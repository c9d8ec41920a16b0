"""The port's DecoderLM against the JAX package's, on the CPU.

The JAX package's seeded parameters cross to the port through
``utils/serializer.py:params_from_jax``; the same numpy token ids go
through both. Config: d=64, 4 heads, 2 layers, vocab 97, KV blocks of 4
tokens. The JAX decode step runs its Pallas paged kernel in interpret
mode on the ``paged`` route (the port's runs the kernel's plain version
on the CPU) and its dense gather on the other. Tolerance 1e-5 absolute
(both sides compute in f32, with other summation orders). Dead decode
slots write to the scratch block 0 with duplicate indices, where which
write lands is unspecified in both frameworks, so pools are compared
over blocks 1 and up, and logits over the live rows.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.decoder import DecoderConfig as JaxConfig
from deeplearning4j_tpu.models.decoder import DecoderLM as JaxDecoder
from deeplearning4j_tpu_torch.models import DecoderConfig, DecoderLM
from deeplearning4j_tpu_torch.utils import serializer
from torch_parity import one_intraop_thread  # noqa: F401,E402

TOL = dict(rtol=0.0, atol=1e-5)
CONF = dict(vocab_size=97, n_layers=2, n_heads=4, d_model=64, d_ff=128,
            max_len=64, eos_id=1)
BLOCK, NUM_BLOCKS, MAX_BLOCKS = 4, 16, 6
PROMPTS = ([5, 9, 2, 7, 11], [3, 8, 13, 21, 34, 55, 89])   # 2 and 2 blocks


def _np_tree(tree):
    return {e: {n: np.asarray(a) for n, a in leaves.items()}
            for e, leaves in tree.items()}


@pytest.fixture(scope="module")
def models():
    jm = JaxDecoder(JaxConfig(**CONF))
    jp = jm.init()
    conf = DecoderConfig(**CONF)
    params, states = serializer.params_from_jax(_np_tree(jp), {}, conf)
    assert states == {}
    pm = DecoderLM(conf)
    pm.set_params(params, "cpu")
    return jm, jp, pm


def _padded(prompts, t):
    tokens = np.zeros((len(prompts), t), np.int32)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = p
    return tokens, np.asarray([len(p) for p in prompts], np.int32)


def test_forward_with_kv_matches_jax(models):
    jm, jp, pm = models
    tokens, lengths = _padded(PROMPTS, 8)
    jl, jk, jv = jm.forward_with_kv(jp, jnp.asarray(tokens),
                                    jnp.asarray(lengths))
    with torch.inference_mode():
        pl, pk, pv = pm.forward_with_kv(pm.params, tokens, lengths)
    assert pk.shape == (2, 2, 8, 4, 16)
    for got, want in ((pl, jl), (pk, jk), (pv, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_matches_jax(models):
    jm, jp, pm = models
    tokens, lengths = _padded(PROMPTS, 8)
    jl, jk, jv = jm.prefill(jp, jnp.asarray(tokens), jnp.asarray(lengths))
    with torch.inference_mode():
        pl, pk, pv = pm.prefill(pm.params, tokens, lengths)
    assert pl.shape == (2, 97)
    for got, want in ((pl, jl), (pk, jk), (pv, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _decode_inputs(jm, jp):
    """A pool holding both prompts' K/V (from the JAX prefill), and one
    decode step's inputs over a batch of 4: the two sequences, a dead
    slot, and the first sequence again at its next position."""
    tokens, lengths = _padded(PROMPTS, 8)
    _, k, v = jm.prefill(jp, jnp.asarray(tokens), jnp.asarray(lengths))
    shape = (CONF["n_layers"], NUM_BLOCKS, BLOCK, CONF["n_heads"], 16)
    rs = np.random.RandomState(5)
    kp = rs.randn(*shape).astype(np.float32)
    vp = rs.randn(*shape).astype(np.float32)
    tables = np.zeros((4, MAX_BLOCKS), np.int32)
    tables[0, :2] = [3, 9]
    tables[1, :2] = [4, 12]
    tables[3, :2] = [3, 9]
    for i, p in enumerate(PROMPTS):
        for t in range(len(p)):
            blk, off = tables[i, t // BLOCK], t % BLOCK
            kp[:, blk, off] = np.asarray(k)[:, i, t]
            vp[:, blk, off] = np.asarray(v)[:, i, t]
    step_tokens = np.asarray([40, 41, 0, 42], np.int32)
    positions = np.asarray([5, 7, 0, 5], np.int32)
    # sequence 1's position 8 opens its third block
    tables[1, 2] = 7
    positions[1] = 8
    return step_tokens, positions, kp, vp, tables


@pytest.mark.parametrize("paged", [False, True])
def test_decode_step_matches_jax(models, paged):
    """Logits of the live rows and the pool after the in-place write
    (blocks 1 and up) agree with the JAX package's functional step."""
    jm, jp, pm = models
    tokens, positions, kp, vp, tables = _decode_inputs(jm, jp)
    jl, jk, jv = jm.decode_step(jp, jnp.asarray(tokens),
                                jnp.asarray(positions), jnp.asarray(kp),
                                jnp.asarray(vp), jnp.asarray(tables),
                                paged=paged)
    k_pool, v_pool = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    with torch.inference_mode():
        pl, pk, pv = pm.decode_step(pm.params, tokens, positions, k_pool,
                                    v_pool, tables, paged=paged)
    assert pk is k_pool and pv is v_pool            # written in place
    live = [0, 1, 3]
    np.testing.assert_allclose(pl.numpy()[live], np.asarray(jl)[live],
                               **TOL)
    np.testing.assert_allclose(pk.numpy()[:, 1:], np.asarray(jk)[:, 1:],
                               **TOL)
    np.testing.assert_allclose(pv.numpy()[:, 1:], np.asarray(jv)[:, 1:],
                               **TOL)
    assert not np.array_equal(pk.numpy()[:, 7], kp[:, 7])   # wrote there
    assert np.isfinite(pl.numpy()).all()                     # dead row too


def test_decode_step_equals_full_forward_last_position(models):
    """Causality: a decode step over cached K/V gives the full forward's
    last-position logits."""
    _, _, pm = models
    prompt = PROMPTS[1]
    nl = CONF["n_layers"]
    k_pool = torch.zeros(nl, NUM_BLOCKS, BLOCK, 4, 16)
    v_pool = torch.zeros_like(k_pool)
    table = np.asarray([[2, 5, 0, 0, 0, 0]], np.int32)
    with torch.inference_mode():
        _, k, v = pm.prefill(pm.params, np.asarray([prompt[:-1]]),
                             np.asarray([len(prompt) - 1]))
        for t in range(len(prompt) - 1):
            k_pool[:, table[0, t // BLOCK], t % BLOCK] = k[:, 0, t]
            v_pool[:, table[0, t // BLOCK], t % BLOCK] = v[:, 0, t]
        step, _, _ = pm.decode_step(pm.params, [prompt[-1]],
                                    [len(prompt) - 1], k_pool, v_pool,
                                    table, paged=True)
        full, _, _ = pm.forward_with_kv(pm.params, np.asarray([prompt]))
    torch.testing.assert_close(step[0], full[0, -1], **TOL)


@pytest.mark.parametrize("which", [0, 1])
def test_reference_decode_tokens_equal_jax(models, which):
    jm, jp, pm = models
    prompt = PROMPTS[which]
    assert pm.reference_decode(pm.params, prompt, 3) == \
        list(jm.reference_decode(jp, np.asarray(prompt), 3))


def test_output_is_the_full_forward(models):
    jm, jp, pm = models
    tokens = np.asarray([PROMPTS[1]], np.int32)
    want = np.asarray(jm.forward_with_kv(jp, jnp.asarray(tokens))[0])
    np.testing.assert_allclose(pm.output(tokens).numpy(), want, **TOL)


def test_params_round_trip_and_shapes_are_checked(models):
    jm, jp, pm = models
    conf = DecoderConfig(**CONF)
    flat = serializer.params_to_jax(pm.params, conf)
    assert set(flat) == set(serializer.decoder_param_shapes(conf))
    for path, a in flat.items():
        entry, leaf = path.split("/")
        np.testing.assert_array_equal(a, np.asarray(jp[entry][leaf]))
    bad = _np_tree(jp)
    bad["layer_0"]["wq"] = bad["layer_0"]["wq"][:, :8]
    with pytest.raises(ValueError, match="shape"):
        serializer.params_from_jax(bad, {}, conf)
    missing = _np_tree(jp)
    del missing["head"]["w"]
    with pytest.raises(ValueError, match="lacks"):
        serializer.params_from_jax(missing, {}, conf)


def test_init_is_seeded_and_on_the_asked_device():
    a = DecoderLM(DecoderConfig.tiny()).init("cpu", seed=3)
    b = DecoderLM(DecoderConfig.tiny()).init("cpu", seed=3)
    c = DecoderLM(DecoderConfig.tiny()).init("cpu", seed=4)
    assert torch.equal(a["layer_1"]["w1"], b["layer_1"]["w1"])
    assert not torch.equal(a["layer_1"]["w1"], c["layer_1"]["w1"])
    assert a["embed"]["tok"].device.type == "cpu"
    assert float(a["layer_0"]["wq"].std()) == pytest.approx(0.02, rel=0.2)


def test_init_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DecoderLM(DecoderConfig.tiny()).init()
