"""The port's recurrent layers against the JAX package's, on the CPU.

Each layer gets the JAX package's initial parameters (a Bidirectional
layer's nested ``fwd``/``bwd`` trees flattened to the port's
``"fwd/W"`` names), the same numpy input and, where given, the same
``[b, t]`` mask; the outputs, the final states and the gradients of
``sum(y * r)`` (``r`` a fixed random cotangent) with respect to every
parameter are held at the reference's f32 bar, rtol 2e-5 (atol 1e-6 for
entries near zero). The JSON of each layer equals the JAX package's and
round-trips.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.conf import layers as jlayers
from deeplearning4j_tpu.nn.conf import layers_recurrent as jrec
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu_torch.nn.conf import layers as tlayers
from deeplearning4j_tpu_torch.nn.conf import layers_recurrent as trec
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from torch_parity import one_intraop_thread  # noqa: F401,E402

RTOL, ATOL = 2e-5, 1e-6
B, T, F, H = 3, 7, 5, 6


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _mask(seed):
    lengths = np.random.RandomState(seed).randint(2, T + 1, B)
    lengths[0] = T
    return (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)


CASES = {
    "SimpleRnn": lambda m: m.SimpleRnn(n_in=F, n_out=H),
    "LSTM": lambda m: m.LSTM(n_in=F, n_out=H, forget_gate_bias_init=0.7),
    "GravesLSTM": lambda m: m.GravesLSTM(n_in=F, n_out=H),
    "GRU": lambda m: m.GRU(n_in=F, n_out=H),
    "GRU-recurrent-bias": lambda m: m.GRU(n_in=F, n_out=H,
                                          recurrent_bias=True),
    "LSTM-hardsigmoid": lambda m: m.LSTM(n_in=F, n_out=H,
                                         gate_activation="HARDSIGMOID"),
}
for _mode in ("CONCAT", "ADD", "MUL", "AVERAGE"):
    CASES[f"Bidirectional-{_mode}"] = (
        lambda m, mode=_mode: m.Bidirectional(
            fwd=m.GravesLSTM(n_in=F, n_out=H), mode=mode))


def _run(name, masked, seed=0):
    """Outputs, states and gradients of both packages' layer."""
    jl, tl = CASES[name](jrec), CASES[name](trec)
    it_j, it_t = JInputType.recurrent(F, T), InputType.recurrent(F, T)
    jl.set_n_in(it_j, False)
    tl.set_n_in(it_t, False)
    jp = jl.init_params(jax.random.PRNGKey(seed), it_j)
    # a nonzero bias, so its gradient path is exercised
    jp = jax.tree_util.tree_map(
        lambda a: a + 0.1 * jnp.asarray(
            np.random.RandomState(7).randn(*a.shape), a.dtype), jp)
    flat = _flat(jp)
    r = np.random.RandomState(seed + 1)
    x = r.randn(B, T, F).astype(np.float32)
    mask = _mask(seed) if masked else None
    out_dim = jl.get_output_type(it_j).size
    ct = r.randn(B, T, out_dim).astype(np.float32)

    def jloss(p):
        y, s = jl.forward(p, jnp.asarray(x), training=True, mask=(
            jnp.asarray(mask) if masked else None))
        return jnp.sum(y * ct), (y, s)

    (_, (jy, js)), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in flat.items()}
    ty, ts = tl.forward(tp, torch.from_numpy(x), training=True,
                        mask=torch.from_numpy(mask) if masked else None)
    (ty * torch.from_numpy(ct)).sum().backward()
    tg = {k: v.grad.numpy() for k, v in tp.items()}
    assert sorted(tl.init_params(torch.Generator().manual_seed(0), it_t)) \
        == sorted(flat), "parameter names differ from the JAX package's"
    return (np.asarray(jy), _flat(js), _flat(jg)), \
        (ty.detach().numpy(), {k: v.detach().numpy() for k, v in ts.items()},
         tg)


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("name", list(CASES))
def test_layer_matches_jax(name, masked):
    (jy, js, jg), (ty, ts, tg) = _run(name, masked)
    np.testing.assert_allclose(ty, jy, rtol=RTOL, atol=ATOL)
    assert sorted(ts) == sorted(js)
    for k in js:
        np.testing.assert_allclose(ts[k], js[k], rtol=RTOL, atol=ATOL,
                                   err_msg=f"state {k}")
    assert sorted(tg) == sorted(jg)
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], rtol=RTOL, atol=ATOL,
                                   err_msg=f"grad {k}")


@pytest.mark.parametrize("name", ["LSTM", "GravesLSTM", "SimpleRnn", "GRU"])
def test_masked_step_holds_the_state(name):
    """A masked step's output is the held previous h, and the final
    state is the last unmasked step's."""
    layer = CASES[name](trec)
    layer.set_n_in(InputType.recurrent(F, T), False)
    p = layer.init_params(torch.Generator().manual_seed(3),
                          InputType.recurrent(F, T))
    x = torch.randn(B, T, F, generator=torch.Generator().manual_seed(4))
    mask = torch.from_numpy(_mask(5))
    y, s = layer.forward(p, x, training=False, mask=mask)
    for b in range(B):
        n = int(mask[b].sum())
        y_short, s_short = layer.forward(p, x[b:b + 1, :n], training=False)
        torch.testing.assert_close(y[b, :n], y_short[0])
        for t in range(n, T):
            assert torch.equal(y[b, t], y[b, n - 1])
        for k in s:
            torch.testing.assert_close(s[k][b], s_short[k][0])


def test_lstm_layout_and_forget_bias():
    """Gate order [i, f, o, g]; the forget slice b[H:2H] starts at
    forget_gate_bias_init; the peepholes are [H] vectors."""
    layer = trec.GravesLSTM(n_in=F, n_out=H, forget_gate_bias_init=1.5,
                            bias_init=0.25)
    p = layer.init_params(torch.Generator().manual_seed(0),
                          InputType.recurrent(F, T))
    assert p["W"].shape == (F, 4 * H) and p["RW"].shape == (H, 4 * H)
    assert torch.equal(p["b"][H:2 * H], torch.full((H,), 1.5))
    assert torch.equal(p["b"][:H], torch.full((H,), 0.25))
    assert torch.equal(p["b"][2 * H:], torch.full((2 * H,), 0.25))
    assert {p[n].shape for n in ("pI", "pF", "pO")} == {(H,)}


def test_carry_keeps_the_input_dtype():
    """Without a given state the carry starts as zeros of the input's
    dtype: bfloat16 in, bfloat16 states out; an f32 state promotes."""
    layer = trec.GravesLSTM(n_in=F, n_out=H)
    p = {k: v.bfloat16() for k, v in layer.init_params(
        torch.Generator().manual_seed(0), InputType.recurrent(F, T)).items()}
    x = torch.randn(B, T, F).bfloat16()
    y, s = layer.forward(p, x, training=False)
    assert y.dtype == s["h"].dtype == s["c"].dtype == torch.bfloat16
    y32, s32 = layer.forward(p, x, training=False,
                             state=layer.zero_state(B, torch.float32))
    assert y32.dtype == s32["c"].dtype == torch.float32


def test_embedding_sequence_and_last_time_step_match_jax():
    r = np.random.RandomState(11)
    ids = r.randint(0, 9, (B, T))
    mask = _mask(12)
    jl, tl = jrec.EmbeddingSequenceLayer(n_in=9, n_out=4), \
        trec.EmbeddingSequenceLayer(n_in=9, n_out=4)
    jp = jl.init_params(jax.random.PRNGKey(0), None)
    tp = {"W": torch.from_numpy(np.array(jp["W"]))}
    je, _ = jl.forward(jp, jnp.asarray(ids), training=False)
    te, _ = tl.forward(tp, torch.from_numpy(ids), training=False)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    last_j, last_t = jrec.LastTimeStepLayer(), trec.LastTimeStepLayer()
    for m in (None, mask):
        want, _ = last_j.forward({}, je, training=False,
                                 mask=None if m is None else jnp.asarray(m))
        got, _ = last_t.forward({}, te, training=False,
                                mask=None if m is None
                                else torch.from_numpy(m))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("pooling", ["MAX", "AVG", "SUM", "PNORM"])
def test_masked_global_pooling_matches_jax(pooling):
    r = np.random.RandomState(13)
    x = r.randn(B, T, F).astype(np.float32)
    mask = _mask(14)
    jl = jlayers.GlobalPoolingLayer(
        pooling_type=jlayers.PoolingType[pooling])
    tl = tlayers.GlobalPoolingLayer(
        pooling_type=tlayers.PoolingType[pooling])
    assert tl.accepts_mask()
    want, _ = jl.forward({}, jnp.asarray(x), training=False,
                         mask=jnp.asarray(mask))
    got, _ = tl.forward({}, torch.from_numpy(x), training=False,
                        mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("name", list(CASES) + ["Embedding", "LastStep",
                                                 "RnnOutputLayer"])
def test_json_round_trip_matches_jax(name):
    extra = {"Embedding": lambda m: m.EmbeddingSequenceLayer(n_in=9,
                                                             n_out=4),
             "LastStep": lambda m: m.LastTimeStepLayer()}
    if name == "RnnOutputLayer":
        jl = jlayers.RnnOutputLayer(n_in=H, n_out=3)
        tl = tlayers.RnnOutputLayer(n_in=H, n_out=3)
    else:
        make = CASES.get(name) or extra[name]
        jl, tl = make(jrec), make(trec)
    d = json.loads(json.dumps(tl.to_map()))
    assert d == json.loads(json.dumps(jl.to_map()))
    back = tlayers.Layer.from_map(d)
    assert type(back) is type(tl)
    assert json.loads(json.dumps(back.to_map())) == d
    assert back.is_recurrent() == jl.is_recurrent()
    assert back.accepts_mask() == jl.accepts_mask()


def test_rnn_preprocessors_round_trip():
    from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
        FeedForwardToRnnPreProcessor, InputPreProcessor,
        RnnToFeedForwardPreProcessor)
    x = torch.arange(2 * 3 * 4.).reshape(2, 3, 4)
    flat = RnnToFeedForwardPreProcessor().pre_process(x)
    assert flat.shape == (6, 4)
    back = FeedForwardToRnnPreProcessor(timesteps=3)
    assert torch.equal(back.pre_process(flat), x)
    assert back.get_output_type(InputType.feed_forward(4)) == \
        InputType.recurrent(4, 3)
    for p in (RnnToFeedForwardPreProcessor(), back):
        assert InputPreProcessor.from_map(p.to_map()) == p
