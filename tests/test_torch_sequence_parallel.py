"""The port's sequence parallelism (``parallel/sequence.py``) against the
JAX package's, forward and backward, on the same inputs:
``blockwise_attention`` (causal, a key mask, a padded last block, fully
masked rows exactly 0), ``ring_attention`` in both forms (the blockwise
fold and ``use_flash``, the flash kernels' plain versions on the CPU
merged through their log-sum-exps) with ``causal`` off and on, and
``ulysses_attention``, through ``ring_self_attention`` /
``ulysses_self_attention`` over a mesh of ``data`` x ``seq`` (the port
on a thread mesh of CPU replicas, the JAX package under ``shard_map`` on
the forced host devices; on the CPU the JAX ring runs its dense
with-lse reference per shard). Gradients by the VJP of a random
cotangent. Tolerances: rtol 2e-5 forward, 2e-4 on gradients."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import one_intraop_thread  # noqa: F401

from deeplearning4j_tpu.parallel import make_mesh as jax_mesh
from deeplearning4j_tpu.parallel import sequence as js
from deeplearning4j_tpu_torch.parallel import mesh as tm
from deeplearning4j_tpu_torch.parallel import sequence as ts

FWD, GRAD = dict(rtol=2e-5, atol=2e-6), dict(rtol=2e-4, atol=2e-5)


def _qkvg(b=2, h=4, t=64, d=16, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, h, t, d).astype(np.float32) for _ in range(4)]


def _jax_vjp(fn, q, k, v, g):
    # jitted: one XLA program, compiled several times faster than the
    # eager shard_map's pieces
    y, vjp = jax.vjp(jax.jit(fn), jnp.asarray(q), jnp.asarray(k),
                     jnp.asarray(v))
    return [np.asarray(y)] + [np.asarray(a) for a in vjp(jnp.asarray(g))]


def _port_vjp(fn, q, k, v, g):
    ins = [torch.from_numpy(a.copy()).requires_grad_() for a in (q, k, v)]
    y = fn(*ins)
    grads = torch.autograd.grad(y, ins, torch.from_numpy(g))
    return [y.detach().numpy()] + [a.numpy() for a in grads]


def _hold(got, want):
    np.testing.assert_allclose(got[0], want[0], **FWD)
    for name, a, b in zip("qkv", got[1:], want[1:]):
        np.testing.assert_allclose(a, b, err_msg=f"d{name}", **GRAD)


BLOCKWISE = {
    "plain": dict(block_k=16),
    "causal": dict(causal=True, block_k=16),
    "padded_last_block": dict(block_k=24),
    "causal_padded_offsets": dict(causal=True, block_k=24, q_offset=8,
                                  k_offset=4),
    "key_mask": dict(block_k=16, mask="ragged"),
}


@pytest.mark.parametrize("case", sorted(BLOCKWISE))
def test_blockwise_attention_matches_jax(case):
    q, k, v, g = _qkvg()
    kw = dict(BLOCKWISE[case])
    jkw, tkw = dict(kw), dict(kw)
    if kw.pop("mask", None):
        km = np.ones((2, 1, 64), np.float32)
        km[0, :, 40:] = 0.0
        km[1, :, :7] = 0.0
        jkw["key_mask"], tkw["key_mask"] = jnp.asarray(km), \
            torch.from_numpy(km)
        del jkw["mask"], tkw["mask"]
    want = _jax_vjp(lambda a, b, c: js.blockwise_attention(a, b, c, **jkw),
                    q, k, v, g)
    got = _port_vjp(lambda a, b, c: ts.blockwise_attention(a, b, c, **tkw),
                    q, k, v, g)
    _hold(got, want)


def test_blockwise_fully_masked_rows_are_exactly_zero():
    q, k, v, g = _qkvg(b=1, h=2, t=16, d=8)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    # every key masked, over two blocks: exact zeros and zero gradients
    out = ts.blockwise_attention(qt, kt, vt, key_mask=torch.zeros(1, 1, 16),
                                 block_k=8)
    assert torch.equal(out, torch.zeros_like(out))
    out.backward(torch.from_numpy(g))
    for t in (qt, kt, vt):
        assert torch.equal(t.grad, torch.zeros_like(t.grad))
    want = js.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), key_mask=jnp.zeros(
                                      (1, 1, 16)), block_k=8)
    np.testing.assert_array_equal(np.asarray(want), 0.0)


#: (mesh axes, the self-attention form, its keywords)
MESH_CASES = {
    "ring_blockwise": ({"data": 2, "seq": 4}, "ring", {}),
    "ring_blockwise_causal": ({"data": 2, "seq": 4}, "ring",
                              {"causal": True}),
    "ring_flash": ({"data": 2, "seq": 4}, "ring", {"use_flash": True}),
    "ring_flash_causal": ({"data": 2, "seq": 4}, "ring",
                          {"use_flash": True, "causal": True}),
    "ring_flash_causal_seq2": ({"data": 1, "seq": 2}, "ring",
                               {"use_flash": True, "causal": True}),
    "ulysses": ({"data": 2, "seq": 4}, "ulysses", {}),
    "ulysses_causal": ({"data": 2, "seq": 4}, "ulysses", {"causal": True}),
    "ulysses_flash_causal": ({"seq": 4}, "ulysses",
                             {"use_flash": True, "causal": True}),
}


@pytest.mark.parametrize("case", sorted(MESH_CASES))
def test_sequence_parallel_attention_matches_jax(case):
    axes, form, kw = MESH_CASES[case]
    n = int(np.prod(list(axes.values())))
    q, k, v, g = _qkvg(t=64, d=16, seed=3)
    jmesh = jax_mesh(axes, jax.devices()[:n])
    tmesh = tm.make_mesh(axes, ["cpu"] * n, timeout_s=60)
    jf = js.ring_self_attention if form == "ring" else \
        js.ulysses_self_attention
    tf = ts.ring_self_attention if form == "ring" else \
        ts.ulysses_self_attention
    want = _jax_vjp(lambda a, b, c: jf(jmesh, a, b, c, **kw), q, k, v, g)
    got = _port_vjp(lambda a, b, c: tf(tmesh, a, b, c, **kw), q, k, v, g)
    _hold(got, want)


def test_ring_flash_skips_the_later_shards():
    """The causal flash ring runs one partial a visible shard: rank r of
    the ring folds r + 1 shards (the others are skipped, no launch)."""
    q, k, v, g = _qkvg(b=1, h=2, t=32, d=8, seed=4)
    mesh = tm.make_mesh({"seq": 4}, ["cpu"] * 4, timeout_s=60)
    calls = [0] * 4
    orig = ts.flash_attention_with_lse

    def counting(*a, **kw):
        r = tm.current_replica().rank
        calls[r] += 1
        return orig(*a, **kw)

    ts.flash_attention_with_lse = counting
    try:
        ts.ring_self_attention(mesh, *(torch.from_numpy(a) for a in
                                       (q, k, v)), causal=True,
                               use_flash=True)
    finally:
        ts.flash_attention_with_lse = orig
    assert calls == [1, 2, 3, 4]
