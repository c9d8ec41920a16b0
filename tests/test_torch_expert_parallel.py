"""The port's expert parallelism (``parallel/expert.py``) against the JAX
package's: ``topk_gating``'s dispatch exactly (expert queues filled in
token order, pass by pass, the first expert on ties, overflow dropped)
with its combine weights and aux loss, on the same logits, including
cases where tokens drop; ``moe_ffn`` at ep 1, 2 and 4 (the port on a
thread mesh of CPU replicas, tokens and experts sharded over an
``expert`` axis) against the JAX function with every expert local, on
weights carried across from the JAX package's ``init_moe_params``,
forward and backward. Tolerances: rtol 2e-5 forward, 2e-4 on
gradients; the combine weights within one f32 rounding (XLA's softmax
and torch's may differ in the last bit)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import one_intraop_thread  # noqa: F401

from deeplearning4j_tpu.parallel import expert as je
from deeplearning4j_tpu_torch.parallel import expert as te
from deeplearning4j_tpu_torch.parallel import mesh as tm

B, T, D, FF, E = 8, 4, 16, 32, 4
N = B * T
FWD, GRAD = dict(rtol=2e-5, atol=2e-6), dict(rtol=2e-4, atol=2e-6)


@pytest.mark.parametrize("n,k,capacity", [
    (64, 2, None), (64, 2, 5), (64, 1, None), (37, 2, 3), (16, 3, 4)],
    ids=["rule", "drops_c5", "top1", "odd_n_drops_c3", "top3_drops"])
def test_topk_gating_matches_jax(n, k, capacity):
    logits = np.random.RandomState(n + k).randn(n, E).astype(np.float32)
    jc, jd, ja, jcap = je.topk_gating(jnp.asarray(logits), k=k,
                                      capacity=capacity)
    tc, td, ta, tcap = te.topk_gating(torch.from_numpy(logits), k=k,
                                      capacity=capacity)
    assert tcap == jcap
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    # the same (token, expert, slot) cells carry a weight
    np.testing.assert_array_equal(tc.numpy() > 0, np.asarray(jc) > 0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=2e-7,
                               atol=0)
    np.testing.assert_allclose(float(ta), float(ja), **FWD)
    if capacity is not None and capacity < k * n // E:
        # tokens dropped: fewer kept picks than n * k
        assert int(td.sum()) < n * k


def test_topk_gating_ties_take_the_first_expert():
    logits = np.zeros((6, E), np.float32)
    jc, jd, _, _ = je.topk_gating(jnp.asarray(logits), k=2, capacity=4)
    tc, td, _, _ = te.topk_gating(torch.from_numpy(logits), k=2,
                                  capacity=4)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert td[:, 0].any() and td[:, 1].any() and not td[:, 2:].any()


@pytest.fixture(scope="module")
def weights():
    p = je.init_moe_params(jax.random.PRNGKey(11), D, FF, E, ep=1,
                           ep_rank=0)
    return {k: np.asarray(v) for k, v in p.items()}


def _data():
    rng = np.random.RandomState(5)
    return (rng.randn(B, T, D).astype(np.float32),
            rng.randn(B, T, D).astype(np.float32))


@pytest.fixture(scope="module")
def jax_ref(weights):
    """The JAX moe_ffn with every expert local (capacity: all tokens, so
    nothing drops) and its VJP on ``sum(out * G)``."""
    x, g = _data()

    def f(p, xx):
        return je.moe_ffn(xx, p, axis=None, k=2, capacity=N)[0]

    y, vjp = jax.vjp(f, {k: jnp.asarray(v) for k, v in weights.items()},
                     jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(g))
    return (np.asarray(y), {k: np.asarray(v) for k, v in gp.items()},
            np.asarray(gx))


@pytest.mark.parametrize("ep", [1, 2, 4])
def test_moe_ffn_matches_jax(weights, jax_ref, ep):
    x, g = _data()
    y_j, gp_j, gx_j = jax_ref
    specs = {"Wg": tm.P(), "Wi": tm.P("expert"), "Wo": tm.P("expert")}
    xs = tm.P("expert")
    mesh = tm.make_mesh({"expert": ep}, ["cpu"] * ep, timeout_s=60)
    full = {k: torch.from_numpy(v.copy()) for k, v in weights.items()}

    def body(r):
        coords = {"expert": r}
        p = {k: v.clone().requires_grad_() for k, v in
             tm.shard_tree(full, specs, mesh, r).items()}
        xr = tm.shard_leaf(torch.from_numpy(x), xs, mesh.axes,
                           coords).clone().requires_grad_()
        gr = tm.shard_leaf(torch.from_numpy(g), xs, mesh.axes, coords)
        with tm.replica_scope(mesh.replica(r)):
            y, _ = te.moe_ffn(xr, p, axis="expert", k=2, capacity=N)
            (y * gr).sum().backward()
            gp = {k: v.grad for k, v in p.items()}
            gp["Wg"] = tm.psum(gp["Wg"], "expert")
        return y.detach(), gp, xr.grad

    out = mesh.run(body)
    y = tm.gather_leaf([o[0] for o in out], xs, mesh)
    np.testing.assert_allclose(y.numpy(), y_j, **FWD)
    np.testing.assert_allclose(
        tm.gather_leaf([o[2] for o in out], xs, mesh).numpy(), gx_j, **GRAD)
    gp = tm.gather_tree([o[1] for o in out], specs, mesh)
    for k in gp_j:
        np.testing.assert_allclose(gp[k].numpy(), gp_j[k], err_msg=k,
                                   **GRAD)


def test_moe_ffn_with_drops_matches_jax(weights):
    """A capacity of 6 (of 16 picks an expert on average) drops tokens;
    the survivors' outputs and the aux loss match."""
    x, _ = _data()
    x = x * 3.0                       # sharper gates, more collisions
    jy, ja = je.moe_ffn(jnp.asarray(x), {k: jnp.asarray(v) for k, v in
                                         weights.items()}, axis=None,
                        k=2, capacity=6)
    tw = {k: torch.from_numpy(v.copy()) for k, v in weights.items()}
    ty, ta = te.moe_ffn(torch.from_numpy(x), tw, axis=None, k=2,
                        capacity=6)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **FWD)
    np.testing.assert_allclose(float(ta), float(ja), **FWD)


def test_init_moe_params_ep_k_slices_ep_1():
    one = te.init_moe_params(torch.Generator().manual_seed(3), D, FF, E,
                             ep=1, ep_rank=0)
    for ep in (2, 4):
        parts = [te.init_moe_params(torch.Generator().manual_seed(3), D,
                                    FF, E, ep=ep, ep_rank=r)
                 for r in range(ep)]
        assert torch.equal(torch.cat([p["Wi"] for p in parts]), one["Wi"])
        assert torch.equal(torch.cat([p["Wo"] for p in parts]), one["Wo"])
        assert all(torch.equal(p["Wg"], one["Wg"]) for p in parts)
