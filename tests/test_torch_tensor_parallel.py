"""The port's tensor parallelism (``parallel/tensor.py``) against the JAX
package's: the TP MLP, self-attention and transformer block, with
megatron sequence parallelism on and off, at tp 2 and 4, forward and
backward, against the JAX function at tp=1 (its ``model`` axis bound
by a one-wide ``vmap``) on the same weights, carried across from the
JAX package's ``init_tp_block_params``. The port runs on a thread mesh
of CPU replicas; each rank seeds its share of ``sum(out * G)`` (1/tp of
it where the output is replicated), and replicated leaves' gradients
are summed over ``model``, the rule ``models/transformer.py`` uses.
Tolerances: rtol 2e-5 forward, 2e-4 on gradients. Also: tp=k equals
tp=1 in the port's own initialisation."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import one_intraop_thread  # noqa: F401

from deeplearning4j_tpu.parallel import tensor as jt
from deeplearning4j_tpu_torch.parallel import mesh as tm
from deeplearning4j_tpu_torch.parallel import tensor as tt

B, T, D, H, FF = 2, 16, 32, 4, 64
FWD, GRAD = dict(rtol=2e-5, atol=2e-6), dict(rtol=2e-4, atol=2e-6)
MASK = np.tril(np.ones((T, T), bool))[None, None]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _pick(tree, kind):
    """The params one function reads, and their specs."""
    specs = tt.megatron_specs()
    if kind == "mlp":
        return tree["mlp"], specs["mlp"]
    if kind == "attn":
        return tree["attn"], specs["attn"]
    return tree, specs


def _jax_call(kind, p, x, mask):
    if kind == "mlp":
        return jt.tp_mlp(x, p)
    if kind == "attn":
        return jt.tp_self_attention(x, p, H, mask=mask)
    return jt.tp_transformer_block(x, p, H, mask=mask)


def _port_call(kind, p, x, mask, tp, sp):
    if kind == "mlp":
        return tt.tp_mlp(x, p, sequence_parallel=sp)
    if kind == "attn":
        return tt.tp_self_attention(x, p, H // tp, mask=mask,
                                    sequence_parallel=sp)
    return tt.tp_transformer_block(x, p, H // tp, mask=mask,
                                   sequence_parallel=sp)


@pytest.fixture(scope="module")
def weights():
    g = jt.init_tp_block_params(jax.random.PRNGKey(7), D, H, FF, tp=1,
                                tp_rank=0)
    return jax.tree_util.tree_map(np.asarray, g)


def _jax_ref(kind, params, x, g, mask):
    """The JAX function at tp=1 (its ``model`` axis bound by a one-wide
    ``vmap``) and its VJP."""
    def f(p, xx):
        return jax.vmap(lambda v: _jax_call(kind, p, v, mask),
                        axis_name="model")(xx[None])[0]

    y, vjp = jax.vjp(f, jax.tree_util.tree_map(jnp.asarray, params),
                     jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(g))
    return np.asarray(y), _flat(gp), np.asarray(gx)


def _port_run(kind, weights, x, g, tp, sp, mask):
    mesh = tm.make_mesh({"model": tp}, ["cpu"] * tp, timeout_s=60)
    full, specs = _pick(_to_torch(weights), kind)
    xs = tm.P(None, "model", None) if sp else tm.P()
    m = None if mask is None else torch.from_numpy(mask)

    def body(r):
        rep = mesh.replica(r)
        coords = {"model": r}
        p = {k: v.clone().requires_grad_() for k, v in _flat_t(
            tm.shard_tree(full, specs, mesh, r)).items()}
        xr = tm.shard_leaf(torch.from_numpy(x), xs, mesh.axes,
                           coords).clone().requires_grad_()
        gr = tm.shard_leaf(torch.from_numpy(g), xs, mesh.axes, coords)
        with tm.replica_scope(rep):
            y = _port_call(kind, _nest(p), xr, m, tp, sp)
            ((y * gr).sum() / (1 if sp else tp)).backward()
            grads = {k: v.grad for k, v in p.items()}
            flat_specs = _flat_s(specs)
            grads = {k: v if "model" in tm.spec_axes(flat_specs[k])
                     else tm.psum(v, "model") for k, v in grads.items()}
            gx = xr.grad if sp else tm.psum(xr.grad, "model")
        return y.detach(), _nest(grads), gx

    out = mesh.run(body)
    y = tm.gather_leaf([o[0] for o in out], xs, mesh)
    gp = tm.gather_tree([o[1] for o in out], specs, mesh)
    gx = tm.gather_leaf([o[2] for o in out], xs, mesh)
    return y.numpy(), {k: v.numpy() for k, v in _flat_t(gp).items()}, \
        gx.numpy()


def _flat_t(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_t(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _flat_s(specs, prefix=""):
    out = {}
    for k, v in specs.items():
        if isinstance(v, dict):
            out.update(_flat_s(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _nest(flat):
    out = {}
    for k, v in flat.items():
        *path, leaf = k.split("/")
        d = out
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = v
    return out


def _inputs():
    rng = np.random.RandomState(3)
    return (rng.randn(B, T, D).astype(np.float32),
            rng.randn(B, T, D).astype(np.float32))


@pytest.fixture(scope="module")
def jax_refs(weights):
    """Each function's JAX output and VJP, computed once a module."""
    x, g = _inputs()
    return {kind: _jax_ref(kind, _pick(weights, kind)[0], x, g,
                           None if kind == "mlp" else MASK)
            for kind in ("mlp", "attn", "block")}


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("sp", [False, True], ids=["tp", "megatron_sp"])
@pytest.mark.parametrize("kind", ["mlp", "attn", "block"])
def test_tp_matches_jax_at_tp1(weights, jax_refs, kind, sp, tp):
    x, g = _inputs()
    mask = None if kind == "mlp" else MASK
    y_j, gp_j, gx_j = jax_refs[kind]
    y_t, gp_t, gx_t = _port_run(kind, weights, x, g, tp, sp, mask)
    np.testing.assert_allclose(y_t, y_j, **FWD)
    np.testing.assert_allclose(gx_t, gx_j, **GRAD)
    assert sorted(gp_t) == sorted(gp_j)
    for k in gp_j:
        np.testing.assert_allclose(gp_t[k], gp_j[k], err_msg=k, **GRAD)


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_k_equals_tp_1_in_the_ports_init(tp):
    """Each shard slices the same draws: the gathered tp=k shards are
    the tp=1 weights, and the sharded block's output equals tp=1's."""
    one = tt.init_tp_block_params(torch.Generator().manual_seed(5), D, H,
                                  FF, tp=1, tp_rank=0)
    mesh = tm.make_mesh({"model": tp}, ["cpu"] * tp, timeout_s=60)
    shards = [tt.init_tp_block_params(torch.Generator().manual_seed(5), D,
                                      H, FF, tp=tp, tp_rank=r)
              for r in range(tp)]
    back = tm.gather_tree(shards, tt.megatron_specs(), mesh)
    for k, v in _flat_t(one).items():
        assert torch.equal(_flat_t(back)[k], v), k
    x = torch.from_numpy(np.random.RandomState(4).randn(B, T, D).astype(
        np.float32))
    want = tt.tp_transformer_block(x, one, H, mask=torch.from_numpy(MASK))

    def body(r):
        with tm.replica_scope(mesh.replica(r)):
            return tt.tp_transformer_block(x, shards[r], H // tp,
                                           mask=torch.from_numpy(MASK))

    for y in mesh.run(body):
        torch.testing.assert_close(y, want, **FWD)
