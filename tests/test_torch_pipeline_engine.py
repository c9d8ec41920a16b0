"""The port's GPipe engine (``parallel/pipeline.py``: ``pipeline_apply``
with ``with_aux`` and ``remat``, ``last_stage_only``, ``pipeline_loss``,
``bubble_fraction``) against the JAX package's scan engine under
``shard_map``, on the same stage weights and microbatches: 4 stages of
``tanh(x W + b)``, 4 microbatches, alone on a ``pipe`` axis and beside a
``data`` axis that shards the batch. The port runs on a thread mesh of
CPU replicas: each rank seeds its replicated loss with 1/N, the
microbatches' gradient (replicated over ``pipe``) is summed over it.
Tolerances: rtol 2e-5 forward, 2e-4 on gradients."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP
from torch_parity import one_intraop_thread  # noqa: F401

from deeplearning4j_tpu.parallel import make_mesh as jax_mesh
from deeplearning4j_tpu.parallel import pipeline as jpl
from deeplearning4j_tpu.parallel.mesh import shard_map
from deeplearning4j_tpu_torch.parallel import mesh as tm
from deeplearning4j_tpu_torch.parallel import pipeline as tpl

B, T, D = 8, 4, 16
S, M = 4, 4
FWD, GRAD = dict(rtol=2e-5, atol=2e-6), dict(rtol=2e-4, atol=2e-6)


def _stacked():
    ws = []
    for s in range(S):
        rng = np.random.RandomState(100 + s)
        ws.append({"w": rng.randn(D, D).astype(np.float32) * 0.3,
                   "b": rng.randn(D).astype(np.float32) * 0.1})
    return {k: np.stack([w[k] for w in ws]) for k in ("w", "b")}


def _xy():
    rng = np.random.RandomState(1)
    return (rng.randn(B, T, D).astype(np.float32),
            rng.randn(B, T, D).astype(np.float32))


def j_stage(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def t_stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def j_stage_aux(p, x):
    y = j_stage(p, x)
    return y, jnp.mean(y * y)


def t_stage_aux(p, x):
    y = t_stage(p, x)
    return y, (y * y).mean()


def _jax_loss(axes, remat, with_aux):
    """The JAX scan engine's mean-square loss (plus the aux sum, psummed
    over ``pipe``) on the pipeline's last-stage outputs."""
    n = int(np.prod(list(axes.values())))
    mesh = jax_mesh(axes, jax.devices()[:n])
    data = "data" in axes
    xspec = JP(None, "data") if data else JP()

    def run(sp, xm, ym):
        local = jax.tree_util.tree_map(lambda a: a[0], sp)
        if with_aux:
            outs, aux = jpl.pipeline_apply(j_stage_aux, local, xm,
                                           remat=remat, with_aux=True)
        else:
            outs = jpl.pipeline_apply(j_stage, local, xm, remat=remat)
            aux = 0.0
        mse = jnp.mean((outs - ym) ** 2)
        loss = jpl.last_stage_only(mse, "pipe") + jax.lax.psum(aux, "pipe")
        return jax.lax.pmean(loss, "data") if data else loss

    f = shard_map(run, mesh, in_specs=(JP("pipe"), xspec, xspec),
                  out_specs=JP(), check_rep=False)
    return jax.jit(f)


def _port_loss(axes, remat, with_aux, params, xm, ym):
    n = int(np.prod(list(axes.values())))
    mesh = tm.make_mesh(axes, ["cpu"] * n, timeout_s=60)
    data = "data" in axes
    specs = {"w": tm.P("pipe"), "b": tm.P("pipe")}
    xspec = tm.P(None, "data") if data else tm.P()

    def body(r):
        rep = mesh.replica(r)
        coords = dict(zip(mesh.axes, mesh.coords(r)))
        p = {k: v.clone().requires_grad_() for k, v in
             tm.shard_tree(params, specs, mesh, r).items()}
        x = tm.shard_leaf(xm, xspec, mesh.axes, coords).clone() \
            .requires_grad_()
        y = tm.shard_leaf(ym, xspec, mesh.axes, coords)
        with tm.replica_scope(rep):
            local = {k: v[0] for k, v in p.items()}
            if with_aux:
                outs, aux = tpl.pipeline_apply(t_stage_aux, local, x,
                                               remat=remat, with_aux=True)
            else:
                outs = tpl.pipeline_apply(t_stage, local, x, remat=remat)
                aux = torch.zeros(())
            mse = ((outs - y) ** 2).mean()
            loss = tpl.last_stage_only(mse, "pipe") + tm.psum(aux, "pipe")
            if data:
                loss = tm.pmean(loss, "data")
            (loss / n).backward()
            gp = {k: tm.psum(v.grad, "data") if data else v.grad
                  for k, v in p.items()}
            # only stage 0 reads the microbatches
            gx = tm.psum(x.grad if x.grad is not None else
                         torch.zeros_like(x), "pipe")
        return float(loss.detach()), gp, gx

    out = mesh.run(body)
    assert len({o[0] for o in out}) == 1       # the same on every rank
    return (out[0][0], tm.gather_tree([o[1] for o in out], specs, mesh),
            tm.gather_leaf([o[2] for o in out], xspec, mesh))


CASES = {
    "pipe4": ({"pipe": 4}, False, False),
    "pipe4_remat": ({"pipe": 4}, True, False),
    "pipe4_aux": ({"pipe": 4}, False, True),
    "pipe4_aux_remat": ({"pipe": 4}, True, True),
    "data2_pipe4_aux": ({"data": 2, "pipe": 4}, False, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pipeline_apply_loss_and_grads_match_jax(case):
    axes, remat, with_aux = CASES[case]
    sp = _stacked()
    x, y = _xy()
    xm, ym = (np.asarray(jpl.to_microbatches(a, M)) for a in (x, y))
    f = _jax_loss(axes, remat, with_aux)
    want = float(f(sp, xm, ym))
    gp_j, gx_j = jax.grad(f, argnums=(0, 1))(sp, jnp.asarray(xm),
                                             jnp.asarray(ym))
    got, gp_t, gx_t = _port_loss(
        axes, remat, with_aux, {k: torch.from_numpy(v) for k, v in
                                sp.items()},
        torch.from_numpy(xm), torch.from_numpy(ym))
    np.testing.assert_allclose(got, want, **FWD)
    for k in sp:
        np.testing.assert_allclose(gp_t[k].numpy(), np.asarray(gp_j[k]),
                                   err_msg=k, **GRAD)
    np.testing.assert_allclose(gx_t.numpy(), np.asarray(gx_j), **GRAD)


@pytest.mark.parametrize("remat", [False, True])
def test_pipeline_loss_matches_jax(remat):
    sp = _stacked()
    x, y = _xy()
    xm, ym = (np.asarray(jpl.to_microbatches(a, M)) for a in (x, y))
    mesh = jax_mesh({"pipe": S}, jax.devices()[:S])

    def run(spl, a, b):
        local = jax.tree_util.tree_map(lambda t: t[0], spl)
        return jpl.pipeline_loss(j_stage, lambda o, t: jnp.mean((o - t) ** 2),
                                 local, a, b, remat=remat)

    f = jax.jit(shard_map(run, mesh, in_specs=(JP("pipe"), JP(), JP()),
                          out_specs=JP()))
    want = float(f(sp, xm, ym))
    gj = jax.grad(f)(sp, jnp.asarray(xm), jnp.asarray(ym))
    tmesh = tm.make_mesh({"pipe": S}, ["cpu"] * S, timeout_s=60)

    def body(r):
        p = {k: torch.from_numpy(v[r:r + 1].copy()).requires_grad_()
             for k, v in sp.items()}
        with tm.replica_scope(tmesh.replica(r)):
            loss = tpl.pipeline_loss(
                t_stage, lambda o, t: ((o - t) ** 2).mean(),
                {k: v[0] for k, v in p.items()}, torch.from_numpy(xm),
                torch.from_numpy(ym), remat=remat)
            (loss / S).backward()
        return float(loss.detach()), {k: v.grad for k, v in p.items()}

    out = tmesh.run(body)
    for loss, _ in out:
        np.testing.assert_allclose(loss, want, **FWD)
    for k in sp:
        np.testing.assert_allclose(
            torch.cat([o[1][k] for o in out]).numpy(), np.asarray(gj[k]),
            err_msg=k, **GRAD)


def test_forward_is_valid_on_the_last_stage_only():
    sp = _stacked()
    x, _ = _xy()
    xm = torch.from_numpy(np.asarray(jpl.to_microbatches(x, M)))
    mesh = tm.make_mesh({"pipe": S}, ["cpu"] * S, timeout_s=60)
    want = torch.from_numpy(x)
    for s in range(S):
        want = t_stage({k: torch.from_numpy(v[s]) for k, v in sp.items()},
                       want)

    def body(r):
        with tm.replica_scope(mesh.replica(r)):
            return tpl.pipeline_apply(
                t_stage, {k: torch.from_numpy(v[r]) for k, v in sp.items()},
                xm)

    outs = mesh.run(body)
    for r in range(S - 1):
        assert torch.equal(outs[r], torch.zeros_like(outs[r]))
    torch.testing.assert_close(tpl.from_microbatches(outs[-1]), want, **FWD)


@pytest.mark.parametrize("s,m", [(1, 4), (2, 4), (4, 4), (4, 16), (8, 3)])
def test_bubble_fraction_and_microbatches(s, m):
    assert tpl.bubble_fraction(s, m) == jpl.bubble_fraction(s, m)
    x = np.arange(48.0).reshape(12, 4)
    if 12 % m:
        with pytest.raises(ValueError, match="not divisible"):
            tpl.to_microbatches(torch.from_numpy(x), m)
        return
    got = tpl.to_microbatches(torch.from_numpy(x), m)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jpl.to_microbatches(x, m)))
    np.testing.assert_array_equal(tpl.from_microbatches(got).numpy(), x)
