"""The port's named-axis collectives (``parallel/mesh.py``) against the
matching ``jax.lax`` collectives under the JAX package's ``shard_map``,
forward and backward, on 2 and 4 ranks of one axis of a 3-axis mesh,
and the process-group mesh's axis groups against the thread mesh's.

The JAX side runs ``shard_map`` without replication checking: there
each collective's VJP is its linear transpose over the stacked per-rank
values (psum against psum, all_gather against psum_scatter, ppermute
against its inverse, all_to_all against its inverse), the rule the port
takes. Every rank holds its own block of a global array; the cotangent
is a random global array of the outputs' shape. Forward and backward
within rtol 2e-5 (the sums run in another order)."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from torch_parity import one_intraop_thread  # noqa: F401

from deeplearning4j_tpu.parallel import make_mesh as jax_mesh
from deeplearning4j_tpu.parallel.mesh import shard_map
from deeplearning4j_tpu_torch.parallel import mesh as tm

ROOT = Path(__file__).resolve().parent.parent
RTOL, ATOL = 2e-5, 1e-6
#: (mesh axes, the axis the collective runs over): 2 and 4 ranks of one
#: axis of a 3-axis mesh
MESHES = [({"a": 2, "b": 2, "c": 2}, "b"), ({"a": 2, "b": 4, "c": 1}, "b")]
ROWS, COLS = 4, 6
#: collective name -> (the lax form, the port form), each of (x, axis, n)
CASES = {
    "psum": (lambda x, a, n: lax.psum(x, a),
             lambda x, a, n: tm.psum(x, a)),
    "pmean": (lambda x, a, n: lax.pmean(x, a),
              lambda x, a, n: tm.pmean(x, a)),
    "all_gather_dim1": (
        lambda x, a, n: lax.all_gather(x, a, axis=1, tiled=True),
        lambda x, a, n: tm.all_gather(x, a, 1)),
    "psum_scatter_dim0": (
        lambda x, a, n: lax.psum_scatter(x, a, scatter_dimension=0,
                                         tiled=True),
        lambda x, a, n: tm.psum_scatter(x, a, 0)),
    "ppermute_ring": (
        lambda x, a, n: lax.ppermute(x, a, [(i, (i + 1) % n)
                                            for i in range(n)]),
        lambda x, a, n: tm.ppermute(x, a, [(i, (i + 1) % n)
                                           for i in range(n)])),
    "ppermute_chain": (
        lambda x, a, n: lax.ppermute(x, a, [(i, i + 1)
                                            for i in range(n - 1)]),
        lambda x, a, n: tm.ppermute(x, a, [(i, i + 1)
                                           for i in range(n - 1)])),
    "all_to_all": (
        lambda x, a, n: lax.all_to_all(x, a, split_axis=0, concat_axis=1,
                                       tiled=True),
        lambda x, a, n: tm.all_to_all(x, a, 0, 1)),
}


def _global(seed, n_ranks, shape):
    return np.random.RandomState(seed).randn(n_ranks, *shape).astype(
        np.float32)


def _jax_vjp(axes, axis, fn, x, g):
    mesh = jax_mesh(axes, jax.devices()[:int(np.prod(list(axes.values())))])
    spec = jax.sharding.PartitionSpec(tuple(axes))
    n = axes[axis]

    def body(xb):
        return fn(xb[0], axis, n)[None]

    f = shard_map(body, mesh, in_specs=(spec,), out_specs=spec,
                  check_rep=False)
    y, vjp = jax.vjp(jax.jit(f), jnp.asarray(x))
    return np.asarray(y), np.asarray(vjp(jnp.asarray(g))[0])


def _port(axes, axis, fn, x, g):
    size = int(np.prod(list(axes.values())))
    mesh = tm.make_mesh(axes, ["cpu"] * size, timeout_s=60)
    n = axes[axis]

    def body(r):
        with tm.replica_scope(mesh.replica(r)):
            xr = torch.from_numpy(x[r]).requires_grad_()
            y = fn(xr, axis, n)
            y.backward(torch.from_numpy(g[r]))
            return y.detach().numpy(), xr.grad.numpy()

    out = mesh.run(body)
    return np.stack([o[0] for o in out]), np.stack([o[1] for o in out])


@pytest.mark.parametrize("axes,axis", MESHES,
                         ids=["2_of_2x2x2", "4_of_2x4x1"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_collective_and_its_transpose_match_lax(axes, axis, case):
    jfn, pfn = CASES[case]
    size = int(np.prod(list(axes.values())))
    x = _global(0, size, (ROWS, COLS))
    # the cotangent has the output's shape
    g = _global(1, size, _jax_fwd(axes, axis, jfn, x).shape[1:])
    y_j, gx_j = _jax_vjp(axes, axis, jfn, x, g)
    y_t, gx_t = _port(axes, axis, pfn, x, g)
    np.testing.assert_allclose(y_t, y_j, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(gx_t, gx_j, rtol=RTOL, atol=ATOL)


def _jax_fwd(axes, axis, fn, x):
    mesh = jax_mesh(axes, jax.devices()[:int(np.prod(list(axes.values())))])
    spec = jax.sharding.PartitionSpec(tuple(axes))
    f = shard_map(lambda xb: fn(xb[0], axis, axes[axis])[None], mesh,
                  in_specs=(spec,), out_specs=spec, check_rep=False)
    return np.asarray(jax.jit(f)(jnp.asarray(x)))


@pytest.mark.parametrize("axes,axis", MESHES,
                         ids=["2_of_2x2x2", "4_of_2x4x1"])
def test_pmax_matches_lax(axes, axis):
    size = int(np.prod(list(axes.values())))
    x = _global(2, size, (ROWS, COLS))
    want = _jax_fwd(axes, axis, lambda v, a, n: lax.pmax(v, a), x)
    mesh = tm.make_mesh(axes, ["cpu"] * size, timeout_s=60)

    def body(r):
        with tm.replica_scope(mesh.replica(r)):
            return tm.pmax(torch.from_numpy(x[r]), axis).numpy()

    np.testing.assert_array_equal(np.stack(mesh.run(body)), want)


def test_axis_layout_is_the_jax_meshs():
    """Ranks row-major over the axes in their order, as the JAX
    ``make_mesh`` reshapes its device list; axis groups share every
    other coordinate."""
    axes = {"data": 2, "pipe": 2, "model": 2}
    jm = jax_mesh(axes, jax.devices()[:8])
    mesh = tm.make_mesh(axes, ["cpu"] * 8)
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    for r in range(8):
        assert ids[mesh.coords(r)] == jax.devices()[r].id
    assert mesh.axis_groups("pipe") == [[0, 2], [1, 3], [4, 6], [5, 7]]
    assert mesh.axis_groups("data") == [[0, 4], [1, 5], [2, 6], [3, 7]]
    rep = mesh.replica(6)
    assert (rep.axis_index("data"), rep.axis_index("pipe"),
            rep.axis_index("model")) == (1, 1, 0)
    assert tm.axis_size("model") == 1 and tm.axis_index("model") == 0


def test_specs_cut_and_gather_a_tree():
    axes = {"data": 2, "pipe": 2, "model": 2}
    mesh = tm.make_mesh(axes, ["cpu"] * 8)
    tree = {"w": torch.arange(32.0).reshape(2, 4, 4),
            "e": [torch.arange(8.0)], "r": torch.ones(3)}
    specs = {"w": tm.P("pipe", None, "model"), "e": [tm.P(("data",
                                                           "model"))],
             "r": tm.P()}
    shards = [tm.shard_tree(tree, specs, mesh, r) for r in range(8)]
    assert tuple(shards[5]["w"].shape) == (1, 4, 2)
    # rank 5 = (data 1, pipe 0, model 1)
    assert torch.equal(shards[5]["w"], tree["w"][0:1, :, 2:4])
    assert torch.equal(shards[5]["e"][0], tree["e"][0][6:8])
    back = tm.gather_tree(shards, specs, mesh)
    for k in ("w", "r"):
        assert torch.equal(back[k], tree[k])
    assert torch.equal(back["e"][0], tree["e"][0])


_CHILD = r"""
import sys, torch
sys.path.insert(0, sys.argv[1])
from deeplearning4j_tpu_torch.parallel import mesh as tm
work, rank = sys.argv[2], int(sys.argv[3])
m = tm.ProcessGroupMesh(f"file://{work}/store", 4, rank, device="cpu",
                        backend="gloo", timeout_s=60,
                        axes={"data": 2, "model": 2})
out = {}
for name, axes in (("dm", None), ("sp", {"data": 1, "seq": 2, "model": 2})):
    mm = m if axes is None else m.with_axes(axes)
    rep = mm.local_replicas()[0]
    x = torch.arange(8.0).reshape(4, 2) + 100 * rank
    res = {}
    for axis in [a for a, n in mm.shape.items() if n > 1]:
        res[axis] = [rep.axis_collective(op, x, axis, **kw) for op, kw in (
            ("psum", {}), ("pmax", {}), ("all_gather", {"dim": 1}),
            ("psum_scatter", {"dim": 0}),
            ("ppermute", {"perm": [(0, 1)]}),
            ("all_to_all", {"split": 0, "concat": 1}))]
    out[name] = res
torch.save(out, f"{work}/rank{rank}.pt")
m.shutdown()
"""


def test_process_group_axes_match_the_thread_mesh(tmp_path):
    """Four gloo processes: each axis group's collectives (two layouts
    of one world, ``with_axes``) equal the thread mesh's."""
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CHILD, str(ROOT), str(tmp_path), str(r)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(4)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    got = [torch.load(tmp_path / f"rank{r}.pt") for r in range(4)]
    for name, axes in (("dm", {"data": 2, "model": 2}),
                       ("sp", {"data": 1, "seq": 2, "model": 2})):
        mesh = tm.make_mesh(axes, ["cpu"] * 4, timeout_s=60)

        def body(r):
            rep = mesh.replica(r)
            x = torch.arange(8.0).reshape(4, 2) + 100 * r
            return {axis: [rep.axis_collective(op, x, axis, **kw)
                           for op, kw in (
                               ("psum", {}), ("pmax", {}),
                               ("all_gather", {"dim": 1}),
                               ("psum_scatter", {"dim": 0}),
                               ("ppermute", {"perm": [(0, 1)]}),
                               ("all_to_all", {"split": 0, "concat": 1}))]
                    for axis in [a for a, n in axes.items() if n > 1]}

        want = mesh.run(body)
        for r in range(4):
            for axis, vals in want[r].items():
                for a, b in zip(got[r][name][axis], vals):
                    assert torch.equal(a, b), (name, r, axis)
