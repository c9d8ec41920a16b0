"""Tensor parallelism on the port's data-parallel fit path (``ParallelWrapper
.Builder(...).workers(4).tensor_parallel(2)``: SpecLayout's leaves,
zero.py's tensor-parallel tails) against the JAX package's run of the
same configuration, on the CPU.

The port runs 8 CPU replicas on a ``{data: 4, model: 2}`` thread mesh,
each holding its shards of the tensor-parallel leaves; the JAX package
runs its 2D wrapper on the 8 forced host devices. Sizes, networks and
tolerances are ``tests/test_2d_parallel.py``'s (the 8-16-3 MLP, 64-row
batches, 4 steps; rtol 1e-6 / atol 1e-7 for Sgd, 1e-5 / 1e-6 for
Nesterovs and Adam); the encoded exchange is held at the same bars (its
codec runs on the same mean-gradient slices in both packages). Each JAX
run is made once a module.
"""
import numpy as np
import pytest
from torch_parity import one_intraop_thread  # noqa: F401

from deeplearning4j_tpu.parallel import SpecLayout as JSpecLayout
from deeplearning4j_tpu.parallel import zero as jzero
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.learning.updaters import (DP_SHARDED_KEY,
                                                        FSDP_KEY, TP_KEY)
from deeplearning4j_tpu_torch.parallel import SpecLayout
from deeplearning4j_tpu_torch.parallel import zero
from deeplearning4j_tpu_torch.parallel.wrapper import ParallelWrapper
from test_torch_pipeline_trainer import (BARS, assert_same, batch,
                                         jax_axes_mesh, jax_wrapper_run,
                                         pair, port_mesh, port_wrapper)

#: exchange -> updater of its trajectory case
MODES = {"dense": "sgd", "sharded": "nesterovs", "fsdp": "adam",
         "encoded": "adam"}


@pytest.fixture(scope="module")
def jax_runs():
    cache = {}

    def get(key, fn, *args, **kw):
        if key not in cache:
            cache[key] = fn(*args, **kw)
        return cache[key]
    return get


def build(mode):
    return dict(workers=4, tensor_parallel=2, update_exchange=mode)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_2d_trajectory_matches_jax(jax_runs, mode):
    """dp4 x tp2, 4 steps, in each exchange, against the JAX 2D
    wrapper's run of the same configuration."""
    upd = MODES[mode]
    want = jax_runs(mode, jax_wrapper_run, "mlp", upd, 4, **build(mode))
    _, net = pair("mlp", upd)
    pw = port_wrapper(net, "mlp", **build(mode))
    assert pw.tensor_parallel == 2 and pw.n_workers == 4
    assert dict(pw.mesh.shape) == {"data": 4, "model": 2}
    assert pw._tp_specs, "SpecLayout inferred no tp leaves"
    assert_same(want, net, BARS[upd])
    np.testing.assert_allclose(net.score(), want["score"], **BARS[upd])


def test_graph_2d_matches_jax(jax_runs):
    """The graph's update tail under dp4 x tp2 (ZeRO-1)."""
    want = jax_runs("graph", jax_wrapper_run, "graph", "adam", 3,
                    **build("sharded"))
    _, g = pair("graph", "adam")
    pw = port_wrapper(g, "graph", steps=3, **build("sharded"))
    assert pw._tp_specs
    assert_same(want, g, BARS["adam"])


@pytest.mark.parametrize("mode", ["dense", "sharded", "fsdp"])
def test_tp_leaves_and_state_resident_at_their_slice(mode):
    """While bound, each replica holds 1/tp of a tensor-parallel leaf
    (1/(dp·tp) under fsdp) and of its updater state (1/(dp·tp) under the
    ZeRO tails, where the resident spec splits over ``data`` too); the
    flats never hold one. Unbound, the model is dense again."""
    _, net = pair("mlp", "adam", seed=3)
    pw = ParallelWrapper.Builder(net).workers(4).tensor_parallel(2) \
        .update_exchange(mode).build()
    pw.fit_batch(DataSet(*batch("mlp", 0, 64)))
    whole = {k: {n: t.numel() for n, t in sub.items()}
             for k, sub in net.params.items()}
    pw._bind()
    try:
        for rep in pw._replicas:
            for k, specs in pw._tp_specs.items():
                ent, st = rep.params[k], rep.updater_states[k]
                for n, ls in specs.items():
                    over_data = 4 if "data" in tuple(ls.resident) else 1
                    if mode == "fsdp":     # the resident shard
                        held = ent[TP_KEY][n].numel() * over_data
                    else:                  # the compute shard
                        held = ent[n].numel()
                    assert held * 2 == whole[k][n], (k, n)
                    slots = st if mode == "dense" else st[TP_KEY]
                    for slot in ("m", "v"):
                        assert slots[slot][n].numel() * 2 * over_data == \
                            whole[k][n], (k, n, slot)
                if mode != "dense":
                    # the flats cover the other leaves only
                    rest = sum(c for n, c in whole[k].items()
                               if n not in specs)
                    flat = sum(t.numel() for t in
                               st[DP_SHARDED_KEY]["m"].values())
                    assert flat * 4 == -(-rest // 4) * 4, k
                    if mode == "fsdp":
                        assert FSDP_KEY in ent
    finally:
        pw._unbind(True)
    assert {k: {n: t.numel() for n, t in sub.items()}
            for k, sub in net.params.items()} == whole


def test_axis_bytes_match_jax():
    """``update_exchange_axis_bytes`` and ``exchange_report`` on the 2D
    mesh equal the JAX package's: 0 bytes of the exchange cross
    ``model``; a naive data-axis ravel of the model-sharded leaves
    would."""
    jnet, net = pair("mlp", "sgd")
    jspecs = JSpecLayout(jax_axes_mesh({"data": 4, "model": 2})).infer(
        jnet.params, shard_over_data=True)
    specs = SpecLayout(port_mesh({"data": 4, "model": 2})).infer(
        net.params, shard_over_data=True)
    want = jzero.update_exchange_axis_bytes(jnet.params, 4, 2, jspecs)
    got = zero.update_exchange_axis_bytes(net.params, 4, 2, specs)
    assert got == want
    assert got["model"] == 0 and got["cross_axis_bytes"] == 0
    assert got["naive_ravel_cross_axis_bytes"] > 0 and got["data"] > 0
    for mode in ("dense", "sharded", "fsdp", "encoded"):
        w = jzero.exchange_report(jnet.params, 4, mode, model_shards=2,
                                  tp_specs=jspecs)
        g = zero.exchange_report(net.params, 4, mode, model_shards=2,
                                 tp_specs=specs)
        assert g == w, mode
        assert g["axis_bytes"]["model"] == 0
    pw = port_wrapper(pair("mlp", "sgd")[1], "mlp", steps=1,
                      **build("sharded"))
    assert pw._axis_bytes["model"] == 0
    assert pw._axis_bytes == got
