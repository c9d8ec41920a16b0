"""The pipeline fit path of the port (``parallel/pipeline.PipelineTrainer``
and the ``pipeline_stages`` builders) against the JAX package's run of
the same configuration, on the CPU.

The port runs on a thread mesh of CPU replicas (one thread a rank, each
running its own stage's ops of the shared tick table), the JAX package
on the 8 forced host devices of ``tests/conftest.py``; both start from
the JAX package's initial weights (``params_from_jax``) and take the same
numpy batches. The networks and sizes are ``tests/test_pipeline.py``'s
(the 8-16-3 MLP, the one-hidden-layer graph, 16-row batches in 4
microbatches), plus the conv + BatchNormalization graph of
``tests/test_torch_parallel.py``, whose byte-balanced partition cuts
between ``c2`` and the add, so the skip from ``bn1`` crosses the stage
boundary. Tolerances are the JAX tests' (``tests/test_pipeline.py``):
rtol 1e-6 / atol 1e-7 for Sgd, 1e-5 / 1e-6 for Nesterovs and Adam,
2e-5 / 1e-6 for the dp × tp × pp layout; the conv graph's parameters and
running statistics are held at ``tests/test_torch_parallel.py``'s bars.
Each JAX run is made once a module (``jax_runs``).
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from torch_parity import one_intraop_thread  # noqa: F401

import deeplearning4j_tpu.activations as jact
import deeplearning4j_tpu.learning.updaters as jup
import deeplearning4j_tpu.lossfunctions as jloss
import deeplearning4j_tpu.nn.conf.builders as jbuild
import deeplearning4j_tpu.nn.conf.graph_vertices as jverts
import deeplearning4j_tpu.nn.conf.inputs as jinputs
import deeplearning4j_tpu.nn.conf.layers as jlayers
import deeplearning4j_tpu.nn.weights as jweights
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.graph import ComputationGraph as JCG
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.parallel import ParallelWrapper as JWrapper
from deeplearning4j_tpu.parallel import PipelineTrainer as JTrainer
from deeplearning4j_tpu.parallel import make_mesh as jax_mesh
from deeplearning4j_tpu.parallel import zero as jzero
import deeplearning4j_tpu_torch.activations as tact
import deeplearning4j_tpu_torch.learning.updaters as tup
import deeplearning4j_tpu_torch.lossfunctions as tloss
import deeplearning4j_tpu_torch.nn.conf.builders as tbuild
import deeplearning4j_tpu_torch.nn.conf.graph_vertices as tverts
import deeplearning4j_tpu_torch.nn.conf.inputs as tinputs
import deeplearning4j_tpu_torch.nn.conf.layers as tlayers
import deeplearning4j_tpu_torch.nn.weights as tweights
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import zero
from deeplearning4j_tpu_torch.parallel.mesh import make_mesh
from deeplearning4j_tpu_torch.parallel.pipeline import (PipelineTrainer,
                                                        to_microbatches)
from deeplearning4j_tpu_torch.parallel.sharedtraining import \
    SharedTrainingMaster
from deeplearning4j_tpu_torch.parallel.wrapper import (ParallelWrapper,
                                                       fit_mesh_axes)
from deeplearning4j_tpu_torch.utils.serializer import (ModelSerializer,
                                                       params_from_jax,
                                                       params_to_jax)

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 60.0
CHILD_TIMEOUT_S = 120
#: the JAX tests' bars by updater (tests/test_pipeline.py)
BARS = {"sgd": dict(rtol=1e-6, atol=1e-7),
        "nesterovs": dict(rtol=1e-5, atol=1e-6),
        "adam": dict(rtol=1e-5, atol=1e-6)}
BAR_3D = dict(rtol=2e-5, atol=1e-6)
#: the conv + BatchNormalization graph (tests/test_torch_parallel.py)
BAR_BN = dict(rtol=2e-4, atol=2e-5)

J = SimpleNamespace(NNC=jbuild.NeuralNetConfiguration, IT=jinputs.InputType,
                    L=jlayers, V=jverts, Act=jact.Activation,
                    WI=jweights.WeightInit, LF=jloss.LossFunction, up=jup)
T = SimpleNamespace(NNC=tbuild.NeuralNetConfiguration, IT=tinputs.InputType,
                    L=tlayers, V=tverts, Act=tact.Activation,
                    WI=tweights.WeightInit, LF=tloss.LossFunction, up=tup)
UPDATERS = {"sgd": lambda m: m.up.Sgd(0.1),
            "nesterovs": lambda m: m.up.Nesterovs(0.1, 0.9),
            "adam": lambda m: m.up.Adam(0.01)}


# -- the networks (tests/test_pipeline.py's, and the conv graph) ------------
def mlp_conf(m, up, seed=42):
    return (m.NNC.Builder().seed(seed).updater(up)
            .weight_init(m.WI.XAVIER).list()
            .layer(m.L.DenseLayer(n_in=8, n_out=16, activation=m.Act.TANH))
            .layer(m.L.OutputLayer(n_out=3, loss_function=m.LF.MCXENT,
                                   activation=m.Act.SOFTMAX))
            .set_input_type(m.IT.feed_forward(8)).build())


def graph_conf(m, up, seed=7):
    return (m.NNC.Builder().seed(seed).updater(up)
            .weight_init(m.WI.XAVIER).graph_builder()
            .add_inputs("in").set_input_types(m.IT.feed_forward(8))
            .add_layer("d1", m.L.DenseLayer(n_out=16,
                                            activation=m.Act.TANH), "in")
            .add_layer("out", m.L.OutputLayer(
                n_out=3, loss_function=m.LF.MCXENT,
                activation=m.Act.SOFTMAX), "d1")
            .set_outputs("out").build())


def bn_graph_conf(m, up, seed=11):
    """conv, BatchNormalization, a 1x1 conv added back, average pool,
    dense, softmax; two stages split it after ``c2``, so ``bn1`` and
    ``c2`` both cross to the add."""
    gb = (m.NNC.Builder().seed(seed).updater(up).graph_builder()
          .add_inputs("in").set_input_types(m.IT.convolutional(12, 12, 3)))
    gb.add_layer("c1", m.L.ConvolutionLayer(
        n_out=8, kernel_size=(3, 3), activation=m.Act.RELU), "in")
    gb.add_layer("bn1", m.L.BatchNormalization(), "c1")
    gb.add_layer("c2", m.L.ConvolutionLayer(
        n_out=8, kernel_size=(1, 1), activation=m.Act.IDENTITY), "bn1")
    gb.add_vertex("add", m.V.ElementWiseVertex(
        m.V.ElementWiseVertex.Op.Add), "bn1", "c2")
    gb.add_layer("pool", m.L.GlobalPoolingLayer(
        pooling_type=m.L.PoolingType.AVG), "add")
    gb.add_layer("d1", m.L.DenseLayer(n_out=16, activation=m.Act.RELU),
                 "pool")
    gb.add_layer("out", m.L.OutputLayer(n_out=4,
                                        activation=m.Act.SOFTMAX), "d1")
    gb.set_outputs("out")
    return gb.build()


NETS = {"mlp": (mlp_conf, JMLN, MultiLayerNetwork),
        "graph": (graph_conf, JCG, ComputationGraph),
        "bn_graph": (bn_graph_conf, JCG, ComputationGraph)}


def np_tree(tree):
    return {k: {n: np.asarray(a) for n, a in sub.items()}
            for k, sub in tree.items()}


def pair(net: str, updater: str, seed=None):
    """The JAX network and the port's, from the JAX package's weights."""
    conf_fn, jcls, tcls = NETS[net]
    kw = {} if seed is None else {"seed": seed}
    jnet = jcls(conf_fn(J, UPDATERS[updater](J), **kw)).init()
    conf = conf_fn(T, UPDATERS[updater](T), **kw)
    p, s = params_from_jax(np_tree(jnet.params), np_tree(jnet.states), conf)
    return jnet, tcls(conf).set_params(p, s, "cpu")


def batch(net: str, seed: int, n: int = 16):
    r = np.random.RandomState(seed)
    if net == "bn_graph":
        x = r.randn(n, 12, 12, 3).astype(np.float32)
        # a per-channel offset, so per-rank statistics would differ
        x[: n // 2] += 1.5
        return x, np.eye(4, dtype=np.float32)[r.randint(0, 4, n)]
    return (r.randn(n, 8).astype(np.float32),
            np.eye(3, dtype=np.float32)[r.randint(0, 3, n)])


def port_mesh(axes):
    n = int(np.prod(list(axes.values())))
    return make_mesh(axes, ["cpu"] * n, timeout_s=TIMEOUT_S)


def jax_axes_mesh(axes):
    n = int(np.prod(list(axes.values())))
    return jax_mesh(axes, jax.devices()[:n])


def snapshot(jnet) -> dict:
    """The JAX network's dense parameters and states as numpy, in the
    port's layout (``params_from_jax``)."""
    dense = jnet.dense_params() if hasattr(jnet, "dense_params") \
        else jnet.params
    return {"params": np_tree(dense), "states": np_tree(jnet.states),
            "score": float(jnet.score())}


def assert_same(want: dict, net, bar: dict, states: bool = False) -> None:
    """The port's parameters (and running statistics) against a JAX
    snapshot, leaf by leaf."""
    conf = net.conf
    ref = params_to_jax(params_from_jax(want["params"], {}, conf)[0], conf)
    got = params_to_jax(net.params, conf)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], err_msg=k, **bar)
    if states:
        for k, sub in want["states"].items():
            for n, a in sub.items():
                np.testing.assert_allclose(net.states[k][n].numpy(), a,
                                           err_msg=f"{k}/{n}", **bar)


# -- the configurations -----------------------------------------------------
#: id -> (network, updater, schedule, mesh axes, steps)
TRAINER_CASES = {
    f"{net}-{lay}-{sched}-{upd}": (net, upd, sched, axes, 4)
    for net, lay, axes, sched, upd in [
        ("mlp", "pp2", {"data": 1, "pipe": 2}, "1f1b", "sgd"),
        ("mlp", "pp2", {"data": 1, "pipe": 2}, "gpipe", "nesterovs"),
        ("mlp", "pp2", {"data": 1, "pipe": 2}, "1f1b", "adam"),
        ("mlp", "dp4pp2", {"data": 4, "pipe": 2}, "gpipe", "sgd"),
        ("mlp", "dp4pp2", {"data": 4, "pipe": 2}, "1f1b", "nesterovs"),
        ("mlp", "dp4pp2", {"data": 4, "pipe": 2}, "gpipe", "adam"),
        ("graph", "pp2", {"data": 1, "pipe": 2}, "1f1b", "adam"),
        ("graph", "pp2", {"data": 1, "pipe": 2}, "gpipe", "sgd"),
        ("graph", "dp4pp2", {"data": 4, "pipe": 2}, "1f1b", "nesterovs"),
    ]}


def jax_trainer_run(net, upd, sched, axes, steps):
    jnet, _ = pair(net, upd)
    tr = JTrainer(jnet, jax_axes_mesh(axes), n_micro=4, schedule=sched)
    scores = []
    for i in range(steps):
        x, y = batch(net, i)
        tr.fit_batch(JDataSet(x, y))
        scores.append(float(jnet.score()))
    return {**snapshot(jnet), "scores": scores,
            "report": {k: v for k, v in tr.last_report.items()
                       if not k.endswith("seconds")}}


def jax_wrapper_run(net, upd, steps, n_batch=64, **build):
    """A JAX ParallelWrapper run: ``build`` sets workers,
    tensor_parallel, pipeline_stages, microbatches, update_exchange."""
    jnet, _ = pair(net, upd)
    b = JWrapper.Builder(jnet)
    for k, v in build.items():
        b = getattr(b, k)(v)
    pw = b.build()
    for i in range(steps):
        x, y = batch(net, i, n_batch)
        pw.fit_batch(JDataSet(x, y))
    return snapshot(jnet)


@pytest.fixture(scope="module")
def jax_runs():
    cache = {}

    def get(key, fn, *args, **kw):
        if key not in cache:
            cache[key] = fn(*args, **kw)
        return cache[key]
    return get


def port_wrapper(net, kind, n_batch=64, steps=4, **build):
    """The port's ParallelWrapper built as ``build`` says, ``steps``
    global batches of ``kind``'s data."""
    b = ParallelWrapper.Builder(net)
    for k, v in build.items():
        b = getattr(b, k)(v)
    pw = b.build()
    for i in range(steps):
        pw.fit_batch(DataSet(*batch(kind, i, n_batch)))
    return pw


# -- trajectories -----------------------------------------------------------
@pytest.mark.parametrize("case", sorted(TRAINER_CASES))
def test_trainer_trajectory_matches_jax(jax_runs, case):
    """4 steps of ``PipelineTrainer.fit_batch`` against the JAX trainer
    on the same mesh layout: the parameters, each step's loss, and the
    report's schedule accounting."""
    net_kind, upd, sched, axes, steps = TRAINER_CASES[case]
    want = jax_runs(case, jax_trainer_run, *TRAINER_CASES[case])
    _, net = pair(net_kind, upd)
    tr = PipelineTrainer(net, port_mesh(axes), n_micro=4, schedule=sched)
    scores = []
    for i in range(steps):
        tr.fit_batch(DataSet(*batch(net_kind, i)))
        scores.append(net.score())
    assert_same(want, net, BARS[upd])
    np.testing.assert_allclose(scores, want["scores"], rtol=1e-5)
    assert net.iteration_count == steps
    rep = tr.last_report
    for k in ("schedule", "n_stages", "n_micro", "bubble_fraction",
              "peak_residency_microbatches", "stage_param_bytes"):
        assert rep[k] == want["report"][k], k
    assert rep["pipe_wire_fwd_bytes"] > 0 and rep["pipe_wire_bwd_bytes"] > 0


@pytest.mark.parametrize("mode", ["dense", "sharded"])
def test_wrapper_pp2_dp4_matches_jax(jax_runs, mode):
    """``ParallelWrapper.Builder(...).workers(4).pipeline_stages(2)``:
    the {data: 4, pipe: 2} mesh, each stage's dense or ZeRO-1 tail over
    its data group, against the JAX wrapper's run."""
    build = dict(workers=4, pipeline_stages=2, microbatches=4,
                 update_exchange=mode)
    want = jax_runs(f"wrapper-{mode}", jax_wrapper_run, "mlp", "adam", 4,
                    **build)
    _, net = pair("mlp", "adam")
    pw = port_wrapper(net, "mlp", **build)
    assert pw.pipeline_stages == 2 and pw.n_workers == 4
    assert dict(pw.mesh.shape) == {"data": 4, "pipe": 2}
    assert pw._pipeline._tail == ("sharded" if mode == "sharded"
                                  else "dense")
    assert pw._exchange_bytes > 0
    assert_same(want, net, BARS["adam"])


def test_3d_dp2_tp2_pp2_sharded_matches_jax(jax_runs):
    """{data: 2, model: 2, pipe: 2}: the stage partition, each stage's
    tensor-parallel specs and the per-stage ZeRO-1 flats together."""
    build = dict(workers=2, tensor_parallel=2, pipeline_stages=2,
                 microbatches=4, update_exchange="sharded")
    want = jax_runs("3d", jax_wrapper_run, "mlp", "adam", 4, **build)
    _, net = pair("mlp", "adam")
    pw = port_wrapper(net, "mlp", **build)
    assert dict(pw.mesh.shape) == {"data": 2, "model": 2, "pipe": 2}
    assert all(pw._pipeline._tp_specs)
    assert_same(want, net, BAR_3D)


def test_bn_graph_skip_across_stages_dp2_pp2_matches_jax(jax_runs):
    """The conv + BatchNormalization graph under {data: 2, pipe: 2}, 3
    Nesterovs steps: microbatch mi is global rows [4 mi, 4 mi + 4), each
    data rank its half, the statistics over the stage's data group;
    every microbatch starts from the step's states and the states kept
    are the last microbatch's. Parameters and running statistics equal
    the JAX trainer's."""
    want = jax_runs("bn", jax_trainer_run, "bn_graph", "nesterovs",
                    "1f1b", {"data": 2, "pipe": 2}, 3)
    _, net = pair("bn_graph", "nesterovs")
    tr = PipelineTrainer(net, port_mesh({"data": 2, "pipe": 2}),
                         n_micro=4, mode="sharded")
    for i in range(3):
        tr.fit_batch(DataSet(*batch("bn_graph", i)))
    assert tr.adapter.outgoing[0] == ["bn1", "c2"]
    assert tr.adapter.incoming[1] == ["bn1", "c2"]
    assert_same(want, net, BAR_BN, states=True)
    np.testing.assert_allclose(net.score(), want["score"], **BAR_BN)


def test_fsdp_downgrades_to_per_stage_zero1(jax_runs):
    build = dict(workers=4, pipeline_stages=2, update_exchange="fsdp")
    want = jax_runs("fsdp", jax_wrapper_run, "mlp", "adam", 1, **build)
    _, net = pair("mlp", "adam")
    pw = port_wrapper(net, "mlp", steps=1, **build)
    assert pw._pipeline._tail == "sharded"
    assert pw._pipeline.n_micro == 4       # 2 x pipeline_stages
    assert_same(want, net, BARS["adam"])


# -- error paths ------------------------------------------------------------
def test_error_paths():
    _, net = pair("mlp", "sgd")
    with pytest.raises(ValueError, match="not divisible by 4"):
        to_microbatches(np.zeros((62, 8), np.float32), 4)
    tr = PipelineTrainer(net, port_mesh({"data": 4, "pipe": 2}), n_micro=4)
    with pytest.raises(ValueError, match="not divisible"):
        tr.fit_batch(DataSet(*batch("mlp", 0, 62)))
    with pytest.raises(ValueError, match="not divisible by 4 data"):
        tr.fit_batch(DataSet(*batch("mlp", 0, 8)))
    with pytest.raises(ValueError, match=">= 2 stages"):
        PipelineTrainer(net, port_mesh({"data": 8}))
    with pytest.raises(ValueError, match="unknown pipeline schedule"):
        PipelineTrainer(net, port_mesh({"data": 1, "pipe": 2}),
                        schedule="interleaved")
    with pytest.raises(ValueError, match="unknown pipeline schedule"):
        ParallelWrapper.Builder(net).pipeline_schedule("interleaved")
    with pytest.raises(ValueError, match="pipeline_stages"):
        ParallelWrapper.Builder(net).pipeline_stages(0)
    with pytest.raises(ValueError, match="does not divide"):
        fit_mesh_axes(8, 1, 3)
    assert fit_mesh_axes(8, 2, 2) == {"data": 2, "model": 2, "pipe": 2}
    # the world is checked before any process group is made
    master = (SharedTrainingMaster.Builder(8).pipeline_stages(2)
              .coordinator("file:///nonexistent/store", 3, 0).build())
    with pytest.raises(ValueError, match="does not divide 3 devices"):
        master._process_mesh(net)
    # the model trains on after a refused batch
    tr.fit_batch(DataSet(*batch("mlp", 1)))
    assert np.isfinite(net.score())


# -- reports ----------------------------------------------------------------
def test_report_and_exchange_accounting_match_jax():
    """``last_report`` has every key of the JAX trainer's (plus its own
    step time), the step breakdown a ``pipeline`` phase, and
    ``exchange_report(pipe_shards=)`` the JAX package's numbers."""
    from deeplearning4j_tpu_torch.common.stepstats import PHASES
    assert "pipeline" in PHASES
    jnet, net = pair("mlp", "sgd")
    jtr = JTrainer(jnet, jax_axes_mesh({"data": 4, "pipe": 2}), n_micro=4)
    jtr.fit_batch(JDataSet(*batch("mlp", 0)))
    tr = PipelineTrainer(net, port_mesh({"data": 4, "pipe": 2}), n_micro=4)
    tr.fit_batch(DataSet(*batch("mlp", 0)))
    rep = tr.last_report
    assert set(jtr.last_report) <= set(rep)
    assert len(rep["stage_idle_seconds"]) == 2
    assert rep["peak_residency_microbatches"] == [2, 1]
    # a data rank's bytes: 4 microbatches of 1 row x 16 features, f32
    assert rep["pipe_wire_fwd_bytes"] == 4 * 1 * 16 * 4
    for mode in ("dense", "sharded", "fsdp"):
        want = jzero.exchange_report(
            jnet.params, 4, mode, pipe_shards=2,
            stage_param_bytes=jtr.last_report["stage_param_bytes"])
        got = zero.exchange_report(
            net.params, 4, mode, pipe_shards=2,
            stage_param_bytes=rep["stage_param_bytes"])
        assert got == want, mode
        assert got["pipeline"]["cross_pipe_bytes"] == 0


# -- checkpoints ------------------------------------------------------------
def test_pp_tp_zip_restores_dense_and_continues_on_1d_mesh(jax_runs,
                                                           tmp_path):
    """2 steps under {data: 2, model: 2, pipe: 2}, written with
    ModelSerializer (the model is dense between fits), restored as a
    plain model that takes 2 more steps on an 8-way data mesh: the JAX
    package's dense 8-way trajectory throughout."""
    want = jax_runs("dense8", jax_wrapper_run, "mlp", "sgd", 4, workers=8,
                    update_exchange="dense")
    _, net = pair("mlp", "sgd")
    pw = (ParallelWrapper.Builder(net).workers(2).tensor_parallel(2)
          .pipeline_stages(2).microbatches(4).update_exchange("sharded")
          .build())
    for i in range(2):
        pw.fit_batch(DataSet(*batch("mlp", i, 64)))
    path = tmp_path / "pp_tp.zip"
    ModelSerializer.write_model(net, str(path))
    restored = ModelSerializer.restore_model(str(path), device="cpu")
    assert restored.iteration_count == 2
    pw2 = ParallelWrapper(restored, port_mesh({"data": 8}),
                          update_exchange="dense")
    assert pw2.pipeline_stages == 1 and pw2.tensor_parallel == 1
    for i in range(2, 4):
        pw2.fit_batch(DataSet(*batch("mlp", i, 64)))
    assert_same(want, restored, BAR_3D)


# -- processes --------------------------------------------------------------
_CHILD = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    sys.path.insert(0, sys.argv[1])
    sys.path.insert(0, sys.argv[1] + "/tests")
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.iterators import \\
        ListDataSetIterator
    from deeplearning4j_tpu_torch.nn.conf.builders import \\
        MultiLayerConfiguration
    from deeplearning4j_tpu_torch.nn.conf.graph_conf import \\
        ComputationGraphConfiguration
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel.mesh import ProcessGroupMesh
    from deeplearning4j_tpu_torch.parallel.sharedtraining import \\
        SharedTrainingMaster
    from deeplearning4j_tpu_torch.parallel.wrapper import fit_mesh_axes
    torch.set_num_threads(1)
    work, rank = sys.argv[2], int(sys.argv[3])
    init = torch.load(f"{work}/init.pt")
    world = ProcessGroupMesh(f"file://{work}/store", 4, rank, device="cpu",
                             backend="gloo", timeout_s=60)
    out = {}
    try:
        for name, (tp, pp, mode) in init["layouts"].items():
            graph, conf, params, states, batches = init[name]
            net = (ComputationGraph(ComputationGraphConfiguration
                                    .from_json(conf)) if graph else
                   MultiLayerNetwork(MultiLayerConfiguration.from_json(
                       conf))).set_params(params, states, "cpu")
            axes = fit_mesh_axes(4, tp, pp)
            dp = axes["data"]
            d = rank // (tp * pp)          # the data index
            shards = []
            for x, y in batches:
                k = x.shape[0] // dp
                shards.append(DataSet(x[d * k:(d + 1) * k],
                                      y[d * k:(d + 1) * k]))
            master = (SharedTrainingMaster.Builder(k)
                      .coordinator(f"file://{work}/store", 4, rank)
                      .tensor_parallel(tp).pipeline_stages(pp)
                      .microbatches(4).update_exchange(mode).build())
            master._mesh = world.with_axes(axes)
            master.fit(net, ListDataSetIterator(shards))
            out[name] = {"params": net.params, "states": net.states,
                         "score": net.score(),
                         "report": master.trainer.last_report}
    finally:
        world.shutdown()
    torch.save(out, f"{work}/rank{rank}.pt")
""")


def test_four_gloo_processes_match_jax(jax_runs, tmp_path):
    """``SharedTrainingMaster`` on four gloo processes, one world, as
    the card's phase 27 runs it: (a) the conv + BatchNormalization graph
    under {data: 2, pipe: 2} with per-stage ZeRO-1, each process feeding
    its data index's shard; (b) the MLP under {data: 1, model: 2, pipe:
    2}, dense tail. Every process ends with the JAX trainer's
    parameters (and running statistics)."""
    layouts = {"a": (1, 2, "sharded"), "b": (2, 2, "dense")}
    nets = {"a": ("bn_graph", "nesterovs", 3), "b": ("mlp", "adam", 3)}
    init = {"layouts": layouts}
    want = {}
    for name, (kind, upd, steps) in nets.items():
        tp, pp, mode = layouts[name]
        _, net = pair(kind, upd)
        batches = [batch(kind, i) for i in range(steps)]
        init[name] = (kind != "mlp", net.conf.to_json(), net.params,
                      net.states, [(torch.from_numpy(x), torch.from_numpy(y))
                                   for x, y in batches])
        if name == "a":
            # the configuration of the single-process conv graph test
            want[name] = jax_runs("bn", jax_trainer_run, kind, upd,
                                  "1f1b", {"data": 2, "pipe": 2}, steps)
        else:
            want[name] = jax_runs(
                "proc-b", jax_wrapper_run, kind, upd, steps, n_batch=16,
                workers=1, tensor_parallel=2, pipeline_stages=2,
                microbatches=4, update_exchange=mode)
    torch.save(init, tmp_path / "init.pt")
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CHILD, str(ROOT), str(tmp_path), str(r)],
        env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(4)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=CHILD_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-6000:]
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(4)]
    for name, (kind, upd, _) in nets.items():
        _, net = pair(kind, upd)
        for res in ranks:
            net.params, net.states = res[name]["params"], \
                res[name]["states"]
            bar = BAR_BN if name == "a" else BARS[upd]
            assert_same(want[name], net, bar, states=name == "a")
            assert res[name]["report"]["peak_residency_microbatches"] == \
                [2, 1]


# -- the attention classifier, tensor x pipeline ----------------------------
def test_attention_classifier_tp2_pp2_with_masks_matches_jax(jax_runs):
    """The masked attention classifier (phase 20's graph at a small
    width) under {data: 1, model: 2, pipe: 2}, dense tail, 3 Sgd steps:
    the embedding, every projection and the head split column-first over
    ``model``, the features mask in every stage; parameters and losses
    against the JAX wrapper's run at the classifier tests' bar."""
    from test_torch_attention_layers import (TRAJ, _classifier_batch,
                                             _classifier_pair)

    def jax_side():
        jg, _ = _classifier_pair()
        pw = (JWrapper.Builder(jg).workers(1).tensor_parallel(2)
              .pipeline_stages(2).microbatches(4).update_exchange("dense")
              .build())
        scores = []
        for step in range(3):
            ids, y, m = _classifier_batch(step)
            pw.fit_batch(JDataSet(ids, y, features_mask=m))
            scores.append(float(jg.score()))
        return {**snapshot(jg), "scores": scores}

    want = jax_runs("classifier", jax_side)
    _, net = _classifier_pair()
    pw = (ParallelWrapper.Builder(net).workers(1).tensor_parallel(2)
          .pipeline_stages(2).microbatches(4).update_exchange("dense")
          .build())
    scores = []
    for step in range(3):
        ids, y, m = _classifier_batch(step)
        pw.fit_batch(DataSet(ids, y, features_mask=m))
        scores.append(net.score())
    specs = pw._tp_specs
    assert set(specs) == {"emb", "sa1", "sa2", "pool", "out"}
    assert all(tuple(ls.compute) in ((None, "model"), ("model",))
               for sub in specs.values() for ls in sub.values())
    np.testing.assert_allclose(scores, want["scores"], **TRAJ)
    assert_same(want, net, TRAJ)
