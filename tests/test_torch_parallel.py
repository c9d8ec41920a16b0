"""Data-parallel training in the port against the JAX package, on the
CPU.

The port's ``ParallelWrapper`` runs N CPU replicas, one thread each
(``parallel/mesh.ThreadMesh``); the JAX package's runs one global-view
program over N of the conftest's virtual devices. Both start from the
JAX package's initial weights (``params_from_jax``) and take 3 steps on
the same numpy global batches; parameters and BatchNormalization
running statistics are held at the bars of ``tests/test_parallel.py``,
rtol 2e-4 / atol 2e-5. A conv + BatchNormalization graph needs the
global batch's statistics (``ops/bn_train.py``); taken per replica they
miss the bar, which a negative case shows. Within the port the dense and
the sharded (ZeRO-1) exchange are bitwise equal: the thread mesh sums in
rank order and the updater math is elementwise.
"""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.activations import Activation as JAct
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.learning import updaters as ju
from deeplearning4j_tpu.learning.updaters import dp_ravel as jax_dp_ravel
from deeplearning4j_tpu.nn.conf import graph_vertices as jv
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.nn.conf.builders import \
    NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT
from deeplearning4j_tpu.nn.graph import ComputationGraph as JCG
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.parallel import ParallelWrapper as JaxWrapper
from deeplearning4j_tpu.parallel import zero as jzero
from deeplearning4j_tpu_torch.activations import Activation
from deeplearning4j_tpu_torch.common.environment import Environment
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.learning import updaters as tu
from deeplearning4j_tpu_torch.learning.updaters import (DP_SHARDED_KEY,
                                                        dp_ravel)
from deeplearning4j_tpu_torch.nn.conf import graph_vertices as tv
from deeplearning4j_tpu_torch.nn.conf import layers as tl
from deeplearning4j_tpu_torch.nn.conf.builders import \
    NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import mesh as tmesh
from deeplearning4j_tpu_torch.parallel import zero
from deeplearning4j_tpu_torch.parallel.mesh import (MeshFactory, ThreadMesh,
                                                    make_mesh,
                                                    pad_batch_to_multiple)
from deeplearning4j_tpu_torch.parallel.scaling import (measure_dp_scaling,
                                                       scaling_report)
from deeplearning4j_tpu_torch.parallel.wrapper import ParallelWrapper
from deeplearning4j_tpu_torch.utils.serializer import (params_from_jax,
                                                       params_to_jax)
from torch_parity import one_intraop_thread  # noqa: F401,E402

RTOL, ATOL = 2e-4, 2e-5
TIMEOUT_S = 60.0


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for v in ("DL4J_TORCH_SHARDED_UPDATE", "DL4J_TORCH_DEVICE_PREFETCH",
              "DL4J_TORCH_FUSED_CONV", "DL4J_TORCH_FUSED_BN_BWD",
              "DL4J_TORCH_FSDP", "DL4J_TORCH_ENCODED_UPDATE"):
        monkeypatch.delenv(v, raising=False)
    Environment.reset()
    yield
    Environment.reset()


def _np_tree(tree):
    return {k: {n: np.asarray(a) for n, a in sub.items()}
            for k, sub in tree.items()}


def _port_of(jnet, cls, conf):
    p, s = params_from_jax(_np_tree(jnet.params), _np_tree(jnet.states),
                           conf)
    return cls(conf).set_params(p, s, "cpu")


def _same_model(jnet, net, rtol=RTOL, atol=ATOL):
    want = params_to_jax(
        params_from_jax(_np_tree(jnet.params), {}, net.conf)[0], net.conf)
    got = params_to_jax(net.params, net.conf)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)
    for k, sub in jnet.states.items():
        for n, a in sub.items():
            np.testing.assert_allclose(net.states[k][n].numpy(),
                                       np.asarray(a), rtol=rtol, atol=atol,
                                       err_msg=f"{k}/{n}")


# -- the two networks -------------------------------------------------------
def _mlp_conf(NNC, IT, L, Act, up):
    """The JAX package's DP test MLP (``tests/test_parallel.py``)."""
    return (NNC.Builder().seed(7).updater(up).list()
            .layer(L.DenseLayer(n_in=8, n_out=16, activation=Act.TANH))
            .layer(L.OutputLayer(n_out=3, activation=Act.SOFTMAX))
            .set_input_type(IT.feed_forward(8)).build())


def _mlp_pair(jup, tup):
    jnet = JMLN(_mlp_conf(JNNC, JIT, jl, JAct, jup)).init()
    return jnet, _port_of(jnet, MultiLayerNetwork,
                          _mlp_conf(NeuralNetConfiguration, InputType, tl,
                                    Activation, tup))


def _mlp_batch(seed, n=64):
    r = np.random.RandomState(seed)
    return (r.randn(n, 8).astype(np.float32),
            np.eye(3, dtype=np.float32)[r.randint(0, 3, n)])


def _graph_conf(NNC, IT, L, V, Act, up, dropout=None):
    """conv, BatchNormalization, a 1x1 conv added back, average pool,
    dense, softmax."""
    gb = (NNC.Builder().seed(11).updater(up).graph_builder()
          .add_inputs("in").set_input_types(IT.convolutional(12, 12, 3)))
    gb.add_layer("c1", L.ConvolutionLayer(n_out=8, kernel_size=(3, 3),
                                          activation=Act.RELU), "in")
    gb.add_layer("bn1", L.BatchNormalization(), "c1")
    gb.add_layer("c2", L.ConvolutionLayer(n_out=8, kernel_size=(1, 1),
                                          activation=Act.IDENTITY), "bn1")
    gb.add_vertex("add", V.ElementWiseVertex(V.ElementWiseVertex.Op.Add),
                  "bn1", "c2")
    gb.add_layer("pool", L.GlobalPoolingLayer(
        pooling_type=L.PoolingType.AVG), "add")
    gb.add_layer("d1", L.DenseLayer(n_out=16, activation=Act.RELU,
                                    dropout=dropout), "pool")
    gb.add_layer("out", L.OutputLayer(n_out=4, activation=Act.SOFTMAX),
                 "d1")
    gb.set_outputs("out")
    return gb.build()


def _graph_pair(jup, tup):
    jnet = JCG(_graph_conf(JNNC, JIT, jl, jv, JAct, jup)).init()
    return jnet, _port_of(jnet, ComputationGraph,
                          _graph_conf(NeuralNetConfiguration, InputType, tl,
                                      tv, Activation, tup))


def _graph_batch(seed, n=16):
    r = np.random.RandomState(seed)
    # a per-channel offset, so per-replica statistics would differ
    x = r.randn(n, 12, 12, 3).astype(np.float32)
    x[: n // 2] += 1.5
    return x, np.eye(4, dtype=np.float32)[r.randint(0, 4, n)]


PAIRS = {"mlp": (_mlp_pair, _mlp_batch), "conv_bn": (_graph_pair,
                                                     _graph_batch)}


def _cpu_wrapper(net, n, mode):
    return ParallelWrapper(net, make_mesh(devices=["cpu"] * n,
                                          timeout_s=TIMEOUT_S),
                           update_exchange=mode)


def _run_pair(kind, n, mode, steps=3):
    make, batch = PAIRS[kind]
    jnet, net = make(ju.Nesterovs(0.1, 0.9), tu.Nesterovs(0.1, 0.9))
    jpw = JaxWrapper.Builder(jnet).workers(n).update_exchange(mode).build()
    pw = _cpu_wrapper(net, n, mode)
    for s in range(steps):
        x, y = batch(s)
        jpw.fit_batch(JDataSet(x, y))
        pw.fit_batch(DataSet(x, y))
        np.testing.assert_allclose(net.score(), float(jnet.score()),
                                   rtol=RTOL, atol=ATOL)
    return jnet, net, pw


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["dense", "sharded"])
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("kind", ["mlp", "conv_bn"])
def test_parallel_wrapper_matches_jax_wrapper(kind, n, mode):
    """N CPU replicas against the JAX wrapper on an N-device mesh, 3
    Nesterovs steps: parameters, running statistics, the score."""
    jnet, net, pw = _run_pair(kind, n, mode)
    assert pw.update_exchange.value == mode
    assert net.iteration_count == jnet.iteration_count == 3
    assert net.last_batch_size == jnet.last_batch_size
    _same_model(jnet, net)


def test_per_replica_batchnorm_statistics_would_miss_the_bar(monkeypatch):
    """The negative case: with the layer's statistics taken per replica
    (no collective), the 2-replica run leaves the JAX reference."""
    monkeypatch.setattr(tmesh, "current_replica", lambda: None)
    with pytest.raises(AssertionError):
        jnet, net, _ = _run_pair("conv_bn", 2, "dense", steps=1)
        _same_model(jnet, net)


@pytest.mark.parametrize("kind", ["mlp", "conv_bn"])
@pytest.mark.parametrize("up", ["nesterovs", "adam"])
def test_dense_and_sharded_exchanges_are_bitwise_equal(kind, up):
    make, batch = PAIRS[kind]
    ups = {"nesterovs": lambda m: m.Nesterovs(0.1, 0.9),
           "adam": lambda m: m.Adam(1e-2)}[up]
    nets = []
    for mode in ("dense", "sharded"):
        _, net = make(ups(ju), ups(tu))
        pw = _cpu_wrapper(net, 4, mode)
        pw.fit(ListDataSetIterator([DataSet(*batch(s)) for s in range(3)]))
        nets.append(net)
    a, b = nets
    for k in a.params:
        for name in a.params[k]:
            assert torch.equal(a.params[k][name], b.params[k][name]), k
    for k in a.states:
        for name in a.states[k]:
            assert torch.equal(a.states[k][name], b.states[k][name]), k
    for k, slots in a.updater_states.items():
        for slot, sub in slots.items():
            for name, t in sub.items():
                assert torch.equal(t, b.updater_states[k][slot][name])
    assert a.score() == b.score()


def test_sharded_state_is_a_replicas_share_while_bound():
    """ZeRO-1: each replica holds 1/N of the padded flat state, and the
    state gathers back to the dense layout unchanged in value."""
    _, net = _graph_pair(ju.Adam(1e-2), tu.Adam(1e-2))
    net.fit(*_graph_batch(0))
    dense = {k: {s: {n: t.clone() for n, t in sub.items()}
                 for s, sub in v.items()}
             for k, v in net.updater_states.items()}
    pw = _cpu_wrapper(net, 4, "sharded")
    pw._bind()
    shares = pw.mesh.run(lambda r: zero.sharded_state_bytes(
        pw._replicas[r].updater_states))
    whole = zero.sharded_state_bytes(
        zero.states_to_sharded(net.params, dense, 4))
    assert shares == [whole // 4] * 4
    assert zero.dense_state_bytes(dense) <= whole
    pw._unbind(True)
    for k, slots in dense.items():
        for slot, sub in slots.items():
            for name, t in sub.items():
                assert torch.equal(net.updater_states[k][slot][name], t)


def test_states_to_dense_inverts_states_to_sharded():
    _, net = _graph_pair(ju.Adam(1e-2), tu.Adam(1e-2))
    net.fit(*_graph_batch(0))
    for n in (1, 3, 4):
        sharded = zero.states_to_sharded(net.params, net.updater_states, n)
        assert all(DP_SHARDED_KEY in s for k, s in sharded.items()
                   if net.updater_states[k])
        back = zero.states_to_dense(net.params, sharded)
        for k, slots in net.updater_states.items():
            for slot, sub in slots.items():
                for name, t in sub.items():
                    assert torch.equal(back[k][slot][name], t)
        # flats for another shard count re-ravel
        again = zero.states_to_sharded(net.params, sharded, 2)
        assert zero.states_to_dense(net.params, again).keys() == back.keys()


def test_flat_layout_and_exchange_bytes_match_jax():
    jnet, net = _graph_pair(ju.Sgd(0.1), tu.Sgd(0.1))
    for k in ("c1", "bn1", "d1"):
        for n in (1, 3, 8):
            jflats, jspec = jax_dp_ravel(jnet.params[k], n)
            flats, spec = dp_ravel(
                {name: torch.from_numpy(np.array(jnet.params[k][name]))
                 for name in jnet.params[k]}, n)
            assert spec.sizes == jspec.sizes
            for dt in jflats:
                np.testing.assert_array_equal(flats[dt].numpy(),
                                              np.asarray(jflats[dt]))
    for n in (1, 2, 4, 8):
        assert zero.update_exchange_bytes(net.params, n) == \
            jzero.update_exchange_bytes(jnet.params, n)


@pytest.mark.parametrize("requested, n, env, gn, want", [
    ("auto", 4, "", False, "sharded"),
    ("auto", 1, "", False, "dense"),
    ("sharded", 4, "SHARDED_UPDATE", False, "dense"),
    ("fsdp", 4, "SHARDED_UPDATE", False, "dense"),
    ("encoded", 4, "SHARDED_UPDATE", False, "dense"),
    ("auto", 4, "", True, "dense"),
    ("dense", 4, "", False, "dense"),
    ("fsdp", 4, "", False, "fsdp"),
    ("encoded", 4, "", False, "encoded"),
    ("fsdp", 4, "FSDP", False, "sharded"),
    ("encoded", 4, "ENCODED_UPDATE", False, "sharded"),
    ("fsdp", 4, "constraints", False, "sharded"),
])
def test_resolve_update_exchange(monkeypatch, requested, n, env, gn, want):
    """The resolver's ladder against the JAX package's, with the same
    kill switch off in each (``DL4J_TORCH_*`` / ``DL4J_TPU_*``)."""
    from deeplearning4j_tpu.common.environment import \
        Environment as JEnvironment
    from deeplearning4j_tpu.nn.conf.constraints import \
        MaxNormConstraint as JMaxNorm
    from deeplearning4j_tpu_torch.nn.conf.constraints import \
        MaxNormConstraint
    for pkg in ("TORCH", "TPU"):
        for flag in ("SHARDED_UPDATE", "FSDP", "ENCODED_UPDATE"):
            monkeypatch.setenv(f"DL4J_{pkg}_{flag}",
                               "0" if flag == env else "1")
    Environment.reset()
    JEnvironment.reset()
    try:
        jnet, net = _mlp_pair(ju.Sgd(0.1), tu.Sgd(0.1))
        if gn:
            from deeplearning4j_tpu.nn.conf.builders import \
                GradientNormalization as JGN
            from deeplearning4j_tpu_torch.nn.conf.builders import \
                GradientNormalization
            net.conf.gradient_normalization = \
                GradientNormalization.CLIP_L2_PER_LAYER
            jnet.conf.gradient_normalization = JGN.CLIP_L2_PER_LAYER
        if env == "constraints":
            net.conf.layers[0].constrain_weights = [MaxNormConstraint(1.0)]
            jnet.conf.layers[0].constrain_weights = [JMaxNorm(1.0)]
        mesh = make_mesh(devices=["cpu"] * n)
        got = zero.resolve_update_exchange(mesh, "data", requested, net)
        jmesh = type("JaxMeshShape", (), {"shape": {"data": n}})()
        assert got.value == want == jzero.resolve_update_exchange(
            jmesh, "data", requested, jnet).value
    finally:
        JEnvironment.reset()


def test_odd_batches_trim_and_epochs_count_iterations():
    _, net = _mlp_pair(ju.Sgd(0.1), tu.Sgd(0.1))
    it = ListDataSetIterator([DataSet(*_mlp_batch(i, 32))
                              for i in range(4)])
    pw = ParallelWrapper.Builder(net).workers(4).averaging_frequency(3) \
        .build()
    assert pw.n_workers == 4
    pw.fit(it, n_epochs=3)
    assert net.iteration_count == 12 and net.epoch_count == 3
    assert np.isfinite(net.score())
    pw.fit_batch(DataSet(*_mlp_batch(9, 61)))      # trimmed to 60
    assert net.last_batch_size == 60
    with pytest.raises(ValueError, match="replicas"):
        pw.fit_batch(DataSet(*_mlp_batch(9, 3)))


def test_staged_and_unstaged_wrapper_runs_are_bitwise_equal(monkeypatch):
    runs = []
    for flag in ("1", "0"):
        monkeypatch.setenv("DL4J_TORCH_DEVICE_PREFETCH", flag)
        Environment.reset()
        _, net = _graph_pair(ju.Nesterovs(0.1, 0.9),
                             tu.Nesterovs(0.1, 0.9))
        _cpu_wrapper(net, 2, "sharded").fit(ListDataSetIterator(
            [DataSet(*_graph_batch(s)) for s in range(3)]), n_epochs=2)
        runs.append(net)
    for k in runs[0].params:
        for name, t in runs[0].params[k].items():
            assert torch.equal(t, runs[1].params[k][name])


def test_dropout_masks_are_drawn_over_the_global_batch():
    """A replica takes its rows of the mask one replica would draw for
    the whole batch: the 2-replica run tracks the 1-replica run on the
    same global batches (a per-replica draw would not)."""
    runs = []
    for n in (1, 2):
        net = ComputationGraph(_graph_conf(
            NeuralNetConfiguration, InputType, tl, tv, Activation,
            tu.Sgd(0.1), dropout=0.5)).init("cpu")
        pw = _cpu_wrapper(net, n, "dense")
        for s in range(2):
            pw.fit_batch(DataSet(*_graph_batch(s)))
        runs.append(net)
    for k in runs[0].params:
        for name, t in runs[0].params[k].items():
            np.testing.assert_allclose(runs[1].params[k][name].numpy(),
                                       t.numpy(), rtol=RTOL, atol=ATOL,
                                       err_msg=f"{k}/{name}")


def test_mesh_construction_and_refusals():
    m = make_mesh(devices=["cpu"] * 8)
    assert m.shape == {"data": 8}
    assert make_mesh({"data": -1}, ["cpu"] * 4).size == 4
    with pytest.raises(ValueError):
        make_mesh({"data": 3}, ["cpu"] * 8)
    # named axes lay the ranks out row-major; on a mesh with another axis
    # above 1 the data-parallel paths exchange over a replica's data group
    dm = make_mesh({"data": -1, "model": 2}, ["cpu"] * 8)
    assert dm.shape == {"data": 4, "model": 2}
    assert dm.axis_groups("model")[1] == [2, 3]
    grp = dm.replica(3).group("data")
    assert (grp.rank, grp.size) == (1, 4) and dm.has_other_axes()
    full = MeshFactory.full(data=2, model=1, seq=2, devices=["cpu"] * 4)
    assert full.shape == {"data": 2, "model": 1, "seq": 2, "stage": 1}
    assert full.has_other_axes() and not make_mesh(
        devices=["cpu"] * 2).has_other_axes()
    assert MeshFactory.data_parallel(2, devices=["cpu"] * 4).size == 2
    # two replicas on one card would deadlock in autograd's backward
    with pytest.raises(ValueError, match="one CUDA device"):
        ThreadMesh(["cuda:0", "cuda:0"])
    x, b = pad_batch_to_multiple(np.arange(5.0), 4)
    assert b == 5 and list(x) == [0, 1, 2, 3, 4, 4, 4, 4]
    t, _ = pad_batch_to_multiple(torch.arange(6.0), 3)
    assert t.shape[0] == 6


def test_thread_mesh_collectives_sum_in_rank_order():
    mesh = make_mesh(devices=["cpu"] * 3, timeout_s=TIMEOUT_S)
    vals = [torch.tensor([1e8, 1.0, -1e8, 0.5, 2.0, 3.0]) * (r + 1)
            for r in range(3)]

    def body(r):
        rep = mesh.replica(r)
        return (rep.all_reduce_sum(vals[r]), rep.reduce_scatter(vals[r]),
                rep.all_gather(vals[r][:2]), rep.broadcast(vals[r], 1))

    out = mesh.run(body)
    want = vals[0].clone() + vals[1] + vals[2]
    for r, (ar, rs, ag, bc) in enumerate(out):
        assert torch.equal(ar, want)
        assert torch.equal(rs, want[2 * r:2 * r + 2])
        assert torch.equal(ag, torch.cat([v[:2] for v in vals]))
        assert torch.equal(bc, vals[1])


def test_a_failing_replica_fails_the_run_without_hanging():
    mesh = make_mesh(devices=["cpu"] * 3, timeout_s=TIMEOUT_S)

    def body(r):
        if r == 2:
            raise RuntimeError("replica 2 exploded")
        return mesh.replica(r).all_reduce_sum(torch.ones(2))

    with pytest.raises(RuntimeError, match="exploded"):
        mesh.run(body)
    # the mesh is usable again
    out = mesh.run(lambda r: mesh.replica(r).all_reduce_sum(torch.ones(1)))
    assert [float(o) for o in out] == [3.0] * 3


def test_unported_options_raise_naming_their_item():
    """remesh (item 14) raises; tensor and pipeline parallelism take
    their degrees (``tests/test_torch_2d_parallel.py`` and
    ``tests/test_torch_pipeline_trainer.py`` train them); the encoded
    and fsdp exchanges, ported, train."""
    _, net = _mlp_pair(ju.Sgd(0.1), tu.Sgd(0.1))
    b = ParallelWrapper.Builder(net)
    assert b.tensor_parallel(1) is b and b.pipeline_stages(1) is b
    with pytest.raises(ValueError, match="tensor_parallel"):
        b.tensor_parallel(0)
    with pytest.raises(ValueError, match="pipeline_stages"):
        b.pipeline_stages(0)
    with pytest.raises(NotImplementedError, match="item 14"):
        _cpu_wrapper(net, 2, "auto").remesh(workers=1)
    pw = b.mesh(make_mesh(devices=["cpu"] * 2, timeout_s=TIMEOUT_S)) \
        .update_exchange("encoded").encoding("int8").build()
    pw.fit_batch(DataSet(*_mlp_batch(0)))
    assert pw.update_exchange is zero.UpdateExchange.ENCODED
    assert pw.encoding.scheme == "int8"
    pw = _cpu_wrapper(net, 2, "fsdp")
    pw.fit_batch(DataSet(*_mlp_batch(1)))
    assert pw.update_exchange is zero.UpdateExchange.FSDP
    assert net.iteration_count == 2 and np.isfinite(net.score())


def test_scaling_harness_reports_each_size():
    def factory():
        return _mlp_pair(ju.Sgd(0.1), tu.Sgd(0.1))[1]

    res = measure_dp_scaling(factory, lambda b: DataSet(*_mlp_batch(0, b)),
                             (1, 2, 16), per_chip_batch=4, steps=2,
                             warmup=1, devices=["cpu"] * 2)
    assert res["sizes"] == [1, 2] and res["base"] == 1
    assert res["efficiency"][1] == pytest.approx(1.0)
    assert all(v > 0 for v in res["throughput"].values())
    assert "efficiency" in scaling_report(res)
