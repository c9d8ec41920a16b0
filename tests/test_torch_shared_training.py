"""SharedTrainingMaster in the port against the JAX package's
data-parallel wrapper, on the CPU.

Each rank is its own process (``python -c``, no JAX imported), joined by
a gloo process group that meets through a ``file://`` store in the
test's temporary directory (no TCP port, so parallel test workers never
collide) and whose collectives time out after 60 s; every child is
waited for with a limit and killed past it. Each rank feeds its half of
each global batch; after 3 Nesterovs steps the parameters and the
BatchNormalization running statistics equal the JAX ``ParallelWrapper``
on a 2-device mesh at the bars of ``tests/test_parallel.py`` (rtol 2e-4
/ atol 2e-5) under each exchange (dense, sharded, fsdp, encoded), and
the ranks equal each other bit for bit. One rank
alone equals the port's one-replica ``ParallelWrapper`` bit for bit.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.activations import Activation as JAct
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.iterators import \
    ListDataSetIterator as JList
from deeplearning4j_tpu.learning import updaters as ju
from deeplearning4j_tpu.nn.conf import graph_vertices as jv
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.nn.conf.builders import \
    NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT
from deeplearning4j_tpu.nn.graph import ComputationGraph as JCG
from deeplearning4j_tpu.parallel import ParallelWrapper as JaxWrapper
from deeplearning4j_tpu.parallel import SharedTrainingMaster as JMaster
from deeplearning4j_tpu_torch.activations import Activation
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.learning import updaters as tu
from deeplearning4j_tpu_torch.nn.conf import graph_vertices as tv
from deeplearning4j_tpu_torch.nn.conf import layers as tl
from deeplearning4j_tpu_torch.nn.conf.builders import \
    NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.parallel.mesh import make_mesh
from deeplearning4j_tpu_torch.parallel.sharedtraining import (
    ParameterAveragingTrainingMaster, SharedTrainingMaster)
from deeplearning4j_tpu_torch.parallel.wrapper import ParallelWrapper
from deeplearning4j_tpu_torch.utils.serializer import (params_from_jax,
                                                       params_to_jax)
from torch_parity import one_intraop_thread  # noqa: F401,E402

RTOL, ATOL = 2e-4, 2e-5
ROOT = Path(__file__).resolve().parents[1]
STEPS = 3
CHILD_TIMEOUT_S = 120


def _graph_conf(NNC, IT, L, V, Act, up):
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
    gb.add_layer("d1", L.DenseLayer(n_out=16, activation=Act.RELU), "pool")
    gb.add_layer("out", L.OutputLayer(n_out=4, activation=Act.SOFTMAX),
                 "d1")
    gb.set_outputs("out")
    return gb.build()


def _np_tree(tree):
    return {k: {n: np.asarray(a) for n, a in sub.items()}
            for k, sub in tree.items()}


def _pair():
    jnet = JCG(_graph_conf(JNNC, JIT, jl, jv, JAct, ju.Nesterovs(0.1, 0.9))
               ).init()
    conf = _graph_conf(NeuralNetConfiguration, InputType, tl, tv,
                       Activation, tu.Nesterovs(0.1, 0.9))
    p, s = params_from_jax(_np_tree(jnet.params), _np_tree(jnet.states),
                           conf)
    return jnet, ComputationGraph(conf).set_params(p, s, "cpu")


def _batches(n=16):
    out = []
    for seed in range(STEPS):
        r = np.random.RandomState(seed)
        x = r.randn(n, 12, 12, 3).astype(np.float32)
        x[: n // 2] += 1.5
        out.append((x, np.eye(4, dtype=np.float32)[r.randint(0, 4, n)]))
    return out


def _same_as_jax(jnet, params, states, conf):
    want = params_to_jax(
        params_from_jax(_np_tree(jnet.dense_params()), {}, conf)[0], conf)
    got = params_to_jax(params, conf)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    for k, sub in jnet.states.items():
        for n, a in sub.items():
            np.testing.assert_allclose(states[k][n].numpy(), np.asarray(a),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"{k}/{n}")


_CHILD = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    sys.path.insert(0, sys.argv[1])
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.iterators import \\
        ListDataSetIterator
    from deeplearning4j_tpu_torch.nn.conf.graph_conf import \\
        ComputationGraphConfiguration
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.parallel.sharedtraining import \\
        SharedTrainingMaster
    torch.set_num_threads(1)
    work, rank, world, mode = sys.argv[2], int(sys.argv[3]), \\
        int(sys.argv[4]), sys.argv[5]
    init = torch.load(f"{work}/init.pt")
    net = ComputationGraph(ComputationGraphConfiguration.from_json(
        init["conf"])).set_params(init["params"], init["states"], "cpu")
    data = np.load(f"{work}/batches.npz")
    shards = []
    for i in range(len(data.files) // 2):
        x, y = data[f"x{i}"], data[f"y{i}"]
        k = x.shape[0] // world
        shards.append(DataSet(x[rank * k:(rank + 1) * k],
                              y[rank * k:(rank + 1) * k]))
    master = (SharedTrainingMaster.Builder(k)
              .coordinator(f"file://{work}/store", world, rank)
              .update_exchange(mode).collective_timeout(60).build())
    try:
        master.fit(net, ListDataSetIterator(shards))
    finally:
        master.shutdown()
    from deeplearning4j_tpu_torch.common import stepstats
    torch.save({"params": net.params, "states": net.states,
                "score": net.score(), "batch": net.last_batch_size,
                "iterations": net.iteration_count,
                "observatory": master.observatory_report(),
                "breakdowns": stepstats.collector().records()},
               f"{work}/rank{rank}.pt")
""")


def _run_ranks(tmp_path, net, batches, world, mode):
    torch.save({"conf": net.conf.to_json(), "params": net.params,
                "states": net.states}, tmp_path / "init.pt")
    np.savez(tmp_path / "batches.npz",
             **{f"{k}{i}": a for i, b in enumerate(batches)
                for k, a in zip("xy", b)})
    # the observatory's leader takes any free port (and broadcasts it)
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "DL4J_TORCH_OBSERVATORY_PORT": "0"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CHILD, str(ROOT), str(tmp_path), str(r),
         str(world), mode], env=env, cwd=str(tmp_path),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
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
        assert p.returncode == 0, out[-3000:]
    return [torch.load(tmp_path / f"rank{r}.pt") for r in range(world)]


@pytest.mark.parametrize("mode", ["dense", "sharded", "fsdp", "encoded"])
def test_two_process_gloo_master_matches_the_jax_wrapper(tmp_path, mode):
    jnet, net = _pair()
    batches = _batches()
    ranks = _run_ranks(tmp_path, net, batches, 2, mode)
    jpw = JaxWrapper.Builder(jnet).workers(2).update_exchange(mode).build()
    for x, y in batches:
        jpw.fit_batch(JDataSet(x, y))
    for res in ranks:
        assert res["iterations"] == STEPS
        assert res["batch"] == 16
        np.testing.assert_allclose(res["score"], float(jnet.score()),
                                   rtol=RTOL, atol=ATOL)
        _same_as_jax(jnet, res["params"], res["states"], net.conf)
    a, b = ranks
    for k in a["params"]:
        for n, t in a["params"][k].items():
            assert torch.equal(t, b["params"][k][n]), f"{k}/{n}"


def test_one_process_group_equals_the_one_replica_wrapper(tmp_path):
    _, net = _pair()
    batches = _batches()
    (res,) = _run_ranks(tmp_path, net, batches, 1, "auto")
    # the child's thread count, so the CPU kernels sum in its order
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ParallelWrapper(net, make_mesh(devices=["cpu"])).fit(
            ListDataSetIterator([DataSet(x, y) for x, y in batches]))
    finally:
        torch.set_num_threads(threads)
    for k, sub in net.params.items():
        for n, t in sub.items():
            assert torch.equal(t, res["params"][k][n]), f"{k}/{n}"
    for k, sub in net.states.items():
        for n, t in sub.items():
            assert torch.equal(t, res["states"][k][n]), f"{k}/{n}"
    assert res["score"] == net.score()


def test_single_process_master_matches_the_jax_master():
    """No coordinator: a ParallelWrapper over workers_per_node local
    replicas, as in the JAX package."""
    jnet, net = _pair()
    batches = _batches()
    JMaster.Builder(8).workers_per_node(2).build().fit(
        jnet, JList([JDataSet(x, y) for x, y in batches]), n_epochs=2)
    SharedTrainingMaster.Builder(8).workers_per_node(2) \
        .threshold_algorithm(object()).build().fit(
            net, ListDataSetIterator([DataSet(x, y) for x, y in batches]),
            n_epochs=2)
    assert net.iteration_count == jnet.iteration_count == 2 * STEPS
    _same_as_jax(jnet, net.params, net.states, net.conf)


def test_master_builders_and_refusals(tmp_path):
    _, net = _pair()
    m = ParameterAveragingTrainingMaster.Builder(16) \
        .averaging_frequency(5).batch_size_per_worker(8).build()
    assert isinstance(m, ParameterAveragingTrainingMaster)
    assert m.config.batch_size_per_worker == 8
    with pytest.raises(ValueError, match="update_exchange"):
        SharedTrainingMaster.Builder().update_exchange("bogus")
    with pytest.raises(NotImplementedError, match="item 14"):
        SharedTrainingMaster().fit(net, ListDataSetIterator([]),
                                   checkpoint_dir=str(tmp_path))
    tp = SharedTrainingMaster.Builder().tensor_parallel(2) \
        .pipeline_stages(2).build()
    assert tp.config.tensor_parallel == 2
    assert tp.config.pipeline_stages == 2
    with pytest.raises(ValueError, match="tensor_parallel"):
        SharedTrainingMaster.Builder().tensor_parallel(0)
    enc = SharedTrainingMaster.Builder().update_exchange("fsdp") \
        .encoding("int8").build().config
    assert enc.encoding.scheme == "int8" and enc.update_exchange == "fsdp"
    assert json.loads(net.conf.to_json())


def test_two_process_master_observatory_report(tmp_path):
    """Each rank labels its step breakdowns with its rank and ships them
    to rank 0's aggregator over the sidecar socket: the leader's report
    has every step of both workers, the other rank has none."""
    _, net = _pair()
    ranks = _run_ranks(tmp_path, net, _batches(), 2, "dense")
    lead, other = ranks[0]["observatory"], ranks[1]["observatory"]
    assert other is None
    assert lead["steps_merged"] == STEPS and lead["workers"] == 2
    assert lead["trips"] >= 0 and lead["max_skew_seconds"] >= 0
    assert set(lead["worker_clock_offsets_s"]) == {0, 1}
    for r, res in enumerate(ranks):
        bd = res["breakdowns"]
        assert [b["worker"] for b in bd] == [r] * STEPS
        assert all(b["n_workers"] == 2 for b in bd)
