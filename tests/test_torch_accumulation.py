"""Gradient accumulation and learning-rate schedules in training, the
port against the JAX package on the CPU.

LeNet-5 (``MultiLayerNetwork``) and a small residual
``ComputationGraph`` with a BatchNormalization start from the JAX
package's weights (``params_from_jax``) and take 8 ``fit`` micro-batches
in both packages with ``set_accumulation_steps(4)`` (two updates on the
mean gradient of four micro-batches each), or 8 plain steps with a
schedule as the learning rate, under Nesterovs; a dense stack takes
Adam with a schedule through accumulation (Adam's bias correction and
the schedule see the updates applied). Held per micro-batch (the score)
and at the end (parameters, BatchNormalization running statistics,
updater state) at the reference's gradient bar, rtol 2e-4 / atol 1e-5.
LeNet-5 runs Nesterovs, not its zoo Adam: over 8 steps Adam turns
gradient entries at the level of the two backends' summation noise
(XLA's CPU convolutions against oneDNN's) into steps of the full lr
(``tests/test_torch_training.py`` holds 4 Adam steps at atol 1e-4 for
that reason), while the accumulated gradients themselves agree to ~4e-7
of their largest entry.
The bookkeeping is the JAX package's: ``iteration_count`` and the
listeners count micro-batches, the updater's iteration counts updates
applied, a partial window is applied at an epoch's end and when the
window changes. Two accumulated halves of a batch equal one step on the
whole batch (no BatchNormalization: its statistics are per micro-batch)
within rtol 1e-5.
"""
import numpy as np
import pytest

from deeplearning4j_tpu.activations import Activation as JAct
from deeplearning4j_tpu.learning import schedules as js
from deeplearning4j_tpu.learning import updaters as ju
from deeplearning4j_tpu.models.zoo import LeNet as JaxLeNet
from deeplearning4j_tpu.nn.conf import graph_vertices as jv
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.nn.conf.builders import \
    NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT
from deeplearning4j_tpu.nn.graph import ComputationGraph as JCG
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu_torch.activations import Activation
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.datasets.mnist import synthetic_mnist
from deeplearning4j_tpu_torch.learning import schedules as ts
from deeplearning4j_tpu_torch.learning import updaters as tu
from deeplearning4j_tpu_torch.models.zoo import LeNet
from deeplearning4j_tpu_torch.nn.conf import graph_vertices as tv
from deeplearning4j_tpu_torch.nn.conf import layers as tl
from deeplearning4j_tpu_torch.nn.conf.builders import \
    NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize.listeners import TrainingListener
from deeplearning4j_tpu_torch.utils.serializer import (
    params_from_jax, params_to_jax, updater_state_from_jax)
from torch_parity import one_intraop_thread  # noqa: F401,E402

RTOL, ATOL = 2e-4, 1e-5


def _np_tree(tree):
    return {k: {n: np.asarray(a) for n, a in sub.items()}
            for k, sub in tree.items()}


def _port_of(jnet, cls, conf):
    p, s = params_from_jax(_np_tree(jnet.params), _np_tree(jnet.states),
                           conf)
    return cls(conf).set_params(p, s, "cpu")


def _same_model(jnet, net, atol):
    want = params_to_jax(
        params_from_jax(_np_tree(jnet.params), {}, net.conf)[0], net.conf)
    got = params_to_jax(net.params, net.conf)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=atol,
                                   err_msg=k)
    for k, sub in jnet.states.items():
        for n, a in sub.items():
            np.testing.assert_allclose(net.states[k][n].numpy(),
                                       np.asarray(a), rtol=RTOL, atol=ATOL,
                                       err_msg=f"{k}/{n}")
    jupd = {k: ({s: {n: np.asarray(a) for n, a in sub.items()}
                 for s, sub in v.items()} if isinstance(v, dict) else v)
            for k, v in jnet.updater_states.items()}
    for k, slots in updater_state_from_jax(jupd, net.conf).items():
        for slot, sub in slots.items():
            for n, t in sub.items():
                np.testing.assert_allclose(
                    net.updater_states[k][slot][n], t.numpy(), rtol=RTOL,
                    atol=ATOL, err_msg=f"{k}/{slot}/{n}")


# -- the two networks -------------------------------------------------------
def _lenet(jup, tup):
    jnet = JaxLeNet(updater=jup).init()
    return jnet, _port_of(jnet, MultiLayerNetwork, LeNet(updater=tup).conf())


def _dense(jup, tup):
    def conf(NNC, IT, L, Act, up):
        return (NNC.Builder().seed(5).updater(up).list()
                .layer(L.DenseLayer(n_out=32, activation=Act.RELU))
                .layer(L.DenseLayer(n_out=16, activation=Act.TANH))
                .layer(L.OutputLayer(n_out=4))
                .set_input_type(IT.feed_forward(12)).build())
    jnet = JMLN(conf(JNNC, JIT, jl, JAct, jup)).init()
    return jnet, _port_of(jnet, MultiLayerNetwork,
                          conf(NeuralNetConfiguration, InputType, tl,
                               Activation, tup))


def _dense_batch(seed, n=16):
    r = np.random.RandomState(seed)
    return (r.randn(n, 12).astype(np.float32),
            np.eye(4, dtype=np.float32)[r.randint(0, 4, n)])


def _graph_conf(NNC, IT, L, V, Act, updater, remat_segments=0,
                dropout=None):
    """A residual conv trunk with a BatchNormalization: conv, bn, 1x1
    conv, add (a skip across it), global average pool, dense,
    softmax."""
    gb = (NNC.Builder().seed(11).updater(updater).graph_builder()
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
    if remat_segments:
        gb.remat_segments(remat_segments)
    return gb.build()


def graph_pair(jup, tup, remat_segments=0, dropout=None):
    jnet = JCG(_graph_conf(JNNC, JIT, jl, jv, JAct, jup, remat_segments,
                           dropout)).init()
    conf = _graph_conf(NeuralNetConfiguration, InputType, tl, tv,
                       Activation, tup, remat_segments, dropout)
    return jnet, _port_of(jnet, ComputationGraph, conf)


def _graph_batch(seed, n=8):
    r = np.random.RandomState(seed)
    return (r.randn(n, 12, 12, 3).astype(np.float32),
            np.eye(4, dtype=np.float32)[r.randint(0, 4, n)])


_MNIST = synthetic_mnist(128, True, seed=7)


def _lenet_batch(i, n=16):
    """Micro-batch ``i`` of the synthetic MNIST surrogate, which both
    packages generate identically from its seed."""
    xs, ys = _MNIST
    sl = slice(n * i, n * (i + 1))
    return xs[sl], np.eye(10, dtype=np.float32)[ys[sl]]


def _run_pair(jnet, net, batches, atol):
    for x, y in batches:
        jnet.fit(x, y)
        net.fit(x, y)
        np.testing.assert_allclose(net.score(), float(jnet.score()),
                                   rtol=RTOL, atol=ATOL)
    assert net.iteration_count == jnet.iteration_count == len(batches)
    _same_model(jnet, net, atol)


# -- trajectories against the JAX package ----------------------------------
def test_lenet_eight_micro_batches_accumulated_by_four_match_jax():
    jnet, net = _lenet(ju.Nesterovs(0.01, 0.9), tu.Nesterovs(0.01, 0.9))
    jnet.set_accumulation_steps(4)
    net.set_accumulation_steps(4)
    _run_pair(jnet, net, [_lenet_batch(s) for s in range(8)], ATOL)
    assert net._updates_applied == jnet._updates_applied == 2


def test_graph_eight_micro_batches_accumulated_by_four_match_jax():
    jnet, net = graph_pair(ju.Nesterovs(0.05, 0.9), tu.Nesterovs(0.05, 0.9))
    jnet.set_accumulation_steps(4)
    net.set_accumulation_steps(4)
    _run_pair(jnet, net, [_graph_batch(s) for s in range(8)], ATOL)
    assert net._updates_applied == jnet._updates_applied == 2


SCHEDULES = [
    ("warmup_exponential",
     lambda m: m.WarmupSchedule(3, m.ExponentialSchedule(2e-2, 0.8))),
    ("step", lambda m: m.StepSchedule(2e-2, 0.5, 3.0)),
    ("cycle", lambda m: m.CycleSchedule(1e-3, 2e-2, 1e-4, 6, 2)),
]


@pytest.mark.parametrize("name,make", SCHEDULES, ids=[s[0] for s in
                                                       SCHEDULES])
def test_lenet_eight_steps_with_a_schedule_match_jax(name, make):
    jnet, net = _lenet(ju.Nesterovs(make(js), 0.9),
                       tu.Nesterovs(make(ts), 0.9))
    _run_pair(jnet, net, [_lenet_batch(s) for s in range(8)], ATOL)


@pytest.mark.parametrize("name,make", SCHEDULES[:2],
                         ids=[s[0] for s in SCHEDULES[:2]])
def test_graph_eight_steps_with_a_schedule_match_jax(name, make):
    jnet, net = graph_pair(ju.Nesterovs(make(js), 0.9),
                           tu.Nesterovs(make(ts), 0.9))
    _run_pair(jnet, net, [_graph_batch(s) for s in range(8)], ATOL)


def test_accumulated_adam_schedule_counts_updates_applied():
    """Under accumulation Adam's bias correction and the schedule see
    the updates applied (the updater's iteration), as in the JAX
    package: 8 micro-batches by 2 are 4 updates at lr 1e-2, 5e-3, ..."""
    jnet, net = _dense(ju.Adam(js.StepSchedule(1e-2, 0.5, 1.0)),
                       tu.Adam(ts.StepSchedule(1e-2, 0.5, 1.0)))
    jnet.set_accumulation_steps(2)
    net.set_accumulation_steps(2)
    _run_pair(jnet, net, [_dense_batch(s) for s in range(8)], ATOL)
    assert net._updates_applied == 4 and net.iteration_count == 8


# -- bookkeeping ------------------------------------------------------------
class _Seen(TrainingListener):
    def __init__(self):
        self.iterations, self.epoch_ends = [], 0

    def iteration_done(self, model, iteration, epoch):
        self.iterations.append((iteration, epoch))

    def on_epoch_end(self, model):
        self.epoch_ends += 1


def test_epoch_end_applies_a_partial_window_and_listeners_see_micro_batches():
    jnet, net = graph_pair(ju.Sgd(0.05), tu.Sgd(0.05))
    batches = [_graph_batch(s, 4) for s in range(5)]
    for n in (jnet, net):
        n.set_accumulation_steps(2)
    seen = _Seen()
    net.set_listeners(seen)
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.datasets.iterators import \
        ListDataSetIterator as JList
    jnet.fit(JList([JDataSet(x, y) for x, y in batches]), n_epochs=2)
    net.fit(ListDataSetIterator([DataSet(x, y) for x, y in batches]),
            n_epochs=2)
    assert seen.iterations == [(i, i // 5) for i in range(10)]
    assert seen.epoch_ends == 2
    # 5 micro-batches an epoch: two full windows and a flushed one
    assert net._updates_applied == jnet._updates_applied == 6
    assert net._accum_count == 0 and net._accum_grads is None
    _same_model(jnet, net, ATOL)


def test_changing_the_window_flushes_the_pending_one():
    jnet, net = graph_pair(ju.Sgd(0.05), tu.Sgd(0.05))
    for n in (jnet, net):
        n.set_accumulation_steps(3)
    for x, y in [_graph_batch(s) for s in range(2)]:
        jnet.fit(x, y)
        net.fit(x, y)
    assert net._updates_applied == 0 and net._accum_count == 2
    jnet.set_accumulation_steps(2)
    net.set_accumulation_steps(2)
    assert net._updates_applied == jnet._updates_applied == 1
    assert net.set_accumulation_steps(2) is net
    _same_model(jnet, net, ATOL)


@pytest.mark.parametrize("kind", ["mln", "graph"])
def test_two_accumulated_halves_equal_one_full_batch_step(kind):
    """Mean of the halves' mean-loss gradients = the whole batch's
    gradient, so one accumulated update is one full-batch update."""
    if kind == "mln":
        def make():
            conf = (NeuralNetConfiguration.Builder().seed(5)
                    .updater(tu.Adam(1e-2)).list()
                    .layer(tl.DenseLayer(n_out=32, activation=Activation.RELU))
                    .layer(tl.DenseLayer(n_out=16, activation=Activation.TANH))
                    .layer(tl.OutputLayer(n_out=4))
                    .set_input_type(InputType.feed_forward(12)).build())
            return MultiLayerNetwork(conf).init("cpu")
        r = np.random.RandomState(0)
        x = r.randn(16, 12).astype(np.float32)
        y = np.eye(4, dtype=np.float32)[r.randint(0, 4, 16)]
    else:
        def make():
            conf = _graph_conf(NeuralNetConfiguration, InputType, tl, tv,
                               Activation, tu.Adam(1e-2))
            conf.vertices.pop("bn1")
            conf.vertices["c2"].inputs = ["c1"]
            conf.vertices["add"].inputs = ["c1", "c2"]
            return ComputationGraph(conf).init("cpu")
        x, y = _graph_batch(3, 16)
    full, acc = make(), make()
    full.fit(x, y)
    acc.set_accumulation_steps(2)
    acc.fit(x[:8], y[:8])
    assert acc._updates_applied == 0
    acc.fit(x[8:], y[8:])
    assert acc._updates_applied == 1
    for k, sub in full.params.items():
        for n, t in sub.items():
            np.testing.assert_allclose(acc.params[k][n].numpy(), t.numpy(),
                                       rtol=1e-5, atol=1e-7,
                                       err_msg=f"{k}/{n}")


def test_epoch_schedules_see_the_epoch_count():
    """An EPOCH schedule is evaluated at the trainer's ``epoch_count``
    (the JAX package's trainers pass no epoch, so its EPOCH schedules
    stay at epoch 0: ROADMAP.md, Queue C). Two epochs of three batches:
    the rate the updater is asked for is the schedule's at (iteration,
    epoch) for every step and layer."""
    sched = ts.StepSchedule(1e-2, 0.5, 1.0, ts.ScheduleType.EPOCH)
    _, net = _dense(ju.Sgd(1e-2), tu.Sgd(sched))
    up = net.conf.layers[0].updater
    asked = []
    lr_at = up.lr_at

    def logged(iteration, epoch=0):
        asked.append((iteration, epoch, lr_at(iteration, epoch)))
        return asked[-1][2]
    up.lr_at = logged
    batches = [DataSet(*_dense_batch(s)) for s in range(3)]
    net.fit(ListDataSetIterator(batches), n_epochs=2)
    layers = len(net.conf.layers)
    assert len(asked) == 6 * layers
    for i, (it, ep, lr) in enumerate(asked):
        assert (it, ep) == (i // layers, i // (3 * layers))
        assert lr == pytest.approx(1e-2 * 0.5 ** ep, rel=1e-6)
