"""The port's training path against the JAX package, on the CPU.

ResNet-50 (the JAX builder at ``SMALL`` size) and LeNet-5 start from
the JAX package's initial weights, carried across by
``params_from_jax``, and train on the same numpy batches in both
packages. Held per step (loss) and at the end (every parameter, the
BatchNormalization running stats, the updater state) at the ROADMAP's
gradient bar, rtol 2e-4 / atol 1e-5: both sides compute in float32,
with convolutions and reductions summed in different orders (XLA's CPU
backend against oneDNN), and Nesterovs' momentum carries those
differences from step to step. LeNet-5 trains with Adam, whose update
divides by the root of the second moment: where a gradient entry is at
the level of that summation noise, the update's size is still ~lr, so
its parameters are held at atol 1e-4 (a tenth of one Adam step at lr
1e-3) and its Adam moments at rtol 1e-3.
"""
import json

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.common.environment import Environment as JEnv
from deeplearning4j_tpu.datasets.mnist import synthetic_mnist as jax_mnist
from deeplearning4j_tpu.models.zoo import LeNet as JaxLeNet
from deeplearning4j_tpu.models.zoo import ResNet50 as JaxResNet50
from deeplearning4j_tpu_torch.common.environment import Environment
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.datasets.mnist import (MnistDataSetIterator,
                                                     synthetic_mnist)
from deeplearning4j_tpu_torch.models.zoo import LeNet, ResNet50
from deeplearning4j_tpu_torch.nn.conf.builders import \
    MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize.listeners import (
    ScoreIterationListener, TrainingListener)
from deeplearning4j_tpu_torch.utils.serializer import (
    params_from_jax, params_to_jax, updater_state_from_jax,
    updater_state_to_jax)
from torch_parity import one_intraop_thread  # noqa: F401,E402

RTOL, ATOL = 2e-4, 1e-5
ADAM_ATOL = 1e-4
SMALL = dict(STAGES=((1, 8), (1, 16)), height=32, width=32, num_classes=10)
GATES = ("fused_conv", "fused_bn_bwd")


@pytest.fixture(autouse=True)
def _clean_gates(monkeypatch):
    for v in ("DL4J_TORCH_FUSED_CONV", "DL4J_TORCH_FUSED_BN_BWD"):
        monkeypatch.delenv(v, raising=False)
    envs = (Environment.get(), JEnv.get())
    saved = [{g: e.extra.pop(g, None) for g in GATES} for e in envs]
    yield
    for e, s in zip(envs, saved):
        for g in GATES:
            e.extra.pop(g, None)
            if s[g] is not None:
                e.extra[g] = s[g]


def _np_tree(tree):
    return {k: {n: np.asarray(a) for n, a in sub.items()}
            for k, sub in tree.items()}


def _port_of(jnet, cls, conf):
    p, s = params_from_jax(_np_tree(jnet.params), _np_tree(jnet.states),
                           conf)
    return cls(conf).set_params(p, s, "cpu")


def _assert_same_model(jnet, net, atol=ATOL):
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


def _batch(seed, n=4, size=32, classes=10):
    r = np.random.RandomState(seed)
    return (r.randn(n, size, size, 3).astype(np.float32),
            np.eye(classes, dtype=np.float32)[r.randint(0, classes, n)])


def _resnet_pair():
    jnet = JaxResNet50(**SMALL).init()
    conf = ResNet50(**SMALL).conf()
    assert json.loads(conf.to_json()) == json.loads(jnet.conf.to_json())
    return jnet, _port_of(jnet, ComputationGraph, conf)


# ---------------------------------------------------------------------------
def test_resnet50_small_three_steps_match_jax():
    """Default CPU routes on both sides (the plain math under autodiff),
    Nesterovs(0.1, 0.9) and l2 1e-4 from the zoo: loss per step, final
    parameters, running stats and momentum."""
    jnet, net = _resnet_pair()
    for step in range(3):
        x, y = _batch(step)
        jnet.fit(x, y)
        net.fit(x, y)
        np.testing.assert_allclose(net.score(), float(jnet.score()),
                                   rtol=RTOL, atol=ATOL)
    assert net.iteration_count == jnet.iteration_count == 3
    _assert_same_model(jnet, net)
    want = updater_state_from_jax(_np_tree_upd(jnet.updater_states),
                                  net.conf)
    for k, slots in want.items():
        for n, t in slots.get("v", {}).items():
            np.testing.assert_allclose(net.updater_states[k]["v"][n],
                                       t.numpy(), rtol=RTOL, atol=ATOL)


def _np_tree_upd(upd):
    return {k: ({s: {n: np.asarray(a) for n, a in sub.items()}
                 for s, sub in st.items()} if isinstance(st, dict) else st)
            for k, st in upd.items()}


@pytest.mark.parametrize("torch_gates,jax_gates", [
    ({"fused_conv": "1", "fused_bn_bwd": "1"},
     {"fused_conv": "1", "fused_bn_bwd": True}),
    ({"fused_conv": "1", "fused_bn_bwd": "0"},
     {"fused_conv": "1", "fused_bn_bwd": "0"})],
    ids=["fused_backward", "maybe_fused_bn_train"])
def test_resnet50_small_step_on_forced_routes_matches_jax(torch_gates,
                                                          jax_gates):
    """One step with both sides' gates forced: the fused BN backward
    (statistics, normalize, kernels 5 and 6), and the
    ``maybe_fused_bn_train`` route (kernels 3 and 1, backward kernel 2);
    JAX runs its Pallas kernels in interpret mode."""
    Environment.get().extra.update(torch_gates)
    JEnv.get().extra.update(jax_gates)
    jnet, net = _resnet_pair()
    x, y = _batch(5)
    jnet.fit(x, y)
    net.fit(x, y)
    np.testing.assert_allclose(net.score(), float(jnet.score()), rtol=RTOL,
                               atol=ATOL)
    _assert_same_model(jnet, net)


def test_resnet50_fit_dataset_iterator_and_listeners():
    net = ResNet50(**SMALL).init("cpu")
    x, y = _batch(6, n=8)

    class Seen(TrainingListener):
        def __init__(self):
            self.events = []

        def iteration_done(self, model, iteration, epoch):
            self.events.append(("it", iteration, epoch, model.score()))

        def on_epoch_end(self, model):
            self.events.append(("epoch", model.epoch_count))

    seen = Seen()
    net.set_listeners(seen, ScoreIterationListener(1))
    net.fit(DataSet(x[:4], y[:4]))
    net.fit(ListDataSetIterator(DataSet(x, y), batch_size=4))
    assert net.iteration_count == 3 and net.epoch_count == 1
    assert [e[:3] for e in seen.events] == [
        ("it", 0, 0), ("it", 1, 0), ("it", 2, 0), ("epoch", 1)]
    assert all(np.isfinite(e[3]) for e in seen.events if e[0] == "it")
    before = {k: dict(v) for k, v in net.states.items()}
    score = net.score(DataSet(x[:4], y[:4]))
    assert np.isfinite(score)
    assert all(torch.equal(before[k][n], net.states[k][n])
               for k in before for n in before[k])


# ---------------------------------------------------------------------------
def _lenet_pair():
    jnet = JaxLeNet().init()
    conf = LeNet().conf()
    assert json.loads(conf.to_json()) == json.loads(jnet.conf.to_json())
    again = MultiLayerConfiguration.from_json(jnet.conf.to_json())
    assert json.loads(again.to_json()) == json.loads(jnet.conf.to_json())
    return jnet, _port_of(jnet, MultiLayerNetwork, conf)


def test_lenet_four_steps_match_jax():
    """Adam(1e-3) on the synthetic MNIST surrogate, which both packages
    generate identically from the seed; the conv sites (C = 20, 50) run
    the plain math on both sides' CPU routes."""
    jnet, net = _lenet_pair()
    xj, yj = jax_mnist(64, True, seed=7)
    xs, ys = synthetic_mnist(64, True, seed=7)
    np.testing.assert_array_equal(xs, xj)
    np.testing.assert_array_equal(ys, yj)
    onehot = np.eye(10, dtype=np.float32)[ys]
    for i in range(4):
        sl = slice(16 * i, 16 * (i + 1))
        jnet.fit(xs[sl], onehot[sl])
        net.fit(xs[sl], onehot[sl])
        np.testing.assert_allclose(net.score(), float(jnet.score()),
                                   rtol=RTOL, atol=ATOL)
    _assert_same_model(jnet, net, atol=ADAM_ATOL)
    want = updater_state_from_jax(_np_tree_upd(jnet.updater_states),
                                  net.conf)
    assert want["layer_0"]["m"]["W"].shape == (20, 1, 5, 5)      # OIHW
    for k, slots in want.items():
        for slot, sub in slots.items():
            for n, t in sub.items():
                np.testing.assert_allclose(
                    net.updater_states[k][slot][n], t.numpy(),
                    rtol=1e-3, atol=1e-6, err_msg=f"{k}/{slot}/{n}")


def test_lenet_forced_epilogue_route_matches_jax():
    """Both sides on the conv-epilogue route: kernel 1 forward and
    kernel 2 backward at the two conv sites (the JAX package's C % 8
    gate demotes them there, so its side is the plain math)."""
    Environment.get().extra["fused_conv"] = "1"
    jnet, net = _lenet_pair()
    xs, ys = synthetic_mnist(32, True, seed=8)
    onehot = np.eye(10, dtype=np.float32)[ys]
    for i in range(2):
        sl = slice(16 * i, 16 * (i + 1))
        jnet.fit(xs[sl], onehot[sl])
        net.fit(xs[sl], onehot[sl])
        np.testing.assert_allclose(net.score(), float(jnet.score()),
                                   rtol=RTOL, atol=ATOL)
    _assert_same_model(jnet, net, atol=ADAM_ATOL)


def test_lenet_learns_on_the_surrogate():
    """Both packages pass 0.95 held-out accuracy on the surrogate after
    ~50 Adam steps of batch 64 (and sit near chance for the first 20)."""
    net = LeNet().init("cpu")
    it = MnistDataSetIterator(64, num_examples=64 * 25, seed=3)
    net.fit(it, n_epochs=2)
    assert net.iteration_count == 50 and net.epoch_count == 2
    x, y = synthetic_mnist(256, False, seed=3)
    acc = float((net.output(x).argmax(-1).numpy() == y).mean())
    assert acc > 0.95, acc


def test_updater_state_round_trips_through_the_jax_layout():
    net = LeNet().init("cpu")
    x, y = synthetic_mnist(8, True)
    net.fit(x, np.eye(10, dtype=np.float32)[y])
    flat = updater_state_to_jax(net.updater_states, net.conf)
    assert flat["layer_0/m/W"].shape == (5, 5, 1, 20)           # HWIO
    back = updater_state_from_jax(flat, net.conf)
    for k, slots in net.updater_states.items():
        for slot, sub in slots.items():
            for n, t in sub.items():
                assert torch.equal(back[k][slot][n], t)


@pytest.mark.parametrize("entry", ["lenet", "mln"])
def test_training_entry_points_default_to_the_card(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {"lenet": lambda: LeNet().init(),
             "mln": lambda: MultiLayerNetwork(LeNet().conf()).init()}
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        calls[entry]()
