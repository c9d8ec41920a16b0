"""Input staging in the port (``datasets/prefetch.py``,
``AsyncDataSetIterator``, SameDiff's ``device_prefetch_placeholders``)
on the CPU, and ``ComputationGraph``'s features masks through them.

The JAX package's prefetch cases (``tests/test_device_prefetch.py``)
ported: order, dtype, reset and exhaustion, the feeder's exception, the
flag off, an ``AsyncDataSetIterator`` base unwrapped, the preprocessor
on the feeder. Staging changes timing only: the staged and unstaged
trajectories are bitwise equal for both network kinds and for SameDiff,
and a staged port run tracks the JAX package's staged run from the same
weights (rtol 2e-4 / atol 1e-5, the gradient bar).
"""
import threading

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.activations import Activation as JAct
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.iterators import \
    ListDataSetIterator as JList
from deeplearning4j_tpu.learning import updaters as ju
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.nn.conf.builders import \
    NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu_torch.activations import Activation
from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff
from deeplearning4j_tpu_torch.autodiff.training import (
    TrainingConfig, device_prefetch_placeholders)
from deeplearning4j_tpu_torch.common.environment import Environment
from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.datasets.iterators import (
    AsyncDataSetIterator, DataSetIterator, ListDataSetIterator)
from deeplearning4j_tpu_torch.datasets.prefetch import (
    DevicePrefetcher, maybe_device_prefetch)
from deeplearning4j_tpu_torch.learning import updaters as tu
from deeplearning4j_tpu_torch.models.zoo import ResNet50
from deeplearning4j_tpu_torch.nn.conf import layers as tl
from deeplearning4j_tpu_torch.nn.conf import layers_recurrent as tr
from deeplearning4j_tpu_torch.nn.conf.builders import \
    NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.utils.serializer import (params_from_jax,
                                                       params_to_jax)
from torch_parity import one_intraop_thread  # noqa: F401,E402

RTOL, ATOL = 2e-4, 1e-5
SMALL = dict(STAGES=((1, 8), (1, 16)), height=32, width=32, num_classes=10)


@pytest.fixture(autouse=True)
def _flag_on(monkeypatch):
    monkeypatch.delenv("DL4J_TORCH_DEVICE_PREFETCH", raising=False)
    monkeypatch.delenv("DL4J_TORCH_DEVICE_PREFETCH_DEPTH", raising=False)
    Environment.reset()
    yield
    Environment.reset()


def _mlp_conf(NNC, IT, L, Act, up):
    return (NNC.Builder().seed(42).updater(up).list()
            .layer(L.DenseLayer(n_out=16, activation=Act.RELU))
            .layer(L.OutputLayer(n_out=3, activation=Act.SOFTMAX))
            .set_input_type(IT.feed_forward(4)).build())


def _mlp():
    return MultiLayerNetwork(_mlp_conf(NeuralNetConfiguration, InputType,
                                       tl, Activation, tu.Sgd(1e-2))
                             ).init("cpu")


def _arrays(n=6, batch=32, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(batch, 4).astype(np.float32),
             np.eye(3, dtype=np.float32)[rng.randint(0, 3, batch)])
            for _ in range(n)]


def _batches(n=6, batch=32, seed=0):
    return [DataSet(x, y) for x, y in _arrays(n, batch, seed)]


class _FailingIterator(DataSetIterator):
    """Raises from next() on the feeder thread after its good
    batches."""

    def __init__(self, good):
        super().__init__()
        self._good = good
        self._i = 0

    def reset(self):
        self._i = 0

    def has_next(self):
        return True

    def next(self):  # noqa: A003
        if self._i >= len(self._good):
            raise RuntimeError("ETL exploded")
        ds = self._good[self._i]
        self._i += 1
        return ds

    def batch(self):
        return self._good[0].num_examples()


def _same(a, b):
    for k in a.params:
        for n, t in a.params[k].items():
            assert torch.equal(t, b.params[k][n]), f"{k}/{n}"
    for k in a.states:
        for n, t in a.states[k].items():
            assert torch.equal(t, b.states[k][n]), f"{k}/{n}"


# -- the JAX package's prefetch cases ----------------------------------------
class TestDevicePrefetcher:
    def test_yields_all_batches_in_order(self):
        data = _batches()
        seen = list(DevicePrefetcher(ListDataSetIterator(data), depth=2,
                                     device="cpu"))
        assert len(seen) == len(data)
        for got, want in zip(seen, data):
            np.testing.assert_array_equal(got.features.numpy(),
                                          want.features)

    def test_floats_cast_masks_keep_their_dtype(self):
        x, y = _arrays(1)[0]
        mask = np.ones((32,), np.int8)
        pf = DevicePrefetcher(ListDataSetIterator(
            [DataSet(x.astype(np.float64), y, labels_mask=mask)]),
            dtype=torch.float32, device="cpu")
        ds = next(iter(pf))
        assert isinstance(ds.features, torch.Tensor)
        assert ds.features.dtype == ds.labels.dtype == torch.float32
        assert ds.labels_mask.dtype == torch.int8
        md = next(iter(DevicePrefetcher(ListDataSetIterator(
            [MultiDataSet([x, x], [y])]), dtype=torch.float64,
            device="cpu")))
        assert [f.dtype for f in md.features] == [torch.float64] * 2

    def test_reset_and_exhaustion(self):
        pf = DevicePrefetcher(ListDataSetIterator(_batches(n=4)), depth=2,
                              device="cpu")
        assert len(list(pf)) == 4
        assert not pf.has_next()
        with pytest.raises(StopIteration):
            pf.next()
        pf.reset()
        assert len(list(pf)) == 4
        pf.reset()
        pf.next()
        pf.reset()                           # reset mid-stream
        assert len(list(pf)) == 4

    def test_feeder_exception_propagates(self):
        pf = DevicePrefetcher(_FailingIterator(_batches(n=2)), depth=2,
                              device="cpu")
        with pytest.raises(RuntimeError, match="ETL exploded"):
            list(pf)

    def test_env_flag_off_switch(self, monkeypatch):
        monkeypatch.setenv("DL4J_TORCH_DEVICE_PREFETCH", "0")
        Environment.reset()
        it = ListDataSetIterator(_batches(n=2))
        assert maybe_device_prefetch(it) is it

    def test_maybe_wraps_iterators_only(self, monkeypatch):
        monkeypatch.setenv("DL4J_TORCH_DEVICE_PREFETCH_DEPTH", "3")
        Environment.reset()
        it = ListDataSetIterator(_batches(n=2))
        wrapped = maybe_device_prefetch(it, device="cpu")
        assert isinstance(wrapped, DevicePrefetcher)
        assert wrapped._depth == 3
        assert maybe_device_prefetch(wrapped) is wrapped
        plain = [1, 2, 3]
        assert maybe_device_prefetch(plain) is plain

    def test_the_card_is_the_default_device(self):
        if torch.cuda.is_available():
            pytest.skip("this machine has a card")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DevicePrefetcher(ListDataSetIterator(_batches(n=1)))

    def test_async_base_is_unwrapped(self):
        base = ListDataSetIterator(_batches(n=3))
        pf = DevicePrefetcher(AsyncDataSetIterator(base), device="cpu")
        assert pf._base is base
        assert len(list(pf)) == 3

    def test_preprocessor_applied_on_feeder(self):
        seen = []

        class _Shift:
            def transform(self, ds):
                seen.append(threading.current_thread().name)
                ds.features = np.asarray(ds.features) + 1.0

        data = _batches(n=2)
        base = ListDataSetIterator([DataSet(np.array(d.features),
                                            np.array(d.labels))
                                    for d in data])
        pf = DevicePrefetcher(base, device="cpu")
        pf.set_pre_processor(_Shift())
        got = next(iter(pf))
        np.testing.assert_allclose(got.features.numpy(),
                                   data[0].features + 1.0)
        assert seen[0] == "dl4j-torch-device-prefetch"

    def test_place_fn_splits_onto_devices(self):
        pf = DevicePrefetcher(
            ListDataSetIterator(_batches(n=2)), device=["cpu", "cpu"],
            place_fn=lambda ds: [ds, ds])
        got = next(iter(pf))
        assert len(got) == 2 and got[0].features.shape == (32, 4)
        bad = DevicePrefetcher(ListDataSetIterator(_batches(n=1)),
                               device=["cpu"] * 3,
                               place_fn=lambda ds: [ds, ds])
        with pytest.raises(ValueError, match="3 devices"):
            list(bad)


class TestAsyncDataSetIterator:
    def test_order_reset_and_exhaustion(self):
        data = _batches(n=5)
        it = AsyncDataSetIterator(ListDataSetIterator(data), queue_size=2)
        got = list(it)
        assert [np.array_equal(g.features, d.features)
                for g, d in zip(got, data)] == [True] * 5
        assert not it.has_next()
        it.reset()
        it.next()
        it.reset()
        assert len(list(it)) == 5
        assert it.batch() == 32

    def test_feeder_exception_propagates(self):
        it = AsyncDataSetIterator(_FailingIterator(_batches(n=1)))
        with pytest.raises(RuntimeError, match="ETL exploded"):
            list(it)


# -- staged == unstaged -------------------------------------------------------
def _fit_both(make, data, monkeypatch, n_epochs=2):
    nets = []
    for flag in ("1", "0"):
        monkeypatch.setenv("DL4J_TORCH_DEVICE_PREFETCH", flag)
        Environment.reset()
        net = make()
        net.fit(ListDataSetIterator(data), n_epochs=n_epochs)
        nets.append(net)
    return nets


def test_staged_and_unstaged_mlp_trajectories_are_bitwise_equal(
        monkeypatch):
    staged, sync = _fit_both(_mlp, _batches(), monkeypatch)
    _same(staged, sync)
    assert staged.score() == sync.score()
    assert staged.iteration_count == sync.iteration_count == 12


def test_staged_and_unstaged_graph_trajectories_are_bitwise_equal(
        monkeypatch):
    rng = np.random.RandomState(3)
    data = [DataSet(rng.randn(4, 32, 32, 3),          # float64 in
                    np.eye(10, dtype=np.float32)[rng.randint(0, 10, 4)])
            for _ in range(3)]
    staged, sync = _fit_both(lambda: ResNet50(**SMALL).init("cpu"), data,
                             monkeypatch)
    _same(staged, sync)


def _sd_model():
    sd = SameDiff(device="cpu")
    x = sd.placeholder("x", (-1, 4))
    y = sd.placeholder("y", (-1, 3))
    w = sd.var("w", array=np.random.RandomState(1).randn(4, 3)
               .astype(np.float32))
    b = sd.var("b", array=np.zeros((3,), np.float32))
    loss = sd.loss.softmax_cross_entropy(y, x.mmul(w) + b, name="loss")
    sd.set_loss_variables(loss)
    sd.training_config = (
        TrainingConfig.Builder().updater(tu.Adam(1e-2))
        .data_set_feature_mapping("x").data_set_label_mapping("y").build())
    return sd


def test_staged_and_unstaged_samediff_trajectories_are_bitwise_equal(
        monkeypatch):
    out = []
    for flag in ("1", "0"):
        monkeypatch.setenv("DL4J_TORCH_DEVICE_PREFETCH", flag)
        Environment.reset()
        sd = _sd_model()
        hist = sd.fit(ListDataSetIterator(_batches(n=4)), n_epochs=2)
        out.append((sd, hist.loss_curve()))
    (a, la), (b, lb) = out
    assert la == lb and len(la) == 8
    for n in ("w", "b"):
        assert torch.equal(a._arrays[n], b._arrays[n])


def test_placeholder_staging_raises_the_feeders_error_and_stops():
    def make_ph(batch):
        if batch == 2:
            raise ValueError("bad batch")
        return {"x": np.full((2,), batch, np.float64)}

    gen = device_prefetch_placeholders(
        iter(range(5)), make_ph, lambda v: torch.as_tensor(v).float(),
        "cpu", depth=1)
    assert float(next(gen)["x"][0]) == 0.0
    with pytest.raises(ValueError, match="bad batch"):
        list(gen)
    early = device_prefetch_placeholders(
        iter(range(100)), lambda b: {"x": np.zeros(1)},
        lambda v: torch.as_tensor(v), "cpu", depth=1)
    next(early)
    early.close()                            # the feeder stops and joins


def test_staged_port_run_tracks_the_jax_staged_run():
    jnet = JMLN(_mlp_conf(JNNC, JIT, jl, JAct, ju.Nesterovs(0.1, 0.9))
                ).init()
    conf = _mlp_conf(NeuralNetConfiguration, InputType, tl, Activation,
                     tu.Nesterovs(0.1, 0.9))
    p, s = params_from_jax({k: {n: np.asarray(a) for n, a in sub.items()}
                            for k, sub in jnet.params.items()}, {}, conf)
    net = MultiLayerNetwork(conf).set_params(p, s, "cpu")
    arrays = _arrays(n=4)
    jnet.fit(JList([JDataSet(x, y) for x, y in arrays]), n_epochs=2)
    net.fit(ListDataSetIterator([DataSet(x, y) for x, y in arrays]),
            n_epochs=2)
    np.testing.assert_allclose(net.score(), float(jnet.score()), rtol=RTOL,
                               atol=ATOL)
    want = params_to_jax(params_from_jax(
        {k: {n: np.asarray(a) for n, a in sub.items()}
         for k, sub in jnet.params.items()}, {}, conf)[0], conf)
    got = params_to_jax(net.params, conf)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)


# -- features masks in a ComputationGraph -------------------------------------
def _rnn_graph(builder, input_type, graves, rnn_out, act, sgd):
    gb = (builder.Builder().seed(3).updater(sgd(0.1)).graph_builder()
          .add_inputs("in").set_input_types(input_type.recurrent(5)))
    gb.add_layer("lstm", graves(n_out=8, activation=act.TANH), "in")
    gb.add_layer("out", rnn_out(n_out=4, activation=act.SOFTMAX), "lstm")
    gb.set_outputs("out")
    return gb.build()


def _rnn_graph_pair():
    from deeplearning4j_tpu.nn.conf.layers_recurrent import \
        GravesLSTM as JGraves
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
    jg = JGraph(_rnn_graph(JNNC, JIT, JGraves, jl.RnnOutputLayer, JAct,
                           ju.Sgd)).init()
    conf = _rnn_graph(NeuralNetConfiguration, InputType, tr.GravesLSTM,
                      tl.RnnOutputLayer, Activation, tu.Sgd)
    p, s = params_from_jax({k: {n: np.asarray(a) for n, a in sub.items()}
                            for k, sub in jg.params.items()}, {}, conf)
    # the nets update their parameters in place: each gets its own copy
    return jg, (lambda: ComputationGraph(conf).set_params(
        {k: {n: t.clone() for n, t in sub.items()} for k, sub in p.items()},
        s, "cpu"))


def _masked_batches(n=2):
    rng = np.random.RandomState(0)
    out = []
    for _ in range(n):
        x = rng.randn(3, 6, 5).astype(np.float32)
        y = np.eye(4, dtype=np.float32)[rng.randint(0, 4, (3, 6))]
        m = np.ones((3, 6), np.float32)
        m[1, 3:] = 0.0
        m[2, 1:] = 0.0
        out.append((x, y, m))
    return out


@pytest.mark.parametrize("how", ["fit", "fit_iterator", "score"])
def test_graph_refuses_a_features_mask(how, monkeypatch):
    """A ComputationGraph applies the features mask (the graph refused
    one until the masks were ported; the test keeps its name): the masked
    ``fit``, staged ``fit(iterator)`` and ``score`` equal the JAX
    package's within 2e-4, a padded step's input changes nothing, and
    the staged run equals plain ``fit`` calls bit for bit."""
    jg, make = _rnn_graph_pair()
    batches = _masked_batches()
    ds = [DataSet(x, y, features_mask=m, labels_mask=m)
          for x, y, m in batches]
    jds = [JDataSet(x, y, features_mask=m, labels_mask=m)
           for x, y, m in batches]
    net = make()
    if how == "score":
        got, want = net.score(ds[0]), jg.score(jds[0])
        x, y, m = batches[0]
        padded = np.where(m[..., None] > 0, x, 1e3).astype(np.float32)
        assert net.score(DataSet(padded, y, features_mask=m,
                                 labels_mask=m)) == got
        assert net.score(MultiDataSet([x], [y], features_masks=[m],
                                      labels_masks=[m])) == got
        held = net.output(x, mask=m).numpy()
        np.testing.assert_allclose(held, np.asarray(jg.output(x, mask=m)),
                                   rtol=RTOL, atol=ATOL)
        # a padded step holds the last real step's state
        assert not np.allclose(held[2, 1:], net.output(x).numpy()[2, 1:])
        np.testing.assert_array_equal(held[2, 1:], np.broadcast_to(
            held[2, :1], held[2, 1:].shape))
    elif how == "fit":
        for d, jd in zip(ds, jds):
            net.fit(d)
            jg.fit(jd)
        got, want = net.score(), float(jg.score())
        multi = make()
        for x, y, m in batches:
            multi.fit(MultiDataSet([x], [y], features_masks=[m],
                                   labels_masks=[m]))
        _same(net, multi)
    else:
        Environment.reset()
        net.fit(ListDataSetIterator(ds), n_epochs=2)
        jg.fit(JList(jds), n_epochs=2)
        got, want = net.score(), float(jg.score())
        plain = make()
        for _ in range(2):
            for d in ds:
                plain.fit(d)
        _same(net, plain)
        assert net.score() == plain.score()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    want_p = {k: {n: np.asarray(a) for n, a in sub.items()}
              for k, sub in jg.params.items()}
    got_p = params_to_jax(net.params, net.conf)
    for k, a in params_to_jax(params_from_jax(want_p, {}, net.conf)[0],
                              net.conf).items():
        np.testing.assert_allclose(got_p[k], a, rtol=RTOL, atol=ATOL,
                                   err_msg=k)
