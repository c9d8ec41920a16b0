"""The training observatory's diagnostics in the port
(``common/diagnostics.py``) and the fit funnels that call it
(``nn/trainer.py``), held against the JAX package's
``common/diagnostics.py``: the numerics watchdog on the same poisoned
trees, the flight recorder over a 3-step LeNet fit of both packages
(parameters carried across with ``params_from_jax``), ``roofline`` with
the same peaks, memory attribution, and ``collective_span``'s routing
into the step breakdown.
"""
import json
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.common import diagnostics as jdiag
from deeplearning4j_tpu.common import stepstats as jss
from deeplearning4j_tpu.common import telemetry as jtel
from deeplearning4j_tpu.common.environment import Environment as JEnv
from deeplearning4j_tpu.datasets.mnist import synthetic_mnist
from deeplearning4j_tpu.models.zoo import LeNet as JaxLeNet
from deeplearning4j_tpu_torch.common import diagnostics, stepstats, telemetry
from deeplearning4j_tpu_torch.common.environment import Environment
from deeplearning4j_tpu_torch.models.zoo import LeNet
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.utils.serializer import params_from_jax
from torch_parity import one_intraop_thread  # noqa: F401,E402

#: the step-1..3 losses of the two packages' LeNet fits (the
#: conformance bar of the training parity tests)
LOSS_RTOL = 2e-5


@pytest.fixture(autouse=True)
def _fresh(tmp_path):
    """Both packages' observatories reset, dumps under ``tmp_path``, the
    watchdog off unless a test arms it."""
    envs = (Environment.get(), JEnv.get())
    saved = [(e.numerics_watchdog, e.numerics_sample,
              e.flight_recorder_dir, e.flight_recorder_keep) for e in envs]
    for e in envs:
        e.flight_recorder_dir = str(tmp_path / "flightrec")
    for tel, ss, dg in ((telemetry, stepstats, diagnostics),
                        (jtel, jss, jdiag)):
        tel.MetricsRegistry._reset_for_tests()
        tel.MetricsRegistry.get().set_enabled(True)
        ss.StepStats._reset_for_tests()
        dg.FlightRecorder._reset_for_tests()
    yield
    for e, s in zip(envs, saved):
        (e.numerics_watchdog, e.numerics_sample, e.flight_recorder_dir,
         e.flight_recorder_keep) = s
    for tel, ss, dg in ((telemetry, stepstats, diagnostics),
                        (jtel, jss, jdiag)):
        dg.FlightRecorder._reset_for_tests()
        ss.StepStats._reset_for_tests()
        tel.MetricsRegistry._reset_for_tests()


def _arm(sample=1):
    for e in (Environment.get(), JEnv.get()):
        e.numerics_watchdog, e.numerics_sample = True, sample


def _poisoned(seed):
    """A nested tree of float32 (and one int32) leaves with a NaN or an
    inf planted at a seeded place, as numpy."""
    rs = np.random.RandomState(seed)
    tree = {"layer_1": {"W": rs.randn(4, 3).astype(np.float32),
                        "b": rs.randn(3).astype(np.float32)},
            "layer_0": {"W": rs.randn(2, 5).astype(np.float32),
                        "steps": np.arange(3, dtype=np.int32)},
            "z": {"v": rs.randn(6).astype(np.float32)}}
    keys = [("layer_1", "W"), ("layer_1", "b"), ("layer_0", "W"),
            ("z", "v")]
    if seed:
        k = keys[seed % len(keys)]
        a = tree[k[0]][k[1]].reshape(-1)
        a[rs.randint(a.size)] = np.inf if seed % 2 else np.nan
    return tree


def _as(tree, fn):
    return {k: {n: fn(a) for n, a in sub.items()} for k, sub in tree.items()}


@pytest.mark.parametrize("seed", range(6))
def test_first_nonfinite_matches_jax(seed):
    tree = _poisoned(seed)
    want = jdiag.first_nonfinite(_as(tree, jnp.asarray))
    got = diagnostics.first_nonfinite(_as(tree, torch.from_numpy))
    assert got == want
    assert (got is None) == (seed == 0)


@pytest.mark.parametrize("group", ["loss", "gradients"])
def test_check_numerics_raises_the_same_event(group):
    _arm()
    tree = _poisoned(3)
    events = []
    for dg, conv in ((diagnostics, torch.from_numpy),
                     (jdiag, jnp.asarray)):
        loss = float("nan") if group == "loss" else 1.25
        gnorm = float("inf") if group == "gradients" else 2.0
        with pytest.raises(dg.NumericsEvent) as ei:
            dg.check_numerics(None, "MultiLayerNetwork", 7, loss,
                              grad_norm=gnorm, grads=_as(tree, conv))
        events.append(ei.value.to_dict())
    got, want = events
    assert got.keys() == want.keys()
    for k in ("model", "step", "tensor_group", "first_bad"):
        assert got[k] == want[k]
    assert math.isnan(got["value"]) == math.isnan(want["value"])
    assert got["tensor_group"] == group


def test_check_numerics_samples_and_stays_quiet_when_finite():
    _arm(sample=2)
    diagnostics.check_numerics(None, "m", 3, float("nan"))   # not sampled
    diagnostics.check_numerics(None, "m", 4, 1.0, grad_norm=2.0)
    with pytest.raises(diagnostics.NumericsEvent):
        diagnostics.check_numerics(None, "m", 4, float("nan"))


def _lenet_pair():
    jnet = JaxLeNet().init()
    conf = LeNet().conf()

    def np_tree(t):
        return {k: {n: np.asarray(a) for n, a in sub.items()}
                for k, sub in t.items()}
    p, s = params_from_jax(np_tree(jnet.params), np_tree(jnet.states), conf)
    return jnet, MultiLayerNetwork(conf).set_params(p, s, "cpu")


def test_flight_recorder_keys_and_losses_over_three_lenet_steps_match_jax():
    _arm()
    jnet, net = _lenet_pair()
    xs, ys = synthetic_mnist(48, True, seed=3)
    onehot = np.eye(10, dtype=np.float32)[ys]
    for i in range(3):
        sl = slice(16 * i, 16 * (i + 1))
        jnet.fit(xs[sl], onehot[sl])
        net.fit(xs[sl], onehot[sl])
    want = jdiag.FlightRecorder.get().records()
    got = diagnostics.FlightRecorder.get().records()
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        assert g["model"] == w["model"] == "MultiLayerNetwork"
        assert g["step"] == w["step"]
        assert sorted(g["phases"]) == sorted(w["phases"])
        np.testing.assert_allclose(float(g["loss"]), float(w["loss"]),
                                   rtol=LOSS_RTOL)
        assert g["grad_norm"] is not None and float(g["grad_norm"]) > 0
    # the span and the breakdown under the same names
    for tel, ss in ((telemetry, stepstats), (jtel, jss)):
        assert tel.histogram("dl4j_train_step_seconds").count_of(
            model="MultiLayerNetwork") == 3
        assert len(ss.collector().records()) == 3


def test_flight_recorder_dump_and_rotation(tmp_path):
    Environment.get().flight_recorder_keep = 2
    diagnostics.FlightRecorder._reset_for_tests()
    rec = diagnostics.FlightRecorder.get()
    for i in range(3):
        rec.record(None, "MultiLayerNetwork", i, torch.tensor(0.5 * i),
                   grad_norm=torch.tensor(1.0))
    paths = [rec.dump(reason) for reason in ("a", "b", "c")]
    assert rec.dump("a") is None           # one dump a reason
    lines = open(paths[-1]).read().splitlines()
    meta = json.loads(lines[0])
    assert meta["record"] == "meta" and meta["reason"] == "c"
    assert meta["n_steps"] == 3 and meta["schema_version"] == 1
    assert [json.loads(ln)["loss"] for ln in lines[1:]] == [0.0, 0.5, 1.0]
    kept = sorted(p.name for p in (tmp_path / "flightrec").iterdir())
    assert len([p for p in kept if p.endswith(".jsonl")]) == 2
    assert all(not p.endswith("_a.jsonl") for p in kept)


def test_the_watchdog_halts_a_poisoned_fit_and_dumps():
    """A NaN in one input row: the fit step raises NumericsEvent naming
    the first bad leaf of the updated parameters, and the recorder dumps
    the poisoned step; under accumulation the micro-batch's gradients
    are checked before they join the window."""
    _arm()
    _, net = _lenet_pair()
    xs, ys = synthetic_mnist(16, True, seed=3)
    onehot = np.eye(10, dtype=np.float32)[ys]
    net.fit(xs, onehot)
    bad = xs.copy()
    bad[2, 0] = np.nan
    with pytest.raises(diagnostics.NumericsEvent) as ei:
        net.fit(bad, onehot)
    ev = ei.value
    assert ev.step == 1 and ev.tensor_group == "loss"
    assert ev.first_bad["leaf"].startswith("['layer_")
    rec = diagnostics.FlightRecorder.get()
    path = sorted(Path(rec.dir).glob("*_numerics.jsonl"))
    assert path and json.loads(path[0].read_text().splitlines()[0])[
        "event"]["first_bad"] == ev.first_bad
    _, acc = _lenet_pair()
    acc.set_accumulation_steps(2)
    with pytest.raises(diagnostics.NumericsEvent) as ei:
        acc.fit(bad, onehot)
    assert ei.value.first_bad["leaf"].startswith("['layer_")
    assert acc._accum_count == 0          # nothing joined the window


def test_tbptt_segments_and_fit_steps_record():
    """fit_steps is one span and one record (``steps``); each tBPTT
    segment records its ``tbptt_segment``."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.nn.conf.builders import (
        BackpropType, NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.conf.layers import RnnOutputLayer
    from deeplearning4j_tpu_torch.nn.conf.layers_recurrent import LSTM
    conf = (NeuralNetConfiguration.Builder().seed(1).list()
            .layer(LSTM(n_out=4)).layer(RnnOutputLayer(n_out=3))
            .set_input_type(InputType.recurrent(2))
            .backprop_type(BackpropType.TRUNCATED_BPTT)
            .t_bptt_length(3).build())
    net = MultiLayerNetwork(conf).init("cpu")
    rs = np.random.RandomState(0)
    x = rs.randn(2, 7, 2).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, (2, 7))]
    net.fit(x, y)
    recs = diagnostics.FlightRecorder.get().records()
    assert [r["tbptt_segment"] for r in recs] == [0, 1, 2]
    assert [r["step"] for r in recs] == [0, 1, 2]
    net.fit_steps(DataSet(x[:, :3], y[:, :3]), 4)
    last = diagnostics.FlightRecorder.get().records()[-1]
    assert last["steps"] == 4 and last["step"] == 6
    assert telemetry.histogram("dl4j_train_step_seconds").count_of(
        model="MultiLayerNetwork") == 1


def test_roofline_matches_jax_for_the_same_peaks():
    for args in ((4e12, 1e9, 0.01), (1e9, 8e9, 0.002), (5e10, 5e10, 1.0)):
        for peaks in ((67.0, 3350.0), (989.0, 3350.0), (None, None)):
            got = diagnostics.roofline(*args, peak_tflops=peaks[0],
                                       peak_hbm_gbps=peaks[1])
            assert got == jdiag.roofline(*args, peak_tflops=peaks[0],
                                         peak_hbm_gbps=peaks[1])
    # the port's defaults are the H100's, never a TPU's
    assert diagnostics.H100_PEAK_TFLOPS["float32"] == 67.0
    assert diagnostics.H100_PEAK_TFLOPS["bfloat16"] == 989.0
    assert diagnostics.H100_HBM_GBPS == 3350.0


def test_memory_report_attributes_like_jax():
    """The same LeNet's parameter and updater-state bytes in both
    reports; the port's KV pools join in as their own class; the
    device gauges take injected stats (the CPU has none) and name the
    card."""
    jnet, net = _lenet_pair()
    xs, ys = synthetic_mnist(16, True, seed=3)
    onehot = np.eye(10, dtype=np.float32)[ys]
    jnet.fit(xs, onehot)
    net.fit(xs, onehot)
    got = diagnostics.memory_report(net)["models"]["MultiLayerNetwork"]
    want = jdiag.memory_report(jnet)["models"]["MultiLayerNetwork"]
    for k in ("params_bytes", "updater_state_bytes", "model_state_bytes"):
        assert got[k] == want[k], k
    from deeplearning4j_tpu_torch.serving.kvcache import KVBlockPool
    pool = KVBlockPool(2, 8, 4, 2, 8, device="cpu", name="p")
    rep = diagnostics.memory_report()
    assert rep["kv_pool_bytes"] >= pool.pool_bytes
    assert rep["accounted_bytes"] >= got["params_bytes"] + pool.pool_bytes
    stats = [{"id": 0, "kind": "NVIDIA H100 80GB HBM3", "bytes_in_use": 5,
              "peak_bytes_in_use": 9, "bytes_limit": 80}]
    diagnostics.update_hbm_gauges(stats)
    assert telemetry.gauge("dl4j_hbm_peak_bytes").value(
        device="0", kind="NVIDIA H100 80GB HBM3") == 9


def test_collective_span_routes_like_jax():
    for tel, ss, dg in ((telemetry, stepstats, diagnostics),
                        (jtel, jss, jdiag)):
        with dg.collective_span("state_placement", "data", 1024,
                                entries=3):
            pass
        assert tel.histogram("dl4j_collective_seconds").count_of(
            kind="state_placement", axis="data") == 1
        assert tel.counter("dl4j_collective_bytes_total").value(
            kind="state_placement", axis="data") == 1024
        rec = ss.collector().close_step("m", 0, 0.01)
        assert rec["phases"]["updater"] > 0
        assert set(rec["collectives"]) == {"state_placement"}


def test_bench_meta_names_the_run():
    meta = diagnostics.bench_meta()
    assert meta["schema_version"] == 1
    assert meta["torch_version"] == torch.__version__
    assert meta["platform"] == ("gpu" if torch.cuda.is_available()
                                else "cpu")
    assert all(k.startswith("DL4J_TORCH_") for k in meta["env"])


@pytest.mark.parametrize("mode,kinds", [
    ("sharded", {"state_placement"}),
    ("fsdp", {"state_placement", "fsdp_param_placement"})])
def test_binding_a_mesh_spans_the_placements(mode, kinds):
    """Binding a flat exchange places the updater state (and under fsdp
    the parameters) in ``collective_span``s, the JAX package's
    ``state_placement`` / ``fsdp_param_placement`` kinds, which the step
    breakdown routes to ``updater`` and ``collective``."""
    from deeplearning4j_tpu_torch.parallel.mesh import make_mesh
    _, net = _lenet_pair()
    mesh = make_mesh(devices=["cpu"], timeout_s=60)
    net.set_dp_mesh(mesh.replica(0), mode=mode)
    h = telemetry.histogram("dl4j_collective_seconds")
    for kind in kinds:
        assert h.count_of(kind=kind, axis="data") == 1, kind
    rec = stepstats.collector().close_step("MultiLayerNetwork", 0, 0.01)
    assert set(rec["collectives"]) == kinds
    net.set_dp_mesh(None)


def test_wrapper_fit_labels_its_breakdowns_and_restores_the_label():
    """``ParallelWrapper.fit`` labels this process's breakdowns worker 0
    of 1 while it runs, and gives the collector back the label it had."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.iterators import \
        ListDataSetIterator
    from deeplearning4j_tpu_torch.parallel.mesh import make_mesh
    from deeplearning4j_tpu_torch.parallel.wrapper import ParallelWrapper
    _, net = _lenet_pair()
    x, ys = synthetic_mnist(8, True, seed=1)
    y = np.eye(10, dtype=np.float32)[ys]
    col = stepstats.collector()
    col.set_worker(3, 4, host="elsewhere")
    ParallelWrapper(net, make_mesh(devices=["cpu"] * 2, timeout_s=60)).fit(
        ListDataSetIterator([DataSet(np.asarray(x), np.asarray(y))] * 2))
    recs = col.records()
    assert len(recs) == 2
    assert all(r["worker"] == 0 and r["n_workers"] == 1 for r in recs)
    assert col.worker_label() == {"worker": 3, "host": "elsewhere",
                                  "n_workers": 4}
