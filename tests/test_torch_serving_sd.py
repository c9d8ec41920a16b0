"""SameDiff models through the port's serving registry, the window flush
policy, and ``ParallelInference``'s inference modes, on the CPU.

The SameDiff and window cases of ``tests/test_serving.py`` on the port.
A small SameDiff classifier built in both packages from the same numpy
weights, served through the port's registry (in memory, from a zip and
over HTTP), answers within rtol 2e-5 / atol 1e-6 of the JAX package's
``sd.output`` on the same rows. Within the port, served answers equal
``sd.output`` of the same bucket-padded batch bit for bit. The window
cases hold a request in the batcher's window so its deadline expires
while queued, or a burst sheds against a small budget; the continuous
cases show batches formed by device busyness alone. No case asserts a
wall-clock rate; every wait has a timeout.
"""
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from deeplearning4j_tpu.autodiff.samediff import SameDiff as JSameDiff
from deeplearning4j_tpu_torch.activations import Activation
from deeplearning4j_tpu_torch.autodiff import SameDiff
from deeplearning4j_tpu_torch.common import telemetry
from deeplearning4j_tpu_torch.common.telemetry import MetricsRegistry
from deeplearning4j_tpu_torch.nn.conf import layers as tl
from deeplearning4j_tpu_torch.nn.conf.builders import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.parallel.inference import (InferenceMode,
                                                         ParallelInference)
from deeplearning4j_tpu_torch.serving import (AdmissionController,
                                              DeadlineExceeded,
                                              InferenceServer, ModelRegistry,
                                              RequestRecorder, ServingBatcher)
from deeplearning4j_tpu_torch.serving.registry import (_SameDiffAdapter,
                                                       load_model)
from torch_parity import one_intraop_thread  # noqa: F401,E402

FWD = dict(rtol=2e-5, atol=1e-6)
TIMEOUT = 60


@pytest.fixture(autouse=True)
def _fresh_panel():
    MetricsRegistry._reset_for_tests()
    yield
    MetricsRegistry._reset_for_tests()
    RequestRecorder._reset_for_tests()


def _weights(seed=0):
    rs = np.random.RandomState(seed)
    return {"w1": (rs.randn(4, 8) * 0.5).astype(np.float32),
            "b1": (rs.randn(8) * 0.1).astype(np.float32),
            "w2": (rs.randn(8, 3) * 0.5).astype(np.float32)}


def _classifier(sd, w):
    """x -> tanh(x W1 + b1) W2 -> softmax "probs", through the surface
    both packages share."""
    x = sd.placeholder("x", shape=(None, 4))
    h = sd.math.tanh(x @ sd.var("w1", array=w["w1"])
                     + sd.var("b1", array=w["b1"]))
    sd.nn.softmax(h @ sd.var("w2", array=w["w2"]), name="probs")
    return sd


def _pad(x, b=8):
    return np.concatenate([x, np.repeat(x[-1:], b - x.shape[0], axis=0)])


def _mlp(seed=42):
    conf = (NeuralNetConfiguration.Builder().seed(seed).graph_builder()
            .add_inputs("in").set_input_types(InputType.feed_forward(8))
            .add_layer("dense", tl.DenseLayer(
                n_out=16, activation=Activation.TANH), "in")
            .add_layer("out", tl.OutputLayer(
                n_out=3, activation=Activation.SOFTMAX), "dense")
            .set_outputs("out").build())
    return ComputationGraph(conf).init("cpu")


def _post(base, name, payload, headers=None):
    h = {"Content-Type": "application/json"}
    h.update(headers or {})
    req = urllib.request.Request(f"{base}/v1/models/{name}:predict",
                                 data=json.dumps(payload).encode(),
                                 headers=h)
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


# ---------------------------------------------------------------------------
class TestSameDiffServing:
    def test_served_graph_matches_jax_sd_output(self):
        w = _weights()
        jsd = _classifier(JSameDiff(), w)
        sd = _classifier(SameDiff(device="cpu"), w)
        reg = ModelRegistry("cpu", default_buckets=(8,))
        ver = reg.register("sd", sd, warmup_shape=(4,))
        srv = InferenceServer(reg).start(0)
        try:
            assert isinstance(ver.model, _SameDiffAdapter)
            assert (ver.model.input_name, ver.model.output_name) == \
                ("x", "probs")
            rs = np.random.RandomState(1)
            for n in (1, 3, 8):
                x = rs.randn(n, 4).astype(np.float32)
                want = np.asarray(jsd.output({"x": x}, ["probs"])["probs"])
                code, body, _ = _post(srv.url, "sd", {"inputs": x.tolist()})
                assert code == 200
                got = np.asarray(json.loads(body)["outputs"], np.float32)
                np.testing.assert_allclose(got, want, **FWD)
                # within the port: the same padded batch, bit for bit
                ref = sd.output({"x": _pad(x)}, ["probs"])["probs"]
                np.testing.assert_array_equal(got, ref.numpy()[:n])
            assert ver.retraces_since_warmup() == 0
        finally:
            srv.stop(drain=False)
            reg.shutdown()

    def test_samediff_zip_registers_by_path(self, tmp_path):
        sd = _classifier(SameDiff(device="cpu"), _weights(3))
        p = tmp_path / "sd.zip"
        sd.save(str(p))
        reg = ModelRegistry("cpu", default_buckets=(8,))
        ver = reg.register("sd", str(p), warmup_shape=(4,))
        try:
            assert ver.source == str(p)
            x = np.random.RandomState(2).randn(5, 4).astype(np.float32)
            got = ver.batcher.submit(x).result(timeout=TIMEOUT)
            ref = sd.output({"x": _pad(x)}, ["probs"])["probs"]
            np.testing.assert_array_equal(got, ref.numpy()[:5])
            assert ver.retraces_since_warmup() == 0
        finally:
            reg.shutdown()

    def test_names_inferred_or_given(self):
        sd = SameDiff(device="cpu")
        a = sd.placeholder("a", shape=(None, 4))
        b = sd.placeholder("b", shape=(None, 4))
        s = sd.math.tanh(a + b, name="s")
        sd.nn.softmax(s, name="p")
        with pytest.raises(ValueError, match="input_name"):
            _SameDiffAdapter(sd)
        with pytest.raises(ValueError, match="output_name"):
            _SameDiffAdapter(_two_outputs(), input_name="x")
        ad = _SameDiffAdapter(_two_outputs(), "x", "u")
        assert (ad.input_name, ad.output_name) == ("x", "u")
        x = np.ones((2, 4), np.float32)
        np.testing.assert_array_equal(ad.output(x).numpy(), np.tanh(x))

    @pytest.mark.parametrize("ext", [".h5", ".keras", ".onnx"])
    def test_keras_and_onnx_artifacts_wait_for_their_importers(self, ext):
        with pytest.raises(NotImplementedError, match="item 14"):
            load_model(f"model{ext}", "cpu")
        with pytest.raises(NotImplementedError, match="item 14"):
            ModelRegistry("cpu").register("m", f"model{ext}")


def _two_outputs():
    sd = SameDiff(device="cpu")
    x = sd.placeholder("x", shape=(None, 4))
    sd.math.tanh(x, name="u")
    sd.math.exp(x, name="v")
    return sd


# ---------------------------------------------------------------------------
class TestFlushPolicies:
    def test_deadline_expired_request_cancelled_not_computed(self):
        net = _mlp()
        b = ServingBatcher(net, buckets=(8,), batch_window_ms=150.0,
                           flush_policy="window")
        b.warmup((8,))
        x = np.zeros((1, 8), np.float32)
        computed = []
        orig = b.output_batched
        b.output_batched = lambda reqs: computed.extend(reqs) or orig(reqs)
        try:
            doomed = b.submit(x, deadline=time.monotonic() + 0.01)
            live = b.submit(x)
            with pytest.raises(DeadlineExceeded):
                doomed.result(timeout=TIMEOUT)
            out = live.result(timeout=TIMEOUT)
            np.testing.assert_array_equal(
                out, net.output(_pad(x)).numpy()[:1])
            assert len(computed) == 1
            assert telemetry.counter(
                "dl4j_serving_deadline_shed_total").value(
                    model="model", where="queue") == 1
        finally:
            b.shutdown()

    def test_window_holds_the_first_request_for_batch_mates(self):
        """Under the window policy, requests submitted one after another
        within the window form one flush."""
        b = ServingBatcher(_Double(), buckets=(8,), batch_window_ms=500.0,
                           flush_policy="window")
        flushes = []
        orig = b.output_batched
        b.output_batched = lambda reqs: flushes.append(len(reqs)) \
            or orig(reqs)
        x = np.ones((1, 4), np.float32)
        try:
            futs = [b.submit(x) for _ in range(3)]
            for f in futs:
                np.testing.assert_array_equal(f.result(timeout=TIMEOUT),
                                              [[2.0]])
        finally:
            b.shutdown()
        assert flushes == [3]

    def test_continuous_batching_aggregates_under_busy_device(self):
        flushes = []
        release = threading.Event()

        class _Slow:
            def output(self, x):
                # the first served flush holds the device until the
                # test has queued more (warmup's forward passes through)
                if flushes == [1]:
                    release.wait(timeout=30)
                return np.asarray(x)[:, :1] * 2

        b = ServingBatcher(_Slow(), buckets=(8,), name="cont")
        assert b.flush_policy == "continuous"
        b.warmup((4,))
        orig = b.output_batched
        b.output_batched = lambda reqs: flushes.append(len(reqs)) \
            or orig(reqs)
        x = np.ones((1, 4), np.float32)
        try:
            first = b.submit(x)
            time.sleep(0.05)
            rest = [b.submit(x) for _ in range(5)]
            time.sleep(0.05)
            release.set()
            for f in [first] + rest:
                np.testing.assert_array_equal(f.result(timeout=30), [[2.0]])
        finally:
            b.shutdown()
        assert flushes == [1, 5]

    def test_continuous_lone_request_flushes(self):
        net = _mlp()
        b = ServingBatcher(net, buckets=(8,))
        b.warmup((8,))
        x = np.zeros((1, 8), np.float32)
        try:
            out = b.submit(x).result(timeout=TIMEOUT)
        finally:
            b.shutdown()
        np.testing.assert_array_equal(out, net.output(_pad(x)).numpy()[:1])

    def test_flush_policy_validated(self):
        with pytest.raises(ValueError, match="flush_policy"):
            ServingBatcher(_mlp(), buckets=(8,), flush_policy="nope")
        with pytest.raises(ValueError, match="flush_policy"):
            ModelRegistry("cpu", flush_policy="nope").register("m", _mlp())

    @pytest.mark.parametrize("policy", ["continuous", "window"])
    def test_occupancy_histogram_by_policy(self, policy):
        net = _mlp()
        b = ServingBatcher(net, buckets=(8,), flush_policy=policy,
                           batch_window_ms=1.0)
        b.warmup((8,))
        try:
            b.submit(np.zeros((2, 8), np.float32)).result(timeout=TIMEOUT)
        finally:
            b.shutdown()
        h = telemetry.histogram("dl4j_serving_batch_occupancy")
        assert h.count_of(model="model", policy=policy) >= 1
        # 2 live rows on an 8-row bucket
        assert h.sum_of(model="model", policy=policy) == pytest.approx(0.25)

    def test_registry_policy_defaults_and_overrides(self):
        reg = ModelRegistry("cpu", default_buckets=(8,),
                            flush_policy="window", batch_window_ms=7.0)
        try:
            a = reg.register("a", _mlp())
            c = reg.register("c", _mlp(), flush_policy="continuous")
            assert (a.batcher.flush_policy, a.batcher.batch_window_ms) == \
                ("window", 7.0)
            assert c.batcher.flush_policy == "continuous"
            by_name = {d["name"]: d["versions"][0]["flush_policy"]
                       for d in reg.describe()}
            assert by_name == {"a": "window", "c": "continuous"}
        finally:
            reg.shutdown()

    def test_deadline_expiry_http_504(self):
        reg = ModelRegistry("cpu", default_buckets=(8,),
                            batch_window_ms=100.0, flush_policy="window")
        reg.register("m", _mlp(), warmup_shape=(8,))
        srv = InferenceServer(reg).start(0)
        try:
            code, _, _ = _post(srv.url, "m", {"inputs": [[0.0] * 8]},
                               headers={"X-Deadline-Ms": "1"})
            assert code == 504
            shed = telemetry.counter("dl4j_serving_deadline_shed_total")
            assert (shed.value(model="m", where="queue")
                    + shed.value(model="m", where="admission")) >= 1
            assert _verdicts(1) == ["504"]
        finally:
            srv.stop(drain=True, timeout=10)
            reg.shutdown()

    def test_shed_then_recover(self):
        """8 simultaneous clients against an in-flight budget of 2 and a
        150 ms window: admitted requests answer 200 with the right rows,
        the rest 429 with Retry-After, each verdict recorded, and a
        fresh request is admitted afterwards."""
        net = _mlp()
        reg = ModelRegistry("cpu", default_buckets=(8,),
                            batch_window_ms=150.0, flush_policy="window")
        reg.register("m", net, warmup_shape=(8,))
        srv = InferenceServer(reg, AdmissionController(
            max_queue=2, retry_after_s=0.5)).start(0)
        x = np.random.RandomState(7).randn(1, 8).astype(np.float32)
        barrier = threading.Barrier(8)
        results = []

        def client():
            barrier.wait(timeout=TIMEOUT)
            results.append(_post(srv.url, "m", {"inputs": x.tolist()}))

        threads = [threading.Thread(target=client) for _ in range(8)]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=TIMEOUT)
            assert not any(t.is_alive() for t in threads)
            codes = [c for c, _, _ in results]
            assert set(codes) <= {200, 429} and 429 in codes \
                and 200 in codes, codes
            ref = net.output(_pad(x)).numpy()[:1]
            for code, body, hdrs in results:
                if code == 200:
                    np.testing.assert_array_equal(
                        np.asarray(json.loads(body)["outputs"], np.float32),
                        ref)
                else:
                    assert int(hdrs["Retry-After"]) >= 1
                    assert json.loads(body)["reason"] == "queue_full"
            assert telemetry.counter("dl4j_serving_shed_total").value(
                model="m", reason="queue_full") == codes.count(429)
            assert _verdicts(8) == sorted(str(c) for c in codes)
            assert _post(srv.url, "m", {"inputs": x.tolist()})[0] == 200
        finally:
            srv.stop(drain=True, timeout=10)
            reg.shutdown()


class _Double:
    def output(self, x):
        return np.asarray(x)[:, :1] * 2


def _verdicts(n, timeout=10.0):
    """The recorder's verdicts, polled until ``n`` have landed: the
    server records a request after its response bytes are out."""
    deadline = time.monotonic() + timeout
    while True:
        recs = RequestRecorder.get().records()
        if len(recs) >= n or time.monotonic() >= deadline:
            return sorted(r["verdict"] for r in recs)
        time.sleep(0.02)


# ---------------------------------------------------------------------------
class TestInferenceModes:
    @pytest.mark.parametrize("mode", [InferenceMode.INPLACE,
                                      InferenceMode.SEQUENTIAL,
                                      InferenceMode.BATCHED])
    def test_modes_answer_like_output(self, mode):
        net = _mlp()
        pi = (ParallelInference.Builder(net).inference_mode(mode)
              .batch_limit(4).queue_limit(16).build())
        x = np.random.RandomState(5).randn(3, 8).astype(np.float32)
        try:
            futs = [pi.submit(x[i:i + 1]) for i in range(3)]
            got = np.concatenate([f.result(timeout=TIMEOUT) for f in futs])
        finally:
            pi.shutdown()
        np.testing.assert_allclose(got, net.output(x).numpy(), **FWD)
        assert pi.inference_mode == mode
        if mode != InferenceMode.BATCHED:
            # on the caller's thread: no worker, one forward a request
            assert pi._worker is None and pi.forwards == 3
        assert telemetry.counter("dl4j_inference_requests_total").value(
            mode=mode) == 3

    def test_unknown_mode_and_policy_refused(self):
        net = _mlp()
        with pytest.raises(ValueError, match="inference_mode"):
            ParallelInference(net, inference_mode="NOPE")
        with pytest.raises(ValueError, match="flush_policy"):
            ParallelInference(net, flush_policy="nope")
        pi = ParallelInference(net, flush_policy="window",
                               batch_window_ms=3.0)
        assert (pi.flush_policy, pi.batch_window_ms) == ("window", 3.0)
        assert pi.n_workers == 1
