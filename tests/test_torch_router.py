"""The port's multi-replica serving router on the CPU.

The cases of ``tests/test_router.py`` on the port: least-loaded
dispatch, fleet-wide warm-then-drain rollouts, rerouting around a dead
replica, the trace id relayed both ways, and the router's metrics. Two
in-process replicas, each its own registry, admission controller and
server on a free port, on the CPU.

Parity: a small ComputationGraph built by the JAX package, carried
across with ``params_from_jax`` and served through the port's router,
answers within rtol 2e-5 / atol 1e-6 of the JAX package's
``ModelRegistry`` (called in process) on the same rows; within the
port, routed answers equal ``net.output`` of the same bucket-padded
batch bit for bit (a row's answer on the CPU may depend on the batch
it shares a product with, so the reference pads as the batcher does).
Every HTTP call has a timeout.
"""
import http.client
import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.activations import Activation as JAct
from deeplearning4j_tpu.nn.conf.builders import \
    NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.serving import ModelRegistry as JRegistry
from deeplearning4j_tpu_torch.activations import Activation
from deeplearning4j_tpu_torch.common import telemetry, tracectx
from deeplearning4j_tpu_torch.common.telemetry import MetricsRegistry
from deeplearning4j_tpu_torch.models import DecoderConfig, DecoderLM
from deeplearning4j_tpu_torch.nn.conf import layers as tl
from deeplearning4j_tpu_torch.nn.conf.builders import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.graph_conf import \
    ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.serving import RequestRecorder, ServingRouter
from deeplearning4j_tpu_torch.serving.router import replica_devices
from deeplearning4j_tpu_torch.utils.serializer import params_from_jax
from torch_parity import one_intraop_thread  # noqa: F401,E402

FWD = dict(rtol=2e-5, atol=1e-6)
BUCKET = 8
TIMEOUT = 60

JAX = dict(builder=JNNC, it=JIT, ly=jl, act=JAct)
PORT = dict(builder=NeuralNetConfiguration, it=InputType, ly=tl,
            act=Activation)


@pytest.fixture(autouse=True)
def _fresh_panel():
    MetricsRegistry._reset_for_tests()
    yield
    MetricsRegistry._reset_for_tests()
    RequestRecorder._reset_for_tests()


def _conf(k, seed=42):
    return (k["builder"].Builder().seed(seed).graph_builder()
            .add_inputs("in").set_input_types(k["it"].feed_forward(8))
            .add_layer("dense", k["ly"].DenseLayer(
                n_out=16, activation=k["act"].TANH), "in")
            .add_layer("out", k["ly"].OutputLayer(
                n_out=3, activation=k["act"].SOFTMAX), "dense")
            .set_outputs("out").build())


_NETS = {}


def _weights(seed):
    """A port graph's parameters and states, made once a seed."""
    if seed not in _NETS:
        net = ComputationGraph(_conf(PORT, seed)).init("cpu")
        _NETS[seed] = (net.params, net.states)
    return _NETS[seed]


def _mlp(seed=42):
    """A fresh port graph with the seed's weights (its own tensors)."""
    p, s = _weights(seed)
    clone = {k: {n: t.clone() for n, t in sub.items()}
             for k, sub in p.items()}
    sclone = {k: {n: t.clone() for n, t in sub.items()}
              for k, sub in s.items()}
    return ComputationGraph(_conf(PORT, seed)).set_params(clone, sclone,
                                                          "cpu")


def _ref(net, x):
    """``net.output`` of ``x`` padded to the bucket as the batcher pads
    it (the last row repeated), sliced back."""
    n = x.shape[0]
    pad = np.concatenate([x, np.repeat(x[-1:], BUCKET - n, axis=0)])
    return net.output(pad).numpy()[:n]


def _get(base, path):
    with urllib.request.urlopen(f"{base}{path}", timeout=TIMEOUT) as r:
        return r.status, r.read()


def _post(base, name, payload, headers=None, raw=False):
    h = {"Content-Type": ("application/octet-stream" if raw
                          else "application/json")}
    h.update(headers or {})
    data = payload if isinstance(payload, bytes) \
        else json.dumps(payload).encode()
    req = urllib.request.Request(f"{base}/v1/models/{name}:predict",
                                 data=data, headers=h)
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


@pytest.fixture
def router():
    rt = ServingRouter(n_replicas=2, device="cpu",
                       default_buckets=(BUCKET,), health_interval_s=0.2)
    rt.start(0)
    yield rt
    rt.stop(drain=False, timeout=5)


# ---------------------------------------------------------------------------
class TestRouterDispatch:
    def test_rollout_then_predict_across_replicas(self, router):
        net = _mlp()
        x = np.random.RandomState(0).randn(2, 8).astype(np.float32)
        versions = router.rollout("m", lambda: _mlp(), warmup_shape=(8,))
        assert len(versions) == 2 and all(v.version == 1 for v in versions)
        assert versions[0].model is not versions[1].model
        code, _ = _get(router.url, "/readyz")
        assert code == 200
        code, body, _ = _post(router.url, "m", {"inputs": x.tolist()})
        assert code == 200
        np.testing.assert_array_equal(
            np.asarray(json.loads(body)["outputs"], np.float32),
            _ref(net, x))
        buf = io.BytesIO()
        np.save(buf, x)
        code, body, hdrs = _post(router.url, "m", buf.getvalue(), raw=True)
        assert code == 200 and hdrs.get("X-Model-Version") == "1"
        np.testing.assert_array_equal(np.load(io.BytesIO(body)),
                                      _ref(net, x))
        c = telemetry.counter("dl4j_serving_router_requests_total")
        assert sum(c.value(replica=f"replica-{i}", code="200")
                   for i in range(2)) == 2
        assert all(v.retraces_since_warmup() == 0 for v in versions)

    def test_least_loaded_picks_idle_replica(self, router):
        r0, r1 = router.replicas
        r0.begin(); r0.begin()
        r1.begin()
        assert router._pick() is r1
        r1.begin(); r1.begin()
        assert router._pick() is r0
        r0.end(); r0.end(); r1.end(); r1.end(); r1.end()

    def test_replicas_endpoint_and_catalog(self, router):
        router.rollout("m", lambda: _mlp(), warmup_shape=(8,))
        code, body = _get(router.url, "/v1/replicas")
        assert code == 200
        reps = json.loads(body)["replicas"]
        assert [r["name"] for r in reps] == ["replica-0", "replica-1"]
        assert all(r["healthy"] and r["ready"] and r["device"] == "cpu"
                   for r in reps)
        code, body = _get(router.url, "/v1/models")
        models = json.loads(body)["models"]
        assert code == 200 and models[0]["name"] == "m"
        assert models[0]["versions"][0]["flush_policy"] == "continuous"

    def test_unknown_model_relays_replica_404(self, router):
        router.rollout("m", lambda: _mlp(), warmup_shape=(8,))
        code, _, _ = _post(router.url, "nope", {"inputs": [[0.0] * 8]})
        assert code == 404

    def test_metrics_endpoint(self, router):
        router.rollout("m", lambda: _mlp(), warmup_shape=(8,))
        _post(router.url, "m", {"inputs": [[0.0] * 8]})
        code, body = _get(router.url, "/metrics")
        text = body.decode()
        assert code == 200
        for name in ("dl4j_serving_router_requests_total",
                     "dl4j_serving_router_healthy",
                     "dl4j_serving_rollouts_total"):
            assert name in text


def test_routed_graph_matches_the_jax_registry(router):
    """A JAX-built graph carried across by ``params_from_jax``, served
    through the port's two replicas, against the JAX package's registry
    in process on the same rows."""
    jnet = JGraph(_conf(JAX, seed=7)).init()
    conf = ComputationGraphConfiguration.from_json(jnet.conf.to_json())
    npy = {k: {n: np.asarray(a) for n, a in sub.items()}
           for k, sub in jnet.params.items()}

    def factory():
        p, s = params_from_jax(npy, {}, conf)
        return ComputationGraph(conf).set_params(p, s, "cpu")

    router.rollout("m", factory, warmup_shape=(8,))
    jreg = JRegistry(default_buckets=(BUCKET,))
    jver = jreg.register("m", jnet, warmup_shape=(8,))
    try:
        rs = np.random.RandomState(3)
        for n in (1, 3, 8):
            x = rs.randn(n, 8).astype(np.float32)
            want = np.asarray(jver.batcher.submit(x).result(timeout=TIMEOUT))
            code, body, _ = _post(router.url, "m", {"inputs": x.tolist()})
            assert code == 200
            got = np.asarray(json.loads(body)["outputs"], np.float32)
            np.testing.assert_allclose(got, want, **FWD)
    finally:
        jreg.shutdown()


def test_replicas_default_to_the_card(monkeypatch):
    assert replica_devices(3, "cpu") == [torch.device("cpu")] * 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingRouter(n_replicas=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert replica_devices(3) == [torch.device("cuda", i)
                                  for i in (0, 1, 0)]


# ---------------------------------------------------------------------------
class TestRouterResilience:
    def test_rollout_under_load_drops_nothing(self, router):
        """A rollout under concurrent client load answers only 200s, each
        equal to version 1's or version 2's answer, and afterwards only
        version 2's."""
        x = np.random.RandomState(1).randn(2, 8).astype(np.float32)
        ref1, ref2 = _ref(_mlp(42), x), _ref(_mlp(99), x)
        assert not np.array_equal(ref1, ref2)
        router.rollout("m", lambda: _mlp(42), warmup_shape=(8,))
        outs, errors = [], []
        stop = threading.Event()

        def hammer():
            while not stop.is_set():
                try:
                    code, body, _ = _post(router.url, "m",
                                          {"inputs": x.tolist()})
                    outs.append((code, body))
                except Exception as e:      # noqa: BLE001
                    errors.append(e)

        threads = [threading.Thread(target=hammer) for _ in range(4)]
        for t in threads:
            t.start()
        try:
            router.rollout("m", lambda: _mlp(99), warmup_shape=(8,))
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=TIMEOUT)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors[:3]
        assert outs and all(code == 200 for code, _ in outs)
        for _, body in outs:
            got = np.asarray(json.loads(body)["outputs"], np.float32)
            assert np.array_equal(got, ref1) or np.array_equal(got, ref2)
        for _ in range(4):
            code, body, _ = _post(router.url, "m", {"inputs": x.tolist()})
            np.testing.assert_array_equal(
                np.asarray(json.loads(body)["outputs"], np.float32), ref2)
        assert telemetry.counter("dl4j_serving_rollouts_total").value(
            model="m") == 2

    def test_dead_replica_reroutes_and_leaves_rotation(self, router):
        x = np.random.RandomState(2).randn(1, 8).astype(np.float32)
        router.rollout("m", lambda: _mlp(), warmup_shape=(8,))
        victim = router.replicas[0]
        victim.server.stop(drain=False)
        code, _, _ = _post(router.url, "m", {"inputs": x.tolist()})
        assert code == 200
        assert victim.healthy is False
        assert telemetry.gauge("dl4j_serving_router_healthy").value(
            replica="replica-0") == 0
        code, _, _ = _post(router.url, "m", {"inputs": x.tolist()})
        assert code == 200
        _, body = _get(router.url, "/v1/replicas")
        assert [r["healthy"] for r in json.loads(body)["replicas"]] == \
            [False, True]

    def test_no_healthy_replica_is_502(self, router):
        router.rollout("m", lambda: _mlp(), warmup_shape=(8,))
        router._stopping = True    # freeze the health poller's verdict
        for r in router.replicas:
            r.set_healthy(False)
            r.server.stop(drain=False)
        code, body, _ = _post(router.url, "m", {"inputs": [[0.0] * 8]})
        assert code == 502
        assert "no healthy replica" in json.loads(body)["error"]
        assert telemetry.counter(
            "dl4j_serving_router_requests_total").value(
                replica="none", code="502") == 1


# ---------------------------------------------------------------------------
class TestRouterObservatory:
    def test_trace_header_relays_both_ways_on_predict(self, router):
        router.rollout("m", lambda: _mlp(), warmup_shape=(8,))
        x = np.random.RandomState(0).randn(1, 8).astype(np.float32)
        tid = "router-relay-tid-1"
        code, _, headers = _post(router.url, "m", {"inputs": x.tolist()},
                                 headers={tracectx.TRACE_HEADER: tid})
        assert code == 200 and headers.get(tracectx.TRACE_HEADER) == tid
        assert headers.get(tracectx.REPLICA_HEADER, "").startswith(
            "replica-")
        code, _, headers = _post(router.url, "m", {"inputs": x.tolist()})
        minted = headers.get(tracectx.TRACE_HEADER)
        assert code == 200 and minted and len(minted) == 16

    def test_trace_and_replica_headers_on_generate_stream(self, router):
        def lm():
            model = DecoderLM(DecoderConfig.tiny())
            model.init("cpu", seed=3)
            return model

        router.rollout("lm", lm, generate={
            "kv_blocks": 32, "kv_block_size": 8, "prompt_buckets": (16,),
            "decode_buckets": (4,), "max_seq_len": 64})
        tid = "router-relay-gen-1"
        conn = http.client.HTTPConnection("127.0.0.1", router.port,
                                          timeout=TIMEOUT)
        try:
            conn.request("POST", "/v1/models/lm:generate",
                         body=json.dumps({"prompt": [5, 9, 2, 7],
                                          "max_tokens": 4}).encode(),
                         headers={"Content-Type": "application/json",
                                  tracectx.TRACE_HEADER: tid})
            resp = conn.getresponse()
            assert resp.status == 200
            assert resp.getheader("Transfer-Encoding") == "chunked"
            assert resp.getheader(tracectx.TRACE_HEADER) == tid
            assert resp.getheader(tracectx.REPLICA_HEADER, "").startswith(
                "replica-")
            lines = [json.loads(ln) for ln in
                     resp.read().decode().strip().splitlines()]
        finally:
            conn.close()
        assert lines[-1]["done"] and lines[-1]["tokens"] == 4
        assert [ln["index"] for ln in lines[:-1]] == [0, 1, 2, 3]

    def test_retry_after_connect_failure_keeps_trace(self, router):
        router.rollout("m", lambda: _mlp(), warmup_shape=(8,))
        victim = router.replicas[0]
        victim.server.stop(drain=False)
        x = np.random.RandomState(2).randn(1, 8).astype(np.float32)
        tid = "router-retry-tid-1"
        code, _, headers = _post(router.url, "m", {"inputs": x.tolist()},
                                 headers={tracectx.TRACE_HEADER: tid})
        assert code == 200 and headers.get(tracectx.TRACE_HEADER) == tid
        assert headers.get(tracectx.REPLICA_HEADER) == \
            router.replicas[1].name
        assert victim.healthy is False
        spans = [e for e in telemetry.trace_events()
                 if e["name"] == "req.route"
                 and e["args"].get("trace") == tid]
        assert [s["args"]["replica"] for s in spans] == ["replica-1"]
