"""The port's serving request observatory on the CPU: trace contexts,
span trees, the sampled access log, SLO error-budget accounting and the
request flight recorder.

The cases of ``tests/test_request_observatory.py`` on the port: one
request is one trace id is one connected timeline; the id round-trips
on ``X-Dl4j-Trace-Id``, every ``req.<phase>`` span lies inside the
request's root span (1 ms of slack for the integer microseconds of the
chrome-trace format), the latency exemplar and the access-log line carry
the same id, and concurrent requests on reused keep-alive handler
threads never swap ids. The replica closes the root span after the
response bytes are out, so every trace assertion polls (with a
timeout).

Against the JAX package: its ``SLOTracker`` and the port's, fed the same
seeded stream of (latency, SLO, ``now``), report equal numbers within
1e-12; its request records and dumps and the port's have the same keys
and phase names; its histogram quantiles and exemplars and the port's
agree on the same observations.
"""
from __future__ import annotations

import http.client
import json
import socket
import struct
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from deeplearning4j_tpu.common import telemetry as jtelemetry
from deeplearning4j_tpu.common import tracectx as jtracectx
from deeplearning4j_tpu.serving.reqrec import \
    RequestRecorder as JRequestRecorder
from deeplearning4j_tpu.serving.slo import SLOTracker as JSLOTracker
from deeplearning4j_tpu_torch.activations import Activation
from deeplearning4j_tpu_torch.common import httputil, telemetry, tracectx
from deeplearning4j_tpu_torch.common.telemetry import MetricsRegistry
from deeplearning4j_tpu_torch.models import DecoderConfig, DecoderLM
from deeplearning4j_tpu_torch.nn.conf import layers as tl
from deeplearning4j_tpu_torch.nn.conf.builders import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.serving import (AdmissionController,
                                              InferenceServer, ModelRegistry,
                                              RequestRecorder, SLOTracker)
from torch_parity import one_intraop_thread  # noqa: F401,E402

TIMEOUT = 60
SLACK_US = 1000
GEN = {"kv_blocks": 32, "kv_block_size": 8, "prompt_buckets": (16,),
       "decode_buckets": (4,), "max_seq_len": 64}


@pytest.fixture(autouse=True)
def _fresh_panel():
    MetricsRegistry._reset_for_tests()
    yield
    MetricsRegistry._reset_for_tests()
    RequestRecorder._reset_for_tests()


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


def _serve(name="m", **register_kw):
    reg = ModelRegistry("cpu", default_buckets=(8,))
    reg.register(name, _mlp(), warmup_shape=(8,), **register_kw)
    return reg, InferenceServer(reg).start(0)


def _trace_spans(trace_id, want=("request",), timeout=5.0):
    """The ring's events of ``trace_id``, polled until every name in
    ``want`` has landed or ``timeout`` passed."""
    deadline = time.monotonic() + timeout
    while True:
        events = [e for e in telemetry.trace_events()
                  if e.get("args", {}).get("trace") == trace_id]
        if all(w in {e["name"] for e in events} for w in want) \
                or time.monotonic() >= deadline:
            return events
        time.sleep(0.02)


def _records_of(trace_id, timeout=10.0):
    """The recorder's records of ``trace_id``, polled until one has
    landed (a request is recorded after its response bytes are out)."""
    deadline = time.monotonic() + timeout
    while True:
        recs = [r for r in RequestRecorder.get().records()
                if r["trace_id"] == trace_id]
        if recs or time.monotonic() >= deadline:
            return recs
        time.sleep(0.02)


def _x(n=2, seed=0):
    return np.random.RandomState(seed).randn(n, 8).astype(np.float32)


def _inside_root(events):
    roots = [e for e in events if e["name"] == "request"]
    assert len(roots) == 1
    r0 = roots[0]["ts"]
    r1 = r0 + roots[0]["dur"]
    for e in events:
        if e["name"].startswith("req.") and e.get("ph") == "X":
            assert r0 - SLACK_US <= e["ts"]
            assert e["ts"] + e["dur"] <= r1 + SLACK_US
    return roots[0]


# ---------------------------------------------------------------------------
class TestPredictSpanTree:
    def test_adopted_id_echoes_and_tree_is_connected(self):
        reg, srv = _serve()
        tid = "obs-test-predict-01"
        try:
            code, _, headers = _post(srv.url, "m", {"inputs": _x().tolist()},
                                     headers={tracectx.TRACE_HEADER: tid})
            assert code == 200 and headers.get(tracectx.TRACE_HEADER) == tid
        finally:
            srv.stop(drain=False)
            reg.shutdown()
        events = _trace_spans(tid)
        root = _inside_root(events)
        assert root["args"]["kind"] == "predict"
        assert root["args"]["verdict"] == "200"
        assert root["args"]["batch"] == 1
        names = {e["name"] for e in events}
        for want in ("req.admit", "req.queue", "req.batch_wait",
                     "req.device", "req.serialize"):
            assert want in names, f"missing {want}"

    def test_exemplar_carries_trace_id(self):
        reg, srv = _serve()
        tid = "obs-test-exemplar-01"
        try:
            code, _, _ = _post(srv.url, "m", {"inputs": _x().tolist()},
                               headers={tracectx.TRACE_HEADER: tid})
            assert code == 200
        finally:
            srv.stop(drain=False)
            reg.shutdown()
        ex = telemetry.histogram("dl4j_serving_total_seconds").exemplar_of(
            model="m")
        assert ex is not None and ex["labels"]["trace_id"] == tid
        assert f'trace_id="{tid}"' in \
            MetricsRegistry.get().render_prometheus()

    def test_minted_id_when_header_absent_or_hostile(self):
        reg, srv = _serve()
        try:
            _, _, h1 = _post(srv.url, "m", {"inputs": _x().tolist()})
            minted = h1.get(tracectx.TRACE_HEADER)
            assert minted and len(minted) == 16
            for bad in ("a bad id!", "x" * 65):
                _, _, h = _post(srv.url, "m", {"inputs": _x().tolist()},
                                headers={tracectx.TRACE_HEADER: bad})
                assert h.get(tracectx.TRACE_HEADER) not in (None, bad)
        finally:
            srv.stop(drain=False)
            reg.shutdown()

    def test_gate_off_serves_without_spans_or_header(self):
        reg, srv = _serve()
        try:
            tracectx.set_enabled(False)
            code, _, headers = _post(
                srv.url, "m", {"inputs": _x().tolist()},
                headers={tracectx.TRACE_HEADER: "gated-off-01"})
            assert code == 200
            assert tracectx.TRACE_HEADER not in headers
        finally:
            tracectx.set_enabled(None)
            srv.stop(drain=False)
            reg.shutdown()
        assert not [e for e in telemetry.trace_events()
                    if e.get("args", {}).get("trace") == "gated-off-01"]
        assert not RequestRecorder.get().records()


# ---------------------------------------------------------------------------
class TestAccessLog:
    def test_log_line_carries_trace_id(self, tmp_path, monkeypatch):
        log = tmp_path / "access.jsonl"
        monkeypatch.setenv("DL4J_TORCH_ACCESS_LOG", str(log))
        httputil._reset_access_conf()
        reg, srv = _serve()
        tid = "obs-test-accesslog-1"
        try:
            code, _, _ = _post(srv.url, "m", {"inputs": _x().tolist()},
                               headers={tracectx.TRACE_HEADER: tid})
            assert code == 200
        finally:
            srv.stop(drain=False)
            reg.shutdown()
            httputil._reset_access_conf()
        lines = [json.loads(ln) for ln in
                 log.read_text().strip().splitlines()]
        mine = [ln for ln in lines if ln["trace_id"] == tid]
        assert len(mine) == 1
        assert mine[0]["method"] == "POST"
        assert mine[0]["path"].endswith("m:predict")
        assert mine[0]["status"] == 200
        assert mine[0]["bytes"] > 0 and mine[0]["duration_ms"] > 0

    def test_sampling_keeps_one_in_n(self, tmp_path, monkeypatch):
        log = tmp_path / "sampled.jsonl"
        monkeypatch.setenv("DL4J_TORCH_ACCESS_LOG", str(log))
        monkeypatch.setenv("DL4J_TORCH_ACCESS_LOG_SAMPLE", "0.5")
        httputil._reset_access_conf()
        reg, srv = _serve()
        try:
            for i in range(8):
                code, _, _ = _post(srv.url, "m",
                                   {"inputs": _x(seed=i).tolist()})
                assert code == 200
        finally:
            srv.stop(drain=False)
            reg.shutdown()
            httputil._reset_access_conf()
        # 8 consecutive sequence numbers hold exactly 4 multiples of 2,
        # wherever the shared counter stood
        lines = [json.loads(ln) for ln in
                 log.read_text().strip().splitlines()]
        assert len(lines) == 4
        assert all(ln["trace_id"] and len(ln["trace_id"]) == 16
                   for ln in lines)


# ---------------------------------------------------------------------------
def _serve_generative(**overrides):
    model = DecoderLM(DecoderConfig.tiny())
    model.init("cpu", seed=5)
    reg = ModelRegistry("cpu")
    reg.register("lm", model, generate=dict(GEN, **overrides))
    return reg, InferenceServer(reg).start(0)


def _gen_request(port, body, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    conn.request("POST", "/v1/models/lm:generate",
                 body=json.dumps(body).encode(),
                 headers={"Content-Type": "application/json",
                          **(headers or {})})
    return conn, conn.getresponse()


class TestGenerateSpanTree:
    def test_stream_trace_with_ttft_and_stream_phase(self):
        reg, srv = _serve_generative()
        tid = "obs-test-generate-1"
        try:
            conn, resp = _gen_request(
                srv.port, {"prompt": [5, 9, 2, 7], "max_tokens": 4},
                headers={tracectx.TRACE_HEADER: tid})
            assert resp.status == 200
            assert resp.getheader(tracectx.TRACE_HEADER) == tid
            lines = [json.loads(ln) for ln in
                     resp.read().decode().strip().splitlines()]
            assert lines[-1]["done"]
            conn.close()
        finally:
            srv.stop(drain=False)
            reg.shutdown()
        events = _trace_spans(tid)
        root = _inside_root(events)
        assert root["args"]["kind"] == "generate"
        assert root["args"]["verdict"] == "200"
        assert root["args"]["tokens"] == 4
        names = {e["name"] for e in events}
        for want in ("req.admit", "req.queue", "req.device", "req.stream",
                     "req.serialize", "req.ttft", "req.inter_token"):
            assert want in names, f"missing {want}"
        assert sum(e["name"] == "req.inter_token" for e in events) == 3

    def test_client_disconnect_closes_span_as_499(self):
        reg, srv = _serve_generative(kv_blocks=80, max_seq_len=512)
        tid = "obs-test-cancel-01"
        try:
            conn, resp = _gen_request(
                srv.port, {"prompt": [5, 9, 2, 7], "max_tokens": 450},
                headers={tracectx.TRACE_HEADER: tid})
            resp.fp.readline()      # one token, then reset the socket
            conn.sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                                 struct.pack("ii", 1, 0))
            resp.close()
            conn.close()
            roots = [e for e in _trace_spans(tid, timeout=15.0)
                     if e["name"] == "request"]
            assert len(roots) == 1 and roots[0]["args"]["verdict"] == "499"
            recs = _records_of(tid)
            assert len(recs) == 1 and recs[0]["verdict"] == "499"
        finally:
            srv.stop(drain=False)
            reg.shutdown()


class TestTraceLeakage:
    def test_concurrent_predict_and_generate_no_crosstalk(self):
        reg = ModelRegistry("cpu", default_buckets=(8,))
        reg.register("m", _mlp(), warmup_shape=(8,))
        model = DecoderLM(DecoderConfig.tiny())
        model.init("cpu", seed=5)
        reg.register("lm", model, generate=GEN)
        srv = InferenceServer(reg).start(0)
        errors = []
        try:
            def predict_client(k):
                for i in range(3):
                    tid = f"leak-p{k}-{i}"
                    code, _, h = _post(srv.url, "m",
                                       {"inputs": _x(seed=i).tolist()},
                                       headers={tracectx.TRACE_HEADER: tid})
                    if code != 200 or h.get(tracectx.TRACE_HEADER) != tid:
                        errors.append(f"predict {tid}: {code} "
                                      f"{h.get(tracectx.TRACE_HEADER)!r}")

            def generate_client(k):
                for i in range(2):
                    tid = f"leak-g{k}-{i}"
                    conn, resp = _gen_request(
                        srv.port, {"prompt": [5, 9, 2, 7], "max_tokens": 3},
                        headers={tracectx.TRACE_HEADER: tid})
                    got = resp.getheader(tracectx.TRACE_HEADER)
                    resp.read()
                    conn.close()
                    if resp.status != 200 or got != tid:
                        errors.append(f"generate {tid}: {resp.status} "
                                      f"{got!r}")

            threads = [threading.Thread(target=predict_client, args=(k,))
                       for k in range(3)]
            threads += [threading.Thread(target=generate_client, args=(k,))
                        for k in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not errors, errors
        finally:
            srv.stop(drain=False)
            reg.shutdown()
        cases = [(f"leak-p{k}-{i}", "m", "predict")
                 for k in range(3) for i in range(3)]
        cases += [(f"leak-g{k}-{i}", "lm", "generate")
                  for k in range(2) for i in range(2)]
        for tid, model_name, kind in cases:
            roots = [e for e in _trace_spans(tid) if e["name"] == "request"]
            assert len(roots) == 1, f"{tid}: {len(roots)} roots"
            assert roots[0]["args"]["model"] == model_name
            assert roots[0]["args"]["kind"] == kind


# ---------------------------------------------------------------------------
class TestSLOAccounting:
    def test_multi_window_burn_rate_math(self):
        t = SLOTracker(target=0.99, fast_window_s=300.0,
                       slow_window_s=3600.0)
        t0 = 10_000.0
        for i in range(90):
            t.observe("m", 0.010, slo_ms=50.0, now=t0 + i * 0.1)
        for i in range(10):
            t.observe("m", 0.500, slo_ms=50.0, now=t0 + 9 + i * 0.1)
        now = t0 + 10
        assert t.burn_rate("m", "fast", now=now) == pytest.approx(10.0)
        assert t.burn_rate("m", "slow", now=now) == pytest.approx(10.0)
        rep = t.report(now=now)["models"]["m"]
        assert rep["windows"]["fast"]["in_slo_fraction"] == \
            pytest.approx(0.90)
        assert rep["budget_remaining"] == pytest.approx(-9.0)
        later = t0 + 10 + 400
        assert t.burn_rate("m", "fast", now=later) == 0.0
        assert t.burn_rate("m", "slow", now=later) == pytest.approx(10.0)
        assert t.burn_rate("other", now=now) is None

    def test_gauges_published_per_window(self):
        t = SLOTracker(target=0.99)
        t.observe("m", 0.500, slo_ms=50.0, now=1000.0)
        g = telemetry.gauge("dl4j_slo_in_fraction")
        assert g.value(model="m", window="fast") == 0.0
        assert g.value(model="m", window="slow") == 0.0
        assert telemetry.gauge("dl4j_slo_burn_rate").value(
            model="m", window="fast") == pytest.approx(100.0)
        assert telemetry.gauge("dl4j_slo_budget_remaining").value(
            model="m") == pytest.approx(-99.0)

    def test_api_slo_reports_forced_violation(self):
        reg, srv = _serve(latency_slo_ms=0.000001)
        try:
            code, _, _ = _post(srv.url, "m", {"inputs": _x().tolist()})
            assert code == 200
            with urllib.request.urlopen(f"{srv.url}/api/slo",
                                        timeout=TIMEOUT) as r:
                doc = json.load(r)
        finally:
            srv.stop(drain=False)
            reg.shutdown()
        assert doc["target"] == pytest.approx(0.99)
        m = doc["models"]["m"]
        assert m["slo_ms"] == pytest.approx(0.000001)
        assert m["windows"]["fast"]["n"] >= 1
        assert m["windows"]["fast"]["in_slo_fraction"] == 0.0
        assert m["windows"]["fast"]["burn_rate"] > 1.0
        assert m["budget_remaining"] < 1.0

    def test_reports_equal_the_jax_tracker(self):
        """The same seeded stream of (model, latency, SLO, now) through
        both packages' trackers: every report field within 1e-12."""
        rs = np.random.RandomState(19)
        kw = dict(target=0.995, fast_window_s=60.0, slow_window_s=600.0)
        port, jax_ = SLOTracker(**kw), JSLOTracker(**kw)
        now = 5000.0
        checkpoints = []
        for i in range(600):
            now += float(rs.exponential(2.0))
            model = "ab"[rs.randint(2)]
            lat = float(rs.lognormal(np.log(0.04), 0.6))
            slo = (50.0, 80.0)[model == "b"]
            port.observe(model, lat, slo, now=now)
            jax_.observe(model, lat, slo, now=now)
            if i % 97 == 0:
                checkpoints.append(now)
        checkpoints += [now, now + 100.0, now + 1000.0]

        def close(a, b):
            if isinstance(a, dict):
                assert a.keys() == b.keys()
                for k in a:
                    close(a[k], b[k])
            else:
                assert a == pytest.approx(b, rel=1e-12, abs=1e-12)

        for t in checkpoints:
            close(port.report(now=t), jax_.report(now=t))
            for m in "ab":
                for w in ("fast", "slow"):
                    close(port.burn_rate(m, w, now=t),
                          jax_.burn_rate(m, w, now=t))


# ---------------------------------------------------------------------------
class TestFlightRecorder:
    def test_ring_records_and_api_endpoints(self, tmp_path, monkeypatch):
        monkeypatch.setenv("DL4J_TORCH_REQREC_DIR", str(tmp_path))
        RequestRecorder._reset_for_tests()
        reg, srv = _serve()
        tid = "obs-test-reqrec-01"
        try:
            code, _, _ = _post(srv.url, "m", {"inputs": _x().tolist()},
                               headers={tracectx.TRACE_HEADER: tid})
            assert code == 200 and _records_of(tid)
            with urllib.request.urlopen(f"{srv.url}/api/reqrec?n=5",
                                        timeout=TIMEOUT) as r:
                live = json.load(r)["requests"]
            req = urllib.request.Request(f"{srv.url}/api/reqrec/dump",
                                         data=b"")
            with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
                dump = json.load(r)
        finally:
            srv.stop(drain=False)
            reg.shutdown()
        mine = [r for r in live if r["trace_id"] == tid]
        assert len(mine) == 1
        assert mine[0]["model"] == "m" and mine[0]["verdict"] == "200"
        assert mine[0]["phase_ms"].get("device", -1) >= 0
        assert "queue_depth" in mine[0]
        path = dump["path"]
        assert path and path.startswith(str(tmp_path))
        lines = [json.loads(ln) for ln in
                 open(path).read().strip().splitlines()]
        assert lines[0]["record"] == "meta" and lines[0]["reason"] == "api"
        assert any(r.get("trace_id") == tid for r in lines[1:])
        trace = json.load(open(path.replace(".jsonl", ".trace.json")))
        assert any(e["args"].get("trace") == tid
                   for e in trace["traceEvents"])
        assert telemetry.counter("dl4j_reqrec_dumps_total").value(
            reason="api") == 1

    def test_shed_storm_threshold_and_cooldown(self, tmp_path, monkeypatch):
        monkeypatch.setenv("DL4J_TORCH_REQREC_DIR", str(tmp_path))
        monkeypatch.setenv("DL4J_TORCH_REQREC_SHED_THRESHOLD", "3")
        monkeypatch.setenv("DL4J_TORCH_REQREC_SHED_WINDOW_S", "30")
        monkeypatch.setenv("DL4J_TORCH_REQREC_STORM_COOLDOWN_S", "60")
        RequestRecorder._reset_for_tests()
        rec = RequestRecorder.get()
        assert rec.note_shed("m", "queue_full") is None
        assert rec.note_shed("m", "queue_full") is None
        path = rec.note_shed("m", "queue_full")
        assert path is not None
        meta = json.loads(open(path).readline())
        assert meta["reason"] == "shed_storm"
        assert meta["event"]["sheds_in_window"] == 3
        assert rec.note_shed("m", "queue_full") is None

    def test_records_and_dumps_match_the_jax_recorder(self, tmp_path,
                                                      monkeypatch):
        """One request's context, with the same phases and notes, through
        both packages' recorders: the same record keys and phase names,
        and the same keys in the dump's meta line."""
        monkeypatch.setenv("DL4J_TORCH_REQREC_DIR", str(tmp_path / "port"))
        monkeypatch.setenv("DL4J_TPU_REQREC_DIR", str(tmp_path / "jax"))
        RequestRecorder._reset_for_tests()
        JRequestRecorder._reset_for_tests()
        recs, metas = [], []
        try:
            for tc, rr in ((tracectx, RequestRecorder),
                           (jtracectx, JRequestRecorder)):
                ctx = tc.TraceContext("m", "predict", trace_id="rec-parity")
                t = time.monotonic()
                for i, phase in enumerate(tc.PHASES[:5]):
                    ctx.phase_at(phase, t + i * 1e-3, t + (i + 1) * 1e-3)
                ctx.note(batch=3, occupancy=0.375)
                ctx.finish(200)
                rec = rr.get()
                rec.record(ctx, 200, queue_depth=1)
                recs.append(rec.records()[-1])
                path = rec.dump("api")
                metas.append(json.loads(open(path).readline()))
        finally:
            JRequestRecorder._reset_for_tests()
        assert tracectx.PHASES == jtracectx.PHASES
        assert recs[0].keys() == recs[1].keys()
        assert recs[0]["phase_ms"].keys() == recs[1]["phase_ms"].keys()
        for k in ("trace_id", "model", "kind", "verdict", "batch",
                  "occupancy", "queue_depth"):
            assert recs[0][k] == recs[1][k]
        assert recs[0]["phase_ms"] == pytest.approx(recs[1]["phase_ms"],
                                                    abs=1e-3)
        assert metas[0].keys() == metas[1].keys()
        assert metas[0]["schema_version"] == metas[1]["schema_version"]


# ---------------------------------------------------------------------------
class TestTelemetryCore:
    def test_quantiles_exemplars_and_snapshot_match_jax(self):
        rs = np.random.RandomState(4)
        vals = rs.lognormal(np.log(0.01), 1.0, 300)
        port = telemetry.histogram("dl4j_test_parity_seconds")
        jreg = jtelemetry.MetricsRegistry(enabled=True)
        jax_ = jreg.histogram("dl4j_test_parity_seconds")
        for i, v in enumerate(vals):
            port.observe_with_exemplar(float(v), {"trace_id": f"t{i}"},
                                       model="m")
            jax_.observe_with_exemplar(float(v), {"trace_id": f"t{i}"},
                                       model="m")
        for q in (0.5, 0.9, 0.99, 1.0):
            assert port.quantile(q, model="m") == pytest.approx(
                jax_.quantile(q, model="m"), rel=1e-12)
        assert np.isnan(port.quantile(0.5, model="none"))
        assert port.count_of(model="m") == jax_.count_of(model="m") == 300
        assert port.sum_of(model="m") == pytest.approx(
            jax_.sum_of(model="m"), rel=1e-12)
        assert port.exemplar_of(model="m")["labels"] == \
            jax_.exemplar_of(model="m")["labels"] == {"trace_id": "t299"}
        snap = MetricsRegistry.get().snapshot()["dl4j_test_parity_seconds"]
        jsnap = jreg.snapshot()["dl4j_test_parity_seconds"]
        assert snap.keys() == jsnap.keys() == {"model=m"}
        assert snap["model=m"] == pytest.approx(jsnap["model=m"],
                                                rel=1e-12)
        g = telemetry.gauge("dl4j_test_parity_gauge")
        g.inc(3, model="m")
        g.dec(1, model="m")
        assert g.value(model="m") == 2
        telemetry.counter("dl4j_test_parity_total").bind(model="m").inc(2)
        assert MetricsRegistry.get().summary()[
            "dl4j_test_parity_total"] == {"model=m": 2}

    def test_gate_off_records_nothing_until_reset(self):
        reg = MetricsRegistry.get()
        c = telemetry.counter("dl4j_test_gate_total")
        reg.set_enabled(False)
        c.inc(model="m")
        telemetry.instant("gated")
        assert c.value(model="m") == 0 and not telemetry.trace_events()
        assert tracectx.start("m", "predict") is tracectx.NULL
        MetricsRegistry._reset_for_tests()      # back to the environment's
        assert reg.enabled and tracectx.request_trace_enabled()
        c.inc(model="m")
        assert c.value(model="m") == 1

    def test_export_merge_and_ring_bound(self, tmp_path):
        buf = telemetry._trace_buffer
        old = buf.max_events
        try:
            buf.max_events = 5
            for i in range(8):
                telemetry.instant("tick", i=i)
            with telemetry.span("outer", k=1):
                pass
            telemetry.span_at("explicit", time.time(), 0.002, k=2)
        finally:
            buf.max_events = old
        events = telemetry.trace_events()
        assert len(events) == 5
        assert [e["name"] for e in events[-2:]] == ["outer", "explicit"]
        assert events[-1]["dur"] == 2000
        a = telemetry.export_chrome_trace(str(tmp_path / "a.json"),
                                          {"host": "w0",
                                           "clock_offset_s": 0.5})
        doc = json.load(open(a))
        assert doc["metadata"]["dropped_events"] == 5
        assert telemetry.counter(
            "dl4j_trace_events_dropped_total").value() == 5
        merged = telemetry.merge_host_traces(str(tmp_path / "m.json"), a,
                                             {"path": a, "host": "w1",
                                              "clock_offset_s": 0.0})
        mdoc = json.load(open(merged))
        by_host = [h["host"] for h in mdoc["metadata"]["hosts"]]
        assert by_host == ["w0", "w1"]
        shifted = [e for e in mdoc["traceEvents"] if e["name"] == "explicit"]
        assert shifted[1]["ts"] - shifted[0]["ts"] == 500_000
        both = telemetry.merge_chrome_traces(str(tmp_path / "c.json"), a, a)
        assert len(json.load(open(both))["traceEvents"]) == 10


# ---------------------------------------------------------------------------
class TestDrainRateColdWindow:
    def test_single_completion_reports_floor_not_spike(self):
        c = AdmissionController(max_queue=4, rate_window_s=30.0)
        c.observe_total("m", 0.01, now=100.0)
        with c._lock:
            rate = c._drain_rate_locked("m", 100.0005)
        assert rate == pytest.approx(1 / 30.0)

    def test_two_spanning_samples_measure_real_rate(self):
        c = AdmissionController(max_queue=4, rate_window_s=30.0)
        c.observe_total("m", 0.01, now=100.0)
        c.observe_total("m", 0.01, now=101.0)
        with c._lock:
            rate = c._drain_rate_locked("m", 101.0)
        assert rate == pytest.approx(2.0)
        assert telemetry.gauge("dl4j_serving_drain_rate_rps").value(
            model="m") == pytest.approx(2.0)

    def test_budget_shrink_feeds_and_reads_the_slo_tracker(self):
        c = AdmissionController(max_queue=10, latency_slo_ms=10.0)
        now = time.monotonic()
        c.observe_total("m", 0.5, now=now, trace_id="shrink-1")
        assert c.budget("m") == 7
        assert SLOTracker.get().burn_rate("m", "fast", now=now) == \
            pytest.approx(100.0)
        shrink = [e for e in telemetry.trace_events()
                  if e["name"] == "admission.shrink"]
        assert shrink and shrink[-1]["args"]["budget"] == 7
        assert shrink[-1]["args"]["burn_rate_fast"] == pytest.approx(100.0)
