"""HTTP inference server over the model registry.

Counterpart of ``deeplearning4j_tpu/serving/server.py``: a stdlib
``ThreadingHTTPServer`` whose handler threads block on their request's
Future while the model's batcher aggregates concurrent requests into
bucket-padded flushes.

Endpoints:

- ``POST /v1/models/<name>:predict``: JSON ``{"inputs": [[...]],
  "deadline_ms": optional}`` -> ``{"outputs", "model", "version",
  "batch"}``; or a raw ``.npy`` body (``Content-Type:
  application/octet-stream``) -> a raw ``.npy`` response.
  ``X-Deadline-Ms`` works for both.
- ``POST /v1/models/<name>:generate``: JSON ``{"prompt": [ids...],
  "max_tokens": N, "temperature": 0.0, "top_k": 0, "deadline_ms":
  optional, "stream": true}``. Streaming (the default) answers chunked
  ``application/x-ndjson``: one ``{"token": id, "index": i}`` line per
  token as it decodes, then ``{"done": true, "reason": ..., "tokens":
  n}``; ``stream: false`` buffers one JSON object. Admission is by
  token cost (the KV blocks of prompt and completion); a full KV pool
  sheds 429 + ``Retry-After`` before any chunk is sent; a client
  disconnect cancels the stream (its blocks free on the engine's next
  iteration); a failure after the first chunk truncates the chunk
  stream. The time to the first token feeds the admission controller.
- ``GET /v1/models``, ``GET /healthz``, ``GET /readyz``,
  ``GET /metrics`` (Prometheus text).
- ``GET /api/slo``: each model's in-SLO fraction, burn rates and
  remaining error budget (``SLOTracker.report``).
- ``GET /api/reqrec?n=``: the request flight recorder's last ``n``
  records (default 100); ``POST /api/reqrec/dump`` writes its dump.

Request observatory: each ``:predict`` and ``:generate`` gets a
:class:`~deeplearning4j_tpu_torch.common.tracectx.TraceContext` at
ingress (its id minted, or adopted from ``X-Dl4j-Trace-Id``, and echoed
on the response). The ``admit`` and ``serialize`` phases are timed here,
the ``queue`` / ``batch_wait`` / ``device`` phases by the batcher or the
decode engine, plus a ``req.ttft`` instant and the ``stream`` phase for a
generate; the ``request`` root span closes with the verdict. The total
latency carries the trace id as its histogram exemplar, every verdict
(200, 429, 499, 503, 504, 500) is recorded in the
:class:`~deeplearning4j_tpu_torch.serving.reqrec.RequestRecorder` ring,
and every shed feeds its storm detector. ``DL4J_TORCH_REQUEST_TRACE=0``
turns all of it off.

Status mapping: shed -> 429 + ``Retry-After``; draining -> 503;
deadline expired -> 504; unknown model -> 404; bad body, or a model
without a generate surface asked to generate -> 400; inference failure
-> 500.
"""
from __future__ import annotations

import json
import re
import threading
import time
from concurrent import futures
from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.common import telemetry, tracectx
from deeplearning4j_tpu_torch.common.httputil import (QuietHandler,
                                                      npy_header, npy_view,
                                                      start_http_server)
from deeplearning4j_tpu_torch.serving import reqrec
from deeplearning4j_tpu_torch.serving.admission import (AdmissionController,
                                                        DeadlineExceeded,
                                                        ShedError,
                                                        deadline_after_ms)
from deeplearning4j_tpu_torch.serving.registry import ModelRegistry
from deeplearning4j_tpu_torch.serving.slo import SLOTracker

_PREDICT_RE = re.compile(r"^/v1/models/([^/:]+):predict$")
_GENERATE_RE = re.compile(r"^/v1/models/([^/:]+):generate$")
_NPY_TYPES = ("application/octet-stream", "application/x-npy")


def query_int(path: str, key: str, default: int) -> int:
    """``?key=N`` of a request path (``default`` when absent or not an
    integer)."""
    from urllib.parse import parse_qs, urlsplit
    try:
        vals = parse_qs(urlsplit(path).query).get(key)
        return int(vals[0]) if vals else default
    except (ValueError, TypeError, IndexError):
        return default


def observatory_get(handler: QuietHandler) -> bool:
    """Answer ``GET /api/slo`` and ``GET /api/reqrec`` (the process's
    tracker and recorder, which in-process replicas share); False for
    any other path."""
    if handler.path == "/api/slo":
        handler.send_json(SLOTracker.get().report())
    elif handler.path.split("?")[0] == "/api/reqrec":
        n = query_int(handler.path, "n", 100)
        handler.send_json({"requests": reqrec.get().records(n)})
    else:
        return False
    return True


def reqrec_dump(handler: QuietHandler) -> None:
    """``POST /api/reqrec/dump``: 200 with the dump's path, 503 when the
    recorder is off or the write failed."""
    path = reqrec.get().dump("api")
    handler.send_json({"path": path}, 200 if path else 503)


class InferenceServer:
    """Serve a :class:`ModelRegistry` over HTTP."""

    def __init__(self, registry: ModelRegistry,
                 admission: Optional[AdmissionController] = None,
                 *, request_timeout_s: float = 60.0):
        self.registry = registry
        self.admission = admission if admission is not None \
            else AdmissionController()
        self.request_timeout_s = request_timeout_s
        self._httpd = None
        self._thread: Optional[threading.Thread] = None
        self.port: Optional[int] = None

    def start(self, port: int = 0) -> "InferenceServer":
        """Serve on ``DL4J_TORCH_HTTP_HOST``:port (0 picks a free port;
        see ``self.port``). Idempotent."""
        if self._httpd is not None:
            return self
        server = self

        class Handler(QuietHandler):
            def do_GET(self):               # noqa: N802
                if self.path == "/v1/models":
                    self.send_json({"models": server.registry.describe()})
                elif self.path == "/healthz":
                    self.send_body(b"ok\n", "text/plain")
                elif self.path == "/readyz":
                    ok = (server.registry.ready()
                          and not server.admission.draining)
                    self.send_body(b"ready\n" if ok else b"not ready\n",
                                   "text/plain", 200 if ok else 503)
                elif self.path == "/metrics":
                    self.send_metrics()
                elif not observatory_get(self):
                    self.send_json({"error": "not found"}, 404)

            def do_POST(self):              # noqa: N802
                m = _PREDICT_RE.match(self.path)
                if m:
                    server._predict(self, m.group(1))
                    return
                g = _GENERATE_RE.match(self.path)
                if g:
                    server._generate(self, g.group(1))
                    return
                if self.path == "/api/reqrec/dump":
                    reqrec_dump(self)
                    return
                self.send_json({"error": "not found"}, 404)

        self._httpd, self._thread = start_http_server(Handler, port)
        self.port = self._httpd.server_address[1]
        return self

    def stop(self, drain: bool = True, timeout: float = 30.0):
        """Stop serving; with ``drain`` admission first rejects new work
        and in-flight requests finish."""
        if self._httpd is None:
            return
        if drain:
            self.admission.drain(timeout)
        self._httpd.shutdown()
        self._httpd.server_close()
        self._httpd = None
        self._thread = None
        self.port = None

    @property
    def url(self) -> Optional[str]:
        if not self.port:
            return None
        host = self._httpd.server_address[0]
        if host in ("0.0.0.0", "::"):
            host = "127.0.0.1"
        return f"http://{host}:{self.port}"

    # ------------------------------------------------------------------
    def _finish_request(self, ctx, verdict) -> None:
        """Close a request's trace (the root span, with its verdict) and
        append it to the flight recorder's ring."""
        if not ctx:
            return
        ctx.finish(verdict)
        reqrec.get().record(ctx, verdict,
                            queue_depth=self.admission.inflight(ctx.model))

    def _predict(self, handler: QuietHandler, name: str):
        ctx = tracectx.start(name, "predict",
                             handler.headers.get(tracectx.TRACE_HEADER))
        handler._trace_id = ctx.trace_id if ctx else None
        with tracectx.bind(ctx):
            self._predict_traced(handler, name, ctx)

    def _predict_traced(self, handler: QuietHandler, name: str, ctx):
        counted = telemetry.counter(
            "dl4j_serving_requests_total",
            "predict requests by model and HTTP status code")
        trace_headers = ({tracectx.TRACE_HEADER: ctx.trace_id}
                         if ctx else {})

        def finish_json(obj, code, headers=None):
            counted.inc(model=name, code=str(code))
            hdrs = dict(trace_headers)
            hdrs.update(headers or {})
            with ctx.phase("serialize"):
                handler.send_json(obj, code, hdrs or None)
            self._finish_request(ctx, code)

        try:
            version = self.registry.model(name)
        except KeyError:
            finish_json({"error": f"model {name!r} not found"}, 404)
            return
        if version.latency_slo_ms is not None:
            self.admission.set_slo(name, version.latency_slo_ms)
        raw = (handler.headers.get("Content-Type", "")
               .split(";")[0].strip() in _NPY_TYPES)
        body = handler.read_body()
        deadline_ms = handler.headers.get("X-Deadline-Ms")
        try:
            if raw:
                x = npy_view(body)
            else:
                doc = json.loads(body.decode() or "{}")
                if "inputs" not in doc:
                    finish_json({"error": "body must carry 'inputs'"}, 400)
                    return
                x = np.asarray(doc["inputs"], dtype=np.float32)
                if deadline_ms is None:
                    deadline_ms = doc.get("deadline_ms")
            if x.ndim < 1 or x.shape[0] < 1:
                finish_json({"error": "inputs need a leading batch dim "
                                      "of >= 1"}, 400)
                return
        except (ValueError, TypeError, UnicodeDecodeError) as e:
            finish_json({"error": f"bad request body: {e}"}, 400)
            return
        deadline = deadline_after_ms(
            float(deadline_ms) if deadline_ms is not None else None)
        t_start = time.monotonic()
        try:
            with ctx.phase("admit"):
                self.admission.admit(name, deadline)
            try:
                fut = version.batcher.submit(x, deadline=deadline,
                                             ctx=ctx or None)
                timeout = (float(deadline_ms) / 1e3 + 1.0
                           if deadline_ms is not None
                           else self.request_timeout_s)
                try:
                    out = fut.result(timeout=timeout)
                except futures.TimeoutError:
                    fut.cancel()
                    raise
            finally:
                self.admission.release(name)
        except DeadlineExceeded as e:
            finish_json({"error": str(e)}, 504)
            return
        except ShedError as e:
            reqrec.get().note_shed(name, e.reason)
            finish_json({"error": str(e), "reason": e.reason},
                        503 if e.reason == "draining" else 429,
                        {"Retry-After":
                         self.admission.retry_after_header(name)})
            return
        except futures.TimeoutError:
            finish_json({"error": "request timed out"}, 504)
            return
        except Exception as e:          # the model raised during compute
            finish_json({"error": f"inference failed: {e}"}, 500)
            return
        self.admission.observe_total(name, time.monotonic() - t_start,
                                     trace_id=ctx.trace_id if ctx else None)
        if raw:
            out_arr = np.ascontiguousarray(out)
            counted.inc(model=name, code="200")
            hdrs = {"X-Model-Version": str(version.version)}
            hdrs.update(trace_headers)
            with ctx.phase("serialize"):
                handler.send_body_parts(
                    [npy_header(out_arr), memoryview(out_arr)],
                    "application/octet-stream", headers=hdrs)
            self._finish_request(ctx, 200)
        else:
            finish_json({"outputs": np.asarray(out).tolist(),
                         "model": name, "version": version.version,
                         "batch": int(x.shape[0])}, 200)

    # ------------------------------------------------------------------
    def _generate(self, handler: QuietHandler, name: str):
        ctx = tracectx.start(name, "generate",
                             handler.headers.get(tracectx.TRACE_HEADER))
        handler._trace_id = ctx.trace_id if ctx else None
        with tracectx.bind(ctx):
            self._generate_traced(handler, name, ctx)

    def _generate_traced(self, handler: QuietHandler, name: str, ctx):
        """``POST /v1/models/<name>:generate`` (see the module doc)."""
        counted = telemetry.counter(
            "dl4j_serving_requests_total",
            "predict requests by model and HTTP status code")
        trace_headers = ({tracectx.TRACE_HEADER: ctx.trace_id}
                         if ctx else {})

        def finish_json(obj, code, headers=None):
            counted.inc(model=name, code=str(code))
            hdrs = dict(trace_headers)
            hdrs.update(headers or {})
            with ctx.phase("serialize"):
                handler.send_json(obj, code, hdrs or None)
            self._finish_request(ctx, code)

        try:
            version = self.registry.model(name)
        except KeyError:
            finish_json({"error": f"model {name!r} not found"}, 404)
            return
        if not version.batcher.is_generative:
            finish_json({"error": f"model {name!r} has no generate "
                                  f"surface"}, 400)
            return
        if version.latency_slo_ms is not None:
            self.admission.set_slo(name, version.latency_slo_ms)
        try:
            doc = json.loads(handler.read_body().decode() or "{}")
            prompt = [int(t) for t in doc["prompt"]]
            if not prompt:
                raise ValueError("prompt must not be empty")
            max_tokens = int(doc.get("max_tokens", 16))
            temperature = float(doc.get("temperature", 0.0))
            top_k = int(doc.get("top_k", 0))
            streaming = bool(doc.get("stream", True))
            deadline_ms = (handler.headers.get("X-Deadline-Ms")
                           or doc.get("deadline_ms"))
            deadline = deadline_after_ms(
                float(deadline_ms) if deadline_ms is not None else None)
        except (KeyError, ValueError, TypeError, UnicodeDecodeError) as e:
            finish_json({"error": f"bad request body: {e}"}, 400)
            return
        t_start = time.monotonic()
        cost = version.batcher.generate_cost(len(prompt), max_tokens)
        tokens_out, idx = [], 0
        headers_sent = False
        t_first = None
        try:
            with ctx.phase("admit"):
                self.admission.admit(name, deadline, cost=cost)
            try:
                stream = version.batcher.submit_generate(
                    prompt, max_tokens, temperature=temperature,
                    top_k=top_k, deadline=deadline, ctx=ctx or None)
                try:
                    while True:
                        tok = stream.next(timeout=self.request_timeout_s)
                        if tok is None:             # closed: see reason
                            break
                        if idx == 0:
                            # time to the first token feeds the admission
                            # controller (drain rate, AIMD budget, SLO)
                            t_first = time.monotonic()
                            self.admission.observe_total(
                                name, t_first - t_start,
                                trace_id=ctx.trace_id if ctx else None)
                            ctx.instant("ttft", ms=round(
                                (t_first - t_start) * 1e3, 3))
                            if streaming:
                                hdrs = {"X-Model-Version":
                                        str(version.version)}
                                hdrs.update(trace_headers)
                                handler.begin_chunks(
                                    "application/x-ndjson", headers=hdrs)
                                headers_sent = True
                        if streaming:
                            handler.send_chunk(json.dumps(
                                {"token": tok, "index": idx}).encode()
                                + b"\n")
                        else:
                            tokens_out.append(tok)
                        idx += 1
                    if t_first is not None:
                        # the stream phase: first token to stream end
                        ctx.phase_at("stream", t_first, time.monotonic())
                except OSError:
                    # the client went away mid-stream: cancel, so the
                    # engine retires the sequence and frees its blocks
                    stream.cancel()
                    counted.inc(model=name, code="499")
                    handler.close_connection = True
                    if t_first is not None:
                        ctx.phase_at("stream", t_first, time.monotonic())
                    ctx.note(tokens=idx)
                    self._finish_request(ctx, 499)
                    return
                except Exception:
                    stream.cancel()
                    raise
            finally:
                self.admission.release(name, cost=cost)
        except DeadlineExceeded as e:
            if headers_sent:
                handler.abort_chunks()
                self._finish_request(ctx, 504)
            else:
                finish_json({"error": str(e)}, 504)
            return
        except ShedError as e:
            reqrec.get().note_shed(name, e.reason)
            code = 503 if e.reason == "draining" else 429
            if headers_sent:
                handler.abort_chunks()
                self._finish_request(ctx, code)
            else:
                finish_json({"error": str(e), "reason": e.reason}, code,
                            {"Retry-After":
                             self.admission.retry_after_header(name)})
            return
        except Exception as e:
            # after the headers: truncate the chunk stream (a prompt
            # client error, not a wedged connection); before: a 500
            if headers_sent:
                handler.abort_chunks()
                self._finish_request(ctx, 500)
            else:
                finish_json({"error": f"generate failed: {e}"}, 500)
            return
        ctx.note(tokens=idx)
        if not headers_sent and streaming:
            # closed before the first token (e.g. its deadline passed in
            # the prefill queue)
            code = 504 if stream.reason == "deadline" else 500
            finish_json({"error": f"generate ended before the first "
                                  f"token ({stream.reason})"}, code)
            return
        if streaming:
            with ctx.phase("serialize"):
                handler.send_chunk(json.dumps(
                    {"done": True, "reason": stream.reason,
                     "tokens": idx}).encode() + b"\n")
                handler.end_chunks()
            counted.inc(model=name, code="200")
            self._finish_request(ctx, 200)
        else:
            finish_json({"tokens": tokens_out, "reason": stream.reason,
                         "model": name, "version": version.version}, 200)
