"""Multi-replica serving router: least-loaded dispatch, health-gated
routing and fleet-wide warm-then-drain rollouts.

Counterpart of ``deeplearning4j_tpu/serving/router.py``. A
:class:`ServingRouter` owns N in-process replicas, each a full
(:class:`~deeplearning4j_tpu_torch.serving.registry.ModelRegistry`,
:class:`~deeplearning4j_tpu_torch.serving.admission.AdmissionController`,
:class:`~deeplearning4j_tpu_torch.serving.server.InferenceServer`) stack
on a port of its own and a device of its own, and fronts them with one
HTTP listener:

- ``POST /v1/models/<name>:predict``: proxied to the healthy replica
  with the fewest outstanding router-dispatched requests. A
  connection-level failure takes the replica out of rotation and the
  request retries on the next one; application statuses (429, 503, 504,
  with their ``Retry-After`` and ``X-Model-Version``) are relayed as
  they are: shedding is the replica's verdict, not a router failure.
- ``POST /v1/models/<name>:generate``: the same dispatch; the replica's
  chunked token stream is relayed chunk by chunk, so each token reaches
  the client the moment the replica emits it.
- ``GET /v1/replicas`` (each replica's health, outstanding requests,
  url and readiness), ``GET /v1/models`` (a healthy replica's catalog),
  ``GET /healthz``, ``GET /readyz`` (ready while one replica is),
  ``GET /metrics``, ``GET /api/slo``, ``GET /api/reqrec?n=`` and
  ``POST /api/reqrec/dump`` (the process's registry, tracker and
  recorder, which in-process replicas share).

The trace id of a request (``X-Dl4j-Trace-Id``, adopted or minted here)
crosses to the replica, which adopts it, and comes back on the response
with ``X-Dl4j-Replica``; a ``req.route`` span covers the router's part.

:meth:`ServingRouter.rollout` re-registers a model on one replica at a
time, and each replica warms the new version fully before its live
pointer flips, so every replica always serves a warm version and the
fleet drops no request. A thread polls each replica's ``/healthz`` every
``health_interval_s`` (``dl4j_serving_router_healthy`` mirrors the
verdict); a replica taken out by a failed proxy comes back on its next
good poll.

Devices: ``device=None`` is the card (an error without one, as for the
registry); on a machine with several cards replica ``i`` serves on
``cuda:(i mod count)``, on one card they share it. ``device="cpu"`` puts
every replica on the CPU (tests).
"""
from __future__ import annotations

import http.client
import re
import threading
import time
from pathlib import Path
from typing import List, Optional, Union

import torch

from deeplearning4j_tpu_torch.common import telemetry, tracectx
from deeplearning4j_tpu_torch.common.environment import resolve_device
from deeplearning4j_tpu_torch.common.httputil import (QuietHandler,
                                                      start_http_server)
from deeplearning4j_tpu_torch.serving.admission import AdmissionController
from deeplearning4j_tpu_torch.serving.registry import ModelRegistry
from deeplearning4j_tpu_torch.serving.server import (InferenceServer,
                                                     observatory_get,
                                                     reqrec_dump)

_ROUTE_RE = re.compile(r"^/v1/models/([^/:]+):(predict|generate)$")

#: headers relayed as they are in each direction; the trace id crosses
#: both ways
_RELAY_REQ = ("Content-Type", "X-Deadline-Ms", tracectx.TRACE_HEADER)
_RELAY_RESP = ("Content-Type", "Retry-After", "X-Model-Version",
               tracectx.TRACE_HEADER)


def _healthy_gauge() -> telemetry.Gauge:
    return telemetry.gauge(
        "dl4j_serving_router_healthy",
        "router's health verdict per replica (1 in rotation, 0 out after "
        "a failed health poll or a connection error)")


def replica_devices(n: int, device: Union[None, str, torch.device] = None
                    ) -> List[torch.device]:
    """The device of each of ``n`` replicas: round-robin over the cards
    when ``device`` is None or names the card without an index, else
    ``device`` for every replica."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        count = torch.cuda.device_count()
        return [torch.device("cuda", i % count) for i in range(n)]
    return [dev] * n


class Replica:
    """One in-process serving stack plus the router's bookkeeping."""

    def __init__(self, name: str, registry: ModelRegistry,
                 admission: AdmissionController, server: InferenceServer,
                 device: torch.device):
        self.name = name
        self.registry = registry
        self.admission = admission
        self.server = server
        self.device = device
        self.healthy = True
        self._outstanding = 0
        self._lock = threading.Lock()

    @property
    def outstanding(self) -> int:
        return self._outstanding

    def begin(self):
        with self._lock:
            self._outstanding += 1

    def end(self):
        with self._lock:
            self._outstanding = max(0, self._outstanding - 1)

    def set_healthy(self, ok: bool):
        self.healthy = ok
        _healthy_gauge().set(1 if ok else 0, replica=self.name)

    def host_port(self):
        httpd = self.server._httpd
        if httpd is None:       # a stopped replica: a connection failure
            raise OSError("replica server is not running")
        host, port = httpd.server_address[0], httpd.server_address[1]
        if host in ("0.0.0.0", "::"):
            host = "127.0.0.1"
        return host, port

    def describe(self) -> dict:
        return {"name": self.name, "url": self.server.url,
                "device": str(self.device), "healthy": self.healthy,
                "outstanding": self.outstanding,
                "ready": self.registry.ready()
                and not self.admission.draining}


class ServingRouter:
    """N serving replicas behind one least-loaded HTTP front."""

    def __init__(self, n_replicas: int = 2, *,
                 device: Union[None, str, torch.device] = None,
                 default_buckets=(8, 32),
                 flush_policy: str = "continuous",
                 queue_limit: int = 256,
                 batch_window_ms: float = 2.0,
                 admission_factory=None,
                 request_timeout_s: float = 60.0,
                 health_interval_s: float = 1.0):
        if n_replicas < 1:
            raise ValueError("need at least one replica")
        self.replicas: List[Replica] = []
        for i, dev in enumerate(replica_devices(n_replicas, device)):
            registry = ModelRegistry(
                dev, default_buckets=default_buckets,
                batch_window_ms=batch_window_ms, queue_limit=queue_limit,
                flush_policy=flush_policy)
            admission = (admission_factory() if admission_factory
                         else AdmissionController())
            server = InferenceServer(registry, admission,
                                     request_timeout_s=request_timeout_s)
            self.replicas.append(Replica(f"replica-{i}", registry,
                                         admission, server, dev))
        self.health_interval_s = health_interval_s
        self._httpd = None
        self._thread: Optional[threading.Thread] = None
        self._health_thread: Optional[threading.Thread] = None
        #: wakes the poller early: stop(), or a changed interval
        self._health_wake = threading.Event()
        self._stopping = False
        self.port: Optional[int] = None

    # ------------------------------------------------------------------
    def start(self, port: int = 0) -> "ServingRouter":
        """Start every replica's server (each on a free port), then the
        front, then the health poller. Idempotent."""
        if self._httpd is not None:
            return self
        for r in self.replicas:
            r.server.start(0)
            r.set_healthy(True)
        router = self

        class Handler(QuietHandler):
            def do_GET(self):               # noqa: N802
                if self.path == "/v1/replicas":
                    self.send_json({"replicas": [
                        r.describe() for r in router.replicas]})
                elif self.path == "/v1/models":
                    rep = router._pick() or router.replicas[0]
                    self.send_json({"models": rep.registry.describe()})
                elif self.path == "/healthz":
                    self.send_body(b"ok\n", "text/plain")
                elif self.path == "/readyz":
                    ok = any(r.healthy and r.registry.ready()
                             and not r.admission.draining
                             for r in router.replicas)
                    self.send_body(b"ready\n" if ok else b"not ready\n",
                                   "text/plain", 200 if ok else 503)
                elif self.path == "/metrics":
                    self.send_metrics()
                elif not observatory_get(self):
                    self.send_json({"error": "not found"}, 404)

            def do_POST(self):              # noqa: N802
                if _ROUTE_RE.match(self.path):
                    router._proxy(self)
                elif self.path == "/api/reqrec/dump":
                    reqrec_dump(self)
                else:
                    self.send_json({"error": "not found"}, 404)

        self._httpd, self._thread = start_http_server(Handler, port)
        self.port = self._httpd.server_address[1]
        self._stopping = False
        self._health_wake.clear()
        self._health_thread = threading.Thread(
            target=self._health_loop, daemon=True,
            name="dl4j-torch-router-health")
        self._health_thread.start()
        return self

    def stop(self, drain: bool = True, timeout: float = 30.0):
        """Stop the front and the poller, then every replica (draining
        by default)."""
        self._stopping = True
        self._health_wake.set()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
            self._thread = None
            self.port = None
        if self._health_thread is not None:
            self._health_thread.join(timeout)
            self._health_thread = None
        for r in self.replicas:
            r.server.stop(drain=drain, timeout=timeout)
            r.registry.shutdown()

    @property
    def url(self) -> Optional[str]:
        return f"http://127.0.0.1:{self.port}" if self.port else None

    # ------------------------------------------------------------------
    def rollout(self, name: str, model, **register_kw) -> List:
        """Register (or hot-swap) ``name`` across the fleet, one replica
        at a time, each warmed before its live pointer flips.

        ``model`` is a zero-argument factory (called once a replica: each
        replica needs its own instance of an in-memory model, which
        serves on the device it was built on), an artifact path (each
        replica restores its own copy onto its device), or one object
        shared by every replica.
        ``register_kw`` goes to :meth:`ModelRegistry.register`
        (``warmup_shape``, ``latency_slo_ms``, ``generate``, ...).
        Returns the new versions."""
        versions = []
        for r in self.replicas:
            m = model
            if callable(m) and not hasattr(m, "output") \
                    and not hasattr(m, "_forward"):
                m = m()
            elif isinstance(m, (str, Path)):
                m = str(m)
            versions.append(r.registry.register(name, m, **register_kw))
        telemetry.counter(
            "dl4j_serving_rollouts_total",
            "fleet-wide warm-then-drain rollouts completed per model (every "
            "replica re-registered in turn, each warmed before its live "
            "pointer flipped)").inc(model=name)
        return versions

    # ------------------------------------------------------------------
    def _pick(self, exclude=()) -> Optional[Replica]:
        """The healthy replica with the fewest outstanding requests."""
        alive = [r for r in self.replicas
                 if r.healthy and r not in exclude]
        if not alive:
            return None
        return min(alive, key=lambda r: r.outstanding)

    def _health_loop(self):
        while not self._stopping:
            for r in self.replicas:
                if self._stopping:
                    return
                try:
                    host, port = r.host_port()
                    conn = http.client.HTTPConnection(host, port,
                                                      timeout=2.0)
                    conn.request("GET", "/healthz")
                    resp = conn.getresponse()
                    resp.read()     # closing on unread bytes resets
                    ok = resp.status == 200
                    conn.close()
                except OSError:
                    ok = False
                r.set_healthy(ok)
            self._health_wake.wait(self.health_interval_s)
            self._health_wake.clear()

    # ------------------------------------------------------------------
    def _proxy(self, handler: QuietHandler):
        counted = telemetry.counter(
            "dl4j_serving_router_requests_total",
            "requests dispatched by the router per replica and relayed "
            "HTTP status (replica=none: no replica could take it, 502)")
        # the fleet's ingress: the client's trace id, or a new one; the
        # replica adopts it, so its root span nests in req.route
        tid = tracectx._clean_id(handler.headers.get(tracectx.TRACE_HEADER))
        if tid is None and tracectx.request_trace_enabled():
            tid = tracectx.mint_trace_id()
        handler._trace_id = tid
        t0_wall, t0_mono = time.time(), time.monotonic()

        def route_span(replica: str, status) -> None:
            if tid:
                telemetry.span_at("req.route", t0_wall,
                                  time.monotonic() - t0_mono, trace=tid,
                                  replica=replica, status=str(status))

        body = handler.read_body()
        req_headers = {h: handler.headers[h] for h in _RELAY_REQ
                       if handler.headers.get(h)}
        if tid:
            req_headers[tracectx.TRACE_HEADER] = tid
        tried = []
        while True:
            rep = self._pick(exclude=tried)
            if rep is None:
                counted.inc(replica="none", code="502")
                handler.send_json(
                    {"error": "no healthy replica available"}, 502,
                    {tracectx.TRACE_HEADER: tid} if tid else None)
                route_span("none", 502)
                return
            tried.append(rep)
            rep.begin()
            try:
                host, port = rep.host_port()
                conn = http.client.HTTPConnection(host, port, timeout=120.0)
                conn.request("POST", handler.path, body=body,
                             headers=req_headers)
                resp = conn.getresponse()
                chunked = (resp.getheader("Transfer-Encoding", "")
                           .lower() == "chunked")
                resp_headers = {h: resp.getheader(h) for h in _RELAY_RESP
                                if resp.getheader(h)}
                resp_headers[tracectx.REPLICA_HEADER] = rep.name
                if tid:
                    resp_headers.setdefault(tracectx.TRACE_HEADER, tid)
                status = resp.status
                if chunked:
                    # a token stream: relayed as it comes (no retry past
                    # this point: bytes are out)
                    self._relay_stream(handler, rep, resp, resp_headers,
                                       status, counted)
                    conn.close()
                    route_span(rep.name, status)
                    return
                payload = resp.read()
                conn.close()
            except OSError:
                # connection-level failure: out of rotation until the
                # next good poll; the request retries elsewhere
                rep.set_healthy(False)
                continue
            finally:
                rep.end()
            counted.inc(replica=rep.name, code=str(status))
            ctype = resp_headers.pop("Content-Type", "application/json")
            handler.send_body(payload, ctype, status, headers=resp_headers)
            route_span(rep.name, status)
            return

    def _relay_stream(self, handler, rep, resp, resp_headers, status,
                      counted):
        """Relay a chunked replica response piece by piece: ``http.client``
        de-chunks the replica's side (``read1`` returns what has landed),
        the router re-chunks toward the client. A replica failure
        mid-stream truncates the client's stream; a client disconnect
        stops the relay, and the replica's own disconnect handling frees
        the sequence when its next chunk fails."""
        ctype = resp_headers.pop("Content-Type", "application/x-ndjson")
        counted.inc(replica=rep.name, code=str(status))
        handler.begin_chunks(ctype, status, headers=resp_headers)
        try:
            while True:
                piece = resp.read1(65536)
                if not piece:
                    break
                handler.send_chunk(piece)
        except OSError:
            handler.abort_chunks()
            return
        handler.end_chunks()
