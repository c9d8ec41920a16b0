"""Request flight recorder: the last N served requests as a black box.

Counterpart of ``deeplearning4j_tpu/serving/reqrec.py``. Every completed
request, whatever its verdict (200, a shed 429 or 503, a 504 deadline,
a 499 client disconnect, a 500), appends one record to a bounded ring:
trace id, model, kind, verdict, total milliseconds, the milliseconds of
each phase of its :class:`~deeplearning4j_tpu_torch.common.tracectx.
TraceContext`, and the facts the serving layer noted (queue depth, batch,
occupancy, KV blocks). The ring is dumped as JSONL (a meta line, then a
record a request) plus a chrome trace of the telemetry ring, so the
requests' ``req.*`` span trees ride along, on three triggers:

- a crash: a ``sys.excepthook`` wrapper installed on the first record,
  chained to the hook it replaced, dumping once a process;
- a shed storm: :meth:`RequestRecorder.note_shed` keeps a sliding window
  of sheds; ``DL4J_TORCH_REQREC_SHED_THRESHOLD`` of them within
  ``DL4J_TORCH_REQREC_SHED_WINDOW_S`` dump the ring, at most once per
  ``DL4J_TORCH_REQREC_STORM_COOLDOWN_S``;
- on demand: ``POST /api/reqrec/dump`` on a replica server or the router.

Knobs, read at construction: ``DL4J_TORCH_REQREC`` (default on),
``DL4J_TORCH_REQREC_CAPACITY`` (default 512), ``DL4J_TORCH_REQREC_DIR``
(default ``flightrec``), ``..._SHED_THRESHOLD`` (20), ``..._SHED_WINDOW_S``
(5) and ``..._STORM_COOLDOWN_S`` (60).
"""
from __future__ import annotations

import json
import logging
import os
import sys
import threading
import time
from collections import deque
from typing import List, Optional

from deeplearning4j_tpu_torch.common import telemetry

log = logging.getLogger("deeplearning4j_tpu_torch")

SCHEMA_VERSION = 1


def _dumps_counter() -> telemetry.Counter:
    return telemetry.counter(
        "dl4j_reqrec_dumps_total",
        "request-flight-recorder dumps, by trigger reason "
        "(crash | shed_storm | api)")


def _depth_gauge() -> telemetry.Gauge:
    return telemetry.gauge(
        "dl4j_reqrec_ring_depth",
        "per-request records held in the request flight recorder's ring")


class RequestRecorder:
    """Bounded ring of per-request records with storm and crash dumps."""

    _instance: Optional["RequestRecorder"] = None
    _instance_lock = threading.Lock()

    def __init__(self):
        env = os.environ.get
        self.enabled = env("DL4J_TORCH_REQREC", "1") not in (
            "0", "false", "False")
        self.capacity = max(1, int(env("DL4J_TORCH_REQREC_CAPACITY",
                                       "512")))
        self.dir = env("DL4J_TORCH_REQREC_DIR", "") or "flightrec"
        self.shed_threshold = max(1, int(
            env("DL4J_TORCH_REQREC_SHED_THRESHOLD", "20")))
        self.shed_window_s = float(env("DL4J_TORCH_REQREC_SHED_WINDOW_S",
                                       "5"))
        self.storm_cooldown_s = float(
            env("DL4J_TORCH_REQREC_STORM_COOLDOWN_S", "60"))
        self._ring: "deque[dict]" = deque()
        self._sheds: "deque[float]" = deque()
        self._lock = threading.Lock()
        self._installed = False
        self._prev_excepthook = None
        self._crash_dumped = False
        self._last_storm_dump = -float("inf")
        self._dump_seq = 0

    @classmethod
    def get(cls) -> "RequestRecorder":
        inst = cls._instance
        if inst is not None:
            return inst
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    @classmethod
    def _reset_for_tests(cls):
        """Drop the singleton, putting back the excepthook it wrapped."""
        with cls._instance_lock:
            if cls._instance is not None:
                cls._instance._uninstall()
            cls._instance = None

    # -- the crash hook ----------------------------------------------------
    def _install(self) -> None:
        if self._installed:
            return
        self._installed = True
        self._prev_excepthook = sys.excepthook

        def _hook(tp, val, tb):
            try:
                if not self._crash_dumped:
                    self._crash_dumped = True
                    self.dump("crash", event={"error": repr(val)})
            finally:
                (self._prev_excepthook or sys.__excepthook__)(tp, val, tb)

        sys.excepthook = _hook

    def _uninstall(self) -> None:
        if self._installed and self._prev_excepthook is not None:
            sys.excepthook = self._prev_excepthook
        self._installed = False

    # -- recording ---------------------------------------------------------
    def record(self, ctx, verdict, **extra) -> None:
        """Append one completed request. ``ctx`` is its TraceContext (a
        falsy one, tracing off, records nothing); ``extra`` carries what
        the serving layer knows at completion (queue depth)."""
        if not self.enabled or not ctx:
            return
        if not self._installed:
            self._install()
        rec = {"t": time.time(), "trace_id": ctx.trace_id,
               "model": ctx.model, "kind": ctx.kind,
               "verdict": str(verdict), "total_ms": ctx.elapsed_s() * 1e3,
               "phase_ms": {k: round(v, 3)
                            for k, v in ctx.phase_ms().items()}}
        attrs = dict(getattr(ctx, "attrs", {}) or {})
        attrs.update(extra)
        rec.update({k: v for k, v in attrs.items() if k not in rec})
        with self._lock:
            self._ring.append(rec)
            while len(self._ring) > self.capacity:
                self._ring.popleft()
            depth = len(self._ring)
        if telemetry.enabled():
            _depth_gauge().set(depth)

    def records(self, n: Optional[int] = None) -> List[dict]:
        with self._lock:
            out = list(self._ring)
        return out[-int(n):] if n else out

    # -- shed storms -------------------------------------------------------
    def note_shed(self, model: str, reason: str) -> Optional[str]:
        """Count one shed; when the window crosses the threshold, dump
        (once a cooldown). Returns the dump's path when a storm fired."""
        if not self.enabled:
            return None
        now = time.monotonic()
        with self._lock:
            self._sheds.append(now)
            while self._sheds and self._sheds[0] < now - self.shed_window_s:
                self._sheds.popleft()
            storm = (len(self._sheds) >= self.shed_threshold
                     and now - self._last_storm_dump
                     >= self.storm_cooldown_s)
            if storm:
                self._last_storm_dump = now
                n_sheds = len(self._sheds)
        if not storm:
            return None
        return self.dump("shed_storm", event={
            "model": model, "reason": reason, "sheds_in_window": n_sheds,
            "window_s": self.shed_window_s})

    # -- dumping -----------------------------------------------------------
    def dump(self, reason: str, event: Optional[dict] = None
             ) -> Optional[str]:
        """Write the ring as ``reqrec_<pid>_<reason>_<seq>.jsonl`` (a meta
        line, then one record a request) and the telemetry ring as
        ``....trace.json`` beside it; returns the JSONL path (None when
        the recorder is off or the write failed)."""
        if not self.enabled:
            return None
        with self._lock:
            ring = list(self._ring)
            self._dump_seq += 1
            seq = self._dump_seq
        base = os.path.join(self.dir,
                            f"reqrec_{os.getpid()}_{reason}_{seq}")
        path = base + ".jsonl"
        try:
            os.makedirs(self.dir, exist_ok=True)
            with open(path, "w") as f:
                f.write(json.dumps({
                    "record": "meta", "schema_version": SCHEMA_VERSION,
                    "reason": reason, "time": time.time(),
                    "pid": os.getpid(), "n_requests": len(ring),
                    "ring_capacity": self.capacity, "event": event}) + "\n")
                for rec in ring:
                    f.write(json.dumps(rec) + "\n")
            trace = telemetry.export_chrome_trace(base + ".trace.json")
        except Exception as e:      # noqa: BLE001  a dump is best effort
            log.warning("request recorder dump failed: %r", e)
            return None
        if telemetry.enabled():
            _dumps_counter().inc(reason=reason)
        log.warning("request recorder: dumped %d request records to %s "
                    "(+ %s) reason=%s", len(ring), path, trace, reason)
        return path


telemetry.on_reset(RequestRecorder._reset_for_tests)


def get() -> RequestRecorder:
    return RequestRecorder.get()
