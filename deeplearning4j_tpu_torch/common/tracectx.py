"""Request-scoped trace context for the serving path.

Counterpart of ``deeplearning4j_tpu/common/tracectx.py``: a trace id is
minted at ingress (or adopted from an incoming ``X-Dl4j-Trace-Id``
header) and a :class:`TraceContext` rides the request through
``ServingRouter`` -> ``InferenceServer`` -> ``AdmissionController`` ->
``ServingBatcher`` / ``DecodeEngine``. Each hop stamps phase spans
(``req.admit``, ``req.queue``, ``req.batch_wait``, ``req.device``,
``req.serialize``, ``req.stream``, and the ``req.ttft`` /
``req.inter_token`` instants of a generate) into the telemetry ring with
the trace id in ``args``, so one request renders as one connected tree
under its ``request`` root span.

Two ways to carry it:

- ambient (:func:`bind` / :func:`current`): a ``contextvars`` slot for
  code on the request's own handler thread. Handler threads are reused
  across keep-alive requests, so ``bind`` always restores the previous
  value;
- explicit: a hop onto another thread (the batcher's flush worker, the
  decode engine's loop) carries the context object itself and uses
  :meth:`TraceContext.phase_at` to put the interval it measured onto
  the request's timeline.

Phase intervals are measured on ``time.monotonic`` and placed on the
chrome-trace epoch axis through the context's (wall, mono) anchor, read
together at ingress, so spans from several threads line up.

Gate: ``DL4J_TORCH_REQUEST_TRACE`` (default on, and off whenever
telemetry is off). Off, :func:`start` returns the falsy :data:`NULL`
context whose methods do nothing, so call sites keep one shape.
"""
from __future__ import annotations

import contextvars
import os
import threading
import time
import uuid
from contextlib import contextmanager
from typing import List, Optional, Tuple

from deeplearning4j_tpu_torch.common import telemetry

#: the end-to-end trace id header (request and response)
TRACE_HEADER = "X-Dl4j-Trace-Id"
#: set by the router: the replica that served the request
REPLICA_HEADER = "X-Dl4j-Replica"

#: the phases of a request (span name ``req.<phase>``)
PHASES = ("admit", "queue", "batch_wait", "device", "serialize", "stream")

_MAX_ID_LEN = 64

_enabled_override: Optional[bool] = None

_current: "contextvars.ContextVar[Optional[TraceContext]]" = \
    contextvars.ContextVar("dl4j_torch_trace_ctx", default=None)


def request_trace_enabled() -> bool:
    """``DL4J_TORCH_REQUEST_TRACE``, and telemetry's own gate: a span
    with no ring to land in is pure cost."""
    if not telemetry.enabled():
        return False
    if _enabled_override is not None:
        return _enabled_override
    return os.environ.get("DL4J_TORCH_REQUEST_TRACE", "1") not in (
        "0", "false", "False", "no")


def set_enabled(on: Optional[bool]) -> None:
    """Override the environment gate in this process (None restores
    it)."""
    global _enabled_override
    _enabled_override = None if on is None else bool(on)


def _reset_for_tests() -> None:
    set_enabled(None)


telemetry.on_reset(_reset_for_tests)


def mint_trace_id() -> str:
    return uuid.uuid4().hex[:16]


def _clean_id(header_value: Optional[str]) -> Optional[str]:
    """An adopted trace id, sanitised: bounded, no whitespace, only
    letters, digits and ``-_.``, so a hostile header cannot reach logs
    or traces."""
    if not header_value:
        return None
    tid = header_value.strip()
    if not tid or len(tid) > _MAX_ID_LEN:
        return None
    if not all(c.isalnum() or c in "-_." for c in tid):
        return None
    return tid


class TraceContext:
    """One request's identity and timeline. Truthy (the disabled path
    gets the falsy :data:`NULL`); ``phase_at`` and ``note`` may be called
    from several threads."""

    __slots__ = ("trace_id", "model", "kind", "t0_wall", "t0_mono",
                 "phases", "attrs", "verdict", "closed", "_lock")

    def __init__(self, model: str, kind: str,
                 trace_id: Optional[str] = None):
        self.trace_id = trace_id or mint_trace_id()
        self.model = model
        self.kind = kind                    # "predict" | "generate"
        self.t0_wall = time.time()
        self.t0_mono = time.monotonic()
        #: (phase, start on the monotonic clock, seconds)
        self.phases: List[Tuple[str, float, float]] = []
        self.attrs: dict = {}
        self.verdict: Optional[str] = None
        self.closed = False
        self._lock = threading.Lock()

    def __bool__(self) -> bool:
        return True

    def wall(self, mono_t: float) -> float:
        """A ``time.monotonic`` instant on this request's wall clock."""
        return self.t0_wall + (mono_t - self.t0_mono)

    @contextmanager
    def phase(self, name: str):
        """Time the with-block as phase ``name`` of this request."""
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.phase_at(name, t0, time.monotonic())

    def phase_at(self, name: str, mono_t0: float, mono_t1: float) -> None:
        """Attribute a measured ``[mono_t0, mono_t1]`` interval to this
        request as phase ``name`` (from any thread)."""
        dur = max(0.0, mono_t1 - mono_t0)
        with self._lock:
            self.phases.append((name, mono_t0, dur))
        telemetry.span_at(f"req.{name}", self.wall(mono_t0), dur,
                          trace=self.trace_id, model=self.model)

    def instant(self, name: str, **attrs) -> None:
        telemetry.instant(f"req.{name}", trace=self.trace_id,
                          model=self.model, **attrs)

    def note(self, **attrs) -> None:
        """Attach request facts (batch, occupancy, KV blocks): they land
        in the root span's args and the request recorder's record."""
        with self._lock:
            self.attrs.update(attrs)

    def elapsed_s(self) -> float:
        return time.monotonic() - self.t0_mono

    def finish(self, verdict) -> float:
        """Close the request: the ``request`` root span from ingress to
        now, with the verdict (HTTP status) in its args. Idempotent.
        Returns the total seconds (0 when already closed)."""
        with self._lock:
            if self.closed:
                return 0.0
            self.closed = True
            self.verdict = str(verdict)
            attrs = dict(self.attrs)
        dur = self.elapsed_s()
        telemetry.span_at("request", self.t0_wall, dur,
                          trace=self.trace_id, model=self.model,
                          kind=self.kind, verdict=self.verdict, **attrs)
        return dur

    def phase_ms(self) -> dict:
        """``{phase: total milliseconds}``; a repeated phase sums."""
        out: dict = {}
        with self._lock:
            for name, _, dur in self.phases:
                out[name] = out.get(name, 0.0) + dur * 1e3
        return out


class _NullContext:
    """The falsy stand-in while request tracing is off."""

    __slots__ = ()
    trace_id = None
    model = None
    kind = None
    verdict = None
    closed = True

    def __bool__(self) -> bool:
        return False

    @contextmanager
    def phase(self, name: str):
        yield

    def phase_at(self, *a, **kw) -> None:
        pass

    def instant(self, *a, **kw) -> None:
        pass

    def note(self, **kw) -> None:
        pass

    def finish(self, verdict) -> float:
        return 0.0

    def phase_ms(self) -> dict:
        return {}

    def wall(self, mono_t: float) -> float:
        return mono_t

    def elapsed_s(self) -> float:
        return 0.0


NULL = _NullContext()


def start(model: str, kind: str, incoming_header: Optional[str] = None):
    """The ingress call: a new context, adopting the id of a well-formed
    ``X-Dl4j-Trace-Id`` header; :data:`NULL` while the gate is off."""
    if not request_trace_enabled():
        return NULL
    return TraceContext(model, kind, trace_id=_clean_id(incoming_header))


def current():
    """The context bound to this thread of control (None outside a
    request)."""
    return _current.get()


@contextmanager
def bind(ctx):
    """Make ``ctx`` the ambient context for the with-block; the previous
    value always comes back, so a reused handler thread never leaks one
    request's context into the next."""
    token = _current.set(ctx if ctx else None)
    try:
        yield ctx
    finally:
        _current.reset(token)
