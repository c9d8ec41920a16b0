"""Metrics registry and one-timeline tracing.

Counterpart of ``deeplearning4j_tpu/common/telemetry.py`` (its metric
and trace core and the fit funnels' step span; the metrics listener
needs the dashboard's stats storage, ROADMAP item 14):

- :class:`MetricsRegistry`: one process-wide, thread-safe registry of
  labelled :class:`Counter`, :class:`Gauge` and :class:`Histogram`
  metrics, rendered as the Prometheus text page that ``/metrics``
  serves, and folded into JSON by :meth:`MetricsRegistry.snapshot` /
  :meth:`MetricsRegistry.summary`. Hot paths pre-resolve a label set
  with ``bind``. A histogram series keeps its latest exemplar (a trace
  id behind the aggregate, :meth:`Histogram.observe_with_exemplar`) and
  estimates quantiles from its buckets (:meth:`Histogram.quantile`).
- :func:`span` / :func:`span_at` / :func:`instant`: chrome-trace "X" and
  "i" events in one bounded ring (:func:`trace_events`), written by
  :func:`export_chrome_trace`; :func:`merge_chrome_traces` and
  :func:`merge_host_traces` fold several trace files into one timeline.
- :func:`step_span`: the one instrumentation point of every fit
  funnel: the ``dl4j_train_step_seconds{model}`` histogram and a
  ``train_step`` trace span; :func:`observe_feed_stall`: time the step
  loop waited on its input (``dl4j_feed_stall_seconds{source}``, and the
  step breakdown's ``data_wait``, ``common/stepstats.py``).
- :func:`on_reset`: modules with process-wide singletons of their own
  (the SLO tracker, the request recorder, the trace-context gate, the
  access-log configuration) register a reset hook that
  :meth:`MetricsRegistry._reset_for_tests` runs.

``DL4J_TORCH_TELEMETRY=0`` turns recording off: every record call is
then one dictionary lookup. ``DL4J_TORCH_TELEMETRY_MAX_EVENTS`` sizes the
trace ring (default 200000).
"""
from __future__ import annotations

import gzip
import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence, Tuple

from deeplearning4j_tpu_torch.common.environment import Environment

#: latency buckets (seconds), from counter overhead to long compiles
DEFAULT_BUCKETS = (1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4,
                   1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
                   0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)

#: buckets for 0..1 ratios (batch occupancy)
RATIO_BUCKETS = (0.1, 0.25, 0.5, 0.75, 0.9, 1.0)

#: chrome-trace events kept by default; older ones are evicted
MAX_TRACE_EVENTS = 200_000

_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: dict) -> _LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _render_labels(key: _LabelKey, extra: str = "") -> str:
    parts = [f'{k}="{v}"' for k, v in key]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _snapshot_key(key: _LabelKey) -> str:
    return ";".join(f"{k}={v}" for k, v in key)


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str, state: dict):
        self.name = name
        self.help = help
        self._state = state        # {'on': bool}, shared with registry
        self._lock = threading.Lock()
        self._series: Dict[_LabelKey, object] = {}

    def _clear(self) -> None:
        with self._lock:
            self._series = {}


class _Scalar(_Metric):
    """A number per label set (counters and gauges)."""

    def _add(self, key: _LabelKey, amount: float) -> None:
        with self._lock:
            self._series[key] = self._series.get(key, 0) + amount

    def inc(self, amount: float = 1, **labels) -> None:
        if self._state["on"]:
            self._add(_label_key(labels), amount)

    def value(self, **labels) -> float:
        return self._series.get(_label_key(labels), 0)

    def _render(self) -> List[str]:
        return [f"{self.name}{_render_labels(k)} {v:g}"
                for k, v in sorted(self._series.items())]

    def _snapshot(self) -> dict:
        return {_snapshot_key(k): v for k, v in self._series.items()}


class Counter(_Scalar):
    kind = "counter"

    def bind(self, **labels) -> "_BoundCounter":
        """Pre-resolve a label set for a hot path."""
        return _BoundCounter(self, _label_key(labels))


class Gauge(_Scalar):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        if not self._state["on"]:
            return
        with self._lock:
            self._series[_label_key(labels)] = value

    def dec(self, amount: float = 1, **labels) -> None:
        self.inc(-amount, **labels)


class _HistSeries:
    __slots__ = ("counts", "sum", "count", "exemplar")

    def __init__(self, n_buckets: int):
        self.counts = [0] * (n_buckets + 1)     # last slot = +Inf
        self.sum = 0.0
        self.count = 0
        #: latest (value, {label: value}, unix time) exemplar
        self.exemplar: Optional[Tuple[float, dict, float]] = None


class Histogram(_Metric):
    """Fixed-bucket histogram, rendered cumulatively with ``le``; the
    latest exemplar of a series rides its +Inf bucket line in
    OpenMetrics form."""

    kind = "histogram"

    def __init__(self, name, help, state,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, state)
        self.buckets = tuple(sorted(buckets))

    def observe(self, value: float, **labels) -> None:
        if self._state["on"]:
            self._observe_key(_label_key(labels), value)

    def observe_with_exemplar(self, value: float, exemplar: dict,
                              **labels) -> None:
        """Observe ``value`` and keep ``exemplar`` (e.g. ``{"trace_id":
        ...}``) as the series' latest, so a slow bucket names a request
        whose timeline can be opened."""
        if self._state["on"]:
            self._observe_key(_label_key(labels), value,
                              exemplar=dict(exemplar))

    def _observe_key(self, key: _LabelKey, value: float,
                     exemplar: Optional[dict] = None) -> None:
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = _HistSeries(len(self.buckets))
            i = 0
            for b in self.buckets:
                if value <= b:
                    break
                i += 1
            s.counts[i] += 1
            s.sum += value
            s.count += 1
            if exemplar is not None:
                s.exemplar = (float(value), exemplar, time.time())

    def exemplar_of(self, **labels) -> Optional[dict]:
        """The latest exemplar of a series as ``{"value", "labels",
        "ts"}``; None before the first one."""
        s = self._series.get(_label_key(labels))
        if s is None or s.exemplar is None:
            return None
        value, ex_labels, ts = s.exemplar
        return {"value": value, "labels": dict(ex_labels), "ts": ts}

    def bind(self, **labels) -> "_BoundHistogram":
        """Pre-resolve a label set for a hot path."""
        return _BoundHistogram(self, _label_key(labels))

    def quantile(self, q: float, **labels) -> float:
        """The ``q``-quantile (0..1) estimated from the cumulative bucket
        counts (``histogram_quantile``: linear inside the bucket that
        holds it, +Inf observations clamp to the top finite edge). NaN
        for a series with no observation."""
        s = self._series.get(_label_key(labels))
        if s is None or s.count == 0:
            return float("nan")
        target = q * s.count
        cum, lo = 0.0, 0.0
        for edge, c in zip(self.buckets, s.counts):
            if c and cum + c >= target:
                return lo + (edge - lo) * (target - cum) / c
            cum += c
            lo = edge
        return self.buckets[-1]

    def count_of(self, **labels) -> int:
        s = self._series.get(_label_key(labels))
        return s.count if s else 0

    def sum_of(self, **labels) -> float:
        s = self._series.get(_label_key(labels))
        return s.sum if s else 0.0

    def _render(self) -> List[str]:
        out = []
        for key, s in sorted(self._series.items()):
            cum = 0
            for b, c in zip(self.buckets, s.counts):
                cum += c
                le = 'le="%g"' % b
                out.append(f"{self.name}_bucket"
                           f"{_render_labels(key, le)} {cum}")
            inf = 'le="+Inf"'
            line = f"{self.name}_bucket{_render_labels(key, inf)} {s.count}"
            if s.exemplar is not None:
                value, ex_labels, ts = s.exemplar
                ex = ",".join(f'{k}="{v}"'
                              for k, v in sorted(ex_labels.items()))
                line += f" # {{{ex}}} {value:g} {ts:.3f}"
            out.append(line)
            out.append(f"{self.name}_sum{_render_labels(key)} {s.sum:g}")
            out.append(f"{self.name}_count{_render_labels(key)} "
                       f"{s.count}")
        return out

    def _snapshot(self) -> dict:
        return {_snapshot_key(k): {
                    "count": s.count, "sum": s.sum,
                    "mean": s.sum / s.count if s.count else 0.0}
                for k, s in self._series.items()}


class _BoundHistogram:
    __slots__ = ("_h", "_key")

    def __init__(self, h: Histogram, key: _LabelKey):
        self._h = h
        self._key = key

    def observe(self, value: float) -> None:
        if self._h._state["on"]:
            self._h._observe_key(self._key, value)


class _BoundCounter:
    __slots__ = ("_c", "_key")

    def __init__(self, c: Counter, key: _LabelKey):
        self._c = c
        self._key = key

    def inc(self, amount: float = 1) -> None:
        if self._c._state["on"]:
            self._c._add(self._key, amount)


class MetricsRegistry:
    """Process-wide, thread-safe registry. Registration is idempotent
    by name and raises on a kind mismatch."""

    _instance: Optional["MetricsRegistry"] = None
    _instance_lock = threading.Lock()

    def __init__(self, enabled: Optional[bool] = None):
        if enabled is None:
            enabled = Environment.get().telemetry
        self._state = {"on": bool(enabled)}
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    @classmethod
    def get(cls) -> "MetricsRegistry":
        inst = cls._instance
        if inst is not None:
            return inst
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    @classmethod
    def _reset_for_tests(cls):
        """A clean panel: every series emptied, the gate back at the
        environment's setting, the trace ring cleared and every
        :func:`on_reset` hook run. The metric objects stay registered, so
        modules that hold one keep recording into the page ``/metrics``
        renders."""
        reg = cls.get()
        reg._state["on"] = bool(Environment.get().telemetry)
        with reg._lock:
            metrics = list(reg._metrics.values())
        for m in metrics:
            m._clear()
        _trace_buffer.clear()
        for hook in list(_reset_hooks):
            hook()

    @property
    def enabled(self) -> bool:
        return self._state["on"]

    def set_enabled(self, on: bool) -> None:
        self._state["on"] = bool(on)

    def _register(self, cls, name, help, **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if type(m) is not cls:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{m.kind}, not {cls.kind}")
                return m
            m = cls(name, help, self._state, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._register(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._register(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS
                  ) -> Histogram:
        return self._register(Histogram, name, help, buckets=buckets)

    def render_prometheus(self) -> str:
        """Prometheus text exposition format (0.0.4)."""
        lines: List[str] = []
        with self._lock:
            metrics = sorted(self._metrics.values(),
                             key=lambda m: m.name)
        for m in metrics:
            lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            lines.extend(m._render())
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """``{name: {label key: value or histogram summary}}``,
        JSON-serialisable."""
        with self._lock:
            metrics = list(self._metrics.values())
        return {m.name: m._snapshot() for m in metrics}

    def summary(self) -> dict:
        """:meth:`snapshot` without the metrics that recorded nothing."""
        return {k: v for k, v in self.snapshot().items() if v}


def counter(name: str, help: str = "") -> Counter:
    return MetricsRegistry.get().counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return MetricsRegistry.get().gauge(name, help)


def histogram(name: str, help: str = "",
              buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
    return MetricsRegistry.get().histogram(name, help, buckets=buckets)


def enabled() -> bool:
    return MetricsRegistry.get().enabled


#: zero-argument callables run by MetricsRegistry._reset_for_tests
_reset_hooks: List = []


def on_reset(hook) -> None:
    """Run ``hook`` on every ``MetricsRegistry._reset_for_tests()``
    (registered once however often this is called)."""
    if hook not in _reset_hooks:
        _reset_hooks.append(hook)


# ---------------------------------------------------------------------------
# one timeline: a bounded ring of chrome-trace events
class _TraceBuffer:
    """A ring: past ``max_events`` the oldest events are evicted (counted
    in ``dropped``, in the exported metadata and in
    ``dl4j_trace_events_dropped_total``), so a long run keeps its most
    recent window at bounded host memory."""

    def __init__(self, max_events: int = MAX_TRACE_EVENTS):
        self.max_events = int(os.environ.get(
            "DL4J_TORCH_TELEMETRY_MAX_EVENTS", str(max_events)))
        self._lock = threading.Lock()
        self.events: "deque[dict]" = deque()
        self.dropped = 0

    def append(self, ev: dict) -> None:
        n_evicted = 0
        with self._lock:
            self.events.append(ev)
            while len(self.events) > self.max_events:
                self.events.popleft()
                self.dropped += 1
                n_evicted += 1
        if n_evicted:
            counter("dl4j_trace_events_dropped_total",
                    "chrome-trace ring evictions (oldest events displaced "
                    "once the ring is full)").inc(n_evicted)

    def clear(self) -> None:
        with self._lock:
            self.events = deque()
            self.dropped = 0


_trace_buffer = _TraceBuffer()


def _event(name: str, ph: str, ts_s: float, attrs: dict, **extra) -> dict:
    return {"name": name, "ph": ph, "pid": os.getpid(),
            "tid": threading.get_ident() & 0xFFFF,
            "ts": int(ts_s * 1e6), **extra, "args": attrs}


@contextmanager
def span(name: str, **attrs):
    """Record a wall-clock chrome-trace span for the with-block on this
    thread's row. Host time: a span around device work measures the
    device only where the block ends in a synchronising call."""
    if not enabled():
        yield
        return
    t0 = time.time()
    try:
        yield
    finally:
        _trace_buffer.append(_event(name, "X", t0, attrs,
                                    dur=int((time.time() - t0) * 1e6)))


def instant(name: str, **attrs) -> None:
    """A zero-duration chrome-trace event (a when without a how long)."""
    if enabled():
        _trace_buffer.append(_event(name, "i", time.time(), attrs, s="p"))


def span_at(name: str, t_wall: float, dur_s: float, **attrs) -> None:
    """A span with an explicit start (unix seconds) and duration: for an
    interval measured on another thread (a batcher flush attributing
    queue wait back to each request)."""
    if enabled():
        _trace_buffer.append(_event(name, "X", t_wall, attrs,
                                    dur=max(0, int(dur_s * 1e6))))


def trace_events() -> List[dict]:
    with _trace_buffer._lock:
        return list(_trace_buffer.events)


def _write_trace(path: str, events: List[dict], meta: dict) -> str:
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                   "metadata": meta}, f)
    return path


def export_chrome_trace(path: str, metadata: Optional[dict] = None) -> str:
    """Write the ring as chrome://tracing JSON; ``metadata`` keys (a
    host name, a clock offset) merge into the document's metadata, where
    :func:`merge_host_traces` reads them back."""
    with _trace_buffer._lock:
        events = list(_trace_buffer.events)
        meta = {"dropped_events": _trace_buffer.dropped}
    meta.update(metadata or {})
    return _write_trace(path, events, meta)


def _load_trace(path: str) -> dict:
    op = gzip.open if str(path).endswith(".gz") else open
    with op(path, "rt") as f:
        doc = json.load(f)
    return doc if isinstance(doc, dict) else {"traceEvents": doc}


def merge_chrome_traces(output_path: str, *paths: str) -> str:
    """Concatenate the events of several chrome-trace files (this
    module's, or a profiler's ``.json.gz``) into one file; events share
    the epoch-microsecond clock, pids and tids keep sources apart."""
    events: List[dict] = []
    meta: dict = {}
    for p in paths:
        doc = _load_trace(p)
        events.extend(doc.get("traceEvents", []))
        meta.update(doc.get("metadata", {}))
    return _write_trace(output_path, events, meta)


def merge_host_traces(output_path: str, *sources) -> str:
    """Fold per-host trace files into one clock-corrected timeline.

    Each source is a path or ``{"path", "host", "clock_offset_s"}``;
    ``clock_offset_s`` is how far that host's clock runs ahead of the
    reference clock (default: the file's own metadata, else 0), and each
    of its timestamps moves back by it. Pids are remapped per source and
    each row is labelled with its host."""
    events: List[dict] = []
    meta: dict = {"hosts": []}
    for idx, src in enumerate(sources):
        if isinstance(src, (str, os.PathLike)):
            src = {"path": src}
        doc = _load_trace(src["path"])
        doc_meta = doc.get("metadata", {}) or {}
        host = src.get("host") or doc_meta.get("host") or f"host{idx}"
        offset_s = src.get("clock_offset_s")
        if offset_s is None:
            offset_s = doc_meta.get("clock_offset_s", 0.0)
        shift_us = int(float(offset_s) * 1e6)
        pid_map: Dict[object, int] = {}
        for ev in doc.get("traceEvents", []):
            ev = dict(ev)
            pid = pid_map.get(ev.get("pid"))
            if pid is None:
                pid = pid_map[ev.get("pid")] = 1000 * (idx + 1) \
                    + len(pid_map)
            ev["pid"] = pid
            if "ts" in ev:
                ev["ts"] = int(ev["ts"]) - shift_us
            events.append(ev)
        for pid in sorted(pid_map.values()):
            events.append({"name": "process_name", "ph": "M", "pid": pid,
                           "tid": 0, "args": {"name": host}})
        meta["hosts"].append({"host": host,
                              "clock_offset_s": float(offset_s),
                              "events": len(doc.get("traceEvents", []))})
    return _write_trace(output_path, events, meta)


_STEP_HELP = ("host-observed train-step wall time: dispatch plus "
              "whatever sync the funnel performs (seconds)")


class _StepSpan:
    """The fit-funnel instrumentation point: times the with-block into
    the ``dl4j_train_step_seconds`` histogram (labelled by model class)
    and records a ``train_step`` chrome-trace span, one call site per
    funnel. The clock always runs (the flight recorder reads
    ``duration`` whatever the metrics gate); slots and a bound
    histogram cached per model keep it cheap once a step."""

    __slots__ = ("model", "attrs", "_bound", "t0", "p0", "duration")

    def __init__(self, model: str, attrs: dict):
        self.model = model
        self.attrs = attrs

    def __enter__(self):
        self.duration = 0.0
        self.p0 = time.perf_counter()
        reg = MetricsRegistry.get()
        if not reg._state["on"]:
            self._bound = None
            return self
        cache = reg.__dict__.setdefault("_step_bound", {})
        b = cache.get(self.model)
        if b is None:
            b = cache[self.model] = histogram(
                "dl4j_train_step_seconds",
                _STEP_HELP).bind(model=self.model)
        self._bound = b
        self.t0 = time.time()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.p0
        self.duration = dt
        if self._bound is None:
            return False
        self._bound.observe(dt)
        _trace_buffer.append(_event("train_step", "X", self.t0,
                                    {"model": self.model, **self.attrs},
                                    dur=int(dt * 1e6)))
        return False


def step_span(model: str, **attrs) -> _StepSpan:
    """``with step_span("MultiLayerNetwork") as sp:`` around one train
    step; ``sp.duration`` is its wall seconds after the block."""
    return _StepSpan(model, attrs)


def observe_feed_stall(seconds: float, source: str) -> None:
    """Time a consumer spent blocked waiting for its next batch:
    non-zero buckets mean the input pipeline, not the device, sets the
    pace. Also the step breakdown's ``data_wait``."""
    histogram("dl4j_feed_stall_seconds",
              "time the step loop waited on the input pipeline for "
              "its next batch (seconds)").observe(seconds, source=source)
    # lazy import: stepstats imports this module
    from deeplearning4j_tpu_torch.common import stepstats
    stepstats.note_data_wait(seconds, source)
