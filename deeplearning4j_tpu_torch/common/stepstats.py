"""The training observatory's step breakdown and cross-worker view.

Counterpart of ``deeplearning4j_tpu/common/stepstats.py``, with its
names, metric names and record schemas:

- :class:`StepStats`: a process-wide collector the fit funnels close
  once a train step (``diagnostics.after_step`` / ``record_step``).
  Instrument sites route into it (``telemetry.observe_feed_stall`` ->
  ``data_wait``, ``diagnostics.collective_span`` -> ``collective`` /
  ``updater`` / ``host_sync``), and the close computes the ``compute``
  residual, so every breakdown's phases sum to the observed step wall
  time. Surfaced as ``dl4j_step_phase_seconds{phase}`` and as a
  ``phases`` key on each flight-recorder record.
- :class:`StepStatsAggregator` / :class:`StepStatsClient`: the
  cross-worker sidecar. Each worker ships its breakdowns to the leader
  over a line-JSON TCP socket beside the gradient exchange; the connect
  handshake is an NTP-like timestamp exchange (each worker learns its
  clock offset); the leader merges per step, gauges each worker's skew
  (``dl4j_straggler_skew_seconds``) and trips straggler detection
  (``dl4j_straggler_trips_total``) when one worker exceeds
  ``DL4J_TORCH_STRAGGLER_FACTOR`` x the step mean.
- :func:`scaling_block`: per-card throughput and efficiency at each
  mesh size against the smallest, with the observatory's skew.
- :class:`ProfileCapture`: one bounded on-demand capture at a time,
  finalized after N closed steps (or a wall-clock expiry): the
  observatory's chrome trace plus a ``torch.profiler`` chrome trace of
  the same steps (host ops, CUDA runtime calls and kernels), merged.

Gate: ``DL4J_TORCH_STEPSTATS`` (default on; it records only while
telemetry is on).
"""
from __future__ import annotations

import json
import logging
import os
import socket
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional

from deeplearning4j_tpu_torch.common import telemetry
from deeplearning4j_tpu_torch.common.environment import Environment

log = logging.getLogger("deeplearning4j_tpu_torch")

#: the step-time decomposition every breakdown carries, in display
#: order.  ``compute`` is the residual of the step span after the
#: in-step phases; ``data_wait`` / ``checkpoint_stall`` / ``host_sync``
#: accrue BETWEEN step spans and extend the total beyond it.
PHASES = ("data_wait", "compute", "collective", "updater",
          "host_sync", "checkpoint_stall", "pipeline")

#: collective kinds → breakdown phase.  ``update_exchange`` is special:
#: its span WRAPS the fused train step, so only its excess over the
#: wrapped step is collective time (see :meth:`StepStats.note_collective`).
_COLLECTIVE_PHASE = {
    "update_exchange": "collective",
    "global_assembly": "host_sync",
    "state_placement": "updater",
}

_PHASE_HELP = ("per-step time decomposition: seconds attributed to "
               "each phase (data_wait | compute | collective | updater "
               "| host_sync | checkpoint_stall | pipeline) of one "
               "train-step dispatch; ``pipeline`` is the measured "
               "schedule bubble (stage idle time while peers compute)")


class StepStats:
    """Process-wide per-step breakdown collector (thread-safe).

    Instrument sites ``note_*`` into the pending accumulators; the fit
    funnel's ``diagnostics.after_step`` closes the step, which snapshots
    the accumulators into a :class:`StepBreakdown`-shaped dict, appends
    it to a bounded ring, observes ``dl4j_step_phase_seconds``, and
    feeds every registered sink (cross-host client, profile capture).
    """

    _instance: Optional["StepStats"] = None
    _instance_lock = threading.Lock()

    def __init__(self):
        self._gate = Environment.get().stepstats
        self._lock = threading.Lock()
        self._ring: "deque[dict]" = deque(
            maxlen=int(os.environ.get("DL4J_TORCH_STEPSTATS_STEPS",
                                      "1024")))
        # pending accumulators since the last closed step
        self._in_step: Dict[str, float] = {}       # subtract from compute
        self._out_step: Dict[str, float] = {}      # extend the total
        self._collectives: Dict[str, float] = {}
        #: step seconds closed but not yet consumed by an
        #: ``update_exchange`` span (the span wraps the step)
        self._unconsumed_step_s = 0.0
        self._last: Optional[dict] = None
        # running totals for summary()
        self._n_steps = 0
        self._totals = {p: 0.0 for p in PHASES}
        self._total_step_s = 0.0
        self._total_s = 0.0
        self._sinks: List[Callable[[dict], None]] = []
        self._worker = {"worker": 0, "host": socket.gethostname(),
                        "n_workers": 1}
        self._bound_hists: Dict[str, object] = {}

    @classmethod
    def get(cls) -> "StepStats":
        inst = cls._instance
        if inst is not None:
            return inst
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    @classmethod
    def _reset_for_tests(cls):
        with cls._instance_lock:
            cls._instance = None

    # -- gating --------------------------------------------------------
    def enabled(self) -> bool:
        return self._gate and telemetry.enabled()

    def set_enabled(self, on: bool) -> None:
        self._gate = bool(on)

    # -- worker identity (cross-host shipping labels) ------------------
    def set_worker(self, worker: int, n_workers: int,
                   host: Optional[str] = None) -> None:
        self._worker = {"worker": int(worker),
                        "host": host or socket.gethostname(),
                        "n_workers": int(n_workers)}

    def worker_label(self) -> dict:
        """The label breakdowns carry (``worker``, ``host``,
        ``n_workers``): ``set_worker(**label)`` puts it back."""
        return dict(self._worker)

    def add_sink(self, fn: Callable[[dict], None]) -> None:
        with self._lock:
            if fn not in self._sinks:
                self._sinks.append(fn)

    def remove_sink(self, fn: Callable[[dict], None]) -> None:
        with self._lock:
            if fn in self._sinks:
                self._sinks.remove(fn)

    # -- instrument-site hooks -----------------------------------------
    def note_data_wait(self, seconds: float, source: str = "") -> None:
        """Feed-stall time the step loop spent blocked on its next
        batch (routed from ``telemetry.observe_feed_stall``)."""
        if not self.enabled():
            return
        with self._lock:
            self._out_step["data_wait"] = \
                self._out_step.get("data_wait", 0.0) + seconds

    def note_checkpoint_stall(self, seconds: float) -> None:
        """Step-loop-blocking checkpoint time (snapshot + join of the
        previous async write; the whole write when synchronous)."""
        if not self.enabled():
            return
        with self._lock:
            self._out_step["checkpoint_stall"] = \
                self._out_step.get("checkpoint_stall", 0.0) + seconds

    def note_in_step(self, phase: str, seconds: float) -> None:
        """A phase measured INSIDE the step span (e.g. the
        accumulation-window updater apply) — subtracted from the
        ``compute`` residual at close."""
        if not self.enabled():
            return
        with self._lock:
            self._in_step[phase] = self._in_step.get(phase, 0.0) \
                + seconds

    @contextmanager
    def phase(self, name: str):
        """Time the with-block as an in-step phase (also emits a
        ``step.<name>`` trace span)."""
        if not self.enabled():
            yield
            return
        t0 = time.perf_counter()
        with telemetry.span(f"step.{name}"):
            yield
        self.note_in_step(name, time.perf_counter() - t0)

    def note_collective(self, kind: str, seconds: float) -> None:
        """Route one closed ``collective_span`` into the breakdown.

        ``update_exchange`` wraps the fused train step, so the step
        seconds already closed inside it are subtracted and only the
        EXCESS (host dispatch + post-step sync around the fused
        program) lands in the last breakdown's ``collective`` phase;
        every other kind accrues as an out-of-step phase per
        ``_COLLECTIVE_PHASE``."""
        if not self.enabled():
            return
        with self._lock:
            if kind == "update_exchange":
                excess = max(seconds - self._unconsumed_step_s, 0.0)
                self._unconsumed_step_s = 0.0
                self._collectives[kind] = \
                    self._collectives.get(kind, 0.0) + seconds
                if self._last is not None:
                    self._last["phases"]["collective"] += excess
                    self._last["total_seconds"] += excess
                    self._last["collectives"][kind] = \
                        self._last["collectives"].get(kind, 0.0) \
                        + seconds
                    self._collectives.pop(kind, None)
                    self._totals["collective"] += excess
                    self._total_s += excess
                amount = excess
            else:
                phase = _COLLECTIVE_PHASE.get(kind, "collective")
                self._out_step[phase] = \
                    self._out_step.get(phase, 0.0) + seconds
                self._collectives[kind] = \
                    self._collectives.get(kind, 0.0) + seconds
                amount = seconds
        if amount:
            self._observe_phase(
                _COLLECTIVE_PHASE.get(kind, "collective"), amount)

    # -- the per-step close --------------------------------------------
    def close_step(self, model: str, step: int,
                   step_seconds: float) -> Optional[dict]:
        """Snapshot the pending accumulators into one breakdown record
        for the step dispatch that just finished (called from
        ``diagnostics.after_step``/``record_step`` with the
        ``step_span`` duration).  Returns the record, or None when the
        layer is off."""
        if not self.enabled() or step_seconds is None:
            return None
        with self._lock:
            in_step, self._in_step = self._in_step, {}
            out_step, self._out_step = self._out_step, {}
            colls, self._collectives = self._collectives, {}
            compute = max(step_seconds - sum(in_step.values()), 0.0)
            phases = {p: 0.0 for p in PHASES}
            phases["compute"] = compute
            for p, s in in_step.items():
                phases[p] = phases.get(p, 0.0) + s
            for p, s in out_step.items():
                phases[p] = phases.get(p, 0.0) + s
            rec = {
                "step": int(step),
                "model": model,
                "t": time.time(),
                **self._worker,
                "step_seconds": float(step_seconds),
                "total_seconds": float(step_seconds
                                       + sum(out_step.values())),
                "phases": phases,
                "collectives": colls,
            }
            self._ring.append(rec)
            self._last = rec
            self._unconsumed_step_s = min(
                self._unconsumed_step_s + step_seconds, 3600.0)
            self._n_steps += 1
            for p, s in phases.items():
                self._totals[p] += s
            self._total_step_s += step_seconds
            self._total_s += rec["total_seconds"]
            sinks = list(self._sinks)
        # metrics + sinks outside the lock
        self._observe_phase("compute", compute, model=model)
        for p, s in {**in_step, **out_step}.items():
            if s and p not in ("host_sync", "updater", "collective"):
                # collective-kind phases were observed at note time
                self._observe_phase(p, s, model=model)
        for fn in sinks:
            try:
                fn(rec)
            except Exception as e:      # noqa: BLE001 — a dead sink
                log.warning("stepstats sink failed: %r", e)
        return rec

    def _observe_phase(self, phase: str, seconds: float,
                       model: str = "") -> None:
        if not telemetry.enabled():
            return
        h = telemetry.histogram("dl4j_step_phase_seconds", _PHASE_HELP)
        h.observe(seconds, phase=phase)

    # -- reads ---------------------------------------------------------
    def last(self) -> Optional[dict]:
        return self._last

    def records(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    def summary(self) -> dict:
        """The ``step_breakdown`` block: mean seconds
        per phase (summing to ~the mean total step time) and each
        phase's share of the run."""
        with self._lock:
            n = self._n_steps
            if not n:
                return {"steps": 0}
            return {
                "steps": n,
                "mean_step_seconds": self._total_step_s / n,
                "mean_total_seconds": self._total_s / n,
                "phases_mean_seconds": {
                    p: self._totals[p] / n for p in PHASES},
                "phases_pct": {
                    p: round(100.0 * self._totals[p]
                             / max(self._total_s, 1e-12), 2)
                    for p in PHASES},
            }


# ----------------------------------------------------------------------
# module-level conveniences (what instrument sites call)
def collector() -> StepStats:
    return StepStats.get()


def note_data_wait(seconds: float, source: str = "") -> None:
    StepStats.get().note_data_wait(seconds, source)


def note_checkpoint_stall(seconds: float) -> None:
    StepStats.get().note_checkpoint_stall(seconds)


def note_collective(kind: str, seconds: float) -> None:
    StepStats.get().note_collective(kind, seconds)


def close_step(model: str, step: int, span) -> Optional[dict]:
    """Close the current step from a ``telemetry.step_span`` (or any
    object with a ``duration``); None-safe."""
    dur = getattr(span, "duration", None)
    if dur is None:
        return None
    return StepStats.get().close_step(model, step, dur)


# ----------------------------------------------------------------------
# clock sync (NTP-lite): the worker sends t0 on its clock, the leader
# replies its own timestamp, the worker notes t1 on receipt
def estimate_clock_offset(t0_local: float, t_remote: float,
                          t1_local: float) -> float:
    """Seconds the LOCAL clock is ahead of the remote one, assuming a
    symmetric network path: ``offset = (t0+t1)/2 - t_remote``.
    Subtract ``offset`` from local timestamps to express them on the
    remote (leader) clock — what the cross-host trace merge does."""
    return (t0_local + t1_local) / 2.0 - t_remote


class StepStatsAggregator:
    """Leader-side cross-host breakdown merge + straggler detection.

    Listens on a TCP port; each worker's :class:`StepStatsClient`
    connects, performs the clock handshake, then streams one JSON line
    per step breakdown.  When every expected worker has reported a
    step, the step merges: per-worker skew vs the step mean lands in
    ``dl4j_straggler_skew_seconds{worker}``; a worker slower than
    ``trip_factor`` × mean (with the mean above ``min_step_seconds``,
    so microsecond noise cannot trip) increments
    ``dl4j_straggler_trips_total{worker,phase}`` and logs the offending
    host plus the phase that grew the most vs the other workers."""

    def __init__(self, expected_workers: int, *, port: int = 0,
                 host: str = "127.0.0.1",
                 trip_factor: Optional[float] = None,
                 min_step_seconds: Optional[float] = None,
                 history: int = 4096):
        if trip_factor is None:
            trip_factor = Environment.get().straggler_factor
        if min_step_seconds is None:
            min_step_seconds = Environment.get().straggler_min_step
        self.expected_workers = int(expected_workers)
        self.trip_factor = float(trip_factor)
        self.min_step_seconds = float(min_step_seconds)
        self.merged: "deque[dict]" = deque(maxlen=history)
        self.worker_offsets: Dict[int, float] = {}
        self.worker_hosts: Dict[int, str] = {}
        self.trips = 0
        self._steps: Dict[int, Dict[int, dict]] = {}
        self._lock = threading.Lock()
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(16)
        self.port = self._srv.getsockname()[1]
        self._closing = False
        self._threads: List[threading.Thread] = []
        t = threading.Thread(target=self._accept_loop, daemon=True,
                             name="dl4j-obs-accept")
        t.start()
        self._threads.append(t)

    # -- wire ----------------------------------------------------------
    def _accept_loop(self):
        while not self._closing:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True, name="dl4j-obs-conn")
            t.start()
            self._threads.append(t)

    def _serve_conn(self, conn: socket.socket):
        try:
            f = conn.makefile("rwb")
            for raw in f:
                try:
                    msg = json.loads(raw.decode())
                except json.JSONDecodeError:
                    continue
                if "hello" in msg:
                    # clock handshake: reply the leader timestamp
                    h = msg["hello"]
                    with self._lock:
                        self.worker_hosts[int(h.get("worker", -1))] = \
                            str(h.get("host", "?"))
                    f.write(json.dumps(
                        {"t_leader": time.time()}).encode() + b"\n")
                    f.flush()
                elif "offset_s" in msg:
                    with self._lock:
                        self.worker_offsets[int(msg["worker"])] = \
                            float(msg["offset_s"])
                elif "step" in msg:
                    self.ingest(msg)
        except (OSError, ValueError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    # -- merge ---------------------------------------------------------
    def ingest(self, rec: dict) -> Optional[dict]:
        """Fold one worker breakdown in; returns the merged record when
        this report completes its step (also the direct-call path the
        tests and a single-process harness use — no socket needed)."""
        step = int(rec["step"])
        worker = int(rec.get("worker", 0))
        with self._lock:
            bucket = self._steps.setdefault(step, {})
            bucket[worker] = rec
            if len(bucket) < self.expected_workers:
                return None
            del self._steps[step]
        return self._merge(step, bucket)

    def _merge(self, step: int, bucket: Dict[int, dict]) -> dict:
        times = {w: float(r["step_seconds"])
                 for w, r in bucket.items()}
        mean = sum(times.values()) / len(times)
        skew = {w: t - mean for w, t in times.items()}
        worst = max(times, key=times.get)
        max_skew = times[worst] - mean
        tripped = (mean > self.min_step_seconds
                   and times[worst] > self.trip_factor * mean)
        slow_phase = self._slowest_phase(bucket, worst)
        if telemetry.enabled():
            g = telemetry.gauge(
                "dl4j_straggler_skew_seconds",
                "per-worker deviation of step wall time from the "
                "cross-host step mean (signed seconds; the leader "
                "updates every merged step)")
            for w, s in skew.items():
                g.set(s, worker=str(w))
        merged = {
            "step": step,
            "workers": len(bucket),
            "mean_step_seconds": mean,
            "skew_seconds": skew,
            "max_skew_seconds": max_skew,
            "worst_worker": worst,
            "worst_host": bucket[worst].get("host", "?"),
            "worst_phase": slow_phase,
            "tripped": bool(tripped),
        }
        if tripped:
            # `trips` is read by report() from the leader thread while
            # every connection thread can be in here — same lock as
            # the merge bookkeeping
            with self._lock:
                self.trips += 1
            if telemetry.enabled():
                telemetry.counter(
                    "dl4j_straggler_trips_total",
                    "straggler-detector trips: one worker exceeded "
                    "DL4J_TORCH_STRAGGLER_FACTOR x the cross-host step "
                    "mean, by worker and its slowest phase").inc(
                        worker=str(worst), phase=slow_phase)
                telemetry.instant("straggler_trip", step=step,
                                  worker=worst, phase=slow_phase)
            log.warning(
                "straggler: step %d worker %d (%s) took %.4fs vs "
                "%.4fs mean (>%.1fx) — slowest phase: %s",
                step, worst, merged["worst_host"], times[worst],
                mean, self.trip_factor, slow_phase)
        with self._lock:
            self.merged.append(merged)
        return merged

    @staticmethod
    def _slowest_phase(bucket: Dict[int, dict], worst: int) -> str:
        """The phase where the worst worker lost the most time vs the
        mean of the OTHER workers — the observatory's attribution of a
        straggler to collective / input / compute."""
        others = [r for w, r in bucket.items() if w != worst]
        worst_ph = bucket[worst].get("phases", {})
        best_phase, best_excess = "compute", float("-inf")
        for p in PHASES:
            mine = float(worst_ph.get(p, 0.0))
            ref = (sum(float(r.get("phases", {}).get(p, 0.0))
                       for r in others) / len(others)) if others else 0.0
            if mine - ref > best_excess:
                best_phase, best_excess = p, mine - ref
        return best_phase

    # -- reads ---------------------------------------------------------
    def report(self) -> dict:
        """The cross-worker summary: mean step time, worker skew, trip
        count."""
        with self._lock:
            merged = list(self.merged)
            trips = self.trips
        if not merged:
            return {"steps_merged": 0, "trips": trips}
        mean = sum(m["mean_step_seconds"] for m in merged) / len(merged)
        return {
            "steps_merged": len(merged),
            "workers": merged[-1]["workers"],
            "mean_step_seconds": mean,
            "max_skew_seconds": max(m["max_skew_seconds"]
                                    for m in merged),
            "trips": trips,
            "worker_clock_offsets_s": dict(self.worker_offsets),
        }

    def wait_for_workers(self, timeout: float = 10.0) -> None:
        """Wait (up to ``timeout`` seconds) until every connected worker
        has hung up: what they sent before closing is merged."""
        deadline = time.monotonic() + timeout
        for t in list(self._threads[1:]):
            t.join(max(deadline - time.monotonic(), 0.0))

    def close(self):
        self._closing = True
        try:
            self._srv.close()
        except OSError:
            pass


class StepStatsClient:
    """Worker-side shipper: clock handshake on connect, then one JSON
    line per breakdown.  Register with
    ``StepStats.get().add_sink(client.ship)``.

    A shipping failure marks the sink dead but schedules a RECONNECT
    with capped exponential backoff instead of disabling it for the
    rest of the run (a leader restart — e.g. after a preemption resume
    — used to silence every worker permanently).  Records offered while
    disconnected are dropped; observability must never take training
    down, so reconnect errors only push the retry further out.

    ``clock`` is injectable so tests can simulate skewed hosts."""

    def __init__(self, host: str, port: int, *, worker: int,
                 hostname: Optional[str] = None,
                 clock: Callable[[], float] = time.time,
                 timeout: float = 5.0,
                 reconnect_backoff: float = 0.5,
                 max_backoff: float = 30.0):
        self.worker = int(worker)
        self.clock = clock
        self._host, self._port, self._timeout = host, int(port), timeout
        self._hostname = hostname
        self._backoff = float(reconnect_backoff)
        self._max_backoff = float(max_backoff)
        self._fail_streak = 0
        self._retry_at = 0.0
        self._closed = False
        self._sock = None
        self._connect()

    def _connect(self) -> None:
        self._sock = socket.create_connection(
            (self._host, self._port), timeout=self._timeout)
        self._f = self._sock.makefile("rwb")
        # NTP-lite handshake: offset of OUR clock vs the leader's
        t0 = self.clock()
        self._send({"hello": {"worker": self.worker,
                              "host": self._hostname
                              or socket.gethostname(),
                              "t0": t0}})
        reply = json.loads(self._f.readline().decode())
        t1 = self.clock()
        self.clock_offset_s = estimate_clock_offset(
            t0, float(reply["t_leader"]), t1)
        self._send({"worker": self.worker,
                    "offset_s": self.clock_offset_s})
        self._dead = False
        self._fail_streak = 0

    def _send(self, obj: dict) -> None:
        self._f.write(json.dumps(obj).encode() + b"\n")
        self._f.flush()

    def _note_failure(self, what: str, e: BaseException) -> None:
        self._dead = True
        self._fail_streak += 1
        delay = min(self._backoff * 2 ** (self._fail_streak - 1),
                    self._max_backoff)
        self._retry_at = time.monotonic() + delay
        log.warning("stepstats client: %s failed (%r); retry in %.1fs",
                    what, e, delay)

    def ship(self, rec: dict) -> None:
        if self._dead:
            if self._closed or time.monotonic() < self._retry_at:
                return
            for end in (self._f, self._sock):
                try:
                    end.close()
                except OSError:
                    pass
            try:
                self._connect()
                log.info("stepstats client: reconnected to %s:%d",
                         self._host, self._port)
            except (OSError, ValueError) as e:
                self._note_failure("reconnect", e)
                return
        try:
            self._send(rec)
        except (OSError, ValueError) as e:
            self._note_failure("shipping", e)

    def close(self):
        """Hang up: the file object and the socket both (a socket with
        a live ``makefile`` stays open, and the leader would not see
        the end of the stream)."""
        self._dead = True
        self._closed = True
        for end in (getattr(self, "_f", None), self._sock):
            try:
                if end is not None:
                    end.close()
            except OSError:
                pass


# ----------------------------------------------------------------------
def scaling_block(measure_result: dict, *,
                  observatory: Optional[dict] = None) -> dict:
    """The ``scaling`` block from a ``parallel.scaling`` measurement
    (``{"sizes", "throughput", "base"}``): per-card throughput and
    efficiency at every mesh size against the smallest-size baseline,
    with the cross-worker observatory's skew report attached when a
    leader ran one."""
    sizes = [int(n) for n in measure_result["sizes"]]
    base = int(measure_result.get("base", min(sizes)))
    tp = {int(n): float(v)
          for n, v in measure_result["throughput"].items()}
    block = {
        "baseline_chips": base,
        "sizes": sizes,
        "throughput_per_chip": {str(n): tp[n] / n for n in sizes},
        "efficiency": {str(n): (tp[n] / n) / (tp[base] / base)
                       for n in sizes},
        "max_worker_skew_seconds": 0.0,
    }
    if observatory:
        block["observatory"] = observatory
        block["max_worker_skew_seconds"] = float(
            observatory.get("max_skew_seconds", 0.0))
    return block


# ----------------------------------------------------------------------
# on-demand bounded profiling
class CaptureActiveError(RuntimeError):
    """A capture is already running (an HTTP front maps this to 409)."""


class ProfileCapture:
    """At most ONE bounded capture per process: counts down ``steps``
    closed breakdowns (or a wall-clock expiry as the backstop: a
    stalled job must not pin the profiler forever), then finalizes:
    stops the optional ``torch.profiler`` trace and writes it as
    ``device.trace.json`` (host ops, CUDA runtime calls and, on the
    card, kernels), exports the observatory chrome trace, and merges
    the two into ``merged.trace.json``."""

    _active: Optional["ProfileCapture"] = None
    _last_result: Optional[dict] = None
    _cls_lock = threading.Lock()

    def __init__(self, steps: int, out_dir: str, *,
                 expire_seconds: Optional[float] = None):
        self.steps = max(1, min(int(steps), 100_000))
        self.remaining = self.steps
        self.out_dir = out_dir
        self.expire_seconds = float(
            expire_seconds if expire_seconds is not None
            else max(30.0, self.steps * 2.0))
        self.started_at = time.time()
        self._prof = None
        self._done = False
        self._lock = threading.Lock()
        self._timer: Optional[threading.Timer] = None

    # -- lifecycle -----------------------------------------------------
    @classmethod
    def start(cls, steps: int, *, out_dir: Optional[str] = None,
              expire_seconds: Optional[float] = None) -> dict:
        """Begin a capture; raises :class:`CaptureActiveError` when one
        is already running."""
        with cls._cls_lock:
            if cls._active is not None:
                raise CaptureActiveError(
                    f"a capture started {time.time() - cls._active.started_at:.0f}s "
                    f"ago is still active "
                    f"({cls._active.remaining} steps remaining)")
            if out_dir is None:
                base = Environment.get().flight_recorder_dir \
                    or "flightrec"
                out_dir = os.path.join(
                    base, f"profile_{int(time.time())}_{os.getpid()}")
            cap = cls(steps, out_dir, expire_seconds=expire_seconds)
            cls._active = cap
        os.makedirs(out_dir, exist_ok=True)
        try:
            cap._prof = _start_profiler()
        except Exception as e:  # noqa: BLE001 — the observatory trace stays
            log.warning("torch.profiler capture unavailable: %r", e)
        StepStats.get().add_sink(cap._on_step)
        cap._timer = threading.Timer(cap.expire_seconds,
                                     cap.finalize, args=("expired",))
        cap._timer.daemon = True
        cap._timer.start()
        return cap.status()

    def _on_step(self, rec: dict) -> None:
        with self._lock:
            self.remaining -= 1
            done = self.remaining <= 0
        if done:
            self.finalize("complete")

    def finalize(self, reason: str) -> Optional[dict]:
        with self._lock:
            if self._done:
                return None
            self._done = True
        if self._timer is not None:
            self._timer.cancel()
        StepStats.get().remove_sink(self._on_step)
        artifacts = []
        device = None
        if self._prof is not None:
            try:
                self._prof.__exit__(None, None, None)
                device = os.path.join(self.out_dir, "device.trace.json")
                self._prof.export_chrome_trace(device)
            except Exception as e:  # noqa: BLE001
                log.warning("torch.profiler stop failed: %r", e)
                device = None
        obs = os.path.join(self.out_dir, "observatory.trace.json")
        try:
            telemetry.export_chrome_trace(obs)
            artifacts.append(obs)
        except OSError as e:
            log.warning("observatory trace export failed: %r", e)
        if device is not None:
            artifacts.append(device)
            try:
                merged = os.path.join(self.out_dir, "merged.trace.json")
                telemetry.merge_chrome_traces(merged, obs, device)
                artifacts.append(merged)
            except Exception as e:  # noqa: BLE001 — merge is best-effort
                log.warning("profile trace merge failed: %r", e)
        result = {
            "reason": reason,
            "steps_requested": self.steps,
            "steps_captured": self.steps - max(self.remaining, 0),
            "seconds": round(time.time() - self.started_at, 3),
            "out_dir": self.out_dir,
            "artifacts": artifacts,
            "torch_profiler": self._prof is not None,
        }
        if telemetry.enabled():
            telemetry.counter(
                "dl4j_profile_captures_total",
                "on-demand profile captures finalized, by reason "
                "(complete | expired | cancelled)").inc(reason=reason)
        with ProfileCapture._cls_lock:
            ProfileCapture._last_result = result
            if ProfileCapture._active is self:
                ProfileCapture._active = None
        log.info("profile capture finalized (%s): %s", reason,
                 artifacts)
        return result

    def status(self) -> dict:
        return {"active": not self._done,
                "remaining_steps": max(self.remaining, 0),
                "steps": self.steps,
                "out_dir": self.out_dir,
                "started_at": self.started_at,
                "expire_seconds": self.expire_seconds,
                "torch_profiler": self._prof is not None}

    # -- module-level views -------------------------------------------
    @classmethod
    def current_status(cls) -> dict:
        with cls._cls_lock:
            active = cls._active
            last = cls._last_result
        if active is not None:
            return active.status()
        out = {"active": False}
        if last is not None:
            out["last"] = last
        return out

    @classmethod
    def _reset_for_tests(cls):
        with cls._cls_lock:
            active, cls._active = cls._active, None
            cls._last_result = None
        if active is not None:
            active.finalize("cancelled")


def _start_profiler():
    """A running ``torch.profiler.profile`` over the host and, when a
    card is present, the device."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    return prof
