"""Admission control for the inference server.

Counterpart of ``deeplearning4j_tpu/serving/admission.py``: requests
beyond a model's in-flight budget are shed at once (HTTP 429 +
``Retry-After``) so admitted ones keep their latency, and shutdown
drains (no new admissions, wait for in-flight work). With a
``latency_slo_ms`` the budget moves AIMD-style on the windowed p95 of
completed requests; ``Retry-After`` comes from the measured drain
rate. Per-request deadlines fail fast at admission (504) and are
cancelled, not computed, when they expire in the batcher's queue.
Generate requests are admitted by token cost (``admit(..., cost=)``).
Every observed latency also feeds the process's
:class:`~deeplearning4j_tpu_torch.serving.slo.SLOTracker` (when the model
has an SLO) with the request's trace id as the latency histogram's
exemplar, and a budget shrink logs the fast window's burn rate beside
the p95 that caused it.
"""
from __future__ import annotations

import logging
import math
import threading
import time
from collections import deque
from typing import Deque, Dict, Optional

from deeplearning4j_tpu_torch.common import telemetry
from deeplearning4j_tpu_torch.serving.slo import SLOTracker

log = logging.getLogger("deeplearning4j_tpu_torch")

#: never tell a client to back off longer than this (seconds)
RETRY_AFTER_CAP_S = 60.0

#: AIMD shrink factor while p95 > SLO / regrow threshold under it
_SHRINK = 0.7
_REGROW_AT = 0.8


class ShedError(RuntimeError):
    """Raised by :meth:`AdmissionController.admit` on rejection:
    ``reason`` is ``"queue_full"`` (429) or ``"draining"`` (503)."""

    def __init__(self, reason: str, retry_after_s: float):
        super().__init__(f"request shed: {reason}")
        self.reason = reason
        self.retry_after_s = retry_after_s


class DeadlineExceeded(TimeoutError):
    """A request's deadline passed before its batch was computed (504)."""


def deadline_after_ms(ms: Optional[float]) -> Optional[float]:
    """A ``time.monotonic()`` deadline ``ms`` from now (None: none)."""
    return None if ms is None else time.monotonic() + float(ms) / 1e3


def deadline_shed_counter() -> telemetry.Counter:
    return telemetry.counter(
        "dl4j_serving_deadline_shed_total",
        "requests dropped because their deadline expired, where="
        "admission (expired on arrival) or where=queue (expired while "
        "queued, cancelled before compute)")


class AdmissionController:
    """Bounded per-model admission with load shedding, SLO-adaptive
    budgets, measured ``Retry-After`` and graceful drain."""

    def __init__(self, max_queue: int = 64,
                 retry_after_s: float = 1.0, *,
                 latency_slo_ms: Optional[float] = None,
                 adapt_window: int = 64,
                 rate_window_s: float = 30.0,
                 min_budget: int = 1):
        self.max_queue = int(max_queue)
        self.retry_after_s = float(retry_after_s)
        self.latency_slo_ms = latency_slo_ms
        self.adapt_window = int(adapt_window)
        self.rate_window_s = float(rate_window_s)
        self.min_budget = int(min_budget)
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self._inflight: Dict[str, int] = {}
        self._draining = False
        self._slo_ms: Dict[str, float] = {}
        self._budget: Dict[str, int] = {}
        self._totals: Dict[str, Deque[float]] = {}
        self._done_ts: Dict[str, Deque[float]] = {}
        self._gauge = telemetry.gauge(
            "dl4j_serving_inflight",
            "admitted requests currently queued or computing, per model")
        self._shed = telemetry.counter(
            "dl4j_serving_shed_total",
            "requests rejected by admission control "
            "(reason=queue_full -> 429, reason=draining -> 503)")

    @property
    def draining(self) -> bool:
        return self._draining

    def inflight(self, model: str) -> int:
        return self._inflight.get(model, 0)

    # -- SLO controller ------------------------------------------------
    def set_slo(self, model: str, slo_ms: Optional[float]) -> None:
        with self._lock:
            if slo_ms is None:
                self._slo_ms.pop(model, None)
            else:
                self._slo_ms[model] = float(slo_ms)

    def budget(self, model: str) -> int:
        return self._budget.get(model, self.max_queue)

    def observe_total(self, model: str, seconds: float,
                      now: Optional[float] = None,
                      trace_id: Optional[str] = None) -> None:
        """Report one completed request's total latency: feeds the
        ``dl4j_serving_total_seconds`` histogram (``trace_id`` as its
        exemplar), the SLO tracker, the drain rate behind
        ``Retry-After`` and the AIMD budget."""
        now = time.monotonic() if now is None else now
        hist = telemetry.histogram(
            "dl4j_serving_total_seconds",
            "total submit->response latency of completed predict "
            "requests (seconds)")
        if trace_id:
            hist.observe_with_exemplar(seconds, {"trace_id": trace_id},
                                       model=model)
        else:
            hist.observe(seconds, model=model)
        slo_ms = self._slo_ms.get(model, self.latency_slo_ms)
        if slo_ms is not None:
            SLOTracker.get().observe(model, seconds, slo_ms, now=now)
        with self._lock:
            self._totals.setdefault(
                model, deque(maxlen=self.adapt_window)).append(
                    float(seconds))
            self._done_ts.setdefault(model, deque(maxlen=512)).append(now)
            rate = self._drain_rate_locked(model, now)
            self._adapt_locked(model)
        if rate is not None:
            telemetry.gauge(
                "dl4j_serving_drain_rate_rps",
                "measured completion rate per model over the admission "
                "controller's sliding window (the denominator of the "
                "derived Retry-After)").set(rate, model=model)

    def _adapt_locked(self, model: str) -> None:
        slo_ms = self._slo_ms.get(model, self.latency_slo_ms)
        window = self._totals.get(model)
        if slo_ms is None or not window:
            return
        lats = sorted(window)
        p95_ms = lats[min(len(lats) - 1,
                          int(math.ceil(0.95 * len(lats))) - 1)] * 1e3
        budget = self._budget.get(model, self.max_queue)
        if p95_ms > slo_ms:
            shrunk = max(self.min_budget, int(budget * _SHRINK))
            if shrunk < budget:
                # the fast burn rate beside the shrink: why the budget
                # dropped stays answerable afterwards
                burn = SLOTracker.get().burn_rate(model, "fast")
                log.info("admission: shrinking %s budget -> %d (p95 "
                         "%.1fms > SLO %.1fms; fast burn rate %s)", model,
                         shrunk, p95_ms, slo_ms,
                         f"{burn:.2f}" if burn is not None else "n/a")
                telemetry.instant("admission.shrink", model=model,
                                  budget=shrunk, p95_ms=round(p95_ms, 3),
                                  burn_rate_fast=burn)
            budget = shrunk
        elif p95_ms < _REGROW_AT * slo_ms and budget < self.max_queue:
            budget += 1
        self._budget[model] = budget
        telemetry.gauge(
            "dl4j_serving_admission_budget",
            "live in-flight budget per model (AIMD on windowed p95 vs "
            "latency_slo_ms)").set(budget, model=model)

    # -- measured Retry-After ------------------------------------------
    def _drain_rate_locked(self, model: str,
                           now: float) -> Optional[float]:
        """Completions per second over the sliding window (None before
        any). With fewer than two samples spanning the window the rate
        is the conservative floor: those completions over the whole
        window."""
        done = self._done_ts.get(model)
        if not done:
            return None
        recent = [t for t in done if t >= now - self.rate_window_s]
        if not recent:
            return None
        span = now - recent[0]
        if len(recent) < 2 or span <= 1e-3:
            return len(recent) / self.rate_window_s
        return len(recent) / span

    def retry_after_s_for(self, model: Optional[str] = None,
                          now: Optional[float] = None) -> float:
        now = time.monotonic() if now is None else now
        with self._lock:
            rate = (self._drain_rate_locked(model, now)
                    if model is not None else None)
            if not rate:
                return self.retry_after_s
            excess = max(1, self._inflight.get(model, 0)
                         - self._budget.get(model, self.max_queue) + 1)
        return min(RETRY_AFTER_CAP_S, max(self.retry_after_s,
                                          excess / rate))

    def retry_after_header(self, model: Optional[str] = None) -> str:
        return str(max(1, int(math.ceil(self.retry_after_s_for(model)))))

    # ------------------------------------------------------------------
    def admit(self, model: str, deadline: Optional[float] = None, *,
              cost: int = 1) -> None:
        """Admit one request for ``model`` or raise
        :class:`DeadlineExceeded` / :class:`ShedError`. Pair every
        successful admit with a :meth:`release` of the same ``cost``.

        ``cost`` is the request's weight against the in-flight budget: 1
        for a predict, the KV blocks of its prompt and completion for a
        generate, so one long prompt spends the budget many short ones
        would. An oversized request is still admitted when the model is
        idle, or it could never run; a shed one is told to retry after
        its cost over the measured drain rate."""
        cost = max(1, int(cost))
        if deadline is not None and time.monotonic() >= deadline:
            deadline_shed_counter().inc(model=model, where="admission")
            raise DeadlineExceeded("deadline already expired at admission")
        with self._lock:
            if self._draining:
                self._shed.inc(model=model, reason="draining")
                raise ShedError("draining", self.retry_after_s)
            n = self._inflight.get(model, 0)
            limit = min(self._budget.get(model, self.max_queue),
                        self.max_queue)
            if n >= limit or (n > 0 and n + cost > limit):
                self._shed.inc(model=model, reason="queue_full")
                rate = self._drain_rate_locked(model, time.monotonic())
                retry = (self.retry_after_s if not rate else
                         min(RETRY_AFTER_CAP_S,
                             max(self.retry_after_s, cost / rate)))
                raise ShedError("queue_full", retry)
            self._inflight[model] = n + cost
            self._gauge.set(n + cost, model=model)

    def release(self, model: str, *, cost: int = 1) -> None:
        with self._lock:
            n = max(0, self._inflight.get(model, 0) - max(1, int(cost)))
            self._inflight[model] = n
            self._gauge.set(n, model=model)
            if n == 0:
                self._idle.notify_all()

    def drain(self, timeout: float = 30.0) -> bool:
        """Stop admitting and wait for in-flight work to finish; True
        when everything drained within ``timeout``."""
        deadline = time.monotonic() + timeout
        with self._lock:
            self._draining = True
            while any(self._inflight.values()):
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._idle.wait(left)
        return True

    def resume(self) -> None:
        with self._lock:
            self._draining = False
