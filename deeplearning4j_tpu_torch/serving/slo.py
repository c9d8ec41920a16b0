"""SLO error-budget accounting over the serving latency stream.

Counterpart of ``deeplearning4j_tpu/serving/slo.py``: each completed
request the admission controller observes is classified in or out of
its model's ``latency_slo_ms``, and rolling windows per model answer:

- the in-SLO fraction over a fast (default 300 s) and a slow (default
  3600 s) window;
- the burn rate of each window: violation fraction over the error
  budget ``1 - target`` (target default 0.99); fast and slow both above
  1 means burning now, and not a blip;
- the budget remaining: ``1 - `` the slow window's burn rate (1 is
  untouched, 0 exhausted, negative overdrawn).

They show as the ``dl4j_slo_*`` gauges on ``/metrics``, as ``GET
/api/slo`` on a replica server and on the router, and as
:meth:`SLOTracker.report`. One tracker a process (in-process replicas
share it); ``DL4J_TORCH_SLO_TARGET``, ``DL4J_TORCH_SLO_FAST_S`` and
``DL4J_TORCH_SLO_SLOW_S`` set the target and windows, and every method
takes an injectable monotonic ``now``.
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Deque, Dict, Optional, Tuple

from deeplearning4j_tpu_torch.common import telemetry

#: events kept a model; past it the oldest age out early (the report
#: then covers a shorter window, never a stale one)
_MAX_EVENTS = 8192


def _in_fraction_gauge() -> telemetry.Gauge:
    return telemetry.gauge(
        "dl4j_slo_in_fraction",
        "fraction of completed requests inside the model's latency_slo_ms "
        "over the rolling window (window=fast|slow), per model")


def _burn_gauge() -> telemetry.Gauge:
    return telemetry.gauge(
        "dl4j_slo_burn_rate",
        "SLO error-budget burn rate per rolling window (violation fraction "
        "/ error budget; 1.0 burns exactly at budget), per model")


def _budget_gauge() -> telemetry.Gauge:
    return telemetry.gauge(
        "dl4j_slo_budget_remaining",
        "share of the slow window's error budget still unspent (1 "
        "untouched, 0 exhausted, negative overdrawn), per model")


class SLOTracker:
    """Per-model rolling-window in-SLO and burn-rate accounting."""

    _instance: Optional["SLOTracker"] = None
    _instance_lock = threading.Lock()

    def __init__(self, target: Optional[float] = None,
                 fast_window_s: Optional[float] = None,
                 slow_window_s: Optional[float] = None):
        env = os.environ.get
        self.target = float(target if target is not None
                            else env("DL4J_TORCH_SLO_TARGET", "0.99"))
        if not 0.0 < self.target < 1.0:
            raise ValueError(f"SLO target must be in (0, 1), got "
                             f"{self.target}")
        self.fast_window_s = float(
            fast_window_s if fast_window_s is not None
            else env("DL4J_TORCH_SLO_FAST_S", "300"))
        self.slow_window_s = float(
            slow_window_s if slow_window_s is not None
            else env("DL4J_TORCH_SLO_SLOW_S", "3600"))
        self._lock = threading.Lock()
        #: per model: (monotonic time, in SLO) completions
        self._events: Dict[str, Deque[Tuple[float, bool]]] = {}
        self._slo_ms: Dict[str, float] = {}

    @classmethod
    def get(cls) -> "SLOTracker":
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

    def observe(self, model: str, seconds: float, slo_ms: float,
                now: Optional[float] = None) -> None:
        """Classify one completed request against ``slo_ms`` and refresh
        the model's gauges."""
        now = time.monotonic() if now is None else now
        ok = seconds * 1e3 <= float(slo_ms)
        with self._lock:
            self._slo_ms[model] = float(slo_ms)
            self._events.setdefault(
                model, deque(maxlen=_MAX_EVENTS)).append((now, ok))
        if telemetry.enabled():
            self._publish(model, now)

    @staticmethod
    def _window_stats(events, horizon: float) -> Tuple[int, int]:
        """(completions, violations) at or after ``horizon``."""
        n = bad = 0
        for ts, ok in reversed(events):
            if ts < horizon:
                break
            n += 1
            bad += not ok
        return n, bad

    def _stats_locked(self, model: str, now: float) -> dict:
        events = self._events.get(model)
        if not events:
            return {}
        budget = 1.0 - self.target
        out = {"slo_ms": self._slo_ms.get(model), "target": self.target,
               "windows": {}}
        for label, win in (("fast", self.fast_window_s),
                           ("slow", self.slow_window_s)):
            n, bad = self._window_stats(events, now - win)
            out["windows"][label] = {
                "window_s": win, "n": n,
                "in_slo_fraction": (n - bad) / n if n else 1.0,
                "burn_rate": (bad / n) / budget if n else 0.0}
        out["budget_remaining"] = 1.0 - out["windows"]["slow"]["burn_rate"]
        return out

    def _publish(self, model: str, now: float) -> None:
        with self._lock:
            stats = self._stats_locked(model, now)
        if not stats:
            return
        for label, w in stats["windows"].items():
            _in_fraction_gauge().set(w["in_slo_fraction"], model=model,
                                     window=label)
            _burn_gauge().set(w["burn_rate"], model=model, window=label)
        _budget_gauge().set(stats["budget_remaining"], model=model)

    def burn_rate(self, model: str, window: str = "fast",
                  now: Optional[float] = None) -> Optional[float]:
        """The window's current burn rate (None before the model's first
        observation)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            stats = self._stats_locked(model, now)
        return stats["windows"][window]["burn_rate"] if stats else None

    def report(self, now: Optional[float] = None) -> dict:
        """The ``GET /api/slo`` document."""
        now = time.monotonic() if now is None else now
        with self._lock:
            models = {m: self._stats_locked(m, now) for m in self._events}
        return {"target": self.target,
                "fast_window_s": self.fast_window_s,
                "slow_window_s": self.slow_window_s, "models": models}


telemetry.on_reset(SLOTracker._reset_for_tests)
