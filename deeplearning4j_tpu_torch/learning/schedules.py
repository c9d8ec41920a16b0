"""Learning-rate schedules.

Counterpart of ``deeplearning4j_tpu/learning/schedules.py``: the same
``ISchedule`` classes, fields and JSON (``to_map`` / ``from_map``), so
an updater whose ``learning_rate`` is a schedule round-trips through
``configuration.json`` in both directions. ``value_at(iteration,
epoch)`` is computed in float32, as the JAX package's jnp arithmetic
is (its weakly typed Python constants meet f32 values), and returned as
a Python float holding that f32 value, so ``lr * g`` on an f32 tensor
gives the JAX package's bits for the lr. ``schedule_type`` picks the
iteration or the epoch as the schedule's time.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict

import numpy as np

_f32 = np.float32


class ScheduleType(enum.Enum):
    ITERATION = "iteration"
    EPOCH = "epoch"


def _pow(a, b) -> np.float32:
    return np.power(_f32(a), _f32(b))


def _clip01(v) -> np.float32:
    return np.minimum(np.maximum(_f32(v), _f32(0.0)), _f32(1.0))


class ISchedule:
    """``value_at(iteration, epoch)`` -> the learning rate (f32)."""

    schedule_type: ScheduleType = ScheduleType.ITERATION

    def _t(self, iteration, epoch):
        return iteration if self.schedule_type is ScheduleType.ITERATION \
            else epoch

    def value_at(self, iteration, epoch=0) -> float:
        return float(self._value(self._t(iteration, epoch), iteration,
                                 epoch))

    def _value(self, t, iteration, epoch) -> np.float32:
        raise NotImplementedError

    # -- JSON round-trip -------------------------------------------------
    def to_map(self) -> dict:
        d = {"@class": type(self).__name__}
        d.update({k: (v.value if isinstance(v, ScheduleType) else v)
                  for k, v in self.__dict__.items()})
        return d

    @staticmethod
    def from_map(d: dict) -> "ISchedule":
        d = dict(d)
        cls = _REGISTRY[d.pop("@class")]
        if not isinstance(cls, type):   # custom deserializer function
            return cls(d)
        if "schedule_type" in d:
            d["schedule_type"] = ScheduleType(d["schedule_type"])
        return cls(**d)


@dataclass
class FixedSchedule(ISchedule):
    value: float = 1e-3
    schedule_type: ScheduleType = ScheduleType.ITERATION

    def _value(self, t, iteration, epoch):
        return _f32(self.value)


@dataclass
class StepSchedule(ISchedule):
    """lr = initial * decay_rate ^ floor(t / step)."""
    initial_value: float = 1e-3
    decay_rate: float = 0.5
    step: float = 1000.0
    schedule_type: ScheduleType = ScheduleType.ITERATION

    def _value(self, t, iteration, epoch):
        k = np.floor(_f32(t) / _f32(self.step))
        return _f32(self.initial_value) * _pow(self.decay_rate, k)


@dataclass
class ExponentialSchedule(ISchedule):
    """lr = initial * gamma ^ t."""
    initial_value: float = 1e-3
    gamma: float = 0.999
    schedule_type: ScheduleType = ScheduleType.ITERATION

    def _value(self, t, iteration, epoch):
        return _f32(self.initial_value) * _pow(self.gamma, t)


@dataclass
class InverseSchedule(ISchedule):
    """lr = initial / (1 + gamma * t) ^ power."""
    initial_value: float = 1e-3
    gamma: float = 0.001
    power: float = 1.0
    schedule_type: ScheduleType = ScheduleType.ITERATION

    def _value(self, t, iteration, epoch):
        base = _f32(1.0) + _f32(self.gamma) * _f32(t)
        return _f32(self.initial_value) / _pow(base, self.power)


@dataclass
class PolySchedule(ISchedule):
    """lr = initial * (1 - t/max_iter) ^ power."""
    initial_value: float = 1e-3
    power: float = 1.0
    max_iter: int = 10000
    schedule_type: ScheduleType = ScheduleType.ITERATION

    def _value(self, t, iteration, epoch):
        frac = _clip01(_f32(t) / _f32(self.max_iter))
        return _f32(self.initial_value) * _pow(_f32(1.0) - frac,
                                               self.power)


@dataclass
class SigmoidSchedule(ISchedule):
    """lr = initial / (1 + exp(-gamma * (t - step_size)))."""
    initial_value: float = 1e-3
    gamma: float = 0.01
    step_size: int = 1000
    schedule_type: ScheduleType = ScheduleType.ITERATION

    def _value(self, t, iteration, epoch):
        z = -_f32(self.gamma) * (_f32(t) - _f32(self.step_size))
        return _f32(self.initial_value) / (_f32(1.0) + np.exp(_f32(z)))


@dataclass
class MapSchedule(ISchedule):
    """Piecewise-constant: each value holds from its breakpoint until
    the next one (reference: ``MapSchedule``)."""
    values: Dict[int, float] = field(default_factory=dict)
    schedule_type: ScheduleType = ScheduleType.ITERATION

    def __post_init__(self):
        self.values = {int(k): float(v) for k, v in self.values.items()}
        if 0 not in self.values:
            raise ValueError("MapSchedule requires a value for t=0")

    def _value(self, t, iteration, epoch):
        keys = sorted(self.values)
        out = _f32(self.values[keys[0]])
        for k in keys[1:]:
            if t >= k:
                out = _f32(self.values[k])
        return out


@dataclass
class LinearSchedule(ISchedule):
    """Linear from initial to final over max_iter steps (then flat)."""
    initial_value: float = 1e-3
    final_value: float = 0.0
    max_iter: int = 10000
    schedule_type: ScheduleType = ScheduleType.ITERATION

    def _value(self, t, iteration, epoch):
        frac = _clip01(_f32(t) / _f32(self.max_iter))
        return _f32(self.initial_value) + frac * _f32(
            self.final_value - self.initial_value)


@dataclass
class CycleSchedule(ISchedule):
    """1cycle: warm up to max, anneal back down, then a short final
    decay (reference: ``CycleSchedule``)."""
    initial_value: float = 1e-4
    max_value: float = 1e-2
    final_value: float = 1e-5
    cycle_length: int = 1000
    annealing_length: int = 100
    schedule_type: ScheduleType = ScheduleType.ITERATION

    def _value(self, t, iteration, epoch):
        up = self.cycle_length // 2
        down_end = self.cycle_length
        tf = _f32(t)
        lo, hi = self.initial_value, self.max_value
        # differences of the Python constants are taken in float64 and
        # rounded once, as the JAX package's weak types do
        if tf < up:
            return _f32(lo) + _f32(hi - lo) * (tf / _f32(max(up, 1)))
        if tf < down_end:
            return _f32(hi) + _f32(lo - hi) * (
                (tf - _f32(up)) / _f32(max(down_end - up, 1)))
        frac = _clip01((tf - _f32(down_end)) /
                       _f32(max(self.annealing_length, 1)))
        return _f32(lo) + _f32(self.final_value - lo) * frac


@dataclass
class WarmupSchedule(ISchedule):
    """Linear warmup into an inner schedule."""
    warmup_steps: int = 1000
    inner: ISchedule = field(default_factory=lambda: FixedSchedule(1e-3))
    schedule_type: ScheduleType = ScheduleType.ITERATION

    def _value(self, t, iteration, epoch):
        peak = _f32(self.inner.value_at(iteration, epoch))
        tf = _f32(t)
        if tf < self.warmup_steps:
            return peak * tf / _f32(max(self.warmup_steps, 1))
        return peak

    def to_map(self) -> dict:
        return {"@class": "WarmupSchedule",
                "warmup_steps": self.warmup_steps,
                "inner": self.inner.to_map(),
                "schedule_type": self.schedule_type.value}


_REGISTRY = {c.__name__: c for c in
             (FixedSchedule, StepSchedule, ExponentialSchedule,
              InverseSchedule, PolySchedule, SigmoidSchedule, MapSchedule,
              LinearSchedule, CycleSchedule)}


def _from_map_warmup(d):
    return WarmupSchedule(warmup_steps=d["warmup_steps"],
                          inner=ISchedule.from_map(d["inner"]),
                          schedule_type=ScheduleType(d["schedule_type"]))


_REGISTRY["WarmupSchedule"] = _from_map_warmup
