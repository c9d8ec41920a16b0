"""The port's learning-rate schedules (``learning/schedules.py``)
against the JAX package's, on the CPU.

Every schedule's ``value_at`` over 50 iterations and 3 epochs, each
under ``ScheduleType.ITERATION`` and ``ScheduleType.EPOCH``, at rtol
1e-6: both compute in float32 (the JAX package's jnp arithmetic, given
an int32 iteration as its train step gives it). The JSON maps cross in
both directions, and an updater with a schedule writes and reads the
JAX package's map.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from deeplearning4j_tpu.learning import schedules as js
from deeplearning4j_tpu.learning import updaters as ju
from deeplearning4j_tpu_torch.learning import schedules as ts
from deeplearning4j_tpu_torch.learning import updaters as tu
from torch_parity import one_intraop_thread  # noqa: F401,E402

RTOL = 1e-6

#: (class name, keyword arguments) for every schedule
CASES = [
    ("FixedSchedule", dict(value=3e-3)),
    ("StepSchedule", dict(initial_value=0.1, decay_rate=0.7, step=7.0)),
    ("ExponentialSchedule", dict(initial_value=0.05, gamma=0.9)),
    ("InverseSchedule", dict(initial_value=0.02, gamma=0.3, power=0.75)),
    ("PolySchedule", dict(initial_value=0.1, power=2.0, max_iter=40)),
    ("SigmoidSchedule", dict(initial_value=0.1, gamma=0.2, step_size=20)),
    ("MapSchedule", dict(values={0: 0.1, 5: 0.05, 17: 0.01, 33: 0.002})),
    ("LinearSchedule", dict(initial_value=0.1, final_value=0.003,
                            max_iter=30)),
    ("CycleSchedule", dict(initial_value=1e-3, max_value=0.1,
                           final_value=1e-4, cycle_length=30,
                           annealing_length=9)),
]
IDS = [c[0] for c in CASES] + ["WarmupSchedule"]


def _pair(name, kw, kind):
    if name == "WarmupSchedule":
        j = js.WarmupSchedule(warmup_steps=12, inner=js.ExponentialSchedule(
            0.05, 0.95, js.ScheduleType[kind]),
            schedule_type=js.ScheduleType[kind])
        t = ts.WarmupSchedule(warmup_steps=12, inner=ts.ExponentialSchedule(
            0.05, 0.95, ts.ScheduleType[kind]),
            schedule_type=ts.ScheduleType[kind])
        return j, t
    return (getattr(js, name)(**kw, schedule_type=js.ScheduleType[kind]),
            getattr(ts, name)(**kw, schedule_type=ts.ScheduleType[kind]))


@pytest.mark.parametrize("kind", ["ITERATION", "EPOCH"])
@pytest.mark.parametrize("case", CASES + [("WarmupSchedule", None)],
                         ids=IDS)
def test_value_at_matches_jax(case, kind):
    j, t = _pair(*case, kind)
    for epoch in range(3):
        for it in range(50):
            want = np.float32(j.value_at(jnp.asarray(it, jnp.int32),
                                         jnp.asarray(epoch, jnp.int32)))
            got = t.value_at(it, epoch)
            assert isinstance(got, float)
            np.testing.assert_allclose(got, want, rtol=RTOL,
                                       err_msg=f"it {it} epoch {epoch}")
            # the port's value is an f32 value, as the JAX package's is
            assert np.float32(got) == got


@pytest.mark.parametrize("case", CASES + [("WarmupSchedule", None)],
                         ids=IDS)
def test_json_crosses_both_ways(case):
    j, t = _pair(*case, "EPOCH")
    assert t.to_map() == j.to_map()
    back = ts.ISchedule.from_map(j.to_map())
    assert type(back) is type(t) and back.to_map() == t.to_map()
    jback = js.ISchedule.from_map(t.to_map())
    assert jback.to_map() == j.to_map()


def test_map_schedule_needs_a_value_at_zero():
    with pytest.raises(ValueError, match="t=0"):
        ts.MapSchedule(values={3: 0.1})


@pytest.mark.parametrize("case", CASES[1:3] + [("WarmupSchedule", None)],
                         ids=IDS[1:3] + ["WarmupSchedule"])
def test_updater_with_a_schedule_round_trips_and_applies(case):
    """Adam with a schedule as its learning rate: the JAX package's map,
    read back by both packages, and ``lr_at`` equal to the schedule's
    value; the update at iteration i uses the rate at i."""
    j, t = _pair(*case, "ITERATION")
    up, jup = tu.Adam(t), ju.Adam(j)
    assert up.to_map() == jup.to_map()
    assert tu.IUpdater.from_map(jup.to_map()).to_map() == jup.to_map()
    assert ju.IUpdater.from_map(up.to_map()).to_map() == jup.to_map()
    import torch
    g = {"W": torch.tensor([0.5, -2.0])}
    for it in (0, 3, 11, 29):
        np.testing.assert_allclose(
            up.lr_at(it), float(jup.lr_at(jnp.asarray(it, jnp.int32))),
            rtol=RTOL)
        sgd = tu.Sgd(t)
        upd, _ = sgd.apply(g, {}, it)
        np.testing.assert_allclose(upd["W"].numpy(),
                                   up.lr_at(it) * g["W"].numpy(),
                                   rtol=1e-7)
