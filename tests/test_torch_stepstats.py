"""The training observatory's step layer in the port
(``common/telemetry.step_span`` / ``observe_feed_stall``,
``common/stepstats.py``), held against the JAX package's
``common/stepstats.py``: the same instrument calls and breakdown records
give the same collector records and summaries, the same merged
cross-worker reports, skew and straggler trips, and the same
``scaling_block``. The sidecar socket and ``ProfileCapture`` (on
``torch.profiler``) run on loopback and a temporary directory.
"""
import json
import os

import pytest

from deeplearning4j_tpu.common import stepstats as jss
from deeplearning4j_tpu.common import telemetry as jtel
from deeplearning4j_tpu_torch.common import stepstats, telemetry
from torch_parity import one_intraop_thread  # noqa: F401,E402

#: floats the two packages compute the same way agree to rounding
REL = 1e-12


@pytest.fixture(autouse=True)
def _fresh():
    """Both packages' registries and collectors empty, recording on."""
    for tel, ss in ((telemetry, stepstats), (jtel, jss)):
        tel.MetricsRegistry._reset_for_tests()
        tel.MetricsRegistry.get().set_enabled(True)
        ss.StepStats._reset_for_tests()
        ss.StepStats.get().set_enabled(True)
    yield
    for tel, ss in ((telemetry, stepstats), (jtel, jss)):
        ss.ProfileCapture._reset_for_tests()
        ss.StepStats._reset_for_tests()
        tel.MetricsRegistry._reset_for_tests()


def _drive(ss):
    """One scripted run of instrument calls into a package's collector:
    three steps with feed stalls, a checkpoint stall, an in-step
    updater phase and collectives (an update exchange wrapping the first
    two)."""
    c = ss.collector()
    out = []
    ss.note_data_wait(0.004, "device_prefetch")
    c.note_in_step("updater", 0.002)
    out.append(c.close_step("MultiLayerNetwork", 0, 0.010))
    ss.note_collective("state_placement", 0.003)
    ss.note_checkpoint_stall(0.05)
    out.append(c.close_step("MultiLayerNetwork", 1, 0.020))
    ss.note_collective("update_exchange", 0.040)
    ss.note_collective("global_assembly", 0.001)
    out.append(c.close_step("MultiLayerNetwork", 2, 0.015))
    return out, c.records(), c.summary()


def _strip(rec):
    return {k: v for k, v in rec.items() if k not in ("t", "host")}


def test_collector_records_and_summary_match_jax():
    got, got_recs, got_sum = _drive(stepstats)
    want, want_recs, want_sum = _drive(jss)
    assert [_strip(r) for r in got_recs] == [_strip(r) for r in want_recs]
    assert [_strip(r) for r in got] == [_strip(r) for r in want]
    assert got_sum.keys() == want_sum.keys()
    assert got_sum["phases_pct"] == want_sum["phases_pct"]
    for k in ("mean_step_seconds", "mean_total_seconds"):
        assert got_sum[k] == pytest.approx(want_sum[k], rel=REL)
    # every breakdown's phases sum to its total
    for r in got_recs:
        assert sum(r["phases"].values()) == pytest.approx(
            r["total_seconds"], rel=REL)
    # the update exchange's excess over the steps it wrapped (both closed
    # steps, 0.030 s) lands in the last breakdown's collective phase
    assert got_recs[1]["phases"]["collective"] == pytest.approx(
        0.040 - 0.030, rel=REL)


def test_step_span_and_feed_stall_route_like_jax():
    for tel, ss in ((telemetry, stepstats), (jtel, jss)):
        with tel.step_span("ComputationGraph", steps=2) as sp:
            pass
        tel.observe_feed_stall(0.0125, source="device_prefetch")
        rec = ss.close_step("ComputationGraph", 0, sp)
        assert rec["phases"]["data_wait"] == 0.0125
        assert rec["step_seconds"] == sp.duration > 0
        h = tel.histogram("dl4j_train_step_seconds")
        assert h.count_of(model="ComputationGraph") == 1
        assert tel.histogram("dl4j_feed_stall_seconds").count_of(
            source="device_prefetch") == 1
        spans = [e for e in tel.trace_events() if e["name"] == "train_step"]
        assert len(spans) == 1 and spans[0]["args"] == {
            "model": "ComputationGraph", "steps": 2}


def _worker_recs():
    """Four steps of two workers' breakdowns; worker 1 straggles at
    step 2 on its collective phase."""
    recs = []
    for step in range(4):
        for w in (0, 1):
            slow = step == 2 and w == 1
            ph = {p: 0.0 for p in jss.PHASES}
            ph["compute"] = 0.010 + 0.001 * w
            ph["collective"] = 0.030 if slow else 0.002
            recs.append({"step": step, "worker": w, "host": f"h{w}",
                         "step_seconds": sum(ph.values()), "phases": ph})
    return recs


def test_aggregators_merge_like_jax():
    """The same records into both aggregators (direct ``ingest``, no
    socket): the same merged steps, skew, straggler trip and report."""
    merged = {}
    for ss in (stepstats, jss):
        agg = ss.StepStatsAggregator(2, port=0, trip_factor=1.5,
                                     min_step_seconds=1e-3)
        try:
            out = [agg.ingest(r) for r in _worker_recs()]
            merged[ss] = ([m for m in out if m is not None], agg.report())
        finally:
            agg.close()
    (got, got_rep), (want, want_rep) = merged[stepstats], merged[jss]
    assert len(got) == 4
    assert got == want
    assert got_rep == want_rep
    assert got[2]["tripped"] and got[2]["worst_worker"] == 1
    assert got[2]["worst_phase"] == "collective"
    assert telemetry.counter("dl4j_straggler_trips_total").value(
        worker="1", phase="collective") == 1


def test_scaling_block_matches_jax():
    meas = {"sizes": [1, 2, 4], "throughput": {1: 100.0, 2: 190.0,
                                               4: 360.0}}
    obs = {"max_skew_seconds": 0.004, "steps_merged": 3}
    for o in (None, obs):
        assert stepstats.scaling_block(meas, observatory=o) == \
            jss.scaling_block(meas, observatory=o)


def test_estimate_clock_offset_matches_jax():
    for args in ((10.0, 4.0, 10.2), (0.5, 1.5, 0.7)):
        assert stepstats.estimate_clock_offset(*args) == \
            jss.estimate_clock_offset(*args)


def test_sidecar_over_loopback_measures_an_injected_skew():
    """A client whose clock runs 7 s ahead ships its breakdowns to the
    leader over the socket; the handshake measures the offset, and the
    leader merges the worker's steps."""
    agg = stepstats.StepStatsAggregator(1, port=0)
    try:
        import time
        client = stepstats.StepStatsClient(
            "127.0.0.1", agg.port, worker=0,
            clock=lambda: time.time() + 7.0)
        try:
            assert client.clock_offset_s == pytest.approx(7.0, abs=0.5)
            c = stepstats.collector()
            c.add_sink(client.ship)
            c.close_step("MultiLayerNetwork", 0, 0.01)
            c.close_step("MultiLayerNetwork", 1, 0.01)
            deadline = time.time() + 10
            while agg.report()["steps_merged"] < 2 and \
                    time.time() < deadline:
                time.sleep(0.01)
            rep = agg.report()
            assert rep["steps_merged"] == 2
            assert rep["worker_clock_offsets_s"][0] == pytest.approx(
                client.clock_offset_s)
        finally:
            stepstats.collector().remove_sink(client.ship)
            client.close()
    finally:
        agg.close()


def test_profile_capture_writes_and_merges_a_torch_profiler_trace(
        tmp_path):
    out = tmp_path / "cap"
    st = stepstats.ProfileCapture.start(2, out_dir=str(out))
    assert st["active"] and st["torch_profiler"]
    with pytest.raises(stepstats.CaptureActiveError):
        stepstats.ProfileCapture.start(1, out_dir=str(tmp_path / "x"))
    import torch
    c = stepstats.collector()
    for i in range(2):
        with telemetry.step_span("MultiLayerNetwork") as sp:
            torch.ones(64, 64) @ torch.ones(64, 64)
        stepstats.close_step("MultiLayerNetwork", i, sp)
    last = stepstats.ProfileCapture.current_status()
    assert not last["active"] and last["last"]["reason"] == "complete"
    assert last["last"]["steps_captured"] == 2
    names = sorted(os.path.basename(p) for p in last["last"]["artifacts"])
    assert names == ["device.trace.json", "merged.trace.json",
                     "observatory.trace.json"]
    merged = json.loads((out / "merged.trace.json").read_text())
    evs = merged["traceEvents"]
    assert any(e.get("name") == "train_step" for e in evs)
    assert any(str(e.get("name", "")).startswith("aten::mm") for e in evs)
    assert len(c.records()) == 2
