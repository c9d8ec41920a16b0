#!/usr/bin/env python3
"""Time the training observatory's cost a step on the card, in paired
blocks.

Full-width ResNet-50 (224x224x3, 1000 classes, batch 32, f32) trains
through ``fit`` under four settings of the observatory's gates:

- ``off``: telemetry, the step breakdown, the flight recorder, the
  watchdog and the layer scopes all off;
- ``telemetry``: telemetry on (its counters and spans, on by default
  before the observatory came) and the observatory's gates off;
- ``default``: the defaults (step spans, breakdowns, the flight
  recorder and the layer scopes on, the watchdog off);
- ``watchdog``: the defaults plus the numerics watchdog every step (a
  host read of the loss and the global gradient norm a step).

Blocks of STEPS steps run in the order of ORDER (each setting twice,
mirrored), ROUNDS times, on one network (the gates change nothing
the step computes). Prints each block's median step ms, each setting's
median of its block medians, and each round's paired differences, then
one JSON line. Run from the root of a checkout, on the machine with the
card (it builds the two kernel libraries the step uses):

    python3 scripts/observatory_overhead.py
"""
import concurrent.futures
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

STEPS = 10
ROUNDS = 4
ORDER = ("off", "telemetry", "default", "watchdog", "watchdog", "default",
         "telemetry", "off")


def _set(setting: str) -> None:
    from deeplearning4j_tpu_torch.common import diagnostics, stepstats
    from deeplearning4j_tpu_torch.common.environment import Environment
    from deeplearning4j_tpu_torch.common.telemetry import MetricsRegistry
    obs = setting in ("default", "watchdog")
    env = Environment.get()
    env.numerics_watchdog, env.numerics_sample = setting == "watchdog", 1
    env.extra["layerprof"] = obs
    MetricsRegistry.get().set_enabled(setting != "off")
    stepstats.collector().set_enabled(obs)
    diagnostics.FlightRecorder.get().enabled = obs


def main():
    import torch

    import chip_smoke as c
    from deeplearning4j_tpu_torch.models.zoo import ResNet50
    from deeplearning4j_tpu_torch.ops import cuda_build
    if not torch.cuda.is_available():
        raise SystemExit("observatory_overhead: no CUDA device")
    label = c.nvidia_smi_line()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        list(pool.map(cuda_build.build, ("conv_epilogue", "bn_train")))
    g = torch.Generator().manual_seed(21)
    net = ResNet50(seed=21).init("cuda", generator=g)
    x, y = c.learnable_batch(torch, g, c.BATCH, 224)
    x, y = x.cuda(), y.cuda()
    _set("default")
    c._timed_steps(torch, net, x, y, 3)          # warm up
    blocks = {s: [] for s in ORDER}
    rounds = []
    for r in range(ROUNDS):
        this = {}
        for s in ORDER:
            _set(s)
            _, ms = c._timed_steps(torch, net, x, y, STEPS)
            med = statistics.median(ms)
            blocks[s].append(med)
            this.setdefault(s, []).append(med)
            print(f"[overhead] round {r} {s}: median {med:.3f} ms "
                  f"(steps {[round(m, 3) for m in ms]})")
        rounds.append({s: statistics.mean(v) for s, v in this.items()})
    _set("default")
    summary = {s: statistics.median(v) for s, v in blocks.items()}
    diffs = {k: [rr[k] - rr["telemetry"] for rr in rounds]
             for k in ("off", "default", "watchdog")}
    out = {"label": label, "steps_a_block": STEPS, "rounds": ROUNDS,
           "median_of_block_medians_ms": summary,
           "block_medians_ms": blocks,
           "paired_minus_telemetry_ms": diffs,
           "spread_off_ms": [min(blocks["off"]), max(blocks["off"])]}
    print(f"[overhead] median of block medians {summary}; paired "
          f"differences from telemetry alone {diffs} [{label}]")
    print(json.dumps(out))


if __name__ == "__main__":
    t0 = time.perf_counter()
    main()
    print(f"[overhead] {time.perf_counter() - t0:.1f}s")
