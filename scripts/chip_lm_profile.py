#!/usr/bin/env python3
"""Where a step of ``chip_smoke.py``'s phase 26 spends its time on one
card.

Spawns phase 26's four gloo rank processes (``chip_smoke.LM_WORLD``) on
the card; each, in each layout of ``chip_smoke.LM_LAYOUTS`` at GPT-2
small's widths (``chip_smoke.LM_DIMS``), takes three ``train_step``\\ s:

1. a warm-up step;
2. a step with the mesh's axis collectives timed on the host, the card
   synchronised before each, so a collective's time is its host staging
   and the exchange (with the wait for the group's slower members), not
   the work queued before it;
3. a step under ``torch.profiler`` (CPU and CUDA activities): the union
   of this rank's kernel intervals on the card (its device busy time),
   its kernel count and its copy time.

The four processes' kernels time-share the card, so the card's busy
time in a step is about the sum of the ranks' busy times. Run from the
root of a checkout, on the machine with the card, after the kernels are
built (``python3 -c 'import chip_smoke as c; c.phase_build()'``):

    python3 scripts/chip_lm_profile.py

It prints one ``[lm-profile]`` line a layout and, last, one JSON object
with every rank's numbers, and exits non-zero if a rank fails. ``--cpu``
rehearses it on CPU ranks at a small width (no device time there).
"""
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
WORK = ROOT / "build" / "lm_profile"
#: the width ``--cpu`` rehearses at
CPU_DIMS = dict(vocab_size=512, real_vocab=500, max_len=64, d_model=64,
                n_heads=4, d_ff=128, layers=4, batch=8, t=64)


def _merge(spans):
    """Total length of the union of ``(start, end)`` spans."""
    total, end = 0.0, None
    for s, e in sorted(spans):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _device_time(prof) -> dict:
    kernels, copies = [], []
    for e in prof.events():
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        span = (e.time_range.start, e.time_range.end)
        if "Memcpy" in e.name or "Memset" in e.name:
            copies.append(span)
        else:
            kernels.append(span)
    return {"kernel_busy_ms": _merge(kernels) / 1e3,
            "kernels": len(kernels), "copy_ms": _merge(copies) / 1e3,
            "copies": len(copies)}


def rank_main(work: str, rank: int, device: str) -> None:
    """One rank: both layouts over one gloo world, three steps each (see
    the module docstring); its numbers go to ``work``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as c
    from deeplearning4j_tpu_torch.parallel.mesh import ProcessGroupMesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dims = c.LM_DIMS if device == "cuda" else dict(c.LM_DIMS, **CPU_DIMS)
    ids, labels = c.lm_batch(dims)
    names = list(c.LM_LAYOUTS)
    world_mesh = ProcessGroupMesh(
        f"file://{work}/store", c.LM_WORLD, rank, device=device,
        backend="gloo", timeout_s=600, axes=c.LM_LAYOUTS[names[0]]["axes"])

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    out = {}
    try:
        for i, name in enumerate(names):
            mesh = world_mesh if i == 0 else world_mesh.with_axes(
                c.LM_LAYOUTS[name]["axes"])
            model = c._lm_model(dims, name, mesh)
            params, opt = model.init(seed=c.LM_SEED)
            res = {"coords": dict(zip(mesh.axes, mesh.coords(rank)))}
            sync()
            t0 = time.perf_counter()
            params, opt, _ = model.train_step(params, opt, ids, labels, 0)
            sync()
            res["warmup_ms"] = (time.perf_counter() - t0) * 1e3

            # step 2: the axis collectives timed on the host
            calls = []
            inner = mesh._axis_op

            def timed(rank_, op, t, axis, **kw):
                sync()
                t1 = time.perf_counter()
                r = inner(rank_, op, t, axis, **kw)
                calls.append((op, axis, t.numel() * t.element_size(),
                              time.perf_counter() - t1))
                return r

            mesh._axis_op = timed
            sync()
            t0 = time.perf_counter()
            try:
                params, opt, _ = model.train_step(params, opt, ids, labels,
                                                  1)
                sync()
            finally:
                del mesh._axis_op
            res["timed_step_ms"] = (time.perf_counter() - t0) * 1e3
            res["collective_ms"] = sum(x[3] for x in calls) * 1e3
            res["collectives"] = len(calls)
            res["collective_mb"] = sum(x[2] for x in calls) / 2**20
            by = {}
            for op, axis, nb, sec in calls:
                k = f"{op}/{axis}"
                n, b, ms = by.get(k, (0, 0, 0.0))
                by[k] = (n + 1, b + nb, ms + sec * 1e3)
            res["collective_by_op"] = {
                k: {"calls": n, "mb": b / 2**20, "ms": ms}
                for k, (n, b, ms) in by.items()}

            # step 3: under the profiler
            sync()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                params, opt, _ = model.train_step(params, opt, ids, labels,
                                                  2)
                sync()
                res["profiled_step_ms"] = (time.perf_counter() - t0) * 1e3
            res.update(_device_time(prof))
            out[name] = res
            del params, opt, model, prof
            if device == "cuda":
                torch.cuda.empty_cache()
    finally:
        world_mesh.shutdown()
    (Path(work) / f"rank{rank}.json").write_text(json.dumps(out))


def main(device: str) -> int:
    import torch

    import chip_smoke as c
    if device == "cuda" and not torch.cuda.is_available():
        print("chip_lm_profile: no CUDA device", file=sys.stderr)
        return 2
    label = c.nvidia_smi_line() if device == "cuda" else "cpu"
    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir(parents=True)
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--rank", str(r),
         device],
        cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(c.LM_WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=900)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            print(f"rank {r} exited {p.returncode}:\n{log[-4000:]}",
                  file=sys.stderr)
            return 1
    ranks = [json.loads((WORK / f"rank{r}.json").read_text())
             for r in range(c.LM_WORLD)]
    shutil.rmtree(WORK, ignore_errors=True)
    for name in c.LM_LAYOUTS:
        rs = [r[name] for r in ranks]
        busy = sum(x["kernel_busy_ms"] for x in rs)
        wall = max(x["profiled_step_ms"] for x in rs)
        busy = busy / wall if busy else "not measured"
        print(f"[lm-profile] {name}: timed step ms per rank "
              f"{[round(x['timed_step_ms'], 3) for x in rs]}, of it in the "
              f"axis collectives {[round(x['collective_ms'], 3) for x in rs]}"
              f" ({rs[0]['collectives']} calls, "
              f"{[round(x['collective_mb'], 1) for x in rs]} MB a rank); "
              f"profiled step ms {[round(x['profiled_step_ms'], 3) for x in rs]}"
              f", kernel busy ms {[round(x['kernel_busy_ms'], 3) for x in rs]}"
              f" ({[x['kernels'] for x in rs]} kernels), copies ms "
              f"{[round(x['copy_ms'], 3) for x in rs]}; the card's kernel "
              f"busy share of the profiled step {busy} [{label}]")
    print(json.dumps({"label": label, "ranks": ranks}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--rank":
        rank_main(str(WORK), int(sys.argv[2]), sys.argv[3])
    else:
        sys.exit(main("cpu" if "--cpu" in sys.argv[1:] else "cuda"))
