"""Data-parallel scaling measurement (BASELINE.md protocol step 3:
aggregate throughput at N replicas, efficiency = (aggregate at N /
aggregate at the smallest size) · (smallest / N)).

Counterpart of ``deeplearning4j_tpu/parallel/scaling.py`` over the
port's meshes: weak scaling (the per-replica batch fixed), each size a
``ParallelWrapper`` over the first N devices, a fixed number of timed
steps after a warm-up, the device synchronised before each clock read.
On CPU replicas the numbers check only the machinery; a scaling number
comes from a run over N cards.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Sequence

import torch

from deeplearning4j_tpu_torch.parallel.mesh import (DEFAULT_DATA_AXIS,
                                                    cuda_devices, make_mesh)
from deeplearning4j_tpu_torch.parallel.wrapper import ParallelWrapper


def measure_dp_scaling(model_factory: Callable[[], object],
                       make_batch: Callable[[int], object],
                       chip_counts: Sequence[int],
                       *, per_chip_batch: int = 8, steps: int = 10,
                       warmup: int = 2,
                       devices: Optional[Sequence] = None) -> Dict:
    """Time data-parallel training at each mesh size.

    - ``model_factory()`` -> a fresh MultiLayerNetwork/ComputationGraph
      on the first device
    - ``make_batch(global_batch)`` -> a DataSet of that many examples
    - ``chip_counts``: the replica counts, e.g. (1, 2, 4, 8)

    Returns ``{"sizes": [...], "throughput": {n: examples/s},
    "efficiency": {n: against the smallest}, "base": n0}``."""
    devices = list(devices if devices is not None else cuda_devices())
    sizes = [int(n) for n in chip_counts if n <= len(devices)]
    if not sizes:
        raise ValueError(f"no chip_counts fit {len(devices)} devices")
    throughput: Dict[int, float] = {}
    for n in sizes:
        mesh = make_mesh({DEFAULT_DATA_AXIS: n}, devices[:n])
        net = model_factory()
        pw = ParallelWrapper(net, mesh)
        ds = make_batch(n * per_chip_batch)
        for _ in range(warmup):
            pw.fit_batch(ds)
        _sync(net, mesh.devices)
        t0 = time.perf_counter()
        for _ in range(steps):
            pw.fit_batch(ds)
        _sync(net, mesh.devices)
        throughput[n] = steps * _batch_size(ds) / (time.perf_counter() - t0)
    base = min(sizes)
    efficiency = {n: (throughput[n] / throughput[base]) * (base / n)
                  for n in sizes}
    return {"sizes": sizes, "throughput": throughput,
            "efficiency": efficiency, "base": base}


def _batch_size(ds) -> int:
    f = ds.features
    f = f[0] if isinstance(f, (list, tuple)) else f
    return int(f.shape[0])


def _sync(net, devices) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)
    float(net.score())


def scaling_report(result: Dict) -> str:
    """A table: replicas, examples/s, efficiency."""
    lines = [f"{'chips':>6} {'examples/sec':>14} {'efficiency':>11}"]
    for n in result["sizes"]:
        lines.append(f"{n:>6} {result['throughput'][n]:>14.1f} "
                     f"{result['efficiency'][n]:>10.1%}")
    return "\n".join(lines)
