#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 23 (the serving fleet) alone on one card.

Builds the kernels, imports the frozen Keras ResNet-50 with
``run_import`` as phase 22 does (without phase 22's checks and
training) and runs ``phase_fleet`` on it. Run from the root of a
checkout, on the machine with the card:

    python3 scripts/chip_fleet.py

It exits with the phase's failure, like ``chip_smoke.py``.
"""
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    import torch

    import chip_smoke as c
    from deeplearning4j_tpu_torch.modelimport.tensorflow import (
        TensorflowFrameworkImporter, resnet_graph)
    t0 = time.perf_counter()
    label = c.phase_device(torch)["nvidia_smi"]
    c.phase_build()
    r = c.TF_RESNET
    gd = resnet_graph.build_resnet50_graph(r["image"], r["classes"],
                                           r["batch"], seed=r["seed"])
    sd = TensorflowFrameworkImporter.run_import(
        gd, {"x": (r["batch"], r["image"], r["image"], 3)})
    c.phase_fleet(torch, label, sd=sd)
    print(f"[chip-fleet] {time.perf_counter() - t0:.1f}s")


if __name__ == "__main__":
    main()
