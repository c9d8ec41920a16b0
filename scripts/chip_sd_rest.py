#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 24 (the rest of SameDiff) alone on one
card.

Builds the kernels and runs ``phase_sd_rest``: the imported BERT-base
trained data-parallel on two gloo ranks and a one-rank NCCL group, its
forward exported and called back, and an attention SameDiffLayer
trained inside a ComputationGraph. Run from the root of a checkout, on
the machine with the card:

    python3 scripts/chip_sd_rest.py

It exits with the phase's failure, like ``chip_smoke.py``.
"""
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    import torch

    import chip_smoke as c
    t0 = time.perf_counter()
    label = c.phase_device(torch)["nvidia_smi"]
    c.phase_build()
    print(f"[chip-sd-rest] torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    c.phase_sd_rest(torch, label)
    print(f"[chip-sd-rest] {time.perf_counter() - t0:.1f}s")


if __name__ == "__main__":
    try:
        main()
    except Exception as e:  # noqa: BLE001 — reported as the phase's failure
        import traceback
        traceback.print_exc()
        print(f"chip_sd_rest: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
