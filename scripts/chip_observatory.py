#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 25 (the training observatory and the
repaired data-parallel SameDiff walk) on one card, with phase 24, whose
gloo rank processes run phase 25's two-rank parts.

Builds the kernels, runs ``phase_sd_rest`` (the imported BERT-base on
two gloo ranks, which also run the C5 table's ops and remat under the
mesh) and then ``phase_observatory``: full-width ResNet-50 trained with
the observatory on and off, the numerics watchdog on a NaN input,
``layer_report`` and a profiled capture joined into it. Run from the
root of a checkout, on the machine with the card:

    python3 scripts/chip_observatory.py

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
    print(f"[chip-observatory] torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    sdr = c.phase_sd_rest(torch, label)
    c.phase_observatory(torch, label, sdr=sdr)
    print(f"[chip-observatory] {time.perf_counter() - t0:.1f}s")


if __name__ == "__main__":
    try:
        main()
    except Exception as e:  # noqa: BLE001 — reported as the phase's failure
        import traceback
        traceback.print_exc()
        print(f"chip_observatory: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
