#!/usr/bin/env python3
"""Time kernel 4 (``matmul_bias_act``, relu) beside ``_addmm_activation``
at chosen [M, K] x [N] shapes on one card, and name the body each shape
takes. CUDA-graph replay over rotating inputs larger than the L2 cache,
as ``chip_smoke.phase_pointwise`` times the SqueezeNet sites. Run from
the root of a checkout, on the machine with the card:

    python3 scripts/bench_matmul_shapes.py                 # the defaults
    python3 scripts/bench_matmul_shapes.py 100352,16,64 6272,512,1000 \\
        --dtype float32
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from deeplearning4j_tpu_torch.ops import conv_epilogue as ce  # noqa: E402

#: narrow and wide K at N = 64 and 16, the expand and classifier sites
DEFAULT_SHAPES = ["100352,16,64", "100352,32,64", "100352,48,64",
                  "100352,64,64", "100352,128,64", "100352,16,16",
                  "100352,64,16", "100352,32,128", "100352,64,128",
                  "25088,48,192", "25088,64,192", "6272,64,256",
                  "6272,512,1000", "6272,512,64", "25088,64,256"]


def time_shape(M: int, K: int, N: int, dtype: torch.dtype) -> str:
    g = torch.Generator(device="cuda").manual_seed(0)
    esize = torch.tensor([], dtype=dtype).element_size()
    n_buf = max(1, int(-(-100e6 // (M * K * esize))))
    xs = [torch.randn(M, K, device="cuda", generator=g).to(dtype)
          for _ in range(n_buf)]
    w = (torch.randn(N, K, device="cuda", generator=g) / K ** 0.5).to(dtype)
    b = 0.1 * torch.randn(N, device="cuda", generator=g)
    it = {"i": 0}

    def nxt():
        it["i"] = (it["i"] + 1) % n_buf
        return xs[it["i"]]

    k_ms = chip_smoke._graph_ms(
        torch, lambda: ce.matmul_bias_act_forward(nxt(), w, b, "relu"))
    l_ms = chip_smoke._graph_ms(
        torch, lambda: torch._addmm_activation(b.to(dtype), nxt(), w.t()))
    moved = (M * K + N * K + M * N) * esize
    return (f"[{M},{K}]x[{N}] {str(dtype)[6:]}: kernel {k_ms * 1e3:.1f} us "
            f"({moved / k_ms / 1e6:.0f} GB/s) lib {l_ms * 1e3:.1f} us | "
            f"{ce.matmul_bias_act_body(xs[0], w)}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("shapes", nargs="*", default=DEFAULT_SHAPES,
                    help="M,K,N triples")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["float32", "bfloat16", "float16"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_matmul_shapes: no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke.nvidia_smi_line())
    for shape in args.shapes:
        M, K, N = (int(v) for v in shape.split(","))
        print(time_shape(M, K, N, getattr(torch, args.dtype)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
