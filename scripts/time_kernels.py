#!/usr/bin/env python3
"""Time kernels 3, 5 and 10 of the tree this is run from, on one card.

Kernel 3 (``channel_sums``) and kernel 5 (``bn_bwd_sums``) over the 53
BatchNormalization sites of a batch-32 ResNet-50 step, with each site's
time (kernel 3 also in f16, with its bytes a second and the ticket
levels its geometry takes); kernel 10 (``paged_decode_attention``) over
the 12 sites of a batch-32 GPT-2-small decode step at L = 480, 512 and
1024, f32 and bf16 pools, with the share of the bytes bound. CUDA-graph
replay, as ``chip_smoke.py`` times them. Run from the root of a checkout
(the tree whose kernels are timed), on the machine with the card:

    python3 scripts/time_kernels.py [3] [5] [10]

(no argument: all three). Design variants are timed by running it from
copies of the tree with one constant changed.
"""
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path.cwd()))

import chip_smoke as c  # noqa: E402
from deeplearning4j_tpu_torch.models.zoo import ResNet50  # noqa: E402
from deeplearning4j_tpu_torch.ops import attention_kernels as ak  # noqa: E402
from deeplearning4j_tpu_torch.ops import bn_train as bt  # noqa: E402
from deeplearning4j_tpu_torch.ops import conv_epilogue as ce  # noqa: E402


def site_groups() -> dict:
    """(M, C) -> sites of a batch-32 ResNet-50 step."""
    groups = {}
    for M, C, _ in c.bn_sites(ResNet50().conf(), c.BATCH):
        groups[(M, C)] = groups.get((M, C), 0) + 1
    return groups


def kernel3(g) -> None:
    groups = site_groups()
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        esize = torch.tensor([], dtype=dt).element_size()
        total, bytes_, row = 0.0, 0, []
        for (M, C), n in sorted(groups.items()):
            nb = max(1, int(-(-100e6 // (M * C * esize))))
            xs = [torch.randn(M, C, device="cuda", generator=g).to(dt)
                  for _ in range(nb)]
            it = [0]

            def one():
                it[0] = (it[0] + 1) % nb
                return ce.channel_sums(xs[it[0]])

            ms = c._graph_ms(torch, one)
            by, _ = c._site_costs("channel_sums", M, C, esize, "identity")
            total += n * ms
            bytes_ += n * by
            # ticket levels, where the tree's kernel 3 names its body
            body = getattr(ce, "channel_sums_body", None)
            levels = (body(xs[0]).split(" ticket level")[0][-1] if body
                      else "?")
            row.append(f"[{M},{C}]x{n} {ms * 1e3:.1f}us "
                       f"{by / ms / 1e9:.2f}TB/s L{levels}")
        bound = bytes_ / c.HBM_BYTES_PER_S * 1e3
        print(f"[k3] {str(dt)[6:]} {total:.4f} ms (bound {bound:.4f}, "
              f"{100 * bound / total:.0f} %); " + "; ".join(row))


def kernel5(g) -> None:
    groups = site_groups()
    for dt in (torch.float32, torch.bfloat16):
        total, row = 0.0, []
        for (M, C), n in sorted(groups.items()):
            nb = max(1, int(-(-100e6 // (M * C * 2))))
            xs = [torch.randn(M, C, device="cuda", generator=g).to(dt)
                  for _ in range(nb)]
            ds = [torch.randn(M, C, device="cuda", generator=g).to(dt)
                  for _ in range(nb)]
            m = torch.rand(C, device="cuda", generator=g) - 0.5
            r = torch.rand(C, device="cuda", generator=g) + 0.5
            it = [0]

            def one():
                it[0] = (it[0] + 1) % nb
                return bt.bn_bwd_sums(xs[it[0]], ds[it[0]], m, r)

            ms = c._graph_ms(torch, one)
            total += n * ms
            row.append(f"[{M},{C}] {ms * 1e3:.1f}")
        print(f"[k5] {str(dt)[6:]} {total:.4f} ms; " + "; ".join(row))


def kernel10(g) -> None:
    b, h, d, block, mb = c.BATCH, 12, 64, 16, 64
    for L in (480, 512, 1024):
        for dt in (torch.float32, torch.bfloat16):
            sites = [c._paged_case(torch, b, h, d, block, mb, [L] * b, dt, g)
                     for _ in range(12)]
            esize = torch.tensor([], dtype=dt).element_size()
            by, ops = c._paged_costs(b, h, d, [L] * b, block, mb, esize)
            bound, _ = c._bound(12 * by, 12 * ops, c.F32_FLOPS)
            ms = c._graph_ms(
                torch, lambda: [ak.paged_decode_attention(*s) for s in sites],
                reps=5)
            print(f"[k10] {str(dt)[6:]} L={L} {ms:.4f} ms "
                  f"({100 * bound / ms:.0f} % of the bound)")


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("time_kernels: no CUDA device")
    which = sys.argv[1:] or ["3", "5", "10"]
    print(c.nvidia_smi_line())
    gen = torch.Generator(device="cuda").manual_seed(5)
    for k, fn in (("3", kernel3), ("5", kernel5), ("10", kernel10)):
        if k in which:
            fn(gen)
