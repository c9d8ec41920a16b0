#!/bin/bash
# Time the port's kernels of two trees on one card, in turns: parent,
# this tree, this tree, parent. Run from the root of this tree, on the
# machine with the card:
#
#     bash scripts/chip_ab_kernels.sh checkout/parent [log-dir] [phases|sums]
#
# where checkout/parent holds the other tree (e.g. `git archive <commit>`
# unpacked there). Each tree builds its own kernels. With `phases` (the
# default) each tree runs its own `chip_smoke.phase_pointwise`,
# `phase_train_kernels` and `phase_paged_kernel`, and this tree's
# `chip_smoke.phase_kernel_paths` runs against each tree's package (it
# uses only entry points every tree has); the summary lines are printed:
# kernel 4's, 2's and 6's totals, kernel 3's and 5's totals and sites,
# kernel 10's `[paged]` timings and the paths' busy times. With `sums`
# each tree builds only bn_train and conv_epilogue and runs its own
# `scripts/time_kernels.py 3 5` (kernels 3 and 5 over the 53 sites of a
# batch-32 ResNet-50 step). Logs go to log-dir (by default
# build/chip_ab/). Last, each tree's kernels 2, 3 and 5 sum the same
# seeded inputs at the site shapes (with their activations) in f32, bf16
# and f16, and the script says whether their bits agree.
set -u
PARENT=$(cd "$1" && pwd)
ROOT=$(pwd)
OUT=$ROOT/${2:-build/chip_ab}
WHAT=${3:-phases}
mkdir -p "$OUT"
libs='"matmul_epilogue", "bn_train", "conv_epilogue", "paged_attention"'
[ "$WHAT" = sums ] && libs='"bn_train", "conv_epilogue"'
build="import concurrent.futures as f
from deeplearning4j_tpu_torch.ops import cuda_build as b
list(f.ThreadPoolExecutor(4).map(b.build, [$libs]))
print({k: round(v['seconds'], 1) for k, v in b.build_info.items()})"
python3 -c "$build" > "$OUT/build_new.log" 2>&1 &
(cd "$PARENT" && python3 -c "$build" > "$OUT/build_parent.log" 2>&1) &
wait
phases='import torch, chip_smoke as c
c.phase_pointwise(torch)
c.phase_train_kernels(torch)
c.phase_paged_kernel(torch)'
paths="import torch, importlib.util as u
s = u.spec_from_file_location('chip_smoke_ab', '$ROOT/chip_smoke.py')
c = u.module_from_spec(s)
s.loader.exec_module(c)
c.phase_kernel_paths(torch, c.nvidia_smi_line())"
i=0
for tree in parent new new parent; do
  i=$((i + 1))
  dir=$ROOT
  [ "$tree" = parent ] && dir=$PARENT
  log=$OUT/${WHAT}${i}_${tree}.log
  if [ "$WHAT" = sums ]; then
    (cd "$dir" && timeout 300 python3 scripts/time_kernels.py 3 5) \
      > "$log" 2>&1
    echo "run $i $tree rc=$?"
    grep -E '^\[k3\]|^\[k5\]|W$' "$log" | cut -c1-400
    continue
  fi
  (cd "$dir" \
    && nvidia-smi --query-gpu=name,power.limit --format=csv,noheader \
    && timeout 600 python3 -c "$phases" \
    && timeout 400 python3 -c "$paths") > "$log" 2>&1
  echo "run $i $tree rc=$?"
  grep -E 'forward, 17 sites|(bn_bwd_dx|epilogue_backward) [a-z0-9]*, 53' \
    "$log" | cut -c1-200
  grep -E -A1 '(bn_bwd_sums|channel_sums) [a-z0-9]*, 53' "$log" \
    | grep -v '^--' | cut -c1-900
  grep -E '^\[paged\] [a-z0-9]+ pool, L=|^\[paths\]' "$log" | cut -c1-300
done
bits="import sys, torch, chip_smoke as c
from deeplearning4j_tpu_torch.models.zoo import ResNet50
from deeplearning4j_tpu_torch.ops import bn_train as bt
from deeplearning4j_tpu_torch.ops import conv_epilogue as ce
g = torch.Generator(device='cuda').manual_seed(29)
out = {}
for M, C, act in sorted(set(c.bn_sites(ResNet50().conf(), c.BATCH))):
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        x, dy = (torch.randn(M, C, device='cuda', generator=g).to(dt)
                 for _ in range(2))
        v = [torch.randn(C, device='cuda', generator=g) for _ in range(2)]
        key = f'{M}x{C} {act} {dt}'
        out['k2 ' + key] = torch.stack(ce.epilogue_backward(
            x, dy, v[0], v[1], act)[1:]).cpu()
        out['k3 ' + key] = ce.channel_sums(x).cpu()
        out['k5 ' + key] = torch.stack(bt.bn_bwd_sums(
            x, dy, v[0], v[1].abs() + 0.5)).cpu()
torch.save(out, sys.argv[1])"
(cd "$PARENT" && python3 -c "$bits" "$OUT/bits_parent.pt")
python3 -c "$bits" "$OUT/bits_new.pt"
python3 -c "import sys, torch
a, b = (torch.load(p) for p in sys.argv[1:])
for k in ('k2', 'k3', 'k5'):
    same = all(torch.equal(a[n], b[n]) for n in a if n.startswith(k))
    n = sum(key.startswith(k) for key in a)
    print(f'[bits] kernel {k[1]}, this tree vs parent at {n} (site shape, '
          f'activation, dtype) cases: bitwise equal {same}')" \
  "$OUT/bits_parent.pt" "$OUT/bits_new.pt"
