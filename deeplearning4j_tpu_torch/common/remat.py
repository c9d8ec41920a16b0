"""Segment plans for sqrt(N) activation checkpointing.

A copy of ``deeplearning4j_tpu/common/remat.py`` (framework-free). The
three training walks, the MultiLayerNetwork layer stack, the
ComputationGraph topo walk and the SameDiff op walk, cut their walk
into contiguous segments and wrap every segment but the last (it holds
the loss head: nothing to save past it) in
``torch.utils.checkpoint.checkpoint``, so only the values that cross a
segment boundary are kept for the backward; a segment's interior is
recomputed from them. This module is the one source of the cut points
and the wrap policy.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


def segment_plan(n_items: int, n_segments: int
                 ) -> List[Tuple[int, int, bool]]:
    """``[(lo, hi, wrap), ...]`` covering ``range(n_items)`` in
    ``min(n_segments, n_items)`` contiguous segments; ``wrap`` is
    True for every segment but the last. ``n_segments`` above the
    item count clamps to per-item checkpointing."""
    n_seg = min(int(n_segments), int(n_items))
    bounds = np.linspace(0, n_items, n_seg + 1).astype(int)
    return [(int(bounds[i]), int(bounds[i + 1]), i + 1 < n_seg)
            for i in range(n_seg)]


def min_cut_segment_plan(n_items: int, n_segments: int,
                         cut_cost) -> List[Tuple[int, int, bool]]:
    """``segment_plan`` with boundary placement by liveness: instead
    of fixed even indices, each interior boundary lands on the
    LOWEST-``cut_cost`` index within a window around its even
    position (ties break toward the even cut). ``cut_cost[c]`` is
    the cost of cutting before walk item ``c`` — e.g. the number of
    live values that would have to be stored across that boundary.

    Why: a flat imported transformer has ~hundreds of ops per layer;
    even cuts land mid-attention where q/k/v/scores (O(t^2)) are all
    live and must be SAVED, which is precisely what checkpointing
    exists to avoid. Layer boundaries — where only the hidden state
    crosses — are liveness minima, and this plan finds them without
    knowing what a "layer" is."""
    base = segment_plan(n_items, n_segments)   # even skeleton + wrap
    n_seg = len(base)
    if n_seg <= 1:
        return base
    cost = np.asarray(cut_cost, dtype=np.float64)
    even = [lo for lo, _, _ in base] + [n_items]
    spacing = n_items / n_seg
    half = max(1, int(spacing // 2) - 1)
    bounds = [0]
    for k in range(1, n_seg):
        center = int(even[k])
        lo = max(bounds[-1] + 1, center - half)
        hi = min(n_items - (n_seg - k), center + half)
        cands = range(lo, hi + 1)
        best = min(cands,
                   key=lambda c: (cost[c], abs(c - center)))
        bounds.append(int(best))
    bounds.append(n_items)
    return [(bounds[i], bounds[i + 1], base[i][2])
            for i in range(n_seg)]
