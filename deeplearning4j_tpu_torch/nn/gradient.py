"""Gradient normalization and clipping.

Counterpart of ``deeplearning4j_tpu/nn/gradient.py``: the same
``GradientNormalization`` modes over one layer's ``{name: gradient}``
dict, applied in the update tail before the updater.
"""
from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nn.conf.builders import GradientNormalization


def _global_l2(grads: dict) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(g * g) for g in grads.values())
                      + 1e-12)


def apply_gradient_normalization(kind: GradientNormalization,
                                 threshold: float, grads: dict) -> dict:
    """grads: one layer's param-name -> gradient dict."""
    if kind is GradientNormalization.NONE or not grads:
        return grads
    if kind is GradientNormalization.RENORMALIZE_L2_PER_LAYER:
        n = _global_l2(grads)
        return {k: g / n for k, g in grads.items()}
    if kind is GradientNormalization.RENORMALIZE_L2_PER_PARAM_TYPE:
        return {k: g / torch.sqrt(torch.sum(g * g) + 1e-12)
                for k, g in grads.items()}
    if kind is GradientNormalization.CLIP_ELEMENT_WISE_ABSOLUTE_VALUE:
        return {k: torch.clamp(g, -threshold, threshold)
                for k, g in grads.items()}
    if kind is GradientNormalization.CLIP_L2_PER_LAYER:
        scale = torch.clamp(threshold / _global_l2(grads), max=1.0)
        return {k: g * scale for k, g in grads.items()}
    if kind is GradientNormalization.CLIP_L2_PER_PARAM_TYPE:
        return {k: g * torch.clamp(
                    threshold / torch.sqrt(torch.sum(g * g) + 1e-12),
                    max=1.0)
                for k, g in grads.items()}
    raise ValueError(kind)
