"""Flash-attention dispatch for scaled dot-product attention sites.

Counterpart of the flash half of
``deeplearning4j_tpu/ops/attention_pallas.py`` (the paged-decode half
is not ported yet): :func:`as_key_mask` reduces a broadcastable mask to
the ``[b, t_k]`` key mask the kernels stream, :func:`select_attention_backend`
runs the ``attention`` family of ``ops/kernel_select.py``, and
:func:`flash_sdpa` adapts a site to the kernels of
``parallel/sequence.py``: any scale is folded into q (the kernels
hard-wire ``1/√d``) and rank-3 inputs get a unit heads axis.

The ladder keeps the JAX package's structural rungs, in its order: an
additive bias, a rank other than 3 or 4, a q/k head-dim mismatch, a mask
that is not a key mask. Its TPU gates (a 4096-key floor, HBM headroom,
"platform is tpu") do not carry over: the auto rung takes the kernels
for every admissible site on the card and the dense path on the CPU.
``DL4J_TORCH_FLASH_ATTENTION=0`` (or ``Environment.extra
["flash_attention"]``) is the explicit kill switch to the dense path of
``ops/attention.py``; ``=1`` forces the kernels' route anywhere (on the
CPU: their plain versions).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch

from deeplearning4j_tpu_torch.ops import kernel_select
from deeplearning4j_tpu_torch.parallel.sequence import flash_attention


def as_key_mask(mask: torch.Tensor, batch: int, t_k: int, rank: int
                ) -> Optional[torch.Tensor]:
    """Reduce a mask broadcastable against ``[b, (h,) t_q, t_k]`` scores
    to the ``[b, t_k]`` key mask, or None when it varies per query or
    head (right-aligned broadcasting, the dense path's semantics)."""
    if mask.dim() == 0 or mask.dim() > rank:
        return None
    ms = tuple(mask.shape)
    if ms[-1] != t_k:
        return None
    if mask.dim() >= 2 and ms[-2] != 1:
        return None             # per-query mask: not streamable
    lead = 1
    for i, dim in enumerate(ms[:-2] if mask.dim() >= 2 else ()):
        axis_from_right = mask.dim() - i
        if axis_from_right == rank:          # the batch axis
            if dim not in (1, batch):
                return None
            lead = dim
        elif dim != 1:                       # a head or query axis
            return None
    return mask.reshape(lead, t_k).expand(batch, t_k)


def select_attention_backend(q_shape: Tuple[int, ...],
                             k_shape: Tuple[int, ...], *,
                             mask_ok: bool = True,
                             has_bias: bool = False,
                             device: Union[str, torch.device] = "cuda",
                             override=None,
                             use_env_override: bool = True
                             ) -> Tuple[str, str]:
    """``("flash" | "dense", reason)`` for an attention site on
    ``device``; ``override`` exists for tests (default: the live
    ``DL4J_TORCH_FLASH_ATTENTION`` gate)."""
    structural = None
    if has_bias:
        structural = "additive bias is not streamable"
    elif len(q_shape) not in (3, 4) or len(k_shape) != len(q_shape):
        structural = f"rank {len(q_shape)} not supported"
    elif q_shape[-1] != k_shape[-1]:
        structural = "q/k head-dim mismatch"
    elif not mask_ok:
        structural = "mask is not a key mask"
    if override is None and use_env_override:
        override = kernel_select.gate_override("attention")
    dev = torch.device(device)

    def auto():
        if dev.type == "cuda":
            return True, "auto: cuda, the flash kernels are the path"
        return False, f"auto: device '{dev.type}' runs the dense path"

    sel = kernel_select.select("attention", structural=structural,
                               auto=auto, override=override,
                               use_env_override=False)
    return ("flash" if sel.fused else "dense"), sel.reason


def flash_sdpa(q, k, v, scale: Optional[float] = None,
               key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``softmax(q kᵀ · scale, masked) v`` on the flash kernels; q/k/v
    ``[b, h, t, d]`` or ``[b, t, d]``, key_mask ``[b, t_k]`` (0 =
    masked) or None. Differentiable."""
    squeeze_heads = q.dim() == 3
    if squeeze_heads:
        q, k, v = q[:, None], k[:, None], v[:, None]
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    factor = float(scale) * math.sqrt(d)
    if abs(factor - 1.0) > 1e-9:
        # the kernels scale scores by 1/sqrt(d): fold the requested scale
        # into q, so q'kᵀ/sqrt(d) == q kᵀ·scale
        q = q * torch.tensor(factor, dtype=q.dtype, device=q.device)
    out = flash_attention(q, k, v, False, key_mask)
    return out[:, 0] if squeeze_heads else out


def maybe_flash_sdpa(q, k, v, scale: Optional[float] = None, mask=None,
                     bias=None) -> Optional[torch.Tensor]:
    """The flash result when the ladder takes the site, else None (the
    caller runs the dense path)."""
    km, mask_ok = None, True
    if mask is not None:
        km = as_key_mask(mask, int(q.shape[0]), int(k.shape[-2]), q.dim())
        mask_ok = km is not None
    backend, _ = select_attention_backend(
        tuple(q.shape), tuple(k.shape), mask_ok=mask_ok,
        has_bias=bias is not None, device=q.device)
    if backend != "flash":
        return None
    return flash_sdpa(q, k, v, scale, key_mask=km)
