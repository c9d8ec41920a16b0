"""Scaled dot-product attention: the dense path and the flash dispatch.

Counterpart of ``deeplearning4j_tpu/ops/attention.py``. Masks are key
masks broadcastable to ``[..., t_q, t_k]``, 0 = masked: masked scores
are ``NEG_INF = -1e9`` before the softmax and their weights are zeroed
after it, so a row whose keys are all masked gives zeros.

Sites with no additive bias and no attention-probability dropout go to
the flash kernels when ``ops/attention_kernels.py``'s ladder takes them
(on the card, by default); everything else runs the dense chain here.
"""
from __future__ import annotations

from typing import Optional

import torch

from deeplearning4j_tpu_torch.ops.attention_kernels import maybe_flash_sdpa

NEG_INF = -1e9


def dot_product_attention(q, k, v, mask=None, scale=None,
                          dropout_generator: Optional[torch.Generator] = None,
                          dropout_rate: float = 0.0, bias=None):
    """Scaled dot-product attention on ``[..., t, d]`` tensors.

    ``dropout_generator``/``dropout_rate``: dropout on the post-softmax
    weights, drawn from the explicit generator (on the tensors' device).
    ``bias``: an additive pre-softmax score bias."""
    if bias is None and (dropout_generator is None or dropout_rate == 0.0):
        out = maybe_flash_sdpa(q, k, v, scale, mask=mask)
        if out is not None:
            return out
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    scores = torch.matmul(q, k.transpose(-1, -2)) * scale
    if bias is not None:
        scores = scores + bias
    if mask is not None:
        scores = torch.where(mask > 0, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    if mask is not None:
        w = torch.where(mask > 0, w, 0.0)
    if dropout_generator is not None and dropout_rate > 0.0:
        keep = torch.rand(w.shape, generator=dropout_generator,
                          device=w.device) < 1.0 - dropout_rate
        w = torch.where(keep, w / (1.0 - dropout_rate), 0.0)
    return torch.matmul(w, v)


def split_heads(a, n_heads: int):
    b, t, _ = a.shape
    return a.reshape(b, t, n_heads, -1).transpose(1, 2)


def merge_heads(a):
    b, h, t, dh = a.shape
    return a.transpose(1, 2).reshape(b, t, h * dh)


def multi_head_attention(params, q_in, kv_in, n_heads: int, key_mask=None):
    """Projected multi-head attention. params: Wq/Wk/Wv ``[*, h·dh]``, Wo
    ``[h·dh, n_out]``; optional biases bq/bk/bv ``[h·dh]`` and bo
    ``[n_out]``. q_in ``[b, tq, dq]``, kv_in ``[b, tk, dk]``, key_mask
    ``[b, tk]`` or None."""
    def proj(x, w, b):
        y = x @ params[w]
        return y + params[b] if b in params else y

    q = split_heads(proj(q_in, "Wq", "bq"), n_heads)
    k = split_heads(proj(kv_in, "Wk", "bk"), n_heads)
    v = split_heads(proj(kv_in, "Wv", "bv"), n_heads)
    m = key_mask[:, None, None, :] if key_mask is not None else None
    o = dot_product_attention(q, k, v, m)
    out = merge_heads(o) @ params["Wo"]
    return out + params["bo"] if "bo" in params else out
