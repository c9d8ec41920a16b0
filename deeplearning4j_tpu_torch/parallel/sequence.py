"""Sequence / context parallelism and flash attention: blockwise, ring
and Ulysses attention over the flash kernels' blocked online-softmax
forward and its log-sum-exp-recomputing backward.

Counterpart of ``deeplearning4j_tpu/parallel/sequence.py``. Three
hand-written CUDA kernels in ``csrc/flash_attention.cu``, each with a
plain PyTorch version beside it:

* ``flash_forward`` (replaces ``_flash_kernel``): ``out = softmax(q kᵀ /
  √d, masked) v`` and the per-row log-sum-exp of the scaled scores;
* ``flash_bwd_dq`` (replaces ``_flash_bwd_dq_kernel``): ``dq = Σ_k
  p·(dO·vᵀ − δ)·k / √d``, p recomputed from the log-sum-exp;
* ``flash_bwd_dkv`` (replaces ``_flash_bwd_dkv_kernel``): ``dv = pᵀ·dO``,
  ``dk = dsᵀ·q / √d``.

On top of them, as in the JAX package:

* :func:`blockwise_attention`: exact attention by online softmax over
  key blocks, O(t) activation memory, plain torch ops;
* :func:`ring_attention`: context parallelism over a mesh axis. Q/K/V
  are sharded along time; K/V shards rotate around the ring (one
  ppermute a step) while each rank folds the visiting shard into its
  accumulator. ``use_flash=True`` runs :func:`flash_attention_with_lse`
  on each visible shard (kernels 7, then 8 and 9 in the backward, on the
  card; their plain versions on the CPU) and merges the normalized
  partials exactly through their log-sum-exps, so the merge's LSE
  cotangent reaches kernels 8 and 9 through δ. The causal ring
  decomposes per shard: earlier shards fully visible, the own shard
  locally causal, later shards skipped (no launch);
* :func:`ulysses_attention`: all-to-all time -> heads, full-sequence
  attention on h/n heads, all-to-all back.

``δ = rowsum(dO·O) − g_lse`` is plain torch ops between the forward and
the two backward kernels, as it is plain jnp in the JAX package. For
bf16 and f16 inputs (head dim up to 128) the forward and dk/dv run on
tensor cores with f32 sums; f32 inputs stay in full f32; any head dim
and float64 run (float64 with f64 sums and f64 lse and δ rows; the
source's header has the design).

Tensors are ``[b, h, t, d]`` with an optional ``[b, tk]`` key mask (a key
is kept where ``mask > 0``). The scale is always ``1/√d``; callers with
another scale fold it into q (``ops/attention_kernels.py:flash_sdpa``).
Masked scores are ``NEG_INF = -1e30`` and the exp of a score ``<=
NEG_INF/2`` is exactly 0, so a fully masked row gives zeros and zero
gradients (PyTorch's SDPA gives NaN there). Each wrapper launches its
kernel on a CUDA tensor (and raises on what it does not take) and runs
the plain version on a CPU tensor; there is no other route.

The differentiable entry points go through three ``torch.library``
custom ops, ``dl4j::flash_fwd`` (-> out, lse), ``dl4j::flash_bwd_dq``
and ``dl4j::flash_bwd_dkv``: each has a fake rule (shapes and dtypes)
and its wrapper as its implementation (the launch on the card, the
plain version on the CPU), and the forward op's autograd rule computes
δ and calls the other two. An op is one node to the dispatcher: its
inner products are not separate torch ops, on the CPU as on the card. Eager code and a ``torch.export`` program (SameDiff's
``export_serialized``) take that one route, with the same launches and
bits; an exported program names the ops, and loading it needs this
module imported.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from deeplearning4j_tpu_torch.common import layerprof
from deeplearning4j_tpu_torch.ops import cuda_build
from deeplearning4j_tpu_torch.parallel.mesh import (P, all_to_all,
                                                    current_replica,
                                                    gather_leaf,
                                                    replica_scope,
                                                    shard_leaf)

NEG_INF = -1e30
#: q/k/v dtypes the kernels read and write, with their codes (sums are
#: f32, f64 for float64)
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
                 torch.float64: 3}

_SOURCE = "deeplearning4j_tpu_torch/csrc/flash_attention.cu"
FLASH_FWD = cuda_build.register(cuda_build.Kernel(
    "flash_fwd", source=_SOURCE,
    replaces="deeplearning4j_tpu/parallel/sequence.py:164 (_flash_kernel)"))
FLASH_BWD_DQ = cuda_build.register(cuda_build.Kernel(
    "flash_bwd_dq", source=_SOURCE,
    replaces="deeplearning4j_tpu/parallel/sequence.py:319 "
             "(_flash_bwd_dq_kernel)"))
FLASH_BWD_DKV = cuda_build.register(cuda_build.Kernel(
    "flash_bwd_dkv", source=_SOURCE,
    replaces="deeplearning4j_tpu/parallel/sequence.py:369 "
             "(_flash_bwd_dkv_kernel)"))


def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def _scale(d: int) -> float:
    return 1.0 / math.sqrt(d)


def flash_cost(name: str, q, k, key_mask, causal: bool
               ) -> Tuple[float, float]:
    """(bytes, operations) of one call of kernel ``name`` (7, 8 or 9)
    on ``[b, h, t, d]`` operands: each input read once and each output
    written once (the f32 key mask and the lse / delta rows in the
    accumulation dtype included); 2 operations a multiply-add over the
    (query, key) pairs the causal mask keeps."""
    b, h, tq, d = (int(s) for s in q.shape)
    tk = int(k.shape[-2])
    e = q.element_size()
    q_side, k_side = b * h * tq * d * e, b * h * tk * d * e
    mask = 0 if key_mask is None else int(key_mask.numel()) * 4
    rows = b * h * tq * max(4, e)
    m = min(tq, tk)
    pairs = m * (m + 1) // 2 + (tq - m) * tk if causal else tq * tk
    ops = b * h * pairs * d
    if name == "flash_fwd":           # q, k, v -> out, lse
        return 2 * q_side + 2 * k_side + mask + rows, 4 * ops
    if name == "flash_bwd_dq":        # q, k, v, dO, lse, delta -> dq
        return 3 * q_side + 2 * k_side + mask + 2 * rows, 6 * ops
    # q, k, v, dO, lse, delta -> dk, dv
    return 2 * q_side + 4 * k_side + mask + 2 * rows, 8 * ops


# ---------------------------------------------------------------------------
# plain versions (the CPU path and the kernels' oracles)
# ---------------------------------------------------------------------------
def _masked_scores(q, k, key_mask, causal: bool):
    """``q kᵀ · scale`` in the accumulation dtype, with the causal and key
    masks applied as NEG_INF: the one definition the three plain versions
    share, as ``_masked_scores`` is in the JAX package."""
    acc = _acc(q.dtype)
    s = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2))
    s = s * _scale(q.shape[-1])
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        keep = (torch.arange(tq, device=s.device)[:, None]
                >= torch.arange(tk, device=s.device)[None, :])
        s = torch.where(keep, s, NEG_INF)
    if key_mask is not None:
        s = torch.where(key_mask[:, None, None, :] > 0, s, NEG_INF)
    return s


def _probs(s, lse):
    return torch.where(s <= NEG_INF / 2, 0.0, torch.exp(s - lse[..., None]))


def flash_forward_plain(q, k, v, key_mask=None, causal: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense, step by step: ``(out, lse)``, out in q's dtype, lse
    ``[b, h, tq]`` in the accumulation dtype; p rounded to v's dtype
    before ``p v``."""
    acc = _acc(q.dtype)
    s = _masked_scores(q, k, key_mask, causal)
    m = s.amax(-1, keepdim=True)
    p = torch.where(s <= NEG_INF / 2, 0.0, torch.exp(s - m))
    lc = torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    o = torch.matmul(p.to(v.dtype).to(acc), v.to(acc)) / lc
    return o.to(q.dtype), (m + torch.log(lc))[..., 0]


def flash_dq_plain(q, k, v, dout, lse, delta, key_mask=None,
                   causal: bool = False) -> torch.Tensor:
    """``dq = (ds·k)·scale`` with ``ds = p·(dO vᵀ − δ)`` rounded to k's
    dtype, in q's dtype."""
    acc = _acc(q.dtype)
    p = _probs(_masked_scores(q, k, key_mask, causal), lse.to(acc))
    dp = torch.matmul(dout.to(acc), v.to(acc).transpose(-1, -2))
    ds = p * (dp - delta.to(acc)[..., None])
    dq = torch.matmul(ds.to(k.dtype).to(acc), k.to(acc)) * _scale(q.shape[-1])
    return dq.to(q.dtype)


def flash_dkv_plain(q, k, v, dout, lse, delta, key_mask=None,
                    causal: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dk, dv)``: ``dv = pᵀ dO`` with p rounded to dO's dtype, ``dk =
    (dsᵀ q)·scale`` with ds rounded to q's dtype."""
    acc = _acc(q.dtype)
    p = _probs(_masked_scores(q, k, key_mask, causal), lse.to(acc))
    dp = torch.matmul(dout.to(acc), v.to(acc).transpose(-1, -2))
    ds = p * (dp - delta.to(acc)[..., None])
    dv = torch.matmul(p.to(dout.dtype).to(acc).transpose(-1, -2),
                      dout.to(acc))
    dk = torch.matmul(ds.to(q.dtype).to(acc).transpose(-1, -2),
                      q.to(acc)) * _scale(q.shape[-1])
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_delta(out, dout, g_lse=None) -> torch.Tensor:
    """``δ = rowsum(dO·O) − g_lse`` in the accumulation dtype: the
    softmax-Jacobian row term, with the log-sum-exp cotangent folded in
    (``∂lse/∂s = p``)."""
    acc = _acc(out.dtype)
    delta = (dout.to(acc) * out.to(acc)).sum(-1)
    if g_lse is not None:
        delta = delta - g_lse.to(acc)
    return delta


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
_P, _I64, _INT, _F = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                      ctypes.c_float)


def _check(fn: str, q, k, v, key_mask, extra=()) -> Tuple[int, ...]:
    """Validate the kernels' operands on the card; returns (b, h, tq, tk,
    d). Raises on what the kernels do not take."""
    if q.device.type != "cuda":
        raise ValueError(f"{fn}: no kernel for device {q.device}")
    if q.dtype not in KERNEL_DTYPES:
        raise TypeError(f"{fn}: dtype {q.dtype} is not one of "
                        f"{tuple(KERNEL_DTYPES)}")
    if q.dim() != 4:
        raise ValueError(f"{fn}: q must be [b, h, t, d], got "
                         f"{tuple(q.shape)}")
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if k.shape != (b, h, tk, d) or v.shape != (b, h, tk, d):
        raise ValueError(f"{fn}: k and v must be [{b}, {h}, tk, {d}], got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    for nm, t in (("k", k), ("v", v)) + tuple(extra):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{fn}: {nm} must be {q.dtype} on {q.device}, "
                             f"got {t.dtype} on {t.device}")
    if key_mask is not None and (key_mask.shape != (b, tk)
                                 or key_mask.device != q.device):
        raise ValueError(f"{fn}: key mask must be [{b}, {tk}] on "
                         f"{q.device}, got {tuple(key_mask.shape)} on "
                         f"{key_mask.device}")
    if min(b, h, tq, tk, d) == 0:
        raise ValueError(f"{fn}: empty operand {tuple(q.shape)} x "
                         f"{tuple(k.shape)}")
    return b, h, tq, tk, d


def _mask_ptr(key_mask):
    """The key mask as a contiguous f32 tensor and its pointer, or (None,
    None). The caller holds the tensor across the launch; once it is
    freed, the allocator reuses its memory only for work queued after
    the kernel on the same stream."""
    if key_mask is None:
        return None, None
    m = key_mask.to(torch.float32).contiguous()
    return m, m.data_ptr()


def _raise_on_error(fn: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{fn}: CUDA launch failed with cudaError {rc}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_forward(q, k, v, key_mask=None, causal: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 7 on a CUDA q, the plain version on a CPU q: ``(out,
    lse)``, lse ``[b, h, tq]`` in the accumulation dtype (f32, f64 for
    float64)."""
    if q.device.type == "cpu":
        return flash_forward_plain(q, k, v, key_mask, causal)
    b, h, tq, tk, d = _check("flash_forward", q, k, v, key_mask)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lse = torch.empty(b, h, tq, dtype=_acc(q.dtype), device=q.device)
    mask, mask_p = _mask_ptr(key_mask)
    fn = cuda_build.c_function(
        "flash_attention", "dl4j_flash_fwd",
        [_P, _P, _P, _P, _P, _P, _I64, _INT, _INT, _INT, _INT, _F, _INT,
         _INT, _P])
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_p,
                out.data_ptr(), lse.data_ptr(), b * h, h, tq, tk, d,
                _scale(d), int(causal), KERNEL_DTYPES[q.dtype], _stream(q))
    _raise_on_error("flash_forward", rc)
    FLASH_FWD.launched(lambda: flash_cost("flash_fwd", q, k, key_mask,
                                          causal))
    return out, lse


def flash_bwd_dq(q, k, v, dout, lse, delta, key_mask=None,
                 causal: bool = False) -> torch.Tensor:
    """Kernel 8 on a CUDA q, the plain version on a CPU q."""
    if q.device.type == "cpu":
        return flash_dq_plain(q, k, v, dout, lse, delta, key_mask, causal)
    b, h, tq, tk, d = _check("flash_bwd_dq", q, k, v, key_mask,
                             (("dout", dout),))
    q, k, v, dout = (t.contiguous() for t in (q, k, v, dout))
    lse = lse.to(_acc(q.dtype)).contiguous()
    delta = delta.to(_acc(q.dtype)).contiguous()
    dq = torch.empty_like(q)
    mask, mask_p = _mask_ptr(key_mask)
    fn = cuda_build.c_function(
        "flash_attention", "dl4j_flash_bwd_dq",
        [_P, _P, _P, _P, _P, _P, _P, _P, _I64, _INT, _INT, _INT, _INT, _F,
         _INT, _INT, _P])
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), mask_p, dq.data_ptr(),
                b * h, h, tq, tk, d, _scale(d), int(causal),
                KERNEL_DTYPES[q.dtype], _stream(q))
    _raise_on_error("flash_bwd_dq", rc)
    FLASH_BWD_DQ.launched(lambda: flash_cost("flash_bwd_dq", q, k,
                                             key_mask, causal))
    return dq


def flash_bwd_dkv(q, k, v, dout, lse, delta, key_mask=None,
                  causal: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 9 on a CUDA q, the plain version on a CPU q: ``(dk, dv)``."""
    if q.device.type == "cpu":
        return flash_dkv_plain(q, k, v, dout, lse, delta, key_mask, causal)
    b, h, tq, tk, d = _check("flash_bwd_dkv", q, k, v, key_mask,
                             (("dout", dout),))
    q, k, v, dout = (t.contiguous() for t in (q, k, v, dout))
    lse = lse.to(_acc(q.dtype)).contiguous()
    delta = delta.to(_acc(q.dtype)).contiguous()
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    mask, mask_p = _mask_ptr(key_mask)
    fn = cuda_build.c_function(
        "flash_attention", "dl4j_flash_bwd_dkv",
        [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _INT, _INT, _INT, _INT,
         _F, _INT, _INT, _P])
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), mask_p, dk.data_ptr(),
                dv.data_ptr(), b * h, h, tq, tk, d, _scale(d), int(causal),
                KERNEL_DTYPES[q.dtype], _stream(q))
    _raise_on_error("flash_bwd_dkv", rc)
    FLASH_BWD_DKV.launched(lambda: flash_cost("flash_bwd_dkv", q, k,
                                              key_mask, causal))
    return dk, dv


# ---------------------------------------------------------------------------
# the kernels as torch.library custom ops (the differentiable route)
# ---------------------------------------------------------------------------
# Three ops of the ``dl4j`` namespace: ``flash_fwd`` -> (out, lse),
# ``flash_bwd_dq`` and ``flash_bwd_dkv``. Each has a fake rule (shapes and
# dtypes, lse in the accumulation dtype), and its implementation is its
# wrapper: the kernel's launch on a CUDA tensor, the plain version on a
# CPU one. ``flash_fwd``'s autograd rule is δ in torch ops, then ops 8 and
# 9, so eager code and a ``torch.export`` program take one route, and an
# exported program names the kernels instead of tracing into ctypes.
@torch.library.custom_op("dl4j::flash_fwd", mutates_args=())
def flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 key_mask: Optional[torch.Tensor], causal: bool
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    return flash_forward(q, k, v, key_mask, causal)


@flash_fwd_op.register_fake
def _flash_fwd_fake(q, k, v, key_mask, causal):
    return q.new_empty(q.shape), q.new_empty(q.shape[:3],
                                             dtype=_acc(q.dtype))


@torch.library.custom_op("dl4j::flash_bwd_dq", mutates_args=())
def flash_bwd_dq_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    dout: torch.Tensor, lse: torch.Tensor,
                    delta: torch.Tensor, key_mask: Optional[torch.Tensor],
                    causal: bool) -> torch.Tensor:
    return flash_bwd_dq(q, k, v, dout, lse, delta, key_mask, causal)


@flash_bwd_dq_op.register_fake
def _flash_bwd_dq_fake(q, k, v, dout, lse, delta, key_mask, causal):
    return q.new_empty(q.shape)


@torch.library.custom_op("dl4j::flash_bwd_dkv", mutates_args=())
def flash_bwd_dkv_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     dout: torch.Tensor, lse: torch.Tensor,
                     delta: torch.Tensor, key_mask: Optional[torch.Tensor],
                     causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    return flash_bwd_dkv(q, k, v, dout, lse, delta, key_mask, causal)


@flash_bwd_dkv_op.register_fake
def _flash_bwd_dkv_fake(q, k, v, dout, lse, delta, key_mask, causal):
    return k.new_empty(k.shape), v.new_empty(v.shape)


# layer attribution charges each op its kernel's analytic cost (aten
# dispatch does not see into a custom op); the arguments end with
# (key_mask, causal) in all three
for _k in (FLASH_FWD, FLASH_BWD_DQ, FLASH_BWD_DKV):
    layerprof.register_op_cost(
        _k.name, lambda args, _n=_k.name: flash_cost(_n, args[0], args[1],
                                                     args[-2], args[-1]))


def _flash_setup(ctx, inputs, output):
    q, k, v, key_mask, causal = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, key_mask, out, lse)
    ctx.causal = causal


def _flash_backward(ctx, g_out, g_lse):
    """δ (torch ops), then kernels 8 and 9. Both outputs are
    differentiable: the lse cotangent folds into δ (an unused output's
    cotangent arrives as zeros, and ``δ - 0`` is δ bit for bit)."""
    q, k, v, key_mask, out, lse = ctx.saved_tensors
    g_out = g_out.contiguous()
    delta = flash_delta(out, g_out, g_lse)
    dq = flash_bwd_dq_op(q, k, v, g_out, lse, delta, key_mask, ctx.causal)
    dk, dv = flash_bwd_dkv_op(q, k, v, g_out, lse, delta, key_mask,
                              ctx.causal)
    return dq, dk, dv, None, None


flash_fwd_op.register_autograd(_flash_backward, setup_context=_flash_setup)


def _flash_apply(q, k, v, key_mask, causal: bool):
    # heads split from [b, t, h·d] arrive as strided views: copy them
    # once here, so the op saves the copies and neither backward
    # kernel's wrapper copies them again
    return flash_fwd_op(q.contiguous(), k.contiguous(), v.contiguous(),
                        _as_key_mask(key_mask), bool(causal))


def _as_key_mask(key_mask):
    if key_mask is not None and key_mask.dtype == torch.bool:
        return key_mask.to(torch.float32)
    return key_mask


def flash_attention(q, k, v, causal: bool = False,
                    key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused attention over ``[b, h, t, d]``, equal to dense softmax
    attention at scale ``1/√d``; ``key_mask`` ``[b, tk]``, 0 = masked.
    Differentiable: the backward is kernels 8 and 9."""
    return _flash_apply(q, k, v, key_mask, causal)[0]


def flash_attention_with_lse(q, k, v, causal: bool = False,
                             key_mask: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention` that also returns the per-row log-sum-exp
    of the scaled scores, ``[b, h, tq]`` in the accumulation dtype,
    differentiable too."""
    return _flash_apply(q, k, v, key_mask, causal)


# ---------------------------------------------------------------------------
# blockwise (online-softmax) attention: plain torch, differentiable
# ---------------------------------------------------------------------------
def _block_update(carry, qb, kb, vb, mask_b, scale):
    """One online-softmax step: fold a K/V block into ``(o, l, m)``. The
    exp of a masked score is exactly 0, so a fully masked row keeps
    ``l = 0`` and finalizes to zeros."""
    o, l, m = carry
    s = torch.matmul(qb, kb.transpose(-1, -2)) * scale
    if mask_b is not None:
        s = torch.where(mask_b, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(-1))
    corr = torch.exp(m - m_new)
    p = torch.where(s <= NEG_INF / 2, 0.0, torch.exp(s - m_new[..., None]))
    l_new = l * corr + p.sum(-1)
    o_new = o * corr[..., None] + torch.matmul(p, vb)
    return o_new, l_new, m_new


def _finalize(o, l):
    return o / torch.clamp(l, min=1e-30)[..., None]


def _carry(q):
    acc = _acc(q.dtype)
    o = torch.zeros(q.shape, dtype=acc, device=q.device)
    l = o[..., 0].clone()
    return o, l, l + NEG_INF


def blockwise_attention(q, k, v, *, causal: bool = False,
                        block_k: int = 256, q_offset: int = 0,
                        k_offset: int = 0,
                        key_mask: Optional[torch.Tensor] = None):
    """Exact attention with O(t) memory by online softmax over key
    blocks. q: ``[..., tq, d]``; k/v: ``[..., tk, d]``; key_mask
    ``[..., tk]`` (0 = masked); ``q_offset`` / ``k_offset`` are the global
    positions of element 0 (the causal mask uses global positions)."""
    tq, d = q.shape[-2], q.shape[-1]
    tk = k.shape[-2]
    scale = 1.0 / (d ** 0.5)
    block_k = min(block_k, tk)
    n_blocks = -(-tk // block_k)
    pad = n_blocks * block_k - tk
    km = key_mask
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
        km = torch.nn.functional.pad(
            key_mask if key_mask is not None else
            torch.ones(k.shape[:-2] + (tk,), dtype=torch.bool,
                       device=k.device), (0, pad))
    q_pos = q_offset + torch.arange(tq, device=q.device)
    carry = _carry(q)
    for i in range(n_blocks):
        s0 = i * block_k
        kb, vb = k[..., s0:s0 + block_k, :], v[..., s0:s0 + block_k, :]
        mask_b = None
        if causal:
            k_pos = k_offset + s0 + torch.arange(block_k, device=q.device)
            mask_b = q_pos[:, None] >= k_pos[None, :]
        if km is not None:
            kmb = km[..., s0:s0 + block_k][..., None, :]
            mask_b = (kmb != 0) if mask_b is None else (mask_b & (kmb > 0))
        carry = _block_update(carry, q, kb, vb, mask_b, scale)
    o, l, _ = carry
    return _finalize(o, l).to(q.dtype)


# ---------------------------------------------------------------------------
# ring attention: context parallelism over a mesh axis
# ---------------------------------------------------------------------------
class _RingRun:
    """One ring call on one rank: the forward's graph from a leaf of q
    and of each visiting K/V shard to the output, kept for the
    backward."""

    def __init__(self, replica, axis: str, causal: bool, use_flash: bool):
        self.replica, self.axis = replica, axis
        self.causal, self.use_flash = causal, use_flash
        self.n = 1 if replica is None else replica.axis_size(axis)
        self.my = 0 if replica is None else replica.axis_index(axis)

    def rotate(self, t, back: bool = False):
        """One ring step: each rank's tensor to the next (``back``: to
        the previous)."""
        n = self.n
        perm = [(i, (i + 1) % n) for i in range(n)]
        if back:
            perm = [(d, s) for s, d in perm]
        return self.replica.axis_collective("ppermute", t.contiguous(),
                                            self.axis, perm=perm)

    def forward(self, q, k, v):
        n, my = self.n, self.my
        t_local = q.shape[-2]
        scale = 1.0 / (q.shape[-1] ** 0.5)
        acc = _acc(q.dtype)
        q_pos = my * t_local + torch.arange(t_local, device=q.device)
        self.kv = []
        kv = torch.stack([k.detach(), v.detach()])
        with torch.enable_grad():
            self.q = q.detach().requires_grad_()
            o, l, m = _carry(q)
            for s in range(n):
                if s:
                    kv = self.rotate(kv)
                kb = kv[0].clone().requires_grad_()
                vb = kv[1].clone().requires_grad_()
                self.kv.append((kb, vb))
                src = (my - s) % n            # who produced this shard
                if not self.use_flash:
                    mask = None
                    if self.causal:
                        k_pos = src * t_local + torch.arange(
                            t_local, device=q.device)
                        mask = q_pos[:, None] >= k_pos[None, :]
                    o, l, m = _block_update((o, l, m), self.q, kb, vb,
                                            mask, scale)
                    continue
                if self.causal and src > my:
                    # a later shard: fully masked, no launch (its merge
                    # would leave the accumulator as it is)
                    continue
                o_s, lse_s = flash_attention_with_lse(
                    self.q, kb, vb, self.causal and src == my)
                o_s = o_s.to(acc)
                # exact merge of normalized partials via their
                # log-sum-exps; a fully masked row has zero weight
                m_new = torch.maximum(m, lse_s)
                c_old = torch.where(m <= NEG_INF / 2, 0.0,
                                    torch.exp(m - m_new))
                c_new = torch.where(lse_s <= NEG_INF / 2, 0.0,
                                    torch.exp(lse_s - m_new))
                o = o * c_old[..., None] + o_s * c_new[..., None]
                l = l * c_old + c_new
                m = m_new
            self.out = _finalize(o, l).to(q.dtype)
        return self.out.detach()

    def backward(self, g):
        leaves = [self.q] + [t for kv in self.kv for t in kv]
        got = torch.autograd.grad(self.out, leaves, g, allow_unused=True)
        dq = got[0] if got[0] is not None else torch.zeros_like(self.q)
        dkv = [torch.stack([
            got[1 + 2 * s] if got[1 + 2 * s] is not None
            else torch.zeros_like(kb),
            got[2 + 2 * s] if got[2 + 2 * s] is not None
            else torch.zeros_like(vb)])
            for s, (kb, vb) in enumerate(self.kv)]
        # each visiting shard's cotangent travels back to its owner: the
        # transpose of the forward's rotations
        acc = dkv[-1]
        for s in range(self.n - 1, 0, -1):
            acc = self.rotate(acc, back=True) + dkv[s - 1]
        del self.q, self.kv, self.out
        return dq, acc[0], acc[1]


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, run):
        ctx.run = run
        with replica_scope(run.replica):
            return run.forward(q, k, v)

    @staticmethod
    def backward(ctx, g):
        run = ctx.run
        del ctx.run
        with replica_scope(run.replica):
            dq, dk, dv = run.backward(g.contiguous())
        return dq, dk, dv, None


def ring_attention(q, k, v, axis_name: str, *, causal: bool = False,
                   use_flash: bool = False):
    """Attention with Q/K/V sharded along time over ``axis_name`` (call
    inside a replica; q/k/v are the local shards ``[b, h, t_local, d]``).
    K/V shards rotate around the ring, one ppermute a step, and each rank
    folds the visiting shard into its accumulator; causal masking uses
    global positions, so the result equals dense causal attention on the
    gathered sequence. ``use_flash=True`` runs
    :func:`flash_attention_with_lse` on each visible shard and merges the
    partials through their log-sum-exps (the causal decomposition in the
    module docstring); the default folds each shard in with
    :func:`_block_update`. The backward runs each step's backward (kernels
    8 and 9 with the merge's LSE cotangent, under ``use_flash``) and sends
    each shard's K/V cotangent back to its owner. (The JAX signature's
    block sizes are not taken: the kernels tile themselves, and the
    blockwise form folds a whole shard at a time there too.)"""
    run = _RingRun(current_replica(), axis_name, causal, use_flash)
    return _Ring.apply(q, k, v, run)


class _MeshCall(torch.autograd.Function):
    """A sequence-parallel function over global ``[b, h, t, d]`` q/k/v:
    each replica of a thread mesh runs it on its shard (time over the
    sequence axis, batch over ``data``), the outputs put back together;
    the backward runs each replica's backward on its slice of the
    cotangent."""

    @staticmethod
    def forward(ctx, call, q, k, v):
        ctx.call = call
        return call.forward(q, k, v)

    @staticmethod
    def backward(ctx, g):
        call = ctx.call
        del ctx.call
        return (None,) + call.backward(g)


class _SeqShardedCall:
    def __init__(self, local_fn, mesh, seq_axis: str, kw: dict):
        other = {a: s for a, s in mesh.shape.items()
                 if a not in ("data", seq_axis) and s > 1}
        if other or not hasattr(mesh, "run"):
            raise ValueError(f"a sequence-sharded call runs on a thread "
                             f"mesh of the data and {seq_axis!r} axes, "
                             f"got {type(mesh).__name__} {mesh.shape}")
        self.local_fn, self.mesh, self.kw = local_fn, mesh, kw
        self.spec = P("data" if "data" in mesh.shape else None, None,
                      seq_axis, None)
        self.seq_axis = seq_axis

    def _shard(self, t, rank):
        coords = dict(zip(self.mesh.axes, self.mesh.coords(rank)))
        return shard_leaf(t, self.spec, self.mesh.axes, coords).to(
            self.mesh.devices[rank])

    def forward(self, q, k, v):
        mesh = self.mesh
        self.ins, self.outs = [None] * mesh.size, [None] * mesh.size

        def body(r):
            rep = mesh.replica(r)
            ins = [self._shard(t, r).detach().requires_grad_(t.requires_grad)
                   for t in (q, k, v)]
            with replica_scope(rep), torch.enable_grad():
                out = self.local_fn(*ins, self.seq_axis, **self.kw)
            self.ins[r], self.outs[r] = ins, out
            return out.detach()

        outs = mesh.run(body)
        return gather_leaf(outs, self.spec, mesh).to(q.device)

    def backward(self, g):
        mesh = self.mesh

        def body(r):
            ins = [t for t in self.ins[r] if t.requires_grad]
            with replica_scope(mesh.replica(r)):
                got = list(torch.autograd.grad(
                    self.outs[r], ins, self._shard(g, r),
                    allow_unused=True))
            return [got.pop(0) if t.requires_grad else None
                    for t in self.ins[r]]

        per_rank = mesh.run(body)
        grads = []
        for i in range(3):
            shards = [gr[i] for gr in per_rank]
            grads.append(None if shards[0] is None else
                         gather_leaf([s if s is not None else
                                      torch.zeros_like(self.ins[r][i])
                                      for r, s in enumerate(shards)],
                                     self.spec, mesh).to(g.device))
        self.ins = self.outs = None
        return tuple(grads)


def _seq_sharded_call(local_fn, mesh, q, k, v, seq_axis, causal, **kw):
    """The plumbing of the self-attention forms: q/k/v are GLOBAL ``[b,
    h, t, d]`` tensors; time sharded over ``seq_axis``, batch over
    ``data`` when the mesh has it. Differentiable."""
    call = _SeqShardedCall(local_fn, mesh, seq_axis,
                           dict(kw, causal=causal))
    return _MeshCall.apply(call, q, k, v)


def ring_self_attention(mesh, q, k, v, *, seq_axis: str = "seq",
                        causal: bool = False, use_flash: bool = False):
    return _seq_sharded_call(ring_attention, mesh, q, k, v, seq_axis,
                             causal, use_flash=use_flash)


# ---------------------------------------------------------------------------
# Ulysses: all-to-all sequence parallelism
# ---------------------------------------------------------------------------
def ulysses_attention(q, k, v, axis_name: str, *, causal: bool = False,
                      block_k: int = 256, use_flash: bool = False):
    """DeepSpeed-Ulysses sequence parallelism (call inside a replica,
    ``[b, h, t_local, d]`` shards, h divisible by the axis size): an
    all-to-all re-shards time -> heads, local attention sees the FULL
    sequence on h/n heads (:func:`flash_attention` under ``use_flash``:
    the kernels on the card, their plain versions on the CPU;
    :func:`blockwise_attention` otherwise), an all-to-all back."""
    qh, kh, vh = (all_to_all(t, axis_name, 1, 2) for t in (q, k, v))
    if use_flash:
        o = flash_attention(qh, kh, vh, causal)
    else:
        o = blockwise_attention(qh, kh, vh, causal=causal, block_k=block_k)
    return all_to_all(o, axis_name, 2, 1)


def ulysses_self_attention(mesh, q, k, v, *, seq_axis: str = "seq",
                           causal: bool = False, use_flash: bool = False):
    return _seq_sharded_call(ulysses_attention, mesh, q, k, v, seq_axis,
                             causal, use_flash=use_flash)
