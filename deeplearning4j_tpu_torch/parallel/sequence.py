"""Flash attention: the blocked online-softmax forward and its
log-sum-exp-recomputing backward.

Counterpart of the flash half of ``deeplearning4j_tpu/parallel/sequence.py``
(ring and Ulysses attention are not ported yet). Three hand-written CUDA
kernels in ``csrc/flash_attention.cu``, each with a plain PyTorch version
beside it:

* ``flash_forward`` (replaces ``_flash_kernel``): ``out = softmax(q kᵀ /
  √d, masked) v`` and the per-row log-sum-exp of the scaled scores;
* ``flash_bwd_dq`` (replaces ``_flash_bwd_dq_kernel``): ``dq = Σ_k
  p·(dO·vᵀ − δ)·k / √d``, p recomputed from the log-sum-exp;
* ``flash_bwd_dkv`` (replaces ``_flash_bwd_dkv_kernel``): ``dv = pᵀ·dO``,
  ``dk = dsᵀ·q / √d``.

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

from deeplearning4j_tpu_torch.ops import cuda_build

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
    FLASH_FWD.launched()
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
    FLASH_BWD_DQ.launched()
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
    FLASH_BWD_DKV.launched()
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
