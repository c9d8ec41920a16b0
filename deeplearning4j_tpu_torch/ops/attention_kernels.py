"""Attention dispatch: flash attention for scaled dot-product sites and
paged decode attention over a block-paged KV pool.

Counterpart of ``deeplearning4j_tpu/ops/attention_pallas.py``, both
halves.

**Flash half.** :func:`as_key_mask` reduces a broadcastable mask to the
``[b, t_k]`` key mask the kernels stream, :func:`select_attention_backend`
runs the ``attention`` family of ``ops/kernel_select.py``, and
:func:`flash_sdpa` adapts a site to the kernels of
``parallel/sequence.py``: any scale is folded into q (the kernels
hard-wire ``1/√d``) and rank-3 inputs get a unit heads axis.

The ladder keeps the JAX package's structural rungs, in its order: an
additive bias, a rank other than 3 or 4, a q/k head-dim mismatch, a mask
that is not a key mask. The kernels take every head dim and every float
dtype (float64 too), so the port adds no rung of its own.
The TPU gates (a 4096-key floor, HBM headroom, "platform is tpu") do not
carry over: the auto rung takes the kernels for every admissible site on
the card and the dense path on the CPU.
``DL4J_TORCH_FLASH_ATTENTION=0`` (or ``Environment.extra
["flash_attention"]``) is the explicit kill switch to the dense path of
``ops/attention.py``; ``=1`` forces the kernels' route anywhere (on the
CPU: their plain versions).

**Paged half.** One query token per sequence attends over a KV pool
``[num_blocks, block, h, d]`` through per-sequence block tables:
:func:`paged_attention_reference` is the plain version (a dense gather
of every table entry, the semantics oracle), :func:`paged_decode_attention`
the wrapper of the hand-written kernel ``csrc/paged_attention.cu``
(kernel 10, replacing ``_paged_decode_kernel``), and
:func:`select_paged_backend` the ``paged_attention`` family's ladder:
a degenerate shape is demoted structurally, ``DL4J_TORCH_PAGED_ATTENTION
=0`` kills the kernel (``=1`` forces its route), and the auto rung takes
the kernel on the card and the dense gather on the CPU (the JAX
package's "platform is tpu" auto rule does not carry over).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple, Union

import torch

from deeplearning4j_tpu_torch.ops import cuda_build, kernel_select
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


# ---------------------------------------------------------------------------
# paged decode attention (kernel 10)
# ---------------------------------------------------------------------------
#: masked-score value, as the flash kernels': the exp of a masked score is
#: exactly 0
PAGED_NEG_INF = -1e30
#: pool and query dtypes the paged kernel reads, with their codes
PAGED_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: the widest head the paged kernel takes
PAGED_MAX_HEAD_DIM = 256

PAGED_DECODE = cuda_build.register(cuda_build.Kernel(
    "paged_decode",
    source="deeplearning4j_tpu_torch/csrc/paged_attention.cu",
    replaces="deeplearning4j_tpu/ops/attention_pallas.py:230 "
             "(_paged_decode_kernel)"))


def paged_attention_reference(q, k_pool, v_pool, block_tables, lengths,
                              scale: Optional[float] = None
                              ) -> torch.Tensor:
    """The plain version of paged decode attention (the CPU path and the
    kernel's oracle): gather every table entry's block densely, mask
    tokens at or past ``lengths``, softmax in f32.

    ``q`` ``[b, h, d]``; ``k_pool`` / ``v_pool`` ``[num_blocks, block, h,
    d]``; ``block_tables`` ``[b, max_blocks]`` (padded with the scratch
    block 0); ``lengths`` ``[b]``, valid tokens a sequence (a length past
    ``max_blocks * block`` counts the whole table). Returns ``[b, h, d]``
    in q's dtype."""
    b, h, d = q.shape
    block = k_pool.shape[1]
    t = block_tables.shape[1] * block
    idx = block_tables.long()
    k = k_pool[idx].reshape(b, t, h, d).float()
    v = v_pool[idx].reshape(b, t, h, d).float()
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bhd,bthd->bht", q.float(), k) * scale
    valid = (torch.arange(t, device=q.device)[None, :]
             < lengths.to(q.device).long()[:, None])             # [b, t]
    s = torch.where(valid[:, None, :], s, PAGED_NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(s <= PAGED_NEG_INF / 2, 0.0, torch.exp(s - m))
    w = p / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    return torch.einsum("bht,bthd->bhd", w, v).to(q.dtype)


_P, _INT, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _check_paged(q, k_pool, v_pool, block_tables, lengths):
    """Validate the kernel's operands on the card; returns (b, h, d,
    block, max_blocks). Raises on what the kernel does not take."""
    fn = "paged_decode_attention"
    if q.device.type != "cuda":
        raise ValueError(f"{fn}: no kernel for device {q.device}")
    if q.dim() != 3 or k_pool.dim() != 4:
        raise ValueError(f"{fn}: q must be [b, h, d] and the pools "
                         f"[num_blocks, block, h, d], got "
                         f"{tuple(q.shape)} and {tuple(k_pool.shape)}")
    b, h, d = q.shape
    nb, block = k_pool.shape[:2]
    if tuple(k_pool.shape) != (nb, block, h, d) \
            or v_pool.shape != k_pool.shape:
        raise ValueError(f"{fn}: pools must be [num_blocks, block, {h}, "
                         f"{d}], got {tuple(k_pool.shape)} and "
                         f"{tuple(v_pool.shape)}")
    for nm, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if t.dtype not in PAGED_DTYPES:
            raise TypeError(f"{fn}: {nm} dtype {t.dtype} is not one of "
                            f"{tuple(PAGED_DTYPES)}")
    if v_pool.dtype != k_pool.dtype:
        raise TypeError(f"{fn}: k_pool is {k_pool.dtype}, v_pool "
                        f"{v_pool.dtype}")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        # a copy of the pool would move more bytes than the site reads
        raise ValueError(f"{fn}: the pools must be contiguous")
    if d > PAGED_MAX_HEAD_DIM:
        raise ValueError(f"{fn}: head dim {d} exceeds the kernel's "
                         f"{PAGED_MAX_HEAD_DIM}")
    if block_tables.dim() != 2 or block_tables.shape[0] != b \
            or tuple(lengths.shape) != (b,):
        raise ValueError(f"{fn}: block tables must be [{b}, max_blocks] "
                         f"and lengths [{b}], got "
                         f"{tuple(block_tables.shape)} and "
                         f"{tuple(lengths.shape)}")
    for nm, t in (("k_pool", k_pool), ("v_pool", v_pool),
                  ("block_tables", block_tables), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{fn}: {nm} is on {t.device}, q on "
                             f"{q.device}")
    max_blocks = block_tables.shape[1]
    if min(b, h, d, block, max_blocks) == 0:
        raise ValueError(f"{fn}: empty operand q {tuple(q.shape)}, pool "
                         f"{tuple(k_pool.shape)}, tables "
                         f"{tuple(block_tables.shape)}")
    return b, h, d, block, max_blocks


def paged_decode_attention(q, k_pool, v_pool, block_tables, lengths,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Kernel 10 on a CUDA q, the plain version on a CPU q; the contract
    of :func:`paged_attention_reference`. The kernel reads only the
    blocks that hold each sequence's valid tokens; table entries must
    name blocks of the pool (not checked on the card: that would need a
    synchronisation)."""
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pool, v_pool, block_tables,
                                          lengths, scale)
    b, h, d, block, max_blocks = _check_paged(q, k_pool, v_pool,
                                              block_tables, lengths)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    q = q.contiguous()
    tables = block_tables.to(torch.int32).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    fn = cuda_build.c_function(
        "paged_attention", "dl4j_paged_decode",
        [_P, _P, _P, _P, _P, _P, _INT, _INT, _INT, _INT, _INT, _F, _INT,
         _INT, _P])
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                tables.data_ptr(), lens.data_ptr(), out.data_ptr(), b, h,
                d, block, max_blocks, float(scale), PAGED_DTYPES[q.dtype],
                PAGED_DTYPES[k_pool.dtype],
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode_attention: CUDA launch failed "
                           f"with cudaError {rc}")
    PAGED_DECODE.launched(lambda: _paged_cost(q, k_pool, lens, block,
                                              max_blocks))
    return out


def _paged_cost(q, k_pool, lens, block: int, max_blocks: int):
    """(bytes, operations) of one launch of kernel 10: the valid tokens'
    K and V rows, q and out, the table entries it reads and the lengths
    (reading the lengths synchronises)."""
    b, h, d = (int(s) for s in q.shape)
    tok = [min(int(n), block * max_blocks) for n in lens.tolist()]
    blocks = sum(-(-n // block) for n in tok)
    return (2 * sum(tok) * h * d * k_pool.element_size()
            + 2 * b * h * d * q.element_size() + 4 * blocks + 4 * b,
            4 * sum(tok) * h * d)


def paged_decode_body(q, k_pool, v_pool, block_tables) -> str:
    """The body :func:`paged_decode_attention` takes for these CUDA
    operands, as the kernel names it: the staged body (lanes a row,
    ranks a cluster, stages) or the general one. Launches nothing."""
    b, h, d, block, max_blocks = _check_paged(
        q, k_pool, v_pool, block_tables,
        torch.zeros(q.shape[0], dtype=torch.int32, device=q.device))
    fn = cuda_build.c_function(
        "paged_attention", "dl4j_paged_decode_describe",
        [_P, _P, _INT, _INT, _INT, _INT, _INT, _INT, ctypes.c_char_p, _INT])
    buf = ctypes.create_string_buffer(256)
    rc = fn(k_pool.data_ptr(), v_pool.data_ptr(), b, h, d, block,
            max_blocks, PAGED_DTYPES[k_pool.dtype], buf, len(buf))
    if rc != 0:
        raise RuntimeError(f"paged_decode_body: cudaError {rc}")
    return buf.value.decode()


def select_paged_backend(batch: int, max_blocks: int, *,
                         device: Union[str, torch.device] = "cuda",
                         override=None,
                         use_env_override: bool = True) -> Tuple[str, str]:
    """``("paged" | "dense", reason)`` for a decode-attention site on
    ``device``; ``override`` exists for tests (default: the live
    ``DL4J_TORCH_PAGED_ATTENTION`` gate)."""
    structural = None
    if batch < 1 or max_blocks < 1:
        structural = (f"degenerate decode shape b={batch} "
                      f"blocks={max_blocks}")
    if override is None and use_env_override:
        override = kernel_select.gate_override("paged_attention")
    dev = torch.device(device)

    def auto():
        if dev.type == "cuda":
            return True, "auto: cuda, the paged kernel is the path"
        return False, f"auto: device '{dev.type}' runs the dense gather"

    sel = kernel_select.select("paged_attention", structural=structural,
                               auto=auto, override=override,
                               use_env_override=False)
    return ("paged" if sel.fused else "dense"), sel.reason
