"""Training-mode BatchNormalization: the forward math and the fused
backward.

Counterpart of ``deeplearning4j_tpu/ops/bn_pallas.py``. The backward of
the normalize is two passes over x and dy, each a hand-written CUDA
kernel in ``csrc/bn_train.cu`` with a plain PyTorch version beside it:

  pass 1, ``bn_bwd_sums`` (replaces ``_reduce_kernel``): per-channel
          ``Σdy`` and ``Σdy·x̂`` (dβ and dγ), one launch a site;
  pass 2, ``bn_bwd_dx`` (replaces ``_dx_kernel``): ``dx = A·dy + D·x + E``

with A, D, E folded per channel between the passes from the sums and
the mean and variance cotangents, as ``_bn_bwd_raw`` folds them.
:func:`bn_train_normalize` is the ``torch.autograd.Function`` that
carries them; its forward is :func:`bn_forward_math`, the one training
forward shared with the layer's plain path.

Data parallelism: with a ``replica`` (``parallel/mesh.py``) the batch
statistics are the global batch's, as in the JAX package's one
global-view program over the data axis. The local Σx and Σx² (kernel 3,
or the one-pass f32 sums of 16-bit activations) are all-reduced before
the mean and variance are formed; the two-pass f32 route takes two
rounds (the global mean, then the global Σ(x − mean)²). In the backward
Σdy and Σdy·x̂ (kernel 5) are all-reduced before kernel 6 runs with the
global row count; dγ and dβ stay this replica's own sums, which the
update exchange adds up with the other gradients. The kernels are
unchanged: the collectives sit between them.

The backward rides the ``bn_bwd`` family of ``ops/kernel_select.py``
(``DL4J_TORCH_FUSED_BN_BWD``, ``Environment.extra["fused_bn_bwd"]``):
the auto rung takes it on the card and leaves the CPU to autograd of the
plain math. ``=0`` is the kill switch; the layer then runs
``maybe_fused_bn_train`` (ops/conv_epilogue.py) or the plain math.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch

from deeplearning4j_tpu_torch.ops import conv_epilogue as ce
from deeplearning4j_tpu_torch.ops import cuda_build, kernel_select
from deeplearning4j_tpu_torch.parallel.mesh import all_reduce_sum

_SOURCE = "deeplearning4j_tpu_torch/csrc/bn_train.cu"
BN_BWD_SUMS = cuda_build.register(cuda_build.Kernel(
    "bn_bwd_sums", source=_SOURCE,
    replaces="deeplearning4j_tpu/ops/bn_pallas.py:69 (_reduce_kernel)"))
BN_BWD_DX = cuda_build.register(cuda_build.Kernel(
    "bn_bwd_dx", source=_SOURCE,
    replaces="deeplearning4j_tpu/ops/bn_pallas.py:90 (_dx_kernel)"))

_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int


def fused_bn_bwd_enabled(device: Union[str, torch.device]) -> bool:
    """The ``bn_bwd`` ladder for a site on ``device``: on by default on
    the card, off on the CPU (where autograd of the plain math runs);
    ``DL4J_TORCH_FUSED_BN_BWD=0`` kills it, ``=1`` forces it anywhere."""
    device = torch.device(device)

    def auto():
        if device.type == "cuda":
            return True, "auto: cuda, the fused backward is the path"
        return False, f"auto: device '{device.type}' runs autograd"

    return kernel_select.select("bn_bwd", auto=auto).fused


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def bn_bwd_sums_plain(x2d: torch.Tensor, dy2d: torch.Tensor,
                      mean: torch.Tensor, rstd: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(Σdy, Σdy·x̂)`` per channel, ``x̂ = (x − mean)·rstd``, in the
    accumulation dtype."""
    acc = torch.promote_types(x2d.dtype, torch.float32)
    xhat = (x2d.to(acc) - mean.to(acc)) * rstd.to(acc)
    dyf = dy2d.to(acc)
    return dyf.sum(0), (dyf * xhat).sum(0)


def bn_bwd_dx_plain(x2d: torch.Tensor, dy2d: torch.Tensor,
                    a: torch.Tensor, d: torch.Tensor, e: torch.Tensor
                    ) -> torch.Tensor:
    """``dx = (A·dy + D·x) + E`` per channel, each product and sum
    rounded on its own, in x's dtype."""
    acc = torch.promote_types(x2d.dtype, torch.float32)
    dx = a.to(acc) * dy2d.to(acc) + d.to(acc) * x2d.to(acc)
    return (dx + e.to(acc)).to(x2d.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
def bn_bwd_sums(x2d: torch.Tensor, dy2d: torch.Tensor, mean: torch.Tensor,
                rstd: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pass 1 on an [M, C] view: the kernel on the card (f32 sums, one
    launch), the plain version on the CPU."""
    if x2d.device.type == "cpu":
        return bn_bwd_sums_plain(x2d, dy2d, mean, rstd)
    C = ce.check_rows("bn_bwd_sums", x2d, others=(("dy", dy2d),),
                      vectors=(("mean", mean), ("rstd", rstd)))
    M = x2d.numel() // C
    if M == 0:
        z = torch.zeros(C, dtype=torch.float32, device=x2d.device)
        return z, z.clone()
    work, floats, sums = ce.sums_workspace(x2d, M, C, "bn_train",
                                           "dl4j_bn_sums_workspace")
    fn = cuda_build.c_function(
        "bn_train", "dl4j_bn_bwd_sums",
        [_P, _P, _P, _P, _P, _I64, _P, _I64, _I64, _INT, _P])
    with torch.cuda.device(x2d.device):
        stream = torch.cuda.current_stream(x2d.device).cuda_stream
        rc = fn(x2d.data_ptr(), dy2d.data_ptr(), mean.data_ptr(),
                rstd.data_ptr(), work.data_ptr(), floats, sums.data_ptr(),
                M, C, ce.DTYPE_CODE[x2d.dtype], stream)
    ce.raise_on_error("bn_bwd_sums", rc)
    e = x2d.element_size()
    BN_BWD_SUMS.launched(lambda: (2 * M * C * e + 4 * C * 4, 5 * M * C))
    return sums[0], sums[1]


def bn_bwd_sums_body(x2d: torch.Tensor, dy2d: torch.Tensor) -> str:
    """The geometry :func:`bn_bwd_sums` takes for CUDA operands ``x2d``
    and ``dy2d`` [M, C], as the kernel names it: vector width, block,
    grid of chunks and channel tiles, ticket groups and index width.
    Launches nothing."""
    C = int(x2d.shape[-1])
    M = x2d.numel() // C
    fn = cuda_build.c_function(
        "bn_train", "dl4j_bn_bwd_sums_describe",
        [_P, _P, _I64, _I64, _INT, ctypes.c_char_p, _INT])
    buf = ctypes.create_string_buffer(256)
    rc = fn(x2d.data_ptr(), dy2d.data_ptr(), M, C,
            ce.DTYPE_CODE[x2d.dtype], buf, len(buf))
    ce.raise_on_error("bn_bwd_sums_body", rc)
    return buf.value.decode()


def bn_bwd_dx(x2d: torch.Tensor, dy2d: torch.Tensor, a: torch.Tensor,
              d: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """Pass 2 on an [M, C] view: the kernel on the card, the plain
    version on the CPU."""
    if x2d.device.type == "cpu":
        return bn_bwd_dx_plain(x2d, dy2d, a, d, e)
    C = ce.check_rows("bn_bwd_dx", x2d, others=(("dy", dy2d),),
                      vectors=(("a", a), ("d", d), ("e", e)))
    dx = torch.empty_like(x2d, memory_format=torch.contiguous_format)
    M = x2d.numel() // C
    if M == 0:
        return dx
    fn = cuda_build.c_function(
        "bn_train", "dl4j_bn_bwd_dx",
        [_P, _P, _P, _P, _P, _P, _I64, _I64, _INT, _P])
    with torch.cuda.device(x2d.device):
        stream = torch.cuda.current_stream(x2d.device).cuda_stream
        rc = fn(x2d.data_ptr(), dy2d.data_ptr(), dx.data_ptr(),
                a.data_ptr(), d.data_ptr(), e.data_ptr(), M, C,
                ce.DTYPE_CODE[x2d.dtype], stream)
    ce.raise_on_error("bn_bwd_dx", rc)
    e = x2d.element_size()
    BN_BWD_DX.launched(lambda: (3 * M * C * e + 3 * C * 4, 4 * M * C))
    return dx


def bn_bwd_dx_body(x2d: torch.Tensor, dy2d: torch.Tensor,
                   dx: Optional[torch.Tensor] = None) -> str:
    """The geometry :func:`bn_bwd_dx` takes for CUDA operands ``x2d``
    and ``dy2d`` [M, C] (and its output ``dx``, by default a fresh,
    aligned one), as the kernel names it: vector width, block, grid and
    index width. Launches nothing."""
    C = int(x2d.shape[-1])
    M = x2d.numel() // C
    fn = cuda_build.c_function(
        "bn_train", "dl4j_bn_bwd_dx_describe",
        [_P, _P, _P, _I64, _I64, _INT, ctypes.c_char_p, _INT])
    buf = ctypes.create_string_buffer(256)
    rc = fn(x2d.data_ptr(), dy2d.data_ptr(),
            0 if dx is None else dx.data_ptr(), M, C,
            ce.DTYPE_CODE[x2d.dtype], buf, len(buf))
    ce.raise_on_error("bn_bwd_dx_body", rc)
    return buf.value.decode()


# ---------------------------------------------------------------------------
# the training forward and the fused backward
# ---------------------------------------------------------------------------
def bn_forward_math(x: torch.Tensor, gamma: torch.Tensor,
                    beta: torch.Tensor, eps: float, replica=None):
    """The training-mode BN forward, ``(y, mean, var, rstd)``.

    Statistics policy, as in the JAX package: with the ``bn_fwd`` ladder
    admitting the site, one pass (``channel_stats``: E[x²] − mean²),
    then the normalize as one epilogue pass. Otherwise one pass with f32
    accumulation for bf16/f16 activations and the two-pass mean-then-var
    form for f32 and wider, and ``x·scale + bias`` as plain math. With a
    data-parallel ``replica`` the statistics are the global batch's."""
    acc = torch.promote_types(x.dtype, torch.float32)
    dims = tuple(range(x.dim() - 1))
    fwd_sel = ce.select_bn_forward(x.shape, x.dtype, training=True,
                                   device=x.device)
    n = x.numel() // x.shape[-1] * (replica.size if replica else 1)
    if fwd_sel.fused:
        x = ce.contiguous(x)
        mean, var = ce.channel_stats(x, replica)
    elif x.dtype in (torch.bfloat16, torch.float16):
        xf = x.to(acc)
        sums = torch.stack([xf.sum(dims), (xf * xf).sum(dims)])
        if replica is not None:
            sums = all_reduce_sum(sums, replica)
        mean = sums[0] / n
        var = torch.clamp(sums[1] / n - mean * mean, min=0.0)
    elif replica is not None and replica.size > 1:
        # (one replica's statistics are its own: the form below)
        mean = all_reduce_sum(x.sum(dims), replica) / n
        var = all_reduce_sum(((x - mean) ** 2).sum(dims), replica) / n
    else:
        var, mean = torch.var_mean(x, dims, correction=0)
    rstd = torch.rsqrt(var + eps)
    scale = gamma.to(acc) * rstd
    bias = beta.to(acc) - mean * scale
    if fwd_sel.fused:
        y = ce.scale_shift_act(x, scale, bias, "identity")
    else:
        y = x * scale.to(x.dtype) + bias.to(x.dtype)
    return y, mean, var, rstd


class _BnTrainNormalize(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps, replica):
        y, mean, var, rstd = bn_forward_math(x, gamma, beta, eps, replica)
        ctx.replica = replica
        ctx.save_for_backward(ce.contiguous(x), gamma, mean, rstd)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, dmean_ct, dvar_ct):
        x, gamma, mean, rstd = ctx.saved_tensors
        replica = ctx.replica
        acc = torch.promote_types(x.dtype, torch.float32)
        C = x.shape[-1]
        M = x.numel() // C
        x2d = x.reshape(M, C)
        dy2d = ce.contiguous(dy).reshape(M, C)
        mu, r = mean.to(acc), rstd.to(acc)
        sdy, sdyx = bn_bwd_sums(x2d, dy2d, mu, r)
        dmean_g, dvar_g = dmean_ct.to(acc), dvar_ct.to(acc)
        sdy_g, sdyx_g, m_g = sdy, sdyx, M
        if replica is not None:
            # the global batch's sums and cotangents; dγ, dβ stay local
            sdy_g, sdyx_g, dmean_g, dvar_g = replica.all_reduce_sum(
                torch.stack([sdy, sdyx, dmean_g, dvar_g]))
            m_g = M * replica.size
        g = gamma.to(acc)
        inv_m = 1.0 / m_g
        # dx = γr·(dy − Σdy/M − x̂·Σdy·x̂/M) plus the mean/var cotangent
        # terms, rearranged into dx = A·dy + D·x + E
        a_coef = g * r
        d_coef = -g * r * r * (sdyx_g * inv_m) + 2.0 * dvar_g * inv_m
        e_coef = (-a_coef * (sdy_g * inv_m)
                  + dmean_g * inv_m
                  - d_coef * mu)
        dx = bn_bwd_dx(x2d, dy2d, a_coef, d_coef, e_coef).reshape(x.shape)
        return dx, sdyx.to(gamma.dtype), sdy.to(gamma.dtype), None, None


def bn_train_normalize(x: torch.Tensor, gamma: torch.Tensor,
                       beta: torch.Tensor, eps: float, replica=None):
    """Training-mode BN normalize with batch statistics (the global
    batch's with a data-parallel ``replica``), ``(y, mean, var)``, whose
    backward is the two-pass fused kernel pair."""
    return _BnTrainNormalize.apply(x, gamma, beta, eps, replica)
