"""The conv/BN epilogue family: ``y = act(x·scale + shift)`` per channel,
its backward, and the channel statistics of training BatchNormalization.

Counterpart of ``deeplearning4j_tpu/ops/conv_pallas.py``. Four
hand-written CUDA kernels, three in ``csrc/conv_epilogue.cu`` and one in
``csrc/matmul_epilogue.cu``, each with a plain PyTorch version beside
it:

* ``scale_shift_act`` (replaces ``_epilogue_kernel``): conv bias plus
  activation, inference-mode BatchNormalization (running stats folded
  into scale and shift, activation streamed behind them) and the
  training-mode BatchNormalization normalize;
* ``epilogue_backward`` (replaces ``_epilogue_bwd_kernel``): one pass
  over x and dy giving ``dx = dy·act′·scale`` and the per-channel
  ``Σdy·act′`` (dshift) and ``Σdy·act′·x`` (dscale);
* ``channel_sums`` (replaces ``_stats_kernel``): per-channel ``Σx`` and
  ``Σx²`` in one read, from which :func:`channel_stats` derives the
  batch mean and (biased) variance;
* ``matmul_bias_act_forward`` (replaces ``_matmul_epilogue_kernel``):
  ``y = act(x @ Wᵀ + b)``, the lowering of a pointwise (1x1, stride 1)
  convolution, with the bias and the activation applied to the f32
  accumulator before the one store.

:func:`scale_shift_act`, :func:`channel_stats` and
:func:`matmul_bias_act` are ``torch.autograd.Function``\\ s: the first's
backward is ``epilogue_backward``, the second's is the epilogue with
identity (the per-channel FMA ``dx = x·(2·dvar/M) + (dmean −
2·mean·dvar)/M``), the third's is plain products, as in the JAX package
(``_mba_bwd``: the relu mask from the saved output, f32 sums). Each
kernel wrapper launches its kernel on a CUDA tensor (and raises on
anything it does not take), runs the plain version on a CPU tensor, and
does nothing else: on the card there is no fallback. The epilogue kernels
are bound by bytes, the matmul by bytes or operations by site; the
source notes say what their design does about that.

Dispatch runs through the ``ops/kernel_select.py`` ladder: family
``conv_epilogue`` for conv and inference-BN sites, ``bn_fwd`` for the
training-BN forward, both on the ``DL4J_TORCH_FUSED_CONV`` gate. An
admitted conv site that is pointwise runs ``matmul_bias_act``, any other
conv + ``scale_shift_act``. The structural gates keep only what is
semantics: rank, a floating dtype, a streamable activation (relu or
identity), an epilogue to apply, training mode for the statistics. The
JAX package's TPU tiling gates (``C % 8``, the 128-lane ``C_in`` and
``C_out`` of its matmul route, a size floor, "platform is tpu") do not
carry over. The auto rung takes the kernels for every admissible site on
the card and the plain versions on the CPU; ``DL4J_TORCH_FUSED_CONV=0``
is the explicit kill switch.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.common import telemetry
from deeplearning4j_tpu_torch.ops import cuda_build, kernel_select

#: activations the epilogue streams
STREAMABLE_ACTIVATIONS = ("relu", "identity")
#: input dtypes the kernels read and write (arithmetic is f32); a
#: float64 x on the card is refused, not demoted
KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_SOURCE = "deeplearning4j_tpu_torch/csrc/conv_epilogue.cu"
EPILOGUE = cuda_build.register(cuda_build.Kernel(
    "scale_shift_act", source=_SOURCE,
    replaces="deeplearning4j_tpu/ops/conv_pallas.py:158 "
             "(_epilogue_kernel)"))
EPILOGUE_BWD = cuda_build.register(cuda_build.Kernel(
    "epilogue_backward", source=_SOURCE,
    replaces="deeplearning4j_tpu/ops/conv_pallas.py:166 "
             "(_epilogue_bwd_kernel)"))
CHANNEL_SUMS = cuda_build.register(cuda_build.Kernel(
    "channel_sums", source=_SOURCE,
    replaces="deeplearning4j_tpu/ops/conv_pallas.py:194 (_stats_kernel)"))
MATMUL = cuda_build.register(cuda_build.Kernel(
    "matmul_bias_act",
    source="deeplearning4j_tpu_torch/csrc/matmul_epilogue.cu",
    replaces="deeplearning4j_tpu/ops/conv_pallas.py:211 "
             "(_matmul_epilogue_kernel)"))

_fused_steps = telemetry.counter(
    "dl4j_conv_fused_steps_total",
    "conv-epilogue sites dispatched to the epilogue kernels, by site "
    "(conv / conv_matmul / bn_infer / bn_train); counts executed "
    "dispatches")
_layout_copies = telemetry.counter(
    "dl4j_conv_layout_copies_total",
    "tensors that reached an epilogue-family kernel in a layout other "
    "than contiguous channels-last and were copied first")


# ---------------------------------------------------------------------------
# selection (structural gate -> override -> auto, via kernel_select)
# ---------------------------------------------------------------------------
def _auto_on_card(device: torch.device):
    def auto() -> Tuple[bool, str]:
        if device.type == "cuda":
            return True, "auto: cuda, the kernel is the path"
        return False, f"auto: device '{device.type}' runs the plain version"
    return auto


def _family_structural(shape: Sequence[int], dtype: torch.dtype
                       ) -> Optional[str]:
    if len(shape) < 2:
        return f"rank {len(shape)} not supported"
    if not dtype.is_floating_point:
        return f"dtype {dtype} is not floating"
    return None


def select_conv_epilogue(out_shape: Sequence[int], dtype: torch.dtype,
                         act_name: str, *,
                         device: Union[str, torch.device],
                         has_epilogue: bool = True,
                         override=None, use_env_override: bool = True,
                         record: bool = True) -> kernel_select.Selection:
    """Ladder decision for a conv-epilogue site on ``device``."""
    if not has_epilogue:
        structural = "no epilogue to fuse (no bias, identity activation)"
    elif act_name not in STREAMABLE_ACTIVATIONS:
        structural = f"activation '{act_name}' is not streamable"
    else:
        structural = _family_structural(out_shape, dtype)
    if override is None and use_env_override:
        override = kernel_select.gate_override("conv_epilogue")
    return kernel_select.select(
        "conv_epilogue", structural=structural,
        auto=_auto_on_card(torch.device(device)),
        override=override, use_env_override=False, record=record)


def select_bn_forward(shape: Sequence[int], dtype: torch.dtype, *,
                      training: bool, device: Union[str, torch.device],
                      override=None, use_env_override: bool = True,
                      record: bool = True) -> kernel_select.Selection:
    """Ladder decision for the training-mode BN forward (channel
    statistics, then the normalize). Inference-mode BN has no statistics
    pass, so asking outside training is a structural demotion."""
    if not training:
        structural = ("inference-mode BN folds into the epilogue "
                      "(no batch-stats pass)")
    else:
        structural = _family_structural(shape, dtype)
    if override is None and use_env_override:
        override = kernel_select.gate_override("bn_fwd")
    return kernel_select.select(
        "bn_fwd", structural=structural,
        auto=_auto_on_card(torch.device(device)),
        override=override, use_env_override=False, record=record)


# ---------------------------------------------------------------------------
# plain versions (the CPU path and the kernels' oracles)
# ---------------------------------------------------------------------------
def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def scale_shift_act_plain(x: torch.Tensor, scale: torch.Tensor,
                          shift: torch.Tensor, act: str) -> torch.Tensor:
    """Plain PyTorch version of the epilogue, with the kernel's
    arithmetic (f32, or f64 for f64 inputs): a rounded multiply, a
    rounded add, relu as ``y < 0 ? 0 : y`` (NaN passes through), and y
    in the dtype of x."""
    acc = _acc(x.dtype)
    y = x.to(acc) * scale.to(acc)
    y = y + shift.to(acc)
    if act == "relu":
        y = y.masked_fill(y < 0, 0.0)
    elif act != "identity":
        raise ValueError(f"activation {act!r} is not streamable")
    return y.to(x.dtype)


def epilogue_backward_plain(x: torch.Tensor, dy: torch.Tensor,
                            scale: torch.Tensor, shift: torch.Tensor,
                            act: str
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Plain version of ``epilogue_backward`` on an [M, C] view:
    ``g = where(x·s + b > 0, dy, 0)`` for relu (the forward's rounding),
    ``dx = g·s`` in x's dtype, ``dscale = Σg·x``, ``dshift = Σg``.
    Returns ``(dx, dscale, dshift)`` as ``_epilogue_backward`` does."""
    acc = _acc(x.dtype)
    xf, g = x.to(acc), dy.to(acc)
    s, b = scale.to(acc), shift.to(acc)
    if act == "relu":
        z = xf * s
        z = z + b
        g = torch.where(z > 0, g, 0.0)
    elif act != "identity":
        raise ValueError(f"activation {act!r} is not streamable")
    dx = (g * s).to(x.dtype)
    return dx, (g * xf).sum(0), g.sum(0)


def channel_sums_plain(x2d: torch.Tensor) -> torch.Tensor:
    """Plain version of ``channel_sums``: ``[Σx, Σx²]`` over the rows of
    an [M, C] view, as a [2, C] tensor in the accumulation dtype."""
    xf = x2d.to(_acc(x2d.dtype))
    return torch.stack([xf.sum(0), (xf * xf).sum(0)])


def matmul_bias_act_plain(x2d: torch.Tensor, w: torch.Tensor,
                          bias: torch.Tensor, act: str) -> torch.Tensor:
    """Plain version of ``matmul_bias_act``: ``x2d [M, K] @ w[N, K]ᵀ``
    accumulated in f32 (f64 for f64 inputs), then the bias, then relu as
    ``y < 0 ? 0 : y`` (NaN passes through), then one cast to x's
    dtype."""
    acc = _acc(x2d.dtype)
    y = x2d.to(acc) @ w.to(acc).t()
    y = y + bias.to(acc)
    if act == "relu":
        y = y.masked_fill(y < 0, 0.0)
    elif act != "identity":
        raise ValueError(f"activation {act!r} is not streamable")
    return y.to(x2d.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int


def check_rows(fn: str, x: torch.Tensor, others=(), vectors=()) -> int:
    """Validate a kernel's operands on the card and return C: ``x`` a
    contiguous tensor of a kernel dtype with channels last, ``others``
    tensors of x's dtype and shape, ``vectors`` contiguous float32 [C]
    tensors, all on x's device."""
    if x.device.type != "cuda":
        raise ValueError(f"{fn}: no kernel for device {x.device}")
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"{fn}: x dtype {x.dtype} is not one of "
                        f"{KERNEL_DTYPES}")
    if x.dim() < 1 or not x.is_contiguous():
        raise ValueError(f"{fn}: x must be contiguous with channels on "
                         f"its last axis")
    C = int(x.shape[-1])
    for nm, t in others:
        if t.device != x.device or t.dtype != x.dtype \
                or t.shape != x.shape or not t.is_contiguous():
            raise ValueError(f"{fn}: {nm} must be a contiguous {x.dtype} "
                             f"{tuple(x.shape)} tensor on {x.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    for nm, t in vectors:
        if t.device != x.device:
            raise ValueError(f"{fn}: {nm} is on {t.device}, x on "
                             f"{x.device}")
        if t.dtype != torch.float32 or t.shape != (C,) \
                or not t.is_contiguous():
            raise ValueError(f"{fn}: {nm} must be a contiguous float32 "
                             f"[{C}] tensor, got {t.dtype} "
                             f"{tuple(t.shape)}")
    return C


def contiguous(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a contiguous tensor; a copy, where one is needed, is
    counted in ``dl4j_conv_layout_copies_total``."""
    if t.is_contiguous():
        return t
    _layout_copies.inc()
    return t.contiguous()


def raise_on_error(fn: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{fn}: CUDA launch failed with cudaError {rc}")


def scale_shift_act_forward(x: torch.Tensor, scale: torch.Tensor,
                            shift: torch.Tensor, act: str) -> torch.Tensor:
    """The epilogue, no autograd: the kernel on a CUDA ``x``, the plain
    version on a CPU ``x``."""
    if x.device.type == "cpu":
        return scale_shift_act_plain(x, scale, shift, act)
    if act not in STREAMABLE_ACTIVATIONS:
        raise ValueError(f"scale_shift_act: activation {act!r} is not "
                         f"streamable")
    C = check_rows("scale_shift_act", x,
                   vectors=(("scale", scale), ("shift", shift)))
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    if x.numel() == 0:
        return y
    fn = cuda_build.c_function(
        "conv_epilogue", "dl4j_scale_shift_act",
        [_P, _P, _P, _P, _I64, _I64, _INT, _INT, _P])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), y.data_ptr(), scale.data_ptr(),
                shift.data_ptr(), x.numel() // C, C, DTYPE_CODE[x.dtype],
                1 if act == "relu" else 0, stream)
    raise_on_error("scale_shift_act", rc)
    n, e = x.numel(), x.element_size()
    EPILOGUE.launched(lambda: (2 * n * e + 2 * C * 4, 2 * n))
    return y


def column_workspace(x: torch.Tensor, M: int, C: int, lib: str,
                     chunks_fn: str):
    """The f32 ``[chunks, 2, C]`` partials workspace of kernel 2's
    two-launch column reduction and its ``[2, C]`` output, from torch's
    allocator. The workspace is freed when the wrapper returns, before
    the kernel has run; the caching allocator hands its block only to
    work queued after the kernel on the same stream, so that is safe."""
    fn = cuda_build.c_function(lib, chunks_fn, [_I64, _I64, _INT],
                               ctypes.c_int64)
    chunks = int(fn(M, C, DTYPE_CODE[x.dtype]))
    partials = torch.empty((chunks, 2, C), dtype=torch.float32,
                           device=x.device)
    sums = torch.empty((2, C), dtype=torch.float32, device=x.device)
    return partials, chunks, sums


def epilogue_backward(x2d: torch.Tensor, dy2d: torch.Tensor,
                      scale: torch.Tensor, shift: torch.Tensor, act: str
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dx, dscale, dshift)`` of the epilogue on an [M, C] view: the
    kernel on the card, the plain version on the CPU."""
    if x2d.device.type == "cpu":
        return epilogue_backward_plain(x2d, dy2d, scale, shift, act)
    if act not in STREAMABLE_ACTIVATIONS:
        raise ValueError(f"epilogue_backward: activation {act!r} is not "
                         f"streamable")
    C = check_rows("epilogue_backward", x2d, others=(("dy", dy2d),),
                   vectors=(("scale", scale), ("shift", shift)))
    M = x2d.numel() // C
    dx = torch.empty_like(x2d, memory_format=torch.contiguous_format)
    if M == 0:
        z = torch.zeros(C, dtype=torch.float32, device=x2d.device)
        return dx, z, z.clone()
    partials, chunks, sums = column_workspace(
        x2d, M, C, "conv_epilogue", "dl4j_conv_epilogue_chunks")
    fn = cuda_build.c_function(
        "conv_epilogue", "dl4j_epilogue_backward",
        [_P, _P, _P, _P, _P, _P, _I64, _P, _I64, _I64, _INT, _INT, _P])
    with torch.cuda.device(x2d.device):
        stream = torch.cuda.current_stream(x2d.device).cuda_stream
        rc = fn(x2d.data_ptr(), dy2d.data_ptr(), dx.data_ptr(),
                scale.data_ptr(), shift.data_ptr(), partials.data_ptr(),
                chunks, sums.data_ptr(), M, C, DTYPE_CODE[x2d.dtype],
                1 if act == "relu" else 0, stream)
    raise_on_error("epilogue_backward", rc)
    e = x2d.element_size()
    EPILOGUE_BWD.launched(lambda: (3 * M * C * e + 4 * C * 4,
                                   (7 if act == "relu" else 4) * M * C))
    return dx, sums[1], sums[0]


def sums_workspace(x2d: torch.Tensor, M: int, C: int, lib: str,
                   floats_fn: str):
    """The f32 workspace of a one-launch column reduction
    (``csrc/column_reduce_sm90.cuh``: its chunk and group partials, as
    many floats as ``floats_fn`` of ``lib`` asks) and its ``[2, C]``
    output, one allocation from torch's stream-ordered allocator (under
    CUDA-graph capture, from the graph's pool), so every launch has a
    workspace of its own; the output view keeps it alive."""
    fn = cuda_build.c_function(lib, floats_fn, [_I64, _I64, _INT],
                               ctypes.c_int64)
    floats = int(fn(M, C, DTYPE_CODE[x2d.dtype]))
    buf = torch.empty(floats + 2 * C, dtype=torch.float32,
                      device=x2d.device)
    return buf, floats, buf[floats:].view(2, C)


def channel_sums(x2d: torch.Tensor) -> torch.Tensor:
    """``[Σx, Σx²]`` per channel of an [M, C] view as a [2, C] tensor:
    the kernel on the card (f32 sums, one launch), the plain version on
    the CPU."""
    if x2d.device.type == "cpu":
        return channel_sums_plain(x2d)
    C = check_rows("channel_sums", x2d)
    M = x2d.numel() // C
    if M == 0:
        return torch.zeros((2, C), dtype=torch.float32, device=x2d.device)
    work, floats, sums = sums_workspace(x2d, M, C, "conv_epilogue",
                                        "dl4j_channel_sums_workspace")
    fn = cuda_build.c_function(
        "conv_epilogue", "dl4j_channel_sums",
        [_P, _P, _I64, _P, _I64, _I64, _INT, _P])
    with torch.cuda.device(x2d.device):
        stream = torch.cuda.current_stream(x2d.device).cuda_stream
        rc = fn(x2d.data_ptr(), work.data_ptr(), floats, sums.data_ptr(), M,
                C, DTYPE_CODE[x2d.dtype], stream)
    raise_on_error("channel_sums", rc)
    e = x2d.element_size()
    CHANNEL_SUMS.launched(lambda: (M * C * e + 2 * C * 4, 3 * M * C))
    return sums


def channel_sums_body(x2d: torch.Tensor) -> str:
    """The geometry :func:`channel_sums` takes for a CUDA ``x2d`` [M, C],
    as the kernel names it: vector width, rows in flight, block, grid of
    chunks and channel tiles, ticket groups and levels, index width.
    Launches nothing."""
    C = int(x2d.shape[-1])
    M = x2d.numel() // C
    fn = cuda_build.c_function(
        "conv_epilogue", "dl4j_channel_sums_describe",
        [_P, _I64, _I64, _INT, ctypes.c_char_p, _INT])
    buf = ctypes.create_string_buffer(256)
    rc = fn(x2d.data_ptr(), M, C, DTYPE_CODE[x2d.dtype], buf, len(buf))
    raise_on_error("channel_sums_body", rc)
    return buf.value.decode()


def matmul_bias_act_forward(x2d: torch.Tensor, w: torch.Tensor,
                            bias: torch.Tensor, act: str) -> torch.Tensor:
    """``act(x2d @ wᵀ + bias)``, no autograd: the kernel on a CUDA
    ``x2d``, the plain version on a CPU one. ``x2d`` is a contiguous
    [M, K] tensor of a kernel dtype, ``w`` a contiguous [N, K] tensor of
    the same dtype, ``bias`` a contiguous float32 [N] tensor."""
    if x2d.device.type == "cpu":
        return matmul_bias_act_plain(x2d, w, bias, act)
    fn_name = "matmul_bias_act"
    if act not in STREAMABLE_ACTIVATIONS:
        raise ValueError(f"{fn_name}: activation {act!r} is not streamable")
    if x2d.dim() != 2 or w.dim() != 2:
        raise ValueError(f"{fn_name}: x must be [M, K] and w [N, K], got "
                         f"{tuple(x2d.shape)} and {tuple(w.shape)}")
    K = check_rows(fn_name, x2d)
    N = int(w.shape[0])
    if w.device != x2d.device or w.dtype != x2d.dtype \
            or int(w.shape[1]) != K or not w.is_contiguous():
        raise ValueError(f"{fn_name}: w must be a contiguous {x2d.dtype} "
                         f"[N, {K}] tensor on {x2d.device}, got {w.dtype} "
                         f"{tuple(w.shape)} on {w.device}")
    if bias.device != x2d.device or bias.dtype != torch.float32 \
            or bias.shape != (N,) or not bias.is_contiguous():
        raise ValueError(f"{fn_name}: bias must be a contiguous float32 "
                         f"[{N}] tensor on {x2d.device}, got {bias.dtype} "
                         f"{tuple(bias.shape)} on {bias.device}")
    M = int(x2d.shape[0])
    y = torch.empty((M, N), dtype=x2d.dtype, device=x2d.device)
    if M == 0 or N == 0:
        return y
    fn = cuda_build.c_function(
        "matmul_epilogue", "dl4j_matmul_bias_act",
        [_P, _P, _P, _P, _I64, _I64, _I64, _INT, _INT, _P])
    with torch.cuda.device(x2d.device):
        stream = torch.cuda.current_stream(x2d.device).cuda_stream
        rc = fn(x2d.data_ptr(), w.data_ptr(), bias.data_ptr(),
                y.data_ptr(), M, N, K, DTYPE_CODE[x2d.dtype],
                1 if act == "relu" else 0, stream)
    raise_on_error(fn_name, rc)
    e = x2d.element_size()
    MATMUL.launched(lambda: ((M * K + N * K + M * N) * e + N * 4,
                             2 * M * K * N))
    return y


def matmul_bias_act_body(x2d: torch.Tensor, w: torch.Tensor,
                         y: Optional[torch.Tensor] = None) -> str:
    """The body :func:`matmul_bias_act_forward` takes for CUDA operands
    ``x2d`` [M, K] and ``w`` [N, K] (and its output ``y``, by default a
    fresh, aligned one), as the kernel's own plan names it: the kernel,
    its tile, ring depth and grid. Launches nothing."""
    M, K = (int(d) for d in x2d.shape)
    N = int(w.shape[0])
    fn = cuda_build.c_function(
        "matmul_epilogue", "dl4j_matmul_bias_act_describe",
        [_P, _P, _P, _I64, _I64, _I64, _INT, ctypes.c_char_p, _INT])
    buf = ctypes.create_string_buffer(256)
    rc = fn(x2d.data_ptr(), w.data_ptr(),
            0 if y is None else y.data_ptr(), M, N, K,
            DTYPE_CODE[x2d.dtype], buf, len(buf))
    raise_on_error("matmul_bias_act_body", rc)
    return buf.value.decode()


def matmul_tensor_map_ns(x2d: torch.Tensor, w: torch.Tensor,
                         reps: int = 1000) -> float:
    """Host ns of encoding the Hopper body's two tensor maps for
    ``x2d`` [M, K] and ``w`` [N, K] (16-bit CUDA tensors), averaged over
    ``reps`` encodings: what each launch of that body adds on the host."""
    fn = cuda_build.c_function(
        "matmul_epilogue", "dl4j_matmul_tensor_map_ns",
        [_P, _P, _I64, _I64, _I64, _INT], restype=ctypes.c_double)
    return float(fn(x2d.data_ptr(), w.data_ptr(), int(x2d.shape[0]),
                    int(w.shape[0]), int(x2d.shape[1]), reps))


# ---------------------------------------------------------------------------
# differentiable building blocks
# ---------------------------------------------------------------------------
class _ScaleShiftAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, shift, act):
        ctx.act = act
        ctx.save_for_backward(x, scale, shift)
        return scale_shift_act_forward(x, scale, shift, act)

    @staticmethod
    def backward(ctx, dy):
        x, scale, shift = ctx.saved_tensors
        C = x.shape[-1]
        dx, dscale, dshift = epilogue_backward(
            x.reshape(-1, C), contiguous(dy).reshape(-1, C), scale, shift,
            ctx.act)
        return (dx.reshape(x.shape), dscale.to(scale.dtype),
                dshift.to(shift.dtype), None)


def scale_shift_act(x: torch.Tensor, scale: torch.Tensor,
                    shift: torch.Tensor, act: str) -> torch.Tensor:
    """``act(x·scale + shift)`` with per-channel (last-axis) coefficients,
    differentiable: the forward is the epilogue kernel, the backward the
    epilogue-backward kernel (plain versions on the CPU)."""
    return _ScaleShiftAct.apply(x, scale, shift, act)


class _ChannelStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        C = x.shape[-1]
        M = x.numel() // C
        sums = channel_sums(x.reshape(M, C))
        mean = sums[0] / M
        var = torch.clamp(sums[1] / M - mean * mean, min=0.0)
        ctx.save_for_backward(x, mean)
        return mean, var

    @staticmethod
    def backward(ctx, dmean, dvar):
        x, mean = ctx.saved_tensors
        inv_m = 1.0 / (x.numel() // x.shape[-1])
        dv = dvar.to(mean.dtype)
        scale = 2.0 * dv * inv_m
        shift = (dmean.to(mean.dtype) - 2.0 * mean * dv) * inv_m
        return scale_shift_act_forward(x, scale.contiguous(),
                                       shift.contiguous(), "identity")


class _DpChannelStats(torch.autograd.Function):
    """``_ChannelStats`` over a data-parallel mesh's global batch: the
    local sums all-reduced before the mean and variance are formed, the
    cotangents all-reduced before the epilogue forms dx."""

    @staticmethod
    def forward(ctx, x, replica):
        C = x.shape[-1]
        M = x.numel() // C * replica.size
        sums = replica.all_reduce_sum(channel_sums(x.reshape(-1, C)))
        mean = sums[0] / M
        var = torch.clamp(sums[1] / M - mean * mean, min=0.0)
        ctx.replica = replica
        ctx.save_for_backward(x, mean)
        return mean, var

    @staticmethod
    def backward(ctx, dmean, dvar):
        x, mean = ctx.saved_tensors
        replica = ctx.replica
        inv_m = 1.0 / (x.numel() // x.shape[-1] * replica.size)
        cts = replica.all_reduce_sum(torch.stack(
            [dmean.to(mean.dtype), dvar.to(mean.dtype)]))
        dv = cts[1]
        scale = 2.0 * dv * inv_m
        shift = (cts[0] - 2.0 * mean * dv) * inv_m
        return scale_shift_act_forward(x, scale.contiguous(),
                                       shift.contiguous(), "identity"), None


def channel_stats(x: torch.Tensor, replica=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel ``(mean, var)`` over every leading axis, var the
    biased batch variance ``E[x²] − mean²`` clamped at 0, from one read
    of x (``channel_sums``). Differentiable: the backward is the
    epilogue with identity. With a data-parallel ``replica``
    (``parallel/mesh.py``) the statistics are the global batch's."""
    if replica is not None:
        return _DpChannelStats.apply(contiguous(x), replica)
    return _ChannelStats.apply(contiguous(x))


class _MatmulBiasAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2d, w, bias, act):
        y = matmul_bias_act_forward(x2d, w, bias, act)
        ctx.act = act
        ctx.save_for_backward(x2d, w, y)
        ctx.bias_dtype = bias.dtype
        return y

    @staticmethod
    def backward(ctx, dy):
        # _mba_bwd: the relu mask from the saved output (y > 0 iff the
        # pre-activation > 0), f32 products cast back; plain matmuls
        x2d, w, y = ctx.saved_tensors
        acc = _acc(x2d.dtype)
        g = torch.where(y > 0, dy, 0.0) if ctx.act == "relu" else dy
        g = g.to(acc)
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        dx = (g @ w.to(acc)).to(x2d.dtype) if need_x else None
        dw = (g.t() @ x2d.to(acc)).to(w.dtype) if need_w else None
        db = g.sum(0).to(ctx.bias_dtype) if need_b else None
        return dx, dw, db, None


def matmul_bias_act(x2d: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                    act: str) -> torch.Tensor:
    """``act(x2d @ wᵀ + bias)`` for ``x2d [M, K]``, ``w [N, K]``, the
    pointwise-conv lowering, differentiable: the forward is the matmul
    kernel (its plain version on the CPU), the backward plain products
    with the relu mask taken from the saved output."""
    return _MatmulBiasAct.apply(x2d, w, bias, act)


# ---------------------------------------------------------------------------
# layer entry points
# ---------------------------------------------------------------------------
def same_padding(size: int, k: int, stride: int, dilation: int = 1
                 ) -> Tuple[int, int]:
    """XLA's SAME padding for one spatial dim: ``(lo, hi)`` with the
    odd pixel on the high side. Stride-2 sites are asymmetric (the
    7x7/s2 stem on 224 pads (2, 3)), which torch's ``padding="same"``
    refuses, so the pads are computed and applied explicitly."""
    eff = (k - 1) * dilation + 1
    out = -(-size // stride)
    total = max((out - 1) * stride + eff - size, 0)
    return total // 2, total - total // 2


def _is_pointwise(w_shape: Sequence[int], stride: Sequence[int],
                  dilation: Sequence[int],
                  padding: Union[str, Sequence[Tuple[int, int]]]) -> bool:
    """A 1x1, stride-1, undilated, unpadded conv of an OIHW kernel: a
    [M, C_in] x [C_in, C_out] matmul."""
    if any(int(k) != 1 for k in w_shape[2:]):
        return False
    if any(int(s) != 1 for s in stride):
        return False
    if any(int(d) != 1 for d in dilation):
        return False
    if isinstance(padding, str):
        return True              # SAME == VALID == no pad for 1x1
    return all(int(lo) == 0 and int(hi) == 0 for lo, hi in padding)


def conv_forward(x: torch.Tensor, w: torch.Tensor, *,
                 stride: Tuple[int, int],
                 padding: Union[str, Sequence[Tuple[int, int]]],
                 dilation: Tuple[int, int] = (1, 1),
                 bias: Optional[torch.Tensor] = None,
                 activation=None) -> torch.Tensor:
    """2-D convolution of NHWC ``x`` with an OIHW ``w``, plus its
    bias/activation epilogue. When the ladder admits the site, a
    pointwise site runs as one ``matmul_bias_act`` over the [M, C_in]
    view of x and the [C_out, C_in] view of w, any other as the conv and
    then the epilogue (the bias gradient comes back as the epilogue's
    dshift); otherwise the plain lowering. ``padding`` is ``"SAME"`` or
    ``[(lo, hi), (lo, hi)]``.

    ``x.permute(0, 3, 1, 2)`` is a channels-last NCHW view, so the
    convolution reads NHWC memory as it lies and writes channels-last;
    the output's NHWC view is then contiguous and the epilogue reads it
    without a copy (a copy, where one happens, is counted in
    ``dl4j_conv_layout_copies_total``)."""
    from deeplearning4j_tpu_torch.activations import Activation
    act = activation if activation is not None else Activation.IDENTITY
    act_name = act.value
    H, W_ = int(x.shape[1]), int(x.shape[2])
    kh, kw = int(w.shape[2]), int(w.shape[3])
    if isinstance(padding, str):
        pads = [same_padding(H, kh, stride[0], dilation[0]),
                same_padding(W_, kw, stride[1], dilation[1])]
    else:
        pads = [tuple(int(p) for p in pr) for pr in padding]
    xn = x.permute(0, 3, 1, 2)
    if all(lo == hi for lo, hi in pads):
        conv_pad = (pads[0][0], pads[1][0])
    else:
        xn = F.pad(xn, (pads[1][0], pads[1][1], pads[0][0], pads[0][1]))
        conv_pad = (0, 0)
    has_epilogue = bias is not None or act_name != "identity"
    n_out = int(w.shape[0])
    out_shape = tuple(x.shape[:-1]) + (n_out,)
    sel = select_conv_epilogue(out_shape, x.dtype, act_name,
                               device=x.device, has_epilogue=has_epilogue)
    if not sel.fused:
        z = F.conv2d(xn, w, bias, stride=stride, padding=conv_pad,
                     dilation=dilation)
        return act(z.permute(0, 2, 3, 1))
    acc = _acc(x.dtype)
    shift = (bias.to(acc) if bias is not None
             else torch.zeros(n_out, dtype=acc, device=x.device))
    if _is_pointwise(w.shape, stride, dilation, padding):
        # a 1x1 stride-1 conv is a [M, C_in] x [C_in, C_out] matmul: the
        # epilogue is applied to the kernel's output tile
        _fused_steps.inc(site="conv_matmul")
        c_in = int(w.shape[1])
        y2d = matmul_bias_act(contiguous(x).reshape(-1, c_in),
                              contiguous(w.reshape(n_out, c_in)), shift,
                              act_name)
        return y2d.reshape(out_shape)
    _fused_steps.inc(site="conv")
    z = F.conv2d(xn, w, None, stride=stride, padding=conv_pad,
                 dilation=dilation).permute(0, 2, 3, 1)
    return scale_shift_act(contiguous(z),
                           torch.ones(n_out, dtype=acc, device=x.device),
                           shift, act_name)


def maybe_fused_bn_train(x: torch.Tensor, gamma: torch.Tensor,
                         beta: torch.Tensor, eps: float, activation,
                         replica=None
                         ) -> Optional[Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]]:
    """Training-mode BN forward on the epilogue family: channel
    statistics (the global batch's with a data-parallel ``replica``),
    then the normalize with the activation streamed in.
    Returns ``(y, mean, var)`` with the activation applied, or None when
    the ``bn_fwd`` ladder demotes the site (the caller runs the plain
    math). Used when the fused BN backward is off; with it on,
    ``ops/bn_train.bn_forward_math`` reaches the same kernels."""
    sel = select_bn_forward(x.shape, x.dtype, training=True,
                            device=x.device)
    if not sel.fused:
        return None
    _fused_steps.inc(site="bn_train")
    acc = _acc(x.dtype)
    x = contiguous(x)
    mean, var = channel_stats(x, replica)
    rstd = torch.rsqrt(var + eps)
    scale = gamma.to(acc) * rstd
    shift = beta.to(acc) - mean * scale
    act_name = activation.value
    if act_name in STREAMABLE_ACTIVATIONS:
        y = scale_shift_act(x, scale, shift, act_name)
    else:
        y = activation(scale_shift_act(x, scale, shift, "identity"))
    return y, mean, var


def maybe_bn_inference_epilogue(x: torch.Tensor, scale: torch.Tensor,
                                shift: torch.Tensor, activation
                                ) -> Optional[torch.Tensor]:
    """Inference-mode BN as one epilogue pass. Returns the activated
    output, or None when the ladder demotes the site (the caller runs
    the plain math)."""
    act_name = activation.value
    sel = select_conv_epilogue(tuple(x.shape), x.dtype, act_name,
                               device=x.device)
    if not sel.fused:
        return None
    _fused_steps.inc(site="bn_infer")
    return scale_shift_act(contiguous(x), scale, shift, act_name)
