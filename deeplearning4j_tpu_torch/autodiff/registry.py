"""Op registry: named graph ops -> eager PyTorch implementations.

Counterpart of ``deeplearning4j_tpu/autodiff/registry.py``. An op is a
function ``fn(inputs: list[Tensor], attrs: dict) -> Tensor | tuple``
registered under the reference's (TF-compatible) name and a domain;
``SameDiff`` walks its op list through this table, and autograd
differentiates the walk.

All twenty domains of the JAX package's registry are ported, in full
(240 ops). The convolution ops take channels-last activations (NWC,
NHWC, NDHWC) and kernels with their spatial axes first and
``[in, out]`` last, as the JAX package's; torch's convolutions see the
channels-first views of the same storage, and the TF/XLA padding rules
(``SAME`` pads more at the end) are applied explicitly. The random ops
draw from ``attrs["rng"]``, an ``common.rng.RngKey`` that ``SameDiff``
derives from the call's key and the op's position, so a draw depends on
nothing else (a rematerialized segment draws the same values).

Numerics follow the JAX package's ops, with its dtype rules where torch
differs: integer reductions, index results and shape queries are int32
(JAX's default integer), a mean of integers is float32, indices of any
integer dtype are accepted. ``gelu`` is the exact erf form; ``sdpa_core``
goes through ``ops/attention.py``, whose ladder takes the flash kernels
(7, 8, 9) for every admissible site on the card.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

OP_REGISTRY: Dict[str, Callable] = {}
OP_DOMAINS: Dict[str, str] = {}

def op(name, domain):
    def deco(fn):
        OP_REGISTRY[name] = fn
        OP_DOMAINS[name] = domain
        return fn
    return deco


def alias(new, existing):
    OP_REGISTRY[new] = OP_REGISTRY[existing]
    OP_DOMAINS[new] = OP_DOMAINS[existing]


def op_coverage() -> Dict[str, int]:
    """Registered (ported) ops per domain."""
    out: Dict[str, int] = {}
    for d in OP_DOMAINS.values():
        out[d] = out.get(d, 0) + 1
    return out


def get_op(name: str) -> Callable:
    if name in OP_REGISTRY:
        return OP_REGISTRY[name]
    raise KeyError(f"unknown op '{name}'; known domains: "
                   f"{sorted(set(OP_DOMAINS.values()))}")


# -- dtypes -----------------------------------------------------------------
_TORCH_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool,
}
_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


def dtype_name(dt) -> Optional[str]:
    """The numpy spelling of a dtype given as a torch dtype, a numpy
    dtype or type, or a name (``"float32"``, ``"bfloat16"``), as the JAX
    package writes it into ``graph.json``; None stays None."""
    if dt is None:
        return None
    if isinstance(dt, torch.dtype):
        return _NAMES[dt]
    if isinstance(dt, str) and dt in _TORCH_DTYPES:
        return dt
    if isinstance(dt, str) and dt.startswith("torch."):
        return _NAMES[getattr(torch, dt[len("torch."):])]
    if isinstance(dt, str) and dt.startswith("<class '"):
        # a scalar type's repr, as graph.json records a placeholder
        # declared with one: "<class 'jax.numpy.float32'>"
        return dtype_name(dt[len("<class '"):-2].rsplit(".", 1)[-1])
    return np.dtype(dt).name


def torch_dtype(dt) -> torch.dtype:
    if isinstance(dt, torch.dtype):
        return dt
    return _TORCH_DTYPES[dtype_name(dt)]


def _int32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32)


def _axes(axis, ndim: int):
    """A reduction axis attr as a torch ``dim``: None -> every axis."""
    if axis is None:
        return tuple(range(ndim))
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return (int(axis),)


def _is_float(t: torch.Tensor) -> bool:
    return t.dtype.is_floating_point


# -- helpers ----------------------------------------------------------------
def _unary(name, domain, fn):
    OP_REGISTRY[name] = lambda ins, attrs: fn(ins[0])
    OP_DOMAINS[name] = domain


def _binary(name, domain, fn):
    OP_REGISTRY[name] = lambda ins, attrs: fn(ins[0], ins[1])
    OP_DOMAINS[name] = domain


def _reduce(name, fn):
    def impl(ins, attrs):
        x = ins[0]
        return fn(x, _axes(attrs.get("axis"), x.dim()),
                  bool(attrs.get("keep_dims", False)))
    OP_REGISTRY[name] = impl
    OP_DOMAINS[name] = "reduce"


# -- arithmetic / broadcastable ---------------------------------------------
_binary("add", "arithmetic", torch.add)
_binary("sub", "arithmetic", torch.sub)
_binary("mul", "arithmetic", torch.mul)
_binary("div", "arithmetic", torch.div)
_binary("rdiv", "arithmetic", lambda a, b: b / a)
_binary("rsub", "arithmetic", lambda a, b: b - a)
_binary("pow", "arithmetic", torch.pow)


def _floordiv(a, b):
    """numpy/CPython floor division; floats as ``float_divmod`` computes
    them (differentiable, with a zero gradient)."""
    if not (a.is_floating_point() or b.is_floating_point()):
        return torch.floor_divide(a, b)
    mod = torch.fmod(a, b)
    div = (a - mod) / b
    ind = (mod != 0) & (torch.sign(b) != torch.sign(mod))
    return torch.round(torch.where(ind, div - 1, div))


_binary("floordiv", "arithmetic", _floordiv)
_binary("mod", "arithmetic", torch.remainder)      # sign of the divisor
_binary("fmod", "arithmetic", torch.fmod)          # sign of the dividend
_binary("maximum", "arithmetic", torch.maximum)
_binary("minimum", "arithmetic", torch.minimum)
_binary("squared_difference", "arithmetic", lambda a, b: (a - b) ** 2)
_unary("neg", "arithmetic", torch.neg)
_unary("abs", "arithmetic", torch.abs)
_unary("sign", "arithmetic", torch.sign)
_unary("reciprocal", "arithmetic", torch.reciprocal)

# -- transforms -------------------------------------------------------------
_unary("exp", "transform", torch.exp)
_unary("log", "transform", torch.log)
_unary("log1p", "transform", torch.log1p)
_unary("expm1", "transform", torch.expm1)
_unary("sqrt", "transform", torch.sqrt)
_unary("rsqrt", "transform", torch.rsqrt)
_unary("square", "transform", torch.square)
_unary("cube", "transform", lambda x: x ** 3)
_unary("floor", "transform", torch.floor)
_unary("ceil", "transform", torch.ceil)
_unary("round", "transform", torch.round)          # half to even
_unary("sin", "transform", torch.sin)
_unary("cos", "transform", torch.cos)
_unary("tan", "transform", torch.tan)
_unary("asin", "transform", torch.asin)
_unary("acos", "transform", torch.acos)
_unary("atan", "transform", torch.atan)
_unary("sinh", "transform", torch.sinh)
_unary("cosh", "transform", torch.cosh)
_unary("tanh", "transform", torch.tanh)
_unary("asinh", "transform", torch.asinh)
_unary("acosh", "transform", torch.acosh)
_unary("atanh", "transform", torch.atanh)
_unary("erf", "transform", torch.erf)
_unary("erfc", "transform", torch.erfc)
_binary("atan2", "transform", torch.atan2)


@op("clip_by_value", "transform")
def _clip(ins, attrs):
    return torch.clamp(ins[0], attrs["clip_value_min"],
                       attrs["clip_value_max"])


@op("clip_by_norm", "transform")
def _clip_norm(ins, attrs):
    n = torch.linalg.vector_norm(ins[0])
    c = attrs["clip_norm"]
    return torch.where(n > c, ins[0] * (c / n), ins[0])


@op("cast", "transform")
def _cast(ins, attrs):
    return ins[0].to(torch_dtype(attrs["dtype"]))


@op("identity", "transform")
def _identity_op(ins, attrs):
    return ins[0]


# -- activations ------------------------------------------------------------
_unary("relu", "activation", torch.relu)
_unary("relu6", "activation", F.relu6)
_unary("sigmoid", "activation", torch.sigmoid)
_unary("softplus", "activation",
       lambda x: torch.logaddexp(x, torch.zeros_like(x)))
_unary("softsign", "activation", F.softsign)
_unary("elu", "activation", F.elu)
_unary("selu", "activation", F.selu)
_unary("gelu", "activation", F.gelu)               # exact (erf) form
_unary("gelu_tanh", "activation", lambda x: F.gelu(x, approximate="tanh"))
_unary("swish", "activation", F.silu)
_unary("mish", "activation", F.mish)
_unary("hard_sigmoid", "activation", F.hardsigmoid)
_unary("hard_tanh", "activation", lambda x: torch.clamp(x, -1.0, 1.0))


@op("leaky_relu", "activation")
def _leaky(ins, attrs):
    return F.leaky_relu(ins[0], attrs.get("alpha", 0.01))


@op("softmax", "activation")
def _softmax(ins, attrs):
    return torch.softmax(ins[0], dim=attrs.get("axis", -1))


@op("log_softmax", "activation")
def _log_softmax(ins, attrs):
    return torch.log_softmax(ins[0], dim=attrs.get("axis", -1))


@op("prelu", "activation")
def _prelu(ins, attrs):
    x, a = ins
    return torch.where(x >= 0, x, a * x)


# -- blas -------------------------------------------------------------------
@op("matmul", "blas")
def _matmul(ins, attrs):
    a, b = ins
    if attrs.get("transpose_a"):
        a = a.transpose(-1, -2)
    if attrs.get("transpose_b"):
        b = b.transpose(-1, -2)
    return torch.matmul(a, b)


alias("mmul", "matmul")
alias("batch_matmul", "matmul")
_binary("tensordot_last", "blas", lambda a, b: torch.tensordot(a, b, 1))
_binary("outer", "blas",
        lambda a, b: torch.outer(a.reshape(-1), b.reshape(-1)))


@op("dot", "blas")
def _dot(ins, attrs):
    """numpy ``dot``: a product for a scalar, matmul up to rank 2, else a
    sum over a's last axis and b's second-to-last."""
    a, b = ins
    if a.dim() == 0 or b.dim() == 0:
        return a * b
    if a.dim() <= 2 and b.dim() <= 2:
        return torch.matmul(a, b)
    return torch.tensordot(a, b, dims=([a.dim() - 1],
                                       [max(b.dim() - 2, 0)]))


@op("einsum", "blas")
def _einsum(ins, attrs):
    return torch.einsum(attrs["equation"], *ins)


# -- linalg -----------------------------------------------------------------
def _source_device(attrs):
    """Where an op with no tensor inputs puts its output: the graph's
    device, which ``SameDiff`` passes in ``attrs["_device"]``."""
    return attrs.get("_device", "cpu")


@op("lu", "linalg")
def _lu(ins, attrs):
    """``(p, l, u)`` with ``x = p @ l @ u`` (``jax.scipy.linalg.lu``)."""
    p, lo, up = torch.linalg.lu(ins[0])
    return p, lo, up


@op("qr", "linalg")
def _qr(ins, attrs):
    q, r = torch.linalg.qr(ins[0], mode="reduced")
    return q, r


@op("cholesky", "linalg")
def _chol(ins, attrs):
    return torch.linalg.cholesky(ins[0])


@op("svd", "linalg")
def _svd(ins, attrs):
    u, s, vh = torch.linalg.svd(
        ins[0], full_matrices=bool(attrs.get("full_matrices", False)))
    return u, s, vh


@op("matrix_inverse", "linalg")
def _inv(ins, attrs):
    return torch.linalg.inv(ins[0])


@op("matrix_determinant", "linalg")
def _det(ins, attrs):
    return torch.linalg.det(ins[0])


@op("triangular_solve", "linalg")
def _trisolve(ins, attrs):
    a, b = ins
    vec = b.dim() == 1                 # scipy takes a vector right side
    x = torch.linalg.solve_triangular(
        a, b[:, None] if vec else b, upper=not attrs.get("lower", True))
    return x[:, 0] if vec else x


@op("solve", "linalg")
def _solve(ins, attrs):
    return torch.linalg.solve(ins[0], ins[1])


@op("trace", "linalg")
def _trace(ins, attrs):
    d = torch.diagonal(ins[0], dim1=-2, dim2=-1).sum(-1)
    return d if _is_float(d) else _int32(d)


@op("diag", "linalg")
def _diag(ins, attrs):
    return torch.diag(ins[0])


@op("diag_part", "linalg")
def _diag_part(ins, attrs):
    return torch.diagonal(ins[0], dim1=-2, dim2=-1)


alias("matrix_diag_part", "diag_part")


@op("eye", "linalg")
def _eye(ins, attrs):
    rows = int(attrs["rows"])
    cols = attrs.get("cols")
    return torch.eye(rows, rows if cols is None else int(cols),
                     dtype=torch_dtype(attrs.get("dtype", "float32")),
                     device=_source_device(attrs))


@op("matrix_diag", "linalg")
def _matrix_diag(ins, attrs):
    v = ins[0]
    return v[..., None] * torch.eye(v.shape[-1], dtype=v.dtype,
                                    device=v.device)


# -- reductions -------------------------------------------------------------
def _sum(x, dim, keep):
    out = torch.sum(x, dim=dim, keepdim=keep)
    return _int32(out) if not _is_float(out) else out


def _mean(x, dim, keep):
    if not _is_float(x):
        x = x.to(torch.float32)
    return torch.mean(x, dim=dim, keepdim=keep)


def _prod(x, dim, keep):
    out = x            # torch.prod takes one dim: innermost first
    for d in sorted((a % max(x.dim(), 1) for a in dim), reverse=True):
        out = torch.prod(out, dim=d, keepdim=keep)
    return _int32(out) if not _is_float(out) else out


def _var(x, dim, keep):
    return torch.var(x, dim=dim, correction=0, keepdim=keep)


def _std(x, dim, keep):
    return torch.std(x, dim=dim, correction=0, keepdim=keep)


def _amax(x, dim, keep):
    return torch.amax(x, dim=dim, keepdim=keep) if x.dim() else x


def _amin(x, dim, keep):
    return torch.amin(x, dim=dim, keepdim=keep) if x.dim() else x


_reduce("reduce_sum", _sum)
_reduce("reduce_mean", _mean)
_reduce("reduce_max", _amax)
_reduce("reduce_min", _amin)
_reduce("reduce_prod", _prod)
_reduce("reduce_std", _std)
_reduce("reduce_var", _var)
alias("sum", "reduce_sum")
alias("mean", "reduce_mean")
alias("amax", "reduce_max")
alias("amin", "reduce_min")


@op("reduce_norm1", "reduce")
def _norm1(ins, attrs):
    x = ins[0]
    return torch.sum(torch.abs(x), dim=_axes(attrs.get("axis"), x.dim()),
                     keepdim=bool(attrs.get("keep_dims", False)))


@op("reduce_norm2", "reduce")
def _norm2(ins, attrs):
    x = ins[0]
    return torch.sqrt(torch.sum(x ** 2, dim=_axes(attrs.get("axis"),
                                                  x.dim()),
                                keepdim=bool(attrs.get("keep_dims",
                                                       False))))


@op("reduce_logsumexp", "reduce")
def _lse(ins, attrs):
    x = ins[0]
    return torch.logsumexp(x, dim=_axes(attrs.get("axis"), x.dim()))


def _scan(x, attrs, fn, identity):
    """TF Cumsum / Cumprod semantics: ``exclusive`` shifts the scan by
    one (the first element is the identity), ``reverse`` scans from the
    end."""
    ax = attrs.get("axis", -1) % x.dim()
    if attrs.get("reverse", False):
        x = torch.flip(x, (ax,))
    y = fn(x, dim=ax)
    if attrs.get("exclusive", False):
        # shift by one (exact: never subtract, which breaks on inf)
        pad = [0, 0] * (x.dim() - 1 - ax) + [1, 0]
        y = F.pad(y, pad, value=identity).narrow(ax, 0, x.shape[ax])
    if attrs.get("reverse", False):
        y = torch.flip(y, (ax,))
    return y


@op("cumsum", "reduce")
def _cumsum(ins, attrs):
    return _scan(ins[0], attrs, torch.cumsum, 0.0)


@op("cumprod", "reduce")
def _cumprod(ins, attrs):
    return _scan(ins[0], attrs, torch.cumprod, 1.0)


@op("reduce_any", "reduce")
def _any(ins, attrs):
    x = ins[0]
    return torch.any(x != 0, dim=_axes(attrs.get("axis"), x.dim()))


@op("reduce_all", "reduce")
def _all(ins, attrs):
    x = ins[0]
    return torch.all(x != 0, dim=_axes(attrs.get("axis"), x.dim()))


# -- indexed reductions -----------------------------------------------------
@op("argmax", "indexreduce")
def _argmax(ins, attrs):
    return _int32(torch.argmax(ins[0], dim=attrs.get("axis", -1)))


@op("argmin", "indexreduce")
def _argmin(ins, attrs):
    return _int32(torch.argmin(ins[0], dim=attrs.get("axis", -1)))


@op("top_k", "indexreduce")
def _topk(ins, attrs):
    """``axis`` (default last) and ``largest`` (default True; False is
    ONNX TopK's smallest mode, a stable ascending argsort)."""
    x = ins[0]
    k = attrs["k"]
    ax = attrs.get("axis", -1) % x.dim()
    if attrs.get("largest", True):
        vals, idx = torch.topk(x, k, dim=ax, largest=True, sorted=True)
    else:
        idx = torch.argsort(x, dim=ax, stable=True).narrow(ax, 0, k)
        vals = torch.gather(x, ax, idx)
    return vals, _int32(idx)


@op("in_top_k", "indexreduce")
def _in_topk(ins, attrs):
    preds, targets = ins
    _, idx = torch.topk(preds, attrs["k"], dim=-1)
    return torch.any(idx == targets.long()[:, None], dim=-1)


# -- boolean / comparison ---------------------------------------------------
_binary("eq", "boolean", torch.eq)
_binary("neq", "boolean", torch.ne)
_binary("gt", "boolean", torch.gt)
_binary("gte", "boolean", torch.ge)
_binary("lt", "boolean", torch.lt)
_binary("lte", "boolean", torch.le)
_binary("logical_and", "boolean", torch.logical_and)
_binary("logical_or", "boolean", torch.logical_or)
_binary("logical_xor", "boolean", torch.logical_xor)
_unary("logical_not", "boolean", torch.logical_not)
_unary("is_nan", "boolean", torch.isnan)
_unary("is_inf", "boolean", torch.isinf)
_unary("is_finite", "boolean", torch.isfinite)


@op("where", "boolean")
def _where(ins, attrs):
    return torch.where(ins[0] != 0, ins[1], ins[2])


alias("select", "where")


# -- bitwise ----------------------------------------------------------------
# XLA defines what C++ leaves undefined: a shift amount is read as
# unsigned, so a negative or over-wide amount shifts every bit out (an
# arithmetic right shift of a negative value leaves -1). The cyclic
# shifts rotate in the unsigned domain of the operand's width.
def _shift_operands(x, s):
    dt = torch.promote_types(x.dtype, s.dtype)
    x, s = x.to(dt), s.to(dt)
    bits = x.element_size() * 8
    wide = (s < 0) | (s >= bits)
    return x, torch.where(wide, torch.zeros_like(s), s), wide


@op("left_shift", "bitwise")
def _lshift(ins, attrs):
    x, k, wide = _shift_operands(ins[0], ins[1])
    return torch.where(wide, torch.zeros_like(x),
                       torch.bitwise_left_shift(x, k))


@op("right_shift", "bitwise")
def _rshift(ins, attrs):
    x, k, wide = _shift_operands(ins[0], ins[1])
    fill = (torch.where(x < 0, torch.full_like(x, -1), torch.zeros_like(x))
            if x.dtype.is_signed else torch.zeros_like(x))
    return torch.where(wide, fill, torch.bitwise_right_shift(x, k))


def _lsr64(x, k):
    """Logical right shift of int64 ``x`` by ``k`` in [0, 63]."""
    high = torch.bitwise_left_shift(torch.ones_like(x),
                                    (64 - k).clamp(max=63)) - 1
    mask = torch.where(k == 0, torch.full_like(x, -1), high)
    return torch.bitwise_right_shift(x, k) & mask


def _rotate(x, s, left: bool):
    bits = x.element_size() * 8
    k = s.to(torch.int64) & (bits - 1)        # s as unsigned, mod bits
    back = (bits - k) & (bits - 1)
    if bits == 64:
        lo, hi = (k, back) if left else (back, k)
        x = x.to(torch.int64)
        return torch.bitwise_left_shift(x, lo) | _lsr64(x, hi)
    m = (1 << bits) - 1
    ux = x.to(torch.int64) & m
    if left:
        r = (torch.bitwise_left_shift(ux, k)
             | torch.bitwise_right_shift(ux, back)) & m
    else:
        r = (torch.bitwise_right_shift(ux, k)
             | torch.bitwise_left_shift(ux, back)) & m
    if x.dtype.is_signed:
        r = torch.where(r >= 1 << (bits - 1), r - (1 << bits), r)
    return r.to(x.dtype)


@op("cyclic_shift_left", "bitwise")
def _rotl(ins, attrs):
    return _rotate(ins[0], ins[1], left=True)


@op("cyclic_shift_right", "bitwise")
def _rotr(ins, attrs):
    return _rotate(ins[0], ins[1], left=False)


_binary("bitwise_and", "bitwise", torch.bitwise_and)
_binary("bitwise_or", "bitwise", torch.bitwise_or)
_binary("bitwise_xor", "bitwise", torch.bitwise_xor)
_unary("bitwise_not", "bitwise", torch.bitwise_not)


# -- shape ops --------------------------------------------------------------
def _static_ints(t) -> list:
    """Integer values of a small index tensor or attr (host side)."""
    if isinstance(t, torch.Tensor):
        return [int(v) for v in t.detach().cpu().reshape(-1).tolist()]
    return [int(v) for v in np.asarray(t).reshape(-1)]


def _index_tensor(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Indices as int64 for torch's indexing, negatives counted from the
    end as numpy's ``take`` does."""
    idx = idx.long()
    return torch.where(idx < 0, idx + n, idx)


def _basic_index(x: torch.Tensor, idx: tuple) -> torch.Tensor:
    """numpy basic indexing (slices of any step, ints, None, Ellipsis);
    torch takes no negative step, so those axes are flipped first."""
    if Ellipsis in idx:
        k = idx.index(Ellipsis)
        used = sum(1 for i in idx if i is not None and i is not Ellipsis)
        idx = idx[:k] + (slice(None),) * (x.dim() - used) + idx[k + 1:]
    out_idx, axis, flips = [], 0, []
    for item in idx:
        if item is None:
            out_idx.append(None)
            continue
        if isinstance(item, slice) and item.step is not None \
                and item.step < 0:
            n = x.shape[axis]
            start, stop, step = item.indices(n)
            # reversed positions start, start+step, ... > stop
            count = max(0, (start - stop - step - 1) // (-step))
            flips.append(axis)
            first = n - 1 - start
            out_idx.append(slice(first, first + count * (-step), -step))
        else:
            out_idx.append(item)
        axis += 1
    if flips:
        x = torch.flip(x, flips)
    return x[tuple(out_idx)]


@op("reshape", "shape")
def _reshape(ins, attrs):
    return torch.reshape(ins[0], [int(s) for s in attrs["shape"]])


@op("permute", "shape")
def _permute(ins, attrs):
    axes = attrs.get("axes")
    if axes is None:
        axes = list(range(ins[0].dim()))[::-1]
    return ins[0].permute(*[int(a) for a in axes])


alias("transpose", "permute")


@op("expand_dims", "shape")
def _expand(ins, attrs):
    x = ins[0]
    ax = attrs["axis"]
    axes = list(ax) if isinstance(ax, (list, tuple)) else [ax]
    nd = x.dim() + len(axes)
    for a in sorted(a % nd for a in axes):
        x = x.unsqueeze(a)
    return x


@op("squeeze", "shape")
def _squeeze(ins, attrs):
    ax = attrs.get("axis")
    if ax is None:
        return torch.squeeze(ins[0])
    return torch.squeeze(ins[0], tuple(ax) if isinstance(ax, (list, tuple))
                         else int(ax))


@op("concat", "shape")
def _concat(ins, attrs):
    return torch.cat(list(ins), dim=attrs.get("axis", 0))


@op("stack", "shape")
def _stack(ins, attrs):
    return torch.stack(list(ins), dim=attrs.get("axis", 0))


@op("unstack", "shape")
def _unstack(ins, attrs):
    return tuple(torch.unbind(ins[0], dim=attrs.get("axis", 0)))


@op("split", "shape")
def _split(ins, attrs):
    x, ax, n = ins[0], attrs.get("axis", 0), attrs["num_splits"]
    if x.shape[ax] % n:
        raise ValueError(f"split: axis {ax} of {tuple(x.shape)} does not "
                         f"divide into {n}")
    return tuple(torch.split(x, x.shape[ax] // n, dim=ax))


@op("split_v", "shape")
def _split_v(ins, attrs):
    return tuple(torch.split(ins[0], [int(s) for s in attrs["size_splits"]],
                             dim=attrs.get("axis", 0)))


@op("tile", "shape")
def _tile(ins, attrs):
    return torch.tile(ins[0], tuple(int(r) for r in attrs["reps"]))


@op("repeat", "shape")
def _repeat(ins, attrs):
    reps = attrs["repeats"]
    if isinstance(reps, (list, tuple)):
        reps = torch.as_tensor(reps, device=ins[0].device)
    return torch.repeat_interleave(ins[0], reps, dim=attrs.get("axis"))


@op("flip", "shape")
def _flip(ins, attrs):
    x = ins[0]
    return torch.flip(x, _axes(attrs.get("axis"), x.dim()))


def _take(p: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    idx = _index_tensor(idx, p.shape[axis])
    out = torch.index_select(p, axis, idx.reshape(-1))
    return out.reshape(p.shape[:axis] + idx.shape + p.shape[axis + 1:])


@op("gather", "shape")
def _gather(ins, attrs):
    """``batch_dims`` (TF GatherV2): the leading b dims of params and
    indices are shared; the take applies per batch element."""
    p, idx = ins[0], ins[1]
    bd = int(attrs.get("batch_dims", 0))
    axis = attrs.get("axis", 0) % p.dim()
    if bd == 0:
        return _take(p, idx, axis)
    lead = p.shape[:bd]
    B = int(np.prod(lead)) if lead else 1
    pb = p.reshape((B,) + p.shape[bd:])
    ib = _index_tensor(idx.reshape((B,) + idx.shape[bd:]), p.shape[axis])
    ax = axis - bd + 1                       # the take axis within pb
    # bring the take axis next to the batch axis, index both at once,
    # then put the axes that sat before it back in front of the indices
    q = pb.movedim(ax, 1)
    rows = torch.arange(B, device=p.device).reshape(
        (B,) + (1,) * (ib.dim() - 1))
    g = q[rows, ib]                  # [B, *ishape, *before, *after]
    ni, nb = ib.dim() - 1, ax - 1
    perm = ([0] + list(range(1 + ni, 1 + ni + nb))
            + list(range(1, 1 + ni))
            + list(range(1 + ni + nb, g.dim())))
    g = g.permute(perm)
    return g.reshape(lead + g.shape[1:])


@op("tensor_list_set_item", "shape")
def _tl_set_item(ins, attrs):
    """A static-size list is a dense ``[n, *element]`` tensor; an index
    out of range clamps to the last slot, as the JAX package's dynamic
    slice update does."""
    lst, idx, item = ins
    i = idx.long().reshape(1).clamp(0, lst.shape[0] - 1)
    return torch.index_put(lst, (i,), item.to(lst.dtype)[None])


@op("tensor_list_get_item", "shape")
def _tl_get_item(ins, attrs):
    lst, idx = ins
    i = idx.long().reshape(1).clamp(0, lst.shape[0] - 1)
    return torch.index_select(lst, 0, i)[0]


@op("tensor_list_length", "shape")
def _tl_length(ins, attrs):
    return torch.tensor(ins[0].shape[0], dtype=torch.int32,
                        device=ins[0].device)


@op("gather_nd", "shape")
def _gather_nd(ins, attrs):
    params, indices = ins
    return params[tuple(indices.long().movedim(-1, 0))]


@op("scatter_update", "shape")
def _scatter_upd(ins, attrs):
    ref, indices, updates = ins
    return torch.index_put(ref, (indices.long(),), updates.to(ref.dtype))


@op("scatter_add", "shape")
def _scatter_add(ins, attrs):
    ref, indices, updates = ins
    return torch.index_put(ref, (indices.long(),), updates.to(ref.dtype),
                           accumulate=True)


def _pad_index(n: int, before: int, after: int, mode: str,
               device) -> torch.Tensor:
    """Source positions of one padded axis for numpy's index-based pad
    modes."""
    j = torch.arange(-before, n + after, device=device)
    if mode == "edge":
        return j.clamp(0, n - 1)
    if mode == "wrap":
        return j % n
    if mode == "reflect":
        if n == 1:
            return torch.zeros_like(j)
        p = 2 * (n - 1)
        j = j % p
        return torch.where(j >= n, p - j, j)
    if mode == "symmetric":
        p = 2 * n
        j = j % p
        return torch.where(j >= n, p - 1 - j, j)
    raise NotImplementedError(f"pad mode {mode!r}")


@op("pad", "shape")
def _pad(ins, attrs):
    x = ins[0]
    mode = attrs.get("mode", "constant").lower()
    pads = [(int(a), int(b)) for a, b in attrs["paddings"]]
    if mode == "constant":
        flat = [v for a, b in reversed(pads) for v in (a, b)]
        return F.pad(x, flat, value=attrs.get("constant", 0.0))
    for ax, (a, b) in enumerate(pads):
        if a or b:
            x = torch.index_select(
                x, ax, _pad_index(x.shape[ax], a, b, mode, x.device))
    return x


@op("slice", "shape")
def _slice(ins, attrs):
    x = ins[0]
    idx = []
    for i, (b, s) in enumerate(zip(attrs["begin"], attrs["size"])):
        e = b + s if s >= 0 else x.shape[i]
        idx.append(slice(b, e))
    return x[tuple(idx)]


@op("strided_slice", "shape")
def _strided_slice(ins, attrs):
    return _basic_index(ins[0], tuple(
        slice(b, e, s) for b, e, s in
        zip(attrs["begin"], attrs["end"], attrs["strides"])))


@op("shape_of", "shape")
def _shape_of(ins, attrs):
    return torch.tensor(list(ins[0].shape), dtype=torch.int32,
                        device=ins[0].device)


@op("size", "shape")
def _size(ins, attrs):
    return torch.tensor(ins[0].numel(), dtype=torch.int32,
                        device=ins[0].device)


@op("rank", "shape")
def _rank(ins, attrs):
    return torch.tensor(ins[0].dim(), dtype=torch.int32,
                        device=ins[0].device)


@op("one_hot", "shape")
def _one_hot(ins, attrs):
    """float32 one-hot; an index outside [0, depth) gives a zero row."""
    idx = ins[0].long()
    depth = int(attrs["depth"])
    oh = (idx[..., None] == torch.arange(depth, device=idx.device)).to(
        torch.float32)
    ax = attrs.get("axis", -1)
    return oh if ax in (-1, idx.dim()) else oh.movedim(-1, ax)


@op("reverse_sequence", "shape")
def _reverse_seq(ins, attrs):
    x, lengths = ins
    sa = attrs.get("seq_axis", 1)
    ba = attrs.get("batch_axis", 0)
    xm = x.movedim((ba, sa), (0, 1))                   # -> [b, t, ...]
    t = xm.shape[1]
    idx = torch.arange(t, device=x.device)
    ln = lengths.long()[:, None]
    rev = torch.where(idx[None, :] < ln, ln - 1 - idx[None, :], idx[None, :])
    rev = rev.reshape(rev.shape + (1,) * (xm.dim() - 2)).expand(xm.shape)
    return torch.gather(xm, 1, rev).movedim((0, 1), (ba, sa))


@op("broadcast_to", "shape")
def _broadcast_to(ins, attrs):
    return torch.broadcast_to(ins[0], [int(s) for s in attrs["shape"]])


@op("zeros_like", "shape")
def _zeros_like(ins, attrs):
    return torch.zeros_like(ins[0])


@op("ones_like", "shape")
def _ones_like(ins, attrs):
    return torch.ones_like(ins[0])


@op("fill", "shape")
def _fill(ins, attrs):
    return torch.full([int(s) for s in attrs["shape"]], attrs["value"],
                      dtype=torch_dtype(attrs.get("dtype", "float32")))


@op("range", "shape")
def _range(ins, attrs):
    start, limit = attrs["start"], attrs["limit"]
    delta = attrs.get("delta", 1)
    if all(isinstance(v, (int, np.integer)) for v in (start, limit, delta)):
        return torch.arange(start, limit, delta, dtype=torch.int32)
    return torch.arange(start, limit, delta, dtype=torch.float32)


@op("linspace", "shape")
def _linspace(ins, attrs):
    return torch.linspace(attrs["start"], attrs["stop"], attrs["num"],
                          dtype=torch.float32)


@op("space_to_depth", "shape")
def _space_to_depth(ins, attrs):
    s = int(attrs.get("block_size", 2))
    b, h, w, c = ins[0].shape
    z = ins[0].reshape(b, h // s, s, w // s, s, c)
    return z.permute(0, 1, 3, 2, 4, 5).reshape(b, h // s, w // s, s * s * c)


@op("depth_to_space", "shape")
def _depth_to_space(ins, attrs):
    s = int(attrs.get("block_size", 2))
    b, h, w, c = ins[0].shape
    co = c // (s * s)
    z = ins[0].reshape(b, h, w, s, s, co)
    return z.permute(0, 1, 3, 2, 4, 5).reshape(b, h * s, w * s, co)


@op("reverse", "shape")
def _reverse(ins, attrs):
    axes = attrs.get("axes")
    if axes is None and len(ins) > 1:
        axes = _static_ints(ins[1])
    return torch.flip(ins[0], tuple(int(a) for a in axes))


@op("roll", "shape")
def _roll(ins, attrs):
    shift = attrs.get("shift")
    axes = attrs.get("axes")
    if shift is None and len(ins) > 2:
        shift, axes = _static_ints(ins[1]), _static_ints(ins[2])
    return torch.roll(ins[0], tuple(int(s) for s in np.atleast_1d(shift)),
                      tuple(int(a) for a in np.atleast_1d(axes)))


@op("scatter_nd", "shape")
def _scatter_nd(ins, attrs):
    idx, updates = ins[0].long(), ins[1]
    shape = attrs.get("shape")
    if shape is None and len(ins) > 2:
        shape = _static_ints(ins[2])
    out = torch.zeros(tuple(int(s) for s in shape), dtype=updates.dtype,
                      device=updates.device)
    return torch.index_put(out, tuple(idx.movedim(-1, 0)), updates,
                           accumulate=True)


@op("scatter_nd_update", "shape")
def _scatter_nd_update(ins, attrs):
    """data, indices [..., d], updates -> data with updates written."""
    data, idx, updates = ins[0], ins[1].long(), ins[2]
    return torch.index_put(data, tuple(idx.movedim(-1, 0)),
                           updates.to(data.dtype))


@op("invert_permutation", "shape")
def _invert_permutation(ins, attrs):
    p = ins[0]
    ar = torch.arange(p.shape[0], dtype=p.dtype, device=p.device)
    return torch.zeros_like(p).scatter(0, p.long(), ar)


def spec_to_index(spec) -> tuple:
    """{"kind": "slice"|"int"|"newaxis"|"ellipsis", ...} items -> a
    python indexing tuple (shared by the 'index' op and the TF
    importer's StridedSlice constant folder)."""
    idx = []
    for item in spec:
        kind = item["kind"]
        if kind == "slice":
            idx.append(slice(item.get("begin"), item.get("end"),
                             item.get("stride")))
        elif kind == "int":
            idx.append(item["i"])
        elif kind == "newaxis":
            idx.append(None)
        elif kind == "ellipsis":
            idx.append(Ellipsis)
        else:
            raise ValueError(f"bad index spec kind {kind!r}")
    return tuple(idx)


@op("index", "shape")
def _index(ins, attrs):
    """Generalized indexing: the importer's lowering of TF StridedSlice
    masks."""
    return _basic_index(ins[0], spec_to_index(attrs["spec"]))


# -- segment ops ------------------------------------------------------------
# Ids are cast to int32; ``num_segments=None`` is ``max(id) + 1`` (a host
# read on the card). An id outside [0, num_segments) is dropped, as the
# JAX package's scatter drops it: such ids go to one extra row that is
# cut off, so no device assert fires and nothing is read back. An empty
# segment holds the reduction's identity (max: -inf or the integer
# minimum, min: +inf or the integer maximum, prod: 1, mean and sqrt_n: 0).
def _segments(data, ids, attrs):
    ids = _int32(ids).long()
    n = attrs.get("num_segments")
    n = int(ids.max()) + 1 if n is None else int(n)
    idx = torch.where((ids >= 0) & (ids < n), ids, torch.full_like(ids, n))
    return idx, n


def _segment_reduce(data, ids, attrs, how):
    idx, n = _segments(data, ids, attrs)
    shape = (n + 1,) + tuple(data.shape[1:])
    if how == "sum":
        out = torch.zeros(shape, dtype=data.dtype, device=data.device)
        return out.index_add(0, idx, data)[:n]
    if how == "prod":
        base = 1
    else:
        info = (torch.finfo if data.dtype.is_floating_point
                else torch.iinfo)(data.dtype)
        base = ((-float("inf") if how == "amax" else float("inf"))
                if data.dtype.is_floating_point
                else (info.min if how == "amax" else info.max))
    out = torch.full(shape, base, dtype=data.dtype, device=data.device)
    index = idx.reshape((-1,) + (1,) * (data.dim() - 1)).expand(data.shape)
    return out.scatter_reduce(0, index, data, reduce=how,
                              include_self=True)[:n]


def _segment_count(data, ids, attrs):
    s = _segment_reduce(data, ids, attrs, "sum")
    c = _segment_reduce(torch.ones_like(data), ids, attrs, "sum")
    return s, torch.clamp(c, min=1)


@op("segment_sum", "segment")
def _segment_sum(ins, attrs):
    return _segment_reduce(ins[0], ins[1], attrs, "sum")


@op("segment_max", "segment")
def _segment_max(ins, attrs):
    return _segment_reduce(ins[0], ins[1], attrs, "amax")


@op("segment_min", "segment")
def _segment_min(ins, attrs):
    return _segment_reduce(ins[0], ins[1], attrs, "amin")


@op("segment_prod", "segment")
def _segment_prod(ins, attrs):
    return _segment_reduce(ins[0], ins[1], attrs, "prod")


@op("segment_mean", "segment")
def _segment_mean(ins, attrs):
    s, c = _segment_count(ins[0], ins[1], attrs)
    return s / c


@op("unsorted_segment_sqrt_n", "segment")
def _segment_sqrt_n(ins, attrs):
    s, c = _segment_count(ins[0], ins[1], attrs)
    return s / torch.sqrt(c if _is_float(c) else c.to(torch.float32))


# the unsorted spellings: a scatter takes ids in any order
for _n in ("sum", "max", "min", "mean", "prod"):
    alias(f"unsorted_segment_{_n}", f"segment_{_n}")


# -- normalization ----------------------------------------------------------
@op("layer_norm", "normalization")
def _layer_norm(ins, attrs):
    """``(x - mean) / sqrt(biased var + eps) * gain + bias`` over
    ``axis``; the last axis with 1-D gain and bias runs as one
    ``F.layer_norm``."""
    x = ins[0]
    gain = ins[1] if len(ins) > 1 else None
    bias = ins[2] if len(ins) > 2 else None
    axis = attrs.get("axis", -1)
    eps = float(attrs.get("epsilon", 1e-5))
    last = isinstance(axis, int) and axis in (-1, x.dim() - 1)
    if last and all(t is None or (t.dim() == 1 and t.dtype == x.dtype)
                    for t in (gain, bias)):
        return F.layer_norm(x, (x.shape[-1],), gain, bias, eps)
    dims = _axes(axis, x.dim())
    mu = torch.mean(x, dim=dims, keepdim=True)
    var = torch.var(x, dim=dims, correction=0, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    if gain is not None:
        y = y * gain
    if bias is not None:
        y = y + bias
    return y


@op("batch_norm", "normalization")
def _batch_norm(ins, attrs):
    x, mean, var, gamma, beta = ins
    eps = attrs.get("epsilon", 1e-5)
    return (x - mean) * torch.rsqrt(var + eps) * gamma + beta


@op("lrn", "normalization")
def _lrn(ins, attrs):
    """Local response normalization over the channel (last) axis."""
    x = ins[0]
    depth = attrs.get("depth", 5)
    bias = attrs.get("bias", 1.0)
    alpha = attrs.get("alpha", 1.0)
    beta = attrs.get("beta", 0.5)
    half = depth // 2
    padded = F.pad(x * x, (half, half))
    c = x.shape[-1]
    win = sum(padded[..., i:i + c] for i in range(depth))
    return x / torch.pow(bias + alpha * win, beta)


@op("standardize", "normalization")
def _standardize(ins, attrs):
    x = ins[0]
    dims = _axes(attrs.get("axis", -1), x.dim())
    mu = torch.mean(x, dim=dims, keepdim=True)
    sd = torch.std(x, dim=dims, correction=0, keepdim=True)
    return (x - mu) / torch.clamp(sd, min=1e-12)


@op("moments", "normalization")
def _moments(ins, attrs):
    x = ins[0]
    dims = _axes(attrs.get("axis"), x.dim())
    return (torch.mean(x, dim=dims),
            torch.var(x, dim=dims, correction=0))


# -- convolution ------------------------------------------------------------
# Channels-last activations and spatial-first kernels ([*K, in, out]), as
# lax.conv_general_dilated takes them in the JAX package. torch's
# convolutions read the channels-first view of the same storage
# (``movedim``: no copy), so a contiguous NHWC tensor reaches cuDNN in its
# channels-last layout, and the output's view back is contiguous NHWC.
def _same_pads(sizes, windows, strides):
    """lax.padtype_to_pads: ``SAME`` pads ``total // 2`` before and the
    rest after, so an odd total pads more at the end."""
    out = []
    for n, k, s in zip(sizes, windows, strides):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        out.append((total // 2, total - total // 2))
    return out


def _pads(padding, sizes, windows, strides):
    """(lo, hi) per spatial axis from ``"SAME"``, ``"VALID"`` or
    explicit pairs (a pair per spatial axis, or per axis of the whole
    array as ``lax.reduce_window`` takes them)."""
    if isinstance(padding, str):
        if padding.upper() == "SAME":
            return _same_pads(sizes, windows, strides)
        if padding.upper() == "VALID":
            return [(0, 0)] * len(sizes)
        raise ValueError(f"padding {padding!r}")
    pairs = [(int(a), int(b)) for a, b in padding]
    return pairs[1:-1] if len(pairs) == len(sizes) + 2 else pairs


def _flat_pads(pads):
    """(lo, hi) pairs in axis order -> ``F.pad``'s last-axis-first list."""
    return [v for lo, hi in reversed(pads) for v in (lo, hi)]


def _tuple(v, n):
    return tuple(int(a) for a in v) if isinstance(v, (list, tuple)) \
        else (int(v),) * n


def _dilate(x, rates):
    """``x`` ``[N, C, *S]`` with ``rate - 1`` zeros between neighbours
    along each spatial axis (lax's lhs dilation)."""
    out = x.new_zeros(x.shape[:2] + tuple((n - 1) * r + 1 for n, r in
                                          zip(x.shape[2:], rates)))
    out[(slice(None), slice(None))
        + tuple(slice(None, None, r) for r in rates)] = x
    return out


def _conv(x, w, stride, padding, dilation=None, groups=1,
          lhs_dilation=None):
    """lax.conv_general_dilated of channels-last ``x`` and ``w`` ``[*K,
    I, O]``; ``padding`` is ``"SAME"``, ``"VALID"`` or (lo, hi) pairs."""
    nsp = x.dim() - 2
    stride = _tuple(stride, nsp)
    dilation = _tuple(dilation or 1, nsp)
    xs = x.movedim(-1, 1)
    wt = w.permute(nsp + 1, nsp, *range(nsp))
    if lhs_dilation is not None and any(r > 1 for r in lhs_dilation):
        xs = _dilate(xs, lhs_dilation)
    windows = [(k - 1) * d + 1 for k, d in zip(w.shape[:nsp], dilation)]
    pads = _pads(padding, xs.shape[2:], windows, stride)
    conv = (F.conv1d, F.conv2d, F.conv3d)[nsp - 1]
    if all(lo == hi and lo >= 0 for lo, hi in pads):
        y = conv(xs, wt, None, stride, [lo for lo, _ in pads], dilation,
                 groups)
    else:
        y = conv(F.pad(xs, _flat_pads(pads)), wt, None, stride, 0,
                 dilation, groups)
    return y.movedim(1, -1)


def _with_bias(out, ins, k):
    return out + ins[k] if len(ins) > k else out


@op("conv2d", "convolution")
def _conv2d(ins, attrs):
    return _with_bias(_conv(ins[0], ins[1], attrs.get("stride", (1, 1)),
                            attrs.get("padding", "SAME"),
                            attrs.get("dilation", (1, 1))), ins, 2)


@op("conv1d", "convolution")
def _conv1d(ins, attrs):
    return _with_bias(_conv(ins[0], ins[1], attrs.get("stride", 1),
                            attrs.get("padding", "SAME"),
                            attrs.get("dilation", 1)), ins, 2)


@op("conv3d", "convolution")
def _conv3d(ins, attrs):
    return _with_bias(_conv(ins[0], ins[1], attrs.get("stride", (1, 1, 1)),
                            attrs.get("padding", "SAME"),
                            attrs.get("dilation", (1, 1, 1))), ins, 2)


def _depthwise_conv(x, w, attrs):
    """``w`` ``[H, W, C, M]``: output channel ``c * M + m`` is input
    channel ``c`` through ``w[..., c, m]`` (the JAX package takes no
    dilation here)."""
    kh, kw, c, m = w.shape
    return _conv(x, w.reshape(kh, kw, 1, c * m), attrs.get("stride", (1, 1)),
                 attrs.get("padding", "SAME"), groups=c)


@op("depthwise_conv2d", "convolution")
def _depthwise(ins, attrs):
    return _with_bias(_depthwise_conv(ins[0], ins[1], attrs), ins, 2)


@op("separable_conv2d", "convolution")
def _separable(ins, attrs):
    y = _depthwise_conv(ins[0], ins[1], attrs)
    return _with_bias(_conv(y, ins[2], (1, 1), "VALID"), ins, 3)


def _transpose_pads(k: int, s: int, padding: str):
    """lax's ``_conv_transpose_padding`` for ``SAME`` / ``VALID``."""
    if padding == "SAME":
        total = k + s - 2
        lo = k - 1 if s > k - 1 else int(np.ceil(total / 2))
    else:
        total = k + s - 2 + max(k - s, 0)
        lo = k - 1
    return lo, total - lo


@op("deconv2d", "convolution")
def _deconv2d(ins, attrs):
    """lax.conv_transpose: a convolution of the input dilated by the
    stride (a string padding gives the transposed pads); with
    ``transpose_kernel`` (TF's ``Conv2DBackpropInput``) the kernel is
    flipped spatially and its in/out axes swapped."""
    x, w = ins[0], ins[1]
    stride = _tuple(attrs.get("stride", (1, 1)), 2)
    dil = _tuple(attrs.get("dilation", (1, 1)), 2)
    padding = attrs.get("padding", "SAME")
    if isinstance(padding, str) and padding.upper() in ("SAME", "VALID"):
        pads = [_transpose_pads((k - 1) * d + 1, s, padding.upper())
                for k, s, d in zip(w.shape[:2], stride, dil)]
    else:
        pads = [(int(a), int(b)) for a, b in padding]
    if attrs.get("transpose_kernel", False):
        w = torch.flip(w, (0, 1)).transpose(2, 3)
    return _with_bias(_conv(x, w, (1, 1), pads, dil, lhs_dilation=stride),
                      ins, 2)


def _pool(x, kind, window, strides, padding):
    """lax.reduce_window over the spatial axes of channels-last ``x``:
    ``max`` pads with -inf, ``avg`` divides each window's sum by the
    count of real (unpadded) elements in it."""
    nsp = x.dim() - 2
    window, strides = _tuple(window, nsp), _tuple(strides, nsp)
    xs = x.movedim(-1, 1)
    pads = _flat_pads(_pads(padding, xs.shape[2:], window, strides))
    if kind == "max":
        if any(pads):
            xs = F.pad(xs, pads, value=-float("inf"))
        pool = (F.max_pool1d, F.max_pool2d, F.max_pool3d)[nsp - 1]
        return pool(xs, window, strides).movedim(1, -1)

    def window_sums(t):
        t = F.pad(t, pads) if any(pads) else t
        if nsp == 1:
            return F.avg_pool2d(t[:, :, None], (1,) + window,
                                (1,) + strides, divisor_override=1)[:, :, 0]
        return (F.avg_pool2d if nsp == 2 else F.avg_pool3d)(
            t, window, strides, divisor_override=1)

    s = window_sums(xs)
    cnt = window_sums(xs.new_ones((1, 1) + tuple(xs.shape[2:])))
    return (s / cnt).movedim(1, -1)


def _pool_op(name, kind, nsp):
    def impl(ins, attrs):
        return _pool(ins[0], kind, attrs.get("kernel", (2,) * nsp),
                     attrs.get("stride", (2,) * nsp),
                     attrs.get("padding", "VALID"))
    OP_REGISTRY[name] = impl
    OP_DOMAINS[name] = "convolution"


for _nsp in (1, 2, 3):
    _pool_op(f"max_pool{_nsp}d", "max", _nsp)
    _pool_op(f"avg_pool{_nsp}d", "avg", _nsp)


@op("upsampling2d", "convolution")
def _upsample(ins, attrs):
    s = attrs.get("scale", 2)
    sh, sw = (s, s) if isinstance(s, int) else s
    return torch.repeat_interleave(
        torch.repeat_interleave(ins[0], int(sh), dim=1), int(sw), dim=2)


@op("im2col", "convolution")
def _im2col(ins, attrs):
    """Patches as columns, NHWC: the JAX package's gather of ``[b, oh,
    kh, ow, kw, c]`` and its reshape to ``[b, oh, ow, kh * kw * c]``."""
    x = ins[0]
    kh, kw = attrs["kernel"]
    sh, sw = attrs.get("stride", (1, 1))
    b, h, w, c = x.shape
    oh, ow = (h - kh) // sh + 1, (w - kw) // sw + 1
    dev = x.device
    rows = (torch.arange(oh, device=dev) * sh)[:, None, None, None] + \
        torch.arange(kh, device=dev)[None, :, None, None]
    cols = (torch.arange(ow, device=dev) * sw)[None, None, :, None] + \
        torch.arange(kw, device=dev)[None, None, None, :]
    return x[:, rows, cols, :].reshape(b, oh, ow, kh * kw * c)


# -- image ------------------------------------------------------------------
def _f32(v) -> np.ndarray:
    return np.asarray(v, np.float32)


def _linear_weights(in_size: int, out_size: int) -> np.ndarray:
    """[in, out] weights of ``jax.image.resize``'s linear method, which
    antialiases when it downsamples (its triangle kernel widens by
    in/out), computed in float32 in its order of operations."""
    scale = out_size / in_size
    inv = 1.0 / scale
    kscale = _f32(max(inv, 1.0))
    sample = (np.arange(out_size, dtype=np.float32) + _f32(0.5)) * \
        _f32(inv) - _f32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float32)
               [:, None]) / kscale
    w = np.maximum(_f32(0.0), _f32(1.0) - np.abs(x))
    total = np.sum(w, axis=0, keepdims=True, dtype=np.float32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, _f32(1.0)), _f32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, _f32(0.0)).astype(np.float32)


def _cubic_weights(out_size: int, in_size: int, a: float,
                   boundary: str) -> np.ndarray:
    """[out, in] separable Keys-cubic interpolation weights with
    half-pixel centers (the JAX package's table): TF ResizeBicubic is
    a=-0.5 with out-of-range taps dropped and the row renormalized
    ("renorm"); torch/ONNX is a=-0.75 with indices clamped to the edge
    ("clamp")."""
    s = in_size / out_size
    src = (np.arange(out_size) + 0.5) * s - 0.5
    base = np.floor(src).astype(np.int64)
    frac = src - base
    w = np.zeros((out_size, in_size), np.float64)
    for o in (-1, 0, 1, 2):
        t = np.abs(frac - o)
        k = np.where(
            t <= 1, (a + 2) * t**3 - (a + 3) * t**2 + 1,
            np.where(t < 2, a * (t**3 - 5 * t**2 + 8 * t - 4), 0.0))
        idx = base + o
        if boundary == "renorm":
            k = np.where((idx < 0) | (idx >= in_size), 0.0, k)
        idx = np.clip(idx, 0, in_size - 1)
        np.add.at(w, (np.arange(out_size), idx), k)
    if boundary == "renorm":
        w /= w.sum(axis=1, keepdims=True)
    return w.astype(np.float32)


def _area_weights(out_size: int, in_size: int) -> np.ndarray:
    """[out, in] row-stochastic overlap weights for area resize: output
    cell i integrates the input cells overlapping [i*s, (i+1)*s),
    s=in/out, by overlap fraction (the TF ResizeArea algorithm)."""
    s = in_size / out_size
    i = np.arange(out_size)[:, None]
    j = np.arange(in_size)[None, :]
    overlap = np.minimum((i + 1) * s, j + 1) - np.maximum(i * s, j)
    return (np.clip(overlap, 0.0, 1.0) / s).astype(np.float32)


def _separable_resize(x, wh, ww):
    """``einsum("oh,bhwc->bowc")`` then ``("ow,bhwc->bhoc")`` with ``[out,
    in]`` tables, in float32 (float64 stays float64); a floating input
    keeps its dtype."""
    dt = (torch.promote_types(x.dtype, torch.float32) if _is_float(x)
          else torch.float32)
    y = x.to(dt)
    y = torch.einsum("oh,bhwc->bowc", torch.as_tensor(wh, device=x.device,
                                                      dtype=dt), y)
    y = torch.einsum("ow,bhwc->bhoc", torch.as_tensor(ww, device=x.device,
                                                      dtype=dt), y)
    return y.to(x.dtype) if _is_float(x) else y


@op("resize_bilinear", "image")
def _resize_bilinear(ins, attrs):
    """``jax.image.resize(..., "bilinear")``: half-pixel centers, an
    axis of unchanged size left alone, antialiased downsampling."""
    x = ins[0]
    h, w = (int(v) for v in attrs["size"])
    y = x if _is_float(x) else x.to(torch.float32)
    if h != x.shape[1]:
        y = torch.einsum("hb,nhwc->nbwc", torch.as_tensor(
            _linear_weights(x.shape[1], h), device=x.device).to(y.dtype), y)
    if w != x.shape[2]:
        y = torch.einsum("wb,nhwc->nhbc", torch.as_tensor(
            _linear_weights(x.shape[2], w), device=x.device).to(y.dtype), y)
    return y


def _nearest_index(n_in: int, n_out: int, device) -> torch.Tensor:
    """``jax.image.resize``'s nearest: floor((o + 0.5) * in / out) in
    float32 (half-pixel, torch's ``nearest-exact``)."""
    off = (np.arange(n_out, dtype=np.float32) + _f32(0.5)) * \
        _f32(n_in) / _f32(n_out)
    return torch.as_tensor(np.floor(off.astype(np.float32)).astype(
        np.int64), device=device)


@op("resize_nearest", "image")
def _resize_nearest(ins, attrs):
    x = ins[0]
    h, w = (int(v) for v in attrs["size"])
    if attrs.get("coordinate_mode") == "asymmetric":
        # ONNX/torch nearest export convention (asymmetric + floor):
        # src index = floor(dst * in/out)
        iy = torch.as_tensor(np.floor(np.arange(h) * (x.shape[1] / h))
                             .astype(np.int64), device=x.device)
        ix = torch.as_tensor(np.floor(np.arange(w) * (x.shape[2] / w))
                             .astype(np.int64), device=x.device)
        return x[:, iy][:, :, ix]
    if h != x.shape[1]:
        x = x[:, _nearest_index(x.shape[1], h, x.device)]
    if w != x.shape[2]:
        x = x[:, :, _nearest_index(x.shape[2], w, x.device)]
    return x


@op("resize_bicubic", "image")
def _resize_bicubic(ins, attrs):
    x = ins[0]
    h, w = attrs["size"]
    a = float(attrs.get("cubic_coeff_a", -0.5))
    boundary = attrs.get("boundary", "renorm")
    return _separable_resize(x, _cubic_weights(h, x.shape[1], a, boundary),
                             _cubic_weights(w, x.shape[2], a, boundary))


@op("resize_area", "image")
def _resize_area(ins, attrs):
    x = ins[0]
    h, w = attrs["size"]
    return _separable_resize(x, _area_weights(h, x.shape[1]),
                             _area_weights(w, x.shape[2]))


@op("crop_and_resize", "image")
def _crop_resize(ins, attrs):
    """Bilinear crops of ``boxes`` ``[n, 4]`` (y1, x1, y2, x2 in [0, 1]
    of the image's ``h - 1`` / ``w - 1``) from images ``box_idx``; a
    sample outside the image clamps to its edge."""
    img, boxes, box_idx = ins
    ch, cw = (int(v) for v in attrs["crop_size"])
    h, w = img.shape[1], img.shape[2]
    dev = img.device
    y1, x1, y2, x2 = boxes.unbind(-1)
    ry = torch.arange(ch, device=dev, dtype=boxes.dtype) / max(ch - 1, 1)
    rx = torch.arange(cw, device=dev, dtype=boxes.dtype) / max(cw - 1, 1)
    ys = (y1 * (h - 1))[:, None] + ry[None, :] * (y2 - y1)[:, None] * (h - 1)
    xs = (x1 * (w - 1))[:, None] + rx[None, :] * (x2 - x1)[:, None] * (w - 1)
    y0 = torch.clamp(torch.floor(ys).long(), 0, h - 1)
    x0 = torch.clamp(torch.floor(xs).long(), 0, w - 1)
    y1i = torch.clamp(y0 + 1, 0, h - 1)
    x1i = torch.clamp(x0 + 1, 0, w - 1)
    wy = (ys - y0)[:, :, None, None]
    wx = (xs - x0)[:, None, :, None]
    b = box_idx.long()[:, None, None]

    def at(yi, xi):
        return img[b, yi[:, :, None], xi[:, None, :]]

    return (at(y0, x0) * (1 - wy) * (1 - wx) + at(y0, x1i) * (1 - wy) * wx
            + at(y1i, x0) * wy * (1 - wx) + at(y1i, x1i) * wy * wx)


@op("extract_image_patches", "image")
def _extract_patches(ins, attrs):
    return _im2col(ins, attrs)


@op("non_max_suppression", "image")
def _nms(ins, attrs):
    """Greedy NMS over a static loop of ``max_output_size`` picks: the
    highest remaining score (the first index of a tie), then every box
    whose IoU with it exceeds the threshold is suppressed. Slots left
    once every box is picked or suppressed hold -1 (int32)."""
    boxes, scores = ins
    iou_thr = attrs.get("iou_threshold", 0.5)
    neg = torch.full_like(scores, -float("inf"))
    pos = torch.arange(scores.shape[0], device=scores.device)
    area_b = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    sc, picks = scores, []
    for _ in range(int(attrs["max_output_size"])):
        i = torch.argmax(sc)
        valid = sc[i] > -float("inf")
        picks.append(torch.where(valid, i, torch.full_like(i, -1)))
        a = boxes[i]
        inter = (torch.clamp(torch.minimum(a[2], boxes[:, 2])
                             - torch.maximum(a[0], boxes[:, 0]), min=0)
                 * torch.clamp(torch.minimum(a[3], boxes[:, 3])
                               - torch.maximum(a[1], boxes[:, 1]), min=0))
        area_a = (a[2] - a[0]) * (a[3] - a[1])
        iou = inter / torch.clamp(area_a + area_b - inter, min=1e-9)
        sc = torch.where(valid & (iou > iou_thr), neg, sc)
        sc = torch.where(pos == i, neg, sc)
    return _int32(torch.stack(picks))


# -- random -----------------------------------------------------------------
# ``attrs["rng"]`` is the op's ``RngKey``; its generator lives on the
# device the output does (the card's Philox there), so the card's and the
# CPU's draws differ, and a draw depends on the key alone.
def _rng_generator(attrs, device):
    rng = attrs.get("rng")
    if rng is None:
        raise ValueError("a random op needs attrs['rng'] (SameDiff passes "
                         "each random op a key of its own)")
    return rng.generator(device)


def _draw(attrs, fn, shape, device):
    device = torch.device(device)
    if device.type == "meta":          # shapes only
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return fn(shape, generator=_rng_generator(attrs, device),
              device=device, dtype=torch.float32)


@op("random_normal", "random")
def _rand_normal(ins, attrs):
    z = _draw(attrs, torch.randn, tuple(attrs["shape"]),
              _source_device(attrs))
    return attrs.get("mean", 0.0) + attrs.get("stddev", 1.0) * z


@op("random_uniform", "random")
def _rand_uniform(ins, attrs):
    lo, hi = attrs.get("min", 0.0), attrs.get("max", 1.0)
    u = _draw(attrs, torch.rand, tuple(attrs["shape"]),
              _source_device(attrs))
    return torch.clamp(u * (hi - lo) + lo, min=lo)


@op("random_bernoulli", "random")
def _rand_bern(ins, attrs):
    u = _draw(attrs, torch.rand, tuple(attrs["shape"]),
              _source_device(attrs))
    return (u < attrs.get("prob", 0.5)).to(torch.float32)


@op("dropout", "random")
def _dropout(ins, attrs):
    """Inverted dropout of drop probability ``rate``: ``where(keep, x /
    (1 - rate), 0)``; the identity when not training or without a key."""
    x = ins[0]
    p = attrs.get("rate", 0.5)
    if attrs.get("rng") is None or not attrs.get("training", True):
        return x
    keep = _draw(attrs, torch.rand, tuple(x.shape), x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


# -- losses -----------------------------------------------------------------
def _apply_weights_reduce(loss, weights, reduction):
    if weights is not None:
        loss = loss * weights
    if reduction == "none":
        return loss
    if reduction == "sum":
        return torch.sum(loss)
    return torch.mean(loss)


def _weights(ins):
    return ins[2] if len(ins) > 2 else None


@op("softmax_cross_entropy", "loss")
def _sce(ins, attrs):
    labels, logits = ins[0], ins[1]
    ls = attrs.get("label_smoothing", 0.0)
    if ls:
        labels = labels * (1 - ls) + ls / labels.shape[-1]
    loss = -torch.sum(labels * torch.log_softmax(logits, -1), dim=-1)
    return _apply_weights_reduce(loss, _weights(ins),
                                 attrs.get("reduction", "mean"))


@op("sparse_softmax_cross_entropy", "loss")
def _ssce(ins, attrs):
    """Integer labels against the last axis of the logits; reduction
    ``mean`` (default), ``sum`` or ``none``."""
    labels, logits = ins[0], ins[1]
    lp = torch.log_softmax(logits, -1)
    loss = -torch.gather(lp, -1, labels.long()[..., None])[..., 0]
    return _apply_weights_reduce(loss, None,
                                 attrs.get("reduction", "mean"))


@op("sigmoid_cross_entropy", "loss")
def _bce(ins, attrs):
    labels, logits = ins[0], ins[1]
    loss = torch.clamp(logits, min=0) - logits * labels + \
        torch.log1p(torch.exp(-torch.abs(logits)))
    return _apply_weights_reduce(loss, _weights(ins),
                                 attrs.get("reduction", "mean"))


@op("mean_squared_error", "loss")
def _mse_loss(ins, attrs):
    loss = (ins[0] - ins[1]) ** 2
    return _apply_weights_reduce(loss, _weights(ins),
                                 attrs.get("reduction", "mean"))


@op("absolute_difference", "loss")
def _mae_loss(ins, attrs):
    loss = torch.abs(ins[0] - ins[1])
    return _apply_weights_reduce(loss, _weights(ins),
                                 attrs.get("reduction", "mean"))


@op("huber_loss", "loss")
def _huber(ins, attrs):
    d = attrs.get("delta", 1.0)
    err = ins[0] - ins[1]
    loss = torch.where(torch.abs(err) <= d, 0.5 * err ** 2,
                       d * (torch.abs(err) - 0.5 * d))
    return _apply_weights_reduce(loss, _weights(ins),
                                 attrs.get("reduction", "mean"))


@op("log_loss", "loss")
def _log_loss(ins, attrs):
    labels, preds = ins[0], ins[1]
    eps = attrs.get("epsilon", 1e-7)
    loss = -(labels * torch.log(preds + eps) +
             (1 - labels) * torch.log(1 - preds + eps))
    return _apply_weights_reduce(loss, _weights(ins),
                                 attrs.get("reduction", "mean"))


@op("cosine_distance", "loss")
def _cos_loss(ins, attrs):
    a, b = ins[0], ins[1]
    loss = 1.0 - torch.sum(a * b, dim=attrs.get("axis", -1))
    return _apply_weights_reduce(loss, None,
                                 attrs.get("reduction", "mean"))


@op("hinge_loss", "loss")
def _hinge(ins, attrs):
    labels, logits = ins[0], ins[1]
    signed = 2.0 * labels - 1.0
    loss = torch.clamp(1.0 - signed * logits, min=0.0)
    return _apply_weights_reduce(loss, None,
                                 attrs.get("reduction", "mean"))


# -- attention --------------------------------------------------------------
@op("apply_key_mask", "attention")
def _apply_key_mask(ins, attrs):
    """Pre-softmax mask select: ``where(mask > 0, scores, neg)``, the
    strength-reduced form of the exporter's additive ``(1-mask)*neg``
    bias chain (``passes.mask_strength_reduce``): the same post-softmax
    values for any row with >= 1 unmasked key."""
    x, m = ins[0], ins[1]
    neg = torch.tensor(attrs.get("neg", -1e9), dtype=x.dtype,
                       device=x.device)
    return torch.where(m > 0, x, neg)


@op("sdpa_core", "attention")
def _sdpa_core(ins, attrs):
    """Fused ``softmax(q kᵀ · scale [+ bias | masked]) v`` on ``[..., t,
    dh]`` tensors: the target of ``passes.attention_fuse``.

    ``attrs["mask_mode"] == "key"`` marks the 4th input as a key mask (0
    = masked, broadcastable to the scores) instead of an additive bias.
    ``ops/attention.py`` dispatches through the ladder of
    ``ops/attention_kernels.py``: on the card the flash kernels take every
    site without an additive bias whose mask reduces to a key mask; a
    bias or a per-query mask (the ladder's structural rungs) and the kill
    switch ``DL4J_TORCH_FLASH_ATTENTION=0`` take the dense chain, which
    is also the CPU's path."""
    from deeplearning4j_tpu_torch.ops.attention import dot_product_attention
    q, k, v = ins[0], ins[1], ins[2]
    extra = ins[3] if len(ins) > 3 else None
    if attrs.get("mask_mode") == "key":
        mask, bias = extra, None
    else:
        mask, bias = None, extra
    return dot_product_attention(q, k, v, mask=mask,
                                 scale=attrs.get("scale", 1.0), bias=bias)


@op("dot_product_attention", "attention")
def _dpa(ins, attrs):
    from deeplearning4j_tpu_torch.ops.attention import dot_product_attention
    mask = ins[3] if len(ins) > 3 else None
    return dot_product_attention(ins[0], ins[1], ins[2], mask,
                                 scale=attrs.get("scale"))


@op("multi_head_dot_product_attention", "attention")
def _mhdpa(ins, attrs):
    # x: [b, t, d]; Wq/Wk/Wv: [d, h*dh]; Wo: [h*dh, d]
    from deeplearning4j_tpu_torch.ops.attention import multi_head_attention
    x, wq, wk, wv, wo = ins[0], ins[1], ins[2], ins[3], ins[4]
    mask = ins[5] if len(ins) > 5 else None
    params = {"Wq": wq, "Wk": wk, "Wv": wv, "Wo": wo}
    return multi_head_attention(params, x, x, attrs["num_heads"],
                                key_mask=mask)


# -- recurrent -----------------------------------------------------------------
# Gate order [i, f, o, g] on the last weight axis (the JAX package's, not
# cuDNN's [i, f, g, o]). The layer ops loop over time in Python and stack
# their outputs; the input projection of every step is one product
# hoisted out of the loop.
def _lstm_step(z, c_prev, H):
    i = torch.sigmoid(z[:, :H])
    f = torch.sigmoid(z[:, H:2 * H])
    o = torch.sigmoid(z[:, 2 * H:3 * H])
    g = torch.tanh(z[:, 3 * H:])
    c = f * c_prev + i * g
    return o * torch.tanh(c), c


@op("lstm_cell", "recurrent")
def _lstm_cell(ins, attrs):
    x, h_prev, c_prev, w, rw, b = ins
    return _lstm_step(x @ w + h_prev @ rw + b, c_prev, h_prev.shape[-1])


@op("gru_cell", "recurrent")
def _gru_cell(ins, attrs):
    x, h_prev, w, rw, b = ins
    H = h_prev.shape[-1]
    xw = x @ w + b
    hr = h_prev @ rw
    r = torch.sigmoid(xw[:, :H] + hr[:, :H])
    zt = torch.sigmoid(xw[:, H:2 * H] + hr[:, H:2 * H])
    n = torch.tanh(xw[:, 2 * H:] + r * hr[:, 2 * H:])
    return (1 - zt) * n + zt * h_prev


@op("sru_cell", "recurrent")
def _sru_cell(ins, attrs):
    x, c_prev, w, b = ins
    H = c_prev.shape[-1]
    z = x @ w + b
    f = torch.sigmoid(z[:, H:2 * H])
    r = torch.sigmoid(z[:, 2 * H:3 * H])
    c = f * c_prev + (1 - f) * z[:, :H]
    return r * torch.tanh(c) + (1 - r) * x[:, :H], c


@op("lstm_layer", "recurrent")
def _lstm_layer(ins, attrs):
    """Full-sequence LSTM (reference: libnd4j lstmLayer). Inputs: x [b,
    t, f], h0 [b, H], c0 [b, H], w [f, 4H], rw [H, 4H], b [4H]. Returns
    (h_seq [b, t, H], h_last, c_last)."""
    x, h, c, w, rw, b = ins
    H = h.shape[-1]
    xw = x @ w
    hs = []
    for s in range(x.shape[1]):
        h, c = _lstm_step(xw[:, s] + h @ rw + b, c, H)
        hs.append(h)
    return torch.stack(hs, 1), h, c


@op("rnn_layer", "recurrent")
def _rnn_layer(ins, attrs):
    """Full-sequence vanilla RNN (ONNX RNN): h_t = tanh(x_t W + h_{t-1} R
    + b). Inputs: x [b, t, f], h0 [b, H], w [f, H], rw [H, H], b [H].
    Returns (h_seq [b, t, H], h_last)."""
    x, h, w, rw, b = ins
    xw = x @ w
    hs = []
    for s in range(x.shape[1]):
        h = torch.tanh(xw[:, s] + h @ rw + b)
        hs.append(h)
    return torch.stack(hs, 1), h


@op("gru_layer", "recurrent")
def _gru_layer(ins, attrs):
    """Full-sequence GRU, ONNX semantics: gate order (z, r, h) on the
    last weight axis, ``linear_before_reset`` per the spec. Inputs: x
    [b, t, f], h0 [b, H], w [f, 3H], rw [H, 3H], wb [3H], rb [3H].
    Returns (h_seq [b, t, H], h_last)."""
    x, h, w, rw, wb, rb = ins
    H = h.shape[-1]
    lbr = bool(attrs.get("linear_before_reset", False))
    xz_all = x @ w + wb
    hs = []
    for s in range(x.shape[1]):
        xz = xz_all[:, s]
        hz = h @ (rw if lbr else rw[:, :2 * H])
        z = torch.sigmoid(xz[:, :H] + hz[:, :H] + rb[:H])
        r = torch.sigmoid(xz[:, H:2 * H] + hz[:, H:2 * H] + rb[H:2 * H])
        if lbr:
            n = torch.tanh(xz[:, 2 * H:] + r * (hz[:, 2 * H:] + rb[2 * H:]))
        else:
            n = torch.tanh(xz[:, 2 * H:] + (r * h) @ rw[:, 2 * H:]
                           + rb[2 * H:])
        h = (1.0 - z) * n + z * h
        hs.append(h)
    return torch.stack(hs, 1), h


@op("sru", "recurrent")
def _sru_layer(ins, attrs):
    """Full-sequence SRU (reference: libnd4j sru). Inputs: x [b, t, f],
    c0 [b, H], w [f, 3H], b [3H] with H == f. Returns (out_seq [b, t,
    H], c_last)."""
    x, c, w, b = ins
    H = c.shape[-1]
    z_all = x @ w + b
    outs = []
    for s in range(x.shape[1]):
        z = z_all[:, s]
        f = torch.sigmoid(z[:, H:2 * H])
        r = torch.sigmoid(z[:, 2 * H:3 * H])
        c = f * c + (1 - f) * z[:, :H]
        outs.append(r * torch.tanh(c) + (1 - r) * x[:, s, :H])
    return torch.stack(outs, 1), c


# -- control flow ----------------------------------------------------------------
# These ops carry traced subgraphs in their attrs (callables that
# SameDiff.while_loop / cond / scan build from child graphs) and run them
# as Python control flow over the graph's eager walk. A bounded
# while_loop runs its bound's trips with masked updates and reads
# nothing on the host; an unbounded one and cond read their predicate on
# the host once per trip or call (counted in ``HOST_READS``).
#: host reads of loop conditions and cond predicates, by op
HOST_READS: Dict[str, int] = {"while_loop": 0, "cond": 0}

_WHILE_GRAD_MESSAGE = (
    "gradient requested through a while_loop capture. XLA's while has "
    "no reverse rule; pass max_iterations=N to while_loop to lower it to "
    "a reverse-differentiable bounded scan (the TF maximum_iterations "
    "semantics), or thread the value so the loss does not depend on the "
    "loop.")


class _WhileCaptureTrap(torch.autograd.Function):
    """Identity on an unbounded loop's outputs, tied to every input of
    the loop that requires a gradient; its backward raises (the JAX
    package's ``_while_capture_trap``): the trips ran without autograd,
    and a gradient of the trips alone would train wrong."""

    @staticmethod
    def forward(ctx, n_out, *tensors):
        return tuple(t.view_as(t) for t in tensors[:n_out])

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(_WHILE_GRAD_MESSAGE)


def _on_meta(ts) -> bool:
    return any(isinstance(t, torch.Tensor) and t.device.type == "meta"
               for t in ts)


def _predicate(t: torch.Tensor) -> torch.Tensor:
    return torch.squeeze(t).to(torch.bool)


def _one(out):
    return out if len(out) > 1 else out[0]


@op("while_loop", "control")
def _while_loop(ins, attrs):
    cond, body = attrs["_cond_call"], attrs["_body_call"]
    n = attrs.get("n_loop", len(ins))
    ncc = attrs.get("n_cond_caps", 0)
    loop0 = tuple(ins[:n])
    cond_caps, body_caps = tuple(ins[n:n + ncc]), tuple(ins[n + ncc:])
    max_iter = attrs.get("max_iterations")
    if _on_meta(ins):
        # shapes only: the loop variables keep theirs from trip to trip
        new = body(*loop0, *body_caps)
        return _one(tuple(torch.where(_predicate(cond(*loop0,
                                                       *cond_caps)[0]),
                                      nv, ov)
                          for nv, ov in zip(new, loop0)))
    if max_iter is not None:
        # the bound's trips, each masking its updates once the
        # condition has gone false (TF maximum_iterations semantics):
        # no host read, and autograd sees every trip
        vars_ = loop0
        done = torch.zeros((), dtype=torch.bool, device=loop0[0].device)
        for _ in range(int(max_iter)):
            cnd = _predicate(cond(*vars_, *cond_caps)[0])
            active = ~done & cnd
            new = body(*vars_, *body_caps)
            # a variable the body passes through stays the same tensor
            vars_ = tuple(ov if nv is ov else torch.where(active, nv, ov)
                          for nv, ov in zip(new, vars_))
            done = done | ~cnd
        return _one(vars_)
    # unbounded: the condition is read on the host once per trip; the
    # trips run without autograd and the trap stands in their place
    vars_ = loop0
    with torch.no_grad():
        while True:
            HOST_READS["while_loop"] += 1
            if not bool(_predicate(cond(*vars_, *cond_caps)[0])):
                break
            vars_ = tuple(body(*vars_, *body_caps))
    live = [t for t in ins if isinstance(t, torch.Tensor)
            and t.requires_grad]
    if live and torch.is_grad_enabled():
        vars_ = _WhileCaptureTrap.apply(len(vars_), *vars_, *live)
    return _one(tuple(vars_))


@op("cond", "control")
def _cond(ins, attrs):
    n_ops = attrs.get("n_operands", len(ins) - 1)
    ntc = attrs.get("n_true_caps", 0)
    operands = tuple(ins[1:1 + n_ops])
    t_caps = tuple(ins[1 + n_ops:1 + n_ops + ntc])
    f_caps = tuple(ins[1 + n_ops + ntc:])
    if _on_meta(ins):
        take = True                   # shapes only: both branches agree
    else:
        HOST_READS["cond"] += 1
        take = bool(_predicate(ins[0]))
    out = (attrs["_true_call"](*operands, *t_caps) if take
           else attrs["_false_call"](*operands, *f_caps))
    return _one(tuple(out))


@op("scan", "control")
def _scan_op(ins, attrs):
    body = attrs["_body_call"]
    n_carry = attrs["n_carry"]
    n_xs = attrs.get("n_xs", len(ins) - n_carry)
    carry = tuple(ins[:n_carry])
    xs = tuple(ins[n_carry:n_carry + n_xs])
    caps = tuple(ins[n_carry + n_xs:])
    length = attrs.get("length")
    length = int(xs[0].shape[0] if length is None else length)
    steps = 1 if _on_meta(ins) else length
    ys = []
    for t in range(steps):
        res = body(*carry, *(x[t] for x in xs), *caps)
        carry = tuple(res[:n_carry])
        ys.append(res[n_carry:])
    if _on_meta(ins):
        stacked = [y.new_empty((length,) + tuple(y.shape)) for y in ys[0]]
    else:
        stacked = [torch.stack(col) for col in zip(*ys)] if ys else []
    return _one(carry + tuple(stacked))


# TF-graph-style primitives, select-lowered: both branches run and merge
# selects by the predicate. switch(data, pred) -> (false_out, true_out),
# both carrying the data; merge(false_val, true_val, pred) picks the live
# one.
@op("switch", "control")
def _switch(ins, attrs):
    data, _pred = ins
    return data, data


@op("merge", "control")
def _merge(ins, attrs):
    if len(ins) != 3:
        raise ValueError("merge expects (false_val, true_val, pred)")
    false_val, true_val, pred = ins
    return torch.where(_predicate(pred), true_val, false_val)


# -- compression (threshold encoding) ---------------------------------------
@op("encode_threshold", "compression")
def _encode_thr(ins, attrs):
    """``(quantized, residual)``: ``parallel/encoding.py``'s codec."""
    from deeplearning4j_tpu_torch.parallel.encoding import encode_threshold
    return encode_threshold(ins[0], attrs.get("threshold", 1e-3))


@op("decode_threshold", "compression")
def _decode_thr(ins, attrs):
    return ins[0]
