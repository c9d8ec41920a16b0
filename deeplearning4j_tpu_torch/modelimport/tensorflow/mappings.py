"""Per-op TF → SameDiff mapping rules.

Counterpart of ``deeplearning4j_tpu/modelimport/tensorflow/mappings.py``
(numpy only, copied). Reference parity: `OpMappingRegistry` + per-op
`MappingProcess` rules in `samediff-import-tensorflow` — each TF NodeDef
is mapped by a registered rule that adapts attrs/static tensors and
emits ops into the target graph. Here a rule is a plain function
``(ctx, node) -> SDVariable | sequence`` registered in ``TF_OP_MAP``.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np

TF_OP_MAP: Dict[str, Callable] = {}


def tf_op(*names):
    def deco(fn):
        for n in names:
            TF_OP_MAP[n] = fn
        return fn
    return deco


def _ints(arr) -> list:
    return [int(v) for v in np.asarray(arr).reshape(-1)]


# -- passthrough ------------------------------------------------------------
@tf_op("Identity", "StopGradient", "PreventGradient", "CheckNumerics",
       "Snapshot", "EnsureShape", "PlaceholderWithDefault")
def _identity(ctx, node):
    # a real (zero-cost) op so the TF node name stays
    # addressable as a graph variable
    return ctx.sd._op("identity", [ctx.var(node.inputs[0])])


@tf_op("IdentityN")
def _identity_n(ctx, node):
    return [ctx.sd._op("identity", [ctx.var(i)]) for i in node.inputs]


# -- elementwise binary -----------------------------------------------------
_BINARY = {
    "Add": "add", "AddV2": "add", "Sub": "sub", "Mul": "mul",
    "RealDiv": "div", "Div": "div", "FloorDiv": "floordiv",
    "FloorMod": "mod", "Mod": "mod", "Maximum": "maximum",
    "Minimum": "minimum", "Pow": "pow",
    "SquaredDifference": "squared_difference", "Atan2": "atan2",
    "Greater": "gt", "GreaterEqual": "gte", "Less": "lt",
    "LessEqual": "lte", "Equal": "eq", "NotEqual": "neq",
    "LogicalAnd": "logical_and", "LogicalOr": "logical_or",
}


def _binary(ctx, node):
    return ctx.sd._op(_BINARY[node.op],
                      [ctx.var(node.inputs[0]), ctx.var(node.inputs[1])])


for _name in _BINARY:
    TF_OP_MAP[_name] = _binary

# -- elementwise unary ------------------------------------------------------
_UNARY = {
    "Neg": "neg", "Abs": "abs", "Exp": "exp", "Log": "log",
    "Log1p": "log1p", "Expm1": "expm1", "Sqrt": "sqrt", "Rsqrt": "rsqrt",
    "Square": "square", "Sign": "sign", "Floor": "floor", "Ceil": "ceil",
    "Round": "round", "Reciprocal": "reciprocal", "Inv": "reciprocal",
    "Erf": "erf", "Erfc": "erfc", "Tanh": "tanh", "Sigmoid": "sigmoid",
    "Sin": "sin", "Cos": "cos", "Tan": "tan", "Asin": "asin",
    "Acos": "acos", "Atan": "atan", "Sinh": "sinh", "Cosh": "cosh",
    "Asinh": "asinh", "Acosh": "acosh", "Atanh": "atanh",
    "Relu": "relu", "Relu6": "relu6", "Elu": "elu", "Selu": "selu",
    "Softplus": "softplus", "Softsign": "softsign",
    "LogicalNot": "logical_not", "Softmax": "softmax",
    "LogSoftmax": "log_softmax", "IsNan": "is_nan", "IsInf": "is_inf",
    "IsFinite": "is_finite", "OnesLike": "ones_like",
    "ZerosLike": "zeros_like",
}


def _unary(ctx, node):
    return ctx.sd._op(_UNARY[node.op], [ctx.var(node.inputs[0])])


for _name in _UNARY:
    TF_OP_MAP[_name] = _unary


@tf_op("LeakyRelu")
def _leaky(ctx, node):
    return ctx.sd._op("leaky_relu", [ctx.var(node.inputs[0])],
                      {"alpha": node.attr("alpha", 0.2)})


@tf_op("AddN")
def _addn(ctx, node):
    out = ctx.var(node.inputs[0])
    for ref in node.inputs[1:]:
        out = ctx.sd._op("add", [out, ctx.var(ref)])
    return out


@tf_op("L2Loss")
def _l2loss(ctx, node):
    sq = ctx.sd._op("square", [ctx.var(node.inputs[0])])
    s = ctx.sd._op("reduce_sum", [sq], {"axis": None})
    half = ctx.sd.constant(np.float32(0.5))
    return ctx.sd._op("mul", [s, half])


@tf_op("Select", "SelectV2")
def _select(ctx, node):
    return ctx.sd._op("where", [ctx.var(i) for i in node.inputs[:3]])


@tf_op("ClipByValue")
def _clip(ctx, node):
    lo = float(np.asarray(ctx.require_static(node, 1)).reshape(())[()])
    hi = float(np.asarray(ctx.require_static(node, 2)).reshape(())[()])
    return ctx.sd._op("clip_by_value", [ctx.var(node.inputs[0])],
                      {"clip_value_min": lo, "clip_value_max": hi})


# -- matmul / einsum --------------------------------------------------------
@tf_op("MatMul")
def _matmul(ctx, node):
    return ctx.sd._op("matmul",
                      [ctx.var(node.inputs[0]), ctx.var(node.inputs[1])],
                      {"transpose_a": bool(node.attr("transpose_a")),
                       "transpose_b": bool(node.attr("transpose_b"))})


@tf_op("BatchMatMul", "BatchMatMulV2", "BatchMatMulV3")
def _batch_matmul(ctx, node):
    return ctx.sd._op("matmul",
                      [ctx.var(node.inputs[0]), ctx.var(node.inputs[1])],
                      {"transpose_a": bool(node.attr("adj_x")),
                       "transpose_b": bool(node.attr("adj_y"))})


@tf_op("Einsum")
def _einsum(ctx, node):
    eq = node.attr("equation", b"").decode()
    return ctx.sd._op("einsum", [ctx.var(i) for i in node.inputs],
                      {"equation": eq})


@tf_op("BiasAdd")
def _bias_add(ctx, node):
    x = ctx.var(node.inputs[0])
    b = ctx.var(node.inputs[1])
    fmt = node.attr("data_format", b"NHWC")
    if fmt == b"NCHW":
        nd = len(x.shape) if x.shape else 4
        b = ctx.sd._op("reshape", [b],
                       {"shape": [-1] + [1] * (nd - 2)})
    return ctx.sd._op("add", [x, b])


# -- reductions -------------------------------------------------------------
_REDUCE = {"Sum": "reduce_sum", "Mean": "reduce_mean",
           "Max": "reduce_max", "Min": "reduce_min",
           "Prod": "reduce_prod", "All": "reduce_all",
           "Any": "reduce_any"}


def _reduce(ctx, node):
    axes = _ints(ctx.require_static(node, 1))
    keep = bool(node.attr("keep_dims", False))
    return ctx.sd._op(_REDUCE[node.op], [ctx.var(node.inputs[0])],
                      {"axis": axes if len(axes) != 1 else axes[0],
                       "keep_dims": keep})


for _name in _REDUCE:
    TF_OP_MAP[_name] = _reduce


@tf_op("ArgMax")
def _argmax(ctx, node):
    axis = int(np.asarray(ctx.require_static(node, 1)).reshape(())[()])
    return ctx.sd._op("argmax", [ctx.var(node.inputs[0])], {"axis": axis})


@tf_op("ArgMin")
def _argmin(ctx, node):
    axis = int(np.asarray(ctx.require_static(node, 1)).reshape(())[()])
    return ctx.sd._op("argmin", [ctx.var(node.inputs[0])], {"axis": axis})


@tf_op("Cumsum")
def _cumsum(ctx, node):
    axis = int(np.asarray(ctx.require_static(node, 1)).reshape(())[()])
    return ctx.sd._op("cumsum", [ctx.var(node.inputs[0])],
                      {"axis": axis,
                       "exclusive": bool(node.attr("exclusive", False)),
                       "reverse": bool(node.attr("reverse", False))})


@tf_op("TopKV2")
def _topk(ctx, node):
    k = int(np.asarray(ctx.require_static(node, 1)).reshape(())[()])
    return ctx.sd._op("top_k", [ctx.var(node.inputs[0])], {"k": k},
                      n_out=2)


# -- shape ops --------------------------------------------------------------
@tf_op("Shape")
def _shape(ctx, node):
    return ctx.sd._op("shape_of", [ctx.var(node.inputs[0])])


@tf_op("Size")
def _size(ctx, node):
    return ctx.sd._op("size", [ctx.var(node.inputs[0])])


@tf_op("Rank")
def _rank(ctx, node):
    return ctx.sd._op("rank", [ctx.var(node.inputs[0])])


@tf_op("Reshape")
def _reshape(ctx, node):
    shape = _ints(ctx.require_static(node, 1))
    return ctx.sd._op("reshape", [ctx.var(node.inputs[0])],
                      {"shape": shape})


@tf_op("Transpose")
def _transpose(ctx, node):
    perm = _ints(ctx.require_static(node, 1))
    return ctx.sd._op("permute", [ctx.var(node.inputs[0])],
                      {"axes": perm})


@tf_op("ExpandDims")
def _expand_dims(ctx, node):
    axis = int(np.asarray(ctx.require_static(node, 1)).reshape(())[()])
    return ctx.sd._op("expand_dims", [ctx.var(node.inputs[0])],
                      {"axis": axis})


@tf_op("Squeeze")
def _squeeze(ctx, node):
    dims = node.attr("squeeze_dims") or None
    if dims is not None:
        dims = tuple(int(d) for d in dims) or None
    return ctx.sd._op("squeeze", [ctx.var(node.inputs[0])],
                      {"axis": dims})


@tf_op("ConcatV2")
def _concat_v2(ctx, node):
    axis = int(np.asarray(
        ctx.require_static(node, len(node.inputs) - 1)).reshape(())[()])
    ins = [ctx.var(i) for i in node.inputs[:-1]]
    return ctx.sd._op("concat", ins, {"axis": axis})


@tf_op("Concat")
def _concat(ctx, node):
    axis = int(np.asarray(ctx.require_static(node, 0)).reshape(())[()])
    ins = [ctx.var(i) for i in node.inputs[1:]]
    return ctx.sd._op("concat", ins, {"axis": axis})


@tf_op("Pack")
def _pack(ctx, node):
    return ctx.sd._op("stack", [ctx.var(i) for i in node.inputs],
                      {"axis": node.attr("axis", 0)})


@tf_op("Unpack")
def _unpack(ctx, node):
    n = node.attr("num")
    return ctx.sd._op("unstack", [ctx.var(node.inputs[0])],
                      {"axis": node.attr("axis", 0)}, n_out=int(n))


@tf_op("Split")
def _split(ctx, node):
    axis = int(np.asarray(ctx.require_static(node, 0)).reshape(())[()])
    n = int(node.attr("num_split"))
    return ctx.sd._op("split", [ctx.var(node.inputs[1])],
                      {"num_splits": n, "axis": axis}, n_out=n)


@tf_op("SplitV")
def _split_v(ctx, node):
    sizes = _ints(ctx.require_static(node, 1))
    axis = int(np.asarray(ctx.require_static(node, 2)).reshape(())[()])
    return ctx.sd._op("split_v", [ctx.var(node.inputs[0])],
                      {"size_splits": sizes, "axis": axis},
                      n_out=len(sizes))


@tf_op("Tile")
def _tile(ctx, node):
    reps = _ints(ctx.require_static(node, 1))
    return ctx.sd._op("tile", [ctx.var(node.inputs[0])], {"reps": reps})


@tf_op("Pad", "PadV2", "MirrorPad")
def _pad(ctx, node):
    pads = np.asarray(ctx.require_static(node, 1)).astype(int).tolist()
    attrs = {"paddings": pads}
    if node.op == "PadV2" and len(node.inputs) > 2:
        attrs["constant"] = float(np.asarray(
            ctx.require_static(node, 2)).reshape(())[()])
    if node.op == "MirrorPad":
        mode = node.attr("mode", b"REFLECT")
        attrs["mode"] = ("reflect" if mode == b"REFLECT"
                         else "symmetric")
    return ctx.sd._op("pad", [ctx.var(node.inputs[0])], attrs)


@tf_op("StridedSlice")
def _strided_slice(ctx, node):
    begin = _ints(ctx.require_static(node, 1))
    end = _ints(ctx.require_static(node, 2))
    strides = _ints(ctx.require_static(node, 3))
    spec = strided_slice_spec(
        begin, end, strides, node.attr("begin_mask", 0),
        node.attr("end_mask", 0), node.attr("ellipsis_mask", 0),
        node.attr("new_axis_mask", 0), node.attr("shrink_axis_mask", 0))
    return ctx.sd._op("index", [ctx.var(node.inputs[0])], {"spec": spec})


@tf_op("Slice")
def _slice(ctx, node):
    begin = _ints(ctx.require_static(node, 1))
    size = _ints(ctx.require_static(node, 2))
    return ctx.sd._op("slice", [ctx.var(node.inputs[0])],
                      {"begin": begin, "size": size})


@tf_op("GatherV2")
def _gather_v2(ctx, node):
    axis = int(np.asarray(ctx.require_static(node, 2)).reshape(())[()])
    bd = int(node.attr("batch_dims", 0))
    return ctx.sd._op("gather",
                      [ctx.var(node.inputs[0]), ctx.var(node.inputs[1])],
                      {"axis": axis, "batch_dims": bd})


@tf_op("Gather")
def _gather(ctx, node):
    return ctx.sd._op("gather",
                      [ctx.var(node.inputs[0]), ctx.var(node.inputs[1])],
                      {"axis": 0})


@tf_op("GatherNd")
def _gather_nd(ctx, node):
    return ctx.sd._op("gather_nd",
                      [ctx.var(node.inputs[0]), ctx.var(node.inputs[1])])


@tf_op("OneHot")
def _one_hot(ctx, node):
    depth = int(np.asarray(ctx.require_static(node, 1)).reshape(())[()])
    on = float(np.asarray(ctx.require_static(node, 2)).reshape(())[()])
    off = float(np.asarray(ctx.require_static(node, 3)).reshape(())[()])
    axis = int(node.attr("axis", -1))
    oh = ctx.sd._op("one_hot", [ctx.var(node.inputs[0])],
                    {"depth": depth, "axis": axis})
    if on != 1.0 or off != 0.0:
        scale = ctx.sd.constant(np.float32(on - off))
        shift = ctx.sd.constant(np.float32(off))
        oh = ctx.sd._op("add", [ctx.sd._op("mul", [oh, scale]), shift])
    return oh


@tf_op("BroadcastTo")
def _broadcast_to(ctx, node):
    shape = _ints(ctx.require_static(node, 1))
    return ctx.sd._op("broadcast_to", [ctx.var(node.inputs[0])],
                      {"shape": shape})


@tf_op("Fill")
def _fill(ctx, node):
    dims = _ints(ctx.require_static(node, 0))
    val = ctx.static(node.inputs[1])
    if val is not None:
        v = np.asarray(val).reshape(())[()]
        return ctx.sd.constant(np.full(dims, v))
    return ctx.sd._op("broadcast_to", [ctx.var(node.inputs[1])],
                      {"shape": dims})


@tf_op("Cast")
def _cast(ctx, node):
    from deeplearning4j_tpu_torch.modelimport.tensorflow.protobuf import \
        tf_dtype_to_np
    dst = tf_dtype_to_np(int(node.attr("DstT", 1)))
    return ctx.sd._op("cast", [ctx.var(node.inputs[0])],
                      {"dtype": np.dtype(dst).name})


@tf_op("Range")
def _range(ctx, node):
    start = np.asarray(ctx.require_static(node, 0)).reshape(())[()]
    limit = np.asarray(ctx.require_static(node, 1)).reshape(())[()]
    delta = np.asarray(ctx.require_static(node, 2)).reshape(())[()]
    return ctx.sd.constant(np.arange(start, limit, delta))


# -- conv / pool / norm -----------------------------------------------------
def _to_nhwc(ctx, x, fmt):
    if fmt == b"NCHW":
        return ctx.sd._op("permute", [x], {"axes": [0, 2, 3, 1]})
    return x


def _from_nhwc(ctx, x, fmt):
    if fmt == b"NCHW":
        return ctx.sd._op("permute", [x], {"axes": [0, 3, 1, 2]})
    return x


def _conv_attrs(node, fmt):
    strides = [int(s) for s in node.attr("strides", [1, 1, 1, 1])]
    dil = [int(d) for d in node.attr("dilations", [1, 1, 1, 1])]
    if fmt == b"NCHW":
        sh, sw = strides[2], strides[3]
        dh, dw = dil[2], dil[3]
    else:
        sh, sw = strides[1], strides[2]
        dh, dw = dil[1], dil[2]
    padding = node.attr("padding", b"SAME").decode()
    if padding == "EXPLICIT":
        ep = [int(p) for p in node.attr("explicit_paddings", [])]
        if fmt == b"NCHW":
            padding = [(ep[4], ep[5]), (ep[6], ep[7])]
        else:
            padding = [(ep[2], ep[3]), (ep[4], ep[5])]
    return {"stride": (sh, sw), "padding": padding,
            "dilation": (dh, dw)}


@tf_op("Conv2D")
def _conv2d(ctx, node):
    fmt = node.attr("data_format", b"NHWC")
    x = _to_nhwc(ctx, ctx.var(node.inputs[0]), fmt)
    w = ctx.var(node.inputs[1])
    out = ctx.sd._op("conv2d", [x, w], _conv_attrs(node, fmt))
    return _from_nhwc(ctx, out, fmt)


@tf_op("DepthwiseConv2dNative")
def _depthwise(ctx, node):
    fmt = node.attr("data_format", b"NHWC")
    x = _to_nhwc(ctx, ctx.var(node.inputs[0]), fmt)
    w = ctx.var(node.inputs[1])
    out = ctx.sd._op("depthwise_conv2d", [x, w], _conv_attrs(node, fmt))
    return _from_nhwc(ctx, out, fmt)


@tf_op("Conv2DBackpropInput")
def _conv2d_transpose(ctx, node):
    fmt = node.attr("data_format", b"NHWC")
    x = _to_nhwc(ctx, ctx.var(node.inputs[2]), fmt)
    w = ctx.var(node.inputs[1])
    attrs = _conv_attrs(node, fmt)
    attrs["transpose_kernel"] = True
    out = ctx.sd._op("deconv2d", [x, w], attrs)
    return _from_nhwc(ctx, out, fmt)


@tf_op("MaxPool", "AvgPool")
def _pool(ctx, node):
    fmt = node.attr("data_format", b"NHWC")
    ks = [int(k) for k in node.attr("ksize", [1, 2, 2, 1])]
    st = [int(s) for s in node.attr("strides", [1, 2, 2, 1])]
    if fmt == b"NCHW":
        kernel, stride = (ks[2], ks[3]), (st[2], st[3])
    else:
        kernel, stride = (ks[1], ks[2]), (st[1], st[2])
    x = _to_nhwc(ctx, ctx.var(node.inputs[0]), fmt)
    opn = "max_pool2d" if node.op == "MaxPool" else "avg_pool2d"
    out = ctx.sd._op(opn, [x],
                     {"kernel": kernel, "stride": stride,
                      "padding": node.attr("padding", b"VALID").decode()})
    return _from_nhwc(ctx, out, fmt)


@tf_op("FusedBatchNorm", "FusedBatchNormV2", "FusedBatchNormV3")
def _fused_bn(ctx, node):
    if node.attr("is_training", True):
        raise NotImplementedError(
            "FusedBatchNorm with is_training=True (freeze the graph "
            "for inference import)")
    fmt = node.attr("data_format", b"NHWC")
    x = _to_nhwc(ctx, ctx.var(node.inputs[0]), fmt)
    gamma = ctx.var(node.inputs[1])
    beta = ctx.var(node.inputs[2])
    mean = ctx.var(node.inputs[3])
    var = ctx.var(node.inputs[4])
    y = ctx.sd._op("batch_norm", [x, mean, var, gamma, beta],
                   {"epsilon": node.attr("epsilon", 1e-3)})
    y = _from_nhwc(ctx, y, fmt)
    # outputs 1..5 (batch stats / reserves) pass through the moving stats
    return [y, mean, var, mean, var, mean]


# -- image ------------------------------------------------------------------
@tf_op("ResizeBilinear")
def _resize_bilinear(ctx, node):
    size = _ints(ctx.require_static(node, 1))
    return ctx.sd._op("resize_bilinear", [ctx.var(node.inputs[0])],
                      {"size": size})


@tf_op("ResizeNearestNeighbor")
def _resize_nearest(ctx, node):
    size = _ints(ctx.require_static(node, 1))
    return ctx.sd._op("resize_nearest", [ctx.var(node.inputs[0])],
                      {"size": size})


@tf_op("ResizeBicubic")
def _resize_bicubic(ctx, node):
    if node.attr("align_corners", False) or \
            not node.attr("half_pixel_centers", False):
        raise NotImplementedError(
            "ResizeBicubic without half_pixel_centers unsupported "
            "(TF2's tf.image.resize emits half-pixel centers; legacy "
            "TF1 corner conventions are not lowered)")
    size = _ints(ctx.require_static(node, 1))
    return ctx.sd._op("resize_bicubic", [ctx.var(node.inputs[0])],
                      {"size": size})


@tf_op("ResizeArea")
def _resize_area(ctx, node):
    if node.attr("align_corners", False):
        raise NotImplementedError("ResizeArea align_corners=True "
                                  "unsupported")
    size = _ints(ctx.require_static(node, 1))
    return ctx.sd._op("resize_area", [ctx.var(node.inputs[0])],
                      {"size": size})


# -- random (rare in frozen inference graphs) -------------------------------
@tf_op("RandomStandardNormal")
def _random_normal(ctx, node):
    shape = _ints(ctx.require_static(node, 0))
    return ctx.sd._op("random_normal", [], {"shape": shape})


@tf_op("RandomUniform")
def _random_uniform(ctx, node):
    shape = _ints(ctx.require_static(node, 0))
    return ctx.sd._op("random_uniform", [], {"shape": shape})


def strided_slice_spec(begin, end, strides, begin_mask, end_mask,
                       ellipsis_mask, new_axis_mask, shrink_axis_mask):
    """TF StridedSlice masks → generic ``index`` op spec."""
    spec = []
    for i in range(len(begin)):
        if ellipsis_mask & (1 << i):
            spec.append({"kind": "ellipsis"})
        elif new_axis_mask & (1 << i):
            spec.append({"kind": "newaxis"})
        elif shrink_axis_mask & (1 << i):
            spec.append({"kind": "int", "i": int(begin[i])})
        else:
            item = {"kind": "slice", "stride": int(strides[i])}
            if not begin_mask & (1 << i):
                item["begin"] = int(begin[i])
            if not end_mask & (1 << i):
                item["end"] = int(end[i])
            spec.append(item)
    return spec


# -- breadth batch 2: 3D conv/pool, block rearrange, segment/scatter, --------
# -- linalg, xent losses ----------------------------------------------------
def _block_rearrange(ctx, node, op_name):
    """SpaceToDepth/DepthToSpace in either layout: the registry op is
    NHWC-native; NCHW wraps it in two transposes."""
    x = ctx.var(node.inputs[0])
    attrs = {"block_size": int(node.attr("block_size", 2))}
    fmt = node.attr("data_format", b"NHWC")
    if fmt not in (b"NHWC", b"NCHW"):
        raise NotImplementedError(f"{node.op}: data_format={fmt}")
    nchw = fmt == b"NCHW"
    if nchw:
        x = ctx.sd._op("transpose", [x], {"axes": (0, 2, 3, 1)})
    y = ctx.sd._op(op_name, [x], attrs)
    if nchw:
        y = ctx.sd._op("transpose", [y], {"axes": (0, 3, 1, 2)})
    return y


@tf_op("SpaceToDepth")
def _space_to_depth(ctx, node):
    return _block_rearrange(ctx, node, "space_to_depth")


@tf_op("DepthToSpace")
def _depth_to_space(ctx, node):
    return _block_rearrange(ctx, node, "depth_to_space")


def _ncdhw_layout(node):
    """NDHWC is the registry-native 3D layout; NCDHW wraps in two
    transposes (same treatment as _block_rearrange).  Per-element
    attrs (strides/ksize/dilations) arrive in the GRAPH layout, so
    the caller permutes them with the returned index map."""
    fmt = node.attr("data_format", b"NDHWC")
    if fmt not in (b"NDHWC", b"NCDHW"):
        raise NotImplementedError(f"{node.op}: data_format={fmt}")
    return fmt == b"NCDHW"


_NCDHW_TO_NDHWC = (0, 2, 3, 4, 1)
_NDHWC_TO_NCDHW = (0, 4, 1, 2, 3)


@tf_op("Conv3D")
def _conv3d(ctx, node):
    ncdhw = _ncdhw_layout(node)
    strides = [int(s) for s in node.attr("strides", [1] * 5)]
    dil = [int(d) for d in node.attr("dilations", [1] * 5)]
    x = ctx.var(node.inputs[0])
    if ncdhw:
        x = ctx.sd._op("transpose", [x], {"axes": _NCDHW_TO_NDHWC})
        strides = [strides[i] for i in _NCDHW_TO_NDHWC]
        dil = [dil[i] for i in _NCDHW_TO_NDHWC]
    y = ctx.sd._op(
        "conv3d", [x, ctx.var(node.inputs[1])],
        {"stride": tuple(strides[1:4]), "dilation": tuple(dil[1:4]),
         "padding": node.attr("padding", b"SAME").decode()})
    if ncdhw:
        y = ctx.sd._op("transpose", [y], {"axes": _NDHWC_TO_NCDHW})
    return y


@tf_op("MaxPool3D", "AvgPool3D")
def _pool3d(ctx, node):
    ncdhw = _ncdhw_layout(node)
    ks = [int(k) for k in node.attr("ksize", [1, 2, 2, 2, 1])]
    st = [int(s) for s in node.attr("strides", [1, 2, 2, 2, 1])]
    x = ctx.var(node.inputs[0])
    if ncdhw:
        x = ctx.sd._op("transpose", [x], {"axes": _NCDHW_TO_NDHWC})
        ks = [ks[i] for i in _NCDHW_TO_NDHWC]
        st = [st[i] for i in _NCDHW_TO_NDHWC]
    opn = "max_pool3d" if node.op == "MaxPool3D" else "avg_pool3d"
    y = ctx.sd._op(opn, [x],
                   {"kernel": tuple(ks[1:4]),
                    "stride": tuple(st[1:4]),
                    "padding": node.attr("padding",
                                         b"VALID").decode()})
    if ncdhw:
        y = ctx.sd._op("transpose", [y], {"axes": _NDHWC_TO_NCDHW})
    return y


@tf_op("ReverseV2")
def _reverse_v2(ctx, node):
    axes = np.asarray(ctx.require_static(node, 1))
    return ctx.sd._op("reverse", [ctx.var(node.inputs[0])],
                      {"axes": [int(a) for a in axes.reshape(-1)]})


@tf_op("Cumprod")
def _cumprod(ctx, node):
    axis = int(np.asarray(ctx.require_static(node, 1)))
    return ctx.sd._op("cumprod", [ctx.var(node.inputs[0])],
                      {"axis": axis,
                       "exclusive": bool(node.attr("exclusive", False)),
                       "reverse": bool(node.attr("reverse", False))})


@tf_op("Roll")
def _roll_tf(ctx, node):
    shift = np.asarray(ctx.require_static(node, 1))
    axes = np.asarray(ctx.require_static(node, 2))
    return ctx.sd._op("roll", [ctx.var(node.inputs[0])],
                      {"shift": [int(s) for s in shift.reshape(-1)],
                       "axes": [int(a) for a in axes.reshape(-1)]})


@tf_op("ScatterNd")
def _scatter_nd_tf(ctx, node):
    shape = np.asarray(ctx.require_static(node, 2))
    return ctx.sd._op("scatter_nd",
                      [ctx.var(node.inputs[0]),
                       ctx.var(node.inputs[1])],
                      {"shape": [int(s) for s in shape.reshape(-1)]})


@tf_op("InvertPermutation")
def _invert_perm(ctx, node):
    return ctx.sd._op("invert_permutation", [ctx.var(node.inputs[0])])


@tf_op("SegmentSum", "SegmentMax", "SegmentMin", "SegmentMean",
       "SegmentProd")
def _segment(ctx, node):
    opn = {"SegmentSum": "segment_sum", "SegmentMax": "segment_max",
           "SegmentMin": "segment_min", "SegmentMean": "segment_mean",
           "SegmentProd": "segment_prod"}[node.op]
    # num_segments must be static; fold it from the ids
    ids = np.asarray(ctx.require_static(node, 1))
    return ctx.sd._op(opn, [ctx.var(node.inputs[0]),
                            ctx.var(node.inputs[1])],
                      {"num_segments": int(ids.max()) + 1})


@tf_op("UnsortedSegmentSum", "UnsortedSegmentMax", "UnsortedSegmentMin",
       "UnsortedSegmentProd")
def _unsorted_segment(ctx, node):
    opn = {"UnsortedSegmentSum": "unsorted_segment_sum",
           "UnsortedSegmentMax": "unsorted_segment_max",
           "UnsortedSegmentMin": "unsorted_segment_min",
           "UnsortedSegmentProd": "unsorted_segment_prod"}[node.op]
    n = int(np.asarray(ctx.require_static(node, 2)))
    return ctx.sd._op(opn, [ctx.var(node.inputs[0]),
                            ctx.var(node.inputs[1])],
                      {"num_segments": n})


@tf_op("LRN")
def _lrn(ctx, node):
    # TF windows [i-r, i+r] (2r+1 wide); our lrn takes the full width
    r = int(node.attr("depth_radius", 5))
    return ctx.sd._op("lrn", [ctx.var(node.inputs[0])],
                      {"depth": 2 * r + 1,
                       "bias": float(node.attr("bias", 1.0)),
                       "alpha": float(node.attr("alpha", 1.0)),
                       "beta": float(node.attr("beta", 0.5))})


def _check_diag_k(ctx, node):
    """V2/V3 carry a k (diagonal offset) input; only k=0 is supported."""
    if len(node.inputs) > 1:
        k = np.asarray(ctx.require_static(node, 1))
        if np.any(k != 0):
            raise NotImplementedError(
                f"{node.op}: only the main diagonal (k=0) is supported")


@tf_op("MatrixDiag", "MatrixDiagV2", "MatrixDiagV3")
def _matrix_diag_tf(ctx, node):
    _check_diag_k(ctx, node)
    return ctx.sd._op("matrix_diag", [ctx.var(node.inputs[0])])


@tf_op("MatrixDiagPart", "MatrixDiagPartV2", "MatrixDiagPartV3")
def _matrix_diag_part_tf(ctx, node):
    _check_diag_k(ctx, node)
    return ctx.sd._op("matrix_diag_part", [ctx.var(node.inputs[0])])


@tf_op("Cholesky")
def _cholesky_tf(ctx, node):
    return ctx.sd._op("cholesky", [ctx.var(node.inputs[0])])


@tf_op("MatrixInverse")
def _matrix_inverse_tf(ctx, node):
    return ctx.sd._op("matrix_inverse", [ctx.var(node.inputs[0])])


@tf_op("SoftmaxCrossEntropyWithLogits")
def _softmax_xent(ctx, node):
    logits = ctx.var(node.inputs[0])
    labels = ctx.var(node.inputs[1])
    loss = ctx.sd._op("softmax_cross_entropy", [labels, logits],
                      {"reduction": "none"})
    # TF also returns backprop dL/dlogits = softmax - labels
    sm = ctx.sd._op("softmax", [logits])
    grad = ctx.sd._op("sub", [sm, labels])
    return [loss, grad]


@tf_op("SparseSoftmaxCrossEntropyWithLogits")
def _sparse_softmax_xent(ctx, node):
    logits = ctx.var(node.inputs[0])
    labels = ctx.var(node.inputs[1])
    loss = ctx.sd._op("sparse_softmax_cross_entropy",
                      [labels, logits], {"reduction": "none"})
    if not (logits.shape and logits.shape[-1] and
            int(logits.shape[-1]) > 0):
        raise NotImplementedError(
            "SparseSoftmaxCrossEntropyWithLogits: class count must be "
            "statically known for the backprop output")
    onehot = ctx.sd._op("one_hot", [labels],
                        {"depth": int(logits.shape[-1])})
    sm = ctx.sd._op("softmax", [logits])
    grad = ctx.sd._op("sub", [sm, onehot])
    return [loss, grad]


# -- TensorList / TensorArray (TF2 dynamic-loop accumulators; the v2
# lowering of tf.TensorArray) -----------------------------------------------
@tf_op("TensorListReserve")
def _tensor_list_reserve(ctx, node):
    shape = node.attr("_tl_shape")     # stashed by _resolve_tensor_lists
    num = node.attr("_tl_num")
    if shape is None or num is None:
        raise NotImplementedError(
            f"TensorListReserve '{node.name}': element shape or size "
            f"not recoverable by the resolver (it reads direct Const "
            f"producers, following the handle through While "
            f"boundaries). Either the list is dynamic-size "
            f"(PushBack-style — no static-shape lowering exists) or "
            f"the size/shape comes through a derived chain this "
            f"resolver does not fold yet")
    from deeplearning4j_tpu_torch.modelimport.tensorflow.protobuf import \
        tf_dtype_to_np
    dt = tf_dtype_to_np(int(node.attr("element_dtype", 1)))
    return ctx.sd.constant(f"{node.name}_storage",
                           np.zeros((int(num),) + tuple(shape), dt))


@tf_op("TensorListSetItem")
def _tensor_list_set_item(ctx, node):
    if node.attr("resize_if_index_out_of_bounds", False):
        # dynamic growth: the dense static-size representation would
        # silently DROP out-of-bounds writes
        raise NotImplementedError(
            "TensorListSetItem with resize_if_index_out_of_bounds "
            "(dynamic-size TensorList) has no static-shape lowering")
    return ctx.sd._op("tensor_list_set_item",
                      [ctx.var(node.inputs[0]), ctx.var(node.inputs[1]),
                       ctx.var(node.inputs[2])])


@tf_op("TensorListGetItem")
def _tensor_list_get_item(ctx, node):
    return ctx.sd._op("tensor_list_get_item",
                      [ctx.var(node.inputs[0]),
                       ctx.var(node.inputs[1])])


@tf_op("TensorListStack", "TensorListFromTensor")
def _tensor_list_identity(ctx, node):
    # dense representation: the storage IS the stacked tensor
    return ctx.var(node.inputs[0])


@tf_op("TensorListLength")
def _tensor_list_length(ctx, node):
    return ctx.sd._op("tensor_list_length", [ctx.var(node.inputs[0])])


@tf_op("TensorListGather")
def _tensor_list_gather(ctx, node):
    return ctx.sd._op("gather",
                      [ctx.var(node.inputs[0]),
                       ctx.var(node.inputs[1])], {"axis": 0})
