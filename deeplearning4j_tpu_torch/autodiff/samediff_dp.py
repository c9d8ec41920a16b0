"""Data-parallel ``SameDiff.output`` and ``SameDiff.fit_steps``.

Counterpart of the mesh branches of ``deeplearning4j_tpu/autodiff/
samediff.py`` (``_shard_placeholders``, ``output(mesh=)``,
``fit_steps(mesh=)``). The JAX package compiles one program over the
global batch and lets GSPMD place the collectives. PyTorch runs eagerly,
so here every replica of a ``parallel/mesh.DpMesh`` (a ``ThreadMesh`` of
replicas in this process, or the one replica of a ``ProcessGroupMesh``
in each process) walks the graph on its rows of the batch, and the walk
itself keeps the global program's meaning:

- **Which values are shards.** The batch placeholders are (the
  ``TrainingConfig`` mappings, else the leading-dimension vote, with
  the JAX package's warning; ``ph_specs`` overrides either); variables,
  constants and other placeholders are replicated. A shard is a
  replica's contiguous block of rows of the global value. One pass of
  the walk on meta tensors, at the global and at the local shapes,
  classifies every op that takes a shard by the op and its axis
  attributes (:func:`row_wise`, :func:`batch_combine`), never by shapes
  alone:
  - an op the allow-list names row-wise (elementwise math, an axis op
    whose axis is not 0, a product whose rows are the batch, attention)
    runs on the replica's rows, and its outputs are shards;
  - a reduction over the batch axis is all-reduced: a sum (``reduce_sum``,
    a product contracting the batch axis, a loss op with
    ``reduction="sum"``), a mean (``reduce_mean``, a loss op reducing by
    its default mean; shards are equal) through a differentiable
    all-reduce, a max or a min exactly (``reduce_max`` / ``reduce_min``;
    ties share the cotangent as in the JAX package);
  - every other op (a softmax, scan, normalisation, reversal or concat
    along axis 0, an ``argmax`` over the batch, an op the table does not
    know) gathers the global rows of its shard inputs first, runs on
    them, and keeps its replica's rows of each output that keeps the
    batch axis. The gather is differentiable (its cotangent is the sum
    of the replicas' cotangents of the replica's rows).
  So the value every replica goes on with is its rows of the global one,
  or the global one.
- **Attributes that fix the global batch.** An imported graph's
  ``reshape`` carries the global batch in its target shape; a replica
  reshapes to its share of the leading dimension. A random op whose
  output is a shard draws the global rows from its key and keeps its
  own, so the masks are the one-device walk's.

So the loss each replica computes is the global loss: the imported MLM
loss ``Σ(xent·valid) / max(Σ valid, 1)`` divides the global sums, not a
shard's. Replica ``r``'s gradient is then ``N`` times its rows' share of
the global gradient (the all-reduce's backward sums the replicas'
cotangents) plus the replicated terms, and the update exchange of
``parallel/zero.py`` (``dense``: an all-reduce; ``sharded``: ZeRO-1;
``encoded``: ZeRO-1 with the gradient compressed; ``fsdp``: ZeRO-3, the
variables resident as 1/N flat slices, gathered for the walk) applies
the replicas' mean, which is the global gradient.

The variables are one parameter group (one flat ravel a dtype). Between
calls the graph holds dense variables and a dense updater state; a call
converts them to its exchange's layout and back, so calls with different
exchanges or replica counts chain. Remat segments apply under a mesh as
on one device: the segmented walk takes the same hooks, the segment plan
is sized from the replica's values, and a recomputed segment redraws the
same rows and runs the same collectives. Tensor-parallel specs
(``tp_specs``) are ROADMAP item 12.
"""
from __future__ import annotations

import copy
import logging
from typing import Dict, Optional

import torch

from deeplearning4j_tpu_torch.autodiff.registry import get_op
from deeplearning4j_tpu_torch.common.rng import RngKey
from deeplearning4j_tpu_torch.learning.updaters import dp_ravel, dp_unravel
from deeplearning4j_tpu_torch.parallel import zero
from deeplearning4j_tpu_torch.parallel.encoding import resolve_encoding
from deeplearning4j_tpu_torch.parallel.mesh import (DEFAULT_DATA_AXIS,
                                                    ThreadMesh,
                                                    all_reduce_sum,
                                                    canonical_device)

log = logging.getLogger("deeplearning4j_tpu_torch")

#: ops whose output, when it has lost the batch axis of a sharded input,
#: is a sum over the batch rows
SUM_OPS = {"reduce_sum", "sum", "matmul", "mmul", "batch_matmul", "dot",
           "tensordot_last"}
#: ... a mean over the batch rows
MEAN_OPS = {"reduce_mean", "mean"}
#: ... the largest / smallest batch row, all-reduced exactly (ties
#: share the cotangent evenly across every replica, as ``jnp.max`` does)
MAX_OPS = {"reduce_max", "amax"}
MIN_OPS = {"reduce_min", "amin"}
#: random ops whose output may be a shard (the draw follows its input)
RNG_DRAWS = {"dropout"}

#: ops acting element by element (with broadcasting), each by name:
#: row-wise whenever every shard input has the output's rank. An op of
#: the same domains that reads the whole tensor (``clip_by_norm``: the
#: norm of every element) is not here, and gathers
_ELEMENTWISE = {
    # arithmetic
    "abs", "add", "div", "floordiv", "fmod", "maximum", "minimum", "mod",
    "mul", "neg", "pow", "rdiv", "reciprocal", "rsub", "sign",
    "squared_difference", "sub",
    # transform
    "acos", "acosh", "asin", "asinh", "atan", "atan2", "atanh", "ceil",
    "clip_by_value", "cos", "cosh", "cube", "erf", "erfc", "exp", "expm1",
    "floor", "log", "log1p", "round", "rsqrt", "sin", "sinh", "sqrt",
    "square", "tan", "tanh",
    # boolean
    "eq", "gt", "gte", "is_finite", "is_inf", "is_nan", "logical_and",
    "logical_not", "logical_or", "logical_xor", "lt", "lte", "neq",
    # bitwise
    "bitwise_and", "bitwise_not", "bitwise_or", "bitwise_xor",
    "cyclic_shift_left", "cyclic_shift_right", "left_shift", "right_shift",
    # activations (softmax and log_softmax read an axis)
    "elu", "gelu", "gelu_tanh", "hard_sigmoid", "hard_tanh", "leaky_relu",
    "mish", "prelu", "relu", "relu6", "selu", "sigmoid", "softplus",
    "softsign", "swish"}
#: losses whose per-example loss (``reduction="none"``) stays in its row:
#: element by element, or along the last axis
_ROW_LOSSES = {
    "absolute_difference", "hinge_loss", "huber_loss", "log_loss",
    "mean_squared_error", "sigmoid_cross_entropy", "softmax_cross_entropy",
    "sparse_softmax_cross_entropy"}
#: ops that keep every input row's result in that row whatever their
#: attributes: per-example layers and shape ops that leave axis 0 alone
_PER_ROW = {
    "identity", "cast", "zeros_like", "ones_like", "where", "select",
    "apply_key_mask", "sdpa_core", "dot_product_attention",
    "multi_head_dot_product_attention", "batch_norm", "lrn", "in_top_k",
    "depth_to_space", "space_to_depth", "conv1d", "conv2d", "conv3d",
    "depthwise_conv2d", "separable_conv2d", "deconv2d", "avg_pool1d",
    "avg_pool2d", "avg_pool3d", "max_pool1d", "max_pool2d", "max_pool3d",
    "upsampling2d", "im2col", "resize_area", "resize_bicubic",
    "resize_bilinear", "resize_nearest", "extract_image_patches",
    "lstm_cell", "gru_cell", "sru_cell", "dropout"}
#: ops whose ``axis`` attr (default below) names the one axis they act
#: along: row-wise unless it resolves to 0
_AXIS_OPS = {
    "softmax": -1, "log_softmax": -1, "cumsum": -1, "cumprod": -1,
    "argmax": -1, "argmin": -1, "top_k": -1, "concat": 0, "stack": 0,
    "unstack": 0, "split": 0, "split_v": 0, "one_hot": -1}
#: reductions and normalizations over an ``axis`` attr (None: every axis)
_REDUCE_AXIS_OPS = {
    "reduce_sum": None, "sum": None, "reduce_mean": None, "mean": None,
    "reduce_max": None, "amax": None, "reduce_min": None, "amin": None,
    "reduce_prod": None, "reduce_std": None, "reduce_var": None,
    "reduce_norm1": None, "reduce_norm2": None, "reduce_logsumexp": None,
    "reduce_any": None, "reduce_all": None, "moments": None,
    "standardize": -1, "layer_norm": -1}
#: batched matrix ops: row-wise on inputs of rank >= 3 (the batch axes
#: lead), a mix of rows on a single matrix
_MATRIX_OPS = {
    "cholesky", "matrix_determinant", "matrix_inverse", "qr", "svd", "lu",
    "solve", "triangular_solve", "diag_part", "matrix_diag_part", "trace"}


def _axes_of(attr, ndim: int, default):
    """An axis attr resolved to non-negative axes (None: every axis)."""
    a = default if attr is None else attr
    if a is None:
        return set(range(ndim))
    a = a if isinstance(a, (list, tuple)) else (a,)
    return {int(x) % max(ndim, 1) for x in a}


def _full_first(begin, end, step, rows: int) -> bool:
    """A slice of axis 0 that keeps every row in order."""
    return (begin in (None, 0) and step in (None, 1)
            and (end is None or int(end) >= rows))


def _index_keeps_rows(spec, rows: int) -> bool:
    first = spec[0] if spec else {"kind": "ellipsis"}
    return first["kind"] == "slice" and _full_first(
        first.get("begin"), first.get("end"), first.get("stride"), rows)


def row_wise(node, attrs: dict, shard_pos, glob_ins) -> bool:
    """Whether ``node`` computes each row of its output from that row of
    its batch-shard inputs alone (axis 0 stays the batch and no op mixes
    rows), judged by the op and its axis attributes, never by shapes.
    An op this table does not name is not row-wise: the walk gathers
    its shard inputs."""
    op = node.op_name
    x = glob_ins[shard_pos[0]]
    nd = x.dim()
    if op in _PER_ROW:
        return True
    if op in _ELEMENTWISE:
        out_rank = max(t.dim() for t in glob_ins)
        return all(glob_ins[i].dim() == out_rank for i in shard_pos)
    if op in _AXIS_OPS:
        if op in ("concat", "stack"):
            nd = nd + (op == "stack")
        return 0 not in _axes_of(attrs.get("axis"), nd, _AXIS_OPS[op])
    if op in _REDUCE_AXIS_OPS:
        return 0 not in _axes_of(attrs.get("axis"), nd,
                                 _REDUCE_AXIS_OPS[op])
    if op in ("matmul", "mmul", "batch_matmul"):
        # the batch stays the leading axis: a 2-D shard is the rows of a
        # (transposed, or as b, its rows are contracted); a shard of
        # rank >= 3 is a batch of matrices
        if 0 in shard_pos and attrs.get("transpose_a") and nd == 2:
            return False
        return not (1 in shard_pos and glob_ins[1].dim() == 2)
    if op == "reshape":
        return True
    if op in ("permute", "transpose"):
        axes = attrs.get("axes")
        return axes is not None and int(axes[0]) % nd == 0
    if op == "expand_dims":
        return 0 not in _axes_of(attrs.get("axis"), nd + 1, None)
    if op == "squeeze":
        return attrs.get("axis") is not None and \
            0 not in _axes_of(attrs.get("axis"), nd, None)
    if op in ("flip", "reverse", "roll"):
        ax = attrs.get("axis" if op == "flip" else "axes")
        return ax is not None and 0 not in _axes_of(ax, nd, None)
    if op == "repeat":
        return attrs.get("axis") is not None and \
            0 not in _axes_of(attrs.get("axis"), nd, None)
    if op == "tile":
        return int(attrs["reps"][0]) == 1
    if op == "pad":
        return tuple(int(v) for v in attrs["paddings"][0]) == (0, 0)
    if op == "gather":
        p_shard = 0 in shard_pos
        if int(attrs.get("batch_dims", 0)) >= 1:
            return True
        return not p_shard and int(attrs.get("axis", 0)) % \
            glob_ins[0].dim() == 0
    if op == "gather_nd":
        return 0 not in shard_pos
    if op == "slice":
        return int(attrs["begin"][0]) == 0 and (
            int(attrs["size"][0]) < 0 or int(attrs["size"][0]) >= x.shape[0])
    if op == "strided_slice":
        return _full_first(attrs["begin"][0], attrs["end"][0],
                           attrs["strides"][0], x.shape[0])
    if op == "index":
        return _index_keeps_rows(attrs["spec"], x.shape[0])
    if op in _MATRIX_OPS:
        return all(glob_ins[i].dim() >= 3 for i in shard_pos)
    if _row_loss(op, attrs, nd):
        return attrs.get("reduction", "mean") == "none"
    return False


def _row_loss(op: str, attrs: dict, nd: int) -> bool:
    """A loss whose per-example loss stays in its row
    (``cosine_distance`` unless its axis is the batch)."""
    return op in _ROW_LOSSES or (op == "cosine_distance" and 0 not in
                                 _axes_of(attrs.get("axis"), nd, -1))


def batch_combine(node, attrs: dict, glob_ins) -> Optional[str]:
    """How the replicas' results of an op that reduces over the batch
    axis combine into the global one: ``"sum"``, ``"mean"``, ``"max"``,
    ``"min"``, or None (the op gathers its shard inputs instead)."""
    op = node.op_name
    if op in SUM_OPS | MEAN_OPS | MAX_OPS | MIN_OPS:
        if op in _REDUCE_AXIS_OPS and 0 not in _axes_of(
                attrs.get("axis"), glob_ins[0].dim(), None):
            return None
        return ("sum" if op in SUM_OPS else "mean" if op in MEAN_OPS
                else "max" if op in MAX_OPS else "min")
    if _row_loss(op, attrs, glob_ins[0].dim()) and \
            attrs.get("reduction", "mean") in ("sum", "mean"):
        return attrs.get("reduction", "mean")
    return None


def _item12(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"SameDiff {what}: SameDiff's mesh paths take the data axis only "
        f"(its tensor-parallel specs, tp_specs, are what is left of "
        f"ROADMAP.md, Queue A item 12)")


def check_mesh(mesh) -> int:
    """The mesh's data-axis size; an axis other than ``data`` of size
    above 1 raises (item 12)."""
    shape = dict(mesh.shape)
    if DEFAULT_DATA_AXIS not in shape:
        raise ValueError(f"mesh must have a 'data' axis, got "
                         f"{tuple(shape)}")
    other = {k: v for k, v in shape.items()
             if k != DEFAULT_DATA_AXIS and v > 1}
    if other:
        raise _item12(f"mesh axes {other}")
    return int(shape[DEFAULT_DATA_AXIS])


def _spec_shards(name: str, spec) -> bool:
    """Whether an explicit placeholder spec shards the leading axis over
    ``data``: ``"data"``, ``("data", None, ...)`` or a PartitionSpec-like
    sequence; ``None`` or ``()`` replicate. Any other axis raises."""
    entries = (spec if isinstance(spec, (tuple, list)) else
               () if spec is None else (spec,))
    entries = tuple(entries)
    if any(e not in (None, DEFAULT_DATA_AXIS) for e in entries) or \
            DEFAULT_DATA_AXIS in entries[1:]:
        raise _item12(f"placeholder spec {name!r}: {spec!r}")
    return bool(entries) and entries[0] == DEFAULT_DATA_AXIS


def shard_placeholders(n: int, ph_vals: Dict[str, torch.Tensor],
                       batch_names=None, specs=None) -> frozenset:
    """The shared data-parallel placeholder contract of ``output(mesh=)``
    and ``fit_steps(mesh=)``, the JAX package's ``_shard_placeholders``:
    the names of the placeholders whose leading axis shards over the
    ``n`` replicas. ``specs`` maps names to explicit specs (see
    :func:`_spec_shards`), which skip the inference. Otherwise the batch
    is the leading dimension of the first of ``batch_names`` (the
    ``TrainingConfig`` mappings) present, or the vote: the most common
    leading dimension among the non-scalar placeholders, ties broken
    toward dimensions that divide ``n``, then higher rank, then size;
    the vote warns about the placeholders it leaves replicated. A batch
    placeholder whose leading dimension does not divide by ``n``
    raises."""
    specs = dict(specs or {})
    for k in specs:
        if k not in ph_vals:
            raise ValueError(
                f"placeholder spec for unknown placeholder {k!r} "
                f"(have {sorted(ph_vals)})")
    explicit = {k: _spec_shards(k, sp) for k, sp in specs.items()}
    batch, inferred = None, False
    for k in batch_names or ():
        v = ph_vals.get(k)
        if v is not None and v.dim() > 0:
            batch = int(v.shape[0])
            break
    if batch is None:
        leads: dict = {}
        ranks: dict = {}
        for k, v in ph_vals.items():
            if k not in specs and v.dim() > 0:
                d = int(v.shape[0])
                leads[d] = leads.get(d, 0) + 1
                ranks[d] = max(ranks.get(d, 0), v.dim())
        if leads:
            inferred = True
            batch = max(leads, key=lambda d: (
                leads[d], d % n == 0, ranks[d], d))
    if inferred:
        excluded = sorted(
            k for k, v in ph_vals.items()
            if k not in specs and v.dim() > 0 and int(v.shape[0]) != batch)
        if excluded:
            log.warning(
                "batch-dim inference chose leading dim %d — "
                "placeholders %s (other leading dims) will be "
                "replicated, not batch-sharded. Pass explicit "
                "data_set_feature_mapping/label_mapping (or "
                "batch_names), or per-placeholder specs "
                "(ph_specs=...), to disambiguate.", batch, excluded)
    sharded = set()
    for k, v in ph_vals.items():
        shard = explicit[k] if k in explicit else (
            v.dim() > 0 and int(v.shape[0]) == batch)
        if not shard:
            continue
        if v.dim() == 0 or v.shape[0] % n:
            raise ValueError(
                f"placeholder {k!r} batch dim {tuple(v.shape)} not "
                f"divisible by data axis size {n}")
        sharded.add(k)
    return frozenset(sharded)


def local_rows(t: torch.Tensor, rank: int, n: int) -> torch.Tensor:
    s = t.shape[0] // n
    return t[rank * s:(rank + 1) * s]


# ---------------------------------------------------------------------------
class DpWalk:
    """What one replica's walk does differently from the one-device walk:
    the target shapes of reshapes (``reshape``), the ops whose result is
    all-reduced (``reduce``: ``"sum"``, ``"mean"``, ``"max"`` or
    ``"min"``), the ops that run on the global rows (``gather``: the
    positions of their shard inputs, gathered first, and of their outputs
    cut back to this replica's rows), the random ops that draw global
    rows and keep their own (``rows``), which values are shards
    (``sharded``) and the bytes of every value on a replica (``sizes``,
    for the remat segment plan)."""

    __slots__ = ("n", "reshape", "reduce", "gather", "rows", "sharded",
                 "sizes")

    def __init__(self, n: int):
        self.n = n
        self.reshape: Dict[int, list] = {}
        self.reduce: Dict[int, str] = {}
        self.gather: Dict[int, tuple] = {}
        self.rows: set = set()
        self.sharded: set = set()
        self.sizes: Dict[str, int] = {}


def _meta(t: torch.Tensor, rows: Optional[int] = None) -> torch.Tensor:
    shape = tuple(t.shape) if rows is None else (rows,) + tuple(t.shape[1:])
    return torch.empty(shape, dtype=t.dtype, device="meta")


def _is_shard(g: torch.Tensor, lo: torch.Tensor, n: int) -> bool:
    gs, ls = tuple(g.shape), tuple(lo.shape)
    return (len(gs) == len(ls) and bool(gs) and gs[0] == n * ls[0]
            and gs[1:] == ls[1:] and gs != ls)


def classify_walk(sd, ops, ph_vals: Dict[str, torch.Tensor],
                  sharded: frozenset, n: int, training: bool) -> DpWalk:
    """One pass of the walk ``ops`` on meta tensors at the global shapes
    and at one replica's: the :class:`DpWalk` of every op that takes a
    shard. An op runs on its replica's rows when :func:`row_wise` names
    it so and its outputs come out as shards; it reduces over the batch
    and is all-reduced when :func:`batch_combine` names it and its
    result has the same shape on a replica as globally; every other op
    with a shard input gathers the global rows first and keeps its
    replica's rows of each output whose leading dimension is the
    batch's (the rest stay replicated)."""
    walk = DpWalk(n)
    if n == 1:
        # one replica's shard is the batch: the walk is the one-device one
        walk.sharded = set(sharded)
        return walk
    glob = {k: _meta(v) for k, v in sd._arrays.items()}
    glob.update({k: _meta(v) for k, v in ph_vals.items()})
    loc = dict(glob)
    for k in sharded:
        loc[k] = _meta(ph_vals[k], ph_vals[k].shape[0] // n)
    shard = set(sharded)
    rng = RngKey(0)

    def run_local(idx, node, attrs):
        try:
            out = get_op(node.op_name)([loc[i] for i in node.inputs], attrs)
        except (RuntimeError, ValueError, IndexError, TypeError):
            return None
        return [out] if len(node.outputs) == 1 else list(out)

    for idx in ops:
        node = sd.ops[idx]
        attrs = sd._op_attrs(idx, node, rng, training)
        g_ins = [glob[i] for i in node.inputs]
        g_out = get_op(node.op_name)(g_ins, attrs)
        g_out = [g_out] if len(node.outputs) == 1 else list(g_out)
        glob.update(zip(node.outputs, g_out))
        pos = tuple(j for j, i in enumerate(node.inputs) if i in shard)
        if not pos:
            loc.update(zip(node.outputs, g_out))
            continue
        if row_wise(node, attrs, pos, g_ins):
            l_attrs = attrs
            if node.op_name == "reshape":
                # a reshape keeps each replica's rows as one contiguous
                # block of the global value when its leading dimension
                # divides by n: a baked global batch becomes a share
                target = [int(s) for s in node.attrs["shape"]]
                if target and target[0] != -1 and target[0] % n == 0:
                    target[0] //= n
                    l_attrs = dict(attrs, shape=target)
            l_out = run_local(idx, node, l_attrs)
            if l_out is not None and all(
                    _is_shard(g, lo, n) for g, lo in zip(g_out, l_out)):
                if l_attrs is not attrs:
                    walk.reshape[idx] = l_attrs["shape"]
                if node.op_name in RNG_DRAWS:
                    walk.rows.add(idx)
                shard.update(node.outputs)
                loc.update(zip(node.outputs, l_out))
                continue
        else:
            kind = batch_combine(node, attrs, g_ins)
            if kind is not None and len(node.outputs) == 1:
                l_out = run_local(idx, node, attrs)
                if l_out is not None and \
                        tuple(l_out[0].shape) == tuple(g_out[0].shape):
                    walk.reduce[idx] = kind
                    loc.update(zip(node.outputs, l_out))
                    continue
        # gathered: the op runs on the global rows of its shard inputs
        rows = int(g_ins[pos[0]].shape[0])
        keep = tuple(j for j, g in enumerate(g_out)
                     if g.dim() and int(g.shape[0]) == rows)
        walk.gather[idx] = (pos, keep)
        for j, (name, g) in enumerate(zip(node.outputs, g_out)):
            if j in keep:
                shard.add(name)
                loc[name] = _meta(g, rows // n)
            else:
                loc[name] = g
    walk.sharded = shard
    walk.sizes = {k: v.numel() * v.element_size() for k, v in loc.items()
                  if isinstance(v, torch.Tensor)}
    return walk


class _GatherRows(torch.autograd.Function):
    """The replicas' shards concatenated in rank order, differentiable:
    every replica reads the global value, so a shard's cotangent is the
    sum of the replicas' cotangents of its rows."""

    @staticmethod
    def forward(ctx, t, replica):
        ctx.replica, ctx.rows = replica, int(t.shape[0])
        return gather_rows(t, replica)

    @staticmethod
    def backward(ctx, g):
        total = ctx.replica.all_reduce_sum(g.contiguous())
        r = ctx.replica.rank
        return total[r * ctx.rows:(r + 1) * ctx.rows], None


class DpRank:
    """One replica's hooks into ``SameDiff._execute``."""

    __slots__ = ("walk", "replica")

    def __init__(self, walk: DpWalk, replica):
        self.walk, self.replica = walk, replica

    def attrs(self, idx: int, attrs: dict) -> dict:
        target = self.walk.reshape.get(idx)
        if target is not None:
            attrs = dict(attrs, shape=target)
        if idx in self.walk.rows:
            attrs = dict(attrs, _dp_rows=(self.replica.rank,
                                          self.replica.size))
        return attrs

    def inputs(self, idx: int, ins: list) -> list:
        g = self.walk.gather.get(idx)
        if g is None:
            return ins
        ins = list(ins)
        for j in g[0]:
            ins[j] = _GatherRows.apply(ins[j], self.replica)
        return ins

    def combine(self, idx: int, out, ins, attrs: dict):
        g = self.walk.gather.get(idx)
        if g is not None:
            if not g[1]:
                return out
            rank, n = self.replica.rank, self.walk.n
            if not isinstance(out, (tuple, list)):
                return local_rows(out, rank, n)
            return type(out)(local_rows(o, rank, n) if j in g[1] else o
                             for j, o in enumerate(out))
        kind = self.walk.reduce.get(idx)
        if kind is None:
            return out
        if kind in ("max", "min"):
            return self._extreme(kind, ins[0], out, attrs)
        total = all_reduce_sum(out.reshape(-1).contiguous(),
                               self.replica).reshape(out.shape)
        return total / self.walk.n if kind == "mean" else total

    def _extreme(self, kind: str, x: torch.Tensor, out: torch.Tensor,
                 attrs: dict) -> torch.Tensor:
        """The global max (min) over the batch: the replicas' results
        gathered and reduced, exact. Under autograd the cotangent goes to
        every element equal to it, on any replica, divided by their
        count (``jnp.max``'s rule for ties)."""
        rep, n = self.replica, self.walk.n
        dims = tuple(sorted(_axes_of(attrs.get("axis"), x.dim(), None)))
        red = torch.amax if kind == "max" else torch.amin
        local = red(x.detach(), dim=dims, keepdim=True)
        every = rep.all_gather(local.reshape(-1).contiguous())
        best = red(every.reshape((n,) + tuple(local.shape)), dim=0)
        if not (torch.is_grad_enabled() and x.requires_grad):
            return best.reshape(out.shape)
        ind = (x.detach() == best).to(x.dtype)
        count = rep.all_reduce_sum(ind.sum(dims, keepdim=True).contiguous())
        share = all_reduce_sum(((x * ind).sum(dims, keepdim=True)
                                / count).contiguous(), rep)
        return share.reshape(out.shape)


def gather_rows(t: torch.Tensor, replica) -> torch.Tensor:
    """The replicas' shards of ``t`` concatenated in rank order."""
    flat = replica.all_gather(t.contiguous().reshape(-1))
    return flat.reshape((t.shape[0] * replica.size,) + tuple(t.shape[1:]))


# ---------------------------------------------------------------------------
def _replicas(sd, mesh) -> list:
    """The replicas this process runs, each on the graph's device for
    rank 0 (a thread mesh) or this process's one (a process group)."""
    reps = mesh.local_replicas()
    if isinstance(mesh, ThreadMesh):
        if canonical_device(sd.device) != reps[0].device:
            raise ValueError(f"the graph is on {sd.device}, the mesh's "
                             f"rank 0 on {reps[0].device}")
    elif canonical_device(sd.device) != canonical_device(reps[0].device):
        raise ValueError(f"the graph is on {sd.device}, this process's "
                         f"replica on {reps[0].device}")
    return reps


def _run_replicas(mesh, fn) -> list:
    """``fn(i)`` for every local replica ``i``: on the mesh's threads for
    a thread mesh, here for a process group's one."""
    if isinstance(mesh, ThreadMesh):
        return mesh.run(fn)
    return [fn(0)]


def _batch_names(sd):
    cfg = sd.training_config
    if cfg is None:
        return None
    return list(cfg.data_set_feature_mapping) + \
        list(cfg.data_set_label_mapping)


def _walk(sd, plan_ops, ph_vals, sharded, n, training) -> DpWalk:
    key = ("dp", tuple(plan_ops), sharded, n, training,
           tuple(sorted((k, tuple(v.shape), v.dtype)
                        for k, v in ph_vals.items())))
    walk = sd._exec_cache.get(key)
    if walk is None:
        walk = sd._exec_cache[key] = classify_walk(
            sd, plan_ops, ph_vals, sharded, n, training)
    return walk


def output(sd, ph_vals, outputs, mesh, ph_specs, training: bool,
           rng: RngKey) -> Dict[str, torch.Tensor]:
    """``SameDiff.output(mesh=)``: every replica walks its rows; sharded
    outputs are gathered in rank order, so each replica (and each
    process of a group) returns the global result."""
    n = check_mesh(mesh)
    reps = _replicas(sd, mesh)
    plan = sd._plan(outputs, tuple(ph_vals))
    sharded = shard_placeholders(n, ph_vals, _batch_names(sd), ph_specs)
    walk = _walk(sd, plan.ops, ph_vals, sharded, n, training)

    def rank_fn(i):
        rep = reps[i]
        dev = rep.device
        ph = {k: (local_rows(v, rep.rank, n) if k in sharded else v)
              .to(dev) for k, v in ph_vals.items()}
        values = {k: sd._arrays[k].to(dev)
                  for k in list(plan.constants) + list(plan.variables)}
        values.update(ph)
        with torch.no_grad():
            sd._execute(values, plan.ops, rng, training,
                        dp=DpRank(walk, rep))
            return {o: (gather_rows(values[o], rep) if o in walk.sharded
                        else values[o]) for o in outputs}

    return _run_replicas(mesh, rank_fn)[0]


# ---------------------------------------------------------------------------
class _RankState:
    """One replica's variables (dense, or its fsdp slices) and updater
    state (dense, or its slice of the flat layout) for one call."""

    __slots__ = ("replica", "params", "flats", "spec", "state")

    def __init__(self, replica):
        self.replica = replica
        self.params = None
        self.flats = None
        self.spec = None
        self.state = None


def _clone_tree(tree, device):
    if isinstance(tree, dict):
        return {k: _clone_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device, copy=True)
    return copy.deepcopy(tree)


def _step(sd, rs: _RankState, plan, walk: DpWalk, ph, consts, mode,
          encoding, rng: RngKey, iteration: int) -> torch.Tensor:
    """One replica's train step: the walk, its gradient, the exchange."""
    cfg = sd.training_config
    rep = rs.replica
    fsdp = mode is zero.UpdateExchange.FSDP
    if fsdp:
        leaves = {dt: f.detach().requires_grad_(True)
                  for dt, f in rs.flats.items()}
        targets = list(leaves.values())
    else:
        params = {k: t.detach().requires_grad_(True)
                  for k, t in rs.params.items()}
        targets = list(params.values())
    with torch.enable_grad():
        if fsdp:
            params = zero.fsdp_gather(leaves, rs.spec, rep)
        values = dict(consts)
        values.update(params)
        values.update(ph)
        dp = DpRank(walk, rep)
        if sd.remat_segments > 1 and len(plan.ops) > 1:
            sd._execute_segmented(values, plan.ops,
                                  tuple(sd.loss_variables), rng, dp=dp)
        else:
            sd._execute(values, plan.ops, rng, True, dp=dp)
        total = sum(values[o].sum() for o in sd.loss_variables)
        if cfg.l2:
            total = total + 0.5 * cfg.l2 * sum(
                (p * p).sum() for p in params.values())
        if cfg.l1:
            total = total + cfg.l1 * sum(
                p.abs().sum() for p in params.values())
        grads = torch.autograd.grad(total, targets, allow_unused=True)
    up, epoch = cfg.updater, sd.epoch_count
    with torch.no_grad():
        grads = [g if g is not None else torch.zeros_like(t)
                 for g, t in zip(grads, targets)]
        if fsdp:
            flat_g = dict(zip(leaves, grads))
            rs.flats, rs.state = zero.apply_update_fsdp(
                up, flat_g, rs.flats, rs.state, iteration, rep, epoch=epoch)
            return total.detach()
        grads = dict(zip(params, grads))
        plain = {k: t.detach() for k, t in params.items()}
        if mode is zero.UpdateExchange.SHARDED:
            rs.params, rs.state = zero.apply_update_sharded(
                up, grads, plain, rs.state, iteration, rep, epoch=epoch)
        elif mode is zero.UpdateExchange.ENCODED:
            rs.params, rs.state = zero.apply_update_encoded(
                up, grads, plain, rs.state, iteration, rep,
                encoding=encoding, epoch=epoch)
        else:
            # dense: the replicas' mean gradient, one all-reduce a dtype
            flats, spec = dp_ravel(grads, 1)
            mean = dp_unravel({k: rep.all_reduce_sum(f.contiguous())
                               / rep.size for k, f in flats.items()}, spec)
            updates, rs.state = up.apply(mean, rs.state, iteration, epoch)
            rs.params = {k: _apply(p, updates[k]) for k, p in plain.items()}
    return total.detach()


def _apply(p: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``p - u`` in ``p``'s dtype (a 16-bit variable steps at f32 and
    rounds once), as the one-device step applies it."""
    if p.dtype in (torch.float32, torch.float64):
        return (p - u).to(p.dtype)
    return (p.float() - u.float()).to(p.dtype)


def fit_steps(sd, ph_vals, n_steps: int, mesh, update_exchange, ph_specs,
              encoding) -> Optional[torch.Tensor]:
    """``SameDiff.fit_steps(mesh=)``: ``n_steps`` data-parallel steps on
    one global batch; the graph's variables and dense updater state are
    rank 0's (this process's replica's) after the call. Returns the last
    step's loss (the global loss, the same on every replica)."""
    n = check_mesh(mesh)
    reps = _replicas(sd, mesh)
    mode = zero.resolve_update_exchange(mesh, requested=update_exchange)
    encoding = (resolve_encoding(encoding)
                if mode is zero.UpdateExchange.ENCODED else None)
    cfg = sd.training_config
    plan = sd._plan(tuple(sd.loss_variables), tuple(ph_vals))
    names = list(plan.variables)
    sharded = shard_placeholders(n, ph_vals, _batch_names(sd), ph_specs)
    walk = _walk(sd, plan.ops, ph_vals, sharded, n, True)
    dense_vars = {k: sd._arrays[k] for k in names}
    if sd._updater_state is None:
        sd._updater_state = cfg.updater.init_state(dense_vars)
        sd._restore_updater_leaves()
    state0 = sd._updater_state
    if mode is not zero.UpdateExchange.ENCODED:
        state0 = zero.strip_encoded_state(state0)
    sd._rng, key = sd._rng.split(2)
    it0 = sd.iteration_count

    def rank_fn(i):
        rep = reps[i]
        dev, rank = rep.device, rep.rank
        rs = _RankState(rep)
        params = {k: t.to(dev) for k, t in dense_vars.items()}
        state = _clone_tree(state0, dev)
        if mode is zero.UpdateExchange.ENCODED:
            state = zero.shard_state(zero.ensure_encoded_state(
                params, state, n, encoding), rank, n)
        elif mode in zero.FLAT_MODES:
            state = zero.shard_state(zero.to_sharded_state(params, state, n),
                                     rank, n)
        rs.state = state
        if mode is zero.UpdateExchange.FSDP:
            flats, rs.spec = dp_ravel(params, n)
            rs.flats = {dt: local_rows(f, rank, n).clone()
                        for dt, f in flats.items()}
        else:
            rs.params = params
        ph = {k: (local_rows(v, rank, n) if k in sharded else v).to(dev)
              for k, v in ph_vals.items()}
        consts = {k: sd._arrays[k].to(dev) for k in plan.constants}
        loss = None
        for s in range(int(n_steps)):
            loss = _step(sd, rs, plan, walk, ph, consts, mode, encoding,
                         key.fold_in(s), it0 + s)
        # back to the dense layouts (collectives: every replica)
        if mode is zero.UpdateExchange.FSDP:
            full = {dt: rep.all_gather(f) for dt, f in rs.flats.items()}
            rs.params = dp_unravel(full, rs.spec)
        state = rs.state
        if mode in zero.FLAT_MODES:
            state = zero.to_dense_state(rs.params,
                                        zero.gather_state(state, rep))
        return loss, rs.params, state

    loss, params, state = _run_replicas(mesh, rank_fn)[0]
    sd._arrays.update(params)
    sd._updater_state = state
    sd.iteration_count += int(n_steps)
    return loss
