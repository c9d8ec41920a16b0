"""The port's op registry (``autodiff/registry.py``) against the JAX
package's, op by op, on the CPU.

One parametrised case per op (240, the JAX package's whole registry; the
60 of the linalg, bitwise, segment, convolution, image, random and
compression domains from ``chip_smoke.domain_cases``): the same seeded
numpy inputs go through ``get_op(name)`` of both packages, for every
variant the case lists. The control ops' subgraphs are Python callables
written with operators both arrays share, so one attrs dict drives both
packages. Bars: the forward within rtol 2e-5 / atol 1e-6 (f32 on both
sides; the roadmap's default), with the same dtype (integer, bitwise,
index and NMS results exactly); for every floating input, the gradient
of ``sum(out * cotangent)`` (a seeded cotangent for each floating output)
within rtol 2e-4 / atol 2e-5, but for ``NO_JAX_GRAD``. The random ops'
streams differ by design: they are held to the JAX package's shapes and
dtypes, dropout to its identity cases and to its own mask. Then the
port's own ``opvalidation`` runs every case (forward against the JAX
package's output, autograd against central differences in float64) and
its ``coverage_report`` is held at >= 0.95 of the registered ops, the
JAX package's floor.
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke

from deeplearning4j_tpu.autodiff.registry import get_op as jax_get_op
from deeplearning4j_tpu_torch.autodiff import opvalidation
from deeplearning4j_tpu_torch.autodiff.registry import (OP_DOMAINS,
                                                        OP_REGISTRY,
                                                        get_op, op_coverage)
from deeplearning4j_tpu_torch.common.rng import RngKey
from torch_parity import one_intraop_thread  # noqa: F401,E402

FWD = dict(rtol=2e-5, atol=1e-6)
GRAD = dict(rtol=2e-4, atol=2e-5)
PORTED_DOMAINS = {"arithmetic": 17, "transform": 30, "activation": 17,
                  "blas": 7, "reduce": 18, "indexreduce": 4,
                  "boolean": 15, "shape": 42, "normalization": 5,
                  "loss": 9, "attention": 4, "recurrent": 7, "control": 5,
                  "linalg": 14, "bitwise": 8, "segment": 11,
                  "convolution": 14, "image": 7, "random": 4,
                  "compression": 2}
#: ops the JAX package cannot differentiate (scatter-multiply has a
#: gradient only for unique indices); ``opvalidation`` holds the port's
#: gradients of them against central differences
NO_JAX_GRAD = {"segment_prod", "unsorted_segment_prod"}


class _R:
    """Seeded inputs for one case."""

    def __init__(self, name):
        self.rs = np.random.RandomState(zlib.crc32(name.encode()))

    def f(self, *shape, lo=-1.0, hi=1.0):
        return self.rs.uniform(lo, hi, shape).astype(np.float32)

    def n(self, *shape):
        return self.rs.randn(*shape).astype(np.float32)

    def i(self, lo, hi, *shape):
        return self.rs.randint(lo, hi, shape).astype(np.int32)

    def b(self, *shape):
        return self.rs.rand(*shape) < 0.5


def _key_mask(b, t, masked):
    m = np.ones((b, 1, 1, t), np.int32)
    m[:, ..., t - masked:] = 0
    return m


def _cases():
    """op -> list of (inputs, attrs) variants; grads are checked for
    every floating input of every variant."""
    c = {}

    def add(name, fn):
        c[name] = fn(_R(name))

    # arithmetic
    for nm in ("add", "sub", "mul", "maximum", "minimum",
               "squared_difference", "rsub"):
        add(nm, lambda r: [([r.f(3, 4), r.f(4)], {}),
                           ([r.f(2, 3), np.float32(0.7)], {})])
    add("div", lambda r: [([r.f(3, 4), r.f(4, lo=0.5, hi=2)], {}),
                          ([r.i(-9, 9, 5), r.i(1, 4, 5)], {})])
    add("rdiv", lambda r: [([r.f(3, 4, lo=0.5, hi=2), r.f(4)], {})])
    add("pow", lambda r: [([r.f(3, 4, lo=0.5, hi=2), r.f(4)], {})])
    for nm in ("floordiv", "mod", "fmod"):
        add(nm, lambda r: [([r.f(3, 4, lo=-5, hi=5),
                             r.f(4, lo=0.7, hi=1.9)], {}),
                           ([r.i(-9, 9, 6), r.i(1, 4, 6)], {})])
    for nm in ("neg", "abs", "sign"):
        add(nm, lambda r: [([r.f(3, 4)], {})])
    add("reciprocal", lambda r: [([r.f(3, 4, lo=0.5, hi=2)], {})])
    # transforms
    for nm in ("exp", "expm1", "square", "cube", "floor", "ceil", "round",
               "sin", "cos", "tan", "atan", "sinh", "cosh", "tanh",
               "asinh", "erf", "erfc", "identity"):
        add(nm, lambda r: [([r.f(3, 4, lo=-1.3, hi=1.3)], {})])
    for nm in ("log", "log1p", "sqrt", "rsqrt"):
        add(nm, lambda r: [([r.f(3, 4, lo=0.5, hi=3)], {})])
    for nm in ("asin", "acos", "atanh"):
        add(nm, lambda r: [([r.f(3, 4, lo=-0.9, hi=0.9)], {})])
    add("acosh", lambda r: [([r.f(3, 4, lo=1.2, hi=3)], {})])
    add("atan2", lambda r: [([r.f(3, 4), r.f(3, 4)], {})])
    add("clip_by_value", lambda r: [([r.f(3, 4)], {
        "clip_value_min": -0.5, "clip_value_max": 0.4})])
    add("clip_by_norm", lambda r: [([r.f(3, 4)], {"clip_norm": 0.5}),
                                   ([r.f(3, 4) * 0.01], {"clip_norm": 0.5})])
    add("cast", lambda r: [([r.f(3, 4, lo=-3, hi=3)], {"dtype": "int32"}),
                           ([r.i(-3, 3, 5)], {"dtype": "float32"}),
                           ([r.f(3, 4)], {"dtype": "bool"})])
    # activations
    for nm in ("relu", "relu6", "sigmoid", "softplus", "softsign", "elu",
               "selu", "gelu", "gelu_tanh", "swish", "mish",
               "hard_sigmoid", "hard_tanh"):
        add(nm, lambda r: [([r.f(3, 5, lo=-4, hi=7)], {})])
    add("leaky_relu", lambda r: [([r.n(3, 5)], {"alpha": 0.2}),
                                 ([r.n(3, 5)], {})])
    add("softmax", lambda r: [([r.n(3, 5)], {}), ([r.n(3, 5)], {"axis": 0})])
    add("log_softmax", lambda r: [([r.n(3, 5)], {}),
                                  ([r.n(3, 5)], {"axis": 0})])
    add("prelu", lambda r: [([r.n(3, 5), r.f(5, lo=0.1, hi=0.3)], {})])
    # blas
    add("matmul", lambda r: [
        ([r.n(2, 3, 4), r.n(2, 5, 4)], {"transpose_b": True}),
        ([r.n(4, 3), r.n(2, 4, 5)], {"transpose_a": True}),
        ([r.n(2, 3, 4), r.n(4, 6)], {})])
    for nm in ("mmul", "batch_matmul"):
        add(nm, lambda r: [([r.n(2, 3, 4), r.n(2, 4, 5)], {})])
    add("tensordot_last", lambda r: [([r.n(3, 4), r.n(4, 5)], {})])
    add("outer", lambda r: [([r.n(3), r.n(4)], {})])
    add("dot", lambda r: [([r.n(3, 4), r.n(4, 2)], {}),
                          ([r.n(2, 3, 4), r.n(3, 4, 5)], {})])
    add("einsum", lambda r: [([r.n(2, 3, 4), r.n(2, 4, 5)],
                              {"equation": "bij,bjk->bik"})])
    # reductions
    for nm in ("reduce_sum", "reduce_mean", "reduce_max", "reduce_min",
               "reduce_std", "reduce_var"):
        add(nm, lambda r: [([r.n(3, 4, 5)], {"axis": [0, 2]}),
                           ([r.n(3, 4, 5)], {"axis": 1, "keep_dims": True}),
                           ([r.n(3, 4)], {})])
    add("reduce_prod", lambda r: [
        ([r.f(3, 4, 5, lo=0.5, hi=1.5)], {"axis": [0, 2]}),
        ([r.f(3, 4, lo=0.5, hi=1.5)], {"axis": 1, "keep_dims": True})])
    for nm in ("sum", "mean", "amax", "amin"):
        add(nm, lambda r: [([r.n(3, 4)], {"axis": 1}),
                           ([r.i(-5, 5, 3, 4)], {"axis": 0})])
    for nm in ("reduce_norm1", "reduce_norm2"):
        add(nm, lambda r: [([r.n(3, 4)], {"axis": 1}), ([r.n(3, 4)], {})])
    add("reduce_logsumexp", lambda r: [([r.n(3, 4)], {"axis": -1}),
                                       ([r.n(3, 4)], {})])
    add("cumsum", lambda r: [([r.n(3, 5)], {"axis": 1}),
                             ([r.n(3, 5)], {"axis": 1, "exclusive": True,
                                            "reverse": True})])
    add("cumprod", lambda r: [([r.f(3, 5, lo=0.5, hi=1.5)], {"axis": 1}),
                              ([r.f(3, 5, lo=0.5, hi=1.5)],
                               {"axis": 0, "exclusive": True})])
    for nm in ("reduce_any", "reduce_all"):
        add(nm, lambda r: [([r.b(3, 4)], {"axis": 1}),
                           ([r.i(0, 2, 3, 4)], {})])
    # index reductions
    for nm in ("argmax", "argmin"):
        add(nm, lambda r: [([r.n(3, 5)], {}), ([r.n(3, 5)], {"axis": 0})])
    add("top_k", lambda r: [([r.n(4, 6)], {"k": 3}),
                            ([r.n(4, 6)], {"k": 2, "axis": 0}),
                            ([r.n(4, 6)], {"k": 2, "largest": False})])
    add("in_top_k", lambda r: [([r.n(4, 6), r.i(0, 6, 4)], {"k": 2})])
    # boolean
    for nm in ("eq", "neq", "gt", "gte", "lt", "lte"):
        add(nm, lambda r: [([r.i(0, 3, 3, 4), r.i(0, 3, 4)], {}),
                           ([r.n(3, 4), r.n(3, 4)], {})])
    for nm in ("logical_and", "logical_or", "logical_xor"):
        add(nm, lambda r: [([r.b(3, 4), r.b(3, 4)], {})])
    add("logical_not", lambda r: [([r.b(3, 4)], {})])

    def special(r):
        x = r.n(3, 4)
        x[0, 1], x[1, 2], x[2, 3] = np.nan, np.inf, -np.inf
        return [([x], {})]
    for nm in ("is_nan", "is_inf", "is_finite"):
        add(nm, special)
    for nm in ("where", "select"):
        add(nm, lambda r: [([r.b(3, 4), r.n(3, 4), r.n(4)], {})])
    # shape
    add("reshape", lambda r: [([r.n(3, 4)], {"shape": [2, -1]})])
    for nm in ("permute", "transpose"):
        add(nm, lambda r: [([r.n(2, 3, 4)], {"axes": [1, 0, 2]})])
    add("expand_dims", lambda r: [([r.n(3, 4)], {"axis": 1}),
                                  ([r.n(3, 4)], {"axis": -1})])
    add("squeeze", lambda r: [([r.n(3, 1, 4)], {"axis": 1}),
                              ([r.n(1, 3, 1)], {})])
    add("concat", lambda r: [([r.n(2, 3), r.n(2, 2)], {"axis": 1})])
    add("stack", lambda r: [([r.n(2, 3), r.n(2, 3)], {"axis": 1})])
    add("unstack", lambda r: [([r.n(3, 2, 4)], {"axis": 1})])
    add("split", lambda r: [([r.n(3, 4)], {"num_splits": 2, "axis": 1})])
    add("split_v", lambda r: [([r.n(3, 4)], {"size_splits": [1, 3],
                                              "axis": 1})])
    add("tile", lambda r: [([r.n(2, 3)], {"reps": [2, 1]}),
                           ([r.n(2, 3)], {"reps": [3]})])
    add("repeat", lambda r: [([r.n(2, 3)], {"repeats": 2, "axis": 1})])
    add("flip", lambda r: [([r.n(2, 3)], {"axis": 0}), ([r.n(2, 3)], {})])
    add("gather", lambda r: [
        ([r.n(5, 3), r.i(0, 5, 2, 2)], {"axis": 0}),
        ([r.n(2, 6, 4), r.i(0, 6, 2, 3)], {"axis": 1, "batch_dims": 1}),
        ([r.n(2, 3, 6, 4), r.i(0, 6, 2, 5)], {"axis": 2, "batch_dims": 1})])
    add("tensor_list_set_item", lambda r: [
        ([r.n(4, 3), np.int32(2), r.n(3)], {}),
        ([r.n(4, 3), np.int32(9), r.n(3)], {})])
    add("tensor_list_get_item", lambda r: [([r.n(4, 3), np.int32(1)], {}),
                                           ([r.n(4, 3), np.int32(7)], {})])
    add("tensor_list_length", lambda r: [([r.n(4, 3)], {})])
    add("gather_nd", lambda r: [
        ([r.n(4, 3), np.asarray([[1, 2], [3, 0]], np.int32)], {})])
    add("scatter_update", lambda r: [
        ([r.n(5, 3), np.asarray([1, 3], np.int32), r.n(2, 3)], {})])
    add("scatter_add", lambda r: [
        ([r.n(5, 3), np.asarray([1, 3, 1], np.int32), r.n(3, 3)], {})])
    add("pad", lambda r: [
        ([r.n(3, 4)], {"paddings": [[1, 2], [0, 1]], "constant": 0.5}),
        ([r.n(3, 4)], {"paddings": [[1, 2], [2, 1]], "mode": "reflect"}),
        ([r.n(3, 4)], {"paddings": [[1, 2], [2, 1]],
                       "mode": "symmetric"}),
        ([r.n(3, 4)], {"paddings": [[1, 2], [2, 1]], "mode": "edge"}),
        ([r.n(3, 4)], {"paddings": [[1, 2], [2, 1]], "mode": "wrap"})])
    add("slice", lambda r: [([r.n(4, 5)], {"begin": [1, 0],
                                            "size": [2, -1]})])
    add("strided_slice", lambda r: [
        ([r.n(5, 6)], {"begin": [1, 0], "end": [4, 6], "strides": [1, 2]}),
        ([r.n(5, 6)], {"begin": [3, 5], "end": [0, 0],
                       "strides": [-1, -2]})])
    for nm in ("shape_of", "size", "rank"):
        add(nm, lambda r: [([r.n(2, 3, 4)], {})])
    add("one_hot", lambda r: [
        ([np.asarray([0, 3, -1, 7, 2], np.int32)], {"depth": 5}),
        ([np.asarray([[1, 0], [2, 4]], np.int32)], {"depth": 5,
                                                    "axis": 0})])
    add("reverse_sequence", lambda r: [
        ([r.n(2, 5, 3), np.asarray([3, 5], np.int32)],
         {"seq_axis": 1, "batch_axis": 0})])
    add("broadcast_to", lambda r: [([r.n(1, 3)], {"shape": [2, 3]})])
    add("zeros_like", lambda r: [([r.n(2, 3)], {})])
    add("ones_like", lambda r: [([r.n(2, 3)], {})])
    add("fill", lambda r: [([], {"shape": [2, 3], "value": 1.5})])
    add("range", lambda r: [([], {"start": 1, "limit": 10, "delta": 3}),
                            ([], {"start": 0.5, "limit": 2.0,
                                  "delta": 0.25})])
    add("linspace", lambda r: [([], {"start": 0.0, "stop": 1.0,
                                     "num": 5})])
    add("space_to_depth", lambda r: [([r.n(1, 4, 4, 2)],
                                      {"block_size": 2})])
    add("depth_to_space", lambda r: [([r.n(1, 2, 2, 8)],
                                      {"block_size": 2})])
    add("reverse", lambda r: [([r.n(2, 3)], {"axes": [0, 1]}),
                              ([r.n(2, 3), np.asarray([1], np.int32)], {})])
    add("roll", lambda r: [([r.n(2, 5)], {"shift": [2], "axes": [1]})])
    add("scatter_nd", lambda r: [
        ([np.asarray([[0, 1], [2, 2], [0, 1]], np.int32), r.n(3)],
         {"shape": [3, 3]})])
    add("scatter_nd_update", lambda r: [
        ([r.n(3, 3), np.asarray([[0, 1], [2, 2]], np.int32), r.n(2)], {})])
    add("invert_permutation", lambda r: [
        ([np.asarray([2, 0, 3, 1], np.int32)], {})])
    add("index", lambda r: [
        ([r.n(3, 4, 5)], {"spec": [
            {"kind": "slice", "begin": 1, "end": None, "stride": None},
            {"kind": "newaxis"},
            {"kind": "int", "i": 2},
            {"kind": "ellipsis"}]}),
        ([r.n(3, 4)], {"spec": [
            {"kind": "slice", "begin": None, "end": None, "stride": -1},
            {"kind": "slice", "begin": 3, "end": 0, "stride": -2}]})])
    # normalization
    add("layer_norm", lambda r: [
        ([r.n(2, 3, 8), r.f(8, lo=0.5, hi=1.5), r.n(8)],
         {"epsilon": 1e-5}),
        ([r.n(2, 3, 8)], {"axis": -1, "epsilon": 1e-12}),
        ([r.n(2, 3, 8), r.f(3, 8, lo=0.5, hi=1.5)],
         {"axis": [1, 2], "epsilon": 1e-3})])
    add("batch_norm", lambda r: [
        ([r.n(4, 3), r.n(3), r.f(3, lo=0.5, hi=2), r.n(3), r.n(3)],
         {"epsilon": 1e-3})])
    add("lrn", lambda r: [([r.n(1, 2, 2, 6)], {"depth": 3, "alpha": 0.5,
                                               "bias": 2.0})])
    add("standardize", lambda r: [([r.n(3, 5)], {})])
    add("moments", lambda r: [([r.n(3, 5)], {"axis": [0]})])
    # losses
    probs = lambda r: (lambda e: (e / e.sum(-1, keepdims=True)).astype(
        np.float32))(np.exp(r.n(4, 5)))
    add("softmax_cross_entropy", lambda r: [
        ([probs(r), r.n(4, 5)], {}),
        ([probs(r), r.n(4, 5), r.f(4, lo=0.5, hi=1.5)],
         {"label_smoothing": 0.1, "reduction": "sum"})])
    add("sparse_softmax_cross_entropy", lambda r: [
        ([r.i(0, 5, 4), r.n(4, 5)], {}),
        ([r.i(0, 5, 2, 3), r.n(2, 3, 5)], {"reduction": "none"}),
        ([r.i(0, 5, 4), r.n(4, 5)], {"reduction": "sum"})])
    add("sigmoid_cross_entropy", lambda r: [
        ([r.b(4, 3).astype(np.float32), r.n(4, 3)], {}),
        ([r.b(4, 3).astype(np.float32), r.n(4, 3), r.f(4, 3)],
         {"reduction": "none"})])
    for nm in ("mean_squared_error", "absolute_difference"):
        add(nm, lambda r: [([r.n(4, 3), r.n(4, 3)], {}),
                           ([r.n(4, 3), r.n(4, 3), r.f(4, 3)],
                            {"reduction": "sum"})])
    add("huber_loss", lambda r: [([r.n(4, 3), r.n(4, 3)], {"delta": 0.5})])
    add("log_loss", lambda r: [([r.b(4, 3).astype(np.float32),
                                 r.f(4, 3, lo=0.1, hi=0.9)], {})])
    add("cosine_distance", lambda r: [([r.n(4, 3), r.n(4, 3)], {})])
    add("hinge_loss", lambda r: [([r.b(4, 3).astype(np.float32),
                                   r.n(4, 3)], {})])
    # attention
    add("apply_key_mask", lambda r: [
        ([r.n(2, 2, 3, 5), _key_mask(2, 5, 2)], {"neg": -30.0}),
        ([r.n(2, 2, 3, 5), _key_mask(2, 5, 2)], {"neg": -1e9})])
    add("sdpa_core", lambda r: [
        ([r.n(2, 2, 5, 4), r.n(2, 2, 5, 4), r.n(2, 2, 5, 4),
          _key_mask(2, 5, 2)], {"scale": 0.5, "mask_mode": "key"}),
        ([r.n(2, 2, 5, 4), r.n(2, 2, 5, 4), r.n(2, 2, 5, 4),
          r.n(2, 1, 5, 5)], {"scale": 0.3}),
        ([r.n(2, 5, 4), r.n(2, 5, 4), r.n(2, 5, 4)], {})])
    add("dot_product_attention", lambda r: [
        ([r.n(2, 2, 5, 4), r.n(2, 2, 5, 4), r.n(2, 2, 5, 4),
          _key_mask(2, 5, 1)], {}),
        ([r.n(2, 5, 4), r.n(2, 5, 4), r.n(2, 5, 4)], {"scale": 0.7})])
    add("multi_head_dot_product_attention", lambda r: [
        ([r.n(2, 5, 8), r.n(8, 8) * 0.3, r.n(8, 8) * 0.3, r.n(8, 8) * 0.3,
          r.n(8, 8) * 0.3, _key_mask(2, 5, 1)[:, 0, 0]], {"num_heads": 2})])
    # recurrent (b=2, f=3, H=4, t=5; SRU needs f == H)
    add("lstm_cell", lambda r: [([r.n(2, 3), r.n(2, 4), r.n(2, 4),
                                  r.n(3, 16) * 0.5, r.n(4, 16) * 0.5,
                                  r.n(16) * 0.1], {})])
    add("gru_cell", lambda r: [([r.n(2, 3), r.n(2, 4), r.n(3, 12) * 0.5,
                                 r.n(4, 12) * 0.5, r.n(12) * 0.1], {})])
    add("sru_cell", lambda r: [([r.n(2, 4), r.n(2, 4), r.n(4, 12) * 0.5,
                                 r.n(12) * 0.1], {})])
    add("lstm_layer", lambda r: [([r.n(2, 5, 3), r.n(2, 4), r.n(2, 4),
                                   r.n(3, 16) * 0.5, r.n(4, 16) * 0.5,
                                   r.n(16) * 0.1], {})])
    add("rnn_layer", lambda r: [([r.n(2, 5, 3), r.n(2, 4), r.n(3, 4) * 0.5,
                                  r.n(4, 4) * 0.5, r.n(4) * 0.1], {})])
    add("gru_layer", lambda r: [
        ([r.n(2, 5, 3), r.n(2, 4), r.n(3, 12) * 0.5, r.n(4, 12) * 0.5,
          r.n(12) * 0.1, r.n(12) * 0.1], {"linear_before_reset": lbr})
        for lbr in (False, True)])
    add("sru", lambda r: [([r.n(2, 5, 4), r.n(2, 4), r.n(4, 12) * 0.5,
                            r.n(12) * 0.1], {})])
    # control: a bounded while (the unbounded one has no gradient in
    # either package: tests/test_torch_control_flow.py), a cond each way,
    # a scan over xs and one over a length, select-lowered switch/merge
    add("while_loop", lambda r: [
        ([r.f(4, lo=0.5, hi=1.5)],
         {"_cond_call": lambda v: [v.sum() < 30.0],
          "_body_call": lambda v: [v * 2.0 + 0.5], "n_loop": 1,
          "n_cond_caps": 0, "n_body_caps": 0, "max_iterations": 8}),
        ([r.f(3, lo=0.5, hi=1.0), r.f(3, lo=1.1, hi=1.4)],
         {"_cond_call": lambda v: [v.sum() < 12.0],
          "_body_call": lambda v, w: [v * w], "n_loop": 1,
          "n_cond_caps": 0, "n_body_caps": 1, "max_iterations": 16})])
    add("cond", lambda r: [
        ([np.asarray(p), r.n(3), r.n(3), r.n(3)],
         {"_true_call": lambda v, w: [v * w, v + 1.0],
          "_false_call": lambda v, w: [v + w, v * v],
          "n_operands": 1, "n_true_caps": 1, "n_false_caps": 1})
        for p in (True, False)])
    add("scan", lambda r: [
        ([r.n(3), r.n(5, 3), r.f(3, lo=0.5, hi=1.0)],
         {"_body_call": lambda c, x, w: [c * w + x, c * x],
          "n_carry": 1, "n_xs": 1, "length": None}),
        ([r.n(3), r.f(3, lo=0.5, hi=1.0)],
         {"_body_call": lambda c, w: [c * w, c], "n_carry": 1, "n_xs": 0,
          "length": 4})])
    add("switch", lambda r: [([r.n(3), np.asarray(True)], {})])
    add("merge", lambda r: [([r.n(3), r.n(3), np.asarray(p)], {})
                            for p in (True, False)])
    # the seven domains of slice 18: chip_smoke's table, which phase 22
    # also runs on the card
    c.update(chip_smoke.domain_cases())
    return c


CASES = _cases()


def _outs(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


def _float_idx(arrays):
    return [i for i, a in enumerate(arrays)
            if np.asarray(a).dtype.kind == "f"]


#: the JAX package's forward outputs by (op, variant): computed once a
#: module, for the cotangents, the parity check and the validator
_JAX_OUTS: dict = {}


def _jax_outs(name, k):
    key = (name, k)
    if key not in _JAX_OUTS:
        ins, attrs = CASES[name][k]
        _JAX_OUTS[key] = [np.asarray(o) for o in _outs(jax_get_op(name)(
            [jnp.asarray(a) for a in ins], dict(attrs)))]
    return _JAX_OUTS[key]


def _jax_run(name, k, cts):
    """The JAX package's outputs (cached) and its gradient of
    ``Σ out·ct`` with respect to every float input."""
    ins, attrs = CASES[name][k]
    fn = jax_get_op(name)
    fidx = _float_idx(ins)
    base = [jnp.asarray(a) for a in ins]

    def loss(*wrt):
        full = list(base)
        for j, i in enumerate(fidx):
            full[i] = wrt[j]
        outs = _outs(fn(full, dict(attrs)))
        return sum(jnp.sum(o * ct) for o, ct in zip(outs, cts)
                   if ct is not None), outs

    outs = _jax_outs(name, k)
    grads = None
    if fidx and any(ct is not None for ct in cts):
        grads = jax.grad(lambda *w: loss(*w)[0],
                         argnums=tuple(range(len(fidx))))(
            *[base[i] for i in fidx])
        grads = [np.asarray(g) for g in grads]
    return outs, grads


def _port_run(name, ins, attrs, cts):
    fn = get_op(name)
    fidx = _float_idx(ins)
    ts = [torch.as_tensor(np.asarray(a)) for a in ins]
    for i in fidx:
        ts[i] = ts[i].clone().requires_grad_(True)
    outs = _outs(fn(list(ts), dict(attrs)))
    grads = None
    if fidx and any(ct is not None for ct in cts):
        total = sum((o * torch.as_tensor(ct)).sum()
                    for o, ct in zip(outs, cts) if ct is not None)
        grads = ([None] * len(fidx) if not total.requires_grad else
                 torch.autograd.grad(total, [ts[i] for i in fidx],
                                     allow_unused=True))
        grads = [np.zeros(ts[i].shape, np.float32) if g is None
                 else g.numpy() for i, g in zip(fidx, grads)]
    return [o.detach().numpy() for o in outs], grads


def _cotangents(name, outs):
    rs = np.random.RandomState(zlib.crc32(name.encode()) + 1)
    return [np.asarray(rs.randn(*o.shape), np.float32)
            if o.dtype.kind == "f" else None for o in outs]


def test_registry_is_the_eleven_ported_domains():
    """The JAX package's whole registry: every name, with its domain
    counts (the name is the one the test had when fewer were ported)."""
    assert op_coverage() == PORTED_DOMAINS
    assert len(OP_REGISTRY) == 240
    jax_reg = jax_get_op.__globals__
    assert set(OP_REGISTRY) == set(jax_reg["OP_REGISTRY"])
    assert op_coverage() == jax_reg["op_coverage"]()
    assert set(CASES) == set(OP_REGISTRY)


def _random_keys(attrs):
    """The key each package's random op reads: JAX's PRNGKey(0) and the
    port's RngKey(0), unless the case sets ``rng`` itself."""
    if "rng" in attrs:
        return dict(attrs), dict(attrs)
    return {**attrs, "rng": jax.random.PRNGKey(0)}, {**attrs,
                                                     "rng": RngKey(0)}


def _random_matches_jax(name, ins, attrs, what):
    """The streams differ, so a random op is held to the JAX package's
    shapes and dtypes, dropout to its identity cases bit for bit, and
    dropout's draw to ``where(keep, x / (1 - p), 0)`` with the gradient
    of its own mask."""
    j_attrs, p_attrs = _random_keys(attrs)
    j = np.asarray(jax_get_op(name)([jnp.asarray(a) for a in ins],
                                    j_attrs))
    x = [torch.as_tensor(np.asarray(a)).requires_grad_(True) for a in ins]
    p = get_op(name)(x, p_attrs)
    assert p.dtype == torch.float32 and j.dtype == np.float32, what
    assert tuple(p.shape) == j.shape, what
    if name != "dropout":
        return
    pn = p.detach().numpy()
    if p_attrs.get("rng") is None or not p_attrs.get("training", True):
        np.testing.assert_array_equal(pn, j, err_msg=what)
        return
    keep = pn != 0
    scale = 1.0 / (1.0 - attrs["rate"])
    np.testing.assert_allclose(pn[keep], ins[0][keep] * scale, **FWD)
    (g,) = torch.autograd.grad(p.sum(), x)
    np.testing.assert_allclose(g.numpy(), keep * np.float32(scale), **FWD)


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_jax(name):
    for k, (ins, attrs) in enumerate(CASES[name]):
        what = f"{name} variant {k} ({OP_DOMAINS[name]})"
        if OP_DOMAINS[name] == "random":
            _random_matches_jax(name, ins, attrs, what)
            continue
        cts = _cotangents(name, _jax_outs(name, k))
        if name in NO_JAX_GRAD:
            cts = [None] * len(cts)
        j_outs, j_grads = _jax_run(name, k, cts)
        p_outs, p_grads = _port_run(name, ins, attrs, cts)
        assert len(p_outs) == len(j_outs), what
        for o, (p, j) in enumerate(zip(p_outs, j_outs)):
            assert p.dtype == j.dtype, f"{what} output {o}: {p.dtype} vs " \
                                       f"{j.dtype}"
            assert p.shape == j.shape, f"{what} output {o}"
            np.testing.assert_allclose(p, j, **FWD,
                                       err_msg=f"{what} output {o}")
        if j_grads is not None:
            for g, (p, j) in enumerate(zip(p_grads, j_grads)):
                np.testing.assert_allclose(
                    p, j, **GRAD, err_msg=f"{what} gradient {g}")


def test_opvalidation_coverage_over_registered_ops():
    """Every case through the port's own validator: forward against the
    JAX package's output, autograd against float64 central differences
    on every floating input."""
    for name, variants in sorted(CASES.items()):
        ins, attrs = variants[0]
        if OP_DOMAINS[name] == "random":
            # a draw depends on its key alone: no JAX value to hold it to,
            # but dropout's gradient is its own mask's
            opvalidation.validate(opvalidation.TestCase(
                op=name, inputs=ins, attrs=_random_keys(attrs)[1]))
            continue
        want = _jax_outs(name, 0)
        opvalidation.validate(opvalidation.TestCase(
            op=name, inputs=ins, attrs=attrs, expected=want,
            fwd_tol=2e-5))
    report = opvalidation.coverage_report()
    assert report["fraction"] >= 0.95, report["missing"]
    assert report["total"] == 240
