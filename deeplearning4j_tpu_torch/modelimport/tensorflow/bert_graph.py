"""A frozen BERT GraphDef written without TensorFlow, and its MLM setup.

Counterpart of ``benchmarks/tf_bert_builder.py`` for a machine with no
TensorFlow. It is a fixture for ``chip_smoke.py`` and the tests, not an
exporter: it writes the one graph that TensorFlow freezes from
``tf_bert_builder.f`` (``convert_variables_to_constants_v2`` of the
canonical encoder: token/position/segment embeddings, post-LN blocks,
GELU through erf, the additive ``(1 - mask) * -1e9`` attention bias,
returning the sequence output ``[b, s, H]``), node for node: the same
names, op types, inputs and attrs, and the same weights, drawn from
``RandomState(seed)`` in ``tf_bert_builder``'s order (the zero biases
and unit gains are not drawn). The weight Consts carry TensorFlow's
names
(``<op>/ReadVariableOp/resource`` read through an Identity
``<op>/ReadVariableOp``, ``Gather/resource`` for the embedding tables),
so one promotion rule finds the weights in either graph.

:func:`build_frozen_bert` returns the serialized GraphDef;
:func:`import_and_attach_mlm` (the port of ``tf_bert_builder``'s)
imports it, promotes the frozen weights to trainable variables and
attaches the weight-tied MLM loss.

The bytes come from ``graph_writer``, the fixtures' protobuf writer.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.modelimport.tensorflow.graph_writer import (
    _DT_FLOAT, _DT_INT32, _Graph, _attr_b, _attr_i, _attr_type, _ld,
    _shape_proto)

#: canonical BERT-base dimensions
BERT_BASE = dict(vocab=30522, hidden=768, heads=12, layers=12,
                 intermediate=3072)


# -- the encoder, op by op as TensorFlow traces it -----------------------------
class _Bert:
    def __init__(self, g: _Graph, w: dict, batch: int, seq: int,
                 hidden: int, heads: int):
        self.g, self.w = g, w
        self.batch, self.seq, self.hidden, self.heads = batch, seq, hidden, \
            heads
        self.hd = hidden // heads

    def _op(self, base: str, op: str, inputs, **attrs) -> str:
        return self.g.add(self.g.unique(base), op, inputs, **attrs)

    def _read(self, scope: str, key: str) -> str:
        """A variable read inside op ``scope``: its frozen value and the
        Identity TensorFlow leaves in place of ReadVariableOp."""
        src = self.g.const(f"{scope}/ReadVariableOp/resource", self.w[key])
        self.g.reads.append(f"{scope}/ReadVariableOp")
        return self.g.add(f"{scope}/ReadVariableOp", "Identity", [src],
                          T=_attr_type(_DT_FLOAT))

    def binary(self, base: str, op: str, a, b, scalar_side=None,
               value=None) -> str:
        """``a op b`` where one side may be a scalar float constant,
        created under the op's scope as ``<op>/x`` or ``<op>/y``."""
        name = self.g.unique(base)
        if scalar_side == "x":
            a = self.g.const(f"{name}/x", np.float32(value))
        elif scalar_side == "y":
            b = self.g.const(f"{name}/y", np.float32(value))
        return self.g.add(name, op, [a, b], T=_attr_type(_DT_FLOAT))

    def add_weight(self, x: str, key: str) -> str:
        name = self.g.unique("add")
        w = self._read(name, key)
        return self.g.add(name, "AddV2", [x, w], T=_attr_type(_DT_FLOAT))

    def mul_weight(self, x: str, key: str) -> str:
        name = self.g.unique("mul")
        w = self._read(name, key)
        return self.g.add(name, "Mul", [x, w], T=_attr_type(_DT_FLOAT))

    def matmul(self, a: str, b: str, adj_y: bool = False) -> str:
        return self._op("MatMul", "BatchMatMulV2", [a, b],
                        T=_attr_type(_DT_FLOAT), adj_x=_attr_b(False),
                        adj_y=_attr_b(adj_y), grad_x=_attr_b(False),
                        grad_y=_attr_b(False))

    def matmul_weight(self, x: str, key: str) -> str:
        name = self.g.unique("MatMul")
        w = self._read(name, key)
        return self.g.add(name, "BatchMatMulV2", [x, w],
                          T=_attr_type(_DT_FLOAT), adj_x=_attr_b(False),
                          adj_y=_attr_b(False), grad_x=_attr_b(False),
                          grad_y=_attr_b(False))

    def strided_slice(self, x: str, begin, end, strides, dtype: int,
                      **masks) -> str:
        name = self.g.unique("strided_slice")
        ins = [x] + [self.g.const(f"{name}/{s}", np.asarray(v, np.int32))
                     for s, v in (("stack", begin), ("stack_1", end),
                                  ("stack_2", strides))]
        attrs = {k: _attr_i(masks.get(k, 0)) for k in (
            "begin_mask", "end_mask", "ellipsis_mask", "new_axis_mask",
            "shrink_axis_mask")}
        return self.g.add(name, "StridedSlice", ins, T=_attr_type(dtype),
                          Index=_attr_type(_DT_INT32), **attrs)

    def dims(self, shape: Sequence[int], extra: Sequence[int]) -> str:
        """``tf.stack([s[0], s[1], *extra])`` of ``s = tf.shape(y)``,
        whose Shape TensorFlow froze to a Const."""
        s = self.g.const(self.g.unique("Shape"), np.asarray(shape, np.int32))
        s0 = self.strided_slice(s, [0], [1], [1], _DT_INT32,
                                shrink_axis_mask=1)
        s1 = self.strided_slice(s, [1], [2], [1], _DT_INT32,
                                shrink_axis_mask=1)
        name = self.g.unique("stack")
        ins = [s0, s1] + [self.g.const(f"{name}/{i + 2}", np.int32(v))
                          for i, v in enumerate(extra)]
        return self.g.add(name, "Pack", ins, T=_attr_type(_DT_INT32),
                          axis=_attr_i(0), N=_attr_i(len(ins)))

    def reshape(self, x: str, shape: str) -> str:
        return self._op("Reshape", "Reshape", [x, shape],
                        T=_attr_type(_DT_FLOAT),
                        Tshape=_attr_type(_DT_INT32))

    def transpose(self, x: str) -> str:
        name = self.g.unique("transpose")
        perm = self.g.const(f"{name}/perm", np.asarray([0, 2, 1, 3],
                                                       np.int32))
        return self.g.add(name, "Transpose", [x, perm],
                          T=_attr_type(_DT_FLOAT),
                          Tperm=_attr_type(_DT_INT32))

    def mean(self, x: str) -> str:
        name = self.g.unique("Mean")
        ax = self.g.const(f"{name}/reduction_indices", np.int32(-1))
        return self.g.add(name, "Mean", [x, ax], T=_attr_type(_DT_FLOAT),
                          Tidx=_attr_type(_DT_INT32),
                          keep_dims=_attr_b(True))

    def gather(self, key: str, ids: str) -> str:
        name = self.g.unique("Gather")
        table = self.g.const(f"{name}/resource", self.w[key])
        axis = self.g.const(f"{name}/axis", np.int32(0))
        self.g.reads.append(name)
        return self.g.add(name, "GatherV2", [table, ids, axis],
                          Tparams=_attr_type(_DT_FLOAT),
                          Tindices=_attr_type(_DT_INT32),
                          Taxis=_attr_type(_DT_INT32),
                          batch_dims=_attr_i(0))

    def layer_norm(self, x: str, i: int, ln: str) -> str:
        mu = self.mean(x)
        sq = self._op("SquaredDifference", "SquaredDifference", [x, mu],
                      T=_attr_type(_DT_FLOAT))
        var = self.mean(sq)
        d = self.binary("sub", "Sub", x, mu)
        r = self._op("Rsqrt", "Rsqrt",
                     [self.binary("add", "AddV2", var, None, "y", 1e-12)],
                     T=_attr_type(_DT_FLOAT))
        y = self.binary("mul", "Mul", d, r)
        return self.add_weight(self.mul_weight(y, f"l{i}_{ln}g"),
                               f"l{i}_{ln}b")

    def encoder(self, layers: int) -> str:
        b, s, H, A, hd = self.batch, self.seq, self.hidden, self.heads, \
            self.hd
        ph = {n: self.g.add(n, "Placeholder", dtype=_attr_type(_DT_INT32),
                            shape=_ld(7, _shape_proto((b, s))))
              for n in ("ids", "seg", "mask")}
        tok = self.gather("tok", ph["ids"])
        self.g.reads.append("ReadVariableOp")
        pos = self.strided_slice(
            self.g.add("ReadVariableOp", "Identity",
                       [self.g.const("ReadVariableOp/resource",
                                     self.w["pos"])],
                       T=_attr_type(_DT_FLOAT)),
            [0], [0], [1], _DT_FLOAT, new_axis_mask=1)
        x = self.binary("add", "AddV2", tok, pos)
        x = self.binary("add", "AddV2", x, self.gather("seg", ph["seg"]))
        cast = self._op("Cast", "Cast", [ph["mask"]],
                        SrcT=_attr_type(_DT_INT32),
                        DstT=_attr_type(_DT_FLOAT), Truncate=_attr_b(False))
        neg = self.binary("mul", "Mul",
                          self.binary("sub", "Sub", None, cast, "x", 1.0),
                          None, "y", -1e9)
        neg = self.strided_slice(neg, [0, 0, 0, 0], [0, 0, 0, 0],
                                 [1, 1, 1, 1], _DT_FLOAT, begin_mask=9,
                                 end_mask=9, new_axis_mask=6)
        for i in range(layers):
            def proj(nm, t):
                y = self.add_weight(self.matmul_weight(t, f"l{i}_{nm}w"),
                                    f"l{i}_{nm}b")
                return self.transpose(self.reshape(
                    y, self.dims((b, s, H), (A, hd))))

            q, k, v = proj("q", x), proj("k", x), proj("v", x)
            scores = self.binary("truediv", "RealDiv",
                                 self.matmul(q, k, adj_y=True), None, "y",
                                 np.sqrt(hd))
            probs = self._op("Softmax", "Softmax",
                             [self.binary("add", "AddV2", scores, neg)],
                             T=_attr_type(_DT_FLOAT))
            ctx = self.transpose(self.matmul(probs, v))
            ctx = self.reshape(ctx, self.dims((b, s, A, hd), (H,)))
            att = self.add_weight(self.matmul_weight(ctx, f"l{i}_ow"),
                                  f"l{i}_ob")
            x = self.layer_norm(self.binary("add", "AddV2", x, att), i,
                                "ln1")
            h = self.add_weight(self.matmul_weight(x, f"l{i}_ffw1"),
                                f"l{i}_ffb1")
            half = self.binary("mul", "Mul", None, h, "x", 0.5)
            erf = self._op("Erf", "Erf",
                           [self.binary("truediv", "RealDiv", h, None, "y",
                                        np.sqrt(2.0))],
                           T=_attr_type(_DT_FLOAT))
            h = self.binary("mul", "Mul", half,
                            self.binary("add", "AddV2", None, erf, "x", 1.0))
            h = self.add_weight(self.matmul_weight(h, f"l{i}_ffw2"),
                                f"l{i}_ffb2")
            x = self.layer_norm(self.binary("add", "AddV2", x, h), i, "ln2")
        return x


def bert_weights(seq: int, *, vocab: int, hidden: int, layers: int,
                 intermediate: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """``tf_bert_builder.build_frozen_bert``'s weights: the same
    ``RandomState(seed)`` draws in its order, zero biases, unit gains."""
    rs = np.random.RandomState(seed)

    def w(*shape, scale=0.02):
        return (rs.randn(*shape) * scale).astype(np.float32)

    p = {"tok": w(vocab, hidden), "pos": w(seq, hidden),
         "seg": w(2, hidden)}
    for i in range(layers):
        for nm in ("q", "k", "v", "o"):
            p[f"l{i}_{nm}w"] = w(hidden, hidden)
            p[f"l{i}_{nm}b"] = np.zeros(hidden, np.float32)
        p[f"l{i}_ffw1"] = w(hidden, intermediate)
        p[f"l{i}_ffb1"] = np.zeros(intermediate, np.float32)
        p[f"l{i}_ffw2"] = w(intermediate, hidden)
        p[f"l{i}_ffb2"] = np.zeros(hidden, np.float32)
        for ln in ("ln1", "ln2"):
            p[f"l{i}_{ln}g"] = np.ones(hidden, np.float32)
            p[f"l{i}_{ln}b"] = np.zeros(hidden, np.float32)
    return p


def build_frozen_bert(seq: int, batch: int, *, vocab=30522, hidden=768,
                      heads=12, layers=12, intermediate=None,
                      seed=0) -> bytes:
    """The serialized frozen GraphDef of ``tf_bert_builder.f`` at these
    dimensions: inputs ``ids``, ``seg``, ``mask`` (int32 ``[batch,
    seq]``), output ``Identity`` ``[batch, seq, hidden]``."""
    intermediate = intermediate or hidden * 4
    w = bert_weights(seq, vocab=vocab, hidden=hidden, layers=layers,
                     intermediate=intermediate, seed=seed)
    g = _Graph()
    out = _Bert(g, w, batch, seq, hidden, heads).encoder(layers)
    g.add("NoOp", "NoOp", [f"^{r}" for r in sorted(g.reads)])
    g.add("Identity", "Identity", [out, "^NoOp"], T=_attr_type(_DT_FLOAT))
    return g.serialize()


def import_and_attach_mlm(gd_bytes, batch: int, seq: int, *, vocab: int,
                          hidden: int, updater=None, dtype=None,
                          max_predictions: Optional[int] = None,
                          device=None) -> Tuple[object, str]:
    """Import the frozen encoder (``gd_bytes``: the serialized GraphDef,
    or anything else ``run_import`` takes, such as its decoded nodes)
    onto ``device`` (``None``: the card),
    promote every frozen weight to a trainable VARIABLE and attach a
    weight-tied MLM objective: ``logits = seq_out @ tok_embeddingᵀ``,
    sparse softmax cross-entropy over the positions whose label >= 0
    (-1 = ignored). Returns ``(sd, "mlm_loss")``.

    ``dtype`` (e.g. ``"bfloat16"``) casts the promoted weights and every
    other float32 constant (the mask's -1e9, LayerNorm's eps, ...), so
    the whole imported program computes in that dtype; the loss is
    summed in float32. ``max_predictions=k`` gathers k positions a
    sequence (placeholder ``mlm_positions`` ``[b, k]``) before the
    decode matmul, with labels ``[b, k]``; ``None`` decodes every
    position (labels ``[b, seq]``)."""
    from deeplearning4j_tpu_torch.autodiff.registry import (dtype_name,
                                                            torch_dtype)
    from deeplearning4j_tpu_torch.autodiff.samediff import VariableType
    from deeplearning4j_tpu_torch.modelimport.tensorflow import \
        TensorflowFrameworkImporter

    shapes = {"ids": (batch, seq), "seg": (batch, seq),
              "mask": (batch, seq)}
    sd = TensorflowFrameworkImporter.run_import(gd_bytes, shapes,
                                                device=device)
    wnames = [n for n, v in sd.vars.items()
              if v.var_type == VariableType.CONSTANT
              and ("ReadVariableOp" in n or n.endswith("/resource"))]
    values = None
    if dtype is not None:
        dt = torch_dtype(dtype)
        values = {n: sd._arrays[n].to(dt) for n in wnames}
        for n, v in sd.vars.items():
            arr = sd._arrays.get(n)
            if (v.var_type == VariableType.CONSTANT and n not in wnames
                    and arr is not None and arr.dtype == torch.float32):
                sd._arrays[n] = arr.to(dt)
                v.dtype = dtype_name(dt)
        sd._exec_cache.clear()
    sd.convert_to_variables(wnames, values)
    out = sorted(n for n in sd.vars if n.startswith("Identity"))[0]
    tok = [n for n in wnames if sd.vars[n].shape == (vocab, hidden)]
    if len(tok) != 1:
        raise RuntimeError(f"expected one (vocab, hidden) weight, "
                           f"found {tok}")
    seq_out = sd.vars[out]
    if max_predictions is not None:
        positions = sd.placeholder("mlm_positions",
                                   shape=(batch, max_predictions),
                                   dtype="int32")
        seq_out = sd._op("gather", [seq_out, positions],
                         {"axis": 1, "batch_dims": 1})
    logits = sd._op("matmul", [seq_out, sd.vars[tok[0]]],
                    {"transpose_b": True})
    labels = sd.placeholder(
        "mlm_labels", dtype="int32",
        shape=(batch, seq if max_predictions is None else max_predictions))
    zero = sd.constant("mlm_zero", np.asarray(0, np.int32))
    safe = sd._op("maximum", [labels, zero])
    xent = sd._op("sparse_softmax_cross_entropy", [safe, logits],
                  {"reduction": "none"})
    valid = sd._op("cast", [sd._op("gte", [labels, zero])],
                   {"dtype": "float32"})
    if dtype is not None:
        xent = sd._op("cast", [xent], {"dtype": "float32"})
    num = sd._op("reduce_sum", [sd._op("mul", [xent, valid])],
                 {"axis": None})
    den = sd._op("maximum", [
        sd._op("reduce_sum", [valid], {"axis": None}),
        sd.constant("mlm_one", np.asarray(1.0, np.float32))])
    sd._op("div", [num, den]).rename("mlm_loss")
    sd.set_loss_variables(["mlm_loss"])
    if updater is not None:
        from deeplearning4j_tpu_torch.autodiff.training import TrainingConfig
        sd.set_training_config(
            TrainingConfig.Builder().updater(updater).build())
    return sd, "mlm_loss"

