"""The frozen Keras ResNet-50 GraphDef written without TensorFlow, and its
fine-tuning setup.

A fixture for ``chip_smoke.py`` and the tests, not an exporter: it
writes the one graph that ``convert_variables_to_constants_v2`` freezes
from ``keras.applications.ResNet50(weights=None, input_shape=(S, S, 3),
classes=K)`` traced by ``tf.function(lambda x: m(x, training=False))``
at batch B (Keras 3, in a process that built the model right after
``keras.backend.clear_session()``, so Keras' per-process name counters
give ``resnet50_1/<layer>_1/...``), node for node: the same names, op
types, inputs and attrs, and the same weight Consts. Keras 3 freezes
each BatchNormalization to ``Rsqrt`` / ``Mul`` / ``Sub`` / ``AddV2`` over
the moving statistics reshaped to ``[1, 1, 1, C]``; a convolution's bias
is reshaped and squeezed before its ``BiasAdd``.

:func:`resnet50_weights` draws the weights from ``RandomState(seed)`` in
Keras' ``model.weights`` order (per layer: a convolution's kernel and
bias; a batch norm's gamma, beta, moving mean and moving variance; the
classifier's kernel and bias), so the same list goes into the Keras
model with ``set_weights``. The draws keep activations of order one
through the 16 blocks: He-normal kernels, batch norms near the identity
whose last one in each residual branch scales by 0.2-0.4, and a
classifier of ``0.5 / sqrt(2048)`` (logits of standard deviation ~2.4
at 224 x 224 and 1000 classes).

:func:`build_resnet50_graph` returns the serialized GraphDef (input
``x`` ``[B, S, S, 3]``, output ``Identity``, the softmax);
:func:`import_and_attach_loss` imports it, promotes the convolution and
dense kernels and biases and the batch norms' gains and offsets to
trainable variables (the moving statistics stay constant: the batch
norm is frozen) and attaches softmax cross-entropy to the logits.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch.modelimport.tensorflow.graph_writer import (
    _DT_FLOAT, _DT_INT32, _NP_ENUM, _PRODUCER, _attr_b, _attr_list, _attr_s,
    _attr_shape, _attr_type, _key, _ld, _node, _tensor_proto, _varint)

#: (filters, blocks, first stride) of the four stages
STAGES = ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2))
#: Keras' BatchNormalization epsilon in ResNet-50
BN_EPS = 1.001e-5
_SCOPE = "resnet50_1"
_T = {"T": _attr_type(_DT_FLOAT)}
#: batch norm weight -> the frozen graph's read of it
_BN_READS = {"moving_variance": "Cast_1", "gamma": "Cast_2",
             "beta": "Cast_3", "moving_mean": "Cast"}
#: the imported graph's constants that hold trainable weights: the
#: importer folds each Const into the op that reads it (a convolution's
#: kernel into its ReadVariableOp, its bias into the Squeeze, gamma and
#: beta into the Reshapes ``_3`` and ``_2``)
_TRAINABLE_SUFFIXES = ("/convolution/ReadVariableOp", "_conv_1/Squeeze",
                       "_bn_1/Reshape_3", "_bn_1/Reshape_2",
                       "predictions_1/Cast/ReadVariableOp",
                       "predictions_1/BiasAdd/ReadVariableOp")


def _layers() -> List[Tuple[str, str, tuple]]:
    """(layer name, kind, geometry) in Keras' ``model.weights`` order (a
    topological order: a first block's projection shortcut comes after
    the branch's second convolution); a convolution's geometry is
    (kernel, cin, cout), a batch norm's (channels,)."""
    out = [("conv1_conv", "conv", (7, 3, 64)), ("conv1_bn", "bn", (64,))]
    cin = 64
    for s, (f, blocks, _) in enumerate(STAGES):
        for b in range(blocks):
            name = f"conv{s + 2}_block{b + 1}"
            out += [(f"{name}_1_conv", "conv", (1, cin, f)),
                    (f"{name}_1_bn", "bn", (f,)),
                    (f"{name}_2_conv", "conv", (3, f, f)),
                    (f"{name}_2_bn", "bn", (f,))]
            if b == 0:
                out += [(f"{name}_0_conv", "conv", (1, cin, 4 * f)),
                        (f"{name}_3_conv", "conv", (1, f, 4 * f)),
                        (f"{name}_0_bn", "bn", (4 * f,))]
            else:
                out += [(f"{name}_3_conv", "conv", (1, f, 4 * f))]
            out += [(f"{name}_3_bn", "bn", (4 * f,))]
            cin = 4 * f
    return out


def resnet50_weights(classes: int = 1000, seed: int = 0
                     ) -> List[Tuple[str, np.ndarray]]:
    """``(Keras weight path, array)`` in ``model.weights`` order, drawn
    from ``RandomState(seed)`` in that order."""
    rs = np.random.RandomState(seed)
    out = []
    for name, kind, geo in _layers():
        if kind == "conv":
            k, cin, cout = geo
            fan_in = k * k * cin
            out.append((f"{name}/kernel", rs.randn(k, k, cin, cout)
                        * np.sqrt(2.0 / fan_in)))
            out.append((f"{name}/bias", rs.randn(cout) * 0.01))
            continue
        (c,) = geo
        lo, hi = (0.2, 0.4) if name.endswith("_3_bn") else (0.8, 1.2)
        out.append((f"{name}/gamma", rs.uniform(lo, hi, c)))
        out.append((f"{name}/beta", rs.randn(c) * 0.05))
        out.append((f"{name}/moving_mean", rs.randn(c) * 0.1))
        out.append((f"{name}/moving_variance", rs.uniform(0.8, 1.2, c)))
    out.append(("predictions/kernel", rs.randn(2048, classes)
                * (0.5 / np.sqrt(2048.0))))
    out.append(("predictions/bias", rs.randn(classes) * 0.01))
    return [(n, np.asarray(a, np.float32)) for n, a in out]


def _ints(v: Sequence[int]) -> bytes:
    return _attr_list(ints=v)


class _Writer:
    """The frozen graph's nodes: the placeholder, then every Const in
    the order the ops first read them, then the ops."""

    def __init__(self, weights: dict):
        self.w = weights
        self.consts: List[bytes] = []
        self.ops: List[bytes] = []
        self.reads: List[str] = []

    def const(self, name: str, value) -> str:
        arr = np.asarray(value)
        self.consts.append(_node(name, "Const", [], {
            "dtype": _attr_type(_NP_ENUM[arr.dtype]),
            "value": _ld(8, _tensor_proto(arr))}))
        return name

    def op(self, name: str, op: str, inputs, **attrs) -> str:
        self.ops.append(_node(name, op, list(inputs), attrs))
        return name

    def read(self, scope: str, key: str) -> str:
        """A variable read: its frozen value and the Identity TensorFlow
        leaves in place of ReadVariableOp."""
        src = self.const(f"{scope}/ReadVariableOp/resource", self.w[key])
        self.reads.append(f"{scope}/ReadVariableOp")
        return self.op(f"{scope}/ReadVariableOp", "Identity", [src],
                       _has_manual_control_dependencies=_attr_b(True), **_T)

    def reshape(self, scope: str, x: str, shape) -> str:
        shp = self.const(f"{scope}/shape", np.asarray(shape, np.int32))
        return self.op(scope, "Reshape", [x, shp],
                       Tshape=_attr_type(_DT_INT32), **_T)

    def pad(self, layer: str, x: str, p: int) -> str:
        s = f"{_SCOPE}/{layer}_1"
        c = self.const(f"{s}/Const", np.asarray(
            [[0, 0], [p, p], [p, p], [0, 0]], np.int32))
        return self.op(f"{s}/Pad", "Pad", [x, c],
                       Tpaddings=_attr_type(_DT_INT32), **_T)

    def conv(self, layer: str, x: str, k: int, cout: int, stride: int
             ) -> str:
        s = f"{_SCOPE}/{layer}_1"
        w = self.read(f"{s}/convolution", f"{layer}/kernel")
        y = self.op(f"{s}/convolution", "Conv2D", [x, w],
                    data_format=_attr_s(b"NHWC"), dilations=_ints([1] * 4),
                    explicit_paddings=_ints([]),
                    padding=_attr_s(b"SAME" if k == 3 else b"VALID"),
                    strides=_ints([1, stride, stride, 1]),
                    use_cudnn_on_gpu=_attr_b(True), **_T)
        b = self.reshape(f"{s}/Reshape", self.read(f"{s}/Reshape",
                                                   f"{layer}/bias"),
                         [1, 1, 1, cout])
        b = self.op(f"{s}/Squeeze", "Squeeze", [b], squeeze_dims=_ints([]),
                    **_T)
        return self.op(f"{s}/BiasAdd", "BiasAdd", [y, b],
                       data_format=_attr_s(b"NHWC"), **_T)

    def bn(self, layer: str, x: str, c: int) -> str:
        s = f"{_SCOPE}/{layer}_1"
        shape = [1, 1, 1, c]

        def stat(key, reshape):
            return self.reshape(f"{s}/{reshape}", self.read(
                f"{s}/{_BN_READS[key]}", f"{layer}/{key}"), shape)

        var = stat("moving_variance", "Reshape_1")
        eps = self.const(f"{s}/batchnorm/add/y", np.float32(BN_EPS))
        r = self.op(f"{s}/batchnorm/Rsqrt", "Rsqrt", [self.op(
            f"{s}/batchnorm/add", "AddV2", [var, eps], **_T)], **_T)
        m = self.op(f"{s}/batchnorm/mul", "Mul",
                    [r, stat("gamma", "Reshape_3")], **_T)
        y = self.op(f"{s}/batchnorm/mul_1", "Mul", [x, m], **_T)
        beta = stat("beta", "Reshape_2")
        mm = self.op(f"{s}/batchnorm/mul_2", "Mul",
                     [stat("moving_mean", "Reshape"), m], **_T)
        sub = self.op(f"{s}/batchnorm/sub", "Sub", [beta, mm], **_T)
        return self.op(f"{s}/batchnorm/add_1", "AddV2", [y, sub], **_T)

    def relu(self, layer: str, x: str) -> str:
        return self.op(f"{_SCOPE}/{layer}_1/Relu", "Relu", [x], **_T)

    def conv_bn(self, name: str, x: str, k: int, cout: int,
                stride: int) -> str:
        return self.bn(f"{name}_bn", self.conv(f"{name}_conv", x, k, cout,
                                               stride), cout)

    def block(self, name: str, x: str, f: int, stride: int,
              shortcut: bool) -> str:
        """keras.applications.resnet's ``block1``."""
        sc = (self.conv_bn(f"{name}_0", x, 1, 4 * f, stride) if shortcut
              else x)
        y = self.relu(f"{name}_1_relu", self.conv_bn(f"{name}_1", x, 1, f,
                                                     stride))
        y = self.relu(f"{name}_2_relu", self.conv_bn(f"{name}_2", y, 3, f,
                                                     1))
        y = self.conv_bn(f"{name}_3", y, 1, 4 * f, 1)
        add = self.op(f"{_SCOPE}/{name}_add_1/Add", "AddV2", [sc, y], **_T)
        return self.relu(f"{name}_out", add)

    def network(self) -> str:
        x = self.relu("conv1_relu", self.conv_bn(
            "conv1", self.pad("conv1_pad", "x", 3), 7, 64, 2))
        x = self.op(f"{_SCOPE}/pool1_pool_1/MaxPool2d", "MaxPool",
                    [self.pad("pool1_pad", x, 1)],
                    data_format=_attr_s(b"NHWC"),
                    explicit_paddings=_ints([]), ksize=_ints([1, 3, 3, 1]),
                    padding=_attr_s(b"VALID"), strides=_ints([1, 2, 2, 1]),
                    **_T)
        for s, (f, blocks, stride) in enumerate(STAGES):
            for b in range(blocks):
                x = self.block(f"conv{s + 2}_block{b + 1}", x, f,
                               stride if b == 0 else 1, b == 0)
        ax = self.const(f"{_SCOPE}/avg_pool_1/Mean/reduction_indices",
                        np.asarray([1, 2], np.int32))
        x = self.op(f"{_SCOPE}/avg_pool_1/Mean", "Mean", [x, ax],
                    Tidx=_attr_type(_DT_INT32), keep_dims=_attr_b(False),
                    **_T)
        p = f"{_SCOPE}/predictions_1"
        x = self.op(f"{p}/MatMul", "MatMul",
                    [x, self.read(f"{p}/Cast", "predictions/kernel")],
                    grad_a=_attr_b(False), grad_b=_attr_b(False),
                    transpose_a=_attr_b(False), transpose_b=_attr_b(False),
                    **_T)
        x = self.op(f"{p}/BiasAdd", "BiasAdd",
                    [x, self.read(f"{p}/BiasAdd", "predictions/bias")],
                    data_format=_attr_s(b"NHWC"), **_T)
        return self.op(f"{p}/Softmax", "Softmax", [x], **_T)


def build_resnet50_graph(image: int = 224, classes: int = 1000,
                         batch: int = 32, seed: int = 0,
                         weights: Optional[Sequence] = None) -> bytes:
    """The serialized frozen GraphDef of Keras' ResNet-50 at ``image`` x
    ``image`` x 3, ``classes`` outputs and batch ``batch``, with
    :func:`resnet50_weights` (or ``weights``, the same list)."""
    w = _Writer(dict(weights if weights is not None
                     else resnet50_weights(classes, seed)))
    out = w.network()
    x = _node("x", "Placeholder", [], {
        "dtype": _attr_type(_DT_FLOAT),
        "shape": _attr_shape((batch, image, image, 3))})
    tail = [_node("NoOp", "NoOp", [f"^{r}" for r in sorted(w.reads)],
                  {"_has_manual_control_dependencies": _attr_b(True)}),
            _node("Identity", "Identity", [out, "^NoOp"], dict(_T))]
    versions = _key(1, 0) + _varint(_PRODUCER)
    return (b"".join(_ld(1, n) for n in [x] + w.consts + w.ops + tail)
            + _ld(4, versions))


#: the logits: the classifier's BiasAdd, before the softmax
LOGITS = f"{_SCOPE}/predictions_1/BiasAdd"


def trainable_names(sd) -> List[str]:
    """The imported graph's constants that hold the convolution and dense
    kernels and biases and the batch norms' gains and offsets (214)."""
    return [n for n in sd._arrays if n.endswith(_TRAINABLE_SUFFIXES)]


def import_and_attach_loss(gd_bytes, batch: int, image: int, *,
                           updater=None, device=None) -> Tuple[object, str]:
    """Import the frozen ResNet-50 onto ``device`` (``None``: the card),
    promote :func:`trainable_names` to VARIABLEs and attach the mean
    softmax cross-entropy of the logits against int32 ``labels``
    ``[batch]``. Returns ``(sd, "loss")``."""
    from deeplearning4j_tpu_torch.modelimport.tensorflow import \
        TensorflowFrameworkImporter
    sd = TensorflowFrameworkImporter.run_import(
        gd_bytes, {"x": (batch, image, image, 3)}, device=device)
    sd.convert_to_variables(trainable_names(sd))
    labels = sd.placeholder("labels", shape=(batch,), dtype="int32")
    sd._op("sparse_softmax_cross_entropy", [labels, sd.vars[LOGITS]],
           name="loss")
    sd.set_loss_variables(["loss"])
    if updater is not None:
        from deeplearning4j_tpu_torch.autodiff.training import TrainingConfig
        sd.set_training_config(
            TrainingConfig.Builder().updater(updater).build())
    return sd, "loss"
