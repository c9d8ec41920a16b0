"""A frozen two-layer LSTM language model's GraphDef, written without
TensorFlow, in both of TensorFlow's export forms, and its training setup.

A fixture for ``chip_smoke.py`` and the tests, as ``bert_graph.py`` is
for BERT (and built on its protobuf writer). It writes, node for node
(names, op types, inputs, the attrs TensorFlow sets that describe the
computation), the graph TensorFlow 2 exports for this function
(``lstm_lm``)::

    def lstm_lm(x, w, batch, time, vocab, hidden, tensor_arrays=None):
        h = x                                       # one-hot [b, t, vocab]
        for l in range(2):
            kw, rw, b = w[f"l{l}_w"], w[f"l{l}_rw"], w[f"l{l}_b"]
            xs = tf.transpose(h, [1, 0, 2])
            ta = (tf.TensorArray(tf.float32, size=time)
                  if tensor_arrays is None else tensor_arrays[l])

            def body(t, hp, cp, ta, xs=xs, kw=kw, rw=rw, b=b):
                z = tf.matmul(tf.gather(xs, t), kw) + tf.matmul(hp, rw) + b
                i, f, o, g = tf.split(z, 4, axis=1)
                c = tf.sigmoid(f) * cp + tf.sigmoid(i) * tf.tanh(g)
                hn = tf.sigmoid(o) * tf.tanh(c)
                return t + 1, hn, c, ta.write(t, hn)

            z0 = tf.zeros((batch, hidden))
            _, _, _, ta = tf.while_loop(lambda t, *_: t < time, body,
                                        (tf.constant(0), z0, z0, ta))
            h = tf.transpose(ta.stack(), [1, 0, 2])
        y = tf.nn.bias_add(tf.matmul(tf.reshape(h, (-1, hidden)),
                                     w["out_w"]), w["out_b"])
        return tf.reshape(y, (batch, time, vocab))

with the weights ``w`` of :func:`lstm_weights` (``tf.Variable`` s). The
gate order [i, f, o, g] is the registry's ``lstm_layer``'s.

- ``form="functional"``: ``tf.function(...).get_concrete_function`` of
  ``lstm_lm`` on a ``[batch, time, vocab]`` float32 ``x``, frozen with
  ``convert_variables_to_constants_v2(..., lower_control_flow=False)``:
  a ``While`` per layer whose cond and body are library functions, the
  TensorArray as ``TensorListReserve`` / ``SetItem`` / ``Stack``, and
  the captured weights as the While's trailing inputs
  (``while/input_7..9``).
- ``form="v1"``: the same function built in a ``tf.compat.v1`` graph
  with ``disable_control_flow_v2`` (the two TensorArrays made before it,
  so they stay TensorLists: v1's ``TensorArrayV3`` ops are mapped by
  neither importer), the variables named by their keys, the output
  ``tf.identity(..., name="Identity")``, and frozen with
  ``convert_variables_to_constants``: ``Enter`` / ``Merge`` /
  ``Switch`` / ``NextIteration`` / ``Exit`` frames.

Both have input ``x`` and output ``Identity`` ``[batch, time, vocab]``.
:func:`import_and_attach_loss` imports either, promotes the frozen
weights to trainable variables and attaches softmax cross-entropy.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch.modelimport.tensorflow.graph_writer import (
    _DT_FLOAT, _DT_INT32, _Graph, _attr_b, _attr_func, _attr_i, _attr_list,
    _attr_s, _attr_shape, _attr_type, _key, _ld, _varint)

_DT_BOOL, _DT_VARIANT = 10, 21
#: the weights, in draw order
WEIGHT_KEYS = ("l0_w", "l0_rw", "l0_b", "l1_w", "l1_rw", "l1_b", "out_w",
               "out_b")
#: the functional form's frozen Consts of the LSTM weights (the While's
#: trailing inputs)
_FUNCTIONAL_NAMES = {
    "l0_w": "while/input_7", "l0_rw": "while/input_8",
    "l0_b": "while/input_9", "l1_w": "while_1/input_7",
    "l1_rw": "while_1/input_8", "l1_b": "while_1/input_9"}
#: the head's weights in an imported graph of either form: the importer
#: folds each Const into the Identity that reads it
_HEAD_NAMES = {"out_w": "MatMul/ReadVariableOp",
               "out_b": "BiasAdd/ReadVariableOp"}


def weight_names(form: str) -> Dict[str, str]:
    """Weight key -> the constant that holds it in ``form``'s imported
    graph."""
    if form == "functional":
        return {**_FUNCTIONAL_NAMES, **_HEAD_NAMES}
    if form == "v1":
        return {**{k: k for k in WEIGHT_KEYS[:6]}, **_HEAD_NAMES}
    raise ValueError(f"form must be 'functional' or 'v1', not {form!r}")


def lstm_weights(vocab: int, hidden: int, seed: int = 0
                 ) -> Dict[str, np.ndarray]:
    """The weights, drawn from ``RandomState(seed)`` in ``WEIGHT_KEYS``
    order: matrices ``randn / sqrt(fan_in)``, biases ``randn * 0.1``."""
    rs = np.random.RandomState(seed)
    p, f = {}, vocab
    for layer in range(2):
        p[f"l{layer}_w"] = (rs.randn(f, 4 * hidden) / np.sqrt(f)).astype(
            np.float32)
        p[f"l{layer}_rw"] = (rs.randn(hidden, 4 * hidden)
                             / np.sqrt(hidden)).astype(np.float32)
        p[f"l{layer}_b"] = (rs.randn(4 * hidden) * 0.1).astype(np.float32)
        f = hidden
    p["out_w"] = (rs.randn(hidden, vocab) / np.sqrt(hidden)).astype(
        np.float32)
    p["out_b"] = (rs.randn(vocab) * 0.1).astype(np.float32)
    return p


_T_FLOAT, _T_INT = _attr_type(_DT_FLOAT), _attr_type(_DT_INT32)
_MATMUL = dict(T=_T_FLOAT, transpose_a=_attr_b(False),
               transpose_b=_attr_b(False), grad_a=_attr_b(False),
               grad_b=_attr_b(False))


# -- the functional form -------------------------------------------------------
def _function_def(name: str, in_args, out_args, nodes: List[bytes],
                  ret: Dict[str, str]) -> bytes:
    """FunctionDef: signature (OpDef: name, input_arg, output_arg),
    node_def, ret."""
    def arg(a):
        return _ld(1, a[0].encode()) + _key(3, 0) + _varint(a[1])
    sig = (_ld(1, name.encode()) + b"".join(_ld(2, arg(a)) for a in in_args)
           + b"".join(_ld(3, arg(a)) for a in out_args))
    return (_ld(1, sig) + b"".join(_ld(3, n) for n in nodes)
            + b"".join(_ld(4, _ld(1, k.encode()) + _ld(2, v.encode()))
                       for k, v in sorted(ret.items())))


#: per layer: the While's name, its input sequence's name, and the
#: numbers TensorFlow gave its functions in a fresh process
_LAYERS = (("while", "transpose", 229, 230, 34),
           ("while_1", "transpose_2", 231, 232, 121))
_LOOP_TYPES = [_DT_INT32, _DT_INT32, _DT_INT32, _DT_FLOAT, _DT_FLOAT,
               _DT_VARIANT, _DT_FLOAT, _DT_FLOAT, _DT_FLOAT, _DT_FLOAT]


def _loop_args(w: str) -> List[Tuple[str, int]]:
    return [(f"{w}_{w}_loop_counter", _DT_INT32),
            (f"{w}_{w}_maximum_iterations", _DT_INT32),
            (f"{w}_placeholder", _DT_INT32),
            (f"{w}_placeholder_1", _DT_FLOAT),
            (f"{w}_placeholder_2", _DT_FLOAT),
            (f"{w}_placeholder_3", _DT_VARIANT)]


def _cond_fn(w: str, fid: int, uid: int, time: int) -> bytes:
    b = _Graph()
    b.const(f"{w}/Less/y", np.int32(time))
    b.add(f"{w}/Less", "Less", [f"{w}_placeholder", f"{w}/Less/y:output:0"],
          T=_T_INT)
    b.add(f"{w}/Identity", "Identity", [f"{w}/Less:z:0"],
          T=_attr_type(_DT_BOOL))
    extra = [(f"{w}_{w}_cond_{uid}___redundant_placeholder{i}", _DT_FLOAT)
             for i in range(4)]
    return _function_def(f"{w}_cond_frozen_{fid}", _loop_args(w) + extra,
                         [(f"{w}_identity", _DT_BOOL)], b.nodes,
                         {f"{w}_identity": f"{w}/Identity:output:0"})


def _body_fn(w: str, xs: str, fid: int) -> bytes:
    b = _Graph()
    a = [n for n, _ in _loop_args(w)]
    passthrough = [f"{w}_gatherv2_{xs}", f"{w}_matmul_readvariableop_resource",
                   f"{w}_matmul_1_readvariableop_resource",
                   f"{w}_add_1_readvariableop_resource"]
    xs_a, wk, wr, wb = [p + "_0" for p in passthrough]
    b.const(f"{w}/GatherV2/axis", np.int32(0))
    b.const(f"{w}/split/split_dim", np.int32(1))
    b.const(f"{w}/add_3/y", np.int32(1))
    b.const(f"{w}/add_4/y", np.int32(1))
    for scope, src in (("MatMul", wk), ("MatMul_1", wr), ("add_1", wb)):
        b.add(f"{w}/{scope}/ReadVariableOp", "Identity", [src], T=_T_FLOAT)
    b.add(f"{w}/GatherV2", "GatherV2",
          [xs_a, a[2], f"{w}/GatherV2/axis:output:0"], Taxis=_T_INT,
          Tindices=_T_INT, Tparams=_T_FLOAT, batch_dims=_attr_i(0))
    b.add(f"{w}/add_3", "AddV2", [a[2], f"{w}/add_3/y:output:0"], T=_T_INT)
    b.add(f"{w}/add_4", "AddV2", [a[0], f"{w}/add_4/y:output:0"], T=_T_INT)
    b.add(f"{w}/MatMul_1", "MatMul",
          [a[3], f"{w}/MatMul_1/ReadVariableOp:output:0"], **_MATMUL)
    b.add(f"{w}/NoOp", "NoOp", [f"^{w}/MatMul/ReadVariableOp",
                                f"^{w}/MatMul_1/ReadVariableOp",
                                f"^{w}/add_1/ReadVariableOp"])
    b.add(f"{w}/MatMul", "MatMul", [f"{w}/GatherV2:output:0",
                                    f"{w}/MatMul/ReadVariableOp:output:0"],
          **_MATMUL)
    dep = f"^{w}/NoOp"
    b.add(f"{w}/Identity", "Identity", [f"{w}/add_4:z:0", dep], T=_T_INT)
    b.add(f"{w}/Identity_1", "Identity", [a[1], dep], T=_T_INT)
    b.add(f"{w}/Identity_2", "Identity", [f"{w}/add_3:z:0", dep], T=_T_INT)
    b.add(f"{w}/add", "AddV2", [f"{w}/MatMul:product:0",
                                f"{w}/MatMul_1:product:0"], T=_T_FLOAT)
    b.add(f"{w}/add_1", "AddV2", [f"{w}/add:z:0",
                                  f"{w}/add_1/ReadVariableOp:output:0"],
          T=_T_FLOAT)
    b.add(f"{w}/split", "Split", [f"{w}/split/split_dim:output:0",
                                  f"{w}/add_1:z:0"], T=_T_FLOAT,
          num_split=_attr_i(4))
    b.add(f"{w}/Sigmoid", "Sigmoid", [f"{w}/split:output:1"], T=_T_FLOAT)
    b.add(f"{w}/Sigmoid_1", "Sigmoid", [f"{w}/split:output:0"], T=_T_FLOAT)
    b.add(f"{w}/Tanh", "Tanh", [f"{w}/split:output:3"], T=_T_FLOAT)
    b.add(f"{w}/Sigmoid_2", "Sigmoid", [f"{w}/split:output:2"], T=_T_FLOAT)
    b.add(f"{w}/mul", "Mul", [f"{w}/Sigmoid:y:0", a[4]], T=_T_FLOAT)
    b.add(f"{w}/mul_1", "Mul", [f"{w}/Sigmoid_1:y:0", f"{w}/Tanh:y:0"],
          T=_T_FLOAT)
    b.add(f"{w}/add_2", "AddV2", [f"{w}/mul:z:0", f"{w}/mul_1:z:0"],
          T=_T_FLOAT)
    b.add(f"{w}/Tanh_1", "Tanh", [f"{w}/add_2:z:0"], T=_T_FLOAT)
    b.add(f"{w}/Identity_4", "Identity", [f"{w}/add_2:z:0", dep],
          T=_T_FLOAT)
    b.add(f"{w}/mul_2", "Mul", [f"{w}/Sigmoid_2:y:0", f"{w}/Tanh_1:y:0"],
          T=_T_FLOAT)
    b.add(f"{w}/TensorArrayV2Write/TensorListSetItem", "TensorListSetItem",
          [a[5], a[2], f"{w}/mul_2:z:0"], element_dtype=_T_FLOAT,
          resize_if_index_out_of_bounds=_attr_b(False))
    b.add(f"{w}/Identity_3", "Identity", [f"{w}/mul_2:z:0", dep],
          T=_T_FLOAT)
    b.add(f"{w}/Identity_5", "Identity",
          [f"{w}/TensorArrayV2Write/TensorListSetItem:output_handle:0", dep],
          T=_attr_type(_DT_VARIANT))
    outs = [f"{w}_identity"] + [f"{w}_identity_{i}" for i in range(1, 6)]
    ret = {o: f"{w}/Identity{'' if i == 0 else f'_{i}'}:output:0"
           for i, o in enumerate(outs)}
    ret.update({p: p + "_0" for p in passthrough})
    in_args = _loop_args(w) + [(p + "_0", _DT_FLOAT) for p in passthrough]
    out_args = [(o, t) for o, t in zip(outs + passthrough, _LOOP_TYPES)]
    return _function_def(f"{w}_body_frozen_{fid}", in_args, out_args,
                         b.nodes, ret)


def _functional(w: dict, batch: int, time: int, vocab: int,
                hidden: int) -> bytes:
    g = _Graph()
    g.add("x", "Placeholder", dtype=_T_FLOAT,
          shape=_attr_shape((batch, time, vocab)))
    zeros = np.zeros((batch, hidden), np.float32)
    for s, ta in (("_1", "TensorArrayV2_2"), ("", "TensorArrayV2")):
        g.const(f"while{s}/loop_counter", np.int32(0))
        g.const(f"while{s}/maximum_iterations", np.int32(-1))
        g.const(f"Const{s}", np.int32(0))
        g.const(f"zeros{s}", zeros)
        g.const(f"{ta}/element_shape", np.int32(-1))
        g.const(f"{ta}/num_elements", np.int32(time))
    g.const("transpose/perm", np.asarray([1, 0, 2], np.int32))
    names = {**_FUNCTIONAL_NAMES, "out_w": "MatMul/ReadVariableOp/resource",
             "out_b": "BiasAdd/ReadVariableOp/resource"}
    for layer, (wn, stack, perms) in enumerate((
            ("while", "TensorArrayV2Stack", ("transpose_1", "transpose_2")),
            ("while_1", "TensorArrayV2Stack_1", ("transpose_3",)))):
        for key in ("w", "rw", "b"):
            g.const(names[f"l{layer}_{key}"], w[f"l{layer}_{key}"])
        g.const(f"{stack}/TensorListStack/element_shape",
                np.asarray([batch, hidden], np.int32))
        for p in perms:
            g.const(f"{p}/perm", np.asarray([1, 0, 2], np.int32))
    g.const("Reshape/shape", np.asarray([-1, hidden], np.int32))
    g.const(names["out_w"], w["out_w"])
    g.const(names["out_b"], w["out_b"])
    g.const("Reshape_1/shape", np.asarray([batch, time, vocab], np.int32))
    for ta in ("TensorArrayV2_2", "TensorArrayV2"):
        g.add(ta, "TensorListReserve",
              [f"{ta}/element_shape", f"{ta}/num_elements"],
              element_dtype=_T_FLOAT, shape_type=_T_INT)

    def transpose(name, x):
        return g.add(name, "Transpose", [x, f"{name}/perm"], T=_T_FLOAT,
                     Tperm=_T_INT)

    xs = transpose("transpose", "x")
    for layer, ((wn, _, cid, bid, _), (s, ta, stack)) in enumerate(zip(
            _LAYERS, (("", "TensorArrayV2", "TensorArrayV2Stack"),
                      ("_1", "TensorArrayV2_2", "TensorArrayV2Stack_1")))):
        shapes = [(), (), (), (batch, hidden), (batch, hidden), (),
                  (time, batch, vocab if layer == 0 else hidden),
                  w[f"l{layer}_w"].shape, (hidden, 4 * hidden),
                  (4 * hidden,)]
        g.add(wn, "While",
              [f"{wn}/loop_counter", f"{wn}/maximum_iterations", f"Const{s}",
               f"zeros{s}", f"zeros{s}", ta, xs, f"{wn}/input_7",
               f"{wn}/input_8", f"{wn}/input_9"],
              T=_attr_list(types=_LOOP_TYPES),
              _has_manual_control_dependencies=_attr_b(True),
              _lower_using_switch_merge=_attr_b(False),
              _num_original_outputs=_attr_i(10),
              _read_only_resource_inputs=_attr_list(ints=[7, 8, 9]),
              body=_attr_func(f"{wn}_body_frozen_{bid}"),
              cond=_attr_func(f"{wn}_cond_frozen_{cid}"),
              output_shapes=_attr_list(shapes=shapes),
              parallel_iterations=_attr_i(10))
        h = g.add(f"{stack}/TensorListStack", "TensorListStack",
                  [f"{wn}:5", f"{stack}/TensorListStack/element_shape"],
                  element_dtype=_T_FLOAT, num_elements=_attr_i(time))
        if wn == "while":
            xs = transpose("transpose_2", transpose("transpose_1", h))
        else:
            h = transpose("transpose_3", h)
    r = g.add("Reshape", "Reshape", [h, "Reshape/shape"], T=_T_FLOAT,
              Tshape=_T_INT)
    g.add("MatMul/ReadVariableOp", "Identity", [names["out_w"]], T=_T_FLOAT,
          _has_manual_control_dependencies=_attr_b(True))
    m = g.add("MatMul", "MatMul", [r, "MatMul/ReadVariableOp"], **_MATMUL)
    g.add("BiasAdd/ReadVariableOp", "Identity", [names["out_b"]],
          T=_T_FLOAT, _has_manual_control_dependencies=_attr_b(True))
    ba = g.add("BiasAdd", "BiasAdd", [m, "BiasAdd/ReadVariableOp"],
               T=_T_FLOAT, data_format=_attr_s(b"NHWC"))
    out = g.add("Reshape_1", "Reshape", [ba, "Reshape_1/shape"], T=_T_FLOAT,
                Tshape=_T_INT)
    g.add("NoOp", "NoOp", ["^BiasAdd/ReadVariableOp", "^MatMul/ReadVariableOp",
                           "^while", "^while_1"],
          _has_manual_control_dependencies=_attr_b(True))
    g.add("Identity", "Identity", [out, "^NoOp"], T=_T_FLOAT)
    library = b""
    for wn, xs_name, cid, bid, uid in _LAYERS:
        fns = [_body_fn(wn, xs_name, bid), _cond_fn(wn, cid, uid, time)]
        library += b"".join(_ld(1, f) for f in (fns if wn == "while"
                                                 else fns[::-1]))
    versions = _key(1, 0) + _varint(2474) + _key(2, 0) + _varint(12)
    return (b"".join(_ld(1, n) for n in g.nodes) + _ld(2, library)
            + _ld(4, versions))


# -- the v1 frame form -----------------------------------------------------------
def _v1_frame(g: _Graph, w: str, t0: str, zeros: str, ta: str, xs: str,
              keys: Sequence[str], stack: str, batch: int, time: int,
              hidden: int) -> str:
    """One ``tf.while_loop`` as v1 frames; returns the stacked list."""
    ctx = _attr_s(f"{w}/while_context".encode())

    def enter(name, src, dtype, constant):
        return g.add(name, "Enter", [src], T=_attr_type(dtype),
                     frame_name=ctx, is_constant=_attr_b(constant),
                     parallel_iterations=_attr_i(10))

    sfx = ["", "_1", "_2", "_3"]
    types = [_DT_INT32, _DT_FLOAT, _DT_FLOAT, _DT_VARIANT]
    for i, src in enumerate((t0, zeros, zeros, ta)):
        enter(f"{w}/Enter{sfx[i]}", src, types[i], False)
    for i in range(4):
        g.add(f"{w}/Merge{sfx[i]}", "Merge",
              [f"{w}/Enter{sfx[i]}", f"{w}/NextIteration{sfx[i]}"],
              N=_attr_i(2), T=_attr_type(types[i]))
    g.const(f"{w}/Less/y", np.int32(time), [f"^{w}/Merge"])
    g.add(f"{w}/Less", "Less", [f"{w}/Merge", f"{w}/Less/y"], T=_T_INT)
    g.add(f"{w}/LoopCond", "LoopCond", [f"{w}/Less"])
    for i in range(4):
        g.add(f"{w}/Switch{sfx[i]}", "Switch",
              [f"{w}/Merge{sfx[i]}", f"{w}/LoopCond"],
              T=_attr_type(types[i]),
              _class=_attr_list(strings=[f"loc:@{w}/Merge{sfx[i]}".encode()]))
    for i in range(4):
        g.add(f"{w}/Identity{sfx[i]}", "Identity", [f"{w}/Switch{sfx[i]}:1"],
              T=_attr_type(types[i]))
    dep = f"^{w}/Identity"
    g.const(f"{w}/GatherV2/axis", np.int32(0), [dep])
    g.add(f"{w}/GatherV2", "GatherV2",
          [f"{w}/GatherV2/Enter", f"{w}/Identity", f"{w}/GatherV2/axis"],
          Taxis=_T_INT, Tindices=_T_INT, Tparams=_T_FLOAT,
          batch_dims=_attr_i(0))
    enter(f"{w}/GatherV2/Enter", xs, _DT_FLOAT, True)

    def read(scope, key):
        g.add(f"{w}/{scope}/ReadVariableOp", "Identity",
              [f"{w}/{scope}/ReadVariableOp/Enter"], T=_T_FLOAT)
        enter(f"{w}/{scope}/ReadVariableOp/Enter", key, _DT_FLOAT, True)
        return f"{w}/{scope}/ReadVariableOp"

    g.add(f"{w}/MatMul", "MatMul", [f"{w}/GatherV2", read("MatMul", keys[0])],
          **_MATMUL)
    g.add(f"{w}/MatMul_1", "MatMul",
          [f"{w}/Identity_1", read("MatMul_1", keys[1])], **_MATMUL)
    g.add(f"{w}/add", "AddV2", [f"{w}/MatMul", f"{w}/MatMul_1"], T=_T_FLOAT)
    g.add(f"{w}/add_1", "AddV2", [f"{w}/add", read("add_1", keys[2])],
          T=_T_FLOAT)
    g.const(f"{w}/split/split_dim", np.int32(1), [dep])
    g.add(f"{w}/split", "Split", [f"{w}/split/split_dim", f"{w}/add_1"],
          T=_T_FLOAT, num_split=_attr_i(4))
    g.add(f"{w}/Sigmoid", "Sigmoid", [f"{w}/split:1"], T=_T_FLOAT)
    g.add(f"{w}/mul", "Mul", [f"{w}/Sigmoid", f"{w}/Identity_2"], T=_T_FLOAT)
    g.add(f"{w}/Sigmoid_1", "Sigmoid", [f"{w}/split"], T=_T_FLOAT)
    g.add(f"{w}/Tanh", "Tanh", [f"{w}/split:3"], T=_T_FLOAT)
    g.add(f"{w}/mul_1", "Mul", [f"{w}/Sigmoid_1", f"{w}/Tanh"], T=_T_FLOAT)
    g.add(f"{w}/add_2", "AddV2", [f"{w}/mul", f"{w}/mul_1"], T=_T_FLOAT)
    g.add(f"{w}/Sigmoid_2", "Sigmoid", [f"{w}/split:2"], T=_T_FLOAT)
    g.add(f"{w}/Tanh_1", "Tanh", [f"{w}/add_2"], T=_T_FLOAT)
    g.add(f"{w}/mul_2", "Mul", [f"{w}/Sigmoid_2", f"{w}/Tanh_1"], T=_T_FLOAT)
    g.const(f"{w}/add_3/y", np.int32(1), [dep])
    g.add(f"{w}/add_3", "AddV2", [f"{w}/Identity", f"{w}/add_3/y"], T=_T_INT)
    setitem = g.add(f"{w}/TensorArrayV2Write/TensorListSetItem",
                    "TensorListSetItem",
                    [f"{w}/Identity_3", f"{w}/Identity", f"{w}/mul_2"],
                    element_dtype=_T_FLOAT,
                    resize_if_index_out_of_bounds=_attr_b(False))
    for i, src in enumerate((f"{w}/add_3", f"{w}/mul_2", f"{w}/add_2",
                             setitem)):
        g.add(f"{w}/NextIteration{sfx[i]}", "NextIteration", [src],
              T=_attr_type(types[i]))
    g.add(f"{w}/Exit_3", "Exit", [f"{w}/Switch_3"],
          T=_attr_type(_DT_VARIANT))
    g.const(f"{stack}/TensorListStack/element_shape",
            np.asarray([batch, hidden], np.int32))
    return g.add(f"{stack}/TensorListStack", "TensorListStack",
                 [f"{w}/Exit_3", f"{stack}/TensorListStack/element_shape"],
                 element_dtype=_T_FLOAT, num_elements=_attr_i(time))


def _v1(w: dict, batch: int, time: int, vocab: int, hidden: int) -> bytes:
    g = _Graph()
    g.add("x", "Placeholder", dtype=_T_FLOAT,
          shape=_attr_shape((batch, time, vocab)))
    for k in WEIGHT_KEYS:
        g.const(k, w[k])
    for ta in ("TensorArrayV2", "TensorArrayV2_1"):
        g.const(f"{ta}/element_shape", np.int32(-1))
        g.const(f"{ta}/num_elements", np.int32(time))
        g.add(ta, "TensorListReserve",
              [f"{ta}/element_shape", f"{ta}/num_elements"],
              element_dtype=_T_FLOAT, shape_type=_T_INT)

    def transpose(name, x):
        g.const(f"{name}/perm", np.asarray([1, 0, 2], np.int32))
        return g.add(name, "Transpose", [x, f"{name}/perm"], T=_T_FLOAT,
                     Tperm=_T_INT)

    xs = transpose("transpose", "x")
    zeros = np.zeros((batch, hidden), np.float32)
    for layer, (wn, s, ta, stack) in enumerate((
            ("while", "", "TensorArrayV2", "TensorArrayV2Stack"),
            ("while_1", "_1", "TensorArrayV2_1", "TensorArrayV2Stack_1"))):
        g.const(f"zeros{s}", zeros)
        g.const(f"Const{s}", np.int32(0))
        h = _v1_frame(g, wn, f"Const{s}", f"zeros{s}", ta, xs,
                      [f"l{layer}_w", f"l{layer}_rw", f"l{layer}_b"], stack,
                      batch, time, hidden)
        if layer == 0:
            xs = transpose("transpose_2", transpose("transpose_1", h))
        else:
            h = transpose("transpose_3", h)
    g.const("Reshape/shape", np.asarray([-1, hidden], np.int32))
    r = g.add("Reshape", "Reshape", [h, "Reshape/shape"], T=_T_FLOAT,
              Tshape=_T_INT)
    g.add("MatMul/ReadVariableOp", "Identity", ["out_w"], T=_T_FLOAT)
    m = g.add("MatMul", "MatMul", [r, "MatMul/ReadVariableOp"], **_MATMUL)
    g.add("BiasAdd/ReadVariableOp", "Identity", ["out_b"], T=_T_FLOAT)
    ba = g.add("BiasAdd", "BiasAdd", [m, "BiasAdd/ReadVariableOp"],
               T=_T_FLOAT, data_format=_attr_s(b"NHWC"))
    g.const("Reshape_1/shape", np.asarray([batch, time, vocab], np.int32))
    out = g.add("Reshape_1", "Reshape", [ba, "Reshape_1/shape"], T=_T_FLOAT,
                Tshape=_T_INT)
    g.add("Identity", "Identity", [out], T=_T_FLOAT)
    return g.serialize()


def build_lstm_graph(batch: int, time: int, vocab: int, hidden: int, *,
                     seed: int = 0, form: str = "functional") -> bytes:
    """The serialized frozen GraphDef of ``lstm_lm`` at these sizes with
    :func:`lstm_weights` ``(vocab, hidden, seed)``: input ``x`` float32
    ``[batch, time, vocab]``, output ``Identity`` ``[batch, time,
    vocab]`` (logits). ``form`` is ``"functional"`` or ``"v1"``."""
    weight_names(form)                                 # validates form
    w = lstm_weights(vocab, hidden, seed)
    build = _functional if form == "functional" else _v1
    return build(w, batch, time, vocab, hidden)


def import_and_attach_loss(gd_bytes, batch: int, time: int, vocab: int, *,
                           updater=None, while_max_iterations=None,
                           device=None) -> Tuple[object, str]:
    """Import ``lstm_lm``'s GraphDef (either form, the writer's or
    TensorFlow's) onto ``device`` (``None``: the card), promote its
    frozen weights to trainable variables and attach the mean softmax
    cross-entropy of the logits against the placeholder ``labels``
    (one-hot float32 ``[batch, time, vocab]``). Returns ``(sd,
    "loss")``; with ``updater``, a training config feeding ``x`` and
    ``labels`` is set. Training needs ``while_max_iterations``."""
    from deeplearning4j_tpu_torch.modelimport.tensorflow import \
        TensorflowFrameworkImporter
    sd = TensorflowFrameworkImporter.run_import(
        gd_bytes, {"x": (batch, time, vocab)},
        while_max_iterations=while_max_iterations, device=device)
    names = sorted({n for form in ("functional", "v1")
                    for n in weight_names(form).values() if n in sd.vars})
    if len(names) != len(WEIGHT_KEYS):
        raise RuntimeError(f"expected the {len(WEIGHT_KEYS)} frozen "
                           f"weights of lstm_lm, found {names}")
    sd.convert_to_variables(names)
    labels = sd.placeholder("labels", shape=(batch, time, vocab))
    sd._op("softmax_cross_entropy", [labels, sd.vars["Identity"]],
           name="loss")
    sd.set_loss_variables(["loss"])
    if updater is not None:
        from deeplearning4j_tpu_torch.autodiff.training import TrainingConfig
        sd.set_training_config(
            TrainingConfig.Builder().updater(updater)
            .data_set_feature_mapping("x")
            .data_set_label_mapping("labels").build())
    return sd, "loss"
