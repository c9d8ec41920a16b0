"""TF control-flow import in the port against the JAX package's, and the
TF-free LSTM GraphDef writer (``modelimport/tensorflow/lstm_graph.py``)
against TensorFlow, on the CPU (skipped where TensorFlow is not
installed).

- The graphs of the JAX package's ``tests/test_tf_import_while.py``,
  ``test_tf_import_v1_control_flow.py`` and
  ``test_tf_import_tensorlist.py``, built with TensorFlow at test time
  and imported by both packages: the same outputs (rtol 2e-5 / atol
  1e-6, and TensorFlow's own), the same gradients under
  ``while_max_iterations`` (rtol 2e-4, and TensorFlow's tape's), the
  same refusals (unbounded gradients, unmapped ops in bodies,
  dynamic-size lists, and ``_Irreducible`` frames with the same
  message).
- ``lstm_graph`` at H = 16, vocab 11, batch 2 x 5: in both forms the
  writer's GraphDef equals TensorFlow's export of ``lstm_lm`` node for
  node (names, op types, inputs, Const values; and the library
  functions' nodes, argument and output types and ``ret``), so the op
  type multisets are equal too; both bytes import, in both packages, to
  TensorFlow's logits; the v1 form imports to the functional form's op
  list (apart from its two Exit identities) and the same logits bit for
  bit; the logits equal two ``lstm_layer`` ops and the head; 3 Adam
  steps through ``import_and_attach_loss`` match the JAX package's loss
  (rtol 2e-4) and gradients (rtol 2e-4 / atol 1e-6).
"""
import collections

import numpy as np
import pytest
import torch
from torch_parity import one_intraop_thread  # noqa: F401,E402

tf = pytest.importorskip("tensorflow")

from deeplearning4j_tpu.autodiff.training import \
    TrainingConfig as JTrainingConfig  # noqa: E402
from deeplearning4j_tpu.learning.updaters import Adam as JAdam  # noqa: E402
from deeplearning4j_tpu.modelimport.tensorflow import \
    TensorflowFrameworkImporter as JImporter  # noqa: E402
from deeplearning4j_tpu_torch.autodiff import SameDiff  # noqa: E402
from deeplearning4j_tpu_torch.learning.updaters import Adam  # noqa: E402
from deeplearning4j_tpu_torch.modelimport.tensorflow import (  # noqa: E402
    TensorflowFrameworkImporter)
from deeplearning4j_tpu_torch.modelimport.tensorflow import \
    lstm_graph  # noqa: E402

FWD = dict(rtol=2e-5, atol=1e-6)
GRAD = dict(rtol=2e-4, atol=1e-6)
B, T, V, H = 2, 5, 11, 16


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _import(gd, shapes, **kw):
    """The port's and the JAX package's imports of one GraphDef."""
    return (TensorflowFrameworkImporter.run_import(gd, shapes, device="cpu",
                                                   **kw),
            JImporter.run_import(gd, shapes, **kw))


def _agree(p, j, feed, outs, want=None, **tol):
    tol = tol or FWD
    pr, jr = p.output(feed, outs), j.output(feed, outs)
    for k, o in enumerate(outs):
        np.testing.assert_allclose(_np(pr[o]), np.asarray(jr[o]), **tol,
                                   err_msg=o)
        if want is not None:
            np.testing.assert_allclose(_np(pr[o]), want[k], **tol,
                                       err_msg=o)


def _out(sd):
    return sorted(n for n in sd.vars if n.startswith("Identity"))[0]


# -- TF2 functional While / If (test_tf_import_while.py) -----------------------
def _freeze(fn, *specs):
    cf = tf.function(fn).get_concrete_function(*specs)
    return cf.graph.as_graph_def().SerializeToString(), cf


def _doubling(x):
    return tf.while_loop(lambda v: tf.reduce_sum(v) < 100.0,
                         lambda v: (v * 2.0,), (x,))[0]


def _multi_var(x):
    return tf.while_loop(lambda i, acc: i < 5,
                         lambda i, acc: (i + 1, acc + tf.cast(
                             i, tf.float32) * x),
                         (tf.constant(0), x * 0.0))[1]


def _if(x):
    return tf.cond(tf.reduce_sum(x) > 0.0, lambda: x * 2.0,
                   lambda: x - 1.0)


def _topk_in_branch(x):
    return tf.cond(tf.reduce_sum(x) > 0.0,
                   lambda: tf.cast(tf.math.top_k(x, k=2).indices,
                                   tf.float32),
                   lambda: tf.zeros((2,)))


def _zero_operand(x):
    return tf.cond(tf.reduce_sum(x) > 0.0, lambda: tf.constant([1.0, 2.0]),
                   lambda: tf.constant([3.0, 4.0]))


def _ta(size, fn, start=0, first=None):
    """A TensorArray loop writing ``fn(i)`` for i in [start, size)."""
    def f(x):
        ta0 = tf.TensorArray(tf.float32, size=size,
                             clear_after_read=first is None)
        if first is not None:
            ta0 = ta0.write(0, first(x))
        _, ta = tf.while_loop(lambda i, ta: i < size,
                              lambda i, ta: (i + 1, ta.write(i, fn(x, i,
                                                                   ta))),
                              (tf.constant(start), ta0))
        return ta.stack()
    return f


#: name -> (function, input shape, inputs)
FUNCTIONAL = {
    "stateless_while_forward": (_doubling, (4,), [np.ones(4, np.float32)]),
    "while_multi_var": (_multi_var, (3,), [np.float32([1, 2, 3])]),
    "stateless_if_both_branches": (
        _if, (3,), [np.float32([1, 2, 3]), np.float32([-1, -2, -3])]),
    "multi_output_port_in_branch": (
        _topk_in_branch, (4,), [np.float32([0.5, 5.0, 1.0, 3.0])]),
    "zero_operand_branches": (
        _zero_operand, (3,), [np.float32([1, 1, 1]),
                              np.float32([-1, -1, -1])]),
    "tensorlist_scalar": (
        _ta(3, lambda x, i, ta: tf.reduce_sum(x) * tf.cast(i, tf.float32)),
        (2,), [np.float32([1.5, 2.5])]),
    "tensorlist_vector": (
        _ta(4, lambda x, i, ta: x * tf.cast(i, tf.float32)), (3,),
        [np.float32([1.0, -2.0, 0.5])]),
    "tensorlist_read_back": (
        _ta(4, lambda x, i, ta: ta.read(i - 1) * 2.0, start=1,
            first=tf.reduce_sum), (2,), [np.float32([0.5, 1.0])]),
}


@pytest.mark.parametrize("bound", [None, 16])
@pytest.mark.parametrize("name", sorted(FUNCTIONAL))
def test_functional_graph_imports_as_in_jax(name, bound):
    fn, shape, inputs = FUNCTIONAL[name]
    gd, frozen = _freeze(fn, tf.TensorSpec(shape, tf.float32))
    p, j = _import(gd, {"x": shape}, while_max_iterations=bound)
    for xv in inputs:
        want = np.asarray(frozen(tf.constant(xv)))
        _agree(p, j, {"x": xv}, [_out(p)], [want])


def _gradient_case(loop_fn, shape, w0, xv, bound):
    """Loss and gradient of a loop graph in both packages and TF."""
    with tf.GradientTape() as tape:
        wt = tf.Variable(w0)
        loss = loop_fn(wt, tf.constant(xv))
    want_grad = np.asarray(tape.gradient(loss, wt))
    gd, frozen = _freeze(loop_fn, tf.TensorSpec(shape, tf.float32),
                         tf.TensorSpec(shape, tf.float32))
    want = float(frozen(tf.constant(w0), tf.constant(xv)))
    sds = _import(gd, {"w": shape, "x": shape}, while_max_iterations=bound)
    got = []
    for sd in sds:
        out = _out(sd)
        assert float(_np(sd.output({"w": w0, "x": xv}, [out])[out])) == \
            pytest.approx(want, rel=1e-5)
        sd.convert_to_variables(["w"], {"w": w0})
        sd.set_loss_variables([out])
        got.append(_np(sd.calculate_gradients({"x": xv}, ["w"])["w"]))
    np.testing.assert_allclose(got[0], got[1], **GRAD)
    np.testing.assert_allclose(got[0], want_grad, rtol=1e-5)


def test_trainable_loop_gradient_matches_tf():
    def loop_fn(w, x):
        return tf.reduce_sum(_doubling(w * x))

    _gradient_case(loop_fn, (4,), np.float32([1.1, 0.9, 1.3, 0.7]),
                   np.float32([1.0, 2.0, 0.5, 1.5]), 16)


def test_gradient_through_tensorlist_accumulator():
    def loop_fn(w, x):
        ta0 = tf.TensorArray(tf.float32, size=3)
        _, ta = tf.while_loop(
            lambda i, ta: i < 3,
            lambda i, ta: (i + 1, ta.write(i, tf.reduce_sum(w * x) ** tf.cast(
                i + 1, tf.float32))), (tf.constant(0), ta0))
        return tf.reduce_sum(ta.stack())

    _gradient_case(loop_fn, (2,), np.float32([1.2, 0.8]),
                   np.float32([1.0, 1.0]), 8)


def test_unbounded_import_gradient_raises_in_both():
    def f(w, x):
        return tf.reduce_sum(_doubling(w * x))

    gd, _ = _freeze(f, tf.TensorSpec((4,), tf.float32),
                    tf.TensorSpec((4,), tf.float32))
    msgs = []
    for sd in _import(gd, {"w": (4,), "x": (4,)}):
        out = _out(sd)
        sd.convert_to_variables(["w"], {"w": np.float32([1.1, 0.9, 1.3,
                                                         0.7])})
        sd.set_loss_variables([out])
        with pytest.raises(NotImplementedError, match="max_iterations") as e:
            sd.calculate_gradients({"x": np.float32([1, 2, 0.5, 1.5])},
                                   ["w"])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def _svd_in_body(x):
    def body(i, acc):
        s = tf.linalg.svd(tf.reshape(acc, (2, 2)), compute_uv=False)
        return i + 1, acc + tf.reduce_sum(s)

    return tf.while_loop(lambda i, acc: i < 3, body, (tf.constant(0), x))[1]


def _dynamic_list(x):
    ta0 = tf.TensorArray(tf.float32, size=0, dynamic_size=True)
    _, ta = tf.while_loop(lambda i, ta: i < 3,
                          lambda i, ta: (i + 1, ta.write(
                              i, x[0] * tf.cast(i, tf.float32))),
                          (tf.constant(0), ta0))
    return ta.stack()


@pytest.mark.parametrize("fn,shape,match", [
    (_svd_in_body, (4,), "no mapping"),
    (_dynamic_list, (2,), "TensorList|no mapping")],
    ids=["unmapped_op_in_body", "dynamic_size_list"])
def test_refusals_match_jax(fn, shape, match):
    gd, _ = _freeze(fn, tf.TensorSpec(shape, tf.float32))
    msgs = []
    for imp in (lambda: TensorflowFrameworkImporter.run_import(
                    gd, {"x": shape}, device="cpu"),
                lambda: JImporter.run_import(gd, {"x": shape})):
        with pytest.raises(NotImplementedError, match=match) as e:
            imp()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# -- v1 frames (test_tf_import_v1_control_flow.py) -------------------------------
def _freeze_v1(build_fn, outputs, feed=None, also_eval=()):
    g = tf.Graph()
    with g.as_default():
        tf.compat.v1.disable_control_flow_v2()
        try:
            build_fn()
            with tf.compat.v1.Session() as sess:
                sess.run(tf.compat.v1.global_variables_initializer())
                gd = tf.compat.v1.graph_util.convert_variables_to_constants(
                    sess, g.as_graph_def(), outputs)
                want = sess.run([f"{o}:0" for o in list(outputs)
                                 + list(also_eval)], feed or {})
        finally:
            tf.compat.v1.enable_control_flow_v2()
    assert any(n.op in ("Enter", "Switch") for n in gd.node)
    return gd.SerializeToString(), want


def _ph(shape=()):
    return tf.compat.v1.placeholder(tf.float32, shape, name="x")


def v1_while_forward():
    x = _ph([4])
    w = tf.compat.v1.get_variable(
        "w", initializer=np.float32([1.1, 0.9, 1.3, 0.7]))
    _, vf = tf.compat.v1.while_loop(
        lambda i, v: tf.logical_and(i < 8, tf.reduce_sum(v) < 100.0),
        lambda i, v: (i + 1, v * 2.0 + w * 0.1), (tf.constant(0), w * x),
        name="loop")
    tf.reduce_sum(vf, name="out")


def v1_cond_in_loop_cond():
    x = _ph()

    def cond(i, acc):
        return tf.compat.v1.cond(i < 2, lambda: acc < 50.0,
                                 lambda: acc < 20.0, name="ccond")

    _, accf = tf.compat.v1.while_loop(
        cond, lambda i, acc: (i + 1, acc + x),
        (tf.constant(0), tf.constant(1.0, tf.float32)), name="loop")
    tf.identity(accf, name="out")


def v1_nested_while():
    x = _ph()

    def outer_body(i, acc):
        _, a = tf.compat.v1.while_loop(
            lambda j, a: j < 3, lambda j, a: (j + 1, a + x),
            (tf.constant(0), acc), name="inner")
        return i + 1, a * 1.5

    _, accf = tf.compat.v1.while_loop(
        lambda i, acc: i < 2, outer_body,
        (tf.constant(0), tf.constant(1.0, tf.float32)), name="outer")
    tf.identity(accf, name="out")


def v1_cond():
    x = _ph([3])
    y = tf.compat.v1.cond(tf.reduce_sum(x) > 0.0, lambda: x * 2.0 + 1.0,
                          lambda: x - 1.0, name="br")
    tf.identity(y, name="out")


def v1_cond_multi_output():
    x = _ph([3])
    a, b = tf.compat.v1.cond(tf.reduce_sum(x) > 0.0,
                             lambda: (x * 2.0, x + 10.0),
                             lambda: (x - 1.0, x * 0.5), name="br")
    tf.identity(a, name="out")
    tf.identity(b, name="outb")


def v1_chained_conds():
    x = _ph([3])
    pred = tf.reduce_sum(x) > 0.0
    y = tf.compat.v1.cond(pred, lambda: x * 2.0, lambda: x - 1.0, name="c0")
    z = tf.compat.v1.cond(pred, lambda: y + 1.0, lambda: y * 3.0, name="c1")
    tf.identity(z, name="out")


def v1_constant_branches():
    x = _ph([3])
    s = tf.compat.v1.cond(tf.reduce_sum(x) > 0.0, lambda: tf.constant(2.5),
                          lambda: tf.constant(0.5), name="br")
    tf.identity(x * s, name="out")


def v1_const_cond_in_while_body():
    x = _ph()

    def body(i, acc):
        s = tf.compat.v1.cond(acc > 20.0, lambda: tf.constant(0.5),
                              lambda: tf.constant(2.0), name="br")
        return i + 1, acc * s + x * 0.0

    _, accf = tf.compat.v1.while_loop(
        lambda i, acc: i < 5, body,
        (tf.constant(0), tf.constant(1.0, tf.float32)), name="loop")
    tf.identity(accf, name="out")


def v1_cond_in_while_body():
    x = _ph()

    def body(i, acc):
        return i + 1, tf.compat.v1.cond(acc > 20.0, lambda: acc * 0.5,
                                        lambda: acc + x, name="br")

    _, accf = tf.compat.v1.while_loop(
        lambda i, acc: i < 5, body,
        (tf.constant(0), tf.constant(1.0, tf.float32)), name="loop")
    tf.identity(accf, name="out")


_SIGNED3 = [np.float32([1, 2, 3]), np.float32([-1, -2, -3])]
#: name -> (graph builder, x's shape, x values, outputs)
V1 = {"while_forward": (v1_while_forward, (4,),
                        [np.float32([1.0, 2.0, 0.5, 1.5])], ["out"]),
      "while_with_cond_in_loop_cond": (v1_cond_in_loop_cond, (),
                                       [np.float32(3.0)], ["out"]),
      "nested_while": (v1_nested_while, (), [np.float32(1.5)], ["out"]),
      "cond_both_branches": (v1_cond, (3,), _SIGNED3, ["out"]),
      "cond_multi_output": (v1_cond_multi_output, (3,), _SIGNED3,
                            ["out", "outb"]),
      "chained_conds_shared_pred": (v1_chained_conds, (3,), _SIGNED3,
                                    ["out"]),
      "cond_constant_branches": (v1_constant_branches, (3,), _SIGNED3,
                                 ["out"]),
      "const_only_cond_inside_while_body": (v1_const_cond_in_while_body,
                                            (), [np.float32(4.0)], ["out"]),
      "cond_inside_while_body": (v1_cond_in_while_body, (),
                                 [np.float32(7.0)], ["out"])}


@pytest.mark.parametrize("name", sorted(V1))
def test_v1_graph_imports_as_in_jax(name):
    build, shape, inputs, outs = V1[name]
    for xv in inputs:
        gd, want = _freeze_v1(build, outs, {"x:0": xv})
        p, j = _import(gd, {"x": shape})
        _agree(p, j, {"x": xv}, outs, want, rtol=1e-5, atol=1e-6)


def test_v1_while_gradient_by_loop_name_matches_tf():
    """The dict form of ``while_max_iterations``, keyed by the TF loop
    name, bounds the deframed loop; gradients as the JAX package's and
    ``tf.gradients``'."""
    xv = np.float32([1.0, 2.0, 0.5, 1.5])
    w0 = np.float32([1.1, 0.9, 1.3, 0.7])

    def build():
        x = _ph([4])
        w = tf.compat.v1.placeholder(tf.float32, [4], name="w")
        vf = tf.compat.v1.while_loop(lambda v: tf.reduce_sum(v) < 100.0,
                                     lambda v: v * 2.0, [w * x], name="loop")
        out = tf.reduce_sum(vf, name="out")
        tf.identity(tf.gradients(out, w)[0], name="gw")

    gd, (want_loss, want_grad) = _freeze_v1(
        build, ["out"], {"x:0": xv, "w:0": w0}, also_eval=["gw"])
    grads = []
    for sd in _import(gd, {"x": (4,), "w": (4,)},
                      while_max_iterations={"loop": 16}):
        assert float(_np(sd.output({"x": xv, "w": w0}, ["out"])["out"])) \
            == pytest.approx(float(want_loss), rel=1e-5)
        sd.convert_to_variables(["w"], {"w": w0})
        sd.set_loss_variables(["out"])
        grads.append(_np(sd.calculate_gradients({"x": xv}, ["w"])["w"]))
    np.testing.assert_allclose(grads[0], grads[1], **GRAD)
    np.testing.assert_allclose(grads[0], want_grad, rtol=1e-5)


def test_fetch_intermediate_through_v1_import():
    xv = np.float32([1.0, 2.0])

    def build():
        x = _ph([2])
        pre = tf.multiply(x, 2.0, name="pre")
        _, vf = tf.compat.v1.while_loop(
            lambda i, v: i < 3, lambda i, v: (i + 1, v + pre),
            (tf.constant(0), x), name="loop")
        tf.identity(vf, name="out")

    gd, want = _freeze_v1(build, ["out"], {"x:0": xv}, also_eval=("pre",))
    p, j = _import(gd, {"x": (2,)}, outputs=["out", "pre"])
    _agree(p, j, {"x": xv}, ["out", "pre"], want, rtol=1e-5, atol=1e-6)


def test_deframe_units_match_jax():
    """The JAX package's two deframe unit cases on the port's
    ``v1_control_flow``: an outer control dependency stays outside the
    frame, and the dead-node sweep keeps a requested output."""
    from deeplearning4j_tpu_torch.modelimport.tensorflow import \
        v1_control_flow as v1
    from deeplearning4j_tpu_torch.modelimport.tensorflow.protobuf import (
        Attr, NodeDef)

    def nd(name, op, inputs):
        return NodeDef(name, op, list(inputs), {})

    frame = Attr("s", b"loop/ctx")
    nodes = [nd("x", "Placeholder", []), nd("ext", "Identity", ["x"]),
             nd("out2", "Identity", ["ext"]), nd("i0", "Const", []),
             nd("limit", "Const", []),
             NodeDef("loop/Enter", "Enter", ["i0"], {"frame_name": frame}),
             nd("loop/Merge", "Merge", ["loop/Enter", "loop/Next"]),
             nd("loop/Less", "Less", ["loop/Merge", "limit"]),
             nd("loop/LoopCond", "LoopCond", ["loop/Less"]),
             nd("loop/Switch", "Switch", ["loop/Merge", "loop/LoopCond"]),
             nd("loop/Identity", "Identity", ["loop/Switch:1"]),
             nd("loop/one", "Const", []),
             nd("loop/add", "Add", ["loop/Identity", "loop/one", "^ext"]),
             nd("loop/Next", "NextIteration", ["loop/add"]),
             nd("loop/Exit", "Exit", ["loop/Switch"]),
             nd("out", "Identity", ["loop/Exit"])]
    out = v1.deframe(nodes, {})
    assert {"x", "ext", "out2", "out"} <= {n.name for n in out}
    assert not any(n.op in v1.V1_CONTROL_FLOW_OPS for n in out)

    original = [nd("x", "Placeholder", []), nd("pre", "Mul", ["x", "x"]),
                nd("ent", "Enter", ["pre"])]

    def swept(**kw):
        return {n.name for n in v1._check_no_dangling(
            [nd("x", "Placeholder", []), nd("pre", "Mul", ["x", "x"])],
            {"ent"}, original, **kw)}

    assert "pre" not in swept()
    assert "pre" in swept(keep={"pre"})


def _irreducible_graphs():
    """GraphDefs whose v1 frames ``deframe`` cannot rebuild."""
    lg = lstm_graph

    def graph(build):
        g = lg._Graph()
        g.add("x", "Placeholder", dtype=lg._T_FLOAT, shape=lg._attr_shape(()))
        build(g)
        return g.serialize()

    def enter(g, name, src):
        g.add(name, "Enter", [src], T=lg._T_FLOAT,
              frame_name=lg._attr_s(b"loop/ctx"),
              is_constant=lg._attr_b(False))

    def no_loopcond(g):               # a frame without Merge / LoopCond
        enter(g, "loop/Enter", "x")
        g.add("loop/Exit", "Exit", ["loop/Enter"], T=lg._T_FLOAT)
        g.add("out", "Identity", ["loop/Exit"], T=lg._T_FLOAT)

    def merge_without_switch(g):      # a cond Merge fed by no Switch
        g.const("a", np.float32(1.0))
        g.add("m", "Merge", ["x", "a"], T=lg._T_FLOAT, N=lg._attr_i(2))
        g.add("out", "Identity", ["m"], T=lg._T_FLOAT)

    return {"frame_without_loopcond": graph(no_loopcond),
            "merge_without_switch": graph(merge_without_switch)}


@pytest.mark.parametrize("name", ["frame_without_loopcond",
                                  "merge_without_switch"])
def test_irreducible_frames_refused_as_in_jax(name):
    gd = _irreducible_graphs()[name]
    msgs = []
    for imp in (lambda: TensorflowFrameworkImporter.run_import(
                    gd, {"x": ()}, device="cpu"),
                lambda: JImporter.run_import(gd, {"x": ()})):
        with pytest.raises(NotImplementedError,
                           match="legacy v1 control flow") as e:
            imp()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# -- the LSTM writer (lstm_graph.py) ---------------------------------------------
def lstm_lm(x, w, batch, time, vocab, hidden, tensor_arrays=None):
    """``lstm_graph``'s documented function, as its docstring gives it."""
    h = x
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
    y = tf.nn.bias_add(tf.matmul(tf.reshape(h, (-1, hidden)), w["out_w"]),
                       w["out_b"])
    return tf.reshape(y, (batch, time, vocab))


@pytest.fixture(scope="module")
def tf_exports():
    """TensorFlow's exports of ``lstm_lm`` in both forms, and its logits
    on a seeded one-hot batch."""
    from tensorflow.python.framework.convert_to_constants import \
        convert_variables_to_constants_v2
    vals = lstm_graph.lstm_weights(V, H, seed=0)
    w = {k: tf.Variable(v) for k, v in vals.items()}
    f = tf.function(lambda x: lstm_lm(x, w, B, T, V, H))
    cf = f.get_concrete_function(tf.TensorSpec((B, T, V), tf.float32,
                                               name="x"))
    functional = convert_variables_to_constants_v2(
        cf, lower_control_flow=False).graph.as_graph_def()
    g = tf.Graph()
    with g.as_default():
        x = tf.compat.v1.placeholder(tf.float32, (B, T, V), name="x")
        wv = {k: tf.compat.v1.Variable(v, name=k) for k, v in vals.items()}
        # made before v1 control flow is switched on: TensorLists
        tas = [tf.TensorArray(tf.float32, size=T) for _ in range(2)]
        tf.compat.v1.disable_control_flow_v2()
        try:
            tf.identity(lstm_lm(x, wv, B, T, V, H, tas), name="Identity")
        finally:
            tf.compat.v1.enable_control_flow_v2()
        with tf.compat.v1.Session() as s:
            s.run(tf.compat.v1.global_variables_initializer())
            v1 = tf.compat.v1.graph_util.convert_variables_to_constants(
                s, g.as_graph_def(), ["Identity"])
    xv = _one_hot(np.random.RandomState(1), (B, T))
    logits = np.asarray(f(tf.constant(xv)))
    return {"functional": functional, "v1": v1, "x": xv, "logits": logits}


def _one_hot(rs, shape):
    return np.eye(V, dtype=np.float32)[rs.randint(0, V, shape)]


def _nodes(nodes):
    return [(n.name, n.op, list(n.input)) for n in nodes]


@pytest.mark.parametrize("form", ["functional", "v1"])
def test_writer_equals_tf_export(tf_exports, form):
    ref = tf_exports[form]
    got = tf.compat.v1.GraphDef.FromString(
        lstm_graph.build_lstm_graph(B, T, V, H, form=form))
    assert _nodes(got.node) == _nodes(ref.node)
    for a, b in zip(got.node, ref.node):
        if a.op == "Const":
            np.testing.assert_array_equal(tf.make_ndarray(a.attr["value"]
                                                          .tensor),
                                          tf.make_ndarray(b.attr["value"]
                                                          .tensor))
    fa, fb = got.library.function, ref.library.function
    assert len(fa) == len(fb) == (4 if form == "functional" else 0)

    def by_loop(graph):
        """Each While's cond and body, in node order (the library's own
        order is not stable across TensorFlow processes)."""
        fns = {f.signature.name: f for f in graph.library.function}
        return [fns[n.attr[k].func.name] for n in graph.node
                if n.op == "While" for k in ("cond", "body")]

    for a, b in zip(by_loop(got), by_loop(ref)):
        assert _nodes(a.node_def) == _nodes(b.node_def)
        assert [x.type for x in a.signature.input_arg] == \
            [x.type for x in b.signature.input_arg]
        assert [x.type for x in a.signature.output_arg] == \
            [x.type for x in b.signature.output_arg]
        assert dict(a.ret) == dict(b.ret)
    ops = collections.Counter(n.op for n in got.node)
    ops.update(n.op for f in fa for n in f.node_def)
    ref_ops = collections.Counter(n.op for n in ref.node)
    ref_ops.update(n.op for f in fb for n in f.node_def)
    assert ops == ref_ops


@pytest.mark.parametrize("bound", [None, T])
@pytest.mark.parametrize("form", ["functional", "v1"])
def test_writer_and_tf_bytes_import_to_tf_logits(tf_exports, form, bound):
    xv, want = tf_exports["x"], tf_exports["logits"]
    for gd in (lstm_graph.build_lstm_graph(B, T, V, H, form=form),
               tf_exports[form].SerializeToString()):
        p, j = _import(gd, {"x": (B, T, V)}, while_max_iterations=bound)
        _agree(p, j, {"x": xv}, ["Identity"], [want])


def test_v1_form_imports_to_the_functional_program():
    xv = _one_hot(np.random.RandomState(2), (B, T))
    ops, logits = {}, {}
    for form in ("functional", "v1"):
        sd = TensorflowFrameworkImporter.run_import(
            lstm_graph.build_lstm_graph(B, T, V, H, form=form),
            {"x": (B, T, V)}, while_max_iterations=T, device="cpu")
        ops[form] = [o.op_name for o in sd.ops]
        logits[form] = _np(sd.output({"x": xv}, ["Identity"])["Identity"])
    assert ops["v1"].count("identity") == ops["functional"].count(
        "identity") + 2                                # the Exit identities
    assert [o for o in ops["v1"] if o != "identity"] == \
        [o for o in ops["functional"] if o != "identity"]
    assert ops["functional"].count("while_loop") == 2
    np.testing.assert_array_equal(logits["v1"], logits["functional"])


def _lstm_layer_logits(w, xv):
    """The oracle: two ``lstm_layer`` ops and the head, in the port."""
    sd = SameDiff(device="cpu")
    h = sd.placeholder("x", shape=(B, T, V))
    z = sd.constant(np.zeros((B, H), np.float32))
    for layer in range(2):
        h = sd._op("lstm_layer", [h, z, z] + [sd.constant(w[f"l{layer}_{k}"])
                                              for k in ("w", "rw", "b")],
                   n_out=3)[0]
    y = sd._op("add", [sd._op("matmul", [h, sd.constant(w["out_w"])]),
                       sd.constant(w["out_b"])], name="logits")
    return _np(sd.output({"x": xv}, [y.name])[y.name])


def test_logits_equal_lstm_layer_route():
    xv = _one_hot(np.random.RandomState(3), (B, T))
    sd = TensorflowFrameworkImporter.run_import(
        lstm_graph.build_lstm_graph(B, T, V, H), {"x": (B, T, V)},
        while_max_iterations=T, device="cpu")
    np.testing.assert_allclose(
        _np(sd.output({"x": xv}, ["Identity"])["Identity"]),
        _lstm_layer_logits(lstm_graph.lstm_weights(V, H), xv), **FWD)


def _jax_attach(gd):
    """The JAX package's counterpart of ``import_and_attach_loss``."""
    sd = JImporter.run_import(gd, {"x": (B, T, V)}, while_max_iterations=T)
    sd.convert_to_variables(sorted(lstm_graph.weight_names(
        "functional").values()))
    labels = sd.placeholder("labels", shape=(B, T, V))
    sd._op("softmax_cross_entropy", [labels, sd.vars["Identity"]],
           name="loss")
    sd.set_loss_variables(["loss"])
    sd.set_training_config(JTrainingConfig.Builder().updater(JAdam(5e-3))
                           .data_set_feature_mapping("x")
                           .data_set_label_mapping("labels").build())
    return sd


def test_attached_loss_trains_as_in_jax():
    gd = lstm_graph.build_lstm_graph(B, T, V, H)
    rs = np.random.RandomState(4)
    feed = {"x": _one_hot(rs, (B, T)), "labels": _one_hot(rs, (B, T))}
    p, loss = lstm_graph.import_and_attach_loss(
        gd, B, T, V, updater=Adam(5e-3), while_max_iterations=T,
        device="cpu")
    j = _jax_attach(gd)
    names = sorted(lstm_graph.weight_names("functional").values())
    pg, jg = p.calculate_gradients(feed, names), j.calculate_gradients(
        feed, names)
    for n in names:
        np.testing.assert_allclose(_np(pg[n]), np.asarray(jg[n]), **GRAD,
                                   err_msg=n)
    pl = [p.fit_steps(feed, 1) for _ in range(3)]
    jl = [j.fit_steps(feed, 1) for _ in range(3)]
    np.testing.assert_allclose(pl, jl, rtol=2e-4)
    assert pl[-1] < pl[0]
