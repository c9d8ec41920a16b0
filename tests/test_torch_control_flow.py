"""SameDiff control flow in the port (``while_loop`` / ``cond`` / ``scan``
and the select-lowered ``switch`` / ``merge``) against the JAX package's,
on the CPU.

Every case of the JAX package's ``tests/test_control_flow.py``,
``tests/test_nested_captures.py`` and ``tests/test_while_grad.py`` is
built through the API both packages share, in both, from the same
seeded numpy inputs: outputs within rtol 2e-5 / atol 1e-6, gradients
within rtol 2e-4 / atol 1e-6, and each case's own expected values held
by the port. Control-flow graphs saved by either package load in the
other (and in itself) to the same outputs. An unbounded ``while_loop``
raises, in both packages, when a gradient is asked through it, with the
same message; a bounded one trains through ``fit`` and ``fit_steps``
as the JAX package's does.
"""
import io
import json
import os
import sys
import zipfile

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.autodiff.samediff import SameDiff as JSameDiff
from deeplearning4j_tpu.autodiff.training import \
    TrainingConfig as JTrainingConfig
from deeplearning4j_tpu.learning.updaters import Sgd as JSgd
from deeplearning4j_tpu_torch.autodiff import SameDiff, TrainingConfig
from deeplearning4j_tpu_torch.autodiff import registry
from deeplearning4j_tpu_torch.learning.updaters import Sgd
from torch_parity import one_intraop_thread  # noqa: F401,E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

FWD = dict(rtol=2e-5, atol=1e-6)
GRAD = dict(rtol=2e-4, atol=1e-6)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _both():
    return JSameDiff(), SameDiff(device="cpu")


def _f32(v):
    return np.float32(v)


# -- the graphs of the JAX package's cases, one builder each ----------------
def _doubling(sd, x, max_iterations=None):
    """double v until sum(v) >= 100 (a data-dependent trip count)."""
    return sd.while_loop(
        [x],
        lambda v: v.sd._op("lt", [v.sd._op("reduce_sum", [v]),
                                  v.sd.constant(_f32(100.0))]),
        lambda v: v.sd._op("mul", [v, v.sd.constant(_f32(2.0))]),
        max_iterations=max_iterations)


def g_doubling(sd):
    x = sd.placeholder("x", shape=(4,))
    return [_doubling(sd, x).rename("res").name], \
        {"x": np.ones(4, np.float32)}


def g_multi_var(sd):
    i0 = sd.constant("i0", np.int32(0))
    acc0 = sd.constant("acc0", _f32(0.0))
    outs = sd.while_loop(
        [i0, acc0],
        lambda i, a: i.sd._op("lt", [i, i.sd.constant(np.int32(5))]),
        lambda i, a: [
            i.sd._op("add", [i, i.sd.constant(np.int32(1))]),
            a.sd._op("add", [a, a.sd._op("cast", [i],
                                         {"dtype": "float32"})])])
    return [o.name for o in outs], {}


def g_cond(flag):
    def build(sd):
        p = sd.placeholder("p", shape=())
        x = sd.placeholder("x", shape=())
        out = sd.cond(
            p, lambda v: v.sd._op("mul", [v, v.sd.constant(_f32(3.0))]),
            lambda v: v.sd._op("neg", [v]), operands=[x])
        return [out.name], {"p": _f32(flag), "x": _f32(3.0)}
    return build


def g_cumsum(sd):
    xs = sd.placeholder("xs", shape=(6,))
    c0 = sd.constant("c0", _f32(0.0))
    outs = sd.scan(lambda c, x: [c.sd._op("add", [c, x]),
                                 c.sd._op("add", [c, x])],
                   init=[c0], xs=[xs])
    return [o.name for o in outs], {"xs": np.arange(1, 7,
                                                    dtype=np.float32)}


def g_rnn_unroll(sd):
    rs = np.random.RandomState(0)
    w = (rs.randn(3, 3) * 0.5).astype(np.float32)
    xs = sd.placeholder("xs", shape=(5, 3))
    h0 = sd.constant("h0", np.zeros(3, np.float32))
    wc = sd.constant("W", w)

    def cell(h, x):
        hn = h.sd._op("tanh", [h.sd._op("add", [h.sd._op("matmul",
                                                         [h, wc]), x])])
        return [hn, hn]

    outs = sd.scan(cell, init=[h0], xs=[xs])
    return [o.name for o in outs], {"xs": rs.randn(5, 3).astype(np.float32)}


def g_no_shadowing(sd):
    outer = sd.constant(_f32(2.0))              # auto-named 'const'
    x = sd.placeholder("x", shape=())

    def branch(v):
        inner = v.sd.constant(_f32(5.0))        # the child's 'const'
        return v.sd._op("add", [v.sd._op("mul", [v, outer]), inner])

    out = sd.cond(sd.constant(_f32(1.0)), branch, lambda v: v,
                  operands=[x])
    return [out.name], {"x": _f32(3.0)}


def g_captured_placeholder(lim):
    def build(sd):
        limit = sd.placeholder("limit", shape=())
        c0 = sd.constant(_f32(0.0))
        out = sd.while_loop(
            [c0], lambda v: v.sd._op("lt", [v, limit]),
            lambda v: v.sd._op("add", [v, v.sd.constant(_f32(1.0))]))
        return [out.name], {"limit": _f32(lim)}
    return build


def g_switch_merge(flag):
    def build(sd):
        x = sd.placeholder("x", shape=(3,))
        p = sd.placeholder("p", shape=())
        f_branch, t_branch = sd._op("switch", [x, p], n_out=2)
        t_out = sd._op("mul", [t_branch, sd.constant(_f32(2.0))])
        f_out = sd._op("add", [f_branch, sd.constant(_f32(10.0))])
        merged = sd._op("merge", [f_out, t_out, p])
        return [merged.name], {"x": np.float32([1, 2, 3]), "p": _f32(flag)}
    return build


def g_scan_length(sd):
    c0 = sd.constant("c0", _f32(1.0))
    outs = sd.scan(lambda c: [c.sd._op("mul", [c, c.sd.constant(
        _f32(2.0))]), c], init=[c0], xs=(), length=5)
    return [o.name for o in outs], {}


def g_truncated(sd):
    x = sd.placeholder("x", shape=(4,))
    return [_doubling(sd, x, 2).rename("res").name], \
        {"x": np.ones(4, np.float32)}


def g_bounded(seed):
    def build(sd):
        x = sd.placeholder("x", shape=(4,))
        xv = np.random.RandomState(seed).rand(4).astype(np.float32) + 0.5
        return [_doubling(sd, x, 16).rename("res").name], {"x": xv}
    return build


#: name -> (builder, the JAX package's expected values, by output)
GRAPHS = {
    "while_doubling": (g_doubling, [np.full(4, 32.0)]),
    "while_multi_var": (g_multi_var, [5, 10.0]),
    "cond_true": (g_cond(1.0), [9.0]),
    "cond_false": (g_cond(0.0), [-3.0]),
    "scan_cumsum": (g_cumsum, [21.0, np.cumsum(np.arange(1, 7))]),
    "scan_linear_rnn": (g_rnn_unroll, None),
    "capture_no_name_shadowing": (g_no_shadowing, [11.0]),
    "captured_placeholder_3": (g_captured_placeholder(3.0), [3.0]),
    "captured_placeholder_7": (g_captured_placeholder(7.0), [7.0]),
    "switch_merge_true": (g_switch_merge(1.0), [[2.0, 4.0, 6.0]]),
    "switch_merge_false": (g_switch_merge(0.0), [[11.0, 12.0, 13.0]]),
    "scan_length_only": (g_scan_length, [32.0, [1, 2, 4, 8, 16]]),
    "while_truncated": (g_truncated, [np.full(4, 4.0)]),
    "while_bounded_seed0": (g_bounded(0), None),
    "while_bounded_seed1": (g_bounded(1), None),
    "while_bounded_seed2": (g_bounded(2), None),
}


def _run(sd, build):
    outs, feed = build(sd)
    return outs, feed, sd.output(feed, outs)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_graph_matches_jax(name):
    build, expected = GRAPHS[name]
    j, p = _both()
    outs, _, jr = _run(j, build)
    _, _, pr = _run(p, build)
    for o in outs:
        assert _np(pr[o]).dtype == np.asarray(jr[o]).dtype, o
        np.testing.assert_allclose(_np(pr[o]), np.asarray(jr[o]), **FWD,
                                   err_msg=o)
    if expected is not None:
        for o, want in zip(outs, expected):
            np.testing.assert_allclose(_np(pr[o]), want, **FWD, err_msg=o)


def test_bounded_forward_matches_unbounded():
    for seed in range(3):
        xv = np.random.RandomState(seed).rand(4).astype(np.float32) + 0.5
        got = {}
        for mi in (None, 16):
            sd = SameDiff(device="cpu")
            _doubling(sd, sd.placeholder("x", shape=(4,)), mi).rename("res")
            got[mi] = _np(sd.output({"x": xv}, ["res"])["res"])
        np.testing.assert_array_equal(got[None], got[16])


# -- gradients ------------------------------------------------------------------
def _grads(sd, feed, wrt):
    return {n: _np(g) for n, g in sd.calculate_gradients(feed, wrt).items()}


def test_bounded_while_gradient_matches_jax_and_numeric():
    """d(loss)/dw through a data-dependent trip count (w scales the start
    vector), against the JAX package and central differences."""
    w0 = np.float32([1.1, 0.9, 1.3, 0.7])
    xv = np.float32([1.0, 2.0, 0.5, 1.5])

    def build(sd, wv):
        w = sd.var("w", array=wv)
        x = sd.placeholder("x", shape=(4,))
        out = _doubling(sd, sd._op("mul", [w, x]), max_iterations=16)
        sd._op("reduce_sum", [out]).rename("loss")
        sd.set_loss_variables(["loss"])
        return sd

    j, p = _both()
    jg = _grads(build(j, w0), {"x": xv}, ["w"])["w"]
    pg = _grads(build(p, w0), {"x": xv}, ["w"])["w"]
    np.testing.assert_allclose(pg, jg, **GRAD)

    def f(wv):
        sd = build(SameDiff(device="cpu"), wv.astype(np.float32))
        return float(sd.output({"x": xv}, ["loss"])["loss"])

    w64, eps, num = w0.astype(np.float64), 1e-3, np.zeros(4)
    for i in range(4):
        d = np.zeros(4)
        d[i] = eps
        num[i] = (f(w64 + d) - f(w64 - d)) / (2 * eps)
    np.testing.assert_allclose(pg, num, rtol=1e-2, atol=1e-3)


def test_bounded_capture_receives_gradient():
    """A variable captured by the bounded loop's body (not carried):
    dloss/dw = trips * size = 18 * 3."""
    def build(sd):
        w = sd.var("w", array=_f32(0.5))
        x = sd.placeholder("x", shape=(3,))
        out = sd.while_loop(
            [x],
            lambda v: v.sd._op("lt", [v.sd._op("reduce_sum", [v]),
                                      v.sd.constant(_f32(30.0))]),
            lambda v: v.sd._op("add", [v, w]), max_iterations=64)
        sd._op("reduce_sum", [out]).rename("loss")
        sd.set_loss_variables(["loss"])
        return sd

    feed = {"x": np.ones(3, np.float32)}
    j, p = _both()
    pg = _grads(build(p), feed, ["w"])["w"]
    np.testing.assert_allclose(pg, _grads(build(j), feed, ["w"])["w"],
                               **GRAD)
    assert float(pg) == pytest.approx(18 * 3, rel=1e-5)


def _unbounded_capture(sd):
    w = sd.var("w", array=_f32(0.5))
    x = sd.placeholder("x", shape=(3,))
    out = sd.while_loop(
        [x],
        lambda v: v.sd._op("lt", [v.sd._op("reduce_sum", [v]),
                                  v.sd.constant(_f32(30.0))]),
        lambda v: v.sd._op("add", [v, w]))
    sd._op("reduce_sum", [out]).rename("loss")
    sd.set_loss_variables(["loss"])
    return sd


def test_unbounded_gradient_raises_as_in_jax():
    feed = {"x": np.ones(3, np.float32)}
    msgs = []
    for sd in _both():
        with pytest.raises(NotImplementedError,
                           match="max_iterations") as e:
            _unbounded_capture(sd).calculate_gradients(feed, ["w"])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    # the forward serves, reading the condition on the host each trip
    before = registry.HOST_READS["while_loop"]
    sd = _unbounded_capture(SameDiff(device="cpu"))
    assert float(sd.output(feed, ["loss"])["loss"]) == pytest.approx(30.0)
    assert registry.HOST_READS["while_loop"] - before == 19


def test_nested_cond_captured_variable_gradient():
    """loss = sum(cond(outer, cond(inner, b*w, b+w), a*0.5)): w captured
    two levels below the graph that owns it."""
    w0 = np.float32([1.5, -0.5, 2.0])
    xv = np.float32([1.0, 2.0, 3.0])

    def build(sd):
        x = sd.placeholder("x", (3,))
        w = sd.var("w", array=w0.copy())
        pred = sd.math.gt(sd.math.reduce_sum(x),
                          sd.constant("c0", _f32(0.0)))

        def outer_true(a):
            csd = a.sd
            p2 = csd.math.gt(sd.math.reduce_sum(w),
                             csd._as_var(_f32(10.0)))
            return csd.cond(p2, lambda b: b * w, lambda b: b + w, [a])

        y = sd.cond(pred, outer_true, lambda a: a * 0.5, [x])
        sd.math.reduce_sum(y, name="loss")
        sd.set_loss_variables(["loss"])
        return sd

    j, p = _both()
    out = float(build(p).output({"x": xv}, ["loss"])["loss"])
    assert out == pytest.approx(float((xv + w0).sum()), rel=1e-6)
    pg = _grads(p, {"x": xv}, ["w"])["w"]
    np.testing.assert_allclose(pg, _grads(build(j), {"x": xv}, ["w"])["w"],
                               **GRAD)
    np.testing.assert_allclose(pg, np.ones(3), atol=1e-6)


def test_while_in_cond_captured_variable_gradient():
    """A bounded while inside a cond branch, its body capturing w."""
    w0 = _f32(1.2)

    def build(sd):
        x = sd.placeholder("x", ())
        w = sd.var("w", array=_f32(w0))
        pred = sd.math.gt(x, sd.constant("c0", _f32(0.0)))

        def true_fn(a):
            csd = a.sd
            outs = csd.while_loop(
                [csd._as_var(np.int32(0)), a],
                lambda i, acc: i.sd.math.lt(i, i.sd._as_var(np.int32(3))),
                lambda i, acc: (i.sd.math.add(i, i.sd._as_var(np.int32(1))),
                                acc * w), max_iterations=4)
            return outs[1]

        y = sd.cond(pred, true_fn, lambda a: a, [x])
        sd.math.mul(y, sd.constant("one", _f32(1.0)), name="loss")
        sd.set_loss_variables(["loss"])
        return sd

    xv = _f32(2.0)
    j, p = _both()
    out = float(build(p).output({"x": xv}, ["loss"])["loss"])
    assert out == pytest.approx(2.0 * w0 ** 3, rel=1e-5)
    pg = float(_grads(p, {"x": xv}, ["w"])["w"])
    assert pg == pytest.approx(float(_grads(build(j), {"x": xv},
                                            ["w"])["w"]), rel=2e-4)
    assert pg == pytest.approx(3 * 2.0 * w0 ** 2, rel=1e-4)


# -- training -------------------------------------------------------------------
def _cond_regression(sd, tc, upd):
    x = sd.placeholder("x", shape=(8, 1))
    y = sd.placeholder("y", shape=(8, 1))
    w = sd.var("w", array=np.zeros((1, 1), np.float32))
    out = sd.cond(sd.constant(_f32(1.0)),
                  lambda v: v.sd._op("matmul", [v, w]), lambda v: v,
                  operands=[x])
    sd._op("mean_squared_error", [y, out], name="loss")
    sd.set_loss_variables(["loss"])
    sd.set_training_config(tc(updater=upd(0.2),
                              data_set_feature_mapping=["x"],
                              data_set_label_mapping=["y"]))
    return sd


class _Batch:
    def __init__(self, x, y):
        self.features, self.labels = [x], [y]


def test_captured_variable_trains_through_fit():
    """A trainable variable captured by a cond body gets gradients
    through ``fit``: 20 Sgd epochs, w against the JAX package's."""
    rs = np.random.RandomState(0)
    xv = rs.randn(8, 1).astype(np.float32)
    data = [_Batch(xv, 3.0 * xv)]
    j = _cond_regression(JSameDiff(), JTrainingConfig, JSgd)
    p = _cond_regression(SameDiff(device="cpu"), TrainingConfig, Sgd)
    j.fit(data, n_epochs=20)
    p.fit(data, n_epochs=20)
    wp = float(_np(p._arrays["w"]).squeeze())
    assert abs(wp - 3.0) < 0.2, wp
    np.testing.assert_allclose(wp, float(np.asarray(j._arrays["w"])
                                         .squeeze()), rtol=2e-4)


def test_nested_captured_variable_trains():
    """``fit`` through a nested capture moves w: w' = w - 0.1 x."""
    w0 = np.float32([2.0, 2.0])
    xv = np.float32([1.0, 3.0])

    def build(sd, tc, upd):
        x = sd.placeholder("x", (2,))
        w = sd.var("w", array=w0.copy())
        pred = sd.math.gt(sd.math.reduce_sum(x),
                          sd.constant("c0", _f32(0.0)))

        def outer_true(a):
            csd = a.sd
            p2 = csd.math.gt(csd.math.reduce_sum(a),
                             csd._as_var(_f32(100.0)))
            return csd.cond(p2, lambda b: b + w, lambda b: b * w, [a])

        y = sd.cond(pred, outer_true, lambda a: a, [x])
        sd.math.reduce_sum(y, name="loss")
        sd.set_loss_variables(["loss"])
        sd.set_training_config(tc.Builder().updater(upd(0.1))
                               .data_set_feature_mapping("x").build())
        return sd

    p = build(SameDiff(device="cpu"), TrainingConfig, Sgd)
    p.fit([type("B", (), {"features": xv, "labels": []})()], n_epochs=1)
    np.testing.assert_allclose(_np(p._arrays["w"]), w0 - 0.1 * xv,
                               rtol=1e-5)


def _loop_regression(sd, tc, upd, max_iterations):
    """loss = mse(y, scan/while over x with a captured weight)."""
    x = sd.placeholder("x", shape=(4, 3))
    y = sd.placeholder("y", shape=(4, 3))
    w = sd.var("w", array=np.float32([[0.9, 0.1, 0.0], [0.0, 0.8, 0.2],
                                      [0.1, 0.0, 1.1]]))
    out = sd.while_loop(
        [sd.constant(np.int32(0)), x],
        lambda i, v: i.sd._op("lt", [i, i.sd.constant(np.int32(3))]),
        lambda i, v: [i.sd._op("add", [i, i.sd.constant(np.int32(1))]),
                      v.sd._op("tanh", [v.sd._op("matmul", [v, w])])],
        max_iterations=max_iterations)[1]
    ys = sd.scan(lambda c, r: [c + r, c * r], [sd.constant(
        np.zeros(3, np.float32))], [out])[1]
    sd._op("mean_squared_error", [y, ys], name="loss")
    sd.set_loss_variables(["loss"])
    sd.set_training_config(tc(updater=upd(0.3),
                              data_set_feature_mapping=["x"],
                              data_set_label_mapping=["y"]))
    return sd


def test_bounded_loops_train_through_fit_steps_and_fit():
    rs = np.random.RandomState(5)
    feed = {"x": rs.randn(4, 3).astype(np.float32),
            "y": rs.randn(4, 3).astype(np.float32) * 0.3}
    j = _loop_regression(JSameDiff(), JTrainingConfig, JSgd, 5)
    p = _loop_regression(SameDiff(device="cpu"), TrainingConfig, Sgd, 5)
    jl = [j.fit_steps(feed, 1) for _ in range(4)]
    pl = [p.fit_steps(feed, 1) for _ in range(4)]
    np.testing.assert_allclose(pl, jl, rtol=2e-4)
    assert pl[-1] < pl[0]
    np.testing.assert_allclose(_np(p._arrays["w"]),
                               np.asarray(j._arrays["w"]), rtol=2e-4,
                               atol=1e-6)
    batch = _Batch(feed["x"], feed["y"])
    hp = p.fit([batch], n_epochs=2).loss_curve()
    hj = j.fit([batch], n_epochs=2).loss_curve()
    np.testing.assert_allclose(hp, hj, rtol=2e-4)


def test_unbounded_loop_refuses_to_train():
    rs = np.random.RandomState(5)
    feed = {"x": rs.randn(4, 3).astype(np.float32),
            "y": rs.randn(4, 3).astype(np.float32)}
    for sd in (_loop_regression(SameDiff(device="cpu"), TrainingConfig,
                                Sgd, None),
               _loop_regression(JSameDiff(), JTrainingConfig, JSgd, None)):
        with pytest.raises(NotImplementedError, match="max_iterations"):
            sd.fit_steps(feed, 1)
        with pytest.raises(NotImplementedError, match="max_iterations"):
            sd.fit([_Batch(feed["x"], feed["y"])])


# -- save / load, both directions ---------------------------------------------
def _cond_capture(sd):
    flag = sd.placeholder("flag", shape=())
    x = sd.placeholder("x", shape=(3,))
    w = sd.var("w", array=np.asarray([2., 2., 2.], np.float32))
    sd.cond(flag, lambda v: v.sd._op("mul", [v, w]),
            lambda v: v.sd._op("add", [v, w]), operands=[x]).rename("res")
    return {"flag": np.asarray(True),
            "x": np.asarray([1., 2., 3.], np.float32)}


def _while_save(sd):
    _doubling(sd, sd.placeholder("x", shape=(4,))).rename("res")
    return {"x": np.ones(4, np.float32)}


def _bounded_save(sd):
    _doubling(sd, sd.placeholder("x", shape=(4,)), 16).rename("res")
    return {"x": np.ones(4, np.float32)}


def _scan_save(sd):
    xs = sd.placeholder("xs", shape=(5,))
    c0 = sd.constant("c0", _f32(0.0))
    outs = sd.scan(lambda c, x: [c.sd._op("add", [c, x])], [c0], xs=[xs])
    (outs[0] if isinstance(outs, (list, tuple)) else outs).rename("res")
    return {"xs": np.arange(5, dtype=np.float32)}


_BIG = np.arange(256 * 256, dtype=np.float32).reshape(256, 256) / 65536


def _big_capture(sd):
    x = sd.placeholder("x", shape=(256,))
    sd.cond(sd.constant(np.asarray(True)),
            lambda v: v.sd._op("mmul", [v.sd.constant(_BIG), v]),
            lambda v: v, operands=[x]).rename("res")
    return {"x": np.ones(256, np.float32)}


def _nested_save(sd):
    x = sd.placeholder("x", ())
    w = sd.var("w", array=_f32(1.2))

    def true_fn(a):
        outs = a.sd.while_loop(
            [a.sd._as_var(np.int32(0)), a],
            lambda i, acc: i.sd.math.lt(i, i.sd._as_var(np.int32(3))),
            lambda i, acc: (i.sd.math.add(i, i.sd._as_var(np.int32(1))),
                            acc * w), max_iterations=4)
        return outs[1]

    sd.cond(sd.math.gt(x, sd.constant(_f32(0.0))), true_fn, lambda a: a,
            [x]).rename("res")
    return {"x": _f32(2.0)}


SAVED = {"while": _while_save, "while_bounded": _bounded_save,
         "cond_capture": _cond_capture, "scan": _scan_save,
         "large_capture": _big_capture, "nested": _nested_save}


@pytest.mark.parametrize("writer,reader", [("port", "port"),
                                           ("jax", "port"),
                                           ("port", "jax")])
@pytest.mark.parametrize("graph", sorted(SAVED))
def test_control_flow_zip_round_trip(tmp_path, graph, writer, reader):
    sds = {"jax": JSameDiff, "port": lambda: SameDiff(device="cpu")}
    src = sds[writer]()
    feed = SAVED[graph](src)
    want = _np(src.output(feed, ["res"])["res"])
    path = str(tmp_path / f"{graph}.sdz")
    src.save(path)
    with zipfile.ZipFile(path) as z:
        assert len(z.read("graph.json")) < 64_000  # arrays stay binary
        names = np.load(io.BytesIO(z.read("arrays.npz"))).files
        ops = json.loads(z.read("graph.json"))["ops"]
    assert any(o["op"] in ("while_loop", "cond", "scan") for o in ops)
    if graph == "large_capture":
        assert any("/" in n for n in names)     # the subgraph's constant
    dst = (SameDiff.load(path, device="cpu") if reader == "port"
           else JSameDiff.load(path))
    np.testing.assert_allclose(_np(dst.output(feed, ["res"])["res"]), want,
                               **FWD)
    if graph == "cond_capture":
        feed["flag"] = np.asarray(False)
        np.testing.assert_allclose(
            _np(dst.output(feed, ["res"])["res"]),
            _np(src.output(feed, ["res"])["res"]), **FWD)


def test_chip_smoke_phase_rehearses_on_the_cpu():
    """``chip_smoke.phase_tf_lstm`` (phase 21) end to end on the CPU at a
    small width: every check but the card's profile, peaks and card-vs-CPU
    comparison."""
    import chip_smoke as c
    r = c.phase_tf_lstm(torch, "cpu", device="cpu", hidden=16, steps=3)
    assert r["fwd_vs_lstm_layer"] <= c.TF_LSTM_FWD
    assert max(r["grad_vs_lstm_layer"]) <= c.TF_LSTM_GRAD
    assert r["losses"][-1] < r["losses"][0]
    assert r["host_reads_per_step"] == 0
    assert r["unbounded_host_reads_per_forward"] == 130
    assert r["unbounded_bitwise"]
    assert r["ops"].count("while_loop") == 2
