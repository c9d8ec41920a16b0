"""The port's SameDiff (``autodiff/samediff.py``) against the JAX
package's, on the CPU.

The same small graph is built through both APIs from the same numpy
weights. Bars: ``output`` within rtol 2e-5 / atol 1e-6 and
``calculate_gradients`` within rtol 2e-4 / atol 1e-6 (f32 on both
sides); a 5-step Adam ``fit`` within rtol 2e-4 of the loss at every step
and the weights at atol 1e-5; ``fit_steps(b, 5)`` twice bitwise equal
to ``fit_steps(b, 10)`` in the port (the same ops in the same order),
and within the trajectory bars of the JAX package's ``fit_steps(b,
10)``. Zips cross both ways: the JAX package's ``save`` loads in the
port (``SameDiff.load`` and ``restore_model``) and the port's in the
JAX package, and training resumes from the carried updater state.
"""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.autodiff.samediff import SameDiff as JSameDiff
from deeplearning4j_tpu.autodiff.training import \
    TrainingConfig as JTrainingConfig
from deeplearning4j_tpu.learning.updaters import Adam as JAdam
from deeplearning4j_tpu_torch.autodiff import (SameDiff, TrainingConfig,
                                               VariableType)
from deeplearning4j_tpu_torch.learning.updaters import Adam
from deeplearning4j_tpu_torch.utils.serializer import ModelSerializer
from torch_parity import one_intraop_thread  # noqa: F401,E402

FWD = dict(rtol=2e-5, atol=1e-6)
GRAD = dict(rtol=2e-4, atol=1e-6)
LOSS_RTOL, W_ATOL = 2e-4, 1e-5


def _weights(seed=0):
    rs = np.random.RandomState(seed)
    return {"w1": (rs.randn(6, 8) * 0.5).astype(np.float32),
            "b1": np.zeros(8, np.float32),
            "w2": (rs.randn(8, 3) * 0.5).astype(np.float32),
            "b2": (rs.randn(3) * 0.1).astype(np.float32)}


def _batch(seed=1, n=16):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, 6).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, n)]
    return {"x": x, "y": y}


def _build(sd, w, config=None, updater=None):
    """A two-layer classifier with a LayerNorm, GELU and softmax
    cross-entropy, through the reference surface both packages share."""
    x = sd.placeholder("x", shape=(None, 6))
    y = sd.placeholder("y", shape=(None, 3))
    w1 = sd.var("w1", array=w["w1"])
    b1 = sd.var("b1", array=w["b1"])
    w2 = sd.var("w2", array=w["w2"])
    b2 = sd.var("b2", array=w["b2"])
    h = sd.nn.gelu(sd.nn.layer_norm(x @ w1 + b1, epsilon=1e-5))
    logits = sd.nn.linear(h, w2, b2)
    sd.nn.softmax(logits, name="probs")
    loss = sd.loss.softmax_cross_entropy(y, logits, name="loss")
    sd.set_loss_variables(loss)
    if updater is not None:
        sd.set_training_config(config.Builder().updater(updater)
                               .data_set_feature_mapping("x")
                               .data_set_label_mapping("y").build())
    return sd


def _pair(lr=1e-2):
    w = _weights()
    j = _build(JSameDiff(), w, JTrainingConfig, JAdam(lr))
    p = _build(SameDiff(device="cpu"), w, TrainingConfig, Adam(lr))
    return j, p


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def test_output_and_gradients_match_jax():
    j, p = _pair()
    b = _batch()
    jo = j.output(b, ["probs", "loss"])
    po = p.output(b, ["probs", "loss"])
    for k in ("probs", "loss"):
        assert isinstance(po[k], torch.Tensor)
        np.testing.assert_allclose(_np(po[k]), jo[k], **FWD, err_msg=k)
    jg = j.calculate_gradients(b, ["w1", "b1", "w2", "b2"])
    pg = p.calculate_gradients(b, ["w1", "b1", "w2", "b2"])
    for k in jg:
        np.testing.assert_allclose(_np(pg[k]), jg[k], **GRAD, err_msg=k)


def test_graph_surface_matches_jax():
    j, p = _pair()
    assert [o.op_name for o in p.ops] == [o.op_name for o in j.ops]
    assert [(o.inputs, o.outputs) for o in p.ops] == \
        [(o.inputs, o.outputs) for o in j.ops]
    assert {n: v.var_type.value for n, v in p.vars.items()} == \
        {n: v.var_type.value for n, v in j.vars.items()}
    assert p.vars["w1"].dtype == "float32" and p.vars["w1"].shape == (6, 8)
    assert "layer_norm" in p.summary() and "gelu" in p.summary()
    assert p.get_variable("w2").var_type is VariableType.VARIABLE
    # the fluent executor and eval reach the same values
    b = _batch()
    got = p.batch_output().input("x", b["x"]).input("y", b["y"]) \
        .output("probs").exec()["probs"]
    np.testing.assert_array_equal(_np(got), _np(p.vars["probs"].eval(b)))


def test_five_step_adam_fit_matches_jax():
    j, p = _pair()
    batches = [_batch(seed=s) for s in range(5)]
    jh = j.fit(batches, placeholders_fn=lambda b: b)
    ph = p.fit(batches, placeholders_fn=lambda b: b)
    np.testing.assert_allclose(ph.loss_curve(), jh.loss_curve(),
                               rtol=LOSS_RTOL)
    assert p.iteration_count == j.iteration_count == 5
    for k in ("w1", "b1", "w2", "b2"):
        np.testing.assert_allclose(p.vars[k].get_arr(),
                                   j.vars[k].get_arr(), atol=W_ATOL,
                                   err_msg=k)
    assert p.score() == pytest.approx(j.score(), rel=LOSS_RTOL)


def test_fit_via_training_config_mappings():
    """Batches with .features/.labels go through the config's
    mappings."""

    class DS:
        def __init__(self, b):
            self.features, self.labels = b["x"], b["y"]

    j, p = _pair()
    data = [DS(_batch(seed=s)) for s in range(3)]
    np.testing.assert_allclose(p.fit(data).loss_curve(),
                               j.fit(data).loss_curve(), rtol=LOSS_RTOL)


def test_fit_validation_and_listeners_match_jax():
    """``fit`` evaluates the validation iterator each epoch into the
    History (loss and an Evaluation over ``probs``), and listeners see
    every iteration and epoch."""
    from deeplearning4j_tpu.evaluation import Evaluation as JEvaluation
    from deeplearning4j_tpu_torch.evaluation import Evaluation
    from deeplearning4j_tpu_torch.optimize.listeners import \
        TrainingListener

    class Count(TrainingListener):
        def __init__(self):
            self.calls = []

        def iteration_done(self, model, iteration, epoch):
            self.calls.append((iteration, epoch, model.score()))

        def on_epoch_end(self, model):
            self.calls.append(("end", model.epoch_count))

    j, p = _pair()
    train = [_batch(seed=s) for s in range(3)]
    val = [_batch(seed=10), _batch(seed=11)]
    lis = Count()
    ph = p.fit(train, n_epochs=2, placeholders_fn=lambda b: b,
               listeners=[lis], validation_iter=val,
               validation_evaluations={"probs": Evaluation})
    jh = j.fit(train, n_epochs=2, placeholders_fn=lambda b: b,
               validation_iter=val,
               validation_evaluations={"probs": JEvaluation})
    np.testing.assert_allclose(ph.validation_loss_curve(),
                               jh.validation_loss_curve(), rtol=LOSS_RTOL)
    assert ph.final_evaluation("probs").accuracy() == \
        jh.final_evaluation("probs").accuracy()
    assert len(ph) == 2 and p.epoch_count == 2
    assert [c[:2] for c in lis.calls] == [
        (0, 0), (1, 0), (2, 0), ("end", 1), (3, 1), (4, 1), (5, 1),
        ("end", 2)]
    assert lis.calls[-2][2] == ph.loss_curve()[-1]


def test_fit_steps_chains_and_matches_jax():
    b = _batch()
    j, p = _pair()
    _, p2 = _pair()
    l10 = p.fit_steps(b, 10)
    p2.fit_steps(b, 5)
    l55 = p2.fit_steps(b, 5)
    assert l55 == l10
    for k in ("w1", "b1", "w2", "b2"):
        torch.testing.assert_close(p2._arrays[k], p._arrays[k], rtol=0,
                                   atol=0)
    assert p.iteration_count == p2.iteration_count == 10
    jl = j.fit_steps(b, 10)
    assert l10 == pytest.approx(jl, rel=LOSS_RTOL)
    for k in ("w1", "w2"):
        np.testing.assert_allclose(p.vars[k].get_arr(),
                                   j.vars[k].get_arr(), atol=W_ATOL)


def test_zip_from_jax_loads_in_the_port_and_resumes(tmp_path):
    j, _ = _pair()
    b = _batch()
    j.fit([b, _batch(seed=2)], placeholders_fn=lambda x: x)
    path = tmp_path / "jax_sd.zip"
    j.save(str(path))
    for p in (SameDiff.load(str(path), device="cpu"),
              ModelSerializer.restore_model(path, "cpu")):
        assert isinstance(p, SameDiff)
        assert p.iteration_count == 2 and p.loss_variables == ["loss"]
        np.testing.assert_allclose(_np(p.output(b, ["probs"])["probs"]),
                                   j.output(b, ["probs"])["probs"], **FWD)
    # the carried Adam moments resume: one more step on both sides
    jl = j.fit([b], placeholders_fn=lambda x: x).loss_curve()
    pl = p.fit([b], placeholders_fn=lambda x: x).loss_curve()
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)
    for k in ("w1", "w2"):
        np.testing.assert_allclose(p.vars[k].get_arr(),
                                   j.vars[k].get_arr(), atol=W_ATOL)


def test_zip_from_the_port_loads_in_jax(tmp_path):
    _, p = _pair()
    b = _batch()
    p.fit([b, _batch(seed=2)], placeholders_fn=lambda x: x)
    path = tmp_path / "port_sd.zip"
    p.save(str(path))
    j = JSameDiff.load(str(path))
    assert j.iteration_count == 2
    np.testing.assert_allclose(j.output(b, ["probs"])["probs"],
                               _np(p.output(b, ["probs"])["probs"]), **FWD)
    jl = j.fit([b], placeholders_fn=lambda x: x).loss_curve()
    pl = p.fit([b], placeholders_fn=lambda x: x).loss_curve()
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)
    # the port's own round trip is exact
    p.save(str(path))
    again = SameDiff.load(str(path), device="cpu")
    torch.testing.assert_close(again.output(b, ["probs"])["probs"],
                               p.output(b, ["probs"])["probs"], rtol=0,
                               atol=0)


def test_bfloat16_variables_round_trip(tmp_path):
    sd = SameDiff(device="cpu")
    x = sd.placeholder("x", shape=(2, 3))
    w = sd.var("w", array=torch.randn(3, 2, generator=torch.Generator()
                                      .manual_seed(0)).bfloat16())
    sd.invoke("matmul", [x.cast("bfloat16"), w], name="out")
    path = tmp_path / "bf16.zip"
    sd.save(str(path))
    again = SameDiff.load(str(path), device="cpu")
    assert again._arrays["w"].dtype == torch.bfloat16
    assert again.vars["w"].dtype == "bfloat16"
    xv = np.ones((2, 3), np.float32)
    torch.testing.assert_close(again.output({"x": xv}, ["out"])["out"],
                               sd.output({"x": xv}, ["out"])["out"],
                               rtol=0, atol=0)


def test_entry_points_default_to_the_card(monkeypatch, tmp_path):
    _, p = _pair()
    path = tmp_path / "sd.zip"
    p.save(str(path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: SameDiff(), lambda: SameDiff.create(),
                 lambda: SameDiff.load(str(path)),
                 lambda: ModelSerializer.restore_model(path)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def _cf_while(sd):
    h = sd.vars["x"] @ sd.vars["w1"]
    two = sd.constant(np.float32(2.0))
    return sd.while_loop(
        [h],
        lambda v: v.sd.math.lt(v.sd.math.reduce_sum(v.sd.math.abs(v)),
                               v.sd._as_var(np.float32(2000.0))),
        lambda v: v * two + sd.vars["b1"], max_iterations=8)


def _cf_cond(sd):
    h = sd.vars["x"] @ sd.vars["w1"]
    return sd.cond(sd.math.gt(sd.math.reduce_sum(h),
                              sd.constant(np.float32(-1e9))),
                   lambda v: v.sd.math.tanh(v @ sd.vars["w2"]),
                   lambda v: v @ sd.vars["w2"], [h])


def _cf_scan(sd):
    h = sd.vars["x"] @ sd.vars["w1"]
    outs = sd.scan(lambda c, r: [c * sd.vars["b1"] + r, c], [h], [h],
                   length=None)
    return outs[0]


@pytest.mark.parametrize("build", [_cf_while, _cf_cond, _cf_scan],
                         ids=["while_loop", "cond", "scan"])
def test_control_flow_paths_work(build):
    """The control-flow builders on the classifier's graph, capturing its
    variables: output and gradients as the JAX package's."""
    j, p = _pair()
    b = _batch()
    for sd in (j, p):
        out = build(sd)
        sd.math.reduce_sum(out, name="cf_loss")
        sd.set_loss_variables(["cf_loss"])
    jo = j.output(b, ["cf_loss"])["cf_loss"]
    po = p.output(b, ["cf_loss"])["cf_loss"]
    np.testing.assert_allclose(_np(po), np.asarray(jo), **FWD)
    names = ["w1", "b1", "w2", "b2"]
    jg = j.calculate_gradients(b, names)
    pg = p.calculate_gradients(b, names)
    for n in names:
        np.testing.assert_allclose(_np(pg[n]), np.asarray(jg[n]), **GRAD,
                                   err_msg=n)


class _ModelAxisMesh:
    """A mesh with a model axis: tensor parallelism, not ported."""
    shape = {"data": 2, "model": 2}


def _exported_probs(sd):
    b = _batch()
    blob = sd.export_serialized({"x": b["x"]}, ["probs"])
    return SameDiff.deserialize_and_call(blob, {"x": b["x"]})[0]


@pytest.mark.parametrize("call, unported", [
    (lambda sd: sd.to_stablehlo({"x": _batch()["x"]}, ["probs"]), None),
    (_exported_probs, None),
    (lambda sd: sd.fit_steps(_batch(), 1, mesh=_ModelAxisMesh()),
     "item 12"),
    (lambda sd: sd.output(_batch(), ["probs"], mesh=_ModelAxisMesh()),
     "item 12"),
], ids=["stablehlo", "export", "fit_steps_mesh", "output_mesh"])
def test_unported_paths_raise(call, unported):
    """Program export runs; of the mesh paths only the axes other than
    ``data`` stay unported, and raise naming their ROADMAP item."""
    _, p = _pair()
    if unported is None:
        assert call(p) is not None
        return
    with pytest.raises(NotImplementedError, match=unported):
        call(p)


def _domain_path(sd, kind):
    """One call into a domain that now runs, on the classifier's graph;
    returns the output name and its feed."""
    rs = np.random.RandomState(4)
    if kind == "cnn":
        img = sd.placeholder("img", shape=(2, 5, 5, 3))
        k = sd.constant("k", (rs.randn(3, 3, 3, 4) * 0.3).astype(np.float32))
        out = sd.cnn.max_pooling2d(sd.cnn.conv2d(img, k, stride=(2, 2)),
                                   kernel=(2, 2), stride=(1, 1),
                                   padding="SAME")
        return out, {"img": rs.randn(2, 5, 5, 3).astype(np.float32)}
    if kind == "random":
        return sd.random.normal(0.0, 1.0, (3, 4)), {}
    if kind == "dropout":
        return sd.nn.dropout(sd.vars["probs"], 0.5), _batch()
    ids = sd.constant("ids", np.asarray([2, 0, 0, 1, 2, 2] * 2 + [1] * 4,
                                        np.int32))
    return sd.math.segment_sum(sd.vars["probs"], ids, num_segments=4), \
        _batch()


@pytest.mark.parametrize("kind", ["cnn", "random", "dropout", "segment"])
def test_domain_paths_run_as_in_jax(kind):
    """The calls that raised while their domains waited (sd.cnn,
    sd.random, sd.nn.dropout, sd.math.segment_sum) run in both packages
    to the same values; a random draw to the same shape and dtype
    (the streams differ), and dropout outside training to its input."""
    j, p = _pair()
    jo, feed = _domain_path(j, kind)
    po, _ = _domain_path(p, kind)
    jv = np.asarray(j.output(feed, [jo.name])[jo.name])
    pv = _np(p.output(feed, [po.name])[po.name])
    assert pv.shape == jv.shape and pv.dtype == jv.dtype
    if kind == "random":
        assert np.isfinite(pv).all() and pv.std() > 0
        return
    np.testing.assert_allclose(pv, jv, **FWD)
    if kind == "dropout":
        np.testing.assert_array_equal(
            pv, _np(p.output(feed, ["probs"])["probs"]))


def test_scalar_values_keep_their_shape():
    """A 0-d numpy constant, placeholder value and variable stay 0-d, as
    in the JAX package (``np.ascontiguousarray`` alone makes them 1-d)."""
    got = []
    for sd in (JSameDiff(), SameDiff(device="cpu")):
        c = sd.constant("c", np.float32(2.0))
        v = sd.var("v", array=np.int32(3))
        p = sd.placeholder("p", shape=())
        sd.math.add(p, c, name="s")
        out = sd.output({"p": np.float32(1.5)}, ["c", "v", "s"])
        got.append({k: _np(t).shape for k, t in out.items()})
    assert got[1] == got[0] == {"c": (), "v": (), "s": ()}
