"""The frozen Keras ResNet-50 (``modelimport/tensorflow/resnet_graph.py``)
and its import into the port, on the CPU at 64x64x3, 10 classes and
batch 2.

- The writer against TensorFlow (skipped where TF is not installed):
  Keras' ``ResNet50(weights=None)``, built after ``clear_session()``
  and given the writer's weights with ``set_weights``, frozen by
  ``convert_variables_to_constants_v2``, equals the writer's graph node
  for node and in order (names, op types, inputs, attrs, constant
  values), and the writer's bytes run in TF to the frozen function's
  probabilities (rtol 1e-5 / atol 1e-5; measured 1.2e-6).
- The port's import of the bytes against the JAX package's: the same op
  walk, logits within atol 1e-4 / rtol 1e-4 (measured 2.2e-6).
- Fine-tuning the promoted graph (``import_and_attach_loss``) against
  the JAX package's, leaf by leaf, relative in norm: the gradients at
  the start within 1e-4 of JAX's (measured 1.3e-6), then each leaf's
  change over 3 Adam(1e-5) steps within 0.2 of JAX's change (measured
  6.6e-2, median 4.1e-3). Adam steps each element by about lr whatever
  its gradient's size, so the last rounding bits of a gradient near
  zero, which differ between the two packages' convolutions, move its
  step by up to 2 lr; a leaf left unchanged, or a gradient off by a
  constant factor, reads 1 on the bar it breaks.
- ``run_import`` defaults to the card, and ``chip_smoke.phase_tf_resnet``
  (phase 22) runs end to end on the CPU, at 32x32.
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from deeplearning4j_tpu.autodiff.training import \
    TrainingConfig as JTrainingConfig  # noqa: E402
from deeplearning4j_tpu.learning.updaters import Adam as JAdam  # noqa: E402
from deeplearning4j_tpu.modelimport.tensorflow import \
    TensorflowFrameworkImporter as JImporter  # noqa: E402
from deeplearning4j_tpu_torch.learning.updaters import Adam  # noqa: E402
from deeplearning4j_tpu_torch.modelimport.tensorflow import (  # noqa: E402
    TensorflowFrameworkImporter, resnet_graph)
from deeplearning4j_tpu_torch.modelimport.tensorflow.protobuf import \
    parse_graphdef  # noqa: E402

IMAGE, CLASSES, BATCH = 64, 10, 2
SHAPES = {"x": (BATCH, IMAGE, IMAGE, 3)}
LR, STEPS = 1e-5, 3
#: bars of the trajectory against JAX, per promoted leaf, relative in norm:
#: the gradient at the start, and the change over the steps
GRAD_RTOL, STEP_RTOL = 1e-4, 0.2


@pytest.fixture(scope="module")
def writer_bytes():
    return resnet_graph.build_resnet50_graph(IMAGE, CLASSES, BATCH)


@pytest.fixture(scope="module")
def keras_frozen():
    """TF's freeze of Keras' ResNet-50 with the writer's weights: (the
    GraphDef's bytes, the frozen function)."""
    tf = pytest.importorskip("tensorflow")
    from tensorflow.python.framework.convert_to_constants import \
        convert_variables_to_constants_v2
    keras = tf.keras
    keras.backend.clear_session()
    m = keras.applications.ResNet50(weights=None,
                                    input_shape=(IMAGE, IMAGE, 3),
                                    classes=CLASSES)
    weights = resnet_graph.resnet50_weights(CLASSES, seed=0)
    assert [w.path for w in m.weights] == [n for n, _ in weights]
    m.set_weights([a for _, a in weights])
    cf = tf.function(lambda x: m(x, training=False)).get_concrete_function(
        tf.TensorSpec((BATCH, IMAGE, IMAGE, 3), tf.float32))
    frozen = convert_variables_to_constants_v2(cf)
    return frozen.graph.as_graph_def().SerializeToString(), frozen


def _batch(seed=3):
    rs = np.random.RandomState(seed)
    return {"x": rs.randn(BATCH, IMAGE, IMAGE, 3).astype(np.float32),
            "labels": rs.randint(0, CLASSES, BATCH).astype(np.int32)}


def test_writer_graph_equals_tf_frozen_graph(keras_frozen, writer_bytes):
    want, got = parse_graphdef(keras_frozen[0]), parse_graphdef(writer_bytes)
    assert [n.name for n in got] == [n.name for n in want]
    for n, m in zip(want, got):
        assert (n.op, n.inputs) == (m.op, m.inputs), n.name
        keys = {k for k in n.attrs if not k.startswith("_")}
        assert keys == {k for k in m.attrs if not k.startswith("_")}, n.name
        for k in keys:
            a, b = n.attrs[k].value, m.attrs[k].value
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype and a.shape == b.shape, n.name
                np.testing.assert_array_equal(a, b, err_msg=n.name)
            else:
                assert a == b, (n.name, k)
    from collections import Counter
    assert Counter(n.op for n in got) == {
        "Const": 641, "Identity": 321, "Reshape": 265, "Mul": 159,
        "AddV2": 122, "BiasAdd": 54, "Conv2D": 53, "Squeeze": 53,
        "Rsqrt": 53, "Sub": 53, "Relu": 49, "Pad": 2, "Placeholder": 1,
        "MaxPool": 1, "Mean": 1, "MatMul": 1, "Softmax": 1, "NoOp": 1}


def test_writer_bytes_run_in_tensorflow(keras_frozen, writer_bytes):
    tf = pytest.importorskip("tensorflow")
    x = _batch()["x"]
    res = keras_frozen[1](tf.constant(x))
    want = np.asarray(res[0] if isinstance(res, (list, tuple)) else res)
    g = tf.Graph()
    with g.as_default():
        tf.graph_util.import_graph_def(
            tf.compat.v1.GraphDef.FromString(writer_bytes), name="")
    with tf.compat.v1.Session(graph=g) as s:
        got = s.run("Identity:0", {"x:0": x})
    assert got.shape == (BATCH, CLASSES)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_import_matches_jax(writer_bytes):
    p = TensorflowFrameworkImporter.run_import(writer_bytes, SHAPES,
                                               device="cpu")
    j = JImporter.run_import(writer_bytes, SHAPES)
    assert [o.op_name for o in p.ops] == [o.op_name for o in j.ops]
    assert [o.outputs for o in p.ops] == [o.outputs for o in j.ops]
    x = _batch()["x"]
    names = [resnet_graph.LOGITS, "Identity"]
    got, want = p.output({"x": x}, names), j.output({"x": x}, names)
    for n in names:
        np.testing.assert_allclose(got[n].numpy(), np.asarray(want[n]),
                                   rtol=1e-4, atol=1e-4, err_msg=n)


def _jax_attach(gd, names):
    """The JAX package's import of the same bytes, with the same weights
    promoted and the same loss attached."""
    j = JImporter.run_import(gd, SHAPES)
    j.convert_to_variables(names)
    labels = j.placeholder("labels", shape=(BATCH,), dtype="int32")
    j._op("sparse_softmax_cross_entropy",
          [labels, j.vars[resnet_graph.LOGITS]], name="loss")
    j.set_loss_variables(["loss"])
    j.set_training_config(JTrainingConfig.Builder().updater(JAdam(LR))
                          .build())
    return j


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_adam_trajectory_matches_jax(writer_bytes):
    p, loss = resnet_graph.import_and_attach_loss(
        writer_bytes, BATCH, IMAGE, updater=Adam(LR), device="cpu")
    names = resnet_graph.trainable_names(p)
    assert loss == "loss" and len(names) == 214
    assert all(p.vars[n].var_type.value == "VARIABLE" for n in names)
    # the frozen batch norm's moving statistics stay constant
    assert p.vars["resnet50_1/conv1_bn_1/Reshape"].var_type.value \
        == "CONSTANT"
    j = _jax_attach(writer_bytes, names)
    b = _batch(5)
    # the gradients at the start, each relative to JAX's in norm (Adam's
    # steps would not see a leaf's gradient off by a constant factor)
    pg = p.calculate_gradients(b, names)
    jg = j.calculate_gradients(b, names)
    worst = max((_rel(pg[n].numpy(), jg[n]), n) for n in names)
    assert worst[0] <= GRAD_RTOL, worst
    p0 = {n: p._arrays[n].numpy().copy() for n in names}
    j0 = {n: np.asarray(j._arrays[n]).copy() for n in names}
    pl = [p.fit_steps(b, 1) for _ in range(STEPS)]
    jl = [float(j.fit_steps(b, 1)) for _ in range(STEPS)]
    np.testing.assert_allclose(pl, jl, rtol=2e-4)
    assert pl[-1] < pl[0]
    # each leaf's change, relative to the norm of JAX's change
    worst = max((_rel(p._arrays[n].numpy() - p0[n],
                      np.asarray(j._arrays[n]) - j0[n]), n) for n in names)
    assert worst[0] <= STEP_RTOL, worst


def test_run_import_defaults_to_the_card(monkeypatch, writer_bytes):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TensorflowFrameworkImporter.run_import(writer_bytes, SHAPES)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resnet_graph.import_and_attach_loss(writer_bytes, BATCH, IMAGE)


def test_chip_smoke_phase_rehearses_on_the_cpu():
    """``chip_smoke.phase_tf_resnet`` end to end on the CPU at 32x32
    (Keras' smallest input), 10 classes, batch 2: every check but the
    card's timings and profiles (the CPU's f32 against its own
    float64)."""
    import chip_smoke as c
    r = c.phase_tf_resnet(torch, "cpu", device="cpu", image=32,
                          classes=CLASSES, batch=BATCH)
    assert r["ops_walked"] == 497 and r["deterministic_bitwise"]
    assert r["logits_vs_f64"] <= c.TF_RESNET_RTOL
    assert r["grad_vs_f64_max"] <= c.TF_RESNET_RTOL
    assert r["kinks_pinned"] == 50
    assert r["losses"][-1] < r["losses"][0]
    assert len(r["sweep"]["ops"]) == 60 and len(r["sweep"]["methods"]) == 31
