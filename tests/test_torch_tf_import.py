"""The port's TF GraphDef import (``modelimport/tensorflow``), its
GraphOptimizer (``autodiff/passes.py``) and the TF-free BERT GraphDef
writer (``modelimport/tensorflow/bert_graph.py``), on the CPU at toy
BERT dimensions (vocab 97, hidden 32, 4 heads, 2 layers, t=16, batch
2).

- The writer against TensorFlow (skipped where TF is not installed):
  its graph equals the one TF freezes from ``benchmarks/
  tf_bert_builder.py`` node for node (names, op types, inputs, attrs,
  constant values), and its bytes run in TF to TF's own frozen graph's
  output for the same seed (atol 1e-6).
- Import in both packages, from TF's bytes and from the writer's: the
  same GraphOptimizer counts (2 / 4 / 2 / 2 at 2 layers), the same op
  walk, outputs within rtol 1e-5 / atol 1e-5, with and without the
  optimizer.
- The weight-tied MLM head with the gathered positions: a 4-step Adam
  trajectory within rtol 2e-4 of the JAX package's loss at every step in
  float32 (measured 1.2e-6), and within rtol 5e-3 in bfloat16 (measured
  1.1e-3; both packages compute the whole program in bf16, ~3
  significant digits, summed in other orders).
- Graphs with control flow (``lstm_graph``'s functional While and v1
  frames with TensorLists, and a functional ``StatelessIf``) import,
  with and without ``while_max_iterations``, to the JAX package's
  outputs (rtol 1e-5 / atol 1e-5); a bounded import trains
  (``tests/test_torch_tf_control_flow.py`` holds the rest).
"""
import os
import sys

import numpy as np
import pytest
import torch
from torch_parity import one_intraop_thread  # noqa: F401,E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from benchmarks.tf_bert_builder import \
    import_and_attach_mlm as j_attach  # noqa: E402
from deeplearning4j_tpu.learning.updaters import Adam as JAdam  # noqa: E402
from deeplearning4j_tpu.modelimport.tensorflow import \
    TensorflowFrameworkImporter as JImporter  # noqa: E402
from deeplearning4j_tpu.modelimport.tensorflow.protobuf import \
    parse_graphdef as j_parse  # noqa: E402
from deeplearning4j_tpu_torch.common.environment import \
    Environment  # noqa: E402
from deeplearning4j_tpu_torch.learning.updaters import Adam  # noqa: E402
from deeplearning4j_tpu_torch.modelimport.tensorflow import \
    TensorflowFrameworkImporter  # noqa: E402
from deeplearning4j_tpu_torch.modelimport.tensorflow.bert_graph import (
    build_frozen_bert, import_and_attach_mlm)  # noqa: E402
from deeplearning4j_tpu_torch.modelimport.tensorflow.protobuf import \
    parse_graphdef  # noqa: E402

SEQ, BATCH = 16, 2
DIMS = dict(vocab=97, hidden=32, heads=4, layers=2)
SHAPES = {"ids": (BATCH, SEQ), "seg": (BATCH, SEQ), "mask": (BATCH, SEQ)}
COUNTS = {"cast_fold": 0, "mask_strength_reduce": 2, "layernorm_refuse": 4,
          "gelu_refuse": 2, "attention_fuse": 2}
FWD = dict(rtol=1e-5, atol=1e-5)
K = 4


@pytest.fixture(scope="module")
def writer_bytes():
    return build_frozen_bert(SEQ, BATCH, **DIMS)


@pytest.fixture(scope="module")
def tf_frozen():
    pytest.importorskip("tensorflow")
    from benchmarks.tf_bert_builder import build_frozen_bert as tf_build
    return tf_build(SEQ, BATCH, **DIMS)


def _feeds(seed=3):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, DIMS["vocab"], (BATCH, SEQ)).astype(np.int32)
    seg = np.zeros((BATCH, SEQ), np.int32)
    seg[:, SEQ // 2:] = 1
    mask = np.ones((BATCH, SEQ), np.int32)
    mask[1, SEQ - 5:] = 0            # padded keys; every row keeps keys
    return {"ids": ids, "seg": seg, "mask": mask}


def _mlm_batch(seed=5):
    rs = np.random.RandomState(seed)
    b = _feeds(seed)
    pos = np.stack([np.sort(rs.choice(SEQ - 5, K, replace=False))
                    for _ in range(BATCH)]).astype(np.int32)
    labels = rs.randint(0, DIMS["vocab"], (BATCH, K)).astype(np.int32)
    labels[1, -1] = -1               # an ignored prediction
    b.update(mlm_positions=pos, mlm_labels=labels)
    return b


def _same_nodes(a, b):
    """Node lists equal in names, ops, inputs, attrs and constant values
    (TF's internal ``_``-attrs aside)."""
    A, B = {n.name: n for n in a}, {n.name: n for n in b}
    assert set(A) == set(B)
    for name, n in A.items():
        m = B[name]
        assert (n.op, n.inputs) == (m.op, m.inputs), name
        keys = {k for k in n.attrs if not k.startswith("_")}
        assert keys == {k for k in m.attrs if not k.startswith("_")}, name
        for k in keys:
            x, y = n.attrs[k].value, m.attrs[k].value
            if isinstance(x, np.ndarray):
                assert x.dtype == y.dtype and x.shape == y.shape, name
                np.testing.assert_array_equal(x, y, err_msg=name)
            else:
                assert x == y, (name, k)


def test_writer_graph_equals_tf_frozen_graph(tf_frozen, writer_bytes):
    gd, _ = tf_frozen
    _same_nodes(parse_graphdef(gd), parse_graphdef(writer_bytes))
    from collections import Counter
    ops = Counter(n.op for n in parse_graphdef(writer_bytes))
    assert ops == {"AddV2": 30, "BatchMatMulV2": 16, "Cast": 1,
                   "Const": 143, "Erf": 2, "GatherV2": 2, "Identity": 34,
                   "Mean": 8, "Mul": 13, "NoOp": 1, "Pack": 8,
                   "Placeholder": 3, "RealDiv": 4, "Reshape": 8,
                   "Rsqrt": 4, "Softmax": 2, "SquaredDifference": 4,
                   "StridedSlice": 18, "Sub": 5, "Transpose": 8}


def test_writer_bytes_run_in_tensorflow(tf_frozen, writer_bytes):
    tf = pytest.importorskip("tensorflow")
    _, run_tf = tf_frozen
    f = _feeds()
    want = run_tf(f["ids"], f["seg"], f["mask"])
    g = tf.Graph()
    with g.as_default():
        tf.graph_util.import_graph_def(
            tf.compat.v1.GraphDef.FromString(writer_bytes), name="")
    with tf.compat.v1.Session(graph=g) as s:
        got = s.run("Identity:0", {f"{k}:0": v for k, v in f.items()})
    assert got.shape == (BATCH, SEQ, DIMS["hidden"])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_decoder_matches_jax(writer_bytes):
    mine, ref = parse_graphdef(writer_bytes), j_parse(writer_bytes)
    _same_nodes(mine, ref)
    assert [n.name for n in mine] == [n.name for n in ref]


@pytest.mark.parametrize("source", ["writer", "tensorflow"])
@pytest.mark.parametrize("optimize", [True, False])
def test_import_matches_jax(source, optimize, request):
    gd = (request.getfixturevalue("writer_bytes") if source == "writer"
          else request.getfixturevalue("tf_frozen")[0])
    p = TensorflowFrameworkImporter.run_import(gd, SHAPES,
                                               optimize=optimize,
                                               device="cpu")
    j = JImporter.run_import(gd, SHAPES, optimize=optimize)
    assert p.graphopt_counts == getattr(j, "graphopt_counts", {})
    assert p.graphopt_counts == (COUNTS if optimize else {})
    assert [(o.op_name, o.inputs, o.outputs) for o in p.ops] == \
        [(o.op_name, o.inputs, o.outputs) for o in j.ops]
    f = _feeds()
    got = p.output(f, ["Identity"])["Identity"]
    np.testing.assert_allclose(got.numpy(), j.output(f, ["Identity"])[
        "Identity"], **FWD)
    walk = [p.ops[i].op_name for i in p._ancestors(["Identity"])]
    if optimize:
        assert "softmax" not in walk and walk.count("sdpa_core") == 2
        assert walk.count("layer_norm") == 4 and walk.count("gelu") == 2
        sdpa = [p.ops[i] for i in p._ancestors(["Identity"])
                if p.ops[i].op_name == "sdpa_core"]
        assert all(o.attrs["mask_mode"] == "key" for o in sdpa)
    else:
        assert walk.count("softmax") == 2 and "sdpa_core" not in walk


def test_optimized_equals_unoptimized_and_shapes_are_inferred(
        writer_bytes):
    opt = TensorflowFrameworkImporter.run_import(writer_bytes, SHAPES,
                                                 device="cpu")
    raw = TensorflowFrameworkImporter.run_import(writer_bytes, SHAPES,
                                                 optimize=False,
                                                 device="cpu")
    f = _feeds()
    torch.testing.assert_close(opt.output(f, ["Identity"])["Identity"],
                               raw.output(f, ["Identity"])["Identity"],
                               **FWD)
    v = opt.vars["Identity"]
    assert v.shape == (BATCH, SEQ, DIMS["hidden"]) and v.dtype == "float32"


def test_kill_switch_leaves_the_graph_alone(writer_bytes):
    extra = Environment.get().extra
    extra["graphopt"] = "0"
    try:
        sd = TensorflowFrameworkImporter.run_import(writer_bytes, SHAPES,
                                                    device="cpu")
    finally:
        extra.pop("graphopt", None)
    assert sd.graphopt_counts == {}
    assert "sdpa_core" not in {o.op_name for o in sd.ops}


def _if_graph() -> bytes:
    """``tf.cond(sum(x) > 0, lambda: x * 2, lambda: x - 1)`` as a
    functional ``StatelessIf`` with its branches in the library."""
    from deeplearning4j_tpu_torch.modelimport.tensorflow import \
        lstm_graph as lg
    g = lg._Graph()
    g.add("x", "Placeholder", dtype=lg._T_FLOAT, shape=lg._attr_shape((3,)))
    g.const("axis", np.int32(0))
    g.add("Sum", "Sum", ["x", "axis"], T=lg._T_FLOAT, Tidx=lg._T_INT,
          keep_dims=lg._attr_b(False))
    g.const("zero", np.float32(0.0))
    g.add("Greater", "Greater", ["Sum", "zero"], T=lg._T_FLOAT)
    g.add("cond", "StatelessIf", ["Greater", "x"],
          then_branch=lg._attr_func("then_fn"),
          else_branch=lg._attr_func("else_fn"))
    g.add("Identity", "Identity", ["cond"], T=lg._T_FLOAT)
    fns = b""
    for name, op, c in (("then_fn", "Mul", 2.0), ("else_fn", "Sub", 1.0)):
        f = lg._Graph()
        f.const("c", np.float32(c))
        f.add("y", op, ["v", "c:output:0"], T=lg._T_FLOAT)
        fns += lg._ld(1, lg._function_def(
            name, [("v", lg._DT_FLOAT)], [("out", lg._DT_FLOAT)],
            f.nodes, {"out": "y:z:0"}))
    return b"".join(lg._ld(1, n) for n in g.nodes) + lg._ld(2, fns)


def _lstm_bytes(form):
    from deeplearning4j_tpu_torch.modelimport.tensorflow.lstm_graph import \
        build_lstm_graph
    return build_lstm_graph(2, 5, 11, 16, form=form)


#: the graph each control-flow op stands in, and the feed of its input
_CF_GRAPHS = {"While": (lambda: _lstm_bytes("functional"), (2, 5, 11)),
              "StatelessIf": (_if_graph, (3,)),
              "Enter": (lambda: _lstm_bytes("v1"), (2, 5, 11)),
              "NextIteration": (lambda: _lstm_bytes("v1"), (2, 5, 11)),
              "TensorListReserve": (lambda: _lstm_bytes("functional"),
                                    (2, 5, 11))}


@pytest.mark.parametrize("op", ["While", "StatelessIf", "Enter",
                                "NextIteration", "TensorListReserve"])
def test_control_flow_graphs_import(op):
    """A graph holding ``op`` imports, unbounded and bounded, to the JAX
    package's output."""
    build, shape = _CF_GRAPHS[op]
    gd = build()
    assert op in {n.op for n in parse_graphdef(gd)}
    rs = np.random.RandomState(3)
    for sign in (1.0, -1.0):
        x = (sign * np.abs(rs.randn(*shape))).astype(np.float32)
        for mi in (None, 5):
            p = TensorflowFrameworkImporter.run_import(
                gd, {"x": shape}, while_max_iterations=mi, device="cpu")
            j = JImporter.run_import(gd, {"x": shape},
                                     while_max_iterations=mi)
            np.testing.assert_allclose(
                p.output({"x": x}, ["Identity"])["Identity"].numpy(),
                np.asarray(j.output({"x": x}, ["Identity"])["Identity"]),
                **FWD)


def test_bounded_while_import_trains():
    """``while_max_iterations`` makes the imported loops differentiable:
    5 Adam steps of the LSTM graph lower the loss."""
    from deeplearning4j_tpu_torch.modelimport.tensorflow.lstm_graph import \
        import_and_attach_loss
    sd, loss = import_and_attach_loss(
        _lstm_bytes("functional"), 2, 5, 11, updater=Adam(5e-2),
        while_max_iterations=5, device="cpu")
    rs = np.random.RandomState(4)
    eye = np.eye(11, dtype=np.float32)
    feed = {"x": eye[rs.randint(0, 11, (2, 5))],
            "labels": eye[rs.randint(0, 11, (2, 5))]}
    losses = [sd.fit_steps(feed, 1) for _ in range(5)]
    assert losses[-1] < losses[0]


def test_run_import_defaults_to_the_card(monkeypatch, writer_bytes):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TensorflowFrameworkImporter.run_import(writer_bytes, SHAPES)


def _trajectory(attach, gd, updater, steps=4, **kw):
    sd, loss = attach(gd, BATCH, SEQ, vocab=DIMS["vocab"],
                      hidden=DIMS["hidden"], updater=updater,
                      max_predictions=K, **kw)
    b = _mlm_batch()
    return sd, sd.fit([b] * steps, placeholders_fn=lambda x: x
                      ).loss_curve()


def test_mlm_trajectory_f32_matches_jax(writer_bytes):
    p, pl = _trajectory(import_and_attach_mlm, writer_bytes, Adam(5e-3),
                        device="cpu")
    j, jl = _trajectory(j_attach, writer_bytes, JAdam(5e-3))
    np.testing.assert_allclose(pl, jl, rtol=2e-4)
    assert pl[-1] < pl[0]
    trainable = sorted(n for n, v in p.vars.items()
                       if v.var_type.value == "VARIABLE")
    assert trainable == sorted(n for n, v in j.vars.items()
                               if v.var_type.value == "VARIABLE")
    assert "Gather/resource" in trainable and len(trainable) == 34


def test_mlm_trajectory_bf16_matches_jax(writer_bytes):
    p, pl = _trajectory(import_and_attach_mlm, writer_bytes, Adam(5e-3),
                        device="cpu", dtype="bfloat16")
    j, jl = _trajectory(j_attach, writer_bytes, JAdam(5e-3),
                        dtype="bfloat16")
    assert p._arrays["Gather/resource"].dtype == torch.bfloat16
    assert all(np.isfinite(pl))
    np.testing.assert_allclose(pl, jl, rtol=5e-3)


def test_chip_smoke_phase_rehearses_on_the_cpu():
    """``chip_smoke.phase_sd_bert`` and its card-vs-CPU check run end to
    end on the CPU at a small size (every check but the card's counts,
    timings and profiles)."""
    import chip_smoke as c
    r = c.phase_sd_bert(torch, "cpu", device="cpu",
                        dims=dict(vocab=97, hidden=64, heads=2, layers=2,
                                  intermediate=128), batch=4, t=32, steps=4)
    assert r["graphopt"] == COUNTS and r["graphdef_nodes"] == 314
    assert r["f32"]["losses"][-1] < r["f32"]["losses"][0]
    assert r["bf16"]["losses"][-1] < r["bf16"]["losses"][0]
    v = c.sd_bert_card_vs_cpu(torch, device="cpu", layers=1, batch=2, t=32)
    assert v["update_card_vs_cpu32"] < 1e-3
