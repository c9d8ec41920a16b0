"""SameDiff program export in the port (``to_stablehlo``,
``export_serialized``, ``deserialize_and_call`` on ``torch.export``)
against the JAX package's, on the CPU.

The four cases of ``tests/test_stablehlo_export.py`` (the program's
text, shapes given by ``meta`` tensors where JAX takes a
``ShapeDtypeStruct``, the serialized round trip, a bounded loop) hold
the loaded program to the JAX package's answers on the same numpy
inputs (rtol 1e-6; 1e-5 through the loop). Beside them: an unbounded
loop and a ``cond`` lower to torch's control-flow operators, so the
loaded program's trip count and branch follow its inputs; an op that
cannot be lowered raises naming it; a dropout program called with seed
``s`` draws what the graph's walk draws from ``RngKey(s)``; a blob
loads in a fresh interpreter that has imported the port; the imported
BERT's program names kernel 7's op once a layer and holds no softmax;
and ``torch.library.opcheck`` passes for the three flash ops on CPU
tensors.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.autodiff.samediff import SameDiff as JSameDiff
from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff
from deeplearning4j_tpu_torch.common.environment import Environment
from deeplearning4j_tpu_torch.common.rng import RngKey
from deeplearning4j_tpu_torch.parallel import sequence

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXACT = dict(rtol=1e-6, atol=1e-7)
LOOP = dict(rtol=1e-5, atol=1e-6)


def _toy(cls, **kw):
    sd = cls(**kw)
    x = sd.placeholder("x", (4, 3))
    w = sd.var("w", array=np.float32(np.ones((3, 2))))
    y = sd.math.matmul(x, w)
    sd.math.tanh(y, name="out")
    return sd


def _x(seed=0, shape=(4, 3)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_text_contains_program():
    txt = _toy(SameDiff, device="cpu").to_stablehlo(
        {"x": np.zeros((4, 3), np.float32)}, ["out"])
    assert "aten.mm" in txt or "aten.matmul" in txt
    assert "aten.tanh" in txt


def test_meta_tensor_inputs_give_the_shapes():
    """A tensor on the meta device stands where JAX takes a
    ShapeDtypeStruct: the program is traced at its shape."""
    txt = _toy(SameDiff, device="cpu").to_stablehlo(
        {"x": torch.empty(8, 3, device="meta")}, ["out"])
    assert "f32[8, 3]" in txt


def test_serialized_roundtrip_matches_output_and_jax():
    sd = _toy(SameDiff, device="cpu")
    xv = _x()
    want = sd.output({"x": xv}, ["out"])["out"]
    blob = sd.export_serialized({"x": xv}, ["out"])
    assert isinstance(blob, bytes) and len(blob) > 100
    got = SameDiff.deserialize_and_call(blob, {"x": xv})
    assert isinstance(got, list) and len(got) == 1
    np.testing.assert_allclose(got[0].numpy(), want.numpy(), **EXACT)
    jsd = _toy(JSameDiff)
    jgot = JSameDiff.deserialize_and_call(
        jsd.export_serialized({"x": xv}, ["out"]), {"x": xv})
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jgot[0]),
                               **EXACT)


def _bounded_loop(cls, **kw):
    sd = cls(**kw)
    x = sd.placeholder("x", (3,))

    def cond(i, acc):
        return i.sd.math.lt(i, i.sd._as_var(np.int32(4)))

    def body(i, acc):
        return (i.sd.math.add(i, i.sd._as_var(np.int32(1))), acc * 1.5)

    outs = sd.while_loop([sd._as_var(np.int32(0)), x], cond, body,
                         max_iterations=8)
    sd.math.reduce_sum(outs[1], name="out")
    return sd


def test_control_flow_exports():
    """A bounded while-loop subgraph exports into the same program, to
    the JAX package's answer."""
    xv = np.float32([1.0, 2.0, 3.0])
    sd = _bounded_loop(SameDiff, device="cpu")
    want = sd.output({"x": xv}, ["out"])["out"]
    got = SameDiff.deserialize_and_call(
        sd.export_serialized({"x": xv}, ["out"]), {"x": xv})
    np.testing.assert_allclose(got[0].numpy(), want.numpy(), **LOOP)
    jsd = _bounded_loop(JSameDiff)
    jgot = JSameDiff.deserialize_and_call(
        jsd.export_serialized({"x": xv}, ["out"]), {"x": xv})
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jgot[0]), **LOOP)


def _counted_loop(cls, **kw):
    """An unbounded loop whose trip count is the placeholder ``n``."""
    sd = cls(**kw)
    x = sd.placeholder("x", (3,))
    n = sd.placeholder("n", (), "int32")

    def cond(i, acc):
        return i.sd.math.lt(i, n)

    def body(i, acc):
        return (i.sd.math.add(i, i.sd._as_var(np.int32(1))), acc * 1.5)

    outs = sd.while_loop([sd._as_var(np.int32(0)), x], cond, body)
    sd.math.reduce_sum(outs[1], name="out")
    return sd


def test_loop_trip_count_follows_a_second_input():
    """Exported at n = 3 and called at n = 1, 3 and 6: each answer is the
    graph's own at that n; at 1 and 6 the JAX package's too."""
    xv = np.float32([1.0, 2.0, 3.0])
    sd = _counted_loop(SameDiff, device="cpu")
    blob = sd.export_serialized({"x": xv, "n": np.int32(3)}, ["out"])
    assert "while_loop" in sd.to_stablehlo({"x": xv, "n": np.int32(3)},
                                           ["out"])
    jsd = _counted_loop(JSameDiff)
    for n in (1, 3, 6):
        feed = {"x": xv, "n": np.int32(n)}
        got = SameDiff.deserialize_and_call(blob, feed)[0]
        want = sd.output(feed, ["out"])["out"]
        np.testing.assert_allclose(got.numpy(), want.numpy(), **LOOP)
        if n != 3:
            np.testing.assert_allclose(
                got.numpy(), np.asarray(jsd.output(feed, ["out"])["out"]),
                **LOOP)


def test_cond_branch_follows_its_predicate():
    sd = SameDiff("cpu")
    x = sd.placeholder("x", (3,))
    p = sd.placeholder("p", (), "bool")
    sd.cond(p, lambda a: a * 2.0, lambda a: a - 1.0, [x], name="out")
    xv = np.float32([1.0, -2.0, 3.0])
    blob = sd.export_serialized({"x": xv, "p": np.bool_(True)}, ["out"])
    for pv in (True, False):
        feed = {"x": xv, "p": np.bool_(pv)}
        np.testing.assert_array_equal(
            SameDiff.deserialize_and_call(blob, feed)[0].numpy(),
            sd.output(feed, ["out"])["out"].numpy())


def test_a_loop_that_cannot_be_lowered_names_its_op():
    """A loop whose carry changes shape has no torch ``while_loop``
    form: export raises naming the op, never one unrolled trip count."""
    sd = SameDiff("cpu")
    x = sd.placeholder("x", (2,))
    n = sd.placeholder("n", (), "int32")

    def cond(i, acc):
        return i.sd.math.lt(i, n)

    def body(i, acc):
        return (i.sd.math.add(i, i.sd._as_var(np.int32(1))),
                i.sd.math.concat([acc, acc], 0))

    sd.while_loop([sd._as_var(np.int32(0)), x], cond, body, name="grow")
    with pytest.raises(RuntimeError, match="grow"):
        sd.export_serialized({"x": np.ones(2, np.float32),
                              "n": np.int32(1)}, ["grow:1"])


def _dropout_graph():
    sd = SameDiff("cpu")
    x = sd.placeholder("x", (6, 5))
    w = sd.var("w", array=np.float32(np.eye(5)))
    sd.nn.dropout(x @ w, 0.5, name="drop")
    return sd


def test_seeded_dropout_program_draws_the_walks_masks():
    """A training program with dropout, called with seed s, equals the
    graph's walk from ``RngKey(s)``; another seed draws another mask."""
    sd = _dropout_graph()
    xv = _x(1, (6, 5))
    blob = sd.export_serialized({"x": xv}, ["drop"], training=True)
    plan = sd._plan(("drop",), ("x",))
    ph = sd._placeholders({"x": xv})
    var = {n: sd._arrays[n] for n in plan.variables}
    outs = {}
    for s in (3, 11):
        got = SameDiff.deserialize_and_call(blob, {"x": xv}, seed=s)[0]
        want = sd._run(plan, var, ph, ["drop"], training=True,
                       rng=RngKey(s))[0]
        assert torch.equal(got, want)
        outs[s] = got
    assert not torch.equal(outs[3] == 0, outs[11] == 0)
    # inference export: dropout is the identity
    inf = SameDiff.deserialize_and_call(
        sd.export_serialized({"x": xv}, ["drop"]), {"x": xv}, seed=3)[0]
    np.testing.assert_allclose(inf.numpy(), xv, **EXACT)


def test_blob_loads_in_a_fresh_interpreter(tmp_path):
    sd = _toy(SameDiff, device="cpu")
    xv = _x(2)
    path = tmp_path / "prog.pt2"
    path.write_bytes(sd.export_serialized({"x": xv}, ["out"]))
    np.save(tmp_path / "x.npy", xv)
    code = (
        "import sys, numpy as np, torch\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff\n"
        f"blob = open({str(path)!r}, 'rb').read()\n"
        f"x = np.load({str(tmp_path / 'x.npy')!r})\n"
        "out = SameDiff.deserialize_and_call(blob, {'x': x})[0]\n"
        f"np.save({str(tmp_path / 'out.npy')!r}, out.numpy())\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=str(tmp_path))
    np.testing.assert_allclose(np.load(tmp_path / "out.npy"),
                               sd.output({"x": xv}, ["out"])["out"].numpy(),
                               **EXACT)


def test_imported_bert_program_names_the_flash_op(monkeypatch):
    """On the flash route (forced on the CPU, as the card takes it) the
    imported BERT's program calls ``dl4j::flash_fwd`` once a layer and
    holds no softmax; the loaded program equals ``output``."""
    from deeplearning4j_tpu_torch.modelimport.tensorflow import \
        TensorflowFrameworkImporter
    from deeplearning4j_tpu_torch.modelimport.tensorflow.bert_graph import \
        build_frozen_bert
    monkeypatch.setenv("DL4J_TORCH_FLASH_ATTENTION", "1")
    Environment.reset()
    try:
        b, t, layers = 2, 8, 2
        gd = build_frozen_bert(t, b, vocab=30, hidden=16, heads=2,
                               layers=layers, intermediate=32)
        shapes = {n: (b, t) for n in ("ids", "seg", "mask")}
        sd = TensorflowFrameworkImporter.run_import(gd, shapes, device="cpu")
        rs = np.random.RandomState(5)
        mask = np.ones((b, t), np.int32)
        mask[1, 5:] = 0
        feed = {"ids": rs.randint(0, 30, (b, t)).astype(np.int32),
                "seg": np.zeros((b, t), np.int32), "mask": mask}
        txt = sd.to_stablehlo(feed, ["Identity"])
        assert txt.count("torch.ops.dl4j.flash_fwd.default") == layers
        assert "softmax" not in txt
        got = SameDiff.deserialize_and_call(
            sd.export_serialized(feed, ["Identity"]), feed)[0]
        want = sd.output(feed, ["Identity"])["Identity"]
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5,
                                   atol=2e-6)
    finally:
        Environment.reset()


def _flash_operands(grad: bool):
    rs = np.random.RandomState(7)

    def t(*shape):
        return torch.from_numpy(rs.randn(*shape).astype(np.float32)) \
            .requires_grad_(grad)

    q, k, v = t(2, 2, 5, 8), t(2, 2, 6, 8), t(2, 2, 6, 8)
    mask = torch.ones(2, 6)
    mask[0, 4:] = 0
    return q, k, v, mask


@pytest.mark.parametrize("op", ["flash_fwd", "flash_bwd_dq",
                                "flash_bwd_dkv"])
def test_flash_ops_pass_opcheck(op):
    """The fake rules, the schemas and the forward op's autograd rule
    (``torch.library.opcheck``), on CPU tensors."""
    q, k, v, mask = _flash_operands(op == "flash_fwd")
    if op == "flash_fwd":
        args = (q, k, v, mask, False)
    else:
        out, lse = sequence.flash_forward_plain(q, k, v, mask)
        dout = torch.randn_like(out)
        delta = sequence.flash_delta(out, dout)
        args = (q, k, v, dout, lse, delta, mask, False)
    torch.library.opcheck(getattr(torch.ops.dl4j, op).default, args)
