"""The data-parallel SameDiff walk classifies ops by the op and its axis
attributes (``autodiff/samediff_dp.py``): ops that mix rows along the
batch axis gather the global rows, reductions over it combine exactly,
and remat segments run under a mesh. Held against the JAX package's mesh
runs (one global program on the forced host devices of
``tests/conftest.py``) on the same numpy inputs, on 2 and 4 replicas of
a thread mesh of CPU replicas, at the bars of
``tests/test_torch_sd_parallel.py``.

The C5 table: ``softmax``, ``log_softmax``, ``cumsum``, ``standardize``,
``concat`` and ``reverse`` along axis 0 each ran on one replica's rows
before the repair (max |mesh - one device| 0.285 to 2.6), and
``reduce_max`` / ``reduce_min`` over axis 0 raised.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from benchmarks.tf_bert_builder import \
    import_and_attach_mlm as j_attach  # noqa: E402
from deeplearning4j_tpu.autodiff.samediff import SameDiff as JSameDiff
from deeplearning4j_tpu.autodiff.training import \
    TrainingConfig as JTrainingConfig
from deeplearning4j_tpu.learning import Sgd as JSgd
from deeplearning4j_tpu_torch.autodiff import samediff_dp
from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff
from deeplearning4j_tpu_torch.autodiff.training import TrainingConfig
from deeplearning4j_tpu_torch.learning.updaters import Sgd
from deeplearning4j_tpu_torch.modelimport.tensorflow.bert_graph import (
    build_frozen_bert, import_and_attach_mlm)
from deeplearning4j_tpu_torch.parallel.mesh import make_mesh
from torch_parity import one_intraop_thread  # noqa: F401,E402

TIMEOUT_S = 60.0
#: tests/test_torch_sd_parallel.py's bars: DP against one device, and
#: outputs across the packages (float32 sums in other orders)
LOSS = dict(rtol=1e-5, atol=1e-7)
VARS = dict(rtol=1e-5, atol=1e-6)
BERT = dict(rtol=1e-4, atol=1e-5)
ACROSS = dict(rtol=2e-5, atol=1e-6)

ROWS, COLS = 8, 3


def _mesh(n):
    return make_mesh(devices=["cpu"] * n, timeout_s=TIMEOUT_S)


def _jmesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("data",))


#: each op along axis 0 (the batch) of placeholder x, named "o"
CASES = {
    "softmax": lambda sd, x: sd.nn.softmax(x, 0, name="o"),
    "log_softmax": lambda sd, x: sd.nn.log_softmax(x, 0, name="o"),
    "cumsum": lambda sd, x: sd.math.cumsum(x, 0, name="o"),
    "standardize": lambda sd, x: sd.math.standardize(x, 0, name="o"),
    "concat": lambda sd, x: sd.math.concat([x, x * 2.0], 0, name="o"),
    "reverse": lambda sd, x: sd.math.reverse(x, axes=[0], name="o"),
    "reduce_max": lambda sd, x: sd.math.reduce_max(x, axis=0, name="o"),
    "reduce_min": lambda sd, x: sd.math.reduce_min(x, axis=0, name="o"),
    # ops whose domain is element by element but that read the whole
    # tensor, or a loss along the batch axis
    "clip_by_norm": lambda sd, x: sd.math.clip_by_norm(x, clip_norm=1.0,
                                                       name="o"),
    "cosine_distance": lambda sd, x: sd.loss.cosine_distance(
        x, sd.math.tanh(x), axis=0, name="o"),
}


def _graph(cls, name, **kw):
    sd = cls(**kw)
    x = sd.placeholder("x", shape=(None, COLS))
    CASES[name](sd, x)
    return sd


@pytest.fixture(scope="module")
def x_in():
    return np.random.RandomState(0).randn(ROWS, COLS).astype(np.float32)


@pytest.fixture(scope="module")
def jax_mesh_outputs(x_in):
    """The JAX package's mesh outputs of every case on 2 and 4 devices,
    computed once a module."""
    return {(name, n): np.asarray(_graph(JSameDiff, name).output(
        {"x": x_in}, ["o"], mesh=_jmesh(n))["o"])
        for name in CASES for n in (2, 4)}


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", sorted(CASES))
def test_c5_op_matches_jax_mesh_and_one_device(name, n, x_in,
                                               jax_mesh_outputs):
    one = _graph(SameDiff, name, device="cpu").output({"x": x_in},
                                                      ["o"])["o"]
    got = _graph(SameDiff, name, device="cpu").output(
        {"x": x_in}, ["o"], mesh=_mesh(n))["o"]
    assert tuple(got.shape) == tuple(one.shape)
    # gathered ops run the one-device op on the global rows; max / min
    # are the replicas' results reduced: both bit for bit
    assert torch.equal(got, one)
    np.testing.assert_allclose(got.numpy(), jax_mesh_outputs[(name, n)],
                               **ACROSS)


def _walk(sd, ph, n, training=False, outputs=("o",)):
    ph_vals = sd._placeholders(ph)
    plan = sd._plan(tuple(outputs), tuple(ph_vals))
    sharded = samediff_dp.shard_placeholders(n, ph_vals)
    return samediff_dp.classify_walk(sd, plan.ops, ph_vals, sharded, n,
                                     training)


@pytest.mark.parametrize("name,kind", [
    ("softmax", "gather"), ("cumsum", "gather"), ("reverse", "gather"),
    ("clip_by_norm", "gather"), ("cosine_distance", "gather"),
    ("reduce_max", "max"), ("reduce_min", "min")])
def test_classification_by_op_and_axis(name, kind, x_in):
    sd = _graph(SameDiff, name, device="cpu")
    walk = _walk(sd, {"x": x_in}, 2)
    (idx,) = [i for i, op in enumerate(sd.ops) if op.outputs == ["o"]]
    if kind == "gather":
        assert idx in walk.gather and idx not in walk.reduce
    else:
        assert walk.reduce[idx] == kind and idx not in walk.gather


def test_row_wise_ops_stay_on_the_shard(x_in):
    """The same ops along the last axis are row-wise: no gather."""
    sd = SameDiff("cpu")
    x = sd.placeholder("x", shape=(None, COLS))
    sd.nn.softmax(sd.math.cumsum(x, -1), -1, name="o")
    walk = _walk(sd, {"x": x_in}, 2)
    assert not walk.gather and not walk.reduce
    assert "o" in walk.sharded


def test_unknown_op_gathers_rather_than_trusting_its_shape(x_in):
    """``reduce_logsumexp`` over the batch keeps no row and is no sum,
    mean, max or min: the walk gathers its input (it raised before), and
    an op the allow-list does not name (``segment_sum`` on the batch
    ids) gathers too."""
    sd = SameDiff("cpu")
    x = sd.placeholder("x", shape=(None, COLS))
    sd.math.reduce_logsumexp(x, axis=0, name="o")
    ids = sd.placeholder("ids", shape=(None,))
    sd.invoke("segment_sum", [x, ids], {"num_segments": 3}, name="seg")
    ph = {"x": x_in, "ids": (np.arange(ROWS) % 3).astype(np.int32)}
    walk = _walk(sd, ph, 2, outputs=("o", "seg"))
    assert len(walk.gather) == 2 and not walk.reduce
    one = sd.output(ph, ["o", "seg"])
    for n in (2, 4):
        got = sd.output(ph, ["o", "seg"], mesh=_mesh(n))
        for k in ("o", "seg"):
            assert torch.equal(got[k], one[k]), (k, n)


def _softmax_fit(cls, tc, sgd, **kw):
    rs = np.random.RandomState(0)
    xv = rs.randn(ROWS, COLS).astype(np.float32)
    yv = rs.rand(ROWS, 2).astype(np.float32)
    w0 = (rs.randn(COLS, 2) * 0.1).astype(np.float32)
    sd = cls(**kw)
    x = sd.placeholder("x", shape=(None, COLS))
    y = sd.placeholder("y", shape=(None, 2))
    w = sd.var("w", array=w0)
    sd.loss.mean_squared_error(y, sd.nn.softmax(x @ w, 0), name="loss")
    sd.set_loss_variables("loss")
    sd.set_training_config(
        tc.Builder().updater(sgd(0.5)).data_set_feature_mapping("x")
        .data_set_label_mapping("y").build())
    return sd, {"x": xv, "y": yv}


@pytest.fixture(scope="module")
def jax_softmax_fit():
    """The JAX package's 3-step losses and ``w``: one device, and a mesh
    of 2 and of 4."""
    out = {}
    for n in (None, 2, 4):
        sd, b = _softmax_fit(JSameDiff, JTrainingConfig, JSgd)
        loss = sd.fit_steps(b, 3, mesh=None if n is None else _jmesh(n))
        out[n] = float(loss), np.asarray(sd.get_variable("w").get_arr())
    return out


@pytest.mark.parametrize("n", [2, 4])
def test_softmax_over_the_batch_trains_as_one_device(n, jax_softmax_fit):
    """Three Sgd(0.5) steps of an MSE loss over ``softmax(x @ w, 0)``:
    every replica walked its own rows before the repair."""
    j_one, j_w = jax_softmax_fit[None]
    np.testing.assert_allclose(jax_softmax_fit[n][0], j_one, **LOSS)
    sd, b = _softmax_fit(SameDiff, TrainingConfig, Sgd, device="cpu")
    one = sd.fit_steps(b, 3)
    dp, _ = _softmax_fit(SameDiff, TrainingConfig, Sgd, device="cpu")
    got = dp.fit_steps(b, 3, mesh=_mesh(n), update_exchange="dense")
    np.testing.assert_allclose(got, one, **LOSS)
    np.testing.assert_allclose(got, jax_softmax_fit[n][0], **LOSS)
    np.testing.assert_allclose(dp._arrays["w"].numpy(), jax_softmax_fit[n][1],
                               **VARS)
    np.testing.assert_allclose(dp._arrays["w"].numpy(), j_w, **VARS)


def test_max_over_the_batch_trains_with_jax_ties():
    """The gradient of ``reduce_max`` over the batch goes to the rows
    that hold the global max, on any replica, split across ties as
    ``jnp.max`` splits it: rows 1 and 6 tie, on different replicas."""
    xv = np.array([[0.5], [2.0], [1.0], [-1.0], [0.0], [1.5], [2.0],
                   [0.25]], np.float32)

    def build(cls, tc, sgd, **kw):
        sd = cls(**kw)
        x = sd.placeholder("x", shape=(None, 1))
        w = sd.var("w", array=np.ones((1, 1), np.float32))
        m = sd.math.reduce_max(x * w, axis=0)
        sd.math.reduce_sum(m * m, name="loss")
        sd.set_loss_variables("loss")
        sd.set_training_config(tc.Builder().updater(sgd(0.05))
                               .data_set_feature_mapping("x").build())
        return sd

    jsd = build(JSameDiff, JTrainingConfig, JSgd)
    jloss = float(jsd.fit_steps({"x": xv}, 2, mesh=_jmesh(2)))
    sd = build(SameDiff, TrainingConfig, Sgd, device="cpu")
    loss = sd.fit_steps({"x": xv}, 2, mesh=_mesh(2))
    np.testing.assert_allclose(loss, jloss, **LOSS)
    np.testing.assert_allclose(sd._arrays["w"].numpy(),
                               np.asarray(jsd.get_variable("w").get_arr()),
                               **VARS)


# -- the imported BERT: the attention sites stay shards; remat on a mesh ----
V, H, HEADS, LAYERS, T, B, K = 50, 16, 2, 2, 16, 8, 4


@pytest.fixture(scope="module")
def bert():
    """The frozen BERT's bytes, tests/test_torch_sd_parallel.py's MLM
    batch (ignored labels uneven across the shards), and the JAX
    package's 3 Sgd steps on 2 devices with 2 remat segments."""
    gd = build_frozen_bert(T, B, vocab=V, hidden=H, heads=HEADS,
                           layers=LAYERS, intermediate=32)
    rs = np.random.RandomState(2)
    labels = rs.randint(0, V, (B, K)).astype(np.int32)
    labels[:B // 2, 1:] = -1
    mask = np.ones((B, T), np.int32)
    mask[1, T - 5:] = 0
    batch = {"ids": rs.randint(0, V, (B, T)).astype(np.int32),
             "seg": np.zeros((B, T), np.int32), "mask": mask,
             "mlm_positions": np.stack([rs.choice(T - 5, K, replace=False)
                                        for _ in range(B)]).astype(np.int32),
             "mlm_labels": labels}
    jsd, _ = j_attach(gd, B, T, vocab=V, hidden=H, updater=JSgd(0.5),
                      max_predictions=K)
    jsd.set_remat_segments(2)
    jloss = float(jsd.fit_steps(batch, 3, mesh=_jmesh(2)))
    jvars = {n: np.asarray(v.get_arr()) for n, v in jsd.vars.items()
             if v.var_type.value == "VARIABLE"}
    return gd, batch, jloss, jvars


def _port_bert(gd):
    return import_and_attach_mlm(gd, B, T, vocab=V, hidden=H,
                                 updater=Sgd(0.5), max_predictions=K,
                                 device="cpu")[0]


def test_bert_attention_sites_stay_shards(bert):
    """The repair reclassifies nothing of the imported BERT: no op is
    gathered, the attention sites (``sdpa_core``) run on each replica's
    rows, and only the two loss sums are all-reduced."""
    gd, batch, _, _ = bert
    sd = _port_bert(gd)
    ph_vals = sd._placeholders(batch)
    plan = sd._plan(tuple(sd.loss_variables), tuple(ph_vals))
    sharded = samediff_dp.shard_placeholders(
        2, ph_vals, samediff_dp._batch_names(sd))
    walk = samediff_dp.classify_walk(sd, plan.ops, ph_vals, sharded, 2,
                                     True)
    assert not walk.gather
    sdpa = [o for i in plan.ops for o in sd.ops[i].outputs
            if sd.ops[i].op_name == "sdpa_core"]
    assert len(sdpa) == LAYERS and all(o in walk.sharded for o in sdpa)
    assert sorted(walk.reduce.values()) == ["sum", "sum"]


def test_remat_segments_under_a_mesh_match_jax(bert):
    """``fit_steps(mesh=)`` with ``remat_segments=2`` (it raised before):
    the JAX package's mesh run, and the port's unsegmented mesh run bit
    for bit."""
    gd, batch, jloss, jvars = bert
    dp = _port_bert(gd)
    dp.set_remat_segments(2)
    l_dp = dp.fit_steps(batch, 3, mesh=_mesh(2), update_exchange="dense")
    np.testing.assert_allclose(l_dp, jloss, **BERT)
    for name, want in jvars.items():
        np.testing.assert_allclose(dp._arrays[name].numpy(), want,
                                   err_msg=name, **BERT)
    plain = _port_bert(gd)
    l_plain = plain.fit_steps(batch, 3, mesh=_mesh(2),
                              update_exchange="dense")
    assert l_dp == l_plain
    for name in jvars:
        assert torch.equal(dp._arrays[name], plain._arrays[name]), name
