"""Data-parallel ``SameDiff.output(mesh=)`` and ``fit_steps(mesh=)`` in the
port (``autodiff/samediff_dp.py``) on thread meshes of CPU replicas,
against the JAX package's single-device runs on the same numpy inputs.

Ported: the mesh cases of ``tests/test_samediff.py`` (the DP trajectory,
a scalar placeholder replicated, DP inference, a non-batch placeholder
replicated while an indivisible batch raises), ``tests/test_fsdp.py``'s
SameDiff case (fsdp against dense, and a second fsdp window resuming),
and the imported BERT trained data-parallel of
``tests/test_tf_import_bert_base.py`` (2 layers, hidden 16), on 2 and 4
replicas, with an MLM batch whose ignored labels (-1) fall unevenly
across the shards: the loss divides the global sums, so the port's DP
loss and variables hold the JAX single-device run at JAX's bars (rtol
1e-4 / atol 1e-5). The dense, ZeRO-1 and fsdp exchanges give the port's
own single-device run within those bars; the encoded exchange trains.
"""
import logging

import numpy as np
import pytest
import torch

from benchmarks.tf_bert_builder import \
    import_and_attach_mlm as j_attach  # noqa: E402
from deeplearning4j_tpu.autodiff.samediff import SameDiff as JSameDiff
from deeplearning4j_tpu.autodiff.training import \
    TrainingConfig as JTrainingConfig
from deeplearning4j_tpu.learning import Adam as JAdam
from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff
from deeplearning4j_tpu_torch.autodiff.training import TrainingConfig
from deeplearning4j_tpu_torch.learning.updaters import Adam
from deeplearning4j_tpu_torch.modelimport.tensorflow.bert_graph import (
    build_frozen_bert, import_and_attach_mlm)
from deeplearning4j_tpu_torch.parallel.mesh import make_mesh
from torch_parity import one_intraop_thread  # noqa: F401,E402

TIMEOUT_S = 60.0
#: the JAX package's bars for DP against one device
LOSS = dict(rtol=1e-5, atol=1e-7)
VARS = dict(rtol=1e-5, atol=1e-6)
BERT = dict(rtol=1e-4, atol=1e-5)


def _mesh(n):
    return make_mesh(devices=["cpu"] * n, timeout_s=TIMEOUT_S)


def _regression(cls, tc, up, **kw):
    sd = cls(**kw)
    x = sd.placeholder("x", shape=(None, 2))
    y = sd.placeholder("y", shape=(None, 1))
    w = sd.var("w", array=np.zeros((2, 1), np.float32))
    b = sd.var("b", array=np.zeros((1,), np.float32))
    sd.loss.mean_squared_error(y, x @ w + b, name="loss")
    sd.set_loss_variables("loss")
    sd.set_training_config(
        tc.Builder().updater(up(0.1)).data_set_feature_mapping("x")
        .data_set_label_mapping("y").build())
    return sd


def _port():
    return _regression(SameDiff, TrainingConfig, Adam, device="cpu")


def _batch(n=64):
    rng = np.random.RandomState(0)
    xv = rng.randn(n, 2).astype(np.float32)
    yv = (xv @ np.array([[2.0], [-3.0]], np.float32)) + 0.5
    return {"x": xv, "y": yv}


@pytest.fixture(scope="module")
def jax_single():
    """The JAX package's single-device six-step run."""
    sd = _regression(JSameDiff, JTrainingConfig, JAdam)
    loss = sd.fit_steps(_batch(), 6)
    return float(loss), {n: np.asarray(sd.get_variable(n).get_arr())
                         for n in ("w", "b")}


@pytest.mark.parametrize("mode", ["dense", "sharded", "fsdp"])
@pytest.mark.parametrize("n", [2, 4])
def test_fit_steps_data_parallel_matches_single_device(n, mode,
                                                       jax_single):
    batch = _batch()
    single = _port()
    l_single = single.fit_steps(batch, 6)
    dp = _port()
    l_dp = dp.fit_steps(batch, 6, mesh=_mesh(n), update_exchange=mode)
    np.testing.assert_allclose(l_dp, jax_single[0], **LOSS)
    for v in ("w", "b"):
        np.testing.assert_allclose(dp._arrays[v].numpy(), jax_single[1][v],
                                   **VARS)
        np.testing.assert_allclose(dp._arrays[v].numpy(),
                                   single._arrays[v].numpy(), **VARS)
    np.testing.assert_allclose(l_dp, l_single, **LOSS)
    assert dp.iteration_count == 6
    with pytest.raises(ValueError, match="divisible"):
        dp.fit_steps({"x": batch["x"][:61], "y": batch["y"][:61]}, 1,
                     mesh=_mesh(n))


@pytest.mark.parametrize("first", ["encoded", "fsdp"])
def test_exchange_windows_chain(first):
    """A window of the compressed exchange (or of fsdp, the variables
    densified after it) trains; a dense window and a one-device window
    resume from it (the encoded residual dropped), and the loss keeps
    falling."""
    sd = _port()
    mesh = _mesh(2)
    l0 = sd.fit_steps(_batch(), 4, mesh=mesh, update_exchange=first,
                      encoding="threshold")
    l1 = sd.fit_steps(_batch(), 4, mesh=mesh, update_exchange="dense")
    l2 = sd.fit_steps(_batch(), 4)
    assert np.isfinite([l0, l1, l2]).all() and l2 < l1 < l0
    assert sd.iteration_count == 12


def test_dropout_draws_the_one_device_masks_on_each_shard():
    """A random op whose output is a shard draws the global rows from its
    key and keeps its own: the DP training output equals the one-device
    one bit for bit."""
    def build():
        sd = SameDiff("cpu")
        x = sd.placeholder("x", shape=(None, 5))
        w = sd.var("w", array=np.eye(5, dtype=np.float32))
        sd.nn.dropout(x @ w, 0.5, name="drop")
        return sd

    xv = np.random.RandomState(3).randn(8, 5).astype(np.float32)
    want = build().output({"x": xv}, ["drop"], training=True)["drop"]
    got = build().output({"x": xv}, ["drop"], training=True,
                         mesh=_mesh(4))["drop"]
    assert torch.equal(got, want) and bool((want == 0).any())


def test_fit_steps_data_parallel_replicates_scalar_placeholder():
    sd = SameDiff("cpu")
    x = sd.placeholder("x", shape=(None, 2))
    y = sd.placeholder("y", shape=(None, 1))
    s = sd.placeholder("s", shape=())
    w = sd.var("w", array=np.zeros((2, 1), np.float32))
    sd._op("mul", [sd.loss.mean_squared_error(y, x @ w), s]) \
        .rename("sloss")
    sd.set_loss_variables("sloss")
    sd.set_training_config(
        TrainingConfig.Builder().updater(Adam(0.1))
        .data_set_feature_mapping("x").data_set_label_mapping("y").build())
    b = _batch()
    loss = sd.fit_steps({**b, "s": np.float32(1.0)}, 5, mesh=_mesh(4))
    assert np.isfinite(loss)


def test_output_data_parallel_matches_single_device_and_jax():
    def build(cls, **kw):
        sd = cls(**kw)
        x = sd.placeholder("x", shape=(None, 4))
        w = sd.var("w", array=np.arange(8, dtype=np.float32).reshape(4, 2))
        sd.nn.softmax(x @ w, name="probs")
        sd.math.reduce_sum(x @ w, name="total")
        return sd

    xv = np.random.RandomState(0).randn(64, 4).astype(np.float32)
    sd = build(SameDiff, device="cpu")
    want = sd.output({"x": xv}, ["probs", "total"])
    got = sd.output({"x": xv}, ["probs", "total"], mesh=_mesh(4))
    np.testing.assert_allclose(got["probs"].numpy(),
                               want["probs"].numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got["total"].numpy(),
                               want["total"].numpy(), rtol=1e-6)
    # across the packages: float32 products summed in other orders
    jwant = build(JSameDiff).output({"x": xv}, ["probs"])["probs"]
    np.testing.assert_allclose(got["probs"].numpy(), jwant, rtol=2e-5,
                               atol=1e-6)


def test_fit_steps_mesh_replicates_non_batch_placeholder(caplog):
    """A placeholder whose leading dimension is not the batch's
    replicates (the vote warns about it, as the JAX package does); the
    batch stays guarded."""
    sd = SameDiff("cpu")
    x = sd.placeholder("x", shape=(None, 2))
    y = sd.placeholder("y", shape=(None, 1))
    cw = sd.placeholder("cw", shape=(3,))
    w = sd.var("w", array=np.zeros((2, 1), np.float32))
    err = sd.loss.mean_squared_error(y, x @ w)
    sd._op("mul", [err, sd.math.reduce_sum(cw)]).rename("loss")
    sd.set_loss_variables("loss")
    sd.set_training_config(TrainingConfig.Builder().updater(Adam(0.1))
                           .build())
    b = _batch()
    with caplog.at_level(logging.WARNING, "deeplearning4j_tpu_torch"):
        loss = sd.fit_steps({**b, "cw": np.ones(3, np.float32) / 3}, 5,
                            mesh=_mesh(4))
    assert np.isfinite(loss)
    assert "cw" in caplog.text
    with pytest.raises(ValueError, match="divisible"):
        sd.fit_steps({"x": b["x"][:60], "y": b["y"][:60],
                      "cw": np.ones(3, np.float32)}, 1, mesh=_mesh(8))


@pytest.mark.parametrize("spec", ["data", ("data",), ("data", None)])
def test_ph_specs_tuple_forms(spec):
    """An explicit spec shards a placeholder the vote would leave
    replicated; every form gives the one-device step."""
    def build():
        sd = _port()
        sd.training_config.data_set_feature_mapping = []
        sd.training_config.data_set_label_mapping = []
        return sd

    b = _batch(8)
    b["y"] = b["y"].reshape(8, 1)
    single = build()
    single.fit_steps(b, 2)
    dp = build()
    dp.fit_steps(b, 2, mesh=_mesh(2), ph_specs={"x": spec, "y": spec})
    np.testing.assert_allclose(dp._arrays["w"].numpy(),
                               single._arrays["w"].numpy(), **VARS)


def test_tensor_parallel_arguments_name_item_12():
    sd = _port()
    with pytest.raises(NotImplementedError, match="item 12"):
        sd.fit_steps(_batch(), 1, mesh=_mesh(2), tp_specs={"w": "model"})
    with pytest.raises(NotImplementedError, match="item 12"):
        sd.fit_steps(_batch(), 1, mesh=_mesh(2), ph_specs={"x": "model"})


# -- the imported BERT, data-parallel ---------------------------------------
V, H, HEADS, LAYERS, T, B, K = 50, 16, 2, 2, 16, 8, 4


@pytest.fixture(scope="module")
def bert():
    """The frozen BERT's bytes, an MLM batch whose ignored labels are
    uneven across the shards (rows 0-3 keep one label each, rows 4-7 all
    four), and the JAX package's single-device 8-step losses and final
    variables."""
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
    jsd, _ = j_attach(gd, B, T, vocab=V, hidden=H, updater=JAdam(1e-2),
                      max_predictions=K)
    jloss = float(jsd.fit_steps(batch, 8))
    jvars = {n: np.asarray(v.get_arr()) for n, v in jsd.vars.items()
             if v.var_type.value == "VARIABLE"}
    return gd, batch, jloss, jvars


def _port_bert(gd):
    return import_and_attach_mlm(gd, B, T, vocab=V, hidden=H,
                                 updater=Adam(1e-2), max_predictions=K,
                                 device="cpu")[0]


@pytest.mark.parametrize("n", [2, 4])
def test_imported_bert_trains_data_parallel(n, bert):
    gd, batch, jloss, jvars = bert
    # the shards' own ratios differ from the global one: a mean of them
    # would not be the loss
    valid = (batch["mlm_labels"] >= 0).reshape(n, -1).sum(1)
    assert len(set(valid.tolist())) > 1
    dp = _port_bert(gd)
    l_dp = dp.fit_steps(batch, 8, mesh=_mesh(n), update_exchange="sharded")
    np.testing.assert_allclose(l_dp, jloss, **BERT)
    assert dp.vars.keys() >= jvars.keys()
    for name, want in jvars.items():
        np.testing.assert_allclose(dp._arrays[name].numpy(), want,
                                   err_msg=name, **BERT)
    # the global result of a DP forward is the one-device forward's
    feeds = {k: batch[k] for k in ("ids", "seg", "mask")}
    one = _port_bert(gd).output(feeds, ["Identity"])["Identity"]
    got = _port_bert(gd).output(feeds, ["Identity"], mesh=_mesh(n))
    assert torch.equal(got["Identity"], one)


def test_imported_bert_first_step_loss_is_the_global_ratio(bert):
    """Step 1's DP loss is the global ``Σ(xent·valid) / Σ valid``, the
    one-device loss, and not the mean of the shards' ratios."""
    gd, batch, _, _ = bert
    one = _port_bert(gd)
    xent = one.output(batch, ["sparse_softmax_cross_entropy"])[
        "sparse_softmax_cross_entropy"].double().numpy()
    valid = (batch["mlm_labels"] >= 0).astype(np.float64)
    ratio = (xent * valid).sum() / valid.sum()
    halves = [slice(0, B // 2), slice(B // 2, B)]
    shard_mean = np.mean([(xent * valid)[h].sum() / valid[h].sum()
                          for h in halves])
    assert abs(shard_mean - ratio) > 1e-3 * ratio
    l_one = one.fit_steps(batch, 1)
    l_dp = _port_bert(gd).fit_steps(batch, 1, mesh=_mesh(2),
                                    update_exchange="dense")
    np.testing.assert_allclose(l_dp, ratio, rtol=1e-6)
    np.testing.assert_allclose(l_dp, l_one, rtol=1e-6)
