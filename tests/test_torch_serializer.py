"""The port's ModelSerializer against the JAX package's: a zip written by
the port carries its updater state in the reference's layout (by
default, as ``write_model(..., save_updater=True)`` does there), and the
JAX package restores the same state from it.
"""
from __future__ import annotations

import zipfile

import numpy as np
import pytest

from deeplearning4j_tpu.utils.serializer import \
    ModelSerializer as JaxSerializer
from deeplearning4j_tpu.utils.serializer import _tree_to_flat_dict
from deeplearning4j_tpu_torch.learning.updaters import Adam, Nesterovs
from deeplearning4j_tpu_torch.models.zoo import ResNet50
from deeplearning4j_tpu_torch.utils.serializer import (
    UPDATER_ENTRY, ModelSerializer, params_to_jax, updater_state_to_jax)
from torch_parity import one_intraop_thread  # noqa: F401,E402

SMALL = dict(STAGES=((1, 8), (1, 16)), height=32, width=32, num_classes=10)


def _trained_graph(updater, steps: int = 2):
    """A small ResNet-50-shaped ComputationGraph after ``steps`` fit
    steps on seeded batches, so every updater slot is non-zero."""
    net = ResNet50(updater=updater, **SMALL).init("cpu")
    r = np.random.RandomState(11)
    for _ in range(steps):
        x = r.randn(4, 32, 32, 3).astype(np.float32)
        y = np.eye(10, dtype=np.float32)[r.randint(0, 10, 4)]
        net.fit(x, y)
    return net


@pytest.mark.parametrize("updater", [Adam(1e-3), Nesterovs(0.1, 0.9)],
                         ids=["adam", "nesterovs"])
def test_write_model_saves_the_updater_state_the_reference_restores(
        tmp_path, updater):
    net = _trained_graph(updater)
    path = tmp_path / "graph.zip"
    ModelSerializer.write_model(net, path)
    with zipfile.ZipFile(path) as zf:
        assert UPDATER_ENTRY in zf.namelist()
    want = updater_state_to_jax(net.updater_states, net.conf)
    assert want and any(np.abs(a).max() > 0 for a in want.values())
    jnet = JaxSerializer.restore_model(str(path))
    got = _tree_to_flat_dict(jnet.updater_states)
    assert set(want) <= set(got)
    for key, a in want.items():
        np.testing.assert_array_equal(np.asarray(got[key]), a, err_msg=key)
    assert jnet.iteration_count == net.iteration_count == 2


def test_write_model_without_the_updater_writes_no_entry(tmp_path):
    net = _trained_graph(Adam(1e-3))
    path = tmp_path / "graph.zip"
    ModelSerializer.write_model(net, path, save_updater=False)
    with zipfile.ZipFile(path) as zf:
        assert UPDATER_ENTRY not in zf.namelist()
    jnet = JaxSerializer.restore_model(str(path))
    want = params_to_jax(net.params, net.conf)
    got = _tree_to_flat_dict(jnet.params)
    for key, a in want.items():
        np.testing.assert_array_equal(np.asarray(got[key]), a, err_msg=key)
    # the reference's fresh updater: nothing was carried over
    assert all(not np.abs(np.asarray(a)).any()
               for a in _tree_to_flat_dict(jnet.updater_states).values())


def _surface_conf(pkg):
    """A small MLN with the training surface in its configuration: a
    schedule as Adam's learning rate, two dropout variants, weight
    noise and remat segments (the same builder calls in both
    packages)."""
    if pkg == "jax":
        from deeplearning4j_tpu.activations import Activation as A
        from deeplearning4j_tpu.learning import schedules as S
        from deeplearning4j_tpu.learning.updaters import Adam as U
        from deeplearning4j_tpu.nn.conf import dropout as D
        from deeplearning4j_tpu.nn.conf import layers as L
        from deeplearning4j_tpu.nn.conf.builders import \
            NeuralNetConfiguration as N
        from deeplearning4j_tpu.nn.conf.inputs import InputType as I
    else:
        from deeplearning4j_tpu_torch.activations import Activation as A
        from deeplearning4j_tpu_torch.learning import schedules as S
        from deeplearning4j_tpu_torch.learning.updaters import Adam as U
        from deeplearning4j_tpu_torch.nn.conf import dropout as D
        from deeplearning4j_tpu_torch.nn.conf import layers as L
        from deeplearning4j_tpu_torch.nn.conf.builders import \
            NeuralNetConfiguration as N
        from deeplearning4j_tpu_torch.nn.conf.inputs import InputType as I
    return (N.Builder().seed(3).remat_segments(2)
            .updater(U(S.WarmupSchedule(2, S.ExponentialSchedule(1e-2,
                                                                 0.9))))
            .list()
            .layer(L.ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                                      activation=A.RELU,
                                      weight_noise=D.WeightNoise(0.01)))
            .layer(L.DenseLayer(n_out=8, activation=A.TANH,
                                dropout=D.SpatialDropout(0.8)))
            .layer(L.OutputLayer(n_out=3,
                                 dropout=D.GaussianDropout(0.1)))
            .set_input_type(I.convolutional(6, 6, 2)).build())


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_zip_with_the_training_surface_restores_in_the_other_package(
        tmp_path, writer):
    """Trained two steps by one package, written, restored by the other:
    the same configuration JSON, parameters and iteration, and the
    restored model trains on."""
    import json

    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    r = np.random.RandomState(2)
    x = r.randn(4, 6, 6, 2).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[r.randint(0, 3, 4)]
    path = tmp_path / "mln.zip"
    if writer == "port":
        net = MultiLayerNetwork(_surface_conf("port")).init("cpu")
        for _ in range(2):
            net.fit(x, y)
        ModelSerializer.write_model(net, path)
        back = JaxSerializer.restore_model(str(path))
        want = params_to_jax(net.params, net.conf)
        got = _tree_to_flat_dict(back.params)
        conf, back_conf = net.conf, back.conf
    else:
        net = JMLN(_surface_conf("jax")).init()
        for _ in range(2):
            net.fit(x, y)
        JaxSerializer.write_model(net, str(path), save_updater=True)
        back = ModelSerializer.restore_model(path, device="cpu")
        want = _tree_to_flat_dict(net.params)
        got = params_to_jax(back.params, back.conf)
        conf, back_conf = net.conf, back.conf
    assert json.loads(back_conf.to_json()) == json.loads(conf.to_json())
    assert back_conf.remat_segments == 2
    for key, a in want.items():
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(a),
                                      err_msg=key)
    assert back.iteration_count == 2
    back.fit(x, y)
    assert np.isfinite(float(back.score()))
