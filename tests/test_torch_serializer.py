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
