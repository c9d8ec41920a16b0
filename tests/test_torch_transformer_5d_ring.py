"""The port's distributed Transformer LM against the JAX package's, in
the ring-CP layouts: mesh ``{data: 1, pipe: 2, seq: 2, model: 2}`` (ring
attention over ``seq`` with the flash kernels' plain versions merged
through their log-sum-exps, tensor parallelism over ``model``) and mesh
``{data: 2, pipe: 2, seq: 2, model: 1}`` with 2 experts over ``data``.
The same checks and tolerances as ``tests/test_torch_transformer_5d.py``
(the megatron-SP layout), whose helpers this module uses: the first
step's loss and every gradient leaf, three Sgd and three Adam steps
against the JAX ``train_step`` (each of a configuration's JAX programs
runs once a test session), and a falling loss."""
import pytest
from torch_parity import one_intraop_thread  # noqa: F401

from test_torch_transformer_5d import (hold_falling_loss, hold_grads,
                                       hold_trajectory, session_jax_runs)

CONFIGS = {"ring": ({"data": 1, "pipe": 2, "seq": 2, "model": 2}, 0),
           "ring_moe": ({"data": 2, "pipe": 2, "seq": 2, "model": 1}, 2)}


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    return session_jax_runs(tmp_path_factory, CONFIGS)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_first_step_loss_and_every_gradient_leaf_match_jax(jax_runs,
                                                           config):
    hold_grads(*CONFIGS[config], jax_runs(config, "reference"))


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_three_sgd_steps_match_jax(jax_runs, config):
    hold_trajectory(*CONFIGS[config], jax_runs(config, "sgd"), "sgd")


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_three_adam_steps_match_jax(jax_runs, config):
    hold_trajectory(*CONFIGS[config], jax_runs(config, "adam"), "adam")


def test_loss_falls_with_experts():
    hold_falling_loss(CONFIGS["ring_moe"][0], 2, lr=0.5, steps=5)
