"""The port's distributed Transformer LM (``models/transformer.py``)
against the JAX package's, megatron-SP layout: mesh ``{data: 2, pipe: 2,
model: 2}``, time sharded over ``model``, dense MLPs and 4 experts over
``data``, at ``tests/test_transformer_5d.py``'s sizes (V 64, T 16, D
32, H 4, FF 64, B 8; 2 blocks a stage, 2 microbatches). The JAX model
runs on the 8 forced host devices, the port on a thread mesh of 8 CPU
replicas, from the same global weights (the JAX ``init_global_params``
carried across by ``utils/serializer.transformer_params_from_jax``):

- the first step's loss, and every gradient leaf (gathered from the
  ranks' shards) against ``jax.grad`` of the JAX test's single-device
  ``ref_loss`` (aux coefficient 0, as there);
- three Sgd(0.1) steps: each step's loss and the parameters after it
  against the JAX ``train_step`` (aux coefficient 0.01 with experts);
- three Adam(1e-3) steps the same way;
- the loss falls over five Sgd steps.

Tolerances: rtol 2e-5 on losses, 2e-4 of each leaf's largest element on
gradients, the JAX package's own bar for its step's parameters
(atol 5e-5, rtol 1e-4) after each Sgd step, and after the three Adam
steps each leaf's update within 5e-3 of the JAX update's norm (Adam
turns a gradient entry at the backends' summation noise into a
full-rate step, so one element may move by up to a learning rate). Each
of a configuration's three JAX programs (the reference, the Sgd and the
Adam trajectory) runs once a test session (``jax_runs``: the first test
process to need it runs it and leaves the result beside the session's
temporary directories, the others read it);
``tests/test_torch_transformer_5d_ring.py`` holds the ring layouts."""
import fcntl
import os
import pickle

import jax
import numpy as np
import pytest
import torch
from torch_parity import one_intraop_thread  # noqa: F401

from deeplearning4j_tpu.learning import updaters as ju
from deeplearning4j_tpu.models.transformer import \
    DistributedTransformerLM as JaxLM
from deeplearning4j_tpu.models.transformer import \
    TransformerLMConfig as JaxConf
from deeplearning4j_tpu.parallel import make_mesh as jax_mesh
from deeplearning4j_tpu_torch.learning import updaters as tu
from deeplearning4j_tpu_torch.models.transformer import (
    DistributedTransformerLM, TransformerLMConfig, flatten_tree)
from deeplearning4j_tpu_torch.parallel.mesh import make_mesh
from deeplearning4j_tpu_torch.utils.serializer import (
    transformer_params_from_jax, transformer_state_from_jax)
from test_transformer_5d import ref_loss

V, T, D, H, FF, B = 64, 16, 32, 4, 64, 8
SEED, STEPS = 3, 3
LOSS = dict(rtol=2e-5)
SGD_STEP = dict(atol=5e-5, rtol=1e-4)
#: each leaf's 3-step Adam update, norm-wise against the JAX update
ADAM_UPDATE_RTOL = 5e-3
#: config name -> (mesh axes, experts)
CONFIGS = {"megatron_dense": ({"data": 2, "pipe": 2, "model": 2}, 0),
           "megatron_moe": ({"data": 2, "pipe": 2, "model": 2}, 4)}


def conf_kw(n_experts, aux_coef):
    return dict(vocab_size=V, max_len=T, d_model=D, n_heads=H, d_ff=FF,
                layers_per_stage=2, n_experts=n_experts,
                moe_capacity=B * T, aux_coef=aux_coef)


def data(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, V, (B, T)).astype(np.int32),
            rng.randint(0, V, (B, T)).astype(np.int32))


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(jax.device_get(a)),
                                  tree)


#: the JAX programs a configuration's tests read, each run on its own
PIECES = ("reference", "sgd", "adam")


def jax_run(axes, n_experts, pieces=PIECES):
    """What the tests hold the port to, from the JAX package: the global
    weights, and for each of ``pieces`` the reference loss and gradients
    (``"reference"``: one jitted ``value_and_grad`` of the JAX test's
    ``ref_loss``) or an Sgd or Adam trajectory (losses, global
    parameters after each step)."""
    n = int(np.prod(list(axes.values())))
    mesh = jax_mesh(axes, jax.devices()[:n])
    aux = 0.01 if n_experts else 0.0
    ids, labels = data()
    out = {}
    ref_conf = JaxConf(**conf_kw(n_experts, 0.0))
    ref_model = JaxLM(ref_conf, mesh, ju.Sgd(0.1), n_micro=2)
    g = ref_model.init_global_params(seed=SEED)
    out["global"] = _np(g)
    if "reference" in pieces:
        moe = {1} if n_experts else set()
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: ref_loss(p, ref_conf, axes["pipe"], ids, labels,
                               moe)))(g)
        out["ref_grads"] = _np(grads)
        out["ref_loss"] = float(loss)
    for name, upd in (("sgd", ju.Sgd(0.1)), ("adam", ju.Adam(1e-3))):
        if name not in pieces:
            continue
        model = JaxLM(JaxConf(**conf_kw(n_experts, aux)), mesh, upd,
                      n_micro=2)
        params, opt = model.init(seed=SEED)
        losses, snaps = [], []
        for it in range(STEPS):
            params, opt, loss = model.train_step(params, opt, ids, labels,
                                                 it)
            losses.append(float(loss))
            snaps.append(_np(params))
        out[name] = {"losses": losses, "params": snaps}
    return out


def port_model(axes, n_experts, aux_coef, updater):
    n = int(np.prod(list(axes.values())))
    return DistributedTransformerLM(
        TransformerLMConfig(**conf_kw(n_experts, aux_coef)),
        make_mesh(axes, ["cpu"] * n, timeout_s=120), updater, n_micro=2)


def hold_grads(axes, n_experts, ref):
    model = port_model(axes, n_experts, 0.0, tu.Sgd(0.1))
    params, _ = model.shard(transformer_params_from_jax(ref["global"]))
    ids, labels = data()
    loss, grads = model.loss_and_grads(params, ids, labels)
    np.testing.assert_allclose(loss, ref["ref_loss"], **LOSS)
    got = flatten_tree(model.gather(grads))
    want = flatten_tree(transformer_params_from_jax(ref["ref_grads"]))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = w.numpy()
        np.testing.assert_allclose(got[k].numpy(), w, rtol=2e-4,
                                   atol=2e-4 * np.abs(w).max(), err_msg=k)


def hold_trajectory(axes, n_experts, ref, name):
    aux = 0.01 if n_experts else 0.0
    upd = tu.Sgd(0.1) if name == "sgd" else tu.Adam(1e-3)
    model = port_model(axes, n_experts, aux, upd)
    params, opt = model.shard(transformer_params_from_jax(ref["global"]))
    ids, labels = data()
    want = ref[name]
    p0 = flatten_tree(transformer_params_from_jax(ref["global"]))
    for it in range(STEPS):
        params, opt, loss = model.train_step(params, opt, ids, labels, it)
        np.testing.assert_allclose(loss, want["losses"][it], **LOSS)
        if name == "adam" and it < STEPS - 1:
            continue
        got = flatten_tree(model.gather(params))
        w = flatten_tree(transformer_params_from_jax(want["params"][it]))
        for k in w:
            if name == "sgd":
                np.testing.assert_allclose(got[k].numpy(), w[k].numpy(),
                                           err_msg=f"step {it + 1} {k}",
                                           **SGD_STEP)
                continue
            # Adam turns a gradient entry at the summation noise into a
            # full-rate step: held norm-wise on the update
            upd = (w[k] - p0[k]).double()
            err = float((got[k].double() - w[k].double()).norm()
                        / upd.norm().clamp_min(1e-30))
            assert err <= ADAM_UPDATE_RTOL, (k, err)


def hold_falling_loss(axes, n_experts, lr, steps):
    model = port_model(axes, n_experts, 0.01, tu.Sgd(lr))
    params, opt = model.init(seed=0)
    ids, labels = data(1)
    losses = []
    for it in range(steps):
        params, opt, loss = model.train_step(params, opt, ids, labels, it)
        losses.append(loss)
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 0.1, losses


def session_jax_runs(tmp_path_factory, configs):
    """``get(name, piece)``: :func:`jax_run` of ``configs[name]`` for
    one of :data:`PIECES`, run once a test session. Under pytest-xdist
    the workers share the parent of their temporary directories: the
    first to need a piece runs it under a file lock and pickles the
    result there, the others wait for the lock and load it; the pieces
    of a configuration run in whichever workers need them, side by
    side."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    cache = {}

    def get(name, piece):
        key = f"{name}_{piece}"
        if key not in cache:
            path = root / f"jax_lm_run_{key}.pkl"
            with open(root / f"jax_lm_run_{key}.lock", "w") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)
                if path.exists():
                    cache[key] = pickle.loads(path.read_bytes())
                else:
                    cache[key] = jax_run(*configs[name], pieces=(piece,))
                    tmp = path.with_suffix(".tmp")
                    tmp.write_bytes(pickle.dumps(cache[key]))
                    tmp.rename(path)
        return cache[key]
    return get


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
    hold_falling_loss(CONFIGS["megatron_moe"][0], 4, lr=0.05, steps=6)


def test_updater_state_crosses_from_jax():
    """The JAX model's Adam state (``{slot: tree}``) and Sgd's ``()``
    become the port's ``{slot: tree}``, sharded like the parameters."""
    axes, n_experts = CONFIGS["megatron_dense"]
    mesh = jax_mesh(axes, jax.devices()[:8])
    jm = JaxLM(JaxConf(**conf_kw(0, 0.0)), mesh, ju.Adam(1e-3), n_micro=2)
    g = _np(jm.init_global_params(seed=SEED))
    state = transformer_state_from_jax(_np(jm.updater.init_state(g)))
    assert sorted(state) == ["m", "v"]
    assert transformer_state_from_jax(()) == {}
    model = port_model(axes, n_experts, 0.0, tu.Adam(1e-3))
    params, opt = model.shard(transformer_params_from_jax(g), state)
    assert sorted(opt[0]) == ["m", "v"]
    for r in range(8):
        for k, p in flatten_tree(params[r]).items():
            assert flatten_tree(opt[r]["m"])[k].shape == p.shape, k
    with pytest.raises(ValueError, match="lacks"):
        transformer_params_from_jax({"embed": g["embed"]})
