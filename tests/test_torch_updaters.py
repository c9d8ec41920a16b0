"""The port's update math against the JAX package, on the CPU: all ten
updaters over 3 steps on the same gradients, gradient normalization,
weight constraints (dense and OIHW conv kernels) and the MCXENT loss.
Inputs are made with numpy from a seed. Tolerance rtol 1e-5 / atol 1e-7:
both sides compute elementwise in float32; the Adam-family bias
corrections are computed in double here and in float32 in JAX.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.learning import updaters as ju
from deeplearning4j_tpu.lossfunctions import LossFunction as JLoss
from deeplearning4j_tpu.nn import gradient as jg
from deeplearning4j_tpu.nn.conf import constraints as jc
from deeplearning4j_tpu.nn.conf.builders import \
    GradientNormalization as JGN
from deeplearning4j_tpu.nn.conf.layers import (ConvolutionLayer as JConv,
                                               DenseLayer as JDense)
from deeplearning4j_tpu_torch.learning import updaters as tu
from deeplearning4j_tpu_torch.lossfunctions import LossFunction
from deeplearning4j_tpu_torch.nn import gradient as tg
from deeplearning4j_tpu_torch.nn.conf import constraints as tc
from deeplearning4j_tpu_torch.nn.conf.builders import GradientNormalization
from deeplearning4j_tpu_torch.nn.conf.layers import (ConvolutionLayer,
                                                     DenseLayer)
from torch_parity import one_intraop_thread  # noqa: F401,E402

RTOL, ATOL = 1e-5, 1e-7
JAX_UPDATERS = {
    "NoOp": ju.NoOp(), "Sgd": ju.Sgd(0.05),
    "Nesterovs": ju.Nesterovs(0.1, 0.9), "Adam": ju.Adam(1e-2),
    "AdaMax": ju.AdaMax(1e-2, 0.8), "Nadam": ju.Nadam(1e-2),
    "AMSGrad": ju.AMSGrad(1e-2, beta2=0.99), "AdaGrad": ju.AdaGrad(0.1),
    "AdaDelta": ju.AdaDelta(0.9), "RmsProp": ju.RmsProp(1e-2, 0.9)}


def _tree(seed):
    r = np.random.RandomState(seed)
    return {"W": r.randn(4, 3).astype(np.float32),
            "b": r.randn(3).astype(np.float32)}


def _close(got, want):
    for n in want:
        np.testing.assert_allclose(got[n].numpy(), np.asarray(want[n]),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", sorted(JAX_UPDATERS))
def test_updater_matches_jax_over_three_steps(kind):
    jup = JAX_UPDATERS[kind]
    up = tu.IUpdater.from_map(jup.to_map())
    assert up.to_map() == jup.to_map()
    params = _tree(0)
    jstate = jup.init_state({n: jnp.asarray(a) for n, a in params.items()})
    state = up.init_state({n: torch.from_numpy(a)
                           for n, a in params.items()})
    for it in range(3):
        g = _tree(it + 1)
        jupd, jstate = jup.apply({n: jnp.asarray(a) for n, a in g.items()},
                                 jstate, it)
        upd, state = up.apply({n: torch.from_numpy(a)
                               for n, a in g.items()}, state, it)
        _close(upd, jupd)
        for slot in tu.SLOTS[kind]:
            _close(state[slot], jstate[slot])


@pytest.mark.parametrize("kind", sorted(JAX_UPDATERS))
def test_factories_write_the_jax_configuration(kind):
    """Defaults and field order, as configuration.json carries them."""
    default = getattr(ju, kind)()
    assert list(getattr(tu, kind)().to_map().items()) == \
        list(default.to_map().items())


def test_schedules_are_refused_until_ported():
    """Schedules are ported: a schedule's JSON map in place of the
    learning rate is read as the schedule, and the update uses its value
    at the step's iteration (StepSchedule's defaults: 1e-3 halved every
    1000 iterations)."""
    up = tu.IUpdater("Sgd", learning_rate={"@class": "StepSchedule"})
    for it, lr in ((0, 1e-3), (999, 1e-3), (1000, 5e-4)):
        upd, _ = up.apply({"W": torch.ones(2)}, {}, it)
        np.testing.assert_allclose(upd["W"].numpy(), [lr, lr], rtol=1e-6)
    assert up.to_map()["learning_rate"]["@class"] == "StepSchedule"


@pytest.mark.parametrize("kind", [k for k in GradientNormalization])
def test_gradient_normalization_matches_jax(kind):
    g = _tree(7)
    want = jg.apply_gradient_normalization(
        JGN[kind.name], 0.5, {n: jnp.asarray(a) for n, a in g.items()})
    got = tg.apply_gradient_normalization(
        kind, 0.5, {n: torch.from_numpy(a) for n, a in g.items()})
    _close(got, want)


@pytest.mark.parametrize("cmap", [
    {"@class": "MaxNormConstraint", "max_norm": 0.5, "dims": None},
    {"@class": "MinMaxNormConstraint", "min_norm": 0.2, "max_norm": 0.4,
     "rate": 0.7, "dims": None},
    {"@class": "UnitNormConstraint", "dims": [0, 1]},
    {"@class": "NonNegativeConstraint"}])
def test_constraints_match_jax_on_dense_and_conv(cmap):
    """Norms per output unit: the JAX package's HWIO kernel is the port's
    OIHW one, so the default axes and an explicit ``dims`` map across."""
    r = np.random.RandomState(8)
    hwio = (0.3 * r.randn(3, 3, 2, 4)).astype(np.float32)
    dense = (0.3 * r.randn(5, 4)).astype(np.float32)
    bias = r.randn(4).astype(np.float32)
    for jl, tl, w, to_port, to_jax in (
            (JConv, ConvolutionLayer, hwio,
             lambda a: np.ascontiguousarray(a.transpose(3, 2, 0, 1)),
             lambda t: t.numpy().transpose(2, 3, 1, 0)),
            (JDense, DenseLayer, dense, lambda a: a, lambda t: t.numpy())):
        if cmap.get("dims") == [0, 1] and w.ndim == 2:
            continue
        jlayer = jl(constrain_weights=[jc.LayerConstraint.from_map(cmap)],
                    constrain_bias=[jc.NonNegativeConstraint()])
        tlayer = tl(constrain_weights=[cmap],
                    constrain_bias=[{"@class": "NonNegativeConstraint"}])
        want = jc.apply_constraints(jlayer, {"W": jnp.asarray(w),
                                             "b": jnp.asarray(bias)})
        got = tc.apply_constraints(tlayer, {
            "W": torch.from_numpy(to_port(w)), "b": torch.from_numpy(bias)})
        np.testing.assert_allclose(to_jax(got["W"]), np.asarray(want["W"]),
                                   rtol=RTOL, atol=1e-6)
        np.testing.assert_array_equal(got["b"].numpy(),
                                      np.asarray(want["b"]))


@pytest.mark.parametrize("name", ["MCXENT", "NEGATIVELOGLIKELIHOOD"])
@pytest.mark.parametrize("masked", [False, True])
def test_mcxent_matches_jax(name, masked):
    r = np.random.RandomState(9)
    logits = r.randn(6, 5).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    labels = np.eye(5, dtype=np.float32)[r.randint(0, 5, 6)]
    mask = (r.rand(6) > 0.3).astype(np.float32) if masked else None
    jlf, lf = JLoss[name], LossFunction[name]
    for fn, jfn, x in (("score", "score", probs),
                       ("score_from_logits", "score_from_logits", logits)):
        want = float(getattr(jlf, jfn)(jnp.asarray(labels), jnp.asarray(x),
                                       mask=mask))
        got = float(getattr(lf, fn)(torch.from_numpy(labels),
                                    torch.from_numpy(x), mask=mask))
        np.testing.assert_allclose(got, want, rtol=1e-6)
    assert lf.supports_logits()
    # the other members are ported too (tests/test_torch_losses.py)
    assert float(LossFunction.MSE.score(torch.zeros(2, 2),
                                        torch.ones(2, 2))) == \
        float(JLoss.MSE.score(jnp.zeros((2, 2)), jnp.ones((2, 2)))) == 1.0
