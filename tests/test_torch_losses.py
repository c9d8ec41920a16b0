"""The port's fourteen loss functions (``lossfunctions/losses.py``)
against the JAX package's, on the CPU.

Each member's ``score`` (``average`` True and False) and ``score_array``,
with no mask, a per-example mask and (for ``[b, t, f]`` outputs) a
per-timestep mask, and the gradient of ``score`` with respect to the
predictions (autograd against ``jax.grad``); the logits forms of
MCXENT, NEGATIVELOGLIKELIHOOD and XENT and their gradients the same
way. The inputs are what each loss is defined on (one-hot or
probability labels, +-1 for the hinges, positive values for POISSON and
MSLE), made with numpy from a seed. Bars: the reference's, rtol 2e-5
forward and 2e-4 for gradients (atol 1e-6 and 1e-7 for entries at
zero).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.lossfunctions import LossFunction as JLoss
from deeplearning4j_tpu_torch.lossfunctions import LossFunction
from torch_parity import one_intraop_thread  # noqa: F401,E402

FWD = dict(rtol=2e-5, atol=1e-6)
GRAD = dict(rtol=2e-4, atol=1e-7)
LOGIT_LOSSES = ("MCXENT", "NEGATIVELOGLIKELIHOOD", "XENT")


def _softmax(z):
    e = np.exp(z - z.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def _inputs(name, shape, seed=0):
    """(labels, preds, logits) the loss is defined on."""
    r = np.random.RandomState(seed)
    z = r.randn(*shape).astype(np.float32)
    if name in ("MCXENT", "NEGATIVELOGLIKELIHOOD"):
        labels = np.eye(shape[-1], dtype=np.float32)[
            r.randint(0, shape[-1], shape[:-1])]
        return labels, _softmax(z).astype(np.float32), z
    if name in ("XENT", "RECONSTRUCTION_CROSSENTROPY"):
        labels = (r.rand(*shape) > 0.5).astype(np.float32)
        return labels, (1 / (1 + np.exp(-z))).astype(np.float32), z
    if name == "KL_DIVERGENCE":
        labels = _softmax(r.randn(*shape)).astype(np.float32)
        return labels, _softmax(z).astype(np.float32), z
    if name in ("HINGE", "SQUARED_HINGE"):
        labels = np.where(r.rand(*shape) > 0.5, 1.0, -1.0).astype(
            np.float32)
        return labels, z, z
    if name in ("POISSON", "MEAN_SQUARED_LOGARITHMIC_ERROR"):
        labels = r.poisson(2.0, shape).astype(np.float32)
        return labels, np.exp(0.5 * z).astype(np.float32), z
    return r.randn(*shape).astype(np.float32), z, z


def _mask(kind, shape, seed=1):
    r = np.random.RandomState(seed)
    if kind == "none":
        return None
    if kind == "example":
        m = (r.rand(shape[0]) > 0.4).astype(np.float32)
    else:                                   # per timestep
        m = (r.rand(*shape[:2]) > 0.4).astype(np.float32)
    m[0] = 1.0                              # never all masked
    return m


CASES = [("none", (6, 5)), ("example", (6, 5)), ("none", (4, 3, 5)),
         ("timestep", (4, 3, 5))]
CASE_IDS = ["2d", "2d_example_mask", "3d", "3d_timestep_mask"]


def _port(fn, labels, x, mask, **kw):
    xt = torch.from_numpy(x).requires_grad_(True)
    out = fn(torch.from_numpy(labels), xt, mask=mask, **kw)
    return out, xt


@pytest.mark.parametrize("average", [True, False])
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("name", [m.name for m in JLoss])
def test_score_and_gradient_match_jax(name, case, average):
    kind, shape = case
    labels, preds, _ = _inputs(name, shape)
    mask = _mask(kind, shape)
    jl, tl = JLoss[name], LossFunction[name]
    want = float(jl.score(jnp.asarray(labels), jnp.asarray(preds),
                          mask=mask, average=average))
    got, xt = _port(tl.score, labels, preds, mask, average=average)
    np.testing.assert_allclose(float(got.detach()), want, **FWD)
    jg = jax.grad(lambda p: jl.score(jnp.asarray(labels), p, mask=mask,
                                     average=average))(jnp.asarray(preds))
    (tg,) = torch.autograd.grad(got, [xt])
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **GRAD)


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("name", [m.name for m in JLoss])
def test_score_array_matches_jax(name, case):
    kind, shape = case
    labels, preds, _ = _inputs(name, shape, seed=2)
    mask = _mask(kind, shape, seed=3)
    want = np.asarray(JLoss[name].score_array(
        jnp.asarray(labels), jnp.asarray(preds), mask=mask))
    got = LossFunction[name].score_array(torch.from_numpy(labels),
                                         torch.from_numpy(preds), mask=mask)
    assert tuple(got.shape) == want.shape == shape[:-1]
    np.testing.assert_allclose(got.numpy(), want, **FWD)


@pytest.mark.parametrize("average", [True, False])
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("name", LOGIT_LOSSES)
def test_logits_form_and_gradient_match_jax(name, case, average):
    kind, shape = case
    labels, _, logits = _inputs(name, shape, seed=4)
    mask = _mask(kind, shape, seed=5)
    jl, tl = JLoss[name], LossFunction[name]
    assert tl.supports_logits() and jl.supports_logits()
    want = float(jl.score_from_logits(jnp.asarray(labels),
                                      jnp.asarray(logits), mask=mask,
                                      average=average))
    got, xt = _port(tl.score_from_logits, labels, logits, mask,
                    average=average)
    np.testing.assert_allclose(float(got.detach()), want, **FWD)
    jg = jax.grad(lambda z: jl.score_from_logits(
        jnp.asarray(labels), z, mask=mask, average=average))(
        jnp.asarray(logits))
    (tg,) = torch.autograd.grad(got, [xt])
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **GRAD)


def test_only_the_cross_entropies_have_a_logits_form():
    for m in LossFunction:
        assert m.supports_logits() == JLoss[m.name].supports_logits()
        if not m.supports_logits():
            with pytest.raises(ValueError, match="no logits form"):
                m.score_from_logits(torch.zeros(2, 3), torch.zeros(2, 3))
    assert {m.name: m.value for m in LossFunction} == \
        {m.name: m.value for m in JLoss}
