"""The training kernels' plain versions and autograd Functions against the
JAX package, on the CPU.

Kernels 2, 3, 5 and 6 (``_epilogue_bwd_kernel``, ``_stats_kernel``,
``_reduce_kernel``, ``_dx_kernel``) run in Pallas interpret mode on the
CPU, as tests/test_conv_pallas.py and tests/test_bn_pallas.py run them,
with the JAX gates forced where a caller consults them. Shapes keep
C % 8 == 0 (the JAX package's gate) with M ragged against its 8-row
tiles. Tolerances: rtol/atol 1e-5 for sums over up to a few hundred f32
terms summed in different orders, 1e-6 for elementwise outputs (XLA may
contract a multiply-add into an FMA where the port rounds twice), and
the ROADMAP's gradient bar, rtol 2e-4, for composed backward passes.
``torch.autograd.gradcheck`` runs each Function's CPU path in float64.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.common.environment import Environment as JEnv
from deeplearning4j_tpu.ops import bn_pallas, conv_pallas
from deeplearning4j_tpu_torch.activations import Activation
from deeplearning4j_tpu_torch.common.environment import Environment
from deeplearning4j_tpu_torch.ops import bn_train as bt
from deeplearning4j_tpu_torch.ops import conv_epilogue as ce
from deeplearning4j_tpu_torch.ops import kernel_select
from torch_parity import one_intraop_thread  # noqa: F401,E402

SHAPES = [(2, 5, 5, 16), (3, 7, 7, 8), (50, 24)]
GATES = ("fused_conv", "fused_bn_bwd")
ENV_VARS = ("DL4J_TORCH_FUSED_CONV", "DL4J_TORCH_FUSED_BN_BWD")


@pytest.fixture(autouse=True)
def _clean_gates(monkeypatch):
    for v in ENV_VARS:
        monkeypatch.delenv(v, raising=False)
    envs = (Environment.get(), JEnv.get())
    saved = [{g: e.extra.pop(g, None) for g in GATES} for e in envs]
    yield
    for e, s in zip(envs, saved):
        for g in GATES:
            e.extra.pop(g, None)
            if s[g] is not None:
                e.extra[g] = s[g]


def _force(torch_side: dict, jax_side: dict):
    Environment.get().extra.update(torch_side)
    JEnv.get().extra.update(jax_side)


def _data(shape, seed):
    r = np.random.RandomState(seed)
    C = shape[-1]
    return (r.randn(*shape).astype(np.float32),
            r.randn(*shape).astype(np.float32),
            (1.0 + 0.3 * r.randn(C)).astype(np.float32),
            (0.2 * r.randn(C)).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# ---------------------------------------------------------------------------
# plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("act", ["relu", "identity"])
@pytest.mark.parametrize("shape", SHAPES)
def test_epilogue_backward_plain_matches_pallas_vjp(shape, act):
    x, dy, s, b = _data(shape, 1)
    _, vjp = jax.vjp(lambda x_, s_, b_: conv_pallas.scale_shift_act(
        x_, s_, b_, act), jnp.asarray(x), jnp.asarray(s), jnp.asarray(b))
    wdx, wds, wdb = (np.asarray(a) for a in vjp(jnp.asarray(dy)))
    C = shape[-1]
    tx, tdy, ts, tb = _t(x, dy, s, b)
    dx, ds, db = ce.epilogue_backward(tx.reshape(-1, C),
                                      tdy.reshape(-1, C), ts, tb, act)
    np.testing.assert_allclose(dx.reshape(shape).numpy(), wdx, rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(ds.numpy(), wds, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(db.numpy(), wdb, rtol=1e-5, atol=1e-5)


#: besides SHAPES, what kernel 3's one-launch geometry tells apart on the
#: card: C % 8 != 0 (the scalar body), one row, and M not a multiple of a
#: chunk (a short last chunk)
STATS_SHAPES = SHAPES + [(2, 3, 3, 20), (5, 13), (1, 40), (1, 1, 1037, 64)]


@pytest.mark.parametrize("shape", STATS_SHAPES)
def test_channel_sums_plain_matches_pallas_stats(shape):
    x = _data(shape, 2)[0] + 0.5
    wmean, wvar = (np.asarray(a) for a in
                   conv_pallas.channel_stats(jnp.asarray(x)))
    mean, var = ce.channel_stats(torch.from_numpy(x))
    np.testing.assert_allclose(mean.numpy(), wmean, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(var.numpy(), wvar, rtol=1e-5, atol=1e-6)
    C = shape[-1]
    want = np.asarray(conv_pallas._channel_sums(
        jnp.asarray(x).reshape(-1, C), jnp.float32))
    np.testing.assert_allclose(
        ce.channel_sums_plain(torch.from_numpy(x).reshape(-1, C)).numpy(),
        want, rtol=1e-5, atol=1e-5)


#: besides SHAPES: C % 8 != 0 (the kernel's scalar body on the card) and
#: M below one chunk of the one-launch sums (a single chunk, one ticket)
BN_BWD_SHAPES = SHAPES + [(2, 3, 3, 20), (5, 13), (3, 40)]


@pytest.mark.parametrize("shape", BN_BWD_SHAPES)
def test_bn_backward_plain_matches_pallas_passes(shape):
    x, dy, _, _ = _data(shape, 3)
    C = shape[-1]
    r = np.random.RandomState(4)
    mean = (0.1 * r.randn(C)).astype(np.float32)
    rstd = (0.5 + r.rand(C)).astype(np.float32)
    a, d, e = (r.randn(C).astype(np.float32) for _ in range(3))
    x2d, dy2d = x.reshape(-1, C), dy.reshape(-1, C)
    wsdy, wsdyx = bn_pallas._bn_bwd_sums(
        jnp.asarray(x2d), jnp.asarray(dy2d), jnp.asarray(mean),
        jnp.asarray(rstd), jnp.float32)
    sdy, sdyx = bt.bn_bwd_sums(*_t(x2d, dy2d, mean, rstd))
    np.testing.assert_allclose(sdy.numpy(), np.asarray(wsdy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(sdyx.numpy(), np.asarray(wsdyx), rtol=1e-5,
                               atol=1e-5)
    want = bn_pallas._bn_bwd_dx(jnp.asarray(x2d), jnp.asarray(dy2d),
                                jnp.asarray(a), jnp.asarray(d),
                                jnp.asarray(e), jnp.float32)
    got = bt.bn_bwd_dx(*_t(x2d, dy2d, a, d, e))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("fused_conv", ["1", "0"])
@pytest.mark.parametrize("shape", SHAPES)
def test_bn_train_normalize_matches_jax_fused_backward(shape, fused_conv):
    """Forward (y, mean, var) and the gradients of x, gamma, beta through
    y and the statistics, both sides on the fused-backward route; with
    fused_conv=1 the statistics and normalize are the epilogue family's
    too."""
    _force({"fused_conv": fused_conv, "fused_bn_bwd": "1"},
           {"fused_conv": fused_conv, "fused_bn_bwd": True})
    x, ct, g, b = _data(shape, 5)
    C = shape[-1]
    r = np.random.RandomState(6)
    cm, cv = r.randn(C).astype(np.float32), r.randn(C).astype(np.float32)

    def jloss(x_, g_, b_):
        y, m, v = bn_pallas.bn_train_normalize(x_, g_, b_, 1e-5)
        return jnp.sum(y * ct) + jnp.sum(m * cm) + jnp.sum(v * cv)

    (wy, wm, wv) = (np.asarray(a) for a in bn_pallas.bn_train_normalize(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), 1e-5))
    wgrads = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    tx, tg, tb = (t.requires_grad_() for t in _t(x, g, b))
    y, m, v = bt.bn_train_normalize(tx, tg, tb, 1e-5)
    for got, want in ((y, wy), (m, wm), (v, wv)):
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                                   atol=1e-5)
    loss = (y * torch.from_numpy(ct)).sum() + (m * torch.from_numpy(
        cm)).sum() + (v * torch.from_numpy(cv)).sum()
    grads = torch.autograd.grad(loss, (tx, tg, tb))
    for got, want in zip(grads, wgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-4, atol=1e-4)


@pytest.mark.parametrize("act", ["RELU", "IDENTITY", "TANH"])
def test_maybe_fused_bn_train_matches_jax(act):
    """The non-fused-backward route: statistics and the normalize with the
    activation streamed in (tanh is applied after an identity epilogue),
    forward and gradients through autograd of the Functions."""
    _force({"fused_conv": "1"}, {"fused_conv": "1"})
    from deeplearning4j_tpu.activations import Activation as JAct
    x, ct, g, b = _data((2, 5, 5, 16), 7)

    def jloss(x_, g_, b_):
        y, _, _ = conv_pallas.maybe_fused_bn_train(x_, g_, b_, 1e-5,
                                                   JAct[act])
        return jnp.sum(y * ct)

    wgrads = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    tx, tg, tb = (t.requires_grad_() for t in _t(x, g, b))
    y, _, _ = ce.maybe_fused_bn_train(tx, tg, tb, 1e-5, Activation[act])
    grads = torch.autograd.grad((y * torch.from_numpy(ct)).sum(),
                                (tx, tg, tb))
    for got, want in zip(grads, wgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# gradcheck of each Function's CPU path, float64
# ---------------------------------------------------------------------------
def _f64(shape, seed):
    r = np.random.RandomState(seed)
    C = shape[-1]
    return (torch.from_numpy(r.randn(*shape)).requires_grad_(),
            torch.from_numpy(1.0 + 0.3 * r.randn(C)).requires_grad_(),
            torch.from_numpy(0.2 * r.randn(C)).requires_grad_())


@pytest.mark.parametrize("act", ["relu", "identity"])
def test_gradcheck_scale_shift_act(act):
    x, s, b = _f64((3, 4, 5), 8)
    assert torch.autograd.gradcheck(
        lambda x_, s_, b_: ce.scale_shift_act(x_, s_, b_, act), (x, s, b))


def test_gradcheck_channel_stats():
    x, _, _ = _f64((3, 4, 5), 9)
    assert torch.autograd.gradcheck(ce.channel_stats, (x,))


@pytest.mark.parametrize("fused_conv", ["1", "0"])
def test_gradcheck_bn_train_normalize(fused_conv):
    Environment.get().extra["fused_conv"] = fused_conv
    x, g, b = _f64((4, 3, 5), 10)
    assert torch.autograd.gradcheck(
        lambda x_, g_, b_: bt.bn_train_normalize(x_, g_, b_, 1e-5),
        (x, g, b))


# ---------------------------------------------------------------------------
# the ladder: the kernels on the card, the plain lowering only through
# the kill switches
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("device,fused", [("cuda", True), ("cpu", False)])
def test_training_families_auto_take_the_kernels_on_the_card(device,
                                                             fused):
    sel = ce.select_bn_forward((4, 8), torch.float32, training=True,
                               device=device)
    assert sel.fused is fused and sel.kernel == "bn_fwd"
    assert bt.fused_bn_bwd_enabled(device) is fused


@pytest.mark.parametrize("var,family", [
    ("DL4J_TORCH_FUSED_CONV", "bn_fwd"),
    ("DL4J_TORCH_FUSED_BN_BWD", "bn_bwd")])
def test_kill_switch_is_the_only_way_to_plain_on_the_card(monkeypatch, var,
                                                          family):
    def decide():
        if family == "bn_fwd":
            return ce.select_bn_forward((4, 8), torch.float32,
                                        training=True, device="cuda").fused
        return bt.fused_bn_bwd_enabled("cuda")
    before = kernel_select.decisions(family)["killed"]
    assert decide() is True
    monkeypatch.setenv(var, "0")
    assert decide() is False
    assert kernel_select.decisions(family)["killed"] == before + 1
    monkeypatch.setenv(var, "1")
    assert decide() is True


def test_bn_forward_is_structural_outside_training():
    sel = ce.select_bn_forward((4, 8), torch.float32, training=False,
                               device="cuda", override=True)
    assert not sel.fused and sel.decision == "structural"


@pytest.mark.parametrize("call", [
    lambda x, v: ce.epilogue_backward(x, x, v, v, "relu"),
    lambda x, v: ce.channel_sums(x),
    lambda x, v: bt.bn_bwd_sums(x, x, v, v),
    lambda x, v: bt.bn_bwd_dx(x, x, v, v, v)])
def test_wrappers_have_no_plain_path_off_the_cpu(call):
    """A tensor that is not on the CPU reaches the kernel or raises; here
    (no card) a meta tensor raises before any launch."""
    x = torch.zeros(4, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        call(x, torch.zeros(8, device="meta"))
