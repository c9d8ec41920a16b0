"""The port's matmul_bias_act (kernel 4's wrapper, plain version and
autograd Function) and its routing in conv_forward, against the JAX
package's ops/conv_pallas.py on the CPU.

On the CPU the port runs the plain version. The JAX package's
``matmul_bias_act`` runs its Pallas kernel in interpret mode, as
tests/test_conv_pallas.py runs it, at the shapes that kernel takes (K
and N multiples of 128). Tolerances are the reference's own bars: 2e-5
forward, 2e-4 for the gradients (tests/test_conv_pallas.py:185, 193);
both sides sum in f32 in different orders. Inputs come from numpy with
a seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.activations import Activation as JAct
from deeplearning4j_tpu.ops import conv_pallas
from deeplearning4j_tpu_torch.activations import Activation
from deeplearning4j_tpu_torch.common import telemetry
from deeplearning4j_tpu_torch.common.environment import Environment
from deeplearning4j_tpu_torch.ops import conv_epilogue as ce
from torch_parity import one_intraop_thread  # noqa: F401,E402

FWD_TOL, GRAD_TOL = 2e-5, 2e-4


@pytest.fixture(autouse=True)
def _clean_extra(monkeypatch):
    monkeypatch.delenv("DL4J_TORCH_FUSED_CONV", raising=False)
    env = Environment.get()
    saved = env.extra.pop("fused_conv", None)
    yield
    env.extra.pop("fused_conv", None)
    if saved is not None:
        env.extra["fused_conv"] = saved


def _mm_inputs(m, k, n, seed):
    r = np.random.RandomState(seed)
    x = (0.5 * r.randn(m, k)).astype(np.float32)
    w = (0.1 * r.randn(k, n)).astype(np.float32)         # JAX: [K, N]
    b = (0.2 * r.randn(n)).astype(np.float32)
    return x, w, b


def _port(x, w, b, grad=False):
    """Port tensors: w as [N, K], the OIHW 1x1 kernel's view."""
    ts = [torch.tensor(x), torch.tensor(np.ascontiguousarray(w.T)),
          torch.tensor(b)]
    for t in ts:
        t.requires_grad_(grad)
    return ts


# 1 -------------------------------------------------------------------------
@pytest.mark.parametrize("act", ["relu", "identity"])
@pytest.mark.parametrize("m,k,n", [(50, 128, 128), (128, 128, 128),
                                   (77, 256, 128), (40, 128, 384)])
def test_forward_and_grads_match_pallas_interpret(act, m, k, n):
    """M ragged and exact against the JAX kernel's 8-row tiles; forward
    within 2e-5, dx, dw, db within 2e-4 (loss sum(y²))."""
    x, w, b = _mm_inputs(m, k, n, m + k + n)

    def jfused(x, w, b):
        return conv_pallas.matmul_bias_act(x, w, b, act)

    want = np.asarray(jfused(x, w, b))
    jg = jax.grad(lambda *a: jnp.sum(jfused(*a) ** 2),
                  argnums=(0, 1, 2))(x, w, b)
    tx, tw, tb = _port(x, w, b, grad=True)
    n0 = ce.MATMUL.launches
    y = ce.matmul_bias_act(tx, tw, tb, act)
    assert ce.MATMUL.launches == n0          # the CPU never launches
    np.testing.assert_allclose(y.detach().numpy(), want, rtol=FWD_TOL,
                               atol=FWD_TOL)
    (y ** 2).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg[0]),
                               rtol=GRAD_TOL, atol=GRAD_TOL)
    np.testing.assert_allclose(tw.grad.numpy().T, np.asarray(jg[1]),
                               rtol=GRAD_TOL, atol=GRAD_TOL)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jg[2]),
                               rtol=GRAD_TOL, atol=GRAD_TOL)


@pytest.mark.parametrize("act", ["relu", "identity"])
def test_bf16_plain_matches_pallas_interpret(act):
    """bf16 operands, f32 accumulation, one rounding to bf16 on both
    sides: within one bf16 ulp (8 significant bits) of each other."""
    x, w, b = _mm_inputs(64, 128, 128, 9)
    xb = jnp.asarray(x, jnp.bfloat16)
    wb = jnp.asarray(w, jnp.bfloat16)
    want = np.asarray(conv_pallas.matmul_bias_act(xb, wb, b, act)
                      .astype(jnp.float32))
    got = ce.matmul_bias_act(
        torch.tensor(x).bfloat16(),
        torch.tensor(np.ascontiguousarray(w.T)).bfloat16(),
        torch.tensor(b), act)
    assert got.dtype == torch.bfloat16
    _, e = np.frexp(np.abs(want))
    ulp = np.ldexp(1.0, e - 8)
    err = np.abs(got.float().numpy() - want)
    assert (err <= ulp + 1e-6).all(), float((err / ulp).max())


# 2 -------------------------------------------------------------------------
@pytest.mark.parametrize("m,k,n", [
    (37, 64, 16),        # squeeze, N = 16
    (50, 16, 64),        # expand-1x1 after a 16-wide squeeze, K = 16
    (45, 384, 48),       # N off every power of two
    (33, 48, 192),
    (20, 512, 1000),     # the 1000-class head
])
def test_plain_matches_dense_at_squeezenet_shapes(m, k, n):
    """At the shapes SqueezeNet gives the kernel (which the JAX kernel's
    128-lane gate never takes), the plain version against JAX's dense
    ``relu(x @ w + b)``."""
    x, w, b = _mm_inputs(m, k, n, k + n)
    want = np.asarray(jax.nn.relu(jnp.asarray(x) @ jnp.asarray(w)
                                  + jnp.asarray(b)))
    got = ce.matmul_bias_act_plain(*_port(x, w, b), "relu").numpy()
    np.testing.assert_allclose(got, want, rtol=FWD_TOL, atol=FWD_TOL)


def test_plain_propagates_nan_and_keeps_the_order():
    """NaN passes through relu (``y < 0 ? 0 : y``, as jnp.maximum), and
    the bias is added to the rounded dot before relu: a dot of -b gives
    exactly 0 after the bias."""
    x = torch.tensor([[1.0, 2.0], [float("nan"), 1.0], [1.0, -1.0]])
    w = torch.tensor([[1.0, 1.0], [-1.0, 0.0]])
    b = torch.tensor([-3.0, 0.5])
    y = ce.matmul_bias_act_plain(x, w, b, "relu")
    assert y[0].tolist() == [0.0, 0.0]
    assert bool(torch.isnan(y[1]).all())
    assert y[2].tolist() == [0.0, 0.0]
    y = ce.matmul_bias_act_plain(x, w, b, "identity")
    assert y[0].tolist() == [0.0, -0.5]
    with pytest.raises(ValueError, match="not streamable"):
        ce.matmul_bias_act_plain(x, w, b, "tanh")


def test_f64_stays_f64_on_the_cpu():
    x, w, b = _mm_inputs(9, 16, 8, 2)
    tx, tw, tb = (t.double() for t in _port(x, w, b))
    y = ce.matmul_bias_act(tx, tw, tb, "relu")
    assert y.dtype == torch.float64
    np.testing.assert_allclose(
        y.numpy(), np.maximum(x.astype(np.float64) @ w + b, 0), rtol=1e-12)


def test_wrapper_refuses_other_devices_and_activations():
    x = torch.empty(4, 8, device="meta")
    w = torch.empty(3, 8, device="meta")
    b = torch.empty(3, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ce.matmul_bias_act_forward(x, w, b, "relu")
    with pytest.raises(ValueError, match="not streamable"):
        ce.matmul_bias_act_forward(x, w, b, "sigmoid")


# 3 -------------------------------------------------------------------------
@pytest.mark.parametrize("k,stride,dilation,padding,want", [
    ((1, 1), (1, 1), (1, 1), "SAME", True),
    ((1, 1), (1, 1), (1, 1), "VALID", True),
    ((1, 1), (1, 1), (1, 1), [(0, 0), (0, 0)], True),
    ((1, 1), (2, 2), (1, 1), "SAME", False),
    ((1, 1), (1, 1), (2, 2), "SAME", False),
    ((1, 1), (1, 1), (1, 1), [(1, 1), (0, 0)], False),
    ((3, 3), (1, 1), (1, 1), "SAME", False),
    ((1, 3), (1, 1), (1, 1), "SAME", False),
])
def test_is_pointwise_matches_jax(k, stride, dilation, padding, want):
    """The port reads OIHW kernels, the JAX package HWIO ones."""
    assert conv_pallas._is_pointwise((*k, 4, 8), stride, dilation,
                                     padding) is want
    assert ce._is_pointwise((8, 4, *k), stride, dilation, padding) is want


def _fused():
    c = telemetry.counter("dl4j_conv_fused_steps_total")
    return {s: c.value(site=s) for s in ("conv", "conv_matmul")}


def _conv_inputs(seed, c_in=24, c_out=40, k=1):
    r = np.random.RandomState(seed)
    x = r.randn(2, 7, 6, c_in).astype(np.float32)
    w = (0.3 * r.randn(k, k, c_in, c_out)).astype(np.float32)   # HWIO
    b = r.randn(c_out).astype(np.float32)
    return x, w, b


def _jax_conv(x, w, b, stride, act=JAct.RELU, bias=True):
    return np.asarray(conv_pallas.conv_forward(
        jnp.asarray(x), jnp.asarray(w), window_strides=stride,
        padding="SAME", rhs_dilation=(1, 1),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        bias=jnp.asarray(b) if bias else None, activation=act))


def _port_conv(x, w, b, stride, act=Activation.RELU, bias=True):
    wt = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
    wt = wt.contiguous(memory_format=torch.channels_last)
    return ce.conv_forward(torch.from_numpy(x), wt, stride=stride,
                           padding="SAME",
                           bias=torch.from_numpy(b) if bias else None,
                           activation=act)


@pytest.mark.parametrize("gate,site", [("1", "conv_matmul"), ("0", None)])
def test_pointwise_conv_routes_to_the_matmul_and_matches_jax(gate, site):
    """Forced, a 1x1 stride-1 biased relu conv is one matmul_bias_act
    over the [M, C_in] view, with no layout copy; killed, the plain conv
    with bias. Both match the JAX package's conv_forward."""
    x, w, b = _conv_inputs(5)
    want = _jax_conv(x, w, b, (1, 1))
    Environment.get().extra["fused_conv"] = gate
    copies = telemetry.counter("dl4j_conv_layout_copies_total")
    c0, n0 = copies.value(), _fused()
    got = _port_conv(x, w, b, (1, 1)).numpy()
    d = {s: v - n0[s] for s, v in _fused().items()}
    assert d == {"conv": 0, "conv_matmul": 1 if site else 0}
    assert copies.value() == c0
    np.testing.assert_allclose(got, want, rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("k,stride,bias,act,want_site", [
    (1, (2, 2), True, "RELU", "conv"),             # strided: not a matmul
    (3, (1, 1), True, "RELU", "conv"),
    (1, (1, 1), False, "RELU", "conv_matmul"),     # relu alone is an epilogue
    (1, (1, 1), True, "IDENTITY", "conv_matmul"),  # so is a bias alone
    (1, (1, 1), False, "IDENTITY", None),          # nothing to fuse
])
def test_forced_routing_by_site(k, stride, bias, act, want_site):
    x, w, b = _conv_inputs(6, k=k)
    want = _jax_conv(x, w, b, stride, getattr(JAct, act), bias)
    Environment.get().extra["fused_conv"] = "1"
    n0 = _fused()
    got = _port_conv(x, w, b, stride, getattr(Activation, act),
                     bias).numpy()
    d = {s: v - n0[s] for s, v in _fused().items()}
    assert d == {s: int(s == want_site) for s in ("conv", "conv_matmul")}
    np.testing.assert_allclose(got, want, rtol=FWD_TOL, atol=FWD_TOL)


def test_pointwise_conv_gradients_match_jax():
    """Through conv_forward on the forced route: the relu mask from the
    saved output, dW back in OIHW, db from Σg."""
    x, w, b = _conv_inputs(7)
    r = np.random.RandomState(8)
    wy = r.randn(2, 7, 6, 40).astype(np.float32)

    def jloss(x, w, b):
        y = conv_pallas.conv_forward(
            x, w, window_strides=(1, 1), padding="SAME",
            rhs_dilation=(1, 1), dimension_numbers=("NHWC", "HWIO", "NHWC"),
            bias=b, activation=JAct.RELU)
        return jnp.sum(y * wy)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(x, w, b)
    Environment.get().extra["fused_conv"] = "1"
    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(np.ascontiguousarray(w.transpose(3, 2, 0, 1)),
                      requires_grad=True)
    tb = torch.tensor(b, requires_grad=True)
    y = ce.conv_forward(tx, tw, stride=(1, 1), padding="SAME", bias=tb,
                        activation=Activation.RELU)
    (y * torch.from_numpy(wy)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg[0]),
                               rtol=GRAD_TOL, atol=GRAD_TOL)
    np.testing.assert_allclose(tw.grad.numpy().transpose(2, 3, 1, 0),
                               np.asarray(jg[1]), rtol=GRAD_TOL,
                               atol=GRAD_TOL)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jg[2]),
                               rtol=GRAD_TOL, atol=GRAD_TOL)
