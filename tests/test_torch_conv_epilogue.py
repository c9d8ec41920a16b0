"""ops/conv_epilogue.py against the JAX package's ops/conv_pallas.py.

On the CPU the port's ``scale_shift_act`` runs its plain version; it is
held against the JAX Pallas ``_epilogue_kernel``, which runs in
interpret mode on the CPU as tests/test_conv_pallas.py runs it. The
tolerance, rtol/atol 1e-6, allows XLA's CPU backend to contract the
multiply-add into an FMA where the port rounds twice. The ladder tests
mirror tests/test_kernel_select.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import conv_pallas
from deeplearning4j_tpu_torch.activations import Activation
from deeplearning4j_tpu_torch.common.environment import Environment
from deeplearning4j_tpu_torch.ops import conv_epilogue as ce
from deeplearning4j_tpu_torch.ops import kernel_select
from torch_parity import one_intraop_thread  # noqa: F401,E402


@pytest.fixture(autouse=True)
def _clean_extra(monkeypatch):
    monkeypatch.delenv("DL4J_TORCH_FUSED_CONV", raising=False)
    env = Environment.get()
    saved = env.extra.pop("fused_conv", None)
    yield
    env.extra.pop("fused_conv", None)
    if saved is not None:
        env.extra["fused_conv"] = saved


def _inputs(shape, seed, nan=False):
    r = np.random.RandomState(seed)
    x = r.randn(*shape).astype(np.float32)
    if nan:
        x.reshape(-1)[::7] = np.nan
    C = shape[-1]
    s = (1.0 + 0.3 * r.randn(C)).astype(np.float32)
    b = (0.2 * r.randn(C)).astype(np.float32)
    return x, s, b


@pytest.mark.parametrize("act", ["relu", "identity"])
@pytest.mark.parametrize("shape,nan", [
    ((2, 5, 5, 16), False),          # M = 50: ragged against 8-row tiles
    ((4, 8, 8, 32), False),
    ((40, 24), False),               # 2-D features
    ((3, 7, 7, 6), False),           # C off the vector width
    ((2, 5, 5, 16), True),           # NaN propagates through relu
])
def test_plain_matches_pallas_interpret(shape, nan, act):
    x, s, b = _inputs(shape, 1, nan)
    want = np.asarray(conv_pallas.scale_shift_act(
        jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), act))
    n0 = ce.EPILOGUE.launches
    got = ce.scale_shift_act(torch.from_numpy(x), torch.from_numpy(s),
                             torch.from_numpy(b), act).numpy()
    assert ce.EPILOGUE.launches == n0      # the CPU never launches
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.array_equal(np.isnan(got), np.isnan(want))


@pytest.mark.parametrize("act", ["relu", "identity"])
def test_plain_bf16_matches_pallas_interpret(act):
    """bf16 in, f32 arithmetic, bf16 out; one bf16 ulp (2^-7 relative)
    covers a differently rounded f32 intermediate."""
    x, s, b = _inputs((4, 6, 6, 32), 2)
    want = np.asarray(conv_pallas.scale_shift_act(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(s), jnp.asarray(b),
        act).astype(jnp.float32))
    got = ce.scale_shift_act(torch.from_numpy(x).bfloat16(),
                             torch.from_numpy(s), torch.from_numpy(b),
                             act)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=1e-6)


def test_wrapper_refuses_other_devices_and_activations():
    x = torch.zeros(4, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ce.scale_shift_act(x, torch.ones(8), torch.zeros(8), "relu")
    with pytest.raises(ValueError, match="not streamable"):
        ce.scale_shift_act_plain(torch.zeros(4, 8), torch.ones(8),
                                 torch.zeros(8), "tanh")


@pytest.mark.parametrize("size,k,stride", [
    (224, 7, 2), (112, 3, 2), (56, 3, 1), (56, 1, 2), (7, 3, 2),
    (8, 3, 2), (9, 4, 1)])
def test_same_padding_matches_xla(size, k, stride):
    from jax import lax
    (want,) = lax.padtype_to_pads((size,), (k,), (stride,), "SAME")
    assert ce.same_padding(size, k, stride) == tuple(want)


# ---------------------------------------------------------------------------
# the ladder
# ---------------------------------------------------------------------------
def _delta(fn):
    before = kernel_select.decisions("conv_epilogue")
    out = fn()
    after = kernel_select.decisions("conv_epilogue")
    return out, {d: after[d] - before[d] for d in after
                 if after[d] != before[d]}


def test_structural_gate_dominates_force():
    sel, counts = _delta(lambda: kernel_select.select(
        "conv_epilogue", structural="dtype torch.int32 is not floating",
        auto=(True, "auto"), override=True, use_env_override=False))
    assert not sel.fused and sel.decision == "structural"
    assert counts == {"structural": 1}


def test_force_and_kill_beat_auto():
    sel, counts = _delta(lambda: kernel_select.select(
        "conv_epilogue", auto=(False, "no"), override=True,
        use_env_override=False))
    assert sel.fused and sel.decision == "forced"
    assert sel.reason == "DL4J_TORCH_FUSED_CONV=1 forced"
    assert counts == {"forced": 1}
    sel, counts = _delta(lambda: kernel_select.select(
        "conv_epilogue", auto=(True, "yes"), override=False,
        use_env_override=False))
    assert not sel.fused and sel.decision == "killed"
    assert sel.reason == "DL4J_TORCH_FUSED_CONV=0 kill switch"
    assert counts == {"killed": 1}


def test_auto_thunk_decides_when_unset():
    sel, counts = _delta(lambda: kernel_select.select(
        "conv_epilogue", auto=lambda: (True, "auto: measured"),
        override=None, use_env_override=False))
    assert sel.fused and sel.decision == "auto_fused"
    assert counts == {"auto_fused": 1}


def test_extra_overrides_env_var(monkeypatch):
    monkeypatch.setenv("DL4J_TORCH_FUSED_CONV", "0")
    assert kernel_select.gate_override("conv_epilogue") is False
    Environment.get().extra["fused_conv"] = "1"
    assert kernel_select.gate_override("conv_epilogue") is True


@pytest.mark.parametrize("device,fused", [("cuda", True), ("cpu", False)])
def test_auto_rung_takes_the_kernel_on_the_card(device, fused):
    # TPU tiling gates do not carry over: C = 3 and a tiny site are
    # admissible on the card
    sel = ce.select_conv_epilogue((2, 3), torch.float32, "relu",
                                  device=device)
    assert sel.fused is fused
    assert sel.decision == ("auto_fused" if fused else "auto_dense")


def test_kill_switch_is_counted(monkeypatch):
    monkeypatch.setenv("DL4J_TORCH_FUSED_CONV", "0")
    sel, counts = _delta(lambda: ce.select_conv_epilogue(
        (64, 64), torch.float32, "relu", device="cuda"))
    assert not sel.fused and counts == {"killed": 1}


@pytest.mark.parametrize("kw,reason", [
    (dict(act_name="relu", has_epilogue=False), "no epilogue"),
    (dict(act_name="tanh"), "not streamable"),
    (dict(act_name="relu", dtype=torch.int32), "not floating"),
    (dict(act_name="relu", out_shape=(8,)), "rank 1"),
])
def test_structural_reasons(kw, reason):
    args = dict(out_shape=(4, 8), dtype=torch.float32, device="cuda")
    args.update(kw)
    sel = ce.select_conv_epilogue(args.pop("out_shape"),
                                  args.pop("dtype"), args.pop("act_name"),
                                  override=True, **args)
    assert not sel.fused and sel.decision == "structural"
    assert reason in sel.reason


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.float64])
def test_every_floating_dtype_reaches_the_kernel_on_the_card(dtype):
    """No dtype gate: on the card a float site goes to the kernel, whose
    wrapper raises on a dtype it does not stream (float64) rather than
    the caller giving way to the plain version."""
    sel = ce.select_conv_epilogue((4, 8), dtype, "relu", device="cuda")
    assert sel.fused and sel.decision == "auto_fused"


@pytest.mark.parametrize("dtype,compute_dtype", [("float64", None),
                                                 ("float32", "float64")])
def test_float64_activations_are_refused_on_the_card(monkeypatch, dtype,
                                                     compute_dtype):
    from deeplearning4j_tpu_torch.models.zoo import ResNet50
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    conf = ResNet50(STAGES=((1, 8),), height=16, width=16, num_classes=4,
                    compute_dtype=compute_dtype).conf()
    conf.dtype = dtype
    with pytest.raises(ValueError, match="float64 activations"):
        ComputationGraph(conf).init("cuda")


def test_bn_epilogue_plain_on_cpu_and_forced():
    x, s, b = (torch.from_numpy(a) for a in _inputs((2, 4, 4, 8), 3))
    assert ce.maybe_bn_inference_epilogue(x, s, b, Activation.RELU) is None
    Environment.get().extra["fused_conv"] = "1"
    y = ce.maybe_bn_inference_epilogue(x, s, b, Activation.RELU)
    assert torch.equal(y, ce.scale_shift_act_plain(x, s, b, "relu"))


@pytest.mark.parametrize("gate", ["0", "1"])
def test_conv_forward_bias_relu_matches_jax(gate):
    """A conv with bias and relu has an epilogue: forced it runs
    conv + scale_shift_act, killed the plain conv with bias; both match
    the JAX package's conv_forward."""
    r = np.random.RandomState(4)
    x = r.randn(2, 9, 9, 5).astype(np.float32)
    w = (0.3 * r.randn(3, 3, 5, 8)).astype(np.float32)       # HWIO
    bias = r.randn(8).astype(np.float32)
    from deeplearning4j_tpu.activations import Activation as JAct
    want = np.asarray(conv_pallas.conv_forward(
        jnp.asarray(x), jnp.asarray(w), window_strides=(2, 2),
        padding="SAME", rhs_dilation=(1, 1),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        bias=jnp.asarray(bias), activation=JAct.RELU))
    Environment.get().extra["fused_conv"] = gate
    got = ce.conv_forward(
        torch.from_numpy(x),
        torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))),
        stride=(2, 2), padding="SAME", bias=torch.from_numpy(bias),
        activation=Activation.RELU)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
