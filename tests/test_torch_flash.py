"""The port's flash attention and attention dispatch against the JAX
package, on the CPU.

On the CPU the port's flash entry points run their kernels' plain
versions (``parallel/sequence.py``); the JAX package runs its Pallas
kernels in interpret mode (``interpret=None`` off a TPU). The same numpy
inputs go through both. Tolerances are the reference's own bars
(``tests/test_attention_pallas.py:38,75``): forward rtol 2e-5 / atol
2e-5, dq/dk/dv rtol 2e-4 / atol 2e-5 (both sides sum in f32 in other
orders; the gradients sum more terms). An interpret-mode call costs
seconds here, so the JAX results are computed once per module.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops.attention import \
    dot_product_attention as jax_dpa
from deeplearning4j_tpu.ops.attention import \
    multi_head_attention as jax_mha
from deeplearning4j_tpu.ops.attention_pallas import as_key_mask as jax_akm
from deeplearning4j_tpu.ops.attention_pallas import flash_sdpa as jax_sdpa
from deeplearning4j_tpu.ops.attention_pallas import \
    select_attention_backend as jax_select
from deeplearning4j_tpu.parallel.sequence import \
    flash_attention as jax_flash
from deeplearning4j_tpu.parallel.sequence import \
    flash_attention_with_lse as jax_flash_lse
from deeplearning4j_tpu_torch.common.environment import Environment
from deeplearning4j_tpu_torch.ops import attention as att
from deeplearning4j_tpu_torch.ops import attention_kernels as ak
from deeplearning4j_tpu_torch.ops import kernel_select
from deeplearning4j_tpu_torch.parallel import sequence as sq
from torch_parity import one_intraop_thread  # noqa: F401,E402

FWD = dict(rtol=2e-5, atol=2e-5)
GRAD = dict(rtol=2e-4, atol=2e-5)

#: name -> (b, h, tq, tk, d, causal, masked); blocks of 16 for the JAX
#: kernels, so 24 and 40 are not multiples of the block
CASES = {
    "key_mask": (2, 2, 24, 24, 16, False, True),
    "causal": (2, 2, 32, 32, 16, True, True),
    "cross": (2, 3, 16, 40, 8, False, True),
}


def _inputs(name):
    b, h, tq, tk, d, causal, masked = CASES[name]
    rs = np.random.RandomState(sorted(CASES).index(name))
    q, do = (rs.randn(b, h, tq, d).astype(np.float32) for _ in range(2))
    k, v = (rs.randn(b, h, tk, d).astype(np.float32) for _ in range(2))
    g_lse = rs.randn(b, h, tq).astype(np.float32)
    mask = None
    if masked:
        mask = (rs.rand(b, tk) > 0.3).astype(np.float32)
        mask[0] = 0.0                          # a fully masked sequence
        mask[-1, 0] = 1.0
    return dict(q=q, k=k, v=v, do=do, g_lse=g_lse, mask=mask,
                causal=causal)


def _jax_case(x):
    mask = None if x["mask"] is None else jnp.asarray(x["mask"])
    q, k, v = (jnp.asarray(x[n]) for n in "qkv")

    def loss_lse(q, k, v):
        out, lse = jax_flash_lse(q, k, v, x["causal"], 16, 16, None, mask)
        return (jnp.sum(out * x["do"]) + jnp.sum(lse * x["g_lse"]),
                (out, lse))

    def loss_out(q, k, v):
        return jnp.sum(jax_flash(q, k, v, x["causal"], 16, 16, None, mask)
                       * x["do"])

    (_, (out, lse)), g_lse = jax.value_and_grad(
        loss_lse, argnums=(0, 1, 2), has_aux=True)(q, k, v)
    g_out = jax.grad(loss_out, argnums=(0, 1, 2))(q, k, v)
    return {"out": np.asarray(out), "lse": np.asarray(lse),
            "grads_with_lse": [np.asarray(a) for a in g_lse],
            "grads": [np.asarray(a) for a in g_out]}


@pytest.fixture(scope="module")
def jax_results():
    return {name: _jax_case(_inputs(name)) for name in CASES}


def _port(x, with_lse: bool):
    q, k, v = (torch.tensor(x[n], requires_grad=True) for n in "qkv")
    mask = None if x["mask"] is None else torch.tensor(x["mask"])
    do = torch.tensor(x["do"])
    if with_lse:
        out, lse = sq.flash_attention_with_lse(q, k, v, x["causal"], mask)
        loss = (out * do).sum() + (lse * torch.tensor(x["g_lse"])).sum()
    else:
        out = sq.flash_attention(q, k, v, x["causal"], mask)
        lse = None
        loss = (out * do).sum()
    grads = torch.autograd.grad(loss, (q, k, v))
    return out.detach(), lse, [g.numpy() for g in grads]


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_and_lse_match_jax_kernel(name, jax_results):
    x, want = _inputs(name), jax_results[name]
    out, lse, _ = _port(x, with_lse=True)
    np.testing.assert_allclose(out.numpy(), want["out"], **FWD)
    np.testing.assert_allclose(lse.detach().numpy(), want["lse"], **FWD)
    if x["mask"] is not None:
        # the fully masked sequence: exact zeros in both packages
        assert not out[0].any() and not np.any(want["out"][0])


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("with_lse", [False, True],
                         ids=["out_cotangent", "lse_cotangent"])
def test_gradients_match_jax_custom_vjp(name, with_lse, jax_results):
    x, want = _inputs(name), jax_results[name]
    _, _, grads = _port(x, with_lse)
    ref = want["grads_with_lse" if with_lse else "grads"]
    for nm, got, w in zip("qkv", grads, ref):
        np.testing.assert_allclose(got, w, **GRAD, err_msg=f"d{nm}")
        assert np.isfinite(got).all()
    if x["mask"] is not None:
        assert not grads[0][0].any()           # dq of the masked sequence


@pytest.fixture(scope="module")
def sdpa_case():
    rs = np.random.RandomState(7)
    q, k, v, do = (rs.randn(2, 20, 8).astype(np.float32) for _ in range(4))
    mask = (rs.rand(2, 20) > 0.25).astype(np.float32)

    def loss(q, k, v):
        out = jax_sdpa(q, k, v, 0.37, key_mask=jnp.asarray(mask),
                       block_q=16, block_k=16)
        return jnp.sum(out * do), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                         has_aux=True)(q, k, v)
    return dict(q=q, k=k, v=v, do=do, mask=mask, out=np.asarray(out),
                grads=[np.asarray(g) for g in grads])


def test_rank3_flash_sdpa_with_a_scale_matches_jax(sdpa_case):
    c = sdpa_case
    q, k, v = (torch.tensor(c[n], requires_grad=True) for n in "qkv")
    out = ak.flash_sdpa(q, k, v, 0.37, key_mask=torch.tensor(c["mask"]))
    assert out.shape == (2, 20, 8)
    np.testing.assert_allclose(out.detach().numpy(), c["out"], **FWD)
    grads = torch.autograd.grad((out * torch.tensor(c["do"])).sum(),
                                (q, k, v))
    for got, want in zip(grads, c["grads"]):
        np.testing.assert_allclose(got.numpy(), want, **GRAD)


def test_bool_key_mask_is_the_float_mask():
    rs = np.random.RandomState(3)
    q, k, v = (torch.tensor(rs.randn(2, 2, 9, 4)) for _ in range(3))
    m = torch.tensor(rs.rand(2, 9) > 0.4)
    assert torch.equal(sq.flash_attention(q, k, v, key_mask=m),
                       sq.flash_attention(q, k, v, key_mask=m.double()))


@pytest.mark.parametrize("causal", [False, True])
def test_gradcheck_float64(causal):
    rs = np.random.RandomState(11)
    q, k, v = (torch.tensor(rs.randn(2, 2, 5, 3), requires_grad=True)
               for _ in range(3))
    mask = torch.tensor([[1.0, 1.0, 0.0, 1.0, 1.0], [0.0] * 5])
    assert torch.autograd.gradcheck(
        lambda q, k, v: sq.flash_attention(q, k, v, causal, mask),
        (q, k, v))
    assert torch.autograd.gradcheck(
        lambda q, k, v: sq.flash_attention_with_lse(q, k, v, causal, mask),
        (q, k, v))


def test_plain_versions_round_low_precision_where_the_kernels_do():
    """bf16 inputs: outputs in the inputs' dtype, lse in f32, and the
    products taken on p and ds rounded to bf16."""
    rs = np.random.RandomState(5)
    q, k, v, do = (torch.tensor(rs.randn(1, 2, 6, 4), dtype=torch.bfloat16)
                   for _ in range(4))
    out, lse = sq.flash_forward_plain(q, k, v)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    delta = sq.flash_delta(out, do)
    dq = sq.flash_dq_plain(q, k, v, do, lse, delta)
    dk, dv = sq.flash_dkv_plain(q, k, v, do, lse, delta)
    assert {t.dtype for t in (dq, dk, dv)} == {torch.bfloat16}
    ref, _ = sq.flash_forward_plain(q.float(), k.float(), v.float())
    torch.testing.assert_close(out.float(), ref, rtol=2e-2, atol=2e-2)


# ---------------------------------------------------------------------------
# dispatch: key-mask reduction and backend selection, case by case
# ---------------------------------------------------------------------------
MASK_SHAPES = [(2, 1, 1, 7), (1, 1, 1, 7), (7,), (1, 7), (2, 1, 7),
               (2, 1, 5, 7), (2, 3, 1, 7), (3, 1, 1, 7), (2, 1, 1, 6), ()]


@pytest.mark.parametrize("shape", MASK_SHAPES, ids=str)
def test_as_key_mask_matches_jax(shape):
    m = np.asarray(np.random.RandomState(1).rand(*shape) > 0.5, np.float32)
    want = jax_akm(jnp.asarray(m), 2, 7, 4)
    got = ak.as_key_mask(torch.tensor(m), 2, 7, 4)
    assert (got is None) == (want is None)
    if want is not None:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


STRUCTURAL = [  # (q_shape, k_shape, kwargs)
    ((2, 2, 8, 4), (2, 2, 8, 4), {"has_bias": True}),
    ((2, 2, 1, 8, 4), (2, 2, 1, 8, 4), {}),
    ((8, 4), (8, 4), {}),
    ((2, 2, 8, 4), (2, 8, 4), {}),
    ((2, 2, 8, 4), (2, 2, 8, 6), {}),
    ((2, 2, 8, 4), (2, 2, 8, 4), {"mask_ok": False}),
]


@pytest.mark.parametrize("case", STRUCTURAL,
                         ids=lambda c: f"{c[0]}x{c[1]}{c[2]}")
def test_structural_rungs_match_jax(case):
    qs, ks, kw = case
    want = jax_select(qs, ks, platform="tpu", override=True, **kw)
    got = ak.select_attention_backend(qs, ks, device="cuda", override=True,
                                      **kw)
    assert got == want and got[0] == "dense"


@pytest.mark.parametrize("device,override,want", [
    ("cuda", None, "flash"), ("cpu", None, "dense"),
    ("cuda", False, "dense"), ("cpu", True, "flash")])
def test_override_and_auto_rungs(device, override, want):
    before = kernel_select.decisions("attention")
    backend, reason = ak.select_attention_backend(
        (2, 2, 8, 4), (2, 2, 8, 4), device=device, override=override,
        use_env_override=False)
    assert backend == want
    if override is False:
        assert "DL4J_TORCH_FLASH_ATTENTION=0" in reason
        assert jax_select((2, 2, 8, 4), (2, 2, 8, 4), platform="tpu",
                          override=False)[0] == "dense"
    after = kernel_select.decisions("attention")
    assert sum(after.values()) == sum(before.values()) + 1


def test_env_gate_reads_extra_before_the_environment(monkeypatch):
    monkeypatch.setenv("DL4J_TORCH_FLASH_ATTENTION", "0")
    extra = Environment.get().extra
    assert kernel_select.gate_override("attention") is False
    extra["flash_attention"] = "1"
    try:
        assert kernel_select.gate_override("attention") is True
    finally:
        extra.pop("flash_attention")


# ---------------------------------------------------------------------------
# ops/attention.py: the dense path, and the flash route it dispatches to
# ---------------------------------------------------------------------------
def _attn_inputs(seed=2):
    rs = np.random.RandomState(seed)
    q, k, v = (rs.randn(2, 3, 10, 8).astype(np.float32) for _ in range(3))
    mask = (rs.rand(2, 1, 1, 10) > 0.3).astype(np.float32)
    mask[1] = 0.0
    bias = rs.randn(2, 3, 10, 10).astype(np.float32)
    return q, k, v, mask, bias


@pytest.mark.parametrize("form", ["mask", "bias", "scale", "none"])
@pytest.mark.parametrize("gate", [None, "1", "0"])
def test_dot_product_attention_matches_jax_dense(form, gate):
    """The JAX dense path (the auto rung off a TPU) against the port's
    dense path (gate unset or killed on the CPU) and its flash route
    (forced: the kernels' plain versions), same inputs."""
    q, k, v, mask, bias = _attn_inputs()
    kw = {"mask": {"mask": mask}, "bias": {"bias": bias, "mask": mask},
          "scale": {"scale": 0.41, "mask": mask}, "none": {}}[form]
    want = np.asarray(jax_dpa(*(jnp.asarray(a) for a in (q, k, v)),
                              **{n: jnp.asarray(a) if n != "scale" else a
                                 for n, a in kw.items()}))
    extra = Environment.get().extra
    if gate is not None:
        extra["flash_attention"] = gate
    try:
        got = att.dot_product_attention(
            *(torch.tensor(a) for a in (q, k, v)),
            **{n: torch.tensor(a) if n != "scale" else a
               for n, a in kw.items()})
    finally:
        extra.pop("flash_attention", None)
    np.testing.assert_allclose(got.numpy(), want, **FWD)


def test_dense_dropout_takes_the_generator():
    q, k, v, mask, _ = _attn_inputs()
    t = [torch.tensor(a) for a in (q, k, v, mask)]

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return att.dot_product_attention(*t[:3], t[3], dropout_generator=g,
                                         dropout_rate=0.5)
    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    plain = att.dot_product_attention(*t[:3], t[3])
    assert not torch.equal(a, plain)


def test_multi_head_attention_matches_jax():
    rs = np.random.RandomState(9)
    p = {n: rs.randn(*s).astype(np.float32) * 0.3 for n, s in
         [("Wq", (6, 8)), ("Wk", (5, 8)), ("Wv", (5, 8)), ("Wo", (8, 7)),
          ("bq", (8,)), ("bo", (7,))]}
    q_in = rs.randn(2, 4, 6).astype(np.float32)
    kv_in = rs.randn(2, 9, 5).astype(np.float32)
    km = (rs.rand(2, 9) > 0.3).astype(np.float32)
    want = jax_mha({n: jnp.asarray(a) for n, a in p.items()},
                   jnp.asarray(q_in), jnp.asarray(kv_in), 2, jnp.asarray(km))
    got = att.multi_head_attention({n: torch.tensor(a) for n, a in
                                    p.items()}, torch.tensor(q_in),
                                   torch.tensor(kv_in), 2, torch.tensor(km))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)
