"""The port's paged decode attention, its ladder and the token sampler
against the JAX package, on the CPU.

On the CPU the port's ``paged_decode_attention`` runs its kernel's plain
version (``paged_attention_reference``); the JAX package runs its Pallas
kernel in interpret mode (``interpret=None`` off a TPU) and its own
reference. The same numpy inputs go through both: ragged lengths, lengths
on and across block boundaries, a dead decode slot (an all-zero table,
length 1), a length past the table, f32 and bf16 pools. Tolerance 1e-5
absolute on unit-normal inputs (both sides sum in f32, in other orders).
An interpret-mode call costs seconds here, so the JAX results are
computed once per module.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops.attention_pallas import \
    paged_attention_reference as jax_paged_ref
from deeplearning4j_tpu.ops.attention_pallas import \
    paged_decode_attention as jax_paged
from deeplearning4j_tpu.ops.sampling import sample_logits as jax_sample
from deeplearning4j_tpu.ops.sampling import top_k_filter as jax_top_k
from deeplearning4j_tpu_torch.common.environment import Environment
from deeplearning4j_tpu_torch.ops import attention_kernels as ak
from deeplearning4j_tpu_torch.ops import cuda_build, kernel_select
from deeplearning4j_tpu_torch.ops import sampling
from torch_parity import one_intraop_thread  # noqa: F401,E402

TOL = dict(rtol=0.0, atol=1e-5)
B, H, D, BLOCK, MAX_BLOCKS, NUM_BLOCKS = 6, 2, 16, 4, 5, 24
#: the dead slot, a single token, a block boundary, one past it, a full
#: table, and a length past the table (clamped to MAX_BLOCKS * BLOCK)
LENGTHS = [1, 3, 4, 5, MAX_BLOCKS * BLOCK, MAX_BLOCKS * BLOCK + 3]


def _inputs(pool_dtype: str):
    rs = np.random.RandomState(0)
    q = rs.randn(B, H, D).astype(np.float32)
    k = rs.randn(NUM_BLOCKS, BLOCK, H, D).astype(np.float32)
    v = rs.randn(NUM_BLOCKS, BLOCK, H, D).astype(np.float32)
    if pool_dtype == "bfloat16":     # values a bf16 pool holds exactly
        k = np.array(jnp.asarray(k, jnp.bfloat16).astype(jnp.float32))
        v = np.array(jnp.asarray(v, jnp.bfloat16).astype(jnp.float32))
    tables = np.zeros((B, MAX_BLOCKS), np.int32)
    for i, n in enumerate(LENGTHS[1:], start=1):
        used = min(MAX_BLOCKS, -(-n // BLOCK))
        tables[i, :used] = rs.choice(np.arange(1, NUM_BLOCKS), used,
                                     replace=False)
    return q, k, v, tables, np.asarray(LENGTHS, np.int32)


@pytest.fixture(scope="module")
def jax_results():
    out = {}
    for dt in ("float32", "bfloat16"):
        q, k, v, tables, lengths = _inputs(dt)
        kj = jnp.asarray(k, getattr(jnp, dt))
        vj = jnp.asarray(v, getattr(jnp, dt))
        args = (jnp.asarray(q), kj, vj, jnp.asarray(tables),
                jnp.asarray(lengths))
        out[dt] = (np.asarray(jax_paged(*args, interpret=True)),
                   np.asarray(jax_paged_ref(*args)))
    return out


def _port(dt, fn=ak.paged_decode_attention):
    q, k, v, tables, lengths = _inputs(dt)
    tdt = getattr(torch, dt)
    return fn(torch.from_numpy(q), torch.from_numpy(k).to(tdt),
              torch.from_numpy(v).to(tdt), torch.from_numpy(tables),
              torch.from_numpy(lengths)).numpy()


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_plain_version_matches_jax_pallas_kernel(jax_results, dt):
    got = _port(dt, ak.paged_attention_reference)
    np.testing.assert_allclose(got, jax_results[dt][0], **TOL)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_plain_version_matches_jax_reference(jax_results, dt):
    np.testing.assert_allclose(_port(dt, ak.paged_attention_reference),
                               jax_results[dt][1], **TOL)


#: shapes of the staged body's cluster split on the card (P = ceil(
#: max_blocks / 32) ranks a (head, sequence), rank r folding the valid
#: blocks [r * n / P, (r + 1) * n / P) of n): lengths one either side of
#: the partition edge of a full table at P = 2, and sequences of 1..3
#: valid blocks; at P = 3 sequences of 1 or 2 valid blocks, so a tail
#: rank folds no token; and d = 80, which the card runs on its general
#: body
SPLIT_CASES = {
    "partition_edges": dict(h=2, d=16, block=4, max_blocks=40,
                            lengths=[4, 8, 9, 79, 80, 81, 160, 165]),
    "empty_tail_partition": dict(h=2, d=16, block=2, max_blocks=65,
                                 lengths=[1, 2, 4, 5]),
    "head_dim_80": dict(h=2, d=80, block=4, max_blocks=5,
                        lengths=[1, 3, 4, 5, 20, 23]),
}


def _split_inputs(case: str, dt: str):
    c = SPLIT_CASES[case]
    h, d, block, mb, lengths = (c["h"], c["d"], c["block"],
                                c["max_blocks"], c["lengths"])
    b = len(lengths)
    nb = b * mb + 1
    rs = np.random.RandomState(7)
    q = rs.randn(b, h, d).astype(np.float32)
    k = rs.randn(nb, block, h, d).astype(np.float32)
    v = rs.randn(nb, block, h, d).astype(np.float32)
    if dt == "bfloat16":
        k = np.array(jnp.asarray(k, jnp.bfloat16).astype(jnp.float32))
        v = np.array(jnp.asarray(v, jnp.bfloat16).astype(jnp.float32))
    tables = np.zeros((b, mb), np.int32)
    perm = rs.permutation(np.arange(1, nb))
    for i, n in enumerate(lengths):
        used = min(mb, -(-n // block))
        tables[i, :used] = perm[i * mb:i * mb + used]
    return q, k, v, tables, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("case", list(SPLIT_CASES))
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_plain_version_matches_jax_at_cluster_split_shapes(case, dt):
    """The port against JAX's Pallas kernel (interpret mode) and JAX's
    reference at the lengths and shapes where the card's staged body
    splits a sequence across its cluster's ranks."""
    q, k, v, tables, lengths = _split_inputs(case, dt)
    jdt = getattr(jnp, dt)
    jargs = (jnp.asarray(q), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
             jnp.asarray(tables), jnp.asarray(lengths))
    tdt = getattr(torch, dt)
    got = ak.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k).to(tdt),
        torch.from_numpy(v).to(tdt), torch.from_numpy(tables),
        torch.from_numpy(lengths)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jax_paged(*jargs, interpret=True)), **TOL)
    np.testing.assert_allclose(got, np.asarray(jax_paged_ref(*jargs)),
                               **TOL)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_wrapper_on_cpu_is_the_plain_version(dt):
    n0 = ak.PAGED_DECODE.launches
    np.testing.assert_array_equal(_port(dt),
                                  _port(dt, ak.paged_attention_reference))
    assert ak.PAGED_DECODE.launches == n0      # nothing launched


def test_length_past_the_table_is_clamped():
    """A length past max_blocks * block attends over the whole table,
    exactly as the length max_blocks * block does."""
    q, k, v, tables, lengths = _inputs("float32")
    args = [torch.from_numpy(a) for a in (q, k, v, tables)]
    full = ak.paged_attention_reference(
        *args, torch.full((B,), MAX_BLOCKS * BLOCK, dtype=torch.int32))
    past = ak.paged_attention_reference(
        *args, torch.full((B,), 10 * MAX_BLOCKS * BLOCK, dtype=torch.int32))
    assert torch.equal(full, past)


def test_output_keeps_q_dtype_and_scale_is_honoured():
    q, k, v, tables, lengths = _inputs("float32")
    t = [torch.from_numpy(a) for a in (q, k, v, tables, lengths)]
    out = ak.paged_attention_reference(t[0].to(torch.bfloat16), *t[1:])
    assert out.dtype == torch.bfloat16
    s2 = ak.paged_attention_reference(t[0] * 2.0, *t[1:], scale=0.125)
    s1 = ak.paged_attention_reference(t[0], *t[1:], scale=0.25)
    torch.testing.assert_close(s2, s1, **TOL)


def test_wrapper_raises_off_cpu_and_cuda():
    """A tensor on neither the CPU nor the card has no route: no silent
    fallback to the plain version."""
    q, k, v, tables, lengths = (torch.from_numpy(a).to("meta")
                                for a in _inputs("float32"))
    with pytest.raises(ValueError, match="no kernel"):
        ak.paged_decode_attention(q, k, v, tables, lengths)


def test_kernel_is_registered_with_its_tpu_kernel():
    k = cuda_build.KERNELS["paged_decode"]
    assert k is ak.PAGED_DECODE
    assert k.source.endswith("csrc/paged_attention.cu")
    assert k.replaces.startswith("deeplearning4j_tpu/ops/attention_pallas.py:")


# ---------------------------------------------------------------------------
# the paged_attention ladder
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("device,override,want,decision", [
    ("cuda", None, "paged", "auto_fused"),
    ("cpu", None, "dense", "auto_dense"),
    ("cuda", False, "dense", "killed"),
    ("cpu", True, "paged", "forced"),
])
def test_ladder_rungs(device, override, want, decision):
    before = kernel_select.decisions("paged_attention")[decision]
    backend, reason = ak.select_paged_backend(
        4, 8, device=device, override=override, use_env_override=False)
    assert backend == want, reason
    assert kernel_select.decisions("paged_attention")[decision] == before + 1


@pytest.mark.parametrize("batch,blocks", [(0, 8), (4, 0)])
def test_ladder_demotes_degenerate_shapes_whatever_the_override(batch,
                                                                blocks):
    backend, reason = ak.select_paged_backend(batch, blocks, device="cuda",
                                              override=True)
    assert backend == "dense" and "degenerate" in reason


@pytest.mark.parametrize("flag,want", [("0", "dense"), ("1", "paged")])
def test_ladder_reads_the_gate(monkeypatch, flag, want):
    monkeypatch.setitem(Environment.get().extra, "paged_attention", flag)
    assert ak.select_paged_backend(4, 8, device="cuda")[0] == want
    assert kernel_select.gate_override("paged_attention") is (flag == "1")
    monkeypatch.delitem(Environment.get().extra, "paged_attention")
    monkeypatch.setenv("DL4J_TORCH_PAGED_ATTENTION", flag)
    assert ak.select_paged_backend(4, 8, device="cpu")[0] == want


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------
def test_top_k_filter_equals_jax():
    rs = np.random.RandomState(3)
    logits = rs.randn(5, 16).astype(np.float32)
    logits[2, :5] = [5.0, 5.0, 4.0, 4.0, 4.0]   # ties at the 3rd largest
    top_k = np.asarray([0, 1, 3, 16, 40], np.int32)
    want = np.asarray(jax_top_k(logits, top_k))
    got = sampling.top_k_filter(torch.from_numpy(logits),
                                torch.from_numpy(top_k)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[2] > sampling.NEG_INF).sum() == 5      # ties kept


def test_greedy_is_argmax_and_rides_the_sampling_call():
    logits = np.random.default_rng(0).normal(size=(4, 16)).astype(
        np.float32)
    lt = torch.from_numpy(logits)
    assert sampling.greedy(lt).tolist() == list(np.argmax(logits, -1))
    g = torch.Generator().manual_seed(1)
    ids0 = sampling.sample_logits(lt, g, torch.zeros(4), torch.zeros(4))
    assert ids0.dtype == torch.int32
    assert ids0.tolist() == list(np.argmax(logits, -1))
    assert ids0.tolist() == list(np.asarray(jax_sample(
        logits, jax.random.PRNGKey(1), np.zeros(4, np.float32),
        np.zeros(4, np.int32))))
    # greedy and sampled rows in one call: the greedy rows stay argmax
    mixed = sampling.sample_logits(lt, g, torch.tensor([0.0, 1.0, 0.0, 2.0]))
    assert mixed[0] == ids0[0] and mixed[2] == ids0[2]


def test_same_generator_seed_same_sample():
    logits = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 32)).astype(np.float32))
    a = sampling.sample_logits(logits, torch.Generator().manual_seed(7))
    b = sampling.sample_logits(logits, torch.Generator().manual_seed(7))
    assert a.tolist() == b.tolist()


def test_top_k_restricts_support():
    logits = torch.arange(16, dtype=torch.float32)[None, :]
    g = torch.Generator().manual_seed(0)
    for _ in range(20):
        t = int(sampling.sample_logits(logits, g, 2.0, 3)[0])
        assert t in {13, 14, 15}


def test_distribution_tracks_logit_mass():
    """~2:1 logit odds come out ~2:1 (the JAX package's own check)."""
    logits = torch.log(torch.tensor([[2.0, 1.0, 1e-9]]))
    draws = sampling.sample_logits(logits.repeat(600, 1),
                                   torch.Generator().manual_seed(0), 1.0)
    counts = np.bincount(draws.numpy(), minlength=3)
    assert counts[2] == 0
    assert 0.5 < counts[0] / max(counts[1], 1) * 0.5 < 2.0
