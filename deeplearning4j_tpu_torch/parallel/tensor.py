"""Tensor (model) parallelism: megatron-style layer sharding.

Counterpart of ``deeplearning4j_tpu/parallel/tensor.py``. Weight
matrices are split across a mesh ``model`` axis and the axis collectives
of :mod:`.mesh` stitch the math back together:

- **column parallel**: ``W: [d_in, d_out/tp]``, input replicated, output
  feature-sharded, no communication;
- **row parallel**: ``W: [d_in/tp, d_out]``, input feature-sharded, the
  output a psum over the axis; the bias added once, after the sum.

A transformer block does column then row for the QKV / out-projection
pair (heads shard over ``model``) and for the MLP's up / down pair.

**Megatron sequence parallelism** (``sequence_parallel=True``): the
residual stream stays sharded along time over the same ``model`` axis in
the norm / residual regions; each all-reduce becomes an all_gather
entering a TP region and a psum_scatter leaving it.

These functions run inside a replica (:func:`.mesh.replica_scope`), as
the JAX package's run inside ``shard_map``; ``axis`` is the mesh axis
name. Each collective's backward is its transpose (:mod:`.mesh`).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ops.attention import dot_product_attention
from deeplearning4j_tpu_torch.parallel.mesh import (P, all_gather, psum,
                                                    psum_scatter)

MODEL_AXIS = "model"


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


# ---------------------------------------------------------------------------
# parallel dense primitives
# ---------------------------------------------------------------------------
def column_parallel_dense(x, w, b=None):
    """x replicated over tp, w/b local output shards -> sharded output."""
    y = x @ w
    if b is not None:
        y = y + b
    return y


def row_parallel_dense(x, w, b=None, axis: str = MODEL_AXIS):
    """x feature-sharded, w a local input shard -> the full output (the
    psum is the TP all-reduce)."""
    y = psum(x @ w, axis)
    if b is not None:
        y = y + b
    return y


def row_parallel_dense_scatter(x, w, b=None, axis: str = MODEL_AXIS,
                               seq_dim: int = 1):
    """Row-parallel dense that leaves the output sequence-sharded: a
    psum_scatter over ``axis`` along ``seq_dim`` (the exit collective of
    a TP region under Megatron-SP)."""
    y = psum_scatter(x @ w, axis, seq_dim)
    if b is not None:
        y = y + b
    return y


def sp_all_gather(x, axis: str = MODEL_AXIS, seq_dim: int = 1):
    """Gather the time dimension from the model axis (enter a TP
    region)."""
    return all_gather(x, axis, seq_dim)


# ---------------------------------------------------------------------------
# TP transformer pieces
# ---------------------------------------------------------------------------
def tp_mlp(x, params, axis: str = MODEL_AXIS,
           activation: Callable = gelu, sequence_parallel: bool = False):
    """Column -> row parallel two-layer MLP. ``params``: ``Wi [d,
    ff/tp]``, ``bi [ff/tp]``, ``Wo [ff/tp, d]``, ``bo [d]``. With
    ``sequence_parallel`` x is ``[b, t/tp, d]`` in and out."""
    if sequence_parallel:
        x = sp_all_gather(x, axis)
    h = activation(column_parallel_dense(x, params["Wi"], params["bi"]))
    if sequence_parallel:
        return row_parallel_dense_scatter(h, params["Wo"], params["bo"],
                                          axis)
    return row_parallel_dense(h, params["Wo"], params["bo"], axis)


def tp_self_attention(x, params, n_heads_local: int,
                      axis: str = MODEL_AXIS, mask=None,
                      sequence_parallel: bool = False):
    """Multi-head self-attention with heads sharded over ``axis``.
    ``params``: ``Wq/Wk/Wv [d, h_local*dh]``, ``Wo [h_local*dh, d]``,
    ``bo [d]``. x: ``[b, t, d]`` (``[b, t/tp, d]`` under
    sequence_parallel). ``mask`` broadcasts to ``[b, h, t, t]``, 0 =
    masked (a per-query mask takes the dense path, as in the JAX
    package)."""
    if sequence_parallel:
        x = sp_all_gather(x, axis)
    b, t, _ = x.shape
    dh = params["Wq"].shape[-1] // n_heads_local

    def heads(a):
        return a.reshape(b, t, n_heads_local, dh).transpose(1, 2)

    q = heads(x @ params["Wq"])
    k = heads(x @ params["Wk"])
    v = heads(x @ params["Wv"])
    o = dot_product_attention(q, k, v, mask)
    o = o.transpose(1, 2).reshape(b, t, n_heads_local * dh)
    if sequence_parallel:
        return row_parallel_dense_scatter(o, params["Wo"], params["bo"],
                                          axis)
    return row_parallel_dense(o, params["Wo"], params["bo"], axis)


def layer_norm(x, g, b, eps: float = 1e-5):
    m = x.mean(-1, keepdim=True)
    v = (x - m).square().mean(-1, keepdim=True)
    return (x - m) * torch.rsqrt(v + eps) * g + b


def tp_transformer_block(x, params, n_heads_local: int,
                         axis: str = MODEL_AXIS, mask=None,
                         activation: Callable = gelu,
                         sequence_parallel: bool = False,
                         mlp_fn: Optional[Callable] = None):
    """Pre-LN transformer block, TP (optionally Megatron-SP) sharded;
    ``mlp_fn(h) -> h`` overrides the dense MLP (the MoE hook)."""
    h = layer_norm(x, params["ln1_g"], params["ln1_b"])
    x = x + tp_self_attention(h, params["attn"], n_heads_local, axis,
                              mask, sequence_parallel=sequence_parallel)
    h = layer_norm(x, params["ln2_g"], params["ln2_b"])
    if mlp_fn is not None:
        return x + mlp_fn(h)
    return x + tp_mlp(h, params["mlp"], axis, activation,
                      sequence_parallel=sequence_parallel)


# ---------------------------------------------------------------------------
# param init (a shard of global weights drawn from an explicit generator)
# ---------------------------------------------------------------------------
def init_tp_block_params(generator: torch.Generator, d_model: int,
                         n_heads: int, d_ff: int, tp: int, tp_rank: int,
                         dtype=torch.float32, device=None):
    """ONE tp shard of a block's params. Every weight is drawn whole from
    ``generator`` (the same draws for every ``tp``) and sliced, so tp=k
    equals tp=1 numerically. Weights ``N(0, 1/d_in)``, biases 0, norms
    1 / 0."""
    dh = d_model // n_heads

    def full(d_in, d_out):
        w = torch.randn(d_in, d_out, generator=generator,
                        dtype=torch.float32) * (d_in ** -0.5)
        return w.to(dtype=dtype, device=device)

    def col(d_in, d_out):           # local [d_in, d_out/tp]
        k = d_out // tp
        return full(d_in, d_out)[:, tp_rank * k:(tp_rank + 1) * k].clone()

    def row(d_in, d_out):           # local [d_in/tp, d_out]
        k = d_in // tp
        return full(d_in, d_out)[tp_rank * k:(tp_rank + 1) * k].clone()

    def const(v, *shape):
        return torch.full(shape, v, dtype=dtype, device=device)

    hd = n_heads * dh
    return {
        "ln1_g": const(1.0, d_model), "ln1_b": const(0.0, d_model),
        "ln2_g": const(1.0, d_model), "ln2_b": const(0.0, d_model),
        "attn": {"Wq": col(d_model, hd), "Wk": col(d_model, hd),
                 "Wv": col(d_model, hd), "Wo": row(hd, d_model),
                 "bo": const(0.0, d_model)},
        "mlp": {"Wi": col(d_model, d_ff), "bi": const(0.0, d_ff // tp),
                "Wo": row(d_ff, d_model), "bo": const(0.0, d_model)},
    }


# ---------------------------------------------------------------------------
# partition specs of a tp block (keys mirror init_tp_block_params)
# ---------------------------------------------------------------------------
def megatron_specs(axis: str = MODEL_AXIS):
    """:class:`.mesh.PartitionSpec`\\ s of a tp block's params."""
    col, row, rep = P(None, axis), P(axis, None), P()
    return {
        "ln1_g": rep, "ln1_b": rep, "ln2_g": rep, "ln2_b": rep,
        "attn": {"Wq": col, "Wk": col, "Wv": col, "Wo": row, "bo": rep},
        "mlp": {"Wi": col, "bi": P(axis), "Wo": row, "bo": rep},
    }
