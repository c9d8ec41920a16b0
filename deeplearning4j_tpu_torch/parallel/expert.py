"""Expert parallelism: Mixture-of-Experts with all_to_all dispatch.

Counterpart of ``deeplearning4j_tpu/parallel/expert.py`` (GShard /
Switch style):

- gating is dense one-hot dispatch / combine einsums, no dynamic shapes;
- expert parallelism shards the expert dimension over a mesh axis (the
  model aliases it to ``data``: expert weights replace the data-parallel
  replication of the expert params);
- tokens move to their experts and back through two tiled
  :func:`.mesh.all_to_all`\\ s, whose backward is the inverse exchange.

Capacity: each expert takes at most ``C = max(4, ceil(k * tokens / E *
capacity_factor))`` tokens a shard; an overflowing token is dropped (its
combine weight is 0 and the residual carries it).
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.parallel.mesh import all_to_all, axis_size
from deeplearning4j_tpu_torch.parallel.tensor import gelu

EXPERT_AXIS = "expert"


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside ``[0, n)`` gives a zero
    row."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def topk_gating(logits, k: int = 2, capacity: Optional[int] = None,
                capacity_factor: float = 1.25,
                generator: Optional[torch.Generator] = None,
                noise_std: float = 0.0):
    """Top-k gating with capacity (GShard §3.2 / Switch top-1).

    logits: ``[n, E]``. Returns ``(combine [n, E, C], dispatch [n, E, C]
    bool, aux_loss scalar, C)``. Expert queues fill in token order, pass
    by pass; ties take the first expert."""
    n, e = logits.shape
    if capacity is None:
        capacity = max(4, math.ceil(k * n / e * capacity_factor))
    c = capacity
    if generator is not None and noise_std > 0.0:
        logits = logits + noise_std * torch.randn(
            logits.shape, generator=generator, dtype=logits.dtype,
            device=logits.device)
    probs = torch.softmax(logits, dim=-1)                 # [n, E]
    dt = logits.dtype

    combine = logits.new_zeros(n, e, c)
    dispatch = torch.zeros(n, e, c, dtype=torch.bool, device=logits.device)
    # running per-expert fill count, updated between the k passes
    fill = torch.zeros(e, dtype=torch.int32, device=logits.device)
    masked = probs
    gate_sum = logits.new_zeros(n)
    picks = []
    for _ in range(k):
        idx = torch.argmax(masked, dim=-1)                # [n]
        onehot = _one_hot(idx, e, torch.int32)            # [n, E]
        pos = fill[None, :] + torch.cumsum(onehot, 0, dtype=torch.int32) \
            - onehot
        pos = (pos * onehot).sum(-1)                      # [n] queue slot
        keep = pos < c
        gate = probs.gather(-1, idx[:, None])[:, 0]
        gate = torch.where(keep, gate, 0.0)
        gate_sum = gate_sum + gate
        picks.append((idx, pos, keep, gate))
        fill = fill + (onehot * keep[:, None]).sum(0, dtype=torch.int32)
        masked = masked * (1 - onehot)                    # exclude chosen

    # renormalize the kept gates so they sum to 1 per token (GShard)
    denom = torch.clamp(gate_sum, min=1e-9)
    for idx, pos, keep, gate in picks:
        w = (gate / denom)[:, None, None]
        hot = (_one_hot(idx, e, dt)[:, :, None]
               * _one_hot(pos, c, dt)[:, None, :])
        hot = hot * keep[:, None, None]
        combine = combine + w * hot
        dispatch = dispatch | (hot > 0)

    # load-balancing aux loss (Switch eq. 4): E * sum_e f_e * p_e
    top1 = _one_hot(torch.argmax(probs, -1), e, probs.dtype)
    f = top1.mean(0)
    p = probs.mean(0)
    aux = e * (f * p).sum()
    return combine, dispatch, aux, c


def moe_ffn(x, params, axis: Optional[str] = EXPERT_AXIS, k: int = 2,
            capacity_factor: float = 1.25, capacity: Optional[int] = None,
            activation: Callable = gelu,
            generator: Optional[torch.Generator] = None,
            noise_std: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE feed-forward over ``[b, t, d]`` activations. ``params``: ``Wg
    [d, E]`` gate (replicated), ``Wi [E_local, d, ff]``, ``Wo [E_local,
    ff, d]`` (sharded over ``axis``; ``axis=None`` runs every expert
    locally). Returns ``(out [b, t, d], aux_loss)``."""
    b, t, d = x.shape
    xf = x.reshape(b * t, d)
    ep = 1 if axis is None else axis_size(axis)
    logits = xf @ params["Wg"]                            # [n, E]
    combine, dispatch, aux, c = topk_gating(
        logits, k=k, capacity=capacity, capacity_factor=capacity_factor,
        generator=generator, noise_std=noise_std)

    # dispatch tokens into per-expert slots: [E, C, d]
    slots = torch.einsum("nec,nd->ecd", dispatch.to(x.dtype), xf)
    if ep > 1:
        # each rank keeps its E/ep experts and receives every shard's
        # slots for them: [E/ep, C*ep, d]
        slots = all_to_all(slots, axis, 0, 1)
    h = activation(torch.einsum("ecd,edf->ecf", slots, params["Wi"]))
    out = torch.einsum("ecf,efd->ecd", h, params["Wo"])
    if ep > 1:
        out = all_to_all(out, axis, 1, 0)
    y = torch.einsum("nec,ecd->nd", combine, out)
    return y.reshape(b, t, d), aux


def init_moe_params(generator: torch.Generator, d_model: int, d_ff: int,
                    n_experts: int, ep: int, ep_rank: int,
                    dtype=torch.float32, device=None):
    """One EP shard of MoE params, sliced from weights drawn whole from
    ``generator``, so ep=k equals ep=1 numerically."""
    def draw(*shape, fan_in):
        w = torch.randn(*shape, generator=generator,
                        dtype=torch.float32) * (fan_in ** -0.5)
        return w.to(dtype=dtype, device=device)

    wg = draw(d_model, n_experts, fan_in=d_model)
    wi = draw(n_experts, d_model, d_ff, fan_in=d_model)
    wo = draw(n_experts, d_ff, d_model, fan_in=d_ff)
    el = n_experts // ep
    sl = slice(ep_rank * el, (ep_rank + 1) * el)
    return {"Wg": wg, "Wi": wi[sl].clone(), "Wo": wo[sl].clone()}
