"""Token sampling: greedy, temperature and top-k next-token selection.

Counterpart of ``deeplearning4j_tpu/ops/sampling.py``, with the same
conventions:

- ``logits`` is ``[batch, vocab]`` (one decode step's last-token
  logits); ``temperature`` and ``top_k`` are per-row tensors (or
  scalars broadcast to the batch), so requests with different settings
  share one call.
- ``temperature == 0`` means greedy (argmax) for that row, resolved with
  ``torch.where``: greedy rows ride the same call as sampled rows.
- ``top_k == 0`` means no top-k filter.

The random draw comes from an explicit ``torch.Generator`` on the
logits' device (the JAX package threads a PRNG key): the Gumbel trick,
``argmax(logits / T + g)`` with ``g = -log(-log(u))``, which is how
``jax.random.categorical`` samples. The two frameworks draw different
bits from the same seed; tests compare distributions.
"""
from __future__ import annotations

from typing import Optional

import torch

#: score of filtered logits, matching ops/attention.py's NEG_INF (finite,
#: so a row with everything filtered degrades to uniform, not NaN)
NEG_INF = -1e9


def _per_row(value, like: torch.Tensor, dtype) -> torch.Tensor:
    return torch.as_tensor(value, dtype=dtype, device=like.device
                           ).expand(like.shape[:-1])


def top_k_filter(logits: torch.Tensor, top_k) -> torch.Tensor:
    """Keep each row's ``top_k`` largest logits (ties with the k-th kept)
    and push the rest to ``NEG_INF``; ``top_k`` is per row, 0 = keep
    all. Always sorts and always selects, whatever ``top_k`` holds."""
    vocab = logits.shape[-1]
    k = _per_row(top_k, logits, torch.int64)
    kc = k.clamp(1, vocab)
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    thresh = torch.gather(sorted_desc, -1, (kc - 1)[..., None])
    filtered = torch.where(logits >= thresh, logits,
                           torch.tensor(NEG_INF, dtype=logits.dtype,
                                        device=logits.device))
    return torch.where(k[..., None] > 0, filtered, logits)


def sample_logits(logits: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  temperature=1.0, top_k=0) -> torch.Tensor:
    """Next-token ids ``[batch]`` (int32) from ``[batch, vocab]`` logits:
    per-row ``temperature`` (0 = greedy argmax) and ``top_k`` (0 =
    unfiltered), the draw from ``generator`` (on the logits' device)."""
    temp = _per_row(temperature, logits, logits.dtype)
    greedy_ids = torch.argmax(logits, dim=-1)
    # the stochastic path for every row (the greedy rows' draws are
    # discarded by the where): temperature-scale with the 0 rows
    # guarded, top-k filter, Gumbel-max
    safe_temp = torch.where(temp > 0, temp, torch.ones_like(temp))
    scaled = top_k_filter(logits / safe_temp[..., None], top_k)
    u = torch.rand(logits.shape, generator=generator,
                   device=logits.device, dtype=logits.dtype)
    gumbel = -torch.log(-torch.log(u))
    sampled_ids = torch.argmax(scaled + gumbel, dim=-1)
    return torch.where(temp > 0, sampled_ids, greedy_ids).to(torch.int32)


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """Argmax ids ``[batch]`` (int32): the deterministic reference."""
    return torch.argmax(torch.as_tensor(logits), dim=-1).to(torch.int32)
