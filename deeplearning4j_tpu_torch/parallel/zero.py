"""The update exchange of data-parallel training: dense, or ZeRO-1
cross-replica sharded (Xu et al., "Automatic Cross-Replica Sharding of
Weight Update in Data-Parallel Training").

Counterpart of the dense and sharded rungs of
``deeplearning4j_tpu/parallel/zero.py``. The dense step ends in an
all-reduce of the gradient, after which every replica runs the full
updater on a full copy of the optimizer state. The sharded (ZeRO-1)
tail, :func:`apply_update_sharded`, replaces it, one parameter group
(layer or vertex) at a time: the gradient ravels into one padded flat
vector per dtype (``learning/updaters.dp_ravel``), a reduce-scatter
leaves each replica the sum of its 1/N slice, the updater runs on that
slice of the flats and on the replica's 1/N of the state, and an
all-gather of the new slices gives every replica the new parameters.
The per-element arithmetic is the dense tail's, so with the rank-ordered
collectives of ``parallel/mesh.ThreadMesh`` the two are bitwise equal.

Layouts: the JAX package's ``states_to_sharded`` gives an entry's state
as ``{DP_SHARDED_KEY: {slot: {dtype: padded flat}}}`` over the whole
mesh. A replica keeps only its slice of each flat (:func:`shard_state`)
and the slices are gathered back with :func:`gather_state`.

Not ported yet (ROADMAP item 11): the fsdp (ZeRO-3) and encoded rungs.
``DL4J_TORCH_SHARDED_UPDATE=0`` (``common/environment``) forces the
dense tail, also for those requests, as the JAX resolution does.
"""
from __future__ import annotations

import enum
import logging
from typing import Dict

import torch

from deeplearning4j_tpu_torch.common.environment import Environment
from deeplearning4j_tpu_torch.learning.updaters import (
    DP_SHARDED_KEY, dp_flatten_spec, dp_ravel, dp_unravel, is_dp_sharded)
from deeplearning4j_tpu_torch.parallel.mesh import DEFAULT_DATA_AXIS

log = logging.getLogger("deeplearning4j_tpu_torch")


class UpdateExchange(str, enum.Enum):
    """How replicas exchange the weight update: ``dense`` (all-reduce,
    replicated update), ``sharded`` (ZeRO-1 reduce-scatter / all-gather,
    updater state 1/N a replica), ``fsdp`` and ``encoded`` (not ported
    yet, ROADMAP item 11), ``auto`` (sharded whenever legal)."""
    DENSE = "dense"
    SHARDED = "sharded"
    FSDP = "fsdp"
    ENCODED = "encoded"
    AUTO = "auto"


def unported(mode: "UpdateExchange") -> NotImplementedError:
    return NotImplementedError(
        f"update_exchange={mode.value!r} is not ported yet (ROADMAP.md, "
        f"Queue A item 11); use 'dense', 'sharded' or 'auto'")


def parse_update_exchange(requested) -> UpdateExchange:
    if isinstance(requested, UpdateExchange):
        return requested
    try:
        return UpdateExchange(str(requested).lower())
    except ValueError:
        raise ValueError(
            f"unknown update_exchange {requested!r}; expected one of "
            f"{[e.value for e in UpdateExchange]}") from None


def resolve_update_exchange(mesh, axis: str = DEFAULT_DATA_AXIS,
                            requested=UpdateExchange.AUTO,
                            model=None) -> UpdateExchange:
    """Resolve ``auto`` (or check a request) down to DENSE or SHARDED.

    DENSE whenever no sharded tail applies: the kill switch
    ``DL4J_TORCH_SHARDED_UPDATE=0`` (for every request), no mesh or a
    data axis of 1, or a model with gradient normalization (it needs the
    whole summed gradient before any slicing)."""
    requested = parse_update_exchange(requested)
    if not Environment.get().sharded_update:
        if requested not in (UpdateExchange.DENSE, UpdateExchange.AUTO):
            log.info("update_exchange=%s requested but "
                     "DL4J_TORCH_SHARDED_UPDATE=0; using dense",
                     requested.value)
        return UpdateExchange.DENSE
    if requested in (UpdateExchange.FSDP, UpdateExchange.ENCODED):
        raise unported(requested)
    if requested is UpdateExchange.DENSE:
        return UpdateExchange.DENSE
    if mesh is None or mesh.shape.get(axis, 1) <= 1:
        return UpdateExchange.DENSE
    if model is not None:
        gn = getattr(getattr(model, "conf", None),
                     "gradient_normalization", None)
        if gn is not None and getattr(gn, "name", "NONE") != "NONE":
            log.info("gradient_normalization=%s needs the full summed "
                     "gradient; update exchange stays dense", gn.name)
            return UpdateExchange.DENSE
    return UpdateExchange.SHARDED


# ---------------------------------------------------------------------------
def apply_update_sharded(updater, grads: Dict[str, torch.Tensor],
                         params: Dict[str, torch.Tensor], state,
                         iteration: int, replica, *, epoch: int = 0):
    """The ZeRO-1 tail for one parameter group on ``replica``: ``grads``
    are this replica's gradients of its own loss, ``state`` its slice of
    the sharded state (:func:`shard_state`). Returns ``(new_params,
    new_state)``: every replica's new parameters (after the all-gather)
    and its new state slice. The gradient applied is the replicas'
    mean."""
    n, rank = replica.size, replica.rank
    flat_p, spec = dp_ravel(params, n)
    flat_g, _ = dp_ravel(grads, n, spec)
    g_shard = {k: replica.reduce_scatter(f.contiguous()) / n
               for k, f in flat_g.items()}
    p_shard = {k: f[rank * f.numel() // n:(rank + 1) * f.numel() // n]
               for k, f in flat_p.items()}
    inner = state[DP_SHARDED_KEY] if is_dp_sharded(state) else state
    updates, new_inner = updater.apply(g_shard, inner, iteration, epoch)
    # each dtype bucket keeps its own dtype, as the dense tail does
    new_flat = {k: replica.all_gather((p_shard[k] - updates[k])
                                      .to(flat_p[k].dtype))
                for k in flat_p}
    new_state = ({DP_SHARDED_KEY: new_inner} if is_dp_sharded(state)
                 else new_inner)
    return dp_unravel(new_flat, spec), new_state


# ---------------------------------------------------------------------------
def _flats_match_spec(inner, spec) -> bool:
    """Every flat's length equals the spec's padded length: the state
    was raveled for the same shard count."""
    for flats in inner.values():
        for dt, flat in flats.items():
            sizes = spec.sizes.get(dt)
            if sizes is None or int(flat.shape[0]) != sizes[1]:
                return False
    return True


def to_sharded_state(params, state, n_shards: int):
    """One entry's dense updater state -> the ZeRO-1 flat layout for
    ``n_shards``. A state already flat for another shard count goes
    through the dense layout and re-ravels; an empty state (a stateless
    updater) passes through."""
    if not state:
        return state
    if is_dp_sharded(state):
        spec = dp_flatten_spec(params, n_shards)
        if _flats_match_spec(state[DP_SHARDED_KEY], spec):
            return state
        state = to_dense_state(params, state)
    return {DP_SHARDED_KEY: {slot: dp_ravel(tree, n_shards)[0]
                             for slot, tree in state.items()}}


def to_dense_state(params, state):
    """Inverse of :func:`to_sharded_state` (padding dropped)."""
    if not is_dp_sharded(state):
        return state
    spec = dp_flatten_spec(params, 1)
    return {slot: dp_unravel(flats, spec)
            for slot, flats in state[DP_SHARDED_KEY].items()}


def states_to_sharded(params: Dict, states: Dict, n_shards: int) -> Dict:
    """Model-level: convert every layer/vertex entry."""
    return {k: to_sharded_state(params.get(k, {}), s, n_shards)
            for k, s in states.items()}


def states_to_dense(params: Dict, states: Dict) -> Dict:
    return {k: to_dense_state(params.get(k, {}), s)
            for k, s in states.items()}


def shard_state(state, rank: int, n_shards: int):
    """This rank's 1/N slice of each flat of a sharded state (dense
    states pass through)."""
    if not is_dp_sharded(state):
        return state
    return {DP_SHARDED_KEY: {
        slot: {dt: f[rank * (f.numel() // n_shards):
                     (rank + 1) * (f.numel() // n_shards)].clone()
               for dt, f in flats.items()}
        for slot, flats in state[DP_SHARDED_KEY].items()}}


def gather_state(state, replica):
    """The whole-mesh sharded state from each replica's slice (a
    collective: every replica calls it)."""
    if not is_dp_sharded(state):
        return state
    return {DP_SHARDED_KEY: {
        slot: {dt: replica.all_gather(f) for dt, f in flats.items()}
        for slot, flats in state[DP_SHARDED_KEY].items()}}


# ---------------------------------------------------------------------------
def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


def update_exchange_bytes(params, n_shards: int, mode=None) -> int:
    """Per-replica wire bytes one applied update exchange moves (ring
    collectives): dense all-reduce = 2(N-1)/N · P bytes; the sharded
    reduce-scatter + all-gather pair moves the same. ZeRO-1 wins HBM
    residency and update traffic, not wire bytes; ``mode`` is accepted
    so callers can be explicit."""
    total = _nbytes(params)
    if n_shards <= 1:
        return 0
    return int(2 * (n_shards - 1) * total / n_shards)


def sharded_state_bytes(states: Dict) -> int:
    """Bytes of the flat sharded updater state in ``states``: the whole
    mesh's for :func:`states_to_sharded`'s layout, a replica's for its
    :func:`shard_state` slices."""
    return sum(_nbytes(s[DP_SHARDED_KEY]) for s in states.values()
               if is_dp_sharded(s))


def dense_state_bytes(states: Dict) -> int:
    """Bytes of the dense (unsharded) updater state in ``states``."""
    return sum(_nbytes(s) for s in states.values() if not is_dp_sharded(s))
