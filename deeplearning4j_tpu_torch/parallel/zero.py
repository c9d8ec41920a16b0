"""The update exchange of data-parallel training: dense, ZeRO-1
sharded, fsdp (ZeRO-3) or encoded (Xu et al., "Automatic Cross-Replica
Sharding of Weight Update in Data-Parallel Training").

Counterpart of ``deeplearning4j_tpu/parallel/zero.py``: its data-axis
rungs and their compositions with tensor parallelism (dense×tp,
sharded×tp, fsdp×tp, encoded×tp; see the last section). The dense step
ends in an all-reduce of the gradient, after which every
replica runs the full updater on a full copy of the optimizer state. The other tails work one
parameter group (layer or vertex) at a time on the per-dtype padded flat
ravel (``learning/updaters.dp_ravel``), each replica on its 1/N slice:

- sharded (ZeRO-1, :func:`apply_update_sharded`): a reduce-scatter
  leaves each replica the sum of its slice of the gradient, the updater
  runs on that slice and on the replica's 1/N of the state, and an
  all-gather of the new slices gives every replica the new parameters.
  The per-element arithmetic is the dense tail's, so with the
  rank-ordered collectives of ``parallel/mesh.ThreadMesh`` the two are
  bitwise equal.
- encoded (:func:`apply_update_encoded`): the sharded exchange with the
  mean-gradient slice compressed before the updater sees it: the carried
  error-feedback residual is added, the sum encoded (``parallel/
  encoding.py``: sign·τ threshold, int8 or 1-bit; the codecs' reductions
  span the whole flat), the remainder carried as the next residual, τ
  adapted from the transmitted fraction, and the updater consumes the
  decoded slice — what the compressed wire format would reconstruct.
- fsdp (ZeRO-3, :func:`apply_update_fsdp`): the parameters themselves
  stay resident as the replica's slice of the flats (``{FSDP_KEY:
  {dtype: slice}}``); the forward all-gathers each group at its first use
  (:class:`FsdpParamView`, through an autograd Function whose backward
  reduce-scatters the cotangent, so a full gradient never forms), and
  the update keeps the new slice: there is no trailing all-gather.

Layouts: the JAX package's ``states_to_sharded`` gives an entry's state
as ``{DP_SHARDED_KEY: {slot: {dtype: padded flat}}}`` over the whole
mesh, with the encoded rung's ``{ENCODED_KEY: {"residual": {dtype:
flat}, "tau", "step", "sparsity"}}`` beside it. A replica keeps only its
slice of each flat (:func:`shard_state`: the state's slots and the
residual; τ, step and sparsity are the same on every replica) and the
slices are gathered back with :func:`gather_state`. In the dense layout
the residual is the parameters' tree, so it re-ravels for any replica
count.

Tensor parallelism (``parallel/speclayout.py`` names the leaves): a
tensor-parallel leaf never ravels into the flats, so the flats' exchange
never crosses ``model``. A replica holds its shard of the leaf (the
compute spec's, and under fsdp the resident one's, 1/(dp·tp)) and of its
updater state (the resident spec's: 1/tp under the dense tail, 1/(dp·tp)
under the ZeRO tails), the state under ``TP_KEY`` in the flat layouts.
The training step gathers the leaf (:func:`pin_tp_entry`,
:func:`tp_gather_leaf`); the model ranks of one data index see the same
rows, so the gradient of the gathered leaf is the same on each of them,
and its transpose takes the rank's own slice rather than summing over
``model`` (which would count it tp times); only the data-axis part
reduces. :func:`apply_update_tp` is the elementwise tail of those
shards: the mean over ``data`` (a reduce-scatter to the resident slice
under the ZeRO tails), the updater, and the new compute shard gathered
back over ``data`` (not under fsdp, which keeps it resident).

Kill switches (``common/environment``): ``DL4J_TORCH_SHARDED_UPDATE=0``
forces the dense tail for every request; ``DL4J_TORCH_FSDP=0`` and
``DL4J_TORCH_ENCODED_UPDATE=0`` demote their rung to ZeRO-1.
"""
from __future__ import annotations

import enum
import logging
from typing import Dict

import torch

from deeplearning4j_tpu_torch.common.environment import Environment
from deeplearning4j_tpu_torch.learning.updaters import (
    DP_SHARDED_KEY, ENCODED_KEY, FSDP_KEY, TP_KEY, dp_flatten_spec, dp_ravel,
    dp_unravel, has_tp, is_dp_sharded, is_encoded, is_fsdp)
from deeplearning4j_tpu_torch.parallel.encoding import (
    encode_flat, encoded_payload_bytes, resolve_encoding)
from deeplearning4j_tpu_torch.parallel.mesh import (DEFAULT_DATA_AXIS,
                                                    shard_leaf)

log = logging.getLogger("deeplearning4j_tpu_torch")


class UpdateExchange(str, enum.Enum):
    """How replicas exchange the weight update: ``dense`` (all-reduce,
    replicated update), ``sharded`` (ZeRO-1 reduce-scatter / all-gather,
    updater state 1/N a replica), ``fsdp`` (ZeRO-3: parameters,
    gradients and state 1/N a replica, per-group all-gathers in the
    forward; opt-in), ``encoded`` (the sharded exchange with the
    gradient compressed under error feedback; opt-in), ``auto``
    (sharded whenever legal)."""
    DENSE = "dense"
    SHARDED = "sharded"
    FSDP = "fsdp"
    ENCODED = "encoded"
    AUTO = "auto"


#: rungs whose updater state is the replica's slice of the flat layout
FLAT_MODES = (UpdateExchange.SHARDED, UpdateExchange.ENCODED,
              UpdateExchange.FSDP)

#: layer attributes ``nn/conf/constraints.apply_constraints`` reads; any
#: of them set means the update tail needs whole tensors after the
#: update, which the fsdp tail (parameters never gathered after it)
#: cannot give
_CONSTRAINT_ATTRS = ("constrain_weights", "constrain_bias",
                     "constrain_all", "constrain_params")


def parse_update_exchange(requested) -> UpdateExchange:
    if isinstance(requested, UpdateExchange):
        return requested
    try:
        return UpdateExchange(str(requested).lower())
    except ValueError:
        raise ValueError(
            f"unknown update_exchange {requested!r}; expected one of "
            f"{[e.value for e in UpdateExchange]}") from None


def _has_weight_constraints(model) -> bool:
    conf = getattr(model, "conf", None)
    layers = list(getattr(conf, "layers", None) or [])
    for v in (getattr(conf, "vertices", None) or {}).values():
        if getattr(v, "is_layer", False) and v.content is not None:
            layers.append(v.content)
    return any(getattr(layer, a, None)
               for layer in layers for a in _CONSTRAINT_ATTRS)


def resolve_update_exchange(mesh, axis: str = DEFAULT_DATA_AXIS,
                            requested=UpdateExchange.AUTO,
                            model=None) -> UpdateExchange:
    """Resolve ``auto`` (or check a request) down to DENSE, SHARDED,
    FSDP or ENCODED, in the JAX package's order.

    DENSE whenever no flat tail applies: the kill switch
    ``DL4J_TORCH_SHARDED_UPDATE=0`` (for every request), a DENSE
    request, no mesh or a data axis of 1, or a model with gradient
    normalization (it needs the whole summed gradient before any
    slicing). An ENCODED request falls back to SHARDED under
    ``DL4J_TORCH_ENCODED_UPDATE=0`` (the exchange still shards, it only
    stops compressing); an FSDP request under ``DL4J_TORCH_FSDP=0`` or
    on a model with weight constraints."""
    requested = parse_update_exchange(requested)
    env = Environment.get()
    if not env.sharded_update:
        if requested not in (UpdateExchange.DENSE, UpdateExchange.AUTO):
            log.info("update_exchange=%s requested but "
                     "DL4J_TORCH_SHARDED_UPDATE=0; using dense",
                     requested.value)
        return UpdateExchange.DENSE
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
    if requested is UpdateExchange.ENCODED:
        if not env.encoded_update:
            log.info("update_exchange=encoded requested but "
                     "DL4J_TORCH_ENCODED_UPDATE=0; using sharded "
                     "(ZeRO-1, uncompressed)")
            return UpdateExchange.SHARDED
        return UpdateExchange.ENCODED
    if requested is UpdateExchange.FSDP:
        if not env.fsdp:
            log.info("update_exchange=fsdp requested but "
                     "DL4J_TORCH_FSDP=0; using sharded (ZeRO-1)")
            return UpdateExchange.SHARDED
        if model is not None and _has_weight_constraints(model):
            log.info("model has weight constraints (post-update "
                     "projection needs full tensors); update exchange "
                     "falls back to sharded (ZeRO-1)")
            return UpdateExchange.SHARDED
        return UpdateExchange.FSDP
    return UpdateExchange.SHARDED


# ---------------------------------------------------------------------------
def _my_slice(flat: torch.Tensor, rank: int, n: int) -> torch.Tensor:
    k = flat.numel() // n
    return flat[rank * k:(rank + 1) * k]


def _mean_grad_slices(flat_g: Dict[str, torch.Tensor], replica):
    """This replica's slice of the replicas' mean of each flat."""
    n = replica.size
    return {k: replica.reduce_scatter(f.contiguous()) / n
            for k, f in flat_g.items()}


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
    g_shard = _mean_grad_slices(flat_g, replica)
    p_shard = {k: _my_slice(f, rank, n) for k, f in flat_p.items()}
    inner = state[DP_SHARDED_KEY] if is_dp_sharded(state) else state
    updates, new_inner = updater.apply(g_shard, inner, iteration, epoch)
    # each dtype bucket keeps its own dtype, as the dense tail does
    new_flat = {k: replica.all_gather((p_shard[k] - updates[k])
                                      .to(flat_p[k].dtype))
                for k in flat_p}
    new_state = ({DP_SHARDED_KEY: new_inner} if is_dp_sharded(state)
                 else new_inner)
    return dp_unravel(new_flat, spec), new_state


# -- encoded rung -----------------------------------------------------------
def encoded_tail(g_shard: Dict[str, torch.Tensor],
                 residual: Dict[str, torch.Tensor], tau, step, encoding,
                 replica=None):
    """The error-feedback codec step on a replica's mean-gradient slices
    (``{dtype: slice}``), in the JAX package's order: ``corrected =
    g + residual``; encode each dtype bucket (its reductions over the
    whole flat with a ``replica``, over the given flats without one);
    the transmitted fraction, size-weighted over the buckets (padding
    counts as not transmitted); ``new_tau = next_tau(tau, fraction)``;
    the new residual ``corrected - decoded``, clipped with ``new_tau`` at
    the pre-increment ``step``. Returns ``(decoded, new_residual,
    new_tau, fraction)``."""
    n = replica.size if replica is not None else 1
    corrected = {k: g + residual[k].to(g.dtype) for k, g in g_shard.items()}
    decoded, frac_num, elems = {}, [], 0
    for k, c in corrected.items():
        d, f = encode_flat(c, tau, encoding.scheme, replica)
        decoded[k] = d
        frac_num.append(f * (c.numel() * n))
        elems += c.numel() * n
    sp = sum(frac_num) / torch.full_like(frac_num[0], float(max(elems, 1)))
    new_residual = {k: (corrected[k] - decoded[k]).to(residual[k].dtype)
                    for k in corrected}
    new_tau = encoding.algorithm.next_tau(tau, sp)
    new_residual = encoding.residual_post.apply(step, new_tau, new_residual)
    return decoded, new_residual, new_tau, sp


def apply_update_encoded(updater, grads: Dict[str, torch.Tensor],
                         params: Dict[str, torch.Tensor], state,
                         iteration: int, replica, *, encoding,
                         epoch: int = 0):
    """The encoded tail for one parameter group on ``replica``: the
    ZeRO-1 exchange of :func:`apply_update_sharded` with the replicas'
    mean-gradient slice run through :func:`encoded_tail` before the
    updater, which consumes the decoded slice. ``state`` carries
    ``ENCODED_KEY`` (:func:`ensure_encoded_state`, then
    :func:`shard_state`); a stateless updater's carries only that.
    Returns ``(new_params, new_state)``."""
    n, rank = replica.size, replica.rank
    flat_p, spec = dp_ravel(params, n)
    flat_g, _ = dp_ravel(grads, n, spec)
    g_shard = _mean_grad_slices(flat_g, replica)
    p_shard = {k: _my_slice(f, rank, n) for k, f in flat_p.items()}
    enc = state[ENCODED_KEY]
    decoded, new_residual, new_tau, sp = encoded_tail(
        g_shard, enc["residual"], enc["tau"], enc["step"], encoding,
        replica)
    inner = state.get(DP_SHARDED_KEY, {})
    updates, new_inner = updater.apply(decoded, inner, iteration, epoch)
    new_flat = {k: replica.all_gather((p_shard[k] - updates[k])
                                      .to(flat_p[k].dtype))
                for k in flat_p}
    new_state = {ENCODED_KEY: {
        "residual": new_residual,
        "tau": new_tau.to(torch.float32),
        "step": (enc["step"] + 1).to(torch.int32),
        "sparsity": sp.to(torch.float32),
    }}
    if is_dp_sharded(state):
        new_state[DP_SHARDED_KEY] = new_inner
    return dp_unravel(new_flat, spec), new_state


# -- fsdp (ZeRO-3) ----------------------------------------------------------
class _GatherFlat(torch.autograd.Function):
    """The all-gather of one flat's slices, differentiable: its backward
    reduce-scatters the cotangent, so each replica only ever holds its
    slice of the gradient (the sum over replicas; the tail takes the
    mean)."""

    @staticmethod
    def forward(ctx, shard, replica):
        ctx.replica = replica
        return replica.all_gather(shard)

    @staticmethod
    def backward(ctx, g):
        return ctx.replica.reduce_scatter(g.contiguous()), None


def fsdp_gather(flats: Dict[str, torch.Tensor], spec, replica,
                cast_dtype=None) -> Dict[str, torch.Tensor]:
    """One group's flat slices -> its dense ``{name: tensor}`` (the
    just-in-time all-gather). 4-D leaves take the channels-last layout
    their dense counterparts are stored in, so the convolutions run the
    dense model's algorithms; ``cast_dtype`` applies the compute-dtype
    cast after the gather."""
    full = {k: _GatherFlat.apply(f, replica) for k, f in flats.items()}
    dense = dp_unravel(full, spec)
    out = {}
    for name, t in dense.items():
        if t.dim() == 4:
            t = t.contiguous(memory_format=torch.channels_last)
        if cast_dtype is not None and t.is_floating_point():
            t = t.to(cast_dtype)
        out[name] = t
    return out


class FsdpParamView:
    """A mapping over an fsdp-flat parameter tree that the training
    forward reads in place of the dense one: the first ``get(key)`` of a
    step gathers that group (:func:`fsdp_gather`) and caches it, so the
    gathers follow the forward's order, one per group a step. Entries
    that are not fsdp pass through. ``order`` and ``prefetch`` are
    accepted for the JAX package's signature and do nothing: eager
    PyTorch has no scheduler to hand the next group's gather to. ``cast``
    gives the view in a compute dtype over the same gathers."""

    def __init__(self, params, specs, replica, order=None, prefetch=True,
                 cast_dtype=None, tp_specs=None, tp_replica=None,
                 _base=None):
        self._params = params
        self._specs = specs
        self._replica = replica
        self._cast_dtype = cast_dtype
        #: an entry's ``TP_KEY`` leaves gather from their resident shards
        #: (over ``data`` and ``model``) through ``tp_replica``
        self._tp_specs = tp_specs or {}
        self._tp_replica = tp_replica
        self._base = _base
        self._cache: Dict[str, dict] = {}

    def cast(self, dtype) -> "FsdpParamView":
        return FsdpParamView(self._params, self._specs, self._replica,
                             cast_dtype=dtype, _base=self)

    def _dense(self, key):
        if key not in self._cache:
            if self._base is not None:
                self._cache[key] = {
                    n: (t.to(self._cast_dtype) if t.is_floating_point()
                        else t)
                    for n, t in self._base._dense(key).items()}
            else:
                sub = self._params[key]
                dense = fsdp_gather(sub[FSDP_KEY], self._specs[key],
                                    self._replica)
                if has_tp(sub):
                    sp = self._tp_specs.get(key, {})
                    dense.update({n: tp_gather_leaf(t, sp[n].resident,
                                                    self._tp_replica)
                                  for n, t in sub[TP_KEY].items()})
                self._cache[key] = dense
        return self._cache[key]

    def get(self, key, default=None):
        sub = self._params.get(key, default)
        if is_fsdp(sub):
            return self._dense(key)
        if self._cast_dtype is not None and sub:
            return {n: (t.to(self._cast_dtype) if t.is_floating_point()
                        else t) for n, t in sub.items()}
        return sub

    def __getitem__(self, key):
        if key not in self._params:
            raise KeyError(key)
        return self.get(key)

    def __contains__(self, key) -> bool:
        return key in self._params

    def __iter__(self):
        return iter(self._params)

    def __len__(self) -> int:
        return len(self._params)

    def keys(self):
        return self._params.keys()

    def items(self):
        return [(k, self.get(k)) for k in self._params]


def params_to_fsdp(params: Dict, n_shards: int, tp_specs=None):
    """Model parameters -> the fsdp flat layout over the whole mesh:
    ``(flat_params, specs)``; empty entries pass through and keep no
    spec (:func:`shard_params` takes a replica's slices). The leaves
    ``tp_specs`` names stay whole under ``TP_KEY``; only the rest of the
    entry ravels."""
    tp_specs = tp_specs or {}
    out, specs = {}, {}
    for k, sub in params.items():
        if not sub or is_fsdp(sub):
            out[k] = sub
            continue
        rest, tpp = split_tp_entry(sub, tp_specs.get(k, {}))
        flats, spec = dp_ravel(rest, n_shards)
        out[k] = {FSDP_KEY: flats, TP_KEY: tpp} if tpp else {FSDP_KEY: flats}
        specs[k] = spec
    return out, specs


def shard_params(flat_params: Dict, rank: int, n_shards: int,
                 tp_specs=None, tp_replica=None) -> Dict:
    """This rank's 1/N slice of each fsdp flat (a copy, so the whole
    flats can go), and its resident shard of each ``TP_KEY`` leaf."""
    out = {}
    for k, sub in flat_params.items():
        if not is_fsdp(sub):
            out[k] = sub
            continue
        out[k] = {FSDP_KEY: {dt: _my_slice(f, rank, n_shards).clone()
                             for dt, f in sub[FSDP_KEY].items()}}
        if has_tp(sub):
            sp = tp_specs[k]
            out[k][TP_KEY] = {n: tp_shard(t, sp[n].resident, tp_replica)
                              for n, t in sub[TP_KEY].items()}
    return out


def fsdp_spec_shards(specs) -> "int | None":
    """The replica count a set of fsdp specs was raveled for (None when
    there are none)."""
    for spec in (specs or {}).values():
        return int(spec.n_shards)
    return None


def params_to_dense(params: Dict, specs: Dict, replica, tp_specs=None,
                    tp_replica=None) -> Dict:
    """Inverse of :func:`params_to_fsdp` from each replica's slices
    (padding dropped; 4-D leaves channels-last, as the dense model
    stores them; ``TP_KEY`` leaves gathered from their resident shards).
    A collective: every replica calls it."""
    out = {}
    for k, sub in params.items():
        if is_fsdp(sub):
            full = {dt: replica.all_gather(f)
                    for dt, f in sub[FSDP_KEY].items()}
            out[k] = {n: (t.contiguous(memory_format=torch.channels_last)
                          if t.dim() == 4 else t)
                      for n, t in dp_unravel(full, specs[k]).items()}
            if has_tp(sub):
                sp = tp_specs[k]
                out[k].update({n: tp_full(t, sp[n].resident, tp_replica)
                               for n, t in sub[TP_KEY].items()})
        else:
            out[k] = sub
    return out


def apply_update_fsdp(updater, flat_g: Dict[str, torch.Tensor],
                      flat_p: Dict[str, torch.Tensor], state,
                      iteration: int, replica, *, epoch: int = 0):
    """The ZeRO-3 tail for one group's slices on ``replica``:
    ``flat_g`` are the reduce-scattered sums the gather's backward left
    (the mean is taken here, as the sharded tail takes it), ``flat_p``
    the resident parameter slices. The new slices stay resident: no
    trailing all-gather, the next forward gathers again. Returns
    ``(new_flat, new_state)``."""
    n = replica.size
    g = {k: f / n for k, f in flat_g.items()}
    inner = state[DP_SHARDED_KEY] if is_dp_sharded(state) else state
    updates, new_inner = updater.apply(g, inner, iteration, epoch)
    new_flat = {k: (flat_p[k] - updates[k]).to(flat_p[k].dtype)
                for k in flat_p}
    new_state = ({DP_SHARDED_KEY: new_inner} if is_dp_sharded(state)
                 else new_inner)
    return new_flat, new_state


def fsdp_param_bytes(params: Dict) -> int:
    """Bytes of the fsdp flats in ``params``: a replica's resident
    parameter bytes for its slices, the whole mesh's padded total for
    :func:`params_to_fsdp`'s layout."""
    return sum(_nbytes(sub[FSDP_KEY]) for sub in params.values()
               if is_fsdp(sub))


# -- layout conversions -----------------------------------------------------
def _flats_match_spec(inner, spec) -> bool:
    """Every flat's length equals the spec's padded length: the state
    was raveled for the same shard count."""
    for flats in inner.values():
        for dt, flat in flats.items():
            sizes = spec.sizes.get(dt)
            if sizes is None or int(flat.shape[0]) != sizes[1]:
                return False
    return True


def _residual_is_flat(res, spec) -> bool:
    """Flat residuals are keyed by the spec's dtype names and 1-D; dense
    ones carry the parameters' names."""
    return (isinstance(res, dict) and set(res) == set(spec.sizes)
            and all(getattr(v, "ndim", None) == 1 for v in res.values()))


def _state_tp_names(state) -> set:
    """The parameter names the ``TP_KEY`` half of a flat state covers
    (its slots mirror the tensor-parallel parameters)."""
    names = set()
    for slot_tree in (state.get(TP_KEY, {}) or {}).values():
        if isinstance(slot_tree, dict):
            names |= set(slot_tree)
    return names


def _rest_of_params(params, tp_names):
    if tp_names and isinstance(params, dict):
        return {n: a for n, a in params.items() if n not in tp_names}
    return params


def to_sharded_state(params, state, n_shards: int, tp_names=()):
    """One entry's dense updater state -> the ZeRO-1 flat layout for
    ``n_shards``, the ``tp_names`` leaves split out whole under
    ``TP_KEY`` (they shard by their specs, never through the flats). A
    state already flat for another shard count or another split goes
    through the dense layout and re-ravels; an empty state (a stateless
    updater) passes through. ``ENCODED_KEY`` rides along: the residual
    re-ravels for ``n_shards`` (from the dense layout, or from flats of
    another shard count; padding is zeros, so the round trip is
    bitwise), τ, step and sparsity pass through."""
    if not state:
        return state
    tp_names = tuple(tp_names or ())
    rest = _rest_of_params(params, tp_names)
    if is_encoded(state):
        enc = state[ENCODED_KEY]
        base = {k: v for k, v in state.items() if k != ENCODED_KEY}
        out = dict(to_sharded_state(params, base, n_shards, tp_names) or {})
        spec = dp_flatten_spec(rest, n_shards)
        res = enc["residual"]
        if not _flats_match_spec({"residual": res}, spec):
            if _residual_is_flat(res, spec):
                # flat for another shard count -> dense first
                res = dp_unravel(res, dp_flatten_spec(rest, 1))
            res = dp_ravel(_rest_of_params(res, tp_names), n_shards)[0]
        out[ENCODED_KEY] = {**enc, "residual": res}
        return out
    if is_dp_sharded(state) or has_tp(state):
        spec = dp_flatten_spec(rest, n_shards)
        if _flats_match_spec(state.get(DP_SHARDED_KEY, {}), spec) and \
                _state_tp_names(state) == set(tp_names):
            return state
        state = to_dense_state(params, state)
    out = {DP_SHARDED_KEY: {slot: dp_ravel(_rest_of_params(tree, tp_names),
                                           n_shards)[0]
                            for slot, tree in state.items()}}
    tp = {slot: {n: tree[n] for n in tp_names if n in tree}
          for slot, tree in state.items()}
    tp = {slot: t for slot, t in tp.items() if t}
    if tp:
        out[TP_KEY] = tp
    return out


def to_dense_state(params, state):
    """Inverse of :func:`to_sharded_state` (padding dropped; the
    ``TP_KEY`` leaves merge back into their slots; an ``ENCODED_KEY``
    residual unravels into the parameters' tree, so the checkpoint
    layout is exact and portable across replica counts)."""
    if is_encoded(state):
        enc = state[ENCODED_KEY]
        base = {k: v for k, v in state.items() if k != ENCODED_KEY}
        out = dict(to_dense_state(params, base) or {})
        rest = _rest_of_params(params, tuple(_state_tp_names(state)))
        res = enc["residual"]
        spec1 = dp_flatten_spec(rest, 1)
        if _residual_is_flat(res, spec1):
            res = dp_unravel(res, spec1)
        out[ENCODED_KEY] = {**enc, "residual": res}
        return out
    if not (is_dp_sharded(state) or has_tp(state)):
        return state
    tp_names = _state_tp_names(state)
    spec = dp_flatten_spec(_rest_of_params(params, tp_names), 1)
    out = {slot: dp_unravel(flats, spec)
           for slot, flats in state.get(DP_SHARDED_KEY, {}).items()}
    for slot, tree in state.get(TP_KEY, {}).items():
        out[slot] = {**out.get(slot, {}), **tree}
    return out


def states_to_sharded(params: Dict, states: Dict, n_shards: int,
                      tp_specs=None) -> Dict:
    """Model-level: convert every layer/vertex entry."""
    tp_specs = tp_specs or {}
    return {k: to_sharded_state(params.get(k, {}), s, n_shards,
                                tp_names=tuple(tp_specs.get(k, ())))
            for k, s in states.items()}


def states_to_dense(params: Dict, states: Dict) -> Dict:
    return {k: to_dense_state(params.get(k, {}), s)
            for k, s in states.items()}


def ensure_encoded_state(params, state, n_shards: int, encoding,
                         tp_names=()):
    """One entry's updater state -> the encoded flat layout: the ZeRO-1
    flats for ``n_shards`` (the ``tp_names`` leaves under ``TP_KEY``)
    with the error-feedback state (zero residual flats, the algorithm's
    initial τ, step 0) injected when absent. An entry without
    parameters, or with tensor-parallel ones only, gets none: it never
    reaches the encoded tail."""
    tp_names = tuple(tp_names or ())
    base = to_sharded_state(params, state, n_shards, tp_names)
    rest = _rest_of_params(params, tp_names)
    if not rest or is_encoded(base):
        return base
    out = dict(base) if base else {}
    like = next(iter(rest.values()))
    out[ENCODED_KEY] = {
        "residual": dp_ravel({n: torch.zeros_like(p)
                              for n, p in rest.items()}, n_shards)[0],
        "tau": torch.tensor(encoding.initial_tau(), dtype=torch.float32,
                            device=like.device),
        "step": torch.zeros((), dtype=torch.int32, device=like.device),
        "sparsity": torch.zeros((), dtype=torch.float32,
                                device=like.device),
    }
    return out


def ensure_encoded_states(params: Dict, states: Dict, n_shards: int,
                          encoding, tp_specs=None) -> Dict:
    """Model-level twin of :func:`ensure_encoded_state`."""
    tp_specs = tp_specs or {}
    return {k: ensure_encoded_state(params.get(k, {}), s, n_shards,
                                    encoding,
                                    tp_names=tuple(tp_specs.get(k, ())))
            for k, s in states.items()}


def strip_encoded_state(state):
    """Drop the encoded rung's error-feedback state from one entry (a
    mode change away from ``encoded``: the residual belongs to the
    compressed exchange and must not leak into other updater math)."""
    if is_encoded(state):
        return {k: v for k, v in state.items() if k != ENCODED_KEY}
    return state


def strip_encoded_states(states: Dict) -> Dict:
    return {k: strip_encoded_state(s) for k, s in states.items()}


def shard_state(state, rank: int, n_shards: int, tp_specs=None,
                tp_replica=None):
    """This rank's 1/N slice of each flat of a sharded state: the slots'
    and the encoded residual's (τ, step and sparsity are every rank's;
    dense states pass through), and its resident shard of each
    ``TP_KEY`` leaf (``tp_specs``: the entry's ``{name: TpLeafSpec}``)."""
    if not (is_dp_sharded(state) or is_encoded(state) or has_tp(state)):
        return state
    out = {}
    if has_tp(state):
        out[TP_KEY] = {slot: {n: tp_shard(t, tp_specs[n].resident,
                                          tp_replica)
                              for n, t in tree.items()}
                       for slot, tree in state[TP_KEY].items()}
    if is_dp_sharded(state):
        out[DP_SHARDED_KEY] = {
            slot: {dt: _my_slice(f, rank, n_shards).clone()
                   for dt, f in flats.items()}
            for slot, flats in state[DP_SHARDED_KEY].items()}
    if is_encoded(state):
        enc = state[ENCODED_KEY]
        out[ENCODED_KEY] = {**enc, "residual": {
            dt: _my_slice(f, rank, n_shards).clone()
            for dt, f in enc["residual"].items()}}
    return out


def gather_state(state, replica, tp_specs=None, tp_replica=None):
    """The whole-mesh sharded state from each replica's slice, the
    ``TP_KEY`` leaves whole again (a collective: every replica calls
    it)."""
    if not (is_dp_sharded(state) or is_encoded(state) or has_tp(state)):
        return state
    out = {}
    if has_tp(state):
        out[TP_KEY] = {slot: {n: tp_full(t, tp_specs[n].resident,
                                         tp_replica)
                              for n, t in tree.items()}
                       for slot, tree in state[TP_KEY].items()}
    if is_dp_sharded(state):
        out[DP_SHARDED_KEY] = {
            slot: {dt: replica.all_gather(f) for dt, f in flats.items()}
            for slot, flats in state[DP_SHARDED_KEY].items()}
    if is_encoded(state):
        enc = state[ENCODED_KEY]
        out[ENCODED_KEY] = {**enc, "residual": {
            dt: replica.all_gather(f)
            for dt, f in enc["residual"].items()}}
    return out


# -- tensor parallelism -----------------------------------------------------
def _base_replica(replica):
    """The replica of the whole mesh under an axis-group view."""
    return getattr(replica, "base", replica)


def _spec_dims(spec):
    """``(dim, axis)`` for each dimension a spec splits (one axis a
    dimension, as SpecLayout's specs have)."""
    out = []
    for d, e in enumerate(spec):
        if e is None:
            continue
        axes = (e,) if isinstance(e, str) else tuple(e)
        for a in axes:
            out.append((d, a))
    return out


def tp_shard(t: torch.Tensor, spec, replica) -> torch.Tensor:
    """The replica's shard of the whole leaf ``t`` under ``spec`` (a
    copy)."""
    rep = _base_replica(replica)
    mesh = rep.mesh
    coords = dict(zip(mesh.axes, mesh.coords(rep.rank)))
    return shard_leaf(t, spec, mesh.axes, coords).contiguous().clone()


def tp_full(t: torch.Tensor, spec, replica) -> torch.Tensor:
    """The whole leaf from every replica's shard under ``spec`` (a
    collective over the spec's axes; not differentiable)."""
    rep = _base_replica(replica)
    for d, a in _spec_dims(spec):
        t = rep.axis_collective("all_gather", t.contiguous(), a, dim=d)
    return t


def tp_grad_slice(g: torch.Tensor, spec, replica,
                  data_axis: str = DEFAULT_DATA_AXIS) -> torch.Tensor:
    """The transpose of :func:`tp_full` for a gradient that the replicas
    of one data index hold alike: the replica's own slice along the
    model dimensions, the sum over ``data`` scattered along a data
    dimension."""
    rep = _base_replica(replica)
    for d, a in _spec_dims(spec):
        if a == data_axis:
            g = rep.axis_collective("psum_scatter", g.contiguous(), a, dim=d)
        else:
            n = rep.axis_size(a)
            k = g.shape[d] // n
            g = g.narrow(d, rep.axis_index(a) * k, k)
    return g.contiguous()


class _TpGather(torch.autograd.Function):
    """:func:`tp_full` under autograd, its backward
    :func:`tp_grad_slice`."""

    @staticmethod
    def forward(ctx, t, spec, replica, data_axis):
        ctx.spec, ctx.replica, ctx.data_axis = spec, replica, data_axis
        return tp_full(t, spec, replica)

    @staticmethod
    def backward(ctx, g):
        return (tp_grad_slice(g, ctx.spec, ctx.replica, ctx.data_axis),
                None, None, None)


def tp_gather_leaf(x: torch.Tensor, spec, replica,
                   data_axis: str = DEFAULT_DATA_AXIS) -> torch.Tensor:
    """The whole leaf from the replicas' shards under ``spec``, for the
    training forward; its gradient comes back as the replica's own slice
    (summed over ``data`` where ``spec`` splits over it), never summed
    over ``model``."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _TpGather.apply(x, spec, replica, data_axis)
    return tp_full(x, spec, replica)


def pin_tp_entry(entry: Dict[str, torch.Tensor], specs, replica
                 ) -> Dict[str, torch.Tensor]:
    """An entry with its tensor-parallel leaves gathered whole from their
    compute shards for the forward; the others pass through."""
    out = dict(entry)
    for n, ls in specs.items():
        if n in out:
            out[n] = tp_gather_leaf(out[n], ls.compute, replica)
    return out


def split_tp_entry(entry, specs):
    """One entry -> ``(rest, tp)`` by the spec'd names."""
    tp = {n: entry[n] for n in specs if n in entry}
    rest = {n: a for n, a in entry.items() if n not in specs}
    return rest, tp


def split_tp_state(state):
    """One entry's updater state -> ``(rest_state, tp_state)``; inverse
    :func:`merge_tp_state`. Stateless entries pass ``()`` through."""
    if has_tp(state):
        rest = {k: v for k, v in state.items() if k != TP_KEY}
        return (rest if rest else ()), state[TP_KEY]
    return state, ()


def merge_tp_state(rest, tp):
    if not tp:
        return rest
    out = dict(rest) if isinstance(rest, dict) else {}
    out[TP_KEY] = tp
    return out


def _data_dim(ls, data_axis: str):
    """The dimension the resident spec splits over ``data`` and the
    compute spec does not, or None."""
    for d, a in _spec_dims(ls.resident):
        if a == data_axis:
            return d
    return None


def apply_update_tp(updater, grads: Dict[str, torch.Tensor],
                    params: Dict[str, torch.Tensor], state, iteration: int,
                    replica, specs, *, gather_params: bool,
                    grads_resident: bool = False, epoch: int = 0,
                    data_axis: str = DEFAULT_DATA_AXIS):
    """The elementwise tail of one entry's tensor-parallel leaves on
    ``replica`` (its data group). ``grads`` are the replica's gradient
    slices of its own rows' loss at the compute spec, or with
    ``grads_resident`` (fsdp) at the resident spec, the data-axis sum
    already scattered where that spec splits over ``data``; ``params``
    are its compute shards (resident under fsdp), ``state`` its
    resident state shards. The gradient applied is the data group's
    mean, at the resident spec; the updater runs there, and with
    ``gather_params`` the new resident shards are gathered over ``data``
    back to the compute shards. Returns ``(new_params, new_state)``."""
    n = replica.size
    base = _base_replica(replica)
    g_res, p_res, dims = {}, {}, {}
    for name, g in grads.items():
        ls = specs[name]
        dd = _data_dim(ls, data_axis)
        p = params[name]
        if dd is None:
            g_res[name] = replica.all_reduce_sum(g.contiguous()) / n
            p_res[name] = p
        elif grads_resident:
            g_res[name] = g / n
            p_res[name] = p
        else:
            g_res[name] = base.axis_collective(
                "psum_scatter", g.contiguous(), data_axis, dim=dd) / n
            k = p.shape[dd] // n
            p_res[name] = p.narrow(dd, replica.rank * k, k)
            dims[name] = dd
    updates, new_state = updater.apply(g_res, state or {}, iteration, epoch)
    new_params = {}
    for name, p in p_res.items():
        new = (p - updates[name]).to(p.dtype)
        if gather_params and name in dims:
            new = base.axis_collective("all_gather", new.contiguous(),
                                       data_axis, dim=dims[name])
        new_params[name] = new
    return new_params, new_state


def place_tp_params(params: Dict, tp_specs, replica, *,
                    resident: bool = False) -> Dict:
    """The replica's shards of a dense parameter tree: each
    tensor-parallel leaf at its compute (or resident) spec, the rest as
    it is."""
    which = "resident" if resident else "compute"
    out = {}
    for k, sub in params.items():
        specs = (tp_specs or {}).get(k)
        if not specs:
            out[k] = sub
            continue
        out[k] = {n: (tp_shard(t, getattr(specs[n], which), replica)
                      if n in specs else t) for n, t in sub.items()}
    return out


def gather_tp_params(params: Dict, tp_specs, replica, *,
                     resident: bool = False) -> Dict:
    """Inverse of :func:`place_tp_params` (a collective over the specs'
    axes)."""
    which = "resident" if resident else "compute"
    out = {}
    for k, sub in params.items():
        specs = (tp_specs or {}).get(k)
        if not specs or is_fsdp(sub):
            out[k] = sub
            continue
        out[k] = {n: (tp_full(t, getattr(specs[n], which), replica)
                      if n in specs else t) for n, t in sub.items()}
    return out


def place_updater_states(states: Dict, replica, tp_specs=None,
                         tp_replica=None) -> Dict:
    """A replica's part of the whole-mesh updater states: its slices of
    the flats (:func:`shard_state`, ``replica`` its data group) and its
    resident shards of the ``TP_KEY`` leaves; a dense state keeps its
    tensor-parallel names' shards at their resident specs."""
    tp_specs = tp_specs or {}
    tp_replica = tp_replica if tp_replica is not None else replica
    out = {}
    for k, s in states.items():
        specs = tp_specs.get(k, {})
        if is_dp_sharded(s) or is_encoded(s) or has_tp(s):
            out[k] = shard_state(s, replica.rank, replica.size, specs,
                                 tp_replica)
        elif specs and s:
            out[k] = {slot: {n: (tp_shard(t, specs[n].resident, tp_replica)
                                 if n in specs else t)
                             for n, t in tree.items()}
                      for slot, tree in s.items()}
        else:
            out[k] = s
    return out


def gather_updater_states(states: Dict, replica, tp_specs=None,
                          tp_replica=None) -> Dict:
    """Inverse of :func:`place_updater_states` (a collective)."""
    tp_specs = tp_specs or {}
    tp_replica = tp_replica if tp_replica is not None else replica
    out = {}
    for k, s in states.items():
        specs = tp_specs.get(k, {})
        if is_dp_sharded(s) or is_encoded(s) or has_tp(s):
            out[k] = gather_state(s, replica, specs, tp_replica)
        elif specs and s:
            out[k] = {slot: {n: (tp_full(t, specs[n].resident, tp_replica)
                                 if n in specs else t)
                             for n, t in tree.items()}
                      for slot, tree in s.items()}
        else:
            out[k] = s
    return out


# -- accounting -------------------------------------------------------------
def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


def _numel(tree) -> int:
    if isinstance(tree, dict):
        return sum(_numel(v) for v in tree.values())
    return tree.numel() if isinstance(tree, torch.Tensor) else 0


def update_exchange_bytes(params, n_shards: int, mode=None) -> int:
    """Per-replica wire bytes one applied update exchange moves (ring
    collectives): dense all-reduce = 2(N-1)/N · P bytes; the sharded
    reduce-scatter + all-gather pair moves the same, and so do fsdp's
    per-group parameter all-gathers plus its gradient reduce-scatters.
    The ZeRO wins are residency and update traffic, not wire bytes;
    ``mode`` is accepted so callers can be explicit."""
    total = _nbytes(params)
    if n_shards <= 1:
        return 0
    return int(2 * (n_shards - 1) * total / n_shards)


def update_exchange_axis_bytes(params, data_shards: int,
                               model_shards: int = 1, tp_specs=None) -> dict:
    """Per-axis, per-replica wire bytes one update exchange moves on a
    ``(data, model)`` mesh (ring model). The tensor-parallel leaves stay
    out of the flats, so each model rank exchanges over ``data`` only its
    1/tp of them, and the exchange moves nothing across ``model`` (the
    forward's gathers are the only model-axis traffic).
    ``naive_ravel_cross_axis_bytes`` is what a data-axis ravel of the
    model-sharded leaves would have moved across ``model``."""
    from deeplearning4j_tpu_torch.parallel.speclayout import tp_param_bytes
    total = _nbytes(params)
    tp = max(int(model_shards), 1)
    tpb = tp_param_bytes(params, tp_specs) if tp > 1 else 0
    exchanged = (total - tpb) + tpb // tp
    nd = max(int(data_shards), 1)
    data = int(2 * (nd - 1) * exchanged / nd) if nd > 1 else 0
    naive = int((tp - 1) * tpb / tp) if tp > 1 else 0
    return {"data": data, "model": 0, "pipe": 0, "cross_axis_bytes": 0,
            "naive_ravel_cross_axis_bytes": naive,
            "tp_param_bytes": int(tpb)}


def _dp_raveled_elems(params, tp_specs=None) -> int:
    """Elements of the leaves the flats cover (tensor-parallel leaves
    excluded: they keep their elementwise tail)."""
    tp_specs = tp_specs or {}
    if not isinstance(params, dict):
        return _numel(params)
    total = 0
    for k, sub in params.items():
        names = set(tp_specs.get(k, ()))
        if names and isinstance(sub, dict):
            sub = {n: a for n, a in sub.items() if n not in names}
        total += _numel(sub)
    return total


def encoded_exchange_bytes(params, n_shards: int, encoding=None,
                           sparsity=None, tp_specs=None) -> int:
    """Per-replica wire bytes the encoded exchange moves per applied
    step: the ring model (``2(N-1)/N``) over the codec's serialized
    payload (``encoding.encoded_payload_bytes``) instead of the
    parameter bytes. ``sparsity`` is the observed transmitted fraction
    (threshold scheme); ``None`` takes the spec's planning sparsity.
    Tensor-parallel leaves are left out: their tail is uncompressed."""
    spec = resolve_encoding(encoding)
    elems = _dp_raveled_elems(params, tp_specs)
    if n_shards <= 1 or elems == 0:
        return 0
    frac = (spec.planning_sparsity() if sparsity is None
            else float(sparsity))
    payload = encoded_payload_bytes(elems, spec.scheme, frac)
    return int(2 * (n_shards - 1) * payload / n_shards)


def exchange_report(params, n_shards: int, mode=None, encoding=None,
                    observed_sparsity=None, model_shards: int = 1,
                    tp_specs=None, pipe_shards: int = 1,
                    stage_param_bytes=None) -> dict:
    """One step's update-exchange accounting: parameter bytes, wire
    bytes a replica (ring model), their ratio, and the mode's split:
    dense reports the one all-reduce; sharded, fsdp and encoded the
    gradient reduce-scatter and parameter all-gather halves; fsdp adds
    the parameters resident a replica; encoded the codec's wire against
    the dense counterfactual (``compression_ratio``). With
    ``model_shards > 1`` the per-axis block of
    :func:`update_exchange_axis_bytes` and the tensor-parallel residency
    join it; with ``pipe_shards > 1`` a ``pipeline`` block with the
    stages' parameter bytes (each stage's flats stay in its pipe group,
    so nothing of the exchange crosses ``pipe``)."""
    total = _nbytes(params)
    mode_s = getattr(mode, "value", mode) or "dense"
    tp = max(int(model_shards), 1)
    axis_bytes = update_exchange_axis_bytes(params, n_shards, tp, tp_specs)
    wire = (axis_bytes["data"] if tp > 1
            else update_exchange_bytes(params, n_shards, mode))
    half = int(wire // 2)
    rep = {
        "mode": mode_s,
        "shards": int(n_shards),
        "param_bytes": int(total),
        "wire_bytes_per_replica": int(wire),
        "wire_to_param_ratio": round(wire / total, 3) if total else 0.0,
    }
    if mode_s == UpdateExchange.DENSE.value:
        rep["all_reduce_bytes"] = int(wire)
    else:
        rep["grad_reduce_scatter_bytes"] = half
        rep["param_all_gather_bytes"] = half
    if mode_s == UpdateExchange.ENCODED.value:
        enc_spec = resolve_encoding(encoding)
        frac = (enc_spec.planning_sparsity() if observed_sparsity is None
                else float(observed_sparsity))
        enc_wire = encoded_exchange_bytes(
            params, n_shards, enc_spec, sparsity=frac,
            tp_specs=tp_specs if tp > 1 else None)
        if tp > 1:
            # the tensor-parallel tail exchanges its 1/tp slice dense
            tpb = axis_bytes["tp_param_bytes"]
            enc_wire += (int(2 * (n_shards - 1) * (tpb // tp) / n_shards)
                         if n_shards > 1 else 0)
        rep["dense_wire_bytes"] = int(wire)
        rep["encoded_wire_bytes"] = int(enc_wire)
        rep["wire_bytes_per_replica"] = int(enc_wire)
        rep["wire_to_param_ratio"] = (
            round(enc_wire / total, 5) if total else 0.0)
        rep["compression_ratio"] = round(wire / max(enc_wire, 1), 3)
        rep["encoding_scheme"] = enc_spec.scheme
        rep["encoding_sparsity"] = float(frac)
        rep["grad_reduce_scatter_bytes"] = int(enc_wire) // 2
        rep["param_all_gather_bytes"] = int(enc_wire) // 2
    if mode_s == UpdateExchange.FSDP.value:
        rep["param_resident_bytes_per_replica"] = (
            int(total // n_shards) if n_shards > 1 else int(total))
    if tp > 1:
        rep["model_shards"] = tp
        rep["axis_bytes"] = axis_bytes
        rep["tp_resident_bytes_per_replica"] = \
            axis_bytes["tp_param_bytes"] // tp
    pp = max(int(pipe_shards), 1)
    if pp > 1:
        rep["pipe_shards"] = pp
        rep["pipeline"] = {
            "stages": pp,
            "stage_param_bytes": [int(b) for b in (stage_param_bytes or [])],
            "cross_pipe_bytes": 0}
    return rep


def sharded_state_bytes(states: Dict) -> int:
    """Bytes of the flat sharded updater state in ``states``: the whole
    mesh's for :func:`states_to_sharded`'s layout, a replica's for its
    :func:`shard_state` slices."""
    return sum(_nbytes(s[DP_SHARDED_KEY]) for s in states.values()
               if is_dp_sharded(s))


def encoded_residual_bytes(states: Dict) -> int:
    """Bytes of the encoded rung's residual in ``states`` (a replica's
    for its slices)."""
    return sum(_nbytes(s[ENCODED_KEY]["residual"])
               for s in states.values() if is_encoded(s))


def dense_state_bytes(states: Dict) -> int:
    """Bytes of the dense (unsharded) updater state in ``states``."""
    return sum(_nbytes(s) for s in states.values()
               if not (is_dp_sharded(s) or is_encoded(s)))
