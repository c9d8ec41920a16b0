"""Data-parallel ``SameDiff.output`` and ``SameDiff.fit_steps``.

Counterpart of the mesh branches of ``deeplearning4j_tpu/autodiff/
samediff.py`` (``_shard_placeholders``, ``output(mesh=)``,
``fit_steps(mesh=)``). The JAX package compiles one program over the
global batch and lets GSPMD place the collectives. PyTorch runs eagerly,
so here every replica of a ``parallel/mesh.DpMesh`` (a ``ThreadMesh`` of
replicas in this process, or the one replica of a ``ProcessGroupMesh``
in each process) walks the graph on its rows of the batch, and the walk
itself keeps the global program's meaning:

- **Which values are shards.** The batch placeholders are (the
  ``TrainingConfig`` mappings, else the leading-dimension vote, with
  the JAX package's warning; ``ph_specs`` overrides either); variables,
  constants and other placeholders are replicated. One pass of the walk
  on meta tensors, at the global and at the local shapes, finds every
  op's outputs that are shards (their leading dimension is the local
  one), and the ops that take a shard and give a replicated value: a
  sum over the batch (``reduce_sum``, a product contracting the batch
  axis, a loss op with ``reduction="sum"``) or a mean (``reduce_mean``,
  a loss op reducing by its default mean). Their local results are all-reduced
  (the mean divided by the replica count: shards are equal), through a
  differentiable all-reduce, so the value every replica goes on with is
  the global one. Any other op that consumes the batch axis raises
  ``NotImplementedError`` naming it.
- **Attributes that fix the global batch.** An imported graph's
  ``reshape`` carries the global batch in its target shape; a replica
  reshapes to its share of the leading dimension. A random op whose
  output is a shard draws the global rows from its key and keeps its
  own, so the masks are the one-device walk's.

So the loss each replica computes is the global loss: the imported MLM
loss ``Σ(xent·valid) / max(Σ valid, 1)`` divides the global sums, not a
shard's. Replica ``r``'s gradient is then ``N`` times its rows' share of
the global gradient (the all-reduce's backward sums the replicas'
cotangents) plus the replicated terms, and the update exchange of
``parallel/zero.py`` (``dense``: an all-reduce; ``sharded``: ZeRO-1;
``encoded``: ZeRO-1 with the gradient compressed; ``fsdp``: ZeRO-3, the
variables resident as 1/N flat slices, gathered for the walk) applies
the replicas' mean, which is the global gradient.

The variables are one parameter group (one flat ravel a dtype). Between
calls the graph holds dense variables and a dense updater state; a call
converts them to its exchange's layout and back, so calls with different
exchanges or replica counts chain. Remat segments are not applied under
a mesh (``NotImplementedError``), nor are tensor-parallel specs (ROADMAP
item 12).
"""
from __future__ import annotations

import copy
import logging
from typing import Dict, Optional

import torch

from deeplearning4j_tpu_torch.autodiff.registry import OP_DOMAINS, get_op
from deeplearning4j_tpu_torch.common.rng import RngKey
from deeplearning4j_tpu_torch.learning.updaters import dp_ravel, dp_unravel
from deeplearning4j_tpu_torch.parallel import zero
from deeplearning4j_tpu_torch.parallel.encoding import resolve_encoding
from deeplearning4j_tpu_torch.parallel.mesh import (DEFAULT_DATA_AXIS,
                                                    ThreadMesh,
                                                    all_reduce_sum,
                                                    canonical_device)

log = logging.getLogger("deeplearning4j_tpu_torch")

#: ops whose output, when it has lost the batch axis of a sharded input,
#: is a sum over the batch rows
SUM_OPS = {"reduce_sum", "matmul", "mmul", "dot", "tensordot"}
#: ... a mean over the batch rows
MEAN_OPS = {"reduce_mean"}
#: random ops whose output may be a shard (the draw follows its input)
RNG_DRAWS = {"dropout"}


def _item12(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"SameDiff {what}: only the data axis is ported (tensor, sequence "
        f"and pipeline parallelism are ROADMAP.md, Queue A item 12)")


def check_mesh(mesh) -> int:
    """The mesh's data-axis size; an axis other than ``data`` of size
    above 1 raises (item 12)."""
    shape = dict(mesh.shape)
    if DEFAULT_DATA_AXIS not in shape:
        raise ValueError(f"mesh must have a 'data' axis, got "
                         f"{tuple(shape)}")
    other = {k: v for k, v in shape.items()
             if k != DEFAULT_DATA_AXIS and v > 1}
    if other:
        raise _item12(f"mesh axes {other}")
    return int(shape[DEFAULT_DATA_AXIS])


def _spec_shards(name: str, spec) -> bool:
    """Whether an explicit placeholder spec shards the leading axis over
    ``data``: ``"data"``, ``("data", None, ...)`` or a PartitionSpec-like
    sequence; ``None`` or ``()`` replicate. Any other axis raises."""
    entries = (spec if isinstance(spec, (tuple, list)) else
               () if spec is None else (spec,))
    entries = tuple(entries)
    if any(e not in (None, DEFAULT_DATA_AXIS) for e in entries) or \
            DEFAULT_DATA_AXIS in entries[1:]:
        raise _item12(f"placeholder spec {name!r}: {spec!r}")
    return bool(entries) and entries[0] == DEFAULT_DATA_AXIS


def shard_placeholders(n: int, ph_vals: Dict[str, torch.Tensor],
                       batch_names=None, specs=None) -> frozenset:
    """The shared data-parallel placeholder contract of ``output(mesh=)``
    and ``fit_steps(mesh=)``, the JAX package's ``_shard_placeholders``:
    the names of the placeholders whose leading axis shards over the
    ``n`` replicas. ``specs`` maps names to explicit specs (see
    :func:`_spec_shards`), which skip the inference. Otherwise the batch
    is the leading dimension of the first of ``batch_names`` (the
    ``TrainingConfig`` mappings) present, or the vote: the most common
    leading dimension among the non-scalar placeholders, ties broken
    toward dimensions that divide ``n``, then higher rank, then size;
    the vote warns about the placeholders it leaves replicated. A batch
    placeholder whose leading dimension does not divide by ``n``
    raises."""
    specs = dict(specs or {})
    for k in specs:
        if k not in ph_vals:
            raise ValueError(
                f"placeholder spec for unknown placeholder {k!r} "
                f"(have {sorted(ph_vals)})")
    explicit = {k: _spec_shards(k, sp) for k, sp in specs.items()}
    batch, inferred = None, False
    for k in batch_names or ():
        v = ph_vals.get(k)
        if v is not None and v.dim() > 0:
            batch = int(v.shape[0])
            break
    if batch is None:
        leads: dict = {}
        ranks: dict = {}
        for k, v in ph_vals.items():
            if k not in specs and v.dim() > 0:
                d = int(v.shape[0])
                leads[d] = leads.get(d, 0) + 1
                ranks[d] = max(ranks.get(d, 0), v.dim())
        if leads:
            inferred = True
            batch = max(leads, key=lambda d: (
                leads[d], d % n == 0, ranks[d], d))
    if inferred:
        excluded = sorted(
            k for k, v in ph_vals.items()
            if k not in specs and v.dim() > 0 and int(v.shape[0]) != batch)
        if excluded:
            log.warning(
                "batch-dim inference chose leading dim %d — "
                "placeholders %s (other leading dims) will be "
                "replicated, not batch-sharded. Pass explicit "
                "data_set_feature_mapping/label_mapping (or "
                "batch_names), or per-placeholder specs "
                "(ph_specs=...), to disambiguate.", batch, excluded)
    sharded = set()
    for k, v in ph_vals.items():
        shard = explicit[k] if k in explicit else (
            v.dim() > 0 and int(v.shape[0]) == batch)
        if not shard:
            continue
        if v.dim() == 0 or v.shape[0] % n:
            raise ValueError(
                f"placeholder {k!r} batch dim {tuple(v.shape)} not "
                f"divisible by data axis size {n}")
        sharded.add(k)
    return frozenset(sharded)


def local_rows(t: torch.Tensor, rank: int, n: int) -> torch.Tensor:
    s = t.shape[0] // n
    return t[rank * s:(rank + 1) * s]


# ---------------------------------------------------------------------------
class DpWalk:
    """What one replica's walk does differently from the one-device walk:
    the target shapes of reshapes (``reshape``), the ops whose result is
    all-reduced (``reduce``: ``"sum"`` or ``"mean"``), the random ops that
    draw global rows and keep their own (``rows``), and which values are
    shards (``sharded``)."""

    __slots__ = ("n", "reshape", "reduce", "rows", "sharded")

    def __init__(self, n: int):
        self.n = n
        self.reshape: Dict[int, list] = {}
        self.reduce: Dict[int, str] = {}
        self.rows: set = set()
        self.sharded: set = set()


def _meta(t: torch.Tensor, rows: Optional[int] = None) -> torch.Tensor:
    shape = tuple(t.shape) if rows is None else (rows,) + tuple(t.shape[1:])
    return torch.empty(shape, dtype=t.dtype, device="meta")


def classify_walk(sd, ops, ph_vals: Dict[str, torch.Tensor],
                  sharded: frozenset, n: int, training: bool) -> DpWalk:
    """One pass of the walk ``ops`` on meta tensors at the global shapes
    and at one replica's: the :class:`DpWalk` of every op that takes a
    shard. Raises ``NotImplementedError`` naming an op that cannot run
    on a shard, or that consumes the batch axis other than by a sum or a
    mean."""
    walk = DpWalk(n)
    if n == 1:
        # one replica's shard is the batch: the walk is the one-device one
        walk.sharded = set(sharded)
        return walk
    glob = {k: _meta(v) for k, v in sd._arrays.items()}
    glob.update({k: _meta(v) for k, v in ph_vals.items()})
    loc = dict(glob)
    for k in sharded:
        loc[k] = _meta(ph_vals[k], ph_vals[k].shape[0] // n)
    shard = set(sharded)
    rng = RngKey(0)
    for idx in ops:
        node = sd.ops[idx]
        what = f"op '{node.outputs[0]}' ({node.op_name})"
        attrs = sd._op_attrs(idx, node, rng, training)
        g_out = get_op(node.op_name)([glob[i] for i in node.inputs], attrs)
        g_out = [g_out] if len(node.outputs) == 1 else list(g_out)
        glob.update(zip(node.outputs, g_out))
        if not any(i in shard for i in node.inputs):
            loc.update(zip(node.outputs, g_out))
            continue
        if node.op_name == "reshape":
            target = [int(s) for s in node.attrs["shape"]]
            if target and target[0] != -1:
                if target[0] % n:
                    raise NotImplementedError(
                        f"{what} reshapes a batch shard to a leading "
                        f"dimension {target[0]} that does not divide by "
                        f"{n} replicas")
                target[0] //= n
                walk.reshape[idx] = target
                attrs = dict(attrs, shape=target)
        try:
            l_out = get_op(node.op_name)([loc[i] for i in node.inputs],
                                         attrs)
        except (RuntimeError, ValueError, IndexError, TypeError) as e:
            raise NotImplementedError(
                f"{what} cannot run on a batch shard under a data-parallel "
                f"mesh: {e}") from e
        l_out = [l_out] if len(node.outputs) == 1 else list(l_out)
        loc.update(zip(node.outputs, l_out))
        for name, g, lo in zip(node.outputs, g_out, l_out):
            gs, ls = tuple(g.shape), tuple(lo.shape)
            if len(gs) == len(ls) and gs and gs[0] == n * ls[0] \
                    and gs[1:] == ls[1:] and gs != ls:
                shard.add(name)
                if node.op_name in RNG_DRAWS:
                    walk.rows.add(idx)
                continue
            kind = None
            if gs == ls and len(node.outputs) == 1:
                if node.op_name in SUM_OPS:
                    kind = "sum"
                elif node.op_name in MEAN_OPS:
                    kind = "mean"
                elif OP_DOMAINS.get(node.op_name) == "loss" and \
                        node.attrs.get("reduction", "mean") in ("sum",
                                                                "mean"):
                    kind = node.attrs.get("reduction", "mean")
            if kind is None:
                raise NotImplementedError(
                    f"{what} consumes the batch axis of a shard ({gs} "
                    f"globally, {ls} on a replica): a data-parallel walk "
                    f"combines only sums and means across replicas")
            walk.reduce[idx] = kind
    walk.sharded = shard
    return walk


class DpRank:
    """One replica's hooks into ``SameDiff._execute``."""

    __slots__ = ("walk", "replica")

    def __init__(self, walk: DpWalk, replica):
        self.walk, self.replica = walk, replica

    def attrs(self, idx: int, attrs: dict) -> dict:
        target = self.walk.reshape.get(idx)
        if target is not None:
            attrs = dict(attrs, shape=target)
        if idx in self.walk.rows:
            attrs = dict(attrs, _dp_rows=(self.replica.rank,
                                          self.replica.size))
        return attrs

    def combine(self, idx: int, out):
        kind = self.walk.reduce.get(idx)
        if kind is None:
            return out
        total = all_reduce_sum(out.reshape(-1).contiguous(),
                               self.replica).reshape(out.shape)
        return total / self.walk.n if kind == "mean" else total


def gather_rows(t: torch.Tensor, replica) -> torch.Tensor:
    """The replicas' shards of ``t`` concatenated in rank order."""
    flat = replica.all_gather(t.contiguous().reshape(-1))
    return flat.reshape((t.shape[0] * replica.size,) + tuple(t.shape[1:]))


# ---------------------------------------------------------------------------
def _replicas(sd, mesh) -> list:
    """The replicas this process runs, each on the graph's device for
    rank 0 (a thread mesh) or this process's one (a process group)."""
    reps = mesh.local_replicas()
    if isinstance(mesh, ThreadMesh):
        if canonical_device(sd.device) != reps[0].device:
            raise ValueError(f"the graph is on {sd.device}, the mesh's "
                             f"rank 0 on {reps[0].device}")
    elif canonical_device(sd.device) != canonical_device(reps[0].device):
        raise ValueError(f"the graph is on {sd.device}, this process's "
                         f"replica on {reps[0].device}")
    return reps


def _run_replicas(mesh, fn) -> list:
    """``fn(i)`` for every local replica ``i``: on the mesh's threads for
    a thread mesh, here for a process group's one."""
    if isinstance(mesh, ThreadMesh):
        return mesh.run(fn)
    return [fn(0)]


def _batch_names(sd):
    cfg = sd.training_config
    if cfg is None:
        return None
    return list(cfg.data_set_feature_mapping) + \
        list(cfg.data_set_label_mapping)


def _walk(sd, plan_ops, ph_vals, sharded, n, training) -> DpWalk:
    key = ("dp", tuple(plan_ops), sharded, n, training,
           tuple(sorted((k, tuple(v.shape), v.dtype)
                        for k, v in ph_vals.items())))
    walk = sd._exec_cache.get(key)
    if walk is None:
        walk = sd._exec_cache[key] = classify_walk(
            sd, plan_ops, ph_vals, sharded, n, training)
    return walk


def output(sd, ph_vals, outputs, mesh, ph_specs, training: bool,
           rng: RngKey) -> Dict[str, torch.Tensor]:
    """``SameDiff.output(mesh=)``: every replica walks its rows; sharded
    outputs are gathered in rank order, so each replica (and each
    process of a group) returns the global result."""
    n = check_mesh(mesh)
    reps = _replicas(sd, mesh)
    plan = sd._plan(outputs, tuple(ph_vals))
    sharded = shard_placeholders(n, ph_vals, _batch_names(sd), ph_specs)
    walk = _walk(sd, plan.ops, ph_vals, sharded, n, training)

    def rank_fn(i):
        rep = reps[i]
        dev = rep.device
        ph = {k: (local_rows(v, rep.rank, n) if k in sharded else v)
              .to(dev) for k, v in ph_vals.items()}
        values = {k: sd._arrays[k].to(dev)
                  for k in list(plan.constants) + list(plan.variables)}
        values.update(ph)
        with torch.no_grad():
            sd._execute(values, plan.ops, rng, training,
                        dp=DpRank(walk, rep))
            return {o: (gather_rows(values[o], rep) if o in walk.sharded
                        else values[o]) for o in outputs}

    return _run_replicas(mesh, rank_fn)[0]


# ---------------------------------------------------------------------------
class _RankState:
    """One replica's variables (dense, or its fsdp slices) and updater
    state (dense, or its slice of the flat layout) for one call."""

    __slots__ = ("replica", "params", "flats", "spec", "state")

    def __init__(self, replica):
        self.replica = replica
        self.params = None
        self.flats = None
        self.spec = None
        self.state = None


def _clone_tree(tree, device):
    if isinstance(tree, dict):
        return {k: _clone_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device, copy=True)
    return copy.deepcopy(tree)


def _step(sd, rs: _RankState, plan, walk: DpWalk, ph, consts, mode,
          encoding, rng: RngKey, iteration: int) -> torch.Tensor:
    """One replica's train step: the walk, its gradient, the exchange."""
    cfg = sd.training_config
    rep = rs.replica
    fsdp = mode is zero.UpdateExchange.FSDP
    if fsdp:
        leaves = {dt: f.detach().requires_grad_(True)
                  for dt, f in rs.flats.items()}
        targets = list(leaves.values())
    else:
        params = {k: t.detach().requires_grad_(True)
                  for k, t in rs.params.items()}
        targets = list(params.values())
    with torch.enable_grad():
        if fsdp:
            params = zero.fsdp_gather(leaves, rs.spec, rep)
        values = dict(consts)
        values.update(params)
        values.update(ph)
        sd._execute(values, plan.ops, rng, True, dp=DpRank(walk, rep))
        total = sum(values[o].sum() for o in sd.loss_variables)
        if cfg.l2:
            total = total + 0.5 * cfg.l2 * sum(
                (p * p).sum() for p in params.values())
        if cfg.l1:
            total = total + cfg.l1 * sum(
                p.abs().sum() for p in params.values())
        grads = torch.autograd.grad(total, targets, allow_unused=True)
    up, epoch = cfg.updater, sd.epoch_count
    with torch.no_grad():
        grads = [g if g is not None else torch.zeros_like(t)
                 for g, t in zip(grads, targets)]
        if fsdp:
            flat_g = dict(zip(leaves, grads))
            rs.flats, rs.state = zero.apply_update_fsdp(
                up, flat_g, rs.flats, rs.state, iteration, rep, epoch=epoch)
            return total.detach()
        grads = dict(zip(params, grads))
        plain = {k: t.detach() for k, t in params.items()}
        if mode is zero.UpdateExchange.SHARDED:
            rs.params, rs.state = zero.apply_update_sharded(
                up, grads, plain, rs.state, iteration, rep, epoch=epoch)
        elif mode is zero.UpdateExchange.ENCODED:
            rs.params, rs.state = zero.apply_update_encoded(
                up, grads, plain, rs.state, iteration, rep,
                encoding=encoding, epoch=epoch)
        else:
            # dense: the replicas' mean gradient, one all-reduce a dtype
            flats, spec = dp_ravel(grads, 1)
            mean = dp_unravel({k: rep.all_reduce_sum(f.contiguous())
                               / rep.size for k, f in flats.items()}, spec)
            updates, rs.state = up.apply(mean, rs.state, iteration, epoch)
            rs.params = {k: _apply(p, updates[k]) for k, p in plain.items()}
    return total.detach()


def _apply(p: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``p - u`` in ``p``'s dtype (a 16-bit variable steps at f32 and
    rounds once), as the one-device step applies it."""
    if p.dtype in (torch.float32, torch.float64):
        return (p - u).to(p.dtype)
    return (p.float() - u.float()).to(p.dtype)


def fit_steps(sd, ph_vals, n_steps: int, mesh, update_exchange, ph_specs,
              encoding) -> Optional[torch.Tensor]:
    """``SameDiff.fit_steps(mesh=)``: ``n_steps`` data-parallel steps on
    one global batch; the graph's variables and dense updater state are
    rank 0's (this process's replica's) after the call. Returns the last
    step's loss (the global loss, the same on every replica)."""
    n = check_mesh(mesh)
    if sd.remat_segments > 1:
        raise NotImplementedError(
            "SameDiff remat segments under a data-parallel mesh")
    reps = _replicas(sd, mesh)
    mode = zero.resolve_update_exchange(mesh, requested=update_exchange)
    encoding = (resolve_encoding(encoding)
                if mode is zero.UpdateExchange.ENCODED else None)
    cfg = sd.training_config
    plan = sd._plan(tuple(sd.loss_variables), tuple(ph_vals))
    names = list(plan.variables)
    sharded = shard_placeholders(n, ph_vals, _batch_names(sd), ph_specs)
    walk = _walk(sd, plan.ops, ph_vals, sharded, n, True)
    dense_vars = {k: sd._arrays[k] for k in names}
    if sd._updater_state is None:
        sd._updater_state = cfg.updater.init_state(dense_vars)
        sd._restore_updater_leaves()
    state0 = sd._updater_state
    if mode is not zero.UpdateExchange.ENCODED:
        state0 = zero.strip_encoded_state(state0)
    sd._rng, key = sd._rng.split(2)
    it0 = sd.iteration_count

    def rank_fn(i):
        rep = reps[i]
        dev, rank = rep.device, rep.rank
        rs = _RankState(rep)
        params = {k: t.to(dev) for k, t in dense_vars.items()}
        state = _clone_tree(state0, dev)
        if mode is zero.UpdateExchange.ENCODED:
            state = zero.shard_state(zero.ensure_encoded_state(
                params, state, n, encoding), rank, n)
        elif mode in zero.FLAT_MODES:
            state = zero.shard_state(zero.to_sharded_state(params, state, n),
                                     rank, n)
        rs.state = state
        if mode is zero.UpdateExchange.FSDP:
            flats, rs.spec = dp_ravel(params, n)
            rs.flats = {dt: local_rows(f, rank, n).clone()
                        for dt, f in flats.items()}
        else:
            rs.params = params
        ph = {k: (local_rows(v, rank, n) if k in sharded else v).to(dev)
              for k, v in ph_vals.items()}
        consts = {k: sd._arrays[k].to(dev) for k in plan.constants}
        loss = None
        for s in range(int(n_steps)):
            loss = _step(sd, rs, plan, walk, ph, consts, mode, encoding,
                         key.fold_in(s), it0 + s)
        # back to the dense layouts (collectives: every replica)
        if mode is zero.UpdateExchange.FSDP:
            full = {dt: rep.all_gather(f) for dt, f in rs.flats.items()}
            rs.params = dp_unravel(full, rs.spec)
        state = rs.state
        if mode in zero.FLAT_MODES:
            state = zero.to_dense_state(rs.params,
                                        zero.gather_state(state, rep))
        return loss, rs.params, state

    loss, params, state = _run_replicas(mesh, rank_fn)[0]
    sd._arrays.update(params)
    sd._updater_state = state
    sd.iteration_count += int(n_steps)
    return loss
