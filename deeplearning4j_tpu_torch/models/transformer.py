"""The distributed Transformer LM: data, pipeline, tensor, sequence and
expert parallelism in one train step.

Counterpart of ``deeplearning4j_tpu/models/transformer.py``. One mesh
(:mod:`..parallel.mesh`) with axes

- ``data``: batch sharded; it also hosts the experts (EP): MoE expert
  weights are sharded over ``data`` and tokens reach their experts
  through two all_to_alls;
- ``pipe``: contiguous stages of blocks, the GPipe engine of
  :mod:`..parallel.pipeline`;
- ``model``: megatron column / row sharding of QKV / out-projection and
  the MLP (:mod:`..parallel.tensor`), the vocab-parallel embedding and
  cross-entropy; and sequence parallelism in megatron form (the
  residual stream time-sharded over ``model``);
- ``seq`` (optional): when its size is above 1, activations are
  time-sharded over it and attention is ring attention with the flash
  kernels (:mod:`..parallel.sequence`), in place of the megatron-SP
  layout.

The JAX package compiles the step as one ``shard_map`` program. Here each
rank runs its own eager program (a thread of a :class:`ThreadMesh`, or a
process of a :class:`ProcessGroupMesh`) and the axis collectives meet
across them. Gradients follow the rule the JAX model keeps for
``shard_map`` without replication typing: every collective's backward is
its transpose, each rank seeds its (replicated) loss with 1/N for a mesh
of N ranks, and each leaf's gradient is then summed over every mesh axis
its PartitionSpec does not name (:meth:`DistributedTransformerLM.
_reduce_grads`). Parameters live as each rank's local shards; the global
tree (stage-stacked leaves with a leading ``[n_stages]`` dimension, as
the JAX package's) is cut by :meth:`param_specs` and put back by
:meth:`DistributedTransformerLM.gather`.

The megatron layout's attention passes a per-query causal mask, which
takes the dense attention path (no kernel), as in the JAX package; the
ring layout launches kernels 7, 8 and 9 on each visible ring step.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.learning.updaters import IUpdater, Sgd
from deeplearning4j_tpu_torch.parallel.expert import (init_moe_params,
                                                      moe_ffn)
from deeplearning4j_tpu_torch.parallel.mesh import (P, axis_index,
                                                    gather_tree, pmax,
                                                    pmean, psum,
                                                    psum_scatter,
                                                    replica_scope,
                                                    shard_leaf, shard_tree,
                                                    spec_axes)
from deeplearning4j_tpu_torch.parallel.pipeline import (from_microbatches,
                                                        pipeline_apply,
                                                        to_microbatches)
from deeplearning4j_tpu_torch.parallel.sequence import ring_attention
from deeplearning4j_tpu_torch.parallel.tensor import (gelu,
                                                      init_tp_block_params,
                                                      layer_norm,
                                                      row_parallel_dense,
                                                      sp_all_gather, tp_mlp,
                                                      tp_self_attention)


@dataclass
class TransformerLMConfig:
    vocab_size: int = 256
    max_len: int = 128
    d_model: int = 64
    n_heads: int = 4
    d_ff: int = 128
    layers_per_stage: int = 2
    n_experts: int = 0          # 0 = dense MLP everywhere (no MoE)
    moe_top_k: int = 2
    moe_capacity: Optional[int] = None   # None = capacity_factor rule
    moe_capacity_factor: float = 1.25
    aux_coef: float = 0.01
    dtype: torch.dtype = torch.float32


def _seed(seed: int, *path: int) -> int:
    """A generator seed for one piece of the model, from the model seed
    and the piece's place (independent of how stages split the
    blocks)."""
    return int(np.random.SeedSequence([int(seed), *path])
               .generate_state(1)[0])


def _gen(seed: int, *path: int) -> torch.Generator:
    return torch.Generator().manual_seed(_seed(seed, *path))


def flatten_tree(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """``{"stages/0/attn/Wq": tensor, ...}`` in tree order."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten_tree(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(flatten_tree(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


def unflatten_tree(like, flat: Dict[str, torch.Tensor], prefix: str = ""):
    if isinstance(like, dict):
        return {k: unflatten_tree(v, flat, f"{prefix}{k}/")
                for k, v in like.items()}
    if isinstance(like, list):
        return [unflatten_tree(v, flat, f"{prefix}{i}/")
                for i, v in enumerate(like)]
    return flat[prefix[:-1]]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


class DistributedTransformerLM:
    """dp/pp/tp/sp/ep-sharded causal LM.

    ``mesh`` must have axes ``data``, ``pipe`` and ``model``; an optional
    ``seq`` axis of size above 1 switches sequence handling from
    megatron-SP (time sharded over ``model``) to ring-attention CP (time
    sharded over ``seq``). The mesh's devices place the model: a mesh
    made without devices spans the cards (and raises without one); CPU
    replicas are asked for by ``devices=["cpu"] * n``."""

    def __init__(self, conf: TransformerLMConfig, mesh,
                 updater: Optional[IUpdater] = None, n_micro: int = 4):
        self.conf = conf
        self.mesh = mesh
        self.updater = updater if updater is not None else Sgd(0.1)
        self.n_micro = n_micro
        ax = mesh.shape
        for need in ("data", "pipe", "model"):
            if need not in ax:
                raise ValueError(f"mesh needs axis '{need}', has {ax}")
        self.dp = ax["data"]
        self.pp = ax["pipe"]
        self.tp = ax["model"]
        self.sp = ax.get("seq", 1)
        self.ring = self.sp > 1
        if conf.n_heads % self.tp:
            raise ValueError("n_heads must divide by tp")
        if conf.n_experts and conf.n_experts % self.dp:
            raise ValueError("n_experts must divide by dp (EP axis)")
        if conf.vocab_size % self.tp:
            raise ValueError("vocab_size must divide by tp (the "
                             "vocab-parallel embedding and head)")

    # -- parameter structure ----------------------------------------------
    def _moe_layer(self, l: int) -> bool:
        """Static MoE placement: the last block of every stage."""
        return (self.conf.n_experts > 0
                and l == self.conf.layers_per_stage - 1)

    def init_global_params(self, seed: int = 0):
        """The full (unsharded) parameter tree on the CPU, drawn from
        explicit generators: ``embed``, ``pos``, ``head`` and each block
        (by its global index) from their own seed. Stage-stacked leaves
        get a leading ``[n_stages]`` dimension; shards are slices."""
        c = self.conf
        dt = c.dtype

        def normal(g, *shape, scale):
            return (torch.randn(*shape, generator=g, dtype=torch.float32)
                    * scale).to(dt)

        stages = []
        for l in range(c.layers_per_stage):
            per_stage = []
            for s in range(self.pp):
                b = s * c.layers_per_stage + l
                g = _gen(seed, 3, b)
                p = init_tp_block_params(g, c.d_model, c.n_heads, c.d_ff,
                                         tp=1, tp_rank=0, dtype=dt)
                if self._moe_layer(l):
                    del p["mlp"]
                    p["moe"] = init_moe_params(
                        _gen(seed, 4, b), c.d_model, c.d_ff, c.n_experts,
                        ep=1, ep_rank=0, dtype=dt)
                per_stage.append(p)
            stages.append(_stack(per_stage))
        return {
            "embed": normal(_gen(seed, 0), c.vocab_size, c.d_model,
                            scale=0.02),
            "pos": normal(_gen(seed, 1), c.max_len, c.d_model, scale=0.02),
            "stages": stages,
            "ln_f_g": torch.ones(c.d_model, dtype=dt),
            "ln_f_b": torch.zeros(c.d_model, dtype=dt),
            "head": normal(_gen(seed, 2), c.d_model, c.vocab_size,
                           scale=c.d_model ** -0.5),
        }

    def param_specs(self):
        """Each leaf's :class:`PartitionSpec` over the mesh axes (the
        stage-stacked leaves shard their leading dimension over
        ``pipe``)."""
        col = P("pipe", None, "model")
        row = P("pipe", "model", None)
        rep = P("pipe", None)
        blk = {
            "ln1_g": rep, "ln1_b": rep, "ln2_g": rep, "ln2_b": rep,
            "attn": {"Wq": col, "Wk": col, "Wv": col, "Wo": row,
                     "bo": rep},
        }
        dense = dict(blk)
        dense["mlp"] = {"Wi": col, "bi": P("pipe", "model"),
                        "Wo": row, "bo": rep}
        moe = dict(blk)
        moe["moe"] = {"Wg": P("pipe", None, None),
                      "Wi": P("pipe", "data", None, None),
                      "Wo": P("pipe", "data", None, None)}
        stages = [moe if self._moe_layer(l) else dense
                  for l in range(self.conf.layers_per_stage)]
        return {
            "embed": P("model", None),     # vocab-parallel rows
            "pos": P(),
            "stages": stages,
            "ln_f_g": P(), "ln_f_b": P(),
            "head": P(None, "model"),      # column-parallel
        }

    def _replicas(self):
        return self.mesh.local_replicas()

    def shard(self, params, opt_state=None):
        """Global trees -> ``(params, opt_state)``: lists of each local
        replica's shards (rank order) on its device. ``opt_state``
        defaults to the updater's fresh state."""
        specs = self.param_specs()
        if opt_state is None:
            opt_state = self.updater.init_state(flatten_tree(params))
            opt_state = {k: unflatten_tree(params, v)
                         for k, v in opt_state.items()}
        ospecs = _state_specs(opt_state, specs)
        ps, ss = [], []
        for r in self._replicas():
            def put(tree, sp, r=r):
                return _tree_map(lambda t: t.to(r.device).clone(),
                                 shard_tree(tree, sp, self.mesh, r.rank))
            ps.append(put(params, specs))
            ss.append({k: put(v, ospecs[k]) for k, v in opt_state.items()})
        return ps, ss

    def init(self, seed: int = 0):
        """``(params, opt_state)``: each local replica's shards of the
        global parameters and of the updater's state."""
        return self.shard(self.init_global_params(seed))

    def gather(self, trees: List) -> dict:
        """The global tree from every rank's local tree (a thread mesh's
        ``params`` list; a process mesh's ranks gather theirs with
        :func:`..parallel.mesh.gather_tree`)."""
        return gather_tree([_tree_map(lambda t: t.detach().cpu(), t)
                            for t in trees], self.param_specs(), self.mesh)

    # -- sharded math (inside a replica) ----------------------------------
    def _embed(self, p, ids):
        """Vocab-parallel embedding plus positions: the time-LOCAL
        activation ``[b, t_local, d]``."""
        table = p["embed"]                  # [V/tp, d] local
        vl = table.shape[0]
        loc = ids - axis_index("model") * vl
        ok = (loc >= 0) & (loc < vl)
        emb = table[loc.clamp(0, vl - 1)]
        emb = torch.where(ok[..., None], emb, 0.0)   # partial per rank
        t = ids.shape[1]
        if self.ring:
            emb = psum(emb, "model")
            off = axis_index("seq") * t
            return emb + p["pos"][off:off + t]
        # megatron-SP: reduce the vocab-partial sums and scatter time
        # over the model axis in one collective
        emb = psum_scatter(emb, "model", 1)      # [b, t/tp, d]
        tl = t // self.tp
        off = axis_index("model") * tl
        return emb + p["pos"][off:off + tl]

    def _attention(self, h, ap, n_heads_local):
        if not self.ring:
            t = h.shape[1] * self.tp        # global length
            mask = torch.tril(torch.ones(t, t, dtype=torch.bool,
                                         device=h.device))[None, None]
            return tp_self_attention(h, ap, n_heads_local, mask=mask,
                                     sequence_parallel=True)
        b, tl, _ = h.shape
        dh = ap["Wq"].shape[-1] // n_heads_local

        def hd(a):
            return a.reshape(b, tl, n_heads_local, dh).transpose(1, 2)

        # flash kernels on each visible ring step, the exact lse merge
        o = ring_attention(hd(h @ ap["Wq"]), hd(h @ ap["Wk"]),
                           hd(h @ ap["Wv"]), "seq", causal=True,
                           use_flash=True)
        o = o.transpose(1, 2).reshape(b, tl, n_heads_local * dh)
        return row_parallel_dense(o, ap["Wo"], ap["bo"], "model")

    def _block(self, p, x, n_heads_local):
        """One transformer block on the local activation layout:
        ``(x, aux)``."""
        c = self.conf
        h = layer_norm(x, p["ln1_g"], p["ln1_b"])
        x = x + self._attention(h, p["attn"], n_heads_local)
        h = layer_norm(x, p["ln2_g"], p["ln2_b"])
        if "moe" in p:
            # each rank routes its LOCAL tokens; EP all_to_all over data
            y, aux = moe_ffn(h, p["moe"], axis="data", k=c.moe_top_k,
                             capacity=c.moe_capacity,
                             capacity_factor=c.moe_capacity_factor)
            if not self.ring:
                aux = pmean(aux, "model")
            return x + y, aux
        return (x + tp_mlp(h, p["mlp"], "model", gelu,
                           sequence_parallel=not self.ring),
                x.new_zeros(()))

    def _local_shape(self, ids):
        b, t = ids.shape
        return (b, t if self.ring else t // self.tp, self.conf.d_model)

    def _loss_local(self, params, ids, labels):
        """The scalar loss (the same on every rank) from local shards;
        ids / labels ``[b_local, t_local]``."""
        c = self.conf
        hl = c.n_heads // self.tp
        stage = axis_index("pipe")
        # only stage 0 reads the pipeline's input
        x = self._embed(params, ids) if stage == 0 else torch.zeros(
            self._local_shape(ids), dtype=c.dtype, device=ids.device)
        xm = to_microbatches(x, self.n_micro)

        def stage_fn(stage_params, xx):
            aux_t = xx.new_zeros(())
            for l in range(c.layers_per_stage):
                bp = _tree_map(lambda a: a[0], stage_params[l])
                xx, aux = self._block(bp, xx, hl)
                aux_t = aux_t + aux
            return xx, aux_t

        outs, aux_sum = pipeline_apply(stage_fn, params["stages"], xm,
                                       with_aux=True)
        # the aux term keeps the pipeline in every stage's graph, so
        # every stage runs the pipeline's backward schedule
        local = c.aux_coef * aux_sum / self.n_micro
        if stage == self.pp - 1:
            h = from_microbatches(outs)          # [b_local, t_local, d]
            h = layer_norm(h, params["ln_f_g"], params["ln_f_b"])
            if not self.ring:
                h = sp_all_gather(h, "model")    # [b_local, t, d]
            logits = h @ params["head"]          # [.., t, V/tp] local
            ce = _vocab_parallel_xent(logits, labels)
            local = ce.mean() + local
        loss = psum(local, "pipe")
        loss = pmean(loss, "data")
        if self.ring:
            loss = pmean(loss, "seq")
        return loss

    def _reduce_grads(self, grads: Dict[str, torch.Tensor],
                      flat_specs: Dict[str, tuple]):
        """Each leaf's gradient summed over every mesh axis of size above
        1 that its spec does not name (one flat buffer per set of axes)."""
        groups: Dict[tuple, List[str]] = {}
        for k, s in flat_specs.items():
            axes = tuple(a for a, n in self.mesh.shape.items()
                         if n > 1 and a not in spec_axes(s))
            if axes:
                groups.setdefault(axes, []).append(k)
        out = dict(grads)
        for axes, keys in groups.items():
            flat = torch.cat([grads[k].reshape(-1) for k in keys])
            flat = psum(flat, axes)
            for k, part in zip(keys, flat.split(
                    [grads[k].numel() for k in keys])):
                out[k] = part.view_as(grads[k])
        return out

    # -- public API ---------------------------------------------------------
    def data_specs(self):
        if self.ring:
            return P("data", "seq")
        return P("data", None)

    def _local_data(self, replica, a):
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.asarray(a))
        coords = dict(zip(self.mesh.axes, self.mesh.coords(replica.rank)))
        return shard_leaf(t, self.data_specs(), self.mesh.axes,
                          coords).to(replica.device, torch.int64)

    def _rank_grads(self, replica, params, ids, labels):
        """This rank's loss and reduced gradients (flat dict)."""
        specs = flatten_tree(self.param_specs())
        with replica_scope(replica):
            flat = {k: v.detach().requires_grad_()
                    for k, v in flatten_tree(params).items()}
            loss = self._loss_local(unflatten_tree(params, flat),
                                    self._local_data(replica, ids),
                                    self._local_data(replica, labels))
            keys = list(flat)
            got = torch.autograd.grad(loss / self.mesh.size,
                                      [flat[k] for k in keys],
                                      allow_unused=True)
            grads = {k: g if g is not None else torch.zeros_like(flat[k])
                     for k, g in zip(keys, got)}
            grads = self._reduce_grads(grads, specs)
        return loss.detach(), grads

    def _rank_step(self, replica, params, opt_state, ids, labels, it):
        loss, grads = self._rank_grads(replica, params, ids, labels)
        flat_p = flatten_tree(params)
        state = {k: flatten_tree(v) for k, v in opt_state.items()}
        with torch.no_grad():
            upd, new_state = self.updater.apply(grads, state, it)
            new_p = {k: flat_p[k] - upd[k] for k in flat_p}
        return (unflatten_tree(params, new_p),
                {k: unflatten_tree(params, v) for k, v in new_state.items()},
                loss)

    def _each(self, fn):
        """``fn(i, replica)`` for each local replica: a thread mesh's
        on their threads, a process mesh's one in this process."""
        if hasattr(self.mesh, "run"):
            return self.mesh.run(lambda r: fn(r, self.mesh.replica(r)))
        return [fn(0, self._replicas()[0])]

    def loss_and_grads(self, params, ids, labels):
        """``(loss, grads)``: the loss and each local replica's reduced
        gradient tree, before any update."""
        out = self._each(lambda i, r: self._rank_grads(r, params[i], ids,
                                                       labels))
        grads = [unflatten_tree(params[i], g) for i, (_, g) in
                 enumerate(out)]
        return float(out[0][0]), grads

    def train_step(self, params, opt_state, ids, labels, it=0):
        """One step on the global batch ``ids`` / ``labels`` ``[B, T]``
        (numpy or torch; each rank takes its shard by
        :meth:`data_specs`): ``(params, opt_state, loss)``, the first two
        lists of each local replica's trees."""
        out = self._each(lambda i, r: self._rank_step(
            r, params[i], opt_state[i], ids, labels, int(it)))
        return ([o[0] for o in out], [o[1] for o in out],
                float(out[0][2]))


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _state_specs(state, specs):
    """Updater-state specs: every state leaf mirrors its param leaf
    (states are ``{slot: param-shaped tree}``)."""
    return {k: specs for k in state}


def _vocab_parallel_xent(logits_local, labels, axis: str = "model"):
    """Per-token cross-entropy with the vocab dim sharded over ``axis``
    (megatron): max / sum / target logit stitched by pmax / psum."""
    vl = logits_local.shape[-1]
    # the stabilizer is mathematically a constant: no gradient
    m = pmax(logits_local.detach().amax(-1), axis)
    e = torch.exp(logits_local - m[..., None]).sum(-1)
    lse = torch.log(psum(e, axis)) + m
    loc = labels - axis_index(axis) * vl
    ok = (loc >= 0) & (loc < vl)
    tgt = logits_local.gather(-1, loc.clamp(0, vl - 1)[..., None])[..., 0]
    tgt = psum(torch.where(ok, tgt, 0.0), axis)
    return lse - tgt
