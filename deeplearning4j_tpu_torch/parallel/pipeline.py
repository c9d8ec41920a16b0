"""Pipeline parallelism over the ``pipe`` axis: the GPipe microbatch
engine of the distributed Transformer LM, and the fit path of the DL4J
network types.

Counterpart of ``deeplearning4j_tpu/parallel/pipeline.py``. Two engines:

1. The scan engine (``pipeline_apply`` / ``pipeline_loss``). The JAX package
runs one ``lax.scan`` over clock ticks with a ``ppermute`` handoff a
tick, and the scan's VJP is the backward pipeline. PyTorch runs eagerly,
so here the schedule is explicit, inside one autograd Function
(:class:`_Pipeline`):

- forward: at tick t stage s runs microbatch ``t - s`` (stage 0 reads
  it from the input, the others from the handoff), then every stage of
  the group hands its output to the next with one ppermute;
- backward: the same ticks in reverse; each stage takes its output's
  cotangent (the last stage from the Function's, the others from the
  handoff), back-propagates through that microbatch's stage graph, and
  hands its input's cotangent to the previous stage.

Every rank of a stage (its tensor-, sequence- and expert-parallel
groups) runs the same ticks, so the collectives inside the stage run in
one order in every group. Warm-up and drain ticks, where the JAX scan
computes on garbage and masks it, are skipped. ``remat=True`` keeps only
each microbatch's stage input and recomputes its forward in the
backward (``jax.checkpoint`` on the stage function).

2. The fit path of ``MultiLayerNetwork`` and ``ComputationGraph``
   (:class:`PipelineTrainer`, which ``ParallelWrapper.Builder.
   pipeline_stages`` and ``SharedTrainingMaster`` build):
   :class:`StagePartition` splits the layer stack or the topo order into
   contiguous stages balanced by parameter bytes, :func:`build_schedule`
   gives the GPipe or 1F1B tick table, and each rank of a ``(data,
   model, pipe)`` mesh runs its own stage's ops from that one table. A
   stage keeps only the input of each microbatch in flight and
   recomputes its forward inside the backward; the last stage runs its
   forward once, inside the loss's backward. Activations and cotangents
   cross ``pipe`` point to point after each tick (``Replica.exchange``:
   sends and receives of the tick paired in one batch); within a stage
   the ranks of a data group and of a model group run the same ops in
   the same order, so their collectives (BatchNormalization's
   statistics over ``data``, the tensor-parallel gathers over ``model``)
   pair up. Each stage's update runs the model's own tail (dense, or
   ZeRO-1 over the stage's data group, with the tensor-parallel tails of
   ``parallel/zero.py``).

   The JAX trainer's semantics are kept, quirks included: microbatch mi
   is rows ``[mi·mb, (mi+1)·mb)`` of the global batch, a data rank's part
   of it its ``1/dp`` slice; every microbatch's forward starts from the
   step-start states, and the state kept is that of the last op to run
   one (the forward of microbatch M-1 on a non-last stage; on the last
   stage the loss of the last backward, microbatch M-1 under 1F1B and 0
   under GPipe); the recomputed forward keeps none; forward and
   recompute take one key per microbatch; gradients sum in execution
   order and scale by 1/M, then regularization and gradient
   normalization apply once a step, per stage; the loss is the mean of
   the microbatch losses plus every stage's regularization.
"""
from __future__ import annotations

import logging
import time
from typing import Callable, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.parallel import zero
from deeplearning4j_tpu_torch.parallel.mesh import (DEFAULT_DATA_AXIS,
                                                    DEFAULT_MODEL_AXIS,
                                                    ThreadMesh, axis_index,
                                                    axis_size,
                                                    canonical_device,
                                                    current_replica, psum,
                                                    replica_scope)

log = logging.getLogger("deeplearning4j_tpu_torch")

PIPE_AXIS = "pipe"


def to_microbatches(x, n_micro: int):
    """``[b, ...] -> [n_micro, b/n_micro, ...]`` (leading-dim split)."""
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible by {n_micro} "
                         f"microbatches")
    return x.reshape((n_micro, b // n_micro) + tuple(x.shape[1:]))


def from_microbatches(x):
    return x.reshape((-1,) + tuple(x.shape[2:]))


def _flatten(tree, out: list):
    if isinstance(tree, dict):
        return {k: _flatten(v, out) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_flatten(v, out) for v in tree]
    out.append(tree)
    return len(out) - 1


def _unflatten(skeleton, leaves):
    if isinstance(skeleton, dict):
        return {k: _unflatten(v, leaves) for k, v in skeleton.items()}
    if isinstance(skeleton, list):
        return [_unflatten(v, leaves) for v in skeleton]
    return leaves[skeleton]


class _Run:
    """One pipeline call on one rank: the stage function, this rank's
    stage, and the microbatch graphs between forward and backward."""

    def __init__(self, fn, skeleton, replica, axis: str, remat: bool):
        self.fn, self.skeleton, self.replica = fn, skeleton, replica
        self.axis, self.remat = axis, remat
        self.n_st = 1 if replica is None else replica.axis_size(axis)
        self.stage = 0 if replica is None else replica.axis_index(axis)

    def handoff(self, t: torch.Tensor, forward: bool) -> torch.Tensor:
        """Each stage's tensor to the next stage (forward) or the
        previous one (backward); the chain's end receives zeros."""
        if self.n_st == 1:
            return torch.zeros_like(t)
        pairs = [(i, i + 1) for i in range(self.n_st - 1)]
        if not forward:
            pairs = [(d, s) for s, d in pairs]
        return self.replica.axis_collective("ppermute", t.contiguous(),
                                            self.axis, perm=pairs)

    def stage_forward(self, x_in):
        y, aux = self.fn(_unflatten(self.skeleton, self.p), x_in)
        if aux is None:
            aux = x_in.new_zeros(())
        return y, aux

    def forward(self, x_micro, leaves):
        n_micro = x_micro.shape[0]
        self.n_micro, self.shape = n_micro, x_micro.shape[1:]
        self.p = [l.detach().requires_grad_(l.requires_grad)
                  for l in leaves]
        self.saved = {}
        state = x_micro.new_zeros(self.shape)
        outputs = torch.zeros_like(x_micro)
        aux_sum = x_micro.new_zeros(())
        last = self.stage == self.n_st - 1
        for t in range(n_micro + self.n_st - 1):
            m = t - self.stage
            send = None
            if 0 <= m < n_micro:
                src = x_micro[m] if self.stage == 0 else state
                x_in = src.detach().requires_grad_(src.requires_grad
                                                   or self.stage > 0)
                if self.remat:
                    with torch.no_grad():
                        y, aux = self.stage_forward(x_in)
                    self.saved[m] = (x_in,)
                else:
                    with torch.enable_grad():
                        y, aux = self.stage_forward(x_in)
                    self.saved[m] = (x_in, y, aux)
                aux_sum = aux_sum + aux.detach()
                if last:
                    outputs[m] = y.detach()
                send = y.detach()
            if self.n_st > 1:
                state = self.handoff(
                    send if send is not None else state.new_zeros(
                        self.shape), forward=True)
        return outputs, aux_sum

    def backward(self, g_out, g_aux):
        want = [i for i, p in enumerate(self.p) if p.requires_grad]
        grads = [None] * len(self.p)
        g_x = torch.zeros((self.n_micro,) + tuple(self.shape),
                          dtype=g_out.dtype, device=g_out.device) \
            if self.stage == 0 else None
        g_state = g_out.new_zeros(self.shape)
        last = self.stage == self.n_st - 1
        for t in reversed(range(self.n_micro + self.n_st - 1)):
            m = t - self.stage
            send = None
            if 0 <= m < self.n_micro:
                if self.remat:
                    (x_in,) = self.saved.pop(m)
                    with torch.enable_grad():
                        y, aux = self.stage_forward(x_in)
                else:
                    x_in, y, aux = self.saved.pop(m)
                g_y = g_out[m] if last else g_state
                outs, gos = [y], [g_y]
                if aux.requires_grad:
                    outs.append(aux)
                    gos.append(g_aux)
                use_x = x_in.requires_grad
                ins = [x_in] * use_x + [self.p[i] for i in want]
                got = torch.autograd.grad(outs, ins, gos, allow_unused=True)
                for i, g in zip(want, got[use_x:]):
                    if g is not None:
                        grads[i] = g if grads[i] is None else grads[i] + g
                gx = got[0] if use_x and got[0] is not None else \
                    torch.zeros_like(x_in)
                if self.stage == 0:
                    g_x[m] = gx
                else:
                    send = gx
            if self.n_st > 1:
                g_state = self.handoff(
                    send if send is not None else g_state.new_zeros(
                        self.shape), forward=False)
        return g_x, grads


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run, x_micro, *leaves):
        ctx.run = run
        with replica_scope(run.replica):
            return run.forward(x_micro, leaves)

    @staticmethod
    def backward(ctx, g_out, g_aux):
        run = ctx.run
        with replica_scope(run.replica):
            g_x, grads = run.backward(g_out.contiguous(), g_aux)
        del ctx.run
        return (None, g_x, *grads)


def pipeline_apply(stage_fn: Callable, stage_params, x_micro,
                   axis: str = PIPE_AXIS, remat: bool = False,
                   with_aux: bool = False):
    """Run microbatches through the stage pipeline (inside a replica).

    ``stage_fn(params, x) -> y`` with ``y.shape == x.shape``;
    ``stage_params`` are this rank's stage weights (a tree of tensors);
    ``x_micro`` is ``[n_micro, mb, ...]`` (only stage 0 reads it).
    Returns ``[n_micro, mb, ...]``, valid on the LAST stage (zeros on the
    others). With ``with_aux`` the stage function returns ``(y,
    aux_scalar)`` and the call ``(outputs, aux_sum)``, the sum over this
    stage's microbatches."""
    raw = stage_fn if with_aux else (lambda p, x: (stage_fn(p, x), None))
    leaves: list = []
    skeleton = _flatten(stage_params, leaves)
    run = _Run(raw, skeleton, current_replica(), axis, remat)
    outputs, aux_sum = _Pipeline.apply(run, x_micro, *leaves)
    if with_aux:
        return outputs, aux_sum
    return outputs


def last_stage_only(value, axis: str = PIPE_AXIS):
    """Zero ``value`` except on the last pipeline stage, then psum: every
    stage ends up holding the last stage's value."""
    keep = float(axis_index(axis) == axis_size(axis) - 1)
    return psum(value * keep, axis)


def pipeline_loss(stage_fn: Callable, loss_fn: Callable, stage_params,
                  x_micro, y_micro, axis: str = PIPE_AXIS,
                  remat: bool = False):
    """Forward the pipeline and reduce a mean loss on the last stage.
    ``loss_fn(outputs_mb, labels_mb)`` is a microbatch's scalar mean
    loss; returns the same scalar on every stage."""
    outs = pipeline_apply(stage_fn, stage_params, x_micro, axis, remat)
    per_mb = torch.stack([loss_fn(outs[i], y_micro[i])
                          for i in range(x_micro.shape[0])])
    return last_stage_only(per_mb.mean(), axis)


def init_stage_params(init_fn: Callable, axis: str = PIPE_AXIS):
    """This stage's params: ``init_fn(stage_index) -> params tree``."""
    return init_fn(axis_index(axis))


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    """The GPipe / 1F1B bubble: ``(S-1)/(M+S-1)`` of the schedule's
    ticks are idle on some stage (warm-up and drain)."""
    s, m = int(n_stages), int(n_micro)
    return (s - 1) / float(m + s - 1)


# ===========================================================================
# the fit path: tick tables, stage partitions and the stage executor
# ===========================================================================
#: the microbatch schedules of the fit path
SCHEDULES = ("gpipe", "1f1b")


def build_schedule(n_stages: int, n_micro: int, kind: str = "1f1b"):
    """The tick table of ``kind``: a list of ticks, each a tuple of one
    op a stage, ``("F", m)``, ``("B", m)`` or ``None`` (idle).

    GPipe: every stage runs its M forwards, then the backwards in
    reverse microbatch order. 1F1B: after a warm-up of ``S-s-1``
    forwards, stage ``s`` alternates one backward and one forward, so at
    most ``min(M, S-s)`` microbatches are in flight on it."""
    s_n, m_n = int(n_stages), int(n_micro)
    if kind not in SCHEDULES:
        raise ValueError(f"unknown pipeline schedule {kind!r} "
                         f"(know {SCHEDULES})")
    if s_n < 1 or m_n < 1:
        raise ValueError(f"need n_stages >= 1 and n_micro >= 1, got "
                         f"({s_n}, {m_n})")
    fwd = [0] * s_n            # forwards committed a stage
    bwd = [0] * s_n            # backwards committed a stage
    ticks = []
    while any(b < m_n for b in bwd):
        ops = []
        for s in range(s_n):
            op = None
            f_ready = fwd[s] < m_n and (s == 0 or fwd[s - 1] > fwd[s])
            if kind == "gpipe":
                if f_ready:
                    op = ("F", fwd[s])
                elif fwd[s] == m_n and bwd[s] < m_n:
                    m = m_n - 1 - bwd[s]     # reverse microbatch order
                    if s == s_n - 1 or bwd[s + 1] >= m_n - m:
                        op = ("B", m)
            else:                            # 1f1b, in-order backward
                in_flight = fwd[s] - bwd[s]
                prefer_b = fwd[s] == m_n or in_flight > s_n - s - 1
                b_ready = bwd[s] < m_n and fwd[s] > bwd[s] and \
                    (s == s_n - 1 or bwd[s + 1] > bwd[s])
                if prefer_b:
                    # no forward fallback: falling forward here is what
                    # would let residency grow past S-s
                    op = ("B", bwd[s]) if b_ready else None
                elif f_ready:
                    op = ("F", fwd[s])
            ops.append(op)
        for s, op in enumerate(ops):          # commit after the tick
            if op is not None:
                if op[0] == "F":
                    fwd[s] += 1
                else:
                    bwd[s] += 1
        if not any(ops):
            raise RuntimeError("pipeline schedule deadlocked "
                               f"(kind={kind}, S={s_n}, M={m_n})")
        ticks.append(tuple(ops))
    return ticks


def peak_residency(schedule, n_stages: int):
    """Each stage's most microbatches in flight (forwarded, backward
    pending) over a tick table: the bound on its stashed inputs. GPipe
    peaks at ``M``; 1F1B at ``min(M, S-s)``."""
    live = [0] * n_stages
    peak = [0] * n_stages
    for ops in schedule:
        for s, op in enumerate(ops):
            if op is None:
                continue
            live[s] += 1 if op[0] == "F" else -1
            peak[s] = max(peak[s], live[s])
    return peak


def schedule_idle_ticks(schedule, n_stages: int):
    """Each stage's idle ticks (no op) in a tick table."""
    return [sum(1 for ops in schedule if ops[s] is None)
            for s in range(n_stages)]


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if hasattr(tree, "shape") and hasattr(tree, "dtype"):
        return int(np.prod(tree.shape)) * np.dtype(tree.dtype).itemsize
    return 0


class StagePartition:
    """A contiguous split of an ordered entry list (MLN ``layer_i`` keys,
    graph topo vertex names) into ``n_stages`` stages, greedily balanced
    by parameter bytes (the JAX package's rule, bit for bit)."""

    def __init__(self, entries, boundaries):
        self.entries = list(entries)
        self.boundaries = list(boundaries)
        self.n_stages = len(self.boundaries) - 1

    @classmethod
    def build(cls, entries, params, n_stages: int) -> "StagePartition":
        entries = list(entries)
        s_n = int(n_stages)
        if s_n < 1:
            raise ValueError(f"n_stages must be >= 1, got {s_n}")
        if len(entries) < s_n:
            raise ValueError(
                f"cannot split {len(entries)} layers/vertices into "
                f"{s_n} pipeline stages — need at least one per stage")
        sizes = [float(_tree_bytes((params or {}).get(e, {})))
                 for e in entries]
        if not sum(sizes):
            sizes = [1.0] * len(entries)
        total = sum(sizes)
        bounds, acc = [0], 0.0
        for i, sz in enumerate(sizes):
            if len(bounds) == s_n:
                break
            acc += sz
            left = len(entries) - (i + 1)
            need = s_n - len(bounds)
            if left == need or (acc >= total / s_n and left >= need):
                bounds.append(i + 1)
                acc = 0.0
        bounds.append(len(entries))
        return cls(entries, bounds)

    def stage_entries(self, s: int):
        return self.entries[self.boundaries[s]:self.boundaries[s + 1]]

    def stage_of(self, entry) -> int:
        i = self.entries.index(entry)
        for s in range(self.n_stages):
            if self.boundaries[s] <= i < self.boundaries[s + 1]:
                return s
        raise ValueError(entry)

    def stage_param_bytes(self, params):
        return [sum(_tree_bytes(params.get(e, {}))
                    for e in self.stage_entries(s))
                for s in range(self.n_stages)]


# -- model adapters ---------------------------------------------------------
# The executor is model-agnostic: an adapter gives the ordered entries, a
# stage's forward (the handoff as a list of tensors) and the last stage's
# loss, over one replica's model.

class _MlnStages:
    def __init__(self, model):
        self.model = model
        self.part = None
        self.n_layers = len(model.conf.layers)

    def entries(self):
        return [f"layer_{i}" for i in range(self.n_layers)]

    def finalize(self):
        pass

    def forward(self, s, params, states, h, fmask, rng):
        lo, hi = self.part.boundaries[s], self.part.boundaries[s + 1]
        out, ns = self.model._forward(params, states, h[0], training=True,
                                      rng=rng, want_logits=False,
                                      mask=fmask, start_at=lo, stop_at=hi)
        return [out], ns

    def loss(self, s, params, states, h, labels, lmasks, fmask, rng):
        m = self.model
        out_layer = m.output_layer_conf
        out, ns = m._forward(params, states, h[0], training=True, rng=rng,
                             want_logits=True, mask=fmask,
                             start_at=self.part.boundaries[s])
        loss = out_layer.compute_loss(
            labels[0], out, from_logits=out_layer.wants_logits(),
            mask=lmasks[0] if lmasks is not None else None)
        return loss, ns


class _GraphStages:
    def __init__(self, model):
        self.model = model
        self.part = None
        self.topo = list(model._topo)

    def entries(self):
        return list(self.topo)

    def finalize(self):
        """The handoff sets of each stage boundary: an activation made at
        stage ``p`` and read at stage ``c > p`` (or by the loss) rides
        every boundary between, network inputs read past stage 0
        included. Sorted: the wire order on both sides."""
        conf = self.model.conf
        part = self.part
        s_n = part.n_stages
        slice_of = {}
        for s in range(s_n):
            for nm in part.stage_entries(s):
                slice_of[nm] = s
        for inp in conf.network_inputs:
            slice_of.setdefault(inp, 0)
        need = [set() for _ in range(s_n + 1)]

        def consume(name, s):
            ss = slice_of.get(name)
            if ss is None or ss >= s:
                return
            for t in range(ss + 1, s + 1):
                need[t].add(name)

        for s in range(s_n):
            for nm in part.stage_entries(s):
                for src in conf.vertices[nm].inputs:
                    consume(src, s)
        for out in conf.network_outputs:
            consume(out, s_n - 1)
        self.incoming = [sorted(need[s]) for s in range(s_n)]
        self.outgoing = [sorted(need[s + 1]) for s in range(s_n)]

    def _walk(self, s, params, states, h, fmask, rng, want_logits):
        lo, hi = self.part.boundaries[s], self.part.boundaries[s + 1]
        first = s == 0
        return self.model._forward(
            params, states, h if first else [], training=True, rng=rng,
            want_logits=want_logits, fmask=fmask,
            start_acts=None if first else dict(zip(self.incoming[s], h)),
            topo_slice=(lo, hi))

    def forward(self, s, params, states, h, fmask, rng):
        acts, ns = self._walk(s, params, states, h, fmask, rng, False)
        return [acts[n] for n in self.outgoing[s]], ns

    def loss(self, s, params, states, h, labels, lmasks, fmask, rng):
        from deeplearning4j_tpu_torch.nn.conf.layers import BaseOutputLayer
        conf = self.model.conf
        acts, ns = self._walk(s, params, states, h, fmask, rng, True)
        loss = None
        for i, name in enumerate(conf.network_outputs):
            layer = conf.vertices[name].content
            if not isinstance(layer, BaseOutputLayer):
                continue
            li = layer.compute_loss(
                labels[i], acts[name], from_logits=layer.wants_logits(),
                mask=lmasks[i] if lmasks is not None else None)
            loss = li if loss is None else loss + li
        return loss, ns


def make_stage_adapter(model):
    """The stage adapter of a model: MultiLayerNetwork layer stacks and
    ComputationGraph topologies."""
    if hasattr(model, "_topo"):
        return _GraphStages(model)
    if hasattr(model, "conf") and hasattr(model.conf, "layers"):
        return _MlnStages(model)
    raise ValueError(
        f"pipeline_stages: unsupported model type {type(model).__name__} "
        f"(need MultiLayerNetwork or ComputationGraph)")


class _MicroViews:
    """One replica's rows of each microbatch of a batch: ``inject(m)``
    (the network inputs), ``labels(m)``, ``lmask(m)``, ``fmask(m)``."""

    def __init__(self, batch_size, inputs, labels, lmasks, fmask, n_micro):
        self.batch_size = batch_size
        self._n = n_micro

        def split(t):
            return None if t is None else list(t.chunk(n_micro))

        self._inputs = [split(t) for t in inputs or []]
        self._labels = [split(t) for t in labels or []]
        self._lmasks = ([split(t) for t in lmasks]
                        if lmasks is not None else None)
        self._fmask = split(fmask)

    def inject(self, m):
        return [x[m] for x in self._inputs]

    def labels(self, m):
        return [y[m] for y in self._labels]

    def lmask(self, m):
        if self._lmasks is None:
            return None
        return [x[m] if x is not None else None for x in self._lmasks]

    def fmask(self, m):
        return self._fmask[m] if self._fmask is not None else None


def check_microbatches(b: int, n_micro: int, dp: int) -> int:
    """The microbatch size of a global batch of ``b`` rows, or the JAX
    trainer's errors."""
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible by {n_micro} "
                         f"microbatches")
    mb = b // n_micro
    if dp > 1 and mb % dp:
        raise ValueError(
            f"microbatch of {mb} rows not divisible by {dp} data-parallel "
            f"shards; pick n_micro/batch so that batch/n_micro is a "
            f"multiple of dp")
    return mb


def rows_of(t, n_micro: int, dp: int, d: int):
    """Data index ``d``'s rows of every microbatch of the global batch
    ``t`` (a tensor or an array), microbatch after microbatch."""
    mb = check_microbatches(int(t.shape[0]), n_micro, dp)
    k = mb // dp
    parts = [t[mi * mb + d * k: mi * mb + (d + 1) * k]
             for mi in range(n_micro)]
    if isinstance(t, torch.Tensor):
        return torch.cat(parts)
    return np.concatenate(parts)


class PipelineTrainer:
    """The pipeline fit path over the ``pipe`` axis of ``mesh``.

    ``model`` is the network every rank starts from. On a
    ``ThreadMesh`` rank 0 runs ``model`` itself and every other rank a
    copy of it on its device, each on its own thread; on a
    ``ProcessGroupMesh`` this process runs its one rank on ``model``.
    Each rank binds its model to its data group (``set_dp_mesh``; the
    update tail ``mode``: ``dense``, or ``sharded`` for ZeRO-1 over the
    stage's data group; ``fsdp`` is run as ``sharded``, the parameters of
    a stage staying whole) with its stage's tensor-parallel specs, runs
    its stage's ops of the tick table, and at the end of each
    :meth:`fit_batch` (or :meth:`fit`) every rank's model is dense again
    and holds every stage's parameters, states and updater state.

    ``last_report`` after a step: the JAX trainer's keys (schedule,
    stages, microbatches, bubble fraction and seconds, each stage's busy
    and idle seconds, peak residency in microbatches and bytes, the pipe
    wire bytes forward and backward, each stage's parameter bytes) plus
    ``exchange_seconds`` (each stage's host seconds in the pipe
    handoffs, waiting included) and ``step_seconds``; the byte counts
    are a data rank's (the sum over the stages of one pipe group), the
    seconds those of the ranks of one pipe group."""

    def __init__(self, model, mesh, *, n_micro=None, schedule="1f1b",
                 mode="dense", pipe_axis: str = PIPE_AXIS,
                 data_axis: Optional[str] = None,
                 model_axis: Optional[str] = None):
        if schedule not in SCHEDULES:
            raise ValueError(f"unknown pipeline schedule {schedule!r} "
                             f"(know {SCHEDULES})")
        self.model = model
        self.mesh = mesh
        self.pipe_axis = pipe_axis
        self.data_axis = data_axis or DEFAULT_DATA_AXIS
        self.model_axis = model_axis or DEFAULT_MODEL_AXIS
        shape = dict(mesh.shape)
        self.n_stages = int(shape.get(pipe_axis, 1))
        if self.n_stages < 2:
            raise ValueError(
                f"pipeline training needs a {pipe_axis!r} mesh axis of "
                f">= 2 stages, got {self.n_stages}")
        self.schedule = schedule
        self.n_micro = int(n_micro) if n_micro else 2 * self.n_stages
        if self.n_micro < 1:
            raise ValueError(f"n_micro must be >= 1, got {self.n_micro}")
        mode_s = str(getattr(mode, "value", mode) or "dense").lower()
        if mode_s == "auto":
            mode_s = "sharded"
        if mode_s == "fsdp":
            # a stage's parameters stay whole: per-stage ZeRO-1 already
            # keeps every updater flat inside its stage's data group
            log.info("pipeline x fsdp: downgrading the update tail to "
                     "per-stage ZeRO-1 (updater flats local to each "
                     "stage's pipe group; stage params stay dense)")
            mode_s = "sharded"
        self.mode = mode_s
        self.dp = int(shape.get(self.data_axis, 1))
        self.tp = int(shape.get(self.model_axis, 1))
        self._tail = "sharded" if (mode_s == "sharded" and
                                   self.dp > 1) else "dense"
        if not model._initialized:
            model.init()
        self._sched = build_schedule(self.n_stages, self.n_micro, schedule)
        self.part = None
        self._tp_specs = None
        self._placed = False
        self._bound = False
        self._local = []            # (rank, model) pairs of this process
        self.last_report = None

    # -- placement ------------------------------------------------------
    def place(self):
        """Partition the (dense) model over the stages, infer each
        stage's tensor-parallel specs, and make this process's ranks'
        models."""
        from deeplearning4j_tpu_torch.parallel.speclayout import SpecLayout
        m = self.model
        if m._replica is not None:
            m.set_dp_mesh(None)
        adapter = make_stage_adapter(m)
        self.part = StagePartition.build(adapter.entries(), m.params,
                                         self.n_stages)
        self._stage_param_bytes = self.part.stage_param_bytes(m.params)
        if self.tp > 1:
            layout = SpecLayout(self.mesh, model_axis=self.model_axis,
                                data_axis=self.data_axis,
                                stage_axis=self.pipe_axis)
            self._tp_specs = layout.infer_stages(m.params, self.part,
                                                 shard_over_data=False)
        else:
            self._tp_specs = [{} for _ in range(self.n_stages)]
        if isinstance(self.mesh, ThreadMesh):
            from deeplearning4j_tpu_torch.parallel.wrapper import \
                _clone_replica
            if canonical_device(m.device) != self.mesh.devices[0]:
                raise ValueError(f"the model is on {m.device}, the mesh's "
                                 f"rank 0 on {self.mesh.devices[0]}")
            self._local = [(0, m)] + [
                (r, _clone_replica(m, d))
                for r, d in enumerate(self.mesh.devices[1:], start=1)]
        else:
            self._local = [(self.mesh.local_replicas()[0].rank, m)]
        self._adapters = {r: make_stage_adapter(mr) for r, mr in self._local}
        for ad in self._adapters.values():
            ad.part = self.part
            ad.finalize()
        self._placed = True

    @property
    def adapter(self):
        return self._adapters[self._local[0][0]]

    def stage_of_rank(self, rank: int) -> int:
        return self.mesh.coords(rank)[list(self.mesh.axes).index(
            self.pipe_axis)]

    def _run_local(self, fn):
        """``fn(rank, model)`` on every rank of this process (each on its
        own thread on a thread mesh); the results by rank."""
        if isinstance(self.mesh, ThreadMesh):
            models = dict(self._local)
            return dict(enumerate(self.mesh.run(lambda r: fn(r, models[r]))))
        r, mr = self._local[0]
        return {r: fn(r, mr)}

    def _replica(self, rank: int):
        if isinstance(self.mesh, ThreadMesh):
            return self.mesh.replica(rank)
        return self.mesh.local_replicas()[0]

    def bind(self):
        """Bind every rank's model to its data group with its stage's
        specs (the copies take the wrapped model's state first)."""
        if not self._placed:
            self.place()
        if self._bound:
            return
        from deeplearning4j_tpu_torch.parallel.wrapper import \
            _copy_training_state
        for r, mr in self._local[1:]:
            _copy_training_state(self.model, mr)

        def bind_one(r, mr):
            mr.set_dp_mesh(self._replica(r), self.data_axis,
                           mode=self._tail, model_axis=self.model_axis,
                           tp_specs=self._tp_specs[self.stage_of_rank(r)])
        self._run_local(bind_one)
        self._bound = True

    def unbind(self, ok: bool = True):
        """Every rank's model back to the dense layout, each stage's
        entries (parameters, states, updater state) from the stage that
        trained them: collectives over the data, model and pipe
        groups."""
        if not self._bound:
            return
        self._bound = False
        if not ok:
            for _, mr in self._local:
                mr._replica, mr._dp_mode = None, None
                mr._tp_specs, mr._tp_replica = {}, None
            return

        def unbind_one(r, mr):
            mr.set_dp_mesh(None)
            self._sync_stages(r, mr)
        self._run_local(unbind_one)

    def _sync_stages(self, rank: int, mr) -> None:
        """Each entry from its own stage: one sum over ``pipe`` a dtype,
        every rank giving its stage's entries and zeros elsewhere (names
        in sorted order, so every rank lays the flats out alike)."""
        from deeplearning4j_tpu_torch.learning.updaters import _leaves
        rep = self._replica(rank)
        mine = set(self.part.stage_entries(self.stage_of_rank(rank)))
        for attr in ("params", "states", "updater_states"):
            tree = getattr(mr, attr)
            by_dt = {}
            for k in sorted(tree):
                for t in _leaves(tree[k]):
                    if isinstance(t, torch.Tensor):
                        by_dt.setdefault(t.dtype, []).append((k, t))
            for dt, kts in by_dt.items():
                flat = torch.cat([
                    (t if k in mine else torch.zeros_like(t)).reshape(-1)
                    for k, t in kts])
                flat = rep.axis_collective("psum", flat, self.pipe_axis)
                off = 0
                with torch.no_grad():
                    for k, t in kts:
                        n = t.numel()
                        if k not in mine:
                            t.copy_(flat[off:off + n].view_as(t))
                        off += n

    # -- one step -------------------------------------------------------
    def _rank_views(self, rank: int, mr, ds, local: bool) -> _MicroViews:
        """This rank's rows of each microbatch, from ``ds``: the global
        batch; with ``local`` its data index's shard of it (the shards
        gathered over the data group first); or a list of one DataSet a
        rank of this process, each already that rank's rows
        (:func:`rows_of`). A stage takes only what it reads."""
        rep = self._replica(rank)
        s = self.stage_of_rank(rank)
        dp, d = self.dp, rep.axis_index(self.data_axis)
        first, last = s == 0, s == self.n_stages - 1
        chosen = isinstance(ds, (list, tuple))
        inputs, labels, lmasks, fmask = mr._split(
            ds[rank] if chosen else ds, None)

        def rows(t):
            if t is None:
                return None
            if chosen:
                check_microbatches(int(t.shape[0]) * dp, self.n_micro, dp)
                return t
            if local and dp > 1:
                t = rep.axis_collective("all_gather", t.contiguous(),
                                        self.data_axis, dim=0)
            return rows_of(t, self.n_micro, dp, d) if dp > 1 else \
                (check_microbatches(int(t.shape[0]), self.n_micro, 1)
                 and t)

        b = int(inputs[0].shape[0]) * (dp if (local or chosen) else 1)
        # every stage checks, so none waits for a stage that raised
        check_microbatches(b, self.n_micro, dp)
        return _MicroViews(
            b, [rows(x) for x in inputs] if first else None,
            [rows(y) for y in labels] if last else None,
            ([rows(x) for x in lmasks] if last and lmasks is not None
             else None),
            rows(fmask), self.n_micro)

    def _rank_step(self, rank: int, mr, ds, local: bool) -> dict:
        rep = self._replica(rank)
        s = self.stage_of_rank(rank)
        s_n, m_n = self.n_stages, self.n_micro
        ad = self._adapters[rank]
        views = self._rank_views(rank, mr, ds, local)
        names = self.part.stage_entries(s)
        specs = self._tp_specs[s]
        # the stage's parameters, the tensor-parallel leaves gathered
        # once a step; one leaf tensor each for every microbatch
        full = {k: ({n: (zero.tp_full(t, specs[k][n].compute, rep)
                         if n in specs.get(k, {}) else t)
                     for n, t in mr.params[k].items()})
                for k in names if k in mr.params}
        leaves = {k: {n: t.detach().requires_grad_(True)
                      for n, t in sub.items()} for k, sub in full.items()}
        flat = [(k, n, t) for k, sub in leaves.items()
                for n, t in sub.items()]
        st = {k: mr.states[k] for k in names if k in mr.states}
        key = mr._next_key()
        # one key a microbatch: forward and recompute draw alike
        rngs = [key.fold_in(mi) for mi in range(m_n)]
        scope = mr._replica
        grads = [None] * len(flat)
        h_next, g_next, stash = {}, {}, {}
        live = live_b = peak = peak_b = 0
        ns_keep, losses = None, []
        wire_fwd = wire_bwd = 0
        busy = handoff = 0.0
        t_step = time.perf_counter()

        def as_inputs(h, need):
            return [t.detach().requires_grad_(need and t.is_floating_point())
                    for t in h]

        for ops in self._sched:
            op = ops[s]
            sends = {}
            t0 = time.perf_counter()
            if op is not None and op[0] == "F":
                mi = op[1]
                h_in = views.inject(mi) if s == 0 else h_next.pop(mi)
                stash[mi] = h_in
                live += 1
                live_b += _tree_bytes(h_in)
                peak, peak_b = max(peak, live), max(peak_b, live_b)
                if s < s_n - 1:
                    # the last stage's forward runs inside its backward
                    with torch.no_grad(), replica_scope(scope):
                        out, ns = ad.forward(s, leaves, st, h_in,
                                             views.fmask(mi), rngs[mi])
                    ns_keep = ns
                    sends[s + 1] = [o.detach() for o in out]
                    wire_fwd += _tree_bytes(out)
            elif op is not None:
                mi = op[1]
                h_in = stash.pop(mi)
                live -= 1
                live_b -= _tree_bytes(h_in)
                hh = as_inputs(h_in, s > 0)
                with torch.enable_grad(), replica_scope(scope):
                    if s == s_n - 1:
                        loss, ns = ad.loss(s, leaves, st, hh,
                                           views.labels(mi), views.lmask(mi),
                                           views.fmask(mi), rngs[mi])
                        ns_keep = ns
                        losses.append(loss.detach())
                        outs, gos = [loss], None
                    else:
                        out, _ = ad.forward(s, leaves, st, hh,
                                            views.fmask(mi), rngs[mi])
                        g_out = g_next.pop(mi)
                        pairs = [(o, g) for o, g in zip(out, g_out)
                                 if o.requires_grad]
                        outs = [o for o, _ in pairs]
                        gos = [g for _, g in pairs]
                    want = [t for _, _, t in flat] + \
                        [x for x in hh if x.requires_grad]
                    got = torch.autograd.grad(outs, want, gos,
                                              allow_unused=True) \
                        if outs else [None] * len(want)
                for i in range(len(flat)):
                    g = got[i]
                    if g is not None:
                        grads[i] = g if grads[i] is None else grads[i] + g
                if s > 0:
                    gh, j = [], len(flat)
                    for x in hh:
                        if x.requires_grad:
                            g = got[j]
                            j += 1
                        else:
                            g = None
                        gh.append(torch.zeros_like(x) if g is None else g)
                    sends[s - 1] = gh
                    wire_bwd += _tree_bytes(gh)
            if op is not None:
                if scope.device.type == "cuda":
                    torch.cuda.current_stream(scope.device).synchronize()
                busy += time.perf_counter() - t0
            recv = []
            if s > 0 and ops[s - 1] is not None and ops[s - 1][0] == "F":
                recv.append(s - 1)
            if s < s_n - 1 and ops[s + 1] is not None and \
                    ops[s + 1][0] == "B":
                recv.append(s + 1)
            t0 = time.perf_counter()
            got_msgs = rep.exchange(self.pipe_axis, sends, recv)
            handoff += time.perf_counter() - t0
            if s - 1 in got_msgs:
                h_next[ops[s - 1][1]] = got_msgs[s - 1]
            if s + 1 in got_msgs:
                g_next[ops[s + 1][1]] = got_msgs[s + 1]
        wall = time.perf_counter() - t_step
        # one update a step per stage: the sum over microbatches / M,
        # the stage's regularization, then the model's own tail
        t0 = time.perf_counter()
        scale = 1.0 / m_n
        with torch.enable_grad():
            reg = mr._regularization(leaves)
            rg = (torch.autograd.grad(reg, [t for _, _, t in flat],
                                      allow_unused=True)
                  if isinstance(reg, torch.Tensor) and reg.requires_grad
                  else [None] * len(flat))
        g_tree = {}
        for (k, n, t), g, r in zip(flat, grads, rg):
            g = torch.zeros_like(t) if g is None else g * scale
            if r is not None:
                g = g + r
            if n in specs.get(k, {}):
                g = zero.tp_grad_slice(g, specs[k][n].compute, rep,
                                       self.data_axis)
            g_tree.setdefault(k, {})[n] = g.detach()
        it = mr.iteration_count
        with torch.no_grad():
            mr._update_tail(g_tree, it)
        if ns_keep is not None:
            mr._keep_states(ns_keep)
        busy += time.perf_counter() - t0
        reg_val = float(reg)
        data_loss = (sum(float(l) for l in losses) / m_n
                     if s == s_n - 1 else 0.0)
        # per-stage numbers to every rank of the pipe group
        vec = torch.zeros(5 * s_n + 3, dtype=torch.float64, device=mr.device)
        vec[s] = busy
        vec[s_n + s] = max(wall + (time.perf_counter() - t0) - busy, 0.0)
        vec[2 * s_n + s] = peak
        vec[3 * s_n + s] = peak_b
        vec[4 * s_n + s] = handoff
        vec[5 * s_n] = wire_fwd
        vec[5 * s_n + 1] = wire_bwd
        vec[5 * s_n + 2] = data_loss + reg_val
        vec = rep.axis_collective("psum", vec, self.pipe_axis)
        # the loss of the whole batch: the data group's mean
        loss = mr._mean_loss(vec[5 * s_n + 2].clone())
        mr._score = loss.to(torch.float32)
        vec = vec.cpu()
        mr.iteration_count += 1
        mr.last_batch_size = views.batch_size
        return {"vec": vec, "loss": float(loss)}

    def _report(self, vec: torch.Tensor, step_s: float) -> dict:
        s_n, m_n = self.n_stages, self.n_micro
        v = vec.tolist()
        busy, idle = v[:s_n], v[s_n:2 * s_n]
        fwd, bwd = int(v[5 * s_n]), int(v[5 * s_n + 1])
        return {
            "schedule": self.schedule,
            "n_stages": s_n,
            "n_micro": m_n,
            "bubble_fraction": bubble_fraction(s_n, m_n),
            "bubble_seconds": sum(idle),
            "stage_busy_seconds": busy,
            "stage_idle_seconds": idle,
            "peak_residency_microbatches": [int(x) for x in
                                            v[2 * s_n:3 * s_n]],
            "peak_residency_bytes": [int(x) for x in v[3 * s_n:4 * s_n]],
            "pipe_wire_fwd_bytes": fwd,
            "pipe_wire_bwd_bytes": bwd,
            "pipe_wire_bytes": fwd + bwd,
            "exchange_seconds": v[4 * s_n:5 * s_n],
            "stage_param_bytes": list(self._stage_param_bytes),
            "step_seconds": step_s,
        }

    def _observe_step(self, mr, report: dict, loss: float, span) -> None:
        from deeplearning4j_tpu_torch.common import (diagnostics, stepstats,
                                                     telemetry)
        stepstats.collector().note_in_step("pipeline",
                                           report["bubble_seconds"])
        if telemetry.enabled():
            telemetry.histogram(
                "dl4j_pipeline_bubble_seconds",
                "measured per-step pipeline bubble (sum of stage idle time "
                "while peers compute)").observe(
                report["bubble_seconds"], schedule=self.schedule,
                stages=str(self.n_stages))
            h = telemetry.histogram(
                "dl4j_pipeline_stage_seconds",
                "per-stage busy seconds inside one pipeline step")
            for s in range(self.n_stages):
                h.observe(report["stage_busy_seconds"][s], stage=str(s))
        diagnostics.record_step(mr, type(mr).__name__,
                                mr.iteration_count - 1, mr._score, span)

    def step(self, ds, local: bool = False) -> float:
        """One training step on ``ds`` with the ranks bound (see
        :meth:`fit_batch`); returns the loss."""
        from deeplearning4j_tpu_torch.common import telemetry
        if not self._bound:
            raise RuntimeError("PipelineTrainer.step needs bind() first")
        obs = [mr for _, mr in self._local if mr._observe]
        t0 = time.perf_counter()
        with telemetry.step_span(type(self.model).__name__) as sp:
            res = self._run_local(lambda r, mr: self._rank_step(
                r, mr, ds, local))
            step_s = time.perf_counter() - t0
            first = res[min(res)]
            report = self._report(first["vec"], step_s)
            self.last_report = report
            for mr in obs:
                self._observe_step(mr, report, first["loss"], sp)
        for mr in obs:
            for lis in mr.listeners:
                lis.iteration_done(mr, mr.iteration_count - 1,
                                   mr.epoch_count)
        return first["loss"]

    def fit_batch(self, ds, local: bool = False) -> float:
        """One training step over ``ds``: the global batch, or with
        ``local`` this process's data index's shard of it (the ranks of
        a data group then gather their shards). Binds the ranks, runs the
        tick table, and leaves every rank's model dense with the whole
        network's new parameters, states and updater state."""
        self.bind()
        ok = False
        try:
            loss = self.step(ds, local)
            ok = True
        finally:
            self.unbind(ok)
        return loss

    def fit(self, iterator, *, n_epochs: int = 1, local: bool = False):
        """Every batch of ``iterator`` for ``n_epochs``, bound once;
        the epoch counters and listeners as ``fit`` runs them."""
        self.bind()
        ok = False
        obs = [mr for _, mr in self._local if mr._observe]
        try:
            for _ in range(n_epochs):
                if hasattr(iterator, "reset"):
                    iterator.reset()
                for mr in obs:
                    for lis in mr.listeners:
                        lis.on_epoch_start(mr)
                for ds in iterator:
                    self.step(ds, local)
                for _, mr in self._local:
                    mr.epoch_count += 1
                for mr in obs:
                    for lis in mr.listeners:
                        lis.on_epoch_end(mr)
            ok = True
        finally:
            self.unbind(ok)
        return self.model
