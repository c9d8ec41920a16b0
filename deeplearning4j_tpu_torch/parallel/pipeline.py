"""Pipeline parallelism: the GPipe microbatch engine over the ``pipe``
axis.

Counterpart of the scan engine of ``deeplearning4j_tpu/parallel/
pipeline.py`` (``pipeline_apply`` / ``pipeline_loss``). The JAX package
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

The 1F1B fit path (``SCHEDULES``, ``build_schedule``, ``StagePartition``,
``PipelineTrainer``) is not ported yet (ROADMAP item 12).
"""
from __future__ import annotations

from typing import Callable

import torch

from deeplearning4j_tpu_torch.parallel.mesh import (axis_index, axis_size,
                                                    current_replica, psum,
                                                    replica_scope)

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
