"""Data-parallel meshes: ordered replicas and the collectives between
them.

Counterpart of ``deeplearning4j_tpu/parallel/mesh.py``. The JAX package
binds parallelism to a ``jax.sharding.Mesh`` and lets GSPMD insert the
collectives into one global program. PyTorch runs eagerly, so here a
mesh is an ordered list of replicas (rank 0 first), one device each,
and the few collectives the update exchange and cross-replica
BatchNormalization need: ``all_reduce_sum``, ``reduce_scatter`` (sum,
then this rank's equal slice), ``all_gather`` (concatenation in rank
order) and ``broadcast``. A model replica calls them through its
:class:`Replica` handle.

Two back ends:

- :class:`ThreadMesh`: one process, one thread a replica (DL4J's own
  ``ParallelWrapper`` ran trainer threads). ``ParallelWrapper`` and the
  CPU tests use it, with N CPU replicas in place of the JAX package's
  virtual devices. The collectives meet at a ``threading.Barrier`` with a
  timeout and sum in rank order, so every replica computes the same
  bits and a run is repeatable. Two replicas may not share a CUDA
  device: autograd runs a device's backward on one engine thread, and
  two replicas waiting for each other there would deadlock.
- :class:`ProcessGroupMesh`: one process a replica over
  ``torch.distributed`` (NCCL across cards, gloo on the CPU; gloo with a
  CUDA tensor stages it through the host). ``SharedTrainingMaster``
  uses it. Every group is made with a timeout.

Only the ``data`` axis is ported: an axis other than ``data`` of size
above 1 (tensor, sequence, pipeline parallelism) raises
``NotImplementedError`` naming ROADMAP item 12.

During a replica's training step :func:`replica_scope` makes its handle
the thread's current replica (:func:`current_replica`), which
BatchNormalization reads to take its batch statistics over the global
batch (``ops/bn_train.py``); an autograd Function that calls a
collective in its backward keeps the handle it saw in the forward, since
the backward may run on another thread.
"""
from __future__ import annotations

import copy
import datetime
import threading
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

DEFAULT_DATA_AXIS = "data"
DEFAULT_MODEL_AXIS = "model"
DEFAULT_SEQ_AXIS = "seq"
DEFAULT_STAGE_AXIS = "stage"
#: seconds a collective waits for the other replicas before it fails
DEFAULT_TIMEOUT_S = 300.0

_Device = Union[str, torch.device]

#: every batch-dim array attribute a DataSet/MultiDataSet can carry
#: (singular = DataSet, plural = MultiDataSet)
DATASET_ARRAY_ATTRS = ("features", "labels", "features_mask",
                       "labels_mask", "features_masks", "labels_masks")


def canonical_device(device: _Device) -> torch.device:
    """``device`` with a CUDA index (the current card when it has
    none), so two names of one card compare equal."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def map_dataset_arrays(ds, fn):
    """Shallow-copy ``ds`` with ``fn`` applied to every array attribute
    (lists mapped elementwise, None passed through)."""
    out = copy.copy(ds)
    for attr in DATASET_ARRAY_ATTRS:
        v = getattr(ds, attr, None)
        if v is None:
            continue
        if isinstance(v, (list, tuple)):
            setattr(out, attr, [fn(x) if x is not None else None
                                for x in v])
        else:
            setattr(out, attr, fn(v))
    return out


def pad_batch_to_multiple(x, n: int):
    """Pad the leading axis up to a multiple of ``n`` by repeating the
    final example; returns ``(padded, original_size)``. Training callers
    trim instead (padding would bias the gradients); inference callers
    pad, then slice the output back."""
    b = int(x.shape[0])
    rem = b % n
    if rem == 0:
        return x, b
    if isinstance(x, torch.Tensor):
        reps = x[-1:].expand(n - rem, *x.shape[1:])
        return torch.cat([x, reps]), b
    x = np.asarray(x)
    return np.concatenate([x, np.repeat(x[-1:], n - rem, axis=0)]), b


# ---------------------------------------------------------------------------
class Replica:
    """One replica's view of a mesh: its rank, its device, and the
    collectives it takes part in."""

    def __init__(self, mesh: "DpMesh", rank: int, device: torch.device):
        self.mesh = mesh
        self.rank = rank
        self.device = device

    @property
    def size(self) -> int:
        return self.mesh.size

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        return self.mesh._all_reduce_sum(self.rank, t)

    def reduce_scatter(self, flat: torch.Tensor) -> torch.Tensor:
        """The sum over replicas of ``flat`` (its length a multiple of
        the mesh size), this rank's slice."""
        return self.mesh._reduce_scatter(self.rank, flat)

    def all_gather(self, shard: torch.Tensor) -> torch.Tensor:
        return self.mesh._all_gather(self.rank, shard)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        return self.mesh._broadcast(self.rank, t, src)

    def __repr__(self) -> str:
        return (f"Replica(rank={self.rank}/{self.size}, "
                f"device={self.device}, {type(self.mesh).__name__})")


class DpMesh:
    """An ordered list of replicas (rank 0 first) over the ``data``
    axis. ``shape`` is ``{"data": size}``, as the JAX mesh's."""

    size: int

    @property
    def shape(self) -> Dict[str, int]:
        return {DEFAULT_DATA_AXIS: self.size}

    def local_replicas(self) -> List[Replica]:
        raise NotImplementedError


class ThreadMesh(DpMesh):
    """N replicas in this process, one thread each (see the module
    docstring); ``devices`` lists each rank's device."""

    def __init__(self, devices: Sequence[_Device],
                 timeout_s: float = DEFAULT_TIMEOUT_S):
        self.devices = [canonical_device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        cuda = [d for d in self.devices if d.type == "cuda"]
        if len(set(cuda)) != len(cuda):
            raise ValueError(
                f"two replicas of a thread mesh on one CUDA device "
                f"({self.devices}): autograd runs a device's backward on "
                f"one thread, so their collectives would deadlock; give "
                f"each replica its own card, or use a process group")
        self.size = len(self.devices)
        self.timeout_s = float(timeout_s)
        self._barrier = threading.Barrier(self.size, timeout=self.timeout_s)
        self._slots: List = [None] * self.size

    def replica(self, rank: int) -> Replica:
        return Replica(self, rank, self.devices[rank])

    def local_replicas(self) -> List[Replica]:
        return [self.replica(r) for r in range(self.size)]

    # -- running the replicas ----------------------------------------------
    def run(self, fn: Callable[[int], object]) -> list:
        """``fn(rank)`` for every rank at once: rank 0 on the calling
        thread, the others on threads of their own; returns the results
        in rank order. A failure in any rank breaks the barrier (the
        others fail at their next collective instead of waiting out the
        timeout) and is raised here."""
        if self._barrier.broken:
            self._barrier.reset()
        results: list = [None] * self.size
        errors: list = [None] * self.size

        def body(rank: int):
            try:
                results[rank] = fn(rank)
            except BaseException as e:   # noqa: BLE001 — raised below
                errors[rank] = e
                self._barrier.abort()

        threads = [threading.Thread(target=body, args=(r,), daemon=True,
                                    name=f"dl4j-torch-replica-{r}")
                   for r in range(1, self.size)]
        for t in threads:
            t.start()
        body(0)
        for t in threads:
            t.join(self.timeout_s)
        stuck = [t.name for t in threads if t.is_alive()]
        if stuck:
            self._barrier.abort()
            raise RuntimeError(f"replica threads {stuck} did not finish "
                               f"within {self.timeout_s} s")
        # the first failure, not the broken barriers it caused
        first = next((e for e in errors if e is not None and not isinstance(
            e, threading.BrokenBarrierError)), None) or next(
            (e for e in errors if e is not None), None)
        if first is not None:
            raise first
        return results

    # -- collectives -----------------------------------------------------
    def _wait(self):
        try:
            self._barrier.wait()
        except threading.BrokenBarrierError:
            raise threading.BrokenBarrierError(
                f"a replica of the {self.size}-thread mesh failed or did "
                f"not reach the collective within {self.timeout_s} s"
            ) from None

    def _exchange(self, rank: int, t: torch.Tensor) -> list:
        if self.size == 1:
            return [t]
        if t.device.type == "cuda":
            # the other replicas read t from their own streams
            torch.cuda.current_stream(t.device).synchronize()
        self._slots[rank] = t
        self._wait()
        vals = list(self._slots)
        # nobody overwrites a slot before every rank has read it
        self._wait()
        return vals

    def _all_reduce_sum(self, rank, t):
        vals = self._exchange(rank, t)
        out = vals[0].to(t.device, copy=True)
        for v in vals[1:]:
            out.add_(v.to(t.device))
        return out

    def _reduce_scatter(self, rank, flat):
        vals = self._exchange(rank, flat)
        n = flat.numel() // self.size
        sl = slice(rank * n, (rank + 1) * n)
        out = vals[0][sl].to(flat.device, copy=True)
        for v in vals[1:]:
            out.add_(v[sl].to(flat.device))
        return out

    def _all_gather(self, rank, shard):
        vals = self._exchange(rank, shard)
        return torch.cat([v.to(shard.device) for v in vals])

    def _broadcast(self, rank, t, src):
        vals = self._exchange(rank, t)
        return vals[src].to(t.device, copy=True)


class ProcessGroupMesh(DpMesh):
    """One replica a process over ``torch.distributed``: ``backend``
    ``"nccl"`` or ``"gloo"``, rendezvous at ``init_method``
    (``tcp://host:port`` or ``file://path``), this process at ``rank`` of
    ``world_size`` on ``device``. Every collective of the group times
    out after ``timeout_s``."""

    def __init__(self, init_method: str, world_size: int, rank: int, *,
                 device: _Device, backend: Optional[str] = None,
                 timeout_s: float = DEFAULT_TIMEOUT_S):
        import torch.distributed as dist
        device = canonical_device(device)
        backend = backend or ("nccl" if device.type == "cuda" else "gloo")
        if backend == "nccl" and device.type != "cuda":
            raise ValueError("the nccl back end needs a CUDA device")
        if device.type == "cuda":
            torch.cuda.set_device(device)
        self.backend = backend
        self.device = device
        self.size = int(world_size)
        self.rank = int(rank)
        self.timeout_s = float(timeout_s)
        if dist.is_initialized():
            raise RuntimeError("torch.distributed is already initialised "
                               "in this process")
        dist.init_process_group(
            backend, init_method=init_method, world_size=self.size,
            rank=self.rank,
            timeout=datetime.timedelta(seconds=self.timeout_s))
        # gloo has no CUDA reduce-scatter or all-gather: it stages
        self._stage = backend == "gloo" and device.type == "cuda"

    def local_replicas(self) -> List[Replica]:
        return [Replica(self, self.rank, self.device)]

    def shutdown(self) -> None:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()

    def _run(self, t: torch.Tensor, op) -> torch.Tensor:
        src = t.cpu() if self._stage else t
        out = op(src.contiguous())
        return out.to(t.device) if self._stage else out

    def _all_reduce_sum(self, rank, t):
        import torch.distributed as dist

        def op(x):
            x = x.clone()
            dist.all_reduce(x)
            return x
        return self._run(t, op)

    def _reduce_scatter(self, rank, flat):
        import torch.distributed as dist

        # the name torch gave it last, where this torch has it
        fn = getattr(dist, "reduce_scatter_single", None) or \
            dist.reduce_scatter_tensor

        def op(x):
            out = x.new_empty(x.numel() // self.size)
            fn(out, x)
            return out
        return self._run(flat, op)

    def _all_gather(self, rank, shard):
        import torch.distributed as dist

        fn = getattr(dist, "all_gather_single", None) or \
            dist.all_gather_into_tensor

        def op(x):
            out = x.new_empty(x.numel() * self.size)
            fn(out, x)
            return out
        return self._run(shard, op)

    def _broadcast(self, rank, t, src):
        import torch.distributed as dist

        def op(x):
            x = x.clone()
            dist.broadcast(x, src)
            return x
        return self._run(t, op)


# ---------------------------------------------------------------------------
def cuda_devices() -> List[torch.device]:
    """Every card of this process, or an error saying how to ask for
    CPU replicas."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "no CUDA device is available: a mesh spans the cards by "
            "default; pass devices=['cpu'] * n for CPU replicas")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(axes: Optional[Dict[str, int]] = None,
              devices: Optional[Sequence[_Device]] = None, *,
              timeout_s: float = DEFAULT_TIMEOUT_S) -> ThreadMesh:
    """A thread mesh. ``axes`` maps axis name -> size; a single ``-1``
    entry absorbs the remaining devices. Default: every card on the
    ``data`` axis."""
    devices = list(devices) if devices is not None else cuda_devices()
    if axes is None:
        axes = {DEFAULT_DATA_AXIS: len(devices)}
    sizes = list(axes.values())
    n = len(devices)
    if sizes.count(-1) > 1:
        raise ValueError("at most one axis may be -1")
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        if n % known:
            raise ValueError(f"{n} devices not divisible by {known}")
        sizes[sizes.index(-1)] = n // known
    resolved = dict(zip(axes, sizes))
    if int(np.prod(sizes)) != n:
        raise ValueError(f"mesh {resolved} needs {int(np.prod(sizes))} "
                         f"devices, have {n}")
    other = {k: s for k, s in resolved.items()
             if k != DEFAULT_DATA_AXIS and s > 1}
    if other:
        raise NotImplementedError(
            f"mesh axes {other}: only the data axis is ported (tensor, "
            f"sequence and pipeline parallelism are ROADMAP item 12)")
    return ThreadMesh(devices, timeout_s=timeout_s)


class MeshFactory:
    """Named mesh presets (the JAX package's ``MeshFactory``)."""

    @staticmethod
    def data_parallel(n: Optional[int] = None, devices=None) -> ThreadMesh:
        devs = list(devices) if devices is not None else cuda_devices()
        devs = devs[:n] if n else devs
        return make_mesh({DEFAULT_DATA_AXIS: len(devs)}, devs)

    @staticmethod
    def data_model(data: int = -1, model: int = 1,
                   devices=None) -> ThreadMesh:
        return make_mesh({DEFAULT_DATA_AXIS: data,
                          DEFAULT_MODEL_AXIS: model}, devices)

    @staticmethod
    def full(data: int = -1, model: int = 1, seq: int = 1, stage: int = 1,
             devices=None) -> ThreadMesh:
        return make_mesh({DEFAULT_DATA_AXIS: data,
                          DEFAULT_MODEL_AXIS: model,
                          DEFAULT_SEQ_AXIS: seq,
                          DEFAULT_STAGE_AXIS: stage}, devices)


# ---------------------------------------------------------------------------
_local = threading.local()


def current_replica() -> Optional[Replica]:
    """The replica whose training step runs on this thread, if any."""
    return getattr(_local, "replica", None)


@contextmanager
def replica_scope(replica: Optional[Replica]):
    prev = current_replica()
    _local.replica = replica
    try:
        yield
    finally:
        _local.replica = prev


class _AllReduceSum(torch.autograd.Function):
    """The sum over replicas, differentiable: the cotangent of a sum
    that every replica reads is the sum of their cotangents."""

    @staticmethod
    def forward(ctx, t, replica):
        ctx.replica = replica
        return replica.all_reduce_sum(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.replica.all_reduce_sum(g.contiguous()), None


def all_reduce_sum(t: torch.Tensor, replica: Replica) -> torch.Tensor:
    """``replica.all_reduce_sum(t)`` under autograd."""
    return _AllReduceSum.apply(t, replica)
