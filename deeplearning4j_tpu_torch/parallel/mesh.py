"""Meshes of ordered replicas with named axes, and the collectives
between them.

Counterpart of ``deeplearning4j_tpu/parallel/mesh.py``. The JAX package
binds parallelism to a ``jax.sharding.Mesh`` and lets GSPMD (or
``shard_map``'s manual collectives) stitch one global program together.
PyTorch runs eagerly, so here a mesh is an ordered list of replicas (rank
0 first), one device each, laid out row-major over named axes in the
order the JAX ``make_mesh`` uses (``{"data": 2, "pipe": 2, "model": 2}``:
rank = (data * 2 + pipe) * 2 + model). A replica knows its
:meth:`Replica.axis_index` and :meth:`Replica.axis_size`.

Two families of collectives:

- over the whole mesh (the data-parallel paths: the update exchange and
  cross-replica BatchNormalization): ``all_reduce_sum``,
  ``reduce_scatter`` (sum, then this rank's equal slice), ``all_gather``
  (concatenation in rank order) and ``broadcast``, through the
  :class:`Replica` handle;
- over one axis's group (the ranks that share every other coordinate),
  as ``jax.lax``'s are inside ``shard_map``: :func:`psum`, :func:`pmax`,
  :func:`pmean`, :func:`psum_scatter` and :func:`all_gather` (tiled),
  :func:`ppermute`, :func:`all_to_all` (tiled). They read the thread's
  :func:`current_replica`, are differentiable, and each one's backward is
  its linear transpose over the stacked per-rank values (psum against
  psum, all_gather against psum_scatter, ppermute against the inverse
  ppermute, all_to_all against the inverse all_to_all): the rule of the
  JAX package's ``shard_map`` without replication typing. A program that
  seeds its replicated loss with 1/N on each of N ranks then gets, on
  each rank, gradients whose sum over the axes a leaf is replicated on is
  the true gradient (``models/transformer.py``). Outside a replica every
  axis has size 1 and the collectives are the identity.

Two back ends:

- :class:`ThreadMesh`: one process, one thread a replica (DL4J's own
  ``ParallelWrapper`` ran trainer threads). ``ParallelWrapper`` and the
  CPU tests use it, with N CPU replicas in place of the JAX package's
  virtual devices. Both families meet at a ``threading.Barrier`` (one
  for the mesh, one for each axis group smaller than the mesh) with a
  timeout and sum in rank order, so every replica computes the same bits
  and a run is repeatable. Two replicas may not share a CUDA device: autograd runs a
  device's backward on one engine thread, and two replicas waiting for
  each other there would deadlock.
- :class:`ProcessGroupMesh`: one process a replica over
  ``torch.distributed`` (NCCL across cards, gloo on the CPU; gloo with a
  CUDA tensor stages it through the host), with one
  ``torch.distributed.new_group`` per axis slice smaller than the world,
  made by every process in the same order (an axis that spans the world
  uses the default group). ``SharedTrainingMaster`` uses it. Every group
  is made with a timeout.

:class:`PartitionSpec` and :func:`shard_tree` / :func:`gather_tree` are
the small counterpart of ``shard_map``'s slicing: a global tree cut into
a rank's shards by its specs, and the shards put back together.

During a replica's step :func:`replica_scope` makes its handle the
thread's current replica (:func:`current_replica`), which
BatchNormalization and the axis collectives read; an autograd Function
that calls a collective in its backward keeps the handle it saw in the
forward, since the backward may run on another thread.
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

    # -- named axes --------------------------------------------------------
    def axis_size(self, axis: str) -> int:
        return self.mesh.axis_size(axis)

    def axis_index(self, axis: str) -> int:
        return self.mesh.coords(self.rank)[self.mesh._axis(axis)]

    def axis_collective(self, op: str, t: torch.Tensor, axis: str,
                        **kw) -> torch.Tensor:
        """One collective over ``axis``'s group, not differentiable (the
        module-level functions wrap it): ``op`` one of ``psum``,
        ``pmax``, ``all_gather`` (``dim``), ``psum_scatter`` (``dim``),
        ``ppermute`` (``perm``: (source, destination) axis indices) and
        ``all_to_all`` (``split``, ``concat``)."""
        if self.mesh.axis_size(axis) == 1:
            return _single(op, t, **kw)
        return self.mesh._axis_op(self.rank, op, t, axis, **kw)

    def __repr__(self) -> str:
        return (f"Replica(rank={self.rank}/{self.size}, "
                f"device={self.device}, {type(self.mesh).__name__})")


def _single(op: str, t: torch.Tensor, perm=None, **kw) -> torch.Tensor:
    """A collective over a group of one."""
    if op == "ppermute" and not any(s == d == 0 for s, d in perm):
        return torch.zeros_like(t)
    return t.clone()


def _resolve_axes(axes: Optional[Dict[str, int]], n: int
                  ) -> Dict[str, int]:
    """``axes`` with a single ``-1`` entry resolved to absorb the rest of
    ``n``; the sizes' product must be ``n``."""
    if axes is None:
        return {DEFAULT_DATA_AXIS: n}
    sizes = [int(s) for s in axes.values()]
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
    return resolved


class DpMesh:
    """An ordered list of replicas (rank 0 first), laid out row-major
    over named axes. ``shape`` maps each axis to its size, as the JAX
    mesh's ``{name: size}``; a mesh made without axes has the one axis
    ``{"data": size}``."""

    size: int
    axes: Dict[str, int]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(self.axes)

    def local_replicas(self) -> List[Replica]:
        raise NotImplementedError

    def _init_axes(self, axes: Optional[Dict[str, int]]) -> None:
        self.axes = _resolve_axes(axes, self.size)
        self._sizes = tuple(self.axes.values())

    def _axis(self, axis: str) -> int:
        try:
            return list(self.axes).index(axis)
        except ValueError:
            raise ValueError(f"mesh {self.axes} has no axis {axis!r}"
                             ) from None

    def axis_size(self, axis: str) -> int:
        return self._sizes[self._axis(axis)]

    def coords(self, rank: int) -> tuple:
        """``rank``'s index on each axis (row-major)."""
        return tuple(int(c) for c in np.unravel_index(rank, self._sizes))

    def axis_groups(self, axis: str) -> List[List[int]]:
        """The groups of ``axis``: each the ranks that share every other
        coordinate, in axis-index order, the groups ordered by their
        first rank."""
        a = self._axis(axis)
        groups: Dict[tuple, List[int]] = {}
        for r in range(self.size):
            c = list(self.coords(r))
            c[a] = 0
            groups.setdefault(tuple(c), []).append(r)
        return sorted(groups.values())

    def data_axis_only(self, what: str) -> None:
        """Raise for an axis other than ``data`` of size above 1: the
        data-parallel paths run over the whole mesh."""
        other = {k: v for k, v in self.axes.items()
                 if k != DEFAULT_DATA_AXIS and v > 1}
        if other:
            raise NotImplementedError(
                f"{what} on mesh axes {other}: the data-parallel paths "
                f"take the data axis only (their tensor and pipeline "
                f"parallelism, speclayout.py, the 1F1B PipelineTrainer and "
                f"zero.py's tensor-parallel branches, are ROADMAP item 12)")


def _local_axis_op(op: str, vals: list, i: int, t: torch.Tensor, dim=0,
                   perm=None, split=0, concat=0, src=0) -> torch.Tensor:
    """A collective computed from every group member's tensor ``vals``
    (in axis order), for member ``i``; sums and maxima in that order."""
    dev = t.device
    if op in ("psum", "pmax"):
        out = vals[0].to(dev, copy=True)
        for v in vals[1:]:
            if op == "psum":
                out.add_(v.to(dev))
            else:
                torch.maximum(out, v.to(dev), out=out)
        return out
    if op == "all_gather":
        return torch.cat([v.to(dev) for v in vals], dim)
    if op == "psum_scatter":
        n = len(vals)
        out = vals[0].chunk(n, dim)[i].to(dev, copy=True)
        for v in vals[1:]:
            out.add_(v.chunk(n, dim)[i].to(dev))
        return out.contiguous()
    if op == "ppermute":
        src = [s for s, d in perm if d == i]
        return (vals[src[0]].to(dev, copy=True) if src
                else torch.zeros_like(t))
    if op == "all_to_all":
        n = len(vals)
        return torch.cat([v.to(dev).chunk(n, split)[i] for v in vals],
                         concat).contiguous()
    if op == "broadcast":
        return vals[src].to(dev, copy=True)
    raise ValueError(f"unknown collective {op!r}")


class _GroupSync:
    """The barrier and slots of one axis group of a thread mesh."""

    def __init__(self, ranks: List[int], timeout_s: float):
        self.ranks = ranks
        self.barrier = threading.Barrier(len(ranks), timeout=timeout_s)
        self.slots: list = [None] * len(ranks)


class ThreadMesh(DpMesh):
    """N replicas in this process, one thread each (see the module
    docstring); ``devices`` lists each rank's device, ``axes`` their
    row-major layout (default: all on ``data``)."""

    def __init__(self, devices: Sequence[_Device],
                 timeout_s: float = DEFAULT_TIMEOUT_S,
                 axes: Optional[Dict[str, int]] = None):
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
        self._init_axes(axes)
        # one barrier and slot list for the whole mesh and one for each
        # group of each axis; an axis that spans the mesh shares the
        # whole mesh's
        whole = _GroupSync(list(range(self.size)), self.timeout_s)
        self._whole = {r: (whole, r) for r in range(self.size)}
        self._groups: Dict[str, Dict[int, tuple]] = {}
        for a in self.axes:
            n = self.axis_size(a)
            if n == self.size:
                self._groups[a] = self._whole
            elif n > 1:
                self._groups[a] = {}
                for g in self.axis_groups(a):
                    sync = _GroupSync(g, self.timeout_s)
                    for i, r in enumerate(g):
                        self._groups[a][r] = (sync, i)

    def _all_barriers(self) -> list:
        syncs = {id(s): s for grp in [self._whole, *self._groups.values()]
                 for s, _ in grp.values()}
        return [s.barrier for s in syncs.values()]

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
        for b in self._all_barriers():
            if b.broken:
                b.reset()
        results: list = [None] * self.size
        errors: list = [None] * self.size

        def body(rank: int):
            try:
                results[rank] = fn(rank)
            except BaseException as e:   # noqa: BLE001 — raised below
                errors[rank] = e
                for b in self._all_barriers():
                    b.abort()

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
            for b in self._all_barriers():
                b.abort()
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
    def _wait(self, barrier):
        try:
            barrier.wait()
        except threading.BrokenBarrierError:
            raise threading.BrokenBarrierError(
                f"a replica of the {self.size}-thread mesh failed or did "
                f"not reach the collective within {self.timeout_s} s"
            ) from None

    def _collect(self, rank, op, t, group, **kw):
        """``op`` over the group of ``rank`` in ``group`` (rank -> (sync,
        index)): every member posts its tensor, each computes its result
        from all of them in axis order, and nobody moves on before every
        member has read the others'."""
        sync, i = group[rank]
        if len(sync.ranks) == 1:
            return _local_axis_op(op, [t], 0, t, **kw)
        if t.device.type == "cuda":
            # the other replicas read t from their own streams
            torch.cuda.current_stream(t.device).synchronize()
        sync.slots[i] = t
        self._wait(sync.barrier)
        out = _local_axis_op(op, list(sync.slots), i, t, **kw)
        if out.device.type == "cuda":
            # the others' tensors are read before their owners move on
            torch.cuda.current_stream(out.device).synchronize()
        # nobody overwrites a slot before every member has read it
        self._wait(sync.barrier)
        return out

    def _axis_op(self, rank, op, t, axis, **kw):
        return self._collect(rank, op, t, self._groups[axis], **kw)

    def _all_reduce_sum(self, rank, t):
        return self._collect(rank, "psum", t, self._whole)

    def _reduce_scatter(self, rank, flat):
        return self._collect(rank, "psum_scatter", flat, self._whole)

    def _all_gather(self, rank, shard):
        return self._collect(rank, "all_gather", shard, self._whole)

    def _broadcast(self, rank, t, src):
        return self._collect(rank, "broadcast", t, self._whole, src=src)


class ProcessGroupMesh(DpMesh):
    """One replica a process over ``torch.distributed``: ``backend``
    ``"nccl"`` or ``"gloo"``, rendezvous at ``init_method``
    (``tcp://host:port`` or ``file://path``), this process at ``rank`` of
    ``world_size`` on ``device``. Every collective of the group times
    out after ``timeout_s``. ``axes`` lays the world out as
    :class:`ThreadMesh`'s (default: all on ``data``); :meth:`with_axes`
    gives another layout over the same world."""

    def __init__(self, init_method: str, world_size: int, rank: int, *,
                 device: _Device, backend: Optional[str] = None,
                 timeout_s: float = DEFAULT_TIMEOUT_S,
                 axes: Optional[Dict[str, int]] = None):
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
        self._set_axes(axes)

    def _set_axes(self, axes: Optional[Dict[str, int]]) -> None:
        """One process group per group of each axis of size above 1 and
        below the world's: every process makes every group, in the same
        order."""
        import torch.distributed as dist
        self._init_axes(axes)
        self._pgs: Dict[str, tuple] = {}
        for a in self.axes:
            n = self.axis_size(a)
            if n == 1:
                continue
            if n == self.size:
                # the axis spans the world: its group is the default one
                self._pgs[a] = (None, list(range(self.size)))
                continue
            for g in self.axis_groups(a):
                pg = dist.new_group(
                    ranks=g, backend=self.backend,
                    timeout=datetime.timedelta(seconds=self.timeout_s))
                if self.rank in g:
                    self._pgs[a] = (pg, g)

    def with_axes(self, axes: Dict[str, int]) -> "ProcessGroupMesh":
        """This world laid out over ``axes``: a new mesh with its own axis
        groups (a collective call: every process makes it)."""
        m = copy.copy(self)
        m._set_axes(axes)
        return m

    def local_replicas(self) -> List[Replica]:
        return [Replica(self, self.rank, self.device)]

    def _axis_op(self, rank, op, t, axis, dim=0, perm=None, split=0,
                 concat=0):
        import torch.distributed as dist
        pg, group = self._pgs[axis]
        i, n = group.index(self.rank), len(group)
        x = (t.cpu() if self._stage else t).contiguous()
        if op in ("psum", "pmax", "psum_scatter"):
            out = x.clone()
            dist.all_reduce(out, op=dist.ReduceOp.MAX if op == "pmax"
                            else dist.ReduceOp.SUM, group=pg)
            if op == "psum_scatter":
                out = out.chunk(n, dim)[i].contiguous()
        elif op == "all_gather":
            parts = [torch.empty_like(x) for _ in range(n)]
            dist.all_gather(parts, x, group=pg)
            out = torch.cat(parts, dim)
        elif op == "ppermute":
            # one batch of this rank's send and receive, so blocking
            # pairs cannot cross
            out = torch.zeros_like(x)
            ops = [dist.P2POp(dist.isend, x, group[d])
                   for s, d in perm if s == i]
            ops += [dist.P2POp(dist.irecv, out, group[s])
                    for s, d in perm if d == i]
            if ops:
                for w in dist.batch_isend_irecv(ops):
                    w.wait()
        elif op == "all_to_all":
            # one batch of point-to-point pairs (gloo has no all-to-all
            # in every torch)
            send = [c.contiguous() for c in x.chunk(n, split)]
            recv = [c if j == i else torch.empty_like(c)
                    for j, c in enumerate(send)]
            ops = [dist.P2POp(dist.isend, send[j], group[j])
                   for j in range(n) if j != i]
            ops += [dist.P2POp(dist.irecv, recv[j], group[j])
                    for j in range(n) if j != i]
            for w in dist.batch_isend_irecv(ops):
                w.wait()
            out = torch.cat(recv, concat)
        else:
            raise ValueError(f"unknown collective {op!r}")
        return out.to(t.device) if self._stage else out

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
    """A thread mesh. ``axes`` maps axis name -> size (``data``,
    ``model``, ``seq``, ``pipe``, ``stage`` or any other name), ranks laid
    out row-major in their order; a single ``-1`` entry absorbs the
    remaining devices. Default: every card on the ``data`` axis."""
    devices = list(devices) if devices is not None else cuda_devices()
    return ThreadMesh(devices, timeout_s=timeout_s,
                      axes=_resolve_axes(axes, len(devices)))


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


# ---------------------------------------------------------------------------
# collectives over one named axis (the ``jax.lax`` ones inside shard_map)
# ---------------------------------------------------------------------------
def axis_size(axis: str) -> int:
    """The size of ``axis`` for the thread's replica (1 outside one)."""
    r = current_replica()
    return 1 if r is None else r.axis_size(axis)


def axis_index(axis: str) -> int:
    """The thread's replica's index on ``axis`` (0 outside one)."""
    r = current_replica()
    return 0 if r is None else r.axis_index(axis)


def _axes(axis) -> tuple:
    return (axis,) if isinstance(axis, str) else tuple(axis)


#: each differentiable collective's transpose: (op, how its keyword
#: arguments turn)
def _transpose(op: str, kw: dict) -> tuple:
    if op == "psum":
        return "psum", kw
    if op == "all_gather":
        return "psum_scatter", kw
    if op == "psum_scatter":
        return "all_gather", kw
    if op == "ppermute":
        return "ppermute", {"perm": [(d, s) for s, d in kw["perm"]]}
    if op == "all_to_all":
        return "all_to_all", {"split": kw["concat"],
                              "concat": kw["split"]}
    raise ValueError(op)


class _AxisCollective(torch.autograd.Function):
    """One collective over an axis, its backward the transpose."""

    @staticmethod
    def forward(ctx, t, replica, op, axis, kw):
        ctx.replica, ctx.op, ctx.axis, ctx.kw = replica, op, axis, kw
        return replica.axis_collective(op, t, axis, **kw)

    @staticmethod
    def backward(ctx, g):
        op, kw = _transpose(ctx.op, ctx.kw)
        return (ctx.replica.axis_collective(op, g.contiguous(), ctx.axis,
                                            **kw), None, None, None, None)


def _collective(op: str, x: torch.Tensor, axis: str, **kw) -> torch.Tensor:
    r = current_replica()
    if r is None or r.axis_size(axis) == 1:
        return _single(op, x, **kw) if op == "ppermute" else x
    if torch.is_grad_enabled() and x.requires_grad:
        return _AxisCollective.apply(x, r, op, axis, kw)
    return r.axis_collective(op, x, axis, **kw)


def psum(x: torch.Tensor, axis) -> torch.Tensor:
    """The sum over ``axis``'s group (``axis`` a name or a tuple of
    names, summed one after another). Backward: psum."""
    for a in _axes(axis):
        x = _collective("psum", x, a)
    return x


def pmean(x: torch.Tensor, axis) -> torch.Tensor:
    n = int(np.prod([axis_size(a) for a in _axes(axis)]))
    return psum(x, axis) / n


def pmax(x: torch.Tensor, axis) -> torch.Tensor:
    """The elementwise maximum over ``axis``'s group; no gradient (the
    JAX package takes it of a stop-gradient)."""
    x = x.detach()
    for a in _axes(axis):
        x = _collective("pmax", x, a)
    return x


def all_gather(x: torch.Tensor, axis: str, dim: int = 0) -> torch.Tensor:
    """The group's tensors concatenated along ``dim`` in axis order
    (``lax.all_gather(..., tiled=True)``). Backward: psum_scatter."""
    return _collective("all_gather", x, axis, dim=dim % x.dim())


def psum_scatter(x: torch.Tensor, axis: str, dim: int = 0) -> torch.Tensor:
    """The sum over the group, this rank's equal slice along ``dim``
    (``lax.psum_scatter(..., tiled=True)``). Backward: all_gather."""
    return _collective("psum_scatter", x, axis, dim=dim % x.dim())


def ppermute(x: torch.Tensor, axis: str, perm) -> torch.Tensor:
    """``perm``'s (source, destination) axis indices: each rank receives
    its source's tensor, zeros where it has none. Backward: the inverse
    permutation."""
    return _collective("ppermute", x, axis,
                       perm=[(int(s), int(d)) for s, d in perm])


def all_to_all(x: torch.Tensor, axis: str, split: int, concat: int
               ) -> torch.Tensor:
    """``lax.all_to_all(..., tiled=True)``: chunk ``split`` into one piece
    a member, send piece j to member j, and concatenate what arrives
    along ``concat`` in axis order. Backward: the inverse all_to_all."""
    return _collective("all_to_all", x, axis, split=split % x.dim(),
                       concat=concat % x.dim())


# ---------------------------------------------------------------------------
# partition specs: a global tree cut into each rank's shards, and back
# ---------------------------------------------------------------------------
class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``: one entry a leading dimension,
    ``None`` (whole), an axis name, or a tuple of names (split row-major
    over them); missing trailing entries are whole."""

    def __new__(cls, *entries):
        return tuple.__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def spec_axes(spec) -> set:
    """Every axis name a spec shards over."""
    out = set()
    for e in spec:
        if e is None:
            continue
        out.update(_axes(e))
    return out


def _dim_parts(entry, axes: Dict[str, int], coords: Dict[str, int]):
    """(number of pieces, this rank's piece) of one spec entry."""
    n, i = 1, 0
    for a in _axes(entry):
        n, i = n * axes[a], i * axes[a] + coords[a]
    return n, i


def shard_leaf(x: torch.Tensor, spec, axes: Dict[str, int],
               coords: Dict[str, int]) -> torch.Tensor:
    """The slice of global ``x`` that the rank at ``coords`` holds."""
    for d, e in enumerate(spec):
        if e is None:
            continue
        n, i = _dim_parts(e, axes, coords)
        if x.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(x.shape)} does not split "
                             f"into {n} shards ({spec})")
        k = x.shape[d] // n
        x = x.narrow(d, i * k, k)
    return x


def _zip(fn, tree, specs):
    """``fn(leaf, spec)`` over a nested dict / list tree and its spec
    tree (specs are leaves)."""
    if isinstance(tree, dict):
        return {k: _zip(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zip(fn, v, s) for v, s in zip(tree, specs)]
    return fn(tree, specs)


def shard_tree(tree, specs, mesh: DpMesh, rank: int):
    """``rank``'s shards of a global tree (views; clone to own them)."""
    coords = dict(zip(mesh.axes, mesh.coords(rank)))
    return _zip(lambda x, s: shard_leaf(x, s, mesh.axes, coords),
                tree, specs)


def gather_leaf(shards: Sequence[Optional[torch.Tensor]], spec,
                mesh: DpMesh) -> torch.Tensor:
    """The global tensor put together from every rank's shard (rank
    order; ``None`` for a rank that holds only a replicated copy kept by
    another); of replicated copies the first is kept."""
    first = next(x for x in shards if x is not None)
    shape = list(first.shape)
    for d, e in enumerate(spec):
        if e is not None:
            shape[d] *= int(np.prod([mesh.axes[a] for a in _axes(e)]))
    out = first.new_empty(shape)
    done = set()
    for r, x in enumerate(shards):
        if x is None:
            continue
        coords = dict(zip(mesh.axes, mesh.coords(r)))
        idx, key = [], []
        for d in range(first.dim()):
            e = spec[d] if d < len(spec) else None
            if e is None:
                idx.append(slice(None))
                key.append(0)
                continue
            n, i = _dim_parts(e, mesh.axes, coords)
            k = first.shape[d]
            idx.append(slice(i * k, (i + 1) * k))
            key.append(i)
        if tuple(key) not in done:
            out[tuple(idx)] = x.to(out.device)
            done.add(tuple(key))
    return out


def first_copy(spec, mesh: DpMesh, rank: int) -> bool:
    """Whether ``rank`` holds the first copy of its shard of a leaf with
    ``spec``: its index is 0 on every axis the spec does not name."""
    named = spec_axes(spec)
    return all(c == 0 for a, c in zip(mesh.axes, mesh.coords(rank))
               if a not in named)


def gather_tree(trees: Sequence, specs, mesh: DpMesh):
    """The global tree from every rank's local tree (rank order)."""
    def walk(ts, s):
        if isinstance(ts[0], dict):
            return {k: walk([t[k] for t in ts], s[k]) for k in ts[0]}
        if isinstance(ts[0], list):
            return [walk([t[i] for t in ts], s[i])
                    for i in range(len(ts[0]))]
        return gather_leaf(ts, s, mesh)
    return walk(list(trees), specs)
