"""DevicePrefetcher: input staging for the fit loops.

Counterpart of ``deeplearning4j_tpu/datasets/prefetch.py`` in the
PyTorch idiom. The feeding ladder:

1. **sync**: ``fit`` calls ``iter.next()`` inline; the ETL, the
   host-to-device copy and the step serialize.
2. **host-async**: :class:`~deeplearning4j_tpu_torch.datasets.iterators.
   AsyncDataSetIterator` moves the ETL onto a feeder thread.
3. **device prefetch** (this module): the feeder thread also stages
   each batch on the device, ``depth`` batches ahead of the step that
   consumes it, so the copy of batch n+1 overlaps the step on batch n.

Staging a batch on the feeder thread: the ETL and the preprocessor run
there; the floats of ``features`` and ``labels`` are cast to the model
dtype on the host (masks keep their dtype, as the JAX package's
``_CAST_ATTRS``), so fewer bytes cross; on a CUDA device every array is
copied into pinned host memory and then with ``non_blocking=True`` on a
side ``torch.cuda.Stream``, which records an event. The consumer makes
its current stream wait on that event before the step reads the batch,
and calls ``Tensor.record_stream`` on the staged tensors, so the caching
allocator cannot hand their memory to the side stream's next copy while
the step still reads it. On the CPU the copy is a no-op and only the
ETL and the cast move to the feeder.

``place_fn`` is the hook a caller with its own placement passes
(``parallel/wrapper.py`` trims the batch to a multiple of the replica
count and splits it): it maps the cast host DataSet to a DataSet, or to
a list of them, one per entry of ``device``, and each is staged on its
device.

An :class:`AsyncDataSetIterator` base is unwrapped: this feeder thread
already overlaps the ETL. A feeder exception is raised on the consumer
thread.

``fit`` wraps iterators through :func:`maybe_device_prefetch`
(``DL4J_TORCH_DEVICE_PREFETCH=0`` opts out; depth from
``DL4J_TORCH_DEVICE_PREFETCH_DEPTH``, default 2; ``common/environment``).
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch

from deeplearning4j_tpu_torch.common import telemetry
from deeplearning4j_tpu_torch.common.environment import (Environment,
                                                         resolve_device)
from deeplearning4j_tpu_torch.datasets.iterators import (
    AsyncDataSetIterator, DataSetIterator, _FeederError)
from deeplearning4j_tpu_torch.parallel.mesh import (canonical_device,
                                                    map_dataset_arrays)

#: the attributes whose floats are cast to the model dtype before the
#: copy; masks keep their dtype
_CAST_ATTRS = ("features", "labels")

_Device = Union[str, torch.device]


def host_tensor(a, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``a`` as a tensor where it lies (numpy arrays on the host, without
    a copy), floats cast to ``dtype`` when one is given."""
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t


def cast_dataset(ds, dtype: Optional[torch.dtype]):
    """A shallow copy of a DataSet/MultiDataSet with every array a
    tensor, the floats of features and labels cast to ``dtype``."""
    out = map_dataset_arrays(ds, host_tensor)
    if dtype is not None:
        for attr in _CAST_ATTRS:
            v = getattr(out, attr, None)
            if isinstance(v, list):
                setattr(out, attr, [host_tensor(t, dtype) for t in v])
            elif v is not None:
                setattr(out, attr, host_tensor(v, dtype))
    return out


class Staged:
    """A staged payload with what its consumer must wait for: one
    ``(device, event, tensors)`` entry for each CUDA device it was
    copied to."""
    __slots__ = ("payload", "pending")

    def __init__(self, payload, pending):
        self.payload = payload
        self.pending = pending

    def consume(self):
        """The payload, once the current stream of each device waits on
        its copies and the staged tensors are recorded on it."""
        for device, event, tensors in self.pending:
            cur = torch.cuda.current_stream(device)
            cur.wait_event(event)
            for t in tensors:
                t.record_stream(cur)
        return self.payload


class Stager:
    """Copies host tensors to a device through pinned memory on a side
    stream (one per CUDA device), on the thread that calls it."""

    def __init__(self):
        self._streams = {}

    def to_device(self, obj, device: _Device, pending: list):
        """``obj`` (a tensor, a DataSet or a dict of tensors) with every
        tensor on ``device``; a CUDA copy appends its event to
        ``pending``."""
        device = canonical_device(device)
        if device.type != "cuda":
            return _map_tensors(obj, lambda t: t.to(device))
        side = self._streams.get(device)
        if side is None:
            side = self._streams[device] = torch.cuda.Stream(device)
        copied: List[torch.Tensor] = []

        def copy(t: torch.Tensor) -> torch.Tensor:
            if t.device.type == "cpu":
                t = t.contiguous()
                if not t.is_pinned():
                    t = t.pin_memory()
            out = t.to(device, non_blocking=True)
            copied.append(out)
            return out

        with torch.cuda.stream(side):
            out = _map_tensors(obj, copy)
            event = torch.cuda.Event()
            event.record(side)
        pending.append((device, event, copied))
        return out


def _map_tensors(obj, fn):
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _map_tensors(v, fn) for k, v in obj.items()}
    return map_dataset_arrays(obj, lambda a: fn(host_tensor(a)))


class DevicePrefetcher(DataSetIterator):
    """Wrap any :class:`DataSetIterator`; the ETL runs on a feeder
    thread and the next ``depth`` batches are staged on ``device`` (a
    device, None for the card, or one device for each DataSet
    ``place_fn`` returns)."""

    _SENTINEL = object()

    def __init__(self, base: DataSetIterator, *, depth: int = 2,
                 device: Union[None, _Device, Sequence[_Device]] = None,
                 dtype: Optional[torch.dtype] = None,
                 place_fn: Optional[Callable] = None):
        super().__init__()
        self._pre = None
        if isinstance(base, AsyncDataSetIterator):
            # this feeder already overlaps the ETL: no second thread
            self._pre = base.pre_processor
            base = base._base
        self._base = base
        self._depth = max(1, int(depth))
        # one device, or one for each DataSet place_fn returns; None is
        # the card, as everywhere in the port
        self._devices = (list(device) if isinstance(device, (list, tuple))
                         else [resolve_device(device)])
        self._dtype = dtype
        self._place_fn = place_fn
        self._queue: queue.Queue = queue.Queue(self._depth)
        self._thread: Optional[threading.Thread] = None
        self._next = None
        self._error: Optional[BaseException] = None
        self._started = False
        self._consumed = False

    def _stage(self, ds, stager: Stager) -> Staged:
        if self._pre is not None:
            self._pre.transform(ds)
        ds = cast_dataset(ds, self._dtype)
        placed = self._place_fn(ds) if self._place_fn is not None else ds
        pending: list = []
        if isinstance(placed, list):
            if len(placed) != len(self._devices):
                raise ValueError(
                    f"place_fn gave {len(placed)} DataSets for "
                    f"{len(self._devices)} devices")
            placed = [stager.to_device(p, d, pending)
                      for p, d in zip(placed, self._devices)]
        else:
            placed = stager.to_device(placed, self._devices[0], pending)
        return Staged(placed, pending)

    def _feeder(self, q: queue.Queue):
        try:
            stager = Stager()
            self._base.reset()
            while self._base.has_next():
                q.put(self._stage(self._base.next(), stager))
            q.put(self._SENTINEL)
        except BaseException as e:       # noqa: BLE001 — re-raised on
            q.put(_FeederError(e))       # the consumer thread

    def reset(self):
        t = self._thread
        if t is not None and t.is_alive():
            # drain so the old feeder can finish (timed gets: the
            # terminal item may already have been consumed)
            while t.is_alive():
                try:
                    item = self._queue.get(timeout=0.05)
                except queue.Empty:
                    continue
                if item is self._SENTINEL or isinstance(item, _FeederError):
                    break
            t.join()
        self._queue = queue.Queue(self._depth)
        self._error = None
        self._thread = threading.Thread(
            target=self._feeder, args=(self._queue,), daemon=True,
            name="dl4j-torch-device-prefetch")
        self._thread.start()
        self._started = True
        self._consumed = False
        self._advance()

    def _advance(self):
        if telemetry.enabled():
            t0 = time.perf_counter()
            item = self._queue.get()
            telemetry.observe_feed_stall(time.perf_counter() - t0,
                                         source="device_prefetch")
        else:
            item = self._queue.get()
        if isinstance(item, _FeederError):
            self._error, self._next = item.exc, None
        elif item is self._SENTINEL:
            self._next = None
        else:
            self._next = item

    def has_next(self) -> bool:
        if not self._started:
            self.reset()
        if self._error is not None:
            e, self._error = self._error, None
            raise e
        return self._next is not None

    def next(self):  # noqa: A003
        if not self.has_next():
            raise StopIteration("iterator exhausted; call reset()")
        staged = self._next
        self._consumed = True
        self._advance()
        return staged.consume()

    def __iter__(self):
        # a freshly reset prefetcher already has batches staged: reset
        # again only when stale, so fit's reset() + ``for ds in it``
        # does not throw the staged window away every epoch
        if not self._started or self._consumed:
            self.reset()
        while self.has_next():
            yield self.next()

    def batch(self) -> int:
        return self._base.batch()

    def set_pre_processor(self, p):
        # preprocessing sees host arrays, on the feeder thread
        self._base.set_pre_processor(p)


def maybe_device_prefetch(iterator, *, device=None, dtype=None,
                          place_fn=None, depth: Optional[int] = None):
    """The fit funnels' hook: ``iterator`` wrapped in a
    :class:`DevicePrefetcher` when ``DL4J_TORCH_DEVICE_PREFETCH`` is on
    (the default); unchanged when the flag is off, when it is already
    staged, or when it is not a resettable DataSetIterator-shaped stream
    (plain lists and generators stay synchronous)."""
    env = Environment.get()
    if not env.device_prefetch or isinstance(iterator, DevicePrefetcher):
        return iterator
    if not (hasattr(iterator, "reset") and hasattr(iterator, "has_next")
            and hasattr(iterator, "next")):
        return iterator
    return DevicePrefetcher(
        iterator, depth=depth or env.device_prefetch_depth, device=device,
        dtype=dtype, place_fn=place_fn)
