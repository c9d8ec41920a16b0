"""DataSetIterator: the minibatch stream contract fit() consumes.

Counterpart of ``DataSetIterator``, ``ListDataSetIterator``,
``ExistingDataSetIterator`` and ``AsyncDataSetIterator`` in
``deeplearning4j_tpu/datasets/iterators.py``. Device staging is
``datasets/prefetch.py``.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, List, Optional

from deeplearning4j_tpu_torch.datasets.dataset import DataSet


class DataSetIterator:
    """Iterable + reset; optional preprocessor (a normalizer)."""

    def __init__(self):
        self.pre_processor = None

    def set_pre_processor(self, p):
        self.pre_processor = p

    def reset(self):
        raise NotImplementedError

    def has_next(self) -> bool:
        raise NotImplementedError

    def next(self) -> DataSet:  # noqa: A003
        raise NotImplementedError

    def batch(self) -> int:
        raise NotImplementedError

    def __iter__(self) -> Iterator[DataSet]:
        self.reset()
        while self.has_next():
            yield self.next()

    def _apply_pre(self, ds: DataSet) -> DataSet:
        if self.pre_processor is not None:
            self.pre_processor.transform(ds)
        return ds


class ListDataSetIterator(DataSetIterator):
    """Iterate a list of pre-batched DataSets, or one big DataSet split
    into minibatches."""

    def __init__(self, data, batch_size: Optional[int] = None):
        super().__init__()
        if isinstance(data, DataSet):
            data = data.batch_by(batch_size or 32)
        self._data: List[DataSet] = list(data)
        self._batch = batch_size or (self._data[0].num_examples()
                                     if self._data else 0)
        self._pos = 0

    def reset(self):
        self._pos = 0

    def has_next(self) -> bool:
        return self._pos < len(self._data)

    def next(self) -> DataSet:  # noqa: A003
        if not self.has_next():
            raise StopIteration("iterator exhausted; call reset()")
        ds = self._data[self._pos]
        self._pos += 1
        return self._apply_pre(ds)

    def batch(self) -> int:
        return self._batch

    def total_examples(self) -> int:
        return sum(d.num_examples() for d in self._data)


class ExistingDataSetIterator(DataSetIterator):
    """Wrap any python iterable of DataSets."""

    def __init__(self, iterable):
        super().__init__()
        self._iterable = iterable
        self._it = None
        self._next = None

    def reset(self):
        self._it = iter(self._iterable)
        self._advance()

    def _advance(self):
        try:
            self._next = next(self._it)
        except StopIteration:
            self._next = None

    def has_next(self) -> bool:
        if self._it is None:
            self.reset()
        return self._next is not None

    def next(self) -> DataSet:  # noqa: A003
        if not self.has_next():
            raise StopIteration("iterator exhausted; call reset()")
        ds = self._next
        self._advance()
        return self._apply_pre(ds)

    def batch(self) -> int:
        return -1


class _FeederError:
    """An exception raised on a feeder thread, carried to the consumer
    so a failing base iterator fails ``fit`` loudly."""
    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


class AsyncDataSetIterator(DataSetIterator):
    """Background-thread prefetch (reference: AsyncDataSetIterator with
    its queue-feeder thread): the base iterator's ETL runs on a feeder
    thread, ``queue_size`` batches ahead of the consumer."""

    _SENTINEL = object()

    def __init__(self, base: DataSetIterator, queue_size: int = 4):
        super().__init__()
        self._base = base
        self._queue_size = max(1, queue_size)
        self._queue: queue.Queue = queue.Queue(self._queue_size)
        self._thread: Optional[threading.Thread] = None
        self._next = None
        self._error: Optional[BaseException] = None
        self._started = False

    def _feeder(self, q: queue.Queue):
        try:
            self._base.reset()
            while self._base.has_next():
                q.put(self._base.next())
            q.put(self._SENTINEL)
        except BaseException as e:       # noqa: BLE001 — re-raised on
            q.put(_FeederError(e))       # the consumer thread

    def reset(self):
        t = self._thread
        if t is not None and t.is_alive():
            # drain so the old feeder can finish; timed gets, because
            # the sentinel may already have been consumed while the
            # feeder is between its final put and its exit
            while t.is_alive():
                try:
                    item = self._queue.get(timeout=0.05)
                except queue.Empty:
                    continue
                if item is self._SENTINEL or isinstance(item, _FeederError):
                    break
            t.join()
        self._queue = queue.Queue(self._queue_size)
        self._error = None
        self._thread = threading.Thread(
            target=self._feeder, args=(self._queue,), daemon=True,
            name="dl4j-torch-async-iterator")
        self._thread.start()
        self._started = True
        self._advance()

    def _advance(self):
        item = self._queue.get()
        if isinstance(item, _FeederError):
            self._error, self._next = item.exc, None
        else:
            self._next = None if item is self._SENTINEL else item

    def has_next(self) -> bool:
        if not self._started:
            self.reset()
        if self._error is not None:
            e, self._error = self._error, None
            raise e
        return self._next is not None

    def next(self) -> DataSet:  # noqa: A003
        if not self.has_next():
            raise StopIteration("iterator exhausted; call reset()")
        ds = self._next
        self._advance()
        return self._apply_pre(ds)

    def batch(self) -> int:
        return self._base.batch()
