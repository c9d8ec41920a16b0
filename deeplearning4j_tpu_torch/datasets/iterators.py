"""DataSetIterator: the minibatch stream contract fit() consumes.

Counterpart of ``DataSetIterator``, ``ListDataSetIterator`` and
``ExistingDataSetIterator`` in ``deeplearning4j_tpu/datasets/
iterators.py``. The background-thread ``AsyncDataSetIterator`` and
device prefetch are not ported yet.
"""
from __future__ import annotations

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
