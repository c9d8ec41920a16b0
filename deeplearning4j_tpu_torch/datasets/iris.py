"""Iris dataset iterator.

Counterpart of ``deeplearning4j_tpu/datasets/iris.py`` (reference:
``org.deeplearning4j.datasets.iterator.impl.IrisDataSetIterator``): the
JAX package's deterministic Gaussian surrogate of the 150-row table
(one linearly separable class, two overlapping), from the same numpy
seed, array for array. No file is read.
"""
from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator

_MEANS = np.array([[5.0, 3.4, 1.5, 0.25],
                   [5.9, 2.8, 4.3, 1.3],
                   [6.6, 3.0, 5.6, 2.0]], dtype=np.float32)
_STDS = np.array([[0.35, 0.38, 0.17, 0.10],
                  [0.52, 0.31, 0.47, 0.20],
                  [0.64, 0.32, 0.55, 0.27]], dtype=np.float32)


def iris_surrogate() -> DataSet:
    """150 rows of 4 features, 50 a class, labels one-hot."""
    rng = np.random.RandomState(6)
    ys = np.repeat(np.arange(3), 50)
    x = (_MEANS[ys] + _STDS[ys] * rng.randn(150, 4)).astype(np.float32)
    return DataSet(x, np.eye(3, dtype=np.float32)[ys])


class IrisDataSetIterator(ListDataSetIterator):
    def __init__(self, batch_size: int = 150, num_examples: int = 150):
        ds = iris_surrogate()
        ds.shuffle(seed=42)
        ds = DataSet(ds.features[:num_examples], ds.labels[:num_examples])
        super().__init__(ds, batch_size)
