"""MNIST-shaped data: the JAX package's deterministic synthetic surrogate.

Counterpart of ``synthetic_mnist`` and ``MnistDataSetIterator`` in
``deeplearning4j_tpu/datasets/mnist.py``, copied: each class is a fixed
smooth 28x28 template plus pixel noise, from a numpy seed, so the same
seed gives the same images in both packages. Reading the real IDX files
is not ported yet: this iterator always serves the surrogate.

Features are flat ``[batch, 784]`` float32 in [0, 1], labels one-hot
``[batch, 10]``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import DataSetIterator


def synthetic_mnist(n: int, train: bool, seed: int = 123
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic MNIST-shaped surrogate: each class is a fixed smooth
    28x28 template plus pixel noise. Linearly separable enough for LeNet
    to learn, hard enough that an untrained net is at chance."""
    rng = np.random.RandomState(seed if train else seed + 1)
    tpl_rng = np.random.RandomState(seed)  # templates shared by splits
    templates = tpl_rng.rand(10, 28, 28).astype(np.float32)
    # smooth the templates so convolutions have local structure to find
    k = np.ones((5, 5), np.float32) / 25.0
    for c in range(10):
        t = templates[c]
        padded = np.pad(t, 2, mode="edge")
        sm = np.zeros_like(t)
        for i in range(5):
            for j in range(5):
                sm += k[i, j] * padded[i:i + 28, j:j + 28]
        templates[c] = sm
    ys = rng.randint(0, 10, size=n)
    noise = rng.rand(n, 28, 28).astype(np.float32)
    xs = np.clip(0.65 * templates[ys] + 0.35 * noise, 0.0, 1.0)
    return xs.reshape(n, -1), ys


class MnistDataSetIterator(DataSetIterator):
    """Minibatches of the synthetic surrogate (60000 train / 10000 test
    examples unless ``num_examples`` says otherwise)."""

    def __init__(self, batch_size: int, train: bool = True,
                 seed: int = 123, num_examples: Optional[int] = None,
                 binarize: bool = False, shuffle: bool = True):
        super().__init__()
        n = num_examples or (60000 if train else 10000)
        x, y = synthetic_mnist(n, train, seed)
        self.synthetic = True
        if binarize:
            x = (x > 0.5).astype(np.float32)
        if shuffle:
            perm = np.random.RandomState(seed).permutation(x.shape[0])
            x, y = x[perm], y[perm]
        self._x = x
        self._y = np.eye(10, dtype=np.float32)[y]
        self._batch_size = batch_size
        self._pos = 0

    def reset(self):
        self._pos = 0

    def has_next(self) -> bool:
        return self._pos < self._x.shape[0]

    def next(self) -> DataSet:  # noqa: A003
        if not self.has_next():
            raise StopIteration("iterator exhausted; call reset()")
        i = self._pos
        self._pos += self._batch_size
        return self._apply_pre(DataSet(self._x[i:i + self._batch_size],
                                       self._y[i:i + self._batch_size]))

    def batch(self) -> int:
        return self._batch_size

    def total_examples(self) -> int:
        return int(self._x.shape[0])
