"""MNIST: the IDX files when they are on disk, else the JAX package's
deterministic synthetic surrogate.

Counterpart of ``deeplearning4j_tpu/datasets/mnist.py``. The loader
looks for ``train-images-idx3-ubyte`` / ``train-labels-idx1-ubyte``
(``t10k-*`` for the test split), plain or ``.gz``, in ``data_dir`` or
``$DL4J_TORCH_DATA_DIR``; nothing is downloaded. Without them it serves
the surrogate, copied from the JAX package: each class a fixed smooth
28x28 template plus pixel noise, from a numpy seed, so the same seed
gives the same images in both packages.

Features are flat ``[batch, 784]`` float32 in [0, 1], labels one-hot
``[batch, 10]``.
"""
from __future__ import annotations

import gzip
import os
import struct
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import DataSetIterator


def _read_idx(path: Path) -> np.ndarray:
    """An IDX file (big-endian dims after a magic whose low byte is the
    rank) as a uint8 array."""
    op = gzip.open if path.suffix == ".gz" else open
    with op(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(dims)


def _find(name: str, data_dir: Optional[str]) -> Optional[Path]:
    for d in (data_dir, os.environ.get("DL4J_TORCH_DATA_DIR")):
        if not d:
            continue
        for cand in (Path(d) / name, Path(d) / (name + ".gz")):
            if cand.exists():
                return cand
    return None


def _load_real(train: bool, data_dir: Optional[str] = None
               ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """``(x [n, 784] float32 in [0, 1], y [n] uint8)`` from the IDX
    files, or None when they are not there."""
    prefix = "train" if train else "t10k"
    imgs = _find(f"{prefix}-images-idx3-ubyte", data_dir)
    lbls = _find(f"{prefix}-labels-idx1-ubyte", data_dir)
    if imgs is None or lbls is None:
        return None
    x = _read_idx(imgs).astype(np.float32) / 255.0
    return x.reshape(x.shape[0], -1), _read_idx(lbls)


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
    """Minibatches of the IDX files, or of the synthetic surrogate
    (60000 train / 10000 test examples unless ``num_examples`` says
    otherwise); ``synthetic`` says which."""

    def __init__(self, batch_size: int, train: bool = True,
                 seed: int = 123, num_examples: Optional[int] = None,
                 binarize: bool = False, shuffle: bool = True,
                 data_dir: Optional[str] = None):
        super().__init__()
        real = _load_real(train, data_dir)
        if real is not None:
            x, y = real
            self.synthetic = False
        else:
            n = num_examples or (60000 if train else 10000)
            x, y = synthetic_mnist(n, train, seed)
            self.synthetic = True
        if num_examples is not None:
            x, y = x[:num_examples], y[:num_examples]
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
