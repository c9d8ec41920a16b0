"""CIFAR-10 / EMNIST / TinyImageNet iterators.

Counterpart of ``deeplearning4j_tpu/datasets/vision.py``, copied. Real
files load from ``$DL4J_TPU_DATA_DIR`` (default ``~/.deeplearning4j``):
CIFAR-10 binary batches, EMNIST / TinyImageNet ``.npz``. Nothing is
downloaded: without the files each iterator serves a deterministic
synthetic surrogate, :func:`synthetic_images`, whose numpy stream is the
JAX package's bit for bit (the bundled checkpoints' quality gates are
measured on it). Features are NHWC float32 in [0, 1] (EMNIST flat),
labels one-hot.
"""
from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import DataSetIterator

log = logging.getLogger("deeplearning4j_tpu_torch")


def _data_dir() -> Path:
    return Path(os.environ.get("DL4J_TPU_DATA_DIR",
                               Path.home() / ".deeplearning4j"))


def synthetic_images(n: int, h: int, w: int, c: int, n_classes: int,
                     train: bool, seed: int,
                     template_weight: float = 0.6
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Class-conditional smooth templates + noise, [n,h,w,c] float32.

    ``template_weight`` sets the signal fraction (default 0.6). The
    pretrained-zoo gates evaluate on a lower-weight ("hard") split so
    the gate sits measurably below saturation."""
    rng = np.random.RandomState(seed if train else seed + 1)
    tpl_rng = np.random.RandomState(seed)
    tpl = tpl_rng.rand(n_classes, h, w, c).astype(np.float32)
    # separable box blur for local structure
    k = 5
    for ax in (1, 2):
        pad = [(0, 0)] * 4
        pad[ax] = (k // 2, k // 2)
        p = np.pad(tpl, pad, mode="edge")
        sl = [slice(None)] * 4
        acc = np.zeros_like(tpl)
        for i in range(k):
            sl[ax] = slice(i, i + tpl.shape[ax])
            acc += p[tuple(sl)]
        tpl = acc / k
    ys = rng.randint(0, n_classes, n)
    noise = rng.rand(n, h, w, c).astype(np.float32)
    tw = float(template_weight)
    xs = np.clip(tw * tpl[ys] + (1.0 - tw) * noise, 0, 1)
    return xs, ys


class _ArrayIterator(DataSetIterator):
    def __init__(self, x, y, n_classes, batch_size, seed, shuffle):
        super().__init__()
        if shuffle:
            perm = np.random.RandomState(seed).permutation(len(x))
            x, y = x[perm], y[perm]
        self._x = x
        self._y = np.eye(n_classes, dtype=np.float32)[y]
        self._batch_size = batch_size
        self._pos = 0

    def reset(self):
        self._pos = 0

    def has_next(self) -> bool:
        return self._pos < len(self._x)

    def next(self) -> DataSet:  # noqa: A003
        if not self.has_next():
            raise StopIteration("iterator exhausted; call reset()")
        i = self._pos
        self._pos += self._batch_size
        return self._apply_pre(DataSet(self._x[i:self._pos],
                                       self._y[i:self._pos]))

    def batch(self) -> int:
        return self._batch_size

    def total_examples(self) -> int:
        return len(self._x)


def _load_cifar10(train: bool) -> Optional[Tuple[np.ndarray,
                                                 np.ndarray]]:
    base = _data_dir() / "cifar10"
    names = ([f"data_batch_{i}.bin" for i in range(1, 6)]
             if train else ["test_batch.bin"])
    paths = [base / n for n in names]
    if not all(p.exists() for p in paths):
        return None
    xs, ys = [], []
    for p in paths:
        raw = np.frombuffer(p.read_bytes(), np.uint8).reshape(-1, 3073)
        ys.append(raw[:, 0].astype(np.int64))
        img = raw[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        xs.append(img.astype(np.float32) / 255.0)
    return np.concatenate(xs), np.concatenate(ys)


class Cifar10DataSetIterator(_ArrayIterator):
    """Reference: Cifar10DataSetIterator(batch, train): NHWC / 255."""

    def __init__(self, batch_size: int, train: bool = True,
                 seed: int = 123,
                 num_examples: Optional[int] = None,
                 shuffle: bool = True):
        real = _load_cifar10(train)
        if real is None:
            log.warning("CIFAR-10 binaries not found; using synthetic "
                        "surrogate (place them under %s)",
                        _data_dir() / "cifar10")
            n = num_examples or (50000 if train else 10000)
            x, y = synthetic_images(n, 32, 32, 3, 10, train, seed)
        else:
            x, y = real
            if num_examples:
                x, y = x[:num_examples], y[:num_examples]
        self.synthetic = real is None
        super().__init__(x, y, 10, batch_size, seed, shuffle)


class EmnistDataSetIterator(_ArrayIterator):
    """Reference: EmnistDataSetIterator(set, batch, train). Sets:
    LETTERS (26), DIGITS (10), BALANCED (47), BYCLASS (62)."""

    SETS = {"LETTERS": 26, "DIGITS": 10, "BALANCED": 47,
            "BYCLASS": 62}

    def __init__(self, emnist_set: str, batch_size: int,
                 train: bool = True, seed: int = 123,
                 num_examples: Optional[int] = None,
                 shuffle: bool = True):
        emnist_set = emnist_set.upper()
        if emnist_set not in self.SETS:
            raise ValueError(f"unknown EMNIST set {emnist_set}; "
                             f"one of {sorted(self.SETS)}")
        n_cls = self.SETS[emnist_set]
        p = _data_dir() / f"emnist_{emnist_set.lower()}.npz"
        if p.exists():
            z = np.load(p)
            k = "train" if train else "test"
            x, y = z[f"x_{k}"].astype(np.float32), z[f"y_{k}"]
            if x.max() > 1.5:
                x = x / 255.0
            x = x.reshape(len(x), -1)
            self.synthetic = False
        else:
            log.warning("EMNIST %s not found; synthetic surrogate",
                        emnist_set)
            n = num_examples or (10000 if train else 2000)
            x, y = synthetic_images(n, 28, 28, 1, n_cls, train, seed)
            x = x.reshape(n, -1)
            self.synthetic = True
        if num_examples:
            x, y = x[:num_examples], y[:num_examples]
        self.n_classes = n_cls
        super().__init__(x, y, n_cls, batch_size, seed, shuffle)


class TinyImageNetDataSetIterator(_ArrayIterator):
    """Reference: TinyImageNetDataSetIterator: 200 classes, 64x64."""

    def __init__(self, batch_size: int, train: bool = True,
                 seed: int = 123,
                 num_examples: Optional[int] = None,
                 shuffle: bool = True):
        p = _data_dir() / "tiny_imagenet.npz"
        if p.exists():
            z = np.load(p)
            k = "train" if train else "val"
            x = z[f"x_{k}"].astype(np.float32)
            if x.max() > 1.5:
                x = x / 255.0
            y = z[f"y_{k}"]
            self.synthetic = False
        else:
            log.warning("TinyImageNet not found; synthetic surrogate")
            n = num_examples or (2000 if train else 500)
            x, y = synthetic_images(n, 64, 64, 3, 200, train, seed)
            self.synthetic = True
        if num_examples:
            x, y = x[:num_examples], y[:num_examples]
        super().__init__(x, y, 200, batch_size, seed, shuffle)
