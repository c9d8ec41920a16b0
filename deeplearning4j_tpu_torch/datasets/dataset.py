"""DataSet / MultiDataSet: the feature/label/mask bundle fit() consumes.

Counterpart of ``deeplearning4j_tpu/datasets/dataset.py``. Arrays are
numpy on the host; a torch tensor handed in is kept as it is (a batch
already on the card is not copied back).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch


def _np(x):
    if isinstance(x, torch.Tensor):
        return x
    return np.asarray(x)


def _opt(x):
    return _np(x) if x is not None else None


class DataSet:
    def __init__(self, features, labels, features_mask=None,
                 labels_mask=None):
        self.features = _np(features)
        self.labels = _np(labels)
        self.features_mask = _opt(features_mask)
        self.labels_mask = _opt(labels_mask)

    def num_examples(self) -> int:
        return int(self.features.shape[0])

    def get_features(self):
        return self.features

    def get_labels(self):
        return self.labels

    def _slice(self, sl) -> "DataSet":
        return DataSet(self.features[sl], self.labels[sl],
                       self.features_mask[sl]
                       if self.features_mask is not None else None,
                       self.labels_mask[sl]
                       if self.labels_mask is not None else None)

    def split_test_and_train(self, n_train: int):
        return self._slice(slice(None, n_train)), \
            self._slice(slice(n_train, None))

    def shuffle(self, seed: Optional[int] = None):
        perm = np.random.RandomState(seed).permutation(self.num_examples())
        shuffled = self._slice(perm)
        self.features, self.labels = shuffled.features, shuffled.labels
        self.features_mask = shuffled.features_mask
        self.labels_mask = shuffled.labels_mask

    def batch_by(self, batch_size: int) -> List["DataSet"]:
        return [self._slice(slice(i, i + batch_size))
                for i in range(0, self.num_examples(), batch_size)]

    @staticmethod
    def merge(datasets: Sequence["DataSet"]) -> "DataSet":
        def cat(name):
            parts = [getattr(d, name) for d in datasets]
            return None if parts[0] is None else np.concatenate(parts)
        return DataSet(cat("features"), cat("labels"),
                       cat("features_mask"), cat("labels_mask"))

    def __repr__(self):
        return (f"DataSet(features={tuple(self.features.shape)}, "
                f"labels={tuple(self.labels.shape)})")


class MultiDataSet:
    """N features / M labels (reference:
    org.nd4j.linalg.dataset.MultiDataSet)."""

    def __init__(self, features, labels, features_masks=None,
                 labels_masks=None):
        def as_list(x):
            return [_np(a) for a in x] if isinstance(x, (list, tuple)) \
                else [_np(x)]
        self.features = as_list(features)
        self.labels = as_list(labels)
        self.features_masks = [_opt(m) for m in features_masks] \
            if features_masks else None
        self.labels_masks = [_opt(m) for m in labels_masks] \
            if labels_masks else None

    def num_examples(self) -> int:
        return int(self.features[0].shape[0])
