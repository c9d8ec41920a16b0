"""Data normalizers with fit / transform / revert.

Counterpart of ``deeplearning4j_tpu/datasets/normalizers.py``, copied
(reference: ``org.nd4j.linalg.dataset.api.preprocessor.
{NormalizerStandardize, NormalizerMinMaxScaler,
ImagePreProcessingScaler}``). They work on a DataSet's numpy features
and change it in place, as the reference does; as an iterator's
preprocessor they run on the staging feeder thread, before the copy to
the device (``datasets/prefetch.py``). ``to_map`` / ``from_map`` read
and write the JAX package's maps, so a normalizer fitted there loads
here.
"""
from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet


class Normalizer:
    def fit(self, it_or_ds):
        raise NotImplementedError

    def transform(self, ds: DataSet):
        raise NotImplementedError

    def revert(self, ds: DataSet):
        raise NotImplementedError

    def pre_process(self, ds: DataSet):
        self.transform(ds)

    # -- serde -----------------------------------------------------------
    def to_map(self) -> dict:
        return {"@class": type(self).__name__,
                **{k: (v.tolist() if isinstance(v, np.ndarray) else v)
                   for k, v in self.__dict__.items()}}

    @staticmethod
    def from_map(d: dict) -> "Normalizer":
        d = dict(d)
        cls = _REGISTRY[d.pop("@class")]
        obj = cls.__new__(cls)
        for k, v in d.items():
            setattr(obj, k, np.asarray(v) if isinstance(v, list) else v)
        return obj


def _feature_stats(it_or_ds, stat_fn):
    if isinstance(it_or_ds, DataSet):
        batches = [np.asarray(it_or_ds.features)]
    else:
        it_or_ds.reset()
        batches = [np.asarray(ds.features) for ds in it_or_ds]
    return stat_fn(np.concatenate([b.reshape(b.shape[0], -1)
                                   for b in batches], axis=0))


class NormalizerStandardize(Normalizer):
    """Per-feature z-score."""

    def __init__(self):
        self.mean = None
        self.std = None

    def fit(self, it_or_ds):
        def stats(flat):
            return flat.mean(0), flat.std(0) + 1e-8
        self.mean, self.std = _feature_stats(it_or_ds, stats)

    def transform(self, ds: DataSet):
        shp = ds.features.shape
        flat = ds.features.reshape(shp[0], -1)
        ds.features = ((flat - self.mean) / self.std).reshape(shp) \
            .astype(np.float32)

    def revert(self, ds: DataSet):
        shp = ds.features.shape
        flat = ds.features.reshape(shp[0], -1)
        ds.features = (flat * self.std + self.mean).reshape(shp)


class NormalizerMinMaxScaler(Normalizer):
    def __init__(self, min_range: float = 0.0, max_range: float = 1.0):
        self.min_range = min_range
        self.max_range = max_range
        self.data_min = None
        self.data_max = None

    def fit(self, it_or_ds):
        def stats(flat):
            return flat.min(0), flat.max(0)
        self.data_min, self.data_max = _feature_stats(it_or_ds, stats)

    def transform(self, ds: DataSet):
        shp = ds.features.shape
        flat = ds.features.reshape(shp[0], -1)
        denom = np.maximum(self.data_max - self.data_min, 1e-8)
        scaled = (flat - self.data_min) / denom
        scaled = scaled * (self.max_range - self.min_range) + self.min_range
        ds.features = scaled.reshape(shp).astype(np.float32)

    def revert(self, ds: DataSet):
        shp = ds.features.shape
        flat = ds.features.reshape(shp[0], -1)
        denom = np.maximum(self.data_max - self.data_min, 1e-8)
        unscaled = (flat - self.min_range) / \
            (self.max_range - self.min_range) * denom + self.data_min
        ds.features = unscaled.reshape(shp)


class ImagePreProcessingScaler(Normalizer):
    """Pixels in [0, max_pixel] -> [min, max] (the MNIST / ImageNet
    default 0-255 -> 0-1)."""

    def __init__(self, min_range: float = 0.0, max_range: float = 1.0,
                 max_pixel: float = 255.0):
        self.min_range = min_range
        self.max_range = max_range
        self.max_pixel = max_pixel

    def fit(self, it_or_ds):
        pass  # stateless

    def transform(self, ds: DataSet):
        scale = (self.max_range - self.min_range) / self.max_pixel
        ds.features = (ds.features * scale + self.min_range) \
            .astype(np.float32)

    def revert(self, ds: DataSet):
        scale = (self.max_range - self.min_range) / self.max_pixel
        ds.features = (ds.features - self.min_range) / scale


_REGISTRY = {c.__name__: c for c in
             (NormalizerStandardize, NormalizerMinMaxScaler,
              ImagePreProcessingScaler)}
