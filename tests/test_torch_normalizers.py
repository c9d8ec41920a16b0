"""The port's normalizers, MNIST IDX reader and iris surrogate against
the JAX package's, on the CPU.

The normalizers are the same numpy arithmetic: fit, transform and
revert agree within 1e-6, and a map the JAX package writes
(``to_map``) loads in the port. The IDX files are written by the test
itself (no data is fetched), plain and gzipped, and both packages read
them to the same arrays. The iris surrogate is the same seeded draw.
"""
import gzip
import json
import struct

import numpy as np
import pytest

from deeplearning4j_tpu.datasets import iris as jiris
from deeplearning4j_tpu.datasets import mnist as jmnist
from deeplearning4j_tpu.datasets import normalizers as jn
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.iterators import \
    ListDataSetIterator as JList
from deeplearning4j_tpu_torch.datasets import iris as tiris
from deeplearning4j_tpu_torch.datasets import mnist as tmnist
from deeplearning4j_tpu_torch.datasets import normalizers as tn
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator

TOL = 1e-6


def _data(seed=0, n=40, shape=(3, 4)):
    r = np.random.RandomState(seed)
    x = (r.rand(n, *shape) * 200.0 - 20.0).astype(np.float32)
    return x, np.eye(2, dtype=np.float32)[r.randint(0, 2, n)]


NORMALIZERS = {
    "standardize": lambda m: m.NormalizerStandardize(),
    "minmax": lambda m: m.NormalizerMinMaxScaler(-1.0, 2.0),
    "image": lambda m: m.ImagePreProcessingScaler(0.0, 1.0, 255.0),
}


@pytest.mark.parametrize("source", ["dataset", "iterator"])
@pytest.mark.parametrize("kind", sorted(NORMALIZERS))
def test_normalizers_match_jax(kind, source):
    x, y = _data()
    jnorm, norm = NORMALIZERS[kind](jn), NORMALIZERS[kind](tn)
    if source == "dataset":
        jnorm.fit(JDataSet(x.copy(), y))
        norm.fit(DataSet(x.copy(), y))
    else:
        jnorm.fit(JList(JDataSet(x.copy(), y), 16))
        norm.fit(ListDataSetIterator(DataSet(x.copy(), y), 16))
    jds, ds = JDataSet(x.copy(), y), DataSet(x.copy(), y)
    jnorm.transform(jds)
    norm.transform(ds)
    assert ds.features.dtype == np.float32
    np.testing.assert_allclose(ds.features, np.asarray(jds.features),
                               rtol=TOL, atol=TOL)
    jnorm.revert(jds)
    norm.revert(ds)
    np.testing.assert_allclose(ds.features, np.asarray(jds.features),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ds.features, x, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("kind", sorted(NORMALIZERS))
def test_a_jax_map_loads_in_the_port(kind):
    x, y = _data(1)
    jnorm = NORMALIZERS[kind](jn)
    jnorm.fit(JDataSet(x.copy(), y))
    m = json.loads(json.dumps(jnorm.to_map()))
    norm = tn.Normalizer.from_map(m)
    assert type(norm).__name__ == type(jnorm).__name__
    assert json.loads(json.dumps(norm.to_map())) == m
    jds, ds = JDataSet(x.copy(), y), DataSet(x.copy(), y)
    jnorm.transform(jds)
    norm.pre_process(ds)
    np.testing.assert_allclose(ds.features, np.asarray(jds.features),
                               rtol=TOL, atol=TOL)


def _write_idx(path, arr, gz):
    head = struct.pack(">I", 0x0800 | arr.ndim) + struct.pack(
        ">" + "I" * arr.ndim, *arr.shape)
    op = gzip.open if gz else open
    with op(path, "wb") as f:
        f.write(head + arr.astype(np.uint8).tobytes())


@pytest.mark.parametrize("gz", [False, True])
def test_idx_files_read_the_same_in_both_packages(tmp_path, monkeypatch,
                                                  gz):
    r = np.random.RandomState(4)
    sfx = ".gz" if gz else ""
    for prefix, n in (("train", 30), ("t10k", 12)):
        _write_idx(tmp_path / f"{prefix}-images-idx3-ubyte{sfx}",
                   r.randint(0, 256, (n, 28, 28)), gz)
        _write_idx(tmp_path / f"{prefix}-labels-idx1-ubyte{sfx}",
                   r.randint(0, 10, (n,)), gz)
    path = tmp_path / f"train-images-idx3-ubyte{sfx}"
    np.testing.assert_array_equal(tmnist._read_idx(path),
                                  jmnist._read_idx(path))
    monkeypatch.setattr(jmnist, "_SEARCH_DIRS", [str(tmp_path)])
    for train in (True, False):
        jx, jy = jmnist._load_real(train)
        x, y = tmnist._load_real(train, str(tmp_path))
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
    monkeypatch.setenv("DL4J_TORCH_DATA_DIR", str(tmp_path))
    it = tmnist.MnistDataSetIterator(8, train=True, seed=5)
    jit = jmnist.MnistDataSetIterator(8, train=True, seed=5)
    assert not it.synthetic and not jit.synthetic
    for a, b in zip(it, jit):
        np.testing.assert_array_equal(a.features, np.asarray(b.features))
        np.testing.assert_array_equal(a.labels, np.asarray(b.labels))


def test_mnist_without_files_serves_the_surrogate(tmp_path, monkeypatch):
    monkeypatch.delenv("DL4J_TORCH_DATA_DIR", raising=False)
    it = tmnist.MnistDataSetIterator(16, num_examples=32,
                                     data_dir=str(tmp_path))
    assert it.synthetic and it.total_examples() == 32


def test_iris_arrays_equal(monkeypatch):
    monkeypatch.delenv("DL4J_TPU_DATA_DIR", raising=False)
    j, t = jiris._load(), tiris.iris_surrogate()
    np.testing.assert_array_equal(t.features, np.asarray(j.features))
    np.testing.assert_array_equal(t.labels, np.asarray(j.labels))
    for a, b in zip(tiris.IrisDataSetIterator(50),
                    jiris.IrisDataSetIterator(50)):
        np.testing.assert_array_equal(a.features, np.asarray(b.features))
        np.testing.assert_array_equal(a.labels, np.asarray(b.labels))
