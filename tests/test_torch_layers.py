"""The port's layer math against the JAX package's, on the CPU: the
activation functions, every pooling type, the element-wise vertex and
the weight-init distributions. Inputs are numpy from a seed; float32
on both sides, so the tolerance is rtol/atol 1e-5."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.activations import Activation as JAct
from deeplearning4j_tpu.nn.conf import graph_vertices as jv
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu_torch.activations import Activation
from deeplearning4j_tpu_torch.nn.conf import graph_vertices as tv
from deeplearning4j_tpu_torch.nn.conf import layers as tl
from deeplearning4j_tpu_torch.nn.weights import WeightInit
from torch_parity import one_intraop_thread  # noqa: F401,E402

R = np.random.RandomState(21)


@pytest.mark.parametrize("act", [a.name for a in Activation])
def test_activation_matches_jax(act):
    x = (3 * R.randn(4, 16)).astype(np.float32)
    want = np.asarray(JAct[act](jnp.asarray(x)))
    got = Activation[act](torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pool", ["MAX", "AVG", "SUM", "PNORM"])
@pytest.mark.parametrize("mode", ["SAME", "TRUNCATE"])
def test_subsampling_matches_jax(pool, mode):
    x = R.randn(2, 7, 7, 3).astype(np.float32)
    kw = dict(kernel_size=(3, 3), stride=(2, 2), padding=(1, 1))
    j = jl.SubsamplingLayer(pooling_type=jl.PoolingType[pool],
                            convolution_mode=jl.ConvolutionMode[mode], **kw)
    t = tl.SubsamplingLayer(pooling_type=tl.PoolingType[pool],
                            convolution_mode=tl.ConvolutionMode[mode], **kw)
    want, _ = j.forward({}, jnp.asarray(x), training=False)
    got, _ = t.forward({}, torch.from_numpy(x), training=False)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("pool", ["MAX", "AVG", "SUM", "PNORM"])
@pytest.mark.parametrize("shape", [(2, 5, 5, 4), (2, 6, 4), (3, 4)])
def test_global_pooling_matches_jax(pool, shape):
    x = R.randn(*shape).astype(np.float32)
    j = jl.GlobalPoolingLayer(pooling_type=jl.PoolingType[pool])
    t = tl.GlobalPoolingLayer(pooling_type=tl.PoolingType[pool])
    want, _ = j.forward({}, jnp.asarray(x), training=False)
    got, _ = t.forward({}, torch.from_numpy(x), training=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("op", [o.name for o in tv.ElementWiseVertex.Op])
def test_elementwise_vertex_matches_jax(op):
    n = 2 if op == "Subtract" else 3
    xs = [R.randn(2, 3, 3, 4).astype(np.float32) for _ in range(n)]
    want = jv.ElementWiseVertex(jv.ElementWiseVertex.Op[op]).forward(
        [jnp.asarray(x) for x in xs])
    v = tv.ElementWiseVertex(op)
    got = v.forward([torch.from_numpy(x) for x in xs])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert v.to_map() == {"@class": "ElementWiseVertex", "op": op}


def test_dense_and_batchnorm_inference_match_jax():
    x = R.randn(5, 6).astype(np.float32)
    W = R.randn(6, 3).astype(np.float32)
    b = R.randn(3).astype(np.float32)
    jd = jl.DenseLayer(n_in=6, n_out=3, activation="TANH")
    td = tl.DenseLayer(n_in=6, n_out=3, activation="TANH")
    want, _ = jd.forward({"W": jnp.asarray(W), "b": jnp.asarray(b)},
                         jnp.asarray(x), training=False)
    got, _ = td.forward({"W": torch.from_numpy(W), "b": torch.from_numpy(b)},
                        torch.from_numpy(x), training=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    p = {"gamma": 1 + R.rand(6).astype(np.float32),
         "beta": R.randn(6).astype(np.float32)}
    s = {"mean": R.randn(6).astype(np.float32),
         "var": 0.5 + R.rand(6).astype(np.float32)}
    jb = jl.BatchNormalization(activation="RELU")
    tb = tl.BatchNormalization(activation="RELU")
    want, _ = jb.forward({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x), training=False,
                         state={k: jnp.asarray(v) for k, v in s.items()})
    got, _ = tb.forward({k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x), training=False,
                        state={k: torch.from_numpy(v) for k, v in s.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # training normalizes with the batch statistics and blends the
    # running stats by decay from the biased batch variance, as in JAX
    want, wst = jb.forward({k: jnp.asarray(v) for k, v in p.items()},
                           jnp.asarray(x), training=True,
                           state={k: jnp.asarray(v) for k, v in s.items()})
    got, gst = tb.forward({k: torch.from_numpy(v) for k, v in p.items()},
                          torch.from_numpy(x), training=True,
                          state={k: torch.from_numpy(v)
                                 for k, v in s.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    for k in ("mean", "var"):
        np.testing.assert_allclose(gst[k].numpy(), np.asarray(wst[k]),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("wi,std", [
    ("XAVIER", np.sqrt(2.0 / (300 + 100))),
    ("RELU", np.sqrt(2.0 / 300)),
    ("LECUN_NORMAL", np.sqrt(1.0 / 300)),
    ("XAVIER_UNIFORM", np.sqrt(6.0 / 400) / np.sqrt(3)),
    ("RELU_UNIFORM", np.sqrt(6.0 / 300) / np.sqrt(3)),
    ("UNIFORM", 1.0 / np.sqrt(300) / np.sqrt(3)),
])
def test_weight_init_distribution(wi, std):
    """Distributions, not values: torch's generator is not threefry."""
    w = WeightInit[wi].init(torch.Generator().manual_seed(0), (300, 100),
                            300, 100)
    assert abs(float(w.mean())) < 3 * std / np.sqrt(w.numel())
    assert abs(float(w.std()) / std - 1) < 0.02
