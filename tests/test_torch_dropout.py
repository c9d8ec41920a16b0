"""The port's dropout variants and weight noise (``nn/conf/dropout.py``)
against the JAX package's, on the CPU.

``torch.Generator`` streams cannot match ``jax.random``'s, so the bits
are held by injection: the JAX package's mask or noise (recomputed from
the same key, or read off its output as ``y != 0`` on inputs with no
zeros) goes through the port's ``apply_noise`` and must give the JAX
package's output exactly. The port's own draws are held to the
statistics the JAX package's tests hold (``tests/test_dropout_variants
.py``), and to determinism: one key, one mask. The JSON maps cross both
ways, and networks with dropout and weight noise train, with
``output(train=True)`` and ``feed_forward(train=True)`` equal to the JAX
package's (the training forward without a key).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.conf import dropout as jd
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.nn.conf.builders import \
    NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu_torch.activations import Activation
from deeplearning4j_tpu_torch.common.rng import RngKey
from deeplearning4j_tpu_torch.learning.updaters import Adam
from deeplearning4j_tpu_torch.lossfunctions import LossFunction
from deeplearning4j_tpu_torch.nn.conf import dropout as td
from deeplearning4j_tpu_torch.nn.conf import layers as tl
from deeplearning4j_tpu_torch.nn.conf.builders import \
    NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers_recurrent import (
    LSTM, Bidirectional)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.utils.serializer import params_from_jax
from torch_parity import one_intraop_thread  # noqa: F401,E402

KEY = jax.random.PRNGKey(0)


def _x(shape, seed=1):
    """Inputs with no zeros, so a dropped entry is the only zero."""
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    x[x == 0] = 0.5
    return x


# -- the JAX package's randomness injected into the port ------------------
@pytest.mark.parametrize("shape", [(16, 12), (4, 5, 5, 8)],
                         ids=["2d", "nhwc"])
@pytest.mark.parametrize("p", [0.5, 0.8])
def test_dropout_with_the_jax_mask_is_exact(p, shape):
    x = _x(shape)
    want = np.asarray(jd.Dropout(p).apply(jnp.asarray(x), KEY))
    keep = torch.from_numpy(want != 0)
    got = td.Dropout(p).apply_noise(torch.from_numpy(x), keep)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name,kw", [("GaussianDropout", {"rate": 0.3}),
                                     ("GaussianNoise", {"stddev": 0.2})])
def test_gaussian_variants_with_the_jax_noise_are_exact(name, kw):
    x = _x((16, 12))
    want = np.asarray(getattr(jd, name)(**kw).apply(jnp.asarray(x), KEY))
    noise = np.array(jax.random.normal(KEY, x.shape, jnp.float32))
    got = getattr(td, name)(**kw).apply_noise(torch.from_numpy(x),
                                              torch.from_numpy(noise))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("p", [0.9, 0.5])
def test_alpha_dropout_with_the_jax_mask_is_exact(p):
    x = _x((16, 12))
    want = np.asarray(jd.AlphaDropout(p).apply(jnp.asarray(x), KEY))
    keep = np.asarray(jax.random.bernoulli(KEY, p, x.shape))
    got = td.AlphaDropout(p).apply_noise(torch.from_numpy(x),
                                         torch.from_numpy(keep))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(4, 5, 5, 8), (3, 7, 6)],
                         ids=["nhwc", "btf"])
def test_spatial_dropout_with_the_jax_mask_is_exact(shape):
    x = _x(shape)
    want = np.asarray(jd.SpatialDropout(0.5).apply(jnp.asarray(x), KEY))
    kshape = (shape[0],) + (1,) * (len(shape) - 2) + (shape[-1],)
    keep = np.asarray(jax.random.bernoulli(KEY, 0.5, kshape))
    got = td.SpatialDropout(0.5).apply_noise(torch.from_numpy(x),
                                             torch.from_numpy(keep))
    np.testing.assert_array_equal(got.numpy(), want)
    # the port's own draw: one decision per (example, channel)
    mask = td.SpatialDropout(0.5).noise(torch.from_numpy(x), RngKey(4))
    assert tuple(mask.shape) == kshape


def _jax_weight_noise(wn, params, key):
    """The JAX package's draws, in its order: one split per perturbed
    parameter."""
    out = {}
    for name, w in params.items():
        if not wn.apply_to_bias and name in ("b", "gamma", "beta"):
            continue
        key, sub = jax.random.split(key)
        out[name] = (jax.random.bernoulli(sub, wn.p, w.shape)
                     if wn.is_dropconnect
                     else jax.random.normal(sub, w.shape, w.dtype))
    return out


@pytest.mark.parametrize("layer", ["dense", "conv"])
@pytest.mark.parametrize("kw", [
    dict(stddev=0.1), dict(stddev=0.2, additive=False),
    dict(is_dropconnect=True, p=0.7), dict(stddev=0.1, apply_to_bias=True)],
    ids=["additive", "multiplicative", "dropconnect", "bias"])
def test_weight_noise_with_the_jax_noise_is_exact(kw, layer):
    """The conv kernel crosses as ``params_from_jax`` carries it (HWIO
    to OIHW), its noise the same way."""
    if layer == "dense":
        jlayer = jl.DenseLayer(n_in=6, n_out=4)
        conf = (NeuralNetConfiguration.Builder().list()
                .layer(tl.DenseLayer(n_in=6, n_out=4))
                .layer(tl.OutputLayer(n_in=4, n_out=2)).build())
    else:
        jlayer = jl.ConvolutionLayer(n_in=3, n_out=4, kernel_size=(3, 3))
        conf = (NeuralNetConfiguration.Builder().list()
                .layer(tl.ConvolutionLayer(n_in=3, n_out=4,
                                           kernel_size=(3, 3)))
                .layer(tl.OutputLayer(n_in=4, n_out=2)).build())
    jp = jlayer.init_params(jax.random.PRNGKey(2), None)
    jp["b"] = jp["b"] + 0.25
    jwn, twn = jd.WeightNoise(**kw), td.WeightNoise(**kw)
    want = jwn.apply(jp, KEY)
    noise = _jax_weight_noise(jwn, jp, KEY)

    def port(tree):
        return params_from_jax({"layer_0": {n: np.asarray(a) for n, a in
                                            tree.items()},
                                "layer_1": {}}, {}, conf)[0]["layer_0"]
    got = twn.apply_noise(port(jp), port(noise))
    assert set(got) == set(jp)
    for n, t in port(want).items():
        np.testing.assert_array_equal(got[n].numpy(), t.numpy(), err_msg=n)
    if not kw.get("apply_to_bias"):
        assert "b" not in twn.noise(port(jp), RngKey(1))


# -- the port's own draws ---------------------------------------------------
def test_one_key_one_mask():
    x = torch.from_numpy(_x((64, 32)))
    a = td.Dropout(0.5).apply(x, RngKey(3))
    assert torch.equal(a, td.Dropout(0.5).apply(x, RngKey(3)))
    assert not torch.equal(a, td.Dropout(0.5).apply(x, RngKey(4)))
    k = RngKey(9)
    assert k.fold_in(1) == RngKey(9).fold_in(1) != k.fold_in(2)
    assert len(set(k.split(3)) | {k.fold_in(0), k.fold_in(1)}) == 5


X = torch.from_numpy(np.random.RandomState(1).randn(512, 64)
                     .astype(np.float32))


def test_dropout_zeroes_and_scales():
    y = td.Dropout(p=0.8).apply(X, RngKey(0))
    frac_zero = float((y == 0).float().mean())
    assert 0.1 < frac_zero < 0.3          # ~20% dropped
    kept = y != 0
    np.testing.assert_allclose(y[kept].numpy(), (X[kept] / 0.8).numpy(),
                               rtol=1e-6)


def test_gaussian_dropout_mean_preserving():
    y = td.GaussianDropout(rate=0.2).apply(torch.ones(200_000), RngKey(0))
    assert abs(float(y.mean()) - 1.0) < 0.01
    assert abs(float(y.std()) - 0.5) < 0.02      # sqrt(0.2/0.8)


def test_gaussian_noise_additive():
    y = td.GaussianNoise(stddev=0.3).apply(torch.zeros(200_000), RngKey(0))
    assert abs(float(y.mean())) < 0.01
    assert abs(float(y.std()) - 0.3) < 0.01


def test_alpha_dropout_preserves_moments():
    big = torch.randn(500_000, generator=torch.Generator().manual_seed(0))
    y = td.AlphaDropout(p=0.9).apply(big, RngKey(7))
    assert abs(float(y.mean())) < 0.02
    assert abs(float(y.std()) - 1.0) < 0.02


def test_spatial_dropout_drops_whole_channels():
    y = td.SpatialDropout(p=0.5).apply(torch.ones(8, 5, 5, 16), RngKey(0))
    per_chan = y.reshape(8, 25, 16).numpy()
    all_zero = (per_chan == 0).all(axis=1)
    all_kept = (per_chan == 2.0).all(axis=1)
    assert np.all(all_zero | all_kept)
    assert 0.2 < all_zero.mean() < 0.8


def test_dropconnect_zeroes_weights():
    wn = td.WeightNoise(is_dropconnect=True, p=0.5)
    out = wn.apply({"W": torch.ones(10, 10), "b": torch.ones(10)},
                   RngKey(0))
    w = out["W"].numpy()
    assert set(np.unique(w)).issubset({0.0, 2.0})
    assert 0.2 < (w == 0).mean() < 0.8
    np.testing.assert_array_equal(out["b"].numpy(), 1.0)


# -- JSON -------------------------------------------------------------------
VARIANTS = [("Dropout", {"p": 0.7}), ("GaussianDropout", {"rate": 0.3}),
            ("GaussianNoise", {"stddev": 0.2}), ("AlphaDropout", {"p": 0.9}),
            ("SpatialDropout", {"p": 0.6})]


@pytest.mark.parametrize("name,kw", VARIANTS, ids=[v[0] for v in VARIANTS])
def test_layer_json_with_dropout_and_weight_noise_crosses_both_ways(name,
                                                                    kw):
    jlayer = jl.DenseLayer(n_in=4, n_out=3, dropout=getattr(jd, name)(**kw),
                           weight_noise=jd.WeightNoise(stddev=0.1,
                                                       additive=False))
    m = jlayer.to_map()
    back = tl.Layer.from_map(m)
    assert isinstance(back.dropout, getattr(td, name))
    assert isinstance(back.weight_noise, td.WeightNoise)
    assert back.to_map() == m
    assert jl.Layer.from_map(back.to_map()).to_map() == m


def test_float_dropout_and_builder_defaults_cross():
    wn = td.WeightNoise(stddev=0.05)
    conf = (NeuralNetConfiguration.Builder().dropout(0.8).weight_noise(wn)
            .list().layer(tl.DenseLayer(n_in=4, n_out=3))
            .layer(tl.OutputLayer(n_in=3, n_out=2, dropout=0.6)).build())
    assert conf.layers[0].dropout == 0.8 and conf.layers[1].dropout == 0.6
    assert conf.layers[0].weight_noise is wn
    from deeplearning4j_tpu.nn.conf.builders import \
        MultiLayerConfiguration as JConf
    from deeplearning4j_tpu_torch.nn.conf.builders import \
        MultiLayerConfiguration
    j = JConf.from_json(conf.to_json())
    assert isinstance(j.layers[0].weight_noise, jd.WeightNoise)
    again = MultiLayerConfiguration.from_json(j.to_json())
    assert again.to_json() == conf.to_json()


# -- in a network -----------------------------------------------------------
def _net(**layer_kw):
    conf = (NeuralNetConfiguration.Builder().seed(0).updater(Adam(1e-2))
            .list()
            .layer(tl.DenseLayer(n_out=16, activation=Activation.RELU,
                                 **layer_kw))
            .layer(tl.OutputLayer(n_out=2, loss_function=LossFunction.MCXENT,
                                  activation=Activation.SOFTMAX))
            .set_input_type(InputType.feed_forward(4)).build())
    return MultiLayerNetwork(conf).init("cpu")


def _xy(n):
    rs = np.random.RandomState(0)
    xs = rs.randn(n, 4).astype(np.float32)
    ys = (xs[:, 0] > 0).astype(int)
    return xs, ys, np.eye(2, dtype=np.float32)[ys]


def test_gaussian_dropout_trains():
    xs, ys, labels = _xy(128)
    net = _net(dropout=td.GaussianDropout(rate=0.1))
    for _ in range(60):
        net.fit(xs, labels)
    assert (net.output(xs).argmax(-1).numpy() == ys).mean() > 0.9


def test_weight_noise_training_vs_inference():
    """Noise perturbs training forwards only; inference is clean and
    deterministic, and training with small noise still converges."""
    xs, ys, labels = _xy(16)
    net = _net(weight_noise=td.WeightNoise(stddev=0.5))
    assert torch.equal(net.output(xs), net.output(xs))
    net2 = _net(weight_noise=td.WeightNoise(stddev=0.02))
    for _ in range(80):
        net2.fit(xs, labels)
    assert (net2.output(xs).argmax(-1).numpy() == ys).mean() > 0.85


def test_weight_noise_gradients_reach_the_clean_parameters():
    """A step under DropConnect updates every weight, kept or dropped in
    the step's forward, from the clean parameters' gradients."""
    xs, _, labels = _xy(16)
    net = _net(weight_noise=td.WeightNoise(is_dropconnect=True, p=0.5))
    w0 = net.params["layer_0"]["W"].clone()
    net.fit(xs, labels)
    assert np.isfinite(net.score())
    assert not torch.equal(net.params["layer_0"]["W"], w0)


def _bn_pair():
    """A small dense + BatchNormalization stack with dropout in both
    packages, the JAX package's weights carried across."""
    def build(pkg, NNC, IT, L):
        return (NNC.Builder().seed(3).list()
                .layer(L.DenseLayer(n_out=8, dropout=0.5,
                                    activation=pkg.RELU))
                .layer(L.BatchNormalization())
                .layer(L.OutputLayer(n_out=3, dropout=0.7))
                .set_input_type(IT.feed_forward(5)).build())
    from deeplearning4j_tpu.activations import Activation as JAct
    jnet = JMLN(build(JAct, JNNC, JInputType, jl)).init()
    conf = build(Activation, NeuralNetConfiguration, InputType, tl)
    p, s = params_from_jax(
        {k: {n: np.asarray(a) for n, a in sub.items()}
         for k, sub in jnet.params.items()},
        {k: {n: np.asarray(a) for n, a in sub.items()}
         for k, sub in jnet.states.items()}, conf)
    return jnet, MultiLayerNetwork(conf).set_params(p, s, "cpu")


def test_output_and_feed_forward_in_training_mode_match_jax():
    """``train=True``: batch statistics, and no dropout (no key), as in
    the JAX package; inference mode differs (running statistics)."""
    jnet, net = _bn_pair()
    x = _x((6, 5))
    want = np.asarray(jnet.output(jnp.asarray(x), train=True))
    np.testing.assert_allclose(net.output(x, train=True).numpy(), want,
                               rtol=2e-5, atol=1e-6)
    assert not np.allclose(net.output(x).numpy(), want, atol=1e-4)
    jacts = jnet.feed_forward(jnp.asarray(x), train=True)
    acts = net.feed_forward(x, train=True)
    assert len(acts) == len(jacts) == 4
    for a, b in zip(acts, jacts):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5,
                                   atol=1e-6)


def test_bidirectional_draws_independent_masks_per_direction():
    """Input dropout on the wrapped layer: each direction gets its own
    key (a split of the layer's), so its own mask."""
    layer = Bidirectional(fwd=LSTM(n_in=6, n_out=5, dropout=0.5))
    params = layer.init_params(torch.Generator().manual_seed(0),
                               InputType.recurrent(6, 4))
    x = torch.from_numpy(_x((3, 4, 6)))
    rng = RngKey(2)
    y, _ = layer.forward(params, x, training=True, rng=rng)
    r_f, r_b = rng.split()
    fwd = {n[4:]: t for n, t in params.items() if n.startswith("fwd/")}
    bwd = {n[4:]: t for n, t in params.items() if n.startswith("bwd/")}
    y_f, _ = layer.fwd.forward(fwd, x, training=True, rng=r_f)
    y_b, _ = layer.fwd.forward(bwd, torch.flip(x, (1,)), training=True,
                               rng=r_b)
    assert torch.equal(y, torch.cat([y_f, torch.flip(y_b, (1,))], -1))
    m_f = td.Dropout(0.5).noise(x, r_f)
    m_b = td.Dropout(0.5).noise(torch.flip(x, (1,)), r_b)
    assert not torch.equal(m_f, torch.flip(m_b, (1,)))
    clean, _ = layer.forward(params, x, training=True)
    assert not torch.equal(y, clean)
