"""The port's SqueezeNet slice against the JAX package, on the CPU.

The JAX package builds and initialises a small SqueezeNet (10 classes,
64x64x3 input, the zoo's architecture otherwise); its parameters cross
to the port through ``params_from_jax`` or a ModelSerializer zip, and
both sides run the same numpy input. Tolerance rtol 1e-4 / atol 1e-5 on
softmax outputs: both compute in float32 and sum convolutions in
different orders. The port runs with its conv-epilogue gate forced on
(pointwise sites through ``matmul_bias_act``'s plain version, the others
through conv + ``scale_shift_act``) and killed (``conv2d`` with bias).
"""
import io
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.zoo_extra import SqueezeNet as JaxSqueezeNet
from deeplearning4j_tpu.nn.conf import graph_vertices as jv
from deeplearning4j_tpu.nn.conf import inputs as ji
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.utils import ModelSerializer as JaxSerializer
from deeplearning4j_tpu_torch.common import telemetry
from deeplearning4j_tpu_torch.common.rng import RngKey
from deeplearning4j_tpu_torch.common.environment import Environment
from deeplearning4j_tpu_torch.models import SqueezeNet
from deeplearning4j_tpu_torch.nn.conf import graph_vertices as tv
from deeplearning4j_tpu_torch.nn.conf import inputs as ti
from deeplearning4j_tpu_torch.nn.conf import layers as tl
from deeplearning4j_tpu_torch.nn.conf.dropout import Dropout
from deeplearning4j_tpu_torch.nn.conf.graph_conf import \
    ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.serving import InferenceServer, ModelRegistry
from deeplearning4j_tpu_torch.utils import ModelSerializer
from deeplearning4j_tpu_torch.utils.serializer import (params_from_jax,
                                                       params_to_jax)
from torch_parity import one_intraop_thread  # noqa: F401,E402

RTOL, ATOL = 1e-4, 1e-5
SMALL = dict(num_classes=10, height=64, width=64)


@pytest.fixture(autouse=True)
def _clean_extra(monkeypatch):
    monkeypatch.delenv("DL4J_TORCH_FUSED_CONV", raising=False)
    env = Environment.get()
    saved = env.extra.pop("fused_conv", None)
    yield
    env.extra.pop("fused_conv", None)
    if saved is not None:
        env.extra["fused_conv"] = saved


def _np_tree(tree):
    return {k: {n: np.asarray(a) for n, a in sub.items()}
            for k, sub in tree.items()}


@pytest.fixture(scope="module")
def jax_net():
    """The JAX-initialised SqueezeNet, its biases set from a seed (the
    zoo initialises them to 0) so the epilogue's bias is exercised, and
    one numpy input with the JAX output for it."""
    jnet = JaxSqueezeNet(**SMALL).init()
    r = np.random.RandomState(11)
    params = _np_tree(jnet.params)
    for sub in params.values():
        if "b" in sub:
            sub["b"] = (0.05 * r.randn(*sub["b"].shape)).astype(np.float32)
    jnet.params = {k: {n: jnp.asarray(a) for n, a in sub.items()}
                   for k, sub in params.items()}
    x = r.randn(4, 64, 64, 3).astype(np.float32)
    return jnet, params, x, np.asarray(jnet.output(x))


def _port_net(jnet, params):
    conf = SqueezeNet(**SMALL).conf()
    p, s = params_from_jax(params, _np_tree(jnet.states), conf)
    return ComputationGraph(conf).set_params(p, s, "cpu")


def _sites():
    c = telemetry.counter("dl4j_conv_fused_steps_total")
    return {s: c.value(site=s) for s in ("conv", "conv_matmul")}


# 1 -------------------------------------------------------------------------
@pytest.mark.parametrize("types", [
    [("convolutional", (5, 6, 16)), ("convolutional", (5, 6, 48))],
    [("recurrent", (7, 9)), ("recurrent", (3, 9))],
    [("feed_forward", (4,)), ("feed_forward", (6,)), ("feed_forward", (1,))],
])
def test_merge_vertex_matches_jax(types):
    r = np.random.RandomState(len(types))
    j_types = [getattr(ji.InputType, kind)(*a) for kind, a in types]
    t_types = [getattr(ti.InputType, kind)(*a) for kind, a in types]
    assert (jv.MergeVertex().get_output_type(j_types).to_map()
            == tv.MergeVertex().get_output_type(t_types).to_map())
    shapes = [(2, 5, 6, 16), (2, 5, 6, 48)] if types[0][0] == \
        "convolutional" else [(2, 3, k) for k in (9, 9)] \
        if types[0][0] == "recurrent" else [(2, 4), (2, 6), (2, 1)]
    xs = [r.randn(*s).astype(np.float32) for s in shapes]
    want = np.asarray(jv.MergeVertex().forward([jnp.asarray(a) for a in xs]))
    got = tv.MergeVertex().forward([torch.from_numpy(a) for a in xs])
    np.testing.assert_array_equal(got.numpy(), want)
    m = tv.MergeVertex().to_map()
    assert m == jv.MergeVertex().to_map()
    assert isinstance(tv.GraphVertex.from_map(m), tv.MergeVertex)


def test_dropout_layer_matches_jax():
    """The identity at inference, and in training without a key (the
    JAX package's ``rng=None``); ``dropout`` is the retain probability:
    with a key, the JAX package's mask applied by the port gives the
    JAX package's output exactly."""
    jd, td = jl.DropoutLayer(dropout=0.5), tl.DropoutLayer(dropout=0.5)
    assert not td.has_params() and td.dropout == jd.dropout == 0.5
    assert tl.DropoutLayer().dropout == jl.DropoutLayer().dropout
    t = ti.InputType.convolutional(4, 4, 8)
    assert td.get_output_type(t) is t
    assert jd.get_output_type(ji.InputType.convolutional(4, 4, 8)) \
        .to_map() == t.to_map()
    x = np.random.RandomState(0).randn(2, 4, 4, 8).astype(np.float32)
    want, _ = jd.forward({}, jnp.asarray(x), training=False)
    got, _ = td.forward({}, torch.from_numpy(x), training=False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got, _ = td.forward({}, torch.from_numpy(x), training=True)
    np.testing.assert_array_equal(got.numpy(), x)
    want, _ = jd.forward({}, jnp.asarray(x), training=True,
                         rng=jax.random.PRNGKey(3))
    want = np.asarray(want)
    keep = torch.from_numpy(want != 0)
    got = Dropout(0.5).apply_noise(torch.from_numpy(x), keep)
    np.testing.assert_array_equal(got.numpy(), want)
    got, _ = td.forward({}, torch.from_numpy(x), training=True,
                        rng=RngKey(3))
    kept = got != 0
    assert 0.3 < float(kept.float().mean()) < 0.7
    np.testing.assert_array_equal(
        got.numpy(), np.where(kept.numpy(), x / 0.5, 0.0))
    m = jd.to_map()
    back = tl.Layer.from_map(m)
    assert isinstance(back, tl.DropoutLayer) and back.to_map() == m


# 2 -------------------------------------------------------------------------
def test_squeezenet_config_json_is_the_jax_packages(jax_net):
    jnet = jax_net[0]
    conf = SqueezeNet(**SMALL).conf()
    assert json.loads(conf.to_json()) == json.loads(jnet.conf.to_json())
    read = ComputationGraphConfiguration.from_json(jnet.conf.to_json())
    assert json.loads(read.to_json()) == json.loads(jnet.conf.to_json())


def test_full_width_pointwise_sites():
    """The full-width net's 17 pointwise sites at batch 32, as (M, K, N):
    the squeeze and expand-1x1 convs at 56, 28 and 14 pixels and the
    1000-class head."""
    conf = SqueezeNet().conf()
    types = conf.resolve_shapes()
    sites = []
    for name in conf.topo_order():
        v = conf.vertices[name]
        if isinstance(v.content, tl.ConvolutionLayer) and \
                v.content.kernel_size == (1, 1):
            t, k = types[name], types[v.inputs[0]].channels
            sites.append((32 * t.height * t.width, k, t.channels))
    assert sites == [
        (100352, 64, 16), (100352, 16, 64), (100352, 128, 16),
        (100352, 16, 64), (100352, 128, 32), (100352, 32, 128),
        (25088, 256, 32), (25088, 32, 128), (25088, 256, 48),
        (25088, 48, 192), (25088, 384, 48), (25088, 48, 192),
        (25088, 384, 64), (25088, 64, 256), (6272, 512, 64),
        (6272, 64, 256), (6272, 512, 1000)]


@pytest.mark.parametrize("gate", ["1", "0"])
def test_jax_initialised_squeezenet_matches(jax_net, gate):
    jnet, params, x, want = jax_net
    net = _port_net(jnet, params)
    assert net.params["fire0_sq"]["W"].shape == (16, 64, 1, 1)   # OIHW
    Environment.get().extra["fused_conv"] = gate
    n0 = _sites()
    got = net.output(x).numpy()
    d = {s: v - n0[s] for s, v in _sites().items()}
    assert d == ({"conv": 9, "conv_matmul": 17} if gate == "1"
                 else {"conv": 0, "conv_matmul": 0})
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert (got.argmax(-1) == want.argmax(-1)).all()


def test_params_round_trip_to_jax(jax_net):
    jnet, params, _, _ = jax_net
    net = _port_net(jnet, params)
    back = params_to_jax(net.params, net.conf)
    flat = {f"{k}/{n}": a for k, sub in params.items()
            for n, a in sub.items()}
    assert sorted(back) == sorted(flat)
    for key, a in flat.items():
        np.testing.assert_array_equal(back[key], a)


def test_jax_written_zip_restores_in_the_port(jax_net, tmp_path):
    jnet, _, x, want = jax_net
    path = tmp_path / "squeezenet.zip"
    JaxSerializer.write_model(jnet, str(path))
    net = ModelSerializer.restore_model(path, device="cpu")
    np.testing.assert_allclose(net.output(x).numpy(), want, rtol=RTOL,
                               atol=ATOL)
    assert json.loads(net.conf.to_json()) == json.loads(jnet.conf.to_json())


# 3 -------------------------------------------------------------------------
@pytest.mark.parametrize("image", [32, 48, 75])
def test_forward_dispatches_17_matmul_and_9_conv_sites(image, monkeypatch):
    """Under DL4J_TORCH_FUSED_CONV=1, at any image size: the 16
    fire-module 1x1 convs and the 1x1 classifier are pointwise, the stem
    and the 8 expand-3x3 convs are not; nothing else reaches the
    conv-epilogue family."""
    net = SqueezeNet(num_classes=10, height=image, width=image).init("cpu")
    x = np.random.RandomState(image).randn(2, image, image, 3).astype(
        np.float32)
    plain = net.output(x).numpy()
    monkeypatch.setenv("DL4J_TORCH_FUSED_CONV", "1")
    n0 = _sites()
    fused = net.output(x).numpy()
    d = {s: v - n0[s] for s, v in _sites().items()}
    assert d == {"conv": 9, "conv_matmul": 17}
    assert fused.shape == (2, 10)
    np.testing.assert_allclose(fused, plain, rtol=RTOL, atol=ATOL)


def test_training_raises_at_the_dropout_layer():
    """Dropout is ported, so training no longer raises at the dropout
    layer: a fit step runs with the layer active (its masks from the
    step's key), gives a finite loss and moves every parameter, and the
    same step from the same weights and key repeats bit for bit."""
    x = np.random.RandomState(1).randn(2, 32, 32, 3).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[[1, 2]]
    nets = [SqueezeNet(num_classes=10, height=32, width=32).init("cpu")
            for _ in range(2)]
    before = {k: {n: t.clone() for n, t in sub.items()}
              for k, sub in nets[0].params.items()}
    for net in nets:
        net.fit(x, y)
    assert np.isfinite(nets[0].score())
    assert nets[0].score() == nets[1].score()
    for k, sub in before.items():
        for n, t in sub.items():
            assert not torch.equal(nets[0].params[k][n], t), (k, n)
            assert torch.equal(nets[0].params[k][n], nets[1].params[k][n])


def test_served_squeezenet_equals_net_output():
    """Registry -> batcher -> HTTP on the CPU: a JSON request at bucket 4
    and an npy batch of 4 answer exactly what ``net.output`` gives at
    that bucket."""
    net = SqueezeNet(num_classes=10, height=32, width=32).init("cpu")
    reg = ModelRegistry("cpu", default_buckets=(4,))
    ver = reg.register("squeezenet", net, warmup_shape=(32, 32, 3))
    server = InferenceServer(reg).start(port=0)
    try:
        url = f"{server.url}/v1/models/squeezenet:predict"
        r = np.random.RandomState(5)
        x1 = r.randn(1, 32, 32, 3).astype(np.float32)
        req = urllib.request.Request(
            url, data=json.dumps({"inputs": x1.tolist()}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            doc = json.loads(resp.read())
        want = net.output(np.repeat(x1, 4, axis=0)).numpy()[:1]
        np.testing.assert_array_equal(
            np.asarray(doc["outputs"], np.float32), want)
        x4 = r.randn(4, 32, 32, 3).astype(np.float32)
        buf = io.BytesIO()
        np.save(buf, x4)
        req = urllib.request.Request(
            url, data=buf.getvalue(),
            headers={"Content-Type": "application/octet-stream"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            got = np.load(io.BytesIO(resp.read()))
        np.testing.assert_array_equal(got, net.output(x4).numpy())
        assert ver.retraces_since_warmup() == 0
    finally:
        server.stop()
        reg.shutdown()


def test_five_training_steps_with_dropout_at_retain_one_match_jax():
    """Training SqueezeNet (32x32, 10 classes) through its dropout layer
    at retain probability 1.0 (the mask keeps every entry in both
    packages), 5 Sgd(0.01) steps on seeded batches from the JAX
    package's weights: the loss at every step and the parameters at the
    reference's gradient bar, rtol 2e-4 / atol 1e-5. (The zoo's Adam
    turns gradient entries at the two backends' summation noise into
    steps of the full lr, tests/test_torch_training.py says why, and
    from these random weights Nesterovs(0.01, 0.9) overshoots to a loss
    of ~68 at its third step.)"""
    small = dict(num_classes=10, height=32, width=32)
    from deeplearning4j_tpu.learning.updaters import Sgd as JSgd
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JCG
    from deeplearning4j_tpu_torch.learning.updaters import Sgd
    jconf = JaxSqueezeNet(**small).init().conf
    conf = SqueezeNet(**small).conf()
    for c, up in ((jconf, JSgd(0.01)), (conf, Sgd(0.01))):
        c.vertices["drop"].content.dropout = 1.0
        c.updater = up
        for v in c.vertices.values():
            if v.is_layer:
                v.content.updater = up
    jnet = JCG(jconf).init()
    assert json.loads(conf.to_json()) == json.loads(jconf.to_json())
    p, s = params_from_jax(_np_tree(jnet.params), _np_tree(jnet.states),
                           conf)
    net = ComputationGraph(conf).set_params(p, s, "cpu")
    r = np.random.RandomState(12)
    for step in range(5):
        x = r.randn(4, 32, 32, 3).astype(np.float32)
        y = np.eye(10, dtype=np.float32)[r.randint(0, 10, 4)]
        jnet.fit(x, y)
        net.fit(x, y)
        np.testing.assert_allclose(net.score(), float(jnet.score()),
                                   rtol=2e-4, atol=1e-5, err_msg=step)
    got = params_to_jax(net.params, conf)
    want = params_to_jax(params_from_jax(_np_tree(jnet.params), {},
                                         conf)[0], conf)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=1e-5,
                                   err_msg=k)
