"""The port's SameDiff layers (``nn/conf/layers_samediff.py``) against the
JAX package's, on the CPU: the six cases of ``tests/test_samediff_layers.py``
(a custom dense layer against the built-in one, training inside a
``MultiLayerNetwork``, gradients reaching the custom parameters, a custom
regression head, a custom vertex alone and inside a ``ComputationGraph``),
each also held against the JAX package on the same numpy inputs with the
parameters carried across by ``params_from_jax``; the configurations'
JSON and ``ModelSerializer`` zips round-trip; a layer taking the
features mask runs its attention through the flash route.

Tolerances: forward rtol 2e-5, gradients and short trajectories rtol
2e-4 (float32 sums in other orders).
"""
import json
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.activations import Activation as JAct
from deeplearning4j_tpu.learning import Adam as JAdam
from deeplearning4j_tpu.lossfunctions import LossFunction as JLoss
from deeplearning4j_tpu.nn import InputType as JIT
from deeplearning4j_tpu.nn import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf import layers_samediff as jsd
from deeplearning4j_tpu.nn.conf.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.conf.layers import OutputLayer as JOutput
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu_torch.activations import Activation
from deeplearning4j_tpu_torch.common.environment import Environment
from deeplearning4j_tpu_torch.learning.updaters import Adam
from deeplearning4j_tpu_torch.lossfunctions import LossFunction
from deeplearning4j_tpu_torch.nn.conf.builders import (
    MultiLayerConfiguration, NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.conf.graph_conf import \
    ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.conf.graph_vertices import register_vertex
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (DenseLayer, OutputLayer,
                                                     register_layer)
from deeplearning4j_tpu_torch.nn.conf.layers_samediff import (
    SameDiffLayer, SameDiffOutputLayer, SameDiffVertex)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.utils.serializer import (ModelSerializer,
                                                       params_from_jax,
                                                       params_to_jax)
from torch_parity import one_intraop_thread  # noqa: F401,E402

FWD = dict(rtol=2e-5, atol=2e-6)
GRAD = dict(rtol=2e-4, atol=1e-6)


# -- the custom layers, once for each package ---------------------------------
@register_layer
@dataclass
class SDDense(SameDiffLayer):
    """Custom dense layer built from the SameDiff graph API."""

    def define_parameters(self):
        return {"W": (self.n_in, self.n_out), "b": (self.n_out,)}

    def define_layer(self, sd, layer_input, params):
        return sd.nn.relu(layer_input.mmul(params["W"]) + params["b"])


@register_layer
@dataclass
class SDMseOutput(SameDiffOutputLayer):
    """Custom linear output head."""

    def define_parameters(self):
        return {"W": (self.n_in, self.n_out)}

    def define_layer(self, sd, layer_input, params):
        return layer_input.mmul(params["W"])


@register_vertex
class GatedSumVertex(SameDiffVertex):
    """sigmoid(a) * b — custom 2-input vertex."""

    def define_vertex(self, sd, inputs):
        a, b = inputs
        return sd.nn.sigmoid(a).mul(b)


def _dense_params(self):
    return {"W": (self.n_in, self.n_out), "b": (self.n_out,)}


def _dense_layer(self, sd, layer_input, params):
    return sd.nn.relu(layer_input.mmul(params["W"]) + params["b"])


def _head_params(self):
    return {"W": (self.n_in, self.n_out)}


def _head_layer(self, sd, layer_input, params):
    return layer_input.mmul(params["W"])


def _gate(self, sd, inputs):
    a, b = inputs
    return sd.nn.sigmoid(a).mul(b)


# the JAX package's classes of the same names, so either package's JSON
# names a class the other has registered
JSDDense = dataclass(type("SDDense", (jsd.SameDiffLayer,), {
    "define_parameters": _dense_params, "define_layer": _dense_layer}))
JSDMseOutput = dataclass(type("SDMseOutput", (jsd.SameDiffOutputLayer,), {
    "define_parameters": _head_params, "define_layer": _head_layer}))
JGatedSumVertex = type("GatedSumVertex", (jsd.SameDiffVertex,),
                       {"define_vertex": _gate})


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_of(jnet, conf):
    """The port's network of a JAX network: ``conf`` (the port's same
    configuration) with the JAX parameters carried across."""
    p, s = params_from_jax(_np_tree(jnet.params), _np_tree(jnet.states),
                           conf)
    cls = ComputationGraph if isinstance(jnet, JGraph) else \
        MultiLayerNetwork
    return cls(conf).set_params(p, s, "cpu")


def _same_params(jnet, net, **tol):
    want = params_to_jax(params_from_jax(_np_tree(jnet.params), {},
                                         net.conf)[0], net.conf)
    got = params_to_jax(net.params, net.conf)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def _classifier_data():
    rng = np.random.RandomState(0)
    xs = rng.randn(128, 4).astype(np.float32)
    ys = (xs[:, 0] + xs[:, 1] > 0).astype(int)
    return xs, ys, np.eye(2, dtype=np.float32)[ys]


def _classifier(jax_side: bool):
    nnc, it = (JNNC, JIT) if jax_side else (NeuralNetConfiguration,
                                            InputType)
    dense, out = (JSDDense, JOutput) if jax_side else (SDDense, OutputLayer)
    act, loss = (JAct, JLoss) if jax_side else (Activation, LossFunction)
    up = JAdam if jax_side else Adam
    return (nnc.Builder().seed(0).updater(up(1e-2)).list()
            .layer(dense(n_out=16))
            .layer(out(n_out=2, loss_function=loss.MCXENT,
                       activation=act.SOFTMAX))
            .set_input_type(it.feed_forward(4)).build())


class TestSameDiffLayer:
    def test_matches_builtin_dense(self):
        """SDDense forward == DenseLayer forward given identical params,
        and == the JAX package's SDDense."""
        sd_layer = SDDense(n_in=4, n_out=8)
        dense = DenseLayer(n_in=4, n_out=8, activation=Activation.RELU)
        p = dense.init_params(torch.Generator().manual_seed(0),
                              InputType.feed_forward(4))
        x = np.random.RandomState(0).randn(6, 4).astype(np.float32)
        y_ref, _ = dense.forward(p, torch.from_numpy(x), training=False)
        y_sd, _ = sd_layer.forward(p, torch.from_numpy(x), training=False)
        np.testing.assert_allclose(y_sd.numpy(), y_ref.numpy(), **FWD)
        jy, _ = JSDDense(n_in=4, n_out=8).forward(
            {k: jnp.asarray(v.numpy()) for k, v in p.items()},
            jnp.asarray(x), training=False)
        np.testing.assert_allclose(y_sd.numpy(), np.asarray(jy), **FWD)

    def test_trains_in_network(self):
        """The JSON of the JAX package's network reads in the port; four
        Adam steps follow the JAX package's, and the port's network
        learns the task."""
        xs, ys, labels = _classifier_data()
        jnet = JMLN(_classifier(True)).init()
        conf = MultiLayerConfiguration.from_json(jnet.conf.to_json())
        assert json.loads(conf.to_json()) == json.loads(jnet.conf.to_json())
        net = _port_of(jnet, conf)
        for _ in range(4):
            jnet.fit(xs, labels)
            net.fit(xs, labels)
        _same_params(jnet, net, **GRAD)
        for _ in range(56):
            net.fit(xs, labels)
        acc = (net.output(xs).numpy().argmax(-1) == ys).mean()
        assert acc > 0.9

    def test_gradients_flow_to_custom_params(self):
        layer = SDDense(n_in=3, n_out=8)
        p = layer.init_params(torch.Generator().manual_seed(0),
                              InputType.feed_forward(3))
        x = np.random.RandomState(1).randn(16, 3).astype(np.float32)
        leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        y, _ = layer.forward(leaves, torch.from_numpy(x), training=True)
        (y ** 2).sum().backward()
        assert float(leaves["W"].grad.abs().sum()) > 0.0
        assert float(leaves["b"].grad.abs().sum()) > 0.0
        jl = JSDDense(n_in=3, n_out=8)

        def loss(pp):
            yy, _ = jl.forward(pp, jnp.asarray(x), training=True)
            return jnp.sum(yy ** 2)

        jg = jax.grad(loss)({k: jnp.asarray(v.numpy())
                             for k, v in p.items()})
        for k in p:
            np.testing.assert_allclose(leaves[k].grad.numpy(),
                                       np.asarray(jg[k]), **GRAD)


class TestSameDiffOutputLayer:
    def test_regression_head(self):
        rng = np.random.RandomState(0)
        xs = rng.randn(128, 3).astype(np.float32)
        w_true = np.array([[1.0], [-2.0], [0.5]], np.float32)
        ys = xs @ w_true

        def conf(jax_side):
            nnc, it = (JNNC, JIT) if jax_side else (NeuralNetConfiguration,
                                                    InputType)
            head = JSDMseOutput if jax_side else SDMseOutput
            loss, act = (JLoss, JAct) if jax_side else (LossFunction,
                                                        Activation)
            return (nnc.Builder().seed(0)
                    .updater((JAdam if jax_side else Adam)(5e-2)).list()
                    .layer(head(n_out=1, loss_function=loss.MSE,
                                activation=act.IDENTITY))
                    .set_input_type(it.feed_forward(3)).build())

        jnet = JMLN(conf(True)).init()
        net = _port_of(jnet, conf(False))
        for _ in range(3):
            jnet.fit(xs, ys)
            net.fit(xs, ys)
        _same_params(jnet, net, **GRAD)
        for _ in range(97):
            net.fit(xs, ys)
        np.testing.assert_allclose(net.params["layer_0"]["W"].numpy(),
                                   w_true, atol=0.05)


def _gate_graph(jax_side: bool):
    nnc, it = (JNNC, JIT) if jax_side else (NeuralNetConfiguration,
                                            InputType)
    dense, out = (JDense, JOutput) if jax_side else (DenseLayer, OutputLayer)
    act, loss = (JAct, JLoss) if jax_side else (Activation, LossFunction)
    g = (nnc.Builder().seed(0)
         .updater((JAdam if jax_side else Adam)(1e-2)).graph_builder())
    g.add_inputs("in")
    g.add_layer("d1", dense(n_out=4, activation=act.IDENTITY), "in")
    g.add_layer("d2", dense(n_out=4, activation=act.IDENTITY), "in")
    g.add_vertex("gate", JGatedSumVertex() if jax_side
                 else GatedSumVertex(), "d1", "d2")
    g.add_layer("out", out(n_out=2, loss_function=loss.MCXENT,
                           activation=act.SOFTMAX), "gate")
    g.set_outputs("out")
    g.set_input_types(it.feed_forward(3))
    return g.build()


class TestSameDiffVertex:
    def test_gated_sum_in_graph(self):
        out = GatedSumVertex().forward([torch.ones(2, 3),
                                        torch.full((2, 3), 2.0)])
        np.testing.assert_allclose(out.numpy(), 2.0 / (1.0 + np.exp(-1.0)),
                                   **FWD)

    def test_inside_computation_graph(self):
        """The gated graph's outputs and two Adam steps against the JAX
        package's graph."""
        jg = JGraph(_gate_graph(True)).init()
        net = _port_of(jg, _gate_graph(False))
        rs = np.random.RandomState(0)
        x = rs.randn(5, 3).astype(np.float32)
        y = np.eye(2, dtype=np.float32)[rs.randint(0, 2, 5)]
        out = net.output(x)
        assert tuple(out.shape) == (5, 2)
        np.testing.assert_allclose(out.numpy(), np.asarray(jg.output(x)),
                                   **FWD)
        for _ in range(2):
            jg.fit(x, y)
            net.fit(x, y)
        _same_params(jg, net, **GRAD)


@pytest.mark.parametrize("kind", ["multilayer", "graph"])
def test_json_and_zip_round_trip(kind, tmp_path):
    """A network with SameDiff layers (and a SameDiff vertex) writes its
    JSON and zip and reads both back: equal configuration, bitwise equal
    outputs."""
    rs = np.random.RandomState(3)
    if kind == "multilayer":
        conf = (NeuralNetConfiguration.Builder().seed(1).updater(Adam(1e-2))
                .list().layer(SDDense(n_out=8))
                .layer(SDMseOutput(n_out=2, loss_function=LossFunction.MSE,
                                   activation=Activation.IDENTITY))
                .set_input_type(InputType.feed_forward(4)).build())
        net = MultiLayerNetwork(conf).init("cpu")
        x = rs.randn(6, 4).astype(np.float32)
        net.fit(x, rs.randn(6, 2).astype(np.float32))
        back = MultiLayerConfiguration.from_json(conf.to_json())
    else:
        conf = _gate_graph(False)
        net = ComputationGraph(conf).init("cpu")
        x = rs.randn(6, 3).astype(np.float32)
        net.fit(x, np.eye(2, dtype=np.float32)[rs.randint(0, 2, 6)])
        back = ComputationGraphConfiguration.from_json(conf.to_json())
    assert json.loads(back.to_json()) == json.loads(conf.to_json())
    path = tmp_path / "sd_layers.zip"
    ModelSerializer.write_model(net, str(path))
    restored = ModelSerializer.restore_model(path, device="cpu")
    assert torch.equal(restored.output(x), net.output(x))


@register_layer
@dataclass
class SDMaskedAttention(SameDiffLayer):
    """Self-attention over ``[b, t, n_in]`` with the features mask as the
    key mask (the four-argument ``define_layer``)."""

    heads: int = 2

    def define_parameters(self):
        return {k: (self.n_in, self.n_in) for k in ("Wq", "Wk", "Wv", "Wo")}

    def define_layer(self, sd, layer_input, params, mask):
        return sd.nn.multi_head_dot_product_attention(
            layer_input, params["Wq"], params["Wk"], params["Wv"],
            params["Wo"], self.heads, mask)

    def set_n_in(self, input_type, override):
        if override or not self.n_in:
            self.n_in = self.n_out = input_type.size

    def get_output_type(self, input_type):
        return input_type


def test_masked_attention_layer_takes_the_flash_route(monkeypatch):
    """A layer whose graph is ``multi_head_dot_product_attention`` with
    the features mask: its forward equals the op's dense route, and with
    the flash gate forced the kernels' plain versions give the same
    output and gradients (the route the card takes)."""
    from deeplearning4j_tpu_torch.ops.attention import multi_head_attention
    layer = SDMaskedAttention(n_in=8, n_out=8, heads=2)
    assert layer.accepts_mask()
    p = layer.init_params(torch.Generator().manual_seed(4), None)
    rs = np.random.RandomState(4)
    x = torch.from_numpy(rs.randn(3, 5, 8).astype(np.float32))
    mask = torch.ones(3, 5)
    mask[1, 3:] = 0

    def run(gate):
        monkeypatch.setenv("DL4J_TORCH_FLASH_ATTENTION", gate)
        Environment.reset()
        leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        y, _ = layer.forward(leaves, x, training=True, mask=mask)
        (y * y).sum().backward()
        return y.detach(), {k: v.grad for k, v in leaves.items()}

    want = multi_head_attention(p, x, x, 2, key_mask=mask)
    y0, g0 = run("0")
    y1, g1 = run("1")
    Environment.reset()
    np.testing.assert_allclose(y0.numpy(), want.numpy(), **FWD)
    np.testing.assert_allclose(y1.numpy(), y0.numpy(), **FWD)
    for k in g0:
        np.testing.assert_allclose(g1[k].numpy(), g0[k].numpy(), **GRAD)
