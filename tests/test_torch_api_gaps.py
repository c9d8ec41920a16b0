"""Small API calls of ported classes that the port lacked, each called in
both packages on the CPU: the global builder's constraints
(``constrain_weights`` / ``constrain_bias`` / ``constrain_all_parameters``,
held by a trajectory of a constrained MLP), ``Builder.activation``,
``WorkspaceMode``, ``MultiLayerConfiguration.get_layer``,
``ComputationGraph.output_layer_confs``, ``ModelRegistry.names``,
``ServingBatcher.params`` and ``ParallelInference.n_workers``.
"""
import jax
import numpy as np
import pytest

from deeplearning4j_tpu.activations import Activation as JAct
from deeplearning4j_tpu.learning import updaters as ju
from deeplearning4j_tpu.nn.conf import builders as jb
from deeplearning4j_tpu.nn.conf import constraints as jc
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT
from deeplearning4j_tpu.nn.graph import ComputationGraph as JCG
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu_torch.activations import Activation
from deeplearning4j_tpu_torch.learning import updaters as tu
from deeplearning4j_tpu_torch.nn.conf import builders as tb
from deeplearning4j_tpu_torch.nn.conf import constraints as tc
from deeplearning4j_tpu_torch.nn.conf import layers as tl
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.utils.serializer import (params_from_jax,
                                                       params_to_jax)
from torch_parity import one_intraop_thread  # noqa: F401,E402

PKGS = {"jax": (jb, jl, jc, JAct, JIT, ju), "port": (tb, tl, tc, Activation,
                                                       InputType, tu)}


def _np_tree(tree):
    return {k: {n: np.asarray(a) for n, a in sub.items()}
            for k, sub in tree.items()}


def _constrained_conf(pkg, kind):
    """An MLP whose constraints come from the global builder only."""
    b, L, C, Act, IT, U = PKGS[pkg]
    builder = (b.NeuralNetConfiguration.Builder().seed(3)
               .updater(U.Sgd(0.5)).activation(Act.TANH))
    if kind == "weights":
        builder = builder.constrain_weights(C.MaxNormConstraint(0.3))
    elif kind == "bias":
        builder = builder.constrain_bias(C.NonNegativeConstraint())
    else:
        builder = builder.constrain_all_parameters(
            C.MinMaxNormConstraint(0.1, 0.4))
    return (builder.list()
            .layer(L.DenseLayer(n_in=6, n_out=8, activation=Act.TANH))
            .layer(L.OutputLayer(n_out=3, activation=Act.SOFTMAX))
            .set_input_type(IT.feed_forward(6)).build())


@pytest.mark.parametrize("kind", ["weights", "bias", "all"])
def test_global_constraints_flow_to_every_layer(kind):
    """The builder's constraints reach every layer that sets none, and a
    5-step Sgd trajectory of the constrained MLP matches the JAX
    package's (the constraint projecting after each update)."""
    jconf, conf = (_constrained_conf(p, kind) for p in ("jax", "port"))
    field = {"weights": "constrain_weights", "bias": "constrain_bias",
             "all": "constrain_all"}[kind]
    for layers in (jconf.layers, conf.layers):
        assert all(len(getattr(layer, field)) == 1 for layer in layers)
    jnet = JMLN(jconf).init()
    p, s = params_from_jax(_np_tree(jnet.params), _np_tree(jnet.states),
                           conf)
    net = MultiLayerNetwork(conf).set_params(p, s, "cpu")
    rs = np.random.RandomState(4)
    x = rs.randn(16, 6).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, 16)]
    for _ in range(5):
        jnet.fit(x, y)
        net.fit(x, y)
    got = params_to_jax(net.params, conf)
    want = params_to_jax(params_from_jax(_np_tree(jnet.params), {},
                                         conf)[0], conf)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-5, atol=2e-6,
                                   err_msg=k)
    if kind == "weights":
        w = net.params[next(iter(net.params))]["W"]
        assert float(w.norm(dim=0).max()) <= 0.3 + 1e-5


def test_builder_activation_workspace_mode_and_get_layer():
    """``Builder.activation`` is stored and applied nowhere (the JAX
    package's no-op), ``WorkspaceMode`` has the JAX package's members,
    and ``get_layer(i)`` is the i-th layer."""
    for pkg in ("jax", "port"):
        b, L, C, Act, IT, U = PKGS[pkg]
        builder = b.NeuralNetConfiguration.Builder().activation(Act.RELU)
        assert builder._activation is Act.RELU
        conf = (builder.list()
                .layer(L.DenseLayer(n_in=4, n_out=5, activation=Act.TANH))
                .layer(L.OutputLayer(n_out=2, activation=Act.SOFTMAX))
                .set_input_type(IT.feed_forward(4)).build())
        assert conf.get_layer(0) is conf.layers[0]
        assert conf.get_layer(0).activation is Act.TANH
        assert conf.get_layer(1) is conf.layers[1]
    assert [(m.name, m.value) for m in tb.WorkspaceMode] == \
        [(m.name, m.value) for m in jb.WorkspaceMode]


def _graph(pkg):
    b, L, C, Act, IT, U = PKGS[pkg]
    gb = (b.NeuralNetConfiguration.Builder().seed(5).graph_builder()
          .add_inputs("in").set_input_types(IT.feed_forward(4)))
    gb.add_layer("d", L.DenseLayer(n_out=6, activation=Act.TANH), "in")
    gb.add_layer("out", L.OutputLayer(n_out=3, activation=Act.SOFTMAX), "d")
    gb.add_layer("feat", L.DenseLayer(n_out=2, activation=Act.TANH), "d")
    gb.set_outputs("out", "feat")
    return (JCG if pkg == "jax" else ComputationGraph)(gb.build())


def test_graph_output_layer_confs():
    """The output layers among the graph's outputs, by vertex name (a
    dense output is not one)."""
    got, want = (_graph(p).output_layer_confs() for p in ("port", "jax"))
    assert sorted(got) == sorted(want) == ["out"]
    assert type(got["out"]).__name__ == type(want["out"]).__name__


def _mlp(pkg):
    b, L, C, Act, IT, U = PKGS[pkg]
    conf = (b.NeuralNetConfiguration.Builder().seed(2).list()
            .layer(L.DenseLayer(n_in=4, n_out=5, activation=Act.TANH))
            .layer(L.OutputLayer(n_out=2, activation=Act.SOFTMAX))
            .set_input_type(IT.feed_forward(4)).build())
    if pkg == "jax":
        return JMLN(conf).init()
    return MultiLayerNetwork(conf).init("cpu")


def test_registry_names_batcher_params_and_workers():
    """``ModelRegistry.names`` (sorted), ``ServingBatcher.params`` (what
    the batcher holds resident: the model's parameters) and
    ``ParallelInference.n_workers`` (the port serves on one device; the
    JAX package's mesh spans its devices)."""
    from deeplearning4j_tpu.parallel.inference import \
        ParallelInference as JPI
    from deeplearning4j_tpu.serving.batcher import ServingBatcher as JSB
    from deeplearning4j_tpu.serving.registry import ModelRegistry as JMR
    from deeplearning4j_tpu_torch.parallel.inference import \
        ParallelInference
    from deeplearning4j_tpu_torch.serving.batcher import ServingBatcher
    from deeplearning4j_tpu_torch.serving.registry import ModelRegistry
    for reg, pkg in ((ModelRegistry(), "port"), (JMR(), "jax")):
        try:
            for name in ("zeta", "alpha", "mid"):
                reg.register(name, _mlp(pkg), buckets=(4,))
            assert reg.names() == ["alpha", "mid", "zeta"]
        finally:
            reg.shutdown()
    net, jnet = _mlp("port"), _mlp("jax")
    assert ServingBatcher(net, buckets=(4,)).params is net.params
    assert JSB(jnet, buckets=(4,)).params is jnet.params
    assert ParallelInference(net).n_workers == 1
    assert JPI(jnet).n_workers == len(jax.devices())
