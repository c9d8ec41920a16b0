"""The port's ComputationGraph surface against the JAX package, on the
CPU: truncated BPTT in a graph, vertex preprocessors, the nine graph
vertices, ``EmbeddingLayer`` / ``LossLayer`` / ``CnnLossLayer``, masked
evaluation, ``fit_steps``, ``rnn_time_step`` and its state accessors,
``summary`` / ``param_table`` (and ``MultiLayerNetwork``'s table,
``clone`` and ``summary``), and the listeners.

Parameters cross by ``params_from_jax``; the same seeded numpy inputs go
through both packages. Tolerances: forward rtol 2e-5, trajectories (and
the gradients inside them) rtol 2e-4 / atol 1e-5.
"""
import json

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.activations import Activation as JAct
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.learning import updaters as ju
from deeplearning4j_tpu.lossfunctions import LossFunction as JLoss
from deeplearning4j_tpu.nn.conf import graph_vertices as jgv
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.nn.conf import layers_recurrent as jlr
from deeplearning4j_tpu.nn.conf import preprocessors as jpp
from deeplearning4j_tpu.nn.conf.builders import BackpropType as JBackprop
from deeplearning4j_tpu.nn.conf.builders import \
    NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.graph_conf import \
    ComputationGraphConfiguration as JGraphConf
from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.optimize import listeners as jlis
from deeplearning4j_tpu_torch.activations import Activation
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.learning import updaters as tu
from deeplearning4j_tpu_torch.lossfunctions import LossFunction
from deeplearning4j_tpu_torch.nn.conf import graph_vertices as gv
from deeplearning4j_tpu_torch.nn.conf import layers as tl
from deeplearning4j_tpu_torch.nn.conf import layers_recurrent as tlr
from deeplearning4j_tpu_torch.nn.conf import preprocessors as tpp
from deeplearning4j_tpu_torch.nn.conf.builders import (
    BackpropType, NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.conf.graph_conf import \
    ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize import listeners as tlis
from deeplearning4j_tpu_torch.utils.serializer import (params_from_jax,
                                                       params_to_jax)
from torch_parity import one_intraop_thread  # noqa: F401,E402

FWD = dict(rtol=2e-5, atol=2e-6)
TRAJ = dict(rtol=2e-4, atol=1e-5)
H, V, T, B = 12, 9, 10, 4

#: each package's names, so one builder makes both configurations
JAX = dict(builder=JNNC, it=JIT, ly=jl, lr=jlr, gv=jgv, pp=jpp, up=ju,
           act=JAct, loss=JLoss, backprop=JBackprop)
PORT = dict(builder=NeuralNetConfiguration, it=InputType, ly=tl, lr=tlr,
            gv=gv, pp=tpp, up=tu, act=Activation, loss=LossFunction,
            backprop=BackpropType)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_of(jnet):
    """The port's network of a JAX network: its configuration read from
    the JAX package's JSON, its parameters and states carried across."""
    from deeplearning4j_tpu_torch.nn.conf.builders import \
        MultiLayerConfiguration
    graph = isinstance(jnet, JGraph)
    conf_cls = ComputationGraphConfiguration if graph \
        else MultiLayerConfiguration
    conf = conf_cls.from_json(jnet.conf.to_json())
    assert json.loads(conf.to_json()) == json.loads(jnet.conf.to_json())
    p, s = params_from_jax(_np_tree(jnet.params), _np_tree(jnet.states),
                           conf)
    net_cls = ComputationGraph if graph else MultiLayerNetwork
    return net_cls(conf).set_params(p, s, "cpu")


def _same_params(jnet, net, **tol):
    want = params_to_jax(params_from_jax(_np_tree(jnet.params), {},
                                         net.conf)[0], net.conf)
    got = params_to_jax(net.params, net.conf)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def _rnn_graph(k, tbptt=None, updater=None):
    """GravesLSTM x 2 + RnnOutputLayer as a graph (the char-RNN's
    shape at a small width)."""
    g = (k["builder"].Builder().seed(12345)
         .updater(updater or k["up"].Sgd(0.1)).graph_builder()
         .add_inputs("in").set_input_types(k["it"].recurrent(V, T))
         .add_layer("l0", k["lr"].GravesLSTM(n_out=H,
                                             activation=k["act"].TANH), "in")
         .add_layer("l1", k["lr"].GravesLSTM(n_out=H,
                                             activation=k["act"].TANH), "l0")
         .add_layer("out", k["ly"].RnnOutputLayer(
             n_out=V, loss_function=k["loss"].MCXENT,
             activation=k["act"].SOFTMAX), "l1")
         .set_outputs("out"))
    if tbptt:
        g = g.backprop_type(k["backprop"].TRUNCATED_BPTT).t_bptt_length(
            tbptt)
    return g.build()


def _onehot_batch(seed, b=B, t=T):
    ids = np.random.RandomState(seed).randint(0, V, (b, t + 1))
    eye = np.eye(V, dtype=np.float32)
    return eye[ids[:, :-1]], eye[ids[:, 1:]]


def _masks(seed, b=B, t=T):
    lengths = np.random.RandomState(seed).randint(3, t + 1, b)
    lengths[0] = t
    return (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)


# -- C2: truncated BPTT in a ComputationGraph --------------------------------
def test_jax_written_tbptt_graph_trains_as_the_jax_graph():
    """A graph configuration the JAX package wrote with TRUNCATED_BPTT
    (segments of 4 over 10 steps: 4, 4, 2) trains in segments in the
    port, as in the JAX package: 3 updates a batch, the same 5-step
    trajectory within 2e-4, masks cut per segment in the last two."""
    jg = JGraph(_rnn_graph(JAX, tbptt=4)).init()
    net = _port_of(jg)
    assert net.conf.backprop_type is BackpropType.TRUNCATED_BPTT
    assert net.conf.tbptt_fwd_length == 4
    for step in range(5):
        x, y = _onehot_batch(step)
        if step < 3:
            jg.fit(x, y)
            net.fit(x, y)
        else:
            m = _masks(10 + step)
            jg.fit(JDataSet(x, y, features_mask=m, labels_mask=m))
            net.fit(DataSet(x, y, features_mask=m, labels_mask=m))
        assert net.iteration_count == jg.iteration_count == 3 * (step + 1)
        np.testing.assert_allclose(net.score(), float(jg.score()), **TRAJ)
    assert net.states["l0"] == {}
    _same_params(jg, net, rtol=2e-4, atol=1e-4)


def test_graph_builder_tbptt_options_write_the_jax_json():
    conf = _rnn_graph(PORT, tbptt=4)
    assert json.loads(conf.to_json()) == json.loads(
        _rnn_graph(JAX, tbptt=4).to_json())
    assert conf.tbptt_back_length == 4


def test_tbptt_graph_equals_the_tbptt_multilayer_network():
    """The same configuration as a graph and as a layer stack, from the
    same weights: the same segments and the same trajectory."""
    net = ComputationGraph(_rnn_graph(PORT, tbptt=4)).init("cpu")
    stack = (NeuralNetConfiguration.Builder().seed(12345)
             .updater(tu.Sgd(0.1)).list()
             .layer(tlr.GravesLSTM(n_out=H, activation=Activation.TANH))
             .layer(tlr.GravesLSTM(n_out=H, activation=Activation.TANH))
             .layer(tl.RnnOutputLayer(n_out=V,
                                      loss_function=LossFunction.MCXENT,
                                      activation=Activation.SOFTMAX))
             .backprop_type(BackpropType.TRUNCATED_BPTT).t_bptt_length(4)
             .set_input_type(InputType.recurrent(V, T)).build())
    names = {"layer_0": "l0", "layer_1": "l1", "layer_2": "out"}
    mln = MultiLayerNetwork(stack).set_params(
        {k: {n: t.clone() for n, t in net.params[v].items()}
         for k, v in names.items()}, {}, "cpu")
    for step in range(3):
        x, y = _onehot_batch(30 + step)
        net.fit(x, y)
        mln.fit(x, y)
        assert net.score() == mln.score()
    for k, v in names.items():
        for n, t in mln.params[k].items():
            assert torch.equal(t, net.params[v][n]), f"{v}/{n}"


# -- vertices ------------------------------------------------------------------
VERTICES = {  # name -> (kwargs builder(pkg), n inputs, input kind)
    "merge": (lambda k: k["gv"].MergeVertex(), 2, "ff"),
    "elementwise_max": (lambda k: k["gv"].ElementWiseVertex(op="Max"), 3,
                        "ff"),
    "subset": (lambda k: k["gv"].SubsetVertex(from_idx=2, to_idx=5), 1,
               "rnn"),
    "scale": (lambda k: k["gv"].ScaleVertex(scale_factor=-1.5), 1, "cnn"),
    "shift": (lambda k: k["gv"].ShiftVertex(shift_factor=0.25), 1, "ff"),
    "stack": (lambda k: k["gv"].StackVertex(), 2, "rnn"),
    "unstack": (lambda k: k["gv"].UnstackVertex(from_idx=1, stack_size=2),
                1, "ff"),
    "l2_normalize": (lambda k: k["gv"].L2NormalizeVertex(), 1, "cnn"),
    "preprocessor_rnn_to_ff": (lambda k: k["gv"].PreprocessorVertex(
        k["pp"].RnnToFeedForwardPreProcessor()), 1, "rnn"),
    "preprocessor_cnn_to_ff": (lambda k: k["gv"].PreprocessorVertex(
        k["pp"].CnnToFeedForwardPreProcessor(3, 4, 5)), 1, "cnn"),
    "preprocessor_ff_to_cnn": (lambda k: k["gv"].PreprocessorVertex(
        k["pp"].FeedForwardToCnnPreProcessor(2, 3, 2)), 1, "ff"),
}
SHAPES = {"ff": ((4, 12), lambda it: it.feed_forward(12)),
          "rnn": ((4, 6, 12), lambda it: it.recurrent(12, 6)),
          "cnn": ((4, 3, 4, 5), lambda it: it.convolutional(3, 4, 5))}


@pytest.mark.parametrize("name", sorted(VERTICES))
def test_vertex_matches_jax(name):
    make, n_in, kind = VERTICES[name]
    shape, itype = SHAPES[kind]
    rs = np.random.RandomState(sorted(VERTICES).index(name))
    xs = [rs.randn(*shape).astype(np.float32) for _ in range(n_in)]
    jv, v = make(JAX), make(PORT)
    want = np.asarray(jv.forward([jax.numpy.asarray(x) for x in xs]))
    got = v.forward([torch.tensor(x) for x in xs])
    np.testing.assert_allclose(got.numpy(), want, **FWD)
    assert v.get_output_type([itype(InputType)] * n_in).to_map() == \
        jv.get_output_type([itype(JIT)] * n_in).to_map()
    m = v.to_map()
    assert json.loads(json.dumps(m)) == json.loads(json.dumps(jv.to_map()))
    assert gv.GraphVertex.from_map(jv.to_map()).to_map() == m
    assert jgv.GraphVertex.from_map(m).to_map() == jv.to_map()


def _vertex_graph(k):
    """Every vertex kind in one graph, a layer preprocessor given
    explicitly and one inserted by shape inference."""
    g = (k["builder"].Builder().seed(4).updater(k["up"].Sgd(0.05))
         .graph_builder().add_inputs("img", "seq")
         .set_input_types(k["it"].convolutional(4, 4, 2),
                          k["it"].recurrent(6, 5))
         .add_layer("conv", k["ly"].ConvolutionLayer(
             n_out=3, kernel_size=(3, 3), activation=k["act"].RELU), "img")
         .add_vertex("l2", k["gv"].L2NormalizeVertex(), "conv")
         .add_vertex("scaled", k["gv"].ScaleVertex(scale_factor=2.0), "l2")
         # CnnToFeedForward inserted before the dense layer
         .add_layer("dense", k["ly"].DenseLayer(n_out=8,
                                               activation=k["act"].TANH),
                    "scaled")
         .add_layer("rnn_dense", k["ly"].DenseLayer(
             n_out=8, activation=k["act"].TANH),
             k["pp"].RnnToFeedForwardPreProcessor(), "seq")
         .add_vertex("back", k["gv"].PreprocessorVertex(
             k["pp"].FeedForwardToRnnPreProcessor(5)), "rnn_dense")
         .add_layer("pool", k["lr"].LastTimeStepLayer(), "back")
         .add_vertex("stack", k["gv"].StackVertex(), "dense", "pool")
         .add_vertex("shifted", k["gv"].ShiftVertex(shift_factor=0.5),
                     "stack")
         .add_vertex("first", k["gv"].UnstackVertex(from_idx=0,
                                                    stack_size=2),
                     "shifted")
         .add_vertex("second", k["gv"].UnstackVertex(from_idx=1,
                                                     stack_size=2),
                     "shifted")
         .add_vertex("merge", k["gv"].MergeVertex(), "first", "second")
         .add_vertex("sub", k["gv"].SubsetVertex(from_idx=3, to_idx=12),
                     "merge")
         .add_layer("out", k["ly"].OutputLayer(n_out=3), "sub")
         .set_outputs("out"))
    return g.build()


def test_graph_of_every_vertex_and_preprocessor_trains_as_jax():
    jg = JGraph(_vertex_graph(JAX)).init()
    conf = _vertex_graph(PORT)
    assert json.loads(conf.to_json()) == json.loads(jg.conf.to_json())
    assert type(conf.vertices["dense"].preprocessor).__name__ == \
        "CnnToFeedForwardPreProcessor"
    assert ComputationGraphConfiguration.from_json(
        conf.to_json()).to_json() == conf.to_json()
    assert json.loads(JGraphConf.from_json(conf.to_json()).to_json()) == \
        json.loads(conf.to_json())
    net = _port_of(jg)
    rs = np.random.RandomState(40)
    for _ in range(4):
        img = rs.randn(4, 4, 4, 2).astype(np.float32)
        seq = rs.randn(4, 5, 6).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, 4)]
        jg.fit([img, seq], [y])
        net.fit([img, seq], [y])
        np.testing.assert_allclose(net.score(), float(jg.score()), **TRAJ)
    np.testing.assert_allclose(net.output(img, seq).numpy(),
                               np.asarray(jg.output(img, seq)), **TRAJ)
    _same_params(jg, net, **TRAJ)


def test_cnn3d_input_to_a_dense_layer_is_refused():
    g = (NeuralNetConfiguration.Builder().graph_builder().add_inputs("v")
         .set_input_types(InputType.convolutional_3d(2, 3, 3, 2))
         .add_layer("out", tl.OutputLayer(n_out=2), "v").set_outputs("out"))
    with pytest.raises(NotImplementedError, match="item 14"):
        g.build()


# -- EmbeddingLayer, LossLayer, CnnLossLayer ----------------------------------
def _layers_graph(k):
    g = (k["builder"].Builder().seed(8).updater(k["up"].Sgd(0.1))
         .graph_builder().add_inputs("ids", "img")
         .set_input_types(k["it"].feed_forward(1),
                          k["it"].convolutional(3, 3, 4))
         .add_layer("emb", k["ly"].EmbeddingLayer(
             n_in=V, n_out=6, has_bias=True, activation=k["act"].TANH),
             "ids")
         .add_layer("proj", k["ly"].DenseLayer(n_out=4,
                                              activation=k["act"].IDENTITY),
                    "emb")
         .add_layer("loss", k["ly"].LossLayer(
             loss_function=k["loss"].MCXENT,
             activation=k["act"].SOFTMAX), "proj")
         .add_layer("pix", k["ly"].ConvolutionLayer(
             n_out=2, kernel_size=(1, 1), activation=k["act"].IDENTITY),
             "img")
         .add_layer("cnn_loss", k["ly"].CnnLossLayer(
             loss_function=k["loss"].MSE), "pix")
         .set_outputs("loss", "cnn_loss"))
    return g.build()


def test_embedding_and_loss_layers_train_as_jax():
    jg = JGraph(_layers_graph(JAX)).init()
    net = _port_of(jg)
    assert net.conf.vertices["cnn_loss"].preprocessor is None
    rs = np.random.RandomState(50)
    for _ in range(4):
        ids = rs.randint(0, V, (B, 1)).astype(np.int32)
        img = rs.randn(B, 3, 3, 4).astype(np.float32)
        y1 = np.eye(4, dtype=np.float32)[rs.randint(0, 4, B)]
        y2 = rs.randn(B, 3, 3, 2).astype(np.float32)
        jg.fit([ids, img], [y1, y2])
        net.fit([ids, img], [y1, y2])
        np.testing.assert_allclose(net.score(), float(jg.score()), **TRAJ)
    _same_params(jg, net, **TRAJ)
    outs = net.outputs(ids[:, 0], img)
    jouts = jg.outputs(ids[:, 0], img)
    assert len(outs) == 2
    for o, jo in zip(outs, jouts):
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TRAJ)
    np.testing.assert_array_equal(net.predict(ids, img),
                                  jg.predict(ids, img))


@pytest.mark.parametrize("which", ["vertices", "layers"])
def test_jax_written_zip_restores_with_equal_outputs(which, tmp_path):
    """A JAX-written zip of a graph with vertex preprocessors (given and
    inserted) and every vertex kind, or with EmbeddingLayer / LossLayer /
    CnnLossLayer, restores in the port with equal outputs."""
    from deeplearning4j_tpu.utils.serializer import \
        ModelSerializer as JSerializer
    from deeplearning4j_tpu_torch.utils.serializer import ModelSerializer
    rs = np.random.RandomState(55)
    if which == "vertices":
        jg = JGraph(_vertex_graph(JAX)).init()
        xs = [rs.randn(4, 4, 4, 2).astype(np.float32),
              rs.randn(4, 5, 6).astype(np.float32)]
        jg.fit(xs, [np.eye(3, dtype=np.float32)[rs.randint(0, 3, 4)]])
    else:
        jg = JGraph(_layers_graph(JAX)).init()
        xs = [rs.randint(0, V, (B, 1)).astype(np.int32),
              rs.randn(B, 3, 3, 4).astype(np.float32)]
        jg.fit(xs, [np.eye(4, dtype=np.float32)[rs.randint(0, 4, B)],
                    rs.randn(B, 3, 3, 2).astype(np.float32)])
    path = tmp_path / f"{which}.zip"
    JSerializer.write_model(jg, str(path))
    net = ModelSerializer.restore_model(path, device="cpu")
    assert json.loads(net.conf.to_json()) == json.loads(jg.conf.to_json())
    for o, jo in zip(net.outputs(*xs), jg.outputs(*xs)):
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), **FWD)


# -- masked evaluation, fit_steps, rnn_time_step ------------------------------
def _pooled_graph(k):
    g = (k["builder"].Builder().seed(6).updater(k["up"].Sgd(0.1))
         .graph_builder().add_inputs("in")
         .set_input_types(k["it"].recurrent(V, T))
         .add_layer("lstm", k["lr"].LSTM(n_out=H, activation=k["act"].TANH),
                    "in")
         .add_layer("pool", k["ly"].GlobalPoolingLayer(), "lstm")
         .add_layer("out", k["ly"].OutputLayer(n_out=3), "pool")
         .set_outputs("out"))
    return g.build()


def test_masked_fit_output_score_and_evaluate_match_jax():
    jg = JGraph(_pooled_graph(JAX)).init()
    net = _port_of(jg)
    rs = np.random.RandomState(60)
    for step in range(3):
        x, _ = _onehot_batch(60 + step)
        y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, B)]
        m = _masks(70 + step)
        jg.fit(JDataSet(x, y, features_mask=m))
        net.fit(DataSet(x, y, features_mask=m))
        np.testing.assert_allclose(net.score(), float(jg.score()), **TRAJ)
    np.testing.assert_allclose(net.output(x, mask=m).numpy(),
                               np.asarray(jg.output(x, mask=m)), **TRAJ)
    np.testing.assert_allclose(net.score(DataSet(x, y, features_mask=m)),
                               jg.score(JDataSet(x, y, features_mask=m)),
                               **TRAJ)
    ev = net.evaluate([DataSet(x, y, features_mask=m)])
    jev = jg.evaluate([JDataSet(x, y, features_mask=m)])
    np.testing.assert_array_equal(ev.confusion_matrix(),
                                  jev.confusion_matrix())
    # the mask changes the pooled answer
    assert not torch.allclose(net.output(x, mask=m), net.output(x))


def test_fit_steps_matches_jax_and_refuses_masks():
    """fit_steps carries the recurrent state from step to step, as the
    JAX package's compiled loop does."""
    jg = JGraph(_rnn_graph(JAX)).init()
    net = _port_of(jg)
    x, y = _onehot_batch(80)
    jg.fit_steps(JDataSet(x, y), 4)
    net.fit_steps(DataSet(x, y), 4)
    np.testing.assert_allclose(net.score(), float(jg.score()), **TRAJ)
    assert net.iteration_count == jg.iteration_count == 4
    _same_params(jg, net, rtol=2e-4, atol=1e-4)
    with pytest.raises(ValueError, match="masked"):
        net.fit_steps(DataSet(x, y, features_mask=np.ones((B, T))), 2)


def test_fit_steps_equals_fit_calls_without_recurrent_state():
    """On a graph with no recurrent layer, fit_steps(ds, n) is n fit
    calls bit for bit, with one listener call."""
    calls = []

    class Count(tlis.TrainingListener):
        def iteration_done(self, model, iteration, epoch):
            calls.append(iteration)

    a = ComputationGraph(_vertex_graph(PORT)).init("cpu")
    b = ComputationGraph(_vertex_graph(PORT)).init("cpu")
    a.set_listeners(Count())
    rs = np.random.RandomState(90)
    img = rs.randn(4, 4, 4, 2).astype(np.float32)
    seq = rs.randn(4, 5, 6).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, 4)]
    from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet
    a.fit_steps(MultiDataSet([img, seq], [y]), 3)
    for _ in range(3):
        b.fit([img, seq], [y])
    assert calls == [2] and a.score() == b.score()
    for k in a.params:
        for n, t in a.params[k].items():
            assert torch.equal(t, b.params[k][n]), f"{k}/{n}"


def test_rnn_time_step_stream_matches_jax_and_output():
    jg = JGraph(_rnn_graph(JAX)).init()
    net = _port_of(jg)
    x, _ = _onehot_batch(100)
    outs, jouts = [], []
    for t in range(T):
        outs.append(net.rnn_time_step(x[:, t]))
        jouts.append(np.asarray(jg.rnn_time_step(x[:, t])))
    got = torch.stack(outs, 1).numpy()
    np.testing.assert_allclose(got, np.stack(jouts, 1), **TRAJ)
    np.testing.assert_allclose(got, net.output(x).numpy(), rtol=0,
                               atol=1e-5)
    st, jst = net.rnn_get_previous_state("l1"), jg.rnn_get_previous_state(
        "l1")
    assert sorted(st) == sorted(jst) == ["c", "h"]
    for n in st:
        np.testing.assert_allclose(st[n].numpy(), np.asarray(jst[n]),
                                   **TRAJ)
    # a chunk continues the stream; another batch size raises
    assert net.rnn_time_step(x[:, :3]).shape == (B, 3, V)
    with pytest.raises(ValueError, match="batch size"):
        net.rnn_time_step(x[:2, 0])
    # a state set from outside seeds the stream, as in the JAX package
    net.rnn_clear_previous_state()
    jg.rnn_clear_previous_state()
    seed = {n: np.full((2, H), 0.3, np.float32) for n in ("h", "c")}
    net.rnn_set_previous_state("l0", seed)
    jg.rnn_set_previous_state("l0", {n: jax.numpy.asarray(a)
                                     for n, a in seed.items()})
    np.testing.assert_allclose(net.rnn_time_step(x[:2, 0]).numpy(),
                               np.asarray(jg.rnn_time_step(x[:2, 0])),
                               **TRAJ)
    with pytest.raises(ValueError, match="not a recurrent vertex"):
        net.rnn_set_previous_state("out", seed)


def test_rnn_time_step_refuses_a_bidirectional_graph():
    g = (NeuralNetConfiguration.Builder().graph_builder().add_inputs("in")
         .set_input_types(InputType.recurrent(V, T))
         .add_layer("bi", tlr.Bidirectional(fwd=tlr.LSTM(n_out=4)), "in")
         .add_layer("out", tl.RnnOutputLayer(n_out=V), "bi")
         .set_outputs("out").build())
    net = ComputationGraph(g).init("cpu")
    with pytest.raises(ValueError, match="Bidirectional"):
        net.rnn_time_step(np.zeros((1, V), np.float32))


# -- summary, param_table, clone ------------------------------------------------
def test_graph_summary_and_param_table_match_jax():
    jg = JGraph(_vertex_graph(JAX)).init()
    net = _port_of(jg)
    assert net.summary() == jg.summary()
    table, jtable = net.param_table(), jg.param_table()
    assert sorted(table) == sorted(jtable)
    for k, t in table.items():
        want = np.asarray(jtable[k])
        if t.dim() == 4:                          # OIHW against HWIO
            want = np.transpose(want, (3, 2, 0, 1))
        np.testing.assert_array_equal(t.numpy(), want, err_msg=k)


def _mlp(k):
    return (k["builder"].Builder().seed(2).updater(k["up"].Adam(1e-2))
            .list()
            .layer(k["ly"].DenseLayer(n_out=7, activation=k["act"].RELU))
            .layer(k["ly"].BatchNormalization())
            .layer(k["ly"].OutputLayer(n_out=3))
            .set_input_type(k["it"].feed_forward(5)).build())


def test_multilayer_table_clone_and_summary_match_jax():
    jnet = JMLN(_mlp(JAX)).init()
    net = _port_of(jnet)
    assert net.summary() == jnet.summary()
    table, jtable = net.param_table(), jnet.param_table()
    assert sorted(table) == sorted(jtable)
    for k, t in table.items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(jtable[k]))
    assert net.get_param("0_W") is net.params["layer_0"]["W"]
    rs = np.random.RandomState(110)
    x = rs.randn(6, 5).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, 6)]
    twin = net.clone()
    # the JAX package's clone shares its source's buffers, which a step
    # donates: only the clone trains there
    jtwin = jnet.clone()
    net.fit(x, y)
    # a clone is independent of its source, its updater state included
    for k in twin.params:
        for n, t in twin.params[k].items():
            assert not torch.equal(t, net.params[k][n]) or n == "b"
    twin.fit(x, y)
    jtwin.fit(x, y)
    np.testing.assert_allclose(twin.score(), float(jtwin.score()), **TRAJ)
    _same_params(jtwin, twin, **TRAJ)
    # set_params_from_table writes parameters and states in place
    new = {"0_W": np.zeros((5, 7), np.float32),
           "1_mean": np.full(7, 0.5, np.float32), "9_nothing": 1.0}
    w = net.params["layer_0"]["W"]
    net.set_params_from_table(new)
    assert net.params["layer_0"]["W"] is w and not bool(w.any())
    assert torch.equal(net.states["layer_1"]["mean"],
                       torch.full((7,), 0.5))


# -- listeners -------------------------------------------------------------------
def test_collect_scores_and_evaluative_listeners_match_jax():
    jg = JGraph(_pooled_graph(JAX)).init()
    net = _port_of(jg)
    rs = np.random.RandomState(120)
    held = []
    for i in range(2):
        x, _ = _onehot_batch(130 + i)
        held.append((x, np.eye(3, dtype=np.float32)[rs.randint(0, 3, B)],
                     _masks(140 + i)))
    jcs, cs = jlis.CollectScoresListener(), tlis.CollectScoresListener()
    jev = jlis.EvaluativeListener([JDataSet(x, y, features_mask=m)
                                   for x, y, m in held], frequency=2)
    seen = []
    ev = tlis.EvaluativeListener(
        iter([DataSet(x, y, features_mask=m) for x, y, m in held]),
        frequency=2, callback=lambda i, e: seen.append(i))
    jg.set_listeners(jcs, jev)
    net.set_listeners(cs, ev)
    for step in range(4):
        x, _ = _onehot_batch(150 + step)
        y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, B)]
        jg.fit(x, y)
        net.fit(x, y)
    assert [i for i, _ in cs.scores] == [i for i, _ in jcs.scores] == \
        [0, 1, 2, 3]
    np.testing.assert_allclose([s for _, s in cs.scores],
                               [float(s) for _, s in jcs.scores], **TRAJ)
    assert seen == [i for i, _ in ev.evaluations] == [0, 2]
    for (_, e), (_, je) in zip(ev.evaluations, jev.evaluations):
        np.testing.assert_array_equal(e.confusion_matrix(),
                                      je.confusion_matrix())


def test_performance_listener_reports_rates(caplog):
    net = ComputationGraph(_pooled_graph(PORT)).init("cpu")
    net.set_listeners(tlis.PerformanceListener(frequency=2))
    with caplog.at_level("INFO", logger="deeplearning4j_tpu_torch"):
        for step in range(5):
            x, _ = _onehot_batch(160 + step)
            net.fit(x, np.eye(3, dtype=np.float32)[np.arange(B) % 3])
    reports = [r.getMessage() for r in caplog.records
               if "iters/sec" in r.getMessage()]
    assert [m.split(":")[0] for m in reports] == ["iteration 2",
                                                   "iteration 4"]
    for m in reports:
        iters = float(m.split(": ")[1].split(" ")[0])
        samples = float(m.split(", ")[1].split(" ")[0])
        assert iters > 0 and samples == pytest.approx(iters * B, rel=0.01)
