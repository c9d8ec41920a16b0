"""The port's char-RNN (GravesLSTM x 2 + RnnOutputLayer, BASELINE config
#3 at H=32, T=12, batch 4) against the JAX package, on the CPU.

Both start from the JAX package's initial weights (``params_from_jax``)
and see the same seeded one-hot batches. Held: the losses of a 5-step
``fit`` trajectory in f32 and its final parameters at the ROADMAP's
gradient bar, rtol 2e-4 / atol 1e-5 (Adam's update divides by the root
of its second moment, so where a gradient entry is at the level of
summation noise the update is still ~lr: parameters get atol 1e-4, a
twentieth of one Adam step at lr 5e-3); a tBPTT trajectory with a short
last segment; ``fit_steps``; masked batches; an ``rnn_time_step``
stream (and against ``output``: the hoisted ``[b·t, 4H]`` product and
the per-step one sum in other orders, so 1e-5, not bitwise);
``TextGenerationLSTM``'s initialised forward. The bf16 trajectory is
held at ``BF16_LOSS_RTOL`` and its output at ``BF16_OUT_ATOL``.
"""
import json

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.activations import Activation as JActivation
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.learning import Adam as JAdam
from deeplearning4j_tpu.lossfunctions import LossFunction as JLoss
from deeplearning4j_tpu.models.zoo_extra import \
    TextGenerationLSTM as JTextGen
from deeplearning4j_tpu.nn import InputType as JInputType
from deeplearning4j_tpu.nn import MultiLayerNetwork as JNet
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JBuilder
from deeplearning4j_tpu.nn.conf.builders import BackpropType as JBackprop
from deeplearning4j_tpu.nn.conf.layers import RnnOutputLayer as JRnnOut
from deeplearning4j_tpu.nn.conf.layers_recurrent import (
    Bidirectional as JBidirectional, GravesLSTM as JGraves)
from deeplearning4j_tpu_torch.activations import Activation
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.learning.updaters import Adam
from deeplearning4j_tpu_torch.lossfunctions import LossFunction
from deeplearning4j_tpu_torch.models import TextGenerationLSTM
from deeplearning4j_tpu_torch.nn.conf.builders import (
    BackpropType, MultiLayerConfiguration, NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import RnnOutputLayer
from deeplearning4j_tpu_torch.nn.conf.layers_recurrent import GravesLSTM
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.utils.serializer import (params_from_jax,
                                                      params_to_jax)
from torch_parity import one_intraop_thread  # noqa: F401,E402

RTOL, ATOL, ADAM_ATOL = 2e-4, 1e-5, 1e-4
#: bf16 losses. Under compute_dtype both packages start each fit batch
#: from float32 zero states, so only the first layer's hoisted product
#: rounds to bf16 and the rest of the step promotes to float32: the
#: largest gap measured over these 5 steps is 2.3e-6 of the loss
BF16_LOSS_RTOL = 1e-4
#: bf16 ``output`` starts from bf16 zero states, so the whole recurrence
#: rounds to bf16: 8 bf16 ulps of the O(0.1) probabilities (2 measured)
BF16_OUT_ATOL = 2.0 ** -8
H, T, B, V = 32, 12, 4, 11


def _jconf(tbptt=None, compute=None, bidirectional=False):
    b = JBuilder.Builder().seed(12345).updater(JAdam(5e-3))
    if compute:
        b = b.compute_data_type(compute)
    lb = b.list()
    if bidirectional:
        lb = lb.layer(JBidirectional(fwd=JGraves(n_out=H,
                                                 activation=JActivation.TANH)))
    else:
        lb = lb.layer(JGraves(n_out=H, activation=JActivation.TANH))
    lb = (lb.layer(JGraves(n_out=H, activation=JActivation.TANH))
          .layer(JRnnOut(n_out=V, loss_function=JLoss.MCXENT,
                         activation=JActivation.SOFTMAX)))
    if tbptt:
        lb = lb.backprop_type(JBackprop.TRUNCATED_BPTT).t_bptt_length(tbptt)
    return lb.set_input_type(JInputType.recurrent(V, T)).build()


def _conf(tbptt=None, compute=None):
    b = NeuralNetConfiguration.Builder().seed(12345).updater(Adam(5e-3))
    if compute:
        b = b.compute_data_type(compute)
    lb = (b.list()
          .layer(GravesLSTM(n_out=H, activation=Activation.TANH))
          .layer(GravesLSTM(n_out=H, activation=Activation.TANH))
          .layer(RnnOutputLayer(n_out=V, loss_function=LossFunction.MCXENT,
                                activation=Activation.SOFTMAX)))
    if tbptt:
        lb = lb.backprop_type(BackpropType.TRUNCATED_BPTT).t_bptt_length(tbptt)
    return lb.set_input_type(InputType.recurrent(V, T)).build()


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(tbptt=None, compute=None, bidirectional=False):
    jnet = JNet(_jconf(tbptt, compute, bidirectional)).init()
    if bidirectional:
        conf = MultiLayerConfiguration.from_json(jnet.conf.to_json())
    else:
        conf = _conf(tbptt, compute)
    assert json.loads(conf.to_json()) == json.loads(jnet.conf.to_json())
    p, s = params_from_jax(_np_tree(jnet.params), _np_tree(jnet.states),
                           conf)
    return jnet, MultiLayerNetwork(conf).set_params(p, s, "cpu")


def _batch(seed, t=T, b=B):
    ids = np.random.RandomState(seed).randint(0, V, (b, t + 1))
    eye = np.eye(V, dtype=np.float32)
    return eye[ids[:, :-1]], eye[ids[:, 1:]]


def _assert_same_params(jnet, net, atol=ADAM_ATOL):
    want = params_to_jax(params_from_jax(_np_tree(jnet.params), {},
                                         net.conf)[0], net.conf)
    got = params_to_jax(net.params, net.conf)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=atol,
                                   err_msg=k)


# ---------------------------------------------------------------------------
def test_f32_fit_trajectory_matches_jax():
    jnet, net = _pair()
    for step in range(5):
        x, y = _batch(step)
        jnet.fit(x, y)
        net.fit(x, y)
        np.testing.assert_allclose(net.score(), float(jnet.score()),
                                   rtol=RTOL, atol=ATOL)
        # no recurrent state survives a batch
        assert net.states == {"layer_0": {}, "layer_1": {}, "layer_2": {}}
    assert net.iteration_count == jnet.iteration_count == 5
    _assert_same_params(jnet, net)
    x, y = _batch(9)
    np.testing.assert_allclose(net.output(x).numpy(),
                               np.asarray(jnet.output(x)), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(net.predict(x), jnet.predict(x))
    ds = JDataSet(x, y)
    np.testing.assert_allclose(net.score(DataSet(x, y)), jnet.score(ds),
                               rtol=RTOL)


def test_bf16_fit_trajectory_near_jax():
    jnet, net = _pair(compute="bfloat16")
    losses = []
    for step in range(5):
        x, y = _batch(step)
        jnet.fit(x, y)
        net.fit(x, y)
        want, got = float(jnet.score()), net.score()
        assert abs(got - want) <= BF16_LOSS_RTOL * abs(want), (step, got,
                                                               want)
        losses.append(got)
    assert losses[-1] < losses[0]
    assert all(t.dtype == torch.float32 for sub in net.params.values()
               for t in sub.values())
    x, _ = _batch(9)
    out = net.output(x)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(jnet.output(x)),
                               rtol=0, atol=BF16_OUT_ATOL)


def test_tbptt_trajectory_matches_jax():
    """Segments of 5, 5 and 2 steps: three updates a batch, the state
    carried across them, listeners once a batch."""
    jnet, net = _pair(tbptt=5)
    calls = []

    class Count:
        def iteration_done(self, model, iteration, epoch):
            calls.append(iteration)

    net.set_listeners(Count())
    for step in range(3):
        x, y = _batch(20 + step)
        jnet.fit(x, y)
        net.fit(x, y)
        np.testing.assert_allclose(net.score(), float(jnet.score()),
                                   rtol=RTOL, atol=ATOL)
    assert net.iteration_count == jnet.iteration_count == 9
    assert calls == [2, 5, 8]
    _assert_same_params(jnet, net)


def test_tbptt_detaches_between_segments(monkeypatch):
    """Each segment starts from the last one's state with no autograd
    history (else the graph of the whole sequence stays alive)."""
    _, net = _pair(tbptt=5)
    seen = []
    step = net._train_step

    def spy(states, *a, **kw):
        seen.append([t for sub in states.values() for t in sub.values()])
        return step(states, *a, **kw)

    monkeypatch.setattr(net, "_train_step", spy)
    x, y = _batch(30)
    net.fit(x, y)
    assert len(seen) == 3
    assert all(len(ts) == 4 for ts in seen)      # h, c of both layers
    assert all(t.grad_fn is None and not t.requires_grad
               for ts in seen for t in ts)
    assert all(float(t.abs().sum()) == 0 for t in seen[0])
    assert all(float(t.abs().sum()) > 0 for t in seen[1])


def test_fit_steps_matches_jax():
    """fit_steps carries the recurrent state from step to step, as the
    JAX package's compiled loop does, and refuses masks."""
    jnet, net = _pair()
    x, y = _batch(40)
    jnet.fit_steps(JDataSet(x, y), 4)
    net.fit_steps(DataSet(x, y), 4)
    np.testing.assert_allclose(net.score(), float(jnet.score()), rtol=RTOL,
                               atol=ATOL)
    assert net.iteration_count == 4
    _assert_same_params(jnet, net)
    with pytest.raises(ValueError, match="masked"):
        net.fit_steps(DataSet(x, y, labels_mask=np.ones((B, T))), 2)


def _masks(seed):
    lengths = np.random.RandomState(seed).randint(3, T + 1, B)
    lengths[0] = T
    m = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)
    return m


def test_masked_fit_and_evaluate_match_jax():
    """Features mask through every recurrent layer, labels mask in the
    loss and in the evaluation."""
    jnet, net = _pair()
    for step in range(3):
        x, y = _batch(50 + step)
        m = _masks(step)
        jnet.fit(JDataSet(x, y, features_mask=m, labels_mask=m))
        net.fit(DataSet(x, y, features_mask=m, labels_mask=m))
        np.testing.assert_allclose(net.score(), float(jnet.score()),
                                   rtol=RTOL, atol=ATOL)
    _assert_same_params(jnet, net)
    x, y = _batch(60)
    m = _masks(7)
    np.testing.assert_allclose(net.output(x, mask=m).numpy(),
                               np.asarray(jnet.output(x, mask=m)),
                               rtol=RTOL, atol=ATOL)
    jev = jnet.evaluate([JDataSet(x, y, features_mask=m, labels_mask=m)])
    ev = net.evaluate([DataSet(x, y, features_mask=m, labels_mask=m)])
    np.testing.assert_array_equal(ev.confusion_matrix(),
                                  jev.confusion_matrix())
    assert ev.confusion_matrix().sum() == m.sum()


def test_rnn_time_step_stream_matches_jax_and_output():
    jnet, net = _pair()
    x, _ = _batch(70)
    outs, jouts = [], []
    for t in range(T):
        o = net.rnn_time_step(x[:, t])
        assert o.shape == (B, V)
        outs.append(o)
        jouts.append(np.asarray(jnet.rnn_time_step(x[:, t])))
    got = torch.stack(outs, 1).numpy()
    np.testing.assert_allclose(got, np.stack(jouts, 1), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got, net.output(x).numpy(), rtol=0,
                               atol=1e-5)
    for i in (0, 1):
        s, js = net.rnn_get_previous_state(i), jnet.rnn_get_previous_state(i)
        assert sorted(s) == ["c", "h"]
        for k in s:
            np.testing.assert_allclose(s[k].numpy(), np.asarray(js[k]),
                                       rtol=RTOL, atol=ATOL)
    # a chunk continues the stream; a changed batch size raises
    chunk = net.rnn_time_step(x[:, :3])
    assert chunk.shape == (B, 3, V)
    with pytest.raises(ValueError, match="batch size"):
        net.rnn_time_step(x[:2, 0])
    net.rnn_clear_previous_state()
    assert net.rnn_get_previous_state(0) is None
    np.testing.assert_allclose(net.rnn_time_step(x[:2, 0]).numpy(),
                               net.output(x[:2, :1])[:, 0].numpy(),
                               rtol=0, atol=1e-5)


def test_rnn_time_step_refuses_bidirectional():
    jnet, net = _pair(bidirectional=True)
    x, y = _batch(80)
    np.testing.assert_allclose(net.output(x).numpy(),
                               np.asarray(jnet.output(x)), rtol=RTOL,
                               atol=ATOL)
    with pytest.raises(ValueError, match="Bidirectional"):
        net.rnn_time_step(x[:, 0])


def test_feed_forward_matches_jax():
    jnet, net = _pair()
    x, _ = _batch(90)
    got, want = net.feed_forward(x), jnet.feed_forward(x)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


def test_text_generation_lstm_forward_matches_jax():
    kw = dict(total_unique_characters=V, max_length=T, units=16)
    jnet = JTextGen(**kw).init()
    conf = TextGenerationLSTM(**kw).conf()
    assert json.loads(conf.to_json()) == json.loads(jnet.conf.to_json())
    p, s = params_from_jax(_np_tree(jnet.params), {}, conf)
    net = MultiLayerNetwork(conf).set_params(p, s, "cpu")
    x, y = _batch(100)
    np.testing.assert_allclose(net.output(x).numpy(),
                               np.asarray(jnet.output(x)), rtol=2e-5,
                               atol=1e-6)
    fresh = TextGenerationLSTM(**kw).init("cpu")
    assert {k: {n: t.shape for n, t in sub.items()}
            for k, sub in fresh.params.items()} == \
        {k: {n: t.shape for n, t in sub.items()} for k, sub in p.items()}
    jnet.fit(x, y)
    net.fit(x, y)
    np.testing.assert_allclose(net.score(), float(jnet.score()), rtol=RTOL,
                               atol=ATOL)


def test_graph_with_a_recurrent_vertex_matches_jax():
    """A ComputationGraph zeroes and drops recurrent state per batch as
    the MultiLayerNetwork does: the same 3-step trajectory as the JAX
    package's graph, and no state left after fit."""
    from deeplearning4j_tpu_torch.nn.conf.graph_conf import \
        ComputationGraphConfiguration
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    def build(builder, graves, rnn_out, input_type, adam, tanh, mcxent,
              softmax):
        return (builder.Builder().seed(7).updater(adam(5e-3))
                .graph_builder().add_inputs("in")
                .set_input_types(input_type.recurrent(V, T))
                .add_layer("lstm", graves(n_out=H, activation=tanh), "in")
                .add_layer("out", rnn_out(n_out=V, loss_function=mcxent,
                                          activation=softmax), "lstm")
                .set_outputs("out").build())

    from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
    jg = JGraph(build(JBuilder, JGraves, JRnnOut, JInputType, JAdam,
                      JActivation.TANH, JLoss.MCXENT,
                      JActivation.SOFTMAX)).init()
    conf = build(NeuralNetConfiguration, GravesLSTM, RnnOutputLayer,
                 InputType, Adam, Activation.TANH, LossFunction.MCXENT,
                 Activation.SOFTMAX)
    assert json.loads(conf.to_json()) == json.loads(jg.conf.to_json())
    assert ComputationGraphConfiguration.from_json(conf.to_json()).to_json() \
        == conf.to_json()
    p, s = params_from_jax(_np_tree(jg.params), _np_tree(jg.states), conf)
    g = ComputationGraph(conf).set_params(p, s, "cpu")
    for step in range(3):
        x, y = _batch(110 + step)
        jg.fit(x, y)
        g.fit(x, y)
        np.testing.assert_allclose(g.score(), float(jg.score()), rtol=RTOL,
                                   atol=ATOL)
        assert g.states["lstm"] == {}
    x, _ = _batch(120)
    np.testing.assert_allclose(g.output(x).numpy(), np.asarray(jg.output(x)),
                               rtol=RTOL, atol=ATOL)
