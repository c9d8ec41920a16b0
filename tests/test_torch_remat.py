"""Rematerialization in the port (``common/remat.py``,
``remat_segments`` of MultiLayerNetwork and ComputationGraph,
``SameDiff.set_remat_segments``, BERT's ``remat``) on the CPU.

Remat reschedules training and changes no value: with dropout on, a
segmented step (``torch.utils.checkpoint``) is held bit for bit to the
plain step, since the recompute runs the same ops from the same keys
(the layer's key is ``fold_in(step key, layer index)`` either way), and
the BatchNormalization state is the first forward's. Against the JAX
package, whose random streams cannot be matched, the segmented
trajectories are held without dropout at the reference's gradient bar
(rtol 2e-4 / atol 1e-5), and the segment plans and SameDiff's cut costs
are equal. BERT-tiny with ``remat`` True and "dots" gives
``remat=False``'s steps with dropout on (within 1e-6: the CPU's BERT
step is not bitwise repeatable even without remat), and "dots" runs no
more matrix products than False, True one forward's more.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from deeplearning4j_tpu.activations import Activation as JAct
from deeplearning4j_tpu.autodiff.samediff import SameDiff as JSameDiff
from deeplearning4j_tpu.autodiff.training import \
    TrainingConfig as JTrainingConfig
from deeplearning4j_tpu.common import remat as jremat
from deeplearning4j_tpu.learning import updaters as ju
from deeplearning4j_tpu.models.bert import Bert as JBert
from deeplearning4j_tpu.models.bert import BertConfig as JBertConfig
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.nn.conf.builders import \
    NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.graph_conf import \
    ComputationGraphConfiguration as JGraphConf
from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu_torch.activations import Activation
from deeplearning4j_tpu_torch.autodiff import SameDiff, TrainingConfig
from deeplearning4j_tpu_torch.common import remat
from deeplearning4j_tpu_torch.common.rng import RngKey
from deeplearning4j_tpu_torch.learning import updaters as tu
from deeplearning4j_tpu_torch.models import Bert, BertConfig
from deeplearning4j_tpu_torch.models.bert import (_device_batch,
                                                  flatten_tree)
from deeplearning4j_tpu_torch.nn.conf import layers as tl
from deeplearning4j_tpu_torch.nn.conf.builders import (
    MultiLayerConfiguration, NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.conf.graph_conf import \
    ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.utils.serializer import params_from_jax
from test_torch_accumulation import _graph_batch, _same_model, graph_pair

RTOL, ATOL = 2e-4, 1e-5


# -- the plans ---------------------------------------------------------------
@pytest.mark.parametrize("n,segs", [(1, 4), (7, 2), (7, 6), (10, 3),
                                    (53, 4), (20, 200)])
def test_segment_plans_match_jax(n, segs):
    assert remat.segment_plan(n, segs) == jremat.segment_plan(n, segs)
    cost = np.random.RandomState(n).rand(n + 1)
    assert remat.min_cut_segment_plan(n, segs, cost) == \
        jremat.min_cut_segment_plan(n, segs, cost)


def test_min_cut_plan_prefers_low_cost_indices():
    n = 100
    cost = np.full(n + 1, 10.0)
    cost[23] = cost[71] = 1.0
    plan = remat.min_cut_segment_plan(n, 3, cost)
    assert [lo for lo, _, _ in plan] + [plan[-1][1]] == [0, 23, 71, 100]
    assert remat.min_cut_segment_plan(n, 3, np.zeros(n + 1)) == \
        remat.segment_plan(n, 3)


# -- MultiLayerNetwork -------------------------------------------------------
def _mln_conf(NNC, IT, L, Act, up, segs=0, dropout=None):
    return (NNC.Builder().seed(7).updater(up).remat_segments(segs).list()
            .layer(L.ConvolutionLayer(n_out=8, kernel_size=(3, 3),
                                      activation=Act.RELU))
            .layer(L.BatchNormalization())
            .layer(L.ConvolutionLayer(n_out=8, kernel_size=(3, 3),
                                      activation=Act.RELU,
                                      dropout=dropout))
            .layer(L.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
            .layer(L.DenseLayer(n_out=16, activation=Act.RELU,
                                dropout=dropout))
            .layer(L.OutputLayer(n_out=4, dropout=dropout))
            .set_input_type(IT.convolutional(12, 12, 3)).build())


def _port_mln(segs, dropout=None):
    return MultiLayerNetwork(_mln_conf(
        NeuralNetConfiguration, InputType, tl, Activation,
        tu.Adam(1e-2), segs, dropout)).init("cpu")


def _mln_batch(seed=0, n=8):
    r = np.random.RandomState(seed)
    return (r.randn(n, 12, 12, 3).astype(np.float32),
            np.eye(4, dtype=np.float32)[r.randint(0, 4, n)])


def _assert_equal_nets(a, b):
    assert a.score() == b.score()
    for tree in ("params", "states"):
        for k, sub in getattr(a, tree).items():
            for n, t in sub.items():
                assert torch.equal(t, getattr(b, tree)[k][n]), (tree, k, n)


@pytest.mark.parametrize("segs", [2, 3, 200])
def test_mln_remat_with_dropout_equals_plain(segs):
    """Three steps with dropout (retain 0.7) and a BatchNormalization:
    losses, parameters and running statistics bit for bit; 200 segments
    clamp to one a layer."""
    plain, seg = _port_mln(0, 0.7), _port_mln(segs, 0.7)
    x, y = _mln_batch()
    for _ in range(3):
        plain.fit(x, y)
        seg.fit(x, y)
    _assert_equal_nets(plain, seg)
    assert np.isfinite(seg.score())


def test_mln_remat_trajectory_matches_jax():
    """No dropout (the streams differ): the JAX package's segmented
    step against the port's, 4 Nesterovs steps."""
    jnet = JMLN(_mln_conf(JNNC, JIT, jl, JAct, ju.Nesterovs(0.02, 0.9),
                          3)).init()
    conf = _mln_conf(NeuralNetConfiguration, InputType, tl, Activation,
                     tu.Nesterovs(0.02, 0.9), 3)
    p, s = params_from_jax(
        {k: {n: np.asarray(a) for n, a in sub.items()}
         for k, sub in jnet.params.items()},
        {k: {n: np.asarray(a) for n, a in sub.items()}
         for k, sub in jnet.states.items()}, conf)
    net = MultiLayerNetwork(conf).set_params(p, s, "cpu")
    for i in range(4):
        x, y = _mln_batch(i)
        jnet.fit(x, y)
        net.fit(x, y)
        np.testing.assert_allclose(net.score(), float(jnet.score()),
                                   rtol=RTOL, atol=ATOL)
    _same_model(jnet, net, ATOL)


def test_inference_ignores_remat():
    x, _ = _mln_batch()
    assert torch.equal(_port_mln(0).output(x), _port_mln(4).output(x))
    assert torch.equal(_port_mln(0).output(x, train=True),
                       _port_mln(4).output(x, train=True))


def test_remat_segments_json_crosses_both_ways():
    conf = _mln_conf(NeuralNetConfiguration, InputType, tl, Activation,
                     tu.Adam(1e-2), 3, 0.6)
    from deeplearning4j_tpu.nn.conf.builders import \
        MultiLayerConfiguration as JConf
    j = JConf.from_json(conf.to_json())
    assert j.remat_segments == 3
    assert MultiLayerConfiguration.from_json(j.to_json()).to_json() == \
        conf.to_json()
    _, net = graph_pair(ju.Sgd(0.1), tu.Sgd(0.1), remat_segments=4)
    jg = JGraphConf.from_json(net.conf.to_json())
    assert jg.remat_segments == 4
    assert ComputationGraphConfiguration.from_json(
        jg.to_json()).to_json() == net.conf.to_json()


# -- ComputationGraph --------------------------------------------------------
@pytest.mark.parametrize("segs", [2, 4, 6])
def test_graph_remat_with_dropout_equals_plain(segs):
    """The residual graph (a skip across a boundary at 6 segments of 7
    vertices), dropout 0.5 on its dense layer: bit for bit, the
    BatchNormalization state included."""
    nets = [graph_pair(ju.Adam(1e-2), tu.Adam(1e-2), remat_segments=s,
                       dropout=0.5)[1] for s in (0, segs)]
    for i in range(3):
        x, y = _graph_batch(i)
        for n in nets:
            n.fit(x, y)
    _assert_equal_nets(*nets)


def test_graph_remat_trajectory_matches_jax():
    jnet, net = graph_pair(ju.Nesterovs(0.05, 0.9), tu.Nesterovs(0.05, 0.9),
                           remat_segments=3)
    for i in range(4):
        x, y = _graph_batch(i)
        jnet.fit(x, y)
        net.fit(x, y)
        np.testing.assert_allclose(net.score(), float(jnet.score()),
                                   rtol=RTOL, atol=ATOL)
    _same_model(jnet, net, ATOL)


# -- SameDiff ----------------------------------------------------------------
def _sd(pkg, cfg, updater, segs, device=None):
    sd = pkg(device=device) if device else pkg()
    x = sd.placeholder("x", shape=(None, 8))
    y = sd.placeholder("y", shape=(None, 4))
    h = x
    rs = np.random.RandomState(3)
    for i in range(6):
        w = sd.var(f"w{i}", array=(rs.randn(8, 8) * 0.3).astype(np.float32))
        h = sd.nn.tanh(h @ w)
    wo = sd.var("wo", array=(rs.randn(8, 4) * 0.3).astype(np.float32))
    sd.loss.mean_squared_error(y, h @ wo, name="loss")
    sd.set_loss_variables("loss")
    sd.set_training_config(cfg.Builder().updater(updater)
                           .data_set_feature_mapping("x")
                           .data_set_label_mapping("y").build())
    if segs:
        sd.set_remat_segments(segs)
    return sd


def _sd_batch():
    rs = np.random.RandomState(0)
    return {"x": rs.randn(32, 8).astype(np.float32),
            "y": rs.randn(32, 4).astype(np.float32)}


@pytest.mark.parametrize("segs", [3, 4, 10_000])
def test_samediff_remat_equals_plain_and_matches_jax(segs):
    batch = _sd_batch()
    plain = _sd(SameDiff, TrainingConfig, tu.Adam(0.01), 0, "cpu")
    seg = _sd(SameDiff, TrainingConfig, tu.Adam(0.01), segs, "cpu")
    lp, ls = plain.fit_steps(batch, 8), seg.fit_steps(batch, 8)
    assert ls == lp
    for n in ("w0", "w5", "wo"):
        assert torch.equal(seg._arrays[n], plain._arrays[n]), n
    g0 = plain.calculate_gradients(batch, ["w0"])["w0"]
    assert torch.equal(seg.calculate_gradients(batch, ["w0"])["w0"], g0)
    jsd = _sd(JSameDiff, JTrainingConfig, ju.Adam(0.01), segs)
    np.testing.assert_allclose(ls, jsd.fit_steps(batch, 8), rtol=RTOL,
                               atol=ATOL)
    for n in ("w0", "wo"):
        np.testing.assert_allclose(seg.vars[n].get_arr(),
                                   np.asarray(jsd.get_variable(n).get_arr()),
                                   rtol=RTOL, atol=ATOL)


def test_samediff_cut_costs_weigh_bytes_as_the_jax_package_does():
    """One huge live tensor costs more than two small ones; the sizes
    (a meta-tensor pass here, jax.eval_shape there) and the costs equal
    the JAX package's."""
    import jax

    def build(sd):
        x = sd.placeholder("x", shape=(2, 4))
        big = sd._op("tile", [x], {"reps": (64, 64)})
        shrunk = sd.math.reduce_sum(big, axis=1)
        both = sd.math.add(sd.math.sin(shrunk), sd.math.cos(shrunk))
        return big, shrunk, sd.math.reduce_sum(both)
    sd, jsd = SameDiff(device="cpu"), JSameDiff()
    big, _, out = build(sd)
    build(jsd)
    ops = list(range(len(sd.ops)))
    sizes = sd._value_sizes({"x": torch.zeros(2, 4)}, ops)
    jsizes = jsd._value_sizes({"x": jnp.zeros((2, 4), jnp.float32)}, ops,
                              jax.random.PRNGKey(0), False)
    assert sizes == jsizes and sizes[big.name] == 128 * 256 * 4
    costs = sd._segment_cut_costs(ops, (out.name,), sizes)
    np.testing.assert_array_equal(
        costs, jsd._segment_cut_costs(ops, (out.name,), jsizes))
    assert costs[1] > costs[4]


def test_setting_segments_drops_cached_plans():
    sd = _sd(SameDiff, TrainingConfig, tu.Adam(0.01), 3, "cpu")
    sd.fit_steps(_sd_batch(), 1)
    assert any(k[0] == "remat" for k in sd._exec_cache)
    sd.set_remat_segments(2)
    assert not sd._exec_cache


# -- BERT --------------------------------------------------------------------
class _CountProducts(TorchDispatchMode):
    """Counts the matrix products dispatched (forward, recompute and
    backward)."""
    OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
           torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func in self.OPS
        return func(*args, **(kwargs or {}))


def _bert_batch(n=4, t=32, vocab=1000, seed=0):
    rs = np.random.RandomState(seed)
    ids = rs.randint(5, vocab, (n, t))
    am = np.ones((n, t), np.float32)
    am[1, 20:] = 0.0
    return {"input_ids": ids, "token_type_ids": np.zeros((n, t), int),
            "attention_mask": am,
            "mlm_labels": np.where(rs.rand(n, t) < 0.2, ids, -1),
            "nsp_labels": rs.randint(0, 2, n)}


@pytest.mark.parametrize("flash", [False, True], ids=["dense", "flash"])
def test_bert_remat_equals_no_remat_with_dropout(flash):
    """Two Sgd steps with hidden dropout 0.1 from the same keys: True and
    "dots" give remat=False's losses and updates, within 1e-6 (the
    updates norm-wise over all parameters; two remat=False runs differ
    by as much, the CPU's embedding backward adding in no fixed order).
    "dots" saves every product (no more than False); True recomputes
    each layer's forward products: 8 on the dense route (q, k, v, o, the
    two FFN ones and the attention's two), 6 on the flash route, where
    the attention is the custom op ``dl4j::flash_fwd``, one node to the
    dispatcher on the CPU as on the card (chip_smoke.py counts 6 a
    layer there)."""
    conf = BertConfig.tiny(hidden_dropout_prob=0.1,
                           attention_probs_dropout_prob=0.0,
                           max_predictions_per_seq=5,
                           use_flash_attention=flash)
    batch = _device_batch(_bert_batch(), "cpu")
    runs, p0 = {}, None
    for mode in (False, True, "dots"):
        bert = Bert(dataclasses.replace(conf, remat=mode),
                    tu.Sgd(0.05)).init("cpu")
        p0 = p0 or {n: t.clone() for n, t in flatten_tree(bert.params)
                    .items()}
        bert._ensure_state()
        count = _CountProducts()
        with count:
            losses = [float(bert._step(batch, RngKey(5).fold_in(i)))
                      for i in range(2)]
        runs[mode] = (losses, count.n, {
            n: t - p0[n] for n, t in flatten_tree(bert.params).items()})
    ref = runs[False]
    for mode in (True, "dots"):
        np.testing.assert_allclose(runs[mode][0], ref[0], rtol=1e-6)
        num = sum(float((t - ref[2][n]).double().pow(2).sum())
                  for n, t in runs[mode][2].items())
        den = sum(float(t.double().pow(2).sum()) for t in ref[2].values())
        assert (num / den) ** 0.5 <= 1e-6, mode
    L = conf.num_hidden_layers
    assert runs["dots"][1] == ref[1]
    assert runs[True][1] == ref[1] + 2 * L * (6 if flash else 8)


def test_bert_remat_trajectory_matches_jax():
    """remat=True in both packages, no dropout: 3 Sgd steps at the
    reference's gradient bar."""
    jconf = JBertConfig.tiny(hidden_dropout_prob=0.0,
                             attention_probs_dropout_prob=0.0, remat=True)
    jb = JBert(jconf, ju.Sgd(0.05)).init()
    conf = BertConfig.tiny(hidden_dropout_prob=0.0,
                           attention_probs_dropout_prob=0.0, remat=True)
    params, _ = params_from_jax(
        {k: ({n: np.asarray(a) for n, a in v.items()})
         for k, v in jb.params.items()}, {}, conf)
    port = Bert(conf, tu.Sgd(0.05)).set_params(params, "cpu")
    b = _bert_batch(seed=1)
    for step in range(3):
        want, got = jb.fit_batch(b), port.fit_batch(b)
        assert abs(got - want) <= RTOL * abs(want) + ATOL, (step, got, want)
