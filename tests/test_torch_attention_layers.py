"""The port's attention layers (``nn/conf/layers_attention.py``) and the
flash ladder at wide heads and float64, against the JAX package on the
CPU.

Parameters cross by ``params_from_jax`` and the serializer; the same
seeded numpy inputs go through both packages. Tolerances: forward rtol
2e-5 (atol 2e-6), gradients rtol 2e-4 (atol 2e-5), a 5-step trajectory
2e-4 (under Sgd: Adam turns gradient entries at summation noise into
full-lr steps). By default both packages run the dense chain here (the
JAX package's auto rung is off off a TPU, the port's off the card);
the forced cases run the JAX Pallas kernels in interpret mode
(``DL4J_TPU_FLASH_ATTENTION=1``) against the port's forced flash route,
the kernels' plain versions (``DL4J_TORCH_FLASH_ATTENTION=1``), on
ragged key masks with a fully masked sequence.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.conf import layers_attention as jla
from deeplearning4j_tpu.nn.conf.builders import \
    NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.utils.serializer import \
    ModelSerializer as JSerializer
from deeplearning4j_tpu_torch.common.environment import Environment
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.nn.conf import layers_attention as tla
from deeplearning4j_tpu_torch.nn.conf.builders import \
    NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.graph_conf import \
    ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import attention_kernels as ak
from deeplearning4j_tpu_torch.ops import kernel_select
from deeplearning4j_tpu_torch.parallel import sequence as sq
from deeplearning4j_tpu_torch.utils.serializer import (ModelSerializer,
                                                       params_from_jax,
                                                       params_to_jax)
from torch_parity import one_intraop_thread  # noqa: F401,E402

FWD = dict(rtol=2e-5, atol=2e-6)
GRAD = dict(rtol=2e-4, atol=2e-5)
TRAJ = dict(rtol=2e-4, atol=1e-5)
B, T, F = 3, 7, 8

#: name -> the kwargs of both packages' layer
LAYERS = {
    "self": dict(n_in=F, n_out=F, n_heads=2),
    "self_bias": dict(n_in=F, n_out=6, n_heads=2, has_bias=True),
    "self_unprojected": dict(n_in=F, n_out=F, n_heads=1,
                             project_input=False),
    "learned": dict(n_in=F, n_out=F, n_heads=2, n_queries=2),
    "recurrent": dict(n_in=F, n_out=6, n_heads=2),
}
CLASSES = {"self": "SelfAttentionLayer", "self_bias": "SelfAttentionLayer",
           "self_unprojected": "SelfAttentionLayer",
           "learned": "LearnedSelfAttentionLayer",
           "recurrent": "RecurrentAttentionLayer"}


@pytest.fixture(autouse=True)
def _gates_unset(monkeypatch):
    for var in ("DL4J_TPU_FLASH_ATTENTION", "DL4J_TORCH_FLASH_ATTENTION"):
        monkeypatch.delenv(var, raising=False)
    Environment.reset()
    yield
    Environment.reset()


def _mask(seed, b=B, t=T):
    """Ragged lengths, the first sequence full and the second fully
    masked."""
    lengths = np.random.RandomState(seed).randint(1, t + 1, b)
    lengths[0], lengths[1] = t, 0
    return (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)


def _layer_pair(name):
    kw = LAYERS[name]
    jlayer = getattr(jla, CLASSES[name])(**kw)
    layer = getattr(tla, CLASSES[name])(**kw)
    jp = jlayer.init_params(jax.random.PRNGKey(3),
                            JInputType.recurrent(F, T))
    p = {n: torch.tensor(np.asarray(a)) for n, a in jp.items()}
    return jlayer, jp, layer, p


def _x(seed=0, b=B, t=T):
    return np.random.RandomState(seed).randn(b, t, F).astype(np.float32)


def _run_jax(jlayer, jp, x, m):
    kw = {"mask": jnp.asarray(m)} if m is not None else {}
    y, _ = jlayer.forward(jp, jnp.asarray(x), training=False, **kw)
    return np.asarray(y)


def _run(layer, p, x, m):
    kw = {"mask": torch.tensor(m)} if m is not None else {}
    y, _ = layer.forward(p, torch.tensor(x), training=False, **kw)
    return y


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("name", sorted(LAYERS))
def test_forward_matches_jax(name, masked):
    jlayer, jp, layer, p = _layer_pair(name)
    x, m = _x(), (_mask(1) if masked else None)
    got = _run(layer, p, x, m)
    np.testing.assert_allclose(got.numpy(), _run_jax(jlayer, jp, x, m),
                               **FWD)
    in_type = InputType.recurrent(F, T)
    assert layer.get_output_type(in_type).to_map() == \
        jlayer.get_output_type(JInputType.recurrent(F, T)).to_map()


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("name", ["self", "self_bias", "self_unprojected",
                                  "learned", "recurrent"])
def test_gradients_match_jax(name, masked):
    jlayer, jp, layer, p = _layer_pair(name)
    x, m = _x(2), (_mask(3) if masked else None)
    out_shape = _run_jax(jlayer, jp, x, m).shape
    do = np.random.RandomState(4).randn(*out_shape).astype(np.float32)
    kw = {"mask": jnp.asarray(m)} if m is not None else {}

    def loss(jp, x):
        y, _ = jlayer.forward(jp, x, training=False, **kw)
        return jnp.sum(y * do)

    jg_p, jg_x = jax.grad(loss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = {n: t.clone().requires_grad_(True) for n, t in p.items()}
    xt = torch.tensor(x, requires_grad=True)
    y, _ = layer.forward(leaves, xt, training=False,
                         **({"mask": torch.tensor(m)} if m is not None
                            else {}))
    (y * torch.tensor(do)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg_x), **GRAD)
    for n, t in leaves.items():
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg_p[n]),
                                   err_msg=n, **GRAD)


@pytest.mark.parametrize("name", ["self", "learned"])
def test_forced_flash_route_matches_jax_pallas_kernel(name, monkeypatch):
    """t_q = t_k (self-attention) and t_q = 2 against t_k = 7 (learned
    queries), ragged key masks with a fully masked sequence: the JAX
    Pallas kernel (interpret mode) against the port's flash route (the
    kernels' plain versions), forward and input gradient."""
    jlayer, jp, layer, p = _layer_pair(name)
    x, m = _x(5), _mask(6)
    monkeypatch.setenv("DL4J_TPU_FLASH_ATTENTION", "1")
    monkeypatch.setenv("DL4J_TORCH_FLASH_ATTENTION", "1")
    do = np.random.RandomState(7).randn(
        *_run_jax(jlayer, jp, x, m).shape).astype(np.float32)

    def loss(x):
        y, _ = jlayer.forward(jp, x, training=False, mask=jnp.asarray(m))
        return jnp.sum(y * do), y

    (_, want), jg_x = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(x))
    before = kernel_select.decisions("attention")["forced"]
    xt = torch.tensor(x, requires_grad=True)
    y, _ = layer.forward(p, xt, training=False, mask=torch.tensor(m))
    assert kernel_select.decisions("attention")["forced"] == before + 1
    (y * torch.tensor(do)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want), **FWD)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg_x), **GRAD)


@pytest.mark.parametrize("gate", ["0", "1"], ids=["dense", "flash"])
def test_fully_masked_sequence_gives_exact_zeros(gate, monkeypatch):
    """Both routes give a fully masked sequence exactly 0 (the dense
    chain masks with -1e9 and zeroes the weights after the softmax, the
    kernels mask with -1e30), and zero gradients."""
    monkeypatch.setenv("DL4J_TORCH_FLASH_ATTENTION", gate)
    for name in ("self", "learned"):
        _, _, layer, p = _layer_pair(name)
        leaves = {n: t.clone().requires_grad_(True) for n, t in p.items()}
        xt = torch.tensor(_x(8), requires_grad=True)
        y, _ = layer.forward(leaves, xt, training=False,
                             mask=torch.tensor(_mask(9)))
        y.sum().backward()
        # the learned queries' readout of no key is 0, then projected by
        # Wo (no bias here)
        assert not bool(y[1].any())
        assert not bool(xt.grad[1].any())


def test_recurrent_layer_holds_h_on_masked_steps():
    _, _, layer, p = _layer_pair("recurrent")
    m = np.ones((B, T), np.float32)
    m[0, 3:] = 0.0
    y, st = layer.forward(p, torch.tensor(_x(10)), training=False,
                          mask=torch.tensor(m))
    for t in range(3, T):
        assert torch.equal(y[0, t], y[0, 2])
    assert torch.equal(st["h"][0], y[0, 2])
    assert not torch.equal(y[2, 3], y[2, 2])


def test_recurrent_layer_promotes_a_float32_state_over_bf16_weights():
    """Under compute_dtype the fit starts from float32 zero states
    against 16-bit weights: the step runs in float32, as jnp promotes."""
    _, _, layer, p = _layer_pair("recurrent")
    p16 = {n: t.to(torch.bfloat16) for n, t in p.items()}
    x = torch.tensor(_x(11)).to(torch.bfloat16)
    y, st = layer.forward(p16, x, training=False,
                          state=layer.zero_state(B, torch.float32),
                          mask=torch.tensor(_mask(12)))
    assert y.dtype == st["h"].dtype == torch.float32


@pytest.mark.parametrize("name", ["self", "learned", "recurrent"])
def test_input_dropout_with_the_jax_mask_matches_jax(name, monkeypatch):
    """Input dropout in training: the JAX package's mask (read off its
    dropped input, which has no zeros otherwise) injected into the
    port's ``apply_noise``; the layer's output equals the JAX
    package's."""
    from deeplearning4j_tpu_torch.nn.conf import dropout as td
    kw = dict(LAYERS[name], dropout=0.8)
    jlayer = getattr(jla, CLASSES[name])(**kw)
    layer = getattr(tla, CLASSES[name])(**kw)
    jp = jlayer.init_params(jax.random.PRNGKey(3),
                            JInputType.recurrent(F, T))
    p = {n: torch.tensor(np.asarray(a)) for n, a in jp.items()}
    x, m, key = _x(13), _mask(14), jax.random.PRNGKey(5)
    jdropped = np.asarray(jlayer._maybe_dropout(jnp.asarray(x), True, key))
    want, _ = jlayer.forward(jp, jnp.asarray(x), training=True, rng=key,
                             mask=jnp.asarray(m))
    keep = torch.from_numpy(jdropped != 0)
    monkeypatch.setattr(layer, "_maybe_dropout", lambda x, training, rng:
                        td.Dropout(0.8).apply_noise(x, keep))
    got, _ = layer.forward(p, torch.tensor(x), training=True, rng=object(),
                           mask=torch.tensor(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_json_round_trip_matches_jax(name):
    from deeplearning4j_tpu.nn.conf.layers import Layer as JLayer
    from deeplearning4j_tpu_torch.nn.conf.layers import Layer
    jm = getattr(jla, CLASSES[name])(**LAYERS[name]).to_map()
    m = getattr(tla, CLASSES[name])(**LAYERS[name]).to_map()
    assert json.loads(json.dumps(m)) == json.loads(json.dumps(jm))
    assert Layer.from_map(jm).to_map() == m
    assert JLayer.from_map(m).to_map() == jm


def test_unprojected_layer_refuses_several_heads():
    with pytest.raises(ValueError, match="n_heads=1"):
        tla.SelfAttentionLayer(n_in=F, n_heads=2, project_input=False
                               ).init_params(torch.Generator(), None)


# ---------------------------------------------------------------------------
# wide heads and float64: the ladder takes them to the kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", [
    ((2, 1, 16, 768), (2, 1, 16, 768), torch.float32),
    ((2, 16, 768), (2, 16, 768), torch.float32),
    ((2, 2, 16, 64), (2, 2, 16, 64), torch.float64),
], ids=["head_dim_768", "rank3_head_dim_768", "float64"])
def test_ladder_takes_wide_heads_and_float64_to_the_kernels(case,
                                                           monkeypatch):
    """No structural rung for a head dim above 256 or for float64: on the
    card such a site takes the kernels (their wide bodies). Here, on the
    forced route, the kernels' plain versions equal the dense chain, and
    the JAX package's dense answer."""
    qs, ks, dt = case
    before = kernel_select.decisions("attention")["structural"]
    assert ak.select_attention_backend(qs, ks, device="cuda")[0] == "flash"
    assert kernel_select.decisions("attention")["structural"] == before
    rs = np.random.RandomState(16)
    q, k, v = (rs.randn(*sh) for sh in (qs, ks, ks))
    m = np.ones((qs[0], ks[-2]))
    m[1, 5:] = 0.0
    mask = m.reshape((qs[0],) + (1,) * (len(qs) - 2) + (ks[-2],))
    tq, tk, tv, tm = (torch.tensor(a, dtype=dt) for a in (q, k, v, mask))
    from deeplearning4j_tpu_torch.ops import attention as tatt
    monkeypatch.setenv("DL4J_TORCH_FLASH_ATTENTION", "0")
    dense = tatt.dot_product_attention(tq, tk, tv, tm)
    monkeypatch.setenv("DL4J_TORCH_FLASH_ATTENTION", "1")
    forced = kernel_select.decisions("attention")["forced"]
    got = tatt.dot_product_attention(tq, tk, tv, tm)
    assert kernel_select.decisions("attention")["forced"] == forced + 1
    assert got.dtype == dt
    tight = dict(rtol=1e-12, atol=1e-13) if dt == torch.float64 else FWD
    torch.testing.assert_close(got, dense, **tight)
    from deeplearning4j_tpu.ops.attention import \
        dot_product_attention as jdpa
    want = jdpa(*(jnp.asarray(a, jnp.float32) for a in (q, k, v, mask)))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want), **FWD)


def test_ladder_keeps_the_jax_rungs():
    """A site that fails a JAX rung reports that rung, as the JAX
    package's ladder does."""
    from deeplearning4j_tpu.ops.attention_pallas import \
        select_attention_backend as jax_select
    qs, ks = (2, 2, 8, 300), (2, 2, 8, 300)
    want = jax_select(qs, ks, has_bias=True, platform="tpu", override=True)
    got = ak.select_attention_backend(qs, ks, has_bias=True, device="cuda",
                                      override=True)
    assert got == want


def test_kernels_take_any_head_dim_and_float64():
    """float64 has a kernel code and f64 lse rows (the wide bodies sum in
    f64); no head-dim cap is left. The wrappers still raise off the card
    and on dtypes they do not take."""
    assert sq.KERNEL_DTYPES[torch.float64] == 3
    assert not hasattr(sq, "MAX_HEAD_DIM")
    q = torch.zeros(1, 1, 4, 300, dtype=torch.float64)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        sq._check("flash_forward", q, q, q, None)
    out, lse = sq.flash_forward(q, q, q)          # the CPU's plain version
    assert out.dtype == lse.dtype == torch.float64


def test_unprojected_layer_over_768_features_computes_the_jax_answer(
        monkeypatch):
    """SelfAttentionLayer(project_input=False) over 768 features: a head
    dim of 768, which the ladder takes to the kernels on the card; here,
    on the forced route (their plain versions), equal to the JAX
    package's."""
    kw = dict(n_in=768, n_out=768, n_heads=1, project_input=False)
    rs = np.random.RandomState(15)
    x = rs.randn(2, 5, 768).astype(np.float32)
    m = np.ones((2, 5), np.float32)
    m[1, 2:] = 0.0
    want, _ = jla.SelfAttentionLayer(**kw).forward(
        {}, jnp.asarray(x), training=False, mask=jnp.asarray(m))
    monkeypatch.setenv("DL4J_TORCH_FLASH_ATTENTION", "1")
    forced = kernel_select.decisions("attention")["forced"]
    got, _ = tla.SelfAttentionLayer(**kw).forward(
        {}, torch.tensor(x), training=False, mask=torch.tensor(m))
    assert kernel_select.decisions("attention")["forced"] == forced + 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)
    assert ak.select_attention_backend((2, 5, 768), (2, 5, 768),
                                       device="cuda")[0] == "flash"


# ---------------------------------------------------------------------------
# the masked attention classifier, at a small width, against the JAX graph
# ---------------------------------------------------------------------------
V, TC, BC, HC = 29, 10, 4, 8


def build_classifier(pkg, updater, compute=None):
    """The phase-20 classifier's graph: token embedding, two
    self-attention blocks with residual adds, learned-query pooling and a
    softmax head behind an RnnToFeedForwardPreProcessor. ``pkg`` is
    ``"jax"`` or ``"torch"``."""
    if pkg == "jax":
        from deeplearning4j_tpu.nn.conf import graph_vertices as gv
        from deeplearning4j_tpu.nn.conf import layers as ly
        from deeplearning4j_tpu.nn.conf import layers_recurrent as lr
        from deeplearning4j_tpu.nn.conf import preprocessors as pp
        builder, it, att = JNNC, JInputType, jla
    else:
        from deeplearning4j_tpu_torch.nn.conf import graph_vertices as gv
        from deeplearning4j_tpu_torch.nn.conf import layers as ly
        from deeplearning4j_tpu_torch.nn.conf import layers_recurrent as lr
        from deeplearning4j_tpu_torch.nn.conf import preprocessors as pp
        builder, it, att = NeuralNetConfiguration, InputType, tla
    b = builder.Builder().seed(11).updater(updater)
    if compute:
        b = b.compute_data_type(compute)
    add = gv.ElementWiseVertex(op="Add")
    g = (b.graph_builder().add_inputs("tokens")
         .set_input_types(it.recurrent(1, TC))
         .add_layer("emb", lr.EmbeddingSequenceLayer(n_in=V, n_out=HC),
                    "tokens")
         .add_layer("sa1", att.SelfAttentionLayer(n_out=HC, n_heads=2),
                    "emb")
         .add_vertex("add1", add, "emb", "sa1")
         .add_layer("sa2", att.SelfAttentionLayer(n_out=HC, n_heads=2),
                    "add1")
         .add_vertex("add2", gv.ElementWiseVertex(op="Add"), "add1", "sa2")
         .add_layer("pool", att.LearnedSelfAttentionLayer(
             n_out=HC, n_heads=2, n_queries=1), "add2")
         .add_layer("out", ly.OutputLayer(n_out=2),
                    pp.RnnToFeedForwardPreProcessor(), "pool")
         .set_outputs("out"))
    return g.build()


def _classifier_pair(updater_name="Sgd", lr=0.1, compute=None):
    from deeplearning4j_tpu.learning import updaters as ju
    from deeplearning4j_tpu_torch.learning import updaters as tu
    jg = JGraph(build_classifier("jax", getattr(ju, updater_name)(lr),
                                 compute)).init()
    conf = build_classifier("torch", getattr(tu, updater_name)(lr), compute)
    assert json.loads(conf.to_json()) == json.loads(jg.conf.to_json())
    p, s = params_from_jax(jax.tree_util.tree_map(np.asarray, jg.params),
                           {}, conf)
    return jg, ComputationGraph(conf).set_params(p, s, "cpu")


def _classifier_batch(seed):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, V, (BC, TC)).astype(np.int32)
    lengths = rs.randint(2, TC + 1, BC)
    lengths[0], lengths[1] = TC, 2
    m = (np.arange(TC)[None, :] < lengths[:, None]).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rs.randint(0, 2, BC)]
    return ids, y, m


def _same_params(jg, net, **tol):
    want = params_to_jax(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jg.params), {}, net.conf)[0],
        net.conf)
    got = params_to_jax(net.params, net.conf)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def test_classifier_masked_trajectory_matches_jax():
    jg, net = _classifier_pair()
    assert isinstance(net.conf.vertices["out"].preprocessor,
                      type(ComputationGraphConfiguration.from_json(
                          net.conf.to_json()).vertices["out"].preprocessor))
    for step in range(5):
        ids, y, m = _classifier_batch(step)
        jg.fit(JDataSet(ids, y, features_mask=m))
        net.fit(DataSet(ids, y, features_mask=m))
        np.testing.assert_allclose(net.score(), float(jg.score()), **TRAJ)
    _same_params(jg, net, **TRAJ)
    ids, y, m = _classifier_batch(9)
    np.testing.assert_allclose(net.output(ids, mask=m).numpy(),
                               np.asarray(jg.output(ids, mask=m)), **TRAJ)
    np.testing.assert_allclose(
        net.score(DataSet(ids, y, features_mask=m)),
        jg.score(JDataSet(ids, y, features_mask=m)), **TRAJ)
    np.testing.assert_array_equal(net.predict(ids), jg.predict(ids))
    ev = net.evaluate([DataSet(ids, y, features_mask=m)])
    jev = jg.evaluate([JDataSet(ids, y, features_mask=m)])
    np.testing.assert_array_equal(ev.confusion_matrix(),
                                  jev.confusion_matrix())


def test_classifier_padded_tokens_change_nothing():
    _, net = _classifier_pair()
    ids, _, m = _classifier_batch(20)
    other = np.where(m > 0, ids, (ids + 7) % V).astype(np.int32)
    a, b = net.output(ids, mask=m), net.output(other, mask=m)
    assert torch.equal(a, b)
    assert not torch.equal(a, net.output(other))


def test_classifier_forced_flash_route_matches_the_dense_route(monkeypatch):
    """The port's classifier on its flash route (the kernels' plain
    versions) against its dense route: forward, and one step's update."""
    _, dense = _classifier_pair()
    _, flash = _classifier_pair()
    ids, y, m = _classifier_batch(21)
    want = dense.output(ids, mask=m)
    dense.fit(DataSet(ids, y, features_mask=m))
    monkeypatch.setenv("DL4J_TORCH_FLASH_ATTENTION", "1")
    before = kernel_select.decisions("attention")["forced"]
    got = flash.output(ids, mask=m)
    flash.fit(DataSet(ids, y, features_mask=m))
    # 3 sites a forward: output's, and the step's forward
    assert kernel_select.decisions("attention")["forced"] == before + 6
    np.testing.assert_allclose(got.numpy(), want.numpy(), **FWD)
    np.testing.assert_allclose(flash.score(), dense.score(), **FWD)
    for k in dense.params:
        for n, t in dense.params[k].items():
            np.testing.assert_allclose(flash.params[k][n].numpy(),
                                       t.numpy(), err_msg=f"{k}/{n}",
                                       **GRAD)


def test_classifier_bf16_compute_tracks_jax():
    """compute_dtype bf16: the first self-attention runs in bf16; the
    float32 mask then promotes the rest, as in the JAX package."""
    jg, net = _classifier_pair(compute="bfloat16")
    ids, y, m = _classifier_batch(22)
    for _ in range(3):
        jg.fit(JDataSet(ids, y, features_mask=m))
        net.fit(DataSet(ids, y, features_mask=m))
        np.testing.assert_allclose(net.score(), float(jg.score()),
                                   rtol=2e-2)
    assert all(t.dtype == torch.float32 for sub in net.params.values()
               for t in sub.values())


def test_jax_written_zip_of_the_classifier_restores_with_equal_outputs(
        tmp_path):
    jg, _ = _classifier_pair("Adam", 1e-3)
    ids, y, m = _classifier_batch(23)
    jg.fit(JDataSet(ids, y, features_mask=m))
    path = tmp_path / "classifier.zip"
    JSerializer.write_model(jg, str(path))
    net = ModelSerializer.restore_model(path, device="cpu")
    assert net.iteration_count == 1
    assert net.conf.vertices["out"].preprocessor is not None
    np.testing.assert_allclose(net.output(ids, mask=m).numpy(),
                               np.asarray(jg.output(ids, mask=m)), **FWD)
    # training resumes from the restored Adam state as the JAX graph does
    jg.fit(JDataSet(ids, y, features_mask=m))
    net.fit(DataSet(ids, y, features_mask=m))
    np.testing.assert_allclose(net.score(), float(jg.score()), **TRAJ)


def test_attention_layers_in_a_masked_multilayer_network_match_jax():
    from deeplearning4j_tpu.learning import updaters as ju
    from deeplearning4j_tpu.nn.conf import layers as jl
    from deeplearning4j_tpu_torch.learning import updaters as tu
    from deeplearning4j_tpu_torch.nn.conf import layers as tl

    def conf(builder, it, att, ly, sgd):
        return (builder.Builder().seed(5).updater(sgd(0.1)).list()
                .layer(att.RecurrentAttentionLayer(n_out=HC, n_heads=2))
                .layer(att.SelfAttentionLayer(n_out=HC, n_heads=2))
                .layer(ly.RnnOutputLayer(n_out=3))
                .set_input_type(it.recurrent(F, T)).build())

    jnet = JMLN(conf(JNNC, JInputType, jla, jl, ju.Sgd)).init()
    c = conf(NeuralNetConfiguration, InputType, tla, tl, tu.Sgd)
    assert json.loads(c.to_json()) == json.loads(jnet.conf.to_json())
    p, s = params_from_jax(jax.tree_util.tree_map(np.asarray, jnet.params),
                           {}, c)
    net = MultiLayerNetwork(c).set_params(p, s, "cpu")
    rs = np.random.RandomState(24)
    for step in range(3):
        x = rs.randn(B, T, F).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, (B, T))]
        m = _mask(25 + step)
        m[1, :2] = 1.0              # no fully masked sequence in a loss
        jnet.fit(JDataSet(x, y, features_mask=m, labels_mask=m))
        net.fit(DataSet(x, y, features_mask=m, labels_mask=m))
        np.testing.assert_allclose(net.score(), float(jnet.score()), **TRAJ)
    assert net.states["layer_0"] == {}
    np.testing.assert_allclose(net.output(x, mask=m).numpy(),
                               np.asarray(jnet.output(x, mask=m)), **TRAJ)
