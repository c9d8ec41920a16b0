"""The encoded update exchange (threshold-compressed, error feedback) and
``parallel/encoding.py`` in the port against the JAX package, on the
CPU.

The codecs run on seeded f32 and bf16 flats beside the JAX package's:
``threshold`` and ``int8`` bit for bit, ``1bit`` within 1e-6 (its
``mean|c|`` sums in another order). Training runs the JAX package's
encoded-rung MLP (``tests/test_encoded.py``) through the port's
``ParallelWrapper`` over N CPU thread replicas against the JAX wrapper
on N of the conftest's virtual devices: parameters and the dense
residual within 2e-4, τ, step and sparsity within 1e-6. The int8 and
1-bit scales and the transmitted fraction span the whole flat in the
JAX program (one global-view computation), so the port reduces them
across the replicas; a per-slice scale misses the JAX numbers, which a
case shows.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu.activations import Activation as JAct
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.iterators import \
    ListDataSetIterator as JList
from deeplearning4j_tpu.learning import updaters as ju
from deeplearning4j_tpu.lossfunctions import LossFunction as JLoss
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.nn.conf.builders import \
    NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn.weights import WeightInit as JWI
from deeplearning4j_tpu.parallel import ParallelWrapper as JaxWrapper
from deeplearning4j_tpu.parallel import SharedTrainingMaster as JMaster
from deeplearning4j_tpu.parallel import encoding as jenc
from deeplearning4j_tpu.parallel import zero as jzero
from deeplearning4j_tpu.utils.serializer import \
    ModelSerializer as JSerializer
from deeplearning4j_tpu_torch.activations import Activation
from deeplearning4j_tpu_torch.common import telemetry
from deeplearning4j_tpu_torch.common.environment import Environment
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.learning import updaters as tu
from deeplearning4j_tpu_torch.learning.updaters import (ENCODED_KEY,
                                                        is_encoded)
from deeplearning4j_tpu_torch.lossfunctions import LossFunction
from deeplearning4j_tpu_torch.nn.conf import layers as tl
from deeplearning4j_tpu_torch.nn.conf.builders import \
    NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.weights import WeightInit
from deeplearning4j_tpu_torch.parallel import encoding as tenc
from deeplearning4j_tpu_torch.parallel import zero
from deeplearning4j_tpu_torch.parallel.mesh import make_mesh
from deeplearning4j_tpu_torch.parallel.sharedtraining import \
    SharedTrainingMaster
from deeplearning4j_tpu_torch.parallel.wrapper import ParallelWrapper
from deeplearning4j_tpu_torch.utils.serializer import (ModelSerializer,
                                                       params_from_jax,
                                                       params_to_jax)
from torch_parity import one_intraop_thread  # noqa: F401,E402

TRAJ_TOL = 2e-4
SCALAR_RTOL = 1e-6
ONEBIT_RTOL = 1e-6
TIMEOUT_S = 60.0
SCHEMES = ("threshold", "int8", "1bit")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for v in ("DL4J_TORCH_SHARDED_UPDATE", "DL4J_TORCH_ENCODED_UPDATE",
              "DL4J_TORCH_FSDP", "DL4J_TORCH_ENCODED_SCHEME"):
        monkeypatch.delenv(v, raising=False)
    Environment.reset()
    yield
    Environment.reset()


def _np(t) -> np.ndarray:
    return np.asarray(t.float() if isinstance(t, torch.Tensor) and
                      t.dtype == torch.bfloat16 else t, dtype=np.float32)


def _jnp_np(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


# -- the codecs -------------------------------------------------------------
def _flat(dtype, n=4099, seed=0):
    c = (np.random.RandomState(seed).randn(n) * 1e-3).astype(np.float32)
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    return jnp.asarray(c).astype(jd), torch.from_numpy(c).to(td)


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_codecs_match_jax(dtype, scheme):
    """encode_flat on a seeded flat with an f32 τ: threshold and int8
    bit for bit, 1-bit within 1e-6; the transmitted fraction bitwise."""
    jc, tc = _flat(dtype)
    tau = np.float32(1.0037e-3)
    jd, jf = jenc.encode_flat(jc, jnp.float32(tau), scheme)
    td, tf = tenc.encode_flat(tc, torch.tensor(tau), scheme)
    assert td.dtype == tc.dtype and td.shape == tc.shape
    if scheme == "1bit":
        np.testing.assert_allclose(_np(td), _jnp_np(jd), rtol=ONEBIT_RTOL,
                                   atol=0)
    else:
        np.testing.assert_array_equal(_np(td), _jnp_np(jd))
    assert float(tf) == float(jf)
    # the standalone codecs agree with their own encode_flat use
    q, r = tenc.encode_threshold(tc, torch.tensor(tau))
    jq, jr = jenc.encode_threshold(jc, jnp.float32(tau))
    np.testing.assert_array_equal(_np(q), _jnp_np(jq))
    np.testing.assert_array_equal(_np(r), _jnp_np(jr))
    assert tenc.decode_threshold(q) is q
    assert float(tenc.sparsity(q)) == float(jenc.sparsity(jq))


def test_tau_compares_in_f32_against_a_bf16_flat():
    """The promotion trap: jnp compares a bf16 flat with an f32 τ in
    f32. Elements within bf16 rounding of τ would flip in a bf16
    comparison; the port's match the JAX package's."""
    # τ a quarter of a bf16 ulp above a bf16 value: bf16 rounds it down
    # onto that value, which then passes a bf16 comparison
    g0 = float(torch.tensor(1e-3, dtype=torch.bfloat16))
    tau = np.float32(g0 * (1 + 2 ** -10))
    near = np.float32(g0) * (1 + np.linspace(-2e-2, 2e-2, 257,
                                             dtype=np.float32))
    c = np.concatenate([near, -near, [g0, -g0]]).astype(np.float32)
    jc = jnp.asarray(c).astype(jnp.bfloat16)
    tc = torch.from_numpy(c).to(torch.bfloat16)
    jq, _ = jenc.encode_threshold(jc, jnp.float32(tau))
    q, _ = tenc.encode_threshold(tc, torch.tensor(tau))
    np.testing.assert_array_equal(_np(q), _jnp_np(jq))
    in_bf16 = (tc.abs() >= torch.tensor(tau)).numpy()
    in_f32 = (tc.float().abs() >= torch.tensor(tau)).numpy()
    assert (in_bf16 != in_f32).any(), "the case does not reach the trap"


@pytest.mark.parametrize("scheme", ["int8", "1bit"])
def test_scales_span_every_replicas_slice(scheme):
    """Two replicas whose slices differ tenfold in max|c|: each encodes
    its slice with the whole flat's scale, as the JAX program's
    global-view reduction does; a per-slice scale gives other bits."""
    c = (np.random.RandomState(3).randn(512) * 1e-3).astype(np.float32)
    c[256:] *= 10.0
    want = _jnp_np({"int8": jenc.encode_int8,
                    "1bit": jenc.encode_1bit}[scheme](jnp.asarray(c)))
    fn = {"int8": tenc.encode_int8, "1bit": tenc.encode_1bit}[scheme]
    mesh = make_mesh(devices=["cpu"] * 2, timeout_s=TIMEOUT_S)
    halves = [torch.from_numpy(c[:256].copy()), torch.from_numpy(c[256:])]
    got = np.concatenate([_np(t) for t in mesh.run(
        lambda r: fn(halves[r], mesh.replica(r)))])
    np.testing.assert_allclose(got, want, rtol=ONEBIT_RTOL, atol=0)
    if scheme == "int8":
        np.testing.assert_array_equal(got, want)
    per_slice = np.concatenate([_np(fn(h)) for h in halves])
    assert not np.allclose(per_slice, want, rtol=1e-3, atol=0)


def test_payload_and_exchange_bytes_match_jax():
    jnet, net = _mlp_pair(ju.Adam(0.01), tu.Adam(0.01))
    for n_elems in (0, 1, 7, 8, 1000, 25557032):
        for scheme in SCHEMES:
            for frac in (0.0, 1e-3, 0.37, 1.0, 1.5):
                assert tenc.encoded_payload_bytes(n_elems, scheme, frac) \
                    == jenc.encoded_payload_bytes(n_elems, scheme, frac)
    for n in (1, 2, 4, 8):
        for scheme in SCHEMES:
            for sp in (None, 0.01, 0.5):
                assert zero.encoded_exchange_bytes(
                    net.params, n, scheme, sparsity=sp) == \
                    jzero.encoded_exchange_bytes(jnet.params, n, scheme,
                                                 sparsity=sp)
        for mode in ("dense", "sharded", "fsdp", "encoded"):
            assert zero.update_exchange_bytes(net.params, n, mode) == \
                jzero.update_exchange_bytes(jnet.params, n, mode)
            want = jzero.exchange_report(jnet.params, n, mode,
                                         encoding="int8")
            assert zero.exchange_report(net.params, n, mode,
                                        encoding="int8") == want
    with pytest.raises(ValueError, match="scheme"):
        tenc.encoded_payload_bytes(4, "gzip")


# -- τ policies and the residual post-processor ------------------------------
_FRACTIONS = (0.5, 1e-5, 5e-3, 1e-3, 0.9, 0.0, 2e-2, 1e-4)


@pytest.mark.parametrize("algo", ["fixed", "adaptive", "target"])
def test_threshold_algorithms_match_jax(algo):
    """The three policies' τ sequences: on the host (Python numbers) as
    the JAX package's host variant, as f32 tensors as its traced
    variant, both exactly."""
    make = {"fixed": lambda m: m.FixedThresholdAlgorithm(2e-3),
            "adaptive": lambda m: m.AdaptiveThresholdAlgorithm(),
            "target": lambda m: m.TargetSparsityThresholdAlgorithm(
                1e-3, 1e-3, 1.05)}[algo]
    ja, ta = make(jenc), make(tenc)
    assert ta.initial() == ja.initial()
    host_j = host_t = ja.initial()
    jt, tt = jnp.float32(ja.initial()), torch.tensor(ta.initial())
    for sp in _FRACTIONS:
        host_j, host_t = ja.next_tau(host_j, sp), ta.next_tau(host_t, sp)
        assert host_t == host_j
        jt = ja.next_tau_traced(jt, jnp.float32(sp))
        tt = ta.next_tau(tt, torch.tensor(sp, dtype=torch.float32))
        assert tt.dtype == torch.float32 and float(tt) == float(jt)


def test_residual_clipping_matches_jax():
    r = (np.random.RandomState(5).randn(300) * 1e-2).astype(np.float32)
    jp, tp = jenc.ResidualClippingPostProcessor(3.0, 4), \
        tenc.ResidualClippingPostProcessor(3.0, 4)
    for step in range(9):
        tau = 1e-3 * (1 + step)
        want = _jnp_np(jp.apply_traced(jnp.int32(step), jnp.float32(tau),
                                       {"a": jnp.asarray(r)})["a"])
        got = tp.apply(torch.tensor(step, dtype=torch.int32),
                       torch.tensor(tau, dtype=torch.float32),
                       {"a": torch.from_numpy(r)})["a"]
        np.testing.assert_array_equal(got.numpy(), want)
        host = tp.apply(step, tau, {"a": torch.from_numpy(r)})["a"]
        jhost = _jnp_np(jp.apply(step, tau, {"a": jnp.asarray(r)})["a"])
        np.testing.assert_array_equal(host.numpy(), jhost)
        assert (step % 4 == 0) == bool(np.abs(want).max() < np.abs(r).max())
    assert tenc.ResidualClippingPostProcessor(3.0, 0).apply(
        0, 1e-3, {"a": torch.ones(2)})["a"].tolist() == [1.0, 1.0]


def test_encoding_spec_and_resolution(monkeypatch):
    spec = tenc.EncodingSpec("int8", tenc.FixedThresholdAlgorithm(1e-2))
    jspec = jenc.EncodingSpec("int8", jenc.FixedThresholdAlgorithm(1e-2))
    assert spec.signature() == jspec.signature()
    assert spec.initial_tau() == jspec.initial_tau() == 1e-2
    for s in SCHEMES:
        for a in ("AdaptiveThresholdAlgorithm",
                  "TargetSparsityThresholdAlgorithm",
                  "FixedThresholdAlgorithm"):
            assert tenc.EncodingSpec(s, getattr(tenc, a)()) \
                .planning_sparsity() == jenc.EncodingSpec(
                    s, getattr(jenc, a)()).planning_sparsity()
    assert tenc.resolve_encoding("1bit").scheme == "1bit"
    assert tenc.resolve_encoding(spec) is spec
    assert tenc.resolve_encoding(None).scheme == "threshold"
    monkeypatch.setenv("DL4J_TORCH_ENCODED_SCHEME", "int8")
    assert tenc.resolve_encoding(None).scheme == "int8"
    with pytest.raises(ValueError, match="scheme"):
        tenc.EncodingSpec("gzip")
    with pytest.raises(TypeError, match="encoding="):
        tenc.resolve_encoding(3)


def test_encoding_handler_matches_jax():
    """The host-side handler over 5 steps on a two-leaf tree: quantized
    trees, residuals, τ and the sparsity gauge as the JAX handler's."""
    r = np.random.RandomState(9)
    grads = [{"a": (r.randn(40) * 2e-3).astype(np.float32),
              "b": {"W": (r.randn(6, 5) * 2e-3).astype(np.float32)}}
             for _ in range(5)]
    algo = dict(initial_threshold=2e-3, min_target=0.2, max_target=0.4,
                decay_rate=1.1)
    jh = jenc.EncodingHandler(jenc.AdaptiveThresholdAlgorithm(**algo),
                              jenc.ResidualClippingPostProcessor(2.0, 2))
    th = tenc.EncodingHandler(tenc.AdaptiveThresholdAlgorithm(**algo),
                              tenc.ResidualClippingPostProcessor(2.0, 2))
    for g in grads:
        jq = jh.encode({"a": jnp.asarray(g["a"]),
                        "b": {"W": jnp.asarray(g["b"]["W"])}})
        tq = th.encode({"a": torch.from_numpy(g["a"]),
                        "b": {"W": torch.from_numpy(g["b"]["W"])}})
        np.testing.assert_array_equal(tq["a"].numpy(), _jnp_np(jq["a"]))
        np.testing.assert_array_equal(tq["b"]["W"].numpy(),
                                      _jnp_np(jq["b"]["W"]))
        np.testing.assert_array_equal(th.residual["b"]["W"].numpy(),
                                      _jnp_np(jh.residual["b"]["W"]))
        assert th.tau == jh.tau and th.step == jh.step
        assert th.last_sparsity == jh.last_sparsity
    assert telemetry.gauge("dl4j_dp_encoding_sparsity").value() == \
        th.last_sparsity


# -- training through the wrappers -----------------------------------------
def _mlp_conf(NNC, IT, L, Act, Loss, WI, up, seed=42):
    """The JAX package's encoded-rung MLP (``tests/test_encoded.py``)."""
    return (NNC.Builder().seed(seed).updater(up)
            .weight_init(WI.XAVIER).list()
            .layer(L.DenseLayer(n_in=8, n_out=16, activation=Act.TANH))
            .layer(L.OutputLayer(n_out=3, loss_function=Loss.MCXENT,
                                 activation=Act.SOFTMAX))
            .set_input_type(IT.feed_forward(8)).build())


def _np_tree(tree):
    return {k: {n: np.asarray(a) for n, a in sub.items()}
            for k, sub in tree.items()}


def _mlp_pair(jup, tup, seed=42):
    jnet = JMLN(_mlp_conf(JNNC, JIT, jl, JAct, JLoss, JWI, jup,
                          seed)).init()
    conf = _mlp_conf(NeuralNetConfiguration, InputType, tl, Activation,
                     LossFunction, WeightInit, tup, seed)
    p, s = params_from_jax(_np_tree(jnet.params), _np_tree(jnet.states),
                           conf)
    return jnet, MultiLayerNetwork(conf).set_params(p, s, "cpu")


def _data(n=64, seed=0):
    r = np.random.RandomState(seed)
    return (r.randn(n, 8).astype(np.float32),
            np.eye(3, dtype=np.float32)[r.randint(0, 3, n)])


def _cpu_wrapper(net, n, mode="encoded", encoding=None):
    return ParallelWrapper(net, make_mesh(devices=["cpu"] * n,
                                          timeout_s=TIMEOUT_S),
                           update_exchange=mode, encoding=encoding)


def _same_params(jnet, net, tol=TRAJ_TOL):
    want = params_to_jax(params_from_jax(_np_tree(jnet.params), {},
                                         net.conf)[0], net.conf)
    got = params_to_jax(net.params, net.conf)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=tol,
                                   err_msg=k)


def _same_encoded_state(jnet, net, tol=TRAJ_TOL):
    """The dense residual within ``tol``; τ, step and sparsity within
    1e-6 (the transmitted fraction's division may round once more in
    the JAX program)."""
    jd = jzero.states_to_dense(jnet.params, jnet.updater_states)
    for k, st in net.updater_states.items():
        if not is_encoded(st):
            assert not (isinstance(jd[k], dict) and ENCODED_KEY in jd[k])
            continue
        je, te = jd[k][ENCODED_KEY], st[ENCODED_KEY]
        for name, t in te["residual"].items():
            np.testing.assert_allclose(t.numpy(),
                                       np.asarray(je["residual"][name]),
                                       rtol=tol, atol=tol,
                                       err_msg=f"{k} residual {name}")
        for s in ("tau", "sparsity"):
            np.testing.assert_allclose(float(te[s]), float(je[s]),
                                       rtol=SCALAR_RTOL, err_msg=f"{k}/{s}")
        assert int(te["step"]) == int(je["step"])
        assert te["tau"].dtype == torch.float32
        assert te["step"].dtype == torch.int32


@pytest.mark.parametrize("up", ["sgd", "adam"])
@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("n", [2, 4])
def test_wrapper_encoded_matches_jax_wrapper(n, scheme, up):
    """4 fit_batch steps through ParallelWrapper(encoded) against the
    JAX wrapper on N devices: parameters and the dense residual within
    2e-4, τ, step and sparsity within 1e-6; a stateless updater carries
    only the encoded state."""
    ups = {"sgd": lambda m: m.Sgd(0.1), "adam": lambda m: m.Adam(0.01)}
    jnet, net = _mlp_pair(ups[up](ju), ups[up](tu))
    jpw = JaxWrapper.Builder(jnet).workers(n).update_exchange("encoded") \
        .encoding(scheme).build()
    pw = ParallelWrapper.Builder(net).mesh(make_mesh(
        devices=["cpu"] * n, timeout_s=TIMEOUT_S)) \
        .update_exchange("encoded").encoding(scheme).build()
    for s in range(4):
        x, y = _data(64, seed=s)
        jpw.fit_batch(JDataSet(x, y))
        pw.fit_batch(DataSet(x, y))
    assert pw.update_exchange is zero.UpdateExchange.ENCODED
    assert pw.encoding.scheme == scheme
    np.testing.assert_allclose(net.score(), float(jnet.score()),
                               rtol=TRAJ_TOL)
    _same_params(jnet, net)
    _same_encoded_state(jnet, net)
    for st in net.updater_states.values():
        assert is_encoded(st)
        if up == "sgd":
            assert set(st) == {ENCODED_KEY}
    # between fits the residual is in the dense layout
    assert set(net.updater_states["layer_0"][ENCODED_KEY]["residual"]) \
        == {"W", "b"}


def test_encoded_state_is_a_replicas_slice_while_bound():
    _, net = _mlp_pair(ju.Adam(0.01), tu.Adam(0.01))
    pw = _cpu_wrapper(net, 4)
    pw.fit_batch(DataSet(*_data()))
    pw._bind()
    try:
        shares = pw.mesh.run(lambda r: zero.encoded_residual_bytes(
            pw._replicas[r].updater_states))
        whole = zero.encoded_residual_bytes(zero.ensure_encoded_states(
            net.params, {k: {} for k in net.updater_states}, 4,
            tenc.resolve_encoding(None)))
        assert shares == [whole // 4] * 4
        taus = pw.mesh.run(lambda r: [
            float(s[ENCODED_KEY]["tau"])
            for s in pw._replicas[r].updater_states.values()])
        assert all(t == taus[0] for t in taus)
    finally:
        pw._unbind(True)


def test_single_process_master_threshold_algorithm_matches_jax():
    """No coordinator: a ParallelWrapper over workers_per_node local
    replicas, with the reference knobs live under 'encoded'."""
    jnet, net = _mlp_pair(ju.Nesterovs(0.1, 0.9), tu.Nesterovs(0.1, 0.9))
    batches = [_data(32, seed=s) for s in range(3)]
    knobs = dict(initial_threshold=5e-3, min_target=0.3, max_target=0.6,
                 decay_rate=1.2)
    JMaster.Builder(16).workers_per_node(2).update_exchange("encoded") \
        .threshold_algorithm(jenc.AdaptiveThresholdAlgorithm(**knobs)) \
        .residual_post_processor(jenc.ResidualClippingPostProcessor(
            2.0, 2)).build().fit(
            jnet, JList([JDataSet(x, y) for x, y in batches]))
    SharedTrainingMaster.Builder(16).workers_per_node(2) \
        .update_exchange("encoded") \
        .threshold_algorithm(tenc.AdaptiveThresholdAlgorithm(**knobs)) \
        .residual_post_processor(tenc.ResidualClippingPostProcessor(
            2.0, 2)).build().fit(
            net, ListDataSetIterator([DataSet(x, y) for x, y in batches]))
    assert net.iteration_count == jnet.iteration_count == 3
    _same_params(jnet, net)
    _same_encoded_state(jnet, net)
    # the knob reached the tail: τ moved off the default's 1e-3 start
    tau = float(net.updater_states["layer_0"][ENCODED_KEY]["tau"])
    assert tau != 1e-3 and abs(tau / 5e-3 - 1) > 1e-3


def test_master_knobs_stay_inert_under_other_exchanges(caplog):
    _, net = _mlp_pair(ju.Sgd(0.1), tu.Sgd(0.1))
    with caplog.at_level("INFO", logger="deeplearning4j_tpu_torch"):
        SharedTrainingMaster.Builder(16).workers_per_node(2) \
            .update_exchange("sharded") \
            .threshold_algorithm(tenc.FixedThresholdAlgorithm(1.0)) \
            .build().fit(net, ListDataSetIterator([DataSet(*_data(32))]))
    assert "inert" in caplog.text
    assert not any(is_encoded(s) for s in net.updater_states.values())
    spec = SharedTrainingMaster.Builder().encoding("1bit").build() \
        .config.encoding
    assert spec.scheme == "1bit"


# -- kill switch, resolver fallbacks, strip ---------------------------------
def test_kill_switch_demotes_encoded_to_sharded(monkeypatch):
    monkeypatch.setenv("DL4J_TORCH_ENCODED_UPDATE", "0")
    Environment.reset()
    mesh = make_mesh(devices=["cpu"] * 2)
    assert zero.resolve_update_exchange(mesh, requested="encoded") \
        is zero.UpdateExchange.SHARDED
    _, net = _mlp_pair(ju.Adam(0.01), tu.Adam(0.01))
    pw = _cpu_wrapper(net, 2)
    pw.fit_batch(DataSet(*_data()))
    assert pw.update_exchange is zero.UpdateExchange.SHARDED
    assert pw.encoding is None
    assert not any(is_encoded(s) for s in net.updater_states.values())


def test_resolver_fallbacks_demote_encoded_to_dense():
    from deeplearning4j_tpu_torch.nn.conf.builders import \
        GradientNormalization
    _, net = _mlp_pair(ju.Sgd(0.1), tu.Sgd(0.1))
    mesh = make_mesh(devices=["cpu"] * 2)
    net.conf.gradient_normalization = \
        GradientNormalization.CLIP_L2_PER_LAYER
    assert zero.resolve_update_exchange(mesh, requested="encoded",
                                        model=net) \
        is zero.UpdateExchange.DENSE
    assert zero.resolve_update_exchange(make_mesh(devices=["cpu"]),
                                        requested="encoded") \
        is zero.UpdateExchange.DENSE
    assert zero.resolve_update_exchange(None, requested="encoded") \
        is zero.UpdateExchange.DENSE


@pytest.mark.parametrize("then", ["dense_wrapper", "plain_fit"])
@pytest.mark.parametrize("up", ["sgd", "adam"])
def test_encoded_state_strips_when_stepping_another_way(then, up):
    """encoded -> dense (a wrapper, or a plain fit) must not leak the
    residual into other updater math: the state is dropped at the first
    step, and the run equals the JAX package's."""
    ups = {"sgd": lambda m: m.Sgd(0.1), "adam": lambda m: m.Adam(0.01)}
    jnet, net = _mlp_pair(ups[up](ju), ups[up](tu), seed=5)
    jpw = JaxWrapper.Builder(jnet).workers(2).update_exchange("encoded") \
        .build()
    jpw.fit_batch(JDataSet(*_data(seed=0)))
    _cpu_wrapper(net, 2).fit_batch(DataSet(*_data(seed=0)))
    assert all(is_encoded(s) for s in net.updater_states.values())
    x, y = _data(seed=1)
    if then == "dense_wrapper":
        JaxWrapper.Builder(jnet).workers(2).update_exchange("dense") \
            .build().fit_batch(JDataSet(x, y))
        _cpu_wrapper(net, 2, "dense").fit_batch(DataSet(x, y))
    else:
        jnet.set_dp_mesh(None)
        jnet.fit(x, y)
        net.fit(x, y)
    assert not any(is_encoded(s) for s in net.updater_states.values())
    _same_params(jnet, net)


# -- checkpoints across the packages ----------------------------------------
def _encoded_run(n=4, steps=3, seed=9):
    jnet, net = _mlp_pair(ju.Adam(0.01), tu.Adam(0.01), seed=seed)
    jpw = JaxWrapper.Builder(jnet).workers(n).update_exchange("encoded") \
        .build()
    pw = _cpu_wrapper(net, n)
    for i in range(steps):
        jpw.fit_batch(JDataSet(*_data(seed=i)))
        pw.fit_batch(DataSet(*_data(seed=i)))
    return jnet, net


def _flat_state(states):
    from deeplearning4j_tpu.utils.serializer import _tree_to_flat_dict
    return {k: np.asarray(v) for k, v in _tree_to_flat_dict(states).items()}


def test_port_encoded_zip_restores_in_jax_bitwise(tmp_path):
    _, net = _encoded_run()
    path = tmp_path / "enc.zip"
    ModelSerializer.write_model(net, path)
    jnet = JSerializer.restore_multi_layer_network(str(path))
    got = params_to_jax(params_from_jax(_np_tree(jnet.params), {},
                                        net.conf)[0], net.conf)
    for k, a in params_to_jax(net.params, net.conf).items():
        np.testing.assert_array_equal(got[k], a, err_msg=k)
    state = _flat_state(jnet.updater_states)
    for k, st in net.updater_states.items():
        enc = st[ENCODED_KEY]
        for name, t in enc["residual"].items():
            np.testing.assert_array_equal(
                state[f"{k}/{ENCODED_KEY}/residual/{name}"], t.numpy())
        for s in ("tau", "step", "sparsity"):
            a = state[f"{k}/{ENCODED_KEY}/{s}"]
            assert a.dtype == enc[s].numpy().dtype
            np.testing.assert_array_equal(a, enc[s].numpy())
        for slot in ("m", "v"):
            for name, t in st[slot].items():
                np.testing.assert_array_equal(
                    state[f"{k}/{slot}/{name}"], t.numpy())


def test_jax_encoded_zip_restores_in_the_port_bitwise(tmp_path):
    jnet, _ = _encoded_run()
    path = tmp_path / "jenc.zip"
    JSerializer.write_model(jnet, str(path))
    net = ModelSerializer.restore_model(path, device="cpu")
    want = _flat_state(jzero.states_to_dense(jnet.params,
                                             jnet.updater_states))
    for k, st in net.updater_states.items():
        enc = st[ENCODED_KEY]
        for name, t in enc["residual"].items():
            np.testing.assert_array_equal(
                t.numpy(), want[f"{k}/{ENCODED_KEY}/residual/{name}"])
        for s in ("tau", "step", "sparsity"):
            np.testing.assert_array_equal(enc[s].numpy(),
                                          want[f"{k}/{ENCODED_KEY}/{s}"])
    for k, a in params_to_jax(net.params, net.conf).items():
        np.testing.assert_array_equal(
            a, np.asarray(jnet.params[k.split("/")[0]][k.split("/")[1]]))
    # and it trains on in the port, on another replica count
    _cpu_wrapper(net, 2).fit_batch(DataSet(*_data(seed=7)))
    assert int(net.updater_states["layer_0"][ENCODED_KEY]["step"]) == 4


def test_residual_reravels_losslessly_across_shard_counts():
    """ensure (4 shards) -> dense -> ensure (2 shards) -> dense -> 4
    is bitwise, as in the JAX package (padding is zeros)."""
    _, net = _encoded_run()
    enc = tenc.resolve_encoding(None)
    dense = net.updater_states
    for n in (2, 3, 4, 1):
        flat = zero.ensure_encoded_states(net.params, dense, n, enc)
        for k, st in flat.items():
            for dt, f in st[ENCODED_KEY]["residual"].items():
                assert f.dim() == 1 and f.numel() % n == 0
        back = zero.states_to_dense(net.params, flat)
        for k, st in back.items():
            for name, t in st[ENCODED_KEY]["residual"].items():
                assert torch.equal(
                    t, dense[k][ENCODED_KEY]["residual"][name])
        # flats for one count re-ravel straight to another
        again = zero.states_to_dense(net.params, zero.states_to_sharded(
            net.params, flat, 2))
        for k, st in again.items():
            for name, t in st[ENCODED_KEY]["residual"].items():
                assert torch.equal(
                    t, dense[k][ENCODED_KEY]["residual"][name])
