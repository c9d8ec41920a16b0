"""The fsdp (ZeRO-3) update exchange in the port against the JAX
package and against the port's own dense exchange, on the CPU.

Under fsdp each replica keeps only its 1/N slice of every group's padded
flat parameters; the forward gathers a group at its first use and the
backward reduce-scatters its gradient. The per-element arithmetic is the
sharded tail's, and the thread mesh sums in rank order, so over 4 steps
the port's fsdp run equals its dense run bit for bit; against the JAX
wrapper's fsdp run on N virtual devices it holds the bars of
``tests/test_parallel.py`` (2e-4). The MLP and the small conv graph with
BatchNormalization are ``tests/test_torch_parallel.py``'s.
"""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.iterators import \
    ListDataSetIterator as JList
from deeplearning4j_tpu.learning import updaters as ju
from deeplearning4j_tpu.parallel import ParallelWrapper as JaxWrapper
from deeplearning4j_tpu.utils.serializer import \
    ModelSerializer as JSerializer
from deeplearning4j_tpu_torch.common import telemetry
from deeplearning4j_tpu_torch.common.environment import Environment
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.learning import updaters as tu
from deeplearning4j_tpu_torch.learning.updaters import (FSDP_KEY,
                                                        dp_flatten_spec,
                                                        is_fsdp)
from deeplearning4j_tpu_torch.nn.conf.constraints import MaxNormConstraint
from deeplearning4j_tpu_torch.parallel import zero
from deeplearning4j_tpu_torch.parallel.mesh import make_mesh
from deeplearning4j_tpu_torch.parallel.wrapper import ParallelWrapper
from deeplearning4j_tpu_torch.utils.serializer import (ModelSerializer,
                                                       params_from_jax,
                                                       params_to_jax)
from test_torch_parallel import PAIRS, _np_tree
from torch_parity import one_intraop_thread  # noqa: F401,E402

RTOL, ATOL = 2e-4, 2e-5
TIMEOUT_S = 60.0
UPDATERS = {"sgd": lambda m: m.Sgd(0.1),
            "nesterovs": lambda m: m.Nesterovs(0.1, 0.9),
            "adam": lambda m: m.Adam(1e-2)}


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for v in ("DL4J_TORCH_SHARDED_UPDATE", "DL4J_TORCH_FSDP",
              "DL4J_TORCH_DEVICE_PREFETCH"):
        monkeypatch.delenv(v, raising=False)
    Environment.reset()
    yield
    Environment.reset()


def _wrapper(net, n, mode="fsdp", accumulation_steps=1):
    return ParallelWrapper(net, make_mesh(devices=["cpu"] * n,
                                          timeout_s=TIMEOUT_S),
                           update_exchange=mode,
                           accumulation_steps=accumulation_steps)


def _jax_params(jnet, conf):
    return params_to_jax(params_from_jax(
        _np_tree(jnet.dense_params()), {}, conf)[0], conf)


def _close_to_jax(jnet, net):
    want = _jax_params(jnet, net.conf)
    got = params_to_jax(net.params, net.conf)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    for k, sub in jnet.states.items():
        for n, a in sub.items():
            np.testing.assert_allclose(net.states[k][n].numpy(),
                                       np.asarray(a), rtol=RTOL, atol=ATOL,
                                       err_msg=f"{k}/{n}")


def _bitwise(a, b):
    for tree in ("params", "states"):
        ta, tb = getattr(a, tree), getattr(b, tree)
        for k, sub in ta.items():
            for n, t in sub.items():
                assert torch.equal(t, tb[k][n]), f"{tree} {k}/{n}"
    for k, st in a.updater_states.items():
        for slot, sub in st.items():
            for n, t in sub.items():
                assert torch.equal(t, b.updater_states[k][slot][n]), \
                    f"updater {k}/{slot}/{n}"
    assert a.score() == b.score()


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("up", sorted(UPDATERS))
@pytest.mark.parametrize("kind", ["mlp", "conv_bn"])
def test_fsdp_equals_dense_and_matches_jax(kind, up, n):
    """4 steps: the port's fsdp run equals its dense run bit for bit
    (parameters, running statistics, updater state, score) and lies
    within 2e-4 of the JAX wrapper's fsdp run."""
    make, batch = PAIRS[kind]
    jnet, net = make(UPDATERS[up](ju), UPDATERS[up](tu))
    _, dense = make(UPDATERS[up](ju), UPDATERS[up](tu))
    jpw = JaxWrapper.Builder(jnet).workers(n).update_exchange("fsdp") \
        .build()
    pw, pw_dense = _wrapper(net, n), _wrapper(dense, n, "dense")
    for s in range(4):
        x, y = batch(s)
        jpw.fit_batch(JDataSet(x, y))
        pw.fit_batch(DataSet(x, y))
        pw_dense.fit_batch(DataSet(x, y))
        np.testing.assert_allclose(net.score(), float(jnet.score()),
                                   rtol=RTOL, atol=ATOL)
    assert pw.update_exchange is zero.UpdateExchange.FSDP
    assert not net._params_are_fsdp()       # dense between fits
    _bitwise(net, dense)
    _close_to_jax(jnet, net)


def test_fsdp_residency_is_a_replicas_share_while_bound():
    """Between steps each replica holds padded/N of the flat parameters
    (and of the ZeRO-1 updater state); dense_params, output and score
    read the gathered parameters while bound (every replica calls
    them); the 4-D leaves gather channels-last."""
    make, batch = PAIRS["conv_bn"]
    _, net = make(ju.Adam(1e-2), tu.Adam(1e-2))
    x, y = batch(0)
    net.fit(x, y)
    ref_out = net.output(x).clone()
    ref_score = net.score(DataSet(x, y))
    dense = {k: {n: t.clone() for n, t in sub.items()}
             for k, sub in net.params.items()}
    pw = _wrapper(net, 4)
    pw._bind()
    try:
        reps = pw._replicas
        flat, _ = zero.params_to_fsdp(dense, 4)
        whole = zero.fsdp_param_bytes(flat)
        shares = pw.mesh.run(lambda r: zero.fsdp_param_bytes(
            reps[r].params))
        assert shares == [whole // 4] * 4
        assert all(is_fsdp(sub) for sub in net.params.values() if sub)
        assert telemetry.gauge("dl4j_fsdp_param_shard_bytes").value() == \
            whole // 4
        states = pw.mesh.run(lambda r: zero.sharded_state_bytes(
            reps[r].updater_states))
        assert states == [zero.sharded_state_bytes(zero.states_to_sharded(
            dense, {k: tu.Adam(1e-2).init_state(p)
                    for k, p in dense.items()}, 4)) // 4] * 4
        got = pw.mesh.run(lambda r: (reps[r].dense_params(),
                                     reps[r].output(x),
                                     reps[r].score(DataSet(x, y))))
        for params, out, score in got:
            for k, sub in dense.items():
                for n, t in sub.items():
                    assert torch.equal(params[k][n], t), f"{k}/{n}"
            assert torch.equal(out, ref_out)
            assert score == ref_score

        def gathered(r):
            view = zero.FsdpParamView(reps[r].params, reps[r]._fsdp_specs,
                                      pw.mesh.replica(r))
            return view["c1"]["W"], view.cast(torch.float64)["d1"]["W"]
        for w, d in pw.mesh.run(gathered):
            assert w.dim() == 4
            assert w.is_contiguous(memory_format=torch.channels_last)
            assert torch.equal(w, dense["c1"]["W"])
            assert d.dtype == torch.float64
    finally:
        pw._unbind(True)
    for k, sub in dense.items():
        for n, t in sub.items():
            assert torch.equal(net.params[k][n], t)
            if t.dim() == 4:
                assert net.params[k][n].is_contiguous(
                    memory_format=torch.channels_last)


def test_fsdp_layouts_invert_and_match_the_flat_spec():
    make, _ = PAIRS["conv_bn"]
    _, net = make(ju.Sgd(0.1), tu.Sgd(0.1))
    for n in (1, 3, 4):
        flat, specs = zero.params_to_fsdp(net.params, n)
        assert zero.fsdp_spec_shards(specs) == n
        for k, sub in net.params.items():
            if not sub:
                assert flat[k] == {} and k not in specs
                continue
            spec = dp_flatten_spec(sub, n)
            assert {dt: f.numel() for dt, f in flat[k][FSDP_KEY].items()} \
                == {dt: s[1] for dt, s in spec.sizes.items()}
        mesh = make_mesh(devices=["cpu"] * n, timeout_s=TIMEOUT_S)
        backs = mesh.run(lambda r: zero.params_to_dense(
            zero.shard_params(flat, r, n), specs, mesh.replica(r)))
        for back in backs:
            for k, sub in net.params.items():
                for name, t in sub.items():
                    assert torch.equal(back[k][name], t)
    assert zero.fsdp_spec_shards({}) is None


def test_fsdp_kill_switch_and_constraints_demote_to_sharded(monkeypatch):
    make, batch = PAIRS["mlp"]
    mesh = make_mesh(devices=["cpu"] * 2)
    monkeypatch.setenv("DL4J_TORCH_FSDP", "0")
    Environment.reset()
    _, net = make(ju.Sgd(0.1), tu.Sgd(0.1))
    assert zero.resolve_update_exchange(mesh, requested="fsdp",
                                        model=net) \
        is zero.UpdateExchange.SHARDED
    pw = _wrapper(net, 2)
    pw.fit_batch(DataSet(*batch(0)))
    assert pw.update_exchange is zero.UpdateExchange.SHARDED
    monkeypatch.delenv("DL4J_TORCH_FSDP")
    Environment.reset()
    _, net = make(ju.Sgd(0.1), tu.Sgd(0.1))
    net.conf.layers[0].constrain_weights = [MaxNormConstraint(0.5)]
    assert zero.resolve_update_exchange(mesh, requested="fsdp",
                                        model=net) \
        is zero.UpdateExchange.SHARDED
    pw = _wrapper(net, 2)
    pw.fit_batch(DataSet(*batch(0)))
    assert pw.update_exchange is zero.UpdateExchange.SHARDED
    # the constraint ran after the update
    assert float(net.params["layer_0"]["W"].norm(dim=0).max()) <= 0.5 + 1e-6
    assert zero.resolve_update_exchange(make_mesh(devices=["cpu"]),
                                        requested="fsdp") \
        is zero.UpdateExchange.DENSE


@pytest.mark.parametrize("kind", ["mlp", "conv_bn"])
def test_fsdp_accumulation_matches_jax(kind):
    """accumulation_steps=2: the gathers' reduce-scattered gradients
    summed over a window, applied once on their mean, against the JAX
    wrapper's fsdp accumulation."""
    make, batch = PAIRS[kind]
    jnet, net = make(ju.Nesterovs(0.1, 0.9), tu.Nesterovs(0.1, 0.9))
    jpw = JaxWrapper.Builder(jnet).workers(2).update_exchange("fsdp") \
        .accumulation_steps(2).build()
    pw = _wrapper(net, 2, accumulation_steps=2)
    # one fit call: binding and unbinding apply a partial window
    jpw.fit(JList([JDataSet(*batch(s)) for s in range(4)]))
    pw.fit(ListDataSetIterator([DataSet(*batch(s)) for s in range(4)]))
    assert net._updates_applied == 2 and net.iteration_count == 4
    _close_to_jax(jnet, net)


def test_zip_written_while_bound_holds_dense_parameters(tmp_path):
    """write_model under fsdp writes the dense layout (every replica
    writes; the gathers are collectives), which the JAX package
    restores."""
    make, batch = PAIRS["conv_bn"]
    _, net = make(ju.Adam(1e-2), tu.Adam(1e-2))
    pw = _wrapper(net, 2)
    pw.fit_batch(DataSet(*batch(0)))
    want = params_to_jax(net.params, net.conf)
    want_upd = {k: {s: {n: t.clone() for n, t in sub.items()}
                    for s, sub in st.items()}
                for k, st in net.updater_states.items()}
    pw._bind()
    try:
        pw.mesh.run(lambda r: ModelSerializer.write_model(
            pw._replicas[r], tmp_path / f"r{r}.zip"))
    finally:
        pw._unbind(True)
    jnet = JSerializer.restore_computation_graph(str(tmp_path / "r0.zip"))
    got = params_to_jax(params_from_jax(_np_tree(jnet.params), {},
                                        net.conf)[0], net.conf)
    for k, a in want.items():
        np.testing.assert_array_equal(got[k], a, err_msg=k)
    back = ModelSerializer.restore_model(tmp_path / "r1.zip", device="cpu")
    for k, st in want_upd.items():
        for s, sub in st.items():
            for n, t in sub.items():
                assert torch.equal(back.updater_states[k][s][n], t)


def test_fsdp_with_remat_segments_equals_dense():
    """A checkpointed segment recomputes its forward in the backward:
    the view's gathers are cached for the step, so the recompute runs no
    collective and fsdp stays the dense run's bits."""
    make, batch = PAIRS["conv_bn"]
    nets = []
    for mode in ("dense", "fsdp"):
        _, net = make(ju.Adam(1e-2), tu.Adam(1e-2))
        net.conf.remat_segments = 2
        pw = _wrapper(net, 2, mode)
        for s in range(3):
            pw.fit_batch(DataSet(*batch(s)))
        nets.append(net)
    _bitwise(*nets)


def test_a_failed_fsdp_step_leaves_the_model_dense():
    """The parameters live only as the replicas' slices while bound, so
    a failed step still gathers them back: the wrapped model keeps its
    parameters, in the dense layout, and trains on."""
    make, batch = PAIRS["mlp"]
    _, net = make(ju.Sgd(0.1), tu.Sgd(0.1))
    before = {k: {n: t.clone() for n, t in sub.items()}
              for k, sub in net.params.items()}
    pw = _wrapper(net, 2)
    pw._place_model()
    boom = pw._replicas[1]

    def fail(*a, **k):
        raise RuntimeError("replica 1 exploded")
    boom._fit_batch = fail
    with pytest.raises(RuntimeError, match="exploded"):
        pw.fit_batch(DataSet(*batch(0)))
    assert not net._params_are_fsdp()
    for k, sub in before.items():
        for n, t in sub.items():
            assert torch.equal(net.params[k][n], t)
    del boom._fit_batch
    pw.fit_batch(DataSet(*batch(0)))
    assert net.iteration_count == 1
