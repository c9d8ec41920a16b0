"""Layer attribution in the port (``common/layerprof.py``) against the
JAX package's ``common/layerprof.py``.

Static: ``layer_report`` on both network kinds. The JAX package parses
its compiled step's HLO (``parse_hlo``); the port charges the aten ops
of one eager step to the ``dl4j.<layer>`` scopes that ran them. Both use
the same analytic products (dot = 2·out·k, conv = 2·out·window·Cin/g),
so each scope's conv + dot FLOPs must agree exactly on a small
ResNet-style ComputationGraph and on LeNet-5: forward, and backward but
for the convolutions' weight gradients, which XLA's CPU rewrite emits
without op metadata (``parse_hlo`` charges them to ``_unattributed``
as forward work). The port charges them to their layer and reports them
apart (``conv_weight_grad_flops``): their sum must equal JAX's
``_unattributed`` conv FLOPs. XLA fuses elementwise work and its bytes
are fusion-boundary bytes, where the port counts each eager op's own:
for those the test holds only the report's structure and
reconciliation, not the JAX numbers.

Dynamic: ``attribute_trace`` over a ``torch.profiler`` trace of fit
steps (the CPU: host op time, each op charged forward to its scope and
backward through autograd's sequence numbers), ``join_dynamic`` and
``share_step_time``; ``note_selection`` fed by ``kernel_select``.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.common import layerprof as jlp
from deeplearning4j_tpu.models.zoo import LeNet as JaxLeNet
from deeplearning4j_tpu.models.zoo import ResNet50 as JaxResNet50
from deeplearning4j_tpu_torch.common import diagnostics, layerprof
from deeplearning4j_tpu_torch.common.environment import Environment
from deeplearning4j_tpu_torch.models.zoo import LeNet, ResNet50
from deeplearning4j_tpu_torch.ops import cuda_build, kernel_select
from torch_parity import one_intraop_thread  # noqa: F401,E402

SMALL = dict(STAGES=((1, 8), (1, 16)), height=32, width=32, num_classes=10)
BATCH = 4


def _jax_conv_dot_by_scope(hlo: str) -> dict:
    """Per scope ``[fwd, bwd]`` conv + dot FLOPs of a compiled step, by
    the JAX module's own HLO walk (``parse_hlo``'s instruction loop,
    restricted to ``dot`` and ``convolution``)."""
    parent, _, _, resolve, _, _ = jlp._comp_roles(hlo)
    out: dict = {}
    factor, symtab = 1.0, {}
    for line in hlo.splitlines():
        stripped = line.strip()
        if stripped.endswith("{") and ("->" in stripped
                                       or stripped.startswith("ENTRY")):
            m = jlp._COMP_HEAD_RE.match(stripped)
            comp = m.group(1) if m else None
            factor = resolve(comp) if comp is not None else 1.0
            symtab = {}
            continue
        if factor == 0.0:
            continue
        m = jlp._HEAD_RE.match(line)
        if not m:
            continue
        name, rhs = m.group(1), m.group(2)
        call = jlp._CALL_RE.match(rhs)
        if not call:
            continue
        rtype, opcode = call.group(1), call.group(2)
        args, attrs = jlp._split_call(rhs[call.end() - 1:])
        elems, byts = jlp._shape_cost(rtype)
        symtab[name] = (jlp._shape_dims(rtype), byts)
        if opcode == "dot":
            f = jlp._dot_flops(elems, args, attrs, symtab)
        elif opcode == "convolution":
            f = jlp._conv_flops(elems, args, attrs, symtab)
        else:
            continue
        meta = jlp._META_RE.search(attrs)
        op_name = meta.group(1) if meta else ""
        sm = jlp._SCOPE_META_RE.search(op_name)
        scope = sm.group(1) if sm else "_unattributed"
        d = out.setdefault(scope, [0.0, 0.0])
        d["transpose(" in op_name] += f * factor
    return out


def _jax_step_hlo(jnet, x, y, graph: bool) -> str:
    jnet.layer_report(x, y)          # builds the train step
    if graph:
        xs, ys = [jnp.asarray(x)], [jnp.asarray(y)]
    else:
        xs, ys = jnp.asarray(x), jnp.asarray(y)
    states = jnet._with_zero_rnn_states(jnet.states, int(x.shape[0]))
    return jnet._train_step.lower(
        jnet.params, states, jnet.updater_states, xs, ys, None, None,
        jnp.asarray(0), jax.random.PRNGKey(0)).compile().as_text()


def _port_conv_dot(report) -> dict:
    """Per scope ``[fwd, bwd]`` conv + dot FLOPs as the JAX parse sees
    them: the weight gradients moved out of their layers' backward into
    ``_unattributed``'s forward."""
    out = {k: [v["conv_dot_flops_fwd"],
               v["conv_dot_flops_bwd"] - v["conv_weight_grad_flops"]]
           for k, v in report["layers"].items()}
    wgrad = sum(v["conv_weight_grad_flops"]
                for v in report["layers"].values())
    if wgrad:
        out["_unattributed"] = [out.get("_unattributed", [0, 0])[0]
                                + wgrad, 0]
    return {k: v for k, v in out.items() if any(v)}


@pytest.fixture(scope="module")
def resnet_batch():
    rs = np.random.RandomState(0)
    x = rs.randn(BATCH, 32, 32, 3).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rs.randint(0, 10, BATCH)]
    return x, y


@pytest.fixture(scope="module")
def jax_resnet_conv_dot(resnet_batch):
    x, y = resnet_batch
    hlo = _jax_step_hlo(JaxResNet50(**SMALL).init(), x, y, graph=True)
    return {k: v for k, v in _jax_conv_dot_by_scope(hlo).items() if any(v)}


def test_graph_conv_dot_flops_by_scope_match_jax_hlo(resnet_batch,
                                                     jax_resnet_conv_dot):
    x, y = resnet_batch
    net = ResNet50(**SMALL).init("cpu")
    report = net.layer_report(x, y)
    got = _port_conv_dot(report)
    assert got.keys() == jax_resnet_conv_dot.keys()
    for k, (f, b) in jax_resnet_conv_dot.items():
        assert got[k] == [round(f), round(b)], k


def test_mln_conv_dot_flops_by_scope_match_jax_hlo():
    rs = np.random.RandomState(1)
    x = rs.rand(BATCH, 784).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rs.randint(0, 10, BATCH)]
    want = {k: v for k, v in _jax_conv_dot_by_scope(
        _jax_step_hlo(JaxLeNet().init(), x, y, graph=False)).items()
        if any(v)}
    net = LeNet().init("cpu")
    got = _port_conv_dot(net.layer_report(x, y))
    assert got == {k: [round(f), round(b)] for k, (f, b) in want.items()}


def test_report_schema_reconciles_and_publishes(resnet_batch):
    """The JAX package's report keys; the per-layer sums are the totals
    (0 % by construction: the totals are the dispatch counts); the
    last report, the top layer and the gauges published; the model is
    left as it was; the H100's peaks by default."""
    x, y = resnet_batch
    net = ResNet50(**SMALL).init("cpu")
    before = {k: {n: t.clone() for n, t in sub.items()}
              for k, sub in net.params.items()}
    rng = net._rng
    layerprof.reset()
    report = net.layer_report(x, y)
    assert set(report) == {"model", "peaks", "totals", "raw_model",
                           "coverage", "time_source", "layers"}
    assert report["model"] == "ComputationGraph"
    assert report["peaks"] == {"tflops": 67.0, "hbm_gbps": 3350.0}
    assert layerprof.reconcile_error_pct(report) < 1e-9
    assert report["raw_model"]["flops_err_pct"] == 0.0
    ent = report["layers"]["stem_conv"]
    for k in ("flops", "bytes", "flops_fwd", "flops_bwd", "bytes_fwd",
              "bytes_bwd", "share_flops", "share_bytes",
              "arithmetic_intensity", "bound", "est_ms", "type"):
        assert k in ent, k
    assert ent["type"] == "ConvolutionLayer"
    assert {"loss", "optimizer"} <= set(report["layers"])
    assert layerprof.last_report() is report
    assert layerprof.top_layer() in report["layers"]
    from deeplearning4j_tpu_torch.common import telemetry
    assert telemetry.gauge("dl4j_layer_flops").value(
        layer="stem_conv") == ent["flops"]
    assert net._rng is rng
    assert all(torch.equal(before[k][n], net.params[k][n])
               for k in before for n in before[k])
    # the flight recorder stamps the top layer on its records
    diagnostics.FlightRecorder._reset_for_tests()
    net.fit(x, y)
    assert diagnostics.FlightRecorder.get().records()[-1]["top_layer"] == \
        layerprof.top_layer()
    diagnostics.FlightRecorder._reset_for_tests()


def test_layer_report_needs_a_batch_or_a_fit(resnet_batch):
    net = LeNet().init("cpu")
    with pytest.raises(ValueError, match="needs a batch"):
        net.layer_report()
    x = np.random.RandomState(2).rand(BATCH, 784).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[np.arange(BATCH)]
    net.fit(x, y)
    a = net.layer_report()
    b = net.layer_report(x, y)
    assert _port_conv_dot(a) == _port_conv_dot(b)


def test_gate_scope_stack_and_kernel_decisions():
    env = Environment.get()
    prev = env.extra.get("layerprof")
    try:
        env.extra["layerprof"] = False
        assert not layerprof.enabled()
        with layerprof.scope("x"):
            assert layerprof.current_scope() is None
        env.extra["layerprof"] = True
        assert layerprof.sanitize("a/b c") == jlp.sanitize("a/b c")
        layerprof.reset_decisions()
        with layerprof.scope("outer"), layerprof.scope("res2a/branch"):
            assert layerprof.current_scope() == "res2a_branch"
            kernel_select.select("conv_epilogue", auto=(True, "fits"))
            kernel_select.select("conv_epilogue", auto=(True, "fits"))
        kernel_select.select("attention", structural="rank")
        got = layerprof.kernel_decisions()
        assert got["res2a_branch"]["conv_epilogue"]["sites"] == 2
        assert got["res2a_branch"]["conv_epilogue"]["decision"] == \
            "auto_fused"
        assert got["_unscoped"]["attention"]["decision"] == "structural"
        assert layerprof.kernel_decisions("outer") == {}
    finally:
        layerprof.reset_decisions()
        if prev is None:
            env.extra.pop("layerprof", None)
        else:
            env.extra["layerprof"] = prev


def test_attribute_trace_of_a_profiled_fit(tmp_path, resnet_batch):
    """Two fit steps under ``torch.profiler``: every conv layer gets
    forward and backward milliseconds (the CPU trace holds host ops, so
    the join is marked as such), and ``share_step_time`` is the JAX
    module's proxy split."""
    x, y = resnet_batch
    net = ResNet50(**SMALL).init("cpu")
    net.fit(x, y)
    path = tmp_path / "t.json"
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        net.fit(x, y)
        net.fit(x, y)
    prof.export_chrome_trace(str(path))
    ms = layerprof.attribute_trace_file(str(path))
    assert ms["stem_conv"]["fwd_ms"] > 0 and ms["stem_conv"]["bwd_ms"] > 0
    assert ms["s0b0_a_conv"]["fwd_ms"] > 0 and ms["s0b0_a_conv"]["bwd_ms"] > 0
    report = net.layer_report(x, y)
    layerprof.join_dynamic(report, ms, time_source="host_op_proxy")
    ent = report["layers"]["stem_conv"]
    assert ent["fwd_ms"] == round(ms["stem_conv"]["fwd_ms"], 4)
    assert report["time_source"] == "host_op_proxy"
    assert "pct_of_roof" in ent
    split = layerprof.share_step_time(report, 10.0)
    assert sum(v["fwd_ms"] + v["bwd_ms"] for v in split.values()) == \
        pytest.approx(10.0)
    assert report["time_source"] == "static_share_proxy"
    # the same split as the JAX module's on the same report
    jsplit = jlp.share_step_time({"layers": {
        k: dict(v) for k, v in report["layers"].items()}}, 10.0)
    for k, v in split.items():
        assert v["fwd_ms"] == pytest.approx(jsplit[k]["fwd_ms"])


def test_kernel_launches_are_charged_their_analytic_cost():
    """A hand-written kernel's launch inside ``attribute_step`` is
    charged to its scope the bytes and operations its wrapper hands over
    (forward, and in the backward to the forward's scope); a launch from
    another thread (on the card, autograd's device thread runs the
    backward) is counted too; the listener is gone after the step."""
    k = cuda_build.Kernel("lp_test_kernel", source="-", replaces="-")

    class _Launches(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            k.launched(lambda: (1000.0, 300.0))
            return x * 2.0

        @staticmethod
        def backward(ctx, g):
            k.launched(lambda: (500.0, 70.0))
            return g * 2.0

    x = torch.ones(8, requires_grad=True)

    def step():
        with layerprof.scope("blk"):
            y = _Launches.apply(x)
        with layerprof.scope("loss"):
            y.sum().backward()
        t = threading.Thread(target=k.launched,
                             args=(lambda: (20.0, 10.0),))
        t.start()
        t.join()

    report = layerprof.attribute_step(step)
    assert report["layers"]["_unattributed"]["kernel_bytes"] == 20
    ent = report["layers"]["blk"]
    assert ent["kernel_launches"] == {"lp_test_kernel": 2}
    assert ent["kernel_bytes"] == 1500 and ent["kernel_flops"] == 370
    assert ent["flops_fwd"] >= 300 and ent["flops_bwd"] >= 70
    assert ent["bytes_fwd"] >= 1000 and ent["bytes_bwd"] >= 500
    assert ent["conv_dot_flops_fwd"] == 0      # not a product kernel
    assert layerprof.reconcile_error_pct(report) < 1e-9
    assert not cuda_build._listeners
    k.launched(lambda: (1.0, 1.0))             # outside: no listener


@torch.library.custom_op("dl4j::lp_test_costed", mutates_args=())
def _lp_test_costed(x: torch.Tensor) -> torch.Tensor:
    _LP_KERNEL.launched(lambda: (7.0, 7.0))
    return x * 3.0


@_lp_test_costed.register_fake
def _lp_test_costed_fake(x):
    return torch.empty_like(x)


_LP_KERNEL = cuda_build.Kernel("lp_test_inner", source="-", replaces="-")


def test_a_costed_custom_op_is_charged_its_rule_once():
    """A ``dl4j`` custom op with a cost rule is charged the rule, not its
    insides: the kernel it launches is counted, not charged again."""
    layerprof.register_op_cost("lp_test_costed", lambda args: (123.0, 456.0))
    try:
        x = torch.ones(4)

        def step():
            with layerprof.scope("blk"):
                torch.ops.dl4j.lp_test_costed(x)

        ent = layerprof.attribute_step(step)["layers"]["blk"]
    finally:
        layerprof._OP_COSTS.pop("lp_test_costed")
    assert ent["bytes"] == 123 and ent["flops"] == 456
    assert ent["conv_dot_flops_fwd"] == 456
    assert ent["kernel_launches"] == {"lp_test_inner": 1}
    assert ent["kernel_bytes"] == 0


@pytest.mark.parametrize("causal", [False, True])
def test_flash_ops_are_charged_the_kernels_analytic_cost(causal):
    """The flash attention custom ops (kernels 7-9 on the card, their
    plain versions here) carry their kernels' analytic cost: 4 (forward),
    6 (dq) and 8 (dk, dv) flops a (query, key) pair the causal mask keeps
    and a head dimension, forward in the scope and backward charged back
    to it."""
    from deeplearning4j_tpu_torch.parallel import sequence as sq
    b, h, tq, tk, d = 2, 3, 5, 7, 4
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(b, h, t, d, generator=g, requires_grad=True)
               for t in (tq, tk, tk))
    mask = torch.ones(b, tk)

    def step():
        with layerprof.scope("att"):
            out, _ = sq.flash_fwd_op(q, k, v, mask, causal)
        with layerprof.scope("loss"):
            out.sum().backward()

    ent = layerprof.attribute_step(step)["layers"]["att"]
    pairs = sum(min(i + 1, tk) for i in range(tq)) if causal else tq * tk
    assert ent["conv_dot_flops_fwd"] == 4 * b * h * pairs * d
    assert ent["conv_dot_flops_bwd"] == (6 + 8) * b * h * pairs * d
    want = {n: sq.flash_cost(n, q, k, mask, causal)[0]
            for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    assert ent["bytes_fwd"] == want["flash_fwd"]
    assert ent["bytes_bwd"] >= want["flash_bwd_dq"] + want["flash_bwd_dkv"]
