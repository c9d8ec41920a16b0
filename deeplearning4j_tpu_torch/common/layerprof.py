"""Layer attribution: which layer a step's work and time belong to.

Counterpart of ``deeplearning4j_tpu/common/layerprof.py``, with its
names, metric names and report schema, on PyTorch's means:

1. **Annotation.** The fit funnels wrap every layer or vertex of the
   training forward (and the loss and the update tail) in
   :func:`scope`: while a profiler records, a
   ``torch.profiler.record_function("dl4j.<name>")`` range, so its trace
   splits a step into the blocks the model names; always a thread-local
   stack (:func:`current_scope`) that
   ``ops/kernel_select.select`` reads, so every kernel decision is
   attributed to the layer whose forward made it
   (:func:`note_selection`, :func:`kernel_decisions`).

2. **Static attribution.** :func:`attribute_step` runs a callable (one
   train step: forward, backward and the update tail, nothing applied)
   under a ``TorchDispatchMode`` that charges every aten op to the
   innermost scope with the JAX module's analytic cost model: dot =
   2·out·k, conv = 2·out·window·Cin/g (its backward: the input gradient
   at the input's size, the weight gradient at the forward's count,
   reported apart as ``conv_weight_grad_flops``),
   reductions = max(in, out) elements, other elementwise math = out
   elements, transcendentals counted apart; bytes = each op's inputs
   read and outputs written. A backward op is charged to the scope of
   the forward op that made its autograd node (its sequence number
   falls in the scope's range of the forward). There is no compiled
   program to partition: the totals are the dispatch counts themselves,
   so :func:`reconcile_error_pct` is 0 by construction (``raw_model``
   says so). The port's hand-written kernels run through ctypes, below
   aten: on the card each launch is charged the analytic bytes and
   operations its wrapper hands to ``cuda_build``'s launch listeners
   (counted apart as ``kernel_bytes`` / ``kernel_flops``, beside
   ``kernel_launches``), and a ``dl4j`` custom op, which dispatch does
   not see into, its rule from :func:`register_op_cost` (the flash
   attention ops: their kernels' analytic cost, on the card and on the
   CPU alike).

3. **Dynamic attribution.** :func:`attribute_trace` buckets a
   ``torch.profiler`` chrome trace (``stepstats.ProfileCapture``'s
   ``device.trace.json``) by scope: each CUDA kernel is charged to the
   ``dl4j.<name>`` range around the host call that launched it, and a
   kernel launched by autograd's backward to the range around the
   forward op with the same sequence number (``bwd``). Where the trace
   holds no kernel (the CPU), host op time stands in and the result says
   so (``time_source``). :func:`join_dynamic` merges the milliseconds
   into a static report and runs ``diagnostics.roofline`` a layer.

Surfaces: ``layer_report(data, labels)`` on MultiLayerNetwork and
ComputationGraph, the ``dl4j_layer_seconds{layer,pass}`` histogram and
``dl4j_layer_flops`` / ``dl4j_layer_bytes`` gauges, :func:`last_report`
and a ``top_layer`` key on flight-recorder records. The HTTP view
(``/api/layers``) lives on the dashboard server, ROADMAP item 14. Gate:
``DL4J_TORCH_LAYERPROF`` (default on; ``Environment.extra["layerprof"]``
overrides it).
"""
from __future__ import annotations

import logging
import os
import re
import threading
from typing import Callable, Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from deeplearning4j_tpu_torch.common import telemetry
from deeplearning4j_tpu_torch.ops import cuda_build

log = logging.getLogger(__name__)

#: prefix all scope annotations carry in profiler traces
SCOPE_PREFIX = "dl4j."

_layer_seconds = telemetry.histogram(
    "dl4j_layer_seconds",
    "per-layer device time from dynamic trace attribution, by layer "
    "scope and pass (fwd/bwd) — seconds per attributed capture")
_layer_flops = telemetry.gauge(
    "dl4j_layer_flops",
    "per-layer share of the compiled step's cost-analysis flops "
    "(static scope partition; refreshed per layer_report)")
_layer_bytes = telemetry.gauge(
    "dl4j_layer_bytes",
    "per-layer share of the compiled step's cost-analysis bytes "
    "accessed (static scope partition; refreshed per layer_report)")

_tls = threading.local()
_state_lock = threading.Lock()
_last_report: Optional[dict] = None
_top_layer: Optional[str] = None
#: kernel-decision join: scope -> kernel family -> decision
_decisions: Dict[str, Dict[str, dict]] = {}


# ----------------------------------------------------------------------
# gate + annotation
def enabled() -> bool:
    """The ``DL4J_TORCH_LAYERPROF`` gate (default on);
    ``Environment.extra["layerprof"]`` overrides the env var."""
    from deeplearning4j_tpu_torch.common.environment import Environment
    flag = Environment.get().extra.get("layerprof")
    if flag is None:
        flag = os.environ.get("DL4J_TORCH_LAYERPROF")
    if flag is None or str(flag) == "":
        return True
    return str(flag) in ("1", "true", "True", "yes")


class _NullScope:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullScope()

_SAFE_RE = re.compile(r"[^0-9A-Za-z_.]")


def sanitize(name: str) -> str:
    """Scope names keep to the characters :func:`attribute_trace`'s
    pattern re-extracts."""
    return _SAFE_RE.sub("_", str(name)) or "_"


class _Scope:
    """An entry on this thread's scope stack, a profiler range while a
    profiler records (a range costs ~14 µs of host time to open and
    close, a step opens one a layer), and, while :func:`attribute_step`
    runs, a range of autograd sequence numbers."""

    __slots__ = ("name", "_rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        stack.append(self.name)
        rec = getattr(_tls, "recorder", None)
        if rec is not None:
            rec.enter(self.name)
        self._rf = None
        if torch._C._autograd._profiler_enabled():
            self._rf = torch.profiler.record_function(
                SCOPE_PREFIX + self.name)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        try:
            if self._rf is not None:
                return self._rf.__exit__(*exc)
            return False
        finally:
            rec = getattr(_tls, "recorder", None)
            if rec is not None:
                rec.exit()
            _tls.stack.pop()


def scope(name: str):
    """Annotate the with-block as layer ``name`` (sanitized). A no-op
    context when the gate is off."""
    if not enabled():
        return _NULL
    return _Scope(sanitize(name))


def current_scope() -> Optional[str]:
    """The innermost active :func:`scope` name on this thread, or
    None."""
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


# ----------------------------------------------------------------------
# kernel-decision join (fed by ops.kernel_select.select)
def note_selection(selection) -> None:
    """Record a ``kernel_select.Selection`` against the layer scope
    whose forward made it."""
    sc = current_scope() or "_unscoped"
    with _state_lock:
        per = _decisions.setdefault(sc, {})
        prev = per.get(selection.kernel)
        if prev is None:
            per[selection.kernel] = {
                "kernel": selection.kernel,
                "fused": bool(selection.fused),
                "decision": selection.decision,
                "reason": selection.reason,
                "sites": 1,
            }
        else:
            prev.update(fused=bool(selection.fused),
                        decision=selection.decision,
                        reason=selection.reason)
            prev["sites"] += 1


def kernel_decisions(scope_name: Optional[str] = None) -> dict:
    """The recorded decisions: for one scope (``{kernel: decision}``) or
    all scopes when ``scope_name`` is None."""
    with _state_lock:
        if scope_name is not None:
            return {k: dict(v)
                    for k, v in _decisions.get(scope_name, {}).items()}
        return {s: {k: dict(v) for k, v in per.items()}
                for s, per in _decisions.items()}


def reset_decisions() -> None:
    with _state_lock:
        _decisions.clear()


# ----------------------------------------------------------------------
# static attribution: aten ops charged to scopes
class _ScopeCost:
    __slots__ = ("flops_fwd", "flops_bwd", "bytes_fwd", "bytes_bwd",
                 "transcendentals", "conv_dot_fwd", "conv_dot_bwd",
                 "conv_wgrad", "launches", "kernel_flops", "kernel_bytes")

    def __init__(self):
        self.flops_fwd = self.flops_bwd = 0.0
        self.bytes_fwd = self.bytes_bwd = 0.0
        self.transcendentals = 0.0
        self.conv_dot_fwd = self.conv_dot_bwd = 0.0
        self.conv_wgrad = 0.0
        self.launches: Dict[str, int] = {}
        self.kernel_flops = self.kernel_bytes = 0.0

    def charge(self, flops: float, byts: float, prod: float,
               bwd: bool) -> None:
        if bwd:
            self.flops_bwd += flops
            self.bytes_bwd += byts
            self.conv_dot_bwd += prod
        else:
            self.flops_fwd += flops
            self.bytes_fwd += byts
            self.conv_dot_fwd += prod


#: analytic ``rule(args) -> (bytes, product flops)`` of ``dl4j`` custom
#: ops, whose insides dispatch does not see, by op name
_OP_COSTS: Dict[str, Callable] = {}
#: hand-written kernels whose operations are products (dot flops)
_PRODUCT_KERNELS = frozenset(("matmul_bias_act", "flash_fwd",
                              "flash_bwd_dq", "flash_bwd_dkv",
                              "paged_decode"))


def register_op_cost(name: str, rule: Callable) -> None:
    """Charge every call of the ``dl4j::<name>`` custom op
    ``rule(args)`` = (bytes, product flops) in :func:`attribute_step`."""
    _OP_COSTS[name] = rule


#: one flop an output element (simple elementwise math; comparisons,
#: selects and copies count zero)
_ELEMENTWISE_FLOP = frozenset((
    "add", "add_", "sub", "sub_", "rsub", "mul", "mul_", "div", "div_",
    "remainder", "fmod", "maximum", "minimum", "clamp", "clamp_min",
    "clamp_max", "neg", "abs", "sign", "floor", "ceil", "round", "relu",
    "relu_", "threshold_backward", "leaky_relu", "hardtanh", "addcmul",
    "addcdiv", "lerp", "where", "square", "reciprocal", "pow",
))
_TRANSCENDENTAL = frozenset((
    "exp", "expm1", "log", "log1p", "log2", "sigmoid", "tanh", "rsqrt",
    "sqrt", "sin", "cos", "tan", "atan2", "erf", "erfc", "gelu",
    "_softmax", "_log_softmax", "softplus",
))
_REDUCTIONS = frozenset((
    "sum", "mean", "amax", "amin", "max", "min", "prod", "var", "std",
    "var_mean", "norm", "linalg_vector_norm", "logsumexp", "argmax",
    "argmin", "native_batch_norm", "_native_batch_norm_legit",
    "native_batch_norm_backward", "_softmax_backward_data",
    "_log_softmax_backward_data", "native_layer_norm",
    "native_layer_norm_backward", "max_pool2d_with_indices",
    "avg_pool2d", "max_pool2d_with_indices_backward",
    "avg_pool2d_backward", "_adaptive_avg_pool2d", "cumsum",
))
#: no byte traffic of their own (views, metadata)
_FREE_BYTES = frozenset((
    "view", "_unsafe_view", "reshape", "expand", "t", "transpose",
    "permute", "squeeze", "unsqueeze", "as_strided", "detach", "alias",
    "slice", "select", "split", "split_with_sizes", "unbind", "narrow",
    "_reshape_alias", "lift_fresh", "empty", "empty_like",
    "empty_strided", "zeros", "zeros_like", "ones_like", "full",
    "scalar_tensor", "arange", "new_empty", "new_zeros", "new_empty_strided",
))


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _tensors(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from _tensors(o)


def _numel(t) -> int:
    return int(t.numel()) if isinstance(t, torch.Tensor) else 0


def _bytes(objs) -> float:
    return float(sum(t.numel() * t.element_size() for o in objs
                     for t in _tensors(o)))


def _conv_wgrad_flops(args) -> float:
    """A ``convolution_backward``'s weight gradient: the forward's
    count, 2·|W|·N·Ho·Wo."""
    grad_out, w = args[0], args[2]
    if not args[10][1]:
        return 0.0
    return 2.0 * _numel(w) * _numel(grad_out) / int(w.shape[0])


def _conv_dot_flops(name: str, args, out) -> float:
    """The analytic products of one aten op: dot = 2·out·k, conv =
    2·out·window·Cin/g; 0 for any other op."""
    if name in ("mm", "bmm", "matmul", "dot", "mv", "vdot"):
        a = args[0]
        k = int(a.shape[-1]) if a.dim() else 1
        return 2.0 * _numel(out) * k
    if name in ("addmm", "baddbmm", "addmv", "addbmm"):
        a = args[1]
        return 2.0 * _numel(out) * int(a.shape[-1])
    if name in ("convolution", "_convolution", "conv2d", "conv1d",
                "conv3d", "cudnn_convolution", "mkldnn_convolution"):
        w = args[1]
        groups = int(args[8]) if len(args) > 8 and \
            name in ("convolution", "_convolution") else 1
        transposed = name in ("convolution", "_convolution") and \
            bool(args[6])
        window = 1
        for d in w.shape[2:]:
            window *= int(d)
        if transposed:
            # weight [Cin, Cout/g, ...]: counted at the output's size
            return 2.0 * _numel(out) * window * int(w.shape[0]) / groups
        return 2.0 * _numel(out) * window * int(w.shape[1])
    if name == "convolution_backward":
        grad_out, x, w = args[0], args[1], args[2]
        groups = int(args[9])
        mask = args[10]
        window = 1
        for d in w.shape[2:]:
            window *= int(d)
        flops = 0.0
        if mask[0]:
            # the input gradient at the input's size (as XLA's dilated
            # convolution counts it)
            flops += 2.0 * _numel(x) * window * int(w.shape[0]) / groups
        if mask[1]:
            flops += _conv_wgrad_flops(args)
        return flops
    if name in ("_scaled_dot_product_efficient_attention",
                "_scaled_dot_product_flash_attention",
                "_scaled_dot_product_cudnn_attention",
                "_scaled_dot_product_attention_math"):
        q, k = args[0], args[1]
        return 4.0 * _numel(q) * int(k.shape[-2])
    return 0.0


class _Attribution(TorchDispatchMode):
    """Charges every aten op run under it to the innermost scope (a
    backward op: the scope whose forward made its autograd node)."""

    def __init__(self):
        super().__init__()
        self.costs: Dict[str, _ScopeCost] = {}
        self._open: List[tuple] = []
        self.ranges: List[tuple] = []      # (lo, hi, depth, name)
        self._quiet = False
        self._in_op = 0                    # inside a costed custom op

    # -- sequence-number ranges of the forward --------------------------
    def _seq(self) -> int:
        self._quiet = True
        try:
            with torch.enable_grad():
                t = torch.zeros((), requires_grad=True) * 1.0
            return int(t.grad_fn._sequence_nr())
        finally:
            self._quiet = False

    def enter(self, name: str) -> None:
        self._open.append((name, self._seq()))

    def exit(self) -> None:
        name, lo = self._open.pop()
        self.ranges.append((lo, self._seq(), len(self._open), name))

    def _scope_of_node(self, node) -> str:
        seq = int(node._sequence_nr())
        best, depth = "_unattributed", -1
        for lo, hi, d, name in self.ranges:
            if lo < seq < hi and d > depth:
                best, depth = name, d
        return best

    def _where(self):
        node = torch._C._current_autograd_node()
        if node is not None:
            return self._scope_of_node(node), True
        return current_scope() or "_unattributed", False

    def cost(self, name: str) -> _ScopeCost:
        c = self.costs.get(name)
        if c is None:
            c = self.costs[name] = _ScopeCost()
        return c

    def launched(self, kernel: str, cost) -> None:
        """A hand-written kernel's launch: counted against its scope, and
        charged its analytic cost unless a custom op's rule already
        charged it."""
        scope_name, bwd = self._where()
        c = self.cost(scope_name)
        c.launches[kernel] = c.launches.get(kernel, 0) + 1
        if cost is None or self._in_op:
            return
        byts, ops = (float(v) for v in cost())
        c.kernel_bytes += byts
        c.kernel_flops += ops
        c.charge(ops, byts, ops if kernel in _PRODUCT_KERNELS else 0.0, bwd)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        rule = _OP_COSTS.get(name) if func.namespace == "dl4j" else None
        self._in_op += rule is not None
        try:
            out = func(*args, **(kwargs or {}))
        finally:
            self._in_op -= rule is not None
        if self._quiet:
            return out
        scope_name, bwd = self._where()
        c = self.cost(scope_name)
        if rule is not None:
            byts, prod = (float(v) for v in rule(args))
            c.charge(prod, byts, prod, bwd)
            return out
        prod = _conv_dot_flops(name, args, out)
        if prod:
            flops = prod
        elif name in _REDUCTIONS:
            flops = float(max(sum(_numel(t) for t in _tensors(args[:1])),
                              sum(_numel(t) for t in _tensors(out))))
        elif name in _ELEMENTWISE_FLOP:
            flops = float(sum(_numel(t) for t in _tensors(out)))
        else:
            flops = 0.0
            if name in _TRANSCENDENTAL:
                c.transcendentals += float(
                    sum(_numel(t) for t in _tensors(out)))
        byts = 0.0 if name in _FREE_BYTES else \
            _bytes(args) + _bytes((kwargs or {},)) + _bytes((out,))
        c.charge(flops, byts, prod, bwd)
        if bwd and name == "convolution_backward":
            c.conv_wgrad += _conv_wgrad_flops(args)
        return out


def attribute_step(step: Callable[[], object], *,
                   model_name: Optional[str] = None,
                   layer_types: Optional[dict] = None,
                   peak_tflops: Optional[float] = None,
                   peak_hbm_gbps: Optional[float] = None) -> dict:
    """Run ``step`` (forward, backward and the update tail of one train
    step, under the model's scopes) with every aten op charged to its
    scope, and return the layer report (the JAX package's schema; see
    the module docstring). Publishes it as the last report (the
    ``dl4j_layer_*`` gauges, ``top_layer``)."""
    from deeplearning4j_tpu_torch.common import diagnostics
    rec = _Attribution()
    prev = getattr(_tls, "recorder", None)
    _tls.recorder = rec
    # every launch while the step runs, on any thread: on the card the
    # backward's launches come from autograd's device thread
    cuda_build.add_launch_listener(rec.launched)
    try:
        with rec:
            step()
    finally:
        cuda_build.remove_launch_listener(rec.launched)
        _tls.recorder = prev
    raw = rec.costs
    total_flops = sum(c.flops_fwd + c.flops_bwd for c in raw.values())
    total_bytes = sum(c.bytes_fwd + c.bytes_bwd for c in raw.values())
    peak_tf = peak_tflops or diagnostics.H100_PEAK_TFLOPS["float32"]
    peak_bw = peak_hbm_gbps or diagnostics.H100_HBM_GBPS
    ridge = peak_tf * 1e12 / (peak_bw * 1e9)
    layers = {}
    attr_flops = attr_bytes = 0.0
    for name, c in raw.items():
        flops = c.flops_fwd + c.flops_bwd
        byts = c.bytes_fwd + c.bytes_bwd
        ai = flops / max(byts, 1.0)
        est_s = max(flops / (peak_tf * 1e12), byts / (peak_bw * 1e9))
        ent = {
            "flops": round(flops),
            "bytes": round(byts),
            "flops_fwd": round(c.flops_fwd), "flops_bwd": round(c.flops_bwd),
            "bytes_fwd": round(c.bytes_fwd), "bytes_bwd": round(c.bytes_bwd),
            "conv_dot_flops_fwd": round(c.conv_dot_fwd),
            "conv_dot_flops_bwd": round(c.conv_dot_bwd),
            "conv_weight_grad_flops": round(c.conv_wgrad),
            "share_flops": round(flops / total_flops, 4)
            if total_flops else 0.0,
            "share_bytes": round(byts / total_bytes, 4)
            if total_bytes else 0.0,
            "arithmetic_intensity": round(ai, 2),
            "bound": "compute" if ai >= ridge else "hbm",
            "est_ms": round(est_s * 1e3, 7),
        }
        if c.launches:
            ent["kernel_launches"] = dict(c.launches)
            ent["kernel_flops"] = round(c.kernel_flops)
            ent["kernel_bytes"] = round(c.kernel_bytes)
        if layer_types and name in layer_types:
            ent["type"] = layer_types[name]
        kd = kernel_decisions(name)
        if kd:
            ent["kernel"] = kd
        if name != "_unattributed":
            attr_flops += flops
            attr_bytes += byts
        layers[name] = ent
    layers = dict(sorted(layers.items(), key=lambda kv: kv[1]["est_ms"],
                         reverse=True))
    report = {
        "model": model_name,
        "peaks": {"tflops": peak_tf, "hbm_gbps": peak_bw},
        "totals": {
            "flops": float(total_flops),
            "bytes": float(total_bytes),
            "transcendentals": float(sum(c.transcendentals
                                         for c in raw.values())),
        },
        "raw_model": {
            "flops": round(total_flops),
            "bytes": round(total_bytes),
            "flops_err_pct": 0.0,
            "bytes_err_pct": 0.0,
            "loop_semantics": "executed-trips",
            "source": "aten dispatch counts of one eager train step: the "
                      "totals are the per-scope sums, so the "
                      "reconciliation error is 0 by construction; "
                      "hand-written kernels launched through ctypes and "
                      "the dl4j custom ops are charged their analytic "
                      "bytes and operations",
        },
        "coverage": {
            "flops": round(attr_flops / total_flops, 4)
            if total_flops else 0.0,
            "bytes": round(attr_bytes / total_bytes, 4)
            if total_bytes else 0.0,
        },
        "time_source": "static_roofline_model",
        "layers": layers,
    }
    _publish(report)
    return report


def reconcile_error_pct(report: dict) -> float:
    """Max relative error (percent) between the per-layer sums and the
    whole-step totals."""
    worst = 0.0
    for key in ("flops", "bytes"):
        total = report["totals"][key]
        if not total:
            continue
        got = sum(ent[key] for ent in report["layers"].values())
        worst = max(worst, abs(got - total) / total * 100.0)
    return worst


# ----------------------------------------------------------------------
# dynamic attribution: a torch.profiler trace -> per-layer milliseconds
_SCOPE_RE = re.compile(r"dl4j\.([0-9A-Za-z_.]*[0-9A-Za-z_])")
_KERNEL_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _innermost(ranges, ts: float) -> Optional[str]:
    """The innermost ``(start, end, name)`` range holding ``ts``."""
    best, width = None, None
    for lo, hi, name in ranges:
        if lo <= ts <= hi and (width is None or hi - lo < width):
            best, width = name, hi - lo
    return best


def attribute_trace(events) -> Dict[str, dict]:
    """Per-scope ``{"fwd_ms", "bwd_ms"}`` of a ``torch.profiler`` chrome
    trace's events. Each device kernel (``cat`` kernel / memcpy /
    memset) is charged through its ``correlation`` id to the host call
    that launched it, and from there to the innermost ``dl4j.<name>``
    range on that thread around the call (``fwd``); a call made by
    autograd's backward, outside any range, goes to the range around the
    forward op with its ``Sequence number`` (``bwd``). Without device
    kernels (a CPU trace) host op time is bucketed the same way. Observes
    ``dl4j_layer_seconds``."""
    events = [e for e in events if e.get("ph") == "X"]
    scopes: Dict[tuple, list] = {}
    fwd_seq: Dict[int, float] = {}
    host_ops = []
    for e in events:
        name = str(e.get("name", ""))
        key = (e.get("pid"), e.get("tid"))
        ts, dur = float(e.get("ts", 0)), float(e.get("dur", 0) or 0)
        if e.get("cat") in ("user_annotation", "cpu_instant_event") or \
                name.startswith(SCOPE_PREFIX) and \
                e.get("cat") not in _KERNEL_CATS + ("gpu_user_annotation",):
            m = _SCOPE_RE.match(name)
            if m:
                scopes.setdefault(key, []).append((ts, ts + dur,
                                                   m.group(1)))
        elif e.get("cat") in ("cpu_op", "cuda_runtime", "cuda_driver",
                              "Operator", "Runtime"):
            host_ops.append(e)
    # forward ops' sequence numbers -> their scope
    for e in host_ops:
        args = e.get("args") or {}
        seq = args.get("Sequence number")
        if seq is None or "evaluate_function" in str(e.get("name")) or \
                "Backward" in str(e.get("name")):
            continue
        sc = _innermost(scopes.get((e.get("pid"), e.get("tid")), []),
                        float(e.get("ts", 0)))
        if sc is not None:
            fwd_seq.setdefault(int(seq), sc)
    # the backward: autograd's evaluate_function ranges and their seq
    bwd_ranges: Dict[tuple, list] = {}
    for e in host_ops:
        args = e.get("args") or {}
        seq = args.get("Sequence number")
        if seq is None or "evaluate_function" not in str(e.get("name")):
            continue
        sc = fwd_seq.get(int(seq))
        if sc is not None:
            ts = float(e.get("ts", 0))
            bwd_ranges.setdefault((e.get("pid"), e.get("tid")), []).append(
                (ts, ts + float(e.get("dur", 0) or 0), sc))

    def place(pid, tid, ts):
        sc = _innermost(scopes.get((pid, tid), []), ts)
        if sc is not None:
            return sc, "fwd"
        sc = _innermost(bwd_ranges.get((pid, tid), []), ts)
        if sc is not None:
            return sc, "bwd"
        return None, None

    launches = {}
    for e in host_ops:
        corr = (e.get("args") or {}).get("correlation")
        if corr is not None:
            launches[int(corr)] = e
    kernels = [e for e in events if e.get("cat") in _KERNEL_CATS]
    out: Dict[str, dict] = {}
    if kernels:
        for k in kernels:
            corr = (k.get("args") or {}).get("correlation")
            host = launches.get(int(corr)) if corr is not None else None
            if host is None:
                continue
            sc, p = place(host.get("pid"), host.get("tid"),
                          float(host.get("ts", 0)))
            if sc is None:
                continue
            d = out.setdefault(sc, {"fwd_ms": 0.0, "bwd_ms": 0.0})
            d[p + "_ms"] += float(k.get("dur", 0) or 0) / 1e3
    else:
        # no device kernels: host op time, each op once (the outermost
        # aten op under a scope, not its nested calls)
        for e in host_ops:
            if e.get("cat") not in ("cpu_op", "Operator"):
                continue
            name = str(e.get("name", ""))
            if not name.startswith("aten::"):
                continue
            sc, p = place(e.get("pid"), e.get("tid"), float(e.get("ts", 0)))
            if sc is None:
                continue
            d = out.setdefault(sc, {"fwd_ms": 0.0, "bwd_ms": 0.0})
            d[p + "_ms"] += float(e.get("dur", 0) or 0) / 1e3
    for scope_name, d in out.items():
        for p in ("fwd", "bwd"):
            if d[p + "_ms"]:
                _layer_seconds.observe(d[p + "_ms"] / 1e3,
                                       **{"layer": scope_name, "pass": p})
    return out


def trace_has_device_kernels(events) -> bool:
    return any(e.get("cat") in _KERNEL_CATS for e in events)


def attribute_trace_file(path: str) -> Dict[str, dict]:
    """:func:`attribute_trace` over a chrome-trace file (``.gz``
    handled)."""
    return attribute_trace(telemetry._load_trace(path).get("traceEvents",
                                                            []))


def join_dynamic(report: dict, layer_ms: Dict[str, dict],
                 time_source: str = "trace") -> dict:
    """Merge measured per-layer milliseconds into a static report and
    run the roofline a layer against the measured time."""
    from deeplearning4j_tpu_torch.common import diagnostics
    peaks = report.get("peaks", {})
    for name, ent in report["layers"].items():
        ms = layer_ms.get(name)
        if not ms:
            continue
        ent["fwd_ms"] = round(ms.get("fwd_ms", 0.0), 4)
        ent["bwd_ms"] = round(ms.get("bwd_ms", 0.0), 4)
        total_s = (ent["fwd_ms"] + ent["bwd_ms"]) / 1e3
        if total_s > 0:
            rl = diagnostics.roofline(
                ent["flops"], ent["bytes"], total_s,
                peak_tflops=peaks.get("tflops"),
                peak_hbm_gbps=peaks.get("hbm_gbps"))
            ent["pct_of_roof"] = rl.get("pct_of_roof")
            ent["tflops"] = rl.get("tflops")
    report["time_source"] = time_source
    _publish(report)
    return report


def share_step_time(report: dict, step_ms: float,
                    time_source: str = "static_share_proxy"
                    ) -> Dict[str, dict]:
    """Split a measured whole-step wall time into per-layer fwd / bwd
    milliseconds by the static roofline-time weights; ``time_source``
    marks the result as the proxy it is."""
    layers = report["layers"]
    est_total = sum(e["est_ms"] for e in layers.values()) or 1.0
    out = {}
    for name, ent in layers.items():
        ms = step_ms * ent["est_ms"] / est_total
        denom = max(ent["flops_fwd"] + ent["flops_bwd"]
                    + ent["bytes_fwd"] + ent["bytes_bwd"], 1.0)
        fwd_w = (ent["flops_fwd"] + ent["bytes_fwd"]) / denom
        out[name] = {"fwd_ms": ms * fwd_w, "bwd_ms": ms * (1 - fwd_w)}
    join_dynamic(report, out, time_source=time_source)
    return out


# ----------------------------------------------------------------------
# module report state (the flight recorder reads this)
def _publish(report: dict) -> None:
    global _last_report, _top_layer
    top = None
    best = -1.0
    for name, ent in report["layers"].items():
        if name == "_unattributed":
            continue
        t = ent.get("fwd_ms", 0.0) + ent.get("bwd_ms", 0.0) \
            or ent.get("est_ms", 0.0)
        if t > best:
            best, top = t, name
        _layer_flops.set(ent["flops"], layer=name)
        _layer_bytes.set(ent["bytes"], layer=name)
    with _state_lock:
        _last_report = report
        _top_layer = top


def last_report() -> Optional[dict]:
    """The most recent layer report computed in this process."""
    with _state_lock:
        return _last_report


def top_layer() -> Optional[str]:
    """The heaviest layer of the last report (measured time when the
    dynamic join ran, else the static roofline-time estimate)."""
    return _top_layer


def reset() -> None:
    """Clear the report state and the decision join."""
    global _last_report, _top_layer
    with _state_lock:
        _last_report = None
        _top_layer = None
        _decisions.clear()
