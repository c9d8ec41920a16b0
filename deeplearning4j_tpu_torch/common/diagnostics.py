"""Training diagnostics: the device under the telemetry spine.

Counterpart of ``deeplearning4j_tpu/common/diagnostics.py``, with its
names, metric names and record schemas. Four pieces:

- **Device memory.** :func:`device_memory_stats` reads the caching
  allocator (``torch.cuda.memory_stats`` / ``mem_get_info``) of every
  card into ``dl4j_hbm_live_bytes`` / ``dl4j_hbm_peak_bytes`` gauges,
  each series naming its card; :func:`memory_report` attributes the
  bytes to parameters, updater state and model state of every model the
  fit funnels stepped (:func:`track_model`), the prefetch staging, the
  paged KV pools (``serving/kvcache.py``), and the residual the
  allocator holds beyond them (activations, workspaces, the cache).
- **Per-collective tracing.** :func:`collective_span`: a
  ``collective.<kind>`` trace span plus ``dl4j_collective_seconds
  {kind,axis}`` and ``dl4j_collective_bytes_total{kind,axis}``, folded
  into the step breakdown (``common/stepstats.py``).
- **Numerics watchdog.** Opt-in (``DL4J_TORCH_NUMERICS_WATCHDOG=1``),
  sampled (``DL4J_TORCH_NUMERICS_SAMPLE=N``) non-finite check of the
  loss and the global gradient norm in the fit funnels: a trip raises
  :class:`NumericsEvent` naming the step, the tensor group and the first
  bad leaf (:func:`first_nonfinite`), after the flight recorder dumps.
- **Flight recorder.** :class:`FlightRecorder`, a bounded ring of
  per-step records (step time, loss, gradient norm, collective bytes,
  device memory, the step's phase breakdown, the heaviest layer of the
  last layer report) dumped as JSONL plus a chrome trace of the span
  ring on a crash (``sys.excepthook``), on SIGTERM, or on a watchdog
  trip; the newest ``DL4J_TORCH_FLIGHT_RECORDER_KEEP`` dumps are kept.

Also :func:`roofline` (achieved rates against the H100's peaks) and
:func:`bench_meta` (the provenance block: versions, the card's name and
power limit as ``nvidia-smi`` reports them, the ``DL4J_TORCH_*``
environment). The funnels call :func:`after_step` (record, then the
watchdog) or :func:`record_step` (record only: the accumulation path
checks before it sums); both close the step breakdown. The JAX
package's fault-injection hook (``common/faults.py``) is ROADMAP item
14. Gates: ``DL4J_TORCH_FLIGHT_RECORDER`` (default on),
``DL4J_TORCH_NUMERICS_WATCHDOG`` (default off),
``DL4J_TORCH_HBM_SAMPLE_STEPS`` (``common/environment.py``). Nothing on
the compute path changes with any gate.
"""
from __future__ import annotations

import json
import logging
import math
import os
import signal
import subprocess
import sys
import threading
import time
import weakref
from collections import deque
from contextlib import contextmanager
from typing import Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.common import stepstats, telemetry
from deeplearning4j_tpu_torch.common.environment import Environment

log = logging.getLogger("deeplearning4j_tpu_torch")

#: flight-recorder / memory-report schema version, stamped into every
#: artifact
SCHEMA_VERSION = 1

#: the H100 SXM's peaks (PERF.md's kernel table): HBM3 at 3.35 TB/s,
#: 67 TFLOP/s f32 (no tensor cores), 989 TFLOP/s dense bf16 / f16
H100_HBM_GBPS = 3350.0
H100_PEAK_TFLOPS = {"float32": 67.0, "bfloat16": 989.0, "float16": 989.0,
                    "float64": 34.0}


def peak_tflops_for(dtype) -> float:
    """The card's peak for ``dtype`` (a torch dtype or its name)."""
    name = str(dtype).replace("torch.", "")
    return H100_PEAK_TFLOPS.get(name, H100_PEAK_TFLOPS["float32"])


# ----------------------------------------------------------------------
# device memory
def _tree_tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tree_tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tree_tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _tree_bytes(tree) -> int:
    """Bytes of every tensor of a nested dict / list tree. A replica's
    tensors are what its card holds: under ZeRO-1 or fsdp the updater
    state and parameters are already its 1/N slices."""
    return sum(t.numel() * t.element_size() for t in _tree_tensors(tree))


def device_memory_stats() -> List[dict]:
    """Per-card allocator stats: ``bytes_in_use`` (allocated tensors),
    ``peak_bytes_in_use``, ``bytes_limit`` (the card's total memory),
    ``bytes_reserved`` (the caching allocator's segments) and
    ``bytes_free`` (free memory as ``mem_get_info`` reports it). Empty
    without a card."""
    if not torch.cuda.is_available():
        return []
    out = []
    for i in range(torch.cuda.device_count()):
        st = torch.cuda.memory_stats(i)
        free, total = torch.cuda.mem_get_info(i)
        out.append({
            "id": i,
            "kind": torch.cuda.get_device_name(i),
            "bytes_in_use": int(st.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(st.get("allocated_bytes.all.peak",
                                            0)),
            "bytes_limit": int(total),
            "bytes_reserved": int(st.get("reserved_bytes.all.current", 0)),
            "bytes_free": int(free),
        })
    return out


def update_hbm_gauges(stats: Optional[List[dict]] = None) -> List[dict]:
    """Refresh ``dl4j_hbm_live_bytes`` / ``dl4j_hbm_peak_bytes`` from the
    allocator (``stats`` injectable for tests and for the CPU, where
    there is none), a series a card, labelled with its index and
    name."""
    if stats is None:
        stats = device_memory_stats()
    if stats and telemetry.enabled():
        live = telemetry.gauge(
            "dl4j_hbm_live_bytes",
            "device allocator bytes currently in use, per device")
        peak = telemetry.gauge(
            "dl4j_hbm_peak_bytes",
            "device allocator high-water mark, per device")
        for s in stats:
            labels = {"device": str(s["id"]),
                      "kind": str(s.get("kind", ""))}
            live.set(s["bytes_in_use"], **labels)
            peak.set(s["peak_bytes_in_use"], **labels)
    return stats


#: models the fit funnels have stepped, for attribution (weak, so a
#: dropped model does not leak through the diagnostics layer)
_tracked_models: "weakref.WeakValueDictionary[str, object]" = \
    weakref.WeakValueDictionary()
_tracked_lock = threading.Lock()


def track_model(model, name: Optional[str] = None) -> None:
    """Register a model for :func:`memory_report` attribution (the fit
    funnels do this on every recorded step; idempotent and weak)."""
    key = f"{name or type(model).__name__}@{id(model):x}"
    if key not in _tracked_models:
        with _tracked_lock:
            try:
                _tracked_models[key] = model
            except TypeError:       # not weak-referenceable
                pass


def _model_attribution(model) -> dict:
    """Bytes by buffer family for one model: the networks' ``params`` /
    ``updater_states`` / ``states``, SameDiff's ``_arrays`` /
    ``_updater_state``."""
    params = getattr(model, "params", None)
    if params is None or callable(params):
        params = getattr(model, "_arrays", {})
    upd = getattr(model, "updater_states", None)
    if upd is None:
        upd = getattr(model, "_updater_state", None) or {}
    states = getattr(model, "states", {}) or {}
    p, u = _tree_bytes(params), _tree_bytes(upd)
    return {
        "params_bytes": p,
        "updater_state_bytes": u,
        "model_state_bytes": _tree_bytes(states),
        "params_resident_bytes": p,
        "updater_state_resident_bytes": u,
    }


def memory_report(model=None) -> dict:
    """The device-memory attribution report: allocator stats a card
    (live / peak / limit), each tracked model's parameter, updater-state
    and model-state bytes, the prefetch staging, the paged KV pools, and
    what the allocator holds beyond them. ``model`` narrows the
    attribution to one model; by default every tracked model counts."""
    devices = update_hbm_gauges()
    if model is not None:
        items = [(type(model).__name__, model)]
    else:
        with _tracked_lock:
            items = [(k, m) for k, m in _tracked_models.items()]
    models = {name: _model_attribution(m) for name, m in items}
    staging = telemetry.gauge(
        "dl4j_prefetch_staged_bytes",
        "bytes of device-prefetched batches currently staged ahead of "
        "the step loop").value()
    accounted = int(staging) + sum(
        v["params_resident_bytes"] + v["updater_state_resident_bytes"] +
        v["model_state_bytes"] for v in models.values())
    # the paged KV pools are their own resident class (sys.modules: no
    # import edge from diagnostics to serving)
    kvc = sys.modules.get("deeplearning4j_tpu_torch.serving.kvcache")
    kv_pools = kvc.pool_report() if kvc is not None else []
    kv_bytes = kvc.pool_resident_bytes() if kvc is not None else 0
    accounted += int(kv_bytes)
    report = {
        "schema_version": SCHEMA_VERSION,
        "devices": devices,
        "live_bytes_total": sum(d["bytes_in_use"] for d in devices),
        "peak_bytes_total": sum(d["peak_bytes_in_use"]
                                for d in devices),
        "models": models,
        "prefetch_staging_bytes": int(staging),
        "kv_pools": kv_pools,
        "kv_pool_bytes": int(kv_bytes),
        "accounted_bytes": accounted,
    }
    if devices:
        # what the allocator holds beyond the buffers named here:
        # activations kept for the backward, workspaces
        report["activations_and_workspace_bytes_est"] = max(
            report["live_bytes_total"] - accounted, 0)
    return report


def roofline(flops: float, bytes_moved: float, step_seconds: float,
             peak_tflops: Optional[float] = None,
             peak_hbm_gbps: Optional[float] = None) -> dict:
    """Roofline classification of measured work: achieved TFLOP/s and
    GB/s, arithmetic intensity against the ridge point of the given
    peaks (the H100's: :data:`H100_PEAK_TFLOPS`, :data:`H100_HBM_GBPS`),
    which roof binds, and the share of that roof reached."""
    tf = flops / step_seconds / 1e12
    gbps = bytes_moved / step_seconds / 1e9
    out = {
        "tflops": round(tf, 2),
        "hbm_gbps": round(gbps, 1),
        "arithmetic_intensity_flops_per_byte": round(
            flops / max(bytes_moved, 1.0), 2),
    }
    if peak_tflops and peak_hbm_gbps:
        ridge = peak_tflops * 1e12 / (peak_hbm_gbps * 1e9)
        ai = out["arithmetic_intensity_flops_per_byte"]
        out["ridge_flops_per_byte"] = round(ridge, 1)
        out["bound"] = "compute" if ai >= ridge else "hbm"
        out["pct_compute_peak"] = round(100 * tf / peak_tflops, 1)
        out["pct_hbm_peak"] = round(100 * gbps / peak_hbm_gbps, 1)
        out["pct_of_roof"] = (out["pct_compute_peak"]
                              if out["bound"] == "compute"
                              else out["pct_hbm_peak"])
    return out


def nvidia_smi_line() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them
    (the first card), or None where the tool is missing."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = r.stdout.strip().splitlines()
    return lines[0].strip() if r.returncode == 0 and lines else None


def bench_meta() -> dict:
    """The provenance block: schema version, time, torch / CUDA /
    Python versions, the cards (count, name, and name and power limit
    as ``nvidia-smi`` reports them), the git revision, and the
    ``DL4J_TORCH_*`` environment that shapes the run."""
    meta = {
        "schema_version": SCHEMA_VERSION,
        "time": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "python_version": sys.version.split()[0],
    }
    if torch.cuda.is_available():
        meta["device_count"] = torch.cuda.device_count()
        meta["device_kind"] = torch.cuda.get_device_name(0)
        meta["platform"] = "gpu"
        smi = nvidia_smi_line()
        if smi is not None:
            meta["nvidia_smi"] = smi
    else:
        meta["device_count"] = 0
        meta["platform"] = "cpu"
    try:
        rev = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10,
            cwd=os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__)))))
        if rev.returncode == 0:
            meta["git_rev"] = rev.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    meta["env"] = {k: v for k, v in sorted(os.environ.items())
                   if k.startswith("DL4J_TORCH_")}
    return meta


# ----------------------------------------------------------------------
# per-collective tracing
_COLLECTIVE_SECONDS_HELP = (
    "host-observed wall time of one collective exchange — update "
    "exchange (AllReduce | ReduceScatter+AllGather), sharded-state "
    "placement, cross-process batch assembly (seconds)")
_COLLECTIVE_BYTES_HELP = (
    "estimated per-replica bytes moved by collective exchanges, by "
    "kind and mesh axis")


@contextmanager
def collective_span(kind: str, axis: str, nbytes: int = 0, **attrs):
    """The general form of the ``dp.update_exchange`` span pattern: a
    chrome-trace span ``collective.<kind>`` plus
    ``dl4j_collective_seconds{kind,axis}`` and
    ``dl4j_collective_bytes_total{kind,axis}``.  ``kind`` names the
    exchange (``update_exchange``, ``state_placement``,
    ``global_assembly``, ...), ``axis`` the mesh axis it rides. Host
    time: it bounds, not isolates, the wire time (the collective's
    kernels run on the card's stream); the bytes counter is the
    per-replica estimate a scaling claim is checked against."""
    if not telemetry.enabled():
        yield
        return
    t0 = time.perf_counter()
    with telemetry.span(f"collective.{kind}", axis=axis,
                        bytes=int(nbytes), **attrs):
        yield
    dt = time.perf_counter() - t0
    telemetry.histogram(
        "dl4j_collective_seconds",
        _COLLECTIVE_SECONDS_HELP).observe(dt, kind=kind, axis=axis)
    if nbytes:
        telemetry.counter(
            "dl4j_collective_bytes_total",
            _COLLECTIVE_BYTES_HELP).inc(int(nbytes), kind=kind,
                                        axis=axis)
    # fold into the scaling observatory's step breakdown
    stepstats.note_collective(kind, dt)


# ----------------------------------------------------------------------
# numerics watchdog
class NumericsEvent(RuntimeError):
    """A non-finite value surfaced in training.  Structured: ``step``,
    ``model``, ``tensor_group`` (``loss``/``gradients``/``params``),
    ``value`` (the offending scalar when there is one), ``first_bad``
    ({leaf, dtype, flat_index} from the DpFlatSpec segment scan)."""

    def __init__(self, model: str, step: int, tensor_group: str,
                 first_bad: Optional[dict] = None, value=None):
        self.model = model
        self.step = int(step)
        self.tensor_group = tensor_group
        self.first_bad = first_bad
        self.value = value
        loc = f" first bad leaf: {first_bad}" if first_bad else ""
        super().__init__(
            f"non-finite {tensor_group} (={value}) in {model} at step "
            f"{step};{loc} — training halted by the numerics watchdog "
            f"(DL4J_TORCH_NUMERICS_WATCHDOG=0 disables)")

    def to_dict(self) -> dict:
        return {"model": self.model, "step": self.step,
                "tensor_group": self.tensor_group,
                "first_bad": self.first_bad,
                "value": (None if self.value is None
                          else float(self.value))}


def _leaves_with_path(tree, path: str = ""):
    """``(label, tensor)`` of every tensor leaf in the JAX package's tree
    order (dict keys sorted, sequence items in order), each label its
    ``jax.tree_util.keystr`` (``"['layer_0']['W']"``)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, f"{path}[{i}]")
    elif isinstance(tree, torch.Tensor):
        yield path, tree


def first_nonfinite(tree) -> Optional[dict]:
    """Locate the first non-finite leaf element through the per-dtype
    flat layout (``learning.updaters.dp_ravel``): one ``isfinite`` and
    ``argmax`` a float dtype instead of a loop over leaves, the flat
    index then mapped back through the layout's (dtype, offset, shape)
    segments to a named leaf. Returns ``{leaf, dtype, flat_index}`` or
    None when every element is finite."""
    from deeplearning4j_tpu_torch.learning.updaters import dp_ravel
    labelled = list(_leaves_with_path(tree))
    if not labelled:
        return None
    paths = [p for p, _ in labelled]
    flats, spec = dp_ravel(_nested(labelled), 1)
    for dt, flat in flats.items():
        if not flat.is_floating_point():
            continue
        bad = ~torch.isfinite(flat)
        if not bool(bad.any()):
            continue
        idx = int(torch.argmax(bad.to(torch.uint8)))
        for (d, off, shape), label in zip(spec.infos, paths):
            if d != dt:
                continue
            size = int(np.prod(shape)) if shape else 1
            if off <= idx < off + size:
                return {"leaf": label, "dtype": dt,
                        "flat_index": idx - off}
        return {"leaf": "<padding>", "dtype": dt, "flat_index": idx}
    return None


def _nested(labelled) -> dict:
    """The leaves as one flat dict whose sorted keys keep the tree
    order (``dp_ravel`` sorts keys)."""
    return {f"{i:09d}": t for i, (_, t) in enumerate(labelled)}


def check_numerics(model, model_name: str, step: int, loss,
                   grad_norm=None, grads=None, params=None,
                   recorded: bool = False) -> None:
    """The fit-funnel watchdog hook.  No-op unless
    ``DL4J_TORCH_NUMERICS_WATCHDOG=1``; checks every
    ``DL4J_TORCH_NUMERICS_SAMPLE``-th step.  ``loss`` (and ``grad_norm``
    when the step computes one) are device scalars — the check is the
    one host sync.  On a trip the first bad leaf is located in
    ``grads`` (preferred) or ``params``, the flight recorder dumps
    with ``reason="numerics"``, and a :class:`NumericsEvent` raises."""
    env = Environment.get()
    if not env.numerics_watchdog:
        return
    if env.numerics_sample > 1 and step % env.numerics_sample:
        return
    lf = float(loss)
    gf = None if grad_norm is None else float(grad_norm)
    if math.isfinite(lf) and (gf is None or math.isfinite(gf)):
        return
    if not math.isfinite(lf):
        group, value = "loss", lf
    else:
        group, value = "gradients", gf
    first_bad = None
    scan = grads if grads is not None else params
    if scan is not None:
        try:
            first_bad = first_nonfinite(scan)
        except Exception as e:      # noqa: BLE001 — diagnosis must not
            log.warning("numerics attribution scan failed: %r", e)
    telemetry.counter(
        "dl4j_numerics_trips_total",
        "numerics-watchdog trips (non-finite loss or grad norm), by "
        "model and tensor group").inc(model=model_name, group=group)
    telemetry.instant("numerics_trip", model=model_name, step=step,
                      group=group)
    event = NumericsEvent(model_name, step, group, first_bad, value)
    rec = FlightRecorder.get()
    if rec.enabled:
        if not recorded:
            # the poisoned step itself belongs in the black box
            rec.record(model, model_name, step, lf, None,
                       grad_norm=gf)
        rec.dump("numerics", event=event.to_dict())
    raise event


# ----------------------------------------------------------------------
# flight recorder
class FlightRecorder:
    """Bounded ring of per-step structured records, dumped to
    ``flightrec_<pid>_<reason>.jsonl`` (+ a chrome trace of the span
    buffer's last window) on crash, SIGTERM, or watchdog trip.

    Loss/grad-norm enter the ring as device scalars and are
    materialized only at dump time, so recording never forces a step
    sync. Device memory gauges refresh every
    ``DL4J_TORCH_HBM_SAMPLE_STEPS`` records. Gate:
    ``DL4J_TORCH_FLIGHT_RECORDER`` (default on)."""

    _instance: Optional["FlightRecorder"] = None
    _instance_lock = threading.Lock()

    def __init__(self):
        env = Environment.get()
        self.enabled = bool(env.flight_recorder)
        self.max_steps = max(int(env.flight_recorder_steps), 1)
        self.dir = env.flight_recorder_dir or "flightrec"
        self.keep = max(int(env.flight_recorder_keep), 1)
        self.hbm_sample = max(int(env.hbm_sample_steps), 1)
        self._ring: "deque[dict]" = deque()
        self._lock = threading.Lock()
        self._installed = False
        self._prev_excepthook = None
        self._prev_sigterm = None
        self._n_records = 0
        self._last_hbm: List[dict] = []
        self._dumped_reasons: set = set()

    @classmethod
    def get(cls) -> "FlightRecorder":
        inst = cls._instance
        if inst is not None:
            return inst
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    @classmethod
    def _reset_for_tests(cls):
        with cls._instance_lock:
            if cls._instance is not None:
                cls._instance.uninstall()
            cls._instance = None
        with _tracked_lock:
            _tracked_models.clear()

    # -- crash / preemption hooks --------------------------------------
    def install(self) -> None:
        """Wrap ``sys.excepthook`` (crash) and the SIGTERM handler
        (preemption).  Idempotent; called lazily on the first recorded
        step so importing the library never touches process-global
        handlers."""
        if self._installed:
            return
        self._installed = True
        self._prev_excepthook = sys.excepthook

        def _hook(tp, val, tb):
            try:
                self.dump("crash", event={"error": repr(val)})
            finally:
                (self._prev_excepthook or sys.__excepthook__)(
                    tp, val, tb)

        sys.excepthook = _hook
        try:
            self._prev_sigterm = signal.signal(signal.SIGTERM,
                                               self._on_sigterm)
        except ValueError:
            # not the main thread — excepthook coverage only
            self._prev_sigterm = None

    def uninstall(self) -> None:
        if not self._installed:
            return
        self._installed = False
        if self._prev_excepthook is not None:
            sys.excepthook = self._prev_excepthook
        if self._prev_sigterm is not None:
            try:
                signal.signal(signal.SIGTERM, self._prev_sigterm)
            except ValueError:
                pass

    def _on_sigterm(self, signum, frame):
        self.dump("sigterm")
        prev = self._prev_sigterm
        if callable(prev):
            prev(signum, frame)
        else:
            # re-deliver with the default disposition so the exit
            # status still says "terminated by SIGTERM"
            try:
                signal.signal(signal.SIGTERM, signal.SIG_DFL)
            except ValueError:
                pass
            os.kill(os.getpid(), signal.SIGTERM)

    # -- recording ------------------------------------------------------
    @staticmethod
    def _counter_total(name: str) -> float:
        reg = telemetry.MetricsRegistry.get()
        m = reg._metrics.get(name)
        if m is None:
            return 0.0
        return float(sum(m._series.values()))

    def record(self, model, model_name: str, step: int, loss,
               span=None, grad_norm=None, **extra) -> None:
        """Append one step record.  ``loss``/``grad_norm`` may be
        device scalars (kept lazy); ``span`` is the
        ``telemetry.step_span`` whose ``duration`` just closed."""
        if not self.enabled:
            return
        if not self._installed:
            self.install()
        track_model(model, model_name)
        self._n_records += 1
        if self._n_records % self.hbm_sample == 1:
            try:
                self._last_hbm = update_hbm_gauges()
            except Exception:       # noqa: BLE001
                self._last_hbm = []
        rec = {
            "step": int(step),
            "t": time.time(),
            "model": model_name,
            "step_seconds": getattr(span, "duration", None),
            "loss": loss,
            "grad_norm": grad_norm,
            "retraces": self._counter_total("dl4j_retrace_total"),
            "collective_bytes": (
                self._counter_total("dl4j_collective_bytes_total") +
                self._counter_total(
                    "dl4j_dp_update_exchange_bytes_total")),
            "hbm_live_bytes": sum(d["bytes_in_use"]
                                  for d in self._last_hbm),
            "hbm_peak_bytes": sum(d["peak_bytes_in_use"]
                                  for d in self._last_hbm),
        }
        # heaviest layer of the last layerprof report, when one was
        # computed (sys.modules lookup: near-free, and no import edge
        # from diagnostics to layerprof)
        lp = sys.modules.get("deeplearning4j_tpu_torch.common.layerprof")
        if lp is not None:
            top = lp.top_layer()
            if top is not None:
                rec["top_layer"] = top
        if extra:
            rec.update(extra)
        with self._lock:
            self._ring.append(rec)
            while len(self._ring) > self.max_steps:
                self._ring.popleft()

    def records(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    # -- dumping --------------------------------------------------------
    @staticmethod
    def _materialize(v):
        if v is None:
            return None
        try:
            return float(v)
        except Exception as e:      # noqa: BLE001 — a dead buffer must
            return f"<unreadable: {e!r}>"   # not lose the record

    def dump(self, reason: str, event: Optional[dict] = None
             ) -> Optional[str]:
        """Write the ring as JSONL plus a chrome trace of the span
        buffer; returns the JSONL path.  One dump per reason per
        process (a crashing step must not stampede artifacts)."""
        if not self.enabled:
            return None
        with self._lock:
            if reason in self._dumped_reasons:
                return None
            self._dumped_reasons.add(reason)
            ring = list(self._ring)
        base = os.path.join(self.dir,
                            f"flightrec_{os.getpid()}_{reason}")
        path = base + ".jsonl"
        try:
            os.makedirs(self.dir, exist_ok=True)
            with open(path, "w") as f:
                f.write(json.dumps({
                    "record": "meta",
                    "schema_version": SCHEMA_VERSION,
                    "reason": reason,
                    "time": time.time(),
                    "pid": os.getpid(),
                    "n_steps": len(ring),
                    "ring_capacity": self.max_steps,
                    "event": event,
                }) + "\n")
                for rec in ring:
                    out = dict(rec)
                    out["loss"] = self._materialize(rec["loss"])
                    out["grad_norm"] = self._materialize(
                        rec["grad_norm"])
                    f.write(json.dumps(out) + "\n")
            trace = telemetry.export_chrome_trace(base + ".trace.json")
        except Exception as e:      # noqa: BLE001 — dumping is best-
            log.warning("flight recorder dump failed: %r", e)
            return None
        telemetry.counter(
            "dl4j_flightrec_dumps_total",
            "flight-recorder dumps, by trigger reason").inc(
                reason=reason)
        log.warning("flight recorder: dumped %d step records to %s "
                    "(+ %s) reason=%s", len(ring), path, trace, reason)
        self._prune()
        return path

    def _prune(self) -> None:
        """Bounded retention: keep the newest ``keep`` dump pairs in
        the dump directory, delete older ones (a week of preemptions
        must not fill the disk with black boxes)."""
        try:
            dumps = sorted(
                (p for p in os.listdir(self.dir)
                 if p.startswith("flightrec_")
                 and p.endswith(".jsonl")),
                key=lambda p: os.path.getmtime(
                    os.path.join(self.dir, p)))
        except OSError:
            return
        for p in dumps[:-self.keep]:
            for victim in (p, p[:-len(".jsonl")] + ".trace.json"):
                try:
                    os.remove(os.path.join(self.dir, victim))
                except OSError:
                    pass


# ----------------------------------------------------------------------
# the calls the fit funnels make per step
def _close_breakdown(model_name: str, step: int, span,
                     extra: dict) -> None:
    """Close the scaling-observatory breakdown for this step and embed
    its phase decomposition into the flight-recorder record."""
    try:
        bd = stepstats.close_step(model_name, step, span)
    except Exception as e:  # noqa: BLE001 — observability must never
        log.warning("stepstats close failed: %r", e)
        return
    if bd is not None:
        extra.setdefault("phases", bd["phases"])


def record_step(model, model_name: str, step: int, loss, span=None,
                grad_norm=None, **extra) -> None:
    """Flight-recorder append only — for funnels that already ran
    :func:`check_numerics` mid-step (the accumulation path checks a
    micro-batch's gradients before they join the window's sum)."""
    _close_breakdown(model_name, step, span, extra)
    rec = FlightRecorder.get()
    if rec.enabled:
        rec.record(model, model_name, step, loss, span,
                   grad_norm=grad_norm, **extra)


def after_step(model, model_name: str, step: int, loss, span=None,
               grad_norm=None, grads=None, params=None,
               **extra) -> None:
    """Record the step into the flight recorder, then run the numerics
    watchdog (which may raise :class:`NumericsEvent`).  Near-free when
    both gates are off: two attribute checks."""
    _close_breakdown(model_name, step, span, extra)
    rec = FlightRecorder.get()
    if rec.enabled:
        rec.record(model, model_name, step, loss, span,
                   grad_norm=grad_norm, **extra)
    check_numerics(model, model_name, step, loss, grad_norm=grad_norm,
                   grads=grads, params=params, recorded=rec.enabled)


def watchdog_enabled() -> bool:
    return Environment.get().numerics_watchdog
