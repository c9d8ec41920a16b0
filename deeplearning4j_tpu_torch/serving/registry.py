"""Versioned model registry with warmed, hot-swappable serving state.

Counterpart of ``deeplearning4j_tpu/serving/registry.py``: a named
catalog of models, each with numbered versions, exactly one live per
name. ``register`` loads (a ComputationGraph, or a ``*.zip`` path
restored onto the registry's device), wraps the model in a
:class:`~deeplearning4j_tpu_torch.serving.batcher.ServingBatcher`,
warms every bucket when ``warmup_shape`` is given, then flips the live
pointer under the lock and drains the old version: swaps drop no
request. ``retraces_since_warmup`` counts padded shapes served after
warmup that no warm bucket covered; 0 in steady state.

A model with the ``prefill`` / ``decode_step`` contract (``DecoderLM``)
registered with ``generate={...}`` gets a decode engine whose prefill
and decode buckets all run once before the version goes live, so the
zero-retrace proof covers ``:generate`` too. A ``SameDiff`` graph (in
memory, or a SameDiff zip) serves through :class:`_SameDiffAdapter`:
one placeholder in, one value out, named by ``input_name`` /
``output_name`` or inferred. Any other model without a graph
``_forward`` serves through its ``output``. A version's flush trigger
is ``flush_policy`` (``"continuous"`` or ``"window"`` with
``batch_window_ms``), per registry or per ``register`` call.

Not ported yet: the residency modes and ``param_dtype`` (Queue A item
12), and the ONNX and Keras adapters, which wait for their importers
(item 14).
"""
from __future__ import annotations

import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from deeplearning4j_tpu_torch.common import telemetry
from deeplearning4j_tpu_torch.common.compilecache import RetraceGuard
from deeplearning4j_tpu_torch.serving.batcher import ServingBatcher


class ModelStatus:
    LOADING = "LOADING"
    WARMING = "WARMING"
    READY = "READY"
    RETIRED = "RETIRED"


def load_model(path, device: Union[None, str, torch.device] = None):
    """Restore a serving artifact: a ModelSerializer ``*.zip``
    (ComputationGraph, MultiLayerNetwork or SameDiff)."""
    p = str(path)
    if p.endswith((".h5", ".keras", ".onnx")):
        raise NotImplementedError(
            f"cannot serve {p!r}: Keras and ONNX import are not ported "
            f"yet (ROADMAP.md Queue A item 14)")
    if not p.endswith(".zip"):
        raise NotImplementedError(
            f"cannot serve {p!r}: the port loads ModelSerializer zips")
    from deeplearning4j_tpu_torch.utils.serializer import ModelSerializer
    return ModelSerializer.restore_model(p, device)


class _SameDiffAdapter:
    """Serve a ``SameDiff`` graph through the batcher's generic surface,
    ``output(batch) -> tensor``. The placeholder and the output are named
    or inferred: the graph's one placeholder, and the one op output that
    no op consumes."""

    def __init__(self, sd, input_name: Optional[str] = None,
                 output_name: Optional[str] = None):
        from deeplearning4j_tpu_torch.autodiff.samediff import VariableType
        self.sd = sd
        if input_name is None:
            phs = [v.name for v in sd.vars.values()
                   if v.var_type == VariableType.PLACEHOLDER]
            if len(phs) != 1:
                raise ValueError(f"cannot infer the input placeholder "
                                 f"from {phs!r}; pass input_name=")
            input_name = phs[0]
        if output_name is None:
            consumed = {n for op in sd.ops for n in op.inputs}
            outs = [n for op in sd.ops for n in op.outputs
                    if n not in consumed]
            if len(outs) != 1:
                raise ValueError(f"cannot infer the output from terminal "
                                 f"values {outs!r}; pass output_name=")
            output_name = outs[0]
        self.input_name = input_name
        self.output_name = output_name

    @property
    def device(self):
        return self.sd.device

    def output(self, x):
        return self.sd.output({self.input_name: x},
                              [self.output_name])[self.output_name]


class ModelVersion:
    """One (model, batcher, guard) serving unit."""

    def __init__(self, name: str, version: int, model,
                 batcher: ServingBatcher, source: str,
                 latency_slo_ms: Optional[float] = None):
        self.name = name
        self.version = version
        self.model = model
        self.batcher = batcher
        self.source = source
        self.latency_slo_ms = latency_slo_ms
        self.status = ModelStatus.LOADING
        self.created = time.time()
        self.warm_signatures = 0      # guard count frozen at warmup end

    @property
    def guard(self) -> RetraceGuard:
        return self.batcher.guard

    def retraces_since_warmup(self) -> int:
        return self.guard.n_signatures - self.warm_signatures

    def describe(self) -> dict:
        return {
            "name": self.name,
            "version": self.version,
            "status": self.status,
            "source": self.source,
            "device": str(getattr(self.model, "device", "")),
            "warm_buckets": list(self.batcher.buckets),
            "signatures": self.guard.n_signatures,
            "retraces_since_warmup": self.retraces_since_warmup(),
            "mode": self.batcher.mode,
            "flush_policy": self.batcher.flush_policy,
            "generative": self.batcher.is_generative,
            "latency_slo_ms": self.latency_slo_ms,
            "created": self.created,
        }


class ModelRegistry:
    """Named, versioned models with an atomic live pointer per name.
    ``device`` is where zip artifacts are restored (``None``: the
    card); in-memory models serve on their own device."""

    def __init__(self, device: Union[None, str, torch.device] = None, *,
                 default_buckets: Sequence[int] = (8, 32),
                 batch_window_ms: float = 2.0,
                 queue_limit: int = 256,
                 flush_policy: str = "continuous"):
        self.device = device
        self.default_buckets = tuple(default_buckets)
        self.batch_window_ms = batch_window_ms
        self.queue_limit = queue_limit
        self.flush_policy = flush_policy
        self._lock = threading.Lock()
        self._current: Dict[str, ModelVersion] = {}
        self._versions: Dict[str, List[ModelVersion]] = {}

    def register(self, name: str, model, *,
                 warmup_shape: Optional[Sequence[int]] = None,
                 warmup_dtype=None,
                 buckets: Optional[Sequence[int]] = None,
                 batch_window_ms: Optional[float] = None,
                 flush_policy: Optional[str] = None,
                 latency_slo_ms: Optional[float] = None,
                 input_name: Optional[str] = None,
                 output_name: Optional[str] = None,
                 generate: Optional[dict] = None) -> ModelVersion:
        """Register (or hot-swap) the live version of ``name``.
        ``warmup_shape`` (one request's shape without the batch dim)
        runs every bucket once before the version goes live.
        ``flush_policy`` and ``batch_window_ms`` default to the
        registry's. ``latency_slo_ms`` arms the SLO-adaptive admission
        budget and the SLO tracker for the model. ``input_name`` /
        ``output_name`` pick a SameDiff graph's placeholder and output.
        ``generate`` configures the decode engine of a model with a
        prefill/decode_step surface (see ``ServingBatcher``); its buckets
        run once before the version goes live."""
        if isinstance(model, (str, Path)):
            source = str(model)
            model = load_model(model, self.device)
        else:
            source = f"memory:{type(model).__name__}"
        from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff
        if isinstance(model, SameDiff):
            model = _SameDiffAdapter(model, input_name, output_name)
        with self._lock:
            version_no = len(self._versions.get(name, ())) + 1
        guard = RetraceGuard(f"serving:{name}:v{version_no}")
        batcher = ServingBatcher(
            model, buckets or self.default_buckets, name=name,
            queue_limit=self.queue_limit, guard=guard,
            flush_policy=(flush_policy if flush_policy is not None
                          else self.flush_policy),
            batch_window_ms=(batch_window_ms if batch_window_ms is not None
                             else self.batch_window_ms),
            generate=generate)
        ver = ModelVersion(name, version_no, model, batcher, source,
                           latency_slo_ms=latency_slo_ms)
        if warmup_shape is not None:
            ver.status = ModelStatus.WARMING
            secs = batcher.warmup(warmup_shape, warmup_dtype or np.float32)
            telemetry.histogram(
                "dl4j_serving_warmup_total_seconds",
                "whole-version warmup wall time: every bucket run once "
                "(seconds)").observe(secs, model=name)
        if generate is not None and batcher.is_generative:
            ver.status = ModelStatus.WARMING
            secs = batcher.warmup_generate()
            telemetry.histogram(
                "dl4j_serving_warmup_total_seconds",
                "whole-version warmup wall time: every bucket run once "
                "(seconds)").observe(secs, model=name)
        ver.warm_signatures = guard.n_signatures
        ver.status = ModelStatus.READY
        with self._lock:
            old = self._current.get(name)
            self._current[name] = ver
            self._versions.setdefault(name, []).append(ver)
        if old is not None:
            telemetry.counter(
                "dl4j_serving_hot_swaps_total",
                "live-version replacements per model").inc(model=name)
            old.status = ModelStatus.RETIRED
            old.batcher.shutdown()
        return ver

    def model(self, name: str) -> ModelVersion:
        """The live version of ``name`` (KeyError when unknown)."""
        with self._lock:
            return self._current[name]

    def names(self) -> List[str]:
        """The registered names, sorted."""
        with self._lock:
            return sorted(self._current)

    def describe(self) -> List[dict]:
        """Every name's versions (GET /v1/models)."""
        with self._lock:
            items = {n: list(vs) for n, vs in self._versions.items()}
            current = dict(self._current)
        return [{"name": name,
                 "live_version": (current[name].version
                                  if name in current else None),
                 "versions": [v.describe() for v in items[name]]}
                for name in sorted(items)]

    def ready(self) -> bool:
        with self._lock:
            return any(v.status == ModelStatus.READY
                       for v in self._current.values())

    def retraces_since_warmup(self, name: str) -> int:
        return self.model(name).retraces_since_warmup()

    def shutdown(self):
        """Drain and stop every live batcher."""
        with self._lock:
            vers = list(self._current.values())
        for v in vers:
            v.batcher.shutdown()
            v.status = ModelStatus.RETIRED
