"""Runtime flags and the device rule.

Counterpart of ``deeplearning4j_tpu/common/environment.py``, cut to
what the port reads: the ``Environment.extra`` registry, where tests
and embedding applications flip kernel gates without touching
``os.environ``, and the few flags seeded from ``DL4J_TORCH_*``
environment variables.

Env vars read here: ``DL4J_TORCH_TELEMETRY`` (metrics and spans,
default on), ``DL4J_TORCH_RETRACE_WARN`` (warn once past this many
distinct served shapes, default 5), ``DL4J_TORCH_DEVICE_PREFETCH``
(``fit`` stages iterators through ``datasets/prefetch.py``, default
on), ``DL4J_TORCH_DEVICE_PREFETCH_DEPTH`` (batches staged ahead,
default 2), ``DL4J_TORCH_SHARDED_UPDATE`` (the ZeRO-1 update
exchange of ``parallel/zero.py``; ``0`` forces the dense tail, default
on), ``DL4J_TORCH_FSDP`` (the fsdp (ZeRO-3) exchange; ``0`` demotes an
fsdp request to ZeRO-1, default on) and ``DL4J_TORCH_ENCODED_UPDATE``
(the encoded exchange; ``0`` demotes an encoded request to ZeRO-1,
uncompressed, default on). Read live by their subsystems:
``DL4J_TORCH_FUSED_CONV`` (the conv-epilogue and training-BN forward
kernel gate), ``DL4J_TORCH_FUSED_BN_BWD`` (the BN backward kernel gate),
``DL4J_TORCH_FLASH_ATTENTION`` (the flash-attention kernel gate),
``DL4J_TORCH_PAGED_ATTENTION`` (the paged-decode kernel gate; all four
in ``ops/kernel_select.py``), ``DL4J_TORCH_GRAPHOPT`` (the GraphOptimizer
after a TF import, default on; ``autodiff/passes.py``),
``DL4J_TORCH_ENCODED_SCHEME`` (the encoded exchange's default codec,
``threshold``, ``int8`` or ``1bit``; ``parallel/encoding.py``),
``DL4J_TORCH_DATA_DIR`` (where ``datasets/mnist.py`` looks for the
IDX files), ``DL4J_TORCH_KV_DTYPE`` (the KV pool's
dtype, ``float32`` or ``bf16``; ``serving/batcher.py``) and
``DL4J_TORCH_HTTP_HOST`` (the serving bind interface, default
127.0.0.1). The serving observatory reads:
``DL4J_TORCH_TELEMETRY_MAX_EVENTS`` (the trace ring's size, default 200000;
``common/telemetry.py``), ``DL4J_TORCH_REQUEST_TRACE`` (per-request
trace contexts, default on, off whenever telemetry is;
``common/tracectx.py``), ``DL4J_TORCH_ACCESS_LOG`` and
``DL4J_TORCH_ACCESS_LOG_SAMPLE`` (the sampled JSONL access log's path,
unset: off, and the share of requests kept, default 1.0;
``common/httputil.py``), ``DL4J_TORCH_SLO_TARGET``,
``DL4J_TORCH_SLO_FAST_S`` and ``DL4J_TORCH_SLO_SLOW_S`` (the in-SLO
target, default 0.99, and the burn-rate windows, default 300 s and
3600 s; ``serving/slo.py``), and ``DL4J_TORCH_REQREC``,
``DL4J_TORCH_REQREC_CAPACITY``, ``DL4J_TORCH_REQREC_DIR``,
``DL4J_TORCH_REQREC_SHED_THRESHOLD``, ``DL4J_TORCH_REQREC_SHED_WINDOW_S``
and ``DL4J_TORCH_REQREC_STORM_COOLDOWN_S`` (the request flight
recorder: default on, 512 records, ``flightrec/``, 20 sheds within 5 s
make a storm, 60 s between storm dumps; ``serving/reqrec.py``).
The training observatory reads: ``DL4J_TORCH_NUMERICS_WATCHDOG``
(the non-finite check in the fit funnels, default off) and
``DL4J_TORCH_NUMERICS_SAMPLE`` (check every Nth step, default 1);
``DL4J_TORCH_FLIGHT_RECORDER`` (the per-step ring, default on),
``DL4J_TORCH_FLIGHT_RECORDER_STEPS`` (its capacity, default 256),
``DL4J_TORCH_FLIGHT_RECORDER_DIR`` (dumps, default ``flightrec``) and
``DL4J_TORCH_FLIGHT_RECORDER_KEEP`` (the newest dumps kept, default 8);
``DL4J_TORCH_HBM_SAMPLE_STEPS`` (device memory gauges refreshed every
Nth record, default 16; all ``common/diagnostics.py``);
``DL4J_TORCH_STEPSTATS`` (the per-step phase breakdown, default on),
``DL4J_TORCH_STEPSTATS_STEPS`` (its ring, default 1024),
``DL4J_TORCH_STRAGGLER_FACTOR`` and ``DL4J_TORCH_STRAGGLER_MIN_STEP``
(a straggler trips past factor x the step mean, default 2.0, above a
mean step of 1e-3 s; ``common/stepstats.py``);
``DL4J_TORCH_OBSERVATORY_PORT`` (the leader's step-stats aggregator,
default 9470; ``parallel/sharedtraining.py``); and
``DL4J_TORCH_LAYERPROF`` (the ``dl4j.<name>`` scopes, default on;
``Environment.extra["layerprof"]`` overrides it; ``common/layerprof.py``).

:func:`resolve_device` is the one place the port's entry points turn
``device=None`` into a device: the card, or an error that says how to
ask for the CPU. Nothing falls back to the CPU silently.
"""
from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from typing import Optional, Union

import torch


@dataclass
class _Env:
    telemetry: bool = True
    retrace_warn_threshold: int = 5
    device_prefetch: bool = True
    device_prefetch_depth: int = 2
    sharded_update: bool = True
    fsdp: bool = True
    encoded_update: bool = True
    numerics_watchdog: bool = False
    numerics_sample: int = 1
    flight_recorder: bool = True
    flight_recorder_steps: int = 256
    flight_recorder_dir: str = "flightrec"
    flight_recorder_keep: int = 8
    hbm_sample_steps: int = 16
    stepstats: bool = True
    straggler_factor: float = 2.0
    straggler_min_step: float = 1e-3
    observatory_port: int = 9470
    extra: dict = field(default_factory=dict)


class Environment:
    """Process-wide flags, seeded from the environment on first use."""

    _inst: Optional[_Env] = None
    _lock = threading.Lock()

    @classmethod
    def get(cls) -> _Env:
        inst = cls._inst
        if inst is not None:
            return inst
        with cls._lock:
            if cls._inst is None:
                def flag(name: str, default: str = "1") -> bool:
                    return os.environ.get(name, default) in (
                        "1", "true", "True", "yes")

                def num(name: str, default: str, kind=int):
                    return kind(os.environ.get(name, default))
                cls._inst = _Env(
                    telemetry=flag("DL4J_TORCH_TELEMETRY"),
                    retrace_warn_threshold=int(os.environ.get(
                        "DL4J_TORCH_RETRACE_WARN", "5")),
                    device_prefetch=flag("DL4J_TORCH_DEVICE_PREFETCH"),
                    device_prefetch_depth=int(os.environ.get(
                        "DL4J_TORCH_DEVICE_PREFETCH_DEPTH", "2")),
                    sharded_update=flag("DL4J_TORCH_SHARDED_UPDATE"),
                    fsdp=flag("DL4J_TORCH_FSDP"),
                    encoded_update=flag("DL4J_TORCH_ENCODED_UPDATE"),
                    numerics_watchdog=flag("DL4J_TORCH_NUMERICS_WATCHDOG",
                                           "0"),
                    numerics_sample=num("DL4J_TORCH_NUMERICS_SAMPLE", "1"),
                    flight_recorder=flag("DL4J_TORCH_FLIGHT_RECORDER"),
                    flight_recorder_steps=num(
                        "DL4J_TORCH_FLIGHT_RECORDER_STEPS", "256"),
                    flight_recorder_dir=os.environ.get(
                        "DL4J_TORCH_FLIGHT_RECORDER_DIR", "flightrec"),
                    flight_recorder_keep=num(
                        "DL4J_TORCH_FLIGHT_RECORDER_KEEP", "8"),
                    hbm_sample_steps=num("DL4J_TORCH_HBM_SAMPLE_STEPS",
                                         "16"),
                    stepstats=flag("DL4J_TORCH_STEPSTATS"),
                    straggler_factor=num("DL4J_TORCH_STRAGGLER_FACTOR",
                                         "2.0", float),
                    straggler_min_step=num("DL4J_TORCH_STRAGGLER_MIN_STEP",
                                           "1e-3", float),
                    observatory_port=num("DL4J_TORCH_OBSERVATORY_PORT",
                                         "9470"))
            return cls._inst

    @classmethod
    def reset(cls):
        with cls._lock:
            cls._inst = None


def resolve_device(device: Union[None, str, torch.device] = None
                   ) -> torch.device:
    """``None`` means the card. Raises when the card is asked for (by
    ``None`` or by name) and there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: deeplearning4j_tpu_torch runs "
            "on the card by default; pass device='cpu' to run on the CPU")
    return dev
