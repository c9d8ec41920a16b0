"""Kernel-selection ladder for the port's hand-written kernels.

Counterpart of ``deeplearning4j_tpu/ops/kernel_select.py`` with the
same three rungs, in the same order:

  1. **structural gate**: a site the kernel cannot express is demoted
     to the plain lowering whatever the environment says;
  2. **force / kill override**: the tri-state env var (``=1`` force,
     ``=0`` kill switch, unset auto), with ``Environment.extra`` taking
     precedence over the process environment;
  3. **auto**: supplied by the caller as ``(fused, reason)`` or a thunk
     returning one.

Every decision increments ``dl4j_kernel_select_total{kernel,decision}``
and is joined to the layer scope that made it
(``common/layerprof.note_selection``). PyTorch runs eagerly, so the port
decides at every call, and the counter and a scope's ``sites`` count
executed dispatches (the JAX package decides while tracing and counts
compiled programs).
"""
from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Callable, Optional, Tuple, Union

from deeplearning4j_tpu_torch.common import layerprof, telemetry
from deeplearning4j_tpu_torch.common.environment import Environment

log = logging.getLogger(__name__)

#: kernel family -> (Environment.extra key, env var) for the tri-state
#: force/kill override. The conv epilogue and the training-BN forward
#: (channel statistics + normalize) ride one gate, as in the JAX package:
#: the epilogue writes what the statistics pass reads.
GATES = {
    "conv_epilogue": ("fused_conv", "DL4J_TORCH_FUSED_CONV"),
    "bn_fwd": ("fused_conv", "DL4J_TORCH_FUSED_CONV"),
    "bn_bwd": ("fused_bn_bwd", "DL4J_TORCH_FUSED_BN_BWD"),
    "attention": ("flash_attention", "DL4J_TORCH_FLASH_ATTENTION"),
    "paged_attention": ("paged_attention", "DL4J_TORCH_PAGED_ATTENTION"),
}

DECISIONS = ("structural", "forced", "killed", "auto_fused", "auto_dense")

_select_total = telemetry.counter(
    "dl4j_kernel_select_total",
    "kernel-dispatch ladder decisions by kernel family and rung "
    "(structural / forced / killed / auto_fused / auto_dense)")


@dataclass(frozen=True)
class Selection:
    """One dispatch decision: which lowering a site gets and why."""

    kernel: str          #: kernel family (a GATES key)
    fused: bool          #: True = hand kernel, False = plain lowering
    decision: str        #: ladder rung that decided (counter label)
    reason: str          #: human-readable justification

    def __bool__(self) -> bool:
        return self.fused


def gate_override(kernel: str) -> Optional[bool]:
    """True (force on) / False (kill switch) / None (auto).
    ``Environment.extra[<key>]`` overrides the env var."""
    extra_key, env_var = GATES[kernel]
    flag = Environment.get().extra.get(extra_key)
    if flag is None:
        flag = os.environ.get(env_var)
    if flag is None or str(flag) == "":
        return None
    return str(flag) in ("1", "true", "True", "yes")


_UNSET = object()


def select(kernel: str, *,
           structural: Optional[str] = None,
           auto: Union[Tuple[bool, str],
                       Callable[[], Tuple[bool, str]]] = (False, "auto"),
           override=_UNSET,
           use_env_override: bool = True,
           record: bool = True) -> Selection:
    """Run the ladder for one dispatch site. ``override`` and
    ``use_env_override`` exist for tests; by default the live
    ``gate_override(kernel)`` is consulted."""
    env_var = GATES[kernel][1]
    if structural is not None:
        sel = Selection(kernel, False, "structural", structural)
    else:
        if override is _UNSET:
            override = gate_override(kernel) if use_env_override else None
        if override is False:
            sel = Selection(kernel, False, "killed",
                            f"{env_var}=0 kill switch")
        elif override is True:
            sel = Selection(kernel, True, "forced", f"{env_var}=1 forced")
        else:
            fused, reason = auto() if callable(auto) else auto
            sel = Selection(kernel, bool(fused),
                            "auto_fused" if fused else "auto_dense",
                            reason)
    if record:
        _select_total.inc(kernel=kernel, decision=sel.decision)
        layerprof.note_selection(sel)
        log.debug("kernel_select %s -> %s (%s: %s)", kernel,
                  "fused" if sel.fused else "dense", sel.decision,
                  sel.reason)
    return sel


def decisions(kernel: str) -> dict:
    """Counter readback: decision -> count."""
    return {d: _select_total.value(kernel=kernel, decision=d)
            for d in DECISIONS}
