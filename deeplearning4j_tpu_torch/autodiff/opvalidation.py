"""Op validation: declarative per-op cases that check an op's forward
output and its autograd gradient against central differences, with
coverage accounting over the registered ops.

Counterpart of ``deeplearning4j_tpu/autodiff/opvalidation.py``
(reference: ``org.nd4j.autodiff.opvalidation.OpValidation``). Numeric
gradients run in float64: the case's floating inputs are promoted, so a
small step measures the op, not float32 rounding.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Set

import numpy as np
import torch

from deeplearning4j_tpu_torch.autodiff.registry import OP_REGISTRY, get_op

#: ops validated so far (coverage accounting)
_VALIDATED: Set[str] = set()


@dataclass
class TestCase:
    """One op validation case (reference: OpValidation TestCase)."""
    __test__ = False              # not a pytest class

    op: str
    inputs: Sequence[np.ndarray]
    attrs: Optional[dict] = None
    expected: Optional[Sequence[np.ndarray]] = None
    #: reference fn computing expected outputs from inputs (numpy)
    expected_fn: Optional[Callable] = None
    gradient_check: bool = True
    #: which inputs get gradient-checked (default: all float inputs)
    grad_inputs: Optional[Sequence[int]] = None
    fwd_tol: float = 1e-5
    grad_tol: float = 1e-4
    epsilon: float = 1e-6
    max_entries: int = 8
    seed: int = 0


def _outputs(out) -> list:
    return list(out) if isinstance(out, (list, tuple)) else [out]


def validate(tc: TestCase) -> None:
    """Run one case; raises AssertionError with op context on any
    mismatch. Records the op as covered."""
    impl = get_op(tc.op)
    attrs = tc.attrs or {}
    ins = [torch.as_tensor(np.asarray(a)) for a in tc.inputs]
    outs = _outputs(impl(list(ins), attrs))
    expected = tc.expected
    if expected is None and tc.expected_fn is not None:
        expected = _outputs(tc.expected_fn(*[np.asarray(a)
                                             for a in tc.inputs]))
    if expected is not None:
        assert len(expected) == len(outs), \
            f"{tc.op}: {len(outs)} outputs, expected {len(expected)}"
        for i, (got, want) in enumerate(zip(outs, expected)):
            np.testing.assert_allclose(
                got.detach().double().numpy(),
                np.asarray(want, np.float64),
                atol=tc.fwd_tol, rtol=tc.fwd_tol,
                err_msg=f"{tc.op}: forward output {i} mismatch")
    if tc.gradient_check:
        _check_grads(tc, impl, attrs, ins)
    _VALIDATED.add(tc.op)


def _check_grads(tc: TestCase, impl, attrs, ins):
    grad_idx = tc.grad_inputs
    if grad_idx is None:
        grad_idx = [i for i, a in enumerate(ins) if a.is_floating_point()]
    if not grad_idx:
        return
    ins = [a.double() if a.is_floating_point() else a for a in ins]

    def scalar_loss(*wrt):
        full = list(ins)
        for j, i in enumerate(grad_idx):
            full[i] = wrt[j]
        return sum((o * o).sum() for o in _outputs(impl(full, attrs))
                   if o.is_floating_point())

    wrt = [ins[i].clone().requires_grad_(True) for i in grad_idx]
    loss = scalar_loss(*wrt)
    if isinstance(loss, torch.Tensor) and loss.requires_grad:
        analytic = torch.autograd.grad(loss, wrt, allow_unused=True)
    else:                         # outputs independent of the inputs
        analytic = [None] * len(wrt)
    rng = np.random.RandomState(tc.seed)
    for j, (a, g) in enumerate(zip(wrt, analytic)):
        a64 = a.detach()
        g64 = (g if g is not None else torch.zeros_like(a64)).reshape(-1)
        n = a64.numel()
        idxs = (range(n) if n <= tc.max_entries else
                rng.choice(n, tc.max_entries, replace=False))
        for fi in idxs:
            d = torch.zeros(n, dtype=torch.float64)
            d[fi] = tc.epsilon
            d = d.reshape(a64.shape)

            def at(off):
                pert = [a64 + off if k == j else w.detach()
                        for k, w in enumerate(wrt)]
                return float(scalar_loss(*pert))

            numeric = (at(d) - at(-d)) / (2 * tc.epsilon)
            ana = float(g64[fi])
            err = abs(numeric - ana)
            denom = max(abs(numeric), abs(ana))
            assert err <= 1e-6 or (denom > 0
                                   and err / denom <= tc.grad_tol), (
                f"{tc.op}: grad mismatch input {grad_idx[j]} "
                f"idx {fi}: analytic {ana:.9g} numeric {numeric:.9g}")


# -- coverage accounting ----------------------------------------------------
def validated_ops() -> Set[str]:
    return set(_VALIDATED)


def coverage_report(exclusions: Optional[Set[str]] = None) -> Dict:
    """Which registered ops have at least one validation case."""
    exclusions = exclusions or set()
    all_ops = set(OP_REGISTRY)
    covered = _VALIDATED & all_ops
    missing = all_ops - covered - exclusions
    return {"total": len(all_ops), "covered": len(covered),
            "missing": sorted(missing),
            "fraction": len(covered) / max(1, len(all_ops))}
