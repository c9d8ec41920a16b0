"""Threshold gradient encoding (compression) with error feedback.

Counterpart of ``deeplearning4j_tpu/parallel/encoding.py`` (reference:
``org.deeplearning4j.optimize.solvers.accumulation.encoding.*``):
``EncodingHandler`` quantizes each gradient element to ``sign(g)·τ``
where ``|g| >= τ``, keeps the remainder as a local *residual* added back
before the next encode, and a ``ThresholdAlgorithm`` adapts τ (Fixed /
Adaptive / TargetSparsity); ``ResidualClippingPostProcessor`` clips
stale residual.

The codecs are the engine of the encoded update exchange
(``parallel/zero.py``, ``UpdateExchange.ENCODED``): on each replica's
slice of the per-dtype flat gradient, with the error-feedback residual
carried in updater state under ``learning.updaters.ENCODED_KEY``;
``EncodingSpec`` is the builder-facing configuration
(``.encoding(...)`` on ``ParallelWrapper`` / ``SharedTrainingMaster``).
The host-side ``EncodingHandler`` remains as the standalone transform.

Reductions span the whole flat. The JAX package encodes inside one
global-view program, where ``max|c|`` (int8's scale), ``mean|c|``
(1-bit's) and the transmitted fraction are taken over every replica's
slice, padding included. A replica here holds only its slice, so with a
``replica`` the codecs reduce across the mesh: the max through an
all-gather of one scalar, the sums through an all-reduce. τ and the
scales are then the same on every replica.

Numerics follow the JAX program's: a 16-bit flat is compared with an f32
τ in f32 (``jnp`` promotes bf16 against f32 arrays; PyTorch would not
promote against a 0-dim tensor), and every division by a constant
divides by a tensor on the operand's device (PyTorch's CUDA division by
a host scalar multiplies by its reciprocal, which can differ in the last
bit from the CPU's division). A Python-float τ (the host handler) keeps
``jnp``'s weak-typed scalar rules.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch

from deeplearning4j_tpu_torch.learning.updaters import tree_leaves, tree_map

#: wire codecs the encoded rung understands: the reference's sign·τ
#: sparse stream, and int8 / 1-bit quantization
SCHEMES = ("threshold", "int8", "1bit")

_F32_TINY = torch.finfo(torch.float32).tiny


def _div(t, s: float):
    """``t / s``: by a tensor of ``s`` on ``t``'s device for a tensor
    (a true division on the card too), Python's for a number."""
    if isinstance(t, torch.Tensor):
        return t / torch.full_like(t, s)
    return t / s


def _select(cond, a, b):
    """``a`` where ``cond``, else ``b``: ``torch.where`` for a tensor
    condition, a branch for a Python one."""
    if isinstance(cond, torch.Tensor):
        return torch.where(cond, a, b)
    return a if cond else b


def encode_threshold(g: torch.Tensor, tau) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """Quantize ``g`` to {-τ, 0, +τ} elementwise (the reference's
    native ``encodeThreshold`` op); returns ``(quantized, residual)``.
    A tensor τ promotes ``g`` as ``jnp`` does (bf16 against f32 compares
    in f32)."""
    x = g
    if isinstance(tau, torch.Tensor):
        x = g.to(torch.promote_types(g.dtype, tau.dtype))
    q = torch.where(x.abs() >= tau, torch.sign(x) * tau,
                    torch.zeros((), dtype=x.dtype, device=x.device))
    q = q.to(g.dtype)
    return q, g - q


def decode_threshold(q: torch.Tensor) -> torch.Tensor:
    """Identity in the dense representation (the reference's
    ``decodeThreshold`` turns the sparse int stream back into a dense
    array)."""
    return q


def _sum_over(t: torch.Tensor, replica) -> torch.Tensor:
    if replica is None:
        return t
    return replica.all_reduce_sum(t.reshape(1))[0]


def sparsity(q: torch.Tensor, replica=None) -> torch.Tensor:
    """Fraction of non-zero (transmitted) elements, f32; with a
    ``replica``, of the whole flat whose slice ``q`` is."""
    count = _sum_over((q != 0).sum(), replica).to(torch.float32)
    n = q.numel() * (replica.size if replica is not None else 1)
    return _div(count, float(n))


def encode_int8(c: torch.Tensor, replica=None) -> torch.Tensor:
    """Symmetric int8 quantization: round to 127 levels of ``max|c|``
    (over the whole flat, with a ``replica``), return the decoded value.
    The scale rides the wire as one f32 beside the int8 payload."""
    m = c.abs().max()
    if replica is not None:
        m = replica.all_gather(m.reshape(1)).max()
    scale = _div(torch.clamp_min(m.to(torch.float32), _F32_TINY), 127.0)
    q = torch.clamp(torch.round(c.to(torch.float32) / scale), -127.0, 127.0)
    return (q * scale).to(c.dtype)


def encode_1bit(c: torch.Tensor, replica=None) -> torch.Tensor:
    """1-bit sign quantization with the scale that minimizes L2 error
    for a sign codebook (``mean|c|``, over the whole flat with a
    ``replica``); the decoded value is ``sign(c)·mean|c|``."""
    total = _sum_over(c.abs().to(torch.float32).sum(), replica)
    n = c.numel() * (replica.size if replica is not None else 1)
    scale = _div(total, float(n))
    return (torch.sign(c).to(torch.float32) * scale).to(c.dtype)


def encode_flat(c: torch.Tensor, tau, scheme: str, replica=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encode one residual-corrected flat (a replica's slice of it, with
    a ``replica``): returns ``(decoded, transmitted_fraction)``. The
    residual is ``c - decoded`` in every scheme (error feedback)."""
    if scheme == "threshold":
        q, _ = encode_threshold(c, tau)
        return q, sparsity(q, replica)
    if scheme == "int8":
        return encode_int8(c, replica), torch.ones(
            (), dtype=torch.float32, device=c.device)
    if scheme == "1bit":
        return encode_1bit(c, replica), torch.ones(
            (), dtype=torch.float32, device=c.device)
    raise ValueError(f"unknown encoding scheme {scheme!r}; "
                     f"expected one of {SCHEMES}")


def encoded_payload_bytes(n_elems: int, scheme: str,
                          sparsity_frac: float = 1.0) -> int:
    """Bytes one replica puts on the wire for an ``n_elems`` gradient
    payload under ``scheme`` (the codec's serialized size, not the ring
    multiple — callers apply ``2(N-1)/N``):

    - ``threshold``: the reference's sparse int stream — one int32 index
      per transmitted element (sign folded into the index), value
      implicit ±τ, plus the τ scalar;
    - ``int8``: one byte per element plus the f32 scale;
    - ``1bit``: one bit per element plus the f32 scale.
    """
    if scheme == "threshold":
        return int(math.ceil(max(0.0, min(1.0, sparsity_frac))
                             * n_elems)) * 4 + 4
    if scheme == "int8":
        return int(n_elems) + 4
    if scheme == "1bit":
        return (int(n_elems) + 7) // 8 + 4
    raise ValueError(f"unknown encoding scheme {scheme!r}; "
                     f"expected one of {SCHEMES}")


class ThresholdAlgorithm:
    """τ policy: the next τ given the last step's transmitted fraction
    (reference: encoding.threshold.ThresholdAlgorithm). ``next_tau``
    takes Python numbers (host arithmetic, as the JAX package's host
    variant) or tensors (f32 on their device, as its traced variant)."""

    def initial(self) -> float:
        raise NotImplementedError

    def next_tau(self, tau, last_sparsity):
        raise NotImplementedError


@dataclass
class FixedThresholdAlgorithm(ThresholdAlgorithm):
    """Reference: FixedThresholdAlgorithm — constant τ."""
    threshold: float = 1e-3

    def initial(self) -> float:
        return self.threshold

    def next_tau(self, tau, last_sparsity):
        return tau


@dataclass
class AdaptiveThresholdAlgorithm(ThresholdAlgorithm):
    """Reference: AdaptiveThresholdAlgorithm — keep the transmitted
    fraction inside [min_target, max_target] by scaling τ by
    ``decay_rate`` steps."""
    initial_threshold: float = 1e-3
    min_target: float = 1e-4
    max_target: float = 1e-2
    decay_rate: float = 1.02

    def initial(self) -> float:
        return self.initial_threshold

    def next_tau(self, tau, last_sparsity):
        # sending too much -> raise; too little -> lower
        return _select(last_sparsity > self.max_target,
                       tau * self.decay_rate,
                       _select(last_sparsity < self.min_target,
                               _div(tau, self.decay_rate), tau))


@dataclass
class TargetSparsityThresholdAlgorithm(ThresholdAlgorithm):
    """Reference: TargetSparsityThresholdAlgorithm — steer toward one
    target transmitted fraction."""
    initial_threshold: float = 1e-3
    target: float = 1e-3
    decay_rate: float = 1.05

    def initial(self) -> float:
        return self.initial_threshold

    def next_tau(self, tau, last_sparsity):
        return _select(last_sparsity > self.target, tau * self.decay_rate,
                       _select(last_sparsity < self.target,
                               _div(tau, self.decay_rate), tau))


@dataclass
class ResidualClippingPostProcessor:
    """Reference: encoding.residual.ResidualClippingPostProcessor —
    every ``frequency`` steps, clip residuals to ±max_multiple·τ so
    stale residual cannot blow up. ``step`` and ``tau`` may be tensors
    (the clip then applies through ``torch.where``)."""
    max_multiple: float = 5.0
    frequency: int = 5

    def apply(self, step, tau, residual):
        if self.frequency <= 0:
            return residual
        do = (step % self.frequency) == 0
        if not isinstance(do, torch.Tensor) and not do:
            return residual
        lim = self.max_multiple * tau

        def clip(r):
            if isinstance(lim, torch.Tensor):
                return _select(do, torch.clamp(r, -lim, lim).to(r.dtype), r)
            return torch.clamp(r, -lim, lim)
        return tree_map(clip, residual)


@dataclass(frozen=True)
class EncodingSpec:
    """Configuration of the encoded update-exchange rung — what
    ``ParallelWrapper.Builder.encoding(...)`` /
    ``SharedTrainingConfiguration`` hand to the step tail. The dynamic
    quantities (τ, residual, observed sparsity) live in updater state
    under ``learning.updaters.ENCODED_KEY``."""
    scheme: str = "threshold"
    algorithm: ThresholdAlgorithm = field(
        default_factory=AdaptiveThresholdAlgorithm)
    residual_post: ResidualClippingPostProcessor = field(
        default_factory=ResidualClippingPostProcessor)

    def __post_init__(self):
        if self.scheme not in SCHEMES:
            raise ValueError(f"unknown encoding scheme "
                             f"{self.scheme!r}; expected one of "
                             f"{SCHEMES}")

    def initial_tau(self) -> float:
        return float(self.algorithm.initial())

    def signature(self) -> tuple:
        """Hashable identity (the spec is eq-comparable, but its
        algorithm objects are not hashable)."""
        return (self.scheme,
                type(self.algorithm).__name__,
                tuple(sorted(vars(self.algorithm).items())),
                type(self.residual_post).__name__,
                tuple(sorted(vars(self.residual_post).items())))

    def planning_sparsity(self) -> float:
        """Expected transmitted fraction before any step has run — the
        analytic wire-bytes estimate the live gauge then refines."""
        if self.scheme != "threshold":
            return 1.0
        if isinstance(self.algorithm, AdaptiveThresholdAlgorithm):
            return self.algorithm.max_target
        if isinstance(self.algorithm, TargetSparsityThresholdAlgorithm):
            return self.algorithm.target
        return 1e-2


def resolve_encoding(encoding=None) -> EncodingSpec:
    """Normalize the builder-facing ``encoding=`` knob: ``None`` -> the
    default spec (its scheme from ``DL4J_TORCH_ENCODED_SCHEME``,
    ``threshold`` unset), a scheme string -> a spec with the default
    algorithm, an ``EncodingSpec`` passes through."""
    if encoding is None:
        return EncodingSpec(scheme=os.environ.get(
            "DL4J_TORCH_ENCODED_SCHEME", "threshold"))
    if isinstance(encoding, str):
        return EncodingSpec(scheme=encoding)
    if isinstance(encoding, EncodingSpec):
        return encoding
    raise TypeError("encoding= expects None, a scheme string "
                    f"{SCHEMES}, or an EncodingSpec; got "
                    f"{type(encoding).__name__}")


class EncodingHandler:
    """Stateful encode pipeline (reference:
    accumulation.encoding.EncodingHandler): residual-corrected threshold
    quantization with adaptive τ, on the host's numbers (τ a Python
    float).

    ``encode(grads)`` -> the quantized grads tree (nested dicts of
    tensors); residual and τ update internally. The quantized tree is
    what a compressed all-reduce would exchange; callers then apply it
    like a gradient."""

    def __init__(self, algorithm: Optional[ThresholdAlgorithm] = None,
                 residual_post: Optional[ResidualClippingPostProcessor]
                 = None):
        self.algorithm = algorithm or AdaptiveThresholdAlgorithm()
        self.residual_post = residual_post or ResidualClippingPostProcessor()
        self.tau = self.algorithm.initial()
        self.residual = None
        self.step = 0
        self.last_sparsity = 0.0

    def encode(self, grads):
        if self.residual is None:
            self.residual = tree_map(torch.zeros_like, grads)
        corrected = tree_map(lambda g, r: g + r, grads, self.residual)
        pairs = tree_map(lambda g: encode_threshold(g, self.tau),
                          corrected)
        quantized = tree_map(lambda g, p: p[0], corrected, pairs)
        self.residual = tree_map(lambda g, p: p[1], corrected, pairs)
        leaves = tree_leaves(quantized)
        if leaves:
            total = sum(q.numel() for q in leaves)
            # size-weighted mean of the leaves' sparsity (summed in f32,
            # as the JAX handler does): one host read for the whole tree
            frac = sum(sparsity(q) * q.numel() for q in leaves)
            self.last_sparsity = float(frac) / max(total, 1)
            from deeplearning4j_tpu_torch.common import telemetry
            telemetry.gauge(
                "dl4j_dp_encoding_sparsity",
                "fraction of gradient elements the encoder transmits "
                "(the encoded rung's wire density; drives the adaptive "
                "tau)").set(self.last_sparsity)
        self.tau = self.algorithm.next_tau(self.tau, self.last_sparsity)
        self.residual = self.residual_post.apply(self.step, self.tau,
                                                 self.residual)
        self.step += 1
        return quantized
