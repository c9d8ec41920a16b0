"""Dropout variants and weight noise.

Counterpart of ``deeplearning4j_tpu/nn/conf/dropout.py``: a layer's
``dropout`` is a retain probability or one of ``Dropout``,
``GaussianDropout``, ``GaussianNoise``, ``AlphaDropout`` and
``SpatialDropout`` (the reference's IDropout family), applied to the
layer's input in training; ``WeightNoise`` (additive or multiplicative
gaussian noise, or DropConnect) perturbs a layer's parameters for each
training forward, and the gradients flow to the clean parameters.
Fields and JSON are the JAX package's.

Each variant is ``apply(x, rng)``: ``noise(x, rng)`` draws the random
tensor (a keep mask, or standard normal values) from an ``RngKey``
(``common/rng.py``) on ``x``'s device, and ``apply_noise(x, noise)`` is
the deterministic rest, so a test can inject the JAX package's mask or
noise and compare bits.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

from deeplearning4j_tpu_torch.common.rng import RngKey
from deeplearning4j_tpu_torch.parallel.mesh import current_replica


def _rows(shape, batch: bool, draw):
    """``draw(shape)``; for an activation (``batch``) in a data-parallel
    step, this replica's rows of the global batch's draw, so N replicas
    draw what one replica draws for the whole batch."""
    replica = current_replica() if batch else None
    if replica is None or replica.size == 1 or not len(shape):
        return draw(tuple(shape))
    b = int(shape[0])
    full = draw((b * replica.size, *shape[1:]))
    return full[replica.rank * b:(replica.rank + 1) * b]


def _keep_mask(shape, p: float, rng: RngKey, device,
               batch: bool = False) -> torch.Tensor:
    """Bernoulli(p) keep decisions: ``uniform < p``, as jax.random's
    bernoulli draws them."""
    return _rows(shape, batch, lambda s: torch.rand(
        s, generator=rng.generator(device), device=device) < p)


def _normal(shape, dtype, rng: RngKey, device,
            batch: bool = False) -> torch.Tensor:
    return _rows(shape, batch, lambda s: torch.randn(
        s, generator=rng.generator(device), dtype=dtype, device=device))


class IDropout:
    """Activation noise (reference: conf.dropout.IDropout)."""

    def noise(self, x: torch.Tensor, rng: RngKey) -> torch.Tensor:
        raise NotImplementedError

    def apply_noise(self, x: torch.Tensor,
                    noise: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def apply(self, x: torch.Tensor, rng: RngKey) -> torch.Tensor:
        return self.apply_noise(x, self.noise(x, rng))

    # -- serde ----------------------------------------------------------
    def to_map(self) -> dict:
        d = {"@class": type(self).__name__}
        d.update(self.__dict__)
        return d

    @staticmethod
    def from_map(d: dict) -> "IDropout":
        d = dict(d)
        return _REGISTRY[d.pop("@class")](**d)


@dataclass
class Dropout(IDropout):
    """Inverted dropout; ``p`` is the RETAIN probability."""

    p: float = 0.5

    def noise(self, x, rng):
        return _keep_mask(x.shape, self.p, rng, x.device, batch=True)

    def apply_noise(self, x, noise):
        return torch.where(noise, x / self.p, 0.0)


@dataclass
class GaussianDropout(IDropout):
    """Multiplicative gaussian noise N(1, rate/(1-rate))."""

    rate: float = 0.1

    def noise(self, x, rng):
        return _normal(x.shape, x.dtype, rng, x.device, batch=True)

    def apply_noise(self, x, noise):
        stddev = (self.rate / (1.0 - self.rate)) ** 0.5
        return x * (1.0 + stddev * noise)


@dataclass
class GaussianNoise(IDropout):
    """Additive gaussian noise N(0, stddev)."""

    stddev: float = 0.1

    def noise(self, x, rng):
        return _normal(x.shape, x.dtype, rng, x.device, batch=True)

    def apply_noise(self, x, noise):
        return x + self.stddev * noise


@dataclass
class AlphaDropout(IDropout):
    """SELU-preserving dropout (Klambauer et al.): dropped units take
    alpha', and an affine correction keeps the mean and variance at
    (0, 1). ``p`` is the retain probability."""

    p: float = 0.95

    _ALPHA = 1.6732632423543772
    _SCALE = 1.0507009873554805

    def noise(self, x, rng):
        return _keep_mask(x.shape, self.p, rng, x.device, batch=True)

    def apply_noise(self, x, noise):
        ap = -self._ALPHA * self._SCALE
        a = (self.p + ap * ap * self.p * (1 - self.p)) ** -0.5
        b = -a * ap * (1 - self.p)
        return a * torch.where(noise, x, ap) + b


@dataclass
class SpatialDropout(IDropout):
    """Drops whole channels: one keep decision per (example, channel),
    the channel the last axis (NHWC, ``[b, t, f]``). ``p`` is the
    retain probability."""

    p: float = 0.5

    def noise(self, x, rng):
        shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (x.shape[-1],)
        return _keep_mask(shape, self.p, rng, x.device, batch=True)

    def apply_noise(self, x, noise):
        return torch.where(noise, x / self.p, 0.0)


def _is_bias(name: str) -> bool:
    # a wrapper's parameters are flat "fwd/W"-style names
    return name.rsplit("/", 1)[-1] in ("b", "gamma", "beta")


@dataclass
class WeightNoise:
    """Parameter noise for each training forward (reference:
    conf.weightnoise.WeightNoise, or DropConnect with
    ``is_dropconnect``): additive N(0, stddev) or multiplicative
    N(1, stddev) gaussian noise, or DropConnect's zeroing with retain
    probability ``p``. Biases (``b``, ``gamma``, ``beta``) keep their
    values unless ``apply_to_bias``."""

    stddev: float = 0.05
    additive: bool = True
    apply_to_bias: bool = False
    is_dropconnect: bool = False
    p: float = 0.5              # DropConnect retain probability

    def noise(self, params: Dict[str, torch.Tensor], rng: RngKey
              ) -> Dict[str, torch.Tensor]:
        """A draw for every perturbed parameter, each from its own key
        (one ``split`` of ``rng`` per parameter, in order)."""
        out = {}
        for name, w in params.items():
            if not self.apply_to_bias and _is_bias(name):
                continue
            rng, sub = rng.split()
            out[name] = (_keep_mask(w.shape, self.p, sub, w.device)
                         if self.is_dropconnect
                         else _normal(w.shape, w.dtype, sub, w.device))
        return out

    def apply_noise(self, params: Dict[str, torch.Tensor],
                    noise: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        out = {}
        for name, w in params.items():
            n = noise.get(name)
            if n is None:
                out[name] = w
            elif self.is_dropconnect:
                out[name] = torch.where(n, w / self.p, 0.0)
            elif self.additive:
                out[name] = w + self.stddev * n
            else:
                out[name] = w * (1.0 + self.stddev * n)
        return out

    def apply(self, params: Dict[str, torch.Tensor], rng: RngKey
              ) -> Dict[str, torch.Tensor]:
        return self.apply_noise(params, self.noise(params, rng))

    def to_map(self) -> dict:
        d = {"@class": type(self).__name__}
        d.update(self.__dict__)
        return d

    @staticmethod
    def from_map(d: dict) -> "WeightNoise":
        d = dict(d)
        d.pop("@class", None)
        return WeightNoise(**d)


def dropout_from(v):
    """A layer's ``dropout`` field as an ``IDropout`` (a retain
    probability is ``Dropout(p)``), or None."""
    if v is None or isinstance(v, IDropout):
        return v
    return Dropout(float(v))


_REGISTRY = {c.__name__: c for c in
             (Dropout, GaussianDropout, GaussianNoise, AlphaDropout,
              SpatialDropout)}
