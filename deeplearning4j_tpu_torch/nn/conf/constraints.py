"""Weight constraints: post-update parameter projections.

Counterpart of the projection half of
``deeplearning4j_tpu/nn/conf/constraints.py``: ``MaxNormConstraint``,
``MinMaxNormConstraint``, ``UnitNormConstraint`` and
``NonNegativeConstraint``, and :func:`apply_constraints`, which the
update tail calls after the updater. Layers carry their constraints as
the JAX package's JSON maps (``{"@class": "MaxNormConstraint",
"max_norm": 2.0, "dims": null}``) or as these objects.

Norms are per output unit. The JAX package stores the output axis last
(dense ``[n_in, n_out]``, conv HWIO) and takes the norm over every
other axis; the port's conv kernels are OIHW, so their default axes are
(I, H, W), and an explicit ``dims`` given in HWIO terms is mapped onto
OIHW.
"""
from __future__ import annotations

import torch

_EPS = 1e-7
#: HWIO axis -> OIHW axis
_HWIO_TO_OIHW = {0: 2, 1: 3, 2: 1, 3: 0}


class LayerConstraint:
    """Base projection."""

    def __init__(self, dims=None):
        self.dims = tuple(dims) if dims is not None else None

    def apply(self, p: torch.Tensor, oihw: bool = False) -> torch.Tensor:
        raise NotImplementedError

    def _norm(self, p: torch.Tensor, oihw: bool) -> torch.Tensor:
        dims = self.dims
        if dims is None:
            dims = ((1, 2, 3) if oihw else
                    tuple(range(p.dim() - 1)) if p.dim() > 1 else (0,))
        elif oihw:
            dims = tuple(_HWIO_TO_OIHW[d % 4] for d in dims)
        return torch.sqrt(torch.sum(torch.square(p.float()), dim=dims,
                                    keepdim=True))

    def to_map(self) -> dict:
        return {"@class": type(self).__name__, **self.__dict__}

    @staticmethod
    def from_map(d: dict) -> "LayerConstraint":
        d = dict(d)
        return CONSTRAINT_REGISTRY[d.pop("@class")](**d)


class MaxNormConstraint(LayerConstraint):
    """Rescale any unit whose norm exceeds ``max_norm`` down to it."""

    def __init__(self, max_norm: float = 2.0, dims=None):
        self.max_norm = float(max_norm)
        super().__init__(dims)

    def apply(self, p, oihw=False):
        n = self._norm(p, oihw)
        return p * (torch.clamp(n, max=self.max_norm) / (n + _EPS)).to(
            p.dtype)


class MinMaxNormConstraint(LayerConstraint):
    """Move unit norms a fraction ``rate`` of the way into
    ``[min_norm, max_norm]``."""

    def __init__(self, min_norm: float = 0.0, max_norm: float = 2.0,
                 rate: float = 1.0, dims=None):
        self.min_norm = float(min_norm)
        self.max_norm = float(max_norm)
        self.rate = float(rate)
        super().__init__(dims)

    def apply(self, p, oihw=False):
        n = self._norm(p, oihw)
        target = torch.clamp(n, self.min_norm, self.max_norm)
        scale = self.rate * target / (n + _EPS) + (1.0 - self.rate)
        return p * scale.to(p.dtype)


class UnitNormConstraint(LayerConstraint):
    """Project every unit onto the unit sphere."""

    def apply(self, p, oihw=False):
        return p / (self._norm(p, oihw) + _EPS).to(p.dtype)


class NonNegativeConstraint(LayerConstraint):
    """Clamp parameters at zero."""

    def __init__(self):
        super().__init__(None)
        del self.dims

    def apply(self, p, oihw=False):
        return torch.clamp(p, min=0)


CONSTRAINT_REGISTRY = {c.__name__: c for c in (
    MaxNormConstraint, MinMaxNormConstraint, UnitNormConstraint,
    NonNegativeConstraint)}


def _constraints(v):
    if not v:
        return ()
    return [c if isinstance(c, LayerConstraint)
            else LayerConstraint.from_map(c) for c in v]


def apply_constraints(layer, params: dict) -> dict:
    """Project a layer's freshly updated ``{name: tensor}`` through its
    constraints (``constrain_weights`` on ``W``/``RW`` and every tensor
    of rank >= 2, ``constrain_bias`` on ``b``, ``constrain_all`` on
    every tensor, ``constrain_params`` by name); no-op without any."""
    cw = _constraints(layer.constrain_weights)
    cb = _constraints(layer.constrain_bias)
    ca = _constraints(layer.constrain_all)
    cp = {k: _constraints(v)
          for k, v in (layer.constrain_params or {}).items()}
    if not (cw or cb or ca or cp):
        return params
    from deeplearning4j_tpu_torch.nn.conf.layers import ConvolutionLayer
    conv = isinstance(layer, ConvolutionLayer)
    out = {}
    for name, p in params.items():
        oihw = conv and name == "W"
        chain = []
        if name in ("W", "RW") or p.dim() >= 2:
            chain += cw
        if name == "b":
            chain += cb
        chain += ca
        chain += cp.get(name, ())
        for c in chain:
            p = c.apply(p, oihw)
        out[name] = p
    return out
