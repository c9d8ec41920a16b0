"""Loss functions.

Counterpart of ``deeplearning4j_tpu/lossfunctions/losses.py``: the same
``LossFunction`` enum and the math of all fourteen members, so
output-layer configurations parse, round-trip and train. Inputs are
``(labels, preds)``, ``[batch, ...]``; ``score_array`` is the
per-example (or per-example-per-timestep) loss, summed over the
features, and ``score`` its mean over the batch, or over the active
entries of a mask (``average=False``: the sum). MCXENT and its alias
NEGATIVELOGLIKELIHOOD take probabilities (``-Σ labels·log(clip(p,
1e-7, 1 − 1e-7))``); they and XENT also have a logits form
(``score_from_logits``) that an output layer selects when it owns the
final softmax or sigmoid, as the JAX package's does. Gradients are
autograd's of ``score``.
"""
from __future__ import annotations

import enum

import torch

_EPS = 1e-7


def _apply_mask_and_reduce(per_example: torch.Tensor, mask,
                           average: bool) -> torch.Tensor:
    """per_example: [batch] or [batch, time]. Applies the mask and
    reduces to a scalar (mean over the active count when ``average``)."""
    if mask is not None:
        mask = torch.as_tensor(mask, dtype=per_example.dtype,
                               device=per_example.device)
        while mask.dim() < per_example.dim():
            mask = mask[..., None]
        mask = mask.reshape(mask.shape[:per_example.dim()]).expand(
            per_example.shape)
        per_example = per_example * mask
        denom = torch.clamp(mask.sum(), min=1.0)
    else:
        denom = per_example.numel()
    total = per_example.sum()
    return total / denom if average else total


def _feature_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the feature axes -> [batch] or [batch, time]."""
    if x.dim() <= 1:
        return x
    if x.dim() == 2:
        return x.sum(-1)
    return x.reshape(x.shape[0], x.shape[1], -1).sum(-1)


def _nfeat(labels: torch.Tensor) -> int:
    return 1 if labels.dim() <= 1 else int(labels.shape[-1])


def _mse(labels, preds):
    return _feature_sum((preds - labels) ** 2) / _nfeat(labels)


def _l1(labels, preds):
    return _feature_sum(torch.abs(preds - labels))


def _l2(labels, preds):
    return _feature_sum((preds - labels) ** 2)


def _mae(labels, preds):
    return _feature_sum(torch.abs(preds - labels)) / _nfeat(labels)


def _mcxent(labels, preds):
    p = torch.clamp(preds, _EPS, 1.0 - _EPS)
    return -_feature_sum(labels * torch.log(p))


def _xent(labels, preds):
    p = torch.clamp(preds, _EPS, 1.0 - _EPS)
    return -_feature_sum(labels * torch.log(p) +
                         (1.0 - labels) * torch.log(1.0 - p))


def _hinge(labels, preds):
    # labels in {-1, +1}, the reference's convention
    return _feature_sum(torch.clamp(1.0 - labels * preds, min=0.0))


def _squared_hinge(labels, preds):
    return _feature_sum(torch.clamp(1.0 - labels * preds, min=0.0) ** 2)


def _kld(labels, preds):
    y = torch.clamp(labels, _EPS, 1.0)
    p = torch.clamp(preds, _EPS, 1.0)
    return _feature_sum(y * (torch.log(y) - torch.log(p)))


def _poisson(labels, preds):
    p = torch.clamp(preds, min=_EPS)
    return _feature_sum(p - labels * torch.log(p))


def _msle(labels, preds):
    return _feature_sum(
        (torch.log1p(torch.clamp(preds, min=-1 + _EPS)) -
         torch.log1p(torch.clamp(labels, min=-1 + _EPS))) ** 2) \
        / _nfeat(labels)


def _cosine_proximity(labels, preds):
    def norm(v):
        return torch.sqrt(torch.clamp(_feature_sum(v * v), min=_EPS))
    return -(_feature_sum(labels * preds) / (norm(labels) * norm(preds)))


def _as_float(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


class LossFunction(enum.Enum):
    MSE = "mse"
    L1 = "l1"
    L2 = "l2"
    MEAN_ABSOLUTE_ERROR = "mae"
    MEAN_SQUARED_LOGARITHMIC_ERROR = "msle"
    MCXENT = "mcxent"
    NEGATIVELOGLIKELIHOOD = "nll"   # alias of MCXENT in the reference
    XENT = "xent"
    HINGE = "hinge"
    SQUARED_HINGE = "squared_hinge"
    KL_DIVERGENCE = "kld"
    RECONSTRUCTION_CROSSENTROPY = "recon_xent"
    POISSON = "poisson"
    COSINE_PROXIMITY = "cosine_proximity"

    def _is_mcxent(self) -> bool:
        return self in (LossFunction.MCXENT,
                        LossFunction.NEGATIVELOGLIKELIHOOD)

    def score_array(self, labels, preds, mask=None) -> torch.Tensor:
        """Per-example (or per-example-per-timestep) loss, masked
        entries zeroed."""
        labels, preds = _as_float(labels), _as_float(preds)
        out = _IMPLS[self](labels, preds)
        if mask is not None:
            m = torch.as_tensor(mask, dtype=out.dtype, device=out.device)
            while m.dim() < out.dim():        # the padding of score()
                m = m[..., None]
            out = out * m.reshape(m.shape[:out.dim()]).expand(out.shape)
        return out

    def score(self, labels, preds, mask=None, average=True) -> torch.Tensor:
        """Scalar loss from the outputs (probabilities for the
        cross-entropies)."""
        labels, preds = _as_float(labels), _as_float(preds)
        return _apply_mask_and_reduce(_IMPLS[self](labels, preds), mask,
                                      average)

    def supports_logits(self) -> bool:
        return self._is_mcxent() or self is LossFunction.XENT

    def score_from_logits(self, labels, logits, mask=None,
                          average=True) -> torch.Tensor:
        """Scalar loss from the logits of a softmax (MCXENT, NLL) or
        sigmoid (XENT) head."""
        labels, logits = _as_float(labels), _as_float(logits)
        if self._is_mcxent():
            per = -_feature_sum(labels * torch.log_softmax(logits, dim=-1))
        elif self is LossFunction.XENT:
            per = _feature_sum(
                torch.clamp(logits, min=0) - logits * labels +
                torch.log1p(torch.exp(-torch.abs(logits))))
        else:
            raise ValueError(f"{self} has no logits form")
        return _apply_mask_and_reduce(per, mask, average)

    @staticmethod
    def from_name(name: str) -> "LossFunction":
        return LossFunction[name.upper()]


_IMPLS = {
    LossFunction.MSE: _mse,
    LossFunction.L1: _l1,
    LossFunction.L2: _l2,
    LossFunction.MEAN_ABSOLUTE_ERROR: _mae,
    LossFunction.MEAN_SQUARED_LOGARITHMIC_ERROR: _msle,
    LossFunction.MCXENT: _mcxent,
    LossFunction.NEGATIVELOGLIKELIHOOD: _mcxent,
    LossFunction.XENT: _xent,
    LossFunction.HINGE: _hinge,
    LossFunction.SQUARED_HINGE: _squared_hinge,
    LossFunction.KL_DIVERGENCE: _kld,
    LossFunction.RECONSTRUCTION_CROSSENTROPY: _xent,
    LossFunction.POISSON: _poisson,
    LossFunction.COSINE_PROXIMITY: _cosine_proximity,
}
