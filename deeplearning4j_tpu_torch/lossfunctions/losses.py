"""Loss functions.

Counterpart of ``deeplearning4j_tpu/lossfunctions/losses.py``: the same
``LossFunction`` enum, so output-layer configurations parse and
round-trip, and the math of the losses the port's models train with,
``MCXENT`` and its alias ``NEGATIVELOGLIKELIHOOD``: from probabilities
(``-Σ labels·log(clip(p, 1e-7, 1 − 1e-7))``) and, for a softmax head,
from logits (``-Σ labels·log_softmax(z)``). A per-example loss is summed
over the features and averaged over the batch, or over the active
entries of a mask, as in the JAX package. The other members carry no
math yet and raise when scored.
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


def _mcxent(labels, preds):
    p = torch.clamp(preds, _EPS, 1.0 - _EPS)
    return -_feature_sum(labels * torch.log(p))


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

    def _not_ported(self):
        return NotImplementedError(
            f"loss {self.name} is not ported yet (ported: MCXENT, "
            f"NEGATIVELOGLIKELIHOOD)")

    def score(self, labels, preds, mask=None, average=True) -> torch.Tensor:
        """Scalar loss from probabilities."""
        if not self._is_mcxent():
            raise self._not_ported()
        return _apply_mask_and_reduce(_mcxent(labels, preds), mask,
                                      average)

    def supports_logits(self) -> bool:
        return self._is_mcxent()

    def score_from_logits(self, labels, logits, mask=None,
                          average=True) -> torch.Tensor:
        """Scalar loss from the logits of a softmax head."""
        if not self._is_mcxent():
            raise self._not_ported()
        per = -_feature_sum(labels * torch.log_softmax(logits, dim=-1))
        return _apply_mask_and_reduce(per, mask, average)

    @staticmethod
    def from_name(name: str) -> "LossFunction":
        return LossFunction[name.upper()]
