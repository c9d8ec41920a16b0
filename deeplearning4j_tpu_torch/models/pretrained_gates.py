"""Quality gates for the bundled pretrained checkpoints.

Counterpart of ``deeplearning4j_tpu/models/pretrained_gates.py``: the
hard held-out split of the CIFAR surrogate on which the bundled
``resnet_cifar`` checkpoint must land inside ``HARD_GATE`` (a gate
below saturation, so a regression shows)."""
from __future__ import annotations

import numpy as np

#: signal fraction of the hard held-out split (training mixes at 0.6)
HARD_TEMPLATE_WEIGHT = 0.45
#: (min, max) accuracy bounds the hard split must land in
HARD_GATE = (0.60, 0.999)


def eval_resnet_cifar_hard(net, n: int = 2000) -> float:
    """Accuracy of ``net`` on the hard held-out CIFAR surrogate."""
    from deeplearning4j_tpu_torch.datasets.vision import synthetic_images
    from deeplearning4j_tpu_torch.evaluation.evaluation import _np
    xs, ys = synthetic_images(
        n, 32, 32, 3, 10, train=False, seed=123,
        template_weight=HARD_TEMPLATE_WEIGHT)
    probs = _np(net.output(xs))
    return float((probs.argmax(-1) == ys).mean())
