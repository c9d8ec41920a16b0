"""SameDiff training config and history.

Counterpart of ``deeplearning4j_tpu/autodiff/training.py`` (reference:
``org.nd4j.autodiff.samediff.TrainingConfig``: updater, regularization,
dataset feature/label -> placeholder mappings; ``History``: the
per-epoch loss curves and evaluation records ``fit`` returns), and
``device_prefetch_placeholders``, the staging ``SameDiff.fit`` runs its
batches through.
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from deeplearning4j_tpu_torch.common import telemetry
from deeplearning4j_tpu_torch.datasets.iterators import _FeederError
from deeplearning4j_tpu_torch.datasets.prefetch import Staged, Stager


def device_prefetch_placeholders(iterator, make_ph: Callable,
                                 convert: Callable,
                                 device: Union[str, torch.device],
                                 depth: int = 2):
    """Staging for the SameDiff fit loop (the placeholder counterpart of
    ``datasets/prefetch.DevicePrefetcher``): a feeder thread maps each
    batch through ``make_ph`` (a batch -> ``{name: array}``) and
    ``convert`` (an array -> a host tensor of the graph's dtype) and
    stages the tensors on ``device`` ahead of the step. Yields the dicts in iterator order; a
    feeder exception is raised here."""
    q: queue.Queue = queue.Queue(max(1, int(depth)))
    sentinel = object()
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def feeder():
        try:
            stager = Stager()
            for batch in iterator:
                ph = {k: convert(v) for k, v in make_ph(batch).items()}
                pending: list = []
                if not put(Staged(stager.to_device(ph, device, pending),
                                  pending)):
                    return
            put(sentinel)
        except BaseException as e:       # noqa: BLE001 — re-raised below
            put(_FeederError(e))

    thread = threading.Thread(target=feeder, daemon=True,
                              name="dl4j-torch-samediff-prefetch")
    thread.start()
    try:
        while True:
            if telemetry.enabled():
                t0 = time.perf_counter()
                item = q.get()
                telemetry.observe_feed_stall(time.perf_counter() - t0,
                                             source="samediff_prefetch")
            else:
                item = q.get()
            if item is sentinel:
                return
            if isinstance(item, _FeederError):
                raise item.exc
            yield item.consume()
    finally:
        # a consumer that stops early (an exception in the step) lets
        # the feeder finish rather than block on a full queue
        stop.set()
        thread.join()


@dataclass
class TrainingConfig:
    updater: object = None        # learning.updaters.IUpdater
    l1: float = 0.0
    l2: float = 0.0
    # placeholder names fed from DataSet features/labels, in order
    data_set_feature_mapping: List[str] = field(default_factory=list)
    data_set_label_mapping: List[str] = field(default_factory=list)
    data_set_feature_mask_mapping: List[str] = field(default_factory=list)
    data_set_label_mask_mapping: List[str] = field(default_factory=list)

    class Builder:
        def __init__(self):
            self._c = TrainingConfig()

        def updater(self, u):
            self._c.updater = u
            return self

        def l1(self, v):
            self._c.l1 = v
            return self

        def l2(self, v):
            self._c.l2 = v
            return self

        def data_set_feature_mapping(self, *names):
            self._c.data_set_feature_mapping = list(names)
            return self

        def data_set_label_mapping(self, *names):
            self._c.data_set_label_mapping = list(names)
            return self

        def data_set_feature_mask_mapping(self, *names):
            self._c.data_set_feature_mask_mapping = list(names)
            return self

        def data_set_label_mask_mapping(self, *names):
            self._c.data_set_label_mask_mapping = list(names)
            return self

        def build(self):
            if self._c.updater is None:
                raise ValueError("TrainingConfig needs an updater")
            return self._c

    # ------------------------------------------------------------------
    def placeholders_from(self, batch) -> Dict[str, np.ndarray]:
        """DataSet/MultiDataSet -> placeholder dict via the mappings."""
        ph = {}

        def as_list(x):
            return x if isinstance(x, (list, tuple)) else [x]

        feats = as_list(batch.features)
        for name, arr in zip(self.data_set_feature_mapping, feats):
            ph[name] = arr
        labs = as_list(batch.labels)
        for name, arr in zip(self.data_set_label_mapping, labs):
            ph[name] = arr
        fm = getattr(batch, "features_masks",
                     getattr(batch, "features_mask", None))
        if fm is not None and self.data_set_feature_mask_mapping:
            for name, arr in zip(self.data_set_feature_mask_mapping,
                                 as_list(fm)):
                if arr is not None:
                    ph[name] = arr
        lm = getattr(batch, "labels_masks",
                     getattr(batch, "labels_mask", None))
        if lm is not None and self.data_set_label_mask_mapping:
            for name, arr in zip(self.data_set_label_mask_mapping,
                                 as_list(lm)):
                if arr is not None:
                    ph[name] = arr
        return ph

    # -- serde ---------------------------------------------------------
    def to_map(self) -> dict:
        return {
            "updater": self.updater.to_map() if self.updater else None,
            "l1": self.l1, "l2": self.l2,
            "data_set_feature_mapping": self.data_set_feature_mapping,
            "data_set_label_mapping": self.data_set_label_mapping,
            "data_set_feature_mask_mapping":
                self.data_set_feature_mask_mapping,
            "data_set_label_mask_mapping":
                self.data_set_label_mask_mapping,
        }

    @staticmethod
    def from_map(m: dict) -> "TrainingConfig":
        from deeplearning4j_tpu_torch.learning.updaters import IUpdater
        c = TrainingConfig()
        if m.get("updater"):
            c.updater = IUpdater.from_map(m["updater"])
        c.l1 = m.get("l1", 0.0)
        c.l2 = m.get("l2", 0.0)
        c.data_set_feature_mapping = m.get("data_set_feature_mapping", [])
        c.data_set_label_mapping = m.get("data_set_label_mapping", [])
        c.data_set_feature_mask_mapping = m.get(
            "data_set_feature_mask_mapping", [])
        c.data_set_label_mask_mapping = m.get(
            "data_set_label_mask_mapping", [])
        return c


class History:
    """Per-epoch training history (reference:
    org.nd4j.autodiff.listeners.records.History — loss curves PLUS
    the evaluation records ``fit`` collects on the validation iterator
    each epoch)."""

    def __init__(self):
        self.epoch_losses: List[List[float]] = []
        #: one dict per epoch: output-var name -> Evaluation-like
        #: object (empty dict for epochs without validation)
        self.epoch_evaluations: List[Dict[str, object]] = []
        #: mean validation loss per epoch (nan when not measured)
        self.validation_losses: List[float] = []

    def add_epoch(self, epoch: int, losses: List[float],
                  evaluations: Optional[Dict[str, object]] = None,
                  validation_loss: float = float("nan")):
        self.epoch_losses.append(losses)
        self.epoch_evaluations.append(dict(evaluations or {}))
        self.validation_losses.append(validation_loss)

    def final_loss(self) -> float:
        if not self.epoch_losses or not self.epoch_losses[-1]:
            return float("nan")
        return self.epoch_losses[-1][-1]

    def loss_curve(self) -> List[float]:
        return [l for ep in self.epoch_losses for l in ep]

    # -- evaluation records (reference: History.finalTrainingEvaluations
    # / getEvaluations) ------------------------------------------------
    def evaluations(self, name: str) -> List[object]:
        """Every recorded evaluation for output var ``name``, in epoch
        order (epochs without one are skipped)."""
        return [d[name] for d in self.epoch_evaluations if name in d]

    def final_evaluation(self, name: str):
        ev = self.evaluations(name)
        if not ev:
            raise KeyError(
                f"no evaluation recorded for {name!r} — pass "
                f"validation_iter/validation_evaluations to fit")
        return ev[-1]

    def validation_loss_curve(self) -> List[float]:
        return list(self.validation_losses)

    def __len__(self):
        return len(self.epoch_losses)
