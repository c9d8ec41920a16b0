"""Evaluation classes.

Counterpart of ``deeplearning4j_tpu/evaluation/evaluation.py``, copied:
``Evaluation`` (accuracy, precision, recall, F1, confusion, top-N),
``EvaluationBinary``, ``ROC`` (exact AUC and AUPRC), ``ROCBinary``,
``ROCMultiClass``, ``EvaluationCalibration`` and
``RegressionEvaluation``. Accumulation is numpy on the host; labels,
predictions and masks may be arrays or torch tensors on any device.
``[b, t, c]`` time series flatten to ``[b·t, c]`` through a ``[b, t]``
labels mask first.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        # numpy has no bfloat16
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _flatten_time(labels, preds, mask):
    """[b, t, c] -> [b*t, c] with mask filtering (per-timestep eval,
    reference: time-series evaluation with label masks)."""
    if labels.ndim == 3:
        b, t, c = labels.shape
        labels = labels.reshape(b * t, c)
        preds = preds.reshape(b * t, c)
        if mask is not None:
            keep = mask.reshape(b * t) > 0
            labels, preds = labels[keep], preds[keep]
            mask = None
    return labels, preds, mask


class Evaluation:
    """Multi-class classification metrics. ``top_n > 1`` additionally
    tracks top-N accuracy (reference: Evaluation(int numClasses, int
    topN) — a prediction counts as top-N correct when the true class is
    among the N highest-probability outputs)."""

    def __init__(self, num_classes: Optional[int] = None, labels=None,
                 top_n: int = 1):
        self.num_classes = num_classes
        self.label_names = labels
        self.confusion: Optional[np.ndarray] = None
        self.top_n = max(1, int(top_n))
        self._top_n_correct = 0
        self._top_n_total = 0

    # ------------------------------------------------------------------
    def eval(self, labels, predictions, mask=None):  # noqa: A003
        labels = _np(labels)
        preds = _np(predictions)
        mask = _np(mask) if mask is not None else None
        labels, preds, mask = _flatten_time(labels, preds, mask)
        if labels.ndim == 2:
            true_idx = labels.argmax(-1)
            n = labels.shape[-1]
        else:
            true_idx = labels.astype(int)
            n = int(true_idx.max()) + 1 if self.num_classes is None \
                else self.num_classes
        pred_idx = preds.argmax(-1) if preds.ndim == 2 \
            else preds.astype(int)
        if self.num_classes is None:
            self.num_classes = n
        if self.confusion is None:
            self.confusion = np.zeros((self.num_classes, self.num_classes),
                                      dtype=np.int64)
        if mask is not None:
            keep = mask.reshape(-1) > 0
            true_idx, pred_idx = true_idx[keep], pred_idx[keep]
            preds = preds[keep] if preds.ndim == 2 else preds
        np.add.at(self.confusion, (true_idx, pred_idx), 1)
        if self.top_n > 1 and preds.ndim == 2:
            k = min(self.top_n, preds.shape[-1])
            topk = np.argpartition(-preds, k - 1, axis=-1)[:, :k]
            self._top_n_correct += int(
                (topk == true_idx[:, None]).any(-1).sum())
            self._top_n_total += int(true_idx.size)
        return self

    def top_n_accuracy(self) -> float:
        """Reference: Evaluation.topNAccuracy()."""
        if self.top_n == 1:
            return self.accuracy()
        if self._top_n_total == 0:
            return float("nan")
        return self._top_n_correct / self._top_n_total

    # ------------------------------------------------------------------
    def _tp(self):
        return np.diag(self.confusion).astype(np.float64)

    def accuracy(self) -> float:
        total = self.confusion.sum()
        return float(self._tp().sum() / total) if total else 0.0

    def precision(self, cls: Optional[int] = None) -> float:
        col = self.confusion.sum(0).astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            per = np.where(col > 0, self._tp() / col, np.nan)
        if cls is not None:
            return float(per[cls])
        return float(np.nanmean(per))

    def recall(self, cls: Optional[int] = None) -> float:
        row = self.confusion.sum(1).astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            per = np.where(row > 0, self._tp() / row, np.nan)
        if cls is not None:
            return float(per[cls])
        return float(np.nanmean(per))

    def f1(self, cls: Optional[int] = None) -> float:
        p = self.precision(cls)
        r = self.recall(cls)
        return 2 * p * r / (p + r) if (p + r) > 0 else 0.0

    def false_positive_rate(self, cls: int) -> float:
        fp = self.confusion[:, cls].sum() - self.confusion[cls, cls]
        tn = self.confusion.sum() - self.confusion[cls].sum() - \
            self.confusion[:, cls].sum() + self.confusion[cls, cls]
        return float(fp / (fp + tn)) if (fp + tn) else 0.0

    def confusion_matrix(self) -> np.ndarray:
        return self.confusion

    def stats(self) -> str:
        lines = [
            "========================Evaluation Metrics=================",
            f" # of classes:    {self.num_classes}",
            f" Accuracy:        {self.accuracy():.4f}",
            f" Precision:       {self.precision():.4f}",
            f" Recall:          {self.recall():.4f}",
            f" F1 Score:        {self.f1():.4f}",
            "",
            "=========================Confusion Matrix==================",
            str(self.confusion),
        ]
        return "\n".join(lines)


class EvaluationBinary:
    """Per-output independent binary metrics (reference: same name)."""

    def __init__(self, threshold: float = 0.5):
        self.threshold = threshold
        self.tp = self.fp = self.tn = self.fn = None

    def eval(self, labels, predictions, mask=None):  # noqa: A003
        labels = _np(labels)
        preds = (_np(predictions) > self.threshold)
        lab = labels > 0.5
        if self.tp is None:
            n = labels.shape[-1]
            self.tp = np.zeros(n, np.int64)
            self.fp = np.zeros(n, np.int64)
            self.tn = np.zeros(n, np.int64)
            self.fn = np.zeros(n, np.int64)
        flat_l = lab.reshape(-1, labels.shape[-1])
        flat_p = preds.reshape(-1, labels.shape[-1])
        if mask is not None:
            keep = _np(mask).reshape(-1) > 0
            flat_l, flat_p = flat_l[keep], flat_p[keep]
        self.tp += (flat_l & flat_p).sum(0)
        self.fp += (~flat_l & flat_p).sum(0)
        self.tn += (~flat_l & ~flat_p).sum(0)
        self.fn += (flat_l & ~flat_p).sum(0)
        return self

    def accuracy(self, i: int) -> float:
        tot = self.tp[i] + self.fp[i] + self.tn[i] + self.fn[i]
        return float((self.tp[i] + self.tn[i]) / tot) if tot else 0.0

    def precision(self, i: int) -> float:
        d = self.tp[i] + self.fp[i]
        return float(self.tp[i] / d) if d else 0.0

    def recall(self, i: int) -> float:
        d = self.tp[i] + self.fn[i]
        return float(self.tp[i] / d) if d else 0.0

    def f1(self, i: int) -> float:
        p, r = self.precision(i), self.recall(i)
        return 2 * p * r / (p + r) if (p + r) > 0 else 0.0


class ROC:
    """Binary ROC / AUC, exact (threshold-free), matching the reference's
    ROC(0) exact mode. For probability outputs [n] or [n, 2] (uses class-1
    column)."""

    def __init__(self):
        self.scores = []
        self.labels = []

    def eval(self, labels, predictions, mask=None):  # noqa: A003
        labels = _np(labels)
        preds = _np(predictions)
        if preds.ndim == 2 and preds.shape[-1] == 2:
            preds = preds[:, 1]
            labels = labels[:, 1] if labels.ndim == 2 else labels
        if mask is not None:
            keep = _np(mask).reshape(-1) > 0
            labels, preds = labels.reshape(-1)[keep], \
                preds.reshape(-1)[keep]
        self.scores.append(preds.reshape(-1))
        self.labels.append(labels.reshape(-1))
        return self

    def calculate_auc(self) -> float:
        s = np.concatenate(self.scores)
        y = np.concatenate(self.labels) > 0.5
        n_pos = int(y.sum())
        n_neg = y.size - n_pos
        if n_pos == 0 or n_neg == 0:
            return float("nan")
        # rank-sum (Mann-Whitney) AUC with tie correction
        order = np.argsort(s, kind="mergesort")
        ranks = np.empty_like(order, dtype=np.float64)
        sorted_s = s[order]
        i = 0
        while i < len(sorted_s):
            j = i
            while j + 1 < len(sorted_s) and sorted_s[j + 1] == sorted_s[i]:
                j += 1
            ranks[order[i:j + 1]] = 0.5 * (i + j) + 1.0
            i = j + 1
        auc = (ranks[y].sum() - n_pos * (n_pos + 1) / 2.0) / \
            (n_pos * n_neg)
        return float(auc)

    def calculate_auprc(self) -> float:
        """Area under the precision-recall curve (reference:
        ROC.calculateAUCPR), exact interpolation-free sum."""
        s = np.concatenate(self.scores)
        y = np.concatenate(self.labels) > 0.5
        if y.sum() == 0:
            return float("nan")
        order = np.argsort(-s, kind="mergesort")
        y_sorted = y[order]
        tp = np.cumsum(y_sorted)
        precision = tp / np.arange(1, y_sorted.size + 1)
        # average precision: sum precision at each positive hit
        return float(precision[y_sorted].sum() / y.sum())


class _PerColumnROC:
    """One independent ROC per label/class column; [b, t, c] time series
    flatten through the label mask first (shared spine of ROCBinary and
    ROCMultiClass)."""

    def __init__(self):
        self.rocs: list = []

    def eval(self, labels, predictions, mask=None):  # noqa: A003
        labels = _np(labels)
        preds = _np(predictions)
        if labels.ndim == 1:
            labels, preds = labels[:, None], preds[:, None]
        mask = _np(mask) if mask is not None else None
        if labels.ndim == 3:   # [b, t, c] time series
            labels, preds, mask = _flatten_time(labels, preds, mask)
        n_col = labels.shape[-1]
        if not self.rocs:
            self.rocs = [ROC() for _ in range(n_col)]
        for i in range(n_col):
            # a per-output [n, c] mask selects column i; an [n] mask
            # applies to every column
            m = mask
            if m is not None and m.ndim == 2:
                m = m[:, i]
            self.rocs[i].eval(labels[:, i], preds[:, i], mask=m)
        return self

    def calculate_auc(self, i: int) -> float:
        return self.rocs[i].calculate_auc()

    def calculate_auprc(self, i: int) -> float:
        return self.rocs[i].calculate_auprc()

    def calculate_average_auc(self) -> float:
        aucs = [r.calculate_auc() for r in self.rocs]
        aucs = [a for a in aucs if not np.isnan(a)]
        return float(np.mean(aucs)) if aucs else float("nan")


class ROCBinary(_PerColumnROC):
    """Per-output binary ROC for multi-label sigmoid heads (reference:
    org.nd4j.evaluation.classification.ROCBinary)."""

    def num_labels(self) -> int:
        return len(self.rocs)


class ROCMultiClass(_PerColumnROC):
    """One-vs-all ROC per class for softmax heads (reference:
    org.nd4j.evaluation.classification.ROCMultiClass)."""

    def num_classes(self) -> int:
        return len(self.rocs)


class EvaluationCalibration:
    """Reliability-diagram accumulation (reference: same name)."""

    def __init__(self, n_bins: int = 10):
        self.n_bins = n_bins
        self.bin_counts = np.zeros(n_bins, np.int64)
        self.bin_correct = np.zeros(n_bins, np.int64)
        self.bin_conf_sum = np.zeros(n_bins, np.float64)

    def eval(self, labels, predictions, mask=None):  # noqa: A003
        labels = _np(labels)
        preds = _np(predictions)
        conf = preds.max(-1)
        correct = preds.argmax(-1) == labels.argmax(-1)
        bins = np.clip((conf * self.n_bins).astype(int), 0,
                       self.n_bins - 1)
        np.add.at(self.bin_counts, bins, 1)
        np.add.at(self.bin_correct, bins, correct.astype(np.int64))
        np.add.at(self.bin_conf_sum, bins, conf)
        return self

    def expected_calibration_error(self) -> float:
        tot = self.bin_counts.sum()
        if tot == 0:
            return 0.0
        acc = np.where(self.bin_counts > 0,
                       self.bin_correct / np.maximum(self.bin_counts, 1),
                       0.0)
        conf = np.where(self.bin_counts > 0,
                        self.bin_conf_sum / np.maximum(self.bin_counts, 1),
                        0.0)
        return float(np.sum(self.bin_counts / tot * np.abs(acc - conf)))


class RegressionEvaluation:
    """Column-wise regression metrics (reference: same name)."""

    def __init__(self, n_columns: Optional[int] = None):
        self.n = 0
        self.n_columns = n_columns
        self.sum_sq = None
        self.sum_abs = None
        self.sum_label = None
        self.sum_label_sq = None
        self.sum_pred = None
        self.sum_label_pred = None
        self.sum_pred_sq = None

    def eval(self, labels, predictions, mask=None):  # noqa: A003
        labels = _np(labels).astype(np.float64)
        preds = _np(predictions).astype(np.float64)
        labels, preds, _ = _flatten_time(labels, preds,
                                         _np(mask) if mask is not None
                                         else None)
        if self.sum_sq is None:
            c = labels.shape[-1]
            self.n_columns = c
            z = lambda: np.zeros(c, np.float64)
            self.sum_sq, self.sum_abs = z(), z()
            self.sum_label, self.sum_label_sq = z(), z()
            self.sum_pred, self.sum_pred_sq = z(), z()
            self.sum_label_pred = z()
        err = preds - labels
        self.n += labels.shape[0]
        self.sum_sq += (err ** 2).sum(0)
        self.sum_abs += np.abs(err).sum(0)
        self.sum_label += labels.sum(0)
        self.sum_label_sq += (labels ** 2).sum(0)
        self.sum_pred += preds.sum(0)
        self.sum_pred_sq += (preds ** 2).sum(0)
        self.sum_label_pred += (labels * preds).sum(0)
        return self

    def mean_squared_error(self, col: int = 0) -> float:
        return float(self.sum_sq[col] / self.n)

    def mean_absolute_error(self, col: int = 0) -> float:
        return float(self.sum_abs[col] / self.n)

    def root_mean_squared_error(self, col: int = 0) -> float:
        return float(np.sqrt(self.mean_squared_error(col)))

    def r_squared(self, col: int = 0) -> float:
        ss_tot = self.sum_label_sq[col] - \
            self.sum_label[col] ** 2 / self.n
        ss_res = self.sum_sq[col]
        return float(1.0 - ss_res / ss_tot) if ss_tot > 0 else 0.0

    def pearson_correlation(self, col: int = 0) -> float:
        n = self.n
        num = self.sum_label_pred[col] - \
            self.sum_label[col] * self.sum_pred[col] / n
        den = np.sqrt((self.sum_label_sq[col] -
                       self.sum_label[col] ** 2 / n) *
                      (self.sum_pred_sq[col] -
                       self.sum_pred[col] ** 2 / n))
        return float(num / den) if den > 0 else 0.0

    def stats(self) -> str:
        cols = range(self.n_columns or 0)
        lines = ["Column    MSE            MAE            RMSE           R^2"]
        for c in cols:
            lines.append(f"col_{c}   {self.mean_squared_error(c):<14.6f} "
                         f"{self.mean_absolute_error(c):<14.6f} "
                         f"{self.root_mean_squared_error(c):<14.6f} "
                         f"{self.r_squared(c):.6f}")
        return "\n".join(lines)
