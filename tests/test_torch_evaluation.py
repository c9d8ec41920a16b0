"""The port's evaluation classes against the JAX package's, on the CPU.

The same seeded labels, predictions and masks (numpy into the JAX
package; numpy and torch tensors into the port) give the same metrics:
counts exactly, float metrics to 1e-12 (both are the same numpy code).
Covers 2-D and ``[b, t, c]`` labels with ``[b, t]`` masks.
"""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import evaluation as jev
from deeplearning4j_tpu_torch import evaluation as tev

N, C, T = 40, 5, 6


def _probs(r, shape):
    z = r.randn(*shape)
    e = np.exp(z - z.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _data(seed, time_series):
    r = np.random.RandomState(seed)
    shape = (N, T, C) if time_series else (N, C)
    labels = np.eye(C, dtype=np.float32)[r.randint(0, C, shape[:-1])]
    preds = _probs(r, shape)
    # mostly right, so every metric has something to count
    preds = np.where(r.rand(*shape[:-1], 1) < 0.6, labels * 0.9 + 0.02,
                     preds).astype(np.float32)
    mask = None
    if time_series:
        lengths = r.randint(1, T + 1, N)
        mask = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)
    return labels, preds, mask


def _both(kind, seed, time_series, as_tensor):
    labels, preds, mask = _data(seed, time_series)
    conv = torch.from_numpy if as_tensor else (lambda a: a)
    j, t = getattr(jev, kind)(), getattr(tev, kind)()
    for lo, hi in ((0, N // 2), (N // 2, N)):   # two batches accumulate
        m = mask[lo:hi] if mask is not None else None
        j.eval(labels[lo:hi], preds[lo:hi], mask=m)
        t.eval(conv(labels[lo:hi]), conv(preds[lo:hi]),
               mask=conv(m) if m is not None else None)
    return j, t


CASES = [(ts, tensor) for ts in (False, True) for tensor in (False, True)]
IDS = [f"{'bt' if ts else 'flat'}-{'tensor' if tensor else 'numpy'}"
       for ts, tensor in CASES]


@pytest.mark.parametrize("time_series,as_tensor", CASES, ids=IDS)
def test_evaluation(time_series, as_tensor):
    j, t = _both("Evaluation", 1, time_series, as_tensor)
    np.testing.assert_array_equal(t.confusion_matrix(),
                                  j.confusion_matrix())
    for name in ("accuracy", "precision", "recall", "f1"):
        assert getattr(t, name)() == pytest.approx(getattr(j, name)(),
                                                   abs=1e-12)
    for c in range(C):
        assert t.f1(c) == pytest.approx(j.f1(c), abs=1e-12)
        assert t.false_positive_rate(c) == pytest.approx(
            j.false_positive_rate(c), abs=1e-12)
    assert t.stats() == j.stats()


def test_evaluation_top_n_and_class_indices():
    labels, preds, _ = _data(2, False)
    j, t = jev.Evaluation(top_n=3), tev.Evaluation(top_n=3)
    j.eval(labels, preds)
    t.eval(torch.from_numpy(labels), torch.from_numpy(preds))
    assert t.top_n_accuracy() == j.top_n_accuracy()
    j, t = jev.Evaluation(num_classes=C), tev.Evaluation(num_classes=C)
    idx = labels.argmax(-1)
    j.eval(idx, preds)
    t.eval(torch.from_numpy(idx), torch.from_numpy(preds))
    np.testing.assert_array_equal(t.confusion_matrix(),
                                  j.confusion_matrix())


@pytest.mark.parametrize("time_series,as_tensor", CASES, ids=IDS)
def test_evaluation_binary(time_series, as_tensor):
    j, t = _both("EvaluationBinary", 3, time_series, as_tensor)
    for name in ("tp", "fp", "tn", "fn"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    for c in range(C):
        for name in ("accuracy", "precision", "recall", "f1"):
            assert getattr(t, name)(c) == pytest.approx(
                getattr(j, name)(c), abs=1e-12)


def test_roc():
    r = np.random.RandomState(4)
    y = (r.rand(60) > 0.4).astype(np.float32)
    s = np.clip(y * 0.3 + r.rand(60) * 0.7, 0, 1).astype(np.float32)
    s[:6] = 0.5                                          # ties
    j, t = jev.ROC(), tev.ROC()
    j.eval(y, s)
    t.eval(torch.from_numpy(y), torch.from_numpy(s))
    assert t.calculate_auc() == pytest.approx(j.calculate_auc(), abs=1e-12)
    assert t.calculate_auprc() == pytest.approx(j.calculate_auprc(),
                                                abs=1e-12)
    two_j, two_t = jev.ROC(), tev.ROC()
    two = np.stack([1 - s, s], -1)
    lab = np.stack([1 - y, y], -1)
    two_j.eval(lab, two)
    two_t.eval(torch.from_numpy(lab), torch.from_numpy(two))
    assert two_t.calculate_auc() == pytest.approx(j.calculate_auc(),
                                                  abs=1e-12)


@pytest.mark.parametrize("kind", ["ROCBinary", "ROCMultiClass"])
@pytest.mark.parametrize("time_series,as_tensor", CASES, ids=IDS)
def test_per_column_roc(kind, time_series, as_tensor):
    j, t = _both(kind, 5, time_series, as_tensor)
    assert len(t.rocs) == len(j.rocs) == C
    for c in range(C):
        assert t.calculate_auc(c) == pytest.approx(j.calculate_auc(c),
                                                   abs=1e-12)
        assert t.calculate_auprc(c) == pytest.approx(j.calculate_auprc(c),
                                                     abs=1e-12)
    assert t.calculate_average_auc() == pytest.approx(
        j.calculate_average_auc(), abs=1e-12)


def test_calibration():
    labels, preds, _ = _data(6, False)
    j, t = jev.EvaluationCalibration(n_bins=7), \
        tev.EvaluationCalibration(n_bins=7)
    j.eval(labels, preds)
    t.eval(torch.from_numpy(labels), torch.from_numpy(preds))
    np.testing.assert_array_equal(t.bin_counts, j.bin_counts)
    np.testing.assert_array_equal(t.bin_correct, j.bin_correct)
    assert t.expected_calibration_error() == pytest.approx(
        j.expected_calibration_error(), abs=1e-12)


@pytest.mark.parametrize("time_series,as_tensor", CASES, ids=IDS)
def test_regression(time_series, as_tensor):
    j, t = _both("RegressionEvaluation", 7, time_series, as_tensor)
    assert t.n == j.n
    for c in range(C):
        for name in ("mean_squared_error", "mean_absolute_error",
                     "root_mean_squared_error", "r_squared",
                     "pearson_correlation"):
            assert getattr(t, name)(c) == pytest.approx(
                getattr(j, name)(c), abs=1e-12)
    assert t.stats() == j.stats()


def test_bfloat16_predictions():
    labels, preds, _ = _data(8, False)
    ev = tev.Evaluation().eval(torch.from_numpy(labels),
                               torch.from_numpy(preds).bfloat16())
    assert ev.confusion_matrix().sum() == N
