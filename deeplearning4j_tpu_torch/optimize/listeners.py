"""Training listeners.

Counterpart of ``deeplearning4j_tpu/optimize/listeners.py``: the hooks
the fit loop calls after every iteration and around every epoch, and
``ScoreIterationListener``, ``PerformanceListener``,
``EvaluativeListener`` and ``CollectScoresListener``. The first two log
through the ``deeplearning4j_tpu_torch`` logger (``stdout=True`` also
prints).
"""
from __future__ import annotations

import logging
import time

log = logging.getLogger("deeplearning4j_tpu_torch")


class TrainingListener:
    def iteration_done(self, model, iteration: int, epoch: int):
        pass

    def on_epoch_start(self, model):
        pass

    def on_epoch_end(self, model):
        pass


class ScoreIterationListener(TrainingListener):
    """Log the score every ``print_iterations`` iterations."""

    def __init__(self, print_iterations: int = 10, *,
                 stdout: bool = False):
        self.print_iterations = max(1, int(print_iterations))
        self.stdout = stdout

    def iteration_done(self, model, iteration, epoch):
        if iteration % self.print_iterations == 0:
            score = model.score()
            log.info("Score at iteration %d is %s", iteration, score)
            if self.stdout:
                print(f"Score at iteration {iteration} is {score}")


class PerformanceListener(TrainingListener):
    """Iterations and samples a second over the last ``frequency``
    iterations, on the host's clock (reference: same name). The rate is
    of the host's loop: on the card, work still queued when an iteration
    returns falls in a later window."""

    def __init__(self, frequency: int = 10, report_samples: bool = True,
                 *, stdout: bool = False):
        self.frequency = max(1, int(frequency))
        self.report_samples = report_samples
        self.stdout = stdout
        self._last_time = None
        self._last_iter = None
        self._examples = 0

    def iteration_done(self, model, iteration, epoch):
        now = time.perf_counter()
        self._examples += getattr(model, "last_batch_size", None) or 0
        if iteration % self.frequency:
            return
        if self._last_time is not None:
            dt = now - self._last_time
            msg = (f"iteration {iteration}: "
                   f"{(iteration - self._last_iter) / dt:.2f} iters/sec"
                   + (f", {self._examples / dt:.1f} samples/sec"
                      if self.report_samples else ""))
            log.info(msg)
            if self.stdout:
                print(msg)
        self._last_time = now
        self._last_iter = iteration
        self._examples = 0


class EvaluativeListener(TrainingListener):
    """Evaluate on a held-out iterator every ``frequency`` iterations
    (reference: EvaluativeListener at ITERATION_END): outputs under each
    batch's features mask, counted under its labels mask. Results
    accumulate in ``evaluations`` as ``(iteration, Evaluation)``;
    ``callback(iteration, evaluation)`` fires after each."""

    def __init__(self, iterator, frequency: int = 10, callback=None):
        if not (hasattr(iterator, "reset") or hasattr(iterator, "features")
                or isinstance(iterator, (list, tuple))):
            iterator = list(iterator)   # a one-shot iterable: keep it
        self.iterator = iterator
        self.frequency = max(1, int(frequency))
        self.callback = callback
        self.evaluations = []

    def iteration_done(self, model, iteration, epoch):
        if iteration % self.frequency:
            return
        from deeplearning4j_tpu_torch.evaluation import Evaluation
        e = Evaluation()
        if hasattr(self.iterator, "reset"):
            self.iterator.reset()
        data = [self.iterator] if hasattr(self.iterator, "features") \
            else self.iterator
        for ds in data:
            out = model.output(ds.features,
                               mask=getattr(ds, "features_mask", None))
            if isinstance(out, (list, tuple)):
                out = out[0]
            e.eval(ds.labels, out, mask=getattr(ds, "labels_mask", None))
        self.evaluations.append((iteration, e))
        log.info("Evaluation at iteration %d: accuracy %.4f", iteration,
                 e.accuracy())
        if self.callback is not None:
            self.callback(iteration, e)


class CollectScoresListener(TrainingListener):
    """Collect ``(iteration, score)`` pairs in memory (reference: same
    name)."""

    def __init__(self):
        self.scores: list = []

    def iteration_done(self, model, iteration, epoch):
        self.scores.append((iteration, model.score()))
