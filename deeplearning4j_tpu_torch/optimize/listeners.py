"""Training listeners.

Counterpart of ``TrainingListener`` and ``ScoreIterationListener`` in
``deeplearning4j_tpu/optimize/listeners.py``: hooks the fit loop calls
after every iteration and around every epoch.
"""
from __future__ import annotations

import logging

log = logging.getLogger("deeplearning4j_tpu_torch")


class TrainingListener:
    def iteration_done(self, model, iteration: int, epoch: int):
        pass

    def on_epoch_start(self, model):
        pass

    def on_epoch_end(self, model):
        pass


class ScoreIterationListener(TrainingListener):
    """Log the score every ``print_iterations`` iterations through the
    ``deeplearning4j_tpu_torch`` logger; ``stdout=True`` also prints."""

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
