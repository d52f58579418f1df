"""Solver facade (the JAX package's ``optimize/solver.py``): pick the
optimizer from the config's OptimizationAlgorithm and run it, handing each
iteration's score to the listeners when there are any."""

from __future__ import annotations

from typing import Any, Sequence

from deeplearning4j_tpu_torch.nn.conf import LayerConfig
from deeplearning4j_tpu_torch.optimize import solvers
from deeplearning4j_tpu_torch.optimize.api import (
    IterationListener,
    ModelFunctions,
    host_read,
)


class Solver:
    def __init__(self, conf: LayerConfig, model: ModelFunctions,
                 listeners: Sequence[IterationListener] = (),
                 algo: str | None = None):
        self.conf = conf
        self.model = model
        self.listeners = list(listeners)
        self.algo = algo or conf.optimization_algo

    def optimize(self, params: Any, key,
                 num_iterations: int | None = None) -> tuple[Any, float]:
        """Run the solver; returns (new_params, final_score)."""
        params, score, _ = solvers.optimize(
            self.conf, self.model, params, key, num_iterations, self.algo,
            self.listeners)
        return params, host_read(score)
