"""Backtracking line search (the JAX package's ``optimize/linesearch.py``):
walk back along a descent direction until the Armijo sufficient-decrease
condition holds.

The reference runs the search as one ``lax.while_loop`` on the device.
Here each trial's Armijo test is read back to the host (``api.host_read``,
one sync a trial); the trial steps, the scores and the test are the
reference's.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.optimize.api import host_read
from deeplearning4j_tpu_torch.utils import tree_math as tm


class LineSearchResult(NamedTuple):
    step: float  # chosen step size (0.0 if no acceptable step)
    score: torch.Tensor  # score at the chosen step
    n_evals: int


def _f32(x) -> float:
    return float(np.float32(x))


def backtrack(score_fn: Callable, params, direction, grad,
              initial_step: float = 1.0, max_iterations: int = 5,
              c1: float = 1e-4, rho: float = 0.5,
              min_step: float = 1e-12) -> LineSearchResult:
    """Find t with score(params + t*direction) <= score(params) +
    c1*t*<g,d>, shrinking t by ``rho`` from ``initial_step``; if no trial
    passes, step 0 and the starting score. The steps are host numbers
    rounded to f32 as the reference's f32 steps are, so only the tests'
    outcomes are read back."""
    phi0 = score_fn(params)
    slope = tm.vdot(grad, direction)

    def trial(t):
        score = score_fn(tm.axpy(t, direction, params))
        bar = phi0 + _f32(np.float32(c1) * np.float32(t)) * slope
        return score, host_read(score <= bar)

    t = _f32(initial_step)
    score, ok = trial(t)
    n = 1
    while not ok and n < max_iterations and t > min_step:
        t = _f32(np.float32(t) * np.float32(rho))
        score, ok = trial(t)
        n += 1
    if not ok:
        return LineSearchResult(step=0.0, score=phi0, n_evals=n)
    return LineSearchResult(step=t, score=score, n_evals=n)
