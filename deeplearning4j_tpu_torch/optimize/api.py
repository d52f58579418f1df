"""Optimizer API (the JAX package's ``optimize/api.py``): the model-function
bundle the solvers drive, termination conditions, listeners, and the count
of host reads.

The reference runs each solver as one ``lax.while_loop`` on the device, so
a solve without listeners reads nothing back until it ends. The port's
solvers are eager loops: every decision that depends on a device value (a
termination check, a line-search trial's Armijo test, an L-BFGS pair's
curvature test, a Hessian-free CG step's residual test) reads it back, one
host sync each. :func:`host_read` makes every such read and counts it in
``host_syncs``.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Sequence

import torch

from deeplearning4j_tpu_torch.nn.layers.api import value_and_grad

log = logging.getLogger(__name__)

#: device values the solvers read back since the last reset
host_syncs = 0


def reset_host_syncs() -> None:
    global host_syncs
    host_syncs = 0


def host_read(x: torch.Tensor):
    """``x.item()``, counted in ``host_syncs``."""
    global host_syncs
    host_syncs += 1
    return x.item()


@dataclasses.dataclass(frozen=True)
class ModelFunctions:
    """Pure functions the solvers drive.

    score_and_grad: (params, key) -> (score, grad tree) — lower is better
    score:          (params, key) -> score
    forward:        optional (params,) -> outputs, for Gauss-Newton products
    loss_on_outputs: optional (outputs,) -> scalar, for Gauss-Newton products
    """

    score_and_grad: Callable[[Any, Any], tuple[torch.Tensor, Any]]
    score: Callable[[Any, Any], torch.Tensor]
    forward: Callable[[Any], Any] | None = None
    loss_on_outputs: Callable[[Any], torch.Tensor] | None = None

    @classmethod
    def from_score(cls, score_fn, **kw) -> "ModelFunctions":
        return cls(score_and_grad=value_and_grad(score_fn), score=score_fn,
                   **kw)


# -- termination conditions ---------------------------------------------------

def eps_termination(eps: float = 1e-4, tolerance: float = 1e-10):
    """Relative score improvement below eps."""

    def cond(score, old_score, grad_norm):
        improvement = torch.abs(old_score - score)
        return improvement < eps * (torch.abs(old_score) + torch.abs(score)
                                    + tolerance)

    return cond


def norm2_termination(gradient_tolerance: float = 1e-8):
    """Gradient 2-norm below tolerance."""

    def cond(score, old_score, grad_norm):
        return grad_norm < gradient_tolerance

    return cond


def default_terminations() -> list:
    return [eps_termination(), norm2_termination()]


# -- listeners ----------------------------------------------------------------

class IterationListener:
    def iteration_done(self, info: dict) -> None:  # pragma: no cover
        raise NotImplementedError


class ScoreIterationListener(IterationListener):
    """Logs the score every N iterations and keeps every score."""

    def __init__(self, print_every: int = 10):
        self.print_every = print_every
        self.history: list[float] = []

    def iteration_done(self, info: dict) -> None:
        self.history.append(float(info["score"]))
        i = info["iteration"]
        if i % self.print_every == 0:
            log.info("Score at iteration %d is %s", i, info["score"])


class ComposableIterationListener(IterationListener):
    """Fan out to several listeners."""

    def __init__(self, listeners: Sequence[IterationListener]):
        self.listeners = list(listeners)

    def iteration_done(self, info: dict) -> None:
        for listener in self.listeners:
            listener.iteration_done(info)
