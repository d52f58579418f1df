"""Viterbi sequence decoding (the port of ``deeplearning4j_tpu/utils/
viterbi.py``; ≙ reference util/Viterbi.java:176).

The reference runs the forward pass as a ``lax.scan``; here it is a loop
over the T positions on tensors, on the device of the scores. Ties in the
argmax go to the lowest state index, as ``jnp.argmax``'s do
(``torch.argmax`` returns the first maximum). The back-pointers come to the
host in one copy and the path is read back there.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device


def viterbi_decode(log_emissions: torch.Tensor, log_transitions: torch.Tensor,
                   log_start: torch.Tensor):
    """Most likely state path.

    log_emissions: (T, S); log_transitions: (S, S) [from, to]; log_start:
    (S,). Returns (path (T,) int64, score 0-dim), on the scores' device.
    """
    delta = log_start + log_emissions[0]
    ptrs = []
    for emit in log_emissions[1:]:
        scores = delta[:, None] + log_transitions  # (S_from, S_to)
        ptrs.append(torch.argmax(scores, dim=0))
        delta = torch.amax(scores, dim=0) + emit
    last = torch.argmax(delta)
    score = delta[last]
    back = (torch.stack(ptrs).cpu().numpy() if ptrs
            else np.zeros((0, delta.shape[0]), np.int64))
    path = np.empty(len(ptrs) + 1, np.int64)
    state = int(last)
    path[-1] = state
    for t in range(len(ptrs) - 1, -1, -1):
        state = int(back[t, state])
        path[t] = state
    return torch.from_numpy(path).to(delta.device), score


class Viterbi:
    """Stateful wrapper with probability-space inputs (≙ util/Viterbi.java),
    its log tables in f32 on ``device`` (``cuda`` unless the caller names
    another; raises without a card)."""

    def __init__(self, transitions: np.ndarray, start: np.ndarray | None = None,
                 device=None):
        self.device = resolve_device(device)
        self.log_transitions = self._log(transitions)
        s = transitions.shape[0]
        start = start if start is not None else np.full(s, 1.0 / s)
        self.log_start = self._log(start)

    def _log(self, p) -> torch.Tensor:
        """``log(p + 1e-12)`` in f32, as the reference takes it (the
        probabilities cast to f32 first)."""
        t = torch.tensor(np.asarray(p, np.float32), device=self.device)
        return torch.log(t + 1e-12)

    def decode(self, emissions: np.ndarray) -> tuple[np.ndarray, float]:
        path, score = viterbi_decode(self._log(emissions),
                                     self.log_transitions, self.log_start)
        return path.cpu().numpy(), float(score)
