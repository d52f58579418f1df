"""Step-scoped ``torch.profiler`` capture trigger (the port of
``deeplearning4j_tpu/obs/profiler.py``, whose capture is ``jax.profiler``'s).

A profiler captures everything between start and stop, so start and stop
must land on meaningful boundaries. For a serving engine the unit is the
*engine step* (one admission sweep and one fused decode horizon), so
:class:`ProfileTrigger` arms a capture of the NEXT ``n`` steps: the engine
calls ``step_start``/``step_end`` around each step, and the trigger starts
the profiler at the first armed step and stops it after the n-th. Disarmed
cost is one integer compare per step.

Armed remotely through ``POST /profile?s=N`` on the serving server, or at
launch with ``serve --profile-steps N``. The capture is
``torch.profiler``'s: CPU activity, plus CUDA activity when a card is
present (the port's kernels then show under their symbol names, e.g.
``flash_fwd_wgmma_kernel``, ``flash_decode_split_kernel``). It is written
as a Chrome trace, ``trace.json``, into a fresh subdirectory of
``log_dir`` (open it at https://ui.perfetto.dev). On a card the last
armed step synchronizes the device before the profiler stops, so the
trace holds every kernel the steps launched.
"""

from __future__ import annotations

import tempfile
import threading
import time
from pathlib import Path

#: the Chrome trace each capture writes into its directory
TRACE_FILE = "trace.json"


def default_log_dir() -> Path:
    """Captures land under the temporary directory by default."""
    return Path(tempfile.gettempdir()) / "dl4j_tpu_torch_profile"


class ProfileTrigger:
    def __init__(self, log_dir: str | Path | None = None):
        self.log_dir = Path(log_dir) if log_dir is not None else (
            default_log_dir())
        self._lock = threading.Lock()
        self._remaining = 0
        self._active = False
        self._prof = None
        self.n_captures = 0
        self.last_capture_dir: Path | None = None

    @property
    def armed(self) -> bool:
        return self._remaining > 0 or self._active

    def arm(self, n_steps: int, log_dir: str | Path | None = None) -> Path:
        """Arm a capture of the next ``n_steps`` engine steps; returns the
        directory the capture will land in. Raises while a capture is
        already armed or running (one at a time: the profiler is a
        process-wide singleton)."""
        if n_steps < 1:
            raise ValueError(f"n_steps must be >= 1, got {n_steps}")
        with self._lock:
            if self.armed:
                raise RuntimeError("a profile capture is already armed")
            d = Path(log_dir) if log_dir is not None else self.log_dir
            d = d / f"capture-{self.n_captures}-{int(time.time())}"
            self.last_capture_dir = d
            self._remaining = int(n_steps)
        return d

    def step_start(self) -> None:
        """Engine hook, before a step. Starts the profiler on the first
        armed step; a plain no-op when disarmed."""
        if self._remaining <= 0 or self._active:
            return
        with self._lock:
            if self._remaining <= 0 or self._active:
                return
            import torch

            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.last_capture_dir.mkdir(parents=True, exist_ok=True)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.start()
            self._active = True

    def step_end(self) -> None:
        """Engine hook, after a step. Stops the profiler and writes the
        trace once the armed step budget is spent."""
        if not self._active:
            return
        with self._lock:
            if not self._active:
                return
            self._remaining -= 1
            if self._remaining > 0:
                return
            import torch

            if torch.cuda.is_available():
                torch.cuda.synchronize()
            prof, self._prof = self._prof, None
            prof.stop()
            prof.export_chrome_trace(
                str(self.last_capture_dir / TRACE_FILE))
            self._active = False
            self._remaining = 0
            self.n_captures += 1
