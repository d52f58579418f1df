"""Device resolution and host-to-device uploads shared by the port."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Raises when CUDA is asked for (explicitly or by default) and
    none is present — the port never carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "deeplearning4j_tpu_torch runs on a CUDA device by default and "
            "none is available; pass device='cpu' to run the plain PyTorch "
            "versions of its kernels on the host"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def synchronize(device: torch.device) -> None:
    """Waits for the work queued on ``device`` (nothing to wait for off
    CUDA): a host clock read after it covers that work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``. On CUDA the copy goes through pinned
    memory without blocking: a pageable upload would wait for all the work
    queued ahead of it and stall a pipelined caller."""
    t = torch.from_numpy(arr)
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)
