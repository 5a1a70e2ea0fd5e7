"""Device selection: CUDA by default, the CPU only when the caller asks."""
from __future__ import annotations

import numpy as np
import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The torch.device an entry point runs on. Raises when CUDA is asked
    for and absent: nothing quietly runs on the CPU."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on `device` without waiting for the copy: on CUDA it is
    staged in pinned memory and copied asynchronously on the current
    stream (a pageable copy would synchronize the stream); on the CPU the
    tensor shares a's memory."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)
