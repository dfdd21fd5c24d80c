"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the CUDA card; the CPU only when asked for by name.

    Raises when CUDA is asked for (explicitly or by default) and no CUDA
    device is present: nothing silently moves to the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def scalar(x: float, device: str | torch.device) -> torch.Tensor:
    """``x`` as a 0-d float32 tensor on ``device``, made by a fill kernel
    whose value is an argument of the launch. ``torch.tensor(x,
    device=...)`` would copy it from the host instead, and that copy waits
    until the device queue has drained. The value is the same: ``x``
    rounded to nearest float32."""
    return torch.full((), x, dtype=torch.float32, device=device)
