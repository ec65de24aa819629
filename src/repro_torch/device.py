"""Device resolution shared by every entry point of the port.

The port runs on CUDA. The CPU is taken only when the caller names it
(the CPU tests do, and there every kernel wrapper uses its plain PyTorch
version). Without a card and without an explicit device the entry points
raise instead of carrying on silently on the CPU."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """`None` -> cuda (raises RuntimeError when CUDA is unavailable);
    anything else is taken as given, "cuda" with the current device's
    index (tensors made on it report one, and engines compare devices)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain PyTorch path explicitly")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev
