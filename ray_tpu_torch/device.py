"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, raising if it names CUDA and no CUDA device
    is present.  The port's entry points default to ``"cuda"`` and never fall
    back to the CPU: a caller that wants the CPU asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev
