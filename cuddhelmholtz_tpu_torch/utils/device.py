"""The device an entry point or operator builder runs on."""

from __future__ import annotations

import torch


def check_device(device) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks for
    the CPU.  A CUDA device that is not there raises; nothing falls back."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but no CUDA device is available; "
            "pass device='cpu' to run on the CPU"
        )
    return device
