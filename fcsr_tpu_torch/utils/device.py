"""Device selection for the port's entry points.

Entry points (``GSRNet``, ``GSRFoldRunner``, ``train_step_fused``) run on
the card unless the caller asks for the CPU. There is no silent fallback:
asking for CUDA on a machine without a card raises.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["DEFAULT_DEVICE", "resolve_device", "check_on_device",
           "on_device"]

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``torch.device`` for ``device``; raises if it names CUDA and no card
    is visible (pass ``device="cpu"`` for the plain PyTorch path)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} requested but no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch path on the host")
    return dev


def check_on_device(what: str, device, *tensors) -> torch.device:
    """Resolve ``device`` and raise unless every tensor lies on a device of
    that type (an entry point never moves its arguments)."""
    dev = resolve_device(device)
    for t in tensors:
        if t.device.type != dev.type:
            raise ValueError(f"{what}(device={device!r}) got a tensor on "
                             f"{t.device}")
    return dev


def on_device(device):
    """Context in which ``device`` is the current CUDA device (kernels
    launch on the current device's stream); nothing for the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()
