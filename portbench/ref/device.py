"""Device and dtype rules shared by every entry point of the port."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. ``cuda`` without a card raises:
    the port never falls back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the port on "
                "the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


def default_dtype(device: torch.device) -> torch.dtype:
    """float64 on the CPU (parity with the JAX package), float32 on the card."""
    return torch.float32 if device.type == "cuda" else torch.float64


def same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.type == "cpu" or a.index == b.index)


def check_device(device: torch.device, **tensors) -> None:
    """Raises unless every given tensor lies on ``device``."""
    for name, t in tensors.items():
        if t is not None and not same_device(t.device, device):
            raise ValueError(f"{name} is on {t.device}, expected {device}")


def synchronize(device: torch.device) -> None:
    """Waits for the card's queued work (host clocks end here); a no-op on
    the CPU."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
