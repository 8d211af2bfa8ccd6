"""Where an entry point of the port runs."""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str | None) -> torch.device:
    """The device an entry point runs on: ``cuda`` when the caller names
    none. Raises where a CUDA device is asked for (by name or by default)
    and there is none; ``"cpu"`` asks for the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev
