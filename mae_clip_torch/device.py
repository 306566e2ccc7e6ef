"""Device selection: the port runs on the card unless the caller asks for the CPU."""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no card
    is present (there is no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but no CUDA card is "
                           "present; pass device='cpu' to run on the CPU")
    return dev
