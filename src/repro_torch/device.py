"""Device resolution shared by every entry point of the port.

Entry points run on the card unless the caller asks for the CPU: the
default ``device="cuda"`` raises when CUDA is missing instead of carrying
on silently on the CPU.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and there
    is none. ``None`` means the default, the card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on the card by default but CUDA is not "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (expected cuda or cpu)")
    return dev
