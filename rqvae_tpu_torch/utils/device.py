"""Default-device resolution for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None` means the card. A CUDA device without a card raises: there is
    no silent fallback to the CPU; pass `device="cpu"` to run there."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    if dev.type == "cuda" and dev.index is None:  # "cuda" and "cuda:0" compare equal
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
