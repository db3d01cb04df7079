"""Default-device resolution for the port's entry points."""

from __future__ import annotations

import warnings
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


def end_failed_capture(device: torch.device) -> None:
    """Call after a CUDA graph capture on `device` failed. torch cannot end a
    capture that the device invalidated, and leaves the device's default
    generator marked as capturing: every later random op there would raise
    "Offset increment outside graph capture". Capturing nothing clears the
    mark."""
    with torch.cuda.device(device), warnings.catch_warnings():
        warnings.simplefilter("ignore")  # "The CUDA Graph is empty"
        with torch.cuda.graph(torch.cuda.CUDAGraph()):
            pass
