"""Hash dropout's masked multiply on the card: the wrapper of csrc/hash_dropout.cu.

`hash_dropout_cuda(x, seed, thresh, scale, offset, row)` is
`where(keep, x, 0) * scale` at x's dtype in one launch, keep being the counter
hash of ops/hash_dropout.py (the plain version, `hash_dropout_plain`, which
CPU tensors take): element i counts as offset + i, or with `row=(w, W)` as
offset + (i // w) * W + i % w, in wrapping uint32. `thresh` is
`keep_threshold(rate)` and `scale` `keep_scale(rate, x.dtype)`; ops/hash_dropout.py's
`_drop` passes both, after its checks of the span (`_check_span`).

The kernel takes float32 and bfloat16 on the card, and reads the int32 seed at
its device address, so a captured launch reads the seed its buffer holds at
replay. Launches are counted in `hash_dropout_cuda.launches` and their
elements under "hash_dropout.kernel" in utils/profiling.py's root recorder,
when Python runs the call: an eager step or a graph's capture, never a replay.
"""

from __future__ import annotations

import ctypes

import torch

from rqvae_tpu_torch.ops.cuda._build import check_launch, launch_operand, load_library
from rqvae_tpu_torch.utils import profiling

_C = ctypes.c_void_p
_U = ctypes.c_uint
_FUNCTIONS = {"hash_dropout": [ctypes.c_int, _C, _C, ctypes.c_ulonglong, _C, _U, _U, _U, _U, ctypes.c_float, _C]}
DTYPES = (torch.float32, torch.bfloat16)


def _check(x: torch.Tensor, seed: torch.Tensor, thresh: int, offset: int, row) -> tuple:
    """(w, W) for the launch (0, 0: the plain layout), after refusing what
    the kernel does not take; everything but the device is checked first."""
    if x.dtype not in DTYPES:
        raise ValueError(f"the hash-dropout kernel takes float32 or bfloat16, got {x.dtype}")
    if not 0 <= offset < 2**32 or not 0 <= thresh < 2**32:
        raise ValueError(f"offset {offset} and threshold {thresh} are uint32 values")
    w, W = (0, 0) if row is None else (int(row[0]), int(row[1]))
    if row is not None and not 1 <= w <= W < 2**32:
        raise ValueError(f"rows of {w} in a global row of {W}: want 1 <= w <= W < 2^32")
    if seed.numel() != 1 or seed.dtype != torch.int32:
        raise ValueError(f"the seed is a 1-element int32 tensor, got {seed.dtype} {tuple(seed.shape)}")
    if x.device.type != "cuda" or seed.device != x.device:
        raise ValueError(f"the hash-dropout kernel takes x and its seed on one CUDA device, got {x.device}, "
                         f"{seed.device}")
    return w, W


def hash_dropout_cuda(x: torch.Tensor, seed: torch.Tensor, thresh: int, scale: float, offset: int = 0,
                      row=None) -> torch.Tensor:
    """where(keep, x, 0) * scale at x's dtype, a fresh contiguous tensor of
    x's shape (a strided or unaligned x is launched from a contiguous copy, so
    the counter follows the logical index)."""
    w, W = _check(x, seed, thresh, offset, row)
    x = launch_operand(x)
    y = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return y
    lib = load_library("hash_dropout", _FUNCTIONS)
    with torch.cuda.device(x.device):  # the kernel launches on the current device
        rc = lib.hash_dropout(int(x.dtype == torch.bfloat16), x.data_ptr(), y.data_ptr(), n, seed.data_ptr(),
                              offset, w, W, thresh, scale, torch.cuda.current_stream(x.device).cuda_stream)
    hash_dropout_cuda.launches += 1
    profiling.count("hash_dropout.kernel", n=n)
    check_launch(lib, rc, "hash dropout")
    return y


hash_dropout_cuda.launches = 0
