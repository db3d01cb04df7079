"""Host-side mirror of csrc/rows_core.cuh, the tensor-core row products that
the two stack kernels share: which widths one output pass takes. Each
stack's route function (`encoder_stack_route`, `decoder_stack_route`) builds
on it."""

from __future__ import annotations

MAX_WIDTH = 384  # rows::MAX_BN: the widest output pass


def tensor_core_widths(unit: int, d: int, inner: int, dff: int) -> bool:
    """d, inner = H*dk and dff are positive multiples of `unit` (64 for the
    encoder's rows; 128 for the decoder, whose products halve across a pair
    of blocks), and d and inner are at most MAX_WIDTH."""
    return all(w >= unit and w % unit == 0 for w in (d, inner, dff)) and d <= MAX_WIDTH and inner <= MAX_WIDTH
