"""The reference's products: float32 (TF32 off), or the control's fp8.

The control is the reference computed one precision below the configuration's
bfloat16: every operand of every product (projections, attention, heads,
distances, and in training the backward's products too) rounded to
float8_e4m3fn with one scale per tensor (its largest magnitude to 448),
products summed in float32. Everything else stays float32.
"""

from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to e4m3 under a per-tensor scale, back in float32."""
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    return (x.float() / scale).to(torch.float8_e4m3fn).float() * scale


class _Fp8MatMul(torch.autograd.Function):
    """a @ b with both operands in fp8, and the backward's products too."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = round_fp8(a), round_fp8(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = round_fp8(g)
        ga = qg @ qb.transpose(-1, -2)
        gb = qa.transpose(-1, -2) @ qg
        # broadcast operands (a 2-D weight against a batch) sum their gradient
        while ga.dim() > qa.dim():
            ga = ga.sum(0)
        while gb.dim() > qb.dim():
            gb = gb.sum(0)
        return ga, gb


class Precision:
    """`matmul(a, b)` and `linear(x, w)` (x @ w.T) at float32 or fp8."""

    def __init__(self, name: str = "f32"):
        if name not in ("f32", "fp8"):
            raise ValueError(f"precision f32 or fp8, got {name!r}")
        self.name = name

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.name == "fp8":
            return _Fp8MatMul.apply(a, b)
        return a.float() @ b.float()

    def linear(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        y = self.matmul(x.reshape(-1, x.shape[-1]), w.t())
        return y.reshape(*lead, w.shape[0])


@contextlib.contextmanager
def exact_float32():
    """TF32 off for the block (a float32 product on the card may otherwise
    run in TF32)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
