"""`amp=True` training products: bf16 operands, float32 sums (the counterpart
of the JAX trainers' `jax_default_matmul_precision="bfloat16"`,
rqvae_tpu/train/train_rqvae.py:109-110, train_decoder.py:112-113).

Inside `bf16_products(True)` and on the card, the trainable products that
JAX's flag reaches run with their operands rounded to bf16 and their sums and
outputs in float32, in the forward and in both backward products:

- the Linear layers of the RQ-VAE's MLPs (models/mlp.py);
- `models/t5.py::dense` at `t5_dtype="float32"`;
- the retrieval model's output heads (models/retrieval.py).

Each is `torch.mm` / `torch.bmm(a_bf16, b_bf16, out_dtype=torch.float32)`
(cuBLAS), with `torch.backends.cuda.matmul.allow_bf16_reduced_precision_
reduction` off while the flag is on, so split-K partial sums stay float32.
The backward is written out (two such products) rather than left to the
autograd of `out_dtype`. The bf16 copies are made from the live float32
tensors at every call, so a captured step graph rounds the parameters of the
step it replays: nothing is cached across optimizer updates.

On the CPU the flag changes nothing, as JAX's flag changes nothing there: the
products stay float32 (`aten::mm.dtype` has no CPU kernel). The quantizer's
distances and codebook lookups, k-means and every evaluation are left in
float32; the attention kernels keep the route their operand dtype picks.

The flag is process-wide, not per thread: autograd runs the backward pass,
and a rematerialised block's forward, on its own threads. The trainers set
it around their step bodies only (train/decoder_steps.py,
train/rqvae_steps.py).
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch
import torch.nn.functional as F

_enabled = False
products = 0  # bf16 products launched (at capture, in a step graph: a replay does not tick it)


@contextlib.contextmanager
def bf16_products(enabled: bool = True) -> Iterator[None]:
    """Run the products listed above in bf16 with float32 sums on the card."""
    global _enabled
    matmul = torch.backends.cuda.matmul
    saved = (_enabled, matmul.allow_bf16_reduced_precision_reduction)
    _enabled = bool(enabled)
    if enabled:
        matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        _enabled, matmul.allow_bf16_reduced_precision_reduction = saved


def active(x: torch.Tensor) -> bool:
    """Whether a product of `x` takes the bf16 route: the flag is on and x
    lies on the card."""
    return _enabled and x.is_cuda


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    global products
    products += 1
    return (torch.bmm if a.dim() == 3 else torch.mm)(a, b, out_dtype=torch.float32)


class _Bf16Matmul(torch.autograd.Function):
    """a @ b for [M, K] x [K, N] (or batched [G, M, K] x [G, K, N]) float32
    tensors: bf16 operands, float32 sums and output; dA = g b^T and
    dB = a^T g the same way."""

    @staticmethod
    def forward(ctx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
        ctx.save_for_backward(a16, b16)
        return _mm(a16, b16)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        a16, b16 = ctx.saved_tensors
        g16 = g.to(torch.bfloat16)
        da = _mm(g16, b16.transpose(-1, -2)) if ctx.needs_input_grad[0] else None
        db = _mm(a16.transpose(-1, -2), g16) if ctx.needs_input_grad[1] else None
        return da, db


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b (2-D, or 3-D batched): bf16 operands with float32 sums when
    `active(a)`, else the plain float32 product."""
    if not active(a):
        return a @ b
    return _Bf16Matmul.apply(a, b)


def linear(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """x @ weight.T over x's last dimension (weight [out, in], nn.Linear's
    layout): bf16 operands with float32 sums when `active(x)`, else
    `F.linear`."""
    if not active(x):
        return F.linear(x, weight)
    y = _Bf16Matmul.apply(x.reshape(-1, x.shape[-1]), weight.t())
    return y.reshape(*x.shape[:-1], weight.shape[0])
