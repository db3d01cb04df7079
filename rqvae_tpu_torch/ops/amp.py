"""bf16 operands with float32 sums on the card: the products of `amp=True`
and of `models/t5.py::dense` at bf16, one autograd Function for both.

`amp=True` training products are the counterpart of the JAX trainers'
`jax_default_matmul_precision="bfloat16"` (rqvae_tpu/train/train_rqvae.py:
109-110, train_decoder.py:112-113). Inside `bf16_products(True)` and on the
card, the trainable products that JAX's flag reaches run with their operands
rounded to bf16 and their sums and outputs in float32, in the forward and in
both backward products:

- the Linear layers of the RQ-VAE's MLPs (models/mlp.py);
- `models/t5.py::dense` at `t5_dtype="float32"`;
- the retrieval model's output heads (models/retrieval.py).

`models/t5.py::dense` at `t5_dtype="bfloat16"` on the card takes the same
products with a bf16 output (`bf16_linear(x, w, torch.bfloat16)`), the JAX
package's `nn.Dense(dtype=bfloat16)`: operands rounded to bf16, float32 sums,
the output rounded to bf16 once; dX and dW each rounded to bf16 once too, then
carried to x's and the parameter's dtype, where the backward of the rounded
operands puts them.

Each product is counted in utils/profiling.py's root recorder, with n = its
multiply-adds: "dense.bf16" for a bf16 output, "amp.bf16" for a float32 one.
They tick when Python runs the product: an eager step or a graph's capture, a
rematerialised forward, never a replay.

A float32 output is `torch.mm` / `torch.bmm(a_bf16, b_bf16,
out_dtype=float32)`; a bf16 output is the bf16 `torch.mm`, which sums in
float32 and rounds once as it writes, with `torch.backends.cuda.matmul.
allow_bf16_reduced_precision_reduction` off for that call alone, so a split-K
product keeps its partial sums in float32 (cuBLAS on the tensor cores either
way; the two forms give the same bits at the cells' shapes,
tests/test_torch_kernels_gpu.py). The backward is written out (two such
products) rather than left to autograd, and only the bf16 operands are saved
for it. The bf16 copies are made from the live tensors at every call, so a
captured step graph rounds the parameters of the step it replays: nothing is
cached across optimizer updates.

On the CPU nothing takes this route (`aten::mm.dtype` has no CPU kernel):
amp's products stay float32, as JAX's flag changes nothing there, and `dense`
keeps its float32 product of the rounded operands. The quantizer's distances
and codebook lookups, k-means and every evaluation are left in float32; the
attention kernels keep the route their operand dtype picks.

The flag is process-wide, not per thread, and torch takes no per-call
setting. Threads that launch bf16 products at once: the caller's (a step
body, or serving's queue worker, which launches the engine's calls) and
autograd's backward thread, which also runs a rematerialised block's second
forward; a data-parallel rank is a process of its own. So a bf16-output
product sets the flag and puts it back under `_FLAG`, in whichever thread
runs it, and `bf16_products(True)`, which keeps it off around the trainers'
step bodies (train/decoder_steps.py, train/rqvae_steps.py), takes the same
lock to set and restore it. No product that reads the flag runs outside the lock: every
cuBLAS product of bf16 operands in the package goes through `_product`; the
others take float32 operands, which the flag does not reach, and the routed
experts' `torch._grouped_mm` (models/moe.py) is a CUTLASS kernel that does not
read it (its bits are the same either way on the H100). The lock is held for
the launch alone, which returns before the card runs the product, so the
threads wait for each other's host calls of a few microseconds, not for the
products.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator

import torch
import torch.nn.functional as F

from rqvae_tpu_torch.utils import profiling

_enabled = False
_FLAG = threading.Lock()  # held while allow_bf16_reduced_precision_reduction is changed or relied on


@contextlib.contextmanager
def bf16_products(enabled: bool = True) -> Iterator[None]:
    """Run the products listed above in bf16 with float32 sums on the card."""
    global _enabled
    matmul = torch.backends.cuda.matmul
    with _FLAG:
        saved = (_enabled, matmul.allow_bf16_reduced_precision_reduction)
        _enabled = bool(enabled)
        if enabled:
            matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        with _FLAG:
            _enabled, matmul.allow_bf16_reduced_precision_reduction = saved


def on_card(x: torch.Tensor) -> bool:
    """Whether x lies on the card, where these products run."""
    return x.is_cuda


def active(x: torch.Tensor) -> bool:
    """Whether an amp product of `x` takes the bf16 route: the flag is on
    and x lies on the card."""
    return _enabled and on_card(x)


def _mm(a16: torch.Tensor, b16: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """The card's product of bf16 operands, float32 sums, written out in
    `out_dtype` (float32 or bf16)."""
    mm = torch.bmm if a16.dim() == 3 else torch.mm
    return mm(a16, b16, out_dtype=torch.float32) if out_dtype == torch.float32 else mm(a16, b16)


def _product(a16: torch.Tensor, b16: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    macs = a16.numel() * b16.shape[-1]
    if out_dtype == torch.float32:
        profiling.count("amp.bf16", n=macs)
        return _mm(a16, b16, out_dtype)
    profiling.count("dense.bf16", n=macs)
    matmul = torch.backends.cuda.matmul
    with _FLAG:
        saved = matmul.allow_bf16_reduced_precision_reduction
        matmul.allow_bf16_reduced_precision_reduction = False
        try:
            return _mm(a16, b16, out_dtype)
        finally:
            matmul.allow_bf16_reduced_precision_reduction = saved


class _Bf16Matmul(torch.autograd.Function):
    """a @ b for [M, K] x [K, N] (or batched [G, M, K] x [G, K, N]): bf16
    operands, float32 sums, the output rounded to `out_dtype` once;
    dA = g b^T and dB = a^T g the same way, each then carried to its
    input's dtype. dB is laid out as autograd's own `mm` lays it out: for a
    transposed b (a weight's `.t()`) it is computed as (g^T a)^T, in the
    weight's own layout."""

    @staticmethod
    def forward(ctx, a: torch.Tensor, b: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
        a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
        ctx.save_for_backward(a16, b16)
        ctx.out_dtype, ctx.dtypes = out_dtype, (a.dtype, b.dtype)
        return _product(a16, b16, out_dtype)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        a16, b16 = ctx.saved_tensors
        g16, out = g.to(torch.bfloat16), ctx.out_dtype
        da = db = None
        if ctx.needs_input_grad[0]:
            da = _product(g16, b16.transpose(-1, -2), out).to(ctx.dtypes[0])
        if ctx.needs_input_grad[1]:
            if b16.dim() == 2 and b16.stride(0) == 1:  # column-major: a weight's transpose
                db = _product(g16.t(), a16, out).t()
            else:
                db = _product(a16.transpose(-1, -2), g16, out)
            db = db.to(ctx.dtypes[1])
        return da, db, None


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b (2-D, or 3-D batched): bf16 operands with float32 sums when
    `active(a)`, else the plain float32 product."""
    if not active(a):
        return a @ b
    return _Bf16Matmul.apply(a, b, torch.float32)


def linear(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """x @ weight.T over x's last dimension (weight [out, in], nn.Linear's
    layout): bf16 operands with float32 sums when `active(x)`, else
    `F.linear`."""
    if not active(x):
        return F.linear(x, weight)
    return bf16_linear(x, weight, torch.float32)


def bf16_linear(x: torch.Tensor, weight: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """x @ weight.T over x's last dimension on the card: bf16 operands,
    float32 sums, the output (and in the backward dX and dW) rounded to
    `out_dtype` once."""
    y = _Bf16Matmul.apply(x.reshape(-1, x.shape[-1]), weight.t(), out_dtype)
    return y.reshape(*x.shape[:-1], weight.shape[0])
