"""Embedding lookup with a matmul backward (port of rqvae_tpu/ops/embedding.py).

The gradient of `table[ids]` is `one_hot(ids)^T @ g`: a dense product in place
of a scatter-add, exact up to the order of the float32 sum. For small
vocabularies (the one-hot is [positions, vocab]): the semantic-id embedding
and the [32, H] relative-position table.
"""

from __future__ import annotations

import torch


def one_hot(ids: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """[..., n] one-hot rows of integer `ids` at `dtype`, by comparison with
    an iota on the ids' device (F.one_hot checks its ids' range on the host
    for CPU tensors; this reads nothing back anywhere)."""
    return (ids.long()[..., None] == torch.arange(n, device=ids.device)).to(dtype)


class _EmbeddingLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.vocab, ctx.table_dtype = table.shape[0], table.dtype
        return table[ids]

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        # a bf16 gradient takes a bf16 one-hot, any other a float32 one; the
        # products are summed in float32 and rounded to the table's dtype
        dt = torch.bfloat16 if g.dtype == torch.bfloat16 else torch.float32
        onehot = one_hot(ids.reshape(-1), ctx.vocab, dt)
        flat_g = g.reshape(-1, g.shape[-1]).to(dt)
        return (onehot.float().t() @ flat_g.float()).to(ctx.table_dtype), None


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table [V, D], ids int[...] -> [..., D]."""
    return _EmbeddingLookup.apply(table, ids.long())
