"""Sequence-window sampling on device tensors (port of
rqvae_tpu/data/jax_sampling.py): the integer results equal the JAX functions'
for the same draws.

  train window: over seq = items[:L-1] (leave-two-out; the whole row for the
  windows format), start ~ U[0, M-3], end ~ U[start+3, start+ml+1] clamped to
  M; history = window[:-1] right-padded with -1, target = window[-1].
"""

from __future__ import annotations

import torch


def subsample_windows_from_draws(
    u_start: torch.Tensor,  # [B] float32 uniform [0, 1) draws
    u_end: torch.Tensor,  # [B]
    seq_items: torch.Tensor,  # [R, T] -1 padded
    seq_lengths: torch.Tensor,  # [R]
    row_idx: torch.Tensor,  # [B]
    max_seq_len: int,
    leave_two_out: bool = True,
):
    """(hist [B, max_seq_len] -1 padded, fut [B]) from pre-drawn uniforms."""
    ml = max_seq_len
    row_idx = row_idx.long()
    L = seq_lengths[row_idx].long()
    M = torch.clamp(L - 1 if leave_two_out else L, min=1)
    # start in [0, M-3] and end in [start+3, start+ml+1], both ends inclusive
    starts = torch.floor(u_start * torch.clamp(M - 2, min=1)).long()
    ends = torch.minimum(starts + 3 + torch.floor(u_end * (ml - 1)).long(), M)
    n = ends - starts
    ar = torch.arange(ml, device=seq_items.device)
    grid = starts[:, None] + ar[None, :]
    ids = seq_items[row_idx[:, None], torch.clamp(grid, max=seq_items.shape[1] - 1)]
    hist = torch.where(ar[None, :] < (n - 1)[:, None], ids, -1)
    fut = seq_items[row_idx, starts + n - 1]
    return hist, fut


def eval_windows(
    seq_items: torch.Tensor,
    seq_lengths: torch.Tensor,
    row_idx: torch.Tensor,
    hist_end: torch.Tensor,  # [B] exclusive end position (the target's index)
    max_seq_len: int,
):
    """The last max_seq_len items before hist_end, the target at hist_end."""
    ml = max_seq_len
    row_idx, hist_end = row_idx.long(), hist_end.long()
    starts = torch.clamp(hist_end - ml, min=0)
    n = hist_end - starts
    ar = torch.arange(ml, device=seq_items.device)
    grid = starts[:, None] + ar[None, :]
    ids = seq_items[row_idx[:, None], torch.clamp(grid, max=seq_items.shape[1] - 1)]
    hist = torch.where(ar[None, :] < n[:, None], ids, -1)
    fut = seq_items[row_idx, hist_end]
    return hist, fut
