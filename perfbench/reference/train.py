"""A stage-2 training step, plain: the window of each row, its tokens, the
loss and its gradients, and AdamW as optax's `adamw` defines it.

Windows (leave-two-out rows: the last item is held out, so a row of length
n trains over its first M = n - 1 items): from float32 uniforms u, v, the
window starts at floor(u * max(M - 2, 1)) and ends (exclusive) at
min(start + 3 + floor(v * (S - 1)), M), S the history length; its last item
is the target, the rest the history, -1 padded to S.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from perfbench.reference.t5 import T5


def windows(items: torch.Tensor, lengths: torch.Tensor, rows: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
            S: int):
    """(history [B, S] -1 padded, target [B]) item ids."""
    rows = rows.long()
    M = (lengths[rows].long() - 1).clamp(min=1)
    start = torch.floor(u.float() * (M - 2).clamp(min=1)).long()
    end = torch.minimum(start + 3 + torch.floor(v.float() * (S - 1)).long(), M)
    n = end - start
    pos = torch.arange(S, device=items.device)
    take = (start[:, None] + pos[None, :]).clamp(max=items.shape[1] - 1)
    hist = torch.where(pos[None, :] < (n - 1)[:, None], items[rows[:, None], take], -1)
    return hist, items[rows, start + n - 1]


def tokens(table: torch.Tensor, hist: torch.Tensor, target: torch.Tensor, L: int):
    """Item ids -> (ids [B, S, L] -1 where padded, mask [B, S, L], target ids [B, L])."""
    N = table.shape[0]
    mask = (hist >= 0)[:, :, None].expand(-1, -1, L)
    ids = torch.where(mask, table[hist.clamp(0, N - 1)][:, :, :L], -1)
    return ids, mask, table[target.clamp(0, N - 1)][:, :L]


def step_loss(model: T5, table, items, lengths, draws: Dict[str, torch.Tensor], S: int,
              seeds: Sequence[int], keep_rows=None) -> List[torch.Tensor]:
    """The per-level losses of one step's draws. `keep_rows`, a fault for the
    check's own test: the loss over those rows only."""
    rows, u, v = draws["row_idx"], draws["u_start"], draws["u_end"]
    if keep_rows is not None:
        rows, u, v = rows[keep_rows], u[keep_rows], v[keep_rows]
    hist, target = windows(items, lengths, rows, u, v, S)
    ids, mask, tgt = tokens(table, hist, target, model.L)
    return model.loss(ids, mask, tgt, seeds)


class AdamW:
    """optax.adamw: decoupled decay lr * wd * p, eps outside the root."""

    def __init__(self, params: List[torch.Tensor], lr: float, weight_decay: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params, self.lr, self.wd, self.b1, self.b2, self.eps = params, lr, weight_decay, b1, b2, eps
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        self.t += 1
        c1, c2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            update = (m / c1) / ((v / c2).sqrt() + self.eps) + self.wd * p
            p.sub_(self.lr * update)
