"""The retrieval T5 with DeepSeek-V2's FFN blocks (arXiv:2405.04434; the
DeepSeek-V2-Lite config), plain and in float32: reference/t5.py's model with
its `ffn` replaced, for the benchmark's sparse-expert cells. It imports
nothing of the program.

- block i < first_k_dense: a dense SwiGLU, W_down(SiLU(W_gate h) * W_up h);
- every later block: s = softmax(h W_r^T) over all n_experts experts, the
  top_k largest (ties to the lower index), y = S(h) + sum over the chosen
  experts that this chip holds (`experts_held` = (first, count)) of
  s_i E_i(h), with S the shared SwiGLU; padding tokens choose no expert.
  The held experts are looped over with masks; no grouped products;
- a gated FFN drops nothing inside (its inner site is unused);
- the balance loss of every MoE block, alpha * mean_b sum_i f_bi P_bi, with
  f_bi = E / (K T_b) * (b's valid tokens choosing i), P_bi = the mean of s_i
  over b's valid tokens.

Two things serve the comparison at the cell's size. A forward may take rows
row0 .. row0 + B - 1 of a larger batch: every dropout site then counts from
that row's first element, so a batch taken in blocks of rows draws the
whole batch's masks (the counter of an element is its linear index in the
whole batch's array). And `follow`, when given, holds the experts each MoE
block's tokens chose in the program, in block order, which the model then
uses in place of its own top_k (as the training reference follows the
program's index); its own top_k is kept beside (`own`) for `route_differ`.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from perfbench.reference import hashing
from perfbench.reference.t5 import T5


class T5MoE(T5):
    """`cfg`: reference/t5.py's sizes and the `moe` group's (first_k_dense,
    n_experts, experts_per_token, expert_d_ff, shared_d_ff, experts_held,
    aux_loss_alpha)."""

    def __init__(self, weights: dict, cfg: dict, moe: dict, L: int, K: int, prec, rate: float = 0.0):
        super().__init__(weights, cfg, L, K, prec, rate)
        self.moe = moe
        self.row0 = 0
        self.follow: Optional[List[torch.Tensor]] = None  # per MoE block: [tokens, K] expert ids
        self.reset()

    def reset(self) -> None:
        """Before a forward: the balance losses, choices used and own top_k of its MoE blocks."""
        self.aux: List[torch.Tensor] = []
        self.used: List[torch.Tensor] = []
        self.own: List[torch.Tensor] = []
        self._valid: Optional[torch.Tensor] = None

    def _drop(self, x, seeds, site):
        if seeds is None or self.rate == 0.0:
            return x
        per_row = x[0].numel()
        counter = torch.arange(x.numel(), dtype=torch.int64, device=x.device) + self.row0 * per_row
        keep = hashing.keep_bits(counter, seeds[site], self.rate).reshape(x.shape)
        return torch.where(keep, x, torch.zeros((), dtype=x.dtype, device=x.device)) * (1.0 / (1.0 - self.rate))

    def encoder(self, x, mask, seeds=None):
        self._valid = mask
        return super().encoder(x, mask, seeds)

    def decoder(self, x, enc, enc_mask, seeds=None):
        self._valid = None  # a decoder's positions are all tokens
        return super().decoder(x, enc, enc_mask, seeds)

    def _swiglu(self, h: torch.Tensor, gate, up, down) -> torch.Tensor:
        p = self.prec
        return p.linear(torch.nn.functional.silu(p.linear(h, gate)) * p.linear(h, up), down)

    def ffn(self, pre: str, x: torch.Tensor, seeds, site: int) -> torch.Tensor:
        layer = int(pre.split(".")[2])
        if layer < self.moe["first_k_dense"]:
            return self._swiglu(x, self.w[pre + "w_gate.weight"], self.w[pre + "w_up.weight"],
                                self.w[pre + "w_down.weight"])
        return self._moe(pre, x)

    def _moe(self, pre: str, x: torch.Tensor) -> torch.Tensor:
        m, w = self.moe, self.w
        B, T, d = x.shape
        h = x.reshape(B * T, d)
        valid = (torch.ones(B * T, dtype=torch.bool, device=x.device) if self._valid is None
                 else self._valid.reshape(-1))
        s = torch.softmax(self.prec.linear(h, w[pre + "router"]), dim=-1)
        own = torch.sort(s.detach(), dim=-1, descending=True, stable=True).indices[:, :m["experts_per_token"]]
        chosen = own if self.follow is None else self.follow[len(self.used)].to(x.device).long()
        self.own.append(own)
        self.used.append(chosen)
        y = self._swiglu(h, w[pre + "shared.w_gate.weight"], w[pre + "shared.w_up.weight"],
                         w[pre + "shared.w_down.weight"])
        first, count = m["experts_held"]
        for e in range(count):
            rows = ((chosen == first + e) & valid[:, None]).any(1).nonzero()[:, 0]
            if rows.numel():
                out = self._swiglu(h[rows], w[pre + "w_gate"][e].t(), w[pre + "w_up"][e].t(), w[pre + "w_down"][e].t())
                y = y.index_add(0, rows, s[rows, first + e][:, None] * out)
        E, k = m["n_experts"], m["experts_per_token"]
        v = valid.float().reshape(B, T, 1)
        n = v.sum(1).clamp(min=1.0)
        picked = torch.zeros_like(s).scatter(1, chosen, 1.0).reshape(B, T, E)
        f = (picked * v).sum(1) * (E / k) / n
        p = (s.reshape(B, T, E) * v).sum(1) / n
        self.aux.append(m["aux_loss_alpha"] * (f * p).sum(1))  # per row: the batch's mean is taken by the caller
        return y.reshape(B, T, d)
