"""Gated feed-forward blocks: a dense SwiGLU and DeepSeek-V2's sparse-expert
layer (DeepSeek-V2, arXiv:2405.04434; the `deepseek_v2` config of
DeepSeek-V2-Lite), for the retrieval T5's blocks (models/t5.py).

SwiGLU: E(h) = W_down(SiLU(W_gate h) * W_up h), each product at the compute
dtype through `dense` (operands rounded to it, f32 sums, the result rounded
once); SiLU and the gating multiply in f32, rounded once. No dropout inside.

`MoEFFN`, per token h (the block's RMSNorm output):

- s = softmax(h W_r^T) over all `n_experts` experts, in f32 (an f32 router
  on the f32-widened h);
- T = the `top_k` largest s_i, ties to the lower index (greedy top-k);
- y = S(h) + sum over i in T that this layer holds of s_i E_i(h), with S the
  shared SwiGLU on every token (`norm_topk_prob` false, scaling 1). The
  routed sum and S(h) add in f32 and round to the compute dtype once.

Expert parallelism: a layer is told which experts it holds (`experts_held`
= (first, count)) and routes over all of them; it computes only its own
experts' part of y, as one chip of an expert-parallel deployment does, and
the part the other chips' experts would add is not computed here.

The held part is dropless at static shapes, so that a CUDA graph of the
training step holds it with no host read: the T * top_k (token, slot)
choices are sorted by held expert (a stable sort, so each expert's rows keep
token order; choices of experts held elsewhere and of padding go last), the
per-expert counts become device-side offsets, and the buffer of all T *
top_k rows goes through `torch._grouped_mm` three times. Rows past the last
offset are outside every group: the grouped products leave them unset, and
they are zeroed on the way in and out so that nothing of them reaches a
value or a gradient. The combine gathers each token's top_k rows back by
the inverse permutation (a gather, so the sums' order is fixed) and adds
them in f32 with their weights.

Padding positions (`mask` 0) are routed to no expert and left out of the
balance loss. The balance loss is DeepSeek-V2's sequence-wise one, for each
sequence b of T_b valid tokens:

  alpha * mean_b sum_i f_bi P_bi,  f_bi = E / (K T_b) * #{valid t of b: i in T_t},
                                   P_bi = mean over b's valid tokens of s_i

over all E experts (every chip computes it from its own tokens' routing).
Each forward returns, beside y, its `MoEStats`: the balance loss, the
counters (valid tokens, rows routed to the held experts, the most-loaded
held expert's rows) and each token's chosen experts, as device tensors.
They are returned and not kept on the module: a block rematerialised in
the backward pass runs its forward again, and what that run kept would hold
its activations past the step.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rqvae_tpu_torch.ops.topk import top_k
from rqvae_tpu_torch.utils import profiling

INIT_STD = 0.02  # the FFN and router weights' init (DeepSeek-V2's initializer_range)


def _f32_copy(x: torch.Tensor) -> torch.Tensor:
    """x in f32, always a new tensor (in-place work on it leaves x alone)."""
    return x.to(torch.float32, copy=True)


class _SwiGLUAct(torch.autograd.Function):
    """SiLU(gate) * up in f32, rounded once to the operands' dtype. Only the
    two operands are kept for the backward pass (at their dtype), and the
    f32 work is done in place, so that a buffer of every routed row costs
    one f32 copy at a time."""

    @staticmethod
    def forward(ctx, gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(gate, up)
        return F.silu(_f32_copy(gate), inplace=True).mul_(up).to(gate.dtype)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        gate, up = ctx.saved_tensors
        sig = torch.sigmoid(gate.float())
        d_up = _f32_copy(gate).mul_(sig).mul_(grad).to(up.dtype)  # dy * SiLU(g)
        # dy * up * SiLU'(g), SiLU'(g) = sig * (1 + g * (1 - sig))
        d_gate = torch.sub(1.0, sig).mul_(gate).add_(1.0).mul_(sig).mul_(grad).mul_(up).to(gate.dtype)
        return d_gate, d_up


class _Combine(torch.autograd.Function):
    """sum_k w[n, k] * y[n, k, :] in f32 from y [N, K, d] at the compute
    dtype and f32 weights [N, K], a slot at a time; y is kept for the
    weights' gradient at its own dtype."""

    @staticmethod
    def forward(ctx, y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(y, w)
        out = _f32_copy(y[:, 0]).mul_(w[:, :1])
        for k in range(1, y.shape[1]):
            out.addcmul_(y[:, k].float(), w[:, k:k + 1])
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        y, w = ctx.saved_tensors
        d_w = torch.stack([(y[:, k].float() * grad).sum(-1) for k in range(y.shape[1])], dim=1)
        return (grad[:, None, :] * w[..., None]).to(y.dtype), d_w


class SwiGLU(nn.Module):
    """A dense SwiGLU of width `d_ff` (the leading dense layers and the shared
    expert)."""

    def __init__(self, d_model: int, d_ff: int, device=None):
        super().__init__()
        self.w_gate = nn.Linear(d_model, d_ff, bias=False, device=device)
        self.w_up = nn.Linear(d_model, d_ff, bias=False, device=device)
        self.w_down = nn.Linear(d_ff, d_model, bias=False, device=device)

    def forward(self, x: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
        from rqvae_tpu_torch.models.t5 import dense

        a = _SwiGLUAct.apply(dense(x, self.w_gate.weight, cdt), dense(x, self.w_up.weight, cdt))
        return dense(a, self.w_down.weight, cdt)


class MoEStats(NamedTuple):
    """A MoE forward's balance loss and counters (device tensors)."""

    aux_loss: torch.Tensor  # f32 scalar (0 outside training or at alpha 0)
    counts: torch.Tensor  # f32 [3]: valid tokens, rows to held experts, the most-loaded held expert's rows
    chosen: Optional[torch.Tensor] = None  # [N, K] each token's experts (a layer's; padding's unused)


def _route_span():
    """`moe.route` around the routing of an eager call; nothing while a CUDA
    graph captures (no span opens inside captured code)."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        return contextlib.nullcontext()
    return profiling.span("moe.route")


class MoEFFN(nn.Module):
    """DeepSeek-V2's FFN: the router over `n_experts`, `top_k` experts a
    token, the held experts' SwiGLUs of `expert_d_ff` stacked as [E_held, d,
    f] / [E_held, f, d] parameters, and a shared SwiGLU of `shared_d_ff`."""

    def __init__(self, d_model: int, n_experts: int, top_k: int, expert_d_ff: int, shared_d_ff: int,
                 experts_held: Tuple[int, int], aux_loss_alpha: float, device=None):
        super().__init__()
        first, count = experts_held
        if not (0 <= first and 1 <= count and first + count <= n_experts):
            raise ValueError(f"experts_held {experts_held} is not a window of the {n_experts} experts")
        if not 1 <= top_k <= n_experts:
            raise ValueError(f"top_k {top_k} outside 1..{n_experts}")
        if shared_d_ff < 1:
            raise ValueError(f"shared_d_ff {shared_d_ff}: a MoE layer has its shared expert")
        self.n_experts, self.k, self.first, self.count = n_experts, top_k, first, count
        self.alpha = aux_loss_alpha
        self.router = nn.Parameter(torch.empty(n_experts, d_model, device=device))
        self.w_gate = nn.Parameter(torch.empty(count, d_model, expert_d_ff, device=device))
        self.w_up = nn.Parameter(torch.empty(count, d_model, expert_d_ff, device=device))
        self.w_down = nn.Parameter(torch.empty(count, expert_d_ff, d_model, device=device))
        self.shared = SwiGLU(d_model, shared_d_ff, device)

    def route(self, h: torch.Tensor, valid: torch.Tensor):
        """h [N, d], valid [N] bool -> (s [N, E] f32, chosen [N, K], their
        weights [N, K] f32, the held expert of each choice [N, K] (count:
        none held here, or padding))."""
        s = torch.softmax(F.linear(h.float(), self.router.float()), dim=-1)
        weight, chosen = top_k(s, self.k)
        local = chosen - self.first
        held = (local >= 0) & (local < self.count) & valid[:, None]
        return s, chosen, weight, torch.where(held, local, self.count)

    def balance_loss(self, s: torch.Tensor, chosen: torch.Tensor, valid: torch.Tensor, rows: int) -> torch.Tensor:
        """The sequence-wise balance loss over `rows` sequences of the N
        tokens (row-major), padding left out."""
        E, K = self.n_experts, self.k
        v = valid.float().reshape(rows, -1, 1)
        picked = torch.zeros_like(s).scatter_(1, chosen, 1.0).reshape(rows, -1, E)
        n_valid = v.sum(1).clamp(min=1.0)  # [rows, 1]
        f = (picked * v).sum(1) * (E / K) / n_valid
        p = (s.reshape(rows, -1, E) * v).sum(1) / n_valid
        return self.alpha * (f * p).sum(1).mean()

    def forward(self, x: torch.Tensor, cdt: torch.dtype, mask: Optional[torch.Tensor] = None,
                training: bool = False) -> Tuple[torch.Tensor, MoEStats]:
        """x [B, T, d] -> ([B, T, d] at cdt, stats); `mask` [B, T] (1 = a token) or None."""
        B, T, d = x.shape
        N, K, C = B * T, self.k, self.count
        h = x.reshape(N, d).to(cdt)
        valid = (torch.ones(N, dtype=torch.bool, device=x.device) if mask is None
                 else mask.reshape(N) != 0)
        with _route_span():
            s, chosen, weight, key = self.route(h, valid)
            flat = key.reshape(N * K)
            order = torch.sort(flat, stable=True).indices  # held experts' rows in token order, the rest last
            counts = torch.zeros(C + 1, dtype=torch.long, device=x.device).scatter_add_(0, flat, torch.ones_like(flat))
            offs = torch.cumsum(counts[:C], 0).to(torch.int32)
            inverse = torch.empty_like(order).scatter_(0, order, torch.arange(N * K, device=x.device))
        inside = (torch.arange(N * K, device=x.device) < offs[-1])[:, None]
        rows = h.unsqueeze(1).expand(N, K, d).reshape(N * K, d).index_select(0, order)
        rows = torch.where(inside, rows, torch.zeros((), dtype=cdt, device=x.device))
        w_gate, w_up, w_down = (w.to(cdt) for w in (self.w_gate, self.w_up, self.w_down))
        a = _SwiGLUAct.apply(torch._grouped_mm(rows, w_gate, offs=offs), torch._grouped_mm(rows, w_up, offs=offs))
        y = torch.where(inside, torch._grouped_mm(a, w_down, offs=offs), torch.zeros((), dtype=cdt, device=x.device))
        routed = _Combine.apply(y.index_select(0, inverse).reshape(N, K, d), torch.where(key < C, weight, 0.0))
        routed = routed + self.shared(h, cdt).float()
        aux = (self.balance_loss(s, chosen, valid, B) if training and self.alpha > 0.0
               else torch.zeros((), device=x.device))
        held_rows = counts[:C].float()
        stats = MoEStats(aux, torch.stack([valid.float().sum(), held_rows.sum(), held_rows.max()]), chosen)
        return routed.to(cdt).reshape(B, T, d), stats
