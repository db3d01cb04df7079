"""The retrieval T5 with DeepSeek-V2's FFN blocks, plain and in float32: the
tests' reference for rqvae_tpu_torch/models/moe.py and the MoE stacks of
models/t5.py. Plain `torch` operations only; it imports nothing of JAX, of
rqvae_tpu or of the port, and leaves TF32 off.

Weights are the port's state dict (names as EncoderDecoderRetrievalModel
gives them). The model, as TIGER's T5 (RMSNorm before each sublayer, no
1/sqrt(d_kv) scale, T5's relative position bias from each stack's first
block, -1e9 masks) with DeepSeek-V2's FFN (arXiv:2405.04434):

- block i < first_k_dense: a dense SwiGLU, W_down(SiLU(W_gate h) * W_up h);
- every later block: s = softmax(h W_r^T) over all n_experts experts; the
  top_k largest, ties to the lower index; y = S(h) + sum over the chosen
  experts among `experts_held` of s_i E_i(h), S the shared SwiGLU. Padding
  tokens choose no expert. The held experts are looped over with masks (no
  grouped products);
- the balance loss of each MoE block, alpha * mean_b sum_i f_bi P_bi, with
  f_bi = E / (K T_b) * (b's valid tokens choosing i) and P_bi the mean of s_i
  over b's valid tokens, added to the sum of the levels' mean cross-entropy.

No dropout: the tests hold the port at rate 0.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

NEG = -1e9


def rms_norm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def bucket(rel: torch.Tensor, bidirectional: bool, buckets: int = 32, max_distance: int = 128) -> torch.Tensor:
    n = -rel.long()
    out = torch.zeros_like(n)
    if bidirectional:
        buckets //= 2
        out = out + (n < 0).long() * buckets
        n = n.abs()
    else:
        n = n.clamp(min=0)
    exact = buckets // 2
    large = exact + (torch.log(n.clamp(min=1).float() / exact) / math.log(max_distance / exact)
                     * (buckets - exact)).long()
    return out + torch.where(n < exact, n, large.clamp(max=buckets - 1))


def swiglu(w: Dict[str, torch.Tensor], pre: str, h: torch.Tensor) -> torch.Tensor:
    g = h @ w[pre + "w_gate.weight"].float().t()
    u = h @ w[pre + "w_up.weight"].float().t()
    return (torch.nn.functional.silu(g) * u) @ w[pre + "w_down.weight"].float().t()


class PlainT5MoE:
    """`cfg`: d_model, num_heads, d_kv, num_layers, first_k_dense, n_experts,
    top_k, experts_held (first, count), aux_loss_alpha, eps; L levels of K
    ids."""

    def __init__(self, w: Dict[str, torch.Tensor], cfg: dict, L: int, K: int):
        self.w, self.cfg, self.L, self.K = w, cfg, L, K
        self.H, self.dk, self.d = cfg["num_heads"], cfg["d_kv"], cfg["d_model"]
        self.aux: List[torch.Tensor] = []
        self.chosen: List[torch.Tensor] = []

    def moe(self, pre: str, x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        """x [B, T, d], valid [B, T] bool."""
        cfg, w = self.cfg, self.w
        B, T, d = x.shape
        h, v = x.reshape(-1, d), valid.reshape(-1)
        s = torch.softmax(h @ w[pre + "router"].float().t(), dim=-1)
        chosen = torch.sort(s, dim=-1, descending=True, stable=True).indices[:, :cfg["top_k"]]
        self.chosen.append(chosen)
        y = swiglu(w, pre + "shared.", h)
        first, count = cfg["experts_held"]
        for e in range(count):
            pick = (chosen == first + e) & v[:, None]
            rows = pick.any(1).nonzero()[:, 0]
            if rows.numel() == 0:
                continue
            gate = s[rows, first + e]
            hx = h[rows]
            out = (torch.nn.functional.silu(hx @ w[pre + "w_gate"][e].float())
                   * (hx @ w[pre + "w_up"][e].float())) @ w[pre + "w_down"][e].float()
            y = y.index_add(0, rows, gate[:, None] * out)
        E, k = cfg["n_experts"], cfg["top_k"]
        vf = v.float().reshape(B, T, 1)
        n = vf.sum(1).clamp(min=1.0)
        picked = torch.zeros_like(s).scatter(1, chosen, 1.0).reshape(B, T, E)
        f = (picked * vf).sum(1) * (E / k) / n
        p = (s.reshape(B, T, E) * vf).sum(1) / n
        self.aux.append(cfg["aux_loss_alpha"] * (f * p).sum(1).mean())
        return y.reshape(B, T, d)

    def ffn(self, pre: str, i: int, x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        if i < self.cfg["first_k_dense"]:
            B, T, d = x.shape
            return swiglu(self.w, pre, x.reshape(-1, d)).reshape(B, T, d)
        return self.moe(pre, x, valid)

    def attention(self, pre, xq, xkv, add):
        w, H, dk = self.w, self.H, self.dk
        B, Tq, _ = xq.shape

        def heads(t):
            return t.reshape(t.shape[0], t.shape[1], H, dk).transpose(1, 2)

        q, k, v = (heads(t @ w[pre + n + ".weight"].float().t()) for n, t in (("q", xq), ("k", xkv), ("v", xkv)))
        a = torch.softmax(q @ k.transpose(-1, -2) + add, dim=-1)
        return (a @ v).transpose(1, 2).reshape(B, Tq, H * dk) @ w[pre + "o.weight"].float().t()

    def _bias(self, table, lq, lk, bidirectional):
        rel = torch.arange(lk)[None, :] - torch.arange(lq)[:, None]
        return table.float()[bucket(rel, bidirectional)].permute(2, 0, 1)

    def encoder(self, x, mask):
        w, eps = self.w, self.cfg["eps"]
        Le = x.shape[1]
        add = self._bias(w["encoder.block.0.self_attn.rel_bias"], Le, Le, True)[None] + \
            torch.where(mask, 0.0, NEG)[:, None, None, :]
        for i in range(self.cfg["num_layers"]):
            pre = f"encoder.block.{i}."
            h = rms_norm(x, w[pre + "ln_self.weight"], eps)
            x = x + self.attention(pre + "self_attn.", h, h, add)
            x = x + self.ffn(pre + "ffn.", i, rms_norm(x, w[pre + "ln_ffn.weight"], eps), mask)
        return rms_norm(x, w["encoder.ln_final.weight"], eps)

    def decoder(self, x, enc, enc_mask):
        w, eps = self.w, self.cfg["eps"]
        T = x.shape[1]
        causal = torch.where(torch.ones(T, T, dtype=torch.bool).tril(), 0.0, NEG)
        self_add = (self._bias(w["decoder.block.0.self_attn.rel_bias"], T, T, False) + causal)[None]
        cross_add = torch.where(enc_mask, 0.0, NEG)[:, None, None, :]
        every = torch.ones(x.shape[:2], dtype=torch.bool)
        for i in range(self.cfg["num_layers"]):
            pre = f"decoder.block.{i}."
            h = rms_norm(x, w[pre + "ln_self.weight"], eps)
            x = x + self.attention(pre + "self_attn.", h, h, self_add)
            h = rms_norm(x, w[pre + "ln_cross.weight"], eps)
            x = x + self.attention(pre + "cross_attn.", h, enc, cross_add)
            x = x + self.ffn(pre + "ffn.", i, rms_norm(x, w[pre + "ln_ffn.weight"], eps), every)
        return rms_norm(x, w["decoder.ln_final.weight"], eps)

    def embed(self, ids: torch.Tensor, mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """ids, mask [B, N, L] -> tokens [B, N*(L+1), d] (a separator after each item), mask."""
        B, N, L = ids.shape
        rows = torch.where(mask, ids + torch.arange(L) * self.K, torch.zeros_like(ids))
        e = self.w["sid_embedding"].float()[rows]
        sep = self.w["sep_token"].float().reshape(1, 1, 1, -1).expand(B, N, 1, self.d)
        return (torch.cat([e, sep], 2).reshape(B, N * (L + 1), self.d),
                torch.cat([mask, mask[:, :, -1:]], 2).reshape(B, N * (L + 1)))

    def dec_inputs(self, prefix: Optional[torch.Tensor], rows: int) -> torch.Tensor:
        bos = self.w["bos_token"].float().reshape(1, 1, -1).expand(rows, 1, self.d)
        if prefix is None or prefix.shape[1] == 0:
            return bos
        return torch.cat([bos, self.w["sid_embedding"].float()[prefix.long() + torch.arange(prefix.shape[1]) * self.K]], 1)

    def forward(self, ids, mask, target):
        """(loss: levels' mean cross-entropy plus the balance loss, logits [B, L, K],
        the balance loss)."""
        self.aux, self.chosen = [], []
        x, m = self.embed(ids, mask)
        enc = self.encoder(x, m)
        dec = self.decoder(self.dec_inputs(target, target.shape[0]), enc, m)[:, :-1]
        logits = torch.einsum("bld,ldk->blk", dec, self.w["heads"].float())
        nll = -torch.log_softmax(logits, -1).gather(2, target.long()[:, :, None])[..., 0]
        aux = torch.stack(self.aux).sum()
        return nll.mean(0).sum() + aux, logits, aux

    def score(self, ids, mask, tuples: torch.Tensor) -> torch.Tensor:
        """The teacher-forced log-probability of each [B, n, L] tuple."""
        B, n, L = tuples.shape
        x, m = self.embed(ids, mask)
        enc = self.encoder(x, m).repeat_interleave(n, 0)
        flat = tuples.reshape(B * n, L)
        dec = self.decoder(self.dec_inputs(flat, B * n), enc, m.repeat_interleave(n, 0))[:, :-1]
        logits = torch.einsum("bld,ldk->blk", dec, self.w["heads"].float())
        lp = torch.log_softmax(logits, -1).gather(2, flat.long()[:, :, None])[..., 0]
        return lp.sum(1).reshape(B, n)
