"""The T5 encoder-decoder of generative retrieval, plain and in float32.

Weights are a dict of tensors under the names the benchmark's weight maker
gives them (perfbench/harness/weights.py). The model, as the RQ-VAE-
Recommender project's T5 and the T5 paper describe it:

- a history of N items enters as N * (L + 1) tokens: each item's L semantic
  ids, embedded from one table with level l's ids at offset l * K, then a
  separator token; a padded item keeps its separator and masks all its
  tokens (a padded id takes row 0 of the table);
- RMSNorm before each sublayer (no mean, no bias), attention with no
  1/sqrt(d_kv) scale and bias-free projections, T5's log-binned relative
  position bias computed once per stack from its first block's table and
  added in every block (bidirectional in the encoder, causal in the
  decoder, none across), additive masks of -1e9, a ReLU feed-forward;
- the decoder reads BOS and then the target's ids; level l's logits are
  its state at position l times head l;
- dropout in training at rate p at these sites, each with its own seed: the
  stack's input, each attention's weights, each sublayer's output, the
  feed-forward's inner activation, the stack's output (encoder sites 0 ..
  2 + 4 * layers - 1, then the decoder's). Keep bits: reference/hashing.py.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch

from perfbench.reference import hashing
from perfbench.reference.precision import Precision

NEG = -1e9


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def position_bucket(rel: torch.Tensor, bidirectional: bool, buckets: int, max_distance: int) -> torch.Tensor:
    """T5's bucket of key position minus query position (float32 logs)."""
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
    large = large.clamp(max=buckets - 1)
    return out + torch.where(n < exact, n, large)


class T5:
    """`cfg`: the T5 sizes (d_model, num_heads, d_kv, num_layers,
    rel_buckets, rel_max_distance, layer_norm_eps); L levels of K ids."""

    def __init__(self, weights: dict, cfg: dict, L: int, K: int, prec: Precision, rate: float = 0.0):
        self.w, self.cfg, self.prec, self.rate = weights, cfg, prec, rate
        self.H, self.dk, self.d = cfg["num_heads"], cfg["d_kv"], cfg["d_model"]
        self.layers, self.eps = cfg["num_layers"], cfg["layer_norm_eps"]
        self.L, self.K = L, K

    # ---- pieces ----

    def _drop(self, x: torch.Tensor, seeds: Optional[Sequence[int]], site: int) -> torch.Tensor:
        if seeds is None or self.rate == 0.0:
            return x
        return hashing.dropout(x, seeds[site], self.rate)

    def _bias(self, table: torch.Tensor, lq: int, lk: int, bidirectional: bool) -> torch.Tensor:
        dev = table.device
        rel = torch.arange(lk, device=dev)[None, :] - torch.arange(lq, device=dev)[:, None]
        b = position_bucket(rel, bidirectional, self.cfg["rel_buckets"], self.cfg["rel_max_distance"])
        return table.float()[b].permute(2, 0, 1)  # [H, lq, lk]

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        B, T, _ = x.shape
        return x.reshape(B, T, self.H, self.dk).transpose(1, 2)

    def attention(self, pre: str, xq: torch.Tensor, xkv: torch.Tensor, add: torch.Tensor,
                  seeds: Optional[Sequence[int]], site: int) -> torch.Tensor:
        """`add` [B or 1, H or 1, Lq, Lk]: bias and masks."""
        p = self.prec
        q = self._heads(p.linear(xq, self.w[pre + "q.weight"]))
        k = self._heads(p.linear(xkv, self.w[pre + "k.weight"]))
        v = self._heads(p.linear(xkv, self.w[pre + "v.weight"]))
        a = torch.softmax(p.matmul(q, k.transpose(-1, -2)) + add, dim=-1)
        a = self._drop(a, seeds, site)
        o = p.matmul(a, v).transpose(1, 2).reshape(xq.shape[0], xq.shape[1], self.H * self.dk)
        return p.linear(o, self.w[pre + "o.weight"])

    def ffn(self, pre: str, x: torch.Tensor, seeds, site: int) -> torch.Tensor:
        h = torch.relu(self.prec.linear(x, self.w[pre + "wi.weight"]))
        return self.prec.linear(self._drop(h, seeds, site), self.w[pre + "wo.weight"])

    # ---- stacks ----

    def embed_history(self, ids: torch.Tensor, mask: torch.Tensor):
        """ids, mask [B, N, L] (ids -1 where masked) -> tokens [B, N*(L+1), d], mask [B, N*(L+1)]."""
        B, N, L = ids.shape
        offs = torch.arange(L, device=ids.device) * self.K
        rows = torch.where(mask, ids + offs, torch.zeros_like(ids))
        e = self.w["sid_embedding"].float()[rows]  # [B, N, L, d]
        sep = self.w["sep_token"].float().reshape(1, 1, 1, -1).expand(B, N, 1, self.d)
        e = torch.cat([e, sep], dim=2).reshape(B, N * (L + 1), self.d)
        m = torch.cat([mask, mask[:, :, -1:]], dim=2).reshape(B, N * (L + 1))
        return e, m

    def encoder(self, x: torch.Tensor, mask: torch.Tensor, seeds=None) -> torch.Tensor:
        Le = x.shape[1]
        add = (self._bias(self.w["encoder.block.0.self_attn.rel_bias"], Le, Le, True)[None]
               + torch.where(mask, 0.0, NEG)[:, None, None, :])
        x = self._drop(x, seeds, 0)
        for i in range(self.layers):
            pre, s = f"encoder.block.{i}.", 1 + 4 * i
            h = rms_norm(x, self.w[pre + "ln_self.weight"], self.eps)
            x = x + self._drop(self.attention(pre + "self_attn.", h, h, add, seeds, s), seeds, s + 1)
            h = self.ffn(pre + "ffn.", rms_norm(x, self.w[pre + "ln_ffn.weight"], self.eps), seeds, s + 2)
            x = x + self._drop(h, seeds, s + 3)
        return self._drop(rms_norm(x, self.w["encoder.ln_final.weight"], self.eps), seeds, 1 + 4 * self.layers)

    def decoder(self, x: torch.Tensor, enc: torch.Tensor, enc_mask: torch.Tensor, seeds=None) -> torch.Tensor:
        """x [B, T, d] decoder inputs, enc [B, Le, d] -> [B, T, d]."""
        T = x.shape[1]
        s0 = 2 + 4 * self.layers
        causal = torch.where(torch.ones(T, T, dtype=torch.bool, device=x.device).tril(), 0.0, NEG)
        self_add = (self._bias(self.w["decoder.block.0.self_attn.rel_bias"], T, T, False) + causal)[None]
        cross_add = torch.where(enc_mask, 0.0, NEG)[:, None, None, :]
        x = self._drop(x, seeds, s0)
        for i in range(self.layers):
            pre, s = f"decoder.block.{i}.", s0 + 1 + 6 * i
            h = rms_norm(x, self.w[pre + "ln_self.weight"], self.eps)
            x = x + self._drop(self.attention(pre + "self_attn.", h, h, self_add, seeds, s), seeds, s + 1)
            h = rms_norm(x, self.w[pre + "ln_cross.weight"], self.eps)
            x = x + self._drop(self.attention(pre + "cross_attn.", h, enc, cross_add, seeds, s + 2), seeds, s + 3)
            h = self.ffn(pre + "ffn.", rms_norm(x, self.w[pre + "ln_ffn.weight"], self.eps), seeds, s + 4)
            x = x + self._drop(h, seeds, s + 5)
        return self._drop(rms_norm(x, self.w["decoder.ln_final.weight"], self.eps), seeds, s0 + 1 + 6 * self.layers)

    def decoder_inputs(self, prefix: Optional[torch.Tensor], rows: int) -> torch.Tensor:
        """BOS then the embedded prefix ids [rows, T] (level t at offset t * K)."""
        bos = self.w["bos_token"].float().reshape(1, 1, -1).expand(rows, 1, self.d)
        if prefix is None or prefix.shape[1] == 0:
            return bos
        offs = torch.arange(prefix.shape[1], device=prefix.device) * self.K
        return torch.cat([bos, self.w["sid_embedding"].float()[prefix.long() + offs]], dim=1)

    def level_logits(self, states: torch.Tensor, level: int) -> torch.Tensor:
        return self.prec.matmul(states, self.w["heads"][level].float())

    # ---- training ----

    def loss(self, hist_ids: torch.Tensor, hist_mask: torch.Tensor, target: torch.Tensor,
             seeds: Optional[Sequence[int]]) -> List[torch.Tensor]:
        """hist_ids, hist_mask [B, N, L]; target [B, L]. The per-level mean
        cross-entropy of the teacher-forced targets."""
        x, m = self.embed_history(hist_ids, hist_mask)
        enc = self.encoder(x, m, seeds)
        dec = self.decoder(self.decoder_inputs(target, target.shape[0]), enc, m, seeds)
        out = []
        for level in range(self.L):
            logp = torch.log_softmax(self.level_logits(dec[:, level], level), dim=-1)
            out.append(-logp.gather(1, target[:, level:level + 1].long()).mean())
        return out
