"""T5-style encoder and decoder stacks (port of rqvae_tpu/models/t5.py).

- RMSNorm: no mean subtraction, no bias; f32 math, cast back to the input
  dtype, then scaled by the f32 weight.
- Attention without 1/sqrt(d) scaling, bias-free q/k/v/o, -1e9 additive
  masks; the relative position bias is computed by the first block of each
  stack and shared by all blocks. Cross-attention has no bias.
- FFN: wi -> ReLU -> dropout -> wo. Final RMSNorm and dropout at the end of
  each stack.
- Dropout (training only, rate `dropout`) at the reference's sites, in its
  order: the stack's input, the attention weights (inside the attention kernel
  where that runs), each sublayer's output before the residual add, the FFN's
  inner activation, the stack's output. Every site has a fixed index, given at
  construction (a stack's sites follow `site0`), and reads its int32 seed
  from that column of the forward's seed row: a device tensor that the caller
  draws on the host from an explicit `torch.Generator` (`DropoutSeeds.draw`)
  and copies to the device once. Nothing reads global random state, and no
  site reads the host, so a CUDA graph of a training step takes the seeds its
  buffer holds at each replay. With `hash_dropout` the mask is the counter
  hash of ops/hash_dropout.py and is rebuilt in the backward pass; without
  it, a Bernoulli mask from a generator seeded with the site's seed (read
  back to the host: that path is eager only).
- Data parallelism: a rank's forward over rows b0 .. b0 + B - 1 of a global
  batch passes its seed row as `SiteSeeds(seeds, b0, rows)`. Every hash site
  then counts from the rank's first global element, and the attention kernels
  from batch row b0, so the rank draws its slice of the global batch's masks:
  the JAX package's sites hash the global element position, and its
  data-parallel step equals its one-device step, dropout included.

Parameters stay float32. With `dtype="bfloat16"` every projection rounds its
operands to bf16, sums the products in f32 and rounds the result to bf16 once
(XLA's bf16 dot on the JAX side); softmax and normalization stay f32.

Three kernels sit behind the JAX package's gates, whose values are kept so
that the port routes as the reference does:

- the decoder serves beam search through `fused_decode`, one launch of the
  decoder-stack kernel per level (ops/cuda/decoder_stack.py), for encoder
  rows up to FUSED_DECODE_MAX_LEN;
- the encoder serves rows of FUSED_ENCODE_MIN_LEN or more through
  `fused_encode`, one call of the encoder-stack kernel
  (ops/cuda/encoder_stack.py);
- self- and cross-attention go through the attention kernels
  (ops/cuda/attention.py, forward and backward), once per layer: in training
  whenever there are at least FUSED_ATTENTION_MIN_TILE queries and keys, at
  inference (with `fused_encode="off"`) only over at least
  FUSED_ATTENTION_MIN_LEN of them.

Each mode field is "auto" (the gate decides), "on" (the same here: one
device, no device-count gate to force past) or "off". With `remat`, each
block of a training forward is rematerialised in the backward pass
(`torch.utils.checkpoint`, the counterpart of the reference's `nn.remat`):
its sites' seeds are fixed by index, so the recomputed block rebuilds the
forward's masks and the gradients equal those without remat bit for bit.
"""

from __future__ import annotations

import functools
import math

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from rqvae_tpu_torch.ops import amp
from rqvae_tpu_torch.ops.cuda.attention import t5_attention
from rqvae_tpu_torch.ops.cuda.decoder_stack import t5_decoder_stack_infer
from rqvae_tpu_torch.ops.cuda.encoder_stack import t5_encoder_stack_infer
from rqvae_tpu_torch.ops.embedding import embedding_lookup
from rqvae_tpu_torch.ops.hash_dropout import hash_dropout

NEG_INF = -1e9

# The kernels' length gates are the JAX package's TPU-measured values, kept
# only so the port routes as the reference does (their crossovers on the card
# are still to be measured). Module-level so tests can patch them down.
FUSED_DECODE_MAX_LEN = 128  # decoder stack: encoder rows Le at most this
FUSED_ENCODE_MIN_LEN = 512  # encoder stack: rows L at least this
FUSED_ATTENTION_MIN_LEN = 512  # attention at inference: min(Lq, Lk) at least this
FUSED_ATTENTION_MIN_TILE = 16  # attention: Lq and Lk at least this


@dataclass(frozen=True)
class T5StackConfig:
    d_model: int = 128
    d_kv: int = 64
    num_heads: int = 6
    d_ff: int = 1024
    num_layers: int = 4
    rel_buckets: int = 32
    rel_max_distance: int = 128
    layer_norm_eps: float = 1e-6
    dropout: float = 0.1
    dtype: str = "float32"  # compute dtype: "float32" | "bfloat16"
    # counter-hash dropout (ops/hash_dropout.py): nothing but the seed is kept
    # for the backward pass; False draws a Bernoulli mask per site
    hash_dropout: bool = True
    # decoder-stack kernel for beam search: "auto" (on when the encoder
    # rows are <= FUSED_DECODE_MAX_LEN) or "off"
    fused_decode: str = "auto"
    # encoder-stack kernel: "auto" (on for rows >= FUSED_ENCODE_MIN_LEN) or "off"
    fused_encode: str = "auto"
    # attention kernels: "auto" (in training on from FUSED_ATTENTION_MIN_TILE
    # queries and keys, at inference from FUSED_ATTENTION_MIN_LEN) or "off"
    fused_attention: str = "auto"
    # rematerialise each block in the backward pass of a training forward
    remat: bool = False

    def __post_init__(self):
        for name in ("fused_decode", "fused_encode", "fused_attention"):
            if getattr(self, name) not in ("auto", "on", "off"):
                raise ValueError(f'{name} must be "auto", "on" or "off", got {getattr(self, name)!r}')
        if not 0.0 <= self.dropout < 1.0:
            raise ValueError(f"dropout {self.dropout} outside [0, 1)")

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


def dense(x: torch.Tensor, weight: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """x @ weight.T at the compute dtype: operands rounded to cdt, products
    summed in f32, the result rounded to cdt once. At float32 inside an amp
    step on the card, bf16 operands with f32 sums (ops/amp.py)."""
    if cdt == torch.float32:
        return amp.linear(x.float(), weight.float())
    return F.linear(x.to(cdt).float(), weight.to(cdt).float()).to(cdt)


class DropoutSeeds:
    """The int32 seeds of the dropout sites, one row per forward pass (micro-
    batch), one column per site index. `draw` takes them from `generator` (a
    CPU torch.Generator) a block of BLOCK at a time, row after row, enough
    blocks for `n_sites`: the same generator state gives the same masks."""

    BLOCK = 64  # more than the sites of one forward of a 4+4-layer model

    @classmethod
    def columns(cls, n_sites: int) -> int:
        return cls.BLOCK * max(1, -(-n_sites // cls.BLOCK))

    @classmethod
    def draw(cls, generator: torch.Generator, rows: int, n_sites: int) -> torch.Tensor:
        """[rows, columns(n_sites)] int32 on the host."""
        if generator.device.type != "cpu":
            raise ValueError("dropout seeds are drawn on the host: pass a CPU torch.Generator")
        blocks = cls.columns(n_sites) // cls.BLOCK
        return torch.stack([
            torch.cat([torch.randint(0, 2**31 - 1, (cls.BLOCK,), generator=generator) for _ in range(blocks)])
            for _ in range(rows)
        ]).to(torch.int32)


    @staticmethod
    def fold_in(seeds: torch.Tensor, index: int) -> torch.Tensor:
        """Host seeds made distinct for `index` (a data-parallel rank), the
        counterpart of `jax.random.fold_in(key, axis_index)`: each seed is
        replaced by the murmur3 finaliser of seed XOR (index + 1) *
        0x9E3779B9, cut to 31 bits. Same int32 shape."""
        x = (seeds.to(torch.int64) & 0xFFFFFFFF) ^ (((int(index) + 1) * 0x9E3779B9) & 0xFFFFFFFF)
        for shift, mul in ((16, 0x85EBCA6B), (13, 0xC2B2AE35)):
            x = ((x ^ (x >> shift)) * mul) & 0xFFFFFFFF
        return ((x ^ (x >> 16)) & 0x7FFFFFFF).to(torch.int32)


class SiteSeeds(NamedTuple):
    """A forward's dropout seed row with the rows of the global batch that
    the forward holds: rows b0 .. b0 + B - 1 of a global batch of `rows` (a
    data-parallel rank's slice). Its sites draw that slice of the global
    batch's masks."""

    seeds: torch.Tensor  # [>= sites] int32 on the device
    b0: int
    rows: int


Seeds = Union[torch.Tensor, SiteSeeds]


def seed_row(seeds: Optional[Seeds]) -> Tuple[Optional[torch.Tensor], int, Optional[int]]:
    """(seed row, b0, global rows): a plain row is the whole batch's (b0 =
    0, rows None)."""
    if isinstance(seeds, SiteSeeds):
        return seeds.seeds, int(seeds.b0), int(seeds.rows)
    return seeds, 0, None


def dropout(x: torch.Tensor, cfg: T5StackConfig, training: bool, seeds: Optional[Seeds],
            site: int) -> torch.Tensor:
    """One dropout site at rate cfg.dropout (the identity outside training);
    its seed is seeds[site], a view on the device. With SiteSeeds, batch row
    0 of x is global row b0 of a batch of `rows`."""
    if not training or cfg.dropout == 0.0:
        return x
    row, b0, rows = seed_row(seeds)
    if row is None:
        raise ValueError("training with dropout needs the step's dropout seeds (an explicit generator)")
    seed = row[site:site + 1]
    if cfg.hash_dropout:
        per_row = math.prod(x.shape[1:])
        return hash_dropout(x, seed, cfg.dropout, b0 * per_row, None if rows is None else rows * per_row)
    if rows is not None and (b0, rows) != (0, x.shape[0]):
        raise ValueError("a data-parallel rank's dropout needs hash dropout (t5_hash_dropout=True): "
                         "Bernoulli masks are not a slice of the global batch's")
    keep_prob = 1.0 - cfg.dropout
    g = torch.Generator(device=x.device).manual_seed(int(seed))
    keep = torch.rand(x.shape, device=x.device, generator=g) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        return (xf * (1.0 / torch.sqrt(var + self.eps))).to(x.dtype) * self.weight


@functools.lru_cache(maxsize=None)
def _log_ratio(max_distance: int, max_exact: int) -> float:
    """log(max_distance / max_exact) in float32, computed once per pair."""
    return float(torch.log(torch.tensor(max_distance / max_exact, dtype=torch.float32)))


def relative_position_bucket(
    relative_position: torch.Tensor,
    bidirectional: bool,
    num_buckets: int = 32,
    max_distance: int = 128,
) -> torch.Tensor:
    """T5's log-binned relative position buckets, computed in float32 with
    truncating casts, as the JAX package does."""
    rp = relative_position.to(torch.int32)
    ret = torch.zeros_like(rp)
    n = -rp
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n < 0).to(torch.int32) * num_buckets
        n = torch.abs(n)
    else:
        n = torch.clamp(n, min=0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    # log(max_distance / max_exact) in float32, made on the device by a fill
    # (a host-to-device copy would break CUDA graph capture)
    log_ratio = _log_ratio(max_distance, max_exact)
    val_if_large = max_exact + (
        torch.log(torch.clamp(n, min=1).to(torch.float32) / max_exact)
        / torch.full((), log_ratio, dtype=torch.float32, device=n.device)
        * (num_buckets - max_exact)
    ).to(torch.int32)
    val_if_large = torch.clamp(val_if_large, max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_if_large)


class T5Attention(nn.Module):
    def __init__(self, cfg: T5StackConfig, has_relative_bias: bool = False,
                 bidirectional: bool = True, device=None, site: int = 0):
        super().__init__()
        self.cfg = cfg
        self.bidirectional = bidirectional
        self.site = site  # the attention weights' dropout site
        inner = cfg.num_heads * cfg.d_kv
        d = cfg.d_model
        self.q = nn.Linear(d, inner, bias=False, device=device)
        self.k = nn.Linear(d, inner, bias=False, device=device)
        self.v = nn.Linear(d, inner, bias=False, device=device)
        self.o = nn.Linear(inner, d, bias=False, device=device)
        self.rel_bias = (
            nn.Parameter(torch.zeros(cfg.rel_buckets, cfg.num_heads, device=device))
            if has_relative_bias else None
        )

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        """[B, L, H*dk] -> [B, H, L, dk]."""
        B, L, _ = x.shape
        return x.reshape(B, L, self.cfg.num_heads, self.cfg.d_kv).transpose(1, 2)

    def kv_heads(self, kv_in: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Projected K/V heads [B, H, Lk, dk]: the level-invariant half of
        cross-attention, computed once per generate()."""
        cdt = self.cfg.compute_dtype
        return self._heads(dense(kv_in, self.k.weight, cdt)), self._heads(dense(kv_in, self.v.weight, cdt))

    def position_bias(self, lq: int, lk: int) -> torch.Tensor:
        """[1, H, Lq, Lk] float32 relative position bias."""
        dev = self.rel_bias.device
        ctx = torch.arange(lq, device=dev)[:, None]
        mem = torch.arange(lk, device=dev)[None, :]
        buckets = relative_position_bucket(
            mem - ctx, self.bidirectional, self.cfg.rel_buckets, self.cfg.rel_max_distance
        )
        return embedding_lookup(self.rel_bias.float(), buckets).permute(2, 0, 1)[None]

    def _use_fused(self, lq: int, lk: int, training: bool = False) -> bool:
        """The attention-kernel gate, as the reference's: never below
        FUSED_ATTENTION_MIN_TILE queries or keys, and at inference only
        for long rows."""
        if self.cfg.fused_attention == "off":
            return False
        if lq < FUSED_ATTENTION_MIN_TILE or lk < FUSED_ATTENTION_MIN_TILE:
            return False
        return training or min(lq, lk) >= FUSED_ATTENTION_MIN_LEN

    def forward(
        self,
        x: torch.Tensor,  # [B, Lq, d]
        kv: Optional[torch.Tensor] = None,  # [B, Lk, d] for cross-attention
        mask: Optional[torch.Tensor] = None,  # [B, Lk] 1 = attend
        position_bias: Optional[torch.Tensor] = None,  # [1, H, Lq, Lk]
        causal: bool = False,
        kv_cache: Optional[tuple] = None,  # precomputed kv_heads() output
        training: bool = False,
        seeds: Optional[Seeds] = None,
    ):
        cfg = self.cfg
        cdt = cfg.compute_dtype
        B, Lq, _ = x.shape
        q = self._heads(dense(x, self.q.weight, cdt))
        k, v = kv_cache if kv_cache is not None else self.kv_heads(x if kv is None else kv)
        Lk = k.shape[2]
        if position_bias is None and self.rel_bias is not None:
            position_bias = self.position_bias(Lq, Lk)

        if self._use_fused(Lq, Lk, training):
            bias = (position_bias[0] if position_bias is not None
                    else torch.zeros(cfg.num_heads, Lq, Lk, device=x.device))
            keys = mask if mask is not None else torch.ones(B, Lk, dtype=torch.int32, device=x.device)
            rate = cfg.dropout if training else 0.0
            row, b0, _ = seed_row(seeds)
            if rate > 0.0 and row is None:
                raise ValueError("training with dropout needs the step's dropout seeds (an explicit generator)")
            seed = row[self.site:self.site + 1] if rate > 0.0 else None  # the kernels read it on the card
            out = t5_attention(q.contiguous(), k.contiguous(), v.contiguous(), bias.contiguous(),
                               keys.to(torch.int32), seed, causal=causal, dropout_rate=rate, b0=b0)
            out = out.transpose(1, 2).reshape(B, Lq, cfg.num_heads * cfg.d_kv)
            return dense(out, self.o.weight, cdt), position_bias

        scores = q.float() @ k.float().transpose(-1, -2)  # no 1/sqrt(d) scale
        if position_bias is not None:
            scores = scores + position_bias
        if mask is not None:
            scores = scores + torch.where(mask[:, None, None, :] != 0, 0.0, NEG_INF)
        if causal:
            cmask = torch.ones(Lq, Lk, dtype=torch.bool, device=x.device).tril()
            scores = scores + torch.where(cmask, 0.0, NEG_INF)
        weights = dropout(torch.softmax(scores, dim=-1).to(cdt), cfg, training, seeds, self.site)
        out = (weights.float() @ v.float()).to(cdt)
        out = out.transpose(1, 2).reshape(B, Lq, cfg.num_heads * cfg.d_kv)
        return dense(out, self.o.weight, cdt), position_bias


class T5FFN(nn.Module):
    def __init__(self, cfg: T5StackConfig, device=None, site: int = 0):
        super().__init__()
        self.cfg = cfg
        self.site = site  # the inner activation's dropout site
        self.wi = nn.Linear(cfg.d_model, cfg.d_ff, bias=False, device=device)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False, device=device)

    def forward(self, x: torch.Tensor, training: bool = False, seeds: Optional[Seeds] = None) -> torch.Tensor:
        cdt = self.cfg.compute_dtype
        h = dropout(torch.relu(dense(x, self.wi.weight, cdt)), self.cfg, training, seeds, self.site)
        return dense(h, self.wo.weight, cdt)


class T5Block(nn.Module):
    """Dropout sites in call order from `site0`: self-attention weights, its
    output, (decoder) cross-attention weights, its output, the FFN's inner
    activation, its output."""

    def __init__(self, cfg: T5StackConfig, is_decoder: bool = False,
                 has_relative_bias: bool = False, device=None, site0: int = 0):
        super().__init__()
        self.cfg = cfg
        self.is_decoder = is_decoder
        eps = cfg.layer_norm_eps
        self.ln_self = RMSNorm(cfg.d_model, eps, device)
        self.self_attn = T5Attention(cfg, has_relative_bias, not is_decoder, device, site=site0)
        site = site0 + 2
        if is_decoder:
            self.ln_cross = RMSNorm(cfg.d_model, eps, device)
            self.cross_attn = T5Attention(cfg, device=device, site=site)
            site += 2
        self.ln_ffn = RMSNorm(cfg.d_model, eps, device)
        self.ffn = T5FFN(cfg, device, site=site)

    @staticmethod
    def sites(is_decoder: bool) -> int:
        return 6 if is_decoder else 4

    def forward(self, x, enc_out=None, self_mask=None, enc_mask=None, position_bias=None,
                beams: int = 1, cross_kv=None, training: bool = False, seeds: Optional[Seeds] = None):
        drop = lambda h, site: dropout(h, self.cfg, training, seeds, site)
        h, position_bias = self.self_attn(
            self.ln_self(x), mask=self_mask, position_bias=position_bias, causal=self.is_decoder,
            training=training, seeds=seeds,
        )
        x = x + drop(h, self.self_attn.site + 1)
        if self.is_decoder and (enc_out is not None or cross_kv is not None):
            xq = self.ln_cross(x)
            if beams > 1:
                # beam-folded cross-attention: the k beams of one query share
                # the encoder rows, so attend as [B, k*T] queries against the
                # un-replicated [B, Le] keys/values
                Bk, T, d = xq.shape
                xq = xq.reshape(Bk // beams, beams * T, d)
            h, _ = self.cross_attn(xq, kv=enc_out, mask=enc_mask, kv_cache=cross_kv,
                                   training=training, seeds=seeds)
            if beams > 1:
                h = h.reshape(x.shape)
            x = x + drop(h, self.cross_attn.site + 1)
        return x + drop(self.ffn(self.ln_ffn(x), training, seeds), self.ffn.site + 1), position_bias


class DecodeWeights(NamedTuple):
    """The decoder stack's weights in the kernel's layout (stacked over
    layers, projections pre-shaped per head): level-invariant, built once
    per generate()."""

    wq: torch.Tensor  # [NL, H, d, dk]
    wk: torch.Tensor
    wv: torch.Tensor
    wo: torch.Tensor  # [NL, H, dk, d]
    cq: torch.Tensor  # [NL, H, d, dk]
    co: torch.Tensor  # [NL, H, dk, d]
    wi: torch.Tensor  # [NL, d, dff]
    wo2: torch.Tensor  # [NL, dff, d]
    ln_s: torch.Tensor  # [NL, d] f32
    ln_c: torch.Tensor
    ln_f: torch.Tensor
    ln_final: torch.Tensor  # [d] f32


class EncodeWeights(NamedTuple):
    """The encoder stack's weights in the kernel's layout (stacked over
    layers, projections pre-shaped per head)."""

    wq: torch.Tensor  # [NL, H, d, dk]
    wk: torch.Tensor
    wv: torch.Tensor
    wo: torch.Tensor  # [NL, H, dk, d]
    wi: torch.Tensor  # [NL, d, dff]
    wo2: torch.Tensor  # [NL, dff, d]
    ln_s: torch.Tensor  # [NL, d] f32
    ln_f: torch.Tensor
    ln_final: torch.Tensor  # [d] f32


class T5Stack(nn.Module):
    """Encoder or decoder stack over pre-computed input embeddings. Its
    `n_sites` dropout sites are site0 (the input), the blocks' in order, and
    the last (the output)."""

    def __init__(self, cfg: T5StackConfig, is_decoder: bool = False, device=None, site0: int = 0):
        super().__init__()
        self.cfg = cfg
        self.is_decoder = is_decoder
        per_block = T5Block.sites(is_decoder)
        self.site0 = site0
        self.n_sites = 2 + per_block * cfg.num_layers
        self.block = nn.ModuleList(
            T5Block(cfg, is_decoder, has_relative_bias=(i == 0), device=device, site0=site0 + 1 + per_block * i)
            for i in range(cfg.num_layers)
        )
        self.ln_final = RMSNorm(cfg.d_model, cfg.layer_norm_eps, device)

    def cross_kv(self, enc_out: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Cross-attention K and V of every layer over `enc_out`, stacked as
        [NL, B, H, Le, dk] at the compute dtype (decoder stacks only)."""
        if not self.is_decoder:
            raise ValueError("cross_kv is a decoder-stack cache")
        enc = enc_out.to(self.cfg.compute_dtype)
        kv = [b.cross_attn.kv_heads(enc) for b in self.block]
        return torch.stack([k for k, _ in kv]), torch.stack([v for _, v in kv])

    def use_fused_decode(self, enc_len: int) -> bool:
        """The decoder-stack kernel gate: on unless "off", and only for
        encoder rows up to FUSED_DECODE_MAX_LEN."""
        return self.cfg.fused_decode != "off" and enc_len <= FUSED_DECODE_MAX_LEN

    def _stack(self, get, dtype=None) -> torch.Tensor:
        """get(block) of every block, stacked, at `dtype` (the compute dtype
        when None)."""
        dtype = self.cfg.compute_dtype if dtype is None else dtype
        return torch.stack([get(b) for b in self.block]).to(dtype).contiguous()

    def _per_head_in(self, lin: nn.Linear) -> torch.Tensor:
        """weight [H*dk, d] -> [H, d, dk]."""
        cfg = self.cfg
        return lin.weight.t().reshape(cfg.d_model, cfg.num_heads, cfg.d_kv).permute(1, 0, 2)

    def _per_head_out(self, lin: nn.Linear) -> torch.Tensor:
        """weight [d, H*dk] -> [H, dk, d]."""
        cfg = self.cfg
        return lin.weight.t().reshape(cfg.num_heads, cfg.d_kv, cfg.d_model)

    def decode_weights(self) -> DecodeWeights:
        stack, head_in, head_out, f32 = self._stack, self._per_head_in, self._per_head_out, torch.float32
        return DecodeWeights(
            wq=stack(lambda b: head_in(b.self_attn.q)),
            wk=stack(lambda b: head_in(b.self_attn.k)),
            wv=stack(lambda b: head_in(b.self_attn.v)),
            wo=stack(lambda b: head_out(b.self_attn.o)),
            cq=stack(lambda b: head_in(b.cross_attn.q)),
            co=stack(lambda b: head_out(b.cross_attn.o)),
            wi=stack(lambda b: b.ffn.wi.weight.t()),
            wo2=stack(lambda b: b.ffn.wo.weight.t()),
            ln_s=stack(lambda b: b.ln_self.weight, f32),
            ln_c=stack(lambda b: b.ln_cross.weight, f32),
            ln_f=stack(lambda b: b.ln_ffn.weight, f32),
            ln_final=self.ln_final.weight.to(f32).contiguous(),
        )

    def decode_operands(
        self,
        x_folded: torch.Tensor,  # [B, beams*T, d] decoder input embeddings
        cross_kv: Tuple[torch.Tensor, torch.Tensor],  # self.cross_kv(enc_out)
        enc_mask: torch.Tensor,  # [B, Le]
        beams: int,
        weights: DecodeWeights,  # self.decode_weights()
    ) -> tuple:
        """The decoder-stack kernel's operands for one beam-search level, in
        its argument order (ops/cuda/decoder_stack.py)."""
        cfg = self.cfg
        B, kt, _ = x_folded.shape
        T = kt // beams
        if kt != beams * T:
            raise ValueError(f"{kt} folded rows are not {beams} beams of equal length")
        dev = x_folded.device
        # block-diagonal folded self-attention bias: block 0's rel-pos table
        # plus causal, tiled per beam; cross-beam pairs get -1e9, which
        # underflows to exactly 0 through softmax
        rel = self.block[0].self_attn.rel_bias.float()  # [buckets, H]
        ctx = torch.arange(T, device=dev)[:, None]
        mem = torch.arange(T, device=dev)[None, :]
        buckets = relative_position_bucket(mem - ctx, False, cfg.rel_buckets, cfg.rel_max_distance)
        bias_tt = rel[buckets.long()].permute(2, 0, 1) + torch.where(mem <= ctx, 0.0, NEG_INF)[None]
        beam_of = torch.arange(kt, device=dev) // T
        same_beam = beam_of[:, None] == beam_of[None, :]
        bias_fold = torch.where(same_beam[None], bias_tt.repeat(1, beams, beams), NEG_INF)
        mask = torch.where(enc_mask != 0, 0.0, NEG_INF).to(torch.float32)
        kc, vc = cross_kv
        return (
            x_folded.to(cfg.compute_dtype).contiguous(), *weights,
            bias_fold.contiguous(), kc.contiguous(), vc.contiguous(), mask.contiguous(),
        )

    def fused_decode(
        self,
        x_folded: torch.Tensor,
        cross_kv: Tuple[torch.Tensor, torch.Tensor],
        enc_mask: torch.Tensor,
        beams: int,
        weights: DecodeWeights,
    ) -> torch.Tensor:
        """One-launch decoder-stack forward for one beam-search level:
        self-attention beam-folded under a block-diagonal causal rel-pos
        bias, cross-attention against the cached K/V. Returns
        [B, beams*T, d] f32 ln_final-normalized states."""
        ops = self.decode_operands(x_folded, cross_kv, enc_mask, beams, weights)
        return t5_decoder_stack_infer(*ops, eps=self.cfg.layer_norm_eps)

    def use_fused_encode(self, L: int, training: bool = False) -> bool:
        """The encoder-stack kernel gate: encoder stacks at inference, on
        unless "off", and only for rows of FUSED_ENCODE_MIN_LEN or more."""
        if self.is_decoder or training or self.cfg.fused_encode == "off":
            return False
        return L >= FUSED_ENCODE_MIN_LEN

    def encode_weights(self) -> EncodeWeights:
        stack, head_in, head_out, f32 = self._stack, self._per_head_in, self._per_head_out, torch.float32
        return EncodeWeights(
            wq=stack(lambda b: head_in(b.self_attn.q)),
            wk=stack(lambda b: head_in(b.self_attn.k)),
            wv=stack(lambda b: head_in(b.self_attn.v)),
            wo=stack(lambda b: head_out(b.self_attn.o)),
            wi=stack(lambda b: b.ffn.wi.weight.t()),
            wo2=stack(lambda b: b.ffn.wo.weight.t()),
            ln_s=stack(lambda b: b.ln_self.weight, f32),
            ln_f=stack(lambda b: b.ln_ffn.weight, f32),
            ln_final=self.ln_final.weight.to(f32).contiguous(),
        )

    def encode_operands(self, x: torch.Tensor, self_mask: Optional[torch.Tensor]) -> tuple:
        """The encoder-stack kernel's operands, in its argument order
        (ops/cuda/encoder_stack.py): x at the compute dtype, the weights, the
        [H, L, L] bidirectional rel-pos bias of block 0's table and the
        additive key mask. Rows keep their length (no padding)."""
        if self.is_decoder:
            raise ValueError("the encoder-stack kernel serves encoder stacks")
        B, L, _ = x.shape
        bias = self.block[0].self_attn.position_bias(L, L)[0]
        if self_mask is None:
            mask = torch.zeros(B, L, dtype=torch.float32, device=x.device)
        else:
            mask = torch.where(self_mask != 0, 0.0, NEG_INF).to(torch.float32)
        return (x.to(self.cfg.compute_dtype).contiguous(), *self.encode_weights(),
                bias.contiguous(), mask.contiguous())

    def fused_encode(self, x: torch.Tensor, self_mask: Optional[torch.Tensor]) -> torch.Tensor:
        """One-call encoder-stack forward for long-row serving: every layer
        and the final norm in the encoder-stack kernel. Keys are masked,
        query rows are not. Inference only. Returns [B, L, d] f32."""
        return t5_encoder_stack_infer(*self.encode_operands(x, self_mask), eps=self.cfg.layer_norm_eps)

    def forward(
        self,
        inputs_embeds: torch.Tensor,  # [B, L, d]
        self_mask: Optional[torch.Tensor] = None,  # [B, L] 1 = valid
        enc_out: Optional[torch.Tensor] = None,
        enc_mask: Optional[torch.Tensor] = None,
        beams: int = 1,  # decoder: input batch = beams * encoder batch
        cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # self.cross_kv()
        training: bool = False,
        seeds: Optional[Seeds] = None,  # the forward's seed row [>= sites] int32; needed for dropout
    ) -> torch.Tensor:
        cfg = self.cfg
        if self.use_fused_encode(inputs_embeds.shape[1], training):
            return self.fused_encode(inputs_embeds, self_mask)
        x = dropout(inputs_embeds.to(cfg.compute_dtype), cfg, training, seeds, self.site0)
        position_bias = None
        remat = cfg.remat and training and torch.is_grad_enabled()
        for i, blk in enumerate(self.block):
            layer_kv = None if cross_kv is None else (cross_kv[0][i], cross_kv[1][i])
            args = (x, enc_out, self_mask, enc_mask, position_bias, beams, layer_kv, training, seeds)
            if remat:  # the RNG is not read (seeds are by site), so its state need not be kept
                x, position_bias = checkpoint(blk, *args, use_reentrant=False, preserve_rng_state=False)
            else:
                x, position_bias = blk(*args)
        return dropout(self.ln_final(x), cfg, training, seeds, self.site0 + self.n_sites - 1).float()
