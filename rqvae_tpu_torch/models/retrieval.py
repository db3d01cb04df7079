"""Retrieval model (port of rqvae_tpu/models/retrieval.py).

T5-style encoder-decoder over semantic-ID sequences with constrained beam
search: per level, candidates are scored by cumulative log-prob, children
whose prefix is absent from the corpus are masked to -1e9, and the top k
beams are kept. Top-k breaks ties toward the lower index, as jax.lax.top_k
does; ties are common, since every invalid candidate scores -1e9 plus its
beam's log-prob, which rounds to -1e9.

Training: `forward(batch, training, generator)` is the teacher-forced loss, the
sum over hierarchy levels of the mean cross-entropy of that level's head at
its decoder position. Its dropout seeds are a device row of `n_dropout_sites`
int32 values (models/t5.py::DropoutSeeds), passed as `seeds` or drawn from
`generator`. `t5_remat` rematerialises each T5 block in the backward pass.

Generation: deterministic over all K codewords per level, or with
`sample_candidates` over n_candidates drawn per beam by Gumbel top-k (the
reference's multinomial without replacement) from Gumbel noise the caller
passes in: the port cannot draw jax.random's bits, so its tests feed it the
noise that JAX draws.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence

import torch
from torch import nn

from rqvae_tpu_torch.data.schemas import TokenizedSeqBatch
from rqvae_tpu_torch.models.t5 import DropoutSeeds, Seeds, T5Stack, T5StackConfig
from rqvae_tpu_torch.ops import amp
from rqvae_tpu_torch.ops.embedding import embedding_lookup
from rqvae_tpu_torch.ops.gumbel import sample_without_replacement
from rqvae_tpu_torch.serving.beam import PrefixTable, extend_keys, valid_children
from rqvae_tpu_torch.utils.device import DeviceLike, resolve_device

NEG_INF = -1e9


@dataclass(frozen=True)
class RetrievalConfig:
    """The fields of rqvae_tpu.models.retrieval.RetrievalConfig, same names
    and defaults (a JAX decoder checkpoint's config JSON holds every one)."""

    num_hierarchies: int = 3
    codebook_size: int = 256
    t5_d_model: int = 128
    t5_d_kv: int = 64
    t5_num_heads: int = 6
    t5_d_ff: int = 1024
    t5_num_layers: int = 4
    t5_dropout: float = 0.1
    top_k_for_generation: int = 10
    n_candidates: int = 64  # sampled candidates per level (sample_candidates=True)
    should_add_sep_token: bool = True
    num_user_bins: Optional[int] = None
    sample_candidates: bool = False
    t5_dtype: str = "float32"
    t5_remat: bool = False  # rematerialise each T5 block in the backward pass
    t5_hash_dropout: bool = True
    t5_fused_decode: str = "auto"
    t5_fused_encode: str = "auto"
    t5_fused_attention: str = "auto"

    @property
    def t5(self) -> T5StackConfig:
        return T5StackConfig(
            d_model=self.t5_d_model,
            d_kv=self.t5_d_kv,
            num_heads=self.t5_num_heads,
            d_ff=self.t5_d_ff,
            num_layers=self.t5_num_layers,
            dropout=self.t5_dropout,
            dtype=self.t5_dtype,
            hash_dropout=self.t5_hash_dropout,
            fused_decode=self.t5_fused_decode,
            fused_encode=self.t5_fused_encode,
            fused_attention=self.t5_fused_attention,
            remat=self.t5_remat,
        )


class ModelOutput(NamedTuple):
    loss: torch.Tensor  # scalar
    logits: torch.Tensor  # [B, L, K] per-hierarchy teacher-forced logits
    loss_d: torch.Tensor  # [L] per-hierarchy losses


class GenerationOutput(NamedTuple):
    sem_ids: torch.Tensor  # [B, top_k, L]
    log_probas: torch.Tensor  # [B, top_k]


def strip_dedup_col(flat: torch.Tensor, sem_ids_dim: int, n_layers: int) -> torch.Tensor:
    """[B, N*sem_ids_dim] -> [B, N*n_layers]."""
    B, total = flat.shape
    N = total // sem_ids_dim
    return flat.reshape(B, N, sem_ids_dim)[:, :, :n_layers].reshape(B, N * n_layers)


def top_k(x: torch.Tensor, k: int):
    """Top k along the last axis, ties to the lower index (jax.lax.top_k's
    order; torch.topk promises none)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


class EncoderDecoderRetrievalModel(nn.Module):
    """Parameters mirror the flax module's names (utils/convert.py);
    initialised from `seed` at the JAX package's scales."""

    def __init__(self, config: RetrievalConfig, device: DeviceLike = None, seed: int = 0):
        super().__init__()
        from rqvae_tpu_torch.utils.convert import init_retrieval_

        dev = resolve_device(device)
        cfg = config
        self.config = cfg
        L, K, d = cfg.num_hierarchies, cfg.codebook_size, cfg.t5_d_model
        self.sid_embedding = nn.Parameter(torch.empty(L * K, d, device=dev))
        self.bos_token = nn.Parameter(torch.empty(1, d, device=dev))
        if cfg.should_add_sep_token:
            self.sep_token = nn.Parameter(torch.empty(1, d, device=dev))
        if cfg.num_user_bins:
            self.user_embedding = nn.Parameter(torch.empty(cfg.num_user_bins, d, device=dev))
        self.encoder = T5Stack(cfg.t5, is_decoder=False, device=dev)
        self.decoder = T5Stack(cfg.t5, is_decoder=True, device=dev, site0=self.encoder.n_sites)
        self.heads = nn.Parameter(torch.empty(L, d, K, device=dev))  # per-hierarchy heads
        init_retrieval_(self, seed)

    @property
    def device(self) -> torch.device:
        return self.heads.device

    @property
    def n_dropout_sites(self) -> int:
        """Dropout sites of one training forward: the encoder's, then the decoder's."""
        return self.encoder.n_sites + self.decoder.n_sites

    def _offsets(self, n_cols: int) -> torch.Tensor:
        """Per-hierarchy embedding offsets repeated across columns."""
        cfg = self.config
        offs = torch.arange(cfg.num_hierarchies, dtype=torch.int32, device=self.device)
        reps = -(-n_cols // cfg.num_hierarchies)
        return (offs * cfg.codebook_size).repeat(reps)[:n_cols]

    def encoder_forward(
        self,
        sem_ids: torch.Tensor,  # [B, N*L], dedup stripped, -1 padded
        seq_mask: torch.Tensor,  # [B, N*L] 1 = valid
        user_ids: Optional[torch.Tensor] = None,  # [B]
        training: bool = False,
        seeds: Optional[Seeds] = None,
    ):
        cfg = self.config
        B, T = sem_ids.shape
        mask = seq_mask.to(torch.int32)
        shifted = (sem_ids + self._offsets(T)[None, :]) * mask  # padding -> row 0, masked out
        embs = embedding_lookup(self.sid_embedding, shifted)  # [B, T, d]
        if cfg.should_add_sep_token:
            L = cfg.num_hierarchies
            items = T // L
            e = embs.reshape(B, items, L, -1)
            m = mask.reshape(B, items, L)
            sep = self.sep_token.reshape(1, 1, 1, -1).expand(B, items, 1, e.shape[-1])
            e = torch.cat([e, sep], dim=2)
            m = torch.cat([m, m[:, :, -1:]], dim=2)
            embs = e.reshape(B, items * (L + 1), -1)
            mask = m.reshape(B, items * (L + 1))
        if user_ids is not None and cfg.num_user_bins:
            u = torch.remainder(user_ids.long(), cfg.num_user_bins)
            embs = torch.cat([self.user_embedding[u][:, None, :], embs], dim=1)
            mask = torch.cat([torch.ones_like(mask[:, :1]), mask], dim=1)
        return self.encoder(embs, self_mask=mask, training=training, seeds=seeds), mask

    def _decoder_embs(self, fut_ids: Optional[torch.Tensor], rows: int) -> torch.Tensor:
        """BOS + offset-shifted prefix embeddings: [rows, T+1, d]."""
        bos = self.bos_token.reshape(1, 1, -1).expand(rows, 1, self.config.t5_d_model)
        if fut_ids is None or fut_ids.shape[1] == 0:
            return bos
        shifted = fut_ids + self._offsets(fut_ids.shape[1])[None, :]
        return torch.cat([bos, embedding_lookup(self.sid_embedding, shifted)], dim=1)

    def decoder_forward(
        self,
        fut_ids: Optional[torch.Tensor],  # [B*beams, T] prefix (None = BOS only)
        enc_out: torch.Tensor,  # [B, Le, d]
        enc_mask: torch.Tensor,
        beams: int = 1,
        cross_kv=None,  # decoder.cross_kv(enc_out)
        training: bool = False,
        seeds: Optional[Seeds] = None,
    ) -> torch.Tensor:
        embs = self._decoder_embs(fut_ids, enc_out.shape[0] * beams)
        return self.decoder(
            embs, enc_out=enc_out, enc_mask=enc_mask, beams=beams, cross_kv=cross_kv,
            training=training, seeds=seeds,
        )  # [B*beams, T+1, d]

    def forward(self, batch: TokenizedSeqBatch, training: bool = False,
                generator: Optional[torch.Generator] = None, seeds: Optional[Seeds] = None) -> ModelOutput:
        """Teacher-forced loss. With `training` and a dropout rate above 0,
        the dropout seeds are `seeds` (an int32 device row of at least
        `n_dropout_sites`, read on the device; or t5.SiteSeeds, whose rows
        say which slice of a global batch this batch is) or, without it,
        drawn from `generator` (a CPU torch.Generator: one row of
        DropoutSeeds.draw)."""
        cfg = self.config
        L = cfg.num_hierarchies
        D = L + 1  # sem_ids_dim including the dedup column
        input_ids = strip_dedup_col(batch.sem_ids, D, L)
        mask = strip_dedup_col(batch.seq_mask.to(torch.int32), D, L)
        fut = batch.sem_ids_fut[:, :L]
        if seeds is None and training and generator is not None and cfg.t5_dropout > 0.0:
            seeds = DropoutSeeds.draw(generator, 1, self.n_dropout_sites)[0].to(self.device)

        enc, enc_mask = self.encoder_forward(input_ids, mask, batch.user_ids, training, seeds)
        dec = self.decoder_forward(fut, enc, enc_mask, training=training, seeds=seeds)[:, :-1]  # [B, L, d]

        if amp.active(dec):  # bf16 operands, f32 sums (ops/amp.py)
            logits = amp.matmul(dec.transpose(0, 1), self.heads).transpose(0, 1)
        else:
            logits = torch.einsum("bld,ldk->blk", dec, self.heads)  # [B, L, K]
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, 2, fut.long()[:, :, None])[..., 0]  # [B, L]
        loss_d = nll.mean(0)  # [L]
        return ModelOutput(loss=loss_d.sum(), logits=logits, loss_d=loss_d)

    def sampling_noise_shapes(self, batch: int) -> list:
        """The shape of each level's Gumbel noise in sampled-candidate
        generation: [B, K] at level 0, [B, k, K] after it (the shapes of
        the JAX package's draws, one per level from fold_in(rng, h))."""
        cfg = self.config
        K, k = cfg.codebook_size, cfg.top_k_for_generation
        return [(batch, K)] + [(batch, k, K)] * (cfg.num_hierarchies - 1)

    @torch.no_grad()
    def generate(
        self,
        sem_ids: torch.Tensor,  # [B, N*(L+1)] with dedup column (as tokenized)
        seq_mask: torch.Tensor,
        user_ids: Optional[torch.Tensor],
        prefix_table: PrefixTable,
        noise: Optional[Sequence[torch.Tensor]] = None,
    ) -> GenerationOutput:
        """Constrained beam search. Deterministic by default: all K codewords
        per level. With `config.sample_candidates`, each level draws
        n_cands = min(max(n_candidates, k), K) distinct candidates per beam
        by Gumbel top-k (ops/gumbel.py::sample_without_replacement) from
        `noise[h]`, Gumbel(0, 1) noise of `sampling_noise_shapes(B)[h]`;
        candidates with an invalid prefix score -1e9."""
        cfg = self.config
        L, K, k = cfg.num_hierarchies, cfg.codebook_size, cfg.top_k_for_generation
        if cfg.sample_candidates and noise is None:
            raise ValueError("sample_candidates=True needs the Gumbel noise of every level "
                             "(Retriever.retrieve draws it from its own generator)")
        D = L + 1
        input_ids = strip_dedup_col(sem_ids, D, L)
        mask = strip_dedup_col(seq_mask.to(torch.int32), D, L)
        B = input_ids.shape[0]

        enc, enc_mask = self.encoder_forward(input_ids, mask, user_ids)
        # cross-attention K/V are level-invariant: project them once
        cross_kv = self.decoder.cross_kv(enc)
        fused = self.decoder.use_fused_decode(enc.shape[1])
        weights = self.decoder.decode_weights() if fused else None

        def decode_last(prefix: Optional[torch.Tensor], beams: int) -> torch.Tensor:
            """Last-position decoder states [B*beams, d] for one level."""
            if not fused:
                return self.decoder_forward(prefix, enc, enc_mask, beams, cross_kv)[:, -1]
            embs = self._decoder_embs(prefix, B * beams)
            T = embs.shape[1]
            y = self.decoder.fused_decode(
                embs.reshape(B, beams * T, -1), cross_kv, enc_mask, beams, weights
            )
            return y.reshape(B, beams, T, -1)[:, :, -1].reshape(B * beams, -1)

        def scores(dec_last: torch.Tensor, h: int, parent_keys: torch.Tensor):
            """Level-h (scores, candidate ids) per parent, invalid prefixes -1e9:
            all K children, or n_cands sampled ones."""
            logp = torch.log_softmax(dec_last @ self.heads[h], dim=-1)
            child_ok = valid_children(prefix_table, h, parent_keys)[..., :K]
            logp = logp.reshape(child_ok.shape)
            if cfg.sample_candidates:
                n_cands = min(max(cfg.n_candidates, k), K)
                cand = sample_without_replacement(logp, n_cands, noise=noise[h])
                valid = torch.gather(child_ok, -1, cand.long())
                return torch.where(valid, torch.gather(logp, -1, cand.long()), NEG_INF), cand
            return torch.where(child_ok, logp, NEG_INF), None

        def chosen_ids(cand: Optional[torch.Tensor], idx: torch.Tensor, n: int) -> torch.Tensor:
            """Candidate ids at flat top-k positions `idx` over rows of n."""
            if cand is None:
                return (idx % n).to(torch.int32)
            return torch.gather(cand.reshape(B, -1), 1, idx)

        # level 0: all beams share the empty prefix
        t0 = prefix_table.level_keys[0]
        key_dtype = torch.int32 if t0.dtype == torch.bool else t0.dtype
        zero_keys = torch.zeros(B, dtype=key_dtype, device=enc.device)
        s0, cand0 = scores(decode_last(None, 1), 0, zero_keys)
        beam_logp, top_idx = top_k(s0, k)
        beam_ids = chosen_ids(cand0, top_idx, s0.shape[-1])[:, :, None]  # [B, k, 1]
        beam_keys = extend_keys(prefix_table, zero_keys[:, None], beam_ids[..., 0])

        for h in range(1, L):
            dec = decode_last(beam_ids.reshape(B * k, h), k)
            s, cand = scores(dec, h, beam_keys)  # [B, k, n]
            n = s.shape[-1]
            total = beam_logp[:, :, None] + s
            beam_logp, top_idx = top_k(total.reshape(B, k * n), k)
            parent = top_idx // n
            chosen = chosen_ids(cand, top_idx, n)
            parent_ids = torch.gather(beam_ids, 1, parent[:, :, None].expand(-1, -1, h))
            beam_ids = torch.cat([parent_ids, chosen[:, :, None]], dim=-1)
            beam_keys = extend_keys(prefix_table, torch.gather(beam_keys, 1, parent), chosen)

        return GenerationOutput(sem_ids=beam_ids, log_probas=beam_logp)
