"""Semantic-ID tokenizer: corpus index build + sequence lookup
(port of rqvae_tpu/tokenizer/semids.py).

`precompute_corpus_ids` tokenizes every corpus item with the frozen RQ-VAE
and appends the dedup column (count of earlier items with an identical
L-tuple). As in the JAX tokenizer, the index build alone takes the kernel
route: on the card, for configurations the kernel supports, the encode is one
launch of the rq_encode kernel (ops/cuda/rq_encode.py) at `precision`, bf16
by default as the reference's `pallas_precision`; elsewhere, and in
`encode_batch` on every device, it is RqVae.get_semantic_ids in chunks.
Sequence tokenization is a table lookup.
"""

from __future__ import annotations

from typing import Optional

import torch

from rqvae_tpu_torch.data.schemas import SeqBatch, TokenizedSeqBatch
from rqvae_tpu_torch.models.rqvae import RqVae
from rqvae_tpu_torch.ops.cuda.rq_encode import PRECISIONS, fused_encode_quantize, pallas_supported
from rqvae_tpu_torch.ops.dedup import dedup_counts_from_keys, pack_sem_id_tuples
from rqvae_tpu_torch.utils.device import DeviceLike, resolve_device


class SemanticIdTokenizer:
    """Owns a frozen RQ-VAE and the cached corpus-ID table [N, L+1]."""

    def __init__(
        self,
        model: RqVae,
        tokenize_batch_size: int = 8192,
        precision: str = "bf16",  # the index build's kernel precision, "bf16" or "f32"
        device: DeviceLike = None,
    ):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.tokenize_batch_size = tokenize_batch_size
        self.precision = precision
        self.cached_ids: Optional[torch.Tensor] = None  # [N, L+1] int32

    def reset(self) -> None:
        self.cached_ids = None

    @property
    def use_kernel(self) -> bool:
        return self.device.type == "cuda" and pallas_supported(self.model.config)

    @torch.no_grad()
    def encode_batch(self, x: torch.Tensor) -> torch.Tensor:
        """[B, D] features -> [B, L] int32 semantic ids (no dedup column),
        by the model's f32 path on every device, as the JAX tokenizer's."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        b = max(1, self.tokenize_batch_size)
        chunks = [self.model.get_semantic_ids(x[i : i + b]).sem_ids for i in range(0, x.shape[0], b)]
        if not chunks:
            return torch.empty((0, self.model.config.n_layers), dtype=torch.int32, device=self.device)
        return torch.cat(chunks)

    @torch.no_grad()
    def precompute_corpus_ids(self, item_features) -> torch.Tensor:
        """Tokenize the whole corpus: encode -> pack -> dedup -> concat. The
        encode is one rq_encode launch at `precision` where `use_kernel`."""
        if self.use_kernel:
            x = torch.as_tensor(item_features, dtype=torch.float32, device=self.device)
            ids = fused_encode_quantize(
                x, self.model.encoder.kernels(), self.model.codebooks.detach(),
                n_levels=self.model.config.n_layers, precision=self.precision,
            )
        else:
            ids = self.encode_batch(item_features)
        keys = pack_sem_id_tuples(ids, self.model.config.codebook_size)
        dedup = dedup_counts_from_keys(keys)
        self.cached_ids = torch.cat([ids, dedup[:, None].to(ids.dtype)], dim=1)
        return self.cached_ids

    def __call__(self, batch: SeqBatch) -> TokenizedSeqBatch:
        """Tokenize a sequence batch by cached-table lookup."""
        if self.cached_ids is None:
            raise RuntimeError("Call precompute_corpus_ids before tokenizing sequences")
        dev = self.device
        return _tokenize_from_cache(
            self.cached_ids,
            torch.as_tensor(batch.user_ids, device=dev),
            torch.as_tensor(batch.ids, device=dev),
            torch.as_tensor(batch.ids_fut, device=dev),
            torch.as_tensor(batch.seq_mask, device=dev),
        )


def _tokenize_from_cache(
    cached_ids: torch.Tensor,  # [N, D] with D = L+1
    user_ids: torch.Tensor,  # [B]
    ids: torch.Tensor,  # [B, N_seq] -1 padded
    ids_fut: torch.Tensor,  # [B]
    seq_mask: torch.Tensor,  # [B, N_seq] bool
) -> TokenizedSeqBatch:
    """Gathers clamp item ids into [0, N) at both ends, as JAX's gathers do."""
    B, N_seq = ids.shape
    N, D = cached_ids.shape
    sem = cached_ids[torch.clamp(ids.long(), 0, N - 1)]  # [B, N_seq, D]
    mask = torch.repeat_interleave(seq_mask.bool(), D, dim=1)  # [B, N_seq*D]
    sem_ids = torch.where(mask, sem.reshape(B, N_seq * D), -1)
    sem_ids_fut = cached_ids[torch.clamp(ids_fut.long(), 0, N - 1)].reshape(B, D)
    arange = torch.arange(D, dtype=torch.int32, device=ids.device)
    return TokenizedSeqBatch(
        user_ids=user_ids,
        sem_ids=sem_ids,
        sem_ids_fut=sem_ids_fut,
        seq_mask=mask,
        token_type_ids=arange.repeat(B, N_seq),
        token_type_ids_fut=arange.repeat(B, 1),
    )
