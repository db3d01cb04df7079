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

An index is saved and loaded (`save_index`, `load_index`) in the JAX
package's file, an `np.savez_compressed` archive of `cached_ids` and a
fingerprint of the RQ-VAE that built it, so either package reads the
other's. `extend_corpus_ids` admits new items with the dedup column a full
rebuild would give them, encoding them as the index build does.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
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

    @property
    def n_layers(self) -> int:
        return self.model.config.n_layers

    @property
    def sem_ids_dim(self) -> int:
        """Tokens per item, the dedup column included."""
        return self.n_layers + 1

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
    def _encode_index(self, item_features) -> torch.Tensor:
        """[N, L] ids as the index build takes them: one rq_encode launch at
        `precision` where `use_kernel`, else the model's f32 path."""
        if self.use_kernel:
            x = torch.as_tensor(item_features, dtype=torch.float32, device=self.device)
            return fused_encode_quantize(
                x, self.model.encoder.kernels(), self.model.codebooks.detach(),
                n_levels=self.model.config.n_layers, precision=self.precision,
            )
        return self.encode_batch(item_features)

    @torch.no_grad()
    def precompute_corpus_ids(self, item_features) -> torch.Tensor:
        """Tokenize the whole corpus: encode -> pack -> dedup -> concat."""
        ids = self._encode_index(item_features)
        keys = pack_sem_id_tuples(ids, self.model.config.codebook_size)
        dedup = dedup_counts_from_keys(keys)
        self.cached_ids = torch.cat([ids, dedup[:, None].to(ids.dtype)], dim=1)
        return self.cached_ids

    # ---- index persistence and growth ----

    def _index_fingerprint(self) -> np.ndarray:
        """Geometry and codebook sums, in float64, of the RQ-VAE that defines
        the index (the JAX package's fingerprint, value for value)."""
        cfg = self.model.config
        cb = self.model.codebooks.detach().cpu().double().numpy()
        return np.asarray([float(cfg.n_layers), float(cfg.codebook_size), float(cb.shape[-1]),
                           float(cb.sum()), float(np.abs(cb).sum())])

    def save_index(self, path: str) -> None:
        """Write cached_ids and the fingerprint (np.savez_compressed, the JAX
        package's file)."""
        if self.cached_ids is None:
            raise RuntimeError("no corpus index built; nothing to save")
        np.savez_compressed(path, cached_ids=self.cached_ids.cpu().numpy(), fingerprint=self._index_fingerprint())

    def load_index(self, path: str) -> torch.Tensor:
        """Read a saved index (either package's) after checking that this
        tokenizer's RQ-VAE built it."""
        with np.load(path) as z:
            fp, cached = z["fingerprint"], z["cached_ids"]
        mine = self._index_fingerprint()
        if fp.shape != mine.shape or not np.allclose(fp, mine):
            raise ValueError(f"index at {path} was built by a different RQ-VAE (fingerprint {fp} != {mine})")
        self.cached_ids = torch.as_tensor(cached, dtype=torch.int32).to(self.device)
        return self.cached_ids

    @torch.no_grad()
    def extend_corpus_ids(self, new_features) -> torch.Tensor:
        """Append [M, L+1] rows for new items to cached_ids and return them.
        A row's dedup column is what a full rebuild gives it: the count of
        equal tuples among the existing items (two searchsorted over their
        sorted keys) plus the count of earlier equal tuples in this batch.
        The encode runs as the index build's (kernel 1 on the card)."""
        if self.cached_ids is None:
            raise RuntimeError("extend_corpus_ids needs an existing index; call precompute_corpus_ids first")
        L, K = self.n_layers, self.model.config.codebook_size
        ids = self._encode_index(new_features)
        keys = pack_sem_id_tuples(ids, K)
        old_sorted = torch.sort(pack_sem_id_tuples(self.cached_ids[:, :L], K)).values
        before = (torch.searchsorted(old_sorted, keys, side="right")
                  - torch.searchsorted(old_sorted, keys, side="left"))
        dedup = dedup_counts_from_keys(keys) + before.to(torch.int32)
        rows = torch.cat([ids, dedup[:, None].to(ids.dtype)], dim=1)
        self.cached_ids = torch.cat([self.cached_ids, rows])
        return rows

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
    mask = seq_mask.bool()[:, :, None].expand(B, N_seq, D).reshape(B, N_seq * D)
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
