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

With `mesh` (parallel/mesh.py), the index build is sharded as the JAX
tokenizer's shard_map build: the corpus rows are split into the mesh's
contiguous 'data' shards, each shard is encoded on its device by the RQ-VAE
replicated there (kernel 1 once per shard on the card), and the ids are
concatenated; the dedup column is then computed over the whole corpus, as
the JAX build dedups the gathered ids. Rows are independent, so the ids equal
the unsharded build's. `extend_corpus_ids` encodes unsharded, as the JAX
tokenizer's extension does.

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
from rqvae_tpu_torch.parallel.mesh import Mesh, replicate, shard_rows
from rqvae_tpu_torch.utils.device import DeviceLike, resolve_device


class SemanticIdTokenizer:
    """Owns a frozen RQ-VAE and the cached corpus-ID table [N, L+1]."""

    def __init__(
        self,
        model: RqVae,
        tokenize_batch_size: int = 8192,
        precision: str = "bf16",  # the index build's kernel precision, "bf16" or "f32"
        device: DeviceLike = None,  # None: the mesh's first device, or the card
        mesh: Optional[Mesh] = None,  # shard the index build over the mesh's 'data' axis
    ):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
        self.device = resolve_device(mesh.data_devices[0] if device is None and mesh is not None else device)
        self.model = model.to(self.device).eval()
        self.tokenize_batch_size = tokenize_batch_size
        self.precision = precision
        self.mesh = mesh
        self.shard_models = None if mesh is None else replicate(self.model, mesh.data_devices)
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
        """Whether the index build on the tokenizer's device runs kernel 1."""
        return self._kernel_on(self.device)

    def _kernel_on(self, device: torch.device) -> bool:
        return device.type == "cuda" and pallas_supported(self.model.config)

    def _model_ids(self, model: RqVae, x: torch.Tensor) -> torch.Tensor:
        """The model's f32 path on x's device, in chunks."""
        b = max(1, self.tokenize_batch_size)
        chunks = [model.get_semantic_ids(x[i : i + b]).sem_ids for i in range(0, x.shape[0], b)]
        if not chunks:
            return torch.empty((0, model.config.n_layers), dtype=torch.int32, device=x.device)
        return torch.cat(chunks)

    @torch.no_grad()
    def encode_batch(self, x: torch.Tensor) -> torch.Tensor:
        """[B, D] features -> [B, L] int32 semantic ids (no dedup column),
        by the model's f32 path on every device, as the JAX tokenizer's."""
        return self._model_ids(self.model, torch.as_tensor(x, dtype=torch.float32, device=self.device))

    def _index_ids(self, model: RqVae, x: torch.Tensor, kernel: bool) -> torch.Tensor:
        """[N, L] ids of x as the index build takes them on x's device: one
        rq_encode launch at `precision` with `kernel` (on a card, for
        configurations the kernel supports), else the model's f32 path."""
        if kernel:
            return fused_encode_quantize(x, model.encoder.kernels(), model.codebooks.detach(),
                                         n_levels=model.config.n_layers, precision=self.precision)
        return self._model_ids(model, x)

    @torch.no_grad()
    def _encode_index(self, item_features, sharded: bool = True) -> torch.Tensor:
        """[N, L] ids as the index build takes them, on the tokenizer's
        device: over the mesh's shards (each on its device) when there is a
        mesh and `sharded`, else on the tokenizer's device."""
        x = torch.as_tensor(item_features, dtype=torch.float32)
        if self.mesh is None or not sharded:
            return self._index_ids(self.model, x.to(self.device), self.use_kernel)
        parts = [self._index_ids(self.shard_models[xs.device], xs, self._kernel_on(xs.device)).to(self.device)
                 for xs in shard_rows(self.mesh, x) if xs.shape[0]]
        return torch.cat(parts)

    @torch.no_grad()
    def precompute_corpus_ids(self, item_features) -> torch.Tensor:
        """Tokenize the whole corpus: encode (per shard with a mesh) -> pack
        -> dedup over the whole corpus -> concat."""
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
        The encode runs as the index build's (kernel 1 on the card), unsharded
        on a mesh too, as the JAX tokenizer extends."""
        if self.cached_ids is None:
            raise RuntimeError("extend_corpus_ids needs an existing index; call precompute_corpus_ids first")
        L, K = self.n_layers, self.model.config.codebook_size
        ids = self._encode_index(new_features, sharded=False)
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
