"""End-to-end serving: user history (item ids) -> top-k retrieved items
(port of rqvae_tpu/serving/retriever.py).

A query runs cached-table tokenization -> T5 encoder -> L levels of
constrained beam search -> inverse lookup of the generated tuples to corpus
items, one binary search over the packed corpus keys (duplicate tuples
resolve to the earliest item, dedup column 0).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from rqvae_tpu_torch.models.retrieval import EncoderDecoderRetrievalModel
from rqvae_tpu_torch.ops.dedup import pack_sem_id_tuples
from rqvae_tpu_torch.serving.beam import build_prefix_table
from rqvae_tpu_torch.tokenizer.semids import SemanticIdTokenizer, _tokenize_from_cache
from rqvae_tpu_torch.utils.device import DeviceLike, resolve_device


class RetrievalResult(NamedTuple):
    item_ids: torch.Tensor  # [B, k] corpus item ids (-1 where no valid beam)
    sem_ids: torch.Tensor  # [B, k, L]
    log_probas: torch.Tensor  # [B, k]


class Retriever:
    """history (item ids) -> top-k item ids, over the tokenizer's corpus index."""

    def __init__(
        self,
        model: EncoderDecoderRetrievalModel,
        tokenizer: SemanticIdTokenizer,
        device: DeviceLike = None,
    ):
        if tokenizer.cached_ids is None:
            raise ValueError("Tokenizer has no corpus index; call precompute_corpus_ids first")
        self.device = resolve_device(device)
        if tokenizer.device != self.device:
            raise ValueError(f"tokenizer is on {tokenizer.device}, retriever on {self.device}")
        self.model = model.to(self.device).eval()
        self.tokenizer = tokenizer
        self._rebuild_corpus_state()

    def _rebuild_corpus_state(self) -> None:
        """Derive the corpus-indexed serving state from the tokenizer's
        cached_ids: the tokenize table, the prefix trie and the tuple-key ->
        earliest-item inverse lookup."""
        L = self.model.config.num_hierarchies
        K = self.model.config.codebook_size
        self._table = self.tokenizer.cached_ids
        self.prefix_table = build_prefix_table(self._table[:, :L], K)
        self._keys = pack_sem_id_tuples(self._table[:, :L], K)
        self._resort_inverse()

    def _resort_inverse(self) -> None:
        """Sorted (key, earliest item) view of the corpus keys; the stable
        sort keeps corpus order as the tiebreaker, so duplicate tuples
        resolve to the earliest item."""
        self._sorted_keys, order = torch.sort(self._keys, stable=True)
        self._sorted_items = order.to(torch.int32)

    @torch.no_grad()
    def retrieve(
        self,
        item_id_history,  # [B, N] item ids, -1 padded
        user_ids: Optional[np.ndarray] = None,
    ) -> RetrievalResult:
        hist = torch.as_tensor(np.asarray(item_id_history), dtype=torch.int32, device=self.device)
        B = hist.shape[0]
        if user_ids is None:
            uids = torch.zeros(B, dtype=torch.int32, device=self.device)
        else:
            uids = torch.as_tensor(np.asarray(user_ids), dtype=torch.int32, device=self.device)
        tok = _tokenize_from_cache(self._table, uids, hist, torch.zeros_like(uids), hist >= 0)
        gen = self.model.generate(tok.sem_ids, tok.seq_mask, tok.user_ids, self.prefix_table)
        tuple_keys = pack_sem_id_tuples(gen.sem_ids, self.model.config.codebook_size)  # [B, k]
        idx = torch.clamp(
            torch.searchsorted(self._sorted_keys, tuple_keys.contiguous(), side="left"),
            0, self._sorted_keys.shape[0] - 1,
        )
        found = self._sorted_keys[idx] == tuple_keys
        items = torch.where(found, self._sorted_items[idx], -1)
        return RetrievalResult(item_ids=items, sem_ids=gen.sem_ids, log_probas=gen.log_probas)
