"""End-to-end serving: user history (item ids) -> top-k retrieved items
(port of rqvae_tpu/serving/retriever.py).

A query runs cached-table tokenization -> T5 encoder -> L levels of
constrained beam search -> inverse lookup of the generated tuples to corpus
items, one binary search over the packed corpus keys (duplicate tuples
resolve to the earliest item, dedup column 0).

Live catalog growth: with `capacity=<max corpus size>`, `extend_corpus`
admits new items. Every corpus-sized tensor (the tokenize table, the packed
keys, the sorted keys and items, each prefix-trie level) is allocated once at
`capacity` and only ever updated in place, so a CUDA graph captured over
`_retrieve_body` (serving/engine.py) reads the grown corpus. A lock orders
each update step against every query's enqueue, and the card is
synchronised around each step, so a query sees the corpus before or after a
step, never half of one.
"""

from __future__ import annotations

import secrets
import threading
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from rqvae_tpu_torch.models.retrieval import EncoderDecoderRetrievalModel
from rqvae_tpu_torch.ops.dedup import pack_sem_id_tuples
from rqvae_tpu_torch.ops.gumbel import sample_gumbel
from rqvae_tpu_torch.serving.beam import _sentinel, build_prefix_table, extend_prefix_table
from rqvae_tpu_torch.tokenizer.semids import SemanticIdTokenizer, _tokenize_from_cache
from rqvae_tpu_torch.utils.device import DeviceLike, resolve_device


class RetrievalResult(NamedTuple):
    item_ids: torch.Tensor  # [B, k] corpus item ids (-1 where no valid beam)
    sem_ids: torch.Tensor  # [B, k, L]
    log_probas: torch.Tensor  # [B, k]


class Retriever:
    """history (item ids) -> top-k item ids, over the tokenizer's corpus
    index. Build directly or with `Retriever.from_checkpoints`."""

    @classmethod
    def from_checkpoints(
        cls,
        rqvae_checkpoint: str,
        decoder_checkpoint: str,
        item_features,
        tokenize_batch_size: int = 8192,
        capacity: Optional[int] = None,
        index_path: Optional[str] = None,
        device: DeviceLike = None,
        precision: str = "bf16",  # the index build's, as SemanticIdTokenizer's
    ) -> "Retriever":
        """Load both stage checkpoints (either format: the JAX package's
        `.msgpack` or this package's `.pt`), take the corpus index from
        `index_path` when that file exists (checked against the RQ-VAE by
        its fingerprint) or else build it (kernel 1 on the card) and save it
        there, and return a retriever ready to serve."""
        import os

        from rqvae_tpu_torch.models.retrieval import RetrievalConfig
        from rqvae_tpu_torch.models.rqvae import RqVae, RqVaeConfig
        from rqvae_tpu_torch.utils import checkpoint as ckpt_lib

        dev = resolve_device(device)
        restored = ckpt_lib.load_checkpoint(rqvae_checkpoint)
        if not isinstance(restored["config"], RqVaeConfig):
            raise ValueError(f"{rqvae_checkpoint} is not an RQ-VAE checkpoint")
        rq = RqVae(restored["config"], device=dev)
        rq.load_state_dict(ckpt_lib.params_state_dict(restored))
        tokenizer = SemanticIdTokenizer(rq, tokenize_batch_size=tokenize_batch_size, precision=precision,
                                        device=dev)
        if index_path is not None and os.path.exists(index_path):
            tokenizer.load_index(index_path)
        else:
            tokenizer.precompute_corpus_ids(np.asarray(item_features, np.float32))
            if index_path is not None:
                tokenizer.save_index(index_path)

        restored = ckpt_lib.load_checkpoint(decoder_checkpoint)
        if not isinstance(restored["config"], RetrievalConfig):
            raise ValueError(f"{decoder_checkpoint} is not a decoder checkpoint")
        model = EncoderDecoderRetrievalModel(restored["config"], device=dev)
        model.load_state_dict(ckpt_lib.params_state_dict(restored))
        return cls(model, tokenizer, device=dev, capacity=capacity)

    def __init__(
        self,
        model: EncoderDecoderRetrievalModel,
        tokenizer: SemanticIdTokenizer,
        device: DeviceLike = None,
        seed: Optional[int] = None,  # sampled candidates: the generator's seed (None: a random one)
        capacity: Optional[int] = None,  # the most items served; extend_corpus admits up to it
    ):
        if tokenizer.cached_ids is None:
            raise ValueError("Tokenizer has no corpus index; call precompute_corpus_ids first")
        self.device = resolve_device(device)
        if tokenizer.device != self.device:
            raise ValueError(f"tokenizer is on {tokenizer.device}, retriever on {self.device}")
        self.model = model.to(self.device).eval()
        self.tokenizer = tokenizer
        self.seed = secrets.randbits(31) if seed is None else int(seed)
        # sampled-candidate noise: drawn on the host, one draw per retrieve()
        self._generator = torch.Generator().manual_seed(self.seed)
        self._lock = threading.Lock()  # one corpus update step, or one query's enqueue
        self._extend_lock = threading.Lock()  # one extension at a time
        self._n_items = tokenizer.cached_ids.shape[0]
        self.capacity = self._n_items if capacity is None else int(capacity)
        if self.capacity < self._n_items:
            raise ValueError(f"capacity {self.capacity} below the corpus size {self._n_items}")
        self._build_corpus_state()

    @property
    def n_items(self) -> int:
        """Items admitted so far: corpus ids [0, n_items) are servable."""
        return self._n_items

    def _build_corpus_state(self) -> None:
        """Allocate the capacity-sized serving state once: the tokenize table
        (zero rows past the corpus, reachable only by ids not admitted yet),
        the prefix trie, the corpus-order packed keys (the sentinel, which
        sorts last and equals no key, past the corpus) and their sorted view."""
        L = self.model.config.num_hierarchies
        K = self.model.config.codebook_size
        cached = self.tokenizer.cached_ids
        n, D = cached.shape
        cap = self.capacity
        self.prefix_table = build_prefix_table(cached[:, :L], K, capacity=cap)
        self._table = torch.zeros((cap, D), dtype=cached.dtype, device=self.device)
        self._table[:n] = cached
        keys = pack_sem_id_tuples(cached[:, :L], K)
        self._sentinel = _sentinel(keys.dtype)
        self._keys_cap = torch.full((cap,), self._sentinel, dtype=keys.dtype, device=self.device)
        self._keys_cap[:n] = keys
        self._sorted_keys = torch.empty_like(self._keys_cap)
        self._sorted_items = torch.empty(cap, dtype=torch.int32, device=self.device)
        self._resort_inverse()

    def corpus_tensors(self) -> List[torch.Tensor]:
        """Every corpus-sized tensor a query reads (what a captured graph holds)."""
        return [self._table, self._keys_cap, self._sorted_keys, self._sorted_items,
                *self.prefix_table.level_keys]

    def _resort_inverse(self) -> None:
        """Sorted (key, earliest item) view of the packed keys, written into
        the existing storage; the stable sort keeps corpus order as the
        tiebreaker, so duplicate tuples resolve to the earliest item, and a
        sentinel slot maps to item -1."""
        keys, order = torch.sort(self._keys_cap, stable=True)
        self._sorted_keys.copy_(keys)
        self._sorted_items.copy_(torch.where(keys != self._sentinel, order, -1))

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _update(self, step) -> None:
        """One corpus update step under the lock, with the card idle before
        it (no query still reads the state) and after it (the next query,
        on any stream, reads the step's result)."""
        with self._lock:
            self._sync()
            step()
            self._sync()

    @torch.no_grad()
    def extend_corpus(self, new_features) -> int:
        """Admit new items into live serving: tokenize them with the frozen
        RQ-VAE (the tokenizer's `extend_corpus_ids`: the dedup column of a
        full rebuild), then update the serving state in place in the JAX
        package's order: (1) the tokenize table, (2) the inverse lookup,
        (3) the prefix trie last, since it admits the new tuples into
        generation. Returns the new corpus size."""
        with self._extend_lock:
            m = len(new_features)
            n_old, n_new = self._n_items, self._n_items + m
            if n_new > self.capacity:
                raise ValueError(f"corpus extension to {n_new} items exceeds capacity {self.capacity}; "
                                 "rebuild the Retriever with more headroom")
            rows = self.tokenizer.extend_corpus_ids(new_features)
            L = self.model.config.num_hierarchies
            K = self.model.config.codebook_size

            def inverse():
                self._keys_cap[n_old:n_new] = pack_sem_id_tuples(rows[:, :L], K)
                self._resort_inverse()

            self._update(lambda: self._table[n_old:n_new].copy_(rows))
            self._update(inverse)
            self._update(lambda: extend_prefix_table(self.prefix_table, rows[:, :L], K, n_valid_old=n_old))
            self._n_items = n_new
            return n_new

    def draw_noise(self, batch: int) -> Optional[List[torch.Tensor]]:
        """Sampled candidates: the Gumbel noise of one call (every level),
        drawn from the retriever's own generator, which each call advances;
        None for deterministic generation."""
        if not self.model.config.sample_candidates:
            return None
        return [sample_gumbel(shape, self._generator) for shape in self.model.sampling_noise_shapes(batch)]

    def _retrieve_body(self, hist: torch.Tensor, uids: torch.Tensor,
                       noise: Optional[List[torch.Tensor]] = None) -> RetrievalResult:
        """The whole query on device tensors, with no host read: what a CUDA
        graph captures (serving/engine.py)."""
        tok = _tokenize_from_cache(self._table, uids, hist, torch.zeros_like(uids), hist >= 0)
        gen = self.model.generate(tok.sem_ids, tok.seq_mask, tok.user_ids, self.prefix_table, noise=noise)
        tuple_keys = pack_sem_id_tuples(gen.sem_ids, self.model.config.codebook_size)  # [B, k]
        idx = torch.clamp(
            torch.searchsorted(self._sorted_keys, tuple_keys.contiguous(), side="left"),
            0, self._sorted_keys.shape[0] - 1,
        )
        found = self._sorted_keys[idx] == tuple_keys
        items = torch.where(found, self._sorted_items[idx], -1)
        return RetrievalResult(item_ids=items, sem_ids=gen.sem_ids, log_probas=gen.log_probas)

    @torch.no_grad()
    def retrieve(
        self,
        item_id_history,  # [B, N] item ids, -1 padded
        user_ids: Optional[np.ndarray] = None,
        noise: Optional[List[torch.Tensor]] = None,  # sampled candidates: given, else drawn
    ) -> RetrievalResult:
        hist = torch.as_tensor(np.asarray(item_id_history), dtype=torch.int32, device=self.device)
        B = hist.shape[0]
        if user_ids is None:
            uids = torch.zeros(B, dtype=torch.int32, device=self.device)
        else:
            uids = torch.as_tensor(np.asarray(user_ids), dtype=torch.int32, device=self.device)
        if noise is None:
            noise = self.draw_noise(B)
        if noise is not None:
            noise = [g.to(self.device) for g in noise]
        with self._lock:
            return self._retrieve_body(hist, uids, noise)
