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
`shard_body` (serving/engine.py) reads the grown corpus. A lock orders
each update step against every query's enqueue, and the card is
synchronised around each step, so a query sees the corpus before or after a
step, never half of one.

Scale-out serving (`mesh`, parallel/mesh.py), the counterpart of the JAX
package's `make_shardmap_generate` and `Retriever(mesh=)`: the query batch is
padded with empty rows to a multiple of `batch_multiple` (the mesh's 'data'
size), split into contiguous shards, and each shard runs the whole query
(tokenization, the encoder, every beam level with kernels 2 and 3, the
inverse lookup) on its device, over the model and corpus state replicated
there; the shards' results are concatenated and the pad rows dropped.
Without a mesh the batch is one shard on the retriever's own device: the
same path, with no pad and no copy. Beam search is row independent, so no
collective is needed, and a shard's deterministic beams equal the unsharded
Retriever's on the same rows. Against one call on the whole batch they are
equal in f32; in bf16 a plain stage's cuBLAS products (the encoder and
cross K/V at the Amazon width, the decoder at ML-32M's) round otherwise at
another batch size, and some beams move. In sampled-candidate mode each shard draws
its own noise (the JAX shards fold their axis index into the key). The JAX
package's `_promote_serving_gates` has no counterpart: the port's kernel
gates never decline a device because there are several.
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
from rqvae_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, replicate
from rqvae_tpu_torch.serving.beam import PrefixTable, _sentinel, build_prefix_table, extend_prefix_table
from rqvae_tpu_torch.tokenizer.semids import SemanticIdTokenizer, _tokenize_from_cache
from rqvae_tpu_torch.utils.device import DeviceLike, resolve_device


class RetrievalResult(NamedTuple):
    item_ids: torch.Tensor  # [B, k] corpus item ids (-1 where no valid beam)
    sem_ids: torch.Tensor  # [B, k, L]
    log_probas: torch.Tensor  # [B, k]


class ShardState(NamedTuple):
    """What one shard's query reads on its device: the model and the corpus
    state (the retriever's own tensors on its device, copies elsewhere)."""

    model: EncoderDecoderRetrievalModel
    table: torch.Tensor
    sorted_keys: torch.Tensor
    sorted_items: torch.Tensor
    prefix_table: PrefixTable


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
        mesh: Optional[Mesh] = None,  # shard the index build and every query over its 'data' axis
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

        dev = resolve_device(mesh.data_devices[0] if device is None and mesh is not None else device)
        restored = ckpt_lib.load_checkpoint(rqvae_checkpoint)
        if not isinstance(restored["config"], RqVaeConfig):
            raise ValueError(f"{rqvae_checkpoint} is not an RQ-VAE checkpoint")
        rq = RqVae(restored["config"], device=dev)
        rq.load_state_dict(ckpt_lib.params_state_dict(restored))
        tokenizer = SemanticIdTokenizer(rq, tokenize_batch_size=tokenize_batch_size, precision=precision,
                                        device=dev, mesh=mesh)
        if index_path is not None and os.path.exists(index_path):
            tokenizer.load_index(index_path)
        else:
            tokenizer.precompute_corpus_ids(np.asarray(item_features, np.float32))
            if index_path is not None:
                tokenizer.save_index(index_path)

        restored = ckpt_lib.load_checkpoint(decoder_checkpoint)
        if not isinstance(restored["config"], RetrievalConfig):
            raise ValueError(f"{decoder_checkpoint} is not a decoder checkpoint")
        model = EncoderDecoderRetrievalModel(restored["config"], device=dev, seed=None)  # every parameter loaded next
        model.load_state_dict(ckpt_lib.params_state_dict(restored))
        return cls(model, tokenizer, device=dev, capacity=capacity, mesh=mesh)

    def __init__(
        self,
        model: EncoderDecoderRetrievalModel,
        tokenizer: SemanticIdTokenizer,
        device: DeviceLike = None,
        seed: Optional[int] = None,  # sampled candidates: the generator's seed (None: a random one)
        capacity: Optional[int] = None,  # the most items served; extend_corpus admits up to it
        mesh: Optional[Mesh] = None,  # shard every query's batch over the mesh's 'data' axis
    ):
        if tokenizer.cached_ids is None:
            raise ValueError("Tokenizer has no corpus index; call precompute_corpus_ids first")
        self.device = resolve_device(mesh.data_devices[0] if device is None and mesh is not None else device)
        self.mesh = mesh
        self.batch_multiple = 1 if mesh is None else mesh.shape[DATA_AXIS]  # a query batch is padded to this
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
        own = ShardState(self.model, self._table, self._sorted_keys, self._sorted_items, self.prefix_table)
        self._state = own
        devices = [self.device] if self.mesh is None else self.mesh.data_devices
        models = replicate(self.model, devices)
        copies = {d: own if d == self.device else ShardState(
            models[d], self._table.to(d), self._sorted_keys.to(d), self._sorted_items.to(d),
            PrefixTable(tuple(t.to(d) for t in self.prefix_table.level_keys), self.prefix_table.bits))
            for d in models}
        self.shards: List[ShardState] = [copies[d] for d in devices]  # one per 'data' shard

    def _refresh_copies(self) -> None:
        """Write the corpus state into the other devices' copies, in place."""
        for s in dict.fromkeys(self.shards):
            if s is not self._state:
                for dst, src in zip((s.table, s.sorted_keys, s.sorted_items, *s.prefix_table.level_keys),
                                    (self._table, self._sorted_keys, self._sorted_items,
                                     *self.prefix_table.level_keys)):
                    dst.copy_(src)

    def corpus_tensors(self) -> List[torch.Tensor]:
        """Every corpus-sized tensor a query reads (what a captured graph
        holds), the other devices' copies included."""
        out = [self._table, self._keys_cap, self._sorted_keys, self._sorted_items, *self.prefix_table.level_keys]
        for s in dict.fromkeys(self.shards):
            if s is not self._state:
                out += [s.table, s.sorted_keys, s.sorted_items, *s.prefix_table.level_keys]
        return out

    def _resort_inverse(self) -> None:
        """Sorted (key, earliest item) view of the packed keys, written into
        the existing storage; the stable sort keeps corpus order as the
        tiebreaker, so duplicate tuples resolve to the earliest item, and a
        sentinel slot maps to item -1."""
        keys, order = torch.sort(self._keys_cap, stable=True)
        self._sorted_keys.copy_(keys)
        self._sorted_items.copy_(torch.where(keys != self._sentinel, order, -1))

    def _sync(self) -> None:
        for s in dict.fromkeys(self.shards):
            if s.table.device.type == "cuda":
                torch.cuda.synchronize(s.table.device)

    def _update(self, step) -> None:
        """One corpus update step under the lock, with the card idle before
        it (no query still reads the state) and after it (the next query,
        on any stream, reads the step's result)."""
        with self._lock:
            self._sync()
            step()
            self._refresh_copies()
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

    def shard_body(self, i: int, hist: torch.Tensor, uids: torch.Tensor,
                   noise: Optional[List[torch.Tensor]] = None) -> RetrievalResult:
        """Shard i's whole query on its device's tensors, with no host read:
        what a CUDA graph captures (serving/engine.py), one per shard."""
        s = self.shards[i]
        tok = _tokenize_from_cache(s.table, uids, hist, torch.zeros_like(uids), hist >= 0)
        gen = s.model.generate(tok.sem_ids, tok.seq_mask, tok.user_ids, s.prefix_table, noise=noise)
        tuple_keys = pack_sem_id_tuples(gen.sem_ids, self.model.config.codebook_size)  # [B, k]
        idx = torch.clamp(
            torch.searchsorted(s.sorted_keys, tuple_keys.contiguous(), side="left"),
            0, s.sorted_keys.shape[0] - 1,
        )
        found = s.sorted_keys[idx] == tuple_keys
        items = torch.where(found, s.sorted_items[idx], -1)
        return RetrievalResult(item_ids=items, sem_ids=gen.sem_ids, log_probas=gen.log_probas)

    def _retrieve_body(self, hist: torch.Tensor, uids: torch.Tensor,
                       noise: Optional[List[torch.Tensor]] = None) -> RetrievalResult:
        """Shard 0's query: the whole query on the retriever's own device."""
        return self.shard_body(0, hist, uids, noise)

    @torch.no_grad()
    def retrieve(
        self,
        item_id_history,  # [B, N] item ids, -1 padded
        user_ids: Optional[np.ndarray] = None,
        noise: Optional[List[torch.Tensor]] = None,  # sampled candidates: given, else drawn
    ) -> RetrievalResult:
        """The batch padded to batch_multiple with empty rows, one query per
        shard on its device, the shards' results concatenated and the pad
        rows dropped (one shard without a mesh: no pad, no copy). Given noise
        covers the B rows (pad rows take zeros); else each shard draws its
        own."""
        hist = torch.as_tensor(np.asarray(item_id_history), dtype=torch.int32, device=self.device)
        B, n = hist.shape[0], self.batch_multiple
        if user_ids is None:
            uids = torch.zeros(B, dtype=torch.int32, device=self.device)
        else:
            uids = torch.as_tensor(np.asarray(user_ids), dtype=torch.int32, device=self.device)
        pad = -B % n
        if pad:
            hist = torch.cat([hist, hist.new_full((pad, hist.shape[1]), -1)])
            uids = torch.cat([uids, uids.new_zeros(pad)])
            if noise is not None:
                noise = [torch.cat([g, g.new_zeros((pad, *g.shape[1:]))]) for g in noise]
        rows = (B + pad) // n
        outs = []
        with self._lock:
            for i, s in enumerate(self.shards):
                d = s.table.device
                part = slice(i * rows, (i + 1) * rows)
                shard_noise = self.draw_noise(rows) if noise is None else [g[part] for g in noise]
                if shard_noise is not None:
                    shard_noise = [g.to(d) for g in shard_noise]
                outs.append(self.shard_body(i, hist[part].to(d), uids[part].to(d), shard_noise))
        if n == 1:
            return outs[0]
        return RetrievalResult(*(torch.cat([o[f].to(self.device) for o in outs])[:B] for f in range(3)))
