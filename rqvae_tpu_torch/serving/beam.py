"""Corpus prefix trie for constrained decoding (port of rqvae_tpu/serving/beam.py).

Each corpus tuple prefix is packed into an integer key (level 0 in the
most-significant bits, ops/dedup.py). A level is either a dense bool
row-bitmap [K^h, 2^bits] indexed by (parent key, child id), when
K^(h+1) <= dense_limit, or a sorted key array searched by binary search.
"""

from __future__ import annotations

from typing import Tuple

import torch

from rqvae_tpu_torch.ops.dedup import id_bits, pack_sem_id_tuples


class PrefixTable:
    """Per-level prefix validity tables: bool [K^h, 2^bits] row-bitmaps or
    sorted int key arrays, told apart by dtype; `bits` per level."""

    __slots__ = ("level_keys", "bits")

    def __init__(self, level_keys: Tuple[torch.Tensor, ...], bits: int):
        self.level_keys = tuple(level_keys)
        self.bits = bits


def _sentinel(dtype: torch.dtype) -> int:
    """Pad value for sorted-key levels under `capacity`: the dtype max sorts
    after every valid key and never equals one."""
    return int(torch.iinfo(dtype).max)


def build_prefix_table(
    corpus_ids: torch.Tensor,  # [N, L], dedup column stripped
    codebook_size: int,
    dense_limit: int = 1 << 26,  # 64M bools = 64 MB; covers 256^3
    capacity: int | None = None,
) -> PrefixTable:
    """`capacity` (>= N) pads sorted-key levels with the sentinel so the
    table keeps its shape while a corpus grows."""
    N, L = corpus_ids.shape
    bits = id_bits(codebook_size)
    W = 1 << bits
    cap = N if capacity is None else int(capacity)
    if cap < N:
        raise ValueError(f"capacity {cap} < corpus size {N}")
    tables = []
    for h in range(L):
        keys = pack_sem_id_tuples(corpus_ids[:, : h + 1], codebook_size)
        size = 1 << (bits * (h + 1))
        if size <= dense_limit:
            flat = torch.zeros(size, dtype=torch.bool, device=corpus_ids.device)
            flat[keys.long()] = True
            tables.append(flat.reshape(size // W, W))
        else:
            if cap > N:
                if bits * (h + 1) >= torch.iinfo(keys.dtype).bits - 1:
                    raise ValueError("capacity padding needs headroom above the key space")
                pad = torch.full((cap - N,), _sentinel(keys.dtype), dtype=keys.dtype,
                                 device=keys.device)
                keys = torch.cat([keys, pad])
            tables.append(torch.sort(keys).values)
    return PrefixTable(level_keys=tuple(tables), bits=bits)


def extend_prefix_table(
    table: PrefixTable,
    new_corpus_ids: torch.Tensor,  # [M, L] semantic ids of the admitted items
    codebook_size: int,
    n_valid_old: int,  # corpus size before this extension
) -> PrefixTable:
    """Admit M new corpus tuples into the trie, IN PLACE: no level changes
    its shape or its storage, so a CUDA graph that captured the table reads
    the grown trie. Dense levels set the bits of the new (parent row, child
    column) pairs; sorted levels overwrite the sentinel slots
    [n_valid_old, n_valid_old + M) and re-sort into the same storage.
    Requires capacity >= n_valid_old + M. Returns `table`."""
    M, L = new_corpus_ids.shape
    if L != len(table.level_keys):
        raise ValueError(f"{L} levels of ids for a {len(table.level_keys)}-level table")
    W = 1 << table.bits
    for h, t in enumerate(table.level_keys):
        keys = pack_sem_id_tuples(new_corpus_ids[:, : h + 1], codebook_size)
        if t.dtype == torch.bool:
            keys = keys.long()
            t[keys >> table.bits, keys & (W - 1)] = True
        else:
            if n_valid_old + M > t.shape[0]:
                raise ValueError(f"prefix-table capacity {t.shape[0]} exceeded: {n_valid_old} + {M} items")
            t[n_valid_old : n_valid_old + M] = keys.to(t.dtype)
            t.copy_(torch.sort(t).values)
    return table


def is_valid_prefix(table: PrefixTable, level: int, keys: torch.Tensor) -> torch.Tensor:
    """keys: packed prefixes of length level+1, any shape -> bool mask."""
    t = table.level_keys[level]
    if t.dtype == torch.bool:
        keys = keys.long()
        return t[keys >> table.bits, keys & ((1 << table.bits) - 1)]
    keys = keys.to(t.dtype)
    idx = torch.clamp(torch.searchsorted(t, keys, side="left"), 0, t.shape[0] - 1)
    return t[idx] == keys


def valid_children(table: PrefixTable, level: int, parent_keys: torch.Tensor) -> torch.Tensor:
    """Validity of all 2^bits child extensions of each parent prefix.

    parent_keys: packed length-`level` prefixes, any shape [..] (zeros at
    level 0). Returns bool [.., 2^bits]; columns >= codebook_size read False."""
    t = table.level_keys[level]
    if t.dtype == torch.bool:
        return t[parent_keys.long()]
    child = torch.arange(1 << table.bits, dtype=t.dtype, device=t.device)
    keys = (parent_keys[..., None].to(t.dtype) << table.bits) | child
    idx = torch.clamp(torch.searchsorted(t, keys, side="left"), 0, t.shape[0] - 1)
    return t[idx] == keys


def extend_keys(table: PrefixTable, parent_keys: torch.Tensor,
                candidate_ids: torch.Tensor) -> torch.Tensor:
    """Parent prefix keys [..] extended with one more level's ids [..]."""
    return (parent_keys << table.bits) | candidate_ids.to(parent_keys.dtype)
