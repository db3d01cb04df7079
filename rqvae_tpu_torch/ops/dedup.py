"""Semantic-ID tuple packing and the dedup column (port of rqvae_tpu/ops/dedup.py).

The dedup column for corpus item i is the number of EARLIER items (j < i)
whose full L-level tuple is identical. Each tuple is packed into one integer
key and the counts come from one stable sort, with corpus order as the
tiebreaker, so they are exact. The stage-1 trainer's id-diversity metrics
(tuple entropy, codebook usage per level) read the same keys and ids.
"""

from __future__ import annotations

import torch


def id_bits(codebook_size: int) -> int:
    """Bits needed per level."""
    return max(1, (int(codebook_size) - 1).bit_length())


def pack_sem_id_tuples(sem_ids: torch.Tensor, codebook_size: int) -> torch.Tensor:
    """Pack [..., L] tuples of IDs in [0, K) into unique integer keys.

    Level 0 occupies the most-significant bits, so key order is
    lexicographic tuple order (the prefix trie reuses the same keys).
    int32 when L * bits <= 31, int64 up to 62 bits.
    """
    L = sem_ids.shape[-1]
    bits = id_bits(codebook_size)
    if L * bits <= 31:
        dtype = torch.int32
    elif L * bits <= 62:
        dtype = torch.int64
    else:
        raise ValueError(f"Cannot pack {L} levels x {bits} bits into 62 bits")
    # Horner's form of sum(id_l << bits*(L-1-l)): the same integers, with no
    # host-made tensor (a copy to the card, which a CUDA graph cannot capture)
    ids = sem_ids.to(dtype)
    key = ids[..., 0]
    for level in range(1, L):
        key = key * (1 << bits) + ids[..., level]
    return key


def dedup_counts_from_keys(keys: torch.Tensor) -> torch.Tensor:
    """dedup[i] = #{j < i : keys[j] == keys[i]} -> int32 [N].

    A stable sort of the keys gives the permutation with ties in corpus
    order; each element's rank inside its run of equal keys is its count,
    and an inverse sort of the permutation carries the ranks home."""
    n = keys.shape[0]
    sorted_keys, order = torch.sort(keys, stable=True)
    idx = torch.arange(n, device=keys.device)
    is_start = torch.ones(n, dtype=torch.bool, device=keys.device)
    is_start[1:] = sorted_keys[1:] != sorted_keys[:-1]
    seg_start = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    rank_in_run = (idx - seg_start).to(torch.int32)
    inverse = torch.argsort(order)
    return rank_in_run[inverse]


def tuple_entropy(keys: torch.Tensor) -> torch.Tensor:
    """Entropy of the empirical distribution of packed tuple keys, -sum p log p."""
    _, counts = torch.unique(keys, return_counts=True)
    p = counts.to(torch.float32) / keys.shape[0]
    return -torch.sum(p * torch.log(p))


def codebook_usage(sem_ids: torch.Tensor, codebook_size: int) -> torch.Tensor:
    """Fraction of the codebook entries used, per level -> [L] float32."""
    return torch.stack([
        torch.mean((torch.bincount(sem_ids[:, level].long(), minlength=codebook_size) > 0).to(torch.float32))
        for level in range(sem_ids.shape[1])
    ])
