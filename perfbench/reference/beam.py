"""Constrained beam search over semantic-id tuples, and the inverse lookup.

Level 0 scores every first id by its log-probability (a log-softmax over all
K ids of head 0 at the decoder's first position); level h extends each of
the k beams by every id, adding the log-probability of head h at the beam's
last position. A candidate whose prefix no corpus item has scores -1e9. The
k best (ties to the lower flat index) survive each level. A finished tuple
maps to the earliest corpus item that has it.
"""

from __future__ import annotations

from typing import Tuple

import torch

from perfbench.reference.t5 import T5

NEG = -1e9


def prefix_sets(table: torch.Tensor, L: int, K: int):
    """Per level h, the sorted packed keys of the corpus's (h + 1)-prefixes."""
    key = torch.zeros(table.shape[0], dtype=torch.int64, device=table.device)
    out = []
    for h in range(L):
        key = key * K + table[:, h].long()
        out.append(torch.unique(key))
    return out


def _member(sorted_keys: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    idx = torch.searchsorted(sorted_keys, keys).clamp(max=sorted_keys.shape[0] - 1)
    return sorted_keys[idx] == keys


def _top_k(x: torch.Tensor, k: int):
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


@torch.no_grad()
def search(model: T5, enc: torch.Tensor, enc_mask: torch.Tensor, prefixes, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(tuples [B, k, L], log-probabilities [B, k]) for encoder outputs [B, Le, d]."""
    B, L, K = enc.shape[0], model.L, model.K
    dev = enc.device
    states = model.decoder(model.decoder_inputs(None, B), enc, enc_mask)[:, -1]
    logp = torch.log_softmax(model.level_logits(states, 0), dim=-1)
    ok = _member(prefixes[0], torch.arange(K, device=dev))[None, :].expand(B, K)
    score, ids = _top_k(torch.where(ok, logp, NEG), k)
    beams, keys = ids[:, :, None], ids.long()
    for h in range(1, L):
        enc_k = enc.repeat_interleave(k, 0)
        mask_k = enc_mask.repeat_interleave(k, 0)
        states = model.decoder(model.decoder_inputs(beams.reshape(B * k, h), B * k), enc_k, mask_k)[:, -1]
        logp = torch.log_softmax(model.level_logits(states, h), dim=-1).reshape(B, k, K)
        child = keys[:, :, None] * K + torch.arange(K, device=dev)
        cand = torch.where(_member(prefixes[h], child), logp, NEG)
        score, flat = _top_k((score[:, :, None] + cand).reshape(B, k * K), k)
        parent, chosen = flat // K, flat % K
        beams = torch.cat([torch.gather(beams, 1, parent[:, :, None].expand(-1, -1, h)), chosen[:, :, None]], 2)
        keys = torch.gather(keys, 1, parent) * K + chosen
    return beams, score


@torch.no_grad()
def level_log_probs(model: T5, enc: torch.Tensor, enc_mask: torch.Tensor, tuples: torch.Tensor):
    """Per level h, [B, k, K] the log-softmax over head h's ids after each
    given tuple's first h ids (teacher forced, unconstrained)."""
    B, k, L = tuples.shape
    flat = tuples.reshape(B * k, L).long()
    enc_k = enc.repeat_interleave(k, 0)
    mask_k = enc_mask.repeat_interleave(k, 0)
    states = model.decoder(model.decoder_inputs(flat, B * k), enc_k, mask_k)  # [B k, L + 1, d]
    return [torch.log_softmax(model.level_logits(states[:, h], h), dim=-1).reshape(B, k, -1) for h in range(L)]


def tuple_log_probs(levels, tuples: torch.Tensor) -> torch.Tensor:
    """[B, k] sum over levels of each tuple's log-probability, from
    `level_log_probs` of the same tuples, as the search scores a valid beam."""
    return sum(lp.gather(2, tuples[..., h:h + 1].long())[..., 0] for h, lp in enumerate(levels))


def choice_gap(levels, tuples: torch.Tensor, valid: torch.Tensor, prefixes, k: int) -> torch.Tensor:
    """[B] how far a served beam set [B, k, L] falls short of what any sound
    constrained search keeps, by the reference's scores (nats, 0 if not):

    - level 0: every first id of the search's level-0 beams, so of every
      served beam, is among the k best valid first ids;
    - the last level: its beams are the k best valid children of the
      level L - 2 beams, among which are the served beams' parents, so no
      valid child of a served parent that is not served scores above the
      worst served beam.

    Both hold whatever the search kept at the levels between, so a near-tie
    that sends the two sides down different paths leaves them true."""
    B, _, L = tuples.shape
    K = levels[0].shape[-1]
    dev = tuples.device
    lp0 = levels[0][:, 0]  # the empty prefix: the same for every beam of a request
    first_ok = _member(prefixes[0], torch.arange(K, device=dev))
    kth = torch.sort(torch.where(first_ok, lp0, NEG), dim=1, descending=True).values[:, min(k, K) - 1]
    served0 = lp0.gather(1, tuples[:, :, 0].long())
    gap0 = torch.where(valid, kth[:, None] - served0, -float("inf")).amax(1)
    prefix = sum(lp.gather(2, tuples[..., h:h + 1].long())[..., 0] for h, lp in enumerate(levels[:-1]))
    score = prefix + levels[-1].gather(2, tuples[..., -1:].long())[..., 0]
    worst = torch.where(valid, score, float("inf")).amin(1)
    parent = torch.zeros((B, k), dtype=torch.int64, device=dev)
    for h in range(L - 1):
        parent = parent * K + tuples[..., h].long()
    child = parent[:, :, None] * K + torch.arange(K, device=dev)  # [B, k, K]
    served = parent * K + tuples[..., -1].long()
    taken = ((child[..., None] == served[:, None, None, :]) & valid[:, None, None, :]).any(-1)
    open_ = _member(prefixes[-1], child) & valid[:, :, None] & ~taken
    gap_last = torch.where(open_, prefix[:, :, None] + levels[-1] - worst[:, None, None], -float("inf")).amax((1, 2))
    return torch.maximum(gap0, gap_last).clamp(min=0.0)


def inverse_lookup(table: torch.Tensor, tuples: torch.Tensor, K: int) -> torch.Tensor:
    """[B, k] the earliest corpus item with each tuple, -1 where none has it."""
    L = tuples.shape[-1]
    corpus = torch.zeros(table.shape[0], dtype=torch.int64, device=table.device)
    want = torch.zeros(tuples.shape[:-1], dtype=torch.int64, device=table.device)
    for h in range(L):
        corpus = corpus * K + table[:, h].long()
        want = want * K + tuples[..., h].long()
    keys, order = torch.sort(corpus, stable=True)
    idx = torch.searchsorted(keys, want).clamp(max=keys.shape[0] - 1)
    return torch.where(keys[idx] == want, order[idx], -1)
