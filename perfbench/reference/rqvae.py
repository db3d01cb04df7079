"""RQ-VAE encode with residual quantization, and the dedup column.

The encoder is a bias-free MLP with ReLU between layers; level l takes the
codeword nearest (squared L2; ties to the lower index) to the residual that
the earlier levels left. The dedup column of item i counts the earlier items
whose whole tuple equals its own.
"""

from __future__ import annotations

import torch

from perfbench.reference.precision import Precision


def encode(weights: dict, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    """[N, input_dim] -> [N, embed_dim]: encoder.layers.{i}.weight are [out, in]."""
    n_layers = len([k for k in weights if k.startswith("encoder.layers.")])
    h = x.float()
    for i in range(n_layers):
        h = prec.linear(h, weights[f"encoder.layers.{i}.weight"])
        if i != n_layers - 1:
            h = torch.relu(h)
    return h


def quantize(z: torch.Tensor, codebooks: torch.Tensor, prec: Precision) -> torch.Tensor:
    """[N, D] embeddings, [L, K, D] codebooks -> [N, L] int64 ids."""
    res = z.float()
    ids = []
    for level in range(codebooks.shape[0]):
        cb = codebooks[level].float()
        dist = (res * res).sum(-1, keepdim=True) + (cb * cb).sum(-1)[None] - 2.0 * prec.matmul(res, cb.t())
        idx = torch.argmin(dist, dim=-1)  # the first minimum: ties to the lower index
        ids.append(idx)
        res = res - cb[idx]
    return torch.stack(ids, dim=1)


def dedup_column(ids: torch.Tensor, codebook_size: int) -> torch.Tensor:
    """[N, L] -> [N]: the number of earlier rows with the same tuple."""
    key = torch.zeros(ids.shape[0], dtype=torch.int64, device=ids.device)
    for level in range(ids.shape[1]):
        key = key * codebook_size + ids[:, level].long()
    order = torch.sort(key, stable=True).indices
    sorted_key = key[order]
    pos = torch.arange(key.shape[0], device=ids.device)
    first = torch.ones_like(sorted_key, dtype=torch.bool)
    first[1:] = sorted_key[1:] != sorted_key[:-1]
    run_start = torch.cummax(torch.where(first, pos, torch.zeros_like(pos)), dim=0).values
    out = torch.empty_like(pos)
    out[order] = pos - run_start
    return out


def corpus_ids(weights: dict, features: torch.Tensor, prec: Precision, chunk: int = 16384) -> torch.Tensor:
    """[N, L + 1] int64: each item's tuple and its dedup column."""
    cb = weights["codebooks"]
    ids = torch.cat([quantize(encode(weights, features[i:i + chunk], prec), cb, prec)
                     for i in range(0, features.shape[0], chunk)])
    return torch.cat([ids, dedup_column(ids, cb.shape[1])[:, None]], dim=1)
