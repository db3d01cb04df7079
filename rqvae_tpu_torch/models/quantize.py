"""One residual-quantization level (port of rqvae_tpu/models/quantize.py).

Distances, the argmin, and the three training estimators: Gumbel-softmax,
straight-through (STE) and the rotation trick. Each `sg` of the reference is
a `.detach()` at the same place. The hard codebook lookup is a one-hot
matmul, exact in value (one term of 1 x the codeword) and, in the backward,
a fixed-order sum over the batch, so a training step repeats bit for bit on
the card (the gather's scatter-add backward would not).
"""

from __future__ import annotations

import enum
from typing import NamedTuple, Optional

import torch

from rqvae_tpu_torch.ops.embedding import one_hot
from rqvae_tpu_torch.ops.gumbel import gumbel_softmax_sample
from rqvae_tpu_torch.ops.losses import quantize_loss
from rqvae_tpu_torch.ops.normalize import l2norm


class QuantizeForwardMode(enum.Enum):
    GUMBEL_SOFTMAX = 1
    STE = 2
    ROTATION_TRICK = 3


class QuantizeDistance(enum.Enum):
    L2 = 1
    COSINE = 2


class QuantizeOutput(NamedTuple):
    embeddings: torch.Tensor  # [B, D] estimator output (feeds the decoder / next residual)
    ids: torch.Tensor  # [B] int32 codeword indices
    loss: torch.Tensor  # [B] VQ loss


def codebook_distances(
    x: torch.Tensor, codebook: torch.Tensor, distance: QuantizeDistance
) -> torch.Tensor:
    """[B, K] distance matrix between queries [B, D] and codewords [K, D]."""
    if distance == QuantizeDistance.L2:
        x2 = torch.sum(x * x, dim=-1, keepdim=True)
        c2 = torch.sum(codebook * codebook, dim=-1)
        return x2 + c2[None, :] - 2.0 * (x @ codebook.T)
    if distance == QuantizeDistance.COSINE:
        xn = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        cn = codebook.T / torch.linalg.vector_norm(codebook.T, dim=0, keepdim=True)
        return -(xn @ cn)
    raise ValueError(f"Unsupported distance: {distance}")


def lookup(codebook: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """codebook[ids] as a one-hot matmul: [B, D]."""
    return one_hot(ids, codebook.shape[0], codebook.dtype) @ codebook


def efficient_rotation_trick_transform(u: torch.Tensor, q: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """Section 4.2 of arXiv:2410.06424: e rotated by the reflection pair of
    unit-ish u and q, which is held constant, so gradients reach `e` as
    through a fixed rotation."""
    w = l2norm(u + q, eps=1e-6).detach()
    e_dot_w = torch.sum(e * w, dim=-1, keepdim=True)
    e_dot_u = torch.sum(e * u.detach(), dim=-1, keepdim=True)
    return e - 2.0 * e_dot_w * w + 2.0 * e_dot_u * q.detach()


def quantize_forward(
    x: torch.Tensor,
    codebook: torch.Tensor,
    *,
    mode: QuantizeForwardMode,
    distance: QuantizeDistance = QuantizeDistance.L2,
    commitment_weight: float = 0.25,
    training: bool = False,
    temperature: float = 0.001,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
) -> QuantizeOutput:
    """Quantize `x` [B, D] against the effective `codebook` [K, D]. Argmin
    keeps the first index on exact ties, as jnp.argmin does. Training in
    Gumbel mode draws its noise [B, K] from `generator`, or takes `noise`."""
    dist = codebook_distances(x, codebook, distance)
    ids = torch.argmin(dist.detach(), dim=-1).to(torch.int32)

    if training:
        if mode == QuantizeForwardMode.GUMBEL_SOFTMAX:
            if generator is None and noise is None:
                raise ValueError("GUMBEL_SOFTMAX mode needs a generator or the noise when training")
            emb = gumbel_softmax_sample(-dist, temperature, generator=generator, noise=noise) @ codebook
            emb_out = emb
        elif mode == QuantizeForwardMode.STE:
            emb = lookup(codebook, ids)
            emb_out = x + (emb - x).detach()
        elif mode == QuantizeForwardMode.ROTATION_TRICK:
            emb = lookup(codebook, ids)
            x_norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
            emb_norm = torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
            emb_out = efficient_rotation_trick_transform(x / (x_norm + 1e-8), emb / (emb_norm + 1e-8), x)
            emb_out = emb_out * (emb_norm / (x_norm + 1e-6)).detach()
        else:
            raise ValueError(f"Unsupported forward mode: {mode}")
        loss = quantize_loss(query=x, value=emb, commitment_weight=commitment_weight)
    else:
        emb_out = lookup(codebook, ids)
        loss = quantize_loss(query=x, value=emb_out, commitment_weight=commitment_weight)

    return QuantizeOutput(embeddings=emb_out, ids=ids, loss=loss)
