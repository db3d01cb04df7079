"""Loss functions of the RQ-VAE stage (port of rqvae_tpu/ops/losses.py).

All return per-example vectors [B] (summed over the feature axis); the
model takes means. `.detach()` stands where the reference stops gradients.
"""

from __future__ import annotations

import torch


def reconstruction_loss(x_hat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Sum-of-squares reconstruction error over the last axis -> [B]."""
    return torch.sum((x_hat - x) ** 2, dim=-1)


def _bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross entropy with logits:
    max(z, 0) - z y + log(1 + exp(-|z|))."""
    return torch.clamp(logits, min=0.0) - logits * targets + torch.log1p(torch.exp(-torch.abs(logits)))


def categorical_reconstruction_loss(x_hat: torch.Tensor, x: torch.Tensor, n_cat_feats: int) -> torch.Tensor:
    """MSE over the dense slice + BCE-with-logits summed over the trailing
    `n_cat_feats` binary features. With n_cat_feats == 0 this is plain MSE."""
    if n_cat_feats <= 0:
        return reconstruction_loss(x_hat, x)
    dense = reconstruction_loss(x_hat[..., :-n_cat_feats], x[..., :-n_cat_feats])
    cat = torch.sum(_bce_with_logits(x_hat[..., -n_cat_feats:], x[..., -n_cat_feats:]), dim=-1)
    return dense + cat


def quantize_loss(query: torch.Tensor, value: torch.Tensor, commitment_weight: float = 1.0) -> torch.Tensor:
    """VQ loss: ||sg(q) - v||^2 + beta ||q - sg(v)||^2, summed over the last axis."""
    emb_loss = torch.sum((query.detach() - value) ** 2, dim=-1)
    query_loss = torch.sum((query - value.detach()) ** 2, dim=-1)
    return emb_loss + commitment_weight * query_loss
