"""L2 normalization (port of rqvae_tpu/ops/normalize.py)."""

from __future__ import annotations

import torch


def l2norm(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||_2, eps) along `dim`."""
    n = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / torch.clamp(n, min=eps)
