"""RQ-VAE, inference (port of rqvae_tpu/models/rqvae.py).

MLP encoder -> L-level residual quantization -> MLP decoder. The training
forward (losses, codebook restarts, k-means init) belongs to the training
path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Tuple

import torch
from torch import nn

from rqvae_tpu_torch.models.mlp import MLP
from rqvae_tpu_torch.models.quantize import (
    QuantizeDistance,
    QuantizeForwardMode,
    quantize_eval,
)
from rqvae_tpu_torch.ops.normalize import l2norm
from rqvae_tpu_torch.utils.device import DeviceLike, resolve_device


@dataclass(frozen=True)
class RqVaeConfig:
    """Same fields and defaults as rqvae_tpu.models.rqvae.RqVaeConfig."""

    input_dim: int = 768
    embed_dim: int = 32
    hidden_dims: Tuple[int, ...] = (512, 256, 128)
    codebook_size: int = 256
    n_layers: int = 3
    commitment_weight: float = 0.25
    n_cat_feats: int = 0
    codebook_normalize: bool = False
    sim_vq: bool = False
    codebook_mode: QuantizeForwardMode = QuantizeForwardMode.GUMBEL_SOFTMAX
    codebook_distance: QuantizeDistance = QuantizeDistance.L2


class RqVaeOutput(NamedTuple):
    embeddings: torch.Tensor  # [B, L, D]
    residuals: torch.Tensor  # [B, L, D]
    sem_ids: torch.Tensor  # [B, L] int32
    quantize_loss: torch.Tensor  # [B]


class RqVae(nn.Module):
    """Parameters: `encoder`/`decoder` MLPs, `codebooks` [L, K, D] and, with
    SimVQ, `out_proj` [L, D, D]. Initialised from `seed` at the JAX
    package's scales (utils/convert.py::init_rqvae_)."""

    def __init__(self, config: RqVaeConfig, device: DeviceLike = None, seed: int = 0):
        super().__init__()
        from rqvae_tpu_torch.utils.convert import init_rqvae_

        dev = resolve_device(device)
        cfg = config
        self.config = cfg
        self.encoder = MLP(
            cfg.input_dim, cfg.hidden_dims, cfg.embed_dim,
            normalize=cfg.codebook_normalize, device=dev,
        )
        self.decoder = MLP(
            cfg.embed_dim, tuple(reversed(cfg.hidden_dims)), cfg.input_dim, device=dev
        )
        self.codebooks = nn.Parameter(
            torch.empty(cfg.n_layers, cfg.codebook_size, cfg.embed_dim, device=dev)
        )
        if cfg.sim_vq:
            self.out_proj = nn.Parameter(
                torch.empty(cfg.n_layers, cfg.embed_dim, cfg.embed_dim, device=dev)
            )
        init_rqvae_(self, seed)

    def effective_codebook(self, level: int) -> torch.Tensor:
        """SimVQ out-projection of the level's codebook; L2 codebook
        normalization applies at level 0 only."""
        cb = self.codebooks[level]
        if self.config.sim_vq:
            cb = cb @ self.out_proj[level]
        if self.config.codebook_normalize and level == 0:
            cb = l2norm(cb)
        return cb

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return self.encoder(x)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(z)

    @torch.no_grad()
    def get_semantic_ids(self, x: torch.Tensor) -> RqVaeOutput:
        """Encode and residually quantize (eval mode: hard lookups)."""
        cfg = self.config
        res = self.encode(x)
        embs, residuals, sem_ids = [], [], []
        q_loss = torch.zeros(x.shape[0], dtype=res.dtype, device=res.device)
        for level in range(cfg.n_layers):
            residuals.append(res)
            out = quantize_eval(
                res,
                self.effective_codebook(level),
                distance=cfg.codebook_distance,
                commitment_weight=cfg.commitment_weight,
            )
            q_loss = q_loss + out.loss
            res = res - out.embeddings
            embs.append(out.embeddings)
            sem_ids.append(out.ids)
        return RqVaeOutput(
            embeddings=torch.stack(embs, dim=1),
            residuals=torch.stack(residuals, dim=1),
            sem_ids=torch.stack(sem_ids, dim=1),
            quantize_loss=q_loss,
        )
