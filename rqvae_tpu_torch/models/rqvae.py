"""RQ-VAE (port of rqvae_tpu/models/rqvae.py).

MLP encoder -> L-level residual quantization -> MLP decoder: the semantic
ids (eval path), the training forward with its losses (`forward`, with the
STE, rotation-trick or Gumbel-softmax estimator), and the two functional
codebook initialisers of the trainer, `kmeans_init_codebooks` and
`restart_dead_codebook_entries`, which write the model's codebooks in place
where the reference returns new params. Gumbel noise comes from an explicit
`torch.Generator` or is passed in (`gumbel_noise`, one [B, K] tensor per
level), so a test can hand both packages the same noise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from rqvae_tpu_torch.models.mlp import MLP
from rqvae_tpu_torch.models.quantize import (
    QuantizeDistance,
    QuantizeForwardMode,
    codebook_distances,
    quantize_forward,
)
from rqvae_tpu_torch.ops.dedup import pack_sem_id_tuples
from rqvae_tpu_torch.ops.gumbel import gumbel_softmax_sample
from rqvae_tpu_torch.ops.kmeans import kmeans
from rqvae_tpu_torch.ops.losses import categorical_reconstruction_loss
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


class RqVaeComputedLosses(NamedTuple):
    loss: torch.Tensor  # scalar
    reconstruction_loss: torch.Tensor  # scalar (mean)
    rqvae_loss: torch.Tensor  # scalar (mean)
    embs_norm: torch.Tensor  # [B, L] per-level embedding norms
    p_unique_ids: torch.Tensor  # scalar: #distinct tuples / B
    sem_ids: torch.Tensor  # [B, L] int32 ids of the batch


def distinct_share(sem_ids: torch.Tensor, codebook_size: int) -> torch.Tensor:
    """The share of rows whose L-tuple is distinct: #distinct tuples / rows
    (float32 scalar), by sorted packed keys."""
    keys = torch.sort(pack_sem_id_tuples(sem_ids, codebook_size)).values
    n_distinct = 1 + torch.count_nonzero(keys[1:] != keys[:-1])
    return n_distinct.to(torch.float32) / keys.shape[0]


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

    def get_semantic_ids(
        self,
        x: torch.Tensor,
        gumbel_t: float = 0.001,
        *,
        training: bool = False,
        generator: Optional[torch.Generator] = None,
        gumbel_noise: Optional[Sequence[torch.Tensor]] = None,
    ) -> RqVaeOutput:
        """Encode and residually quantize. Eval mode (hard lookups) runs
        without autograd; training mode runs the configured estimator."""
        with torch.set_grad_enabled(training and torch.is_grad_enabled()):
            return self._quantize(x, gumbel_t, training, generator, gumbel_noise)

    def _quantize(self, x, gumbel_t, training, generator, gumbel_noise) -> RqVaeOutput:
        cfg = self.config
        res = self.encode(x)
        embs, residuals, sem_ids = [], [], []
        q_loss = torch.zeros(x.shape[0], dtype=res.dtype, device=res.device)
        for level in range(cfg.n_layers):
            residuals.append(res)
            out = quantize_forward(
                res,
                self.effective_codebook(level),
                mode=cfg.codebook_mode,
                distance=cfg.codebook_distance,
                commitment_weight=cfg.commitment_weight,
                training=training,
                temperature=gumbel_t,
                generator=generator,
                noise=None if gumbel_noise is None else gumbel_noise[level],
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

    def forward(
        self,
        x: torch.Tensor,
        gumbel_t: float,
        *,
        training: bool = False,
        generator: Optional[torch.Generator] = None,
        gumbel_noise: Optional[Sequence[torch.Tensor]] = None,
    ) -> RqVaeComputedLosses:
        """The training forward: quantize, decode the summed codewords, then
        loss = mean(reconstruction + quantize loss). With categorical
        features the dense slice of x_hat is L2-normalised; without, x_hat
        is left as it is (the reference's `[..., :-0]` slice is empty)."""
        cfg = self.config
        quantized = self._quantize(x, gumbel_t, training, generator, gumbel_noise)
        x_hat = self.decode(torch.sum(quantized.embeddings, dim=1))
        if cfg.n_cat_feats > 0:
            x_hat = torch.cat([l2norm(x_hat[..., : -cfg.n_cat_feats]), x_hat[..., -cfg.n_cat_feats:]], dim=-1)
        recon = categorical_reconstruction_loss(x_hat, x, cfg.n_cat_feats)
        return RqVaeComputedLosses(
            loss=torch.mean(recon + quantized.quantize_loss),
            reconstruction_loss=torch.mean(recon),
            rqvae_loss=torch.mean(quantized.quantize_loss),
            embs_norm=torch.linalg.vector_norm(quantized.embeddings, dim=-1),
            p_unique_ids=distinct_share(quantized.sem_ids.detach(), cfg.codebook_size),
            sem_ids=quantized.sem_ids.detach(),
        )


@torch.no_grad()
def restart_dead_codebook_entries(
    model: RqVae,
    x_sample: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    min_usage: int = 1,
    reseed_idx: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Re-seed, in place, the codebook entries that fewer than `min_usage`
    samples of `x_sample` use, each from the residual (the quantizer's
    input at its level) of sample reseed_idx[level, k]. The indices
    [L, K] are drawn from `generator` unless given. Returns the dead counts
    per level [L]."""
    cfg = model.config
    out = model.get_semantic_ids(x_sample)
    B = x_sample.shape[0]
    if reseed_idx is None:
        if generator is None:
            raise ValueError("restart_dead_codebook_entries needs a generator or the reseed indices")
        reseed_idx = torch.randint(0, B, (cfg.n_layers, cfg.codebook_size), generator=generator)
    reseed_idx = reseed_idx.to(x_sample.device).long()
    dead_counts = []
    for level in range(cfg.n_layers):
        usage = torch.bincount(out.sem_ids[:, level].long(), minlength=cfg.codebook_size)
        dead = usage < min_usage
        reseed = out.residuals[:, level][reseed_idx[level]]
        model.codebooks[level].copy_(torch.where(dead[:, None], reseed, model.codebooks[level]))
        dead_counts.append(torch.sum(dead))
    return torch.stack(dead_counts)


@torch.no_grad()
def kmeans_init_codebooks(
    model: RqVae,
    x_sample: torch.Tensor,
    generator: torch.Generator,
    max_iters: int = 100,
    gumbel_temperature: Optional[float] = None,
) -> None:
    """K-means warm start of every codebook level, in place. Level l is
    fitted to the residuals left by hard quantization of the levels before
    it (exact for STE and, to the normalisation epsilons, the rotation
    trick). With `gumbel_temperature` and a Gumbel-mode config, the next
    level sees x minus the Gumbel-softmax mixture of the centroids at that
    temperature instead, the regime of the reference's mid-forward init."""
    cfg = model.config
    res = model.encode(x_sample)
    for level in range(cfg.n_layers):
        out = kmeans(res, k=cfg.codebook_size, generator=generator, max_iters=max_iters)
        centroids = out.centroids
        model.codebooks[level].copy_(centroids)
        if gumbel_temperature is not None and cfg.codebook_mode == QuantizeForwardMode.GUMBEL_SOFTMAX:
            dist = codebook_distances(res, centroids, cfg.codebook_distance)
            emb = gumbel_softmax_sample(-dist, gumbel_temperature, generator=generator) @ centroids
        else:
            emb = centroids[out.assignment]
        res = res - emb
