"""Train and eval steps of the RQ-VAE stage (port of rqvae_tpu/train/rqvae_steps.py).

A train step is forward -> backward over A micro-batches -> AdamW: each
micro-batch's loss is divided by A, so the gradients that add up in `.grad`
are their mean, as the reference's `lax.scan` accumulation gives. The steps
are plain functions closing over the model and the optimizer, which they
update in place; they return metrics as device tensors and never read one
back, so the caller decides when to wait for the device.

- make_rqvae_train_step:        step(x [A, B, D], generator, gumbel_t)
- make_rqvae_index_train_step:  step(features [N, D], idx [A, B], generator, gumbel_t)
  (the batch is gathered on the device: per-step host work is the indices)
- make_rqvae_eval_step:         eval_step(x [B, D], gumbel_t)

Gumbel noise, the step's only randomness, comes from the CPU generator the
caller passes. The reference's multi-step `lax.scan` has no counterpart: a
Python loop over the step is the same program here.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from rqvae_tpu_torch.models.rqvae import RqVae
from rqvae_tpu_torch.train.state import AdamW


def make_rqvae_train_step(model: RqVae, optimizer: AdamW):
    """step(x [A, B, D], generator, gumbel_t) -> metrics: one update from A
    micro-batches (total_loss, reconstruction_loss, rqvae_loss,
    p_unique_ids, gumbel_t, emb_norms [L]; means over the micro-batches)."""

    def step(x: torch.Tensor, generator: Optional[torch.Generator] = None, gumbel_t: float = 0.2):
        model.train()
        optimizer.zero_grad()
        n_micro = x.shape[0]
        total: Dict[str, torch.Tensor] = {}
        for a in range(n_micro):
            out = model(x[a], gumbel_t, training=True, generator=generator)
            (out.loss / n_micro).backward()
            metrics = {
                "total_loss": out.loss.detach(), "reconstruction_loss": out.reconstruction_loss.detach(),
                "rqvae_loss": out.rqvae_loss.detach(), "p_unique_ids": out.p_unique_ids,
                "emb_norms": torch.mean(out.embs_norm.detach(), dim=0),
            }
            for k, v in metrics.items():
                total[k] = v / n_micro if k not in total else total[k] + v / n_micro
        optimizer.step()
        total["gumbel_t"] = torch.tensor(float(gumbel_t))
        return total

    return step


def make_rqvae_index_train_step(model: RqVae, optimizer: AdamW):
    """step(features [N, D], idx [A, B], generator, gumbel_t) -> metrics: the
    train step on features[idx], gathered on the features' device."""
    core = make_rqvae_train_step(model, optimizer)

    def step(features: torch.Tensor, idx: torch.Tensor, generator: Optional[torch.Generator] = None,
             gumbel_t: float = 0.2):
        return core(features[idx.long()], generator, gumbel_t)

    return step


def make_rqvae_eval_step(model: RqVae):
    """eval_step(x [B, D], gumbel_t) -> {eval_total_loss,
    eval_reconstruction_loss, eval_rqvae_loss}: the eval-mode forward."""

    @torch.no_grad()
    def eval_step(x: torch.Tensor, gumbel_t: float = 0.2) -> Dict[str, torch.Tensor]:
        model.eval()
        out = model(x, gumbel_t, training=False)
        return {
            "eval_total_loss": out.loss,
            "eval_reconstruction_loss": out.reconstruction_loss,
            "eval_rqvae_loss": out.rqvae_loss,
        }

    return eval_step
