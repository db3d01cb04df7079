"""Gumbel sampling, Gumbel-softmax and sampling without replacement (port of
rqvae_tpu/ops/gumbel.py).

The reference draws from an explicit JAX key; here the draws come from an
explicit `torch.Generator` (a CPU generator: the noise is drawn on the host
and copied to the logits' device, so one generator gives the same noise on
every device). A caller that already holds the noise passes it in instead.
"""

from __future__ import annotations

from typing import Optional

import torch


def gumbel_from_uniform(u: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """Gumbel(0, 1) noise from uniforms on [0, 1): -log(-log(u + eps) + eps),
    on u's device."""
    return -torch.log(-torch.log(u + eps) + eps)


def sample_gumbel(shape, generator: Optional[torch.Generator] = None, device=None,
                  dtype: torch.dtype = torch.float32, eps: float = 1e-20) -> torch.Tensor:
    """Gumbel(0, 1) noise: -log(-log(U + eps) + eps), U ~ Uniform[0, 1) drawn
    on the host and copied to `device` first."""
    return gumbel_from_uniform(torch.rand(shape, generator=generator, dtype=dtype).to(device), eps)


def gumbel_softmax_sample(logits: torch.Tensor, temperature: float, generator: Optional[torch.Generator] = None,
                          noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A soft sample from the Gumbel-softmax distribution over the last axis,
    softmax((logits + g) / t), with g drawn from `generator` or given as `noise`."""
    if noise is None:
        if generator is None:
            raise ValueError("gumbel_softmax_sample needs a generator or the noise")
        noise = sample_gumbel(logits.shape, generator, logits.device, logits.dtype)
    return torch.softmax((logits + noise.to(logits.device, logits.dtype)) / temperature, dim=-1)


def sample_without_replacement(logp: torch.Tensor, n: int, generator: Optional[torch.Generator] = None,
                               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """n distinct indices drawn from softmax(logp) over the last axis, without
    replacement (the Gumbel top-k trick): the indices of the n largest
    logp + g, g Gumbel(0, 1) noise from `generator` or given as `noise`,
    ordered by draw, ties to the lower index as jax.lax.top_k breaks them.
    Returns int32 [..., n]."""
    if noise is None:
        if generator is None:
            raise ValueError("sample_without_replacement needs a generator or the noise")
        noise = sample_gumbel(logp.shape, generator, logp.device, logp.dtype)
    perturbed = logp + noise.to(logp.device, logp.dtype)
    idx = torch.sort(perturbed, dim=-1, descending=True, stable=True).indices[..., :n]
    return idx.to(torch.int32)
