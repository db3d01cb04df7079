"""Bias-free MLP encoder/decoder (port of rqvae_tpu/models/mlp.py).

Linear(bias=False) + ReLU stack with an optional final L2 normalization.
Inference only: the JAX module's dropout is a training feature. Inside an amp
step on the card the Linear products take bf16 operands with f32 sums
(ops/amp.py).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from rqvae_tpu_torch.ops import amp
from rqvae_tpu_torch.ops.normalize import l2norm


class MLP(nn.Module):
    def __init__(
        self,
        in_dim: int,
        hidden_dims: Sequence[int],
        out_dim: int,
        normalize: bool = False,
        device=None,
    ):
        super().__init__()
        dims = [in_dim] + list(hidden_dims) + [out_dim]
        self.layers = nn.ModuleList(
            nn.Linear(a, b, bias=False, device=device) for a, b in zip(dims[:-1], dims[1:])
        )
        self.normalize = normalize

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = amp.linear(x, layer.weight)
            if i != len(self.layers) - 1:
                x = torch.relu(x)
        if self.normalize:
            x = l2norm(x)
        return x

    def kernels(self) -> tuple:
        """The weights in the JAX layout [in, out], in forward order."""
        return tuple(layer.weight.t().contiguous() for layer in self.layers)
