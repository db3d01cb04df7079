"""AdamW with the update of optax's `adamw` (port of rqvae_tpu/train/state.py).

    g      <- g * max_norm / max(||g||, max_norm)      (optional global-norm clip)
    mu     <- b1 mu + (1 - b1) g,   nu <- b2 nu + (1 - b2) g^2
    update <- (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps) + weight_decay * p
    p      <- p - lr(t - 1) * update

The decay is decoupled, scaled by the LR and applied to every parameter (optax's
`adamw` has no mask here); eps sits outside the square root; the LR of update i
(0-based) is `learning_rate(i)` when a schedule is given. Moments are float32.
The update count and the LR live on the host, so a step waits for nothing on
the device; the clip factor stays a device scalar. Parameters are updated in
place.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, List, Optional, Union

import torch


class AdamW:
    def __init__(self, params: Iterable[torch.nn.Parameter], learning_rate: Union[float, Callable[[int], float]],
                 weight_decay: float = 0.01, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 max_grad_norm: Optional[float] = None):
        self.params: List[torch.nn.Parameter] = list(params)
        self.learning_rate = learning_rate
        self.weight_decay, self.b1, self.b2, self.eps = weight_decay, b1, b2, eps
        self.max_grad_norm = max_grad_norm
        self.count = 0  # updates taken
        self.mu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]

    def lr(self, count: Optional[int] = None) -> float:
        """The LR of update `count` (0-based; the next one by default)."""
        count = self.count if count is None else count
        return float(self.learning_rate(count)) if callable(self.learning_rate) else float(self.learning_rate)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        """One update from the parameters' `.grad` (a missing grad counts as zeros)."""
        grads = [p.grad.float() if p.grad is not None else torch.zeros_like(p, dtype=torch.float32)
                 for p in self.params]
        if self.max_grad_norm is not None:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            factor = self.max_grad_norm / torch.clamp(norm, min=self.max_grad_norm)
            torch._foreach_mul_(grads, factor)
        lr = self.lr()
        self.count += 1
        t, b1, b2 = self.count, self.b1, self.b2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - b2)
        denom = torch._foreach_sqrt(self.nu)
        torch._foreach_div_(denom, math.sqrt(1.0 - b2 ** t))
        torch._foreach_add_(denom, self.eps)
        torch._foreach_mul_(self.params, 1.0 - lr * self.weight_decay)
        torch._foreach_addcdiv_(self.params, self.mu, denom, value=-lr / (1.0 - b1 ** t))

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": [m.clone() for m in self.mu], "nu": [n.clone() for n in self.nu]}

    def load_state_dict(self, state: dict) -> None:
        if len(state["mu"]) != len(self.params):
            raise ValueError(f"optimizer state holds {len(state['mu'])} moments for {len(self.params)} parameters")
        self.count = int(state["count"])
        for dst, src in zip(self.mu + self.nu, list(state["mu"]) + list(state["nu"])):
            dst.copy_(src)


def adamw(params, learning_rate, weight_decay: float = 0.01, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, max_grad_norm: Optional[float] = None) -> AdamW:
    """AdamW over `params` with optional global-norm clipping; `learning_rate`
    is a float or a function of the update count (ops/schedules.py)."""
    return AdamW(params, learning_rate, weight_decay, b1, b2, eps, max_grad_norm)
