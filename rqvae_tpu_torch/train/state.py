"""AdamW with the update of optax's `adamw` (port of rqvae_tpu/train/state.py).

    g      <- g * max_norm / max(||g||, max_norm)      (optional global-norm clip)
    mu     <- b1 mu + (1 - b1) g,   nu <- b2 nu + (1 - b2) g^2
    update <- (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps) + weight_decay * p
    p      <- p - lr(t - 1) * update

The decay is decoupled, scaled by the LR and applied to every parameter (optax's
`adamw` has no mask here); eps sits outside the square root; the LR of update i
(0-based) is `learning_rate(i)` when a schedule is given. Moments are float32.

The update count lives on the device, as optax's count does, and the LR,
1 - b1^t and sqrt(1 - b2^t) are float32 device scalars computed from it
(`torch.optim.AdamW(capturable=True)` does the same): a step reads nothing
back, and a CUDA graph of it follows the count at every replay. Parameters,
moments and the count are updated in place, and `load_state_dict` writes in
place too, so a captured graph still holds them after a resume.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Union

import torch


class AdamW:
    def __init__(self, params: Iterable[torch.nn.Parameter], learning_rate: Union[float, Callable],
                 weight_decay: float = 0.01, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 max_grad_norm: Optional[float] = None):
        self.params: List[torch.nn.Parameter] = list(params)
        self.learning_rate = learning_rate
        self.weight_decay, self.b1, self.b2, self.eps = weight_decay, b1, b2, eps
        self.max_grad_norm = max_grad_norm
        device = self.params[0].device if self.params else None
        self.step_count = torch.zeros((), dtype=torch.int32, device=device)  # updates taken
        self.mu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]

    @property
    def count(self) -> int:
        """Updates taken (a host read of the device count)."""
        return int(self.step_count)

    def lr(self, count: Optional[int] = None) -> float:
        """The LR of update `count` (0-based; the next one by default), on the host."""
        count = self.count if count is None else count
        return float(self.learning_rate(count)) if callable(self.learning_rate) else float(self.learning_rate)

    def _lr_on_device(self) -> torch.Tensor:
        """The LR of the next update as a float32 device scalar."""
        if callable(self.learning_rate):
            return self.learning_rate(self.step_count).to(torch.float32)
        return torch.full((), float(self.learning_rate), dtype=torch.float32, device=self.step_count.device)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def state_tensors(self) -> List[torch.Tensor]:
        """Every tensor a step updates in place: parameters, moments, count."""
        return [*self.params, *self.mu, *self.nu, self.step_count]

    @torch.no_grad()
    def step(self) -> None:
        """One update from the parameters' `.grad` (a missing grad counts as zeros)."""
        grads = [p.grad.float() if p.grad is not None else torch.zeros_like(p, dtype=torch.float32)
                 for p in self.params]
        if self.max_grad_norm is not None:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            factor = self.max_grad_norm / torch.clamp(norm, min=self.max_grad_norm)
            torch._foreach_mul_(grads, factor)
        lr = self._lr_on_device()
        self.step_count.add_(1)
        t = self.step_count.to(torch.float32)
        b1, b2 = self.b1, self.b2
        bias1 = 1.0 - torch.pow(b1, t)
        bias2_sqrt = torch.sqrt(1.0 - torch.pow(b2, t))
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - b2)
        denom = torch._foreach_sqrt(self.nu)
        torch._foreach_div_(denom, bias2_sqrt)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_mul_(self.params, 1.0 - lr * self.weight_decay)
        update = torch._foreach_div(self.mu, denom)
        torch._foreach_mul_(update, -lr / bias1)
        torch._foreach_add_(self.params, update)

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": [m.clone() for m in self.mu], "nu": [n.clone() for n in self.nu]}

    def load_state_dict(self, state: dict) -> None:
        if len(state["mu"]) != len(self.params):
            raise ValueError(f"optimizer state holds {len(state['mu'])} moments for {len(self.params)} parameters")
        self.step_count.fill_(int(state["count"]))
        for dst, src in zip(self.mu + self.nu, list(state["mu"]) + list(state["nu"])):
            dst.copy_(src)


def adamw(params, learning_rate, weight_decay: float = 0.01, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, max_grad_norm: Optional[float] = None) -> AdamW:
    """AdamW over `params` with optional global-norm clipping; `learning_rate`
    is a float or a schedule of ops/schedules.py (a function of the update
    count that also takes the count as a device tensor)."""
    return AdamW(params, learning_rate, weight_decay, b1, b2, eps, max_grad_norm)
