"""Learning-rate and temperature schedules (port of rqvae_tpu/ops/schedules.py).

- inverse_sqrt_schedule: the base LR through `warmup_steps`, then
  base * sqrt(warmup / step).
- TemperatureScheduler / gumbel_temperature_at: the exponential Gumbel
  temperature anneal of the stage-1 trainer, stateful and in closed form.

Each schedule has two forms. On a host number it returns a Python float (for
logging). On a device step count (an integer tensor) it returns a float32
tensor on that device, computed there as optax and the JAX package compute
it inside the program (rqvae_tpu/ops/schedules.py): a training step that
reads its LR or temperature this way waits for nothing on the host, and a
CUDA graph of it follows the count at every replay.
"""

from __future__ import annotations

import math

import torch


def inverse_sqrt_schedule(base_lr: float, warmup_steps: int):
    """A function of the update count (0-based). Update i uses the LR of
    step = i + 1: base for step <= warmup, else base * sqrt(warmup / step).
    A tensor count gives the float32 value on its device."""

    def schedule(count):
        if isinstance(count, torch.Tensor):
            step = count + 1
            stepf = torch.clamp(step, min=1).to(torch.float32)
            scale = torch.sqrt(torch.full_like(stepf, float(warmup_steps)) / stepf)  # a true division, as XLA's
            return float(base_lr) * torch.where(step <= warmup_steps, torch.ones_like(scale), scale)
        step = int(count) + 1
        if step <= warmup_steps:
            return base_lr
        return base_lr * math.sqrt(warmup_steps / max(step, 1))

    return schedule


class TemperatureScheduler:
    """Exponential-anneal Gumbel temperature (host-side, stateful): every
    `step_size` steps, t <- max(t * exp(-anneal_rate * iter), min_t)."""

    def __init__(self, t0: float, min_t: float, anneal_rate: float, step_size: int):
        self.t0 = t0
        self.min_t = min_t
        self.anneal_rate = anneal_rate
        self.step_size = step_size
        self.t = t0

    def update_t(self, iteration: int) -> None:
        if iteration % self.step_size == self.step_size - 1:
            self.t = max(self.t * math.exp(-self.anneal_rate * iteration), self.min_t)

    def get_t(self, iteration: int) -> float:
        self.update_t(iteration)
        return self.t


def gumbel_temperature_at(step, t0: float, min_t: float, anneal_rate: float, step_size: int):
    """Closed form of TemperatureScheduler.get_t called for every iteration up
    to `step`: by then n = (step + 1) // step_size updates have fired, at
    iterations j * step_size - 1 (j = 1..n), whose exponents sum to
    step_size * n (n + 1) / 2 - n; the clamp commutes with the monotone
    product. A tensor step gives the float32 value on its device, the
    exponent sum taken in float32 as the JAX package takes it (an int32 sum
    overflows within shipped budgets)."""
    if isinstance(step, torch.Tensor):
        nf = torch.div(step + 1, step_size, rounding_mode="floor").to(torch.float32)
        s = step_size * nf * (nf + 1.0) / 2.0 - nf
        return torch.clamp(t0 * torch.exp(-anneal_rate * s), min=min_t)
    n = float((int(step) + 1) // step_size)
    s = step_size * n * (n + 1.0) / 2.0 - n
    return max(t0 * math.exp(-anneal_rate * s), min_t)
