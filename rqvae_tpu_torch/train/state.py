"""AdamW with the update of optax's `adamw` (port of rqvae_tpu/train/state.py).

    g      <- g * max_norm / max(||g||, max_norm)      (optional global-norm clip)
    mu     <- b1 mu + (1 - b1) g,   nu <- b2 nu + (1 - b2) g^2
    update <- (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps) + weight_decay * p
    p      <- p - lr(t - 1) * update

The decay is decoupled, scaled by the LR and applied to every parameter (optax's
`adamw` has no mask here); eps sits outside the square root; the LR of update i
(0-based) is `learning_rate(i)` when a schedule is given. Moments are float32.

`optax_state` / `load_optax_state` map the optimizer to and from the JAX
package's `opt_state` (`rqvae_tpu/train/state.py::adamw`, optax 0.2.6) as
flax writes it into a checkpoint: `{'0': ScaleByAdamState(count, mu, nu),
'1': {} (the weight decay's EmptyState), '2': {} or {'count'} (a constant LR
or a schedule's ScaleByScheduleState)}`, inside `{'0': {} (clip's
EmptyState), '1': ...}` when `max_grad_norm` is set. `mu` and `nu` mirror
the flax params tree `{'params': ...}`, mapped by parameter name with the
transposes of utils/convert.py, and each `count` is an int32 scalar: both
are `step_count`, so the LR position carries over exactly.

The update count lives on the device, as optax's count does, and the LR,
1 - b1^t and sqrt(1 - b2^t) are float32 device scalars computed from it
(`torch.optim.AdamW(capturable=True)` does the same): a step reads nothing
back, and a CUDA graph of it follows the count at every replay. Parameters,
moments and the count are updated in place, and `load_state_dict` writes in
place too, so a captured graph still holds them after a resume.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Mapping, Optional, Union

import numpy as np
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


def _moment_names(optimizer: AdamW, model: torch.nn.Module) -> List[str]:
    """The model's name of each of the optimizer's parameters, in its order."""
    names = {id(p): n for n, p in model.named_parameters()}
    missing = [i for i, p in enumerate(optimizer.params) if id(p) not in names]
    if missing:
        raise ValueError(f"optimizer parameters {missing} are not parameters of the model")
    return [names[id(p)] for p in optimizer.params]


def optax_state(optimizer: AdamW, model: torch.nn.Module) -> Dict:
    """The optimizer's state as the flax state dict of the JAX package's
    optax `opt_state` for the same settings (a constant LR or a schedule,
    clipping or none), numpy leaves: what `rqvae_tpu.utils.checkpoint.
    save_checkpoint` writes for that state and `load_checkpoint` restores
    into its template."""
    from rqvae_tpu_torch.utils.convert import jax_params_from_state_dict

    names = _moment_names(optimizer, model)
    count = np.asarray(optimizer.count, dtype=np.int32)
    adam = {"count": count}
    for key, moments in (("mu", optimizer.mu), ("nu", optimizer.nu)):
        adam[key] = jax_params_from_state_dict(model, dict(zip(names, moments)))
    inner = {"0": adam, "1": {}, "2": {"count": count.copy()} if callable(optimizer.learning_rate) else {}}
    return {"0": {}, "1": inner} if optimizer.max_grad_norm is not None else inner


def _expect(node, keys: set, where: str) -> None:
    if not isinstance(node, Mapping) or set(node) != keys:
        got = sorted(node) if isinstance(node, Mapping) else type(node).__name__
        raise ValueError(f"opt_state{where}: expected keys {sorted(keys)} for this optimizer's settings "
                         f"(schedule, max_grad_norm), got {got}")


def load_optax_state(optimizer: AdamW, model: torch.nn.Module, tree: Mapping) -> None:
    """Write a JAX `opt_state` (the tree `optax_state` describes, as a
    checkpoint holds it) into the optimizer in place. A tree that does not
    fit the optimizer's settings, or whose two counts differ, raises, as the
    JAX package's restore into its template would."""
    from rqvae_tpu_torch.utils.convert import grads_from_jax

    inner, where = tree, ""
    if optimizer.max_grad_norm is not None:
        _expect(tree, {"0", "1"}, "")
        _expect(tree["0"], set(), "['0']")
        inner, where = tree["1"], "['1']"
    _expect(inner, {"0", "1", "2"}, where)
    _expect(inner["1"], set(), f"{where}['1']")
    schedule = callable(optimizer.learning_rate)
    _expect(inner["2"], {"count"} if schedule else set(), f"{where}['2']")
    adam = inner["0"]
    _expect(adam, {"count", "mu", "nu"}, f"{where}['0']")
    counts = {int(np.asarray(adam["count"]))}
    if schedule:
        counts.add(int(np.asarray(inner["2"]["count"])))
    if len(counts) != 1:
        raise ValueError(f"opt_state: the Adam count and the schedule's count differ: {sorted(counts)}")
    names = _moment_names(optimizer, model)
    moments = {}
    for key in ("mu", "nu"):
        by_name = grads_from_jax(adam[key])
        if set(by_name) != set(names):
            raise ValueError(f"opt_state {key}: parameters {sorted(set(by_name) ^ set(names))} do not match")
        moments[key] = [by_name[n] for n in names]
    optimizer.load_state_dict({"count": counts.pop(), **moments})
