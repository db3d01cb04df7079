"""Train and eval steps of the RQ-VAE stage (port of rqvae_tpu/train/rqvae_steps.py).

A train step is forward -> backward over A micro-batches -> AdamW: each
micro-batch's loss is divided by A, so the gradients that add up in `.grad`
are their mean, as the reference's `lax.scan` accumulation gives. The steps
update the model and the optimizer in place and return metrics as device
tensors, never reading one back, so the caller decides when to wait for the
device.

- make_rqvae_train_step:        step(x [A, B, D], generator, gumbel_t)
- make_rqvae_index_train_step:  step(features [N, D], idx [A, B], generator, gumbel_t)
  (the batch is gathered on the device: per-step host work is the indices)
- make_rqvae_graph_train_step:  chunks of steps from features, the counterpart
  of make_rqvae_scan_train_step: each step one replay of a CUDA graph of the
  step's body on the card (train/step_graph.py), the temperature computed on
  the device from the step number (`t_fn`), the chunk's metrics their means
- make_rqvae_eval_step:         eval_step(x [B, D], gumbel_t)

Gumbel noise, the step's only randomness besides its rows, is drawn on the
host from the CPU generator of the step, as uniforms in the order the eager
forward used to draw them (micro-batch, then level), and turned into noise
on the device inside the step (ops/gumbel.py::gumbel_from_uniform). The
temperature is a float32 device scalar.

Data parallelism (`replicas`, parallel/dist.py::Replicas), batch axis 1 of
[A, B, D]: every rank draws the step's global rows and Gumbel uniforms from
(seed, step) and keeps its contiguous slice of the B rows, as the JAX
package's GSPMD step shards its globally drawn batch. One all-reduce then
averages the gradients and metrics before AdamW; `p_unique_ids`, a share of
distinct tuples over the whole batch, is taken once over the gathered ids.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from rqvae_tpu_torch.models.quantize import QuantizeForwardMode
from rqvae_tpu_torch.models.rqvae import RqVae, distinct_share
from rqvae_tpu_torch.ops import amp as amp_lib
from rqvae_tpu_torch.ops.gumbel import gumbel_from_uniform
from rqvae_tpu_torch.parallel.dist import Replicas
from rqvae_tpu_torch.parallel.mesh import local_rows, rank_slice
from rqvae_tpu_torch.train.state import AdamW
from rqvae_tpu_torch.train.step_graph import Draws, StepChunks, step_generator, step_rows


def _uses_noise(model: RqVae) -> bool:
    return model.config.codebook_mode == QuantizeForwardMode.GUMBEL_SOFTMAX


def _make_body(model: RqVae, optimizer: AdamW, amp: bool = False, replicas: Optional[Replicas] = None):
    """body(x [A, B, D], uniforms [A, L, B, K] or None, t (float32 device
    scalar)) -> metrics: one update, reading nothing back (the body a step
    graph captures). With `amp`, the MLP products take bf16 operands with
    f32 sums on the card (ops/amp.py). With `replicas`, the B rows are this
    rank's slice and the update is the data-parallel one."""

    @amp_lib.bf16_products(amp)
    def body(x: torch.Tensor, uniforms: Optional[torch.Tensor], t: torch.Tensor):
        model.train()
        optimizer.zero_grad()
        n_micro = x.shape[0]
        total: Dict[str, torch.Tensor] = {}
        for a in range(n_micro):
            noise = None if uniforms is None else [gumbel_from_uniform(u) for u in uniforms[a]]
            out = model(x[a], t, training=True, gumbel_noise=noise)
            (out.loss / n_micro).backward()
            p_unique = out.p_unique_ids
            if replicas is not None:  # a share over the global batch: from every rank's ids
                p_unique = distinct_share(replicas.all_gather(out.sem_ids), model.config.codebook_size)
            metrics = {
                "total_loss": out.loss.detach(), "reconstruction_loss": out.reconstruction_loss.detach(),
                "rqvae_loss": out.rqvae_loss.detach(), "p_unique_ids": p_unique,
                "emb_norms": torch.mean(out.embs_norm.detach(), dim=0),
            }
            for k, v in metrics.items():
                total[k] = v / n_micro if k not in total else total[k] + v / n_micro
        if replicas is not None:
            total = replicas.average_step_(optimizer.params, total, exact=("p_unique_ids",))
        optimizer.step()
        total["gumbel_t"] = t.detach().clone()
        return total

    return body


def draw_uniforms(generator: torch.Generator, model: RqVae, accum: int, batch_size: int) -> torch.Tensor:
    """The step's Gumbel uniforms [A, L, B, K], drawn micro-batch by
    micro-batch and level by level from `generator`."""
    cfg = model.config
    return torch.stack([torch.stack([torch.rand((batch_size, cfg.codebook_size), generator=generator)
                                     for _ in range(cfg.n_layers)]) for _ in range(accum)])


RANK_AXES = {"idx": 1, "uniforms": 2}  # the batch dimension of idx [A, B] and uniforms [A, L, B, K]


def _temperature(t, device) -> torch.Tensor:
    if isinstance(t, torch.Tensor):
        return t.to(device=device, dtype=torch.float32)
    return torch.full((), float(t), dtype=torch.float32, device=device)


def make_rqvae_train_step(model: RqVae, optimizer: AdamW, replicas: Optional[Replicas] = None):
    """step(x [A, B, D], generator, gumbel_t) -> metrics: one update from A
    micro-batches (total_loss, reconstruction_loss, rqvae_loss,
    p_unique_ids, gumbel_t, emb_norms [L]; means over the micro-batches).
    Gumbel mode draws its noise from `generator`; gumbel_t is a float or a
    device scalar. With `replicas`, x holds this rank's B rows of a global
    batch of world x B, and the uniforms are drawn for the global batch and
    sliced."""
    body = _make_body(model, optimizer, replicas=replicas)
    world = 1 if replicas is None else replicas.world

    def step(x: torch.Tensor, generator: Optional[torch.Generator] = None, gumbel_t=0.2):
        uniforms = None
        if _uses_noise(model):
            if generator is None:
                raise ValueError("GUMBEL_SOFTMAX mode needs a generator when training")
            uniforms = draw_uniforms(generator, model, x.shape[0], x.shape[1] * world)
            uniforms = rank_slice({"uniforms": uniforms}, replicas, RANK_AXES)["uniforms"]
            uniforms = uniforms.to(x.device, non_blocking=True)
        return body(x, uniforms, _temperature(gumbel_t, x.device))

    return step


def make_rqvae_index_train_step(model: RqVae, optimizer: AdamW, replicas: Optional[Replicas] = None):
    """step(features [N, D], idx [A, B], generator, gumbel_t) -> metrics: the
    train step on features[idx], gathered on the features' device. With
    `replicas`, idx is the global step's and the rank takes its B / world
    rows."""
    core = make_rqvae_train_step(model, optimizer, replicas)

    def step(features: torch.Tensor, idx: torch.Tensor, generator: Optional[torch.Generator] = None,
             gumbel_t=0.2):
        idx = rank_slice({"idx": idx}, replicas, RANK_AXES)["idx"]
        return core(features[idx.long()], generator, gumbel_t)

    return step


def rqvae_step_draws(model: RqVae, seed: int, step: int, n_items: int, batch_size: int, accum: int) -> Draws:
    """Every host draw of stage-1 step `step`, a function of (seed, step):
    its rows [A, B], its number, and in Gumbel mode its uniforms."""
    draws = {"idx": step_rows(seed, step, n_items, accum * batch_size).reshape(accum, batch_size),
             "step": torch.tensor(int(step), dtype=torch.long)}
    if _uses_noise(model):
        draws["uniforms"] = draw_uniforms(step_generator(seed, step), model, accum, batch_size)
    return draws


class RqvaeGraphTrainStep:
    """Chunks of stage-1 steps (the counterpart of make_rqvae_scan_train_step):

      step(features [N, D], draws) -> mean metrics

    `draws` holds 1 to n_steps steps' `rqvae_step_draws`. The temperature of
    a step is t_fn(step) on the device (ops/schedules.py::
    gumbel_temperature_at's tensor form, as the JAX scan's t_fn) or the fixed
    `gumbel_t`. The features are bound at the first call. On the card each
    step is one replay of a CUDA graph (n_steps > 1), on the CPU the same
    body eagerly; either way a chunk takes, bit for bit, the steps that
    make_rqvae_index_train_step takes from the same draws and temperature.
    `amp`: the trainer's knob (ops/amp.py), inside the graph too. With
    `replicas`, `batch_size` is the global batch, `draws` hands each step's
    global draws to the rank (rank_slice), and the steps are data-parallel;
    a group whose collectives a graph cannot hold (gloo) runs them eagerly."""

    def __init__(self, model: RqVae, optimizer: AdamW, n_steps: int, accum: int, batch_size: int,
                 gumbel_t: float = 0.2, t_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
                 amp: bool = False, replicas: Optional[Replicas] = None):
        self.model, self.accum, self.batch_size, self.replicas = model, accum, batch_size, replicas
        self.features: Optional[torch.Tensor] = None
        cfg = model.config
        if replicas is not None:
            local_rows(batch_size, replicas.rank, replicas.world)  # a batch the world does not divide raises
        rows = batch_size if replicas is None else batch_size // replicas.world
        body = _make_body(model, optimizer, amp, replicas)
        dev = next(model.parameters()).device

        def step_body(idx, step, uniforms=None):
            t = t_fn(step) if t_fn is not None else torch.full((), float(gumbel_t), dtype=torch.float32, device=dev)
            return body(self.features[idx], uniforms, t.to(torch.float32))

        specs = {"idx": ((accum, rows), torch.long), "step": ((), torch.long)}
        if _uses_noise(model):
            specs["uniforms"] = ((accum, cfg.n_layers, rows, cfg.codebook_size), torch.float32)
        self.chunks = StepChunks(step_body, specs, optimizer.state_tensors, dev, n_steps,
                                 capturable=replicas is None or replicas.capturable)

    def draws(self, seed: int, step: int, n_items: int) -> Draws:
        return rank_slice(rqvae_step_draws(self.model, seed, step, n_items, self.batch_size, self.accum),
                          self.replicas, RANK_AXES)

    def __call__(self, features: torch.Tensor, draws: List[Draws]) -> Dict[str, torch.Tensor]:
        if self.features is None:
            self.features = features
        elif features is not self.features:
            raise ValueError("a step graph reads the features it was first called with: pass the same tensor")
        return self.chunks.run(draws)


def make_rqvae_graph_train_step(model: RqVae, optimizer: AdamW, n_steps: int, accum: int, batch_size: int,
                                gumbel_t: float = 0.2, t_fn=None, amp: bool = False,
                                replicas: Optional[Replicas] = None) -> RqvaeGraphTrainStep:
    """Chunks of up to `n_steps` stage-1 steps, each one replay of a CUDA
    graph of the step on the card (see RqvaeGraphTrainStep)."""
    return RqvaeGraphTrainStep(model, optimizer, n_steps, accum, batch_size, gumbel_t, t_fn, amp, replicas)


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
