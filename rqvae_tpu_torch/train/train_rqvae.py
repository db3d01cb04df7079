"""Stage-1 trainer: RQ-VAE tokenizer training (port of rqvae_tpu/train/train_rqvae.py).

Same knob surface and cadences: k-means warm start of the codebooks on up to
`kmeans_init_samples` training items, gradient accumulation, rolling loss
windows, the Gumbel temperature (fixed, or the exponential anneal in closed
form), dead-code restarts, the eval-loss cadence with the id-diversity
metrics of a full index build (codebook usage, tuple entropy, the largest
duplicate share), checkpoint and resume with the optimizer's moments. It runs
on the card unless `device="cpu"`.

On the card the index build of each evaluation launches the rq_encode kernel
at the tokenizer's default precision, bf16, as the JAX trainer's tokenizer
does on its accelerator; on the CPU it takes the model's f32 path, as the JAX
trainer's does there. `index_build_ms` (host clock, synchronised) is logged
beside the diversity metrics, and `kmeans_init_ms` is in the summary.

Every step's randomness (rows, Gumbel noise) and every restart's reseed draw
is a function of (`seed`, step), and the temperature anneal is its closed
form, computed on the device from the step number (the float32 arithmetic of
the JAX scan's `t_fn`), so a resumed run takes the steps an unbroken run
takes.

Training runs in chunks of `steps_per_loop` steps, by the JAX trainer's rule
(train/step_graph.py::steps_per_loop): on the card each step of a chunk is
one replay of a CUDA graph of the whole step (train/rqvae_steps.py::
RqvaeGraphTrainStep), and the metrics logged at a chunk's end are the means
over its steps, as the JAX trainer logs its scan's means. Restarts,
evaluations, checkpoints and resumes fall on chunk ends; k-means init,
restarts and resumes write the parameters in place. `steps_per_loop=1` is
the eager route; so is debug mode (`RQVAE_TPU_DEBUG=1`, utils/debug.py).

`amp=True` is the JAX trainer's bf16 matmul precision: on the card each
step's MLP products take bf16 operands with float32 sums (ops/amp.py), in the
step graph too; the quantizer, k-means and the evaluations stay float32. On
the CPU it changes nothing, as the JAX flag changes nothing there.

A run resumes from a checkpoint of either format (utils/checkpoint.py): this
package's `.pt`, or the JAX stage-1 trainer's `.msgpack` with its optax
opt_state (or without one, as the JAX trainer resumes too).

Data parallelism, as the JAX trainer's mesh (batch axis 1 of [A, B, D]):
launched as several processes with the markers of parallel/dist.py, each
rank runs on its own card (or the CPU), draws every step's global rows and
Gumbel uniforms from (`seed`, step) and keeps its slice of `batch_size`
(which the world must divide); the ranks average their gradients and
metrics before each update (train/rqvae_steps.py). k-means init and the
restarts read the same training items on every rank; the state is broadcast
from rank 0 after init or resume all the same. Only rank 0 writes
checkpoints and logs; every rank runs the whole evaluation. Under NCCL the
step graphs hold the collectives; under gloo the steps run eagerly, and the
first log line says so.

Knobs with no meaning here are accepted so that the shipped config files bind:
`split_batches`, `mixed_precision_type` and `wandb_logging` without wandb.

CLI:  python -m rqvae_tpu_torch.train.train_rqvae configs/rqvae_synthetic.gin [param=value ...]
"""

from __future__ import annotations

import os
import sys
import time
from functools import partial
from typing import List, Optional

import torch

from rqvae_tpu_torch.data.datasets import ItemDataset
from rqvae_tpu_torch.data.registry import RecDataset, ensure_dataset
from rqvae_tpu_torch.models.quantize import QuantizeForwardMode
from rqvae_tpu_torch.models.rqvae import RqVae, RqVaeConfig, kmeans_init_codebooks, restart_dead_codebook_entries
from rqvae_tpu_torch.ops.dedup import codebook_usage, pack_sem_id_tuples, tuple_entropy
from rqvae_tpu_torch.ops.schedules import gumbel_temperature_at
from rqvae_tpu_torch.parallel import dist
from rqvae_tpu_torch.tokenizer.semids import SemanticIdTokenizer
from rqvae_tpu_torch.train.rqvae_steps import make_rqvae_eval_step, make_rqvae_graph_train_step
from rqvae_tpu_torch.train.state import adamw
from rqvae_tpu_torch.train.step_graph import steps_per_loop as chunk_steps
from rqvae_tpu_torch.train.step_graph import stream_generator
from rqvae_tpu_torch.utils import checkpoint as ckpt_lib
from rqvae_tpu_torch.utils.debug import assert_finite, maybe_init_debug
from rqvae_tpu_torch.utils.device import DeviceLike, resolve_device
from rqvae_tpu_torch.utils.logging import MetricLogger

KMEANS_STREAM, RESTART_STREAM = 2, 777  # the reference's fold_in constants for these draws


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train(
    iterations: int = 50000,
    batch_size: int = 64,
    learning_rate: float = 0.0001,
    weight_decay: float = 0.01,
    dataset_folder: str = "dataset/synthetic",
    dataset: RecDataset = RecDataset.SYNTHETIC,
    pretrained_rqvae_path: Optional[str] = None,
    save_dir_root: str = "out/rqvae/",
    use_kmeans_init: bool = True,
    split_batches: bool = True,
    amp: bool = False,
    wandb_logging: bool = False,
    do_eval: bool = True,
    force_dataset_process: bool = False,
    mixed_precision_type: str = "bf16",
    gradient_accumulate_every: int = 1,
    save_model_every: int = 1_000_000,
    eval_every: int = 50000,
    commitment_weight: float = 0.25,
    vae_n_cat_feats: int = 18,
    vae_input_dim: int = 18,
    vae_embed_dim: int = 16,
    vae_hidden_dims: List[int] = [18, 18],
    vae_codebook_size: int = 32,
    vae_codebook_normalize: bool = False,
    vae_codebook_mode: QuantizeForwardMode = QuantizeForwardMode.GUMBEL_SOFTMAX,
    vae_sim_vq: bool = False,
    vae_n_layers: int = 3,
    dataset_split: str = "beauty",
    gumbel_temperature: float = 0.2,
    gumbel_anneal_rate: Optional[float] = None,  # None: a fixed temperature
    gumbel_min_t: float = 0.05,
    gumbel_anneal_step_size: int = 1000,
    seed: int = 0,
    log_every: int = 100,
    kmeans_init_samples: int = 20000,
    steps_per_loop: Optional[int] = None,  # steps per chunk (None: the JAX rule; 1: eager, step by step)
    codebook_restart_every: Optional[int] = None,  # re-seed unused codes every N iterations (None: off)
    codebook_restart_until: Optional[int] = None,  # no restart after this iteration (None: never stop)
    auto_resume: bool = False,  # resume from the latest checkpoint in save_dir_root
    device: DeviceLike = None,  # None: the card
) -> dict:
    """Returns a summary dict with the last metrics and the checkpoint path."""
    debug = maybe_init_debug()
    dist.initialize_distributed(device)
    replicas = dist.replicas()
    is_main = dist.is_main_process()
    dev = resolve_device(device)  # on the card: this rank's, made current by initialize_distributed
    if auto_resume and pretrained_rqvae_path is None:
        pretrained_rqvae_path = ckpt_lib.latest_checkpoint(save_dir_root)
        if pretrained_rqvae_path and is_main:
            print(f"---Auto-resuming from {pretrained_rqvae_path}---")

    data = ensure_dataset(dataset_folder, dataset, split=dataset_split, force=force_dataset_process)
    train_items = ItemDataset(data, "train" if do_eval else "all")
    eval_items = ItemDataset(data, "eval") if do_eval else None
    index_items = ItemDataset(data, "all") if do_eval else train_items

    cfg = RqVaeConfig(
        input_dim=vae_input_dim, embed_dim=vae_embed_dim, hidden_dims=tuple(vae_hidden_dims),
        codebook_size=vae_codebook_size, n_layers=vae_n_layers, commitment_weight=commitment_weight,
        n_cat_feats=vae_n_cat_feats, codebook_normalize=vae_codebook_normalize, sim_vq=vae_sim_vq,
        codebook_mode=vae_codebook_mode,
    )
    model = RqVae(cfg, device=dev, seed=seed)
    optimizer = adamw(model.parameters(), learning_rate, weight_decay=weight_decay)
    summary: dict = {}
    start_iter = 0
    sample = torch.as_tensor(train_items.head(kmeans_init_samples), device=dev)  # k-means init and restarts
    if pretrained_rqvae_path is not None:
        restored = ckpt_lib.load_checkpoint(pretrained_rqvae_path)
        if not isinstance(restored["config"], RqVaeConfig):
            raise ValueError(f"{pretrained_rqvae_path} is not an RQ-VAE checkpoint")
        start_iter = ckpt_lib.restore_training_state(restored, model, optimizer, need_opt_state=False)
        if is_main:
            print(f"---Loaded RQVAE iter {restored['step']}---")
    elif use_kmeans_init:
        sync(dev)
        t0 = time.perf_counter()
        kmeans_init_codebooks(
            model, sample, stream_generator(seed, KMEANS_STREAM),
            # Gumbel configs: level l > 0 is fitted to soft-mixture residuals at
            # the iteration-0 temperature, the regime of the reference's init
            gumbel_temperature=gumbel_temperature if vae_codebook_mode == QuantizeForwardMode.GUMBEL_SOFTMAX else None,
        )
        sync(dev)
        summary["kmeans_init_ms"] = (time.perf_counter() - t0) * 1e3
    if replicas is not None:  # every rank starts from rank 0's state
        replicas.broadcast_(optimizer.state_tensors())

    # device-resident features: per-step host work is sampling row indices
    features_dev = torch.as_tensor(train_items.features, device=dev)
    eval_dev = torch.as_tensor(eval_items.features, device=dev) if do_eval else None
    index_dev = torch.as_tensor(index_items.features, device=dev) if do_eval else None
    cadences = [log_every, iterations, save_model_every]
    if do_eval:
        cadences.append(eval_every)
    if codebook_restart_every:
        cadences.append(codebook_restart_every)
    spl = chunk_steps(steps_per_loop, cadences)
    if debug and spl > 1:
        print(f"RQVAE_TPU_DEBUG: anomaly detection cannot be captured; steps_per_loop {spl} -> 1 (eager)")
        spl = 1
    t_fn = None
    if gumbel_anneal_rate is not None:  # the anneal on the device, from the step number
        t_fn = partial(gumbel_temperature_at, t0=gumbel_temperature, min_t=gumbel_min_t,
                       anneal_rate=gumbel_anneal_rate, step_size=gumbel_anneal_step_size)
    train_step = make_rqvae_graph_train_step(model, optimizer, n_steps=spl, accum=gradient_accumulate_every,
                                             batch_size=batch_size, gumbel_t=gumbel_temperature, t_fn=t_fn, amp=amp,
                                             replicas=replicas)
    if is_main and replicas is not None and dev.type == "cuda" and spl > 1 and not replicas.capturable:
        print(f"[dist] {replicas.backend} on the card: its collectives wait for the host, so each step of a "
              f"chunk runs eagerly (no step graph)", flush=True)
    eval_step = make_rqvae_eval_step(model)
    tokenizer = SemanticIdTokenizer(model, device=dev)

    logger = MetricLogger(log_dir=os.path.join(save_dir_root, "logs"), use_wandb=wandb_logging,
                          wandb_project="rq-vae-training", is_main=is_main)
    t_start = time.time()
    ckpt_path = None
    end_iter = start_iter + iterations
    t = gumbel_temperature
    it = start_iter - 1
    while it + 1 < end_iter:
        draws = [train_step.draws(seed, step, len(train_items)) for step in range(it + 1, it + 1 + spl)]
        metrics = train_step(features_dev, draws)  # the chunk's means
        it += spl
        if t_fn is not None:  # host mirror for logging and the eval passes
            t = t_fn(it)

        if (it + 1) % log_every == 0 or it < start_iter + spl or it >= end_iter - 1:
            host = {k: v.detach().cpu() for k, v in metrics.items()}  # the chunk's one wait for the device
            if debug:
                assert_finite(host, f"train step {it}")
            log = {k: float(v) for k, v in host.items() if v.dim() == 0}
            log.update({f"emb_avg_norm_{i}": float(v) for i, v in enumerate(host["emb_norms"])})
            logger.push_rolling({k: log[k] for k in ("total_loss", "reconstruction_loss", "rqvae_loss")})
            log.update({f"rolling_{k}": v for k, v in logger.rolling_means().items()})
            logger.log(it, {**log, "temperature": t, "learning_rate": learning_rate},
                       echo=(it + 1) % (log_every * 10) == 0)
            summary.update(log)

        if codebook_restart_every and (it + 1) % codebook_restart_every == 0 and it + 1 != end_iter and (
                codebook_restart_until is None or it < codebook_restart_until):
            dead = restart_dead_codebook_entries(model, sample, stream_generator(seed, RESTART_STREAM, it))
            logger.log(it, {f"restarted_codes_{i}": float(d) for i, d in enumerate(dead.cpu())})

        if do_eval and ((it + 1) % eval_every == 0 or it + 1 == end_iter):
            eval_metrics = _run_eval(eval_step, eval_dev, batch_size, t)
            diversity = _id_diversity_metrics(tokenizer, index_dev, cfg)
            logger.log(it, {**eval_metrics, **diversity}, echo=True)
            summary.update(eval_metrics)
            summary.update(diversity)

        if (it + 1) % save_model_every == 0 or it + 1 == end_iter:
            ckpt_path = ckpt_lib.save_checkpoint_main(save_dir_root, it, model.state_dict(), optimizer.state_dict(),
                                                      cfg)

    sync(dev)
    summary["iterations_per_sec"] = iterations / max(time.time() - t_start, 1e-9)
    summary["checkpoint_path"] = ckpt_path
    if replicas is not None:  # replicas that drifted apart would be a fault, not noise
        replicas.check_equal(optimizer.state_tensors(), "parameters and moments after training")
    logger.close()
    return summary


def _run_eval(eval_step, features: torch.Tensor, batch_size: int, t: float) -> dict:
    """The eval losses over every eval item: batch means weighted by the
    batch's size (the last batch runs at its own size; padding it would bias
    the means toward the pad row)."""
    n = features.shape[0]
    sums: dict = {}
    for s in range(0, n, batch_size):
        x = features[s:s + batch_size]
        for k, v in eval_step(x, t).items():
            sums[k] = sums.get(k, 0.0) + v * x.shape[0]
    return {k: float(v) / max(n, 1) for k, v in sums.items()}


def _id_diversity_metrics(tokenizer: SemanticIdTokenizer, features: torch.Tensor, cfg: RqVaeConfig) -> dict:
    """Codebook usage per level, tuple entropy and the largest duplicate
    share of a full index build, and the build's host-clock ms."""
    tokenizer.reset()
    sync(features.device)
    t0 = time.perf_counter()
    cached = tokenizer.precompute_corpus_ids(features)
    sync(features.device)
    build_ms = (time.perf_counter() - t0) * 1e3
    ids = cached[:, : cfg.n_layers]
    out = {f"codebook_usage_{i}": float(u) for i, u in enumerate(codebook_usage(ids, cfg.codebook_size).cpu())}
    out["rqvae_entropy"] = float(tuple_entropy(pack_sem_id_tuples(ids, cfg.codebook_size)))
    out["max_id_duplicates"] = float(cached[:, -1].max()) / cached.shape[0]
    out["index_build_ms"] = build_ms
    return out


def main(argv: Optional[List[str]] = None) -> None:
    from rqvae_tpu_torch.utils.config import _parse_value, apply_config

    argv = argv if argv is not None else sys.argv[1:]
    if not argv or any("=" not in a for a in argv[1:]):
        print("usage: python -m rqvae_tpu_torch.train.train_rqvae <config.gin> [param=value ...]", file=sys.stderr)
        raise SystemExit(2)
    overrides = {k.strip(): _parse_value(v) for k, v in (a.split("=", 1) for a in argv[1:])}
    apply_config(train, argv[0], **overrides)


if __name__ == "__main__":
    main()
