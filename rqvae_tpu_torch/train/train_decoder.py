"""Stage-2 trainer: retrieval (decoder) training over semantic-ID sequences
(port of rqvae_tpu/train/train_decoder.py).

Same knob surface: corpus tokenization with the frozen RQ-VAE before training,
the prefix table for constrained generation, the inverse-sqrt LR with warm-up,
optional gradient clipping and accumulation, partial (loss only) and full
(generation + hits@k / NDCG) evaluation cadences, checkpoint and resume with
the optimizer's moments and the schedule's position. It runs on the card
unless `device="cpu"`.

The frozen RQ-VAE comes from a checkpoint of either format (utils/checkpoint.py:
this package's `.pt`, or the `.msgpack` file that every shipped
`configs/decoder_*.gin` names, as the JAX stage-1 trainer writes it) or, with
no path, from `seed` (untrained). A run resumes from a checkpoint of either
format too: this package's `.pt`, or the JAX trainer's `.msgpack` with its
optax opt_state (`auto_resume` takes the newest of either suffix). Every
step's randomness (rows, windows, dropout seeds) is a function of (`seed`,
step), so a resumed run takes the steps an unbroken run takes.

With `sample_candidates`, the full evaluation's beam search samples each
level's candidates with Gumbel noise drawn for eval batch `bi` from a CPU
generator of (`seed`, 999 + bi), the counterpart of the JAX trainer's
`fold_in(root_key, 999 + bi)` (the bits differ: JAX draws with threefry).

`amp=True` is the JAX trainer's bf16 matmul precision: on the card, at
`t5_dtype="float32"`, each step's `dense` products and output heads take
bf16 operands with float32 sums (ops/amp.py), in the step graph too; the
attention kernels keep their float32 route, and the evaluations stay
float32. On the CPU it changes nothing, as the JAX flag changes nothing
there. (At `t5_dtype="bfloat16"` the heads take the bf16 route and the
rest is as without it.)

`push_vae_to_hf=True` writes the frozen RQ-VAE to `save_dir_root/rqvae_export`
(utils/hub.py::save_pretrained, the JAX package's layout) and then tries the
push, which the port does not have: it prints that the push failed and that
the local export is kept, as the JAX trainer does offline.

Training runs in chunks of `steps_per_loop` steps, by the JAX trainer's rule
(train/step_graph.py::steps_per_loop: by default gcd of every cadence and
500): on the card each step of a chunk is one replay of a CUDA graph of the
whole step (train/decoder_steps.py::DecoderGraphTrainStep), and the metrics
logged at a chunk's end are the means over its steps, as the JAX trainer
logs its scan's means. `steps_per_loop=1` is the eager route, one step at a
time; so is debug mode (`RQVAE_TPU_DEBUG=1`, utils/debug.py). Evaluations,
checkpoints and resumes fall on chunk ends.

Data parallelism, as the JAX trainer's mesh: launched as several processes
with the markers of parallel/dist.py (RQVAE_TPU_NUM_PROCESSES,
RQVAE_TPU_PROCESS_ID and JAX_COORDINATOR_ADDRESS, or torchrun's), each rank
runs on its own card (or the CPU with `device="cpu"`), draws every step's
global rows from (`seed`, step) and keeps its slice of `batch_size` (which the
world must divide), and the ranks average their gradients and metrics before
each update (train/decoder_steps.py). After init or resume the state is
broadcast from rank 0. Only rank 0 writes checkpoints, logs and prints;
every rank evaluates the whole evaluation set, so all get the same numbers.
Under NCCL the step graphs hold the collectives; under gloo (ranks that
share a card) the steps run eagerly, and the first log line says so.

Knobs with no meaning here are accepted so that the shipped config files bind:
`split_batches`, `mixed_precision_type` (compute dtype is `t5_dtype`) and
`wandb_logging` without wandb.

CLI:  python -m rqvae_tpu_torch.train.train_decoder configs/decoder_synthetic.gin [param=value ...]
      (a trailing `pretrained_rqvae_path=None` trains over an RQ-VAE made from the seed)
"""

from __future__ import annotations

import os
import sys
import time
from typing import List, Optional

import torch

from rqvae_tpu_torch.data.datasets import ItemDataset, SeqDataset
from rqvae_tpu_torch.data.registry import RecDataset, ensure_dataset
from rqvae_tpu_torch.models.quantize import QuantizeForwardMode
from rqvae_tpu_torch.models.retrieval import EncoderDecoderRetrievalModel, RetrievalConfig
from rqvae_tpu_torch.models.rqvae import RqVae, RqVaeConfig
from rqvae_tpu_torch.ops.gumbel import sample_gumbel
from rqvae_tpu_torch.ops.metrics import TopKAccumulator
from rqvae_tpu_torch.ops.schedules import inverse_sqrt_schedule
from rqvae_tpu_torch.parallel import dist
from rqvae_tpu_torch.serving.beam import build_prefix_table
from rqvae_tpu_torch.tokenizer.semids import SemanticIdTokenizer
from rqvae_tpu_torch.train.decoder_steps import (
    make_decoder_eval_step,
    make_decoder_graph_train_step,
    make_generate_fn,
)
from rqvae_tpu_torch.train.state import adamw
from rqvae_tpu_torch.train.step_graph import step_generator, step_rows  # noqa: F401 (the trainers' step draws)
from rqvae_tpu_torch.train.step_graph import steps_per_loop as chunk_steps
from rqvae_tpu_torch.train.step_graph import stream_generator
from rqvae_tpu_torch.utils import checkpoint as ckpt_lib
from rqvae_tpu_torch.utils import hub
from rqvae_tpu_torch.utils.convert import jax_params_from_state_dict
from rqvae_tpu_torch.utils.debug import assert_finite, maybe_init_debug
from rqvae_tpu_torch.utils.device import DeviceLike, resolve_device
from rqvae_tpu_torch.utils.logging import MetricLogger


def load_rqvae(path: Optional[str], fallback: RqVaeConfig, device, seed: int) -> RqVae:
    """The frozen RQ-VAE: from a checkpoint of either format (a `.pt` file of
    this package, or the `.msgpack` file the JAX package's stage-1 trainer
    writes), or made from `seed` at `fallback` when there is no path."""
    if path is None:
        return RqVae(fallback, device=device, seed=seed)
    restored = ckpt_lib.load_checkpoint(path)
    if not isinstance(restored["config"], RqVaeConfig):
        raise ValueError(f"{path} is not an RQ-VAE checkpoint")
    rq = RqVae(restored["config"], device=device, seed=seed)
    rq.load_state_dict(ckpt_lib.params_state_dict(restored))
    if dist.is_main_process():
        print(f"---Loaded RQVAE iter {restored['step']}---")
    return rq


def eval_noise(model: EncoderDecoderRetrievalModel, batch, seed: int, bi: int) -> Optional[List[torch.Tensor]]:
    """The Gumbel noise of full-evaluation batch `bi` with sampled candidates
    (None without): every level's, drawn from the CPU generator of (seed,
    999 + bi) and moved to the model's device."""
    if not model.config.sample_candidates:
        return None
    g = stream_generator(seed, 999 + bi)
    shapes = model.sampling_noise_shapes(batch.sem_ids.shape[0])
    return [sample_gumbel(shape, g, device=model.device) for shape in shapes]


def train(
    iterations: int = 500000,
    batch_size: int = 64,
    learning_rate: float = 0.001,
    weight_decay: float = 0.01,
    dataset_folder: str = "dataset/synthetic",
    save_dir_root: str = "out/decoder/",
    dataset: RecDataset = RecDataset.SYNTHETIC,
    pretrained_rqvae_path: Optional[str] = None,
    pretrained_decoder_path: Optional[str] = None,
    split_batches: bool = True,
    amp: bool = False,
    wandb_logging: bool = False,
    force_dataset_process: bool = False,
    mixed_precision_type: str = "bf16",
    gradient_accumulate_every: int = 1,
    save_model_every: int = 1_000_000,
    partial_eval_every: int = 1000,
    full_eval_every: int = 10000,
    vae_input_dim: int = 18,
    vae_embed_dim: int = 16,
    vae_hidden_dims: List[int] = [18, 18],
    vae_codebook_size: int = 32,
    vae_codebook_normalize: bool = False,
    vae_sim_vq: bool = False,
    vae_n_cat_feats: int = 18,
    vae_n_layers: int = 3,
    dataset_split: str = "beauty",
    push_vae_to_hf: bool = False,
    train_data_subsample: bool = True,
    vae_hf_model_name: str = "",
    max_grad_norm: Optional[float] = None,
    t5_d_model: int = 128,
    t5_num_heads: int = 6,
    t5_d_ff: int = 1024,
    t5_num_layers: int = 4,
    top_k_for_generation: int = 10,
    should_add_sep_token: bool = True,
    num_user_bins: Optional[int] = None,
    top_k_eval_list: List[int] = [1, 5, 10],
    t5_dropout: float = 0.1,
    t5_dtype: str = "float32",
    t5_remat: bool = False,
    t5_fused_attention: str = "auto",  # attention kernels: "auto" | "on" | "off"
    t5_fused_decode: str = "auto",  # decoder-stack kernel (full eval)
    t5_fused_encode: str = "auto",  # encoder-stack kernel (full eval, long rows)
    t5_hash_dropout: bool = True,
    warmup_steps: int = 10000,
    sample_candidates: bool = False,
    full_eval_max_batches: Optional[int] = None,
    seed: int = 0,
    log_every: int = 100,
    steps_per_loop: Optional[int] = None,  # steps per chunk (None: the JAX rule; 1: eager, step by step)
    auto_resume: bool = False,
    device: DeviceLike = None,  # None: the card
) -> dict:
    debug = maybe_init_debug()
    dist.initialize_distributed(device)
    replicas = dist.replicas()
    is_main = dist.is_main_process()
    dev = resolve_device(device)  # on the card: this rank's, made current by initialize_distributed
    if auto_resume and pretrained_decoder_path is None:
        pretrained_decoder_path = ckpt_lib.latest_checkpoint(save_dir_root)
        if pretrained_decoder_path and is_main:
            print(f"---Auto-resuming from {pretrained_decoder_path}---")

    data = ensure_dataset(dataset_folder, dataset, split=dataset_split, force=force_dataset_process)
    item_dataset = ItemDataset(data, "all")
    train_dataset = SeqDataset(data, split="train", subsample=train_data_subsample)
    eval_dataset = SeqDataset(data, split="test")

    # --- frozen RQ-VAE + corpus index build ---
    rq_model = load_rqvae(
        pretrained_rqvae_path,
        RqVaeConfig(
            input_dim=vae_input_dim, embed_dim=vae_embed_dim, hidden_dims=tuple(vae_hidden_dims),
            codebook_size=vae_codebook_size, n_layers=vae_n_layers, n_cat_feats=vae_n_cat_feats,
            codebook_normalize=vae_codebook_normalize, sim_vq=vae_sim_vq, codebook_mode=QuantizeForwardMode.STE,
        ),
        dev, seed,
    )
    vae_cfg = rq_model.config
    tokenizer = SemanticIdTokenizer(rq_model, device=dev)
    cached_ids = tokenizer.precompute_corpus_ids(item_dataset.features)
    if push_vae_to_hf and is_main:
        export_dir = hub.save_pretrained(os.path.join(save_dir_root, "rqvae_export"),
                                         jax_params_from_state_dict(rq_model), vae_cfg)
        try:
            url = hub.push_to_hub(export_dir, vae_hf_model_name or "rqvae-tokenizer")
            print(f"Pushed tokenizer to {url}")
        except RuntimeError as e:  # no hub client here: keep the local export
            print(f"[hub] push failed ({e}); local export kept at {export_dir}")
    prefix_table = build_prefix_table(cached_ids[:, : vae_cfg.n_layers], vae_cfg.codebook_size)

    # --- retrieval model ---
    cfg = RetrievalConfig(
        num_hierarchies=vae_cfg.n_layers,
        codebook_size=vae_cfg.codebook_size,
        t5_d_model=t5_d_model,
        t5_num_heads=t5_num_heads,
        t5_d_ff=t5_d_ff,
        t5_num_layers=t5_num_layers,
        t5_dropout=t5_dropout,
        top_k_for_generation=top_k_for_generation,
        should_add_sep_token=should_add_sep_token,
        num_user_bins=num_user_bins,
        sample_candidates=sample_candidates,
        t5_dtype=t5_dtype,
        t5_remat=t5_remat,
        t5_fused_attention=t5_fused_attention,
        t5_fused_decode=t5_fused_decode,
        t5_fused_encode=t5_fused_encode,
        t5_hash_dropout=t5_hash_dropout,
    )
    model = EncoderDecoderRetrievalModel(cfg, device=dev, seed=seed)
    n_params = sum(p.numel() for p in model.parameters())
    if is_main:
        print(f"Device: {dev}, Num Parameters: {n_params}")

    optimizer = adamw(
        model.parameters(),
        inverse_sqrt_schedule(learning_rate, warmup_steps),
        weight_decay=weight_decay,
        max_grad_norm=max_grad_norm,
    )
    start_iter = 0
    if pretrained_decoder_path is not None:
        restored = ckpt_lib.load_checkpoint(pretrained_decoder_path)
        if not isinstance(restored["config"], RetrievalConfig):
            raise ValueError(f"{pretrained_decoder_path} is not a retrieval-model checkpoint")
        start_iter = ckpt_lib.restore_training_state(restored, model, optimizer)
    if replicas is not None:  # every rank starts from rank 0's state
        replicas.broadcast_(optimizer.state_tensors())

    # device-resident sequence store: per-step host work is sampling row
    # indices; window subsampling and tokenization run on the device
    seq_items_dev = torch.as_tensor(train_dataset.seq_items, device=dev)
    seq_lengths_dev = torch.as_tensor(train_dataset.seq_lengths, device=dev)
    seq_users_dev = torch.as_tensor(train_dataset.user_ids, device=dev)
    # chunks of spl steps, each step one replay of the step's CUDA graph on the
    # card; every cadence falls on a chunk end (the JAX trainer's rule)
    spl = chunk_steps(steps_per_loop, [log_every, iterations, save_model_every, partial_eval_every, full_eval_every])
    if debug and spl > 1:
        print(f"RQVAE_TPU_DEBUG: anomaly detection cannot be captured; steps_per_loop {spl} -> 1 (eager)")
        spl = 1
    train_step = make_decoder_graph_train_step(
        model,
        optimizer,
        max_seq_len=train_dataset.max_seq_len,
        n_steps=spl,
        batch_size=batch_size,
        leave_two_out=(train_dataset.format == "leave_two_out"),
        subsample=train_data_subsample,
        accum=gradient_accumulate_every,
        amp=amp,
        replicas=replicas,
    )
    if is_main and replicas is not None and dev.type == "cuda" and spl > 1 and not replicas.capturable:
        print(f"[dist] {replicas.backend} on the card: its collectives wait for the host, so each step of a "
              f"chunk runs eagerly (no step graph)", flush=True)
    eval_step = make_decoder_eval_step(model)
    generate = make_generate_fn(model)
    accumulator = TopKAccumulator(ks=top_k_eval_list)

    logger = MetricLogger(
        log_dir=os.path.join(save_dir_root, "logs"),
        use_wandb=wandb_logging,
        wandb_project="gen-retrieval-decoder-training",
        is_main=is_main,
    )
    t_start = time.time()
    summary: dict = {}
    ckpt_path = None
    end_iter = start_iter + iterations

    it = start_iter - 1
    while it + 1 < end_iter:
        draws = [train_step.draws(seed, step, len(train_dataset)) for step in range(it + 1, it + 1 + spl)]
        metrics = train_step(seq_items_dev, seq_lengths_dev, seq_users_dev, cached_ids, draws)  # chunk means
        it += spl

        if (it + 1) % log_every == 0 or it < start_iter + spl or it >= end_iter - 1:
            host = {k: v.detach().cpu() for k, v in metrics.items()}  # the chunk's one wait for the device
            if debug:
                assert_finite(host, f"train step {it}")
            log = {"total_loss": float(host["total_loss"])}
            log.update({f"loss_{d}": float(v) for d, v in enumerate(host["loss_d"])})
            log.update({f"train_{k}": float(v) for k, v in host.items() if k.startswith("seq_length_p")})
            logger.push_rolling({"total_loss": log["total_loss"]})
            log["rolling_total_loss"] = logger.rolling_means().get("total_loss", 0.0)
            log["learning_rate"] = optimizer.lr(it)
            logger.log(it, log, echo=(it + 1) % (log_every * 10) == 0)
            summary.update(log)

        if (it + 1) % partial_eval_every == 0:
            # pad_final=False: the eval step returns a batch mean, which a
            # padded final batch would bias toward its pad row
            ev, n_ev = 0.0, 0
            for eb, valid in eval_dataset.iter_eval_batches(batch_size, with_features=False, pad_final=False):
                ev += float(eval_step(tokenizer(eb))["eval_loss"]) * valid
                n_ev += valid
            summary["eval_loss"] = ev / max(n_ev, 1)
            logger.log(it, {"eval_loss": summary["eval_loss"]}, echo=True)

        if (it + 1) % full_eval_every == 0 or it + 1 == end_iter:
            accumulator.reset()
            for bi, (eb, valid) in enumerate(eval_dataset.iter_eval_batches(batch_size, with_features=False)):
                if full_eval_max_batches is not None and bi >= full_eval_max_batches:
                    break
                tok = tokenizer(eb)
                gen = generate(tok, prefix_table, eval_noise(model, tok, seed, bi))
                actual = tok.sem_ids_fut[:valid, : vae_cfg.n_layers]
                accumulator.accumulate(actual=actual.cpu(), top_k=gen.sem_ids[:valid].cpu())
            eval_metrics = accumulator.reduce()
            if is_main:
                print({k: round(v, 5) for k, v in eval_metrics.items()})
            logger.log(it, eval_metrics, echo=False)
            summary.update(eval_metrics)

        if (it + 1) % save_model_every == 0 or it + 1 == end_iter:
            ckpt_path = ckpt_lib.save_checkpoint_main(save_dir_root, it, model.state_dict(), optimizer.state_dict(),
                                                      cfg)

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    summary["iterations_per_sec"] = iterations / max(time.time() - t_start, 1e-9)
    summary["checkpoint_path"] = ckpt_path
    if replicas is not None:  # replicas that drifted apart would be a fault, not noise
        replicas.check_equal(optimizer.state_tensors(), "parameters and moments after training")
    logger.close()
    return summary


def main(argv: Optional[List[str]] = None) -> None:
    from rqvae_tpu_torch.utils.config import _parse_value, apply_config

    argv = argv if argv is not None else sys.argv[1:]
    if not argv or any("=" not in a for a in argv[1:]):
        print("usage: python -m rqvae_tpu_torch.train.train_decoder <config.gin> [param=value ...]", file=sys.stderr)
        raise SystemExit(2)
    overrides = {k.strip(): _parse_value(v) for k, v in (a.split("=", 1) for a in argv[1:])}
    apply_config(train, argv[0], **overrides)


if __name__ == "__main__":
    main()
