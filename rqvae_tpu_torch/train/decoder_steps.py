"""Train / eval / generate steps of the retrieval (decoder) stage
(port of rqvae_tpu/train/decoder_steps.py).

A step is tokenize -> forward -> backward -> clip -> AdamW with the LR
schedule inside the optimizer. The steps are plain functions closing over the
model and the optimizer, which they update in place; they return metrics as
device tensors and never read one back, so the caller decides when to wait for
the device (the logging cadence). Gradient accumulation runs `accum`
micro-batches with the loss divided by `accum`, so the accumulated gradient is
the mean over micro-batches, equal to one batch of accum x B rows.

All randomness of a step comes from the `torch.Generator` the caller passes (a
CPU generator): the window draws, made on the host and copied to the device,
and the dropout seeds (models/t5.py::DropoutSeeds), in that order.

`make_decoder_graph_train_step` is the counterpart of the JAX package's
`make_decoder_scan_train_step`: chunks of steps through static device buffers,
each step one replay of a CUDA graph of the fused step's body (train/
step_graph.py), the chunk's metrics their mean over its steps.

Data parallelism (`replicas`, parallel/dist.py::Replicas): every rank draws
the step's global rows and randomness from (seed, step), as one process
would, and keeps its contiguous slice of the rows (parallel/mesh.py::
local_rows). Its dropout sites count from its first global row
(models/t5.py::SiteSeeds), so it draws its slice of the global batch's masks,
as the JAX package's GSPMD step does. After the backward pass one all-reduce
averages the gradients and the metrics as one flat buffer (the sequence-length
quantiles are taken once over the gathered lengths, as GSPMD takes them over
the global batch); AdamW then clips the averaged gradient's global norm and
updates the same parameters on every rank. With equal shards the step equals
the one-process step up to the order of the sums. Under NCCL the collectives
are nodes of the step's CUDA graph. `make_decoder_shardmap_train_step` is the
counterpart of the JAX shard_map step: per-rank dropout seeds, local
counters.

Tensor parallelism: over an [n_data, n_model] mesh (parallel/mesh.py::
make_process_mesh) the model is cut with parallel/tp.py::shard_params before
the optimizer is made, `replicas` is the mesh's data group, and the model
ranks of one data index hold the same rows. The forward pass runs the model
group's collectives itself; AdamW updates each rank's shards (its moments are
sharded as the parameters are) and its clipping takes the global norm of the
whole gradient (tp.attach_optimizer). Under gloo the steps run eagerly.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from rqvae_tpu_torch.data.sampling import eval_windows, subsample_windows_from_draws
from rqvae_tpu_torch.data.schemas import TokenizedSeqBatch
from rqvae_tpu_torch.models.retrieval import EncoderDecoderRetrievalModel, GenerationOutput
from rqvae_tpu_torch.models.t5 import DropoutSeeds, SiteSeeds
from rqvae_tpu_torch.ops import amp as amp_lib
from rqvae_tpu_torch.parallel.dist import Replicas
from rqvae_tpu_torch.parallel.mesh import local_rows, rank_slice
from rqvae_tpu_torch.parallel.tp import attach_optimizer, shard_of
from rqvae_tpu_torch.serving.beam import PrefixTable
from rqvae_tpu_torch.tokenizer.semids import _tokenize_from_cache
from rqvae_tpu_torch.train.state import AdamW
from rqvae_tpu_torch.train.step_graph import Draws, StepChunks, step_generator, step_rows
from rqvae_tpu_torch.utils import profiling

SEQ_LENGTH_QUANTILES = (0.25, 0.5, 0.75, 0.9, 1.0)
SEQ_LENGTH_KEYS = tuple(f"seq_length_p{int(q * 100)}" for q in SEQ_LENGTH_QUANTILES)


def _debug_metrics(batch: TokenizedSeqBatch, replicas: Optional[Replicas] = None) -> Dict[str, torch.Tensor]:
    """Per-batch quantiles of the tokenized sequence lengths, over the
    global batch (every rank's lengths gathered) in a data-parallel step."""
    lengths = batch.seq_mask.sum(1).to(torch.float32)
    if replicas is not None:
        lengths = replicas.all_gather(lengths)
    return {k: torch.quantile(lengths, q) for k, q in zip(SEQ_LENGTH_KEYS, SEQ_LENGTH_QUANTILES)}


def _loss_and_metrics(model, batch: TokenizedSeqBatch, generator=None, seeds=None,
                      replicas: Optional[Replicas] = None):
    out = model(batch, training=True, generator=generator, seeds=seeds)
    metrics = {"total_loss": out.loss.detach(), "loss_d": out.loss_d.detach()}
    metrics.update(_debug_metrics(batch, replicas))
    if out.aux_loss is not None:  # sparse experts: the balance loss and each stack's counters
        metrics["aux_loss"] = out.aux_loss.detach()
        metrics.update({f"moe.{stack}": c for stack, c in out.moe_counts.items()})
    return out.loss, metrics


MOE_COUNTERS = ("moe.tokens", "moe.rows", "moe.rows_max")


def record_moe_counters(host: Dict[str, torch.Tensor], steps: int) -> None:
    """Hand a read-back chunk's MoE counters to the root recorder (outside
    captured code): per stack, `moe.tokens.<stack>` (valid tokens times MoE
    layers), `moe.rows.<stack>` (rows routed to the held experts) and
    `moe.rows_max.<stack>` (each layer's most-loaded held expert's rows,
    summed over the layers), the chunk's `steps` steps in all. `host` holds
    the chunk's means, read back; nothing without MoE layers."""
    for key, means in host.items():
        if key.startswith("moe."):
            stack = key.split(".", 1)[1]
            for name, v in zip(MOE_COUNTERS, means.tolist()):
                profiling.count(f"{name}.{stack}", int(round(v * steps)))


def _rank_seeds(seeds: Optional[torch.Tensor], replicas: Optional[Replicas], rows: int):
    """A forward's seed row for a rank holding `rows` rows: SiteSeeds that
    place them in the global batch (rank order), or the row as it is."""
    if seeds is None or replicas is None:
        return seeds
    return SiteSeeds(seeds, replicas.rank * rows, replicas.world * rows)


def _reduce(replicas: Optional[Replicas], optimizer: AdamW, metrics: Dict[str, torch.Tensor]):
    """The data-parallel mean of the gradients and metrics (none alone)."""
    if replicas is None:
        return metrics
    return replicas.average_step_(optimizer.params, metrics, exact=SEQ_LENGTH_KEYS)


def _step_seeds(model, generator, seeds, device):
    """The forward's seed row: `seeds`, else one row drawn from `generator`
    (None without dropout or generator)."""
    if seeds is None and generator is not None and _uses_dropout(model):
        seeds = DropoutSeeds.draw(generator, 1, model.n_dropout_sites)[0]
    return None if seeds is None else seeds.to(device)


def make_decoder_train_step(model: EncoderDecoderRetrievalModel, optimizer: AdamW,
                            replicas: Optional[Replicas] = None):
    """train_step(batch, generator=None, seeds=None) -> metrics: one update
    from one tokenized batch. The dropout seeds are `seeds` (a device row) or
    drawn from `generator`. With `replicas` the batch is this rank's
    contiguous slice of the global batch (every rank holds as many rows) and
    the update is the data-parallel one. A tensor-parallel shard (tp.
    shard_params) takes the tensor-parallel step."""
    attach_optimizer(model, optimizer)

    def train_step(batch: TokenizedSeqBatch, generator: Optional[torch.Generator] = None,
                   seeds: Optional[torch.Tensor] = None):
        model.train()
        optimizer.zero_grad()
        row = _rank_seeds(_step_seeds(model, generator, seeds, model.device), replicas, batch.sem_ids.shape[0])
        loss, metrics = _loss_and_metrics(model, batch, seeds=row, replicas=replicas)
        loss.backward()
        metrics = _reduce(replicas, optimizer, metrics)
        optimizer.step()
        return metrics

    return train_step


def make_decoder_shardmap_train_step(model: EncoderDecoderRetrievalModel, optimizer: AdamW,
                                     replicas: Optional[Replicas]):
    """train_step(batch, generator=None, seeds=None) -> metrics: the
    counterpart of the JAX package's `make_decoder_shardmap_train_step`. Each
    rank runs the whole forward and backward on its batch shard, the attention
    kernels on its local shapes, then the gradients and metrics are averaged
    over the ranks and every rank takes the same update. The dropout seeds are
    made distinct per rank (DropoutSeeds.fold_in(seeds, rank), the JAX step's
    `fold_in(key, axis_index)`) and count from the shard's row 0, so the
    shards' masks are independent draws, not slices of one global mask:
    without dropout the step equals the one-process step on the global
    batch."""

    def train_step(batch: TokenizedSeqBatch, generator: Optional[torch.Generator] = None,
                   seeds: Optional[torch.Tensor] = None):
        model.train()
        optimizer.zero_grad()
        row = _step_seeds(model, generator, seeds, model.device)
        if row is not None and replicas is not None:
            row = DropoutSeeds.fold_in(row, replicas.rank)
        loss, metrics = _loss_and_metrics(model, batch, seeds=row, replicas=replicas)
        loss.backward()
        metrics = _reduce(replicas, optimizer, metrics)
        optimizer.step()
        return metrics

    return train_step


def _make_micro_batch_fn(max_seq_len: int, leave_two_out: bool, subsample: bool):
    """Micro-batch construction on the device: window (sub)sampling and
    cached-table tokenization. The uniform draws come from the caller."""

    def build(seq_items, seq_lengths, user_ids, cached_ids, row_idx, u_start, u_end) -> TokenizedSeqBatch:
        if subsample:
            hist, fut = subsample_windows_from_draws(
                u_start, u_end, seq_items, seq_lengths, row_idx, max_seq_len, leave_two_out
            )
        else:
            L = seq_lengths[row_idx.long()]
            # clamp to 0, not 1: a length-1 row targets its only item with an empty history
            hist_end = torch.clamp(L - 2 if leave_two_out else L - 1, min=0)
            hist, fut = eval_windows(seq_items, seq_lengths, row_idx, hist_end, max_seq_len)
        return _tokenize_from_cache(cached_ids, user_ids[row_idx.long()], hist, fut, hist >= 0)

    return build


def _uses_dropout(model: EncoderDecoderRetrievalModel) -> bool:
    return model.config.t5_dropout > 0.0


def _make_fused_body(model: EncoderDecoderRetrievalModel, optimizer: AdamW, max_seq_len: int,
                     leave_two_out: bool, subsample: bool, accum: int, amp: bool = False,
                     replicas: Optional[Replicas] = None):
    """body(tables, row_idx [accum, B], u_start, u_end [accum, B], seeds
    [accum, C] or None) -> metrics: the fused step on device tensors, reading
    nothing back (the body a step graph captures). With `amp`, the float32
    products and the heads take bf16 operands with f32 sums on the card
    (ops/amp.py). With `replicas`, the B rows are this rank's slice of each
    micro-batch and the update is the data-parallel one."""
    build = _make_micro_batch_fn(max_seq_len, leave_two_out, subsample)
    attach_optimizer(model, optimizer)

    @amp_lib.bf16_products(amp)
    def body(tables, row_idx, u_start, u_end, seeds=None):
        model.train()
        optimizer.zero_grad()
        total: Dict[str, torch.Tensor] = {}
        for a in range(accum):
            batch = build(*tables, row_idx[a], u_start[a], u_end[a])
            row = _rank_seeds(None if seeds is None else seeds[a], replicas, row_idx.shape[1])
            loss, metrics = _loss_and_metrics(model, batch, seeds=row, replicas=replicas)
            (loss / accum).backward()  # grads add up in .grad: the mean over micro-batches
            for k, v in metrics.items():
                total[k] = v / accum if k not in total else total[k] + v / accum
        total = _reduce(replicas, optimizer, total)
        optimizer.step()
        return total

    return body


def draw_decoder_step(generator: torch.Generator, accum: int, batch_size: int,
                      n_sites: Optional[int]) -> Dict[str, torch.Tensor]:
    """A step's host draws from its generator, in the eager step's order:
    u_start, u_end [accum, B], then the dropout seeds [accum, C] (one block
    row per micro-batch; none when n_sites is None)."""
    draws = {"u_start": torch.rand((accum, batch_size), generator=generator),
             "u_end": torch.rand((accum, batch_size), generator=generator)}
    if n_sites is not None:
        draws["seeds"] = DropoutSeeds.draw(generator, accum, n_sites)
    return draws


def make_decoder_fused_train_step(
    model: EncoderDecoderRetrievalModel,
    optimizer: AdamW,
    max_seq_len: int,
    leave_two_out: bool = True,
    subsample: bool = True,
    accum: int = 1,
    replicas: Optional[Replicas] = None,
):
    """The whole stage-2 step from row indices: window subsampling on the
    device, tokenization from the cached id table, forward / backward over
    `accum` accumulated micro-batches, clip, AdamW.

      step(seq_items [R, T], seq_lengths [R], user_ids [R], cached_ids [N, L+1],
           row_idx [accum * B], generator) -> metrics

    The tables and row_idx live on the model's device. Per-step host work is
    sampling the row indices, 2 x accum x B uniforms and the dropout seeds.
    With `replicas`, row_idx and the draws are the global step's, and the rank
    keeps its slice of each micro-batch's B rows."""
    body = _make_fused_body(model, optimizer, max_seq_len, leave_two_out, subsample, accum, replicas=replicas)

    def train_step(seq_items, seq_lengths, user_ids, cached_ids, row_idx, generator: torch.Generator):
        dev = seq_items.device
        row_idx = row_idx.reshape(accum, -1)
        n_sites = model.n_dropout_sites if _uses_dropout(model) else None
        draws = {"row_idx": row_idx, **draw_decoder_step(generator, accum, row_idx.shape[1], n_sites)}
        draws = {k: v.to(dev, non_blocking=True) for k, v in rank_slice(draws, replicas, RANK_AXES).items()}
        return body((seq_items, seq_lengths, user_ids, cached_ids), **draws)

    return train_step


# the batch dimension of a step's row draws [A, B]; the dropout seeds stay
# whole (a rank's sites place its rows in the global batch)
RANK_AXES = {"row_idx": 1, "u_start": 1, "u_end": 1}


def decoder_step_draws(seed: int, step: int, n_rows: int, batch_size: int, accum: int,
                       n_sites: Optional[int]) -> Draws:
    """Every host draw of training step `step`, a function of (seed, step):
    its rows (train/step_graph.py::step_rows) and its generator's draws."""
    rows = step_rows(seed, step, n_rows, accum * batch_size).reshape(accum, batch_size)
    return {"row_idx": rows, **draw_decoder_step(step_generator(seed, step), accum, batch_size, n_sites)}


class DecoderGraphTrainStep:
    """Chunks of stage-2 steps (the counterpart of make_decoder_scan_train_step):

      step(seq_items, seq_lengths, user_ids, cached_ids, draws) -> mean metrics

    `draws` holds 1 to n_steps steps' `decoder_step_draws`. The tables are
    bound at the first call (a captured graph reads them where they are) and
    must be the same tensors at every later call. On the card each step is
    one replay of a CUDA graph of the fused step (n_steps > 1), on the CPU
    the same body eagerly; either way the chunk takes, bit for bit, the steps
    that make_decoder_fused_train_step takes from the same draws. `amp`: the
    trainer's knob (ops/amp.py), inside the graph too. With `replicas`,
    `batch_size` is the global batch, `draws` hands each step's global draws
    to the rank (rank_slice), and the steps are data-parallel; a group whose
    collectives a graph cannot hold (gloo) runs the steps eagerly."""

    def __init__(self, model: EncoderDecoderRetrievalModel, optimizer: AdamW, max_seq_len: int, n_steps: int,
                 batch_size: int, leave_two_out: bool = True, subsample: bool = True, accum: int = 1,
                 amp: bool = False, replicas: Optional[Replicas] = None):
        if not model.config.t5_hash_dropout and _uses_dropout(model) and model.device.type == "cuda" and n_steps > 1:
            raise ValueError("a step graph needs hash dropout (t5_hash_dropout=True): the Bernoulli masks "
                             "seed a generator on the host")
        self.model, self.optimizer, self.accum, self.batch_size = model, optimizer, accum, batch_size
        self.replicas = replicas
        if replicas is not None:
            local_rows(batch_size, replicas.rank, replicas.world)  # a batch the world does not divide raises
        rows = batch_size if replicas is None else batch_size // replicas.world
        self.n_sites = model.n_dropout_sites if _uses_dropout(model) else None
        body = _make_fused_body(model, optimizer, max_seq_len, leave_two_out, subsample, accum, amp, replicas)
        specs = {"row_idx": ((accum, rows), torch.long),
                 "u_start": ((accum, rows), torch.float32), "u_end": ((accum, rows), torch.float32)}
        if self.n_sites is not None:
            specs["seeds"] = ((accum, DropoutSeeds.columns(self.n_sites)), torch.int32)
        self.tables: Optional[tuple] = None
        shard = shard_of(model)
        capturable = (replicas is None or replicas.capturable) and (shard is None or shard.capturable)
        self.chunks = StepChunks(lambda **d: body(self.tables, **d), specs, optimizer.state_tensors,
                                 model.device, n_steps, capturable=capturable)

    def draws(self, seed: int, step: int, n_rows: int) -> Draws:
        """Step `step`'s host draws (span `train.draws`)."""
        with profiling.span("train.draws"):
            return rank_slice(decoder_step_draws(seed, step, n_rows, self.batch_size, self.accum, self.n_sites),
                              self.replicas, RANK_AXES)

    def bind(self, seq_items, seq_lengths, user_ids, cached_ids) -> None:
        tables = (seq_items, seq_lengths, user_ids, cached_ids)
        if self.tables is None:
            self.tables = tables
        elif any(a is not b for a, b in zip(self.tables, tables)):
            raise ValueError("a step graph reads the tables it was first called with: pass the same tensors")

    def __call__(self, seq_items, seq_lengths, user_ids, cached_ids, draws: List[Draws]) -> Dict[str, torch.Tensor]:
        self.bind(seq_items, seq_lengths, user_ids, cached_ids)
        return self.chunks.run(draws)


def make_decoder_graph_train_step(
    model: EncoderDecoderRetrievalModel,
    optimizer: AdamW,
    max_seq_len: int,
    n_steps: int,
    batch_size: int,
    leave_two_out: bool = True,
    subsample: bool = True,
    accum: int = 1,
    amp: bool = False,
    replicas: Optional[Replicas] = None,
) -> DecoderGraphTrainStep:
    """Chunks of up to `n_steps` stage-2 steps, each one replay of a CUDA
    graph of the fused step on the card (see DecoderGraphTrainStep)."""
    return DecoderGraphTrainStep(model, optimizer, max_seq_len, n_steps, batch_size, leave_two_out, subsample,
                                 accum, amp, replicas)


def make_decoder_eval_step(model: EncoderDecoderRetrievalModel):
    """eval_step(batch) -> {"eval_loss", "eval_loss_d"}: the loss without dropout."""

    @torch.no_grad()
    def eval_step(batch: TokenizedSeqBatch):
        model.eval()
        out = model(batch, training=False)
        return {"eval_loss": out.loss, "eval_loss_d": out.loss_d}

    return eval_step


def make_generate_fn(model: EncoderDecoderRetrievalModel):
    """generate(batch, prefix_table, noise=None) -> GenerationOutput
    (constrained beam search). With `sample_candidates`, `noise` is each
    level's Gumbel noise (EncoderDecoderRetrievalModel.sampling_noise_shapes),
    the counterpart of the JAX generate's `rng`."""

    def generate(batch: TokenizedSeqBatch, prefix_table: PrefixTable,
                 noise: Optional[Sequence[torch.Tensor]] = None) -> GenerationOutput:
        model.eval()
        return model.generate(batch.sem_ids, batch.seq_mask, batch.user_ids, prefix_table, noise)

    return generate
