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
and the dropout seeds (models/t5.py::DropoutSeeds).

The JAX package's `lax.scan` over several steps has no counterpart: a Python
loop over the fused step is the same program here. Its `shard_map` step has
no counterpart until the package runs on more than one GPU.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from rqvae_tpu_torch.data.sampling import eval_windows, subsample_windows_from_draws
from rqvae_tpu_torch.data.schemas import TokenizedSeqBatch
from rqvae_tpu_torch.models.retrieval import EncoderDecoderRetrievalModel, GenerationOutput
from rqvae_tpu_torch.serving.beam import PrefixTable
from rqvae_tpu_torch.tokenizer.semids import _tokenize_from_cache
from rqvae_tpu_torch.train.state import AdamW

SEQ_LENGTH_QUANTILES = (0.25, 0.5, 0.75, 0.9, 1.0)


def _debug_metrics(batch: TokenizedSeqBatch) -> Dict[str, torch.Tensor]:
    """Per-batch quantiles of the tokenized sequence lengths."""
    lengths = batch.seq_mask.sum(1).to(torch.float32)
    return {f"seq_length_p{int(q * 100)}": torch.quantile(lengths, q) for q in SEQ_LENGTH_QUANTILES}


def _loss_and_metrics(model, batch: TokenizedSeqBatch, generator):
    out = model(batch, training=True, generator=generator)
    metrics = {"total_loss": out.loss.detach(), "loss_d": out.loss_d.detach()}
    metrics.update(_debug_metrics(batch))
    return out.loss, metrics


def make_decoder_train_step(model: EncoderDecoderRetrievalModel, optimizer: AdamW):
    """train_step(batch, generator) -> metrics: one update from one tokenized batch."""

    def train_step(batch: TokenizedSeqBatch, generator: Optional[torch.Generator] = None):
        model.train()
        optimizer.zero_grad()
        loss, metrics = _loss_and_metrics(model, batch, generator)
        loss.backward()
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


def make_decoder_fused_train_step(
    model: EncoderDecoderRetrievalModel,
    optimizer: AdamW,
    max_seq_len: int,
    leave_two_out: bool = True,
    subsample: bool = True,
    accum: int = 1,
):
    """The whole stage-2 step from row indices: window subsampling on the
    device, tokenization from the cached id table, forward / backward over
    `accum` accumulated micro-batches, clip, AdamW.

      step(seq_items [R, T], seq_lengths [R], user_ids [R], cached_ids [N, L+1],
           row_idx [accum * B], generator) -> metrics

    The tables and row_idx live on the model's device. Per-step host work is
    sampling the row indices and 2 x accum x B uniforms."""
    build = _make_micro_batch_fn(max_seq_len, leave_two_out, subsample)

    def train_step(seq_items, seq_lengths, user_ids, cached_ids, row_idx, generator: torch.Generator):
        model.train()
        dev = seq_items.device
        row_idx = row_idx.reshape(accum, -1)
        u_start = torch.rand(row_idx.shape, generator=generator).to(dev, non_blocking=True)
        u_end = torch.rand(row_idx.shape, generator=generator).to(dev, non_blocking=True)
        optimizer.zero_grad()
        total: Dict[str, torch.Tensor] = {}
        for a in range(accum):
            batch = build(seq_items, seq_lengths, user_ids, cached_ids, row_idx[a], u_start[a], u_end[a])
            loss, metrics = _loss_and_metrics(model, batch, generator)
            (loss / accum).backward()  # grads add up in .grad: the mean over micro-batches
            for k, v in metrics.items():
                total[k] = v / accum if k not in total else total[k] + v / accum
        optimizer.step()
        return total

    return train_step


def make_decoder_eval_step(model: EncoderDecoderRetrievalModel):
    """eval_step(batch) -> {"eval_loss", "eval_loss_d"}: the loss without dropout."""

    @torch.no_grad()
    def eval_step(batch: TokenizedSeqBatch):
        model.eval()
        out = model(batch, training=False)
        return {"eval_loss": out.loss, "eval_loss_d": out.loss_d}

    return eval_step


def make_generate_fn(model: EncoderDecoderRetrievalModel):
    """generate(batch, prefix_table) -> GenerationOutput (constrained beam search)."""

    def generate(batch: TokenizedSeqBatch, prefix_table: PrefixTable) -> GenerationOutput:
        model.eval()
        return model.generate(batch.sem_ids, batch.seq_mask, batch.user_ids, prefix_table)

    return generate
