"""Stage-2 training as rqvae_tpu_torch's trainer runs it.

Set-up: item features, the frozen RQ-VAE and the T5 made on the card from
the seed; the corpus index built by the tokenizer (kernel 1, bf16); the
trainer's `make_decoder_graph_train_step` callable at the configuration's
batch, chunks of `steps_per_loop` steps by the trainer's rule at the
configuration's cadences. Steps 0, 1 and 2 run through that callable as a
chunk of one step (the first call captures the step's CUDA graph), then a
chunk of two (two staged slots, two replays, as the window's chunks stage
and replay): they are the steps the reference follows. Window: chunk after chunk from step 3,
each with its host draws, the graph's replays and one read-back of the chunk
means (a log step), until `seconds` have passed; no chunk is cut, and the
rate is all the window's samples over all its time. No evaluation or
checkpoint falls inside it.

The comparison, after the window and with the program's state freed: the
reference rebuilds the index and follows steps 0-2 from the same weights,
rows, uniforms and dropout seeds in float32:

- `loss_gap`: the largest |loss - reference| / reference over the two
  checked chunks (step 0's loss, and steps 1 and 2's mean, as the program
  reads a chunk's means back);
- `grad_norm_gap`: the first gradient as AdamW got it (its first moment
  after step 0 over 1 - b1), worst leaf: |norm - reference norm| over the
  larger of the reference norm and the median leaf's;
- `update_norm_gap`: the same for each leaf's change over the 3 steps,
  leaving out leaves whose reference gradient is under a thousandth of the
  median leaf's (they move by round-off alone);
- `index_ids_differ`: the share of items whose semantic-id tuple differs
  from the reference index's.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from perfbench.harness import flops, port, stats, traffic, weights
from perfbench.harness.cell import Check, Context, Result, free_memory
from perfbench.harness.trace import DeviceTrace
from perfbench.reference import rqvae as rq_ref
from perfbench.reference.precision import Precision, exact_float32
from perfbench.reference.t5 import T5
from perfbench.reference.train import AdamW, step_loss

CHUNKS = (1, 2)  # the checked steps' chunks: step 0 alone (its gradient read from AdamW), then 1 and 2
CHECKED_STEPS = sum(CHUNKS)
B1 = 0.9


def _cadences(tc: dict) -> List[int]:
    return [tc["log_every"], tc["iterations"], tc["save_model_every"], tc["partial_eval_every"],
            tc["full_eval_every"]]


def inputs(ctx: Context):
    """Features, histories and the RQ-VAE weights: the benchmark's inputs,
    made anew from the seed for either side."""
    cfg, dev = ctx.config, ctx.device
    features = weights.item_features(cfg["rqvae"], cfg["data"]["items"], ctx.seed, dev)
    items, lengths = traffic.histories(ctx.traffic, cfg["data"]["items"], ctx.seed, dev)
    return features, items, lengths, weights.rqvae_weights(cfg["rqvae"], features, ctx.seed)


class Program:
    """The measured trainer's objects, built as train_decoder.train builds them."""

    def __init__(self, ctx: Context, features, items, lengths, rq_w: Dict[str, torch.Tensor],
                 t5_w: Dict[str, torch.Tensor]):
        from rqvae_tpu_torch.ops.schedules import inverse_sqrt_schedule
        from rqvae_tpu_torch.train.decoder_steps import make_decoder_graph_train_step
        from rqvae_tpu_torch.train.state import adamw
        from rqvae_tpu_torch.train.step_graph import steps_per_loop

        cfg, dev, tc = ctx.config, ctx.device, ctx.config["train"]
        self.cached_ids = port.tokenizer(cfg, rq_w, features, dev, ctx.seed).cached_ids
        self.model = port.retrieval_model(cfg, t5_w, dev, ctx.seed)
        self.optimizer = adamw(self.model.parameters(),
                               inverse_sqrt_schedule(tc["learning_rate"], tc["warmup_steps"]),
                               weight_decay=tc["weight_decay"])
        self.spl = steps_per_loop(None, _cadences(tc))
        self.step_fn = make_decoder_graph_train_step(
            self.model, self.optimizer, max_seq_len=tc["max_seq_len"], n_steps=self.spl,
            batch_size=tc["batch_size"], leave_two_out=True, subsample=True)
        self.tables = (items, lengths, torch.arange(items.shape[0], device=dev), self.cached_ids)
        self.names = [n for n, _ in self.model.named_parameters()]
        self.rows = items.shape[0]

    def draws(self, seed: int, step: int):
        return self.step_fn.draws(seed, step, self.rows)

    def chunk(self, draws) -> Dict[str, torch.Tensor]:
        return self.step_fn(*self.tables, draws)


def _leaf_norms(tensors) -> np.ndarray:
    return torch.stack([t.detach().float().norm() for t in tensors]).cpu().double().numpy()


def first_steps(ctx: Context, prog: Program, t5_w: Dict[str, torch.Tensor]) -> dict:
    """Steps 0-2 through the window's callable, in the chunks of CHUNKS:
    each chunk's mean loss, the first gradient's leaf norms (after the
    first chunk, of step 0 alone), the change's leaf norms."""
    losses, draws, step = [], [], 0
    for n in CHUNKS:
        chunk = [prog.draws(ctx.seed, s) for s in range(step, step + n)]
        draws += chunk
        losses.append(float(prog.chunk(chunk)["total_loss"]))
        if step == 0:
            grad = _leaf_norms([m / (1.0 - B1) for m in prog.optimizer.mu])
        step += n
    params = dict(prog.model.named_parameters())
    change = _leaf_norms([params[n] - t5_w[n] for n in prog.names])
    return {"losses": losses, "grad": grad, "change": change, "draws": draws, "names": prog.names,
            "table": prog.cached_ids.cpu().numpy()}


def reference_steps(ctx: Context, draws: list, table, precision: str = "f32", keep_rows=None) -> dict:
    """The reference's steps 0-2 from the same weights and draws, over the
    program's index `table` (the index is judged apart: the reference's own
    index, built at `precision` too, is returned beside the readings)."""
    cfg, dev = ctx.config, ctx.device
    rq, tc = cfg["rqvae"], cfg["train"]
    prec = Precision(precision)
    with exact_float32():
        features, items, lengths, rq_w = inputs(ctx)
        own = rq_ref.corpus_ids(rq_w, features, prec).cpu().numpy()
        del features, rq_w
        table = torch.as_tensor(np.asarray(table), device=dev).long()
        start = weights.t5_weights(cfg["t5"], rq["n_layers"], rq["codebook_size"], ctx.seed, dev)
        names = list(start)
        params = {n: start[n].clone().requires_grad_(True) for n in names}
        model = T5(params, cfg["t5"], rq["n_layers"], rq["codebook_size"], prec, rate=cfg["t5"]["dropout"])
        opt = AdamW([params[n] for n in names], tc["learning_rate"], tc["weight_decay"])
        losses = []
        for step, d in enumerate(draws):
            dd = {k: torch.as_tensor(np.asarray(d[k]))[0].to(dev) for k in ("row_idx", "u_start", "u_end")}
            seeds = [int(s) for s in np.asarray(d["seeds"])[0]]  # one micro-batch
            per_level = step_loss(model, table, items, lengths, dd, tc["max_seq_len"], seeds, keep_rows)
            loss = sum(per_level)
            grads = torch.autograd.grad(loss, [params[n] for n in names], allow_unused=True)
            grads = [torch.zeros_like(params[n]) if g is None else g for n, g in zip(names, grads)]
            losses.append(float(loss.detach()))
            if step == 0:
                grad = _leaf_norms(grads)
            opt.step(grads)
            del grads, loss, per_level
        change = _leaf_norms([params[n] - start[n] for n in names])
    return {"names": names, "losses": losses, "grad": grad, "change": change, "table": own}


def chunk_means(losses) -> np.ndarray:
    """Per-step losses as the program reads them back: a mean a chunk."""
    ends = np.cumsum(CHUNKS)
    return np.asarray([np.mean(losses[e - n:e]) for n, e in zip(CHUNKS, ends)])


def compare(prog: dict, ref: dict, L: int) -> Dict[str, float]:
    """The numbers compared, from the two sides' readings."""
    lp, lr = np.asarray(prog["losses"]), chunk_means(ref["losses"])
    if sorted(prog["names"]) != sorted(ref["names"]):
        raise ValueError("the program's parameters are not the reference's")
    order = [prog["names"].index(n) for n in ref["names"]]  # the program's leaves in the reference's order
    gp, gr = prog["grad"][order], ref["grad"]
    cp, cr = prog["change"][order], ref["change"]
    g_med, c_med = float(np.median(gr)), float(np.median(cr))
    moved = gr >= 1e-3 * g_med  # leaves the reference's gradient moves beyond round-off
    return {
        "loss_gap": float(np.max(np.abs(lp - lr) / np.abs(lr))),
        "grad_norm_gap": float(np.max(np.abs(gp - gr) / np.maximum(gr, g_med))),
        "update_norm_gap": float(np.max((np.abs(cp - cr) / np.maximum(cr, c_med))[moved])),
        "index_ids_differ": float(np.mean(np.any(prog["table"][:, :L] != ref["table"][:, :L], axis=1))),
    }


def setup(ctx: Context):
    """The program built from the seed and driven through steps 0-2."""
    cfg = ctx.config
    L, K = cfg["rqvae"]["n_layers"], cfg["rqvae"]["codebook_size"]
    features, items, lengths, rq_w = inputs(ctx)
    t5_w = weights.t5_weights(cfg["t5"], L, K, ctx.seed, ctx.device)
    prog = Program(ctx, features, items, lengths, rq_w, t5_w)
    del features, rq_w
    readings = first_steps(ctx, prog, t5_w)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    return prog, readings



def controls(ctx: Context, compared: dict) -> Dict[str, Dict[str, float]]:
    """From the draws, index and reference that `run` compared: the numbers
    of the control (the reference in fp8 in the program's place) and of a
    planted fault (the loss over half of each batch)."""
    L, draws, table, ref = ctx.config["rqvae"]["n_layers"], compared["draws"], compared["table"], compared["ref"]
    half = slice(0, ctx.config["train"]["batch_size"] // 2)
    return {"control_fp8": compare(chunked(reference_steps(ctx, draws, table, "fp8")), ref, L),
            "fault_half_batch": compare(chunked(reference_steps(ctx, draws, table, keep_rows=half)), ref, L)}


def chunked(ref: dict) -> dict:
    """Reference readings in the program's place: losses as chunk means."""
    return {**ref, "losses": chunk_means(ref["losses"])}


def run(ctx: Context) -> Result:
    cfg, dev = ctx.config, ctx.device
    rq, t5, tc = cfg["rqvae"], cfg["t5"], cfg["train"]
    L, K = rq["n_layers"], rq["codebook_size"]
    prog, readings = setup(ctx)

    # the window: whole chunks from step 3, each ending in its read-back
    setup_s = time.time() - ctx.t0
    step, chunks, bad = CHECKED_STEPS, 0, 0

    def one_chunk(first: int) -> int:
        draws = [prog.draws(ctx.seed, s) for s in range(first, first + prog.spl)]
        means = {k: v.detach().cpu() for k, v in prog.chunk(draws).items()}
        return int(not all(bool(torch.isfinite(v).all()) for v in means.values()))

    t0 = time.perf_counter()
    while True:
        bad += one_chunk(step)
        step += prog.spl
        chunks += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    window_s = time.perf_counter() - t0
    tracer = None
    if ctx.trace:  # one more whole chunk, traced, after the window
        tracer = DeviceTrace()
        with tracer.window():
            bad += one_chunk(step)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    steps = chunks * prog.spl
    B = tc["batch_size"]
    Le = tc["max_seq_len"] * (L + 1)
    attn = {"B": B, "H": t5["num_heads"], "Lq": Le, "Lk": Le, "dk": t5["d_kv"], "dtype": t5["dtype"]}
    extra = {
        "kind": "train", "steps": steps, "window_s": window_s,
        "flops_per_step": flops.train_step_flops(t5, L, K, B, tc["max_seq_len"]),
        # the traced chunk's calls of each kernel function: one per encoder layer a step
        "calls": {"attention_fwd": [(attn, t5["num_layers"] * prog.spl)],
                  "attention_bwd": [(attn, t5["num_layers"] * prog.spl)]},
    }
    del prog
    free_memory(dev)

    ref = reference_steps(ctx, readings["draws"], readings["table"])
    numbers = compare(readings, ref, L)
    checks = [Check(name, value, float(ctx.limits[name])) for name, value in numbers.items()]
    extra["compared"] = {"draws": readings["draws"], "table": readings["table"], "ref": ref}
    e2e = {"setup_s": setup_s, "train_samples_per_s": stats.rate(steps * B, window_s)}
    return Result(e2e=e2e, attempted=steps, failed=bad, checks=checks, memory_peak_bytes=peak,
                  trace=tracer.finish() if tracer else None, extra=extra)
