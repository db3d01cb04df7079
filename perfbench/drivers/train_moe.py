"""Stage-2 training of the retrieval T5 with DeepSeek-V2's sparse-expert FFN,
as rqvae_tpu_torch's trainer runs it (drivers/train.py's cell, with the
model that perfbench/harness/moe.py builds).

Set-up: as drivers/train.py's, with the MoE model (`t5_ffn="moe"`, this
chip's share of the experts, `experts_held`). Steps 0, 1 and 2 run through
the window's callable as three chunks of one step each (the first captures
the step's CUDA graph; each is one replay), and after each the experts that
every MoE block's tokens chose in it are read back: the reference follows
them, as it follows the program's index. Window: as drivers/train.py's;
each chunk's read-back also hands the MoE counters to the program's recorder
(`record_moe_counters`, as the trainer does), and the routed rows it read
set the step's operation count (`mfu.train`).

The comparison, after the window and with the program's state freed: the
reference (reference/t5_moe.py, float32) rebuilds the index and follows
steps 0-2 from the same weights, rows, uniforms, dropout seeds and expert
choices, a block of REFERENCE_ROWS rows at a time (its gradient the sum of
the blocks'), so that its float32 attention weights fit beside the model:

- `loss_gap`, `grad_norm_gap`, `update_norm_gap`, `index_ids_differ`: as
  drivers/train.py's, each step's loss its own chunk's;
- `route_differ`: of the (token, slot) choices the program made for valid
  tokens in steps 0-2, the share that is not among the reference's own
  float32 top_k at the same token.

The parent of the change that added this driver has no sparse experts: the
run stops at once on the import of rqvae_tpu_torch.models.moe.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from perfbench.harness import moe as moe_h
from perfbench.harness import port, registry, stats
from perfbench.harness.cell import Check, Context, Result, free_memory
from perfbench.harness.trace import DeviceTrace
from perfbench.reference import rqvae as rq_ref
from perfbench.reference.precision import Precision, exact_float32
from perfbench.reference.t5_moe import T5MoE
from perfbench.reference.train import AdamW, tokens, windows

base = registry.module("drivers", "train")

CHUNKS = (1, 1, 1)  # the checked steps, a chunk each: each step's expert choices are read back after it
CHECKED_STEPS = sum(CHUNKS)
REFERENCE_ROWS = 8  # rows of a reference block: [8, 32, 800, 800] float32 attention weights are 655 MB


class Program(base.Program):
    """drivers/train.py's trainer objects, with the MoE model."""

    def __init__(self, ctx: Context, features, items, lengths, rq_w, t5_w):
        from rqvae_tpu_torch.ops.schedules import inverse_sqrt_schedule
        from rqvae_tpu_torch.train.decoder_steps import make_decoder_graph_train_step, record_moe_counters
        from rqvae_tpu_torch.train.state import adamw
        from rqvae_tpu_torch.train.step_graph import steps_per_loop

        cfg, dev, tc = ctx.config, ctx.device, ctx.config["train"]
        self.cached_ids = port.tokenizer(cfg, rq_w, features, dev, ctx.seed).cached_ids
        self.model = moe_h.retrieval_model(cfg, t5_w, dev)
        self.optimizer = adamw(self.model.parameters(),
                               inverse_sqrt_schedule(tc["learning_rate"], tc["warmup_steps"]),
                               weight_decay=tc["weight_decay"])
        self.spl = steps_per_loop(None, base._cadences(tc))
        self.step_fn = make_decoder_graph_train_step(
            self.model, self.optimizer, max_seq_len=tc["max_seq_len"], n_steps=self.spl,
            batch_size=tc["batch_size"], leave_two_out=True, subsample=True)
        self.tables = (items, lengths, torch.arange(items.shape[0], device=dev), self.cached_ids)
        self.names = [n for n, _ in self.model.named_parameters()]
        self.rows = items.shape[0]
        self.record = record_moe_counters

    def read_back(self, draws) -> Dict[str, torch.Tensor]:
        """A chunk, its means read back, its MoE counters recorded."""
        means = {k: v.detach().cpu() for k, v in self.chunk(draws).items()}
        self.record(means, len(draws))
        return means

    def choices(self) -> List[torch.Tensor]:
        """Each MoE block's [tokens, K] expert choices of the last step."""
        return [c.cpu() for stack in (self.model.encoder, self.model.decoder) for c in stack.moe_chosen]


def first_steps(ctx: Context, prog: Program, t5_w: Dict[str, torch.Tensor]) -> dict:
    """Steps 0-2 through the window's callable, a chunk each: losses, the
    first gradient's and the change's leaf norms, each step's choices."""
    losses, draws, choices, step = [], [], [], 0
    for n in CHUNKS:
        chunk = [prog.draws(ctx.seed, s) for s in range(step, step + n)]
        draws += chunk
        losses.append(float(prog.read_back(chunk)["total_loss"]))
        choices.append(prog.choices())
        if step == 0:
            grad = base._leaf_norms([m / (1.0 - base.B1) for m in prog.optimizer.mu])
        step += n
    params = dict(prog.model.named_parameters())
    change = base._leaf_norms([params[n] - t5_w[n].to(ctx.device) for n in prog.names])
    return {"losses": losses, "grad": grad, "change": change, "draws": draws, "names": prog.names,
            "table": prog.cached_ids.cpu().numpy(), "choices": choices}


def reference_steps(ctx: Context, draws: list, table, follow=None, precision: str = "f32", keep_rows=None) -> dict:
    """The reference's steps 0-2 over the program's index `table`, following
    the program's expert choices `follow` (per step, per MoE block; None:
    its own top_k), in blocks of REFERENCE_ROWS rows. Returns, beside
    drivers/train.py's readings, each step's own top_k per block (`own`)
    and the valid tokens (`valid`)."""
    cfg, dev = ctx.config, ctx.device
    rq, tc, t5 = cfg["rqvae"], cfg["train"], cfg["t5"]
    L, K = rq["n_layers"], rq["codebook_size"]
    prec = Precision(precision)
    with exact_float32():
        features, items, lengths, rq_w = base.inputs(ctx)
        own_index = rq_ref.corpus_ids(rq_w, features, prec).cpu().numpy()
        del features, rq_w
        table = torch.as_tensor(np.asarray(table), device=dev).long()
        start = moe_h.t5_weights(cfg, ctx.seed, dev)
        names = list(start)
        params = {n: start[n].clone().requires_grad_(True) for n in names}
        model = T5MoE(params, t5, cfg["moe"], L, K, prec, rate=t5["dropout"])
        opt = AdamW([params[n] for n in names], tc["learning_rate"], tc["weight_decay"])
        losses, own, valid = [], [], []
        n_enc = t5["num_layers"] - cfg["moe"]["first_k_dense"]
        for step, d in enumerate(draws):
            rows, u, v = (torch.as_tensor(np.asarray(d[k]))[0].to(dev) for k in ("row_idx", "u_start", "u_end"))
            if keep_rows is not None:
                rows, u, v = rows[keep_rows], u[keep_rows], v[keep_rows]
            seeds = [int(s) for s in np.asarray(d["seeds"])[0]]
            hist, target = windows(items, lengths, rows, u, v, tc["max_seq_len"])
            ids, mask, tgt = tokens(table, hist, target, L)
            B = ids.shape[0]
            grads = [torch.zeros_like(params[n]) for n in names]
            loss, step_own, step_valid = 0.0, [], []
            for r0 in range(0, B, REFERENCE_ROWS):
                sl = slice(r0, min(B, r0 + REFERENCE_ROWS))
                n = sl.stop - sl.start
                model.reset()
                model.row0 = r0
                model.follow = None if follow is None else [_rows(c, B, sl) for c in follow[step]]
                x, m = model.embed_history(ids[sl], mask[sl])
                dec = model.decoder(model.decoder_inputs(tgt[sl], n), model.encoder(x, m, seeds), m, seeds)
                nll = sum(-torch.log_softmax(model.level_logits(dec[:, lv], lv), -1)
                          .gather(1, tgt[sl, lv:lv + 1].long()).sum() for lv in range(L))
                block = (nll + torch.stack(model.aux).sum()) / B
                for acc, g in zip(grads, torch.autograd.grad(block, [params[k] for k in names], allow_unused=True)):
                    if g is not None:
                        acc.add_(g)
                loss += float(block.detach())
                for i, o in enumerate(model.own):  # the encoder's MoE blocks first: their padding is not routed
                    step_own.append((i, o.cpu()))
                    step_valid.append((i, m.reshape(-1).cpu() if i < n_enc else torch.ones(o.shape[0], dtype=torch.bool)))
                del block, nll, dec, x, m
            losses.append(loss)
            own.append(_join(step_own))
            valid.append(_join(step_valid))
            if step == 0:
                grad = base._leaf_norms(grads)
            opt.step(grads)
            del grads
        change = base._leaf_norms([params[n] - start[n] for n in names])
    return {"names": names, "losses": losses, "grad": grad, "change": change, "table": own_index,
            "own": own, "valid": valid}


def _rows(choice: torch.Tensor, B: int, sl: slice) -> torch.Tensor:
    """A block's [tokens, K] choices cut to rows `sl` of B (tokens row-major)."""
    return choice.reshape(B, -1, choice.shape[-1])[sl].reshape(-1, choice.shape[-1])


def _join(parts) -> List[torch.Tensor]:
    """Per MoE block, its row blocks' tensors in row order."""
    out: Dict[int, list] = {}
    for i, t in parts:
        out.setdefault(i, []).append(t)
    return [torch.cat(out[i]) for i in sorted(out)]


def route_differ(choices, own, valid) -> float:
    """The share of the valid tokens' (token, slot) choices in `choices` that
    are not among `own`'s top_k for the same token (over a common prefix of
    tokens, rows first), every step and block."""
    missed, total = 0, 0
    for step_c, step_o, step_v in zip(choices, own, valid):
        for c, o, v in zip(step_c, step_o, step_v):
            n = min(c.shape[0], o.shape[0])
            c, o, v = c[:n].long(), o[:n].long(), v[:n]
            out = (c[:, :, None] != o[:, None, :]).all(-1)[v]
            missed += int(out.sum())
            total += out.numel()
    return missed / max(total, 1)


def compare(prog: dict, ref: dict, L: int) -> Dict[str, float]:
    """drivers/train.py's numbers, each step its own chunk, and `route_differ`."""
    lp, lr = np.asarray(prog["losses"]), np.asarray(ref["losses"])
    order = [prog["names"].index(n) for n in ref["names"]]
    gp, gr = prog["grad"][order], ref["grad"]
    cp, cr = prog["change"][order], ref["change"]
    g_med, c_med = float(np.median(gr)), float(np.median(cr))
    moved = gr >= 1e-3 * g_med
    return {
        "loss_gap": float(np.max(np.abs(lp - lr) / np.abs(lr))),
        "grad_norm_gap": float(np.max(np.abs(gp - gr) / np.maximum(gr, g_med))),
        "update_norm_gap": float(np.max((np.abs(cp - cr) / np.maximum(cr, c_med))[moved])),
        "index_ids_differ": float(np.mean(np.any(prog["table"][:, :L] != ref["table"][:, :L], axis=1))),
        "route_differ": route_differ(prog["choices"], ref["own"], ref["valid"]),
    }


def controls(ctx: Context, compared: dict) -> Dict[str, Dict[str, float]]:
    """The control (the reference in fp8, on its own routing) and the planted
    fault (the loss over half of each batch), in the program's place."""
    L, draws, table, ref = ctx.config["rqvae"]["n_layers"], compared["draws"], compared["table"], compared["ref"]
    half = slice(0, ctx.config["train"]["batch_size"] // 2)
    out = {}
    for name, kw in (("control_fp8", {"precision": "fp8"}), ("fault_half_batch", {"keep_rows": half})):
        got = reference_steps(ctx, draws, table, **kw)
        out[name] = compare({**got, "choices": got["own"]}, ref, L)
        free_memory(ctx.device)
    return out


def setup(ctx: Context):
    cfg = ctx.config
    features, items, lengths, rq_w = base.inputs(ctx)
    t5_w = moe_h.t5_weights(cfg, ctx.seed, ctx.device)
    prog = Program(ctx, features, items, lengths, rq_w, t5_w)
    t5_w = {k: v.cpu() for k, v in t5_w.items()}  # the start, kept off the card for the change's norms
    del features, rq_w
    free_memory(ctx.device)
    readings = first_steps(ctx, prog, t5_w)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    return prog, readings


def run(ctx: Context) -> Result:
    import rqvae_tpu_torch.models.moe  # noqa: F401  (a program without sparse experts stops here, at once)

    cfg, dev = ctx.config, ctx.device
    rq, t5, tc, moe = cfg["rqvae"], cfg["t5"], cfg["train"], cfg["moe"]
    L = rq["n_layers"]
    prog, readings = setup(ctx)

    setup_s = time.time() - ctx.t0
    step, chunks, bad = CHECKED_STEPS, 0, 0
    routed = {"encoder": 0.0, "decoder": 0.0}

    def one_chunk(first: int) -> dict:
        means = prog.read_back([prog.draws(ctx.seed, s) for s in range(first, first + prog.spl)])
        means["bad"] = int(not all(bool(torch.isfinite(v).all()) for v in means.values()))
        return means

    t0 = time.perf_counter()
    while True:
        means = one_chunk(step)
        bad += means["bad"]
        for stack in routed:
            routed[stack] += float(means[f"moe.{stack}"][1]) * prog.spl
        step += prog.spl
        chunks += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    window_s = time.perf_counter() - t0
    tracer = None
    if ctx.trace:  # one more whole chunk, traced, after the window
        tracer = DeviceTrace()
        with tracer.window():
            traced = one_chunk(step)
        bad += traced["bad"]
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    steps = chunks * prog.spl
    B = tc["batch_size"]
    Le = tc["max_seq_len"] * (L + 1)
    attn = {"B": B, "H": t5["num_heads"], "Lq": Le, "Lk": Le, "dk": t5["d_kv"], "dtype": t5["dtype"]}
    moe_layers = t5["num_layers"] - moe["first_k_dense"]
    experts = []
    if ctx.trace:  # the traced chunk's expert products: one call a MoE block a step, at its mean rows
        for stack in routed:
            rows = float(traced[f"moe.{stack}"][1]) / moe_layers
            experts.append(({"rows": rows, "d": t5["d_model"], "f": moe["expert_d_ff"],
                             "experts": moe["experts_held"][1], "dtype": t5["dtype"]}, moe_layers * prog.spl))
    extra = {
        "kind": "train", "steps": steps, "window_s": window_s,
        "flops_per_step": moe_h.train_step_flops(cfg, {k: v / steps for k, v in routed.items()}),
        "calls": {"attention_fwd": [(attn, t5["num_layers"] * prog.spl)],
                  "attention_bwd": [(attn, t5["num_layers"] * prog.spl)],
                  "moe_experts": experts},
    }
    del prog
    free_memory(dev)

    ref = reference_steps(ctx, readings["draws"], readings["table"], follow=readings["choices"])
    numbers = compare(readings, ref, L)
    checks = [Check(name, value, float(ctx.limits[name])) for name, value in numbers.items()]
    extra["compared"] = {"draws": readings["draws"], "table": readings["table"], "ref": ref}
    e2e = {"setup_s": setup_s, "train_samples_per_s": stats.rate(steps * B, window_s)}
    return Result(e2e=e2e, attempted=steps, failed=bad, checks=checks, memory_peak_bytes=peak,
                  trace=tracer.finish() if tracer else None, extra=extra)
