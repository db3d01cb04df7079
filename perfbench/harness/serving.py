"""What the serving drivers share: the program's serving stack built from the
seed, the requests of a traffic mix, and the comparison of served answers
with the plain reference.

The program: the frozen RQ-VAE's index built by the tokenizer (kernel 1,
bf16), the retrieval model at the configuration's compute dtype, a
`Retriever` over them and a `RetrievalEngine` with the traffic's buckets,
every bucket the traffic reaches captured in set-up.

The comparison, after the window and with the program's state freed, over
a sample of the answered requests drawn from the seed, the longest history
in it. The reference rebuilds the index from the same weights and features;
its share of items whose tuple differs from the program's is
`index_ids_differ`. From there it follows the program's own index (the
bf16 index build may place a near-tie item in the other cell, and beams and
the inverse lookup can only be judged against the corpus that was served),
and scores each served beam and its siblings by teacher forcing:

- `beam_choice_gap`: the largest shortfall of a served beam set from what
  every sound constrained search keeps, by the reference's scores (nats;
  `reference/beam.py::choice_gap`): a served first id below the k best
  valid ones, or a valid unserved child of a served parent above the worst
  served beam. It holds on any path, so a near-tie that sends the program
  and the reference down different beams does not move it; a search that
  keeps worse beams moves it;
- `beam_tuple_bad`: served beams that are not k distinct corpus tuples:
  valid beams whose tuple no corpus item has or that repeat an earlier
  beam of the same request, and beams short of k valid ones (a sound search
  keeps k valid beams at every level once the corpus has k first ids):
  exact, limit 0;
- `beam_logp_gap`: the largest |served log-probability - the reference's
  log-probability of the served tuple| over the valid served beams (nats);
- `item_lookup_wrong`: served items that are not the earliest corpus item
  with the served tuple (an invalid beam must serve -1): exact, limit 0.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from perfbench.harness import port, weights
from perfbench.reference import beam as beam_ref
from perfbench.reference import rqvae as rq_ref
from perfbench.reference.precision import Precision, exact_float32
from perfbench.reference.t5 import T5

SAMPLE = 512
BLOCK = 64
VALID = -1e8  # a served log-probability below this is an invalid beam (-1e9 and its sums)


class ServingProgram:
    """The measured serving stack, built as Retriever.from_checkpoints builds it."""

    def __init__(self, ctx, features, rq_w: Dict[str, torch.Tensor], t5_w: Dict[str, torch.Tensor]):
        from rqvae_tpu_torch.serving.engine import RetrievalEngine
        from rqvae_tpu_torch.serving.retriever import Retriever

        cfg, dev, tr = ctx.config, ctx.device, ctx.traffic
        tokenizer = port.tokenizer(cfg, rq_w, features, dev, ctx.seed)
        self.cached_ids = tokenizer.cached_ids
        model = port.retrieval_model(cfg, t5_w, dev, ctx.seed)
        self.retriever = Retriever(model, tokenizer, device=dev)
        self.engine = RetrievalEngine(self.retriever, max_items=tr["max_items"],
                                      item_buckets=tr.get("item_buckets"), batch_buckets=tr["batch_buckets"])

    def warm(self, item_buckets: Sequence[int]) -> int:
        """Capture (on the card) or run once (elsewhere) every bucket of the
        given item buckets at every batch bucket."""
        n = 0
        for ib in item_buckets:
            for bb in self.engine.batch_buckets:
                if self.engine.use_graphs:
                    self.engine.graph_for(bb, ib)
                else:
                    h = np.full((bb, ib), -1, np.int32)
                    h[:, 0] = 0
                    self.retriever.retrieve(h, np.zeros((bb,), np.int32))
                n += 1
        return n

    def reached_item_buckets(self, lengths: np.ndarray) -> List[int]:
        e = self.engine
        return sorted({e._bucket_for(max(min(int(n), e.max_items), 1), e.item_buckets) for n in lengths})


def build(ctx) -> "ServingProgram":
    """The serving stack over weights and features made from the seed."""
    cfg = ctx.config
    L, K = cfg["rqvae"]["n_layers"], cfg["rqvae"]["codebook_size"]
    features = weights.item_features(cfg["rqvae"], cfg["data"]["items"], ctx.seed, ctx.device)
    rq_w = weights.rqvae_weights(cfg["rqvae"], features, ctx.seed)
    return ServingProgram(ctx, features, rq_w, weights.t5_weights(cfg["t5"], L, K, ctx.seed, ctx.device))


def requests(ctx, n: int) -> List[np.ndarray]:
    """`n` request histories: users drawn from the seed, each its history
    less the held-out last item (int32 item ids)."""
    from perfbench.harness import traffic

    items, lengths = traffic.histories(ctx.traffic, ctx.config["data"]["items"], ctx.seed, torch.device("cpu")
                                       if ctx.device.type != "cuda" else ctx.device)
    items, lengths = items.cpu().numpy(), lengths.cpu().numpy()
    users = np.random.default_rng([int(ctx.seed) & (2**64 - 1), 12]).integers(0, items.shape[0], n)
    return [items[u, : lengths[u] - 1].astype(np.int32) for u in users]


def sample(ctx, answered, hists: Sequence[np.ndarray], size: int = SAMPLE) -> np.ndarray:
    """Indices of a sample of the answered requests, drawn from the seed,
    with the longest history among them."""
    answered = np.asarray(sorted(answered))
    if answered.size <= size:
        return answered
    rng = np.random.default_rng([int(ctx.seed) & (2**64 - 1), 13])
    pick = rng.choice(answered, size - 1, replace=False)
    longest = answered[np.argmax([len(hists[i]) for i in answered])]
    return np.unique(np.append(pick, longest))


def _tokens(table: torch.Tensor, hists: Sequence[np.ndarray], L: int, max_items: int, dev):
    """Histories (last max_items items), right-padded, as [B, N, L] ids and mask."""
    trimmed = [h[-max_items:] for h in hists]
    N = max(1, max(len(h) for h in trimmed))
    ids = torch.full((len(trimmed), N), -1, dtype=torch.int64)
    for i, h in enumerate(trimmed):
        ids[i, : len(h)] = torch.as_tensor(h, dtype=torch.int64)
    ids = ids.to(dev)
    mask = (ids >= 0)[:, :, None].expand(-1, -1, L)
    tok = torch.where(mask, table[ids.clamp(min=0)][:, :, :L], -1)
    return tok, mask


def reference_answers(ctx, table, hists: Sequence[np.ndarray], precision: str) -> dict:
    """The reference in the program's place, over the index `table`: its
    beams, their scores and items (at "fp8", the control's answers)."""
    cfg = ctx.config
    table = torch.as_tensor(table, device=ctx.device).long()
    L, K = cfg["rqvae"]["n_layers"], cfg["rqvae"]["codebook_size"]
    prec = Precision(precision)
    with exact_float32():
        W = weights.t5_weights(cfg["t5"], L, K, ctx.seed, ctx.device)
        model = T5(W, cfg["t5"], L, K, prec)
        prefixes = beam_ref.prefix_sets(table, L, K)
        out = {"sem_ids": [], "log_probas": [], "item_ids": []}
        for i in range(0, len(hists), BLOCK):
            tok, mask = _tokens(table, hists[i:i + BLOCK], L, ctx.traffic["max_items"], ctx.device)
            x, m = model.embed_history(tok, mask)
            beams, score = beam_ref.search(model, model.encoder(x, m), m, prefixes, cfg["t5"]["top_k"])
            items = torch.where(score > VALID, beam_ref.inverse_lookup(table, beams, K), -1)
            out["sem_ids"].append(beams.cpu())
            out["log_probas"].append(score.cpu())
            out["item_ids"].append(items.cpu())
    return {k: torch.cat(v).numpy() for k, v in out.items()}


def _bad_tuples(table: torch.Tensor, beams: torch.Tensor, valid: torch.Tensor, K: int, due: int) -> int:
    """Beam slots [B, k, L] that break k distinct valid corpus tuples: valid
    beams that no corpus item has or that repeat an earlier valid beam of
    the same request, and valid beams short of `due` in a request."""
    outside = (beam_ref.inverse_lookup(table, beams, K) < 0) & valid
    key = torch.zeros(beams.shape[:2], dtype=torch.int64, device=beams.device)
    for h in range(beams.shape[-1]):
        key = key * K + beams[..., h].long()
    same = (key[:, :, None] == key[:, None, :]) & valid[:, :, None] & valid[:, None, :]
    repeat = torch.tril(same, diagonal=-1).any(dim=2)  # equal to an earlier beam
    short = (due - valid.sum(1)).clamp(min=0)
    return int((outside | repeat).sum() + short.sum())


def compare(ctx, table_np: np.ndarray, hists: Sequence[np.ndarray], served: dict,
            index_precision: Optional[str] = None) -> Dict[str, float]:
    """The numbers compared, for served answers (sem_ids [n, k, L],
    log_probas [n, k], item_ids [n, k]) of the requests `hists`, served over
    the index `table_np`; the index judged is that one, or with
    `index_precision` the one the reference builds at that precision (the
    control's)."""
    cfg, dev = ctx.config, ctx.device
    rq = cfg["rqvae"]
    L, K = rq["n_layers"], rq["codebook_size"]
    with exact_float32():
        features = weights.item_features(rq, cfg["data"]["items"], ctx.seed, dev)
        rq_w = weights.rqvae_weights(rq, features, ctx.seed)
        ref_table = rq_ref.corpus_ids(rq_w, features, Precision("f32")).cpu().numpy()
        index_table = table_np if index_precision is None else \
            rq_ref.corpus_ids(rq_w, features, Precision(index_precision)).cpu().numpy()
        del features, rq_w
        differ = float(np.mean(np.any(index_table[:, :L] != ref_table[:, :L], axis=1)))
        table = torch.as_tensor(table_np, device=dev).long()
        W = weights.t5_weights(cfg["t5"], L, K, ctx.seed, dev)
        model = T5(W, cfg["t5"], L, K, Precision("f32"))
        prefixes = beam_ref.prefix_sets(table, L, K)
        k = cfg["t5"]["top_k"]
        due = min(k, int(prefixes[0].shape[0]))  # valid beams a sound search keeps
        choice_gap, logp_gap, bad, wrong = 0.0, 0.0, 0, 0
        for i in range(0, len(hists), BLOCK):
            sl = slice(i, i + BLOCK)
            tok, mask = _tokens(table, hists[sl], L, ctx.traffic["max_items"], dev)
            x, m = model.embed_history(tok, mask)
            enc = model.encoder(x, m)
            got = torch.as_tensor(served["sem_ids"][sl], device=dev).long()
            got_lp = torch.as_tensor(served["log_probas"][sl], device=dev).double()
            valid = got_lp > VALID
            levels = beam_ref.level_log_probs(model, enc, m, got.clamp(min=0))
            choice_gap = max(choice_gap, float(beam_ref.choice_gap(levels, got.clamp(min=0), valid, prefixes, k).max()))
            bad += _bad_tuples(table, got.clamp(min=0), valid, K, due)
            scored = beam_ref.tuple_log_probs(levels, got.clamp(min=0)).double()
            if valid.any():
                logp_gap = max(logp_gap, float((got_lp - scored).abs()[valid].max()))
            want = torch.where(valid, beam_ref.inverse_lookup(table, got.clamp(min=0), K), -1)
            wrong += int((want.cpu() != torch.as_tensor(served["item_ids"][sl]).long()).sum())
    return {"index_ids_differ": differ, "beam_choice_gap": choice_gap, "beam_tuple_bad": float(bad),
            "beam_logp_gap": logp_gap, "item_lookup_wrong": float(wrong)}


def controls(ctx, table: np.ndarray, hists: Sequence[np.ndarray]) -> Dict[str, Dict[str, float]]:
    """The control's numbers: the reference at fp8 in the program's place
    (its own fp8 index judged) over the same requests and served index."""
    answers = reference_answers(ctx, table, hists, "fp8")
    return {"control_fp8": compare(ctx, table, hists, answers, index_precision="fp8")}
