"""Random weights and item features, made on the device from the seed in a
few large calls, under the parameter names of the measured package's
modules so that one state dict loads into the program and feeds the
reference.

T5 (HF's init, factor 1): embeddings N(0, 1); q N(0, (d * d_kv)^-1/2), k and
v N(0, d^-1/2), o N(0, (H * d_kv)^-1/2), wi N(0, d^-1/2), wo N(0, d_ff^-1/2),
the relative bias N(0, d^-1/2), RMSNorm scales 1, heads U(+-d^-1/2). RQ-VAE:
Linear layers U(+-fan_in^-1/2); each level's codebook is the residual that
level sees of K distinct items drawn from the seed (the start that k-means
initialisation gives a trained tokenizer), so the tuples spread over the
catalog as a trained index's do.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from perfbench.reference.precision import exact_float32


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A torch generator on `device` for one stream of the run's seed."""
    state = np.random.SeedSequence([int(seed) & (2**64 - 1), stream]).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed((int(state[0]) << 32) | int(state[1]))


def t5_layout(t5: dict, L: int, K: int) -> List[Tuple[str, tuple, str, float]]:
    """(name, shape, kind, scale) of every retrieval-model parameter, in the
    measured model's order."""
    d, H, dk, dff, NL = t5["d_model"], t5["num_heads"], t5["d_kv"], t5["d_ff"], t5["num_layers"]
    inner = H * dk
    out = [("sid_embedding", (L * K, d), "normal", 1.0), ("bos_token", (1, d), "normal", 1.0),
           ("sep_token", (1, d), "normal", 1.0), ("heads", (L, d, K), "uniform", d ** -0.5)]

    def attn(pre, bias):
        rows = [(pre + "rel_bias", (t5["rel_buckets"], H), "normal", d ** -0.5)] if bias else []
        return rows + [(pre + "q.weight", (inner, d), "normal", (d * dk) ** -0.5),
                       (pre + "k.weight", (inner, d), "normal", d ** -0.5),
                       (pre + "v.weight", (inner, d), "normal", d ** -0.5),
                       (pre + "o.weight", (d, inner), "normal", inner ** -0.5)]

    for stack in ("encoder", "decoder"):
        for i in range(NL):
            pre = f"{stack}.block.{i}."
            out.append((pre + "ln_self.weight", (d,), "ones", 1.0))
            out += attn(pre + "self_attn.", i == 0)
            if stack == "decoder":
                out.append((pre + "ln_cross.weight", (d,), "ones", 1.0))
                out += attn(pre + "cross_attn.", False)
            out += [(pre + "ln_ffn.weight", (d,), "ones", 1.0),
                    (pre + "ffn.wi.weight", (dff, d), "normal", d ** -0.5),
                    (pre + "ffn.wo.weight", (d, dff), "normal", dff ** -0.5)]
        out.append((f"{stack}.ln_final.weight", (d,), "ones", 1.0))
    return out


def _fill(layout, g: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """One normal and one uniform draw for all the leaves, cut and scaled."""
    sizes = {kind: sum(int(np.prod(s)) for _, s, k, _ in layout if k == kind) for kind in ("normal", "uniform")}
    pools = {"normal": torch.randn(sizes["normal"], generator=g, device=device),
             "uniform": torch.rand(sizes["uniform"], generator=g, device=device) * 2.0 - 1.0}
    used = {"normal": 0, "uniform": 0}
    out = {}
    for name, shape, kind, scale in layout:
        n = int(np.prod(shape))
        if kind == "ones":
            out[name] = torch.ones(shape, device=device)
            continue
        out[name] = pools[kind][used[kind]:used[kind] + n].reshape(shape) * scale
        used[kind] += n
    return out


def t5_weights(t5: dict, L: int, K: int, seed: int, device) -> Dict[str, torch.Tensor]:
    return _fill(t5_layout(t5, L, K), generator(seed, 1, device), device)


def item_features(rq: dict, n_items: int, seed: int, device) -> torch.Tensor:
    """[N, input_dim]: unit-norm dense embeddings, then `n_cat_feats`
    multi-hot categories (each with probability 0.1, at least one)."""
    g = generator(seed, 2, device)
    n_cat = rq["n_cat_feats"]
    dense = torch.randn((n_items, rq["input_dim"] - n_cat), generator=g, device=device)
    dense = dense / dense.norm(dim=1, keepdim=True)
    if not n_cat:
        return dense
    cats = (torch.rand((n_items, n_cat), generator=g, device=device) < 0.1).float()
    first = torch.randint(0, n_cat, (n_items,), generator=g, device=device)
    cats[torch.arange(n_items, device=device), first] = 1.0
    return torch.cat([dense, cats], dim=1)


@torch.no_grad()
def rqvae_weights(rq: dict, features: torch.Tensor, seed: int) -> Dict[str, torch.Tensor]:
    """The encoder, decoder and codebooks, float32 on the features' device."""
    dev = features.device
    g = generator(seed, 3, dev)
    dims = [rq["input_dim"], *rq["hidden_dims"], rq["embed_dim"]]
    shapes = [(f"encoder.layers.{i}.weight", (b, a)) for i, (a, b) in enumerate(zip(dims[:-1], dims[1:]))]
    rdims = dims[::-1]
    shapes += [(f"decoder.layers.{i}.weight", (b, a)) for i, (a, b) in enumerate(zip(rdims[:-1], rdims[1:]))]
    pool = torch.rand(sum(a * b for _, (a, b) in shapes), generator=g, device=dev) * 2.0 - 1.0
    out, used = {}, 0
    for name, (o, i) in shapes:
        out[name] = pool[used:used + o * i].reshape(o, i) * i ** -0.5
        used += o * i
    with exact_float32():
        return _with_codebooks(rq, features, out, g)


def _with_codebooks(rq: dict, features: torch.Tensor, out: dict, g: torch.Generator) -> dict:
    dev = features.device
    dims = [rq["input_dim"], *rq["hidden_dims"], rq["embed_dim"]]
    h = features.float()
    n_enc = len(dims) - 1
    for i in range(n_enc):
        h = h @ out[f"encoder.layers.{i}.weight"].t()
        if i != n_enc - 1:
            h = torch.relu(h)
    K, levels = rq["codebook_size"], rq["n_layers"]
    picks = torch.randperm(features.shape[0], generator=g, device=dev)[: K * levels].reshape(levels, K)
    books, res = [], h
    for level in range(levels):
        cb = res[picks[level]].clone()
        books.append(cb)
        dist = (res * res).sum(-1, keepdim=True) + (cb * cb).sum(-1)[None] - 2.0 * res @ cb.t()
        res = res - cb[dist.argmin(-1)]
    out["codebooks"] = torch.stack(books)
    return out
