"""Synthetic dataset generator: hierarchically-clustered item embeddings and
cluster-correlated user sequences.

The port's own copy of rqvae_tpu/data/synthetic.py (numpy only): the same
seed gives the same arrays. It writes the on-disk layout the dataset views
read, so every training and evaluation path runs without downloaded data.

Structure: items are drawn from a 3-level hierarchy of Gaussian clusters
(so an RQ-VAE with 3 codebook levels can compress them well), and each
user's sequence follows a Markov chain over top-level clusters with
preference persistence (so next-item prediction is learnable).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class SyntheticConfig:
    n_items: int = 2000
    n_users: int = 500
    input_dim: int = 64
    n_cat_feats: int = 0
    # hierarchy geometry
    n_top: int = 8
    n_mid: int = 4  # children per top cluster
    n_leaf: int = 4  # children per mid cluster
    scale_top: float = 4.0
    scale_mid: float = 1.0
    scale_leaf: float = 0.25
    noise: float = 0.05
    # L2-normalize item features (sentence-T5 embeddings, which the real
    # pipelines produce, are unit-norm; leaving features at raw hierarchy
    # scale makes reconstruction gradients swamp the commitment term)
    normalize_features: bool = True
    # sequences
    min_seq_len: int = 8
    max_seq_len: int = 20
    stay_prob: float = 0.8  # probability of staying in the same top cluster
    seed: int = 0
    eval_item_frac: float = 0.05  # 5% item holdout


def generate(cfg: SyntheticConfig = SyntheticConfig()) -> dict:
    """Returns dict of numpy arrays in the framework's on-disk layout:

    - item_features  [N, input_dim(+n_cat_feats)] float32
    - item_is_train  [N] bool (95/5 split)
    - seq_items      [U, max_len+2] int64, -1 padded RIGHT; full history
    - seq_lengths    [U] int64 (true lengths, >= min_seq_len)
    - user_ids       [U] int64

    The +2 is the leave-two-out protocol: the last two items are the eval
    and test targets.
    """
    rng = np.random.RandomState(cfg.seed)

    # --- items: 3-level Gaussian hierarchy ---
    top = rng.randn(cfg.n_top, cfg.input_dim) * cfg.scale_top
    mid = top[:, None, :] + rng.randn(cfg.n_top, cfg.n_mid, cfg.input_dim) * cfg.scale_mid
    leaf = (
        mid[:, :, None, :]
        + rng.randn(cfg.n_top, cfg.n_mid, cfg.n_leaf, cfg.input_dim) * cfg.scale_leaf
    )
    leaves = leaf.reshape(-1, cfg.input_dim)
    leaf_idx = rng.randint(0, leaves.shape[0], cfg.n_items)
    item_features = (leaves[leaf_idx] + rng.randn(cfg.n_items, cfg.input_dim) * cfg.noise).astype(
        np.float32
    )
    if cfg.normalize_features:
        item_features /= np.maximum(
            np.linalg.norm(item_features, axis=1, keepdims=True), 1e-6
        )
    item_top_cluster = leaf_idx // (cfg.n_mid * cfg.n_leaf)

    if cfg.n_cat_feats > 0:
        cat = (rng.rand(cfg.n_items, cfg.n_cat_feats) < 0.3).astype(np.float32)
        item_features = np.concatenate([item_features, cat], axis=1)

    item_is_train = rng.rand(cfg.n_items) > cfg.eval_item_frac

    # --- sequences: markov over top clusters ---
    items_by_top = [np.where(item_top_cluster == t)[0] for t in range(cfg.n_top)]
    total_len = cfg.max_seq_len + 2
    seq_items = np.full((cfg.n_users, total_len), -1, dtype=np.int64)
    seq_lengths = np.zeros(cfg.n_users, dtype=np.int64)
    for u in range(cfg.n_users):
        L = rng.randint(cfg.min_seq_len, total_len + 1)
        t = rng.randint(cfg.n_top)
        for j in range(L):
            if rng.rand() > cfg.stay_prob:
                t = rng.randint(cfg.n_top)
            pool = items_by_top[t]
            if len(pool) == 0:
                pool = np.arange(cfg.n_items)
            seq_items[u, j] = pool[rng.randint(len(pool))]
        seq_lengths[u] = L

    return {
        "item_features": item_features,
        "item_is_train": item_is_train,
        "seq_items": seq_items,
        "seq_lengths": seq_lengths,
        "user_ids": np.arange(cfg.n_users, dtype=np.int64),
        "max_seq_len": np.int64(cfg.max_seq_len),
    }


def save(path: str, data: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **data)


def generate_and_save(root: str, cfg: SyntheticConfig = SyntheticConfig()) -> str:
    path = os.path.join(root, "processed", "data.npz")
    save(path, {**generate(cfg), "dataset_name": np.asarray("synthetic")})
    return path


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description="Generate a synthetic dataset")
    ap.add_argument("root")
    ap.add_argument("--n-items", type=int, default=2000)
    ap.add_argument("--n-users", type=int, default=500)
    ap.add_argument("--input-dim", type=int, default=64)
    ap.add_argument("--n-cat-feats", type=int, default=0)
    ap.add_argument("--max-seq-len", type=int, default=20)
    ap.add_argument("--n-top", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    cfg = SyntheticConfig(
        n_items=args.n_items,
        n_users=args.n_users,
        input_dim=args.input_dim,
        n_cat_feats=args.n_cat_feats,
        max_seq_len=args.max_seq_len,
        n_top=args.n_top,
        seed=args.seed,
    )
    print(generate_and_save(args.root, cfg))


if __name__ == "__main__":
    main()
