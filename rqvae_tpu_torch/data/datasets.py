"""Dataset views over the on-disk npz layout (the port's own copy of
rqvae_tpu/data/datasets.py; numpy only).

- ItemDataset: per-item content features with the seeded 95/5 train/eval
  item split.
- SeqDataset: user histories under the leave-two-out protocol, with
  train-time random contiguous-window subsampling.

All sampling is vectorized numpy producing fixed-shape padded batches
(pad id = -1); the batches hold numpy arrays, which the tokenizer moves to
its device. The stored
`seq_items` rows are full histories; the last two positions are the eval
and test targets:
  train       items[:L-2]  (+ items[L-2] appended for subsampling)
  eval   hist items[:L-2],  target items[L-2]
  test   hist items[:L-1],  target items[L-1]
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from rqvae_tpu_torch.data.schemas import SeqBatch


def load_processed(root: str) -> dict:
    """Load {root}/processed/data.npz (written by synthetic.py or the real
    preprocessing pipelines)."""
    path = os.path.join(root, "processed", "data.npz")
    with np.load(path, allow_pickle=False) as f:
        return {k: f[k] for k in f.files}


class ItemDataset:
    """Per-item feature rows, filterable by the item-level train/eval split."""

    def __init__(self, data: dict, split: str = "all", max_feat_dim: Optional[int] = None):
        feats = data["item_features"]
        # the pipeline declares its feature width ("feature_dim", defaulting
        # to the full row), so trailing categorical columns are kept
        if max_feat_dim is None:
            max_feat_dim = int(data.get("feature_dim", feats.shape[1]))
        if feats.shape[1] > max_feat_dim:
            feats = feats[:, :max_feat_dim]
        is_train = data["item_is_train"].astype(bool)
        if split == "train":
            filt = is_train
        elif split == "eval":
            filt = ~is_train
        elif split == "all":
            filt = np.ones(feats.shape[0], dtype=bool)
        else:
            raise ValueError(f"Unknown split: {split}")
        self.features = feats[filt].astype(np.float32)
        # original corpus indices of the filtered rows
        self.corpus_ids = np.nonzero(filt)[0].astype(np.int64)

    def __len__(self) -> int:
        return self.features.shape[0]

    def sample_batch(self, rng: np.random.RandomState, batch_size: int) -> np.ndarray:
        idx = rng.randint(0, len(self), batch_size)
        return self.features[idx]

    def head(self, n: int) -> np.ndarray:
        return self.features[: min(n, len(self))]


class SeqDataset:
    """User interaction sequences with fixed-shape batch sampling.

    Two on-disk formats (marker key `seq_format`):
    - "leave_two_out" (default; Amazon / synthetic): each row
      is a user's FULL history; items[L-2] is the eval target, items[L-1]
      the test target.
    - "windows" (MovieLens): each row is one sliding window with an
      `seq_is_train` flag from the timestamp-quantile split; eval/test rows
      use their last item as the target.
    """

    def __init__(self, data: dict, split: str = "train", subsample: bool = False):
        assert (not subsample) or split == "train", "Can only subsample the training split."
        self.split = split
        self.subsample = subsample
        self.format = str(data.get("seq_format", "leave_two_out"))
        seq_items = data["seq_items"].astype(np.int64)  # [R, T] -1 padded
        seq_lengths = data["seq_lengths"].astype(np.int64)  # [R]
        user_ids = data["user_ids"].astype(np.int64)
        if self.format == "windows":
            is_train = data["seq_is_train"].astype(bool)
            filt = is_train if split == "train" else ~is_train
            seq_items, seq_lengths, user_ids = seq_items[filt], seq_lengths[filt], user_ids[filt]
        self.seq_items = seq_items
        self.seq_lengths = seq_lengths
        self.user_ids = user_ids
        self.features = data["item_features"].astype(np.float32)
        feat_dim = int(data.get("feature_dim", self.features.shape[1]))
        if self.features.shape[1] > feat_dim:
            self.features = self.features[:, :feat_dim]
        self.max_seq_len = int(data["max_seq_len"])

    def __len__(self) -> int:
        return self.seq_items.shape[0]

    @property
    def n_items(self) -> int:
        return self.features.shape[0]

    def _gather_features(self, ids: np.ndarray) -> np.ndarray:
        x = self.features[np.clip(ids, 0, None)]
        x[ids < 0] = -1.0
        return x

    def _window(self, batch_idx: np.ndarray, hist_end: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Last `max_seq_len` items before position hist_end (exclusive),
        left-aligned and right-padded with -1, plus the target at hist_end."""
        ml = self.max_seq_len
        starts = np.maximum(0, hist_end - ml)
        n = hist_end - starts  # [B] window lengths
        grid = starts[:, None] + np.arange(ml)[None, :]
        ids = self.seq_items[batch_idx[:, None], np.minimum(grid, self.seq_items.shape[1] - 1)]
        mask = np.arange(ml)[None, :] < n[:, None]
        ids = np.where(mask, ids, -1)
        fut = self.seq_items[batch_idx, hist_end]
        return ids, fut

    def _subsample_window(
        self, rng: np.random.RandomState, batch_idx: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Random contiguous window: over
        seq = items[:L-1] (train items + the eval target), pick
        start ~ U[0, M-3], end ~ U[start+3, start+max_len+1], clamp to M;
        history = window[:-1], target = window[-1]."""
        ml = self.max_seq_len
        if self.format == "windows":
            M = self.seq_lengths[batch_idx].astype(np.int64)  # whole window usable
        else:
            M = (self.seq_lengths[batch_idx] - 1).astype(np.int64)  # len(items[:L-1])
        M = np.maximum(M, 1)
        # python random.randint is inclusive on both ends
        starts = rng.randint(0, np.maximum(1, M - 2))  # [0, M-3] inclusive
        ends = np.minimum(starts + 3 + rng.randint(0, ml - 1), M)  # [start+3, start+ml+1] clamped
        n = ends - starts  # window length; >= 1 always, >= 3 when M >= 3
        grid = starts[:, None] + np.arange(ml)[None, :]
        ids = self.seq_items[batch_idx[:, None], np.minimum(grid, self.seq_items.shape[1] - 1)]
        mask = np.arange(ml)[None, :] < (n - 1)[:, None]
        hist = np.where(mask, ids, -1)
        fut = self.seq_items[batch_idx, starts + n - 1]
        return hist, fut

    def batch(
        self,
        batch_idx: np.ndarray,
        rng: Optional[np.random.RandomState] = None,
        with_features: bool = True,
    ) -> SeqBatch:
        batch_idx = np.asarray(batch_idx)
        L = self.seq_lengths[batch_idx]
        if self.subsample:
            assert rng is not None
            ids, fut = self._subsample_window(rng, batch_idx)
        elif self.format == "windows":
            # window rows: last item is the target for every split. Clamp
            # hist_end to >= 0, NOT >= 1: a length-1 window must yield
            # (empty history, fut = its only item) — clamping to 1 indexed
            # one past the row's items, silently training on the -1
            # padding's item-0 semantic ids
            ids, fut = self._window(batch_idx, np.maximum(L - 1, 0))
        elif self.split in ("train", "eval"):
            ids, fut = self._window(batch_idx, np.maximum(L - 2, 0))
        else:  # test
            ids, fut = self._window(batch_idx, np.maximum(L - 1, 0))

        if with_features:
            x = self._gather_features(ids)
            x_fut = self._gather_features(fut)
        else:
            x = np.zeros((len(batch_idx), 0, 0), np.float32)
            x_fut = np.zeros((len(batch_idx), 0), np.float32)

        return SeqBatch(
            user_ids=self.user_ids[batch_idx],
            ids=ids,
            ids_fut=fut,
            x=x,
            x_fut=x_fut,
            seq_mask=ids >= 0,
        )

    def sample_batch(
        self, rng: np.random.RandomState, batch_size: int, with_features: bool = True
    ) -> SeqBatch:
        idx = rng.randint(0, len(self), batch_size)
        return self.batch(idx, rng, with_features)

    def iter_eval_batches(self, batch_size: int, with_features: bool = True, pad_final: bool = True):
        """Sequential full pass. With pad_final the last short batch is
        padded by repeating row 0 with a validity count so shapes stay
        static (consumers must slice [:valid] BEFORE any mean — a padded
        batch mean times `valid` is biased toward row 0); with
        pad_final=False the final batch is yielded at its exact size (one
        batch of another shape, exact means)."""
        n = len(self)
        for s in range(0, n, batch_size):
            idx = np.arange(s, min(s + batch_size, n))
            valid = len(idx)
            if pad_final and valid < batch_size:
                idx = np.concatenate([idx, np.zeros(batch_size - valid, np.int64)])
            yield self.batch(idx, None, with_features), valid
