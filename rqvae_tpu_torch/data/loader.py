"""Host-side batch iteration and device placement (port of
rqvae_tpu/data/loader.py).

Batches are numpy arrays or (nested) tuples, NamedTuples, lists and dicts of
them. `to_device` takes a device where the JAX function takes a sharding: a
data-parallel rank places its own rows (parallel/mesh.py::local_rows) on its
own device.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from rqvae_tpu_torch.utils.device import DeviceLike, resolve_device


def infinite_batches(dataset, batch_size: int, seed: int = 0, **kw) -> Iterator:
    """Infinite stream of randomly sampled batches (the reference's cycle())."""
    rng = np.random.RandomState(seed)
    while True:
        yield dataset.sample_batch(rng, batch_size, **kw)


def to_device(batch, device: DeviceLike = None):
    """Every array leaf of `batch` as a tensor on `device` (None: the card)."""
    dev = resolve_device(device)

    def put(a):
        if a is None:
            return None
        if isinstance(a, (tuple, list)) and not hasattr(a, "_fields"):
            return type(a)(put(x) for x in a)
        if hasattr(a, "_fields"):  # NamedTuple
            return type(a)(*(put(x) for x in a))
        if isinstance(a, dict):
            return {k: put(v) for k, v in a.items()}
        return torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor) else a, device=dev)

    return put(batch)
