"""Device meshes and row splits (port of rqvae_tpu/parallel/mesh.py).

The JAX package builds a `jax.sharding.Mesh` with ('data', 'model') axes and
lets GSPMD insert the collectives. Here a `Mesh` is a [n_data, n_model] grid
of torch devices; code that runs on it splits a batch's rows over the 'data'
axis itself (`shard_rows`), runs each shard on its device with the state
replicated there (`replicate`), and concatenates. Within one process that
needs no collective: the sharded index build and sharded generate are row
independent, as their shard_maps are. Across processes (data-parallel
training, parallel/dist.py) each rank takes its rows with `local_rows`, and
its slice of a step's globally drawn randomness with `rank_slice`.

A mesh may name one device more than once (['cuda:0', 'cuda:0'], ['cpu',
'cpu']): the shards then run one after another on it, with one replica.
Tensor parallelism ('model' > 1) is not ported (ROADMAP, `parallel/tp.py`).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, TypeVar

import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"

T = TypeVar("T")


@dataclass(frozen=True)
class Mesh:
    """A [n_data, n_model] grid of devices, axes ('data', 'model')."""

    devices: Tuple[Tuple[torch.device, ...], ...]
    axis_names: Tuple[str, str] = (DATA_AXIS, MODEL_AXIS)

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: len(self.devices), MODEL_AXIS: len(self.devices[0])}

    @property
    def data_devices(self) -> List[torch.device]:
        """The device of each 'data' shard, in shard order."""
        return [row[0] for row in self.devices]


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, devices: Optional[Sequence] = None) -> Mesh:
    """A ('data', 'model') mesh over `devices` (default: every card), all on
    the data axis by default, as the JAX package's."""
    if n_model != 1:
        raise NotImplementedError(
            f"n_model={n_model}: tensor parallelism (rqvae_tpu/parallel/tp.py) is not ported; "
            "it is ROADMAP queue 1's `parallel/tp.py` item")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for the default mesh; pass devices, e.g. ['cpu', 'cpu']")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    devices = [torch.device("cuda", torch.cuda.current_device()) if d.type == "cuda" and d.index is None else d
               for d in devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    if n_data is None:
        n_data = len(devices) // n_model
    if n_data * n_model != len(devices):
        raise ValueError(f"{n_data} x {n_model} mesh over {len(devices)} devices")
    return Mesh(tuple(tuple(devices[i * n_model:(i + 1) * n_model]) for i in range(n_data)))


def shard_sizes(n: int, n_shards: int) -> List[int]:
    """Rows of each shard when n rows are split over n_shards: ceil(n /
    n_shards) each, the last ones shorter (or empty), in row order, as a
    'data'-sharded array of n rows padded to a multiple splits."""
    size = -(-n // n_shards) if n else 0
    return [max(0, min(size, n - i * size)) for i in range(n_shards)]


def shard_rows(mesh: Mesh, x: torch.Tensor, axis: int = 0) -> List[torch.Tensor]:
    """x's rows (along `axis`) split over the mesh's 'data' shards
    (shard_sizes), each piece moved to its shard's device: the counterpart of
    device_put with `batch_sharding(mesh, axis)`."""
    pieces = torch.split(x, shard_sizes(x.shape[axis], mesh.shape[DATA_AXIS]), dim=axis)
    return [p.to(d) for p, d in zip(pieces, mesh.data_devices)]


def replicate(obj: T, devices: Sequence[torch.device]) -> Dict[torch.device, T]:
    """A module or tensor on each distinct device: the object itself where
    it already lies, a copy elsewhere (the counterpart of
    `replicate_pytree`)."""
    out: Dict[torch.device, T] = {}
    for d in dict.fromkeys(torch.device(d) for d in devices):
        if isinstance(obj, torch.nn.Module):
            here = next(iter(obj.parameters())).device
            out[d] = obj if here == d else copy.deepcopy(obj).to(d)
        elif isinstance(obj, torch.Tensor):
            out[d] = obj.to(d)
        else:
            raise TypeError(f"replicate takes a module or a tensor, got {type(obj).__name__}")
    return out


def local_rows(global_rows: int, rank: int, world: int) -> slice:
    """The rows of a global batch that data-parallel rank `rank` of `world`
    holds: contiguous, rank-ordered, equal (the counterpart of
    `global_batch_from_process_local`). A batch the world does not divide
    raises: the step's mean over ranks equals the mean over rows only for
    equal shards."""
    if world < 1 or not 0 <= rank < world:
        raise ValueError(f"rank {rank} of a world of {world}")
    if global_rows % world:
        raise ValueError(f"a batch of {global_rows} rows does not divide over {world} ranks")
    n = global_rows // world
    return slice(rank * n, (rank + 1) * n)


def rank_slice(draws: Mapping[str, torch.Tensor], replicas, axes: Mapping[str, int]) -> Dict[str, torch.Tensor]:
    """A step's global draws as a data-parallel rank keeps them: each draw
    named in `axes` that `draws` holds cut to the rank's `local_rows` along
    that dimension, every other draw whole. `replicas` (parallel/dist.py::
    Replicas, or None for a process alone, which keeps everything) gives
    the rank and the world."""
    if replicas is None:
        return dict(draws)
    out = dict(draws)
    for k, dim in axes.items():
        if k in out:
            rows = local_rows(out[k].shape[dim], replicas.rank, replicas.world)
            out[k] = out[k][(slice(None),) * dim + (rows,)]
    return out
