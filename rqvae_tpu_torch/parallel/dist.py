"""Process setup and collectives of data-parallel runs (port of
rqvae_tpu/parallel/dist.py).

One process per rank under torch.distributed. `initialize_distributed` reads
the launch markers:

- the JAX package's manual markers: `RQVAE_TPU_NUM_PROCESSES` and
  `RQVAE_TPU_PROCESS_ID` name the world and this process's slot, and
  `JAX_COORDINATOR_ADDRESS` or `COORDINATOR_ADDRESS` (`host:port`) the TCP
  store that rank 0 serves;
- torchrun's markers, which stand where the JAX module reads TPU pod
  markers: `WORLD_SIZE`, `RANK`, `LOCAL_RANK` (and `LOCAL_WORLD_SIZE`),
  `MASTER_ADDR` and `MASTER_PORT`;
- `RQVAE_TPU_DISTRIBUTED`: "0" never initialises, "1" initialises (and
  raises when no marker names the world); any other value raises, as a typo
  would otherwise fall through to auto-detection.

Without a marker the process runs alone, with no process group: the entry
points run as they did before this module existed.

A rank's card is `cuda:(local_rank % device_count())`. The backend is chosen
once, from what the process can observe, and printed on the main process:
NCCL when the ranks of a host hold distinct cards; gloo on the CPU; gloo
when ranks share a card (NCCL refuses two ranks on one GPU). A failed
initialisation raises; it never retries with another backend.

Collectives go through `Replicas`, the group a step runs in, on the tensors
as they are. Under NCCL a CUDA graph of a step captures them. gloo takes
CUDA tensors for every collective a step uses (all_reduce, all_gather,
broadcast: checked on the card with torch 2.11), but moves them through the
host, so a step under gloo on the card runs eagerly (`capturable`).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from datetime import timedelta
from typing import Collection, Dict, List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as tdist

from rqvae_tpu_torch.utils.device import DeviceLike

TIMEOUT = timedelta(minutes=10)  # a rank that waits longer than this for its peers raises


class Launch(NamedTuple):
    """What the launch markers say about this process."""

    world: int
    rank: int
    local_rank: int
    local_world: int  # ranks on this host
    address: str  # host:port of the TCP store


def _int_env(name: str) -> Optional[int]:
    v = os.environ.get(name)
    if v is None or v == "":
        return None
    try:
        return int(v)
    except ValueError:
        raise ValueError(f"{name}={v!r} is not an integer") from None


def launch_from_env() -> Optional[Launch]:
    """The launch the environment describes, or None for a process alone."""
    force = os.environ.get("RQVAE_TPU_DISTRIBUTED")
    if force not in (None, "", "0", "1"):
        raise ValueError(
            f"RQVAE_TPU_DISTRIBUTED={force!r}: must be '0' or '1' "
            "(typos would otherwise silently fall through to auto-detection)"
        )
    coord = os.environ.get("JAX_COORDINATOR_ADDRESS") or os.environ.get("COORDINATOR_ADDRESS")
    nproc = _int_env("RQVAE_TPU_NUM_PROCESSES")
    world = _int_env("WORLD_SIZE")
    markers = coord or nproc is not None or world is not None
    if force == "0" or not (force == "1" or markers):
        return None
    if nproc is not None:  # the manual launch: every process on one host
        if not coord:
            raise ValueError("RQVAE_TPU_NUM_PROCESSES is set but no JAX_COORDINATOR_ADDRESS/"
                             "COORDINATOR_ADDRESS names the coordinator")
        pid = _int_env("RQVAE_TPU_PROCESS_ID")
        if pid is None:
            raise ValueError("RQVAE_TPU_NUM_PROCESSES is set but RQVAE_TPU_PROCESS_ID is not; "
                             "each process must name its slot (0..N-1)")
        local = _int_env("LOCAL_RANK")
        return _checked(Launch(nproc, pid, pid if local is None else local, nproc, coord))
    if world is not None:  # torchrun
        rank = _int_env("RANK")
        addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
        if rank is None or not addr or not port:
            raise ValueError("WORLD_SIZE is set but RANK, MASTER_ADDR or MASTER_PORT is not")
        local = _int_env("LOCAL_RANK")
        local_world = _int_env("LOCAL_WORLD_SIZE")
        return _checked(Launch(world, rank, rank if local is None else local,
                               world if local_world is None else local_world, f"{addr}:{port}"))
    raise ValueError("a distributed launch needs RQVAE_TPU_NUM_PROCESSES (with RQVAE_TPU_PROCESS_ID and "
                     "JAX_COORDINATOR_ADDRESS) or torchrun's WORLD_SIZE, RANK, MASTER_ADDR, MASTER_PORT")


def _checked(launch: Launch) -> Launch:
    if launch.world < 1 or not 0 <= launch.rank < launch.world:
        raise ValueError(f"rank {launch.rank} of a world of {launch.world}")
    if ":" not in launch.address:
        raise ValueError(f"coordinator address {launch.address!r} is not host:port")
    return launch


def rank_device(device: DeviceLike, launch: Optional[Launch]) -> torch.device:
    """The device a rank runs on: the CPU when asked for, else the card
    cuda:(local_rank % device_count()) (the current card without a launch)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or launch is None:
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return torch.device("cuda", launch.local_rank % torch.cuda.device_count())


def choose_backend(dev: torch.device, launch: Launch) -> str:
    """NCCL when the host's ranks hold distinct cards, else gloo."""
    if dev.type != "cuda":
        return "gloo"
    return "nccl" if launch.local_world <= torch.cuda.device_count() else "gloo"


def initialize_distributed(device: DeviceLike = None) -> Optional[str]:
    """Join the process group the launch markers describe (no-op for a
    process alone; safe to call more than once). `device` is the entry
    point's (None: the card): it decides the backend and, on the card, the
    rank's card becomes the current device. Returns the backend, or None
    without a group."""
    if tdist.is_available() and tdist.is_initialized():
        return tdist.get_backend()
    launch = launch_from_env()
    if launch is None:
        return None
    dev = rank_device(device, launch)
    backend = choose_backend(dev, launch)
    kw = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        if backend == "nccl":
            kw["device_id"] = dev  # the communicator is made now, before any capture
    tdist.init_process_group(backend, init_method=f"tcp://{launch.address}", world_size=launch.world,
                             rank=launch.rank, timeout=TIMEOUT, **kw)
    # one eager collective: every rank is there, and NCCL's communicator exists
    probe = torch.ones(1, device=dev if backend == "nccl" else "cpu")
    tdist.all_reduce(probe)
    if int(probe.item()) != launch.world:
        raise RuntimeError(f"the first all-reduce over {launch.world} ranks gave {probe.item()}")
    if launch.rank == 0:
        print(f"[dist] backend {backend}: {launch.world} ranks, this one on {dev}", flush=True)
    return backend


def is_main_process() -> bool:
    return process_index() == 0


def process_index() -> int:
    return tdist.get_rank() if tdist.is_available() and tdist.is_initialized() else 0


def process_count() -> int:
    return tdist.get_world_size() if tdist.is_available() and tdist.is_initialized() else 1


def barrier() -> None:
    """Wait for every rank (no-op for a process alone)."""
    if process_count() > 1:
        tdist.barrier()


@dataclass(frozen=True)
class Replicas:
    """The data-parallel group a step runs in: this process is `rank` of
    `world`, over `backend`. Every rank holds the same state and its own
    contiguous slice of the batch."""

    rank: int
    world: int
    backend: str

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph can hold this group's collectives (NCCL)."""
        return self.backend == "nccl"

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """t <- the sum of every rank's t, in place."""
        tdist.all_reduce(t)
        return t

    def mean_(self, t: torch.Tensor) -> torch.Tensor:
        """t <- the mean of every rank's t, in place (the sum, then / world)."""
        return self.all_reduce_(t).div_(self.world)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's t, concatenated along dim 0 in rank order."""
        src = t.contiguous()
        parts = [torch.empty_like(src) for _ in range(self.world)]
        tdist.all_gather(parts, src)
        return torch.cat(parts)

    def average_step_(self, params: Sequence[torch.nn.Parameter], metrics: Dict[str, torch.Tensor],
                      exact: Collection[str] = ()) -> Dict[str, torch.Tensor]:
        """A data-parallel step's reduction, before the optimizer clips and
        updates: every parameter's gradient (zeros where there is none) and
        every metric not in `exact` go into one flat float32 buffer, which
        one all-reduce turns into its mean over the ranks; each .grad becomes
        its view of that mean. Returns the metrics, averaged but for the
        `exact` ones, which every rank computed from the gathered rows."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        names = [k for k in metrics if k not in exact]
        flat = torch.cat([g.reshape(-1).float() for g in grads] + [metrics[k].reshape(-1).float() for k in names])
        self.mean_(flat)
        at = 0
        for p, g in zip(params, grads):
            p.grad = flat[at:at + g.numel()].view(g.shape).to(g.dtype)
            at += g.numel()
        out = dict(metrics)
        for k in names:
            out[k] = flat[at:at + metrics[k].numel()].view(metrics[k].shape).to(metrics[k].dtype)
            at += metrics[k].numel()
        return out

    def check_equal(self, tensors: Sequence[torch.Tensor], what: str) -> None:
        """Raise unless every rank holds the same bits in `tensors`: two
        integer checksums of each tensor's bits, gathered and compared."""
        sums = []
        for t in tensors:
            bits = t.detach().reshape(-1)
            bits = bits.view(torch.int32) if bits.element_size() == 4 else bits.view(torch.int16)
            bits = bits.to(torch.int64)
            weight = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
            sums += [bits.sum(), (bits * weight).sum()]
        mine = torch.stack(sums)
        every = self.all_gather(mine[None]).cpu()
        if not bool((every == every[0]).all()):
            differ = sorted({i // 2 for i in torch.nonzero((every != every[0]).any(0)).flatten().tolist()})
            raise RuntimeError(f"{what}: the ranks' bits differ in tensors {differ[:10]}")

    def broadcast_(self, tensors: Sequence[torch.Tensor], src: int = 0) -> None:
        """Each tensor <- rank `src`'s, in place."""
        for t in tensors:
            tdist.broadcast(t.detach(), src)


def replicas() -> Optional[Replicas]:
    """The process group's Replicas, or None for a process alone."""
    if not (tdist.is_available() and tdist.is_initialized()):
        return None
    return Replicas(tdist.get_rank(), tdist.get_world_size(), tdist.get_backend())

