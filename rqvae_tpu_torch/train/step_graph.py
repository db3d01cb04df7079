"""Chunks of training steps, each step one replay of a CUDA graph of the whole
step: the counterpart of the JAX package's `lax.scan` over `steps_per_loop`
steps (rqvae_tpu/train/decoder_steps.py::make_decoder_scan_train_step,
rqvae_tpu/train/rqvae_steps.py::make_rqvae_scan_train_step).

A chunk of k steps works on static device buffers:

- `stage(draws)` copies the host draws of its k steps (row indices, uniforms,
  dropout seeds, step numbers: each step's randomness is drawn on the host
  from (seed, step), as the eager steps draw it) into buffers of
  [n_steps, ...] on the device, one copy per buffer, and zeroes the device
  step index and the metric sums;
- `replay(k)` runs the step body k times. The body reads its step's row of
  each buffer at the device step index, runs the whole step (forward,
  backward, optimizer update, in place), adds its metrics into the sums and
  advances the index: nothing in it reads the host or makes a tensor from
  host data, so on the card it is captured once as one CUDA graph and each
  step is one replay. On the CPU, and for a chunk of one step (the eager
  route, `steps_per_loop=1`), the same body runs eagerly through the same
  buffers;
- `means(k)` is each metric's mean over the chunk: the sum, taken in step
  order on the device, over k, as the JAX chunk returns the mean over its
  scan (`jnp.mean(m, axis=0)`).

Capture follows the serving engine's rules (serving/engine.py): one eager run
of the body on a side stream first (it builds and loads the kernels, sets
their attributes, sets up cuBLAS and allocates the gradients and sums, and
runs a data-parallel step's collectives once, so NCCL's communicator and its
buffers exist before the capture), its update undone in place from a copy
of the state kept on the host, and the blocks it freed handed back to the
card before the capture allocates its own; one graph pool; captured state
is only ever updated in place; the capture is thread-local, so another thread's CUDA calls (the NCCL watchdog's event
queries, a serving resolver's waits) do not void it. Under NCCL a
data-parallel step's all-reduce and all-gathers are nodes of the graph.
Under gloo (`capturable=False`) they wait for the host, so the steps run
eagerly on the card through the same buffers. Unreachable objects are collected first: a graph left in a dead
reference cycle (a step runner closes over itself) that Python's collector
destroyed during the capture would invalidate it. A capture or replay that
fails raises: there is no quiet eager fallback.

Spans (utils/profiling.py, the root recorder): `train.stage`, `train.replay`
over a chunk's launches, `train.capture` with `capture.eager`,
`capture.collect` and `capture.record` (capture and instantiate) inside, as
the serving engine names its captures' parts; none inside the captured step.
"""

from __future__ import annotations

import gc
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from rqvae_tpu_torch.utils import profiling
from rqvae_tpu_torch.utils.device import end_failed_capture

Draws = Dict[str, object]  # name -> host array of one step (numpy or torch)

MAX_AUTO_STEPS = 500  # the JAX trainers' cap on an automatic chunk


def steps_per_loop(requested: Optional[int], cadences: Sequence[int]) -> int:
    """Steps per chunk by the JAX trainers' rule (rqvae_tpu/train/
    train_decoder.py, train_rqvae.py): 1 when 1 is asked for; else every
    cadence (logging, evaluation, checkpoints, restarts, the run's length)
    must fall on a chunk end, so gcd(cadences), capped at gcd with 500 when
    None is asked for and otherwise taken gcd with the request."""
    if requested == 1:
        return 1
    auto = math.gcd(*[int(c) for c in cadences])
    if requested is None:
        return max(1, math.gcd(auto, MAX_AUTO_STEPS))
    return max(1, math.gcd(int(requested), auto))


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of one training step: a function of (seed, step)."""
    return torch.Generator().manual_seed((int(seed) * 1_000_003 + int(step)) % (2**63))


def stream_generator(seed: int, stream: int, step: int = 0) -> torch.Generator:
    """A CPU generator for draws other than a step's (k-means init, restarts,
    sampled-candidate evaluation): a function of (seed, stream, step), apart
    from every step's generator."""
    state = np.random.SeedSequence([int(seed) % 2**32, stream, int(step) % 2**32]).generate_state(2, np.uint32)
    return torch.Generator().manual_seed((int(state[0]) << 31) ^ int(state[1]))


def step_rows(seed: int, step: int, n_rows: int, count: int) -> np.ndarray:
    """The `count` training rows of one step, drawn from (seed, step)."""
    return np.random.RandomState([int(seed) % (2**32), int(step) % (2**32)]).randint(0, n_rows, count).astype(np.int64)


class StepChunks:
    """Runs `body(**step_draws) -> metrics` for chunks of up to `n_steps`
    steps. `specs` gives each staged buffer's per-step shape and dtype;
    `state()` lists every tensor the body updates in place (parameters,
    moments, the optimizer's count), restored after the capture's eager run.
    On a CUDA device with n_steps > 1 the steps are replays of one graph,
    unless the body's collectives are not `capturable`."""

    def __init__(self, body: Callable[..., Dict[str, torch.Tensor]],
                 specs: Dict[str, Tuple[tuple, torch.dtype]], state: Callable[[], List[torch.Tensor]],
                 device: torch.device, n_steps: int, capturable: bool = True):
        if n_steps < 1:
            raise ValueError(f"a chunk takes at least one step, got {n_steps}")
        self.body, self.state, self.device, self.n_steps = body, state, torch.device(device), int(n_steps)
        # zeros: the capture's eager run reads row 0 even before a chunk was staged
        self.staged = {name: torch.zeros((self.n_steps, *shape), dtype=dtype, device=self.device)
                       for name, (shape, dtype) in specs.items()}
        self.index = torch.zeros(1, dtype=torch.long, device=self.device)  # the step within the chunk
        self.sums: Optional[Dict[str, torch.Tensor]] = None
        self.use_graph = self.device.type == "cuda" and self.n_steps > 1 and capturable
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.pool = torch.cuda.graph_pool_handle() if self.use_graph else None
        self.replays = 0  # graph replays so far (the wrappers' counters do not tick on a replay)

    def _one_step(self) -> None:
        """The captured step: this step's row of every buffer, the body, the
        metric sums, the index advanced; all on the device."""
        draws = {name: buf.index_select(0, self.index)[0] for name, buf in self.staged.items()}
        metrics = self.body(**draws)
        if self.sums is None:  # first (eager) run: the sums' buffers
            self.sums = {k: torch.zeros_like(v) for k, v in metrics.items()}
        for k, v in metrics.items():
            self.sums[k].add_(v)
        self.index.add_(1)

    def stage(self, draws: Sequence[Draws]) -> None:
        """Copy the host draws of len(draws) <= n_steps steps to the device,
        one copy per buffer; zero the step index and the sums."""
        k = len(draws)
        if not 1 <= k <= self.n_steps:
            raise ValueError(f"a chunk of {k} steps; this one takes 1 to {self.n_steps}")
        with profiling.span("train.stage"):
            for name, buf in self.staged.items():
                host = torch.stack([torch.as_tensor(d[name]) for d in draws]).to(buf.dtype)
                if self.device.type == "cuda":
                    host = host.pin_memory()
                buf[:k].copy_(host.reshape(buf[:k].shape), non_blocking=True)
            self.index.zero_()
            if self.sums is not None:
                for v in self.sums.values():
                    v.zero_()

    def capture(self) -> None:
        """Capture the step's graph (once; `replay` captures at first use)."""
        if not self.use_graph or self.graph is not None:
            return
        with profiling.span("train.capture"):
            dev = self.device
            with profiling.span("capture.collect"):
                gc.collect()  # no graph of a dead cycle may be destroyed while this one captures
            state = self.state()
            with torch.no_grad():  # kept on the host: a large model's state would otherwise sit twice on the card
                saved = [t.detach().to("cpu", copy=True) for t in state]
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with profiling.span("capture.eager"), torch.cuda.device(dev), torch.cuda.stream(side):
                self._one_step()  # eager: kernels built and set up, grads and sums allocated
            torch.cuda.current_stream(dev).wait_stream(side)
            with torch.no_grad():
                for t, s in zip(state, saved):
                    t.copy_(s)  # the eager run's update undone
                    t.grad = None  # the eager run's gradients (the body allocates its own)
            del saved
            torch.cuda.empty_cache()  # the eager run's freed blocks go back to the card, for the graph's pool
            graph = torch.cuda.CUDAGraph(keep_graph=True)  # kept, so its nodes can be read (debug_dump)
            try:
                with profiling.span("capture.record"):
                    with torch.cuda.device(dev), torch.cuda.graph(graph, pool=self.pool, stream=side,
                                                                  capture_error_mode="thread_local"):
                        self._one_step()
                    graph.instantiate()
            except Exception as e:
                end_failed_capture(dev)
                raise RuntimeError(f"CUDA graph capture of the training step failed: {e}") from e
            self.graph = graph

    def replay(self, k: int) -> None:
        """Run k staged steps: k replays of the graph, or k eager bodies."""
        if not 1 <= k <= self.n_steps:
            raise ValueError(f"{k} steps of a chunk of at most {self.n_steps}")
        if not self.use_graph:
            with profiling.span("train.replay"):
                for _ in range(k):
                    self._one_step()
            return
        if self.graph is None:
            self.capture()
            self.index.zero_()
            for v in self.sums.values():
                v.zero_()
        with profiling.span("train.replay"), torch.cuda.device(self.device):
            for _ in range(k):
                self.graph.replay()
        self.replays += k

    def means(self, k: int) -> Dict[str, torch.Tensor]:
        """Each metric's mean over the chunk's k steps (device tensors)."""
        return {name: v / k for name, v in self.sums.items()}

    def run(self, draws: Sequence[Draws]) -> Dict[str, torch.Tensor]:
        """stage, replay, means: one chunk."""
        self.stage(draws)
        self.replay(len(draws))
        return self.means(len(draws))
