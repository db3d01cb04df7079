"""Tensor parallelism of the retrieval model (port of rqvae_tpu/parallel/tp.py).

The JAX package gives GSPMD Megatron-style sharding rules and lets XLA insert
the collectives. Here the same rules (`_RULES`, first match wins, on the flax
layout) say which dimension of each parameter a rank of the mesh's 'model'
axis keeps a slice of, and the forward pass runs the collectives itself, as
autograd functions over the model group:

- column-parallel q / k / v and the FFN's `wi` (the flax kernel's output
  dimension, so dim 0 of an nn.Linear weight [out, in]): each rank runs
  H / n_model heads and d_ff / n_model inner columns. Their input enters
  through `copy_to_model` (identity forward, all-reduce backward), so every
  rank ends the backward pass with the whole gradient of the replicated
  activations;
- row-parallel `o` and `wo` (dim 1 of the torch weight): each rank's partial
  product leaves through `reduce_from_model` (all-reduce forward, identity
  backward);
- `sid_embedding` and `user_embedding` sharded on rows: a masked local lookup
  whose sum over the model group is the lookup;
- `heads` [L, d, K] sharded on K: each rank's logits are gathered over the
  model group (`gather_from_model`), so every rank computes the same loss;
- everything else is replicated: the RMSNorm weights, the tokens, and the
  relative-position bias, of which each rank reads its heads' columns
  through `copy_to_model`, so its gradient is summed over the model group.

Every replicated parameter therefore ends each backward pass with the same
gradient on every model rank; global-norm clipping (`grad_norm`) sums the
squared norms of the shards over the model group and counts each replicated
parameter once.

Dropout draws the same masks under any layout, as the JAX package's global
iota hash does: the attention kernels (and their plain versions) count heads
from the rank's first global head `h0` of the global count, the FFN's inner
dropout counts its column window `j0 ..` of each d_ff row (ops/hash_dropout.
py's `row` form), and the dropouts over d_model are replicated.

Generation on a tensor-parallel mesh gathers the shards once per call and runs
the unsharded `generate` (`unsharded`), which is what XLA does with a custom
call's sharded operands: kernels 2 and 3 see whole weights. A checkpoint of a
tensor-parallel run holds the gathered parameters (`gather_params`), as the
JAX package saves global arrays. Under gloo a step runs eagerly (the
collectives cannot be captured); under NCCL a step graph holds them as kernel
nodes.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as tdist

MODEL_AXIS = "model"

# (path names that must all occur, flax-layout spec) -- first match wins
_RULES = [
    (("sid_embedding",), (MODEL_AXIS, None)),
    (("user_embedding",), (MODEL_AXIS, None)),
    (("heads",), (None, None, MODEL_AXIS)),  # [L, d, K] -> shard K
    (("self_attn", "q"), (None, MODEL_AXIS)),
    (("self_attn", "k"), (None, MODEL_AXIS)),
    (("self_attn", "v"), (None, MODEL_AXIS)),
    (("self_attn", "o"), (MODEL_AXIS, None)),
    (("cross_attn", "q"), (None, MODEL_AXIS)),
    (("cross_attn", "k"), (None, MODEL_AXIS)),
    (("cross_attn", "v"), (None, MODEL_AXIS)),
    (("cross_attn", "o"), (MODEL_AXIS, None)),
    (("ffn", "wi"), (None, MODEL_AXIS)),
    (("ffn", "wo"), (MODEL_AXIS, None)),
]

Spec = Tuple[Optional[str], ...]


class ModelShard(NamedTuple):
    """This process's place on the mesh's 'model' axis: rank `rank` of
    `size`, collectives over `group` (a torch process group) and `backend`."""

    rank: int
    size: int
    group: Any = None
    backend: str = "gloo"

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph can hold this group's collectives (NCCL)."""
        return self.backend == "nccl"

    def window(self, n: int) -> Tuple[int, int]:
        """(start, length) of this rank's slice of a dimension of n."""
        if n % self.size:
            raise ValueError(f"a dimension of {n} does not divide over {self.size} model ranks")
        return self.rank * (n // self.size), n // self.size


def _spec_for(names: Sequence[str], ndim: int) -> Spec:
    """The flax-layout spec of a leaf of `ndim` dims at path `names`
    (rqvae_tpu/parallel/tp.py's rule, leaves of other ranks included)."""
    for needles, spec in _RULES:
        if all(any(n == needle for n in names) for needle in needles):
            if len(spec) == ndim:
                return spec
            if ndim > len(spec):  # leading dims replicated (stacked params)
                return (None,) * (ndim - len(spec)) + spec
            return spec[len(spec) - ndim:]  # fewer dims: the rule's trailing entries
    return (None,) * ndim


def retrieval_param_specs(model: torch.nn.Module) -> Dict[str, Spec]:
    """For each parameter name of an EncoderDecoderRetrievalModel, the mesh
    axis of each of its dims in the torch layout: the JAX spec of its flax
    counterpart, reversed for an nn.Linear weight (flax kernel [in, out],
    torch weight [out, in])."""
    linear = {f"{name}.weight" for name, m in model.named_modules() if isinstance(m, torch.nn.Linear)}
    out = {}
    for name, p in model.named_parameters():
        spec = _spec_for(name.split("."), p.dim())
        out[name] = tuple(reversed(spec)) if name in linear else spec
    return out


def _sharded_dim(spec: Spec) -> Optional[int]:
    return spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None


def shard_of(model: torch.nn.Module) -> Optional[ModelShard]:
    """The ModelShard a model was cut for (None: a whole model)."""
    return getattr(model, "tp", None)


@torch.no_grad()
def shard_params(mesh, model: torch.nn.Module, rank: Optional[int] = None) -> torch.nn.Module:
    """Cut `model`'s parameters in place to model rank `rank`'s slices
    (default: this process's rank on `mesh`, a parallel/mesh.py::
    ProcessMesh) and mark its modules for the tensor-parallel forward.
    Make the optimizer after this call: its moments take the slices'
    shapes. Returns the model."""
    shard = mesh.model if rank is None else mesh.model._replace(rank=int(rank))
    ffn = getattr(getattr(model, "config", None), "t5_ffn", "relu")
    if ffn != "relu":
        raise ValueError(f"tensor parallelism cuts T5's ReLU FFN; a model with t5_ffn={ffn!r} has no "
                         "tensor-parallel layout (its experts would be cut by expert parallelism)")
    if shard_of(model) is not None:
        raise ValueError("the model is already sharded")
    specs = retrieval_param_specs(model)
    for name, p in model.named_parameters():
        dim = _sharded_dim(specs[name])
        if dim is not None:
            start, n = shard.window(p.shape[dim])
            p.data = p.data.narrow(dim, start, n).contiguous()
    for m in model.modules():
        m.tp = shard
    return model


@torch.no_grad()
def gather_params(model: torch.nn.Module, state: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """The whole parameters of a sharded model (every shard all-gathered
    over its model group, in rank order), by name; a whole model's as they
    are. `state`: tensors shaped as the parameters under their names (an
    optimizer's moments) to gather instead. A collective: every model rank
    calls it."""
    shard = shard_of(model)
    specs = retrieval_param_specs(model)
    out = {}
    items = model.named_parameters() if state is None else state.items()
    for name, p in items:
        dim = _sharded_dim(specs[name])
        if shard is None or dim is None or shard.size == 1:
            out[name] = p.detach().clone()
            continue
        parts = [torch.empty_like(p) for _ in range(shard.size)]
        tdist.all_gather(parts, p.detach().contiguous(), group=shard.group)
        out[name] = torch.cat(parts, dim=dim)
    return out


def unsharded(model: torch.nn.Module) -> torch.nn.Module:
    """A whole copy of a sharded model, its parameters gathered (a
    collective), with no tensor-parallel marks: what generation runs on."""
    full = gather_params(model)
    shard = shard_of(model)
    for m in model.modules():
        m.tp = None
    try:
        whole = copy.deepcopy(model)
    finally:
        for m in model.modules():
            m.tp = shard
    for name, p in whole.named_parameters():
        p.data = full[name].to(p.device)
    return whole


def sharded_mask(model: torch.nn.Module, params: Sequence[torch.nn.Parameter]) -> list:
    """For each of `params` (an optimizer's), whether it is sharded."""
    specs = retrieval_param_specs(model)
    names = {id(p): n for n, p in model.named_parameters()}
    return [_sharded_dim(specs[names[id(p)]]) is not None for p in params]


def attach_optimizer(model: torch.nn.Module, optimizer) -> None:
    """Give `optimizer` (train/state.py::AdamW over `model`'s parameters) the
    global norm of a sharded model's whole gradient for its clipping."""
    shard = shard_of(model)
    if shard is not None and shard.size > 1:
        optimizer.grad_norm = grad_norm(shard, sharded_mask(model, optimizer.params))


def grad_norm(shard: ModelShard, sharded: Sequence[bool]):
    """norm(grads) -> the global norm of the whole gradient: the squared
    norms of the sharded gradients summed over the model group, plus each
    replicated gradient's once (every model rank holds the same)."""

    def norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
        sq = [g.float().pow(2).sum() for g in grads]
        zero = torch.zeros((), dtype=torch.float32, device=grads[0].device)
        part = sum((s for s, sh in zip(sq, sharded) if sh), zero)
        tdist.all_reduce(part, group=shard.group)
        return torch.sqrt(part + sum((s for s, sh in zip(sq, sharded) if not sh), zero))

    return norm


# ---- the collectives of the forward pass -------------------------------------

class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        tdist.all_reduce(g, group=ctx.shard.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        x = x.contiguous().clone()
        tdist.all_reduce(x, group=shard.group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard, dim):
        ctx.shard, ctx.dim, ctx.n = shard, dim, x.shape[dim]
        parts = [torch.empty_like(x.contiguous()) for _ in range(shard.size)]
        tdist.all_gather(parts, x.contiguous(), group=shard.group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.shard.rank * ctx.n, ctx.n), None, None


def copy_to_model(x: torch.Tensor, shard: Optional[ModelShard]) -> torch.Tensor:
    """Identity forward, gradient all-reduced over the model group: the entry
    of a replicated activation (or parameter) into rank-local work."""
    return x if shard is None or shard.size == 1 else _CopyToModel.apply(x, shard)


def reduce_from_model(x: torch.Tensor, shard: Optional[ModelShard]) -> torch.Tensor:
    """The sum over the model group forward, gradient passed through: the
    exit of a row-parallel product."""
    return x if shard is None or shard.size == 1 else _ReduceFromModel.apply(x, shard)


def gather_from_model(x: torch.Tensor, shard: Optional[ModelShard], dim: int = -1) -> torch.Tensor:
    """The model ranks' x concatenated along `dim` in rank order; the
    gradient is this rank's slice."""
    if shard is None or shard.size == 1:
        return x
    return _GatherFromModel.apply(x, shard, dim % x.dim())


def vocab_lookup(table: torch.Tensor, ids: torch.Tensor, shard: Optional[ModelShard], lookup) -> torch.Tensor:
    """lookup(table, ids) of a table sharded on rows: each rank looks up the
    ids among its rows (others read row 0 and are zeroed), and the sum over
    the model group is the whole lookup."""
    if shard is None or shard.size == 1:
        return lookup(table, ids)
    start = shard.rank * table.shape[0]
    local = ids.long() - start
    mine = (local >= 0) & (local < table.shape[0])
    rows = lookup(table, torch.where(mine, local, 0))
    return reduce_from_model(rows * mine[..., None].to(rows.dtype), shard)
