"""Weights for the port: the bridge from JAX params and seeded initialisers.

`state_dict_from_jax` maps a flax params tree, as numpy arrays
(`jax.device_get(params)`), to the `state_dict` of the port's `RqVae` or
`EncoderDecoderRetrievalModel`. The module names mirror the flax names:
`block_{i}` becomes `block.{i}`, an MLP's `dense_{i}` becomes `layers.{i}`,
and a Dense `kernel` [in, out] becomes an nn.Linear `weight` [out, in]. Every
other leaf (`codebooks`, `out_proj`, `heads`, `sid_embedding`, `bos_token`,
`sep_token`, `user_embedding`, `rel_bias`, RMSNorm `weight`) carries over
as it is. `jax_params_from_state_dict` is the inverse (the JAX-format
checkpoint writer's params): it decides by module type, since an nn.Linear
`weight` becomes a transposed `kernel` while an RMSNorm `weight` stays.

`init_rqvae_` and `init_retrieval_` fill a model from a seed at the JAX
package's init scales (models/mlp.py torch-Linear uniform; models/t5.py HF
T5 normals). They draw on the CPU and copy to the model's device, so one
seed gives the same weights on every device.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from rqvae_tpu_torch.models.moe import INIT_STD


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, path + "/"))
        elif isinstance(v, torch.Tensor):  # a bf16 leaf of a checkpoint (utils/flax_msgpack.py)
            out[path] = v
        else:
            out[path] = torch.from_numpy(np.array(v, copy=True))
    return out


def state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """flax params ({'params': {...}} or the inner dict), numpy or torch
    leaves -> port state_dict."""
    if set(params) == {"params"}:
        params = params["params"]
    state = {}
    for path, arr in _flatten(params).items():
        parts = path.split("/")
        leaf = parts[-1]
        name = ".".join(re.sub(r"^(block|dense)_(\d+)$", _rename, p) for p in parts[:-1])
        if leaf == "kernel":
            leaf, arr = "weight", arr.T
        state[f"{name}.{leaf}" if name else leaf] = arr.contiguous().clone()
    return state


def jax_params_from_state_dict(model: torch.nn.Module,
                               state: Optional[Mapping[str, torch.Tensor]] = None) -> Dict[str, Dict]:
    """The inverse of `state_dict_from_jax`: the flax params tree
    {'params': {...}} of `model`, numpy leaves. An nn.Linear `weight` [out,
    in] goes back to a Dense `kernel` [in, out]; every other parameter (an
    RMSNorm's `weight` included) keeps its name and layout. The module's
    type decides, not the name. `state` (default: the model's state_dict)
    may be any tensors under the model's names, optimizer moments too."""
    linear = {f"{name}.weight" if name else "weight"
              for name, m in model.named_modules() if isinstance(m, torch.nn.Linear)}
    tree: Dict = {}
    for key, t in (model.state_dict() if state is None else state).items():
        parts = key.split(".")
        path, leaf = [], parts[-1]
        i = 0
        while i < len(parts) - 1:
            if parts[i] in ("block", "layers") and parts[i + 1].isdigit():
                path.append(f"{'block' if parts[i] == 'block' else 'dense'}_{parts[i + 1]}")
                i += 2
            else:
                path.append(parts[i])
                i += 1
        arr = t.detach().cpu()
        if key in linear:
            leaf, arr = "kernel", arr.T
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = arr.contiguous() if arr.dtype == torch.bfloat16 else arr.contiguous().numpy()
    return {"params": tree}


def grads_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """A JAX gradient tree, or one tree of optimizer moments (optax's `mu` or
    `nu`), under the port's parameter names: the view that lays it beside
    `p.grad` and the optimizer's moments. A Dense kernel's gradient is
    transposed exactly as the kernel is."""
    return state_dict_from_jax(tree)


def _rename(m: re.Match) -> str:
    return f"{'block' if m.group(1) == 'block' else 'layers'}.{m.group(2)}"


def load_jax_params(model: torch.nn.Module, params: Mapping) -> torch.nn.Module:
    """Copy JAX params into `model` (strict: every name must match)."""
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return model


@torch.no_grad()
def _fill(param: torch.Tensor, value: torch.Tensor) -> None:
    param.copy_(value.to(param.dtype))


def _uniform(g, shape, bound):
    return (torch.rand(shape, generator=g) * 2.0 - 1.0) * bound


def _normal(g, shape, std):
    return torch.randn(shape, generator=g) * std


def init_rqvae_(model: torch.nn.Module, seed: int) -> None:
    """torch-Linear init U(+-1/sqrt(fan_in)) for the MLPs, U(0, 1) codebooks,
    per-level U(+-1/sqrt(D)) SimVQ projections."""
    g = torch.Generator().manual_seed(seed)
    for name, p in model.named_parameters():
        if name == "codebooks":
            _fill(p, torch.rand(p.shape, generator=g))
        elif name == "out_proj":
            _fill(p, _uniform(g, p.shape, p.shape[-2] ** -0.5))
        else:  # MLP Linear weight [out, in]
            _fill(p, _uniform(g, p.shape, p.shape[1] ** -0.5))


def init_retrieval_(model: torch.nn.Module, seed: int) -> None:
    """HF T5 init (factor 1) as in the JAX package: embeddings N(0, 1);
    q N(0, (d*dk)^-1/2), k/v N(0, d^-1/2), o N(0, (H*dk)^-1/2), rel-bias
    N(0, d^-1/2), wi N(0, d^-1/2), wo N(0, dff^-1/2), RMSNorm scales 1;
    heads U(+-1/sqrt(d)); a gated FFN's weights and router N(0, 0.02^2)
    (models/moe.py::INIT_STD)."""
    cfg = model.config
    d, dk, H = cfg.t5_d_model, cfg.t5_d_kv, cfg.t5_num_heads
    std = {
        "q": (d * dk) ** -0.5, "k": d ** -0.5, "v": d ** -0.5, "o": (H * dk) ** -0.5,
        "wi": d ** -0.5, "wo": cfg.t5_d_ff ** -0.5,
    }
    g = torch.Generator().manual_seed(seed)
    for name, p in model.named_parameters():
        parts = name.split(".")
        if name in ("sid_embedding", "bos_token", "sep_token", "user_embedding"):
            _fill(p, torch.randn(p.shape, generator=g))
        elif name == "heads":
            _fill(p, _uniform(g, p.shape, d ** -0.5))
        elif parts[-1] == "rel_bias":
            _fill(p, _normal(g, p.shape, d ** -0.5))
        elif parts[-2].startswith("ln"):
            _fill(p, torch.ones(p.shape))
        elif {"router", "w_gate", "w_up", "w_down"} & set(parts[-2:]):  # gated FFNs (models/moe.py)
            _fill(p, _normal(g, p.shape, INIT_STD))
        else:  # q/k/v/o and wi/wo Linear weights
            _fill(p, _normal(g, p.shape, std[parts[-2]]))
