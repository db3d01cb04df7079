"""Checkpoints of the port: params + optimizer state + step + config
(counterpart of rqvae_tpu/utils/checkpoint.py).

One `checkpoint_{step}.pt` per step, written by `torch.save`: the model's
`state_dict`, the optimizer's `state_dict` (moments and update count, which
fixes the schedule's position), the step, free-form `extra`, and the config
dataclass as JSON, rebuilt on load. The RQ-VAE checkpoint is the contract
between the two training stages: the decoder trainer rebuilds the RQ-VAE from
the stored config and loads the weights.

The JAX package's flax-msgpack checkpoints are not read here: a `.msgpack`
path raises (their reader is queued in ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import enum
import json
import os
from typing import Any, Dict, Optional, Tuple

import torch

_SUFFIX = ".pt"


def _config_to_jsonable(cfg: Any) -> Any:
    if dataclasses.is_dataclass(cfg):
        return {
            "__dataclass__": type(cfg).__name__,
            **{f.name: _config_to_jsonable(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)},
        }
    if isinstance(cfg, enum.Enum):
        return {"__enum__": type(cfg).__name__, "name": cfg.name}
    if isinstance(cfg, (list, tuple)):
        return [_config_to_jsonable(v) for v in cfg]
    return cfg


def _jsonable_to_config(obj: Any) -> Any:
    """Inverse of _config_to_jsonable for the port's config dataclasses."""
    if isinstance(obj, dict) and "__enum__" in obj:
        from rqvae_tpu_torch.utils.config import _ENUM_REGISTRY, _register_builtin_enums

        _register_builtin_enums()
        return _ENUM_REGISTRY[obj["__enum__"]][obj["name"]]
    if isinstance(obj, dict) and "__dataclass__" in obj:
        from rqvae_tpu_torch.models.retrieval import RetrievalConfig
        from rqvae_tpu_torch.models.rqvae import RqVaeConfig

        cls = {"RqVaeConfig": RqVaeConfig, "RetrievalConfig": RetrievalConfig}[obj["__dataclass__"]]
        kwargs = {k: _jsonable_to_config(v) for k, v in obj.items() if k != "__dataclass__"}
        for f in dataclasses.fields(cls):  # JSON has no tuples
            if f.name in kwargs and isinstance(kwargs[f.name], list):
                kwargs[f.name] = tuple(kwargs[f.name])
        return cls(**kwargs)
    return obj


def _refuse_msgpack(path: str) -> None:
    if str(path).endswith(".msgpack"):
        raise NotImplementedError(
            f"{path}: flax-msgpack checkpoints of the rqvae_tpu package are not read yet "
            "(the reader is queued in ROADMAP.md); pass a .pt checkpoint written by "
            "rqvae_tpu_torch.utils.checkpoint.save_checkpoint"
        )


def save_checkpoint(save_dir: str, step: int, params: Dict[str, torch.Tensor], opt_state: Any = None,
                    config: Any = None, extra: Optional[Dict[str, Any]] = None) -> str:
    """Write checkpoint_{step}.pt under save_dir (tensors moved to the CPU);
    returns the path."""
    os.makedirs(save_dir, exist_ok=True)
    to_cpu = lambda t: t.detach().cpu() if isinstance(t, torch.Tensor) else t
    payload = {
        "step": int(step),
        "params": {k: to_cpu(v) for k, v in params.items()},
        "config_json": json.dumps(_config_to_jsonable(config)),
    }
    if opt_state is not None:
        payload["opt_state"] = {k: [to_cpu(t) for t in v] if isinstance(v, list) else v for k, v in opt_state.items()}
    if extra:
        payload["extra"] = extra
    path = os.path.join(save_dir, f"checkpoint_{step}{_SUFFIX}")
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str, map_location="cpu") -> Dict[str, Any]:
    """{step, params, opt_state?, extra?, config} of a checkpoint written by
    save_checkpoint."""
    _refuse_msgpack(path)
    payload = dict(torch.load(path, map_location=map_location, weights_only=True))
    payload["config"] = _jsonable_to_config(json.loads(payload.pop("config_json")))
    payload["step"] = int(payload["step"])
    return payload


def latest_checkpoint(save_dir: str) -> Optional[str]:
    """The checkpoint_{step}.pt with the largest step under save_dir, or None."""
    if not os.path.isdir(save_dir):
        return None
    best: Tuple[int, Optional[str]] = (-1, None)
    for name in os.listdir(save_dir):
        if name.startswith("checkpoint_") and name.endswith(_SUFFIX):
            try:
                step = int(name[len("checkpoint_"): -len(_SUFFIX)])
            except ValueError:
                continue
            if step > best[0]:
                best = (step, os.path.join(save_dir, name))
    return best[1]
