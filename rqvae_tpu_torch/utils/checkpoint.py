"""Checkpoints of the port: params + optimizer state + step + config
(counterpart of rqvae_tpu/utils/checkpoint.py).

Two formats, told apart by the suffix:

- `checkpoint_{step}.pt`, the port's trainers' own, written by `torch.save`:
  the model's `state_dict`, the optimizer's `state_dict` (moments and update
  count, which fixes the schedule's position), the step, free-form `extra`,
  and the config dataclass as JSON, rebuilt on load;
- `checkpoint_{step}.msgpack`, the JAX package's: an 8-byte little-endian
  length, the JSON meta {"config", "step"}, then the flax-msgpack blob of
  {step, params, opt_state?, extra?}, read and written without JAX, flax or
  msgpack (utils/flax_msgpack.py). Its params are the flax tree
  ({'params': {...}}, numpy leaves, bf16 leaves as torch tensors) and its
  opt_state optax's (train/state.py::optax_state); `params_state_dict`
  turns either format's params into the port's `state_dict`.

Both trainers resume from either format (`restore_training_state`), and
`latest_checkpoint` sees both suffixes. `export_jax_checkpoint` rewrites a
port `.pt` checkpoint as the JAX file, params and opt_state, for a JAX run
to continue.

The RQ-VAE checkpoint is the contract between the two training stages: the
decoder trainer rebuilds the RQ-VAE from the stored config and loads the
weights.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from rqvae_tpu_torch.utils import flax_msgpack

SUFFIXES = (".pt", ".msgpack")


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


def is_jax_format(path: str) -> bool:
    """A `.msgpack` checkpoint, the JAX package's format."""
    return str(path).endswith(".msgpack")


def _write_atomic(path: str, write) -> str:
    tmp = path + ".tmp"
    write(tmp)
    os.replace(tmp, path)
    return path


def checkpoint_path(save_dir: str, step: int, fmt: str = "pt") -> str:
    """Where save_checkpoint writes the checkpoint of `step`."""
    if fmt not in ("pt", "msgpack"):
        raise ValueError(f"fmt must be 'pt' or 'msgpack', got {fmt!r}")
    return os.path.join(save_dir, f"checkpoint_{step}.{fmt}")


def save_checkpoint_main(save_dir: str, step: int, params, opt_state: Any = None, config: Any = None,
                         fmt: str = "pt") -> str:
    """save_checkpoint on the main process only, as the JAX trainers gate
    their writes; every rank returns the path after a barrier, so the file
    exists before any rank reads it (a process alone just writes)."""
    from rqvae_tpu_torch.parallel import dist

    if dist.is_main_process():
        save_checkpoint(save_dir, step, params, opt_state, config, fmt=fmt)
    dist.barrier()
    return checkpoint_path(save_dir, step, fmt)


def save_checkpoint(save_dir: str, step: int, params, opt_state: Any = None, config: Any = None,
                    extra: Optional[Dict[str, Any]] = None, fmt: str = "pt") -> str:
    """Write checkpoint_{step}.{fmt} under save_dir; returns the path.

    fmt="pt": `params` a state_dict (tensors moved to the CPU), `opt_state`
    the optimizer's state_dict. fmt="msgpack": the JAX package's file, which
    its `load_checkpoint` restores; `params` the flax tree
    (`utils/convert.py::jax_params_from_state_dict`), `opt_state` optax's
    tree (`train/state.py::optax_state`)."""
    os.makedirs(save_dir, exist_ok=True)
    config_json = _config_to_jsonable(config)
    if fmt == "msgpack":
        payload = {"step": np.int64(step), "params": params}
        if opt_state is not None:
            payload["opt_state"] = opt_state
        if extra:
            payload["extra"] = extra
        blob = flax_msgpack.msgpack_serialize(payload)
        meta = json.dumps({"config": config_json, "step": int(step)}).encode()

        def write(tmp):
            with open(tmp, "wb") as f:
                f.write(len(meta).to_bytes(8, "little"))
                f.write(meta)
                f.write(blob)

        return _write_atomic(checkpoint_path(save_dir, step, fmt), write)
    path = checkpoint_path(save_dir, step, fmt)
    to_cpu = lambda t: t.detach().cpu() if isinstance(t, torch.Tensor) else t
    payload = {
        "step": int(step),
        "params": {k: to_cpu(v) for k, v in params.items()},
        "config_json": json.dumps(config_json),
    }
    if opt_state is not None:
        payload["opt_state"] = {k: [to_cpu(t) for t in v] if isinstance(v, list) else v for k, v in opt_state.items()}
    if extra:
        payload["extra"] = extra
    return _write_atomic(path, lambda tmp: torch.save(payload, tmp))


def _load_msgpack(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        meta_len = int.from_bytes(f.read(8), "little")
        meta = json.loads(f.read(meta_len))
        blob = f.read()
    payload = dict(flax_msgpack.msgpack_restore(blob))
    payload["config"] = _jsonable_to_config(meta.get("config"))
    payload["step"] = int(payload["step"])
    return payload


def load_checkpoint(path: str, map_location="cpu") -> Dict[str, Any]:
    """{step, params, opt_state?, extra?, config} of a checkpoint of either
    format: a `.msgpack` file's params are its flax tree (numpy leaves), a
    `.pt` file's a state_dict."""
    if is_jax_format(path):
        return _load_msgpack(path)
    payload = dict(torch.load(path, map_location=map_location, weights_only=True))
    payload["config"] = _jsonable_to_config(json.loads(payload.pop("config_json")))
    payload["step"] = int(payload["step"])
    return payload


def params_state_dict(restored: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's state_dict of a loaded checkpoint's params, from either
    format (a flax tree goes through `state_dict_from_jax`)."""
    from rqvae_tpu_torch.utils.convert import state_dict_from_jax

    params = restored["params"]
    if set(params) == {"params"} and isinstance(params["params"], dict):
        return state_dict_from_jax(params)
    return params


def latest_checkpoint(save_dir: str) -> Optional[str]:
    """The checkpoint_{step}.pt or .msgpack with the largest step under
    save_dir, or None."""
    if not os.path.isdir(save_dir):
        return None
    best: Tuple[int, Optional[str]] = (-1, None)
    for name in os.listdir(save_dir):
        suffix = next((s for s in SUFFIXES if name.endswith(s)), None)
        if name.startswith("checkpoint_") and suffix:
            try:
                step = int(name[len("checkpoint_"): -len(suffix)])
            except ValueError:
                continue
            if step > best[0]:
                best = (step, os.path.join(save_dir, name))
    return best[1]


def restore_training_state(restored: Dict[str, Any], model: torch.nn.Module, optimizer,
                           need_opt_state: bool = True) -> int:
    """Load a checkpoint of either format (`load_checkpoint`'s dict) into a
    trainer's model and AdamW, in place; returns the step to start from.
    A `.msgpack` file's opt_state is optax's tree (train/state.py::
    load_optax_state), which must fit the optimizer's settings. Without an
    opt_state the moments stay as they are, if `need_opt_state` is False
    (the JAX stage-1 trainer resumes so), else it raises."""
    from rqvae_tpu_torch.train.state import load_optax_state

    model.load_state_dict(params_state_dict(restored))
    opt_state = restored.get("opt_state")
    if opt_state is None:
        if need_opt_state:
            raise ValueError("the checkpoint holds no opt_state to resume the optimizer from")
    elif "mu" in opt_state:  # the port's AdamW.state_dict
        optimizer.load_state_dict(opt_state)
    else:
        load_optax_state(optimizer, model, opt_state)
    return restored["step"] + 1


def export_jax_checkpoint(src: str, dst_dir: str, max_grad_norm: Optional[float] = None) -> str:
    """Rewrite a port `.pt` checkpoint as the JAX package's file
    (checkpoint_{step}.msgpack under dst_dir): the flax params tree and, if
    the file has an optimizer state, optax's opt_state in the layout of the
    JAX trainer of its stage: a constant LR for an RQ-VAE (stage 1), the
    schedule for a retrieval model (stage 2), clipping if `max_grad_norm` is
    given, as the JAX trainer it continues in is configured. Returns the
    path. The counterpart of rqvae_tpu/utils/torch_export.py's
    export_checkpoint, the other way round."""
    from rqvae_tpu_torch.models.retrieval import EncoderDecoderRetrievalModel, RetrievalConfig
    from rqvae_tpu_torch.models.rqvae import RqVae, RqVaeConfig
    from rqvae_tpu_torch.train.state import AdamW, optax_state
    from rqvae_tpu_torch.utils.convert import jax_params_from_state_dict

    if is_jax_format(src):
        raise ValueError(f"{src} is a JAX-format checkpoint already")
    restored = load_checkpoint(src)
    cfg = restored["config"]
    if isinstance(cfg, RqVaeConfig):
        model, schedule = RqVae(cfg, device="cpu"), False
    elif isinstance(cfg, RetrievalConfig):
        model, schedule = EncoderDecoderRetrievalModel(cfg, device="cpu"), True
    else:
        raise ValueError(f"{src} holds neither an RQ-VAE nor a retrieval model config")
    model.load_state_dict(restored["params"])
    opt_state = None
    if restored.get("opt_state") is not None:
        # only the layout is read from the LR: a schedule or a constant
        opt = AdamW(model.parameters(), (lambda count: 0.0) if schedule else 0.0, max_grad_norm=max_grad_norm)
        opt.load_state_dict(restored["opt_state"])
        opt_state = optax_state(opt, model)
    return save_checkpoint(dst_dir, restored["step"], jax_params_from_state_dict(model), opt_state, cfg,
                           fmt="msgpack")
