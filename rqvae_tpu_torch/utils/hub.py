"""Hub-style model export and import on local directories (counterpart of
rqvae_tpu/utils/hub.py).

`save_pretrained` writes the JAX package's self-describing directory:
config.json (the config dataclass as utils/checkpoint.py writes it) and
flax_model.msgpack (the flax params tree, through utils/flax_msgpack.py), so
`rqvae_tpu.utils.hub.load_pretrained` reads what the port exports and the
other way round. `from_pretrained` reads a local directory in any of the
three layouts the JAX module reads:

  1. that native export;
  2. the reference's `PyTorchModelHubMixin` layout: config.json of the RqVae
     init kwargs with model.safetensors or pytorch_model.bin, converted by
     utils/torch_import.py;
  3. a raw reference trainer `.pt` (torch.save{iter, model, model_config}).

The port has no hub client and no network: a repo id that is not a local
directory raises the JAX module's offline error, and `push_to_hub` raises.
`.safetensors` files are read by `read_safetensors`, a small reader of the
format (an 8-byte little-endian header length, a JSON header of each
tensor's dtype, shape and byte offsets, then the little-endian buffers).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import torch

from rqvae_tpu_torch.utils import flax_msgpack
from rqvae_tpu_torch.utils.checkpoint import _config_to_jsonable, _jsonable_to_config, params_state_dict

WEIGHTS_NAME = "flax_model.msgpack"
CONFIG_NAME = "config.json"
MIXIN_WEIGHTS = ("model.safetensors", "pytorch_model.bin")  # in the order they are preferred

_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}


def save_pretrained(save_dir: str, params: Any, config: Any) -> str:
    """Write config.json and flax_model.msgpack under save_dir; `params` is
    the flax tree (utils/convert.py::jax_params_from_state_dict)."""
    os.makedirs(save_dir, exist_ok=True)
    with open(os.path.join(save_dir, CONFIG_NAME), "w") as f:
        json.dump(_config_to_jsonable(config), f, indent=2)
    with open(os.path.join(save_dir, WEIGHTS_NAME), "wb") as f:
        f.write(flax_msgpack.msgpack_serialize(params))
    return save_dir


def load_pretrained(save_dir: str) -> Tuple[Any, Any]:
    """(config, params) of a native export: the flax params tree."""
    with open(os.path.join(save_dir, CONFIG_NAME)) as f:
        config = _jsonable_to_config(json.load(f))
    with open(os.path.join(save_dir, WEIGHTS_NAME), "rb") as f:
        params = flax_msgpack.msgpack_restore(f.read())
    return config, params


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a `.safetensors` file, as CPU tensors."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 8:
        raise ValueError(f"{path}: too short for a safetensors header")
    n = int.from_bytes(data[:8], "little")
    if 8 + n > len(data):
        raise ValueError(f"{path}: a header of {n} bytes does not fit the file")
    header = json.loads(data[8:8 + n])
    body = memoryview(data)[8 + n:]
    out = {}
    for name, spec in header.items():
        if name == "__metadata__":
            continue
        if spec["dtype"] not in _SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: tensor {name} has dtype {spec['dtype']}, which is not read")
        dtype = _SAFETENSORS_DTYPES[spec["dtype"]]
        begin, end = spec["data_offsets"]
        shape = tuple(spec["shape"])
        count = 1
        for s in shape:
            count *= s
        if not 0 <= begin <= end <= len(body) or end - begin != count * torch.empty((), dtype=dtype).element_size():
            raise ValueError(f"{path}: tensor {name} has offsets {spec['data_offsets']} for shape {shape}")
        flat = torch.frombuffer(bytearray(body[begin:end]), dtype=dtype) if count else torch.empty(0, dtype=dtype)
        out[name] = flat.reshape(shape)
    return out


def _load_torch_state_file(path: str) -> Dict[str, Any]:
    """A torch state_dict from `.safetensors` or a torch.save file (a bare
    state_dict or the reference trainer's {"model": ...}). A torch.save file
    is unpickled in full: read only local files that you trust."""
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    obj = torch.load(path, map_location="cpu", weights_only=False)
    return obj["model"] if isinstance(obj, dict) and "model" in obj else obj


def from_pretrained(repo_id_or_dir: str) -> Tuple[Any, Dict[str, torch.Tensor]]:
    """(config, the port's state_dict) of an RQ-VAE in a local directory, in
    the first of the three layouts (module docstring) that it holds. A name
    that is not a local directory raises: the port downloads nothing."""
    from rqvae_tpu_torch.utils.torch_import import (
        load_reference_rqvae_checkpoint,
        rqvae_config_from_reference,
        rqvae_params_from_torch_state,
        strip_wrappers,
    )

    path = repo_id_or_dir
    if not os.path.isdir(path):
        raise RuntimeError(
            f"'{repo_id_or_dir}' is not a local directory and downloading it from the HF Hub failed "
            "(this package has no hub client and no network). "
            "Offline environments can load a pre-downloaded snapshot directory instead.")
    if os.path.exists(os.path.join(path, WEIGHTS_NAME)):
        config, params = load_pretrained(path)
        return config, params_state_dict({"params": params})
    cfg_raw = None
    cfg_file = os.path.join(path, CONFIG_NAME)
    if os.path.exists(cfg_file):
        with open(cfg_file) as f:
            cfg_raw = json.load(f)
        if isinstance(cfg_raw, dict) and "__dataclass__" in cfg_raw:
            cfg_raw = None  # a native config without its weights
    for name in MIXIN_WEIGHTS:
        wfile = os.path.join(path, name)
        if cfg_raw is not None and os.path.exists(wfile):
            cfg = rqvae_config_from_reference(cfg_raw)
            return cfg, rqvae_params_from_torch_state(strip_wrappers(_load_torch_state_file(wfile)), cfg.n_layers)
    pts = sorted(f for f in os.listdir(path) if f.endswith(".pt"))
    if pts:
        cfg, state, _ = load_reference_rqvae_checkpoint(os.path.join(path, pts[-1]))
        return cfg, state
    raise FileNotFoundError(
        f"no loadable model found under {path}: expected {WEIGHTS_NAME}, model.safetensors / "
        "pytorch_model.bin (+ config.json), or a reference trainer .pt checkpoint")


def push_to_hub(save_dir: str, repo_id: str, private: bool = True) -> str:
    """Not available in this package: it has no hub client, and the card's
    machines no network. Raises RuntimeError; the export in save_dir stays."""
    raise RuntimeError(f"pushing {save_dir} to the HF Hub as {repo_id} is not available: "
                       "this package has no hub client")
