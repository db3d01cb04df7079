"""The reference PyTorch layout into the port (counterpart of
rqvae_tpu/utils/torch_import.py).

A user of the original PyTorch repository has RQ-VAE `.pt` files of
torch.save({iter, model: state_dict, model_config, optimizer}), and its
published tokenizer is a `PyTorchModelHubMixin` directory (config.json of the
RqVae init kwargs with model.safetensors or pytorch_model.bin). Their
state_dict layout:

    encoder.mlp.{i}.weight           [out, in]
    decoder.mlp.{i}.weight           [out, in]
    layers.{l}.embedding.weight      [K, D]
    layers.{l}.out_proj.0.weight     [D, D]      (only with sim_vq)

The port's RqVae state_dict (models/rqvae.py):

    encoder.layers.{j}.weight        [out, in]   (nn.Linear keeps torch's layout)
    decoder.layers.{j}.weight        [out, in]
    codebooks                        [L, K, D]
    out_proj                         [L, D, D]   (sim_vq; x @ out_proj[l])

The nn.Sequential index i counts ReLU and Dropout modules too, so the Linear
layers are matched by the sorted numeric order of the entries with a 2-D
weight.
"""

from __future__ import annotations

import enum
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from rqvae_tpu_torch.models.quantize import QuantizeForwardMode
from rqvae_tpu_torch.models.rqvae import RqVaeConfig


def _tensor(v) -> torch.Tensor:
    return v.detach().cpu() if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v, copy=True))


def _seq_linears(state: Mapping[str, torch.Tensor], prefix: str) -> list:
    """The `{prefix}.{i}.weight` 2-D tensors in ascending i."""
    found = []
    for key, val in state.items():
        if key.startswith(prefix + ".") and key.endswith(".weight") and val.dim() == 2:
            found.append((int(key[len(prefix) + 1: -len(".weight")]), val))
    return [v for _, v in sorted(found, key=lambda kv: kv[0])]


def strip_wrappers(state: Mapping[str, Any]) -> Dict[str, Any]:
    """Keys without the prefixes torch.compile and DDP add."""
    return {k.replace("_orig_mod.", "").replace("module.", ""): v for k, v in state.items()}


def rqvae_params_from_torch_state(state_dict: Mapping[str, Any], n_layers: int) -> Dict[str, torch.Tensor]:
    """A reference-layout RQ-VAE state_dict (tensors or arrays) -> the port's
    RqVae state_dict."""
    state = {k: _tensor(v) for k, v in state_dict.items()}
    out: Dict[str, torch.Tensor] = {}
    for ours, theirs in (("encoder", "encoder.mlp"), ("decoder", "decoder.mlp")):
        for j, w in enumerate(_seq_linears(state, theirs)):
            out[f"{ours}.layers.{j}.weight"] = w.contiguous().clone()
    out["codebooks"] = torch.stack([state[f"layers.{l}.embedding.weight"] for l in range(n_layers)])
    if "layers.0.out_proj.0.weight" in state:
        out["out_proj"] = torch.stack([state[f"layers.{l}.out_proj.0.weight"].t() for l in range(n_layers)])
    return out


def _forward_mode(m) -> QuantizeForwardMode:
    """The reference's codebook_mode in any of the forms its files hold: the
    enum itself (pickled from the reference's module), its value, a dict of
    its name or value, or a string such as "QuantizeForwardMode.STE"."""
    if m is None:
        return QuantizeForwardMode.GUMBEL_SOFTMAX
    if isinstance(m, enum.Enum):
        return QuantizeForwardMode[m.name]
    if isinstance(m, int):
        return QuantizeForwardMode(m)
    if isinstance(m, dict):
        return _forward_mode(m.get("name", m.get("value")))
    return QuantizeForwardMode[str(m).split(".")[-1].upper()]


def rqvae_config_from_reference(cfg_raw: Mapping[str, Any]) -> RqVaeConfig:
    """The reference RqVae's init kwargs (a checkpoint's `model_config`, a
    mixin config.json) -> the port's RqVaeConfig."""
    return RqVaeConfig(
        input_dim=cfg_raw.get("input_dim", 768),
        embed_dim=cfg_raw.get("embed_dim", 32),
        hidden_dims=tuple(cfg_raw.get("hidden_dims", (512, 256, 128))),
        codebook_size=cfg_raw.get("codebook_size", 256),
        n_layers=cfg_raw.get("n_layers", 3),
        commitment_weight=cfg_raw.get("commitment_weight", 0.25),
        n_cat_feats=cfg_raw.get("n_cat_features", 0),
        codebook_normalize=cfg_raw.get("codebook_normalize", False),
        sim_vq=cfg_raw.get("codebook_sim_vq", False),
        codebook_mode=_forward_mode(cfg_raw.get("codebook_mode")),
    )


def load_reference_rqvae_checkpoint(path: str) -> Tuple[RqVaeConfig, Dict[str, torch.Tensor], int]:
    """A reference `.pt` RQ-VAE checkpoint -> (RqVaeConfig, the port's
    state_dict, step). The file is unpickled in full (its `model_config`
    may hold objects of the reference's modules, which must then be
    importable): read only local files that you trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    cfg = rqvae_config_from_reference(ckpt.get("model_config", {}))
    return cfg, rqvae_params_from_torch_state(strip_wrappers(ckpt["model"]), cfg.n_layers), int(ckpt.get("iter", 0))
