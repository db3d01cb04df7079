"""The port's weights in the reference PyTorch layout (counterpart of
rqvae_tpu/utils/torch_export.py, the inverse of utils/torch_import.py).

An RQ-VAE trained here drops into the original repository, whose stage-2
trainer loads `.pt` files of torch.save({iter, model: state_dict,
model_config}); its encoder and decoder are nn.Sequential([Linear, ReLU] *
hidden + [Linear, Identity]), so the Linear layers sit at indices 0, 2, 4, ...:

    encoder.mlp.{2j}.weight          [out, in]
    decoder.mlp.{2j}.weight          [out, in]
    layers.{l}.embedding.weight      [K, D]
    layers.{l}.out_proj.0.weight     [D, D]      (only with sim_vq)

`model_config` holds plain Python values only (the forward mode as its enum
name), so the file unpickles anywhere. A retrieval model goes to the
reference `EncoderDecoderRetrievalModel` layout (HF T5 stacks).

    python -m rqvae_tpu_torch.utils.torch_export <checkpoint .pt or .msgpack> <out.pt>
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from rqvae_tpu_torch.models.retrieval import RetrievalConfig
from rqvae_tpu_torch.models.rqvae import RqVaeConfig


def torch_state_from_rqvae_params(state_dict: Mapping[str, torch.Tensor], n_layers: int) -> Dict[str, torch.Tensor]:
    """The port's RqVae state_dict -> the reference layout."""
    out: Dict[str, torch.Tensor] = {}
    for ours, theirs in (("encoder", "encoder.mlp"), ("decoder", "decoder.mlp")):
        j = 0
        while f"{ours}.layers.{j}.weight" in state_dict:
            out[f"{theirs}.{2 * j}.weight"] = state_dict[f"{ours}.layers.{j}.weight"].detach().cpu().clone()
            j += 1
    codebooks = state_dict["codebooks"].detach().cpu()
    if codebooks.shape[0] != n_layers:
        raise ValueError(f"codebooks of {codebooks.shape[0]} levels for n_layers {n_layers}")
    for l in range(n_layers):
        out[f"layers.{l}.embedding.weight"] = codebooks[l].clone()
    if "out_proj" in state_dict:
        for l in range(n_layers):
            out[f"layers.{l}.out_proj.0.weight"] = state_dict["out_proj"][l].detach().cpu().t().contiguous()
    return out


def save_reference_checkpoint(cfg: RqVaeConfig, state_dict: Mapping[str, torch.Tensor], step: int, dst: str) -> str:
    """Write a `.pt` the original repository loads: {iter, model, model_config}."""
    model_config = {
        "input_dim": int(cfg.input_dim),
        "embed_dim": int(cfg.embed_dim),
        "hidden_dims": [int(d) for d in cfg.hidden_dims],
        "codebook_size": int(cfg.codebook_size),
        "n_layers": int(cfg.n_layers),
        "commitment_weight": float(cfg.commitment_weight),
        "n_cat_features": int(cfg.n_cat_feats),
        "codebook_normalize": bool(cfg.codebook_normalize),
        "codebook_sim_vq": bool(cfg.sim_vq),
        "codebook_mode": cfg.codebook_mode.name,
    }
    model = torch_state_from_rqvae_params(state_dict, cfg.n_layers)
    torch.save({"iter": int(step), "model": model, "model_config": model_config}, dst)
    return dst



def export_checkpoint(src: str, dst: str) -> str:
    """An RQ-VAE checkpoint of either format (the port's `.pt` or the JAX
    package's `.msgpack`) -> the reference `.pt`."""
    from rqvae_tpu_torch.utils.checkpoint import load_checkpoint, params_state_dict

    ckpt = load_checkpoint(src)
    cfg = ckpt["config"]
    if not isinstance(cfg, RqVaeConfig):
        raise ValueError(f"{src} carries no RqVaeConfig; cannot export")
    return save_reference_checkpoint(cfg, params_state_dict(ckpt), ckpt["step"], dst)

def _t5_stack_state(state: Mapping[str, torch.Tensor], ours: str, num_layers: int, is_decoder: bool,
                    prefix: str) -> Dict[str, torch.Tensor]:
    """The port's T5Stack weights -> an HF T5Stack state_dict (nn.Linear
    weights keep their [out, in] layout on both sides)."""
    get = lambda name: state[f"{ours}.{name}"].detach().cpu().clone()  # noqa: E731
    out: Dict[str, torch.Tensor] = {}
    for i in range(num_layers):
        b, p = f"block.{i}", f"{prefix}block.{i}.layer.0."
        for x in "qkvo":
            out[f"{p}SelfAttention.{x}.weight"] = get(f"{b}.self_attn.{x}.weight")
        if i == 0:
            out[f"{p}SelfAttention.relative_attention_bias.weight"] = get(f"{b}.self_attn.rel_bias")
        out[f"{p}layer_norm.weight"] = get(f"{b}.ln_self.weight")
        li = 1
        if is_decoder:
            c = f"{prefix}block.{i}.layer.1."
            for x in "qkvo":
                out[f"{c}EncDecAttention.{x}.weight"] = get(f"{b}.cross_attn.{x}.weight")
            out[f"{c}layer_norm.weight"] = get(f"{b}.ln_cross.weight")
            li = 2
        f = f"{prefix}block.{i}.layer.{li}."
        out[f"{f}DenseReluDense.wi.weight"] = get(f"{b}.ffn.wi.weight")
        out[f"{f}DenseReluDense.wo.weight"] = get(f"{b}.ffn.wo.weight")
        out[f"{f}layer_norm.weight"] = get(f"{b}.ln_ffn.weight")
    out[f"{prefix}final_layer_norm.weight"] = get("ln_final.weight")
    return out


def reference_retrieval_state_from_params(state_dict: Mapping[str, torch.Tensor],
                                          cfg: RetrievalConfig) -> Dict[str, torch.Tensor]:
    """The port's EncoderDecoderRetrievalModel state_dict -> the reference
    `modules/model.py::EncoderDecoderRetrievalModel` layout. The corpus
    tuple table there is a buffer set at construction, not a weight, so it
    is not in this state_dict; load it with strict=False (the reference's
    unused token-embedding stubs have no counterpart here)."""
    get = lambda name: state_dict[name].detach().cpu().clone()  # noqa: E731
    out: Dict[str, torch.Tensor] = {"item_sid_embedding_table.weight": get("sid_embedding"),
                                    "bos_token": get("bos_token")}
    if "sep_token" in state_dict:
        out["sep_token"] = get("sep_token")
    if "user_embedding" in state_dict:
        out["user_embedding.weight"] = get("user_embedding")
    heads = get("heads")  # [L, d, K]
    for h in range(cfg.num_hierarchies):
        out[f"decoder_mlp.{h}.weight"] = heads[h].t().contiguous()
    out.update(_t5_stack_state(state_dict, "encoder", cfg.t5_num_layers, False, "encoder.encoder."))
    out.update(_t5_stack_state(state_dict, "decoder", cfg.t5_num_layers, True, "t5_decoder."))
    return out


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description="Export an RQ-VAE checkpoint to the reference .pt")
    ap.add_argument("src", help="checkpoint .pt or .msgpack path")
    ap.add_argument("dst", help="output .pt path")
    args = ap.parse_args()
    print(export_checkpoint(args.src, args.dst))


if __name__ == "__main__":
    main()
