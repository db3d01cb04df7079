"""The measured package's objects, built from a configuration file's sizes:
the one place that maps the benchmark's configurations onto
rqvae_tpu_torch's constructors. Imported lazily, so the benchmark's CPU
tests of its own arithmetic need nothing of the program."""

from __future__ import annotations

from typing import Dict

import torch


def tokenizer(cfg: dict, rq_w: Dict[str, torch.Tensor], features: torch.Tensor, dev, seed: int):
    """The frozen RQ-VAE loaded with the benchmark's weights, and its
    tokenizer with the corpus index built (kernel 1 at its default bf16 on
    the card)."""
    from rqvae_tpu_torch.models.quantize import QuantizeForwardMode
    from rqvae_tpu_torch.models.rqvae import RqVae, RqVaeConfig
    from rqvae_tpu_torch.tokenizer.semids import SemanticIdTokenizer

    rq = cfg["rqvae"]
    model = RqVae(RqVaeConfig(
        input_dim=rq["input_dim"], embed_dim=rq["embed_dim"], hidden_dims=tuple(rq["hidden_dims"]),
        codebook_size=rq["codebook_size"], n_layers=rq["n_layers"], n_cat_feats=rq["n_cat_feats"],
        codebook_mode=QuantizeForwardMode[rq["codebook_mode"]]), device=dev, seed=seed)
    model.load_state_dict(rq_w)
    tok = SemanticIdTokenizer(model, device=dev)
    tok.precompute_corpus_ids(features)
    return tok


def retrieval_model(cfg: dict, t5_w: Dict[str, torch.Tensor], dev, seed: int):
    """The retrieval T5 at the configuration's widths and compute dtype,
    loaded with the benchmark's weights."""
    from rqvae_tpu_torch.models.retrieval import EncoderDecoderRetrievalModel, RetrievalConfig

    rq, t5 = cfg["rqvae"], cfg["t5"]
    model = EncoderDecoderRetrievalModel(RetrievalConfig(
        num_hierarchies=rq["n_layers"], codebook_size=rq["codebook_size"], t5_d_model=t5["d_model"],
        t5_d_kv=t5["d_kv"], t5_num_heads=t5["num_heads"], t5_d_ff=t5["d_ff"], t5_num_layers=t5["num_layers"],
        t5_dropout=t5["dropout"], top_k_for_generation=t5["top_k"], should_add_sep_token=True,
        t5_dtype=t5["dtype"]), device=dev, seed=seed)
    model.load_state_dict(t5_w)
    return model
