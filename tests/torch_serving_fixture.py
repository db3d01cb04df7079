"""The serving fixture of tests/test_retriever.py in both packages: the JAX
RQ-VAE, tokenizer, model and params of `_setup()`, and the port's with the
same weights and its own index over the same corpus (equal to JAX's on the
CPU: both take the f32 path)."""

import jax
import numpy as np

from rqvae_tpu_torch.models import retrieval as tr
from rqvae_tpu_torch.models.quantize import QuantizeForwardMode
from rqvae_tpu_torch.models.rqvae import RqVae, RqVaeConfig
from rqvae_tpu_torch.serving.retriever import Retriever
from rqvae_tpu_torch.tokenizer.semids import SemanticIdTokenizer
from rqvae_tpu_torch.utils.convert import load_jax_params

from tests.test_retriever import _setup


def both_packages():
    """(jax: (model, params, tok), port retriever, histories [6, 8])."""
    data, model, params, tok, hist = _setup()
    trq = load_jax_params(RqVae(RqVaeConfig(input_dim=16, embed_dim=8, hidden_dims=(16,), codebook_size=8,
                                            n_layers=3, codebook_mode=QuantizeForwardMode.STE), device="cpu"),
                          jax.device_get(tok.params))
    ttok = SemanticIdTokenizer(trq, device="cpu")
    ttok.precompute_corpus_ids(np.asarray(data["item_features"]))
    cfg = model.config
    tcfg = tr.RetrievalConfig(num_hierarchies=cfg.num_hierarchies, codebook_size=cfg.codebook_size,
                              t5_d_model=cfg.t5_d_model, t5_d_kv=cfg.t5_d_kv, t5_num_heads=cfg.t5_num_heads,
                              t5_d_ff=cfg.t5_d_ff, t5_num_layers=cfg.t5_num_layers,
                              top_k_for_generation=cfg.top_k_for_generation)
    tm = load_jax_params(tr.EncoderDecoderRetrievalModel(tcfg, device="cpu"), jax.device_get(params))
    return (model, params, tok), Retriever(tm, ttok, device="cpu"), np.asarray(hist)
