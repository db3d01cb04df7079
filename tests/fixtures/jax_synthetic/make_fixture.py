"""Regenerate this directory: checkpoints written by the JAX package, the
inputs, and what the JAX package's Retriever.from_checkpoints serves for them.

    JAX_PLATFORMS=cpu python tests/fixtures/jax_synthetic/make_fixture.py

Widths: the RQ-VAE of configs/rqvae_synthetic.gin (64 -> [128, 64] -> 16,
3 x 64 codes, STE, k-means-initialised codebooks) and the decoder of
configs/decoder_synthetic.gin (d_model 64, 4 heads, d_ff 128, 2 + 2 layers,
top-k 10, SEP tokens, float32) with d_kv cut from the default 64 to 16, which
keeps the directory under 1 MB. Random weights from fixed seeds; 64 synthetic
items, 16 histories of 1..8 items. The results are the JAX XLA path's, f32.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.abspath(os.path.join(HERE, "..", "..", "..")))

from rqvae_tpu.data.schemas import TokenizedSeqBatch  # noqa: E402
from rqvae_tpu.data.synthetic import SyntheticConfig, generate  # noqa: E402
from rqvae_tpu.models.quantize import QuantizeForwardMode  # noqa: E402
from rqvae_tpu.models.retrieval import EncoderDecoderRetrievalModel, RetrievalConfig  # noqa: E402
from rqvae_tpu.models.rqvae import RqVae, RqVaeConfig, kmeans_init_codebooks  # noqa: E402
from rqvae_tpu.serving.retriever import Retriever  # noqa: E402
from rqvae_tpu.utils.checkpoint import save_checkpoint  # noqa: E402

N_ITEMS, N_HIST, MAX_ITEMS = 64, 16, 8


def main() -> None:
    data = generate(SyntheticConfig(n_items=N_ITEMS, n_users=N_HIST, input_dim=64, max_seq_len=MAX_ITEMS, seed=3))
    feats = np.asarray(data["item_features"], np.float32)
    r = np.random.RandomState(4)
    lengths = r.randint(1, MAX_ITEMS + 1, N_HIST)
    hist = np.where(np.arange(MAX_ITEMS)[None, :] < lengths[:, None],
                    r.randint(0, N_ITEMS, (N_HIST, MAX_ITEMS)), -1).astype(np.int32)

    vae_cfg = RqVaeConfig(input_dim=64, embed_dim=16, hidden_dims=(128, 64), codebook_size=64, n_layers=3,
                          n_cat_feats=0, codebook_mode=QuantizeForwardMode.STE)
    rq = RqVae(vae_cfg)
    x = jnp.asarray(feats)
    rq_params = rq.init({"params": jax.random.PRNGKey(0), "gumbel": jax.random.PRNGKey(1)}, x[:2], 0.2,
                        training=True)
    rq_params = jax.device_get(kmeans_init_codebooks(jax.random.PRNGKey(2), rq, rq_params, x))
    rq_path = save_checkpoint(os.path.join(HERE, "rqvae"), 299, rq_params, config=vae_cfg)

    dec_cfg = RetrievalConfig(num_hierarchies=3, codebook_size=64, t5_d_model=64, t5_d_kv=16, t5_num_heads=4,
                              t5_d_ff=128, t5_num_layers=2, t5_dropout=0.1, top_k_for_generation=10,
                              should_add_sep_token=True)
    model = EncoderDecoderRetrievalModel(dec_cfg)
    D = dec_cfg.num_hierarchies + 1
    example = TokenizedSeqBatch(
        user_ids=jnp.zeros(1, jnp.int32), sem_ids=jnp.zeros((1, D), jnp.int32),
        sem_ids_fut=jnp.zeros((1, D), jnp.int32), seq_mask=jnp.ones((1, D), bool),
        token_type_ids=jnp.zeros((1, D), jnp.int32), token_type_ids_fut=jnp.zeros((1, D), jnp.int32))
    params = jax.device_get(model.init({"params": jax.random.PRNGKey(5), "dropout": jax.random.PRNGKey(6)},
                                       example, training=True))
    dec_path = save_checkpoint(os.path.join(HERE, "decoder"), 400, params, config=dec_cfg)

    out = Retriever.from_checkpoints(rq_path, dec_path, feats).retrieve(hist)
    np.savez_compressed(os.path.join(HERE, "inputs_and_results.npz"), item_features=feats, histories=hist,
                        item_ids=np.asarray(out.item_ids), sem_ids=np.asarray(out.sem_ids),
                        log_probas=np.asarray(out.log_probas))
    valid = np.asarray(out.item_ids) >= 0
    print(f"wrote {rq_path}, {dec_path}; {int(valid.sum())} of {valid.size} beams resolve to items")


if __name__ == "__main__":
    main()
