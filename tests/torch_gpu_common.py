"""What the card's test files share (tests/test_torch_kernels_gpu.py,
tests/test_torch_paths_gpu.py): the `cuda` fixture, the published widths,
and data and weights made from seeds. Imports torch and the port only.
"""

import gc
import os

import numpy as np
import pytest
import torch

from rqvae_tpu_torch.models.quantize import QuantizeForwardMode
from rqvae_tpu_torch.models.retrieval import EncoderDecoderRetrievalModel, RetrievalConfig
from rqvae_tpu_torch.models.rqvae import RqVae, RqVaeConfig
from rqvae_tpu_torch.utils.checkpoint import save_checkpoint
from rqvae_tpu_torch.utils.config import parse_config_file

# RQ-VAE and T5 widths, history length and batch of configs/rqvae_amazon.gin, decoder_amazon.gin and their
# ML-32M files (the same T5); the encoder rows Le are 4 x the items of a history: 80 (kernel 2's whole rows), 800.
# Users are cut from Amazon Beauty's 22,363 and ML-32M's 200,948 to a full-evaluation batch or more, Amazon's
# items from 65,536; ML-32M keeps its movie count, 87,585, no multiple of a 64-row block
AMAZON = dict(input_dim=768, embed_dim=32, history=20, batch=640, users=2048, items=8192)
ML32M = dict(input_dim=788, embed_dim=64, history=200, batch=64, users=1024, items=87585)
T5 = dict(t5_d_model=384, t5_d_kv=64, t5_num_heads=6, t5_d_ff=1024, t5_num_layers=4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    # what a test leaves goes back to the card for the next: step runners and engines close over
    # themselves (their graphs' pools), and cuBLAS keeps a workspace for every stream it ran on (the
    # captures' side streams), each in a segment of the caching allocator that it keeps from release
    gc.collect()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()


# ---- data and weights from seeds ----

def make_corpus(n, dim, seed):
    """Clustered item features on the CPU: 256 centers, unit per-item noise."""
    g = torch.Generator().manual_seed(seed)
    centers = torch.randn(256, dim, generator=g)
    return centers[torch.randint(0, 256, (n,), generator=g)] + torch.randn(n, dim, generator=g)


def item_corpus(n, cfg, seed):
    """Stage-1 rows at cfg's width: make_corpus rows with the dense columns at
    unit norm, as sentence-T5 item embeddings are, and the last n_cat_feats
    binary and cluster-correlated (ML-32M's genre flags)."""
    x = make_corpus(n, cfg.input_dim, seed)
    dense = cfg.input_dim - cfg.n_cat_feats
    x[:, :dense] /= x[:, :dense].norm(dim=1, keepdim=True)
    x[:, dense:] = (x[:, dense:] > 1.0).float()
    return x


def seed_codebooks(rq, x, seed):
    """Each level's codebook: residuals of random rows of x, jittered, so the
    index holds many distinct tuples and no argmin ties exactly."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        res = rq.encode(x[torch.randperm(x.shape[0], generator=g)[:8192].to(x.device)])
        for level in range(rq.config.n_layers):
            cb = res[torch.randperm(res.shape[0], generator=g)[: rq.config.codebook_size].to(x.device)]
            cb = cb + 0.1 * res.std() * torch.randn(cb.shape, generator=g).to(x.device)
            rq.codebooks[level].copy_(cb)
            res = res - cb[torch.cdist(res, cb).argmin(1)]


def make_rqvae(geo, dev):
    """The geometry's RQ-VAE (3 x 256 codes, STE) with data-seeded codebooks,
    and its corpus on the CPU."""
    cfg = RqVaeConfig(input_dim=geo["input_dim"], embed_dim=geo["embed_dim"], hidden_dims=(512, 256, 128),
                      codebook_size=256, n_layers=3, codebook_mode=QuantizeForwardMode.STE)
    x = make_corpus(geo["items"], cfg.input_dim, seed=0)
    rq = RqVae(cfg, device=dev, seed=0)
    seed_codebooks(rq, x.to(dev), seed=1)
    return rq, x


def retrieval_model(dtype, dev, **over):
    cfg = RetrievalConfig(num_hierarchies=3, codebook_size=256, top_k_for_generation=10, should_add_sep_token=True,
                          t5_dtype=dtype, **T5, **over)
    return EncoderDecoderRetrievalModel(cfg, device=dev, seed=2)


def gin_rqvae(path, mode=None):
    """The RQ-VAE config of a configs/rqvae_*.gin file (its estimator unless
    `mode`) and the file's settings."""
    st = parse_config_file(path)
    cfg = RqVaeConfig(input_dim=st["vae_input_dim"], embed_dim=st["vae_embed_dim"],
                      hidden_dims=tuple(st["vae_hidden_dims"]), codebook_size=st["vae_codebook_size"],
                      n_layers=st["vae_n_layers"], commitment_weight=st["commitment_weight"],
                      n_cat_feats=st["vae_n_cat_feats"], codebook_mode=mode or st["vae_codebook_mode"])
    return cfg, st


def write_training_inputs(root, geo, rq, x, seed):
    """The processed dataset file of the geometry's synthetic users
    (leave-two-out histories of 8 .. history + 2 items) and the frozen
    RQ-VAE's checkpoint, as train_decoder.train reads them. Returns (dataset
    folder, checkpoint path, the dataset's arrays)."""
    r = np.random.RandomState(seed)
    users, max_len = geo["users"], geo["history"] + 2
    lengths = r.randint(8, max_len + 1, users).astype(np.int64)
    items = r.randint(0, x.shape[0], (users, max_len)).astype(np.int64)
    items[np.arange(max_len)[None, :] >= lengths[:, None]] = -1
    data = {"item_features": x.numpy(), "item_is_train": np.ones(x.shape[0], bool), "seq_items": items,
            "seq_lengths": lengths, "user_ids": np.arange(users, dtype=np.int64),
            "max_seq_len": np.int64(geo["history"]), "dataset_name": np.asarray("synthetic")}
    os.makedirs(os.path.join(root, "data", "processed"))
    np.savez(os.path.join(root, "data", "processed", "data.npz"), **data)
    ckpt = save_checkpoint(os.path.join(root, "rqvae"), 0, rq.state_dict(), None, rq.config)
    return os.path.join(root, "data"), ckpt, data
