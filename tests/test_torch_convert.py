"""The port's weight bridge, its seeded initialisers, its import rule and its
default device."""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rqvae_tpu.data.schemas import TokenizedSeqBatch as JBatch
from rqvae_tpu.models import retrieval as jr
from rqvae_tpu.models.rqvae import RqVae as JRqVae
from rqvae_tpu.models.rqvae import RqVaeConfig as JRqVaeConfig

from rqvae_tpu_torch.models import retrieval as tr
from rqvae_tpu_torch.models.rqvae import RqVae, RqVaeConfig
from rqvae_tpu_torch.ops.cuda.rq_encode import fused_encode_quantize
from rqvae_tpu_torch.serving.retriever import Retriever
from rqvae_tpu_torch.tokenizer.semids import SemanticIdTokenizer
from rqvae_tpu_torch.utils.convert import load_jax_params, state_dict_from_jax
from rqvae_tpu_torch.utils.device import resolve_device

ROOT = pathlib.Path(__file__).resolve().parents[1]
RET = dict(num_hierarchies=3, codebook_size=8, t5_d_model=32, t5_d_kv=8, t5_num_heads=4, t5_d_ff=64,
           t5_num_layers=2, num_user_bins=5)


def _numbered_like(shapes):
    """A params tree of the given shapes holding distinct values (so a
    wrong transpose or a swapped leaf shows)."""
    leaves, treedef = jax.tree_util.tree_flatten(shapes)
    start, out = 0, []
    for leaf in leaves:
        n = int(np.prod(leaf.shape))
        out.append(np.arange(start, start + n, dtype=np.float32).reshape(leaf.shape))
        start += n
    return jax.tree_util.tree_unflatten(treedef, out)


SMALL_VAE = dict(input_dim=12, embed_dim=4, hidden_dims=(8, 6), codebook_size=5, n_layers=2)
ML32M_VAE = dict(input_dim=788, embed_dim=64, hidden_dims=(512, 256, 128), codebook_size=256, n_layers=3)


@pytest.mark.parametrize("fields", [SMALL_VAE, {**SMALL_VAE, "sim_vq": True}, ML32M_VAE],
                         ids=["small", "small-sim_vq", "ml32m"])
def test_bridge_rqvae(fields):
    sim_vq = fields.get("sim_vq", False)
    jm = JRqVae(JRqVaeConfig(**fields))
    rngs = {"params": jax.random.PRNGKey(0), "gumbel": jax.random.PRNGKey(1)}
    params = _numbered_like(jax.eval_shape(lambda: jm.init(rngs, jnp.zeros((2, fields["input_dim"])), 0.2)))
    tm = load_jax_params(RqVae(RqVaeConfig(**fields), device="cpu"), params)
    p = params["params"]
    assert tm.codebooks.shape == (fields["n_layers"], fields["codebook_size"], fields["embed_dim"])
    for i in range(len(fields["hidden_dims"]) + 1):
        np.testing.assert_array_equal(tm.encoder.layers[i].weight.detach().numpy(), p["encoder"][f"dense_{i}"]["kernel"].T)
        np.testing.assert_array_equal(tm.decoder.layers[i].weight.detach().numpy(), p["decoder"][f"dense_{i}"]["kernel"].T)
    np.testing.assert_array_equal(tm.codebooks.detach().numpy(), p["codebooks"])
    if sim_vq:
        np.testing.assert_array_equal(tm.out_proj.detach().numpy(), p["out_proj"])


def test_bridge_retrieval_model():
    jm = jr.EncoderDecoderRetrievalModel(jr.RetrievalConfig(**RET))
    D = 4
    batch = JBatch(jnp.zeros(2, jnp.int32), jnp.zeros((2, 2 * D), jnp.int32), jnp.zeros((2, D), jnp.int32),
                   jnp.ones((2, 2 * D), bool), jnp.zeros((2, 2 * D), jnp.int32), jnp.zeros((2, D), jnp.int32))
    rngs = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}
    params = _numbered_like(jax.eval_shape(lambda: jm.init(rngs, batch, training=True)))
    sd = state_dict_from_jax(params)
    tm = load_jax_params(tr.EncoderDecoderRetrievalModel(tr.RetrievalConfig(**RET), device="cpu"), params)
    assert set(sd) == set(tm.state_dict())
    p = params["params"]
    blk = p["decoder"]["block_1"]
    np.testing.assert_array_equal(tm.decoder.block[1].cross_attn.q.weight.detach().numpy(),
                                  blk["cross_attn"]["q"]["kernel"].T)
    np.testing.assert_array_equal(tm.decoder.block[1].ffn.wo.weight.detach().numpy(), blk["ffn"]["wo"]["kernel"].T)
    np.testing.assert_array_equal(tm.encoder.block[0].self_attn.rel_bias.detach().numpy(),
                                  p["encoder"]["block_0"]["self_attn"]["rel_bias"])
    for name in ("heads", "sid_embedding", "bos_token", "sep_token", "user_embedding"):
        np.testing.assert_array_equal(getattr(tm, name).detach().numpy(), p[name])


def test_seeded_initialisers_follow_jax_scales():
    cfg = tr.RetrievalConfig(**{**RET, "t5_d_model": 64, "t5_d_kv": 16, "t5_d_ff": 128})
    a = tr.EncoderDecoderRetrievalModel(cfg, device="cpu", seed=3)
    b = tr.EncoderDecoderRetrievalModel(cfg, device="cpu", seed=3)
    c = tr.EncoderDecoderRetrievalModel(cfg, device="cpu", seed=4)
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    assert not torch.equal(a.heads, c.heads)
    d, dk, H, dff = 64, 16, 4, 128
    blk = a.decoder.block[0]
    for w, std in [(blk.self_attn.q.weight, (d * dk) ** -0.5), (blk.self_attn.k.weight, d ** -0.5),
                   (blk.cross_attn.o.weight, (H * dk) ** -0.5), (blk.ffn.wi.weight, d ** -0.5),
                   (blk.ffn.wo.weight, dff ** -0.5), (a.sid_embedding, 1.0)]:
        assert abs(w.std().item() / std - 1) < 0.1
    assert torch.equal(blk.ln_cross.weight, torch.ones(d))
    assert a.heads.abs().max() <= d ** -0.5
    rq = RqVae(RqVaeConfig(input_dim=64, embed_dim=8, hidden_dims=(32,), codebook_size=16), device="cpu", seed=0)
    assert 0 <= rq.codebooks.min() and rq.codebooks.max() < 1
    assert rq.encoder.layers[0].weight.abs().max() <= 64 ** -0.5


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_never_imports_jax():
    package = sorted((ROOT / "rqvae_tpu_torch").rglob("*.py"))
    # the worker of the multi-process tests runs the port as a user would: it is held to the same rule
    files = package + [ROOT / "chip_smoke.py", ROOT / "tests" / "torch_dist_worker.py"]
    assert len(files) > 35 and all(f.exists() for f in files)
    assert {"hash_dropout.py", "attention.py", "encoder_stack.py", "_build.py"} <= {f.name for f in files}
    rel = {str(f.relative_to(ROOT / "rqvae_tpu_torch")) for f in package}
    assert {"train/train_decoder.py", "train/decoder_steps.py", "train/state.py", "data/sampling.py",
            "data/synthetic.py", "data/datasets.py", "data/registry.py", "utils/config.py", "utils/logging.py",
            "utils/checkpoint.py", "ops/schedules.py", "ops/metrics.py", "ops/embedding.py",
            "train/train_rqvae.py", "train/rqvae_steps.py", "ops/kmeans.py", "ops/losses.py", "ops/gumbel.py"} <= rel
    assert {"utils/flax_msgpack.py", "serving/engine.py", "serving/queue.py"} <= rel
    assert {"ops/amp.py", "utils/hub.py", "utils/torch_import.py", "utils/torch_export.py"} <= rel
    assert {"parallel/dist.py", "parallel/mesh.py", "data/loader.py"} <= rel
    # the card machine has no JAX, flax, msgpack, safetensors or hub client: checkpoints are read by
    # utils/flax_msgpack.py, .safetensors files by utils/hub.py::read_safetensors
    banned = {"jax", "flax", "rqvae_tpu", "jaxlib", "optax", "msgpack", "safetensors", "huggingface_hub"}
    for path in files:
        for mod in _imports(path):
            assert mod.split(".")[0] not in banned, f"{path.relative_to(ROOT)} imports {mod}"


def test_entry_points_need_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = RqVaeConfig(input_dim=8, embed_dim=4, hidden_dims=(8,), codebook_size=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RqVae(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tr.EncoderDecoderRetrievalModel(tr.RetrievalConfig(**RET))
    rq = RqVae(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SemanticIdTokenizer(rq)
    tok = SemanticIdTokenizer(rq, device="cpu")
    tok.precompute_corpus_ids(np.random.RandomState(0).randn(10, 8).astype(np.float32))
    model = tr.EncoderDecoderRetrievalModel(
        tr.RetrievalConfig(**{**RET, "codebook_size": 4, "top_k_for_generation": 3}), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Retriever(model, tok)
    assert Retriever(model, tok, device="cpu").retrieve(np.array([[1, 2, -1]])).item_ids.shape == (1, 3)


def test_kernel_wrapper_never_falls_back():
    """A tensor neither on the CPU nor on a card is refused, not computed
    some other way."""
    x = torch.zeros(4, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_encode_quantize(x, [torch.zeros(8, 4, device="meta")], torch.zeros(2, 3, 4, device="meta"), 2)
