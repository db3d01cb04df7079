"""Checkpoints across the two packages, on the CPU.

Files that rqvae_tpu.utils.checkpoint.save_checkpoint writes (flax msgpack)
are read by the port's pure-Python reader (utils/flax_msgpack.py) with every
leaf bit-equal and the config equal, enums and `n_candidates` included; the
port's JAX-format files are restored by the JAX package's load_checkpoint
with templates, bit-equal. Small widths (the synthetic configs or narrower).
"""

import dataclasses
import enum
import os
import sys

import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rqvae_tpu.data.schemas import TokenizedSeqBatch as JBatch
from rqvae_tpu.models import retrieval as jr
from rqvae_tpu.models.quantize import QuantizeForwardMode as JMode
from rqvae_tpu.models.rqvae import RqVae as JRqVae
from rqvae_tpu.models.rqvae import RqVaeConfig as JRqVaeConfig
from rqvae_tpu.utils import checkpoint as jckpt

from rqvae_tpu_torch.models import quantize as tquantize
from rqvae_tpu_torch.models import retrieval as tr
from rqvae_tpu_torch.models.quantize import QuantizeForwardMode
from rqvae_tpu_torch.models.rqvae import RqVae, RqVaeConfig
from rqvae_tpu_torch.utils import checkpoint as tckpt
from rqvae_tpu_torch.utils import flax_msgpack
from rqvae_tpu_torch.utils.convert import jax_params_from_state_dict, state_dict_from_jax

VAE = dict(input_dim=64, embed_dim=16, hidden_dims=(128, 64), codebook_size=64, n_layers=3, n_cat_feats=0)
DEC = dict(num_hierarchies=3, codebook_size=64, t5_d_model=64, t5_d_kv=16, t5_num_heads=4, t5_d_ff=128,
           t5_num_layers=2, top_k_for_generation=10, n_candidates=17, t5_dropout=0.0)


def _leaves(tree, prefix=""):
    """{path: numpy bits} of a nested mapping; bf16 leaves (jax or torch) as
    their uint16 bits."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_leaves(v, path + "/"))
        elif isinstance(v, torch.Tensor):
            out[path] = v.view(torch.uint16).numpy() if v.dtype == torch.bfloat16 else v.numpy()
        else:
            a = np.asarray(v)
            out[path] = a.view(np.uint16) if a.dtype == jnp.bfloat16 else a
    return out


def _assert_trees_bit_equal(got, want):
    g, w = _leaves(got), _leaves(want)
    assert set(g) == set(w)
    for path in w:
        assert g[path].dtype == w[path].dtype and g[path].shape == w[path].shape, path
        assert g[path].tobytes() == w[path].tobytes(), path


def _jax_rqvae():
    cfg = JRqVaeConfig(**VAE, codebook_mode=JMode.STE)
    m = JRqVae(cfg)
    params = m.init({"params": jax.random.PRNGKey(0), "gumbel": jax.random.PRNGKey(1)},
                    jnp.zeros((2, VAE["input_dim"])), 0.2, training=True)
    return cfg, m, jax.device_get(params)


def _jax_decoder():
    cfg = jr.RetrievalConfig(**DEC)
    m = jr.EncoderDecoderRetrievalModel(cfg)
    D = cfg.num_hierarchies + 1
    example = JBatch(user_ids=jnp.zeros(1, jnp.int32), sem_ids=jnp.zeros((1, D), jnp.int32),
                     sem_ids_fut=jnp.zeros((1, D), jnp.int32), seq_mask=jnp.ones((1, D), bool),
                     token_type_ids=jnp.zeros((1, D), jnp.int32), token_type_ids_fut=jnp.zeros((1, D), jnp.int32))
    params = m.init({"params": jax.random.PRNGKey(2), "dropout": jax.random.PRNGKey(3)}, example, training=True)
    return cfg, m, jax.device_get(params), example


def _port_config(jcfg):
    """The port's config with the JAX config's field values (enums by name)."""
    cls = RqVaeConfig if isinstance(jcfg, JRqVaeConfig) else tr.RetrievalConfig
    kw = {}
    for f in dataclasses.fields(jcfg):
        v = getattr(jcfg, f.name)
        kw[f.name] = getattr(tquantize, type(v).__name__)[v.name] if isinstance(v, enum.Enum) else v
    return cls(**{k: v for k, v in kw.items() if k in {f.name for f in dataclasses.fields(cls)}})


def test_rqvae_checkpoint_reads_bit_equal_without_msgpack(tmp_path, monkeypatch):
    cfg, _, params = _jax_rqvae()
    path = jckpt.save_checkpoint(str(tmp_path), 299, params, config=cfg)
    monkeypatch.setitem(sys.modules, "msgpack", None)  # the card machine has neither
    monkeypatch.setitem(sys.modules, "flax", None)
    got = tckpt.load_checkpoint(path)
    assert got["step"] == 299 and got["config"] == _port_config(cfg)
    assert got["config"].codebook_mode is QuantizeForwardMode.STE
    _assert_trees_bit_equal(got["params"], params)
    rq = RqVae(got["config"], device="cpu")
    rq.load_state_dict(tckpt.params_state_dict(got))  # strict: every name maps
    np.testing.assert_array_equal(rq.codebooks.detach().numpy(), params["params"]["codebooks"])


def test_decoder_checkpoint_with_n_candidates_and_opt_state(tmp_path):
    """The fault this reader would have hit: a JAX decoder checkpoint's
    config holds n_candidates, which the port's RetrievalConfig now has."""
    cfg, _, params, _ = _jax_decoder()
    opt_state = jax.device_get(optax.adamw(1e-3).init(params))
    path = jckpt.save_checkpoint(str(tmp_path), 7, params, opt_state=opt_state, config=cfg,
                                 extra={"rng": np.arange(4, dtype=np.uint32), "best": 0.25})
    got = tckpt.load_checkpoint(path)
    assert got["config"] == _port_config(cfg) and got["config"].n_candidates == 17
    _assert_trees_bit_equal(got["params"], params)
    _assert_trees_bit_equal(got["opt_state"], fser.to_state_dict(opt_state))
    assert got["extra"]["best"] == 0.25 and got["extra"]["rng"].dtype == np.uint32
    model = tr.EncoderDecoderRetrievalModel(got["config"], device="cpu")
    model.load_state_dict(tckpt.params_state_dict(got))
    sd = state_dict_from_jax(params)
    assert all(torch.equal(model.state_dict()[k], v) for k, v in sd.items())


def test_bf16_int_and_chunked_leaves(tmp_path, monkeypatch):
    r = np.random.RandomState(0)
    tree = {"params": {"w": jnp.asarray(r.randn(5, 7), jnp.bfloat16), "idx": np.arange(9, dtype=np.int32),
                       "big": r.randn(40, 3).astype(np.float32), "big_bf16": jnp.asarray(r.randn(50), jnp.bfloat16)}}
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 64)  # forces 'big' and 'big_bf16' into chunks
    path = jckpt.save_checkpoint(str(tmp_path), 1, tree)
    with open(path, "rb") as f:
        assert b"__msgpack_chunked_array__" in f.read()
    got = tckpt.load_checkpoint(path)
    assert got["config"] is None and got["params"]["params"]["w"].dtype == torch.bfloat16
    _assert_trees_bit_equal(got["params"], jax.device_get(tree))
    # and the port's writer chunks as flax does: flax reads it back
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 64)
    blob = flax_msgpack.msgpack_serialize(got["params"])
    assert b"__msgpack_chunked_array__" in blob
    _assert_trees_bit_equal(fser.msgpack_restore(blob), jax.device_get(tree))


def test_port_writer_matches_flax_bytes():
    # keys in sorted order: flax's msgpack_serialize copies the tree by tree_map, which sorts them
    tree = {"extra": {"f": 1.5, "i": -70000, "n": None, "s": "text", "t": True, "z": complex(1, -2)},
            "params": {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
                       "b": {"c": np.int32(-4), "d": np.zeros((0,), np.float64)}},
            "step": np.int64(3)}
    assert flax_msgpack.msgpack_serialize(tree) == fser.msgpack_serialize(tree)


def test_port_writer_matches_flax_bytes_for_chunked_leaves(monkeypatch):
    # the chunk marker dicts keep flax's insertion order ('10' after '9'), the tree's keys are sorted
    r = np.random.RandomState(1)
    tree = {"params": {"w": r.randn(200).astype(np.float32), "b": np.arange(3, dtype=np.int32),
                       "h": jnp.asarray(r.randn(50), jnp.bfloat16)}, "step": np.int64(7)}
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 64)
    host = jax.device_get(tree)
    want = fser.msgpack_serialize(host)
    assert flax_msgpack.msgpack_serialize(host) == want
    ported = {"params": {k: torch.from_numpy(np.asarray(v, np.float32)).to(torch.bfloat16) if k == "h"
                         else torch.from_numpy(v) for k, v in host["params"].items()}, "step": host["step"]}
    assert flax_msgpack.msgpack_serialize(ported) == want  # torch leaves, bf16 too


@pytest.mark.parametrize("which", ["rqvae", "decoder"])
def test_jax_package_restores_the_ports_files(tmp_path, which):
    """An nn.Linear weight goes back to a transposed kernel, an RMSNorm
    weight stays a weight: the JAX templates restore every leaf."""
    if which == "rqvae":
        jcfg, _, template = _jax_rqvae()
        model = RqVae(_port_config(jcfg), device="cpu", seed=5)
    else:
        jcfg, _, template, _ = _jax_decoder()
        model = tr.EncoderDecoderRetrievalModel(_port_config(jcfg), device="cpu", seed=5)
    tree = jax_params_from_state_dict(model)
    path = tckpt.save_checkpoint(str(tmp_path), 11, tree, config=model.config, fmt="msgpack")
    assert os.path.basename(path) == "checkpoint_11.msgpack" and not os.path.exists(path + ".tmp")
    got = jckpt.load_checkpoint(path, params_template=template)
    assert got["step"] == 11 and got["config"] == jcfg
    sd = state_dict_from_jax(jax.device_get(got["params"]))
    assert set(sd) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert torch.equal(sd[k], v), k
    # with the port optimizer's state in optax's layout, which the JAX template restores
    from rqvae_tpu.train.state import adamw as jadamw
    from rqvae_tpu_torch.train.state import adamw, optax_state

    opt = adamw(model.parameters(), 1e-3)
    for m in opt.mu + opt.nu:
        m.normal_()
    opt.step_count.fill_(4)
    path = tckpt.save_checkpoint(str(tmp_path), 12, tree, optax_state(opt, model), model.config, fmt="msgpack")
    got = jckpt.load_checkpoint(path, params_template=template, opt_state_template=jadamw(1e-3).init(template))
    adam = got["opt_state"][0]
    assert int(adam.count) == 4 and adam.count.dtype == jnp.int32
    mu = state_dict_from_jax(jax.device_get(adam.mu))
    for name, m in zip((n for n, _ in model.named_parameters()), opt.mu):
        assert torch.equal(mu[name], m), name


def test_latest_checkpoint_sees_both_suffixes(tmp_path):
    cfg, _, params = _jax_rqvae()
    jckpt.save_checkpoint(str(tmp_path), 5, params, config=cfg)
    rq = RqVae(_port_config(cfg), device="cpu")
    tckpt.save_checkpoint(str(tmp_path), 3, rq.state_dict(), config=rq.config)
    assert tckpt.latest_checkpoint(str(tmp_path)).endswith("checkpoint_5.msgpack")
    tckpt.save_checkpoint(str(tmp_path), 9, rq.state_dict(), config=rq.config)
    assert tckpt.latest_checkpoint(str(tmp_path)).endswith("checkpoint_9.pt")
    assert tckpt.latest_checkpoint(str(tmp_path / "none")) is None
