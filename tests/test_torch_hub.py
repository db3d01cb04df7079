"""The port's local hub export and import (rqvae_tpu_torch/utils/hub.py)
against the JAX package's rqvae_tpu/utils/hub.py, on the CPU.

- The port's export is read by the JAX `load_pretrained` with its template,
  config equal and every leaf bit-equal; the JAX export is read by the port;
  the semantic IDs of both sides equal.
- `from_pretrained` in the three layouts (native; PyTorchModelHubMixin with
  model.safetensors or pytorch_model.bin; a raw reference trainer `.pt`),
  with IDs equal to the JAX `from_pretrained`'s on the same directory.
- The pure-Python `.safetensors` reader against `safetensors` itself.
- A repo id that is not a directory raises the JAX module's offline error,
  `push_to_hub` raises, and `push_vae_to_hf=True` in the stage-2 trainer
  leaves the export that the JAX `load_pretrained` reads and prints that the
  local export was kept.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rqvae_tpu.models.quantize import QuantizeForwardMode as JMode
from rqvae_tpu.models.rqvae import RqVae as JRqVae
from rqvae_tpu.models.rqvae import RqVaeConfig as JRqVaeConfig
from rqvae_tpu.utils import hub as jhub

from rqvae_tpu_torch.data.registry import RecDataset
from rqvae_tpu_torch.models.quantize import QuantizeForwardMode
from rqvae_tpu_torch.models.rqvae import RqVae, RqVaeConfig
from rqvae_tpu_torch.train import train_decoder
from rqvae_tpu_torch.utils import hub
from rqvae_tpu_torch.utils.convert import jax_params_from_state_dict, state_dict_from_jax
from tests.test_torch_import import _reference_layout_state_dict

RQ = dict(input_dim=64, embed_dim=8, hidden_dims=(32,), codebook_size=16, n_layers=3, n_cat_feats=0)


def _x(n=256, dim=64, seed=0):
    return np.random.RandomState(seed).randn(n, dim).astype(np.float32)


def _jax_ids(cfg, params, x):
    m = JRqVae(cfg)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    return np.asarray(m.apply(params, jnp.asarray(x), training=False, method=JRqVae.get_semantic_ids).sem_ids)


def _port_ids(cfg, state_dict, x):
    model = RqVae(cfg, device="cpu")
    model.load_state_dict(state_dict)
    return model.get_semantic_ids(torch.from_numpy(x)).sem_ids.numpy()


def _jax_template(cfg, x):
    return JRqVae(cfg).init({"params": jax.random.PRNGKey(0), "gumbel": jax.random.PRNGKey(1)},
                            jnp.asarray(x[:2]), 0.2, training=True)


def _assert_trees_equal(got, want):
    flat_got = state_dict_from_jax(jax.device_get(got))
    flat_want = state_dict_from_jax(jax.device_get(want))
    assert set(flat_got) == set(flat_want)
    for k, v in flat_want.items():
        assert torch.equal(flat_got[k], v), k


def test_the_ports_export_reads_in_the_jax_package(tmp_path):
    cfg = RqVaeConfig(**RQ, codebook_mode=QuantizeForwardMode.STE)
    model = RqVae(cfg, device="cpu", seed=2)
    tree = jax_params_from_state_dict(model)
    d = hub.save_pretrained(str(tmp_path / "export"), tree, cfg)
    assert sorted(os.listdir(d)) == ["config.json", "flax_model.msgpack"]
    x = _x()
    want_cfg = JRqVaeConfig(**RQ, codebook_mode=JMode.STE)
    jcfg, jparams = jhub.load_pretrained(d, params_template=_jax_template(want_cfg, x))
    assert jcfg == want_cfg
    _assert_trees_equal(jparams, tree)
    np.testing.assert_array_equal(_jax_ids(jcfg, jparams, x), _port_ids(cfg, model.state_dict(), x))
    tcfg, tparams = hub.load_pretrained(d)  # the port reads its own export as the JAX module reads it
    assert tcfg == cfg
    _assert_trees_equal(tparams, tree)


def test_the_jax_export_loads_in_the_port(tmp_path):
    jcfg = JRqVaeConfig(**RQ, codebook_mode=JMode.ROTATION_TRICK)
    x = _x(seed=1)
    params = _jax_template(jcfg, x)
    d = jhub.save_pretrained(str(tmp_path / "jax_export"), params, jcfg)
    cfg, sd = hub.from_pretrained(d)
    assert cfg == RqVaeConfig(**RQ, codebook_mode=QuantizeForwardMode.ROTATION_TRICK)
    np.testing.assert_array_equal(_port_ids(cfg, sd, x), _jax_ids(jcfg, params, x))


@pytest.mark.parametrize("weights", ["model.safetensors", "pytorch_model.bin"])
def test_from_pretrained_reads_the_mixin_layout(tmp_path, weights):
    """The layout the published reference mirror has: config.json with the
    RqVae init kwargs, and the weights in either file the mixin writes."""
    from safetensors.numpy import save_file

    jcfg = JRqVaeConfig(**RQ, codebook_mode=JMode.STE)
    sd = _reference_layout_state_dict(jcfg)
    d = tmp_path / "mirror"
    d.mkdir()
    if weights.endswith(".safetensors"):
        save_file({k: v.numpy() for k, v in sd.items()}, str(d / weights))
    else:
        torch.save(sd, str(d / weights))
    (d / "config.json").write_text(json.dumps({
        "input_dim": 64, "embed_dim": 8, "hidden_dims": [32], "codebook_size": 16, "n_layers": 3,
        "commitment_weight": 0.25, "n_cat_features": 0, "codebook_normalize": False, "codebook_sim_vq": False,
        "codebook_mode": "QuantizeForwardMode.STE"}))
    cfg, state = hub.from_pretrained(str(d))
    jcfg2, jparams = jhub.from_pretrained(str(d))
    assert cfg == RqVaeConfig(**RQ, codebook_mode=QuantizeForwardMode.STE) and jcfg2 == jcfg
    x = _x(seed=3)
    np.testing.assert_array_equal(_port_ids(cfg, state, x), _jax_ids(jcfg2, jparams, x))


def test_from_pretrained_reads_a_raw_reference_checkpoint(tmp_path):
    jcfg = JRqVaeConfig(**RQ, codebook_mode=JMode.STE)
    sd = _reference_layout_state_dict(jcfg)
    d = tmp_path / "ckpts"
    d.mkdir()
    torch.save({"iter": 7, "model": sd, "model_config": {
        "input_dim": 64, "embed_dim": 8, "hidden_dims": [32], "codebook_size": 16, "n_layers": 3,
        "n_cat_features": 0, "codebook_mode": "STE"}}, str(d / "checkpoint_7.pt"))
    cfg, state = hub.from_pretrained(str(d))
    jcfg2, jparams = jhub.from_pretrained(str(d))
    assert cfg.input_dim == 64 and cfg.codebook_mode == QuantizeForwardMode.STE
    assert state["codebooks"].shape == (3, 16, 8)
    x = _x(seed=4)
    np.testing.assert_array_equal(_port_ids(cfg, state, x), _jax_ids(jcfg2, jparams, x))


def test_repo_ids_empty_directories_and_the_push_raise(tmp_path):
    with pytest.raises(RuntimeError, match="downloading"):
        hub.from_pretrained("edobotta/rqvae-amazon-beauty")
    with pytest.raises(FileNotFoundError, match="no loadable model"):
        hub.from_pretrained(str(tmp_path))
    with pytest.raises(RuntimeError, match="no hub client"):
        hub.push_to_hub(str(tmp_path), "someone/rqvae")


def test_safetensors_reader_against_safetensors(tmp_path):
    from safetensors.numpy import save_file
    from safetensors.torch import save_file as save_torch

    r = np.random.RandomState(5)
    arrays = {"f32": r.randn(3, 4).astype(np.float32), "f64": r.randn(5).astype(np.float64),
              "f16": r.randn(2, 2, 2).astype(np.float16), "i64": r.randint(-9, 9, (4,)).astype(np.int64),
              "i32": r.randint(-9, 9, (2, 3)).astype(np.int32), "i16": r.randint(-9, 9, (3,)).astype(np.int16),
              "i8": r.randint(-9, 9, (3,)).astype(np.int8), "u8": r.randint(0, 255, (6,)).astype(np.uint8),
              "bool": r.rand(5) > 0.5, "scalar": np.full((), 3.5, np.float32),
              "empty": np.zeros((0, 3), np.float32)}
    save_file(arrays, str(tmp_path / "a.safetensors"), metadata={"format": "np"})
    got = hub.read_safetensors(str(tmp_path / "a.safetensors"))
    assert set(got) == set(arrays)
    for k, v in arrays.items():
        assert got[k].shape == v.shape and np.array_equal(got[k].numpy(), v), k
    bf16 = {"w": torch.randn(4, 6, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)}
    save_torch(bf16, str(tmp_path / "b.safetensors"))
    w = hub.read_safetensors(str(tmp_path / "b.safetensors"))["w"]
    assert w.dtype == torch.bfloat16 and torch.equal(w, bf16["w"])
    (tmp_path / "bad.safetensors").write_bytes((1000).to_bytes(8, "little") + b"{}")
    with pytest.raises(ValueError, match="header"):
        hub.read_safetensors(str(tmp_path / "bad.safetensors"))


def test_push_vae_to_hf_keeps_the_local_export(tmp_path, capsys):
    kw = dict(iterations=1, batch_size=8, dataset=RecDataset.SYNTHETIC, dataset_folder=str(tmp_path / "ds"),
              vae_input_dim=64, vae_n_cat_feats=0, vae_hidden_dims=[32], vae_embed_dim=8, vae_codebook_size=16,
              vae_n_layers=3, t5_d_model=32, t5_num_heads=4, t5_d_ff=64, t5_num_layers=1, top_k_for_generation=5,
              partial_eval_every=1000, full_eval_every=1000, full_eval_max_batches=1, device="cpu")
    train_decoder.train(push_vae_to_hf=True, save_dir_root=str(tmp_path / "dec"), **kw)
    export = str(tmp_path / "dec" / "rqvae_export")
    out = capsys.readouterr().out
    assert "[hub] push failed" in out and f"local export kept at {export}" in out
    cfg = RqVaeConfig(**RQ, codebook_mode=QuantizeForwardMode.STE)  # the trainer's RQ-VAE, from its seed
    x = _x(seed=6)
    jcfg, jparams = jhub.load_pretrained(export, params_template=_jax_template(
        JRqVaeConfig(**RQ, codebook_mode=JMode.STE), x))
    assert jcfg == JRqVaeConfig(**RQ, codebook_mode=JMode.STE)
    model = RqVae(cfg, device="cpu", seed=0)
    np.testing.assert_array_equal(_jax_ids(jcfg, jparams, x), _port_ids(cfg, model.state_dict(), x))
    tcfg, state = hub.from_pretrained(export)
    assert tcfg == cfg and all(torch.equal(state[k], v) for k, v in model.state_dict().items())
