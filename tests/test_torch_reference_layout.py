"""The reference PyTorch layout to and from the port's state_dicts
(rqvae_tpu_torch/utils/torch_import.py, torch_export.py), held to the JAX
package's utils/torch_import.py and torch_export.py on the same weights: the
RQ-VAE both ways (with and without SimVQ), the reference trainer's `.pt`
files both ways, the retrieval model's HF-T5 layout, and the forms in which
the reference's files hold `codebook_mode`.
"""

import enum

import numpy as np
import pytest
import torch

from rqvae_tpu.models import retrieval as jr
from rqvae_tpu.models.quantize import QuantizeForwardMode as JMode
from rqvae_tpu.models.rqvae import RqVaeConfig as JRqVaeConfig
from rqvae_tpu.utils import checkpoint as jckpt
from rqvae_tpu.utils import torch_export as jexport
from rqvae_tpu.utils import torch_import as jimport
from rqvae_tpu.utils.hub import _mixin_config_to_rqvae

from rqvae_tpu_torch.models import retrieval as tr
from rqvae_tpu_torch.models.quantize import QuantizeForwardMode
from rqvae_tpu_torch.models.rqvae import RqVae, RqVaeConfig
from rqvae_tpu_torch.utils import checkpoint as tckpt
from rqvae_tpu_torch.utils import torch_export, torch_import
from rqvae_tpu_torch.utils.convert import jax_params_from_state_dict, state_dict_from_jax
from tests.test_torch_import import _reference_layout_state_dict

RQ = dict(input_dim=24, embed_dim=8, hidden_dims=(16, 12), codebook_size=16, n_layers=3, n_cat_feats=0)
DEC = dict(num_hierarchies=3, codebook_size=16, t5_d_model=32, t5_d_kv=8, t5_num_heads=4, t5_d_ff=64,
           t5_num_layers=2, top_k_for_generation=5, num_user_bins=7)


def _reference_sd(sim_vq: bool):
    sd = _reference_layout_state_dict(JRqVaeConfig(**RQ))
    if sim_vq:
        g = torch.Generator().manual_seed(1)
        for l in range(RQ["n_layers"]):
            sd[f"layers.{l}.out_proj.0.weight"] = torch.randn(RQ["embed_dim"], RQ["embed_dim"], generator=g)
    return sd


def _assert_same(got: dict, want: dict):
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], torch.as_tensor(np.asarray(v))), k


@pytest.mark.parametrize("sim_vq", [False, True])
def test_import_equals_the_jax_import(sim_vq):
    sd = _reference_sd(sim_vq)
    got = torch_import.rqvae_params_from_torch_state(sd, RQ["n_layers"])
    _assert_same(got, state_dict_from_jax(jimport.rqvae_params_from_torch_state(sd, RQ["n_layers"])))
    model = RqVae(RqVaeConfig(**RQ, sim_vq=sim_vq), device="cpu")
    model.load_state_dict(got)  # every name of the port's model, strict
    # wrappers of torch.compile and DDP are stripped
    wrapped = {f"module._orig_mod.{k}": v for k, v in sd.items()}
    _assert_same(torch_import.rqvae_params_from_torch_state(torch_import.strip_wrappers(wrapped), 3), got)


@pytest.mark.parametrize("sim_vq", [False, True])
def test_export_equals_the_jax_export_and_round_trips(sim_vq):
    model = RqVae(RqVaeConfig(**RQ, sim_vq=sim_vq), device="cpu", seed=3)
    sd = model.state_dict()
    got = torch_export.torch_state_from_rqvae_params(sd, RQ["n_layers"])
    _assert_same(got, jexport.torch_state_from_rqvae_params(jax_params_from_state_dict(model), RQ["n_layers"]))
    assert set(got) >= {"encoder.mlp.0.weight", "encoder.mlp.2.weight", "encoder.mlp.4.weight"}
    _assert_same(torch_import.rqvae_params_from_torch_state(got, RQ["n_layers"]), sd)
    with pytest.raises(ValueError, match="levels"):
        torch_export.torch_state_from_rqvae_params(sd, 2)


def test_reference_checkpoints_both_ways(tmp_path):
    cfg = RqVaeConfig(**RQ, codebook_mode=QuantizeForwardMode.ROTATION_TRICK)
    model = RqVae(cfg, device="cpu", seed=4)
    path = torch_export.save_reference_checkpoint(cfg, model.state_dict(), 17, str(tmp_path / "ref.pt"))
    jcfg, jparams, jstep = jimport.load_reference_rqvae_checkpoint(path)
    assert jstep == 17 and jcfg == JRqVaeConfig(**RQ, codebook_mode=JMode.ROTATION_TRICK)
    _assert_same(model.state_dict(), state_dict_from_jax(jparams))
    tcfg, tsd, tstep = torch_import.load_reference_rqvae_checkpoint(path)
    assert (tcfg, tstep) == (cfg, 17)
    _assert_same(tsd, model.state_dict())
    # a file the JAX package's exporter wrote reads the same
    jpath = jexport.save_reference_checkpoint(jcfg, jparams, 5, str(tmp_path / "jax_ref.pt"))
    tcfg, tsd, tstep = torch_import.load_reference_rqvae_checkpoint(jpath)
    assert (tcfg, tstep) == (cfg, 5)
    _assert_same(tsd, model.state_dict())



@pytest.mark.parametrize("fmt", ["pt", "msgpack"])
def test_export_checkpoint_equals_the_jax_export(tmp_path, fmt):
    """The CLI's function on a port checkpoint (either format) writes the
    file that the JAX package's export_checkpoint writes from its own."""
    cfg = RqVaeConfig(**RQ, codebook_mode=QuantizeForwardMode.STE)
    model = RqVae(cfg, device="cpu", seed=8)
    params = model.state_dict() if fmt == "pt" else jax_params_from_state_dict(model)
    src = tckpt.save_checkpoint(str(tmp_path / "port"), 9, params, config=cfg, fmt=fmt)
    got = torch.load(torch_export.export_checkpoint(src, str(tmp_path / "port.pt")), weights_only=True)
    jsrc = jckpt.save_checkpoint(str(tmp_path / "jax"), 9, jax_params_from_state_dict(model),
                                 config=JRqVaeConfig(**RQ, codebook_mode=JMode.STE))
    want = torch.load(jexport.export_checkpoint(jsrc, str(tmp_path / "jax.pt")), weights_only=True)
    assert got["iter"] == want["iter"] == 9 and got["model_config"] == want["model_config"]
    _assert_same(got["model"], want["model"])
    dec = tckpt.save_checkpoint(str(tmp_path / "dec"), 1, {}, config=tr.RetrievalConfig(**DEC))
    with pytest.raises(ValueError, match="no RqVaeConfig"):
        torch_export.export_checkpoint(dec, str(tmp_path / "dec.pt"))

def test_retrieval_state_equals_the_jax_export():
    cfg = tr.RetrievalConfig(**DEC)
    model = tr.EncoderDecoderRetrievalModel(cfg, device="cpu", seed=6)
    got = torch_export.reference_retrieval_state_from_params(model.state_dict(), cfg)
    want = jexport.reference_retrieval_state_from_params(jax_params_from_state_dict(model), jr.RetrievalConfig(**DEC))
    _assert_same(got, want)
    assert "user_embedding.weight" in got and "decoder_mlp.2.weight" in got


class _RefMode(enum.Enum):  # the reference's own enum, pickled with its files
    STE = 1
    ROTATION_TRICK = 2


@pytest.mark.parametrize("mode,want", [
    (None, QuantizeForwardMode.GUMBEL_SOFTMAX), ("STE", QuantizeForwardMode.STE),
    ("QuantizeForwardMode.ROTATION_TRICK", QuantizeForwardMode.ROTATION_TRICK),
    ("gumbel_softmax", QuantizeForwardMode.GUMBEL_SOFTMAX), ({"name": "STE"}, QuantizeForwardMode.STE),
    (_RefMode.ROTATION_TRICK, QuantizeForwardMode.ROTATION_TRICK),
    (QuantizeForwardMode.STE.value, QuantizeForwardMode.STE)])
def test_reference_config_forms(mode, want):
    raw = {"input_dim": 24, "embed_dim": 8, "hidden_dims": [16, 12], "codebook_size": 16, "n_layers": 3,
           "n_cat_features": 2, "codebook_sim_vq": True, "codebook_mode": mode}
    cfg = torch_import.rqvae_config_from_reference(raw)
    assert cfg.codebook_mode == want and cfg.hidden_dims == (16, 12) and cfg.n_cat_feats == 2 and cfg.sim_vq
    if not isinstance(mode, _RefMode):  # the JAX hub's reader takes the other forms too
        assert _mixin_config_to_rqvae(raw).codebook_mode.name == want.name
