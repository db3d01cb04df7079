"""The port's stage-1 trainer end to end on the CPU (tiny shapes): a dozen
iterations on the in-repo synthetic dataset with the eval and restart
cadences, the JAX trainer's summary keys, save and resume bit for bit, the
checkpoint the stage-2 trainer reads, the CLI on configs/rqvae_synthetic.gin,
and the shipped stage-1 config files binding to the trainer as they bind to
the JAX one.
"""

import inspect
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rqvae_tpu.train import train_rqvae as jtrain
from rqvae_tpu.utils import config as jconfig

from rqvae_tpu_torch.data.registry import RecDataset
from rqvae_tpu_torch.models.quantize import QuantizeForwardMode
from rqvae_tpu_torch.models.rqvae import RqVaeConfig
from rqvae_tpu_torch.ops.schedules import gumbel_temperature_at
from rqvae_tpu_torch.train import train_decoder, train_rqvae
from rqvae_tpu_torch.train.train_rqvae import stream_generator, train
from rqvae_tpu_torch.utils import checkpoint as ckpt
from rqvae_tpu_torch.utils import config as tconfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(batch_size=32, learning_rate=1e-3, weight_decay=1e-4, dataset=RecDataset.SYNTHETIC, vae_input_dim=64,
             vae_n_cat_feats=0, vae_hidden_dims=[32], vae_embed_dim=8, vae_codebook_size=16, vae_n_layers=3,
             vae_codebook_mode=QuantizeForwardMode.STE, kmeans_init_samples=500, device="cpu")
# the summary keys of rqvae_tpu.train.train_rqvae.train at these settings
JAX_KEYS = {"total_loss", "reconstruction_loss", "rqvae_loss", "p_unique_ids", "gumbel_t", "emb_avg_norm_0",
            "emb_avg_norm_1", "emb_avg_norm_2", "eval_total_loss", "eval_reconstruction_loss", "eval_rqvae_loss",
            "codebook_usage_0", "codebook_usage_1", "codebook_usage_2", "rqvae_entropy", "max_id_duplicates",
            "iterations_per_sec", "checkpoint_path"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return str(tmp_path_factory.mktemp("ds"))


def test_train_runs_with_the_jax_trainers_summary(tmp_path, dataset):
    s = train(iterations=12, eval_every=6, codebook_restart_every=6, log_every=4, dataset_folder=dataset,
              save_dir_root=str(tmp_path / "rq"), **SMALL)
    assert JAX_KEYS <= set(s), JAX_KEYS - set(s)
    for k, v in s.items():
        if isinstance(v, float):
            assert np.isfinite(v), k
    assert 0.0 < s["codebook_usage_0"] <= 1.0 and s["rqvae_entropy"] > 0 and 0 <= s["max_id_duplicates"] < 1
    assert s["kmeans_init_ms"] > 0 and s["index_build_ms"] > 0 and s["gumbel_t"] == pytest.approx(0.2)
    assert s["checkpoint_path"].endswith("checkpoint_11.pt")
    restored = ckpt.load_checkpoint(s["checkpoint_path"])
    assert isinstance(restored["config"], RqVaeConfig) and restored["config"].codebook_mode == QuantizeForwardMode.STE
    assert restored["step"] == 11 and restored["opt_state"]["count"] == 12
    with open(tmp_path / "rq" / "logs" / "metrics.jsonl") as f:
        logged = f.read()
    assert logged.count("restarted_codes_0") == 1 and logged.count("rqvae_entropy") == 2  # at 6; at 6 and 12


def test_resumed_run_takes_the_steps_of_an_unbroken_run(tmp_path, dataset):
    """12 iterations at once against 4, a checkpoint, and 8 more, with a
    restart and evaluations inside: the same parameters and moments, bit for
    bit, since every step's rows and noise and every restart's draws are
    functions of (seed, step). (Gumbel mode, so that the noise is drawn.)"""
    kw = dict(eval_every=6, codebook_restart_every=6, log_every=1, dataset_folder=dataset, seed=3,
              **{**SMALL, "vae_codebook_mode": QuantizeForwardMode.GUMBEL_SOFTMAX})
    whole = train(iterations=12, save_dir_root=str(tmp_path / "a"), **kw)
    first = train(iterations=4, save_dir_root=str(tmp_path / "b"), **kw)
    rest = train(iterations=8, save_dir_root=str(tmp_path / "b"), auto_resume=True, **kw)
    assert first["checkpoint_path"].endswith("checkpoint_3.pt") and rest["checkpoint_path"].endswith("checkpoint_11.pt")
    a, b = ckpt.load_checkpoint(whole["checkpoint_path"]), ckpt.load_checkpoint(rest["checkpoint_path"])
    assert a["step"] == b["step"] == 11 and a["opt_state"]["count"] == b["opt_state"]["count"] == 12
    for name in a["params"]:
        assert torch.equal(a["params"][name], b["params"][name]), name
    for ma, mb in zip(a["opt_state"]["mu"] + a["opt_state"]["nu"], b["opt_state"]["mu"] + b["opt_state"]["nu"]):
        assert torch.equal(ma, mb)
    assert whole["total_loss"] == rest["total_loss"] and whole["rqvae_entropy"] == rest["rqvae_entropy"]
    assert "kmeans_init_ms" not in rest  # a resumed run keeps the trained codebooks


def test_the_checkpoint_feeds_the_stage2_trainer(tmp_path, dataset):
    s1 = train(iterations=3, eval_every=1000, dataset_folder=dataset, save_dir_root=str(tmp_path / "rq"), **SMALL)
    s2 = train_decoder.train(
        iterations=2, dataset_folder=dataset, dataset=RecDataset.SYNTHETIC, pretrained_rqvae_path=s1["checkpoint_path"],
        save_dir_root=str(tmp_path / "dec"), batch_size=16, t5_d_model=32, t5_num_heads=4, t5_d_ff=64,
        t5_num_layers=1, top_k_for_generation=5, warmup_steps=5, partial_eval_every=1000, full_eval_every=1000,
        full_eval_max_batches=1, device="cpu")
    assert np.isfinite(s2["total_loss"]) and s2["checkpoint_path"].endswith("checkpoint_1.pt")
    assert ckpt.load_checkpoint(s2["checkpoint_path"])["config"].codebook_size == 16


def test_anneal_follows_the_closed_form_and_amp_is_refused(tmp_path, dataset):
    kw = dict(gumbel_temperature=1.0, gumbel_anneal_rate=0.05, gumbel_min_t=0.1, gumbel_anneal_step_size=2)
    s = train(iterations=7, eval_every=1000, log_every=1, dataset_folder=dataset, save_dir_root=str(tmp_path / "rq"),
              **{**SMALL, "vae_codebook_mode": QuantizeForwardMode.GUMBEL_SOFTMAX}, **kw)
    assert s["gumbel_t"] == pytest.approx(gumbel_temperature_at(6, 1.0, 0.1, 0.05, 2)) and s["gumbel_t"] < 1.0
    # amp=True trains (bf16 products on the card); on the CPU it is the float32 run, as JAX's flag is there
    runs = [train(iterations=2, amp=amp, eval_every=1000, dataset_folder=dataset,
                  save_dir_root=str(tmp_path / f"amp{amp}"), **SMALL) for amp in (False, True)]
    assert runs[0]["total_loss"] == runs[1]["total_loss"]
    g = [torch.rand(3, generator=stream_generator(1, 777, it)) for it in (5, 5, 6)]
    assert torch.equal(g[0], g[1]) and not torch.equal(g[0], g[2])


def test_cli_runs_the_synthetic_config(tmp_path):
    cmd = [sys.executable, "-m", "rqvae_tpu_torch.train.train_rqvae", "configs/rqvae_synthetic.gin", "iterations=4",
           "eval_every=2", "batch_size=32", "kmeans_init_samples=300", 'device="cpu"',
           f'dataset_folder="{tmp_path / "ds"}"', f'save_dir_root="{tmp_path / "rq"}"']
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    run = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    assert ckpt.latest_checkpoint(str(tmp_path / "rq")).endswith("checkpoint_3.pt")


@pytest.mark.parametrize("name", ["rqvae_amazon", "rqvae_ml32m", "rqvae_synthetic", "rqvae_ml1m"])
def test_shipped_configs_bind_to_the_trainer(name, monkeypatch):
    path = f"configs/{name}.gin"
    want = jconfig.parse_config_file(path)
    got = tconfig.parse_config_file(path)
    assert set(got) == set(want)
    for k, v in want.items():
        assert (got[k].name if hasattr(v, "name") else got[k]) == (v.name if hasattr(v, "name") else v), k
    seen = {}
    fake = lambda **kw: seen.update(kw)
    fake.__signature__ = inspect.signature(train)  # apply_config checks the bindings against it
    monkeypatch.setattr(train_rqvae, "train", fake)
    train_rqvae.main([path, "iterations=3", 'device="cpu"'])
    assert seen["iterations"] == 3 and seen["device"] == "cpu" and seen["batch_size"] == want["batch_size"]
    with pytest.raises(SystemExit):
        train_rqvae.main([])


def test_signature_matches_the_jax_trainer():
    """The same knobs with the same defaults, plus `device`."""
    jp, tp = inspect.signature(jtrain.train).parameters, inspect.signature(train).parameters
    assert set(tp) - set(jp) == {"device"} and set(jp) <= set(tp)
    for name, p in jp.items():
        want, got = p.default, tp[name].default
        assert (got.name if hasattr(got, "name") else got) == (want.name if hasattr(want, "name") else want), name


def test_runs_resume_across_the_two_packages(tmp_path, dataset):
    """The JAX stage-1 trainer's checkpoint resumes the port's trainer, with
    its optax opt_state or, as the JAX trainer also resumes, without one; a
    port checkpoint rewritten by export_jax_checkpoint resumes the JAX
    trainer. Each resumed run starts at the saved step + 1 with the update
    count carried over."""
    from rqvae_tpu.data.registry import RecDataset as JRecDataset
    from rqvae_tpu.models.quantize import QuantizeForwardMode as JMode
    from rqvae_tpu.utils import checkpoint as jckpt

    kw = dict(eval_every=1000, save_model_every=1000, dataset_folder=dataset, steps_per_loop=1)
    jkw = {**SMALL, **kw, "dataset": JRecDataset.SYNTHETIC, "vae_codebook_mode": JMode.STE}
    del jkw["device"]
    j1 = jtrain.train(iterations=2, save_dir_root=str(tmp_path / "jax"), **jkw)
    assert j1["checkpoint_path"].endswith("checkpoint_1.msgpack")
    t2 = train(iterations=1, pretrained_rqvae_path=j1["checkpoint_path"], save_dir_root=str(tmp_path / "port"),
               **SMALL, **kw)
    got = ckpt.load_checkpoint(t2["checkpoint_path"])
    assert t2["checkpoint_path"].endswith("checkpoint_2.pt") and got["opt_state"]["count"] == 3

    no_opt = jckpt.load_checkpoint(j1["checkpoint_path"])
    bare = jckpt.save_checkpoint(str(tmp_path / "bare"), 4, no_opt["params"], None, no_opt["config"])
    t5 = train(iterations=1, pretrained_rqvae_path=bare, save_dir_root=str(tmp_path / "port_bare"), **SMALL, **kw)
    got = ckpt.load_checkpoint(t5["checkpoint_path"])
    assert t5["checkpoint_path"].endswith("checkpoint_5.pt") and got["opt_state"]["count"] == 1

    t1 = train(iterations=2, save_dir_root=str(tmp_path / "port_a"), **SMALL, **kw)
    exported = ckpt.export_jax_checkpoint(t1["checkpoint_path"], str(tmp_path / "exported"))
    j2 = jtrain.train(iterations=1, pretrained_rqvae_path=exported, save_dir_root=str(tmp_path / "jax_b"), **jkw)
    assert j2["checkpoint_path"].endswith("checkpoint_2.msgpack")
    adam = jckpt.load_checkpoint(j2["checkpoint_path"])["opt_state"]["0"]
    assert int(adam["count"]) == 3
