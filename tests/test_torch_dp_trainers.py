"""Both trainers end to end on 2 real processes over gloo (tests/
torch_dist_worker.py, one launch for the module) against the same calls in
one process, on the CPU at tiny widths: `train_decoder.train` with dropout
0.1 and both evaluations, `train_rqvae.train` in Gumbel mode with restarts
and evaluations, each fresh and resumed on 2 ranks from the 1-process run's
checkpoint.

- Every step's logged loss (log_every=1) and the final checkpoint's
  parameters agree with the one-process run: losses rtol 1e-5 and
  parameters atol 1e-5 over 6 AdamW steps (one-process and two-rank sums are
  taken in another order; Adam's first steps move every parameter by about
  the LR, so a last-bit difference in a gradient moves its parameter by a
  small share of 1e-3).
- Only rank 0 writes: one log line a step and one checkpoint, as the
  one-process run writes; every rank returns the same summary, evaluation
  included; the trainers check that the ranks' parameters and moments are
  bit-equal at the end (they raise otherwise).
- A resume on 2 ranks from the one-process checkpoint continues as the
  one-process resume does (the same bounds).
"""

import json
import os

import numpy as np
import pytest
import torch

from rqvae_tpu_torch.data.registry import RecDataset, ensure_dataset
from rqvae_tpu_torch.models.quantize import QuantizeForwardMode
from rqvae_tpu_torch.models.rqvae import RqVae, RqVaeConfig
from rqvae_tpu_torch.train import train_decoder, train_rqvae
from rqvae_tpu_torch.utils import checkpoint as ckpt
from torch_dist_worker import launch

VAE = dict(vae_input_dim=64, vae_n_cat_feats=0, vae_hidden_dims=[32], vae_embed_dim=8, vae_codebook_size=16,
           vae_n_layers=3)
DEC = dict(batch_size=16, dataset="SYNTHETIC", t5_d_model=32, t5_num_heads=4, t5_d_ff=64, t5_num_layers=1,
           top_k_for_generation=5, warmup_steps=5, device="cpu", t5_dropout=0.1, log_every=1,
           partial_eval_every=3, full_eval_every=6, full_eval_max_batches=1, seed=2, **VAE)
RQ = dict(batch_size=32, learning_rate=1e-3, weight_decay=1e-4, dataset="SYNTHETIC", vae_input_dim=64,
          vae_n_cat_feats=0, vae_hidden_dims=[32], vae_embed_dim=8, vae_codebook_size=16, vae_n_layers=3,
          vae_codebook_mode="GUMBEL_SOFTMAX", kmeans_init_samples=500, device="cpu", eval_every=3,
          codebook_restart_every=3, log_every=1, seed=3)
RTOL, ATOL = 1e-5, 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _enums(kw):
    kw = dict(kw, dataset=RecDataset[kw["dataset"]])
    if "vae_codebook_mode" in kw:
        kw["vae_codebook_mode"] = QuantizeForwardMode[kw["vae_codebook_mode"]]
    return kw


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The one-process calls here, then the same calls on 2 ranks."""
    root = tmp_path_factory.mktemp("dpt")
    ds = str(root / "ds")
    data = ensure_dataset(ds, RecDataset.SYNTHETIC)
    cfg = RqVaeConfig(input_dim=64, embed_dim=8, hidden_dims=(32,), codebook_size=16, n_layers=3, n_cat_feats=0,
                      codebook_mode=QuantizeForwardMode.STE)
    rq = RqVae(cfg, device="cpu", seed=0)
    x = torch.from_numpy(data["item_features"])
    with torch.no_grad():  # codebooks on the items, so the index holds many tuples
        res = rq.encode(x)
        for level in range(3):
            cb = res[torch.randperm(len(res), generator=torch.Generator().manual_seed(level))[:16]]
            rq.codebooks[level].copy_(cb)
            res = res - cb[torch.cdist(res, cb).argmin(1)]
    rq_path = ckpt.save_checkpoint(str(root / "rq_ckpt"), 0, rq.state_dict(), None, cfg)
    dec = dict(DEC, dataset_folder=ds, pretrained_rqvae_path=rq_path)
    rqk = dict(RQ, dataset_folder=ds)

    def d(name, **kw):
        return dict(dec, save_dir_root=str(root / name), **kw)

    def r(name, **kw):
        return dict(rqk, save_dir_root=str(root / name), **kw)

    one = {
        "dec": train_decoder.train(**_enums(d("dec1", iterations=6))),
        "dec_half": train_decoder.train(**_enums(d("dec1h", iterations=3))),
        "rq": train_rqvae.train(**_enums(r("rq1", iterations=6))),
        "rq_half": train_rqvae.train(**_enums(r("rq1h", iterations=3))),
    }
    one["dec_resume"] = train_decoder.train(**_enums(d("dec1r", iterations=3,
                                                      pretrained_decoder_path=one["dec_half"]["checkpoint_path"])))
    one["rq_resume"] = train_rqvae.train(**_enums(r("rq1r", iterations=3,
                                                   pretrained_rqvae_path=one["rq_half"]["checkpoint_path"])))
    spec = {"out": str(root), "scenarios": [
        dict(kind="train_decoder", name="dec", calls=[
            d("dec2", iterations=6),
            d("dec2r", iterations=3, pretrained_decoder_path=one["dec_half"]["checkpoint_path"])]),
        dict(kind="train_rqvae", name="rq", calls=[
            r("rq2", iterations=6),
            r("rq2r", iterations=3, pretrained_rqvae_path=one["rq_half"]["checkpoint_path"])]),
    ]}
    with open(root / "spec.json", "w") as f:
        json.dump(spec, f)
    launch(2, str(root / "spec.json"), timeout=300)
    two = {sc["name"]: [torch.load(root / f"{sc['name']}.rank{k}.pt")["summaries"] for k in range(2)]
           for sc in spec["scenarios"]}
    return root, one, two


def _log(path):
    with open(os.path.join(path, "logs", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _same_summaries(a: dict, b: dict):
    for k in set(a) | set(b):
        if k != "iterations_per_sec" and not k.endswith("_ms"):  # host-clock times differ
            assert a[k] == b[k], k


def _close_runs(root, one_dir, two_dir, one_summary, two_summary):
    """Per-step logged losses and the final checkpoints, one process against
    two ranks; one log line a step in either."""
    la, lb = _log(root / one_dir), _log(root / two_dir)
    assert [r["step"] for r in la] == [r["step"] for r in lb]
    for ra, rb in zip(la, lb):
        assert set(ra) == set(rb)
        if "total_loss" in ra:
            np.testing.assert_allclose(rb["total_loss"], ra["total_loss"], rtol=RTOL)
    a, b = ckpt.load_checkpoint(one_summary["checkpoint_path"]), ckpt.load_checkpoint(two_summary["checkpoint_path"])
    assert a["step"] == b["step"] and a["opt_state"]["count"] == b["opt_state"]["count"]
    for name in a["params"]:
        np.testing.assert_allclose(b["params"][name].numpy(), a["params"][name].numpy(), atol=ATOL, rtol=0,
                                   err_msg=name)
    assert sorted(os.listdir(root / one_dir)) == sorted(os.listdir(root / two_dir))  # rank 0 alone wrote


@pytest.mark.parametrize("stage,one_key,call,one_dir,two_dir", [
    ("dec", "dec", 0, "dec1", "dec2"), ("dec", "dec_resume", 1, "dec1r", "dec2r"),
    ("rq", "rq", 0, "rq1", "rq2"), ("rq", "rq_resume", 1, "rq1r", "rq2r")])
def test_two_ranks_train_as_one_process(runs, stage, one_key, call, one_dir, two_dir):
    root, one, two = runs
    rank0, rank1 = two[stage][0][call], two[stage][1][call]
    _same_summaries(rank0, rank1)  # every rank gets the same numbers, the evaluation's too
    _close_runs(root, one_dir, two_dir, one[one_key], rank0)
    for k in ("eval_loss", "eval_total_loss"):
        if k in rank0:
            np.testing.assert_allclose(rank0[k], one[one_key][k], rtol=RTOL)
