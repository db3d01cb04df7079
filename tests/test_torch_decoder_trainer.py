"""The port's stage-2 trainer end to end on the CPU (tiny shapes), mirroring
tests/test_decoder_trainer.py: a dozen iterations on the synthetic dataset
with both evaluation cadences, save and resume, the RQ-VAE checkpoint contract,
the config files and the dataset views against the JAX package's.
"""

import inspect

import numpy as np
import pytest
import torch

from rqvae_tpu.data import datasets as jdata
from rqvae_tpu.data import synthetic as jsyn
from rqvae_tpu.utils import config as jconfig

from rqvae_tpu_torch.data import datasets as tdata
from rqvae_tpu_torch.data import synthetic as tsyn
from rqvae_tpu_torch.data.registry import DATASET_MAX_SEQ_LEN, RecDataset, ensure_dataset
from rqvae_tpu_torch.models.quantize import QuantizeForwardMode
from rqvae_tpu_torch.models.retrieval import RetrievalConfig
from rqvae_tpu_torch.models.rqvae import RqVae, RqVaeConfig
from rqvae_tpu_torch.train import train_decoder
from rqvae_tpu_torch.train.train_decoder import step_generator, step_rows, train
from rqvae_tpu_torch.utils import checkpoint as ckpt
from rqvae_tpu_torch.utils import config as tconfig
from rqvae_tpu_torch.utils.convert import jax_params_from_state_dict

VAE = dict(vae_input_dim=64, vae_n_cat_feats=0, vae_hidden_dims=[32], vae_embed_dim=8, vae_codebook_size=16,
           vae_n_layers=3)
SMALL = dict(batch_size=16, dataset=RecDataset.SYNTHETIC, t5_d_model=32, t5_num_heads=4, t5_d_ff=64,
             t5_num_layers=1, top_k_for_generation=5, warmup_steps=5, device="cpu", **VAE)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads, and several test
    workers that each start a thread per core slow one another down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rqvae_checkpoint(tmp_path_factory):
    """A frozen RQ-VAE in the port's checkpoint format, codebooks spread over
    the synthetic items so that the index holds many tuples."""
    root = tmp_path_factory.mktemp("rq")
    ds = str(root / "ds")
    data = ensure_dataset(ds, RecDataset.SYNTHETIC)
    cfg = RqVaeConfig(input_dim=64, embed_dim=8, hidden_dims=(32,), codebook_size=16, n_layers=3, n_cat_feats=0,
                      codebook_mode=QuantizeForwardMode.STE)
    rq = RqVae(cfg, device="cpu", seed=0)
    x = torch.from_numpy(data["item_features"])
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        res = rq.encode(x)
        for level in range(3):
            cb = res[torch.randperm(len(res), generator=g)[:16]]
            rq.codebooks[level].copy_(cb)
            res = res - cb[torch.cdist(res, cb).argmin(1)]
    return ds, ckpt.save_checkpoint(str(root / "ckpt"), 19, rq.state_dict(), None, cfg)


def test_end_to_end_with_rqvae_checkpoint(tmp_path, rqvae_checkpoint):
    ds, rq_path = rqvae_checkpoint
    s2 = train(iterations=12, dataset_folder=ds, pretrained_rqvae_path=rq_path, save_dir_root=str(tmp_path / "dec"),
               t5_dropout=0.0, partial_eval_every=6, full_eval_every=12, save_model_every=12,
               full_eval_max_batches=2, log_every=4, **SMALL)
    assert np.isfinite(s2["total_loss"]) and s2["total_loss"] < 9.0  # below 3 ln 16 = 8.3 plus slack
    assert "eval_loss" in s2 and np.isfinite(s2["eval_loss"])
    assert "h@5" in s2 and 0.0 <= s2["h@1"] <= s2["h@5"] <= 1.0 and 0.0 <= s2["ndcg"] <= 1.0
    assert s2["learning_rate"] == pytest.approx(1e-3 * (5 / 12) ** 0.5)
    assert s2["checkpoint_path"].endswith("checkpoint_11.pt") and s2["iterations_per_sec"] > 0
    assert {"loss_0", "loss_1", "loss_2", "rolling_total_loss", "train_seq_length_p50"} <= set(s2)
    restored = ckpt.load_checkpoint(s2["checkpoint_path"])
    assert isinstance(restored["config"], RetrievalConfig) and restored["config"].codebook_size == 16
    assert restored["step"] == 11 and restored["opt_state"]["count"] == 12

    # resume, with the Bernoulli dropout path and accumulation
    s3 = train(iterations=3, dataset_folder=ds, pretrained_rqvae_path=rq_path,
               pretrained_decoder_path=s2["checkpoint_path"], save_dir_root=str(tmp_path / "dec2"),
               t5_dropout=0.1, t5_hash_dropout=False, gradient_accumulate_every=2, max_grad_norm=1.0,
               partial_eval_every=1000, full_eval_every=1000, save_model_every=1000, **SMALL)
    assert np.isfinite(s3["total_loss"])
    assert s3["checkpoint_path"].endswith("checkpoint_14.pt")
    assert ckpt.latest_checkpoint(str(tmp_path / "dec2")) == s3["checkpoint_path"]


def test_resumed_run_takes_the_steps_of_an_unbroken_run(tmp_path, rqvae_checkpoint):
    """7 iterations at once against 4, a checkpoint, and 3 more (hash dropout
    on): the same parameters, bit for bit, since every step's rows, windows
    and dropout seeds are functions of (seed, step)."""
    ds, rq_path = rqvae_checkpoint
    kw = dict(dataset_folder=ds, pretrained_rqvae_path=rq_path, t5_dropout=0.1, partial_eval_every=1000,
              full_eval_every=1000, full_eval_max_batches=1, max_grad_norm=1.0, seed=3, **SMALL)
    whole = train(iterations=7, save_dir_root=str(tmp_path / "a"), save_model_every=1000, **kw)
    first = train(iterations=4, save_dir_root=str(tmp_path / "b"), save_model_every=1000, **kw)
    rest = train(iterations=3, save_dir_root=str(tmp_path / "b"), save_model_every=1000, auto_resume=True, **kw)
    assert first["checkpoint_path"].endswith("checkpoint_3.pt") and rest["checkpoint_path"].endswith("checkpoint_6.pt")
    a, b = ckpt.load_checkpoint(whole["checkpoint_path"]), ckpt.load_checkpoint(rest["checkpoint_path"])
    assert a["step"] == b["step"] == 6 and a["opt_state"]["count"] == b["opt_state"]["count"] == 7
    for name in a["params"]:
        assert torch.equal(a["params"][name], b["params"][name]), name
    for ma, mb in zip(a["opt_state"]["nu"], b["opt_state"]["nu"]):
        assert torch.equal(ma, mb)
    assert whole["total_loss"] == rest["total_loss"]


def test_step_randomness_is_a_function_of_seed_and_step():
    assert np.array_equal(step_rows(0, 5, 100, 8), step_rows(0, 5, 100, 8))
    assert not np.array_equal(step_rows(0, 5, 100, 8), step_rows(0, 6, 100, 8))
    assert not np.array_equal(step_rows(0, 5, 100, 8), step_rows(1, 5, 100, 8))
    assert step_rows(0, 5, 100, 64).max() < 100
    a, b = torch.rand(4, generator=step_generator(2, 9)), torch.rand(4, generator=step_generator(2, 9))
    assert torch.equal(a, b) and not torch.equal(a, torch.rand(4, generator=step_generator(2, 10)))


def test_untrained_rqvae_from_seed_and_refusals(tmp_path, rqvae_checkpoint):
    s = train(iterations=2, dataset_folder=str(tmp_path / "ds"), save_dir_root=str(tmp_path / "dec"),
              partial_eval_every=1000, full_eval_every=1000, full_eval_max_batches=1, **SMALL)
    assert np.isfinite(s["total_loss"]) and "h@10" in s
    # a `.msgpack` RQ-VAE path (the JAX format, which the shipped configs name) is read: the same
    # weights in either format train the same step
    ds, rq_path = rqvae_checkpoint
    restored = ckpt.load_checkpoint(rq_path)
    rq = RqVae(restored["config"], device="cpu")
    rq.load_state_dict(restored["params"])
    jax_path = ckpt.save_checkpoint(str(tmp_path / "jaxfmt"), 19, jax_params_from_state_dict(rq),
                                    config=restored["config"], fmt="msgpack")
    runs = [train(iterations=1, dataset_folder=ds, save_dir_root=str(tmp_path / f"x{i}"), pretrained_rqvae_path=p,
                  partial_eval_every=1000, full_eval_every=1000, **SMALL) for i, p in enumerate((rq_path, jax_path))]
    assert jax_path.endswith(".msgpack") and runs[0]["total_loss"] == runs[1]["total_loss"]
    with pytest.raises(FileNotFoundError):
        train(iterations=1, dataset_folder=str(tmp_path / "ds"), save_dir_root=str(tmp_path / "x"),
              pretrained_rqvae_path="out/rqvae/checkpoint_9.msgpack", **SMALL)
    # a JAX-format file resumes a run now (tests/test_torch_optax_state.py), but an RQ-VAE's is refused
    with pytest.raises(ValueError, match="not a retrieval"):
        train(iterations=1, dataset_folder=ds, save_dir_root=str(tmp_path / "x"), pretrained_decoder_path=jax_path,
              **SMALL)
    with pytest.raises(ValueError, match="not an RQ-VAE"):
        train(iterations=1, dataset_folder=str(tmp_path / "ds"), save_dir_root=str(tmp_path / "x"),
              pretrained_rqvae_path=s["checkpoint_path"], **SMALL)
    with pytest.raises(NotImplementedError, match="not ported"):
        ensure_dataset(str(tmp_path / "amazon"), RecDataset.AMAZON)
    assert DATASET_MAX_SEQ_LEN[RecDataset.ML_32M] == 200 and ckpt.latest_checkpoint(str(tmp_path / "none")) is None


@pytest.mark.parametrize("name", ["decoder_amazon", "decoder_ml32m", "decoder_synthetic"])
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
    monkeypatch.setattr(train_decoder, "train", fake)
    train_decoder.main([path, "pretrained_rqvae_path=None", "iterations=3"])
    assert seen["pretrained_rqvae_path"] is None and seen["iterations"] == 3 and seen["batch_size"] == want["batch_size"]
    with pytest.raises(ValueError, match="Unknown config parameters"):
        tconfig.apply_config(train, path, no_such_knob=1)
    with pytest.raises(SystemExit):
        train_decoder.main([])


def test_synthetic_data_and_dataset_views_equal_the_jax_package(tmp_path):
    cfg = dict(n_items=300, n_users=60, input_dim=16, seed=4)
    want, got = jsyn.generate(jsyn.SyntheticConfig(**cfg)), tsyn.generate(tsyn.SyntheticConfig(**cfg))
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    tsyn.generate_and_save(str(tmp_path), tsyn.SyntheticConfig(**cfg))
    data = tdata.load_processed(str(tmp_path))
    assert str(data["dataset_name"]) == "synthetic"
    np.testing.assert_array_equal(tdata.ItemDataset(data, "eval").corpus_ids, jdata.ItemDataset(data, "eval").corpus_ids)
    for split, subsample in (("train", True), ("train", False), ("test", False)):
        js, ts = jdata.SeqDataset(data, split, subsample), tdata.SeqDataset(data, split, subsample)
        jb = js.sample_batch(np.random.RandomState(1), 12)
        tb = ts.sample_batch(np.random.RandomState(1), 12)
        for a, b in zip(jb, tb):
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    win = {**data, "seq_format": np.asarray("windows"), "seq_is_train": np.arange(60) % 3 != 0}
    jw, tw = jdata.SeqDataset(win, "test"), tdata.SeqDataset(win, "test")
    assert len(tw) == len(jw) == 20
    for (jb, jv), (tb, tv) in zip(jw.iter_eval_batches(8), tw.iter_eval_batches(8)):
        assert jv == tv
        np.testing.assert_array_equal(tb.ids, jb.ids)
        np.testing.assert_array_equal(tb.ids_fut, jb.ids_fut)


def test_sampled_candidate_evaluation_equals_generate_fed_the_same_noise(tmp_path, rqvae_checkpoint, monkeypatch):
    """sample_candidates=True: the full evaluation finishes, and its beams
    and metrics equal those of `generate` fed each eval batch's noise from
    the generator of (seed, 999 + bi), the counterpart of the JAX trainer's
    fold_in(root_key, 999 + bi) (whose threefry bits the port cannot draw)."""
    from rqvae_tpu_torch.data.datasets import SeqDataset
    from rqvae_tpu_torch.models.retrieval import EncoderDecoderRetrievalModel
    from rqvae_tpu_torch.ops.gumbel import sample_gumbel
    from rqvae_tpu_torch.ops.metrics import TopKAccumulator
    from rqvae_tpu_torch.serving.beam import build_prefix_table
    from rqvae_tpu_torch.tokenizer.semids import SemanticIdTokenizer
    from rqvae_tpu_torch.train.decoder_steps import make_generate_fn
    from rqvae_tpu_torch.train.step_graph import stream_generator

    ds, rq_path = rqvae_checkpoint
    beams = []

    def recording_generate_fn(model):  # the trainer's beams, recorded as they are
        generate = make_generate_fn(model)

        def run(batch, table, noise=None):
            out = generate(batch, table, noise)
            beams.append(out.sem_ids.clone())
            return out
        return run

    monkeypatch.setattr(train_decoder, "make_generate_fn", recording_generate_fn)
    s = train(iterations=2, dataset_folder=ds, pretrained_rqvae_path=rq_path, save_dir_root=str(tmp_path / "dec"),
              sample_candidates=True, full_eval_every=2, full_eval_max_batches=2, partial_eval_every=1000,
              save_model_every=1000, seed=4, **SMALL)
    assert len(beams) == 2
    restored = ckpt.load_checkpoint(s["checkpoint_path"])
    assert restored["config"].sample_candidates
    model = EncoderDecoderRetrievalModel(restored["config"], device="cpu")
    model.load_state_dict(restored["params"])
    rq = train_decoder.load_rqvae(rq_path, None, "cpu", 0)
    data = ensure_dataset(ds, RecDataset.SYNTHETIC)
    tokenizer = SemanticIdTokenizer(rq, device="cpu")
    cached = tokenizer.precompute_corpus_ids(tdata.ItemDataset(data, "all").features)
    prefix_table = build_prefix_table(cached[:, :3], 16)
    generate, acc = make_generate_fn(model), TopKAccumulator(ks=[1, 5, 10])
    for bi, (eb, valid) in enumerate(SeqDataset(data, split="test").iter_eval_batches(16, with_features=False)):
        if bi >= 2:
            break
        tok = tokenizer(eb)
        g = stream_generator(4, 999 + bi)
        noise = [sample_gumbel(shape, g) for shape in model.sampling_noise_shapes(tok.sem_ids.shape[0])]
        gen = generate(tok, prefix_table, noise)
        assert torch.equal(gen.sem_ids, beams[bi])
        acc.accumulate(actual=tok.sem_ids_fut[:valid, :3], top_k=gen.sem_ids[:valid])
    want = acc.reduce()
    assert {k: s[k] for k in want} == want
    with pytest.raises(ValueError, match="Gumbel noise"):
        generate(tok, prefix_table)


def _jax_decoder_kwargs(ds):
    from rqvae_tpu.data.registry import RecDataset as JRecDataset

    return dict(batch_size=8, dataset=JRecDataset.SYNTHETIC, dataset_folder=ds, t5_d_model=32, t5_num_heads=4,
                t5_d_ff=64, t5_num_layers=1, top_k_for_generation=5, warmup_steps=5, t5_dropout=0.0,
                max_grad_norm=1.0, partial_eval_every=1000, full_eval_every=1000, full_eval_max_batches=1,
                save_model_every=1000, steps_per_loop=1, **VAE)


def test_runs_resume_across_the_two_packages(tmp_path):
    """A JAX trainer's checkpoint, optax opt_state and all, resumes the
    port's trainer; a port checkpoint rewritten by export_jax_checkpoint
    resumes the JAX trainer. Each resumed run starts at the saved step + 1
    with the update count and the schedule's LR position carried over."""
    from rqvae_tpu.train import train_decoder as jtrain
    from rqvae_tpu.utils import checkpoint as jckpt

    from rqvae_tpu_torch.ops.schedules import inverse_sqrt_schedule

    ds = str(tmp_path / "ds")
    jkw = _jax_decoder_kwargs(ds)
    tkw = {**{k: v for k, v in jkw.items() if k not in ("dataset", "steps_per_loop")}, "dataset": RecDataset.SYNTHETIC,
           "device": "cpu"}
    lr_at_2 = inverse_sqrt_schedule(1e-3, 5)(2)

    j1 = jtrain.train(iterations=2, save_dir_root=str(tmp_path / "jax"), **jkw)
    assert j1["checkpoint_path"].endswith("checkpoint_1.msgpack")
    t2 = train(iterations=1, pretrained_decoder_path=j1["checkpoint_path"], save_dir_root=str(tmp_path / "port"),
               **tkw)
    got = ckpt.load_checkpoint(t2["checkpoint_path"])
    assert t2["checkpoint_path"].endswith("checkpoint_2.pt") and got["opt_state"]["count"] == 3
    assert t2["learning_rate"] == lr_at_2

    t1 = train(iterations=2, save_dir_root=str(tmp_path / "port_a"), **tkw)
    exported = ckpt.export_jax_checkpoint(t1["checkpoint_path"], str(tmp_path / "exported"), max_grad_norm=1.0)
    j2 = jtrain.train(iterations=1, pretrained_decoder_path=exported, save_dir_root=str(tmp_path / "jax_b"), **jkw)
    assert j2["checkpoint_path"].endswith("checkpoint_2.msgpack")
    jgot = jckpt.load_checkpoint(j2["checkpoint_path"])
    adam, sched = jgot["opt_state"]["1"]["0"], jgot["opt_state"]["1"]["2"]
    assert int(adam["count"]) == int(sched["count"]) == 3
    assert j2["learning_rate"] == pytest.approx(t2["learning_rate"], rel=1e-6)
