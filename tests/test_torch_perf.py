"""The port's step-time and MFU accounting on the CPU: utils/flops.py equal to
rqvae_tpu/utils/flops.py on a grid of shapes, train/perf.py's differential
timing against a fake clock and its two measures at tiny sizes (the returned
keys; the times are the CPU's and say nothing of the card),
utils/debug.py's finite checks and RQVAE_TPU_DEBUG, utils/profiling.py.
"""

import itertools
import json
import os

import pytest
import torch

from rqvae_tpu.utils import flops as jflops

from rqvae_tpu_torch.data.registry import RecDataset
from rqvae_tpu_torch.train import perf, train_rqvae
from rqvae_tpu_torch.utils import debug, flops, profiling


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_flop_counts_equal_the_jax_package():
    for batch, dims, embed, K, L in itertools.product((1, 64, 640), ((512, 256, 128), (32,), ()), (16, 32, 64),
                                                     (32, 256), (1, 3)):
        args = (batch, 768, dims, embed, K, L)
        assert flops.rqvae_fwd_flops(*args) == jflops.rqvae_fwd_flops(*args)
        assert flops.rqvae_train_step_flops(*args) == jflops.rqvae_train_step_flops(*args)
    for batch, enc, dec, d, H, dk, dff, NL in itertools.product((1, 64, 640), (80, 800), (4,), (128, 384), (4, 6),
                                                                (16, 64), (256, 1024), (1, 4)):
        args = (batch, enc, dec, d, H, dk, dff, NL, 256, 3)
        assert flops.retrieval_fwd_flops(*args) == jflops.retrieval_fwd_flops(*args)
        assert flops.retrieval_train_step_flops(*args) == jflops.retrieval_train_step_flops(*args)
    for t, d, inner in itertools.product((1, 80), (128, 384), (256, 384)):
        assert flops.t5_attention_fwd_flops(t, 2 * t, d, inner) == jflops.t5_attention_fwd_flops(t, 2 * t, d, inner)
        assert flops.t5_ffn_fwd_flops(t, d, 4 * d) == jflops.t5_ffn_fwd_flops(t, d, 4 * d)
    assert flops.mlp_fwd_flops(8, [4, 5, 6]) == jflops.mlp_fwd_flops(8, [4, 5, 6]) == 2 * 8 * (20 + 30)
    # the card's peaks only, and MFU against them
    assert flops.PEAK_FLOPS == {"h100_sxm_bf16": 989e12, "h100_sxm_f32": 67e12}
    assert flops.mfu(989e12, 1.0) == 1.0 and flops.mfu(67e12, 2.0, "h100_sxm_f32") == 0.5
    f = flops.retrieval_train_step_flops(640, 80, 4, 384, 6, 64, 1024, 4, 256, 3)
    assert 2.2e12 < f < 2.3e12  # an Amazon stage-2 step, 2.24 TFLOP


class _FakeClock:
    """A clock that a run(r) advances by a fixed cost plus r steps."""

    def __init__(self, per_step, fixed):
        self.now, self.per_step, self.fixed = 0.0, per_step, fixed
        self.calls = []

    def __call__(self):
        return self.now

    def run(self, r):
        self.calls.append(r)
        self.now += self.fixed + self.per_step * r


def test_differential_time_cancels_the_fixed_cost():
    clock = _FakeClock(per_step=0.004, fixed=0.25)
    got = perf.differential_time(clock.run, r1=5, r2=55, reps=3, clock=clock)
    assert got == pytest.approx(0.004, rel=1e-9)
    assert clock.calls == [5, 55] + [5, 55] * 3  # warm-up, then the trip counts interleaved
    flat = _FakeClock(per_step=0.0, fixed=0.1)
    with pytest.raises(RuntimeError, match="differential timing failed"):
        perf.differential_time(flat.run, r1=1, r2=3, reps=2, clock=flat)


def test_measures_return_the_jax_packages_keys():
    s1 = perf.measure_stage1_step(batch=16, input_dim=24, hidden_dims=(16,), embed_dim=8, codebook_size=8,
                                  n_items=64, r1=2, r2=6, device="cpu")
    assert {"seconds_per_step", "examples_per_sec", "flops_per_step", "mfu", "peak", "batch"} <= set(s1)
    assert s1["peak"] == "h100_sxm_bf16" and s1["device"] == "cpu" and s1["seconds_per_step"] > 0
    assert s1["flops_per_step"] == jflops.rqvae_train_step_flops(16, 24, (16,), 8, 8, 3)
    s2 = perf.measure_stage2_step(batch=4, max_seq_len=4, d_model=32, num_heads=2, d_kv=16, d_ff=64, num_layers=1,
                                  codebook_size=8, n_rows=40, n_corpus=50, dtype="float32", r1=1, r2=3,
                                  device="cpu")
    assert s2["enc_len"] == 16 and s2["flops_per_step"] == jflops.retrieval_train_step_flops(
        4, 16, 4, 32, 2, 16, 64, 1, 8, 3)
    assert s2["examples_per_sec"] == pytest.approx(4 / s2["seconds_per_step"])
    # bf16=True is the amp route; on the CPU it is the float32 step (the JAX flag changes nothing there)
    s1_amp = perf.measure_stage1_step(batch=16, input_dim=24, hidden_dims=(16,), embed_dim=8, codebook_size=8,
                                      n_items=64, r1=2, r2=6, bf16=True, device="cpu")
    s2_amp = perf.measure_stage2_step(batch=4, max_seq_len=4, d_model=32, num_heads=2, d_kv=16, d_ff=64,
                                      num_layers=1, codebook_size=8, n_rows=40, n_corpus=50, dtype="float32",
                                      bf16=True, r1=1, r2=3, device="cpu")
    for amp_row, row in ((s1_amp, s1), (s2_amp, s2)):
        assert amp_row["flops_per_step"] == row["flops_per_step"] and amp_row["peak"] == "h100_sxm_bf16"
        assert amp_row["seconds_per_step"] > 0 and 0 < amp_row["mfu"]


def test_assert_finite_raises_on_a_nan():
    debug.assert_finite({"loss": torch.tensor(1.0), "loss_d": [torch.ones(3)], "lr": 1e-3, "step": 4})
    with pytest.raises(FloatingPointError, match="ctx:loss_d/0"):
        debug.assert_finite({"loss": 1.0, "loss_d": [torch.tensor([1.0, float("nan")])]}, "ctx")
    with pytest.raises(FloatingPointError, match="total_loss"):
        debug.assert_finite({"total_loss": float("inf")})
    debug.assert_finite({"ids": torch.tensor([1, 2])})  # integers are not checked


def test_debug_mode_turns_on_anomaly_detection_and_eager_chunks(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("RQVAE_TPU_DEBUG", "1")
    try:
        s = train_rqvae.train(iterations=4, log_every=2, eval_every=1000, save_model_every=1000,
                              dataset_folder=str(tmp_path / "ds"), dataset=RecDataset.SYNTHETIC,
                              save_dir_root=str(tmp_path / "rq"), vae_input_dim=64, vae_n_cat_feats=0,
                              vae_hidden_dims=[32], vae_embed_dim=8, vae_codebook_size=16, batch_size=8,
                              device="cpu")
        assert torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(False)
    assert "steps_per_loop 2 -> 1" in capsys.readouterr().out and s["total_loss"] > 0
    monkeypatch.setenv("RQVAE_TPU_DEBUG", "0")
    assert not debug.debug_enabled() and not debug.maybe_init_debug()


def test_profiling_harness(tmp_path):
    calls = []
    got = profiling.timeit(lambda n: calls.append(n), 3, warmup=2, runs=4)
    assert calls == [3] * 6 and set(got) == {"first_call_s", "steady_state_s", "calls_per_sec"}
    with profiling.trace(str(tmp_path / "tr")):
        with profiling.annotate("my_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.load(open(os.path.join(tmp_path, "tr", "trace.json")))["traceEvents"]
    assert any(e.get("name") == "my_region" for e in events)
