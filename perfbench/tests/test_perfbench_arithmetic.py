"""The benchmark's own arithmetic on the CPU: traffic from the seed, rates
and tails over a whole window, roofline counts against hand counts, the
trace reduction, and every file found by the name BENCHMARK.json gives."""

import json

import numpy as np
import pytest
import torch

from perfbench.harness import flops, registry, stats, traffic
from perfbench.harness.cell import Check, Result, result_line
from perfbench.harness.roofline import least_seconds
from perfbench.harness.trace import summarize

BENCH = registry.benchmark()


# ---- files by name ----

@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_is_found_by_name(cell):
    entry = registry.cell(BENCH, cell)
    spec = registry.workload(cell)
    assert spec["config"] == entry["config"] and spec["traffic"] == entry["traffic"]
    cfg = registry.config(entry["config"])
    assert cfg["name"] == entry["config"]
    tr = registry.traffic(entry["traffic"])
    assert hasattr(registry.module("drivers", tr["driver"]), "run")
    assert hasattr(registry.module("drivers", tr["driver"]), "controls")
    assert set(spec["limits"]) and all(isinstance(v, (int, float)) for v in spec["limits"].values())
    e2e = {m["name"] for m in registry.end_to_end(BENCH, cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert registry.per_layer(BENCH, cell)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(registry.module("metrics", metric).read)


@pytest.mark.parametrize("fn", ["attention_fwd", "attention_bwd", "decoder_stack", "encoder_stack"])
def test_every_roofline_has_counts_and_names(fn):
    assert callable(registry.module("rooflines", fn).work)
    assert registry.roofline_names(fn)


def test_config_files_match_benchmark_entries():
    for c in BENCH["configs"]:
        cfg = json.loads((registry.REPO / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]


def test_every_per_layer_metric_moves_a_metric_its_cells_report():
    for m in BENCH["per_layer"]:
        for cell in m["workloads"]:
            assert m["moves"] in {e["name"] for e in registry.end_to_end(BENCH, cell)}


def test_missing_file_is_named():
    with pytest.raises(FileNotFoundError, match="no-such-cell"):
        registry.workload("no-such-cell")


# ---- traffic ----

def test_lengths_follow_their_mix_and_the_seed():
    tr = registry.traffic("beauty-train")
    a, la = traffic.histories(tr, 12101, 2**31 + 7, "cpu")
    b, lb = traffic.histories(tr, 12101, 2**31 + 7, "cpu")
    c, lc = traffic.histories(tr, 12101, 2**31 + 8, "cpu")
    assert torch.equal(a, b) and torch.equal(la, lb) and not torch.equal(la, lc)
    assert int(la.min()) >= tr["length_base"] and int(la.max()) <= tr["length_max"]
    # the clip at 22 takes little off a mean of 5 + 3.88
    assert abs(float(la.float().mean()) - (tr["length_base"] + tr["length_extra_mean"])) < 0.3
    assert bool(((a >= 0).sum(1) == la).all()) and int(a.max()) < 12101


def test_poisson_due_times_offer_the_same_load_for_every_seed():
    d1 = traffic.poisson_due_times(2000.0, 10.0, 1)
    d2 = traffic.poisson_due_times(2000.0, 10.0, 2)
    assert len(d1) == len(d2) == 20000
    assert np.all(np.diff(d1) >= 0) and 0 <= d1[0] and d1[-1] < 10.0
    assert not np.array_equal(d1, d2)
    gaps = np.diff(d1)
    assert abs(gaps.std() / gaps.mean() - 1.0) < 0.05  # exponential gaps: sd equals the mean


# ---- rates and tails over the whole window ----

def test_a_planted_stall_moves_the_rate_and_the_tail():
    due = np.arange(1000) * 0.001  # 1,000 req/s for 1 s
    service = 0.002
    done = due + service
    base_p95 = stats.percentile(stats.latencies_from_due(due, done) * 1e3, 95)
    stalled = done.copy()
    stalled[500:] = np.maximum(stalled[500:], 0.7)  # the server stops from 0.5 s to 0.7 s
    stall_p95 = stats.percentile(stats.latencies_from_due(due, stalled) * 1e3, 95)
    assert base_p95 == pytest.approx(2.0)
    assert stall_p95 > 50.0
    # a rate over all the window's time sees the stall; a median of chunk rates does not
    assert stats.rate(1000, 1.0) == pytest.approx(1000.0)
    assert stats.rate(1000, 1.2) < 0.9 * stats.rate(1000, 1.0)


def test_latency_counts_from_the_due_time_not_the_submit():
    due = np.array([0.0, 0.1])
    submitted = np.array([0.05, 0.1])  # the generator ran late for the first
    done = submitted + 0.01
    assert list(stats.latencies_from_due(due, done)) == pytest.approx([0.06, 0.01])


def test_percentile_of_all_values():
    assert stats.percentile(list(range(101)), 95) == pytest.approx(95.0)
    with pytest.raises(ValueError):
        stats.percentile([], 50)


# ---- operation counts ----

def test_attention_counts_by_hand():
    shape = {"B": 640, "H": 6, "Lq": 80, "Lk": 80, "dk": 64, "dtype": "bfloat16"}
    f, b = registry.module("rooflines", "attention_fwd").work(shape)
    assert f == 2 * 2 * 640 * 6 * 80 * 80 * 64
    qkvo = 4 * 640 * 6 * 80 * 64 * 2
    assert b == qkvo + 6 * 80 * 80 * 4 + 640 * 80 * 4
    # bytes-bound at the Amazon shape: 157 MB over 3.35 TB/s
    assert least_seconds("attention_fwd", shape) == pytest.approx(b / 3.35e12)
    f, b = registry.module("rooflines", "attention_bwd").work(shape)
    assert f == 4 * 2 * 640 * 6 * 80 * 80 * 64
    assert b == 8 * 640 * 6 * 80 * 64 * 2 + 2 * 6 * 80 * 80 * 4 + 640 * 80 * 4
    ml = {"B": 64, "H": 6, "Lq": 800, "Lk": 800, "dk": 64, "dtype": "bfloat16"}
    f, _ = registry.module("rooflines", "attention_fwd").work(ml)
    assert least_seconds("attention_fwd", ml) == pytest.approx(f / 989e12)  # operations-bound at 800 keys


def test_stack_counts_by_hand():
    d, H, dk, dff, NL = 384, 6, 64, 1024, 4
    enc = {"B": 64, "L": 800, "d": d, "H": H, "dk": dk, "dff": dff, "layers": NL, "dtype": "bfloat16"}
    f, b = registry.module("rooflines", "encoder_stack").work(enc)
    per_layer = 4 * 2 * 64 * 800 * d * 384 + 2 * 2 * 64 * 6 * 800 * 800 * 64 + 2 * 2 * 64 * 800 * d * dff
    assert f == NL * per_layer
    weights = NL * (4 * d * 384 + 2 * d * dff) * 2 + NL * 2 * d * 4 + d * 4
    assert b == weights + 64 * 800 * d * 2 + 6 * 800 * 800 * 4 + 64 * 800 * 4 + 64 * 800 * d * 4
    dec = {"B": 64, "beams": 10, "T": 3, "Le": 80, "d": d, "H": H, "dk": dk, "dff": dff, "layers": NL,
           "dtype": "bfloat16"}
    f, _ = registry.module("rooflines", "decoder_stack").work(dec)
    per_pos = 8 * d * 384 + 2 * (3 + 1) * 384 + 4 * d * 384 + 4 * 80 * 384 + 4 * d * dff
    assert f == NL * 64 * 30 * per_pos


def test_frozen_step_count_is_the_programs_formula():
    t5 = {"d_model": 384, "num_heads": 6, "d_kv": 64, "d_ff": 1024, "num_layers": 4}
    got = flops.train_step_flops(t5, 3, 256, 640, 20)
    enc_len, dec_len, d, inner = 80, 4, 384, 384
    att = lambda tq, tk: 2 * tq * d * inner * 2 + 2 * tk * d * inner * 2 + 4 * tq * tk * inner  # noqa: E731
    ffn = lambda t: 4 * t * d * 1024  # noqa: E731
    fwd = 640 * (4 * (att(80, 80) + ffn(80) + att(4, 4) + att(4, 80) + ffn(4)) + 2 * 3 * d * 256)
    assert got == pytest.approx(3 * fwd)
    assert enc_len == 20 * 4 and dec_len == 3 + 1


def test_query_count_grows_with_the_history():
    t5 = {"d_model": 384, "num_heads": 6, "d_kv": 64, "d_ff": 1024, "num_layers": 4}
    short, long = flops.query_flops(t5, 3, 256, 10, 20), flops.query_flops(t5, 3, 256, 10, 200)
    assert 0 < short < long
    # the encoder at 800 tokens: about 12.7 GFLOP of the 200-item query
    assert 12e9 < long < 16e9


# ---- the trace reduction ----

def test_trace_summary_busy_idle_and_gaps():
    ms = 1_000_000
    device = [("void attention_rows_kernel<1>(P)", 0, 2 * ms), ("gemm", 1 * ms, 3 * ms),
              ("void bwd_rows_kernel<1>(P)", 5 * ms, 6 * ms)]
    host = [("cudaGraphLaunch", 2 * ms, 4 * ms), ("aten::copy_", 3 * ms, 3 * ms + 10)]
    s = summarize(device, host, (0, 10 * ms))
    assert s.window_s == pytest.approx(0.010) and s.busy_s == pytest.approx(0.004)
    assert s.idle_share == pytest.approx(0.6)
    assert s.seconds_of(["attention_rows_kernel"]) == (1, pytest.approx(0.002))
    assert s.seconds_of(["attention_kernel"])[0] == 0  # whole identifiers only
    assert s.gaps["cudaGraphLaunch"] == pytest.approx(0.002)  # the gap 3-5 ms, the host launching
    assert s.gaps["no host event"] == pytest.approx(0.004)  # 6-10 ms
    bd = s.breakdown()
    assert bd["device_ops"][0][0] == "void attention_rows_kernel<1>(P)" and len(bd["idle_gaps"]) == 2


def test_roofline_share_reads_nothing_without_its_kernels():
    from perfbench.harness.roofline import share_pct

    res = Result(e2e={}, attempted=1, failed=0, checks=[], memory_peak_bytes=0,
                 trace=summarize([("gemm", 0, 10)], [], (0, 10)),
                 extra={"calls": {"attention_fwd": [({"B": 1, "H": 1, "Lq": 16, "Lk": 16, "dk": 64,
                                                      "dtype": "bfloat16"}, 4)]}})
    assert share_pct(res, "attention_fwd") is None
    assert share_pct(res, "attention_bwd") is None


# ---- the result line ----

def test_result_line_keys_and_checks_last():
    from perfbench.harness.cell import Context

    ctx = Context("amazon-beauty.train", 1, 1.0, False, torch.device("cpu"), 0.0, {}, {}, {})
    res = Result(e2e={"setup_s": 1.5, "train_samples_per_s": 10.0}, attempted=3, failed=0,
                 checks=[Check("loss_gap", 0.1, 0.2), Check("grad_norm_gap", float("nan"), 1.0)],
                 memory_peak_bytes=7)
    line = result_line(BENCH, ctx, res, 1)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is False  # a NaN never passes
    assert line["metrics"]["train_samples_per_s"] == {"value": 10.0, "unit": "samples/s"}
    assert line["checks"]["grad_norm_gap"]["value"] == "nan"
    json.loads(json.dumps(line), parse_constant=lambda c: pytest.fail(f"non-JSON constant {c}"))
