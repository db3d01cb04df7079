"""A run with the timed path broken underneath must come out not correct.

Each test skips the harness's look for a chip and drives the rest of a run
at a size a CPU test holds, under the cell's own limits (its workload file),
with one fault planted in the program: a step that leaves its state
unchanged, half of each batch left out, every replay of a chunk reading its
first staged step, a served answer altered where it is produced, a beam
search that drops the prefix constraint, keeps worse beams or repeats one.
The control (the reference, one precision below the
configuration's, in the program's place) must fail one of the cell's
numbers too. A sound run at the same size passes."""

import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from perfbench.harness import cell, registry
from perfbench.tests.test_perfbench_reference import REPO_ROOT, tiny

TRAIN_CELLS = ["amazon-beauty.train", "ml-32m.train"]
SERVE_CELLS = ["amazon-beauty.serve-poisson", "ml-32m.batch-retrieve"]


def run_cell(name, kind, dtype="float32", seed=2**31 + 21):
    torch.set_num_threads(2)
    over = tiny(t5={"dtype": dtype}, traffic={"driver": kind})
    over["limits"] = registry.workload(name)["limits"]
    return cell.run(cell.context(name, seed, 0.2, False, "cpu", time.time(), over))


def _kind(name):
    return registry.traffic(registry.workload(name)["traffic"])["driver"]


@pytest.mark.parametrize("name", TRAIN_CELLS + SERVE_CELLS)
def test_a_sound_run_is_correct(name):
    res = run_cell(name, _kind(name))
    assert res.correct, cell.check_lines(res)


@pytest.mark.parametrize("name", TRAIN_CELLS)
def test_a_step_that_leaves_its_state_unchanged_is_caught(name, monkeypatch):
    from rqvae_tpu_torch.train import state

    monkeypatch.setattr(state.AdamW, "step", lambda self: None)
    res = run_cell(name, "train")
    assert not res.correct, cell.check_lines(res)


@pytest.mark.parametrize("name", TRAIN_CELLS)
def test_half_of_the_batch_left_out_is_caught(name, monkeypatch):
    from rqvae_tpu_torch.train import decoder_steps

    whole = decoder_steps.subsample_windows_from_draws

    def half(u_start, u_end, seq_items, seq_lengths, row_idx, max_seq_len, leave_two_out=True):
        h = row_idx.shape[0] // 2  # the loss then takes the mean over the rest
        return whole(u_start[:h], u_end[:h], seq_items, seq_lengths, row_idx[:h], max_seq_len, leave_two_out)

    monkeypatch.setattr(decoder_steps, "subsample_windows_from_draws", half)
    res = run_cell(name, "train")
    assert not res.correct, cell.check_lines(res)


@pytest.mark.parametrize("name", TRAIN_CELLS)
def test_every_replay_reading_the_first_staged_step_is_caught(name, monkeypatch):
    from rqvae_tpu_torch.train import step_graph

    one_step = step_graph.StepChunks._one_step

    def slot_zero(self):
        self.index.zero_()  # the step within the chunk never moves on
        one_step(self)

    monkeypatch.setattr(step_graph.StepChunks, "_one_step", slot_zero)
    res = run_cell(name, "train")
    assert not res.correct, cell.check_lines(res)


@pytest.mark.parametrize("name", SERVE_CELLS)
@pytest.mark.parametrize("what", ["unconstrained", "worse", "repeated"])
def test_a_beam_search_that_chooses_wrong_is_caught(name, what, monkeypatch):
    from rqvae_tpu_torch.models import retrieval

    if what == "unconstrained":  # the prefix constraint's mask dropped
        valid = retrieval.valid_children
        monkeypatch.setattr(retrieval, "valid_children", lambda *a: torch.ones_like(valid(*a)))
    else:
        best = retrieval.top_k

        def wrong(x, k):
            values, idx = best(x, 2 * k) if what == "worse" else best(x, 1)
            if what == "worse":  # ranks k to 2k - 1 kept in place of the best k
                return values[..., k:], idx[..., k:]
            return values.expand(*values.shape[:-1], k), idx.expand(*idx.shape[:-1], k)  # one beam k times

        monkeypatch.setattr(retrieval, "top_k", wrong)
    res = run_cell(name, _kind(name))
    assert not res.correct, cell.check_lines(res)


@pytest.mark.parametrize("name", SERVE_CELLS)
@pytest.mark.parametrize("what", ["item", "token"])
def test_an_answer_altered_where_it_is_produced_is_caught(name, what, monkeypatch):
    from rqvae_tpu_torch.serving import retriever

    body = retriever.Retriever.shard_body

    def altered(self, i, hist, uids, noise=None):
        out = body(self, i, hist, uids, noise)
        if what == "item":
            return out._replace(item_ids=torch.where(out.item_ids >= 0, out.item_ids + 1, out.item_ids))
        sem = out.sem_ids.clone()
        sem[:, :, -1] = (sem[:, :, -1] + 1) % self.model.config.codebook_size
        return out._replace(sem_ids=sem)

    monkeypatch.setattr(retriever.Retriever, "shard_body", altered)
    res = run_cell(name, _kind(name))
    assert not res.correct, cell.check_lines(res)


@pytest.mark.parametrize("name", TRAIN_CELLS + SERVE_CELLS)
def test_the_control_fails_a_number(name):
    torch.set_num_threads(2)
    over = tiny(t5={"dtype": "bfloat16"}, traffic={"driver": _kind(name)})
    limits = registry.workload(name)["limits"]
    ctx = cell.context(name, 2**31 + 33, 0.2, False, "cpu", time.time(), over)
    res = cell.run(ctx)
    control = registry.module("drivers", _kind(name)).controls(ctx, res.extra["compared"])["control_fp8"]
    assert any(control[k] > limits[k] for k in limits), control


def test_no_card_no_result():
    """Without the card the cell asks for: a non-zero exit and no result line."""
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "amazon-beauty.train", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=REPO_ROOT, capture_output=True, text=True,
                         timeout=300, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert "correct" not in out.stdout and "needs 1 CUDA device" in out.stderr


@pytest.mark.gpu
def test_a_cell_runs_on_the_card(card):
    """One short run of the first cell on the card: correct, and its line last."""
    import json

    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "amazon-beauty.train", "--seed",
                          str(2**31 + 99), "--seconds", "1", "--trace", "0"], cwd=REPO_ROOT, capture_output=True,
                         text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert np.isfinite(line["metrics"]["train_samples_per_s"]["value"])
