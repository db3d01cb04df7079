"""DeepSeek-V2's FFN blocks in the port's retrieval T5 (rqvae_tpu_torch/
models/moe.py, the MoE stacks of models/t5.py) against the plain float32
reference tests/plain_t5_moe.py, at tiny sizes on the CPU (one torch thread).

- f32: the MoE layer, a whole forward (loss, balance loss, logits in eval
  mode) and every gradient leaf: the same sums in another order and grouping,
  rtol 1e-5 / atol 1e-5 (values) and atol 2e-5 + rtol 1e-3 (gradients, as
  tests/test_torch_decoder_steps.py holds the T5's).
- bf16: every product's operands rounded to bf16 with f32 sums and the
  result rounded once, at 7 of them in series between a value and the loss:
  loss rtol 2e-2, logits atol 0.15 (the T5's bf16 tolerances there); the
  gradients within 30% of the largest entry of each leaf's f32 gradient, as
  that file holds the T5's bf16 gradients. Routing is fed the same expert
  choices as the reference takes (the argmax of nearly tied router scores
  moves under bf16 rounding, and a choice moved is a different model).
- The share test: the four shares of 64 experts (16 each), each with the
  shared expert, add up, the shared expert counted once, to the uncut
  reference layer.
- Dropless: a router biased so that one expert takes nearly every token
  loses none; padding is routed to no expert and changes nothing.
- The balance loss's value and its gradient (it reaches the router only).
- The gates: kernels 2 and 3 refused for gated stacks, tensor parallelism
  refused; a checkpoint round trip; an old config without the new fields
  loads as T5's ReLU FFN; rqvae_tpu_torch/configs/decoder_ml32m_moe.gin binds
  to the port's trainer, whose CLI trains it at a tiny override; serving's plain route, each beam's log-probability
  against the reference's teacher-forced score.
"""

import dataclasses

import numpy as np
import pytest
import torch

from plain_t5_moe import PlainT5MoE
from rqvae_tpu_torch.data.schemas import TokenizedSeqBatch
from rqvae_tpu_torch.models import moe as tmoe
from rqvae_tpu_torch.models.retrieval import EncoderDecoderRetrievalModel, RetrievalConfig
from rqvae_tpu_torch.models.t5 import T5Stack

L, K = 3, 8
CFG = RetrievalConfig(num_hierarchies=L, codebook_size=K, t5_d_model=32, t5_d_kv=8, t5_num_heads=4, t5_d_ff=48,
                      t5_num_layers=3, t5_dropout=0.0, top_k_for_generation=4, t5_ffn="moe", t5_first_k_dense=1,
                      t5_n_experts=8, t5_experts_per_token=2, t5_expert_d_ff=16, t5_shared_d_ff=32,
                      t5_experts_held=(2, 4), t5_aux_loss_alpha=0.01)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def plain(model, cfg=CFG):
    w = {k: v.detach() for k, v in model.state_dict().items()}
    return PlainT5MoE(w, {"d_model": cfg.t5_d_model, "num_heads": cfg.t5_num_heads, "d_kv": cfg.t5_d_kv,
                          "num_layers": cfg.t5_num_layers, "first_k_dense": cfg.t5_first_k_dense,
                          "n_experts": cfg.t5_n_experts, "top_k": cfg.t5_experts_per_token,
                          "experts_held": cfg.t5_experts_held or (0, cfg.t5_n_experts),
                          "aux_loss_alpha": cfg.t5_aux_loss_alpha, "eps": 1e-6}, L, K)


def batch(B=4, N=6, seed=0):
    """A tokenized batch with padded items in two rows (ids -1 there)."""
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, K, (B, N, L), generator=g)
    mask = torch.ones(B, N, L, dtype=torch.bool)
    mask[0, -2:] = False
    mask[2, -4:] = False
    ids = torch.where(mask, ids, -1)
    fut = torch.randint(0, K, (B, L), generator=g)
    dedup = torch.zeros(B, N, 1, dtype=torch.long)
    sem = torch.cat([ids, torch.where(mask[..., :1], dedup, -1)], 2).reshape(B, -1)
    seq_mask = torch.cat([mask, mask[..., :1]], 2).reshape(B, -1)
    fut_d = torch.cat([fut, torch.zeros(B, 1, dtype=torch.long)], 1)
    tb = TokenizedSeqBatch(torch.zeros(B, dtype=torch.long), sem, fut_d, seq_mask, torch.zeros_like(sem),
                           torch.zeros_like(fut_d))
    return tb, ids, mask, fut


def _feed_choices(model, ref):
    """Make the port take the reference's expert choices, block by block."""
    it = iter(ref.chosen)
    originals = {}
    for m in model.modules():
        if isinstance(m, tmoe.MoEFFN):
            originals[m] = m.route

            def route(h, valid, m=m):
                s, _, _, _ = originals[m](h, valid)
                chosen = next(it)
                local = chosen - m.first
                held = (local >= 0) & (local < m.count) & valid[:, None]
                return s, chosen, s.gather(1, chosen), torch.where(held, local, m.count)

            m.route = route
    return originals


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_loss_and_gradients_equal_the_reference(dtype):
    cfg = dataclasses.replace(CFG, t5_dtype=dtype)
    model = EncoderDecoderRetrievalModel(cfg, device="cpu", seed=3)
    tb, ids, mask, fut = batch()
    ref = plain(model, cfg)
    w = {k: v.clone().requires_grad_(True) for k, v in ref.w.items()}
    ref.w = w
    loss_r, logits_r, aux_r = ref.forward(ids, mask, fut)
    grads_r = dict(zip(w, torch.autograd.grad(loss_r, list(w.values()), allow_unused=True)))
    if dtype == "bfloat16":
        _feed_choices(model, ref)
    out = model(tb, training=True)
    out.loss.backward()
    if dtype == "float32":
        torch.testing.assert_close(out.loss, loss_r.detach(), rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(out.aux_loss, aux_r.detach(), rtol=1e-5, atol=1e-7)
        for n, p in model.named_parameters():
            want = grads_r[n] if grads_r[n] is not None else torch.zeros_like(p)
            torch.testing.assert_close(p.grad, want, rtol=1e-3, atol=2e-5, msg=n)
        model.eval()
        with torch.no_grad():
            torch.testing.assert_close(model(tb).logits, logits_r.detach(), rtol=1e-5, atol=1e-4)
    else:
        torch.testing.assert_close(out.loss, loss_r.detach(), rtol=2e-2, atol=0.0)
        torch.testing.assert_close(out.logits.float(), logits_r.detach(), rtol=0.0, atol=0.15)
        for n, p in model.named_parameters():
            want = grads_r[n] if grads_r[n] is not None else torch.zeros_like(p)
            scale = float(want.abs().max()) or 1.0
            assert float((p.grad.float() - want).abs().max()) <= 0.3 * scale, n
    counts = out.moe_counts["encoder"]
    assert int(counts[0]) == 2 * int(tb.seq_mask.sum())  # the valid tokens, in each of the 2 MoE blocks
    assert 0 < int(counts[1]) <= 2 * int(counts[0]) and int(counts[2]) <= int(counts[1])


def _layer(first, count, E=64, k=6, d=16, f=8, fs=24, seed=0):
    layer = tmoe.MoEFFN(d, E, k, f, fs, (first, count), 0.001)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.3)
    return layer


def test_four_shares_add_up_to_the_uncut_layer():
    E, d, f = 64, 16, 8
    g = torch.Generator().manual_seed(1)
    x = torch.randn(3, 10, d, generator=g)
    full = {n: torch.randn(E, *s, generator=g) * 0.3 for n, s in (("w_gate", (d, f)), ("w_up", (d, f)),
                                                                   ("w_down", (f, d)))}
    shares = []
    for first in (0, 16, 32, 48):
        layer = _layer(first, 16)
        with torch.no_grad():
            for n, t in full.items():
                getattr(layer, n).copy_(t[first:first + 16])
        y, _ = layer(x, torch.float32)
        shares.append(y)
    shared = layer.shared(x.reshape(-1, d), torch.float32).reshape(x.shape)
    total = sum(shares) - 3 * shared  # each share carries the shared expert: count it once
    state = {n: v.detach() for n, v in layer.state_dict().items() if not n.startswith("w_")}
    state.update({n: full[n] for n in full})
    ref = PlainT5MoE({f"l.{n}": v for n, v in state.items()},
                     {"top_k": 6, "experts_held": (0, E), "n_experts": E, "aux_loss_alpha": 0.0,
                      "d_model": d, "num_heads": 1, "d_kv": d}, L, K)
    want = ref.moe("l.", x, torch.ones(3, 10, dtype=torch.bool))
    torch.testing.assert_close(total, want, rtol=1e-5, atol=1e-5)


def test_dropless_under_imbalance_and_padding_routed_nowhere():
    E, d = 64, 16
    layer = _layer(0, 16, seed=2)
    with torch.no_grad():
        layer.router[5] += 5.0  # expert 5 outscores the rest for nearly every token
    g = torch.Generator().manual_seed(4)
    x = torch.randn(4, 12, d, generator=g).abs()  # same-signed rows: the bias wins
    mask = torch.ones(4, 12, dtype=torch.bool)
    mask[1, 7:] = False
    y, stats = layer(x, torch.float32, mask, training=True)
    ref = PlainT5MoE({f"l.{n}": v.detach() for n, v in layer.state_dict().items()},
                     {"top_k": 6, "experts_held": (0, 16), "n_experts": E, "aux_loss_alpha": 0.001, "d_model": d,
                      "num_heads": 1, "d_kv": d}, L, K)
    want = ref.moe("l.", x, mask)
    assert float((stats.chosen[:, 0] == 5).float().mean()) > 0.9  # one expert takes nearly every token
    rows = (stats.chosen[mask.reshape(-1)] < 16).sum()
    assert int(stats.counts[0]) == int(mask.sum()) and int(stats.counts[1]) == int(rows)  # no row dropped
    torch.testing.assert_close(y[mask], want[mask], rtol=1e-5, atol=1e-5)
    shared = layer.shared(x.reshape(-1, d), torch.float32).reshape(x.shape)
    torch.testing.assert_close(y[~mask], shared[~mask])  # padding: the shared expert only
    x2 = x.clone()
    x2[~mask] = 100.0  # padding's values reach no other token and no count
    y2, stats2 = layer(x2, torch.float32, mask, training=True)
    torch.testing.assert_close(y2[mask], y[mask])
    assert torch.equal(stats2.counts, stats.counts) and torch.equal(stats2.aux_loss, stats.aux_loss)


def test_balance_loss_value_and_gradient():
    E, d = 64, 16
    layer = _layer(16, 16, seed=5)
    g = torch.Generator().manual_seed(6)
    x = torch.randn(3, 9, d, generator=g)
    mask = torch.ones(3, 9, dtype=torch.bool)
    mask[2, 4:] = False
    _, stats = layer(x, torch.float32, mask, training=True)
    ref = PlainT5MoE({f"l.{n}": v.detach().clone().requires_grad_(n == "router")
                      for n, v in layer.state_dict().items()},
                     {"top_k": 6, "experts_held": (16, 16), "n_experts": E, "aux_loss_alpha": 0.001, "d_model": d,
                      "num_heads": 1, "d_kv": d}, L, K)
    ref.moe("l.", x, mask)
    torch.testing.assert_close(stats.aux_loss, ref.aux[0], rtol=1e-6, atol=1e-9)
    got = torch.autograd.grad(stats.aux_loss, list(layer.parameters()), allow_unused=True)
    names = [n for n, _ in layer.named_parameters()]
    assert all(gr is None for n, gr in zip(names, got) if n != "router")  # only the router's scores carry it
    want = torch.autograd.grad(ref.aux[0], [ref.w["l.router"]])[0]
    torch.testing.assert_close(got[names.index("router")], want, rtol=1e-5, atol=1e-9)
    _, eval_stats = layer(x, torch.float32, mask, training=False)
    assert float(eval_stats.aux_loss) == 0.0


def test_stack_kernels_refuse_gated_ffns():
    cfg = dataclasses.replace(CFG, t5_fused_decode="on", t5_fused_encode="on").t5
    assert not T5Stack(cfg, is_decoder=True).use_fused_decode(8)
    assert not T5Stack(cfg).use_fused_encode(4096)
    relu = dataclasses.replace(cfg, ffn="relu")
    assert T5Stack(relu, is_decoder=True).use_fused_decode(8) and T5Stack(relu).use_fused_encode(4096)


def test_tensor_parallelism_refuses_moe_stacks():
    from rqvae_tpu_torch.parallel import tp
    from rqvae_tpu_torch.parallel.mesh import ProcessMesh

    model = EncoderDecoderRetrievalModel(CFG, device="cpu")
    with pytest.raises(ValueError, match="t5_ffn='moe'"):
        tp.shard_params(ProcessMesh(1, 2, None, tp.ModelShard(0, 2)), model)


def test_moe_layer_refuses_no_shared_expert():
    with pytest.raises(ValueError, match="shared expert"):
        tmoe.MoEFFN(16, 8, 2, 8, 0, (0, 4), 0.0)
    with pytest.raises(ValueError, match="shared expert"):
        EncoderDecoderRetrievalModel(dataclasses.replace(CFG, t5_shared_d_ff=0), device="cpu")


def test_unseeded_model_takes_every_parameter_from_its_state_dict():
    model = EncoderDecoderRetrievalModel(CFG, device="cpu", seed=3)
    bare = EncoderDecoderRetrievalModel(CFG, device="cpu", seed=None)  # no init for the load to replace
    bare.load_state_dict(model.state_dict())
    tb = batch()[0]
    torch.testing.assert_close(bare(tb).loss, model(tb).loss, rtol=0.0, atol=0.0)


def test_checkpoint_round_trip_and_old_configs(tmp_path):
    from rqvae_tpu_torch.utils import checkpoint as ckpt

    model = EncoderDecoderRetrievalModel(CFG, device="cpu", seed=7)
    path = ckpt.save_checkpoint(str(tmp_path), 3, model.state_dict(), None, CFG)
    restored = ckpt.load_checkpoint(path)
    assert restored["config"] == CFG and restored["config"].t5_experts_held == (2, 4)
    again = EncoderDecoderRetrievalModel(restored["config"], device="cpu")
    again.load_state_dict(ckpt.params_state_dict(restored))
    for (n, a), b in zip(model.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), n
    # a config written before the FFN fields (every JAX checkpoint's) is T5's ReLU FFN
    old = {k: v for k, v in ckpt._config_to_jsonable(RetrievalConfig()).items()
           if not k.startswith(("t5_ffn", "t5_first", "t5_n_experts", "t5_experts", "t5_expert_", "t5_shared",
                                "t5_aux"))}
    assert ckpt._jsonable_to_config(old) == RetrievalConfig() and RetrievalConfig().t5_ffn == "relu"
    jax_ckpt = ckpt.load_checkpoint("tests/fixtures/jax_synthetic/decoder/checkpoint_400.msgpack")
    assert jax_ckpt["config"].t5_ffn == "relu" and jax_ckpt["config"].t5_n_experts == 0


MOE_GIN = "rqvae_tpu_torch/configs/decoder_ml32m_moe.gin"


def test_moe_config_binds_to_the_ports_trainer():
    import inspect

    from rqvae_tpu_torch.train.train_decoder import train
    from rqvae_tpu_torch.utils.config import parse_config_file

    bindings = parse_config_file(MOE_GIN)
    assert bindings and not set(bindings) - set(inspect.signature(train).parameters)
    assert bindings["t5_ffn"] == "moe" and tuple(bindings["t5_experts_held"]) == (0, 16) and bindings["t5_remat"]


def test_trainer_cli_trains_the_moe_config(tmp_path):
    from rqvae_tpu_torch.train import train_decoder
    from rqvae_tpu_torch.utils import profiling

    seen = {}
    real = train_decoder.train

    def spy(**kw):
        seen.update(real(**kw))

    train_decoder.train = spy
    spy.__signature__ = __import__("inspect").signature(real)
    before = profiling.ROOT.snapshot().get("moe.rows.encoder")
    try:
        train_decoder.main([
            MOE_GIN, "device='cpu'", "dataset=%data.registry.RecDataset.SYNTHETIC",
            f"dataset_folder='{tmp_path / 'ds'}'", "pretrained_rqvae_path=None", f"save_dir_root='{tmp_path / 'out'}'",
            "iterations=4", "log_every=2", "partial_eval_every=4", "full_eval_every=4", "save_model_every=4",
            "full_eval_max_batches=1", "batch_size=8", "t5_d_model=32", "t5_num_heads=4", "t5_d_ff=48",
            "t5_num_layers=2", "t5_expert_d_ff=16", "t5_shared_d_ff=32", "t5_n_experts=8",
            "t5_experts_per_token=2", "t5_experts_held=[0, 4]", "vae_input_dim=64", "vae_hidden_dims=[32]",
            "vae_embed_dim=8", "vae_codebook_size=16", "vae_n_cat_feats=0"])
    finally:
        train_decoder.train = real
    assert np.isfinite(seen["total_loss"]) and seen["aux_loss"] > 0.0 and "h@1" in seen
    after = profiling.ROOT.snapshot()["moe.rows.encoder"]
    assert after.count > (before.count if before is not None else 0)  # the chunks' counters reached the recorder


def test_serving_scores_equal_the_references_teacher_forcing():
    from rqvae_tpu_torch.models.rqvae import RqVae, RqVaeConfig
    from rqvae_tpu_torch.serving.retriever import Retriever
    from rqvae_tpu_torch.tokenizer.semids import SemanticIdTokenizer

    cfg = dataclasses.replace(CFG, t5_aux_loss_alpha=0.001)
    model = EncoderDecoderRetrievalModel(cfg, device="cpu", seed=9)
    rq = RqVae(RqVaeConfig(input_dim=16, embed_dim=8, hidden_dims=(16,), codebook_size=K, n_layers=L), device="cpu")
    tok = SemanticIdTokenizer(rq, device="cpu")
    feats = torch.randn(60, 16, generator=torch.Generator().manual_seed(2))
    table = tok.precompute_corpus_ids(feats)
    retriever = Retriever(model, tok, device="cpu")
    hist = np.full((5, 6), -1)
    rng = np.random.default_rng(0)
    for b, n in enumerate((6, 3, 1, 5, 2)):
        hist[b, :n] = rng.integers(0, 60, n)
    res = retriever.retrieve(hist)
    h = torch.as_tensor(hist)
    ids = torch.where(h[..., None] >= 0, table[h.clamp(min=0)][..., :L].long(), -1)
    ref = plain(model, cfg)
    with torch.no_grad():
        want = ref.score(ids, (h >= 0)[..., None].expand(-1, -1, L), res.sem_ids.long())
    ok = res.log_probas > -1e8  # beams of a corpus tuple (a sparse corpus leaves fewer than k in some rows)
    assert int(ok.sum()) >= 2 * ok.shape[0] and bool((res.item_ids[ok] >= 0).all())
    torch.testing.assert_close(res.log_probas.float()[ok], want[ok], rtol=1e-5, atol=1e-4)
