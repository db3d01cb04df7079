"""The sparse-expert retrieval T5 of the benchmark's MoE configurations: the
weights made from the seed, the program's model built from the
configuration's `t5` and `moe` groups, and the step's operation count.

Weights as perfbench/harness/weights.py makes the T5's (one pool, cut and
scaled), with each block's FFN replaced: a dense SwiGLU (blocks before
`first_k_dense`) or the router, the held experts stacked as [E_held, d, f]
and [E_held, f, d], and the shared SwiGLU, all N(0, 0.02^2)
(DeepSeek-V2's initializer_range).
"""

from __future__ import annotations

from typing import Dict

import torch

from perfbench.harness import weights

STD = 0.02


def layout(t5: dict, moe: dict, L: int, K: int):
    """(name, shape, kind, scale) of every parameter of the MoE model."""
    d, dff = t5["d_model"], t5["d_ff"]
    first, count = moe["experts_held"]
    f, fs = moe["expert_d_ff"], moe["shared_d_ff"]
    out = []
    for row in weights.t5_layout(t5, L, K):
        name = row[0]
        if ".ffn.wi." in name:  # the T5 FFN's place: the block's gated FFN
            pre = name.split("wi.")[0]
            if int(name.split(".")[2]) < moe["first_k_dense"]:
                out += [(pre + "w_gate.weight", (dff, d), "normal", STD), (pre + "w_up.weight", (dff, d), "normal", STD),
                        (pre + "w_down.weight", (d, dff), "normal", STD)]
            else:
                out += [(pre + "router", (moe["n_experts"], d), "normal", STD),
                        (pre + "w_gate", (count, d, f), "normal", STD), (pre + "w_up", (count, d, f), "normal", STD),
                        (pre + "w_down", (count, f, d), "normal", STD),
                        (pre + "shared.w_gate.weight", (fs, d), "normal", STD),
                        (pre + "shared.w_up.weight", (fs, d), "normal", STD),
                        (pre + "shared.w_down.weight", (d, fs), "normal", STD)]
        elif ".ffn.wo." not in name:
            out.append(row)
    return out


def t5_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    rq = cfg["rqvae"]
    return weights._fill(layout(cfg["t5"], cfg["moe"], rq["n_layers"], rq["codebook_size"]),
                         weights.generator(seed, 1, device), device)


def retrieval_model(cfg: dict, t5_w: Dict[str, torch.Tensor], dev):
    """The program's retrieval model at the configuration's widths, its
    blocks' FFNs DeepSeek-V2's, loaded with the benchmark's weights (built
    with `seed=None`: no init of its own for the weights to replace)."""
    from rqvae_tpu_torch.models.retrieval import EncoderDecoderRetrievalModel, RetrievalConfig

    rq, t5, moe = cfg["rqvae"], cfg["t5"], cfg["moe"]
    model = EncoderDecoderRetrievalModel(RetrievalConfig(
        num_hierarchies=rq["n_layers"], codebook_size=rq["codebook_size"], t5_d_model=t5["d_model"],
        t5_d_kv=t5["d_kv"], t5_num_heads=t5["num_heads"], t5_d_ff=t5["d_ff"], t5_num_layers=t5["num_layers"],
        t5_dropout=t5["dropout"], top_k_for_generation=t5["top_k"], should_add_sep_token=True,
        t5_dtype=t5["dtype"], t5_remat=t5.get("remat", False), t5_ffn="moe",
        t5_first_k_dense=moe["first_k_dense"], t5_n_experts=moe["n_experts"],
        t5_experts_per_token=moe["experts_per_token"], t5_expert_d_ff=moe["expert_d_ff"],
        t5_shared_d_ff=moe["shared_d_ff"], t5_experts_held=tuple(moe["experts_held"]),
        t5_aux_loss_alpha=moe["aux_loss_alpha"]), device=dev, seed=None)
    model.load_state_dict(t5_w)
    return model


def _ffn(t: float, d: int, f: int) -> float:
    """A SwiGLU's products over t rows: gate, up and down."""
    return 2.0 * 3.0 * t * d * f


def train_step_flops(cfg: dict, rows: Dict[str, float]) -> float:
    """A training step's matmul operations (a step 3x its forward, 2 m k n a
    product): every attention as the frozen T5 count has it, the dense
    SwiGLU blocks, each MoE block's shared SwiGLU over every position and its
    held experts over `rows[stack]`, the rows the step routed to them (summed
    over the stack's MoE blocks), the routers, and the heads. Decoder
    positions: BOS + L."""
    from perfbench.harness.flops import _attention

    rq, t5, moe, tc = cfg["rqvae"], cfg["t5"], cfg["moe"], cfg["train"]
    L, K = rq["n_layers"], rq["codebook_size"]
    B, d, NL = tc["batch_size"], t5["d_model"], t5["num_layers"]
    inner = t5["num_heads"] * t5["d_kv"]
    le, ld = tc["max_seq_len"] * (L + 1), L + 1
    dense_n, moe_n = moe["first_k_dense"], NL - moe["first_k_dense"]
    fwd = 0.0
    for t, cross in ((le, False), (ld, True)):
        per_pos = dense_n * _ffn(1, d, t5["d_ff"]) + moe_n * (_ffn(1, d, moe["shared_d_ff"]) + 2.0 * d * moe["n_experts"])
        attn = _attention(t, t, d, inner) + (_attention(t, le, d, inner) if cross else 0.0)
        fwd += B * (NL * attn + t * per_pos)
    fwd += _ffn(rows["encoder"] + rows["decoder"], d, moe["expert_d_ff"])
    fwd += B * 2.0 * L * d * K
    return 3.0 * fwd
