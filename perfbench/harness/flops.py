"""Peaks of the card and analytic operation counts, frozen here.

The stage-2 step count is a copy of the measured package's own accounting
(matmul FLOPs only, 2 m k n a product, a train step 3x the forward), so that
the yardstick stays put if the program's copy moves. The retrieval count is
new: the matmul FLOPs of one query at its real history length, as the
program's retrieval computes it (encoder over the history's tokens, then L
beam levels whose decoder runs over BOS and the prefix for every beam).
"""

from __future__ import annotations

# one NVIDIA H100 SXM (NVIDIA's data sheet; dense, at its 700 W limit)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12


def _attention(tq: int, tkv: int, d_model: int, d_inner: int) -> float:
    proj = 2.0 * tq * d_model * d_inner * 2 + 2.0 * tkv * d_model * d_inner * 2
    return proj + 2.0 * 2.0 * tq * tkv * d_inner


def _ffn(t: int, d_model: int, d_ff: int) -> float:
    return 2.0 * 2.0 * t * d_model * d_ff


def retrieval_fwd_flops(batch, enc_len, dec_len, d_model, num_heads, d_kv, d_ff, num_layers, codebook_size,
                        num_hierarchies) -> float:
    d_inner = num_heads * d_kv
    enc_layer = _attention(enc_len, enc_len, d_model, d_inner) + _ffn(enc_len, d_model, d_ff)
    dec_layer = (_attention(dec_len, dec_len, d_model, d_inner) + _attention(dec_len, enc_len, d_model, d_inner)
                 + _ffn(dec_len, d_model, d_ff))
    heads = 2.0 * num_hierarchies * d_model * codebook_size
    return batch * (num_layers * (enc_layer + dec_layer) + heads)


def retrieval_train_step_flops(batch, enc_len, dec_len, d_model, num_heads, d_kv, d_ff, num_layers,
                               codebook_size, num_hierarchies) -> float:
    return 3.0 * retrieval_fwd_flops(batch, enc_len, dec_len, d_model, num_heads, d_kv, d_ff, num_layers,
                                     codebook_size, num_hierarchies)


def train_step_flops(t5: dict, L: int, K: int, batch: int, max_seq_len: int) -> float:
    """A stage-2 step at the configuration's widths: encoder rows of
    max_seq_len items of L + 1 tokens, decoder rows of BOS + L targets."""
    return retrieval_train_step_flops(batch, max_seq_len * (L + 1), L + 1, t5["d_model"], t5["num_heads"],
                                      t5["d_kv"], t5["d_ff"], t5["num_layers"], K, L)


def query_flops(t5: dict, L: int, K: int, beams: int, history_items: int) -> float:
    """One retrieval query over a history of `history_items` items: the
    encoder over its (L + 1) tokens an item, then level h's decoder over
    h + 1 positions for each live beam (one at level 0), the cross-attention
    K/V projected once, and the head over every beam's last position."""
    d, H, dk, dff, NL = t5["d_model"], t5["num_heads"], t5["d_kv"], t5["d_ff"], t5["num_layers"]
    inner = H * dk
    le = history_items * (L + 1)
    enc = NL * (_attention(le, le, d, inner) + _ffn(le, d, dff))
    cross_kv = NL * 2.0 * 2.0 * le * d * inner
    dec = 0.0
    for h in range(L):
        n, t = (1 if h == 0 else beams), h + 1
        self_attn = _attention(t, t, d, inner)
        cross = 2.0 * 2.0 * t * d * inner + 2.0 * 2.0 * t * le * inner  # q and o projections, scores and values
        dec += n * (NL * (self_attn + cross + _ffn(t, d, dff)) + 2.0 * d * K)
    return enc + cross_kv + dec
