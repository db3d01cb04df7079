"""Analytic FLOP counts and MFU accounting for the train steps (port of
rqvae_tpu/utils/flops.py; the formulas are the JAX package's, unchanged).

The models count the matmul FLOPs of the stage-1 (RQ-VAE) and stage-2
(retrieval T5) train steps, so that a measured step time converts to MFU:
the share of the card's peak matmul rate the step achieves. Consumed by
train/perf.py.

Conventions (the standard accounting, e.g. PaLM appendix B):
- a [m,k]x[k,n] matmul is 2*m*k*n FLOPs;
- backward through a matmul costs 2x the forward (dL/dx and dL/dW), so a
  train step is 3x the forward matmul FLOPs;
- elementwise work, softmax, normalisation, gathers and the optimizer update
  are left out (they are bound by memory, not by the matrix units; counting
  them would flatter MFU).

Geometries: RQ-VAE 768->[512,256,128]->32, 3x256 codebooks
(configs/rqvae_amazon.gin); T5 d_model 384 / 6 heads / d_ff 1024 / 4 layers
over 20-item histories (configs/decoder_amazon.gin).
"""

from __future__ import annotations

from typing import Sequence

# Peak dense rates of one NVIDIA H100 SXM, FLOP/s (NVIDIA's data sheet, at
# the full 700 W power limit): bf16 on the tensor cores, and float32 on the
# CUDA cores, where the port's f32 products (`models/t5.py::dense` at
# t5_dtype="float32", the stage-1 MLPs) run with TF32 off.
PEAK_FLOPS = {
    "h100_sxm_bf16": 989e12,
    "h100_sxm_f32": 67e12,
}


def mlp_fwd_flops(batch: int, dims: Sequence[int]) -> float:
    """Bias-free Linear stack (models/mlp.py): sum of 2*B*d_i*d_{i+1}."""
    return float(sum(2 * batch * a * b for a, b in zip(dims[:-1], dims[1:])))


def rqvae_fwd_flops(
    batch: int,
    input_dim: int,
    hidden_dims: Sequence[int],
    embed_dim: int,
    codebook_size: int,
    n_layers: int,
) -> float:
    """RQ-VAE forward (models/rqvae.py): MLP encoder + L quantize levels
    (each a [B,e]x[e,K] distance matmul; the -2*x@c.T term is the only
    matrix-unit work in the L2 distance) + mirrored MLP decoder."""
    enc_dims = [input_dim, *hidden_dims, embed_dim]
    dec_dims = list(reversed(enc_dims))
    enc = mlp_fwd_flops(batch, enc_dims)
    dec = mlp_fwd_flops(batch, dec_dims)
    quant = n_layers * 2.0 * batch * embed_dim * codebook_size
    return enc + dec + quant


def rqvae_train_step_flops(
    batch: int,
    input_dim: int,
    hidden_dims: Sequence[int],
    embed_dim: int,
    codebook_size: int,
    n_layers: int,
) -> float:
    """fwd + bwd = 3x forward matmul FLOPs."""
    return 3.0 * rqvae_fwd_flops(
        batch, input_dim, hidden_dims, embed_dim, codebook_size, n_layers
    )


def t5_attention_fwd_flops(tq: int, tkv: int, d_model: int, d_inner: int) -> float:
    """One attention block, per example: Q/O projections over tq, K/V over
    tkv, plus the QK^T and A@V contractions (2 * 2*tq*tkv*d_inner)."""
    proj = 2.0 * tq * d_model * d_inner * 2 + 2.0 * tkv * d_model * d_inner * 2
    scores = 2.0 * 2.0 * tq * tkv * d_inner
    return proj + scores


def t5_ffn_fwd_flops(t: int, d_model: int, d_ff: int) -> float:
    return 2.0 * 2.0 * t * d_model * d_ff


def retrieval_fwd_flops(
    batch: int,
    enc_len: int,
    dec_len: int,
    d_model: int,
    num_heads: int,
    d_kv: int,
    d_ff: int,
    num_layers: int,
    codebook_size: int,
    num_hierarchies: int,
) -> float:
    """Stage-2 forward (models/retrieval.py / models/t5.py): encoder stack
    over enc_len tokens, decoder stack (self + cross attention) over
    dec_len teacher-forced positions, plus the L per-hierarchy heads."""
    d_inner = num_heads * d_kv
    enc_layer = (
        t5_attention_fwd_flops(enc_len, enc_len, d_model, d_inner)
        + t5_ffn_fwd_flops(enc_len, d_model, d_ff)
    )
    dec_layer = (
        t5_attention_fwd_flops(dec_len, dec_len, d_model, d_inner)  # self
        + t5_attention_fwd_flops(dec_len, enc_len, d_model, d_inner)  # cross
        + t5_ffn_fwd_flops(dec_len, d_model, d_ff)
    )
    heads = 2.0 * num_hierarchies * d_model * codebook_size  # one position each
    per_example = num_layers * (enc_layer + dec_layer) + heads
    return batch * per_example


def retrieval_train_step_flops(
    batch: int,
    enc_len: int,
    dec_len: int,
    d_model: int,
    num_heads: int,
    d_kv: int,
    d_ff: int,
    num_layers: int,
    codebook_size: int,
    num_hierarchies: int,
) -> float:
    return 3.0 * retrieval_fwd_flops(
        batch, enc_len, dec_len, d_model, num_heads, d_kv, d_ff,
        num_layers, codebook_size, num_hierarchies,
    )


def mfu(flops_per_step: float, seconds_per_step: float, peak: str = "h100_sxm_bf16") -> float:
    """Measured model FLOPs utilization: analytic step FLOPs / (time * peak)."""
    return flops_per_step / (seconds_per_step * PEAK_FLOPS[peak])
