// Fused T5 attention forward: softmax(q k^T + bias + mask [+ causal]) @ v with
// in-register dropout, one launch for all (batch row, head, query tile). When
// asked (training), it also writes each row's softmax maximum and sum, from
// which the backward kernel (attention_bwd.cu) rebuilds the same p.
//
// Replaces the Pallas TPU kernel rqvae_tpu/ops/pallas/attention.py::_fwd_kernel
// (via _fwd_call / t5_attention). The device routine, its rounding points and
// its design are in attention_core.cuh, which the encoder-stack kernel shares.
//
// Bound on the H100 (4 B H Lq Lk dk operations; q, k, v, out, bias and mask
// moved once): at the long-row serving shape [64, 6, 800, 64] 63 GFLOP against
// about 170 MB, so with bf16 tensor cores the two bounds are close
// (operations 0.064 ms, bytes 0.051 ms) and in float32 the CUDA-core rate
// bounds it (0.94 ms); at the Amazon training shape [640, 6, 80, 64] bytes
// bound it in bf16. bf16 at dk = 64 takes the tensor-core routes (whole rows
// up to 128 keys, pipelined key tiles beyond); float32 runs on the CUDA cores.
// The [B, H, Lq, Lk] scores never reach device memory, which is what the TPU
// kernel is for.

#include "attention_core.cuh"

namespace {

template <typename T>
int launch(void* const* ptrs, const int* dims, const int* seed, unsigned keep_thresh, float keep_scale,
           int dropout, int b0, void* stream) {
  attn::Params<T> p;
  p.q = static_cast<const T*>(ptrs[0]);
  p.k = static_cast<const T*>(ptrs[1]);
  p.v = static_cast<const T*>(ptrs[2]);
  p.bias = static_cast<const float*>(ptrs[3]);
  p.mask_add = nullptr;
  p.mask_keep = static_cast<const int*>(ptrs[4]);
  p.out = static_cast<T*>(ptrs[5]);
  p.row_max = static_cast<float*>(ptrs[6]);
  p.row_sum = static_cast<float*>(ptrs[7]);
  p.keep_bits = static_cast<unsigned*>(ptrs[8]);
  p.B = dims[0]; p.H = dims[1]; p.Lq = dims[2]; p.Lk = dims[3]; p.dk = dims[4];
  p.causal = dims[5];
  p.dropout = dropout;
  p.seed = seed;
  p.b0 = b0;
  p.keep_thresh = keep_thresh;
  p.keep_scale = keep_scale;
  return (int)attn::launch_attention<T>(p, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// ptrs: q, k, v, bias [H, Lq, Lk] f32, mask [B, Lk] int32 (1 = attend), out,
// then row_max and row_sum [B, H, Lq] f32 (both null: statistics not written),
// then keep_bits [B, H, Lq, ceil(Lk / 64), 2] int32 (null: not written; only
// the tiled route writes them, with dropout).
// dims: B, H, Lq, Lk, dk, causal. With dropout != 0, seed is the device
// address of the int32 dropout seed (read by the kernel, not here), keep iff
// the hash bits >= keep_thresh and kept probabilities are scaled by keep_scale;
// b0 is the global batch index of batch row 0 in the dropout counter.
int attention_forward(int is_bf16, void* const* ptrs, const int* dims, const int* seed,
                      unsigned keep_thresh, float keep_scale, int dropout, int b0, void* stream) {
  return is_bf16 ? launch<__nv_bfloat16>(ptrs, dims, seed, keep_thresh, keep_scale, dropout, b0, stream)
                 : launch<float>(ptrs, dims, seed, keep_thresh, keep_scale, dropout, b0, stream);
}

// The route attention_forward takes (0: CUDA cores, 1: whole rows, 2: tiled).
int attention_route(int is_bf16, int Lk, int dk) { return attn::forward_route(is_bf16 != 0, Lk, dk); }

}  // extern "C"
