// Fused T5 attention forward: softmax(q k^T + bias + mask [+ causal]) @ v with
// in-register dropout, one launch for all (batch row, head, query tile). When
// asked (training), it also writes each row's softmax maximum and sum, from
// which the backward kernel (attention_bwd.cu) rebuilds the same p.
//
// Replaces the Pallas TPU kernel rqvae_tpu/ops/pallas/attention.py::_fwd_kernel
// (via _fwd_call / t5_attention). The device routine, its rounding points and
// its design are in attention_core.cuh, which the encoder-stack kernel shares.
//
// Bound on the H100 at the long-row serving shape (B = 64, H = 6,
// Lq = Lk = 800, dk = 64): 4 B H Lq Lk dk = 63 GFLOP against about 170 MB of
// q, k, v, out and bias, so with bf16 tensor cores the two bounds are close
// (operations 0.064 ms, bytes 0.051 ms) and in float32 the CUDA-core rate
// bounds it (0.94 ms). The kernel computes q k^T twice (two-pass softmax, to
// round the normalised p as the reference does) and runs float32 on the CUDA
// cores and bf16 at dk = 64 on the tensor cores through mma.sync, fed from
// shared memory without TMA or wgmma, so it sits above either bound; it keeps
// the [B, H, Lq, Lk] scores out of device memory, which is what the TPU
// kernel is for.

#include "attention_core.cuh"

namespace {

template <typename T>
int launch(void* const* ptrs, const int* dims, int seed, unsigned keep_thresh, float keep_scale,
           int dropout, void* stream) {
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
  p.B = dims[0]; p.H = dims[1]; p.Lq = dims[2]; p.Lk = dims[3]; p.dk = dims[4];
  p.causal = dims[5];
  p.dropout = dropout;
  p.seed_mix = (unsigned)seed * 0x9E3779B9u;
  p.keep_thresh = keep_thresh;
  p.keep_scale = keep_scale;
  return (int)attn::launch_attention<T>(p, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// ptrs: q, k, v, bias [H, Lq, Lk] f32, mask [B, Lk] int32 (1 = attend), out,
// then row_max and row_sum [B, H, Lq] f32 (both null: statistics not written).
// dims: B, H, Lq, Lk, dk, causal. With dropout != 0, keep iff the hash bits
// >= keep_thresh and kept probabilities are scaled by keep_scale.
int attention_forward(int is_bf16, void* const* ptrs, const int* dims, int seed,
                      unsigned keep_thresh, float keep_scale, int dropout, void* stream) {
  return is_bf16 ? launch<__nv_bfloat16>(ptrs, dims, seed, keep_thresh, keep_scale, dropout, stream)
                 : launch<float>(ptrs, dims, seed, keep_thresh, keep_scale, dropout, stream);
}

}  // extern "C"
