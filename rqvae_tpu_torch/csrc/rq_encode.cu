// Fused MLP encode + L-level residual quantization (corpus index build).
//
// Replaces the Pallas TPU kernel rqvae_tpu/ops/pallas/rq_encode.py::_kernel
// (via fused_encode_quantize). For each corpus row: the bias-free MLP chain
// (matmul -> ReLU -> ... -> matmul), then for each level
// argmin_k(||cb_k||^2 - 2 res.cb_k) with the lowest index kept on exact ties,
// then res -= cb[id]. Writes the [N, L] int32 ids.
//
// Two modes, as the reference's `precision`. float32: every value and sum in
// float32. bf16: the values are rounded to bfloat16 where the reference casts
// to its compute dtype (rq_encode.py::_kernel) and nowhere else: x on load;
// each layer's output, after the ReLU between layers and also after the last
// layer (no ReLU there), which gives the residual; the residual after each
// level's subtraction. Sums stay float32 and a product of two bf16 values is
// exact in float32, so the bf16 mode computes the reference's function up to
// the order of its float32 sums. The wrapper hands this mode weights and
// codebooks already rounded to bf16 (once per call, as the reference casts
// them outside its kernel) and the squared norms of the UNROUNDED float32
// codebooks (the reference's cb2). Storage stays float32 in both modes.
//
// Bound on the H100: compute. At the Amazon geometry (768 -> 512 -> 256 ->
// 128 -> 32, 3 x 256 codebooks) a row costs ~1.2 MFLOP against 3 KB read.
// In float32 the arithmetic must stay float32 (TF32 would move argmins), so
// the card's float32 CUDA-core rate bounds it; in bf16 the tensor cores'
// bf16 rate would (bf16 products, f32 sums), but this kernel runs the bf16
// mode on the same CUDA-core loops, so it costs what float32 costs.
//
// Design: one block per tile of ROWS rows. The activations ping-pong between
// two shared-memory buffers; the weights stream from global memory, where the
// 2.3 MB stack stays resident in L2 across blocks. Each thread owns a
// RB x 4 register tile (one float4 of weight columns, RB rows), so a weight
// load feeds 4*RB FMAs. Each level's codebook is staged in shared memory with
// rows padded to D+1 floats (lanes read distinct codes without bank
// conflicts); one warp takes one row's argmin with a shuffle reduction and
// subtracts the chosen code in place. The ragged last tile is zero-filled on
// load and masked on store. Everything accumulates in float32.
//
// Shared memory: once the MLP chain is done only the [ROWS, D] residuals are
// live, at the front of the block's memory, and the codebook is staged over
// the dead activation buffers instead of beside them. A block
// needs max(the two activation buffers, residuals + codebook): 166,400 B at
// 788 -> 512 -> 256 -> 128 -> 64 with K = 256, where buffers plus codebook
// (233,984 B) would pass the 232,448 B a Hopper block may use. The arithmetic
// and its order are untouched, so the ids are too.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAX_WEIGHTS = 8;
constexpr int ROWS = 32;     // corpus rows per block
constexpr int THREADS = 512;
constexpr int RB = 8;        // rows per thread in the register tile

struct Params {
  const float* x;            // [n_rows, dims[0]]
  const float* w[MAX_WEIGHTS];  // w[i]: [dims[i], dims[i+1]] row-major
  int dims[MAX_WEIGHTS + 1];
  int n_weights;
  const float* codebooks;    // [n_levels, K, D]
  const float* cb2;          // [n_levels, K] squared norms
  int n_rows, n_levels, K, D;
  int* out;                  // [n_rows, n_levels]
};

// v rounded to the nearest bf16 value (ties to even) when BF16, else v.
template <bool BF16>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (BF16) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

template <bool BF16>
__device__ __forceinline__ float4 round_to(float4 v) {
  return make_float4(round_to<BF16>(v.x), round_to<BF16>(v.y), round_to<BF16>(v.z), round_to<BF16>(v.w));
}

// C[M, N] = A[M, Kd] @ W[Kd, N] (ReLU if relu; then rounded to bf16 if BF16),
// A and C in shared memory with row strides Kd and N, W row-major in global
// memory. Kd and N are multiples of 4 (checked on the host).
template <bool BF16>
__device__ void tile_gemm(const float* __restrict__ A, int M, int Kd,
                          const float* __restrict__ W, int N,
                          float* __restrict__ C, bool relu) {
  const int ncg = N / 4;
  const int nrg = (M + RB - 1) / RB;
  for (int item = threadIdx.x; item < ncg * nrg; item += blockDim.x) {
    const int n0 = (item % ncg) * 4;
    const int m0 = (item / ncg) * RB;
    float acc[RB][4];
#pragma unroll
    for (int r = 0; r < RB; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
    // two k-steps of weight loads in flight per thread
#pragma unroll 2
    for (int k = 0; k < Kd; k += 4) {
      float4 a[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r)
        a[r] = (m0 + r < M) ? *reinterpret_cast<const float4*>(A + (m0 + r) * Kd + k)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 w = __ldg(reinterpret_cast<const float4*>(W + (size_t)(k + kk) * N + n0));
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const float av = kk == 0 ? a[r].x : kk == 1 ? a[r].y : kk == 2 ? a[r].z : a[r].w;
          acc[r][0] = fmaf(av, w.x, acc[r][0]);
          acc[r][1] = fmaf(av, w.y, acc[r][1]);
          acc[r][2] = fmaf(av, w.z, acc[r][2]);
          acc[r][3] = fmaf(av, w.w, acc[r][3]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (m0 + r < M) {
        float4 v = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
        if (relu) {
          v.x = fmaxf(v.x, 0.f); v.y = fmaxf(v.y, 0.f);
          v.z = fmaxf(v.z, 0.f); v.w = fmaxf(v.w, 0.f);
        }
        *reinterpret_cast<float4*>(C + (m0 + r) * N + n0) = round_to<BF16>(v);
      }
    }
  }
}

// Floats of ping-pong buffer `parity`: it holds the activations whose index
// has that parity counted back from the last one, so the residuals (index
// n_weights) always land in buffer 0, at the front of shared memory.
__host__ __device__ int buffer_floats(const int* dims, int n_weights, int parity) {
  int m = 0;
  for (int i = n_weights - parity; i >= 0; i -= 2) m = dims[i] > m ? dims[i] : m;
  return ROWS * m;
}

size_t smem_bytes(const int* dims, int n_weights, int K, int D) {
  const size_t mlp = (size_t)buffer_floats(dims, n_weights, 0) + buffer_floats(dims, n_weights, 1);
  const size_t quant = (size_t)ROWS * D + (size_t)K * (D + 1) + K;
  return (mlp > quant ? mlp : quant) * sizeof(float);
}

template <bool BF16>
__global__ void __launch_bounds__(THREADS) rq_encode_kernel(Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* buf[2];
  buf[0] = smem;
  buf[1] = smem + buffer_floats(p.dims, p.n_weights, 0);
  float* cb_s = smem + ROWS * p.D;         // [K, D+1], over the dead activations
  float* cb2_s = cb_s + p.K * (p.D + 1);   // [K]

  const int row0 = blockIdx.x * ROWS;
  const int in_dim = p.dims[0];

  // input tile -> the buffer of index 0, zero rows past the corpus end
  float* in_buf = buf[p.n_weights & 1];
  for (int i = threadIdx.x; i < ROWS * in_dim / 4; i += blockDim.x) {
    const int r = (i * 4) / in_dim, c = (i * 4) % in_dim;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < p.n_rows)
      v = __ldg(reinterpret_cast<const float4*>(p.x + (size_t)(row0 + r) * in_dim + c));
    *reinterpret_cast<float4*>(in_buf + r * in_dim + c) = round_to<BF16>(v);
  }
  __syncthreads();

  for (int i = 0; i < p.n_weights; ++i) {
    tile_gemm<BF16>(buf[(p.n_weights - i) & 1], ROWS, p.dims[i], p.w[i], p.dims[i + 1],
              buf[(p.n_weights - i - 1) & 1], i != p.n_weights - 1);
    __syncthreads();
  }
  float* res = smem;  // buf[0]: [ROWS, D]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int K = p.K, D = p.D;
  for (int level = 0; level < p.n_levels; ++level) {
    const float* cb = p.codebooks + (size_t)level * K * D;
    for (int i = threadIdx.x; i < K * D; i += blockDim.x)
      cb_s[(i / D) * (D + 1) + i % D] = __ldg(cb + i);
    for (int i = threadIdx.x; i < K; i += blockDim.x) cb2_s[i] = __ldg(p.cb2 + level * K + i);
    __syncthreads();
    for (int r = warp; r < ROWS; r += nwarps) {
      const float* rr = res + r * D;
      float best = INFINITY;
      int bi = 0;
      for (int k = lane; k < K; k += 32) {  // ascending k: strict < keeps the first
        const float* ck = cb_s + k * (D + 1);
        float dot = 0.f;
        for (int c = 0; c < D; ++c) dot = fmaf(rr[c], ck[c], dot);
        const float dist = cb2_s[k] - 2.0f * dot;
        if (dist < best) { best = dist; bi = k; }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (ob < best || (ob == best && oi < bi)) { best = ob; bi = oi; }
      }
      __syncwarp();
      for (int c = lane; c < D; c += 32)
        res[r * D + c] = round_to<BF16>(res[r * D + c] - cb_s[bi * (D + 1) + c]);
      if (lane == 0 && row0 + r < p.n_rows) p.out[(size_t)(row0 + r) * p.n_levels + level] = bi;
    }
    __syncthreads();
  }
}

template <bool BF16>
int launch(const Params& p, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(rq_encode_kernel<BF16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (p.n_rows + ROWS - 1) / ROWS;
  rq_encode_kernel<BF16><<<blocks, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Shared memory one block needs; the host wrapper refuses shapes above the
// card's 227 KB per block.
int rq_encode_smem_bytes(const int* dims, int n_weights, int K, int D) {
  return (int)smem_bytes(dims, n_weights, K, D);
}

// bf16 != 0: the bf16 mode (weights and codebooks already rounded to bf16,
// cb2 the squared norms of the unrounded codebooks).
int rq_encode_forward(const float* x, int n_rows, void* const* weights, const int* dims,
                      int n_weights, const float* codebooks, const float* cb2, int n_levels,
                      int K, int D, int* out, int bf16, void* stream) {
  if (n_weights < 1 || n_weights > MAX_WEIGHTS) return (int)cudaErrorInvalidValue;
  Params p;
  p.x = x;
  for (int i = 0; i < n_weights; ++i) p.w[i] = static_cast<const float*>(weights[i]);
  for (int i = 0; i <= n_weights; ++i) p.dims[i] = dims[i];
  p.n_weights = n_weights;
  p.codebooks = codebooks;
  p.cb2 = cb2;
  p.n_rows = n_rows;
  p.n_levels = n_levels;
  p.K = K;
  p.D = D;
  p.out = out;
  const size_t smem = smem_bytes(dims, n_weights, K, D);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<true>(p, smem, s) : launch<false>(p, smem, s);
}

}  // extern "C"
