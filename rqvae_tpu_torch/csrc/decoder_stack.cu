// Fused T5 decoder-stack forward for one beam-search level (serving).
//
// Replaces the Pallas TPU kernel
// rqvae_tpu/ops/pallas/decoder_stack.py::_kernel (via t5_decoder_stack_infer).
// One launch runs every decoder layer for one decode level: per layer
// RMSNorm; beam-folded self-attention under the block-diagonal causal
// rel-pos bias `bias_fold` [H, kT, kT]; cross-attention against the cached
// K/V [NL, B, H, Le, dk] with the additive mask [B, Le]; ReLU FFN. Then the
// final RMSNorm, written as float32.
//
// Bound on the H100: at the Amazon geometry's last level (B = 64, kT = 30,
// d = 384, Le = 80, bf16) ~27 GFLOP against ~45 MB (weights 13.4 MB + K/V
// 31.5 MB), so with tensor cores the bound is compute (~27 us). This kernel
// is far from it: one block per batch row fills 64 of 132 SMs, and each
// block walks its layers as a chain of small dependent products.
//
// Design: one block per batch row b. The block keeps that row's residual
// stream x [kT, d] in shared memory through all layers, next to the
// normalized input xn and a float32 accumulator for the per-head output
// projections; a scratch region holds one head's q, K, V, output and scores,
// or one FFN hidden chunk [kT, 256]. Weights stream from global memory (they
// stay L2-resident across blocks) as 4-wide vector loads into per-thread
// RB x 4 register tiles, with K split across threads when the tiles alone
// would leave most of the block idle (the few-row early decode levels).
// Products run on the CUDA cores in both dtypes: bf16 operands are exact in
// f32, and a first tensor-core version (one warp per 32 x 8 mma tile, weights
// read straight from global memory) measured slower at these shapes.
// Cross-attention stages K/V of (layer, b, head) in shared memory, K with
// rows padded to dk+1 floats so the score loop is free of bank conflicts.
// Every value is held as float32; in bf16 mode it is rounded to bf16 exactly
// where the reference rounds: q/k/v, p and the head output after f32
// accumulation, the RMSNorm output before and after its scale, the
// per-sub-layer projection sum once, and the residual stream after every add.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 512;
constexpr int RB = 4;      // rows per thread in the register tile
constexpr int FCHUNK = 256;  // FFN hidden columns per chunk
constexpr int MAX_SMEM_FLOATS = 232448 / 4;  // the 227 KB a Hopper block may opt in to

template <typename T> struct Num;
template <> struct Num<float> {
  static __device__ __forceinline__ float to_f(float v) { return v; }
  static __device__ __forceinline__ float rnd(float v) { return v; }
  static __device__ __forceinline__ float4 load4(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
};
template <> struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ __forceinline__ float rnd(float v) {
    return __bfloat162float(__float2bfloat16(v));  // round to nearest even
  }
  static __device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
};

template <typename T> struct Params {
  const T* x;                    // [B, kT, d]
  const T *wq, *wk, *wv;         // [NL, H, d, dk]
  const T* wo;                   // [NL, H, dk, d]
  const T* cq;                   // [NL, H, d, dk]
  const T* co;                   // [NL, H, dk, d]
  const T* wi;                   // [NL, d, dff]
  const T* wo2;                  // [NL, dff, d]
  const float *ln_s, *ln_c, *ln_f;  // [NL, d]
  const float* ln_final;         // [d]
  const float* bias;             // [H, kT, kT]
  const T *kc, *vc;              // [NL, B, H, Le, dk]
  const float* mask;             // [B, Le] additive (0 / -1e9)
  float* out;                    // [B, kT, d]
  int B, kT, d, NL, H, dk, dff, Le;
  float eps;
};

enum Epilogue { ROUND = 0, ACCUMULATE = 1, ROUND_RELU = 2 };

template <typename T, int EPI>
__device__ __forceinline__ void epilogue(float* dst, float v) {
  if (EPI == ACCUMULATE) *dst += v;
  else if (EPI == ROUND) *dst = Num<T>::rnd(v);
  else *dst = fmaxf(Num<T>::rnd(v), 0.f);
}

// For each of n_mat products: C[M, N] (op)= A[M, Kd] @ W[Kd, N], A in shared
// memory (row stride lda), W[i] in global memory (row stride ldw), C[i] in
// shared memory (row stride ldc[i]). Kd, N, lda and ldw are multiples of 4.
//
// A work item is an RB x 4 output tile. When the items fill less than half
// the block (few rows: the early decode levels), K is split S ways so more
// threads stream weights at once: each (item, split) pair writes its partial
// tile to `red` (red_cap floats), and the partials are summed in split order,
// so the result does not depend on scheduling.
template <typename T, int EPI>
__device__ void block_gemm(const float* __restrict__ A, int lda, int M, int Kd, int N,
                           const T* const* W, int ldw, float* const* C, const int* ldc,
                           int n_mat, float* __restrict__ red, int red_cap) {
  const int ncg = N / 4;
  const int nrg = (M + RB - 1) / RB;
  const int per_mat = ncg * nrg;
  const int items = per_mat * n_mat;
  constexpr int TILE = RB * 4;
  int S = 1;
  if (2 * items <= (int)blockDim.x) {
    S = min((int)blockDim.x / items, red_cap / (items * TILE));
    S = max(1, min(S, Kd / 8));
  }
  const int kc = (Kd / S + 7) / 8 * 8;  // k per split: whole unrolled steps
  for (int idx = threadIdx.x; idx < items * S; idx += blockDim.x) {
    const int item = idx % items, split = idx / items;
    const int mat = item / per_mat;
    const int rem = item % per_mat;
    const int n0 = (rem % ncg) * 4;
    const int m0 = (rem / ncg) * RB;
    const T* w = W[mat];
    const int k_end = min(Kd, (split + 1) * kc);
    float acc[RB][4];
#pragma unroll
    for (int r = 0; r < RB; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
    // two k-steps of weight loads in flight per thread
#pragma unroll 2
    for (int k = split * kc; k < k_end; k += 4) {
      float4 a[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r)
        a[r] = (m0 + r < M) ? *reinterpret_cast<const float4*>(A + (m0 + r) * lda + k)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 wv = Num<T>::load4(w + (size_t)(k + kk) * ldw + n0);
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const float av = kk == 0 ? a[r].x : kk == 1 ? a[r].y : kk == 2 ? a[r].z : a[r].w;
          acc[r][0] = fmaf(av, wv.x, acc[r][0]);
          acc[r][1] = fmaf(av, wv.y, acc[r][1]);
          acc[r][2] = fmaf(av, wv.z, acc[r][2]);
          acc[r][3] = fmaf(av, wv.w, acc[r][3]);
        }
      }
    }
    if (S > 1) {
      float* part = red + (size_t)idx * TILE;  // idx = split * items + item
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[r * 4 + j] = acc[r][j];
      continue;
    }
    float* c = C[mat];
    const int ld = ldc[mat];
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (m0 + r >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) epilogue<T, EPI>(c + (m0 + r) * ld + n0 + j, acc[r][j]);
    }
  }
  if (S == 1) return;
  __syncthreads();
  for (int e = threadIdx.x; e < items * TILE; e += blockDim.x) {
    const int item = e / TILE, rj = e % TILE;
    const int mat = item / per_mat;
    const int rem = item % per_mat;
    const int row = (rem / ncg) * RB + rj / 4;
    if (row >= M) continue;
    float v = red[(size_t)item * TILE + rj];
    for (int split = 1; split < S; ++split) v += red[((size_t)split * items + item) * TILE + rj];
    epilogue<T, EPI>(C[mat] + row * ldc[mat] + (rem % ncg) * 4 + rj % 4, v);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// dst = rnd(rnd(x * (1 / sqrt(mean(x^2) + eps))) * w); with final, dst is the
// float32 output rnd(x * (1 / sqrt(..))) * w. sqrt and the division are correctly
// rounded (rsqrtf is not), as in the plain version.
template <typename T>
__device__ void rmsnorm(const float* x, const float* __restrict__ w, float* dst, int rows, int d,
                        float eps, bool final_out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int i = warp; i < rows; i += nwarps) {
    float ss = 0.f;
    for (int c = lane; c < d; c += 32) ss = fmaf(x[i * d + c], x[i * d + c], ss);
    const float rs = 1.0f / sqrtf(warp_sum(ss) / d + eps);
    for (int c = lane; c < d; c += 32) {
      const float v = Num<T>::rnd(x[i * d + c] * rs) * __ldg(w + c);
      dst[i * d + c] = final_out ? v : Num<T>::rnd(v);
    }
  }
}

// p = rnd(softmax(s)) row-wise over n columns (row stride ld), in place.
template <typename T>
__device__ void softmax_rows(float* s, int rows, int n, int ld) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int i = warp; i < rows; i += nwarps) {
    float* row = s + i * ld;
    float m = -INFINITY;
    for (int j = lane; j < n; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    __syncwarp();
    for (int j = lane; j < n; j += 32) row[j] = Num<T>::rnd(row[j] / sum);
  }
}

struct Layout {
  int x, xn, acc;                   // [kT, d] each
  int q, kb, vb, oh, s;             // attention scratch
  int h;                            // FFN hidden chunk [kT, FCHUNK] (aliases attention)
  int red, red_cap;                 // split-K partials (block_gemm)
  int ldk, lds, total;              // K row stride, score row stride, floats in all
};

__host__ __device__ inline int up4(int v) { return (v + 3) & ~3; }

__host__ __device__ inline Layout make_layout(int kT, int d, int dk, int Le) {
  Layout L;
  const int lk = kT > Le ? kT : Le;
  L.ldk = dk + 1;
  L.lds = lk;
  L.x = 0;
  L.xn = L.x + up4(kT * d);
  L.acc = L.xn + up4(kT * d);
  const int scratch = L.acc + up4(kT * d);
  L.q = scratch;
  L.kb = L.q + up4(kT * dk);
  L.vb = L.kb + up4(lk * L.ldk);
  L.oh = L.vb + up4(lk * dk);
  L.s = L.oh + up4(kT * dk);
  const int attn_end = L.s + up4(kT * lk);
  L.h = scratch;
  const int ffn_end = L.h + up4(kT * FCHUNK);
  L.red = attn_end > ffn_end ? attn_end : ffn_end;
  // whatever the block may still opt in to, up to one tile per thread
  const int room = MAX_SMEM_FLOATS - L.red;
  L.red_cap = room < 0 ? 0 : (room < THREADS * RB * 4 ? room : THREADS * RB * 4);
  L.total = L.red + L.red_cap;
  return L;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) decoder_stack_kernel(Params<T> p) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.x;
  const int kT = p.kT, d = p.d, H = p.H, dk = p.dk, Le = p.Le, dff = p.dff;
  const Layout L = make_layout(kT, d, dk, Le);
  float *x = sm + L.x, *xn = sm + L.xn, *acc = sm + L.acc;
  float *q = sm + L.q, *kb = sm + L.kb, *vb = sm + L.vb, *oh = sm + L.oh, *s = sm + L.s;
  float* hb = sm + L.h;
  float* red = sm + L.red;
  const int tid = threadIdx.x, nt = blockDim.x;

  for (int i = tid; i < kT * d; i += nt) x[i] = Num<T>::to_f(p.x[(size_t)b * kT * d + i]);
  __syncthreads();

  // one attention head: scores (+ bias or mask), softmax, oh = rnd(p @ v),
  // acc += oh @ wout. q, kb (stride ldk), vb are filled by the caller.
  auto attend = [&](int lk, const float* bias_h, const float* mask_b, const T* wout) {
    for (int idx = tid; idx < kT * lk; idx += nt) {
      const int i = idx / lk, j = idx % lk;
      float dot = 0.f;
      for (int c = 0; c < dk; ++c) dot = fmaf(q[i * dk + c], kb[j * L.ldk + c], dot);
      s[i * L.lds + j] = dot + (bias_h ? bias_h[i * kT + j] : mask_b[j]);
    }
    __syncthreads();
    softmax_rows<T>(s, kT, lk, L.lds);
    __syncthreads();
    for (int idx = tid; idx < kT * dk; idx += nt) {
      const int i = idx / dk, c = idx % dk;
      float o = 0.f;
      for (int j = 0; j < lk; ++j) o = fmaf(s[i * L.lds + j], vb[j * dk + c], o);
      oh[idx] = Num<T>::rnd(o);
    }
    __syncthreads();
    float* cs[1] = {acc};
    const T* ws[1] = {wout};
    const int ld[1] = {d};
    block_gemm<T, ACCUMULATE>(oh, dk, kT, dk, d, ws, d, cs, ld, 1, red, L.red_cap);
    __syncthreads();
  };
  auto residual_add = [&]() {
    for (int i = tid; i < kT * d; i += nt) x[i] = Num<T>::rnd(x[i] + Num<T>::rnd(acc[i]));
    __syncthreads();
  };
  auto zero_acc = [&]() {
    for (int i = tid; i < kT * d; i += nt) acc[i] = 0.f;
  };

  for (int l = 0; l < p.NL; ++l) {
    // ---- self-attention, beam-folded under bias_fold ----
    rmsnorm<T>(x, p.ln_s + l * d, xn, kT, d, p.eps, false);
    zero_acc();
    __syncthreads();
    for (int h = 0; h < H; ++h) {
      const size_t wofs = ((size_t)l * H + h) * d * dk;
      const T* ws[3] = {p.wq + wofs, p.wk + wofs, p.wv + wofs};
      float* cs[3] = {q, kb, vb};
      const int ld[3] = {dk, L.ldk, dk};
      block_gemm<T, ROUND>(xn, d, kT, d, dk, ws, dk, cs, ld, 3, red, L.red_cap);
      __syncthreads();
      attend(kT, p.bias + (size_t)h * kT * kT, nullptr, p.wo + wofs);
    }
    residual_add();

    // ---- cross-attention against the cached K/V ----
    rmsnorm<T>(x, p.ln_c + l * d, xn, kT, d, p.eps, false);
    zero_acc();
    __syncthreads();
    for (int h = 0; h < H; ++h) {
      const size_t wofs = ((size_t)l * H + h) * d * dk;
      const T* ws[1] = {p.cq + wofs};
      float* cs[1] = {q};
      const int ld[1] = {dk};
      block_gemm<T, ROUND>(xn, d, kT, d, dk, ws, dk, cs, ld, 1, red, L.red_cap);
      const size_t kvofs = (((size_t)l * p.B + b) * H + h) * Le * dk;
      for (int i = tid; i < Le * dk; i += nt) {
        kb[(i / dk) * L.ldk + i % dk] = Num<T>::to_f(p.kc[kvofs + i]);
        vb[i] = Num<T>::to_f(p.vc[kvofs + i]);
      }
      __syncthreads();
      attend(Le, nullptr, p.mask + (size_t)b * Le, p.co + wofs);
    }
    residual_add();

    // ---- FFN: relu(xn @ wi) @ wo2, dff in chunks ----
    rmsnorm<T>(x, p.ln_f + l * d, xn, kT, d, p.eps, false);
    zero_acc();
    __syncthreads();
    for (int c0 = 0; c0 < dff; c0 += FCHUNK) {
      const int nc = dff - c0 < FCHUNK ? dff - c0 : FCHUNK;
      const T* wi_s[1] = {p.wi + (size_t)l * d * dff + c0};
      float* h_s[1] = {hb};
      const int ld_h[1] = {nc};
      block_gemm<T, ROUND_RELU>(xn, d, kT, d, nc, wi_s, dff, h_s, ld_h, 1, red, L.red_cap);
      __syncthreads();
      const T* wo_s[1] = {p.wo2 + ((size_t)l * dff + c0) * d};
      float* a_s[1] = {acc};
      const int ld_a[1] = {d};
      block_gemm<T, ACCUMULATE>(hb, nc, kT, nc, d, wo_s, d, a_s, ld_a, 1, red, L.red_cap);
      __syncthreads();
    }
    residual_add();
  }
  rmsnorm<T>(x, p.ln_final, p.out + (size_t)b * kT * d, kT, d, p.eps, true);
}

template <typename T>
int launch(const void* const* ptrs, const int* dims, float eps, void* stream) {
  Params<T> p;
  p.x = static_cast<const T*>(ptrs[0]);
  p.wq = static_cast<const T*>(ptrs[1]);
  p.wk = static_cast<const T*>(ptrs[2]);
  p.wv = static_cast<const T*>(ptrs[3]);
  p.wo = static_cast<const T*>(ptrs[4]);
  p.cq = static_cast<const T*>(ptrs[5]);
  p.co = static_cast<const T*>(ptrs[6]);
  p.wi = static_cast<const T*>(ptrs[7]);
  p.wo2 = static_cast<const T*>(ptrs[8]);
  p.ln_s = static_cast<const float*>(ptrs[9]);
  p.ln_c = static_cast<const float*>(ptrs[10]);
  p.ln_f = static_cast<const float*>(ptrs[11]);
  p.ln_final = static_cast<const float*>(ptrs[12]);
  p.bias = static_cast<const float*>(ptrs[13]);
  p.kc = static_cast<const T*>(ptrs[14]);
  p.vc = static_cast<const T*>(ptrs[15]);
  p.mask = static_cast<const float*>(ptrs[16]);
  p.out = static_cast<float*>(const_cast<void*>(ptrs[17]));
  p.B = dims[0]; p.kT = dims[1]; p.d = dims[2]; p.NL = dims[3];
  p.H = dims[4]; p.dk = dims[5]; p.dff = dims[6]; p.Le = dims[7];
  p.eps = eps;
  const size_t smem = (size_t)make_layout(p.kT, p.d, p.dk, p.Le).total * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(decoder_stack_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  decoder_stack_kernel<T><<<p.B, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Shared memory one block needs for these widths; the host wrapper refuses
// shapes above the card's 227 KB per block.
int decoder_stack_smem_bytes(int kT, int d, int dk, int Le) {
  return make_layout(kT, d, dk, Le).total * (int)sizeof(float);
}

// ptrs: x, wq, wk, wv, wo, cq, co, wi, wo2, ln_s, ln_c, ln_f, ln_final, bias,
// kc, vc, mask, out. dims: B, kT, d, NL, H, dk, dff, Le.
int decoder_stack_forward(int is_bf16, void* const* ptrs, const int* dims, float eps,
                          void* stream) {
  return is_bf16 ? launch<__nv_bfloat16>(ptrs, dims, eps, stream)
                 : launch<float>(ptrs, dims, eps, stream);
}

}  // extern "C"
