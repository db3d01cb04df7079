// Fused T5 encoder-stack forward for long-row serving.
//
// Replaces the Pallas TPU kernel rqvae_tpu/ops/pallas/encoder_stack.py::_kernel
// (via t5_encoder_stack_infer): every encoder layer (RMSNorm, per-head q/k/v,
// softmax(q k^T + bias + mask) v, out-projection, residual; RMSNorm, wi, ReLU,
// wo2, residual) and the final RMSNorm, written as float32.
//
// Bound on the H100 at the long-row serving shape (B = 64, L = 800, d = 384,
// 6 heads of 64, dff = 1024, 4 layers): 0.82 TFLOP against about 135 MB that
// must move, so operations bound it: 0.82 ms at the bf16 tensor-core rate,
// 12.2 ms at the float32 CUDA-core rate. This first version runs the row
// products (projections, FFN) on the CUDA cores in both dtypes and only the
// bf16 attention on the tensor cores, so it is far from the bf16 bound.
//
// Design. The TPU kernel holds a batch block's whole residual stream, all
// weights, the [H, L, L] bias and a [bb, L, L] score tensor in VMEM. One
// row's residual stream alone (800 x 384) is over a Hopper block's 227 KB, so
// "one dispatch" becomes one host call that launches a fixed sequence of
// kernels on one stream, 1 + 2 per layer:
//
//   rows(-1):  RMSNorm + q/k/v projections of layer 0
//   per layer: attention (attention_core.cuh, one block per (b, h, 64 queries))
//              rows(l): out-projection + residual, RMSNorm + wi + ReLU + wo2 +
//                       residual, then RMSNorm + q/k/v of layer l + 1, or
//                       after the last layer the final RMSNorm
//
// A rows block owns TM = 32 rows of the flattened [B*L, d] stream and keeps
// them in shared memory through its whole chain; the FFN hidden is produced
// FCHUNK columns at a time and consumed at once. So what the TPU kernel keeps
// out of device memory stays out (scores, probabilities, FFN hidden, every
// normalised copy of x); only q, k, v, the per-head attention output and the
// residual stream pass through it between kernels, once per layer. Weights
// stream from global memory (the 11 MB stack stays in L2) as 4-wide loads
// into RB x 4 register tiles. Dropped from the TPU kernel: the rank-1 matmul
// that materialises the mask, the per-head weight slicing workaround, the row
// padding to 8.
//
// Rounding points are the reference's: every value is held as float32 and, in
// bf16 mode, rounded where the reference rounds: the RMSNorm output before and
// after its scale; q, k, v; the normalised p; the head output; the sum over
// heads of the out-projection once; x + attn; relu(round(xn wi));
// round(hf wo2); x + ff; the final norm stays float32. RMSNorm is
// x * (1 / sqrt(mean(x^2) + eps)) with correctly rounded sqrt and division.

#include "attention_core.cuh"

namespace {

using attn::Num;

constexpr int TM = 32;         // rows of [B*L, d] per block
constexpr int RTHREADS = 512;
constexpr int RB = 8;          // rows per thread in the register tile
constexpr int FCHUNK = 512;    // FFN hidden columns per chunk

template <typename T> struct Params {
  const T* x_in;                 // [B*L, d]
  const T *wq, *wk, *wv;         // [NL, H, d, dk]
  const T* wo;                   // [NL, H, dk, d]
  const T* wi;                   // [NL, d, dff]
  const T* wo2;                  // [NL, dff, d]
  const float *ln_s, *ln_f;      // [NL, d]
  const float* ln_final;         // [d]
  float* out;                    // [B*L, d]
  T* xs;                         // [B*L, d] residual stream between kernels
  T *q, *k, *v;                  // [B, H, L, dk]
  T* oh;                         // [B, H, L, dk] attention output per head
  int B, L, d, NL, H, dk, dff;
  float eps;
};

__host__ __device__ inline int rows_smem_floats(int d, int inner) {
  return TM * d + TM * (d > inner ? d : inner) + TM * d + TM * FCHUNK;
}

// For each of n_mat matrices: acc[TM, N] = A[TM, Kd] @ W, A in shared memory
// (row stride lda), W = w_of(mat) in global memory ([Kd, N], row stride ldw).
// A work item is an RB x 4 output tile; epi(mat, row, col, acc4) takes each of
// its rows. Kd, N, lda, ldw are multiples of 4.
template <typename T, typename WOf, typename Epi>
__device__ __forceinline__ void tile_gemm(const float* __restrict__ A, int lda, int Kd, int N,
                                          int n_mat, WOf w_of, int ldw, Epi epi) {
  const int ncg = N / 4;
  const int per_mat = ncg * (TM / RB);
  for (int item = threadIdx.x; item < per_mat * n_mat; item += blockDim.x) {
    const int mat = item / per_mat;
    const int rem = item % per_mat;
    const int n0 = (rem % ncg) * 4;
    const int m0 = (rem / ncg) * RB;
    const T* __restrict__ w = w_of(mat);
    float acc[RB][4];
#pragma unroll
    for (int r = 0; r < RB; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
#pragma unroll 2
    for (int k = 0; k < Kd; k += 4) {
      float4 a[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) a[r] = *reinterpret_cast<const float4*>(A + (m0 + r) * lda + k);
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
#pragma unroll
    for (int r = 0; r < RB; ++r) epi(mat, m0 + r, n0, acc[r]);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// dst = rnd(rnd(x * (1 / sqrt(mean(x^2) + eps))) * w) over TM rows; with
// final_out, dst is global float32 and the outer rounding is left out.
template <typename T>
__device__ void rmsnorm(const float* x, const float* __restrict__ w, float* dst, int d, float eps,
                        bool final_out, int valid_rows) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int i = warp; i < TM; i += nwarps) {
    if (final_out && i >= valid_rows) continue;
    float ss = 0.f;
    for (int c = lane; c < d; c += 32) ss = fmaf(x[i * d + c], x[i * d + c], ss);
    const float rs = 1.0f / sqrtf(warp_sum(ss) / d + eps);
    for (int c = lane; c < d; c += 32) {
      const float v = Num<T>::rnd(x[i * d + c] * rs) * __ldg(w + c);
      dst[(size_t)i * d + c] = final_out ? v : Num<T>::rnd(v);
    }
  }
}

// layer = -1: x <- x_in; q/k/v of layer 0.
// layer >= 0: x <- (layer == 0 ? x_in : xs); attention out-projection and
// residual; FFN and residual; then q/k/v of layer + 1 with x -> xs, or after
// the last layer the final RMSNorm -> out.
template <typename T>
__global__ void __launch_bounds__(RTHREADS) encoder_rows_kernel(Params<T> p, int layer) {
  extern __shared__ float4 rows_smem4[];
  float* sm = reinterpret_cast<float*>(rows_smem4);
  const int d = p.d, H = p.H, dk = p.dk, dff = p.dff, L = p.L;
  const int inner = H * dk;
  float* x = sm;                                   // [TM, d] residual stream
  float* a = x + TM * d;                           // [TM, max(d, inner)] GEMM input
  float* acc = a + TM * (d > inner ? d : inner);   // [TM, d] FFN accumulator
  float* hid = acc + TM * d;                       // [TM, FCHUNK] FFN hidden chunk
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long rows = (long long)p.B * L;
  const long long row0 = (long long)blockIdx.x * TM;
  const int valid = rows - row0 < TM ? (int)(rows - row0) : TM;

  const T* src = layer <= 0 ? p.x_in : p.xs;
  for (int i = tid; i < TM * d / 4; i += nt) {
    const int r = (i * 4) / d, c = (i * 4) % d;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid) v = Num<T>::load4(src + (size_t)(row0 + r) * d + c);
    *reinterpret_cast<float4*>(x + r * d + c) = v;
  }

  if (layer >= 0) {
    // the heads' outputs of these rows, concatenated: a[r, h*dk + c]
    for (int i = tid; i < TM * inner / 4; i += nt) {
      const int r = (i * 4) / inner, col = (i * 4) % inner;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < valid) {
        const long long g = row0 + r;
        const size_t b = (size_t)(g / L), l = (size_t)(g % L);
        v = Num<T>::load4(p.oh + ((b * H + col / dk) * L + l) * dk + col % dk);
      }
      *reinterpret_cast<float4*>(a + r * inner + col) = v;
    }
    __syncthreads();

    // x = rnd(x + rnd(sum over heads of oh_h @ wo_h)): wo[layer] is [inner, d]
    const T* wo = p.wo + (size_t)layer * inner * d;
    tile_gemm<T>(a, inner, inner, d, 1, [&](int) { return wo; }, d,
                 [&](int, int row, int n0, const float* v) {
#pragma unroll
                   for (int j = 0; j < 4; ++j) {
                     float* xp = x + row * d + n0 + j;
                     *xp = Num<T>::rnd(*xp + Num<T>::rnd(v[j]));
                   }
                 });
    __syncthreads();

    // FFN: x = rnd(x + rnd(relu(rnd(xn @ wi)) @ wo2)), dff in chunks
    rmsnorm<T>(x, p.ln_f + (size_t)layer * d, a, d, p.eps, false, TM);
    for (int i = tid; i < TM * d; i += nt) acc[i] = 0.f;
    __syncthreads();
    for (int c0 = 0; c0 < dff; c0 += FCHUNK) {
      const int nc = dff - c0 < FCHUNK ? dff - c0 : FCHUNK;
      const T* wi = p.wi + (size_t)layer * d * dff + c0;
      tile_gemm<T>(a, d, d, nc, 1, [&](int) { return wi; }, dff,
                   [&](int, int row, int n0, const float* v) {
#pragma unroll
                     for (int j = 0; j < 4; ++j) hid[row * nc + n0 + j] = fmaxf(Num<T>::rnd(v[j]), 0.f);
                   });
      __syncthreads();
      const T* wo2 = p.wo2 + ((size_t)layer * dff + c0) * d;
      tile_gemm<T>(hid, nc, nc, d, 1, [&](int) { return wo2; }, d,
                   [&](int, int row, int n0, const float* v) {
#pragma unroll
                     for (int j = 0; j < 4; ++j) acc[row * d + n0 + j] += v[j];
                   });
      __syncthreads();
    }
    for (int i = tid; i < TM * d; i += nt) x[i] = Num<T>::rnd(x[i] + Num<T>::rnd(acc[i]));
  }
  __syncthreads();

  const int next = layer + 1;
  if (next >= p.NL) {
    rmsnorm<T>(x, p.ln_final, p.out + (size_t)row0 * d, d, p.eps, true, valid);
    return;
  }
  if (layer >= 0) {
    for (int i = tid; i < TM * d / 4; i += nt) {
      const int r = (i * 4) / d, c = (i * 4) % d;
      if (r < valid)
        Num<T>::store4(p.xs + (size_t)(row0 + r) * d + c, *reinterpret_cast<const float4*>(x + r * d + c));
    }
  }
  rmsnorm<T>(x, p.ln_s + (size_t)next * d, a, d, p.eps, false, TM);
  __syncthreads();
  // q, k, v of the next layer: 3 * H products [TM, d] @ [d, dk], each rounded
  // and written to [B, H, L, dk]
  const size_t wofs = (size_t)next * H * d * dk;
  const T* wqkv[3] = {p.wq + wofs, p.wk + wofs, p.wv + wofs};
  T* dst[3] = {p.q, p.k, p.v};
  tile_gemm<T>(a, d, d, dk, 3 * H, [&](int mat) { return wqkv[mat / H] + (size_t)(mat % H) * d * dk; }, dk,
               [&](int mat, int row, int n0, const float* v) {
                 if (row >= valid) return;
                 const long long g = row0 + row;
                 const size_t b = (size_t)(g / L), l = (size_t)(g % L);
                 Num<T>::store4(dst[mat / H] + ((b * H + mat % H) * L + l) * dk + n0,
                                make_float4(v[0], v[1], v[2], v[3]));
               });
}

template <typename T>
int launch(void* const* ptrs, const int* dims, float eps, cudaStream_t stream) {
  Params<T> p;
  p.x_in = static_cast<const T*>(ptrs[0]);
  p.wq = static_cast<const T*>(ptrs[1]);
  p.wk = static_cast<const T*>(ptrs[2]);
  p.wv = static_cast<const T*>(ptrs[3]);
  p.wo = static_cast<const T*>(ptrs[4]);
  p.wi = static_cast<const T*>(ptrs[5]);
  p.wo2 = static_cast<const T*>(ptrs[6]);
  p.ln_s = static_cast<const float*>(ptrs[7]);
  p.ln_f = static_cast<const float*>(ptrs[8]);
  p.ln_final = static_cast<const float*>(ptrs[9]);
  p.out = static_cast<float*>(ptrs[12]);
  p.xs = static_cast<T*>(ptrs[13]);
  p.q = static_cast<T*>(ptrs[14]);
  p.k = static_cast<T*>(ptrs[15]);
  p.v = static_cast<T*>(ptrs[16]);
  p.oh = static_cast<T*>(ptrs[17]);
  p.B = dims[0]; p.L = dims[1]; p.d = dims[2]; p.NL = dims[3];
  p.H = dims[4]; p.dk = dims[5]; p.dff = dims[6];
  p.eps = eps;
  if (p.B < 1 || p.L < 1 || p.NL < 1 || p.d % 4 || p.dk % 4 || p.dff % 4) return (int)cudaErrorInvalidValue;

  attn::Params<T> ap;
  ap.q = p.q; ap.k = p.k; ap.v = p.v;
  ap.bias = static_cast<const float*>(ptrs[10]);
  ap.mask_add = static_cast<const float*>(ptrs[11]);
  ap.mask_keep = nullptr;
  ap.out = p.oh;
  ap.row_max = nullptr; ap.row_sum = nullptr; ap.keep_bits = nullptr;
  ap.B = p.B; ap.H = p.H; ap.Lq = p.L; ap.Lk = p.L; ap.dk = p.dk;
  ap.causal = 0;
  ap.dropout = 0; ap.seed_mix = 0; ap.keep_thresh = 0; ap.keep_scale = 1.f;

  const size_t smem = (size_t)rows_smem_floats(p.d, p.H * p.dk) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(encoder_rows_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = ((long long)p.B * p.L + TM - 1) / TM;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  for (int layer = -1; layer < p.NL; ++layer) {
    if (layer >= 0) {
      err = attn::launch_attention<T>(ap, stream);
      if (err != cudaSuccess) return (int)err;
    }
    encoder_rows_kernel<T><<<(unsigned)blocks, RTHREADS, smem, stream>>>(p, layer);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Shared memory a block of the rows kernel needs; the host wrapper refuses
// widths above the card's 227 KB per block.
int encoder_stack_smem_bytes(int d, int inner) {
  return rows_smem_floats(d, inner) * (int)sizeof(float);
}

// ptrs: x, wq, wk, wv, wo, wi, wo2, ln_s, ln_f, ln_final, bias [H, L, L],
// mask [B, L] additive f32, out [B, L, d] f32, then the scratch the wrapper
// allocates: xs [B, L, d], q, k, v, oh [B, H, L, dk] at the compute dtype.
// dims: B, L, d, NL, H, dk, dff. Launches 1 + 2 NL kernels on `stream`.
int encoder_stack_forward(int is_bf16, void* const* ptrs, const int* dims, float eps, void* stream) {
  return is_bf16 ? launch<__nv_bfloat16>(ptrs, dims, eps, static_cast<cudaStream_t>(stream))
                 : launch<float>(ptrs, dims, eps, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
