// Fused T5 encoder-stack forward for long-row serving.
//
// Replaces the Pallas TPU kernel rqvae_tpu/ops/pallas/encoder_stack.py::_kernel
// (via t5_encoder_stack_infer): every encoder layer (RMSNorm, per-head q/k/v,
// softmax(q k^T + bias + mask) v, out-projection, residual; RMSNorm, wi, ReLU,
// wo2, residual) and the final RMSNorm, written as float32.
//
// Bound on the H100 at the long-row serving shape (B = 64, L = 800, d = 384,
// 6 heads of 64, dff = 1024, 4 layers): 0.82 TFLOP against about 135 MB that
// must move, so operations bound it: 0.82 ms at the bf16 tensor-core rate
// (0.57 ms of it the row products, 0.25 ms the attention), 12.2 ms at the
// float32 CUDA-core rate.
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
// A rows block owns a tile of the flattened [B*L, d] stream and keeps it in
// shared memory through its whole chain; the FFN hidden is produced a chunk
// of columns at a time and consumed at once, its sum over dff chunks kept as
// one float32 sum. So what the TPU kernel keeps out of device memory stays
// out (scores, probabilities, FFN hidden, every normalised copy of x); only
// q, k, v, the per-head attention output and the residual stream pass through
// it between kernels, once per layer. Rows past B*L (the last block's) are
// computed on zeros and not stored. Dropped from the TPU kernel: the rank-1
// matmul that materialises the mask, the per-head weight slicing workaround,
// the row padding to 8.
//
// The rows kernel has two routes (encoder_stack_route):
//   - bf16 at dk = 64 and widths that are multiples of 64 (every
//     configuration in the repository): encoder_rows_tc_kernel, 64 rows a
//     block, every product on the tensor cores (rows_core.cuh::mma_pass:
//     mma.sync with weight K-tiles copied by cp.async three deep, the
//     products of a launch one stream of tiles, the first ones loading with
//     the block's rows). x and the A operand are bf16 in shared memory (205
//     KB a block with the hidden chunk and the weight tiles at d = 384), one
//     block per SM, 800 blocks at B*L = 51,200; q, k and v leave through
//     shared memory as 16-byte stores. The out-projection is one
//     [64, H*dk] @ [H*dk, d] product, so its sum over heads is one float32
//     sum, rounded once; the FFN's sum over dff chunks stays in registers.
//     What holds it back on the H100: each block streams a layer's 2.75 MB
//     of weights from L2 (8.8 GB a call), and the copies and the mma.sync
//     products each take a large part of the time and overlap only in part
//     (development runs without the one or the other); the rows, q, k, v
//     and head outputs that pass through device memory between the kernels
//     (about 235 MB a launch) come on top, and 800 blocks make 7 waves of
//     132 for 6.06 waves of work.
//   - float32, and bf16 at other widths: encoder_rows_kernel<T>, 32 rows a
//     block on the CUDA cores: each thread builds an 8 x 4 register tile from
//     float4 reads of its A rows in shared memory and 4-wide weight loads from
//     L2. float32 must not drop to TF32.
//
// Rounding points are the reference's: every value is held as float32 and, in
// bf16 mode, rounded where the reference rounds: the RMSNorm output before and
// after its scale; q, k, v; the normalised p; the head output; the sum over
// heads of the out-projection once; x + attn; relu(round(xn wi));
// round(hf wo2); x + ff; the final norm stays float32. RMSNorm is
// x * (1 / sqrt(mean(x^2) + eps)) with correctly rounded sqrt and division.

#include "attention_core.cuh"
#include "rows_core.cuh"

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
    rows::rmsnorm_f32<T>(x, p.ln_f + (size_t)layer * d, a, TM, d, p.eps, false);
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
    rows::rmsnorm_f32<T>(x, p.ln_final, p.out + (size_t)row0 * d, valid, d, p.eps, true);
    return;
  }
  if (layer >= 0) {
    for (int i = tid; i < TM * d / 4; i += nt) {
      const int r = (i * 4) / d, c = (i * 4) % d;
      if (r < valid)
        Num<T>::store4(p.xs + (size_t)(row0 + r) * d + c, *reinterpret_cast<const float4*>(x + r * d + c));
    }
  }
  rows::rmsnorm_f32<T>(x, p.ln_s + (size_t)next * d, a, TM, d, p.eps, false);
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

// ---- bf16 on the tensor cores ----

using bf16 = __nv_bfloat16;

constexpr int TC_TM = 64;       // rows of [B*L, d] per block: 2 m16 tiles per warp
constexpr int TC_STAGES = 3;    // weight K-tiles in flight
constexpr int TC_FC = 256;      // FFN hidden columns per chunk
constexpr int TC_WI_BN = 128;   // wi output columns per pass (the FFN's sum over chunks holds 96 registers)

// The rows kernel's route; ops/cuda/encoder_stack.py::encoder_stack_route
// mirrors it. bf16 at dk = 64, d and H*dk multiples of 64 up to MAX_BN (one
// output pass), dff a multiple of 64.
__host__ __device__ inline bool tensor_core_route(bool is_bf16, int d, int dk, int inner, int dff) {
  return is_bf16 && dk == 64 && d >= 64 && d % 64 == 0 && d <= rows::MAX_BN && inner >= 64 && inner % 64 == 0 &&
         inner <= rows::MAX_BN && dff >= 64 && dff % 64 == 0;
}

// bf16 offsets of the tensor-core rows kernel's shared regions
struct TcLayout {
  int ldx, lda, ldh;        // row strides of x, the A operand and the FFN hidden chunk
  int x, a, hid, w, rowoff;  // x and A [TC_TM, max(d, inner)], hidden [TC_TM, TC_FC], weight tiles,
                             // and each row's offset in [B, H, L, 64] (TC_TM long longs)
  int total;
};

__host__ __device__ inline TcLayout tc_layout(int d, int inner) {
  TcLayout S;
  S.ldx = rows::row_ld(d > inner ? d : inner);  // x, and last the q, k, v rows on their way out
  S.lda = S.ldx;
  S.ldh = rows::row_ld(TC_FC);
  S.x = 0;
  S.a = S.x + TC_TM * S.ldx;
  S.hid = S.a + TC_TM * S.lda;
  S.w = S.hid + TC_TM * S.ldh;
  S.rowoff = S.w + TC_STAGES * rows::W_TILE;
  S.total = S.rowoff + TC_TM * 4;
  return S;
}

// The same chain as encoder_rows_kernel, for 64 rows, every product on the
// tensor cores and every row in shared memory as bf16 (in bf16 mode each is a
// bf16 value: the residual stream after every add, the normalised rows, the
// heads' outputs, the ReLU'd hidden). Its products are one stream of weight
// K-tiles (rows_core.cuh::Pipe): wo, then wi and wo2 chunk by chunk, then
// the next layer's wq, wk, wv.
__global__ void __launch_bounds__(rows::THREADS, 1) encoder_rows_tc_kernel(Params<bf16> p, int layer) {
  using rows::Weights;
  extern __shared__ float4 tc_smem4[];
  bf16* sm = reinterpret_cast<bf16*>(tc_smem4);
  const int d = p.d, H = p.H, dff = p.dff, L = p.L;
  const int inner = H * 64;
  const TcLayout S = tc_layout(d, inner);
  bf16 *x = sm + S.x, *a = sm + S.a, *hid = sm + S.hid;
  long long* rowoff = reinterpret_cast<long long*>(sm + S.rowoff);
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long n_rows = (long long)p.B * L;
  const long long row0 = (long long)blockIdx.x * TC_TM;
  const int valid = n_rows - row0 < TC_TM ? (int)(n_rows - row0) : TC_TM;
  const size_t head_step = (size_t)L * 64;  // from head h to h + 1 in [B, H, L, 64]
  rows::Pipe pipe{sm + S.w, 0, false};

  // each row's offset in [B, H, L, 64] at head 0
  if (tid < TC_TM) {
    const long long g = row0 + tid;
    rowoff[tid] = tid < valid ? ((g / L) * H * L + g % L) * 64 : 0;
  }
  __syncthreads();
  const int next = layer + 1;
  const bool more = next < p.NL;  // the next layer's q, k, v follow
  const size_t wofs = (size_t)(more ? next : 0) * H * d * 64;
  const Weights wqkv[3] = {rows::per_head(p.wq + wofs, d, inner), rows::per_head(p.wk + wofs, d, inner),
                           rows::per_head(p.wv + wofs, d, inner)};
  const Weights wo = rows::row_major(p.wo + (size_t)(layer >= 0 ? layer : 0) * inner * d, d, inner, d);

  // x <- x_in or xs; with layer >= 0 also A <- the heads' outputs of these
  // rows, concatenated: a[r, h*64 + c]. Zeros past B*L. The first product's
  // weight tiles load meanwhile.
  const bf16* src = layer <= 0 ? p.x_in : p.xs;
  const int xc = d / 8;
  for (int i = tid; i < TC_TM * xc; i += nt) {
    const int r = i / xc, c = (i - r * xc) * 8;
    const bool ok = r < valid;
    attn::cp_async16(x + r * S.ldx + c, src + (ok ? (size_t)(row0 + r) * d + c : 0), ok);
  }
  if (layer >= 0) {
    for (int i = tid; i < TC_TM * (inner / 8); i += nt) {
      const int r = i / (inner / 8), col = (i - r * (inner / 8)) * 8;
      const bool ok = r < valid;
      attn::cp_async16(a + r * S.lda + col, p.oh + (ok ? rowoff[r] + (col >> 6) * head_step + (col & 63) : 0), ok);
    }
  }
  attn::cp_async_commit();
  rows::prime<TC_STAGES>(pipe, layer >= 0 ? wo : wqkv[0]);
  attn::cp_async_wait<TC_STAGES - 1>();  // the rows have landed (the weight tiles may not have)
  __syncthreads();

  if (layer >= 0) {
    const size_t wl = (size_t)layer;
    const bf16 *wi = p.wi + wl * d * dff, *wo2 = p.wo2 + wl * dff * d;
    // the wi product of chunk c0's columns n0 ..
    const auto wi_part = [&](int c0, int n0) {
      const int nc = dff - c0 < TC_FC ? dff - c0 : TC_FC;
      return rows::row_major(wi + c0 + n0, dff, d, nc - n0 < TC_WI_BN ? nc - n0 : TC_WI_BN);
    };
    const auto residual = [&](int r, int c, float v0, float v1) { rows::residual_pair(x + r * S.ldx + c, v0, v1); };
    {
      // x = rnd(x + rnd(concat_h(oh_h) @ wo)): one float32 sum over all heads
      float acc[2][12][4];
      rows::zero(acc);
      const Weights first = wi_part(0, 0);
      rows::mma_pass<2, 12, TC_STAGES>(acc, a, S.lda, wo, &first, pipe);
      rows::for_each_pair(acc, d, residual);
    }
    __syncthreads();

    // FFN: x = rnd(x + rnd(relu(rnd(xn @ wi)) @ wo2)), dff in chunks, one sum
    rows::rmsnorm_bf16<false>(x, S.ldx, p.ln_f + wl * d, a, S.lda, TC_TM, d, p.eps);
    __syncthreads();
    float acc2[2][12][4];
    rows::zero(acc2);
    for (int c0 = 0; c0 < dff; c0 += TC_FC) {
      const int nc = dff - c0 < TC_FC ? dff - c0 : TC_FC;
      const Weights w2 = rows::row_major(wo2 + (size_t)c0 * d, d, nc, d);
      for (int n0 = 0; n0 < nc; n0 += TC_WI_BN) {
        const Weights w1 = wi_part(c0, n0), after = n0 + TC_WI_BN < nc ? wi_part(c0, n0 + TC_WI_BN) : w2;
        float acc1[2][4][4];
        rows::zero(acc1);
        rows::mma_pass<2, 4, TC_STAGES>(acc1, a, S.lda, w1, &after, pipe);
        rows::for_each_pair(acc1, w1.bn, [&](int r, int c, float v0, float v1) {
          rows::store_pair(hid + r * S.ldh + n0 + c, fmaxf(Num<bf16>::rnd(v0), 0.f), fmaxf(Num<bf16>::rnd(v1), 0.f));
        });
      }
      __syncthreads();
      const bool last = c0 + TC_FC >= dff;
      const Weights after = last ? wqkv[0] : wi_part(c0 + TC_FC, 0);
      rows::mma_pass<2, 12, TC_STAGES>(acc2, hid, S.ldh, w2, last && !more ? nullptr : &after, pipe);
    }
    rows::for_each_pair(acc2, d, residual);
    __syncthreads();
  }

  if (!more) {
    rows::rmsnorm_bf16<true>(x, S.ldx, p.ln_final, p.out + (size_t)row0 * d, 0, valid, d, p.eps);
    return;
  }
  if (layer >= 0) {
    for (int i = tid; i < valid * xc; i += nt) {
      const int r = i / xc, c = (i - r * xc) * 8;
      *reinterpret_cast<uint4*>(p.xs + (size_t)(row0 + r) * d + c) =
          *reinterpret_cast<const uint4*>(x + r * S.ldx + c);
    }
  }
  rows::rmsnorm_bf16<false>(x, S.ldx, p.ln_s + (size_t)next * d, a, S.lda, TC_TM, d, p.eps);
  __syncthreads();
  // q, k, v of the next layer: [TC_TM, d] @ [d, H*64] each (head h's columns
  // are wq[next, h]), rounded once, gathered in x (dead now: it is in xs and,
  // normalised, in A) and written to [B, H, L, 64] 16 bytes at a time
  bf16* const dst[3] = {p.q, p.k, p.v};
#pragma unroll 1
  for (int m = 0; m < 3; ++m) {
    float acc[2][12][4];
    rows::zero(acc);
    rows::mma_pass<2, 12, TC_STAGES>(acc, a, S.lda, wqkv[m], m < 2 ? &wqkv[m + 1] : nullptr, pipe);
    rows::for_each_pair(acc, inner, [&](int r, int c, float v0, float v1) {
      rows::store_pair(x + r * S.ldx + c, v0, v1);
    });
    __syncthreads();
    bf16* out = dst[m];
    for (int i = tid; i < valid * (inner / 8); i += nt) {
      const int r = i / (inner / 8), col = (i - r * (inner / 8)) * 8;
      *reinterpret_cast<uint4*>(out + rowoff[r] + (col >> 6) * head_step + (col & 63)) =
          *reinterpret_cast<const uint4*>(x + r * S.ldx + col);
    }
  }
}

// the tensor-core rows kernel takes bf16 only (tensor_core_route)
inline void launch_rows_tc(const Params<float>&, unsigned, size_t, cudaStream_t, int) {}
inline void launch_rows_tc(const Params<bf16>& p, unsigned blocks, size_t smem, cudaStream_t stream, int layer) {
  encoder_rows_tc_kernel<<<blocks, rows::THREADS, smem, stream>>>(p, layer);
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
  ap.dropout = 0; ap.seed = nullptr; ap.b0 = 0; ap.keep_thresh = 0; ap.keep_scale = 1.f;

  const bool tc = tensor_core_route(std::is_same<T, bf16>::value, p.d, p.dk, p.H * p.dk, p.dff);
  const int tm = tc ? TC_TM : TM;
  const size_t smem = tc ? (size_t)tc_layout(p.d, p.H * p.dk).total * sizeof(bf16)
                         : (size_t)rows_smem_floats(p.d, p.H * p.dk) * sizeof(float);
  const long long blocks = ((long long)p.B * p.L + tm - 1) / tm;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaError_t err = tc ? cudaFuncSetAttribute(encoder_rows_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              (int)smem)
                       : cudaFuncSetAttribute(encoder_rows_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              (int)smem);
  if (err != cudaSuccess) return (int)err;
  for (int layer = -1; layer < p.NL; ++layer) {
    if (layer >= 0) {
      err = attn::launch_attention<T>(ap, stream);
      if (err != cudaSuccess) return (int)err;
    }
    if (tc)
      launch_rows_tc(p, (unsigned)blocks, smem, stream, layer);
    else
      encoder_rows_kernel<T><<<(unsigned)blocks, RTHREADS, smem, stream>>>(p, layer);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// The rows kernel's route: 1 = tensor cores (bf16 at widths that are
// multiples of 64), 0 = CUDA cores.
int encoder_stack_route(int is_bf16, int d, int dk, int inner, int dff) {
  return tensor_core_route(is_bf16 != 0, d, dk, inner, dff) ? 1 : 0;
}

// Shared memory a block of the rows kernel needs on its route; the host
// wrapper refuses widths above the card's 227 KB per block.
int encoder_stack_smem_bytes(int is_bf16, int d, int dk, int inner, int dff) {
  return tensor_core_route(is_bf16 != 0, d, dk, inner, dff) ? tc_layout(d, inner).total * (int)sizeof(bf16)
                                                            : rows_smem_floats(d, inner) * (int)sizeof(float);
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
