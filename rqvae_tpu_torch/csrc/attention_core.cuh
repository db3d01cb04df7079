// T5 attention core shared by csrc/attention.cu and csrc/encoder_stack.cu:
//
//   out = softmax(q k^T + bias[h] + keymask(-1e9) [+ causal(-1e9)]) [dropout] @ v
//
// for one (batch row, head, tile of QT query rows), with no 1/sqrt(dk) scale.
// It carries the arithmetic of the Pallas TPU kernel
// rqvae_tpu/ops/pallas/attention.py::_fwd_kernel, which is also the attention
// step of rqvae_tpu/ops/pallas/encoder_stack.py::_kernel: scores, bias, masks
// and softmax in float32; the NORMALISED probabilities rounded to the compute
// dtype before the PV product; the output rounded once. Masks are -1e9, never
// -inf, so a row whose keys are all masked gets the uniform softmax the
// reference gives, and every query row is computed (keys are masked, queries
// are not).
//
// What the TPU kernel keeps out of device memory stays out: the [Lq, Lk]
// scores and probabilities live in registers and shared memory only. The TPU
// version holds whole rows in VMEM. The usual online softmax would round
// exp(s - m) before the division, which is a different rounding than the
// reference's softmax(s).astype(dtype); so where a row does not fit (long
// rows), the softmax takes two passes over key tiles: pass 1 keeps a running
// row maximum and sum, pass 2 recomputes the same scores (same code, same
// order, so the same bits), divides by the sum, rounds the normalised p and
// accumulates p @ v. The price is a second q k^T.
//
// Three routes, one arithmetic (the route is chosen by forward_route):
//   - CUDA cores (attention_tile): float32, which must not drop to TF32, and
//     bf16 at head widths other than 64. Each thread owns a 4 x 4 tile of a
//     QT x KT score block and a 4 x 4 (per 64 columns of dk) tile of the
//     output, fed by float4 reads of q, k, p and v from shared memory (bf16
//     operands are exact in float32); two passes over 64-key tiles.
//   - bf16 at dk = 64 (the head width of every configuration in the
//     repository), on the tensor cores: a whole-row route for Lk <= 128 and a
//     pipelined tiled route for longer rows (see "the tensor-core routes"
//     below).
// Ragged edges, every route: keys past Lk score -inf (they are no keys at
// all, unlike masked ones) and their v rows are zero; query rows past Lq are
// computed on zeros and not stored.
//
// Dropout (rate > 0): keep bits (hash_core.cuh) are the murmur3 finaliser of the wrapping
// uint32 counter (((b0 + b)*Hg + h0 + h)*Lq + q)*Lk + k XOR seed * 0x9E3779B9, keep iff
// bits >= round(rate * 2^32); dropped p is zeroed and the rest scaled by
// 1/(1-rate) in float32 before the rounding to the compute dtype. The int32
// seed is read from device memory (Params::seed) by every thread that drops,
// as the Pallas kernels read seed_ref[0] from SMEM: a launch captured in a
// CUDA graph reads the seed its buffer holds at replay. b0 (Params::b0) is the
// global index of the launch's first batch row: a data-parallel rank that holds
// rows b0 .. b0 + B - 1 of the global batch draws the global batch's masks, as
// the Pallas kernel's counter is the logical (batch, head, q, k) position. It is
// a launch argument, so a captured launch keeps the rank's constant. h0 and Hg
// (Params::h0, Params::Hg) do the same for heads: a tensor-parallel rank that
// runs heads h0 .. h0 + H - 1 of Hg draws those heads' masks (Hg = H, h0 = 0
// without tensor parallelism).
//
// Row statistics: when Params::row_max / row_sum are set, each row's softmax
// maximum m and sum l are written out ([B, H, Lq] float32), so that the
// backward kernel (csrc/attention_bwd.cu) rebuilds p = exp(s - m) / l from
// the forward's own m and l.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "hash_core.cuh"
#include "mma_core.cuh"

namespace attn {

constexpr float MASKED = -1e9f;
constexpr int QT = 64;        // query rows per block
constexpr int KT = 64;        // keys per tile
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 scores each
constexpr int MAX_DK = 128;   // two float4 output column groups per thread

template <typename T> struct Params {
  const T *q, *k, *v;       // [B, H, Lq, dk], [B, H, Lk, dk] x 2
  const float* bias;        // [H, Lq, Lk]
  const float* mask_add;    // [B, Lk] additive (0 / -1e9), or null
  const int* mask_keep;     // [B, Lk] 1 = attend, used when mask_add is null
  T* out;                   // [B, H, Lq, dk]
  float* row_max;           // [B, H, Lq] softmax row maximum m, or null: not written
  float* row_sum;           // [B, H, Lq] sum l of exp(s - m) over the keys, or null
  unsigned* keep_bits;      // [B, H, Lq, ceil(Lk / 64), 2] the tiled route's dropout keep bits, one 64-bit
                            // word per row and 64-key tile, written for the backward; or null
  int B, H, Lq, Lk, dk;
  int causal;
  int dropout;              // 0: no dropout, the three fields below unused
  const int* seed;          // [1] int32 dropout seed in device memory
  int b0;                   // the global batch index of batch row 0 (the dropout counter's)
  int h0, Hg;               // the global index of head 0 and the global head count (the counter's)
  unsigned keep_thresh;     // keep iff bits >= this
  float keep_scale;         // 1 / (1 - rate)
};

__host__ __device__ inline int smem_floats(int dk) {
  return QT * (dk + 4) + KT * (dk + 4) + KT * dk + QT * (KT + 4) + KT;
}

using hashdrop::keep_bit;
using hashdrop::seed_mix_of;

// max / sum over the 16 lanes that share a query row (tid & 15 varies); the
// butterfly gives every lane the same bits
__device__ __forceinline__ float row_max(float v) {
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__device__ void attention_tile(const Params<T>& p, int b, int h, int q0, float* sm) {
  const int dk = p.dk, Lq = p.Lq, Lk = p.Lk;
  const int ldq = dk + 4, lds = KT + 4, dk4 = dk / 4;
  float* Qs = sm;                // [QT, ldq]
  float* Ks = Qs + QT * ldq;     // [KT, ldq]
  float* Vs = Ks + KT * ldq;     // [KT, dk]
  float* Ss = Vs + KT * dk;      // [QT, lds] rounded probabilities of one tile
  float* madd = Ss + QT * lds;   // [KT] additive key mask of one tile
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t qbase = ((size_t)b * p.H + h) * Lq * dk;
  const size_t kbase = ((size_t)b * p.H + h) * Lk * dk;
  const float* bias_h = p.bias + (size_t)h * Lq * Lk;

  for (int i = tid; i < QT * dk4; i += THREADS) {
    const int r = i / dk4, c = (i % dk4) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < Lq) v = Num<T>::load4(p.q + qbase + (size_t)(q0 + r) * dk + c);
    *reinterpret_cast<float4*>(Qs + r * ldq + c) = v;
  }

  // stage the keys k0 .. k0 + KT - 1 (and their values in pass 2)
  auto stage = [&](int k0, bool with_v) {
    for (int i = tid; i < KT * dk4; i += THREADS) {
      const int r = i / dk4, c = (i % dk4) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (k0 + r < Lk) {
        kv = Num<T>::load4(p.k + kbase + (size_t)(k0 + r) * dk + c);
        if (with_v) vv = Num<T>::load4(p.v + kbase + (size_t)(k0 + r) * dk + c);
      }
      *reinterpret_cast<float4*>(Ks + r * ldq + c) = kv;
      if (with_v) *reinterpret_cast<float4*>(Vs + r * dk + c) = vv;
    }
    for (int j = tid; j < KT; j += THREADS) {
      float a = 0.f;
      if (k0 + j < Lk)
        a = p.mask_add ? p.mask_add[(size_t)b * Lk + k0 + j]
                       : (p.mask_keep[(size_t)b * Lk + k0 + j] != 0 ? 0.f : MASKED);
      madd[j] = a;
    }
  };

  // s[i][j]: query row q0 + ty*4 + i against key k0 + tx + 16*j, in the
  // reference's order ((q.k + bias) + mask) + causal; -inf past Lk
  auto scores = [&](int k0, float (&s)[4][4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int c = 0; c < dk; c += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(Qs + (ty * 4 + i) * ldq + c);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * ldq + c);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      const float* bias_row = bias_h + (size_t)(row < Lq ? row : Lq - 1) * Lk;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        if (key < Lk) {
          float v = s[i][j] + __ldg(bias_row + key);
          v += madd[tx + 16 * j];
          if (p.causal) v += key <= row ? 0.f : MASKED;
          s[i][j] = v;
        } else {
          s[i][j] = -INFINITY;
        }
      }
    }
  };

  // ---- pass 1: row maximum m and sum l of exp(s - m) over all keys ----
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) { m[i] = -INFINITY; l[i] = 0.f; }
  for (int k0 = 0; k0 < Lk; k0 += KT) {
    __syncthreads();  // the tile before is read out (and Qs is written)
    stage(k0, false);
    __syncthreads();
    float s[4][4];
    scores(k0, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float tmax = row_max(fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3])));
      const float mn = fmaxf(m[i], tmax);  // finite: every tile holds a key < Lk
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) sum += expf(s[i][j] - mn);
      l[i] = l[i] * expf(m[i] - mn) + row_sum(sum);
      m[i] = mn;
    }
  }

  // the row statistics, for a backward pass that recomputes p = exp(s - m) / l
  if (p.row_max != nullptr && tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      if (row < Lq) {
        const size_t at = ((size_t)b * p.H + h) * Lq + row;
        p.row_max[at] = m[i];
        p.row_sum[at] = l[i];
      }
    }
  }

  // ---- pass 2: p = round(exp(s - m) / l [dropout]); out += p @ v ----
  const unsigned seed_mix = p.dropout ? seed_mix_of(p.seed) : 0u;
  float o[2][4][4];
#pragma unroll
  for (int g = 0; g < 2; ++g)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[g][i][c] = 0.f;
  for (int k0 = 0; k0 < Lk; k0 += KT) {
    __syncthreads();
    stage(k0, true);
    __syncthreads();
    float s[4][4];
    scores(k0, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float pv = expf(s[i][j] - m[i]) / l[i];
        if (p.dropout) {
          const unsigned key = (unsigned)(k0 + tx + 16 * j);
          const unsigned counter =
              (((unsigned)(p.b0 + b) * (unsigned)p.Hg + (unsigned)(p.h0 + h)) * (unsigned)Lq + (unsigned)row) *
                  (unsigned)Lk + key;
          pv = (keep_bit(counter, seed_mix, p.keep_thresh) ? pv : 0.f) * p.keep_scale;
        }
        Ss[(ty * 4 + i) * lds + tx + 16 * j] = Num<T>::rnd(pv);
      }
    }
    __syncthreads();
    for (int j = 0; j < KT; j += 4) {
      float4 pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = *reinterpret_cast<const float4*>(Ss + (ty * 4 + i) * lds + j);
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        const int c0 = (tx + 16 * g) * 4;
        if (c0 >= dk) continue;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float4 vv = *reinterpret_cast<const float4*>(Vs + (j + t) * dk + c0);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pt = t == 0 ? pr[i].x : t == 1 ? pr[i].y : t == 2 ? pr[i].z : pr[i].w;
            o[g][i][0] = fmaf(pt, vv.x, o[g][i][0]);
            o[g][i][1] = fmaf(pt, vv.y, o[g][i][1]);
            o[g][i][2] = fmaf(pt, vv.z, o[g][i][2]);
            o[g][i][3] = fmaf(pt, vv.w, o[g][i][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const int c0 = (tx + 16 * g) * 4;
    if (c0 >= dk) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      if (row < Lq)
        Num<T>::store4(p.out + qbase + (size_t)row * dk + c0,
                       make_float4(o[g][i][0], o[g][i][1], o[g][i][2], o[g][i][3]));
    }
  }
}

// ---- bf16, dk = 64: the tensor-core routes ----
//
// Every product runs on mma.sync m16n8k16 (bf16 operands, float32 sums),
// fed by ldmatrix from shared memory that cp.async fills. A warp owns 16
// query rows. A score's q.k is always the same instruction sequence: four
// k-steps of 16 over dk in ascending order, from a zero sum (qk_product). The
// backward kernel (attention_bwd.cu) builds its scores with the same routine,
// so on every route its p has the forward's bits.
//
// Whole-row route, Lk <= WR_MAX_KEYS (Amazon's 80 keys): keys are padded to
// a multiple of 16 (nothing at 80); a block stages one (b, h)'s keys, values
// and key mask once, and each warp holds its whole [16, Lk] score row in
// registers (40 floats a thread at 80 keys): one q k^T gives m, l, the
// normalised and rounded p and p @ v, in one pass. A block covers up to 8
// warps of one (b, h)'s query rows (5 at 80 queries). V's B fragments come
// from ldmatrix.trans; p goes from the score registers straight into the PV
// product's A fragments.
//
// Tiled route, Lk > WR_MAX_KEYS (ML-32M's 800): a block of 4 warps (64
// query rows) walks the 64-key tiles twice, pass 1 for m and l, pass 2 for
// the rounded p and p @ v, since the reference rounds the normalised p. The
// next tile's keys (and values, in pass 2) and mask are copied by cp.async
// into the second of two buffers while this tile's products run, and each
// tile's bias rows and mask are copied while its q k^T runs. Warps whose rows
// all lie past Lq copy but do not compute. The bias is read twice per batch
// row (from L2). With dropout and row statistics (training), pass 2 also
// writes each row's keep bits, one 64-bit word per 64-key tile, so that the
// backward reads them instead of hashing every score three more times.
//
// On both routes the work per score element (bias, mask, exp, scale, keep
// bits), not the products, takes most of the time on the card: the exp is
// the hardware's (sm_exp), and tiles whose keys all exist skip the edge checks
// (add_bias_masks).

constexpr int MMA_DK = 64;
constexpr int MMA_LD = 72;        // bf16 per staged row: 144 B, so ldmatrix's 8 row reads hit distinct banks
constexpr int WR_MAX_KEYS = 128;  // whole-row route: at most this many keys
constexpr int WR_MAX_WARPS = 8;   // whole-row route: at most 128 query rows per block
constexpr int TL_WARPS = 4;       // tiled route: 64 query rows per block (128 measured slower at 800 rows)
constexpr int TL_MIN_BLOCKS = 4;  // tiled forward: blocks an SM holds (128 registers; 3 measured slower)
constexpr int TL_KT = 64;         // tiled route: keys per tile

enum Route { ROUTE_CUDA_CORES = 0, ROUTE_WHOLE_ROW = 1, ROUTE_TILED = 2 };

// The forward's route; ops/cuda/attention.py::attention_route mirrors it.
__host__ __device__ inline int forward_route(bool is_bf16, int Lk, int dk) {
  if (!is_bf16 || dk != MMA_DK) return ROUTE_CUDA_CORES;
  return Lk <= WR_MAX_KEYS ? ROUTE_WHOLE_ROW : ROUTE_TILED;
}

// exp(x) and p = exp(s - m) / l of the bf16 routes, forward and backward
// alike: the hardware's exp2 (__expf, a few ulp) and one reciprocal per row.
// Their error is far below the bf16 rounding of p that follows, and the
// backward rebuilds p with the same two functions, so its bits stay the
// forward's. The float32 routine keeps expf and the division.
__device__ __forceinline__ float sm_exp(float x) { return __expf(x); }
__device__ __forceinline__ float sm_p(float s, float m, float inv_l) { return __expf(s - m) * inv_l; }


// rows row0 .. row0 + rows - 1 of src [n_rows, 64] into dst [rows, MMA_LD]
// by cp.async (the caller commits), zeros past n_rows
__device__ __forceinline__ void stage_rows_async(__nv_bfloat16* dst, const __nv_bfloat16* src, int row0, int rows,
                                                 int n_rows) {
  for (int i = threadIdx.x; i < rows * 8; i += blockDim.x) {
    const int r = i >> 3, c = (i & 7) * 8;
    const bool ok = row0 + r < n_rows;
    cp_async16(dst + r * MMA_LD + c, src + (ok ? (size_t)(row0 + r) * MMA_DK + c : 0), ok);
  }
}

// This lane's A fragments of rows row_lo and row_lo + 8 of a [n_rows, 64]
// matrix in global memory, four k-steps of 16; zeros past n_rows.
__device__ __forceinline__ void a_frags_global(unsigned (&a)[4][4], const __nv_bfloat16* base, int row_lo,
                                               int n_rows) {
  const int t = threadIdx.x & 3;
  const unsigned* lo = row_lo < n_rows ? reinterpret_cast<const unsigned*>(base + (size_t)row_lo * MMA_DK) : nullptr;
  const unsigned* hi =
      row_lo + 8 < n_rows ? reinterpret_cast<const unsigned*>(base + (size_t)(row_lo + 8) * MMA_DK) : nullptr;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = lo ? __ldg(lo + kk * 8 + t) : 0u;
    a[kk][1] = hi ? __ldg(hi + kk * 8 + t) : 0u;
    a[kk][2] = lo ? __ldg(lo + kk * 8 + 4 + t) : 0u;
    a[kk][3] = hi ? __ldg(hi + kk * 8 + 4 + t) : 0u;
  }
}

// The same fragments from a staged [rows, MMA_LD] tile, rows r0 .. r0 + 15.
__device__ __forceinline__ void a_frags_smem(unsigned (&a)[4][4], const __nv_bfloat16* tile, int r0) {
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* ap = tile + (r0 + a_row(lane)) * MMA_LD + a_col(lane);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) ldsm_x4(a[kk], ap + kk * 16);
}

// s[j] = q k^T for keys j*8 .. j*8 + 7 of a staged [keys, MMA_LD] tile: four
// k-steps of 16 in ascending order from a zero sum. The one sequence every
// score of the bf16 routes is built with, forward and backward (and dout v^T).
template <int NJ>
__device__ __forceinline__ void qk_product(float (&s)[NJ][4], const unsigned (&qa)[4][4],
                                           const __nv_bfloat16* Ks) {
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* kp = Ks + bn_row(lane) * MMA_LD + bn_col(lane);
#pragma unroll
  for (int j = 0; j < NJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int jp = 0; jp < NJ / 2; ++jp) {
      unsigned kb[4];
      ldsm_x4(kb, kp + jp * 16 * MMA_LD + kk * 16);
      mma_16816(s[2 * jp], qa[kk], kb[0], kb[1]);
      mma_16816(s[2 * jp + 1], qa[kk], kb[2], kb[3]);
    }
}

constexpr int BIAS_LD = TL_KT + 8;  // floats per staged bias row: conflict-free float2 reads

// The bias of rows row0 .. row0 + rows - 1 and keys k0 .. k0 + TL_KT - 1 of
// bias_h [Lq, Lk] into dst [rows, BIAS_LD] by cp.async (the caller commits),
// zeros outside [Lq, Lk]; 16-byte copies where Lk is a multiple of 4.
__device__ __forceinline__ void stage_bias_async(float* dst, const float* bias_h, int row0, int rows, int k0, int Lq,
                                                 int Lk) {
  if ((Lk & 3) == 0) {
    for (int i = threadIdx.x; i < rows * (TL_KT / 4); i += blockDim.x) {
      const int r = i / (TL_KT / 4), c = (i % (TL_KT / 4)) * 4;
      const bool ok = row0 + r < Lq && k0 + c < Lk;  // all four keys or none
      cp_async16(dst + r * BIAS_LD + c, bias_h + (ok ? (size_t)(row0 + r) * Lk + k0 + c : 0), ok);
    }
  } else {
    for (int i = threadIdx.x; i < rows * TL_KT; i += blockDim.x) {
      const int r = i / TL_KT, c = i % TL_KT;
      const bool ok = row0 + r < Lq && k0 + c < Lk;
      cp_async4(dst + r * BIAS_LD + c, bias_h + (ok ? (size_t)(row0 + r) * Lk + k0 + c : 0), ok);
    }
  }
}

// Words k0 .. k0 + n - 1 of one batch row's key mask [Lk] (int32 keep flags
// or float32 additive values) into dst by cp.async, zeros past Lk.
__device__ __forceinline__ void stage_mask_async(unsigned* dst, const void* mask_row, int k0, int n, int Lk) {
  const unsigned* src = static_cast<const unsigned*>(mask_row);
  for (int j = threadIdx.x; j < n; j += blockDim.x) cp_async4(dst + j, src + (k0 + j < Lk ? k0 + j : 0), k0 + j < Lk);
}

// A staged mask word as the additive mask: the value itself (additive), or
// 0 for a kept key and MASKED for a masked one.
__device__ __forceinline__ float mask_value(unsigned w, bool additive) {
  return additive ? __uint_as_float(w) : (w != 0u ? 0.f : MASKED);
}

// s[j][e] becomes ((q.k + bias) + mask) + causal for row row_lo (e < 2) or
// row_lo + 8 and key k0 + j*8 + 2t + (e & 1); -inf past Lk. b_lo and b_hi
// point at the two rows' bias at key k0 (in global or shared memory; pairs:
// two keys at a time, 8-byte aligned), mk at the staged mask words of keys k0 ...
template <int NJ>
__device__ __forceinline__ void add_bias_masks(float (&s)[NJ][4], const float* b_lo, const float* b_hi, bool pairs,
                                               const unsigned* mk, bool additive, int row_lo, int k0, int Lk,
                                               int causal) {
  const int t = threadIdx.x & 3;
  if (pairs && k0 + NJ * 8 <= Lk && !causal) {
    // every key of the tile exists and nothing is causal: the same additions,
    // without the edge checks (which cost more than the additions)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int kl = j * 8 + 2 * t;
      const uint2 w = *reinterpret_cast<const uint2*>(mk + kl);
      const float m0 = mask_value(w.x, additive), m1 = mask_value(w.y, additive);
      const float2 lo = *reinterpret_cast<const float2*>(b_lo + kl), hi = *reinterpret_cast<const float2*>(b_hi + kl);
      s[j][0] = (s[j][0] + lo.x) + m0;
      s[j][1] = (s[j][1] + lo.y) + m1;
      s[j][2] = (s[j][2] + hi.x) + m0;
      s[j][3] = (s[j][3] + hi.y) + m1;
    }
    return;
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row_lo + hh * 8;
    const float* bias_row = hh ? b_hi : b_lo;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int kl = j * 8 + 2 * t, key = k0 + kl;
      float bv[2];
      if (pairs && key < Lk) {
        const float2 b2 = *reinterpret_cast<const float2*>(bias_row + kl);
        bv[0] = b2.x;
        bv[1] = b2.y;
      } else {
        bv[0] = key < Lk ? bias_row[kl] : 0.f;
        bv[1] = key + 1 < Lk ? bias_row[kl + 1] : 0.f;
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& v = s[j][2 * hh + e];
        if (key + e < Lk) {
          v = v + bv[e];
          v += mask_value(mk[kl + e], additive);
          if (causal) v += key + e <= row ? 0.f : MASKED;
        } else {
          v = -INFINITY;
        }
      }
    }
  }
}

// The same, reading the bias of rows row_lo and row_lo + 8 from bias_h
// [Lq, Lk] in global memory (rows past Lq read row Lq - 1).
template <int NJ>
__device__ __forceinline__ void add_bias_masks_global(float (&s)[NJ][4], const float* bias_h, const unsigned* mk,
                                                      bool additive, int row_lo, int k0, int Lq, int Lk, int causal) {
  const float* b_lo = bias_h + (size_t)(row_lo < Lq ? row_lo : Lq - 1) * Lk + k0;
  const float* b_hi = bias_h + (size_t)(row_lo + 8 < Lq ? row_lo + 8 : Lq - 1) * Lk + k0;
  add_bias_masks<NJ>(s, b_lo, b_hi, (Lk & 1) == 0, mk, additive, row_lo, k0, Lk, causal);
}

// ... and from a staged [rows, BIAS_LD] tile whose row 0 is query row q0.
template <int NJ>
__device__ __forceinline__ void add_bias_masks_tile(float (&s)[NJ][4], const float* tile, int q0, const unsigned* mk,
                                                    bool additive, int row_lo, int k0, int Lk, int causal) {
  const float* b_lo = tile + (row_lo - q0) * BIAS_LD;
  add_bias_masks<NJ>(s, b_lo, b_lo + 8 * BIAS_LD, true, mk, additive, row_lo, k0, Lk, causal);
}

__device__ __forceinline__ unsigned drop_counter(int b, int h, int H, int Lq, int Lk, int row, int key) {
  return (((unsigned)b * (unsigned)H + (unsigned)h) * (unsigned)Lq + (unsigned)row) * (unsigned)Lk + (unsigned)key;
}

// batch row b's key mask [Lk]: additive float32 (mask_add) or int32 keep flags
template <typename T> __device__ __forceinline__ const void* mask_row(const Params<T>& p, int b) {
  return p.mask_add ? static_cast<const void*>(p.mask_add + (size_t)b * p.Lk)
                    : static_cast<const void*>(p.mask_keep + (size_t)b * p.Lk);
}

// p = round(exp(s - m) / l [dropout]) in place, and out += p @ v for the keys
// of the staged value tile Vs [keys, MMA_LD] (NJ / 2 k-steps of 16).
// bits: the keep bits' words (Params::keep_bits) to write for this 64-key
// tile, or null.
template <int NJ>
__device__ __forceinline__ void probs_times_v(float (&s)[NJ][4], float (&o)[8][4], const float (&m)[2],
                                              const float (&l)[2], const Params<__nv_bfloat16>& p, int b, int h,
                                              int row_lo, int k0, const __nv_bfloat16* Vs, unsigned* bits) {
  const int lane = threadIdx.x & 31, t = lane & 3;
  const float inv_l[2] = {1.f / l[0], 1.f / l[1]};
  const unsigned seed_mix = p.dropout ? seed_mix_of(p.seed) : 0u;
  unsigned kw[2][2] = {{0u, 0u}, {0u, 0u}};  // [row][keys 0-31, 32-63 of the tile]
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float pv = sm_p(s[j][e], m[e >> 1], inv_l[e >> 1]);
      if (p.dropout) {
        const unsigned c = drop_counter(p.b0 + b, p.h0 + h, p.Hg, p.Lq, p.Lk, row_lo + (e >> 1) * 8, k0 + j * 8 + 2 * t + (e & 1));
        const bool keep = keep_bit(c, seed_mix, p.keep_thresh);
        pv = (keep ? pv : 0.f) * p.keep_scale;
        if (NJ == 8) kw[e >> 1][(j >> 2) & 1] |= (unsigned)keep << ((j & 3) * 8 + 2 * t + (e & 1));
      }
      s[j][e] = pv;
    }
  if (NJ == 8 && bits != nullptr && p.dropout) {  // the quad's words, written by its first lane
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        kw[hh][w] |= __shfl_xor_sync(0xffffffffu, kw[hh][w], 1);
        kw[hh][w] |= __shfl_xor_sync(0xffffffffu, kw[hh][w], 2);
      }
    const int nt = (p.Lk + TL_KT - 1) / TL_KT;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row_lo + hh * 8;
      if (t == 0 && row < p.Lq)
        *reinterpret_cast<uint2*>(bits + (((size_t)b * p.H + h) * p.Lq + row) * nt * 2 + (k0 / TL_KT) * 2) =
            make_uint2(kw[hh][0], kw[hh][1]);
    }
  }
  const __nv_bfloat16* vp = Vs + bt_row(lane) * MMA_LD + bt_col(lane);
#pragma unroll
  for (int kk = 0; kk < NJ / 2; ++kk) {
    const unsigned pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
    for (int jn = 0; jn < 4; ++jn) {
      unsigned vb[4];
      ldsm_x4_t(vb, vp + kk * 16 * MMA_LD + jn * 16);
      mma_16816(o[2 * jn], pa, vb[0], vb[1]);
      mma_16816(o[2 * jn + 1], pa, vb[2], vb[3]);
    }
  }
}

__device__ __forceinline__ void store_rows_bf16(__nv_bfloat16* base, const float (&o)[8][4], int row_lo, int n_rows) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row_lo + hh * 8;
    if (row >= n_rows) continue;
#pragma unroll
    for (int jn = 0; jn < 8; ++jn)
      *reinterpret_cast<unsigned*>(base + (size_t)row * MMA_DK + jn * 8 + 2 * t) =
          pack_bf16(o[jn][2 * hh], o[jn][2 * hh + 1]);
  }
}

__device__ __forceinline__ void store_stats(const Params<__nv_bfloat16>& p, int bh, int row_lo, const float (&m)[2],
                                            const float (&l)[2]) {
  if (p.row_max == nullptr || (threadIdx.x & 3) != 0) return;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row_lo + hh * 8;
    if (row < p.Lq) {
      p.row_max[(size_t)bh * p.Lq + row] = m[hh];
      p.row_sum[(size_t)bh * p.Lq + row] = l[hh];
    }
  }
}

// Whole-row route: one block per (query chunk of up to 128 rows, head, batch
// row), query chunks fastest. NKS: 16-key steps (keys padded to 16 NKS).
template <int NKS>
__global__ void __launch_bounds__(WR_MAX_WARPS * 32) attention_rows_kernel(Params<__nv_bfloat16> p, int q_chunks) {
  using bf16 = __nv_bfloat16;
  constexpr int KP = 16 * NKS, NJ = 2 * NKS;
  __shared__ __align__(16) bf16 Ks[KP * MMA_LD];
  __shared__ __align__(16) bf16 Vs[KP * MMA_LD];
  __shared__ __align__(16) unsigned mk[KP];
  const int Lq = p.Lq, Lk = p.Lk;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  const int bh = blockIdx.x / q_chunks, b = bh / p.H, h = bh % p.H;
  const int q0 = (blockIdx.x % q_chunks) * (int)(blockDim.x / 2);  // 16 rows per warp
  const size_t kbase = (size_t)bh * Lk * MMA_DK;
  stage_rows_async(Ks, p.k + kbase, 0, KP, Lk);
  stage_rows_async(Vs, p.v + kbase, 0, KP, Lk);
  stage_mask_async(mk, mask_row(p, b), 0, KP, Lk);
  cp_async_commit();
  const int row_lo = q0 + warp * 16 + g;
  unsigned qa[4][4];
  a_frags_global(qa, p.q + (size_t)bh * Lq * MMA_DK, row_lo, Lq);
  cp_async_wait_all();
  __syncthreads();
  if (q0 + warp * 16 >= Lq) return;  // no query rows in this warp; no barrier follows

  float s[NJ][4];
  qk_product<NJ>(s, qa, Ks);
  add_bias_masks_global<NJ>(s, p.bias + (size_t)h * Lq * Lk, mk, p.mask_add != nullptr, row_lo, 0, Lq, Lk, p.causal);
  float m[2], l[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < NJ; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * hh], s[j][2 * hh + 1]));
    m[hh] = quad_max(mx);  // finite: key 0 < Lk
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) sum += sm_exp(s[j][2 * hh] - m[hh]) + sm_exp(s[j][2 * hh + 1] - m[hh]);
    l[hh] = quad_sum(sum);
  }
  store_stats(p, bh, row_lo, m, l);
  float o[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  probs_times_v<NJ>(s, o, m, l, p, b, h, row_lo, 0, Vs, nullptr);
  store_rows_bf16(p.out + (size_t)bh * Lq * MMA_DK, o, row_lo, Lq);
}

// Shared memory of the tiled kernel: keys and values (two buffers each), the
// step's bias tile and key mask.
constexpr int TILED_SMEM = 4 * TL_KT * MMA_LD * 2 + TL_WARPS * 16 * BIAS_LD * 4 + TL_KT * 4;

// Tiled route: one block per (64-query tile, head, batch row), query tiles
// fastest, so that the blocks sharing one head's keys and values run close
// together. Each step (one key tile of one pass) first copies its own bias
// tile and mask, then the next step's keys and values, and waits for the bias
// only after its q k^T.
__global__ void __launch_bounds__(TL_WARPS * 32, TL_MIN_BLOCKS) attention_tiled_kernel(Params<__nv_bfloat16> p) {
  using bf16 = __nv_bfloat16;
  extern __shared__ float4 attn_tiled_smem4[];
  bf16* Ks = reinterpret_cast<bf16*>(attn_tiled_smem4);  // [2][TL_KT, MMA_LD]
  bf16* Vs = Ks + 2 * TL_KT * MMA_LD;                     // [2][TL_KT, MMA_LD]
  float* Bs = reinterpret_cast<float*>(Vs + 2 * TL_KT * MMA_LD);  // [128, BIAS_LD]
  unsigned* mk = reinterpret_cast<unsigned*>(Bs + TL_WARPS * 16 * BIAS_LD);
  const int Lq = p.Lq, Lk = p.Lk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2;
  const int q_tiles = (Lq + TL_WARPS * 16 - 1) / (TL_WARPS * 16);
  const int bh = blockIdx.x / q_tiles, b = bh / p.H, h = bh % p.H;
  const int q0 = (blockIdx.x % q_tiles) * TL_WARPS * 16;
  const bool active = q0 + warp * 16 < Lq;  // else this warp copies but does not compute
  const int row_lo = q0 + warp * 16 + g;
  const size_t kbase = (size_t)bh * Lk * MMA_DK;
  const float* bias_h = p.bias + (size_t)h * Lq * Lk;
  const void* mrow = mask_row(p, b);
  const bool additive = p.mask_add != nullptr;
  const int nt = (Lk + TL_KT - 1) / TL_KT, steps = 2 * nt;  // pass 1 over the tiles, then pass 2

  auto prefetch_kv = [&](int step) {
    const int buf = step & 1, k0 = (step % nt) * TL_KT;
    stage_rows_async(Ks + buf * TL_KT * MMA_LD, p.k + kbase, k0, TL_KT, Lk);
    if (step >= nt) stage_rows_async(Vs + buf * TL_KT * MMA_LD, p.v + kbase, k0, TL_KT, Lk);
    cp_async_commit();
  };
  prefetch_kv(0);
  unsigned qa[4][4];
  a_frags_global(qa, p.q + (size_t)bh * Lq * MMA_DK, row_lo, Lq);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, o[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int step = 0; step < steps; ++step) {
    const int buf = step & 1, k0 = (step % nt) * TL_KT;
    cp_async_wait_all();
    __syncthreads();  // this step's keys have landed; the other buffers are read out
    stage_bias_async(Bs, bias_h, q0, TL_WARPS * 16, k0, Lq, Lk);
    stage_mask_async(mk, mrow, k0, TL_KT, Lk);
    cp_async_commit();
    if (step + 1 < steps) {
      prefetch_kv(step + 1);
      cp_async_wait_but_one();
    } else {
      cp_async_wait_all();
    }
    float s[8][4];
    if (active) qk_product<8>(s, qa, Ks + buf * TL_KT * MMA_LD);
    __syncthreads();  // this step's bias and mask have landed
    if (!active) continue;
    add_bias_masks_tile<8>(s, Bs, q0, mk, additive, row_lo, k0, Lk, p.causal);
    if (step < nt) {  // pass 1: running row maximum and sum of exp(s - m)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float tmax = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j) tmax = fmaxf(tmax, fmaxf(s[j][2 * hh], s[j][2 * hh + 1]));
        const float mn = fmaxf(m[hh], quad_max(tmax));  // finite: every tile holds a key < Lk
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) sum += sm_exp(s[j][2 * hh] - mn) + sm_exp(s[j][2 * hh + 1] - mn);
        l[hh] = l[hh] * sm_exp(m[hh] - mn) + quad_sum(sum);
        m[hh] = mn;
      }
      if (step == nt - 1) store_stats(p, bh, row_lo, m, l);
    } else {  // pass 2
      probs_times_v<8>(s, o, m, l, p, b, h, row_lo, k0, Vs + buf * TL_KT * MMA_LD, p.keep_bits);
    }
  }
  if (active) store_rows_bf16(p.out + (size_t)bh * Lq * MMA_DK, o, row_lo, Lq);
}

template <int NKS>
cudaError_t launch_rows(const Params<__nv_bfloat16>& p, unsigned blocks, int threads, int q_chunks,
                        cudaStream_t stream) {
  attention_rows_kernel<NKS><<<blocks, threads, 0, stream>>>(p, q_chunks);
  return cudaGetLastError();
}

inline cudaError_t launch_mma(const Params<float>&, cudaStream_t) { return cudaErrorInvalidValue; }
inline cudaError_t launch_mma(const Params<__nv_bfloat16>& p, cudaStream_t stream) {
  const long long bh = (long long)p.B * p.H;
  if (forward_route(true, p.Lk, p.dk) == ROUTE_TILED) {
    const long long blocks = bh * ((p.Lq + TL_WARPS * 16 - 1) / (TL_WARPS * 16));
    if (blocks > 2147483647LL) return cudaErrorInvalidValue;
    const cudaError_t err =
        cudaFuncSetAttribute(attention_tiled_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TILED_SMEM);
    if (err != cudaSuccess) return err;
    attention_tiled_kernel<<<(unsigned)blocks, TL_WARPS * 32, TILED_SMEM, stream>>>(p);
    return cudaGetLastError();
  }
  const int warps = (p.Lq + 15) / 16 < WR_MAX_WARPS ? (p.Lq + 15) / 16 : WR_MAX_WARPS;
  const int q_chunks = (p.Lq + warps * 16 - 1) / (warps * 16);
  const long long blocks = bh * q_chunks;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  const unsigned nb = (unsigned)blocks;
  switch ((p.Lk + 15) / 16) {
    case 1: return launch_rows<1>(p, nb, warps * 32, q_chunks, stream);
    case 2: return launch_rows<2>(p, nb, warps * 32, q_chunks, stream);
    case 3: return launch_rows<3>(p, nb, warps * 32, q_chunks, stream);
    case 4: return launch_rows<4>(p, nb, warps * 32, q_chunks, stream);
    case 5: return launch_rows<5>(p, nb, warps * 32, q_chunks, stream);
    case 6: return launch_rows<6>(p, nb, warps * 32, q_chunks, stream);
    case 7: return launch_rows<7>(p, nb, warps * 32, q_chunks, stream);
    default: return launch_rows<8>(p, nb, warps * 32, q_chunks, stream);
  }
}

// One block per (query tile, head, batch row) for the CUDA-core routine,
// query tiles fastest.
template <typename T>
__global__ void __launch_bounds__(THREADS, 2) attention_kernel(Params<T> p) {
  extern __shared__ float4 attn_smem4[];
  const int q_tiles = (p.Lq + QT - 1) / QT;
  const int qt = blockIdx.x % q_tiles;
  const int bh = blockIdx.x / q_tiles;
  attention_tile<T>(p, bh / p.H, bh % p.H, qt * QT, reinterpret_cast<float*>(attn_smem4));
}

// Launches on `stream`; returns the launch's cudaError_t. The host wrapper
// checks dk (a multiple of 4, at most MAX_DK) and the block count.
template <typename T> cudaError_t launch_attention(const Params<T>& p, cudaStream_t stream) {
  if (p.dk % 4 || p.dk > MAX_DK || p.dk < 4 || p.Lq < 1 || p.Lk < 1 || p.B < 1 || p.H < 1 || p.h0 < 0 ||
      p.Hg < p.h0 + p.H)
    return cudaErrorInvalidValue;
  if (forward_route(std::is_same<T, __nv_bfloat16>::value, p.Lk, p.dk) != ROUTE_CUDA_CORES)
    return launch_mma(p, stream);
  const long long blocks = (long long)((p.Lq + QT - 1) / QT) * p.H * p.B;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  const size_t smem = (size_t)smem_floats(p.dk) * sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  attention_kernel<T><<<(unsigned)blocks, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace attn
