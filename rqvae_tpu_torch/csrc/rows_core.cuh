// Row products shared by the T5 stack kernels, csrc/encoder_stack.cu
// (kernel 3's rows kernel) and csrc/decoder_stack.cu (kernel 2): a block's
// rows in shared memory times a weight matrix in global memory, and the
// RMSNorm both kernels apply to those rows.
//
// Two routes, one arithmetic; each kernel's route function says which a
// shape takes:
//   - float32 (which must not drop to TF32) and bf16 at widths the
//     tensor-core route does not take: the CUDA-core products each kernel
//     keeps, on float32 rows, normalised by rmsnorm_f32.
//   - bf16 at widths that are multiples of 64 (the decoder's: of 128, so that
//     its products halve across a pair of blocks) up to MAX_BN, on the tensor
//     cores: mma_pass. Rows are bf16 in shared memory (every A operand the
//     stacks multiply is a bf16 value in bf16 mode: a normalised row, a head
//     output, a ReLU'd FFN hidden), normalised by rmsnorm_bf16.
//
// mma_pass: acc[rows, bn] += A[rows, K] @ W[K, bn] on mma.sync m16n8k16
// (bf16 operands, float32 sums in registers). Weight K-tiles of BK rows are
// copied global -> shared by 16-byte cp.async from every thread, STAGES
// deep, and fed to the MMA by ldmatrix.trans; the A fragments come from the
// rows by ldmatrix. A kernel's products run as one stream of K-tiles: while
// one product's last tiles are multiplied, the next product's first tiles
// are copied, so no product waits for L2 at its start. What bounds it on the
// H100: an SM draws weight tiles from L2 this way (one 16-byte request per
// copy) at a rate far below the L2's, so a block's time follows its weight
// bytes more than its rows; one bulk copy per tile row (cp.async.bulk) and
// deeper rings measured no faster.
// Staged rows are WLD (weights) or width + 8 (rows) bf16 apart: an odd
// multiple of 16 bytes, so the 8 row reads of an ldmatrix hit distinct banks.
// The block's 8 warps split the output 2 (rows) x 4 (columns); a warp holds
// MI m16 tiles by bn / 32 n8 tiles of float32 sums. A caller keeps a sum
// across several passes (the FFN's sum over dff chunks) by passing the same
// registers again, and then stores it once with for_each_pair, whose functor
// rounds and stores as the reference does (round, round + ReLU, residual
// add). The products' k order differs from the CUDA cores' ascending fmaf
// chain; the products themselves are exact (bf16 x bf16 fits float32).

#pragma once

#include <math.h>

#include "mma_core.cuh"

namespace rows {

using bf16 = __nv_bfloat16;

// dst = rnd(rnd(x * (1 / sqrt(mean(x^2) + eps))) * w) for `rows` float32 rows
// of width d (row stride d); with final_out, dst is the float32 output and
// the outer rounding is left out. sqrt and the division are correctly rounded
// (rsqrtf is not), as in the plain versions.
template <typename T>
__device__ void rmsnorm_f32(const float* x, const float* __restrict__ w, float* dst, int rows, int d, float eps,
                            bool final_out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int i = warp; i < rows; i += nwarps) {
    float ss = 0.f;
    for (int c = lane; c < d; c += 32) ss = fmaf(x[i * d + c], x[i * d + c], ss);
    const float rs = 1.0f / sqrtf(attn::warp_sum(ss) / d + eps);
    for (int c = lane; c < d; c += 32) {
      const float v = attn::Num<T>::rnd(x[i * d + c] * rs) * __ldg(w + c);
      dst[(size_t)i * d + c] = final_out ? v : attn::Num<T>::rnd(v);
    }
  }
}

// The same for `rows` bf16 rows (row stride ldx, d a multiple of 64): into
// bf16 rows (row stride ldd), or with FINAL into float32 rows out (stride d).
template <bool FINAL>
__device__ void rmsnorm_bf16(const bf16* x, int ldx, const float* __restrict__ w, void* dst, int ldd, int rows,
                             int d, float eps) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int i = warp; i < rows; i += nwarps) {
    const __nv_bfloat162* xr = reinterpret_cast<const __nv_bfloat162*>(x + i * ldx);
    float ss = 0.f;
    for (int c = lane; c < d / 2; c += 32) {
      const float2 v = __bfloat1622float2(xr[c]);
      ss = fmaf(v.x, v.x, ss);
      ss = fmaf(v.y, v.y, ss);
    }
    const float rs = 1.0f / sqrtf(attn::warp_sum(ss) / d + eps);
    for (int c = lane; c < d / 2; c += 32) {
      const float2 v = __bfloat1622float2(xr[c]);
      const float2 wv = __ldg(reinterpret_cast<const float2*>(w) + c);
      const float y0 = attn::Num<bf16>::rnd(v.x * rs) * wv.x, y1 = attn::Num<bf16>::rnd(v.y * rs) * wv.y;
      if (FINAL)
        reinterpret_cast<float2*>(static_cast<float*>(dst) + (size_t)i * d)[c] = make_float2(y0, y1);
      else
        reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(dst) + i * ldd)[c] = __floats2bfloat162_rn(y0, y1);
    }
  }
}

constexpr int THREADS = 256;  // 8 warps: 2 (rows) x 4 (columns) of every product
constexpr int WARPS_N = 4;
constexpr int BK = THREADS / 8;  // weight rows per staged K-tile: one 16-byte copy per thread and 64 columns
constexpr int MAX_BN = 384;      // widest output pass
constexpr int WLD = MAX_BN + 8;  // bf16 per staged weight row: 784 B = 49 x 16
constexpr int W_TILE = BK * WLD;

// Row stride, in bf16, of staged rows `width` wide (a multiple of 16).
__host__ __device__ constexpr int row_ld(int width) { return width + 8; }

// One product's weights, W[k][c] = base + (c / 64) * hs + c % 64 + k * ldw
// for k < K, c < bn: a row-major [K, N] matrix (hs = 64, ldw = N), or per-head
// blocks [H, K, 64] (hs = K * 64, ldw = 64). K is a multiple of BK, bn of 64.
struct Weights {
  const bf16* base;
  int hs, ldw, K, bn;
};

__device__ __forceinline__ Weights row_major(const bf16* base, int ldw, int K, int bn) {
  return Weights{base, 64, ldw, K, bn};
}
__device__ __forceinline__ Weights per_head(const bf16* base, int K, int bn) {
  return Weights{base, K * 64, 64, K, bn};
}

// The weight tiles' ring: STAGES tiles of W_TILE in shared memory. seq
// counts the K-tiles of every product so far (tile i sits in stage
// i % STAGES); primed says the next product's first STAGES - 1 tiles are
// already in flight.
struct Pipe {
  bf16* wbuf;
  int seq;
  bool primed;
};

// K-tile kt of w into stage `s` of the ring by cp.async (the caller
// commits): thread t copies row t / 8, bytes (t % 8) * 16 of every 64-column
// block, so no copy address needs a division.
// LDW: the staged tile's row stride (WLD, or less for narrower products).
template <int LDW>
__device__ __forceinline__ void stage_weights(const Pipe& pipe, int s, const Weights& w, int kt) {
  const int r = threadIdx.x >> 3, q = (threadIdx.x & 7) * 8;
  const bf16* g = w.base + (size_t)(kt * BK + r) * w.ldw + q;
  bf16* dst = pipe.wbuf + s * BK * LDW + r * LDW + q;
#pragma unroll
  for (int blk = 0; blk < MAX_BN / 64; ++blk)
    if (blk * 64 < w.bn) attn::cp_async16(dst + blk * 64, g + (size_t)blk * w.hs, true);
}

template <int MI, int NT>
__device__ __forceinline__ void zero(float (&acc)[MI][NT][4]) {
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[mi][j][0] = acc[mi][j][1] = acc[mi][j][2] = acc[mi][j][3] = 0.f;
}

// Copies w's first STAGES - 1 K-tiles, one cp.async group each, so that the
// next mma_pass (with w) starts primed; a kernel calls it before it waits for
// its own rows, so that those and the first weight tiles load together.
template <int STAGES, int LDW = WLD>
__device__ __forceinline__ void prime(Pipe& pipe, const Weights& w) {
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < w.K / BK) stage_weights<LDW>(pipe, (pipe.seq + s) % STAGES, w, s);
    attn::cp_async_commit();
  }
  pipe.primed = true;
}

// acc += A @ W over the block's 2 * MI * 16 rows and w.bn output columns.
// A: bf16 rows in shared memory, row stride lda (row_ld of a multiple of 16),
// w.K columns. w.bn is at most NT * 32, the staged tiles BK x LDW. With next, the last iterations
// already copy next's first STAGES - 1 tiles, so that product starts without
// waiting for L2 (the caller must not touch the ring or commit other
// cp.async groups until it runs); without, every copy has landed on return.
// Every thread of the block calls it; it ends with __syncthreads, so the
// caller may store into rows other warps multiplied.
template <int MI, int NT, int STAGES, int LDW = WLD>
__device__ __forceinline__ void mma_pass(float (&acc)[MI][NT][4], const bf16* A, int lda, const Weights& w,
                                         const Weights* next, Pipe& pipe) {
  static_assert(STAGES >= 2 && BK * 8 == THREADS, "double buffering at least; one copy per thread and 64 columns");
  static_assert(LDW % 16 == 8 && LDW >= NT * 32 + 8, "staged rows: an odd multiple of 16 bytes");
  using namespace attn;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int nt = w.bn / (WARPS_N * 8);  // n8 tiles of this warp, even
  const int nk = w.K / BK;
  // next's first tiles are copied in this product's last STAGES - 1 iterations
  const int next_nk = next != nullptr && nk >= STAGES - 1 ? next->K / BK : 0;
  if (!pipe.primed) {
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < nk) stage_weights<LDW>(pipe, (pipe.seq + s) % STAGES, w, s);
      cp_async_commit();
    }
  }
  const bf16* a_ptr = A + (wm * MI * 16 + a_row(lane)) * lda + a_col(lane);
  const int b_off = bt_row(lane) * LDW + wn * (w.bn / WARPS_N) + bt_col(lane);
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();  // tile kt has landed (this thread's copies) ...
    __syncthreads();              // ... everyone's; and the stage of tile kt - 1 is free
    const int ahead = kt + STAGES - 1, s_ahead = (pipe.seq + ahead) % STAGES;
    if (ahead < nk) stage_weights<LDW>(pipe, s_ahead, w, ahead);
    else if (ahead - nk < next_nk) stage_weights<LDW>(pipe, s_ahead, *next, ahead - nk);
    cp_async_commit();
    const bf16* wt = pipe.wbuf + ((pipe.seq + kt) % STAGES) * BK * LDW + b_off;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      unsigned a[MI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) ldsm_x4(a[mi], a_ptr + mi * 16 * lda + kt * BK + kk * 16);
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        if (2 * jp < nt) {
          unsigned b[4];
          ldsm_x4_t(b, wt + kk * 16 * LDW + jp * 16);
#pragma unroll
          for (int mi = 0; mi < MI; ++mi) {
            mma_16816(acc[mi][2 * jp], a[mi], b[0], b[1]);
            mma_16816(acc[mi][2 * jp + 1], a[mi], b[2], b[3]);
          }
        }
      }
    }
  }
  pipe.seq += nk;
  pipe.primed = next_nk > 0;
  if (!pipe.primed) cp_async_wait<0>();  // only empty groups are left
  __syncthreads();
}

// epi(row, col, v0, v1) for each pair of adjacent output columns (col even)
// this thread holds after mma_pass calls of width bn.
template <int MI, int NT, typename Epi>
__device__ __forceinline__ void for_each_pair(const float (&acc)[MI][NT][4], int bn, const Epi& epi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int nt = bn / (WARPS_N * 8);
  const int row0 = wm * MI * 16 + (lane >> 2), col0 = wn * (bn / WARPS_N) + 2 * (lane & 3);
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < nt) {
        epi(row0 + mi * 16, col0 + j * 8, acc[mi][j][0], acc[mi][j][1]);
        epi(row0 + mi * 16 + 8, col0 + j * 8, acc[mi][j][2], acc[mi][j][3]);
      }
    }
}

// a bf16 pair from shared memory as two floats, and two floats rounded into one
__device__ __forceinline__ float2 load_pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store_pair(bf16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// x = rnd(x + rnd(v)) for a pair of a bf16 residual row: the residual adds
__device__ __forceinline__ void residual_pair(bf16* x, float v0, float v1) {
  const float2 o = load_pair(x);
  store_pair(x, o.x + attn::Num<bf16>::rnd(v0), o.y + attn::Num<bf16>::rnd(v1));
}

// zero `bytes` (a multiple of 16) of shared memory from p
__device__ __forceinline__ void zero_smem(void* p, int bytes) {
  float4* q = static_cast<float4*>(p);
  for (int i = threadIdx.x; i < bytes / 16; i += blockDim.x) q[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

}  // namespace rows
