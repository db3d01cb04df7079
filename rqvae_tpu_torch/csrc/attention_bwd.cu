// Fused T5 attention backward: dq, dk, dv and dbias (summed over the batch) of
//
//   out = softmax(q k^T + bias + mask [+ causal]) [dropout] @ v
//
// from q, k, v, bias, mask, the seed, the forward's row statistics and dout.
//
// Replaces the Pallas TPU kernel rqvae_tpu/ops/pallas/attention.py::_bwd_kernel
// (via _bwd_call / _fused_bwd). Its arithmetic, kept here:
//
//   s   = ((q.k + bias) + mask) + causal            float32, masks -1e9
//   p   = exp(s - m) / l                            m, l: the forward's own
//   pd  = keep ? p * scale : 0                      the forward's keep bits
//   dv  = round(pd)^T dout                          pd rounded to the compute dtype
//   dpd = dout v^T                                  summed in float32
//   dp  = keep ? dpd * scale : 0
//   ds  = p * (dp - sum_k(dp * p))                  float32, over the whole row
//   dq  = round(ds) k,  dk = round(ds)^T q          ds rounded to the compute dtype
//   dbias[h] = sum_b ds                             from the unrounded float32 ds
//
// dq, dk, dv are summed in float32 and rounded once to q's dtype.
//
// The TPU kernel holds whole [Lq, Lk] score rows of a batch block in VMEM and
// walks the batch sequentially, adding into one resident dbias block. A Hopper
// block has 227 KB and the blocks run in no order, so every sum here is taken
// in a fixed order instead (no float atomics: two launches on the same inputs
// give the same bits), and what the TPU kernel keeps out of device memory
// stays out: scores, p, dp and ds live in registers and shared memory only.
// dbias is summed per batch group, in batch order, into the group's partial
// [groups, H, Lq, Lk] (dbias itself for one group), and reduce_groups_kernel
// adds the partials in group order. Three routes (backward_route; the wrapper
// picks the batch groups for each):
//
// Whole-row route: bf16, dk = 64, Lq and Lk <= 128 (Amazon's 80 x 80). One
// kernel, bwd_rows_kernel, one block per (head, batch group), which walks its
// group's batch rows in order, as the Pallas grid (H, B blocks) with its
// "arbitrary" batch axis does. For each batch row, q, k, v and dout are
// staged whole by cp.async (the next row's k and v while this row's last
// products run), and exactly the reference's five products run on mma.sync:
//   phase A, a warp per 16 query rows, whole score rows in registers:
//     s = q k^T, p from the forward's m and l, pd; dpd = dout v^T, dp; the row
//     term in registers; ds; dbias += ds in shared memory; dq = round(ds) k
//     (k's B fragments by ldmatrix.trans);
//   phase B, a warp per 16 keys, from round(pd) and round(ds) left in shared
//     memory by phase A: dv = round(pd)^T dout, dk = round(ds)^T q (A
//     fragments of pd^T and ds^T, B fragments of dout and q, all by
//     ldmatrix.trans).
// The group's partial dbias [Lq, Lk] stays in shared memory across its rows.
//
// Tiled route: bf16, dk = 64, longer rows (ML-32M's 800). Four kernels:
//   1. bwd_delta_tiled_kernel, one block of 4 warps per (batch row, head, 64
//      queries): walks the 64-key tiles and writes the row term [B, H, Lq];
//   2. bwd_dkv_tiled_kernel, one block of 4 warps per (batch row, head, 64
//      keys): walks the 64-query tiles (double-buffered q and dout), phase A
//      and B as above per tile, dv and dk summed in registers;
//   3. bwd_dq_tiled_kernel, one block of 4 warps per (64 queries, head, batch
//      group): walks its group's batch rows in order and, inside, the key
//      tiles (double-buffered k and v): dq in registers, the unrounded ds
//      added into its own region of the group's partial dbias in device
//      memory (a plain read-modify-write: no other block touches the region);
//   4. reduce_groups_kernel.
// Every product is on mma.sync, operands staged as bf16 by cp.async and read
// by ldmatrix; each step's bias tile (and row statistics, and partial dbias)
// is copied while its q k^T runs. It computes 9 products where the reference
// computes 5 (kernel 1: q k^T and dout v^T; kernel 2: those and the two that
// give dv and dk; kernel 3: those and the one that gives dq): a score row of
// 800 keys does not fit a warp, and dq and dk sum along different axes. With
// dropout, the keep bits come from the forward (one 64-bit word per row and
// 64-key tile, written by the tiled forward) instead of three more hashes per
// score; without them (keep_bits null) the kernels hash anew, the same bits.
// The groups are as many as keep their partial dbias regions in L2 together
// (3 at the long-row shape), since each batch row reads and writes them.
//
// CUDA-core route: float32 (which must not drop to TF32), and bf16 at other
// head widths than 64: the same four kernels with 64 x 64 tiles staged as
// float32 (bf16 values are exact there, and every rounding point above is
// applied explicitly), each thread owning 4 x 4 pieces fed by float4 reads.
//
// The same p as the forward's, bit for bit: the bf16 routes build q.k with
// the forward's own instruction sequence (attn::qk_product: mma.sync, four
// k-steps of 16 in ascending order from zero), the CUDA-core route with the
// forward's CUDA-core order (one fused multiply-add per element of dk in
// ascending order); then ((q.k + bias) + mask) + causal, and
// exp(s - m) / l from the forward's own m and l, by the forward's own
// functions (attn::sm_p on the bf16 routes: the hardware exp and 1 / l).
//
// Bound on the H100 (5 products, q, k, v, dout, bias, mask in, dq, dk, dv,
// dbias out): at the Amazon training shape [640, 6, 80, 64] 15.7 GFLOP and
// about 275 MB in bf16, bound by bytes (0.082 ms); at the long-row shape
// [64, 6, 800, 64] 157 GFLOP, bound by operations (0.159 ms). Beside the
// bound, the tiled route reads the f32 bias three times per batch row (from
// L2) and moves the partial dbias through a read and a write per batch row:
// 2 x 64 x 6 x 800 x 800 x 4 B = 1.97 GB at the long-row shape.

#include "attention_core.cuh"

namespace {

using attn::keep_bit;
using attn::seed_mix_of;
using attn::MASKED;
using attn::Num;
using attn::row_sum;

constexpr int QT = 64;        // query rows per tile
constexpr int KT = 64;        // keys per tile
constexpr int THREADS = 256;  // 16 x 16 threads, a 4 x 4 piece of a tile each
constexpr int MAX_DK = 128;
constexpr int LDS = KT + 4;   // floats per row of a [QT, KT] tile in shared memory

template <typename T> struct BwdParams {
  const T *q, *k, *v, *dout;  // [B, H, Lq, dk], [B, H, Lk, dk] x 2, [B, H, Lq, dk]
  const float* bias;          // [H, Lq, Lk]
  const int* mask;            // [B, Lk] 1 = attend
  const float *row_max, *row_sum;  // [B, H, Lq] from the forward
  float* delta;               // [B, H, Lq] scratch: sum_k(dp * p)
  T *dq, *dk, *dv;
  float* dbias_part;          // [groups, H, Lq, Lk]; dbias itself when groups == 1
  float* dbias;               // [H, Lq, Lk]
  const unsigned* keep_bits;  // the tiled forward's keep bits (attn::Params::keep_bits), or null: hashed anew
  int B, H, Lq, Lk, dkw;      // dkw: head width
  int causal, dropout, groups;
  const int* seed;            // [1] int32 dropout seed in device memory (read as the forward reads it)
  int b0;                     // the global batch index of batch row 0 (attn::Params::b0)
  unsigned keep_thresh;
  float keep_scale;
};

// Shared memory of a block: four [64, dk + 4] operand tiles, two [64, 68]
// score-shaped tiles and the key tile's additive mask.
struct Smem {
  float *Qs, *Os, *Ks, *Vs, *Ss, *Ds, *madd;
  int ld;
  __device__ Smem(float* base, int dk) : ld(dk + 4) {
    Qs = base;
    Os = Qs + QT * ld;
    Ks = Os + QT * ld;
    Vs = Ks + KT * ld;
    Ss = Vs + KT * ld;
    Ds = Ss + QT * LDS;
    madd = Ds + QT * LDS;
  }
};

__host__ __device__ inline size_t smem_floats(int dk) {
  return (size_t)4 * 64 * (dk + 4) + 2 * QT * LDS + KT;
}

// rows row0 .. row0 + 63 of src [n_rows, dk] into dst [64, ld] as float32,
// zeros past n_rows
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, int ld, const T* src, int row0, int n_rows, int dk) {
  const int dk4 = dk / 4;
  for (int i = threadIdx.x; i < 64 * dk4; i += THREADS) {
    const int r = i / dk4, c = (i % dk4) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows) v = Num<T>::load4(src + (size_t)(row0 + r) * dk + c);
    *reinterpret_cast<float4*>(dst + r * ld + c) = v;
  }
}

template <typename T>
__device__ __forceinline__ void stage_mask(float* madd, const BwdParams<T>& P, int b, int k0) {
  for (int j = threadIdx.x; j < KT; j += THREADS) {
    float a = 0.f;
    if (k0 + j < P.Lk) a = P.mask[(size_t)b * P.Lk + k0 + j] != 0 ? 0.f : MASKED;
    madd[j] = a;
  }
}

// The forward's statistics and (optionally) the row term of this thread's
// four query rows; rows past Lq get m = 0, l = 1, delta = 0.
template <typename T>
__device__ __forceinline__ void load_rows(const BwdParams<T>& P, int b, int h, int q0, float (&m)[4],
                                          float (&l)[4], float (&delta)[4], bool with_delta) {
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    m[i] = 0.f; l[i] = 1.f; delta[i] = 0.f;
    if (row < P.Lq) {
      const size_t at = ((size_t)b * P.H + h) * P.Lq + row;
      m[i] = __ldg(P.row_max + at);
      l[i] = __ldg(P.row_sum + at);
      if (with_delta) delta[i] = P.delta[at];
    }
  }
}

// This thread's 4 x 4 pieces of q k^T (into p) and dout v^T (into dp) on the
// CUDA cores: one fused multiply-add per element of dk in ascending order.
__device__ __forceinline__ void cuda_core_products(const Smem& sm, int dk, float (&p)[4][4], float (&dp)[4][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4, ld = sm.ld;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) p[i][j] = dp[i][j] = 0.f;
  for (int c = 0; c < dk; c += 4) {
    float4 qv[4], ov[4], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = *reinterpret_cast<const float4*>(sm.Qs + (ty * 4 + i) * ld + c);
      ov[i] = *reinterpret_cast<const float4*>(sm.Os + (ty * 4 + i) * ld + c);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kv[j] = *reinterpret_cast<const float4*>(sm.Ks + (tx + 16 * j) * ld + c);
      vv[j] = *reinterpret_cast<const float4*>(sm.Vs + (tx + 16 * j) * ld + c);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = fmaf(qv[i].x, kv[j].x, p[i][j]);
        p[i][j] = fmaf(qv[i].y, kv[j].y, p[i][j]);
        p[i][j] = fmaf(qv[i].z, kv[j].z, p[i][j]);
        p[i][j] = fmaf(qv[i].w, kv[j].w, p[i][j]);
        dp[i][j] = fmaf(ov[i].x, vv[j].x, dp[i][j]);
        dp[i][j] = fmaf(ov[i].y, vv[j].y, dp[i][j]);
        dp[i][j] = fmaf(ov[i].z, vv[j].z, dp[i][j]);
        dp[i][j] = fmaf(ov[i].w, vv[j].w, dp[i][j]);
      }
  }
}

// For the staged tiles (queries q0.., keys k0..): this thread's 4 x 4 piece of
// p (no dropout yet; 0 outside [Lq, Lk]) and of dp (dropout applied), element
// [i][j] being query row q0 + ty*4 + i against key k0 + tx + 16*j, and the
// keep bits (bit i*4 + j). The scores are built as the forward's CUDA-core
// routine builds them: q.k by ascending fused multiply-adds, then
// ((q.k + bias) + mask) + causal.
template <typename T>
__device__ __forceinline__ unsigned tile_p_dp(const BwdParams<T>& P, const Smem& sm, int b, int h, int q0, int k0,
                                              const float (&m)[4], const float (&l)[4], float (&p)[4][4],
                                              float (&dp)[4][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  cuda_core_products(sm, P.dkw, p, dp);
  const unsigned seed_mix = P.dropout ? seed_mix_of(P.seed) : 0u;
  unsigned keep = 0xFFFFu;
  const float* bias_h = P.bias + (size_t)h * P.Lq * P.Lk;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    const float* bias_row = bias_h + (size_t)(row < P.Lq ? row : P.Lq - 1) * P.Lk;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = k0 + tx + 16 * j;
      float pv = 0.f;
      if (row < P.Lq && key < P.Lk) {
        float s = p[i][j] + __ldg(bias_row + key);
        s += sm.madd[tx + 16 * j];
        if (P.causal) s += key <= row ? 0.f : MASKED;
        pv = expf(s - m[i]) / l[i];
      }
      p[i][j] = pv;
      if (P.dropout) {
        const unsigned counter =
            (((unsigned)(P.b0 + b) * (unsigned)P.H + (unsigned)h) * (unsigned)P.Lq + (unsigned)row) * (unsigned)P.Lk +
            (unsigned)key;
        if (keep_bit(counter, seed_mix, P.keep_thresh)) {
          dp[i][j] *= P.keep_scale;
        } else {
          dp[i][j] = 0.f;
          keep &= ~(1u << (i * 4 + j));
        }
      }
    }
  }
  return keep;
}

// ---- 1. the row term: delta[b, h, q] = sum_k dp * p over the whole row ----
template <typename T>
__global__ void __launch_bounds__(THREADS, 2) delta_kernel(BwdParams<T> P) {
  extern __shared__ float4 bwd_smem4[];
  const Smem sm(reinterpret_cast<float*>(bwd_smem4), P.dkw);
  const int q_tiles = (P.Lq + QT - 1) / QT;
  const int q0 = (blockIdx.x % q_tiles) * QT;
  const int bh = blockIdx.x / q_tiles, b = bh / P.H, h = bh % P.H;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4, dk = P.dkw;
  const size_t qbase = (size_t)bh * P.Lq * dk, kbase = (size_t)bh * P.Lk * dk;

  stage_rows<T>(sm.Qs, sm.ld, P.q + qbase, q0, P.Lq, dk);
  stage_rows<T>(sm.Os, sm.ld, P.dout + qbase, q0, P.Lq, dk);
  float m[4], l[4], unused[4], acc[4] = {0.f, 0.f, 0.f, 0.f};
  load_rows<T>(P, b, h, q0, m, l, unused, false);
  for (int k0 = 0; k0 < P.Lk; k0 += KT) {
    __syncthreads();  // the tile before is read out
    stage_rows<T>(sm.Ks, sm.ld, P.k + kbase, k0, P.Lk, dk);
    stage_rows<T>(sm.Vs, sm.ld, P.v + kbase, k0, P.Lk, dk);
    stage_mask<T>(sm.madd, P, b, k0);
    __syncthreads();
    float p[4][4], dp[4][4];
    tile_p_dp<T>(P, sm, b, h, q0, k0, m, l, p, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i] = fmaf(dp[i][j], p[i][j], acc[i]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float d = row_sum(acc[i]);  // the 16 lanes of a row, fixed butterfly order
    const int row = q0 + ty * 4 + i;
    if (tx == 0 && row < P.Lq) P.delta[((size_t)b * P.H + h) * P.Lq + row] = d;
  }
}

// ---- 2. dv = round(pd)^T dout and dk = round(ds)^T q for one key tile ----
// NG: 64-column groups of the head width (1 for dk <= 64, else 2).
template <typename T, int NG>
__global__ void __launch_bounds__(THREADS, 2) dkv_kernel(BwdParams<T> P) {
  extern __shared__ float4 bwd_smem4[];
  const Smem sm(reinterpret_cast<float*>(bwd_smem4), P.dkw);
  const int k_tiles = (P.Lk + KT - 1) / KT;
  const int k0 = (blockIdx.x % k_tiles) * KT;
  const int bh = blockIdx.x / k_tiles, b = bh / P.H, h = bh % P.H;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4, dk = P.dkw, ld = sm.ld;
  const size_t qbase = (size_t)bh * P.Lq * dk, kbase = (size_t)bh * P.Lk * dk;

  stage_rows<T>(sm.Ks, ld, P.k + kbase, k0, P.Lk, dk);
  stage_rows<T>(sm.Vs, ld, P.v + kbase, k0, P.Lk, dk);
  stage_mask<T>(sm.madd, P, b, k0);
  // this thread's outputs: key rows k0 + ty*4 + i, columns (tx + 16*g)*4 ..+3
  float dv[NG][4][4], dkk[NG][4][4];
#pragma unroll
  for (int g = 0; g < NG; ++g)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) dv[g][i][c] = dkk[g][i][c] = 0.f;

  for (int q0 = 0; q0 < P.Lq; q0 += QT) {
    __syncthreads();  // the tile before is read out (and Ks, Vs, madd are written)
    stage_rows<T>(sm.Qs, ld, P.q + qbase, q0, P.Lq, dk);
    stage_rows<T>(sm.Os, ld, P.dout + qbase, q0, P.Lq, dk);
    __syncthreads();
    float m[4], l[4], delta[4], p[4][4], dp[4][4];
    load_rows<T>(P, b, h, q0, m, l, delta, true);
    const unsigned keep = tile_p_dp<T>(P, sm, b, h, q0, k0, m, l, p, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float pd = p[i][j];
        if (P.dropout) pd = ((keep >> (i * 4 + j)) & 1u ? pd : 0.f) * P.keep_scale;
        sm.Ss[(ty * 4 + i) * LDS + tx + 16 * j] = Num<T>::rnd(pd);
        sm.Ds[(ty * 4 + i) * LDS + tx + 16 * j] = Num<T>::rnd(p[i][j] * (dp[i][j] - delta[i]));
      }
    __syncthreads();
    for (int qq = 0; qq < QT; ++qq) {
      const float4 pr = *reinterpret_cast<const float4*>(sm.Ss + qq * LDS + ty * 4);
      const float4 dr = *reinterpret_cast<const float4*>(sm.Ds + qq * LDS + ty * 4);
      const float pk[4] = {pr.x, pr.y, pr.z, pr.w}, dsk[4] = {dr.x, dr.y, dr.z, dr.w};
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const int c0 = (tx + 16 * g) * 4;
        if (c0 >= dk) continue;
        const float4 ov = *reinterpret_cast<const float4*>(sm.Os + qq * ld + c0);
        const float4 qv = *reinterpret_cast<const float4*>(sm.Qs + qq * ld + c0);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv[g][i][0] = fmaf(pk[i], ov.x, dv[g][i][0]);
          dv[g][i][1] = fmaf(pk[i], ov.y, dv[g][i][1]);
          dv[g][i][2] = fmaf(pk[i], ov.z, dv[g][i][2]);
          dv[g][i][3] = fmaf(pk[i], ov.w, dv[g][i][3]);
          dkk[g][i][0] = fmaf(dsk[i], qv.x, dkk[g][i][0]);
          dkk[g][i][1] = fmaf(dsk[i], qv.y, dkk[g][i][1]);
          dkk[g][i][2] = fmaf(dsk[i], qv.z, dkk[g][i][2]);
          dkk[g][i][3] = fmaf(dsk[i], qv.w, dkk[g][i][3]);
        }
      }
    }
  }
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    const int c0 = (tx + 16 * g) * 4;
    if (c0 >= dk) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + ty * 4 + i;
      if (key >= P.Lk) continue;
      Num<T>::store4(P.dv + kbase + (size_t)key * dk + c0,
                     make_float4(dv[g][i][0], dv[g][i][1], dv[g][i][2], dv[g][i][3]));
      Num<T>::store4(P.dk + kbase + (size_t)key * dk + c0,
                     make_float4(dkk[g][i][0], dkk[g][i][1], dkk[g][i][2], dkk[g][i][3]));
    }
  }
}

// ---- 3. dq = round(ds) k for one query tile, and the group's partial dbias ----
template <typename T, int NG>
__global__ void __launch_bounds__(THREADS, 2) dq_dbias_kernel(BwdParams<T> P) {
  extern __shared__ float4 bwd_smem4[];
  const Smem sm(reinterpret_cast<float*>(bwd_smem4), P.dkw);
  const int q_tiles = (P.Lq + QT - 1) / QT;
  const int q0 = (blockIdx.x % q_tiles) * QT;
  const int hg = blockIdx.x / q_tiles, h = hg % P.H, grp = hg / P.H;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4, dk = P.dkw, ld = sm.ld;
  const int rows_per_group = (P.B + P.groups - 1) / P.groups;
  const int b_lo = grp * rows_per_group, b_hi = min(P.B, b_lo + rows_per_group);
  float* part = P.dbias_part + ((size_t)grp * P.H + h) * P.Lq * P.Lk;

  for (int b = b_lo; b < b_hi; ++b) {
    const size_t bh = (size_t)b * P.H + h;
    const size_t qbase = bh * P.Lq * dk, kbase = bh * P.Lk * dk;
    __syncthreads();  // the batch row before is read out
    stage_rows<T>(sm.Qs, ld, P.q + qbase, q0, P.Lq, dk);
    stage_rows<T>(sm.Os, ld, P.dout + qbase, q0, P.Lq, dk);
    float m[4], l[4], delta[4];
    load_rows<T>(P, b, h, q0, m, l, delta, true);
    float dq[NG][4][4];
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) dq[g][i][c] = 0.f;

    for (int k0 = 0; k0 < P.Lk; k0 += KT) {
      __syncthreads();
      stage_rows<T>(sm.Ks, ld, P.k + kbase, k0, P.Lk, dk);
      stage_rows<T>(sm.Vs, ld, P.v + kbase, k0, P.Lk, dk);
      stage_mask<T>(sm.madd, P, b, k0);
      __syncthreads();
      float p[4][4], dp[4][4];
      tile_p_dp<T>(P, sm, b, h, q0, k0, m, l, p, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = k0 + tx + 16 * j;
          const float ds = p[i][j] * (dp[i][j] - delta[i]);
          sm.Ds[(ty * 4 + i) * LDS + tx + 16 * j] = Num<T>::rnd(ds);
          if (row < P.Lq && key < P.Lk) {
            // this block owns the region and this thread the element: the
            // batch rows of the group are added in order
            float* at = part + (size_t)row * P.Lk + key;
            *at = b == b_lo ? ds : *at + ds;
          }
        }
      }
      __syncthreads();
      for (int j = 0; j < KT; j += 4) {
        float4 dr[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) dr[i] = *reinterpret_cast<const float4*>(sm.Ds + (ty * 4 + i) * LDS + j);
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const int c0 = (tx + 16 * g) * 4;
          if (c0 >= dk) continue;
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const float4 kv = *reinterpret_cast<const float4*>(sm.Ks + (j + t) * ld + c0);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float dt = t == 0 ? dr[i].x : t == 1 ? dr[i].y : t == 2 ? dr[i].z : dr[i].w;
              dq[g][i][0] = fmaf(dt, kv.x, dq[g][i][0]);
              dq[g][i][1] = fmaf(dt, kv.y, dq[g][i][1]);
              dq[g][i][2] = fmaf(dt, kv.z, dq[g][i][2]);
              dq[g][i][3] = fmaf(dt, kv.w, dq[g][i][3]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int c0 = (tx + 16 * g) * 4;
      if (c0 >= dk) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + ty * 4 + i;
        if (row < P.Lq)
          Num<T>::store4(P.dq + qbase + (size_t)row * dk + c0,
                         make_float4(dq[g][i][0], dq[g][i][1], dq[g][i][2], dq[g][i][3]));
      }
    }
  }
}

// ---- 4. dbias = the groups' partials, added in group order ----
__global__ void reduce_groups_kernel(const float* part, float* dbias, size_t n, int groups) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += (size_t)gridDim.x * blockDim.x) {
    float acc = part[i];
    for (int g = 1; g < groups; ++g) acc += part[(size_t)g * n + i];
    dbias[i] = acc;
  }
}

// ---- bf16, dk = 64: the tensor-core routes ----

using bf16 = __nv_bfloat16;
using attn::a_frags_global;
using attn::a_frags_smem;
using attn::add_bias_masks_global;
using attn::add_bias_masks_tile;
using attn::BIAS_LD;
using attn::bn_col;
using attn::bn_row;
using attn::bt_col;
using attn::bt_row;
using attn::cp_async4;
using attn::cp_async_commit;
using attn::cp_async_wait_all;
using attn::cp_async_wait_but_one;
using attn::drop_counter;
using attn::ldsm_x4_t;
using attn::MMA_DK;
using attn::MMA_LD;
using attn::mma_16816;
using attn::pack_bf16;
using attn::qk_product;
using attn::quad_sum;
using attn::stage_bias_async;
using attn::stage_mask_async;
using attn::stage_rows_async;
using attn::store_rows_bf16;
using attn::TILED_SMEM;
using attn::TL_KT;
using attn::TL_WARPS;
using attn::WR_MAX_KEYS;

constexpr int DKV_WARPS = 4;  // tiled route, kernels 2 and 3: 64 rows (keys or queries) per block
// kernel 2: k, v; q, dout x 2 buffers; round(pd), round(ds); a bias tile; m, l, delta; the key mask
constexpr int DKV_SMEM = (2 + 4 + 2) * 64 * MMA_LD * 2 + 64 * BIAS_LD * 4 + 3 * 64 * 4 + 64 * 4;
// kernel 3: k, v x 2 buffers; a bias tile and a partial-dbias tile; the key mask
constexpr int DQ_SMEM = 4 * TL_KT * MMA_LD * 2 + 2 * 64 * BIAS_LD * 4 + TL_KT * 4;

// The backward's route; ops/cuda/attention.py::attention_route mirrors it.
__host__ __device__ inline int backward_route(bool is_bf16, int Lq, int Lk, int dk) {
  if (!is_bf16 || dk != MMA_DK) return attn::ROUTE_CUDA_CORES;
  return Lq <= WR_MAX_KEYS && Lk <= WR_MAX_KEYS ? attn::ROUTE_WHOLE_ROW : attn::ROUTE_TILED;
}

// Shared memory of the whole-row kernel at QP query rows and KP keys (both
// multiples of 16): q, dout, k, v; round(pd), round(ds); the group's partial
// dbias; the key mask.
__host__ __device__ inline int rows_smem_bytes(int QP, int KP) {
  return (2 * QP + 2 * KP) * MMA_LD * 2 + 2 * QP * (KP + 8) * 2 + QP * (KP + 8) * 4 + KP * 4;
}

// The forward's m and l of rows row_lo and row_lo + 8; past Lq, m = +inf and
// l = 1, so that p = 0 there.
__device__ __forceinline__ void load_stats(const BwdParams<bf16>& P, size_t bh, int row_lo, float (&m)[2],
                                           float (&l)[2]) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row_lo + hh * 8;
    m[hh] = row < P.Lq ? __ldg(P.row_max + bh * P.Lq + row) : INFINITY;
    l[hh] = row < P.Lq ? __ldg(P.row_sum + bh * P.Lq + row) : 1.f;
  }
}

// From the scores s (((q.k + bias) + mask) + causal, -inf past Lk) and the
// raw dout.v (dp) of rows row_lo, row_lo + 8 and keys k0 + j*8 + 2t + (e & 1):
// s becomes p = exp(s - m) / l and dp gets the forward's keep bits and scale;
// pd (p with the keep bits and scale) is written rounded to pd_tile [rows,
// ld] at row pd_row0 + g (+ 8), unless pd_tile is null. The keep bits come
// from the forward's words (bits, 64-key tiles; NJ = 8) or, when bits is
// null, from the hash.
template <int NJ>
__device__ __forceinline__ void probs_and_dp(float (&s)[NJ][4], float (&dp)[NJ][4], const BwdParams<bf16>& P, int b,
                                             int h, int row_lo, int k0, const float (&m)[2], const float (&l)[2],
                                             bf16* pd_tile, int ld, int pd_row0, const unsigned* bits) {
  const int t = threadIdx.x & 3, g = (threadIdx.x & 31) >> 2;
  const float inv_l[2] = {1.f / l[0], 1.f / l[1]};
  const unsigned seed_mix = P.dropout && bits == nullptr ? seed_mix_of(P.seed) : 0u;
  uint2 kw[2] = {make_uint2(0u, 0u), make_uint2(0u, 0u)};
  if (NJ == 8 && bits != nullptr && P.dropout) {
    const int nt = (P.Lk + TL_KT - 1) / TL_KT;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row_lo + hh * 8;
      if (row < P.Lq)
        kw[hh] = __ldg(reinterpret_cast<const uint2*>(bits + (((size_t)b * P.H + h) * P.Lq + row) * nt * 2 +
                                                      (k0 / TL_KT) * 2));
    }
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float pd[2];
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int e = 2 * hh + e2;
        const float pv = attn::sm_p(s[j][e], m[hh], inv_l[hh]);
        pd[e2] = pv;
        if (P.dropout) {
          const int bit = (j & 3) * 8 + 2 * t + e2;
          const bool keep =
              NJ == 8 && bits != nullptr
                  ? (((j & 4) ? kw[hh].y : kw[hh].x) >> bit) & 1u
                  : keep_bit(drop_counter(P.b0 + b, h, P.H, P.Lq, P.Lk, row_lo + hh * 8, k0 + j * 8 + 2 * t + e2),
                             seed_mix, P.keep_thresh);
          pd[e2] = (keep ? pv : 0.f) * P.keep_scale;
          dp[j][e] = keep ? dp[j][e] * P.keep_scale : 0.f;
        }
        s[j][e] = pv;
      }
      if (pd_tile != nullptr)
        *reinterpret_cast<unsigned*>(pd_tile + (pd_row0 + g + hh * 8) * ld + j * 8 + 2 * t) = pack_bf16(pd[0], pd[1]);
    }
}

// The softmax VJP's row term sum_k(dp * p) of this thread's two rows, over
// the keys its quad holds.
template <int NJ>
__device__ __forceinline__ void row_term(const float (&p)[NJ][4], const float (&dp)[NJ][4], float (&delta)[2]) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      acc = fmaf(dp[j][2 * hh], p[j][2 * hh], acc);
      acc = fmaf(dp[j][2 * hh + 1], p[j][2 * hh + 1], acc);
    }
    delta[hh] = quad_sum(acc);
  }
}

// ds = p (dp - delta) in place of p; written rounded to ds_tile like pd above
// unless it is null.
template <int NJ>
__device__ __forceinline__ void make_ds(float (&s)[NJ][4], const float (&dp)[NJ][4], const float (&delta)[2],
                                        bf16* ds_tile, int ld, int row0) {
  const int t = threadIdx.x & 3, g = (threadIdx.x & 31) >> 2;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      s[j][2 * hh] = s[j][2 * hh] * (dp[j][2 * hh] - delta[hh]);
      s[j][2 * hh + 1] = s[j][2 * hh + 1] * (dp[j][2 * hh + 1] - delta[hh]);
      if (ds_tile != nullptr)
        *reinterpret_cast<unsigned*>(ds_tile + (row0 + g + hh * 8) * ld + j * 8 + 2 * t) =
            pack_bf16(s[j][2 * hh], s[j][2 * hh + 1]);
    }
}

// acc [16 rows, 64] += round(ds) [16 rows, NJ*8 keys] k for a staged key tile
// Ks [keys, MMA_LD] (k's B fragments by ldmatrix.trans).
template <int NJ>
__device__ __forceinline__ void ds_times_k(float (&acc)[8][4], const float (&ds)[NJ][4], const bf16* Ks) {
  const int lane = threadIdx.x & 31;
  const bf16* kp = Ks + bt_row(lane) * MMA_LD + bt_col(lane);
#pragma unroll
  for (int kk = 0; kk < NJ / 2; ++kk) {
    const unsigned a[4] = {pack_bf16(ds[2 * kk][0], ds[2 * kk][1]), pack_bf16(ds[2 * kk][2], ds[2 * kk][3]),
                           pack_bf16(ds[2 * kk + 1][0], ds[2 * kk + 1][1]),
                           pack_bf16(ds[2 * kk + 1][2], ds[2 * kk + 1][3])};
#pragma unroll
    for (int jn = 0; jn < 4; ++jn) {
      unsigned kb[4];
      ldsm_x4_t(kb, kp + kk * 16 * MMA_LD + jn * 16);
      mma_16816(acc[2 * jn], a, kb[0], kb[1]);
      mma_16816(acc[2 * jn + 1], a, kb[2], kb[3]);
    }
  }
}

// Phase B for the 16 keys key0 .. key0 + 15 of the [n_q, ldp] tiles of
// round(pd) and round(ds) (rows: queries): dv += pd^T dout and dk += ds^T q
// over n_q queries (a multiple of 16) of the staged Os, Qs [n_q, MMA_LD].
__device__ __forceinline__ void dv_dk_products(float (&dv)[8][4], float (&dk)[8][4], const bf16* PDs,
                                               const bf16* DSs, int ldp, int key0, const bf16* Os, const bf16* Qs,
                                               int n_q) {
  const int lane = threadIdx.x & 31;
  const int at = bn_row(lane) * ldp + key0 + bn_col(lane), bt = bt_row(lane) * MMA_LD + bt_col(lane);
  for (int kq = 0; kq < n_q; kq += 16) {
    unsigned a_pd[4], a_ds[4];
    ldsm_x4_t(a_pd, PDs + kq * ldp + at);
    ldsm_x4_t(a_ds, DSs + kq * ldp + at);
#pragma unroll
    for (int jn = 0; jn < 4; ++jn) {
      unsigned bo[4], bq[4];
      ldsm_x4_t(bo, Os + kq * MMA_LD + bt + jn * 16);
      ldsm_x4_t(bq, Qs + kq * MMA_LD + bt + jn * 16);
      mma_16816(dv[2 * jn], a_pd, bo[0], bo[1]);
      mma_16816(dv[2 * jn + 1], a_pd, bo[2], bo[3]);
      mma_16816(dk[2 * jn], a_ds, bq[0], bq[1]);
      mma_16816(dk[2 * jn + 1], a_ds, bq[2], bq[3]);
    }
  }
}

__device__ __forceinline__ void zero8x4(float (&a)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) a[j][0] = a[j][1] = a[j][2] = a[j][3] = 0.f;
}

// ---- whole-row route: one block per (head, batch group) ----
template <int NKS>
__global__ void __launch_bounds__(256) bwd_rows_kernel(BwdParams<bf16> P) {
  constexpr int KP = 16 * NKS, NJ = 2 * NKS, LDP = KP + 8;
  extern __shared__ float4 bwd_smem4[];
  const int Lq = P.Lq, Lk = P.Lk, nqw = (Lq + 15) / 16, QP = 16 * nqw;
  bf16* Qs = reinterpret_cast<bf16*>(bwd_smem4);
  bf16* Os = Qs + QP * MMA_LD;
  bf16* Ks = Os + QP * MMA_LD;
  bf16* Vs = Ks + KP * MMA_LD;
  bf16* PDs = Vs + KP * MMA_LD;
  bf16* DSs = PDs + QP * LDP;
  float* dbs = reinterpret_cast<float*>(DSs + QP * LDP);  // [QP, LDP] the group's partial dbias
  unsigned* mk = reinterpret_cast<unsigned*>(dbs + QP * LDP);
  const int h = blockIdx.x % P.H, grp = blockIdx.x / P.H;
  const int rows_per_group = (P.B + P.groups - 1) / P.groups;
  const int b_lo = grp * rows_per_group, b_hi = min(P.B, b_lo + rows_per_group);
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* bias_h = P.bias + (size_t)h * Lq * Lk;

  auto stage_kv = [&](int b) {
    const size_t kbase = ((size_t)b * P.H + h) * Lk * MMA_DK;
    stage_rows_async(Ks, P.k + kbase, 0, KP, Lk);
    stage_rows_async(Vs, P.v + kbase, 0, KP, Lk);
    stage_mask_async(mk, P.mask + (size_t)b * Lk, 0, KP, Lk);
    cp_async_commit();
  };
  auto stage_qo = [&](int b) {
    const size_t qbase = ((size_t)b * P.H + h) * Lq * MMA_DK;
    stage_rows_async(Qs, P.q + qbase, 0, QP, Lq);
    stage_rows_async(Os, P.dout + qbase, 0, QP, Lq);
    cp_async_commit();
  };
  stage_kv(b_lo);
  stage_qo(b_lo);
  for (int b = b_lo; b < b_hi; ++b) {
    const size_t bh = (size_t)b * P.H + h;
    cp_async_wait_all();
    __syncthreads();  // this row's operands have landed
    if (warp < nqw) {  // phase A: query rows 16 warp .. + 15, whole score rows
      const int row_lo = warp * 16 + g;
      unsigned a[4][4];
      float s[NJ][4], dp[NJ][4], m[2], l[2], delta[2];
      load_stats(P, bh, row_lo, m, l);
      a_frags_smem(a, Qs, warp * 16);
      qk_product<NJ>(s, a, Ks);
      a_frags_smem(a, Os, warp * 16);
      qk_product<NJ>(dp, a, Vs);
      add_bias_masks_global<NJ>(s, bias_h, mk, false, row_lo, 0, Lq, Lk, P.causal);
      probs_and_dp<NJ>(s, dp, P, b, h, row_lo, 0, m, l, PDs, LDP, warp * 16, nullptr);
      row_term<NJ>(s, dp, delta);
      make_ds<NJ>(s, dp, delta, DSs, LDP, warp * 16);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {  // this thread's own elements, in batch order
          float2* at = reinterpret_cast<float2*>(dbs + (row_lo + hh * 8) * LDP + j * 8 + 2 * t);
          float2 acc = make_float2(s[j][2 * hh], s[j][2 * hh + 1]);
          if (b != b_lo) {
            const float2 was = *at;
            acc.x = was.x + acc.x;
            acc.y = was.y + acc.y;
          }
          *at = acc;
        }
      float dq[8][4];
      zero8x4(dq);
      ds_times_k<NJ>(dq, s, Ks);
      store_rows_bf16(P.dq + bh * Lq * MMA_DK, dq, row_lo, Lq);
    }
    __syncthreads();  // round(pd), round(ds) are written; k, v and the mask are read out
    if (b + 1 < b_hi) stage_kv(b + 1);
    if (warp < NKS) {  // phase B: keys 16 warp .. + 15
      float dv[8][4], dk[8][4];
      zero8x4(dv);
      zero8x4(dk);
      dv_dk_products(dv, dk, PDs, DSs, LDP, warp * 16, Os, Qs, QP);
      store_rows_bf16(P.dv + bh * Lk * MMA_DK, dv, warp * 16 + g, Lk);
      store_rows_bf16(P.dk + bh * Lk * MMA_DK, dk, warp * 16 + g, Lk);
    }
    __syncthreads();  // q, dout, round(pd), round(ds) are read out
    if (b + 1 < b_hi) stage_qo(b + 1);
  }
  // the group's partial dbias (dbias itself for one group); the last
  // read-modify-writes are behind the barriers above
  float* part = P.dbias_part + ((size_t)grp * P.H + h) * Lq * Lk;
  for (int i = threadIdx.x; i < Lq * Lk; i += blockDim.x) part[i] = dbs[(i / Lk) * LDP + i % Lk];
}

// ---- tiled route ----

// 1. the row term, one block of 4 warps per (batch row, head, 64 queries):
// key tiles double-buffered, each tile's bias and mask copied during its
// products (the forward's tiled layout of shared memory, then q and dout)
constexpr int DELTA_SMEM = TILED_SMEM + 2 * TL_WARPS * 16 * MMA_LD * 2;
__global__ void __launch_bounds__(TL_WARPS * 32, 3) bwd_delta_tiled_kernel(BwdParams<bf16> P) {
  extern __shared__ float4 bwd_smem4[];
  bf16* Ks = reinterpret_cast<bf16*>(bwd_smem4);  // [2][TL_KT, MMA_LD]
  bf16* Vs = Ks + 2 * TL_KT * MMA_LD;
  float* Bs = reinterpret_cast<float*>(Vs + 2 * TL_KT * MMA_LD);  // [128, BIAS_LD]
  unsigned* mk = reinterpret_cast<unsigned*>(Bs + TL_WARPS * 16 * BIAS_LD);
  bf16* Qs = reinterpret_cast<bf16*>(mk + TL_KT);  // [rows, MMA_LD] q, then dout
  bf16* Os = Qs + TL_WARPS * 16 * MMA_LD;
  const int Lq = P.Lq, Lk = P.Lk, warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  const int q_tiles = (Lq + TL_WARPS * 16 - 1) / (TL_WARPS * 16);
  const int bhi = blockIdx.x / q_tiles, b = bhi / P.H, h = bhi % P.H;
  const size_t bh = bhi;
  const int q0 = (blockIdx.x % q_tiles) * TL_WARPS * 16, row_lo = q0 + warp * 16 + g;
  const bool active = q0 + warp * 16 < Lq;
  const int nt = (Lk + TL_KT - 1) / TL_KT;
  auto prefetch_kv = [&](int tile) {
    const int buf = tile & 1;
    stage_rows_async(Ks + buf * TL_KT * MMA_LD, P.k + bh * Lk * MMA_DK, tile * TL_KT, TL_KT, Lk);
    stage_rows_async(Vs + buf * TL_KT * MMA_LD, P.v + bh * Lk * MMA_DK, tile * TL_KT, TL_KT, Lk);
    cp_async_commit();
  };
  // q and dout rows staged once, their fragments read per tile: registers
  // for the scores instead (no spills at three blocks per SM)
  stage_rows_async(Qs, P.q + bh * Lq * MMA_DK, q0, TL_WARPS * 16, Lq);
  stage_rows_async(Os, P.dout + bh * Lq * MMA_DK, q0, TL_WARPS * 16, Lq);
  prefetch_kv(0);
  float m[2], l[2], acc[2] = {0.f, 0.f};
  load_stats(P, bh, row_lo, m, l);
  for (int tile = 0; tile < nt; ++tile) {
    const int buf = tile & 1, k0 = tile * TL_KT;
    cp_async_wait_all();
    __syncthreads();  // this tile has landed; the other buffers are read out
    stage_bias_async(Bs, P.bias + (size_t)h * Lq * Lk, q0, TL_WARPS * 16, k0, Lq, Lk);
    stage_mask_async(mk, P.mask + (size_t)b * Lk, k0, TL_KT, Lk);
    cp_async_commit();
    if (tile + 1 < nt) {
      prefetch_kv(tile + 1);
      cp_async_wait_but_one();
    } else {
      cp_async_wait_all();
    }
    float s[8][4], dp[8][4], d[2];
    if (active) {
      unsigned a[4][4];
      a_frags_smem(a, Qs, warp * 16);
      qk_product<8>(s, a, Ks + buf * TL_KT * MMA_LD);
      a_frags_smem(a, Os, warp * 16);
      qk_product<8>(dp, a, Vs + buf * TL_KT * MMA_LD);
    }
    __syncthreads();  // this tile's bias and mask have landed
    if (!active) continue;
    add_bias_masks_tile<8>(s, Bs, q0, mk, false, row_lo, k0, Lk, P.causal);
    probs_and_dp<8>(s, dp, P, b, h, row_lo, k0, m, l, nullptr, 0, 0, P.keep_bits);
    row_term<8>(s, dp, d);
    acc[0] += d[0];
    acc[1] += d[1];
  }
  if (!active || (threadIdx.x & 3) != 0) return;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    if (row_lo + hh * 8 < Lq) P.delta[bh * Lq + row_lo + hh * 8] = acc[hh];
}

// 2. dv and dk, one block of 4 warps per (batch row, head, 64 keys): query
// tiles of 64 double-buffered, each tile's bias and row statistics copied
// during its products
__global__ void __launch_bounds__(DKV_WARPS * 32, 3) bwd_dkv_tiled_kernel(BwdParams<bf16> P) {
  extern __shared__ float4 bwd_smem4[];
  bf16* Ks = reinterpret_cast<bf16*>(bwd_smem4);
  bf16* Vs = Ks + 64 * MMA_LD;
  bf16* Qs = Vs + 64 * MMA_LD;  // [2][64, MMA_LD]
  bf16* Os = Qs + 2 * 64 * MMA_LD;
  bf16* PDs = Os + 2 * 64 * MMA_LD;
  bf16* DSs = PDs + 64 * MMA_LD;
  float* Bs = reinterpret_cast<float*>(DSs + 64 * MMA_LD);  // [64, BIAS_LD]
  float* Ms = Bs + 64 * BIAS_LD;                            // m, l, delta [3][64]
  unsigned* mk = reinterpret_cast<unsigned*>(Ms + 3 * 64);
  const int Lq = P.Lq, Lk = P.Lk, warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  const int k_tiles = (Lk + 63) / 64;
  const int bhi = blockIdx.x / k_tiles, b = bhi / P.H, h = bhi % P.H;
  const size_t bh = bhi;
  const int k0 = (blockIdx.x % k_tiles) * 64, nq = (Lq + 63) / 64;
  auto stage_qo = [&](int it) {
    const int buf = it & 1;
    stage_rows_async(Qs + buf * 64 * MMA_LD, P.q + bh * Lq * MMA_DK, it * 64, 64, Lq);
    stage_rows_async(Os + buf * 64 * MMA_LD, P.dout + bh * Lq * MMA_DK, it * 64, 64, Lq);
    cp_async_commit();
  };
  stage_rows_async(Ks, P.k + bh * Lk * MMA_DK, k0, 64, Lk);
  stage_rows_async(Vs, P.v + bh * Lk * MMA_DK, k0, 64, Lk);
  stage_mask_async(mk, P.mask + (size_t)b * Lk, k0, 64, Lk);
  stage_qo(0);
  float dv[8][4], dk[8][4];
  zero8x4(dv);
  zero8x4(dk);
  for (int it = 0; it < nq; ++it) {
    const bf16* Qb = Qs + (it & 1) * 64 * MMA_LD;
    const bf16* Ob = Os + (it & 1) * 64 * MMA_LD;
    const int q0 = it * 64, row_lo = q0 + warp * 16 + g;
    cp_async_wait_all();
    __syncthreads();  // this query tile has landed; the last tile's products are done
    stage_bias_async(Bs, P.bias + (size_t)h * Lq * Lk, q0, 64, k0, Lq, Lk);
    for (int i = threadIdx.x; i < 3 * 64; i += blockDim.x) {
      const float* src = i < 64 ? P.row_max : i < 128 ? P.row_sum : P.delta;
      const int row = q0 + (i & 63);
      cp_async4(Ms + i, src + (row < Lq ? bh * Lq + row : 0), row < Lq);
    }
    cp_async_commit();
    if (it + 1 < nq) {
      stage_qo(it + 1);
      cp_async_wait_but_one();
    } else {
      cp_async_wait_all();
    }
    // phase A: query rows q0 + 16 warp .. + 15 (p = 0 past Lq)
    unsigned a[4][4];
    float s[8][4], dp[8][4], m[2], l[2], delta[2];
    a_frags_smem(a, Qb, warp * 16);
    qk_product<8>(s, a, Ks);
    a_frags_smem(a, Ob, warp * 16);
    qk_product<8>(dp, a, Vs);
    __syncthreads();  // this tile's bias and statistics have landed
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = warp * 16 + g + hh * 8;
      const bool in = q0 + r < Lq;
      m[hh] = in ? Ms[r] : INFINITY;
      l[hh] = in ? Ms[64 + r] : 1.f;
      delta[hh] = in ? Ms[128 + r] : 0.f;
    }
    add_bias_masks_tile<8>(s, Bs, q0, mk, false, row_lo, k0, Lk, P.causal);
    probs_and_dp<8>(s, dp, P, b, h, row_lo, k0, m, l, PDs, MMA_LD, warp * 16, P.keep_bits);
    make_ds<8>(s, dp, delta, DSs, MMA_LD, warp * 16);
    __syncthreads();  // round(pd), round(ds) of the tile are written
    dv_dk_products(dv, dk, PDs, DSs, MMA_LD, warp * 16, Ob, Qb, 64);  // phase B: keys k0 + 16 warp ..
  }
  store_rows_bf16(P.dv + bh * Lk * MMA_DK, dv, k0 + warp * 16 + g, Lk);
  store_rows_bf16(P.dk + bh * Lk * MMA_DK, dk, k0 + warp * 16 + g, Lk);
}

// 3. dq and the group's partial dbias, one block of 4 warps per (64 queries,
// head, batch group): (batch row, key tile) steps, keys and values
// double-buffered; each step's bias, mask and partial-dbias tiles copied
// during its products
__global__ void __launch_bounds__(DKV_WARPS * 32, 2) bwd_dq_tiled_kernel(BwdParams<bf16> P) {
  extern __shared__ float4 bwd_smem4[];
  bf16* Ks = reinterpret_cast<bf16*>(bwd_smem4);  // [2][TL_KT, MMA_LD]
  bf16* Vs = Ks + 2 * TL_KT * MMA_LD;
  float* Bs = reinterpret_cast<float*>(Vs + 2 * TL_KT * MMA_LD);  // [64, BIAS_LD] bias
  float* Ps = Bs + 64 * BIAS_LD;                                  // [64, BIAS_LD] partial dbias so far
  unsigned* mk = reinterpret_cast<unsigned*>(Ps + 64 * BIAS_LD);
  const int Lq = P.Lq, Lk = P.Lk, warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int q_tiles = (Lq + 63) / 64;
  const int q0 = (blockIdx.x % q_tiles) * 64, hg = blockIdx.x / q_tiles, h = hg % P.H, grp = hg / P.H;
  const int rows_per_group = (P.B + P.groups - 1) / P.groups;
  const int b_lo = grp * rows_per_group, b_hi = min(P.B, b_lo + rows_per_group);
  const int nt = (Lk + TL_KT - 1) / TL_KT, steps = (b_hi - b_lo) * nt;
  const int row_lo = q0 + warp * 16 + g;
  const bool active = q0 + warp * 16 < Lq;
  float* part = P.dbias_part + ((size_t)grp * P.H + h) * Lq * Lk;
  auto prefetch_kv = [&](int step) {
    const int buf = step & 1, b = b_lo + step / nt, k0 = (step % nt) * TL_KT;
    const size_t kbase = ((size_t)b * P.H + h) * Lk * MMA_DK;
    stage_rows_async(Ks + buf * TL_KT * MMA_LD, P.k + kbase, k0, TL_KT, Lk);
    stage_rows_async(Vs + buf * TL_KT * MMA_LD, P.v + kbase, k0, TL_KT, Lk);
    cp_async_commit();
  };
  prefetch_kv(0);
  unsigned qa[4][4], da[4][4];
  float m[2], l[2], delta[2], dq[8][4];
  for (int step = 0; step < steps; ++step) {
    const int buf = step & 1, b = b_lo + step / nt, tile = step % nt, k0 = tile * TL_KT;
    const size_t bh = (size_t)b * P.H + h;
    cp_async_wait_all();
    __syncthreads();  // this step's keys have landed; the other buffers are read out
    stage_bias_async(Bs, P.bias + (size_t)h * Lq * Lk, q0, 64, k0, Lq, Lk);
    if (b != b_lo) stage_bias_async(Ps, part, q0, 64, k0, Lq, Lk);  // same [Lq, Lk] layout
    stage_mask_async(mk, P.mask + (size_t)b * Lk, k0, TL_KT, Lk);
    cp_async_commit();
    if (step + 1 < steps) {
      prefetch_kv(step + 1);
      cp_async_wait_but_one();
    } else {
      cp_async_wait_all();
    }
    float s[8][4], dp[8][4];
    if (active) {
      if (tile == 0) {
        a_frags_global(qa, P.q + bh * Lq * MMA_DK, row_lo, Lq);
        a_frags_global(da, P.dout + bh * Lq * MMA_DK, row_lo, Lq);
        load_stats(P, bh, row_lo, m, l);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          delta[hh] = row_lo + hh * 8 < Lq ? P.delta[bh * Lq + row_lo + hh * 8] : 0.f;
        zero8x4(dq);
      }
      qk_product<8>(s, qa, Ks + buf * TL_KT * MMA_LD);
      qk_product<8>(dp, da, Vs + buf * TL_KT * MMA_LD);
    }
    __syncthreads();  // this step's bias, mask and partial have landed
    if (!active) continue;
    add_bias_masks_tile<8>(s, Bs, q0, mk, false, row_lo, k0, Lk, P.causal);
    probs_and_dp<8>(s, dp, P, b, h, row_lo, k0, m, l, nullptr, 0, 0, P.keep_bits);
    make_ds<8>(s, dp, delta, nullptr, 0, 0);
    // the unrounded ds into this block's region of the group's partial: this
    // thread owns its elements, and the group's batch rows come in order
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row_lo + hh * 8;
      if (row >= Lq) continue;
      float* prow = part + (size_t)row * Lk;
      const float* was = Ps + (row - q0) * BIAS_LD;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kl = j * 8 + 2 * t, key = k0 + kl;
        float2 acc = make_float2(s[j][2 * hh], s[j][2 * hh + 1]);
        if (b != b_lo) {
          acc.x = was[kl] + acc.x;
          acc.y = was[kl + 1] + acc.y;
        }
        if ((Lk & 1) == 0 && key < Lk) {
          *reinterpret_cast<float2*>(prow + key) = acc;
        } else {
          if (key < Lk) prow[key] = acc.x;
          if (key + 1 < Lk) prow[key + 1] = acc.y;
        }
      }
    }
    ds_times_k<8>(dq, s, Ks + buf * TL_KT * MMA_LD);
    if (tile == nt - 1) store_rows_bf16(P.dq + bh * Lq * MMA_DK, dq, row_lo, Lq);
  }
}

template <int NKS> cudaError_t launch_bwd_rows(const BwdParams<bf16>& P, cudaStream_t stream) {
  const int nqw = (P.Lq + 15) / 16;
  const int smem = rows_smem_bytes(16 * nqw, 16 * NKS);
  cudaError_t err =
      cudaFuncSetAttribute(bwd_rows_kernel<NKS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int threads = 32 * (nqw > NKS ? nqw : NKS);
  bwd_rows_kernel<NKS><<<(unsigned)(P.H * P.groups), threads, smem, stream>>>(P);
  return cudaGetLastError();
}

inline cudaError_t launch_mma(const BwdParams<float>&, cudaStream_t) { return cudaErrorInvalidValue; }
inline cudaError_t launch_mma(const BwdParams<bf16>& P, cudaStream_t stream) {
  if (backward_route(true, P.Lq, P.Lk, P.dkw) == attn::ROUTE_WHOLE_ROW) {
    switch ((P.Lk + 15) / 16) {
      case 1: return launch_bwd_rows<1>(P, stream);
      case 2: return launch_bwd_rows<2>(P, stream);
      case 3: return launch_bwd_rows<3>(P, stream);
      case 4: return launch_bwd_rows<4>(P, stream);
      case 5: return launch_bwd_rows<5>(P, stream);
      case 6: return launch_bwd_rows<6>(P, stream);
      case 7: return launch_bwd_rows<7>(P, stream);
      default: return launch_bwd_rows<8>(P, stream);
    }
  }
  const long long bh = (long long)P.B * P.H;
  const long long d_blocks = bh * ((P.Lq + TL_WARPS * 16 - 1) / (TL_WARPS * 16));
  const long long kv_blocks = bh * ((P.Lk + 63) / 64);
  const long long q_blocks = (long long)((P.Lq + 63) / 64) * P.H * P.groups;
  if (d_blocks > 2147483647LL || kv_blocks > 2147483647LL || q_blocks > 2147483647LL) return cudaErrorInvalidValue;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(bwd_delta_tiled_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DELTA_SMEM)) ||
      (err = cudaFuncSetAttribute(bwd_dkv_tiled_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DKV_SMEM)) ||
      (err = cudaFuncSetAttribute(bwd_dq_tiled_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DQ_SMEM)))
    return err;
  bwd_delta_tiled_kernel<<<(unsigned)d_blocks, TL_WARPS * 32, DELTA_SMEM, stream>>>(P);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_dkv_tiled_kernel<<<(unsigned)kv_blocks, DKV_WARPS * 32, DKV_SMEM, stream>>>(P);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_dq_tiled_kernel<<<(unsigned)q_blocks, DKV_WARPS * 32, DQ_SMEM, stream>>>(P);
  return cudaGetLastError();
}

template <typename T, int NG>
cudaError_t launch_ng(const BwdParams<T>& P, cudaStream_t stream) {
  const int smem = (int)(smem_floats(P.dkw) * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(delta_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dkv_kernel<T, NG>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dq_dbias_kernel<T, NG>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long q_tiles = (P.Lq + QT - 1) / QT, k_tiles = (P.Lk + KT - 1) / KT;
  const long long bh = (long long)P.B * P.H;
  if (q_tiles * bh > 2147483647LL || k_tiles * bh > 2147483647LL) return cudaErrorInvalidValue;

  delta_kernel<T><<<(unsigned)(q_tiles * bh), THREADS, smem, stream>>>(P);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dkv_kernel<T, NG><<<(unsigned)(k_tiles * bh), THREADS, smem, stream>>>(P);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dq_dbias_kernel<T, NG><<<(unsigned)(q_tiles * P.H * P.groups), THREADS, smem, stream>>>(P);
  return cudaGetLastError();
}

template <typename T>
int launch(void* const* ptrs, const int* dims, const int* seed, unsigned keep_thresh, float keep_scale, int dropout,
           int b0, void* stream) {
  BwdParams<T> P;
  P.q = static_cast<const T*>(ptrs[0]);
  P.k = static_cast<const T*>(ptrs[1]);
  P.v = static_cast<const T*>(ptrs[2]);
  P.bias = static_cast<const float*>(ptrs[3]);
  P.mask = static_cast<const int*>(ptrs[4]);
  P.dout = static_cast<const T*>(ptrs[5]);
  P.row_max = static_cast<const float*>(ptrs[6]);
  P.row_sum = static_cast<const float*>(ptrs[7]);
  P.delta = static_cast<float*>(ptrs[8]);
  P.dq = static_cast<T*>(ptrs[9]);
  P.dk = static_cast<T*>(ptrs[10]);
  P.dv = static_cast<T*>(ptrs[11]);
  P.dbias = static_cast<float*>(ptrs[12]);
  P.dbias_part = static_cast<float*>(ptrs[13]);
  P.keep_bits = static_cast<const unsigned*>(ptrs[14]);
  P.B = dims[0]; P.H = dims[1]; P.Lq = dims[2]; P.Lk = dims[3]; P.dkw = dims[4];
  P.causal = dims[5];
  P.groups = dims[6];
  P.dropout = dropout;
  P.seed = seed;
  P.b0 = b0;
  P.keep_thresh = keep_thresh;
  P.keep_scale = keep_scale;
  if (P.dkw % 4 || P.dkw < 4 || P.dkw > MAX_DK || P.B < 1 || P.H < 1 || P.Lq < 1 || P.Lk < 1 || P.groups < 1 ||
      P.groups > P.B)
    return (int)cudaErrorInvalidValue;
  if (P.groups == 1) P.dbias_part = P.dbias;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = backward_route(std::is_same<T, bf16>::value, P.Lq, P.Lk, P.dkw) != attn::ROUTE_CUDA_CORES
                        ? launch_mma(P, s)
                    : P.dkw <= 64 ? launch_ng<T, 1>(P, s)
                                  : launch_ng<T, 2>(P, s);
  if (err != cudaSuccess || P.groups == 1) return (int)err;
  const size_t n = (size_t)P.H * P.Lq * P.Lk;
  const unsigned blocks = (unsigned)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  reduce_groups_kernel<<<blocks, 256, 0, s>>>(P.dbias_part, P.dbias, n, P.groups);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// ptrs: q, k, v, bias [H, Lq, Lk] f32, mask [B, Lk] int32 (1 = attend), dout,
// row_max and row_sum [B, H, Lq] f32 (the forward's), delta [B, H, Lq] f32
// (scratch), dq, dk, dv (q's dtype), dbias [H, Lq, Lk] f32, and the partial
// dbias [groups, H, Lq, Lk] f32 (unused when groups == 1), and the tiled
// forward's keep bits (attention_forward's keep_bits; null: hashed anew).
// dims: B, H, Lq, Lk, dk, causal, groups. Dropout as in attention_forward
// (seed: the device address of the int32 seed; b0: the global batch index of
// batch row 0 in the dropout counter).
// Launches on `stream` the route's kernels (1 on the whole-row route, 3 on the
// others), and one more when groups > 1.
int attention_backward(int is_bf16, void* const* ptrs, const int* dims, const int* seed, unsigned keep_thresh,
                       float keep_scale, int dropout, int b0, void* stream) {
  return is_bf16 ? launch<__nv_bfloat16>(ptrs, dims, seed, keep_thresh, keep_scale, dropout, b0, stream)
                 : launch<float>(ptrs, dims, seed, keep_thresh, keep_scale, dropout, b0, stream);
}

// The route attention_backward takes (0: CUDA cores, 1: whole rows, 2: tiled).
int attention_backward_route(int is_bf16, int Lq, int Lk, int dk) { return backward_route(is_bf16 != 0, Lq, Lk, dk); }

}  // extern "C"
