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
// block has 227 KB and the blocks run in no order, so the work is tiled 64
// queries x 64 keys, score tiles are recomputed where they are needed, and
// every sum is taken in a fixed order (no float atomics: two launches on the
// same inputs give the same bits). One routine serves short rows (80 keys, two
// tiles) and long rows (800 keys, thirteen tiles). Four kernels, one stream:
//
//   1. delta_kernel, one block per (batch row, head, query tile): walks the key
//      tiles and writes the softmax VJP's row term sum_k(dp * p) [B, H, Lq].
//   2. dkv_kernel, one block per (batch row, head, key tile): walks the query
//      tiles, rebuilds p, dp and ds, and sums dv and dk in registers.
//   3. dq_dbias_kernel, one block per (query tile, head, batch group): walks
//      its group's batch rows in order and, inside, the key tiles; sums dq in
//      registers and adds the unrounded ds into its own [Lq tile, Lk] region of
//      the group's partial dbias (a plain read-modify-write: no other block
//      touches the region, and the batch order is fixed).
//   4. reduce_groups_kernel: dbias = the groups' partials added in group order.
//
// What the TPU kernel keeps out of device memory stays out: scores, p, dp and
// ds live in registers and shared memory only. Device memory holds the row
// term and the [groups, H, Lq, Lk] partial dbias, with a few batch groups
// (the wrapper picks about 4 blocks per SM, at most B / 4 groups).
//
// The tiled design computes 9 products where the reference computes 5 (kernel
// 1: q k^T and dout v^T; kernel 2: those and the two that give dv and dk;
// kernel 3: those and the one that gives dq). Operands are staged in shared
// memory as float32 (bf16 values are exact there, and every rounding point
// above is applied explicitly). The products that give dv, dk and dq run on the
// CUDA cores in both dtypes, each thread owning a 4 x 4 piece fed by float4
// reads from shared memory, as the float32 forward does. q k^T and dout v^T:
//   - float32, and bf16 at other head widths than 64: on the CUDA cores, one
//     fused multiply-add per element of dk in ascending order, the float32
//     forward's order, so p has the forward's bits;
//   - bf16 at dk = 64, where the forward runs on the tensor cores: the same
//     mma.sync m16n8k16 sequence as the forward (four k-steps in order,
//     float32 sums), so again p has the forward's bits. A warp owns 16 query
//     rows x 32 keys; its sums pass through the two score-shaped tiles of
//     shared memory to the threads' 4 x 4 pieces.
// The kernels keep to 128 registers a thread so that two blocks (105 KB of
// shared memory each at dk = 64) share an SM.
//
// Bound on the H100 (5 products, q, k, v, dout in, dq, dk, dv, dbias out): at
// the Amazon training shape [640, 6, 80, 64] 15.7 GFLOP and about 275 MB in
// bf16, bound by bytes; at the long-row shape [64, 6, 800, 64] 157 GFLOP,
// bound by operations. Computing 9 products, 3 to 5 of them on the CUDA cores
// in bf16 too, puts this kernel far above either bound; tensor cores for the
// remaining products, wgmma and TMA are later work.

#include "attention_core.cuh"

namespace {

using attn::keep_bit;
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
  int B, H, Lq, Lk, dkw;      // dkw: head width
  int causal, dropout, groups;
  unsigned seed_mix, keep_thresh;
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

template <typename T> struct OnTensorCores { static constexpr bool value = false; };
template <> struct OnTensorCores<__nv_bfloat16> { static constexpr bool value = true; };

// C [64, LDS] = A [64, ld] (rows: queries) x Bm [64, ld]^T (rows: keys) at
// dk = 64 on the tensor cores, the forward's instruction sequence
// (attn::attention_tile_mma): operands packed to bf16 from their float32
// copies (exact), four k-steps of 16 in order, float32 sums. Warp w owns rows
// (w & 3) * 16 .. + 15 and keys (w >> 2) * 32 .. + 31.
__device__ __forceinline__ void mma_product(const float* A, const float* Bm, float* C, int ld) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (warp & 3) * 16, n0 = (warp >> 2) * 32;
  float c[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const float* ap = A + (r0 + g) * ld + kk * 16 + 2 * t;
    const unsigned a[4] = {attn::pack_bf16(ap[0], ap[1]), attn::pack_bf16(ap[8 * ld], ap[8 * ld + 1]),
                           attn::pack_bf16(ap[8], ap[9]), attn::pack_bf16(ap[8 * ld + 8], ap[8 * ld + 9])};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float* bp = Bm + (n0 + j * 8 + g) * ld + kk * 16 + 2 * t;
      attn::mma_16816(c[j], a, attn::pack_bf16(bp[0], bp[1]), attn::pack_bf16(bp[8], bp[9]));
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float* cp = C + (r0 + g) * LDS + n0 + j * 8 + 2 * t;
    cp[0] = c[j][0];
    cp[1] = c[j][1];
    cp[8 * LDS] = c[j][2];
    cp[8 * LDS + 1] = c[j][3];
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
// keep bits (bit i*4 + j). The scores are built as the forward builds them:
// q.k by the forward's own sequence (see the head of this file), then
// ((q.k + bias) + mask) + causal. Uses Ss and Ds as scratch on the
// tensor-core route: the caller's earlier reads of them are behind a
// __syncthreads(), and this routine ends with one before they are rewritten.
template <typename T>
__device__ __forceinline__ unsigned tile_p_dp(const BwdParams<T>& P, const Smem& sm, int b, int h, int q0, int k0,
                                              const float (&m)[4], const float (&l)[4], float (&p)[4][4],
                                              float (&dp)[4][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  if (OnTensorCores<T>::value && P.dkw == attn::MMA_DK) {
    mma_product(sm.Qs, sm.Ks, sm.Ss, sm.ld);
    mma_product(sm.Os, sm.Vs, sm.Ds, sm.ld);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = sm.Ss[(ty * 4 + i) * LDS + tx + 16 * j];
        dp[i][j] = sm.Ds[(ty * 4 + i) * LDS + tx + 16 * j];
      }
    __syncthreads();
  } else {
    cuda_core_products(sm, P.dkw, p, dp);
  }
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
            (((unsigned)b * (unsigned)P.H + (unsigned)h) * (unsigned)P.Lq + (unsigned)row) * (unsigned)P.Lk +
            (unsigned)key;
        if (keep_bit(counter, P.seed_mix, P.keep_thresh)) {
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
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (P.groups > 1) {
    const size_t n = (size_t)P.H * P.Lq * P.Lk;
    const unsigned blocks = (unsigned)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
    reduce_groups_kernel<<<blocks, 256, 0, stream>>>(P.dbias_part, P.dbias, n, P.groups);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T>
int launch(void* const* ptrs, const int* dims, int seed, unsigned keep_thresh, float keep_scale, int dropout,
           void* stream) {
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
  P.B = dims[0]; P.H = dims[1]; P.Lq = dims[2]; P.Lk = dims[3]; P.dkw = dims[4];
  P.causal = dims[5];
  P.groups = dims[6];
  P.dropout = dropout;
  P.seed_mix = (unsigned)seed * 0x9E3779B9u;
  P.keep_thresh = keep_thresh;
  P.keep_scale = keep_scale;
  if (P.dkw % 4 || P.dkw < 4 || P.dkw > MAX_DK || P.B < 1 || P.H < 1 || P.Lq < 1 || P.Lk < 1 || P.groups < 1 ||
      P.groups > P.B)
    return (int)cudaErrorInvalidValue;
  if (P.groups == 1) P.dbias_part = P.dbias;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(P.dkw <= 64 ? launch_ng<T, 1>(P, s) : launch_ng<T, 2>(P, s));
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// ptrs: q, k, v, bias [H, Lq, Lk] f32, mask [B, Lk] int32 (1 = attend), dout,
// row_max and row_sum [B, H, Lq] f32 (the forward's), delta [B, H, Lq] f32
// (scratch), dq, dk, dv (q's dtype), dbias [H, Lq, Lk] f32, and the partial
// dbias [groups, H, Lq, Lk] f32 (unused when groups == 1).
// dims: B, H, Lq, Lk, dk, causal, groups. Dropout as in attention_forward.
// Launches 3 kernels (4 when groups > 1) on `stream`.
int attention_backward(int is_bf16, void* const* ptrs, const int* dims, int seed, unsigned keep_thresh,
                       float keep_scale, int dropout, void* stream) {
  return is_bf16 ? launch<__nv_bfloat16>(ptrs, dims, seed, keep_thresh, keep_scale, dropout, stream)
                 : launch<float>(ptrs, dims, seed, keep_thresh, keep_scale, dropout, stream);
}

}  // extern "C"
