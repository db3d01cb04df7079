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
// 31.5 MB), so with tensor cores the bound is compute (~27 us). What holds
// the kernel back is the weights' stream instead: every batch row's blocks
// read all 13.4 MB of them from L2 through a chain of small dependent
// products, and an SM draws weight tiles far below the L2's rate
// (rows_core.cuh), so the time follows the bytes a block streams, almost
// the same at kT = 1 as at kT = 30.
//
// Design: one launch per decode level, as the reference's one dispatch per
// level; each batch row's residual stream x [kT, d] stays in shared memory
// through all layers. Two routes (decoder_stack_route):
//
//   - bf16 at dk = 64, kT <= 32, Le <= 128, d and H*dk multiples of 128 up
//     to 384 and dff a multiple of 128 (the published configurations, d =
//     384): decoder_stack_tc_kernel, a cluster of two blocks per batch row
//     (128 blocks at B = 64). Rows pad to 32 (zeros, never stored). Every
//     weight product is one rows_core.cuh::mma_pass on mma.sync over all
//     heads at once (q, k, v: [32, d] @ [d, H*dk] each; the out-projections
//     one [32, H*dk] @ [H*dk, d], so the sum over heads is one float32 sum,
//     rounded once; the FFN's sum over dff chunks stays in registers), the
//     products of a launch one stream of weight K-tiles copied by cp.async.
//     Each block of the pair computes half the columns of every product and
//     the attention of half the heads, so it streams half the weights, and
//     writes what both need (x, the heads' outputs, the FFN hidden) into
//     both blocks' shared memory before a cluster barrier; 185.5 KB of
//     shared memory a block. Attention runs on mma.sync too, one warp per
//     (head, 16 query rows): the whole score row in registers (Le <= 128),
//     the f32 softmax (expf, one reciprocal of the row sum), p rounded into
//     the A fragments of p @ v; self-attention reads k and v from shared
//     memory, cross-attention its K fragments straight from the cache and
//     the values of its heads staged in shared memory. 8 warps a block.
//   - float32 (which must not drop to TF32), and bf16 at other widths (the
//     synthetic configuration's d = 64 among them): the CUDA-core kernel decoder_stack_kernel<T>: 512 threads, weights as
//     4-wide loads into RB x 4 register tiles, K split across threads when
//     the tiles alone would leave most of the block idle (the few-row early
//     levels), per-head attention on float32 rows.
//
// Every value is held as float32; in bf16 mode it is rounded to bf16 exactly
// where the reference rounds: q/k/v, p and the head output after f32
// accumulation, the RMSNorm output before and after its scale, the
// per-sub-layer projection sum once, and the residual stream after every add.

#include <type_traits>

#include "rows_core.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int RB = 4;      // rows per thread in the register tile
constexpr int FCHUNK = 256;  // FFN hidden columns per chunk
constexpr int MAX_SMEM_FLOATS = 232448 / 4;  // the 227 KB a Hopper block may opt in to

using attn::Num;
using attn::warp_max;
using attn::warp_sum;

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
    rows::rmsnorm_f32<T>(x, p.ln_s + l * d, xn, kT, d, p.eps, false);
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
    rows::rmsnorm_f32<T>(x, p.ln_c + l * d, xn, kT, d, p.eps, false);
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
    rows::rmsnorm_f32<T>(x, p.ln_f + l * d, xn, kT, d, p.eps, false);
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
  rows::rmsnorm_f32<T>(x, p.ln_final, p.out + (size_t)b * kT * d, kT, d, p.eps, true);
}

// ---- bf16 on the tensor cores ----

using bf16 = __nv_bfloat16;

constexpr int TC_MT = 32;       // rows per block: kT padded; one m16 tile per warp
constexpr int TC_FC = 256;      // FFN hidden columns per chunk
constexpr int TC_DK = 64;       // head width of the tensor-core attention
constexpr int TC_MAX_LE = 128;  // cross-attention keys a warp's score row holds
constexpr int KV_LD = 72;       // bf16 per staged value row: 144 B, conflict-free ldmatrix

// The kernel's route; ops/cuda/decoder_stack.py::decoder_stack_route mirrors
// it. bf16 at dk = 64, kT <= 32, Le <= 128, d and H*dk multiples of 128 up to
// MAX_BN (one output pass), dff a multiple of 128: every product halves into
// whole 64-column blocks, one for each block of the pair. The shared memory
// of every shape it takes fits a block (tc_layout: at most 189,952 bytes).
__host__ __device__ inline bool tensor_core_route(bool is_bf16, int kT, int d, int dk, int inner, int dff, int Le) {
  return is_bf16 && dk == TC_DK && kT >= 1 && kT <= TC_MT && Le >= 1 && Le <= TC_MAX_LE && d >= 128 &&
         d % 128 == 0 && d <= rows::MAX_BN && inner >= 128 && inner % 128 == 0 && inner <= rows::MAX_BN &&
         dff >= 128 && dff % 128 == 0;
}

// Pipeline depth and staged weight row stride: the widest product a block
// computes is MAX_BN / 2 columns.
constexpr int TC_STAGES = 4, TC_LDW = rows::MAX_BN / 2 + 8, TC_NT = 6;

// bf16 offsets of the tensor-core kernel's shared regions. Each block keeps
// q, k and v of its own heads only (H / 2), and the heads' outputs of all of
// them (oh, which the blocks exchange); the values of its heads for
// cross-attention (vall) overlay ka, va and the weight tiles, idle then. The
// FFN hidden chunks alternate between oh and hid2 (a block may still read
// one chunk while its partner writes the next).
struct TcLayout {
  int ldx, ldq, ldo;  // row strides: [., d], [., H*dk / 2], the heads' output / FFN hidden
  int x, xn, qa, oh, hid2, ka, va, w, vall;
  int le_pad, total;
};

__host__ __device__ inline TcLayout tc_layout(int d, int inner, int H, int Le) {
  TcLayout S;
  S.ldx = rows::row_ld(d);
  S.ldq = rows::row_ld(inner / 2);
  S.ldo = rows::row_ld(inner > TC_FC ? inner : TC_FC);
  S.x = 0;
  S.xn = S.x + TC_MT * S.ldx;
  S.qa = S.xn + TC_MT * S.ldx;
  S.oh = S.qa + TC_MT * S.ldq;
  S.hid2 = S.oh + TC_MT * S.ldo;
  S.ka = S.hid2 + TC_MT * S.ldo;
  S.va = S.ka + TC_MT * S.ldq;
  S.w = S.va + TC_MT * S.ldq;
  S.vall = S.ka;
  S.le_pad = (Le + 15) / 16 * 16;
  const int w_end = S.w + TC_STAGES * rows::BK * TC_LDW, v_end = S.vall + H / 2 * S.le_pad * KV_LD;
  S.total = w_end > v_end ? w_end : v_end;
  return S;
}

// Stores of rows that both blocks of the pair hold (x, oh, hid): into this
// block's shared memory and the partner's (delta: the partner's
// shared::cluster address of a byte minus this block's).
__device__ __forceinline__ void store_both(bf16* p, float v0, float v1, unsigned delta) {
  const unsigned v = attn::pack_bf16(v0, v1);
  *reinterpret_cast<unsigned*>(p) = v;
  attn::st_cluster_u32(attn::smem_addr(p) + delta, v);
}
// x = rnd(x + rnd(v)) for a pair of the residual stream, in both blocks
__device__ __forceinline__ void residual_both(bf16* x, float v0, float v1, unsigned delta) {
  const float2 o = rows::load_pair(x);
  store_both(x, o.x + Num<bf16>::rnd(v0), o.y + Num<bf16>::rnd(v1), delta);
}

// One warp: rows r0 .. r0 + 15 of one head,
//   oh = rnd(rnd(softmax(q k^T + add(row, key))) @ v)
// over NKS * 16 key slots, of which keys < lk exist (the rest score -inf).
// q: the head's bf16 rows (row stride ldq); kfrag(jp, kk, b) gives the B
// fragments of keys jp*16 .. jp*16 + 15 for k-step kk (16 of the 64 dims);
// v: the head's [NKS * 16, 64] bf16 values (row stride ldv), finite past lk;
// out(row, col, v0, v1) stores two adjacent output columns of the head.
// Scores, softmax and p @ v stay in registers; the softmax is float32:
// expf, then one correctly rounded reciprocal of the row sum per row.
template <int NKS, typename KFrag, typename Add, typename Out>
__device__ __forceinline__ void attend16(const bf16* q, int ldq, const KFrag& kfrag, int lk, const Add& add,
                                         const bf16* v, int ldv, const Out& out, int r0) {
  using namespace attn;
  constexpr int NJ = 2 * NKS;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  unsigned qa[4][4];
  const bf16* qp = q + (r0 + a_row(lane)) * ldq + a_col(lane);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) ldsm_x4(qa[kk], qp + kk * 16);
  float s[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int jp = 0; jp < NKS; ++jp) {
      unsigned b[4];
      kfrag(jp, kk, b);
      mma_16816(s[2 * jp], qa[kk], b[0], b[1]);
      mma_16816(s[2 * jp + 1], qa[kk], b[2], b[3]);
    }
  float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = j * 8 + 2 * t + (e & 1);
      s[j][e] = key < lk ? s[j][e] + add(r0 + g + (e >> 1) * 8, key) : -INFINITY;
      m[e >> 1] = fmaxf(m[e >> 1], s[j][e]);
    }
  m[0] = quad_max(m[0]);
  m[1] = quad_max(m[1]);
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = expf(s[j][e] - m[e >> 1]);
      l[e >> 1] += s[j][e];
    }
  const float inv_l[2] = {1.f / quad_sum(l[0]), 1.f / quad_sum(l[1])};
  float o[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  const bf16* vp = v + bt_row(lane) * ldv + bt_col(lane);
#pragma unroll
  for (int kk = 0; kk < NKS; ++kk) {
    // p = rnd(e * (1 / l)): the A fragment of keys kk*16 .. kk*16 + 15
    const unsigned pa[4] = {pack_bf16(s[2 * kk][0] * inv_l[0], s[2 * kk][1] * inv_l[0]),
                            pack_bf16(s[2 * kk][2] * inv_l[1], s[2 * kk][3] * inv_l[1]),
                            pack_bf16(s[2 * kk + 1][0] * inv_l[0], s[2 * kk + 1][1] * inv_l[0]),
                            pack_bf16(s[2 * kk + 1][2] * inv_l[1], s[2 * kk + 1][3] * inv_l[1])};
#pragma unroll
    for (int jn = 0; jn < 4; ++jn) {
      unsigned vb[4];
      ldsm_x4_t(vb, vp + kk * 16 * ldv + jn * 16);
      mma_16816(o[2 * jn], pa, vb[0], vb[1]);
      mma_16816(o[2 * jn + 1], pa, vb[2], vb[3]);
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    out(r0 + g, j * 8 + 2 * t, o[j][0], o[j][1]);
    out(r0 + g + 8, j * 8 + 2 * t, o[j][2], o[j][3]);
  }
}

// Self-attention of the block's head hl (global head h), rows r0 ..: keys
// and values are the block's own rows (ka, va), the bias bias_fold[h];
// padded query rows get no bias.
template <int NKS, typename Out>
__device__ void self_attend(const Params<bf16>& p, const TcLayout& S, const bf16* qa, const bf16* ka, const bf16* va,
                            int hl, int h, int r0, const Out& out) {
  const int lane = threadIdx.x & 31, kT = p.kT;
  const bf16* kp = ka + attn::bn_row(lane) * S.ldq + hl * TC_DK + attn::bn_col(lane);
  const float* bias_h = p.bias + (size_t)h * kT * kT;
  attend16<NKS>(
      qa + hl * TC_DK, S.ldq, [&](int jp, int kk, unsigned (&b)[4]) { attn::ldsm_x4(b, kp + jp * 16 * S.ldq + kk * 16); },
      kT, [&](int row, int key) { return row < kT ? __ldg(bias_h + row * kT + key) : 0.f; }, va + hl * TC_DK, S.ldq,
      out, r0);
}

// Cross-attention of the block's head hl (global head h), rows r0 ..: K
// fragments straight from the cache kc[l, b, h] (32-bit loads, zeros past
// Le), values staged in vall, the batch row's additive mask.
template <int NKS, typename Out>
__device__ void cross_attend(const Params<bf16>& p, const TcLayout& S, const bf16* qa, const bf16* vall, int l, int b,
                             int hl, int h, int r0, const Out& out) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, Le = p.Le;
  const unsigned* kc = reinterpret_cast<const unsigned*>(p.kc + (((size_t)l * p.B + b) * p.H + h) * Le * TC_DK);
  const float* mask_b = p.mask + (size_t)b * Le;
  attend16<NKS>(
      qa + hl * TC_DK, S.ldq,
      [&](int jp, int kk, unsigned (&bf)[4]) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int key = jp * 16 + half * 8 + g;
          const unsigned* kr = kc + (size_t)key * (TC_DK / 2) + kk * 8 + t;
          bf[2 * half] = key < Le ? __ldg(kr) : 0u;
          bf[2 * half + 1] = key < Le ? __ldg(kr + 4) : 0u;
        }
      },
      Le, [&](int, int key) { return __ldg(mask_b + key); }, vall + (size_t)hl * S.le_pad * KV_LD, KV_LD, out, r0);
}

// One batch row's decoder stack on a cluster of two blocks. Block `rank`
// computes the output columns [rank, rank + 1) * n / 2 of every product and
// the attention of heads [rank, rank + 1) * H / 2; what both need (the
// residual stream x, the heads' outputs, the FFN hidden) it writes into both
// blocks' shared memory, then the cluster barrier.
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(rows::THREADS, 1)
    decoder_stack_tc_kernel(Params<bf16> p) {
  using rows::Weights;
  constexpr int STAGES = TC_STAGES, LDW = TC_LDW, NT = TC_NT;
  extern __shared__ float4 tc_smem4[];
  bf16* sm = reinterpret_cast<bf16*>(tc_smem4);
  const int rank = (int)attn::cluster_rank();
  const int b = blockIdx.x / 2;
  const int kT = p.kT, d = p.d, H = p.H, Le = p.Le, dff = p.dff;
  const int inner = H * TC_DK, Hb = H / 2, dh = d / 2;  // heads and d columns of this block
  const TcLayout S = tc_layout(d, inner, H, Le);
  bf16 *x = sm + S.x, *xn = sm + S.xn, *qa = sm + S.qa, *oh = sm + S.oh, *ka = sm + S.ka, *va = sm + S.va;
  bf16* vall = sm + S.vall;
  bf16* hids[2] = {oh, sm + S.hid2};  // the FFN hidden chunks: the heads' output is dead then
  const unsigned delta = attn::cluster_addr(sm, rank ^ 1) - attn::smem_addr(sm);
  const int tid = threadIdx.x, nt = blockDim.x, warp = tid >> 5;
  const int m_tiles = (kT + 15) / 16, nks_self = (kT + 15) / 16, nks_cross = (Le + 15) / 16;
  rows::Pipe pipe{sm + S.w, 0, false};

  // padded rows stay zero in x and xn, so their q, k, v are zero too
  rows::zero_smem(sm, S.total * (int)sizeof(bf16));
  __syncthreads();
  const int xc = d / 8;
  for (int i = tid; i < kT * xc; i += nt) {
    const int r = i / xc, c = (i - r * xc) * 8;
    attn::cp_async16(x + r * S.ldx + c, p.x + ((size_t)b * kT + r) * d + c, true);
  }
  attn::cp_async_commit();
  // layer 0's wq tiles load with the rows
  rows::prime<STAGES, LDW>(pipe, rows::per_head(p.wq + (size_t)rank * Hb * d * TC_DK, d, inner / 2));
  attn::cp_async_wait<STAGES - 1>();
  attn::cluster_sync();  // and the partner runs: its shared memory may be written

  // x = rnd(x + rnd(v)) for this block's columns c0 + c, in both blocks
  const auto residual_at = [&](int c0) {
    return [=](int r, int c, float v0, float v1) {
      if (r < kT) residual_both(x + r * S.ldx + c0 + c, v0, v1, delta);
    };
  };
  // dst = rnd(xn @ w) for this block's heads, w per-head blocks [H, d, 64]
  const auto heads_product = [&](const bf16* w, const Weights* next, bf16* dst) {
    float acc[1][NT][4];
    rows::zero(acc);
    rows::mma_pass<1, NT, STAGES, LDW>(acc, xn, S.ldx, rows::per_head(w + (size_t)rank * Hb * d * TC_DK, d, inner / 2),
                                       next, pipe);
    rows::for_each_pair(acc, inner / 2, [&](int r, int c, float v0, float v1) {
      rows::store_pair(dst + r * S.ldq + c, v0, v1);
    });
  };
  // x = rnd(x + rnd(oh @ w)), w [H*dk, d]: one float32 sum over all heads
  const auto out_projection = [&](const Weights& w, const Weights* next) {
    float acc[1][NT][4];
    rows::zero(acc);
    rows::mma_pass<1, NT, STAGES, LDW>(acc, oh, S.ldo, w, next, pipe);
    rows::for_each_pair(acc, dh, residual_at(rank * dh));
    attn::cluster_sync();
  };
  const auto heads_out = [&](int h) {
    return [=](int r, int c, float v0, float v1) { store_both(oh + r * S.ldo + h * TC_DK + c, v0, v1, delta); };
  };
  // this block's part of a row-major product: columns rank * n / 2 ..
  const auto part = [&](const bf16* base, int ldw, int K, int n) {
    return rows::row_major(base + rank * (n / 2), ldw, K, n / 2);
  };

#pragma unroll 1
  for (int l = 0; l < p.NL; ++l) {
    const size_t wofs = (size_t)l * H * d * TC_DK, wl = (size_t)l;
    const Weights wk = rows::per_head(p.wk + wofs + (size_t)rank * Hb * d * TC_DK, d, inner / 2),
                  wv = rows::per_head(p.wv + wofs + (size_t)rank * Hb * d * TC_DK, d, inner / 2),
                  cq = rows::per_head(p.cq + wofs + (size_t)rank * Hb * d * TC_DK, d, inner / 2);
    const Weights wo = part(p.wo + wl * inner * d, d, inner, d), co = part(p.co + wl * inner * d, d, inner, d);
    const bf16 *wi = p.wi + wl * d * dff, *wo2 = p.wo2 + wl * dff * d;
    const auto wi_chunk = [&](int c0) { return part(wi + c0, dff, d, dff - c0 < TC_FC ? dff - c0 : TC_FC); };

    // ---- self-attention, beam-folded under bias_fold ----
    rows::rmsnorm_bf16<false>(x, S.ldx, p.ln_s + wl * d, xn, S.ldx, kT, d, p.eps);
    __syncthreads();
    heads_product(p.wq + wofs, &wk, qa);
    heads_product(p.wk + wofs, &wv, ka);
    heads_product(p.wv + wofs, &wo, va);  // wo's first tiles stream in during the attention
    __syncthreads();
    for (int u = warp; u < Hb * m_tiles; u += nt / 32) {
      const int hl = u / m_tiles, r0 = (u % m_tiles) * 16, h = rank * Hb + hl;
      if (nks_self == 1) self_attend<1>(p, S, qa, ka, va, hl, h, r0, heads_out(h));
      else self_attend<2>(p, S, qa, ka, va, hl, h, r0, heads_out(h));
    }
    attn::cluster_sync();
    out_projection(wo, &cq);

    // ---- cross-attention against the cached K/V ----
    rows::rmsnorm_bf16<false>(x, S.ldx, p.ln_c + wl * d, xn, S.ldx, kT, d, p.eps);
    __syncthreads();
    heads_product(p.cq + wofs, nullptr, qa);  // the values below overlay the weight tiles
    {
      // this block's heads' values [Le, 64] into vall [Hb, le_pad, KV_LD], zeros past Le
      const bf16* vsrc = p.vc + (((size_t)l * p.B + b) * H + rank * Hb) * Le * TC_DK;
      for (int i = tid; i < Hb * S.le_pad * 8; i += nt) {
        const int hr = i >> 3, c = (i & 7) * 8, hh = hr / S.le_pad, r = hr - hh * S.le_pad;
        const bool ok = r < Le;
        attn::cp_async16(vall + hr * KV_LD + c, vsrc + (ok ? ((size_t)hh * Le + r) * TC_DK + c : 0), ok);
      }
      attn::cp_async_commit();
      attn::cp_async_wait_all();
    }
    __syncthreads();
    for (int u = warp; u < Hb * m_tiles; u += nt / 32) {
      const int hl = u / m_tiles, r0 = (u % m_tiles) * 16, h = rank * Hb + hl;
      const auto out = heads_out(h);
      switch (nks_cross) {
        case 1: cross_attend<1>(p, S, qa, vall, l, b, hl, h, r0, out); break;
        case 2: cross_attend<2>(p, S, qa, vall, l, b, hl, h, r0, out); break;
        case 3: cross_attend<3>(p, S, qa, vall, l, b, hl, h, r0, out); break;
        case 4: cross_attend<4>(p, S, qa, vall, l, b, hl, h, r0, out); break;
        case 5: cross_attend<5>(p, S, qa, vall, l, b, hl, h, r0, out); break;
        case 6: cross_attend<6>(p, S, qa, vall, l, b, hl, h, r0, out); break;
        case 7: cross_attend<7>(p, S, qa, vall, l, b, hl, h, r0, out); break;
        default: cross_attend<8>(p, S, qa, vall, l, b, hl, h, r0, out); break;
      }
    }
    attn::cluster_sync();
    const Weights first = wi_chunk(0);
    out_projection(co, &first);

    // ---- FFN: relu(xn @ wi) @ wo2, dff in chunks, one float32 sum ----
    rows::rmsnorm_bf16<false>(x, S.ldx, p.ln_f + wl * d, xn, S.ldx, kT, d, p.eps);
    __syncthreads();
    float acc2[1][NT][4];
    rows::zero(acc2);
    for (int c0 = 0, chunk = 0; c0 < dff; c0 += TC_FC, ++chunk) {
      const int nc = dff - c0 < TC_FC ? dff - c0 : TC_FC;
      bf16* hid = hids[chunk & 1];
      const Weights w1 = wi_chunk(c0), w2 = part(wo2 + (size_t)c0 * d, d, nc, d);
      float acc1[1][4][4];
      rows::zero(acc1);
      rows::mma_pass<1, 4, STAGES, LDW>(acc1, xn, S.ldx, w1, &w2, pipe);
      rows::for_each_pair(acc1, nc / 2, [&](int r, int c, float v0, float v1) {
        store_both(hid + r * S.ldo + rank * (nc / 2) + c, fmaxf(Num<bf16>::rnd(v0), 0.f),
                   fmaxf(Num<bf16>::rnd(v1), 0.f), delta);
      });
      attn::cluster_sync();
      // then the next chunk's wi, or the next layer's wq
      const bool last = c0 + TC_FC >= dff;
      const Weights after =
          !last ? wi_chunk(c0 + TC_FC)
                : rows::per_head(p.wq + (size_t)(l + 1) * H * d * TC_DK + (size_t)rank * Hb * d * TC_DK, d, inner / 2);
      rows::mma_pass<1, NT, STAGES, LDW>(acc2, hid, S.ldo, w2, last && l + 1 == p.NL ? nullptr : &after, pipe);
    }
    rows::for_each_pair(acc2, dh, residual_at(rank * dh));
    attn::cluster_sync();
  }
  // the final norm: each block writes its share of the rows
  const int half = (kT + 1) / 2, r_lo = rank * half, r_hi = r_lo + half < kT ? r_lo + half : kT;
  if (r_hi > r_lo)
    rows::rmsnorm_bf16<true>(x + r_lo * S.ldx, S.ldx, p.ln_final, p.out + ((size_t)b * kT + r_lo) * d, 0, r_hi - r_lo,
                             d, p.eps);
}

// the tensor-core kernel takes bf16 only (tensor_core_route)
inline cudaError_t launch_tc(const Params<float>&, size_t, cudaStream_t) { return cudaErrorInvalidValue; }
inline cudaError_t launch_tc(const Params<bf16>& p, size_t smem, cudaStream_t stream) {
  const cudaError_t err =
      cudaFuncSetAttribute(decoder_stack_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  decoder_stack_tc_kernel<<<2 * p.B, rows::THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// shared memory a block of the tensor-core route asks for at these widths
inline int tc_smem_bytes(int d, int inner, int H, int Le) {
  return tc_layout(d, inner, H, Le).total * (int)sizeof(bf16);
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
  if (tensor_core_route(std::is_same<T, bf16>::value, p.kT, p.d, p.dk, p.H * p.dk, p.dff, p.Le))
    return (int)launch_tc(p, tc_smem_bytes(p.d, p.H * p.dk, p.H, p.Le), static_cast<cudaStream_t>(stream));
  const size_t smem = (size_t)make_layout(p.kT, p.d, p.dk, p.Le).total * sizeof(float);
  const cudaError_t err =
      cudaFuncSetAttribute(decoder_stack_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  decoder_stack_kernel<T><<<p.B, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// The kernel's route: 1 = tensor cores (bf16 at dk = 64, kT <= 32, Le <= 128,
// widths that are multiples of 128), 0 = CUDA cores.
int decoder_stack_route(int is_bf16, int kT, int d, int dk, int inner, int dff, int Le) {
  return tensor_core_route(is_bf16 != 0, kT, d, dk, inner, dff, Le) ? 1 : 0;
}

// Shared memory one block needs on its route for these widths; the host
// wrapper refuses shapes above the card's 227 KB per block.
int decoder_stack_smem_bytes(int is_bf16, int kT, int d, int dk, int inner, int dff, int Le) {
  if (tensor_core_route(is_bf16 != 0, kT, d, dk, inner, dff, Le)) return tc_smem_bytes(d, inner, inner / dk, Le);
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
