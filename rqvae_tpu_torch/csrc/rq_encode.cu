// Fused MLP encode + L-level residual quantization (corpus index build).
//
// Replaces the Pallas TPU kernel rqvae_tpu/ops/pallas/rq_encode.py::_kernel
// (via fused_encode_quantize). For each corpus row: the bias-free MLP chain
// (matmul -> ReLU -> ... -> matmul), then for each level
// argmin_k(cb2_k - 2 res.cb_k) with the lowest index kept on exact ties
// (cb2: the squared norms of the unrounded float32 codebooks), then
// res -= cb[id]. Writes the [N, L] int32 ids.
//
// Two modes, as the reference's `precision`. float32: every value and sum in
// float32. bf16: the values are rounded to bfloat16 where the reference casts
// to its compute dtype (rq_encode.py::_kernel) and nowhere else: x on load;
// each layer's output, after the ReLU between layers and also after the last
// layer (no ReLU there), which gives the residual; the residual after each
// level's subtraction. Sums stay float32 and a product of two bf16 values is
// exact in float32, so the bf16 mode computes the reference's function up to
// the order of its float32 sums. The wrapper hands the kernel weights and
// codebooks already rounded to bf16 in bf16 mode (once per call, as the
// reference casts them outside its kernel) and cb2 from the unrounded ones.
//
// Operands, as the wrapper prepares them: x float32 [n_rows, dims[0]] with
// dims[0] a multiple of 4 (16-byte rows; the wrapper pads x's columns and the
// first weight's rows with zeros where it is not, which adds nothing to any
// sum); every later width a multiple of 16 (zero-padded the same way: a zero
// column of a layer is a zero input of the next one, a zero column of the
// codebooks a zero term of every distance); the codebooks as [L, K, D] (the
// gather of the chosen code) and transposed [L, D, K] (the distance product's
// right operand, row-major like a weight), K a multiple of 16 with the codes
// past the real codebook given cb2 = +inf, so that they never win an argmin.
//
// Bound on the H100: compute. At the Amazon geometry (768 -> 512 -> 256 ->
// 128 -> 32, 3 x 256 codebooks) a row costs 1.17 MFLOP against 3 KB read: in
// bf16 the tensor cores' 989 TFLOP/s bound it (0.078 ms for 65,536 rows), in
// float32 the CUDA cores' 67 TFLOP/s (1.15 ms; TF32 would move argmins, so
// the float32 mode never uses the tensor cores).
//
// Both routes take a tile of ROWS = 64 rows per block of 512 threads, one
// block per SM, and run the whole chain on chip: every layer's output, the
// residual and the distances stay in shared memory or registers, and the
// only device-memory traffic is x, the ids, and the weight stack, which
// stays in L2 and streams through a ring of shared-memory K-tiles copied by
// every thread with 16-byte cp.async, shared by all 16 warps.
//
// Route "tensor_cores" (bf16 at widths 16..512 that are powers of two and
// K = 64, 128 or 256: every shipped configuration): activations are bf16 in
// shared memory (every value the kernel keeps is a bf16 value in this mode,
// so the storage is exact). Every product -- the MLP layers, in passes of at
// most 256 columns, and each level's distances res @ cb^T (cb^T staged like
// a weight) -- runs on mma.sync (bf16 operands): the 16 warps split a pass
// 2 (rows) x 8 (columns), A fragments by ldmatrix from the activations, B
// fragments by ldmatrix.trans from the staged K-tile (3 deep; 32 to 64 rows,
// fewer for the widest passes, so a narrow product takes few tiles). All the
// kernel's K-tiles form one stream, so the next pass's first tiles are copied
// while the current one ends. x is read as the first pass runs, 32 columns a
// tile, two tiles ahead, rounded to bf16 into a whole [64, dims[0]] tile that
// the first layer's later passes read again. Sums: the tensor cores round
// their own sums toward zero, and a long chain of them biases the layer
// outputs, so each k step's products are summed from zero (8 deep in the
// first layer, 16 after) and added to float32 sums in registers, ascending,
// by round-to-nearest additions (mma_add): the closest these sums come to
// the plain version's sequence of float32 additions. The argmin is taken on
// the accumulator fragments: within a thread's columns, across the quad
// (shfl_xor 1, 2), then across the 8 column warps through shared memory,
// always keeping the lower index on equal distances; the chosen code is
// gathered from the bf16 codebook, subtracted in float32 and rounded to
// bf16. What bounds it on the H100: the mma.sync issue rate and the float32
// additions of the fresh sums (k8 doubles both in the first layer), not the
// weight bytes from L2 (1/64 of the bf16 stack per row).
//
// Route "cuda_cores" (float32, and bf16 at other widths): float32 FMAs in
// registers, each output an ascending fmaf chain over k. Each thread owns a
// TM x TN register tile (8 x 8 for 512 outputs, 4 x 8, 4 x 4, 2 x 4 for
// narrower layers) and reads per two k steps TM float2 of its rows
// (broadcast within the warp) and TN / 4 float4 of staged weights (a warp's
// 32 threads read 512 contiguous bytes; a tile of 8 columns is two float4
// half a row apart), so that 128 FMAs follow 12 shared-memory reads. The
// first layer streams x in 16-column chunks beside its weight K-tiles (a
// whole float32 x tile would not fit beside the first layer's output); the
// later layers read the previous output from shared memory; weight K-tiles
// are double-buffered. The argmin writes each thread's best per row to the
// dead weight ring, and 8 threads a row reduce it, lower index first.
//
// With pack_bits > 0 (the reference's emit_packed epilogue), each row's
// output holds one more column: the lexicographic packed key of its ids,
// ((id_0 << b | id_1) << b | ...), which the thread that writes the row's
// ids keeps in a register across the levels (n_levels * b <= 31).
//
// Shared memory (both routes fit every shipped configuration in the 232,448
// B a Hopper block may use): see tc::layout and cc::layout, mirrored by
// rqvae_tpu_torch/ops/cuda/rq_encode.py::rq_encode_smem_bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#include "mma_core.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int MAX_WEIGHTS = 8;
constexpr int MAX_LEVELS = 16;
constexpr int MAX_PASSES = 2 * MAX_WEIGHTS + MAX_LEVELS;
constexpr int MAX_WIDTH = 512;   // widest layer and largest codebook either route takes
constexpr int ROWS = 64;         // corpus rows per block, both routes
constexpr int THREADS = 512;     // 16 warps
constexpr int SMEM_LIMIT = 232448;

// One product of the chain: rows [0, k) of an [k, n] block of a row-major
// right operand with rows ld apart (a weight or a column block of one, or one
// level's transposed codebook), in nk K-tiles of bk rows.
struct Pass {
  const void* w;
  int k, n, ld, bk, nk;
};

struct Params {
  const float* x;          // [n_rows, dims[0]]
  int dims[MAX_WEIGHTS + 1];
  int n_weights;
  const void* cb;          // [n_levels, K, D]: the gather of the chosen codes
  const float* cb2;        // [n_levels, K], +inf past the real codebook
  int n_rows, n_levels, K, D;
  int* out;                // [n_rows, ld_out]: the ids, then the packed key when pack_bits > 0
  int ld_out, pack_bits;
  Pass pass[MAX_PASSES];   // the layers (the tensor-core route's in blocks of 256 columns), then the levels
  int n_passes;
};

// v rounded to the nearest bf16 value (ties to even) when BF16, else v.
template <bool BF16>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (BF16) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

// (d, i) replaces (best, bi) when nearer, or as near with a lower index
__device__ __forceinline__ void take_min(float& best, int& bi, float d, int i) {
  if (d < best || (d == best && i < bi)) {
    best = d;
    bi = i;
  }
}

__host__ __device__ inline int max_i(int a, int b) { return a > b ? a : b; }

// ---------------------------------------------------------------------------
// Route "tensor_cores"
// ---------------------------------------------------------------------------
namespace tc {

constexpr int WARPS_N = 8;  // 16 warps: 2 (rows, 32 each) x 8 (columns) of every product
constexpr int STAGES = 3;
constexpr int SLOT_CAP = 64 * 136;  // bf16 a ring slot may hold: 32 rows of 256 columns, or 64 of 128
constexpr int MAX_PASS_N = 256;     // a wider layer runs as passes of 256 columns (32 sums a thread)

__host__ __device__ inline bool width_ok(int n) {
  return n == 16 || n == 32 || n == 64 || n == 128 || n == 256 || n == 512;
}
__host__ __device__ inline bool codebook_ok(int k) { return k == 64 || k == 128 || k == 256; }

// columns of the staged x tile (the MMA depth) and the row stride, in bf16,
// of activation i: an odd multiple of 16 bytes, so the 8 rows an ldmatrix
// reads hit distinct banks
__host__ __device__ inline int x_cols(int in_dim) { return (in_dim + 15) / 16 * 16; }
__host__ __device__ inline int act_ld(const int* dims, int i) { return (i == 0 ? x_cols(dims[0]) : dims[i]) + 8; }

// Rows of a K-tile of a product of depth k (a multiple of 16) and n columns:
// the deepest power-of-two multiple of 16 that divides k and fits a slot, so
// that a narrow product takes few tiles (each tile costs a barrier and the
// copies in flight stay near a slot's worth of bytes).
__host__ __device__ inline int tile_k(int k, int n) {
  int bk = 16;
  while (k % (2 * bk) == 0 && 2 * bk * (n + 8) <= SLOT_CAP) bk *= 2;
  return bk;
}

// Byte offsets: the buffer that ends with the residual first, the other
// activation buffer, the ring of K-tiles (each slot the largest tile of any
// product), the argmin's candidates [ROWS, WARPS_N] and ids [ROWS].
// Activation i lives in buffer i & 1, so the layers ping-pong between them.
struct Layout {
  int buf[2], ring, slot, scratch, ids, total;
};

__host__ __device__ inline Layout layout(const int* dims, int n_weights, int K) {
  int widest[2] = {0, 0};
  for (int i = 0; i <= n_weights; ++i) widest[i & 1] = max_i(widest[i & 1], act_ld(dims, i));
  const int D = dims[n_weights];
  int slot = tile_k(D, K) * (K + 8);
  for (int i = 0; i < n_weights; ++i) {
    const int k = i == 0 ? x_cols(dims[0]) : dims[i], n = dims[i + 1] < MAX_PASS_N ? dims[i + 1] : MAX_PASS_N;
    slot = max_i(slot, tile_k(k, n) * (n + 8));
  }
  Layout L;
  const int res = n_weights & 1;
  L.buf[res] = 0;
  L.buf[res ^ 1] = ROWS * widest[res] * 2;
  L.ring = L.buf[res ^ 1] + ROWS * widest[res ^ 1] * 2;
  L.slot = slot;  // bf16
  L.scratch = L.ring + STAGES * L.slot * 2;
  L.ids = L.scratch + ROWS * WARPS_N * 8;
  L.total = L.ids + ROWS * 4;
  return L;
}

__host__ inline bool takes(const int* dims, int n_weights, int K, int D) {
  if (dims[0] % 4 || !codebook_ok(K) || dims[n_weights] != D) return false;
  for (int i = 1; i <= n_weights; ++i)
    if (!width_ok(dims[i])) return false;
  return layout(dims, n_weights, K).total <= SMEM_LIMIT;
}

// two 8 x 8 bf16 matrices, transposed: lanes 0-15 give the row addresses
__device__ __forceinline__ void ldsm_x2_t(unsigned (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(attn::smem_addr(p))
               : "memory");
}

// acc += a (16 x 16) b (16 x 8): the products of each k step summed from
// zero by the tensor cores, and added to acc by round-to-nearest float32
// additions in ascending k. The tensor cores round their own sums toward
// zero: chained through a long product (48 k steps at 768 inputs) the bias
// moves bf16 roundings of the layer outputs in one direction, and those carry
// to the ids; a fresh sum per step bounds the error of each to that step.
// K8: two steps of 8 (m16n8k8), so that the first layer's long sums come
// closer to the plain version's sequence of float32 additions.
template <bool K8>
__device__ __forceinline__ void mma_add(float (&acc)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  float d[4];
  if constexpr (K8) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
        "{%7, %7, %7, %7};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(b0), "f"(0.f));
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] += d[e];
    asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
        "{%7, %7, %7, %7};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[2]), "r"(a[3]), "r"(b1), "f"(0.f));
  } else {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%10, %10, %10, %10};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += d[e];
}

// The ring of K-tiles. The kernel's right operands form one stream of tiles,
// pass after pass; tile t sits in slot t % STAGES with its pass's depth bk
// and row stride n + 8. Every thread keeps the same cursor (the next tile).
struct Ring {
  bf16* base;
  int slot;
  int issued;   // tiles copied so far
  int ip, ikt;  // the next tile: pass, K-tile
};

// Copy the next tile of the stream (if any) into its slot and commit one
// cp.async group (empty at the end of the stream), so that every call
// commits exactly one group. Rows past the pass's k read as zeros.
__device__ __forceinline__ void issue(const Params& p, Ring& r) {
  if (r.ip < p.n_passes) {
    const Pass& ps = p.pass[r.ip];
    const bf16* w = static_cast<const bf16*>(ps.w);
    bf16* dst = r.base + (r.issued % STAGES) * r.slot;
    const int ldw = ps.n + 8;
    const int shift = __ffs(ps.n / 8) - 1;  // 16-byte pieces per row, a power of two
    for (int i = threadIdx.x; i < (ps.bk << shift); i += THREADS) {
      const int row = i >> shift, c = (i & ((1 << shift) - 1)) * 8;
      const int k = r.ikt * ps.bk + row;
      const bool valid = k < ps.k;
      attn::cp_async16(dst + row * ldw + c, w + (size_t)(valid ? k : 0) * ps.ld + c, valid);
    }
    ++r.issued;
    if (++r.ikt == ps.nk) {
      r.ikt = 0;
      ++r.ip;
    }
  }
  attn::cp_async_commit();
}

// This thread's four values of x chunk c (columns [32c, 32c + 32) of the
// block's 64 rows: row t / 8, columns 32c + 4 (t % 8)), zeros past the corpus
// end and past dims[0] (a multiple of 4); and the four rounded to bf16 into
// the x tile.
__device__ __forceinline__ float4 x_quad(const Params& p, int row0, int c) {
  const int r = threadIdx.x >> 3, col = c * 32 + (threadIdx.x & 7) * 4;
  if (row0 + r < p.n_rows && col < p.dims[0])
    return __ldg(reinterpret_cast<const float4*>(p.x + (size_t)(row0 + r) * p.dims[0] + col));
  return make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ void put_x_quad(bf16* xs, int ld, int c, float4 v) {
  *reinterpret_cast<uint2*>(xs + (threadIdx.x >> 3) * ld + c * 32 + (threadIdx.x & 7) * 4) =
      make_uint2(attn::pack_bf16(v.x, v.y), attn::pack_bf16(v.z, v.w));
}

// acc = A[64, nk * bk] @ (the stream's next nk tiles of bk rows)[., n]. A:
// bf16 rows in shared memory, row stride lda. Warp (wm, wn) holds rows
// wm * 32 + [0, 32) and columns wn * NT * 8 + [0, NT * 8) (n < 64: only
// n / 8 column warps work). Each tile waits for its copies, passes one block
// barrier (after which the slot of the previous tile is free and the
// previous pass's epilogue stores are visible) and copies the tile STAGES - 1
// ahead. The k steps add in ascending order (mma_add; K8: steps of 8).
// SX (the first pass of the first layer, at bk = 32): A is the x tile,
// filled as the pass runs: chunk 0 is in place, chunk c is loaded into
// registers during tile c - 2 and stored during tile c - 1, so that reading x
// overlaps the products.
template <int NT, bool SX, bool K8 = false>
__device__ __forceinline__ void mma_pass(const Params& p, Ring& ring, int& consumed, const bf16* A, int lda,
                                         const Pass& ps, float (&acc)[2][NT][4], bf16* xs = nullptr, int row0 = 0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int n = ps.n, ldw = n + 8, col0 = wn * NT * 8;
  const bool active = col0 < n;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[mi][j][0] = acc[mi][j][1] = acc[mi][j][2] = acc[mi][j][3] = 0.f;
  float4 x_next;  // the next chunk of x to store
  if constexpr (SX) x_next = x_quad(p, row0, 1);
  const bf16* a_ptr = A + (wm * 32 + attn::a_row(lane)) * lda + attn::a_col(lane);
  for (int kt = 0; kt < ps.nk; ++kt, ++consumed) {
    attn::cp_async_wait<STAGES - 2>();
    __syncthreads();
    issue(p, ring);
    if constexpr (SX) {  // chunk kt + 1, read by tile kt + 1 after the next barrier
      if (kt + 1 < ps.nk) put_x_quad(xs, lda, kt + 1, x_next);
      if (kt + 2 < ps.nk) x_next = x_quad(p, row0, kt + 2);
    }
    if (!active) continue;
    const bf16* wt = ring.base + (consumed % STAGES) * ring.slot;
    for (int ks = 0; ks < ps.bk; ks += 16) {
      unsigned a0[4], a1[4];
      attn::ldsm_x4(a0, a_ptr + kt * ps.bk + ks);
      attn::ldsm_x4(a1, a_ptr + 16 * lda + kt * ps.bk + ks);
      if constexpr (NT == 1) {
        unsigned b[2];
        ldsm_x2_t(b, wt + (ks + (lane & 15)) * ldw + col0);
        mma_add<K8>(acc[0][0], a0, b[0], b[1]);
        mma_add<K8>(acc[1][0], a1, b[0], b[1]);
      } else {
        const bf16* b_ptr = wt + (ks + attn::bt_row(lane)) * ldw + col0 + attn::bt_col(lane);
#pragma unroll
        for (int jp = 0; jp < NT / 2; ++jp) {
          unsigned b[4];
          attn::ldsm_x4_t(b, b_ptr + jp * 16);
          mma_add<K8>(acc[0][2 * jp], a0, b[0], b[1]);
          mma_add<K8>(acc[0][2 * jp + 1], a0, b[2], b[3]);
          mma_add<K8>(acc[1][2 * jp], a1, b[0], b[1]);
          mma_add<K8>(acc[1][2 * jp + 1], a1, b[2], b[3]);
        }
      }
    }
  }
}

// A layer's output: ReLU between layers, rounded to bf16, into the rows of
// the next activation buffer (row stride ldo).
template <int NT>
__device__ __forceinline__ void store_layer(const float (&acc)[2][NT][4], bf16* out, int ldo, int n, bool relu) {
  // out: the pass's first column; n: its width
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int col0 = wn * NT * 8;
  if (col0 >= n) return;
  const int row = wm * 32 + (lane >> 2), col = col0 + 2 * (lane & 3);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v0 = acc[mi][j][2 * h], v1 = acc[mi][j][2 * h + 1];
        if (relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        *reinterpret_cast<unsigned*>(out + (row + mi * 16 + 8 * h) * ldo + col + j * 8) = attn::pack_bf16(v0, v1);
      }
}

// Each warp's nearest code per row among its columns, cb2 - 2 res.cb in
// float32: within the thread's columns in ascending order, then across the
// quad; one candidate per (row, column warp) into scratch.
template <int NT>
__device__ __forceinline__ void row_candidates(const float (&acc)[2][NT][4], const float (&cb2)[NT][2],
                                               float2* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int col = wn * NT * 8 + 2 * (lane & 3);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float best = INFINITY;
      int bi = INT_MAX;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = col + j * 8 + e;
          const float d = cb2[j][e] - 2.0f * acc[mi][j][2 * h + e];
          if (d < best) {  // ascending columns: the first of equals stays
            best = d;
            bi = c;
          }
        }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1)
        take_min(best, bi, __shfl_xor_sync(0xffffffffu, best, off), __shfl_xor_sync(0xffffffffu, bi, off));
      if ((lane & 3) == 0)
        scratch[(wm * 32 + mi * 16 + 8 * h + (lane >> 2)) * WARPS_N + wn] = make_float2(best, __int_as_float(bi));
    }
}

// The x tile, rounded to bf16: rows past the corpus end and columns past
// dims[0] (up to the MMA depth) are zeros.
__device__ __forceinline__ void load_x(const Params& p, bf16* xs, int row0) {
  const int in4 = p.dims[0] / 4, cols4 = x_cols(p.dims[0]) / 4, ld = act_ld(p.dims, 0);
#pragma unroll 4
  for (int i = threadIdx.x; i < ROWS * cols4; i += THREADS) {
    const int r = i / cols4, c = i - r * cols4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < p.n_rows && c < in4) v = __ldg(reinterpret_cast<const float4*>(p.x + (size_t)(row0 + r) * p.dims[0]) + c);
    *reinterpret_cast<uint2*>(xs + r * ld + c * 4) = make_uint2(attn::pack_bf16(v.x, v.y), attn::pack_bf16(v.z, v.w));
  }
}

// Pass q, columns [c0, c0 + pass width) of layer i: its products and its
// stores into activation i + 1.
template <int NT>
__device__ __forceinline__ void layer(const Params& p, Ring& ring, int& consumed, bf16* const* buf, int i, int q,
                                      int c0, int row0) {
  float acc[2][NT][4];
  const Pass& ps = p.pass[q];
  if (q == 0 && ps.bk == 32)
    mma_pass<NT, true, true>(p, ring, consumed, buf[0], act_ld(p.dims, 0), ps, acc, buf[0], row0);
  else if (i == 0)
    mma_pass<NT, false, true>(p, ring, consumed, buf[0], act_ld(p.dims, 0), ps, acc);
  else
    mma_pass<NT, false>(p, ring, consumed, buf[i & 1], act_ld(p.dims, i), ps, acc);
  store_layer<NT>(acc, buf[(i + 1) & 1] + c0, act_ld(p.dims, i + 1), ps.n, i != p.n_weights - 1);
}

template <int NT>
__device__ __forceinline__ void distances(const Params& p, Ring& ring, int& consumed, const bf16* res, int level,
                                          float2* scratch) {
  const int col = (threadIdx.x >> 5) % WARPS_N * NT * 8 + 2 * (threadIdx.x & 3);
  float cb2[NT][2];  // this thread's columns' norms, read while the product runs
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) cb2[j][e] = __ldg(p.cb2 + level * p.K + col + j * 8 + e);
  float acc[2][NT][4];
  mma_pass<NT, false>(p, ring, consumed, res, p.D + 8, p.pass[p.n_passes - p.n_levels + level], acc);
  row_candidates<NT>(acc, cb2, scratch);
}

// the tensor-core route's kernel body (rq_encode_tc_kernel)
__device__ __forceinline__ void encode(const Params& p) {
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const Layout L = layout(p.dims, p.n_weights, p.K);
  bf16* buf[2] = {reinterpret_cast<bf16*>(smem + L.buf[0]), reinterpret_cast<bf16*>(smem + L.buf[1])};
  float2* scratch = reinterpret_cast<float2*>(smem + L.scratch);
  int* ids = reinterpret_cast<int*>(smem + L.ids);
  Ring ring{reinterpret_cast<bf16*>(smem + L.ring), L.slot, 0, 0, 0};
  int consumed = 0;
  const int row0 = blockIdx.x * ROWS;

  for (int s = 0; s < STAGES - 1; ++s) issue(p, ring);  // the first weight tiles load with x
  // the x tile, seen after the first pass's barrier: whole, or (the first
  // pass at 32-row tiles) its first chunk, the rest loaded by the pass
  if (p.pass[0].bk == 32) put_x_quad(buf[0], act_ld(p.dims, 0), 0, x_quad(p, row0, 0));
  else load_x(p, buf[0], row0);

  for (int i = 0, q = 0; i < p.n_weights; ++i)
    for (int c0 = 0; c0 < p.dims[i + 1]; c0 += p.pass[q].n, ++q) {
      const int n = p.pass[q].n;
      if (n >= 256) layer<4>(p, ring, consumed, buf, i, q, c0, row0);
      else if (n >= 128) layer<2>(p, ring, consumed, buf, i, q, c0, row0);
      else layer<1>(p, ring, consumed, buf, i, q, c0, row0);
    }

  bf16* res = buf[p.n_weights & 1];
  const int ldr = p.D + 8;
  const bf16* cb_all = static_cast<const bf16*>(p.cb);
  int packed = 0;  // the row's packed key (threads < ROWS)
  for (int level = 0; level < p.n_levels; ++level) {
    if (p.K == 256) distances<4>(p, ring, consumed, res, level, scratch);
    else if (p.K == 128) distances<2>(p, ring, consumed, res, level, scratch);
    else distances<1>(p, ring, consumed, res, level, scratch);
    __syncthreads();
    if (threadIdx.x < ROWS) {
      const int r = threadIdx.x;
      float best = INFINITY;
      int bi = INT_MAX;
      for (int w = 0; w < WARPS_N; ++w) {
        const float2 c = scratch[r * WARPS_N + w];
        take_min(best, bi, c.x, __float_as_int(c.y));
      }
      ids[r] = bi;
      packed = (packed << p.pack_bits) | bi;
      if (row0 + r < p.n_rows) {
        int* o = p.out + (size_t)(row0 + r) * p.ld_out;
        o[level] = bi;
        if (p.pack_bits && level + 1 == p.n_levels) o[p.n_levels] = packed;
      }
    }
    __syncthreads();
    if (level + 1 < p.n_levels) {  // res = rnd(res - cb[id]); the next pass's barrier orders it
      const bf16* cb = cb_all + (size_t)level * p.K * p.D;
      const int half = p.D / 2;
      for (int i = threadIdx.x; i < ROWS * half; i += THREADS) {
        const int r = i / half, c = (i - r * half) * 2;
        __nv_bfloat162* rp = reinterpret_cast<__nv_bfloat162*>(res + r * ldr + c);
        const float2 rv = __bfloat1622float2(*rp);
        const float2 cv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(cb + (size_t)ids[r] * p.D + c));
        *rp = __floats2bfloat162_rn(rv.x - cv.x, rv.y - cv.y);
      }
    }
  }
  attn::cp_async_wait<0>();  // only empty groups are left
}

}  // namespace tc

// ---------------------------------------------------------------------------
// Route "cuda_cores"
// ---------------------------------------------------------------------------
namespace cc {

constexpr int BK = 16;       // k rows per staged tile
constexpr int STAGES = 2;
constexpr int XLD = BK + 4;  // floats per staged x row

// A thread's register tile for a product n wide is TM x TN, TM = 8, 4, 4, 2
// for n in (256, 512], (128, 256], (64, 128], up to 64, so that 512 threads
// cover 64 x n; TN:
__host__ __device__ inline int tile_n(int n) { return n > 128 ? 8 : 4; }

// Byte offsets. Activation i >= 1 lives in the odd or the even buffer (row
// stride dims[i] + 4 floats); x only ever sits in the first layer's ring,
// [x chunk | weight tile] per stage, which shares its memory with the even
// buffer and the later products' ring: the even buffer is first written by
// the second layer. The argmin's candidates use the later ring once a
// distance product is done.
struct Layout {
  int odd, even, ring0, ring, ids, total;
};

__host__ __device__ inline Layout layout(const int* dims, int n_weights, int K) {
  int odd = 0, even = 0, later = K;
  for (int i = 1; i <= n_weights; ++i) {
    if (i & 1) odd = max_i(odd, dims[i] + 4);
    else even = max_i(even, dims[i] + 4);
    if (i >= 2) later = max_i(later, dims[i]);
  }
  Layout L;
  L.odd = 0;
  L.ring0 = L.even = ROWS * odd * 4;
  L.ring = L.even + ROWS * even * 4;
  const int ring0_bytes = STAGES * (ROWS * XLD + BK * dims[1]) * 4;
  const int rest_bytes = ROWS * even * 4 + STAGES * BK * later * 4;
  L.ids = L.even + max_i(ring0_bytes, rest_bytes);
  L.total = L.ids + ROWS * 4;
  return L;
}

__host__ inline bool takes(const int* dims, int n_weights, int K, int D) {
  if (dims[0] % 4 || K % 16 || K > MAX_WIDTH || dims[n_weights] != D) return false;
  for (int i = 1; i <= n_weights; ++i)
    if (dims[i] % 16 || dims[i] > MAX_WIDTH) return false;
  return layout(dims, n_weights, K).total <= SMEM_LIMIT;
}

// This thread's register tile in a product n wide: thread t takes row group
// rg = t / (n / TN), rows rg * TM + [0, TM), and column group cg = t % (n /
// TN), columns cg * 4 + [0, 4) and, for TN = 8, n / 2 + cg * 4 + [0, 4). A
// warp's 32 consecutive column groups read 512 contiguous bytes of a staged
// weight row; its rows are one broadcast address.
struct Tile {
  int rg, cg;
  bool active;
};

template <int TM, int TN>
__device__ __forceinline__ Tile tile_of(int n) {
  const int C = n / TN;
  return Tile{(int)threadIdx.x / C, (int)threadIdx.x % C, (int)threadIdx.x < (ROWS / TM) * C};
}

// acc = A[64, k] @ W[k, n] for this thread's tile (tile_of). X0: A is x,
// streamed from global memory in chunks beside the weight tiles (and rounded
// as read in bf16 mode); else A is float32 rows in shared memory (stride
// lda). Every output is an ascending fmaf chain over k.
template <bool BF16, bool X0, int TM, int TN>
__device__ __forceinline__ void fma_pass(const Params& p, const float* A, int lda, const float* __restrict__ W, int k,
                                         int n, float* ring, int row0, float (&acc)[TM][TN]) {
  const Tile t = tile_of<TM, TN>(n);
  const bool active = t.active;
  const int c_lo = t.cg * 4, c_hi = n / 2 + t.cg * 4;
  const int nk = (k + BK - 1) / BK;
  const int xslot = X0 ? ROWS * XLD : 0, slot = xslot + BK * n;
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[r][c] = 0.f;

  auto stage = [&](int kt) {
    float* dst = ring + (kt % STAGES) * slot;
    if (X0) {
      for (int i = threadIdx.x; i < ROWS * BK / 4; i += THREADS) {
        const int r = i / (BK / 4), c = (i % (BK / 4)) * 4, kk = kt * BK + c;
        const bool valid = row0 + r < p.n_rows && kk < k;
        attn::cp_async16(dst + r * XLD + c, p.x + (valid ? (size_t)(row0 + r) * p.dims[0] + kk : 0), valid);
      }
    }
    float* wd = dst + xslot;
    const int chunks = n / 4;
    for (int i = threadIdx.x; i < BK * chunks; i += THREADS) {
      const int r = i / chunks, c = (i - r * chunks) * 4, kk = kt * BK + r;
      const bool valid = kk < k;
      attn::cp_async16(wd + r * n + c, W + (size_t)(valid ? kk : 0) * n + c, valid);
    }
  };

  stage(0);
  attn::cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) stage(kt + 1);  // into the slot everyone finished with last iteration
    attn::cp_async_commit();
    attn::cp_async_wait<1>();
    __syncthreads();
    if (active) {
      const float* st = ring + (kt % STAGES) * slot;
      const float* wt = st + xslot;
      const float* at = X0 ? st + t.rg * TM * XLD : A + t.rg * TM * lda + kt * BK;
      const int ald = X0 ? XLD : lda;
#pragma unroll 1  // one k pair at a time: the other 15 warps hide the reads' latency
      for (int kk = 0; kk < BK; kk += 2) {
        float2 a[TM];
#pragma unroll
        for (int r = 0; r < TM; ++r) {
          a[r] = *reinterpret_cast<const float2*>(at + r * ald + kk);
          if (X0) a[r] = make_float2(round_to<BF16>(a[r].x), round_to<BF16>(a[r].y));
        }
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          float b[TN];
          const float4 lo = *reinterpret_cast<const float4*>(wt + (kk + s) * n + c_lo);
          b[0] = lo.x; b[1] = lo.y; b[2] = lo.z; b[3] = lo.w;
          if constexpr (TN == 8) {
            const float4 hi = *reinterpret_cast<const float4*>(wt + (kk + s) * n + c_hi);
            b[4] = hi.x; b[5] = hi.y; b[6] = hi.z; b[7] = hi.w;
          }
#pragma unroll
          for (int r = 0; r < TM; ++r) {
            const float av = s ? a[r].y : a[r].x;
#pragma unroll
            for (int c = 0; c < TN; ++c) acc[r][c] = fmaf(av, b[c], acc[r][c]);
          }
        }
      }
    }
    __syncthreads();  // the slot is free for the copy two tiles on
  }
}

// the column of register tile entry c
__device__ __forceinline__ int tile_col(int c, int c_lo, int c_hi) { return c < 4 ? c_lo + c : c_hi + c - 4; }

template <bool BF16, bool X0, int TM, int TN>
__device__ __forceinline__ void layer(const Params& p, const float* A, int lda, float* out, int i, float* ring,
                                      int row0) {
  const int n = p.dims[i + 1];
  float acc[TM][TN];
  fma_pass<BF16, X0, TM, TN>(p, A, lda, static_cast<const float*>(p.pass[i].w), p.pass[i].k, n, ring, row0, acc);
  const Tile t = tile_of<TM, TN>(n);
  if (!t.active) return;
  const int ldo = n + 4;
  const bool relu = i != p.n_weights - 1;
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int q = 0; q < TN / 4; ++q) {
      float v[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        v[c] = acc[r][4 * q + c];
        if (relu) v[c] = fmaxf(v[c], 0.f);
        v[c] = round_to<BF16>(v[c]);
      }
      *reinterpret_cast<float4*>(out + (t.rg * TM + r) * ldo + (q ? n / 2 : 0) + t.cg * 4) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
}

template <bool BF16, int TM, int TN>
__device__ __forceinline__ void distances(const Params& p, const float* res, int level, float* ring, float2* scratch) {
  const int n = p.K;
  float acc[TM][TN];
  fma_pass<BF16, false, TM, TN>(p, res, p.D + 4, static_cast<const float*>(p.pass[p.n_weights + level].w), p.D, n,
                                ring, 0, acc);
  const int ncg = n / TN;
  const Tile t = tile_of<TM, TN>(n);
  if (!t.active) return;
  const float* cb2 = p.cb2 + level * p.K;
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    float best = INFINITY;
    int bi = INT_MAX;
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int col = tile_col(c, t.cg * 4, n / 2 + t.cg * 4);
      take_min(best, bi, __ldg(cb2 + col) - 2.0f * acc[r][c], col);
    }
    scratch[(t.rg * TM + r) * ncg + t.cg] = make_float2(best, __int_as_float(bi));
  }
}

template <bool BF16>
__device__ __forceinline__ void any_layer(const Params& p, const float* A, int lda, float* out, int i, float* ring,
                                          int row0) {
  const int n = p.dims[i + 1];
  if (i == 0) {
    if (n > 256) layer<BF16, true, 8, 8>(p, A, lda, out, i, ring, row0);
    else if (n > 128) layer<BF16, true, 4, 8>(p, A, lda, out, i, ring, row0);
    else if (n > 64) layer<BF16, true, 4, 4>(p, A, lda, out, i, ring, row0);
    else layer<BF16, true, 2, 4>(p, A, lda, out, i, ring, row0);
  } else {
    if (n > 256) layer<BF16, false, 8, 8>(p, A, lda, out, i, ring, row0);
    else if (n > 128) layer<BF16, false, 4, 8>(p, A, lda, out, i, ring, row0);
    else if (n > 64) layer<BF16, false, 4, 4>(p, A, lda, out, i, ring, row0);
    else layer<BF16, false, 2, 4>(p, A, lda, out, i, ring, row0);
  }
}

// the CUDA-core route's kernel body (rq_encode_cc_kernel<BF16>)
template <bool BF16>
__device__ __forceinline__ void encode(const Params& p) {
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const Layout L = layout(p.dims, p.n_weights, p.K);
  float* buf[2] = {reinterpret_cast<float*>(smem + L.even), reinterpret_cast<float*>(smem + L.odd)};
  int* ids = reinterpret_cast<int*>(smem + L.ids);
  const int row0 = blockIdx.x * ROWS;

  for (int i = 0; i < p.n_weights; ++i) {
    // activation i + 1 into buffer (i + 1) & 1; the first layer reads x, the others activation i
    float* ring = reinterpret_cast<float*>(smem + (i == 0 ? L.ring0 : L.ring));
    any_layer<BF16>(p, buf[i & 1], p.dims[i] + 4, buf[(i + 1) & 1], i, ring, row0);
  }

  float* res = buf[p.n_weights & 1];
  const int ldr = p.D + 4;
  float* ring = reinterpret_cast<float*>(smem + L.ring);
  float2* scratch = reinterpret_cast<float2*>(ring);
  const int n = p.K, ncg = n / tile_n(n);
  const float* cb_all = static_cast<const float*>(p.cb);
  int packed = 0;  // the row's packed key (threads with s == 0)
  for (int level = 0; level < p.n_levels; ++level) {
    if (n > 256) distances<BF16, 8, 8>(p, res, level, ring, scratch);
    else if (n > 128) distances<BF16, 4, 8>(p, res, level, ring, scratch);
    else if (n > 64) distances<BF16, 4, 4>(p, res, level, ring, scratch);
    else distances<BF16, 2, 4>(p, res, level, ring, scratch);
    __syncthreads();
    {  // 8 threads a row, each over every 8th candidate in ascending order, then across the 8
      const int r = threadIdx.x >> 3, s = threadIdx.x & 7;
      float best = INFINITY;
      int bi = INT_MAX;
      for (int c = s; c < ncg; c += 8) {
        const float2 v = scratch[r * ncg + c];
        take_min(best, bi, v.x, __float_as_int(v.y));
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        take_min(best, bi, __shfl_xor_sync(0xffffffffu, best, off), __shfl_xor_sync(0xffffffffu, bi, off));
      if (s == 0) {
        ids[r] = bi;
        packed = (packed << p.pack_bits) | bi;
        if (row0 + r < p.n_rows) {
          int* o = p.out + (size_t)(row0 + r) * p.ld_out;
          o[level] = bi;
          if (p.pack_bits && level + 1 == p.n_levels) o[p.n_levels] = packed;
        }
      }
    }
    __syncthreads();
    if (level + 1 < p.n_levels) {  // the next distance product's first barrier orders it
      const float* cb = cb_all + (size_t)level * p.K * p.D;
      for (int i = threadIdx.x; i < ROWS * p.D; i += THREADS) {
        const int r = i / p.D, c = i - r * p.D;
        res[r * ldr + c] = round_to<BF16>(res[r * ldr + c] - __ldg(cb + (size_t)ids[r] * p.D + c));
      }
    }
  }
}

}  // namespace cc

__global__ void __launch_bounds__(THREADS, 1) rq_encode_tc_kernel(Params p) { tc::encode(p); }

template <bool BF16>
__global__ void __launch_bounds__(THREADS, 1) rq_encode_cc_kernel(Params p) { cc::encode<BF16>(p); }

enum Route { CUDA_CORES = 0, TENSOR_CORES = 1 };

int smem_bytes(const int* dims, int n_weights, int K, int route) {
  return route == TENSOR_CORES ? tc::layout(dims, n_weights, K).total : cc::layout(dims, n_weights, K).total;
}

template <typename Kernel>
int launch(Kernel kernel, const Params& p, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (p.n_rows + ROWS - 1) / ROWS;
  kernel<<<blocks, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Corpus rows per block, and the shared memory one block of `route`
// (0: cuda_cores, 1: tensor_cores) needs at these prepared widths.
int rq_encode_rows_per_block() { return ROWS; }
int rq_encode_smem_bytes(const int* dims, int n_weights, int K, int route) {
  return smem_bytes(dims, n_weights, K, route);
}

// Operands as the wrapper prepares them (see the head of this file):
// weights [dims[i], dims[i+1]], codebooks [n_levels, K, D] and their
// transposes [n_levels, D, K], cb2 [n_levels, K]; bf16 storage (weights,
// codebooks) on the tensor-core route, float32 on the CUDA-core route.
// bf16 != 0: the bf16 mode. pack_bits > 0: out is [n_rows, n_levels + 1],
// the last column each row's packed key (n_levels * pack_bits <= 31).
// Returns cudaErrorInvalidValue, launching nothing, when the route does not
// take these widths.
int rq_encode_forward(const float* x, int n_rows, void* const* weights, const int* dims, int n_weights,
                      const void* codebooks, const void* codebooks_t, const float* cb2, int n_levels, int K, int D,
                      int* out, int bf16, int route, int pack_bits, void* stream) {
  if (n_weights < 1 || n_weights > MAX_WEIGHTS || n_levels < 1 || n_levels > MAX_LEVELS || pack_bits < 0 ||
      n_levels * pack_bits > 31)
    return (int)cudaErrorInvalidValue;
  const bool tc_route = route == TENSOR_CORES;
  if (tc_route ? !(bf16 && tc::takes(dims, n_weights, K, D)) : !cc::takes(dims, n_weights, K, D))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = x;
  for (int i = 0; i <= n_weights; ++i) p.dims[i] = dims[i];
  p.n_weights = n_weights;
  p.cb = codebooks;
  p.cb2 = cb2;
  p.n_rows = n_rows;
  p.n_levels = n_levels;
  p.K = K;
  p.D = D;
  p.out = out;
  p.pack_bits = pack_bits;
  p.ld_out = n_levels + (pack_bits > 0);
  // K-tile rows: the tensor-core route's from tc::tile_k (x padded to the
  // MMA depth), the CUDA-core route's cc::BK
  auto bk_of = [&](int depth, int n) { return tc_route ? tc::tile_k(depth, n) : cc::BK; };
  const size_t elem = tc_route ? 2 : 4;
  int q = 0;
  for (int i = 0; i < n_weights; ++i) {
    const int depth = tc_route && i == 0 ? tc::x_cols(dims[0]) : dims[i], n = dims[i + 1];
    const int pn = tc_route && n > tc::MAX_PASS_N ? tc::MAX_PASS_N : n, bk = bk_of(depth, pn);
    for (int c0 = 0; c0 < n; c0 += pn)
      p.pass[q++] = Pass{static_cast<const char*>(weights[i]) + c0 * elem, dims[i], pn, n, bk, (depth + bk - 1) / bk};
  }
  const int bk = bk_of(D, K);
  for (int l = 0; l < n_levels; ++l)
    p.pass[q++] = Pass{static_cast<const char*>(codebooks_t) + (size_t)l * D * K * elem, D, K, K, bk, (D + bk - 1) / bk};
  p.n_passes = q;
  const int smem = smem_bytes(dims, n_weights, K, route);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tc_route) return launch(rq_encode_tc_kernel, p, smem, s);
  return bf16 ? launch(rq_encode_cc_kernel<true>, p, smem, s) : launch(rq_encode_cc_kernel<false>, p, smem, s);
}

}  // extern "C"
