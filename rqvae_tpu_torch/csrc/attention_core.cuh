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
// version holds whole rows in VMEM; a Hopper block has 227 KB, so Lk is tiled
// (KT keys at a time) and the softmax takes two passes over the keys: pass 1
// keeps a running row maximum and sum, pass 2 recomputes the same scores
// (same code, same order, so the same bits), divides by the sum, rounds the
// normalised p and accumulates p @ v. The usual online softmax would round
// exp(s - m) before the division, which is a different rounding than the
// reference's softmax(s).astype(dtype). The price is a second q k^T.
//
// Two versions of the routine, one arithmetic. The general one
// (attention_tile) runs the products on the CUDA cores in float32 (bf16
// operands are exact in float32): each thread owns a 4 x 4 tile of a QT x KT
// score block and a 4 x 4 (per 64 columns of dk) tile of the output, fed by
// float4 reads of q, k, p and v from shared memory. It serves float32, which
// must not drop to TF32, and any dk. For bf16 at dk = 64 (the head width of
// every configuration in the repository) attention_tile_mma runs both
// products on the tensor cores with mma.sync m16n8k16 (bf16 operands, float32
// sums): a warp owns 16 query rows, its q fragments stay in registers, k and
// a transposed v tile are read from shared memory as 32-bit pairs, and the
// rounded p goes from the score registers straight into the PV product's A
// fragments without touching shared memory. Ragged edges, both versions:
// keys past Lk score -inf (they are no keys at all, unlike masked ones) and
// their v rows are zero; query rows past Lq are computed on zeros and not
// stored.
//
// Dropout (rate > 0): keep bits are the murmur3 finaliser of the wrapping
// uint32 counter ((b*H + h)*Lq + q)*Lk + k XOR seed * 0x9E3779B9, keep iff
// bits >= round(rate * 2^32); dropped p is zeroed and the rest scaled by
// 1/(1-rate) in float32 before the rounding to the compute dtype.
//
// Row statistics: when Params::row_max / row_sum are set, each row's pass-1
// maximum m and sum l are written out ([B, H, Lq] float32), so that the
// backward kernel (csrc/attention_bwd.cu) rebuilds p = exp(s - m) / l from
// the forward's own m and l.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace attn {

constexpr float MASKED = -1e9f;
constexpr int QT = 64;        // query rows per block
constexpr int KT = 64;        // keys per tile
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 scores each
constexpr int MAX_DK = 128;   // two float4 output column groups per thread

template <typename T> struct Num;
template <> struct Num<float> {
  static __device__ __forceinline__ float rnd(float v) { return v; }
  static __device__ __forceinline__ float4 load4(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void store4(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
  }
};
template <> struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float rnd(float v) {
    return __bfloat162float(__float2bfloat16(v));  // round to nearest even
  }
  static __device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
  static __device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 u;
    u.x = *reinterpret_cast<const unsigned*>(&lo);
    u.y = *reinterpret_cast<const unsigned*>(&hi);
    *reinterpret_cast<uint2*>(p) = u;
  }
};

template <typename T> struct Params {
  const T *q, *k, *v;       // [B, H, Lq, dk], [B, H, Lk, dk] x 2
  const float* bias;        // [H, Lq, Lk]
  const float* mask_add;    // [B, Lk] additive (0 / -1e9), or null
  const int* mask_keep;     // [B, Lk] 1 = attend, used when mask_add is null
  T* out;                   // [B, H, Lq, dk]
  float* row_max;           // [B, H, Lq] softmax row maximum m, or null: not written
  float* row_sum;           // [B, H, Lq] sum l of exp(s - m) over the keys, or null
  int B, H, Lq, Lk, dk;
  int causal;
  int dropout;              // 0: no dropout, the three fields below unused
  unsigned seed_mix;        // seed * 0x9E3779B9 (wrapping)
  unsigned keep_thresh;     // keep iff bits >= this
  float keep_scale;         // 1 / (1 - rate)
};

__host__ __device__ inline int smem_floats(int dk) {
  return QT * (dk + 4) + KT * (dk + 4) + KT * dk + QT * (KT + 4) + KT;
}

__device__ __forceinline__ bool keep_bit(unsigned counter, unsigned seed_mix, unsigned thresh) {
  unsigned x = counter ^ seed_mix;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x >= thresh;
}

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
              (((unsigned)b * (unsigned)p.H + (unsigned)h) * (unsigned)Lq + (unsigned)row) * (unsigned)Lk + key;
          pv = (keep_bit(counter, p.seed_mix, p.keep_thresh) ? pv : 0.f) * p.keep_scale;
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

// ---- bf16, dk = 64: both products on the tensor cores ----

constexpr int MMA_THREADS = 128;  // 4 warps x 16 query rows = QT
constexpr int MMA_DK = 64;
constexpr int MMA_LD = 72;        // bf16 per shared-memory row: 144 B, conflict-free fragment reads

// d += a (16 x 16, row) * b (16 x 8, col), bf16 operands, float32 sums
__device__ __forceinline__ void mma_16816(float (&d)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (nearest even), the first in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// max / sum over the 4 lanes of a quad, which share a score row
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ void attention_tile_mma(const Params<__nv_bfloat16>& p, int b, int h, int q0) {
  using bf16 = __nv_bfloat16;
  __shared__ __align__(16) bf16 Qs[QT * MMA_LD];      // [query, dk]
  __shared__ __align__(16) bf16 Ks[KT * MMA_LD];      // [key, dk]
  __shared__ __align__(16) bf16 Vt[MMA_DK * MMA_LD];  // [dk, key]: v transposed
  __shared__ float madd[KT];
  const int Lq = p.Lq, Lk = p.Lk;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const size_t qbase = ((size_t)b * p.H + h) * Lq * MMA_DK;
  const size_t kbase = ((size_t)b * p.H + h) * Lk * MMA_DK;
  const float* bias_h = p.bias + (size_t)h * Lq * Lk;
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);

  // a thread moves 8 bf16 (16 B) of row r = i % 64; consecutive lanes take
  // consecutive rows, so the transposed v stores fall on consecutive addresses
  for (int i = tid; i < QT * 8; i += MMA_THREADS) {
    const int r = i & 63, c = (i >> 6) * 8;
    uint4 v = zero4;
    if (q0 + r < Lq) v = __ldg(reinterpret_cast<const uint4*>(p.q + qbase + (size_t)(q0 + r) * MMA_DK + c));
    *reinterpret_cast<uint4*>(Qs + r * MMA_LD + c) = v;
  }
  auto stage = [&](int k0, bool with_v) {
    for (int i = tid; i < KT * 8; i += MMA_THREADS) {
      const int r = i & 63, c = (i >> 6) * 8;
      uint4 kv = zero4, vv = zero4;
      if (k0 + r < Lk) {
        kv = __ldg(reinterpret_cast<const uint4*>(p.k + kbase + (size_t)(k0 + r) * MMA_DK + c));
        if (with_v) vv = __ldg(reinterpret_cast<const uint4*>(p.v + kbase + (size_t)(k0 + r) * MMA_DK + c));
      }
      *reinterpret_cast<uint4*>(Ks + r * MMA_LD + c) = kv;
      if (with_v) {
        const bf16* ve = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
        for (int e = 0; e < 8; ++e) Vt[(c + e) * MMA_LD + r] = ve[e];
      }
    }
    for (int j = tid; j < KT; j += MMA_THREADS) {
      float a = 0.f;
      if (k0 + j < Lk)
        a = p.mask_add ? p.mask_add[(size_t)b * Lk + k0 + j]
                       : (p.mask_keep[(size_t)b * Lk + k0 + j] != 0 ? 0.f : MASKED);
      madd[j] = a;
    }
  };
  __syncthreads();

  // this warp's q fragments: rows warp*16 + g and + 8, four k-steps of 16
  unsigned qa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const bf16* qp = Qs + (warp * 16 + g) * MMA_LD + kk * 16 + 2 * t;
    qa[kk][0] = *reinterpret_cast<const unsigned*>(qp);
    qa[kk][1] = *reinterpret_cast<const unsigned*>(qp + 8 * MMA_LD);
    qa[kk][2] = *reinterpret_cast<const unsigned*>(qp + 8);
    qa[kk][3] = *reinterpret_cast<const unsigned*>(qp + 8 * MMA_LD + 8);
  }
  const int row_lo = q0 + warp * 16 + g;  // s[j][0..1] are row_lo, s[j][2..3] row_lo + 8

  // s[j][e]: key k0 + j*8 + 2t + (e & 1), in the reference's order
  // ((q.k + bias) + mask) + causal; -inf past Lk
  auto scores = [&](int k0, float (&s)[8][4]) {
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bf16* kp = Ks + (j * 8 + g) * MMA_LD + kk * 16 + 2 * t;
        mma_16816(s[j], qa[kk], *reinterpret_cast<const unsigned*>(kp),
                  *reinterpret_cast<const unsigned*>(kp + 8));
      }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row_lo + (e >> 1) * 8;
      const float* bias_row = bias_h + (size_t)(row < Lq ? row : Lq - 1) * Lk;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kl = j * 8 + 2 * t + (e & 1), key = k0 + kl;
        if (key < Lk) {
          float v = s[j][e] + __ldg(bias_row + key);
          v += madd[kl];
          if (p.causal) v += key <= row ? 0.f : MASKED;
          s[j][e] = v;
        } else {
          s[j][e] = -INFINITY;
        }
      }
    }
  };

  // ---- pass 1: row maximum m and sum l of exp(s - m), rows row_lo and + 8 ----
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int k0 = 0; k0 < Lk; k0 += KT) {
    __syncthreads();
    stage(k0, false);
    __syncthreads();
    float s[8][4];
    scores(k0, s);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) tmax = fmaxf(tmax, fmaxf(s[j][2 * hh], s[j][2 * hh + 1]));
      const float mn = fmaxf(m[hh], quad_max(tmax));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) sum += expf(s[j][2 * hh] - mn) + expf(s[j][2 * hh + 1] - mn);
      l[hh] = l[hh] * expf(m[hh] - mn) + quad_sum(sum);
      m[hh] = mn;
    }
  }

  if (p.row_max != nullptr && t == 0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row_lo + hh * 8;
      if (row < Lq) {
        const size_t at = ((size_t)b * p.H + h) * Lq + row;
        p.row_max[at] = m[hh];
        p.row_sum[at] = l[hh];
      }
    }
  }

  // ---- pass 2: p = round(exp(s - m) / l [dropout]); out += p @ v ----
  float o[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  for (int k0 = 0; k0 < Lk; k0 += KT) {
    __syncthreads();
    stage(k0, true);
    __syncthreads();
    float s[8][4];
    scores(k0, s);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pv = expf(s[j][e] - m[e >> 1]) / l[e >> 1];
        if (p.dropout) {
          const unsigned row = (unsigned)(row_lo + (e >> 1) * 8);
          const unsigned key = (unsigned)(k0 + j * 8 + 2 * t + (e & 1));
          const unsigned counter =
              (((unsigned)b * (unsigned)p.H + (unsigned)h) * (unsigned)Lq + row) * (unsigned)Lk + key;
          pv = (keep_bit(counter, p.seed_mix, p.keep_thresh) ? pv : 0.f) * p.keep_scale;
        }
        s[j][e] = pv;
      }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // 16 keys: score tiles 2kk and 2kk + 1
      const unsigned pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int jn = 0; jn < 8; ++jn) {
        const bf16* vp = Vt + (jn * 8 + g) * MMA_LD + kk * 16 + 2 * t;
        mma_16816(o[jn], pa, *reinterpret_cast<const unsigned*>(vp), *reinterpret_cast<const unsigned*>(vp + 8));
      }
    }
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row_lo + hh * 8;
    if (row >= Lq) continue;
#pragma unroll
    for (int jn = 0; jn < 8; ++jn)
      *reinterpret_cast<unsigned*>(p.out + qbase + (size_t)row * MMA_DK + jn * 8 + 2 * t) =
          pack_bf16(o[jn][2 * hh], o[jn][2 * hh + 1]);
  }
}

// One block per (query tile, head, batch row), query tiles fastest so that
// the blocks sharing one head's keys and values run close together.
template <typename T>
__global__ void __launch_bounds__(THREADS, 2) attention_kernel(Params<T> p) {
  extern __shared__ float4 attn_smem4[];
  const int q_tiles = (p.Lq + QT - 1) / QT;
  const int qt = blockIdx.x % q_tiles;
  const int bh = blockIdx.x / q_tiles;
  attention_tile<T>(p, bh / p.H, bh % p.H, qt * QT, reinterpret_cast<float*>(attn_smem4));
}

__global__ void __launch_bounds__(MMA_THREADS) attention_mma_kernel(Params<__nv_bfloat16> p) {
  const int q_tiles = (p.Lq + QT - 1) / QT;
  const int qt = blockIdx.x % q_tiles;
  const int bh = blockIdx.x / q_tiles;
  attention_tile_mma(p, bh / p.H, bh % p.H, qt * QT);
}

inline bool use_mma(const Params<float>&) { return false; }
inline bool use_mma(const Params<__nv_bfloat16>& p) { return p.dk == MMA_DK; }
inline void launch_mma(const Params<float>&, unsigned, cudaStream_t) {}
inline void launch_mma(const Params<__nv_bfloat16>& p, unsigned blocks, cudaStream_t stream) {
  attention_mma_kernel<<<blocks, MMA_THREADS, 0, stream>>>(p);
}

// Launches on `stream`; returns the launch's cudaError_t. The host wrapper
// checks dk (a multiple of 4, at most MAX_DK) and the block count.
template <typename T> cudaError_t launch_attention(const Params<T>& p, cudaStream_t stream) {
  if (p.dk % 4 || p.dk > MAX_DK || p.dk < 4 || p.Lq < 1 || p.Lk < 1) return cudaErrorInvalidValue;
  const long long blocks = (long long)((p.Lq + QT - 1) / QT) * p.H * p.B;
  if (blocks < 1 || blocks > 2147483647LL) return cudaErrorInvalidValue;
  if (use_mma(p)) {
    launch_mma(p, (unsigned)blocks, stream);
    return cudaGetLastError();
  }
  const size_t smem = (size_t)smem_floats(p.dk) * sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  attention_kernel<T><<<(unsigned)blocks, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace attn
