// Hash dropout's masked multiply: y[i] = keep(i) ? round(float(x[i]) * scale) : +0
// at x's dtype (float32 or bf16), one read of x and one write of y, the keep
// bit hashed in registers (hash_core.cuh).
//
// Replaces no Pallas kernel: the JAX package's rqvae_tpu/ops/hash_dropout.py
// builds the mask from jnp operations that XLA fuses into the multiply. Built
// op by op in PyTorch (rqvae_tpu_torch/ops/hash_dropout.py, the plain version)
// the mask takes about 17 elementwise passes over an int32 copy of the site's
// shape, then a `where` and a multiply on the data; this kernel is the whole
// function in one pass.
//
// Bound on the H100: bytes. Each element is read once and written once (2 x
// the element size: 4 bytes in bf16) over 3.35 TB/s; the hash is about 12
// integer operations an element, far below the card's integer rate. So:
// 16-byte vector loads and stores (8 bf16 or 4 float32 elements a thread an
// iteration), a grid-stride loop over a grid sized to the SMs, no shared
// memory and no atomics; the elements past the last whole vector one by one.
//
// The counter of element i (64-bit) is, in wrapping uint32 arithmetic,
//   plain layout:        offset + i
//   rows (w of W):       offset + (i / w) * W + i % w
// (a rank's slice of a global array: its first element at `offset`, and with
// rows its column window of w in every global row of W). The int32 seed is
// read from device memory, so a launch captured in a CUDA graph reads the seed
// its buffer holds at replay; offset, w, W, the threshold and the scale are
// launch arguments.
//
// Exactness against the plain version, where(keep, x, 0) * scale in PyTorch:
// a kept element is float(x) * scale in float32, rounded to bf16 to nearest
// even (PyTorch's bf16-times-scalar); a dropped one is +0 whatever x holds
// (negative, inf or NaN).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hash_core.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;  // 2,048 threads: a full SM

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

struct Args {
  unsigned long long n;  // elements
  const int* seed;       // [1] int32 in device memory
  unsigned offset;       // the counter of element 0
  unsigned w, W;         // rows of w, W apart (ROWS only)
  unsigned thresh;       // keep iff the hash bits >= this
  float scale;           // 1 / (1 - rate) at x's dtype
};

template <bool ROWS>
__device__ __forceinline__ unsigned counter_of(unsigned long long i, const Args& a) {
  if (!ROWS) return a.offset + (unsigned)i;
  return a.offset + (unsigned)(i / a.w) * a.W + (unsigned)(i % a.w);
}

template <typename T>
__device__ __forceinline__ T drop_one(T v, bool keep, float scale) {
  return from_float<T>(keep ? to_float(v) * scale : 0.f);
}

template <typename T, bool ROWS>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
    hash_dropout_kernel(const T* __restrict__ x, T* __restrict__ y, Args a) {
  constexpr int N = 16 / sizeof(T);  // elements a vector
  const unsigned mix = hashdrop::seed_mix_of(a.seed);
  const unsigned long long vectors = a.n / N;
  const unsigned long long first = (unsigned long long)blockIdx.x * THREADS + threadIdx.x;
  const unsigned long long stride = (unsigned long long)gridDim.x * THREADS;
  for (unsigned long long k = first; k < vectors; k += stride) {
    alignas(16) T in[N], out[N];
    *reinterpret_cast<uint4*>(in) = __ldg(reinterpret_cast<const uint4*>(x) + k);
    const unsigned long long i0 = k * N;
    unsigned c = counter_of<ROWS>(i0, a);
    unsigned col = ROWS ? (unsigned)(i0 % a.w) : 0u;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      out[j] = drop_one(in[j], hashdrop::keep_bit(c, mix, a.thresh), a.scale);
      if (ROWS && ++col == a.w) {  // the next global row: W - w + 1 on from the window's last column
        col = 0;
        c += a.W - a.w + 1;
      } else {
        c += 1;
      }
    }
    reinterpret_cast<uint4*>(y)[k] = *reinterpret_cast<const uint4*>(out);
  }
  const unsigned long long i = vectors * N + first;  // the tail, fewer than N elements
  if (i < a.n) y[i] = drop_one(x[i], hashdrop::keep_bit(counter_of<ROWS>(i, a), mix, a.thresh), a.scale);
}

template <typename T>
cudaError_t launch(const void* x, void* y, const Args& a, cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  constexpr int N = 16 / sizeof(T);
  const unsigned long long threads = (a.n + N - 1) / N;
  const unsigned long long want = (threads + THREADS - 1) / THREADS;
  const unsigned blocks = (unsigned)(want < (unsigned long long)sms * BLOCKS_PER_SM ? want : sms * BLOCKS_PER_SM);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (a.w) {
    hash_dropout_kernel<T, true><<<blocks, THREADS, 0, stream>>>(xt, yt, a);
  } else {
    hash_dropout_kernel<T, false><<<blocks, THREADS, 0, stream>>>(xt, yt, a);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// x, y: n > 0 contiguous elements of float32 (is_bf16 = 0) or bf16, 16-byte
// aligned; seed: the device address of the int32 seed (read by the kernel, not
// here); w = 0: the plain layout, else rows of w that lie W apart (1 <= w <= W).
// Keep iff the hash bits >= keep_thresh; kept elements are scaled by keep_scale.
int hash_dropout(int is_bf16, const void* x, void* y, unsigned long long n, const int* seed, unsigned offset,
                 unsigned w, unsigned W, unsigned keep_thresh, float keep_scale, void* stream) {
  const Args a{n, seed, offset, w, W, keep_thresh, keep_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch<__nv_bfloat16>(x, y, a, s) : launch<float>(x, y, a, s));
}

}  // extern "C"
