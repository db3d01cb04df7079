// The counter-hash dropout keep bit, shared by the attention kernels
// (attention_core.cuh, attention_bwd.cu) and the hash-dropout kernel
// (hash_dropout.cu): the murmur3 finaliser of a wrapping uint32 counter XOR
// seed * 0x9E3779B9, kept iff the bits >= round(rate * 2^32). The bits are
// those of rqvae_tpu/ops/hash_dropout.py::hash_keep_bits and of the plain
// versions in rqvae_tpu_torch/ops/hash_dropout.py.

#pragma once

#include <cuda_runtime.h>

namespace hashdrop {

// seed * 0x9E3779B9 (wrapping) of the int32 seed at `seed`
__device__ __forceinline__ unsigned seed_mix_of(const int* seed) { return (unsigned)__ldg(seed) * 0x9E3779B9u; }

__device__ __forceinline__ bool keep_bit(unsigned counter, unsigned seed_mix, unsigned thresh) {
  unsigned x = counter ^ seed_mix;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x >= thresh;
}

}  // namespace hashdrop
