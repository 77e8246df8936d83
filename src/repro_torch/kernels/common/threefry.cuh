// threefry2x32 (20 rounds) as jax.random computes it in partitionable mode,
// shared by the port's kernels that draw from a round key in-kernel:
//
//   threefry2x32(k0, k1, x0, x1)  -> (y0, y1), the raw hash;
//   threefry_bits(k0, k1, i)      -> y0 ^ y1 of the counter (i >> 32, i):
//                                    element i of jax.random.bits(key, (n,));
//   fold_in(k0, k1, data)         -> the key jax.random.fold_in(key, data),
//                                    i.e. (y0, y1) of the counter (0, data).
//
// repro_torch/random.py is the same hash in int64 tensor ops; the CPU tests
// pin that one to jax.random key for key.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace threefry {

__device__ __forceinline__ void mix(uint32_t& x0, uint32_t& x1, int r) {
  x0 += x1;
  x1 = ((x1 << r) | (x1 >> (32 - r))) ^ x0;
}

__device__ __forceinline__ uint2 threefry2x32(uint32_t k0, uint32_t k1,
                                              uint32_t x0, uint32_t x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  mix(x0, x1, 13); mix(x0, x1, 15); mix(x0, x1, 26); mix(x0, x1, 6);
  x0 += k1; x1 += k2 + 1u;
  mix(x0, x1, 17); mix(x0, x1, 29); mix(x0, x1, 16); mix(x0, x1, 24);
  x0 += k2; x1 += k0 + 2u;
  mix(x0, x1, 13); mix(x0, x1, 15); mix(x0, x1, 26); mix(x0, x1, 6);
  x0 += k0; x1 += k1 + 3u;
  mix(x0, x1, 17); mix(x0, x1, 29); mix(x0, x1, 16); mix(x0, x1, 24);
  x0 += k1; x1 += k2 + 4u;
  mix(x0, x1, 13); mix(x0, x1, 15); mix(x0, x1, 26); mix(x0, x1, 6);
  x0 += k2; x1 += k0 + 5u;
  return make_uint2(x0, x1);
}

__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1,
                                                  uint64_t i) {
  const uint2 y = threefry2x32(k0, k1, static_cast<uint32_t>(i >> 32),
                               static_cast<uint32_t>(i));
  return y.x ^ y.y;
}

__device__ __forceinline__ uint2 fold_in(uint32_t k0, uint32_t k1,
                                         uint32_t data) {
  return threefry2x32(k0, k1, 0u, data);
}

}  // namespace threefry
