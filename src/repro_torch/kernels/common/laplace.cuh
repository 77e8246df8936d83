// The Laplace(0, 1) inverse CDF shared by the port's kernels that turn a
// uint32 word into a noise draw (dp_round, tree_delta): the top 24 bits as
// a uniform in [0, 1), centred, clipped to +-0.4999999, then
// -sign(v) * log1p(-2|v|), with sign(0) = 0 as jnp.sign. The float
// arithmetic uses the _rn intrinsics in the op order of
// dp_clip_noise/ref.py::laplace_from_bits_ref, so no multiply-add is
// contracted into an FMA the plain version does not have.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace laplace {

__device__ __forceinline__ float from_bits(uint32_t b) {
  const float lim = static_cast<float>(0.4999999);
  const float u01 = __fmul_rn(__uint2float_rn(b >> 8), 5.9604644775390625e-08f);
  const float v = __fsub_rn(u01, 0.5f);
  const float vc = fminf(fmaxf(v, -lim), lim);
  const float neg_sign = v > 0.f ? -1.f : (v < 0.f ? 1.f : -0.f);
  return __fmul_rn(neg_sign, log1pf(__fmul_rn(-2.0f, fabsf(vc))));
}

}  // namespace laplace
