// Hopper (sm_90a) kernels of the quantized owner bank (int8 / fp8 rows with
// one f32 scale each), bound to Python with ctypes (plain C entry points;
// pointers and the stream arrive as void*).
//
// absmax  replaces src/repro/kernels/bank_codec/kernel.py: _absmax_kernel /
//         absmax_2d and row_scale_2d. Deterministic two-pass max|x|, like
//         sqnorm: pass 1 writes one partial per block of a grid that depends
//         only on n, pass 2 is one block that reduces the partials and
//         writes scale = max(absmax, 1e-30) / qmax to a device scalar, so
//         the caller never syncs with the host. NaN propagates as in
//         jnp.max and torch.amax (fmaxf would drop it). Bound: bytes,
//         4 B/element.
// encode  replaces kernel.py: _encode_kernel / encode_2d. One pass: reads x
//         and the device scale, writes the 1-byte code and the error row
//         err = x - decode(code) * scale (the error-feedback residual).
//         int8: q = clip(floor(x/scale + u), -127, 127). fp8: stochastic
//         rounding on the e4m3fn grid between the two neighbouring bit
//         patterns, stored as the raw uint8 pattern (ref.fp8_sr); Hopper's
//         cvt to e4m3 rounds to nearest, so the grid walk is done on the
//         f32 bit fields instead. The rounding bits u are NOT read from
//         memory: each element hashes its own index with the counter hash
//         of ref.counter_bits, seeded by bits(fold_in(key, salt), ()) with
//         the caller's ref.CODEC_SALT, which every thread derives from the
//         round key's device pointer (two threefry hashes, no launch of its
//         own); a slice of a row (a rank's columns on a device mesh)
//         passes col0 and hashes col0 + i. `deterministic`
//         takes u = 0.5 exactly (ref.det_bits). Bound: bytes, 9 B/element
//         (read 4, write 1 + 4).
// decode  replaces kernel.py: _decode_kernel / decode_2d. code * scale;
//         fp8 patterns decode from their bit fields, exactly as
//         ref._fp8_decode_mag. Bound: bytes, 5 B/element.
//
// Simple first versions: grid-stride loops, one element per thread per
// step (one float4 for absmax), no shared-memory staging. Division and the
// error row use the _rn intrinsics in the plain version's op order, so nvcc
// contracts nothing into an FMA that ref.py does not have.

#include <cstdint>
#include <cuda_runtime.h>

#include "common/threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 4096;
constexpr int kMaxPartials = 1024;
constexpr int kFinalThreads = 1024;
constexpr float kTiny = 1e-30f;          // scale floor: a zero row decodes to 0
constexpr float kInt8Max = 127.f;
constexpr float kFp8Max = 448.f;         // largest finite float8_e4m3fn

// max that keeps a NaN from either side, as jnp.max / torch.amax
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a >= b) ? a : b;
}

// clip to [lo, hi] that keeps NaN, as jnp.clip / torch.clamp
__device__ __forceinline__ float nan_clip(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

// Max over the block in a fixed order (warp shuffles, then warp 0); the
// result is valid in thread 0. |x| >= 0, so 0 is the identity.
__device__ __forceinline__ float block_max(float v) {
  __shared__ float warp_max[32];
  for (int o = 16; o > 0; o >>= 1) v = nan_max(v, __shfl_down_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < static_cast<int>(blockDim.x >> 5) ? warp_max[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) v = nan_max(v, __shfl_down_sync(0xffffffffu, v, o));
  }
  return v;
}

// ref.counter_bits: murmur3's fmix32 of (index * golden ratio + seed)
__device__ __forceinline__ uint32_t counter_bits(uint32_t seed, uint32_t i) {
  uint32_t x = i * 0x9E3779B9u + seed;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// ref.u01_from_bits: the top 24 bits as a float in [0, 1), exactly
__device__ __forceinline__ float u01(uint32_t b) {
  return __fmul_rn(__uint2float_rn(b >> 8), 5.9604644775390625e-08f);
}

// ref._fp8_decode_mag: |value| of an e4m3fn magnitude pattern (0..0x7F);
// normal (8 + m) * 2^(e - 10), subnormal m * 2^-9. Both products are exact.
__device__ __forceinline__ float fp8_decode_mag(uint32_t b) {
  const int e = static_cast<int>(b >> 3);
  const int m = static_cast<int>(b & 7u);
  if (e > 0) return __fmul_rn(__int2float_rn(8 + m), __int_as_float((e + 117) << 23));
  return __fmul_rn(__int2float_rn(m), 0.001953125f);
}

// ref._fp8_floor_bits: the largest e4m3fn magnitude pattern <= a, for a in
// [0, 448]: floor(a * 2^9) below 2^-6, else the f32 exponent and the top
// three mantissa bits (truncation is floor for a >= 0).
__device__ __forceinline__ uint32_t fp8_floor_bits(float a) {
  if (a < 0.015625f) return static_cast<uint32_t>(floorf(__fmul_rn(a, 512.f))) & 0xFFu;
  const int ab = __float_as_int(a);
  const int e = ((ab >> 23) & 0xFF) - 120;
  const int m = (ab >> 20) & 7;
  return static_cast<uint32_t>((e << 3) | m) & 0xFFu;
}

__global__ void __launch_bounds__(kThreads)
absmax_partial_kernel(const float* __restrict__ x, int64_t n, int vec,
                      float* __restrict__ partial) {
  float m = 0.f;
  const int64_t start = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  int64_t tail = 0;
  if (vec) {
    const int64_t n4 = n >> 2;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    for (int64_t i = start; i < n4; i += stride) {
      const float4 v = x4[i];
      m = nan_max(m, fabsf(v.x));
      m = nan_max(m, fabsf(v.y));
      m = nan_max(m, fabsf(v.z));
      m = nan_max(m, fabsf(v.w));
    }
    tail = n4 << 2;
  }
  for (int64_t i = tail + start; i < n; i += stride) m = nan_max(m, fabsf(x[i]));
  m = block_max(m);
  if (threadIdx.x == 0) partial[blockIdx.x] = m;
}

__global__ void __launch_bounds__(kFinalThreads)
absmax_final_kernel(const float* __restrict__ partial, int nparts, float qmax,
                    float* __restrict__ scale) {
  float m = 0.f;
  for (int i = threadIdx.x; i < nparts; i += kFinalThreads) m = nan_max(m, partial[i]);
  m = block_max(m);
  if (threadIdx.x == 0) *scale = __fdiv_rn(nan_max(m, kTiny), qmax);
}

__global__ void __launch_bounds__(kThreads)
encode_kernel(const float* __restrict__ x, const float* __restrict__ scale,
              const uint32_t* __restrict__ key, uint32_t salt, int deterministic,
              int fp8, uint8_t* __restrict__ codes, float* __restrict__ err, int64_t n,
              int64_t col0) {
  const float s = *scale;
  uint32_t seed = 0;
  if (!deterministic) {
    const uint2 folded = threefry::fold_in(key[0], key[1], salt);
    seed = threefry::threefry_bits(folded.x, folded.y, 0);  // bits(fold_in(key, salt), ())
  }
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    const float u =
        deterministic ? 0.5f : u01(counter_bits(seed, static_cast<uint32_t>(i + col0)));
    const float xi = x[i];
    if (fp8) {
      const float y = nan_clip(__fdiv_rn(xi, s), -kFp8Max, kFp8Max);
      const float a = fabsf(y);
      const uint32_t lo8 = fp8_floor_bits(a);
      const uint32_t hi8 = lo8 + 1u;
      const float lo = fp8_decode_mag(lo8);
      const float hi = fp8_decode_mag(hi8);
      const float p = a > lo ? __fdiv_rn(__fsub_rn(a, lo), __fsub_rn(hi, lo)) : 0.f;
      const bool up = u < p;
      const bool neg = y < 0.f;
      const float mag = up ? hi : lo;
      const uint32_t out8 = up ? hi8 : lo8;
      codes[i] = static_cast<uint8_t>(neg ? (out8 | 0x80u) : out8);
      err[i] = __fsub_rn(xi, __fmul_rn(neg ? -mag : mag, s));
    } else {
      const float q = nan_clip(floorf(__fadd_rn(__fdiv_rn(xi, s), u)), -kInt8Max, kInt8Max);
      codes[i] = static_cast<uint8_t>(static_cast<int8_t>(static_cast<int>(q)));
      err[i] = __fsub_rn(xi, __fmul_rn(q, s));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
decode_kernel(const uint8_t* __restrict__ codes, const float* __restrict__ scale,
              int fp8, float* __restrict__ out, int64_t n) {
  const float s = *scale;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    const uint32_t c = codes[i];
    float v;
    if (fp8) {
      const float mag = fp8_decode_mag(c & 0x7Fu);
      v = (c & 0x80u) ? -mag : mag;
    } else {
      v = __int2float_rn(static_cast<int8_t>(c));
    }
    out[i] = __fmul_rn(v, s);
  }
}

unsigned grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks > kMaxBlocks ? kMaxBlocks : blocks);
}

}  // namespace

extern "C" {

// Number of absmax pass-1 partials (the scratch the caller allocates); a
// function of n alone.
int bank_absmax_num_partials(long long n) {
  if (n <= 0) return 0;
  long long parts = (n + 4LL * kThreads - 1) / (4LL * kThreads);
  return static_cast<int>(parts < kMaxPartials ? parts : kMaxPartials);
}

int bank_absmax_launch(const float* x, long long n, float qmax, float* partial,
                       float* scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int parts = bank_absmax_num_partials(n);
  if (parts > 0) {
    const int vec = (reinterpret_cast<uintptr_t>(x) & 15u) == 0;
    absmax_partial_kernel<<<parts, kThreads, 0, s>>>(x, n, vec, partial);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  absmax_final_kernel<<<1, kFinalThreads, 0, s>>>(partial, parts, qmax, scale);
  return static_cast<int>(cudaGetLastError());
}

// element i rounds with the counter col0 + i (the columns [col0, col0 + n)
// of a wider row)
int bank_encode_launch(const float* x, const float* scale, const uint32_t* key,
                       unsigned salt, int deterministic, int fp8, void* codes,
                       float* err_row, long long n, long long col0, int device,
                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    encode_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        x, scale, key, salt, deterministic, fp8,
        static_cast<uint8_t*>(codes), err_row, n, col0);
  }
  return static_cast<int>(cudaGetLastError());
}

int bank_decode_launch(const void* codes, const float* scale, int fp8, float* out,
                       long long n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    decode_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(codes), scale, fp8, out, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
