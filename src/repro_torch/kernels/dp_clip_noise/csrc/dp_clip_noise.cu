// Hopper (sm_90a) kernels of the async-DP round, bound to Python with
// ctypes (plain C entry points; pointers and the stream arrive as void*).
//
// dp_round  replaces src/repro/kernels/dp_clip_noise/kernel.py:
//           _dp_round_kernel / dp_round_2d. One pass over the (P,) flat
//           buffer: q = acc*gain + ns*Laplace(bits) (eq. 4), g_reg = sigma*tb,
//           new_i = clip(tb - lr_own*(g_reg/(2N) + w*q)) (eq. 5),
//           new_L = clip(tb - lr_L*g_reg) (eq. 7). The uint32 bits are NOT
//           read from memory: each element hashes its own 64-bit index with
//           threefry2x32 exactly as repro_torch.random.bits(key, (P,)) (and
//           jax.random.bits in partitionable mode) does, so no P-word bits
//           array is written or read per round; the inverse CDF is
//           common/laplace.cuh, shared with tree_delta. Bound: bytes, 16 B/element
//           (read tb and acc, write both outputs); the hash adds ~100 integer
//           operations per element on top.
// scale_noise replaces src/repro/kernels/dp_clip_noise/kernel.py:
//           _scale_noise_kernel / scale_noise_2d. One pass over one contiguous
//           f32 leaf of a gradient tree: out = g*cs + ns*Laplace(bits), the
//           clip (or group-mean) scale and the noise add of eq. 4 for the
//           pytree privatizer. The bits are the leaf key's
//           repro_torch.random.bits(key, (n,)) words, hashed per element as
//           in dp_round; the reference's oracle draws the same words at the
//           unpadded shape (and, in partitionable mode, its padded draw
//           starts with them). Bound: bytes, 8 B/element (read g, write out).
//           Design: a grid-stride loop of one float4 per thread per step
//           where g and out are 16-byte aligned, one element per step on the
//           tail and on an unaligned view; each step loads g first and then
//           hashes, so the load is in flight during the ~100 integer
//           operations of the hash (the order that took tree_delta at r = 0
//           to 51% of its bound); streaming loads and stores (__ldcs /
//           __stcs), since a leaf is touched once.
// sqnorm    replaces src/repro/kernels/dp_clip_noise/kernel.py:
//           _sqnorm_kernel / sqnorm_2d. Deterministic two-pass sum of g*g:
//           pass 1 writes one partial per block of a grid that depends only on
//           P, pass 2 is one block that sums the partials in a fixed order.
//           No atomics, so the same input gives the same bits on every run.
//           Bound: bytes, 4 B/element.
//
// All three are simple first versions: grid-stride loops, one element (or one
// float4 for scale_noise and sqnorm) per thread per step, no shared-memory
// staging.
//
// Member axis (the owner-parallel grouped driver, which the reference runs
// under jax.vmap, one grid axis more): dp_round_rows and sqnorm_rows take g
// contiguous rows of P elements, blockIdx.y is the row (member), and row m
// reads its own key, gain, noise scale and weight. A row is computed exactly
// as a single launch on it: dp_round is elementwise and hashes
// threefry(key_m, i) for element i of its row; sqnorm gives every row the
// grid of a single launch over P (the same partials, each summed in the
// same order), and takes the float4 path where the row's own pointer is
// 16-byte aligned, as a single launch on that row decides. So row m of a
// batched launch equals a single launch on row m bit for bit, and a
// member's result does not depend on g. A single row is the launch with
// one row.
//
// Column offset (a rank's slice of a row on a device mesh): dp_round takes
// col0 and hashes threefry(key, col0 + i) for element i, so a launch over
// columns [col0, col0 + n) draws exactly the bits of those columns of the
// unsharded row; col0 = 0 is the unsharded launch.
//
// Block offset (a rank's block of a leaf sharded on one or two dims, with
// a stacked layer dim in front, under the pytree privatizer): scale_noise
// sees its contiguous local block as (A, R, C) and element (a, r, c) hashes
// the counter base + a*SA + r*SR + c, where base is the block's first
// element's flat index in the whole leaf and SA, SR are the global strides
// of the block's merged dims (ops.py's _block_layout merges every run of
// dims whose inner dims the block holds whole, so a leaf sharded on at most
// two dims needs at most three). So the block draws exactly the bits of
// those elements of the unsharded leaf. The whole leaf is the block
// A = R = 1, C = n, base 0: element i hashes i, the whole-leaf launch bit
// for bit, whose loop computes nothing more. A block's loop divides nothing
// either: a thread finds its first element's (a, r, c) once and steps it by
// its grid stride with carries (BlockCursor; the launcher splits the strides
// into (c, r, a) steps once for all threads). Where C is a multiple of 4 a
// float4 never straddles a row, so it takes one counter and its three
// successors; otherwise each of its elements steps the cursor by one.
//
// The per-round scalars (gain or clip scale, noise scale, owner weight) and
// the key are read from device memory, so the caller never syncs with the
// host. The float arithmetic uses the _rn intrinsics op for op in the order
// of ref.py, so no multiply-add is contracted into an FMA the plain version
// does not have.

#include <cstdint>
#include <cuda_runtime.h>

#include "common/laplace.cuh"
#include "common/threefry.cuh"

namespace {

using laplace::from_bits;
using threefry::threefry_bits;

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 4096;
constexpr int kMaxPartials = 1024;
constexpr int kFinalThreads = 1024;
constexpr long long kMaxRows = 65535;   // gridDim.y

__global__ void __launch_bounds__(kThreads)
dp_round_kernel(const float* __restrict__ tb, const float* __restrict__ acc,
                const uint32_t* __restrict__ key, const float* __restrict__ gain,
                const float* __restrict__ ns, const float* __restrict__ w,
                float* __restrict__ out_l, float* __restrict__ out_i, int64_t n,
                int64_t col0, float sigma, float lr_own, float lr_l, float inv_2n,
                float theta_max) {
  // row blockIdx.y: its own buffers, key and scalars
  const int64_t m = blockIdx.y;
  tb += m * n;
  acc += m * n;
  out_l += m * n;
  out_i += m * n;
  const uint32_t k0 = key[2 * m];
  const uint32_t k1 = key[2 * m + 1];
  const float g = gain[m];
  const float s = ns[m];
  const float wv = w[m];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    const float lap = from_bits(
        threefry_bits(k0, k1, static_cast<uint64_t>(i + col0)));
    const float t = tb[i];
    const float q = __fadd_rn(__fmul_rn(acc[i], g), __fmul_rn(s, lap));
    const float g_reg = __fmul_rn(sigma, t);
    const float step_i = __fmul_rn(
        lr_own, __fadd_rn(__fmul_rn(g_reg, inv_2n), __fmul_rn(wv, q)));
    const float new_i = __fsub_rn(t, step_i);
    const float new_l = __fsub_rn(t, __fmul_rn(lr_l, g_reg));
    out_i[i] = fminf(fmaxf(new_i, -theta_max), theta_max);
    out_l[i] = fminf(fmaxf(new_l, -theta_max), theta_max);
  }
}

__device__ __forceinline__ float scale_noise_one(float g, float cs, float s,
                                                uint32_t k0, uint32_t k1, uint64_t ctr) {
  const float lap = from_bits(threefry_bits(k0, k1, ctr));
  return __fadd_rn(__fmul_rn(g, cs), __fmul_rn(s, lap));
}

// The counter of element i of an (A, R, C) block (see "Block offset"), and
// the (c, r, a) steps of one element and of the grid strides (element and
// float4 loops), which the launcher computes once for every thread.
struct Step {
  int64_t c, r, a;
};

struct BlockLayout {
  int64_t base, R, C, SR, SA;
  Step one, stride, stride4;
};

// The position (c, r, a) of one element of an (A, R, C) block. A thread
// finds its first element's once, then follows its grid-stride loop by
// adding the stride's (c, r, a) with carries, so the loop divides nothing.
struct BlockCursor {
  int64_t c, r, a;
  __device__ __forceinline__ BlockCursor(const BlockLayout& lay, int64_t i) {
    const int64_t t = i / lay.C;
    c = i - t * lay.C;
    r = t % lay.R;
    a = t / lay.R;
  }
  __device__ __forceinline__ uint64_t counter(const BlockLayout& lay) const {
    return static_cast<uint64_t>(lay.base + a * lay.SA + r * lay.SR + c);
  }
  // move on by d (d.c < C and d.r < R)
  __device__ __forceinline__ void advance(const BlockLayout& lay, const Step& d) {
    c += d.c;
    if (c >= lay.C) { c -= lay.C; ++r; }
    r += d.r;
    if (r >= lay.R) { r -= lay.R; ++a; }
    a += d.a;
  }
};

// kFlat: the whole leaf, or a block that is one range of it (the caller
// merges such a block into C = n): element i hashes base + i, and the loop
// is the whole-leaf loop with nothing more. Otherwise the cursor path,
// which on whole leaves takes 15% longer (the 12 DENSE_124M leaves: 0.800
// against 0.696 ms on an H100 80GB HBM3 at 700 W, tools/scale_noise_ms.py).
template <bool kFlat>
__global__ void __launch_bounds__(kThreads)
scale_noise_kernel(const float* __restrict__ g, const uint32_t* __restrict__ key,
                   const float* __restrict__ cs_ptr, const float* __restrict__ ns,
                   float* __restrict__ out, int64_t n, int vec, BlockLayout lay) {
  const uint32_t k0 = key[0];
  const uint32_t k1 = key[1];
  const float cs = *cs_ptr;
  const float s = *ns;
  const int64_t start = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  int64_t tail = 0;
  if (vec) {
    const int64_t n4 = n >> 2;
    const float4* g4 = reinterpret_cast<const float4*>(g);
    float4* out4 = reinterpret_cast<float4*>(out);
    if constexpr (kFlat) {
      for (int64_t j = start; j < n4; j += stride) {
        const float4 v = __ldcs(g4 + j);
        const uint64_t c0 = static_cast<uint64_t>(lay.base + (j << 2));
        __stcs(out4 + j, make_float4(scale_noise_one(v.x, cs, s, k0, k1, c0),
                                     scale_noise_one(v.y, cs, s, k0, k1, c0 + 1),
                                     scale_noise_one(v.z, cs, s, k0, k1, c0 + 2),
                                     scale_noise_one(v.w, cs, s, k0, k1, c0 + 3)));
      }
    } else if (start < n4) {
      // a float4 within a row (C a multiple of 4) takes one counter and its
      // successors; otherwise each element steps the cursor by one
      const bool rows4 = (lay.C & 3) == 0;
      BlockCursor cur(lay, start << 2);
      for (int64_t j = start; j < n4; j += stride) {
        const float4 v = __ldcs(g4 + j);
        uint64_t c[4];
        if (rows4) {
          c[0] = cur.counter(lay);
          c[1] = c[0] + 1; c[2] = c[0] + 2; c[3] = c[0] + 3;
        } else {
          BlockCursor e = cur;
          for (int q = 0; q < 4; ++q) {
            c[q] = e.counter(lay);
            e.advance(lay, lay.one);
          }
        }
        __stcs(out4 + j, make_float4(scale_noise_one(v.x, cs, s, k0, k1, c[0]),
                                     scale_noise_one(v.y, cs, s, k0, k1, c[1]),
                                     scale_noise_one(v.z, cs, s, k0, k1, c[2]),
                                     scale_noise_one(v.w, cs, s, k0, k1, c[3])));
        cur.advance(lay, lay.stride4);
      }
    }
    tail = n4 << 2;
  }
  if constexpr (kFlat) {
    for (int64_t i = tail + start; i < n; i += stride) {
      __stcs(out + i, scale_noise_one(__ldcs(g + i), cs, s, k0, k1,
                                      static_cast<uint64_t>(lay.base + i)));
    }
  } else if (tail + start < n) {
    BlockCursor cur(lay, tail + start);
    for (int64_t i = tail + start; i < n; i += stride) {
      __stcs(out + i, scale_noise_one(__ldcs(g + i), cs, s, k0, k1, cur.counter(lay)));
      cur.advance(lay, lay.stride);
    }
  }
}

// Sum over the block in a fixed order (warp shuffles, then warp 0);
// the result is valid in thread 0.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < static_cast<int>(blockDim.x >> 5) ? warp_sums[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
sqnorm_partial_kernel(const float* __restrict__ g, int64_t n,
                      float* __restrict__ partial) {
  // row blockIdx.y: its elements, its gridDim.x partials; the float4 path
  // where the row's own pointer allows it, as a launch on that row alone
  g += static_cast<int64_t>(blockIdx.y) * n;
  partial += static_cast<int64_t>(blockIdx.y) * gridDim.x;
  const int vec = (reinterpret_cast<uintptr_t>(g) & 15u) == 0;
  float acc = 0.f;
  const int64_t start = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  int64_t tail = 0;
  if (vec) {
    const int64_t n4 = n >> 2;
    const float4* g4 = reinterpret_cast<const float4*>(g);
    for (int64_t i = start; i < n4; i += stride) {
      const float4 v = g4[i];
      acc = fmaf(v.x, v.x, acc);
      acc = fmaf(v.y, v.y, acc);
      acc = fmaf(v.z, v.z, acc);
      acc = fmaf(v.w, v.w, acc);
    }
    tail = n4 << 2;
  }
  for (int64_t i = tail + start; i < n; i += stride) {
    const float v = g[i];
    acc = fmaf(v, v, acc);
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) partial[blockIdx.x] = acc;
}

__global__ void __launch_bounds__(kFinalThreads)
sqnorm_final_kernel(const float* __restrict__ partial, int nparts,
                    float* __restrict__ out) {
  // one block per row
  partial += static_cast<int64_t>(blockIdx.x) * nparts;
  float acc = 0.f;
  for (int i = threadIdx.x; i < nparts; i += kFinalThreads) acc += partial[i];
  acc = block_sum(acc);
  if (threadIdx.x == 0) out[blockIdx.x] = acc;
}

}  // namespace

extern "C" {

// rows x n elements, row m with key[2m:2m+2], gain[m], ns[m] and w[m];
// element i hashes the counter col0 + i (the columns [col0, col0 + n) of a
// wider row)
int dp_round_rows_launch(const float* tb, const float* acc, const uint32_t* key,
                         const float* gain, const float* ns, const float* w,
                         float* out_l, float* out_i, long long rows, long long n,
                         long long col0, float sigma, float lr_own, float lr_l, float inv_2n,
                         float theta_max, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows > kMaxRows) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0 && rows > 0) {
    long long blocks = (n + kThreads - 1) / kThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    dp_round_kernel<<<dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(rows)),
                      kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        tb, acc, key, gain, ns, w, out_l, out_i, n, col0, sigma, lr_own, lr_l,
        inv_2n, theta_max);
  }
  return static_cast<int>(cudaGetLastError());
}

// n elements of an (A, R, C) block whose element (a, r, c) hashes
// base + a*SA + r*SR + c; the whole leaf is base 0, R 1, C n
int scale_noise_launch(const float* g, const uint32_t* key, const float* cs,
                       const float* ns, float* out, long long n, long long base,
                       long long R, long long C, long long SR, long long SA, int device,
                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0 && (R <= 0 || C <= 0 || n % (R * C) != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    const int vec = (reinterpret_cast<uintptr_t>(g) & 15u) == 0 &&
                    (reinterpret_cast<uintptr_t>(out) & 15u) == 0;
    const long long per_thread = vec ? 4 : 1;
    long long blocks = (n / per_thread + kThreads - 1) / kThreads;
    if (blocks < 1) blocks = 1;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    // the (c, r, a) of a step of d elements, the same for every thread
    const auto step_of = [R, C](long long d) {
      return Step{d % C, (d / C) % R, d / (C * R)};
    };
    const long long stride = blocks * kThreads;
    const BlockLayout lay{base, R, C, SR, SA, step_of(1), step_of(stride), step_of(4 * stride)};
    if (C == n) {
      scale_noise_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(g, key, cs, ns, out,
                                                                      n, vec, lay);
    } else {
      scale_noise_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(g, key, cs, ns, out,
                                                                       n, vec, lay);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// Number of pass-1 partials (the scratch the caller allocates); a function of
// n alone, which is what makes the sum deterministic.
int sqnorm_num_partials(long long n) {
  if (n <= 0) return 0;
  long long parts = (n + 4LL * kThreads - 1) / (4LL * kThreads);
  return static_cast<int>(parts < kMaxPartials ? parts : kMaxPartials);
}

// rows x n elements -> out[rows]; partial holds rows * sqnorm_num_partials(n)
int sqnorm_rows_launch(const float* g, long long rows, long long n, float* partial,
                       float* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows > kMaxRows) return static_cast<int>(cudaErrorInvalidValue);
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int parts = sqnorm_num_partials(n);
  if (parts > 0) {
    sqnorm_partial_kernel<<<dim3(parts, static_cast<unsigned>(rows)), kThreads, 0, s>>>(
        g, n, partial);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  sqnorm_final_kernel<<<static_cast<unsigned>(rows), kFinalThreads, 0, s>>>(partial, parts,
                                                                            out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
