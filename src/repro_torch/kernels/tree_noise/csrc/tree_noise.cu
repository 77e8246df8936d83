// Hopper (sm_90a) kernel of the DP-FTRL tree mechanism, bound to Python with
// ctypes (plain C entry points; pointers and the stream arrive as void*).
//
// tree_delta replaces src/repro/kernels/tree_noise/kernel.py:
//            _tree_delta_kernel / tree_delta_2d. It advances one owner's
//            binary counter from leaf t to t + 1 over that owner's (depth, P)
//            row of the (N, depth, P) node tensor:
//              zeta  = ns * Laplace(bits)           (the fresh node's draw)
//              delta = zeta - sum of the retired levels
//              retired levels <- 0, the fresh level <- zeta
//            Level l retires iff (t+1) mod 2^(l+1) == 0 and is fresh iff
//            (t+1) mod 2^(l+1) == 2^l. It computes what the reference's
//            oracle computes (ref.tree_delta_ref, the backend off the TPU):
//            the bits are jax.random.bits(key, (P,)) at the unpadded shape,
//            hashed per element with threefry2x32 (no P-word bits array),
//            and the retired levels are summed first, in increasing level
//            order, then subtracted from zeta.
//
// The update is IN PLACE, which is what saves memory: the reference gathers
// the owner's (depth, P) row, builds a new row, masks it and scatters it
// back, three (depth, P) transients (2.44 GB each at depth 4 and P =
// 152,783,616). Here the kernel reads only the r retired levels (r = the
// trailing one bits of t), writes zeros to them, writes the draw to level
// r and writes delta; the untouched levels are never read or written.
// Bound: bytes, (8r + 8) B per element.
//
// The count, the noise scale, the owner index and the grant are read from
// device memory, so the K-round loop never syncs with the host. Which levels
// retire depends only on the count, the same for every thread, so the level
// loop does not diverge. A refused round (grant 0) writes no node but still
// writes delta (the caller's update is masked). The caller bumps the count
// afterwards on the same stream.
//
// Member axis (the owner-parallel grouped driver, which the reference runs
// under jax.vmap): tree_delta_rows advances g owners in one launch,
// blockIdx.y the member m, with its own owner index, key, noise scale and
// grant, writing row m of a (g, P) delta. The owners must be distinct (the
// conflict-free partition's invariant), so no two members touch one node
// row; the kernel assumes it. Each element is computed as in a single
// launch on that owner, so a member's result does not depend on g. One
// owner is the launch with one member.
//
// Paged banks (the paged owner bank keeps n_hot rows resident, and the
// tree's node rows page with them): `slot` (may be null) gives member m's
// node row, its hot slot, apart from its owner index, which still reads
// the per-owner (N,) count. A member whose owner is not resident has
// grant 0, so it writes no node, whatever row its clamped slot names.
//
// Design, in a grid-stride loop of four elements (one float4 per level) per
// thread per step where the row and delta are 16-byte aligned, one element
// per step on the tail, no shared memory: each step first loads the r
// retired levels, then hashes the draw, then stores. Loading first lets the
// threefry hash (about 100 integer operations per element, what bounds
// r = 0) run while the loads are in flight; hashed first, the draw left
// each load's latency exposed. The retired levels are always levels
// 0..r-1 and the fresh one is level r, so the level loops run over r and
// never test a mask. Loads and stores are streaming (__ldcs / __stcs): a
// row is touched once per round.

#include <cstdint>
#include <cuda_runtime.h>

#include "common/laplace.cuh"
#include "common/threefry.cuh"

namespace {

using laplace::from_bits;
using threefry::threefry_bits;

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 4096;
constexpr long long kMaxRows = 65535;   // gridDim.y

__device__ __forceinline__ float draw(float s, uint32_t k0, uint32_t k1, int64_t i) {
  return __fmul_rn(s, from_bits(threefry_bits(k0, k1, static_cast<uint64_t>(i))));
}

__device__ __forceinline__ float4 sub4(float4 z, float4 sum) {
  return make_float4(__fsub_rn(z.x, sum.x), __fsub_rn(z.y, sum.y),
                     __fsub_rn(z.z, sum.z), __fsub_rn(z.w, sum.w));
}

__global__ void __launch_bounds__(kThreads)
tree_delta_kernel(float* __restrict__ nodes, const int32_t* __restrict__ counts,
                  const int64_t* __restrict__ owner, const int64_t* __restrict__ slot,
                  const uint32_t* __restrict__ key,
                  const float* __restrict__ ns, const int32_t* __restrict__ grant,
                  float* __restrict__ delta, int64_t n, int64_t col0, int depth,
                  int vec) {
  // member blockIdx.y: its owner, node row, key, scale, grant and delta row
  const int64_t m = blockIdx.y;
  const int64_t o = owner[m];
  const int64_t ro = slot != nullptr ? slot[m] : o;
  key += 2 * m;
  ns += m;
  if (grant != nullptr) grant += m;
  delta += m * n;
  const int64_t t1 = static_cast<int64_t>(counts[o]) + 1;
  // level l retires iff (t+1) mod 2^(l+1) == 0 (a prefix 0..r-1 of the
  // levels) and is fresh iff (t+1) mod 2^(l+1) == 2^l (level r, if any)
  int r = 0, fresh = -1;
  for (int l = 0; l < depth; ++l) {
    const int64_t pw = int64_t{1} << (l + 1);
    int64_t rem = t1 % pw;
    if (rem < 0) rem += pw;                     // torch.remainder's sign
    if (rem == 0) r = l + 1;
    if (rem == (int64_t{1} << l)) fresh = l;
  }
  const bool write = grant == nullptr || *grant != 0;
  if (!write) fresh = -1;                       // refused: delta only
  const uint32_t k0 = key[0];
  const uint32_t k1 = key[1];
  const float s = *ns;
  float* row = nodes + ro * depth * n;
  const int64_t start = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  int64_t tail = 0;
  if (vec) {
    const int64_t n4 = n >> 2;
    float4* row4 = reinterpret_cast<float4*>(row);
    float4* delta4 = reinterpret_cast<float4*>(delta);
    const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int64_t j = start; j < n4; j += stride) {
      float4 sum = zero4;
#pragma unroll 4
      for (int l = 0; l < r; ++l) {
        const float4 v = __ldcs(row4 + l * n4 + j);
        sum.x = __fadd_rn(sum.x, v.x);
        sum.y = __fadd_rn(sum.y, v.y);
        sum.z = __fadd_rn(sum.z, v.z);
        sum.w = __fadd_rn(sum.w, v.w);
      }
      const int64_t i = (j << 2) + col0;
      const float4 z = make_float4(draw(s, k0, k1, i), draw(s, k0, k1, i + 1),
                                   draw(s, k0, k1, i + 2), draw(s, k0, k1, i + 3));
      if (write) {
#pragma unroll 4
        for (int l = 0; l < r; ++l) __stcs(row4 + l * n4 + j, zero4);
      }
      if (fresh >= 0) __stcs(row4 + fresh * n4 + j, z);
      __stcs(delta4 + j, sub4(z, sum));
    }
    tail = n4 << 2;
  }
  for (int64_t i = tail + start; i < n; i += stride) {
    float sum = 0.f;
    for (int l = 0; l < r; ++l) sum = __fadd_rn(sum, __ldcs(row + l * n + i));
    const float z = draw(s, k0, k1, i + col0);
    if (write) {
      for (int l = 0; l < r; ++l) __stcs(row + l * n + i, 0.f);
    }
    if (fresh >= 0) __stcs(row + fresh * n + i, z);
    __stcs(delta + i, __fsub_rn(z, sum));
  }
}

}  // namespace

extern "C" {

// rows members: owner[m], node row slot[m] (slot may be null: the owner's
// own row), key[2m:2m+2], ns[m], grant[m] (grant may be null: all granted),
// delta row m of rows x n; element i draws the counter col0 + i (the columns
// [col0, col0 + n) of a wider row)
int tree_delta_rows_launch(float* nodes, const int32_t* counts, const int64_t* owner,
                           const int64_t* slot, const uint32_t* key, const float* ns,
                           const int32_t* grant, float* delta, long long rows, long long n,
                           long long col0, int depth,
                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows > kMaxRows) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0 && rows > 0) {
    const int vec = n % 4 == 0 && (reinterpret_cast<uintptr_t>(nodes) & 15u) == 0 &&
                    (reinterpret_cast<uintptr_t>(delta) & 15u) == 0;
    const long long per_thread = vec ? 4 : 1;
    long long blocks = (n / per_thread + kThreads - 1) / kThreads;
    if (blocks < 1) blocks = 1;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    tree_delta_kernel<<<dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(rows)),
                        kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        nodes, counts, owner, slot, key, ns, grant, delta, n, col0, depth, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
