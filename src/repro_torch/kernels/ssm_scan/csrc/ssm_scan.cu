// Hopper (sm_90a) kernel of the intra-chunk SSD contraction (Mamba2, mLSTM),
// bound to Python with ctypes (plain C entry point; pointers and the stream
// arrive as void*).
//
// ssd_chunk_scan replaces src/repro/kernels/ssm_scan/kernel.py:
//            _ssd_chunk_kernel / ssd_chunk_scan. Per (batch, head, chunk of
//            Q positions) it computes
//              cum     = inclusive cumsum of the log-decay ld     (Q,)
//              tot     = cum[Q - 1]
//              y_intra = tril((q k^T) * exp(cum_i - cum_j)) @ (g v)   (Q, P)
//              h_add   = (k * exp(tot - cum) * g)^T @ v              (N, P)
//            in f32. The recurrence between chunks and the product of the
//            decayed queries with the carried state stay torch ops in
//            ops.py, as the reference leaves them to XLA.
//
// Why it is not the TPU kernel block by block: that kernel holds Q x Q +
// Q x N + Q x P f32 in VMEM, about 0.5 MB at Q = 256 and N = P = 64, more
// than a block's 227 KB of shared memory. Here the rows i are tiled 64 at
// a time and, for each, the key tiles j walk up to the diagonal only: the
// upper triangle, which the TPU kernel computes and masks, is skipped. In
// the diagonal tile the mask comes before exp (above the diagonal
// cum_i - cum_j is positive and overflows f32). cum is computed once per
// chunk, a warp scan over Q in shared memory.
//
// Layout: q, k (B, S, H, N) and v (B, S, H, P), ld and g (B, S, H), read
// through their strides: Mamba2's head-broadcast B and C arrive with a head
// stride of 0 and are never copied, and the reference's chunked transposes
// are not needed. A ragged last chunk is masked (rows past S read as zero,
// which is what the reference's zero padding gives: ld = 0, g = 0). Outputs:
// y_intra (B, S, H, P), h_add (B, nc, H, N, P), cum (B, S, H) and tot
// (B, nc, H), all f32.
//
// Bound: operations. At zamba2's prefill (B 2, S 4096, H 80, N = P = 64,
// Q 256: 2,560 blocks) a block does Q (Q + 1) / 2 (N + P) 2 + Q N P 2 =
// 10.5 MFLOP with the upper triangle skipped, 26.9 GFLOP in all: 0.40 ms at
// 67 TFLOP/s of f32 outside the tensor cores, against 0.1 to 0.2 ms for its
// 0.4 to 0.7 GB of traffic.
//
// Design: one block of 128 threads per (chunk, head, batch). Thread t owns
// rows 4 (t / 8) .. + 3 of a 64-row tile and columns t % 8 + 8 j, as in the
// flash attention kernel: 32 entries of the 64 x 64 tile of decayed q k^T,
// which go through shared memory into the product with the (g v) tile, and
// 4 x P / 8 accumulators of y_intra in registers. h_add is a second pass
// over the key tiles, 64 of its N rows at a time, with k * exp(tot - cum)
// staged in place of the queries. Plain FMAs in f32, no tensor cores: a
// first kernel that is right; wgmma and pipelining are later work.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 64;
constexpr int kSStride = kTile + 1;

__device__ __forceinline__ void load8(const float* src, float* x, bool vec) {
  if (vec) {
    const float4 a = reinterpret_cast<const float4*>(src)[0];
    const float4 b = reinterpret_cast<const float4*>(src)[1];
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = src[i];
  }
}

__device__ __forceinline__ void load8(const __nv_bfloat16* src, float* x, bool vec) {
  if (vec) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = __bfloat162float(h[i]);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = __bfloat162float(src[i]);
  }
}

// Stage rows row0 .. row0 + 63 of the chunk (zeros from row n_rows on) of a
// (rows, width) matrix with row stride `row_stride` into shared memory as
// f32, `ld` floats apart, each row multiplied by row_scale(row) (the
// product is exact where the scale is 1).
template <typename T, typename Scale>
__device__ __forceinline__ void stage(float* dst, int ld, const T* base, int64_t row_stride,
                                      int row0, int n_rows, int width, bool vec,
                                      Scale row_scale) {
  const int chunks = width >> 3;
  for (int c = threadIdx.x; c < kTile * chunks; c += kThreads) {
    const int r = c / chunks;
    const int d0 = (c - r * chunks) << 3;
    float* out = dst + r * ld + d0;
    const int row = row0 + r;
    if (row < n_rows) {
      float x[8];
      load8(base + static_cast<int64_t>(row) * row_stride + d0, x, vec);
      const float sc = row_scale(row);
#pragma unroll
      for (int i = 0; i < 8; ++i) out[i] = x[i] * sc;
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) out[i] = 0.f;
    }
  }
}

// NJ: the most value columns per thread (P / 8 <= NJ)
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const T* __restrict__ v, const float* __restrict__ ld,
                 const T* __restrict__ k, const T* __restrict__ q,
                 const float* __restrict__ g, float* __restrict__ y,
                 float* __restrict__ hadd, float* __restrict__ cum_out,
                 float* __restrict__ tot_out, int64_t svb, int64_t svs, int64_t svh,
                 int64_t slb, int64_t sls, int64_t slh, int64_t skb, int64_t sks,
                 int64_t skh, int64_t sqb, int64_t sqs, int64_t sqh, int64_t sgb,
                 int64_t sgs, int64_t sgh, int S, int H, int N, int P, int Q, int Qp,
                 int vec) {
  extern __shared__ float smem[];
  const int ldn = N + 1;
  float* cum = smem;                    // Qp
  float* xs = cum + Qp;                 // queries, then k * w: kTile x ldn
  float* ks = xs + kTile * ldn;         // keys: kTile x ldn
  float* gs = ks + kTile * ldn;         // g * v: kTile x P
  float* ss = gs + kTile * P;           // decayed scores: kTile x kSStride
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x;
  const int s0 = c * Q;
  const int nvalid = S - s0 < Q ? S - s0 : Q;
  const int rg = threadIdx.x >> 3, cg = threadIdx.x & 7;
  const int nj = P >> 3;

  const T* vb = v + b * svb + s0 * svs + h * svh;
  const T* kb = k + b * skb + s0 * sks + h * skh;
  const T* qb = q + b * sqb + s0 * sqs + h * sqh;
  const float* lb = ld + b * slb + s0 * sls + h * slh;
  const float* gb = g + b * sgb + s0 * sgs + h * sgh;

  // cum: one warp scans 32 rows at a time, carrying the running total;
  // rows past the chunk's valid ones add 0, so they hold tot
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float carry = 0.f;
    for (int base = 0; base < Qp; base += 32) {
      const int r = base + lane;
      float x = r < nvalid ? lb[static_cast<int64_t>(r) * sls] : 0.f;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, x, off);
        if (lane >= off) x += up;
      }
      x += carry;
      cum[r] = x;
      carry = __shfl_sync(0xffffffffu, x, 31);
    }
  }
  __syncthreads();
  const float tot = cum[Qp - 1];
  for (int r = threadIdx.x; r < nvalid; r += kThreads)
    cum_out[(static_cast<int64_t>(b) * S + s0 + r) * H + h] = cum[r];
  if (threadIdx.x == 0) tot_out[(static_cast<int64_t>(b) * nc + c) * H + h] = tot;

  auto one = [](int) { return 1.f; };
  auto gate = [&](int r) { return gb[static_cast<int64_t>(r) * sgs]; };
  const int n_tiles = (nvalid + kTile - 1) / kTile;

  // y_intra, 64 rows at a time, key tiles up to the diagonal
  for (int it = 0; it < n_tiles; ++it) {
    const int i0 = it * kTile;
    float acc[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
    __syncthreads();                    // the previous tile's queries are consumed
    stage(xs, ldn, qb, sqs, i0, nvalid, N, vec, one);
    for (int jt = 0; jt <= it; ++jt) {
      const int j0 = jt * kTile;
      __syncthreads();                  // the previous keys, g v and scores are consumed
      stage(ks, ldn, kb, sks, j0, nvalid, N, vec, one);
      stage(gs, P, vb, svs, j0, nvalid, P, vec, gate);
      __syncthreads();

      float s[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
      for (int n0 = 0; n0 < N; n0 += 8) {
#pragma unroll
        for (int dn = 0; dn < 8; ++dn) {
          const int n = n0 + dn;
          float qv[4], kv[8];
#pragma unroll
          for (int i = 0; i < 4; ++i) qv[i] = xs[(4 * rg + i) * ldn + n];
#pragma unroll
          for (int j = 0; j < 8; ++j) kv[j] = ks[(cg + 8 * j) * ldn + n];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ri = i0 + 4 * rg + i;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int rj = j0 + cg + 8 * j;
          // mask before exp: above the diagonal cum_i - cum_j > 0 overflows
          const float dec = rj <= ri ? expf(cum[ri] - cum[rj]) : 0.f;
          ss[(4 * rg + i) * kSStride + cg + 8 * j] = s[i][j] * dec;
        }
      }
      __syncthreads();
      for (int kk = 0; kk < kTile; ++kk) {
        float a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = ss[(4 * rg + i) * kSStride + kk];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          if (j < nj) {
            const float gv = gs[kk * P + cg + 8 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(a[i], gv, acc[i][j]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ri = i0 + 4 * rg + i;
      if (ri < nvalid) {
        float* row = y + ((static_cast<int64_t>(b) * S + s0 + ri) * H + h) * P;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          if (j < nj) row[cg + 8 * j] = acc[i][j];
      }
    }
  }

  // h_add = (k * exp(tot - cum))^T @ (g v), 64 of its N rows at a time
  auto decay = [&](int r) { return expf(tot - cum[r]); };
  for (int n0 = 0; n0 < N; n0 += kTile) {
    float acc[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
    for (int jt = 0; jt < n_tiles; ++jt) {
      const int j0 = jt * kTile;
      __syncthreads();                  // the previous k * w and g v are consumed
      stage(xs, ldn, kb, sks, j0, nvalid, N, vec, decay);
      stage(gs, P, vb, svs, j0, nvalid, P, vec, gate);
      __syncthreads();
      for (int kk = 0; kk < kTile; ++kk) {
        float a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int n = n0 + 4 * rg + i;
          a[i] = n < N ? xs[kk * ldn + n] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          if (j < nj) {
            const float gv = gs[kk * P + cg + 8 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(a[i], gv, acc[i][j]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = n0 + 4 * rg + i;
      if (n < N) {
        float* row = hadd + (((static_cast<int64_t>(b) * nc + c) * H + h) * N + n) * P;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          if (j < nj) row[cg + 8 * j] = acc[i][j];
      }
    }
  }
}

template <typename T, int NJ>
int launch(const void* v, const float* ld, const void* k, const void* q, const float* g,
           float* y, float* hadd, float* cum, float* tot, const long long* st, int B, int S,
           int H, int N, int P, int Q, int vec, cudaStream_t stream) {
  const int nc = (S + Q - 1) / Q;
  const int Qp = (Q + kTile - 1) / kTile * kTile;
  const size_t smem = sizeof(float) * (Qp + 2 * kTile * (N + 1) + kTile * P + kTile * kSStride);
  auto* kern = ssd_chunk_kernel<T, NJ>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(nc, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(v), ld, static_cast<const T*>(k), static_cast<const T*>(q), g, y,
      hadd, cum, tot, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], st[12], st[13], st[14], S, H, N, P, Q, Qp, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* v, const float* ld, const void* k, const void* q, const float* g,
             float* y, float* hadd, float* cum, float* tot, const long long* st, int B, int S,
             int H, int N, int P, int Q, int vec, cudaStream_t stream) {
  const int nj = P / 8;
  if (nj <= 4) return launch<T, 4>(v, ld, k, q, g, y, hadd, cum, tot, st, B, S, H, N, P, Q, vec, stream);
  if (nj <= 8) return launch<T, 8>(v, ld, k, q, g, y, hadd, cum, tot, st, B, S, H, N, P, Q, vec, stream);
  return launch<T, 16>(v, ld, k, q, g, y, hadd, cum, tot, st, B, S, H, N, P, Q, vec, stream);
}

}  // namespace

extern "C" {

// dtype 0: f32, 1: bf16 (of v, k and q; ld and g are f32). Strides are in
// elements, (batch, sequence, head) of v, ld, k, q and g in that order; the
// last axis of v, k and q is contiguous. vec 1 when every row of v, k and q
// starts 16-byte aligned.
int ssd_chunk_scan_launch(const void* v, const float* ld, const void* k, const void* q,
                          const float* g, float* y, float* hadd, float* cum, float* tot,
                          long long svb, long long svs, long long svh, long long slb,
                          long long sls, long long slh, long long skb, long long sks,
                          long long skh, long long sqb, long long sqs, long long sqh,
                          long long sgb, long long sgs, long long sgh, int B, int S, int H,
                          int N, int P, int Q, int dtype, int vec, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (N % 8 != 0 || P % 8 != 0 || N < 8 || P < 8 || N > 128 || P > 128 || Q < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[15] = {svb, svs, svh, slb, sls, slh, skb, sks, skh,
                            sqb, sqs, sqh, sgb, sgs, sgh};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(v, ld, k, q, g, y, hadd, cum, tot, st, B, S, H, N, P, Q, vec, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(v, ld, k, q, g, y, hadd, cum, tot, st, B, S, H, N, P, Q,
                                   vec, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
