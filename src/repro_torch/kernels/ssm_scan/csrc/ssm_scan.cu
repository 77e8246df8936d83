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
// rows 4 (t / 8) .. + 3 of a 64-row tile and columns t % 8 + 8 j: 32
// entries of the 64 x 64 tile of decayed q k^T, which go through shared
// memory into the product with the (g v) tile, and 4 x P / 8 accumulators
// of y_intra in registers. h_add is a second pass over the key tiles, 64 of
// its N rows at a time, with k * exp(tot - cum) staged in place of the
// queries. Plain FMAs in f32, no tensor cores: a first kernel that is
// right; wgmma and pipelining are later work.
//
// ssd_chunk_scan_bwd has no TPU counterpart: the reference trains through
// its plain scan under jax.grad. It is the backward of ssd_chunk_scan, from
// the cotangents (dy, dh, dcum, dtot) of its four outputs to (dv, dld, dk,
// dq, dg). Per chunk, with u_j = g_j v_j, L_ij = exp(cum_i - cum_j) for
// j <= i, S_ij = q_i . k_j, D_ij = dy_i . u_j, w_j = exp(tot - cum_j) and
// A_ij = L_ij S_ij D_ij:
//              dq_i = sum_j L_ij D_ij k_j
//              dk_j = sum_i L_ij D_ij q_i + w_j dh u_j
//              du_j = sum_i L_ij S_ij dy_i + w_j dh^T k_j   (dv = g du,
//                     dg = v . du)
//              c_i  = dcum_i + sum_j A_ij - sum_i' A_i'i - w_i k_i^T dh u_i,
//                     the last valid row also dtot + sum_j w_j k_j^T dh u_j
//              dld  = the reverse cumsum of c over the chunk's valid rows.
// ops.SSDChunkScan wraps the pair as one autograd op; combine_chunks, the
// torch ops between chunks, is differentiated by autograd as it stands.
//
// Bound: operations. Without recomputation the five triangle products (S,
// D, dq, dk, du) are Q (Q + 1) / 2 (3 N + 2 P) 2 and the h_add terms 2 Q N P
// 2 per block: 25.3 MFLOP at Q = 256, N = P = 64, 2.4x the forward; at the
// training microbatch (B 2, S 1024, H 80: 640 blocks) 16.2 GFLOP, 0.24 ms
// at 67 TFLOP/s, against 0.06 ms for its bytes.
//
// Design: the forward's block, tiling and thread mapping. Pass 1 walks the
// key tiles j and, for each, the query tiles i >= j, accumulating dk_j and
// du_j in registers from (L D)^T and (L S)^T tiles that go through shared
// memory; pass 2 walks the query tiles i and the key tiles j <= i for dq_i.
// The S, D and L tiles are recomputed in each pass (S and D twice, whole
// diagonal tiles: 40.9 MFLOP a block, 3.9x the forward's count, against
// 2.4x), so nothing crosses blocks and no
// atomics are needed. dh sits in shared memory for the h_add terms. The
// row and column sums of A are reduced in a fixed order (shuffles, then
// the four warps in turn), and one warp forms c and its reverse cumsum:
// two launches give the same bits. dk and dq are dense (B, S, H, N) even
// where k and q broadcast over the heads; expand's backward sums them.

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

// cum: one warp scans 32 rows at a time, carrying the running total; rows
// past the chunk's valid ones add 0, so they hold tot. The forward and the
// backward both call it, so the backward's cum is the forward's, bit for bit.
__device__ __forceinline__ void scan_cum(float* cum, const float* lb, int64_t sls, int nvalid,
                                         int Qp) {
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

  scan_cum(cum, lb, sls, nvalid, Qp);
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

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// sum over the 8 threads (consecutive lanes) that share a row group
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// The 4 x 8 register tiles of S = q_i . k_j (over N, xs x ks) and of
// D = dy_i . u_j (over P, ys x us) for rows i0 + 4 rg + a and columns
// j0 + cg + 8 b; then, with L = exp(cum_i - cum_j) masked to j <= i before
// the exp, sv becomes L S and dv L D, and take(a, b, A) gets A = L D S.
template <typename Take>
__device__ __forceinline__ void score_tiles(const float* xs, const float* ks, const float* ys,
                                            const float* us, const float* cum, int ldn,
                                            int ldp, int N, int P, int i0, int j0, int rg,
                                            int cg, float (&sv)[4][8], float (&dv)[4][8],
                                            Take take) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) sv[a][b] = dv[a][b] = 0.f;
  for (int n = 0; n < N; ++n) {
    float x[4], y[8];
#pragma unroll
    for (int a = 0; a < 4; ++a) x[a] = xs[(4 * rg + a) * ldn + n];
#pragma unroll
    for (int b = 0; b < 8; ++b) y[b] = ks[(cg + 8 * b) * ldn + n];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b) sv[a][b] = fmaf(x[a], y[b], sv[a][b]);
  }
  for (int p = 0; p < P; ++p) {
    float x[4], y[8];
#pragma unroll
    for (int a = 0; a < 4; ++a) x[a] = ys[(4 * rg + a) * ldp + p];
#pragma unroll
    for (int b = 0; b < 8; ++b) y[b] = us[(cg + 8 * b) * ldp + p];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b) dv[a][b] = fmaf(x[a], y[b], dv[a][b]);
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int ri = i0 + 4 * rg + a;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int rj = j0 + cg + 8 * b;
      const float L = rj <= ri ? expf(cum[ri] - cum[rj]) : 0.f;   // mask before exp
      const float ld = L * dv[a][b];
      take(a, b, ld * sv[a][b]);
      dv[a][b] = ld;
      sv[a][b] *= L;
    }
  }
}

// acc[a][c] += sum_kk tile[(4 rg + a) * kSStride + kk] * mat[kk * ld + cg + 8 c]
// for the columns cg + 8 c < width of a 64-row operand in shared memory
template <int NJ>
__device__ __forceinline__ void tile_product(float (&acc)[4][NJ], const float* tile,
                                             const float* mat, int ld, int width, int rg,
                                             int cg) {
  const int nj = width >> 3;
  for (int kk = 0; kk < kTile; ++kk) {
    float a4[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) a4[a] = tile[(4 * rg + a) * kSStride + kk];
#pragma unroll
    for (int c = 0; c < NJ; ++c) {
      if (c < nj) {
        const float m = mat[kk * ld + cg + 8 * c];
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[a][c] = fmaf(a4[a], m, acc[a][c]);
      }
    }
  }
}

// The backward of ssd_chunk_kernel for one (chunk, head, batch): from the
// cotangents dy (B, S, H, P), dh (B, nc, H, N, P), dcum (B, S, H) and dtot
// (B, nc, H), all contiguous f32, it writes dv, dk, dq (dense, in T) and
// dld, dg (f32). Pass 1 walks the key tiles j and, for each, the query
// tiles i >= j: dk_j and du_j, and the column sums of A. Pass 2 walks the
// query tiles i and, for each, the key tiles j <= i: dq_i and the row sums
// of A. The L, S and D tiles are recomputed in each pass. Then one warp
// forms the cotangent of cum and its reverse cumsum, dld.
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_bwd_kernel(const float* __restrict__ dy, const float* __restrict__ dh,
                     const float* __restrict__ dcum, const float* __restrict__ dtot,
                     const T* __restrict__ v, const float* __restrict__ ld,
                     const T* __restrict__ k, const T* __restrict__ q,
                     const float* __restrict__ g, T* __restrict__ dv_out,
                     float* __restrict__ dld_out, T* __restrict__ dk_out,
                     T* __restrict__ dq_out, float* __restrict__ dg_out, int64_t svb,
                     int64_t svs, int64_t svh, int64_t slb, int64_t sls, int64_t slh,
                     int64_t skb, int64_t sks, int64_t skh, int64_t sqb, int64_t sqs,
                     int64_t sqh, int64_t sgb, int64_t sgs, int64_t sgh, int S, int H, int N,
                     int P, int Q, int Qp, int vec) {
  extern __shared__ float smem[];
  const int ldn = N + 1, ldp = P + 1;
  float* cum = smem;                    // Qp
  float* wv = cum + Qp;                 // w = exp(tot - cum): Qp
  float* rs = wv + Qp;                  // row sums of A: Qp
  float* cs = rs + Qp;                  // column sums of A: Qp
  float* wt = cs + Qp;                  // w_j k_j^T dh u_j: Qp
  float* cpart = wt + Qp;               // per-warp column partials: 4 x kTile
  float* xs = cpart + 4 * kTile;        // q_i: kTile x ldn
  float* ks = xs + kTile * ldn;         // k_j: kTile x ldn
  float* ys = ks + kTile * ldn;         // dy_i: kTile x ldp
  float* us = ys + kTile * ldp;         // u_j = g_j v_j: kTile x ldp
  float* ss = us + kTile * ldp;         // an L D or L S tile: kTile x kSStride
  float* dhs = ss + kTile * kSStride;   // dh: N x ldp
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x;
  const int s0 = c * Q;
  const int nvalid = S - s0 < Q ? S - s0 : Q;
  const int rg = threadIdx.x >> 3, cg = threadIdx.x & 7;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nn = N >> 3, np = P >> 3;

  const T* vb = v + b * svb + s0 * svs + h * svh;
  const T* kb = k + b * skb + s0 * sks + h * skh;
  const T* qb = q + b * sqb + s0 * sqs + h * sqh;
  const float* lb = ld + b * slb + s0 * sls + h * slh;
  const float* gb = g + b * sgb + s0 * sgs + h * sgh;
  const int64_t row0 = static_cast<int64_t>(b) * S + s0;         // (b, s0) in (B, S)
  const float* dyb = dy + (row0 * H + h) * P;
  const int64_t dys = static_cast<int64_t>(H) * P;
  const float* dhb = dh + ((static_cast<int64_t>(b) * nc + c) * H + h) * N * P;

  scan_cum(cum, lb, sls, nvalid, Qp);
  for (int i = threadIdx.x; i < N * P; i += kThreads) dhs[(i / P) * ldp + i % P] = dhb[i];
  __syncthreads();
  const float tot = cum[Qp - 1];
  for (int r = threadIdx.x; r < Qp; r += kThreads) wv[r] = expf(tot - cum[r]);

  auto one = [](int) { return 1.f; };
  auto gate = [&](int r) { return gb[static_cast<int64_t>(r) * sgs]; };
  const int n_tiles = (nvalid + kTile - 1) / kTile;
  float sv[4][8], dv[4][8];

  // pass 1: key tiles j; dk_j, du_j and the column sums of A
  for (int jt = 0; jt < n_tiles; ++jt) {
    const int j0 = jt * kTile;
    float acc_k[4][NJ], acc_u[4][NJ], colsum[8];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int cc = 0; cc < NJ; ++cc) acc_k[a][cc] = acc_u[a][cc] = 0.f;
#pragma unroll
    for (int bb = 0; bb < 8; ++bb) colsum[bb] = 0.f;
    __syncthreads();                    // the previous tile's k and u are consumed
    stage(ks, ldn, kb, sks, j0, nvalid, N, vec, one);
    stage(us, ldp, vb, svs, j0, nvalid, P, vec, gate);
    for (int it = jt; it < n_tiles; ++it) {
      const int i0 = it * kTile;
      __syncthreads();                  // the previous q, dy and tiles are consumed
      stage(xs, ldn, qb, sqs, i0, nvalid, N, vec, one);
      stage(ys, ldp, dyb, dys, i0, nvalid, P, true, one);
      __syncthreads();
      score_tiles(xs, ks, ys, us, cum, ldn, ldp, N, P, i0, j0, rg, cg, sv, dv,
                  [&](int, int bb, float A) { colsum[bb] += A; });
      // (L D)^T into ss, for dk_j += sum_i L_ij D_ij q_i
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int bb = 0; bb < 8; ++bb) ss[(cg + 8 * bb) * kSStride + 4 * rg + a] = dv[a][bb];
      __syncthreads();
      tile_product<NJ>(acc_k, ss, xs, ldn, N, rg, cg);
      __syncthreads();
      // (L S)^T into ss, for du_j += sum_i L_ij S_ij dy_i
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int bb = 0; bb < 8; ++bb)
          ss[(cg + 8 * bb) * kSStride + 4 * rg + a] = sv[a][bb];
      __syncthreads();
      tile_product<NJ>(acc_u, ss, ys, ldp, P, rg, cg);
    }
    // column sums of A over the 16 row groups, in a fixed order
#pragma unroll
    for (int bb = 0; bb < 8; ++bb) {
      float x = colsum[bb];
      x += __shfl_xor_sync(0xffffffffu, x, 8);
      x += __shfl_xor_sync(0xffffffffu, x, 16);
      if (lane < 8) cpart[warp * kTile + cg + 8 * bb] = x;
    }
    __syncthreads();
    if (threadIdx.x < kTile)
      cs[j0 + threadIdx.x] = ((cpart[threadIdx.x] + cpart[kTile + threadIdx.x])
                              + cpart[2 * kTile + threadIdx.x]) + cpart[3 * kTile + threadIdx.x];
    // the h_add terms of rows j: dk_j += w_j dh u_j, du_j += w_j dh^T k_j,
    // and wt_j = w_j k_j^T dh u_j
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int jl = 4 * rg + a;
      const int rj = j0 + jl;
      const float w = wv[rj];
      float kdhu = 0.f;
#pragma unroll
      for (int cc = 0; cc < NJ; ++cc) {
        if (cc < nn) {
          const int n = cg + 8 * cc;
          float x = 0.f;
          for (int p = 0; p < P; ++p) x = fmaf(us[jl * ldp + p], dhs[n * ldp + p], x);
          kdhu = fmaf(ks[jl * ldn + n], x, kdhu);
          acc_k[a][cc] = fmaf(w, x, acc_k[a][cc]);
        }
        if (cc < np) {
          const int p = cg + 8 * cc;
          float x = 0.f;
          for (int n = 0; n < N; ++n) x = fmaf(ks[jl * ldn + n], dhs[n * ldp + p], x);
          acc_u[a][cc] = fmaf(w, x, acc_u[a][cc]);
        }
      }
      kdhu = group_sum(kdhu);
      if (cg == 0) wt[rj] = w * kdhu;
      // every lane takes part in the shuffles; only valid rows are written
      const bool valid = rj < nvalid;
      const int64_t row = (row0 + rj) * H + h;
      const float gj = valid ? gb[static_cast<int64_t>(rj) * sgs] : 0.f;
      const T* vrow = vb + static_cast<int64_t>(rj) * svs;
      float dgj = 0.f;
#pragma unroll
      for (int cc = 0; cc < NJ; ++cc) {
        if (valid && cc < nn) store(dk_out + row * N + cg + 8 * cc, acc_k[a][cc]);
        if (valid && cc < np) {
          const int p = cg + 8 * cc;
          store(dv_out + row * P + p, gj * acc_u[a][cc]);
          dgj = fmaf(load1(vrow + p), acc_u[a][cc], dgj);
        }
      }
      dgj = group_sum(dgj);
      if (valid && cg == 0) dg_out[row] = dgj;
    }
  }

  // pass 2: query tiles i; dq_i and the row sums of A
  for (int it = 0; it < n_tiles; ++it) {
    const int i0 = it * kTile;
    float acc_q[4][NJ], rowsum[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      rowsum[a] = 0.f;
#pragma unroll
      for (int cc = 0; cc < NJ; ++cc) acc_q[a][cc] = 0.f;
    }
    __syncthreads();                    // the previous q and dy are consumed
    stage(xs, ldn, qb, sqs, i0, nvalid, N, vec, one);
    stage(ys, ldp, dyb, dys, i0, nvalid, P, true, one);
    for (int jt = 0; jt <= it; ++jt) {
      const int j0 = jt * kTile;
      __syncthreads();                  // the previous k, u and tile are consumed
      stage(ks, ldn, kb, sks, j0, nvalid, N, vec, one);
      stage(us, ldp, vb, svs, j0, nvalid, P, vec, gate);
      __syncthreads();
      score_tiles(xs, ks, ys, us, cum, ldn, ldp, N, P, i0, j0, rg, cg, sv, dv,
                  [&](int a, int, float A) { rowsum[a] += A; });
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int bb = 0; bb < 8; ++bb) ss[(4 * rg + a) * kSStride + cg + 8 * bb] = dv[a][bb];
      __syncthreads();
      tile_product<NJ>(acc_q, ss, ks, ldn, N, rg, cg);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int ri = i0 + 4 * rg + a;
      const float rsum = group_sum(rowsum[a]);
      if (cg == 0) rs[ri] = rsum;
      if (ri < nvalid) {
        const int64_t row = (row0 + ri) * H + h;
#pragma unroll
        for (int cc = 0; cc < NJ; ++cc)
          if (cc < nn) store(dq_out + row * N + cg + 8 * cc, acc_q[a][cc]);
      }
    }
  }
  __syncthreads();

  // the cotangent of cum, c_r = dcum_r + rs_r - cs_r - wt_r (the last valid
  // row also takes dtot and the sum of wt: tot is its cum), and dld, its
  // reverse cumsum over the valid rows: one warp, 32 rows at a time from
  // the end, carrying the running total
  if (threadIdx.x < 32) {
    const float* dcb = dcum + row0 * H + h;
    float wsum = 0.f;
    for (int r = lane; r < nvalid; r += 32) wsum += wt[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) wsum += __shfl_xor_sync(0xffffffffu, wsum, off);
    const float dt = dtot[(static_cast<int64_t>(b) * nc + c) * H + h];
    float carry = 0.f;
    for (int base = (nvalid - 1) / 32 * 32; base >= 0; base -= 32) {
      const int r = base + 31 - lane;   // lane 0 takes the chunk's last row
      float x = 0.f;
      if (r < nvalid) {
        x = dcb[static_cast<int64_t>(r) * H] + rs[r] - cs[r] - wt[r];
        if (r == nvalid - 1) x += dt + wsum;
      }
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, x, off);
        if (lane >= off) x += up;
      }
      x += carry;
      if (r < nvalid) dld_out[(row0 + r) * H + h] = x;
      carry = __shfl_sync(0xffffffffu, x, 31);
    }
  }
}

template <typename T, int NJ>
int launch_bwd(const float* dy, const float* dh, const float* dcum, const float* dtot,
               const void* v, const float* ld, const void* k, const void* q, const float* g,
               void* dv, float* dld, void* dk, void* dq, float* dg, const long long* st, int B,
               int S, int H, int N, int P, int Q, int vec, cudaStream_t stream) {
  const int nc = (S + Q - 1) / Q;
  const int Qp = (Q + kTile - 1) / kTile * kTile;
  const size_t smem = sizeof(float) * (5 * Qp + 4 * kTile + 2 * kTile * (N + 1) +
                                       2 * kTile * (P + 1) + kTile * kSStride + N * (P + 1));
  auto* kern = ssd_chunk_bwd_kernel<T, NJ>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(nc, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      dy, dh, dcum, dtot, static_cast<const T*>(v), ld, static_cast<const T*>(k),
      static_cast<const T*>(q), g, static_cast<T*>(dv), dld, static_cast<T*>(dk),
      static_cast<T*>(dq), dg, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], st[12], st[13], st[14], S, H, N, P, Q, Qp, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_bwd(const float* dy, const float* dh, const float* dcum, const float* dtot,
                 const void* v, const float* ld, const void* k, const void* q, const float* g,
                 void* dv, float* dld, void* dk, void* dq, float* dg, const long long* st,
                 int B, int S, int H, int N, int P, int Q, int vec, cudaStream_t stream) {
  const int nj = (N > P ? N : P) / 8;
  if (nj <= 4)
    return launch_bwd<T, 4>(dy, dh, dcum, dtot, v, ld, k, q, g, dv, dld, dk, dq, dg, st, B, S,
                            H, N, P, Q, vec, stream);
  if (nj <= 8)
    return launch_bwd<T, 8>(dy, dh, dcum, dtot, v, ld, k, q, g, dv, dld, dk, dq, dg, st, B, S,
                            H, N, P, Q, vec, stream);
  return launch_bwd<T, 16>(dy, dh, dcum, dtot, v, ld, k, q, g, dv, dld, dk, dq, dg, st, B, S,
                           H, N, P, Q, vec, stream);
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

extern "C" {

// The backward of ssd_chunk_scan_launch at the same inputs (v, ld, k, q, g,
// strides, shapes, dtype and vec as that entry point takes them), from the
// contiguous f32 cotangents dy (B, S, H, P), dh (B, nc, H, N, P), dcum
// (B, S, H) and dtot (B, nc, H). Writes contiguous dv (B, S, H, P), dk and
// dq (B, S, H, N) in the inputs' dtype, and dld, dg (B, S, H) in f32.
int ssd_chunk_scan_bwd_launch(const float* dy, const float* dh, const float* dcum,
                              const float* dtot, const void* v, const float* ld, const void* k,
                              const void* q, const float* g, void* dv, float* dld, void* dk,
                              void* dq, float* dg, long long svb, long long svs, long long svh,
                              long long slb, long long sls, long long slh, long long skb,
                              long long sks, long long skh, long long sqb, long long sqs,
                              long long sqh, long long sgb, long long sgs, long long sgh, int B,
                              int S, int H, int N, int P, int Q, int dtype, int vec, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (N % 8 != 0 || P % 8 != 0 || N < 8 || P < 8 || N > 128 || P > 128 || Q < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[15] = {svb, svs, svh, slb, sls, slh, skb, sks, skh,
                            sqb, sqs, sqh, sgb, sgs, sgh};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_bwd<float>(dy, dh, dcum, dtot, v, ld, k, q, g, dv, dld, dk, dq, dg, st, B,
                               S, H, N, P, Q, vec, s);
  if (dtype == 1)
    return dispatch_bwd<__nv_bfloat16>(dy, dh, dcum, dtot, v, ld, k, q, g, dv, dld, dk, dq, dg,
                                       st, B, S, H, N, P, Q, vec, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
