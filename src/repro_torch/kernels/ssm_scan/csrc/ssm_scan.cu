// Hopper (sm_90a) kernels of the intra-chunk SSD contraction (Mamba2, mLSTM)
// and of its backward, bound to Python with ctypes (plain C entry points;
// pointers and the stream arrive as void*).
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
// ssd_chunk_scan_bwd has no TPU counterpart: the reference trains through
// its plain scan under jax.grad. It is the backward of ssd_chunk_scan, from
// the cotangents (dy, dh, dcum, dtot) of its four outputs to (dv, dld, dk,
// dq, dg). Per chunk, with u_j = g_j v_j, L_ij = exp(cum_i - cum_j) for
// j <= i, D_ij = dy_i . u_j and w_j = exp(tot - cum_j):
//              dq_i = sum_j L_ij D_ij k_j
//              dk_j = sum_i L_ij D_ij q_i + w_j dh u_j
//              du_j = sum_i L_ij (q_i . k_j) dy_i + w_j dh^T k_j
//                     (dv = g du, dg = v . du)
//              c_r  = dcum_r + q_r . dq_r - k_r . dk_r, the last valid row
//                     also dtot + sum_j w_j k_j^T dh u_j
//              dld  = the reverse cumsum of c over the chunk's valid rows.
// q . dq is the row sum of A_ij = L_ij (q_i . k_j) D_ij, and k . dk its
// column sum plus w k^T dh u, so A is never formed. ops.SSDChunkScan wraps
// the pair as one autograd op; autograd differentiates combine_chunks.
//
// Layout: q, k (B, S, H, N) and v (B, S, H, P), ld and g (B, S, H), read
// through their strides: Mamba2's head-broadcast B and C arrive with a head
// stride of 0 and are never copied. A ragged last chunk is masked (rows past
// S read as zero, which is what the reference's zero padding gives: ld = 0,
// g = 0). Forward outputs y_intra (B, S, H, P), h_add (B, nc, H, N, P), cum
// (B, S, H), tot (B, nc, H), all f32; the backward takes contiguous f32
// cotangents and writes dv, dk, dq (dense (B, S, H, N) also where k and q
// broadcast; expand's backward sums them) in the inputs' dtype, dld and dg
// in f32.
//
// Bound: operations. At zamba2's prefill (B 2, S 4096, H 80, N = P = 64,
// Q 256) the forward needs Q (Q + 1) / 2 (N + P) 2 + Q N P 2 = 10.5 MFLOP a
// chunk, 26.9 GFLOP in all: 0.40 ms at 67 TFLOP/s of f32 outside the tensor
// cores, against 0.1 ms for its bytes. The backward needs the five triangle
// products Q (Q + 1) / 2 (3 N + 2 P) 2 and the h_add terms 2 Q N P 2, 25.3
// MFLOP a chunk: at the training microbatch (B 2, S 1024: 640 chunks) 16.2
// GFLOP, 0.24 ms, against 0.06 ms for its bytes. With f32 FMAs fed from
// shared memory, what binds in practice is instruction dispatch: the loads
// and shuffles that feed the FMAs, and their latency with two warps a
// scheduler.
//
// Design. Both kernels hold a resident tile of 128 rows of the chunk in
// shared memory and stream column tiles of 64 rows through a two-slot ring
// of 16-byte cp.async (tile i + 1 in flight while tile i is computed; bf16
// and unaligned rows are widened through registers into the same ring).
// Thread (rg, cg) = (t / 8, t % 8) owns rows rg + RG a of the resident tile
// (RG = T / 8) and columns cg + 8 b (b < 8) of the column tile: a register
// tile of scores, formed with float2 loads, masked before the exp, decayed
// (exp2f) and kept in registers; the product with the column tile's values
// takes each score from its owner lane by one shuffle per row. N and P are
// padded with zeros to the variant's width W (32, 64, 128), so every
// shared-memory offset is a constant. Row slices wholly on the masked side
// of a tile are skipped, and so are the wholly masked (slice, 8-column
// group) pairs of each 64 x 64 diagonal block, all at compile time. The
// loops over the 8 lanes of a shuffle and over the score's depth are not
// unrolled: fully unrolled, the code outgrew the instruction cache. cum is
// added up in row order by one thread, as torch.cumsum adds along an outer
// axis on the card, so the decays are the plain version's bit for bit.
//
// The forward (128 threads and 8 x 8 score tiles at W <= 64, two blocks a
// SM; 256 threads and 4 x 8 at 128) walks the query rows in passes of 128
// against the key tiles j <= i, with g_j folded into the decay (cp.async
// cannot scale what it copies). The last pass walks every key tile, and
// there each thread also adds its W / RG x W / 8 share of h_add (keys in
// row order), so h_add needs no walk of its own.
//
// The backward at W <= 64 and chunks up to 256 (every path shape) is one
// walk: 256 threads, one block a SM, passes of 128 resident rows j (their k
// and v) from the chunk's last pass to its first. A pass takes dh, then the
// query tiles i >= its first row (q and dy through the ring). A tile pair
// forms S^T = k_j . q_i and D^T = v_j . dy_i once each as 4 x 8 register
// tiles, decays both and adds du_j += (L S^T) dy_i and dk_j += (L D^T) q_i
// by shuffles: 5 products a pair. g_j L D^T goes to shared memory, and dq_i
// += (g L D^T)^T k_j is formed from there; rows past the first pass sum
// their dq over the passes in a chunk-sized shared buffer, in pass order,
// and the first pass writes every row. Wider N or P, or longer chunks,
// whose resident k and v, ring and dq buffer exceed a block's shared
// memory, take the wide backward: three walks per pass (A: rows i, dq; B:
// rows j, dk; C: rows j, du; D formed twice), two block kinds (A + B + dld,
// then C) on the grid's doubled z axis. Both form dcum as dcum + q . dq -
// k . dk (no A row or column sums). Nothing crosses blocks, no atomics,
// every sum in a fixed order: two launches give the same bits.
//
// Wide heads. N and P that are not both multiples of 8 up to 128 (the
// mLSTM's N = dm / H and P = N + 1: N 384 / P 385 at xlstm-125m's width, N
// 128 / P 129 reduced) take the wide variant further down, any N and P up to
// 512 with chunks up to 256: 64 x 64 tile products over 64-wide slices of N
// and P, staged element by element (the P tail masked, not padded in
// memory), one block per work item (a 64-row tile of y_intra, a 64-row
// slice of h_add; dq, dk or du of a 64-row tile, then one warp per chunk for
// dld). Bound at the xLSTM prefill (B 2, S 4096, H 4, N 384, P 385, Q 256):
// Q (Q + 1) / 2 (N + P) 2 + Q N P 2 = 126.3 MFLOP a chunk, 16.2 GFLOP in
// all, 0.241 ms at 67 TFLOP/s of f32.
//
// Registers and shared memory at N = P = 64 (ptxas, chip_smoke.py's build
// phase): forward 255 registers, 103 KB at chunk 256; backward 254
// registers, 209 KB; no spills in f32 or bf16, nor in any other variant.
// Plain FMAs in f32, no tensor cores: TF32 or bf16 wgmma would change the
// numbers of an f32 model with TF32 off, the model's decision.

#include <cmath>
#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 64;                 // rows of a streamed (column) tile
constexpr float kLog2e = 1.4426950408889634f;

// row stride, in floats, of a score operand tile of width W: 8 consecutive
// rows start in 8 distinct pairs of banks
__host__ __device__ constexpr int ld_of(int w) { return w + 4; }

// floats of one ring slot: the column tile's score operand (kCols x ld_of(W))
// and its value operand (kCols x W)
__host__ __device__ constexpr int slot_of(int w) { return kCols * (ld_of(w) + w); }

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;           // 0 bytes read: the 16 are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

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

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// blockIdx, read anew where the compiler would otherwise keep values
// derived from it in registers
__device__ __forceinline__ uint3 block_index() {
  uint3 id;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(id.x));
  asm volatile("mov.u32 %0, %%ctaid.y;" : "=r"(id.y));
  asm volatile("mov.u32 %0, %%ctaid.z;" : "=r"(id.z));
  return id;
}

// sum over the 8 threads (consecutive lanes) that share a row group
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Stage rows row0 .. row0 + ROWS - 1 of a (rows, width) matrix with row
// stride `row_stride` into shared memory as f32, LD floats apart and WP
// wide: zeros from row n_rows on and from column width on. f32 rows that
// start 16-byte aligned go by cp.async (the caller commits and waits); the
// rest are loaded, widened and stored by the threads themselves.
template <int T, int ROWS, int WP, int LD, typename Tin>
__device__ __forceinline__ void stage(float* dst, const Tin* base, int row_stride, int row0,
                                      int n_rows, int width, bool vec) {
  if constexpr (std::is_same<Tin, float>::value) {
    if (vec) {
      constexpr int chunks = WP / 4;
      for (int c = threadIdx.x; c < ROWS * chunks; c += T) {
        const int r = c / chunks;
        const int d0 = (c - r * chunks) * 4;
        const bool ok = row0 + r < n_rows && d0 < width;
        const float* src = ok ? base + static_cast<int64_t>(row0 + r) * row_stride + d0 : base;
        cp_async16(dst + r * LD + d0, src, ok);
      }
      return;
    }
  }
  constexpr int chunks = WP / 8;
  for (int c = threadIdx.x; c < ROWS * chunks; c += T) {
    const int r = c / chunks;
    const int d0 = (c - r * chunks) * 8;
    float* out = dst + r * LD + d0;
    if (row0 + r < n_rows && d0 < width) {
      float x[8];
      load8(base + static_cast<int64_t>(row0 + r) * row_stride + d0, x, vec);
#pragma unroll
      for (int i = 0; i < 8; ++i) out[i] = x[i];
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) out[i] = 0.f;
    }
  }
}

// dst[kk][n] = dh[n][p0 + kk] for kk < kCols, n < W (zeros past N and P):
// dh^T as a value tile, through registers (lanes on consecutive n)
template <int T, int W, int DLD>
__device__ __forceinline__ void stage_dh_t(float* dst, const float* dhb, int N, int P, int p0) {
  for (int i = threadIdx.x; i < (kCols / 4) * W; i += T) {
    const int n = i % W;
    const int kk = 4 * (i / W);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (n < N && p0 + kk < P)
      x = *reinterpret_cast<const float4*>(dhb + static_cast<int64_t>(n) * P + p0 + kk);
    dst[kk * DLD + n] = x.x;
    dst[(kk + 1) * DLD + n] = x.y;
    dst[(kk + 2) * DLD + n] = x.z;
    dst[(kk + 3) * DLD + n] = x.w;
  }
}

// The chunk's per-row f32 values (ld or g, stride `st`) into dst[0 .. Qr),
// zeros past the valid rows.
template <int T>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int64_t st, int nvalid,
                                          int Qr) {
  for (int r = threadIdx.x; r < Qr; r += T)
    dst[r] = r < nvalid ? src[static_cast<int64_t>(r) * st] : 0.f;
}

// cum, in place over the loaded log-decays: one thread adds them in row
// order from 0, as torch.cumsum does along an outer axis on the card, so
// the decays exp(cum_i - cum_j) carry no rounding of a different order.
// Rows past the valid ones add 0 and hold tot.
__device__ __forceinline__ void scan_cum(float* cum, int Qr) {
  if (threadIdx.x == 0) {
    float acc = 0.f;
#pragma unroll 8
    for (int r = 0; r < Qr; ++r) {
      acc += cum[r];
      cum[r] = acc;
    }
  }
}

// Whether (row slice a, column group b) of a tile holds any unmasked entry:
// slices a in [D0, D1) cover the tile's 64 x 64 diagonal block, slice a - D0
// its rows RG (a - D0) .. + RG - 1 and group b its columns 8 b .. 8 b + 7;
// TRANS keeps columns >= rows, otherwise columns <= rows.
template <int RG, bool TRANS, int D0, int D1>
__device__ __forceinline__ constexpr bool live(int a, int b) {
  return a < D0 || a >= D1 ||
         (TRANS ? 8 * b + 7 >= RG * (a - D0) : 8 * b <= RG * (a - D0 + 1) - 1);
}

// One column tile of a walk. Thread (rg, cg) = (tid / 8, tid % 8) owns rows
// r0 + rg + RG a (a < RPT, RG = T / 8) of the resident tile xs and columns
// c0 + cg + 8 b (b < 8) of the column tile: an RPT x 8 register tile of
// scores s = xs . ys (over W, float2 steps). The decay masks before the exp:
// TRANS false keeps columns c <= r with exp(cum_r - cum_c), TRANS true keeps
// c >= r with exp(cum_c - cum_r); COLF multiplies column c by colf[c]. Then
// acc[a][t] += sum_c s[a][c] vs[c][2 (cg + 8 t) + {0, 1}]: for column kk
// the row group's 8 lanes hold s in register kk / 8 of lane kk % 8, and one
// shuffle per row hands it to all 8. Row slices a outside [A0, A1) lie
// wholly on the masked side of this tile and are skipped, and so are the
// (slice, column group) pairs of the diagonal block [D0, D1) that `live`
// rules out: all at compile time.
template <int T, int RPT, int W, bool TRANS, bool COLF, int A0, int A1, int D0, int D1>
__device__ __forceinline__ void tile_step(const float* __restrict__ xs,
                                          const float* __restrict__ ys,
                                          const float* __restrict__ vs,
                                          const float* __restrict__ cum,
                                          const float* __restrict__ colf, int r0, int c0,
                                          float2 (&acc)[RPT][W / 16]) {
  constexpr int RG = T / 8, LD = ld_of(W), NV = W / 16;
  const int lane = threadIdx.x & 31, rg = threadIdx.x >> 3, cg = threadIdx.x & 7;
  float s[RPT][8];
#pragma unroll
  for (int a = A0; a < A1; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) s[a][b] = 0.f;
  const float* xrow = xs + rg * LD;
  const float* yrow = ys + cg * LD;
#pragma unroll 1
  for (int d = 0; d < W; d += 2) {
    float2 xv[RPT];
#pragma unroll
    for (int a = A0; a < A1; ++a)
      xv[a] = *reinterpret_cast<const float2*>(xrow + RG * a * LD + d);
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const float2 yv = *reinterpret_cast<const float2*>(yrow + 8 * b * LD + d);
#pragma unroll
      for (int a = A0; a < A1; ++a) {
        if (live<RG, TRANS, D0, D1>(a, b)) {
          s[a][b] = fmaf(xv[a].x, yv.x, s[a][b]);
          s[a][b] = fmaf(xv[a].y, yv.y, s[a][b]);
        }
      }
    }
  }
  float ccol[8], fcol[8];
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const int cj = c0 + cg + 8 * b;
    ccol[b] = cum[cj];
    fcol[b] = COLF ? colf[cj] : 1.f;
  }
#pragma unroll
  for (int a = A0; a < A1; ++a) {
    const int ri = r0 + rg + RG * a;
    const float cr = cum[ri];
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      if (!live<RG, TRANS, D0, D1>(a, b)) continue;
      const int cj = c0 + cg + 8 * b;
      const bool ok = TRANS ? cj >= ri : cj <= ri;
      // mask before exp: on the masked side the exponent is positive and
      // overflows f32
      const float e = exp2f(ok ? (TRANS ? ccol[b] - cr : cr - ccol[b]) * kLog2e : -INFINITY);
      s[a][b] *= COLF ? e * fcol[b] : e;
    }
  }
  const int src0 = lane & 24;             // lane of column group 0 in this row group
#pragma unroll
  for (int bb = 0; bb < 8; ++bb) {
#pragma unroll 1
    for (int c8 = 0; c8 < 8; ++c8) {
      const float* vrow = vs + (c8 + 8 * bb) * W + 2 * cg;
      float p[RPT];
#pragma unroll
      for (int a = A0; a < A1; ++a)
        if (live<RG, TRANS, D0, D1>(a, bb)) p[a] = __shfl_sync(0xffffffffu, s[a][bb], src0 | c8);
#pragma unroll
      for (int t = 0; t < NV; ++t) {
        const float2 vv = *reinterpret_cast<const float2*>(vrow + 16 * t);
#pragma unroll
        for (int a = A0; a < A1; ++a) {
          if (live<RG, TRANS, D0, D1>(a, bb)) {
            acc[a][t].x = fmaf(p[a], vv.x, acc[a][t].x);
            acc[a][t].y = fmaf(p[a], vv.y, acc[a][t].y);
          }
        }
      }
    }
  }
}

// Column tile c0 = r0 + 64 m of a causal walk for the pass at r0, with the
// row slices and diagonal block chosen at compile time. SL = 512 / T slices
// cover 64 rows, so a pass of RPT slices meets the diagonal at m = 0 ..
// RPT / SL - 1, in slices SL m .. SL m + SL - 1. Not TRANS: the slices
// before lie above the diagonal and are skipped; TRANS: the slices after
// lie below it. Other tiles (m < 0 not TRANS, m past the pass TRANS) are
// whole.
template <int T, int RPT, int W, bool TRANS, bool COLF, int M>
__device__ __forceinline__ void causal_step(int m, const float* xs, const float* ys,
                                            const float* vs, const float* cum,
                                            const float* colf, int r0, int c0,
                                            float2 (&acc)[RPT][W / 16]) {
  constexpr int SL = 512 / T;
  if constexpr (M < RPT / SL) {
    if (m == M) {
      constexpr int A0 = TRANS ? 0 : SL * M, A1 = TRANS ? SL * (M + 1) : RPT;
      tile_step<T, RPT, W, TRANS, COLF, A0, A1, SL * M, SL * (M + 1)>(xs, ys, vs, cum, colf,
                                                                       r0, c0, acc);
      return;
    }
    causal_step<T, RPT, W, TRANS, COLF, M + 1>(m, xs, ys, vs, cum, colf, r0, c0, acc);
  } else {
    tile_step<T, RPT, W, TRANS, COLF, 0, RPT, 0, 0>(xs, ys, vs, cum, colf, r0, c0, acc);
  }
}

// One tile of dh for the h_add terms of the backward: acc[a][t] +=
// sum_kk xs[row a][p0 + kk] vs[kk][2 (cg + 8 t) + {0, 1}], the rows' own
// operand as the scores (read from shared memory, no decay).
template <int T, int RPT, int W, int VLD>
__device__ __forceinline__ void dh_step(const float* __restrict__ xs, int p0,
                                        const float* __restrict__ vs,
                                        float2 (&acc)[RPT][W / 16]) {
  constexpr int RG = T / 8, LD = ld_of(W), NV = W / 16, KEYS = W < kCols ? W : kCols;
  const int rg = threadIdx.x >> 3, cg = threadIdx.x & 7;
  const float* xrow = xs + rg * LD + p0;
#pragma unroll 8
  for (int kk = 0; kk < KEYS; ++kk) {
    const float* vrow = vs + kk * VLD + 2 * cg;
    float p[RPT];
#pragma unroll
    for (int a = 0; a < RPT; ++a) p[a] = xrow[RG * a * LD + kk];
#pragma unroll
    for (int t = 0; t < NV; ++t) {
      const float2 vv = *reinterpret_cast<const float2*>(vrow + 16 * t);
#pragma unroll
      for (int a = 0; a < RPT; ++a) {
        acc[a][t].x = fmaf(p[a], vv.x, acc[a][t].x);
        acc[a][t].y = fmaf(p[a], vv.y, acc[a][t].y);
      }
    }
  }
}

// A walk for the pass at r0: stage_x fills the resident tile xs, then
// n_dh tiles of dh (dh_step; after_dh() once they are done) and the column
// tiles first .. first + n_cols - 1 (causal_step) go through a two-slot
// ring that stage_tile(slot, i) fills: tile i + 1 is in flight while tile i
// is computed, one commit group per tile, cp.async.wait_group 1 before each.
template <int T, int RPT, int W, bool TRANS, bool COLF, typename StageX, typename StageTile,
          typename AfterDh, typename AfterCol>
__device__ __forceinline__ void walk(float* xs, float* ring, const float* cum, const float* colf,
                                     int r0, int first, int n_cols, int n_dh, StageX stage_x,
                                     StageTile stage_tile, AfterDh after_dh, AfterCol after_col,
                                     float2 (&acc)[RPT][W / 16]) {
  constexpr int SLOT = slot_of(W);
  const int n = n_dh + n_cols;
  stage_x(xs);
  if (n > 0) stage_tile(ring, 0);
  cp_async_commit();
  if (n > 1) stage_tile(ring + SLOT, 1);
  cp_async_commit();
  for (int i = 0; i < n; ++i) {
    cp_async_wait<1>();                   // tile i (and the resident tile) have landed
    __syncthreads();
    const float* ys = ring + (i & 1) * SLOT;
    const float* vs = ys + kCols * ld_of(W);
    if (i < n_dh) {
      dh_step<T, RPT, W, W>(xs, kCols * i, vs, acc);
      if (i == n_dh - 1) after_dh();
    } else {
      const int c0 = kCols * (first + i - n_dh);
      causal_step<T, RPT, W, TRANS, COLF, 0>((c0 - r0) / kCols, xs, ys, vs, cum, colf, r0, c0,
                                             acc);
      after_col(first + i - n_dh, ys, vs);
    }
    __syncthreads();                      // every thread is done with slot i & 1
    if (i + 2 < n) stage_tile(ring + (i & 1) * SLOT, i + 2);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();                        // xs and the ring are free for the next walk
}

template <int RPT, int W>
__device__ __forceinline__ void zero(float2 (&acc)[RPT][W / 16]) {
#pragma unroll
  for (int a = 0; a < RPT; ++a)
#pragma unroll
    for (int t = 0; t < W / 16; ++t) acc[a][t] = make_float2(0.f, 0.f);
}

// The forward: per (chunk, head, batch) one block of T threads; passes of
// ROWS = RPT T / 8 query rows walk the key tiles up to the diagonal, and
// the last pass, which walks them all, also forms h_add.
template <typename Tin, int T, int RPT, int W>
__global__ void __launch_bounds__(T, T == 128 ? 2 : 1)
ssd_chunk_kernel(const Tin* __restrict__ v, const float* __restrict__ ld,
                 const Tin* __restrict__ k, const Tin* __restrict__ q,
                 const float* __restrict__ g, float* __restrict__ y,
                 float* __restrict__ hadd, float* __restrict__ cum_out,
                 float* __restrict__ tot_out, int64_t svb, int64_t svs, int64_t svh,
                 int64_t slb, int64_t sls, int64_t slh, int64_t skb, int64_t sks,
                 int64_t skh, int64_t sqb, int64_t sqs, int64_t sqh, int64_t sgb,
                 int64_t sgs, int64_t sgh, int S, int H, int N, int P, int Q, int Qr,
                 int vec) {
  constexpr int RG = T / 8, ROWS = RG * RPT, LD = ld_of(W), NV = W / 16;
  extern __shared__ __align__(16) float smem[];
  float* cum = smem;                      // Qr
  float* gs = cum + Qr;                   // g: Qr
  float* wg = gs + Qr;                    // exp(tot - cum) g: Qr
  float* xs = wg + Qr;                    // the pass's queries: ROWS x LD
  float* ring = xs + ROWS * LD;           // 2 slots: keys (kCols x LD), v (kCols x W)
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x;
  const int s0 = c * Q;
  const int nvalid = S - s0 < Q ? S - s0 : Q;
  const int n_tiles = (nvalid + kCols - 1) / kCols;
  const int rg = threadIdx.x >> 3, cg = threadIdx.x & 7;

  const Tin* vb = v + b * svb + s0 * svs + h * svh;
  const Tin* kb = k + b * skb + s0 * sks + h * skh;
  const Tin* qb = q + b * sqb + s0 * sqs + h * sqh;
  const float* lb = ld + b * slb + s0 * sls + h * slh;
  const float* gb = g + b * sgb + s0 * sgs + h * sgh;
  // row strides in 32 bits (the entry point checks that they fit): fewer
  // registers held through the walks
  const int rsv = static_cast<int>(svs), rsk = static_cast<int>(sks), rsq = static_cast<int>(sqs);

  load_rows<T>(cum, lb, sls, nvalid, Qr);
  load_rows<T>(gs, gb, sgs, nvalid, Qr);
  __syncthreads();
  scan_cum(cum, Qr);
  __syncthreads();
  const float tot = cum[Qr - 1];
  for (int r = threadIdx.x; r < Qr; r += T) wg[r] = expf(tot - cum[r]) * gs[r];
  // (the walks' first barrier orders wg before use)

  auto key_tile = [&](float* slot, int i) {
    stage<T, kCols, W, LD>(slot, kb, rsk, kCols * i, nvalid, N, vec);
    stage<T, kCols, W, W>(slot + kCols * LD, vb, rsv, kCols * i, nvalid, P, vec);
  };
  auto nothing = [] {};
  // h_add = sum_j k_j (w_j g_j) v_j^T, formed in the last pass, which walks
  // every key tile: thread (rg, cg) owns rows n = rg + RG x (x < HX) and
  // columns 2 (cg + 8 t) + {0, 1} (t < NV), adding the keys in row order
  constexpr int HX = W / RG;
  float2 hacc[HX][NV];
#pragma unroll
  for (int x = 0; x < HX; ++x)
#pragma unroll
    for (int t = 0; t < NV; ++t) hacc[x][t] = make_float2(0.f, 0.f);
  float2 acc[RPT][NV];
  for (int r0 = 0; r0 < nvalid; r0 += ROWS) {
    zero<RPT, W>(acc);
    const int last = (r0 + ROWS) / kCols;
    const bool last_pass = r0 + ROWS >= nvalid;
    walk<T, RPT, W, false, true>(
        xs, ring, cum, gs, r0, 0, n_tiles < last ? n_tiles : last, 0,
        [&](float* dst) { stage<T, ROWS, W, LD>(dst, qb, rsq, r0, nvalid, N, vec); },
        key_tile, nothing,
        [&](int i, const float* ks, const float* vs) {
          if (!last_pass) return;
          const float* wt = wg + kCols * i;
#pragma unroll 2
          for (int kk = 0; kk < kCols; ++kk) {
            const float f = wt[kk];
            float p[HX];
#pragma unroll
            for (int x = 0; x < HX; ++x) p[x] = ks[kk * LD + rg + RG * x] * f;
#pragma unroll
            for (int t = 0; t < NV; ++t) {
              const float2 vv = *reinterpret_cast<const float2*>(vs + kk * W + 2 * (cg + 8 * t));
#pragma unroll
              for (int x = 0; x < HX; ++x) {
                hacc[x][t].x = fmaf(p[x], vv.x, hacc[x][t].x);
                hacc[x][t].y = fmaf(p[x], vv.y, hacc[x][t].y);
              }
            }
          }
        },
        acc);
#pragma unroll
    for (int a = 0; a < RPT; ++a) {
      const int ri = r0 + rg + RG * a;
      if (ri < nvalid) {
        float* row = y + ((static_cast<int64_t>(b) * S + s0 + ri) * H + h) * P;
#pragma unroll
        for (int t = 0; t < NV; ++t) {
          const int col = 2 * (cg + 8 * t);
          if (col < P) *reinterpret_cast<float2*>(row + col) = acc[a][t];
        }
      }
    }
  }

  for (int r = threadIdx.x; r < nvalid; r += T)
    cum_out[(static_cast<int64_t>(b) * S + s0 + r) * H + h] = cum[r];
  if (threadIdx.x == 0) tot_out[(static_cast<int64_t>(b) * nc + c) * H + h] = tot;
  float* hout = hadd + ((static_cast<int64_t>(b) * nc + c) * H + h) * N * P;
#pragma unroll
  for (int x = 0; x < HX; ++x) {
    const int n = rg + RG * x;
#pragma unroll
    for (int t = 0; t < NV; ++t) {
      const int p = 2 * (cg + 8 * t);
      if (n < N && p < P) *reinterpret_cast<float2*>(hout + n * P + p) = hacc[x][t];
    }
  }
}

// The wide backward (W 128 or chunks over 256) for one (chunk, head,
// batch), per pass of ROWS rows: walk A
// (rows i: dq_i = sum_j L_ij g_j (dy_i . v_j) k_j), walk B (rows j, columns
// i >= j: dk_j = g_j (w_j dh v_j + sum_i L_ij (v_j . dy_i) q_i)) and walk C
// (rows j: du_j = w_j dh^T k_j + sum_i L_ij (k_j . q_i) dy_i); then dv = g du,
// dg = v . du. The cotangent of cum is c_r = dcum_r + q_r . dq_r - k_r . dk_r
// (the row sums of A are q . dq, its column sums plus w k^T dh u are k . dk),
// and the last valid row also takes dtot + sum_j w_j k_j^T dh u_j; one warp
// forms dld, its reverse cumsum. Every sum runs in a fixed order.
template <typename Tin, int T, int RPT, int W>
__global__ void __launch_bounds__(T, T == 128 ? 2 : 1)
ssd_chunk_bwd_wide_kernel(const float* __restrict__ dy, const float* __restrict__ dh,
                          const float* __restrict__ dcum, const float* __restrict__ dtot,
                          const Tin* __restrict__ v, const float* __restrict__ ld,
                          const Tin* __restrict__ k, const Tin* __restrict__ q,
                          const float* __restrict__ g, Tin* __restrict__ dv_out,
                          float* __restrict__ dld_out, Tin* __restrict__ dk_out,
                          Tin* __restrict__ dq_out, float* __restrict__ dg_out, int64_t svb,
                          int64_t svs, int64_t svh, int64_t slb, int64_t sls, int64_t slh,
                          int64_t skb, int64_t sks, int64_t skh, int64_t sqb, int64_t sqs,
                          int64_t sqh, int64_t sgb, int64_t sgs, int64_t sgh, int S, int H,
                          int N, int P, int Q, int Qr, int vec) {
  constexpr int RG = T / 8, ROWS = RG * RPT, LD = ld_of(W), NV = W / 16;
  constexpr int N_DH = (W + kCols - 1) / kCols;
  extern __shared__ __align__(16) float smem[];
  float* cum = smem;                      // Qr
  float* gs = cum + Qr;                   // g: Qr
  float* wv = gs + Qr;                    // w = exp(tot - cum): Qr
  float* qdq = wv + Qr;                   // q_r . dq_r: Qr
  float* kdk = qdq + Qr;                  // k_r . dk_r: Qr
  float* wt = kdk + Qr;                   // w_r k_r^T dh u_r: Qr
  float* xs = wt + Qr;                    // the resident tile: ROWS x LD
  float* ring = xs + ROWS * LD;           // 2 slots
  // blocks in the first half of the z axis run walks A and B and form dld,
  // those in the second half walk C: the heavier half is scheduled first
  const int nb = gridDim.z / 2;
  const bool ab = blockIdx.z < nb;
  const int nc = gridDim.x;
  const int s0 = blockIdx.x * Q;
  const int nvalid = S - s0 < Q ? S - s0 : Q;
  const int n_tiles = (nvalid + kCols - 1) / kCols;
  const int lane = threadIdx.x & 31, rg = threadIdx.x >> 3, cg = threadIdx.x & 7;
  const int rsv = static_cast<int>(svs), rsk = static_cast<int>(sks), rsq = static_cast<int>(sqs);
  const int dys = H * P;

  // The chunk's base pointers and output rows are formed where they are
  // used, from block_index(): held through the walks they would take
  // registers the tiles need.
  auto at = [&](auto* p, int64_t sb, int64_t ss, int64_t sh) {
    const uint3 id = block_index();
    return p + (id.z % nb) * sb + static_cast<int64_t>(id.x) * Q * ss + id.y * sh;
  };
  auto vb = [&] { return at(v, svb, svs, svh); };
  auto kb = [&] { return at(k, skb, sks, skh); };
  auto qb = [&] { return at(q, sqb, sqs, sqh); };
  auto dyb = [&] { return at(dy, static_cast<int64_t>(S) * dys, dys, P); };
  auto dhb = [&] {
    const uint3 id = block_index();
    return dh + ((static_cast<int64_t>(id.z % nb) * nc + id.x) * H + id.y) * N * P;
  };
  auto row_at = [&](int r) {               // row r of the chunk in (B, S, H)
    const uint3 id = block_index();
    return (static_cast<int64_t>(id.z % nb) * S + id.x * Q + r) * H + id.y;
  };

  load_rows<T>(cum, at(ld, slb, sls, slh), sls, nvalid, Qr);
  load_rows<T>(gs, at(g, sgb, sgs, sgh), sgs, nvalid, Qr);
  __syncthreads();
  scan_cum(cum, Qr);
  __syncthreads();
  const float tot = cum[Qr - 1];
  for (int r = threadIdx.x; r < Qr; r += T) wv[r] = expf(tot - cum[r]);

  // the thread's rows' values of a (rows, N or P) input at the columns
  // 2 (cg + 8 t) + {0, 1} it owns, dotted with its accumulators
  auto row_dot = [&](const Tin* base, int st, int ri, int width,
                     const float2 (&a)[NV]) {
    float dot = 0.f;
    if (ri < nvalid) {
      const Tin* src = base + static_cast<int64_t>(ri) * st;
#pragma unroll
      for (int t = 0; t < NV; ++t) {
        const int col = 2 * (cg + 8 * t);
        if (col < width) {
          dot = fmaf(load1(src + col), a[t].x, dot);
          dot = fmaf(load1(src + col + 1), a[t].y, dot);
        }
      }
    }
    return group_sum(dot);
  };
  auto store_rows = [&](Tin* out, int ri, int width, const float2 (&a)[NV], float scale) {
    if (ri < nvalid) {
      Tin* row = out + row_at(ri) * width;
#pragma unroll
      for (int t = 0; t < NV; ++t) {
        const int col = 2 * (cg + 8 * t);
        if (col < width) {
          store(row + col, scale * a[t].x);
          store(row + col + 1, scale * a[t].y);
        }
      }
    }
  };
  auto nothing = [] {};
  float2 acc[RPT][NV];
  for (int r0 = 0; r0 < nvalid; r0 += ROWS) {
    const int last = (r0 + ROWS) / kCols;
    const int first = r0 / kCols;

    // walk A: dq over the key tiles j up to the diagonal
    if (ab) {
      zero<RPT, W>(acc);
      walk<T, RPT, W, false, true>(
          xs, ring, cum, gs, r0, 0, n_tiles < last ? n_tiles : last, 0,
          [&](float* dst) { stage<T, ROWS, W, LD>(dst, dyb(), dys, r0, nvalid, P, true); },
          [&](float* slot, int i) {
            stage<T, kCols, W, LD>(slot, vb(), rsv, kCols * i, nvalid, P, vec);
            stage<T, kCols, W, W>(slot + kCols * LD, kb(), rsk, kCols * i, nvalid, N, vec);
          },
          nothing, [](int, const float*, const float*) {}, acc);
#pragma unroll
      for (int a = 0; a < RPT; ++a) {
        const int ri = r0 + rg + RG * a;
        const float dot = row_dot(qb(), rsq, ri, N, acc[a]);
        if (cg == 0 && ri < nvalid) qdq[ri] = dot;
        store_rows(dq_out, ri, N, acc[a], 1.f);
      }
    }

    // walk B in the first half's blocks (dk: rows v_j, scores with dy_i,
    // values q_i), walk C in the others (du: rows k_j, scores with q_i,
    // values dy_i), each over dh first and then the query tiles i from the
    // pass's first row: one call site, so the walk's code is compiled once
    const bool du = !ab;
    zero<RPT, W>(acc);
    walk<T, RPT, W, true, false>(
        xs, ring, cum, nullptr, r0, first, n_tiles - first, N_DH,
        [&](float* dst) {
          if (du) stage<T, ROWS, W, LD>(dst, kb(), rsk, r0, nvalid, N, vec);
          else stage<T, ROWS, W, LD>(dst, vb(), rsv, r0, nvalid, P, vec);
        },
        [&](float* slot, int i) {
          if (i < N_DH) {
            if (du) stage<T, kCols, W, W>(slot + kCols * LD, dhb(), P, kCols * i, N, P, true);
            else stage_dh_t<T, W, W>(slot + kCols * LD, dhb(), N, P, kCols * i);
            return;
          }
          const int i0 = kCols * (first + i - N_DH);
          if (du) {
            stage<T, kCols, W, LD>(slot, qb(), rsq, i0, nvalid, N, vec);
            stage<T, kCols, W, W>(slot + kCols * LD, dyb(), dys, i0, nvalid, P, true);
          } else {
            stage<T, kCols, W, LD>(slot, dyb(), dys, i0, nvalid, P, true);
            stage<T, kCols, W, W>(slot + kCols * LD, qb(), rsq, i0, nvalid, N, vec);
          }
        },
        [&] {
          // acc = w_j dh v_j (B) or w_j dh^T k_j (C); B also wt_j = g_j k_j . acc
#pragma unroll
          for (int a = 0; a < RPT; ++a) {
            const int rj = r0 + rg + RG * a;
            const float w = wv[rj];
#pragma unroll
            for (int t = 0; t < NV; ++t) {
              acc[a][t].x *= w;
              acc[a][t].y *= w;
            }
            if (!du) {
              const float dot = row_dot(kb(), rsk, rj, N, acc[a]);
              if (cg == 0 && rj < nvalid) wt[rj] = gs[rj] * dot;
            }
          }
        },
        [](int, const float*, const float*) {}, acc);
#pragma unroll
    for (int a = 0; a < RPT; ++a) {
      const int rj = r0 + rg + RG * a;
      const float gj = gs[rj];
      if (du) {                         // dg = v . du, dv = g du
        const float dot = row_dot(vb(), rsv, rj, P, acc[a]);
        if (cg == 0 && rj < nvalid) dg_out[row_at(rj)] = dot;
        store_rows(dv_out, rj, P, acc[a], gj);
      } else {                          // dk = g acc; k . dk
#pragma unroll
        for (int t = 0; t < NV; ++t) {
          acc[a][t].x *= gj;
          acc[a][t].y *= gj;
        }
        const float dot = row_dot(kb(), rsk, rj, N, acc[a]);
        if (cg == 0 && rj < nvalid) kdk[rj] = dot;
        store_rows(dk_out, rj, N, acc[a], 1.f);
      }
    }
  }
  __syncthreads();

  // c_r = dcum_r + qdq_r - kdk_r (the last valid row also dtot and the sum
  // of wt: tot is its cum), and dld, its reverse cumsum over the valid rows:
  // one warp, 32 rows at a time from the end, carrying the running total
  if (ab && threadIdx.x < 32) {
    // the offsets anew from the block's index: held through the walks they
    // would be spilled
    const uint3 id = block_index();
    const int64_t at = (static_cast<int64_t>(id.z % nb) * S + id.x * Q) * H + id.y;
    const float* dcb = dcum + at;
    float wsum = 0.f;
    for (int r = lane; r < nvalid; r += 32) wsum += wt[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) wsum += __shfl_xor_sync(0xffffffffu, wsum, off);
    const float dt = dtot[(static_cast<int64_t>(id.z % nb) * nc + id.x) * H + id.y];
    float carry = 0.f;
    for (int base = (nvalid - 1) / 32 * 32; base >= 0; base -= 32) {
      const int r = base + 31 - lane;   // lane 0 takes the chunk's last row
      float x = 0.f;
      if (r < nvalid) {
        x = dcb[static_cast<int64_t>(r) * H] + qdq[r] - kdk[r];
        if (r == nvalid - 1) x += dt + wsum;
      }
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, x, off);
        if (lane >= off) x += up;
      }
      x += carry;
      if (r < nvalid) dld_out[at + static_cast<int64_t>(r) * H] = x;
      carry = __shfl_sync(0xffffffffu, x, 31);
    }
  }
}

// The one-walk backward (W <= 64, chunks up to 256; see the header):
// kBwdT threads, passes of kBwdRows resident rows, the tile pair's g L D^T
// kPtLd floats a row in shared memory.
constexpr int kBwdT = 256, kBwdRpt = 4, kBwdRows = kBwdT / 8 * kBwdRpt, kPtLd = kBwdRows + 4;

template <int W, int A0, int A1, int D0, int D1>
__device__ __forceinline__ void pair_step(const float* __restrict__ kr,
                                          const float* __restrict__ vr,
                                          const float* __restrict__ qs,
                                          const float* __restrict__ dys,
                                          const float* __restrict__ cum,
                                          const float* __restrict__ gs, float* __restrict__ pt,
                                          int r0, int c0, float2 (&adk)[kBwdRpt][W / 16],
                                          float2 (&adu)[kBwdRpt][W / 16]) {
  constexpr int RG = kBwdT / 8, LD = ld_of(W), NV = W / 16;
  const int lane = threadIdx.x & 31, rg = threadIdx.x >> 3, cg = threadIdx.x & 7;
  float s[kBwdRpt][8], d[kBwdRpt][8];
#pragma unroll
  for (int a = A0; a < A1; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) s[a][b] = d[a][b] = 0.f;
  const float* krow = kr + rg * LD;
  const float* vrow = vr + rg * LD;
  const float* qrow = qs + cg * LD;
  const float* yrow = dys + cg * LD;
#pragma unroll 1
  for (int dd = 0; dd < W; dd += 2) {
    float2 xk[kBwdRpt], xv[kBwdRpt];
#pragma unroll
    for (int a = A0; a < A1; ++a) {
      xk[a] = *reinterpret_cast<const float2*>(krow + RG * a * LD + dd);
      xv[a] = *reinterpret_cast<const float2*>(vrow + RG * a * LD + dd);
    }
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const float2 yq = *reinterpret_cast<const float2*>(qrow + 8 * b * LD + dd);
      const float2 yd = *reinterpret_cast<const float2*>(yrow + 8 * b * LD + dd);
#pragma unroll
      for (int a = A0; a < A1; ++a) {
        if (live<RG, true, D0, D1>(a, b)) {
          s[a][b] = fmaf(xk[a].x, yq.x, s[a][b]);
          s[a][b] = fmaf(xk[a].y, yq.y, s[a][b]);
          d[a][b] = fmaf(xv[a].x, yd.x, d[a][b]);
          d[a][b] = fmaf(xv[a].y, yd.y, d[a][b]);
        }
      }
    }
  }
  float ccol[8];
#pragma unroll
  for (int b = 0; b < 8; ++b) ccol[b] = cum[c0 + cg + 8 * b];
#pragma unroll
  for (int a = A0; a < A1; ++a) {
    const int rj = r0 + rg + RG * a;
    const float cr = cum[rj], gj = gs[rj];
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      float* cell = pt + (cg + 8 * b) * kPtLd + rg + RG * a;
      if (!live<RG, true, D0, D1>(a, b)) {
        *cell = 0.f;
        continue;
      }
      const int ci = c0 + cg + 8 * b;
      const float e = exp2f(ci >= rj ? (ccol[b] - cr) * kLog2e : -INFINITY);
      s[a][b] *= e;
      d[a][b] *= e;
      *cell = d[a][b] * gj;
    }
  }
  const int src0 = lane & 24;
#pragma unroll
  for (int bb = 0; bb < 8; ++bb) {
#pragma unroll 1
    for (int c8 = 0; c8 < 8; ++c8) {
      const int col = c8 + 8 * bb;
      const float* qv = qs + col * LD + 2 * cg;
      const float* yv = dys + col * LD + 2 * cg;
      float ps[kBwdRpt], pd[kBwdRpt];
#pragma unroll
      for (int a = A0; a < A1; ++a)
        if (live<RG, true, D0, D1>(a, bb)) {
          ps[a] = __shfl_sync(0xffffffffu, s[a][bb], src0 | c8);
          pd[a] = __shfl_sync(0xffffffffu, d[a][bb], src0 | c8);
        }
#pragma unroll
      for (int t = 0; t < NV; ++t) {
        const float2 vq = *reinterpret_cast<const float2*>(qv + 16 * t);
        const float2 vy = *reinterpret_cast<const float2*>(yv + 16 * t);
#pragma unroll
        for (int a = A0; a < A1; ++a) {
          if (live<RG, true, D0, D1>(a, bb)) {
            adu[a][t].x = fmaf(ps[a], vy.x, adu[a][t].x);
            adu[a][t].y = fmaf(ps[a], vy.y, adu[a][t].y);
            adk[a][t].x = fmaf(pd[a], vq.x, adk[a][t].x);
            adk[a][t].y = fmaf(pd[a], vq.y, adk[a][t].y);
          }
        }
      }
    }
  }
}

template <int W, int M>
__device__ __forceinline__ void pair_causal(int m, const float* kr, const float* vr,
                                            const float* qs, const float* dys, const float* cum,
                                            const float* gs, float* pt, int r0, int c0,
                                            float2 (&adk)[kBwdRpt][W / 16],
                                            float2 (&adu)[kBwdRpt][W / 16]) {
  constexpr int SL = 512 / kBwdT;
  if constexpr (M < kBwdRpt / SL) {
    if (m == M) {
      pair_step<W, 0, SL * (M + 1), SL * M, SL * (M + 1)>(kr, vr, qs, dys, cum, gs, pt, r0, c0,
                                                         adk, adu);
      return;
    }
    pair_causal<W, M + 1>(m, kr, vr, qs, dys, cum, gs, pt, r0, c0, adk, adu);
  } else {
    pair_step<W, 0, kBwdRpt, 0, 0>(kr, vr, qs, dys, cum, gs, pt, r0, c0, adk, adu);
  }
}

template <typename Tin, int W>
__global__ void __launch_bounds__(kBwdT, 1)
ssd_chunk_bwd_kernel(const float* __restrict__ dy, const float* __restrict__ dh,
                      const float* __restrict__ dcum, const float* __restrict__ dtot,
                      const Tin* __restrict__ v, const float* __restrict__ ld,
                      const Tin* __restrict__ k, const Tin* __restrict__ q,
                      const float* __restrict__ g, Tin* __restrict__ dv_out,
                      float* __restrict__ dld_out, Tin* __restrict__ dk_out,
                      Tin* __restrict__ dq_out, float* __restrict__ dg_out, int64_t svb,
                      int64_t svs, int64_t svh, int64_t slb, int64_t sls, int64_t slh,
                      int64_t skb, int64_t sks, int64_t skh, int64_t sqb, int64_t sqs,
                      int64_t sqh, int64_t sgb, int64_t sgs, int64_t sgh, int S, int H, int N,
                      int P, int Q, int Qr, int vec) {
  constexpr int T = kBwdT, RG = T / 8, ROWS = kBwdRows, LD = ld_of(W), NV = W / 16;
  constexpr int SLOT = 2 * kCols * LD;
  extern __shared__ __align__(16) float smem[];
  float* cum = smem;                      // Qr
  float* gs = cum + Qr;                   // g: Qr
  float* wv = gs + Qr;                    // w = exp(tot - cum): Qr
  float* qdq = wv + Qr;                   // q_r . dq_r: Qr
  float* kdk = qdq + Qr;                  // k_r . dk_r: Qr
  float* wt = kdk + Qr;                   // w_r k_r^T dh u_r: Qr
  float* kr = wt + Qr;                    // the pass's k rows: ROWS x LD
  float* vr = kr + ROWS * LD;             // and v rows
  float* ring = vr + ROWS * LD;           // 2 slots: q (kCols x LD), dy (kCols x LD)
  float* pt = ring + 2 * SLOT;            // g_j L D^T of a tile pair: kCols x kPtLd
  float* dqb = pt + kCols * kPtLd;        // dq of rows ROWS .. Qr - 1: (Qr - ROWS) x LD
  const int nc = gridDim.x, c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int s0 = c * Q;
  const int nvalid = S - s0 < Q ? S - s0 : Q;
  const int n_tiles = (nvalid + kCols - 1) / kCols;
  const int lane = threadIdx.x & 31, rg = threadIdx.x >> 3, cg = threadIdx.x & 7;
  const int rsv = static_cast<int>(svs), rsk = static_cast<int>(sks), rsq = static_cast<int>(sqs);
  const int dys = H * P;
  const Tin* vb = v + b * svb + static_cast<int64_t>(s0) * svs + h * svh;
  const Tin* kb = k + b * skb + static_cast<int64_t>(s0) * sks + h * skh;
  const Tin* qb = q + b * sqb + static_cast<int64_t>(s0) * sqs + h * sqh;
  const float* dyb = dy + (static_cast<int64_t>(b) * S + s0) * dys + h * P;
  const float* dhb = dh + ((static_cast<int64_t>(b) * nc + c) * H + h) * N * P;
  auto row_at = [&](int r) { return (static_cast<int64_t>(b) * S + s0 + r) * H + h; };

  load_rows<T>(cum, ld + b * slb + static_cast<int64_t>(s0) * sls + h * slh, sls, nvalid, Qr);
  load_rows<T>(gs, g + b * sgb + static_cast<int64_t>(s0) * sgs + h * sgh, sgs, nvalid, Qr);
  __syncthreads();
  scan_cum(cum, Qr);
  __syncthreads();
  const float tot = cum[Qr - 1];
  for (int r = threadIdx.x; r < Qr; r += T) wv[r] = expf(tot - cum[r]);

  // a row of the resident tile (k or v, smem) dotted with the thread's
  // accumulators of that row
  auto row_dot = [&](const float* xrow, const float2 (&a)[NV]) {
    float dot = 0.f;
#pragma unroll
    for (int t = 0; t < NV; ++t) {
      const float2 x = *reinterpret_cast<const float2*>(xrow + 2 * (cg + 8 * t));
      dot = fmaf(x.x, a[t].x, dot);
      dot = fmaf(x.y, a[t].y, dot);
    }
    return group_sum(dot);
  };
  auto store_rows = [&](Tin* out, int ri, int width, const float2 (&a)[NV], float scale) {
    if (ri < nvalid) {
      Tin* row = out + row_at(ri) * width;
#pragma unroll
      for (int t = 0; t < NV; ++t) {
        const int col = 2 * (cg + 8 * t);
        if (col < width) {
          store(row + col, scale * a[t].x);
          store(row + col + 1, scale * a[t].y);
        }
      }
    }
  };

  float2 adk[kBwdRpt][NV], adu[kBwdRpt][NV];
  for (int r0 = (nvalid - 1) / ROWS * ROWS; r0 >= 0; r0 -= ROWS) {
    const int first = r0 / kCols;
    const int n = 1 + n_tiles - first;    // dh, then the query tiles
    zero<kBwdRpt, W>(adk);
    zero<kBwdRpt, W>(adu);
    auto stage_tile = [&](float* slot, int i) {
      if (i == 0) {
        stage<T, kCols, W, LD>(slot, dhb, P, 0, N, P, true);   // dh: rows n
        stage_dh_t<T, W, LD>(slot + kCols * LD, dhb, N, P, 0);  // dh^T: rows p
        return;
      }
      const int i0 = kCols * (first + i - 1);
      stage<T, kCols, W, LD>(slot, qb, rsq, i0, nvalid, N, vec);
      stage<T, kCols, W, LD>(slot + kCols * LD, dyb, dys, i0, nvalid, P, true);
    };
    stage<T, ROWS, W, LD>(kr, kb, rsk, r0, nvalid, N, vec);
    stage<T, ROWS, W, LD>(vr, vb, rsv, r0, nvalid, P, vec);
    stage_tile(ring, 0);
    cp_async_commit();
    if (n > 1) stage_tile(ring + SLOT, 1);
    cp_async_commit();
    for (int i = 0; i < n; ++i) {
      cp_async_wait<1>();
      __syncthreads();
      const float* qs = ring + (i & 1) * SLOT;
      const float* ys = qs + kCols * LD;
      if (i == 0) {
        // dk_j = w_j dh v_j (dh^T rows p), du_j = w_j dh^T k_j (dh rows n);
        // wt_j = g_j k_j . (w_j dh v_j)
        dh_step<T, kBwdRpt, W, LD>(vr, 0, ys, adk);
        dh_step<T, kBwdRpt, W, LD>(kr, 0, qs, adu);
#pragma unroll
        for (int a = 0; a < kBwdRpt; ++a) {
          const int rj = r0 + rg + RG * a;
          const float w = wv[rj];
#pragma unroll
          for (int t = 0; t < NV; ++t) {
            adk[a][t].x *= w;
            adk[a][t].y *= w;
            adu[a][t].x *= w;
            adu[a][t].y *= w;
          }
          const float dot = row_dot(kr + (rg + RG * a) * LD, adk[a]);
          if (cg == 0 && rj < nvalid) wt[rj] = gs[rj] * dot;
        }
      } else {
        const int c0 = kCols * (first + i - 1);
        const int m = (c0 - r0) / kCols;
        pair_causal<W, 0>(m, kr, vr, qs, ys, cum, gs, pt, r0, c0, adk, adu);
        __syncthreads();                  // pt is complete
        // dq of the tile's rows: thread (ig, ng) owns rows c0 + ig + 16 x
        // and columns 2 (ng + 16 t) + {0, 1}, over the pass's rows j < jmax
        constexpr int NQ = W / 32 > 0 ? W / 32 : 1;
        const int ig = threadIdx.x >> 4, ng = threadIdx.x & 15;
        const int jmax = m == 0 ? kCols : ROWS;
        float2 dacc[4][NQ];
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int t = 0; t < NQ; ++t) dacc[x][t] = make_float2(0.f, 0.f);
        const bool cols_ok = W >= 32 || ng < W / 2;
#pragma unroll 2
        for (int j = 0; j < jmax; j += 2) {
          float2 pv[4];
#pragma unroll
          for (int x = 0; x < 4; ++x)
            pv[x] = *reinterpret_cast<const float2*>(pt + (ig + 16 * x) * kPtLd + j);
#pragma unroll
          for (int t = 0; t < NQ; ++t) {
            const int col = cols_ok ? 2 * (ng + 16 * t) : 0;
            const float2 k0 = *reinterpret_cast<const float2*>(kr + j * LD + col);
            const float2 k1 = *reinterpret_cast<const float2*>(kr + (j + 1) * LD + col);
#pragma unroll
            for (int x = 0; x < 4; ++x) {
              dacc[x][t].x = fmaf(pv[x].x, k0.x, dacc[x][t].x);
              dacc[x][t].y = fmaf(pv[x].x, k0.y, dacc[x][t].y);
              dacc[x][t].x = fmaf(pv[x].y, k1.x, dacc[x][t].x);
              dacc[x][t].y = fmaf(pv[x].y, k1.y, dacc[x][t].y);
            }
          }
        }
        const bool first_touch = c0 < r0 + ROWS;
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int ri = c0 + ig + 16 * x;
          float dot = 0.f;
#pragma unroll
          for (int t = 0; t < NQ; ++t) {
            const int col = 2 * (ng + 16 * t);
            if (!cols_ok) continue;
            float2 val = dacc[x][t];
            float2* cell = reinterpret_cast<float2*>(dqb + (ri - ROWS) * LD + col);
            if (r0 > 0) {
              if (!first_touch) {
                const float2 o = *cell;
                val = make_float2(o.x + val.x, o.y + val.y);
              }
              *cell = val;
            } else {
              if (ri >= ROWS) {
                const float2 o = *cell;
                val = make_float2(o.x + val.x, o.y + val.y);
              }
              const float2 qv = *reinterpret_cast<const float2*>(qs + (ri - c0) * LD + col);
              dot = fmaf(qv.x, val.x, dot);
              dot = fmaf(qv.y, val.y, dot);
              if (ri < nvalid && col < N) {
                Tin* row = dq_out + row_at(ri) * N;
                store(row + col, val.x);
                store(row + col + 1, val.y);
              }
            }
          }
          if (r0 == 0) {
#pragma unroll
            for (int off = 1; off < 16; off <<= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
            if (ng == 0 && ri < nvalid) qdq[ri] = dot;
          }
        }
      }
      __syncthreads();                    // the slot and pt are free
      if (i + 2 < n) stage_tile(ring + (i & 1) * SLOT, i + 2);
      cp_async_commit();
    }
    cp_async_wait<0>();
#pragma unroll
    for (int a = 0; a < kBwdRpt; ++a) {
      const int rj = r0 + rg + RG * a;
      const float gj = gs[rj];
      const float* krow = kr + (rg + RG * a) * LD;
      const float* vrow = vr + (rg + RG * a) * LD;
#pragma unroll
      for (int t = 0; t < NV; ++t) {
        adk[a][t].x *= gj;
        adk[a][t].y *= gj;
      }
      const float kd = row_dot(krow, adk[a]);
      const float vd = row_dot(vrow, adu[a]);
      if (cg == 0 && rj < nvalid) {
        kdk[rj] = kd;
        dg_out[row_at(rj)] = vd;
      }
      store_rows(dk_out, rj, N, adk[a], 1.f);
      store_rows(dv_out, rj, P, adu[a], gj);
    }
    __syncthreads();                      // kr, vr free for the next pass
  }

  if (threadIdx.x < 32) {
    const int64_t at = (static_cast<int64_t>(b) * S + s0) * H + h;
    const float* dcb = dcum + at;
    float wsum = 0.f;
    for (int r = lane; r < nvalid; r += 32) wsum += wt[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) wsum += __shfl_xor_sync(0xffffffffu, wsum, off);
    const float dt = dtot[(static_cast<int64_t>(b) * nc + c) * H + h];
    float carry = 0.f;
    for (int base = (nvalid - 1) / 32 * 32; base >= 0; base -= 32) {
      const int r = base + 31 - lane;
      float x = 0.f;
      if (r < nvalid) {
        x = dcb[static_cast<int64_t>(r) * H] + qdq[r] - kdk[r];
        if (r == nvalid - 1) x += dt + wsum;
      }
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, x, off);
        if (lane >= off) x += up;
      }
      x += carry;
      if (r < nvalid) dld_out[at + static_cast<int64_t>(r) * H] = x;
      carry = __shfl_sync(0xffffffffu, x, 31);
    }
  }
}

template <typename Tin, int W>
int launch_bwd(const float* dy, const float* dh, const float* dcum, const float* dtot,
                const void* v, const float* ld, const void* k, const void* q, const float* g,
                void* dv, float* dld, void* dk, void* dq, float* dg, const long long* st, int B,
                int S, int H, int N, int P, int Q, int vec, cudaStream_t stream) {
  constexpr int LD = ld_of(W);
  const int nc = (S + Q - 1) / Q;
  const int Qr = (Q + kBwdRows - 1) / kBwdRows * kBwdRows;
  const size_t smem = sizeof(float) * (6 * Qr + 2 * kBwdRows * LD + 4 * kCols * LD +
                                       kCols * kPtLd + (Qr - kBwdRows) * LD);
  auto* kern = ssd_chunk_bwd_kernel<Tin, W>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(nc, H, B);
  kern<<<grid, kBwdT, smem, stream>>>(
      dy, dh, dcum, dtot, static_cast<const Tin*>(v), ld, static_cast<const Tin*>(k),
      static_cast<const Tin*>(q), g, static_cast<Tin*>(dv), dld, static_cast<Tin*>(dk),
      static_cast<Tin*>(dq), dg, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], st[12], st[13], st[14], S, H, N, P, Q, Qr, vec);
  return static_cast<int>(cudaGetLastError());
}

// Threads, rows per thread and padded width of each variant: N and P are
// padded with zeros to W (32, 64 or 128); at W = 128 a thread keeps 4 rows,
// so its accumulators fit beside the scores.
template <int W> struct Variant { static constexpr int kT = 128, kRpt = 8; };
template <> struct Variant<128> { static constexpr int kT = 256, kRpt = 4; };

template <int W>
int round_up_rows(int Q) {
  constexpr int rows = Variant<W>::kT / 8 * Variant<W>::kRpt;
  return (Q + rows - 1) / rows * rows;
}

template <typename Tin, int W>
int launch(const void* v, const float* ld, const void* k, const void* q, const float* g,
           float* y, float* hadd, float* cum, float* tot, const long long* st, int B, int S,
           int H, int N, int P, int Q, int vec, cudaStream_t stream) {
  constexpr int T = Variant<W>::kT, RPT = Variant<W>::kRpt, ROWS = T / 8 * RPT;
  const int nc = (S + Q - 1) / Q;
  const int Qr = round_up_rows<W>(Q);
  const size_t smem = sizeof(float) * (3 * Qr + ROWS * ld_of(W) + 2 * slot_of(W));
  auto* kern = ssd_chunk_kernel<Tin, T, RPT, W>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(nc, H, B);
  kern<<<grid, T, smem, stream>>>(
      static_cast<const Tin*>(v), ld, static_cast<const Tin*>(k), static_cast<const Tin*>(q), g,
      y, hadd, cum, tot, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], st[12], st[13], st[14], S, H, N, P, Q, Qr, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename Tin>
int dispatch(const void* v, const float* ld, const void* k, const void* q, const float* g,
             float* y, float* hadd, float* cum, float* tot, const long long* st, int B, int S,
             int H, int N, int P, int Q, int vec, cudaStream_t stream) {
  const int w = N > P ? N : P;
  if (w <= 32) return launch<Tin, 32>(v, ld, k, q, g, y, hadd, cum, tot, st, B, S, H, N, P, Q, vec, stream);
  if (w <= 64) return launch<Tin, 64>(v, ld, k, q, g, y, hadd, cum, tot, st, B, S, H, N, P, Q, vec, stream);
  return launch<Tin, 128>(v, ld, k, q, g, y, hadd, cum, tot, st, B, S, H, N, P, Q, vec, stream);
}

template <typename Tin, int W>
int launch_bwd_wide(const float* dy, const float* dh, const float* dcum, const float* dtot,
                    const void* v, const float* ld, const void* k, const void* q,
                    const float* g, void* dv, float* dld, void* dk, void* dq, float* dg,
                    const long long* st, int B, int S, int H, int N, int P, int Q, int vec,
                    cudaStream_t stream) {
  constexpr int T = Variant<W>::kT, RPT = Variant<W>::kRpt, ROWS = T / 8 * RPT;
  const int nc = (S + Q - 1) / Q;
  const int Qr = round_up_rows<W>(Q);
  const size_t smem = sizeof(float) * (6 * Qr + ROWS * ld_of(W) + 2 * slot_of(W));
  auto* kern = ssd_chunk_bwd_wide_kernel<Tin, T, RPT, W>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (2 * B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(nc, H, 2 * B);
  kern<<<grid, T, smem, stream>>>(
      dy, dh, dcum, dtot, static_cast<const Tin*>(v), ld, static_cast<const Tin*>(k),
      static_cast<const Tin*>(q), g, static_cast<Tin*>(dv), dld, static_cast<Tin*>(dk),
      static_cast<Tin*>(dq), dg, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], st[12], st[13], st[14], S, H, N, P, Q, Qr, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename Tin>
int dispatch_bwd(const float* dy, const float* dh, const float* dcum, const float* dtot,
                 const void* v, const float* ld, const void* k, const void* q, const float* g,
                 void* dv, float* dld, void* dk, void* dq, float* dg, const long long* st,
                 int B, int S, int H, int N, int P, int Q, int vec, cudaStream_t stream) {
  const int w = N > P ? N : P;
  if (w <= 64 && Q <= kBwdRows * 2) {   // the one walk's shared memory holds it
    auto* one = w <= 32 ? launch_bwd<Tin, 32> : launch_bwd<Tin, 64>;
    return one(dy, dh, dcum, dtot, v, ld, k, q, g, dv, dld, dk, dq, dg, st, B, S, H, N, P, Q,
               vec, stream);
  }
  auto* wide = w <= 32 ? launch_bwd_wide<Tin, 32>
               : w <= 64 ? launch_bwd_wide<Tin, 64> : launch_bwd_wide<Tin, 128>;
  return wide(dy, dh, dcum, dtot, v, ld, k, q, g, dv, dld, dk, dq, dg, st, B, S, H, N, P, Q, vec,
              stream);
}

// ---------------------------------------------------------------------------
// The wide-head variant (the mLSTM's heads: N = dm / H, P = N + 1, e.g. N 384
// / P 385 at xlstm-125m's width and N 128 / P 129 reduced): any N and P up to
// kWideMax, chunks up to kWQ. The resident-tile design above pads N and P to
// a compile-time width and keeps a 128-row tile of it in shared memory, which
// at W = 384 alone would take 198 KB. Here every product is a sequence of
// 64 x 64 x 64 tile products over 64-wide slices of N and P, staged element
// by element from global memory (rows of 385 floats are not 16-byte aligned;
// columns past N or P read as zero), so shared memory does not grow with N or
// P. y_intra and h_add are linear in v's columns, so each P slice is exact.
// Thread (ty, tx) = (t / 16, t % 16) of kWT owns rows ty + 16 a and columns
// tx + 16 b (a, b < 4) of a tile. A block takes one work item of one (chunk,
// head, batch); each item's sums run in a fixed order, nothing crosses
// blocks, so two launches give the same bits.
//   forward items: y_I for each 64-row tile I of the chunk (the decayed
//     scores of I against every key tile J <= I, over N, kept in a 64 x Q
//     strip, then applied to each P slice of v) with its rows' cum; and
//     h_add for each 64-row slice of N (over every P slice and key tile).
//   backward items, three kinds per 64-row tile T: dq of rows T (scores
//     g_j L_ij (dy_i . v_j) over P, then applied to k over each N slice),
//     dk of rows T (w_j dh v_j, then (L_ij (v_j . dy_i))^T applied to q, times
//     g_j) and du of rows T (w_j dh^T k_j, then (L_ij (k_j . q_i))^T applied
//     to dy; dv = g du, dg = v . du). q . dq, k . dk and w k^T dh u go to a
//     (3, B, S, H) scratch, and a second kernel, one warp a chunk, forms
//     dld as the narrow backward does.
// ---------------------------------------------------------------------------
constexpr int kWT = 256;                  // threads of a wide block
constexpr int kWQ = 256;                  // longest chunk of the wide variant
constexpr int kWideMax = 512;             // largest N and P of the wide variant
constexpr int kOpLd = 65;                 // row stride of a 64 x 64 operand tile
constexpr int kStripLd = kWQ + 4;         // row stride of the 64 x Q score strip
constexpr size_t kWideSmem = sizeof(float) * (2 * kWQ + 64 * kStripLd + 2 * 64 * kOpLd);

// dst[r][c] = x[row0 + r][col0 + c] for r, c < 64 as f32 (kOpLd floats a row),
// zero where row0 + r >= n_rows or col0 + c >= width
template <typename Tin>
__device__ __forceinline__ void wstage(float* dst, const Tin* base, int64_t row_stride, int row0,
                                       int n_rows, int col0, int width) {
  for (int i = threadIdx.x; i < 64 * 64; i += kWT) {
    const int r = i >> 6, c = i & 63;
    float x = 0.f;
    if (row0 + r < n_rows && col0 + c < width)
      x = load1(base + static_cast<int64_t>(row0 + r) * row_stride + col0 + c);
    dst[r * kOpLd + c] = x;
  }
}

__device__ __forceinline__ void wzero(float (&acc)[4][4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
}

// acc[a][b] += sum_kk A[ty + 16 a][kk] B[tx + 16 b][kk] (both kOpLd a row)
__device__ __forceinline__ void mm_nt(float (&acc)[4][4], const float* __restrict__ A,
                                      const float* __restrict__ B) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll 4
  for (int kk = 0; kk < 64; ++kk) {
    float x[4], y[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) x[a] = A[(ty + 16 * a) * kOpLd + kk];
#pragma unroll
    for (int b = 0; b < 4; ++b) y[b] = B[(tx + 16 * b) * kOpLd + kk];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(x[a], y[b], acc[a][b]);
  }
}

// acc[a][b] += sum_kk A[ty + 16 a][kk] V[kk][tx + 16 b] (A lda a row, V kOpLd)
__device__ __forceinline__ void mm_nn(float (&acc)[4][4], const float* __restrict__ A, int lda,
                                      const float* __restrict__ V) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll 4
  for (int kk = 0; kk < 64; ++kk) {
    float x[4], y[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) x[a] = A[(ty + 16 * a) * lda + kk];
#pragma unroll
    for (int b = 0; b < 4; ++b) y[b] = V[kk * kOpLd + tx + 16 * b];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(x[a], y[b], acc[a][b]);
  }
}

// acc[a][b] += sum_kk (A[kk][ty + 16 a] w[kk]) V[kk][tx + 16 b] (both kOpLd)
__device__ __forceinline__ void mm_tn(float (&acc)[4][4], const float* __restrict__ A,
                                      const float* __restrict__ w,
                                      const float* __restrict__ V) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll 4
  for (int kk = 0; kk < 64; ++kk) {
    const float f = w[kk];
    float x[4], y[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) x[a] = A[kk * kOpLd + ty + 16 * a] * f;
#pragma unroll
    for (int b = 0; b < 4; ++b) y[b] = V[kk * kOpLd + tx + 16 * b];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(x[a], y[b], acc[a][b]);
  }
}

// sum over the 16 threads (consecutive lanes) that share a tile row
__device__ __forceinline__ float row16_sum(float x) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// exp(cum_i - cum_j) where j <= i, else 0; masked before the exp
__device__ __forceinline__ float wdecay(const float* cum, int i, int j) {
  return exp2f(j <= i ? (cum[i] - cum[j]) * kLog2e : -INFINITY);
}

template <typename Tin>
__global__ void __launch_bounds__(kWT, 2)
ssd_chunk_wide_kernel(const Tin* __restrict__ v, const float* __restrict__ ld,
                      const Tin* __restrict__ k, const Tin* __restrict__ q,
                      const float* __restrict__ g, float* __restrict__ y,
                      float* __restrict__ hadd, float* __restrict__ cum_out,
                      float* __restrict__ tot_out, int64_t svb, int64_t svs, int64_t svh,
                      int64_t slb, int64_t sls, int64_t slh, int64_t skb, int64_t sks,
                      int64_t skh, int64_t sqb, int64_t sqs, int64_t sqh, int64_t sgb,
                      int64_t sgs, int64_t sgh, int S, int H, int N, int P, int Q, int nI,
                      int nN) {
  extern __shared__ __align__(16) float smem[];
  float* cum = smem;                      // kWQ
  float* gs = cum + kWQ;                  // g: kWQ
  float* strip = gs + kWQ;                // 64 x kStripLd
  float* ta = strip + 64 * kStripLd;      // 64 x kOpLd
  float* tb = ta + 64 * kOpLd;            // 64 x kOpLd
  const int items = nI + nN;
  const int c = blockIdx.x / items, item = blockIdx.x % items;
  const int h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x / items;
  const int s0 = c * Q;
  const int nvalid = S - s0 < Q ? S - s0 : Q;
  const int nIv = (nvalid + 63) / 64;
  const int Qr = nI * 64;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  if (item < nI && item >= nIv) return;   // a tile past the ragged chunk's rows
  const Tin* vb = v + b * svb + static_cast<int64_t>(s0) * svs + h * svh;
  const Tin* kb = k + b * skb + static_cast<int64_t>(s0) * sks + h * skh;
  const Tin* qb = q + b * sqb + static_cast<int64_t>(s0) * sqs + h * sqh;
  load_rows<kWT>(cum, ld + b * slb + static_cast<int64_t>(s0) * sls + h * slh, sls, nvalid, Qr);
  load_rows<kWT>(gs, g + b * sgb + static_cast<int64_t>(s0) * sgs + h * sgh, sgs, nvalid, Qr);
  __syncthreads();
  scan_cum(cum, Qr);
  __syncthreads();
  const float tot = cum[Qr - 1];
  float acc[4][4];

  if (item < nI) {                        // y_intra of rows I
    const int I = item;
    for (int J = 0; J <= I; ++J) {
      wzero(acc);
      for (int n0 = 0; n0 < N; n0 += 64) {
        wstage(ta, qb, sqs, 64 * I, nvalid, n0, N);
        wstage(tb, kb, sks, 64 * J, nvalid, n0, N);
        __syncthreads();
        mm_nt(acc, ta, tb);
        __syncthreads();
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          const int i = 64 * I + ty + 16 * a, j = 64 * J + tx + 16 * bb;
          strip[(ty + 16 * a) * kStripLd + 64 * J + tx + 16 * bb] =
              acc[a][bb] * wdecay(cum, i, j) * gs[j];
        }
    }
    __syncthreads();
    for (int p0 = 0; p0 < P; p0 += 64) {
      wzero(acc);
      for (int J = 0; J <= I; ++J) {
        wstage(ta, vb, svs, 64 * J, nvalid, p0, P);
        __syncthreads();
        mm_nn(acc, strip + 64 * J, kStripLd, ta);
        __syncthreads();
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = 64 * I + ty + 16 * a;
        if (i >= nvalid) continue;
        float* row = y + ((static_cast<int64_t>(b) * S + s0 + i) * H + h) * P;
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          const int p = p0 + tx + 16 * bb;
          if (p < P) row[p] = acc[a][bb];
        }
      }
    }
    for (int r = 64 * I + threadIdx.x; r < 64 * I + 64 && r < nvalid; r += kWT)
      cum_out[(static_cast<int64_t>(b) * S + s0 + r) * H + h] = cum[r];
    if (I == 0 && threadIdx.x == 0) tot_out[(static_cast<int64_t>(b) * nc + c) * H + h] = tot;
    return;
  }

  // h_add rows n0 .. n0 + 63: sum_j (k_j exp(tot - cum_j) g_j) v_j^T, keys in row order
  const int n0 = 64 * (item - nI);
  float* wg = strip;                      // exp(tot - cum) g: Qr
  for (int r = threadIdx.x; r < Qr; r += kWT) wg[r] = expf(tot - cum[r]) * gs[r];
  __syncthreads();
  float* hout = hadd + ((static_cast<int64_t>(b) * nc + c) * H + h) * N * P;
  for (int p0 = 0; p0 < P; p0 += 64) {
    wzero(acc);
    for (int J = 0; J < nIv; ++J) {
      wstage(ta, kb, sks, 64 * J, nvalid, n0, N);
      wstage(tb, vb, svs, 64 * J, nvalid, p0, P);
      __syncthreads();
      mm_tn(acc, ta, wg + 64 * J, tb);
      __syncthreads();
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int n = n0 + ty + 16 * a;
      if (n >= N) continue;
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const int p = p0 + tx + 16 * bb;
        if (p < P) hout[static_cast<int64_t>(n) * P + p] = acc[a][bb];
      }
    }
  }
}

template <typename Tin>
__global__ void __launch_bounds__(kWT, 2)
ssd_chunk_bwd_heads_kernel(const float* __restrict__ dy, const float* __restrict__ dh,
                           const Tin* __restrict__ v, const float* __restrict__ ld,
                           const Tin* __restrict__ k, const Tin* __restrict__ q,
                           const float* __restrict__ g, Tin* __restrict__ dv_out,
                           Tin* __restrict__ dk_out, Tin* __restrict__ dq_out,
                           float* __restrict__ dg_out, float* __restrict__ scratch, int64_t svb,
                           int64_t svs, int64_t svh, int64_t slb, int64_t sls, int64_t slh,
                           int64_t skb, int64_t sks, int64_t skh, int64_t sqb, int64_t sqs,
                           int64_t sqh, int64_t sgb, int64_t sgs, int64_t sgh, int S, int H,
                           int N, int P, int Q, int nI) {
  extern __shared__ __align__(16) float smem[];
  float* cum = smem;                      // kWQ
  float* gs = cum + kWQ;                  // g: kWQ
  float* strip = gs + kWQ;                // 64 x kStripLd
  float* ta = strip + 64 * kStripLd;      // 64 x kOpLd
  float* tb = ta + 64 * kOpLd;            // 64 x kOpLd
  const int items = 3 * nI;
  const int c = blockIdx.x / items, item = blockIdx.x % items;
  const int kind = item / nI, T = item % nI;
  const int h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x / items;
  const int s0 = c * Q;
  const int nvalid = S - s0 < Q ? S - s0 : Q;
  const int nIv = (nvalid + 63) / 64;
  const int Qr = nI * 64;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  if (T >= nIv) return;                   // a tile past the ragged chunk's rows
  const int64_t bsh = static_cast<int64_t>(gridDim.z) * S * H;
  float* qdq = scratch;                   // q . dq
  float* kdk = scratch + bsh;             // k . dk
  float* wts = scratch + 2 * bsh;         // w k^T dh u
  const Tin* vb = v + b * svb + static_cast<int64_t>(s0) * svs + h * svh;
  const Tin* kb = k + b * skb + static_cast<int64_t>(s0) * sks + h * skh;
  const Tin* qb = q + b * sqb + static_cast<int64_t>(s0) * sqs + h * sqh;
  const int64_t dys = static_cast<int64_t>(H) * P;
  const float* dyb = dy + (static_cast<int64_t>(b) * S + s0) * dys + static_cast<int64_t>(h) * P;
  const float* dhb = dh + ((static_cast<int64_t>(b) * nc + c) * H + h) * N * P;
  auto row_at = [&](int r) { return (static_cast<int64_t>(b) * S + s0 + r) * H + h; };
  load_rows<kWT>(cum, ld + b * slb + static_cast<int64_t>(s0) * sls + h * slh, sls, nvalid, Qr);
  load_rows<kWT>(gs, g + b * sgb + static_cast<int64_t>(s0) * sgs + h * sgh, sgs, nvalid, Qr);
  __syncthreads();
  scan_cum(cum, Qr);
  __syncthreads();
  const float tot = cum[Qr - 1];
  float acc[4][4], dot[4] = {0.f, 0.f, 0.f, 0.f}, wdot[4] = {0.f, 0.f, 0.f, 0.f};

  if (kind == 0) {                        // dq_i = sum_{j <= i} g_j L_ij (dy_i . v_j) k_j
    const int I = T;
    for (int J = 0; J <= I; ++J) {
      wzero(acc);
      for (int p0 = 0; p0 < P; p0 += 64) {
        wstage(ta, dyb, dys, 64 * I, nvalid, p0, P);
        wstage(tb, vb, svs, 64 * J, nvalid, p0, P);
        __syncthreads();
        mm_nt(acc, ta, tb);
        __syncthreads();
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          const int i = 64 * I + ty + 16 * a, j = 64 * J + tx + 16 * bb;
          strip[(ty + 16 * a) * kStripLd + 64 * J + tx + 16 * bb] =
              acc[a][bb] * wdecay(cum, i, j) * gs[j];
        }
    }
    __syncthreads();
    for (int n0 = 0; n0 < N; n0 += 64) {
      wzero(acc);
      for (int J = 0; J <= I; ++J) {
        wstage(ta, kb, sks, 64 * J, nvalid, n0, N);
        __syncthreads();
        mm_nn(acc, strip + 64 * J, kStripLd, ta);
        __syncthreads();
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = 64 * I + ty + 16 * a;
        if (i >= nvalid) continue;
        Tin* row = dq_out + row_at(i) * N;
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          const int n = n0 + tx + 16 * bb;
          if (n < N) {
            store(row + n, acc[a][bb]);
            dot[a] = fmaf(load1(qb + static_cast<int64_t>(i) * sqs + n), acc[a][bb], dot[a]);
          }
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = 64 * I + ty + 16 * a;
      const float s = row16_sum(dot[a]);
      if (tx == 0 && i < nvalid) qdq[row_at(i)] = s;
    }
    return;
  }

  // dk (kind 1) and du (kind 2) of rows j of tile T, against the query
  // tiles I >= T: the strip holds L_ij (v_j . dy_i) (dk) or L_ij (k_j . q_i)
  // (du) at row j, column 64 (I - T) + i
  const int J = T;
  const bool dk = kind == 1;
  for (int I = J; I < nIv; ++I) {
    wzero(acc);
    const int width = dk ? P : N;
    for (int x0 = 0; x0 < width; x0 += 64) {
      if (dk) {
        wstage(ta, vb, svs, 64 * J, nvalid, x0, P);
        wstage(tb, dyb, dys, 64 * I, nvalid, x0, P);
      } else {
        wstage(ta, kb, sks, 64 * J, nvalid, x0, N);
        wstage(tb, qb, sqs, 64 * I, nvalid, x0, N);
      }
      __syncthreads();
      mm_nt(acc, ta, tb);
      __syncthreads();
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const int j = 64 * J + ty + 16 * a, i = 64 * I + tx + 16 * bb;
        strip[(ty + 16 * a) * kStripLd + 64 * (I - J) + tx + 16 * bb] =
            acc[a][bb] * wdecay(cum, i, j);
      }
  }
  __syncthreads();
  float wj[4], gj[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int j = 64 * J + ty + 16 * a;
    wj[a] = expf(tot - cum[j]);
    gj[a] = gs[j];
  }
  const int width = dk ? N : P;           // the output's columns
  for (int o0 = 0; o0 < width; o0 += 64) {
    wzero(acc);
    if (dk) {                             // w_j dh v_j: sum_p v_j[p] dh[n][p]
      for (int p0 = 0; p0 < P; p0 += 64) {
        wstage(ta, vb, svs, 64 * J, nvalid, p0, P);
        wstage(tb, dhb, P, o0, N, p0, P);
        __syncthreads();
        mm_nt(acc, ta, tb);
        __syncthreads();
      }
    } else {                              // w_j dh^T k_j: sum_n k_j[n] dh[n][p]
      for (int n0 = 0; n0 < N; n0 += 64) {
        wstage(ta, kb, sks, 64 * J, nvalid, n0, N);
        wstage(tb, dhb, P, n0, N, o0, P);
        __syncthreads();
        mm_nn(acc, ta, kOpLd, tb);
        __syncthreads();
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int j = 64 * J + ty + 16 * a;
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        acc[a][bb] *= wj[a];
        const int n = o0 + tx + 16 * bb;
        if (dk && j < nvalid && n < N)
          wdot[a] = fmaf(load1(kb + static_cast<int64_t>(j) * sks + n), acc[a][bb], wdot[a]);
      }
    }
    for (int I = J; I < nIv; ++I) {
      if (dk) wstage(ta, qb, sqs, 64 * I, nvalid, o0, N);
      else wstage(ta, dyb, dys, 64 * I, nvalid, o0, P);
      __syncthreads();
      mm_nn(acc, strip + 64 * (I - J), kStripLd, ta);
      __syncthreads();
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int j = 64 * J + ty + 16 * a;
      if (j >= nvalid) continue;
      Tin* row = (dk ? dk_out + row_at(j) * N : dv_out + row_at(j) * P);
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const int o = o0 + tx + 16 * bb;
        if (o >= width) continue;
        if (dk) {                         // dk = g_j (w_j dh v_j + sum_i ...); k . dk
          const float d = gj[a] * acc[a][bb];
          store(row + o, d);
          dot[a] = fmaf(load1(kb + static_cast<int64_t>(j) * sks + o), d, dot[a]);
        } else {                          // dv = g_j du; dg = v . du
          store(row + o, gj[a] * acc[a][bb]);
          dot[a] = fmaf(load1(vb + static_cast<int64_t>(j) * svs + o), acc[a][bb], dot[a]);
        }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int j = 64 * J + ty + 16 * a;
    const float s = row16_sum(dot[a]);
    const float w = row16_sum(wdot[a]);
    if (tx == 0 && j < nvalid) {
      if (dk) {
        kdk[row_at(j)] = s;
        wts[row_at(j)] = gj[a] * w;
      } else {
        dg_out[row_at(j)] = s;
      }
    }
  }
}

// dld of the wide backward: one warp per (chunk, head, batch), as the
// narrow backward's last step, from the scratch's q . dq, k . dk and w k^T dh u
__global__ void __launch_bounds__(32)
ssd_chunk_bwd_dld_kernel(const float* __restrict__ dcum, const float* __restrict__ dtot,
                         const float* __restrict__ scratch, float* __restrict__ dld_out, int S,
                         int H, int Q) {
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  const int lane = threadIdx.x;
  const int s0 = c * Q;
  const int nvalid = S - s0 < Q ? S - s0 : Q;
  const int64_t bsh = static_cast<int64_t>(gridDim.z) * S * H;
  const int64_t at = (static_cast<int64_t>(b) * S + s0) * H + h;
  const float* qdq = scratch + at;
  const float* kdk = scratch + bsh + at;
  const float* wt = scratch + 2 * bsh + at;
  const float* dcb = dcum + at;
  float wsum = 0.f;
  for (int r = lane; r < nvalid; r += 32) wsum += wt[static_cast<int64_t>(r) * H];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) wsum += __shfl_xor_sync(0xffffffffu, wsum, off);
  const float dt = dtot[(static_cast<int64_t>(b) * nc + c) * H + h];
  float carry = 0.f;
  for (int base = (nvalid - 1) / 32 * 32; base >= 0; base -= 32) {
    const int r = base + 31 - lane;       // lane 0 takes the chunk's last row
    float x = 0.f;
    if (r < nvalid) {
      const int64_t o = static_cast<int64_t>(r) * H;
      x = dcb[o] + qdq[o] - kdk[o];
      if (r == nvalid - 1) x += dt + wsum;
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, x, off);
      if (lane >= off) x += up;
    }
    x += carry;
    if (r < nvalid) dld_out[at + static_cast<int64_t>(r) * H] = x;
    carry = __shfl_sync(0xffffffffu, x, 31);
  }
}

template <typename Tin>
int launch_wide(const void* v, const float* ld, const void* k, const void* q, const float* g,
                float* y, float* hadd, float* cum, float* tot, const long long* st, int B,
                int S, int H, int N, int P, int Q, cudaStream_t stream) {
  const int nc = (S + Q - 1) / Q;
  const int nI = (Q + 63) / 64, nN = (N + 63) / 64;
  auto* kern = ssd_chunk_wide_kernel<Tin>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kWideSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(nc * (nI + nN), H, B);
  kern<<<grid, kWT, kWideSmem, stream>>>(
      static_cast<const Tin*>(v), ld, static_cast<const Tin*>(k), static_cast<const Tin*>(q), g,
      y, hadd, cum, tot, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], st[12], st[13], st[14], S, H, N, P, Q, nI, nN);
  return static_cast<int>(cudaGetLastError());
}

template <typename Tin>
int launch_bwd_heads(const float* dy, const float* dh, const float* dcum, const float* dtot,
                     const void* v, const float* ld, const void* k, const void* q,
                     const float* g, void* dv, float* dld, void* dk, void* dq, float* dg,
                     float* scratch, const long long* st, int B, int S, int H, int N, int P,
                     int Q, cudaStream_t stream) {
  const int nc = (S + Q - 1) / Q;
  const int nI = (Q + 63) / 64;
  auto* kern = ssd_chunk_bwd_heads_kernel<Tin>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kWideSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<dim3(nc * 3 * nI, H, B), kWT, kWideSmem, stream>>>(
      dy, dh, static_cast<const Tin*>(v), ld, static_cast<const Tin*>(k),
      static_cast<const Tin*>(q), g, static_cast<Tin*>(dv), static_cast<Tin*>(dk),
      static_cast<Tin*>(dq), dg, scratch, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11], st[12], st[13], st[14], S, H, N, P, Q, nI);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_chunk_bwd_dld_kernel<<<dim3(nc, H, B), 32, 0, stream>>>(dcum, dtot, scratch, dld, S, H, Q);
  return static_cast<int>(cudaGetLastError());
}

// Whether (N, P) take the resident-tile variants (multiples of 8 up to 128)
// or the wide one
bool narrow_heads(int N, int P) {
  return N % 8 == 0 && P % 8 == 0 && N >= 8 && P >= 8 && N <= 128 && P <= 128;
}

bool heads_ok(int N, int P, int Q) {
  return narrow_heads(N, P) ||
         (N >= 1 && P >= 1 && N <= kWideMax && P <= kWideMax && Q <= kWQ);
}

bool fits_int(long long x) { return x >= 0 && x <= 0x7fffffffLL; }

}  // namespace

extern "C" {

// dtype 0: f32, 1: bf16 (of v, k and q; ld and g are f32). Strides are in
// elements, (batch, sequence, head) of v, ld, k, q and g in that order; the
// last axis of v, k and q is contiguous. vec 1 when every row of v, k and q
// starts 16-byte aligned (the wide variant ignores it). N and P multiples of
// 8 up to 128 take the resident-tile variants, any other N and P up to
// kWideMax the wide one, whose chunks are at most kWQ.
int ssd_chunk_scan_launch(const void* v, const float* ld, const void* k, const void* q,
                          const float* g, float* y, float* hadd, float* cum, float* tot,
                          long long svb, long long svs, long long svh, long long slb,
                          long long sls, long long slh, long long skb, long long sks,
                          long long skh, long long sqb, long long sqs, long long sqh,
                          long long sgb, long long sgs, long long sgh, int B, int S, int H,
                          int N, int P, int Q, int dtype, int vec, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!heads_ok(N, P, Q) || Q < 1 || !fits_int(svs) || !fits_int(sks) || !fits_int(sqs) ||
      !fits_int(1LL * H * P))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[15] = {svb, svs, svh, slb, sls, slh, skb, sks, skh,
                            sqb, sqs, sqh, sgb, sgs, sgh};
  auto s = static_cast<cudaStream_t>(stream);
  if (!narrow_heads(N, P)) {
    if (dtype == 0)
      return launch_wide<float>(v, ld, k, q, g, y, hadd, cum, tot, st, B, S, H, N, P, Q, s);
    if (dtype == 1)
      return launch_wide<__nv_bfloat16>(v, ld, k, q, g, y, hadd, cum, tot, st, B, S, H, N, P,
                                        Q, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
// `scratch`, (3, B, S, H) f32, is used by the wide variant only (null
// otherwise).
int ssd_chunk_scan_bwd_launch(const float* dy, const float* dh, const float* dcum,
                              const float* dtot, const void* v, const float* ld, const void* k,
                              const void* q, const float* g, void* dv, float* dld, void* dk,
                              void* dq, float* dg, long long svb, long long svs, long long svh,
                              long long slb, long long sls, long long slh, long long skb,
                              long long sks, long long skh, long long sqb, long long sqs,
                              long long sqh, long long sgb, long long sgs, long long sgh, int B,
                              int S, int H, int N, int P, int Q, int dtype, int vec, int device,
                              void* stream, float* scratch) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!heads_ok(N, P, Q) || Q < 1 || !fits_int(svs) || !fits_int(sks) || !fits_int(sqs) ||
      !fits_int(1LL * H * P))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[15] = {svb, svs, svh, slb, sls, slh, skb, sks, skh,
                            sqb, sqs, sqh, sgb, sgs, sgh};
  auto s = static_cast<cudaStream_t>(stream);
  if (!narrow_heads(N, P)) {
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    if (dtype == 0)
      return launch_bwd_heads<float>(dy, dh, dcum, dtot, v, ld, k, q, g, dv, dld, dk, dq, dg,
                                     scratch, st, B, S, H, N, P, Q, s);
    if (dtype == 1)
      return launch_bwd_heads<__nv_bfloat16>(dy, dh, dcum, dtot, v, ld, k, q, g, dv, dld, dk,
                                             dq, dg, scratch, st, B, S, H, N, P, Q, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0)
    return dispatch_bwd<float>(dy, dh, dcum, dtot, v, ld, k, q, g, dv, dld, dk, dq, dg, st, B,
                               S, H, N, P, Q, vec, s);
  if (dtype == 1)
    return dispatch_bwd<__nv_bfloat16>(dy, dh, dcum, dtot, v, ld, k, q, g, dv, dld, dk, dq, dg,
                                       st, B, S, H, N, P, Q, vec, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
