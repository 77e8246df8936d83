// Hopper (sm_90a) kernel of flash attention (forward), bound to Python with
// ctypes (plain C entry point; pointers and the stream arrive as void*).
//
// flash_attention replaces src/repro/kernels/flash_attention/kernel.py:
//            _flash_kernel / flash_attention_bhsd. For each query row it
//            computes softmax(q k^T * hd^-0.5, masked) v with an online
//            softmax over tiles of keys: scores masked to -1e30 (causal:
//            key <= query; window w: query - key < w), running max m, sum l
//            and accumulator acc in f32, and o = acc / max(l, 1e-30) at the
//            end, in the input's dtype. The scale is that of the real hd.
//
// What the TPU wrapper does that this kernel does not need: it repeats the
// kv heads for GQA, transposes to (B, H, S, hd), pads hd to 128 and pads S
// to the block. Here the kernel reads q (B, S, H, hd) and k, v (B, Skv, Kv,
// hd) through their strides, takes kv head h / (H / Kv), takes hd as it is
// (a multiple of 8 up to 128) and masks the ragged tails of S and Skv.
//
// Bound: operations. At zamba2's prefill (B 2, S 4096, H 32, hd 80,
// causal) the two products are 4 B H hd S (S + 1) / 2 = 172 GFLOP, 2.6 ms
// at 67 TFLOP/s of f32 outside the tensor cores, against 0.1 ms for the
// 336 MB of q, k, v and o. f32 inputs are computed in full f32 (no TF32),
// bf16 inputs are widened to f32 as they are staged.
//
// Design: one block of 128 threads per (64 query rows, head, batch). The
// query tile is staged in shared memory once; the loop over 64-key tiles
// starts and ends where the causal and window masks of the tile's rows
// allow, so key tiles wholly outside them are never loaded (the TPU kernel
// skips them with pl.when on its fourth grid axis). Each key tile and its
// value tile are staged in shared memory (rows padded to hd + 1 words so
// that the column walks of the score product hit distinct banks). Thread t
// owns query rows 4 (t / 8) .. + 3 and, of the 64 keys, columns t % 8 + 8 j:
// 32 scores, and for the output the head-dim columns t % 8 + 8 j, so m, l
// and acc (4 x hd / 8 values) stay in registers; a row's max and sum are
// reduced over its 8 threads with warp shuffles. The probabilities go
// through shared memory (over the key tile, which is no longer read) into
// the product with the value tile. Plain FMAs, no tensor cores: a first
// kernel that is right; wgmma, TMA and pipelining are later work.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 64;                 // query rows per block and keys per tile
constexpr int kPStride = kTile + 1;       // row stride of the probability tile
constexpr float kNegInf = -1e30f;

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

// Stage rows row0 .. row0 + 63 (of `n_rows`; zeros past it) of a (rows, hd)
// matrix with row stride `row_stride` into shared memory as f32, `ld`
// floats apart. Eight elements per thread per step.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int ld, const T* base, int64_t row_stride,
                                      int row0, int n_rows, int hd, bool vec) {
  const int chunks = hd >> 3;
  for (int c = threadIdx.x; c < kTile * chunks; c += kThreads) {
    const int r = c / chunks;
    const int d0 = (c - r * chunks) << 3;
    float* out = dst + r * ld + d0;
    if (row0 + r < n_rows) {
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

// max and sum over the 8 threads (consecutive lanes) that share a row
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// NJ: the most head-dim columns per thread (hd / 8 <= NJ)
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       int64_t sqb, int64_t sqs, int64_t sqh, int64_t skb, int64_t sks,
                       int64_t skh, int64_t svb, int64_t svs, int64_t svh,
                       int S, int Skv, int H, int G, int hd, int causal, int window,
                       int vec, float scale) {
  extern __shared__ float smem[];
  const int ld = hd + 1;
  float* qs = smem;                                  // kTile x ld
  float* kps = qs + kTile * ld;                      // keys (kTile x ld), then p (kTile x kPStride)
  float* vs = kps + kTile * (ld > kPStride ? ld : kPStride);   // kTile x hd
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * kTile;
  const int rg = threadIdx.x >> 3, cg = threadIdx.x & 7;
  const int nj = hd >> 3;

  const T* qb = q + b * sqb + h * sqh;
  const T* kb = k + b * skb + (h / G) * skh;
  const T* vb = v + b * svb + (h / G) * svh;
  stage(qs, ld, qb, sqs, q0, S, hd, vec);

  // key tiles that any row of this query tile can see
  int kv_end = Skv;
  if (causal && q0 + kTile < kv_end) kv_end = q0 + kTile;
  int kv_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kv_begin = (q0 - window + 1) / kTile * kTile;

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  for (int j0 = kv_begin; j0 < kv_end; j0 += kTile) {
    __syncthreads();                     // the previous tile's p and values are consumed
    stage(kps, ld, kb, sks, j0, Skv, hd, vec);
    stage(vs, hd, vb, svs, j0, Skv, hd, vec);
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    for (int d0 = 0; d0 < hd; d0 += 8) {
#pragma unroll
      for (int dd = 0; dd < 8; ++dd) {
        const int d = d0 + dd;
        float qv[4], kv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = qs[(4 * rg + i) * ld + d];
#pragma unroll
        for (int j = 0; j < 8; ++j) kv[j] = kps[(cg + 8 * j) * ld + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + 4 * rg + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kj = j0 + cg + 8 * j;
        bool ok = kj < Skv;
        if (causal) ok = ok && kj <= qi;
        if (window > 0) ok = ok && qi - kj < window;
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + row_sum(sum);
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
      m[i] = m_new;
    }

    __syncthreads();                     // every thread is done with the keys
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) kps[(4 * rg + i) * kPStride + cg + 8 * j] = s[i][j];
    __syncthreads();

    for (int kk = 0; kk < kTile; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = kps[(4 * rg + i) * kPStride + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (j < nj) {
          const float vv = vs[kk * hd + cg + 8 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * rg + i;
    if (qi < S) {
      const float den = fmaxf(l[i], 1e-30f);
      T* row = o + ((static_cast<int64_t>(b) * S + qi) * H + h) * hd;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        if (j < nj) store(row + cg + 8 * j, acc[i][j] / den);
    }
  }
}

template <typename T, int NJ>
int launch(const void* q, const void* k, const void* v, void* o, const long long* st,
           int B, int S, int Skv, int H, int Kv, int hd, int causal, int window, int vec,
           float scale, cudaStream_t stream) {
  const int ld = hd + 1;
  const size_t smem =
      sizeof(float) * (kTile * ld + kTile * (ld > kPStride ? ld : kPStride) + kTile * hd);
  auto* kern = flash_attention_kernel<T, NJ>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], S, Skv,
      H, H / Kv, hd, causal, window, vec, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, const long long* st, int B,
             int S, int Skv, int H, int Kv, int hd, int causal, int window, int vec,
             float scale, cudaStream_t stream) {
  const int nj = hd / 8;
  if (nj <= 4)
    return launch<T, 4>(q, k, v, o, st, B, S, Skv, H, Kv, hd, causal, window, vec, scale, stream);
  if (nj <= 8)
    return launch<T, 8>(q, k, v, o, st, B, S, Skv, H, Kv, hd, causal, window, vec, scale, stream);
  if (nj <= 10)
    return launch<T, 10>(q, k, v, o, st, B, S, Skv, H, Kv, hd, causal, window, vec, scale, stream);
  return launch<T, 16>(q, k, v, o, st, B, S, Skv, H, Kv, hd, causal, window, vec, scale, stream);
}

}  // namespace

extern "C" {

// dtype 0: f32, 1: bf16. Strides are in elements: (batch, sequence, head)
// of q, then of k, then of v; the head_dim axis is contiguous. window 0 is
// no window; vec 1 when every row of q, k and v starts 16-byte aligned.
// `scale` is hd^-0.5 as the caller rounds it to f32.
int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                           long long sqb, long long sqs, long long sqh, long long skb,
                           long long sks, long long skh, long long svb, long long svs,
                           long long svh, int B, int S, int Skv, int H, int Kv, int hd,
                           int causal, int window, int dtype, int vec, float scale, int device,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (hd % 8 != 0 || hd < 8 || hd > 128 || Kv < 1 || H % Kv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[9] = {sqb, sqs, sqh, skb, sks, skh, svb, svs, svh};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, st, B, S, Skv, H, Kv, hd, causal, window, vec, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, st, B, S, Skv, H, Kv, hd, causal, window, vec,
                                   scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
