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
// Design, a SIMT GEMM's register blocking around the online softmax. One
// block of 128 threads per (head, batch, 128 query rows); the query tiles
// run heaviest first under the causal mask (the last rows see the most
// keys, so the grid's last wave is the lightest). Thread t (row group
// rg = t / 8, column group cg = t % 8) owns query rows rg + 16 a and keys
// cg + 8 b of each 64-key tile, a, b < 8: an 8 x 8 register tile of scores.
// hd is a template parameter, padded with zeros to the variant's width HDP
// (32, 64, 80 or 128; zamba2's 80 and yi-6b's 128 run unpadded), so every
// shared-memory offset is a constant. q k^T walks hd two at a time: per
// step 8 float2 loads of the rows' q and 8 of the keys' k feed 128 FMAs (8
// FMAs per shared-memory load; float4 steps, 16 FMAs per load, ran 4 to 6%
// slower on the H100: more registers held for the loads at 255 in use).
// The Q and K tiles are stored row-major with a row stride of HDP + 4
// floats, so the 8 rows that 8 neighbouring lanes read at one column fall
// in 8 distinct pairs of banks. The probabilities stay in registers: for
// key kk of the tile, the row's 8 threads hold p in register kk / 8 of
// lane kk % 8, and one shuffle per row hands it to all 8; each thread then
// multiplies it into its 8 rows x 2 NV output columns (NV = HDP / 16
// float2 pairs at 2 (cg + 8 t): 8 lanes read 64 contiguous bytes of the
// value row), 80 FMAs per 5 loads and 8 shuffles at hd 80. m, l and the
// 8 x 2 NV accumulators stay in registers; a row's max and sum are reduced
// over its 8 lanes with shuffles. exp2f on scores pre-scaled by
// hd^-0.5 * log2(e). What is left of the bound is the shared-memory pipe:
// each load or shuffle instruction of a warp takes it one cycle per 16 (or
// 32) lanes, about one cycle per 4 FMA cycles of the warps it serves.
//
// The copies overlap the arithmetic: the K and V tiles form a two-slot
// ring filled by 16-byte cp.async (zero-filled past Skv and hd). The next
// tile's keys are in flight while this tile's softmax and p v run, and its
// values while the next tile's q k^T runs; one commit group per copy, and
// cp.async.wait_group 1 before each use. Shared memory is the Q tile and
// the two slots, 85 KB at hd 80, so two blocks (8 warps) fit an SM.
// bf16 inputs, and rows that are not 16-byte aligned, are staged through
// registers instead (widened to f32), into the same ring.
//
// Plain FMAs in f32, no tensor cores: TF32 or bf16 wgmma would change the
// numbers of an f32 model with TF32 off, which is the model's decision.

#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 128;                // query rows per block: 16 row groups x 8
constexpr int kKeys = 64;                 // keys per tile: 8 column groups x 8
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// row stride of the Q and K tiles, in floats: for every variant's width, 8
// consecutive rows start in 8 distinct even banks
__host__ __device__ constexpr int qk_ld(int hd) { return hd + 4; }

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

// Stage rows row0 .. row0 + ROWS - 1 of a (rows, hd) matrix with row
// stride `row_stride` into shared memory as f32, LD floats apart and HDP
// wide: zeros from row n_rows on and from column hd on. f32 rows that
// start 16-byte aligned go by cp.async (the caller commits and waits); the
// rest are loaded, widened and stored by the threads themselves.
template <int ROWS, int HDP, int LD, typename T>
__device__ __forceinline__ void stage(float* dst, const T* base, int64_t row_stride, int row0,
                                      int n_rows, int hd, bool vec) {
  if constexpr (std::is_same<T, float>::value) {
    if (vec) {
      constexpr int chunks = HDP / 4;
      for (int c = threadIdx.x; c < ROWS * chunks; c += kThreads) {
        const int r = c / chunks;
        const int d0 = (c - r * chunks) * 4;
        const bool ok = row0 + r < n_rows && d0 < hd;
        const float* src = ok ? base + static_cast<int64_t>(row0 + r) * row_stride + d0 : base;
        cp_async16(dst + r * LD + d0, src, ok);
      }
      return;
    }
  }
  constexpr int chunks = HDP / 8;
  for (int c = threadIdx.x; c < ROWS * chunks; c += kThreads) {
    const int r = c / chunks;
    const int d0 = (c - r * chunks) * 8;
    float* out = dst + r * LD + d0;
    if (row0 + r < n_rows && d0 < hd) {
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

// One key tile's online-softmax step for the thread's 8 rows: scores
// scaled to log2 units (masked ones to -1e30), the running max and sum
// updated over the row's 8 lanes, the accumulators rescaled, and s
// replaced by p = exp2(s - m).
template <int NV>
__device__ __forceinline__ void online_softmax(float (&s)[8][8], float (&m)[8], float (&l)[8],
                                               float2 (&acc)[8][NV], int q0, int j0, int rg,
                                               int cg, int Skv, int causal, int window,
                                               float scale2) {
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int qi = q0 + rg + 16 * a;
    float mx = kNegInf;
#pragma unroll
    for (int bb = 0; bb < 8; ++bb) {
      const int kj = j0 + cg + 8 * bb;
      bool ok = kj < Skv;
      if (causal) ok = ok && kj <= qi;
      if (window > 0) ok = ok && qi - kj < window;
      s[a][bb] = ok ? s[a][bb] * scale2 : kNegInf;
      mx = fmaxf(mx, s[a][bb]);
    }
    const float m_new = fmaxf(m[a], row_max(mx));
    float sum = 0.f;
#pragma unroll
    for (int bb = 0; bb < 8; ++bb) {
      s[a][bb] = exp2f(s[a][bb] - m_new);
      sum += s[a][bb];
    }
    const float corr = exp2f(m[a] - m_new);
    l[a] = l[a] * corr + row_sum(sum);
#pragma unroll
    for (int t = 0; t < NV; ++t) {
      acc[a][t].x *= corr;
      acc[a][t].y *= corr;
    }
    m[a] = m_new;
  }
}

// HDP: hd padded to the variant's width (zeros past hd in every tile);
// each thread keeps NV = HDP / 16 float2 output columns
template <typename T, int HDP>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       int64_t sqb, int64_t sqs, int64_t sqh, int64_t skb, int64_t sks,
                       int64_t skh, int64_t svb, int64_t svs, int64_t svh,
                       int S, int Skv, int H, int G, int hd, int causal, int window,
                       int vec, float scale) {
  constexpr int NV = HDP / 16;
  constexpr int LD = qk_ld(HDP);
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                                  // kRows x LD
  float* ks = qs + kRows * LD;                       // the ring's key slot: kKeys x LD
  float* vs = ks + kKeys * LD;                       // the ring's value slot: kKeys x HDP
  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;   // heaviest first
  const int q0 = qt * kRows;
  const int lane = threadIdx.x & 31;
  const int rg = threadIdx.x >> 3, cg = threadIdx.x & 7;
  const float scale2 = scale * kLog2e;               // scores in log2 units

  const T* qb = q + b * sqb + h * sqh;
  const T* kb = k + b * skb + (h / G) * skh;
  const T* vb = v + b * svb + (h / G) * svh;

  // key tiles that any row of this query tile can see
  int kv_end = Skv;
  if (causal && q0 + kRows < kv_end) kv_end = q0 + kRows;
  int kv_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kv_begin = (q0 - window + 1) / kKeys * kKeys;

  float m[8], l[8];
  float2 acc[8][NV];
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    m[a] = kNegInf;
    l[a] = 0.f;
#pragma unroll
    for (int t = 0; t < NV; ++t) acc[a][t] = make_float2(0.f, 0.f);
  }

  // prologue: group 1 the queries and the first keys, group 2 the first values
  stage<kRows, HDP, LD>(qs, qb, sqs, q0, S, hd, vec);
  if (kv_begin < kv_end) stage<kKeys, HDP, LD>(ks, kb, sks, kv_begin, Skv, hd, vec);
  cp_async_commit();
  if (kv_begin < kv_end) stage<kKeys, HDP, HDP>(vs, vb, svs, kv_begin, Skv, hd, vec);
  cp_async_commit();

  for (int j0 = kv_begin; j0 < kv_end; j0 += kKeys) {
    const bool more = j0 + kKeys < kv_end;
    cp_async_wait<1>();                  // this tile's keys (and the queries) have landed
    __syncthreads();

    float s[8][8];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int bb = 0; bb < 8; ++bb) s[a][bb] = 0.f;
    const float* qrow = qs + rg * LD;
    const float* krow = ks + cg * LD;
#pragma unroll 2
    for (int d = 0; d < HDP; d += 2) {
      float2 qv[8];
#pragma unroll
      for (int a = 0; a < 8; ++a) qv[a] = *reinterpret_cast<const float2*>(qrow + 16 * a * LD + d);
#pragma unroll
      for (int bb = 0; bb < 8; ++bb) {
        const float2 kv = *reinterpret_cast<const float2*>(krow + 8 * bb * LD + d);
#pragma unroll
        for (int a = 0; a < 8; ++a) {
          s[a][bb] = fmaf(qv[a].x, kv.x, s[a][bb]);
          s[a][bb] = fmaf(qv[a].y, kv.y, s[a][bb]);
        }
      }
    }
    __syncthreads();                     // every thread is done with the key slot
    if (more) stage<kKeys, HDP, LD>(ks, kb, sks, j0 + kKeys, Skv, hd, vec);
    cp_async_commit();

    online_softmax(s, m, l, acc, q0, j0, rg, cg, Skv, causal, window, scale2);

    cp_async_wait<1>();                  // this tile's values have landed
    __syncthreads();
    const int src0 = lane & 24;          // lane of column group 0 in this row group
#pragma unroll
    for (int bb = 0; bb < 8; ++bb) {
#pragma unroll
      for (int c8 = 0; c8 < 8; ++c8) {
        // key c8 + 8 bb: register bb of lane c8
        const float* vrow = vs + (c8 + 8 * bb) * HDP + 2 * cg;
        float p[8];
#pragma unroll
        for (int a = 0; a < 8; ++a) p[a] = __shfl_sync(0xffffffffu, s[a][bb], src0 | c8);
#pragma unroll
        for (int t = 0; t < NV; ++t) {
          const float2 vv = *reinterpret_cast<const float2*>(vrow + 16 * t);
#pragma unroll
          for (int a = 0; a < 8; ++a) {
            acc[a][t].x = fmaf(p[a], vv.x, acc[a][t].x);
            acc[a][t].y = fmaf(p[a], vv.y, acc[a][t].y);
          }
        }
      }
    }
    __syncthreads();                     // every thread is done with the value slot
    if (more) stage<kKeys, HDP, HDP>(vs, vb, svs, j0 + kKeys, Skv, hd, vec);
    cp_async_commit();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int qi = q0 + rg + 16 * a;
    if (qi < S) {
      const float den = fmaxf(l[a], 1e-30f);
      T* row = o + ((static_cast<int64_t>(b) * S + qi) * H + h) * hd;
#pragma unroll
      for (int t = 0; t < NV; ++t) {
        const int col = 2 * (cg + 8 * t);
        if (col < hd) {
          store(row + col, acc[a][t].x / den);
          store(row + col + 1, acc[a][t].y / den);
        }
      }
    }
  }
}

template <typename T, int HDP>
int launch(const void* q, const void* k, const void* v, void* o, const long long* st,
           int B, int S, int Skv, int H, int Kv, int hd, int causal, int window, int vec,
           float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((kRows + kKeys) * qk_ld(HDP) + kKeys * HDP);
  auto* kern = flash_attention_kernel<T, HDP>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, B, (S + kRows - 1) / kRows);
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
  // hd as it is at 32, 64, 80 and 128; padded with zeros up to the next
  // of them otherwise
  if (hd <= 32)
    return launch<T, 32>(q, k, v, o, st, B, S, Skv, H, Kv, hd, causal, window, vec, scale, stream);
  if (hd <= 64)
    return launch<T, 64>(q, k, v, o, st, B, S, Skv, H, Kv, hd, causal, window, vec, scale, stream);
  if (hd <= 80)
    return launch<T, 80>(q, k, v, o, st, B, S, Skv, H, Kv, hd, causal, window, vec, scale, stream);
  return launch<T, 128>(q, k, v, o, st, B, S, Skv, H, Kv, hd, causal, window, vec, scale,
                        stream);
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
  if (hd % 8 != 0 || hd < 8 || hd > 128 || Kv < 1 || H % Kv != 0 || B > 65535 ||
      (S + kRows - 1) / kRows > 65535)
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
