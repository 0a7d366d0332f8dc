// Exit-head confidence (max softmax probability) and argmax, for Hopper
// (sm_90a): two kernels from one template.
//
// Replaces: src/repro/kernels/exit_confidence/kernel.py
//   * exit_confidence_pallas (pl.pallas_call at :119): h (B, D) @ w (D, V)
//     -> conf = max_c softmax(h w)_c (f32), pred = argmax (i32), by an
//     online (max, sum-exp, argmax) over vocab columns, never writing the
//     (B, V) logits;
//   * exit_confidence_fused_pallas (pl.pallas_call at :219): the same
//     after an rms/layer norm of the RAW pooled hidden with shared (1, D)
//     or per-row (B, D) parameters, the normed row cast to the activation
//     dtype and back (as the unfused path's apply_norm does), and a head
//     bias added to the logits — one launch for norm + head + softmax.
//   A leading group axis G runs G independent heads in one launch (the
//   JAX package vmaps the Pallas call over the per-layer exit heads).
//
// Kept semantics: ties go to the LOWEST vocab index. Each thread (each
// warp, for a small head) walks its own columns in increasing order and
// takes a new argmax only on a strict improvement; the block then combines threads (and the second
// pass combines vocab splits) by max, taking the smaller index on an
// equal max. Together that is the global first-occurrence argmax, the
// rule the TPU kernel pins with its strict cross-tile update. Columns
// past V are never visited (the TPU kernel masks its padded tile to
// -1e30, which contributes nothing), so V = 2 and V = 151936 both work.
//
// What bounds it on the H100: the serving shape (B = 32, D = 768, V = 2)
// reads ~52 KB and does ~0.1 MFLOP: about 16 ns of memory time, so the
// launch itself (a few microseconds) is the bound, and the design keeps
// it to ONE launch per call (the fused form also absorbs the norm's
// launches) and, for such a small head, splits each dot product over a
// warp's lanes so no thread walks D alone. For a large vocabulary the bound is reading W (D*V
// elements) once per row tile; the grid then splits the vocabulary over
// enough blocks to cover the SMs and a small second kernel combines the
// per-split (max, sum, argmax) triples. The row tile (8 rows, f32, in
// shared memory) is read as a broadcast while each thread streams one
// column of W, so W reads are coalesced across the warp. CUDA cores in
// f32; no wgmma/TMA yet.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = kWarps;          // rows per block: one warp per row in the norm
constexpr float kNegInf = -1e30f;
constexpr float kNormEps = 1e-6f;      // repro models.common rmsnorm/layernorm eps
constexpr int kNoArg = INT_MAX;
constexpr int kSmallVocab = 64;        // up to this V: a warp per column

constexpr int kNormNone = 0;
constexpr int kNormRms = 1;
constexpr int kNormLayer = 2;

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Params {
  const void* h;        // (G, B, D), strides (h_sg, h_sb, 1)
  const void* gamma;    // (G, norm_rows, D) contiguous, fused only
  const void* nbias;    // same shape as gamma, or null (= 0)
  const void* w;        // (G, D, V) contiguous
  const float* hbias;   // (G, V) or null (= 0)
  float* conf;          // (G, B)
  int* pred;            // (G, B)
  float* part_m;        // (G, splits, B) when splits > 1
  float* part_s;
  int* part_a;
  int64_t h_sg, h_sb;
  int g, b, d, v, norm_rows, splits, cols_per_split;
};

struct Stat {
  float m;   // running max logit
  float s;   // sum of exp(logit - m)
  int a;     // lowest column holding m
};

__device__ __forceinline__ Stat combine(const Stat x, const Stat y) {
  const float m = fmaxf(x.m, y.m);
  Stat r;
  r.m = m;
  r.s = x.s * expf(x.m - m) + y.s * expf(y.m - m);
  r.a = x.m > y.m ? x.a : (y.m > x.m ? y.a : min(x.a, y.a));
  return r;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ void write_result(const Params& p, int64_t i, const Stat x) {
  p.conf[i] = 1.f / x.s;    // exp(m - logsumexp) = 1 / sum exp(l - m)
  p.pred[i] = x.a == kNoArg ? 0 : x.a;
}

// fold column c's logits (acc + head bias) into each row's running
// stats; columns arrive in increasing order, so a tie keeps the earlier
__device__ __forceinline__ void fold_column(Stat (&st)[kRows],
                                            const float (&acc)[kRows],
                                            float hb, int c) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float lg = acc[r] + hb;
    if (lg > st[r].m) {
      st[r].s = st[r].s * expf(st[r].m - lg) + 1.f;
      st[r].m = lg;
      st[r].a = c;
    } else {
      st[r].s += expf(lg - st[r].m);
    }
  }
}

template <typename T, int NORM>
__global__ void __launch_bounds__(kThreads)
exit_confidence_kernel(const Params p) {
  extern __shared__ float hs[];                 // [kRows][D] f32
  __shared__ Stat red[kWarps][kRows];

  const int gi = blockIdx.z;
  const int r0 = blockIdx.x * kRows;
  const int nrows = min(kRows, p.b - r0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const T* hp = static_cast<const T*>(p.h) + gi * p.h_sg;

  for (int i = threadIdx.x; i < kRows * p.d; i += kThreads) {
    const int r = i / p.d;
    const int c = i % p.d;
    hs[i] = r < nrows ? to_f32(hp[(r0 + r) * p.h_sb + c]) : 0.f;
  }
  if (NORM != kNormNone) {
    // normalise the tile once, one warp per row, into the same buffer
    __syncthreads();
    const int r = warp;
    if (r < nrows) {
      float* row = hs + r * p.d;
      float mu = 0.f;
      float var;
      if (NORM == kNormRms) {
        float sq = 0.f;
        for (int c = lane; c < p.d; c += 32) sq += row[c] * row[c];
        var = warp_sum(sq) / p.d;
      } else {
        float sum = 0.f;
        for (int c = lane; c < p.d; c += 32) sum += row[c];
        mu = warp_sum(sum) / p.d;
        float sq = 0.f;
        for (int c = lane; c < p.d; c += 32) {
          const float dv = row[c] - mu;
          sq += dv * dv;
        }
        var = warp_sum(sq) / p.d;
      }
      const float rs = 1.f / sqrtf(var + kNormEps);
      const int64_t nrow = static_cast<int64_t>(gi) * p.norm_rows
                           + (p.norm_rows == 1 ? 0 : r0 + r);
      const T* gp = static_cast<const T*>(p.gamma) + nrow * p.d;
      const T* bp = p.nbias ? static_cast<const T*>(p.nbias) + nrow * p.d : nullptr;
      for (int c = lane; c < p.d; c += 32) {
        float y = ((row[c] - mu) * rs) * to_f32(gp[c]);
        if (bp) y += to_f32(bp[c]);
        row[c] = to_f32(from_f32<T>(y));   // activation-dtype round trip
      }
    }
  }
  __syncthreads();

  Stat st[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) st[r] = Stat{kNegInf, 0.f, kNoArg};

  const int c_begin = blockIdx.y * p.cols_per_split;
  const int c_end = min(p.v, c_begin + p.cols_per_split);
  const T* wp = static_cast<const T*>(p.w) + static_cast<int64_t>(gi) * p.d * p.v;
  const float* hbp = p.hbias ? p.hbias + static_cast<int64_t>(gi) * p.v : nullptr;
  if (p.v <= kSmallVocab) {
    // few columns (a classifier head): one warp per column, its lanes
    // split D, so the dot product is 32-way parallel instead of one
    // thread's serial walk over D; for small V the lanes' W reads lie
    // within a few sectors
    for (int c = c_begin + warp; c < c_end; c += kWarps) {
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
      const T* wc = wp + c;
#pragma unroll 4
      for (int k = lane; k < p.d; k += 32) {
        const float wv = to_f32(wc[static_cast<int64_t>(k) * p.v]);
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] += hs[r * p.d + k] * wv;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = warp_sum(acc[r]);
      if (lane == 0) fold_column(st, acc, hbp ? hbp[c] : 0.f, c);
    }
  } else {
    // many columns: one thread per column, so a warp's W reads are
    // consecutive elements of a row
    for (int c = c_begin + threadIdx.x; c < c_end; c += kThreads) {
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
      const T* wc = wp + c;
#pragma unroll 4
      for (int k = 0; k < p.d; ++k) {
        const float wv = to_f32(wc[static_cast<int64_t>(k) * p.v]);
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] += hs[r * p.d + k] * wv;
      }
      fold_column(st, acc, hbp ? hbp[c] : 0.f, c);
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    Stat x = st[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      Stat y;
      y.m = __shfl_xor_sync(0xffffffffu, x.m, off);
      y.s = __shfl_xor_sync(0xffffffffu, x.s, off);
      y.a = __shfl_xor_sync(0xffffffffu, x.a, off);
      x = combine(x, y);
    }
    if (lane == 0) red[warp][r] = x;
  }
  __syncthreads();
  if (threadIdx.x < nrows) {
    const int r = threadIdx.x;
    Stat x = red[0][r];
    for (int wi = 1; wi < kWarps; ++wi) x = combine(x, red[wi][r]);
    if (p.splits == 1) {
      write_result(p, static_cast<int64_t>(gi) * p.b + r0 + r, x);
    } else {
      const int64_t i = (static_cast<int64_t>(gi) * p.splits + blockIdx.y) * p.b + r0 + r;
      p.part_m[i] = x.m;
      p.part_s[i] = x.s;
      p.part_a[i] = x.a;
    }
  }
}

// second pass when the vocabulary was split over blocks: one thread per
// (group, row) folds its splits' triples
__global__ void exit_confidence_combine(const Params p) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<int64_t>(p.g) * p.b) return;
  const int64_t gi = i / p.b;
  const int64_t row = i % p.b;
  Stat x{kNegInf, 0.f, kNoArg};
  for (int k = 0; k < p.splits; ++k) {
    const int64_t j = (gi * p.splits + k) * p.b + row;
    x = combine(x, Stat{p.part_m[j], p.part_s[j], p.part_a[j]});
  }
  write_result(p, i, x);
}

template <typename T, int NORM>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kRows) * p.d * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        exit_confidence_kernel<T, NORM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((p.b + kRows - 1) / kRows, p.splits, p.g);
  exit_confidence_kernel<T, NORM><<<grid, kThreads, smem, stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || p.splits == 1) return static_cast<int>(e);
  const int64_t n = static_cast<int64_t>(p.g) * p.b;
  exit_confidence_combine<<<static_cast<unsigned>((n + 255) / 256), 256, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int NORM>
int launch_dtype(const Params& p, int dtype, cudaStream_t stream) {
  if (dtype == 0) return launch<float, NORM>(p, stream);
  if (dtype == 1) return launch<__nv_bfloat16, NORM>(p, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

bool bad_shape(int g, int b, int d, int v, int splits, int cols_per_split) {
  return g < 1 || b < 1 || d < 1 || v < 1 || splits < 1 || cols_per_split < 1 ||
         static_cast<int64_t>(splits) * cols_per_split < v || g > 65535 || splits > 65535;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (h and w share it). Each launcher
// returns cudaGetLastError() after its launches.
extern "C" int exit_confidence_launch(
    const void* h, int64_t h_sg, int64_t h_sb, const void* w,
    float* conf, int* pred, float* part_m, float* part_s, int* part_a,
    int g, int b, int d, int v, int splits, int cols_per_split, int dtype,
    void* stream) {
  if (bad_shape(g, b, d, v, splits, cols_per_split))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{h, nullptr, nullptr, w, nullptr, conf, pred, part_m, part_s, part_a,
           h_sg, h_sb, g, b, d, v, 1, splits, cols_per_split};
  return launch_dtype<kNormNone>(p, dtype, static_cast<cudaStream_t>(stream));
}

// kind: 1 = rmsnorm, 2 = layernorm. norm_rows: 1 (shared) or b (per row).
extern "C" int exit_confidence_fused_launch(
    const void* x, int64_t x_sg, int64_t x_sb, const void* gamma,
    const void* nbias, const void* w, const float* hbias,
    float* conf, int* pred, float* part_m, float* part_s, int* part_a,
    int g, int b, int d, int v, int norm_rows, int kind, int splits,
    int cols_per_split, int dtype, void* stream) {
  if (bad_shape(g, b, d, v, splits, cols_per_split) || gamma == nullptr ||
      (norm_rows != 1 && norm_rows != b))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{x, gamma, nbias, w, hbias, conf, pred, part_m, part_s, part_a,
           x_sg, x_sb, g, b, d, v, norm_rows, splits, cols_per_split};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == kNormRms) return launch_dtype<kNormRms>(p, dtype, s);
  if (kind == kNormLayer) return launch_dtype<kNormLayer>(p, dtype, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
