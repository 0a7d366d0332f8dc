// Exit-head confidence (max softmax probability) and argmax, for Hopper
// (sm_90a): three kernel variants, each taking the plain and the fused
// (norm prologue) form, and one second pass that combines vocabulary
// splits.
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
//   Both launchers take the head bias (G, V) f32 natively. A leading group
//   axis G runs G independent heads in one launch (the JAX package vmaps
//   the Pallas call over the per-layer exit heads).
//
// Kept semantics: ties go to the LOWEST vocab index, across columns,
// threads, warps, row tiles and vocabulary splits. No reduction here
// relies on the order it visits columns in (a tensor-core thread holds
// columns 2t, 2t+1 of each n8 tile): every fold and every combine
// compares (value, index), a larger value wins and an equal value takes
// the lower index. Columns past V are never folded (the TPU kernel masks
// its padded tile to -1e30, which contributes nothing).
//
// The variants (kernel.py picks one as a pure function of dtype, D, V and
// the 16-byte alignment of the rows; nothing here falls back):
//   * tensor_core (bf16, D % 8 == 0, even V, aligned rows): a skinny
//     GEMM with an online-softmax epilogue. A ring of 3 shared-memory
//     stages, fed by 16-byte cp.async, holds the h tile (BM x 64) and the W
//     tile (64 x 128); the next tiles load while the tensor cores multiply
//     the current one (bf16 in, f32 accumulate). When V % 8 != 0 (seamless's
//     256206) a row of W starts on 4 bytes only, so W is staged in 4-byte
//     cp.async pieces (NARROW), one column pair each, zero-filled past V;
//     the epilogue masks every column >= V on its own, so a zero-filled
//     column adds nothing to the sum and cannot win the argmax. After each 128-column tile
//     the logits (+ bias) fold into per-row (max, sum, argmax) in
//     registers; quad shuffles (and, for mma.sync, a shared-memory pass
//     over the warps) finish each split. bf16 x bf16 products are exact in
//     f32 and the sums are f32, as in the CUDA-core walk: only the order of
//     summation changes.
//     - M <= 32 (an edge bucket; the LM head (32,2560)x(2560,65536)):
//       mma.sync m16n8k16 with ldmatrix (.trans for W, whose V axis is
//       contiguous), one 32-row tile, 4 warps of 32 x 32, the grid splitting
//       V into 256-column splits, 2 blocks an SM, so W is read from HBM
//       once: bound by its 335 MB (0.100 ms at 3.35 TB/s).
//     - M > 32 (SplitEE-S scoring every exit of a bucket on a shared head:
//       (1024,2560)x(2560,65536)): wgmma m64n128k16, two warpgroups over a
//       128 x 128 tile, h and W read by descriptor from shared memory laid
//       out in wgmma's 128-byte-swizzled atoms (W MN-major, the transpose
//       flag); bound by its 343.6 GFLOP (0.347 ms at 989 TFLOP/s). Each
//       thread's copy addresses are computed once (a thread copies the same
//       column of every stage): recomputing them every k-step held this
//       kernel back more than its tile shape did. On an H100 mma.sync took
//       1.4 ms at this shape, and wgmma was slower than mma.sync at
//       M <= 32, so each size keeps its instruction.
//     - fused: a prologue kernel normalises each row in f32 (mean and rstd
//       from a sweep over the row, one warp per row, 16-byte words) and
//       rounds it to bf16 into a (G, B, D) scratch the wrapper allocates;
//       the same tensor-core kernel then reads it as h. The A operand is
//       exactly the row the other variants normalise and round. (A first
//       design normalised each h k-tile in shared memory as it landed: that
//       redid the norm for every 128-column tile and put a second barrier in
//       every k-step, 1.8x the plain time at M = 32 and 2.7x at M = 1024.)
//   * small_head (V <= 64, D % (16 / sizeof(T)) == 0, aligned rows; bf16 or
//     f32): one warp per row; its lanes walk the row in 16-byte words (and
//     normalise them, fused) against the same rows of W, 8 columns at a
//     time, and a warp shuffle finishes each dot product. The serving head
//     (32,768)x(768,2) reads ~52 KB: launch latency is the bound, so the
//     design keeps each warp's loads independent and fills 8 blocks of 4
//     warps for 32 rows (the CUDA-core walk made 4 blocks in which 2 of 8
//     warps worked).
//   * cuda_core (everything else: f32 LM heads, odd D, unaligned rows): the
//     first kernel's walk. The row tile (8 rows, f32, in shared memory) is
//     read as a broadcast while each thread streams one column of W and
//     folds it; CUDA cores in f32, so f32 heads keep their f32 tolerances
//     (TF32 would not).

#include <limits.h>

#include "tile_mma.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kNormEps = 1e-6f;      // repro models.common rmsnorm/layernorm eps
constexpr int kNoArg = INT_MAX;

constexpr int kNormNone = 0;
constexpr int kNormRms = 1;
constexpr int kNormLayer = 2;

constexpr int kVariantCudaCore = 0;
constexpr int kVariantSmallHead = 1;
constexpr int kVariantTensorCore = 2;

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

// fold one logit ``lg`` of column ``c``: a larger value wins, an equal one
// takes the lower index (explicitly, whatever order columns arrive in)
__device__ __forceinline__ void fold(Stat& st, float lg, int c) {
  if (lg > st.m) {
    st.s = st.s * expf(st.m - lg) + 1.f;
    st.m = lg;
    st.a = c;
  } else {
    st.s += expf(lg - st.m);
    if (lg == st.m) st.a = min(st.a, c);
  }
}

__device__ __forceinline__ Stat shfl_xor(const Stat x, int off) {
  Stat y;
  y.m = __shfl_xor_sync(0xffffffffu, x.m, off);
  y.s = __shfl_xor_sync(0xffffffffu, x.s, off);
  y.a = __shfl_xor_sync(0xffffffffu, x.a, off);
  return y;
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

// a row's result, or its split's partial triple when V is split
__device__ __forceinline__ void write_row(const Params& p, int gi, int split, int row,
                                          const Stat x) {
  if (p.splits == 1) {
    write_result(p, static_cast<int64_t>(gi) * p.b + row, x);
  } else {
    const int64_t i = (static_cast<int64_t>(gi) * p.splits + split) * p.b + row;
    p.part_m[i] = x.m;
    p.part_s[i] = x.s;
    p.part_a[i] = x.a;
  }
}

// the norm parameters' row for output row ``row`` of group ``gi``
__device__ __forceinline__ int64_t norm_row(const Params& p, int gi, int row) {
  return static_cast<int64_t>(gi) * p.norm_rows + (p.norm_rows == 1 ? 0 : row);
}

// ------------------------------------------------------- cuda_core variant

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = kWarps;          // rows per block: one warp per row in the norm

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
      const int64_t nrow = norm_row(p, gi, r0 + r);
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
  // one thread per column, so a warp's W reads are consecutive elements
  // of a row
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
    const float hb = hbp ? hbp[c] : 0.f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) fold(st[r], acc[r] + hb, c);
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    Stat x = st[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x = combine(x, shfl_xor(x, off));
    if (lane == 0) red[warp][r] = x;
  }
  __syncthreads();
  if (threadIdx.x < nrows) {
    const int r = threadIdx.x;
    Stat x = red[0][r];
    for (int wi = 1; wi < kWarps; ++wi) x = combine(x, red[wi][r]);
    write_row(p, gi, blockIdx.y, r0 + r, x);
  }
}

// ------------------------------------------------------ small_head variant

// mean (layernorm; 0 for rmsnorm) and rstd of a row of D = 16 nw / sizeof(T)
// elements in 16-byte words, in f32, by the warp that owns the row
template <typename T, int NORM>
__device__ __forceinline__ float2 row_stats(const uint4* row, int nw, int d, int lane) {
  constexpr int kVec = 16 / sizeof(T);
  float xs[kVec];
  float mu = 0.f;
  if (NORM == kNormLayer) {
    float sum = 0.f;
    for (int ch = lane; ch < nw; ch += 32) {
      unpack16<T>(row[ch], xs);
#pragma unroll
      for (int j = 0; j < kVec; ++j) sum += xs[j];
    }
    mu = warp_sum(sum) / d;
  }
  float sq = 0.f;
  for (int ch = lane; ch < nw; ch += 32) {
    unpack16<T>(row[ch], xs);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float dv = xs[j] - mu;
      sq += dv * dv;
    }
  }
  return make_float2(mu, 1.f / sqrtf(warp_sum(sq) / d + kNormEps));
}

// word ``ch`` of a row, normalised in f32: ((x - mu) rstd) gamma (+ beta)
template <typename T>
__device__ __forceinline__ void normalise_word(float* xs, float2 stats, const uint4* gp,
                                               const uint4* bp, int ch) {
  constexpr int kVec = 16 / sizeof(T);
  float gv[kVec], bv[kVec];
  unpack16<T>(gp[ch], gv);
  if (bp) unpack16<T>(bp[ch], bv);
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    xs[j] = ((xs[j] - stats.x) * stats.y) * gv[j];
    if (bp) xs[j] += bv[j];
  }
}

constexpr int kSmallVocab = 64;        // up to this V
constexpr int kSmallWarps = 4;         // rows per block, one warp each
constexpr int kSmallCols = 8;          // columns whose sums a lane keeps at once

template <typename T, int NORM>
__global__ void __launch_bounds__(kSmallWarps * 32)
exit_confidence_small_kernel(const Params p) {
  constexpr int kVec = 16 / sizeof(T);          // elements per 16-byte word
  const int lane = threadIdx.x % 32;
  const int gi = blockIdx.y;
  const int row = blockIdx.x * kSmallWarps + threadIdx.x / 32;
  if (row >= p.b) return;
  const int nw = p.d / kVec;                    // words in a row
  const uint4* hp = reinterpret_cast<const uint4*>(static_cast<const T*>(p.h) + gi * p.h_sg +
                                                   row * p.h_sb);
  float2 stats = make_float2(0.f, 1.f);
  const uint4* gp = nullptr;
  const uint4* bp = nullptr;
  if (NORM != kNormNone) {
    stats = row_stats<T, NORM>(hp, nw, p.d, lane);
    const int64_t nrow = norm_row(p, gi, row);
    gp = reinterpret_cast<const uint4*>(static_cast<const T*>(p.gamma) + nrow * p.d);
    if (p.nbias) bp = reinterpret_cast<const uint4*>(static_cast<const T*>(p.nbias) + nrow * p.d);
  }

  // lane l walks words l, l + 32, ... of the row (L1-resident after the
  // first pass) against the same rows of W, for kSmallCols columns at once
  const T* wp = static_cast<const T*>(p.w) + static_cast<int64_t>(gi) * p.d * p.v;
  const float* hbp = p.hbias ? p.hbias + static_cast<int64_t>(gi) * p.v : nullptr;
  Stat st{kNegInf, 0.f, kNoArg};
  for (int c0 = 0; c0 < p.v; c0 += kSmallCols) {
    float acc[kSmallCols];
#pragma unroll
    for (int cc = 0; cc < kSmallCols; ++cc) acc[cc] = 0.f;
#pragma unroll 2
    for (int ch = lane; ch < nw; ch += 32) {
      float xs[kVec];
      unpack16<T>(hp[ch], xs);
      if (NORM != kNormNone) {
        normalise_word<T>(xs, stats, gp, bp, ch);
#pragma unroll
        for (int j = 0; j < kVec; ++j) xs[j] = to_f32(from_f32<T>(xs[j]));  // dtype round trip
      }
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const T* wr = wp + static_cast<int64_t>(ch * kVec + j) * p.v + c0;
#pragma unroll
        for (int cc = 0; cc < kSmallCols; ++cc)
          if (c0 + cc < p.v) acc[cc] += xs[j] * to_f32(wr[cc]);
      }
    }
#pragma unroll
    for (int cc = 0; cc < kSmallCols; ++cc) {
      if (c0 + cc >= p.v) break;
      const float lg = warp_sum(acc[cc]) + (hbp ? hbp[c0 + cc] : 0.f);
      fold(st, lg, c0 + cc);             // every lane holds the same stats
    }
  }
  if (lane == 0) write_result(p, static_cast<int64_t>(gi) * p.b + row, st);
}

// ----------------------------------------------------- tensor_core variant

constexpr int kTcBK = 64;              // k-tile depth: four m16n8k16 steps
constexpr int kTcStages = 3;           // cp.async ring depth
constexpr int kTcSmallRows = 32;       // M up to this: the 32-row tile

// byte offset of 16-byte word ``c`` of row ``r`` in an h tile (rows of
// kTcBK = 64 bf16, 128 bytes): words XORed by r % 8, so the 8 row
// addresses of one ldmatrix phase hit 8 distinct bank groups; this is also
// wgmma's 128-byte-swizzled K-major layout
__device__ __forceinline__ int a_off(int r, int c) {
  return r * (kTcBK * 2) + ((c ^ (r & 7)) << 4);
}
// the same for a W tile (rows of BN bf16, a multiple of 128 bytes)
template <int BN>
__device__ __forceinline__ int b_off(int r, int c) {
  return r * (BN * 2) + ((c ^ (r & 7)) << 4);
}

// a block of WARPS_M x WARPS_N warps, each warp MT m16 tiles (16 MT rows)
// by BN / WARPS_N columns
template <int WARPS_M, int WARPS_N, int MT, int BN>
struct TcShape {
  static constexpr int kThreads = WARPS_M * WARPS_N * 32;
  static constexpr int kBM = 16 * MT * WARPS_M;
  static constexpr int kWN = BN / WARPS_N;     // each warp: kWN columns
  static constexpr int kNT = kWN / 8;          // n8 tiles per warp
  static constexpr int kABytes = kBM * kTcBK * 2;
  static constexpr int kStageBytes = kABytes + kTcBK * BN * 2;   // h tile, W tile
};

// MIN_BLOCKS blocks an SM bound the registers a thread may take; NARROW
// stages W in 4-byte pieces (V % 8 != 0)
template <int WARPS_M, int WARPS_N, int MT, int BN, int MIN_BLOCKS, bool NARROW>
__global__ void __launch_bounds__(WARPS_M * WARPS_N * 32, MIN_BLOCKS)
exit_confidence_tc_kernel(const Params p) {
  using S = TcShape<WARPS_M, WARPS_N, MT, BN>;
  constexpr int kBM = S::kBM;
  constexpr int kNT = S::kNT;
  constexpr int kWords = kTcBK / 8;            // 16-byte words per h row
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ Stat red[WARPS_N][kBM];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wm = warp / WARPS_N;
  const int wn = warp % WARPS_N;
  const int gi = blockIdx.z;
  const int r0 = blockIdx.x * kBM;
  const int split = blockIdx.y;
  const int c_begin = split * p.cols_per_split;
  const int c_end = min(p.v, c_begin + p.cols_per_split);
  const int n_ct = (c_end - c_begin + BN - 1) / BN;
  const int kt_n = (p.d + kTcBK - 1) / kTcBK;
  const int steps = n_ct * kt_n;

  const __nv_bfloat16* hp = static_cast<const __nv_bfloat16*>(p.h) + gi * p.h_sg;
  const __nv_bfloat16* wp =
      static_cast<const __nv_bfloat16*>(p.w) + static_cast<int64_t>(gi) * p.d * p.v;
  const float* hbp = p.hbias ? p.hbias + static_cast<int64_t>(gi) * p.v : nullptr;
  const uint32_t smem0 = smem_addr(smem);

  // issue the copies of step t (column tile t / kt_n, k-tile t % kt_n)
  auto load_stage = [&](int t) {
    const int k0 = (t % kt_n) * kTcBK;
    const int n0 = c_begin + (t / kt_n) * BN;
    const uint32_t stage = smem0 + (t % kTcStages) * S::kStageBytes;
    for (int i = tid; i < kBM * kWords; i += S::kThreads) {
      const int r = i / kWords, c = i % kWords;
      const bool ok = r0 + r < p.b && k0 + c * 8 < p.d;
      cp_async16(stage + a_off(r, c), ok ? hp + (r0 + r) * p.h_sb + k0 + c * 8 : hp, ok);
    }
    if (NARROW) {
      // piece c: columns 2c, 2c + 1 of the tile, bytes 4 (c % 4) of word c / 4
      for (int i = tid; i < kTcBK * (BN / 2); i += S::kThreads) {
        const int r = i / (BN / 2), c = i % (BN / 2);
        const bool ok = k0 + r < p.d && n0 + c * 2 < p.v;
        cp_async4(stage + S::kABytes + b_off<BN>(r, c / 4) + (c % 4) * 4,
                  ok ? wp + static_cast<int64_t>(k0 + r) * p.v + n0 + c * 2 : wp, ok);
      }
    } else {
      for (int i = tid; i < kTcBK * (BN / 8); i += S::kThreads) {
        const int r = i / (BN / 8), c = i % (BN / 8);
        const bool ok = k0 + r < p.d && n0 + c * 8 < p.v;
        cp_async16(stage + S::kABytes + b_off<BN>(r, c),
                   ok ? wp + static_cast<int64_t>(k0 + r) * p.v + n0 + c * 8 : wp, ok);
      }
    }
  };

  float acc[MT][kNT][4];
  Stat st[MT][2];                // [m16 tile][row half]: rows lane/4 and lane/4 + 8
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) st[mi][hf] = Stat{kNegInf, 0.f, kNoArg};
#pragma unroll
    for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;
  }

#pragma unroll
  for (int t = 0; t < kTcStages - 1; ++t) {
    if (t < steps) load_stage(t);
    cp_async_commit();
  }
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<kTcStages - 2>();
    __syncthreads();                       // step t landed; step t-1's stage is free
    if (t + kTcStages - 1 < steps) load_stage(t + kTcStages - 1);
    cp_async_commit();
    const uint32_t sa = smem0 + (t % kTcStages) * S::kStageBytes;
    const uint32_t sb = sa + S::kABytes;
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const int r = (wm * MT + mi) * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
        ldmatrix_x4(a[mi], sa + a_off(r, kk * 2 + lane / 16));
      }
#pragma unroll
      for (int nj = 0; nj < kNT / 2; ++nj) {
        uint32_t b[4];
        const int kr = kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
        ldmatrix_x4_trans(b, sb + b_off<BN>(kr, (wn * S::kWN + nj * 16) / 8 + lane / 16));
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          mma_bf16(acc[mi][2 * nj], a[mi], b[0], b[1]);
          mma_bf16(acc[mi][2 * nj + 1], a[mi], b[2], b[3]);
        }
      }
    }
    if (t % kt_n == kt_n - 1) {
      // epilogue of a column tile: logits (+ bias) into the row stats
      const int n0 = c_begin + (t / kt_n) * BN + wn * S::kWN + (lane % 4) * 2;
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          // the tile's max and its lowest column, then one rescale
          float tm = kNegInf;
          int ta = kNoArg;
#pragma unroll
          for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int c = n0 + ni * 8 + j;
              float& lg = acc[mi][ni][hf * 2 + j];
              if (hbp && c < c_end) lg += hbp[c];
              if (c < c_end && (lg > tm || (lg == tm && c < ta))) {
                tm = lg;
                ta = c;
              }
            }
          Stat& s = st[mi][hf];
          const float m_new = fmaxf(s.m, tm);
          float sum = s.s * expf(s.m - m_new);
#pragma unroll
          for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
            for (int j = 0; j < 2; ++j)
              if (n0 + ni * 8 + j < c_end) sum += expf(acc[mi][ni][hf * 2 + j] - m_new);
          s.a = tm > s.m ? ta : (tm == s.m ? min(s.a, ta) : s.a);
          s.m = m_new;
          s.s = sum;
        }
#pragma unroll
        for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;
      }
    }
  }
  cp_async_wait<0>();

  // the quad shares rows: combine its four column sets, then the warps
  // that share the rows, in shared memory
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      Stat x = st[mi][hf];
      x = combine(x, shfl_xor(x, 1));
      x = combine(x, shfl_xor(x, 2));
      if (lane % 4 == 0) red[wn][(wm * MT + mi) * 16 + hf * 8 + lane / 4] = x;
    }
  __syncthreads();
  if (tid < kBM && r0 + tid < p.b) {
    Stat x = red[0][tid];
#pragma unroll
    for (int wi = 1; wi < WARPS_N; ++wi) x = combine(x, red[wi][tid]);
    write_row(p, gi, split, r0 + tid, x);
  }
}

// M > 32 on wgmma: two warpgroups, each m64n128k16 over its 64 rows of a
// 128 x 128 tile, operands read from shared memory by descriptor (h
// K-major, W MN-major with the transpose flag), both in the 128-byte
// swizzled layout wgmma expects; 2 blocks an SM
constexpr int kWgGroups = 2;
constexpr int kWgThreads = 128 * kWgGroups;
constexpr int kWgBM = 64 * kWgGroups;
constexpr int kWgBN = 128;
constexpr int kWgABytes = kWgBM * kTcBK * 2;
constexpr int kWgStageBytes = kWgABytes + kTcBK * kWgBN * 2;

// byte offset of 16-byte word c of row r of a W tile in wgmma's MN-major
// layout: 64-column atoms of kTcBK rows x 128 bytes, one after another
__device__ __forceinline__ int w_atom_off(int r, int c) {
  return (c >> 3) * (kTcBK * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

template <bool NARROW>
__global__ void __launch_bounds__(kWgThreads, 2)
exit_confidence_wgmma_kernel(const Params p) {
  static_assert(kTcBK == 64, "the h tile's rows are one 128-byte swizzle atom wide");
  constexpr int BN = kWgBN;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t smem0 = (smem_addr(smem_raw) + 1023u) & ~1023u;   // atoms on 1024 bytes

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int wg = tid / 128;
  const int gi = blockIdx.z;
  const int r0 = blockIdx.x * kWgBM;
  const int split = blockIdx.y;
  const int c_begin = split * p.cols_per_split;
  const int c_end = min(p.v, c_begin + p.cols_per_split);
  const int n_ct = (c_end - c_begin + BN - 1) / BN;
  const int kt_n = (p.d + kTcBK - 1) / kTcBK;
  const int steps = n_ct * kt_n;

  const __nv_bfloat16* hp = static_cast<const __nv_bfloat16*>(p.h) + gi * p.h_sg;
  const __nv_bfloat16* wp =
      static_cast<const __nv_bfloat16*>(p.w) + static_cast<int64_t>(gi) * p.d * p.v;
  const float* hbp = p.hbias ? p.hbias + static_cast<int64_t>(gi) * p.v : nullptr;

  // each thread copies the same words of every stage: kAW of the h tile,
  // rows kARows apart, and kBW of the W tile, rows kBRows apart, always the
  // same 16-byte column; their addresses, less the step's offset, once
  constexpr int kAW = kWgBM * (kTcBK / 8) / kWgThreads;
  constexpr int kARows = kWgThreads / (kTcBK / 8);
  constexpr int kBW = kTcBK * (BN / 8) / kWgThreads;
  constexpr int kBRows = kWgThreads / (BN / 8);
  const int a_r = tid / (kTcBK / 8), a_c = (tid % (kTcBK / 8)) * 8;
  const int b_r = tid / (BN / 8), b_c = c_begin + (tid % (BN / 8)) * 8;
  const __nv_bfloat16* a_src = hp + (r0 + a_r) * p.h_sb + a_c;
  const __nv_bfloat16* b_src = wp + static_cast<int64_t>(b_r) * p.v + b_c;
  const uint32_t a_dst = a_off(a_r, a_c / 8);
  const uint32_t b_dst = kWgABytes + w_atom_off(b_r, (tid % (BN / 8)));
  // NARROW: kBW4 4-byte pieces of W a thread, rows kBRows4 apart (4, so
  // the swizzle differs between them), always the same column pair
  constexpr int kBW4 = kTcBK * (BN / 2) / kWgThreads;
  constexpr int kBRows4 = kWgThreads / (BN / 2);
  const int n_r = tid / (BN / 2), n_p = tid % (BN / 2);
  const __nv_bfloat16* n_src = wp + static_cast<int64_t>(n_r) * p.v + c_begin + n_p * 2;
  auto load_stage = [&](int t) {
    const int k0 = (t % kt_n) * kTcBK;
    const int dn = (t / kt_n) * BN;
    const uint32_t stage = smem0 + (t % kTcStages) * kWgStageBytes;
#pragma unroll
    for (int j = 0; j < kAW; ++j) {     // a row kARows further: the same swizzle
      const bool ok = r0 + a_r + j * kARows < p.b && k0 + a_c < p.d;
      cp_async16(stage + a_dst + j * kARows * 128,
                 ok ? a_src + j * kARows * p.h_sb + k0 : hp, ok);
    }
    if (NARROW) {
#pragma unroll
      for (int j = 0; j < kBW4; ++j) {
        const int r = n_r + j * kBRows4;
        const bool ok = k0 + r < p.d && c_begin + dn + n_p * 2 < p.v;
        cp_async4(stage + kWgABytes + w_atom_off(r, n_p / 4) + (n_p % 4) * 4,
                  ok ? n_src + static_cast<int64_t>(k0 + j * kBRows4) * p.v + dn : wp, ok);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kBW; ++j) {
        const bool ok = k0 + b_r + j * kBRows < p.d && b_c + dn < p.v;
        cp_async16(stage + b_dst + j * kBRows * 128,
                   ok ? b_src + static_cast<int64_t>(k0 + j * kBRows) * p.v + dn : wp, ok);
      }
    }
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  Stat st[2] = {Stat{kNegInf, 0.f, kNoArg}, Stat{kNegInf, 0.f, kNoArg}};

#pragma unroll
  for (int t = 0; t < kTcStages - 1; ++t) {
    if (t < steps) load_stage(t);
    cp_async_commit();
  }
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<kTcStages - 2>();
    fence_proxy_async_smem();              // this thread's copies, visible to wgmma
    __syncthreads();                       // ... every thread's; step t-1's stage is free
    if (t + kTcStages - 1 < steps) load_stage(t + kTcStages - 1);
    cp_async_commit();
    const uint32_t sa = smem0 + (t % kTcStages) * kWgStageBytes + wg * (64 * kTcBK * 2);
    const uint32_t sb = smem0 + (t % kTcStages) * kWgStageBytes + kWgABytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk)      // a column tile's first overwrites acc
      wgmma_m64n128k16(acc, wgmma_desc_sw128(sa + kk * 32, 16, 1024),
                       wgmma_desc_sw128(sb + kk * 16 * 128, kTcBK * 128, 1024),
                       (t % kt_n == 0 && kk == 0) ? 0 : 1);
    wgmma_commit();
    wgmma_wait<0>();
    if (t % kt_n == kt_n - 1) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) fence_operand(acc[i]);
      // epilogue of a column tile, as in the mma.sync kernel: n8 tile j of
      // this thread's rows lane/4 (hf 0) and lane/4 + 8 (hf 1)
      const int n0 = c_begin + (t / kt_n) * BN + (lane % 4) * 2;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float tm = kNegInf;
        int ta = kNoArg;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int c = n0 + j * 8 + q;
            float& lg = acc[4 * j + 2 * hf + q];
            if (hbp && c < c_end) lg += hbp[c];
            if (c < c_end && (lg > tm || (lg == tm && c < ta))) {
              tm = lg;
              ta = c;
            }
          }
        Stat& s = st[hf];
        const float m_new = fmaxf(s.m, tm);
        float sum = s.s * expf(s.m - m_new);
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int q = 0; q < 2; ++q)
            if (n0 + j * 8 + q < c_end) sum += expf(acc[4 * j + 2 * hf + q] - m_new);
        s.a = tm > s.m ? ta : (tm == s.m ? min(s.a, ta) : s.a);
        s.m = m_new;
        s.s = sum;
      }
    }
  }
  cp_async_wait<0>();

  // a quad holds all of a row's columns: combine it, then write the row
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    Stat x = st[hf];
    x = combine(x, shfl_xor(x, 1));
    x = combine(x, shfl_xor(x, 2));
    const int row = r0 + wg * 64 + ((tid / 32) % 4) * 16 + hf * 8 + lane / 4;
    if (lane % 4 == 0 && row < p.b) write_row(p, gi, split, row, x);
  }
}

// the fused form's prologue on the tensor-core path: each row normalised
// in f32 (mean and rstd from a sweep over the row, as the other variants
// do) and rounded to bf16 into the wrapper's (G, B, D) scratch, which the
// tensor-core kernel then reads as its h. One warp per row, 16-byte words.
constexpr int kNormWarps = 8;

template <int NORM>
__global__ void __launch_bounds__(kNormWarps * 32)
exit_norm_rows_kernel(const Params p, __nv_bfloat16* out) {
  const int lane = threadIdx.x % 32;
  const int gi = blockIdx.y;
  const int row = blockIdx.x * kNormWarps + threadIdx.x / 32;
  if (row >= p.b) return;
  const int nw = p.d / 8;
  const uint4* xp = reinterpret_cast<const uint4*>(
      static_cast<const __nv_bfloat16*>(p.h) + gi * p.h_sg + row * p.h_sb);
  const float2 stats = row_stats<__nv_bfloat16, NORM>(xp, nw, p.d, lane);
  const int64_t nrow = norm_row(p, gi, row);
  const uint4* gp = reinterpret_cast<const uint4*>(
      static_cast<const __nv_bfloat16*>(p.gamma) + nrow * p.d);
  const uint4* bp = p.nbias ? reinterpret_cast<const uint4*>(
                                  static_cast<const __nv_bfloat16*>(p.nbias) + nrow * p.d)
                            : nullptr;
  uint4* op = reinterpret_cast<uint4*>(out + (static_cast<int64_t>(gi) * p.b + row) * p.d);
  for (int ch = lane; ch < nw; ch += 32) {
    float xs[8];
    unpack16<__nv_bfloat16>(xp[ch], xs);
    normalise_word<__nv_bfloat16>(xs, stats, gp, bp, ch);
    op[ch] = make_uint4(pack_bf16(xs[0], xs[1]), pack_bf16(xs[2], xs[3]),
                        pack_bf16(xs[4], xs[5]), pack_bf16(xs[6], xs[7]));  // dtype rounding
  }
}

// second pass when the vocabulary was split over blocks: one warp per
// (group, row), its lanes striding over the splits' triples
constexpr int kCombineWarps = 8;

__global__ void __launch_bounds__(kCombineWarps * 32)
exit_confidence_combine(const Params p) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kCombineWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (i >= static_cast<int64_t>(p.g) * p.b) return;
  const int64_t gi = i / p.b;
  const int64_t row = i % p.b;
  Stat x{kNegInf, 0.f, kNoArg};
  for (int k = lane; k < p.splits; k += 32) {
    const int64_t j = (gi * p.splits + k) * p.b + row;
    x = combine(x, Stat{p.part_m[j], p.part_s[j], p.part_a[j]});
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = combine(x, shfl_xor(x, off));
  if (lane == 0) write_result(p, i, x);
}

// opt in to ``smem`` bytes of dynamic shared memory: needed whenever
// static + dynamic exceed 48 KB, harmless below
cudaError_t set_smem(const void* kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

int launch_combine(const Params& p, cudaStream_t stream) {
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || p.splits == 1) return static_cast<int>(e);
  const int64_t n = static_cast<int64_t>(p.g) * p.b;
  exit_confidence_combine<<<static_cast<unsigned>((n + kCombineWarps - 1) / kCombineWarps),
                            kCombineWarps * 32, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NORM>
int launch_cuda_core(const Params& p, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kRows) * p.d * sizeof(float);
  const cudaError_t e = set_smem(reinterpret_cast<const void*>(exit_confidence_kernel<T, NORM>), smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((p.b + kRows - 1) / kRows, p.splits, p.g);
  exit_confidence_kernel<T, NORM><<<grid, kThreads, smem, stream>>>(p);
  return launch_combine(p, stream);
}

// the rows of h and of the norm parameters start on 16 bytes (strides in
// elements of ``vec`` per 16 bytes; an axis of length 1 has no stride)
bool rows_on16(const Params& p, int vec) {
  const auto on16 = [](const void* x) { return reinterpret_cast<uintptr_t>(x) % 16 == 0; };
  return on16(p.h) && on16(p.gamma) && on16(p.nbias) && p.d % vec == 0 &&
         (p.b == 1 || p.h_sb % vec == 0) && (p.g == 1 || p.h_sg % vec == 0);
}

template <typename T, int NORM>
int launch_small(const Params& p, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (!rows_on16(p, kVec) || p.splits != 1 || p.v > kSmallVocab)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((p.b + kSmallWarps - 1) / kSmallWarps, p.g);
  exit_confidence_small_kernel<T, NORM><<<grid, kSmallWarps * 32, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int WARPS_M, int WARPS_N, int MT, int BN, int MIN_BLOCKS, bool NARROW>
int launch_tc_shape(const Params& p, cudaStream_t stream) {
  using S = TcShape<WARPS_M, WARPS_N, MT, BN>;
  if (p.cols_per_split % BN) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(kTcStages) * S::kStageBytes;
  const auto kernel = exit_confidence_tc_kernel<WARPS_M, WARPS_N, MT, BN, MIN_BLOCKS, NARROW>;
  const cudaError_t e = set_smem(reinterpret_cast<const void*>(kernel), smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((p.b + S::kBM - 1) / S::kBM, p.splits, p.g);
  kernel<<<grid, S::kThreads, smem, stream>>>(p);
  return launch_combine(p, stream);
}

template <bool NARROW>
int launch_wgmma(const Params& p, cudaStream_t stream) {
  if (p.cols_per_split % kWgBN) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(kTcStages) * kWgStageBytes + 1024;   // + alignment
  const auto kernel = exit_confidence_wgmma_kernel<NARROW>;
  const cudaError_t e = set_smem(reinterpret_cast<const void*>(kernel), smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((p.b + kWgBM - 1) / kWgBM, p.splits, p.g);
  kernel<<<grid, kWgThreads, smem, stream>>>(p);
  return launch_combine(p, stream);
}

// fused (NORM != none): the rows are normalised into ``normed`` first; W
// starts on 16 bytes and V is even, so every row of W lies on 4 bytes
template <int NORM>
int launch_tc(const Params& p, __nv_bfloat16* normed, cudaStream_t stream) {
  if (!rows_on16(p, 8) || reinterpret_cast<uintptr_t>(p.w) % 16 || p.v % 2 ||
      (NORM != kNormNone && (normed == nullptr || reinterpret_cast<uintptr_t>(normed) % 16)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params q = p;
  if (NORM != kNormNone) {
    const dim3 grid((p.b + kNormWarps - 1) / kNormWarps, p.g);
    exit_norm_rows_kernel<NORM><<<grid, kNormWarps * 32, 0, stream>>>(p, normed);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    q.h = normed;
    q.h_sg = static_cast<int64_t>(p.b) * p.d;
    q.h_sb = p.d;
  }
  // M <= 32: 4 warps of 32 x 32 (60 KB of stages); else the wgmma tile,
  // 2 blocks an SM; 4-byte W pieces where a row of W may miss 16 bytes
  const bool narrow = q.v % 8 != 0;
  if (q.b <= kTcSmallRows)
    return narrow ? launch_tc_shape<1, 4, 2, 128, 4, true>(q, stream)
                  : launch_tc_shape<1, 4, 2, 128, 4, false>(q, stream);
  return narrow ? launch_wgmma<true>(q, stream) : launch_wgmma<false>(q, stream);
}

template <int NORM>
int launch_variant(const Params& p, int dtype, int variant, void* normed,
                   cudaStream_t stream) {
  if (variant == kVariantTensorCore)
    return dtype == 1 ? launch_tc<NORM>(p, static_cast<__nv_bfloat16*>(normed), stream)
                      : static_cast<int>(cudaErrorInvalidValue);
  if (variant == kVariantSmallHead) {
    if (dtype == 0) return launch_small<float, NORM>(p, stream);
    if (dtype == 1) return launch_small<__nv_bfloat16, NORM>(p, stream);
  }
  if (variant == kVariantCudaCore) {
    if (dtype == 0) return launch_cuda_core<float, NORM>(p, stream);
    if (dtype == 1) return launch_cuda_core<__nv_bfloat16, NORM>(p, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

bool bad_shape(int g, int b, int d, int v, int splits, int cols_per_split) {
  return g < 1 || b < 1 || d < 1 || v < 1 || splits < 1 || cols_per_split < 1 ||
         static_cast<int64_t>(splits) * cols_per_split < v || g > 65535 || splits > 65535;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (h and w share it). variant: 0 =
// cuda_core, 1 = small_head, 2 = tensor_core. hbias: (G, V) f32 or null.
// Each launcher returns cudaGetLastError() after its launches, or
// cudaErrorInvalidValue for arguments its variant does not take.
extern "C" int exit_confidence_launch(
    const void* h, int64_t h_sg, int64_t h_sb, const void* w, const float* hbias,
    float* conf, int* pred, float* part_m, float* part_s, int* part_a,
    int g, int b, int d, int v, int splits, int cols_per_split, int dtype,
    int variant, void* stream) {
  if (bad_shape(g, b, d, v, splits, cols_per_split))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{h, nullptr, nullptr, w, hbias, conf, pred, part_m, part_s, part_a,
           h_sg, h_sb, g, b, d, v, 1, splits, cols_per_split};
  return launch_variant<kNormNone>(p, dtype, variant, nullptr,
                                   static_cast<cudaStream_t>(stream));
}

// kind: 1 = rmsnorm, 2 = layernorm. norm_rows: 1 (shared) or b (per row).
// normed: (G, B, D) bf16 scratch for the tensor_core variant, else null.
extern "C" int exit_confidence_fused_launch(
    const void* x, int64_t x_sg, int64_t x_sb, const void* gamma,
    const void* nbias, const void* w, const float* hbias,
    float* conf, int* pred, float* part_m, float* part_s, int* part_a,
    void* normed, int g, int b, int d, int v, int norm_rows, int kind,
    int splits, int cols_per_split, int dtype, int variant, void* stream) {
  if (bad_shape(g, b, d, v, splits, cols_per_split) || gamma == nullptr ||
      (norm_rows != 1 && norm_rows != b))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{x, gamma, nbias, w, hbias, conf, pred, part_m, part_s, part_a,
           x_sg, x_sb, g, b, d, v, norm_rows, splits, cols_per_split};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == kNormRms) return launch_variant<kNormRms>(p, dtype, variant, normed, s);
  if (kind == kNormLayer) return launch_variant<kNormLayer>(p, dtype, variant, normed, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
