// Block attention with an online softmax, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention/kernel.py,
//   flash_attention_pallas (pl.pallas_call at :103) and its _kernel.
//   Same function: softmax(q k^T * scale + mask) v per (batch, head), f32
//   accumulation, output in the input dtype. Kept semantics:
//   * queries are the LAST sq positions of the skv timeline
//     (q_offset = skv - sq), so decode-style suffix queries work;
//   * causal and sliding-window masks on global positions;
//   * columns past skv are never read (the TPU kernel masks padded
//     columns even when they hold NaN; here they are not loaded at all,
//     and padded V rows are zeros in shared memory); a NaN score in a
//     valid column becomes -1e30, as in the TPU kernel;
//   * a fully masked row gives exactly 0: its probabilities are zero and
//     the denominator is clamped at 1e-30.
//   GQA is handled here by index (kv head = q head / group) instead of
//   the repeat the TPU wrapper materializes.
//
// What bounds it on the H100: at the serving shapes (S = 64, d = 64,
// B*H = 384) the work is 0.40 GFLOP against 12.6 MB of q/k/v/o in bf16,
// about 32 FLOP per byte, far under the ~295 FLOP/byte where the tensor
// cores would become the limit; the bound is memory (about 3.8 us at
// 3.35 TB/s). The design therefore reads each K/V tile once per block
// into shared memory (coalesced, converted to f32 there) and never
// writes scores to device memory; the grid is one block per
// (batch*head, 128/TPR query rows), so the 384 heads give 768 blocks.
// The products run on the CUDA cores in f32 (no wgmma, no TMA, no
// pipelining): a simple, right first kernel; tensor cores come later.
//
// Thread layout: TPR threads own one query row; thread t of the row
// holds the columns c*TPR + t (c < 16) of q and of the accumulator, so
// the TPR threads of a row read consecutive shared-memory words. A score
// is a partial dot product over those columns, summed with TPR-lane
// shuffles. Every thread keeps the row's running max and sum.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBlockK = 32;          // keys per shared-memory tile
constexpr int kColsPerThread = 16;   // head_dim <= 16 * TPR
constexpr float kNegInf = -1e30f;

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
  const void* q;
  const void* k;
  const void* v;
  void* o;
  // element strides of the (batch, head, seq) dims; head_dim is contiguous
  int64_t q_sb, q_sh, q_ss;
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss;
  int hq, hkv, sq, skv, d;
  int causal, window;
  float scale;
};

template <typename T, int TPR>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const Params p) {
  constexpr int kRows = kThreads / TPR;          // query rows per block
  constexpr int kDPad = TPR * kColsPerThread;    // head_dim padded
  __shared__ float ks[kBlockK][kDPad];
  __shared__ float vs[kBlockK][kDPad];

  const int bh = blockIdx.x;
  const int b = bh / p.hq;
  const int h = bh % p.hq;
  const int hk = h / (p.hq / p.hkv);
  const int row_local = threadIdx.x / TPR;
  const int t = threadIdx.x % TPR;
  const int q_row = blockIdx.y * kRows + row_local;
  const bool row_ok = q_row < p.sq;
  const int q_offset = p.skv - p.sq;
  const int q_pos = q_row + q_offset;

  const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh
                + static_cast<int64_t>(row_ok ? q_row : 0) * p.q_ss;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  float qr[kColsPerThread];
  float acc[kColsPerThread];
#pragma unroll
  for (int c = 0; c < kColsPerThread; ++c) {
    const int col = c * TPR + t;
    qr[c] = (row_ok && col < p.d) ? to_f32(qp[col]) * p.scale : 0.f;
    acc[c] = 0.f;
  }
  float m = kNegInf;
  float l = 0.f;

  // key range any row of this block may see; tiles outside it are fully
  // masked for every row, and a fully masked tile leaves (m, l, acc)
  // unchanged, so skipping it is exact
  const int first_pos = blockIdx.y * kRows + q_offset;
  const int last_pos = min((blockIdx.y + 1) * kRows, p.sq) - 1 + q_offset;
  int k_lo = 0;
  int k_hi = p.skv;
  if (p.causal) k_hi = min(k_hi, last_pos + 1);
  if (p.window) k_lo = max(k_lo, first_pos - p.window + 1);
  const int t_lo = k_lo / kBlockK;
  const int t_hi = k_hi > k_lo ? (k_hi + kBlockK - 1) / kBlockK : t_lo;

  for (int tile = t_lo; tile < t_hi; ++tile) {
    const int k0 = tile * kBlockK;
    __syncthreads();                    // previous tile fully consumed
    for (int i = threadIdx.x; i < kBlockK * kDPad; i += kThreads) {
      const int r = i / kDPad;
      const int c = i % kDPad;
      const int kr = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (kr < p.skv && c < p.d) {
        kv = to_f32(kp[static_cast<int64_t>(kr) * p.k_ss + c]);
        vv = to_f32(vp[static_cast<int64_t>(kr) * p.v_ss + c]);
      }
      ks[r][c] = kv;
      vs[r][c] = vv;
    }
    __syncthreads();

    float s[kBlockK];
    uint32_t valid_bits = 0u;
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) dot += qr[c] * ks[j][c * TPR + t];
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      const int kpos = k0 + j;
      bool valid = kpos < p.skv;
      if (p.causal) valid = valid && (kpos <= q_pos);
      if (p.window) valid = valid && (kpos > q_pos - p.window);
      const float sv = valid ? (isnan(dot) ? kNegInf : dot) : kNegInf;
      valid_bits |= (valid ? 1u : 0u) << j;
      s[j] = sv;
      tile_max = fmaxf(tile_max, sv);
    }
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    float l_tile = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      s[j] = ((valid_bits >> j) & 1u) ? expf(s[j] - m_new) : 0.f;
      l_tile += s[j];
    }
    l = l * alpha + l_tile;
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) {
      float a = acc[c] * alpha;
#pragma unroll
      for (int j = 0; j < kBlockK; ++j) a += s[j] * vs[j][c * TPR + t];
      acc[c] = a;
    }
    m = m_new;
  }

  if (row_ok) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* op = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh
            + static_cast<int64_t>(q_row) * p.o_ss;
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) {
      const int col = c * TPR + t;
      if (col < p.d) op[col] = from_f32<T>(acc[c] * inv);
    }
  }
}

template <typename T, int TPR>
void launch(const Params& p, int batch, cudaStream_t stream) {
  constexpr int kRows = kThreads / TPR;
  const dim3 grid(batch * p.hq, (p.sq + kRows - 1) / kRows);
  flash_attention_kernel<T, TPR><<<grid, kThreads, 0, stream>>>(p);
}

template <typename T>
void launch_for_dim(const Params& p, int batch, cudaStream_t stream) {
  if (p.d <= 16) launch<T, 1>(p, batch, stream);
  else if (p.d <= 32) launch<T, 2>(p, batch, stream);
  else if (p.d <= 64) launch<T, 4>(p, batch, stream);
  else launch<T, 8>(p, batch, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (nonzero when the launch was refused or the arguments are bad).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o,
    int64_t q_sb, int64_t q_sh, int64_t q_ss,
    int64_t k_sb, int64_t k_sh, int64_t k_ss,
    int64_t v_sb, int64_t v_sh, int64_t v_ss,
    int64_t o_sb, int64_t o_sh, int64_t o_ss,
    int batch, int hq, int hkv, int sq, int skv, int d,
    int causal, int window, float scale, int dtype, void* stream) {
  if (d < 1 || d > 128 || hkv < 1 || hq % hkv != 0 || sq < 1 || skv < 1 ||
      batch < 1 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, o,
           q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
           o_sb, o_sh, o_ss,
           hq, hkv, sq, skv, d, causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) launch_for_dim<float>(p, batch, s);
  else launch_for_dim<__nv_bfloat16>(p, batch, s);
  return static_cast<int>(cudaGetLastError());
}
