// RWKV6 (Finch) WKV recurrence, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/wkv6/kernel.py, wkv6_pallas (pl.pallas_call
//   at :74) and its _kernel. Same function, per (batch, head), from a zero
//   state S (dk x dv, f32):
//     y_t[j] = sum_i r_t[i] * (S[i,j] + u[i] * k_t[i] * v_t[j])
//     S[i,j] <- w_t[i] * S[i,j] + k_t[i] * v_t[j]
//   returning y (B, H, T, dv) f32 and the final S (B, H, dk, dv) f32. The
//   TPU kernel cuts T into chunks only because VMEM tiles the time axis
//   (and then must not apply the padded tail steps); a CUDA block loops
//   over T itself, so there is no padding and no step to mask.
//
// What bounds it on the H100: at the serving shape (B = 32, H = 40,
// T = 64, dk = dv = 64; r/k/v bf16, w f32) the inputs are ~52 MB and the
// outputs ~42 MB, about 28 us at 3.35 TB/s; the ~2 GFLOP of f32 work is
// about as long on the CUDA cores (67 TFLOP/s). Neither bound is reached
// by this first kernel: the scan over T is 64 dependent steps, so the
// design is a latency design. One block per (batch, head) with one thread
// per state column: thread j keeps S[:, j] (dk floats) in registers for
// the whole scan, so the state never leaves the SM. The time axis is
// staged CHUNK steps at a time: r, k, w (dk each) and v (dv) of CHUNK
// steps are loaded into shared memory together (all loads in flight, one
// pair of barriers per chunk instead of one per step), converted to f32;
// then every step reads them as broadcasts. dk is a template parameter
// (16, 32 or 64, the tail zero-filled), so the per-step loop over i is
// unrolled and S stays in registers; zero k and w rows keep the padded
// state rows at exactly 0. y is summed in four partial accumulators to
// shorten its dependent chain. CUDA cores in f32; no tensor cores: the
// exact rank-1 updates are what the reference computes (a chunked matmul
// form would trade that exactness for throughput, as the TPU kernel's own
// note says).
//
// Inputs are read through their strides (the model hands over
// (B, S, H, hd) -> (B, H, S, hd) transposed views); y is written through
// its strides (the wrapper lays it out (B, T, H, dv)).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxDim = 64;      // dk, dv <= 64
constexpr int kChunk = 16;       // time steps staged per shared-memory fill

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

struct Params {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;
  float* y;
  float* s_out;       // (B, H, dk, dv) contiguous
  // element strides of (batch, head, time, feature)
  int64_t r_s[4], k_s[4], v_s[4], w_s[4], y_s[4];
  int64_t u_s[2];     // (head, feature)
  int h, t, dk, dv;
};

template <typename T, int DK>
__global__ void __launch_bounds__(kMaxDim)
wkv6_kernel(const Params p) {
  __shared__ __align__(16) float rs[kChunk][DK];
  __shared__ __align__(16) float ks[kChunk][DK];
  __shared__ __align__(16) float ws[kChunk][DK];
  __shared__ __align__(16) float us[DK];
  __shared__ float vs[kChunk][kMaxDim];

  const int b = blockIdx.x / p.h;
  const int h = blockIdx.x % p.h;
  const int j = threadIdx.x;                 // state column; >= dv: loads only
  const int nt = blockDim.x;

  const T* rp = static_cast<const T*>(p.r) + b * p.r_s[0] + h * p.r_s[1];
  const T* kp = static_cast<const T*>(p.k) + b * p.k_s[0] + h * p.k_s[1];
  const T* vp = static_cast<const T*>(p.v) + b * p.v_s[0] + h * p.v_s[1];
  const float* wp = p.w + b * p.w_s[0] + h * p.w_s[1];
  const float* up = p.u + h * p.u_s[0];
  float* yp = p.y + b * p.y_s[0] + h * p.y_s[1];

  for (int i = j; i < DK; i += nt) us[i] = i < p.dk ? up[i * p.u_s[1]] : 0.f;

  float s[DK];
#pragma unroll
  for (int i = 0; i < DK; ++i) s[i] = 0.f;

  for (int t0 = 0; t0 < p.t; t0 += kChunk) {
    const int n = min(kChunk, p.t - t0);
    __syncthreads();                         // previous chunk consumed
    for (int e = j; e < kChunk * DK; e += nt) {
      const int tt = e / DK;
      const int c = e % DK;
      float rv = 0.f, kv = 0.f, wv = 0.f;
      if (tt < n && c < p.dk) {
        const int64_t ti = t0 + tt;
        rv = to_f32(rp[ti * p.r_s[2] + c * p.r_s[3]]);
        kv = to_f32(kp[ti * p.k_s[2] + c * p.k_s[3]]);
        wv = wp[ti * p.w_s[2] + c * p.w_s[3]];
      }
      rs[tt][c] = rv;
      ks[tt][c] = kv;
      ws[tt][c] = wv;
    }
    for (int e = j; e < kChunk * kMaxDim; e += nt) {
      const int tt = e / kMaxDim;
      const int c = e % kMaxDim;
      vs[tt][c] = (tt < n && c < p.dv)
          ? to_f32(vp[(t0 + tt) * p.v_s[2] + c * p.v_s[3]]) : 0.f;
    }
    __syncthreads();
    if (j < p.dv) {
      for (int tt = 0; tt < n; ++tt) {
        const float vt = vs[tt][j];
        float y0 = 0.f, y1 = 0.f, y2 = 0.f, y3 = 0.f;
#pragma unroll
        for (int i = 0; i < DK; i += 4) {
          const float4 r4 = *reinterpret_cast<const float4*>(&rs[tt][i]);
          const float4 k4 = *reinterpret_cast<const float4*>(&ks[tt][i]);
          const float4 w4 = *reinterpret_cast<const float4*>(&ws[tt][i]);
          const float4 u4 = *reinterpret_cast<const float4*>(&us[i]);
          float kv;
          kv = k4.x * vt; y0 += r4.x * (s[i] + u4.x * kv); s[i] = w4.x * s[i] + kv;
          kv = k4.y * vt; y1 += r4.y * (s[i + 1] + u4.y * kv); s[i + 1] = w4.y * s[i + 1] + kv;
          kv = k4.z * vt; y2 += r4.z * (s[i + 2] + u4.z * kv); s[i + 2] = w4.z * s[i + 2] + kv;
          kv = k4.w * vt; y3 += r4.w * (s[i + 3] + u4.w * kv); s[i + 3] = w4.w * s[i + 3] + kv;
        }
        yp[(t0 + tt) * p.y_s[2] + j * p.y_s[3]] = (y0 + y1) + (y2 + y3);
      }
    }
  }

  if (j < p.dv) {
    float* sp = p.s_out + (static_cast<int64_t>(blockIdx.x) * p.dk) * p.dv + j;
#pragma unroll
    for (int i = 0; i < DK; ++i)
      if (i < p.dk) sp[static_cast<int64_t>(i) * p.dv] = s[i];
  }
}

template <typename T>
void launch(const Params& p, int batch, cudaStream_t stream) {
  const int threads = ((p.dv + 31) / 32) * 32;
  const dim3 grid(batch * p.h);
  if (p.dk <= 16) wkv6_kernel<T, 16><<<grid, threads, 0, stream>>>(p);
  else if (p.dk <= 32) wkv6_kernel<T, 32><<<grid, threads, 0, stream>>>(p);
  else wkv6_kernel<T, 64><<<grid, threads, 0, stream>>>(p);
}

}  // namespace

// strides: 22 int64 — r, k, v, w, y as (batch, head, time, feature), then
// u as (head, feature). dtype: 0 = float32, 1 = bfloat16 (r, k, v share
// it; w and u are float32). Returns cudaGetLastError() after the
// launch (nonzero when the launch was refused or the arguments are bad).
extern "C" int wkv6_launch(
    const void* r, const void* k, const void* v, const float* w,
    const float* u, float* y, float* s_out, const int64_t* strides,
    int batch, int h, int t, int dk, int dv, int dtype, void* stream) {
  if (batch < 1 || h < 1 || t < 1 || dk < 1 || dk > kMaxDim || dv < 1 ||
      dv > kMaxDim || (dtype != 0 && dtype != 1) ||
      static_cast<int64_t>(batch) * h > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.r = r; p.k = k; p.v = v; p.w = w; p.u = u; p.y = y; p.s_out = s_out;
  for (int d = 0; d < 4; ++d) {
    p.r_s[d] = strides[d];
    p.k_s[d] = strides[4 + d];
    p.v_s[d] = strides[8 + d];
    p.w_s[d] = strides[12 + d];
    p.y_s[d] = strides[16 + d];
  }
  p.u_s[0] = strides[20];
  p.u_s[1] = strides[21];
  p.h = h; p.t = t; p.dk = dk; p.dv = dv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) launch<float>(p, batch, s);
  else launch<__nv_bfloat16>(p, batch, s);
  return static_cast<int>(cudaGetLastError());
}
