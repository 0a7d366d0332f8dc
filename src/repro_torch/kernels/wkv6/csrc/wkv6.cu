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
// The bonus is hoisted out of the sum over i: with the scalar
//     a_t = sum_i r_t[i] * u[i] * k_t[i],
//   y_t[j] = sum_i r_t[i] * S_{t-1}[i,j] + a_t * v_t[j]. a_t is computed
//   once per step while the inputs are staged, and a_t * v_t[j] is added
//   when y is written out, so each (step, i, j) costs three f32
//   instructions: y += r*S (FMA), S *= w (MUL), S += k*v (FMA). That is
//   the reference's arithmetic up to summation order and the one rounding
//   fma(k, v, w*S) saves.
//
// What bounds it on the H100. At the serving shape (B = 32, H = 40, T =
// 64, dk = dv = 64; r/k/v bf16, w f32) the inputs are ~52 MB and the
// outputs ~42 MB: 0.028 ms at 3.35 TB/s. The work is 1280 (batch, head)
// scans of 64 dependent steps over 4096 state elements. A warp-step (32
// elements a thread) is ~130 warp instructions: 96 FP, 6 LDS.128, the
// y sum and addressing; 1280 x 4 warps x 64 steps of it is ~0.04 ms of
// issue on 132 SMs x 4 schedulers, and the LDS.128s (4 shared-memory
// wavefronts each) about as long on the SMs' shared-memory pipes: the
// issue floor lies above the byte bound. The design is laid out for
// that floor:
//
// - Threads and state. One block of 128 threads per (batch, head). Thread
//   (warp w, lane l) holds the state columns jc..jc+3 (jc = 4 (4w + l/8))
//   and the rows 4 (g + 8m) + q (row group g = l % 8, m < dk/32, q < 4):
//   4 x 8 = 32 registers of state for dk = 64, never leaving the SM. The
//   8 row groups of a column quad sit in adjacent lanes, so a step's sum
//   of y over i is three __shfl_xor_sync in the warp (halving the columns
//   at each level) and needs no barrier. Each LDS.128 of r, k or w serves
//   16 state elements, and the 8 row groups of a warp read 128 contiguous
//   bytes (no bank conflict). Loads of one step are volatile, so they
//   stay in the order written and hold one row quad at a time.
// - Registers and occupancy. The state takes 32 of a thread's registers;
//   what a step needs beyond it (a row quad, the v quad, 4 y partials,
//   addresses) does not fit the 48 that 10 blocks of 128 threads per SM
//   allow: every 48-register build spilled and ran slower than the 56
//   of __launch_bounds__(128, 9). So 9 blocks (36 warps) are resident per
//   SM, 1188 of the serving shape's 1280, and 92 run as a second round;
//   shared memory is ~20.4 KB a block for bf16 (10 would fit the SM's
//   228 KB), ~26.4 KB for f32 inputs (8 fit, with 64 registers).
// - Staging. T is staged kChunk = 8 steps at a time. Chunk c+1 is copied
//   while chunk c is computed: raw rows in two buffers, 16-byte cp.async
//   copies of whole rows on the serving layout (VEC: unit feature stride,
//   rows on 16 bytes and a multiple of 16 bytes long; the wrapper checks,
//   and so does the launcher), element by element otherwise. Each chunk
//   is then converted once to f32 into one step row per step (r, k, w, v,
//   y, a_t), zero past dk and dv, in a short pass that also sums a_t; a
//   step past T gets w = 1 and zeros, so the step loop always runs kChunk
//   steps and such a step leaves the state as it is. A step row's y slots
//   collect the step's output, written out coalesced (plus a_t v_t)
//   during the next chunk. Two barriers per chunk.
// - No tensor cores. The exact rank-1 update per step is what the
//   reference computes. A chunked matmul form (state passed between
//   chunks, intra-chunk products on the tensor cores) needs the products
//   of decays over a chunk; a step's decay is as small as exp(-e^2) =
//   6.2e-4, so over 16 steps the product reaches ~1e-51, below f32's
//   range: that form needs log-space pairwise decays or sub-chunks (and
//   3xTF32 splits for f32 accuracy) before its first result is right.
//
// Inputs are read through their strides (the model hands over
// (B, S, H, hd) -> (B, H, S, hd) transposed views); y is written through
// its batch, head and time strides (the wrapper lays it out (B, T, H, dv)).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "tile_mma.cuh"

namespace {

constexpr int kMaxDim = 64;      // dk, dv <= 64
constexpr int kChunk = 8;        // time steps per stage
constexpr int kThreads = 128;    // 16 column quads x 8 row groups
constexpr int kRowGroups = 8;

// resident blocks per SM the registers must allow: 9 (a cap of 56
// registers) for the serving instantiations, bf16 rows staged by cp.async;
// 8 (64 registers) for the rest, whose f32 stages or element loads are
// not the serving path (f32 stages' shared memory fits 8 blocks anyway)
template <typename T, bool VEC>
constexpr int min_blocks() { return VEC && sizeof(T) == 2 ? 9 : 8; }
// one f32 step row: r, k, w, v, y (kMaxDim each), a_t, padded to 16 bytes
constexpr int kR = 0, kK = 64, kW = 128, kV = 192, kY = 256, kA = 320;
constexpr int kStepRow = 324;

struct Params {
  const void* x[4];   // r, k, v (dtype T), w (f32)
  const float* u;
  float* y;
  float* s_out;       // (B, H, dk, dv) contiguous
  int64_t st[5][4];   // element strides (batch, head, time, feature) of r, k, v, w, y
  int64_t u_s[2];     // (head, feature)
  int h, t, dk, dv;
};

template <typename T, int DK>
struct Smem {
  static constexpr int kRowBytes = DK * sizeof(T);            // r, k
  static constexpr int kVRowBytes = kMaxDim * sizeof(T);      // v
  static constexpr int kWRowBytes = DK * sizeof(float);       // w
  // raw rows as loaded, two buffers
  uint4 r[2][kChunk * kRowBytes / 16];
  uint4 k[2][kChunk * kRowBytes / 16];
  uint4 v[2][kChunk * kVRowBytes / 16];
  uint4 w[2][kChunk * kWRowBytes / 16];
  float step[kChunk][kStepRow];
  float u[DK];
  const char* base[5];  // r, k, v, w, y at this (batch, head)
};

// a shared pointer read after a barrier, never kept in a register across one
__device__ __forceinline__ const char* shared_ptr(const char* const& p) {
  return *const_cast<const char* const volatile*>(&p);
}

template <typename T> __device__ __forceinline__ float2 load_pair(const T* p);
template <> __device__ __forceinline__ float2 load_pair<float>(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
template <> __device__ __forceinline__ float2 load_pair<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// steps [t0, t0 + n) of one input (rows of ``width`` elements E at time
// stride ts and feature stride fs, in elements) into a raw buffer of rows
// of ROW_BYTES. VEC: 16-byte cp.async pieces of whole rows (fs == 1, rows
// on 16 bytes, width * sizeof(E) % 16 == 0); else one element per thread
// and load. Whatever lies past ``width`` or ``n`` is left as it was.
template <typename E, int ROW_BYTES, bool VEC>
__device__ __forceinline__ void stage_rows(void* dst, const char* src, int64_t ts,
                                           int64_t fs, int width, int t0, int n,
                                           int rot) {
  if constexpr (VEC) {
    constexpr int kPieces = ROW_BYTES / 16;
    constexpr int kTotal = kChunk * kPieces;
    const int pieces = width * static_cast<int>(sizeof(E)) / 16;
    const uint32_t d = smem_addr(dst);
#pragma unroll
    for (int e0 = 0; e0 < kTotal; e0 += kThreads) {
      const int e = e0 + ((threadIdx.x + rot) % kThreads);
      const int tt = e / kPieces;
      const int c = e % kPieces;
      if (e < kTotal && tt < n && c < pieces)
        cp_async16(d + tt * ROW_BYTES + c * 16,
                   src + ((t0 + tt) * ts) * static_cast<int64_t>(sizeof(E)) + c * 16, true);
    }
  } else {
    constexpr int kWidth = ROW_BYTES / static_cast<int>(sizeof(E));
    E* d = static_cast<E*>(dst);
    const E* s = reinterpret_cast<const E*>(src);
#pragma unroll 2
    for (int e = threadIdx.x; e < kChunk * kWidth; e += kThreads) {
      const int tt = e / kWidth;
      const int c = e % kWidth;
      if (tt < n && c < width) d[e] = s[(t0 + tt) * ts + c * fs];
    }
  }
}

template <typename T, int DK, bool VEC>
__device__ __forceinline__ void stage(Smem<T, DK>& sm, const Params& p, int buf,
                                      int t0, int n) {
  using S = Smem<T, DK>;
  stage_rows<T, S::kRowBytes, VEC>(sm.r[buf], shared_ptr(sm.base[0]), p.st[0][2],
                                   p.st[0][3], p.dk, t0, n, 0);
  stage_rows<T, S::kRowBytes, VEC>(sm.k[buf], shared_ptr(sm.base[1]), p.st[1][2],
                                   p.st[1][3], p.dk, t0, n, 64);
  stage_rows<T, S::kVRowBytes, VEC>(sm.v[buf], shared_ptr(sm.base[2]), p.st[2][2],
                                    p.st[2][3], p.dv, t0, n, 32);
  stage_rows<float, S::kWRowBytes, VEC>(sm.w[buf], shared_ptr(sm.base[3]), p.st[3][2],
                                        p.st[3][3], p.dk, t0, n, 0);
}

// raw buffer ``buf`` -> f32 step rows, and a_t = sum_i r_t[i] u[i] k_t[i].
// Zero past dk and dv; a step past the n live ones gets w = 1 and zeros
// elsewhere, so it leaves the state as it is (the step loop always runs
// kChunk steps). Warp w converts steps w and w + 4; lane l the feature
// pair 2l, 2l+1.
template <typename T, int DK>
__device__ __forceinline__ void convert(Smem<T, DK>& sm, int buf, int n, int dk, int dv) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int i = 2 * lane;
  const T* rr = reinterpret_cast<const T*>(sm.r[buf]);
  const T* kr = reinterpret_cast<const T*>(sm.k[buf]);
  const T* vr = reinterpret_cast<const T*>(sm.v[buf]);
  const float* wr = reinterpret_cast<const float*>(sm.w[buf]);
#pragma unroll
  for (int q = 0; q < kChunk / 4; ++q) {
    const int tt = warp + 4 * q;
    float* row = sm.step[tt];
    const bool live = tt < n;
    float a = 0.f;
    if (i < DK) {
      float2 r2 = make_float2(0.f, 0.f), k2 = r2, w2 = live ? r2 : make_float2(1.f, 1.f);
      if (live && i < dk) {
        r2 = load_pair(rr + tt * DK + i);
        k2 = load_pair(kr + tt * DK + i);
        w2 = load_pair(wr + tt * DK + i);
        if (i + 1 >= dk) r2.y = k2.y = w2.y = 0.f;
      }
      const float2 u2 = *reinterpret_cast<const float2*>(&sm.u[i]);
      a = r2.x * u2.x * k2.x + r2.y * u2.y * k2.y;
      *reinterpret_cast<float2*>(row + kR + i) = r2;
      *reinterpret_cast<float2*>(row + kK + i) = k2;
      *reinterpret_cast<float2*>(row + kW + i) = w2;
    }
    float2 v2 = make_float2(0.f, 0.f);
    if (live && i < dv) {
      v2 = load_pair(vr + tt * kMaxDim + i);
      if (i + 1 >= dv) v2.y = 0.f;
    }
    *reinterpret_cast<float2*>(row + kV + i) = v2;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
    if (lane == 0) row[kA] = a;
  }
}

// y = the y slots + a_t v_t of the step rows of steps [t0, t0 + n); lane
// l writes columns l and l + 32 of warp w's steps w and w + 4
template <typename T, int DK>
__device__ __forceinline__ void write_y(const Smem<T, DK>& sm, const Params& p,
                                        int t0, int n) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* y = reinterpret_cast<float*>(const_cast<char*>(shared_ptr(sm.base[4])));
#pragma unroll
  for (int q = 0; q < kChunk / 4; ++q) {
    const int tt = warp + 4 * q;
    if (tt >= n) continue;
    float* yt = y + (t0 + tt) * p.st[4][2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = lane + 32 * half;
      if (c < p.dv) yt[c] = fmaf(sm.step[tt][kA], sm.step[tt][kV + c], sm.step[tt][kY + c]);
    }
  }
}

// a 16-byte shared load kept in program order: volatile loads are issued
// in the order written, so the registers beyond the state hold one row
// quad at a time instead of loads hoisted past the register cap
__device__ __forceinline__ float4 ld4(const float* p) {
  float4 v;
  asm volatile("ld.volatile.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(smem_addr(p)));
  return v;
}

template <typename T, int DK, bool VEC>
__global__ void __launch_bounds__(kThreads, min_blocks<T, VEC>())
wkv6_kernel(const Params p) {
  constexpr int kM = DK / (4 * kRowGroups);   // row quads per thread
  __shared__ __align__(16) Smem<T, DK> sm;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane & (kRowGroups - 1);      // row group: rows 4 (g + 8m) + q
  const int jc = 4 * (tid / kRowGroups);     // columns jc..jc+3
  // the column whose y this lane holds after the sum over row groups:
  // jc + 2 ((g >> 2) & 1) + ((g >> 1) & 1), which is tid / 2
  const int own = tid >> 1;
  const int b = blockIdx.x / p.h;
  const int h = blockIdx.x % p.h;

  if (tid < 5) {
    const int64_t elem = tid < 3 ? sizeof(T) : sizeof(float);
    const char* x = tid < 4 ? static_cast<const char*>(p.x[tid])
                            : reinterpret_cast<const char*>(p.y);
    sm.base[tid] = x + (b * p.st[tid][0] + h * p.st[tid][1]) * elem;
  }
  if (tid < DK) sm.u[tid] = tid < p.dk ? p.u[h * p.u_s[0] + tid * p.u_s[1]] : 0.f;

  float s[kM][4][4];                          // [quad][row in quad][column]
#pragma unroll
  for (int m = 0; m < kM; ++m)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[m][q][c] = 0.f;

  __syncthreads();                            // bases visible to every thread
  stage<T, DK, VEC>(sm, p, 0, 0, min(kChunk, p.t));
  cp_async_commit();

  for (int t0 = 0; t0 < p.t; t0 += kChunk) {
    const int buf = (t0 / kChunk) & 1;
    const int n = min(kChunk, p.t - t0);
    cp_async_wait<0>();
    __syncthreads();                          // raw chunk landed; step rows free
    if (t0 + kChunk < p.t) {
      stage<T, DK, VEC>(sm, p, buf ^ 1, t0 + kChunk, min(kChunk, p.t - t0 - kChunk));
      cp_async_commit();
    }
    // write_y reads, and convert then overwrites, the step rows w and
    // w + 4 of warp w only: a warp barrier orders the two
    if (t0 > 0) write_y(sm, p, t0 - kChunk, kChunk);
    __syncwarp();
    convert(sm, buf, n, p.dk, p.dv);
    __syncthreads();                          // step rows ready

    // not unrolled: steps share no loads, and an unrolled chunk lets the
    // compiler hoist the next steps' loads past the register cap
#pragma unroll 1
    for (int tt = 0; tt < kChunk; ++tt) {
      float* row = sm.step[tt];
      // y partials of the 4 columns over this thread's rows (old state)
      float y[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        const float4 r4 = ld4(row + kR + 4 * (g + kRowGroups * m));
        const float rq[4] = {r4.x, r4.y, r4.z, r4.w};
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int c = 0; c < 4; ++c) y[c] = fmaf(rq[q], s[m][q][c], y[c]);
      }
      // sum over the 8 row groups (lanes xor 4, 2, 1), halving the
      // columns at each level: the lane keeps column own - jc
      const bool hi2 = g & 4, hi1 = g & 2;
      const float k0 = (hi2 ? y[2] : y[0]) +
                       __shfl_xor_sync(0xffffffffu, hi2 ? y[0] : y[2], 4);
      const float k1 = (hi2 ? y[3] : y[1]) +
                       __shfl_xor_sync(0xffffffffu, hi2 ? y[1] : y[3], 4);
      float yo = (hi1 ? k1 : k0) + __shfl_xor_sync(0xffffffffu, hi1 ? k0 : k1, 2);
      yo += __shfl_xor_sync(0xffffffffu, yo, 1);
      if (!(g & 1)) row[kY + own] = yo;       // y - a v: write_y adds a v

      // the state update, one row quad at a time
      const float4 v4 = ld4(row + kV + jc);
      const float vc[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        const int i = 4 * (g + kRowGroups * m);
        const float4 w4 = ld4(row + kW + i);
        const float wq[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[m][q][c] *= wq[q];
        const float4 k4 = ld4(row + kK + i);
        const float kq[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[m][q][c] = fmaf(kq[q], vc[c], s[m][q][c]);
      }
    }
  }
  __syncthreads();                            // the last chunk's y slots
  const int last = ((p.t - 1) / kChunk) * kChunk;
  write_y(sm, p, last, p.t - last);

  float* so = p.s_out + static_cast<int64_t>(blockIdx.x) * p.dk * p.dv;
#pragma unroll
  for (int m = 0; m < kM; ++m)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = 4 * (g + kRowGroups * m) + q;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (i < p.dk && jc + c < p.dv) so[i * p.dv + jc + c] = s[m][q][c];
    }
}

template <typename T, bool VEC>
const void* pick_dk(int dk) {
  if (dk <= 32) return reinterpret_cast<const void*>(wkv6_kernel<T, 32, VEC>);
  return reinterpret_cast<const void*>(wkv6_kernel<T, 64, VEC>);
}

// the instantiation for dtype (0 f32, 1 bf16), dk and variant (0 scalar,
// 1 vec16), with the shared-memory carveout at its maximum so that the
// blocks' shared memory never limits residency below the registers'
const void* kernel_for(int dtype, int dk, int variant) {
  const void* fn = dtype == 0 ? (variant ? pick_dk<float, true>(dk) : pick_dk<float, false>(dk))
                              : (variant ? pick_dk<__nv_bfloat16, true>(dk)
                                         : pick_dk<__nv_bfloat16, false>(dk));
  cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
  return fn;
}

bool valid_args(int dk, int dtype, int variant) {
  return dk >= 1 && dk <= kMaxDim && (dtype == 0 || dtype == 1) &&
         (variant == 0 || variant == 1);
}

// what the vec16 variant's copies need of one input: unit feature stride,
// rows on 16 bytes (pointer and every stride of an axis longer than 1)
// and a multiple of 16 bytes long
bool rows16(const void* x, const int64_t* st, int64_t elem, int width,
            int batch, int h, int t) {
  const int64_t len[3] = {batch, h, t};
  bool ok = reinterpret_cast<uintptr_t>(x) % 16 == 0 && st[3] == 1 &&
            (width * elem) % 16 == 0;
  for (int d = 0; d < 3; ++d) ok = ok && (len[d] == 1 || (st[d] * elem) % 16 == 0);
  return ok;
}

}  // namespace

// strides: 22 int64 — r, k, v, w, y as (batch, head, time, feature), then
// u as (head, feature); y's feature stride must be 1. dtype: 0 = float32, 1 = bfloat16 (r, k, v share
// it; w and u are float32). variant: 0 = scalar (any strides), 1 = vec16
// (cp.async rows: refused unless r, k, v, w have them). Returns
// cudaGetLastError() after the launch (nonzero when the launch was refused
// or the arguments are bad).
extern "C" int wkv6_launch(
    const void* r, const void* k, const void* v, const float* w,
    const float* u, float* y, float* s_out, const int64_t* strides,
    int batch, int h, int t, int dk, int dv, int dtype, int variant,
    void* stream) {
  if (batch < 1 || h < 1 || t < 1 || dv < 1 || dv > kMaxDim ||
      !valid_args(dk, dtype, variant) || static_cast<int64_t>(batch) * h > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.x[0] = r; p.x[1] = k; p.x[2] = v; p.x[3] = w;
  p.u = u; p.y = y; p.s_out = s_out;
  for (int a = 0; a < 5; ++a)
    for (int d = 0; d < 4; ++d) p.st[a][d] = strides[4 * a + d];
  p.u_s[0] = strides[20];
  p.u_s[1] = strides[21];
  if (p.st[4][3] != 1) return static_cast<int>(cudaErrorInvalidValue);
  p.h = h; p.t = t; p.dk = dk; p.dv = dv;
  if (variant == 1) {
    const int64_t elem = dtype == 0 ? 4 : 2;
    const int width[4] = {dk, dk, dv, dk};
    for (int a = 0; a < 4; ++a)
      if (!rows16(p.x[a], p.st[a], a < 3 ? elem : 4, width[a], batch, h, t))
        return static_cast<int>(cudaErrorInvalidValue);
  }
  void* args[] = {&p};
  cudaLaunchKernel(kernel_for(dtype, dk, variant), dim3(batch * h), dim3(kThreads),
                   args, 0, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// out[0..3] = blocks of one instantiation resident per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor at 128 threads),
// registers per thread, static shared memory bytes per block and local
// (spill) bytes per thread. Returns the first CUDA error, else 0.
extern "C" int wkv6_occupancy(int dtype, int dk, int variant, int* out) {
  if (!valid_args(dk, dtype, variant)) return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = kernel_for(dtype, dk, variant);
  cudaFuncAttributes attr{};
  cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], fn, kThreads, 0);
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(attr.sharedSizeBytes);
  out[3] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(e);
}
