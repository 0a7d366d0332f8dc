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
// The recurrence's gradient, wkv6_backward_kernel, follows the forward
// below, with its own note.
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
// stride ts and feature stride fs, in elements) into a raw buffer of ROWS
// rows of ROW_BYTES. VEC: 16-byte cp.async pieces of whole rows (fs == 1,
// rows on 16 bytes, width * sizeof(E) % 16 == 0); else one element per
// thread and load. Whatever lies past ``width`` or ``n`` is left as it
// was.
template <typename E, int ROW_BYTES, bool VEC, int ROWS = kChunk>
__device__ __forceinline__ void stage_rows(void* dst, const char* src, int64_t ts,
                                           int64_t fs, int width, int t0, int n,
                                           int rot) {
  if constexpr (VEC) {
    constexpr int kPieces = ROW_BYTES / 16;
    constexpr int kTotal = ROWS * kPieces;
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
    for (int e = threadIdx.x; e < ROWS * kWidth; e += kThreads) {
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

// ------------------------------------------------------------- backward
//
// The gradient of the recurrence above, which no TPU kernel computes: the
// reference differentiates the plain lax.scan of
// src/repro/kernels/wkv6/ref.py with XLA. `WKV6` (ops.py) calls it as the
// backward of wkv6_kernel. Per (batch, head), with G_t = dL/dS_t and G_T
// the final state's cotangent (zero without one):
//   G_{t-1} = diag(w_t) G_t + r_t dy_t^T
//   dr_t    = S_{t-1} dy_t + u * k_t * (v_t . dy_t)
//   dk_t    = G_t v_t + r_t * u * (v_t . dy_t)
//   dv_t    = G_t^T k_t + a_t dy_t             (a_t = sum_i r_t u k_t)
//   dw_t[i] = sum_j G_t[i,j] S_{t-1}[i,j]
//   du      = sum_{b,t} r_t * k_t * (v_t . dy_t)
// all in f32 on the CUDA cores; dr, dk and dv are written in the inputs'
// dtype, dw and du in f32.
//
// The design point: dw_t needs S_{t-1} and G_t at the same step, and the
// two run in opposite directions. S_{t-1} is never rebuilt backwards as
// (S_t - k_t v_t^T) / w_t: w falls to exp(-e^2) = 6.2e-4, so each step
// would amplify round-off up to 1600x; nor is dw taken from the
// suffix-sum identity w_t dw_t = sum r dr' - sum k dk', whose cancellation
// costs about four decimal digits in f32 at T = 1024. The states are
// recomputed instead:
// - pass 0: the forward recurrence from S = 0 writes the state at every
//   chunk start (every C steps) to an f32 scratch (B*H, ceil(T/C), 64 x 64)
//   the wrapper allocates;
// - then the chunks in reverse: the chunk's first state from the scratch,
//   C forward steps that leave each S_{t-1} in shared memory, then the
//   chunk's steps in reverse with G in registers.
// The forward recurrence runs twice; the scratch is written once and read
// once, T/C - 1 states of 16 KB a (batch, head) each way.
//
// Threads. One block of 128 per (batch, head). Thread (row i = tid / 2,
// half = tid % 2) holds columns 32 half .. 32 half + 31 of row i of S and
// of G (zero past dk and dv): dr, dk and dw of a row are sums over its
// columns, one shuffle between the pair; dv's sum over rows is a butterfly
// over the warp's 16 rows (lanes xor 2, 4, 8, 16, halving the columns at
// each level, 16 columns at a time) and, when a chunk is written out, a
// sum of the 4 warps' partials. Each thread keeps its S_{t-1} in slots of
// its own (float4 [step][quad][thread]: no bank conflict) and du's partial
// of its row (a compensated sum); a second kernel adds the partials over
// the batch in order. No atomics: two launches give bitwise equal
// gradients.
//
// Shared memory and the chunk C (kBwdChunk = 4). A block holds C states
// (C x 16 KB), C f32 step rows (1.3 KB each), C output rows (1.75 KB) and
// the raw rows of two chunks (cp.async stages the next chunk while one
// runs; 0.9 KB a step for bf16 inputs, 1.25 KB for f32): about C x 21 KB,
// so 2 resident blocks an SM of its 228 KB, and the register cap of two
// blocks (__launch_bounds__) leaves room for S, G and a step's sums. A
// smaller C would move more states through the scratch under a tighter
// register cap; a larger one would keep one block an SM.
//
// What bounds it: at (16, 40, 64, 64) the inputs (r/k/v bf16, w and dy
// f32) and the gradients (dr/dk/dv bf16, dw f32) are ~63 MB, 0.019 ms at
// 3.35 TB/s; the scratch adds 2 x 15 states of 16 KB a block (0.31 GB);
// 14 f32 operations a (step, i, j) (the recomputed update 3, G's update 3,
// dr, dk, dv and dw 2 each) are 2.35 GFLOP, 0.035 ms at 67 TFLOP/s. It is
// a first kernel, right before fast: its steps are serial, and each one
// costs shuffles and shared-memory loads beside its FMAs.

constexpr int kBwdThreads = 128;  // 64 rows x 2 column halves
constexpr int kBwdInputs = 5;     // r, k, v (dtype T), w, dy (f32)
constexpr int kBwdOutputs = 4;    // dr, dk, dv (dtype T), dw (f32)
// one f32 step row: r, k, w (64 each), v and dy (68 each: columns 32..63
// sit four floats on, so the two halves' 16-byte broadcasts fall in other
// banks), a_t and v_t . dy_t, padded to 16 bytes
constexpr int kBR = 0, kBK = 64, kBW = 128, kBV = 192, kBDY = 260, kBA = 328,
              kBVDY = 329;
constexpr int kBStepRow = 332;
constexpr int kHalfStride = 36;   // floats from column 0 to column 32
// one output row: dr, dk, dw (64 each) and the 4 warps' dv partials
constexpr int kODR = 0, kODK = 64, kODW = 128, kODV = 192;
constexpr int kOutRow = 448;

__device__ __forceinline__ int half_col(int j) { return j + (j >= 32 ? 4 : 0); }

constexpr int kBwdChunk = 4;      // steps between saved states (see above)
// resident blocks per SM the shared memory allows, which the register cap
// then keeps
constexpr int kBwdMinBlocks = 2;

struct BwdParams {
  const void* x[kBwdInputs];
  const float* u;
  const float* ds;      // (B, H, dk, dv) cotangent of the final state, or null
  void* g[kBwdOutputs];
  float4* ckpt;         // (B*H, nc, 8, 128): the state at each chunk start
  float* du_part;       // (B*H, dk)
  int64_t st[kBwdInputs + kBwdOutputs][4];  // (batch, head, time, feature)
  int64_t u_s[2];
  int64_t ds_s[4];
  int h, t, dk, dv, nc;
};

template <typename T>
struct BwdSmem {
  static constexpr int kRowBytes = kMaxDim * sizeof(T);   // r, k, v
  static constexpr int kFRowBytes = kMaxDim * sizeof(float);  // w, dy
  float4 slot[kBwdChunk][8][kBwdThreads];  // each thread's S_{t-1}, 32 floats a step
  uint4 r[2][kBwdChunk * kRowBytes / 16];
  uint4 k[2][kBwdChunk * kRowBytes / 16];
  uint4 v[2][kBwdChunk * kRowBytes / 16];
  uint4 w[2][kBwdChunk * kFRowBytes / 16];
  uint4 dy[2][kBwdChunk * kFRowBytes / 16];
  float step[kBwdChunk][kBStepRow];
  float out[kBwdChunk][kOutRow];
  float u[kMaxDim];
  const char* base[kBwdInputs + kBwdOutputs];
};

// steps [t0, t0 + n) of the inputs into raw buffer ``buf``: k, v, w, and
// with ``all`` also r and dy (pass 0 needs only the update's inputs)
template <typename T, bool VEC>
__device__ __forceinline__ void bwd_stage(BwdSmem<T>& sm, const BwdParams& p,
                                          int buf, int t0, int n, bool all) {
  using S = BwdSmem<T>;
  if (all)
    stage_rows<T, S::kRowBytes, VEC, kBwdChunk>(sm.r[buf], shared_ptr(sm.base[0]), p.st[0][2],
                                        p.st[0][3], p.dk, t0, n, 0);
  stage_rows<T, S::kRowBytes, VEC, kBwdChunk>(sm.k[buf], shared_ptr(sm.base[1]), p.st[1][2],
                                      p.st[1][3], p.dk, t0, n, 64);
  stage_rows<T, S::kRowBytes, VEC, kBwdChunk>(sm.v[buf], shared_ptr(sm.base[2]), p.st[2][2],
                                      p.st[2][3], p.dv, t0, n, 32);
  stage_rows<float, S::kFRowBytes, VEC, kBwdChunk>(sm.w[buf], shared_ptr(sm.base[3]), p.st[3][2],
                                           p.st[3][3], p.dk, t0, n, 96);
  if (all)
    stage_rows<float, S::kFRowBytes, VEC, kBwdChunk>(sm.dy[buf], shared_ptr(sm.base[4]),
                                             p.st[4][2], p.st[4][3], p.dv, t0, n, 16);
}

// raw buffer ``buf`` -> the f32 step rows of its n steps, zero past dk and
// dv, with a_t and v_t . dy_t. Warp w converts steps w, w + 4, ...; lane l
// the feature pair 2l, 2l + 1.
template <typename T>
__device__ __forceinline__ void bwd_convert(BwdSmem<T>& sm, int buf, int n, int dk,
                                            int dv) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int i = 2 * lane;
  const T* rr = reinterpret_cast<const T*>(sm.r[buf]);
  const T* kr = reinterpret_cast<const T*>(sm.k[buf]);
  const T* vr = reinterpret_cast<const T*>(sm.v[buf]);
  const float* wr = reinterpret_cast<const float*>(sm.w[buf]);
  const float* dr = reinterpret_cast<const float*>(sm.dy[buf]);
  for (int tt = warp; tt < n; tt += kBwdThreads / 32) {
    float* row = sm.step[tt];
    float2 r2 = make_float2(0.f, 0.f), k2 = r2, w2 = r2, v2 = r2, d2 = r2;
    if (i < dk) {
      r2 = load_pair(rr + tt * kMaxDim + i);
      k2 = load_pair(kr + tt * kMaxDim + i);
      w2 = load_pair(wr + tt * kMaxDim + i);
      if (i + 1 >= dk) r2.y = k2.y = w2.y = 0.f;
    }
    if (i < dv) {
      v2 = load_pair(vr + tt * kMaxDim + i);
      d2 = load_pair(dr + tt * kMaxDim + i);
      if (i + 1 >= dv) v2.y = d2.y = 0.f;
    }
    *reinterpret_cast<float2*>(row + kBR + i) = r2;
    *reinterpret_cast<float2*>(row + kBK + i) = k2;
    *reinterpret_cast<float2*>(row + kBW + i) = w2;
    *reinterpret_cast<float2*>(row + kBV + half_col(i)) = v2;
    *reinterpret_cast<float2*>(row + kBDY + half_col(i)) = d2;
    float a = r2.x * sm.u[i] * k2.x + r2.y * sm.u[i + 1] * k2.y;
    float vd = v2.x * d2.x + v2.y * d2.y;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, off);
      vd += __shfl_xor_sync(0xffffffffu, vd, off);
    }
    if (lane == 0) {
      row[kBA] = a;
      row[kBVDY] = vd;
    }
  }
}

// S <- diag(w_t) S + k_t v_t^T on this thread's row and column half
__device__ __forceinline__ void bwd_update(const float* row, float (&s)[32], int i,
                                           int half) {
  const float kk = row[kBK + i], ww = row[kBW + i];
  const float* vrow = row + kBV + kHalfStride * half;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const float4 v4 = *reinterpret_cast<const float4*>(vrow + 4 * q);
    const float vq[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) s[4 * q + e] = fmaf(kk, vq[e], ww * s[4 * q + e]);
  }
}

// one step of the backward: the step's dr, dk, dw (row owners) and dv
// partials (each warp over its 16 rows) into ``out``, du's term added to
// (du, du_c), then G <- diag(w_t) G + r_t dy_t^T
__device__ __forceinline__ void bwd_step(const float* row, float* out, const float4* slot,
                                         float (&g)[32], const float* u, int i, int half,
                                         float& du, float& du_c) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float ri = row[kBR + i], ki = row[kBK + i], wi = row[kBW + i];
  const float* vrow = row + kBV + kHalfStride * half;
  const float* drow = row + kBDY + kHalfStride * half;
  float dr = 0.f, dk = 0.f, dw = 0.f;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const float4 s4 = slot[q * kBwdThreads];
    const float4 v4 = *reinterpret_cast<const float4*>(vrow + 4 * q);
    const float4 d4 = *reinterpret_cast<const float4*>(drow + 4 * q);
    const float sq[4] = {s4.x, s4.y, s4.z, s4.w};
    const float vq[4] = {v4.x, v4.y, v4.z, v4.w};
    const float dq[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dr = fmaf(sq[e], dq[e], dr);
      dk = fmaf(g[4 * q + e], vq[e], dk);
      dw = fmaf(g[4 * q + e], sq[e], dw);
    }
  }
  dr += __shfl_xor_sync(0xffffffffu, dr, 1);
  dk += __shfl_xor_sync(0xffffffffu, dk, 1);
  dw += __shfl_xor_sync(0xffffffffu, dw, 1);
  if (half == 0) {
    const float vdy = row[kBVDY];
    out[kODR + i] = fmaf(u[i] * ki, vdy, dr);
    out[kODK + i] = fmaf(ri * u[i], vdy, dk);
    out[kODW + i] = dw;
    // du += r k (v . dy), compensated (Neumaier): T * B terms of either sign
    // (the _rn intrinsics keep the compiler from fusing the sums into FMAs)
    const float term = __fmul_rn(__fmul_rn(ri, ki), vdy);
    const float sum = __fadd_rn(du, term);
    du_c = __fadd_rn(du_c, fabsf(du) >= fabsf(term) ? __fadd_rn(__fsub_rn(du, sum), term)
                                                    : __fadd_rn(__fsub_rn(term, sum), du));
    du = sum;
  }
  // dv partials: G^T k over this warp's 16 rows, 16 columns at a time
#pragma unroll
  for (int part = 0; part < 2; ++part) {
    float x[16];
#pragma unroll
    for (int c = 0; c < 16; ++c) x[c] = g[16 * part + c] * ki;
#pragma unroll
    for (int lvl = 0; lvl < 4; ++lvl) {
      const int hs = 8 >> lvl;
      const int mask = 2 << lvl;
      const bool up = lane & mask;
#pragma unroll
      for (int q = 0; q < hs; ++q) {
        const float keep = up ? x[q + hs] : x[q];
        const float send = up ? x[q] : x[q + hs];
        x[q] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
      }
    }
    const int col = 32 * half + 16 * part + ((lane & 2) ? 8 : 0) + ((lane & 4) ? 4 : 0) +
                    ((lane & 8) ? 2 : 0) + ((lane & 16) ? 1 : 0);
    out[kODV + kMaxDim * warp + col] = x[0];
  }
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const float4 d4 = *reinterpret_cast<const float4*>(drow + 4 * q);
    const float dq[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) g[4 * q + e] = fmaf(wi, g[4 * q + e], ri * dq[e]);
  }
}

// the gradients of steps [t0, t0 + n) from the output and step rows: dr,
// dk and dw as they are, dv the sum of the warps' partials plus a_t dy_t
template <typename T>
__device__ __forceinline__ void bwd_write(const BwdSmem<T>& sm, const BwdParams& p,
                                          int t0, int n) {
  for (int e = threadIdx.x; e < n * kMaxDim; e += kBwdThreads) {
    const int tt = e / kMaxDim;
    const int i = e % kMaxDim;
    const int64_t t = t0 + tt;
    const float* o = sm.out[tt];
    const float* row = sm.step[tt];
    if (i < p.dk) {
      T* dr = reinterpret_cast<T*>(const_cast<char*>(shared_ptr(sm.base[5])));
      T* dk = reinterpret_cast<T*>(const_cast<char*>(shared_ptr(sm.base[6])));
      float* dw = reinterpret_cast<float*>(const_cast<char*>(shared_ptr(sm.base[8])));
      dr[t * p.st[5][2] + i] = from_f32<T>(o[kODR + i]);
      dk[t * p.st[6][2] + i] = from_f32<T>(o[kODK + i]);
      dw[t * p.st[8][2] + i] = o[kODW + i];
    }
    if (i < p.dv) {
      T* dv = reinterpret_cast<T*>(const_cast<char*>(shared_ptr(sm.base[7])));
      const float part = ((o[kODV + i] + o[kODV + kMaxDim + i]) + o[kODV + 2 * kMaxDim + i]) +
                         o[kODV + 3 * kMaxDim + i];
      dv[t * p.st[7][2] + i] = from_f32<T>(fmaf(row[kBA], row[kBDY + half_col(i)], part));
    }
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kBwdThreads, kBwdMinBlocks)
wkv6_backward_kernel(const BwdParams p) {
  extern __shared__ uint4 bwd_smem[];
  BwdSmem<T>& sm = *reinterpret_cast<BwdSmem<T>*>(bwd_smem);
  const int tid = threadIdx.x;
  const int i = tid >> 1;                     // state row
  const int half = tid & 1;                   // columns 32 half .. 32 half + 31
  const int b = blockIdx.x / p.h;
  const int h = blockIdx.x % p.h;

  if (tid < kBwdInputs + kBwdOutputs) {
    const bool f32 = tid == 3 || tid == 4 || tid == 8;   // w, dy, dw
    const int64_t elem = f32 ? sizeof(float) : sizeof(T);
    const char* x = tid < kBwdInputs ? static_cast<const char*>(p.x[tid])
                                     : static_cast<const char*>(p.g[tid - kBwdInputs]);
    sm.base[tid] = x + (b * p.st[tid][0] + h * p.st[tid][1]) * elem;
  }
  if (tid < kMaxDim) sm.u[tid] = tid < p.dk ? p.u[h * p.u_s[0] + tid * p.u_s[1]] : 0.f;
  float4* ckpt = p.ckpt + static_cast<int64_t>(blockIdx.x) * p.nc * 8 * kBwdThreads + tid;

  float s[32];
#pragma unroll
  for (int c = 0; c < 32; ++c) s[c] = 0.f;
  __syncthreads();                            // bases and u visible to every thread

  // pass 0: the state at the start of chunks 1 .. nc-1 (each earlier chunk
  // is whole: only the last one may be short)
  if (p.nc > 1) {
    bwd_stage<T, VEC>(sm, p, 0, 0, kBwdChunk, false);
    cp_async_commit();
    for (int c = 0; c + 1 < p.nc; ++c) {
      const int buf = c & 1;
      cp_async_wait<0>();
      __syncthreads();                        // raw chunk landed; step rows free
      if (c + 2 < p.nc) {
        bwd_stage<T, VEC>(sm, p, buf ^ 1, (c + 1) * kBwdChunk, kBwdChunk, false);
        cp_async_commit();
      }
      bwd_convert(sm, buf, kBwdChunk, p.dk, p.dv);
      __syncthreads();                        // step rows ready
#pragma unroll 1
      for (int tt = 0; tt < kBwdChunk; ++tt) bwd_update(sm.step[tt], s, i, half);
#pragma unroll
      for (int q = 0; q < 8; ++q)
        ckpt[((c + 1) * 8 + q) * kBwdThreads] =
            make_float4(s[4 * q], s[4 * q + 1], s[4 * q + 2], s[4 * q + 3]);
    }
  }

  float g[32];
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    const int j = 32 * half + c;
    g[c] = p.ds != nullptr && i < p.dk && j < p.dv
               ? p.ds[b * p.ds_s[0] + h * p.ds_s[1] + i * p.ds_s[2] + j * p.ds_s[3]]
               : 0.f;
  }
  float du = 0.f, du_c = 0.f;

  const int last = p.nc - 1;
  bwd_stage<T, VEC>(sm, p, 0, last * kBwdChunk, p.t - last * kBwdChunk, true);
  cp_async_commit();
  for (int c = last; c >= 0; --c) {
    const int buf = (last - c) & 1;
    const int t0 = c * kBwdChunk;
    const int n = min(kBwdChunk, p.t - t0);
    cp_async_wait<0>();
    __syncthreads();                          // raw chunk landed; step and out rows free
    if (c > 0) {
      bwd_stage<T, VEC>(sm, p, buf ^ 1, t0 - kBwdChunk, kBwdChunk, true);
      cp_async_commit();
    }
    bwd_convert(sm, buf, n, p.dk, p.dv);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float4 s4 = c > 0 ? ckpt[(c * 8 + q) * kBwdThreads] : make_float4(0.f, 0.f, 0.f, 0.f);
      s[4 * q] = s4.x;
      s[4 * q + 1] = s4.y;
      s[4 * q + 2] = s4.z;
      s[4 * q + 3] = s4.w;
    }
    __syncthreads();                          // step rows ready
    // S_{t-1} of each step of the chunk into this thread's slots
#pragma unroll 1
    for (int tt = 0; tt < n; ++tt) {
#pragma unroll
      for (int q = 0; q < 8; ++q)
        sm.slot[tt][q][tid] = make_float4(s[4 * q], s[4 * q + 1], s[4 * q + 2], s[4 * q + 3]);
      if (tt + 1 < n) bwd_update(sm.step[tt], s, i, half);
    }
#pragma unroll 1
    for (int tt = n - 1; tt >= 0; --tt)
      bwd_step(sm.step[tt], sm.out[tt], &sm.slot[tt][0][tid], g, sm.u, i, half, du, du_c);
    __syncthreads();                          // the chunk's output rows
    bwd_write(sm, p, t0, n);
  }
  if (half == 0 && i < p.dk) p.du_part[static_cast<int64_t>(blockIdx.x) * p.dk + i] = du + du_c;
}

// du (H, dk) = the per-(batch, head) partials summed over the batch in
// order (compensated), one thread per (head, feature)
__global__ void wkv6_du_kernel(const float* part, float* du, int batch, int hdk) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= hdk) return;
  float sum = 0.f, comp = 0.f;
  for (int b = 0; b < batch; ++b) {
    const float x = part[static_cast<int64_t>(b) * hdk + e];
    const float t = __fadd_rn(sum, x);
    comp = __fadd_rn(comp, fabsf(sum) >= fabsf(x) ? __fadd_rn(__fsub_rn(sum, t), x)
                                                  : __fadd_rn(__fsub_rn(x, t), sum));
    sum = t;
  }
  du[e] = __fadd_rn(sum, comp);
}

template <typename T>
const void* bwd_pick_variant(int variant) {
  return variant ? reinterpret_cast<const void*>(wkv6_backward_kernel<T, true>)
                 : reinterpret_cast<const void*>(wkv6_backward_kernel<T, false>);
}

// the backward instantiation for dtype (0 f32, 1 bf16) and variant (0
// scalar, 1 vec16), its dynamic shared memory in *smem, allowed past 48 KB
// and with the carveout at its maximum
const void* bwd_kernel_for(int dtype, int variant, int* smem) {
  const void* fn;
  if (dtype == 0) {
    *smem = sizeof(BwdSmem<float>);
    fn = bwd_pick_variant<float>(variant);
  } else {
    *smem = sizeof(BwdSmem<__nv_bfloat16>);
    fn = bwd_pick_variant<__nv_bfloat16>(variant);
  }
  cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
  return fn;
}

bool bwd_valid_args(int dtype, int variant) {
  return (dtype == 0 || dtype == 1) && (variant == 0 || variant == 1);
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

// strides: 42 int64 -- r, k, v, w, dy, dr, dk, dv, dw as (batch, head,
// time, feature), then u as (head, feature), then ds as (batch, head, row,
// column) (read only when ds is not null); the gradients' feature stride
// must be 1. dtype: 0 = float32, 1 = bfloat16 (r, k, v and dr, dk, dv
// share it; w, u, dy, ds, dw and du are float32). variant: 0 = scalar,
// 1 = vec16 (refused unless r, k, v, w and dy have 16-byte rows). ckpt:
// B*H*ceil(t/kBwdChunk)*4096 floats
// on 16 bytes; du_part: B*H*dk floats; du: H*dk floats (row-major). Runs
// wkv6_backward_kernel, then wkv6_du_kernel; returns cudaGetLastError()
// after them (nonzero when a launch was refused or the arguments are bad).
extern "C" int wkv6_backward_launch(
    const void* r, const void* k, const void* v, const float* w, const float* u,
    const float* dy, const float* ds, void* dr, void* dk, void* dv, float* dw,
    float* du, float* ckpt, float* du_part, const int64_t* strides, int batch,
    int h, int t, int dk_, int dv_, int dtype, int variant, void* stream) {
  if (batch < 1 || h < 1 || t < 1 || dk_ < 1 || dk_ > kMaxDim || dv_ < 1 ||
      dv_ > kMaxDim || !bwd_valid_args(dtype, variant) ||
      static_cast<int64_t>(batch) * h > 2147483647LL ||
      reinterpret_cast<uintptr_t>(ckpt) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdParams p{};
  p.x[0] = r; p.x[1] = k; p.x[2] = v; p.x[3] = w; p.x[4] = dy;
  p.u = u; p.ds = ds;
  p.g[0] = dr; p.g[1] = dk; p.g[2] = dv; p.g[3] = dw;
  p.ckpt = reinterpret_cast<float4*>(ckpt);
  p.du_part = du_part;
  for (int a = 0; a < kBwdInputs + kBwdOutputs; ++a)
    for (int d = 0; d < 4; ++d) p.st[a][d] = strides[4 * a + d];
  p.u_s[0] = strides[36];
  p.u_s[1] = strides[37];
  for (int d = 0; d < 4; ++d) p.ds_s[d] = strides[38 + d];
  for (int a = kBwdInputs; a < kBwdInputs + kBwdOutputs; ++a)
    if (p.st[a][3] != 1) return static_cast<int>(cudaErrorInvalidValue);
  p.h = h; p.t = t; p.dk = dk_; p.dv = dv_;
  p.nc = (t + kBwdChunk - 1) / kBwdChunk;
  if (variant == 1) {
    const int64_t elem = dtype == 0 ? 4 : 2;
    const int width[kBwdInputs] = {dk_, dk_, dv_, dk_, dv_};
    for (int a = 0; a < kBwdInputs; ++a)
      if (!rows16(p.x[a], p.st[a], a < 3 ? elem : 4, width[a], batch, h, t))
        return static_cast<int>(cudaErrorInvalidValue);
  }
  int smem = 0;
  const void* fn = bwd_kernel_for(dtype, variant, &smem);
  void* args[] = {&p};
  cudaLaunchKernel(fn, dim3(batch * h), dim3(kBwdThreads), args, smem,
                   static_cast<cudaStream_t>(stream));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  int hdk = h * dk_;
  void* du_args[] = {&du_part, &du, &batch, &hdk};
  cudaLaunchKernel(reinterpret_cast<const void*>(wkv6_du_kernel),
                   dim3((hdk + 127) / 128), dim3(128), du_args, 0,
                   static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// out[0..3] = blocks of the backward instantiation resident per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor at 128 threads and its
// dynamic shared memory), registers per thread, dynamic shared memory
// bytes per block and local (spill) bytes per thread. Returns the first
// CUDA error, else 0.
extern "C" int wkv6_backward_occupancy(int dtype, int variant, int* out) {
  if (!bwd_valid_args(dtype, variant)) return static_cast<int>(cudaErrorInvalidValue);
  int smem = 0;
  const void* fn = bwd_kernel_for(dtype, variant, &smem);
  cudaFuncAttributes attr{};
  cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], fn, kBwdThreads, smem);
  out[1] = attr.numRegs;
  out[2] = smem;
  out[3] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(e);
}
