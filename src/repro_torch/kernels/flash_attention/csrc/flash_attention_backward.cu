// The gradient of block attention, for Hopper (sm_90a): dQ, dK and dV of
// out = softmax(q k^T * scale + mask) v, two variants of one function.
//
// Replaces no TPU kernel of its own: the reference differentiates its plain
// attention with XLA (src/repro/kernels/flash_attention/ops.py, outside the
// Pallas kernel flash_attention_pallas, kernel.py:80). It is the backward
// of the port's forward (flash_attention.cu) and keeps its semantics:
// queries are the LAST sq positions of the skv timeline (q_offset = skv -
// sq), causal and sliding-window masks on global positions, GQA by index
// (kv head = q head / group). Every probability is recomputed as
// P = exp(s * scale - lse) from the row log-sum-exp the forward saved
// (+inf for a row with no key, whose P, dS and dQ are then 0); nothing of
// size (Sq, Skv) is ever held in device memory.
//
// Three kernels on the caller's stream, FlashAttention-2's backward:
//   1. delta = rowsum(dO * O), float32 (B, Hq, Sq): a warp a row;
//   2. dK and dV: a block a (batch, KV head, tile of keys). It keeps its K
//      and V tile in shared memory and walks every query head of its KV
//      group and every query tile that can reach its keys (the masks skip
//      the rest), recomputing S^T = K Q^T and dP^T = V dO^T, then
//      dS^T = P^T (dP^T - delta), and accumulates dV += P^T dO and
//      dK += dS^T Q * scale in float32 registers. The GQA sum over the
//      group happens inside the block;
//   3. dQ: a block a (batch, query head, tile of queries), walking the KV
//      tiles its rows can see: dQ += dS K * scale.
// Passes 2 and 3 both recompute Q K^T and dO V^T (7 products where 5 are
// the minimum), so that every output element is written by one thread
// from sums in a fixed order: no atomics, and two launches are bitwise
// equal. dq, dk and dv are written through their strides (the wrapper
// allocates them in the layout of q, k and v).
//
// What bounds it on the H100: at seamless's encoder (B*H = 128, S = 4096,
// d = 64, bf16) the five products are 1.37 TFLOP against ~0.1 GB of
// operands, far above the ~295 FLOP/byte where the tensor cores become the
// limit; the bound is the products (about 1.4 ms at 989 TFLOP/s), so the
// products run on the tensor cores and the tiles are staged in shared
// memory once per block and reused across the 64 products of a tile.
//
// tensor_core variant (bf16, d in {64, 128}, rows 16-byte aligned):
// mma.sync m16n8k16 (bf16 in, f32 accumulate), 4 warps. In pass 2 each
// warp owns 16 keys, so S^T, dP^T and its dK/dV rows are its own and no
// sum crosses warps; Q and dO tiles are double-buffered by 16-byte
// cp.async. P^T and dS^T are rounded to bf16 in registers to be the A
// operands of P^T dO and dS^T Q (dO and Q through ldmatrix.trans), as in
// the forward's P V. In pass 3 each warp owns 16 query rows; K and V tiles
// of 64 keys are double-buffered; dS is rounded to bf16 as the A operand
// of dS K (K through ldmatrix.trans). The K, V, Q and dO fragments are
// read from shared memory where they are used, which keeps the
// accumulators (d / 2 floats a thread for each of dK and dV) in registers
// at d = 128; pass 2 takes 32-row query tiles there for the same reason.
//
// cuda_core variant (f32, any other d <= 128, unaligned rows): TPR threads
// own one key row (pass 2) or one query row (pass 3); thread t of the row
// holds its columns c*TPR + t (c < 16), as the forward's cuda_core variant.
// Each score and dP is a partial dot product summed with TPR-lane
// shuffles; tiles of 32 rows are staged in shared memory as f32. Plain f32
// FMA, no TF32, so f32 keeps its f32 tolerance.

#include "tile_mma.cuh"

namespace {

constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* g;        // dO
  const float* lse;     // (B, Hq, Sq) float32
  float* delta;         // (B, Hq, Sq) float32, written by pass 1
  void* dq;
  void* dk;
  void* dv;
  // element strides of the (batch, head, seq) dims; head_dim is contiguous
  int64_t q_sb, q_sh, q_ss;
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss;
  int64_t g_sb, g_sh, g_ss;
  int64_t dq_sb, dq_sh, dq_ss;
  int64_t dk_sb, dk_sh, dk_ss;
  int64_t dv_sb, dv_sh, dv_ss;
  int hq, hkv, sq, skv, d;
  int causal, window;
  float scale;
};

// the query at row q_row (global position q_row + skv - sq) sees key
__device__ __forceinline__ bool visible(const Params& p, int q_row, int key) {
  const int q_pos = q_row + p.skv - p.sq;
  bool ok = q_row < p.sq && key < p.skv;
  if (p.causal) ok = ok && key <= q_pos;
  if (p.window) ok = ok && key > q_pos - p.window;
  return ok;
}

// keys [lo, hi) that some query row of [r0, r1) may see
__device__ __forceinline__ void key_range(const Params& p, int r0, int r1, int& lo,
                                          int& hi) {
  const int off = p.skv - p.sq;
  lo = 0;
  hi = p.skv;
  if (p.causal) hi = min(hi, min(r1, p.sq) - 1 + off + 1);
  if (p.window) lo = max(lo, r0 + off - p.window + 1);
}

// query rows [lo, hi) that may see some key of [k0, k1)
__device__ __forceinline__ void query_range(const Params& p, int k0, int k1, int& lo,
                                            int& hi) {
  const int off = p.skv - p.sq;
  lo = 0;
  hi = p.sq;
  if (p.causal) lo = max(lo, k0 - off);
  if (p.window) hi = min(hi, min(k1, p.skv) - 1 + p.window - off);
}

// exp(s - lse) where the key is visible, else 0; a NaN score counts as
// -1e30, as in the forward
__device__ __forceinline__ float prob(float s, float lse, bool ok) {
  return ok ? expf((isnan(s) ? kNegInf : s) - lse) : 0.f;
}

// ------------------------------------------------------------ pass 1: delta

constexpr int kDeltaThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kDeltaThreads)
attention_delta_kernel(const Params p, int rows) {
  const int row = blockIdx.x * (kDeltaThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;                     // a whole warp returns
  const int bh = row / p.sq;
  const int i = row % p.sq;
  const int b = bh / p.hq;
  const int h = bh % p.hq;
  const T* op = static_cast<const T*>(p.o) + b * p.o_sb + h * p.o_sh
                + static_cast<int64_t>(i) * p.o_ss;
  const T* gp = static_cast<const T*>(p.g) + b * p.g_sb + h * p.g_sh
                + static_cast<int64_t>(i) * p.g_ss;
  float acc = 0.f;
  for (int c = lane; c < p.d; c += 32) acc += to_f32(op[c]) * to_f32(gp[c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.delta[row] = acc;
}

// ------------------------------------------------------ cuda_core variant

constexpr int kThreads = 128;
constexpr int kBlock = 32;            // rows of a staged tile
constexpr int kColsPerThread = 16;    // head_dim <= 16 * TPR

// stage rows r0.. of a (rows, d) operand as f32 into tile[kBlock][kDPad];
// rows past n and columns past d are zeros
template <typename T, int kDPad>
__device__ __forceinline__ void stage_rows(float (*tile)[kDPad], const T* src,
                                           int64_t stride, int r0, int n, int d) {
  for (int i = threadIdx.x; i < kBlock * kDPad; i += kThreads) {
    const int r = i / kDPad;
    const int c = i % kDPad;
    tile[r][c] = (r0 + r < n && c < d) ? to_f32(src[static_cast<int64_t>(r0 + r) * stride + c])
                                       : 0.f;
  }
}

// pass 2, cuda_core: a block holds kThreads / TPR keys
template <typename T, int TPR>
__global__ void __launch_bounds__(kThreads)
attention_dkdv_kernel(const Params p) {
  constexpr int kRows = kThreads / TPR;
  constexpr int kDPad = TPR * kColsPerThread;
  __shared__ float qs[kBlock][kDPad];
  __shared__ float gs[kBlock][kDPad];
  __shared__ float ls[kBlock];
  __shared__ float ds_[kBlock];

  const int bh = blockIdx.x;
  const int b = bh / p.hkv;
  const int hk = bh % p.hkv;
  const int rep = p.hq / p.hkv;
  const int t = threadIdx.x % TPR;
  const int k0 = blockIdx.y * kRows;
  const int key = k0 + threadIdx.x / TPR;
  const bool key_ok = key < p.skv;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh
                + static_cast<int64_t>(key_ok ? key : 0) * p.k_ss;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh
                + static_cast<int64_t>(key_ok ? key : 0) * p.v_ss;

  float kr[kColsPerThread], vr[kColsPerThread];
  float dk[kColsPerThread], dv[kColsPerThread];
#pragma unroll
  for (int c = 0; c < kColsPerThread; ++c) {
    const int col = c * TPR + t;
    kr[c] = (key_ok && col < p.d) ? to_f32(kp[col]) : 0.f;
    vr[c] = (key_ok && col < p.d) ? to_f32(vp[col]) : 0.f;
    dk[c] = 0.f;
    dv[c] = 0.f;
  }

  int q_lo, q_hi;
  query_range(p, k0, min(k0 + kRows, p.skv), q_lo, q_hi);
  const int t_lo = max(q_lo, 0) / kBlock;
  const int t_hi = q_hi > q_lo ? (q_hi + kBlock - 1) / kBlock : t_lo;

  for (int h = hk * rep; h < (hk + 1) * rep; ++h) {
    const int64_t row0 = static_cast<int64_t>(b * p.hq + h) * p.sq;
    const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
    const T* gp = static_cast<const T*>(p.g) + b * p.g_sb + h * p.g_sh;
    for (int tile = t_lo; tile < t_hi; ++tile) {
      const int r0 = tile * kBlock;
      __syncthreads();                    // the previous tile is consumed
      stage_rows<T, kDPad>(qs, qp, p.q_ss, r0, p.sq, p.d);
      stage_rows<T, kDPad>(gs, gp, p.g_ss, r0, p.sq, p.d);
      if (threadIdx.x < kBlock) {
        const bool ok = r0 + threadIdx.x < p.sq;
        ls[threadIdx.x] = ok ? p.lse[row0 + r0 + threadIdx.x] : 0.f;
        ds_[threadIdx.x] = ok ? p.delta[row0 + r0 + threadIdx.x] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < kBlock; ++j) {
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int c = 0; c < kColsPerThread; ++c) {
          s += kr[c] * qs[j][c * TPR + t];
          dp += vr[c] * gs[j][c * TPR + t];
        }
#pragma unroll
        for (int off = TPR / 2; off > 0; off >>= 1) {
          s += __shfl_xor_sync(0xffffffffu, s, off);
          dp += __shfl_xor_sync(0xffffffffu, dp, off);
        }
        const float pv = prob(s * p.scale, ls[j], visible(p, r0 + j, key));
        const float dsv = pv * (dp - ds_[j]);
#pragma unroll
        for (int c = 0; c < kColsPerThread; ++c) {
          dv[c] += pv * gs[j][c * TPR + t];
          dk[c] += dsv * qs[j][c * TPR + t];
        }
      }
    }
  }

  if (key_ok) {
    T* dkp = static_cast<T*>(p.dk) + b * p.dk_sb + hk * p.dk_sh
             + static_cast<int64_t>(key) * p.dk_ss;
    T* dvp = static_cast<T*>(p.dv) + b * p.dv_sb + hk * p.dv_sh
             + static_cast<int64_t>(key) * p.dv_ss;
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) {
      const int col = c * TPR + t;
      if (col < p.d) {
        dkp[col] = from_f32<T>(dk[c] * p.scale);
        dvp[col] = from_f32<T>(dv[c]);
      }
    }
  }
}

// pass 3, cuda_core: a block holds kThreads / TPR query rows
template <typename T, int TPR>
__global__ void __launch_bounds__(kThreads)
attention_dq_kernel(const Params p) {
  constexpr int kRows = kThreads / TPR;
  constexpr int kDPad = TPR * kColsPerThread;
  __shared__ float ks[kBlock][kDPad];
  __shared__ float vs[kBlock][kDPad];

  const int bh = blockIdx.x;
  const int b = bh / p.hq;
  const int h = bh % p.hq;
  const int hk = h / (p.hq / p.hkv);
  const int t = threadIdx.x % TPR;
  const int r0 = blockIdx.y * kRows;
  const int row = r0 + threadIdx.x / TPR;
  const bool row_ok = row < p.sq;
  const int64_t lrow = static_cast<int64_t>(bh) * p.sq + (row_ok ? row : 0);
  const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh
                + static_cast<int64_t>(row_ok ? row : 0) * p.q_ss;
  const T* gp = static_cast<const T*>(p.g) + b * p.g_sb + h * p.g_sh
                + static_cast<int64_t>(row_ok ? row : 0) * p.g_ss;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  float qr[kColsPerThread], gr[kColsPerThread], dq[kColsPerThread];
#pragma unroll
  for (int c = 0; c < kColsPerThread; ++c) {
    const int col = c * TPR + t;
    qr[c] = (row_ok && col < p.d) ? to_f32(qp[col]) : 0.f;
    gr[c] = (row_ok && col < p.d) ? to_f32(gp[col]) : 0.f;
    dq[c] = 0.f;
  }
  const float lse = row_ok ? p.lse[lrow] : 0.f;
  const float delta = row_ok ? p.delta[lrow] : 0.f;

  int k_lo, k_hi;
  key_range(p, r0, r0 + kRows, k_lo, k_hi);
  const int t_lo = k_lo / kBlock;
  const int t_hi = k_hi > k_lo ? (k_hi + kBlock - 1) / kBlock : t_lo;

  for (int tile = t_lo; tile < t_hi; ++tile) {
    const int k0 = tile * kBlock;
    __syncthreads();
    stage_rows<T, kDPad>(ks, kp, p.k_ss, k0, p.skv, p.d);
    stage_rows<T, kDPad>(vs, vp, p.v_ss, k0, p.skv, p.d);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kBlock; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) {
        s += qr[c] * ks[j][c * TPR + t];
        dp += gr[c] * vs[j][c * TPR + t];
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, off);
        dp += __shfl_xor_sync(0xffffffffu, dp, off);
      }
      const float pv = prob(s * p.scale, lse, visible(p, row, k0 + j));
      const float dsv = pv * (dp - delta);
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) dq[c] += dsv * ks[j][c * TPR + t];
    }
  }

  if (row_ok) {
    T* dqp = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh
             + static_cast<int64_t>(row) * p.dq_ss;
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) {
      const int col = c * TPR + t;
      if (col < p.d) dqp[col] = from_f32<T>(dq[c] * p.scale);
    }
  }
}

template <typename T, int TPR>
void launch_cc(const Params& p, int batch, cudaStream_t stream) {
  constexpr int kRows = kThreads / TPR;
  attention_dkdv_kernel<T, TPR>
      <<<dim3(batch * p.hkv, (p.skv + kRows - 1) / kRows), kThreads, 0, stream>>>(p);
  attention_dq_kernel<T, TPR>
      <<<dim3(batch * p.hq, (p.sq + kRows - 1) / kRows), kThreads, 0, stream>>>(p);
}

template <typename T>
void launch_cc_for_dim(const Params& p, int batch, cudaStream_t stream) {
  if (p.d <= 16) launch_cc<T, 1>(p, batch, stream);
  else if (p.d <= 32) launch_cc<T, 2>(p, batch, stream);
  else if (p.d <= 64) launch_cc<T, 4>(p, batch, stream);
  else launch_cc<T, 8>(p, batch, stream);
}

// ------------------------------------------------------ tensor_core variant

constexpr int kTcThreads = 128;       // 4 warps
constexpr int kTcKeys = 64;           // keys of a pass-2 block; of a pass-3 K/V tile
constexpr int kTcRows = 64;           // query rows of a pass-3 block

// pass 2's query tile: 64 rows at d = 64, 32 at d = 128 (its S^T and dP^T
// fragments beside the d-wide dK and dV accumulators)
template <int D>
__host__ __device__ constexpr int dkdv_rows() { return D == 128 ? 32 : 64; }

// byte offset of 16-byte word c of row r in a tile of rows of D bf16:
// words swizzled by r % 8, so the 8 rows of one ldmatrix phase hit 8
// distinct bank groups (the forward's layout)
template <int D>
__device__ __forceinline__ int tile_off(int r, int c) {
  return r * (D * 2) + ((c ^ (r & 7)) << 4);
}

// rows row0.. (rows of them) of a (n, D) bf16 operand into a tile by
// 16-byte cp.async; rows past n are zeros
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* src,
                                          int64_t stride, int row0, int n, int rows) {
  constexpr int kWords = D / 8;
  for (int i = threadIdx.x; i < rows * kWords; i += kTcThreads) {
    const int r = i / kWords, c = i % kWords;
    const bool ok = row0 + r < n;
    cp_async16(dst + tile_off<D>(r, c),
               ok ? src + static_cast<int64_t>(row0 + r) * stride + c * 8 : src, ok);
  }
}

// n floats from src (row0..) into shared memory by 4-byte cp.async; past
// n zeros
__device__ __forceinline__ void load_floats(uint32_t dst, const float* src, int row0,
                                            int n, int rows) {
  for (int i = threadIdx.x; i < rows; i += kTcThreads) {
    const bool ok = row0 + i < n;
    cp_async4(dst + 4 * i, ok ? src + row0 + i : src, ok);
  }
}

// acc (16 x N per warp, C fragments) += A B over K = 16 * KT: A the
// (16, 16 KT) operand at rows a_row0.. of tile a (ldmatrix), B the (N, 16
// KT) operand at rows b_row0.. of tile b (ldmatrix, non-transposed): the
// "S = Q K^T" pattern of the forward
template <int DA, int NT>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], uint32_t a, int a_row0,
                                        uint32_t bt, int b_row0, int lane) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[nt][j] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DA / 16; ++kk) {
    uint32_t af[4];
    const int r = a_row0 + (lane % 8) + ((lane / 8) % 2) * 8;
    ldmatrix_x4(af, a + tile_off<DA>(r, kk * 2 + lane / 16));
#pragma unroll
    for (int nj = 0; nj < NT / 2; ++nj) {
      uint32_t bf[4];
      const int n = b_row0 + nj * 16 + (lane / 16) * 8 + lane % 8;
      ldmatrix_x4(bf, bt + tile_off<DA>(n, kk * 2 + (lane / 8) % 2));
      mma_bf16(acc[2 * nj], af, bf[0], bf[1]);
      mma_bf16(acc[2 * nj + 1], af, bf[2], bf[3]);
    }
  }
}

// out (16 x D per warp) += P B: P the (16, 16 KT) f32 C fragments, rounded
// to bf16 A fragments in registers; B the (16 KT, D) operand at rows
// b_row0.. of tile b, through ldmatrix.trans: the "O += P V" pattern
template <int D, int KT>
__device__ __forceinline__ void mma_pb(float (&out)[D / 8][4], const float (&pf)[2 * KT][4],
                                       uint32_t bt, int b_row0, int lane) {
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    const uint32_t a[4] = {pack_bf16(pf[2 * kk][0], pf[2 * kk][1]),
                           pack_bf16(pf[2 * kk][2], pf[2 * kk][3]),
                           pack_bf16(pf[2 * kk + 1][0], pf[2 * kk + 1][1]),
                           pack_bf16(pf[2 * kk + 1][2], pf[2 * kk + 1][3])};
#pragma unroll
    for (int nj = 0; nj < D / 16; ++nj) {
      uint32_t bf[4];
      const int r = b_row0 + kk * 16 + ((lane / 8) % 2) * 8 + lane % 8;
      ldmatrix_x4_trans(bf, bt + tile_off<D>(r, nj * 2 + lane / 16));
      mma_bf16(out[2 * nj], a, bf[0], bf[1]);
      mma_bf16(out[2 * nj + 1], a, bf[2], bf[3]);
    }
  }
}

// rows (16 per warp) of a (16, D) f32 C-fragment tile times ``mul`` into
// bf16 rows at dst + row * stride, through 4-byte stores
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4], __nv_bfloat16* base,
                                           int64_t stride, int row0, int n, float mul,
                                           int lane) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = row0 + lane / 4 + hf * 8;
    if (row >= n) continue;
    __nv_bfloat16* dst = base + static_cast<int64_t>(row) * stride + (lane % 4) * 2;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      *reinterpret_cast<uint32_t*>(dst + nt * 8) =
          pack_bf16(acc[nt][2 * hf] * mul, acc[nt][2 * hf + 1] * mul);
  }
}

template <int D>
constexpr size_t dkdv_smem_bytes() {  // K, V; Q and dO twice; lse and delta twice
  return static_cast<size_t>(2 * kTcKeys + 4 * dkdv_rows<D>()) * D * 2
         + 4 * dkdv_rows<D>() * 4;
}

// pass 2, tensor_core: a block holds kTcKeys keys, warp w keys 16w..16w+15
template <int D>
__global__ void __launch_bounds__(kTcThreads)
attention_dkdv_tc_kernel(const Params p) {
  using bf16 = __nv_bfloat16;
  constexpr int kRowsQ = dkdv_rows<D>();
  constexpr int NQ = kRowsQ / 8;                 // n8 tiles of a warp's S^T
  constexpr int kQTile = kRowsQ * D * 2;         // bytes of a Q or dO tile
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t ks = smem_addr(smem);            // [kTcKeys][D]
  const uint32_t vs = ks + kTcKeys * D * 2;       // [kTcKeys][D]
  const uint32_t qs = vs + kTcKeys * D * 2;       // [2][kRowsQ][D]
  const uint32_t gs = qs + 2 * kQTile;            // [2][kRowsQ][D]
  const uint32_t lss = gs + 2 * kQTile;           // [2][kRowsQ] f32
  const uint32_t dls = lss + 2 * kRowsQ * 4;      // [2][kRowsQ] f32
  const float* lse_s = reinterpret_cast<const float*>(smem + (lss - ks));
  const float* dl_s = reinterpret_cast<const float*>(smem + (dls - ks));

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.x / p.hkv;
  const int hk = blockIdx.x % p.hkv;
  const int rep = p.hq / p.hkv;
  const int k0 = blockIdx.y * kTcKeys;
  const bf16* kp = static_cast<const bf16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const bf16* vp = static_cast<const bf16*>(p.v) + b * p.v_sb + hk * p.v_sh;

  int q_lo, q_hi;
  query_range(p, k0, min(k0 + kTcKeys, p.skv), q_lo, q_hi);
  const int t_lo = max(q_lo, 0) / kRowsQ;
  const int n_tiles = q_hi > q_lo ? (q_hi + kRowsQ - 1) / kRowsQ - t_lo : 0;
  const int steps = n_tiles * rep;                // (query head, tile) pairs

  // the step's Q, dO, lse and delta into buffer buf
  auto load_step = [&](int step, int buf) {
    const int h = hk * rep + step / n_tiles;
    const int r0 = (t_lo + step % n_tiles) * kRowsQ;
    const int64_t row0 = static_cast<int64_t>(b * p.hq + h) * p.sq;
    load_tile<D>(qs + buf * kQTile, static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh,
                 p.q_ss, r0, p.sq, kRowsQ);
    load_tile<D>(gs + buf * kQTile, static_cast<const bf16*>(p.g) + b * p.g_sb + h * p.g_sh,
                 p.g_ss, r0, p.sq, kRowsQ);
    load_floats(lss + buf * kRowsQ * 4, p.lse + row0, r0, p.sq, kRowsQ);
    load_floats(dls + buf * kRowsQ * 4, p.delta + row0, r0, p.sq, kRowsQ);
  };

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk[nt][j] = dv[nt][j] = 0.f;

  if (steps > 0) {
    load_tile<D>(ks, kp, p.k_ss, k0, p.skv, kTcKeys);
    load_tile<D>(vs, vp, p.v_ss, k0, p.skv, kTcKeys);
    load_step(0, 0);
  }
  cp_async_commit();
  const int kw = k0 + warp * 16;                  // this warp's first key

  for (int step = 0; step < steps; ++step) {
    const int buf = step & 1;
    cp_async_wait<0>();          // this step's tiles landed (this thread's)
    __syncthreads();             // ... every thread's; step - 1 is consumed
    if (step + 1 < steps) load_step(step + 1, buf ^ 1);
    cp_async_commit();
    const int r0 = (t_lo + step % n_tiles) * kRowsQ;
    const uint32_t qb = qs + buf * kQTile;
    const uint32_t gb = gs + buf * kQTile;

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x kRowsQ queries per warp
    float s[NQ][4], dp[NQ][4];
    mma_abt<D, NQ>(s, ks, warp * 16, qb, 0, lane);
    mma_abt<D, NQ>(dp, vs, warp * 16, gb, 0, lane);
    // P^T = exp(S^T * scale - lse), dS^T = P^T (dP^T - delta)
#pragma unroll
    for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = kw + lane / 4 + (j / 2) * 8;
        const int qc = nt * 8 + (lane % 4) * 2 + (j & 1);
        const float pv = prob(s[nt][j] * p.scale, lse_s[buf * kRowsQ + qc],
                              visible(p, r0 + qc, key));
        s[nt][j] = pv;
        dp[nt][j] = pv * (dp[nt][j] - dl_s[buf * kRowsQ + qc]);
      }
    // dV += P^T dO, dK += dS^T Q
    mma_pb<D, kRowsQ / 16>(dv, s, gb, 0, lane);
    mma_pb<D, kRowsQ / 16>(dk, dp, qb, 0, lane);
  }
  cp_async_wait<0>();

  store_rows<D>(dk, static_cast<bf16*>(p.dk) + b * p.dk_sb + hk * p.dk_sh, p.dk_ss, kw,
                p.skv, p.scale, lane);
  store_rows<D>(dv, static_cast<bf16*>(p.dv) + b * p.dv_sb + hk * p.dv_sh, p.dv_ss, kw,
                p.skv, 1.f, lane);
}

template <int D>
constexpr size_t dq_smem_bytes() {    // Q, dO; K and V twice each
  return static_cast<size_t>(2 * kTcRows + 4 * kTcKeys) * D * 2;
}

// pass 3, tensor_core: a block holds kTcRows query rows, warp w rows
// 16w..16w+15
template <int D>
__global__ void __launch_bounds__(kTcThreads)
attention_dq_tc_kernel(const Params p) {
  using bf16 = __nv_bfloat16;
  constexpr int NK = kTcKeys / 8;
  constexpr int kTile = kTcKeys * D * 2;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t qs = smem_addr(smem);            // [kTcRows][D]
  const uint32_t gs = qs + kTcRows * D * 2;       // [kTcRows][D]
  const uint32_t ks = gs + kTcRows * D * 2;       // [2][kTcKeys][D]
  const uint32_t vs = ks + 2 * kTile;             // [2][kTcKeys][D]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int bh = blockIdx.x;
  const int b = bh / p.hq;
  const int h = bh % p.hq;
  const int hk = h / (p.hq / p.hkv);
  const int r0 = blockIdx.y * kTcRows;
  const int rw = r0 + warp * 16;                  // this warp's first row
  const bf16* kp = static_cast<const bf16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const bf16* vp = static_cast<const bf16*>(p.v) + b * p.v_sb + hk * p.v_sh;

  // lse and delta of this thread's two rows
  float lse[2], delta[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = rw + lane / 4 + hf * 8;
    const int64_t i = static_cast<int64_t>(bh) * p.sq + (row < p.sq ? row : 0);
    lse[hf] = row < p.sq ? p.lse[i] : 0.f;
    delta[hf] = row < p.sq ? p.delta[i] : 0.f;
  }

  int k_lo, k_hi;
  key_range(p, r0, r0 + kTcRows, k_lo, k_hi);
  const int t_lo = k_lo / kTcKeys;
  const int t_hi = k_hi > k_lo ? (k_hi + kTcKeys - 1) / kTcKeys : t_lo;

  float dq[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) dq[nt][j] = 0.f;

  if (t_lo < t_hi) {
    load_tile<D>(qs, static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh, p.q_ss, r0,
                 p.sq, kTcRows);
    load_tile<D>(gs, static_cast<const bf16*>(p.g) + b * p.g_sb + h * p.g_sh, p.g_ss, r0,
                 p.sq, kTcRows);
    load_tile<D>(ks, kp, p.k_ss, t_lo * kTcKeys, p.skv, kTcKeys);
    load_tile<D>(vs, vp, p.v_ss, t_lo * kTcKeys, p.skv, kTcKeys);
  }
  cp_async_commit();

  for (int t = t_lo; t < t_hi; ++t) {
    const int buf = (t - t_lo) & 1;
    const uint32_t kb = ks + buf * kTile;
    const uint32_t vb = vs + buf * kTile;
    cp_async_wait<0>();
    __syncthreads();
    if (t + 1 < t_hi) {
      load_tile<D>(ks + (buf ^ 1) * kTile, kp, p.k_ss, (t + 1) * kTcKeys, p.skv, kTcKeys);
      load_tile<D>(vs + (buf ^ 1) * kTile, vp, p.v_ss, (t + 1) * kTcKeys, p.skv, kTcKeys);
    }
    cp_async_commit();
    const int k0 = t * kTcKeys;

    // S = Q K^T and dP = dO V^T: 16 rows x kTcKeys keys per warp
    float s[NK][4], dp[NK][4];
    mma_abt<D, NK>(s, qs, warp * 16, kb, 0, lane);
    mma_abt<D, NK>(dp, gs, warp * 16, vb, 0, lane);
#pragma unroll
    for (int nt = 0; nt < NK; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = rw + lane / 4 + (j / 2) * 8;
        const int key = k0 + nt * 8 + (lane % 4) * 2 + (j & 1);
        const float pv = prob(s[nt][j] * p.scale, lse[j / 2], visible(p, row, key));
        dp[nt][j] = pv * (dp[nt][j] - delta[j / 2]);
      }
    // dQ += dS K
    mma_pb<D, kTcKeys / 16>(dq, dp, kb, 0, lane);
  }
  cp_async_wait<0>();

  store_rows<D>(dq, static_cast<bf16*>(p.dq) + b * p.dq_sb + h * p.dq_sh, p.dq_ss, rw,
                p.sq, p.scale, lane);
}

template <typename K>
int allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

template <int D>
int launch_tc(const Params& p, int batch, cudaStream_t stream) {
  constexpr size_t s2 = dkdv_smem_bytes<D>();
  constexpr size_t s3 = dq_smem_bytes<D>();
  int e = allow_smem(attention_dkdv_tc_kernel<D>, s2);
  if (e == 0) e = allow_smem(attention_dq_tc_kernel<D>, s3);
  if (e != 0) return e;
  attention_dkdv_tc_kernel<D>
      <<<dim3(batch * p.hkv, (p.skv + kTcKeys - 1) / kTcKeys), kTcThreads, s2, stream>>>(p);
  attention_dq_tc_kernel<D>
      <<<dim3(batch * p.hq, (p.sq + kTcRows - 1) / kTcRows), kTcThreads, s3, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* x) { return reinterpret_cast<uintptr_t>(x) % 16 == 0; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, dO and the gradients).
// variant: 0 = cuda_core, 1 = tensor_core (bf16, d 64 or 128, 16-byte
// aligned rows: the wrapper checks the strides). strides: 24 element
// strides, the (batch, head, seq) ones of q, k, v, o, dO, dq, dk, dv in
// that order (head_dim contiguous in each). lse: the forward's float32
// (B, Hq, Sq), contiguous; delta: float32 (B, Hq, Sq) scratch. Launches
// the three passes on ``stream`` and returns cudaGetLastError() after
// them (nonzero when a launch was refused or the arguments are bad).
extern "C" int flash_attention_backward_launch(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const float* lse, float* delta, void* dq, void* dk, void* dv, const int64_t* strides,
    int batch, int hq, int hkv, int sq, int skv, int d,
    int causal, int window, float scale, int dtype, int variant, void* stream) {
  if (d < 1 || d > 128 || hkv < 1 || hq % hkv != 0 || sq < 1 || skv < 1 ||
      batch < 1 || (dtype != 0 && dtype != 1) || (variant != 0 && variant != 1) ||
      strides == nullptr || lse == nullptr || delta == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t* s = strides;
  Params p{q, k, v, o, dout, lse, delta, dq, dk, dv,
           s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11],
           s[12], s[13], s[14], s[15], s[16], s[17], s[18], s[19], s[20], s[21], s[22],
           s[23],
           hq, hkv, sq, skv, d, causal, window, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
    if (dtype != 1 || !(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o) &&
                        aligned16(dout) && aligned16(dq) && aligned16(dk) && aligned16(dv)))
      return static_cast<int>(cudaErrorInvalidValue);
    if (d != 64 && d != 128) return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rows = batch * hq * sq;
  const int blocks = (rows + kDeltaThreads / 32 - 1) / (kDeltaThreads / 32);
  if (dtype == 0) attention_delta_kernel<float><<<blocks, kDeltaThreads, 0, st>>>(p, rows);
  else attention_delta_kernel<__nv_bfloat16><<<blocks, kDeltaThreads, 0, st>>>(p, rows);
  int e = static_cast<int>(cudaGetLastError());
  if (e != 0) return e;
  if (variant == 1) return d == 64 ? launch_tc<64>(p, batch, st) : launch_tc<128>(p, batch, st);
  if (dtype == 0) launch_cc_for_dim<float>(p, batch, st);
  else launch_cc_for_dim<__nv_bfloat16>(p, batch, st);
  return static_cast<int>(cudaGetLastError());
}
