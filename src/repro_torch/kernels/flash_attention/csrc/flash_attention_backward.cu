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
// Three kernels on the caller's stream (four where the wgmma tile splits
// dQ over keys), FlashAttention-2's backward:
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
// tensor_core variant (bf16, d in {64, 128}, rows 16-byte aligned), two
// tiles picked by the wrapper from the shapes (kernel.py,
// attention_backward_tile).
//
// wgmma tile (the long sequences): each pass on two warpgroups. Pass 2: a
// block of 128 keys keeps K and V in wgmma's 128-byte-swizzled layout;
// query tiles of Q, dO (and lse, delta) come through a 4-stage ring of
// 16-byte cp.async copies, two tiles ahead, fenced for the async proxy
// (the exit kernel's staging: every thread copies, no producer warp, so
// no mbarrier protocol; the ring hides the loads because a step's four
// products far outlast them). S^T = K Q^T and dP^T = V dO^T are wgmma
// with both operands read by descriptor; P^T and dS^T are rounded to
// bf16 in registers and are the register A of dV += P^T dO and
// dK += dS^T Q (dO, Q as MN-major B). So each Q and dO tile is read once
// a warpgroup by the tensor cores, where the mma_sync tile reads it once
// a warp by ldmatrix, which bounded that tile by shared-memory bandwidth.
// Pass 3: a block of 128 query rows, K/V tiles of 64 keys through the
// ring, dQ += dS K from registers; where its grid underfills the card it
// splits over keys into float32 partials (a workspace the wrapper
// allocates), summed in split order by attention_dq_sum_kernel, so dQ
// stays deterministic without atomics.
//
// mma_sync tile (the short sequences, where its smaller blocks fill the
// card): mma.sync m16n8k16 (bf16 in, f32 accumulate), 4 warps. In pass 2 each
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

// ------------------------------------------- tensor_core variant, wgmma tile

constexpr int kWgThreads = 256;       // two warpgroups
constexpr int kWgKeys = 128;          // keys of a dK/dV block, 64 a warpgroup
constexpr int kWgRows = 128;          // query rows of a dQ block, 64 a warpgroup
constexpr int kWgKv = 64;             // keys of a dQ step's K and V tiles
constexpr int kWgStages = 4;          // the cp.async ring's depth
constexpr int kWgAhead = 2;           // tiles loaded ahead of the one in use
constexpr float kLog2e = 1.4426950408889634f;

// byte offset of 16-byte word c of row r of a tile of ROWS rows of bf16 in
// wgmma's 128-byte-swizzled layout: atoms of 64 columns, each ROWS lines
// of 128 bytes whose words are XORed by r % 8, one after another along
// the row (a d = 64 row is one line). The same bytes are a K-major operand
// (rows the M or N index, columns K) and an MN-major one (rows K, columns
// N).
template <int ROWS>
__device__ __forceinline__ int sw_off(int r, int c) {
  return (c >> 3) * (ROWS * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// descriptor of k-step kk (16 columns) of rows r0 .. of a ROWS-row tile as
// a K-major operand; of k-step kk (16 rows) of the tile as an MN-major B
// (its 64-column atoms ROWS * 128 bytes apart)
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int rows, int r0, int kk) {
  return wgmma_desc_sw128(tile + (kk >> 2) * rows * 128 + r0 * 128 + (kk & 3) * 32, 16, 1024);
}
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int rows, int kk) {
  return wgmma_desc_sw128(tile + kk * 16 * 128, rows * 128, 1024);
}

// rows row0 .. (ROWS of them) of a (n, D) bf16 operand into a swizzled
// tile by 16-byte cp.async, every thread of the block; rows past n zeros
template <int D, int ROWS>
__device__ __forceinline__ void load_sw(uint32_t dst, const __nv_bfloat16* src,
                                        int64_t stride, int row0, int n) {
  constexpr int kWords = D / 8;
  static_assert(ROWS * kWords % kWgThreads == 0, "whole words a thread");
#pragma unroll
  for (int j = 0; j < ROWS * kWords / kWgThreads; ++j) {
    const int i = threadIdx.x + j * kWgThreads;
    const int r = i / kWords, c = i % kWords;
    const bool ok = row0 + r < n;
    cp_async16(dst + sw_off<ROWS>(r, c),
               ok ? src + static_cast<int64_t>(row0 + r) * stride + c * 8 : src, ok);
  }
}

// does some (query row, key) pair of [r0, r1) x [k0, k1) fall outside the
// causal or window mask (bounds aside: rows past sq and keys past skv are
// zeros in their tiles and add nothing to another row's gradient)?
__device__ __forceinline__ bool tile_masked(const Params& p, int r0, int r1, int k0, int k1) {
  const int off = p.skv - p.sq;
  return (p.causal && k1 - 1 > r0 + off) || (p.window && k0 <= r1 - 1 + off - p.window);
}

// P = exp(s * scale - lse) where the key is visible, as 2^x by the SFU's
// ex2.approx (relative error ~2^-22, far under the bf16 rounding of P
// that follows); fmaxf takes a NaN score as -1e30, as prob() does;
// sl2 = scale * log2(e), ll2 = lse * log2(e)
__device__ __forceinline__ float prob2(float s, float sl2, float ll2) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(fmaxf(s, kNegInf) * sl2 - ll2));
  return y;
}

// rows row0 + lane / 4 (+ 8) of warp-row fragments acc (64 x N a
// warpgroup, d[4 j + q] as in wgmma_ss) times ``mul`` into bf16 rows at
// base + row * stride, through 4-byte stores; rows past n are skipped
template <int N>
__device__ __forceinline__ void store_wg(const float (&acc)[N / 2], __nv_bfloat16* base,
                                         int64_t stride, int row0, int n, float mul, int lane) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = row0 + lane / 4 + hf * 8;
    if (row >= n) continue;
    __nv_bfloat16* dst = base + static_cast<int64_t>(row) * stride + (lane % 4) * 2;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + j * 8) =
          pack_bf16(acc[4 * j + 2 * hf] * mul, acc[4 * j + 2 * hf + 1] * mul);
  }
}

// the k-steps of an m64nNk16 product whose A is the (64 x 16 KT) f32
// accumulator ``f`` of an earlier one, rounded to bf16 A fragments
template <int KT>
__device__ __forceinline__ void pack_a(uint32_t (&a)[KT][4], const float (&f)[KT * 8]) {
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    a[kk][0] = pack_bf16(f[8 * kk + 0], f[8 * kk + 1]);
    a[kk][1] = pack_bf16(f[8 * kk + 2], f[8 * kk + 3]);
    a[kk][2] = pack_bf16(f[8 * kk + 4], f[8 * kk + 5]);
    a[kk][3] = pack_bf16(f[8 * kk + 6], f[8 * kk + 7]);
  }
}

template <int N>
__device__ __forceinline__ void fence_all(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_operand(r[i]);
}
// keep register A fragments of a wgmma still in flight where they are
// until the wait that retires it (the compiler sees its last use at issue)
template <int KT>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[KT][4]) {
#pragma unroll
  for (int kk = 0; kk < KT; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[kk][i]));
}

template <int D, int BR>
constexpr size_t dkdv_wg_smem_bytes() {  // K, V; the ring's Q, dO, lse, delta; alignment
  return 1024 + static_cast<size_t>(2 * kWgKeys + 2 * kWgStages * BR) * D * 2
         + 2 * kWgStages * BR * 4;
}

// pass 2, wgmma: a block (blockIdx.x: its keys, .y: batch and KV head,
// so that the blocks of one head run together and share its Q and dO in
// L2) holds kWgKeys keys, warpgroup g keys 64 g ..;
// query tiles of BR rows (and their lse and delta) through the ring,
// kWgAhead tiles ahead. S^T and dP^T read both operands by descriptor; P^T
// and dS^T stay in registers as the A of dV and dK. At d = 64 and BR = 32
// (the cross-attention's one short step a block) two blocks share an SM,
// so one block's loads overlap another's products (128 registers, a
// 16-byte spill); at d = 128 the accumulators need one block an SM.
template <int D, int BR>
__global__ void __launch_bounds__(kWgThreads, D == 64 && BR == 32 ? 2 : 1)
attention_dkdv_wgmma_kernel(const Params p) {
  using bf16 = __nv_bfloat16;
  constexpr int kQTile = BR * D * 2;             // bytes of a Q or dO tile
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t ks = (smem_addr(smem_raw) + 1023u) & ~1023u;   // atoms on 1024 bytes
  const uint32_t vs = ks + kWgKeys * D * 2;       // [kWgKeys][D]
  const uint32_t qs = vs + kWgKeys * D * 2;       // [kWgStages][BR][D]
  const uint32_t gs = qs + kWgStages * kQTile;    // [kWgStages][BR][D]
  const uint32_t lss = gs + kWgStages * kQTile;   // [kWgStages][BR] f32
  const uint32_t dls = lss + kWgStages * BR * 4;  // [kWgStages][BR] f32
  const unsigned char* sbase = smem_raw + (ks - smem_addr(smem_raw));
  const float* lse_s = reinterpret_cast<const float*>(sbase + (lss - ks));
  const float* dl_s = reinterpret_cast<const float*>(sbase + (dls - ks));

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.y / p.hkv;
  const int hk = blockIdx.y % p.hkv;
  const int rep = p.hq / p.hkv;
  const int k0 = blockIdx.x * kWgKeys;
  const int k1 = min(k0 + kWgKeys, p.skv);
  const bf16* kp = static_cast<const bf16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const bf16* vp = static_cast<const bf16*>(p.v) + b * p.v_sb + hk * p.v_sh;

  int q_lo, q_hi;
  query_range(p, k0, k1, q_lo, q_hi);
  const int t_lo = max(q_lo, 0) / BR;
  const int n_tiles = q_hi > q_lo ? (q_hi + BR - 1) / BR - t_lo : 0;
  const int steps = n_tiles * rep;                // (query head, tile) pairs

  auto load_step = [&](int step) {
    const int buf = step % kWgStages;
    const int h = hk * rep + step / n_tiles;
    const int r0 = (t_lo + step % n_tiles) * BR;
    const int64_t row0 = static_cast<int64_t>(b * p.hq + h) * p.sq;
    load_sw<D, BR>(qs + buf * kQTile, static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh,
                   p.q_ss, r0, p.sq);
    load_sw<D, BR>(gs + buf * kQTile, static_cast<const bf16*>(p.g) + b * p.g_sb + h * p.g_sh,
                   p.g_ss, r0, p.sq);
    if (threadIdx.x < BR) {
      const bool ok = r0 + threadIdx.x < p.sq;
      cp_async4(lss + (buf * BR + threadIdx.x) * 4, ok ? p.lse + row0 + r0 + threadIdx.x : p.lse,
                ok);
    } else if (threadIdx.x < 2 * BR) {
      const int i = threadIdx.x - BR;
      const bool ok = r0 + i < p.sq;
      cp_async4(dls + (buf * BR + i) * 4, ok ? p.delta + row0 + r0 + i : p.delta, ok);
    }
  };

  float dk[D / 2], dv[D / 2], s[BR / 2], dp[BR / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BR / 2; ++i) s[i] = dp[i] = 0.f;

  if (steps > 0) {
    load_sw<D, kWgKeys>(ks, kp, p.k_ss, k0, p.skv);
    load_sw<D, kWgKeys>(vs, vp, p.v_ss, k0, p.skv);
  }
#pragma unroll
  for (int st = 0; st < kWgAhead; ++st) {
    if (st < steps) load_step(st);
    cp_async_commit();
  }
  const int kw = k0 + wg * 64 + warp * 16;        // this warp's first key
  const float sl2 = p.scale * kLog2e;

  for (int step = 0; step < steps; ++step) {
    const int buf = step % kWgStages;
    cp_async_wait<kWgAhead - 1>();    // this step's tiles landed (this thread's)
    fence_proxy_async_smem();         // ... visible to wgmma
    __syncthreads();                  // ... every thread's; step - 2's stage is free
    if (step + kWgAhead < steps) load_step(step + kWgAhead);
    cp_async_commit();
    const int r0 = (t_lo + step % n_tiles) * BR;
    const uint32_t qb = qs + buf * kQTile;
    const uint32_t gb = gs + buf * kQTile;
    const float* lse_b = lse_s + buf * BR;
    const float* dl_b = dl_s + buf * BR;

    // S^T = K Q^T and dP^T = V dO^T: 64 keys x BR queries a warpgroup
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BR>(s, kmajor_desc(ks, kWgKeys, wg * 64, kk), kmajor_desc(qb, BR, 0, kk), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BR>(dp, kmajor_desc(vs, kWgKeys, wg * 64, kk), kmajor_desc(gb, BR, 0, kk), kk);
    wgmma_commit();

    // P^T = exp(S^T * scale - lse), while dP^T runs; the masks only on the
    // tiles that cross them (a branch: the compiler would otherwise
    // evaluate them, predicated, on every tile)
    wgmma_wait<1>();                  // S^T
    fence_all(s);
#pragma unroll
    for (int j = 0; j < BR / 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        s[4 * j + q] = prob2(s[4 * j + q], sl2,
                             lse_b[j * 8 + (lane % 4) * 2 + (q & 1)] * kLog2e);
    if (tile_masked(p, r0, r0 + BR, kw, kw + 16)) {
#pragma unroll
      for (int j = 0; j < BR / 8; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (!visible(p, r0 + j * 8 + (lane % 4) * 2 + (q & 1), kw + lane / 4 + (q / 2) * 8))
            s[4 * j + q] = 0.f;
    }
    uint32_t pa[BR / 16][4];
    pack_a<BR / 16>(pa, s);
    // dV += P^T dO
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BR / 16; ++kk) wgmma_rs<D>(dv, pa[kk], mnmajor_desc(gb, BR, kk), 1);
    wgmma_commit();

    // dS^T = P^T (dP^T - delta), while dV runs; then dK += dS^T Q
    wgmma_wait<1>();
    fence_all(dp);
#pragma unroll
    for (int j = 0; j < BR / 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        dp[4 * j + q] = s[4 * j + q] * (dp[4 * j + q] - dl_b[j * 8 + (lane % 4) * 2 + (q & 1)]);
    uint32_t da[BR / 16][4];
    pack_a<BR / 16>(da, dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BR / 16; ++kk) wgmma_rs<D>(dk, da[kk], mnmajor_desc(qb, BR, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();                  // this stage, pa and da are free again
    fence_frags(pa);
    fence_frags(da);
  }
  cp_async_wait<0>();
  fence_all(dk);
  fence_all(dv);

  store_wg<D>(dk, static_cast<bf16*>(p.dk) + b * p.dk_sb + hk * p.dk_sh, p.dk_ss, kw, p.skv,
              p.scale, lane);
  store_wg<D>(dv, static_cast<bf16*>(p.dv) + b * p.dv_sb + hk * p.dv_sh, p.dv_ss, kw, p.skv,
              1.f, lane);
}

template <int D>
constexpr size_t dq_wg_smem_bytes() {  // Q, dO; the ring's K and V; alignment
  return 1024 + static_cast<size_t>(2 * kWgRows + 2 * kWgStages * kWgKv) * D * 2;
}

// KV tiles [first, last) of split ``split`` of ``splits`` over the tiles
// [t_lo, t_hi) a block's rows see: contiguous ranges of ceil(n / splits)
// tiles in split order (kernel.py's dq_split_tiles)
__device__ __forceinline__ void split_tiles(int t_lo, int t_hi, int splits, int split, int& first,
                                            int& last) {
  const int per = (t_hi - t_lo + splits - 1) / splits;
  first = min(t_hi, t_lo + split * per);
  last = min(t_hi, first + per);
}

// pass 3, wgmma: a block (blockIdx.x: its rows, .y: batch and query head,
// so that the blocks of one head run together and share its K and V in
// L2) holds kWgRows query rows, warpgroup g rows 64 g ..;
// KV tiles of kWgKv keys through the ring, kWgAhead tiles ahead; S and dP
// read both operands by descriptor, dS stays in registers as the A of dQ,
// and a tile's dQ product runs on under the next tile's S and dP. Split
// blockIdx.z
// of ``splits`` walks its range of the KV tiles; with splits > 1 it
// writes its float32 partial dQ (unscaled) to work (splits, B, Hq, Sq,
// d), which attention_dq_sum_kernel adds up in split order
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
attention_dq_wgmma_kernel(const Params p, float* work, int splits) {
  using bf16 = __nv_bfloat16;
  constexpr int kTile = kWgKv * D * 2;           // bytes of a K or V tile
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t qs = (smem_addr(smem_raw) + 1023u) & ~1023u;   // [kWgRows][D]
  const uint32_t gs = qs + kWgRows * D * 2;       // [kWgRows][D]
  const uint32_t ks = gs + kWgRows * D * 2;       // [kWgStages][kWgKv][D]
  const uint32_t vs = ks + kWgStages * kTile;     // [kWgStages][kWgKv][D]

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int bh = blockIdx.y;
  const int b = bh / p.hq;
  const int h = bh % p.hq;
  const int hk = h / (p.hq / p.hkv);
  const int r0 = blockIdx.x * kWgRows;
  const int rw = r0 + wg * 64 + warp * 16;        // this warp's first row
  const bool active = r0 + wg * 64 < p.sq;        // this warpgroup has rows
  const bf16* kp = static_cast<const bf16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const bf16* vp = static_cast<const bf16*>(p.v) + b * p.v_sb + hk * p.v_sh;

  // lse and delta of this thread's two rows (log2 units for the lse)
  float ll2[2], delta[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = rw + lane / 4 + hf * 8;
    const int64_t i = static_cast<int64_t>(bh) * p.sq + (row < p.sq ? row : 0);
    ll2[hf] = row < p.sq ? p.lse[i] * kLog2e : 0.f;
    delta[hf] = row < p.sq ? p.delta[i] : 0.f;
  }

  int k_lo, k_hi;
  key_range(p, r0, r0 + kWgRows, k_lo, k_hi);
  const int t_lo = k_lo / kWgKv;
  const int t_hi = k_hi > k_lo ? (k_hi + kWgKv - 1) / kWgKv : t_lo;
  int first, last;
  split_tiles(t_lo, t_hi, splits, blockIdx.z, first, last);

  auto load_kv = [&](int t) {
    const int buf = (t - first) % kWgStages;
    load_sw<D, kWgKv>(ks + buf * kTile, kp, p.k_ss, t * kWgKv, p.skv);
    load_sw<D, kWgKv>(vs + buf * kTile, vp, p.v_ss, t * kWgKv, p.skv);
  };

  float dq[D / 2], s[kWgKv / 2], dp[kWgKv / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kWgKv / 2; ++i) s[i] = dp[i] = 0.f;
  uint32_t da[kWgKv / 16][4];                   // dS, the A of dQ += dS K

  if (first < last) {
    load_sw<D, kWgRows>(qs, static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh, p.q_ss, r0,
                        p.sq);
    load_sw<D, kWgRows>(gs, static_cast<const bf16*>(p.g) + b * p.g_sb + h * p.g_sh, p.g_ss, r0,
                        p.sq);
  }
#pragma unroll
  for (int st = 0; st < kWgAhead; ++st) {
    if (first + st < last) load_kv(first + st);
    cp_async_commit();
  }
  const float sl2 = p.scale * kLog2e;

  for (int t = first; t < last; ++t) {
    const int buf = (t - first) % kWgStages;
    cp_async_wait<kWgAhead - 1>();
    fence_proxy_async_smem();
    __syncthreads();                  // tile t - 2's stage is free
    if (t + kWgAhead < last) load_kv(t + kWgAhead);
    cp_async_commit();
    if (!active) continue;            // a warpgroup-uniform branch
    const int k0 = t * kWgKv;
    const uint32_t kb = ks + buf * kTile;
    const uint32_t vb = vs + buf * kTile;

    // S = Q K^T and dP = dO V^T: 64 rows x kWgKv keys a warpgroup
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<kWgKv>(s, kmajor_desc(qs, kWgRows, wg * 64, kk), kmajor_desc(kb, kWgKv, 0, kk),
                      kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<kWgKv>(dp, kmajor_desc(gs, kWgRows, wg * 64, kk), kmajor_desc(vb, kWgKv, 0, kk),
                      kk);
    wgmma_commit();

    wgmma_wait<1>();                  // tile t - 1's dQ, and S
    fence_frags(da);
    fence_all(s);
#pragma unroll
    for (int i = 0; i < kWgKv / 2; ++i) s[i] = prob2(s[i], sl2, ll2[(i % 4) / 2]);
    if (tile_masked(p, rw, rw + 16, k0, k0 + kWgKv)) {   // a branch, as in pass 2
#pragma unroll
      for (int j = 0; j < kWgKv / 8; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (!visible(p, rw + lane / 4 + (q / 2) * 8, k0 + j * 8 + (lane % 4) * 2 + (q & 1)))
            s[4 * j + q] = 0.f;
    }
    wgmma_wait<0>();
    fence_all(dp);
#pragma unroll
    for (int i = 0; i < kWgKv / 2; ++i) dp[i] = s[i] * (dp[i] - delta[(i % 4) / 2]);
    pack_a<kWgKv / 16>(da, dp);
    // dQ += dS K, running on under the next tile's S and dP
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWgKv / 16; ++kk)
      wgmma_rs<D>(dq, da[kk], mnmajor_desc(kb, kWgKv, kk), 1);
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_frags(da);
  cp_async_wait<0>();
  if (!active) return;
  fence_all(dq);

  if (splits == 1) {
    store_wg<D>(dq, static_cast<bf16*>(p.dq) + b * p.dq_sb + h * p.dq_sh, p.dq_ss, rw, p.sq,
                p.scale, lane);
    return;
  }
  const int bhs = static_cast<int>(gridDim.y);
  float* part = work + (static_cast<int64_t>(blockIdx.z) * bhs + bh) * p.sq * D;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = rw + lane / 4 + hf * 8;
    if (row >= p.sq) continue;
    float* dst = part + static_cast<int64_t>(row) * D + (lane % 4) * 2;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(dst + j * 8) = make_float2(dq[4 * j + 2 * hf],
                                                            dq[4 * j + 2 * hf + 1]);
  }
}

// dq = scale * (the splits' partials summed in split order): a thread four
// columns of a row
constexpr int kSumThreads = 256;

__global__ void __launch_bounds__(kSumThreads)
attention_dq_sum_kernel(const Params p, const float* work, int splits, int rows) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kSumThreads + threadIdx.x;
  const int quads = p.d / 4;
  if (i >= static_cast<int64_t>(rows) * quads) return;
  const int64_t row = i / quads;
  const int c = static_cast<int>(i % quads) * 4;
  const int64_t plane = static_cast<int64_t>(rows) * p.d;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int sp = 0; sp < splits; ++sp) {
    const float4 x = *reinterpret_cast<const float4*>(work + sp * plane + row * p.d + c);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  const int bh = static_cast<int>(row / p.sq);
  const int r = static_cast<int>(row % p.sq);
  __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(p.dq) + (bh / p.hq) * p.dq_sb
                       + (bh % p.hq) * p.dq_sh + static_cast<int64_t>(r) * p.dq_ss + c;
  *reinterpret_cast<uint2*>(dst) = make_uint2(pack_bf16(acc.x * p.scale, acc.y * p.scale),
                                              pack_bf16(acc.z * p.scale, acc.w * p.scale));
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

template <int D, int BR>
int launch_dkdv_wg(const Params& p, int batch, cudaStream_t stream) {
  constexpr size_t bytes = dkdv_wg_smem_bytes<D, BR>();
  const int e = allow_smem(attention_dkdv_wgmma_kernel<D, BR>, bytes);
  if (e != 0) return e;
  attention_dkdv_wgmma_kernel<D, BR>
      <<<dim3((p.skv + kWgKeys - 1) / kWgKeys, batch * p.hkv), kWgThreads, bytes, stream>>>(p);
  return 0;
}

// the wgmma tile: the dK/dV pass on query tiles of 32 rows where sq <= 32
// (seamless's cross-attention: no padded rows) or d = 128, else 64; the
// dQ pass over ``splits`` ranges of KV tiles, summed by a third pass
template <int D>
int launch_wg(const Params& p, int batch, int splits, float* work, cudaStream_t stream) {
  int e = (D == 128 || p.sq <= 32) ? launch_dkdv_wg<D, 32>(p, batch, stream)
                                   : launch_dkdv_wg<D, D == 128 ? 32 : 64>(p, batch, stream);
  constexpr size_t s3 = dq_wg_smem_bytes<D>();
  if (e == 0) e = allow_smem(attention_dq_wgmma_kernel<D>, s3);
  if (e != 0) return e;
  attention_dq_wgmma_kernel<D>
      <<<dim3((p.sq + kWgRows - 1) / kWgRows, batch * p.hq, splits), kWgThreads, s3, stream>>>(
          p, work, splits);
  if (splits > 1) {
    const int rows = batch * p.hq * p.sq;
    const int64_t n = static_cast<int64_t>(rows) * (p.d / 4);
    attention_dq_sum_kernel<<<static_cast<int>((n + kSumThreads - 1) / kSumThreads), kSumThreads,
                              0, stream>>>(p, work, splits, rows);
  }
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* x) { return reinterpret_cast<uintptr_t>(x) % 16 == 0; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, dO and the gradients).
// variant: 0 = cuda_core, 1 = tensor_core (bf16, d 64 or 128, 16-byte
// aligned rows: the wrapper checks the strides); tile (tensor_core only):
// 0 = mma_sync, 1 = wgmma. strides: 24 element strides, the (batch, head,
// seq) ones of q, k, v, o, dO, dq, dk, dv in that order (head_dim
// contiguous in each). lse: the forward's float32 (B, Hq, Sq), contiguous;
// delta: float32 (B, Hq, Sq) scratch. dq_splits: the wgmma tile's dQ key
// splits (1 for every other tile); above 1, dq_work is float32 scratch of
// (dq_splits, B, Hq, Sq, d), contiguous. Launches the passes on
// ``stream`` and returns cudaGetLastError() after them (nonzero when a
// launch was refused or the arguments are bad).
extern "C" int flash_attention_backward_launch(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const float* lse, float* delta, void* dq, void* dk, void* dv, const int64_t* strides,
    int batch, int hq, int hkv, int sq, int skv, int d,
    int causal, int window, float scale, int dtype, int variant, int tile, int dq_splits,
    float* dq_work, void* stream) {
  if (d < 1 || d > 128 || hkv < 1 || hq % hkv != 0 || sq < 1 || skv < 1 ||
      batch < 1 || (dtype != 0 && dtype != 1) || (variant != 0 && variant != 1) ||
      strides == nullptr || lse == nullptr || delta == nullptr || (tile != 0 && tile != 1) ||
      (tile == 1 && variant != 1) || dq_splits < 1 || dq_splits > 65535 ||
      (dq_splits > 1 && (tile != 1 || dq_work == nullptr)))
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
  if (variant == 1 && tile == 1)
    return d == 64 ? launch_wg<64>(p, batch, dq_splits, dq_work, st)
                   : launch_wg<128>(p, batch, dq_splits, dq_work, st);
  if (variant == 1) return d == 64 ? launch_tc<64>(p, batch, st) : launch_tc<128>(p, batch, st);
  if (dtype == 0) launch_cc_for_dim<float>(p, batch, st);
  else launch_cc_for_dim<__nv_bfloat16>(p, batch, st);
  return static_cast<int>(cudaGetLastError());
}
