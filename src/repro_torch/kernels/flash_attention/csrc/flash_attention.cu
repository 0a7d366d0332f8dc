// Block attention with an online softmax, for Hopper (sm_90a): two
// variants of one function.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py,
//   flash_attention_pallas (pl.pallas_call at :103) and its _kernel.
//   Same function: softmax(q k^T * scale + mask) v per (batch, head), f32
//   accumulation, output in the input dtype. Kept semantics, by both
//   variants:
//   * queries are the LAST sq positions of the skv timeline
//     (q_offset = skv - sq), so decode-style suffix queries work;
//   * causal and sliding-window masks on global positions;
//   * columns past skv are never read (the TPU kernel masks padded
//     columns even when they hold NaN; here they are not loaded at all,
//     and padded K/V rows are zeros in shared memory); a NaN score in a
//     valid column becomes -1e30, as in the TPU kernel;
//   * a fully masked row gives exactly 0: its probabilities are zero and
//     the denominator is clamped at 1e-30.
//   Given a non-null ``lse`` (in the tensor_core variant an instantiation
//   of its own, so the serving kernel carries no code for it), each
//   variant also writes the row's
//   log-sum-exp of the scaled logits, float32 (B, Hq, Sq), once a row after
//   its key loop: m + log(l), or +inf for a row with no key to attend, so
//   that the backward (flash_attention_backward.cu) recomputes every
//   probability as exp(s - lse) and a row without keys gets none. Serving
//   passes null and writes nothing.
//   GQA is handled here by index (kv head = q head / group) instead of
//   the repeat the TPU wrapper materializes. The output is written through
//   its strides (the wrapper lays it out (B, S, H, d)).
//
// What bounds it on the H100: at the serving shape (S = 64, d = 64,
// B*H = 384, bf16) the work is 0.40 GFLOP against 12.6 MB of q/k/v/o,
// about 32 FLOP per byte, far under the ~295 FLOP/byte where the tensor
// cores would become the limit; the bound is memory (about 3.8 us at
// 3.35 TB/s), so what matters is that every block's loads are in flight
// together and its arithmetic is short.
//
// tensor_core variant (bf16, d in {64, 128}, rows 16-byte aligned): the
// FlashAttention-2 structure on mma.sync m16n8k16 (bf16 in, f32
// accumulate). One block of 4 warps covers (batch*head, 64 query rows);
// each warp owns 16 rows, so the serving shape is 384 blocks of 128
// threads. Q is copied once and kept in registers as A fragments; K and V
// tiles of 64 keys are double-buffered in shared memory by 16-byte
// cp.async, V in its own copy group so S = Q K^T starts while V is in
// flight. S is f32 in registers; scale and masks apply there; the row max
// and sum come from quad shuffles. P is rounded to bf16 in registers to
// be the A operand of P V (V through ldmatrix.trans): one rounding the
// TPU kernel does not make (it keeps p in f32), a relative error of at
// most 2^-9 per weight, inside the bf16 tolerance (2e-2) the output is
// held to.
//
// cuda_core variant (f32, any other d <= 128, unaligned rows): TPR threads
// own one query row; thread t of the row holds the columns c*TPR + t
// (c < 16) of q and of the accumulator, so the TPR threads of a row read
// consecutive shared-memory words. A score is a partial dot product over
// those columns, summed with TPR-lane shuffles; K/V tiles of 32 keys are
// staged in shared memory as f32. f32 keeps its f32 tolerance (no TF32).

#include "tile_mma.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBlockK = 32;          // keys per shared-memory tile
constexpr int kColsPerThread = 16;   // head_dim <= 16 * TPR
constexpr float kNegInf = -1e30f;

// a row's log-sum-exp from its running max and sum; +inf when no key was
// visible (l == 0), so that exp(s - lse) is 0 for every key of the row
__device__ __forceinline__ float row_lse(float m, float l) {
  return l > 0.f ? m + logf(l) : __int_as_float(0x7f800000);
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;          // (B, Hq, Sq) float32, or null: not written
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
    if (p.lse != nullptr && t == 0)
      p.lse[static_cast<int64_t>(bh) * p.sq + q_row] = row_lse(m, l);
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

// ------------------------------------------------------ tensor_core variant

constexpr int kTcRows = 64;          // query rows per block: 4 warps x 16
constexpr int kTcKeys = 64;          // keys per K/V tile
constexpr int kTcThreads = 128;

// byte offset of 16-byte word c of row r in a tile of rows of D bf16:
// words swizzled by r % 8, so the 8 rows of one ldmatrix phase hit 8
// distinct bank groups
template <int D>
__device__ __forceinline__ int tile_off(int r, int c) {
  return r * (D * 2) + ((c ^ (r & 7)) << 4);
}

template <int D>
constexpr size_t tc_smem_bytes() {    // Q, then K and V twice each
  return static_cast<size_t>(kTcRows + 4 * kTcKeys) * D * 2;
}

template <int D, bool kLse>
__global__ void __launch_bounds__(kTcThreads)
flash_attention_tc_kernel(const Params p) {
  using bf16 = __nv_bfloat16;
  constexpr int kWords = D / 8;                   // 16-byte words per row
  constexpr int kTile = kTcKeys * D * 2;          // bytes of a K or V tile
  static_assert(kTcRows == kTcKeys, "Q and K/V tiles share load_rows");
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t qs = smem_addr(smem);            // [kTcRows][D]
  const uint32_t ks = qs + kTcRows * D * 2;       // [2][kTcKeys][D]
  const uint32_t vs = ks + 2 * kTile;             // [2][kTcKeys][D]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int bh = blockIdx.x;
  const int b = bh / p.hq;
  const int h = bh % p.hq;
  const int hk = h / (p.hq / p.hkv);
  const int q0 = blockIdx.y * kTcRows;
  const int q_offset = p.skv - p.sq;
  const int rq = warp * 16 + lane / 4;            // this thread's rows: rq, rq + 8
  const bf16* qp = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kp = static_cast<const bf16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const bf16* vp = static_cast<const bf16*>(p.v) + b * p.v_sb + hk * p.v_sh;

  // key tiles any row of this block may see (as in the cuda_core variant)
  const int first_pos = q0 + q_offset;
  const int last_pos = min(q0 + kTcRows, p.sq) - 1 + q_offset;
  int k_lo = 0;
  int k_hi = p.skv;
  if (p.causal) k_hi = min(k_hi, last_pos + 1);
  if (p.window) k_lo = max(k_lo, first_pos - p.window + 1);
  const int t_lo = k_lo / kTcKeys;
  const int t_hi = k_hi > k_lo ? (k_hi + kTcKeys - 1) / kTcKeys : t_lo;

  // rows row0.. of a (rows, D) operand into a tile; rows past n are zeros
  // and are never read
  auto load_rows = [&](uint32_t dst, const bf16* src, int64_t stride, int row0, int n) {
    for (int i = tid; i < kTcKeys * kWords; i += kTcThreads) {
      const int r = i / kWords, c = i % kWords;
      const bool ok = row0 + r < n;
      cp_async16(dst + tile_off<D>(r, c), ok ? src + (row0 + r) * stride + c * 8 : src, ok);
    }
  };

  // copy groups: {Q, K[t_lo]}, {V[t_lo]}, then {K[t+1]}, {V[t+1]} per tile
  load_rows(qs, qp, p.q_ss, q0, p.sq);
  if (t_lo < t_hi) load_rows(ks, kp, p.k_ss, t_lo * kTcKeys, p.skv);
  cp_async_commit();
  if (t_lo < t_hi) load_rows(vs, vp, p.v_ss, t_lo * kTcKeys, p.skv);
  cp_async_commit();

  uint32_t qf[D / 16][4];
  float o[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[nt][j] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};                        // this thread's columns only

  for (int t = t_lo; t < t_hi; ++t) {
    const int buf = (t - t_lo) & 1;
    const uint32_t kb = ks + buf * kTile;
    const uint32_t vb = vs + buf * kTile;
    cp_async_wait<1>();          // Q and K[t] landed; V[t] may be in flight
    __syncthreads();             // ... for every thread; tile t-1 is consumed
    if (t == t_lo) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int r = warp * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
        ldmatrix_x4(qf[kk], qs + tile_off<D>(r, kk * 2 + lane / 16));
      }
    }
    if (t + 1 < t_hi) load_rows(ks + (buf ^ 1) * kTile, kp, p.k_ss, (t + 1) * kTcKeys, p.skv);
    cp_async_commit();
    if (t + 1 < t_hi) load_rows(vs + (buf ^ 1) * kTile, vp, p.v_ss, (t + 1) * kTcKeys, p.skv);
    cp_async_commit();

    // S = Q K^T, 16 rows x 64 keys per warp, f32
    float s[kTcKeys / 8][4];
#pragma unroll
    for (int nt = 0; nt < kTcKeys / 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[nt][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int nj = 0; nj < kTcKeys / 16; ++nj) {
        uint32_t kf[4];
        const int key = nj * 16 + (lane / 16) * 8 + lane % 8;
        ldmatrix_x4(kf, kb + tile_off<D>(key, kk * 2 + (lane / 8) % 2));
        mma_bf16(s[2 * nj], qf[kk], kf[0], kf[1]);
        mma_bf16(s[2 * nj + 1], qf[kk], kf[2], kf[3]);
      }

    // scale, mask on global positions, online softmax
    const int k0 = t * kTcKeys;
    uint32_t valid = 0u;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < kTcKeys / 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q_pos = q0 + rq + (j / 2) * 8 + q_offset;
        const int key = k0 + nt * 8 + (lane % 4) * 2 + (j & 1);
        bool ok = key < p.skv;
        if (p.causal) ok = ok && key <= q_pos;
        if (p.window) ok = ok && key > q_pos - p.window;
        const float x = s[nt][j] * p.scale;
        const float sv = ok ? (isnan(x) ? kNegInf : x) : kNegInf;
        s[nt][j] = sv;
        valid |= (ok ? 1u : 0u) << (nt * 4 + j);
        mx[j / 2] = fmaxf(mx[j / 2], sv);
      }
    float alpha[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
      const float m_new = fmaxf(m[hf], mx[hf]);
      alpha[hf] = expf(m[hf] - m_new);
      m[hf] = m_new;
      l[hf] *= alpha[hf];
    }
#pragma unroll
    for (int nt = 0; nt < kTcKeys / 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pv = ((valid >> (nt * 4 + j)) & 1u) ? expf(s[nt][j] - m[j / 2]) : 0.f;
        s[nt][j] = pv;
        l[j / 2] += pv;
      }
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) o[nt][j] *= alpha[j / 2];

    cp_async_wait<2>();          // V[t] landed; tile t+1 may be in flight
    __syncthreads();
    // O += P V: P rounded to bf16 A fragments in registers
#pragma unroll
    for (int kk = 0; kk < kTcKeys / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int nj = 0; nj < D / 16; ++nj) {
        uint32_t vf[4];
        const int key = kk * 16 + ((lane / 8) % 2) * 8 + lane % 8;
        ldmatrix_x4_trans(vf, vb + tile_off<D>(key, nj * 2 + lane / 16));
        mma_bf16(o[2 * nj], a, vf[0], vf[1]);
        mma_bf16(o[2 * nj + 1], a, vf[2], vf[3]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 1);
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 2);
    const int row = q0 + rq + hf * 8;
    if (row >= p.sq) continue;
    const float inv = 1.f / fmaxf(l[hf], 1e-30f);
    bf16* op = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh
               + static_cast<int64_t>(row) * p.o_ss + (lane % 4) * 2;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      *reinterpret_cast<uint32_t*>(op + nt * 8) =
          pack_bf16(o[nt][2 * hf] * inv, o[nt][2 * hf + 1] * inv);
    if constexpr (kLse) {
      if (lane % 4 == 0) p.lse[static_cast<int64_t>(bh) * p.sq + row] = row_lse(m[hf], l[hf]);
    }
  }
}

template <int D, bool kLse>
int launch_tc_lse(const Params& p, int batch, cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<D>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_tc_kernel<D, kLse>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(batch * p.hq, (p.sq + kTcRows - 1) / kTcRows);
  flash_attention_tc_kernel<D, kLse><<<grid, kTcThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// the serving instantiation (no lse) carries no code for it
template <int D>
int launch_tc(const Params& p, int batch, cudaStream_t stream) {
  return p.lse != nullptr ? launch_tc_lse<D, true>(p, batch, stream)
                          : launch_tc_lse<D, false>(p, batch, stream);
}

bool aligned16(const void* x) { return reinterpret_cast<uintptr_t>(x) % 16 == 0; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. variant: 0 = cuda_core, 1 =
// tensor_core (bf16, d 64 or 128, 16-byte aligned rows: the wrapper
// checks the strides). lse: float32 (B, Hq, Sq) contiguous, or null.
// Returns cudaGetLastError() after the launch
// (nonzero when the launch was refused or the arguments are bad).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int64_t q_sb, int64_t q_sh, int64_t q_ss,
    int64_t k_sb, int64_t k_sh, int64_t k_ss,
    int64_t v_sb, int64_t v_sh, int64_t v_ss,
    int64_t o_sb, int64_t o_sh, int64_t o_ss,
    int batch, int hq, int hkv, int sq, int skv, int d,
    int causal, int window, float scale, int dtype, int variant, void* stream) {
  if (d < 1 || d > 128 || hkv < 1 || hq % hkv != 0 || sq < 1 || skv < 1 ||
      batch < 1 || (dtype != 0 && dtype != 1) || (variant != 0 && variant != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, o, lse,
           q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
           o_sb, o_sh, o_ss,
           hq, hkv, sq, skv, d, causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
    if (dtype != 1 || !(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o)))
      return static_cast<int>(cudaErrorInvalidValue);
    if (d == 64) return launch_tc<64>(p, batch, s);
    if (d == 128) return launch_tc<128>(p, batch, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) launch_for_dim<float>(p, batch, s);
  else launch_for_dim<__nv_bfloat16>(p, batch, s);
  return static_cast<int>(cudaGetLastError());
}
