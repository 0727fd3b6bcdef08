// Flash attention forward: causal / sliding-window / bidirectional GQA
// attention over a whole prompt, with an online softmax over K/V tiles.
//
// Replaces src/repro/kernels/flash_attention/kernel.py
// flash_attention_fwd (_flash_kernel), and computes the function of its
// plain version, src/repro_torch/kernels/flash_attention/ref.py: q is
// scaled in f32 before QK^T; query i sits at position i + Skv - Sq (the
// ends are aligned); a key is seen when k_pos < Skv, k_pos <= q_pos
// (causal) and k_pos > q_pos - window (window > 0); query head h reads
// kv head h / G; m, l and acc are f32, m starts at -1e30, p is re-masked
// to 0 where the mask is false, and the output acc / max(l, 1e-30) is
// cast to q's dtype, so a row that sees no key gives 0.
//
// Bound: 4 * D operations per visible (query, key) pair against one read
// of q, k, v and one write of o, so at the model's shapes it is bound by
// operations: the bf16 tensor-core peak for bf16, the f32 CUDA-core peak
// for f32 (TF32 is not used).  Like the TPU kernel, both paths below
// skip the K/V tiles that lie wholly outside the causal and window band,
// so a sliding-window layer pays for its band only, and start the heavy
// (late) query tiles of a causal mask first.  Strides are 64-bit: at the
// prefill shapes B * H * S * D passes 2^31.  Built without -fmad=false
// (kernels/build.py): it is held to a tolerance, not to bitwise
// equality, and fused multiply-adds double the f32 rate.
//
// The simple designs first; wgmma, TMA and warp specialisation are the
// later redesign.
// - f32 (flash_attention_kernel): one block per (b, h, 64-row query tile)
//   keeps its q tile (scaled, f32) in shared memory and walks the 64-row
//   K/V tiles of its band, staged in shared memory as f32.  Its 256
//   threads form 16 row groups of 16 lanes: each thread holds 4 query
//   rows x 4 key columns of the score tile and 4 rows x D/16 columns of
//   the output accumulator in registers; the row max and sum are reduced
//   across a row group's 16 lanes with shuffles, and the probabilities go
//   through shared memory to the P.V product, all on the CUDA cores.
// - bf16 (tc::flash_attention_tc_kernel): the products on the tensor
//   cores with mma.sync m16n8k16, f32 accumulation; see namespace tc.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // key rows per tile
constexpr int kThreads = 256;  // 16 row groups x 16 lanes
constexpr int kRows = kBQ / 16;  // query rows per thread
constexpr int kCols = kBK / 16;  // score columns per thread
constexpr float kNegInf = -1e30f;

// Shared-memory layout for head dim D, in floats.  Rows of sQ and sK are
// padded by 4 so that the float4 reads of a warp's two query rows and of
// eight consecutive key rows fall in distinct banks; sP rows likewise.
template <int D>
struct Layout {
  static constexpr int kQK = D + 4;                // sQ, sK row stride
  static constexpr int kP = kBK + 4;               // sP row stride
  static constexpr int kVec = D >= 64 ? 4 : D / 16;  // output cols per read
  static constexpr int kGroups = D / (16 * kVec);  // reads per output row
  static constexpr int kOut = kGroups * kVec;      // output cols per thread
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kBQ * kQK;
  static constexpr int kV = kK + kBK * kQK;
  static constexpr int kPOff = kV + kBK * D;
  static constexpr int kFloats = kPOff + kBQ * kP;
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int H, G, Sq, Skv, causal, window;
  float scale;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
};

template <int N>
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  if constexpr (N == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x; out[1] = x.y;
  } else {
    out[0] = *p;
  }
}

// Copies rows [row0, row0 + 64) of a (rows, D) slice with row stride
// `ss` into shared memory times `mul`, rows at or past `n` as 0.
template <int D>
__device__ __forceinline__ void stage(float* dst, int dst_stride,
                                      const float* src, long long ss,
                                      int row0, int n, float mul) {
  for (int idx = threadIdx.x; idx < 64 * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int row = row0 + r;
    dst[r * dst_stride + d] = row < n ? src[(long long)row * ss + d] * mul
                                      : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const Params p) {
  using L = Layout<D>;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem + L::kQ;
  float* sK = smem + L::kK;
  float* sV = smem + L::kV;
  float* sP = smem + L::kPOff;

  const int qi = gridDim.x - 1 - blockIdx.x;  // late (heavy) tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int q0 = qi * kBQ;
  const int q_base = q0 + (p.Skv - p.Sq);      // position of row 0

  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb +
                    h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb +
                    (h / p.G) * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb +
                    (h / p.G) * p.v_sh;
  stage<D>(sQ, L::kQK, qg, p.q_ss, q0, p.Sq, p.scale);

  // the K tiles this query tile can see: [lo, hi)
  const int n_kt = (p.Skv + kBK - 1) / kBK;
  int hi = n_kt;
  if (p.causal) {
    const int last = q_base + min(kBQ, p.Sq - q0) - 1;  // newest query
    hi = last < 0 ? 0 : min(n_kt, last / kBK + 1);
  }
  int lo = 0;
  if (p.window > 0) {
    const int first = q_base - p.window + 1;  // oldest key row 0 sees
    lo = first <= 0 ? 0 : first / kBK;
  }

  float m[kRows], l[kRows], acc[kRows][L::kOut];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < L::kOut; ++c) acc[i][c] = 0.f;
  }

  for (int kt = lo; kt < hi; ++kt) {
    __syncthreads();  // the previous tile's sK, sV, sP are consumed
    stage<D>(sK, L::kQK, kg, p.k_ss, kt * kBK, p.Skv, 1.f);
    stage<D>(sV, D, vg, p.v_ss, kt * kBK, p.Skv, 1.f);
    __syncthreads();

    // scores: rows ty * 4 + i, columns tx + 16 * j
    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float qv[kRows][4], kv[kCols][4];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        load_vec<4>(sQ + (ty * kRows + i) * L::kQK + d, qv[i]);
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        load_vec<4>(sK + (tx + 16 * j) * L::kQK + d, kv[j]);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[i][j] += qv[i][e] * kv[j][e];
    }

    // mask, online softmax; a row group's 16 lanes share its rows
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int q_pos = q_base + ty * kRows + i;
      bool valid[kCols];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int k_pos = kt * kBK + tx + 16 * j;
        bool ok = k_pos < p.Skv;
        if (p.causal) ok = ok && k_pos <= q_pos;
        if (p.window > 0) ok = ok && k_pos > q_pos - p.window;
        valid[j] = ok;
        s[i][j] = ok ? s[i][j] : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float pij = valid[j] ? expf(s[i][j] - m_new) : 0.f;
        sP[(ty * kRows + i) * L::kP + tx + 16 * j] = pij;
        sum += pij;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < L::kOut; ++c) acc[i][c] *= corr;
    }
    __syncthreads();  // sP complete

    // acc += P . V; output columns g * 16 * kVec + tx * kVec + e
#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      float pv[kRows][4];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        load_vec<4>(sP + (ty * kRows + i) * L::kP + c, pv[i]);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float vv[L::kOut];
#pragma unroll
        for (int g = 0; g < L::kGroups; ++g)
          load_vec<L::kVec>(sV + (c + cc) * D + g * 16 * L::kVec + tx * L::kVec,
                            vv + g * L::kVec);
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int o = 0; o < L::kOut; ++o) acc[i][o] += pv[i][cc] * vv[o];
      }
    }
  }

  float* og = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty * kRows + i;
    if (row >= p.Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float* orow = og + (long long)row * p.o_ss;
#pragma unroll
    for (int g = 0; g < L::kGroups; ++g)
#pragma unroll
      for (int e = 0; e < L::kVec; ++e)
        orow[g * 16 * L::kVec + tx * L::kVec + e] =
            acc[i][g * L::kVec + e] / den;
  }
}

// ---------------------------------------------------------------------- //
// bf16: the products on the tensor cores, mma.sync m16n8k16 bf16 -> f32
// ---------------------------------------------------------------------- //
// One block of 4 warps per (b, h, 64-row query tile); each warp owns 16
// query rows, keeps their q fragments, the f32 output accumulator and
// the row max and sum in registers, and walks the block's 64-row K/V
// tiles, staged in shared memory as bf16 with 16-byte loads.  S = Q K^T
// takes its B fragments straight from K's rows; the probabilities go
// from the score accumulators into A fragments in registers (the
// accumulator layout of two 8-key tiles is the A layout of one 16-key
// step); V's B fragments come from ldmatrix.trans.  P.V keeps f32
// accuracy by splitting each probability into a bf16 head and the bf16
// of its remainder, two products against the exact bf16 V: one bf16 P
// alone put a bf16 ulp on outputs near 2, against the plain version's
// f32 product, close to the 2e-2 tolerance.  The scale multiplies the
// f32 scores
// after the product (the same number as scaling q in f32 first, without
// rounding a scaled q to bf16).
namespace tc {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

// row stride in bf16: 16-byte aligned rows whose 32-bit words shift by
// 4 banks (D = 64, 128) or an odd multiple of 4 (D = 16, 32) a row, so
// the 8 rows a fragment load touches fall in distinct banks
template <int D>
struct Smem {
  static constexpr int kStride = D + 8;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kBQ * kStride;
  static constexpr int kV = kK + kBK * kStride;
  static constexpr int kElems = kV + kBK * kStride;
};

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two f32 as a bf16x2 fragment register (the first in the low half),
// and in `rest` the bf16x2 of what rounding left over
__device__ __forceinline__ uint32_t pack(float a, float b, uint32_t& rest) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 r = __floats2bfloat162_rn(
      a - __low2float(x), b - __high2float(x));
  rest = *reinterpret_cast<const uint32_t*>(&r);
  return *reinterpret_cast<const uint32_t*>(&x);
}

__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const __nv_bfloat16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// rows [row0, row0 + 64) of a (rows, D) bf16 slice into shared memory,
// rows at or past n as 0; 16-byte loads when the slice allows them
template <int D>
__device__ __forceinline__ void stage(__nv_bfloat16* dst,
                                      const __nv_bfloat16* src, long long ss,
                                      int row0, int n) {
  constexpr int kChunks = D / 8;
  const bool vec = (reinterpret_cast<uintptr_t>(src) % 16 == 0) &&
                   (ss % 8 == 0);
  if (vec) {
#pragma unroll
    for (int idx = threadIdx.x; idx < 64 * kChunks; idx += kThreads) {
      const int r = idx / kChunks, c = idx % kChunks;
      const int row = row0 + r;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (row < n)
        x = *reinterpret_cast<const uint4*>(src + (long long)row * ss + c * 8);
      *reinterpret_cast<uint4*>(dst + r * Smem<D>::kStride + c * 8) = x;
    }
  } else {
    for (int idx = threadIdx.x; idx < 64 * D; idx += kThreads) {
      const int r = idx / D, d = idx % D;
      const int row = row0 + r;
      dst[r * Smem<D>::kStride + d] =
          row < n ? src[(long long)row * ss + d] : __float2bfloat16_rn(0.f);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_tc_kernel(const Params p) {
  using S = Smem<D>;
  constexpr int kKSteps = D / 16;   // k steps of Q K^T
  constexpr int kNTiles = kBK / 8;  // 8-key tiles of S
  constexpr int kDTiles = D / 8;    // 8-column tiles of the output
  extern __shared__ __align__(16) __nv_bfloat16 smem_h[];
  __nv_bfloat16* sQ = smem_h + S::kQ;
  __nv_bfloat16* sK = smem_h + S::kK;
  __nv_bfloat16* sV = smem_h + S::kV;

  const int qi = gridDim.x - 1 - blockIdx.x;  // late (heavy) tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;     // fragment row, column pair
  const int q0 = qi * kBQ;
  const int q_base = q0 + (p.Skv - p.Sq);

  using bf16 = __nv_bfloat16;
  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kg =
      static_cast<const bf16*>(p.k) + b * p.k_sb + (h / p.G) * p.k_sh;
  const bf16* vg =
      static_cast<const bf16*>(p.v) + b * p.v_sb + (h / p.G) * p.v_sh;
  stage<D>(sQ, qg, p.q_ss, q0, p.Sq);
  __syncthreads();

  // this warp's q fragments: rows warp * 16 + g and + 8
  uint32_t qa[kKSteps][4];
  const bf16* qr = sQ + (warp * 16 + g) * S::kStride + t * 2;
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk) {
    qa[kk][0] = ld32(qr + kk * 16);
    qa[kk][1] = ld32(qr + 8 * S::kStride + kk * 16);
    qa[kk][2] = ld32(qr + kk * 16 + 8);
    qa[kk][3] = ld32(qr + 8 * S::kStride + kk * 16 + 8);
  }

  const int n_kt = (p.Skv + kBK - 1) / kBK;
  int hi = n_kt;
  if (p.causal) {
    const int last = q_base + min(kBQ, p.Sq - q0) - 1;
    hi = last < 0 ? 0 : min(n_kt, last / kBK + 1);
  }
  int lo = 0;
  if (p.window > 0) {
    const int first = q_base - p.window + 1;
    lo = first <= 0 ? 0 : first / kBK;
  }

  const int qpos[2] = {q_base + warp * 16 + g, q_base + warp * 16 + g + 8};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[kDTiles][4];
#pragma unroll
  for (int nd = 0; nd < kDTiles; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;

  for (int kt = lo; kt < hi; ++kt) {
    __syncthreads();  // the previous tile's sK, sV are consumed
    stage<D>(sK, kg, p.k_ss, kt * kBK, p.Skv);
    stage<D>(sV, vg, p.v_ss, kt * kBK, p.Skv);
    __syncthreads();

    // S = Q K^T: element e of tile j is row g + 8 * (e / 2), key
    // j * 8 + t * 2 + e % 2
    float s[kNTiles][4];
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      const bf16* kr = sK + (j * 8 + g) * S::kStride + t * 2;
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk)
        mma(s[j], qa[kk], ld32(kr + kk * 16), ld32(kr + kk * 16 + 8));
    }

    // scale, mask, online softmax; a row's 4 lanes form a quad
    uint32_t valid = 0;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kNTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int k_pos = kt * kBK + j * 8 + t * 2 + (e & 1);
        bool ok = k_pos < p.Skv;
        if (p.causal) ok = ok && k_pos <= qpos[r];
        if (p.window > 0) ok = ok && k_pos > qpos[r] - p.window;
        s[j][e] = ok ? s[j][e] * p.scale : kNegInf;
        valid |= (ok ? 1u : 0u) << (j * 4 + e);
        mx[r] = fmaxf(mx[r], s[j][e]);
      }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < kNTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float pe =
            (valid >> (j * 4 + e)) & 1u ? expf(s[j][e] - m[r]) : 0.f;
        s[j][e] = pe;
        sum[r] += pe;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * corr[r] + sum[r];
    }
#pragma unroll
    for (int nd = 0; nd < kDTiles; ++nd) {
      o[nd][0] *= corr[0];
      o[nd][1] *= corr[0];
      o[nd][2] *= corr[1];
      o[nd][3] *= corr[1];
    }

    // O += P V, 16 keys a step
#pragma unroll
    for (int jj = 0; jj < kBK / 16; ++jj) {
      uint32_t pa[4], pr[4];
      pa[0] = pack(s[2 * jj][0], s[2 * jj][1], pr[0]);
      pa[1] = pack(s[2 * jj][2], s[2 * jj][3], pr[1]);
      pa[2] = pack(s[2 * jj + 1][0], s[2 * jj + 1][1], pr[2]);
      pa[3] = pack(s[2 * jj + 1][2], s[2 * jj + 1][3], pr[3]);
      const bf16* vr = sV +
                       (jj * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                           S::kStride +
                       (lane >> 4) * 8;
#pragma unroll
      for (int nd2 = 0; nd2 < kDTiles / 2; ++nd2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vr + nd2 * 16);
        mma(o[2 * nd2], pa, vb[0], vb[1]);
        mma(o[2 * nd2], pr, vb[0], vb[1]);
        mma(o[2 * nd2 + 1], pa, vb[2], vb[3]);
        mma(o[2 * nd2 + 1], pr, vb[2], vb[3]);
      }
    }
  }

  bf16* og = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= p.Sq) continue;
    const float den = fmaxf(l[r], 1e-30f);
    bf16* orow = og + (long long)row * p.o_ss + t * 2;
#pragma unroll
    for (int nd = 0; nd < kDTiles; ++nd) {
      orow[nd * 8] = __float2bfloat16_rn(o[nd][2 * r] / den);
      orow[nd * 8 + 1] = __float2bfloat16_rn(o[nd][2 * r + 1] / den);
    }
  }
}

template <int D>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const int smem = Smem<D>::kElems * (int)sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_tc_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + kBQ - 1) / kBQ, p.H, B);
  flash_attention_tc_kernel<D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace tc

template <int D>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const int smem = Layout<D>::kFloats * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + kBQ - 1) / kBQ, p.H, B);
  flash_attention_kernel<D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_f32(const Params& p, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<16>(p, B, stream);
    case 32: return launch<32>(p, B, stream);
    case 64: return launch<64>(p, B, stream);
    case 128: return launch<128>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_bf16(const Params& p, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return tc::launch<16>(p, B, stream);
    case 32: return tc::launch<32>(p, B, stream);
    case 64: return tc::launch<64>(p, B, stream);
    case 128: return tc::launch<128>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, Sq, D), k/v (B, Hkv, Skv, D), o (B, H, Sq, D): the head dim
// dense, the batch, head and sequence strides given in elements.
// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o alike).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int Hkv, int Sq, int Skv, int D, int causal, int window, float scale,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long o_sb, long long o_sh, long long o_ss,
    int dtype, void* stream) {
  if (B == 0 || H == 0 || Sq == 0) return (int)cudaGetLastError();
  if (Hkv <= 0 || H % Hkv != 0 || B > 65535 || H > 65535 || window < 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.H = H; p.G = H / Hkv; p.Sq = Sq; p.Skv = Skv;
  p.causal = causal; p.window = window; p.scale = scale;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return (int)launch_f32(p, B, D, s);
  if (dtype == 1) return (int)launch_bf16(p, B, D, s);
  return (int)cudaErrorInvalidValue;
}
