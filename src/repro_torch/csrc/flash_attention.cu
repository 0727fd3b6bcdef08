// Flash attention forward: causal / sliding-window / bidirectional GQA
// attention over a whole prompt, with an online softmax over K/V tiles.
//
// Replaces src/repro/kernels/flash_attention/kernel.py:86
// flash_attention_fwd (_flash_kernel), and computes the function of its
// plain version, src/repro_torch/kernels/flash_attention/ref.py: q is
// scaled in f32 before QK^T; query i sits at position i + Skv - Sq (the
// ends are aligned); a key is seen when k_pos < Skv, k_pos <= q_pos
// (causal) and k_pos > q_pos - window (window > 0); query head h reads
// kv head h / G; m, l and acc are f32, p is 0 where the mask is false,
// and the output acc / max(l, 1e-30) is cast to q's dtype, so a row that
// sees no key gives 0.
//
// Bound: operations.  The function needs 4 * D operations per visible
// (query, key) pair against one read of q, k, v and one write of o; at
// the model's shapes that is far above the H100's 295 operations per
// byte.  Both paths skip the K/V tiles that lie wholly outside the
// causal and window band (the TPU kernel's lo / hi), so a sliding-window
// layer pays for its band only.  Strides are 64-bit: at the prefill
// shapes B * H * S * D passes 2^31.  Built without -fmad=false
// (kernels/build.py): it is held to a tolerance, not to bitwise
// equality, and fused multiply-adds double the f32 rate.
//
// - f32 (flash_attention_kernel): one block per (b, h, 64-row query tile)
//   keeps its q tile (scaled, f32) in shared memory and walks the 64-row
//   K/V tiles of its band, staged in shared memory as f32.  Its 256
//   threads form 16 row groups of 16 lanes: each thread holds 4 query
//   rows x 4 key columns of the score tile and 4 rows x D/16 columns of
//   the output accumulator in registers; the row max and sum are reduced
//   across a row group's 16 lanes with shuffles, and the probabilities go
//   through shared memory to the P.V product, all on the CUDA cores.
// - bf16 (wg::flash_attention_wg_kernel): TMA, wgmma and warp
//   specialisation; see namespace wg.
#include <cstdint>
#include <cuda.h>
#include <cudaTypedefs.h>
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
// bf16: TMA-fed K/V ring, wgmma, a producer and two consumer warpgroups
// ---------------------------------------------------------------------- //
// Bound: operations on the tensor cores.  P.V keeps f32 accuracy by
// splitting each probability into a bf16 head and the bf16 of its
// remainder, two products against the exact bf16 V (one bf16 P fails
// the bf16 gate, ref.py::BF16_EXCESS_TOL), so the kernel does 6 * D
// operations per visible pair against the function's 4 * D: its floor
// is 1.5x the bound.
//
// One block per (h, b, 128-row query tile), the grid's slowest dimension
// the query tile, late (heavy, causal) tiles first.  384 threads:
// - warpgroup 0, the producer, gives up registers (setmaxnreg 24); one
//   thread loads the block's q tile once and then the K/V tiles of its
//   band into a ring of kStages stages with TMA (cp.async.bulk.tensor,
//   4-D maps (D, S, heads, B) on the caller's strides, so the model's
//   transposed (B, S, H, D) views load without a copy; S is its own
//   dimension, so rows past Skv read zeros).  Each stage has a full
//   barrier (the TMA bytes arrive) and an empty one (both consumers
//   are done with it).  Loads of the next tile run while the consumers
//   compute on this one.
// - warpgroups 1 and 2, the consumers (setmaxnreg 240), own 64 query rows
//   each.  For a tile: S = Q K^T with wgmma m64n128k16 (q and K from
//   shared memory, K-major); scale by scale * log2(e), online softmax
//   in exp2 with m, l and O in f32; O += P V with wgmma m64nDk16, P from
//   registers (the S accumulator layout is the A fragment layout) and V
//   from shared memory as an MN-major operand (the transpose bit), two
//   products per 16-key step (head and remainder).  The two consumers
//   interleave on the SM, one's softmax beside the other's products.
// Each consumer sorts the tiles for its rows: those it cannot see it
// skips (it still waits for and releases the stage), those wholly inside
// the band need no mask, and only those that cross the causal diagonal,
// a window edge or the ragged end Skv are masked per element (the
// formulas of kernels/flash_attention/ops.py::tile_plan).  A masked
// score is -inf, so its p is exactly 0 (the TPU kernel's re-mask), and m
// starts at -1e30, so a row with no key yet has finite m and p = 0.
// The output goes back through the consumer's q rows in shared memory
// (same swizzled layout) and out with a TMA store in q's layout, rows
// past Sq clipped by the map.
//
// Against the five causes of the mma.sync design this replaced: loads
// overlap compute (the ring, the producer); occupancy stops mattering,
// 8 consumer warps per SM keep the tensor cores fed from shared memory
// that the TMA fills without registers; wgmma reaches the Hopper tensor
// rate; unmasked tiles skip the per-element mask; the output leaves as
// whole TMA boxes.
//
// Tiles: kBK = 128 keys, so a score tile is 64 x 128 f32 (64 registers a
// thread) and with D = 128 the O accumulator 64 more, within the 240 of
// a consumer; 2 stages of K and V (64 KB a stage at D = 128) and the q
// tile (32 KB) leave the block at 160 KB, one block per SM.  Swizzle by row
// width: 128 B for D >= 64 (a D = 128 row loads as two 64-column boxes),
// 64 B for D = 32, 32 B for D = 16; the wgmma descriptors name the same
// mode, with 8 rows (one swizzle atom) between core-matrix groups.
namespace wg {

constexpr int kBQ = 128;        // query rows per block, 64 per consumer
constexpr int kBK = 128;        // keys per K/V tile
constexpr int kStages = 2;      // K/V ring depth
constexpr int kThreads = 384;   // producer + two consumer warpgroups
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  int G, Sq, Skv, causal, window;
  float scale_log2;  // scale * log2(e)
};

// Shared memory for head dim D, in bytes from a 1024-aligned base: the
// q tile, kStages K and V tiles, each as boxes of [rows][kRowBytes]
// swizzled rows; then the barriers q, full[kStages], empty[kStages].
template <int D>
struct Tile {
  static constexpr int kRowBytes = D * 2 < 128 ? D * 2 : 128;
  static constexpr int kBoxes = D * 2 / kRowBytes;   // 2 at D = 128
  static constexpr int kBoxCols = kRowBytes / 2;
  static constexpr uint32_t kSwz = kRowBytes / 16 - 1;   // 7, 3, 1
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1
                                      : kRowBytes == 64 ? 2 : 3;
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kKVBytes = kBK * D * 2;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kBar = kV + kStages * kKVBytes;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// until the barrier's phase of this parity has completed
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n"
      :: "r"(bar), "r"(parity) : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accumulator registers across a wgmma's
// launch and its wait
template <int N>
__device__ __forceinline__ void pin(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma shared-memory descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle mode; the stride offset is one
// 8-row swizzle atom, the leading one only matters for V at D = 128
// (the next 64-column box)
template <int D>
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo) {
  using T = Tile<D>;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((8 * T::kRowBytes) >> 4) << 32 |
         T::kLayout << 62;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// two f32 as a bf16x2 A-fragment register (the first in the low half),
// and in `rest` the bf16x2 of what rounding left over
__device__ __forceinline__ uint32_t pack(float a, float b, uint32_t& rest) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 r = __floats2bfloat162_rn(
      a - __low2float(x), b - __high2float(x));
  rest = *reinterpret_cast<const uint32_t*>(&r);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// The K tiles that query rows [r0, r1) can see, [lo, hi), and whether a
// tile needs no per-element mask: ops.py::tile_plan's formulas.
__device__ __forceinline__ void tile_range(const Args& a, int r0, int r1,
                                           int& lo, int& hi) {
  const int off = a.Skv - a.Sq;
  const int n_kt = (a.Skv + kBK - 1) / kBK;
  hi = n_kt;
  if (a.causal) {
    const int last = r1 - 1 + off;   // newest query's position
    hi = last < 0 ? 0 : min(n_kt, last / kBK + 1);
  }
  lo = 0;
  if (a.window > 0) {
    const int first = r0 + off - a.window + 1;   // oldest key row r0 sees
    lo = first <= 0 ? 0 : first / kBK;
  }
  lo = min(lo, hi);
}

__device__ __forceinline__ bool tile_unmasked(const Args& a, int r0, int r1,
                                              int kt) {
  const int off = a.Skv - a.Sq;
  const int k0 = kt * kBK;
  return k0 + kBK <= a.Skv && (!a.causal || k0 + kBK - 1 <= r0 + off) &&
         (a.window == 0 || k0 > r1 - 1 + off - a.window);
}

// S = Q K^T for one 16-deep k step: m64n128k16, A and B from shared
// memory (both K-major), f32 accumulators; scale_d 0 starts from zero
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
      "%62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// O += P V for one 16-key step: m64nDk16, P (A) from registers, V (B)
// from shared memory MN-major (the transpose bit)
template <int N> __device__ void wgmma_rs(float* d, const uint32_t* a,
                                          uint64_t db);
template <>
__device__ __forceinline__ void wgmma_rs<16>(float* d, const uint32_t* a,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float* d, const uint32_t* a,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      "%26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t* a,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
      "%62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int D>
__device__ __forceinline__ void consume(const Args& a,
                                       const CUtensorMap* map_o,
                                       uint32_t base, int q0, int h, int b,
                                       int lo, int hi) {
  using T = Tile<D>;
  constexpr int kRB = T::kRowBytes;
  constexpr int kO = D / 2;   // O accumulator registers a thread
  const int c = threadIdx.x / 128 - 1;        // consumer 0 or 1
  const int t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  const int g = lane / 4, tq = lane % 4;      // fragment row, column pair
  const uint32_t bar_q = base + T::kBar;
  const int r0 = q0 + 64 * c, r1 = min(r0 + 64, a.Sq);
  int lo_c = 0, hi_c = 0;                     // this consumer's band
  if (r0 < a.Sq) tile_range(a, r0, r1, lo_c, hi_c);
  // positions of this thread's two rows: qpos, qpos + 8
  const int qpos = r0 + (a.Skv - a.Sq) + 16 * warp + g;
  const uint32_t sq = base + T::kQ + 64 * c * kRB;

  float o[kO];
#pragma unroll
  for (int i = 0; i < kO; ++i) o[i] = 0.f;
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};
  bar_wait(bar_q, 0);

  for (int kt = lo, i = 0; kt < hi; ++kt, ++i) {
    const int s = i % kStages;
    bar_wait(bar_q + 8 * (1 + s), (i / kStages) & 1);
    if (kt >= lo_c && kt < hi_c) {
      // S = Q K^T: element 4 j + 2 r + e is row qpos + 8 r, key
      // kt * kBK + 8 j + 2 tq + e
      float sc[64];
#pragma unroll
      for (int j = 0; j < 64; ++j) sc[j] = 0.f;
      const uint32_t sk = base + T::kK + s * T::kKVBytes;
      wg_fence();
      pin<64>(sc);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int box = kk * 32 / kRB, col = kk * 32 % kRB;
        wgmma_ss_n128(sc, desc<D>(sq + box * kBQ * kRB + col, 16),
                      desc<D>(sk + box * kBK * kRB + col, 16), kk > 0);
      }
      wg_commit();
      pin<64>(sc);
      wg_wait0();
      pin<64>(sc);

#pragma unroll
      for (int j = 0; j < 64; ++j) sc[j] *= a.scale_log2;
      if (!tile_unmasked(a, r0, r1, kt)) {
#pragma unroll
        for (int j = 0; j < 64; ++j) {
          const int k = kt * kBK + 8 * (j / 4) + 2 * tq + (j & 1);
          const int qp = qpos + 8 * ((j / 2) & 1);
          const bool ok = k < a.Skv && (!a.causal || k <= qp) &&
                          (a.window == 0 || k > qp - a.window);
          if (!ok) sc[j] = __int_as_float(0xff800000);   // -inf
        }
      }
      // online softmax in exp2; a row's 4 lanes form a quad
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m[r];
#pragma unroll
        for (int j = 0; j < 16; ++j)
          mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        corr[r] = ex2(m[r] - mx);
        m[r] = mx;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = ex2(sc[4 * j + 2 * r + e] - mx);
            sc[4 * j + 2 * r + e] = p;
            sum += p;
          }
        l[r] = l[r] * corr[r] + sum;   // this thread's share of the row
      }
#pragma unroll
      for (int j = 0; j < kO / 4; ++j) {
        o[4 * j] *= corr[0];
        o[4 * j + 1] *= corr[0];
        o[4 * j + 2] *= corr[1];
        o[4 * j + 3] *= corr[1];
      }

      // O += P V, 16 keys a step: head and remainder of P
      uint32_t ph[kBK / 16][4], pr[kBK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const float* x = sc + 8 * kk;
        ph[kk][0] = pack(x[0], x[1], pr[kk][0]);
        ph[kk][1] = pack(x[2], x[3], pr[kk][1]);
        ph[kk][2] = pack(x[4], x[5], pr[kk][2]);
        ph[kk][3] = pack(x[6], x[7], pr[kk][3]);
      }
      const uint32_t sv = base + T::kV + s * T::kKVBytes;
      wg_fence();
      pin<kO>(o);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t dv = desc<D>(sv + kk * 16 * kRB, kBK * kRB);
        wgmma_rs<D>(o, ph[kk], dv);
        wgmma_rs<D>(o, pr[kk], dv);
      }
      wg_commit();
      pin<kO>(o);
      wg_wait0();
      pin<kO>(o);
    }
    __syncwarp();
    if (lane == 0) bar_arrive(bar_q + 8 * (1 + kStages + s));
  }

  // O / max(l, 1e-30) as bf16 into this consumer's q rows (their last
  // reader, the final S product, has completed), then one TMA store
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int j = 0; j < kO / 4; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 64 * c + 16 * warp + g + 8 * r;
      const int byte = (8 * j + 2 * tq) * 2;
      uint32_t off = (byte / kRB) * kBQ * kRB + row * kRB + byte % kRB;
      off ^= ((off >> 7) & T::kSwz) << 4;
      const __nv_bfloat162 x = __floats2bfloat162_rn(
          o[4 * j + 2 * r] * inv[r], o[4 * j + 2 * r + 1] * inv[r]);
      asm volatile("st.shared.b32 [%0], %1;\n"
                   :: "r"(base + T::kQ + off),
                      "r"(*reinterpret_cast<const uint32_t*>(&x))
                   : "memory");
    }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + c) : "memory");
  if (t == 0 && r0 < a.Sq) {
#pragma unroll
    for (int box = 0; box < T::kBoxes; ++box)
      tma_store(map_o, sq + box * kBQ * kRB, box * T::kBoxCols, r0, h, b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_wg_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const __grid_constant__ CUtensorMap map_o,
                          const Args a) {
  using T = Tile<D>;
  constexpr int kRB = T::kRowBytes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = base + T::kBar;   // then full[], empty[]
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;  // heavy tiles first
  int lo, hi;
  tile_range(a, q0, min(q0 + kBQ, a.Sq), lo, hi);

  if (threadIdx.x == 0) {
    bar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      bar_init(bar_q + 8 * (1 + s), 1);              // the producer's
      bar_init(bar_q + 8 * (1 + kStages + s), 8);    // 8 consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      bar_expect_tx(bar_q, T::kQBytes);
      for (int c = 0; c < 2; ++c)
        for (int box = 0; box < T::kBoxes; ++box)
          tma_load(base + T::kQ + box * kBQ * kRB + 64 * c * kRB, &map_q,
                   bar_q, box * T::kBoxCols, q0 + 64 * c, h, b);
      const int hk = h / a.G;
      for (int kt = lo, i = 0; kt < hi; ++kt, ++i) {
        const int s = i % kStages;
        if (i >= kStages)
          bar_wait(bar_q + 8 * (1 + kStages + s), (i / kStages - 1) & 1);
        const uint32_t full = bar_q + 8 * (1 + s);
        bar_expect_tx(full, 2 * T::kKVBytes);
        for (int box = 0; box < T::kBoxes; ++box) {
          const uint32_t at = box * kBK * kRB + s * T::kKVBytes;
          tma_load(base + T::kK + at, &map_k, full, box * T::kBoxCols,
                   kt * kBK, hk, b);
          tma_load(base + T::kV + at, &map_v, full, box * T::kBoxCols,
                   kt * kBK, hk, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    consume<D>(a, &map_o, base, q0, h, b, lo, hi);
  }
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry
// points, so the library links without -lcuda
PFN_cuTensorMapEncodeTiled encode_tiled() {
  static PFN_cuTensorMapEncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled>(p);
  }
  return fn;
}

// A 4-D bf16 map (D, S, heads, B) over strides given in elements, box
// (box_cols, box_rows, 1, 1).  A dimension of extent 1 may carry any
// stride in PyTorch; TMA takes a multiple of 16 bytes, so it gets one.
bool make_map(CUtensorMap* map, const void* ptr, int D, int S, int heads,
              int B, long long ss, long long sh, long long sb, int box_cols,
              int box_rows, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S,
                              (cuuint64_t)heads, (cuuint64_t)B};
  cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                           (cuuint64_t)sb * 2};
  cuuint64_t span = (cuuint64_t)D * 2;   // bytes below this dimension
  for (int i = 0; i < 3; ++i) {
    if (dims[i + 1] == 1) strides[i] = (span + 15) / 16 * 16;
    span = strides[i] * dims[i + 1];
  }
  const cuuint32_t box[4] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1,
                             1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  using T = Tile<D>;
  const int n_qt = (p.Sq + kBQ - 1) / kBQ;
  if (n_qt > 65535 || B > 65535) return cudaErrorInvalidValue;
  if (encode_tiled() == nullptr) return cudaErrorNotSupported;
  const CUtensorMapSwizzle swz = T::kRowBytes == 128
                                     ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : T::kRowBytes == 64
                                     ? CU_TENSOR_MAP_SWIZZLE_64B
                                     : CU_TENSOR_MAP_SWIZZLE_32B;
  const int Hkv = p.H / p.G;
  CUtensorMap mq, mk, mv, mo;
  if (!make_map(&mq, p.q, D, p.Sq, p.H, B, p.q_ss, p.q_sh, p.q_sb,
                T::kBoxCols, 64, swz) ||
      !make_map(&mo, p.o, D, p.Sq, p.H, B, p.o_ss, p.o_sh, p.o_sb,
                T::kBoxCols, 64, swz))
    return cudaErrorInvalidValue;   // misaligned base or strides
  if (p.Skv == 0) {
    mk = mv = mq;   // no K tile to load: every row gives 0
  } else if (!make_map(&mk, p.k, D, p.Skv, Hkv, B, p.k_ss, p.k_sh, p.k_sb,
                       T::kBoxCols, kBK, swz) ||
             !make_map(&mv, p.v, D, p.Skv, Hkv, B, p.v_ss, p.v_sh, p.v_sb,
                       T::kBoxCols, kBK, swz)) {
    return cudaErrorInvalidValue;
  }
  const int smem = T::kBytes + 1024;   // + room to align the base
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_wg_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const Args a{p.G, p.Sq, p.Skv, p.causal, p.window, p.scale * kLog2e};
  const dim3 grid(p.H, B, n_qt);
  flash_attention_wg_kernel<D><<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, mo, a);
  return cudaGetLastError();
}

}  // namespace wg

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
    case 16: return wg::launch<16>(p, B, stream);
    case 32: return wg::launch<32>(p, B, stream);
    case 64: return wg::launch<64>(p, B, stream);
    case 128: return wg::launch<128>(p, B, stream);
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
