// Decode attention: one query token per sequence against its KV cache,
// GQA, ragged lengths.
//
// Replaces src/repro/kernels/decode_attention/kernel.py
// decode_attention_fwd (_decode_kernel and its combine pass), and
// computes the function of its plain version,
// src/repro_torch/kernels/decode_attention/ref.py: query head h reads kv
// head h / G; keys at positions >= lengths[b] are masked; softmax and
// sums in float32; a lane of length 0 gives exactly 0; the output is
// cast to q's dtype.
//
// Bound: it reads each valid K and V row once (2 * len * D elements per
// (lane, kv head)) and does 2 * G operations per element, far below the
// card's operations per byte, so it is bound by bytes; at decode sizes (a
// few MB) the time is the latency of getting them in flight and of the
// arithmetic behind the last of them.
//
// Design: split-KV over the warps of one block per (kv head, lane), as
// the TPU kernel splits T over a grid axis.
//   - The grid is (Hkv, B).  A lane's positions below its length fall in
//     chunks of `rows`, dealt out in turn to the block's warps: chunk c to
//     warp c % warps.  So a short lane spreads over the warps as a long
//     one does (the lengths live on the card, and a plan by spans of T
//     left the warps past a short lane's end idle), and a long T only
//     gives each warp more chunks.  ops.py::split_plan picks warps and
//     rows (at the serve shape 4 warps, chunks of 16).
//   - Each warp stages its own chunks into shared memory with cp.async
//     (at most kWarpRows rows, one per lane below): 16-byte copies where
//     every base, stride and row is 16-byte aligned, else 8 or 4 bytes,
//     else 2-byte loads (the width comes from ops.py::load_width).  Its
//     first two chunks are issued before any arithmetic, so the second
//     lands while the first is computed, and each later chunk is issued
//     as the chunk two back is done (two stages).  q's loads go out
//     first; each warp keeps its own copy of q and waits only on its own
//     copies (__syncwarp), so no block barrier stands between a warp's
//     loads and its arithmetic.
//   - Per chunk, lane j computes the G scores of row j, reading q (as
//     f32) from shared memory at one address for the whole warp and its
//     row in 16-byte pieces (rows are padded by 16 bytes so that the 32
//     rows start in different banks); the online softmax is a max and a
//     sum over the lanes; then lane j accumulates columns [4 j, 4 j + 4)
//     of acc = sum_r p[r] V[r] in registers, taking each p[r] from lane r
//     by shuffle.  Each operation runs once per row and column, not once
//     per lane of a row.
//   - Combine without a second launch: the warps of the block merge
//     through shared memory, in warp order, and the merge is the output.
//     The result is the same from call to call (no atomics).
//   - Not kept (measured on the card, PERF.md): the blocks of a
//     thread-block cluster per (kv head, lane), merged through
//     distributed shared memory (slower than one block at the serve
//     shape with 2, 4 or 8 blocks: the cluster barriers and the larger
//     grid cost more than the split saves, and no caller's cache is
//     long enough to gain); contiguous spans of T per warp (a short lane
//     left most warps idle, and a serve step's lanes are short); 16
//     lanes a row with an online-softmax update per row (twice the
//     instructions); the products on the tensor cores (mma.sync: little
//     gain, the arithmetic waiting on the loads).
//
// Accuracy: expf, not __expf; fused multiply-adds (kernels/build.py
// builds this source without -fmad=false), which round once where a
// multiply and an add round twice.  The kernel is held to 1e-5 in f32
// and 2e-2 in bf16 of its plain version.
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxWarps = 8;
constexpr int kWarpRows = 32;    // rows of K (and of V) in a warp's stage
constexpr int kStages = 2;       // a warp's stages, both in flight at once
constexpr int kMaxD = 128;       // head dim
constexpr int kVecs = kMaxD / 4; // 4-column items of a query row
// dynamic shared memory a block may hold: its 227 KB less the static
// arrays (m and l of every warp at G = 16)
constexpr int kMaxSmem = 232448 - 2 * kMaxWarps * 16 * 4;

struct Params {
  const void* q;
  const char* k;
  const char* v;
  const int* lengths;
  void* out;
  int G, H, T, D;
  int width;     // bytes per global -> shared copy: 16, 8, 4 or 2
  int pitch;     // bytes of one staged row: D * sizeof(T) rounded to 16,
                 // plus 16 * lpr, so that the rows the lanes of a
                 // quarter warp read start in different banks
  int rows;      // rows of a chunk, one stage of a warp
  int lpr;       // lanes a row in the score pass: lpr * rows <= 32
  long long q_sb, q_sh, k_sb, k_sh, k_st, v_sb, v_sh, v_st;  // elements
  float scale;
};

__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// 16 bytes of a staged row as f32: four f32, or eight bf16 (a bf16's f32
// value is its bits shifted up by 16)
__device__ __forceinline__ void load16(const uint8_t* p, float* x, float) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
}
__device__ __forceinline__ void load16(const uint8_t* p, float* x,
                                       __nv_bfloat16) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    x[2 * j] = __uint_as_float(w[j] << 16);
    x[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}
// four consecutive elements of a staged row as f32
__device__ __forceinline__ void load4(const uint8_t* p, float* x, float) {
  load16(p, x, 0.f);
}
__device__ __forceinline__ void load4(const uint8_t* p, float* x,
                                      __nv_bfloat16) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  x[0] = __uint_as_float(t.x << 16);
  x[1] = __uint_as_float(t.x & 0xffff0000u);
  x[2] = __uint_as_float(t.y << 16);
  x[3] = __uint_as_float(t.y & 0xffff0000u);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// one global -> shared copy of `width` bytes
__device__ __forceinline__ void copy(uint8_t* dst, const char* src,
                                     int width) {
  const uint32_t d = smem_u32(dst);
  if (width == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(d), "l"(src) : "memory");
  else if (width == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                 :: "r"(d), "l"(src) : "memory");
  else if (width == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(d), "l"(src) : "memory");
  else
    *reinterpret_cast<uint16_t*>(dst) =
        *reinterpret_cast<const uint16_t*>(src);
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// Dynamic shared memory: each warp's kStages stages of K rows then V
// rows, each row `pitch` bytes; the warps' partial accumulators (f32,
// kMaxD a query row); each warp's copy of q (f32, g_max rows of kMaxD).
__host__ __device__ __forceinline__ int g_max_of(int G) {
  return G <= 2 ? 2 : G <= 4 ? 4 : G <= 8 ? 8 : 16;
}
__host__ __device__ __forceinline__ int stage_bytes(const Params& p) {
  return 2 * p.rows * p.pitch;
}
__host__ __device__ __forceinline__ int partial_offset(const Params& p,
                                                       int warps) {
  return warps * kStages * stage_bytes(p);
}
__host__ __device__ __forceinline__ int q_offset(const Params& p,
                                                 int warps) {
  return partial_offset(p, warps) + warps * p.G * kMaxD * 4;
}
__host__ __device__ __forceinline__ int dynamic_smem(const Params& p,
                                                     int warps, int g_max) {
  return q_offset(p, warps) + warps * g_max * kMaxD * 4;
}

// G_MAX >= the block's G query rows.
template <typename T, int G_MAX>
__global__ void __launch_bounds__(kMaxWarps * 32)
decode_attention_kernel(const Params p) {
  constexpr int kN = 16 / sizeof(T);   // elements in 16 bytes
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float s_wm[kMaxWarps][G_MAX], s_wl[kMaxWarps][G_MAX];

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int warps = blockDim.x / 32;
  const int G = p.G, D = p.D;
  const int row_bytes = D * (int)sizeof(T);
  const int pieces = (row_bytes + 15) / 16;   // 16-byte pieces of a row
  const int row = lane / p.lpr, part = lane % p.lpr;  // of the score pass
  // q's loads go out first, beside the length's, ahead of K and V
  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb;
  float qv[G_MAX * kMaxD / 32];
#pragma unroll
  for (int j = 0; j < G_MAX * kMaxD / 32; ++j) {
    const int g = (lane + 32 * j) / kMaxD, d = (lane + 32 * j) % kMaxD;
    qv[j] = (g < G && d < D)
                ? (float)qb[(long long)(h * G + g) * p.q_sh + d]
                : 0.f;
  }
  int len = p.lengths[b];
  len = len < 0 ? 0 : (len > p.T ? p.T : len);
  // the lane's chunks of `rows` positions, dealt out in turn to the
  // warps: chunk first + stride * c is this warp's c-th
  const int first = warp, stride = warps;
  const int chunks = (len + p.rows - 1) / p.rows;
  const int n_chunks = chunks > first ? (chunks - first - 1) / stride + 1
                                      : 0;
  const char* kb = p.k + (b * p.k_sb + h * p.k_sh) * (long long)sizeof(T);
  const char* vb = p.v + (b * p.v_sb + h * p.v_sh) * (long long)sizeof(T);
  const long long k_row = p.k_st * (long long)sizeof(T);
  const long long v_row = p.v_st * (long long)sizeof(T);
  uint8_t* wsm = smem + warp * kStages * stage_bytes(p);
  float* w_q = reinterpret_cast<float*>(smem + q_offset(p, warps)) +
               warp * G_MAX * kMaxD;

  // all of chunk c's K and V rows of this warp, in flight before any
  // arithmetic; lane l copies pieces l, l + 32, ... of the chunk's rows,
  // walked without a division per piece
  const int per_row = row_bytes / p.width;
  const int dr = 32 / per_row, dc = 32 % per_row;
  auto issue = [&](int c) {
    const int r0 = (first + stride * c) * p.rows;
    const int n = min(p.rows, len - r0);
    uint8_t* ks = wsm + (c % kStages) * stage_bytes(p);
    uint8_t* vs = ks + p.rows * p.pitch;
    int r = lane / per_row, col = lane % per_row;
    while (r < n) {
      const int off = col * p.width;
      copy(ks + r * p.pitch + off, kb + (r0 + r) * k_row + off, p.width);
      copy(vs + r * p.pitch + off, vb + (r0 + r) * v_row + off, p.width);
      r += dr;
      col += dc;
      if (col >= per_row) {
        col -= per_row;
        ++r;
      }
    }
    copy_commit();
  };
  if (n_chunks > 0) issue(0);

  // each warp's own copy of q as f32, zero past D and G, so that no block
  // barrier stands between a warp's loads and its arithmetic; the bytes
  // of a staged row's last 16-byte piece past D are zeroed once and
  // never copied into
#pragma unroll
  for (int j = 0; j < G_MAX * kMaxD / 32; ++j) w_q[lane + 32 * j] = qv[j];
  if (row_bytes % 16) {
    const int pad = 16 - row_bytes % 16;
    for (int i = lane; i < kStages * 2 * p.rows * pad; i += 32)
      wsm[(i / pad) * p.pitch + row_bytes + i % pad] = 0;
  }
  __syncwarp();

  // the warp's running (m, l) and acc = sum p V per query row; every
  // query row up to G_MAX is computed (rows past G have q = 0), so no
  // branch on G stops the loops from unrolling
  float m[G_MAX], l[G_MAX], acc[G_MAX][4];
#pragma unroll
  for (int g = 0; g < G_MAX; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[g][e] = 0.f;
  }

  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) {
      issue(c + 1);
      copy_wait<1>();
    } else {
      copy_wait<0>();
    }
    __syncwarp();
    const int n = min(p.rows, len - (first + stride * c) * p.rows);
    const uint8_t* ks = wsm + (c % kStages) * stage_bytes(p);
    const uint8_t* vs = ks + p.rows * p.pitch;

    // scores: the lpr lanes of row `row` take its 16-byte pieces part,
    // part + lpr, ..., reading q at one address for each part
    float s[G_MAX][2];
#pragma unroll
    for (int g = 0; g < G_MAX; ++g) s[g][0] = s[g][1] = 0.f;
    if (row < n) {
      const uint8_t* kr = ks + row * p.pitch;
#pragma unroll 2
      for (int c16 = part; c16 < pieces; c16 += p.lpr) {
        float kx[kN];
        load16(kr + 16 * c16, kx, T(0.f));
#pragma unroll
        for (int g = 0; g < G_MAX; ++g) {
          const float* qg = w_q + g * kMaxD + c16 * kN;
#pragma unroll
          for (int e = 0; e < kN; e += 4) {
            const float4 qv4 = *reinterpret_cast<const float4*>(qg + e);
            float& acc_s = s[g][(e / 4) % 2];
            acc_s += qv4.x * kx[e];
            acc_s += qv4.y * kx[e + 1];
            acc_s += qv4.z * kx[e + 2];
            acc_s += qv4.w * kx[e + 3];
          }
        }
      }
    }

    // online softmax over the warp's rows (a row's lpr lanes hold its
    // score; one of them counts in the sum), then acc[g][4 lane .. + 3] =
    // acc * corr + sum_r p[g][r] V[r], p[g][r] from row r's first lane
    float pr[G_MAX];
#pragma unroll
    for (int g = 0; g < G_MAX; ++g) {
      float sc = s[g][0] + s[g][1];
      for (int off = p.lpr / 2; off > 0; off >>= 1)
        sc += __shfl_xor_sync(0xffffffffu, sc, off);
      sc = row < n ? sc * p.scale : -INFINITY;
      const float m_new = fmaxf(m[g], warp_max(sc));
      const float corr = expf(m[g] - m_new);   // 0 on the first chunk
      pr[g] = row < n ? expf(sc - m_new) : 0.f;
      l[g] = l[g] * corr + warp_sum(part == 0 ? pr[g] : 0.f);
      m[g] = m_new;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][e] *= corr;
    }
    const bool cols = 4 * lane * (int)sizeof(T) < row_bytes;
#pragma unroll 4
    for (int r = 0; r < n; ++r) {
      float vx[4] = {0.f, 0.f, 0.f, 0.f};
      if (cols) load4(vs + r * p.pitch + 4 * lane * sizeof(T), vx, T(0.f));
#pragma unroll
      for (int g = 0; g < G_MAX; ++g) {
        const float w = __shfl_sync(0xffffffffu, pr[g], r * p.lpr);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[g][e] += w * vx[e];
      }
    }
    __syncwarp();   // the stage is free for the chunk after next
  }

  // the warp's part: (m, l) and its 4 columns of acc
  float* w_acc = reinterpret_cast<float*>(smem + partial_offset(p, warps));
#pragma unroll
  for (int g = 0; g < G_MAX; ++g) {
    if (g >= G) break;
    if (lane == 0) {
      s_wm[warp][g] = m[g];
      s_wl[warp][g] = l[g];
    }
    *reinterpret_cast<float4*>(&w_acc[(warp * G + g) * kMaxD + 4 * lane]) =
        make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
  }
  __syncthreads();

  // merge the warps per (query row, 4 columns) item, in warp order; a
  // warp that saw no row (l = 0) drops out, and a lane of length 0
  // (every l = 0) gives exactly 0
  T* o = static_cast<T*>(p.out) + ((long long)b * p.H + (long long)h * G) * D;
  for (int item = tid; item < G * kVecs; item += blockDim.x) {
    const int g = item / kVecs, d = 4 * (item % kVecs);
    float mx = -INFINITY;
    for (int w = 0; w < warps; ++w)
      if (s_wl[w][g] > 0.f) mx = fmaxf(mx, s_wm[w][g]);
    float den = 0.f;
    float num[4] = {0.f, 0.f, 0.f, 0.f};
    for (int w = 0; w < warps; ++w) {
      const float lw = s_wl[w][g];
      if (lw > 0.f) {
        const float c = expf(s_wm[w][g] - mx);
        const float4 a =
            *reinterpret_cast<const float4*>(&w_acc[(w * G + g) * kMaxD + d]);
        den += lw * c;
        num[0] += a.x * c; num[1] += a.y * c;
        num[2] += a.z * c; num[3] += a.w * c;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (d + j < D)
        store_f32(o + g * D + d + j, den > 0.f ? num[j] / den : 0.f);
  }
}

// dynamic shared memory set per kernel instance: raised when a launch
// needs more than the last size set, or runs on another device (the
// attribute is the device's)
template <typename T, int G_MAX>
cudaError_t launch_g(const Params& p, int warps, int B, int Hkv,
                     cudaStream_t stream) {
  static int set_dev = -1, set_smem = 0;
  auto kernel = decode_attention_kernel<T, G_MAX>;
  const int smem = dynamic_smem(p, warps, G_MAX);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (smem > 48 * 1024 && (dev != set_dev || smem > set_smem)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    set_dev = dev;
    set_smem = smem;
  }
  kernel<<<dim3(Hkv, B), 32 * warps, smem, stream>>>(p);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_t(const Params& p, int warps, int B, int Hkv,
                     cudaStream_t stream) {
  if (p.G <= 2) return launch_g<T, 2>(p, warps, B, Hkv, stream);
  if (p.G <= 4) return launch_g<T, 4>(p, warps, B, Hkv, stream);
  if (p.G <= 8) return launch_g<T, 8>(p, warps, B, Hkv, stream);
  if (p.G <= 16) return launch_g<T, 16>(p, warps, B, Hkv, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q (B, H, D), k/v (B, Hkv, T, D) with the head dim dense and the other
// strides given in elements; lengths (B,) int32; out (B, H, D) dense.
// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out alike).  warps (1
// to 8 a block) and rows (the positions of a chunk; fewer where shared
// memory would not hold two stages of them for every warp) from
// ops.py::split_plan;
// width (bytes per copy of K and V into shared memory: 16, 8, 4, or 2
// for bf16) from ops.py::load_width, which it must divide: the bases of
// k and v, their strides in bytes and D * sizeof(T).
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* lengths,
    void* out, int B, int H, int Hkv, int T, int D, long long q_sb,
    long long q_sh, long long k_sb, long long k_sh, long long k_st,
    long long v_sb, long long v_sh, long long v_st, float scale, int dtype,
    int warps, int rows, int width, void* stream) {
  if (B == 0 || Hkv == 0 || D == 0) return (int)cudaGetLastError();
  const int es = dtype == 0 ? 4 : 2;
  const long long ws[] = {(long long)(uintptr_t)k, (long long)(uintptr_t)v,
                          k_sb * es, k_sh * es, k_st * es, v_sb * es,
                          v_sh * es, v_st * es, (long long)D * es};
  bool aligned = width == 16 || width == 8 || width == 4 ||
                 (width == 2 && es == 2);
  for (long long x : ws) aligned = aligned && x % width == 0;
  if (H % Hkv != 0 || D > kMaxD || (dtype != 0 && dtype != 1) ||
      warps < 1 || warps > kMaxWarps || rows < 1 || rows > kWarpRows ||
      !aligned)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = static_cast<const char*>(k);
  p.v = static_cast<const char*>(v);
  p.lengths = static_cast<const int*>(lengths);
  p.out = out;
  p.G = H / Hkv;
  p.H = H;
  p.T = T;
  p.D = D;
  p.width = width;
  p.lpr = 1;
  while (2 * p.lpr * rows <= kWarpRows) p.lpr *= 2;
  p.pitch = (D * es + 15) / 16 * 16 + 16 * p.lpr;
  // two stages of `rows` rows for every warp, fewer rows where the
  // block's shared memory would not hold them
  p.rows = 0;
  const int fixed = dynamic_smem(p, warps, g_max_of(p.G));
  const int per_row = warps * kStages * 2 * p.pitch;  // K and V rows
  p.rows = min(rows, (kMaxSmem - fixed) / per_row);
  if (p.rows < 1) return (int)cudaErrorInvalidValue;
  p.q_sb = q_sb; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_st = k_st;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_st = v_st;
  p.scale = scale;
  cudaError_t err =
      dtype == 0 ? launch_t<float>(p, warps, B, Hkv, (cudaStream_t)stream)
                 : launch_t<__nv_bfloat16>(p, warps, B, Hkv,
                                           (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
