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
// (lane, kv head)) and a few FLOPs per element, so it is bound by bytes.
// Design: one block per (kv head, lane) holds the G query rows of that kv
// head in registers; its four warps stride over the valid positions, so
// each K/V row is read once, by one warp, as coalesced loads (element d
// of a row lives in lane d % 32).  Each warp keeps an online softmax per
// query row (running max m, sum of exponentials l, weighted V sum acc);
// a second pass in the block combines the four warps' partials through
// shared memory.  Unlike the TPU kernel, T needs no chunk multiple: the
// loop runs to the lane's own length.
//
// Accuracy: expf, not __expf.  The library is built with -fmad=false,
// which keeps the compiler from contracting our own a*b + c: each step
// of a dot product and each update of acc is a rounded multiply and a
// rounded add, about twice the floating-point instructions of the fused
// form.  expf is written with explicit fmaf in CUDA's math library, so
// it keeps its fused steps and its 2-ulp bound; __expf is a multiply and
// ex2.approx, whose error grows with |x|.  The kernel is bound by bytes,
// so neither choice moves its time much.
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// G_MAX >= the block's G query rows; DPL = head-dim elements per lane
// (D <= 32 * DPL).  Unrolled loops over both keep the arrays in registers.
template <typename T, int G_MAX, int DPL>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ lengths, T* __restrict__ out,
                        int G, int H, int T_len, int D, long long q_sb,
                        long long q_sh, long long k_sb, long long k_sh,
                        long long k_st, long long v_sb, long long v_sh,
                        long long v_st, float scale) {
  __shared__ float s_m[kWarps][G_MAX];
  __shared__ float s_l[kWarps][G_MAX];
  __shared__ float s_acc[kWarps][G_MAX][DPL * 32];

  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int len = lengths[b];
  len = len < 0 ? 0 : (len > T_len ? T_len : len);
  T* o = out + ((long long)b * H + (long long)h * G) * D;
  if (len == 0) {
    for (int i = threadIdx.x; i < G * D; i += kThreads) store_f32(o + i, 0.f);
    return;
  }

  float qr[G_MAX][DPL], acc[G_MAX][DPL], m[G_MAX], l[G_MAX];
#pragma unroll
  for (int g = 0; g < G_MAX; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int d = j * 32 + lane;
      qr[g][j] = (g < G && d < D)
                     ? load_f32(q + b * q_sb + (long long)(h * G + g) * q_sh + d)
                     : 0.f;
      acc[g][j] = 0.f;
    }
  }

  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  for (int t = warp; t < len; t += kWarps) {
    float kr[DPL], vr[DPL];
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int d = j * 32 + lane;
      kr[j] = d < D ? load_f32(kb + t * k_st + d) : 0.f;
      vr[j] = d < D ? load_f32(vb + t * v_st + d) : 0.f;
    }
#pragma unroll
    for (int g = 0; g < G_MAX; ++g) {
      if (g >= G) break;
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < DPL; ++j) s += qr[g][j] * kr[j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      s *= scale;
      const float m_new = fmaxf(m[g], s);
      const float corr = expf(m[g] - m_new);  // 0 on a warp's first row
      const float p = expf(s - m_new);
      l[g] = l[g] * corr + p;
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[g][j] = acc[g][j] * corr + p * vr[j];
      m[g] = m_new;
    }
  }

#pragma unroll
  for (int g = 0; g < G_MAX; ++g) {
    if (lane == 0) {
      s_m[warp][g] = m[g];
      s_l[warp][g] = l[g];
    }
#pragma unroll
    for (int j = 0; j < DPL; ++j) s_acc[warp][g][j * 32 + lane] = acc[g][j];
  }
  __syncthreads();

  // combine: a warp that saw no row (len < kWarps) has l = 0 and drops
  // out; warp 0 always saw row 0, so the sum of weights is positive
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w][g]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (s_l[w][g] > 0.f) {
        const float c = expf(s_m[w][g] - mx);
        den += s_l[w][g] * c;
        num += s_acc[w][g][d] * c;
      }
    }
    store_f32(o + i, num / den);
  }
}

template <typename T, int G_MAX>
cudaError_t launch_g(dim3 grid, cudaStream_t stream, const void* q,
                     const void* k, const void* v, const int* lengths,
                     void* out, int G, int H, int T_len, int D,
                     const long long* st, float scale) {
  const int dpl = (D + 31) / 32;
#define REPRO_DA_LAUNCH(DPL)                                                  \
  decode_attention_kernel<T, G_MAX, DPL><<<grid, kThreads, 0, stream>>>(      \
      (const T*)q, (const T*)k, (const T*)v, lengths, (T*)out, G, H, T_len, D, \
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], scale)
  if (dpl <= 1) REPRO_DA_LAUNCH(1);
  else if (dpl <= 2) REPRO_DA_LAUNCH(2);
  else if (dpl <= 4) REPRO_DA_LAUNCH(4);
  else return cudaErrorInvalidValue;
#undef REPRO_DA_LAUNCH
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(dim3 grid, cudaStream_t stream, const void* q,
                     const void* k, const void* v, const int* lengths,
                     void* out, int G, int H, int T_len, int D,
                     const long long* st, float scale) {
  if (G <= 1) return launch_g<T, 1>(grid, stream, q, k, v, lengths, out, G, H, T_len, D, st, scale);
  if (G <= 2) return launch_g<T, 2>(grid, stream, q, k, v, lengths, out, G, H, T_len, D, st, scale);
  if (G <= 4) return launch_g<T, 4>(grid, stream, q, k, v, lengths, out, G, H, T_len, D, st, scale);
  if (G <= 8) return launch_g<T, 8>(grid, stream, q, k, v, lengths, out, G, H, T_len, D, st, scale);
  if (G <= 16) return launch_g<T, 16>(grid, stream, q, k, v, lengths, out, G, H, T_len, D, st, scale);
  return cudaErrorInvalidValue;
}

}  // namespace

// q (B, H, D), k/v (B, Hkv, T, D) with the head dim dense and the other
// strides given in elements; lengths (B,) int32; out (B, H, D) dense.
// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out alike).
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* lengths,
    void* out, int B, int H, int Hkv, int T, int D, long long q_sb,
    long long q_sh, long long k_sb, long long k_sh, long long k_st,
    long long v_sb, long long v_sh, long long v_st, float scale, int dtype,
    void* stream) {
  if (B == 0 || Hkv == 0 || D == 0) return (int)cudaGetLastError();
  if (H % Hkv != 0 || D > 128) return (int)cudaErrorInvalidValue;
  const long long st[8] = {q_sb, q_sh, k_sb, k_sh, k_st, v_sb, v_sh, v_st};
  const dim3 grid(Hkv, B);
  const int G = H / Hkv;
  cudaError_t err;
  if (dtype == 0)
    err = launch_t<float>(grid, (cudaStream_t)stream, q, k, v,
                          (const int*)lengths, out, G, H, T, D, st, scale);
  else if (dtype == 1)
    err = launch_t<__nv_bfloat16>(grid, (cudaStream_t)stream, q, k, v,
                                  (const int*)lengths, out, G, H, T, D, st,
                                  scale);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
