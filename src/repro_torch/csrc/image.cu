// The batched Atari observation path: Pong render, grayscale, crop,
// resize.  Every op is integer fixed point, a copy, or exact f32
// compares, so each kernel
// is bitwise equal to its plain version in
// src/repro_torch/kernels/image/ref.py.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// ------------------------------------------------------------------------
// pong_render — replaces src/repro/kernels/image/kernel.py
// pong_render_batch (_render_kernel).
//
// Bound: it reads 16 bytes per lane and writes 100,800 (210 x 160 x 3
// uint8), so it is bound by its writes: 103.2 MB at N = 1024.  Design:
// one thread per four output bytes, stored as one 32-bit word, so a warp
// writes 128 contiguous bytes; the four game scalars of the lane are
// read once per thread (every word lies within one screen, as
// 100,800 % 4 == 0).  The compares use explicitly rounded f32 products
// and differences (__fmul_rn/__fsub_rn), as the plain version rounds.
// ------------------------------------------------------------------------
constexpr int kH = 210, kW = 160;
constexpr int kScreenBytes = kH * kW * 3;
constexpr int kScreenWords = kScreenBytes / 4;
static_assert(kScreenBytes % 4 == 0, "screens must be whole words");

__constant__ uint8_t kPalette[4][3] = {
    {236, 236, 236},  // ball
    {92, 186, 92},    // player paddle
    {213, 130, 74},   // enemy paddle
    {144, 72, 17},    // background
};

__global__ void pong_render_kernel(const float* __restrict__ ball_x,
                                   const float* __restrict__ ball_y,
                                   const float* __restrict__ paddle_y,
                                   const float* __restrict__ enemy_y,
                                   uint32_t* __restrict__ out, long total) {
  const long word = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (word >= total) return;
  const int lane = (int)(word / kScreenWords);
  const int first = (int)(word % kScreenWords) * 4;

  const float sy = 2.5f;                            // f32(210 / 84)
  const float sx = (float)(160.0 / 84.0);           // f32(160 / 84)
  const float reach = __fmul_rn(6.0f, sy);          // paddle half-length
  const float player_x = __fsub_rn(160.0f, __fmul_rn(3.0f, sx));
  const float enemy_x = __fmul_rn(2.0f, sx);
  const float by = __fmul_rn(ball_y[lane], sy);
  const float bx = __fmul_rn(ball_x[lane], sx);
  const float py = __fmul_rn(paddle_y[lane], sy);
  const float ey = __fmul_rn(enemy_y[lane], sy);

  uint32_t packed = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int byte = first + k;
    const int pix = byte / 3, c = byte % 3;
    const float y = (float)(pix / kW), x = (float)(pix % kW);
    const bool ball = fabsf(__fsub_rn(y, by)) <= sy &&
                      fabsf(__fsub_rn(x, bx)) <= sx;
    const bool pad = fabsf(__fsub_rn(y, py)) <= reach && x >= player_x;
    const bool enemy = fabsf(__fsub_rn(y, ey)) <= reach && x <= enemy_x;
    const int which = ball ? 0 : pad ? 1 : enemy ? 2 : 3;
    packed |= (uint32_t)kPalette[which][c] << (8 * k);
  }
  out[word] = packed;
}

// ------------------------------------------------------------------------
// grayscale — replaces src/repro/kernels/image/kernel.py grayscale_batch
// (_grayscale_kernel).
//
// Bound: it reads 3 bytes and writes 1 per pixel (103.2 MB in, 34.4 MB
// out at N = 1024), so it is bound by bytes.  Design: one thread per
// pixel, neighbouring threads on neighbouring pixels, the luma in int32.
// ------------------------------------------------------------------------
__global__ void grayscale_kernel(const uint8_t* __restrict__ rgb,
                                 uint8_t* __restrict__ out, long n) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int r = rgb[3 * i], g = rgb[3 * i + 1], b = rgb[3 * i + 2];
  out[i] = (uint8_t)((9798 * r + 19235 * g + 3735 * b + (1 << 14)) >> 15);
}

// ------------------------------------------------------------------------
// resize — replaces src/repro/kernels/image/kernel.py resize_batch
// (_resize_kernel).
//
// Bound: it reads H*W bytes and writes out_h*out_w per image (34.4 MB in,
// 7.2 MB out at N = 1024, 210x160 -> 84x84); the arithmetic is a few
// integer multiply-adds per byte, so it is bound by bytes.  Design: one
// block per image.  The source image goes into shared memory (33.6 KB),
// the vertical pass writes an (out_h, W) intermediate that holds values
// <= 255 after rounding into shared memory as uint16 (26.9 KB), then the
// horizontal pass writes the output.  Each output row or column sums
// only its band of nonzero taps [lo, hi) of the dense weight table;
// integer accumulation is exact, so the order of the sum is free.
// ------------------------------------------------------------------------
__global__ void resize_kernel(const uint8_t* __restrict__ img,
                              const int* __restrict__ a,
                              const int* __restrict__ a_lo,
                              const int* __restrict__ a_hi,
                              const int* __restrict__ b,
                              const int* __restrict__ b_lo,
                              const int* __restrict__ b_hi,
                              uint8_t* __restrict__ out, int h, int w,
                              int out_h, int out_w) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* src = smem;
  uint16_t* mid = (uint16_t*)(smem + ((h * w + 15) / 16) * 16);
  const long image = blockIdx.x;
  const uint8_t* in = img + image * h * w;

  for (int i = threadIdx.x; i < h * w; i += blockDim.x) src[i] = in[i];
  __syncthreads();

  for (int i = threadIdx.x; i < out_h * w; i += blockDim.x) {
    const int o = i / w, x = i % w;
    const int* row = a + (long)o * h;
    int acc = 0;
    for (int k = a_lo[o]; k < a_hi[o]; ++k) acc += row[k] * src[k * w + x];
    mid[i] = (uint16_t)((acc + 128) >> 8);
  }
  __syncthreads();

  uint8_t* dst = out + image * out_h * out_w;
  for (int i = threadIdx.x; i < out_h * out_w; i += blockDim.x) {
    const int o = i / out_w, p = i % out_w;
    const int* row = b + (long)p * w;
    const uint16_t* t = mid + o * w;
    int acc = 0;
    for (int k = b_lo[p]; k < b_hi[p]; ++k) acc += row[k] * t[k];
    dst[i] = (uint8_t)((acc + 128) >> 8);
  }
}

// ------------------------------------------------------------------------
// crop — replaces src/repro/kernels/image/kernel.py crop_batch
// (_crop_kernel).
//
// Bound: a copy, it reads and writes height*width bytes per image
// (26.2 MB each way at N = 1024, 210x160 -> 160x160), so it is bound by
// bytes.  Design: one thread per output unit, neighbouring threads on
// neighbouring units of an output row.  The unit is a 32-bit word when
// the window's left edge and width, the input width and both base
// pointers are multiples of 4 bytes (the Pong window is), else a byte.
// ------------------------------------------------------------------------
template <typename U>
__global__ void crop_kernel(const U* __restrict__ in, U* __restrict__ out,
                            long total, int in_h, int in_w, int top, int left,
                            int height, int width) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int x = (int)(i % width);
  const long row = i / width;
  const int y = (int)(row % height);
  const long image = row / height;
  out[i] = in[(image * in_h + top + y) * in_w + left + x];
}

}  // namespace

extern "C" int pong_render_launch(const void* ball_x, const void* ball_y,
                                  const void* paddle_y, const void* enemy_y,
                                  void* out, int n, void* stream) {
  const long total = (long)n * kScreenWords;
  if (total > 0) {
    const int threads = 256;
    const long blocks = (total + threads - 1) / threads;
    pong_render_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)ball_x, (const float*)ball_y, (const float*)paddle_y,
        (const float*)enemy_y, (uint32_t*)out, total);
  }
  return (int)cudaGetLastError();
}

extern "C" int grayscale_launch(const void* rgb, void* out,
                                long long n_pixels, void* stream) {
  if (n_pixels > 0) {
    const int threads = 256;
    const long long blocks = (n_pixels + threads - 1) / threads;
    grayscale_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)rgb, (uint8_t*)out, (long)n_pixels);
  }
  return (int)cudaGetLastError();
}

extern "C" int resize_launch(const void* img, const void* a, const void* a_lo,
                             const void* a_hi, const void* b, const void* b_lo,
                             const void* b_hi, void* out, int n, int h, int w,
                             int out_h, int out_w, void* stream) {
  if (n > 0) {
    const int smem = ((h * w + 15) / 16) * 16 + 2 * out_h * w;
    cudaError_t err = cudaFuncSetAttribute(
        resize_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    resize_kernel<<<n, 256, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)img, (const int*)a, (const int*)a_lo,
        (const int*)a_hi, (const int*)b, (const int*)b_lo, (const int*)b_hi,
        (uint8_t*)out, h, w, out_h, out_w);
  }
  return (int)cudaGetLastError();
}

extern "C" int crop_launch(const void* img, void* out, int n, int in_h,
                           int in_w, int top, int left, int height,
                           int width, void* stream) {
  const bool words = ((left | width | in_w) % 4 == 0) &&
                     ((uintptr_t)img % 4 == 0) && ((uintptr_t)out % 4 == 0);
  const int unit = words ? 4 : 1;
  const long total = (long)n * height * (width / unit);
  if (total > 0) {
    const int threads = 256;
    const long blocks = (total + threads - 1) / threads;
    if (words)
      crop_kernel<uint32_t><<<(unsigned)blocks, threads, 0,
                              (cudaStream_t)stream>>>(
          (const uint32_t*)img, (uint32_t*)out, total, in_h, in_w / 4, top,
          left / 4, height, width / 4);
    else
      crop_kernel<uint8_t><<<(unsigned)blocks, threads, 0,
                             (cudaStream_t)stream>>>(
          (const uint8_t*)img, (uint8_t*)out, total, in_h, in_w, top, left,
          height, width);
  }
  return (int)cudaGetLastError();
}
