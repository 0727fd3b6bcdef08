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
// uint8), so it is bound by its writes: 103.2 MB at N = 1024.
//
// Design: 16-byte row spans, the game tests split into row and column
// tests.
//   - The batch is n * 210 screen rows of 480 bytes, one after another
//     (row g = lane * 210 + y), and a row is 30 16-byte words.  Each warp
//     owns a run of `rows` consecutive rows (ops.py::render_plan: the
//     fewest that let every warp of one resident wave of blocks take a
//     share; 2 blocks of 8 warps an SM, whose ~60 registers a thread
//     then never spill); thread l < 30 of the warp stores word l of each,
//     so a warp writes 480 contiguous bytes a row as plain 16-byte
//     stores (streaming stores and bulk stores from a shared row buffer
//     measured no faster for render then grayscale: PERF.md).  No index
//     is divided per byte or word: a row finds its lane by one 32-bit
//     division by 210.
//   - The row tests (ball, paddle, enemy) run once per row: thread l of
//     the warp tests row base + l of the next 32 and the warp passes the
//     three flags on by shuffle.  The column tests run once per column:
//     each thread tests the (at most 6) pixels of its word, the paddles'
//     once for the kernel, the ball's once per lane, into a 16-bit mask of
//     the word's bytes.  A row with no flag, and every word whose masks
//     its flags do not select, is the background, one 16-byte pattern per
//     phase of the 48-byte period, in registers.
//   - Every test is the compare the plain version makes, on explicitly
//     rounded f32 products and differences (__fmul_rn/__fsub_rn) of the
//     row's or column's own f32 index; no span edge is derived by
//     arithmetic.  Priority stays ball > paddle > enemy > background; the
//     palette is immediates, no table is indexed.
// ------------------------------------------------------------------------
constexpr int kH = 210, kW = 160;
constexpr int kRowWords = kW * 3 / 16;   // 16-byte words a screen row
static_assert(kW * 3 % 16 == 0, "screen rows must be whole 16-byte words");
constexpr int kRenderWarps = 8;          // ops.py::RENDER_WARPS
constexpr int kRenderBlocksPerSm = 2;    // ops.py::RENDER_BLOCKS_PER_SM

// colours as 0x00BBGGRR
constexpr uint32_t kBall = 236u | 236u << 8 | 236u << 16;
constexpr uint32_t kPlayer = 92u | 186u << 8 | 92u << 16;
constexpr uint32_t kEnemy = 213u | 130u << 8 | 74u << 16;
constexpr uint32_t kBackground = 144u | 72u << 8 | 17u << 16;

// 16 bytes of `rgb` pixels whose first byte is channel q of a pixel
__device__ __forceinline__ uint4 fill(uint32_t rgb, int q) {
  const uint32_t c = q == 0 ? rgb
                     : q == 1 ? (rgb >> 8 | rgb << 16) & 0xffffffu
                              : (rgb >> 16 | rgb << 8) & 0xffffffu;
  const uint32_t w0 = c | c << 24;                 // c0 c1 c2 c0
  const uint32_t w1 = c >> 8 | c << 16;            // c1 c2 c0 c1
  const uint32_t w2 = c >> 16 | c << 8;            // c2 c0 c1 c2
  return make_uint4(w0, w1, w2, w0);
}

// bit b set where byte b of a word of phase q shows a pixel whose bit
// (q + b) / 3 is set in `pixels` (the word's pixels, first at bit 0)
__device__ __forceinline__ uint32_t byte_bits(uint32_t pixels, int q) {
  uint32_t bits = 0;
#pragma unroll
  for (int b = 0; b < 16; ++b) bits |= (pixels >> ((q + b) / 3) & 1u) << b;
  return bits;
}

// 0xff in each byte whose bit is set in the low 4 bits of x
__device__ __forceinline__ uint32_t spread(uint32_t x) {
  return ((x & 0xfu) * 0x00204081u & 0x01010101u) * 0xffu;
}

// v with the bytes in `bits` painted `rgb`
__device__ __forceinline__ uint4 paint(uint4 v, uint32_t rgb, uint32_t bits,
                                       int q) {
  if (bits == 0) return v;
  const uint4 c = fill(rgb, q);
  const uint32_t m0 = spread(bits), m1 = spread(bits >> 4),
                 m2 = spread(bits >> 8), m3 = spread(bits >> 12);
  return make_uint4((v.x & ~m0) | (c.x & m0), (v.y & ~m1) | (c.y & m1),
                    (v.z & ~m2) | (c.z & m2), (v.w & ~m3) | (c.w & m3));
}

__global__ void __launch_bounds__(kRenderWarps * 32, kRenderBlocksPerSm)
pong_render_kernel(const float* __restrict__ ball_x,
                   const float* __restrict__ ball_y,
                   const float* __restrict__ paddle_y,
                   const float* __restrict__ enemy_y,
                   uint4* __restrict__ out, int total_rows, int rows) {
  const int l = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * kRenderWarps +
                         (threadIdx.x >> 5);
  if (warp * rows >= total_rows) return;   // the whole warp
  const int first = (int)(warp * rows);
  const int last = min(total_rows - first, rows) + first;

  const float sy = 2.5f;                            // f32(210 / 84)
  const float sx = (float)(160.0 / 84.0);           // f32(160 / 84)
  const float reach = __fmul_rn(6.0f, sy);          // paddle half-length
  const float player_x = __fsub_rn(160.0f, __fmul_rn(3.0f, sx));
  const float enemy_x = __fmul_rn(2.0f, sx);

  // this thread's word of a row: phase q, pixels x0 .. x0 + 5 (threads
  // 30 and 31 follow word 29 and store nothing)
  const int word = min(l, kRowWords - 1);
  const int q = word % 3, x0 = 16 * word / 3;
  uint32_t pad_px = 0, enemy_px = 0;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    const float x = (float)(x0 + j);
    pad_px |= (uint32_t)(x >= player_x) << j;
    enemy_px |= (uint32_t)(x <= enemy_x) << j;
  }
  const uint32_t pad_bits = byte_bits(pad_px, q);
  const uint32_t enemy_bits = byte_bits(enemy_px, q);
  const uint4 background = fill(kBackground, q);

  int lane = -1;
  uint32_t ball_bits = 0;
  for (int base = first; base < last; base += 32) {
    // row tests: thread l takes row base + l
    uint32_t flags = 0;
    if (base + l < last) {
      const int g = base + l, n = g / kH;
      const float y = (float)(g - n * kH);
      flags = (uint32_t)(fabsf(__fsub_rn(y, __fmul_rn(ball_y[n], sy))) <=
                         sy) |
              (uint32_t)(fabsf(__fsub_rn(y, __fmul_rn(paddle_y[n], sy))) <=
                         reach) << 1 |
              (uint32_t)(fabsf(__fsub_rn(y, __fmul_rn(enemy_y[n], sy))) <=
                         reach) << 2;
    }
    const int count = min(32, last - base);
    for (int j = 0; j < count; ++j) {
      const uint32_t f = __shfl_sync(0xffffffffu, flags, j);
      const int g = base + j;
      if (g / kH != lane) {   // the ball's column tests, once per lane
        lane = g / kH;
        const float bx = __fmul_rn(ball_x[lane], sx);
        uint32_t ball_px = 0;
#pragma unroll
        for (int i = 0; i < 6; ++i)
          ball_px |= (uint32_t)(fabsf(__fsub_rn((float)(x0 + i), bx)) <= sx)
                     << i;
        ball_bits = byte_bits(ball_px, q);
      }
      uint4 v = background;
      const uint32_t ball = f & 1u ? ball_bits : 0u;
      const uint32_t pad = f & 2u ? pad_bits : 0u;
      const uint32_t enemy = f & 4u ? enemy_bits : 0u;
      if (ball | pad | enemy) {   // lowest priority first
        v = paint(v, kEnemy, enemy, q);
        v = paint(v, kPlayer, pad, q);
        v = paint(v, kBall, ball, q);
      }
      if (l < kRowWords) out[(long long)g * kRowWords + l] = v;
    }
  }
}

// ------------------------------------------------------------------------
// grayscale — replaces src/repro/kernels/image/kernel.py grayscale_batch
// (_grayscale_kernel).
//
// Bound: it reads 3 bytes and writes 1 per pixel (103.2 MB in, 34.4 MB
// out at N = 1024), so it is bound by bytes.
//
// Design: 16 pixels a thread from three 16-byte loads (48 bytes, aligned
// as 48 k is a multiple of 16), the luma in int32 per pixel, one 16-byte
// store; two such groups a thread per turn of a grid-stride loop over
// persistent blocks (ops.py::gray_plan), their six loads issued before
// any arithmetic.  `vec` (ops.py::vector_pixels: both pointers 16-byte
// aligned and a pixel count that 16 divides) picks that path; any other
// batch takes a byte path, one pixel a thread per turn, in the same
// kernel.
// ------------------------------------------------------------------------
constexpr int kGrayThreads = 256;      // ops.py::GRAY_THREADS
constexpr int kGrayBlocksPerSm = 4;    // ops.py::GRAY_BLOCKS_PER_SM

__device__ __forceinline__ uint32_t luma(uint32_t r, uint32_t g, uint32_t b) {
  return (9798u * r + 19235u * g + 3735u * b + (1u << 14)) >> 15;
}

// the luma of the 16 pixels in w (48 bytes), as 16 bytes
__device__ __forceinline__ uint4 luma16(const uint4& a, const uint4& b,
                                        const uint4& c) {
  const uint32_t w[12] = {a.x, a.y, a.z, a.w, b.x, b.y,
                          b.z, b.w, c.x, c.y, c.z, c.w};
  uint32_t o[4] = {0, 0, 0, 0};
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    uint32_t ch[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int byte = 3 * p + k;
      ch[k] = w[byte / 4] >> (8 * (byte % 4)) & 0xffu;
    }
    o[p / 4] |= luma(ch[0], ch[1], ch[2]) << (8 * (p % 4));
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

__global__ void __launch_bounds__(kGrayThreads, kGrayBlocksPerSm)
grayscale_kernel(const uint8_t* __restrict__ rgb, uint8_t* __restrict__ out,
                 long long n, bool vec) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (vec) {
    const uint4* src = reinterpret_cast<const uint4*>(rgb);
    uint4* dst = reinterpret_cast<uint4*>(out);
    const long long groups = n / 16;
    for (; i + stride < groups; i += 2 * stride) {
      const long long j = i + stride;
      const uint4 a0 = src[3 * i], a1 = src[3 * i + 1], a2 = src[3 * i + 2];
      const uint4 b0 = src[3 * j], b1 = src[3 * j + 1], b2 = src[3 * j + 2];
      dst[i] = luma16(a0, a1, a2);
      dst[j] = luma16(b0, b1, b2);
    }
    if (i < groups) dst[i] = luma16(src[3 * i], src[3 * i + 1], src[3 * i + 2]);
  } else {
    for (; i < n; i += stride)
      out[i] = (uint8_t)luma(rgb[3 * i], rgb[3 * i + 1], rgb[3 * i + 2]);
  }
}

// ------------------------------------------------------------------------
// resize — replaces src/repro/kernels/image/kernel.py resize_batch
// (_resize_kernel).
//
// Bound: it reads H*W bytes and writes out_h*out_w per image (34.4 MB in,
// 7.2 MB out at N = 1024, 210x160 -> 84x84); the arithmetic is a few
// integer multiply-adds per byte, so it is bound by bytes.
//
// Design: persistent blocks fed by bulk copies.
//   - The grid is min(N, the blocks that fit on the card at once); each
//     block walks images i, i + grid, ...  One thread keeps a ring of
//     `stages` (2 where it fits) images in shared memory full with 1-D
//     bulk copies (cp.async.bulk ... mbarrier::complete_tx), so the next
//     image arrives while the block computes this one.  A bulk copy needs
//     a 16-byte-aligned image of a multiple of 16 bytes (210x160 and
//     160x160 are); other images take a cooperative byte copy into one
//     stage in the same kernel (`bulk` from ops.py::bulk_copies).
//   - Each output row and column keeps its first tap and its band of ka
//     (kb) weights (ops.py::compact_taps, the rows of
//     ref.py::resize_weights), loaded into shared memory once per block.
//   - The vertical pass makes 4 adjacent columns per thread from 32-bit
//     loads, two columns per 32-bit register at once: a weight (<= 2^8)
//     times a byte, summed over a band whose weights sum to 2^8, stays
//     below 2^16, so (px & 0x00ff00ff) * w never carries into the next
//     column.  The intermediate is uint8 (the rounding shift leaves
//     values <= 255), (out_h, W).
//   - The horizontal pass makes 4 outputs per thread, one 32-bit word in
//     a shared output image, which leaves as 16-byte stores (bytes when
//     the output image is not 16-byte aligned).
//   - Each thread keeps one column (of words) of both passes for the
//     whole kernel and walks the rows, so no index is divided per output
//     and the horizontal taps of its four columns stay in registers; a
//     row's taps (first input, 3 weights) are one 16-byte load.  This
//     fast path needs W and out_w multiples of 4 and bands of at most 3
//     taps (every main-path size); any other size takes a general path of
//     byte columns in the same kernel.
// Integer accumulation is exact, so the order of the sum is free and the
// result is bitwise that of the plain version.
// ------------------------------------------------------------------------
constexpr int kResizeThreads = 512;

__host__ __device__ __forceinline__ int round16(int x) {
  return (x + 15) / 16 * 16;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// one thread: `bytes` from global to shared, completion on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// Shared memory, each part 16-byte aligned, at these offsets: `stages`
// source images, the (out_h, W) uint8 intermediate, the output image, the
// taps as int32 rows (a[out_h][1 + ka], then b[out_w][1 + kb], each row
// its first input and its band of weights), one mbarrier per stage.
// resize_launch sizes the block's shared memory with the same struct.
struct ResizeSmem {
  int stage, mid, obuf, tap, bars, bytes;
  __host__ __device__ ResizeSmem(int stages, int h, int w, int out_h,
                                 int out_w, int ka, int kb)
      : stage(round16(h * w)),
        mid(stages * stage),
        obuf(mid + round16(out_h * w)),
        tap(obuf + round16(out_h * out_w)),
        bars(tap + round16(4 * (out_h * (1 + ka) + out_w * (1 + kb)))),
        bytes(bars + 8 * stages) {}
};

// kFast: W and out_w multiples of 4, W / 4 and out_w / 4 at most the
// block's threads, ka = kb = 3 (ops.py pads every band of 3 or fewer taps
// to 3), so a row of taps is one 16-byte load.
template <bool kFast>
__global__ void __launch_bounds__(kResizeThreads)
resize_kernel(const uint8_t* __restrict__ img, const int* __restrict__ taps,
              uint8_t* __restrict__ out, int n, int h, int w, int out_h,
              int out_w, int ka, int kb, int stages, bool bulk,
              bool vec_out) {
  extern __shared__ __align__(16) uint8_t smem[];
  const ResizeSmem at(stages, h, w, out_h, out_w, ka, kb);
  const int img_bytes = h * w, out_bytes = out_h * out_w;
  const int stage_bytes = at.stage;
  uint8_t* mid = smem + at.mid;
  uint8_t* obuf = smem + at.obuf;
  int* tap = reinterpret_cast<int*>(smem + at.tap);
  const int n_taps = out_h * (1 + ka) + out_w * (1 + kb);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + at.bars);
  const int* a_rows = tap;
  const int* b_rows = tap + out_h * (1 + ka);
  const int tid = threadIdx.x;

  // image i into stage j % stages (thread 0)
  auto load = [&](int j, long long i) {
    bulk_load(smem_u32(smem + (j % stages) * stage_bytes),
              img + i * img_bytes, img_bytes,
              smem_u32(&bars[j % stages]));
  };
  for (int i = tid; i < n_taps; i += blockDim.x) tap[i] = taps[i];
  if (bulk && tid == 0) {
    for (int s = 0; s < stages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   :: "r"(smem_u32(&bars[s])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < stages; ++s) {
      const long long i = blockIdx.x + (long long)s * gridDim.x;
      if (i < n) load(s, i);
    }
  }
  __syncthreads();

  // fast path: this thread's word column of each pass, its rows, and the
  // horizontal taps of its four output columns
  const int wq = w / 4, wpr = out_w / 4;
  const int v_step = kFast ? blockDim.x / wq : 0;
  const int h_step = kFast ? blockDim.x / wpr : 0;
  const int v_col = kFast ? tid % wq : 0, v_row = kFast ? tid / wq : 0;
  const int h_col = kFast ? tid % wpr : 0, h_row = kFast ? tid / wpr : 0;
  int4 bt[4] = {};   // first input and 3 weights of each output column
  if (kFast && h_row < h_step) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      bt[q] = reinterpret_cast<const int4*>(b_rows)[4 * h_col + q];
  }

  int j = 0;
  for (long long i = blockIdx.x; i < n; i += gridDim.x, ++j) {
    uint8_t* src = smem + (j % stages) * stage_bytes;
    if (bulk) {
      bar_wait(smem_u32(&bars[j % stages]), (j / stages) & 1);
    } else {
      for (int x = tid; x < img_bytes; x += blockDim.x)
        src[x] = img[i * img_bytes + x];
      __syncthreads();
    }

    // vertical: mid[o][x] = round_shift(sum_k a[o][k] src[a_first + k][x])
    if (kFast) {
      if (v_row < v_step) {
#pragma unroll 2
        for (int o = v_row; o < out_h; o += v_step) {
          const int4 t = reinterpret_cast<const int4*>(a_rows)[o];
          const uint8_t* col = src + t.x * w + 4 * v_col;
          const uint32_t px0 = *reinterpret_cast<const uint32_t*>(col);
          const uint32_t px1 = *reinterpret_cast<const uint32_t*>(col + w);
          const uint32_t px2 =
              *reinterpret_cast<const uint32_t*>(col + 2 * w);
          const uint32_t even = 0x00800080u +   // 2^7 rounding
                                (px0 & 0x00ff00ffu) * (uint32_t)t.y +
                                (px1 & 0x00ff00ffu) * (uint32_t)t.z +
                                (px2 & 0x00ff00ffu) * (uint32_t)t.w;
          const uint32_t odd = 0x00800080u +
                               ((px0 >> 8) & 0x00ff00ffu) * (uint32_t)t.y +
                               ((px1 >> 8) & 0x00ff00ffu) * (uint32_t)t.z +
                               ((px2 >> 8) & 0x00ff00ffu) * (uint32_t)t.w;
          *reinterpret_cast<uint32_t*>(mid + o * w + 4 * v_col) =
              ((even >> 8) & 0x00ff00ffu) | (odd & 0xff00ff00u);
        }
      }
    } else {
      for (int it = tid; it < out_h * w; it += blockDim.x) {
        const int o = it / w, x = it % w;
        const int* row = a_rows + o * (1 + ka);
        const uint8_t* col = src + row[0] * w + x;
        int acc = 128;
        for (int k = 0; k < ka; ++k) acc += row[1 + k] * col[k * w];
        mid[it] = (uint8_t)(acc >> 8);
      }
    }
    __syncthreads();   // mid is whole, and this stage free for the
                       // image `stages` rounds ahead
    if (bulk && tid == 0) {
      const long long next = i + (long long)stages * gridDim.x;
      if (next < n) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        load(j + stages, next);
      }
    }

    // horizontal: 4 outputs per thread, one word of the output image
    if (kFast) {
      if (h_row < h_step) {
#pragma unroll 2
        for (int o = h_row; o < out_h; o += h_step) {
          const uint8_t* row = mid + o * w;
          uint32_t word = 0;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const uint8_t* x = row + bt[q].x;
            const int acc = 128 + bt[q].y * x[0] + bt[q].z * x[1] +
                            bt[q].w * x[2];
            word |= (uint32_t)(acc >> 8) << (8 * q);
          }
          reinterpret_cast<uint32_t*>(obuf)[o * wpr + h_col] = word;
        }
      }
    } else {
      for (int wi = tid; wi < (out_bytes + 3) / 4; wi += blockDim.x) {
        uint32_t word = 0;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int e = wi * 4 + q;
          if (e < out_bytes) {
            const int o = e / out_w, x = e % out_w;
            const int* trow = b_rows + x * (1 + kb);
            const uint8_t* row = mid + o * w + trow[0];
            int acc = 128;
            for (int k = 0; k < kb; ++k) acc += trow[1 + k] * row[k];
            word |= (uint32_t)(acc >> 8) << (8 * q);
          }
        }
        reinterpret_cast<uint32_t*>(obuf)[wi] = word;
      }
    }
    __syncthreads();

    uint8_t* dst = out + i * out_bytes;
    if (vec_out) {
      for (int v = tid; v < out_bytes / 16; v += blockDim.x)
        reinterpret_cast<uint4*>(dst)[v] =
            reinterpret_cast<const uint4*>(obuf)[v];
    } else {
      for (int e = tid; e < out_bytes; e += blockDim.x) dst[e] = obuf[e];
    }
  }
}

// ------------------------------------------------------------------------
// crop — replaces src/repro/kernels/image/kernel.py crop_batch
// (_crop_kernel).
//
// Bound: a copy, it reads and writes height*width bytes per image
// (26.2 MB each way at N = 1024, 210x160 -> 160x160), so it is bound by
// bytes.
//
// Design: a 2-D grid, x over an image's output units in chunks of
// kCropThreads * kCropUnroll, y over the images (a block walks images
// gridDim.y apart past the grid's 65535 limit).  Each thread issues its
// kCropUnroll loads before its stores (two: four measured 1-2% slower,
// PERF.md), neighbouring threads on neighbouring units; indices inside
// an image are 32-bit, and no unit divides a 64-bit index.  A unit finds
// its row by one 32-bit division by the window's width.
// ops.py::crop_plan picks the unit:
//   (a) kCropRuns, 16 bytes: a window of whole rows (left 0, the full
//       width; the Pong playfield) is one contiguous run of
//       height * width bytes an image, copied as a window of one row;
//   (b) kCropSpans, 16 bytes: left, width and the input width multiples
//       of 16, each output row a span of 16-byte units;
//   (c) kCropWords, 4 bytes, the same on multiples of 4;
//   (d) kCropBytes, a byte.
// Every path but (d) needs both base pointers aligned to its unit, and
// (a) every image's run too; crop_launch checks the plan's claim again.
// ------------------------------------------------------------------------
constexpr int kCropRuns = 0, kCropSpans = 1, kCropWords = 2, kCropBytes = 3;
constexpr int kCropThreads = 128;
constexpr int kCropUnroll = 2;
constexpr int kMaxGridY = 65535;

// in: images of `image_units` units, the window `offset` units in, its
// rows `in_w` units apart; out: images of per_image units, rows of
// `width` units.
template <typename U>
__global__ void __launch_bounds__(kCropThreads)
    crop_kernel(const U* __restrict__ in, U* __restrict__ out, int n,
                long long image_units, int offset, int in_w, int width,
                int per_image) {
  const int first = blockIdx.x * (kCropThreads * kCropUnroll) + threadIdx.x;
  for (int image = blockIdx.y; image < n; image += gridDim.y) {
    const U* src = in + image * image_units + offset;
    U* dst = out + (long long)image * per_image;
    U v[kCropUnroll];
#pragma unroll
    for (int k = 0; k < kCropUnroll; ++k) {
      const int u = first + k * kCropThreads;
      if (u < per_image) {
        const int y = (int)((unsigned)u / (unsigned)width);
        v[k] = src[y * in_w + (u - y * width)];
      }
    }
#pragma unroll
    for (int k = 0; k < kCropUnroll; ++k) {
      const int u = first + k * kCropThreads;
      if (u < per_image) dst[u] = v[k];
    }
  }
}

// sizes in bytes, each a multiple of sizeof(U) (crop_launch's checks)
template <typename U>
void launch_crop(const void* img, void* out, int n, int in_h, int in_w,
                 int top, int left, int height, int width,
                 cudaStream_t stream) {
  constexpr int unit = (int)sizeof(U);
  const int per_image = (int)((long long)height * width / unit);
  const dim3 grid((per_image + kCropThreads * kCropUnroll - 1) /
                      (kCropThreads * kCropUnroll),
                  n < kMaxGridY ? n : kMaxGridY);
  crop_kernel<U><<<grid, kCropThreads, 0, stream>>>(
      (const U*)img, (U*)out, n, (long long)in_h * in_w / unit,
      (int)(((long long)top * in_w + left) / unit), in_w / unit,
      width / unit, per_image);
}

}  // namespace

// out (n, 210, 160, 3) uint8, 16-byte aligned; each warp of the `blocks`
// blocks of kRenderWarps warps renders `rows` consecutive screen rows
// (ops.py::render_plan), which must cover all n * 210.
extern "C" int pong_render_launch(const void* ball_x, const void* ball_y,
                                  const void* paddle_y, const void* enemy_y,
                                  void* out, int n, int rows, int blocks,
                                  void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (n > INT32_MAX / kH || rows < 1 || blocks < 1 ||
      (long long)blocks * kRenderWarps * rows < (long long)n * kH ||
      (uintptr_t)out % 16 != 0)
    return (int)cudaErrorInvalidValue;
  pong_render_kernel<<<blocks, kRenderWarps * 32, 0, (cudaStream_t)stream>>>(
      (const float*)ball_x, (const float*)ball_y, (const float*)paddle_y,
      (const float*)enemy_y, (uint4*)out, n * kH, rows);
  return (int)cudaGetLastError();
}

// rgb (n_pixels, 3), out (n_pixels) uint8 dense.  vec: 16 pixels a thread
// by 16-byte loads and stores (both pointers 16-byte aligned and n_pixels
// % 16 == 0, ops.py::vector_pixels), else a byte path; `blocks` persistent
// blocks of kGrayThreads threads (ops.py::gray_plan).
extern "C" int grayscale_launch(const void* rgb, void* out,
                                long long n_pixels, int vec, int blocks,
                                void* stream) {
  if (n_pixels <= 0) return (int)cudaGetLastError();
  if (blocks < 1 ||
      (vec && ((uintptr_t)rgb % 16 != 0 || (uintptr_t)out % 16 != 0 ||
               n_pixels % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  grayscale_kernel<<<blocks, kGrayThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)rgb, (uint8_t*)out, n_pixels, vec != 0);
  return (int)cudaGetLastError();
}

// img (n, h, w) uint8 dense; taps int32 rows (first input, ka weights)
// for the out_h output rows, then (first, kb weights) for the out_w
// columns (ops.py::compact_taps); out (n, out_h, out_w) uint8 dense.  bulk:
// the images come in by 1-D bulk copies (img 16-byte aligned and h * w %
// 16 == 0, ops.py::bulk_copies); then two source images are staged where
// they fit, so the next loads while this one is computed.  The grid is
// the blocks that fit on the card at once (at most n); the fit and the
// shared-memory attribute are kept per kernel instance, and found again
// when the device or the size changes.
extern "C" int resize_launch(const void* img, const void* taps, void* out,
                             int n, int h, int w, int out_h, int out_w,
                             int ka, int kb, int bulk, void* stream) {
  constexpr int kMaxSmem = 232448;   // a Hopper block's shared memory
  if (n <= 0) return (int)cudaGetLastError();
  if (ka < 1 || kb < 1 ||
      (bulk && ((uintptr_t)img % 16 != 0 || (h * w) % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  int stages = bulk ? 2 : 1;
  if (ResizeSmem(stages, h, w, out_h, out_w, ka, kb).bytes > kMaxSmem)
    stages = 1;
  const int smem = ResizeSmem(stages, h, w, out_h, out_w, ka, kb).bytes;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const bool fast = w % 4 == 0 && out_w % 4 == 0 &&
                    w / 4 <= kResizeThreads && out_w / 4 <= kResizeThreads &&
                    ka == 3 && kb == 3;
  const bool vec_out = (uintptr_t)out % 16 == 0 && (out_h * out_w) % 16 == 0;
  auto kernel = fast ? resize_kernel<true> : resize_kernel<false>;
  struct Fit {
    int dev = -1, smem = 0, blocks = 0;   // blocks resident on the card
  };
  static Fit fit[2];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  Fit& f = fit[fast];
  if (f.dev != dev || f.smem != smem) {
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, kResizeThreads, smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    f = Fit{dev, smem, per_sm * sms};
  }
  const int grid = n < f.blocks ? n : f.blocks;
  kernel<<<grid, kResizeThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)img, (const int*)taps, (uint8_t*)out, n, h, w, out_h,
      out_w, ka, kb, stages, bulk != 0, vec_out);
  return (int)cudaGetLastError();
}

// img (n, in_h, in_w), out (n, height, width) uint8 dense; `path` is
// ops.py::crop_plan's unit, whose alignment is checked here again.
extern "C" int crop_launch(const void* img, void* out, int n, int in_h,
                           int in_w, int top, int left, int height,
                           int width, int path, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const long long run = (long long)height * width;
  const bool aligned16 = ((uintptr_t)img | (uintptr_t)out) % 16 == 0;
  bool ok;
  switch (path) {
    case kCropRuns:
      ok = left == 0 && width == in_w && aligned16 && run % 16 == 0 &&
           (long long)top * in_w % 16 == 0 &&
           (long long)in_h * in_w % 16 == 0 &&
           (long long)in_h * in_w <= INT32_MAX;
      break;
    case kCropSpans:
      ok = (left | width | in_w) % 16 == 0 && aligned16;
      break;
    case kCropWords:
      ok = (left | width | in_w) % 4 == 0 &&
           ((uintptr_t)img | (uintptr_t)out) % 4 == 0;
      break;
    case kCropBytes:
      ok = true;
      break;
    default:
      ok = false;
  }
  if (!ok || height < 1 || width < 1 || top < 0 || left < 0 ||
      top + height > in_h || left + width > in_w || run > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (path == kCropRuns)   // one row of height * width bytes an image
    launch_crop<uint4>(img, out, n, 1, in_h * in_w, 0, top * in_w, 1,
                       (int)run, s);
  else if (path == kCropSpans)
    launch_crop<uint4>(img, out, n, in_h, in_w, top, left, height, width, s);
  else if (path == kCropWords)
    launch_crop<uint32_t>(img, out, n, in_h, in_w, top, left, height, width,
                          s);
  else
    launch_crop<uint8_t>(img, out, n, in_h, in_w, top, left, height, width,
                         s);
  return (int)cudaGetLastError();
}
