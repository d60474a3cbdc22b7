// Stem: (B, H, W, 3) uint8 -> hardswish(conv3x3 stride 2 pad 1 (u8 - center)
// * W' + b), 3 -> 16 channels, bfloat16 (or float32) NHWC out.
//
// Replaces: mtg_card_image_segmentation_tpu/ops/pallas/stem.py::fused_stem.
// The TPU kernel is a space-to-depth matmul, a form chosen to fill a
// 128-lane matrix unit, with a depth-to-space on the way out. Neither is of
// use here: this is a direct stencil.
//
// Bound on the H100: at (128, 512, 512, 3) it reads 101 MB and writes 268 MB
// of bf16 (~0.110 ms at 3.35 TB/s) and does 7.25 GFLOP in float32 (~0.108 ms
// at 67 TFLOP/s): bytes and operations bind about alike. Design: one CTA
// makes a 8 x 64 tile of output pixels. It first loads the (17 x 129 x 3)
// window of input bytes the tile needs as aligned 4-byte words (the window's
// rows start 4 bytes before a multiple of 384, and W*3 is a multiple of 8,
// so no word straddles a row), and keeps it centered, as float, in shared
// memory, with 0 where the window leaves the image (padding stands for the
// centered value 0). The window is stored per row and channel with its even
// and odd columns apart, so that the 32 threads of a warp, which read
// columns 2*tx + kx, touch 32 neighbouring floats: no bank conflict. Each
// thread then makes four output pixels of one column (rows ty, ty+2, ty+4,
// ty+6), so that a tap's 16 weights, read from shared memory as four float4
// broadcasts, serve 64 multiply-adds. A pixel's 16 channels leave as two
// 16-byte stores (four for float32).
//
// Arithmetic (that of the TPU kernel): the centered input is bf16(u8) -
// bf16(center) rounded to bf16; the weights arrive rounded to bf16; products
// are exact in float32 and are summed in float32 in the order (ky, kx, c)
// ascending, so an FMA rounds as a product and a sum would, and the plain
// PyTorch version, which sums in the same order, sees the same values; bias
// and hardswish y * (clamp(y + 3, 0, 6) * float32(1/6)) in float32, each
// step rounded on its own.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileH = 8;    // output rows per CTA
constexpr int kTileW = 64;   // output columns per CTA
constexpr int kRowsPerThread = 4;
constexpr int kThreads = kTileW * (kTileH / kRowsPerThread);  // 128
constexpr int kInH = 2 * kTileH + 1;                          // 17
constexpr int kInW = 2 * kTileW + 1;                          // 129
constexpr int kHalfW = kTileW + 1;     // even columns of a window row: 65
constexpr int kRowWords = (kInW * 3 + 1 + 3) / 4;  // 4-byte words per row: 97
constexpr int kCout = 16;
constexpr int kTaps = 27;  // 3 x 3 x 3
constexpr float kOneSixth = 1.0f / 6.0f;

__device__ __forceinline__ void store16(float* out, const float* v) {
  float4* p = reinterpret_cast<float4*>(out);
#pragma unroll
  for (int q = 0; q < 4; ++q)
    p[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

__device__ __forceinline__ void store16(__nv_bfloat16* out, const float* v) {
  unsigned pk[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    // .x is the low half: the value at the lower address
    const __nv_bfloat162 two = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
    pk[q] = *reinterpret_cast<const unsigned*>(&two);
  }
  uint4* p = reinterpret_cast<uint4*>(out);
  p[0] = make_uint4(pk[0], pk[1], pk[2], pk[3]);
  p[1] = make_uint4(pk[4], pk[5], pk[6], pk[7]);
}

// weight: (27, 16) float32 holding bf16-rounded values, tap index
// (ky * 3 + kx) * 3 + c; center: 3 float32 holding bf16-rounded values.
template <typename T>
__global__ void __launch_bounds__(kThreads)
stem_kernel(const uint8_t* __restrict__ in, const float* __restrict__ weight,
            const float* __restrict__ bias, const float* __restrict__ center,
            T* __restrict__ out, int H, int W, int Ho, int Wo) {
  // tile[r][c][parity][col / 2] = centered input at window row r, column
  // col (parity = col & 1), channel c
  __shared__ float tile[kInH][3][2][kHalfW];
  __shared__ __align__(16) float w_s[kTaps][kCout];
  __shared__ float b_s[kCout];

  const int b = blockIdx.z;
  const int oy0 = blockIdx.y * kTileH;
  const int ox0 = blockIdx.x * kTileW;
  const int iy0 = 2 * oy0 - 1;
  const int ix0 = 2 * ox0 - 1;
  const float c0 = center[0], c1 = center[1], c2 = center[2];

  for (int i = threadIdx.x; i < kTaps * kCout; i += kThreads)
    w_s[i / kCout][i % kCout] = weight[i];
  if (threadIdx.x < kCout) b_s[threadIdx.x] = bias[threadIdx.x];

  // Window row r holds the bytes e = column * 3 + channel, e in [0, 387),
  // of image row iy0 + r from byte (ix0 * 3) on. Word k of the row covers
  // e = 4k - 1 .. 4k + 2 and starts at byte 6 * ox0 - 4 + 4k of the image
  // row: 4-byte aligned, since ox0 is a multiple of 64 and rows are W * 3
  // bytes, a multiple of 8.
  const uint8_t* img = in + (long long)b * H * W * 3;
  for (int i = threadIdx.x; i < kInH * kRowWords; i += kThreads) {
    const int r = i / kRowWords;
    const int k = i % kRowWords;
    const int y = iy0 + r;
    const int byte0 = 6 * ox0 - 4 + 4 * k;  // within the image row
    unsigned word = 0u;
    const bool row_ok = y >= 0 && y < H;
    if (row_ok && byte0 >= 0 && byte0 + 4 <= W * 3)
      word = *reinterpret_cast<const unsigned*>(img + (long long)y * W * 3 + byte0);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = 4 * k - 1 + j;
      if (e < 0 || e >= kInW * 3) continue;
      const int col = e / 3, ch = e % 3;
      const int x = ix0 + col;
      float v = 0.0f;
      if (row_ok && x >= 0 && x < W) {
        const float u = (float)((word >> (8 * j)) & 0xffu);
        const float c = ch == 0 ? c0 : (ch == 1 ? c1 : c2);
        // bf16(u8) is exact; the difference is rounded to bf16
        v = __bfloat162float(__float2bfloat16_rn(u - c));
      }
      tile[r][ch][col & 1][col >> 1] = v;
    }
  }
  __syncthreads();

  const int tx = threadIdx.x % kTileW;
  const int ty = threadIdx.x / kTileW;
  float acc[kRowsPerThread][kCout];
#pragma unroll
  for (int p = 0; p < kRowsPerThread; ++p)
#pragma unroll
    for (int o = 0; o < kCout; ++o) acc[p][o] = 0.0f;

  // ky is not unrolled: unrolling all 27 taps made the compiler hoist the
  // loads of every tap and spill
#pragma unroll 1
  for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int tap = (ky * 3 + kx) * 3 + c;
        float wv[kCout];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 w4 = reinterpret_cast<const float4*>(w_s[tap])[q];
          wv[4 * q] = w4.x;
          wv[4 * q + 1] = w4.y;
          wv[4 * q + 2] = w4.z;
          wv[4 * q + 3] = w4.w;
        }
#pragma unroll
        for (int p = 0; p < kRowsPerThread; ++p) {
          const int oy = ty + p * (kTileH / kRowsPerThread);
          // column 2 * tx + kx: parity kx & 1, index tx + (kx >> 1)
          const float xv = tile[2 * oy + ky][c][kx & 1][tx + (kx >> 1)];
#pragma unroll
          for (int o = 0; o < kCout; ++o)
            acc[p][o] = __fmaf_rn(xv, wv[o], acc[p][o]);
        }
      }
    }
  }

  const int ox = ox0 + tx;
  if (ox >= Wo) return;
#pragma unroll
  for (int p = 0; p < kRowsPerThread; ++p) {
    const int oy = oy0 + ty + p * (kTileH / kRowsPerThread);
    if (oy >= Ho) continue;
    float y[kCout];
#pragma unroll
    for (int o = 0; o < kCout; ++o) {
      const float s = __fadd_rn(acc[p][o], b_s[o]);
      const float g =
          __fmul_rn(fminf(fmaxf(__fadd_rn(s, 3.0f), 0.0f), 6.0f), kOneSixth);
      y[o] = __fmul_rn(s, g);
    }
    store16(out + (((long long)b * Ho + oy) * Wo + ox) * kCout, y);
  }
}

}  // namespace

// in (B, H, W, 3) uint8, H and W multiples of 8, 4-byte aligned; weight (27, 16), bias (16), center (3) float32;
// out (B, Ho, Wo, 16) float32 (out_bf16 == 0) or bfloat16, 16-byte aligned;
// Ho = (H + 1) / 2, Wo = (W + 1) / 2.
extern "C" int mtg_fused_stem(const void* in, const void* weight,
                              const void* bias, const void* center, void* out,
                              int out_bf16, int B, int H, int W, void* stream) {
  if (((uintptr_t)out & 15) || ((uintptr_t)in & 3))
    return (int)cudaErrorMisalignedAddress;
  if ((H & 7) || (W & 7)) return (int)cudaErrorInvalidValue;
  const int Ho = (H + 1) / 2, Wo = (W + 1) / 2;
  if (B < 1 || B > 65535 || (Ho + kTileH - 1) / kTileH > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((Wo + kTileW - 1) / kTileW, (Ho + kTileH - 1) / kTileH, B);
  cudaStream_t st = (cudaStream_t)stream;
  if (out_bf16)
    stem_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        (const uint8_t*)in, (const float*)weight, (const float*)bias,
        (const float*)center, (__nv_bfloat16*)out, H, W, Ho, Wo);
  else
    stem_kernel<float><<<grid, kThreads, 0, st>>>(
        (const uint8_t*)in, (const float*)weight, (const float*)bias,
        (const float*)center, (float*)out, H, W, Ho, Wo);
  return (int)cudaGetLastError();
}
