// Mask decode: (B, h, w) float32 card-minus-background score -> (B, H, W)
// uint8 {0,1} mask, (U_h . s . U_w^T) > 0 per image, with U the half-pixel
// bilinear interpolation matrices (two taps per row).
//
// Replaces: mtg_card_image_segmentation_tpu/ops/pallas/decoder.py::
// fused_mask_decode (two dense MXU matmuls per image on the TPU).
//
// Bound on the H100: memory. At b128, 64x64 -> 512x512 the kernel must read
// 2.1 MB and write 33.5 MB, ~11 us at 3.35 TB/s, against ~0.07 GFLOP. The
// dense matmul form would spend 2*H*h + 2*H*W*w operations per image on
// zeros, so the design is a direct two-tap gather: each thread makes 16
// neighbouring pixels of one output row and writes them with one 16-byte
// store; the score rows it reads stay in L1/L2 (the whole input is 2 MB).
//
// Arithmetic: the row lerp, then the column lerp, each w0*a + w1*b with
// the weights of _interp_matrix (float64 on the host, cast to float32).
// __fmul_rn/__fadd_rn keep nvcc from contracting them into an FMA, so the
// result is bit-equal to the plain PyTorch version (ops/kernels/decoder.py),
// which computes the same products and sums in the same order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPix = 16;  // output pixels per thread along W

__device__ __forceinline__ float lerp2(float w0, float a, float w1, float b) {
  return __fadd_rn(__fmul_rn(w0, a), __fmul_rn(w1, b));
}

__global__ void mask_decode_kernel(const float* __restrict__ score,
                                   const int* __restrict__ lo_h,
                                   const int* __restrict__ hi_h,
                                   const float* __restrict__ w0_h,
                                   const float* __restrict__ w1_h,
                                   const int* __restrict__ lo_w,
                                   const int* __restrict__ hi_w,
                                   const float* __restrict__ w0_w,
                                   const float* __restrict__ w1_w,
                                   uint8_t* __restrict__ out, int B, int h,
                                   int w, int H, int W) {
  const int groups = (W + kPix - 1) / kPix;
  const long long total = (long long)B * H * groups;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    const int g = (int)(t % groups);
    const long long bi = t / groups;  // b * H + i
    const int i = (int)(bi % H);
    const int b = (int)(bi / H);
    const float* img = score + (long long)b * h * w;
    const float* top = img + (long long)lo_h[i] * w;
    const float* bot = img + (long long)hi_h[i] * w;
    const float a0 = w0_h[i], a1 = w1_h[i];
    const int j0 = g * kPix;
    uint8_t* orow = out + bi * W;
    alignas(16) uint8_t m[kPix];
#pragma unroll
    for (int p = 0; p < kPix; ++p) {
      const int j = min(j0 + p, W - 1);
      const int l = lo_w[j], r = hi_w[j];
      const float rl = lerp2(a0, top[l], a1, bot[l]);
      const float rr = lerp2(a0, top[r], a1, bot[r]);
      m[p] = lerp2(w0_w[j], rl, w1_w[j], rr) > 0.0f ? 1 : 0;
    }
    if (j0 + kPix <= W && ((uintptr_t)(orow + j0) & 15) == 0) {
      *reinterpret_cast<uint4*>(orow + j0) = *reinterpret_cast<const uint4*>(m);
    } else {
      for (int p = 0; p < kPix && j0 + p < W; ++p) orow[j0 + p] = m[p];
    }
  }
}

}  // namespace

extern "C" int mtg_fused_mask_decode(const void* score, const void* lo_h,
                                     const void* hi_h, const void* w0_h,
                                     const void* w1_h, const void* lo_w,
                                     const void* hi_w, const void* w0_w,
                                     const void* w1_w, void* out, int B, int h,
                                     int w, int H, int W, void* stream) {
  const long long total = (long long)B * H * ((W + kPix - 1) / kPix);
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 65535LL * 16) blocks = 65535LL * 16;
  if (blocks < 1) blocks = 1;
  mask_decode_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)score, (const int*)lo_h, (const int*)hi_h,
      (const float*)w0_h, (const float*)w1_h, (const int*)lo_w,
      (const int*)hi_w, (const float*)w0_w, (const float*)w1_w,
      (uint8_t*)out, B, h, w, H, W);
  return (int)cudaGetLastError();
}
