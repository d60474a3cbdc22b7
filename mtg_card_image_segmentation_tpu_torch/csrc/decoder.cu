// The LR-ASPP head's decode kernels: fused_mask_decode, fused_head_decode
// and upsample2x_add. Each has its own note below.
//
// Mask decode: (B, h, w) float32 card-minus-background score -> (B, H, W)
// uint8 {0,1} mask, (U_h . s . U_w^T) > 0 per image, with U the half-pixel
// bilinear interpolation matrices (two taps per row).
//
// Replaces: mtg_card_image_segmentation_tpu/ops/pallas/decoder.py::
// fused_mask_decode (two dense MXU matmuls per image on the TPU).
//
// Bound on the H100: memory. At b128, 64x64 -> 512x512 the kernel must read
// 2.1 MB and write 33.5 MB, ~11 us at 3.35 TB/s, against ~0.07 GFLOP. Made
// pixel by pixel from scores and column taps in global memory, with both
// row lerps per pixel, it would issue ~270 M scalar loads for those 33.5 MB
// and be bound by load instructions. So:
//   - one CTA per (band of output rows, image); the band's source score rows
//     go to shared memory once;
//   - the row lerp of every output row of the band is made once per source
//     column (w values per row, not 2 per pixel) into shared memory;
//   - a thread owns 16 consecutive output columns: their 16 column taps
//     (lo | hi << 16, w0, w1) sit in its registers for all the band's rows,
//     so a pixel costs two shared-memory reads and one lerp; the 16 bytes go
//     out in one 16-byte store.
// The band plan (rows per band, the most source rows a band reads, shared
// bytes, block shape) is made on the host: ops/kernels/decoder.py::
// mask_decode_plan, which the CPU tests check and emulate.
//
// Arithmetic: the row lerp, then the column lerp, each w0*a + w1*b with
// the weights of _interp_matrix (float64 on the host, cast to float32).
// __fmul_rn/__fadd_rn keep nvcc from contracting them into an FMA. A row-
// lerped value is the same number whether it is made once per column or once
// per pixel, so the result is bit-equal to the plain PyTorch version
// (ops/kernels/decoder.py), which computes the same products and sums in the
// same order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPix = 16;  // output pixels per thread along W

__device__ __forceinline__ float lerp2(float w0, float a, float w1, float b) {
  return __fadd_rn(__fmul_rn(w0, a), __fmul_rn(w1, b));
}

// the column taps of output columns 16 g .. 16 g + 15 (clamped to W - 1)
__device__ __forceinline__ void load_col_taps(const int* __restrict__ lo_w,
                                              const int* __restrict__ hi_w,
                                              const float* __restrict__ w0_w,
                                              const float* __restrict__ w1_w, int g, int W,
                                              int (&lh)[kPix], float (&a0)[kPix],
                                              float (&a1)[kPix]) {
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    const int j = min(g * kPix + p, W - 1);
    lh[p] = __ldg(lo_w + j) | (__ldg(hi_w + j) << 16);
    a0[p] = __ldg(w0_w + j);
    a1[p] = __ldg(w1_w + j);
  }
}

// grid (bands, B), block (gx, gy): gx threads across column groups of 16,
// gy across the band's rows. Shared: the band's source rows (src_rows x w)
// and its row-lerped rows (band_rows x w), float32. The first column group's
// taps are loaded before the staging, so their latency overlaps it.
__global__ void __launch_bounds__(256, 3)
mask_decode_kernel(const float* __restrict__ score, const int* __restrict__ lo_h,
                   const int* __restrict__ hi_h, const float* __restrict__ w0_h,
                   const float* __restrict__ w1_h, const int* __restrict__ lo_w,
                   const int* __restrict__ hi_w, const float* __restrict__ w0_w,
                   const float* __restrict__ w1_w, uint8_t* __restrict__ out, int h,
                   int w, int H, int W, int band_rows, int src_rows) {
  extern __shared__ float dec_smem[];
  float* src = dec_smem;                   // src_rows x w
  float* rl = dec_smem + src_rows * w;     // band_rows x w
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * band_rows;
  const int rows = min(band_rows, H - r0);
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthr = blockDim.x * blockDim.y;
  const int groups = (W + kPix - 1) / kPix;

  int lh[kPix];  // lo | hi << 16
  float a0[kPix], a1[kPix];
  if (threadIdx.x < groups) load_col_taps(lo_w, hi_w, w0_w, w1_w, threadIdx.x, W, lh, a0, a1);

  const int s0 = lo_h[r0];
  const int ns = hi_h[r0 + rows - 1] - s0 + 1;  // lo, hi are nondecreasing
  const float* img = score + ((long long)b * h + s0) * w;
  for (int i = tid; i < ns * w; i += nthr) src[i] = img[i];
  __syncthreads();
  for (int i = tid; i < rows * w; i += nthr) {
    const int r = i / w, c = i - r * w;
    const int oi = r0 + r;
    rl[i] = lerp2(w0_h[oi], src[(lo_h[oi] - s0) * w + c], w1_h[oi],
                  src[(hi_h[oi] - s0) * w + c]);
  }
  __syncthreads();

  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    if (g != threadIdx.x) load_col_taps(lo_w, hi_w, w0_w, w1_w, g, W, lh, a0, a1);
    const int j0 = g * kPix;
    const bool vec = j0 + kPix <= W && (W & 15) == 0;
    for (int r = threadIdx.y; r < rows; r += blockDim.y) {
      const float* v = rl + r * w;
      unsigned pk[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int p = 0; p < kPix; ++p) {
        if (lerp2(a0[p], v[lh[p] & 0xffff], a1[p], v[lh[p] >> 16]) > 0.0f)
          pk[p >> 2] |= 1u << (8 * (p & 3));
      }
      uint8_t* orow = out + ((long long)b * H + r0 + r) * W;
      if (vec) {
        *reinterpret_cast<uint4*>(orow + j0) = make_uint4(pk[0], pk[1], pk[2], pk[3]);
      } else {
        for (int p = 0; p < kPix && j0 + p < W; ++p)
          orow[j0 + p] = (uint8_t)((pk[p >> 2] >> (8 * (p & 3))) & 1u);
      }
    }
  }
}


// ---------------------------------------------------------------------------
// Head decode: the head's tail and the mask decode in one launch. Per image
//   hs[y, x]  = sum_c x[y, x, c] * gw[b, c]                       (stride 16)
//   s[Y, X]   = up2(hs)[Y, X] + sum_c low[Y, X, c] * w_lo[c] + bias (stride 8)
//   mask      = (U_h . s . U_w^T) > 0                         (full size, u8)
// with x (B, h16, w16, C) and low (B, h8, w8, Cl) bfloat16, gw (B, C), w_lo
// (Cl) and bias float32.
//
// Replaces: mtg_card_image_segmentation_tpu/ops/pallas/decoder.py::
// fused_head_decode (one grid step per image, the lerps as MXU matmuls).
//
// Bound on the H100: memory. At b128, 512x512 it reads 33.6 MB (x) and
// 41.9 MB (low) and writes 33.6 MB, ~0.033 ms at 3.35 TB/s, against 0.5
// GFLOP. An image's stride-8 score map is 16 KB, so the three stages share
// one launch through shared memory. One CTA per image would leave the card
// short of CTAs at small batches, so an image's output rows are split into
// bands, one CTA each (grid = bands x B); a CTA recomputes the few hs and s
// rows its band needs (the band table, made on the host from the tap tables,
// says which). Stage 1 and the low matvec take one pixel per thread and read
// its channels as 16-byte loads; stage 3 is the mask decode's two-tap gather
// with 16 pixels per thread and one 16-byte store.
//
// Arithmetic: the channel sums run in ascending channel order in float32,
// product then sum, each rounded on its own (__fmul_rn/__fadd_rn); the lerps
// are w0*a + w1*b, rows then columns; s = (up + ls) + bias. The plain PyTorch
// version does the same operations in the same order, so the two are
// bit-equal.

constexpr int kHeadThreads = 256;

// sum_c px[c] * wt[c], c ascending; px: C bf16 values, 16-byte aligned,
// C % 8 == 0
__device__ __forceinline__ float dot_bf16_seq(const __nv_bfloat16* px,
                                              const float* wt, int C) {
  float acc = 0.0f;
  for (int c0 = 0; c0 < C; c0 += 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(px + c0);
    const unsigned wd[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      // a bf16 is the high half of its float32
      const float lo = __uint_as_float(wd[q] << 16);
      const float hi = __uint_as_float(wd[q] & 0xffff0000u);
      acc = __fadd_rn(acc, __fmul_rn(lo, wt[c0 + 2 * q]));
      acc = __fadd_rn(acc, __fmul_rn(hi, wt[c0 + 2 * q + 1]));
    }
  }
  return acc;
}

struct Taps {
  const int* lo;
  const int* hi;
  const float* w0;
  const float* w1;
};

// bands: per band (s8_row0, s8_rows, hs_row0, hs_rows); band k makes output
// rows [k * band_rows, (k + 1) * band_rows).
__global__ void __launch_bounds__(kHeadThreads)
head_decode_kernel(const __nv_bfloat16* __restrict__ x,
                   const float* __restrict__ gw,
                   const __nv_bfloat16* __restrict__ low,
                   const float* __restrict__ w_lo,
                   const float* __restrict__ bias, Taps uh, Taps uw, Taps vh,
                   Taps vw, const int* __restrict__ bands,
                   uint8_t* __restrict__ out, int h16, int w16, int C, int h8,
                   int w8, int Cl, int H, int W, int band_rows, int max_hs_rows,
                   int max_s8_rows) {
  extern __shared__ float smem[];
  float* gw_s = smem;                        // C
  float* wlo_s = gw_s + C;                   // Cl
  float* hs_s = wlo_s + Cl;                  // max_hs_rows * w16
  float* s_s = hs_s + max_hs_rows * w16;     // max_s8_rows * w8

  const int b = blockIdx.y;
  const int band = blockIdx.x;
  const int s8_row0 = bands[4 * band], s8_rows = bands[4 * band + 1];
  const int hs_row0 = bands[4 * band + 2], hs_rows = bands[4 * band + 3];
  const int tid = threadIdx.x;

  for (int i = tid; i < C; i += kHeadThreads) gw_s[i] = gw[(long long)b * C + i];
  for (int i = tid; i < Cl; i += kHeadThreads) wlo_s[i] = w_lo[i];
  __syncthreads();

  // stage 1: the gated high-classifier matvec on the band's stride-16 rows
  const __nv_bfloat16* xb = x + ((long long)b * h16 + hs_row0) * w16 * C;
  for (int i = tid; i < hs_rows * w16; i += kHeadThreads)
    hs_s[i] = dot_bf16_seq(xb + (long long)i * C, gw_s, C);
  __syncthreads();

  // stage 2: s = (up2(hs) + low matvec) + bias on the band's stride-8 rows
  const float bias_v = bias[0];
  const __nv_bfloat16* lb = low + ((long long)b * h8 + s8_row0) * w8 * Cl;
  for (int i = tid; i < s8_rows * w8; i += kHeadThreads) {
    const int Y = s8_row0 + i / w8, X = i % w8;
    const float* top = hs_s + (uh.lo[Y] - hs_row0) * w16;
    const float* bot = hs_s + (uh.hi[Y] - hs_row0) * w16;
    const float a0 = uh.w0[Y], a1 = uh.w1[Y];
    const int l = uw.lo[X], r = uw.hi[X];
    const float up = lerp2(uw.w0[X], lerp2(a0, top[l], a1, bot[l]), uw.w1[X],
                           lerp2(a0, top[r], a1, bot[r]));
    const float ls = dot_bf16_seq(lb + (long long)i * Cl, wlo_s, Cl);
    s_s[i] = __fadd_rn(__fadd_rn(up, ls), bias_v);
  }
  __syncthreads();

  // stage 3: full-size two-tap lerp and threshold, 16 pixels per thread
  const int groups = (W + kPix - 1) / kPix;
  const int row0 = band * band_rows;
  const int rows = min(band_rows, H - row0);
  for (int t = tid; t < rows * groups; t += kHeadThreads) {
    const int g = t % groups;
    const int i = row0 + t / groups;
    const float* top = s_s + (vh.lo[i] - s8_row0) * w8;
    const float* bot = s_s + (vh.hi[i] - s8_row0) * w8;
    const float a0 = vh.w0[i], a1 = vh.w1[i];
    const int j0 = g * kPix;
    uint8_t* orow = out + ((long long)b * H + i) * W;
    unsigned pk[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int p = 0; p < kPix; ++p) {
      const int j = min(j0 + p, W - 1);
      const int l = vw.lo[j], r = vw.hi[j];
      const float rl = lerp2(a0, top[l], a1, bot[l]);
      const float rr = lerp2(a0, top[r], a1, bot[r]);
      if (lerp2(vw.w0[j], rl, vw.w1[j], rr) > 0.0f)
        pk[p >> 2] |= 1u << (8 * (p & 3));
    }
    if (j0 + kPix <= W && ((uintptr_t)(orow + j0) & 15) == 0) {
      *reinterpret_cast<uint4*>(orow + j0) = make_uint4(pk[0], pk[1], pk[2], pk[3]);
    } else {
      for (int p = 0; p < kPix && j0 + p < W; ++p)
        orow[j0 + p] = (uint8_t)((pk[p >> 2] >> (8 * (p & 3))) & 1u);
    }
  }
}

// ---------------------------------------------------------------------------
// upsample2x_add: (B, h, w, C) exact 2x half-pixel bilinear upsample (weights
// 0.25/0.75 and 0.75/0.25, edges clamped) + (B, 2h, 2w, C), float32 math, out
// in the inputs' type (float32 or bfloat16).
//
// Replaces: mtg_card_image_segmentation_tpu/ops/pallas/decoder.py::
// upsample2x_add (roll + interleave on the VPU, one image per grid step).
//
// Bound on the H100: memory. At (128, 32, 32, 128) + (128, 64, 64, 128) in
// bf16 it reads 33.6 + 134.2 MB and writes 134.2 MB, ~0.090 ms at 3.35 TB/s.
// One thread makes 16 bytes of one output pixel's channels (8 bf16 or 4
// float32), neighbouring threads on neighbouring channels, then pixels: it
// reads the 16 bytes of its four source pixels (which the cache serves to the
// three other output pixels that share them), the 16 bytes of `low`, and
// stores 16 bytes.
//
// Arithmetic: rows first, then columns, each 0.25*a + 0.75*b with the
// products and the sum rounded on their own, then + low, as the plain
// PyTorch version does: the two are bit-equal.

template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 r = *reinterpret_cast<const float4*>(p);
    v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int kN = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const unsigned wd[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v[2 * q] = __uint_as_float(wd[q] << 16);
      v[2 * q + 1] = __uint_as_float(wd[q] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
    unsigned pk[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const __nv_bfloat162 two = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
      pk[q] = *reinterpret_cast<const unsigned*>(&two);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(pk[0], pk[1], pk[2], pk[3]);
  }
};

template <typename T>
__global__ void upsample2x_add_kernel(const T* __restrict__ high,
                                      const T* __restrict__ low,
                                      T* __restrict__ out, int B, int h, int w,
                                      int C) {
  constexpr int N = Vec16<T>::kN;
  const int vecs = C / N;
  const long long total = (long long)B * 2 * h * 2 * w * vecs;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    const int cv = (int)(t % vecs);
    long long pix = t / vecs;  // (b * 2h + Y) * 2w + X
    const int X = (int)(pix % (2 * w));
    const long long bY = pix / (2 * w);
    const int Y = (int)(bY % (2 * h));
    const int b = (int)(bY / (2 * h));
    // output row 2y takes 0.25 * row(y-1) + 0.75 * row(y); row 2y+1 takes
    // 0.75 * row(y) + 0.25 * row(y+1): first the farther or nearer row as
    // listed, so the sums match the plain version term for term
    const int y = Y >> 1, xx = X >> 1;
    const int ya = (Y & 1) ? y : max(y - 1, 0);
    const int yb = (Y & 1) ? min(y + 1, h - 1) : y;
    const float wya = (Y & 1) ? 0.75f : 0.25f, wyb = 1.0f - wya;
    const int xa = (X & 1) ? xx : max(xx - 1, 0);
    const int xb = (X & 1) ? min(xx + 1, w - 1) : xx;
    const float wxa = (X & 1) ? 0.75f : 0.25f, wxb = 1.0f - wxa;
    const T* img = high + (long long)b * h * w * C + cv * N;
    float aa[N], ab[N], ba[N], bb[N], lw[N], o[N];
    Vec16<T>::load(img + ((long long)ya * w + xa) * C, aa);
    Vec16<T>::load(img + ((long long)ya * w + xb) * C, ab);
    Vec16<T>::load(img + ((long long)yb * w + xa) * C, ba);
    Vec16<T>::load(img + ((long long)yb * w + xb) * C, bb);
    Vec16<T>::load(low + pix * C + cv * N, lw);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float left = lerp2(wya, aa[k], wyb, ba[k]);
      const float right = lerp2(wya, ab[k], wyb, bb[k]);
      o[k] = __fadd_rn(lerp2(wxa, left, wxb, right), lw[k]);
    }
    Vec16<T>::store(out + pix * C + cv * N, o);
  }
}

}  // namespace

// band_rows, src_rows, gx, gy: the host's band plan (mask_decode_plan).
// out must be 16-byte aligned when W % 16 == 0.
extern "C" int mtg_fused_mask_decode(const void* score, const void* lo_h,
                                     const void* hi_h, const void* w0_h,
                                     const void* w1_h, const void* lo_w,
                                     const void* hi_w, const void* w0_w,
                                     const void* w1_w, void* out, int B, int h,
                                     int w, int H, int W, int band_rows,
                                     int src_rows, int gx, int gy,
                                     void* stream) {
  if (B < 1 || B > 65535 || band_rows < 1 || src_rows < 1 || gx < 1 || gy < 1 ||
      gx * gy > 1024 || w > 65535 || ((W & 15) == 0 && ((uintptr_t)out & 15)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)(src_rows + band_rows) * w;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mask_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((H + band_rows - 1) / band_rows, B);
  mask_decode_kernel<<<grid, dim3(gx, gy), smem, (cudaStream_t)stream>>>(
      (const float*)score, (const int*)lo_h, (const int*)hi_h,
      (const float*)w0_h, (const float*)w1_h, (const int*)lo_w,
      (const int*)hi_w, (const float*)w0_w, (const float*)w1_w,
      (uint8_t*)out, h, w, H, W, band_rows, src_rows);
  return (int)cudaGetLastError();
}

// taps: 16 pointers, (lo, hi, w0, w1) of U_h (h16 -> h8), U_w (w16 -> w8),
// V_h (h8 -> H), V_w (w8 -> W). Needs C % 8 == 0, Cl % 8 == 0 and 16-byte
// aligned x and low.
extern "C" int mtg_fused_head_decode(const void* x, const void* gw,
                                     const void* low, const void* w_lo,
                                     const void* bias, const void* const* taps,
                                     const void* bands, void* out, int B,
                                     int h16, int w16, int C, int h8, int w8,
                                     int Cl, int H, int W, int n_bands,
                                     int band_rows, int max_hs_rows,
                                     int max_s8_rows, void* stream) {
  if ((C & 7) || (Cl & 7) || ((uintptr_t)x & 15) || ((uintptr_t)low & 15))
    return (int)cudaErrorMisalignedAddress;
  if (B < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  Taps t[4];
  for (int i = 0; i < 4; ++i) {
    t[i].lo = (const int*)taps[4 * i];
    t[i].hi = (const int*)taps[4 * i + 1];
    t[i].w0 = (const float*)taps[4 * i + 2];
    t[i].w1 = (const float*)taps[4 * i + 3];
  }
  const size_t smem =
      sizeof(float) * ((size_t)C + Cl + (size_t)max_hs_rows * w16 +
                       (size_t)max_s8_rows * w8);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        head_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  head_decode_kernel<<<dim3(n_bands, B), kHeadThreads, smem,
                       (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const float*)gw, (const __nv_bfloat16*)low,
      (const float*)w_lo, (const float*)bias, t[0], t[1], t[2], t[3],
      (const int*)bands, (uint8_t*)out, h16, w16, C, h8, w8, Cl, H, W,
      band_rows, max_hs_rows, max_s8_rows);
  return (int)cudaGetLastError();
}

// high (B, h, w, C), low and out (B, 2h, 2w, C), all float32 (is_bf16 == 0)
// or all bfloat16, 16-byte aligned, C a multiple of 4 (float32) or 8.
extern "C" int mtg_upsample2x_add(const void* high, const void* low, void* out,
                                  int is_bf16, int B, int h, int w, int C,
                                  void* stream) {
  const int n = is_bf16 ? 8 : 4;
  if ((C % n) || ((uintptr_t)high & 15) || ((uintptr_t)low & 15) ||
      ((uintptr_t)out & 15))
    return (int)cudaErrorMisalignedAddress;
  const long long total = (long long)B * 2 * h * 2 * w * (C / n);
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 65535LL * 64) blocks = 65535LL * 64;
  if (blocks < 1) blocks = 1;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    upsample2x_add_kernel<__nv_bfloat16><<<(unsigned)blocks, threads, 0, st>>>(
        (const __nv_bfloat16*)high, (const __nv_bfloat16*)low,
        (__nv_bfloat16*)out, B, h, w, C);
  else
    upsample2x_add_kernel<float><<<(unsigned)blocks, threads, 0, st>>>(
        (const float*)high, (const float*)low, (float*)out, B, h, w, C);
  return (int)cudaGetLastError();
}
