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
// The row lerp reads each output row's two source rows and weights from a
// table staged in shared memory (one 16-byte read, not four global ones).
// These band stages (stage_taps, band_row_lerp, band_col_store) are shared
// with the head decode below. The band plan (rows per band, the most source rows a band reads, shared
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

// A lerp's two taps: offsets of the two source rows (or columns) and their
// weights, staged in shared memory so the lerp loops read one 16-byte value
// instead of four global ones.
struct __align__(16) LerpTap {
  int a, b;
  float w0, w1;
};

// taps[i] for outputs o0 .. o0 + n - 1: source offsets (lo - s0) * stride,
// (hi - s0) * stride
__device__ __forceinline__ void stage_taps(LerpTap* taps, int o0, int n, int s0, int stride,
                                           const int* __restrict__ lo,
                                           const int* __restrict__ hi,
                                           const float* __restrict__ w0,
                                           const float* __restrict__ w1, int tid, int nthr) {
  for (int i = tid; i < n; i += nthr) {
    const int o = o0 + i;
    taps[i] = {(__ldg(lo + o) - s0) * stride, (__ldg(hi + o) - s0) * stride, __ldg(w0 + o),
               __ldg(w1 + o)};
  }
}

// The band's rows, row-lerped once per source column: rl (rows x w) from
// src with the rows' staged taps. Thread tid of nthr.
__device__ __forceinline__ void band_row_lerp(const float* src, int w, int rows,
                                              const LerpTap* row_taps, float* rl, int tid,
                                              int nthr) {
  for (int i = tid; i < rows * w; i += nthr) {
    const int r = i / w, c = i - r * w;
    const LerpTap t = row_taps[r];
    rl[i] = lerp2(t.w0, src[t.a + c], t.w1, src[t.b + c]);
  }
}

// The band's column lerp, threshold and stores: thread (tx, ty) of a gx x gy
// grid owns column groups tx, tx + gx, ... (16 pixels each, their taps in
// registers) on rows ty, ty + gy, ...; one 16-byte store per 16 pixels
// (out_band 16-byte aligned when W % 16 == 0). kPreloaded: lh, a0, a1
// already hold group tx's taps.
template <bool kPreloaded>
__device__ __forceinline__ void band_col_store(const float* rl, int rows, int w,
                                               uint8_t* __restrict__ out_band, int W,
                                               const int* __restrict__ lo_w,
                                               const int* __restrict__ hi_w,
                                               const float* __restrict__ w0_w,
                                               const float* __restrict__ w1_w, int tx, int ty,
                                               int gx, int gy, int (&lh)[kPix],
                                               float (&a0)[kPix], float (&a1)[kPix]) {
  const int groups = (W + kPix - 1) / kPix;
  for (int g = tx; g < groups; g += gx) {
    if (!kPreloaded || g != tx) load_col_taps(lo_w, hi_w, w0_w, w1_w, g, W, lh, a0, a1);
    const int j0 = g * kPix;
    const bool vec = j0 + kPix <= W && (W & 15) == 0;
    for (int r = ty; r < rows; r += gy) {
      const float* v = rl + r * w;
      unsigned pk[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int p = 0; p < kPix; ++p) {
        if (lerp2(a0[p], v[lh[p] & 0xffff], a1[p], v[lh[p] >> 16]) > 0.0f)
          pk[p >> 2] |= 1u << (8 * (p & 3));
      }
      uint8_t* orow = out_band + (long long)r * W;
      if (vec) {
        *reinterpret_cast<uint4*>(orow + j0) = make_uint4(pk[0], pk[1], pk[2], pk[3]);
      } else {
        for (int p = 0; p < kPix && j0 + p < W; ++p)
          orow[j0 + p] = (uint8_t)((pk[p >> 2] >> (8 * (p & 3))) & 1u);
      }
    }
  }
}

// grid (bands, B), block (gx, gy): gx threads across column groups of 16,
// gy across the band's rows. Shared: the band's row taps (band_rows), source
// rows (src_rows x w) and row-lerped rows (band_rows x w), float32. The
// first column group's taps are loaded before the staging, so their latency
// overlaps it.
__global__ void __launch_bounds__(256, 3)
mask_decode_kernel(const float* __restrict__ score, const int* __restrict__ lo_h,
                   const int* __restrict__ hi_h, const float* __restrict__ w0_h,
                   const float* __restrict__ w1_h, const int* __restrict__ lo_w,
                   const int* __restrict__ hi_w, const float* __restrict__ w0_w,
                   const float* __restrict__ w1_w, uint8_t* __restrict__ out, int h,
                   int w, int H, int W, int band_rows, int src_rows) {
  extern __shared__ __align__(16) uint8_t dec_smem[];
  LerpTap* row_taps = reinterpret_cast<LerpTap*>(dec_smem);     // band_rows
  float* src = reinterpret_cast<float*>(row_taps + band_rows);  // src_rows x w
  float* rl = src + src_rows * w;                               // band_rows x w
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * band_rows;
  const int rows = min(band_rows, H - r0);
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthr = blockDim.x * blockDim.y;
  const int groups = (W + kPix - 1) / kPix;

  int lh[kPix];  // lo | hi << 16
  float a0[kPix], a1[kPix];
  if (threadIdx.x < groups)
    load_col_taps(lo_w, hi_w, w0_w, w1_w, threadIdx.x, W, lh, a0, a1);

  const int s0 = lo_h[r0];
  const int ns = hi_h[r0 + rows - 1] - s0 + 1;  // lo, hi are nondecreasing
  const float* img = score + ((long long)b * h + s0) * w;
  for (int i = tid; i < ns * w; i += nthr) src[i] = img[i];
  stage_taps(row_taps, r0, rows, s0, w, lo_h, hi_h, w0_h, w1_h, tid, nthr);
  __syncthreads();
  band_row_lerp(src, w, rows, row_taps, rl, tid, nthr);
  __syncthreads();
  band_col_store<true>(rl, rows, w, out + ((long long)b * H + r0) * W, W, lo_w, hi_w, w0_w,
                       w1_w, threadIdx.x, threadIdx.y, blockDim.x, blockDim.y, lh, a0, a1);
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
// Bound on the H100: bytes. At b128, 512x512 it reads 33.6 MB (x) and
// 41.9 MB (low) and writes 33.6 MB, ~0.033 ms at 3.35 TB/s, against 0.5
// GFLOP. The earlier version gave one pixel to one thread and summed its
// 128 channels as one serial fp32 chain: its loads were 256 bytes apart
// across a warp, a quarter of the threads idled in stage 1, and it moved
// ~320 GB/s, bound by latency. So:
//   - an image's output rows are split into bands of up to 128 rows, one
//     CTA of 128 threads each (grid = bands x B, four CTAs per SM); the host
//     plan (ops/kernels/decoder.py::head_decode_plan) sizes the bands from
//     the SM count and lists the stride-16 (hs) and stride-8 (s) rows each
//     band reads; the halo re-read is 1.14x at b128;
//   - stage 1 (x, C = 128) gives a pixel's channels to neighbouring lanes:
//     lane k of a group of P lanes (P the chunk count C / 8 rounded up to a
//     power of two) loads chunk k, 8 channels, as one 16-byte load, so a
//     warp reads whole pixels, contiguous; each lane keeps its chunk's 8
//     weights in registers, four pixel groups' loads are in flight before
//     any is summed, and a lane butterfly combines the chunk sums;
//   - stage 2 (low, Cl = 40: 5 chunks) gives one pixel to one lane, which
//     loads its 5 chunks at once and combines them in registers: 8 lanes
//     per pixel would idle 3 of them and leave the 2x lerp and the store to
//     one lane in 8; the lerp's row and column taps come from tables staged
//     in shared memory;
//   - stage 3 is the mask decode's band scheme (stage_taps, band_row_lerp,
//     band_col_store above): each output row's row lerp once per stride-8
//     column in shared memory, then 16 column taps per thread in registers
//     and one 16-byte store per 16 pixels.
// Timed stage by stage at b128 512x512 on the H100, stages 1 and 2 together
// take about as long as stage 3, which alone costs what the mask decode
// does. A persistent variant with producer warps for stages 1-2 and consumer
// warps for stage 3 (two s buffers between them) was no faster and is not
// kept.
//
// Arithmetic: a chunk's 8 products are summed in channel order, product then
// sum, each rounded on its own (__fmul_rn/__fadd_rn); the chunk sums,
// zero-padded to P, are combined pairwise, p[0::2] + p[1::2], level by level
// (the lane butterfly, __shfl_xor_sync with offsets 1, 2, 4, ..., computes
// exactly that, IEEE addition being commutative; stage 2 does the same levels
// in registers). The lerps are w0*a + w1*b, rows then columns; s = (up + ls)
// + bias. The plain PyTorch version (ops/kernels/decoder.py::
// _tree_channel_sum) sums in the same tree order, so the two are bit-equal.

constexpr int kHeadThreads = 128;
constexpr int kHeadUnroll = 4;  // pixel groups whose loads are in flight at once

__device__ __forceinline__ int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// sum of a chunk's 8 products, channels ascending
__device__ __forceinline__ float chunk_dot(const uint4 raw, const float (&wt)[8]) {
  const unsigned wd[4] = {raw.x, raw.y, raw.z, raw.w};
  float acc = 0.0f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    // a bf16 is the high half of its float32
    acc = __fadd_rn(acc, __fmul_rn(__uint_as_float(wd[q] << 16), wt[2 * q]));
    acc = __fadd_rn(acc, __fmul_rn(__uint_as_float(wd[q] & 0xffff0000u), wt[2 * q + 1]));
  }
  return acc;
}

// The channel sums of n pixels (pixel i's C channels at px + i * C), P lanes
// per pixel (P = C / 8 chunks rounded up to a power of two), lane k of a
// group holding chunk k and its weights wt; every lane of the warp takes
// part. emit(i, sum) runs on lane 0 of pixel i's group.
template <typename Emit>
__device__ __forceinline__ void channel_sums(const __nv_bfloat16* __restrict__ px, int C,
                                             int n, int P, const float (&wt)[8], Emit emit) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k = lane & (P - 1), nchunks = C / 8;
  const int per_warp = 32 / P, step = (kHeadThreads / 32) * per_warp;
  for (int wbase = warp * per_warp; wbase < n; wbase += step * kHeadUnroll) {
    uint4 raw[kHeadUnroll];
#pragma unroll
    for (int u = 0; u < kHeadUnroll; ++u) {
      const int i = wbase + u * step + lane / P;
      raw[u] = i < n && k < nchunks
                   ? __ldg(reinterpret_cast<const uint4*>(px + (long long)i * C + 8 * k))
                   : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kHeadUnroll; ++u) {
      const int i = wbase + u * step + lane / P;
      float p = k < nchunks ? chunk_dot(raw[u], wt) : 0.0f;
      for (int o = 1; o < P; o <<= 1) p = __fadd_rn(p, __shfl_xor_sync(0xffffffffu, p, o));
      if (k == 0 && i < n) emit(i, p);
    }
  }
}

// The channel sums of n pixels, one pixel per lane (C <= 64: up to 8 chunks
// loaded at once); the chunk sums' tree runs in registers. wt: the C weights
// in shared memory (every lane reads the same ones). emit(i, sum) on every
// lane.
template <typename Emit>
__device__ __forceinline__ void channel_sums_per_lane(const __nv_bfloat16* __restrict__ px,
                                                      int C, int n, const float* wt,
                                                      Emit emit) {
  const int nchunks = C / 8;
  const int P = pow2_at_least(nchunks);
  for (int i = threadIdx.x; i < n; i += kHeadThreads) {
    uint4 raw[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      raw[k] = k < nchunks
                   ? __ldg(reinterpret_cast<const uint4*>(px + (long long)i * C + 8 * k))
                   : make_uint4(0u, 0u, 0u, 0u);
    float p[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (k < nchunks) {
        const float4 w0 = *reinterpret_cast<const float4*>(wt + 8 * k);
        const float4 w1 = *reinterpret_cast<const float4*>(wt + 8 * k + 4);
        const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
        p[k] = chunk_dot(raw[k], w);
      } else {
        p[k] = 0.0f;
      }
    }
    // the tree over the chunks zero-padded to P, level by level
#pragma unroll
    for (int s = 1; s < 8; s <<= 1) {
      if (s < P) {
#pragma unroll
        for (int j = 0; j < 8; j += 2 * s) p[j] = __fadd_rn(p[j], p[j + s]);
      }
    }
    emit(i, p[0]);
  }
}

struct Taps {
  const int* lo;
  const int* hi;
  const float* w0;
  const float* w1;
};

// bands: per band (s8_row0, s8_rows, hs_row0, hs_rows); band k makes output
// rows [k * band_rows, (k + 1) * band_rows). Shared, in this order: the taps
// of the band's output rows (band_rows), of its stride-8 rows (max_s8_rows)
// and columns (w8); w_lo (64); hs (max_hs_rows x w16), s (max_s8_rows x w8)
// and the row-lerped rows (band_rows x w8), float32.
__global__ void __launch_bounds__(kHeadThreads, 4)
head_decode_kernel(const __nv_bfloat16* __restrict__ x,
                   const float* __restrict__ gw,
                   const __nv_bfloat16* __restrict__ low,
                   const float* __restrict__ w_lo,
                   const float* __restrict__ bias, Taps uh, Taps uw, Taps vh,
                   Taps vw, const int* __restrict__ bands,
                   uint8_t* __restrict__ out, int h16, int w16, int C, int h8,
                   int w8, int Cl, int H, int W, int band_rows, int max_hs_rows,
                   int max_s8_rows, int gx, int gy) {
  extern __shared__ __align__(16) uint8_t head_smem[];
  LerpTap* out_taps = reinterpret_cast<LerpTap*>(head_smem);  // band_rows
  LerpTap* s8_taps = out_taps + band_rows;                     // max_s8_rows
  LerpTap* col_taps = s8_taps + max_s8_rows;                   // w8
  float* wlo_s = reinterpret_cast<float*>(col_taps + w8);      // 64
  float* hs_s = wlo_s + 64;                                    // max_hs_rows x w16
  float* s_s = hs_s + max_hs_rows * w16;                       // max_s8_rows x w8
  float* rl = s_s + max_s8_rows * w8;                          // band_rows x w8

  const int b = blockIdx.y;
  const int band = blockIdx.x;
  const int s8_row0 = bands[4 * band], s8_rows = bands[4 * band + 1];
  const int hs_row0 = bands[4 * band + 2], hs_rows = bands[4 * band + 3];
  const int row0 = band * band_rows;
  const int rows = min(band_rows, H - row0);
  const int tid = threadIdx.x;
  const int px_x = pow2_at_least(C / 8);

  float wx[8];  // the weights of this lane's chunk of x
  const int k = tid & (px_x - 1);
#pragma unroll
  for (int j = 0; j < 8; ++j)
    wx[j] = 8 * k < C ? __ldg(gw + (long long)b * C + 8 * k + j) : 0.0f;
  if (tid < Cl) wlo_s[tid] = w_lo[tid];
  stage_taps(out_taps, row0, rows, s8_row0, w8, vh.lo, vh.hi, vh.w0, vh.w1, tid, kHeadThreads);
  stage_taps(s8_taps, s8_row0, s8_rows, hs_row0, w16, uh.lo, uh.hi, uh.w0, uh.w1, tid,
             kHeadThreads);
  stage_taps(col_taps, 0, w8, 0, 1, uw.lo, uw.hi, uw.w0, uw.w1, tid, kHeadThreads);

  // stage 1: the gated high-classifier matvec on the band's stride-16 rows
  channel_sums(x + ((long long)b * h16 + hs_row0) * w16 * C, C, hs_rows * w16, px_x, wx,
               [&](int i, float v) { hs_s[i] = v; });
  __syncthreads();

  // stage 2: s = (up2(hs) + low matvec) + bias on the band's stride-8 rows
  const float bias_v = bias[0];
  channel_sums_per_lane(
      low + ((long long)b * h8 + s8_row0) * w8 * Cl, Cl, s8_rows * w8, wlo_s,
      [&](int i, float ls) {
        const int r = i / w8, X = i - r * w8;
        const LerpTap ty = s8_taps[r], tx = col_taps[X];
        const float up = lerp2(tx.w0, lerp2(ty.w0, hs_s[ty.a + tx.a], ty.w1, hs_s[ty.b + tx.a]),
                               tx.w1, lerp2(ty.w0, hs_s[ty.a + tx.b], ty.w1, hs_s[ty.b + tx.b]));
        s_s[i] = __fadd_rn(__fadd_rn(up, ls), bias_v);
      });
  __syncthreads();

  // stage 3: the mask decode of the band's rows from s
  band_row_lerp(s_s, w8, rows, out_taps, rl, tid, kHeadThreads);
  __syncthreads();
  const int cx = tid % gx, cy = tid / gx;
  if (cy < gy) {
    int lh[kPix];
    float a0[kPix], a1[kPix];
    band_col_store<false>(rl, rows, w8, out + ((long long)b * H + row0) * W, W, vw.lo, vw.hi,
                          vw.w0, vw.w1, cx, cy, gx, gy, lh, a0, a1);
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
  const size_t smem = 16 * (size_t)band_rows + sizeof(float) * (size_t)(src_rows + band_rows) * w;
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
// V_h (h8 -> H), V_w (w8 -> W). Needs C and Cl multiples of 8, C up to 256
// and Cl up to 64, 16-byte aligned x and low, and out 16-byte aligned when
// W % 16 == 0.
// bands, n_bands, band_rows, max_hs_rows, max_s8_rows, gx, gy and smem: the host's plan (head_decode_plan); smem must cover the
// layout.
extern "C" int mtg_fused_head_decode(const void* x, const void* gw,
                                     const void* low, const void* w_lo,
                                     const void* bias, const void* const* taps,
                                     const void* bands, void* out, int B,
                                     int h16, int w16, int C, int h8, int w8,
                                     int Cl, int H, int W, int n_bands,
                                     int band_rows, int max_hs_rows, int max_s8_rows,
                                     int gx, int gy, int smem, void* stream) {
  if ((C & 7) || (Cl & 7) || ((uintptr_t)x & 15) || ((uintptr_t)low & 15) ||
      ((W & 15) == 0 && ((uintptr_t)out & 15)))
    return (int)cudaErrorMisalignedAddress;
  if (B < 1 || B > 65535 || C < 8 || C > 256 || Cl < 8 || Cl > 64 || gx < 1 || gy < 1 ||
      gx * gy > kHeadThreads || band_rows < 1)
    return (int)cudaErrorInvalidValue;
  const long long need =
      16LL * (band_rows + max_s8_rows + w8) +
      4LL * (64 + (long long)max_hs_rows * w16 + (long long)max_s8_rows * w8 +
             (long long)band_rows * w8);
  if (smem < need || smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  Taps t[4];
  for (int i = 0; i < 4; ++i) {
    t[i].lo = (const int*)taps[4 * i];
    t[i].hi = (const int*)taps[4 * i + 1];
    t[i].w0 = (const float*)taps[4 * i + 2];
    t[i].w1 = (const float*)taps[4 * i + 3];
  }
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        head_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  head_decode_kernel<<<dim3(n_bands, B), kHeadThreads, smem,
                       (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const float*)gw, (const __nv_bfloat16*)low,
      (const float*)w_lo, (const float*)bias, t[0], t[1], t[2], t[3],
      (const int*)bands, (uint8_t*)out, h16, w16, C, h8, w8, Cl, H, W,
      band_rows, max_hs_rows, max_s8_rows, gx, gy);
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
