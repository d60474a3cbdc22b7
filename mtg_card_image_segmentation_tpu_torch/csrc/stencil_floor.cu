// Stencil-floor microbenchmark kernel: 1x1 expand product, then the 25-tap
// dilated depthwise term chain, then the mean over the expanded channels,
// all in one launch.
//
// Replaces: tools/vpu_stencil_floor.py::run (make_kernel), the TPU
// microbenchmark that splits the cost of the tail block's depthwise stencil
// into its arithmetic and its shifts. Three modes, as there:
//   pass   acc = f32(y)                                  (no stencil)
//   arith  acc = sum over the k*k taps of f32(bf16(y * w_dw[tap])) on the
//          UNSHIFTED y (the term chain without any window movement;
//          wrong math on purpose, for timing)
//   full   the same sum on y shifted by ((ky-p)*dil, (kx-p)*dil) with zero
//          fill: the real stencil
// with y = bf16(bf16(x) @ bf16(w_exp)) accumulated in fp32, taps summed in
// fp32 with columns outer and rows inner, and out = mean over channels.
//
// Design. The TPU kernel holds eight whole images' expanded maps in VMEM.
// Here one CTA owns (image, band of kRows output rows) and walks over the
// expanded channels in slices of kCS: for each slice it makes the band of
// y (with its halo rows in `full`) by a WMMA bf16 product straight into a
// zero-padded shared-memory tile, then every thread runs the tap chain for 8
// channels of a few pixels out of that tile. The expanded map never touches
// device memory, so the function's bytes are x, the weights and the tiny
// output. Per-pixel channel sums are kept per (pixel, 8-channel group) by the
// one thread that owns them and added up in a fixed order at the end: no
// atomics, the same bits every run.
//
// Bound on the H100 at the tool's shape (x (128,32,32,160) bf16, 960
// expanded channels, k5 d2): operations. The 25-term chain is 2*25 fp32
// operations per expanded value = 6.3 GFLOP, 0.094 ms at 67 TFLOP/s; the
// expand product is 40 GFLOP, 0.041 ms at 989 TFLOP/s; the bytes (42 MB of
// x, 0.7 MB of weights, 0.5 MB out) take 0.013 ms at 3.35 TB/s. `pass` is
// bounded by the product. This first version recomputes the halo rows of y
// (2x the product in `full`), feeds WMMA from global memory without a copy
// pipeline, and issues ~6 operations per term, so it sits well above that.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

enum { kModePass = 0, kModeArith = 1, kModeFull = 2 };

constexpr int kCS = 64;        // expanded channels per slice
constexpr int kRows = 8;       // output rows per CTA
constexpr int kThreads = 512;  // 16 warps
constexpr int kWarps = kThreads / 32;
constexpr int kBsLd = kCS + 8;  // bf16 elements per row of the weight slice
constexpr int kStageLd = 20;    // floats per row of a warp's 16x16 staging tile

struct Smem {
  size_t tile, bs, wsm, stage, red, total;
};

__host__ __device__ inline size_t align128(size_t v) { return (v + 127) & ~(size_t)127; }

__host__ __device__ inline Smem smem_layout(int W, int cin, int k, int halo) {
  Smem s;
  size_t off = 0;
  s.tile = off;
  off += align128((size_t)(kRows + 2 * halo) * (W + 2 * halo) * kCS * sizeof(bf16));
  s.bs = off;
  off += align128((size_t)cin * kBsLd * sizeof(bf16));
  s.wsm = off;
  off += align128((size_t)k * k * kCS * sizeof(float));
  s.stage = off;
  off += align128((size_t)kWarps * 16 * kStageLd * sizeof(float));
  s.red = off;
  off += align128((size_t)kRows * W * (kCS / 8) * sizeof(float));
  s.total = off;
  return s;
}

__global__ void __launch_bounds__(kThreads)
stencil_floor_kernel(const bf16* __restrict__ x, const float* __restrict__ w_exp,
                     const float* __restrict__ w_dw, float* __restrict__ out,
                     int H, int W, int cin, int cexp, int k, int dil, int mode) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int p = (k - 1) / 2;
  const int halo = (mode == kModeFull) ? p * dil : 0;
  const Smem L = smem_layout(W, cin, k, halo);
  bf16* tile = reinterpret_cast<bf16*>(smem + L.tile);
  bf16* Bs = reinterpret_cast<bf16*>(smem + L.bs);
  float* wsm = reinterpret_cast<float*>(smem + L.wsm);
  float* stage = reinterpret_cast<float*>(smem + L.stage);
  float* red = reinterpret_cast<float*>(smem + L.red);

  const int band = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int oy0 = band * kRows, oy1 = min(H, oy0 + kRows);
  const int Wp = W + 2 * halo;
  const int rows_cap = kRows + 2 * halo;
  // input rows of y this band reads, clipped to the image
  const int iy_lo = max(0, oy0 - halo), iy_hi = min(H, oy1 + halo);
  const int nstrips = (iy_hi - iy_lo) * W / 16;
  const int npix = (oy1 - oy0) * W;
  constexpr int G = kCS / 8;  // 8-channel groups per slice

  // the tile's halo columns and rows outside the image stay zero throughout
  for (int v = tid; v < rows_cap * Wp * kCS / 8; v += kThreads)
    reinterpret_cast<uint4*>(tile)[v] = make_uint4(0, 0, 0, 0);
  for (int i = tid; i < kRows * W * G; i += kThreads) red[i] = 0.0f;

  float* my_stage = stage + warp * 16 * kStageLd;
  const int g = tid % G, plane = tid / G, nplanes = kThreads / G;

  for (int c0 = 0; c0 < cexp; c0 += kCS) {
    __syncthreads();  // the previous slice's stencil is done with tile, wsm
    for (int i = tid; i < cin * kCS; i += kThreads) {
      const int r = i / kCS, c = i % kCS;
      Bs[r * kBsLd + c] = __float2bfloat16_rn(w_exp[(size_t)r * cexp + c0 + c]);
    }
    if (mode != kModePass) {
      for (int i = tid; i < k * k * kCS; i += kThreads) {
        const int tap = i / kCS, c = i % kCS;
        // the tap weight as the reference uses it: rounded to bf16
        wsm[i] = __bfloat162float(__float2bfloat16_rn(w_dw[(size_t)tap * cexp + c0 + c]));
      }
    }
    __syncthreads();

    // ---- y slice: (valid rows * W) x kCS = x @ w_exp[:, c0:c0+kCS] --------
    for (int s = warp; s < nstrips; s += kWarps) {
      const int pix0 = s * 16;  // within the valid rows; a strip lies in one row
      const int iy = iy_lo + pix0 / W, ix0 = pix0 % W;
      const bf16* a_ptr = x + ((size_t)(b * H + iy) * W + ix0) * cin;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kCS / 16];
#pragma unroll
      for (int j = 0; j < kCS / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);
      for (int kk = 0; kk < cin; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, a_ptr + kk, cin);
#pragma unroll
        for (int j = 0; j < kCS / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
          wmma::load_matrix_sync(bfr, Bs + kk * kBsLd + j * 16, kBsLd);
          wmma::mma_sync(acc[j], a, bfr, acc[j]);
        }
      }
      const int ry = iy - (oy0 - halo);
      bf16* dst_row = tile + ((size_t)ry * Wp + halo + ix0) * kCS;
#pragma unroll
      for (int j = 0; j < kCS / 16; ++j) {
        wmma::store_matrix_sync(my_stage, acc[j], kStageLd, wmma::mem_row_major);
        __syncwarp();
        const int r = lane >> 1, h = (lane & 1) * 8;
        uint4 packed;
        bf16* o = reinterpret_cast<bf16*>(&packed);
#pragma unroll
        for (int e = 0; e < 8; ++e) o[e] = __float2bfloat16_rn(my_stage[r * kStageLd + h + e]);
        *reinterpret_cast<uint4*>(dst_row + (size_t)r * kCS + j * 16 + h) = packed;
        __syncwarp();
      }
    }
    __syncthreads();

    // ---- tap chain: 8 channels of one pixel at a time ---------------------
    for (int pix = plane; pix < npix; pix += nplanes) {
      const int dy = pix / W, ox = pix - dy * W;
      float acc[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = 0.0f;
      if (mode == kModePass) {
        const uint4 raw = *reinterpret_cast<const uint4*>(
            tile + ((size_t)dy * Wp + ox) * kCS + g * 8);
        const bf16* v = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[j] = __bfloat162float(v[j]);
      } else {
        const int step = (mode == kModeFull) ? dil : 0;
        for (int kx = 0; kx < k; ++kx) {
          for (int ky = 0; ky < k; ++ky) {
            const uint4 raw = *reinterpret_cast<const uint4*>(
                tile + ((size_t)(dy + ky * step) * Wp + ox + kx * step) * kCS + g * 8);
            const bf16* v = reinterpret_cast<const bf16*>(&raw);
            const float* wt = wsm + (ky * k + kx) * kCS + g * 8;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const float term = __bfloat162float(
                  __float2bfloat16_rn(__fmul_rn(__bfloat162float(v[j]), wt[j])));
              acc[j] = __fadd_rn(acc[j], term);
            }
          }
        }
      }
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) s = __fadd_rn(s, acc[j]);
      red[pix * G + g] += s;  // this thread alone owns (pix, g)
    }
  }
  __syncthreads();
  for (int pix = tid; pix < npix; pix += kThreads) {
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < G; ++j) s = __fadd_rn(s, red[pix * G + j]);
    out[(size_t)(b * H + oy0) * W + pix] = s / (float)cexp;
  }
}

}  // namespace

extern "C" int mtg_stencil_floor_smem(int W, int cin, int k, int dil, int mode) {
  const int halo = (mode == kModeFull) ? (k - 1) / 2 * dil : 0;
  return (int)smem_layout(W, cin, k, halo).total;
}

// x (B, H, W, cin) bf16, w_exp (cin, cexp) f32, w_dw (k*k, cexp) f32 ->
// out (B, H, W, 1) f32. One launch.
extern "C" int mtg_stencil_floor(const void* x, const void* w_exp, const void* w_dw,
                                 void* out, int B, int H, int W, int cin, int cexp,
                                 int k, int dil, int mode, void* stream) {
  if (mode < kModePass || mode > kModeFull) return (int)cudaErrorInvalidValue;
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || W % 16 != 0 || cin % 16 != 0 ||
      cexp % kCS != 0 || k < 1 || k % 2 == 0 || dil < 1)
    return (int)cudaErrorInvalidValue;
  const int halo = (mode == kModeFull) ? (k - 1) / 2 * dil : 0;
  const size_t smem = smem_layout(W, cin, k, halo).total;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        stencil_floor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((H + kRows - 1) / kRows, B);
  stencil_floor_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const float*)w_exp, (const float*)w_dw, (float*)out, H, W,
      cin, cexp, k, dil, mode);
  return (int)cudaGetLastError();
}
