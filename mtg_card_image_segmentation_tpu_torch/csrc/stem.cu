// Stem: (B, H, W, 3) uint8 -> hardswish(conv3x3 stride 2 pad 1 (u8 - center)
// * W' + b), 3 -> 16 channels, bfloat16 (or float32) NHWC out.
//
// Replaces: mtg_card_image_segmentation_tpu/ops/pallas/stem.py::fused_stem,
// which on the TPU is already a matrix product (its space-to-depth form,
// _assemble_shift_weights). Here it is an implicit GEMM on the tensor cores.
//
// Bound on the H100: bytes. At (128, 512, 512, 3) it reads 101 MB and writes
// 268 MB of bf16, ~0.110 ms at 3.35 TB/s. Its 7.25 GFLOP of products take
// ~0.007 ms on the tensor cores (the earlier direct stencil did them as fp32
// FMAs, ~0.108 ms at 67 TFLOP/s, and reached a fifth of that bound), and the
// bias + hardswish epilogue ~0.010 ms of fp32. So the design keeps the
// tensor cores fed from shared memory and the copies in flight:
//   - GEMM shape: M = output pixels, N = 16 channels (two n8 tiles), K = the
//     27 taps laid out as 16 pairs of neighbouring window bytes (below), 32
//     in all; `mma.sync.m16n8k16` bf16 x bf16 -> fp32. The B fragments (the
//     32 x 16 padded weights, made once on the host: ops/kernels/stem.py::
//     prepare_stem) sit in 8 registers per lane for the whole kernel.
//     `mma.sync` and not `wgmma`: the products need under 1 % of the tensor
//     rate, and `mma.sync` takes the im2col'd A straight from registers.
//   - K layout: a window row holds the centered bytes of (column, channel)
//     as the image does, so the 9 values of one tap row (kx, c) of an output
//     pixel are 9 neighbouring bf16 values. Pair j = 0..4 of tap row ky
//     covers the values at relative positions 2j - 1 and 2j (position -1 is
//     the neighbour's last channel, with a zero weight), and every pair is
//     4-byte aligned: an A register is ONE 32-bit shared load. 3 x 5 = 15
//     pairs, and a 16th of zero weight, make K = 32. Zero weight rows are
//     K = 0, 10, 20, 30 and 31.
//   - Persistent CTAs (three per SM) walk 16 x 64 output tiles. A tile's
//     33 x 129 x 3 byte window comes in by cp.async into one of two raw
//     buffers while the previous tile is computed; it is centered into bf16
//     once per byte (one 16-byte word at a time, the channel pattern from
//     the word's index, no division per byte), and read by the MMAs.
//   - Loads: when W * 3 is a multiple of 16 (W % 16 == 0: 512, 320 and 240)
//     the window is copied as 16-byte words, else (W % 8 == 0, e.g. 24) as
//     4-byte words; the host plan picks (ops/kernels/stem.py::stem_plan). A
//     word lies wholly inside or wholly outside an image row, so the padding
//     is decided per word.
//   - Stores: each warp makes 16 neighbouring pixels of one output row per
//     step, stages them in shared memory and writes the 512 contiguous
//     bytes as one 16-byte store per lane.
//
// Arithmetic: the centered input is bf16(u8) - bf16(center) rounded to
// bf16; the weights are bf16; every product is exact in fp32. The tensor
// cores sum the 27 products in their own order, so the result is NOT
// bit-equal to the plain PyTorch version (ops/kernels/stem.py), which sums in
// (ky, kx, c) order: the sums differ by fp32 rounding, and a bf16 output
// rounds the other way where the fp32 value lies that close to a tie. The
// gate on the card (chip_smoke.py) is max|d| <= one bf16 ulp at the output's
// largest magnitude and mean|d| < 0.01. Bias and hardswish
// y * (clamp(y + 3, 0, 6) * float32(1/6)) in fp32, each step rounded on its
// own, as the plain version does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileH = 16;  // output rows per tile
constexpr int kTileW = 64;  // output columns per tile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSegs = kTileH * kTileW / 16;  // 16-pixel row segments per tile
constexpr int kWinRows = 2 * kTileH + 1;     // 33
constexpr int kCout = 16;
constexpr float kOneSixth = 1.0f / 6.0f;

__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }

// Window geometry for VB-byte words. Element e = column * 3 + channel of a
// window row, column 0 being image column 2 * ox0 - 1; a row is kWords words
// from byte 6 * ox0 - 3 - kPre of the image row on, so element e sits at
// index e + kPre of the row. 16-byte rows start 16 bytes before the tile's
// first needed byte's word; 4-byte rows 4 bytes before. kPre is odd in both,
// which makes every K pair (positions 2j - 1, 2j) 4-byte aligned.
template <int VB>
struct Geo {
  static constexpr int kPre = VB == 16 ? 13 : 1;
  // elements up to 6 * (kTileW - 1) + 8 = 386 are read
  static constexpr int kWords = (6 * kTileW - 6 + 9 + kPre + VB - 1) / VB;  // 25 | 97
  static constexpr int kRow = kWords * VB;                                  // 400 | 388
  static constexpr int kRawBytes = round16(kWinRows * kRow);
  static constexpr int kWinBytes = round16(2 * kWinRows * kRow);
};

template <int VB, typename T>
constexpr int stem_smem() {
  return 2 * Geo<VB>::kRawBytes + Geo<VB>::kWinBytes + kWarps * 16 * kCout * (int)sizeof(T);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

template <int VB>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, int n) {
  if constexpr (VB == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float hardswish_bias(float acc, float b) {
  const float s = __fadd_rn(acc, b);
  return __fmul_rn(s, __fmul_rn(fminf(fmaxf(__fadd_rn(s, 3.0f), 0.0f), 6.0f), kOneSixth));
}

struct Tile {
  int b, oy0, ox0;
};

__device__ __forceinline__ Tile tile_of(int t, int tiles_x, int per_img) {
  const int b = t / per_img, r = t - b * per_img;
  const int ty = r / tiles_x;
  return {b, ty * kTileH, (r - ty * tiles_x) * kTileW};
}

// word k of window row r: its byte offset in the image row, and whether it
// lies inside the image
template <int VB>
__device__ __forceinline__ bool word_in_image(const Tile& tl, int r, int k, int H, int row_bytes,
                                              int& gb) {
  const int y = 2 * tl.oy0 - 1 + r;
  gb = 6 * tl.ox0 - 3 - Geo<VB>::kPre + k * VB;
  return y >= 0 && y < H && gb >= 0 && gb + VB <= row_bytes;
}

template <int VB>
__device__ __forceinline__ void copy_window(const uint8_t* __restrict__ in, const Tile& tl,
                                             uint8_t* raw, int H, int W) {
  using G = Geo<VB>;
  const int row_bytes = 3 * W;
  const uint8_t* img = in + (long long)tl.b * H * row_bytes;
  for (int i = threadIdx.x; i < kWinRows * G::kWords; i += kThreads) {
    const int r = i / G::kWords, k = i - r * G::kWords;
    int gb;
    const bool ok = word_in_image<VB>(tl, r, k, H, row_bytes, gb);
    const uint8_t* src = ok ? img + (long long)(2 * tl.oy0 - 1 + r) * row_bytes + gb : in;
    cp_async<VB>(smem_u32(raw + r * G::kRow + k * VB), src, ok ? VB : 0);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// bf16(u - c) for the 4 bytes j0 .. j0 + 3 of a word, cr the centers of its
// bytes 0, 1, 2 (mod 3)
__device__ __forceinline__ void center4(uint32_t word, const float (&cr)[3], int j0,
                                        uint32_t& lo, uint32_t& hi) {
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    v[j] = (float)((word >> (8 * j)) & 0xffu) - cr[(j0 + j) % 3];
  const __nv_bfloat162 p0 = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 p1 = __floats2bfloat162_rn(v[2], v[3]);
  lo = *reinterpret_cast<const uint32_t*>(&p0);
  hi = *reinterpret_cast<const uint32_t*>(&p1);
}

// raw bytes -> centered bf16 window; words outside the image are 0 (the
// padding stands for the centered value 0)
template <int VB>
__device__ __forceinline__ void center_window(const uint8_t* raw, __nv_bfloat16* win,
                                              const Tile& tl, const float (&c)[3], int H,
                                              int W) {
  using G = Geo<VB>;
  for (int i = threadIdx.x; i < kWinRows * G::kWords; i += kThreads) {
    const int r = i / G::kWords, k = i - r * G::kWords;
    int gb;
    const bool ok = word_in_image<VB>(tl, r, k, H, 3 * W, gb);
    // channel of the word's first byte: (k * VB - kPre) mod 3, VB = 1 mod 3
    const int ph = (k + 3 - Geo<VB>::kPre % 3) % 3;
    // c rotated by ph, by selects (a run-time index would put c in local memory)
    const float cr[3] = {ph == 0 ? c[0] : (ph == 1 ? c[1] : c[2]),
                         ph == 0 ? c[1] : (ph == 1 ? c[2] : c[0]),
                         ph == 0 ? c[2] : (ph == 1 ? c[0] : c[1])};
    uint8_t* dst = reinterpret_cast<uint8_t*>(win + r * G::kRow + k * VB);
    if constexpr (VB == 16) {
      uint4 o0 = make_uint4(0u, 0u, 0u, 0u), o1 = o0;
      if (ok) {
        const uint4 w = *reinterpret_cast<const uint4*>(raw + r * G::kRow + k * VB);
        center4(w.x, cr, 0, o0.x, o0.y);
        center4(w.y, cr, 4, o0.z, o0.w);
        center4(w.z, cr, 8, o1.x, o1.y);
        center4(w.w, cr, 12, o1.z, o1.w);
      }
      reinterpret_cast<uint4*>(dst)[0] = o0;
      reinterpret_cast<uint4*>(dst)[1] = o1;
    } else {
      uint2 o = make_uint2(0u, 0u);
      if (ok) center4(*reinterpret_cast<const uint32_t*>(raw + r * G::kRow + k * VB), cr, 0,
                      o.x, o.y);
      *reinterpret_cast<uint2*>(dst) = o;
    }
  }
}

__device__ __forceinline__ void stage_pair(__nv_bfloat16* st, int idx, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(st + idx) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void stage_pair(float* st, int idx, float a, float b) {
  *reinterpret_cast<float2*>(st + idx) = make_float2(a, b);
}

// pairs: (16, 16) uint32, pair q of output channel n (low half: K = 2q);
// bias (16) float32; center (3) float32 holding bf16-rounded values.
template <int VB, typename T>
__global__ void __launch_bounds__(kThreads, 3)
stem_kernel(const uint8_t* __restrict__ in, const uint32_t* __restrict__ pairs,
            const float* __restrict__ bias, const float* __restrict__ center,
            T* __restrict__ out, int H, int W, int Ho, int Wo, int tiles_x, int per_img,
            int n_tiles) {
  using G = Geo<VB>;
  extern __shared__ __align__(16) uint8_t stem_smem_buf[];
  uint8_t* raw0 = stem_smem_buf;  // raw window buffers raw0 and raw0 + kRawBytes
  __nv_bfloat16* win = reinterpret_cast<__nv_bfloat16*>(stem_smem_buf + 2 * G::kRawBytes);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  T* stage = reinterpret_cast<T*>(stem_smem_buf + 2 * G::kRawBytes + G::kWinBytes) +
             warp * 16 * kCout;

  int t = blockIdx.x;
  if (t >= n_tiles) return;
  copy_window<VB>(in, tile_of(t, tiles_x, per_img), raw0, H, W);

  const int g = lane >> 2, q4 = lane & 3;
  uint32_t bq[2][2][2];  // [k step][n tile][reg]
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      bq[ks][nt][0] = pairs[(ks * 8 + q4) * kCout + nt * 8 + g];
      bq[ks][nt][1] = pairs[(ks * 8 + q4 + 4) * kCout + nt * 8 + g];
    }
  float bs[2][2];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    bs[nt][0] = bias[nt * 8 + 2 * q4];
    bs[nt][1] = bias[nt * 8 + 2 * q4 + 1];
  }
  const float cen[3] = {center[0], center[1], center[2]};
  // the lane's pairs q = q4 + 4 i: offset of their first value from a
  // pixel's tap (0, 0, 0); pair 15 (zero weight) reads pair 0's values
  int off[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = q4 + 4 * i;
    off[i] = q < 15 ? (q / 5) * G::kRow + 2 * (q % 5) - 1 : -1;
  }

  for (int it = 0; t < n_tiles; t += gridDim.x, ++it) {
    const Tile tl = tile_of(t, tiles_x, per_img);
    const int tn = t + gridDim.x;
    if (tn < n_tiles)
      copy_window<VB>(in, tile_of(tn, tiles_x, per_img),
                       raw0 + ((it + 1) & 1) * G::kRawBytes, H, W);
    else
      asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();  // this tile's bytes have landed; the last tile's MMAs are done
    center_window<VB>(raw0 + (it & 1) * G::kRawBytes, win, tl, cen, H, W);
    __syncthreads();

    for (int s = warp; s < kSegs; s += kWarps) {
      const int ly = s / (kTileW / 16), lx0 = (s % (kTileW / 16)) * 16;
      const int oy = tl.oy0 + ly, ox = tl.ox0 + lx0;
      if (oy >= Ho || ox >= Wo) continue;  // uniform across the warp
      const __nv_bfloat16* p0 = win + 2 * ly * G::kRow + G::kPre + 6 * (lx0 + g);
      uint32_t a[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i][0] = *reinterpret_cast<const uint32_t*>(p0 + off[i]);
        a[i][1] = *reinterpret_cast<const uint32_t*>(p0 + 48 + off[i]);  // pixel g + 8
      }
      float acc[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[nt][j] = 0.0f;
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
          mma_bf16(acc[nt], a[2 * ks][0], a[2 * ks][1], a[2 * ks + 1][0], a[2 * ks + 1][1],
                   bq[ks][nt][0], bq[ks][nt][1]);
      }
      // lane holds pixels g and g + 8, channels nt * 8 + 2 q4 and + 1
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int ch = nt * 8 + 2 * q4;
        stage_pair(stage, g * kCout + ch, hardswish_bias(acc[nt][0], bs[nt][0]),
                   hardswish_bias(acc[nt][1], bs[nt][1]));
        stage_pair(stage, (g + 8) * kCout + ch, hardswish_bias(acc[nt][2], bs[nt][0]),
                   hardswish_bias(acc[nt][3], bs[nt][1]));
      }
      __syncwarp();
      // 16 pixels x 16 channels, contiguous in the output row
      constexpr int kUnits = 16 * kCout * (int)sizeof(T) / 16;
      T* orow = out + (((long long)tl.b * Ho + oy) * Wo + ox) * kCout;
#pragma unroll
      for (int u = lane; u < kUnits; u += 32) {
        const int px = u * 16 / (kCout * (int)sizeof(T));
        if (ox + px < Wo)
          reinterpret_cast<uint4*>(orow)[u] = reinterpret_cast<const uint4*>(stage)[u];
      }
      __syncwarp();
    }
  }
}

template <int VB, typename T>
int launch(const void* in, const void* pairs, const void* bias, const void* center, void* out,
           int B, int H, int W, int grid, int smem, cudaStream_t st) {
  if (smem < stem_smem<VB, T>()) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(stem_kernel<VB, T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int Ho = H / 2, Wo = W / 2;
  const int tiles_x = (Wo + kTileW - 1) / kTileW;
  const int per_img = tiles_x * ((Ho + kTileH - 1) / kTileH);
  stem_kernel<VB, T><<<grid, kThreads, smem, st>>>(
      (const uint8_t*)in, (const uint32_t*)pairs, (const float*)bias, (const float*)center,
      (T*)out, H, W, Ho, Wo, tiles_x, per_img, B * per_img);
  return (int)cudaGetLastError();
}

}  // namespace

// in (B, H, W, 3) uint8, H and W multiples of 8; vec_bytes 16 (W % 16 == 0,
// `in` 16-byte aligned) or 4 (`in` 4-byte aligned); pairs (16, 16) uint32,
// bias (16) and center (3) float32; out (B, H/2, W/2, 16) float32
// (out_bf16 == 0) or bfloat16, 16-byte aligned. grid and smem: the host's
// plan (stem_plan); smem must cover the kernel's layout.
extern "C" int mtg_fused_stem(const void* in, const void* pairs, const void* bias,
                              const void* center, void* out, int out_bf16, int B, int H, int W,
                              int vec_bytes, int grid, int smem, void* stream) {
  if ((H & 7) || (W & 7) || B < 1 || grid < 1) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)out & 15) || ((uintptr_t)in & (vec_bytes - 1)))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  if (vec_bytes == 16) {
    if (W & 15) return (int)cudaErrorInvalidValue;
    return out_bf16 ? launch<16, __nv_bfloat16>(in, pairs, bias, center, out, B, H, W, grid,
                                                smem, st)
                    : launch<16, float>(in, pairs, bias, center, out, B, H, W, grid, smem, st);
  }
  if (vec_bytes == 4)
    return out_bf16 ? launch<4, __nv_bfloat16>(in, pairs, bias, center, out, B, H, W, grid,
                                               smem, st)
                    : launch<4, float>(in, pairs, bias, center, out, B, H, W, grid, smem, st);
  return (int)cudaErrorInvalidValue;
}
