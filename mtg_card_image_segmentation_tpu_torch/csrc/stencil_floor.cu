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
// with y = bf16(bf16(x) @ bf16(w_exp)) accumulated in fp32, the terms summed
// in fp32 (in any order), and out = mean over channels.
//
// Bound on the H100 at the tool's shape (x (128,32,32,160) bf16, 960
// expanded channels, k5 d2): operations. Per expanded value 25 products at
// the packed bf16 rate (134 TFLOP/s) and 25 fp32 adds (67 TFLOP/s): 0.070 ms;
// the expand product is 40 GFLOP, 0.041 ms at 989 TFLOP/s; the bytes (42 MB
// of x, 0.7 MB of weights, 0.5 MB out) take 0.013 ms at 3.35 TB/s. `pass` is
// bounded by the product.
//
// What bounds this design (measured with clock64 phase marks, NVIDIA H100
// 80GB HBM3, 700 W): the copies of x and the term chain's MMAs.
//   - One CTA owns one whole image (one CTA per SM) and walks the expanded
//     channels in slices of kCS = 64. The image's y slice (H * W * 64 bf16,
//     128 KB at 32x32) stays in shared memory, so every halo row of the
//     dilated window is a row of the same tile, or zero outside the image:
//     no halo row is recomputed, and y never touches device memory.
//   - So x is copied in once per slice, 15 x 320 KB per SM at the tool's
//     shape. An SM takes it in at 10-12 bytes a clock whatever the copy
//     (cp.async, bulk copies, x hot in L2, two or four stages in flight, 64
//     or 128 of the 128 images): ~0.2 ms, over half of `pass`. The product itself is cheap: x comes in
//     by cp.async, in chunks of 128 pixels, double-buffered, laid out as the
//     8 x 8 core matrices wgmma reads (no swizzle); warpgroup wg multiplies
//     the chunk's pixels 32 wg .. + 31 by the slice's 64 channels with
//     `wgmma.mma_async m64n32k16`, A (the slice of w_exp rounded to bf16,
//     staged in the y tile's memory at the slice's start) in registers, B
//     (x) read from shared memory; channel chunks past cin stay zero, so
//     every chunk runs the same ten steps without a branch. Each warp's
//     A rows are channels 16 wq + 2g and + 1, so a lane's accumulators pair
//     up into the tile's bf16 channel pairs. The same product on mma.sync
//     fed by ldmatrix (four warps loading each x tile) took 25-28 % longer
//     in every mode. Running the chain band by band while the next slice's
//     chunks are multiplied into the rows no later band reads, x copied by
//     TMA, took 7 % off `pass`, 3 % off `arith` and nothing off `full` (a
//     chunk still took ~2,300 clocks with its x in place), so it is not kept.
//   - The term chain. A warp owns a strip of output pixels: 8 neighbouring
//     columns times 2 * kNP rows of one residue class mod the dilation,
//     walked two rows at a time. Lane (g, t) holds column g and channel pair
//     t of an 8-channel group and keeps that pair's k*k tap weights in
//     registers as bf16 pairs. Two tap columns at a time, it keeps the
//     (k + 1) x 2 window values the two rows need; the next two rows reuse
//     k - 1 rows of them. Each pair of terms is one `mul.rn.bf16x2` (the
//     exact product of two bf16 values rounded once to bf16: the reference's
//     bf16 * bf16). The rounded products are summed on the tensor cores: they
//     are the A fragment of an m16n8k16 `mma.sync` against a B of ones, row
//     g of A holding one pixel's products and row g + 8 the next pixel's, so
//     one MMA adds 256 terms into fp32; two accumulators per pair alternate.
//     That leaves about one issued instruction per term (the earlier chain
//     took about six); its ~100k MMAs per SM in `arith`, one per ~14 clocks
//     of an SM sub-partition at the measured time, likely set its pace.
//     Four pairs per strip saved 3 % in `full` but spilled registers.
//   - The tile stores each pixel's 8-channel chunks XOR-swizzled by the
//     column (chunk c of column x at c ^ (x & 7); W % 8 == 0, so also
//     c ^ (pixel & 7)), so the eight columns of a warp's chain load or
//     product store fall in eight bank groups, and a lane's word offset
//     within a row depends on its column alone.
//   - Per-pixel sums go to shared memory once per strip and slice, each
//     pixel owned by one warp, and are divided by the channel count at the
//     end: no atomics, the same bits every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

enum { kModePass = 0, kModeArith = 1, kModeFull = 2 };

constexpr int kCS = 64;          // expanded channels per slice
constexpr int kChunk = 128;      // pixels of x per staged chunk
constexpr int kWgN = kChunk / 4;  // pixels per warpgroup per chunk: wgmma n32
constexpr int kThreads = 512;    // 16 warps
constexpr int kWarps = kThreads / 32;
static_assert(kChunk / 8 == kWarps, "warp pg copies pixel group pg of a chunk");
constexpr int kNP = 2;           // pixel pairs per strip: 4 output rows
constexpr int kMaxKSteps = 10;   // cin <= 160: the A fragments live in registers
constexpr int kMaxK = 16 * kMaxKSteps;
constexpr int kWords = kCS / 2;  // 32-bit words per pixel of the y tile
constexpr int kStageLoads = 4;   // weight loads in flight per thread at a slice's start
constexpr uint32_t kOnes = 0x3F803F80u;  // bf16x2 (1, 1)
constexpr size_t kMaxSmem = 232448;      // 227 KB, one CTA per SM

struct Smem {
  size_t tile, xs, wdw, red, total;
};

__host__ __device__ inline size_t align128(size_t v) { return (v + 127) & ~(size_t)127; }

// the y tile (which also holds the slice of w_exp, kCS channel rows of
// cin + 8, at a slice's start), two x chunks, the slice's tap weights as bf16
// pairs, the per-pixel sums
__host__ __device__ inline Smem smem_layout(int H, int W, int cin, int k) {
  const size_t npix = (size_t)H * W;
  Smem s;
  size_t off = 0;
  s.tile = off;
  const size_t tile = npix * kCS * sizeof(bf16), bt = (size_t)kCS * (cin + 8) * sizeof(bf16);
  off += align128(tile > bt ? tile : bt);
  s.xs = off;
  off += align128((size_t)2 * kChunk * kMaxK * sizeof(bf16));
  s.wdw = off;
  off += align128((size_t)k * k * kWords * sizeof(uint32_t));
  s.red = off;
  off += align128(npix * sizeof(float));
  s.total = off;
  return s;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// shared-memory matrix descriptor, no swizzle: core matrices of 8 rows x 16
// bytes (128 contiguous bytes), `lbo` bytes apart along K, `sbo` along the rows
__device__ __forceinline__ uint64_t interleave_desc(const void* p, int lbo, int sbo) {
  uint64_t d = (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void fence_operand(float& x) { asm volatile("" : "+f"(x)::"memory"); }

// d[16] += A (64x16 bf16, registers) . B (16x32 bf16, shared, K-major), one warpgroup
__device__ __forceinline__ void wgmma_m64n32k16_rs(float (&d)[16], const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t hmul2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// word of channels 8q + 2t, + 1 of column col within a tile row
__device__ __forceinline__ int word_of(int col, int q, int t) {
  return col * kWords + ((q ^ (col & 7)) << 2) + t;
}

// One warp: the terms of channel group q for the strip of 2 * NP pixels of
// column col + g at rows row0 + j * dil (j = 0 .. 2 NP - 1), added into acc:
// acc[i][*][0] sums pixel row0 + 2i dil, acc[i][*][2] pixel row0 + (2i+1) dil
// (each over the four lanes of g). Two accumulators per pair alternate, so
// consecutive MMAs do not wait on each other. y is zero outside the image.
template <int K, int NP, int MODE>
__device__ __forceinline__ void chain_strip(const uint32_t* __restrict__ tile, int H, int W,
                                            int q, int col, int row0, int dil,
                                            const uint32_t (&w)[K * K],
                                            float (&acc)[NP][2][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int c = col + g, row_words = W * kWords;
  constexpr int P = (K - 1) / 2, KK = K * K, NC = (MODE == kModeFull) ? K : 1;
  int off[NC];  // a window column's word within a row; -1 outside the image
#pragma unroll
  for (int kx = 0; kx < NC; ++kx) {
    const int cc = (MODE == kModeFull) ? c + (kx - P) * dil : c;
    off[kx] = (unsigned)cc < (unsigned)W ? word_of(cc, q, t) : -1;
  }
  auto ld = [&](int r, int kx) -> uint32_t {
    return ((unsigned)r < (unsigned)H && off[kx] >= 0) ? tile[r * row_words + off[kx]] : 0u;
  };
  if constexpr (MODE == kModeFull) {
    // two tap columns at a time: their (k + 1) x 2 window values in registers
#pragma unroll
    for (int kx0 = 0; kx0 < K; kx0 += 2) {
      const int ncol = kx0 + 1 < K ? 2 : 1, nt = K * ncol;
      uint32_t win[K + 1][2];  // rows row0 + (2i + j - P) dil, j = 0 .. K
#pragma unroll
      for (int i = 0; i < NP; ++i) {
#pragma unroll
        for (int j = 0; j <= K; ++j) {
          if (i > 0 && j < K - 1) {
            win[j][0] = win[j + 2][0];
            win[j][1] = win[j + 2][1];
          } else {
            const int r = row0 + (2 * i + j - P) * dil;
#pragma unroll
            for (int u = 0; u < ncol; ++u) win[j][u] = ld(r, kx0 + u);
          }
        }
        // taps (ky, kx0 + u), e = ky * ncol + u, two per MMA
#pragma unroll
        for (int m = 0; m < (nt + 1) / 2; ++m) {
          const int e0 = 2 * m, e1 = 2 * m + 1;
          const int y0 = e0 / ncol, u0 = e0 % ncol, y1 = e1 / ncol, u1 = e1 % ncol;
          const uint32_t w0 = w[y0 * K + kx0 + u0];
          const uint32_t a0 = hmul2(win[y0][u0], w0), a1 = hmul2(win[y0 + 1][u0], w0);
          uint32_t a2 = 0u, a3 = 0u;
          if (e1 < nt) {
            const uint32_t w1 = w[y1 * K + kx0 + u1];
            a2 = hmul2(win[y1][u1], w1);
            a3 = hmul2(win[y1 + 1][u1], w1);
          }
          mma_bf16(acc[i][m & 1], a0, a1, a2, a3, kOnes, kOnes);
        }
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int r0 = row0 + 2 * i * dil;
      const uint32_t c0 = ld(r0, 0), c1 = ld(r0 + dil, 0);
      if constexpr (MODE == kModePass) {
        mma_bf16(acc[i][0], c0, c1, 0u, 0u, kOnes, kOnes);
      } else {
#pragma unroll
        for (int m = 0; m < (KK + 1) / 2; ++m) {
          const int t0 = 2 * m, t1 = 2 * m + 1;
          const uint32_t a0 = hmul2(c0, w[t0]), a1 = hmul2(c1, w[t0]);
          const uint32_t a2 = t1 < KK ? hmul2(c0, w[t1]) : 0u;
          const uint32_t a3 = t1 < KK ? hmul2(c1, w[t1]) : 0u;
          mma_bf16(acc[i][m & 1], a0, a1, a2, a3, kOnes, kOnes);
        }
      }
    }
  }
}

template <int K, int MODE>
__global__ void __launch_bounds__(kThreads, 1)
stencil_floor_kernel(const bf16* __restrict__ x, const float* __restrict__ w_exp,
                     const float* __restrict__ w_dw, float* __restrict__ out,
                     int H, int W, int cin, int cexp, int dil) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int KK = K * K;
  const Smem L = smem_layout(H, W, cin, K);
  uint32_t* tile = reinterpret_cast<uint32_t*>(smem + L.tile);
  bf16* bt = reinterpret_cast<bf16*>(smem + L.tile);  // w_exp slice as B^T, at a slice's start
  bf16* xs = reinterpret_cast<bf16*>(smem + L.xs);
  uint32_t* wdw = reinterpret_cast<uint32_t*>(smem + L.wdw);
  float* red = reinterpret_cast<float*>(smem + L.red);

  const int b = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int npix = H * W, ldx = cin + 8, nks = cin / 16, nc8 = cin / 8, quads = (nc8 + 3) / 4;
  // chunk core matrices (pixel group pg, channel chunk c) at pg * kSbo + c * 128 bytes
  constexpr int kSbo = 8 * kMaxK * (int)sizeof(bf16);
  const int nchunks = (npix + kChunk - 1) / kChunk, nslices = cexp / kCS;
  const int total_chunks = nslices * nchunks;
  const bf16* xb = x + (size_t)b * npix * cin;

  // x chunk n (chunks of all slices in order) into buffer n & 1, as 8 x 8
  // core matrices (pixel group pg, channel chunk c at pg * kSbo + c * 128
  // bytes, a pixel's 16 bytes at 16 * (pixel & 7)), the layout wgmma reads;
  // pixels past the image are zero-filled. Warp pg copies pixel group pg, 8
  // pixels x 4 chunks at a time: 64 bytes of each of 8 rows in device
  // memory, four whole 128-byte core matrices in shared memory.
  auto load_chunk = [&](int n) {
    if (n < total_chunks) {
      const int pix0 = (n % nchunks) * kChunk, r = warp * 8 + (lane & 7);
      const bool ok = pix0 + r < npix;
      const bf16* src = xb + (size_t)(ok ? pix0 + r : 0) * cin;
      const uint32_t dst = smem_u32(xs + (n & 1) * kChunk * kMaxK) + warp * kSbo + (lane & 7) * 16;
      for (int qd = 0; qd < quads; ++qd) {
        const int c = qd * 4 + (lane >> 3);
        if (c < nc8) cp_async16(dst + c * 128, src + c * 8, ok ? 16 : 0);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  // channel chunks past cin stay zero in both buffers, so every chunk runs
  // kMaxKSteps wgmma steps without a branch
  for (int i = tid; i < 2 * kChunk / 8 * (kMaxK / 8 - nc8) * 8; i += kThreads) {
    const int row = i & 7, cm = i >> 3, per = kMaxK / 8 - nc8;
    const int blk = cm / per, c = nc8 + cm - blk * per;
    *reinterpret_cast<uint4*>(reinterpret_cast<unsigned char*>(xs) + blk * kSbo + c * 128 +
                              row * 16) = make_uint4(0, 0, 0, 0);
  }

  for (int i = tid; i < npix; i += kThreads) red[i] = 0.0f;
  load_chunk(0);

  // product roles: warpgroup wg makes pixels 32 wg .. + 31 of a chunk; its
  // warp wq the channels 16 wq .. + 15, A rows g and g + 8 being channels
  // 16 wq + 2g and + 1, so a lane's accumulators pair up into bf16 pairs
  const int wg = warp >> 2, wq = warp & 3;
  // chain tasks: (strip, column group of 8); a strip is 2 kNP rows of one
  // residue class mod dil
  const int per_res = (H + dil - 1) / dil;
  const int strips = dil * ((per_res + 2 * kNP - 1) / (2 * kNP));
  const int ncg = (W + 7) / 8, ntasks = strips * ncg;

  int n = 0;  // chunk counter over all slices
  for (int s = 0; s < nslices; ++s) {
    const int c0 = s * kCS;
    __syncthreads();  // the previous slice's chain is done with the tile and wdw
    // the slice of w_exp rounded to bf16, as channel rows of cin + 8 (bf16
    // pairs of k, k + 1); a warp stores 8 channels x 4 k-pairs, 32 banks
    for (int base = tid; base < cin / 2 * kCS; base += kThreads * kStageLoads) {
      float2 v[kStageLoads];
#pragma unroll
      for (int u = 0; u < kStageLoads; ++u) {
        const int i = base + u * kThreads, wi = i >> 5;
        const int c = (wi & 7) * 8 + (i & 7), k = 2 * ((wi >> 3) * 4 + ((i >> 3) & 3));
        if (i < cin / 2 * kCS) {
          v[u].x = w_exp[(size_t)k * cexp + c0 + c];
          v[u].y = w_exp[(size_t)(k + 1) * cexp + c0 + c];
        }
      }
#pragma unroll
      for (int u = 0; u < kStageLoads; ++u) {
        const int i = base + u * kThreads, wi = i >> 5;
        const int c = (wi & 7) * 8 + (i & 7), k = 2 * ((wi >> 3) * 4 + ((i >> 3) & 3));
        if (i < cin / 2 * kCS)
          reinterpret_cast<uint32_t*>(bt)[(c * ldx + k) >> 1] = pack_bf16(v[u].x, v[u].y);
      }
    }
    if (MODE != kModePass) {
      // the tap weights as the reference uses them: rounded to bf16, in pairs
      for (int base = tid; base < KK * kWords; base += kThreads * kStageLoads) {
        float2 v[kStageLoads];
#pragma unroll
        for (int u = 0; u < kStageLoads; ++u) {
          const int i = base + u * kThreads, tap = i / kWords;
          if (i < KK * kWords)
            v[u] = *reinterpret_cast<const float2*>(w_dw + (size_t)tap * cexp + c0 +
                                                    2 * (i - tap * kWords));
        }
#pragma unroll
        for (int u = 0; u < kStageLoads; ++u) {
          const int i = base + u * kThreads;
          if (i < KK * kWords) wdw[i] = pack_bf16(v[u].x, v[u].y);
        }
      }
    }
    __syncthreads();
    uint32_t aw[kMaxKSteps][4];  // this warp's A fragments (channel rows), per k step
#pragma unroll
    for (int ks = 0; ks < kMaxKSteps; ++ks) {
      if (ks < nks) {
        const int m = lane >> 3, c = 16 * wq + 2 * (lane & 7) + (m & 1);
        ldmatrix_x4(aw[ks], bt + c * ldx + ks * 16 + (m >> 1) * 8);
      } else {
        aw[ks][0] = aw[ks][1] = aw[ks][2] = aw[ks][3] = 0u;
      }
    }
    // ---- y slice = x @ w_exp[:, c0:c0+kCS], chunk by chunk ---------------
    for (int ch = 0; ch < nchunks; ++ch, ++n) {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      // the chunk's bytes, written through the generic proxy, become visible
      // to wgmma's reads
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      // chunk n is in for every thread, every warpgroup's wgmma on the other
      // buffer has completed, and (in the first chunk) every warp holds its
      // A fragments before y overwrites the staged w_exp
      __syncthreads();
      load_chunk(n + 1);
      const uint64_t desc = interleave_desc(
          reinterpret_cast<const unsigned char*>(xs + (n & 1) * kChunk * kMaxK) +
              wg * (kWgN / 8) * kSbo, 128, kSbo);
      float acc[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        acc[e] = 0.0f;
        fence_operand(acc[e]);
      }
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kMaxKSteps; ++ks)
        wgmma_m64n32k16_rs(acc, aw[ks], desc + 16 * ks);  // + 256 bytes along K
      wgmma_commit();
      wgmma_wait0();
#pragma unroll
      for (int e = 0; e < 16; ++e) fence_operand(acc[e]);
      // acc[4j + h]: channel 16 wq + 2g at pixel 8j + 2t + h of the
      // warpgroup's 32; acc[4j + 2 + h]: channel 16 wq + 2g + 1
#pragma unroll
      for (int j = 0; j < kWgN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int pix = ch * kChunk + wg * kWgN + 8 * j + 2 * t + h;
          // W % 8 == 0: the pixel's column & 7 is pix & 7
          if (pix < npix)
            tile[pix * kWords + (((2 * wq + (g >> 2)) ^ (pix & 7)) << 2) + (g & 3)] =
                pack_bf16(acc[4 * j + h], acc[4 * j + 2 + h]);
        }
    }
    __syncthreads();  // the y slice is complete

    // ---- term chain -------------------------------------------------------
    for (int task = warp; task < ntasks; task += kWarps) {
      const int cg = task % ncg, st = task / ncg;
      const int row0 = st % dil + dil * (2 * kNP * (st / dil));
      float acc[kNP][2][4];
#pragma unroll
      for (int i = 0; i < kNP; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][0][e] = acc[i][1][e] = 0.0f;
      for (int q = 0; q < kCS / 8; ++q) {
        uint32_t w[KK];
#pragma unroll
        for (int tap = 0; tap < KK; ++tap)
          w[tap] = (MODE == kModePass) ? kOnes : wdw[tap * kWords + q * 4 + t];
        chain_strip<K, kNP, MODE>(tile, H, W, q, cg * 8, row0, dil, w, acc);
      }
      const int col = cg * 8 + g;
      if (t == 0 && col < W) {
#pragma unroll
        for (int i = 0; i < kNP; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = row0 + (2 * i + h) * dil;
            // this warp alone owns (row, col)
            if (row < H) red[row * W + col] += acc[i][0][2 * h] + acc[i][1][2 * h];
          }
      }
    }
  }
  __syncthreads();
  for (int pix = tid; pix < npix; pix += kThreads)
    out[(size_t)b * npix + pix] = red[pix] / (float)cexp;
}

template <int K, int MODE>
int launch(const void* x, const void* w_exp, const void* w_dw, void* out, int B, int H, int W,
           int cin, int cexp, int dil, cudaStream_t stream) {
  const size_t smem = smem_layout(H, W, cin, K).total;
  const cudaError_t e = cudaFuncSetAttribute(
      stencil_floor_kernel<K, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  stencil_floor_kernel<K, MODE><<<B, kThreads, smem, stream>>>(
      (const bf16*)x, (const float*)w_exp, (const float*)w_dw, (float*)out, H, W, cin, cexp, dil);
  return (int)cudaGetLastError();
}

template <int K>
int launch_mode(const void* x, const void* w_exp, const void* w_dw, void* out, int B, int H,
                int W, int cin, int cexp, int dil, int mode, cudaStream_t s) {
  if (mode == kModePass) return launch<K, kModePass>(x, w_exp, w_dw, out, B, H, W, cin, cexp, dil, s);
  if (mode == kModeArith) return launch<K, kModeArith>(x, w_exp, w_dw, out, B, H, W, cin, cexp, dil, s);
  return launch<K, kModeFull>(x, w_exp, w_dw, out, B, H, W, cin, cexp, dil, s);
}

}  // namespace

// shared-memory bytes of one CTA (the plan's `smem_bytes`)
extern "C" int mtg_stencil_floor_smem(int H, int W, int cin, int k) {
  return (int)smem_layout(H, W, cin, k).total;
}

// x (B, H, W, cin) bf16, w_exp (cin, cexp) f32, w_dw (k*k, cexp) f32 ->
// out (B, H, W, 1) f32. One launch, one CTA per image.
extern "C" int mtg_stencil_floor(const void* x, const void* w_exp, const void* w_dw,
                                 void* out, int B, int H, int W, int cin, int cexp,
                                 int k, int dil, int mode, void* stream) {
  if (mode < kModePass || mode > kModeFull) return (int)cudaErrorInvalidValue;
  if (B <= 0 || H <= 0 || W <= 0 || W % 8 != 0 || cin <= 0 || cin % 16 != 0 || cin > 16 * kMaxKSteps ||
      cexp <= 0 || cexp % kCS != 0 || (k != 3 && k != 5) || dil < 1 ||
      smem_layout(H, W, cin, k).total > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (k == 3) return launch_mode<3>(x, w_exp, w_dw, out, B, H, W, cin, cexp, dil, mode, s);
  return launch_mode<5>(x, w_exp, w_dw, out, B, H, W, cin, cexp, dil, mode, s);
}
