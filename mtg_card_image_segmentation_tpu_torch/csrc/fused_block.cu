// MobileNetV3 inverted-residual block (folded BN) as four kernels:
//   K1 pw_gemm      1x1 expand: bf16 GEMM, fp32 accumulate, + bias, act
//   K2 depthwise    k x k depthwise (any odd k; 3 and 5 unrolled) at any
//                   dilation, stride 1 or 2, + bias, act, and the
//                   per-(image, channel) SE sums
//   K3 se_gate      SE fc1 + ReLU -> fc2 -> hard-sigmoid, fp32, -> bf16 gate
//   K4 pw_gemm      1x1 project with the gate applied to A in registers,
//                   + bias (+ residual)
//
// Replaces: mtg_card_image_segmentation_tpu/ops/pallas/fused_block.py::
// fused_inverted_residual (one block) and ::fused_tail_chain (blocks 12-14
// as one kernel). The TPU kernel keeps the whole per-image map in VMEM;
// here one image's 32x32x960 bf16 expanded map (1.9 MB) is far beyond the
// 227 KB of shared memory, and the SE gate needs each image's full spatial
// mean before the project step, so one block cannot stream over spatial
// tiles. This is design (b): the expanded and depthwise maps go through
// HBM in bf16, with the SE sums made by the depthwise kernel.
//
// Bound on the H100 at the serving tail (b128, 32x32, widths 112/672/160,
// 160/960/160 x2): operations, ~0.26 ms (~209 GFLOP of 1x1 GEMMs, 0.21 ms
// at 989 TFLOP/s bf16; ~17 GFLOP of depthwise + SE, 0.26 ms at 67 TFLOP/s
// fp32). Design (b) has its own byte floor: K1 reads 29 + 42 + 42 MB and
// writes 176 + 252 + 252 MB, K2 reads and writes those maps again, K4 reads
// them with the float32 residuals and writes 84 + 84 + 42 MB (+ 42 + 42 MB of
// bf16 copies, see K4): ~3.3 GB, ~1.0 ms at 3.35 TB/s.
//
// K1/K4 are byte-bound, not compute-bound (K = 160, N = 960 and K = 960,
// N = 160 do ~137 flop per byte, under the card's ridge of ~295), so the
// GEMM is built to stream:
//   - a persistent grid: one CTA per SM walks output tiles of 128 rows x BN
//     columns, BN = 80, 160 or 240 from the host's plan (ops/kernels/
//     fused_block.py::gemm_plan), so the project's N = 160 is one tile and A
//     is read once; 672 and 960 take 3 and 4 tiles;
//   - one producer warp keeps a ring of 128x64 A tiles (and BNx64 B tiles)
//     in flight with TMA loads (128-byte swizzle, zero fill past M, N and K:
//     a K of 472 or 24 needs no special case), completion on mbarriers. When
//     an n tile's whole B panel fits beside the ring (the expand GEMMs, K =
//     112 or 160), it is loaded once per CTA and stays; the CTA then keeps
//     its n tile and only A streams. The ring is as deep as shared memory
//     allows (5-8 stages);
//   - two consumer warpgroups (64 rows each) load their A fragments from
//     shared memory with ldmatrix and issue wgmma.mma_async m64n80k16 with A
//     from registers and B from shared memory, fp32 accumulators in
//     registers. A in registers is what lets K4 apply the SE gate on the way
//     (one __hmul2 per bf16 pair: a bf16 x bf16 product is exact in fp32, so
//     the rounded product is the reference's bf16(y * gate)); a tile's rows
//     may belong to two images (300 rows per image at the server's 20x15);
//   - the epilogue adds the bias and the act in registers. A plain bf16
//     output (K1) is rounded into a 64x80 tile per warpgroup and written by
//     a TMA store that runs on while the next chunk is made (two tiles per
//     warpgroup, one in flight). Otherwise (K4: float32 output, residual,
//     bf16 copy) a 64x80 fp32 staging tile per warpgroup is stored as whole
//     row segments (16 bytes fp32 or 8 bytes bf16 per lane, the residual
//     read the same way). Pairs of columns stored straight from the
//     accumulator layout (a quad of lanes writing 16 bytes of each of 8
//     rows) were several times slower. One TMA-store epilogue for every
//     output (float32 tile + bf16 copy, residual added in registers) made
//     nvcc spill at BN = 240 and slowed the expand several-fold; keeping one
//     wgmma group in flight across k tiles (two sets of A fragment
//     registers) was slower too. Neither is kept.
// Chain blocks 13-14 take the float32 value between blocks as their
// residual and its bf16 rounding as K1's A: the previous K4 writes that bf16
// copy beside its float32 output (42 MB more written, 42 MB less read by
// K1), so A is always bf16 in device memory.
//
// K2 (depthwise): each term of the reference is the bf16-rounded product,
// accumulated in fp32. The products are made two channels at a time with
// __hmul2 on bf16x2 (exact product, one rounding: bit-equal to the
// reference's bf16 multiply), unpacked with a shift or a mask (a bf16 is
// the high half of its float32) and added in fp32 in the reference's tap
// order (columns outer, rows inner). The tap weights are read from shared
// memory as bf16x2: held in registers (8 channels x 25 taps = 100 of them)
// they took the kernel to 255 registers and one CTA per SM, which was
// slower.
//
// Numerics otherwise follow the TPU kernel: bf16 GEMM inputs with fp32
// accumulation; the SE runs in fp32 and its gate is rounded to bf16; the
// residual is added in fp32.

#include <cuda.h>  // CUtensorMap and its enums (cuTensorMapEncodeTiled is looked up at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

enum { kActNone = 0, kActRelu = 1, kActHardswish = 2 };

__device__ __forceinline__ float act_fn(float x, int act) {
  if (act == kActRelu) return fmaxf(x, 0.0f);
  // times float32(1/6), as torch's CUDA division by a scalar does
  if (act == kActHardswish) return x * fminf(fmaxf(x + 3.0f, 0.0f), 6.0f) * (1.0f / 6.0f);
  return x;
}

__device__ __forceinline__ uint32_t bf162_bits(__nv_bfloat162 v) {
  return (uint32_t)__bfloat16_as_ushort(v.x) | ((uint32_t)__bfloat16_as_ushort(v.y) << 16);
}

// two bf16 products with one rounding each (a bf16 x bf16 product is exact
// in fp32, so this equals rounding the fp32 product), packed as bf16x2
__device__ __forceinline__ uint32_t hmul2_bits(uint32_t a, uint32_t b) {
  const __nv_bfloat162 x = __halves2bfloat162(__ushort_as_bfloat16((unsigned short)(a & 0xffffu)),
                                              __ushort_as_bfloat16((unsigned short)(a >> 16)));
  const __nv_bfloat162 y = __halves2bfloat162(__ushort_as_bfloat16((unsigned short)(b & 0xffffu)),
                                              __ushort_as_bfloat16((unsigned short)(b >> 16)));
  return bf162_bits(__hmul2(x, y));
}

// acc[j], acc[j + 1] += the two bf16 of a packed pair (a bf16 is the high
// half of its float32), fp32 adds with no contraction
__device__ __forceinline__ void add_terms(float* acc, uint32_t pair, int j) {
  acc[j] = __fadd_rn(acc[j], __uint_as_float(pair << 16));
  acc[j + 1] = __fadd_rn(acc[j + 1], __uint_as_float(pair & 0xffff0000u));
}

// ---------------------------------------------------------------------------
// PTX helpers: mbarriers, TMA, ldmatrix, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// spins until the phase of the given parity has completed; a wait that
// outlasts ~10 s of clocks traps (a launch error) instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long t0 = clock64();
  uint32_t done = 0;
  do {
    if (clock64() - t0 > 20000000000LL) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// a (box) tile at element coordinates (c0 along the row, c1 across rows)
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// shared-memory matrix descriptor: K-major rows of 128 bytes, 128-byte
// swizzle, 8-row groups 1024 bytes apart (the layout TMA writes with
// CU_TENSOR_MAP_SWIZZLE_128B and a 64-element bf16 box row)
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  uint64_t d = (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4);
  d |= (uint64_t)1 << 16;             // leading byte offset (unused here)
  d |= (uint64_t)(1024 >> 4) << 32;   // stride byte offset
  d |= (uint64_t)1 << 62;             // 128-byte swizzle
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
__device__ __forceinline__ void fence_operand(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}

// d[40] += A (64x16 bf16, registers) . B (16x80 bf16, shared, K-major, 128-byte
// swizzle), one warpgroup
__device__ __forceinline__ void wgmma_m64n80k16_rs(float* d, const uint32_t* a,
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// ---------------------------------------------------------------------------
// K1 / K4: out[M, N] = act(A[M, K] (x gate) @ Bt[N, K]^T + bias) (+ res).
// A and Bt bf16, row-major, K a multiple of 8 (16-byte rows for TMA).
// ---------------------------------------------------------------------------

constexpr int kBM = 128, kBK = 64, kNI = 80;
constexpr int kConsumerWarps = 8;  // two warpgroups of 64 rows
constexpr int kGemmThreads = (kConsumerWarps + 1) * 32;
constexpr int kStgStride = kNI + 8;  // fp32 staging row: conflict-free float2 writes
constexpr size_t kSmemLimit = 227 * 1024;

struct GemmArgs {
  const float* bias;
  const bf16* gate;  // (images, K) or null
  int rows_per_image;
  const void* res;   // (M, N) or null
  int res_f32;
  void* out;         // (M, N)
  int out_f32;
  bf16* out_copy;    // (M, N) bf16 rounding of out, or null
  int M, N, K, act;
  int stages;        // depth of the ring
};

// kResident: the CTA keeps one n tile's whole B panel in shared memory
// (loaded once) and streams only A; CTA c takes n tile c % n_tiles and every
// (gridDim.x / n_tiles)-th m tile from c / n_tiles. Otherwise A and B tiles
// stream through the ring and CTA c takes every gridDim.x-th output tile.
template <int BN, bool kGate, bool kResident, bool kTmaStore>
__global__ void __launch_bounds__(kGemmThreads, 1)
pw_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
               const __grid_constant__ CUtensorMap map_b,
               const __grid_constant__ CUtensorMap map_out, const GemmArgs p) {
  constexpr int NJ = BN / kNI;
  const int stages = p.stages;
  const int n_tiles = (p.N + BN - 1) / BN;
  const int m_tiles = (p.M + kBM - 1) / kBM;
  const int k_tiles = (p.K + kBK - 1) / kBK;
  extern __shared__ unsigned char gemm_smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(gemm_smem_raw) + 1023) & ~(uintptr_t)1023);
  bf16* Bs = As + stages * kBM * kBK;
  float* staging = reinterpret_cast<float*>(Bs + (kResident ? k_tiles : stages) * BN * kBK);
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + 2 * 64 * kStgStride);
  uint64_t* empty = full + stages;
  uint64_t* panel = empty + stages;  // the resident B panel has landed

  // the launch's shared bytes come from the host's plan (ops/kernels/
  // fused_block.py::gemm_smem, the one copy of the formula): a plan short of
  // this layout traps here instead of writing past the allocation
  if (threadIdx.x == 0) {
    uint32_t dyn;
    asm volatile("mov.u32 %0, %%dynamic_smem_size;\n" : "=r"(dyn));
    if (reinterpret_cast<unsigned char*>(panel + 1) - gemm_smem_raw > (long)dyn) __trap();
  }

  // the CTA's tiles: it = first, first + step, ... < count
  const int first = kResident ? blockIdx.x / n_tiles : blockIdx.x;
  const int step = kResident ? gridDim.x / n_tiles : gridDim.x;
  const int count = kResident ? m_tiles : m_tiles * n_tiles;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_init(panel, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // producer: one lane issues every TMA load
    if (lane == 0) {
      if (kResident) {
        const int n0 = (blockIdx.x % n_tiles) * BN;
        mbar_expect_tx(panel, k_tiles * BN * kBK * sizeof(bf16));
        for (int kt = 0; kt < k_tiles; ++kt)
          tma_load_2d(Bs + kt * BN * kBK, &map_b, kt * kBK, n0, panel);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int it = first; it < count; it += step) {
        const int m0 = (kResident ? it : it / n_tiles) * kBM;
        const int n0 = (kResident ? blockIdx.x : it) % n_tiles * BN;
        for (int kt = 0; kt < k_tiles; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], (kBM + (kResident ? 0 : BN)) * kBK * sizeof(bf16));
          tma_load_2d(As + stage * kBM * kBK, &map_a, kt * kBK, m0, &full[stage]);
          if (!kResident)
            tma_load_2d(Bs + stage * BN * kBK, &map_b, kt * kBK, n0, &full[stage]);
          if (++stage == stages) { stage = 0; phase ^= 1; }
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the tile,
    // warp wq of it rows 16 wq .. 16 wq + 15; lane holds rows g and g + 8
    const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, t = lane & 3;
    const int frag_row = 64 * wg + 16 * wq + (lane & 7) + ((lane >> 3) & 1) * 8;
    const int frag_chunk = lane >> 4;
    int stage = 0;
    uint32_t phase = 0;
    float acc[NJ][40];
    int nstore = 0;  // TMA stores issued by this warpgroup
    if (kResident) mbar_wait(panel, 0);
    for (int it = first; it < count; it += step) {
      const int m0 = (kResident ? it : it / n_tiles) * kBM;
      const int n0 = (kResident ? blockIdx.x : it) % n_tiles * BN;
      const int ra = m0 + 64 * wg + 16 * wq + g, rb = ra + 8;
      const bf16* ga = nullptr;
      const bf16* gb = nullptr;
      if (kGate) {
        ga = p.gate + (size_t)(min(ra, p.M - 1) / p.rows_per_image) * p.K;
        gb = p.gate + (size_t)(min(rb, p.M - 1) / p.rows_per_image) * p.K;
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 40; ++e) {
          acc[j][e] = 0.0f;
          fence_operand(acc[j][e]);
        }
      for (int kt = 0; kt < k_tiles; ++kt) {
        mbar_wait(&full[stage], phase);
        const unsigned char* at =
            reinterpret_cast<const unsigned char*>(As + stage * kBM * kBK) + frag_row * 128;
        uint32_t a[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          ldmatrix_x4(a[kk], at + (((2 * kk + frag_chunk) ^ (frag_row & 7)) << 4));
        if (kGate) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const int k = kt * kBK + kk * 16 + 2 * t;  // K % 8 == 0: k < K covers k + 1
            uint32_t g0 = 0, g1 = 0, g2 = 0, g3 = 0;
            if (k < p.K) {
              g0 = __ldg(reinterpret_cast<const unsigned int*>(ga + k));
              g1 = __ldg(reinterpret_cast<const unsigned int*>(gb + k));
            }
            if (k + 8 < p.K) {
              g2 = __ldg(reinterpret_cast<const unsigned int*>(ga + k + 8));
              g3 = __ldg(reinterpret_cast<const unsigned int*>(gb + k + 8));
            }
            a[kk][0] = hmul2_bits(a[kk][0], g0);
            a[kk][1] = hmul2_bits(a[kk][1], g1);
            a[kk][2] = hmul2_bits(a[kk][2], g2);
            a[kk][3] = hmul2_bits(a[kk][3], g3);
          }
        }
        const bf16* bt = Bs + (kResident ? kt : stage) * BN * kBK;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int j = 0; j < NJ; ++j)
            wgmma_m64n80k16_rs(acc[j], a[kk], sw128_desc(bt + j * kNI * kBK) + 2 * kk);
        wgmma_commit();
        wgmma_wait0();
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 40; ++e) fence_operand(acc[j][e]);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[stage]);
        if (++stage == stages) { stage = 0; phase ^= 1; }
      }

      const int wtid = threadIdx.x & 127;
      if constexpr (kTmaStore) {
        // bf16 output, no residual: the warpgroup rounds act(acc + bias) into
        // one of its two 64x80 bf16 tiles and one lane hands it to a TMA
        // store (clipped at M and N), which runs on while the next chunk or
        // tile is made; a tile is written again only once its store has read it
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          bf16* buf = reinterpret_cast<bf16*>(staging) + (2 * wg + (nstore & 1)) * 64 * kNI;
          if (wtid == 0) asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
          asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
#pragma unroll
          for (int i = 0; i < kNI / 8; ++i) {
            const int lc = 8 * i + 2 * t, col = n0 + j * kNI + lc;
            const float2 bv = col < p.N ? __ldg(reinterpret_cast<const float2*>(p.bias + col))
                                        : make_float2(0.0f, 0.0f);
#pragma unroll
            for (int h = 0; h < 2; ++h)
              *reinterpret_cast<__nv_bfloat162*>(buf + (16 * wq + g + 8 * h) * kNI + lc) =
                  __floats2bfloat162_rn(act_fn(acc[j][4 * i + 2 * h] + bv.x, p.act),
                                        act_fn(acc[j][4 * i + 2 * h + 1] + bv.y, p.act));
          }
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
          if (wtid == 0) {  // hand the tile to TMA
            asm volatile(
                "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n"
                ::"l"(reinterpret_cast<uint64_t>(&map_out)), "r"(smem_u32(buf)),
                "r"(n0 + j * kNI), "r"(m0 + 64 * wg)
                : "memory");
            asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
          }
          ++nstore;
        }
      } else {
        // epilogue, 80 columns at a time: the warpgroup writes act(acc + bias)
        // to its fp32 staging tile (d[4i + (0,1)] is row g, cols 8i + 2t, +1;
        // d[4i + (2,3)] row g + 8), then stores rows of it with the residual
        // added, 16 bytes (fp32) or 8 bytes (bf16) per lane, neighbouring lanes
        // on neighbouring columns
        float* stg = staging + wg * 64 * kStgStride;
  #pragma unroll
        for (int j = 0; j < NJ; ++j) {
  #pragma unroll
          for (int i = 0; i < kNI / 8; ++i) {
            const int lc = 8 * i + 2 * t, col = n0 + j * kNI + lc;
            const float2 bv = col < p.N ? __ldg(reinterpret_cast<const float2*>(p.bias + col))
                                        : make_float2(0.0f, 0.0f);
  #pragma unroll
            for (int h = 0; h < 2; ++h)
              *reinterpret_cast<float2*>(stg + (16 * wq + g + 8 * h) * kStgStride + lc) =
                  make_float2(act_fn(acc[j][4 * i + 2 * h] + bv.x, p.act),
                              act_fn(acc[j][4 * i + 2 * h + 1] + bv.y, p.act));
          }
          asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
          for (int u = wtid; u < 64 * (kNI / 4); u += 128) {
            const int r = u / (kNI / 4), lc = 4 * (u % (kNI / 4));
            const int row = m0 + 64 * wg + r, col = n0 + j * kNI + lc;
            if (row >= p.M || col >= p.N) continue;  // N % 8 == 0: col < N covers col + 3
            float4 v = *reinterpret_cast<const float4*>(stg + r * kStgStride + lc);
            const size_t off = (size_t)row * p.N + col;
            if (p.res != nullptr) {
              if (p.res_f32) {
                const float4 rv = *reinterpret_cast<const float4*>(
                    static_cast<const float*>(p.res) + off);
                v.x += rv.x; v.y += rv.y; v.z += rv.z; v.w += rv.w;
              } else {
                const uint2 rv = *reinterpret_cast<const uint2*>(
                    static_cast<const bf16*>(p.res) + off);
                v.x += __uint_as_float(rv.x << 16);
                v.y += __uint_as_float(rv.x & 0xffff0000u);
                v.z += __uint_as_float(rv.y << 16);
                v.w += __uint_as_float(rv.y & 0xffff0000u);
              }
            }
            const uint2 vb = make_uint2(bf162_bits(__floats2bfloat162_rn(v.x, v.y)),
                                        bf162_bits(__floats2bfloat162_rn(v.z, v.w)));
            if (p.out_f32)
              *reinterpret_cast<float4*>(static_cast<float*>(p.out) + off) = v;
            else
              *reinterpret_cast<uint2*>(static_cast<bf16*>(p.out) + off) = vb;
            if (p.out_copy != nullptr) *reinterpret_cast<uint2*>(p.out_copy + off) = vb;
          }
          asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
        }
      }
    }
    if constexpr (kTmaStore) {  // the stores must have read shared memory before exit
      if ((threadIdx.x & 127) == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(f);
  }
  return fn;
}

// a (rows, cols) bf16 row-major matrix in boxes of box_rows x box_cols:
// 128-byte swizzle for the operands (box_cols = 64), none for the output
bool encode_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows,
                int box_cols, CUtensorMapSwizzle swizzle) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
            box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, bool kGate, bool kResident, bool kTmaStore>
cudaError_t launch_gemm(const void* A, const void* Bt, const GemmArgs& p, int grid,
                        size_t smem, cudaStream_t stream) {
  CUtensorMap map_a, map_b, map_out = {};
  if (!encode_map(&map_a, A, p.M, p.K, kBM, kBK, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_map(&map_b, Bt, p.N, p.K, BN, kBK, CU_TENSOR_MAP_SWIZZLE_128B) ||
      (kTmaStore &&
       !encode_map(&map_out, p.out, p.M, p.N, 64, kNI, CU_TENSOR_MAP_SWIZZLE_NONE)))
    return cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(pw_gemm_kernel<BN, kGate, kResident, kTmaStore>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)smem);
  if (e != cudaSuccess) return e;
  pw_gemm_kernel<BN, kGate, kResident, kTmaStore>
      <<<grid, kGemmThreads, smem, stream>>>(map_a, map_b, map_out, p);
  return cudaGetLastError();
}

// the gate is only taken with B streaming (the project GEMM's B panel is
// too large to stay resident); the TMA-store epilogue only with B resident
// and a plain bf16 output (the expand GEMMs)
template <int BN>
cudaError_t dispatch_mode(bool gate, bool resident, bool tma, const void* A, const void* Bt,
                          const GemmArgs& p, int grid, size_t smem, cudaStream_t s) {
  if (gate) {
    if (resident) return cudaErrorInvalidValue;
    return launch_gemm<BN, true, false, false>(A, Bt, p, grid, smem, s);
  }
  if (!resident) return launch_gemm<BN, false, false, false>(A, Bt, p, grid, smem, s);
  return tma ? launch_gemm<BN, false, true, true>(A, Bt, p, grid, smem, s)
             : launch_gemm<BN, false, true, false>(A, Bt, p, grid, smem, s);
}

// ---------------------------------------------------------------------------
// K2: depthwise. One CTA per (channel tile of CT, band of output rows,
// image). The zero-padded input band (rows_in x (W + 2p) x CT bf16) comes
// into shared memory by cp.async (16 bytes each, zero-filled outside the
// image); each thread makes 8 channels of two output pixels at a time with
// 16-byte loads and stores; the tap weights sit beside the window as bf16x2
// (one 16-byte broadcast read per tap, shared by the two pixels). The SE
// sums of the CTA's pixels are reduced in a fixed order (deterministic, no
// atomics) into sums[b, band, c], in the window's room once it is read.
// One pixel per thread was slower than two.
// Tried and slower or no faster: a persistent CTA double-buffering the next
// band's window (two CTAs per SM instead of three), and the window loaded
// in two parts with the first half computed while the second lands.
// ---------------------------------------------------------------------------

constexpr int CT = 16;            // channels per CTA
constexpr int kCG = CT / 8;       // 8-channel groups per pixel, one thread each
constexpr int kDwThreads = 256;
constexpr int kDwPix = 2;  // output pixels per thread at a time

// PX output pixels per thread at a time share each tap's weight read and
// give each thread 8 * PX independent sums; three CTAs per SM. KS is the
// kernel size with its tap loops unrolled (3 and 5, the model's), or 0 for
// any other odd size, taken at run time from ks.
template <int KS, int PX>
__global__ void __launch_bounds__(kDwThreads, 3)
depthwise_kernel(const bf16* __restrict__ y, const bf16* __restrict__ w,
                 const float* __restrict__ bias, bf16* __restrict__ out,
                 float* __restrict__ sums, int H, int W, int C, int OH,
                 int OW, int ks, int stride, int dil, int band_rows, int act) {
  const int K = KS > 0 ? KS : ks;
  extern __shared__ __align__(16) unsigned char smem[];
  const int c0 = blockIdx.x * CT, band = blockIdx.y, b = blockIdx.z;
  const int nbands = gridDim.y;
  const int oy0 = band * band_rows, oy1 = min(OH, oy0 + band_rows);
  const int p = (K - 1) / 2 * dil;
  const int iy0 = oy0 * stride - p;
  const int rows_in = (oy1 - 1 - oy0) * stride + 2 * p + 1;
  const int Wp = W + 2 * p;
  uint4* wsm = reinterpret_cast<uint4*>(smem);
  bf16* tile = reinterpret_cast<bf16*>(wsm + K * K * kCG);
  float* red = reinterpret_cast<float*>(tile);
  const int tid = threadIdx.x;

  const int nvec = rows_in * Wp * kCG;
  for (int v = tid; v < nvec; v += blockDim.x) {
    const int g = v % kCG, pix = v / kCG;
    const int ry = pix / Wp, rx = pix - ry * Wp;
    const int gy = iy0 + ry, gx = rx - p, c = c0 + g * 8;
    const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W && c < C;
    const bf16* src = inside ? y + (((size_t)b * H + gy) * W + gx) * C + c : y;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(tile + (size_t)pix * CT + g * 8)),
                 "l"(src), "r"(inside ? 16 : 0)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int i = tid; i < K * K * kCG; i += blockDim.x) {
    const int tap = i / kCG, cc = c0 + (i % kCG) * 8;
    wsm[i] = cc < C ? *reinterpret_cast<const uint4*>(w + (size_t)tap * C + cc)
                    : make_uint4(0, 0, 0, 0);
  }
  const int g = tid % kCG, lane = tid / kCG, nlanes = blockDim.x / kCG;
  const int c = c0 + g * 8;
  const bool cvalid = c < C;
  float bsum[8], bb[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    bsum[j] = 0.0f;
    bb[j] = cvalid ? bias[c + j] : 0.0f;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int npix = (oy1 - oy0) * OW;
  for (int pix0 = lane; pix0 < npix; pix0 += PX * nlanes) {
    const bf16* base[PX];
    int pixs[PX];
#pragma unroll
    for (int q = 0; q < PX; ++q) {
      pixs[q] = min(pix0 + q * nlanes, npix - 1);
      const int dy = pixs[q] / OW, ox = pixs[q] - dy * OW;
      base[q] = tile + ((size_t)(dy * stride) * Wp + ox * stride) * CT + g * 8;
    }
    float acc[PX][8];
#pragma unroll
    for (int q = 0; q < PX; ++q)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[q][j] = 0.0f;
#pragma unroll
    for (int kx = 0; kx < K; ++kx) {
#pragma unroll
      for (int ky = 0; ky < K; ++ky) {
        const uint4 wt = wsm[(ky * K + kx) * kCG + g];
        const size_t off = ((size_t)(ky * dil) * Wp + kx * dil) * CT;
#pragma unroll
        for (int q = 0; q < PX; ++q) {
          const uint4 raw = *reinterpret_cast<const uint4*>(base[q] + off);
          add_terms(acc[q], hmul2_bits(raw.x, wt.x), 0);
          add_terms(acc[q], hmul2_bits(raw.y, wt.y), 2);
          add_terms(acc[q], hmul2_bits(raw.z, wt.z), 4);
          add_terms(acc[q], hmul2_bits(raw.w, wt.w), 6);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < PX; ++q) {
      if (!cvalid || pix0 + q * nlanes >= npix) continue;
      const int dy = pixs[q] / OW, ox = pixs[q] - dy * OW;
      uint32_t pk[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const __nv_bfloat162 o = __floats2bfloat162_rn(
            act_fn(acc[q][2 * e] + bb[2 * e], act), act_fn(acc[q][2 * e + 1] + bb[2 * e + 1], act));
        bsum[2 * e] += __low2float(o);
        bsum[2 * e + 1] += __high2float(o);
        pk[e] = bf162_bits(o);
      }
      *reinterpret_cast<uint4*>(out + (((size_t)b * OH + oy0 + dy) * OW + ox) * C + c) =
          make_uint4(pk[0], pk[1], pk[2], pk[3]);
    }
  }
  if (sums != nullptr) {
    __syncthreads();  // the window is read for the last time
#pragma unroll
    for (int j = 0; j < 8; ++j) red[tid * 8 + j] = bsum[j];
    __syncthreads();
    if (tid < CT && c0 + tid < C) {
      const int gg = tid / 8, j = tid % 8;
      float s = 0.0f;
      for (int l = 0; l < nlanes; ++l) s += red[(l * kCG + gg) * 8 + j];
      sums[((size_t)b * nbands + band) * C + c0 + tid] = s;
    }
  }
}

// ---------------------------------------------------------------------------
// K3: SE gate, one CTA per image: mean -> fc1 + ReLU -> fc2 -> hard-sigmoid.
// Weights in (in, out) layout so that neighbouring threads read neighbouring
// outputs.
// ---------------------------------------------------------------------------

__global__ void se_gate_kernel(const float* __restrict__ sums, int nbands,
                               int npix, const float* __restrict__ w1,
                               const float* __restrict__ b1,
                               const float* __restrict__ w2,
                               const float* __restrict__ b2,
                               bf16* __restrict__ gate, int C, int S) {
  extern __shared__ float sm[];
  float* mean = sm;
  float* hid = sm + C;
  const int b = blockIdx.x;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float s = 0.0f;
    for (int band = 0; band < nbands; ++band) s += sums[((size_t)b * nbands + band) * C + c];
    mean[c] = s / (float)npix;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < S; j += blockDim.x) {
    float d = 0.0f;
    for (int c = 0; c < C; ++c) d += mean[c] * w1[(size_t)c * S + j];
    hid[j] = fmaxf(d + b1[j], 0.0f);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float d = 0.0f;
    for (int j = 0; j < S; ++j) d += hid[j] * w2[(size_t)j * C + c];
    const float s = d + b2[c];
    gate[(size_t)b * C + c] = __float2bfloat16_rn(fminf(fmaxf(s + 3.0f, 0.0f), 6.0f) / 6.0f);
  }
}

size_t depthwise_smem(int band_rows, int W, int k, int stride, int dil) {
  const int p = (k - 1) / 2 * dil;
  const size_t rows = (size_t)(band_rows - 1) * stride + 2 * p + 1;
  const size_t window = rows * (W + 2 * p) * CT * sizeof(bf16);
  const size_t red = (size_t)kDwThreads * 8 * sizeof(float);
  return (size_t)k * k * CT * sizeof(bf16) + (window > red ? window : red);
}

template <int KS>
cudaError_t launch_depthwise(const void* y, const void* w, const void* bias, void* out,
                             void* sums, int B, int H, int W, int C, int OH, int OW,
                             int k, int stride, int dil, int band_rows, int act,
                             size_t smem, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      depthwise_kernel<KS, kDwPix>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((C + CT - 1) / CT, (OH + band_rows - 1) / band_rows, B);
  depthwise_kernel<KS, kDwPix><<<grid, kDwThreads, smem, stream>>>(
      (const bf16*)y, (const bf16*)w, (const float*)bias, (bf16*)out, (float*)sums, H, W, C,
      OH, OW, k, stride, dil, band_rows, act);
  return cudaGetLastError();
}

}  // namespace

// A (M, K) and Bt (N, K) bf16, 16-byte aligned; bias (N) fp32; gate (images,
// K) bf16 or null; res (M, N) fp32 or bf16 or null; out (M, N) fp32 or bf16;
// out_copy (M, N) bf16 or null. bn (80, 160 or 240), stages, resident,
// grid and the shared bytes come from the host's plan (ops/kernels/
// fused_block.py::gemm_plan); a resident grid is a multiple of the n tiles.
extern "C" int mtg_pw_gemm(const void* A, const void* Bt, const void* bias,
                           const void* gate, int rows_per_image, const void* res,
                           int res_f32, void* out, int out_f32, void* out_copy, int M,
                           int N, int K, int act, int bn, int stages, int resident,
                           int grid, int smem_bytes, void* stream) {
  if (K % 8 != 0 || N % 8 != 0 || M <= 0 || grid <= 0 || stages < 2 || bn <= 0)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)A & 15) || ((uintptr_t)Bt & 15)) return (int)cudaErrorMisalignedAddress;
  if (gate != nullptr && rows_per_image <= 0) return (int)cudaErrorInvalidValue;
  if (resident && grid % ((N + bn - 1) / bn) != 0) return (int)cudaErrorInvalidValue;
  if (smem_bytes <= 0 || (size_t)smem_bytes > kSmemLimit) return (int)cudaErrorInvalidValue;
  GemmArgs p;
  p.bias = (const float*)bias;
  p.gate = (const bf16*)gate;
  p.rows_per_image = rows_per_image;
  p.res = res;
  p.res_f32 = res_f32;
  p.out = out;
  p.out_f32 = out_f32;
  p.out_copy = (bf16*)out_copy;
  p.M = M; p.N = N; p.K = K; p.act = act;
  p.stages = stages;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool g = gate != nullptr;
  const bool tma = resident && res == nullptr && !out_f32 && out_copy == nullptr &&
                   ((uintptr_t)out & 15) == 0;
  const size_t smem = (size_t)smem_bytes;
  switch (bn) {
    case 80: return (int)dispatch_mode<80>(g, resident, tma, A, Bt, p, grid, smem, s);
    case 160: return (int)dispatch_mode<160>(g, resident, tma, A, Bt, p, grid, smem, s);
    case 240: return (int)dispatch_mode<240>(g, resident, tma, A, Bt, p, grid, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int mtg_depthwise_smem(int band_rows, int W, int k, int stride, int dil) {
  return (int)depthwise_smem(band_rows, W, k, stride, dil);
}

extern "C" int mtg_depthwise(const void* y, const void* w, const void* bias,
                             void* out, void* sums, int B, int H, int W,
                             int C, int OH, int OW, int k, int stride, int dil,
                             int band_rows, int act, void* stream) {
  if (C % 8 != 0 || band_rows <= 0 || B <= 0 || B > 65535 || k < 1 || k % 2 == 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = depthwise_smem(band_rows, W, k, stride, dil);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (k) {
    case 3: return (int)launch_depthwise<3>(y, w, bias, out, sums, B, H, W, C, OH, OW, k,
                                            stride, dil, band_rows, act, smem, s);
    case 5: return (int)launch_depthwise<5>(y, w, bias, out, sums, B, H, W, C, OH, OW, k,
                                            stride, dil, band_rows, act, smem, s);
    default: return (int)launch_depthwise<0>(y, w, bias, out, sums, B, H, W, C, OH, OW, k,
                                             stride, dil, band_rows, act, smem, s);
  }
}

extern "C" int mtg_se_gate(const void* sums, int nbands, int npix,
                           const void* w1, const void* b1, const void* w2,
                           const void* b2, void* gate, int B, int C, int S,
                           void* stream) {
  const size_t smem = (size_t)(C + S) * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  se_gate_kernel<<<B, 256, smem, (cudaStream_t)stream>>>(
      (const float*)sums, nbands, npix, (const float*)w1, (const float*)b1,
      (const float*)w2, (const float*)b2, (bf16*)gate, C, S);
  return (int)cudaGetLastError();
}
