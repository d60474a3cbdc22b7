// MobileNetV3 inverted-residual block (folded BN) as four kernels:
//   K1 pw_gemm      1x1 expand: bf16 GEMM, fp32 accumulate, + bias, act
//   K2 depthwise    k x k depthwise at any dilation, stride 1 or 2, + bias,
//                   act, and the per-(image, channel) SE sums
//   K3 se_gate      SE fc1 + ReLU -> fc2 -> hard-sigmoid, fp32, -> bf16 gate
//   K4 pw_gemm      1x1 project with the gate applied to A as it loads,
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
// 160/960/160 x2): operations. ~209 GFLOP of 1x1 GEMMs take 0.21 ms at
// 989 TFLOP/s bf16 on the tensor cores, and ~17 GFLOP of depthwise take
// 0.25 ms at 67 TFLOP/s fp32 on the CUDA cores; the two can overlap, so the
// bound is ~0.25 ms. The chain's own input and output are ~71 MB, ~21 us at
// 3.35 TB/s. Design (b) writes and reads back each expanded map twice,
// ~2.7 GB more through HBM (~0.8 ms at 3.35 TB/s), and the GEMM here is a plain WMMA
// tile loop without a copy pipeline, so this first version sits well above
// the bound; wgmma/TMA GEMMs and design (a) (recompute instead of storing
// the expanded map) are the ways down.
//
// Numerics follow the TPU kernel: bf16 GEMM inputs with fp32 accumulation;
// each depthwise term is the bf16-rounded product, accumulated in fp32, in
// the reference's tap order (columns outer, rows inner); the SE runs in
// fp32 and its gate is rounded to bf16 and multiplied into the bf16
// depthwise output with a bf16 rounding; the residual is added in fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

enum { kActNone = 0, kActRelu = 1, kActHardswish = 2 };

__device__ __forceinline__ float act_fn(float x, int act) {
  if (act == kActRelu) return fmaxf(x, 0.0f);
  if (act == kActHardswish) return x * fminf(fmaxf(x + 3.0f, 0.0f), 6.0f) / 6.0f;
  return x;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// 8 consecutive A elements as 8 packed bf16 (fp32 A is rounded to bf16,
// the reference's astype(bfloat16) before the matmul)
__device__ __forceinline__ uint4 load_a8(const bf16* p) {
  return *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ uint4 load_a8(const float* p) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  uint4 r;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
  h[0] = __floats2bfloat162_rn(a.x, a.y);
  h[1] = __floats2bfloat162_rn(a.z, a.w);
  h[2] = __floats2bfloat162_rn(b.x, b.y);
  h[3] = __floats2bfloat162_rn(b.z, b.w);
  return r;
}

// y * gate with a bf16 rounding, 8 lanes
__device__ __forceinline__ uint4 gate8(uint4 v, const bf16* g) {
  const uint4 gv = *reinterpret_cast<const uint4*>(g);
  bf16* a = reinterpret_cast<bf16*>(&v);
  const bf16* s = reinterpret_cast<const bf16*>(&gv);
#pragma unroll
  for (int j = 0; j < 8; ++j)
    a[j] = __float2bfloat16_rn(__bfloat162float(a[j]) * __bfloat162float(s[j]));
  return v;
}

// ---------------------------------------------------------------------------
// K1 / K4: out[M, N] = act(A[M, K] @ Bt[N, K]^T + bias) (+ res), WMMA bf16
// 16x16x16 fragments, fp32 accumulate. 128 threads, 64x64 output tile,
// four warps of 32x32. K and N are multiples of 8 (16-byte rows).
// ---------------------------------------------------------------------------

constexpr int BM = 64, BN = 64, BK = 32, SK = BK + 8, SC = BN + 4;

template <typename TA, typename TOut, typename TRes>
__global__ void __launch_bounds__(128)
pw_gemm_kernel(const TA* __restrict__ A, const bf16* __restrict__ Bt,
               const float* __restrict__ bias, const bf16* __restrict__ gate,
               int rows_per_image, const TRes* __restrict__ res,
               TOut* __restrict__ out, int M, int N, int K, int act) {
  __shared__ __align__(128) bf16 As[BM * SK];
  __shared__ __align__(128) bf16 Bs[BN * SK];
  __shared__ __align__(128) float Cs[BM * SC];
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int warp = threadIdx.x >> 5, wm = warp >> 1, wn = warp & 1;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int v = threadIdx.x; v < BM * BK / 8; v += blockDim.x) {
      const int r = v / (BK / 8), c = (v % (BK / 8)) * 8;
      const int gm = m0 + r, gk = k0 + c;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (gm < M && gk < K) {
        val = load_a8(A + (size_t)gm * K + gk);
        if (gate != nullptr)
          val = gate8(val, gate + (size_t)(gm / rows_per_image) * K + gk);
      }
      *reinterpret_cast<uint4*>(&As[r * SK + c]) = val;
    }
    for (int v = threadIdx.x; v < BN * BK / 8; v += blockDim.x) {
      const int r = v / (BK / 8), c = (v % (BK / 8)) * 8;
      const int gn = n0 + r, gk = k0 + c;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (gn < N && gk < K)
        val = *reinterpret_cast<const uint4*>(Bt + (size_t)gn * K + gk);
      *reinterpret_cast<uint4*>(&Bs[r * SK + c]) = val;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * SK + kk, SK);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + (wn * 32 + j * 16) * SK + kk, SK);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * SC + wn * 32 + j * 16,
                              acc[i][j], SC, wmma::mem_row_major);
  __syncthreads();
  for (int e = threadIdx.x; e < BM * BN; e += blockDim.x) {
    const int r = e / BN, c = e % BN;
    const int gm = m0 + r, gn = n0 + c;
    if (gm < M && gn < N) {
      float v = act_fn(Cs[r * SC + c] + bias[gn], act);
      if (res != nullptr) v = v + to_f32(res[(size_t)gm * N + gn]);
      out[(size_t)gm * N + gn] = from_f32<TOut>(v);
    }
  }
}

template <typename TA, typename TOut, typename TRes>
cudaError_t launch_gemm(const void* A, const void* Bt, const void* bias,
                        const void* gate, int rows_per_image, const void* res,
                        void* out, int M, int N, int K, int act,
                        cudaStream_t stream) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  pw_gemm_kernel<TA, TOut, TRes><<<grid, 128, 0, stream>>>(
      (const TA*)A, (const bf16*)Bt, (const float*)bias, (const bf16*)gate,
      rows_per_image, (const TRes*)res, (TOut*)out, M, N, K, act);
  return cudaGetLastError();
}

template <typename TA, typename TOut>
cudaError_t dispatch_res(int res_f32, const void* A, const void* Bt,
                         const void* bias, const void* gate, int rpi,
                         const void* res, void* out, int M, int N, int K,
                         int act, cudaStream_t s) {
  return res_f32 ? launch_gemm<TA, TOut, float>(A, Bt, bias, gate, rpi, res, out, M, N, K, act, s)
                 : launch_gemm<TA, TOut, bf16>(A, Bt, bias, gate, rpi, res, out, M, N, K, act, s);
}

template <typename TA>
cudaError_t dispatch_out(int out_f32, int res_f32, const void* A,
                         const void* Bt, const void* bias, const void* gate,
                         int rpi, const void* res, void* out, int M, int N,
                         int K, int act, cudaStream_t s) {
  return out_f32 ? dispatch_res<TA, float>(res_f32, A, Bt, bias, gate, rpi, res, out, M, N, K, act, s)
                 : dispatch_res<TA, bf16>(res_f32, A, Bt, bias, gate, rpi, res, out, M, N, K, act, s);
}

// ---------------------------------------------------------------------------
// K2: depthwise. One CTA per (channel tile of CT, band of output rows,
// image). The zero-padded input band (rows_in x (W + 2p) x CT bf16) sits in
// shared memory; each thread makes 8 channels of one output pixel at a time
// with 16-byte loads and stores. The SE sums of the CTA's pixels are reduced
// in a fixed order (deterministic, no atomics) into sums[b, band, c].
// ---------------------------------------------------------------------------

constexpr int CT = 16;
constexpr int kDwThreads = 256;

__global__ void __launch_bounds__(kDwThreads)
depthwise_kernel(const bf16* __restrict__ y, const bf16* __restrict__ w,
                 const float* __restrict__ bias, bf16* __restrict__ out,
                 float* __restrict__ sums, int H, int W, int C, int OH,
                 int OW, int k, int stride, int dil, int band_rows, int act) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int c0 = blockIdx.x * CT, band = blockIdx.y, b = blockIdx.z;
  const int nbands = gridDim.y;
  const int oy0 = band * band_rows, oy1 = min(OH, oy0 + band_rows);
  const int p = (k - 1) / 2 * dil;
  const int iy0 = oy0 * stride - p;
  const int rows_in = (oy1 - 1 - oy0) * stride + 2 * p + 1;
  const int Wp = W + 2 * p;
  bf16* tile = reinterpret_cast<bf16*>(smem);
  const int rows_cap = (band_rows - 1) * stride + 2 * p + 1;
  float* wsm = reinterpret_cast<float*>(smem + (size_t)rows_cap * Wp * CT * sizeof(bf16));
  float* red = wsm + k * k * CT;
  const int tid = threadIdx.x;

  const int nvec = rows_in * Wp * (CT / 8);
  for (int v = tid; v < nvec; v += blockDim.x) {
    const int g = v & 1, pix = v >> 1;
    const int ry = pix / Wp, rx = pix - ry * Wp;
    const int gy = iy0 + ry, gx = rx - p, c = c0 + g * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W && c < C)
      val = *reinterpret_cast<const uint4*>(y + (((size_t)b * H + gy) * W + gx) * C + c);
    *reinterpret_cast<uint4*>(tile + (size_t)pix * CT + g * 8) = val;
  }
  for (int i = tid; i < k * k * CT; i += blockDim.x) {
    const int tap = i / CT, cc = i % CT;
    wsm[i] = (c0 + cc < C) ? __bfloat162float(w[(size_t)tap * C + c0 + cc]) : 0.0f;
  }
  __syncthreads();

  const int g = tid & 1, lane = tid >> 1, nlanes = blockDim.x >> 1;
  const int c = c0 + g * 8;
  const bool cvalid = c < C;
  float bsum[8], bb[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    bsum[j] = 0.0f;
    bb[j] = cvalid ? bias[c + j] : 0.0f;
  }
  const int npix = (oy1 - oy0) * OW;
  for (int pix = lane; pix < npix; pix += nlanes) {
    const int dy = pix / OW, ox = pix - dy * OW;
    const int ry0 = dy * stride, rx0 = ox * stride;
    float acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0.0f;
    for (int kx = 0; kx < k; ++kx) {
      for (int ky = 0; ky < k; ++ky) {
        const uint4 raw = *reinterpret_cast<const uint4*>(
            tile + ((size_t)(ry0 + ky * dil) * Wp + rx0 + kx * dil) * CT + g * 8);
        const bf16* v = reinterpret_cast<const bf16*>(&raw);
        const float* wt = wsm + (ky * k + kx) * CT + g * 8;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float term = __bfloat162float(
              __float2bfloat16_rn(__bfloat162float(v[j]) * wt[j]));
          acc[j] = __fadd_rn(acc[j], term);
        }
      }
    }
    if (cvalid) {
      uint4 packed;
      bf16* o = reinterpret_cast<bf16*>(&packed);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[j] = __float2bfloat16_rn(act_fn(acc[j] + bb[j], act));
        bsum[j] += __bfloat162float(o[j]);
      }
      *reinterpret_cast<uint4*>(out + (((size_t)b * OH + oy0 + dy) * OW + ox) * C + c) = packed;
    }
  }
  if (sums != nullptr) {
#pragma unroll
    for (int j = 0; j < 8; ++j) red[tid * 8 + j] = bsum[j];
    __syncthreads();
    if (tid < CT && c0 + tid < C) {
      const int gg = tid / 8, j = tid % 8;
      float s = 0.0f;
      for (int l = 0; l < nlanes; ++l) s += red[(l * 2 + gg) * 8 + j];
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
  return rows * (W + 2 * p) * CT * sizeof(bf16) + (size_t)k * k * CT * sizeof(float) +
         (size_t)kDwThreads * 8 * sizeof(float);
}

}  // namespace

extern "C" int mtg_pw_gemm(const void* A, int a_f32, const void* Bt,
                           const void* bias, const void* gate,
                           int rows_per_image, const void* res, int res_f32,
                           void* out, int out_f32, int M, int N, int K,
                           int act, void* stream) {
  if (K % 8 != 0 || N % 8 != 0 || M <= 0) return (int)cudaErrorInvalidValue;
  if (gate != nullptr && (rows_per_image <= 0)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t e =
      a_f32 ? dispatch_out<float>(out_f32, res_f32, A, Bt, bias, gate, rows_per_image, res, out, M, N, K, act, s)
            : dispatch_out<bf16>(out_f32, res_f32, A, Bt, bias, gate, rows_per_image, res, out, M, N, K, act, s);
  return (int)e;
}

extern "C" int mtg_depthwise_smem(int band_rows, int W, int k, int stride, int dil) {
  return (int)depthwise_smem(band_rows, W, k, stride, dil);
}

extern "C" int mtg_depthwise(const void* y, const void* w, const void* bias,
                             void* out, void* sums, int B, int H, int W,
                             int C, int OH, int OW, int k, int stride, int dil,
                             int band_rows, int act, void* stream) {
  if (C % 8 != 0 || band_rows <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = depthwise_smem(band_rows, W, k, stride, dil);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        depthwise_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((C + CT - 1) / CT, (OH + band_rows - 1) / band_rows, B);
  depthwise_kernel<<<grid, kDwThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)y, (const bf16*)w, (const float*)bias, (bf16*)out,
      (float*)sums, H, W, C, OH, OW, k, stride, dil, band_rows, act);
  return (int)cudaGetLastError();
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
