// Normalize: (B, H, W, 3) uint8 -> x * scale[c] + shift[c] as bfloat16 or
// float32, scale = 1/(255 std_c), shift = -mean_c/std_c. One read of the
// bytes, one write of the result, no float32 image in between.
//
// Replaces: mtg_card_image_segmentation_tpu/ops/pallas/preprocess.py::
// fused_normalize (a row-tiled VPU pass over the (B*H, W*3) view).
//
// Bound on the H100: memory. At (128, 480, 640, 3) it reads 118 MB and
// writes 236 MB of bf16, ~0.106 ms at 3.35 TB/s, against 0.24 GFLOP. So the
// design is a flat pass over the bytes in 16-byte units: one thread loads
// one uint4 (16 bytes) and stores 16 results (32 or 64 bytes) with 16-byte
// stores, neighbouring threads on neighbouring units, four units in flight
// per thread. The channel of byte i is i % 3 and 16 % 3 == 1, so unit u
// starts at channel u % 3 and byte j of it has channel (u + j) % 3: the
// thread rotates the three constants once per unit.
//
// Arithmetic: __fmul_rn then __fadd_rn, so nvcc cannot contract them into an
// FMA and the result is bit-equal to the plain PyTorch version
// (x.float() * scale + shift, then the cast, round to nearest even).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // 16-byte units per thread

template <typename T>
struct Store16;  // writes 16 results starting at out + 16 * unit

template <>
struct Store16<float> {
  static __device__ __forceinline__ void run(float* out, long long unit,
                                             const float* v) {
    float4* p = reinterpret_cast<float4*>(out + unit * 16);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      p[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  }
  static __device__ __forceinline__ float one(float v) { return v; }
};

template <>
struct Store16<__nv_bfloat16> {
  static __device__ __forceinline__ void run(__nv_bfloat16* out,
                                             long long unit, const float* v) {
    unsigned pk[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      // .x is the low half: the value at the lower address
      const __nv_bfloat162 two = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
      pk[q] = *reinterpret_cast<const unsigned*>(&two);
    }
    uint4* p = reinterpret_cast<uint4*>(out + unit * 16);
    p[0] = make_uint4(pk[0], pk[1], pk[2], pk[3]);
    p[1] = make_uint4(pk[4], pk[5], pk[6], pk[7]);
  }
  static __device__ __forceinline__ __nv_bfloat16 one(float v) {
    return __float2bfloat16_rn(v);
  }
};

// v0, v1 or v2 for i == 0, 1, 2, without indexing a register array
__device__ __forceinline__ float pick(int i, float v0, float v1, float v2) {
  return i == 0 ? v0 : (i == 1 ? v1 : v2);
}

template <typename T>
__global__ void normalize_kernel(const uint8_t* __restrict__ in,
                                 T* __restrict__ out, long long n,
                                 long long units, float s0, float s1, float s2,
                                 float t0, float t1, float t2) {
  const long long base =
      (long long)blockIdx.x * (kThreads * kUnroll) + threadIdx.x;
  uint4 raw[kUnroll];
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const long long u = base + (long long)k * kThreads;
    if (u < units) raw[k] = reinterpret_cast<const uint4*>(in)[u];
  }
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const long long u = base + (long long)k * kThreads;
    if (u >= units) continue;
    const int ph = (int)(u % 3);
    // constants of bytes j % 3 == 0, 1, 2 of this unit
    const float a[3] = {pick(ph, s0, s1, s2), pick(ph, s1, s2, s0),
                        pick(ph, s2, s0, s1)};
    const float c[3] = {pick(ph, t0, t1, t2), pick(ph, t1, t2, t0),
                        pick(ph, t2, t0, t1)};
    const unsigned w[4] = {raw[k].x, raw[k].y, raw[k].z, raw[k].w};
    float v[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float x = (float)((w[j >> 2] >> (8 * (j & 3))) & 0xffu);
      v[j] = __fadd_rn(__fmul_rn(x, a[j % 3]), c[j % 3]);
    }
    Store16<T>::run(out, u, v);
  }
  // the last n % 16 bytes, one per thread of the first block
  if (blockIdx.x == 0) {
    const long long i = units * 16 + threadIdx.x;
    if (i < n) {
      const int ch = (int)(i % 3);
      out[i] = Store16<T>::one(__fadd_rn(
          __fmul_rn((float)in[i], pick(ch, s0, s1, s2)), pick(ch, t0, t1, t2)));
    }
  }
}

}  // namespace

// in: n = B*H*W*3 bytes, 16-byte aligned; out: n values of float32
// (out_bf16 == 0) or bfloat16, 16-byte aligned.
extern "C" int mtg_fused_normalize(const void* in, void* out, long long n,
                                   int out_bf16, float s0, float s1, float s2,
                                   float t0, float t1, float t2, void* stream) {
  if (((uintptr_t)in & 15) || ((uintptr_t)out & 15))
    return (int)cudaErrorMisalignedAddress;
  const long long units = n / 16;
  long long blocks = (units + kThreads * kUnroll - 1) / (kThreads * kUnroll);
  if (blocks < 1) blocks = 1;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (out_bf16)
    normalize_kernel<__nv_bfloat16><<<(unsigned)blocks, kThreads, 0, st>>>(
        (const uint8_t*)in, (__nv_bfloat16*)out, n, units, s0, s1, s2, t0, t1,
        t2);
  else
    normalize_kernel<float><<<(unsigned)blocks, kThreads, 0, st>>>(
        (const uint8_t*)in, (float*)out, n, units, s0, s1, s2, t0, t1, t2);
  return (int)cudaGetLastError();
}
