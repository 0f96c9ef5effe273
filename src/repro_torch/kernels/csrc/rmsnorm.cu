// Fused RMSNorm over the last axis: out = x * rsqrt(mean(x^2) + eps) * scale.
//
// Replaces the TPU kernel repro/kernels/rmsnorm.py::rmsnorm_pallas
// (_rmsnorm_kernel), which blocks 256 rows into VMEM and reduces each row
// there. Every LM layer runs it four times (pre-norm, post-norm, and the
// per-head q and k norms over 128-wide rows), and the model once more
// before its head.
//
// Bound on the H100: device-memory bytes. Each element is read once and
// written once (8 bytes) for 3 FP32 operations; at a prefill's
// (8192, 1024) the 67.1 MB moved take 0.020 ms at 3.35 TB/s, and the
// arithmetic is 100x less.
//
// Design: one warp per row, eight rows per 256-thread block. Where the row
// width is a multiple of 4 (and the pointers 16-byte aligned), each lane
// loads its share of the row with 16-byte loads into registers (NV float4s
// a lane, a compile-time count for widths up to 2,048), so the row is read
// from device memory once and written once. The sum of squares is
// accumulated per lane in a fixed order and reduced by a xor butterfly of
// warp shuffles, which gives every lane the same sum. Other widths take a
// scalar two-pass loop (the second pass re-reads the row from L1/L2).
// Float32 only: the TPU kernel also takes bf16 (ROADMAP lists it as open).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int NV>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_vec_kernel(const float* __restrict__ x,
                       const float* __restrict__ scale,
                       float* __restrict__ out, long long N, int d,
                       float eps) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= N) return;                    // whole warp: one row each
  const int d4 = d >> 2;
  const float4* xr = reinterpret_cast<const float4*>(x + row * d);
  float4 v[NV];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < d4 ? xr[c] : make_float4(0.f, 0.f, 0.f, 0.f);
    ss = fmaf(v[i].x, v[i].x, ss);
    ss = fmaf(v[i].y, v[i].y, ss);
    ss = fmaf(v[i].z, v[i].z, ss);
    ss = fmaf(v[i].w, v[i].w, ss);
  }
  ss = warp_sum(ss);
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);
  const float4* s4 = reinterpret_cast<const float4*>(scale);
  float4* orow = reinterpret_cast<float4*>(out + row * d);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = lane + 32 * i;
    if (c < d4) {
      const float4 s = s4[c];
      orow[c] = make_float4(v[i].x * r * s.x, v[i].y * r * s.y,
                            v[i].z * r * s.z, v[i].w * r * s.w);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    rmsnorm_any_kernel(const float* __restrict__ x,
                       const float* __restrict__ scale,
                       float* __restrict__ out, long long N, int d,
                       float eps) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= N) return;
  const float* xr = x + row * d;
  float ss = 0.f;
  for (int c = lane; c < d; c += 32) ss = fmaf(xr[c], xr[c], ss);
  ss = warp_sum(ss);
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);
  float* orow = out + row * d;
  for (int c = lane; c < d; c += 32) orow[c] = xr[c] * r * scale[c];
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// x (N, d) and out (N, d) contiguous float32, scale (d,) float32.
extern "C" int rt_rmsnorm(const float* x, const float* scale, float* out,
                          long long N, int d, float eps, int device,
                          void* stream) {
  if (N < 1 || d < 1) return cudaErrorInvalidValue;
  const long long blocks = (N + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(blocks);
  const bool vec = d % 4 == 0 && aligned16(x) && aligned16(scale) &&
                   aligned16(out);
  const int per_lane = (d / 4 + 31) / 32;  // float4s a lane holds
#define RT_RMS(NV_)                                                        \
  if (vec && per_lane <= NV_) {                                            \
    rmsnorm_vec_kernel<NV_><<<grid, kThreads, 0, st>>>(x, scale, out, N,   \
                                                        d, eps);           \
    return cudaGetLastError();                                             \
  }
  RT_RMS(1) RT_RMS(2) RT_RMS(4) RT_RMS(8) RT_RMS(16)
#undef RT_RMS
  rmsnorm_any_kernel<<<grid, kThreads, 0, st>>>(x, scale, out, N, d, eps);
  return cudaGetLastError();
}
