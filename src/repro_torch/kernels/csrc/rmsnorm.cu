// Fused RMSNorm over the last axis: out = x * rsqrt(mean(x^2) + eps) * scale.
//
// Replaces the TPU kernel repro/kernels/rmsnorm.py::rmsnorm_pallas
// (_rmsnorm_kernel), which blocks 256 rows into VMEM and reduces each row
// there, for rows up to 8,192 wide (its own premise). Every qwen3 layer runs
// it four times (pre-norm, post-norm, and the per-head q and k norms over
// 128-wide rows), the model once more before its head; Jamba's rows are
// 4,096 wide.
//
// Bound on the H100: device-memory bytes. Each element is read once and
// written once (8 bytes) for 3 FP32 operations: (8,192, 1,024) moves 67.1
// MB, 0.020 ms at 3.35 TB/s; (8,192, 4,096) 268 MB, 0.080 ms. The
// arithmetic is 100x less. There is no product, so no TMA and no wgmma: the
// lever is bytes in flight (~20 KB an SM to cover the memory latency at the
// full rate), and 16-byte loads of whole rows held in registers supply them.
// At a decode step's 8 rows the device work is ~2.5 us and the host's launch
// path is the rest of the call (launch.cuh).
//
// Design: one single-pass vector path for every width d % 4 == 0 up to
// 8,192 with 16-byte aligned pointers. Each lane holds at most 8 float4s of
// its row in registers, so a row is read from device memory once (x with
// the streaming hint __ldcs, scale through __ldg) and written once (with
// the streaming store __stcs: a prefill's rows outsize the 50 MB L2).
//  * d <= 1,024: one warp owns a row; the sum of squares is accumulated per
//    lane in a fixed order and reduced by a xor butterfly of shuffles.
//  * 1,024 < d <= 8,192: a group of ceil(d / 1,024) warps owns a row, one
//    block a row; each warp reduces its part by shuffles, and the parts
//    cross the warps through shared memory, summed in warp order.
//  * Few rows (fewer than the SMs x 8, e.g. a decode step's 8): the warp
//    path launches smaller blocks, so 8 rows land on 8 SMs and not on one.
// Widths not a multiple of 4, wider than 8,192, or misaligned pointers take
// a scalar two-pass loop (the second pass re-reads the row from L1/L2).
// The arithmetic is the same everywhere: r = rsqrtf(ss / d + eps), then
// x * r * scale. Float32 only: the TPU kernel also takes bf16 (ROADMAP lists
// it as open).
#include <cuda_runtime.h>

#include "launch.cuh"

#include <cstdint>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kRowsPerBlock = kMaxThreads / 32;
constexpr int kMaxNV = 8;                  // float4s a lane holds
constexpr int kWarpWidth = 32 * 4 * kMaxNV;   // 1,024 floats a warp holds
constexpr int kMaxVecWidth = 8192;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float sq4(const float4& v, float ss) {
  ss = fmaf(v.x, v.x, ss);
  ss = fmaf(v.y, v.y, ss);
  ss = fmaf(v.z, v.z, ss);
  return fmaf(v.w, v.w, ss);
}

__device__ __forceinline__ float4 norm4(const float4& v, float r,
                                        const float4& s) {
  return make_float4(v.x * r * s.x, v.y * r * s.y, v.z * r * s.z,
                     v.w * r * s.w);
}

// One warp a row, blockDim.x / 32 rows a block, NV float4s a lane.
template <int NV>
__global__ void __launch_bounds__(kMaxThreads)
    rmsnorm_warp_kernel(const float* __restrict__ x,
                        const float* __restrict__ scale,
                        float* __restrict__ out, long long N, int d,
                        float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) *
                            (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= N) return;                    // whole warp: one row each
  const int d4 = d >> 2;
  const float4* xr = reinterpret_cast<const float4*>(x + row * d);
  float4 v[NV];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < d4 ? __ldcs(xr + c) : make_float4(0.f, 0.f, 0.f, 0.f);
    ss = sq4(v[i], ss);
  }
  ss = warp_sum(ss);
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);
  const float4* s4 = reinterpret_cast<const float4*>(scale);
  float4* orow = reinterpret_cast<float4*>(out + row * d);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = lane + 32 * i;
    if (c < d4) __stcs(orow + c, norm4(v[i], r, __ldg(s4 + c)));
  }
}

// A block of blockDim.x / 32 warps a row (one block a row), up to kMaxNV
// float4s a lane.
__global__ void __launch_bounds__(kMaxThreads)
    rmsnorm_group_kernel(const float* __restrict__ x,
                         const float* __restrict__ scale,
                         float* __restrict__ out, int d, float eps) {
  __shared__ float part[kMaxThreads / 32];
  const int t = threadIdx.x, n = blockDim.x, warps = n >> 5;
  const long long row = blockIdx.x;
  const int d4 = d >> 2;
  const float4* xr = reinterpret_cast<const float4*>(x + row * d);
  float4 v[kMaxNV];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxNV; ++i) {
    const int c = t + n * i;
    v[i] = c < d4 ? __ldcs(xr + c) : make_float4(0.f, 0.f, 0.f, 0.f);
    ss = sq4(v[i], ss);
  }
  ss = warp_sum(ss);
  if ((t & 31) == 0) part[t >> 5] = ss;
  __syncthreads();
  ss = 0.f;
  for (int w = 0; w < warps; ++w) ss += part[w];     // fixed order
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);
  const float4* s4 = reinterpret_cast<const float4*>(scale);
  float4* orow = reinterpret_cast<float4*>(out + row * d);
#pragma unroll
  for (int i = 0; i < kMaxNV; ++i) {
    const int c = t + n * i;
    if (c < d4) __stcs(orow + c, norm4(v[i], r, __ldg(s4 + c)));
  }
}

__global__ void __launch_bounds__(kMaxThreads)
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
  cudaError_t err = rt::use_device(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = d % 4 == 0 && d <= kMaxVecWidth && aligned16(x) &&
                   aligned16(scale) && aligned16(out);
  if (vec && d > kWarpWidth) {
    if (N > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    const int warps = (d + kWarpWidth - 1) / kWarpWidth;
    rmsnorm_group_kernel<<<static_cast<unsigned>(N), 32 * warps, 0, st>>>(
        x, scale, out, d, eps);
    return cudaGetLastError();
  }
  if (vec) {
    // rows a block: 8, or fewer so that few rows spread over the SMs
    const long long sms = rt::sm_count(device);
    long long rows = kRowsPerBlock;
    if (sms > 0 && N < sms * kRowsPerBlock) rows = (N + sms - 1) / sms;
    const long long blocks = (N + rows - 1) / rows;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    const unsigned grid = static_cast<unsigned>(blocks);
    const int threads = static_cast<int>(32 * rows);
    const int per_lane = (d / 4 + 31) / 32;  // float4s a lane holds
#define RT_RMS(NV_)                                                       \
  if (per_lane <= NV_) {                                                  \
    rmsnorm_warp_kernel<NV_><<<grid, threads, 0, st>>>(x, scale, out, N,  \
                                                        d, eps);          \
    return cudaGetLastError();                                            \
  }
    RT_RMS(1) RT_RMS(2) RT_RMS(4) RT_RMS(8)
#undef RT_RMS
  }
  const long long blocks = (N + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  rmsnorm_any_kernel<<<static_cast<unsigned>(blocks), kMaxThreads, 0, st>>>(
      x, scale, out, N, d, eps);
  return cudaGetLastError();
}
