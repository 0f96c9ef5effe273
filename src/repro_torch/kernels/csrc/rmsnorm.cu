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
// x * r * scale.
//
// dtypes, as the TPU kernel's: x and scale each float32 or bfloat16 (a
// config's dtype and param_dtype may differ), loaded and widened to float,
// the output in x's dtype, rounded once. Every path keeps its lane-to-
// element map and summation order at bf16: a lane's unit is still 4
// elements, loaded as 8 bytes (two bf16 pairs) where float32 loads 16. So
// the bf16 output is the float32 instance's output on the widened inputs,
// rounded once, bit for bit (chip_smoke.py checks it). A 16-byte load of 8
// bf16 would move the same bytes in half the loads but change the order.
#include <cuda_runtime.h>

#include "dtype.cuh"
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

using dt::as_f4;

// One warp a row, blockDim.x / 32 rows a block, NV float4s a lane.
template <int NV, typename TX, typename TS>
__global__ void __launch_bounds__(kMaxThreads)
    rmsnorm_warp_kernel(const TX* __restrict__ x,
                        const TS* __restrict__ scale,
                        TX* __restrict__ out, long long N, int d,
                        float eps) {
  using VX = typename dt::Vec4<TX>::type;
  using VS = typename dt::Vec4<TS>::type;
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) *
                            (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= N) return;                    // whole warp: one row each
  const int d4 = d >> 2;
  const VX* xr = reinterpret_cast<const VX*>(x + row * d);
  float4 v[NV];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < d4 ? as_f4(__ldcs(xr + c)) : make_float4(0.f, 0.f, 0.f, 0.f);
    ss = sq4(v[i], ss);
  }
  ss = warp_sum(ss);
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);
  const VS* s4 = reinterpret_cast<const VS*>(scale);
  VX* orow = reinterpret_cast<VX*>(out + row * d);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = lane + 32 * i;
    if (c < d4)
      __stcs(orow + c, dt::from_f4<TX>(norm4(v[i], r, as_f4(__ldg(s4 + c)))));
  }
}

// A block of blockDim.x / 32 warps a row (one block a row), up to kMaxNV
// float4s a lane.
template <typename TX, typename TS>
__global__ void __launch_bounds__(kMaxThreads)
    rmsnorm_group_kernel(const TX* __restrict__ x,
                         const TS* __restrict__ scale,
                         TX* __restrict__ out, int d, float eps) {
  using VX = typename dt::Vec4<TX>::type;
  using VS = typename dt::Vec4<TS>::type;
  __shared__ float part[kMaxThreads / 32];
  const int t = threadIdx.x, n = blockDim.x, warps = n >> 5;
  const long long row = blockIdx.x;
  const int d4 = d >> 2;
  const VX* xr = reinterpret_cast<const VX*>(x + row * d);
  float4 v[kMaxNV];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxNV; ++i) {
    const int c = t + n * i;
    v[i] = c < d4 ? as_f4(__ldcs(xr + c)) : make_float4(0.f, 0.f, 0.f, 0.f);
    ss = sq4(v[i], ss);
  }
  ss = warp_sum(ss);
  if ((t & 31) == 0) part[t >> 5] = ss;
  __syncthreads();
  ss = 0.f;
  for (int w = 0; w < warps; ++w) ss += part[w];     // fixed order
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);
  const VS* s4 = reinterpret_cast<const VS*>(scale);
  VX* orow = reinterpret_cast<VX*>(out + row * d);
#pragma unroll
  for (int i = 0; i < kMaxNV; ++i) {
    const int c = t + n * i;
    if (c < d4)
      __stcs(orow + c, dt::from_f4<TX>(norm4(v[i], r, as_f4(__ldg(s4 + c)))));
  }
}

template <typename TX, typename TS>
__global__ void __launch_bounds__(kMaxThreads)
    rmsnorm_any_kernel(const TX* __restrict__ x,
                       const TS* __restrict__ scale,
                       TX* __restrict__ out, long long N, int d,
                       float eps) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= N) return;
  const TX* xr = x + row * d;
  float ss = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float v = dt::to_f(xr[c]);
    ss = fmaf(v, v, ss);
  }
  ss = warp_sum(ss);
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);
  TX* orow = out + row * d;
  for (int c = lane; c < d; c += 32)
    orow[c] = dt::from_f<TX>(dt::to_f(xr[c]) * r * dt::to_f(scale[c]));
}

template <typename TX, typename TS>
cudaError_t launch(const TX* x, const TS* scale, TX* out, long long N, int d,
                   float eps, int device, cudaStream_t st) {
  // a lane's unit is 4 elements: 16 bytes of float32, 8 of bf16
  const bool vec = d % 4 == 0 && d <= kMaxVecWidth &&
                   dt::aligned(x, 4 * sizeof(TX)) &&
                   dt::aligned(scale, 4 * sizeof(TS)) &&
                   dt::aligned(out, 4 * sizeof(TX));
  if (vec && d > kWarpWidth) {
    if (N > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    const int warps = (d + kWarpWidth - 1) / kWarpWidth;
    rmsnorm_group_kernel<TX, TS>
        <<<static_cast<unsigned>(N), 32 * warps, 0, st>>>(x, scale, out, d,
                                                          eps);
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
    const int per_lane = (d / 4 + 31) / 32;  // units a lane holds
#define RT_RMS(NV_)                                                      \
  if (per_lane <= NV_) {                                                 \
    rmsnorm_warp_kernel<NV_, TX, TS><<<grid, threads, 0, st>>>(          \
        x, scale, out, N, d, eps);                                       \
    return cudaGetLastError();                                           \
  }
    RT_RMS(1) RT_RMS(2) RT_RMS(4) RT_RMS(8)
#undef RT_RMS
  }
  const long long blocks = (N + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  rmsnorm_any_kernel<TX, TS>
      <<<static_cast<unsigned>(blocks), kMaxThreads, 0, st>>>(x, scale, out,
                                                              N, d, eps);
  return cudaGetLastError();
}

}  // namespace

// x (N, d) and out (N, d) contiguous, scale (d,); dtypes: bit 0 set where
// x and out are bfloat16 (else float32), bit 1 where scale is.
extern "C" int rt_rmsnorm_dt(const void* x, const void* scale, void* out,
                             long long N, int d, float eps, int dtypes,
                             int device, void* stream) {
  if (N < 1 || d < 1 || dtypes < 0 || dtypes > 3)
    return cudaErrorInvalidValue;
  cudaError_t err = rt::use_device(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  using dt::bf16;
  switch (dtypes) {
    case 0:
      return launch(static_cast<const float*>(x),
                    static_cast<const float*>(scale), static_cast<float*>(out),
                    N, d, eps, device, st);
    case 1:
      return launch(static_cast<const bf16*>(x),
                    static_cast<const float*>(scale), static_cast<bf16*>(out),
                    N, d, eps, device, st);
    case 2:
      return launch(static_cast<const float*>(x),
                    static_cast<const bf16*>(scale), static_cast<float*>(out),
                    N, d, eps, device, st);
    default:
      return launch(static_cast<const bf16*>(x),
                    static_cast<const bf16*>(scale), static_cast<bf16*>(out),
                    N, d, eps, device, st);
  }
}

// x (N, d) and out (N, d) contiguous float32, scale (d,) float32.
extern "C" int rt_rmsnorm(const float* x, const float* scale, float* out,
                          long long N, int d, float eps, int device,
                          void* stream) {
  return rt_rmsnorm_dt(x, scale, out, N, d, eps, 0, device, stream);
}
