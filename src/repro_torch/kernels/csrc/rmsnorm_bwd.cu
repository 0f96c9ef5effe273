// Backward of the fused RMSNorm out = x * r * scale, r = rsqrt(mean(x^2) +
// eps), over the last axis: from x, scale and the output gradient g,
//   dx     = r * (g * scale) - x * r^3 * <g * scale, x> / d   (a row)
//   dscale = sum over rows of g * x * r.
// r is recomputed from x, not saved by the forward.
//
// The TPU package has no backward kernel: its LM normalises with plain jnp
// and XLA differentiates it. This is that gradient for the function of
// repro/kernels/rmsnorm.py::rmsnorm_pallas, whose forward rmsnorm.cu
// replaces.
//
// Bound on the H100: device-memory bytes. x and g are read once and dx is
// written once (12 bytes an element for ~10 FP32 operations): (8,192,
// 1,024), a qwen3 training step's pre-norm, moves 100.7 MB, 0.030 ms at
// 3.35 TB/s. The float64 partials add 2 x 256 x d x 8 bytes (4.2 MB).
//
// Design: the forward's paths, for the same widths and alignments.
//  * d % 4 == 0, 16-byte aligned, d <= 1,024: one warp a row, 8 warps a
//    block; each lane holds its float4s of x and g in registers, so a row
//    is read once, and its two sums (sum x^2 and <g*scale, x>) are xor
//    butterflies of shuffles.
//  * 1,024 < d <= 8,192: a group of ceil(d / 1,024) warps a row, the two
//    sums crossing the warps through shared memory in warp order.
//  * anything else: 256 threads a row, scalar, two passes over the row.
// dscale needs a sum over every row, which no block sees whole. Each of
// `nb` blocks (the wrapper's choice from the row count alone: min(rows,
// 256)) takes a contiguous chunk of rows; each thread sums g * (x * r) for
// its columns over its rows of the chunk in float registers, each term
// rounded to float as autograd of the forward rounds it; the warps of a
// block combine in float64, in warp order, and write one float64 partial
// row into an (nb, d) scratch. A second launch sums the partials of each
// column in float64 in a fixed order and rounds once to float. So the
// float sums run over a few rows (4 of qwen3's 8,192 a warp) and the long
// sum over the blocks, whose terms may cancel, adds only float64 roundings.
// (Holding float64 sums in registers instead halves the warp path's
// resident blocks: 15% slower at (8,192, 1,024) on an H100.) r is
// rsqrt correctly rounded (__frsqrt_rn), as near as a float gets to the
// CPU's 1 / sqrt of the plain version; rsqrtf is off by up to 2 ulps, and
// each row's error in r runs through all of its dscale terms. No atomics:
// the result is the same bits run to run, on any card.
//
// dtypes, as the forward's: x and g in one type (g is the gradient of the
// forward's output, which has x's), scale in its own, each float32 or
// bfloat16. dx is stored in x's type and dscale in scale's, each rounded
// once: dx from its float, dscale from the float64 sum of the partials
// (dtype.cuh's bf16_from_double). The lane-to-element maps and summation
// orders are the float32 instance's (a lane's unit of 4 elements is 8
// bytes at bf16), so the bf16 results are the float32 instance's on the
// widened inputs, rounded once.
#include <cuda_runtime.h>

#include "dtype.cuh"
#include "launch.cuh"

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxNV = 8;                      // float4s a lane holds
constexpr int kWarpWidth = 32 * 4 * kMaxNV;    // 1,024 floats a warp holds
constexpr int kMaxVecWidth = 8192;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ss += x^2 and dot += (g * s) x over a float4
__device__ __forceinline__ void sums4(const float4& x, const float4& g,
                                      const float4& s, float& ss,
                                      float& dot) {
  ss = fmaf(x.x, x.x, ss);
  ss = fmaf(x.y, x.y, ss);
  ss = fmaf(x.z, x.z, ss);
  ss = fmaf(x.w, x.w, ss);
  dot = fmaf(g.x * s.x, x.x, dot);
  dot = fmaf(g.y * s.y, x.y, dot);
  dot = fmaf(g.z * s.z, x.z, dot);
  dot = fmaf(g.w * s.w, x.w, dot);
}

__device__ __forceinline__ float dx1(float x, float g, float s, float r,
                                     float c) {
  return g * s * r - x * c;
}

__device__ __forceinline__ float4 dx4(const float4& x, const float4& g,
                                      const float4& s, float r, float c) {
  return make_float4(dx1(x.x, g.x, s.x, r, c), dx1(x.y, g.y, s.y, r, c),
                     dx1(x.z, g.z, s.z, r, c), dx1(x.w, g.w, s.w, r, c));
}

using dt::as_f4;

// a row's term of dscale: g * (x * r), both products rounded to float
__device__ __forceinline__ float term(float x, float g, float r) {
  return __fmul_rn(g, __fmul_rn(x, r));
}

__device__ __forceinline__ void acc4(float4& a, const float4& x,
                                     const float4& g, float r) {
  a.x += term(x.x, g.x, r);
  a.y += term(x.y, g.y, r);
  a.z += term(x.z, g.z, r);
  a.w += term(x.w, g.w, r);
}

// r and r^3 <g*s, x> / d of a row from its two sums
__device__ __forceinline__ void row_terms(float ss, float dot, int d,
                                          float eps, float& r, float& c) {
  const float fd = static_cast<float>(d);
  r = __frsqrt_rn(ss / fd + eps);
  c = r * r * r * (dot / fd);
}

// One warp a row, 8 warps a block over the block's chunk of rows.
template <int NV, typename TX, typename TS>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_bwd_warp_kernel(const TX* __restrict__ x,
                            const TS* __restrict__ scale,
                            const TX* __restrict__ g,
                            TX* __restrict__ dx,
                            double* __restrict__ part, long long N, int d,
                            long long chunk, float eps) {
  using VX = typename dt::Vec4<TX>::type;
  using VS = typename dt::Vec4<TS>::type;
  __shared__ double tot[32 * 4 * NV];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long row0 = static_cast<long long>(blockIdx.x) * chunk;
  const long long row1 = min(N, row0 + chunk);
  const int d4 = d >> 2;
  const VS* s4 = reinterpret_cast<const VS*>(scale);
  float4 acc[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (long long row = row0 + warp; row < row1; row += kWarps) {
    const VX* xr = reinterpret_cast<const VX*>(x + row * d);
    const VX* gr = reinterpret_cast<const VX*>(g + row * d);
    float4 xv[NV], gv[NV];
    float ss = 0.f, dot = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = lane + 32 * i;
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      xv[i] = c < d4 ? as_f4(__ldcs(xr + c)) : z;
      gv[i] = c < d4 ? as_f4(__ldcs(gr + c)) : z;
      sums4(xv[i], gv[i], c < d4 ? as_f4(__ldg(s4 + c)) : z, ss, dot);
    }
    float r, cc;
    row_terms(warp_sum(ss), warp_sum(dot), d, eps, r, cc);
    VX* orow = reinterpret_cast<VX*>(dx + row * d);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = lane + 32 * i;
      if (c < d4) {
        __stcs(orow + c, dt::from_f4<TX>(dx4(xv[i], gv[i],
                                             as_f4(__ldg(s4 + c)), r, cc)));
        acc4(acc[i], xv[i], gv[i], r);
      }
    }
  }
  for (int w = 0; w < kWarps; ++w) {    // warp order
    if (warp == w) {
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        double* t = tot + (lane + 32 * i) * 4;
        if (w == 0) {                   // warp 0 starts the sums
          t[0] = acc[i].x;
          t[1] = acc[i].y;
          t[2] = acc[i].z;
          t[3] = acc[i].w;
        } else {
          t[0] += acc[i].x;
          t[1] += acc[i].y;
          t[2] += acc[i].z;
          t[3] += acc[i].w;
        }
      }
    }
    __syncthreads();
  }
  for (int col = threadIdx.x; col < d; col += kThreads)
    part[static_cast<long long>(blockIdx.x) * d + col] = tot[col];
}

// A block of blockDim.x / 32 warps a row, rows of the chunk in order.
template <typename TX, typename TS>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_bwd_group_kernel(const TX* __restrict__ x,
                             const TS* __restrict__ scale,
                             const TX* __restrict__ g,
                             TX* __restrict__ dx,
                             double* __restrict__ part, long long N, int d,
                             long long chunk, float eps) {
  using VX = typename dt::Vec4<TX>::type;
  using VS = typename dt::Vec4<TS>::type;
  __shared__ float red[2][2][kWarps];    // [row parity][ss, dot][warp]
  const int t = threadIdx.x, n = blockDim.x, warps = n >> 5;
  const long long row0 = static_cast<long long>(blockIdx.x) * chunk;
  const long long row1 = min(N, row0 + chunk);
  const int d4 = d >> 2;
  const VS* s4 = reinterpret_cast<const VS*>(scale);
  float4 acc[kMaxNV];
#pragma unroll
  for (int i = 0; i < kMaxNV; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  int par = 0;
  for (long long row = row0; row < row1; ++row, par ^= 1) {
    const VX* xr = reinterpret_cast<const VX*>(x + row * d);
    const VX* gr = reinterpret_cast<const VX*>(g + row * d);
    float4 xv[kMaxNV], gv[kMaxNV];
    float ss = 0.f, dot = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxNV; ++i) {
      const int c = t + n * i;
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      xv[i] = c < d4 ? as_f4(__ldcs(xr + c)) : z;
      gv[i] = c < d4 ? as_f4(__ldcs(gr + c)) : z;
      sums4(xv[i], gv[i], c < d4 ? as_f4(__ldg(s4 + c)) : z, ss, dot);
    }
    ss = warp_sum(ss);
    dot = warp_sum(dot);
    if ((t & 31) == 0) {
      red[par][0][t >> 5] = ss;
      red[par][1][t >> 5] = dot;
    }
    __syncthreads();
    ss = dot = 0.f;
    for (int w = 0; w < warps; ++w) {    // fixed order
      ss += red[par][0][w];
      dot += red[par][1][w];
    }
    float r, cc;
    row_terms(ss, dot, d, eps, r, cc);
    VX* orow = reinterpret_cast<VX*>(dx + row * d);
#pragma unroll
    for (int i = 0; i < kMaxNV; ++i) {
      const int c = t + n * i;
      if (c < d4) {
        __stcs(orow + c, dt::from_f4<TX>(dx4(xv[i], gv[i],
                                             as_f4(__ldg(s4 + c)), r, cc)));
        acc4(acc[i], xv[i], gv[i], r);
      }
    }
  }
  double* prow = part + static_cast<long long>(blockIdx.x) * d;
#pragma unroll
  for (int i = 0; i < kMaxNV; ++i) {
    const int c = t + n * i;
    if (c < d4) {
      prow[4 * c] = acc[i].x;
      prow[4 * c + 1] = acc[i].y;
      prow[4 * c + 2] = acc[i].z;
      prow[4 * c + 3] = acc[i].w;
    }
  }
}

// 256 threads a row, scalar: any width and alignment.
template <typename TX, typename TS>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_bwd_any_kernel(const TX* __restrict__ x,
                           const TS* __restrict__ scale,
                           const TX* __restrict__ g,
                           TX* __restrict__ dx,
                           double* __restrict__ part, long long N, int d,
                           long long chunk, float eps) {
  __shared__ float red[2][2][kWarps];
  const int t = threadIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * chunk;
  const long long row1 = min(N, row0 + chunk);
  double* prow = part + static_cast<long long>(blockIdx.x) * d;
  for (int c = t; c < d; c += kThreads) prow[c] = 0.0;  // this thread's
  int par = 0;
  for (long long row = row0; row < row1; ++row, par ^= 1) {
    const TX* xr = x + row * d;
    const TX* gr = g + row * d;
    float ss = 0.f, dot = 0.f;
    for (int c = t; c < d; c += kThreads) {
      const float xc = dt::to_f(xr[c]);
      ss = fmaf(xc, xc, ss);
      dot = fmaf(dt::to_f(gr[c]) * dt::to_f(scale[c]), xc, dot);
    }
    ss = warp_sum(ss);
    dot = warp_sum(dot);
    if ((t & 31) == 0) {
      red[par][0][t >> 5] = ss;
      red[par][1][t >> 5] = dot;
    }
    __syncthreads();
    ss = dot = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      ss += red[par][0][w];
      dot += red[par][1][w];
    }
    float r, cc;
    row_terms(ss, dot, d, eps, r, cc);
    TX* orow = dx + row * d;
    for (int c = t; c < d; c += kThreads) {
      const float xc = dt::to_f(xr[c]), gc = dt::to_f(gr[c]);
      orow[c] = dt::from_f<TX>(dx1(xc, gc, dt::to_f(scale[c]), r, cc));
      prow[c] += term(xc, gc, r);         // float64, in global memory
    }
  }
}

// dscale[c] = sum of part[b][c] over b, in float64 and a fixed order: 32
// columns a block, 8 warps each summing every 8th partial, then warp
// order; one rounding to scale's type
template <typename TS>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_bwd_reduce(const double* __restrict__ part,
                       TS* __restrict__ dscale, int nb, int d) {
  __shared__ double red[kWarps][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  double t = 0.0;
  if (col < d)
    for (int b = w; b < nb; b += kWarps)
      t += part[static_cast<long long>(b) * d + col];
  red[w][lane] = t;
  __syncthreads();
  if (w == 0 && col < d) {
    double s = 0.0;
    for (int i = 0; i < kWarps; ++i) s += red[i][lane];
    dscale[col] = dt::from_double<TS>(s);
  }
}

template <typename TX, typename TS>
cudaError_t launch(const TX* x, const TS* scale, const TX* g, TX* dx,
                   double* part, TS* dscale, long long N, int d, int nb,
                   float eps, cudaStream_t st) {
  const long long chunk = (N + nb - 1) / nb;
  // a lane's unit is 4 elements: 16 bytes of float32, 8 of bf16
  const bool vec = d % 4 == 0 && d <= kMaxVecWidth &&
                   dt::aligned(x, 4 * sizeof(TX)) &&
                   dt::aligned(scale, 4 * sizeof(TS)) &&
                   dt::aligned(g, 4 * sizeof(TX)) &&
                   dt::aligned(dx, 4 * sizeof(TX)) && dt::aligned(part, 16);
  const unsigned grid = static_cast<unsigned>(nb);
  if (vec && d > kWarpWidth) {
    const int warps = (d + kWarpWidth - 1) / kWarpWidth;
    rmsnorm_bwd_group_kernel<TX, TS><<<grid, 32 * warps, 0, st>>>(
        x, scale, g, dx, part, N, d, chunk, eps);
  } else if (vec) {
    const int per_lane = (d / 4 + 31) / 32;  // units a lane holds
    if (per_lane <= 1)
      rmsnorm_bwd_warp_kernel<1, TX, TS><<<grid, kThreads, 0, st>>>(
          x, scale, g, dx, part, N, d, chunk, eps);
    else if (per_lane <= 2)
      rmsnorm_bwd_warp_kernel<2, TX, TS><<<grid, kThreads, 0, st>>>(
          x, scale, g, dx, part, N, d, chunk, eps);
    else if (per_lane <= 4)
      rmsnorm_bwd_warp_kernel<4, TX, TS><<<grid, kThreads, 0, st>>>(
          x, scale, g, dx, part, N, d, chunk, eps);
    else
      rmsnorm_bwd_warp_kernel<8, TX, TS><<<grid, kThreads, 0, st>>>(
          x, scale, g, dx, part, N, d, chunk, eps);
  } else {
    rmsnorm_bwd_any_kernel<TX, TS><<<grid, kThreads, 0, st>>>(
        x, scale, g, dx, part, N, d, chunk, eps);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rmsnorm_bwd_reduce<TS><<<(d + 31) / 32, kThreads, 0, st>>>(part, dscale,
                                                             nb, d);
  return cudaGetLastError();
}

}  // namespace

// x, g, dx (N, d) contiguous; scale, dscale (d,); part (nb, d) float64
// scratch, 1 <= nb <= N. dtypes: bit 0 set where x, g and dx are bfloat16
// (else float32), bit 1 where scale and dscale are.
extern "C" int rt_rmsnorm_bwd_dt(const void* x, const void* scale,
                                 const void* g, void* dx, double* part,
                                 void* dscale, long long N, int d, int nb,
                                 float eps, int dtypes, int device,
                                 void* stream) {
  if (N < 1 || d < 1 || nb < 1 || nb > N || dtypes < 0 || dtypes > 3)
    return cudaErrorInvalidValue;
  cudaError_t err = rt::use_device(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  using dt::bf16;
#define RT_RMS_BWD(TX, TS)                                                  \
  return launch(static_cast<const TX*>(x), static_cast<const TS*>(scale),   \
                static_cast<const TX*>(g), static_cast<TX*>(dx), part,      \
                static_cast<TS*>(dscale), N, d, nb, eps, st);
  switch (dtypes) {
    case 0: RT_RMS_BWD(float, float)
    case 1: RT_RMS_BWD(bf16, float)
    case 2: RT_RMS_BWD(float, bf16)
    default: RT_RMS_BWD(bf16, bf16)
  }
#undef RT_RMS_BWD
}

// x, g, dx (N, d) contiguous float32; scale, dscale (d,); part (nb, d)
// float64 scratch, 1 <= nb <= N.
extern "C" int rt_rmsnorm_bwd(const float* x, const float* scale,
                              const float* g, float* dx, double* part,
                              float* dscale, long long N, int d, int nb,
                              float eps, int device, void* stream) {
  return rt_rmsnorm_bwd_dt(x, scale, g, dx, part, dscale, N, d, nb, eps, 0,
                           device, stream);
}
