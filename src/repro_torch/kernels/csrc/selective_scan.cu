// Selective scan: the Mamba recurrence and its output contraction, in
// float32 on float32 or bfloat16 inputs.
//
//   h_t = decay_t * h_{t-1} + inp_t          decay, inp (B, T, di, N)
//   y_t = sum_n h_t[n] * C_t[n]              C (B, T, N)  -> y (B, T, di)
//
// returning y and h_T (B, di, N), from h_0 (B, di, N).
//
// Replaces the TPU kernel repro/kernels/selective_scan.py::
// selective_scan_pallas (_selscan_kernel). The Mamba mixer runs it once a
// layer in prefill (T > 1) and once a layer in every decode step (T = 1,
// h_0 the cached state).
//
// Bound on the H100: device-memory bytes. Each (b, t, channel) reads 2N
// floats of decay and inp and writes one float of y, for 4N FLOP; at a
// Jamba prefill's (8, 1,024, 8,192, 16) that is 8.6 GB read and 0.27 GB
// written, 2.65 ms at 3.35 TB/s, against 4.3 GFLOP (0.06 ms at the FP32
// peak). A decode step's (8, 1, 8,192, 16) moves 16.8 MB (5 us).
//
// Design, and what differs from the TPU kernel:
//  * The TPU grid walks time chunks in order and carries the (512, N) state
//    block in VMEM scratch from one grid step to the next. Blocks on Hopper
//    run in no order, so the time loop moves inside the thread: one thread
//    owns one (batch, channel) pair and keeps its N <= 16 states in
//    registers for all T steps. A block holds 128 channels of one batch
//    row; 8 x 8,192 pairs are 512 blocks, resident at once on 132 SMs.
//  * Each step a thread reads its N-float run of decay and of inp (64
//    bytes at N = 16, 16-byte loads where N % 4 == 0 and the pointers are
//    aligned), so a warp reads 2 KB of each array, contiguous. The loads
//    of step t+1 are issued before step t's arithmetic (a register double
//    buffer), so a step does not wait one memory latency.
//  * C[b, t, :] is the same for every channel of the block: 32 steps of it
//    are staged in shared memory at a time, and the block reads it as a
//    broadcast.
//  * y[b, t, ch] is written by neighbouring threads to neighbouring
//    addresses; h_T is written once.
//  * No padding: the TPU wrapper pads T with decay 1 and inp 0 (which
//    leaves h unchanged) and di to whole blocks. Here the loop runs exactly
//    T steps and threads past di only take part in the block's barriers.
//  * nvcc contracts decay * h + inp into one FMA and y sums over n in
//    order: the result differs from the plain version by rounding only.
//  * dtypes, as the TPU kernel's: decay, inp, c and h0 each float32 or
//    bfloat16 (a mask bit each), widened to float at the load; y and h_T
//    are float32 either way. The FMA order is the float32 instance's, so a
//    bf16 input gives the float32 instance's result on the widened input,
//    bit for bit. The types are read at run time (a uniform branch at each
//    load) rather than instantiated: 16 combinations x 16 N would be 512
//    kernels for a memory-bound loop.
#include <cuda_runtime.h>

#include "dtype.cuh"
#include "launch.cuh"

#include <cstdint>

namespace {

constexpr int kThreads = 128;            // channels per block
constexpr int kChunk = 32;               // steps of C staged per pass
constexpr int kMaxN = 16;

// the mask bits of the four inputs' types
constexpr int kDecayBf16 = 1, kInpBf16 = 2, kCBf16 = 4, kH0Bf16 = 8;

// element i of a float32 (bf false) or bfloat16 array, widened
__device__ __forceinline__ float load1(const void* p, bool bf, long long i) {
  return bf ? dt::to_f(static_cast<const dt::bf16*>(p)[i])
            : static_cast<const float*>(p)[i];
}

template <int N, bool VEC>
__device__ __forceinline__ void load_run(const float* __restrict__ p,
                                         float (&r)[N]) {
  if constexpr (VEC) {
    const float4* p4 = reinterpret_cast<const float4*>(p);
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 v = p4[i];
      r[4 * i] = v.x;
      r[4 * i + 1] = v.y;
      r[4 * i + 2] = v.z;
      r[4 * i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) r[i] = p[i];
  }
}

// the N-element run at element `at`: 16-byte loads (float32) or 8-byte
// loads (bf16) where VEC
template <int N, bool VEC>
__device__ __forceinline__ void load_run(const void* p, bool bf,
                                         long long at, float (&r)[N]) {
  if (bf) {
    const dt::bf16* b = static_cast<const dt::bf16*>(p) + at;
    if constexpr (VEC) {
      const uint2* b4 = reinterpret_cast<const uint2*>(b);
#pragma unroll
      for (int i = 0; i < N / 4; ++i) {
        const float4 v = dt::as_f4(b4[i]);
        r[4 * i] = v.x;
        r[4 * i + 1] = v.y;
        r[4 * i + 2] = v.z;
        r[4 * i + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) r[i] = dt::to_f(b[i]);
    }
    return;
  }
  load_run<N, VEC>(static_cast<const float*>(p) + at, r);
}


template <int N, bool VEC>
__global__ void __launch_bounds__(kThreads)
    selective_scan_kernel(const void* __restrict__ decay,
                          const void* __restrict__ inp,
                          const void* __restrict__ c,
                          const void* __restrict__ h0,
                          float* __restrict__ y, float* __restrict__ h_last,
                          int T, int di, int dtypes) {
  const bool bd = dtypes & kDecayBf16, bi = dtypes & kInpBf16;
  const bool bc = dtypes & kCBf16, bh = dtypes & kH0Bf16;
  __shared__ __align__(16) float c_s[kChunk * N];
  const int b = blockIdx.y;
  const int ch = blockIdx.x * kThreads + threadIdx.x;
  const bool active = ch < di;
  // (b, t, ch) runs are N floats apart in ch and di * N apart in t
  const long long run0 = (static_cast<long long>(b) * T * di + ch) * N;
  const long long stride = static_cast<long long>(di) * N;
  const long long state = (static_cast<long long>(b) * di + ch) * N;

  float h[N], d_cur[N], i_cur[N], d_nxt[N], i_nxt[N];
#pragma unroll
  for (int n = 0; n < N; ++n)
    h[n] = d_cur[n] = i_cur[n] = d_nxt[n] = i_nxt[n] = 0.f;
  if (active) {
    load_run<N, VEC>(h0, bh, state, h);
    load_run<N, VEC>(decay, bd, run0, d_cur);
    load_run<N, VEC>(inp, bi, run0, i_cur);
  }
  const long long cb = static_cast<long long>(b) * T * N;
  float* yb = y + static_cast<long long>(b) * T * di + ch;

  for (int t0 = 0; t0 < T; t0 += kChunk) {
    const int len = min(kChunk, T - t0);
    __syncthreads();                     // the last chunk's C is read
    for (int k = threadIdx.x; k < len * N; k += kThreads)
      c_s[k] = load1(c, bc, cb + static_cast<long long>(t0) * N + k);
    __syncthreads();
    for (int tt = 0; tt < len; ++tt) {
      const int t = t0 + tt;
      if (active && t + 1 < T) {         // step t+1's loads go out first
        const long long nxt = run0 + (t + 1) * stride;
        load_run<N, VEC>(decay, bd, nxt, d_nxt);
        load_run<N, VEC>(inp, bi, nxt, i_nxt);
      }
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        h[n] = fmaf(d_cur[n], h[n], i_cur[n]);
        acc = fmaf(h[n], c_s[tt * N + n], acc);
      }
      if (active) yb[static_cast<long long>(t) * di] = acc;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        d_cur[n] = d_nxt[n];
        i_cur[n] = i_nxt[n];
      }
    }
  }
  if (!active) return;
  if constexpr (VEC) {
    float4* o4 = reinterpret_cast<float4*>(h_last + state);
#pragma unroll
    for (int i = 0; i < N / 4; ++i)
      o4[i] = make_float4(h[4 * i], h[4 * i + 1], h[4 * i + 2], h[4 * i + 3]);
  } else {
#pragma unroll
    for (int n = 0; n < N; ++n) h_last[state + n] = h[n];
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0;
}

template <int N>
cudaError_t launch(const void* decay, const void* inp, const void* c,
                   const void* h0, float* y, float* h_last, int B, int T,
                   int di, int dtypes, cudaStream_t st) {
  const dim3 grid((di + kThreads - 1) / kThreads, B);
  if constexpr (N % 4 == 0) {
    if (aligned16(decay) && aligned16(inp) && aligned16(h0) &&
        aligned16(h_last)) {
      selective_scan_kernel<N, true><<<grid, kThreads, 0, st>>>(
          decay, inp, c, h0, y, h_last, T, di, dtypes);
      return cudaGetLastError();
    }
  }
  selective_scan_kernel<N, false><<<grid, kThreads, 0, st>>>(
      decay, inp, c, h0, y, h_last, T, di, dtypes);
  return cudaGetLastError();
}

}  // namespace

// decay, inp (B, T, di, N), c (B, T, N), h0 (B, di, N) contiguous, each
// float32 or bfloat16 (dtypes: bit 0 decay, 1 inp, 2 c, 3 h0 set where
// bfloat16) -> y (B, T, di), h_last (B, di, N) float32. No output may
// alias an input.
extern "C" int rt_selective_scan_dt(const void* decay, const void* inp,
                                    const void* c, const void* h0, float* y,
                                    float* h_last, int B, int T, int di,
                                    int N, int dtypes, int device,
                                    void* stream) {
  if (B < 1 || T < 1 || di < 1 || N < 1 || N > kMaxN || dtypes < 0 ||
      dtypes > 15)
    return cudaErrorInvalidValue;
  if (B > 65535) return cudaErrorInvalidConfiguration;
  cudaError_t err = rt::use_device(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (N) {
#define RT_SCAN(N_) \
  case N_:          \
    return launch<N_>(decay, inp, c, h0, y, h_last, B, T, di, dtypes, st);
    RT_SCAN(1) RT_SCAN(2) RT_SCAN(3) RT_SCAN(4) RT_SCAN(5) RT_SCAN(6)
    RT_SCAN(7) RT_SCAN(8) RT_SCAN(9) RT_SCAN(10) RT_SCAN(11) RT_SCAN(12)
    RT_SCAN(13) RT_SCAN(14) RT_SCAN(15) RT_SCAN(16)
#undef RT_SCAN
    default:
      return cudaErrorInvalidValue;
  }
}

// decay, inp (B, T, di, N), c (B, T, N), h0 (B, di, N) contiguous float32
// -> y (B, T, di), h_last (B, di, N). No output may alias an input.
extern "C" int rt_selective_scan(const float* decay, const float* inp,
                                 const float* c, const float* h0, float* y,
                                 float* h_last, int B, int T, int di, int N,
                                 int device, void* stream) {
  return rt_selective_scan_dt(decay, inp, c, h0, y, h_last, B, T, di, N, 0,
                              device, stream);
}
