// Backward of the selective scan, in float32: the gradients of
//
//   h_t = decay_t * h_{t-1} + inp_t          decay, inp (B, T, di, N)
//   y_t = sum_n h_t[n] * C_t[n]              C (B, T, N)  -> y (B, T, di)
//
// given gy (B, T, di) and gh (B, di, N), the gradient of h_T. With the
// reverse recurrence g_t = gy_t * C_t + decay_{t+1} * g_{t+1} (g_T taking
// gh as well):
//
//   d_inp_t = g_t,  d_decay_t = g_t * h_{t-1},  dh0 = decay_0 * g_0,
//   dC_t[n] = sum_d gy_t[d] * h_t[d, n].
//
// The TPU package has no backward kernel: its Mamba mixer runs
// _selective_scan_fused under jax.checkpoint and XLA differentiates it
// (repro/nn/ssm.py). This kernel is the gradient of the function of
// selective_scan.cu, which replaces repro/kernels/selective_scan.py::
// selective_scan_pallas; its plain version is kernels/ref.py::
// selective_scan_bwd_ref.
//
// Bound on the H100: device-memory bytes. decay and inp are read and their
// two gradients written, 4 B T di N floats: at Jamba's training shape (2,
// 1,024, 8,192, 16) 4.29 GB, 1.28 ms at 3.35 TB/s. The arithmetic is a few
// FLOP an element (0.02 ms at the FP32 peak).
//
// Design:
//  * One thread a (b, channel d, state n): the recurrence runs down its own
//    scalar, and a warp's 32 threads read 32 consecutive floats of decay
//    and inp each step. A block holds 256 threads: 256 / N channels of one
//    batch row (16 at N = 16), so 2 x 8,192 channels are 1,024 blocks.
//  * The states are not all kept (they would be as large as decay). A
//    forward pass over T writes each thread's h at the start of every
//    chunk of kL = 16 steps to a scratch (B, ceil(T / kL), di, N). Then the
//    chunks are taken in reverse: the chunk's decay and inp are read into
//    registers, its kL states recomputed from the checkpoint (the forward
//    kernel's FMA, so the same bits) into shared memory, and the reverse
//    recurrence runs over the chunk with decay_{t+1} from the registers.
//    decay and inp are read twice, the gradients written once: 6 of the
//    bound's 4 passes.
//  * dC sums over di, across blocks: no atomics. With the chunk's states in
//    shared memory and its gy staged beside them, each block sums its
//    channels for every (t, n) of the chunk in channel order and writes the
//    partial to a scratch (B, blocks, T, N); a second kernel,
//    scan_bwd_reduce, adds the blocks' partials in block order. Two calls
//    give the same bits.
//  * No padding: the last chunk runs T mod kL steps, and threads past di
//    (or past 256 / N channels, where N does not divide 256) only take part
//    in the barriers, with zero states.
//  * dtypes, as the forward's: decay, inp, c and h0 each float32 or
//    bfloat16 (a mask bit each), widened at the load; gy and gh float32 (the
//    forward's outputs are). Each gradient is stored in its input's type,
//    rounded once from float (dc by the reduce kernel). The arithmetic and
//    its order are the float32 instance's, so the bf16 gradients are the
//    float32 instance's on the widened inputs, rounded once. decay's and
//    inp's types (the arrays a thread reads and writes every step) are
//    template parameters, four instances a state count; c's and h0's are
//    read at run time. Reading all four types at run time put a branch at
//    each load and store of a chunk: on an H100 the bf16 backward then ran
//    3.2x the float32 one at Jamba's training shape (8.06 against 2.52 ms),
//    and one branch a chunk made the float32 instance 1.4x slower.
#include <cuda_runtime.h>

#include "dtype.cuh"
#include "launch.cuh"

#include <cstdint>

namespace {

constexpr int kThreads = 256;            // (channel, state) pairs a block
constexpr int kL = 16;                   // steps a checkpointed chunk
constexpr int kMaxN = 16;
// the mask bits of the four inputs' types (and so of their gradients')
constexpr int kDecayBf16 = 1, kInpBf16 = 2, kCBf16 = 4, kH0Bf16 = 8;

// element i of a float32 (bf false) or bfloat16 array, widened
__device__ __forceinline__ float load1(const void* p, bool bf, long long i) {
  return bf ? dt::to_f(static_cast<const dt::bf16*>(p)[i])
            : static_cast<const float*>(p)[i];
}

// element i of a float32 or bfloat16 array, v rounded once to its type
__device__ __forceinline__ void store1(void* p, bool bf, long long i,
                                       float v) {
  if (bf)
    static_cast<dt::bf16*>(p)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(p)[i] = v;
}

template <int N, typename TD, typename TI>
__global__ void __launch_bounds__(kThreads)
    scan_bwd_kernel(const TD* __restrict__ decay,
                    const TI* __restrict__ inp,
                    const void* __restrict__ c,
                    const void* __restrict__ h0,
                    const float* __restrict__ gy,
                    const float* __restrict__ gh,
                    TD* __restrict__ d_decay, TI* __restrict__ d_inp,
                    void* __restrict__ dh0, float* __restrict__ ckpt,
                    float* __restrict__ part, int T, int di, int dtypes) {
  const bool bc = dtypes & kCBf16, bh = dtypes & kH0Bf16;
  constexpr int DPB = kThreads / N;      // channels a block
  __shared__ float hs[kL * kThreads];    // the chunk's states
  __shared__ float gys[kL * DPB];        // the chunk's gy of these channels
  __shared__ float cs[kL * N];           // the chunk's C
  const int b = blockIdx.y, tid = threadIdx.x;
  const int dl = tid / N, n = tid - dl * N;
  const int d0 = blockIdx.x * DPB, d = d0 + dl;
  const bool active = dl < DPB && d < di;
  const int dj = dl < DPB ? dl : 0;      // a column of gys to read
  const int nck = (T + kL - 1) / kL;
  const long long slab = static_cast<long long>(di) * N;   // a (b, t)
  const long long chan = static_cast<long long>(d) * N + n;
  const long long run = static_cast<long long>(b) * T * slab + chan;
  const long long state = static_cast<long long>(b) * slab + chan;
  const long long ck = static_cast<long long>(b) * nck * slab + chan;

  // forward: the state at the start of each chunk past the first
  const float start = active ? load1(h0, bh, state) : 0.f;
  if (nck > 1) {
    float h = start;
    for (int k = 0; k + 1 < nck; ++k) {
      float a[kL], x[kL];
      const long long r0 = run + static_cast<long long>(k) * kL * slab;
#pragma unroll
      for (int i = 0; i < kL; ++i) {
        a[i] = active ? dt::to_f(decay[r0 + i * slab]) : 0.f;
        x[i] = active ? dt::to_f(inp[r0 + i * slab]) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kL; ++i) h = fmaf(a[i], h, x[i]);
      if (active) ckpt[ck + (k + 1) * slab] = h;
    }
  }

  // reverse, chunk by chunk
  float gnext = active ? gh[state] : 0.f;  // dL/dh_t from later steps
  const int nblk = gridDim.x;
  float* pb = part + (static_cast<long long>(b) * nblk + blockIdx.x) * T * N;
  for (int k = nck - 1; k >= 0; --k) {
    const int t0 = k * kL, len = min(kL, T - t0);
    __syncthreads();                     // the last chunk's shared reads
    for (int i = tid; i < kL * DPB; i += kThreads) {
      const int tt = i / DPB, j = i - tt * DPB;
      gys[i] = tt < len && d0 + j < di
                   ? gy[(static_cast<long long>(b) * T + t0 + tt) * di + d0 +
                        j]
                   : 0.f;
    }
    for (int i = tid; i < kL * N; i += kThreads)
      cs[i] = i < len * N
                  ? load1(c, bc, (static_cast<long long>(b) * T + t0) * N + i)
                  : 0.f;
    const float hk = k == 0 ? start : (active ? ckpt[ck + k * slab] : 0.f);
    float a[kL], x[kL];
    const long long r0 = run + static_cast<long long>(t0) * slab;
#pragma unroll
    for (int i = 0; i < kL; ++i) {
      const bool ok = active && i < len;
      a[i] = ok ? dt::to_f(decay[r0 + i * slab]) : 0.f;
      x[i] = ok ? dt::to_f(inp[r0 + i * slab]) : 0.f;
    }
    float h = hk;
#pragma unroll
    for (int i = 0; i < kL; ++i) {
      h = fmaf(a[i], h, x[i]);
      hs[i * kThreads + tid] = h;
    }
    __syncthreads();
    // this block's part of dC for the chunk's (t, n), channels in order
    for (int i = tid; i < len * N; i += kThreads) {
      const int tt = i / N, m = i - tt * N;
      float acc = 0.f;
#pragma unroll 4
      for (int j = 0; j < DPB; ++j)
        acc = fmaf(gys[tt * DPB + j], hs[tt * kThreads + j * N + m], acc);
      pb[static_cast<long long>(t0) * N + i] = acc;
    }
    // the reverse recurrence over the chunk
#pragma unroll
    for (int i = kL - 1; i >= 0; --i) {
      if (i < len) {
        const float g = fmaf(gys[i * DPB + dj], cs[i * N + n], gnext);
        const float hprev = i > 0 ? hs[(i - 1) * kThreads + tid] : hk;
        if (active) {
          d_inp[r0 + i * slab] = dt::from_f<TI>(g);
          d_decay[r0 + i * slab] = dt::from_f<TD>(g * hprev);
        }
        gnext = a[i] * g;
      }
    }
  }
  if (active) store1(dh0, bh, state, gnext);
}

// dC[b, t, n] = the blocks' partials summed in block order, rounded once to
// c's type (bc): one thread a (b, t, n)
__global__ void __launch_bounds__(256)
    scan_bwd_reduce(const float* __restrict__ part, void* __restrict__ dc,
                    int T, int N, int nblk, long long count, bool bc) {
  const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= count) return;
  const long long per_b = static_cast<long long>(T) * N;
  const long long b = i / per_b, tn = i - b * per_b;
  const float* p = part + b * nblk * per_b + tn;
  float acc = 0.f;
  for (int j = 0; j < nblk; ++j) acc += p[j * per_b];
  store1(dc, bc, i, acc);
}

template <int N>
cudaError_t launch(const void* decay, const void* inp, const void* c,
                   const void* h0, const float* gy, const float* gh,
                   void* d_decay, void* d_inp, void* dc, void* dh0,
                   float* ckpt, float* part, int B, int T, int di, int dtypes,
                   cudaStream_t st) {
  constexpr int DPB = kThreads / N;
  const int nblk = (di + DPB - 1) / DPB;
  const dim3 grid(nblk, B);
  using dt::bf16;
#define RT_SCAN_BWD_T(TD, TI)                                              \
  scan_bwd_kernel<N, TD, TI><<<grid, kThreads, 0, st>>>(                   \
      static_cast<const TD*>(decay), static_cast<const TI*>(inp), c, h0,   \
      gy, gh, static_cast<TD*>(d_decay), static_cast<TI*>(d_inp), dh0,     \
      ckpt, part, T, di, dtypes)
  switch (dtypes & (kDecayBf16 | kInpBf16)) {
    case 0: RT_SCAN_BWD_T(float, float); break;
    case kDecayBf16: RT_SCAN_BWD_T(bf16, float); break;
    case kInpBf16: RT_SCAN_BWD_T(float, bf16); break;
    default: RT_SCAN_BWD_T(bf16, bf16);
  }
#undef RT_SCAN_BWD_T
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long count = static_cast<long long>(B) * T * N;
  scan_bwd_reduce<<<static_cast<unsigned>((count + 255) / 256), 256, 0,
                    st>>>(part, dc, T, N, nblk, count,
                          (dtypes & kCBf16) != 0);
  return cudaGetLastError();
}

}  // namespace

// decay, inp (B, T, di, N), c (B, T, N), h0 (B, di, N), each float32 or
// bfloat16 (dtypes: bit 0 decay, 1 inp, 2 c, 3 h0 set where bfloat16), gy
// (B, T, di) and gh (B, di, N) float32, all contiguous -> d_decay, d_inp
// (B, T, di, N), dc (B, T, N), dh0 (B, di, N), each in its input's type.
// Scratch: ckpt (B, ceil(T / 16), di, N) floats and part (B, ceil(di /
// floor(256 / N)), T, N) floats (kernels/selective_scan.py::bwd_scratch).
// No output or scratch may alias another buffer.
extern "C" int rt_selective_scan_bwd_dt(const void* decay, const void* inp,
                                        const void* c, const void* h0,
                                        const float* gy, const float* gh,
                                        void* d_decay, void* d_inp, void* dc,
                                        void* dh0, float* ckpt, float* part,
                                        int B, int T, int di, int N,
                                        int dtypes, int device,
                                        void* stream) {
  if (B < 1 || T < 1 || di < 1 || N < 1 || N > kMaxN || dtypes < 0 ||
      dtypes > 15)
    return cudaErrorInvalidValue;
  if (B > 65535 ||
      static_cast<long long>(B) * T * N > 0x7fffffffLL * 256)
    return cudaErrorInvalidConfiguration;
  cudaError_t err = rt::use_device(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (N) {
#define RT_SCAN_BWD(N_)                                                   \
  case N_:                                                                \
    return launch<N_>(decay, inp, c, h0, gy, gh, d_decay, d_inp, dc, dh0, \
                      ckpt, part, B, T, di, dtypes, st);
    RT_SCAN_BWD(1) RT_SCAN_BWD(2) RT_SCAN_BWD(3) RT_SCAN_BWD(4)
    RT_SCAN_BWD(5) RT_SCAN_BWD(6) RT_SCAN_BWD(7) RT_SCAN_BWD(8)
    RT_SCAN_BWD(9) RT_SCAN_BWD(10) RT_SCAN_BWD(11) RT_SCAN_BWD(12)
    RT_SCAN_BWD(13) RT_SCAN_BWD(14) RT_SCAN_BWD(15) RT_SCAN_BWD(16)
#undef RT_SCAN_BWD
    default:
      return cudaErrorInvalidValue;
  }
}

// The float32 entry: rt_selective_scan_bwd_dt with every input float32.
extern "C" int rt_selective_scan_bwd(const float* decay, const float* inp,
                                     const float* c, const float* h0,
                                     const float* gy, const float* gh,
                                     float* d_decay, float* d_inp, float* dc,
                                     float* dh0, float* ckpt, float* part,
                                     int B, int T, int di, int N, int device,
                                     void* stream) {
  return rt_selective_scan_bwd_dt(decay, inp, c, h0, gy, gh, d_decay, d_inp,
                                  dc, dh0, ckpt, part, B, T, di, N, 0, device,
                                  stream);
}
