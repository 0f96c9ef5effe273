// Causal / sliding-window attention with an online softmax over KV tiles
// (flash attention), float32 or bfloat16 in and out, GQA by head index, its
// two products on TF32 tensor cores with a 3-pass split that keeps FP32
// accuracy.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::
// flash_attention_pallas (_flash_kernel). Same function: scores of q
// scaled by 1/sqrt(D) before the dot, keys masked where kpos >= Tk, where
// kpos > qpos (causal) and where kpos <= qpos - window (window > 0), a
// masked score set to the finite -1e30 (never -inf), a running (max m,
// denominator l, weighted sum acc) per query row, and the output
// acc / max(l, 1e-30).
//
// Bound on the H100: tensor operations. A prefill of 8 x 1,024 tokens with
// 16 query heads of 128 does 4 * D FLOP per unmasked (query, key) pair,
// 34.4 GFLOP causal. One TF32 pass keeps ~3 decimal digits, and attention
// on N(0, 1) inputs then lands ~1e-3 off the plain FP32 version, far past
// the port's 2e-5 tolerance. So every product is taken in three passes,
// a * b ~ a_hi * b_hi + a_hi * b_lo + a_lo * b_hi with a_hi = a rounded to
// TF32 (to nearest, ties away, as cvt.rna) and a_lo = a - a_hi cut to TF32,
// each pass a TF32 mma with FP32 accumulation, which lands ~1e-6 off it
// (the CPU model of this arithmetic in tests/test_torch_lm_kernels.py holds
// both). The bound is then 3 x 34.4 GFLOP at 495 TFLOP/s TF32, 0.208 ms;
// the FP32 FMA pipes would need 0.513 ms at 67 TFLOP/s. q, k, v and the
// output are 201 MB (0.060 ms).
//
// Design, and what differs from the TPU kernel:
//  * The TPU grid walks the KV axis in order and carries (m, l, acc) in
//    VMEM scratch from one grid step to the next. Blocks on Hopper run in
//    no order, so one block of 4 warps owns a 64-row query tile of one
//    (batch, head) and loops over 32-key KV tiles itself. Each warp owns 16
//    query rows: its scores (16 x 32), its output rows (16 x D) and its
//    (m, l) stay in registers, in the mma.sync accumulator layout.
//  * Products: mma.sync.aligned.m16n8k8 TF32. S = (q * scale) K^T and
//    O += P V each take three mmas per fragment; every FP32 operand is
//    split into (hi, lo) in registers as it is taken from shared memory (or,
//    for P, from the score accumulators). The two small passes of S
//    accumulate apart from the large one and are added after the loop over
//    D, which also gives the tensor pipe two independent chains.
//  * Layouts: within each 8-wide step of a contraction the index is
//    permuted the same way on both operands (lane column t <-> elements 2t
//    and 2t+1), so a thread takes its two Q or K values with one 8-byte
//    load, and the score accumulators are already P's A fragment (no
//    shuffle). Q and K rows are padded to D + 8 floats and V rows to D + 4,
//    so every fragment load of a warp falls in 32 different banks.
//  * K and V tiles are double-buffered in shared memory and filled by
//    16-byte cp.async.cg copies: the next tile's load runs under this
//    tile's products. Rows past Tk are zero-filled by the copy and masked.
//    The query tile is loaded once, scaled as the TPU kernel scales q.
//  * The online softmax stays in FP32 on the FMA pipes: the row max over a
//    quad of lanes by two xor shuffles, expf, the running l kept per lane
//    and summed over the quad at the end.
//  * A row that sees no key (window > 0 and qpos >= Tk - 1 + window) is
//    what the plain function gives it, the mean of v over the Tk keys (its
//    softmax over Tk scores of -1e30 is uniform), and its lse is written
//    +inf, which the backward reads as the mark of such a row. (The TPU
//    kernel also averages its zero-padded keys there.)
//  * A causal block stops at its diagonal tile and a window block starts at
//    the first tile its first row can see; within a block a warp skips a
//    tile that is masked for all 16 of its rows. The TPU kernel visits
//    every tile. A skipped tile is wholly masked for every row it is
//    skipped for: after a row's diagonal its p underflows to 0, and before
//    its window its p would be wiped by corr = exp(-1e30 - m) = 0 at the
//    row's first real score -- so the result is the same.
//  * GQA: query head h reads KV head h / (Hq / Hkv) straight from k and v,
//    so no repeated copy of k and v is made (the TPU wrapper repeats them).
//  * Layout in memory: q, k, v and the output stay (B, T, H, D) contiguous;
//    no transpose and no padding to whole tiles: query rows past Tq load
//    as zeros and are not written.
//  * Blocks of the last query tiles (the most KV tiles when causal) are
//    numbered first, so the longest blocks start first. Shared memory
//    (Tile<D>::bytes): 78,848 B at D = 96 and 101 KB at D = 128, two blocks
//    (8 warps) an SM; 152,576 B at D = 192 and 201,728 B at D = 256, one
//    block (4 warps) an SM.
//  * When a graph is built, the caller passes lse (B, Hq, Tq) and each row's
//    log-sum-exp m + log(l) of its scaled scores is stored there for the
//    backward (flash_attention_bwd.cu); the output is the same bits with or
//    without it (serving passes null).
//  * D of 64, 96, 128, 192 or 256: 64 and 128 for the smoke
//    configs, qwen3 and the rest; 256 for gemma-7b; 96 and 192 for MLA's
//    q/k widths (minicpm3-4b's 64 + 32 RoPE, deepseek-v3's 128 + 64), whose
//    narrower v (64, 128) the caller pads with zero columns. Every loop over
//    D steps by 4 (16-byte copies) or 8 (an mma's k or n), and BK * D / 4 is
//    a multiple of the block's 128 threads at each D (1,536 = 12 x 128 at
//    192), so 96 and 192 need no power of two. The output accumulator alone
//    is 96 registers a thread at D = 192 (o[24][4]) and 128 at D = 256
//    (o[32][4]). Other head dims up to 256 reach the kernel padded with zero
//    columns to the next of these (nn/attention.py::attend). The backward
//    (flash_attention_bwd.cu) takes the same five. wgmma fed by TMA, the
//    full TF32 rate, is a later step.
//  * dtypes, as the TPU kernel's: q, k and v of one type, float32 or
//    bfloat16, the output in it, rounded once from float; lse is float32
//    either way. At bf16 the K and V tiles are staged as bf16 (half the
//    cp.async bytes and their shared memory; rows of D + 8 elements, so
//    both fragment reads stay in distinct banks) and widened as fragments
//    are formed. q is widened and scaled in float32, as the TPU kernel
//    scales it, and P is float32, so K and V are the only operands of
//    bf16 origin: a bf16 value is exact in TF32, its split's low part is
//    0, and each product drops its a_hi * b_lo pass (two mmas, not three).
//    The tile schedule and every float operation are the float32
//    instance's (an mma that adds only zero products leaves its
//    accumulator as it was), so the bf16 output is the float32 instance's
//    output on the widened inputs, rounded once, and lse is the same bits
//    (chip_smoke.py checks both).
#include <cuda_runtime.h>

#include "dtype.cuh"
#include "launch.cuh"
#include "tf32x3.cuh"

#include <cstdint>

namespace {

constexpr int BQ = 64;                   // query rows a block
constexpr int BK = 32;                   // keys a KV tile
constexpr int kWarps = BQ / 16;
constexpr int kThreads = 32 * kWarps;
constexpr int NS = BK / 8;               // 8-key steps of a tile
constexpr float kNegInf = -1e30f;

// the shared memory of K and V elements of type T
template <int D, typename T = float>
struct Tile {
  static constexpr int QS = D + 8;       // row stride of Q (floats) and K
  static constexpr int VS = dt::kBf16<T> ? D + 8 : D + 4;   // of V
  static constexpr int kQ = BQ * QS;
  static constexpr int kK = BK * QS;     // one stage
  static constexpr int kV = BK * VS;
  static constexpr int kChunk = 16 / sizeof(T);   // elements a cp.async
  static constexpr size_t bytes =
      sizeof(float) * kQ + sizeof(T) * (2 * kK + 2 * kV);
};

using tf32x3::cp_async16;
using tf32x3::cp_async_commit;
using tf32x3::cp_async_wait;
using tf32x3::mma;
using tf32x3::split;

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// the TF32 bits of an element read as a B operand: at bf16 the value
// itself (exact in TF32, its low part 0), at float32 its split
__device__ __forceinline__ void b_split(float x, uint32_t& hi, uint32_t& lo) {
  split(x, hi, lo);
}
__device__ __forceinline__ void b_split(dt::bf16 x, uint32_t& hi,
                                        uint32_t& lo) {
  hi = __float_as_uint(__bfloat162float(x));
  lo = 0;
}

// two consecutive elements as float2
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const dt::bf16* p) {
  return dt::unpack2(*reinterpret_cast<const uint32_t*>(p));
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads, 2)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int Hq, int Tq, int Tk,
                 int q_per_kv, int n_bh, int n_qt,
                 int causal, int window, float scale) {
  using L = Tile<D, T>;
  constexpr bool kB = dt::kBf16<T>;      // drop the b_lo passes
  constexpr int D4 = D / 4;
  constexpr int NT = D / 8;              // 8-column output tiles
  constexpr int DC = D / L::kChunk;      // cp.async chunks a row
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                      // (BQ, QS), q * scale
  T* Ks = reinterpret_cast<T*>(Qs + L::kQ);   // 2 x (BK, QS)
  T* Vs = Ks + 2 * L::kK;                // 2 x (BK, VS)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma group and lane in group
  const int bh = blockIdx.x % n_bh;
  const int qt = n_qt - 1 - blockIdx.x / n_bh;
  const int b = bh / Hq, h = bh % Hq, hk = h / q_per_kv;
  const int Hkv = Hq / q_per_kv;
  const int q0 = qt * BQ;

  // the KV tiles this block can see
  int kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / BK;
  int last_key = Tk - 1;
  if (causal) last_key = min(last_key, min(q0 + BQ - 1, Tq - 1));
  const int kt_end = last_key < 0 ? -1 : last_key / BK;   // inclusive

  const long long kv_row = static_cast<long long>(Hkv) * D;
  const T* kbase = k + (static_cast<long long>(b) * Tk * Hkv + hk) * D;
  const T* vbase = v + (static_cast<long long>(b) * Tk * Hkv + hk) * D;
  auto load_tile = [&](int kt, int stage) {
    T* ks = Ks + stage * L::kK;
    T* vs = Vs + stage * L::kV;
#pragma unroll
    for (int i = 0; i < BK * DC / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / DC, c = (idx - r * DC) * L::kChunk;
      const int key = kt * BK + r;
      const bool ok = key < Tk;
      const long long off = ok ? key * kv_row + c : 0;
      cp_async16(reinterpret_cast<float*>(ks + r * L::QS + c),
                 reinterpret_cast<const float*>(kbase + off), ok);
      cp_async16(reinterpret_cast<float*>(vs + r * L::VS + c),
                 reinterpret_cast<const float*>(vbase + off), ok);
    }
  };
  if (kt_begin <= kt_end) load_tile(kt_begin, 0);
  cp_async_commit();

  // the query tile, scaled, as the TPU kernel scales q before the dot
  for (int idx = tid; idx < BQ * D4; idx += kThreads) {
    const int r = idx / D4, c = (idx - r * D4) * 4, tq = q0 + r;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (tq < Tq)
      val = dt::as_f4(*reinterpret_cast<const typename dt::Vec4<T>::type*>(
          q + ((static_cast<long long>(b) * Tq + tq) * Hq + h) * D + c));
    *reinterpret_cast<float4*>(Qs + r * L::QS + c) =
        make_float4(val.x * scale, val.y * scale, val.z * scale,
                    val.w * scale);
  }

  // this lane's rows: r0 (accumulator entries 0, 1) and r0 + 8 (2, 3)
  const int wq0 = q0 + 16 * warp;
  const int r0 = wq0 + g, r1 = r0 + 8;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  const float* qa = Qs + (16 * warp + g) * L::QS + 2 * t;
  for (int kt = kt_begin, stage = 0; kt <= kt_end; ++kt, stage ^= 1) {
    if (kt < kt_end) load_tile(kt + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();                  // tile kt has landed
    __syncthreads();
    const int k0 = kt * BK;
    // a tile masked for all 16 rows of this warp changes nothing (above)
    const bool skip =
        (causal && k0 > wq0 + 15) ||
        (window > 0 && k0 + BK - 1 <= wq0 - window);
    if (!skip) {
      // S = (q * scale) K^T: 16 x BK, three passes a fragment
      float s[NS][4], s2[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = s2[j][e] = 0.f;
      const T* kb = Ks + stage * L::kK + g * L::QS + 2 * t;
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const float2 x0 = *reinterpret_cast<const float2*>(qa + 8 * kk);
        const float2 x1 =
            *reinterpret_cast<const float2*>(qa + 8 * L::QS + 8 * kk);
        uint32_t ah[4], al[4];
        split(x0.x, ah[0], al[0]);
        split(x1.x, ah[1], al[1]);
        split(x0.y, ah[2], al[2]);
        split(x1.y, ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const float2 y = load2(kb + 8 * j * L::QS + 8 * kk);
          uint32_t bh0, bl0, bh1, bl1;
          split(y.x, bh0, bl0);          // at bf16 bl0 = bl1 = 0
          split(y.y, bh1, bl1);
          mma(s2[j], al, bh0, bh1);
          if constexpr (!kB) mma(s2[j], ah, bl0, bl1);
          mma(s[j], ah, bh0, bh1);
        }
      }
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] += s2[j][e];

      // mask, then the online softmax of rows r0 and r1
      const bool full = k0 + BK <= Tk && (!causal || k0 + BK - 1 <= wq0) &&
                        (window <= 0 || k0 > wq0 + 15 - window);
      if (!full) {
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpos = k0 + 8 * j + 2 * t + (e & 1);
            const int qpos = e < 2 ? r0 : r1;
            bool ok = kpos < Tk;
            if (causal) ok = ok && kpos <= qpos;
            if (window > 0) ok = ok && kpos > qpos - window;
            if (!ok) s[j][e] = kNegInf;
          }
      }
      float mx0 = m[0], mx1 = m[1];
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
        mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
      }
      mx0 = quad_max(mx0);
      mx1 = quad_max(mx1);
      const float c0 = expf(m[0] - mx0), c1 = expf(m[1] - mx1);
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        s[j][0] = expf(s[j][0] - mx0);
        s[j][1] = expf(s[j][1] - mx0);
        s[j][2] = expf(s[j][2] - mx1);
        s[j][3] = expf(s[j][3] - mx1);
        sum0 += s[j][0] + s[j][1];
        sum1 += s[j][2] + s[j][3];
      }
      l[0] = l[0] * c0 + sum0;
      l[1] = l[1] * c1 + sum1;
      m[0] = mx0;
      m[1] = mx1;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        o[n][0] *= c0;
        o[n][1] *= c0;
        o[n][2] *= c1;
        o[n][3] *= c1;
      }

      // O += P V: the score accumulators are P's A fragment as they lie
      const T* vb = Vs + stage * L::kV + 2 * t * L::VS + g;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        uint32_t ah[4], al[4];
        split(s[j][0], ah[0], al[0]);
        split(s[j][2], ah[1], al[1]);
        split(s[j][1], ah[2], al[2]);
        split(s[j][3], ah[3], al[3]);
        const T* vj = vb + 8 * j * L::VS;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          uint32_t bh0, bl0, bh1, bl1;
          b_split(vj[8 * n], bh0, bl0);
          b_split(vj[L::VS + 8 * n], bh1, bl1);
          mma(o[n], al, bh0, bh1);
          if constexpr (!kB) mma(o[n], ah, bl0, bl1);
          mma(o[n], ah, bh0, bh1);
        }
      }
    }
    __syncthreads();                     // the stage is read: refill it
  }

  // Rows from `blind` on see no key (a window past the last key). The plain
  // function's softmax over their Tk scores of -1e30 is uniform, so such a
  // row is the mean of v over the Tk keys; its lse is +inf, the mark the
  // backward reads (in float32 -1e30 + log Tk rounds back to -1e30).
  const int blind = window > 0 && Tk - 1 + window < Tq ? Tk - 1 + window : Tq;
  float* mean = Qs;                      // the query tile is read
  if (q0 + BQ > blind) {                 // uniform in the block
    __syncthreads();                     // no thread still writes Qs
    for (int c = tid; c < D; c += kThreads) {
      float acc = 0.f;
      for (int key = 0; key < Tk; ++key)
        acc += dt::to_f(vbase[key * kv_row + c]);
      mean[c] = acc / static_cast<float>(Tk);
    }
    __syncthreads();
  }
  const bool blind0 = r0 >= blind, blind1 = r1 >= blind;
  const float l0 = quad_sum(l[0]), l1 = quad_sum(l[1]);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  // the row's log-sum-exp of its scaled scores, for the backward: only
  // stored, so `out` is the same bits with or without it
  if (lse != nullptr && t == 0) {
    float* lrow = lse + static_cast<long long>(b * Hq + h) * Tq;
    const float inf = __int_as_float(0x7f800000);
    if (r0 < Tq) lrow[r0] = blind0 ? inf : m[0] + logf(l0);
    if (r1 < Tq) lrow[r1] = blind1 ? inf : m[1] + logf(l1);
  }
  const long long row_stride = static_cast<long long>(Hq) * D;
  T* o0 = out + ((static_cast<long long>(b) * Tq + r0) * Hq + h) * D + 2 * t;
  // two output values, rounded once to T
  auto put = [](T* p, float2 x) {
    if constexpr (kB)
      *reinterpret_cast<uint32_t*>(p) = dt::pack2(x.x, x.y);
    else
      *reinterpret_cast<float2*>(p) = x;
  };
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const float2 mv = blind0 || blind1
                          ? *reinterpret_cast<const float2*>(mean + 8 * n +
                                                             2 * t)
                          : make_float2(0.f, 0.f);
    if (r0 < Tq)
      put(o0 + 8 * n,
          blind0 ? mv : make_float2(o[n][0] * inv0, o[n][1] * inv0));
    if (r1 < Tq)
      put(o0 + 8 * row_stride + 8 * n,
          blind1 ? mv : make_float2(o[n][2] * inv1, o[n][3] * inv1));
  }
}

template <int D, typename T>
struct SmemAttr {};

template <int D, typename T>
cudaError_t launch(const T* q, const T* k, const T* v, T* out,
                   float* lse, int B, int Tq, int Tk, int Hq, int Hkv, int causal,
                   int window, float scale, int device, cudaStream_t st) {
  using L = Tile<D, T>;
  auto kernel = flash_kernel<D, T>;
  // the shared-memory attributes, once per device
  cudaError_t err = rt::once_per_device<SmemAttr<D, T>>(device, [kernel] {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L::bytes));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                static_cast<int>(
                                    cudaSharedmemCarveoutMaxShared));
  });
  if (err != cudaSuccess) return err;
  const long long n_bh = static_cast<long long>(B) * Hq;
  const int n_qt = (Tq + BQ - 1) / BQ;
  const long long blocks = n_bh * n_qt;
  if (n_bh > 0x7fffffffLL || blocks > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(blocks), kThreads, L::bytes, st>>>(
      q, k, v, out, lse, Hq, Tq, Tk, Hq / Hkv, static_cast<int>(n_bh), n_qt,
      causal, window, scale);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0;
}

template <typename T>
cudaError_t dispatch(const T* q, const T* k, const T* v, T* out, float* lse,
                     int B, int Tq, int Tk, int Hq, int Hkv, int D,
                     int causal, int window, float scale, int device,
                     cudaStream_t st) {
  switch (D) {
#define RT_FLASH_D(W)                                                        \
  case W:                                                                   \
    return launch<W, T>(q, k, v, out, lse, B, Tq, Tk, Hq, Hkv, causal,      \
                        window, scale, device, st);
    RT_FLASH_D(64)
    RT_FLASH_D(96)
    RT_FLASH_D(128)
    RT_FLASH_D(192)
    RT_FLASH_D(256)
#undef RT_FLASH_D
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// q, out (B, Tq, Hq, D) and k, v (B, Tk, Hkv, D), contiguous, float32
// (bf16 0) or bfloat16 (bf16 1); lse (B, Hq, Tq) float32, or null when the
// caller needs no log-sum-exp.
extern "C" int rt_flash_attention_dt(const void* q, const void* k,
                                     const void* v, void* out, float* lse,
                                     int B, int Tq, int Tk, int Hq, int Hkv,
                                     int D, int causal, int window,
                                     float scale, int bf16, int device,
                                     void* stream) {
  if (B < 1 || Tq < 1 || Tk < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 ||
      window < 0 || (bf16 != 0 && bf16 != 1))
    return cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out))
    return cudaErrorMisalignedAddress;
  cudaError_t err = rt::use_device(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    using dt::bf16;
    return dispatch(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                    static_cast<const bf16*>(v), static_cast<bf16*>(out),
                    lse, B, Tq, Tk, Hq, Hkv, D, causal, window, scale,
                    device, st);
  }
  return dispatch(static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), static_cast<float*>(out), lse,
                  B, Tq, Tk, Hq, Hkv, D, causal, window, scale, device, st);
}

// q, out (B, Tq, Hq, D) and k, v (B, Tk, Hkv, D), contiguous float32; lse
// (B, Hq, Tq) float32, or null when the caller needs no log-sum-exp.
extern "C" int rt_flash_attention(const float* q, const float* k,
                                  const float* v, float* out, float* lse,
                                  int B, int Tq,
                                  int Tk, int Hq, int Hkv, int D, int causal,
                                  int window, float scale, int device,
                                  void* stream) {
  return rt_flash_attention_dt(q, k, v, out, lse, B, Tq, Tk, Hq, Hkv, D,
                               causal, window, scale, 0, device, stream);
}
