// Causal / sliding-window attention with an online softmax over KV tiles
// (flash attention), float32, GQA by head index.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::
// flash_attention_pallas (_flash_kernel). Same function: scores of q
// scaled by 1/sqrt(D) before the dot, keys masked where kpos >= Tk, where
// kpos > qpos (causal) and where kpos <= qpos - window (window > 0), a
// masked score set to the finite -1e30 (never -inf), a running (max m,
// denominator l, weighted sum acc) per query row, and the output
// acc / max(l, 1e-30).
//
// Bound on the H100: FP32 operations. A prefill of 8 x 1,024 tokens with
// 16 query heads of 128 does 4 * D FLOP per unmasked (query, key) pair,
// 34.4 GFLOP causal, 0.513 ms at the 67 TFLOP/s FP32 peak, against 201 MB
// of q, k, v and output (0.060 ms). Tensor cores would need TF32 or bf16;
// this kernel keeps the reference's FP32 products and runs on the FMA
// pipes.
//
// Design, and what differs from the TPU kernel:
//  * The TPU grid walks the KV axis in order and carries (m, l, acc) in
//    VMEM scratch from one grid step to the next. Blocks on Hopper run in
//    no order, so one block owns a 64-row query tile of one (batch, head)
//    and loops over the KV tiles itself, keeping m and l in registers
//    (replicated over the 16 lanes that share a row) and acc in registers.
//  * A causal block stops at its diagonal tile, and a window block starts
//    at the first tile its first row can see. The TPU kernel visits every
//    tile; a skipped tile is one that is wholly masked for every row of
//    the block, which contributes nothing once a row has seen a real score
//    (its p underflows to 0) and is wiped by corr = exp(-1e30 - m) = 0
//    when the row has not -- so the result is the same.
//  * GQA: query head h reads KV head h / (Hq / Hkv) straight from k and v,
//    so no repeated copy of k and v is made (the TPU wrapper repeats them).
//  * Layout: q, k, v and the output stay (B, T, H, D) contiguous; the
//    kernel computes the row offsets, so no transpose to (B*H, T, D) and no
//    padding to whole tiles: rows past Tq or Tk load as zeros and are
//    masked or not written.
//  * Work: 256 threads as a 16 x 16 grid. For S = Q K^T each thread
//    computes a 4 x 4 patch of the 64 x 64 score tile (rows 4*ty.., keys
//    tx + 16*j) from 16-byte shared-memory loads; for O += P V a 4 x (D/16)
//    patch of the output (rows 4*ty.., columns 4*tx + 64*jj). Row max and
//    row sum are xor-butterfly shuffles over the 16 lanes of a row, so all
//    16 hold the same values. The K tile's shared memory holds P once the
//    scores are read. Q and K rows are padded to D + 4 floats so the 16
//    rows read at once fall in different banks.
//  * Blocks of the last query tiles (the most KV tiles when causal) are
//    numbered first, so the longest blocks start first.
//  * Float32 only, D of 64 or 128 (ROADMAP lists bf16 and other D as open).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BQ = 64;                   // query rows per block
constexpr int BK = 64;                   // keys per KV tile
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

template <int D>
struct Tile {
  static constexpr int QS = D + 4;       // padded row stride of Q and K tiles
  static constexpr int PS = BK + 4;      // padded row stride of the P tile
  static constexpr int kQ = BQ * QS;
  static constexpr int kK = BK * QS;     // also holds P (BQ * PS <= kK)
  static constexpr int kV = BK * D;
  static constexpr int NJ = D / 64;      // float4 output columns per thread
  static constexpr size_t bytes = sizeof(float) * (kQ + kK + kV);
  static_assert(BQ * PS <= kK, "P does not fit in the K tile");
};

__device__ __forceinline__ float row16_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row16_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float comp(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 int Hq, int Tq, int Tk, int q_per_kv, int n_bh, int n_qt,
                 int causal, int window, float scale) {
  using L = Tile<D>;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                      // (BQ, QS), q * scale
  float* Ks = Qs + L::kQ;                // (BK, QS); then P (BQ, PS)
  float* Vs = Ks + L::kK;                // (BK, D)
  float* Ps = Ks;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.x % n_bh;
  const int qt = n_qt - 1 - blockIdx.x / n_bh;
  const int b = bh / Hq, h = bh % Hq, hk = h / q_per_kv;
  const int Hkv = Hq / q_per_kv;
  const int q0 = qt * BQ;
  constexpr int D4 = D / 4;

  // the query tile, scaled, as the TPU kernel scales q before the dot
  for (int idx = tid; idx < BQ * D4; idx += kThreads) {
    const int r = idx / D4, c = (idx - r * D4) * 4, t = q0 + r;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t < Tq)
      val = *reinterpret_cast<const float4*>(
          q + ((static_cast<long long>(b) * Tq + t) * Hq + h) * D + c);
    *reinterpret_cast<float4*>(Qs + r * L::QS + c) =
        make_float4(val.x * scale, val.y * scale, val.z * scale,
                    val.w * scale);
  }

  // the KV tiles this block can see
  int kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / BK;
  int last_key = Tk - 1;
  if (causal) {
    const int last_q = min(q0 + BQ - 1, Tq - 1);
    last_key = min(last_key, last_q);
  }
  const int kt_end = last_key < 0 ? -1 : last_key / BK;   // inclusive

  float m[4], l[4], acc[4][4 * L::NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * L::NJ; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt_begin; kt <= kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                     // the last tile's P and V are read
    for (int idx = tid; idx < BK * D4; idx += kThreads) {
      const int r = idx / D4, c = (idx - r * D4) * 4, t = k0 + r;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (t < Tk) {
        const long long off =
            ((static_cast<long long>(b) * Tk + t) * Hkv + hk) * D + c;
        kv = *reinterpret_cast<const float4*>(k + off);
        vv = *reinterpret_cast<const float4*>(v + off);
      }
      *reinterpret_cast<float4*>(Ks + r * L::QS + c) = kv;
      *reinterpret_cast<float4*>(Vs + r * D + c) = vv;
    }
    __syncthreads();

    // S = (q * scale) K^T, a 4 x 4 patch per thread
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty * 4 + i) * L::QS + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * L::QS + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // mask, then the online softmax of each of the thread's 4 rows
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool ok = kpos < Tk;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        if (!ok) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row16_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      l[i] = l[i] * corr + row16_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * L::NJ; ++c) acc[i][c] *= corr;
    }

    __syncthreads();                     // every thread has read K
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(ty * 4 + i) * L::PS + tx + 16 * j] = s[i][j];
    __syncthreads();

    // acc += P V, a 4 x (4 * NJ) patch per thread
#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (ty * 4 + i) * L::PS + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int jj = 0; jj < L::NJ; ++jj) {
          const float4 vv = *reinterpret_cast<const float4*>(
              Vs + (c + cc) * D + jj * 64 + tx * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = comp(pv[i], cc);
            acc[i][jj * 4 + 0] = fmaf(p, vv.x, acc[i][jj * 4 + 0]);
            acc[i][jj * 4 + 1] = fmaf(p, vv.y, acc[i][jj * 4 + 1]);
            acc[i][jj * 4 + 2] = fmaf(p, vv.z, acc[i][jj * 4 + 2]);
            acc[i][jj * 4 + 3] = fmaf(p, vv.w, acc[i][jj * 4 + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty * 4 + i;
    if (t >= Tq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    float* orow = out + ((static_cast<long long>(b) * Tq + t) * Hq + h) * D;
#pragma unroll
    for (int jj = 0; jj < L::NJ; ++jj)
      *reinterpret_cast<float4*>(orow + jj * 64 + tx * 4) = make_float4(
          acc[i][jj * 4 + 0] * inv, acc[i][jj * 4 + 1] * inv,
          acc[i][jj * 4 + 2] * inv, acc[i][jj * 4 + 3] * inv);
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, float* out,
                   int B, int Tq, int Tk, int Hq, int Hkv, int causal,
                   int window, float scale, cudaStream_t st) {
  auto kernel = flash_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Tile<D>::bytes));
  if (err != cudaSuccess) return err;
  const long long n_bh = static_cast<long long>(B) * Hq;
  const int n_qt = (Tq + BQ - 1) / BQ;
  const long long blocks = n_bh * n_qt;
  if (n_bh > 0x7fffffffLL || blocks > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(blocks), kThreads, Tile<D>::bytes, st>>>(
      q, k, v, out, Hq, Tq, Tk, Hq / Hkv, static_cast<int>(n_bh), n_qt,
      causal, window, scale);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// q, out (B, Tq, Hq, D) and k, v (B, Tk, Hkv, D), contiguous float32.
extern "C" int rt_flash_attention(const float* q, const float* k,
                                  const float* v, float* out, int B, int Tq,
                                  int Tk, int Hq, int Hkv, int D, int causal,
                                  int window, float scale, int device,
                                  void* stream) {
  if (B < 1 || Tq < 1 || Tk < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 ||
      window < 0)
    return cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out))
    return cudaErrorMisalignedAddress;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch<64>(q, k, v, out, B, Tq, Tk, Hq, Hkv, causal, window,
                      scale, st);
  if (D == 128)
    return launch<128>(q, k, v, out, B, Tq, Tk, Hq, Hkv, causal, window,
                       scale, st);
  return cudaErrorInvalidValue;
}
