// Backward of causal / sliding-window flash attention, float32, GQA by head
// index: dq, dk and dv from q, k, v, the forward's output o and its
// per-row log-sum-exp lse, and the output gradient do.
//
// The TPU package has no backward kernel: its LM calls plain jnp attention
// and XLA differentiates it. This is the same gradient taken by the flash
// route (the gradient of repro/kernels/flash_attention.py::
// flash_attention_pallas's function, which this file's forward twin,
// flash_attention.cu, replaces), so the (B, H, T, T) scores never reach
// device memory:
//   delta_i = sum_d do_i * o_i                      (flash_bwd_delta)
//   P = exp(S * scale - lse),  S = q k^T            (recomputed per tile)
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - delta) elementwise
//   dK = dS^T Q * scale,  dQ = dS K * scale.
// Masking is the forward's, with T queries over the same T keys: a key is
// seen where kpos <= qpos (causal) and kpos > qpos - window (window > 0).
// Every row sees its own key, so a masked entry's P is exactly 0, as the
// forward's exp(-1e30 - m) is.
//
// Bound on the H100: operations. At qwen3's training shape (8 x 1,024
// tokens, 16 query heads and 8 KV heads of 128, causal) the five products
// are 5 * 2 * D FLOP a visible (query, key) pair, 86 GFLOP: 1.283 ms on
// the FP32 pipes at 67 TFLOP/s, 0.521 ms as three TF32 passes at 495
// TFLOP/s. The inputs and gradients are 403 MB (0.120 ms).
//
// Design: three launches, simple FP32 FMA tiles (no tensor cores yet).
//  * flash_bwd_delta: one warp a (b, t, h) row, delta into (B, Hq, T).
//  * flash_bwd_dkdv: one block of 4 warps a (b, KV head, 32-key tile). The
//    K and V tiles stay in shared memory; the block walks the q_per_kv
//    query heads of its group and the 32-row query tiles that see its keys,
//    recomputing S and dP for each (32 x 32, 8 + 8 a thread), and keeps
//    dK and dV (32 x D) in registers. So each KV head's gradient is summed
//    over its group in one fixed order, with no atomics: the result is the
//    same bits run to run.
//  * flash_bwd_dq: one block a (b, q head, 32-row query tile), the Q and dO
//    tiles resident, walking the KV tiles its rows see; it recomputes S
//    and dP again (two more products than the five counted above).
// Shared-memory rows are padded to D + 4 floats, so the 16-byte fragment
// loads of a quarter warp fall in distinct banks. The streamed tiles (Q,
// dO, lse and delta in dkdv; K and V in dq) are double-buffered and filled
// by cp.async, the next tile's copy running under this tile's work; rows
// past T load as zeros and are not written. 111 KB of shared memory at
// D = 128: two blocks an SM. wgmma fed by TMA and the TF32 three-pass
// split of the forward are the next steps (ROADMAP Queue 2).
#include <cuda_runtime.h>

#include "launch.cuh"

#include <cstdint>
#include <initializer_list>

namespace {

constexpr int BQ = 32;                   // query rows a tile
constexpr int BKV = 32;                  // keys a tile
constexpr int kThreads = 128;
constexpr int PS = 36;                   // row stride of the P / dS tiles

template <int D>
struct Tiles {
  static constexpr int S = D + 4;        // row stride of a (rows, D) tile
  static constexpr int kRows = 32 * S;   // one (32, D) tile
  // six (32, D) tiles (the resident pair and two stages of the streamed
  // pair), two (32, PS) tiles and two stages of lse / delta of 32 rows:
  // 111,104 bytes at D = 128, two blocks an SM
  static constexpr size_t bytes =
      sizeof(float) * (6 * kRows + 2 * 32 * PS + 4 * 32);
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void fma4(float& acc, const float4& a,
                                     const float4& b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  acc = fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float4& acc, float a, const float4& b) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

__device__ __forceinline__ unsigned smem_addr(const float* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared, asynchronously; zeros when !pred
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// start copying rows [row0, row0 + 32) of a (B, T, H, D) tensor at head h
// into a (32, D + 4) shared tile; rows past T as zeros
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int b, int row0, int T, int H,
                                          int h) {
  constexpr int D4 = D / 4;
#pragma unroll
  for (int i = 0; i < 32 * D4 / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / D4, c = (idx - r * D4) * 4, t = row0 + r;
    const long long off =
        t < T ? ((static_cast<long long>(b) * T + t) * H + h) * D + c : 0;
    cp_async16(dst + r * Tiles<D>::S + c, src + off, t < T);
  }
}

// start copying lse and delta of rows [row0, row0 + 32) of (b, h)
__device__ __forceinline__ void load_row_stats(float* ls, float* dl,
                                               const float* lse,
                                               const float* delta, int b,
                                               int h, int Hq, int row0,
                                               int T) {
  const int r = threadIdx.x;
  if (r < 32) {
    const bool ok = row0 + r < T;
    const long long i =
        ok ? (static_cast<long long>(b) * Hq + h) * T + row0 + r : 0;
    cp_async4(ls + r, lse + i, ok);
    cp_async4(dl + r, delta + i, ok);
  }
}

// S = Q K^T and dP = dO V^T on a (32 query, 32 key) tile: this thread's
// rows ty and ty + 16, keys tx + 8j, turned into P and dS in place
template <int D>
__device__ __forceinline__ void tile_grads(
    const float* Qs, const float* dOs, const float* Ks, const float* Vs,
    const float* ls, const float* dl, int q0, int k0, int T, int causal,
    int window, float scale, float (&p)[2][4], float (&ds)[2][4]) {
  constexpr int S = Tiles<D>::S;
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
  float s[2][4], dp[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; d += 4) {
    float4 q[2], o[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      q[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * S + d);
      o[i] = *reinterpret_cast<const float4*>(dOs + (ty + 16 * i) * S + d);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 kk =
          *reinterpret_cast<const float4*>(Ks + (tx + 8 * j) * S + d);
      const float4 vv =
          *reinterpret_cast<const float4*>(Vs + (tx + 8 * j) * S + d);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        fma4(s[i][j], q[i], kk);
        fma4(dp[i][j], o[i], vv);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = ty + 16 * i, qpos = q0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kpos = k0 + tx + 8 * j;
      bool ok = qpos < T && kpos < T;
      if (causal) ok = ok && kpos <= qpos;
      if (window > 0) ok = ok && kpos > qpos - window;
      p[i][j] = ok ? expf(s[i][j] * scale - ls[r]) : 0.f;
      ds[i][j] = p[i][j] * (dp[i][j] - dl[r]);
    }
  }
}

// delta[(b, h, t)] = <do, o> of the (b, t, h) row: one warp a row
template <int D>
__global__ void __launch_bounds__(256)
    flash_bwd_delta(const float* __restrict__ o, const float* __restrict__ dO,
                    float* __restrict__ delta, long long rows, int T,
                    int Hq) {
  const long long row =
      static_cast<long long>(blockIdx.x) * 8 + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  float acc = 0.f;
  if (lane < D / 4) {
    const float4 a = *reinterpret_cast<const float4*>(o + row * D + 4 * lane);
    const float4 g =
        *reinterpret_cast<const float4*>(dO + row * D + 4 * lane);
    fma4(acc, a, g);
  }
  acc = warp_sum(acc);
  if (lane == 0) {
    const int h = static_cast<int>(row % Hq);
    const long long bt = row / Hq;
    const long long b = bt / T, t = bt - b * T;
    delta[(b * Hq + h) * T + t] = acc;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dO,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dk,
                   float* __restrict__ dv, int T, int Hq, int Hkv,
                   int causal, int window, float scale) {
  using L = Tiles<D>;
  constexpr int S = L::S;
  constexpr int DG = D / 4;              // float4 columns
  constexpr int KG = kThreads / DG;      // key groups
  constexpr int KPT = BKV / KG;          // keys a thread, contiguous
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + L::kRows;
  float* Qs = Vs + L::kRows;             // 2 stages of (Q, dO)
  float* Ps = Qs + 4 * L::kRows;         // (32 rows, PS): P
  float* dSs = Ps + 32 * PS;             // (32 rows, PS): dS
  float* stats = dSs + 32 * PS;          // 2 stages of (lse, delta)

  const int n_bh = gridDim.x / ((T + BKV - 1) / BKV);
  const int kt = blockIdx.x / n_bh;      // first tiles see the most rows
  const int bh = blockIdx.x - kt * n_bh;
  const int b = bh / Hkv, hk = bh - b * Hkv, q_per_kv = Hq / Hkv;
  const int k0 = kt * BKV;
  const int n_qt = (T + BQ - 1) / BQ;
  const int qt_begin = causal ? k0 / BQ : 0;
  int qt_end = n_qt - 1;                 // inclusive
  if (window > 0) qt_end = min(qt_end, (k0 + BKV - 2 + window) / BQ);
  const int per_head = qt_end - qt_begin + 1;
  const int n_iter = q_per_kv * per_head;  // (head, query tile) pairs

  // iteration it's Q, dO, lse and delta into stage st
  auto load = [&](int it, int st) {
    const int h = hk * q_per_kv + it / per_head;
    const int q0 = (qt_begin + it % per_head) * BQ;
    float* qs = Qs + 2 * st * L::kRows;
    load_rows<D>(qs, q, b, q0, T, Hq, h);
    load_rows<D>(qs + L::kRows, dO, b, q0, T, Hq, h);
    load_row_stats(stats + 64 * st, stats + 64 * st + 32, lse, delta, b, h,
                   Hq, q0, T);
  };
  load_rows<D>(Ks, k, b, k0, T, Hkv, hk);
  load_rows<D>(Vs, v, b, k0, T, Hkv, hk);
  load(0, 0);
  cp_async_commit();

  const int dg = threadIdx.x % DG, kg = threadIdx.x / DG;
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
  float4 ak[KPT], av[KPT];
#pragma unroll
  for (int c = 0; c < KPT; ++c)
    ak[c] = av[c] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int it = 0, st = 0; it < n_iter; ++it, st ^= 1) {
    if (it + 1 < n_iter) load(it + 1, st ^ 1);  // under this tile's work
    cp_async_commit();
    cp_async_wait<1>();                  // stage st has landed
    __syncthreads();
    const float* qs = Qs + 2 * st * L::kRows;
    const float* dos = qs + L::kRows;
    const float* ls = stats + 64 * st;
    const int q0 = (qt_begin + it % per_head) * BQ;
    float p[2][4], ds[2][4];
    tile_grads<D>(qs, dos, Ks, Vs, ls, ls + 32, q0, k0, T, causal, window,
                  scale, p, ds);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        Ps[(ty + 16 * i) * PS + tx + 8 * j] = p[i][j];
        dSs[(ty + 16 * i) * PS + tx + 8 * j] = ds[i][j];
      }
    __syncthreads();
    // dV += P^T dO, dK += dS^T Q over the tile's 32 rows, in row order
#pragma unroll 4
    for (int r = 0; r < BQ; ++r) {
      const float4 o4 =
          *reinterpret_cast<const float4*>(dos + r * S + 4 * dg);
      const float4 q4 = *reinterpret_cast<const float4*>(qs + r * S + 4 * dg);
#pragma unroll
      for (int c = 0; c < KPT; c += 4) {
        const float4 p4 = *reinterpret_cast<const float4*>(
            Ps + r * PS + kg * KPT + c);
        const float4 s4 = *reinterpret_cast<const float4*>(
            dSs + r * PS + kg * KPT + c);
        axpy4(av[c], p4.x, o4);
        axpy4(av[c + 1], p4.y, o4);
        axpy4(av[c + 2], p4.z, o4);
        axpy4(av[c + 3], p4.w, o4);
        axpy4(ak[c], s4.x, q4);
        axpy4(ak[c + 1], s4.y, q4);
        axpy4(ak[c + 2], s4.z, q4);
        axpy4(ak[c + 3], s4.w, q4);
      }
    }
    __syncthreads();                     // the stage is read: refill it
  }
#pragma unroll
  for (int c = 0; c < KPT; ++c) {
    const int kpos = k0 + kg * KPT + c;
    if (kpos < T) {
      const long long off =
          ((static_cast<long long>(b) * T + kpos) * Hkv + hk) * D + 4 * dg;
      *reinterpret_cast<float4*>(dk + off) =
          make_float4(ak[c].x * scale, ak[c].y * scale, ak[c].z * scale,
                      ak[c].w * scale);
      *reinterpret_cast<float4*>(dv + off) = av[c];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dO,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq,
                 int T, int Hq, int Hkv, int causal, int window,
                 float scale) {
  using L = Tiles<D>;
  constexpr int S = L::S;
  constexpr int DG = D / 4;
  constexpr int RG = kThreads / DG;      // row groups
  constexpr int RPT = BQ / RG;           // rows a thread, contiguous
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + L::kRows;
  float* Ks = dOs + L::kRows;            // 2 stages of (K, V)
  float* dSt = Ks + 4 * L::kRows;        // (32 keys, PS): dS transposed
  float* ls = dSt + 2 * 32 * PS;         // (one of the two PS tiles unused)
  float* dl = ls + 32;

  const int n_qt = (T + BQ - 1) / BQ;
  const int n_bh = gridDim.x / n_qt;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / n_bh;
  const int bh = blockIdx.x % n_bh;
  const int b = bh / Hq, h = bh - b * Hq, hk = h / (Hq / Hkv);
  const int q0 = qt * BQ;
  int kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / BKV;
  int last_key = T - 1;
  if (causal) last_key = min(last_key, q0 + BQ - 1);
  const int kt_end = last_key / BKV;     // inclusive

  load_rows<D>(Qs, q, b, q0, T, Hq, h);
  load_rows<D>(dOs, dO, b, q0, T, Hq, h);
  load_row_stats(ls, dl, lse, delta, b, h, Hq, q0, T);
  load_rows<D>(Ks, k, b, kt_begin * BKV, T, Hkv, hk);
  load_rows<D>(Ks + L::kRows, v, b, kt_begin * BKV, T, Hkv, hk);
  cp_async_commit();

  const int dg = threadIdx.x % DG, rg = threadIdx.x / DG;
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
  float4 acc[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int kt = kt_begin, st = 0; kt <= kt_end; ++kt, st ^= 1) {
    if (kt < kt_end) {                   // the next tile under this one
      float* ks = Ks + 2 * (st ^ 1) * L::kRows;
      load_rows<D>(ks, k, b, (kt + 1) * BKV, T, Hkv, hk);
      load_rows<D>(ks + L::kRows, v, b, (kt + 1) * BKV, T, Hkv, hk);
    }
    cp_async_commit();
    cp_async_wait<1>();                  // stage st has landed
    __syncthreads();
    const float* ks = Ks + 2 * st * L::kRows;
    float p[2][4], ds[2][4];
    tile_grads<D>(Qs, dOs, ks, ks + L::kRows, ls, dl, q0, kt * BKV, T,
                  causal, window, scale, p, ds);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dSt[(tx + 8 * j) * PS + ty + 16 * i] = ds[i][j];
    __syncthreads();
    // dQ += dS K over the tile's 32 keys, in key order
#pragma unroll 4
    for (int c = 0; c < BKV; ++c) {
      const float4 k4 = *reinterpret_cast<const float4*>(ks + c * S + 4 * dg);
#pragma unroll
      for (int r = 0; r < RPT; r += 4) {
        const float4 s4 = *reinterpret_cast<const float4*>(
            dSt + c * PS + rg * RPT + r);
        axpy4(acc[r], s4.x, k4);
        axpy4(acc[r + 1], s4.y, k4);
        axpy4(acc[r + 2], s4.z, k4);
        axpy4(acc[r + 3], s4.w, k4);
      }
    }
    __syncthreads();                     // the stage is read: refill it
  }
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int qpos = q0 + rg * RPT + r;
    if (qpos < T)
      *reinterpret_cast<float4*>(
          dq + ((static_cast<long long>(b) * T + qpos) * Hq + h) * D +
          4 * dg) = make_float4(acc[r].x * scale, acc[r].y * scale,
                                acc[r].z * scale, acc[r].w * scale);
  }
}

template <int D>
struct BwdAttr {};

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* o, const float* lse, const float* dO,
                   float* delta, float* dq, float* dk, float* dv, int B,
                   int T, int Hq, int Hkv, int causal, int window,
                   float scale, int device, cudaStream_t st) {
  constexpr size_t bytes = Tiles<D>::bytes;
  // the shared-memory limits and carveout (two blocks an SM), once per
  // device
  cudaError_t err = rt::once_per_device<BwdAttr<D>>(device, [] {
    constexpr int smem = static_cast<int>(Tiles<D>::bytes);
    for (const void* kernel :
         {reinterpret_cast<const void*>(flash_bwd_dkdv<D>),
          reinterpret_cast<const void*>(flash_bwd_dq<D>)}) {
      cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
            static_cast<int>(cudaSharedmemCarveoutMaxShared));
      if (e != cudaSuccess) return e;
    }
    return cudaSuccess;
  });
  if (err != cudaSuccess) return err;
  const long long rows = static_cast<long long>(B) * T * Hq;
  const long long n_t = (T + BKV - 1) / BKV;
  const long long kv_blocks = static_cast<long long>(B) * Hkv * n_t;
  const long long q_blocks = static_cast<long long>(B) * Hq * n_t;
  if ((rows + 7) / 8 > 0x7fffffffLL || q_blocks > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  flash_bwd_delta<D><<<static_cast<unsigned>((rows + 7) / 8), 256, 0, st>>>(
      o, dO, delta, rows, T, Hq);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv<D><<<static_cast<unsigned>(kv_blocks), kThreads, bytes,
                      st>>>(q, k, v, dO, lse, delta, dk, dv, T, Hq, Hkv,
                            causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq<D><<<static_cast<unsigned>(q_blocks), kThreads, bytes, st>>>(
      q, k, v, dO, lse, delta, dq, T, Hq, Hkv, causal, window, scale);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// q, o, do, dq (B, T, Hq, D); k, v, dk, dv (B, T, Hkv, D); lse and the
// scratch delta (B, Hq, T); all contiguous float32.
extern "C" int rt_flash_attention_bwd(const float* q, const float* k,
                                      const float* v, const float* o,
                                      const float* lse, const float* dO,
                                      float* delta, float* dq, float* dk,
                                      float* dv, int B, int T, int Hq,
                                      int Hkv, int D, int causal, int window,
                                      float scale, int device, void* stream) {
  if (B < 1 || T < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 || window < 0)
    return cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o) ||
      !aligned16(dO) || !aligned16(dq) || !aligned16(dk) || !aligned16(dv))
    return cudaErrorMisalignedAddress;
  cudaError_t err = rt::use_device(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch<64>(q, k, v, o, lse, dO, delta, dq, dk, dv, B, T, Hq, Hkv,
                      causal, window, scale, device, st);
  if (D == 128)
    return launch<128>(q, k, v, o, lse, dO, delta, dq, dk, dv, B, T, Hq,
                       Hkv, causal, window, scale, device, st);
  return cudaErrorInvalidValue;
}
