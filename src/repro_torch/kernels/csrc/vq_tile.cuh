// The FP32 score-and-argmin tiles shared by the vq_nearest and encode_codes
// kernels (vq_nn.cu, encode_codes.cu).
//
// The (rows, atoms) score matrix ||e||^2 - 2 z.e is tiled as an FP32 SGEMM
// is: a block of kThreads threads is TY rows of TX threads, and thread
// (ty, tx) keeps a TM x TN micro-tile of scores in registers (rows ty + TY i,
// atoms tx + TX j). Rows and atoms sit in shared memory in rows of MT + 4
// floats (MT, a compile-time width >= M, zero-filled past M), landed by
// cp.async. Every (row, atom) score is taken in one FMA order, whatever the
// tiling, and ||e||^2 by one thread an atom in the resident kernels, so two
// kernels that share these tiles choose the same atom bit for bit: the
// lower score, or at equal scores the lower index.
#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace vq {

constexpr int kThreads = 256;            // TY rows x TX threads

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(Pending) : "memory");
}

// Rows [r0, r0 + rows) of a row-major (limit, M) matrix into shared rows of
// MT + 4 floats; columns past M and rows past `limit` are zero-filled (a
// copy of 0 bytes, from a valid address).
template <int MT>
__device__ __forceinline__ void stage(float* dst,
                                      const float* __restrict__ src,
                                      long long r0, int rows,
                                      long long limit, int M, bool vec) {
  constexpr int RS = MT + 4;
  if (vec) {
    constexpr int Q = MT / 4;
    for (int i = threadIdx.x; i < rows * Q; i += kThreads) {
      const int r = i / Q, q = i - r * Q;
      const bool ok = r0 + r < limit && 4 * q < M;
      cp_async16(dst + r * RS + 4 * q, ok ? src + (r0 + r) * M + 4 * q : src,
                 ok);
    }
  } else {
    for (int i = threadIdx.x; i < rows * MT; i += kThreads) {
      const int r = i / MT, k = i - r * MT;
      const bool ok = r0 + r < limit && k < M;
      cp_async4(dst + r * RS + k, ok ? src + (r0 + r) * M + k : src, ok);
    }
  }
}

// ||e||^2 of `rows` staged atoms into e2, 256 / TPA atoms at a time with
// TPA threads an atom.
template <int MT, int TPA>
__device__ __forceinline__ void atom_norms(const float* e, float* e2,
                                           int rows) {
  constexpr int RS = MT + 4;
  const int part = threadIdx.x % TPA;
  for (int a = threadIdx.x / TPA; a < rows; a += kThreads / TPA) {
    const float4* ea = reinterpret_cast<const float4*>(e + a * RS);
    float acc = 0.f;
    for (int q = part; q < MT / 4; q += TPA) {
      const float4 v = ea[q];
      acc = fmaf(v.x, v.x, acc);
      acc = fmaf(v.y, v.y, acc);
      acc = fmaf(v.z, v.z, acc);
      acc = fmaf(v.w, v.w, acc);
    }
#pragma unroll
    for (int o = TPA / 2; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (part == 0) e2[a] = acc;
  }
}

// This thread's TM x TN scores against one staged tile of BK = TX*TN atoms
// (`e`, norms `e2`, the first atom's index `atom0`), folded into the rows'
// bests in index order with a strict `<`. The block is TY = 256 / TX rows
// of TX threads: thread (ty, tx) scores rows ty + TY i and atoms tx + TX j.
template <int MT, int TM, int TN, int TX>
__device__ __forceinline__ void score_tile(const float* zs, const float* e,
                                           const float* e2, int atom0, int K,
                                           float (&best)[TM],
                                           int (&code)[TM]) {
  constexpr int RS = MT + 4, TY = kThreads / TX;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  // the TN atoms' 4 values stay in registers while the TM rows stream by
#pragma unroll 4
  for (int q = 0; q < MT / 4; ++q) {
    float4 ev[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j)
      ev[j] = reinterpret_cast<const float4*>(e + (tx + TX * j) * RS)[q];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float4 zr =
          reinterpret_cast<const float4*>(zs + (ty + TY * i) * RS)[q];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        acc[i][j] = fmaf(zr.x, ev[j].x, acc[i][j]);
        acc[i][j] = fmaf(zr.y, ev[j].y, acc[i][j]);
        acc[i][j] = fmaf(zr.z, ev[j].z, acc[i][j]);
        acc[i][j] = fmaf(zr.w, ev[j].w, acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int atom = atom0 + tx + TX * j;
    if (atom < K) {
      const float n2 = e2[tx + TX * j];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float s = n2 - 2.f * acc[i][j];
        if (s < best[i]) {
          best[i] = s;
          code[i] = atom;
        }
      }
    }
  }
}

// (b, c) takes (ob, oc) when it is lower, or equal with a lower index.
__device__ __forceinline__ void take_lower(float& b, int& c, float ob,
                                           int oc) {
  if (ob < b || (ob == b && oc < c)) {
    b = ob;
    c = oc;
  }
}

// The threads of a row that share a warp (consecutive lanes, at most 32)
// combine their bests.
template <int TM, int TX>
__device__ __forceinline__ void combine_lanes(float (&best)[TM],
                                             int (&code)[TM]) {
  constexpr int LANES = TX < 32 ? TX : 32;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int o = LANES / 2; o > 0; o >>= 1)
      take_lower(best[i], code[i],
                 __shfl_xor_sync(0xffffffffu, best[i], o),
                 __shfl_xor_sync(0xffffffffu, code[i], o));
  }
}

template <int TM>
__device__ __forceinline__ void init_best(float (&best)[TM],
                                          int (&code)[TM]) {
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    best[i] = INFINITY;
    code[i] = 0;
  }
}

template <int MT, int TM, int TN, int TX = 16>
struct Tile {
  static constexpr int BN = kThreads / TX * TM, BK = TX * TN, RS = MT + 4;
  // the streaming kernel: a z tile, two atom tiles, two tiles of norms
  static constexpr size_t stream_bytes =
      (static_cast<size_t>(BN) * RS + 2 * BK * RS + 2 * BK) * sizeof(float);
  // the resident kernel: two z tiles, the codebook of `k_pad` atoms, norms
  static constexpr size_t resident_bytes(long long k_pad) {
    return (2 * static_cast<size_t>(BN) * RS +
            static_cast<size_t>(k_pad) * (RS + 1)) * sizeof(float);
  }
  // resident blocks an SM: one for 8 x 8 micro-tiles (their registers),
  // two else; each may take its share of the SM's 228 KB of shared memory,
  // less 3 KB (the block's reserved 1 KB and its static arrays)
  static constexpr int bps = TM * TN >= 64 ? 1 : 2;
  static constexpr size_t resident_budget = (228 / bps - 3) * 1024;
};

// Rows are copied 16 bytes at a time where M % 4 == 0 and both inputs start
// 16-byte aligned.
inline bool aligned16(const float* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

}  // namespace vq
