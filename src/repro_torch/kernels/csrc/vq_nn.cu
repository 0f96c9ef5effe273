// Nearest codebook atom per latent row (the VQ search of every training
// step).
//
// Replaces the TPU kernel repro/kernels/vq_nn.py::vq_nearest_pallas
// (_vq_nn_kernel): for each row z of (N, M), the index of the atom e of
// (K, M) with the least `||e||^2 - 2 z.e` (no ||z||^2, which is constant
// per row), ties to the lower index, as int32.
//
// Bound on the H100: FP32 operations. A training step's search (N = 2,048,
// K = 256, M = 64) is 2*N*K*M = 67 MFLOP, 1.0 us at the 67 TFLOP/s FP32
// peak, against 0.6 MB of inputs and outputs, 0.2 us of memory; a
// full-width client batch (N = 65,536) 2.1 GFLOP, 32 us. The scores must
// reproduce the reference's FP32 formula, so they run on the FP32 FMA
// pipes, not on tensor cores in TF32 (which would flip codes).
//
// Design: the (N, K) score matrix is tiled as an FP32 SGEMM is (the tiles,
// staging and combines live in vq_tile.cuh, shared with encode_codes.cu).
//  * A block of 256 threads is TY rows of TX threads. Thread (ty, tx)
//    computes a TM x TN micro-tile of scores in registers: rows ty + TY i,
//    atoms tx + TX j. Each 16-byte shared-memory load of an atom's 4 values
//    feeds 4*TM FMAs and each of a row's feeds 4*TN. With these strides a
//    warp's 16-byte loads are free of bank conflicts in rows padded to
//    MT + 4 floats (MT, a compile-time width >= M, zero-filled past M).
//  * Tiles land by cp.async, all of a tile's copies in flight at once: 16
//    bytes where rows start 16-byte aligned (M % 4 == 0), 4 bytes else.
//  * Where the codebook fits shared memory (M <= 64; at M = 64, K <= 512
//    in 128-row tiles and K <= 256 in 16-row tiles), it stays resident:
//    each block stages it and computes its ||e||^2 once,
//    then walks row tiles, the next z tile copied while this one is scored.
//    Many rows (a full-width client batch): 128-row tiles, 8 x 8 a thread,
//    one block an SM (254 registers). Few rows (a training step's 2,048):
//    16-row tiles, 4 x 4 a thread with 64 threads across 256 atoms, so
//    that 128 blocks fill the SMs and nothing is combined across blocks.
//  * Each thread scans its atoms in index order with a strict `<`; the
//    threads of a row combine by shuffles (and through shared memory where
//    they span two warps): the lower score, or at equal scores the lower
//    index -- the rule of the TPU kernel's carry. Duplicated atoms score
//    bit-identically (one FMA order for every (row, atom) pair), so the
//    rule decides their ties.
//  * Otherwise 64 x 64 tiles (4 x 4 a thread) stream the codebook through
//    two buffers, one block a row tile, the next atom tile copied while
//    this one is scored. No caller sends such inputs (every DVQ-AE config
//    has M <= 64 and K <= 256), so this path is kept simple and right, not
//    tuned: few rows leave SMs idle. No global scratch, atomics or second
//    pass.
//  * What bounds it in practice is shared-memory issue, not the FMA pipes:
//    the tilings tried ran faster the more FMAs each 16-byte load fed (4 x 4
//    < 8 x 4 < 8 x 8 a thread at 65,536 rows). Unrolling the contraction
//    loop in full spilled and ran several times slower. Sums run in another
//    order than the reference's, hence the near-tie rule of the tests.
#include <cuda_runtime.h>

#include "launch.cuh"
#include "vq_tile.cuh"

#include <cmath>

namespace {

using namespace vq;

constexpr size_t kMaxSmem = 227 * 1024;

// The whole codebook resident: each block stages it and its norms once,
// then walks row tiles (persistent where there are more row tiles than
// blocks), the next z tile copied while this one is scored. A row's TX
// threads combine by shuffles, and through shared memory where they span
// warps.
template <int MT, int TM, int TN, int TX>
__global__ void __launch_bounds__(kThreads, Tile<MT, TM, TN, TX>::bps)
    vq_resident_kernel(const float* __restrict__ z,
                       const float* __restrict__ codebook,
                       int* __restrict__ out, long long N, int K, int M,
                       long long row_tiles, bool vec) {
  using L = Tile<MT, TM, TN, TX>;
  constexpr int BN = L::BN, BK = L::BK, RS = L::RS, TY = kThreads / TX;
  constexpr int PARTS = TX > 32 ? TX / 32 : 1;   // warps a row spans
  extern __shared__ __align__(16) float smem[];
  __shared__ float part_best[PARTS][BN];
  __shared__ int part_code[PARTS][BN];
  const int k_pad = (K + BK - 1) / BK * BK;
  float* es = smem;                       // (k_pad, RS)
  float* e2s = es + k_pad * RS;           // (k_pad,)
  float* z2 = e2s + k_pad;                // 2 x (BN, RS)
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;

  stage<MT>(es, codebook, 0, k_pad, K, M, vec);
  stage<MT>(z2, z, static_cast<long long>(blockIdx.x) * BN, BN, N, M, vec);
  cp_async_commit();
  for (long long rt = blockIdx.x, n = 0; rt < row_tiles;
       rt += gridDim.x, ++n) {
    const long long row0 = rt * BN;
    const float* zs = z2 + (n & 1) * BN * RS;
    if (rt + gridDim.x < row_tiles) {
      stage<MT>(z2 + ((n + 1) & 1) * BN * RS, z, row0 + gridDim.x * BN, BN,
                N, M, vec);
      cp_async_commit();
      cp_async_wait<1>();                 // this tile (and the codebook)
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (rt == blockIdx.x) {
      atom_norms<MT, 1>(es, e2s, k_pad);
      __syncthreads();
    }
    float best[TM];
    int code[TM];
    init_best(best, code);
    for (int a0 = 0; a0 < K; a0 += BK)
      score_tile<MT, TM, TN, TX>(zs, es + a0 * RS, e2s + a0, a0, K, best,
                                 code);
    combine_lanes<TM, TX>(best, code);
    if (PARTS == 1) {
      if (tx == 0) {
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const long long row = row0 + ty + TY * i;
          if (row < N) out[row] = code[i];
        }
      }
    } else {
      if (tx % 32 == 0) {
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          part_best[tx / 32][ty + TY * i] = best[i];
          part_code[tx / 32][ty + TY * i] = code[i];
        }
      }
      __syncthreads();
      for (int r = threadIdx.x; r < BN && row0 + r < N; r += kThreads) {
        float b = part_best[0][r];
        int c = part_code[0][r];
#pragma unroll
        for (int p = 1; p < PARTS; ++p)
          take_lower(b, c, part_best[p][r], part_code[p][r]);
        out[row0 + r] = c;
      }
    }
    __syncthreads();                      // before this z tile is restaged
  }
}

// A codebook that does not fit shared memory, or atoms wider than 64: one
// row tile a block, the atom tiles streamed through two buffers.
template <int MT, int TM, int TN>
__global__ void __launch_bounds__(kThreads)
    vq_stream_kernel(const float* __restrict__ z,
                     const float* __restrict__ codebook,
                     int* __restrict__ out, long long N, int K, int M,
                     bool vec) {
  using L = Tile<MT, TM, TN>;
  constexpr int BN = L::BN, BK = L::BK, RS = L::RS;
  extern __shared__ __align__(16) float smem[];
  float* zs = smem;                       // (BN, RS)
  float* es = zs + BN * RS;               // 2 x (BK, RS)
  float* e2s = es + 2 * BK * RS;          // 2 x BK

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long long row0 = static_cast<long long>(blockIdx.x) * BN;
  const int n_tiles = (K + BK - 1) / BK;

  stage<MT>(zs, z, row0, BN, N, M, vec);
  stage<MT>(es, codebook, 0, BK, K, M, vec);
  cp_async_commit();

  float best[TM];
  int code[TM];
  init_best(best, code);
  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    const float* e = es + buf * BK * RS;
    float* e2 = e2s + buf * BK;
    if (t + 1 < n_tiles) {
      stage<MT>(es + (buf ^ 1) * BK * RS, codebook,
                static_cast<long long>(t + 1) * BK, BK, K, M, vec);
      cp_async_commit();
      cp_async_wait<1>();                 // tile t (and z) have landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    atom_norms<MT, kThreads / BK>(e, e2, BK);
    __syncthreads();
    score_tile<MT, TM, TN, 16>(zs, e, e2, t * BK, K, best, code);
    __syncthreads();                      // before buffer `buf` is restaged
  }
  combine_lanes<TM, 16>(best, code);
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const long long row = row0 + ty + 16 * i;
      if (row < N) out[row] = code[i];
    }
  }
}

template <int MT, int TM, int TN, int TX>
cudaError_t launch_resident(const float* z, const float* codebook, int* out,
                            long long N, int K, int M, int device, int sms,
                            size_t smem, cudaStream_t st) {
  using L = Tile<MT, TM, TN, TX>;
  constexpr auto kernel = vq_resident_kernel<MT, TM, TN, TX>;
  cudaError_t err = rt::allow_smem<kernel>(device, L::resident_budget);
  if (err != cudaSuccess) return err;
  const long long row_tiles = (N + L::BN - 1) / L::BN;
  const long long most = static_cast<long long>(L::bps) * sms;
  const long long blocks = row_tiles < most ? row_tiles : most;
  const bool vec = M % 4 == 0 && aligned16(z) && aligned16(codebook);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(
      z, codebook, out, N, K, M, row_tiles, vec);
  return cudaGetLastError();
}

template <int MT>
cudaError_t launch_stream(const float* z, const float* codebook, int* out,
                          long long N, int K, int M, int device,
                          cudaStream_t st) {
  using L = Tile<MT, 4, 4>;
  static_assert(L::stream_bytes <= kMaxSmem, "tile exceeds shared memory");
  constexpr auto kernel = vq_stream_kernel<MT, 4, 4>;
  cudaError_t err = rt::allow_smem<kernel>(device, L::stream_bytes);
  if (err != cudaSuccess) return err;
  const long long row_tiles = (N + L::BN - 1) / L::BN;
  if (row_tiles > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const bool vec = M % 4 == 0 && aligned16(z) && aligned16(codebook);
  kernel<<<static_cast<unsigned>(row_tiles), kThreads, L::stream_bytes, st>>>(
      z, codebook, out, N, K, M, vec);
  return cudaGetLastError();
}

// The codebook resident where it fits its blocks' shared memory (M <= 64):
// in 128-row tiles (8 x 8 a thread, atoms in sub-tiles of 128, one block
// an SM; K <= 512 at M = 64) where the rows fill the SMs twice over, else
// in 16-row tiles (4 x 4 a thread, 64 threads across 256 atoms, two blocks
// an SM; K <= 256 at M = 64), so that a training step's 2,048 rows are 128
// blocks that combine nothing across blocks. Streamed 64 x 64 tiles else.
template <int MT>
cudaError_t dispatch(const float* z, const float* codebook, int* out,
                     long long N, int K, int M, int device, int sms,
                     cudaStream_t st) {
  if constexpr (MT <= 64) {
    using W = Tile<MT, 8, 8, 16>;
    using F = Tile<MT, 4, 4, 64>;
    const size_t wide = W::resident_bytes((K + W::BK - 1LL) / W::BK * W::BK);
    const size_t few = F::resident_bytes((K + F::BK - 1LL) / F::BK * F::BK);
    if ((N + W::BN - 1) / W::BN >= 2LL * sms && wide <= W::resident_budget)
      return launch_resident<MT, 8, 8, 16>(z, codebook, out, N, K, M,
                                           device, sms, wide, st);
    if (few <= F::resident_budget)
      return launch_resident<MT, 4, 4, 64>(z, codebook, out, N, K, M,
                                           device, sms, few, st);
  }
  return launch_stream<MT>(z, codebook, out, N, K, M, device, st);
}

}  // namespace

// z (N, M) and codebook (K, M), contiguous float32 -> out (N,) int32.
extern "C" int rt_vq_nearest(const float* z, const float* codebook, int* out,
                             long long N, int K, int M, int device,
                             void* stream) {
  if (N < 1 || K < 1 || M < 1 || M > 256) return cudaErrorInvalidValue;
  cudaError_t err = rt::use_device(device);
  if (err != cudaSuccess) return err;
  const int sms = rt::sm_count(device);
  if (sms < 1) return cudaErrorInvalidDevice;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RT_VQ(W_)                                                         \
  if (M <= W_) return dispatch<W_>(z, codebook, out, N, K, M, device, sms, st);
  RT_VQ(16) RT_VQ(32) RT_VQ(64) RT_VQ(128) RT_VQ(256)
#undef RT_VQ
  return cudaErrorInvalidValue;
}
