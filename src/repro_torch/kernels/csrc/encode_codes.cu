// Fused latent -> packed-code + EMA-statistics encode (the client uplink).
//
// Replaces the TPU kernel repro/kernels/encode_codes.py::encode_codes_pallas
// (_encode_kernel): per record, a streaming argmin of every latent row
// against that record's own codebook, the codes packed straight into the
// b-bit word stream, and the per-atom counts and latent sums of Eq. 7-8.
//
// Bound on the H100: FP32 operations. At full width (65,536 rows, K = 256,
// M = 64) the scores take N*K*M = 1.07e9 FMAs, 2.1 GFLOP, against 17 MB of
// latents read: 32 us at the 67 TFLOP/s FP32 peak against 5 us of memory.
// The scores must reproduce the reference's FP32 formula, so they run on
// the FP32 FMA pipes, not on tensor cores in TF32.
//
// What differs from the TPU kernel: the TPU grid runs in order and carries
// the argmin across K steps in VMEM scratch and the statistics across N
// steps in the output block. GPU blocks run in parallel and in no order, so
// a block loops over its record's codebook itself, packs its own words, and
// writes its own partial statistics, which a second kernel adds in a fixed
// order. No float atomics, so words, counts and sums are the same from run
// to run. Pad rows (past the record's count) pack as 0 and cast no vote.
//
// Two paths, chosen by the wrapper from the shapes:
//
// VQ with the codebook resident (encode_resident_kernel; every DVQ-AE
// config's uplink: K atoms of width M <= 64, at most 32 or even, whose
// codebook, two z tiles and (K, M) sums fit one block an SM, K <= 256 at
// M = 64). The search is
// vq_nn.cu's, from vq_tile.cuh, so the TPU kernel's promise that its score
// is bit-identical to vq_nn holds here too:
//  * 128-row tiles, 8 x 8 scores a thread (16 threads a row), one block an
//    SM walking row tiles of one record; the block stages its record's
//    codebook and ||e||^2 once, and the next z tile lands by cp.async while
//    this one is scored. Every (row, atom) score has vq_nearest's FMA order,
//    norms and tie rule (strict `<` in index order, the lower index at equal
//    scores), so the codes equal vq_nearest's bit for bit.
//  * After a tile's lanes combine, its 128 codes go to shared memory and the
//    tile packs its own super-groups (every group_codes(bits) divides 32).
//  * The block's (K, M) sums and K integer counts stay in shared memory for
//    its whole walk. Each tile adds its votes from the z tile already in
//    shared memory: warp w adds, in row order, the rows whose atom k has
//    k % 8 == w, one or two columns a lane, four rows a shared-memory round
//    trip (add_votes); counts by integer atomics. One partial a block
//    (<= one an SM), and one reduce launch for sums and counts.
//  * Beyond the search, the votes cost the most: 8 warps an SM hide little
//    latency, and each vote is a shared-memory read-modify-write. Walking
//    every row with a predicate, or one row a round trip, cost several times
//    more; then come the packing, the partials and the reduce (PERF.md).
//
// GSVQ, or a codebook too large to keep (encode_kernel): one block owns
// `bn` consecutive rows of one record (a multiple of lcm(32, S): whole
// warps, whole positions, whole super-groups) and one thread a row:
//  * The row's latent sits in registers (padded with zeros to MT, a
//    compile-time width), the table is staged in shared memory in chunks of
//    CK rows per slice (rows padded to MT floats, so a row is read as
//    16-byte vectors that every thread of a warp shares). Threads are laid
//    out so that a warp holds rows of one slice. The dot product runs as
//    two interleaved FMA chains; ||e||^2 is one warp per staged row.
//  * Scores follow the reference's formula: VQ `e2 - 2*cross`, with no
//    ||z||^2; GSVQ `sqrt(max(z2 - 2*cross + e2, 0) + 1e-12)` summed over a
//    group's ng atoms and divided by ng, all in FP32. The sums run in
//    another order than the reference's, hence the near-tie rule. Ties
//    keep the lower index: strict `<` in index order.
//  * The block's (K, M) sums are accumulated in shared memory (over the
//    spent table chunk), each (atom, column) by one thread in row order;
//    counts by integer atomics. One partial a block; two reduce launches.
#include "bits.cuh"
#include "launch.cuh"
#include "vq_tile.cuh"

#include <cmath>

namespace {

constexpr int kTableBytes = 96 * 1024;   // shared memory for table chunks
constexpr int kMaxSmem = 227 * 1024;

template <int MT, bool GSVQ>
__global__ void encode_kernel(const float* __restrict__ z_in,
                              const float* __restrict__ table,
                              uint32_t* __restrict__ words,
                              float* __restrict__ pcounts,
                              float* __restrict__ psums, int P, int Pn, int m,
                              int M, int K, int S, int ng, int bits, int nW,
                              int bn, int NB, int CK) {
  extern __shared__ __align__(16) float smem[];
  // the table chunk (S*CK, MT), reused for the block's (K, M) sums
  float* es = smem;
  float* e2s = es + max(S * CK * MT, K * M);         // (S*CK,)
  int* code_s = reinterpret_cast<int*>(e2s + S * CK);  // (bn,)
  int* cnt_s = code_s + bn;                          // (K,)

  const int r = blockIdx.y, b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = blockDim.x >> 5;
  const int rps = bn / S;                  // rows of each slice in the block
  const int s = tid / rps;                 // this thread's slice
  const int t = (tid - s * rps) * S + s;   // this thread's row in the block
  const int row0 = b * bn;
  const int n_valid = min(bn, Pn - row0);  // valid rows are a prefix
  const bool valid = t < n_valid;

  float z[MT];
  {
    // z_in as (R, Pn, m): this thread's slice row
    const float* zrow = z_in + (static_cast<long long>(r) * Pn +
                              (valid ? row0 + t : 0)) * m;
#pragma unroll
    for (int k = 0; k < MT; ++k) z[k] = (valid && k < m) ? zrow[k] : 0.f;
  }
  float z2 = 0.f;
  if (GSVQ) {
#pragma unroll
    for (int k = 0; k < MT; ++k) z2 = fmaf(z[k], z[k], z2);
  }

  float best = INFINITY;
  int code = 0;
  const float* tab = table + static_cast<long long>(r) * S * K * m;
  for (int k0 = 0; k0 < K; k0 += CK) {
    const int ck = min(CK, K - k0);
    __syncthreads();
    for (int idx = tid; idx < S * CK * MT; idx += blockDim.x) {
      const int k = idx % MT, row = idx / MT, sp = row / CK, i = row % CK;
      es[idx] = (i < ck && k < m)
                    ? tab[(static_cast<long long>(sp) * K + k0 + i) * m + k]
                    : 0.f;
    }
    __syncthreads();
    // ||e||^2 per staged row: one warp per row, lanes across the row
    for (int row = warp; row < S * CK; row += n_warps) {
      float acc = 0.f;
      for (int k = lane; k < MT; k += 32)
        acc = fmaf(es[row * MT + k], es[row * MT + k], acc);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (lane == 0) e2s[row] = acc;
    }
    __syncthreads();
    const float* eb = es + s * CK * MT;
    const float* e2b = e2s + s * CK;
    // z.e in two interleaved FMA chains, so consecutive FMAs are independent
    auto cross_of = [&](int i) {
      const float4* e4 = reinterpret_cast<const float4*>(eb + i * MT);
      float c0 = 0.f, c1 = 0.f;
#pragma unroll
      for (int q = 0; q < MT / 4; q += 2) {
        const float4 e = e4[q];
        c0 = fmaf(z[4 * q], e.x, c0);
        c0 = fmaf(z[4 * q + 1], e.y, c0);
        c0 = fmaf(z[4 * q + 2], e.z, c0);
        c0 = fmaf(z[4 * q + 3], e.w, c0);
        if (q + 1 < MT / 4) {
          const float4 f = e4[q + 1];
          c1 = fmaf(z[4 * q + 4], f.x, c1);
          c1 = fmaf(z[4 * q + 5], f.y, c1);
          c1 = fmaf(z[4 * q + 6], f.z, c1);
          c1 = fmaf(z[4 * q + 7], f.w, c1);
        }
      }
      return c0 + c1;
    };
    if (!GSVQ) {
      for (int i = 0; i < ck; ++i) {
        const float score = e2b[i] - 2.f * cross_of(i);
        if (score < best) {
          best = score;
          code = k0 + i;
        }
      }
    } else {
      for (int g0 = 0; g0 < ck; g0 += ng) {
        float sum = 0.f;
        for (int i = g0; i < g0 + ng; ++i) {
          const float d2 = fmaxf(__fadd_rn(__fsub_rn(z2, 2.f * cross_of(i)),
                                           e2b[i]), 0.f);
          sum = __fadd_rn(sum, __fsqrt_rn(__fadd_rn(d2, 1e-12f)));
        }
        const float gd = __fdiv_rn(sum, static_cast<float>(ng));
        if (gd < best) {
          best = gd;
          code = (k0 + g0) / ng;
        }
      }
    }
  }

  // ---- pack: the block's codes -> its super-groups of words
  __syncthreads();                         // every thread is done with es
  code_s[t] = valid ? code : 0;            // pad packs as 0
  float* sums_s = es;
  for (int k = tid; k < K; k += blockDim.x) cnt_s[k] = 0;
  for (int e = tid; e < K * M; e += blockDim.x) sums_s[e] = 0.f;
  __syncthreads();
  const int G = group_codes(bits), W = group_words(bits);
  const int gpb = bn / G;
  for (int gi = tid; gi < gpb; gi += blockDim.x) {
    const long long gg = static_cast<long long>(b) * gpb + gi;
    if (gg < nW)
      pack_group(code_s + gi * G, bits, G, W,
                 words + (static_cast<long long>(r) * nW + gg) * W);
  }

  // ---- EMA statistics. Counts: integer atomics, exact in any order.
  // Sums: thread (column c, group g) owns atoms k with k % n_grp == g and
  // adds their votes in row order, so each sum is taken in one fixed order.
  if (valid) atomicAdd(&cnt_s[code * ng + ng / 2], 1);
  const int n_grp = M <= static_cast<int>(blockDim.x) ? blockDim.x / M : 1;
  const int grp = M <= static_cast<int>(blockDim.x) ? tid / M : 0;
  if (grp < n_grp) {
    const int c_step = M <= static_cast<int>(blockDim.x) ? M : blockDim.x;
    const int pos0 = row0 / S;
    for (int c = M <= static_cast<int>(blockDim.x) ? tid % M : tid; c < M;
         c += c_step) {
      // every slice votes its position's FULL latent: z_in as (R, P, M)
      const float* zcol =
          z_in + (static_cast<long long>(r) * P + pos0) * M + c;
#pragma unroll 4
      for (int u = 0; u < n_valid; ++u) {
        const int rep = code_s[u] * ng + ng / 2;
        const float v = zcol[static_cast<long long>(S == 1 ? u : u / S) * M];
        if (rep % n_grp == grp) sums_s[rep * M + c] += v;
      }
    }
  }
  __syncthreads();
  const long long part = static_cast<long long>(r) * NB + b;
  float* ps = psums + part * K * M;
  for (int e = tid; e < K * M; e += blockDim.x) ps[e] = sums_s[e];
  for (int k = tid; k < K; k += blockDim.x)
    pcounts[part * K + k] = static_cast<float>(cnt_s[k]);
}

constexpr int kSegments = 8;

// out[r, i] = sum over blocks of part[r, b, i] in a fixed order, for the 32
// outputs of reduce block `blk`: segment s adds blocks b = s, s + 8, ... in
// block order, then the eight segment sums are added in segment order. One
// warp per segment, one lane per output; integer partials add exactly.
template <typename T>
__device__ __forceinline__ void reduce_block(const T* __restrict__ part,
                                             float* __restrict__ out, int R,
                                             int NB, long long n,
                                             long long blk) {
  __shared__ T seg_s[kSegments][32];
  const int lane = threadIdx.x & 31, seg = threadIdx.x >> 5;
  const long long idx = blk * 32 + lane;
  const bool ok = idx < R * n;
  T acc = 0;
  if (ok) {
    const long long r = idx / n;
    const T* src = part + r * NB * n + (idx - r * n);
    for (int bb = seg; bb < NB; bb += kSegments)
      acc += src[static_cast<long long>(bb) * n];
  }
  seg_s[seg][lane] = acc;
  __syncthreads();
  if (seg == 0 && ok) {
    T total = 0;
    for (int q = 0; q < kSegments; ++q) total += seg_s[q][lane];
    out[idx] = static_cast<float>(total);
  }
}

__global__ void reduce_partials(const float* __restrict__ part,
                                float* __restrict__ out, int R, int NB,
                                long long n) {
  reduce_block(part, out, R, NB, n, blockIdx.x);
}

// The resident path's one reduce launch: blocks below `sum_blocks` add the
// (R, NB, K, M) float sums, the rest the (R, NB, K) integer counts.
__global__ void reduce_stats(const float* __restrict__ psums,
                             const int* __restrict__ pcounts,
                             float* __restrict__ sums,
                             float* __restrict__ counts, int R, int NB,
                             int K, int M, unsigned sum_blocks) {
  if (blockIdx.x < sum_blocks)
    reduce_block(psums, sums, R, NB, static_cast<long long>(K) * M,
                 blockIdx.x);
  else
    reduce_block(pcounts, counts, R, NB, K, blockIdx.x - sum_blocks);
}

// ---- VQ, the codebook resident: vq_nn.cu's 128-row tiles, 8 x 8 a thread
template <int MT>
using Res = vq::Tile<MT, 8, 8, 16>;

// Shared memory of the resident kernel at K atoms of width M: the codebook
// padded to whole atom sub-tiles with its norms, two z tiles, a tile's
// codes, the (K, M) sums and K counts.
template <int MT>
constexpr size_t resident_smem(int K, int M) {
  using L = Res<MT>;
  return L::resident_bytes((K + L::BK - 1LL) / L::BK * L::BK) +
         (L::BN + static_cast<size_t>(K) * M + K) * sizeof(float);
}

// A lane's CPL consecutive columns of a row (CPL = 1 or 2).
template <int CPL>
struct Cols;
template <>
struct Cols<1> {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.f; }
  static __device__ __forceinline__ T add(T a, T b) { return a + b; }
};
template <>
struct Cols<2> {
  using T = float2;
  static __device__ __forceinline__ T zero() {
    return make_float2(0.f, 0.f);
  }
  static __device__ __forceinline__ T add(T a, T b) {
    return make_float2(a.x + b.x, a.y + b.y);
  }
};

// A tile's votes into the block's sums. Warp w owns the atoms k with
// k % 8 == w, and lane l columns [l*CPL, l*CPL + CPL) of them (CPL = 2 past
// 32 columns, with M even, so a lane moves 8 aligned bytes); each lane adds,
// in row order, its columns of every row whose atom its warp owns. The warp
// finds those rows 32 at a time by one ballot and takes them B at a time:
// their B sums are loaded together, a row whose atom an earlier row of the
// B shares adds to that row's running value, and the B are stored in row
// order. So each (atom, column) sum is the same chain of additions as row
// by row, at one shared-memory round trip for B rows (B = 8 measured
// slower than 4 on the H100).
template <int RS, int CPL>
__device__ __forceinline__ void add_votes(const int* code_s, const float* zs,
                                          float* sums_s, int n_valid,
                                          int M) {
  constexpr int B = 4;
  using C = Cols<CPL>;
  using T = typename C::T;
  constexpr int n_grp = vq::kThreads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = lane * CPL;
  const bool act = c0 < M;
  for (int u0 = 0; u0 < n_valid; u0 += 32) {
    const bool valid = u0 + lane < n_valid;
    const int c_lane = valid ? code_s[u0 + lane] : 0;
    unsigned rows =
        __ballot_sync(0xffffffffu, valid && c_lane % n_grp == warp);
    while (rows) {                      // the same rows in every lane
      int k[B];
      T v[B], t[B];
      bool on[B];
#pragma unroll
      for (int i = 0; i < B; ++i) {
        on[i] = rows != 0;
        const int j = on[i] ? __ffs(rows) - 1 : 0;
        rows &= rows - 1;
        k[i] = on[i] ? __shfl_sync(0xffffffffu, c_lane, j) : -1 - i;
        v[i] = on[i] && act
                   ? *reinterpret_cast<const T*>(zs + (u0 + j) * RS + c0)
                   : C::zero();
      }
#pragma unroll
      for (int i = 0; i < B; ++i)
        t[i] = on[i] && act
                   ? *reinterpret_cast<const T*>(sums_s + k[i] * M + c0)
                   : C::zero();
#pragma unroll
      for (int i = 0; i < B; ++i) {
        T run = t[i];
#pragma unroll
        for (int p = 0; p < i; ++p)
          if (k[p] == k[i]) run = t[p];   // the latest earlier row's value
        t[i] = C::add(run, v[i]);
      }
#pragma unroll
      for (int i = 0; i < B; ++i)
        if (on[i] && act)
          *reinterpret_cast<T*>(sums_s + k[i] * M + c0) = t[i];
    }
  }
}

// n floats from src to dst, 16 bytes at a time where both are 16-byte
// aligned and n % 4 == 0 (src null: zeros).
__device__ __forceinline__ void copy_floats(float* dst, const float* src,
                                            int n) {
  const bool vec = n % 4 == 0 &&
                   ((reinterpret_cast<unsigned long long>(dst) |
                     reinterpret_cast<unsigned long long>(src)) & 15) == 0;
  if (vec) {
    float4* d4 = reinterpret_cast<float4*>(dst);
    const float4* s4 = reinterpret_cast<const float4*>(src);
    for (int e = threadIdx.x; e < n / 4; e += blockDim.x)
      d4[e] = src ? s4[e] : make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    for (int e = threadIdx.x; e < n; e += blockDim.x)
      dst[e] = src ? src[e] : 0.f;
  }
}

template <int MT>
__global__ void __launch_bounds__(vq::kThreads, 1)
    encode_resident_kernel(const float* __restrict__ z,
                           const float* __restrict__ codebooks,
                           uint32_t* __restrict__ words,
                           int* __restrict__ pcounts,
                           float* __restrict__ psums, int P, int K, int M,
                           int bits, int nW, int row_tiles, bool vec) {
  using L = Res<MT>;
  constexpr int BN = L::BN, BK = L::BK, RS = L::RS;
  constexpr int TY = vq::kThreads / 16;
  extern __shared__ __align__(16) float smem[];
  const int k_pad = (K + BK - 1) / BK * BK;
  float* es = smem;                           // (k_pad, RS)
  float* e2s = es + k_pad * RS;               // (k_pad,)
  float* z2 = e2s + k_pad;                    // 2 x (BN, RS)
  int* code_s = reinterpret_cast<int*>(z2 + 2 * BN * RS);  // (BN,) codes
  float* sums_s = reinterpret_cast<float*>(code_s + BN);   // (K, M)
  int* cnt_s = reinterpret_cast<int*>(sums_s + K * M);     // (K,)

  const int r = blockIdx.y, tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const float* zr = z + static_cast<long long>(r) * P * M;
  const int G = group_codes(bits), W = group_words(bits), gpt = BN / G;

  copy_floats(sums_s, nullptr, K * M);
  for (int k = tid; k < K; k += vq::kThreads) cnt_s[k] = 0;
  vq::stage<MT>(es, codebooks + static_cast<long long>(r) * K * M, 0, k_pad,
                K, M, vec);
  vq::stage<MT>(z2, zr, static_cast<long long>(blockIdx.x) * BN, BN, P, M,
                vec);
  vq::cp_async_commit();
  for (int rt = blockIdx.x, n = 0; rt < row_tiles; rt += gridDim.x, ++n) {
    const long long row0 = static_cast<long long>(rt) * BN;
    const float* zs = z2 + (n & 1) * BN * RS;
    if (rt + static_cast<int>(gridDim.x) < row_tiles) {
      vq::stage<MT>(z2 + ((n + 1) & 1) * BN * RS, zr,
                    row0 + static_cast<long long>(gridDim.x) * BN, BN, P, M,
                    vec);
      vq::cp_async_commit();
      vq::cp_async_wait<1>();                 // this tile (and the codebook)
    } else {
      vq::cp_async_wait<0>();
    }
    __syncthreads();
    if (n == 0) {
      vq::atom_norms<MT, 1>(es, e2s, k_pad);
      __syncthreads();
    }
    float best[8];
    int code[8];
    vq::init_best(best, code);
    for (int a0 = 0; a0 < K; a0 += BK)
      vq::score_tile<MT, 8, 8, 16>(zs, es + a0 * RS, e2s + a0, a0, K, best,
                                   code);
    vq::combine_lanes<8, 16>(best, code);
    const int n_valid = static_cast<int>(min(static_cast<long long>(BN),
                                             P - row0));
    if (tx == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int u = ty + TY * i;
        code_s[u] = u < n_valid ? code[i] : 0;   // pad packs as 0
      }
    }
    __syncthreads();
    // pack: the tile's whole super-groups
    for (int gi = tid; gi < gpt; gi += vq::kThreads) {
      const long long g = static_cast<long long>(rt) * gpt + gi;
      if (g < nW)
        pack_group(code_s + gi * G, bits, G, W,
                   words + (static_cast<long long>(r) * nW + g) * W);
    }
    // statistics from the z tile in shared memory, each sum in row order
    if (tid < n_valid) atomicAdd(&cnt_s[code_s[tid]], 1);
    add_votes<RS, (MT > 32 ? 2 : 1)>(code_s, zs, sums_s, n_valid, M);
    __syncthreads();            // before this z tile and the codes are reused
  }
  const long long part = static_cast<long long>(r) * gridDim.x + blockIdx.x;
  copy_floats(psums + part * K * M, sums_s, K * M);
  for (int k = tid; k < K; k += vq::kThreads) pcounts[part * K + k] = cnt_s[k];
}

template <int MT>
cudaError_t launch_resident(const float* z, const float* codebooks,
                            uint32_t* words, int* pcounts, float* psums,
                            int R, int P, int K, int M, int bits, int nW,
                            int nb, int device, cudaStream_t st) {
  constexpr auto kernel = encode_resident_kernel<MT>;
  const size_t smem = resident_smem<MT>(K, M);
  if (smem > Res<MT>::resident_budget) return cudaErrorInvalidConfiguration;
  cudaError_t err =
      rt::allow_smem<kernel>(device, Res<MT>::resident_budget);
  if (err != cudaSuccess) return err;
  const int row_tiles = (P + Res<MT>::BN - 1) / Res<MT>::BN;
  const bool vec = M % 4 == 0 && vq::aligned16(z) && vq::aligned16(codebooks);
  kernel<<<dim3(nb, R), vq::kThreads, smem, st>>>(
      z, codebooks, words, pcounts, psums, P, K, M, bits, nW, row_tiles, vec);
  return cudaGetLastError();
}

template <int MT, bool GSVQ>
cudaError_t launch_encode(dim3 grid, int threads, size_t smem,
                          cudaStream_t st, const float* z, const float* table,
                          uint32_t* words, float* pcounts,
                          float* psums, int P, int Pn, int m, int M, int K,
                          int S, int ng, int bits, int nW, int bn, int NB,
                          int CK) {
  auto kernel = encode_kernel<MT, GSVQ>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, st>>>(z, table, words, pcounts, psums,
                                      P, Pn, m, M, K, S, ng, bits, nW, bn,
                                      NB, CK);
  return cudaGetLastError();
}

template <bool GSVQ>
cudaError_t dispatch_width(int MT, dim3 grid, int threads, size_t smem,
                           cudaStream_t st, const float* z,
                           const float* table, uint32_t* words,
                           float* pcounts, float* psums, int P, int Pn, int m,
                           int M, int K, int S, int ng, int bits, int nW,
                           int bn, int NB, int CK) {
#define RT_ENC(W_)                                                          \
  case W_:                                                                  \
    return launch_encode<W_, GSVQ>(grid, threads, smem, st, z, table, words, \
                                   pcounts, psums, P, Pn, m, M, K, S, ng,    \
                                   bits, nW, bn, NB, CK);
  switch (MT) {
    RT_ENC(4) RT_ENC(8) RT_ENC(16) RT_ENC(32) RT_ENC(64) RT_ENC(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef RT_ENC
}

}  // namespace

// z: contiguous latents, read both as (R, P, M) and as its slice view
// (R, Pn, m) with Pn = P*S, m = M/S; table (R, S*K, m) slice-stacked
// codebooks -> words (R*nW, W), counts (R, K), sums (R, K, M). pcounts
// (R, NB, K) and psums (R, NB, K, M) are scratch.
extern "C" int rt_encode_codes(const float* z, const float* table, int* words,
                               float* counts,
                               float* sums, float* pcounts, float* psums,
                               int R, int P, int Pn, int m, int M, int K,
                               int S, int ng, int gsvq, int bits, int bn,
                               int NB, int device, void* stream) {
  if (m < 1 || m > 128 || bits < 1 || bits > 32 || S < 1 || ng < 1 ||
      K % ng != 0 || bn % S != 0 || bn % group_codes(bits) != 0 ||
      bn % 32 != 0 || bn > 1024 || R < 1 || NB < 1)
    return cudaErrorInvalidValue;
  cudaError_t err = rt::use_device(device);
  if (err != cudaSuccess) return err;
  int MT = 4;
  while (MT < m) MT *= 2;
  // rows per slice per chunk: whole groups, as many as the budget allows
  int CK = kTableBytes / (S * (MT + 1) * 4);
  CK = CK < K ? CK : K;
  CK -= CK % ng;
  if (CK < ng) return cudaErrorInvalidConfiguration;
  const size_t table_floats = static_cast<size_t>(S) * CK * MT;
  const size_t sums_floats = static_cast<size_t>(K) * M;
  const size_t smem =
      ((table_floats > sums_floats ? table_floats : sums_floats) +
       static_cast<size_t>(S) * CK + bn + K) * 4;
  if (smem > kMaxSmem) return cudaErrorInvalidConfiguration;
  const int nW = static_cast<int>(
      (static_cast<long long>(Pn) + group_codes(bits) - 1) / group_codes(bits));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint32_t* w = reinterpret_cast<uint32_t*>(words);
  const dim3 grid(NB, R);
  err = gsvq ? dispatch_width<true>(MT, grid, bn, smem, st, z, table, w,
                                    pcounts, psums, P, Pn, m, M, K, S, ng,
                                    bits, nW, bn, NB, CK)
             : dispatch_width<false>(MT, grid, bn, smem, st, z, table, w,
                                     pcounts, psums, P, Pn, m, M, K, S, ng,
                                     bits, nW, bn, NB, CK);
  if (err != cudaSuccess) return err;
  const long long n_sums = static_cast<long long>(K) * M;
  reduce_partials<<<static_cast<unsigned>((R * n_sums + 31) / 32),
                    32 * kSegments, 0, st>>>(psums, sums, R, NB, n_sums);
  reduce_partials<<<static_cast<unsigned>((static_cast<long long>(R) * K +
                                           31) / 32),
                    32 * kSegments, 0, st>>>(pcounts, counts, R, NB, K);
  return cudaGetLastError();
}

// The VQ path with the codebook resident. z (R, P, M) and codebooks
// (R, K, M), contiguous float32, M <= 64 -> words (R*nW, W), counts (R, K),
// sums (R, K, M). `nb` blocks a record, each walking its record's row
// tiles; pcounts (R, nb, K) int32 and psums (R, nb, K, M) are scratch.
extern "C" int rt_encode_codes_resident(const float* z,
                                        const float* codebooks, int* words,
                                        float* counts, float* sums,
                                        int* pcounts, float* psums, int R,
                                        int P, int K, int M, int bits,
                                        int nb, int device, void* stream) {
  if (R < 1 || R > 65535 || P < 1 || K < 1 || M < 1 || M > 64 ||
      (M > 32 && M % 2) ||
      bits < 1 || bits > 32 || nb < 1 ||
      nb > (P + Res<64>::BN - 1) / Res<64>::BN)
    return cudaErrorInvalidValue;
  cudaError_t err = rt::use_device(device);
  if (err != cudaSuccess) return err;
  const int nW = static_cast<int>(
      (static_cast<long long>(P) + group_codes(bits) - 1) / group_codes(bits));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint32_t* w = reinterpret_cast<uint32_t*>(words);
  err = M <= 16   ? launch_resident<16>(z, codebooks, w, pcounts, psums, R, P,
                                        K, M, bits, nW, nb, device, st)
        : M <= 32 ? launch_resident<32>(z, codebooks, w, pcounts, psums, R, P,
                                        K, M, bits, nW, nb, device, st)
                  : launch_resident<64>(z, codebooks, w, pcounts, psums, R, P,
                                        K, M, bits, nW, nb, device, st);
  if (err != cudaSuccess) return err;
  const long long n_sums = static_cast<long long>(R) * K * M;
  const unsigned sum_blocks = static_cast<unsigned>((n_sums + 31) / 32);
  const unsigned cnt_blocks =
      static_cast<unsigned>((static_cast<long long>(R) * K + 31) / 32);
  reduce_stats<<<sum_blocks + cnt_blocks, 32 * kSegments, 0, st>>>(
      psums, pcounts, sums, counts, R, nb, K, M, sum_blocks);
  return cudaGetLastError();
}
