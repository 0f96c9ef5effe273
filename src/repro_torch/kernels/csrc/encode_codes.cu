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
// Three paths, chosen by the wrapper from the shapes:
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
// GSVQ with every slice table resident (gsvq_tiled_kernel; the speech
// config's 3-bit uplink, g8s2: slice widths m <= 64, m % 4 == 0, whose S
// tables, two latent tiles, a pass's distances and the vote warps'
// (n_groups, M) sums fit one block an SM, 175 KB at g8s2). Bound: the FP32
// pipes' instruction rate. Each (slice row, atom) score takes m FMAs and a
// tail (subtract, add, max, add, the correctly rounded square root, the
// group add) of ten more FP32 instructions (and __fsqrt_rn's range test,
// an integer add, a compare and a branch), so at m = 32 the tail is a
// quarter of the work:
//  * One block of 16 warps an SM, spread over the records, each walking its
//    record's tiles of 32 positions (64 at S = 1), so the speech transmit's
//    7,680 positions make 240 tiles for 132 SMs; the block stages its
//    record's S slice tables straight from the (K, M) codebook and their
//    norms once, and the next latent tile lands by cp.async while this one
//    is scored.
//  * A pass scores two units of 32 slice rows, each of one slice, against
//    their slice's atoms: a warp takes a unit and a window of 32 atoms, 8 x
//    4 scores a thread in FP32 FMA, a 16-byte read of shared memory shared
//    by 8 lanes (a row) or 4 (an atom), and takes its rows' ||z_s||^2
//    itself. The square root is __fsqrt_rn, correctly rounded.
//  * Distances go to shared memory, group by group; then one lane adds a
//    group's ng distances in atom order, the same chain for every group
//    wherever it sits and for any ng that divides K, so equal groups score
//    equal bit for bit. The mean is the sum divided by ng; the lowest mean
//    wins, the lower group at equal means. (Summing groups of a power of
//    two in registers, by lane butterflies, measured no faster.)
//  * Only the n_groups representative atoms (g*ng + ng/2) receive votes,
//    so a block keeps (n_groups, M) sums and n_groups counts, not (K, M).
//    The tile's rows are cut into 8 runs, one a vote warp, each warp adding
//    its run in row order into its own copy of the sums, so codes that
//    crowd into one group cost no more; the other 8 warps pack the words
//    and count the codes meanwhile. One reduce launch adds the blocks'
//    partials (the copies added in warp order) and writes the (R, K, M)
//    and (R, K) outputs, zeros off the representatives.
//
// GSVQ that does not fit, or a VQ codebook too large to keep
// (encode_kernel): one block owns
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

// ---- GSVQ, the slice tables resident: a tiled group search
//
// A tile's slice rows come in units of 32 rows of one slice (32 positions).
// A pass takes two units, 64 rows; a warp scores one unit against a window
// of 32 atoms of its slice, lane (ty, tx) = (lane / 8, lane % 8) the rows
// ty + 4 i (i < 8) and the atoms tx + 8 j (j < 4), so each thread keeps 8 x
// 4 cross products in registers (FP32 FMA, k in order) and each 16-byte
// read of shared memory serves 8 lanes (a row) or 4 (an atom): a warp's
// reads of 4 rows or 8 atoms are one wavefront each. 16 warps an SM, at
// most 128 registers a thread.
namespace gs {
constexpr int kThreads = 512;
constexpr int kTM = 8, kTN = 4;                   // rows, atoms a thread
constexpr int kLY = 4, kLX = 8;                   // lanes along rows, atoms
constexpr int kUnitRows = kLY * kTM;              // 32 rows of one slice
constexpr int kWindow = kLX * kTN;                // 32 atoms a warp's task
constexpr int kPassRows = 2 * kUnitRows;          // 64 slice rows a pass
constexpr int kVoteWarps = 8;                     // warps that add votes
constexpr size_t kBudget = (228 - 3) * 1024;      // one block an SM

__host__ __device__ constexpr size_t align4(size_t n) {
  return (n + 3) / 4 * 4;
}

// The tiled kernel's shapes and shared-memory regions (offsets in floats).
struct Layout {
  int S, K, M, m, ng, n_groups;
  int BP;   // positions a tile: 32, or 64 at S = 1 (two units a tile)
  int RS;   // a slice table row's floats: RS / 4 odd, so 8 lanes reading
            // neighbouring rows' 16 bytes hit 8 distinct bank quads
  int RSZ;  // a latent tile row's floats (M rounded up so RSZ / 4 is odd)
  int GS;   // a group's floats in a score row: ng rounded up to odd, so
            // the group sums of neighbouring lanes use distinct banks
  int KS;   // a score row's floats, n_groups * GS
  int TG;   // lanes that search one row's groups: pow2 >= n_groups, <= 32
  unsigned zdiv;  // ceil(2^32 / S): u / S = umulhi(u, zdiv) for S > 1
  size_t es, e2s, zt, sc, code, sums, cnt, col, total;
};

inline Layout layout(int K, int M, int S, int n_groups) {
  Layout L{};
  L.S = S;
  L.K = K;
  L.M = M;
  L.m = M / S;
  L.n_groups = n_groups;
  L.ng = K / n_groups;
  L.BP = S == 1 ? 2 * kUnitRows : kUnitRows;
  L.RS = 4 * ((L.m / 4) | 1);
  L.RSZ = 4 * ((M / 4) | 1);
  L.GS = L.ng | 1;
  L.KS = n_groups * L.GS;
  L.TG = 1;
  while (L.TG < n_groups && L.TG < 32) L.TG *= 2;
  L.zdiv = S > 1 ? static_cast<unsigned>(((1ULL << 32) + S - 1) / S) : 0u;
  size_t o = 0;
  L.es = o;   o += align4(static_cast<size_t>(S) * K * L.RS);
  L.e2s = o;  o += align4(static_cast<size_t>(S) * K);
  L.zt = o;   o += align4(2 * static_cast<size_t>(L.BP) * L.RSZ);
  L.sc = o;   o += align4(static_cast<size_t>(kPassRows) * L.KS);
  L.code = o; o += align4(static_cast<size_t>(L.BP) * S);
  L.sums = o; o += align4(static_cast<size_t>(kVoteWarps) * n_groups * M);
  L.cnt = o;  o += align4(static_cast<size_t>(n_groups));
  L.col = o;  o += align4(static_cast<size_t>(K));
  L.total = o;
  return L;
}

// Every slice table of one record: row s*K + a holds codebook row a's
// columns [s*m, s*m + m); the RS - m floats past them are never read.
__device__ __forceinline__ void stage_tables(float* es,
                                             const float* __restrict__ cb,
                                             const Layout& L, bool vec) {
  const int w = vec ? 4 : 1, Q = L.m / w, n = L.S * L.K * Q;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int row = i / Q, q = i - row * Q;
    const int s = row / L.K, a = row - s * L.K;
    float* dst = es + static_cast<long long>(row) * L.RS + w * q;
    const float* src = cb + static_cast<long long>(a) * L.M + s * L.m + w * q;
    if (vec)
      vq::cp_async16(dst, src, true);
    else
      vq::cp_async4(dst, src, true);
  }
}

// Positions [p0, p0 + BP) of a record's (P, M) latents into rows of RSZ
// floats; positions past P are zero-filled.
__device__ __forceinline__ void stage_positions(float* dst,
                                                const float* __restrict__ z,
                                                long long p0,
                                                const Layout& L, long long P,
                                                bool vec) {
  const int w = vec ? 4 : 1, Q = L.M / w, n = L.BP * Q;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int r = i / Q, q = i - r * Q;
    const bool ok = p0 + r < P;
    const float* src = ok ? z + (p0 + r) * L.M + w * q : z;
    if (vec)
      vq::cp_async16(dst + r * L.RSZ + w * q, src, ok);
    else
      vq::cp_async4(dst + r * L.RSZ + w * q, src, ok);
  }
}

// One pass: slice rows [u0, u0 + 64) of the tile (slice-major: u = s*BP +
// p; two units of 32 rows, the second absent past the tile) against every
// atom of their slice, d = sqrt(max(z2 - 2 z.e + e2, 0) + 1e-12) in FP32.
// Warp w takes the (unit, window) tasks w, w + 16, ... Each task first
// takes its rows' ||z_s||^2: lane tx sums the 4-column chunks tx, tx + 8,
// ... in order, then a fixed butterfly over the row's 8 lanes. Each distance
// goes to its row's column col_s[a] of `sc`, for group_pass to add.
__device__ __forceinline__ void score_pass(const float* zs, const float* es,
                                           const float* e2s,
                                           const int* col_s, float* sc,
                                           const Layout& L, int u0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ty = lane / kLX, tx = lane % kLX;
  const int K = L.K, RSZ = L.RSZ, KS = L.KS, m4 = L.m / 4;
  const int windows = (K + kWindow - 1) / kWindow;
  const int units = min(2, (L.BP * L.S - u0) / kUnitRows);
  for (int task = warp; task < units * windows; task += kThreads / 32) {
    const int un = task / windows, a0 = (task - un * windows) * kWindow;
    const int ub = u0 + un * kUnitRows;    // the unit's first row: one slice
    const int s = ub / L.BP, pb = ub - s * L.BP;
    const float* zp = zs + (pb + ty) * RSZ + s * L.m;   // row i: + 4 i RSZ
    const float* et = es + static_cast<long long>(s) * K * L.RS;
    float z2[kTM];
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const float4* zq = reinterpret_cast<const float4*>(zp + kLY * i * RSZ);
      float acc = 0.f;
      for (int q = tx; q < m4; q += kLX) {
        const float4 v = zq[q];
        acc = fmaf(v.x, v.x, acc);
        acc = fmaf(v.y, v.y, acc);
        acc = fmaf(v.z, v.z, acc);
        acc = fmaf(v.w, v.w, acc);
      }
#pragma unroll
      for (int o = 1; o < kLX; o <<= 1)
        acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, o));
      z2[i] = acc;
    }
    int eo[kTN];                            // atoms past K read atom K - 1
#pragma unroll
    for (int j = 0; j < kTN; ++j)
      eo[j] = min(a0 + tx + kLX * j, K - 1) * L.RS;
    float acc[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
#pragma unroll 1
    for (int q = 0; q < m4; ++q) {
      float4 ev[kTN];
#pragma unroll
      for (int j = 0; j < kTN; ++j)
        ev[j] = reinterpret_cast<const float4*>(et + eo[j])[q];
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const float4 zv =
            reinterpret_cast<const float4*>(zp + kLY * i * RSZ)[q];
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          acc[i][j] = fmaf(zv.x, ev[j].x, acc[i][j]);
          acc[i][j] = fmaf(zv.y, ev[j].y, acc[i][j]);
          acc[i][j] = fmaf(zv.z, ev[j].z, acc[i][j]);
          acc[i][j] = fmaf(zv.w, ev[j].w, acc[i][j]);
        }
      }
    }
    float* srow = sc + (un * kUnitRows + ty) * KS;   // row i: + 4 i KS
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int a = a0 + tx + kLX * j;
      const float e2 = e2s[s * K + min(a, K - 1)];
      float d[kTM];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
        // z2 - 2*cross in one rounding (2*cross is exact), then + e2; fmaxf
        // drops a NaN, so x >= 1e-12
        d[i] = __fadd_rn(
            fmaxf(__fadd_rn(fmaf(-2.f, acc[i][j], z2[i]), e2), 0.f), 1e-12f);
#pragma unroll
      for (int i = 0; i < kTM; ++i) d[i] = __fsqrt_rn(d[i]);
      if (a < K) {
        float* dst = srow + col_s[a];
#pragma unroll
        for (int i = 0; i < kTM; ++i) dst[kLY * i * KS] = d[i];
      }
    }
  }
}

// The pass's rows' codes: TG lanes a row, lane l taking the groups g = l,
// l + TG, ...: a group's ng distances added one by one in atom order (the
// same chain for every group, so equal groups score equal bit for bit) and
// divided by ng; kept by strict `<` in increasing g, then the lanes keep
// the lowest mean, the lower group at equal means. Codes go to the tile's
// position-major slots (pad positions pack as 0).
__device__ __forceinline__ void group_pass(const float* sc, int* code_s,
                                           const Layout& L, int u0,
                                           int n_valid_pos) {
  const int TG = L.TG, gl = threadIdx.x % TG, step = kThreads / TG;
  const float fng = static_cast<float>(L.ng);
  // 32 or 64 rows: a multiple of a warp's 32 / TG rows, so whole warps stop
  const int n_rows = min(kPassRows, L.BP * L.S - u0);
  for (int row = threadIdx.x / TG; row < n_rows; row += step) {
    float best = INFINITY;
    int code = 0;
    for (int g = gl; g < L.n_groups; g += TG) {
      const float* src = sc + row * L.KS + g * L.GS;
      float sum = 0.f;
#pragma unroll 4
      for (int i = 0; i < L.ng; ++i) sum = __fadd_rn(sum, src[i]);
      const float gd = __fdiv_rn(sum, fng);
      if (gd < best) {
        best = gd;
        code = g;
      }
    }
    for (int o = TG / 2; o > 0; o >>= 1)
      vq::take_lower(best, code, __shfl_xor_sync(0xffffffffu, best, o),
                     __shfl_xor_sync(0xffffffffu, code, o));
    if (gl == 0) {
      const int u = u0 + row, s = u / L.BP, p = u - s * L.BP;
      code_s[p * L.S + s] = p < n_valid_pos ? code : 0;
    }
  }
}

// A tile's votes: slice row u (of position u / S) votes its position's
// full latent onto its group. The tile's rows are cut into kVoteWarps
// contiguous runs; warp w adds its run, in row order, into its own copy of
// the (n_groups, M) sums, two columns a lane, B rows a shared-memory round
// trip (a row whose group an earlier row of the B shares adds to that row's
// running value, as add_votes does). So every warp has the same number of
// rows, however the codes crowd, and no two warps touch one sum.
__device__ __forceinline__ void add_votes(const int* code_s, const float* zs,
                                          float* vsum, int n_valid,
                                          const Layout& L) {
  constexpr int B = 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, M = L.M;
  float* sums = vsum + static_cast<long long>(warp) * L.n_groups * M;
  const int hi = n_valid * (warp + 1) / kVoteWarps;
  for (int u0 = n_valid * warp / kVoteWarps; u0 < hi; u0 += B) {
    int k[B];
    const float* zr[B];
#pragma unroll
    for (int i = 0; i < B; ++i) {
      const bool on = u0 + i < hi;
      const unsigned u = on ? u0 + i : 0;
      k[i] = on ? code_s[u] : -1 - i;
      zr[i] = zs + (L.S > 1 ? __umulhi(u, L.zdiv) : u) * L.RSZ;
    }
    for (int c = 2 * lane; c < M; c += 64) {
      float2 v[B], t[B];
#pragma unroll
      for (int i = 0; i < B; ++i) {
        v[i] = *reinterpret_cast<const float2*>(zr[i] + c);
        t[i] = k[i] >= 0 ? *reinterpret_cast<const float2*>(sums + k[i] * M
                                                            + c)
                         : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int i = 0; i < B; ++i) {
        float2 run = t[i];
#pragma unroll
        for (int p = 0; p < i; ++p)
          if (k[p] == k[i]) run = t[p];   // the latest earlier row's value
        t[i] = make_float2(__fadd_rn(run.x, v[i].x), __fadd_rn(run.y, v[i].y));
      }
#pragma unroll
      for (int i = 0; i < B; ++i)
        if (k[i] >= 0) *reinterpret_cast<float2*>(sums + k[i] * M + c) = t[i];
    }
  }
}

}  // namespace gs

__global__ void __launch_bounds__(gs::kThreads, 1)
    gsvq_tiled_kernel(const float* __restrict__ z,
                      const float* __restrict__ codebooks,
                      uint32_t* __restrict__ words, int* __restrict__ pcounts,
                      float* __restrict__ psums, gs::Layout L, int P,
                      int bits, int nW, int tiles, bool vec) {
  using namespace gs;
  extern __shared__ __align__(16) float smem[];
  float* es = smem + L.es;                 // (S*K, RS) slice tables
  float* e2s = smem + L.e2s;               // (S*K,) their norms
  float* zt = smem + L.zt;                 // 2 x (BP, RSZ) latent tiles
  float* sc = smem + L.sc;                 // (64, KS) a pass's distances
  int* code_s = reinterpret_cast<int*>(smem + L.code);   // (BP*S,)
  float* vsum = smem + L.sums;             // kVoteWarps x (n_groups, M)
  int* cnt_s = reinterpret_cast<int*>(smem + L.cnt);     // (n_groups,)
  int* col_s = reinterpret_cast<int*>(smem + L.col);     // (K,) score column
  const int r = blockIdx.y, tid = threadIdx.x;
  const int rows = L.BP * L.S, M = L.M;
  const float* zr = z + static_cast<long long>(r) * P * M;
  const int G = group_codes(bits), W = group_words(bits), gpt = rows / G;
  // pack and counts run on the warps past the vote warps' while they vote
  const int aux = tid - 32 * kVoteWarps, n_aux = kThreads - 32 * kVoteWarps;

  for (int e = tid; e < kVoteWarps * L.n_groups * M; e += kThreads)
    vsum[e] = 0.f;
  for (int g = tid; g < L.n_groups; g += kThreads) cnt_s[g] = 0;
  for (int a = tid; a < L.K; a += kThreads)   // g*GS + a - g*ng, g = a / ng
    col_s[a] = L.GS == L.ng ? a : a + a / L.ng;
  stage_tables(es, codebooks + static_cast<long long>(r) * L.K * M, L, vec);
  stage_positions(zt, zr, static_cast<long long>(blockIdx.x) * L.BP, L, P,
                  vec);
  vq::cp_async_commit();
  // three barriers a tile: (1) this tile's latents have landed, and the
  // last tile's votes are done with its latents and codes; (2) the scores
  // are in `sc`; (3) the codes are in `code_s`
  for (int t = blockIdx.x, n = 0; t < tiles; t += gridDim.x, ++n) {
    const long long p0 = static_cast<long long>(t) * L.BP;
    const float* zs = zt + (n & 1) * L.BP * L.RSZ;
    vq::cp_async_wait<0>();                 // this tile (and the tables)
    __syncthreads();
    if (t + static_cast<int>(gridDim.x) < tiles) {   // the next tile lands
      stage_positions(zt + ((n + 1) & 1) * L.BP * L.RSZ, zr,  // meanwhile
                      p0 + static_cast<long long>(gridDim.x) * L.BP, L, P,
                      vec);
      vq::cp_async_commit();
    }
    if (n == 0) {                           // ||e||^2, once a block
      for (int row = tid; row < L.S * L.K; row += kThreads) {
        const float4* e =
            reinterpret_cast<const float4*>(es + static_cast<long long>(row)
                                                     * L.RS);
        float acc = 0.f;
        for (int q = 0; q < L.m / 4; ++q) {
          const float4 v = e[q];
          acc = fmaf(v.x, v.x, acc);
          acc = fmaf(v.y, v.y, acc);
          acc = fmaf(v.z, v.z, acc);
          acc = fmaf(v.w, v.w, acc);
        }
        e2s[row] = acc;
      }
      __syncthreads();
    }
    const int n_valid_pos = static_cast<int>(
        min(static_cast<long long>(L.BP), P - p0));
    for (int u0 = 0; u0 < rows; u0 += kPassRows) {
      if (u0 > 0) __syncthreads();          // the last pass's `sc` is read
      score_pass(zs, es, e2s, col_s, sc, L, u0);
      __syncthreads();
      group_pass(sc, code_s, L, u0, n_valid_pos);
    }
    __syncthreads();
    const int n_valid = n_valid_pos * L.S;
    if (aux >= 0) {
      // pack: the tile's whole super-groups, a thread a word
      for (int wi = aux; wi < gpt * W; wi += n_aux) {
        const int gi = wi / W;
        const long long g = static_cast<long long>(t) * gpt + gi;
        if (g < nW)
          words[(static_cast<long long>(r) * nW + g) * W + (wi - gi * W)] =
              pack_word(code_s + gi * G, bits, G, wi - gi * W);
      }
      // counts: a warp's rows of one code add once, by their lowest lane
      for (int u0 = aux & ~31; u0 < n_valid; u0 += n_aux) {
        const int u = u0 + (tid & 31);
        const int k = u < n_valid ? code_s[u] : -1;
        const unsigned peers = __match_any_sync(0xffffffffu, k);
        if (k >= 0 && (tid & 31) == __ffs(peers) - 1)
          atomicAdd(&cnt_s[k], __popc(peers));
      }
    } else {
      // statistics from the z tile in shared memory, each sum in row order
      gs::add_votes(code_s, zs, vsum, n_valid, L);
    }
  }
  // the block's partial: the vote warps' copies added in warp order
  __syncthreads();
  const long long part = static_cast<long long>(r) * gridDim.x + blockIdx.x;
  const int n_sums = L.n_groups * M;
  for (int e = tid; e < n_sums; e += kThreads) {
    float acc = vsum[e];
#pragma unroll
    for (int w = 1; w < kVoteWarps; ++w)
      acc = __fadd_rn(acc, vsum[w * n_sums + e]);
    psums[part * n_sums + e] = acc;
  }
  for (int g = tid; g < L.n_groups; g += kThreads)
    pcounts[part * L.n_groups + g] = cnt_s[g];
}

// out[r, k, c] for the 32 outputs of block `blk` from the (R, NB, n_groups,
// C) partials: atom k = g*ng + ng/2 (group g's representative) takes group
// g's sum over blocks, in reduce_block's fixed order; every other atom 0.
template <typename T>
__device__ __forceinline__ void reduce_rep_block(const T* __restrict__ part,
                                                 float* __restrict__ out,
                                                 int R, int NB, int K, int ng,
                                                 int C, long long blk) {
  __shared__ T seg_s[kSegments][32];
  const int lane = threadIdx.x & 31, seg = threadIdx.x >> 5;
  const long long n_out = static_cast<long long>(K) * C;
  const long long idx = blk * 32 + lane;
  const bool ok = idx < R * n_out;
  T acc = 0;
  if (ok) {
    const long long r = idx / n_out, e = idx - r * n_out;
    const int k = static_cast<int>(e / C);
    const int c = static_cast<int>(e - static_cast<long long>(k) * C);
    if (k % ng == ng / 2) {
      const long long n = static_cast<long long>(K / ng) * C;
      const T* src = part + r * NB * n + static_cast<long long>(k / ng) * C
                     + c;
      for (int bb = seg; bb < NB; bb += kSegments)
        acc += src[static_cast<long long>(bb) * n];
    }
  }
  seg_s[seg][lane] = acc;
  __syncthreads();
  if (seg == 0 && ok) {
    T total = 0;
    for (int q = 0; q < kSegments; ++q) total += seg_s[q][lane];
    out[idx] = static_cast<float>(total);
  }
}

// The GSVQ path's one reduce launch: blocks below `sum_blocks` write the
// (R, K, M) sums, the rest the (R, K) counts.
__global__ void reduce_reps(const float* __restrict__ psums,
                            const int* __restrict__ pcounts,
                            float* __restrict__ sums,
                            float* __restrict__ counts, int R, int NB, int K,
                            int M, int ng, unsigned sum_blocks) {
  if (blockIdx.x < sum_blocks)
    reduce_rep_block(psums, sums, R, NB, K, ng, M, blockIdx.x);
  else
    reduce_rep_block(pcounts, counts, R, NB, K, ng, 1,
                     blockIdx.x - sum_blocks);
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
// tiles; pcounts (R, nb, K) int32 and psums (R, nb, K, M) are scratch. The
// caller takes `nb` from the record's shape alone, so that a record's sums,
// added over its partials in reduce_block's fixed order, do not depend on R.
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

// The GSVQ path with every slice table resident. z (R, P, M) and codebooks
// (R, K, M), contiguous float32, S slices of width m = M / S (m % 4 == 0, m
// <= 64), n_groups groups of ng = K / n_groups atoms -> words (R*nW, W) of
// the position-major slice codes, counts (R, K), sums (R, K, M). `nb`
// blocks a record, each walking its record's tiles of BP positions (`nb`
// from the record's shape alone, as on the resident path);
// pcounts (R, nb, n_groups) int32 and psums (R, nb, n_groups, M) are
// scratch. Refuses shapes whose shared memory passes one block an SM.
extern "C" int rt_encode_codes_gsvq(const float* z, const float* codebooks,
                                    int* words, float* counts, float* sums,
                                    int* pcounts, float* psums, int R, int P,
                                    int K, int M, int S, int n_groups,
                                    int bits, int nb, int device,
                                    void* stream) {
  if (R < 1 || R > 65535 || P < 1 || K < 1 || M < 1 || S < 1 ||
      n_groups < 1 || (S == 1 && n_groups == 1) || M % S != 0 ||
      K % n_groups != 0 || (M / S) % 4 != 0 || M / S > 64 || bits < 1 ||
      bits > 32 || nb < 1)
    return cudaErrorInvalidValue;
  const gs::Layout L = gs::layout(K, M, S, n_groups);
  const int tiles = (P + L.BP - 1) / L.BP;
  if (nb > tiles) return cudaErrorInvalidValue;
  const size_t smem = L.total * sizeof(float);
  if (smem > gs::kBudget) return cudaErrorInvalidConfiguration;
  cudaError_t err = rt::use_device(device);
  if (err != cudaSuccess) return err;
  constexpr auto kernel = gsvq_tiled_kernel;
  err = rt::allow_smem<kernel>(device, gs::kBudget);
  if (err != cudaSuccess) return err;
  const int nW = static_cast<int>(
      (static_cast<long long>(P) * S + group_codes(bits) - 1) /
      group_codes(bits));
  const bool vec = vq::aligned16(z) && vq::aligned16(codebooks);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  kernel<<<dim3(nb, R), gs::kThreads, smem, st>>>(
      z, codebooks, reinterpret_cast<uint32_t*>(words), pcounts, psums, L, P,
      bits, nW, tiles, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n_sums = static_cast<long long>(R) * K * M;
  const unsigned sum_blocks = static_cast<unsigned>((n_sums + 31) / 32);
  const unsigned cnt_blocks =
      static_cast<unsigned>((static_cast<long long>(R) * K + 31) / 32);
  reduce_reps<<<sum_blocks + cnt_blocks, 32 * kSegments, 0, st>>>(
      psums, pcounts, sums, counts, R, nb, K, M, L.ng, sum_blocks);
  return cudaGetLastError();
}
