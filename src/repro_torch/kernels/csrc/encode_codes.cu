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
// Design, and what differs from the TPU kernel:
//  * The TPU grid runs in order and carries the argmin across K steps in
//    VMEM scratch and the statistics across N steps in the output block.
//    GPU blocks run in parallel and in no order. Here a block owns `bn`
//    consecutive rows of one record (a multiple of lcm(32, S): whole warps,
//    whole positions, whole super-groups), loops over the record's table
//    itself, and packs its own words.
//  * One thread per row. The row's latent sits in registers (padded with
//    zeros to MT, a compile-time width), the table is staged in shared
//    memory in chunks of CK rows per slice (rows padded to MT floats, so a
//    row is read as 16-byte vectors that every thread of a warp shares).
//    Threads are laid out so that a warp holds rows of one slice. The dot
//    product runs as two interleaved FMA chains, so the FMA latency is
//    hidden with few warps per SM; ||e||^2 is one warp per staged row.
//  * Scores follow the reference's formula: VQ `e2 - 2*cross`, with no
//    ||z||^2; GSVQ `sqrt(max(z2 - 2*cross + e2, 0) + 1e-12)` summed over a
//    group's ng atoms and divided by ng, all in FP32. The sums run in
//    another order than the reference's, hence the near-tie rule. Ties
//    keep the lower index: strict `<` in index order.
//  * Pad rows (past the record's count) pack as 0 and cast no vote.
//  * Statistics without float atomics, so they are the same from run to
//    run: the block's (K, M) sums are accumulated in shared memory (over
//    the spent table chunk), each (atom, column) by one thread in row
//    order; counts by integer atomics. Each block writes one partial, and
//    a second kernel adds the partials in a fixed order.
#include "bits.cuh"
#include "launch.cuh"

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

// out[r, i] = sum over blocks of part[r, b, i] in a fixed order: segment s
// adds blocks b = s, s + 8, ... in block order, then the eight segment sums
// are added in segment order. One warp per segment, one lane per output.
__global__ void reduce_partials(const float* __restrict__ part,
                                float* __restrict__ out, int R, int NB,
                                long long n) {
  __shared__ float seg_s[kSegments][32];
  const int lane = threadIdx.x & 31, seg = threadIdx.x >> 5;
  const long long idx = static_cast<long long>(blockIdx.x) * 32 + lane;
  const bool ok = idx < R * n;
  float acc = 0.f;
  if (ok) {
    const long long r = idx / n;
    const float* src = part + r * NB * n + (idx - r * n);
    for (int bb = seg; bb < NB; bb += kSegments)
      acc += src[static_cast<long long>(bb) * n];
  }
  seg_s[seg][lane] = acc;
  __syncthreads();
  if (seg == 0 && ok) {
    float total = 0.f;
    for (int q = 0; q < kSegments; ++q) total += seg_s[q][lane];
    out[idx] = total;
  }
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
