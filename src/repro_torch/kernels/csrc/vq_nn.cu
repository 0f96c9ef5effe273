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
// peak, against 0.6 MB of inputs and outputs, 0.2 us of memory. The
// scores must reproduce the reference's FP32 formula, so they run on the
// FP32 FMA pipes, not on tensor cores in TF32 (which would flip codes).
//
// Design, and what differs from the TPU kernel:
//  * The TPU grid walks K blocks in order and carries the running best in
//    VMEM scratch; atoms past K are padded with a 1e30 norm to fill its
//    fixed block shapes. Here each block stages the codebook in shared
//    memory in chunks of CK atoms and loops to K itself, so nothing is
//    padded.
//  * `split` threads share one row, each scanning every split-th atom of
//    a chunk (the row sits in each one's registers, padded with zeros to
//    MT, a compile-time width). The split is chosen per launch so that a
//    small N still fills the SMs: a training step's 2,048 rows would
//    otherwise be 8 blocks on 132 SMs. The `split` lanes of a row are
//    consecutive lanes of one warp and combine their bests by shuffles.
//  * Staged atom rows are padded to MT + 4 floats, so the `split` atoms
//    that one warp reads at once fall in different shared-memory banks.
//  * Ties keep the lower index: each lane scans its atoms in index order
//    with a strict `<`, and the combine takes the lower index at equal
//    scores -- the rule of the TPU kernel's carry.
//  * The dot product runs as two interleaved FMA chains, and
//    ||e||^2 per staged atom is one warp reduction, both as in
//    encode_codes.cu. Sums run in another order than the reference's,
//    hence the near-tie rule of the tests.
#include <cuda_runtime.h>

#include "launch.cuh"

#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kTableBytes = 96 * 1024;   // shared memory for atom chunks
constexpr int kMaxSmem = 227 * 1024;

template <int MT>
__global__ void vq_nearest_kernel(const float* __restrict__ z,
                                  const float* __restrict__ codebook,
                                  int* __restrict__ out, long long N, int K,
                                  int M, int split, int CK) {
  extern __shared__ __align__(16) float smem[];
  constexpr int RS = MT + 4;               // padded staged-row stride
  float* es = smem;                        // (CK, RS)
  float* e2s = es + CK * RS;               // (CK,)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const int sub = tid % split;
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x / split) + tid / split;
  const bool valid = row < N;

  float zr[MT];
  {
    const float* zrow = z + (valid ? row : 0) * M;
#pragma unroll
    for (int k = 0; k < MT; ++k) zr[k] = (valid && k < M) ? zrow[k] : 0.f;
  }

  float best = INFINITY;
  int code = 0;
  for (int k0 = 0; k0 < K; k0 += CK) {
    const int ck = min(CK, K - k0);
    __syncthreads();
    for (int idx = tid; idx < CK * MT; idx += blockDim.x) {
      const int i = idx / MT, k = idx - i * MT;
      es[i * RS + k] = (i < ck && k < M)
                           ? codebook[(static_cast<long long>(k0) + i) * M + k]
                           : 0.f;
    }
    __syncthreads();
    for (int i = warp; i < ck; i += n_warps) {
      float acc = 0.f;
      for (int k = lane; k < MT; k += 32)
        acc = fmaf(es[i * RS + k], es[i * RS + k], acc);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (lane == 0) e2s[i] = acc;
    }
    __syncthreads();
    for (int i = sub; i < ck; i += split) {
      const float4* e4 = reinterpret_cast<const float4*>(es + i * RS);
      float c0 = 0.f, c1 = 0.f;
#pragma unroll
      for (int q = 0; q < MT / 4; q += 2) {
        const float4 e = e4[q];
        c0 = fmaf(zr[4 * q], e.x, c0);
        c0 = fmaf(zr[4 * q + 1], e.y, c0);
        c0 = fmaf(zr[4 * q + 2], e.z, c0);
        c0 = fmaf(zr[4 * q + 3], e.w, c0);
        if (q + 1 < MT / 4) {
          const float4 f = e4[q + 1];
          c1 = fmaf(zr[4 * q + 4], f.x, c1);
          c1 = fmaf(zr[4 * q + 5], f.y, c1);
          c1 = fmaf(zr[4 * q + 6], f.z, c1);
          c1 = fmaf(zr[4 * q + 7], f.w, c1);
        }
      }
      const float score = e2s[i] - 2.f * (c0 + c1);
      if (score < best) {
        best = score;
        code = k0 + i;
      }
    }
  }

  // combine the split lanes of a row: the lower score, or at equal scores
  // the lower index
  for (int o = split >> 1; o > 0; o >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, o);
    const int oc = __shfl_xor_sync(0xffffffffu, code, o);
    if (ob < best || (ob == best && oc < code)) {
      best = ob;
      code = oc;
    }
  }
  if (valid && sub == 0) out[row] = code;
}

template <int MT>
cudaError_t launch(long long N, int K, int M, int split, cudaStream_t st,
                   const float* z, const float* codebook, int* out) {
  const int RS = MT + 4;
  int CK = kTableBytes / ((RS + 1) * 4);
  CK = CK < K ? CK : K;
  const size_t smem = (static_cast<size_t>(CK) * RS + CK) * 4;
  if (smem > kMaxSmem) return cudaErrorInvalidConfiguration;
  auto kernel = vq_nearest_kernel<MT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long rows_per_block = kThreads / split;
  const long long blocks = (N + rows_per_block - 1) / rows_per_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(
      z, codebook, out, N, K, M, split, CK);
  return cudaGetLastError();
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
  // the least split (a power of two, at most a warp) that gives two blocks
  // per SM, and no more lanes per row than the row has atoms to scan
  int split = 1;
  while (split < 32 && split < K &&
         N * split < 2LL * sms * kThreads)
    split *= 2;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RT_VQ(W_)                                                     \
  if (M <= W_) return launch<W_>(N, K, M, split, st, z, codebook, out);
  RT_VQ(4) RT_VQ(8) RT_VQ(16) RT_VQ(32) RT_VQ(64) RT_VQ(128) RT_VQ(256)
#undef RT_VQ
  return cudaErrorInvalidValue;
}
