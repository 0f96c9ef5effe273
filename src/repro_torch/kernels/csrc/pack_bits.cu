// Dense b-bit packing of code indices into uint32 super-groups, and back.
//
// Replaces the TPU kernels repro/kernels/pack_bits.py::pack_codes_pallas
// (_pack_kernel) and ::unpack_codes_pallas (_unpack_kernel).
//
// Bound on the H100: device-memory bytes. Each code is read once as an
// int32 and each word written once (unpack: the reverse); the integer
// shifts cost a few instructions per code, far below the memory time.
//
// Design: one thread per super-group, grid-stride. The code width is a
// template parameter instantiated for 1..32 bits, so G, W, every shift
// and every straddle test are compile-time constants and the loops unroll
// into straight-line shift/OR code, as the TPU kernel unrolls its columns.
// Arithmetic is uint32_t, so a straddling code never picks up sign bits.
// Pad codes past `count` pack as 0.
#include "bits.cuh"
#include "launch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 20;

template <int BITS>
__global__ void pack_kernel(const int* __restrict__ codes, long long count,
                            uint32_t* __restrict__ words, long long n_groups) {
  constexpr int G = group_codes(BITS), W = group_words(BITS);
  constexpr uint32_t MASK = code_mask(BITS);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long g = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       g < n_groups; g += stride) {
    uint32_t w[W];
#pragma unroll
    for (int i = 0; i < W; ++i) w[i] = 0u;
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const long long p = g * G + j;
      const uint32_t c = p < count ? (static_cast<uint32_t>(codes[p]) & MASK)
                                   : 0u;
      const int o = j * BITS, w0 = o / 32, s = o % 32;
      w[w0] |= c << s;
      if (s + BITS > 32) w[w0 + 1] |= c >> (32 - s);
    }
#pragma unroll
    for (int i = 0; i < W; ++i) words[g * W + i] = w[i];
  }
}

template <int BITS>
__global__ void unpack_kernel(const uint32_t* __restrict__ words,
                              long long n_groups, int* __restrict__ codes,
                              long long count) {
  constexpr int G = group_codes(BITS), W = group_words(BITS);
  constexpr uint32_t MASK = code_mask(BITS);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long g = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       g < n_groups; g += stride) {
    uint32_t w[W];
#pragma unroll
    for (int i = 0; i < W; ++i) w[i] = words[g * W + i];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const long long p = g * G + j;
      if (p < count) {
        const int o = j * BITS, w0 = o / 32, s = o % 32;
        uint32_t v = w[w0] >> s;
        if (s + BITS > 32) v |= w[w0 + 1] << (32 - s);
        codes[p] = static_cast<int>(v & MASK);
      }
    }
  }
}

unsigned grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

}  // namespace

#define RT_BITS_CASES(X)                                                    \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13)     \
  X(14) X(15) X(16) X(17) X(18) X(19) X(20) X(21) X(22) X(23) X(24) X(25)  \
  X(26) X(27) X(28) X(29) X(30) X(31) X(32)

extern "C" int rt_pack_codes(const int* codes, long long count, int* words,
                             long long n_groups, int bits, int device,
                             void* stream) {
  cudaError_t err = rt::use_device(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint32_t* out = reinterpret_cast<uint32_t*>(words);
  switch (bits) {
#define RT_PACK(B)                                                         \
  case B:                                                                  \
    pack_kernel<B><<<grid_for(n_groups), kThreads, 0, st>>>(codes, count,  \
                                                            out, n_groups); \
    break;
    RT_BITS_CASES(RT_PACK)
#undef RT_PACK
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

extern "C" int rt_unpack_codes(const int* words, long long n_groups,
                               int* codes, long long count, int bits,
                               int device, void* stream) {
  cudaError_t err = rt::use_device(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* in = reinterpret_cast<const uint32_t*>(words);
  switch (bits) {
#define RT_UNPACK(B)                                                        \
  case B:                                                                   \
    unpack_kernel<B><<<grid_for(n_groups), kThreads, 0, st>>>(in, n_groups, \
                                                              codes, count); \
    break;
    RT_BITS_CASES(RT_UNPACK)
#undef RT_UNPACK
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

extern "C" const char* rt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
