// Fused packed-code -> feature decode (the server's Step 6 hot path).
//
// Replaces the TPU kernel repro/kernels/decode_codes.py::decode_codes_pallas
// (_decode_kernel). The TPU kernel unpacks each (BLOCK_G, W) word tile and
// gathers decode-table rows through a one-hot MXU matmul.
//
// Bound on the H100: device-memory bytes, dominated by the output
// (count * F * 4 bytes, 256 B per code at full width against 1 B of packed
// code read). There is no arithmetic to speak of.
//
// Design: a gather needs no matrix unit on the GPU. Each thread owns one
// 16-byte vector of one output row (F / 4 threads per row when F % 4 == 0,
// else one float per thread), unpacks its row's code with the same shifts
// as the unpack kernel, and copies the vector of table row
// ((phase[g] + j) % S) * rows + code. Consecutive threads write
// consecutive 16-byte vectors, so stores coalesce. The table (64 KiB at
// full width) is read through the L1/L2 caches, where it stays resident.
// Rows are copies, so the result is bit-exact against the plain version; a
// row index past the table writes zeros, as the one-hot gather does.
#include "bits.cuh"
#include "launch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 20;

template <bool VEC4, typename I>
__global__ void decode_kernel(const uint32_t* __restrict__ words,
                              const int* __restrict__ phases,
                              const float* __restrict__ table,
                              float* __restrict__ out, I count, int n_tab,
                              int F, int rows, int S, int bits) {
  // G is a power of two (32 / gcd(bits, 32)): group and column by shifts
  const int G = group_codes(bits), W = group_words(bits);
  const int gshift = __ffs(G) - 1;
  const I fv = VEC4 ? F / 4 : F;  // vectors per row
  const I total = count * fv;
  const I stride = static_cast<I>(gridDim.x) * blockDim.x;
  for (I idx = static_cast<I>(blockIdx.x) * blockDim.x + threadIdx.x;
       idx < total; idx += stride) {
    const I i = idx / fv;
    const int c = static_cast<int>(idx - i * fv);
    const I g = i >> gshift;
    const int j = static_cast<int>(i & (G - 1));
    long long row = unpack_code(words + g * W, j, bits);
    if (S > 1) row += static_cast<long long>((phases[g] + j) % S) * rows;
    if (VEC4) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < n_tab) v = reinterpret_cast<const float4*>(table + row * F)[c];
      reinterpret_cast<float4*>(out + static_cast<long long>(i) * F)[c] = v;
    } else {
      out[static_cast<long long>(i) * F + c] =
          row < n_tab ? table[row * F + c] : 0.f;
    }
  }
}

template <bool VEC4>
void launch_decode(unsigned blocks, cudaStream_t st, const uint32_t* w,
                   const int* phases, const float* table, float* out,
                   long long count, long long total, int n_tab, int F,
                   int rows, int S, int bits) {
  // 32-bit index arithmetic whenever the output allows it: 64-bit integer
  // division costs tens of instructions per element
  if (total + static_cast<long long>(blocks) * kThreads < (1LL << 31))
    decode_kernel<VEC4, unsigned><<<blocks, kThreads, 0, st>>>(
        w, phases, table, out, static_cast<unsigned>(count), n_tab, F, rows,
        S, bits);
  else
    decode_kernel<VEC4, long long><<<blocks, kThreads, 0, st>>>(
        w, phases, table, out, count, n_tab, F, rows, S, bits);
}

}  // namespace

extern "C" int rt_decode_codes(const int* words, const int* phases,
                               const float* table, float* out,
                               long long count, int n_tab, int F, int rows,
                               int S, int bits, int device, void* stream) {
  if (bits < 1 || bits > 32 || F < 1 || S < 1) return cudaErrorInvalidValue;
  cudaError_t err = rt::use_device(device);
  if (err != cudaSuccess) return err;
  const bool vec4 = F % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long total = count * (vec4 ? F / 4 : F);
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(words);
  const unsigned nb = static_cast<unsigned>(blocks);
  if (vec4)
    launch_decode<true>(nb, st, w, phases, table, out, count, total, n_tab,
                        F, rows, S, bits);
  else
    launch_decode<false>(nb, st, w, phases, table, out, count, total, n_tab,
                         F, rows, S, bits);
  return cudaGetLastError();
}
