// Dense b-bit packing of code indices into uint32 super-groups, and back.
//
// Replaces the TPU kernels repro/kernels/pack_bits.py::pack_codes_pallas
// (_pack_kernel) and ::unpack_codes_pallas (_unpack_kernel).
//
// Bound on the H100: device-memory bytes. Each code is read once as an
// int32 and each word written once (unpack: the reverse); the shifts cost
// a few instructions a code, below the memory time once they are shared
// across a warp as below.
//
// Design. Code p sits at bit p*b of the word stream (the super-groups are
// consecutive), so 128 consecutive codes fill exactly 4b words at any width
// b, and such a chunk starts on a word and holds whole super-groups. Both
// sides of a chunk therefore move as 16-byte vectors: 512 bytes of codes,
// b vectors of words. A warp owns whole chunks; lane t holds codes 4t..4t+3.
//  * pack: each lane loads its 4 codes as one vector. Up to 16 bits, the
//    lane ORs them into one 4b-bit field and word i of the chunk gathers the
//    fields that overlap it by warp shuffles (at most 32/4b + 2 of them);
//    wider, the codes go to shared memory (one pad int every 32, so the
//    lanes forming neighbouring words read distinct banks) and word i ORs
//    the codes that overlap it, as bits.cuh::pack_group does. Either way a
//    lane forms whole words, word-major, and the chunk's b vectors of words
//    are stored from shared memory.
//  * unpack: the warp stages its chunks' words in shared memory by 16-byte
//    cp.async; lane t forms codes 4t..4t+3, bits [4tb, 4tb + 4b) of the
//    chunk (at most 5 words, a straddle by a funnel shift), and stores them
//    as one vector.
//  * b = 32 is a copy.
// The width is a template parameter for 1..32, so every shift that the
// layout fixes is a constant. Stores are streaming (st.global.cs): the
// output passes through L2 once and is not read again by the kernel.
//
// The grid: one block of kWarps warps for every kWarps groups of chunks, a
// group a warp, all its loads issued before the first is used. A group is
// kUnroll consecutive chunks (2 KB of codes a warp in flight, one write
// front) where that still gives every SM a block, else one chunk (the
// serving path's 512 chunks land on 128 blocks, not 32). On an NVIDIA H100
// 80GB HBM3 at 700 W (tools/pack_bits_turns.py, PERF.md) this beat a
// persistent grid-stride walk of the same groups at every width of a
// 67,108,864-code stream (8 bits: 0.109 against 0.116 ms for pack, 0.117
// against 0.123 for unpack), and strided groups, 2 or 8 chunks a group,
// 8-warp blocks, double-buffered staging and higher occupancy measured no
// faster. The edges take a masked path inside the same kernel: lanes whose
// 4 codes or words pass the end of the stream, and every access where a
// pointer is not 16-byte aligned, go element by element; codes past
// `count` pack as 0, and unpack writes no code at or past `count`.
#include <type_traits>

#include "bits.cuh"
#include "launch.cuh"

namespace {

// kChunk, kWarps and kUnroll are mirrored by pack_bits.py (CHUNK, WARPS,
// GROUP), which names the path a call takes
constexpr int kChunk = 128;                  // codes a chunk: 4b words
constexpr int kWarps = 4;                    // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 4;                   // chunks a group, at most
constexpr int kMinBlocks = 8;                // an SM: at most 64 registers

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// shared index of code p of a chunk: one pad int every 32 codes
__device__ __forceinline__ int padded(int p) { return p + (p >> 5); }

// Elements p..p+3 of a stream of n, zero past n: one 16-byte load where it
// is aligned and whole, else element by element.
__device__ __forceinline__ uint4 load4(const uint32_t* __restrict__ src,
                                       long long p, long long n, bool vec) {
  if (vec && p + 4 <= n) return *reinterpret_cast<const uint4*>(src + p);
  uint4 v;
  v.x = p < n ? src[p] : 0u;
  v.y = p + 1 < n ? src[p + 1] : 0u;
  v.z = p + 2 < n ? src[p + 2] : 0u;
  v.w = p + 3 < n ? src[p + 3] : 0u;
  return v;
}

// Store v to elements p..p+3 of a stream of n, none at or past n.
__device__ __forceinline__ void store4(uint32_t* __restrict__ dst,
                                       long long p, long long n, bool vec,
                                       uint4 v) {
  if (vec && p + 4 <= n) {
    __stcs(reinterpret_cast<uint4*>(dst + p), v);
    return;
  }
  if (p < n) dst[p] = v.x;
  if (p + 1 < n) dst[p + 1] = v.y;
  if (p + 2 < n) dst[p + 2] = v.z;
  if (p + 3 < n) dst[p + 3] = v.w;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(src)
               : "memory");
}

// 4 bytes, or 0 bytes and a zero fill where !pred (src must stay valid)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::
                   : "memory");
}

// The first chunk of the calling warp's group of `per_warp` chunks.
__device__ __forceinline__ long long first_chunk(int per_warp) {
  return (blockIdx.x * static_cast<long long>(kWarps) + (threadIdx.x >> 5)) *
         per_warp;
}

// b = 32: dst[i] = src[i] for i < n, over the warp's group of chunks.
__device__ __forceinline__ void copy_chunks(const uint32_t* __restrict__ src,
                                            uint32_t* __restrict__ dst,
                                            long long n, bool vec,
                                            int per_warp) {
  const int lane = threadIdx.x & 31;
  const long long c0 = first_chunk(per_warp);
  uint4 v[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)
    if (u < per_warp) v[u] = load4(src, (c0 + u) * kChunk + 4 * lane, n, vec);
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)
    if (u < per_warp) store4(dst, (c0 + u) * kChunk + 4 * lane, n, vec, v[u]);
}

// Word i of a chunk from its masked codes in shared memory (padded index),
// b in 17..31: the OR of codes floor(32i/b) .. floor((32i+31)/b), each
// shifted to its bit, the parts of straddling codes included.
template <int BITS>
__device__ __forceinline__ uint32_t form_word(const uint32_t* sc, int i) {
  constexpr int NJ = 32 / BITS + 2;          // most codes overlapping a word
  const int j0 = (32 * i) / BITS;
  uint32_t acc = 0;
#pragma unroll
  for (int k = 0; k < NJ; ++k) {
    const int j = j0 + k;
    const int o = j * BITS - 32 * i;         // in (-BITS, 32) if it overlaps
    if (o < 32) {
      const uint32_t c = sc[padded(j)];
      acc |= o >= 0 ? c << o : c >> -o;
    }
  }
  return acc;
}

// Word i of a chunk (i = lane + 32r) from the lanes' fields, b <= 16: lane t
// holds its 4 masked codes as one 4b-bit field F_t at chunk bit 4tb, so word
// i ORs the fields of lanes 8i/b onward that overlap it (at most 32/4b + 2),
// each taken by a warp shuffle. Every lane runs every shuffle.
template <int BITS, typename F>
__device__ __forceinline__ uint32_t gather_word(F field, int i) {
  constexpr int FB = 4 * BITS;               // bits a field
  if constexpr (32 % FB == 0) {              // fields tile the word exactly
    uint32_t acc = 0;
#pragma unroll
    for (int k = 0; k < 32 / FB; ++k)
      acc |= static_cast<uint32_t>(
                 __shfl_sync(0xFFFFFFFFu, field, (i * (32 / FB) + k) & 31))
             << (k * FB);
    return acc;
  } else {
    constexpr int K = 32 / FB + 2;
    const int t0 = (8 * i) / BITS;
    uint32_t acc = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int t = t0 + k;
      const F f = __shfl_sync(0xFFFFFFFFu, field, t & 31);
      const int o = t * FB - 32 * i;         // in (-FB, 32) if it overlaps
      if (t < 32 && o < 32)
        acc |= static_cast<uint32_t>(o >= 0 ? f << o : f >> -o);
    }
    return acc;
  }
}

// Codes 4t..4t+3 of a chunk whose words start at cw (t = lane).
template <int BITS>
__device__ __forceinline__ uint4 form_codes(const uint32_t* cw, int lane) {
  constexpr uint32_t MASK = code_mask(BITS);
  const int s = 4 * lane * BITS;             // the lane's first bit
  const int w0 = s >> 5, s0 = s & 31;
  uint32_t v[4];
  if constexpr (BITS <= 8 && 32 % BITS == 0) {   // 4 codes in one word
    const uint32_t w = cw[w0];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = (w >> (s0 + j * BITS)) & MASK;
  } else if constexpr (BITS == 16) {             // 2 words, s0 = 0
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = (cw[w0 + j / 2] >> (16 * (j & 1))) & MASK;
  } else {                                       // straddles: funnel shifts
    constexpr int NW = (3 * BITS) / 32 + 3;
    uint32_t w[NW];
#pragma unroll
    for (int k = 0; k < NW; ++k) w[k] = cw[w0 + k];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kb = (j * BITS) >> 5;
      const int q = s0 + ((j * BITS) & 31);  // < 64
      const bool up = q >= 32;
      const uint32_t lo = up ? w[kb + 1] : w[kb];
      const uint32_t hi = up ? w[kb + 2] : w[kb + 1];
      v[j] = __funnelshift_r(lo, hi, q) & MASK;
    }
  }
  return make_uint4(v[0], v[1], v[2], v[3]);
}

template <int BITS>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
pack_kernel(const uint32_t* __restrict__ codes, long long count,
            uint32_t* __restrict__ words, long long n_words, bool vec,
            int per_warp) {
  if constexpr (BITS == 32) {
    copy_chunks(codes, words, count, vec, per_warp);
  } else {
    constexpr int CW = 4 * BITS;             // words a chunk
    constexpr uint32_t MASK = code_mask(BITS);
    __shared__ __align__(16) uint32_t s_words[kWarps][CW];
    const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
    uint32_t* sw = s_words[wib];
    const long long n_chunks = (count + kChunk - 1) / kChunk;
    const long long c0 = first_chunk(per_warp);
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (u < per_warp)
        v[u] = load4(codes, (c0 + u) * kChunk + 4 * lane, count, vec);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long c = c0 + u;
      if (u >= per_warp || c >= n_chunks) break;   // uniform across the warp
      if constexpr (BITS <= 16) {            // fields through shuffles
        using F = std::conditional_t<BITS <= 8, uint32_t, unsigned long long>;
        const F field = static_cast<F>(v[u].x & MASK) |
                        static_cast<F>(v[u].y & MASK) << BITS |
                        static_cast<F>(v[u].z & MASK) << (2 * BITS) |
                        static_cast<F>(v[u].w & MASK) << (3 * BITS);
#pragma unroll
        for (int r = 0; r < (CW + 31) / 32; ++r) {
          const int i = lane + 32 * r;
          const uint32_t w = gather_word<BITS>(field, i);
          if (i < CW) sw[i] = w;
        }
      } else {                               // codes through shared memory
        __shared__ uint32_t s_codes[kWarps][kChunk + kChunk / 32];
        uint32_t* sc = s_codes[wib];
        const int p = padded(4 * lane);      // the lane's 4 codes, one row
        sc[p] = v[u].x & MASK;
        sc[p + 1] = v[u].y & MASK;
        sc[p + 2] = v[u].z & MASK;
        sc[p + 3] = v[u].w & MASK;
        __syncwarp();
#pragma unroll
        for (int r = 0; r < (CW + 31) / 32; ++r) {
          const int i = lane + 32 * r;
          if (i < CW) sw[i] = form_word<BITS>(sc, i);
        }
      }
      __syncwarp();
      if (lane < BITS)                       // the chunk's b vectors
        store4(words, c * CW + 4 * lane, n_words, vec,
               reinterpret_cast<const uint4*>(sw)[lane]);
      __syncwarp();                          // the buffers are reused
    }
  }
}

template <int BITS>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
unpack_kernel(const uint32_t* __restrict__ words, long long n_words,
              uint32_t* __restrict__ codes, long long count, bool vec,
              int per_warp) {
  if constexpr (BITS == 32) {
    copy_chunks(words, codes, count, vec, per_warp);
  } else {
    constexpr int CW = 4 * BITS;             // words a chunk
    constexpr int SLACK = 4;                 // read past the last chunk
    __shared__ __align__(16) uint32_t s_words[kWarps][kUnroll * CW + SLACK];
    const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
    uint32_t* sw = s_words[wib];
    if (lane < SLACK) sw[kUnroll * CW + lane] = 0u;
    const long long n_chunks = (count + kChunk - 1) / kChunk;
    const long long c0 = first_chunk(per_warp);
    // stage the group's words: vector t is vector q of chunk u
#pragma unroll
    for (int r = 0; r < (kUnroll * BITS + 31) / 32; ++r) {
      const int t = lane + 32 * r;
      const int u = t / BITS, q = t - u * BITS;
      if (u < per_warp) {
        const long long w = (c0 + u) * CW + 4 * q;
        uint32_t* dst = sw + u * CW + 4 * q;
        if (vec && w + 4 <= n_words) {
          cp_async16(dst, words + w);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const bool ok = w + j < n_words;
            cp_async4(dst + j, ok ? words + w + j : words, ok);
          }
        }
      }
    }
    cp_async_wait_all();
    __syncwarp();
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long c = c0 + u;
      if (u >= per_warp || c >= n_chunks) break;   // uniform across the warp
      store4(codes, c * kChunk + 4 * lane, count, vec,
             form_codes<BITS>(sw + u * CW, lane));
    }
  }
}

// (blocks, chunks a warp): groups of kUnroll chunks where they give every
// SM a block, else one chunk a warp.
void grid_for(long long count, int device, unsigned* blocks, int* per_warp) {
  const long long chunks = (count + kChunk - 1) / kChunk;
  const long long full = (chunks + kWarps * kUnroll - 1) / (kWarps * kUnroll);
  *per_warp = full >= rt::sm_count(device) ? kUnroll : 1;
  *blocks = static_cast<unsigned>(
      (chunks + kWarps * *per_warp - 1) / (kWarps * *per_warp));
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
  if (bits < 1 || bits > 32) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* in = reinterpret_cast<const uint32_t*>(codes);
  uint32_t* out = reinterpret_cast<uint32_t*>(words);
  const long long n_words = n_groups * group_words(bits);
  const bool vec = aligned16(codes) && aligned16(words);
  unsigned grid;
  int per_warp;
  grid_for(count, device, &grid, &per_warp);
  switch (bits) {
#define RT_PACK(B)                                                      \
  case B:                                                               \
    pack_kernel<B><<<grid, kThreads, 0, st>>>(in, count, out, n_words, \
                                               vec, per_warp);          \
    break;
    RT_BITS_CASES(RT_PACK)
#undef RT_PACK
  }
  return cudaGetLastError();
}

extern "C" int rt_unpack_codes(const int* words, long long n_groups,
                               int* codes, long long count, int bits,
                               int device, void* stream) {
  cudaError_t err = rt::use_device(device);
  if (err != cudaSuccess) return err;
  if (bits < 1 || bits > 32) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* in = reinterpret_cast<const uint32_t*>(words);
  uint32_t* out = reinterpret_cast<uint32_t*>(codes);
  const long long n_words = n_groups * group_words(bits);
  const bool vec = aligned16(words) && aligned16(codes);
  unsigned grid;
  int per_warp;
  grid_for(count, device, &grid, &per_warp);
  switch (bits) {
#define RT_UNPACK(B)                                                      \
  case B:                                                                 \
    unpack_kernel<B><<<grid, kThreads, 0, st>>>(in, n_words, out, count, \
                                                 vec, per_warp);          \
    break;
    RT_BITS_CASES(RT_UNPACK)
#undef RT_UNPACK
  }
  return cudaGetLastError();
}

extern "C" const char* rt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
