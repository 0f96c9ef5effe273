// Super-group bit layout shared by the pack, unpack, encode and decode
// kernels (the layout of repro/kernels/pack_bits.py).
//
// A super-group holds G = lcm(b, 32) / b codes in W = lcm(b, 32) / 32
// uint32 words; code j sits at bit j*b of the group and may straddle two
// words. Streams are zero-padded to whole groups.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

__host__ __device__ constexpr int gcd_int(int a, int b) {
  return b == 0 ? a : gcd_int(b, a % b);
}

// codes per super-group: lcm(b, 32) / b
__host__ __device__ constexpr int group_codes(int bits) {
  return 32 / gcd_int(bits, 32);
}

// words per super-group: lcm(b, 32) / 32
__host__ __device__ constexpr int group_words(int bits) {
  return bits / gcd_int(bits, 32);
}

__host__ __device__ constexpr uint32_t code_mask(int bits) {
  return bits == 32 ? 0xFFFFFFFFu : ((1u << bits) - 1u);
}

// Code j of the group whose words start at w (bits known at run time).
__device__ __forceinline__ uint32_t unpack_code(const uint32_t* w, int j,
                                                int bits) {
  const int o = j * bits, w0 = o >> 5, s = o & 31;
  uint32_t v = w[w0] >> s;
  if (s + bits > 32) v |= w[w0 + 1] << (32 - s);
  return v & code_mask(bits);
}

// Word i of the group of G codes at `codes` (bits known at run time): the
// OR of every code whose bits overlap it.
__device__ __forceinline__ uint32_t pack_word(const int* codes, int bits,
                                              int G, int i) {
  const uint32_t mask = code_mask(bits);
  uint32_t acc = 0;
  const int j0 = (32 * i) / bits;
  const int j1 = min(G - 1, (32 * i + 31) / bits);
  for (int j = j0; j <= j1; ++j) {
    const uint32_t c = static_cast<uint32_t>(codes[j]) & mask;
    const int o = j * bits - 32 * i;  // in (-bits, 32)
    acc |= o >= 0 ? (c << o) : (c >> (-o));
  }
  return acc;
}

// Pack the G codes at `codes` into the group's W words at `out`.
__device__ __forceinline__ void pack_group(const int* codes, int bits, int G,
                                           int W, uint32_t* out) {
  for (int i = 0; i < W; ++i) out[i] = pack_word(codes, bits, G, i);
}
