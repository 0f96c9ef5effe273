// The pieces of TF32 three-pass products and cp.async staging that the
// flash attention kernels share (flash_attention.cu, flash_attention_bwd.cu).
//
// One TF32 pass keeps ~3 decimal digits. A product taken as three passes,
// a * b ~ a_hi * b_hi + a_hi * b_lo + a_lo * b_hi, each a TF32 mma with FP32
// accumulation, lands ~1e-6 off the FP32 product (the CPU models in
// tests/test_torch_lm_kernels.py and tests/test_torch_flash_bwd_tf32.py
// hold both).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace tf32x3 {

// x ~ hi + lo, both TF32. hi is x rounded to nearest, ties away from zero:
// the value cvt.rna.tf32.f32 gives for every non-NaN x, in two integer
// operations (ptxas expands the cvt into a longer sequence with NaN tests,
// and the split runs ~10 times a product). The remainder x - hi is exact in
// FP32 and is cut to TF32 toward zero, as the tensor core reads an FP32
// register (it drops the low 13 bits). Rounding lo to nearest as well would
// move a product by < 2^-22 of itself, cost two more operations, and carry
// the GPU's canonical NaN 0x7fffffff into the sign bit, so a NaN in q, k or
// v would come out as a number; cut toward zero, a NaN stays a NaN in lo.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// d += a (16 x 8, row) * b (8 x 8, col), TF32 in, FP32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared, asynchronously; zeros when !pred
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most N of this thread's committed copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

}  // namespace tf32x3
