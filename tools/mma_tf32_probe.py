#!/usr/bin/env python3
"""Measure two facts of the GPU's TF32 ``mma.sync`` m16n8k8 that the
three-pass kernels (``src/repro_torch/kernels/csrc/tf32x3.cuh``) are
designed around.

    python3 tools/mma_tf32_probe.py

1. Its rate: warps that issue only mma.sync with constant operands, 1, 2 or
   4 warps a sub-partition, each with 1 or 4 independent accumulators
   (chains), timed by CUDA events.
2. How its FP32 accumulator rounds: 2^20 products of 8 x tf32(0.1) summed in
   one accumulator, beside the float32 round-to-nearest sum and the exact
   one. A sum below the round-to-nearest one shows truncation.

The kernel is built by nvcc into ``build/mma_probe/``. Prints the card's
name and power limit, then one JSON line; exits non-zero without a GPU.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
import chip_smoke  # noqa: E402  (its timing helpers; it imports no torch)

BUILD = ROOT / "build" / "mma_probe"
PROBE_SRC = r"""
#include <cstdint>
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <int CH>
__global__ void chains(float* out, int iters, uint32_t x) {
  const uint32_t a[4] = {x, x, x, x};
  float d[CH][4] = {};
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int c = 0; c < CH; ++c) mma(d[c], a, x + c, x - c);
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < CH; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  if (s == 1.2345f) out[threadIdx.x] = s;
}
__global__ void accumulate(float* out, float x, int n) {
  const uint32_t one = __float_as_uint(1.f), xb = __float_as_uint(x);
  const uint32_t a[4] = {one, one, one, one};
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  for (int i = 0; i < n; ++i) mma(d, a, xb, xb);
  if (threadIdx.x == 0) out[0] = d[0];
}
extern "C" int probe_chains(float* out, int warps, int iters, int ch,
                            void* st) {
  cudaStream_t s = static_cast<cudaStream_t>(st);
  if (ch == 1) chains<1><<<warps, 32, 0, s>>>(out, iters, 0x3f800000u);
  else chains<4><<<warps, 32, 0, s>>>(out, iters, 0x3f800000u);
  return cudaGetLastError();
}
extern "C" int probe_accumulate(float* out, float x, int n, void* st) {
  accumulate<<<1, 32, 0, static_cast<cudaStream_t>(st)>>>(out, x, n);
  return cudaGetLastError();
}
"""


def probe(dev):
    """The card's mma.sync TF32 rate and its accumulator's rounding."""
    import numpy as np
    import torch
    from repro_torch.kernels import _build
    BUILD.mkdir(parents=True, exist_ok=True)
    src, so = BUILD / "probe.cu", BUILD / "probe.so"
    src.write_text(PROBE_SRC)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", str(src),
                    "-o", str(so)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.probe_chains.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_void_p]
    lib.probe_accumulate.argtypes = [ctypes.c_void_p, ctypes.c_float,
                                     ctypes.c_int, ctypes.c_void_p]
    out = torch.zeros(32, device=dev)
    st = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rates = {}
    for per_smsp in (1, 2, 4):
        for ch in (1, 4):
            warps, iters = 4 * sms * per_smsp, 20000

            def run():
                if lib.probe_chains(out.data_ptr(), warps, iters, ch, st):
                    raise RuntimeError("probe_chains failed to launch")
            ms = chip_smoke.cuda_ms(run, reps=1, trials=3)
            rates[f"{per_smsp} warps a sub-partition, {ch} chains"] = \
                warps * iters * ch * 16 * 8 * 8 * 2 / ms / 1e9
    n, x = 1 << 20, 0.1
    lib.probe_accumulate(out.data_ptr(), x, n, st)
    term = np.float32(8) * (np.array([x], np.float32).view(np.uint32)
                            & np.uint32(0xffffe000)).view(np.float32)[0]
    rn = np.float32(0)
    for _ in range(n):
        rn = np.float32(rn + term)
    return {"mma_sync_tf32_tflops": rates,
            "accumulate_2^20_terms_of_8*tf32(0.1)": {
                "mma_accumulator": float(out[0]), "float32_rn": float(rn),
                "exact": float(np.float64(term) * n)}}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("mma_tf32_probe: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import resolve_device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(json.dumps({"card": smi, **probe(resolve_device("cuda"))}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
