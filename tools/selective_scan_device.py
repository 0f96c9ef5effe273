#!/usr/bin/env python3
"""Device time of the ``selective_scan`` CUDA kernel at a Jamba prefill's
shape, on one NVIDIA GPU.

    python3 tools/selective_scan_device.py

Builds the port's kernels, draws Mamba-like scan inputs at (8, 1,024,
8,192, 16) (``chip_smoke.scan_case``: decay = exp(dt * A), a zero h0, as a
prefill has), holds the kernel against its plain version
(``chip_smoke.scan_errors``), then reads its device time from
``torch.profiler`` over windows of 1, 3 and 10 calls
(``chip_smoke.device_ms``) and its time by CUDA events over back-to-back
calls (``chip_smoke.cuda_ms``), beside its bytes bound. Prints the card's
name and power limit, one JSON line, and exits non-zero without a GPU or on
a disagreement.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
import chip_smoke  # noqa: E402  (its helpers; it imports no torch)

SHAPE = (8, 1024, 8192, 16)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("selective_scan_device: no CUDA device", file=sys.stderr)
        return 1
    dev, smi = chip_smoke.phase_device()
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.selective_scan import selective_scan_cuda
    _build.build()
    _build.library()
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    args = chip_smoke.scan_case(dev, gen, *SHAPE, "mamba", zero_h0=True)
    y, h = selective_scan_cuda(*args)
    want_y, want_h = ref.selective_scan_ref(*args)
    _, _, worst = chip_smoke.scan_errors(
        y, h, want_y, want_h, chip_smoke.scan_magnitude(*args))
    chip_smoke.require(worst <= 1.0, f"selective_scan: {worst}x the "
                       f"tolerance")
    decay, _, c, h0 = args
    nbytes = (2 * decay.numel() + c.numel() + h0.numel() + y.numel()
              + h.numel()) * 4
    bound_ms, bound_by = chip_smoke.bound(nbytes, 4 * decay.numel())
    del y, h, want_y, want_h

    def call():
        return selective_scan_cuda(*args)

    windows = {}
    for reps in (1, 3, 10):
        dev_ms, by_kernel, n = chip_smoke.device_ms(call, reps)
        windows[reps] = {"device_ms": dev_ms, "events": n,
                         "device_ms_by_kernel": by_kernel}
    print(json.dumps({"card": smi, "shape": list(SHAPE),
                      "max_err_over_tolerance": worst,
                      "ms": chip_smoke.cuda_ms(call, reps=10),
                      "profiler_windows": windows, "bound_ms": bound_ms,
                      "bound_by": bound_by}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
