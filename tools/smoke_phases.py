#!/usr/bin/env python3
"""Run part of ``chip_smoke.py`` on one NVIDIA GPU: the card's line, the
kernels' build, ``lm_kernels`` and the named full-width phases of its
``WIDE_PHASES`` (each with its profile and flash row), then the ``grad``
line. Every line is the one ``chip_smoke.py`` prints, from the same
functions and under the same checks.

    python3 tools/smoke_phases.py [PHASE ...]     # default: lm_deepseek

A quicker run of one wide model than the whole script. Exits non-zero
without a GPU, on an unknown phase or where a check fails.
"""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as C  # noqa: E402


def main(argv) -> int:
    import torch
    phases = {p[0]: p for p in C.WIDE_PHASES}
    names = argv or ["lm_deepseek"]
    unknown = [n for n in names if n not in phases]
    if unknown:
        print(f"smoke_phases: unknown phases {unknown}; WIDE_PHASES has "
              f"{list(phases)}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("smoke_phases: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    dev, _ = C.phase_device()
    C.phase_build()
    C.phase_lm_kernels(dev)
    for name in names:
        C.run_wide(dev, *phases[name])
    C.emit({"phase": "grad", **C.GRAD})
    C.emit({"seconds": time.perf_counter() - t0})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
