#!/usr/bin/env python3
"""Run part of ``chip_smoke.py`` on one NVIDIA GPU: the card's line, the
kernels' build, ``lm_kernels`` and the named phases, then the ``grad``
line. A phase is one of ``chip_smoke.py``'s ``WIDE_PHASES`` (with its
profile and flash row) or one of its training phases, ``lm_whisper_train``
(with the flash backward's rows at whisper-base's three shapes) and
``lm_hybrid_train`` (with selective_scan_bwd's row), or ``lm_mesh`` (the
mesh path, after the ``lm_serve`` phase whose weights it takes). Every
line is the one
``chip_smoke.py`` prints, from the same functions and under the same
checks.

    python3 tools/smoke_phases.py [PHASE ...]     # default: lm_deepseek

A quicker run of one model than the whole script. Exits non-zero without a
GPU, on an unknown phase or where a check fails.
"""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as C  # noqa: E402


def whisper_train(dev):
    out = C.phase_lm_whisper_train(dev)
    C.emit({"phase": "lm_whisper_train_flash_bwd_rows",
            **C.whisper_bwd_rows(dev, out["bwd_by_shape"])})


def hybrid_train(dev):
    out = C.phase_lm_hybrid_train(dev)
    C.emit({"phase": "lm_hybrid_train_scan_bwd_row",
            "row": C.scan_bwd_row(dev,
                                  out["launches"]["selective_scan_bwd"])})


def mesh(dev):
    lm = C.phase_lm_serve(dev)
    C.phase_lm_mesh(dev, lm)


TRAIN_PHASES = {"lm_whisper_train": whisper_train,
                "lm_hybrid_train": hybrid_train, "lm_mesh": mesh}


def main(argv) -> int:
    import torch
    phases = {p[0]: p for p in C.WIDE_PHASES}
    names = argv or ["lm_deepseek"]
    unknown = [n for n in names if n not in phases and n not in TRAIN_PHASES]
    if unknown:
        print(f"smoke_phases: unknown phases {unknown}; WIDE_PHASES has "
              f"{list(phases)}, the training phases {list(TRAIN_PHASES)}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("smoke_phases: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    dev, _ = C.phase_device()
    C.phase_build()
    C.phase_lm_kernels(dev)
    for name in names:
        t = time.perf_counter()
        if name in TRAIN_PHASES:
            TRAIN_PHASES[name](dev)
        else:
            C.run_wide(dev, *phases[name])
        C.emit({"phase_seconds": {name: time.perf_counter() - t}})
    C.emit({"phase": "grad", **C.GRAD})
    C.emit({"seconds": time.perf_counter() - t0})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
