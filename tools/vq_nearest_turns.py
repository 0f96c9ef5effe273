#!/usr/bin/env python3
"""Time the ``vq_nearest`` CUDA kernel of several checkouts in turns, on
one NVIDIA GPU.

    python3 tools/vq_nearest_turns.py [LABEL=DIR ...]

Each DIR is the root of a checkout of this repository (``this`` = the
checkout that holds this script, the default). Its
``src/repro_torch/kernels/csrc/vq_nn.cu`` is built alone by nvcc into
``build/vq_turns/LABEL.so`` (plain C interface, loaded with ctypes), so two
versions of the kernel run side by side in one process. At a training
step's (2,048, 256, 64) and a full-width client batch's (65,536, 256, 64)
-- rows, atoms, width -- each kernel's codes are held against the plain
version (``repro_torch.kernels.ref``, near-tie rule); then the kernels are
timed by CUDA events in turns (first, second, ..., second, first, in every
trial), the plain version beside them, and each kernel's device time is
read from ``torch.profiler`` (``chip_smoke.py``'s timing helpers and
bound). Prints the card's name and power limit, one
JSON line, and exits non-zero without a GPU or on a disagreement.
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

BUILD = ROOT / "build" / "vq_turns"
SHAPES = ((2048, 256, 64), (65536, 256, 64))


def build(label: str, tree: Path):
    """(the loaded library's rt_vq_nearest, ptxas' register lines)."""
    from repro_torch.kernels import _build
    src = tree / "src" / "repro_torch" / "kernels" / "csrc" / "vq_nn.cu"
    BUILD.mkdir(parents=True, exist_ok=True)
    so = BUILD / f"{label}.so"
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                          str(src), "-o", str(so)],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{res.stdout}{res.stderr}")
    fn = ctypes.CDLL(str(so)).rt_vq_nearest
    fn.argtypes = list(_build._SIGNATURES["rt_vq_nearest"])
    fn.restype = ctypes.c_int                 # as _build.library() binds it
    usage = [ln.strip() for ln in (res.stdout + res.stderr).splitlines()
             if "registers" in ln]
    return fn, usage


def caller(fn, z, cb, out):
    import torch
    N, M = z.shape
    K = cb.shape[0]
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        err = fn(z.data_ptr(), cb.data_ptr(), out.data_ptr(), N, K, M,
                 z.get_device(), stream)
        if err:
            raise RuntimeError(f"rt_vq_nearest returned {err}")
        return out
    return call


def device_ms(fn, reps=20):
    """Mean device time of one call's kernel (torch.profiler)."""
    events, _, _ = chip_smoke.profile_kernels(fn, reps=reps)
    return sum(b - a for _, a, b in events) / len(events) / 1e3 \
        if events else None


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("vq_nearest_turns: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import resolve_device
    from repro_torch.kernels import ref
    dev = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    trees = dict(a.split("=", 1) for a in argv) or {"this": str(ROOT)}
    libs = {k: build(k, Path(v).resolve()) for k, v in trees.items()}
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for N, K, M in SHAPES:
        z = torch.randn((N, M), generator=gen, device=dev)
        cb = torch.randn((K, M), generator=gen, device=dev)
        scores = ref.vq_scores(z, cb)
        want = scores.argmin(-1)
        calls, row = {}, {"shape": [N, K, M]}
        for label, (fn, _) in libs.items():
            out = torch.empty((N,), dtype=torch.int32, device=dev)
            calls[label] = caller(fn, z, cb, out)
            n_diff, n_out = ref.code_mismatches(calls[label](), want, scores)
            if n_out or n_diff > 1e-3 * N:
                raise AssertionError(f"{label} at {N, K, M}: {n_diff} codes "
                                     f"differ, {n_out} outside near ties")
            row[label] = {"codes_differ": n_diff}
        order = list(calls) + list(calls)[::-1]
        ms = chip_smoke.cuda_ms_turns([calls[k] for k in order], reps=50)
        for label in calls:
            row[label]["ms"] = [t for k, t in zip(order, ms) if k == label]
            row[label]["device_ms"] = device_ms(calls[label])
        row["plain_ms"] = chip_smoke.cuda_ms(
            lambda: ref.vq_nearest_ref(z, cb))
        row["bound_ms"], row["bound_by"] = chip_smoke.bound(
            (N * M + K * M + N) * 4, 2 * N * K * M)
        rows.append(row)
    print(json.dumps({"card": smi, "turns": rows,
                      "ptxas": {k: u for k, (_, u) in libs.items()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
