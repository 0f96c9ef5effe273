#!/usr/bin/env python3
"""Time the ``encode_codes`` CUDA kernels of several checkouts in turns, on
one NVIDIA GPU.

    python3 tools/encode_codes_turns.py [LABEL=DIR ...]

Each DIR is the root of a checkout of this repository (``this`` = the
checkout that holds this script, the default). Its
``src/repro_torch/kernels/csrc/encode_codes.cu`` is built alone by nvcc into
``build/encode_turns/LABEL.so`` (plain C interface, loaded with ctypes), so
two versions of the kernel run side by side in one process. Each is called
as its own checkout's wrapper calls it at plain VQ: through
``rt_encode_codes_resident`` where the library has it and the codebook fits
(``encode_path``), else through ``rt_encode_codes`` (one thread a row,
256-row blocks), with its scratch allocated once. At a full-width client
batch (1, 65,536, 64) x (1, 256, 64), at the train phase's largest
transmit (the 160 test images, (1, 10,240, 64)) and at 8 clients'
(8, 65,536, 64) x (8, 256, 64), 8 bits: each kernel's codes are held
against the plain version (``repro_torch.kernels.ref``, near-tie rule) and
its words against the packing of its own codes; then the kernels are timed
by CUDA events in turns (first, second, ..., second, first, in every
trial), the plain version beside them, and each kernel's device time is read
from ``torch.profiler``, in all and split by kernel name. Prints the card's
name and power limit, one JSON line, and exits non-zero without a GPU or on
a disagreement.
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

BUILD = ROOT / "build" / "encode_turns"
SHAPES = ((1, 65536, 256, 64), (1, 10240, 256, 64), (8, 65536, 256, 64))
BITS = 8
PROFILE_REPS = 20


def build(label: str, tree: Path):
    """(the loaded library, ptxas' register lines)."""
    from repro_torch.kernels import _build
    src = tree / "src" / "repro_torch" / "kernels" / "csrc" / "encode_codes.cu"
    BUILD.mkdir(parents=True, exist_ok=True)
    so = BUILD / f"{label}.so"
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                          str(src), "-o", str(so)],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(str(so))
    for name in ("rt_encode_codes", "rt_encode_codes_resident"):
        if hasattr(lib, name):               # as _build.library() binds it
            fn = getattr(lib, name)
            fn.argtypes = list(_build._SIGNATURES[name])
            fn.restype = ctypes.c_int
    usage = [ln.strip() for ln in (res.stdout + res.stderr).splitlines()
             if "registers" in ln or "spill" in ln]
    return lib, usage


def caller(lib, z, cb):
    """(path, a call of the library's kernel on z and cb -> (words, counts,
    sums)), its outputs and scratch allocated once, as the wrapper of the
    library's own checkout sizes them."""
    import torch
    from repro_torch.kernels.encode_codes import (BLOCK_ROWS, TILE_ROWS,
                                                  _sm_count, encode_path)
    from repro_torch.kernels.pack_bits import packing_dims
    R, P, M = z.shape
    K = cb.shape[1]
    G, W = packing_dims(BITS)
    dev = z.device
    words = torch.empty((R * -(-P // G), W), dtype=torch.int32, device=dev)
    counts = torch.empty((R, K), device=dev)
    sums = torch.empty((R, K, M), device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    out = (words, counts, sums)
    if hasattr(lib, "rt_encode_codes_resident") \
            and encode_path(K, M) == "resident":
        nb = min(-(-P // TILE_ROWS), max(1, _sm_count(dev.index) // R))
        pc = torch.empty((R, nb, K), dtype=torch.int32, device=dev)
        ps = torch.empty((R, nb, K, M), device=dev)

        def call():
            err = lib.rt_encode_codes_resident(
                z.data_ptr(), cb.data_ptr(), words.data_ptr(),
                counts.data_ptr(), sums.data_ptr(), pc.data_ptr(),
                ps.data_ptr(), R, P, K, M, BITS, nb, dev.index, stream)
            if err:
                raise RuntimeError(f"rt_encode_codes_resident returned {err}")
            return out
        return "resident", call
    NB = -(-P // BLOCK_ROWS)
    pc = torch.empty((R, NB, K), device=dev)
    ps = torch.empty((R, NB, K, M), device=dev)

    def call():
        err = lib.rt_encode_codes(
            z.data_ptr(), cb.data_ptr(), words.data_ptr(), counts.data_ptr(),
            sums.data_ptr(), pc.data_ptr(), ps.data_ptr(), R, P, P, M, M, K,
            1, 1, 0, BITS, BLOCK_ROWS, NB, dev.index, stream)
        if err:
            raise RuntimeError(f"rt_encode_codes returned {err}")
        return out
    return "thread_per_row", call


def check(label, call, z, cb, scores):
    """Codes by the near-tie rule against the plain scores, words the
    packing of the kernel's own codes, counts exact, sums within
    1e-5 of the summed magnitudes."""
    import torch
    from repro_torch.kernels import ref
    R, P, _ = z.shape
    K = cb.shape[1]
    words, counts, sums = call()
    torch.cuda.synchronize()
    codes = ref.unpack_records_ref(words, bits=BITS, n_records=R,
                                   per_record=P)
    n_diff, n_out = ref.code_mismatches(codes, scores.argmin(-1), scores)
    p_counts, p_sums = ref.encode_stats(z, codes, K)
    _, mag = ref.encode_stats(z.abs(), codes, K)
    ok = (n_out == 0 and n_diff <= 1e-3 * codes.numel()
          and torch.equal(words, ref.pack_codes_ref(
              ref.pad_records(codes, BITS), bits=BITS))
          and torch.equal(counts, p_counts)
          and bool(((sums - p_sums).abs() <= 1e-5 * mag + 1e-6).all()))
    if not ok:
        raise AssertionError(f"{label} at {tuple(z.shape)} x {K}: "
                             f"{n_diff} codes differ ({n_out} outside near "
                             f"ties), or its words, counts or sums")
    return n_diff


def device_split(fn):
    """(mean device ms a call, {kernel name: ms a call}) over PROFILE_REPS
    calls (``chip_smoke.device_ms``)."""
    return chip_smoke.device_ms(fn, PROFILE_REPS)[:2]


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("encode_codes_turns: no CUDA device", file=sys.stderr)
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
    for R, P, K, M in SHAPES:
        z = torch.randn((R, P, M), generator=gen, device=dev)
        cb = torch.randn((R, K, M), generator=gen, device=dev)
        scores = ref.encode_scores(z, cb)
        calls, row = {}, {"shape": [R, P, K, M]}
        for label, (lib, _) in libs.items():
            path, calls[label] = caller(lib, z, cb)
            row[label] = {"path": path, "codes_differ": check(
                label, calls[label], z, cb, scores)}
        order = list(calls) + list(calls)[::-1]
        ms = chip_smoke.cuda_ms_turns([calls[k] for k in order], reps=50)
        for label in calls:
            row[label]["ms"] = [t for k, t in zip(order, ms) if k == label]
            row[label]["device_ms"], row[label]["device_ms_by_kernel"] = \
                device_split(calls[label])
        row["plain_ms"] = chip_smoke.cuda_ms(
            lambda: ref.encode_codes_ref(z, cb, bits=BITS))
        words = -(-P // 4)                    # 8 bits: 4 codes a word
        row["bound_ms"], row["bound_by"] = chip_smoke.bound(
            (z.numel() + cb.numel() + R * words + R * K + R * K * M) * 4,
            2 * R * P * K * M)
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps({"card": smi, "turns": rows,
                      "ptxas": {k: u for k, (_, u) in libs.items()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
