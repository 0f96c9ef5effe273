#!/usr/bin/env python3
"""Time the ``pack_codes`` and ``unpack_codes`` CUDA kernels of several
checkouts in turns, on one NVIDIA GPU.

    python3 tools/pack_bits_turns.py [LABEL=DIR ...]

Each DIR is the root of a checkout of this repository (``this`` = the
checkout that holds this script, the default). Its
``src/repro_torch/kernels/csrc/pack_bits.cu`` is built alone by nvcc into
``build/pack_turns/LABEL.so`` (plain C interface, loaded with ctypes), all
builds started together, so that several versions run side by side in one
process. At the serving path's 65,536 codes at 8 bits and at a cohort's
uplink (1,024 clients x 65,536 codes = 67,108,864) at 1, 4, 5, 7, 8, 10, 16
and 32 bits: each library's words and codes are held bit-exact against the
plain version (``repro_torch.kernels.ref``); then the raw C calls of every
library and, at 8 bits, the byte-conversion calls that compute the same
functions (``codes.to(uint8).view(int32)``, ``words.view(uint8).to(int32)``)
are timed by CUDA events in turns (first, ..., last, last, ..., first, in
every trial), and each one's device time is read from ``torch.profiler``.
Then the host's microseconds a wrapper call at the serving shape (1,000
back-to-back calls, one synchronize): each checkout's own
``kernels/pack_bits.py`` around its own library, in turns. Prints the card's
name and power limit, one JSON line a shape and a last summary line; exits
non-zero without a GPU or on a disagreement.
"""
from __future__ import annotations

import ctypes
import importlib.util
import json
import re
import subprocess
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
import chip_smoke  # noqa: E402  (its timing helpers; it imports no torch)

BUILD = ROOT / "build" / "pack_turns"
MAIN_CODES = chip_smoke.IMAGES_PER_CLIENT * 64
COHORT_BITS = (1, 4, 5, 7, 8, 10, 16, 32)
SHAPES = ((8, MAIN_CODES),) + tuple((b, chip_smoke.COHORT_CODES)
                                    for b in COHORT_BITS)
PROFILE_REPS = 20
HOST_TRIALS = 5
ENTRIES = ("rt_pack_codes", "rt_unpack_codes")


def build_all(trees):
    """{label: (library, [kernel, registers, spill bytes] at 8 bits and of
    every kernel that spills)}; one nvcc a library, all at once."""
    from repro_torch.kernels import _build
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for label, tree in trees.items():
        src = tree / "src" / "repro_torch" / "kernels" / "csrc" / "pack_bits.cu"
        procs[label] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", str(src), "-o",
             str(BUILD / f"{label}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out = {}
    for label, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {label}:\n{log}")
        lib = ctypes.CDLL(str(BUILD / f"{label}.so"))
        for name in ENTRIES:                 # as _build.library() binds them
            fn = getattr(lib, name)
            fn.argtypes = list(_build._SIGNATURES[name])
            fn.restype = ctypes.c_int
        usage = [u for u in chip_smoke.ptxas_usage(log)
                 if u[0].endswith("<8>") or u[2]]
        out[label] = (lib, usage)
    return out


def wrapper(label: str, tree: Path, lib):
    """The checkout's own ``kernels/pack_bits.py``, launching ``lib``."""
    from repro_torch.kernels import _build
    name = "repro_torch.kernels._pack_turns_" + re.sub(r"\W", "_", label)
    spec = importlib.util.spec_from_file_location(
        name, tree / "src" / "repro_torch" / "kernels" / "pack_bits.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    def check(err, kernel):
        if err:
            raise RuntimeError(f"{label} {kernel} returned {err}")

    mod._build = types.SimpleNamespace(library=lambda: lib, check=check,
                                       stream_of=_build.stream_of)
    return mod


def shape_row(libs, bits, count, gen):
    """Check every library at (bits, count), then time them in turns."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.pack_bits import packing_dims
    dev = gen.device
    _, W = packing_dims(bits)
    codes = ref.as_int32_bits(torch.randint(0, 1 << bits, (count,),
                                            generator=gen, device=dev))
    want = ref.pack_codes_ref(codes, bits=bits)
    n = want.shape[0]
    card, stream = codes.get_device(), torch.cuda.current_stream().cuda_stream
    fns = {}
    for label, (lib, _) in libs.items():
        words = torch.empty_like(want)
        back = torch.empty_like(codes)

        def pack(lib=lib, words=words):
            return lib.rt_pack_codes(codes.data_ptr(), count,
                                     words.data_ptr(), n, bits, card, stream)

        def unpack(lib=lib, back=back):
            return lib.rt_unpack_codes(want.data_ptr(), n, back.data_ptr(),
                                       count, bits, card, stream)

        if pack() or unpack():
            raise RuntimeError(f"{label} failed to launch at {bits} bits")
        torch.cuda.synchronize()
        if not (torch.equal(words, want) and torch.equal(back, codes)):
            raise AssertionError(f"{label} differs at {bits} bits x {count}")
        fns[f"{label}:pack"], fns[f"{label}:unpack"] = pack, unpack
    if bits == 8:
        fns["conversion:pack"] = lambda: codes.to(torch.uint8).view(
            torch.int32)
        fns["conversion:unpack"] = lambda: want.view(torch.uint8).to(
            torch.int32)
        if not (torch.equal(fns["conversion:pack"](), want.view(-1))
                and torch.equal(fns["conversion:unpack"]().view(-1), codes)):
            raise AssertionError("the byte conversions differ")
    order = list(fns) + list(fns)[::-1]
    ms = chip_smoke.cuda_ms_turns([fns[k] for k in order],
                                  reps=50 if count <= MAIN_CODES else 20)
    bound_ms, _ = chip_smoke.bound((count + n * W) * 4, 0)
    row = {"bits": bits, "codes": count, "words": n * W,
           "bound_ms": bound_ms, "bound_by": "bytes"}
    for key, fn in fns.items():
        for _ in range(3):          # a profiler session may keep no events
            dev_ms = chip_smoke.device_ms(fn, PROFILE_REPS)[0]
            if dev_ms is not None:
                break
        row[key] = {"ms": [t for k, t in zip(order, ms) if k == key],
                    "device_ms": dev_ms,
                    "bound_share": bound_ms / dev_ms if dev_ms else None}
    return row


def host_turns(wrappers, gen):
    """Host microseconds a wrapper call at the serving shape, each
    checkout's wrapper in turns over HOST_TRIALS trials."""
    import torch
    codes = torch.randint(0, 256, (MAIN_CODES,), generator=gen,
                          device=gen.device, dtype=torch.int32)
    words = next(iter(wrappers.values())).pack_codes_cuda(codes, bits=8)
    calls = {}
    for label, mod in wrappers.items():
        calls[f"{label}:pack"] = lambda mod=mod: mod.pack_codes_cuda(codes,
                                                                     bits=8)
        calls[f"{label}:unpack"] = lambda mod=mod: mod.unpack_codes_cuda(
            words, bits=8, count=MAIN_CODES)
    out = {k: [] for k in calls}
    for trial in range(HOST_TRIALS):
        keys = list(calls) if trial % 2 == 0 else list(calls)[::-1]
        for k in keys:
            out[k].append(chip_smoke.host_us(calls[k]))
    return out


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("pack_bits_turns: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import resolve_device
    resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    trees = {label: Path(tree).resolve() for label, tree in
             (a.split("=", 1) for a in argv)} or {"this": ROOT}
    libs = build_all(trees)
    gen = torch.Generator(device="cuda:0").manual_seed(0)
    rows = []
    for bits, count in SHAPES:
        rows.append(shape_row(libs, bits, count, gen))
        print(json.dumps(rows[-1]), flush=True)
    host = host_turns({label: wrapper(label, tree, libs[label][0])
                       for label, tree in trees.items()}, gen)
    print(json.dumps({"card": smi, "turns": rows, "host_us": host,
                      "ptxas": {k: u for k, (_, u) in libs.items()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
