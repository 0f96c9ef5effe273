#!/usr/bin/env python3
"""Time the ``encode_codes`` CUDA kernels of several checkouts in turns, on
one NVIDIA GPU.

    python3 tools/encode_codes_turns.py [--only vq|gsvq] [LABEL=DIR ...]

Each DIR is the root of a checkout of this repository (``this`` = the
checkout that holds this script, the default). Its
``src/repro_torch/kernels/csrc/encode_codes.cu`` is built alone by nvcc into
``build/encode_turns/LABEL.so`` (plain C interface, loaded with ctypes), so
two versions of the kernel run side by side in one process. Each is called
as its own checkout's wrapper calls it: through ``rt_encode_codes_resident``
(plain VQ whose codebook fits) or ``rt_encode_codes_gsvq`` (GSVQ whose slice
tables fit) where the library has the entry and ``encode_path`` picks it,
else through ``rt_encode_codes`` (one thread a row, 256-row blocks, on the
slice-stacked table), with its scratch allocated once.

Shapes (``--only`` picks one set): plain VQ at 8 bits, a full-width client
batch (1, 65,536, 64) x (1, 256, 64), the train phase's largest transmit
(1, 10,240, 64), 8 clients' (8, 65,536, 64) x (8, 256, 64) and a cohort
of 64 clients' (64, 16,384, 64) x (64, 256, 64); GSVQ g8s2 (8
groups, 2 slices, K 256, M 64, 3 bits) at the speech transmit's (1, 7,680,
64) and at (1, 65,536, 64). Each kernel's codes are held against the plain
version (``repro_torch.kernels.ref``, near-tie rule) and its words, counts
and sums against the packing and statistics of its own codes; then the
kernels are timed by CUDA events in turns (first, second, ..., second,
first, in every trial), the plain version beside them, and each kernel's
device time is read from ``torch.profiler``, in all and split by kernel
name. Prints the card's name and power limit, one JSON line a shape and one
in all, and exits non-zero without a GPU or on a disagreement.
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
#: (R, P, K, M, n_groups, n_slices, bits)
VQ_SHAPES = ((1, 65536, 256, 64, 1, 1, 8), (1, 10240, 256, 64, 1, 1, 8),
             (8, 65536, 256, 64, 1, 1, 8), (64, 16384, 256, 64, 1, 1, 8))
GSVQ_SHAPES = ((1, 7680, 256, 64, 8, 2, 3), (1, 65536, 256, 64, 8, 2, 3))
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
    for name in ("rt_encode_codes", "rt_encode_codes_resident",
                 "rt_encode_codes_gsvq"):
        if hasattr(lib, name):               # as _build.library() binds it
            fn = getattr(lib, name)
            fn.argtypes = list(_build._SIGNATURES[name])
            fn.restype = ctypes.c_int
    usage = [ln.strip() for ln in (res.stdout + res.stderr).splitlines()
             if "registers" in ln or "spill" in ln]
    return lib, usage


def shape_partials(tree: Path) -> bool:
    """Whether the checkout's wrapper takes a record's partials from its
    shape (``resident_partials``); older ones took ``SM count // R``."""
    wrapper = tree / "src" / "repro_torch" / "kernels" / "encode_codes.py"
    return "def resident_partials" in wrapper.read_text()


def caller(lib, z, cb, n_groups, n_slices, bits, by_shape=True):
    """(path, a call of the library's kernel on z and cb -> (words, counts,
    sums)), its outputs and scratch allocated once, as the wrapper of the
    library's own checkout sizes them (``by_shape``: partials from the
    record's shape, else one block an SM spread over the records)."""
    import torch
    from repro_torch.kernels import encode_codes as E
    from repro_torch.kernels.pack_bits import packing_dims
    R, P, M = z.shape
    K = cb.shape[1]
    gsvq = n_groups > 1 or n_slices > 1
    S = n_slices if gsvq else 1
    G, W = packing_dims(bits)
    dev = z.device
    words = torch.empty((R * -(-P * S // G), W), dtype=torch.int32,
                        device=dev)
    counts = torch.empty((R, K), device=dev)
    sums = torch.empty((R, K, M), device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    out = (words, counts, sums)
    path = E.encode_path(K, M, n_groups=n_groups, n_slices=n_slices)

    def checked(name, err):
        if err:
            raise RuntimeError(f"{name} returned {err}")
        return out

    if path == "resident" and hasattr(lib, "rt_encode_codes_resident"):
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        nb = E.resident_partials(P) if by_shape else \
            min(-(-P // E.TILE_ROWS), max(1, sms // R))
        pc = torch.empty((R, nb, K), dtype=torch.int32, device=dev)
        ps = torch.empty((R, nb, K, M), device=dev)
        return path, lambda: checked("rt_encode_codes_resident",
                                     lib.rt_encode_codes_resident(
            z.data_ptr(), cb.data_ptr(), words.data_ptr(),
            counts.data_ptr(), sums.data_ptr(), pc.data_ptr(),
            ps.data_ptr(), R, P, K, M, bits, nb, dev.index, stream))
    if path == "gsvq_tiled" and hasattr(lib, "rt_encode_codes_gsvq"):
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        nb = E.gsvq_partials(P, S) if by_shape else \
            min(-(-P // E.gsvq_tile_positions(S)), max(1, sms // R))
        pc = torch.empty((R, nb, n_groups), dtype=torch.int32, device=dev)
        ps = torch.empty((R, nb, n_groups, M), device=dev)
        return path, lambda: checked("rt_encode_codes_gsvq",
                                     lib.rt_encode_codes_gsvq(
            z.data_ptr(), cb.data_ptr(), words.data_ptr(),
            counts.data_ptr(), sums.data_ptr(), pc.data_ptr(),
            ps.data_ptr(), R, P, K, M, S, n_groups, bits, nb, dev.index,
            stream))
    bn = E.block_rows(S)
    Pn = P * S
    NB = -(-Pn // bn)
    ng = K // n_groups if gsvq else 1
    pc = torch.empty((R, NB, K), device=dev)
    ps = torch.empty((R, NB, K, M), device=dev)

    def call():
        table = E.stacked_slice_table(cb, n_slices=S) if gsvq else cb
        return checked("rt_encode_codes", lib.rt_encode_codes(
            z.data_ptr(), table.data_ptr(), words.data_ptr(),
            counts.data_ptr(), sums.data_ptr(), pc.data_ptr(), ps.data_ptr(),
            R, P, Pn, M // S, M, K, S, ng, int(gsvq), bits, bn, NB,
            dev.index, stream))
    return "thread_per_row", call


def check(label, call, z, cb, kw):
    """Codes by the near-tie rule against the plain scores; words the
    packing of the kernel's own codes; counts exact and sums within 1e-5 of
    the summed magnitudes. Returns the codes that differ."""
    import torch
    from repro_torch.kernels import ref
    R, P, _ = z.shape
    K = cb.shape[1]
    bits, n_groups, n_slices = kw["bits"], kw["n_groups"], kw["n_slices"]
    S = n_slices if n_groups > 1 or n_slices > 1 else 1
    words, counts, sums = call()
    torch.cuda.synchronize()
    scores = ref.encode_scores(z, cb, n_groups=n_groups, n_slices=n_slices)
    codes = ref.unpack_records_ref(words, bits=bits, n_records=R,
                                   per_record=P * S)
    n_diff, n_out = ref.code_mismatches(codes, scores.argmin(-1), scores)
    ok = (n_out == 0 and n_diff <= 1e-3 * codes.numel()
          and torch.equal(words, ref.pack_codes_ref(
              ref.pad_records(codes, bits), bits=bits)))
    if ok:
        st = dict(n_groups=n_groups, n_slices=n_slices)
        p_counts, p_sums = ref.encode_stats(z, codes, K, **st)
        _, mag = ref.encode_stats(z.abs(), codes, K, **st)
        ok = (torch.equal(counts, p_counts)
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
    only = None
    if argv[:1] == ["--only"]:
        only, argv = argv[1], argv[2:]
    shapes = {"vq": VQ_SHAPES, "gsvq": GSVQ_SHAPES}.get(
        only, VQ_SHAPES + GSVQ_SHAPES)
    dev = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    trees = dict(a.split("=", 1) for a in argv) or {"this": str(ROOT)}
    libs, by_shape = {}, {}
    for label, tree in trees.items():
        libs[label] = build(label, Path(tree).resolve())
        by_shape[label] = shape_partials(Path(tree).resolve())
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for R, P, K, M, n_groups, n_slices, bits in shapes:
        z = torch.randn((R, P, M), generator=gen, device=dev)
        z = (z - z.mean(1, keepdim=True)) / z.std(1, keepdim=True)
        cb = torch.randn((R, K, M), generator=gen, device=dev)
        kw = dict(bits=bits, n_groups=n_groups, n_slices=n_slices)
        calls, row = {}, {"shape": [R, P, K, M], **kw}
        for label, (lib, _) in libs.items():
            path, calls[label] = caller(lib, z, cb, n_groups, n_slices, bits,
                                        by_shape[label])
            row[label] = {"path": path, "codes_differ": check(
                label, calls[label], z, cb, kw)}
        order = list(calls) + list(calls)[::-1]
        ms = chip_smoke.cuda_ms_turns([calls[k] for k in order], reps=50)
        for label in calls:
            row[label]["ms"] = [t for k, t in zip(order, ms) if k == label]
            row[label]["device_ms"], row[label]["device_ms_by_kernel"] = \
                device_split(calls[label])
        row["plain_ms"] = chip_smoke.cuda_ms(
            lambda: ref.encode_codes_ref(z, cb, **kw), reps=5)
        row.update(zip(("bound_ms", "bound_by", "tail_bound_ms"),
                       chip_smoke.encode_bounds(R, P, K, M, n_groups,
                                                n_slices, bits)))
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps({"card": smi, "turns": rows,
                      "ptxas": {k: u for k, (_, u) in libs.items()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
