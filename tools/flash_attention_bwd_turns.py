#!/usr/bin/env python3
"""Time the ``flash_attention_bwd`` CUDA kernels of several checkouts in
turns, on one NVIDIA GPU, beside PyTorch's FP32 SDPA backward.

    python3 tools/flash_attention_bwd_turns.py [--cases] [LABEL=DIR ...]

Each DIR is the root of a checkout of this repository (``this`` = the
checkout that holds this script, the default). Its
``src/repro_torch/kernels/csrc/flash_attention_bwd.cu`` is built alone by
nvcc into ``build/flash_bwd_turns/LABEL.so`` (plain C interface, loaded
with ctypes), all builds started together, so that several versions run
side by side in one process. At qwen3's
training shape (8, 1,024, 16/8, 128), the LM-on-codes backbone's (8, 64,
12/4, 64) and a long row's (1, 4,096, 16/8, 128), causal, each library's
dq, dk and dv are held against the plain backward
(``repro_torch.kernels.ref``) on the plain forward's o and lse, within
``chip_smoke.py``'s ``1e-5*(1 + m)``, and two calls must give the same
bits. Then the raw C calls of every library and ``torch.autograd.grad`` of
FP32 ``scaled_dot_product_attention`` are timed by CUDA events in turns
(first, ..., last, last, ..., first, in every trial), and each one's device
time is read from ``torch.profiler``, split by kernel name. A library whose
C entry takes a query-row range is called as this checkout's wrapper calls
it, over ``bwd_plan``'s batch slices and ranges, so at the long row it
launches its kernels over two ranges (with Tk = Tq where its entry takes
the two lengths apart); an older one is given one scratch with room for
every block. ``--cases`` also holds every library to the
plain version at all of ``chip_smoke.py``'s ``FLASH_CASES``. Prints the
card's name and power limit, one JSON line a shape and a last line with
ptxas' registers and spills; exits non-zero without a GPU or on a
disagreement.
"""
from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
import chip_smoke  # noqa: E402  (its timing helpers; it imports no torch)

BUILD = ROOT / "build" / "flash_bwd_turns"
SHAPES = ((chip_smoke.TRAIN_BATCH, chip_smoke.TRAIN_LEN, 16, 8, 128),
          (8, 64, 12, 4, 64), (1, 4096, 16, 8, 128))
PROFILE_REPS = 5
# the C entry before it took a query-row range: q, k, v, o, lse, do,
# scratch, dq, dk, dv, B, T, Hq, Hkv, D, causal, window, scale, device,
# stream
OLD_SIGNATURE = (*[ctypes.c_void_p] * 10, *[ctypes.c_int] * 7,
                 ctypes.c_float, ctypes.c_int, ctypes.c_void_p)
# the C entry with a query-row range before it took Tq and Tk apart: q, k,
# v, o, lse, do, scratch, scratch floats, dq, dk, dv, B, T, Hq, Hkv, D,
# causal, window, scale, qbegin, qend, device, stream
RANGED_SIGNATURE = (*[ctypes.c_void_p] * 7, ctypes.c_longlong,
                    *[ctypes.c_void_p] * 3, *[ctypes.c_int] * 7,
                    ctypes.c_float, *[ctypes.c_int] * 3, ctypes.c_void_p)


def parse(argv):
    """(--cases given, {label: checkout root})."""
    trees = dict(a.split("=", 1) for a in argv if a != "--cases")
    return "--cases" in argv, \
        {k: Path(v).resolve() for k, v in trees.items()} or {"this": ROOT}


def build_all(trees):
    """{label: (rt_flash_attention_bwd, [kernel, registers, spill bytes] of
    each kernel, its C entry's kind: "old" with no query-row range,
    "ranged" with one, "unequal" with a range and Tq and Tk apart)}; one
    nvcc a library, all at once."""
    from repro_torch.kernels import _build
    BUILD.mkdir(parents=True, exist_ok=True)
    procs, ranged = {}, {}
    for label, tree in trees.items():
        src = (tree / "src" / "repro_torch" / "kernels" / "csrc"
               / "flash_attention_bwd.cu")
        text = src.read_text()
        ranged[label] = ("unequal" if "int Tk," in text else "ranged"
                         if "long long scratch_floats" in text else "old")
        procs[label] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", str(src), "-o",
             str(BUILD / f"{label}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out = {}
    for label, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {label}:\n{log}")
        fn = ctypes.CDLL(str(BUILD / f"{label}.so")).rt_flash_attention_bwd
        fn.argtypes = list({
            "unequal": _build._SIGNATURES["rt_flash_attention_bwd"],
            "ranged": RANGED_SIGNATURE,
            "old": OLD_SIGNATURE}[ranged[label]])
        fn.restype = ctypes.c_int             # as _build.library() binds it
        out[label] = (fn, chip_smoke.ptxas_usage(log), ranged[label])
    return out


def caller(lib, q, k, v, o, lse, do, causal=True, window=0):
    """A call of one library's C entry into fresh (dq, dk, dv)."""
    import torch
    from repro_torch.kernels.flash_attention import bwd_plan
    fn, _, kind = lib
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    stream = torch.cuda.current_stream().cuda_stream
    scale, dev = 1.0 / math.sqrt(D), q.get_device()
    lengths = (T, T) if kind == "unequal" else (T,)
    if kind != "old":
        bc, bounds, floats = bwd_plan(B, T, T, Hq, causal)
    else:        # delta, then dS in every 16 x 16 block
        n = -(-T // 16)
        bc, bounds = B, [(0, T)]
        floats = -(-B * Hq * T // 4) * 4 + B * Hq * n * n * 256
    scratch = lse.new_empty(floats)

    def call():
        out = [torch.empty_like(t) for t in (q, k, v)]
        for b0 in range(0, B, bc):
            m = min(bc, B - b0)
            at = [t.data_ptr() + b0 * (t.numel() // B) * 4
                  for t in (q, k, v, o, lse, do, *out)]
            for r0, r1 in bounds:
                err = fn(*at[:6], scratch.data_ptr(), floats, *at[6:], m,
                         *lengths, Hq, Hkv, D, int(causal), window, scale,
                         r0, r1, dev, stream) if kind != "old" else \
                    fn(*at[:6], scratch.data_ptr(), *at[6:], m, T, Hq, Hkv,
                       D, int(causal), window, scale, dev, stream)
                if err:
                    raise RuntimeError(
                        f"rt_flash_attention_bwd returned {err}")
        return tuple(out)
    return call


def inputs(dev, gen, B, T, Hq, Hkv, D, causal=True, window=0):
    """q, k, v, do from ``gen``, and the plain forward's o and lse, made
    contiguous as the kernel takes them."""
    import torch
    from repro_torch.kernels import ref
    q = torch.randn((B, T, Hq, D), generator=gen, device=dev)
    k = torch.randn((B, T, Hkv, D), generator=gen, device=dev)
    v = torch.randn((B, T, Hkv, D), generator=gen, device=dev)
    do = torch.randn((B, T, Hq, D), generator=gen, device=dev)
    o = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    lse = ref.flash_attention_lse_ref(q, k, v, causal=causal, window=window)
    return q, k, v, o.contiguous(), lse.contiguous(), do


def check(label, call, args, causal=True, window=0):
    """The largest error over 1e-5*(1 + m) of dq, dk and dv against the
    plain backward; two calls must give the same bits."""
    import torch
    from repro_torch.kernels import ref
    got, again = call(), call()
    torch.cuda.synchronize()
    shape = list(args[0].shape) + [args[1].shape[2], causal, window]
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{label} at {shape}: two calls differ")
    want = ref.flash_attention_bwd_ref(*args, causal=causal, window=window)
    mags = chip_smoke.flash_bwd_magnitudes(*args, causal, window)
    worst = [chip_smoke.over_tolerance((g - w).abs(), m)
             for g, w, m in zip(got, want, mags)]
    if not max(worst) <= 1:
        raise AssertionError(f"{label} at {shape}: dq, dk, dv {worst}x the "
                             f"tolerance")
    return worst


def sdpa_backward(q, k, v, do):
    """torch.autograd.grad of FP32 SDPA (causal, GQA) in its (B, H, T, D)
    layout, its graph made once: the yardstick, never the port's path."""
    import torch
    import torch.nn.functional as F
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    rep = q.shape[2] // k.shape[2]
    try:
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                             enable_gqa=True)
    except TypeError:                    # no enable_gqa in this torch
        out = F.scaled_dot_product_attention(
            qt, kt.repeat_interleave(rep, 1), vt.repeat_interleave(rep, 1),
            is_causal=True)
    dot = do.transpose(1, 2).contiguous()
    return lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                       retain_graph=True)


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("flash_attention_bwd_turns: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import resolve_device
    from repro_torch.kernels import ref
    dev = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    cases, trees = parse(argv)
    libs = build_all(trees)
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED + 5)
    if cases:
        worst = {label: 0.0 for label in libs}
        for B, T, Hq, Hkv, D, causal, window in chip_smoke.FLASH_CASES:
            args = inputs(dev, gen, B, T, Hq, Hkv, D, causal, window)
            for label, lib in libs.items():
                w = check(label, caller(lib, *args, causal, window), args,
                          causal, window)
                worst[label] = max(worst[label], max(w))
            del args
            torch.cuda.empty_cache()
        print(json.dumps({"cases": len(chip_smoke.FLASH_CASES),
                          "max_err_over_tolerance": worst}), flush=True)
    for B, T, Hq, Hkv, D in SHAPES:
        args = inputs(dev, gen, B, T, Hq, Hkv, D)
        row = {"shape": [B, T, Hq, Hkv, D, "causal"]}
        calls = {}
        for label, lib in libs.items():
            calls[label] = caller(lib, *args)
            row[label] = {"max_err_over_tolerance_dq_dk_dv":
                          check(label, calls[label], args)}
        calls["sdpa_backward"] = sdpa_backward(args[0], args[1], args[2],
                                               args[5])
        order = list(calls) + list(calls)[::-1]
        ms = chip_smoke.cuda_ms_turns([calls[k] for k in order], reps=10)
        for label in calls:
            dev_ms, by_kernel, _ = chip_smoke.device_ms(calls[label],
                                                        PROFILE_REPS)
            row.setdefault(label, {}).update(
                ms=[t for k, t in zip(order, ms) if k == label],
                device_ms=dev_ms, device_ms_by_kernel=by_kernel)
        row["plain_ms"] = chip_smoke.cuda_ms(
            lambda: ref.flash_attention_bwd_ref(*args), reps=3)
        pairs = B * Hq * T * (T + 1) // 2
        nbytes = (4 * B * T * Hq * D + 4 * B * T * Hkv * D + B * Hq * T) * 4
        row["bound_ms"], row["bound_by"] = chip_smoke.bound(
            nbytes, 3 * 5 * 2 * D * pairs, rate=chip_smoke.TF32_FLOP_PER_S,
            ops="tf32x3 operations")
        print(json.dumps(row), flush=True)
        del args, calls
        torch.cuda.empty_cache()
    print(json.dumps({"card": smi, "ptxas_registers_spills":
                      {k: u for k, (_, u, _) in libs.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
