"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

All sources under ``kernels/csrc`` go into one shared library with a
plain C interface. Each ``.cu`` is compiled by its own ``nvcc`` process,
all started together, and the objects are linked into
``build/repro_torch_kernels/librepro_torch_kernels_<hash>.so`` at the
repository root. The hash covers the sources and the flags, so an edit
rebuilds and an unchanged tree reuses the library. Nothing is built when
the module is imported: :func:`library` builds at the first launch.

Every C entry takes its pointers and the CUDA stream as ``void*`` and
returns ``cudaGetLastError()``; :func:`check` raises when that is not 0.
Each launch adds one to its kernel's count in :data:`LAUNCHES`.

The launch path is lean because at a decode step's shapes it is most of a
call: :func:`stream_of` reads the raw stream handle without building a
``torch.cuda.Stream``, and the C entries share ``csrc/launch.cuh``, which
sets the device only when it is not current and does once-per-device setup
once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: launches of each hand-written kernel since the last :func:`reset_launches`
LAUNCHES = {"pack_codes": 0, "unpack_codes": 0, "encode_codes": 0,
            "decode_codes": 0, "vq_nearest": 0, "rmsnorm": 0,
            "flash_attention": 0, "selective_scan": 0,
            "flash_attention_bwd": 0, "rmsnorm_bwd": 0,
            "selective_scan_bwd": 0}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    # words/codes pointers, sizes, bits, device, stream
    "rt_pack_codes": (_P, _L, _P, _L, _I, _I, _P),
    "rt_unpack_codes": (_P, _L, _P, _L, _I, _I, _P),
    "rt_encode_codes": (_P, _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                        _I, _P),
    # z, codebooks, words, counts, sums, pcounts, psums, R, P, K, M, bits,
    # blocks a record, device, stream
    "rt_encode_codes_resident": (_P, _P, _P, _P, _P, _P, _P,
                                 _I, _I, _I, _I, _I, _I, _I, _P),
    # z, codebooks, words, counts, sums, pcounts, psums, R, P, K, M,
    # n_slices, n_groups, bits, blocks a record, device, stream
    "rt_encode_codes_gsvq": (_P, _P, _P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "rt_decode_codes": (_P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _P),
    # z, codebook, out, N, K, M, device, stream
    "rt_vq_nearest": (_P, _P, _P, _L, _I, _I, _I, _P),
    # x, scale, out, rows, d, eps, device, stream
    "rt_rmsnorm": (_P, _P, _P, _L, _I, _F, _I, _P),
    # x, scale, g, dx, partials, dscale, rows, d, partial rows, eps,
    # device, stream
    "rt_rmsnorm_bwd": (_P, _P, _P, _P, _P, _P, _L, _I, _I, _F, _I, _P),
    # q, k, v, out, lse (or null), B, Tq, Tk, Hq, Hkv, D, causal, window,
    # scale, device, stream
    "rt_flash_attention": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                           _I, _F, _I, _P),
    # q, k, v, o, lse, do, scratch, scratch floats, dq, dk, dv, B, Tq, Tk,
    # Hq, Hkv, D, causal, window, scale, qbegin, qend, device, stream
    "rt_flash_attention_bwd": (_P, _P, _P, _P, _P, _P, _P, _L, _P, _P, _P,
                               _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I,
                               _I, _P),
    # decay, inp, c, h0, y, h_last, B, T, di, N, device, stream
    "rt_selective_scan": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # decay, inp, c, h0, gy, gh, d_decay, d_inp, dc, dh0, checkpoints,
    # partials, B, T, di, N, device, stream
    "rt_selective_scan_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                              _P, _I, _I, _I, _I, _I, _P),
    # the LM kernels' entries with dtype codes (float32 or bfloat16): the
    # float32 entry's arguments and, before the device, rmsnorm's mask (1 x,
    # 2 scale), flash's bf16 flag, the scan's mask (1 decay, 2 inp, 4 c,
    # 8 h0); the flash backward also takes the float32 accumulators dk32,
    # dv32 after dv
    "rt_rmsnorm_dt": (_P, _P, _P, _L, _I, _F, _I, _I, _P),
    "rt_rmsnorm_bwd_dt": (_P, _P, _P, _P, _P, _P, _L, _I, _I, _F, _I, _I,
                          _P),
    "rt_flash_attention_dt": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                              _I, _I, _F, _I, _I, _P),
    "rt_flash_attention_bwd_dt": (_P, _P, _P, _P, _P, _P, _P, _L, _P, _P,
                                  _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                  _I, _F, _I, _I, _I, _I, _P),
    "rt_selective_scan_dt": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                             _P),
    "rt_selective_scan_bwd_dt": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                 _P, _I, _I, _I, _I, _I, _I, _P),
}

_lib = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc on the machine with the GPU")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"librepro_torch_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile every ``.cu`` in parallel and link them; returns the .so."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in (p for p in _sources() if p.suffix == ".cu"):
            obj = Path(tmp) / (src.stem + ".o")
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for src, _, proc in procs:
            log, _ = proc.communicate()
            logs.append(f"== {src.name}\n{log}")
            if proc.returncode:
                failed.append(src.name)
        (BUILD_DIR / "build.log").write_text("\n".join(logs))
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        so = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(so),
             *(str(obj) for _, obj, _ in procs)],
            capture_output=True, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(so, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(args)
            fn.restype = ctypes.c_int
        lib.rt_error_string.argtypes = [ctypes.c_int]
        lib.rt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, kernel: str) -> None:
    """Raise if a C entry reported a CUDA error; else count the launch."""
    if err:
        msg = library().rt_error_string(err).decode()
        raise RuntimeError(f"{kernel} kernel failed to launch: {msg} ({err})")
    LAUNCHES[kernel] += 1


def stream_of(t) -> int:
    """Raw handle of PyTorch's current stream on ``t``'s device, read
    without building a ``torch.cuda.Stream`` object (the call Triton's
    launcher makes)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())
