"""Public kernel entry points: the CUDA kernel for a tensor on the card,
the plain PyTorch version for a tensor on the CPU.

Port of ``repro.kernels.ops`` for the kernels of the port. The choice follows
only from where the tensor lies: a CUDA tensor launches the hand-written
kernel (or raises), a CPU tensor runs the plain version in
:mod:`repro_torch.kernels.ref`. Nothing falls back from one to the other.

:data:`LAUNCHES` counts the CUDA launches of each kernel; the plain
versions never touch it.

Gradients. The CUDA kernels write their outputs through ``ctypes``, so
autograd cannot see into them. ``rmsnorm``, ``flash_attention`` and
``selective_scan`` therefore go through a ``torch.autograd.Function``
whenever a graph is being built (grad mode on and an input that requires
grad); under ``torch.no_grad()`` (serving) the kernels are called directly
and no graph is built. A CPU tensor runs the plain version, which autograd
differentiates itself. The reference has no backward kernel: XLA
differentiates plain ``jnp``. On the card each backward is a hand-written
kernel too (``csrc/rmsnorm_bwd.cu``, ``csrc/flash_attention_bwd.cu``,
``csrc/selective_scan_bwd.cu``), counted in :data:`LAUNCHES` as
``rmsnorm_bwd``, ``flash_attention_bwd`` and ``selective_scan_bwd``. The
flash forward saves its output and each row's log-sum-exp for its
backward, so the (B, H, Tq, Tk) scores are never materialised; the scan's
backward keeps a state every 16 steps and recomputes the rest, so the
scan's states are never all held.

On a device mesh (DTensor inputs, :mod:`repro_torch.distributed`) the three
LM kernels are reached through ``local_map`` (:mod:`._mesh`): inputs are
redistributed, where they must be, to placements under which each rank's
shard is a problem of its own, and each rank calls the same entry point on
its local tensors, so a launch is counted once on each rank.
"""
from __future__ import annotations

import torch

from repro_torch.hints import is_dtensor

from . import ref
from ._build import LAUNCHES, reset_launches  # noqa: F401  (re-exported)
from .decode_codes import decode_codes_cuda
from .encode_codes import encode_codes_cuda
from .flash_attention import flash_attention_bwd_cuda, flash_attention_cuda
from .pack_bits import pack_codes_cuda, unpack_codes_cuda
from .rmsnorm import rmsnorm_bwd_cuda, rmsnorm_cuda
from .selective_scan import (check_scan_args, selective_scan_bwd_cuda,
                             selective_scan_cuda)
from .vq_nn import vq_nearest_cuda


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"the port's kernels run on cuda or cpu tensors, got "
                     f"{t.device}")


def _builds_graph(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class _RMSNorm(torch.autograd.Function):
    """The rmsnorm kernel forward, the rmsnorm_bwd kernel back."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rmsnorm_cuda(x, scale, eps=eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd_cuda(x, scale, g.contiguous(), eps=ctx.eps)
        return dx, dscale, None


class _FlashAttention(torch.autograd.Function):
    """The flash kernel forward (with each row's log-sum-exp), the
    flash_attention_bwd kernel back; it sums each group's gradient into
    its KV head."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = flash_attention_cuda(q, k, v, causal=causal,
                                        window=window, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        return flash_attention_bwd_cuda(
            q, k, v, out, lse, g.contiguous(), causal=ctx.causal,
            window=ctx.window) + (None, None)


class _SelectiveScan(torch.autograd.Function):
    """The scan kernel forward, the selective_scan_bwd kernel back, through
    y, h_last or both (autograd hands zeros for an output with none)."""

    @staticmethod
    def forward(ctx, decay, inp, c, h0):
        ctx.save_for_backward(decay, inp, c, h0)
        return selective_scan_cuda(decay, inp, c, h0)

    @staticmethod
    def backward(ctx, gy, gh):
        grads = selective_scan_bwd_cuda(*ctx.saved_tensors, gy.contiguous(),
                                        gh.contiguous())
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))


def vq_nearest(z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """(N, M), (K, M) -> (N,) int32 nearest codebook atom per row."""
    if _on_card(z):
        return vq_nearest_cuda(z.float().contiguous(),
                               codebook.float().contiguous())
    return ref.vq_nearest_ref(z, codebook)


def pack_codes(codes: torch.Tensor, *, bits: int) -> torch.Tensor:
    """Any-shape int codes -> (n_groups, W) int32 dense bit-stream at
    ``bits`` bits per code (kernels/pack_bits.py layout)."""
    if _on_card(codes):
        return pack_codes_cuda(codes.to(torch.int32).contiguous(), bits=bits)
    return ref.pack_codes_ref(codes, bits=bits)


def unpack_codes(words: torch.Tensor, *, bits: int,
                 count: int) -> torch.Tensor:
    """(n_groups, W) int32 words -> (count,) int32 codes, bit-exact."""
    if _on_card(words):
        return unpack_codes_cuda(words.contiguous(), bits=bits, count=count)
    return ref.unpack_codes_ref(words, bits=bits, count=count)


def decode_codes(words: torch.Tensor, table: torch.Tensor, *, bits: int,
                 count: int, n_slices: int = 1, phases=None) -> torch.Tensor:
    """Fused packed-word -> feature decode: (n, W) words + a
    (n_slices*rows, F) decode table -> (count, F) rows."""
    if _on_card(words):
        if phases is not None:
            phases = torch.as_tensor(phases, device=words.device) \
                .to(torch.int32).contiguous()
        return decode_codes_cuda(words.contiguous(),
                                 table.float().contiguous(), bits=bits,
                                 count=count, n_slices=n_slices,
                                 phases=phases)
    return ref.decode_codes_ref(words, table, bits=bits, count=count,
                                n_slices=n_slices, phases=phases)


def encode_codes(z: torch.Tensor, codebooks: torch.Tensor, *, bits: int,
                 n_groups: int = 1, n_slices: int = 1):
    """Fused latent -> packed-code encode with the EMA statistics:
    (R, P, M) latents + (R, K, M) per-record codebooks -> (words
    (R*nW, W) int32, counts (R, K), sums (R, K, M)) in one dispatch."""
    if _on_card(z):
        return encode_codes_cuda(z.float().contiguous(),
                                 codebooks.float().contiguous(), bits=bits,
                                 n_groups=n_groups, n_slices=n_slices)
    return ref.encode_codes_ref(z, codebooks, bits=bits, n_groups=n_groups,
                                n_slices=n_slices)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """(..., d) rows, (d,) scale -> ``x * rsqrt(mean(x^2) + eps) * scale``
    (float32 on the card). A DTensor goes through :mod:`._mesh`: each
    rank normalises its own rows."""
    if is_dtensor(x):
        from ._mesh import rmsnorm_mesh
        return rmsnorm_mesh(rmsnorm, x, scale, eps)
    if _on_card(x):
        # the kernel reads whole rows: float32 views are copied to
        # contiguous ones (other dtypes are refused, not copied first)
        if x.dtype == torch.float32 and not x.is_contiguous():
            x = x.contiguous()
        if scale.dtype == torch.float32 and not scale.is_contiguous():
            scale = scale.contiguous()
        if _builds_graph(x, scale):
            return _RMSNorm.apply(x, scale, eps)
        return rmsnorm_cuda(x, scale, eps=eps)
    return ref.rmsnorm_ref(x, scale, eps)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """(B, T, Hq, D) queries with GQA keys/values (B, T, Hkv, D) ->
    (B, T, Hq, D). The kernel reads KV head ``h // (Hq // Hkv)`` itself,
    so nothing is repeated (the reference's ``ops`` repeats k and v). A
    DTensor goes through :mod:`._mesh`: each rank attends its own (batch,
    head) shard."""
    if is_dtensor(q):
        from ._mesh import flash_attention_mesh
        return flash_attention_mesh(flash_attention, q, k, v, causal=causal,
                                    window=window)
    if _on_card(q):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if _builds_graph(q, k, v):
            return _FlashAttention.apply(q, k, v, causal, window)
        return flash_attention_cuda(q, k, v, causal=causal, window=window)
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window)


def selective_scan(decay: torch.Tensor, inp: torch.Tensor, c: torch.Tensor,
                   h0: torch.Tensor):
    """Mamba recurrence and output: decay, inp (B, T, di, N), c (B, T, N),
    h0 (B, di, N), float32 and contiguous -> (y (B, T, di), h_last
    (B, di, N)), ``h_t = decay_t * h_{t-1} + inp_t``, ``y_t = <h_t, c_t>``.
    Anything else raises, on the card and on the CPU alike. A DTensor
    goes through :mod:`._mesh`: each rank scans its own (batch, channel)
    shard."""
    if is_dtensor(decay):
        from ._mesh import selective_scan_mesh
        return selective_scan_mesh(selective_scan, decay, inp, c, h0)
    if _on_card(decay):
        if _builds_graph(decay, inp, c, h0):
            return _SelectiveScan.apply(decay, inp, c, h0)
        return selective_scan_cuda(decay, inp, c, h0)
    check_scan_args(decay, inp, c, h0)
    return ref.selective_scan_ref(decay, inp, c, h0)
