"""Public kernel entry points: the CUDA kernel for a tensor on the card,
the plain PyTorch version for a tensor on the CPU.

Port of ``repro.kernels.ops`` for the kernels of the port. The choice follows
only from where the tensor lies: a CUDA tensor launches the hand-written
kernel (or raises), a CPU tensor runs the plain version in
:mod:`repro_torch.kernels.ref`. Nothing falls back from one to the other.

:data:`LAUNCHES` counts the CUDA launches of each kernel; the plain
versions never touch it.

The LM kernels are ``torch.library`` ops in the ``repro_torch`` namespace
(``torch.ops.repro_torch.*``, defined below): ``rmsnorm``,
``rmsnorm_bwd``, ``flash_attention`` (the output and each row's
log-sum-exp), ``flash_attention_bwd``, ``selective_scan`` and
``selective_scan_bwd``. :func:`rmsnorm`, :func:`flash_attention` and
:func:`selective_scan` call the op whatever the device, so every tensor
takes one path. Each op has

* one implementation for the CPU and CUDA dispatch keys (``_impl_*``): the
  kernel's wrapper on the card (``csrc/*.cu``), its plain version on the
  CPU;
* a fake rule (``_fake_*``) that applies the CUDA wrapper's refusals, with
  its messages (``check_*`` in :mod:`.rmsnorm`, :mod:`.flash_attention`
  and :mod:`.selective_scan`, called with ``cuda=False``), and gives the
  outputs' shapes: a run on fake tensors (``launch/dryrun.py``) refuses
  what the card would, and allocates nothing;
* an autograd rule (an ``Autograd`` kernel, ``_autograd``): the forward
  op's backward calls the backward op
  (``csrc/rmsnorm_bwd.cu``, ``csrc/flash_attention_bwd.cu``,
  ``csrc/selective_scan_bwd.cu`` on the card). The flash forward saves its
  output and each row's log-sum-exp, so the (B, H, Tq, Tk) scores are
  never materialised; the scan's backward keeps a state every 16 steps and
  recomputes the rest. The reference has no backward kernel: XLA
  differentiates plain ``jnp``;
* a FLOP formula for ``torch.utils.flop_counter``, the work the kernel
  does at the shapes it is given (:mod:`.costs`, which also holds each
  op's bytes; :data:`OP_BYTES` maps each op to them).

Under ``torch.no_grad()`` (serving) the entry points call the op below
autograd, so no graph is built and the Autograd kernel is not entered.

On a device mesh (DTensor inputs, :mod:`repro_torch.distributed`) the three
LM kernels are reached through ``local_map`` (:mod:`._mesh`): inputs are
redistributed, where they must be, to placements under which each rank's
shard is a problem of its own, and each rank calls the same entry point on
its local tensors, so a launch is counted once on each rank.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.hints import is_dtensor

from . import costs, ref
from ._dtypes import LM_DTYPES
from ._build import LAUNCHES, reset_launches  # noqa: F401  (re-exported)
from .decode_codes import decode_codes_cuda
from .encode_codes import encode_codes_cuda
from .flash_attention import (check_flash, check_flash_bwd,
                              flash_attention_bwd_cuda, flash_attention_cuda)
from .pack_bits import pack_codes_cuda, unpack_codes_cuda
from .rmsnorm import (check_rmsnorm, check_rmsnorm_bwd, rmsnorm_bwd_cuda,
                      rmsnorm_cuda)
from .selective_scan import (check_scan_args, check_scan_bwd_kernel,
                             check_scan_kernel, selective_scan_bwd_cuda,
                             selective_scan_cuda)
from .vq_nn import vq_nearest_cuda


def _on_card(t: torch.Tensor) -> bool:
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"the port's kernels run on cuda or cpu tensors, got "
                     f"{t.device}")


def _builds_graph(tensors) -> bool:
    """Grad mode on and a tensor input that requires grad: the one case in
    which an op's autograd rule records a node."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


# ------------------------------------------------------ the LM kernels' ops

_LIB = torch.library.Library("repro_torch", "DEF")
_LIB.define("rmsnorm(Tensor x, Tensor scale, float eps) -> Tensor")
_LIB.define("rmsnorm_bwd(Tensor x, Tensor scale, Tensor g, float eps) "
            "-> (Tensor, Tensor)")
_LIB.define("flash_attention(Tensor q, Tensor k, Tensor v, bool causal, "
            "int window) -> (Tensor, Tensor)")
_LIB.define("flash_attention_bwd(Tensor q, Tensor k, Tensor v, Tensor o, "
            "Tensor lse, Tensor dout, bool causal, int window) "
            "-> (Tensor, Tensor, Tensor)")
_LIB.define("selective_scan(Tensor decay, Tensor inp, Tensor c, Tensor h0) "
            "-> (Tensor, Tensor)")
_LIB.define("selective_scan_bwd(Tensor decay, Tensor inp, Tensor c, "
            "Tensor h0, Tensor gy, Tensor gh) "
            "-> (Tensor, Tensor, Tensor, Tensor)")
_OPS = torch.ops.repro_torch
_BELOW_AUTOGRAD = torch._C._AutoDispatchBelowAutograd


def _impl_rmsnorm(x, scale, eps):
    if _on_card(x):
        return rmsnorm_cuda(x, scale, eps=eps)
    return ref.rmsnorm_ref(x, scale, eps)


def _impl_rmsnorm_bwd(x, scale, g, eps):
    if _on_card(x):
        return rmsnorm_bwd_cuda(x, scale, g, eps=eps)
    return ref.rmsnorm_bwd_ref(x, scale, g, eps)


def _impl_flash_attention(q, k, v, causal, window):
    if _on_card(q):
        return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                    return_lse=True)
    # contiguous, as the kernel's outputs (and the fake rule's) are
    return tuple(t.contiguous() for t in ref.flash_attention_with_lse_ref(
        q, k, v, causal=causal, window=window))


def _impl_flash_attention_bwd(q, k, v, o, lse, dout, causal, window):
    if _on_card(q):
        return flash_attention_bwd_cuda(q, k, v, o, lse, dout, causal=causal,
                                        window=window)
    return tuple(t.contiguous() for t in ref.flash_attention_bwd_ref(
        q, k, v, o, lse, dout, causal=causal, window=window))


def _impl_selective_scan(decay, inp, c, h0):
    if _on_card(decay):
        return selective_scan_cuda(decay, inp, c, h0)
    check_scan_args(decay, inp, c, h0)
    return ref.selective_scan_ref(decay, inp, c, h0)


def _impl_selective_scan_bwd(decay, inp, c, h0, gy, gh):
    if _on_card(decay):
        return selective_scan_bwd_cuda(decay, inp, c, h0, gy, gh)
    return ref.selective_scan_bwd_ref(decay, inp, c, h0, gy, gh)


def _fake_rmsnorm(x, scale, eps):
    check_rmsnorm(x, scale, cuda=False)
    return torch.empty_like(x)


def _fake_rmsnorm_bwd(x, scale, g, eps):
    check_rmsnorm_bwd(x, scale, g, cuda=False)
    return torch.empty_like(x), torch.empty_like(scale)


def _fake_flash_attention(q, k, v, causal, window):
    check_flash(q, k, v, window, cuda=False)
    B, Tq, Hq, _ = q.shape
    return torch.empty_like(q), q.new_empty((B, Hq, Tq), dtype=torch.float32)


def _fake_flash_attention_bwd(q, k, v, o, lse, dout, causal, window):
    check_flash_bwd(q, k, v, o, lse, dout, window, cuda=False)
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _fake_selective_scan(decay, inp, c, h0):
    check_scan_kernel(decay, inp, c, h0, cuda=False)
    return (decay.new_empty(decay.shape[:3], dtype=torch.float32),
            torch.empty_like(h0, dtype=torch.float32))


def _fake_selective_scan_bwd(decay, inp, c, h0, gy, gh):
    check_scan_bwd_kernel(decay, inp, c, h0, gy, gh, cuda=False)
    return (torch.empty_like(decay), torch.empty_like(inp),
            torch.empty_like(c), torch.empty_like(h0))


class _RMSNormGrad(torch.autograd.Function):
    """The rmsnorm op below autograd forward, the rmsnorm_bwd op back."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        with _BELOW_AUTOGRAD():
            return _OPS.rmsnorm.default(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, dscale = _OPS.rmsnorm_bwd.default(x, scale, g.contiguous(),
                                              ctx.eps)
        return dx, dscale, None


class _FlashAttentionGrad(torch.autograd.Function):
    """The flash op below autograd forward (its output and each row's
    log-sum-exp, which takes no gradient), the flash_attention_bwd op back:
    each group's gradient summed into its KV head."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        with _BELOW_AUTOGRAD():
            out, lse = _OPS.flash_attention.default(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g, _g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        return (*_OPS.flash_attention_bwd.default(
            q, k, v, out, lse, g.contiguous(), ctx.causal, ctx.window),
            None, None)


class _SelectiveScanGrad(torch.autograd.Function):
    """The scan op below autograd forward, the selective_scan_bwd op back,
    through y, h_last or both (autograd hands zeros for an output with
    none)."""

    @staticmethod
    def forward(ctx, decay, inp, c, h0):
        ctx.save_for_backward(decay, inp, c, h0)
        with _BELOW_AUTOGRAD():
            return tuple(_OPS.selective_scan.default(decay, inp, c, h0))

    @staticmethod
    def backward(ctx, gy, gh):
        grads = _OPS.selective_scan_bwd.default(
            *ctx.saved_tensors, gy.contiguous(), gh.contiguous())
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))


def _autograd(name, fn, n_tensors):
    """The op's Autograd kernel: ``fn.apply`` where a graph is built (grad
    mode on and a tensor input that requires grad), else straight to the
    implementation below autograd -- the serving path, in as few host
    operations as the dispatcher allows."""
    op = getattr(_OPS, name).default

    def kernel(*args):
        if _builds_graph(args[:n_tensors]):
            return fn.apply(*args)
        with _BELOW_AUTOGRAD():
            return op(*args)

    return kernel


for _name in ("rmsnorm", "rmsnorm_bwd", "flash_attention",
              "flash_attention_bwd", "selective_scan", "selective_scan_bwd"):
    for _key in ("CPU", "CUDA"):
        _LIB.impl(_name, globals()[f"_impl_{_name}"], _key)
    torch.library.register_fake(f"repro_torch::{_name}",
                                globals()[f"_fake_{_name}"], lib=_LIB)
for _name, _fn, _n in (("rmsnorm", _RMSNormGrad, 2),
                       ("flash_attention", _FlashAttentionGrad, 3),
                       ("selective_scan", _SelectiveScanGrad, 4)):
    _LIB.impl(_name, _autograd(_name, _fn, _n), "Autograd")


@register_flop_formula(_OPS.rmsnorm)
def _flops_rmsnorm(x, scale, eps, *args, **kw):
    return costs.rmsnorm_flops(x)


@register_flop_formula(_OPS.rmsnorm_bwd)
def _flops_rmsnorm_bwd(x, scale, g, eps, *args, **kw):
    return costs.rmsnorm_bwd_flops(x)


@register_flop_formula(_OPS.flash_attention)
def _flops_flash_attention(q, k, v, causal, window, *args, **kw):
    return costs.flash_flops(q, k, v, causal, window)


@register_flop_formula(_OPS.flash_attention_bwd)
def _flops_flash_attention_bwd(q, k, v, o, lse, dout, causal, window, *args,
                               **kw):
    return costs.flash_bwd_flops(q, k, causal, window)


@register_flop_formula(_OPS.selective_scan)
def _flops_selective_scan(decay, *args, **kw):
    return costs.scan_flops(decay)


@register_flop_formula(_OPS.selective_scan_bwd)
def _flops_selective_scan_bwd(decay, *args, **kw):
    return costs.scan_bwd_flops(decay)


def _call(op, n_tensors, *args):
    """``op(*args)``; where no graph is built, entered below autograd
    (what its Autograd kernel would choose), which saves the dispatcher a
    Python crossing a call on the serving path."""
    if _builds_graph(args[:n_tensors]):
        return op(*args)
    with _BELOW_AUTOGRAD():
        return op(*args)


def _sizes(*tensors):
    return tuple(t.element_size() for t in tensors)


#: each op's bytes (inputs read and outputs written once, each at its
#: element size) from its tensor arguments, for the memory term of a
#: counted step
OP_BYTES = {
    _OPS.rmsnorm.default: lambda x, s, *a: costs.rmsnorm_bytes(
        x.shape, *_sizes(x, s)),
    _OPS.rmsnorm_bwd.default: lambda x, s, *a: costs.rmsnorm_bwd_bytes(
        x.shape, *_sizes(x, s)),
    _OPS.flash_attention.default: lambda q, k, v, *a: costs.flash_bytes(
        q.shape, k.shape, v.shape, q.element_size()),
    _OPS.flash_attention_bwd.default: lambda q, k, *a: costs.flash_bwd_bytes(
        q.shape, k.shape, q.element_size()),
    _OPS.selective_scan.default: lambda d, i, c, h, *a: costs.scan_bytes(
        d.shape, _sizes(d, i, c, h)),
    _OPS.selective_scan_bwd.default: lambda d, i, c, h, *a:
        costs.scan_bwd_bytes(d.shape, _sizes(d, i, c, h)),
}


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
    in x's type (float32 or bfloat16 each on the card, computed in
    float32). A DTensor goes through :mod:`._mesh`: each rank normalises
    its own rows."""
    if is_dtensor(x):
        from ._mesh import rmsnorm_mesh
        return rmsnorm_mesh(rmsnorm, x, scale, eps)
    # the kernel reads whole rows: views of the types it takes are copied
    # to contiguous ones (other dtypes are refused on the card, not copied
    # first)
    if x.dtype in LM_DTYPES and not x.is_contiguous():
        x = x.contiguous()
    if scale.dtype in LM_DTYPES and not scale.is_contiguous():
        scale = scale.contiguous()
    return _call(_OPS.rmsnorm.default, 2, x, scale, eps)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """(B, T, Hq, D) queries with GQA keys/values (B, T, Hkv, D), all
    float32 or all bfloat16 -> (B, T, Hq, D) in their type. The kernel
    reads KV head ``h // (Hq // Hkv)`` itself,
    so nothing is repeated (the reference's ``ops`` repeats k and v). A
    DTensor goes through :mod:`._mesh`: each rank attends its own (batch,
    head) shard."""
    if is_dtensor(q):
        from ._mesh import flash_attention_mesh
        return flash_attention_mesh(flash_attention, q, k, v, causal=causal,
                                    window=window)
    return _call(_OPS.flash_attention.default, 3, q.contiguous(),
                 k.contiguous(), v.contiguous(), bool(causal),
                 int(window))[0]


def selective_scan(decay: torch.Tensor, inp: torch.Tensor, c: torch.Tensor,
                   h0: torch.Tensor):
    """Mamba recurrence and output: decay, inp (B, T, di, N), c (B, T, N),
    h0 (B, di, N), each float32 or bfloat16, contiguous -> (y (B, T, di),
    h_last (B, di, N)) in float32, ``h_t = decay_t * h_{t-1} + inp_t``,
    ``y_t = <h_t, c_t>``.
    Anything else raises, on the card and on the CPU alike. A DTensor
    goes through :mod:`._mesh`: each rank scans its own (batch, channel)
    shard."""
    if is_dtensor(decay):
        from ._mesh import selective_scan_mesh
        return selective_scan_mesh(selective_scan, decay, inp, c, h0)
    return tuple(_call(_OPS.selective_scan.default, 4, decay, inp, c, h0))
