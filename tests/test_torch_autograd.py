"""Port parity: the gradients of the LM kernels' ``torch.library`` ops
against ``jax.vjp`` of the JAX package's ``repro.kernels.ref`` functions.

On the card ``ops.rmsnorm``, ``ops.flash_attention`` and
``ops.selective_scan`` call a ``repro_torch`` op whose CUDA implementation
is the kernel forward, and whose autograd rule calls the backward op, a
backward kernel on the card (``rmsnorm_bwd_cuda``,
``flash_attention_bwd_cuda``, ``selective_scan_bwd_cuda``). Here
``ops._on_card`` is patched and every kernel symbol an op calls, forward
and backward, is swapped for a stand-in that returns the plain result
computed under ``torch.no_grad()``, with no ``grad_fn``, as the kernel's
output has none; so every gradient below comes from the ops' autograd
rules alone, and the stand-ins count the calls. The
backward kernels' plain versions (``ref.rmsnorm_bwd_ref``,
``ref.flash_attention_bwd_ref``) are also held to ``jax.vjp`` directly, and
the backward wrappers' refusals are reached without a card through a CPU
tensor that reports ``cuda:0``, as is the flash backward's acceptance of
queries and keys of different lengths (its C entry a recording stand-in).
Inputs and output gradients are drawn with
numpy from a seed and handed to both packages.

Tolerances: rmsnorm ``1e-5*(1 + |g|)`` per element; flash attention 2e-5
absolute (softmax sums in another order); the scan ``1e-5*(1 + m)``, m the
magnitude of the terms summed into each gradient element (the same
gradient taken on the absolute values of every input and output gradient),
the scan rule of ``PERF.md`` section 2.
"""
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_bwd_cuda)
from repro_torch.kernels.rmsnorm import rmsnorm_bwd_cuda  # noqa: E402

RMS_RTOL = 1e-5
FLASH_ATOL = 2e-5
SCAN_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small CPU tensors run far faster on one thread than on many."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def stand_ins(monkeypatch):
    """Each kernel symbol the ops call, forward and backward, replaced by
    its plain version under no_grad, CPU tensors taken as on the card; the
    calls are counted."""
    calls = {"rmsnorm": 0, "flash_attention": 0, "selective_scan": 0,
             "rmsnorm_bwd": 0, "flash_attention_bwd": 0,
             "selective_scan_bwd": 0}

    def plain(name, fn):
        def kernel(*args, **kw):
            calls[name] += 1
            with torch.no_grad():
                out = fn(*args, **kw)
            assert all(t.grad_fn is None for t in
                       (out if isinstance(out, tuple) else (out,)))
            return out
        return kernel

    def flash(q, k, v, *, causal, window, return_lse=False):
        o = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        if not return_lse:
            return o
        return o, ref.flash_attention_lse_ref(q, k, v, causal=causal,
                                              window=window)

    monkeypatch.setattr(ops, "_on_card", lambda t: True)
    monkeypatch.setattr(ops, "rmsnorm_cuda", plain(
        "rmsnorm", lambda x, s, *, eps: ref.rmsnorm_ref(x, s, eps)))
    monkeypatch.setattr(ops, "flash_attention_cuda",
                        plain("flash_attention", flash))
    monkeypatch.setattr(ops, "selective_scan_cuda", plain(
        "selective_scan", ref.selective_scan_ref))
    monkeypatch.setattr(ops, "rmsnorm_bwd_cuda", plain(
        "rmsnorm_bwd", lambda x, s, g, *, eps: ref.rmsnorm_bwd_ref(
            x, s, g, eps)))
    monkeypatch.setattr(ops, "flash_attention_bwd_cuda", plain(
        "flash_attention_bwd", ref.flash_attention_bwd_ref))
    monkeypatch.setattr(ops, "selective_scan_bwd_cuda", plain(
        "selective_scan_bwd", ref.selective_scan_bwd_ref))
    return calls


def _leaves(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(True)
            for a in arrays]


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------- rmsnorm

@pytest.mark.parametrize("shape", [(5, 64), (2, 3, 130), (1, 1024)])
def test_rmsnorm_function_gradients_match_reference(stand_ins, shape):
    rng = np.random.default_rng(sum(shape))
    x, scale, g = _f32(rng, *shape), _f32(rng, shape[-1]), _f32(rng, *shape)
    tx, ts = _leaves(x, scale)
    out = ops.rmsnorm(tx, ts, eps=1e-6)
    out.backward(torch.from_numpy(g))
    assert stand_ins["rmsnorm"] == 1 and stand_ins["rmsnorm_bwd"] == 1
    _, vjp = jax.vjp(lambda a, b: jref.rmsnorm_ref(a, b, 1e-6),
                     jnp.asarray(x), jnp.asarray(scale))
    for name, got, want in zip(("x", "scale"), (tx.grad, ts.grad),
                               vjp(jnp.asarray(g))):
        want = np.asarray(want)
        over = np.abs(got.numpy() - want) / (RMS_RTOL * (1 + np.abs(want)))
        assert np.all(over <= 1), f"d{name}: {float(over.max())}x"


# -------------------------------------------------------- flash attention

# (causal, window, Tq, Tk) at queries and keys of two lengths (whisper's
# cross-attention is the non-causal case); every row sees a key
FLASH_UNEQUAL = [(False, 0, 7, 30), (False, 0, 30, 7), (True, 0, 12, 25),
                 (True, 0, 25, 12), (True, 5, 12, 25), (False, 6, 12, 9)]


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 7),
                                           (False, 0)])
def test_flash_function_gradients_match_reference(stand_ins, causal, window):
    """GQA 2:1: the plain version reads KV head h // 2, so the gradient of
    each KV head is the sum over its two query heads, as ``jnp.repeat``
    of k and v gives it in the reference."""
    _flash_function_case(stand_ins, causal, window, 19, 19,
                         int(causal) * 10 + window)


@pytest.mark.parametrize("causal,window,Tq,Tk", FLASH_UNEQUAL)
def test_flash_function_gradients_at_unequal_lengths(stand_ins, causal,
                                                     window, Tq, Tk):
    """The same at Tq queries over Tk keys."""
    _flash_function_case(stand_ins, causal, window, Tq, Tk,
                         int(causal) * 10 + window + Tq + 2 * Tk)


def _flash_function_case(stand_ins, causal, window, Tq, Tk, seed):
    rng = np.random.default_rng(seed)
    B, Hq, Hkv, D = 2, 4, 2, 64
    q, k, v = (_f32(rng, B, L, H, D) for L, H in ((Tq, Hq), (Tk, Hkv),
                                                  (Tk, Hkv)))
    g = _f32(rng, B, Tq, Hq, D)
    tq, tk, tv = _leaves(q, k, v)
    out = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    out.backward(torch.from_numpy(g))
    assert stand_ins["flash_attention"] == 1
    assert stand_ins["flash_attention_bwd"] == 1

    def f(a, b, c):
        rep = Hq // Hkv
        return jref.flash_attention_ref(
            a, jnp.repeat(b, rep, axis=2), jnp.repeat(c, rep, axis=2),
            causal=causal, window=window)

    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for name, got, want in zip("qkv", (tq.grad, tk.grad, tv.grad),
                               vjp(jnp.asarray(g))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=FLASH_ATOL, err_msg=f"d{name}")


# ------------------------------------------------------------------- scan

def _scan_inputs(rng, b, t, di, n):
    decay = 1 / (1 + np.exp(-rng.standard_normal((b, t, di, n))))
    return [a.astype(np.float32) for a in (
        decay, rng.standard_normal((b, t, di, n)),
        rng.standard_normal((b, t, n)), rng.standard_normal((b, di, n)))]


def _scan_grad_magnitudes(arrays, gy, gh):
    """The terms summed into each input gradient, in magnitude: the same
    gradient on |every input| and |every output gradient| (no term cancels
    another there)."""
    ins = _leaves(*(np.abs(a) for a in arrays))
    y, h = ref.selective_scan_ref(*ins)
    ((y * torch.from_numpy(np.abs(gy))).sum()
     + (h * torch.from_numpy(np.abs(gh))).sum()).backward()
    return [t.grad.numpy() for t in ins]


@pytest.mark.parametrize("through", ["y", "h_last", "both"])
@pytest.mark.parametrize("shape", [(2, 16, 8, 4), (1, 40, 24, 16)])
def test_scan_function_gradients_match_reference(stand_ins, shape, through):
    """Through y, through h_last, or both: an output that takes no part in
    the loss gets a zero gradient, in the Function and in the reference."""
    rng = np.random.default_rng(sum(shape) + len(through))
    arrays = _scan_inputs(rng, *shape)
    B, T, di, N = shape
    gy = _f32(rng, B, T, di) * (through != "h_last")
    gh = _f32(rng, B, di, N) * (through != "y")
    leaves = _leaves(*arrays)
    y, h = ops.selective_scan(*leaves)
    loss = 0
    if through != "h_last":
        loss = loss + (y * torch.from_numpy(gy)).sum()
    if through != "y":
        loss = loss + (h * torch.from_numpy(gh)).sum()
    loss.backward()
    assert stand_ins["selective_scan"] == 1
    assert stand_ins["selective_scan_bwd"] == 1
    _, vjp = jax.vjp(jref.selective_scan_ref,
                     *[jnp.asarray(a) for a in arrays])
    wants = vjp((jnp.asarray(gy), jnp.asarray(gh)))
    mags = _scan_grad_magnitudes(arrays, gy, gh)
    for name, t, want, m in zip(("decay", "inp", "c", "h0"), leaves, wants,
                                mags):
        err = np.abs(t.grad.numpy() - np.asarray(want))
        assert np.all(err <= SCAN_RTOL * (1 + m)), \
            f"d{name}: {float((err / (SCAN_RTOL * (1 + m))).max())}x"


# ------------------------------------------------------------- dispatcher

def _dispatch_args(name):
    rng = np.random.default_rng(5)
    if name == "rmsnorm":
        return _leaves(_f32(rng, 3, 32), _f32(rng, 32)), {}
    if name == "flash_attention":
        return _leaves(_f32(rng, 1, 8, 2, 64), _f32(rng, 1, 8, 1, 64),
                       _f32(rng, 1, 8, 1, 64)), {"causal": True}
    return _leaves(*_scan_inputs(rng, 1, 4, 6, 4)), {}


#: the autograd.Function behind each op's autograd rule
FUNCTIONS = {"rmsnorm": "_RMSNormGrad",
             "flash_attention": "_FlashAttentionGrad",
             "selective_scan": "_SelectiveScanGrad"}


@pytest.mark.parametrize("name", sorted(FUNCTIONS))
def test_dispatcher_builds_no_graph_under_no_grad(stand_ins, monkeypatch,
                                                  name):
    """On the card, under ``torch.no_grad()`` (serving), the op passes its
    autograd rule through even for inputs that require grad: no Function,
    no graph, and the entry point enters the op below autograd, so its
    Autograd kernel is not called at all. With grad mode on, the op's autograd rule carries the
    gradient, its backward the backward op."""
    args, kw = _dispatch_args(name)
    function = getattr(ops, FUNCTIONS[name])
    forward = function.forward
    built = []

    def refused(ctx, *a):
        raise AssertionError("a Function was built under no_grad")

    def counted(ctx, *a):
        built.append(name)
        return forward(ctx, *a)

    # the entry point's own bypass: the op is entered below autograd, so
    # its Autograd kernel's frame is not under the kernel's call
    autograd_kernel = ops._autograd(name, function, 0).__code__
    kernel = getattr(ops, f"{name}_cuda")

    def below_autograd(*a, **k):
        frame = sys._getframe()
        while frame is not None:
            assert frame.f_code is not autograd_kernel, \
                "the Autograd kernel was entered under no_grad"
            frame = frame.f_back
        return kernel(*a, **k)

    monkeypatch.setattr(ops, f"{name}_cuda", below_autograd)
    monkeypatch.setattr(function, "forward", staticmethod(refused))
    with torch.no_grad():
        out = getattr(ops, name)(*args, **kw)
    outs = out if isinstance(out, tuple) else (out,)
    assert all(t.grad_fn is None and not t.requires_grad for t in outs)
    assert stand_ins[name] == 1

    monkeypatch.setattr(ops, f"{name}_cuda", kernel)
    monkeypatch.setattr(function, "forward", staticmethod(counted))
    out = getattr(ops, name)(*args, **kw)
    outs = out if isinstance(out, tuple) else (out,)
    assert built == [name]
    assert stand_ins[name] == 2
    assert stand_ins[name + "_bwd"] == 0
    assert all(type(t.grad_fn).__name__ == FUNCTIONS[name] + "Backward"
               for t in outs)
    sum(t.sum() for t in outs).backward()
    assert all(a.grad is not None and bool(a.grad.abs().sum() > 0)
               for a in args)
    assert stand_ins[name + "_bwd"] == 1


# ------------------------------------------- the backward plain versions

@pytest.mark.parametrize("shape", [(5, 64), (2, 3, 130), (1, 1024)])
def test_rmsnorm_bwd_ref_matches_reference_vjp(shape):
    rng = np.random.default_rng(sum(shape) + 1)
    x, scale, g = _f32(rng, *shape), _f32(rng, shape[-1]), _f32(rng, *shape)
    got = ref.rmsnorm_bwd_ref(torch.from_numpy(x), torch.from_numpy(scale),
                              torch.from_numpy(g), 1e-6)
    _, vjp = jax.vjp(lambda a, b: jref.rmsnorm_ref(a, b, 1e-6),
                     jnp.asarray(x), jnp.asarray(scale))
    for name, t, want in zip(("x", "scale"), got, vjp(jnp.asarray(g))):
        want = np.asarray(want)
        assert t.shape == want.shape
        over = np.abs(t.numpy() - want) / (RMS_RTOL * (1 + np.abs(want)))
        assert np.all(over <= 1), f"d{name}: {float(over.max())}x"


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 7),
                                           (False, 0)])
def test_flash_bwd_ref_matches_reference_vjp(causal, window):
    """The backward's formula (P from lse, delta = <do, o>) on the plain
    forward's o and lse, GQA 2:1, against the reference's vjp."""
    _flash_bwd_ref_case(causal, window, 19, 19, int(causal) * 10 + window + 1)


@pytest.mark.parametrize("causal,window,Tq,Tk", FLASH_UNEQUAL)
def test_flash_bwd_ref_at_unequal_lengths_matches_reference_vjp(
        causal, window, Tq, Tk):
    """The same at Tq queries over Tk keys."""
    _flash_bwd_ref_case(causal, window, Tq, Tk,
                        int(causal) * 10 + window + Tq + 2 * Tk + 1)


def _flash_bwd_ref_case(causal, window, Tq, Tk, seed):
    rng = np.random.default_rng(seed)
    B, Hq, Hkv, D = 2, 4, 2, 64
    q, k, v = (_f32(rng, B, L, H, D) for L, H in ((Tq, Hq), (Tk, Hkv),
                                                  (Tk, Hkv)))
    g = _f32(rng, B, Tq, Hq, D)
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    o = ref.flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    lse = ref.flash_attention_lse_ref(tq, tk, tv, causal=causal,
                                      window=window)
    got = ref.flash_attention_bwd_ref(tq, tk, tv, o, lse, tg, causal=causal,
                                      window=window)

    def f(a, b, c):
        rep = Hq // Hkv
        return jref.flash_attention_ref(
            a, jnp.repeat(b, rep, axis=2), jnp.repeat(c, rep, axis=2),
            causal=causal, window=window)

    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for name, t, want in zip("qkv", got, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(t.numpy(), np.asarray(want), rtol=0,
                                   atol=FLASH_ATOL, err_msg=f"d{name}")


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5),
                                           (False, 3)])
def test_flash_lse_ref_is_the_masked_logsumexp(causal, window):
    """lse against a float64 numpy log-sum-exp over each row's seen keys,
    within 1e-5*(1 + |lse|)."""
    rng = np.random.default_rng(7 + window)
    B, T, Hq, Hkv, D = 1, 13, 4, 1, 64
    q, k, v = (_f32(rng, B, T, H, D) for H in (Hq, Hkv, Hkv))
    got = ref.flash_attention_lse_ref(*(torch.from_numpy(a) for a in
                                        (q, k, v)), causal=causal,
                                      window=window).numpy()
    s = np.einsum("bqhd,bkd->bhqk", q.astype(np.float64),
                  k[:, :, 0].astype(np.float64)) / np.sqrt(D)
    qpos, kpos = np.arange(T)[:, None], np.arange(T)[None, :]
    seen = np.ones((T, T), bool)
    if causal:
        seen &= kpos <= qpos
    if window:
        seen &= kpos > qpos - window
    top = np.where(seen, s, -np.inf).max(-1, keepdims=True)
    want = (top + np.log(np.where(seen, np.exp(s - top), 0).sum(
        -1, keepdims=True)))[..., 0]
    assert got.shape == (B, Hq, T)
    assert np.all(np.abs(got - want) <= 1e-5 * (1 + np.abs(want)))


# ------------------------------------------ the backward wrappers' refusals

class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself on cuda:0, to reach the wrappers'
    checks past the device test without a card."""

    @property
    def is_cuda(self):
        return True

    @property
    def device(self):
        return torch.device("cuda", 0)

    def get_device(self):
        return 0


def _card(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype).as_subclass(_OnCard)


def _flash_args(**over):
    """q, k, v, o, lse, do of a valid (1, 4, 2/1, 64) call, ``over``
    replacing some."""
    args = dict(q=_card(1, 4, 2, 64), k=_card(1, 4, 1, 64),
                v=_card(1, 4, 1, 64), o=_card(1, 4, 2, 64),
                lse=_card(1, 2, 4), do=_card(1, 4, 2, 64))
    args.update(over)
    return args


def _noncontiguous(*shape):
    """Every other float of a buffer twice as wide."""
    return torch.zeros(shape[:-1] + (2 * shape[-1],))[..., ::2] \
        .as_subclass(_OnCard)


BWD_REFUSALS = [
    ("flash_cpu", lambda: flash_attention_bwd_cuda(**_flash_args(
        q=torch.zeros(1, 4, 2, 64))),
     ValueError, "q must lie on a CUDA device, got cpu"),
    ("flash_dtype", lambda: flash_attention_bwd_cuda(**_flash_args(
        k=_card(1, 4, 1, 64, dtype=torch.float64))),
     TypeError, "k must be torch.float32, got torch.float64"),
    ("flash_contiguous", lambda: flash_attention_bwd_cuda(**_flash_args(
        do=_noncontiguous(1, 4, 2, 64))),
     ValueError, "do must be contiguous"),
    ("flash_head_dim", lambda: flash_attention_bwd_cuda(
        **{n: _card(*t.shape[:-1], 32) if n != "lse" else t
           for n, t in _flash_args().items()}),
     ValueError, "the kernel takes head dims (64, 96, 128, 192, 256), got "
     "32"),
    ("flash_o_shape", lambda: flash_attention_bwd_cuda(**_flash_args(
        o=_card(1, 5, 2, 64))),
     ValueError, "o and do must have q's shape (1, 4, 2, 64), got "
     "(1, 5, 2, 64) and (1, 4, 2, 64)"),
    ("flash_kv_batch", lambda: flash_attention_bwd_cuda(**_flash_args(
        k=_card(2, 5, 1, 64), v=_card(2, 5, 1, 64))),
     ValueError, "k and v must be (B, Tk, Hkv, D) beside q (1, 4, 2, 64), "
     "got (2, 5, 1, 64) and (2, 5, 1, 64)"),
    ("flash_kv_differ", lambda: flash_attention_bwd_cuda(**_flash_args(
        k=_card(1, 5, 1, 64), v=_card(1, 6, 1, 64))),
     ValueError, "k and v must be (B, Tk, Hkv, D) beside q (1, 4, 2, 64), "
     "got (1, 5, 1, 64) and (1, 6, 1, 64)"),
    ("flash_groups", lambda: flash_attention_bwd_cuda(**_flash_args(
        q=_card(1, 4, 3, 64), o=_card(1, 4, 3, 64), do=_card(1, 4, 3, 64),
        k=_card(1, 4, 2, 64), v=_card(1, 4, 2, 64), lse=_card(1, 3, 4))),
     ValueError, "3 query heads do not share 2 KV heads"),
    ("flash_lse_shape", lambda: flash_attention_bwd_cuda(**_flash_args(
        lse=_card(1, 4, 2))),
     ValueError, "lse must be (B, Hq, Tq) = (1, 2, 4), got (1, 4, 2)"),
    ("rms_cpu", lambda: rmsnorm_bwd_cuda(torch.zeros(3, 8), _card(8),
                                         _card(3, 8)),
     ValueError, "x must lie on a CUDA device, got cpu"),
    ("rms_dtype", lambda: rmsnorm_bwd_cuda(
        _card(3, 8), _card(8), _card(3, 8, dtype=torch.float64)),
     TypeError, "g must be torch.float32, got torch.float64"),
    ("rms_contiguous", lambda: rmsnorm_bwd_cuda(
        _noncontiguous(3, 8), _card(8), _card(3, 8)),
     ValueError, "x must be contiguous"),
    ("rms_g_shape", lambda: rmsnorm_bwd_cuda(_card(3, 8), _card(8),
                                             _card(3, 9)),
     ValueError, "x and g must be (..., d) and scale (d,), got (3, 8), "
     "(3, 9) and (8,)"),
    ("rms_scale_shape", lambda: rmsnorm_bwd_cuda(_card(3, 8), _card(9),
                                                 _card(3, 8)),
     ValueError, "x and g must be (..., d) and scale (d,), got (3, 8), "
     "(3, 8) and (9,)"),
]


@pytest.mark.parametrize("call,exc,message",
                         [c[1:] for c in BWD_REFUSALS],
                         ids=[c[0] for c in BWD_REFUSALS])
def test_bwd_wrappers_refuse_with_their_messages(call, exc, message):
    """The backward wrappers raise, before any build or launch, on what
    their kernels do not take."""
    with pytest.raises(exc) as err:
        call()
    assert str(err.value) == message


class _Library:
    """Records the flash backward C entry's arguments; reports success."""

    def __init__(self):
        self.calls = []

    def rt_flash_attention_bwd(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("B,Tq,Tk,causal", [
    (1, 4, 5, True),          # the call flash_kv_length refused before
    (2, 7, 100, False),       # cross-attention: few queries, many keys
    (3, 130, 9, True),        # more queries than keys
    (8, 1500, 1500, False)])  # whisper's encoder: two batch slices
def test_flash_bwd_wrapper_takes_unequal_lengths(monkeypatch, B, Tq, Tk,
                                                 causal):
    """Queries and keys of different lengths pass the checks: the C entry
    gets Tq and Tk apart, once a batch slice and query range of bwd_plan
    (Tq, Tk), with the plan's scratch, and each launch is counted."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import bwd_plan
    lib = _Library()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    Hq, Hkv, D = 8, (8 if Tq == Tk else 2), 64
    args = _flash_args(q=_card(B, Tq, Hq, D), k=_card(B, Tk, Hkv, D),
                       v=_card(B, Tk, Hkv, D), o=_card(B, Tq, Hq, D),
                       lse=_card(B, Hq, Tq), do=_card(B, Tq, Hq, D))
    before = _build.LAUNCHES["flash_attention_bwd"]
    dq, dk, dv = flash_attention_bwd_cuda(**args, causal=causal)
    assert (dq.shape, dk.shape, dv.shape) == (args["q"].shape,
                                              args["k"].shape,
                                              args["v"].shape)
    bc, bounds, floats = bwd_plan(B, Tq, Tk, Hq, causal)
    assert len(lib.calls) == -(-B // bc) * len(bounds)
    assert _build.LAUNCHES["flash_attention_bwd"] == before + len(lib.calls)
    for i, call in enumerate(lib.calls):
        assert call[7] == floats
        n = min(bc, B - i // len(bounds) * bc)
        assert call[11:17] == (n, Tq, Tk, Hq, Hkv, D)
        assert call[17] == int(causal) and call[18] == 0
        assert call[20:22] == bounds[i % len(bounds)]
