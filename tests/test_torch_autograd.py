"""Port parity: the gradients of the LM kernels' autograd Functions against
``jax.vjp`` of the JAX package's ``repro.kernels.ref`` functions.

On the card ``ops.rmsnorm``, ``ops.flash_attention`` and
``ops.selective_scan`` run the CUDA kernel forward inside a
``torch.autograd.Function`` whose backward recomputes the plain version.
Here the kernel each Function launches is swapped for a stand-in that
returns the plain result computed under ``torch.no_grad()``, with no
``grad_fn``, as the kernel's output has none; so every gradient below comes
from the Function's backward alone. Inputs and output gradients are drawn
with numpy from a seed and handed to both packages.

Tolerances: rmsnorm ``1e-5*(1 + |g|)`` per element; flash attention 2e-5
absolute (softmax sums in another order); the scan ``1e-5*(1 + m)``, m the
magnitude of the terms summed into each gradient element (the same
gradient taken on the absolute values of every input and output gradient),
the scan rule of ``PERF.md`` section 2.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

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
    """Each kernel symbol the Functions call, replaced by its plain version
    under no_grad; the launches are counted."""
    calls = {"rmsnorm": 0, "flash_attention": 0, "selective_scan": 0}

    def plain(name, fn):
        def kernel(*args, **kw):
            calls[name] += 1
            with torch.no_grad():
                out = fn(*args, **kw)
            assert all(t.grad_fn is None for t in
                       (out if isinstance(out, tuple) else (out,)))
            return out
        return kernel

    monkeypatch.setattr(ops, "rmsnorm_cuda", plain(
        "rmsnorm", lambda x, s, *, eps: ref.rmsnorm_ref(x, s, eps)))
    monkeypatch.setattr(ops, "flash_attention_cuda", plain(
        "flash_attention", ref.flash_attention_ref))
    monkeypatch.setattr(ops, "selective_scan_cuda", plain(
        "selective_scan", ref.selective_scan_ref))
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
    out = ops._RMSNorm.apply(tx, ts, 1e-6)
    out.backward(torch.from_numpy(g))
    assert stand_ins["rmsnorm"] == 1
    _, vjp = jax.vjp(lambda a, b: jref.rmsnorm_ref(a, b, 1e-6),
                     jnp.asarray(x), jnp.asarray(scale))
    for name, got, want in zip(("x", "scale"), (tx.grad, ts.grad),
                               vjp(jnp.asarray(g))):
        want = np.asarray(want)
        over = np.abs(got.numpy() - want) / (RMS_RTOL * (1 + np.abs(want)))
        assert np.all(over <= 1), f"d{name}: {float(over.max())}x"


# -------------------------------------------------------- flash attention

@pytest.mark.parametrize("causal,window", [(True, 0), (True, 7),
                                           (False, 0)])
def test_flash_function_gradients_match_reference(stand_ins, causal, window):
    """GQA 2:1: the plain version reads KV head h // 2, so the gradient of
    each KV head is the sum over its two query heads, as ``jnp.repeat``
    of k and v gives it in the reference."""
    rng = np.random.default_rng(int(causal) * 10 + window)
    B, T, Hq, Hkv, D = 2, 19, 4, 2, 64
    q, k, v = (_f32(rng, B, T, H, D) for H in (Hq, Hkv, Hkv))
    g = _f32(rng, B, T, Hq, D)
    tq, tk, tv = _leaves(q, k, v)
    out = ops._FlashAttention.apply(tq, tk, tv, causal, window)
    out.backward(torch.from_numpy(g))
    assert stand_ins["flash_attention"] == 1

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
    y, h = ops._SelectiveScan.apply(*leaves)
    loss = 0
    if through != "h_last":
        loss = loss + (y * torch.from_numpy(gy)).sum()
    if through != "y":
        loss = loss + (h * torch.from_numpy(gh)).sum()
    loss.backward()
    assert stand_ins["selective_scan"] == 1
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


FUNCTIONS = {"rmsnorm": "_RMSNorm", "flash_attention": "_FlashAttention",
             "selective_scan": "_SelectiveScan"}


@pytest.mark.parametrize("name", sorted(FUNCTIONS))
def test_dispatcher_builds_no_graph_under_no_grad(stand_ins, monkeypatch,
                                                  name):
    """On the card, under ``torch.no_grad()`` (serving), ``ops`` calls the
    kernel directly even for inputs that require grad: no Function, no
    graph. With grad mode on, the Function carries the gradient."""
    monkeypatch.setattr(ops, "_on_card", lambda t: True)
    args, kw = _dispatch_args(name)
    real = getattr(ops, FUNCTIONS[name])

    class Refused(real):
        @staticmethod
        def forward(ctx, *a):
            raise AssertionError("a Function was built under no_grad")

    monkeypatch.setattr(ops, FUNCTIONS[name], Refused)
    with torch.no_grad():
        out = getattr(ops, name)(*args, **kw)
    outs = out if isinstance(out, tuple) else (out,)
    assert all(t.grad_fn is None and not t.requires_grad for t in outs)
    assert stand_ins[name] == 1

    monkeypatch.setattr(ops, FUNCTIONS[name], real)
    out = getattr(ops, name)(*args, **kw)
    outs = out if isinstance(out, tuple) else (out,)
    assert stand_ins[name] == 2
    assert all(type(t.grad_fn).__name__ == FUNCTIONS[name] + "Backward"
               for t in outs)
    sum(t.sum() for t in outs).backward()
    assert all(a.grad is not None and bool(a.grad.abs().sum() > 0)
               for a in args)
