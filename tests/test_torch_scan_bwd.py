"""Port parity: the selective scan's backward (``csrc/selective_scan_bwd.cu``).

* ``ref.selective_scan_bwd_ref`` (the kernel's reverse-time recurrence as
  plain tensor ops) against ``jax.vjp`` of the reference's
  ``repro.nn.ssm._selective_scan_fused`` (the chunked scan its Mamba mixer
  differentiates) and of ``repro.kernels.ref.selective_scan_ref``, and
  against autograd of the port's ``selective_scan_ref``: through y, through
  h_last and through both;
* a CPU model of the kernel's algorithm -- a state kept every 16 steps, each
  chunk recomputed from it and run in reverse, dc summed a 256-thread block
  of channels at a time in channel order, then the blocks' partials in
  block order -- against the same, at T not a multiple of the chunk and N
  not dividing 256;
* the wrapper's scratch, its refusals (reached without a card through a CPU
  tensor that reports ``cuda:0``) and an accepted call's arguments at the
  C entry (a recording stand-in for the library).

Inputs and output gradients are drawn with numpy from a seed and handed to
both packages. Tolerance: each gradient element within ``1e-5*(1 + m)``,
m the terms summed into it in magnitude (the same gradient taken on the
absolute values of every input and output gradient), the scan rule of
``PERF.md`` section 2; autograd of the port's own loop, which takes the
same products in the same order, within 1e-6 of it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.nn import ssm as jssm  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import selective_scan as SS  # noqa: E402

SCAN_RTOL = 1e-5
CHUNK, THREADS = SS.BWD_CHUNK, SS.BWD_THREADS


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small CPU tensors run far faster on one thread than on many."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, B, T, di, N, through="both"):
    """decay (Mamba's exp(dt * A) or a sigmoid), inp, c, h0, and the output
    gradients, gy zero when the loss goes through h_last alone and gh zero
    when through y alone."""
    rng = np.random.default_rng(seed)
    if seed % 2:
        dt = np.log1p(np.exp(rng.standard_normal((B, T, di)) - 3.0))
        decay = np.exp(dt[..., None] * -np.arange(1, N + 1))
    else:
        decay = 1 / (1 + np.exp(-rng.standard_normal((B, T, di, N))))
    arrays = [a.astype(np.float32) for a in (
        decay, rng.standard_normal((B, T, di, N)),
        rng.standard_normal((B, T, N)), rng.standard_normal((B, di, N)))]
    gy = rng.standard_normal((B, T, di)).astype(np.float32) \
        * (through != "h_last")
    gh = rng.standard_normal((B, di, N)).astype(np.float32) \
        * (through != "y")
    return arrays, gy, gh


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _magnitudes(arrays, gy, gh):
    return [m.numpy() for m in ref.selective_scan_bwd_ref(
        *_t(*(np.abs(a) for a in (*arrays, gy, gh))))]


def _within(got, want, mags, what):
    for name, g, w, m in zip(("decay", "inp", "c", "h0"), got, want, mags):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, (what, name)
        over = np.abs(g - w) / (SCAN_RTOL * (1 + m))
        assert np.all(over <= 1), f"{what} d{name}: {float(over.max())}x"


SHAPES = [(2, 16, 8, 4), (1, 40, 24, 16), (2, 37, 6, 5), (1, 1, 3, 1)]


@pytest.mark.parametrize("through", ["y", "h_last", "both"])
@pytest.mark.parametrize("shape", SHAPES)
def test_bwd_ref_matches_reference_vjps(shape, through):
    """Against jax.vjp of the reference's chunked _selective_scan_fused
    (chunk 16, so T 37 pads its last chunk) and of its plain loop."""
    arrays, gy, gh = _inputs(sum(shape) + len(through), *shape,
                             through=through)
    got = ref.selective_scan_bwd_ref(*_t(*arrays, gy, gh))
    mags = _magnitudes(arrays, gy, gh)
    ja = [jnp.asarray(a) for a in arrays]
    cot = (jnp.asarray(gy), jnp.asarray(gh))
    for label, fn in (
            ("_selective_scan_fused",
             lambda *a: jssm._selective_scan_fused(*a, chunk=16)),
            ("selective_scan_ref", jref.selective_scan_ref)):
        _, vjp = jax.vjp(fn, *ja)
        _within(got, vjp(cot), mags, label)


@pytest.mark.parametrize("through", ["y", "h_last", "both"])
@pytest.mark.parametrize("shape", SHAPES)
def test_bwd_ref_matches_autograd_of_the_plain_scan(shape, through):
    arrays, gy, gh = _inputs(sum(shape) + 7, *shape, through=through)
    leaves = [t.requires_grad_(True) for t in _t(*arrays)]
    y, h = ref.selective_scan_ref(*leaves)
    want = torch.autograd.grad(
        (y * torch.from_numpy(gy)).sum() + (h * torch.from_numpy(gh)).sum(),
        leaves)
    got = ref.selective_scan_bwd_ref(*_t(*arrays, gy, gh))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-6)


def kernel_model(decay, inp, c, h0, gy, gh):
    """The backward kernel's algorithm in plain PyTorch (module docstring):
    one scalar recurrence a (b, channel, state), states kept at the start
    of every CHUNK steps, each chunk recomputed and run in reverse; dc a
    block of THREADS // N channels at a time, summed in channel order, then
    over the blocks in block order."""
    B, T, di, N = decay.shape
    dpb = THREADS // N
    blocks = -(-di // dpb)
    nck = -(-T // CHUNK)
    ckpt, h = [h0], h0
    for k in range(nck - 1):                 # forward: the checkpoints
        for t in range(k * CHUNK, (k + 1) * CHUNK):
            h = decay[:, t] * h + inp[:, t]
        ckpt.append(h)
    d_decay, d_inp = torch.empty_like(decay), torch.empty_like(inp)
    part = torch.zeros((B, blocks, T, N))
    g_next = gh
    for k in reversed(range(nck)):
        t0, t1 = k * CHUNK, min(T, (k + 1) * CHUNK)
        hs, h = [], ckpt[k]
        for t in range(t0, t1):
            h = decay[:, t] * h + inp[:, t]
            hs.append(h)
        for t in range(t0, t1):
            prod = gy[:, t, :, None] * hs[t - t0]           # (B, di, N)
            for j in range(blocks):
                acc = torch.zeros((B, N))
                for d in range(j * dpb, min(di, (j + 1) * dpb)):
                    acc = acc + prod[:, d]
                part[:, j, t] = acc
        for t in reversed(range(t0, t1)):
            g = gy[:, t, :, None] * c[:, t, None, :] + g_next
            d_inp[:, t] = g
            d_decay[:, t] = g * (hs[t - t0 - 1] if t > t0 else ckpt[k])
            g_next = decay[:, t] * g
    dc = torch.zeros((B, T, N))
    for j in range(blocks):
        dc = dc + part[:, j]
    return d_decay, d_inp, dc, g_next


@pytest.mark.parametrize("shape", [(2, 37, 6, 5), (1, 48, 100, 3),
                                   (2, 33, 40, 16), (1, 1, 1, 1)])
def test_kernel_model_matches_plain_and_reference(shape):
    """T 37 and 33 leave a ragged last chunk, T 48 three whole ones; N 3
    and 5 leave threads of a block idle (256 % N), di 100 at N 3 splits
    over two channel blocks and di 40 at N 16 over three."""
    arrays, gy, gh = _inputs(sum(shape) + 11, *shape)
    got = kernel_model(*_t(*arrays, gy, gh))
    mags = _magnitudes(arrays, gy, gh)
    _within(got, ref.selective_scan_bwd_ref(*_t(*arrays, gy, gh)), mags,
            "plain")
    _, vjp = jax.vjp(jref.selective_scan_ref,
                     *[jnp.asarray(a) for a in arrays])
    _within(got, vjp((jnp.asarray(gy), jnp.asarray(gh))), mags, "jax.vjp")


@pytest.mark.parametrize("shape,floats", [
    ((2, 1024, 8192, 16), (16_777_216, 16_777_216)),    # Jamba's training
    ((3, 77, 130, 5), (3 * 5 * 130 * 5, 3 * 3 * 77 * 5)),
    ((1, 16, 1, 1), (1, 16))])
def test_bwd_scratch(shape, floats):
    """Checkpoints (B, ceil(T / 16), di, N) and partials (B, blocks, T, N),
    256 // N channels a block."""
    assert SS.bwd_scratch(*shape) == floats


# ------------------------------------------- the wrapper without a card

class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself on cuda:0, to reach the wrapper's
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


def _args(B=1, T=3, di=4, N=8, **over):
    args = dict(decay=_card(B, T, di, N), inp=_card(B, T, di, N),
                c=_card(B, T, N), h0=_card(B, di, N), gy=_card(B, T, di),
                gh=_card(B, di, N))
    args.update(over)
    return args


REFUSALS = [
    ("cpu", lambda: _args(gy=torch.zeros(1, 3, 4)), ValueError,
     "gy lies on cpu, decay on cuda:0"),
    ("N17", lambda: _args(N=17), ValueError,
     "the kernel takes N <= 16 states and B <= 65,535, got N 17 and B 1"),
    ("gy_shape", lambda: _args(gy=_card(1, 2, 4)), ValueError,
     "gy must be (1, 3, 4), got (1, 2, 4)"),
    ("gh_shape", lambda: _args(gh=_card(1, 4, 7)), ValueError,
     "gh must be (1, 4, 8), got (1, 4, 7)"),
    ("gh_dtype", lambda: _args(gh=_card(1, 4, 8, dtype=torch.float64)),
     TypeError, "gh must be float32, got torch.float64"),
    ("gy_contiguous", lambda: _args(
        gy=torch.zeros(1, 4, 3).transpose(1, 2).as_subclass(_OnCard)),
     ValueError, "gy must be contiguous"),
    ("c_shape", lambda: _args(c=_card(1, 3, 7)), ValueError,
     "c must be (B, T, N) = (1, 3, 8) and h0 (B, di, N) = (1, 4, 8), got "
     "(1, 3, 7) and (1, 4, 8)")]


@pytest.mark.parametrize("make,exc,message", [r[1:] for r in REFUSALS],
                         ids=[r[0] for r in REFUSALS])
def test_bwd_wrapper_refuses_with_its_messages(make, exc, message):
    """The wrapper raises, before any build or launch, on what its kernel
    does not take."""
    with pytest.raises(exc) as err:
        SS.selective_scan_bwd_cuda(**make())
    assert str(err.value) == message


class _Library:
    """Records the C entry's arguments and reports success."""

    def __init__(self):
        self.calls = []

    def rt_selective_scan_bwd(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("shape", [(2, 37, 6, 5), (1, 1, 1, 1)])
def test_bwd_wrapper_passes_shapes_and_scratch(monkeypatch, shape):
    """An accepted call reaches the C entry once with the inputs, four
    fresh outputs and the two scratch buffers of bwd_scratch, and counts
    one selective_scan_bwd launch."""
    lib = _Library()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    B, T, di, N = shape
    args = _args(B, T, di, N)
    before = _build.LAUNCHES["selective_scan_bwd"]
    out = SS.selective_scan_bwd_cuda(**args)
    assert _build.LAUNCHES["selective_scan_bwd"] == before + 1
    (call,) = lib.calls
    ins = [t.data_ptr() for t in args.values()]
    assert list(call[:6]) == ins
    assert list(call[6:10]) == [t.data_ptr() for t in out]
    assert [tuple(t.shape) for t in out] == [
        tuple(args[k].shape) for k in ("decay", "inp", "c", "h0")]
    assert len(set(call[:12])) == 12            # no buffer aliases another
    assert call[12:16] == (B, T, di, N) and call[16] == 0
