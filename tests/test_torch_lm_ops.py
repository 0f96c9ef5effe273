"""The LM kernels as ``torch.library`` ops (``repro_torch.kernels.ops``):
their registration, fake rules, FLOP formulas and gradients, on the CPU.

* ``torch.library.opcheck`` on each of the six ops (schema, autograd
  registration, the fake rule against the CPU implementation, and a trace
  of the op with dynamic shapes);
* the fake rules' shapes equal the CPU implementation's;
* the fake rules refuse what the CUDA wrappers refuse, with the same
  messages (the wrappers reached without a card through a CPU tensor that
  reports ``cuda:0``): a float16 input, head dim 48 (at float32 and at
  bfloat16), 32 states, Hq not a multiple of Hkv;
* the FLOP formulas under ``torch.utils.flop_counter`` count the visible
  (query, key) pairs of the mask, against a brute-force count, and
  ``PERF.md`` section 6's pair counts;
* gradients through the ops on the CPU (the ops' autograd rules, whose
  backward ops run the plain backwards) against autograd of the plain
  forward versions: rmsnorm ``1e-5*(1 + |g|)``, flash attention 2e-5
  absolute, the scan ``1e-5*(1 + m)`` (``tests/test_torch_autograd.py``'s
  rules).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro_torch.kernels import costs, ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_cuda)
from repro_torch.kernels.rmsnorm import rmsnorm_cuda  # noqa: E402
from repro_torch.kernels.selective_scan import (  # noqa: E402
    selective_scan_cuda)
from test_torch_autograd import _card  # noqa: E402

OPS = torch.ops.repro_torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _r(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _scan_inputs(rng, B, T, di, N):
    decay = torch.sigmoid(_r(rng, B, T, di, N))
    return decay, _r(rng, B, T, di, N), _r(rng, B, T, N), _r(rng, B, di, N)


def _args(name):
    rng = np.random.default_rng(len(name))
    if name == "rmsnorm":
        return _r(rng, 3, 5, 64), _r(rng, 64), 1e-6
    if name == "rmsnorm_bwd":
        return _r(rng, 3, 64), _r(rng, 64), _r(rng, 3, 64), 1e-6
    q, k, v = _r(rng, 2, 7, 4, 64), _r(rng, 2, 9, 2, 64), _r(rng, 2, 9, 2, 64)
    if name == "flash_attention":
        return q, k, v, True, 3
    if name == "flash_attention_bwd":
        o, lse = OPS.flash_attention(q, k, v, False, 0)
        return q, k, v, o, lse, _r(rng, 2, 7, 4, 64), False, 0
    scan = _scan_inputs(rng, 2, 5, 8, 4)
    if name == "selective_scan":
        return scan
    return (*scan, _r(rng, 2, 5, 8), _r(rng, 2, 8, 4))


NAMES = ("rmsnorm", "rmsnorm_bwd", "flash_attention", "flash_attention_bwd",
         "selective_scan", "selective_scan_bwd")


@pytest.mark.parametrize("name", NAMES)
def test_opcheck_passes(name):
    args = _args(name)
    if not name.endswith("_bwd"):    # the autograd rule's check too
        args = tuple(a.requires_grad_() if isinstance(a, torch.Tensor)
                     and a.dtype.is_floating_point else a for a in args)
    torch.library.opcheck(getattr(OPS, name), args)


@pytest.mark.parametrize("name", NAMES)
def test_fake_shapes_equal_the_cpu_implementation(name):
    args = _args(name)
    real = getattr(OPS, name)(*args)
    with FakeTensorMode() as mode:
        fake = getattr(OPS, name)(*(
            mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
            for a in args))
    real = real if isinstance(real, (tuple, list)) else (real,)
    fake = fake if isinstance(fake, (tuple, list)) else (fake,)
    assert [(tuple(t.shape), t.dtype, t.stride()) for t in fake] == \
        [(tuple(t.shape), t.dtype, t.stride()) for t in real]


def _on_card(args):
    return [_card(*a.shape, dtype=a.dtype) if isinstance(a, torch.Tensor)
            else a for a in args]


REFUSALS = {
    "fp16": ("rmsnorm", lambda: (torch.zeros(3, 64, dtype=torch.float16),
                                 torch.zeros(64)),
             lambda x, s: rmsnorm_cuda(x, s)),
    "bf16": ("flash_attention", lambda: (
        torch.zeros(1, 4, 2, 48, dtype=torch.bfloat16),
        torch.zeros(1, 4, 1, 48, dtype=torch.bfloat16),
        torch.zeros(1, 4, 1, 48, dtype=torch.bfloat16)),
        lambda q, k, v: flash_attention_cuda(q, k, v)),
    "D48": ("flash_attention", lambda: (torch.zeros(1, 4, 2, 48),
                                       torch.zeros(1, 4, 1, 48),
                                       torch.zeros(1, 4, 1, 48)),
            lambda q, k, v: flash_attention_cuda(q, k, v)),
    "N32": ("selective_scan", lambda: (torch.zeros(1, 3, 4, 32),
                                       torch.zeros(1, 3, 4, 32),
                                       torch.zeros(1, 3, 32),
                                       torch.zeros(1, 4, 32)),
            lambda *a: selective_scan_cuda(*a)),
    "groups": ("flash_attention", lambda: (torch.zeros(1, 4, 3, 64),
                                           torch.zeros(1, 4, 2, 64),
                                           torch.zeros(1, 4, 2, 64)),
               lambda q, k, v: flash_attention_cuda(q, k, v)),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_fake_rules_refuse_what_the_card_refuses(case):
    name, make, wrapper = REFUSALS[case]
    with pytest.raises((TypeError, ValueError)) as card:
        wrapper(*_on_card(make()))
    extra = {"rmsnorm": (1e-6,), "flash_attention": (True, 0),
             "selective_scan": ()}[name]
    with FakeTensorMode() as mode:
        fake_args = [mode.from_tensor(a) for a in make()]
        with pytest.raises(type(card.value)) as fake:
            getattr(OPS, name)(*fake_args, *extra)
    assert str(fake.value) == str(card.value)


def _brute_pairs(Tq, Tk, causal, window):
    qpos, kpos = np.arange(Tq)[:, None], np.arange(Tk)[None, :]
    seen = np.ones((Tq, Tk), bool)
    if causal:
        seen &= kpos <= qpos
    if window:
        seen &= kpos > qpos - window
    return int(seen.sum())


@pytest.mark.parametrize("Tq,Tk,causal,window", [
    (19, 19, True, 0), (19, 19, True, 7), (7, 30, False, 0),
    (30, 7, True, 0), (12, 25, True, 5), (40, 10, False, 5)])
def test_flash_flop_formulas_count_visible_pairs(Tq, Tk, causal, window):
    B, Hq, Hkv, D = 2, 4, 2, 64
    pairs = B * Hq * _brute_pairs(Tq, Tk, causal, window)
    q = torch.zeros(B, Tq, Hq, D, requires_grad=True)
    k, v = (torch.zeros(B, Tk, Hkv, D, requires_grad=True) for _ in "kv")
    with FlopCounterMode(display=False) as fc:
        out = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert fc.get_total_flops() == 2 * (D + D) * pairs
    with FlopCounterMode(display=False) as fc:
        out.sum().backward()
    counts = fc.get_flop_counts()["Global"]
    assert counts[OPS.flash_attention_bwd] == 5 * 2 * D * pairs


def test_pair_counts_of_the_perf_table():
    """``PERF.md`` section 6: qwen3's training layer, starcoder2-3b's
    window and whisper-base's encoder."""
    assert costs.flash_pairs((8, 1024, 16, 128), (8, 1024, 8, 128), True,
                             0) == 67_174_400
    assert costs.flash_pairs((2, 6144, 24, 128), (2, 6144, 2, 128), True,
                             4096) == 805_404_672
    assert costs.flash_pairs((8, 1500, 8, 64), (8, 1500, 8, 64), False,
                             0) == 144_000_000


def test_elementwise_flop_formulas():
    x, s = torch.zeros(3, 5, 64, requires_grad=True), torch.zeros(64)
    with FlopCounterMode(display=False) as fc:
        ops.rmsnorm(x, s).sum().backward()
    counts = fc.get_flop_counts()["Global"]
    assert counts[OPS.rmsnorm] == 4 * 3 * 5 * 64
    assert counts[OPS.rmsnorm_bwd] == 8 * 3 * 5 * 64
    d, i, c, h0 = (t.requires_grad_() for t in _scan_inputs(
        np.random.default_rng(0), 2, 5, 8, 4))
    with FlopCounterMode(display=False) as fc:
        y, h = ops.selective_scan(d, i, c, h0)
        (y.sum() + h.sum()).backward()
    counts = fc.get_flop_counts()["Global"]
    assert counts[OPS.selective_scan] == 4 * 2 * 5 * 8 * 4
    assert counts[OPS.selective_scan_bwd] == 8 * 2 * 5 * 8 * 4


# ------------------------------------------------- gradients through the ops

def _grads(fn, leaves, g):
    out = fn(*leaves)
    outs = out if isinstance(out, tuple) else (out,)
    return torch.autograd.grad(sum((o * w).sum() for o, w in zip(outs, g)),
                               leaves)


@pytest.mark.parametrize("shape", [(5, 64), (2, 3, 130)])
def test_rmsnorm_op_gradients_equal_autograd_of_the_plain_version(shape):
    rng = np.random.default_rng(sum(shape))
    x, s, g = _r(rng, *shape), _r(rng, shape[-1]), _r(rng, *shape)
    got = _grads(lambda a, b: ops.rmsnorm(a, b), [x.clone().requires_grad_(),
                 s.clone().requires_grad_()], (g,))
    want = _grads(lambda a, b: ref.rmsnorm_ref(a, b), [
        x.clone().requires_grad_(), s.clone().requires_grad_()], (g,))
    for a, b in zip(got, want):
        assert bool(((a - b).abs() <= 1e-5 * (1 + b.abs())).all())


@pytest.mark.parametrize("causal,window,Tq,Tk", [
    (True, 0, 19, 19), (True, 7, 19, 19), (False, 0, 7, 30),
    (True, 0, 25, 12), (False, 5, 40, 10)])
def test_flash_op_gradients_equal_autograd_of_the_plain_version(
        causal, window, Tq, Tk):
    """GQA 2:1; the last case has rows that see no key (the mean of v)."""
    rng = np.random.default_rng(Tq + Tk + window)
    q, k, v = _r(rng, 2, Tq, 4, 64), _r(rng, 2, Tk, 2, 64), \
        _r(rng, 2, Tk, 2, 64)
    g = _r(rng, 2, Tq, 4, 64)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = _grads(lambda a, b, c: ops.flash_attention(
        a, b, c, causal=causal, window=window), leaves, (g,))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = _grads(lambda a, b, c: ref.flash_attention_ref(
        a, b, c, causal=causal, window=window), leaves, (g,))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=2e-5)


def test_scan_op_gradients_equal_autograd_of_the_plain_version():
    rng = np.random.default_rng(3)
    inputs = _scan_inputs(rng, 2, 16, 8, 4)
    gy, gh = _r(rng, 2, 16, 8), _r(rng, 2, 8, 4)
    got = _grads(ops.selective_scan,
                 [t.clone().requires_grad_() for t in inputs], (gy, gh))
    want = _grads(ref.selective_scan_ref,
                  [t.clone().requires_grad_() for t in inputs], (gy, gh))
    mags = _grads(ref.selective_scan_ref,
                  [t.abs().requires_grad_() for t in inputs],
                  (gy.abs(), gh.abs()))
    for a, b, m in zip(got, want, mags):
        assert bool(((a - b).abs() <= 1e-5 * (1 + m)).all())
