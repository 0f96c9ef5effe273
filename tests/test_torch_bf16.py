"""Port parity at bfloat16: the three LM kernels' ops, their backwards, the
parameter paths and qwen3 SMOKE against the JAX package, on the CPU.

The TPU kernels' dtype contract (``src/repro/kernels/rmsnorm.py``,
``flash_attention.py``, ``selective_scan.py``): load float32 or bfloat16,
compute in float32, store in the output's type (the scan's y and h_last
stay float32). On the CPU the port's ops run their plain versions, which
take bf16 the same way; the CUDA kernels' bf16 instances are held against
them, and against their float32 instances, on the card by
``chip_smoke.py``. Inputs come from numpy and are rounded to bf16 once;
the JAX side gets the same bf16 values (``jnp.asarray(x).astype(bf16)``
of the same float32 array rounds as torch's cast: to nearest even).

Tolerances (BF16 rule): one bf16 ulp of the larger magnitude, beyond the
float32 rule of the same comparison -- both sides compute in float32 and
round once, so they can land on neighbouring bf16 values, and their float32
results differ by the float32 rule (rmsnorm 2e-6 relative; attention 2e-5
absolute, the Pallas kernel scaling q before the dot; the scan 2e-5
relative; gradients 1e-5 of each array's largest magnitude). The scan's
y and h_last are float32: the float32 rule alone. The flash backward's
gradients also take one ulp of the array's largest magnitude: its delta =
<dO, O> a row is formed from the bf16 output O, as a flash backward keeps
O and not its float32 sums, where autodiff of the plain function reads
the float32 sums (measured: at most that ulp, at 24 tokens of D 64).

qwen3 SMOKE at bf16 (prefill logits, decode steps, the loss and gradients
of one train step): the port's distance from the reference's bf16 result,
relative L2, at most twice the reference's own bf16 result's distance from
its float32 result on the same (bf16-valued) weights: the two frameworks
round bf16 products in other places, so the port is held to the distance
the reference's own rounding makes.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro.checkpoint.npz import _flatten_with_paths  # noqa: E402
from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.kernels.rmsnorm import rmsnorm_pallas  # noqa: E402
from repro.kernels.selective_scan import selective_scan_pallas  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim.adamw import adamw_init as jadamw_init  # noqa: E402
from repro.optim.adamw import adamw_update as jadamw_update  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.convert import (lm_params_from_numpy,  # noqa: E402
                                 lm_params_to_numpy)
from repro_torch.kernels import costs, ops  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_bwd_cuda, flash_attention_cuda)
from repro_torch.kernels.rmsnorm import (rmsnorm_bwd_cuda,  # noqa: E402
                                         rmsnorm_cuda)
from repro_torch.kernels.selective_scan import (  # noqa: E402
    selective_scan_bwd_cuda, selective_scan_cuda)
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim.adamw import (adamw_init, adamw_update,  # noqa: E402
                                     leaves)
from test_torch_autograd import _card  # noqa: E402

OPS = torch.ops.repro_torch
BF16, F32 = torch.bfloat16, torch.float32
ARCH = "qwen3-0.6b"
RMS_TOL, ATTN_TOL, SCAN_TOL, GRAD_TOL = 2e-6, 2e-5, 2e-5, 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small CPU tensors run far faster on one thread than on many."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _pair(a, dtype="bf16"):
    """A float32 numpy array as (torch, jax) of one type, the same values."""
    if dtype == "f32":
        return torch.from_numpy(a.copy()), jnp.asarray(a)
    return torch.from_numpy(a.copy()).to(BF16), \
        jnp.asarray(a).astype(jnp.bfloat16)


def _f32(x):
    """A torch or jax array as float32 numpy (bf16 widened, exact)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _ulp(a):
    """bf16's spacing at |a| (float32 numpy): 2^(e - 8), |a| = m 2^e."""
    _, e = np.frexp(np.abs(a))
    return np.ldexp(np.float32(1.0), e - 8).astype(np.float32)


def _assert_bf16_close(got, want, tol32, what):
    """The BF16 rule: |got - want| <= ulp(max(|got|, |want|)) + tol32."""
    g, w = _f32(got), _f32(want)
    err = np.abs(g - w)
    limit = _ulp(np.maximum(np.abs(g), np.abs(w))) + tol32
    assert (err <= limit).all(), \
        f"{what}: {float((err / limit).max())}x the BF16 rule"


def _rel_l2(a, b):
    a, b = _f32(a).astype(np.float64), _f32(b).astype(np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ------------------------------------------------- the kernels' forwards

@pytest.mark.parametrize("xt,st", [("bf16", "bf16"), ("bf16", "f32"),
                                   ("f32", "bf16")])
def test_rmsnorm_matches_pallas_kernel(xt, st):
    """x and scale each float32 or bf16 (dtype and param_dtype may
    differ); the output in x's type."""
    x, jx = _pair(_np(0, 3, 37, 128), xt)
    s, js = _pair(1.0 + 0.1 * _np(1, 128), st)
    want = rmsnorm_pallas(jx, js, interpret=True)
    got = ops.rmsnorm(x, s)
    assert got.dtype == x.dtype and np.dtype(want.dtype) == \
        np.dtype(jx.dtype)
    _assert_bf16_close(got, want, RMS_TOL * (1 + np.abs(_f32(want))),
                       "rmsnorm")


@pytest.mark.parametrize("causal,window,Hkv", [(True, 0, 2), (True, 5, 4),
                                               (False, 0, 1)])
def test_flash_attention_matches_pallas_kernel(causal, window, Hkv):
    """GQA through the port's kernel, the reference's Pallas kernel on k
    and v repeated to the query heads (its ops repeats them)."""
    B, T_, Hq, D = 2, 40, 4, 64
    q, jq = _pair(_np(2, B, T_, Hq, D))
    k, jk = _pair(_np(3, B, T_, Hkv, D))
    v, jv = _pair(_np(4, B, T_, Hkv, D))
    rep = Hq // Hkv
    want = flash_attention_pallas(
        jq, jnp.repeat(jk, rep, axis=2), jnp.repeat(jv, rep, axis=2),
        causal=causal, window=window, block_q=16, block_k=16,
        interpret=True)
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert got.dtype == BF16 and np.dtype(want.dtype) == np.dtype(jq.dtype)
    _assert_bf16_close(got, want, ATTN_TOL, "flash_attention")


@pytest.mark.parametrize("mask", [15, 1, 12])
def test_selective_scan_matches_pallas_kernel(mask):
    """decay, inp, c, h0 each float32 or bf16 (bit i of ``mask`` set:
    input i bf16); y and h_last float32, as the TPU kernel's."""
    B, T_, di, N = 2, 11, 16, 8
    arrays = [1.0 / (1.0 + np.exp(-_np(5, B, T_, di, N))), _np(6, B, T_, di, N),
              _np(7, B, T_, N), _np(8, B, di, N)]
    pairs = [_pair(a.astype(np.float32), "bf16" if mask >> i & 1 else "f32")
             for i, a in enumerate(arrays)]
    want = selective_scan_pallas(*(j for _, j in pairs), block_di=8,
                                 chunk_t=4, interpret=True)
    got = ops.selective_scan(*(t for t, _ in pairs))
    for g, w, name in zip(got, want, ("y", "h_last")):
        assert g.dtype == F32 and np.dtype(w.dtype) == np.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=SCAN_TOL,
                                   atol=SCAN_TOL, err_msg=name)


# ------------------------------------------------ the kernels' backwards

def _vjp_close(port_fn, jax_fn, torch_in, jax_in, cot, what, *,
               from_output=False):
    """Gradients of the port's op (its autograd rule, whose backward op
    runs the plain backward here) against ``jax.vjp`` of the reference's
    plain function, on the same bf16 inputs and output cotangent: each in
    its input's type, under the BF16 rule with the float32 rule
    GRAD_TOL of its largest magnitude; ``from_output`` (flash): plus one
    ulp of that magnitude (the module's docstring)."""
    tin = [t.clone().requires_grad_(True) for t in torch_in]
    out = port_fn(*tin)
    out = out[0] if isinstance(out, tuple) else out
    grads = torch.autograd.grad(out, tin, cot[0])
    jout, vjp = jax.vjp(jax_fn, *jax_in)
    jgrads = vjp(cot[1] if not isinstance(jout, tuple)
                 else (cot[1], jnp.zeros_like(jout[1])))
    for i, (g, jg, t) in enumerate(zip(grads, jgrads, torch_in)):
        assert g.dtype == t.dtype, f"{what} grad {i}: {g.dtype}"
        top = np.abs(_f32(jg)).max()
        tol = GRAD_TOL * top + (_ulp(top) if from_output else 0.0)
        _assert_bf16_close(g, jg, tol, f"{what} grad {i}")


@pytest.mark.parametrize("st", ["bf16", "f32"])
def test_rmsnorm_gradients_match_jax_vjp(st):
    x, jx = _pair(_np(10, 3, 9, 64))
    s, js = _pair(1.0 + 0.1 * _np(11, 64), st)
    g, jg = _pair(_np(12, 3, 9, 64))
    _vjp_close(lambda a, b: ops.rmsnorm(a, b),
               lambda a, b: jref.rmsnorm_ref(a, b), (x, s), (jx, js),
               (g, jg), "rmsnorm")


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 7)])
def test_flash_attention_gradients_match_jax_vjp(causal, window):
    q, jq = _pair(_np(13, 2, 24, 2, 64))
    k, jk = _pair(_np(14, 2, 24, 2, 64))
    v, jv = _pair(_np(15, 2, 24, 2, 64))
    do, jdo = _pair(_np(16, 2, 24, 2, 64))
    _vjp_close(lambda a, b, c: ops.flash_attention(
        a, b, c, causal=causal, window=window),
        lambda a, b, c: jref.flash_attention_ref(a, b, c, causal=causal,
                                                 window=window),
        (q, k, v), (jq, jk, jv), (do, jdo), "flash_attention",
        from_output=True)


def test_selective_scan_gradients_match_jax_vjp():
    """Through y (h_last's gradient 0): each gradient in its input's type
    (all four bf16 here)."""
    B, T_, di, N = 2, 9, 8, 4
    arrays = [1.0 / (1.0 + np.exp(-_np(17, B, T_, di, N))),
              _np(18, B, T_, di, N), _np(19, B, T_, N), _np(20, B, di, N)]
    pairs = [_pair(a.astype(np.float32)) for a in arrays]
    gy = _np(21, B, T_, di)
    _vjp_close(lambda *a: ops.selective_scan(*a),
               lambda *a: jref.selective_scan_ref(*a),
               [t for t, _ in pairs], [j for _, j in pairs],
               (torch.from_numpy(gy), jnp.asarray(gy)), "selective_scan")


# ------------------------------------- dtypes, fake rules and refusals

def _bf16_args(name):
    """Each op's arguments at bf16 (rmsnorm's scale float32: mixed)."""
    rng = np.random.default_rng(len(name))

    def r(*shape, dtype=BF16):
        return torch.from_numpy(rng.standard_normal(shape)
                                .astype(np.float32)).to(dtype)

    if name == "rmsnorm":
        return r(3, 5, 64), r(64, dtype=F32), 1e-6
    if name == "rmsnorm_bwd":
        return r(3, 64), r(64), r(3, 64), 1e-6
    q, k, v = r(2, 7, 4, 64), r(2, 9, 2, 64), r(2, 9, 2, 64)
    if name == "flash_attention":
        return q, k, v, True, 3
    if name == "flash_attention_bwd":
        o, lse = OPS.flash_attention(q, k, v, False, 0)
        return q, k, v, o, lse, r(2, 7, 4, 64), False, 0
    scan = (torch.sigmoid(r(2, 5, 8, 4, dtype=F32)).to(BF16), r(2, 5, 8, 4),
            r(2, 5, 4), r(2, 8, 4, dtype=F32))
    if name == "selective_scan":
        return scan
    return (*scan, r(2, 5, 8, dtype=F32), r(2, 8, 4, dtype=F32))


NAMES = ("rmsnorm", "rmsnorm_bwd", "flash_attention", "flash_attention_bwd",
         "selective_scan", "selective_scan_bwd")
#: each output's dtype, from the inputs': the forwards' outputs as the TPU
#: kernels' (lse and the scan's float32), every gradient its input's
WANT_DTYPES = {"rmsnorm": (BF16,), "rmsnorm_bwd": (BF16, BF16),
               "flash_attention": (BF16, F32),
               "flash_attention_bwd": (BF16, BF16, BF16),
               "selective_scan": (F32, F32),
               "selective_scan_bwd": (BF16, BF16, BF16, F32)}


@pytest.mark.parametrize("name", NAMES)
def test_fake_rules_give_the_cpu_implementations_dtypes(name):
    """At bf16 the fake rules' (shape, dtype, stride) are the CPU
    implementation's, and the dtypes are the contract's."""
    args = _bf16_args(name)
    real = getattr(OPS, name)(*args)
    with FakeTensorMode() as mode:
        fake = getattr(OPS, name)(*(
            mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
            for a in args))
    real = real if isinstance(real, (tuple, list)) else (real,)
    fake = fake if isinstance(fake, (tuple, list)) else (fake,)
    assert [(tuple(t.shape), t.dtype, t.stride()) for t in fake] == \
        [(tuple(t.shape), t.dtype, t.stride()) for t in real]
    assert tuple(t.dtype for t in real) == WANT_DTYPES[name]


@pytest.mark.parametrize("name", NAMES)
def test_opcheck_passes_at_bf16(name):
    args = _bf16_args(name)
    if not name.endswith("_bwd"):
        args = tuple(a.requires_grad_() if isinstance(a, torch.Tensor)
                     and a.dtype.is_floating_point else a for a in args)
    torch.library.opcheck(getattr(OPS, name), args)


def test_autograd_gradients_have_their_inputs_dtypes():
    """Mixed types through the ops' autograd rules: rmsnorm's x bf16 and
    scale float32, the scan's decay and h0 float32, inp and c bf16."""
    x = torch.randn(4, 64).to(BF16).requires_grad_(True)
    s = torch.rand(64).add_(0.5).requires_grad_(True)
    gx, gs = torch.autograd.grad(ops.rmsnorm(x, s).float().sum(), (x, s))
    assert (gx.dtype, gs.dtype) == (BF16, F32)
    d = torch.sigmoid(torch.randn(1, 5, 8, 4)).requires_grad_(True)
    i = torch.randn(1, 5, 8, 4).to(BF16).requires_grad_(True)
    c = torch.randn(1, 5, 4).to(BF16).requires_grad_(True)
    h = torch.randn(1, 8, 4).requires_grad_(True)
    y, hl = ops.selective_scan(d, i, c, h)
    grads = torch.autograd.grad(y.sum() + hl.sum(), (d, i, c, h))
    assert [t.dtype for t in grads] == [F32, BF16, BF16, F32]


def test_rmsnorm_copies_a_bf16_view_to_contiguous():
    """ops.rmsnorm makes a strided bf16 view contiguous, as a float32 one,
    and gives the same bits as on the contiguous copy."""
    base = torch.randn(6, 128).to(BF16)
    view = base[:, ::2]
    s = torch.rand(64).add_(0.5).to(BF16)
    assert not view.is_contiguous()
    assert torch.equal(ops.rmsnorm(view, s), ops.rmsnorm(view.contiguous(),
                                                         s))


FP16_REFUSALS = {
    "rmsnorm": lambda: rmsnorm_cuda(_card(3, 64, dtype=torch.float16),
                                    _card(64)),
    "rmsnorm_bwd": lambda: rmsnorm_bwd_cuda(
        _card(3, 64), _card(64, dtype=torch.float16), _card(3, 64)),
    "flash_attention": lambda: flash_attention_cuda(
        _card(1, 4, 2, 64, dtype=torch.float16),
        _card(1, 4, 1, 64, dtype=torch.float16),
        _card(1, 4, 1, 64, dtype=torch.float16)),
    "flash_attention_bwd": lambda: flash_attention_bwd_cuda(
        *(_card(1, 4, 2, 64, dtype=torch.float16),) * 4, _card(1, 2, 4),
        _card(1, 4, 2, 64, dtype=torch.float16)),
    "selective_scan": lambda: selective_scan_cuda(
        _card(1, 3, 4, 8), _card(1, 3, 4, 8, dtype=torch.float16),
        _card(1, 3, 8), _card(1, 4, 8)),
    "selective_scan_bwd": lambda: selective_scan_bwd_cuda(
        _card(1, 3, 4, 8), _card(1, 3, 4, 8), _card(1, 3, 8),
        _card(1, 4, 8, dtype=torch.float16), _card(1, 3, 4), _card(1, 4, 8))}


@pytest.mark.parametrize("name", sorted(FP16_REFUSALS))
def test_float16_is_refused_with_a_message_that_names_it(name):
    """float16 stays refused by all six wrappers (through a CPU tensor that
    reports cuda:0, so nothing is built or launched)."""
    with pytest.raises(TypeError, match="must be float32 or bfloat16, got "
                       "torch.float16"):
        FP16_REFUSALS[name]()


# --------------------------------------------------------------- costs

def test_costs_count_bytes_at_each_element_size():
    """At bf16 each input and output of bf16 counts half its float32
    bytes; flash's lse and the scan's float32 outputs and output gradients
    do not; float32's counts are the ones PERF.md section 6 uses."""
    q, k = (8, 1024, 16, 128), (8, 1024, 8, 128)
    lse = 4 * 8 * 16 * 1024
    assert costs.flash_bytes(q, k, k) == 201_850_880
    assert costs.flash_bytes(q, k, k, 2) - lse == \
        (costs.flash_bytes(q, k, k) - lse) // 2
    assert costs.flash_bwd_bytes(q, k, 2) - lse == \
        (costs.flash_bwd_bytes(q, k) - lse) // 2
    x = (8192, 1024)
    assert costs.rmsnorm_bytes(x) == 67_112_960
    assert 2 * costs.rmsnorm_bytes(x, 2, 2) == costs.rmsnorm_bytes(x)
    assert 2 * costs.rmsnorm_bwd_bytes(x, 2, 2) == costs.rmsnorm_bwd_bytes(x)
    assert costs.rmsnorm_bytes(x, 2, 4) == 2 * 2 * 8192 * 1024 + 4 * 1024
    d = (8, 1024, 8192, 16)
    B, T_, di, N = d
    f32_out = 4 * (B * di * N + B * T_ * di)
    assert costs.scan_bytes(d) == 8_867_282_944
    assert costs.scan_bytes(d, (2, 2, 2, 2)) - f32_out == \
        (costs.scan_bytes(d) - f32_out) // 2
    assert costs.scan_bwd_bytes(d, (2, 2, 2, 2)) - f32_out == \
        (costs.scan_bwd_bytes(d) - f32_out) // 2


def test_flash_passes_at_each_type():
    """The TF32 passes a product the flash kernels take: three at float32;
    at bf16 two forward and 8/5 on the average backward (one for S and
    dP, two for dV, dK and dQ) -- chip_smoke.py's bound for the bf16
    rows."""
    from repro_torch.roofline.analysis import flash_passes
    assert flash_passes() == flash_passes(4, True) == 3.0
    assert flash_passes(2) == 2.0 and flash_passes(2, True) == 8 / 5


def test_op_bytes_read_the_tensors_element_sizes():
    """The counted step's byte terms (ops.OP_BYTES) at bf16 arguments are
    costs' at size 2."""
    args = _bf16_args("flash_attention")
    q, k, v = args[:3]
    assert ops.OP_BYTES[OPS.flash_attention.default](*args) == \
        costs.flash_bytes(q.shape, k.shape, v.shape, 2)
    x, s, _ = _bf16_args("rmsnorm")
    assert ops.OP_BYTES[OPS.rmsnorm.default](x, s, 1e-6) == \
        costs.rmsnorm_bytes(x.shape, 2, 4)
    scan = _bf16_args("selective_scan")
    assert ops.OP_BYTES[OPS.selective_scan.default](*scan) == \
        costs.scan_bytes(scan[0].shape, (2, 2, 2, 4))


# ------------------------------------------------ parameters at bf16

@pytest.fixture(scope="module")
def twins():
    """The reference's SMOKE weights at bfloat16 (dtype = param_dtype), the
    same bf16 values widened to float32 for the float32 run, and the port's
    configs and parameters."""
    jcfg16 = jsmoke_config(ARCH).replace(dtype="bfloat16",
                                         param_dtype="bfloat16")
    jcfg32 = jsmoke_config(ARCH)
    jp16 = JT.init_lm(jax.random.PRNGKey(0), jcfg16)
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp16)
    # the tests pass the reference's bf16 leaves widened: exact
    flat = {k: np.asarray(jnp.asarray(v).astype(jnp.float32))
            for k, v in _flatten_with_paths(jp16)[0].items()}
    cfg16 = smoke_config(ARCH).replace(dtype="bfloat16",
                                       param_dtype="bfloat16")
    return {"jcfg16": jcfg16, "jcfg32": jcfg32, "jp16": jp16, "jp32": jp32,
            "flat": flat, "cfg16": cfg16, "cfg32": smoke_config(ARCH),
            "p16": lm_params_from_numpy(flat, cfg16, device="cpu"),
            "p32": lm_params_from_numpy(flat, smoke_config(ARCH),
                                        device="cpu")}


def _reference_shapes(jcfg):
    """jax.eval_shape of the reference's init_lm: {path: ShapeDtypeStruct},
    keyed as _flatten_with_paths keys its arrays."""
    flat = jax.tree_util.tree_flatten_with_path(jax.eval_shape(
        lambda: JT.init_lm(jax.random.PRNGKey(0), jcfg)))[0]
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): leaf for path, leaf in flat}


def test_lm_params_from_numpy_follow_param_dtype(twins):
    """Every leaf in cfg.param_dtype, with the shapes of jax.eval_shape of
    the reference's init_lm at bf16; the values the reference's bf16
    leaves, bit for bit; and back to numpy the same values."""
    shapes = _reference_shapes(twins["jcfg16"])
    assert {np.dtype(s.dtype) for s in shapes.values()} == \
        {np.dtype(jnp.bfloat16)}
    back = lm_params_to_numpy(twins["p16"], twins["cfg16"])
    assert sorted(back) == sorted(shapes)
    for key, s in shapes.items():
        assert back[key].shape == tuple(s.shape), key
        np.testing.assert_array_equal(back[key], twins["flat"][key],
                                      err_msg=key)
    assert {t.dtype for t in leaves(twins["p16"])} == {BF16}
    assert {t.dtype for t in leaves(twins["p32"])} == {F32}


def test_lm_params_from_numpy_rounds_to_nearest_even(twins):
    """float32 arrays cast to bf16 as JAX's astype rounds them."""
    cfg = twins["cfg16"]
    rng = np.random.default_rng(3)
    flat = {k: (rng.standard_normal(v.shape) * 0.37).astype(np.float32)
            for k, v in twins["flat"].items()}
    back = lm_params_to_numpy(lm_params_from_numpy(flat, cfg, device="cpu"),
                              cfg)
    for key, a in flat.items():
        want = np.asarray(jnp.asarray(a).astype(jnp.bfloat16)
                          .astype(jnp.float32))
        np.testing.assert_array_equal(back[key], want, err_msg=key)


def test_init_lm_follows_param_dtype(twins):
    """The port's init_lm draws in float32 and casts once to
    cfg.param_dtype (or ``dtype=``), the reference's tree shapes."""
    cfg16 = twins["cfg16"]
    p = T.init_lm(torch.Generator().manual_seed(0), cfg16, device="cpu")
    assert {t.dtype for t in leaves(p)} == {BF16}
    back = lm_params_to_numpy(p, cfg16)
    want = _reference_shapes(twins["jcfg16"])
    assert {k: v.shape for k, v in back.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    p32 = T.init_lm(torch.Generator().manual_seed(0), cfg16, device="cpu",
                    dtype=F32)
    assert {t.dtype for t in leaves(p32)} == {F32}
    # one draw, cast once: the bf16 tree is the float32 tree rounded
    assert all(torch.equal(a, b.to(BF16)) for a, b in
               zip(leaves(p), leaves(p32)))


# --------------------------------------------------- qwen3 SMOKE at bf16

def _tokens(seed, B, T_, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (B, T_)) \
        .astype(np.int32)


def _distances(port16, ref16, ref32):
    """(port's distance from the reference's bf16 result, the reference's
    bf16 result's from its float32 one), relative L2."""
    return _rel_l2(port16, ref16), _rel_l2(ref16, ref32)


def test_prefill_logits_at_bf16(twins):
    toks = _tokens(0, 2, 24, twins["cfg16"].vocab_size)
    ref16 = JT.prefill(twins["jp16"], twins["jcfg16"],
                       jnp.asarray(toks)).logits
    ref32 = JT.prefill(twins["jp32"], twins["jcfg32"],
                       jnp.asarray(toks)).logits
    got = T.prefill(twins["p16"], twins["cfg16"],
                    torch.from_numpy(toks)).logits
    assert got.dtype == BF16 and np.dtype(ref16.dtype) == \
        np.dtype(jnp.bfloat16)
    port, own = _distances(got, ref16, ref32)
    assert 0 < own and port <= 2 * own, (port, own)


def test_decode_steps_at_bf16(twins):
    """Ten decode steps on bf16 caches, each step's logits."""
    cfg16, jcfg16 = twins["cfg16"], twins["jcfg16"]
    toks = _tokens(1, 2, 10, cfg16.vocab_size)
    caches = T.init_caches(cfg16, 2, 12, device="cpu")
    assert caches[0].k.dtype == BF16
    j16 = JT.init_caches(jcfg16, 2, 12)
    j32 = JT.init_caches(twins["jcfg32"], 2, 12)
    got, want16, want32 = [], [], []
    for t in range(10):
        tok = toks[:, t:t + 1]
        lg, caches = T.decode_step(twins["p16"], cfg16,
                                   torch.from_numpy(tok), caches, t)
        jl16, j16 = JT.decode_step(twins["jp16"], jcfg16, jnp.asarray(tok),
                                   j16, jnp.int32(t))
        jl32, j32 = JT.decode_step(twins["jp32"], twins["jcfg32"],
                                   jnp.asarray(tok), j32, jnp.int32(t))
        got.append(_f32(lg))
        want16.append(_f32(jl16))
        want32.append(_f32(jl32))
    port, own = _distances(np.stack(got), np.stack(want16),
                           np.stack(want32))
    assert 0 < own and port <= 2 * own, (port, own)


def _token_losses(logits, toks):
    """(B, T - 1) next-token cross-entropies of float32 numpy logits."""
    lg = logits[:, :-1].astype(np.float64)
    lse = np.log(np.exp(lg - lg.max(-1, keepdims=True)).sum(-1)) \
        + lg.max(-1)
    tgt = np.take_along_axis(lg, toks[:, 1:, None].astype(np.int64), -1)
    return lse - tgt[..., 0]


def test_train_step_loss_and_gradients_at_bf16(twins):
    """lm_loss and its gradient at bf16, remat on, every gradient bf16.
    The gradient tree (all leaves, relative L2) within twice the
    reference's own bf16-to-float32 distance. The loss is one mean, whose
    own distance can vanish by chance, so the rule is taken token by
    token: each position's cross-entropy (from the forward's logits)
    within twice the reference's own distance (relative L2 over the
    positions), and the mean loss within twice the mean absolute distance
    of the reference's own per-token losses."""
    cfg16, jcfg16 = twins["cfg16"], twins["jcfg16"]
    toks = _tokens(2, 2, 24, cfg16.vocab_size)
    ref16, jg16 = jax.value_and_grad(lambda p: JT.lm_loss(
        p, jcfg16, jnp.asarray(toks)))(twins["jp16"])
    ref32, jg32 = jax.value_and_grad(lambda p: JT.lm_loss(
        p, twins["jcfg32"], jnp.asarray(toks)))(twins["jp32"])
    params = lm_params_from_numpy(twins["flat"], cfg16, device="cpu")
    for p in leaves(params):
        p.requires_grad_(True)
    loss = T.lm_loss(params, cfg16, torch.from_numpy(toks))
    grads = torch.autograd.grad(loss, leaves(params))
    assert all(g.dtype == BF16 for g in grads)
    per_token = [_token_losses(_f32(lg), toks) for lg in (
        T.forward(params, cfg16, torch.from_numpy(toks)).logits,
        JT.forward(twins["jp16"], jcfg16, jnp.asarray(toks)).logits,
        JT.forward(twins["jp32"], twins["jcfg32"], jnp.asarray(toks)).logits)]
    port, own = _distances(*per_token)
    assert 0 < own and port <= 2 * own, (port, own)
    own_mean = float(np.abs(per_token[1] - per_token[2]).mean())
    port_loss = abs(float(loss.detach()) - float(ref16))
    assert port_loss <= 2 * own_mean, (port_loss, own_mean)
    it = iter(grads)
    tree = _tree_like(params, it)
    got = lm_params_to_numpy(tree, cfg16)
    w16, w32 = (_flatten_with_paths(g)[0] for g in (jg16, jg32))
    keys = sorted(w16)
    port, own = _distances(np.concatenate([got[k].ravel() for k in keys]),
                           np.concatenate([_f32(w16[k]).ravel()
                                           for k in keys]),
                           np.concatenate([_f32(w32[k]).ravel()
                                           for k in keys]))
    assert 0 < own and port <= 2 * own, (port, own)


def _tree_like(params, it):
    if isinstance(params, dict):
        return {k: _tree_like(v, it) for k, v in params.items()}
    if isinstance(params, list):
        return [_tree_like(v, it) for v in params]
    return next(it)


def test_adamw_casts_the_step_as_the_reference(twins):
    """One AdamW step of bf16 parameters (float32 moments) against the
    reference's adamw_update at bf16, past warmup with weight decay: each
    parameter within one bf16 ulp, the moments within 1e-6 of each leaf's
    largest."""
    flat = twins["flat"]
    keys = sorted(flat)[:6]
    rng = np.random.default_rng(4)
    gr = {k: (rng.standard_normal(flat[k].shape) * 1e-2).astype(np.float32)
          for k in keys}
    jp = {k: jnp.asarray(flat[k]).astype(jnp.bfloat16) for k in keys}
    jg = {k: jnp.asarray(gr[k]).astype(jnp.bfloat16) for k in keys}
    lr = jnp.float32(3e-3)
    jnew, jopt = jadamw_update(jp, jg, jadamw_init(jp), lr=lr,
                               weight_decay=0.1)
    p = {k: torch.from_numpy(flat[k].copy()).to(BF16) for k in keys}
    g = {k: torch.from_numpy(gr[k]).to(BF16) for k in keys}
    state = adamw_init(p)
    assert all(m.dtype == F32 for m in state.mu)
    new, state = adamw_update(p, g, state, lr=float(lr), weight_decay=0.1)
    for k in keys:
        assert new[k].dtype == BF16
        _assert_bf16_close(new[k], jnew[k], 0.0, f"param {k}")
    for m, k in zip(state.mu, keys):
        w = _f32(jopt.mu[k])
        np.testing.assert_allclose(m.numpy(), w,
                                   atol=1e-6 * np.abs(w).max(), rtol=0)


def test_train_launcher_runs_at_bf16(capsys):
    """launch/train.py --dtype bfloat16 on the CPU: bf16 parameters and a
    finite loss that falls."""
    from repro_torch.launch import train
    state, losses = train.main(["--smoke", "--device", "cpu", "--dtype",
                                "bfloat16", "--steps", "8", "--batch", "2",
                                "--seq", "32", "--log-every", "7"])
    assert {t.dtype for t in leaves(state.params)} == {BF16}
    assert all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
    assert "dtype=bfloat16" in capsys.readouterr().out


# ------------------------------------------------------- the mesh path

_MESH_SCRIPT = r'''
import sys, json
import numpy as np
import torch
import torch.distributed as dist
from datetime import timedelta
torch.set_num_threads(1)
rank, where = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", store=dist.FileStore(where + "/store", 2),
                        rank=rank, world_size=2,
                        timeout=timedelta(seconds=60))
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.kernels import ops
mesh = init_device_mesh("cpu", (2, 1), mesh_dim_names=("data", "model"))
rng = np.random.default_rng(0)
bf = torch.bfloat16


def draw(*shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def shard(t, dim):
    return DTensor.from_local(t, mesh, [Replicate(), Replicate()],
                              run_check=False).redistribute(
        mesh, [Shard(dim), Replicate()])


x, s, g = draw(4, 6, 64).to(bf), (draw(64) + 3).to(bf), draw(4, 6, 64).to(bf)
q, k, v = draw(4, 16, 4, 64).to(bf), draw(4, 16, 2, 64).to(bf), \
    draw(4, 16, 2, 64).to(bf)
dec = torch.sigmoid(draw(4, 5, 8, 4)).to(bf)
inp, c, h0 = draw(4, 5, 8, 4).to(bf), draw(4, 5, 4).to(bf), draw(4, 8, 4)
out = {}
# forwards: each rank's shard through the op, against the whole call
xs = shard(x, 0)
out["rms"] = [ops.rmsnorm(xs, s).full_tensor(), ops.rmsnorm(x, s)]
out["flash"] = [ops.flash_attention(shard(q, 0), shard(k, 0),
                                    shard(v, 0)).full_tensor(),
                ops.flash_attention(q, k, v)]
y, h = ops.selective_scan(shard(dec, 2), inp, c, h0)
out["scan"] = [y.full_tensor(), ops.selective_scan(dec, inp, c, h0)[0]]
# rmsnorm's gradients through the mesh path: x's per rank, scale's summed
xl = xs.detach().requires_grad_(True)
sl = s.clone().requires_grad_(True)
gx, gs = torch.autograd.grad(ops.rmsnorm(xl, sl), (xl, sl), shard(g, 0))
x2, s2 = x.clone().requires_grad_(True), s.clone().requires_grad_(True)
wx, ws = torch.autograd.grad(ops.rmsnorm(x2, s2), (x2, s2), g)
out["grad_x"] = [gx.full_tensor(), wx]
out["grad_scale"] = [gs.full_tensor() if isinstance(gs, DTensor) else gs,
                     ws]
if rank == 0:
    with open(where + "/out.json", "w") as f:
        json.dump({k: {"dtypes": [str(t.dtype) for t in v],
                       "a": v[0].float().tolist(), "b": v[1].float().tolist()}
                   for k, v in out.items()}, f)
dist.barrier()
dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """The bf16 ops through kernels/_mesh.py's local_map wrappers on a
    (2, 1) gloo mesh, two processes (a FileStore in the test's directory),
    beside the same calls on whole tensors."""
    import json
    import os
    import subprocess
    import sys
    where = str(tmp_path_factory.mktemp("bf16_mesh"))
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=src, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _MESH_SCRIPT, str(r),
                               where], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]
    with open(os.path.join(where, "out.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("what", ["rms", "flash", "scan", "grad_x"])
def test_mesh_path_at_bf16_gives_the_whole_call_s_bits(mesh_run, what):
    """Each rank's rows (rmsnorm), batch (flash) or channels (the scan) of
    a bf16 call, through local_map: the dtypes and the bits of the call on
    the whole tensors, and x's gradient too."""
    r = mesh_run[what]
    want = "torch.float32" if what == "scan" else "torch.bfloat16"
    assert r["dtypes"] == [want, want]
    np.testing.assert_array_equal(np.asarray(r["a"]), np.asarray(r["b"]))


def test_mesh_path_sums_the_bf16_scale_gradient(mesh_run):
    """The scale's gradient sums the two ranks' parts where the whole
    call takes one float32 sum: bf16, within two ulps of the largest
    magnitude (each rank's part is rounded to bf16 once, and their sum
    once more; measured one ulp)."""
    r = mesh_run["grad_scale"]
    assert r["dtypes"] == ["torch.bfloat16", "torch.bfloat16"]
    a, b = np.asarray(r["a"], np.float32), np.asarray(r["b"], np.float32)
    assert (np.abs(a - b) <= 2 * _ulp(np.abs(b).max())).all()
