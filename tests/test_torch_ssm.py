"""Port parity: the selective scan and the Mamba mixer against the JAX
package on shared numpy inputs.

The JAX side runs as its own tests run it off-TPU: the Pallas kernel in
interpret mode, beside ``repro.kernels.ref.selective_scan_ref`` and the
mixer's chunked ``_selective_scan_fused``. On the CPU the port's ``ops``
runs the plain sequential loop in ``repro_torch.kernels.ref``; the CUDA
kernel is held against it on the card by ``chip_smoke.py``.

Tolerances: the scan 1e-5 absolute and relative (float32 products summed
in another order: the reference's associative scan regroups the
recurrence, its einsum sums over N in another order); the causal conv
1e-6; the mixer's outputs and caches 2e-5 (three products of width up to
512 summed in another order, then exp and softplus).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.selective_scan import selective_scan_pallas  # noqa: E402
from repro.nn import attention as jattn  # noqa: E402
from repro.nn import layers as jlayers  # noqa: E402
from repro.nn import ssm as jssm  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.selective_scan import (MAX_STATE,  # noqa: E402
                                                selective_scan_cuda)
from repro_torch.nn import attention, layers, ssm  # noqa: E402

ARCH = "jamba_v0_1_52b"
SCAN_TOL = 1e-5
MIXER_TOL = 2e-5
# the shapes of the reference's own kernel tests (tests/test_kernels.py)
SHAPES = [(1, 16, 8, 4), (2, 40, 24, 8), (2, 128, 64, 16), (1, 200, 48, 16)]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small CPU tensors run far faster on one thread than on many."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scan_inputs(seed, b, t, di, n, *, near_one=False):
    """decay in (0, 1) (a sigmoid of N(0, 1), or within 1e-3 of 1), inp,
    c and h0 N(0, 1), float32."""
    rng = np.random.default_rng(seed)
    if near_one:
        decay = np.exp(-rng.uniform(0, 1e-3, (b, t, di, n)))
    else:
        decay = 1 / (1 + np.exp(-rng.standard_normal((b, t, di, n))))
    return [a.astype(np.float32) for a in (
        decay, rng.standard_normal((b, t, di, n)),
        rng.standard_normal((b, t, n)), rng.standard_normal((b, di, n)))]


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol, err_msg=what)


# ------------------------------------------------------------------- scan

@pytest.mark.parametrize("against", ["ref", "pallas", "fused"])
@pytest.mark.parametrize("shape", SHAPES)
def test_selective_scan_matches_reference(shape, against):
    """The plain version against the reference's sequential loop, its
    Pallas kernel (interpret mode) and the mixer's chunked scan."""
    arrays = _scan_inputs(sum(shape), *shape)
    y, h = ops.selective_scan(*_t(*arrays))
    ja = [jnp.asarray(a) for a in arrays]
    if against == "ref":
        yw, hw = jref.selective_scan_ref(*ja)
    elif against == "pallas":
        yw, hw = selective_scan_pallas(*ja, interpret=True)
    else:
        yw, hw = jssm._selective_scan_fused(*ja, chunk=16)
    assert tuple(y.shape) == shape[:3] and tuple(h.shape) == (
        shape[0], shape[2], shape[3])
    _close(y.numpy(), yw, SCAN_TOL, "y")
    _close(h.numpy(), hw, SCAN_TOL, "h_last")


def test_selective_scan_long_memory_matches_reference():
    """Decays within 1e-3 of 1 over 512 steps: the state sums hundreds of
    terms, as in a Mamba channel of long memory."""
    arrays = _scan_inputs(7, 1, 512, 16, 16, near_one=True)
    y, h = ops.selective_scan(*_t(*arrays))
    yw, hw = jref.selective_scan_ref(*[jnp.asarray(a) for a in arrays])
    scale = float(np.abs(np.asarray(hw)).max())
    _close(y.numpy() / scale, np.asarray(yw) / scale, SCAN_TOL, "y")
    _close(h.numpy() / scale, np.asarray(hw) / scale, SCAN_TOL, "h_last")


def test_one_step_scan_is_the_decode_step():
    """T = 1 from a carried state is the reference mixer's decode update
    ``h = decay * h0 + inp``, ``y = <h, C>``."""
    decay, inp, c, h0 = _scan_inputs(3, 4, 1, 32, 8)
    y, h = ops.selective_scan(*_t(decay, inp, c, h0))
    hw = decay[:, 0] * h0 + inp[:, 0]
    _close(h.numpy(), hw, 1e-6)
    _close(y.numpy(), np.einsum("bdn,bn->bd", hw, c[:, 0])[:, None], 1e-5)


@pytest.mark.parametrize("case", ["rank", "inp", "c", "h0", "dtype",
                                  "contiguous", "empty_time"])
def test_scan_rejects_bad_arguments(case):
    """The checks the CUDA wrapper runs before it launches; ``ops`` runs
    them for the plain version too."""
    decay, inp, c, h0 = _t(*_scan_inputs(1, 2, 5, 6, 4))
    args = {"rank": (decay[0], inp[0], c, h0),
            "inp": (decay, inp[:, :4], c, h0),
            "c": (decay, inp, c[:, :, :3], h0),
            "h0": (decay, inp, c, h0[:1]),
            "dtype": (decay.double(), inp.double(), c.double(), h0.double()),
            "contiguous": (decay, inp, c, h0.transpose(1, 2).contiguous()
                           .transpose(1, 2)),
            "empty_time": (decay[:, :0], inp[:, :0], c[:, :0], h0)}[case]
    with pytest.raises((ValueError, TypeError)):
        ops.selective_scan(*args)
    with pytest.raises((ValueError, TypeError)):
        selective_scan_cuda(*args)


def test_cuda_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        selective_scan_cuda(*_t(*_scan_inputs(1, 1, 3, 4, 4)))


@pytest.mark.cuda
def test_cuda_kernel_checks_and_matches_plain():
    """On a card: the kernel against the plain version at a ragged shape,
    and the refusals only the card can show (N past the register budget,
    tensors on two devices)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")
    arrays = _t(*_scan_inputs(2, 2, 77, 130, 5))
    y, h = selective_scan_cuda(*(a.cuda() for a in arrays))
    yw, hw = ref.selective_scan_ref(*arrays)
    _close(y.cpu().numpy(), yw.numpy(), SCAN_TOL)
    _close(h.cpu().numpy(), hw.numpy(), SCAN_TOL)
    big = [a.cuda() for a in _t(*_scan_inputs(1, 1, 2, 4, MAX_STATE + 1))]
    with pytest.raises(ValueError, match="N <="):
        selective_scan_cuda(*big)
    decay, inp, c, h0 = arrays
    with pytest.raises(ValueError, match="share a device"):
        selective_scan_cuda(decay.cuda(), inp.cuda(), c, h0.cuda())


def test_plain_scan_counts_no_launch():
    ops.reset_launches()
    ops.selective_scan(*_t(*_scan_inputs(1, 1, 4, 8, 4)))
    assert ops.LAUNCHES["selective_scan"] == 0


# ------------------------------------------------------------ causal conv

@pytest.mark.parametrize("T_", [1, 2, 9])
def test_causal_conv1d_matches_reference(T_):
    rng = np.random.default_rng(T_)
    x = rng.standard_normal((2, T_, 6)).astype(np.float32)
    k = rng.standard_normal((4, 6)).astype(np.float32)
    got = layers.causal_conv1d({"kernel": torch.from_numpy(k)},
                               torch.from_numpy(x))
    want = jlayers.causal_conv1d({"kernel": jnp.asarray(k)}, jnp.asarray(x))
    assert tuple(got.shape) == x.shape
    _close(got.numpy(), want, 1e-6)


# ------------------------------------------------------------------ mixer

@pytest.fixture(scope="module")
def mixer():
    """Layer parameters of the reference's init_mamba at the jamba SMOKE
    config (d 256, di 512, N 8, K 4, dt_rank 16), and the same in the
    port."""
    jcfg, cfg = jsmoke_config(ARCH), smoke_config(ARCH)
    jp = jssm.init_mamba(jax.random.PRNGKey(5), jcfg)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    return jcfg, jp, cfg, tp


def test_init_mamba_matches_reference_layout(mixer):
    jcfg, jp, cfg, _ = mixer
    mine = ssm.init_mamba(cfg, generator=torch.Generator().manual_seed(0))
    shapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    assert jax.tree.map(lambda t: tuple(t.shape), mine) == shapes
    np.testing.assert_allclose(mine["A_log"].numpy(), np.asarray(jp["A_log"]),
                               rtol=1e-7)
    assert bool((mine["D"] == 1).all())
    dt = torch.nn.functional.softplus(mine["dt_bias"])
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5)
    assert float(dt.max()) <= 0.1 * (1 + 1e-5)
    assert ssm.dt_rank(cfg) == jssm.dt_rank(jcfg) == 16


@pytest.mark.parametrize("T_", [1, 2, 24])
def test_mamba_prefill_matches_reference(mixer, T_):
    """Outputs and both cache fields; T = 2 is shorter than the conv
    window, so the cached window is left-padded."""
    jcfg, jp, cfg, tp = mixer
    x = np.random.default_rng(T_).standard_normal(
        (2, T_, cfg.d_model)).astype(np.float32)
    out, cache = ssm.mamba(tp, cfg, torch.from_numpy(x))
    jout, jcache = jssm.mamba(jp, jcfg, jnp.asarray(x))
    _close(out.numpy(), jout, MIXER_TOL, "out")
    _close(cache.h.numpy(), jcache.h, MIXER_TOL, "h")
    _close(cache.conv.numpy(), jcache.conv, MIXER_TOL, "conv")


def test_mamba_decode_matches_reference_and_prefill(mixer):
    """Twelve decode steps from a zero cache, each against the reference's
    decode step (outputs, state and conv window) and against the port's
    prefill over the same positions."""
    jcfg, jp, cfg, tp = mixer
    S_ = 12
    x = np.random.default_rng(11).standard_normal(
        (3, S_, cfg.d_model)).astype(np.float32)
    full, full_cache = ssm.mamba(tp, cfg, torch.from_numpy(x))
    cache = ssm.init_mamba_cache(cfg, 3, device="cpu")
    jcache = jssm.init_mamba_cache(jcfg, 3)
    for t in range(S_):
        out, cache = ssm.mamba(tp, cfg, torch.from_numpy(x[:, t:t + 1]),
                               cache=cache)
        jout, jcache = jssm.mamba(jp, jcfg, jnp.asarray(x[:, t:t + 1]),
                                  cache=jcache, cache_index=jnp.int32(t))
        _close(out.numpy(), jout, MIXER_TOL, f"out {t}")
        _close(cache.h.numpy(), jcache.h, MIXER_TOL, f"h {t}")
        _close(cache.conv.numpy(), jcache.conv, MIXER_TOL, f"conv {t}")
        _close(out.numpy()[:, 0], full.numpy()[:, t], MIXER_TOL, f"pre {t}")
    _close(cache.h.numpy(), full_cache.h.numpy(), MIXER_TOL)
    _close(cache.conv.numpy(), full_cache.conv.numpy(), MIXER_TOL)


@pytest.mark.parametrize("kind", ["kv", "mamba"])
def test_cache_initialisers_default_to_the_card(mixer, kind):
    """init_cache and init_mamba_cache run on cuda unless asked otherwise:
    with no device they raise on a host without a GPU; ``device="cpu"``
    gives zero CPU tensors of the reference's shapes and types."""
    jcfg, _, cfg, _ = mixer
    if kind == "kv":
        make = lambda **kw: attention.init_cache(cfg, 2, 5, **kw)  # noqa: E731
        want = jattn.init_cache(jcfg, 2, 5)
    else:
        make = lambda **kw: ssm.init_mamba_cache(cfg, 2, **kw)  # noqa: E731
        want = jssm.init_mamba_cache(jcfg, 2)
    cache = make(device="cpu")
    for t, w in zip(cache, want):
        assert t.device.type == "cpu" and not t.any()
        assert tuple(t.shape) == tuple(w.shape)
        assert str(t.dtype).split(".")[-1] == str(w.dtype)
    if torch.cuda.is_available():
        assert all(t.device.type == "cuda" for t in make())
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
