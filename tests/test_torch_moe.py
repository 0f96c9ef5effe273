"""Port parity: the MoE router and flat dispatch against ``repro.nn.moe``
on shared parameters and numpy inputs.

Off a mesh the reference takes its flat (E*C, d) dispatch, which the port
implements; the configs here are the jamba SMOKE config (4 experts, top-2,
capacity factor 4.0: dropless) and variants of it that drop at capacity,
score with sigmoids, or carry a shared expert.

Tolerances: integer outputs (expert choices, positions in expert) are
bit-exact; gates and probabilities 1e-6; the layer's output and its aux
loss 2e-5 (float32 products of width up to 512 summed in another order).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.nn import moe as jmoe  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.nn import moe  # noqa: E402

ARCH = "jamba_v0_1_52b"
TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small CPU tensors run far faster on one thread than on many."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(**moe_kw):
    """The jamba SMOKE config with its MoE fields replaced, both
    packages."""
    out = []
    for get in (jsmoke_config, smoke_config):
        cfg = get(ARCH)
        out.append(cfg.replace(moe=dataclasses.replace(cfg.moe, **moe_kw)))
    return out


VARIANTS = {
    "smoke": {},
    "drops": dict(n_experts=8, capacity_factor=1.0),
    "sigmoid_shared": dict(router_scoring="sigmoid", n_shared_experts=1,
                           d_ff_expert=128),
}


def _twins(variant, seed=0):
    jcfg, cfg = _configs(**VARIANTS[variant])
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    return jcfg, jp, cfg, tp


def _x(seed, B, T_, d):
    return np.random.default_rng(seed).standard_normal(
        (B, T_, d)).astype(np.float32)


# ----------------------------------------------------------------- router

@pytest.mark.parametrize("scoring", ["softmax", "sigmoid"])
def test_router_topk_matches_reference(scoring):
    logits = np.random.default_rng(0).standard_normal((37, 8)) \
        .astype(np.float32)
    gate, idx, probs = moe.router_topk(torch.from_numpy(logits), 2, scoring)
    jg, ji, jpr = jmoe.router_topk(jnp.asarray(logits), 2, scoring)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_allclose(gate.numpy(), np.asarray(jg), atol=1e-6)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jpr), atol=1e-6)


@pytest.mark.parametrize("case", ["random", "one_expert", "empty_experts"])
def test_positions_in_expert_bit_exact(case):
    rng = np.random.default_rng(1)
    ids = {"random": rng.integers(0, 8, 200),
           "one_expert": np.full(33, 5),
           "empty_experts": rng.choice([0, 7], 64)}[case].astype(np.int32)
    got = moe.positions_in_expert(torch.from_numpy(ids).long(), 8)
    want = jmoe.positions_in_expert(jnp.asarray(ids), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_load_balance_loss_matches_reference():
    rng = np.random.default_rng(2)
    probs = rng.dirichlet(np.ones(8), 50).astype(np.float32)
    idx = rng.integers(0, 8, (50, 2)).astype(np.int32)
    got = moe.load_balance_loss(torch.from_numpy(probs),
                                torch.from_numpy(idx).long(), 8)
    want = jmoe.load_balance_loss(jnp.asarray(probs), jnp.asarray(idx), 8)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ------------------------------------------------------------------ layer

def test_init_moe_matches_reference_layout():
    for variant in VARIANTS:
        jcfg, jp, cfg, _ = _twins(variant)
        mine = moe.init_moe(cfg, generator=torch.Generator().manual_seed(0))
        assert jax.tree.map(lambda t: tuple(t.shape), mine) == \
            jax.tree.map(lambda a: tuple(a.shape), jp)
        wo = mine["experts"]["wo"]                   # (E, d_ff_expert, d)
        assert float(wo.abs().max()) <= wo.shape[1] ** -0.5
        assert float(wo.abs().max()) > 0.9 * wo.shape[1] ** -0.5


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("T_", [1, 16])
def test_moe_apply_matches_reference(variant, T_):
    """T = 16 dispatches at capacity, T = 1 (a decode step) dropless."""
    jcfg, jp, cfg, tp = _twins(variant)
    x = _x(T_, 3, T_, cfg.d_model)
    out = moe.moe_apply(tp, cfg, torch.from_numpy(x))
    jout = jmoe.moe_apply(jp, jcfg, jnp.asarray(x))
    np.testing.assert_allclose(out.y.numpy(), np.asarray(jout.y), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(float(out.aux_loss), float(jout.aux_loss),
                               atol=TOL, rtol=TOL)


def test_drops_at_capacity_and_decode_is_dropless():
    """The "drops" variant really drops assignments at T > 1 (so the test
    above covers dropping), and one token at a time gives the outputs of
    an unbounded capacity."""
    jcfg, jp, cfg, tp = _twins("drops")
    m = cfg.moe
    x = _x(16, 3, 16, cfg.d_model)
    xf = torch.from_numpy(x).reshape(-1, cfg.d_model)
    _, idx, _ = moe.router_topk(xf @ tp["router"], m.n_experts_per_tok)
    A = idx.numel()
    C = max(m.n_experts_per_tok, round(A * m.capacity_factor / m.n_experts))
    pos = moe.positions_in_expert(idx.reshape(-1), m.n_experts)
    assert int((pos >= C).sum()) > 0
    # a token whose assignments were all kept gets the same output alone
    keep = (pos < C).reshape(-1, m.n_experts_per_tok).all(-1)
    d = cfg.d_model
    batch = moe.moe_apply(tp, cfg, torch.from_numpy(x)).y.reshape(-1, d)
    alone = moe.moe_apply(tp, cfg, torch.from_numpy(x).reshape(-1, 1, d)
                          ).y.reshape(-1, d)
    np.testing.assert_allclose(batch[keep].numpy(), alone[keep].numpy(),
                               atol=TOL, rtol=TOL)
    assert not torch.allclose(batch[~keep], alone[~keep], atol=TOL)
