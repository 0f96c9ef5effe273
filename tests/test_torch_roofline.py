"""The port's roofline modules (``repro_torch.roofline``) against the JAX
package's (``repro.roofline``), the counterparts of
``tests/test_roofline.py``, on the CPU.

The reference parses compiled HLO; the port counts the ops a step
dispatches (``op_analysis.analyze_step``). So the reference's trip-count
test becomes a Python loop of 8 matmuls counting 8 times one: the
undercount its module exists for cannot arise here. The port's qwen3 SMOKE
train step (4 x 64 tokens, remat) is held to 0.8-2.0 x 6ND, as the
reference's is, and within 15% of the reference's ``analyze_hlo`` total on
the same step: the two count the same matmuls; attention differs (XLA
counts the dense (T, T) score products, the port's flash formula the
visible causal pairs) and XLA fuses some elementwise work away.
``model_flops_per_step`` equals the reference's exactly at all 10
configs and 4 shapes; the bound helpers reproduce ``PERF.md`` section 6.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.configs.base import INPUT_SHAPES as JSHAPES  # noqa: E402
from repro.roofline import analysis as JRA  # noqa: E402
from repro.roofline.hlo_analysis import analyze_hlo  # noqa: E402
from repro_torch.configs import (ARCH_IDS, INPUT_SHAPES,  # noqa: E402
                                 get_config, smoke_config)
from repro_torch.roofline import analysis as RA  # noqa: E402
from repro_torch.roofline.op_analysis import (  # noqa: E402
    analyze_step, group_bytes_by_link)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_plain_matmul_flops():
    a, b = torch.ones(128, 256), torch.ones(256, 512)
    t = analyze_step(lambda x, y: x @ y, a, b)
    assert t.flops == 2 * 128 * 256 * 512
    # read and written once: the output's bytes twice; the arguments held
    assert t.hbm_bytes == 2 * 128 * 512 * 4
    assert t.argument_bytes == (128 * 256 + 256 * 512) * 4
    assert t.peak_bytes == t.argument_bytes + 128 * 512 * 4


def test_python_loop_counts_every_pass():
    """The counterpart of the scan trip-count test: 8 matmuls in a loop
    count 8 times one, and the loop's count is recorded."""
    w, x = torch.zeros(8, 64, 64), torch.ones(4, 64)

    def loop(x, w):
        for i in range(8):
            x = torch.tanh(x @ w[i])
        return x

    one = analyze_step(lambda x, w: torch.tanh(x @ w[0]), x, w)
    t = analyze_step(loop, x, w, trip_counts=(8,))
    assert t.flops == 8 * one.flops == 8 * 2 * 4 * 64 * 64
    assert t.while_trip_counts == [8]


def test_convolution_follows_its_formula():
    x, k = torch.ones(2, 3, 16, 16), torch.ones(8, 3, 3, 3)
    t = analyze_step(lambda a, b: torch.nn.functional.conv2d(a, b), x, k)
    assert t.flops == 2 * 2 * 8 * 14 * 14 * 3 * 3 * 3


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_equal_the_reference(arch):
    for name in INPUT_SHAPES:
        assert RA.model_flops_per_step(get_config(arch), INPUT_SHAPES[name]) \
            == JRA.model_flops_per_step(jget_config(arch), JSHAPES[name])


def test_report_fields_are_the_reference_s():
    assert [f.name for f in dataclasses.fields(RA.RooflineReport)] == \
        [f.name for f in dataclasses.fields(JRA.RooflineReport)]


def test_report_bottleneck_selection():
    r = RA.RooflineReport(arch="a", shape="s", mesh="m", chips=256,
                          hlo_flops=RA.PEAK_FLOPS["float32"], hlo_bytes=0.0,
                          collective_bytes=0.0,
                          model_flops=RA.PEAK_FLOPS["float32"] * 256)
    r.finalize()
    assert r.bottleneck == "compute"
    assert r.compute_s == pytest.approx(1.0)
    assert r.useful_ratio == pytest.approx(1.0)
    r = RA.RooflineReport(arch="a", shape="s", mesh="m", chips=256,
                          hlo_flops=1.0, hlo_bytes=RA.HBM_BW,
                          collective_bytes=2 * RA.HBM_BW)
    r.link_bytes = {"nvlink": 0.0, "network": 2 * RA.HBM_BW}
    r.finalize()
    assert r.bottleneck == "collective"
    assert r.memory_s == pytest.approx(1.0)
    assert r.collective_s == pytest.approx(2 * RA.HBM_BW / RA.NETWORK_BW)


def test_links_follow_the_node_of_eight():
    groups = {tuple(range(8)): 10.0, (8, 9): 1.0, tuple(range(16)): 100.0,
              (0, 16, 32): 1000.0}
    assert group_bytes_by_link(groups, RA.NODE_RANKS) == \
        {"nvlink": 11.0, "network": 1100.0}


def test_moe_active_params_used():
    cfg = get_config("qwen3_moe_30b_a3b")
    tr = RA.model_flops_per_step(cfg, INPUT_SHAPES["train_4k"])
    assert tr < 6 * cfg.param_count() * 256 * 4096 / 5


def test_bounds_reproduce_the_perf_table():
    pairs, tf32x3, fp32 = RA.flash_bound_ms(8, 1024, 1024, 16, 8, 128, True)
    assert pairs == 67_174_400
    assert round(tf32x3, 5) == 0.20844 and round(fp32, 5) == 0.51333
    assert RA.flash_bound_ms(2, 6144, 6144, 24, 2, 128, True,
                             4096)[0] == 805_404_672
    assert RA.flash_bound_ms(8, 1500, 1500, 8, 8, 64, False)[0] \
        == 144_000_000
    assert round(RA.rmsnorm_bound_ms(8192, 1024), 6) == 0.020034
    # the backward: 5 products of 2 D a pair, 86.0 GFLOP, 0.52111 ms
    assert round(RA.flash_bound_ms(8, 1024, 1024, 16, 8, 128, True,
                                   backward=True)[1], 5) == 0.52111


def test_train_step_flops_against_6nd_and_the_reference():
    """qwen3 SMOKE, 4 x 64 tokens, remat: the port's count within 0.8-2.0
    x 6ND and within 15% of the reference's analyze_hlo of the same
    step."""
    from repro.models import transformer as JT
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import leaves
    cfg = smoke_config("qwen3_0_6b")
    params = T.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    tokens = torch.zeros((4, 64), dtype=torch.int64)

    def step(params, tokens):
        loss = T.lm_loss(params, cfg, tokens, remat=True)
        return torch.autograd.grad(loss, flat, allow_unused=True,
                                   materialize_grads=True)

    got = analyze_step(step, params, tokens).flops
    est = 6 * cfg.param_count() * 4 * 64
    assert 0.8 < got / est < 2.0, got / est

    jcfg = jsmoke_config("qwen3_0_6b")
    jparams = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    text = jax.jit(lambda p, t: jax.grad(
        lambda p: JT.lm_loss(p, jcfg, t, remat=True))(p)).lower(
        jparams, jnp.zeros((4, 64), jnp.int32)).compile().as_text()
    want = analyze_hlo(text).flops
    assert abs(got / want - 1) < 0.15, (got, want)
    assert math.isclose(est, 6 * jcfg.param_count() * 4 * 64)
    assert np.isfinite(got)
