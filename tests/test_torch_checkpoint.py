"""Port parity: train-state checkpoints in the reference's .npz layout.

A TrainState saved by the port loads through the JAX package's
``load_pytree``, and one saved by the JAX package loads through the
port's, with every array equal; versioned ``save`` prunes to ``keep`` and
``restore`` picks the latest, as the reference's do. States come from the
qwen3 and jamba ``SMOKE`` configs (jamba: five segments, Mamba and MoE
leaves), with moments and counts made non-zero so that a swapped field
shows.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import npz as jnpz  # noqa: E402
from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.distributed import steps as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim.adamw import AdamWState as JAdamWState  # noqa: E402
from repro_torch.checkpoint import npz  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.distributed import steps as S  # noqa: E402

ARCHS = ("qwen3-0.6b", "jamba-v0.1-52b")


def _states(arch):
    """The same train state in both packages: the reference's SMOKE
    weights, mu = params + 1, nu = params^2, count and step 7."""
    jp = JT.init_lm(jax.random.PRNGKey(0), jsmoke_config(arch))
    jstate = JS.TrainState(
        params=jp, opt=JAdamWState(mu=jax.tree.map(lambda a: a + 1, jp),
                                   nu=jax.tree.map(jnp.square, jp),
                                   count=jnp.int32(7)),
        step=jnp.int32(7))
    flat, _ = jnpz._flatten_with_paths(jp)
    state = S.init_train_state(lm_params_from_numpy(flat, smoke_config(arch),
                                                    device="cpu"))
    with torch.no_grad():
        mu = [p + 1 for p in S.leaves(state.params)]
        nu = [p * p for p in S.leaves(state.params)]
    return jstate, state._replace(
        opt=state.opt._replace(mu=mu, nu=nu, count=7), step=7)


def _blank(state):
    """``state``'s structure with zeros, for loading into."""
    with torch.no_grad():
        params = npz._like_params(state.params, [
            torch.zeros_like(p).requires_grad_(True)
            for p in S.leaves(state.params)])
    return S.init_train_state(params)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_checkpoint_loads_in_reference(arch, tmp_path):
    jstate, state = _states(arch)
    path = str(tmp_path / "port.npz")
    npz.save_pytree(path, state)
    loaded = jnpz.load_pytree(path, jax.tree.map(jnp.zeros_like, jstate))
    got, _ = jnpz._flatten_with_paths(loaded)
    want, _ = jnpz._flatten_with_paths(jstate)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert sorted(np.load(path).files) == sorted(want)


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_checkpoint_loads_in_port(arch, tmp_path):
    jstate, state = _states(arch)
    path = str(tmp_path / "ref.npz")
    jnpz.save_pytree(path, jstate)
    loaded = npz.load_pytree(path, _blank(state))
    assert loaded.step == 7 and loaded.opt.count == 7
    assert isinstance(loaded.opt.mu, list)
    assert all(p.requires_grad for p in S.leaves(loaded.params))
    got, want = npz.to_arrays(loaded), npz.to_arrays(state)
    assert sorted(got) == sorted(want) == sorted(np.load(path).files)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_load_refuses_a_shape_that_does_not_fit(tmp_path):
    _, state = _states("qwen3-0.6b")
    path = str(tmp_path / "s.npz")
    npz.save_pytree(path, state)
    like = _blank(state)
    like.params["embed"] = torch.zeros(3, 5)
    with pytest.raises(ValueError, match="embed: shape"):
        npz.load_pytree(path, like)


def test_save_prunes_and_restore_picks_latest_as_reference(tmp_path):
    """Steps 1-5 saved with keep=3, by both packages into their own
    directories: the same checkpoints remain (and in the port's directory
    nothing else), the sidecars carry the metadata and the step, and
    restore returns the newest state."""
    jstate, state = _states("qwen3-0.6b")
    for step in range(1, 6):
        with torch.no_grad():
            for p in S.leaves(state.params):
                p.add_(1.0)
        npz.save(str(tmp_path / "port"), step, state._replace(step=step),
                 metadata={"arch": "qwen3-smoke"})
        jnpz.save(str(tmp_path / "ref"), step, jstate._replace(
            step=jnp.int32(step)), metadata={"arch": "qwen3-smoke"})
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    # the reference also leaves each save's empty temporary file behind
    # (np.savez appends ".npz" to the name it is given): not compared
    assert names == sorted(p.name for p in (tmp_path / "ref").iterdir()
                           if p.name.startswith("step_"))
    assert names == [f"step_{s:08d}.npz{x}" for s in (3, 4, 5)
                     for x in ("", ".json")]
    side = json.loads((tmp_path / "port" / "step_00000005.npz.json")
                      .read_text())
    assert side == {"arch": "qwen3-smoke", "step": 5}
    restored, at = npz.restore(str(tmp_path / "port"), _blank(state))
    assert at == 5 and restored.step == 5
    got, want = npz.to_arrays(restored), npz.to_arrays(
        state._replace(step=5))
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert npz.restore(str(tmp_path / "none"), state) == (None, 0)
    (tmp_path / "empty").mkdir()
    assert npz.restore(str(tmp_path / "empty"), state) == (None, 0)
