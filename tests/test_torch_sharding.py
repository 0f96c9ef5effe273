"""The port's sharding rules against the JAX package's, with no ranks.

``repro_torch.distributed.sharding`` computes partition specs on abstract
meshes (``repro_torch.launch.mesh.abstract_mesh``), as the reference's
tests do with ``jax.sharding.AbstractMesh``. For all 10 configs at full
size, on the production meshes (16, 16) and (pod 2, 16, 16) and the small
(2, 2) and (1, 4), in both modes, every leaf's spec equals the
reference's ``param_specs`` of ``jax.eval_shape(init_lm)``: a top-level
leaf's whole, a layer's the reference's stacked spec without its layer
entry (which is never sharded). Also ``cache_specs`` (batches 1, 8 and
32), ``batch_spec``, ``data_axis_size``, ``decode_window`` and the meta
tensors of ``params_shape``, ``state_shape`` and ``caches_shape``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import INPUT_SHAPES as JSHAPES  # noqa: E402
from repro.distributed import sharding as jshd  # noqa: E402
from repro.distributed import steps as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import INPUT_SHAPES  # noqa: E402
from repro_torch.configs.registry import ARCH_IDS  # noqa: E402
from repro_torch.convert import _flatten_specs  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.distributed import steps as S  # noqa: E402
from repro_torch.launch.mesh import abstract_mesh  # noqa: E402

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model"))}
CACHE_LEN = 4096


def _jmesh(name):
    sizes, names = MESHES[name]
    try:
        return jax.sharding.AbstractMesh(sizes, names)
    except TypeError:                    # jax 0.4.x: ((name, size), ...)
        return jax.sharding.AbstractMesh(tuple(zip(names, sizes)))


def _mesh(name):
    return abstract_mesh(*MESHES[name])


_SHAPES = {}


def _shapes(arch):
    """(the reference's eval_shape of init_lm, the port's meta tree)."""
    if arch not in _SHAPES:
        _SHAPES[arch] = (JS.params_shape(jget_config(arch)),
                         S.params_shape(get_config(arch)))
    return _SHAPES[arch]


def _ref_flat(tree):
    """Path-keyed leaves of a reference tree ("segments/0/mixer/wq")."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
    )[0]:
        out["/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path)] = leaf
    return out


def _norm(spec):
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e
                 for e in spec)


@pytest.mark.parametrize("mode", ["train", "infer"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_the_reference(arch, mesh, mode):
    jshape, shape = _shapes(arch)
    want = _ref_flat(jshd.param_specs(jshape, jget_config(arch),
                                      _jmesh(mesh), mode=mode))
    got = _flatten_specs(shd.param_specs(shape, get_config(arch),
                                         _mesh(mesh), mode=mode))
    seen = set()
    for key, spec in got.items():
        if isinstance(key, tuple):       # a layer's: the stacked spec less
            key, _ = key                 # its layer entry
            w = _norm(want[key])
            assert w[:1] in ((), (None,)), (key, w)
            assert _norm(spec) == w[1:], (key, spec, w)
        else:
            assert _norm(spec) == _norm(want[key]), (key, spec, want[key])
        seen.add(key)
    assert seen == set(want)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_the_reference(arch, mesh):
    jcfg, cfg = jget_config(arch), get_config(arch)
    for batch in (1, 8, 32):
        jc = jax.eval_shape(lambda: JT.init_caches(jcfg, batch, CACHE_LEN))
        want = jshd.cache_specs(jc, jcfg, _jmesh(mesh), batch=batch)
        got = shd.cache_specs(S.caches_shape(cfg, batch, CACHE_LEN), cfg,
                              _mesh(mesh), batch=batch)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g._fields == w._fields
            for f, gs, ws in zip(g._fields, g, w):
                assert _norm(gs) == _norm(ws), (batch, f, gs, ws)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_spec_and_data_axis_size(mesh):
    assert _norm(shd.batch_spec(_mesh(mesh))) == \
        _norm(jshd.batch_spec(_jmesh(mesh)))
    assert shd.data_axis_size(_mesh(mesh)) == \
        jshd.data_axis_size(_jmesh(mesh))
    assert S._dp_size(_mesh(mesh)) == JS._dp_size(_jmesh(mesh))
    assert shd.data_axis_size(None) == jshd.data_axis_size(None) == 1


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_window(arch, shape):
    assert S.decode_window(get_config(arch), INPUT_SHAPES[shape]) == \
        JS.decode_window(jget_config(arch), JSHAPES[shape])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_params_shape_is_meta_and_the_reference_shapes(arch):
    jshape, shape = _shapes(arch)
    want = _ref_flat(jshape)
    flat = _flatten_specs(shape)
    for key, t in flat.items():
        assert t.device.type == "meta"
        if isinstance(key, tuple):
            key, j = key
            assert (want[key].shape[0] > j
                    and tuple(t.shape) == tuple(want[key].shape[1:])), key
        else:
            assert tuple(t.shape) == tuple(want[key].shape), key
        assert want[key].dtype == jnp.float32 and t.dtype == torch.float32
    assert {k[0] if isinstance(k, tuple) else k for k in flat} == set(want)


def test_state_and_cache_shapes_allocate_nothing():
    cfg = get_config("deepseek-v3-671b")
    state = S.state_shape(cfg)
    tensors = S.leaves(state.params) + list(state.opt.mu) + list(state.opt.nu)
    assert all(t.device.type == "meta" for t in tensors)
    assert sum(t.numel() for t in S.leaves(state.params)) > 600e9
    caches = S.caches_shape(cfg, 8, 32768)
    assert all(t.device.type == "meta" for c in caches for t in c)


@pytest.mark.parametrize("mesh", ["2x2", "pod2x16x16"])
def test_state_specs_give_the_moments_their_parameters_specs(mesh):
    cfg = get_config("qwen3-0.6b")
    specs = S.state_specs(cfg, _mesh(mesh))
    flat = S._spec_leaves(specs.params)
    assert specs.opt.mu == flat and specs.opt.nu == flat
    assert len(flat) == len(S.leaves(S.params_shape(cfg)))
    assert specs.step == shd.P() and specs.opt.count == shd.P()


def test_a_spec_on_the_layer_axis_raises():
    with pytest.raises(ValueError, match="layer axis"):
        shd._unstacked(shd.P("model", None), ("segments", "0", "x"))
    with pytest.raises(ValueError, match="two dims"):
        from torch.distributed.device_mesh import DeviceMesh  # noqa: F401

        class Fake:
            mesh_dim_names = ("data", "model")
        shd.to_placements(shd.P("model", "model"), Fake())


def test_to_placements():
    from torch.distributed.tensor import Replicate, Shard

    class Fake:
        mesh_dim_names = ("pod", "data", "model")
    assert shd.to_placements(shd.P(("pod", "data"), None, "model"),
                             Fake()) == (Shard(0), Shard(0), Shard(2))
    assert shd.to_placements(shd.P(), Fake()) == (Replicate(),) * 3
    assert shd.to_placements(shd.P(None, "data"), Fake()) == (
        Replicate(), Shard(1), Replicate())


def test_shd_to_gives_each_spec_its_placements():
    from torch.distributed.tensor import Replicate, Shard

    class Fake:
        mesh_dim_names = ("data", "model")
    cfg = get_config("qwen3-0.6b")
    specs = S.state_specs(cfg, _mesh("2x2"))
    placed = S.shd_to(specs.params, Fake())
    assert placed["embed"] == (Replicate(), Shard(0))
    mixer = placed["segments"][0][0]["mixer"]
    assert mixer["wq"] == (Replicate(), Shard(1))      # column-parallel
    assert mixer["wo"] == (Replicate(), Shard(0))      # row-parallel
    assert placed["final_norm"]["scale"] == (Replicate(), Replicate())


def test_mmap_npz_maps_stored_arrays_and_reads_compressed_ones(tmp_path):
    from repro_torch.convert import mmap_npz
    rng = np.random.default_rng(0)
    arrays = {"a/b": rng.standard_normal((3, 5)).astype(np.float32),
              "c": np.arange(7, dtype=np.int32),
              "f": np.asfortranarray(rng.standard_normal((4, 2)))}
    np.savez(tmp_path / "s.npz", **arrays)
    np.savez_compressed(tmp_path / "z.npz", **arrays)
    for name, mapped in (("s", True), ("z", False)):
        got = mmap_npz(str(tmp_path / f"{name}.npz"))
        assert sorted(got) == sorted(arrays)
        for k, v in arrays.items():
            assert isinstance(got[k], np.memmap) == mapped, (name, k)
            np.testing.assert_array_equal(got[k], v)
            np.testing.assert_array_equal(got[k][1:], v[1:])
