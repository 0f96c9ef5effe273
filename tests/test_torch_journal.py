"""The port's journal and server-state converter against the reference's
(``repro_torch.checkpoint.journal``, ``convert.server_state_*``,
``checkpoint.npz.save_server_state`` / ``load_server_state``).

* ``encode_array`` / ``decode_array`` give the reference's JSON triples and
  read them back bit for bit, in both directions and for every dtype the
  service journals; the port's int32 words go out as ``uint32`` (the
  reference's word dtype) and come back as int32 with the same bits.
* A torn last line is skipped by either package's reader; ``resume=True``
  keeps ``position``; ``entries(start)`` yields the tail.
* A DVQ-AE ``ServerState`` written by the port loads through the
  reference's ``load_pytree`` (HWIO/HIO kernels, AdamW moments under the
  parameters' paths, int32 count and step), and one written by the
  reference loads through the port, every array equal; a state with no
  optimizer writes zero moments and count 0.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import journal as JJ  # noqa: E402
from repro.checkpoint import npz as jnpz  # noqa: E402
from repro.checkpoint.npz import load_pytree, save_pytree  # noqa: E402
from repro.core import octopus as JOC  # noqa: E402
from repro.core.dvqae import DVQAEConfig as JConfig  # noqa: E402
from repro.optim.adamw import AdamWState as JAdamWState  # noqa: E402
from repro_torch import checkpoint as CK  # noqa: E402
from repro_torch.checkpoint import journal as J  # noqa: E402
from repro_torch.convert import (params_from_numpy,  # noqa: E402
                                 params_to_numpy, server_state_from_numpy,
                                 server_state_to_numpy, to_reference_layout)
from repro_torch.core import octopus as OC  # noqa: E402
from repro_torch.core.dvqae import DVQAEConfig  # noqa: E402
from repro_torch.optim.adamw import AdamWState, leaves  # noqa: E402

TINY = dict(kind="image", in_channels=3, hidden=8, latent_dim=8,
            codebook_size=16, n_res_blocks=1)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def arrays(seed=0):
    """Arrays of every dtype the service journals: words (the uint32 bit
    pattern, high bits set), codebooks, labels, ids; odd and empty
    shapes."""
    rng = np.random.default_rng(seed)
    return [
        rng.integers(0, 2 ** 32, (5, 4), dtype=np.uint64).astype(np.uint32),
        rng.standard_normal((16, 8)).astype(np.float32),
        rng.integers(-9, 9, (7,)).astype(np.int32),
        rng.integers(0, 99, (3, 2)).astype(np.int64),
        np.zeros((0, 4), np.uint32),
        rng.standard_normal((2, 3, 4)).astype(np.float64),
    ]


@pytest.mark.parametrize("i", range(6))
def test_encode_decode_array_match_reference_both_ways(i):
    a = arrays()[i]
    got, want = J.encode_array(a), JJ.encode_array(a)
    assert got == want
    assert json.loads(json.dumps(got)) == got
    for out in (J.decode_array(want), JJ.decode_array(got)):
        assert out.dtype == np.asarray(a).dtype
        assert out.shape == np.asarray(a).shape
        assert out.tobytes() == np.asarray(a).tobytes()
    # a tensor journals as its host array
    t = torch.from_numpy(np.array(a))
    assert J.encode_array(t) == want


def test_port_words_journal_as_uint32_and_read_back_int32():
    u = arrays()[0]
    words = torch.from_numpy(u.view(np.int32).copy())
    assert (words < 0).any()                  # the high bit is exercised
    d = J.encode_words(words)
    assert d["dtype"] == "uint32"
    assert d == JJ.encode_array(jnp.asarray(u))
    np.testing.assert_array_equal(JJ.decode_array(d), u)
    back = J.decode_words(JJ.encode_array(u))
    assert back.dtype == np.int32
    assert torch.equal(torch.from_numpy(back), words)
    # an int32 triple (or uint32) reads as the same int32 bits either way
    assert np.array_equal(J.decode_words(J.encode_array(words)),
                          back)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_torn_last_line_skipped_and_resume_keeps_position(tmp_path, writer):
    path = str(tmp_path / "journal.jsonl")
    mod = J if writer == "port" else JJ
    j = mod.Journal(path)
    entries = [{"kind": "tick"}, {"kind": "refusal", "verdict": "rejected",
                                  "reason": "corrupt", "nbytes": 12},
               {"kind": "merge", "version": 1,
                "codebook": J.encode_array(arrays()[1])}]
    assert [j.append(e) for e in entries] == [0, 1, 2]
    assert j.position == 3
    j.close()
    with open(path, "a") as fh:
        fh.write('{"kind": "offer", "words": {"b64": "AAA')   # mid-write
    for reader in (J, JJ):
        assert list(reader.Journal(path, resume=True).entries()) == entries
        assert reader.Journal(path, resume=True).position == 3
        assert list(reader.Journal(path, resume=True).entries(2)) == \
            entries[2:]
    with open(path) as fh:                       # torn line kept on disk
        n_lines = sum(1 for _ in fh)
    # a port journal resumed on the reference's file appends after it
    k = J.Journal(str(tmp_path / "other.jsonl"))
    k.append(entries[0])
    k.close()
    k = J.Journal(str(tmp_path / "other.jsonl"), resume=True)
    assert k.position == 1 and k.append(entries[1]) == 1
    k.close()
    assert list(JJ.Journal(str(tmp_path / "other.jsonl"),
                           resume=True).entries()) == entries[:2]
    assert n_lines == 4
    # resume=False truncates
    assert J.Journal(path).position == 0
    assert list(J.Journal(path, resume=True).entries()) == []


def test_checkpoint_package_exports_the_reference_names():
    assert CK.Journal is J.Journal
    assert CK.encode_array is J.encode_array
    assert CK.decode_array is J.decode_array


# ------------------------------------------------------ server state

def reference_state():
    """The reference's TINY server with moments mu = params + 1, nu =
    params^2 and count and step 2, so that a swapped field shows."""
    s = JOC.server_init(jax.random.PRNGKey(0), JConfig(**TINY))
    return s._replace(
        opt=JAdamWState(mu=jax.tree.map(lambda a: a + 1, s.params),
                        nu=jax.tree.map(jnp.square, s.params),
                        count=jnp.int32(2)),
        step=jnp.int32(2))


def test_server_state_from_reference_save_pytree(tmp_path):
    js = reference_state()
    path = str(tmp_path / "ref.state.npz")
    save_pytree(path, js)
    cfg = DVQAEConfig(**TINY)
    state = CK.load_server_state(path, cfg, device="cpu")
    with np.load(path) as data:
        flat = dict(data)
    assert set(server_state_to_numpy(state)) == set(flat)
    for k, v in server_state_to_numpy(state).items():
        assert v.dtype == flat[k].dtype, k
        np.testing.assert_array_equal(v, flat[k], err_msg=k)
    assert state.step == 2 and state.opt.count == 2
    assert all(not torch.equal(m, torch.zeros_like(m))
               for m in state.opt.mu)
    # moments are in the port's layout, in trainable() leaf order
    keys = list(params_to_numpy(state.params))
    for k, m in zip(keys, state.opt.mu):
        np.testing.assert_array_equal(to_reference_layout(m),
                                      flat[f".opt/.mu/{k}"])


def test_server_state_to_reference_load_pytree(tmp_path):
    js = reference_state()
    cfg = DVQAEConfig(**TINY)
    flat = {k: np.array(v) for k, v in
            jnpz._flatten_with_paths(js.params)[0].items()}
    params = params_from_numpy(flat, cfg, device="cpu")
    rng = np.random.default_rng(3)
    mu = [torch.from_numpy(rng.standard_normal(tuple(p.shape))
                           .astype(np.float32))
          for p in leaves(OC.trainable(params))]
    nu = [m * m for m in mu]
    state = OC.ServerState(params=params,
                           opt=AdamWState(mu=mu, nu=nu, count=5), step=9)
    path = str(tmp_path / "port.state.npz")
    CK.save_server_state(path, state)
    back = load_pytree(path, js)
    want = server_state_to_numpy(state)
    got, _ = jnpz._flatten_with_paths(back)
    assert set(got) == set(want)
    for k, v in got.items():
        assert np.asarray(v).dtype == want[k].dtype, k
        np.testing.assert_array_equal(np.asarray(v), want[k], err_msg=k)
    assert int(back.step) == 9 and int(back.opt.count) == 5
    # and round-trips through the port bit for bit
    again = server_state_from_numpy(want, cfg, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(again.opt.nu, nu))
    assert again.step == 9 and again.opt.count == 5


def test_server_state_without_optimizer_writes_zero_moments(tmp_path):
    cfg = DVQAEConfig(**TINY)
    state = OC.server_init(0, cfg, device="cpu")._replace(opt=None)
    flat = server_state_to_numpy(state)
    moments = [k for k in flat if k.startswith(".opt/.")
               and k != ".opt/.count"]
    assert len(moments) == 2 * len(params_to_numpy(state.params))
    assert all(not flat[k].any() for k in moments)
    assert flat[".opt/.count"] == 0 and flat[".opt/.count"].dtype == np.int32
    path = str(tmp_path / "s.state.npz")
    CK.save_server_state(path, state)
    back = load_pytree(path, JOC.server_init(jax.random.PRNGKey(0),
                                             JConfig(**TINY)))
    assert int(back.opt.count) == 0
    with pytest.raises(ValueError, match="moments"):
        server_state_to_numpy(state._replace(
            opt=AdamWState(mu=[], nu=[], count=0)))
