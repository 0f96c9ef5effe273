"""Port parity of the §3.1 federated baselines and the §2.8 byte model:
``repro_torch.core.{fedavg,overheads}`` against ``repro.core.{fedavg,
overheads}``.

The byte formulas are integer arithmetic and equal. FedAvg draws its
minibatches and DP noise from ``torch.Generator`` s where the reference
folds ``jax.random`` keys, so the local step is held to a JAX ``grad`` +
``adamw_update`` step on the port's own minibatch (within 1e-5), the clip
and the aggregation on the same deltas, and the batched form to the
sequential one bit for bit."""
import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import downstream as JDS  # noqa: E402
from repro.core import fedavg as JF  # noqa: E402
from repro.core import overheads as JO  # noqa: E402
from repro.optim.adamw import adamw_init as j_adamw_init  # noqa: E402
from repro.optim.adamw import adamw_update as j_adamw_update  # noqa: E402
from repro_torch.convert import (conv_classifier_from_numpy,  # noqa: E402
                                 to_reference_layout)
from repro_torch.core import fedavg as F  # noqa: E402
from repro_torch.core import overheads as O  # noqa: E402
from repro_torch.core.downstream import ConvClassifier, accuracy  # noqa: E402
from repro_torch.data.federated import partition_stacked  # noqa: E402
from repro_torch.data.synthetic import LabeledData, make_images  # noqa: E402

torch.set_num_threads(1)


# ------------------------------------------------------------ the byte model

COMM = [dict(n_clients=c, model_bytes=m, n_samples=n, n_epochs=e,
             code_bytes_per_sample=z, smashed_bytes_per_sample=s,
             client_frac_params=eta, codebook_bytes=b,
             codebook_sync_rounds=pi, downstream_model_bytes=a)
        for c, m, n, e, z, s, eta, b, pi, a in [
            (10, 1_000_000, 60_000, 20, 512, 0, 1.0, 0, 10, 0),
            (100, 4_400_000, 50_000, 50, 64, 8192, 0.3, 65_536, 5, 120_000),
            (1, 7, 1, 1, 1, 1, 0.5, 1, 1, 1),
            (1000, 12_345_678, 1_000_000, 3, 3, 100, 0.01, 256, 0, 1),
        ]]


@pytest.mark.parametrize("kw", COMM)
def test_overheads_match_reference(kw):
    c, jc = O.CommModel(**kw), JO.CommModel(**kw)
    assert dataclasses.asdict(c) == dataclasses.asdict(jc)
    for name in ("federated_bytes", "split_learning_bytes", "octopus_bytes",
                 "comparison_table"):
        assert getattr(O, name)(c) == getattr(JO, name)(jc), name
    for up, sel, mult in itertools.product((0.01, 0.1, 1.0), (0.1, 0.5),
                                           (1.0, 3.0)):
        kwg = dict(up_compress=up, selected_frac=sel, round_multiplier=mult)
        assert O.gradient_compressed_fl_bytes(c, **kwg) == \
            JO.gradient_compressed_fl_bytes(jc, **kwg)
    for n_tasks in (1, 3, 10):
        assert O.multi_task_bytes(c, n_tasks) == \
            JO.multi_task_bytes(jc, n_tasks)


def test_code_bytes_match_reference():
    for P, K, S in itertools.product((1, 7, 64, 1000), (1, 2, 3, 16, 100,
                                                        256, 4096), (1, 2, 4)):
        assert O.code_bytes(P, K, S) == JO.code_bytes(P, K, S)


# -------------------------------------------------------------- DP + FedAvg

def random_delta(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=s) * scale).astype(np.float32)
            for s in ((3, 3, 3, 8), (8,), (16, 4), (4,))]


@pytest.mark.parametrize("clip,scale", [(1.0, 1.0), (0.5, 0.01), (3.0, 2.0)])
def test_privatize_delta_clip_matches_reference(clip, scale):
    delta = random_delta(int(clip * 10), scale)
    got = F._privatize_delta(torch.Generator().manual_seed(0),
                             [torch.from_numpy(d) for d in delta],
                             F.FedConfig(dp_clip=clip, dp_noise=0.0))
    want = JF._privatize_delta(jax.random.PRNGKey(0),
                               [jnp.asarray(d) for d in delta],
                               JF.FedConfig(dp_clip=clip, dp_noise=0.0))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-9)
    norm = np.sqrt(sum(float((g.double() ** 2).sum()) for g in got))
    assert norm <= clip * (1 + 1e-6)
    # the noise: dp_noise * dp_clip * N(0, 1) from the generator, leaf by leaf
    noisy = F._privatize_delta(torch.Generator().manual_seed(1),
                               [torch.from_numpy(d) for d in delta],
                               F.FedConfig(dp_clip=clip, dp_noise=0.5))
    g = torch.Generator().manual_seed(1)
    for n, c in zip(noisy, got):
        assert torch.equal(n, c + 0.5 * clip * torch.randn(c.shape,
                                                           generator=g))
    same = F._privatize_delta(None, [torch.from_numpy(d) for d in delta],
                              F.FedConfig())
    assert all(torch.equal(a, torch.from_numpy(b))
               for a, b in zip(same, delta))


def test_aggregation_matches_reference():
    sizes = [3, 5, 8]
    deltas = [random_delta(i) for i in range(3)]
    w = np.asarray(sizes, np.float32)
    got = F._aggregate([[torch.from_numpy(d) for d in ds] for ds in deltas],
                       w / w.sum())
    jw = jnp.asarray(sizes, jnp.float32)
    jw = jw / jnp.sum(jw)
    want = jax.tree.map(lambda *ds: sum(a * d for a, d in zip(jw, ds)),
                        *[[jnp.asarray(d) for d in ds] for ds in deltas])
    for g, v in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(v))


def classifier_pair(seed=0, hidden=8, n_classes=8):
    """A reference conv classifier and the port's on the same weights."""
    jp = JDS.init_conv_classifier(jax.random.PRNGKey(seed), in_channels=3,
                                  n_classes=n_classes, hidden=hidden)
    flat = {f"{k}/{kk}" if isinstance(v, dict) else k: np.array(vv)
            for k, v in jp.items()
            for kk, vv in (v.items() if isinstance(v, dict) else [(None, v)])}
    return jp, conv_classifier_from_numpy(flat, device="cpu")


def ref_names(model):
    return [n.replace(".weight", "/kernel").replace(".", "/")
            for n, _ in model.named_parameters()]


@pytest.mark.parametrize("n_steps,prox_mu", [(1, 0.0), (3, 0.1)])
def test_local_update_matches_jax_steps(n_steps, prox_mu):
    """``_local_update``'s minibatches (drawn again from the same seed) fed
    to JAX: xent (+ FedProx) ``grad`` and ``adamw_update``, step by step."""
    jp, model = classifier_pair()
    data = make_images(torch.Generator().manual_seed(3), 40, size=8,
                       n_identities=4)
    fc = F.FedConfig(local_batch=16, lr=1e-3, prox_mu=prox_mu)
    delta = F._local_update(torch.Generator().manual_seed(9), model, data.x,
                            data.content, n_steps, fc)
    g = torch.Generator().manual_seed(9)
    x, y = jnp.asarray(data.x.numpy()), jnp.asarray(data.content.numpy())
    apply = lambda p, xb: JDS.conv_classifier(p, xb)  # noqa: E731
    jfc = JF.FedConfig(local_batch=16, lr=1e-3, prox_mu=prox_mu)

    def loss(p, xb, yb):
        out = JDS.xent_loss(apply, p, xb, yb)
        if jfc.prox_mu:
            sq = jax.tree.map(lambda a, b: jnp.sum(jnp.square(a - b)), p, jp)
            out = out + 0.5 * jfc.prox_mu * jax.tree.reduce(jnp.add, sq)
        return out

    params, opt = jp, j_adamw_init(jp)
    for _ in range(n_steps):
        sel = torch.randint(0, 40, (16,), generator=g).numpy()
        grads = jax.grad(loss)(params, x[sel], y[sel])
        params, opt = j_adamw_update(params, grads, opt, lr=jfc.lr)
    want = jax.tree.map(lambda a, b: a - b, params, jp)
    for name, d in zip(ref_names(model), delta):
        k, _, leaf = name.partition("/")
        w = np.asarray(want[k][leaf] if leaf else want[k])
        err = np.abs(to_reference_layout(d) - w).max()
        assert err <= 1e-5, f"{name}: {err}"
    # the global model is not moved by a local pass
    for (name, p), q in zip(model.named_parameters(),
                            classifier_pair()[1].parameters()):
        assert torch.equal(p, q), name


@pytest.mark.parametrize("fc", [
    F.FedConfig(rounds=2, local_batch=8, lr=3e-3),
    F.FedConfig(rounds=2, local_batch=8, lr=3e-3, prox_mu=0.05,
                dp_clip=1.0, dp_noise=0.1)])
def test_batched_equals_sequential(fc):
    data = make_images(torch.Generator().manual_seed(4), 64, size=8,
                       n_identities=4)
    st = partition_stacked(data, 4, regime="worst")
    _, model = classifier_pair(1)
    shards = [LabeledData(st.x[c], st.content[c], st.style[c])
              for c in range(4)]
    seq = F.fedavg_train(7, model, shards, lambda s: s.content, fc,
                         device="cpu")
    bat = F.fedavg_train_batched(7, model, st.x, st.content, fc,
                                 device="cpu")
    moved = False
    for (name, a), b, c in zip(seq.named_parameters(), bat.parameters(),
                               model.parameters()):
        assert torch.equal(a, b), name
        moved = moved or not torch.equal(a, c)
    assert moved


def test_shared_data_is_appended_to_every_shard():
    data = make_images(torch.Generator().manual_seed(5), 48, size=8,
                       n_identities=4)
    shared = make_images(torch.Generator().manual_seed(6), 8, size=8,
                         n_identities=4)
    _, model = classifier_pair(2)
    shards = [LabeledData(*(f[i::3] for f in data)) for i in range(3)]
    fc = F.FedConfig(rounds=1, local_batch=8)
    got = F.fedavg_train(3, model, shards, lambda s: s.style, fc,
                         shared_data=shared, device="cpu")
    joined = [LabeledData(*(torch.cat([a, b]) for a, b in zip(s, shared)))
              for s in shards]
    want = F.fedavg_train(3, model, joined, lambda s: s.style, fc,
                          device="cpu")
    for a, b in zip(got.parameters(), want.parameters()):
        assert torch.equal(a, b)


def test_fedavg_accuracy_rises():
    data = make_images(torch.Generator().manual_seed(0), 256, size=16,
                       n_identities=4)
    test = make_images(torch.Generator().manual_seed(1), 128, size=16,
                       n_identities=4)
    model = ConvClassifier(3, 8, hidden=16,
                           generator=torch.Generator().manual_seed(0))
    before = accuracy(model, test.x, test.content)
    shards = [LabeledData(*(f[i::4] for f in data)) for i in range(4)]
    fc = F.FedConfig(rounds=8, local_epochs=2, local_batch=32, lr=1e-2)
    after = accuracy(F.fedavg_train(0, model, shards, lambda s: s.content,
                                    fc, device="cpu"), test.x, test.content)
    assert after > before + 0.3, (before, after)
