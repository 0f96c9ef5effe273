"""Port parity: the plain versions of the fused encode and decode against
the JAX package (its jnp oracle off-TPU, and one interpret-mode Pallas
decode).

Tolerances: encode codes follow the near-tie rule (a code may differ only
where the reference's second-best score is within 1e-3*(1+|best|) of its
best); counts are exact; sums rtol 1e-5, atol 1e-5 (float32 sums in
another order). VQ decode is bit-exact; GSVQ decode rtol 1e-6, since the
group-mean table is summed in another order.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import octopus as JOC  # noqa: E402
from repro.core.dvqae import DVQAEConfig as JConfig  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.decode_codes import stream_phases as j_stream_phases  # noqa: E402
from repro.kernels.encode_codes import stacked_slice_table as j_stacked  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import octopus as OC  # noqa: E402
from repro_torch.core.dvqae import DVQAEConfig  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.decode_codes import (decode_codes_cuda,  # noqa: E402
                                              stream_phases)
from repro_torch.kernels.encode_codes import (encode_codes_cuda,  # noqa: E402
                                              stacked_slice_table)
from repro_torch.kernels.pack_bits import code_bits, packing_dims  # noqa: E402
from repro_torch.kernels.vq_nn import vq_nearest_cuda  # noqa: E402

BITS = list(range(1, 13))


def ref_scores64(z, cb, n_groups, n_slices):
    """The reference's score formula in float64: (R, P*S, C)."""
    z = z.astype(np.float64)
    cb = cb.astype(np.float64)
    R, P, M = z.shape
    K = cb.shape[1]
    if n_groups == 1 and n_slices == 1:
        return (cb * cb).sum(-1)[:, None, :] - 2 * np.einsum(
            "rpm,rkm->rpk", z, cb)
    S, m = n_slices, M // n_slices
    zs = z.reshape(R, P, S, m)
    cs = cb.reshape(R, K, S, m).transpose(0, 2, 1, 3)
    d2 = ((zs * zs).sum(-1)[..., None] - 2 * np.einsum("rpsm,rskm->rpsk",
                                                        zs, cs)
          + (cs * cs).sum(-1)[:, None])
    d = np.sqrt(np.maximum(d2, 0) + 1e-12)
    return d.reshape(R, P, S, n_groups, K // n_groups).mean(-1).reshape(
        R, P * S, n_groups)


@pytest.mark.parametrize("n_groups,n_slices", [(1, 1), (16, 4)],
                         ids=["vq_k256", "gsvq_g16s4"])
def test_encode_codes_matches_reference(n_groups, n_slices):
    rng = np.random.default_rng(n_groups)
    R, P, M, K = 3, 50, 16, 256
    z = rng.standard_normal((R, P, M)).astype(np.float32)
    cb = rng.standard_normal((R, K, M)).astype(np.float32)
    gsvq = n_groups > 1
    bits = code_bits(n_groups if gsvq else K)
    S = n_slices if gsvq else 1
    jw, jc, js = jops.encode_codes(jnp.asarray(z), jnp.asarray(cb),
                                   bits=bits, n_groups=n_groups,
                                   n_slices=n_slices)
    tw, tc, ts = ops.encode_codes(torch.from_numpy(z), torch.from_numpy(cb),
                                  bits=bits, n_groups=n_groups,
                                  n_slices=n_slices)
    assert tw.shape == jw.shape and tw.dtype == torch.int32
    codes = ref.unpack_records_ref(tw, bits=bits, n_records=R,
                                   per_record=P * S)
    jcodes = ref.unpack_records_ref(
        torch.from_numpy(np.array(jw).view(np.int32)), bits=bits,
        n_records=R, per_record=P * S)
    scores = torch.from_numpy(ref_scores64(z, cb, n_groups, n_slices))
    n_diff, n_outside = ref.code_mismatches(codes, jcodes, scores)
    print(f"encode {n_groups}/{n_slices}: {n_diff} of {codes.numel()} "
          f"codes differ")
    assert n_outside == 0 and n_diff <= 1e-3 * codes.numel()
    if n_diff == 0:
        np.testing.assert_array_equal(tw.numpy().view(np.uint32),
                                      np.asarray(jw))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                                   atol=1e-5)
    else:                        # stats of the port's own codes
        c, s = ref.encode_stats(torch.from_numpy(z), codes, K,
                                n_groups=n_groups, n_slices=n_slices)
        assert torch.equal(tc, c)
        torch.testing.assert_close(ts, s, rtol=1e-5, atol=1e-5)


def test_stacked_slice_table_matches_reference():
    cb = np.random.default_rng(3).standard_normal((2, 8, 12)) \
        .astype(np.float32)
    np.testing.assert_array_equal(
        stacked_slice_table(torch.from_numpy(cb), n_slices=3).numpy(),
        np.asarray(j_stacked(jnp.asarray(cb), n_slices=3)))


@pytest.mark.parametrize("bits", BITS)
def test_decode_vq_multi_record_bit_exact(bits):
    """Two records of a non-multiple length, concatenated into one stream."""
    rng = np.random.default_rng(bits)
    rows = min(1 << bits, 20)
    table = rng.standard_normal((rows, 8)).astype(np.float32)
    recs = [rng.integers(0, rows, 29).astype(np.int32) for _ in range(2)]
    words = np.concatenate([np.asarray(jref.pack_codes_ref(
        jnp.asarray(r), bits=bits)) for r in recs])
    G, _ = packing_dims(bits)
    count = words.shape[0] * G
    want = np.asarray(jops.decode_codes(jnp.asarray(words),
                                        jnp.asarray(table), bits=bits,
                                        count=count, use_ref=True))
    got = ops.decode_codes(torch.from_numpy(words.view(np.int32)),
                           torch.from_numpy(table), bits=bits, count=count)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bits", BITS)
def test_decode_gsvq_with_phases(bits):
    """GSVQ: 3 slices, two records whose slice phase restarts at 0, the
    group-mean table built by each package from one codebook."""
    rng = np.random.default_rng(100 + bits)
    S, n_groups = 3, min(1 << bits, 5)
    jcfg = JConfig(latent_dim=12, codebook_size=10 * n_groups,
                   n_groups=n_groups, n_slices=S)
    cfg = DVQAEConfig(latent_dim=12, codebook_size=10 * n_groups,
                      n_groups=n_groups, n_slices=S)
    cb = rng.standard_normal((jcfg.codebook_size, 12)).astype(np.float32)
    jtab, jS = JOC.decode_table(jcfg, jnp.asarray(cb))
    ttab, tS = OC.decode_table(cfg, torch.from_numpy(cb))
    assert jS == tS == S
    np.testing.assert_allclose(ttab.numpy(), np.asarray(jtab), rtol=1e-6)
    per = S * 7
    recs = [rng.integers(0, n_groups, per).astype(np.int32)
            for _ in range(2)]
    words = np.concatenate([np.asarray(jref.pack_codes_ref(
        jnp.asarray(r), bits=bits)) for r in recs])
    G, _ = packing_dims(bits)
    nw = -(-per // G)
    jph = np.tile(np.asarray(j_stream_phases(nw, bits, S)), 2)
    tph = stream_phases(nw, bits, S).repeat(2)
    np.testing.assert_array_equal(tph.numpy(), jph)
    count = words.shape[0] * G
    want = np.asarray(jops.decode_codes(jnp.asarray(words), jtab, bits=bits,
                                        count=count, n_slices=S,
                                        phases=jnp.asarray(jph),
                                        use_ref=True))
    got = ops.decode_codes(torch.from_numpy(words.view(np.int32)), ttab,
                           bits=bits, count=count, n_slices=S, phases=tph)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_decode_matches_interpret_mode_kernel():
    """One small case against the Pallas kernel itself, in interpret mode."""
    rng = np.random.default_rng(7)
    bits, S = 5, 3
    table = rng.standard_normal((S * 20, 4)).astype(np.float32)
    codes = rng.integers(0, 20, 93).astype(np.int32)
    words = np.array(jref.pack_codes_ref(jnp.asarray(codes), bits=bits))
    want = np.asarray(jops.decode_codes(jnp.asarray(words),
                                        jnp.asarray(table), bits=bits,
                                        count=93, n_slices=S))
    got = ops.decode_codes(torch.from_numpy(words.view(np.int32)),
                           torch.from_numpy(table), bits=bits, count=93,
                           n_slices=S)
    np.testing.assert_array_equal(got.numpy(), want)


def test_cuda_wrappers_refuse_cpu_tensors():
    z = torch.zeros((1, 8, 4))
    with pytest.raises(ValueError, match="CUDA"):
        encode_codes_cuda(z, torch.zeros((1, 4, 4)), bits=2)
    with pytest.raises(ValueError, match="CUDA"):
        decode_codes_cuda(torch.zeros((2, 1), dtype=torch.int32),
                          torch.zeros((4, 4)), bits=8, count=8)
    with pytest.raises(ValueError, match="CUDA"):
        vq_nearest_cuda(torch.zeros((8, 4)), torch.zeros((16, 4)))
