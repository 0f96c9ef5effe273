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
from repro_torch.kernels.encode_codes import (  # noqa: E402
    GSVQ_PASS_ROWS, RESIDENT_BUDGET, encode_codes_cuda, encode_path,
    gsvq_bytes, gsvq_tile_positions, resident_bytes, stacked_slice_table)
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


#: (seed, n_groups, n_slices, R, P, M, K, duplicated atom pairs (lo, hi)):
#: the first two at the DVQ-AE's K; then shapes that the CUDA kernel's tiles
#: make awkward (P one past a 128-row tile, K not a multiple of the atom
#: sub-tile and 7 bits, M not a multiple of 16, two records), and atom
#: copies on both sides of its sub-tile, thread and codebook boundaries
ENCODE_CASES = {
    "vq_k256": (1, 1, 1, 3, 50, 16, 256, ()),
    "gsvq_g16s4": (16, 16, 4, 3, 50, 16, 256, ()),
    "gsvq_g8s2_speech": (17, 8, 2, 1, 40, 64, 256, ()),
    "vq_r2_p129_k100_m48": (2, 1, 1, 2, 129, 48, 100, ()),
    "vq_duplicated_atoms": (3, 1, 1, 2, 129, 64, 256,
                            ((15, 16), (63, 64), (127, 128), (0, 255))),
}


def _encode_inputs(seed, R, P, M, K, dup_pairs):
    """z and per-record codebooks, N(0, 1) float32; with ``dup_pairs``,
    atom ``hi`` a copy of atom ``lo`` and every row close to a ``lo``."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((R, P, M)).astype(np.float32)
    cb = rng.standard_normal((R, K, M)).astype(np.float32)
    if dup_pairs:
        lo, hi = (np.array(v) for v in zip(*dup_pairs))
        cb[:, hi] = cb[:, lo]
        pick = lo[rng.integers(0, len(lo), (R, P))]
        z = (np.take_along_axis(cb, pick[..., None], 1)
             + 1e-2 * z).astype(np.float32)
    return z, cb


@pytest.mark.parametrize("case", list(ENCODE_CASES))
def test_encode_codes_matches_reference(case):
    seed, n_groups, n_slices, R, P, M, K, dup_pairs = ENCODE_CASES[case]
    z, cb = _encode_inputs(seed, R, P, M, K, dup_pairs)
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
    if dup_pairs:                # a tie between copies keeps the lower index
        assert not np.isin(codes.numpy(), [hi for _, hi in dup_pairs]).any()
        assert not np.isin(jcodes.numpy(), [hi for _, hi in dup_pairs]).any()
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


@pytest.mark.parametrize("case", ["vq_r2_p129_k100_m48",
                                  "vq_duplicated_atoms"])
def test_plain_encode_codes_are_the_vq_search(case):
    """The plain VQ encode picks, record by record, the atom that the plain
    vq_nearest picks: the CUDA kernels share one search the same way."""
    seed, _, _, R, P, M, K, dup_pairs = ENCODE_CASES[case]
    z, cb = (torch.from_numpy(a) for a in _encode_inputs(seed, R, P, M, K,
                                                         dup_pairs))
    bits = code_bits(K)
    words, _, _ = ref.encode_codes_ref(z, cb, bits=bits)
    codes = ref.unpack_records_ref(words, bits=bits, n_records=R,
                                   per_record=P).reshape(R, P)
    for r in range(R):
        assert torch.equal(codes[r].to(torch.int32),
                           ref.vq_nearest_ref(z[r], cb[r]))


def test_encode_path_follows_the_shapes():
    """Plain VQ whose codebook, z tiles and sums fit one block an SM takes
    the resident kernel; GSVQ whose slice tables fit, with slice widths up
    to 64 and a multiple of 4, the tiled GSVQ kernel; wider atoms, larger
    codebooks and tables keep the thread-per-row kernel."""
    assert encode_path(256, 64) == "resident"       # DVQAEConfig()
    assert resident_bytes(256, 64) == 207_360 <= RESIDENT_BUDGET
    for K, M in ((2, 64), (100, 48), (256, 16), (1024, 16), (1, 1)):
        assert encode_path(K, M) == "resident", (K, M)
    for K, M in ((512, 64), (257, 64), (256, 65), (2048, 16), (100, 33)):
        assert encode_path(K, M) == "thread_per_row", (K, M)
    # (K, M, n_groups, n_slices): the speech config's g8s2, g16s4, 5 bits
    # over 3 slices, groups of 1, 24 and 128 atoms, one slice of width 64
    for K, M, g, S in ((256, 64, 8, 2), (256, 64, 16, 4), (256, 48, 32, 3),
                       (64, 64, 64, 2), (96, 64, 4, 2), (256, 64, 2, 2),
                       (256, 64, 8, 1)):
        assert encode_path(K, M, n_groups=g, n_slices=S) == "gsvq_tiled", \
            (K, M, g, S)
    # tables past the budget, slice widths past 64 or not a multiple of 4
    for K, M, g, S in ((512, 64, 16, 2), (256, 128, 8, 2), (256, 256, 8, 2),
                       (256, 6, 2, 2), (256, 40, 8, 4)):
        assert encode_path(K, M, n_groups=g, n_slices=S) \
            == "thread_per_row", (K, M, g, S)


def test_gsvq_bytes_is_the_kernel_budget():
    """gsvq_bytes sums the tiled GSVQ kernel's shared-memory regions as
    gs::layout does, and encode_path takes exactly the GSVQ shapes whose sum
    fits the one-block-an-SM budget; a tile is whole units of 32 slice rows
    of one slice, at least one pass of 64, whole super-groups at any
    width."""
    # speech g8s2: tables 512 rows x 36, norms 512, two 32 x 68 latent
    # tiles, 64 x (8 groups x 33) distances, 64 codes, 8 vote warps' 8 x 64
    # sums, 8 counts, 256 score columns
    assert gsvq_bytes(256, 64, n_groups=8, n_slices=2) == 4 * (
        512 * 36 + 512 + 2 * 32 * 68 + 64 * 8 * 33 + 64 + 8 * 8 * 64 + 8
        + 256) == 178_464
    # rows of a multiple of 8 floats get 4 more (RS / 4 and RSZ / 4 odd);
    # odd group sizes need no pad; regions round up to 4 floats
    assert gsvq_bytes(96, 60, n_groups=32, n_slices=5) == 4 * (
        5 * 96 * 12 + 5 * 96 + 2 * 32 * 60 + 64 * 32 * 3 + 160
        + 8 * 32 * 60 + 32 + 96)
    for S in range(1, 40):
        BP = gsvq_tile_positions(S)
        assert BP % 32 == 0 and BP * S >= GSVQ_PASS_ROWS, S
        assert all(BP * S % (32 // np.gcd(b, 32)) == 0
                   for b in range(1, 33)), S
    for K, M, g, S in ((256, 64, 8, 2), (512, 64, 8, 2), (256, 128, 8, 2),
                       (384, 64, 8, 2), (512, 32, 32, 2), (1024, 16, 8, 1),
                       (256, 64, 256, 1), (768, 32, 8, 4)):
        fits = gsvq_bytes(K, M, n_groups=g, n_slices=S) <= RESIDENT_BUDGET
        assert (encode_path(K, M, n_groups=g, n_slices=S)
                == "gsvq_tiled") == fits, (K, M, g, S)


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
