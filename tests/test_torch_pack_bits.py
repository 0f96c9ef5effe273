"""Port parity: the plain pack/unpack of ``repro_torch.kernels`` against
``repro.kernels.ref``, bit-exact, for 1-12 bits, counts that are not a
multiple of the super-group, and multi-record streams."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.pack_bits import code_bits as j_code_bits  # noqa: E402
from repro.kernels.pack_bits import packing_dims as j_packing_dims  # noqa: E402
from repro.wire.payload import CodePayload as JPayload  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.pack_bits import (code_bits, pack_codes_cuda,  # noqa: E402
                                           packing_dims, unpack_codes_cuda)
from repro_torch.wire.payload import CodePayload  # noqa: E402

BITS = list(range(1, 13))


def test_layout_helpers_match_reference():
    for bits in range(1, 33):
        assert packing_dims(bits) == j_packing_dims(bits)
    for k in (1, 2, 3, 16, 17, 256, 257, 1 << 20):
        assert code_bits(k) == j_code_bits(k)


@pytest.mark.parametrize("count", [1, 37, 1000])
@pytest.mark.parametrize("bits", BITS)
def test_pack_unpack_bit_exact(bits, count):
    rng = np.random.default_rng(bits * 1000 + count)
    codes = rng.integers(0, 1 << bits, count).astype(np.int32)
    codes[:1] = (1 << bits) - 1             # all-ones code: straddle bits
    want = np.asarray(jref.pack_codes_ref(jnp.asarray(codes), bits=bits))
    words = ops.pack_codes(torch.from_numpy(codes), bits=bits)
    assert words.dtype == torch.int32
    np.testing.assert_array_equal(words.numpy().view(np.uint32), want)
    back = ops.unpack_codes(words, bits=bits, count=count)
    assert back.dtype == torch.int32
    np.testing.assert_array_equal(back.numpy(), np.asarray(
        jref.unpack_codes_ref(jnp.asarray(want), bits=bits, count=count)))
    np.testing.assert_array_equal(back.numpy(), codes)


@pytest.mark.parametrize("bits", [13, 16, 20, 31, 32])
def test_pack_unpack_wide_codes_bit_exact(bits):
    """Wide alphabets, up to 32-bit codes whose top bit lands in the int32
    carrier's sign bit: words and round trip still match the reference."""
    rng = np.random.default_rng(bits)
    codes = rng.integers(0, 1 << bits, 101, dtype=np.uint64) \
        .astype(np.uint32).view(np.int32)
    want = np.asarray(jref.pack_codes_ref(jnp.asarray(codes.view(np.uint32)),
                                          bits=bits))
    words = ops.pack_codes(torch.from_numpy(codes), bits=bits)
    np.testing.assert_array_equal(words.numpy().view(np.uint32), want)
    back = ops.unpack_codes(words, bits=bits, count=101)
    np.testing.assert_array_equal(back.numpy(), codes)


@pytest.mark.parametrize("bits", BITS)
def test_pack_records_bit_exact(bits):
    """R per-record streams, each padded to whole super-groups: words,
    nbytes and CRC equal the reference carrier's for the same codes."""
    rng = np.random.default_rng(bits)
    idx = rng.integers(0, 1 << bits, (3, 5, 7)).astype(np.int32)
    G, _ = j_packing_dims(bits)
    flat = np.pad(idx.reshape(3, -1), ((0, 0), (0, (-35) % G)))
    jp = JPayload.from_words(jref.pack_codes_ref(jnp.asarray(flat),
                                                 bits=bits),
                             bits=bits, shape=idx.shape, n_records=3)
    tp = CodePayload.pack_records(torch.from_numpy(idx), bits=bits)
    np.testing.assert_array_equal(tp.payload.numpy().view(np.uint32),
                                  np.asarray(jp.payload))
    assert (tp.nbytes, tp.checksum, tp.shape, tp.n_records) == (
        jp.nbytes, jp.checksum, jp.shape, jp.n_records)
    np.testing.assert_array_equal(tp.unpack().numpy(), idx)


def test_cuda_wrappers_refuse_cpu_tensors():
    codes = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        pack_codes_cuda(codes, bits=8)
    with pytest.raises(ValueError, match="CUDA"):
        unpack_codes_cuda(torch.zeros((2, 1), dtype=torch.int32), bits=8,
                          count=8)


def test_words_keep_uint32_bit_patterns():
    """Words at and above 2^31 survive the int32 carrier: the plain
    shifts run in int64, so no sign bit leaks into a straddling code."""
    codes = np.full(64, 0x3FF, np.int32)    # 10-bit all-ones
    words = ref.pack_codes_ref(torch.from_numpy(codes), bits=10)
    assert (words.numpy().view(np.uint32) == 0xFFFFFFFF).all()
    np.testing.assert_array_equal(
        ref.unpack_codes_ref(words, bits=10, count=64).numpy(), codes)
