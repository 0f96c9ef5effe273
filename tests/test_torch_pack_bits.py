"""Port parity: the plain pack/unpack of ``repro_torch.kernels`` against
``repro.kernels.ref`` and the Pallas kernels in interpret mode, bit-exact,
for 1-32 bits, counts that are not a multiple of the super-group, and
multi-record streams; the 128-code chunk the CUDA kernels are built on; and
the refusals of the CUDA wrappers."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.pack_bits import pack_codes_pallas  # noqa: E402
from repro.kernels.pack_bits import unpack_codes_pallas  # noqa: E402
from repro.kernels.pack_bits import code_bits as j_code_bits  # noqa: E402
from repro.kernels.pack_bits import packing_dims as j_packing_dims  # noqa: E402
from repro.wire.payload import CodePayload as JPayload  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.pack_bits import (CHUNK, code_bits,  # noqa: E402
                                           kernel_path, pack_codes_cuda,
                                           packing_dims, unpack_codes_cuda)
from repro_torch.wire.payload import CodePayload  # noqa: E402

BITS = list(range(1, 13))

torch.set_num_threads(1)


def _codes(rng, bits, count):
    """``count`` codes of ``bits`` bits as int32 (32-bit codes wrap into the
    carrier's sign bit)."""
    return rng.integers(0, 1 << bits, count, dtype=np.uint64) \
        .astype(np.uint32).view(np.int32)


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


@pytest.mark.parametrize("bits", range(1, 33))
def test_chunk_of_128_codes_packs_alone(bits):
    """The invariant the CUDA kernels are built on: 128 codes fill exactly
    4b words and hold whole super-groups, so a stream packed chunk by chunk
    gives the words of packing it whole, a partial last chunk included."""
    G, W = packing_dims(bits)
    assert CHUNK % G == 0 and CHUNK // G * W == 4 * bits
    rng = np.random.default_rng(bits)
    for count in (3 * CHUNK, 3 * CHUNK + 61):
        codes = torch.from_numpy(_codes(rng, bits, count))
        whole = ref.pack_codes_ref(codes, bits=bits).reshape(-1)
        chunks = [ref.pack_codes_ref(codes[i:i + CHUNK], bits=bits)
                  .reshape(-1) for i in range(0, count, CHUNK)]
        assert all(c.numel() == 4 * bits for c in chunks[:3])
        assert torch.equal(torch.cat(chunks), whole)
        np.testing.assert_array_equal(whole.numpy().view(np.uint32), np.asarray(
            jref.pack_codes_ref(jnp.asarray(codes.numpy().view(np.uint32)),
                                bits=bits)).reshape(-1))


@pytest.mark.parametrize("bits", [1, 5, 7, 8, 10, 16, 31, 32])
def test_plain_versions_match_pallas_kernels(bits):
    """The port's pack and unpack against the Pallas kernels themselves, in
    interpret mode, bit-exact: words of 1,029 codes and the codes back."""
    count = 1029
    codes = _codes(np.random.default_rng(100 + bits), bits, count)
    want = np.asarray(pack_codes_pallas(jnp.asarray(codes.view(np.uint32)),
                                        bits=bits, interpret=True))
    words = ops.pack_codes(torch.from_numpy(codes), bits=bits)
    np.testing.assert_array_equal(words.numpy().view(np.uint32), want)
    back = np.asarray(unpack_codes_pallas(jnp.asarray(want), bits=bits,
                                          count=count, interpret=True))
    np.testing.assert_array_equal(
        ops.unpack_codes(words, bits=bits, count=count).numpy(), back)
    np.testing.assert_array_equal(back, codes)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself on cuda:0, to reach the wrappers'
    checks past the device test without a card."""

    @property
    def is_cuda(self):
        return True

    @property
    def device(self):
        return torch.device("cuda", 0)

    def get_device(self):
        return 0


def _on_card(t):
    return t.as_subclass(_OnCard)


_I32 = torch.int32
REFUSALS = [
    ("pack_cpu", lambda: pack_codes_cuda(torch.zeros(8, dtype=_I32), bits=8),
     ValueError, "codes must lie on a CUDA device, got cpu"),
    ("pack_bits", lambda: pack_codes_cuda(
        _on_card(torch.zeros(8, dtype=_I32)), bits=33),
     ValueError, "bits must be in [1, 32], got 33"),
    ("pack_dtype", lambda: pack_codes_cuda(
        _on_card(torch.zeros(8, dtype=torch.int64)), bits=8),
     TypeError, "codes must be torch.int32, got torch.int64"),
    ("pack_strided", lambda: pack_codes_cuda(
        _on_card(torch.zeros(16, dtype=_I32))[::2], bits=8),
     ValueError, "codes must be contiguous"),
    ("unpack_cpu", lambda: unpack_codes_cuda(
        torch.zeros((2, 1), dtype=_I32), bits=8, count=8),
     ValueError, "words must lie on a CUDA device, got cpu"),
    ("unpack_bits", lambda: unpack_codes_cuda(
        _on_card(torch.zeros((2, 1), dtype=_I32)), bits=0, count=8),
     ValueError, "bits must be in [1, 32], got 0"),
    ("unpack_dtype", lambda: unpack_codes_cuda(
        _on_card(torch.zeros((2, 1))), bits=8, count=8),
     TypeError, "words must be torch.int32, got torch.float32"),
    ("unpack_strided", lambda: unpack_codes_cuda(
        _on_card(torch.zeros((2, 2), dtype=_I32))[:, :1], bits=8, count=8),
     ValueError, "words must be contiguous"),
    ("unpack_flat", lambda: unpack_codes_cuda(
        _on_card(torch.zeros(2, dtype=_I32)), bits=8, count=8),
     ValueError, "words must be (n, 1) for 8 bits, got (2,)"),
    ("unpack_width", lambda: unpack_codes_cuda(
        _on_card(torch.zeros((2, 1), dtype=_I32)), bits=5, count=8),
     ValueError, "words must be (n, 5) for 5 bits, got (2, 1)"),
    ("unpack_count", lambda: unpack_codes_cuda(
        _on_card(torch.zeros((2, 1), dtype=_I32)), bits=8, count=9),
     ValueError, "count 9 exceeds the 8 codes of the stream"),
    ("unpack_negative", lambda: unpack_codes_cuda(
        _on_card(torch.zeros((2, 1), dtype=_I32)), bits=8, count=-1),
     ValueError, "count -1 exceeds the 8 codes of the stream"),
]


@pytest.mark.parametrize("call, exc, message",
                         [r[1:] for r in REFUSALS],
                         ids=[r[0] for r in REFUSALS])
def test_cuda_wrappers_refuse_with_their_messages(call, exc, message):
    """The wrappers' one combined test refuses what each check refused
    before, in the same order and with the same message, and launches
    nothing."""
    with pytest.raises(exc) as err:
        call()
    assert str(err.value) == message


def test_kernel_path_names_the_chunks_and_edges():
    buf = torch.zeros(4 * CHUNK + 8, dtype=torch.int32)
    assert kernel_path(8, 2 * CHUNK, buf, sms=132) == "chunksx1"
    assert kernel_path(7, 2 * CHUNK + 1, buf, sms=132) == "chunksx1+tail"
    assert kernel_path(32, CHUNK, buf, sms=132) == "copyx1"
    assert kernel_path(32, 5, buf, sms=132) == "copyx1+tail"
    for off in (1, 2, 3):
        assert kernel_path(8, CHUNK, buf, buf[off:], sms=132) \
            == "chunksx1+masked"
    assert kernel_path(8, CHUNK, buf, buf[4:], sms=132) == "chunksx1"
    # groups of 4 chunks a warp once they give every SM a 4-warp block
    n = 132 * 16 * CHUNK
    assert kernel_path(5, n, buf, sms=132) == "chunksx4"
    assert kernel_path(5, n - 16 * CHUNK, buf, sms=132) == "chunksx1"
    assert kernel_path(5, n + 3, buf, sms=132) == "chunksx4+tail"
    assert kernel_path(8, 1024 * 65536, buf, sms=132) == "chunksx4"
    assert kernel_path(8, 65536, buf, sms=132) == "chunksx1"
