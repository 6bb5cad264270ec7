"""The port's checksums (zlib_rs_tpu_torch.ops.checksum) against the JAX
package and stdlib zlib. Integer arithmetic: every comparison is exact.

`adler32_batch` on a CPU tensor runs K1's plain PyTorch version; the JAX
side runs its XLA reduction and its Pallas kernel in interpret mode."""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zlib_rs_tpu.ops import checksum as jchk
from zlib_rs_tpu.ops.pallas import checksum_kernels as jck
from zlib_rs_tpu_torch.ops import checksum as tchk
from zlib_rs_tpu_torch.ops.kernels import checksum_kernels as tck

# the test workers share the cores, and an oversubscribed OpenMP pool spin-waits
torch.set_num_threads(1)

_BASH = open("/bin/bash", "rb").read()


def _rows(seed: int, B: int, N: int):
    """uint8 [B, N] rows cut from /bin/bash at seeded offsets, zero past
    each row's seeded true length (0 and N included)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, N + 1, size=B).astype(np.int32)
    lens[0] = 0
    lens[-1] = N
    data = np.zeros((B, N), np.uint8)
    for r in range(B):
        off = int(rng.integers(0, len(_BASH) - N))
        data[r, : lens[r]] = np.frombuffer(_BASH[off : off + lens[r]], np.uint8)
    return data, lens


@pytest.mark.parametrize(
    "B,N", [(1, 1), (3, 1000), (5, 4097), (8, 4096), (2, 65521), (16, 32768)]
)
def test_adler32_batch_matches_jax_and_zlib(B, N):
    data, lens = _rows(B * 7 + N, B, N)
    got = tchk.adler32_batch(torch.from_numpy(data), torch.from_numpy(lens)).numpy()
    ref = np.asarray(jchk.adler32_batch_jax(jnp.asarray(data), jnp.asarray(lens)))
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, ref.astype(np.int64))
    for r in range(B):
        assert int(got[r]) == zlib.adler32(data[r, : lens[r]].tobytes())


def test_adler32_batch_matches_pallas_kernel_interpret():
    data, lens = _rows(11, 8, 4096)
    got = tchk.adler32_batch(torch.from_numpy(data), torch.from_numpy(lens)).numpy()
    ref = np.asarray(jck.adler32_batch_pallas(
        jnp.asarray(data), jnp.asarray(lens), interpret=True
    ))
    np.testing.assert_array_equal(got, ref.astype(np.int64))


def test_adler32_batch_strided_rows_and_full_chunk():
    # the pipeline hands K1 a column slice of the chunk buffer
    rng = np.random.default_rng(5)
    buf = rng.integers(0, 256, size=(4, 32768 + 300), dtype=np.uint8)
    lens = np.array([32768, 1, 0, 20000], np.int32)
    view = torch.from_numpy(buf)[:, 100 : 100 + 32768]
    got = tchk.adler32_batch(view, torch.from_numpy(lens)).numpy()
    for r in range(4):
        assert int(got[r]) == zlib.adler32(buf[r, 100 : 100 + lens[r]].tobytes())


def test_adler32_batch_plain_of_all_ff_bytes():
    # the largest per-byte terms: no overflow in the int64 sums
    data = np.full((2, 65536), 255, np.uint8)
    lens = np.array([65536, 65521], np.int32)
    got = tck.adler32_batch_plain(torch.from_numpy(data), torch.from_numpy(lens))
    got = got.numpy().view(np.uint32)
    for r in range(2):
        assert int(got[r]) == zlib.adler32(data[r, : lens[r]].tobytes())


def test_adler32_kernel_wrapper_refuses_cpu_tensors():
    data = torch.zeros((2, 8), dtype=torch.uint8)
    lens = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="CUDA"):
        tck.adler32_batch_cuda(data, lens)


@pytest.mark.parametrize("split", [0, 1, 777, 32768, 50_000])
def test_combines_match_zlib(split):
    buf = _BASH[300_000 : 300_000 + 50_000]
    a, b = buf[:split], buf[split:]
    want_adler = zlib.adler32(buf)
    got = tchk.adler32_combine(zlib.adler32(a), zlib.adler32(b), len(b))
    assert got == want_adler == jchk.adler32_combine(zlib.adler32(a), zlib.adler32(b), len(b))


# -- K1's design as a numpy model ------------------------------------------
#
# csrc/adler32.cu as built: a block of THREADS threads a row, each owning
# SEG contiguous bytes of every pass, the passes from the row's start
# rounded down to 16 bytes; the 16-byte loads cover every vector that holds
# a row byte and bytes outside the row are zeroed; a segment [lo, hi) keeps
# s = sum d and w = sum (hi - i) d in 32 bits, a word by two __dp4a with
# constant weights; b gathers w + s (end - hi) in 64 bits, each thread
# reduces mod 65521 and the block sums. Addresses are offsets into `buf`,
# whose offset 0 stands for a 16-byte aligned address.

_T, _L = tck.THREADS, tck.SEG
_BASE = tck.ADLER_BASE


def _dp4a(words, weights):
    """__dp4a(word, weights, 0) over arrays: the four byte products summed."""
    out = np.zeros(np.broadcast(words, weights).shape, np.uint64)
    for j in range(4):
        out += ((words >> (8 * j)) & 0xFF) * ((weights >> (8 * j)) & 0xFF)
    return out


def _weights(m):
    return (_L - 4 * m) | (_L - 4 * m - 1) << 8 | (_L - 4 * m - 2) << 16 | (_L - 4 * m - 3) << 24


def _k1_row(buf, start, length, most=None):
    """K1's (b << 16) | a of buf[start : start + length], as the kernel
    computes it. `most`, a dict, keeps the largest 32-bit partials: a
    segment's s and w, a thread's residues and the block's sums of them."""
    most = {} if most is None else most
    p, e = start, start + length
    p_al, e_up = p & ~15, (e + 15) & ~15
    passes = -(-(e_up - p_al) // (_T * _L)) if length else 0
    t = np.arange(_T, dtype=np.int64)
    s_sum = np.zeros(_T, np.uint64)
    b_sum = np.zeros(_T, np.uint64)
    for q in range(passes):
        lo = p_al + q * _T * _L + t * _L
        addr = lo[:, None] + np.arange(_L)[None, :]
        vec = addr - (addr % 16)
        b = np.where(vec < e_up, buf[np.clip(addr, 0, len(buf) - 1)].astype(np.uint64), 0)
        b = np.where((addr >= p) & (addr < e), b, 0).reshape(_T, _L // 4, 4)
        words = b[:, :, 0] | (b[:, :, 1] << 8) | (b[:, :, 2] << 16) | (b[:, :, 3] << 24)
        s = sum(_dp4a(words[:, m], 0x01010101) for m in range(_L // 4))
        w = sum(_dp4a(words[:, m], _weights(m)) for m in range(_L // 4))
        most["s"] = max(most.get("s", 0), int(s.max()))
        most["w"] = max(most.get("w", 0), int(w.max()))
        b_sum += (w.astype(np.int64) + s.astype(np.int64) * (e - (lo + _L))).astype(np.uint64)
        s_sum += s
    s32, b32 = s_sum % _BASE, b_sum % _BASE
    most["block"] = max(most.get("block", 0), int(s32.sum()), int(b32.sum()))
    a = (1 + int(s32.sum()) % _BASE) % _BASE
    bb = (length % _BASE + int(b32.sum()) % _BASE) % _BASE
    return (bb << 16) | a


def test_k1_constants_equal_the_source():
    src = open("zlib_rs_tpu_torch/csrc/adler32.cu").read()
    assert f"constexpr int kThreads = {tck.THREADS};" in src
    assert f"constexpr int kSeg = {tck.SEG};" in src
    assert tck.SEG % 16 == 0 and tck.SEG <= 255  # a weight fits a byte of __dp4a


def test_k1_weighted_words_equal_the_byte_sums():
    rng = np.random.default_rng(3)
    seg = rng.integers(0, 256, (64, _L), dtype=np.uint64)
    words = seg.reshape(64, _L // 4, 4)
    words = words[:, :, 0] | (words[:, :, 1] << 8) | (words[:, :, 2] << 16) | (words[:, :, 3] << 24)
    w = sum(_dp4a(words[:, m], _weights(m)) for m in range(_L // 4))
    assert (w == (seg * np.arange(_L, 0, -1, dtype=np.uint64)).sum(axis=1)).all()


_K1_N = _T * _L + 100  # a row past one pass
_K1_LENGTHS = [0, 1, 15, 16, 17, _L - 1, _L, _L + 1, _T * _L - 1, _T * _L, _K1_N]


@pytest.fixture(scope="module")
def k1_ragged():
    """Rows of width _K1_N at column offsets 0 and 3 of a wider seeded
    buffer (random bytes on both sides of every row), one row a length;
    with the plain version's and the JAX kernel's (interpret mode, rows
    zero-padded to its 4096-byte blocks) results."""
    rng = np.random.default_rng(13)
    out = {}
    n_rows = len(_K1_LENGTHS)
    lens = np.array(_K1_LENGTHS, np.int32)
    for off in (0, 3):
        width = -(-(_K1_N + 64) // 16) * 16  # every row starts at an aligned offset
        buf = rng.integers(0, 256, (n_rows, width), dtype=np.uint8)
        buf[0, : width // 2] = np.frombuffer(_BASH[: width // 2], np.uint8)
        plain = tchk.adler32_batch(torch.from_numpy(buf)[:, off : off + _K1_N],
                                   torch.from_numpy(lens)).numpy()
        padded = np.zeros((-(-n_rows // 8) * 8, -(-_K1_N // 4096) * 4096), np.uint8)
        for r, n in enumerate(_K1_LENGTHS):
            padded[r, :n] = buf[r, off : off + n]
        plens = np.zeros(padded.shape[0], np.int32)
        plens[:n_rows] = lens
        jax_out = np.asarray(jck.adler32_batch_pallas(jnp.asarray(padded), jnp.asarray(plens),
                                                      interpret=True))
        out[off] = (buf, plain, jax_out)
    return out


@pytest.mark.parametrize("off", [0, 3])
@pytest.mark.parametrize("n", _K1_LENGTHS)
def test_k1_model_on_design_edges_equals_plain_jax_and_zlib(k1_ragged, off, n):
    buf, plain, jax_out = k1_ragged[off]
    r = _K1_LENGTHS.index(n)
    got = _k1_row(buf.reshape(-1), r * buf.shape[1] + off, n)
    want = zlib.adler32(buf[r, off : off + n].tobytes())
    assert got == want == int(plain[r]) == int(jax_out[r])


def test_k1_model_on_full_rows_equals_the_jax_kernel():
    data, lens = _rows(11, 8, 32768)
    want = np.asarray(jck.adler32_batch_pallas(jnp.asarray(data), jnp.asarray(lens),
                                               interpret=True))
    flat = data.reshape(-1)
    for r in range(8):
        assert _k1_row(flat, r * 32768, int(lens[r])) == int(want[r])


@pytest.mark.parametrize("off", [0, 3])
def test_k1_partials_stay_in_32_bits_on_all_ff_rows(off):
    # the largest bytes at the full length: every 32-bit partial in range
    n = 32768
    buf = np.full((2, n + 32), 0xFF, np.uint8)
    most = {}
    got = _k1_row(buf.reshape(-1), off, n, most)
    assert got == zlib.adler32(buf[0, off : off + n].tobytes())
    assert most["s"] == 255 * _L and most["w"] == 255 * _L * (_L + 1) // 2
    assert max(most.values()) < 2**32
