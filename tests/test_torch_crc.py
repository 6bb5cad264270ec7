"""K7, the batched crc32, and the gzip trailer it feeds: the port's plain
version (`device="cpu"`) against the JAX package's K7 in interpret mode
and stdlib zlib, on full and ragged rows; the host combine; the gzip
streams of `compress_parallel` against the JAX package's bytes."""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zlib_rs_tpu.parallel.pipeline as jp
from zlib_rs_tpu.ops import gf2 as jgf2
from zlib_rs_tpu.ops.pallas import crc_kernels as JK
import zlib_rs_tpu_torch as zt
from zlib_rs_tpu_torch.ops import checksum as C
from zlib_rs_tpu_torch.ops import gf2
from zlib_rs_tpu_torch.ops.kernels import crc_kernels as CK
from zlib_rs_tpu_torch.parallel import pipeline as tp

# the test workers share the cores, and an oversubscribed OpenMP pool spin-waits
torch.set_num_threads(1)

_BASH = open("/bin/bash", "rb").read()


def _rows(B, N, seed):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 256, (B, N), dtype=np.uint8)
    rows[: B // 2] = np.frombuffer(_BASH[: (B // 2) * N], np.uint8).reshape(B // 2, N)
    return rows


def test_plain_equals_jax_kernel_and_zlib_on_full_rows():
    rows = _rows(8, 32 * 1024, 1)
    got = C.crc32_batch(torch.from_numpy(rows)).numpy()
    want = np.asarray(JK.crc32_batch_pallas(jnp.asarray(rows), interpret=True))
    assert got.tolist() == want.astype(np.int64).tolist()
    assert got.tolist() == [zlib.crc32(r.tobytes()) for r in rows]


@pytest.mark.parametrize("N", [1, 3, 255, 256, 257, 1000, 4099])
def test_plain_on_ragged_rows_equals_zlib(N):
    rows = _rows(6, N, N)
    lens = np.array([0, 1, N // 2, N - 1, N, N // 3], np.int32)
    got = C.crc32_batch(torch.from_numpy(rows), torch.from_numpy(lens)).numpy()
    assert got.tolist() == [zlib.crc32(r[:n].tobytes()) for r, n in zip(rows, lens)]


def test_plain_returns_int32_bit_views():
    rows = np.full((2, 64), 0xFF, np.uint8)
    out = CK.crc32_batch_plain(torch.from_numpy(rows), torch.tensor([64, 7], dtype=torch.int32))
    assert out.dtype == torch.int32
    assert (out.numpy().view(np.uint32)).tolist() == [
        zlib.crc32(rows[0].tobytes()), zlib.crc32(rows[1, :7].tobytes())]


def test_kernel_wrapper_refuses_cpu_tensors():
    rows = torch.zeros((2, 16), dtype=torch.uint8)
    with pytest.raises(RuntimeError, match="CUDA"):
        CK.crc32_batch_cuda(rows, torch.tensor([16, 16], dtype=torch.int32))


@pytest.mark.parametrize("split", [0, 1, 4095, 32768, 65535])
def test_combine_and_host_crc_equal_zlib_and_jax(split):
    data = _BASH[:70_001]
    a, b = data[:split], data[split:]
    got = C.crc32_combine(C.crc32(a), C.crc32(b), len(b))
    assert got == zlib.crc32(data)
    assert got == jgf2.crc32_combine(zlib.crc32(a), zlib.crc32(b), len(b))
    assert C.crc32(b, C.crc32(a)) == zlib.crc32(data)


def test_gf2_table_and_shift_equal_the_jax_package():
    # the port's carry-less shift is the reference's packed shift matrix
    assert (gf2.CRC_TABLE == jgf2.CRC_TABLE).all()
    for n, crc in zip((0, 1, 3, 4096, 32768, 123_457), (0, 1, 0xFFFFFFFF, 0x80000000, 0x1234, 0xDEADBEEF)):
        want = jgf2.matrix_times_vec(jgf2.shift_matrix_for_len(n), crc)
        assert gf2.crc32_combine(crc, 0, n) == want


@pytest.mark.parametrize("n", [0, 5, 32_767, 32_768, 65_536 + 99])
def test_gzip_trailer_crc_equals_zlib(n):
    data = (_BASH * 2)[:n]
    assert tp._gzip_crc(data, tp.DEFAULT_CHUNK, torch.device("cpu")) == zlib.crc32(data)


@pytest.fixture
def kernel_engine(monkeypatch):
    for name in ("ZRS_TPU_CHAIN", "ZRS_TPU_WG", "ZRS_TPU_HOPSCAN", "ZRS_TPU_TABSCAN",
                 "ZRS_TPU_HOP_IL"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("ZRS_TPU_KERNEL", "1")
    from zlib_rs_tpu_torch.ops import dynhuff as td

    table = np.asarray(jnp.exp2(jnp.arange(16, dtype=jnp.float32))).copy()
    monkeypatch.setattr(td, "EXP2_LEN", torch.from_numpy(table))


@pytest.mark.parametrize("n", [65_536, 40_000])
def test_gzip_streams_equal_jax(kernel_engine, n):
    data = _BASH[300_000 : 300_000 + n]
    got = zt.compress_parallel(data, 6, window_bits=31, device="cpu")
    assert got == jp.compress_parallel(data, 6, window_bits=31)
    assert zlib.decompress(got, 31) == data


# -- K7's design as a numpy model ------------------------------------------
#
# csrc/crc32.cu as built: a block of THREADS threads a row, each owning SEG
# bytes of every pass; the passes end at the row's end rounded up to 16
# bytes (e_up), so thread t's raw crc (zero register in) moves to e_up by
# one constant, shift_table()[t]; the 16-byte loads cover every vector
# that holds a row byte, and bytes outside the row are zeroed; zlib's init
# enters as the row's first four bytes inverted; the slice-by-8 tables
# come from bit steps, a column a thread; the block XORs the shifted crcs,
# and one shift by x^(-8k) takes out the k zeros read past the row's end.
# Addresses are offsets into `buf`, whose offset 0 stands for a 16-byte
# aligned address.

_T, _L = CK.THREADS, CK.SEG
_POLY = gf2.CRC32_POLY


def _bit_steps(c, n):
    for _ in range(n):
        c = np.where(c & 1, (c >> 1) ^ _POLY, c >> 1)
    return c


def _k7_tables():
    """tab[k][b]: byte b, then k zero bytes, into a zero register."""
    c = np.arange(256, dtype=np.uint64)
    tab = np.zeros((8, 256), np.uint64)
    for k in range(8):
        c = _bit_steps(c, 8)
        tab[k] = c
    return tab


_TAB = _k7_tables()


def _step8(c, w0, w1):
    c = c ^ w0
    t = _TAB
    return (t[7][c & 0xFF] ^ t[6][(c >> 8) & 0xFF] ^ t[5][(c >> 16) & 0xFF] ^ t[4][c >> 24]
            ^ t[3][w1 & 0xFF] ^ t[2][(w1 >> 8) & 0xFF] ^ t[1][(w1 >> 16) & 0xFF] ^ t[0][w1 >> 24])


def _multmodp(a, b):
    """The kernel's branch-free a * b mod P, over arrays."""
    a, b = np.asarray(a, np.uint64), np.asarray(b, np.uint64)
    p = np.zeros(np.broadcast(a, b).shape, np.uint64)
    for _ in range(32):
        p ^= np.where((a >> 31) & 1, b, 0)
        a = (a << 1) & 0xFFFFFFFF
        b = np.where(b & 1, (b >> 1) ^ _POLY, b >> 1)
    return p


def _segment_words(buf, addr, p, e, p_al, e_up):
    """The kernel's view of the bytes at `addr` [T, L]: loaded where the
    16-byte vector lies in [p_al, e_up), zero elsewhere; then zeroed
    outside [p, e) and inverted in [p, p + 4); as LE32 words [T, L // 4]."""
    vec = addr - (addr % 16)
    loaded = (vec >= p_al) & (vec < e_up)
    b = np.where(loaded, buf[np.clip(addr, 0, len(buf) - 1)].astype(np.uint64), 0)
    b = np.where((addr >= p) & (addr < e), b, 0)
    b ^= np.where((addr >= p) & (addr < p + 4), 0xFF, 0).astype(np.uint64)
    w = b.reshape(addr.shape[0], -1, 4)
    return w[:, :, 0] | (w[:, :, 1] << 8) | (w[:, :, 2] << 16) | (w[:, :, 3] << 24)


def _k7_row(buf, start, length, edges=None):
    """K7's crc32 of buf[start : start + length], as the kernel computes it.
    `edges`, a set, collects the design edges the row reached."""
    edges = set() if edges is None else edges
    if length < 4:
        edges.add("short")
        c = np.uint64(0xFFFFFFFF)
        for byte in buf[start : start + length]:
            c = _bit_steps(c ^ np.uint64(byte), 8)
        return int(c) ^ 0xFFFFFFFF
    shifts = CK.shift_table(_T, _L).astype(np.uint64)
    p, e = start, start + length
    p_al, e_up = p & ~15, (e + 15) & ~15
    pass_bytes = _T * _L
    q = -(-(e_up - p_al) // pass_bytes) - 1
    if q:
        edges.add("passes")
    t = np.arange(_T, dtype=np.int64)
    c = np.zeros(_T, np.uint64)
    while True:
        s = e_up - (q + 1) * pass_bytes + t * _L
        if (s < p_al).any():
            edges.add("front zeros")
        words = _segment_words(buf, s[:, None] + np.arange(_L)[None, :], p, e, p_al, e_up)
        for m in range(0, _L // 4, 2):
            c = _step8(c, words[:, m], words[:, m + 1])
        q -= 1
        if q < 0:
            break
        c = _multmodp(shifts[0], c)  # the kernel skips it where c == 0: the same
    x = np.bitwise_xor.reduce(_multmodp(shifts[:_T], c))
    k = e_up - e
    if k:
        edges.add("past the end")
        x = _multmodp(shifts[_T + k], x)
    if p != p_al:
        edges.add("misaligned start")
    return int(x) ^ 0xFFFFFFFF


def test_k7_constants_equal_the_source():
    src = open("zlib_rs_tpu_torch/csrc/crc32.cu").read()
    assert f"constexpr int kThreads = {CK.THREADS};" in src
    assert f"constexpr int kSeg = {CK.SEG};" in src
    assert CK.SEG % 16 == 0 and CK.SEG % 8 == 0


def test_k7_tables_equal_the_crc_table():
    assert (_TAB[0] == gf2.CRC_TABLE.astype(np.uint64)).all()
    assert (_TAB[0] == jgf2.CRC_TABLE.astype(np.uint64)).all()
    for k in range(1, 8):  # slice-by-8: T_k[i] = T_{k-1}[i] >> 8 ^ T_0[T_{k-1}[i] & 0xFF]
        assert (_TAB[k] == (_TAB[k - 1] >> 8) ^ _TAB[0][_TAB[k - 1] & 0xFF]).all()


def test_k7_shift_table_equals_x8nmodp_and_jax_shift_matrices():
    table = CK.shift_table()
    assert table.shape == (_T + 16,) and table.dtype == np.uint32
    for t in range(_T):
        n = (_T - 1 - t) * _L
        assert int(table[t]) == gf2.x8nmodp(n)
        if t % 37 == 0 or t == _T - 1:  # the reference's packed shift matrix, on x^0
            assert int(table[t]) == jgf2.matrix_times_vec(jgf2.shift_matrix_for_len(n), 1 << 31)
    for k in range(16):  # x^(-8k) undoes the shift past k zero bytes
        assert gf2.multmodp(gf2.x8nmodp(k), int(table[_T + k])) == 1 << 31
    assert int(table[_T]) == 1 << 31


@pytest.mark.parametrize("n", [4, 5, 17, 4096, _T * _L + 3])
def test_k7_init_term_is_four_inverted_bytes(n):
    # zlib's init 0xFFFFFFFF adds x^(8 n) * 0xFFFFFFFF mod P to the raw crc;
    # the raw crc of FF FF FF FF and n - 4 zeros is that term
    c = 0
    for byte in b"\xff\xff\xff\xff" + bytes(n - 4):
        c = int(gf2.CRC_TABLE[(c ^ byte) & 0xFF]) ^ (c >> 8)
    assert c == gf2.multmodp(gf2.x8nmodp(n), 0xFFFFFFFF)


def test_k7_model_equals_plain_jax_kernel_and_zlib_on_full_rows():
    rows = _rows(8, 32 * 1024, 1)
    want = np.asarray(JK.crc32_batch_pallas(jnp.asarray(rows), interpret=True))
    plain = C.crc32_batch(torch.from_numpy(rows)).numpy()
    flat = rows.reshape(-1)
    for r in range(8):
        got = _k7_row(flat, r * rows.shape[1], rows.shape[1])
        assert got == int(want[r]) == zlib.crc32(rows[r].tobytes()) == int(plain[r]) & 0xFFFFFFFF


_K7_N = _T * _L + 100  # a row past one pass
_K7_LENGTHS = [0, 1, 15, 16, 17, _L - 1, _L, _L + 1, _T * _L - 1, _T * _L, _K7_N]


@pytest.fixture(scope="module")
def k7_ragged():
    """Rows of width _K7_N at column offsets 0 and 3 of a wider seeded
    buffer (random bytes on both sides of every row), one row a length;
    with the plain version's crcs of each view."""
    rng = np.random.default_rng(12)
    out = {}
    for off in (0, 3):
        width = -(-(_K7_N + 64) // 16) * 16  # every row starts at an aligned offset
        buf = rng.integers(0, 256, (len(_K7_LENGTHS), width), dtype=np.uint8)
        buf[0, : width // 2] = np.frombuffer(_BASH[: width // 2], np.uint8)
        view = torch.from_numpy(buf)[:, off : off + _K7_N]
        lens = torch.tensor(_K7_LENGTHS, dtype=torch.int32)
        out[off] = (buf, C.crc32_batch(view, lens).numpy())
    return out


@pytest.mark.parametrize("off", [0, 3])
@pytest.mark.parametrize("n", _K7_LENGTHS)
def test_k7_model_on_design_edges_equals_plain_and_zlib(k7_ragged, off, n):
    buf, plain = k7_ragged[off]
    r = _K7_LENGTHS.index(n)
    edges = set()
    got = _k7_row(buf.reshape(-1), r * buf.shape[1] + off, n, edges)
    want = zlib.crc32(buf[r, off : off + n].tobytes())
    assert got == want == int(plain[r]) & 0xFFFFFFFF
    # the row reached the edges its length and start put it on
    assert ("short" in edges) == (n < 4)
    if n >= 4:
        assert ("misaligned start" in edges) == (off != 0)
        assert ("past the end" in edges) == ((off + n) % 16 != 0)
        span = -(-(off + n) // 16) * 16 - (off & ~15)  # e_up - p_al
        assert ("front zeros" in edges) == (span % (_T * _L) != 0)
        assert ("passes" in edges) == (span > _T * _L)


def test_k7_model_on_all_ff_rows():
    rows = np.full((3, _T * _L), 0xFF, np.uint8)
    flat = rows.reshape(-1)
    for r, n in enumerate((_T * _L, _T * _L - 5, 4)):
        assert _k7_row(flat, r * rows.shape[1] + 1, n - 1) == zlib.crc32(rows[r, 1:n].tobytes())
