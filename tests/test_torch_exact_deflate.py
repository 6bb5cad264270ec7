"""EX (csrc/exact_deflate.cu) and the routes into the native engine's port:
`parallel/chunk_deflate` (deflate_chunk, deflate_parallel),
`parallel/speculative.inflate_raw`, `models/medium`'s dictionary, and the
one-shot `compress`/`decompress` card routes, on the CPU.

The reference is the JAX package's C++ native engine (`zlib_rs_tpu.native`,
built with g++ here) and stdlib zlib: for levels 1-9 every output is held
to both on inputs where they agree, and EX follows zlib where native does
not (native never hashes a dictionary's last two positions; zlib inserts
them once the chunk's bytes complete their strings). EX's own source
compiles as host C++ (a warp of one lane) and runs here against native and
zlib, so that its control flow is tested before the card; the plain
version (the port's host engines) runs under device="cpu". Every
comparison is exact."""

import ctypes
import gzip
import re
import shutil
import subprocess
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import native_build  # noqa: F401  (the JAX package's native library, built once under a lock)

import zlib_rs_tpu.models.oneshot as joneshot
from zlib_rs_tpu import native
from zlib_rs_tpu_torch import _device
from zlib_rs_tpu_torch.models import medium, oneshot
from zlib_rs_tpu_torch.ops.kernels import exact_deflate_kernel as EK
from zlib_rs_tpu_torch.parallel import chunk_deflate as CD
from zlib_rs_tpu_torch.parallel import speculative as S

# the test workers share the cores, and an oversubscribed OpenMP pool spin-waits
torch.set_num_threads(1)

_BASH = open("/bin/bash", "rb").read()
OFF = 100_000  # a slice of /bin/bash where native and zlib agree at every level
DATA = _BASH[OFF : OFF + 12_000]
WINDOW = _BASH[OFF - 40_000 : OFF]  # cut to its last 32 KiB
PAR = _BASH[OFF : OFF + 16_384]
SRC = Path(__file__).resolve().parents[1] / "zlib_rs_tpu_torch" / "csrc" / "exact_deflate.cu"
MODES = [CD.QUICK, CD.MEDIUM4, CD.MEDIUM5, CD.MEDIUM6]


def zraw(data: bytes, level: int, final: bool = True, window: bytes = b"") -> bytes:
    """stdlib zlib's raw deflate of `data` primed with `window`."""
    kw = {"zdict": window[-32768:]} if window else {}
    c = zlib.compressobj(level, zlib.DEFLATED, -15, 8, 0, **kw)
    return c.compress(data) + c.flush(zlib.Z_FINISH if final else zlib.Z_SYNC_FLUSH)


# ---------------------------------------------------------------------------
# the kernel's source as host C++
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def host_ex(tmp_path_factory):
    """csrc/exact_deflate.cu built by g++ (no __CUDACC__: one lane)."""
    gxx = shutil.which("g++")
    assert gxx, "g++ builds the reference's native engine and this file's host build"
    lib = tmp_path_factory.mktemp("ex") / "libex_host.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-x", "c++", str(SRC), "-o",
                    str(lib)], check=True, capture_output=True, timeout=300)
    dll = ctypes.CDLL(str(lib))
    dll.zrs_exact_deflate_host.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + \
        [ctypes.c_void_p] * 3
    dll.zrs_exact_deflate_work_bytes.restype = ctypes.c_longlong

    def run(buf: bytes, rows, level: int):
        """EX's control flow over rows of (start, len, dict_len, final):
        (out, lens, status) as the kernel lays them out."""
        meta = CD.chunk_meta(rows, level)
        data = np.frombuffer(buf + bytes(1), np.uint8).copy()
        out = np.zeros(max(EK.out_bytes(torch.from_numpy(meta)), 1), np.uint8)
        lens = np.zeros(len(rows), np.int64)
        st = np.zeros(len(rows), np.int32)
        assert dll.zrs_exact_deflate_host(data.ctypes.data, meta.ctypes.data, len(rows), level,
                                          out.ctypes.data, lens.ctypes.data, st.ctypes.data) == 0
        parts = [out[m[4] : m[4] + min(n, m[5])].tobytes() for m, n in zip(meta, lens)]
        return parts, lens, st, meta

    run.dll = dll
    return run


def _host_chunk(host_ex, data: bytes, level: int, final: bool, window: bytes) -> bytes:
    w = window[-32768:]
    parts, _lens, st, _m = host_ex(w + data, [(len(w), len(data), len(w), int(final))], level)
    assert st.tolist() == [0]
    return parts[0]


def test_host_build_equals_native_and_zlib(host_ex):
    """Every mode, primed and not, final and not, on binary, random and
    repetitive bytes of several sizes (an empty chunk, one byte, blocks
    flushed at 16,383 symbols, stored escapes)."""
    rnd = np.random.default_rng(5).integers(0, 256, 70_000, dtype=np.uint8).tobytes()
    rep = b"abcabcabd" * 8000
    n_cases = 0
    for src, off, n in ((_BASH, OFF, 12_000), (_BASH, 5, 1), (_BASH, 0, 0), (rnd, 40_000, 20_000),
                        (rep, 33_000, 30_000), (_BASH, OFF, 70_000)):
        data = src[off : off + n]
        for dl in (0, 2, 40_000):
            window = src[max(0, off - dl) : off]
            for final in (True, False):
                for level in [*range(10), *MODES]:
                    got = _host_chunk(host_ex, data, level, final, window)
                    want = native.deflate_chunk(data, level, final, window or None)
                    if 1 <= level <= 9:
                        assert got == zraw(data, level, final, window), (off, n, dl, final, level)
                    if got != want:  # only native's dictionary tail may differ
                        assert 1 <= level <= 9 and len(window) >= 2, (off, n, dl, final, level)
                    n_cases += 1
    assert n_cases == 6 * 3 * 2 * 14


def test_host_build_follows_zlib_on_the_dictionary_tail(host_ex):
    """A chunk of zeros after a window ending in zeros: zlib matches from
    the window's last two positions, which native never hashes. EX gives
    zlib's bytes, as the plain version does."""
    off = 36_867  # the window ends in 00 00, the chunk starts 00 00 00 00
    data, window = _BASH[off : off + 2000], _BASH[off - 32768 : off]
    for level in (1, 6):
        got = _host_chunk(host_ex, data, level, True, window)
        assert got == zraw(data, level, True, window) == CD.deflate_chunk(
            data, level, True, window, device="cpu")
        assert got != native.deflate_chunk(data, level, True, window)


def test_host_build_in_the_parallel_layout(host_ex):
    """deflate_parallel's layout (chunk k's window the bytes before it in
    one buffer, the next chunk's bytes after it): each chunk reads nothing
    past its end; the joined stream is zlib's chunk by chunk at levels 1-9
    (native's where native hashes the whole window) and native's in QUICK
    and MEDIUM."""
    data = _BASH[OFF : OFF + 200_000]
    n = len(data)
    for level in (1, 6, 9, CD.QUICK, CD.MEDIUM5):
        for chunk in (4096, 65_536):
            for prime in (True, False):
                rows = [(lo, min(n, lo + chunk) - lo, min(32768, lo) if prime and lo else 0,
                         int(lo + chunk >= n)) for lo in range(0, n, chunk)]
                parts, _lens, st, _m = host_ex(data, rows, level)
                assert not st.any()
                got = b"".join(parts)
                if level <= 9:
                    assert parts == [zraw(data[lo : lo + ln], level, bool(fin),
                                          data[lo - dl : lo]) for lo, ln, dl, fin in rows]
                    assert prime or got == native.deflate_parallel(data, level, chunk, prime)
                else:
                    assert got == native.deflate_parallel(data, level, chunk, prime)


def test_host_build_reports_an_overflow(host_ex):
    """An output past its room: the length still counts it, the status is
    native's -1, and the bytes within the room are the stream's first."""
    data = np.random.default_rng(2).integers(0, 256, 30_000, dtype=np.uint8).tobytes()
    want = native.deflate_chunk(data, 1)
    meta = np.array([[0, len(data), 0, 1, 0, 1000]], np.int64)
    buf = np.frombuffer(data, np.uint8).copy()
    out, lens, st = np.zeros(1000, np.uint8), np.zeros(1, np.int64), np.zeros(1, np.int32)
    host_ex.dll.zrs_exact_deflate_host(buf.ctypes.data, meta.ctypes.data, 1, 1, out.ctypes.data,
                                       lens.ctypes.data, st.ctypes.data)
    assert (int(lens[0]), int(st[0])) == (len(want), EK.OVERFLOW)
    assert out.tobytes() == want[:1000]
    got, glens, gst = EK.exact_deflate_plain(torch.from_numpy(buf), torch.from_numpy(meta), 1)
    assert (glens.tolist(), gst.tolist(), got.numpy().tobytes()) == \
        ([len(want)], [EK.OVERFLOW], want[:1000])


def test_constants_match_the_source(host_ex):
    src = SRC.read_text()
    for name, value in (("kWorkBytes", "300 * 1024"), ("kWork4Bytes", "320 * 1024"),
                        ("kMeta", "6"), ("kOverflow", "-1")):
        assert re.search(rf"{name} = {re.escape(value)};", src), name
    assert (EK.WORK_BYTES, EK.WORK4_BYTES, EK.META, EK.OVERFLOW) == \
        (300 * 1024, 320 * 1024, 6, -1)
    for level in (0, 6, 9, CD.QUICK, *MODES):
        assert host_ex.dll.zrs_exact_deflate_work_bytes(level) == EK.work_bytes(level)
    assert "exact_deflate" in _device.SOURCES


# ---------------------------------------------------------------------------
# the plain version and the entry points against native
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("level", range(10))
def test_plain_final_levels_equal_native(level):
    got = CD.deflate_chunk(DATA, level, device="cpu")
    assert got == native.deflate_chunk(DATA, level)
    if level:
        assert got == zraw(DATA, level)


@pytest.mark.parametrize("level", [0, 1, 6, 9])
def test_plain_primed_and_not_final_equal_native(level):
    got = CD.deflate_chunk(DATA, level, False, WINDOW, device="cpu")
    assert got == native.deflate_chunk(DATA, level, False, WINDOW)
    assert got.endswith(b"\x00\x00\xff\xff")
    if level:
        assert got == zraw(DATA, level, False, WINDOW)


@pytest.mark.parametrize("primed", [False, True])
@pytest.mark.parametrize("level", MODES)
def test_plain_quick_and_medium_equal_native(level, primed):
    window = WINDOW if primed else None
    for final in (True, False):
        got = CD.deflate_chunk(DATA[:8000], level, final, window, device="cpu")
        assert got == native.deflate_chunk(DATA[:8000], level, final, window), final
        assert zlib.decompressobj(-15, zdict=(window or b"")[-32768:]).decompress(got) == \
            DATA[:8000]


@pytest.mark.parametrize("chunk", [4096, 16_384])
@pytest.mark.parametrize("prime", [True, False])
@pytest.mark.parametrize("level", [1, 6, CD.QUICK, CD.MEDIUM6])
def test_plain_parallel_equals_native(level, prime, chunk):
    got = CD.deflate_parallel(PAR, level, chunk, prime, device="cpu")
    assert got == native.deflate_parallel(PAR, level, chunk, prime)
    assert zlib.decompress(got, -15) == PAR


def test_parallel_is_the_primed_chunks_joined():
    chunk = 4096
    parts = [CD.deflate_chunk(PAR[lo : lo + chunk], 6, lo + chunk >= len(PAR),
                              PAR[max(0, lo - 32768) : lo], device="cpu")
             for lo in range(0, len(PAR), chunk)]
    assert CD.deflate_parallel(PAR, 6, chunk, device="cpu") == b"".join(parts)


@pytest.mark.parametrize("level", [-1, -5, 0, 6, 10, 12, 14, 99])
def test_levels_and_empty_input_as_native(level):
    assert CD.normalize_level(level) == (6 if level < 0 else 9 if level in (14, 99) else level)
    assert CD.deflate_parallel(b"", level, device="cpu") == \
        native.deflate_parallel(b"", CD.normalize_level(level))
    assert CD.deflate_chunk(b"", level, False, device="cpu") == \
        native.deflate_chunk(b"", level, False)
    assert CD.deflate_chunk(DATA[:700], level, device="cpu") == \
        native.deflate_chunk(DATA[:700], level)


def test_plain_operands_and_the_empty_stored_block():
    """EX's operands (one buffer, rows with room) and the one case where
    the host engine and native lay level 0 out differently: an empty chunk
    that is not final (native's empty stored block before the seam)."""
    assert EK.plain_chunk(b"", 0, False, b"") == native.deflate_chunk(b"", 0, False) == \
        EK.EMPTY_STORED + b"\x00\x00\x00\xff\xff"
    data = torch.from_numpy(np.frombuffer(WINDOW + DATA, np.uint8).copy())
    meta = torch.tensor([[len(WINDOW), 3000, 32768, 0, 0, 20_000],
                         [len(WINDOW) + 3000, 5000, 0, 1, 20_000, 9000]], dtype=torch.int64)
    out, lens, st = EK.exact_deflate(data, meta, 6)
    assert out.shape == (29_000,) and lens.dtype == torch.int64 and st.tolist() == [0, 0]
    assert out[: lens[0]].numpy().tobytes() == native.deflate_chunk(DATA[:3000], 6, False, WINDOW)
    assert out[20_000 : 20_000 + lens[1]].numpy().tobytes() == \
        native.deflate_chunk(DATA[3000:8000], 6)
    with pytest.raises(ValueError, match="outside the data"):
        EK.exact_deflate(data, torch.tensor([[10, 5, 20, 1, 0, 100]]), 6)
    with pytest.raises(ValueError, match="level"):
        EK.exact_deflate(data, meta, 14)


@pytest.mark.parametrize("level", [4, 5, 6])
def test_medium_dictionary_equals_native(level):
    for final in (True, False):
        got = medium.compress_medium(DATA[:6000], level, final, WINDOW)
        assert got == native.deflate_chunk(DATA[:6000], native.MEDIUM_BASE + level - 4, final,
                                           WINDOW)
    got = medium.compress_quick(DATA[:6000], False, WINDOW)
    assert got == native.deflate_chunk(DATA[:6000], native.QUICK, False, WINDOW)


def test_no_gpu_raises():
    assert not torch.cuda.is_available()
    for call in (lambda: CD.deflate_chunk(DATA[:100]), lambda: CD.deflate_parallel(DATA[:100]),
                 lambda: S.inflate_raw(zraw(DATA[:100], 6), 1000),
                 lambda: oneshot.compress(DATA[:100]),
                 lambda: oneshot.decompress(zlib.compress(DATA[:100]))):
        with pytest.raises(RuntimeError, match="CUDA device"):
            call()


# ---------------------------------------------------------------------------
# inflate_raw
# ---------------------------------------------------------------------------


def _result(fn, *args, **kw):
    """fn's result, or its error as (type name, message): the port's error
    classes mirror the reference's under the same names."""
    try:
        return fn(*args, **kw)
    except Exception as e:  # noqa: BLE001 - the error is the result compared
        return type(e).__name__, str(e)


@pytest.mark.parametrize("level", [0, 1, 9])
def test_inflate_raw_equals_native(level):
    raw = zraw(DATA, level) + b"after the stream"
    for cap in (len(DATA), len(DATA) - 1, 1):
        want = native.inflate_raw(raw, cap) if cap >= len(DATA) else None
        got = _result(S.inflate_raw, raw, cap, device="cpu")
        assert got == (want if want else _result(native.inflate_raw, raw, cap))
    assert S.inflate_raw(raw, 1 << 20, device="cpu") == (DATA, len(raw) - 16)


def test_inflate_raw_errors_as_native():
    raw = zraw(DATA, 6)
    cases = {"truncated": raw[: len(raw) // 2], "empty": b"", "no final block": zraw(DATA, 6,
             False), "type 3": b"\x07" + raw[1:],
             "a distance too far": zraw(DATA[:3000], 6, True, DATA[3000:])}
    seen = set()
    for name, bad in cases.items():
        got = _result(S.inflate_raw, bad, 1 << 16, device="cpu")
        assert got == _result(native.inflate_raw, bad, 1 << 16), name
        seen.add(got[1] if isinstance(got[0], str) else "ok")
    assert seen == {"invalid deflate data", "truncated deflate data"}


# ---------------------------------------------------------------------------
# the one-shot card routes against the reference's native routes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window_bits", [15, 31, -15])
@pytest.mark.parametrize("level", [0, 1, 6, 9, None, -1])
def test_oneshot_compress_equals_native_route(level, window_bits):
    assert native.available()
    got = oneshot.compress(DATA, level, window_bits=window_bits, device="cpu")
    assert got == joneshot.compress(DATA, level, window_bits=window_bits)


@pytest.mark.parametrize("speculative", [False, True])
def test_oneshot_decompress_equals_native_route(monkeypatch, speculative):
    """zlib, gzip (with a name and a comment) and raw streams through the
    card's route (inflate_speculative: one exact decode from bit 0, or,
    with segments lowered to 2 KiB, segments decoded in parallel and
    chained), and the shapes it hands the host engine: FDICT, a damaged
    checksum, a cut trailer, a corrupt body, another window size."""
    if speculative:
        monkeypatch.setattr(S, "SEGMENT_BYTES", 2048)
    calls = []
    real = oneshot.card_inflate
    monkeypatch.setattr(oneshot, "card_inflate",
                        lambda p, d: calls.append(len(p)) or real(p, d))
    gz = bytearray(gzip.compress(DATA, 6))
    gz[3] |= 0x18  # FNAME and FCOMMENT
    gz[10:10] = b"name\x00comment\x00"
    c = zlib.compressobj(6, zlib.DEFLATED, 15, zdict=WINDOW[-2000:])
    fdict = c.compress(DATA) + c.flush()
    z = zlib.compress(DATA, 9)
    streams = {"zlib": (z, 47), "gzip": (bytes(gz), 47), "raw": (zraw(DATA, 1), -15),
               "zlib-15": (z, 15), "gzip-31": (gzip.compress(DATA), 31)}
    bad = {"fdict": (fdict, 47), "adler": (z[:-1] + bytes([z[-1] ^ 1]), 47),
           "cut": (gzip.compress(DATA)[:-5], 47), "body": (z[:40] + bytes(20) + z[60:], 47),
           "wbits": (zlib.compress(DATA)[:], 9 + 32),
           "isize": (gzip.compress(DATA)[:-4] + (len(DATA) + 1).to_bytes(4, "little"), 47)}
    for name, (s, wb) in streams.items():
        calls.clear()
        got = oneshot.decompress(s, window_bits=wb, device="cpu")
        assert got == joneshot.decompress(s, window_bits=wb) == DATA, name
        assert len(calls) == 1, name
    for name, (s, wb) in bad.items():
        assert _result(oneshot.decompress, s, window_bits=wb, device="cpu") == \
            _result(joneshot.decompress, s, window_bits=wb), name
