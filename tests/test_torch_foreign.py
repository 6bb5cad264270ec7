"""The decode of foreign streams: the port's zran index, its copy of the
host inflater and `decompress_foreign` (device="cpu": K6's plain version,
the lockstep engine's torch ops) against the JAX package's, on streams
stdlib zlib and gzip wrote from slices of /bin/bash.

The JAX index pass runs its Python path here (its native pass is patched
out; no file of the JAX package changes), and so does the port's (its
card pass, `_build_index_card` and `_extract_card`, patched out beside
them; tests/test_torch_speculative.py holds the card pass against the
native one). That pass auto-detects zlib or
gzip only, so a raw stream's index is held against the JAX index of the
same body in a zlib wrapper, two bytes later; `extract` runs its Python
path too (its native region decoder patched out). Where the JAX Python path
records a point after the final block, its `decompress_foreign` raises;
the port skips regions that cover no output and decodes the stream."""

import gzip
import zlib

import pytest
import torch

import native_build  # noqa: F401  (the JAX package's native library, built once under a lock)

import zlib_rs_tpu.config as jc
import zlib_rs_tpu.models.inflate as JINF
import zlib_rs_tpu.models.zran as JZ
import zlib_rs_tpu.parallel.inflate as JI
from zlib_rs_tpu_torch import config as tc
from zlib_rs_tpu_torch.models import inflate as TINF
from zlib_rs_tpu_torch.models import zran as TZ
from zlib_rs_tpu_torch.parallel import inflate as TI
from zlib_rs_tpu_torch.parallel import pipeline as tp

# the test workers share the cores, and an oversubscribed OpenMP pool spin-waits
torch.set_num_threads(1)

_BASH = open("/bin/bash", "rb").read()


@pytest.fixture(autouse=True)
def _python_index(monkeypatch):
    monkeypatch.setattr(JZ, "_build_index_native", lambda data, span: None)
    monkeypatch.setattr(JZ, "_extract_native", lambda data, index, offset, length: None)
    monkeypatch.setattr(TZ, "_build_index_card", lambda data, span, device: None)
    monkeypatch.setattr(TZ, "_extract_card", lambda data, index, offset, length, device: None)


def _stream(wrap, data, level):
    if wrap == "zlib":
        return zlib.compress(data, level)
    if wrap == "gzip":
        return gzip.compress(data, level, mtime=0)
    c = zlib.compressobj(level, zlib.DEFLATED, -15)
    return c.compress(data) + c.flush()


def _points(index, shift=0):
    return [(p.out_offset, p.in_offset + shift, p.bits, p.hold, p.window) for p in index.points]


INDEX_CASES = [  # wrap, level, slice start, slice length, span
    ("zlib", 1, 0, 64 * 1024, 8 * 1024),
    ("zlib", 6, 300_000, 256 * 1024, 64 * 1024),
    ("zlib", 9, 600_000, 128 * 1024, 16 * 1024),
    ("gzip", 1, 100_000, 128 * 1024, 32 * 1024),
    ("gzip", 6, 0, 192 * 1024, 16 * 1024),
    ("gzip", 9, 400_000, 64 * 1024, 8 * 1024),
    ("raw", 1, 500_000, 256 * 1024, 64 * 1024),
    ("raw", 6, 200_000, 64 * 1024, 8 * 1024),
    ("raw", 9, 700_000, 128 * 1024, 32 * 1024),
]


@pytest.mark.parametrize("wrap,level,start,n,span", INDEX_CASES)
def test_build_index_equal_jax(wrap, level, start, n, span):
    data = _BASH[start : start + n]
    stream = _stream(wrap, data, level)
    got = TZ.build_index(stream, span, device="cpu")
    assert got.total_out == len(data) and len(got.points) >= 2
    if wrap == "raw":
        with pytest.raises(ValueError, match="header"):
            JZ.build_index(stream, span)
        want = JZ.build_index(zlib.compress(data, level), span)
        assert _points(got, shift=2) == _points(want)
    else:
        want = JZ.build_index(stream, span)
        assert _points(got) == _points(want)
    assert (got.total_out, got.wrapper_offset) == (want.total_out, want.wrapper_offset)
    for p in got.points:
        assert p.window == data[max(0, p.out_offset - 32768) : p.out_offset]


def _gzip_with_fields(data):
    """A gzip member with FEXTRA, FNAME, FCOMMENT and FHCRC set."""
    hdr = bytearray(b"\x1f\x8b\x08\x1e" + (1234567).to_bytes(4, "little") + b"\x02\x03")
    hdr += (6).to_bytes(2, "little") + b"ab\x02\x00xy" + b"name.bin\x00" + b"a comment\x00"
    hdr += (zlib.crc32(bytes(hdr)) & 0xFFFF).to_bytes(2, "little")
    body = _stream("raw", data, 6)
    return bytes(hdr) + body + zlib.crc32(data).to_bytes(4, "little") + (
        len(data).to_bytes(4, "little"))


def _inflator_case(name):
    """(window_bits, stream, input piece, output budget)."""
    data = _BASH[800_000:830_000]
    if name == "zlib":
        return 15, zlib.compress(data, 6), 701, 5_000
    if name == "gzip_fields":
        return 31, _gzip_with_fields(data), 333, None
    if name == "raw":
        return -15, _stream("raw", data, 9), 4_096, 1_000
    if name == "auto_gzip":
        return 47, gzip.compress(data, 1, mtime=0), 10_000, 2_048
    if name == "corrupt":
        z = bytearray(zlib.compress(data, 6))
        z[len(z) // 3] ^= 0x21
        return 15, bytes(z), 2_000, None
    if name == "bad_check":
        z = zlib.compress(data, 6)
        return 15, z[:-1] + bytes([z[-1] ^ 1]), 50_000, None
    raise KeyError(name)


def _drive(Inflator, InflateConfig, InflateFlush, window_bits, stream, piece, budget, flush):
    """Every call's (return code, input used, output, mark(), message),
    feeding `piece` bytes a call (twice as many after a call that moved
    nothing) with an output budget, until the stream ends or fails."""
    inf = Inflator(InflateConfig(window_bits=window_bits))
    log, pos, k = [], 0, piece
    for _ in range(10_000):
        rc, used, out = inf.inflate(stream[pos : pos + k], budget, getattr(InflateFlush, flush))
        log.append((int(rc), used, bytes(out), inf.mark(), inf.msg))
        pos += used
        if int(rc) != 0:
            break
        k = k * 2 if used == 0 and not out else piece
    return log


@pytest.mark.parametrize("flush", ["NO_FLUSH", "BLOCK"])
@pytest.mark.parametrize("name", ["zlib", "gzip_fields", "raw", "auto_gzip", "corrupt",
                                  "bad_check"])
def test_inflator_equal_jax(name, flush):
    case = _inflator_case(name)
    got = _drive(TINF.Inflator, tc.InflateConfig, tc.InflateFlush, *case, flush)
    want = _drive(JINF.Inflator, jc.InflateConfig, jc.InflateFlush, *case, flush)
    assert got == want
    ok = name not in ("corrupt", "bad_check")
    assert (got[-1][0] == int(tc.ReturnCode.StreamEnd)) == ok
    if ok:
        assert b"".join(e[2] for e in got) == _BASH[800_000:830_000]


def _foreign(name):
    data = _BASH[200_000:400_000]
    if name == "zlib":
        return data, zlib.compress(data, 9), 65_536
    if name == "raw":
        return data, _stream("raw", data, 9), 65_536
    if name == "gzip":
        return data, gzip.compress(data, 6, mtime=0), 1 << 20
    if name == "gzip_members":
        return data, b"".join(gzip.compress(data[k : k + 50_000], 1 + k // 50_000, mtime=0)
                              for k in range(0, len(data), 50_000)), 1 << 20
    raise KeyError(name)


@pytest.mark.parametrize("name", ["zlib", "raw", "gzip", "gzip_members"])
def test_decompress_foreign_equal_jax(name):
    data, stream, span = _foreign(name)
    tp._FALLBACKS.clear()
    got = TI.decompress_foreign(stream, span, device="cpu")
    assert got == data and tp.fallback_stats() == {}
    if name == "raw":
        # the JAX Python index pass does not read raw streams; the same
        # body in a zlib wrapper decodes to the same bytes
        with pytest.raises(ValueError, match="header"):
            JI.decompress_foreign(stream, span)
        assert JI.decompress_foreign(_foreign("zlib")[1], span) == got
    else:
        assert JI.decompress_foreign(stream, span) == got


def test_decompress_foreign_point_after_final_block():
    """The Python index pass records a point after the final block when
    that block ends a span past the last point; the JAX package decodes
    the trailer as a region and raises, the port skips it."""
    data = _BASH[:30_000]
    stream = zlib.compress(data, 6)
    index = TZ.build_index(stream, 8_192, device="cpu")
    assert index.points[-1].out_offset == index.total_out
    with pytest.raises(ValueError, match="failed to decode"):
        JI.decompress_foreign(stream, 8_192)
    assert TI.decompress_foreign(stream, 8_192, device="cpu") == data


@pytest.mark.parametrize("engine", ["lockstep", "kernel"])
def test_decompress_foreign_engines(engine):
    """A zlib stream of small blocks, 6 regions with sub-byte starts and
    no point after its final block: each engine gives the JAX lockstep
    engine's bytes. The JAX kernel engine refuses the stream's first
    region, which covers no output (the stream's start, cut again by the
    index's first point); the port does not decode it."""
    data = _BASH[500_000:524_000]
    c = zlib.compressobj(6, zlib.DEFLATED, 15, 1)
    stream = c.compress(data) + c.flush()
    index = TZ.build_index(stream, 4_096, device="cpu")
    assert index.points[-1].out_offset < index.total_out
    assert sum(p.bits != 0 for p in index.points) >= 2
    assert TI.decompress_foreign(stream, 4_096, engine, device="cpu") == data
    assert JI.decompress_foreign(stream, 4_096, "lockstep") == data
    if engine == "kernel":
        with pytest.raises(ValueError, match="region 0 failed"):
            JI.decompress_foreign(stream, 4_096, engine)


@pytest.mark.parametrize("name", ["zlib", "gzip", "gzip_members"])
def test_decompress_foreign_bad_check_raises(name):
    data, stream, span = _foreign(name)
    if name == "zlib":
        bad = stream[:-1] + bytes([stream[-1] ^ 1])  # the adler32
    else:
        bad = stream[:-5] + bytes([stream[-5] ^ 1]) + stream[-4:]  # the last member's crc32
    with pytest.raises(ValueError, match="incorrect data check"):
        TI.decompress_foreign(bad, span, device="cpu")
    with pytest.raises(ValueError, match="incorrect data check"):
        JI.decompress_foreign(bad, span)


@pytest.mark.parametrize("wrap,level,start,n,span", [c for c in INDEX_CASES if c[0] != "raw"])
def test_extract_equal_jax(wrap, level, start, n, span):
    """zran's extract through the port's index against the JAX package's:
    before, at and between points, across a point, at the end and past
    it."""
    data = _BASH[start : start + n]
    stream = _stream(wrap, data, level)
    got_ix, want_ix = TZ.build_index(stream, span, device="cpu"), JZ.build_index(stream, span)
    p1 = got_ix.points[1].out_offset
    for off, length in ((0, 1000), (p1, 700), (p1 - 300, 600), (n // 2 + 17, 5000),
                        (n - 100, 1000), (n, 10), (n + 5, 10)):
        got = TZ.extract(stream, got_ix, off, length, device="cpu")
        assert got == JZ.extract(stream, want_ix, off, length)
        assert got == data[off : off + length]


def test_extract_raw_stream():
    """A raw stream, which the JAX Python index pass refuses: the port's
    index starts at bit 0 and extract reads through it."""
    data = _BASH[200_000:264_000]
    stream = _stream("raw", data, 6)
    ix = TZ.build_index(stream, 8 * 1024, device="cpu")
    for off in (0, 9_999, 40_000, len(data) - 1):
        assert TZ.extract(stream, ix, off, 3000, device="cpu") == data[off : off + 3000]


# ---------------------------------------------------------------------------
# the gzip split: each member skimmed by the speculative decode
# ---------------------------------------------------------------------------


def _members(k: int) -> tuple[bytes, bytes]:
    """k stdlib gzip members of slices of /bin/bash at mixed levels."""
    data = _BASH[250_000:250_000 + 60_000 * k]
    parts = [data[i * 60_000 : (i + 1) * 60_000] for i in range(k)]
    return data, b"".join(gzip.compress(p, (1, 9, 6, 0)[i % 4], mtime=0)
                          for i, p in enumerate(parts))


@pytest.fixture
def skims(monkeypatch):
    """The rooms of the port's member skims (speculative.skim calls); each
    call's input length goes into `skims.reads`."""
    from zlib_rs_tpu_torch.parallel import speculative as SP

    class Rooms(list):
        reads: list

    rooms = Rooms()
    rooms.reads = []
    real = SP.skim

    def spy(data, max_out, *, device=None, stats=None):
        rooms.append(max_out)
        rooms.reads.append(len(data))
        return real(data, max_out, device=device, stats=stats)

    monkeypatch.setattr(SP, "skim", spy)
    return rooms


@pytest.mark.parametrize("k", [1, 2, 4])
def test_gzip_split_on_the_speculative_decode_equal_jax_native(skims, k):
    """The port skims every member on the speculative decode, as the JAX
    package skims them with native's zran_index (built with g++ here)."""
    import zlib_rs_tpu.native as JN

    assert JN.available()
    data, stream = _members(k)
    tp._FALLBACKS.clear()
    got = TI.decompress_foreign(stream, device="cpu")
    assert got == data == JI.decompress_foreign(stream) and tp.fallback_stats() == {}
    assert len(skims) == k  # 60 kB members: every first read holds its member


def test_gzip_split_reads_each_members_own_bytes(skims, monkeypatch):
    """16 members of 6 kB with SKIM_FIRST and SKIM_MIN cut to 1 KiB: the
    first member's skim grows its read 4x on each truncation, the next ones
    read twice the last body, and the skims read under 3 times the file in
    all (a skim of
    each member's whole rest would read it about 8 times over). The bytes
    equal the JAX package's split with native built."""
    import zlib_rs_tpu.native as JN

    assert JN.available()
    monkeypatch.setattr(TI, "SKIM_FIRST", 1024)
    monkeypatch.setattr(TI, "SKIM_MIN", 1024)
    data = _BASH[250_000:250_000 + 16 * 6_000]
    stream = b"".join(gzip.compress(data[i : i + 6_000], (1, 9, 6, 0)[(i // 6_000) % 4], mtime=0)
                      for i in range(0, len(data), 6_000))
    assert TI.decompress_foreign(stream, device="cpu") == data == JI.decompress_foreign(stream)
    assert skims.reads[:2] == [1024, 4096] and len(skims) > 16
    assert sum(skims.reads) < 3 * len(stream), (skims.reads, len(stream))


def test_gzip_split_room_grows_past_the_references(skims):
    """2 MiB of zeros in one member: the first room (4 x the body plus 1
    MiB, the reference's) is too small, and the port grows it 4x, up to
    deflate's limit. The reference raises BufferError on the same member
    (a reference note, not a contract of the port)."""
    data = bytes(2 << 20)
    stream = gzip.compress(data, 6, mtime=0)
    assert TI.decompress_foreign(stream, device="cpu") == data
    body = len(stream) - 10  # past gzip's 10-byte header, the trailer included
    first, cap = 4 * body + (1 << 20), TI.DEFLATE_MAX_RATIO * body + (1 << 20)
    assert skims == [first, min(4 * first, cap)] and first < len(data) <= skims[-1]
    with pytest.raises(BufferError):
        JI.decompress_foreign(stream)


def test_gzip_split_truncated_member_raises():
    data, stream = _members(2)
    with pytest.raises(ValueError):
        TI.decompress_foreign(stream[: len(stream) - 20_000], device="cpu")
