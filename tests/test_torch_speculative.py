"""The speculative decode of an unindexed raw-deflate stream
(parallel/speculative.py over SP1-SP3 of ops/kernels/speculative_kernel.py,
device="cpu": the plain versions) against the reference's native engine
(zlib_rs_tpu.native, compared only where it builds), stdlib zlib and the
JAX package's zran index, on slices of /bin/bash and a text/random mix at
levels 0, 1, 6 and 9 and under Z_FIXED, with segments of 2-16 KiB of input
so that windows cross several segments. Also numpy models of SP1's two
passes (the pre-filter's survivor list and the full check's per-segment
minimum), of the fixed-code and code-length decodes SP1 does without
tables, and of SP3's pointer jumping."""

import zlib

import numpy as np
import pytest
import torch

import native_build  # noqa: F401  (the JAX package's native library, built once under a lock)

import zlib_rs_tpu.models.zran as JZ
import zlib_rs_tpu.parallel.inflate as JI
from zlib_rs_tpu import native
from zlib_rs_tpu_torch import config as tc
from zlib_rs_tpu_torch.models import inflate as TINF
from zlib_rs_tpu_torch.models import zran as TZ
from zlib_rs_tpu_torch.ops.kernels import speculative_kernel as SK
from zlib_rs_tpu_torch.parallel import inflate as TI
from zlib_rs_tpu_torch.parallel import pipeline as tp
from zlib_rs_tpu_torch.parallel import speculative as S

# the test workers share the cores, and an oversubscribed OpenMP pool spin-waits
torch.set_num_threads(1)

_BASH = open("/bin/bash", "rb").read()
SEGMENTS = (2048, 16384)


def _mix(n: int, seed: int) -> bytes:
    """Text of a small vocabulary, random bytes and repeated runs."""
    rng = np.random.default_rng(seed)
    words = [b"alpha", b"beta", b"gamma", b"delta", b"epsilon", b"zeta", b"theta", b"iota",
             b"kappa", b"lambda", b"\n", b"0123456789", b"the", b"of", b"and"]
    out = bytearray()
    while len(out) < n:
        kind = rng.integers(0, 4)
        if kind < 2:
            out += b" ".join(words[i] for i in rng.integers(0, len(words), 200))
        elif kind == 2:
            out += rng.integers(0, 256, int(rng.integers(100, 3000)), dtype=np.uint8).tobytes()
        else:
            out += bytes(out[-int(rng.integers(50, 400)):]) * int(rng.integers(2, 20))
    return bytes(out[:n])


def _data(src: str) -> bytes:
    return _BASH[400_000 : 400_000 + 128 * 1024] if src == "bash" else _mix(128 * 1024, 7)


def _raw(data: bytes, level, strategy=zlib.Z_DEFAULT_STRATEGY) -> bytes:
    c = zlib.compressobj(level, zlib.DEFLATED, -15, 8, strategy)
    return c.compress(data) + c.flush()


LEVELS = [0, 1, 6, 9, "fixed"]


def _stream(src, level):
    data = _data(src)
    if level == "fixed":
        return data, _raw(data, 6, zlib.Z_FIXED)
    return data, _raw(data, level)


def _outcome(fn):
    try:
        return fn()
    except (ValueError, BufferError) as e:
        return type(e), str(e)


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("src", ["bash", "mix"])
def test_inflate_speculative_equal_native(src, level, monkeypatch):
    data, raw = _stream(src, level)
    for seg in SEGMENTS:
        monkeypatch.setattr(S, "SEGMENT_BYTES", seg)
        stats = {}
        out, used = S.inflate_speculative(raw, 4 * len(data), device="cpu", stats=stats)
        assert out == data and used == len(raw)
        assert stats["segments"] == max(1, len(raw) // seg) and stats["segment_bytes"] == seg
        if native.available():
            assert (out, used) == native.inflate_speculative(raw, 4 * len(data))
    # zlib's own reading of the stream
    d = zlib.decompressobj(-15)
    assert d.decompress(raw) == data and not d.unused_data


@pytest.mark.parametrize("src,level,span", [("bash", 6, 16384), ("mix", 1, 8192),
                                            ("mix", 9, 32768), ("bash", 0, 8192),
                                            ("mix", "fixed", 16384)])
def test_zran_index_equal_native(src, level, span, monkeypatch):
    data, raw = _stream(src, level)
    for seg in (4096, 8192):
        monkeypatch.setattr(S, "SEGMENT_BYTES", seg)
        full, points, used = S.zran_index(raw, span, 4 * len(data), device="cpu")
        assert full == data and used == len(raw)
        assert all(b - a >= span for (a, _), (b, _) in zip(points, points[1:]))
        if native.available():
            assert (full, points, used) == native.zran_index(raw, span, 4 * len(data))


@pytest.mark.parametrize("level", LEVELS)
def test_skim_equal_native_and_truncated_on_every_prefix(level, monkeypatch):
    """skim (no SP3, no output) of a raw stream with bytes after it, as a
    gzip member has its trailer and the next member: the output size and
    the input used equal zran_index's and native's; every prefix that
    ends inside the stream raises "truncated deflate data", as native's
    zran_index does on it, which is what lets the gzip split grow its
    read."""
    data, raw = _stream("mix", level)
    monkeypatch.setattr(S, "SEGMENT_BYTES", 4096)
    tail = bytes(8) + _raw(data[:5000], 6)
    got = S.skim(raw + tail, 4 * len(data), device="cpu")
    assert got == (len(data), len(raw))
    if native.available():
        full, _points, used = native.zran_index(raw + tail, 1 << 62, 4 * len(data))
        assert got == (len(full), used)
    for cut in (1, 4095, 4097, len(raw) // 2, len(raw) - 1):
        want = (ValueError, "truncated deflate data")
        assert _outcome(lambda: S.skim(raw[:cut], 4 * len(data), device="cpu")) == want
        if native.available():
            assert _outcome(lambda: native.zran_index(raw[:cut], 1 << 62, 4 * len(data))) == want


def _wrapped(wrap, data, level):
    """zlib, gzip or raw at memLevel 2 (blocks of about 500 symbols, so
    that a small stream has many block starts)."""
    c = zlib.compressobj(level, zlib.DEFLATED, {"zlib": 15, "gzip": 31, "raw": -15}[wrap], 2)
    return c.compress(data) + c.flush()


def _ix_fields(ix):
    return ([(p.out_offset, p.in_offset, p.bits, p.hold, p.window) for p in ix.points],
            ix.total_out, ix.wrapper_offset)


@pytest.mark.parametrize("wrap,level,span", [("zlib", 6, 16384), ("gzip", 9, 8192),
                                             ("raw", 1, 16384)])
def test_build_index_and_extract_equal_jax(wrap, level, span, monkeypatch):
    """The port's card pass against the JAX package's native pass, field
    by field, and extract through both; where native does not build, the
    JAX package's Python path is the reference and only the bytes are
    held."""
    monkeypatch.setattr(S, "SEGMENT_BYTES", 4096)
    data = _mix(96 * 1024, 11)
    stream = _wrapped(wrap, data, level)
    got = TZ.build_index(stream, span, device="cpu")
    assert got.total_out == len(data) and len(got.points) >= 2
    assert all(p.out_offset > 0 for p in got.points)
    for p in got.points:
        assert p.window == data[max(0, p.out_offset - 32768) : p.out_offset]
    if native.available():
        want = JZ.build_index(stream, span)
        assert _ix_fields(got) == _ix_fields(want)
    p1 = got.points[1].out_offset
    for off, length in ((0, 1000), (p1, 700), (p1 - 300, 600), (len(data) // 2 + 17, 5000),
                        (len(data) - 100, 1000), (len(data), 10)):
        back = TZ.extract(stream, got, off, length, device="cpu")
        assert back == data[off : off + length]
        if native.available():
            assert back == JZ.extract(stream, want, off, length)


def test_build_index_falls_back_where_native_does(monkeypatch):
    """A multi-member gzip and a bad adler32: the card pass returns None
    (as native's does) and the host pass runs; a flipped body byte is a
    data fault, which returns None too."""
    import gzip

    calls = []
    real = TZ._build_index_card

    def spy(data, span, device):
        got = real(data, span, device)
        calls.append(got is None)
        return got

    monkeypatch.setattr(TZ, "_build_index_card", spy)
    data = _mix(40 * 1024, 3)
    two = gzip.compress(data[:20_000], 6, mtime=0) + gzip.compress(data[20_000:], 6, mtime=0)
    z = zlib.compress(data, 6)
    bad = z[:-1] + bytes([z[-1] ^ 1])
    assert TZ._build_index_card(two, 8192, "cpu") is None
    assert TZ._build_index_card(bad, 8192, "cpu") is None
    flipped = bytearray(z)
    flipped[len(z) // 2] ^= 0x10
    if native.available():
        assert JZ._build_index_native(bytes(flipped), 8192) is None
        assert JZ._build_index_native(two, 8192) is None
        assert JZ._build_index_native(bad, 8192) is None
    assert TZ._build_index_card(bytes(flipped), 8192, "cpu") is None
    ix = TZ.build_index(_wrapped("zlib", data, 6), 8192, device="cpu")
    assert calls[-1] is False and ix.wrapper_offset == 2


def test_decompress_foreign_through_the_card_index():
    """decompress_foreign's zran_index stage runs the card pass; the
    regions it cuts decode to the stream, equal to the JAX package's
    with its native pass in place."""
    data = _BASH[600_000 : 600_000 + 96 * 1024]
    stream = zlib.compress(data, 6)
    tp._FALLBACKS.clear()
    got = TI.decompress_foreign(stream, 16384, device="cpu")
    assert got == data and tp.fallback_stats() == {}
    ix = TZ.build_index(stream, 16384, device="cpu")
    if native.available():
        assert _ix_fields(ix) == _ix_fields(JZ.build_index(stream, 16384))
        assert JI.decompress_foreign(stream, 16384) == got


def test_wrapper_errors_propagate_out_of_build_index(monkeypatch):
    """Only native's data faults send build_index to the host pass: a
    wrapper's argument or size-limit error propagates out of build_index,
    and one of K6's out of extract."""
    data = _mix(40 * 1024, 4)
    stream = zlib.compress(data, 6)
    ix = TZ.build_index(stream, 8192, device="cpu")
    host = []
    real_inflator = TZ.Inflator

    def spy(*a, **k):
        host.append(1)
        return real_inflator(*a, **k)

    monkeypatch.setattr(TZ, "Inflator", spy)
    # words too short for the stream: an argument error, not a data fault
    monkeypatch.setattr(SK, "stream_words", lambda d: np.zeros(4, "<i4"))
    with pytest.raises(ValueError, match="words must hold the stream"):
        TZ.build_index(stream, 8192, device="cpu")

    def bad_args(*a, **k):
        raise ValueError("decode_streams: bad arguments")

    monkeypatch.setattr(S.IK, "decode_streams", bad_args)
    with pytest.raises(ValueError, match="decode_streams: bad arguments"):
        TZ.extract(stream, ix, 1000, 100, device="cpu")
    assert not host


def test_outgrown_segments_decode_again(monkeypatch):
    """Segments that decode to more than their first room (8 cells an
    input byte) decode again from their start in four times the room,
    and an exact re-decode grows its room the same way: the bytes, the
    points and the errors stay those of native."""
    monkeypatch.setattr(S, "SEGMENT_BYTES", 2048)
    monkeypatch.setattr(S, "CAP_SLACK", 64)
    data = _mix(64 * 1024, 12) + bytes(96 * 1024) + _mix(32 * 1024, 13)
    raw = _raw(data, 6)
    stats = {}
    full, points, used = S.zran_index(raw, 8192, 4 * len(data), device="cpu", stats=stats)
    assert full == data and used == len(raw) and stats["attempts"] >= 2
    assert S.inflate_speculative(raw, len(data), device="cpu") == (data, len(raw))
    assert _outcome(lambda: S.inflate_speculative(raw, len(data) - 1, device="cpu"))[0] is BufferError
    if native.available():
        assert (full, points, used) == native.zran_index(raw, 8192, 4 * len(data))


def _stored_blocks(payload: bytes, size: int, final: bool = True) -> bytes:
    """Raw deflate of stored blocks of `size` bytes (the last one final)."""
    out = bytearray()
    parts = [payload[i : i + size] for i in range(0, len(payload), size)] or [b""]
    for k, p in enumerate(parts):
        last = final and k == len(parts) - 1
        out += bytes([1 if last else 0]) + len(p).to_bytes(2, "little")
        out += (len(p) ^ 0xFFFF).to_bytes(2, "little") + p
    return bytes(out)


def test_false_anchor_in_stored_bytes(monkeypatch):
    """A level-0 stream whose stored payload holds a level-6 raw stream:
    SP1 finds the inner stream's dynamic header inside the stored bytes,
    its segment decodes (the inner stream is valid deflate), the chain
    never reaches it, and the bytes come out exact."""
    inner = _raw(_BASH[50_000:70_000], 6)
    payload = _mix(3000, 5) + inner + _mix(30_000, 6)
    outer = _stored_blocks(payload, 16000)
    inner_bit = (5 + 3000) * 8  # one stored header of 5 bytes before the payload
    assert _peek3(inner, 0) >> 1 == 2  # the inner stream opens with a dynamic block
    words = torch.from_numpy(SK.stream_words(outer))
    N = 8 * len(outer)
    lo = torch.tensor([2048 * 8], dtype=torch.int32)
    hi = torch.tensor([4096 * 8], dtype=torch.int32)
    assert SK.block_find_plain(words, N, lo, hi).tolist() == [inner_bit]
    monkeypatch.setattr(S, "SEGMENT_BYTES", 2048)
    stats = {}
    out, used = S.inflate_speculative(outer, 4 * len(payload), device="cpu", stats=stats)
    assert out == payload and used == len(outer)
    assert stats["guessed"] > stats["chained"] and stats["misses"] >= 1
    if native.available():
        assert (out, used) == native.inflate_speculative(outer, 4 * len(payload))


def _peek3(b: bytes, bit: int) -> int:
    return (int.from_bytes(b[bit >> 3 : (bit >> 3) + 2], "little") >> (bit & 7)) & 7


@pytest.mark.parametrize("seg", [2048, 8192, 1 << 20])
def test_errors_equal_native(seg, monkeypatch):
    """A flipped byte, a truncated stream and too small an output budget:
    the native function's error (or, where a flip decodes, its bytes)."""
    monkeypatch.setattr(S, "SEGMENT_BYTES", seg)
    data = _mix(128 * 1024, 9)
    raw = _raw(data, 6)
    cases = [bytes(raw[:k]) + bytes([raw[k] ^ 0x44]) + raw[k + 1 :]
             for k in (len(raw) // 3, len(raw) // 2, 2 * len(raw) // 3)]
    cases += [raw[: len(raw) * 3 // 5], raw[:-1]]
    seen = set()
    for s in cases:
        got = _outcome(lambda: S.inflate_speculative(s, 4 * len(data), device="cpu"))
        seen.add(got[0] if isinstance(got[0], type) else "bytes")
        if native.available():
            assert got == _outcome(lambda: native.inflate_speculative(s, 4 * len(data)))
    assert ValueError in seen
    got = _outcome(lambda: S.inflate_speculative(raw, len(data) // 2, device="cpu"))
    assert got[0] is BufferError
    if native.available():
        assert got == _outcome(lambda: native.inflate_speculative(raw, len(data) // 2))


def _host_block_starts(raw: bytes) -> list[int]:
    """Every block start the host Inflator's pass reports (its stops at
    block boundaries, InflateFlush.BLOCK), as bit positions, through the
    BFINAL block (the pass also stops after it)."""
    inf = TINF.Inflator(tc.InflateConfig(window_bits=-15))
    starts, pos = [0], 0
    while True:
        rc, used, _out = inf.inflate(raw[pos:], None, tc.InflateFlush.BLOCK)
        pos += used
        if rc == tc.ReturnCode.StreamEnd:
            last = next(i for i, b in enumerate(starts) if _peek3(raw, b) & 1)
            return starts[: last + 1]
        assert rc == tc.ReturnCode.Ok
        if inf.mode.name == "TYPE" and pos * 8 - inf.bits != starts[-1]:
            starts.append(pos * 8 - inf.bits)


def _chain_passes(kinds: list[int], i: int) -> bool | None:
    """Native's depth-6 chain over the real block types from block i (0
    stored, 1 static, 2 dynamic): True or False, None where a static
    follower's symbol count would decide."""
    stored = 0
    for d in range(SK.DEPTH):
        if i + d >= len(kinds):
            return False
        k = kinds[i + d]
        if k == 2:
            return True
        if k == 1:
            return None if d else False
        stored += 1
    return stored >= 2


@pytest.mark.parametrize("name", ["bash6", "mix1", "stored_then_dynamic"])
def test_block_find_has_no_false_negative(name):
    """Every real non-final dynamic block start passes SP1's plain
    version, and every real stored one whose chain of real blocks passes
    the native rule (six stored links, or stored links into a dynamic
    block); each is found in a range that starts there."""
    if name == "bash6":
        raw = _wrapped("raw", _BASH[100_000:260_000], 6)
    elif name == "mix1":
        raw = _wrapped("raw", _mix(160 * 1024, 2), 1)
    else:
        raw = _stored_blocks(_mix(40_000, 4), 3000, final=False) + _raw(_BASH[:90_000], 6)
    starts = _host_block_starts(raw)
    kinds = [_peek3(raw, b) >> 1 for b in starts]
    finals = [_peek3(raw, b) & 1 for b in starts]
    words = torch.from_numpy(SK.stream_words(raw))
    N = 8 * len(raw)
    buf = bytes(raw) + bytes(8)
    want = [b for i, b in enumerate(starts)
            if not finals[i] and kinds[i] in (0, 2) and _chain_passes(kinds, i)]
    assert len(want) >= 3
    if name == "stored_then_dynamic":
        assert sum(kinds[starts.index(b)] == 0 for b in want) >= 10
    offs = torch.tensor(want, dtype=torch.int64)
    assert bool(SK.prefilter_plain(words, N, offs).all())
    assert all(SK._validate(buf, N, b) for b in want)
    lo = torch.tensor(want, dtype=torch.int32)
    assert SK.block_find_plain(words, N, lo, lo + 64).tolist() == want


# ---------------------------------------------------------------------------
# numpy models of the kernels' designs
# ---------------------------------------------------------------------------


def _peek32(w: np.ndarray, bp: int) -> int:
    """The kernels' peek32: two 32-bit words, index clamped to the row."""
    top = len(w) - 1
    wi, sh = bp >> 5, bp & 31
    lo = int(w[min(max(wi, 0), top)])
    if not sh:
        return lo
    return ((lo >> sh) | (int(w[min(max(wi + 1, 0), top)]) << (32 - sh))) & 0xFFFFFFFF


def _prefilter_model(w: np.ndarray, N: int, b: int) -> bool:
    """csrc/speculative.cu's `prefilter`, field by field from 32-bit words."""
    def bits(p, k):
        return _peek32(w, p) & ((1 << k) - 1)

    if b + 3 > N:
        return False
    typ = bits(b + 1, 2)
    if typ == 0:
        q = (b + 10) & ~7
        if q + 32 > N:
            return False
        v = _peek32(w, q)
        return (v & 0xFFFF) ^ (v >> 16) == 0xFFFF and v & 0xFFFF != 0
    if typ != 2:
        return False
    h = bits(b + 3, 14)
    ncode = ((h >> 10) & 15) + 4
    if h & 31 > 29 or (h >> 5) & 31 > 29 or b + 17 + 3 * ncode > N:
        return False
    cnt = [0] * 8
    for i in range(ncode):
        cnt[bits(b + 17 + 3 * i, 3)] += 1
    left = 1
    for ln in range(1, 8):
        left = 2 * left - cnt[ln]
        if left < 0:
            return False
    return left == 0


def _sp1_model(raw: bytes, lo: list, hi: list, cap: int, threads: int = 256):
    """The kernel's two passes: a thread a bit offset in tiles of
    `threads` a segment, survivors appended a warp at a time (ballot, one
    atomic, popc ranks) into a list of `cap`, the exact count kept; then a
    thread a listed survivor, atomicMin into its segment's best (the early
    exit past the best so far changes only the work). Returns (best,
    count, list)."""
    w = SK.stream_words(raw).view(np.uint32)
    N = 8 * len(raw)
    tiles = -(-max(h - l for l, h in zip(lo, hi)) // threads)
    surv, count = [], 0
    for k, (a, z) in enumerate(zip(lo, hi)):
        for t in range(tiles):
            for warp in range(threads // 32):
                base_b = a + t * threads + warp * 32
                ballot = [base_b + i < min(z, N) and _prefilter_model(w, N, base_b + i)
                          for i in range(32)]
                m = sum(1 << i for i, p in enumerate(ballot) if p)
                if not m:
                    continue
                base = count
                count += bin(m).count("1")
                for i, p in enumerate(ballot):
                    if p:
                        idx = base + bin(m & ((1 << i) - 1)).count("1")
                        if idx < cap:
                            surv.append((base_b + i, k))
    best = [(1 << 31) - 1] * len(lo)
    buf = bytes(raw) + bytes(8)
    for b, k in reversed(surv[: min(count, cap)]):  # any order gives the same minimum
        if b < best[k] and SK._validate(buf, N, b):
            best[k] = min(best[k], b)
    return [-1 if v == (1 << 31) - 1 else v for v in best], count, surv


def test_sp1_model_equals_plain():
    """The two-pass design against the plain version on segments of a
    dynamic stream, of stored blocks and of a static stream (no anchor),
    and a survivor list too short (the wrapper's rerun with room for the
    exact count gives the same offsets)."""
    raw = (_stored_blocks(_mix(6000, 8), 2000, final=False)
           + _wrapped("raw", _BASH[5000:25_000], 6)[:-200] + _raw(_mix(3000, 9), 6, zlib.Z_FIXED))
    N = 8 * len(raw)
    step = 2000 * 8
    lo = list(range(0, N, step))
    hi = [min(x + step, N) for x in lo]
    words = torch.from_numpy(SK.stream_words(raw))
    plain = SK.block_find_plain(words, N, torch.tensor(lo, dtype=torch.int32),
                                torch.tensor(hi, dtype=torch.int32)).tolist()
    best, count, _ = _sp1_model(raw, lo, hi, cap=N)
    assert best == plain and count > 0
    assert sum(v >= 0 for v in plain) >= 4
    short, count2, listed = _sp1_model(raw, lo, hi, cap=count // 3)
    assert count2 == count and len(listed) == count // 3
    rerun, _, _ = _sp1_model(raw, lo, hi, cap=count)
    assert rerun == plain
    # the survivors are a superset of the passing offsets, and rare
    offs = torch.arange(0, N, dtype=torch.int64)
    keep = SK.prefilter_plain(words, N, offs)
    assert int(keep.sum()) == count and count < N // 50


def test_fixed_code_arithmetic_equals_table():
    """SP1's static follower decodes the fixed code by bit reversal; its
    symbol and length for every 9-bit peek equal the fixed table's."""
    lut, bits = SK._FIXED_LIT
    assert bits == 9
    for p in range(512):
        r7 = int(f"{p & 0x7F:07b}"[::-1], 2)
        if r7 < 24:
            got = (256 + r7, 7)
        else:
            r8 = int(f"{p & 0xFF:08b}"[::-1], 2)
            if r8 < 192:
                got = (r8 - 48, 8)
            elif r8 < 200:
                got = (280 + r8 - 192, 8)
            else:
                got = (144 + int(f"{p:09b}"[::-1], 2) - 400, 9)
        assert got == lut[p], p
    dlut, _ = SK._FIXED_DIST
    assert all(dlut[p] == (int(f"{p:05b}"[::-1], 2), 5) for p in range(32))


def _puff_decode(cl: list, peek: int):
    """SP1's code-length decode: canonical, a bit at a time (puff's)."""
    cnt = [0] * 8
    for ln in cl:
        cnt[ln] += 1
    order = [s for ln in range(1, 8) for s in range(19) if cl[s] == ln]
    first_idx, k = [0] * 8, 0
    for ln in range(1, 8):
        first_idx[ln] = k
        k += cnt[ln]
    code = firstc = 0
    for ln in range(1, 8):
        code |= peek & 1
        peek >>= 1
        if code - cnt[ln] < firstc:
            return order[first_idx[ln] + code - firstc], ln
        firstc = (firstc + cnt[ln]) << 1
        code <<= 1
    return None


def test_code_length_decode_equals_table():
    """On complete code-length codes of random lengths, the bit-at-a-time
    decode equals the table decode for every 7-bit peek."""
    rng = np.random.default_rng(3)
    done = 0
    while done < 40:
        cl = [int(x) for x in rng.integers(0, 8, 19)]
        if SK._table_bad(cl, 0):
            continue
        lut, bits = SK._lut(cl, 0)
        for p in range(128):
            assert _puff_decode(cl, p) == lut[p & ((1 << bits) - 1)]
        done += 1


def _resolve_serial(cells: np.ndarray, ofs: list) -> np.ndarray:
    """Native's stitch: segments in order, each marker from the bytes
    already written."""
    out = np.zeros(len(cells), np.int64)
    bounds = ofs + [len(cells)]
    for k in range(len(ofs)):
        for i in range(bounds[k], bounds[k + 1]):
            c = int(cells[i])
            out[i] = c if c < 256 else out[bounds[k] - (c - 255)]
    return out


def _resolve_model(cells: np.ndarray, ofs: list) -> np.ndarray:
    """SP3's design: a pointer a cell, resolve_rounds synchronous rounds of
    p = p[p], then the narrow."""
    idx = np.arange(len(cells))
    seg = np.searchsorted(np.asarray(ofs), idx, side="right") - 1
    p = np.where(cells < 256, idx, np.asarray(ofs)[seg] - (cells.astype(np.int64) - 255))
    for _ in range(SK.resolve_rounds(len(ofs))):
        p = p[p]
    return cells[p].astype(np.int64)


def test_sp3_pointer_jumping():
    """Segments under 32 KiB whose markers reach several segments back
    (each segment's first cells copy the previous one's first marker run,
    a chain of every segment), against the serial stitch and the plain
    version."""
    rng = np.random.default_rng(4)
    sizes = [900, 40, 1300, 7, 0, 2600, 300, 5000, 64, 1000, 777, 5]
    ofs = list(np.cumsum([0] + sizes[:-1]))
    cells = np.zeros(sum(sizes), np.int64)
    for k, (o, n) in enumerate(zip(ofs, sizes)):
        row = rng.integers(0, 256, n)
        if k:
            for j in range(n):
                if rng.random() < 0.6:
                    back = int(rng.integers(1, min(o, 32768) + 1))
                    row[j] = 256 + back - 1
            if n:
                row[0] = 256 + (o - ofs[k - 1]) - 1 if sizes[k - 1] else row[0]
        cells[o : o + n] = row
    want = _resolve_serial(cells, ofs)
    assert (want < 256).all()
    assert (_resolve_model(cells, ofs) == want).all()
    got, unresolved = SK.spec_resolve_plain(
        torch.from_numpy(cells.astype(np.uint16).view(np.int16)),
        torch.tensor(ofs + [len(cells)], dtype=torch.int64))
    assert not unresolved and (got.numpy().astype(np.int64) == want).all()
    # a chain through every segment: the first cell of each points at the
    # previous segment's first cell
    chain = np.full(len(sizes), 65, np.int64)
    ofs1 = list(range(len(sizes)))
    chain[1:] = 256 + 1 - 1
    assert (_resolve_model(chain, ofs1) == 65).all()
    assert SK.resolve_rounds(len(sizes)) == 4


def test_spec_decode_plain_status_and_records():
    """SP2's status on segments of one stream: a guess at a real block
    start chains into the next, its records are the block starts in its
    range, a start of -1 is NO_START, a cap of 16 cells is CAP."""
    raw = _wrapped("raw", _mix(64 * 1024, 12), 6)
    starts = _host_block_starts(raw)
    assert len(starts) >= 4
    words = torch.from_numpy(SK.stream_words(raw))
    N = 8 * len(raw)
    a, b, c = starts[len(starts) // 2 : len(starts) // 2 + 3]
    rows = [(0, a, 1 << 20, 0), (a, b, 1 << 20, SK.WSIZE), (-1, b, 0, SK.WSIZE),
            (b, c, 16, SK.WSIZE), (b, N, 1 << 20, SK.WSIZE)]
    segs = S._decode(words, N, rows)
    assert (segs[0].why, segs[0].end, segs[0].final) == (SK.OK, a, 0)
    assert segs[0].recs[:, 0].tolist() == [s for s in starts if s < a] and segs[0].need == 0
    assert (segs[1].why, segs[1].end, segs[1].start) == (SK.OK, b, a)
    assert segs[1].recs.tolist() == [[a, 0]] and segs[1].need <= SK.WSIZE
    assert (segs[2].why, segs[2].n) == (SK.NO_START, 0)
    assert (segs[3].why, segs[3].end) == (SK.CAP, -1) and segs[3].n <= 16
    assert segs[4].final == 1 and (segs[4].end + 7) // 8 == len(raw)
    assert segs[4].recs[:, 0].tolist() == [s for s in starts if s >= b]
    assert 0 < segs[4].need <= SK.WSIZE
    cells = segs[4].cells.to(torch.int32) & 0xFFFF
    assert int((cells >= 256).sum()) > 0 and int(cells.max()) <= 256 + SK.WSIZE - 1
