"""EX and DS at levels 4-9 (csrc/exact_deflate.cu): the static hash chains,
the resolve (two walks a position, packed into slots) and the chase that
reads them, on the CPU.

- The reconstruction: at every position and every prev_length p in
  [2, lazy), the chase's longest (the slot's lookup, or the live walk over
  the static chains where p >= total - pos) equals a serial model of zlib's
  longest_match over the chains of zlib's serial inserts.
- The plain resolve's chase (a Python model of run_slow) gives the symbol
  stream stdlib zlib's raw stream decodes to, with and without a zdict; the
  source's host build gives zlib's bytes, whole and a piece at a time.
- The plain resolve (`exact_deflate_kernel.resolve_plain`) equals the host
  build's deltas and slots, EX's pieces and DS's (seeded by a handle's
  tables).
- DS's handle tables after each pump equal their definition: the last
  inserted position of each hash and the capped deltas of the ring.

The inputs are crafted: a dictionary's tail, the last 258 bytes (the
zero-extended compare), length-3 matches past TOO_FAR, chains longer than
the budget and chains cut at nice (runs of one byte), 15-bit hash
collisions of different triples, a candidate exactly MAX_DIST back and
position 0. Every comparison is exact."""

import ctypes
import random
import re
import shutil
import subprocess
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from zlib_rs_tpu_torch import native as tnative
from zlib_rs_tpu_torch.config import CONFIGURATION_TABLE
from zlib_rs_tpu_torch.ops.kernels import dstream_kernel as DK
from zlib_rs_tpu_torch.ops.kernels import exact_deflate_kernel as EK
from zlib_rs_tpu_torch.parallel import chunk_deflate as CD

# the test workers share the cores, and an oversubscribed OpenMP pool spin-waits
torch.set_num_threads(1)

SRC = Path(__file__).resolve().parents[1] / "zlib_rs_tpu_torch" / "csrc" / "exact_deflate.cu"
_BASH = open("/bin/bash", "rb").read()
MASK = 32767
LEVELS = range(4, 10)
_rng = np.random.default_rng(22)


def _rnd(n: int) -> bytes:
    """n random bytes of 16 letters: compressible, so that zlib's blocks
    are coded and not stored (a stored block would hide its symbols)."""
    return bytes(np.frombuffer(b"0123456789ABCDEF", np.uint8)[_rng.integers(0, 16, n)])


_X = _rnd(600)
CRAFTED = {
    # matches that run into the end of the data: the zero-extended compare
    "tail258": _rnd(300) + _X + _rnd(50) + _X,
    # a triple whose only earlier copy lies past TOO_FAR
    "far3": b"qzjA" + _rnd(4400) + b"qzjB" + _rnd(300),
    # one triple 700 times, each followed by a random byte
    "long_chains": b"".join(b"xyz" + bytes([v]) for v in _rng.integers(0, 256, 700)),
    # runs of one byte: every walk stops at nice
    "runs": bytes(700) + b"a" * 300 + _rnd(40) + bytes(500) + b"ab" * 200,
    # 'A' (0x41), 'a' (0x61), '!' (0x21), 0x01: one 15-bit hash a triple
    "collisions": b"".join(bytes([c]) + b"bc" + _rnd(1) for c in
                           _rng.choice([0x41, 0x61, 0x21, 0x01], 500)),
    # position 0's triple again later: position 0 is NIL
    "position0": b"abcd" + _rnd(100) + b"abcd" + _rnd(100) + b"abcd",
    "bash": _BASH[100_000:102_500],
}
# a candidate exactly MAX_DIST back, and one a byte further, in a filler
# no triple of which shares a hash with a mark's
_MD = EK.MAX_DIST
_F = b"\xee"
MAX_DIST_DATA = (_F * 100 + b"QJX1" + _F * 200 + b"ZVW2" + _F * (_MD - 208) + b"QJX1" +
                 _F * 201 + b"ZVW2" + _F * 300)


def zraw(data: bytes, level: int, final: bool = True, window: bytes = b"") -> bytes:
    kw = {"zdict": window[-32768:]} if window else {}
    c = zlib.compressobj(level, zlib.DEFLATED, -15, 8, 0, **kw)
    return c.compress(data) + c.flush(zlib.Z_FINISH if final else zlib.Z_SYNC_FLUSH)


def _cfg(level: int):
    c = CONFIGURATION_TABLE[level]
    return c.good_length, c.max_lazy, c.nice_length, c.max_chain


# ---------------------------------------------------------------------------
# the host build
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """csrc/exact_deflate.cu built by g++ (no __CUDACC__: one lane)."""
    gxx = shutil.which("g++")
    assert gxx, "g++ builds this file's host build"
    lib = tmp_path_factory.mktemp("exr") / "libexr_host.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-x", "c++", str(SRC), "-o",
                    str(lib)], check=True, capture_output=True, timeout=300)
    dll = ctypes.CDLL(str(lib))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    dll.zrs_exact_resolve_host.argtypes = [P, P, I, I, P, P, P, P, P, L, I]
    dll.zrs_exact_chase_host.argtypes = [P, P, P, I, I, P, P, P, P, P, L, P, P, P, P, L, P]
    dll.zrs_exact_deflate_host.argtypes = [P, P, I, I, P, P, P]
    dll.zrs_exact_set_piece.argtypes = [L]
    dll.zrs_exact_piece_len.restype = L
    dll.zrs_dstream_ranges.argtypes = [P, P]
    dll.zrs_dstream_pump_host.argtypes = [P] * 4
    return dll


def _p(t):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _host_launches(dll):
    """run_static's two launches through the host build."""

    def resolve(data, pieces, level, deltas, slots, cb, wb):
        assert dll.zrs_exact_resolve_host(_p(data), _p(pieces), pieces.shape[0], level, None, None,
                                          _p(deltas), _p(slots), None, 0, 1) == 0

    def chase(data, meta, pieces, level, out, lens, st, recs, scratch, slots, deltas):
        assert dll.zrs_exact_chase_host(_p(data), _p(meta), _p(pieces), pieces.shape[0], level,
                                        _p(out), _p(lens), _p(st), _p(recs), _p(scratch),
                                        EK.WORK_BYTES, _p(slots), _p(deltas), None, None, 0,
                                        None) == 0

    return resolve, chase


def _host_resolve(dll, data, pieces, level, head_old=None, ring=None):
    _p_, nd, ns, _cb, _wb = EK.with_offsets(pieces.tolist())
    deltas = torch.zeros(max(nd, 1), dtype=torch.int16)
    slots = torch.zeros(max(ns, 1), 2, dtype=torch.int32)
    assert dll.zrs_exact_resolve_host(_p(data), _p(pieces), pieces.shape[0], level, _p(head_old),
                                      _p(ring), _p(deltas), _p(slots), None, 0, 1) == 0
    return deltas, slots


def _host_chunk(dll, data: bytes, level: int, final: bool, window: bytes, piece: int) -> bytes:
    dll.zrs_exact_set_piece(piece)
    try:
        buf = np.frombuffer(window + data + bytes(1), np.uint8).copy()
        meta = CD.chunk_meta([(len(window), len(data), len(window), int(final))], level)
        out = np.zeros(EK.out_bytes(torch.from_numpy(meta)), np.uint8)
        lens, st = np.zeros(1, np.int64), np.zeros(1, np.int32)
        assert dll.zrs_exact_deflate_host(buf.ctypes.data, meta.ctypes.data, 1, level,
                                          out.ctypes.data, lens.ctypes.data, st.ctypes.data) == 0
        assert st.tolist() == [0]
        return out[: lens[0]].tobytes()
    finally:
        dll.zrs_exact_set_piece(EK.PIECE)


# ---------------------------------------------------------------------------
# the serial models: zlib's inserts, longest_match, deflate_slow
# ---------------------------------------------------------------------------


def _hash(b: bytes, p: int) -> int:
    return ((b[p] << 10) ^ (b[p + 1] << 5) ^ b[p + 2]) & MASK


def _lcp(b: bytes, total: int, p: int, q: int) -> int:
    """match258 (or match258_z past `total`): zero-extended bytes."""
    n = 0
    while n < 258 and (b[p + n] if p + n < total else 0) == (b[q + n] if q + n < total else 0):
        n += 1
    return n


def serial_longest(b: bytes, total: int, pos: int, cur: int, prev_len: int, level: int, link,
                   cache: dict) -> tuple:
    """zlib's longest_match as the source's `longest` writes it, decision
    for decision, over the chain links `link(p)` (a position's delta, 0 for
    none): (length, distance)."""
    good, _lazy, nice, chain = _cfg(level)
    lookahead = total - pos
    if prev_len >= good:
        chain >>= 2
    best, bd = prev_len, 0
    nice = min(nice, lookahead)
    limit = max(pos - EK.MAX_DIST, 0)

    def ml(c):
        if c not in cache:
            cache[c] = _lcp(b, total, pos, c)
        return cache[c]

    if pos + 258 <= total:
        scan_end, scan_start = b[pos + best - 1 : pos + best + 1], b[pos : pos + 2]
        while True:
            d = link(cur)
            nxt = cur - d
            if b[cur + best - 1 : cur + best + 1] == scan_end and b[cur : cur + 2] == scan_start:
                m = ml(cur)
                if m > best:
                    best, bd = m, pos - cur
                    if m >= nice:
                        break
                    scan_end = b[pos + best - 1 : pos + best + 1]
            if nxt >= cur:
                break
            cur = nxt
            if cur <= limit:
                break
            chain -= 1
            if chain == 0:
                break
    else:
        while True:
            m = ml(cur)
            if m > best:
                best, bd = m, pos - cur
                if m >= nice:
                    break
            d = link(cur)
            nxt = cur - d if d else 0
            if nxt <= limit or nxt >= cur:
                break
            cur = nxt
            chain -= 1
            if chain == 0:
                break
    return min(best, lookahead), bd


def model_longest(b: bytes, total: int, pos: int, slot, prev_len: int, level: int, deltas,
                  cache: dict) -> tuple:
    """The chase's longest: the slot's lookup, or the live walk over the
    static chains where prev_len >= total - pos."""
    good = _cfg(level)[0]
    lookahead = total - pos
    if prev_len >= lookahead:
        d0 = int(deltas[pos])
        return serial_longest(b, total, pos, pos - d0, prev_len, level, lambda c: int(deltas[c]),
                              cache)
    v = int(slot[1] if prev_len >= good else slot[0])
    m, dist = v >> 15, v & 0x7FFF
    if m <= prev_len:
        m, dist = prev_len, 0
    return min(m, lookahead), dist


def _resolve_whole(buf: bytes, dict_len: int, level: int):
    """The plain resolve of one piece over the whole data: deltas of every
    position (from 0) and the slots of [dict_len, total)."""
    total = len(buf)
    row = [0, total, 0, 0, max(0, total - 2), 0, dict_len, total, 0, 0, 0, 0, 1, 0]
    pieces, *_ = EK.with_offsets([row])
    data = torch.from_numpy(np.frombuffer(buf + bytes(1), np.uint8).copy())
    deltas, slots = EK.resolve_plain(data, torch.from_numpy(pieces), level)
    return EK.unsigned(deltas).numpy(), slots.numpy()


def chase_model(buf: bytes, dict_len: int, level: int) -> list:
    """run_slow over the plain resolve's slots, then the trailing literal:
    the symbol stream, a byte or (length, distance) each."""
    total = len(buf)
    deltas, slots = _resolve_whole(buf, dict_len, level)
    lazy = _cfg(level)[1]
    syms = []
    spos, match_length, match_start, avail = dict_len, 2, 0, False
    while spos < total:
        slot = slots[spos - dict_len] if spos + 3 <= total else (0, 0)
        prev_length, prev_start = match_length, match_start
        match_length = 2
        if slot[0] and prev_length < lazy:
            match_length, md = model_longest(buf, total, spos, slot, prev_length, level, deltas, {})
            if md > 0:
                match_start = spos - md
            if match_length == 3 and spos - match_start > 4096:
                match_length = 2
        if prev_length >= 3 and match_length <= prev_length:
            syms.append((prev_length, spos - 1 - prev_start))
            spos += prev_length - 1
            avail, match_length = False, 2
        elif avail:
            syms.append(buf[spos - 1])
            spos += 1
        else:
            avail, spos = True, spos + 1
    if avail:
        syms.append(buf[total - 1])
    return syms


# RFC 1951's length and distance bases, for the token decoder
_LBASE = [3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31, 35, 43, 51, 59, 67, 83, 99, 115,
          131, 163, 195, 227, 258]
_LEXT = [0] * 8 + [1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0]
_DBASE = [1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193, 257, 385, 513, 769, 1025,
          1537, 2049, 3073, 4097, 6145, 8193, 12289, 16385, 24577]
_DEXT = [0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12,
         13, 13]


def zlib_tokens(raw: bytes) -> list:
    """The symbol stream of a raw deflate stream of coded blocks: a byte or
    (length, distance) each, blocks joined."""
    bits = int.from_bytes(raw, "little")
    pos = 0

    def get(n):
        nonlocal pos
        v = (bits >> pos) & ((1 << n) - 1)
        pos += n
        return v

    def table(lengths):
        codes, code, cnt = {}, 0, [0] * 16
        for ln in lengths:
            cnt[ln] += 1
        cnt[0], nxt = 0, [0] * 16
        for b in range(1, 16):
            code = (code + cnt[b - 1]) << 1
            nxt[b] = code
        for s, ln in enumerate(lengths):
            if ln:
                codes[(ln, nxt[ln])] = s
                nxt[ln] += 1
        return codes

    def sym(t):
        code = ln = 0
        while True:
            code = (code << 1) | get(1)
            ln += 1
            if (ln, code) in t:
                return t[(ln, code)]

    out, last = [], 0
    while not last:
        last, kind = get(1), get(2)
        assert kind, "a stored block hides its symbols"
        if kind == 1:
            lt = table([8] * 144 + [9] * 112 + [7] * 24 + [8] * 8)
            dt = table([5] * 30)
        else:
            hl, hd, hc = get(5) + 257, get(5) + 1, get(4) + 4
            order = [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15]
            cl = [0] * 19
            for i in range(hc):
                cl[order[i]] = get(3)
            ct, lens = table(cl), []
            while len(lens) < hl + hd:
                s = sym(ct)
                if s < 16:
                    lens.append(s)
                elif s == 16:
                    lens += [lens[-1]] * (3 + get(2))
                elif s == 17:
                    lens += [0] * (3 + get(3))
                else:
                    lens += [0] * (11 + get(7))
            lt, dt = table(lens[:hl]), table(lens[hl:])
        while True:
            s = sym(lt)
            if s < 256:
                out.append(s)
            elif s == 256:
                break
            else:
                s -= 257
                ln = _LBASE[s] + get(_LEXT[s])
                d = sym(dt)
                out.append((ln, _DBASE[d] + get(_DEXT[d])))
    return out


def _serial_states(buf: bytes, dict_len: int):
    """zlib's serial inserts over buf: for each body position with a first
    candidate, (pos, first candidate, the ring of deltas then)."""
    total = len(buf)
    head = np.zeros(MASK + 1, np.int64)
    ring = np.zeros(MASK + 1, np.int64)
    for p in range(total - 2):
        h = _hash(buf, p)
        ring[p & MASK] = min(p - head[h], 0xFFFF)
        head[h] = p
        if p >= dict_len:
            d = int(ring[p & MASK])
            first = p - d if d else 0
            if first > 0 and p - first <= EK.MAX_DIST:
                yield p, first, ring


# ---------------------------------------------------------------------------
# the reconstruction and the symbols
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("name", sorted(CRAFTED))
def test_slots_reconstruct_longest_at_every_prev_length(level, name):
    """At every body position with a first candidate (every 5th at levels
    8-9) and every p in [2, lazy): the chase's longest from the plain
    resolve equals zlib's over the serial chains."""
    buf = CRAFTED[name]
    total = len(buf)
    deltas, slots = _resolve_whole(buf, 0, level)
    lazy = _cfg(level)[1]
    step = 5 if level >= 8 else 1
    checked = 0
    for k, (pos, first, ring) in enumerate(_serial_states(buf, 0)):
        if k % step:
            continue
        assert pos - int(deltas[pos]) == first
        serial_cache, model_cache = {}, {}
        for p in range(2, lazy):
            want = serial_longest(buf, total, pos, first, p, level, lambda c: int(ring[c & MASK]),
                                  serial_cache)
            got = model_longest(buf, total, pos, slots[pos], p, level, deltas, model_cache)
            assert got == want, (name, level, pos, p)
            checked += 1
    assert checked


@pytest.mark.parametrize("level", LEVELS)
def test_slots_reconstruct_longest_at_max_dist(level):
    """A candidate exactly MAX_DIST back is a first candidate; one a byte
    further is not; the later positions of the marks reconstruct."""
    buf = MAX_DIST_DATA
    total = len(buf)
    m1, m2 = buf.rindex(b"QJX1"), buf.rindex(b"ZVW2")
    assert m1 - buf.index(b"QJX1") == EK.MAX_DIST and m2 - buf.index(b"ZVW2") == EK.MAX_DIST + 1
    deltas, slots = _resolve_whole(buf, 0, level)
    assert int(deltas[m1]) == EK.MAX_DIST and slots[m1, 0] & 0x7FFF == EK.MAX_DIST
    assert int(deltas[m2]) == EK.MAX_DIST + 1 and slots[m2].tolist() == [0, 0]
    lazy = _cfg(level)[1]
    for pos, first, ring in _serial_states(buf, 0):
        if pos not in range(m1, m1 + 4):
            continue
        for p in range(2, lazy):
            want = serial_longest(buf, total, pos, first, p, level, lambda c: int(ring[c & MASK]),
                                  {})
            assert model_longest(buf, total, pos, slots[pos], p, level, deltas, {}) == want


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("name", sorted(CRAFTED))
def test_model_chase_gives_zlibs_symbols(level, name):
    """The chase over the plain resolve's slots gives the symbol stream of
    stdlib zlib's raw stream, without and with a zdict (the dictionary's
    tail: a window ending in the data's first bytes)."""
    data = CRAFTED[name]
    assert chase_model(data, 0, level) == zlib_tokens(zraw(data, level))
    window = _rnd(300) + data[:40]
    assert chase_model(window + data, len(window), level) == \
        zlib_tokens(zraw(data, level, True, window))


def test_model_chase_on_the_dictionary_tail():
    """A chunk of zeros after a window ending in zeros: zlib matches from
    the window's last two positions."""
    off = 36_867
    data, window = _BASH[off : off + 1500], _BASH[off - 2000 : off]
    for level in (4, 6, 9):
        assert chase_model(window + data, len(window), level) == \
            zlib_tokens(zraw(data, level, True, window))


@pytest.mark.parametrize("level", LEVELS)
def test_host_build_gives_zlibs_bytes_on_crafted_inputs(host, level):
    """The source's resolve and chase (whole, and in pieces of 1, 777 and
    4096 positions) give stdlib zlib's bytes, final and not, with and
    without a zdict; the 24 KB chains pass every budget (level 9's 4,096)."""
    big_chain = b"".join(b"xyz" + bytes([v]) for v in _rng.integers(0, 256, 6000))
    inputs = {**CRAFTED, "max_dist": MAX_DIST_DATA, "big_chain": big_chain}
    for name, data in inputs.items():
        for window in (b"", _BASH[36_867 - 32768 : 36_867]):
            for final in (True, False):
                want = zraw(data, level, final, window)
                for piece in (EK.PIECE, 777):
                    assert _host_chunk(host, data, level, final, window, piece) == want, \
                        (name, len(window), final, piece)
    data = CRAFTED["bash"]
    for piece in (1, 4096):
        assert _host_chunk(host, data, level, True, b"", piece) == zraw(data, level)


# ---------------------------------------------------------------------------
# the plain resolve against the host build; the plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("level", LEVELS)
def test_plain_resolve_equals_host_build(host, level):
    """EX's pieces (a first piece from position 0, a later one whose
    deltas start 32 KiB before it) and a DS pump's piece seeded by a
    handle's head and prevd: the same deltas and slots."""
    buf = _BASH[200_000:290_000]
    data = torch.from_numpy(np.frombuffer(buf + bytes(1), np.uint8).copy())
    rows = CD.chunk_meta([(0, 6000, 0, 1), (50_000, 30_000, 32768, 0)], level).tolist()
    prs = [EK.ex_piece(rows[0], 0, 0, 0), EK.ex_piece(rows[1], 32768, 1, 1, 9000),
           EK.ex_piece(rows[1], 32768 + 18_000, 1, 1, 9000)]
    pieces = torch.from_numpy(EK.with_offsets(prs)[0])
    got = _host_resolve(host, data, pieces, level)
    want = EK.resolve_plain(data, pieces, level)
    assert torch.equal(EK.unsigned(got[0]), EK.unsigned(want[0]))
    assert torch.equal(got[1], want[1])
    assert int((got[1][:, 0] != 0).sum()) > 10_000
    # DS: a handle's tables after 40,000 bytes, then a pump of 20,000
    rec = np.zeros(DK.REC, np.int64)
    rec[DK.D_LEVEL] = level
    rec[DK.D_MATCH_LENGTH] = rec[DK.D_PREV_LENGTH] = 2
    work = torch.zeros(EK.WORK_BYTES, dtype=torch.uint8)
    for chunk, flush in ((buf[:40_000], 2), (buf[40_000:60_000], 0)):
        rec[DK.D_TOTAL] += len(chunk)
        rec[DK.D_FLUSH], rec[DK.D_OUT_CAP] = flush, DK.room(int(rec[DK.D_TOTAL]))
        a, c1, s, we = DK.ranges(rec)
        row = [0, int(rec[DK.D_TOTAL]), a, a, c1, 0, s, we, 0, 0, 0, 0, 0, 0]
        pieces = torch.from_numpy(EK.with_offsets([row])[0])
        head, ring = work[: 4 * EK.HASH_SIZE].view(torch.int32), work[4 * EK.HASH_SIZE :]
        ring = ring[: 2 * 32768].view(torch.int16)
        got = _host_resolve(host, data, pieces, level, head, ring)
        want = EK.resolve_plain(data, pieces, level, head, ring)
        assert torch.equal(EK.unsigned(got[0]), EK.unsigned(want[0]))
        assert torch.equal(got[1], want[1])
        out = torch.zeros(int(rec[DK.D_OUT_CAP]), dtype=torch.uint8)
        host.zrs_dstream_pump_host(rec.ctypes.data, data.data_ptr(), work.data_ptr(),
                                   out.data_ptr())
        assert rec[DK.D_STATUS] == 0


@pytest.mark.parametrize("level", [4, 6, 9])
def test_run_static_through_the_host_build(host, level):
    """The wrapper's plan and run_static over the host build's two
    launches, PIECE, ROUND and MAX_SLOTS patched as a caller would: batches
    cut at MAX_SLOTS chunks and at ROUND positions (fresh records and
    scratch a batch), chunks cut into pieces, a resolve and a chase a round,
    each chunk zlib's primed raw deflate."""
    data = _BASH[120_000:200_000]
    n = len(data)
    dt = torch.from_numpy(np.frombuffer(data + bytes(1), np.uint8).copy())
    resolve, chase = _host_launches(host)
    calls = []

    def counted(fn, name, at):
        def launch(*a):
            calls.append((name, a[at].shape[0]))
            fn(*a)
        return launch

    for chunk, piece, round_positions, slots, want_batches in (
            (16_384, 5000, 20_000, 3, 2), (n, 30_000, 1 << 24, 1024, 1), (7000, 1 << 22, 100, 2, 12),
            (7000, 1 << 22, 1 << 24, 4, 3)):
        rows = [(lo, min(n, lo + chunk) - lo, min(32768, lo), int(lo + chunk >= n))
                for lo in range(0, n, chunk)]
        meta = torch.from_numpy(CD.chunk_meta(rows, level))
        calls.clear()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(EK, "PIECE", piece)
            mp.setattr(EK, "ROUND", round_positions)
            mp.setattr(EK, "MAX_SLOTS", slots)
            batches = EK.plan(meta.tolist())
            out, lens, st = EK.run_static(dt, meta, level, counted(resolve, "resolve", 1),
                                          counted(chase, "chase", 2))
        assert len(batches) == want_batches
        assert all(nch <= slots for nch, _r in batches) and sum(nch for nch, _r in batches) == \
            len(rows)
        rounds = [len(pieces) for _nch, rs in batches for pieces, *_rest in rs]
        assert calls == [(name, p) for p in rounds for name in ("resolve", "chase")]
        assert not st.any()
        parts = [out[m[4] : m[4] + ln].numpy().tobytes() for m, ln in zip(meta.tolist(),
                                                                        lens.tolist())]
        assert parts == [zraw(data[lo : lo + ln], level, bool(fin), data[lo - dl : lo])
                         for lo, ln, dl, fin in rows]


def test_plan_tiles_every_chunk():
    """Each chunk's pieces cover its body in order, a first piece even for
    an empty chunk; offsets and blocks are prefix sums; a round's pieces
    hold at most ROUND positions unless one chunk alone passes it."""
    rows = CD.chunk_meta([(0, 10_000, 0, 0), (10_000, 0, 10_000, 0), (10_000, 25_000, 10_000, 1)],
                         6).tolist()
    batches = EK.plan(rows, piece=7000, round_positions=12_000)
    seen = {}
    for nch, rounds in batches:
        for pieces, nd, ns, cb, wb in rounds:
            assert (pieces[:, EK.P_E] - pieces[:, EK.P_S]).sum() == ns
            assert (pieces[:, EK.P_C1] - pieces[:, EK.P_C0]).sum() == nd
            assert pieces[0, EK.P_DOFF] == pieces[0, EK.P_SOFF] == pieces[0, EK.P_CBLK] == 0
            for r in pieces:
                seen.setdefault(int(r[EK.P_CHUNK]), []).append((int(r[EK.P_S]), int(r[EK.P_E]),
                                                                int(r[EK.P_LAST])))
                assert r[EK.P_WORK] < nch and r[EK.P_C0] == max(0, r[EK.P_S] - 32768)
    for k, (start, n, dl, *_rest) in enumerate(rows):
        spans = seen[k]
        assert spans[0][0] == dl and spans[-1][1] == dl + n and spans[-1][2] == 1
        assert all(a[1] == b[0] and a[2] == 0 for a, b in zip(spans, spans[1:]))
    assert len(batches) == 2  # 7,000 + 0 + 7,000 passes 12,000


def test_constants_and_ranges_match_the_source(host):
    src = SRC.read_text()
    for name, value in (("kTile", EK.TILE), ("kLookback", EK.LOOKBACK),
                        ("kWalkThreads", EK.WALK_THREADS)):
        assert re.search(rf"{name} = {value}[;L]", src), name
    assert host.zrs_exact_piece_len() == EK.PIECE_FIELDS == 14
    assert DK.D_INS_LO == 25 and DK.D_INS_HI == 26 and "D_INS_LO, D_INS_HI" in src
    rng = random.Random(5)
    for _ in range(2000):
        rec = np.zeros(DK.REC, np.int64)
        rec[DK.D_TOTAL] = rng.choice([0, 1, 2, 3, 200, 261, 262, 263, 600, 70_000])
        rec[DK.D_STARTED] = rng.random() < 0.8
        rec[DK.D_SPOS] = rng.randint(0, int(rec[DK.D_TOTAL])) if rec[DK.D_STARTED] else 0
        rec[DK.D_INSERT_PENDING] = min(rng.choice([0, 0, 1, 2]), int(rec[DK.D_SPOS]))
        rec[DK.D_FLUSH] = rng.choice(DK.FLUSHES)
        out = np.zeros(4, np.int64)
        host.zrs_dstream_ranges(rec.ctypes.data, out.ctypes.data)
        assert tuple(out.tolist()) == DK.ranges(rec)


def test_resolve_wrapper_refuses_cpu_tensors_and_other_levels():
    data = torch.zeros(64, dtype=torch.uint8)
    pieces = torch.zeros(1, EK.PIECE_FIELDS, dtype=torch.int64)
    d, s = torch.zeros(1, dtype=torch.int16), torch.zeros(1, 2, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="expected CUDA"):
        EK.resolve_cuda(data, pieces, 6, d, s, 0, 0)
    with pytest.raises(ValueError, match="1-9"):
        EK.resolve_plain(data, pieces, 0)


# ---------------------------------------------------------------------------
# DS: the handle's tables after each pump
# ---------------------------------------------------------------------------


def _tables_definition(steps, level):
    """zlib's serial inserts replayed from the pumps' records: after each
    pump the positions below spos less the pending `insert` (within the
    data) are inserted; a FULL_FLUSH inserts to the data's end less two,
    then clears the heads and restarts the positions at 0."""
    head = np.zeros(MASK + 1, np.int64)
    ring = np.zeros(MASK + 1, np.int64)
    buf, done, want = b"", 0, []
    for data, flush, rec in steps:
        buf += data
        if flush == 3:
            hi = max(0, len(buf) - 2)
        else:
            hi = min(int(rec[DK.D_SPOS]) - int(rec[DK.D_INSERT_PENDING]), len(buf) - 2)
        for p in range(done, max(done, hi)):
            h = _hash(buf, p)
            ring[p & MASK] = min(p - head[h], 0xFFFF)
            head[h] = p
        done = max(done, hi)
        if flush == 3:
            head[:] = 0
            buf, done = b"", 0
        want.append((head.copy(), ring.copy()))
    return want


@pytest.mark.parametrize("level", [4, 6, 9])
def test_ds_handle_tables_equal_their_definition(monkeypatch, host, level):
    """Pumps of 1 byte to 64 KiB under NO_FLUSH, SYNC_FLUSH and FULL_FLUSH
    through the host build: after each pump the handle's head and prevd are
    the last inserted position of each hash and the capped deltas (the ring
    keeps older slots as the serial inserts leave them), and the stream is
    native's and zlib's."""

    def pump(rec, data, work, out, rec_dev=None):
        host.zrs_dstream_pump_host(rec.ctypes.data, data.data_ptr(), work.data_ptr(),
                                   out.data_ptr())

    monkeypatch.setattr(DK, "pump", pump)
    src = _BASH[300_000:500_000]
    rng = random.Random(level)
    script, pos = [], 0
    for n, flush in ([(1, 0)] * 40 + [(2, 2), (1, 0), (1, 0), (3, 2), (1, 3), (2, 0), (65_536, 0),
                                      (700, 2), (9000, 3), (65_536, 2), (5, 0)]
                     + [(rng.choice([1, 60, 3000, 20_000]), rng.choice([0, 0, 2, 3]))
                        for _ in range(12)]):
        script.append((src[pos : pos + n], flush))
        pos += n
    handle = DK.Handle(level, "cpu")
    s = tnative.RawDeflateStream(level, _handle=handle)
    steps, outs = [], []
    for data, flush in script:
        outs.append(s.pump(data, flush))
        steps.append((data, flush, handle.rec.copy()))
        head = handle.work[: 4 * EK.HASH_SIZE].view(torch.int32).numpy()
        ring = handle.work[4 * EK.HASH_SIZE : 4 * EK.HASH_SIZE + 2 * 32768].view(torch.int16)
        got = (head.astype(np.int64), EK.unsigned(ring).numpy())
        want = _tables_definition(steps, level)[-1]
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1]), len(steps)
    outs.append(s.pump(b"", 4))
    z = zlib.compressobj(level, zlib.DEFLATED, -15)
    zb = b""
    for data, flush in script:
        zb += z.compress(data)
        if flush:
            zb += z.flush({2: zlib.Z_SYNC_FLUSH, 3: zlib.Z_FULL_FLUSH}[flush])
    assert b"".join(outs) == zb + z.flush()


@pytest.mark.parametrize("level", [4, 6, 9])
def test_ds_pump_longer_than_a_piece_runs_a_piece_at_a_time(monkeypatch, host, level):
    """With EK.PIECE patched to 5,000, pumps of up to 64 KiB under every
    flush go to the host build a piece at a time (NO_FLUSH but the last,
    which takes the pump's flush): each launch's deltas and slots cover at
    most a piece and MIN_LOOKAHEAD positions, and the stream is zlib's."""
    piece = 5000
    seen = []

    def pump(rec, data, work, out, rec_dev=None):
        a, c1, s, we = DK.ranges(rec)
        seen.append((int(rec[DK.D_FLUSH]), c1 - a, we - s))
        host.zrs_dstream_pump_host(rec.ctypes.data, data.data_ptr(), work.data_ptr(),
                                   out.data_ptr())

    monkeypatch.setattr(DK, "pump", pump)
    monkeypatch.setattr(EK, "PIECE", piece)
    src = _BASH[500_000:800_000]
    script = [(65_536, 0), (12_345, 2), (65_536, 3), (5000, 0), (5001, 2), (40_000, 0), (1, 4)]
    handle = DK.Handle(level, "cpu")
    z = zlib.compressobj(level, zlib.DEFLATED, -15)
    got, want, pos = b"", b"", 0
    for n, flush in script:
        data = src[pos : pos + n]
        pos += n
        seen.clear()
        got += handle.pump(data, flush)
        want += z.compress(data) + (z.flush({2: zlib.Z_SYNC_FLUSH, 3: zlib.Z_FULL_FLUSH,
                                             4: zlib.Z_FINISH}[flush]) if flush else b"")
        assert [f for f, _d, _s in seen] == [0] * (len(seen) - 1) + [flush]
        assert len(seen) == -(-n // piece)
        assert max(max(d, s) for _f, d, s in seen) <= piece + DK.MIN_LOOKAHEAD
    assert got == want
