"""EX and DS at levels 1-3 (csrc/exact_deflate.cu): zlib's greedy parse
(deflate_fast) resolved a position a thread over chains built under an
assumed skip map, a dry parse between two rounds, and the chase that
checks each slot against the parse's own map, on the CPU.

- The reconstruction: at every position, the slot resolved under the
  parse's own map (every position deflate_fast leaves out of its chains:
  the interior of a match longer than lazy, every interior of a match
  ending within MIN_MATCH of the data's end) equals a serial model of
  zlib's longest over the chains of zlib's serial inserts.
- The source's host build gives stdlib zlib's bytes, whole and a piece at
  a time, primed and not, from any assumed map (none skipped, the true
  one, all set, random), in 1-3 rounds; the true map costs no live walk.
- The plain resolve (`exact_deflate_kernel.resolve_plain`) and the plain
  dry parse (`dry_plain`) equal the host build's, and `run_static` drives
  the host build's launches round by round to zlib's bytes.
- DS's handle tables after each pump equal the serial inserts': the
  skipped interiors' ring slots untouched, a flushing pump's near-end
  interiors left out.

The inputs are crafted: runs of one byte longer than 258, matches of
exactly lazy and lazy + 1, matches ending within 3 of the data's end, a
candidate exactly MAX_DIST back, position 0, a dictionary's tail, 15-bit
hash collisions of different triples. Every comparison is exact."""

import ctypes
import random
import shutil
import subprocess
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import native_build  # noqa: F401  (the JAX package's native library, built once under a lock)

from zlib_rs_tpu_torch import native as tnative
from zlib_rs_tpu_torch.config import CONFIGURATION_TABLE
from zlib_rs_tpu_torch.models import medium as TM
from zlib_rs_tpu_torch.ops.kernels import dstream_kernel as DK
from zlib_rs_tpu_torch.ops.kernels import exact_deflate_kernel as EK
from zlib_rs_tpu_torch.parallel import chunk_deflate as CD

# the test workers share the cores, and an oversubscribed OpenMP pool spin-waits
torch.set_num_threads(1)

SRC = Path(__file__).resolve().parents[1] / "zlib_rs_tpu_torch" / "csrc" / "exact_deflate.cu"
_BASH = open("/bin/bash", "rb").read()
MASK = 32767
LEVELS = (1, 2, 3)
_rng = np.random.default_rng(23)


def _rnd(n: int, letters: int = 16) -> bytes:
    """n random bytes of `letters` letters (at most 180)."""
    return bytes(np.frombuffer(bytes(range(65, 65 + letters)), np.uint8)[
        _rng.integers(0, letters, n)])


def _copies() -> bytes:
    """A text of 180 letters with copies of earlier spans of 3 to 8 bytes
    (matches of exactly lazy and lazy + 1 at every level 1-3), each copy
    between fresh letters."""
    src = _rnd(2000, 180)
    out = bytearray(src)
    for k in range(120):
        ln = 3 + k % 6
        at = int(_rng.integers(0, len(src) - ln))
        out += src[at : at + ln] + _rnd(7, 180)
    return bytes(out)


_X = _rnd(400)
_M = b"\xf8\xf9\xfa\xfb"  # a short match, no byte of it a letter
CRAFTED = {
    # runs of one byte past 258, and of a two-byte period
    "runs": bytes(900) + _rnd(30) + b"a" * 700 + _rnd(40) + b"ab" * 600 + _rnd(20),
    "copies": _copies(),
    # short matches that end at the data's end, and 1 and 2 bytes before
    # it, and a long one that ends there
    "tail0": _rnd(300, 180) + _M + _rnd(50, 180) + _M,
    "tail1": _rnd(300, 180) + _M + _rnd(50, 180) + _M + b"~",
    "tail2": _rnd(300, 180) + _M + _rnd(50, 180) + _M + b"~~",
    "tail_long": _rnd(300) + _X + _rnd(50) + _X,
    # 'A' (0x41), 'a' (0x61), '!' (0x21), 0x01: one 15-bit hash a triple
    "collisions": b"".join(bytes([c]) + b"bc" + _rnd(1) for c in
                           _rng.choice([0x41, 0x61, 0x21, 0x01], 500)),
    # position 0's triple again later: position 0 is NIL
    "position0": b"abcd" + _rnd(100) + b"abcd" + _rnd(100) + b"abcd",
    "bash": _BASH[100_000:103_000],
}
# a candidate exactly MAX_DIST back, and one a byte further, in a filler
# no triple of which shares a hash with a mark's
_MD = EK.MAX_DIST
_F = b"\xee"
MAX_DIST_DATA = (_F * 100 + b"QJX1" + _F * 200 + b"ZVW2" + _F * (_MD - 208) + b"QJX1" +
                 _F * 201 + b"ZVW2" + _F * 300)
# a triple whose hash_head lies exactly MAX_DIST back, inside a long
# match's interior (left out of zlib's chains, in the superset's): a walk
# under a map that keeps it reads it as its first candidate
_R = _rnd(300, 180)
_R = _R[:100] + b"QJX" + _R[103:]
_Q = len(_R) + 50 + 100
MAX_DIST_SKIP = (_R + _rnd(50, 180) + _R + _F * (_Q + _MD - 2 * len(_R) - 50) + b"QJX" +
                 _rnd(20, 180))
# a window ending in zeros before a chunk of zeros: zlib matches from the
# window's last two positions
TAIL_OFF = 36_867
DICT_TAIL = (_BASH[TAIL_OFF - 32768 : TAIL_OFF], _BASH[TAIL_OFF : TAIL_OFF + 1500])


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
    lib = tmp_path_factory.mktemp("exf") / "libexf_host.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-x", "c++", str(SRC), "-o",
                    str(lib)], check=True, capture_output=True, timeout=300)
    dll = ctypes.CDLL(str(lib))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    dll.zrs_exact_greedy_host.argtypes = [P, P, I, I, P, P, P, P, L, I, P, P]
    dll.zrs_exact_resolve_host.argtypes = [P, P, I, I, P, P, P, P, P, L, I]
    dll.zrs_exact_dry_host.argtypes = [P, P, I, I, P, P, P, L]
    dll.zrs_exact_chase_host.argtypes = [P, P, P, I, I, P, P, P, P, P, L, P, P, P, P, L, P]
    dll.zrs_exact_set_piece.argtypes = [L]
    dll.zrs_dstream_pump_host.argtypes = [P] * 4
    return dll


def _p(t):
    return None if t is None else ctypes.c_void_p(t.data_ptr() if torch.is_tensor(t)
                                                  else t.ctypes.data)


def _greedy(dll, data: bytes, level: int, final: bool, window: bytes, seed=None, rounds=2,
            piece=EK.PIECE):
    """One chunk through zrs_exact_greedy_host: (bytes, the parse's map,
    [loop tops, live walks])."""
    dll.zrs_exact_set_piece(piece)
    try:
        buf = np.frombuffer(window + data + bytes(1), np.uint8).copy()
        meta = CD.chunk_meta([(len(window), len(data), len(window), int(final))], level)
        out = np.zeros(EK.out_bytes(torch.from_numpy(meta)), np.uint8)
        lens, st = np.zeros(1, np.int64), np.zeros(1, np.int32)
        words = EK.bit_words(len(window) + len(data))
        truth, stats = np.zeros(words, np.uint32), np.zeros(2, np.int64)
        seed = None if seed is None else np.ascontiguousarray(seed, np.uint32)
        assert dll.zrs_exact_greedy_host(buf.ctypes.data, meta.ctypes.data, 1, level,
                                         out.ctypes.data, lens.ctypes.data, st.ctypes.data,
                                         _p(seed), words, rounds, truth.ctypes.data,
                                         stats.ctypes.data) == 0
        assert st.tolist() == [0]
        return out[: lens[0]].tobytes(), truth, stats.tolist()
    finally:
        dll.zrs_exact_set_piece(EK.PIECE)


# ---------------------------------------------------------------------------
# the serial models: zlib's inserts, longest_match, deflate_fast
# ---------------------------------------------------------------------------


def _hash(b: bytes, p: int) -> int:
    return ((b[p] << 10) ^ (b[p + 1] << 5) ^ b[p + 2]) & MASK


def _lcp(b: bytes, total: int, p: int, q: int) -> int:
    n = 0
    while n < 258 and (b[p + n] if p + n < total else 0) == (b[q + n] if q + n < total else 0):
        n += 1
    return n


def serial_longest(b: bytes, total: int, pos: int, cur: int, level: int, ring) -> tuple:
    """zlib's longest_match at prev_length MIN_MATCH - 1 (deflate_fast's),
    decision for decision, over the ring of deltas of zlib's inserts:
    (best length, unclamped, and its distance)."""
    _good, _lazy, nice, chain = _cfg(level)
    lookahead = total - pos
    best, bd = 2, 0
    nice = min(nice, lookahead)
    limit = max(pos - EK.MAX_DIST, 0)
    while True:
        m = _lcp(b, total, pos, cur)
        if m > best:
            best, bd = m, pos - cur
            if m >= nice:
                break
        d = int(ring[cur & MASK])
        nxt = cur - d if d else 0
        if nxt <= limit or nxt >= cur:
            break
        cur = nxt
        chain -= 1
        if chain == 0:
            break
    return best, bd


class SerialFast:
    """zlib's deflate_fast with its serial inserts, pumped as DS pumps
    (native's limit contract: NO_FLUSH scans the positions with
    MIN_LOOKAHEAD bytes after them, a flush all; the <= 2 tail positions of
    a flush go in once their strings complete; FULL_FLUSH clears the heads
    and restarts the positions). Keeps head, the ring of deltas, the map of
    skipped positions, and the loop tops' walks."""

    def __init__(self, level: int, window: bytes = b""):
        self.level = level
        self.lazy = _cfg(level)[1]
        self.head = np.zeros(MASK + 1, np.int64)
        self.ring = np.zeros(MASK + 1, np.int64)
        self.buf = window
        self.skip = np.zeros(len(window), bool)
        self.p = len(window)
        # the dictionary's last two positions go in once the data completes
        # their strings (zlib's `insert`)
        self.pending = min(len(window), 2)
        self.near_end = 0  # skipped interiors of short matches ending within MIN_MATCH of the data
        self.walks = {}  # loop top -> (length, distance) of its longest, unclamped
        for q in range(len(window) - 2):
            self._insert(q)

    def _insert(self, q: int) -> None:
        h = _hash(self.buf, q)
        self.ring[q & MASK] = min(q - self.head[h], 0xFFFF)
        self.head[h] = q

    def pump(self, data: bytes, flush: int) -> None:
        self.buf += data
        self.skip = np.concatenate([self.skip, np.zeros(len(data), bool)])
        b, total = self.buf, len(self.buf)
        lookahead = total - self.p
        if self.pending and lookahead + self.pending >= 3:
            q = self.p - self.pending
            while self.pending:
                self._insert(q)
                q += 1
                self.pending -= 1
                if lookahead + self.pending < 3:
                    break
        limit = total if flush else max(total - 261, 0)
        while self.p < limit:
            p = self.p
            hh = 0
            if p + 3 <= total:
                hh = int(self.head[_hash(b, p)])
                self._insert(p)
            ml = 0
            if hh > 0 and p - hh <= EK.MAX_DIST:
                m, d = serial_longest(b, total, p, hh, self.level, self.ring)
                self.walks[p] = (m, d)
                if d:
                    ml = min(m, total - p)
            if ml >= 3:
                end = p + ml
                if ml <= self.lazy and total - end >= 3:
                    for q in range(p + 1, end):
                        self._insert(q)
                else:
                    self.skip[p + 1 : end] = True
                    self.near_end += (end - p - 1) * (ml <= self.lazy)
                self.p = end
            else:
                self.p = p + 1
        if flush:
            self.pending = min(self.p, 2)
            if flush == 3:
                self.head[:] = 0
                self.buf, self.skip, self.p, self.pending = b"", np.zeros(0, bool), 0, 0

    def words(self, n: int) -> np.ndarray:
        """The map as n uint32 words."""
        bits = np.zeros(32 * n, np.uint8)
        bits[: len(self.skip)] = self.skip
        return np.packbits(bits, bitorder="little").view(np.uint32)


def _resolve(buf: bytes, dict_len: int, level: int, words):
    """The plain resolve of one piece over the whole data under `words`."""
    total = len(buf)
    row = [0, total, 0, 0, max(0, total - 2), 0, dict_len, total, 0, 0, 0, 0, 1, 0]
    pieces, *_ = EK.with_offsets([row])
    data = torch.from_numpy(np.frombuffer(buf + bytes(1), np.uint8).copy())
    bits = torch.from_numpy(words.view(np.int32).copy())
    deltas, slots = EK.resolve_plain(data, torch.from_numpy(pieces), level, bits=bits)
    return torch.from_numpy(pieces), data, bits, deltas, slots.numpy()


# ---------------------------------------------------------------------------
# the reconstruction
# ---------------------------------------------------------------------------


def _inputs():
    out = {name: (b"", d) for name, d in CRAFTED.items()}
    out["max_dist"] = (b"", MAX_DIST_DATA)
    out["max_dist_skip"] = (b"", MAX_DIST_SKIP)
    out["dict_tail"] = DICT_TAIL
    return out


INPUTS = _inputs()


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("name", sorted(INPUTS))
def test_slots_under_the_true_map_reconstruct_longest(level, name):
    """At every position of the chunk: the slot resolved under the parse's
    own map equals zlib's longest over the chains of the positions zlib
    inserted before it (0 where it has no hash_head within MAX_DIST), and
    its reach lies at or below the last candidate that walk compared; at
    each loop top that is the walk the serial parse ran."""
    window, data = INPUTS[name]
    buf = window + data
    total = len(buf)
    model = SerialFast(level, window)
    model.pump(data, 4)
    words = model.words(EK.bit_words(total))
    *_r, slots = _resolve(buf, len(window), level, words)
    head = np.zeros(MASK + 1, np.int64)
    ring = np.zeros(MASK + 1, np.int64)
    inserted = [q + 3 <= total and not model.skip[q] for q in range(total)]
    checked = walks = 0
    for p in range(total):
        if p >= len(window) and p + 3 <= total:
            hh = int(head[_hash(buf, p)])
            want = 0
            if hh > 0 and p - hh <= EK.MAX_DIST:
                m, d = serial_longest(buf, total, p, hh, level, ring)
                want = (m << 15) | d
                if p in model.walks:
                    assert model.walks[p] == (m, d)
                    walks += 1
            assert int(slots[p - len(window), 0]) == want, (name, level, p)
            checked += 1
        if inserted[p]:
            h = _hash(buf, p)
            ring[p & MASK] = min(p - head[h], 0xFFFF)
            head[h] = p
    assert checked and walks == len(model.walks)


@pytest.mark.parametrize("level", LEVELS)
def test_the_crafted_inputs_reach_their_cases(level):
    """The inputs hold what they are for: long-match interiors and
    near-end interiors skipped, matches of exactly lazy and lazy + 1, a
    candidate exactly MAX_DIST back, a walk into the dictionary's tail."""
    lazy = _cfg(level)[1]
    lengths = set()
    for name, (window, data) in INPUTS.items():
        model = SerialFast(level, window)
        model.pump(data, 4)
        lengths |= {min(m, len(window + data) - p) for p, (m, d) in model.walks.items() if d}
        if name in ("tail0", "tail1", "tail2"):
            assert model.near_end, name
        if name == "runs":
            assert model.skip.sum() > 1000
        if name == "max_dist":
            assert any(d == EK.MAX_DIST for _m, d in model.walks.values())
        if name == "max_dist_skip":  # the mark's copy is skipped, and no walk finds it
            q = _Q
            assert data[q : q + 3] == b"QJX" and model.skip[q] and q + _MD not in model.walks
        if name == "dict_tail":
            assert any(p - d >= len(window) - 2 and p - d < len(window) for p, (_m, d) in
                       model.walks.items() if d)
    assert {lazy, lazy + 1, 258} <= lengths


# ---------------------------------------------------------------------------
# the host build's bytes under every assumed map
# ---------------------------------------------------------------------------


def _maps(n: int, truth) -> dict:
    maps = {"none": np.zeros(n, np.uint32), "true": truth,
            "all": np.full(n, 0xFFFFFFFF, np.uint32)}
    for seed in range(4):
        maps[f"random{seed}"] = np.random.default_rng(seed).integers(
            0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    return maps


@pytest.mark.parametrize("level", LEVELS)
def test_host_build_gives_zlibs_bytes_under_every_assumed_map(host, level):
    """Every crafted input, primed and not, final and not, whole and in
    pieces of 777 positions: zlib's bytes from every assumed map in one
    round, and in 1-3 rounds from none skipped; no live walk under the true
    map, and the map the chase leaves is the serial parse's."""
    for name, (window, data) in INPUTS.items():
        for win in {window, _BASH[50_000 - 4000 : 50_000]}:
            for final in (True, False):
                want = zraw(data, level, final, win)
                got, truth, stats = _greedy(host, data, level, final, win)
                assert got == want, (name, len(win), final)
                model = SerialFast(level, win)
                model.pump(data, 4 if final else 2)
                n = EK.bit_words(len(win + data))
                assert np.array_equal(truth, model.words(n)), (name, len(win), final)
                for label, seed in _maps(n, truth).items():
                    got, _t, st = _greedy(host, data, level, final, win, seed, rounds=1)
                    assert got == want, (name, len(win), final, label)
                    assert label != "true" or st[1] == 0, (name, st)
                for rounds in (1, 3):
                    assert _greedy(host, data, level, final, win, rounds=rounds)[0] == want
                assert _greedy(host, data, level, final, win, piece=777)[0] == want
                assert _greedy(host, data, level, final, win, seed=_maps(n, truth)["all"],
                               rounds=1, piece=777)[0] == want


@pytest.mark.parametrize("level", LEVELS)
def test_host_build_on_binary_data_and_the_live_walks(host, level):
    """60 KB of /bin/bash: zlib's bytes in 1, 2 and 3 rounds, the live
    walks falling with the rounds and none under the true map."""
    data = _BASH[100_000:160_000]
    want = zraw(data, level)
    lives = []
    for rounds in (1, 2, 3):
        got, truth, (tops, live) = _greedy(host, data, level, True, b"", rounds=rounds)
        assert got == want
        lives.append(live)
    assert lives[0] > lives[2] and tops > 0
    got, _t, (tops2, live2) = _greedy(host, data, level, True, b"", truth, rounds=1)
    assert got == want and live2 == 0 and tops2 == tops


# ---------------------------------------------------------------------------
# the plain resolve and dry parse against the host build; run_static
# ---------------------------------------------------------------------------


def _host_resolve(dll, data, pieces, level, deltas, slots, bits, stride, chains,
                  head_old=None, ring=None):
    assert dll.zrs_exact_resolve_host(_p(data), _p(pieces), pieces.shape[0], level, _p(head_old),
                                      _p(ring), _p(deltas), _p(slots), _p(bits), stride,
                                      chains) == 0


@pytest.mark.parametrize("level", LEVELS)
def test_plain_resolve_and_dry_parse_equal_host_build(host, level):
    """EX's pieces (a first one from position 0, later ones whose deltas
    start 32 KiB before them, each chunk its own map at P_WORK *
    bit_stride) under random maps, then the dry parse of their slots from
    the pieces' starts and from records' spos; and a DS pump's piece seeded
    by a handle's head and prevd: the same deltas, slots and maps."""
    buf = _BASH[200_000:290_000]
    data = torch.from_numpy(np.frombuffer(buf + bytes(1), np.uint8).copy())
    rows = CD.chunk_meta([(0, 6000, 0, 1), (50_000, 30_000, 32768, 0)], level).tolist()
    prs = [EK.ex_piece(rows[0], 0, 0, 0), EK.ex_piece(rows[1], 32768, 1, 1, 9000),
           EK.ex_piece(rows[1], 32768 + 18_000, 1, 1, 9000)]
    pieces_np, nd, ns, *_ = EK.with_offsets(prs)
    pieces = torch.from_numpy(pieces_np)
    stride = EK.bit_words(32768 + 30_000)
    words = np.random.default_rng(level).integers(0, 1 << 32, 2 * stride,
                                                  dtype=np.uint64).astype(np.uint32)
    words &= np.random.default_rng(level + 9).integers(0, 1 << 32, 2 * stride,
                                                       dtype=np.uint64).astype(np.uint32)
    bits = torch.from_numpy(words.view(np.int32).copy())
    deltas = torch.zeros(max(nd, 1), dtype=torch.int16)
    slots = torch.zeros(max(ns, 1), 2, dtype=torch.int32)
    _host_resolve(host, data, pieces, level, deltas, slots, bits, stride, 1)
    want_d, want_s = EK.resolve_plain(data, pieces, level, bits=bits, bit_stride=stride)
    assert torch.equal(EK.unsigned(deltas), EK.unsigned(want_d))
    assert torch.equal(slots, want_s)
    assert int((slots[:, 0] != 0).sum()) > 10_000 and int((slots[:, 1] != 0).sum()) > 1000
    recs = np.zeros(2 * EK.REC, np.int64)
    for spos in (None, 32768 + 18_000 + 57):
        if spos is not None:
            recs[EK.REC + EK.REC_SPOS] = spos
        got = words.copy()
        assert host.zrs_exact_dry_host(None, pieces_np.ctypes.data, len(prs), level,
                                       None if spos is None else recs.ctypes.data,
                                       slots.numpy().ctypes.data, got.ctypes.data, stride) == 0
        plain = words.copy()
        EK.dry_plain(pieces_np, level, slots.numpy().astype(np.int64), plain, stride,
                     None if spos is None else recs)
        assert np.array_equal(got, plain) and not np.array_equal(got, words)
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
        n = EK.bit_words(int(rec[DK.D_TOTAL]), a & ~31)
        m = np.random.default_rng(a).integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
        bits = torch.from_numpy(m.view(np.int32).copy())
        head, ring = work[: 4 * EK.HASH_SIZE].view(torch.int32), work[4 * EK.HASH_SIZE :]
        ring = ring[: 2 * 32768].view(torch.int16)
        deltas = torch.zeros(max(c1 - a, 1), dtype=torch.int16)
        slots = torch.zeros(max(we - s, 1), 2, dtype=torch.int32)
        _host_resolve(host, data, pieces, level, deltas, slots, bits, 0, 1, head, ring)
        want_d, want_s = EK.resolve_plain(data, pieces, level, head, ring, bits=bits)
        assert torch.equal(EK.unsigned(deltas), EK.unsigned(want_d))
        assert torch.equal(slots, want_s)
        out = torch.zeros(int(rec[DK.D_OUT_CAP]), dtype=torch.uint8)
        host.zrs_dstream_pump_host(rec.ctypes.data, data.data_ptr(), work.data_ptr(),
                                   out.data_ptr())
        assert rec[DK.D_STATUS] == 0


@pytest.mark.parametrize("level", LEVELS)
def test_run_static_through_the_host_build(host, level):
    """The wrapper's plan and run_static over the host build's launches,
    PIECE, ROUND, MAX_SLOTS and ROUNDS patched as a caller would: a round
    of pieces is ROUNDS[level] resolves over chains built under the map (a dry
    parse before each but the first), then the chase, each chunk's map at
    its place in the batch; each chunk zlib's primed raw deflate."""
    data = _BASH[120_000:200_000]
    n = len(data)
    dt = torch.from_numpy(np.frombuffer(data + bytes(1), np.uint8).copy())
    calls = []

    def resolve(data, pieces, level, deltas, slots, cb, wb, bits=None, bit_stride=0):
        calls.append(("resolve", bits is not None))
        _host_resolve(host, data, pieces, level, deltas, slots if wb else None, bits, bit_stride,
                      int(cb > 0))

    def dry(pieces, level, slots, bits, bit_stride, recs):
        calls.append(("dry", pieces.shape[0]))
        assert host.zrs_exact_dry_host(None, _p(pieces), pieces.shape[0], level, _p(recs),
                                       _p(slots), _p(bits), bit_stride) == 0

    def chase(data, meta, pieces, level, out, lens, st, recs, scratch, slots, deltas, dlist,
              bits, bit_stride):
        calls.append(("chase", pieces.shape[0]))
        assert host.zrs_exact_chase_host(_p(data), _p(meta), _p(pieces), pieces.shape[0], level,
                                         _p(out), _p(lens), _p(st), _p(recs), _p(scratch),
                                         EK.WORK_BYTES, _p(slots), _p(deltas), _p(dlist),
                                         _p(bits), bit_stride, None) == 0

    for chunk, piece, round_positions, slots, rounds in (
            (16_384, 5000, 20_000, 3, 2), (n, 30_000, 1 << 24, 1024, 3), (7000, 1 << 22, 100, 2, 1),
            (7000, 1 << 22, 1 << 24, 4, 2)):
        rows = [(lo, min(n, lo + chunk) - lo, min(32768, lo), int(lo + chunk >= n))
                for lo in range(0, n, chunk)]
        meta = torch.from_numpy(CD.chunk_meta(rows, level))
        calls.clear()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(EK, "PIECE", piece)
            mp.setattr(EK, "ROUND", round_positions)
            mp.setattr(EK, "MAX_SLOTS", slots)
            mp.setattr(EK, "ROUNDS", {level: rounds})
            batches = EK.plan(meta.tolist())
            out, lens, st = EK.run_static(dt, meta, level, resolve, chase, dry)
        per_round = [len(p) for _nch, rs in batches for p, *_rest in rs]
        want = []
        for p in per_round:
            want += [("resolve", True)]
            for _ in range(rounds - 1):
                want += [("dry", p), ("resolve", True)]
            want += [("chase", p)]
        assert calls == want
        assert not st.any()
        parts = [out[m[4] : m[4] + ln].numpy().tobytes() for m, ln in zip(meta.tolist(),
                                                                        lens.tolist())]
        assert parts == [zraw(data[lo : lo + ln], level, bool(fin), data[lo - dl : lo])
                         for lo, ln, dl, fin in rows]


def test_constants_match_the_source():
    src = SRC.read_text()
    rounds = ", ".join(str(EK.ROUNDS[lv]) for lv in (1, 2, 3))
    assert f"kHostRounds[4] = {{0, {rounds}}};" in src
    assert EK.static_level(1) and EK.greedy_level(3) and not EK.greedy_level(4)
    assert [EK.bit_words(t, b) for t, b in ((0, 0), (1, 0), (32, 0), (33, 0), (100, 64))] == \
        [1, 2, 2, 3, 3]


def test_one_round_takes_a_launchs_chunks_of_128k():
    """A round holds MAX_SLOTS chunks of 128 KiB (deflate_parallel's
    chunk), so that the chases of a call of that many overlap on the card;
    one chunk more starts a second batch."""
    chunk = CD.DEFAULT_CHUNK
    rows = [[k * chunk, chunk, min(32768, k * chunk), 0] for k in range(EK.MAX_SLOTS + 1)]
    assert [(n, len(r)) for n, r in EK.plan(rows[:-1])] == [(EK.MAX_SLOTS, 1)]
    assert [n for n, _ in EK.plan(rows)] == [EK.MAX_SLOTS, 1]


def test_wrappers_refuse_cpu_tensors_and_maps_past_level_3():
    data = torch.zeros(64, dtype=torch.uint8)
    pieces = torch.zeros(1, EK.PIECE_FIELDS, dtype=torch.int64)
    d, s = torch.zeros(1, dtype=torch.int16), torch.zeros(1, 2, dtype=torch.int32)
    m = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="expected CUDA"):
        EK.dry_cuda(pieces, 1, s, m, 0)
    with pytest.MonkeyPatch.context() as mp:
        from zlib_rs_tpu_torch import _device

        mp.setattr(_device, "require_cuda", lambda *a: None)
        with pytest.raises(ValueError, match="levels 1-3"):
            EK.resolve_cuda(data, pieces, 6, d, s, 0, 0, bits=m)
        with pytest.raises(ValueError, match="1-3"):
            EK.dry_cuda(pieces, 4, s, m, 0)


# ---------------------------------------------------------------------------
# DS: the handle's tables after each pump
# ---------------------------------------------------------------------------


def _script(level: int, pumps: int = 12):
    src = _BASH[300_000:600_000]
    rng = random.Random(level)
    plan = ([(1, 0)] * 40 + [(2, 2), (1, 0), (1, 0), (3, 2), (1, 3), (2, 0), (65_536, 0), (700, 2),
                             (9000, 3), (65_536, 2), (5, 0)]
            + [(rng.choice([1, 60, 3000, 20_000]), rng.choice([0, 0, 2, 3])) for _ in range(pumps)])
    out, pos = [], 0
    for n, flush in plan:
        chunk = src[pos : pos + n]
        if n == 3000:  # a run to the end of the pump: a near-end interior skipped at a flush
            chunk = chunk[:2000] + bytes(1000)
        out.append((chunk, flush))
        pos += n
    return out


@pytest.mark.parametrize("level", LEVELS)
def test_ds_handle_tables_equal_the_serial_inserts(monkeypatch, host, level):
    """Pumps of 1 byte to 64 KiB under NO_FLUSH, SYNC_FLUSH and FULL_FLUSH
    through the host build: after each pump the handle's head and prevd
    are zlib's serial inserts' (SerialFast), so a skipped interior's ring
    slot keeps the value an older insert wrote and a flushing pump's
    near-end interiors stay out; the stream is zlib's."""

    def pump(rec, data, work, out, rec_dev=None):
        host.zrs_dstream_pump_host(rec.ctypes.data, data.data_ptr(), work.data_ptr(),
                                   out.data_ptr())

    monkeypatch.setattr(DK, "pump", pump)
    script = _script(level)
    handle = DK.Handle(level, "cpu")
    s = tnative.RawDeflateStream(level, _handle=handle)
    model = SerialFast(level)
    outs, untouched = [], 0
    for k, (data, flush) in enumerate(script):
        outs.append(s.pump(data, flush))
        model.pump(data, flush)
        head = handle.work[: 4 * EK.HASH_SIZE].view(torch.int32).numpy().astype(np.int64)
        ring = EK.unsigned(handle.work[4 * EK.HASH_SIZE : 4 * EK.HASH_SIZE + 2 * 32768]
                           .view(torch.int16)).numpy()
        assert np.array_equal(head, model.head), k
        assert np.array_equal(ring, model.ring), k
        skipped = np.nonzero(model.skip)[0]
        untouched += int((ring[skipped & MASK] != 0).sum())
    outs.append(s.pump(b"", 4))
    z = zlib.compressobj(level, zlib.DEFLATED, -15)
    zb = b""
    for data, flush in script:
        zb += z.compress(data)
        if flush:
            zb += z.flush({2: zlib.Z_SYNC_FLUSH, 3: zlib.Z_FULL_FLUSH}[flush])
    assert b"".join(outs) == zb + z.flush()
    assert model.near_end and untouched


@pytest.mark.parametrize("level", [1, 3])
def test_ds_pump_longer_than_a_piece_runs_a_piece_at_a_time(monkeypatch, host, level):
    """With EK.PIECE patched to 5,000, pumps of up to 64 KiB go to the host
    build a piece at a time (NO_FLUSH but the last, which takes the pump's
    flush); the stream is zlib's."""
    monkeypatch.setattr(EK, "PIECE", 5000)
    seen = []

    def pump(rec, data, work, out, rec_dev=None):
        seen.append(int(rec[DK.D_FLUSH]))
        host.zrs_dstream_pump_host(rec.ctypes.data, data.data_ptr(), work.data_ptr(),
                                   out.data_ptr())

    monkeypatch.setattr(DK, "pump", pump)
    src = _BASH[500_000:800_000]
    handle = DK.Handle(level, "cpu")
    z = zlib.compressobj(level, zlib.DEFLATED, -15)
    got, want, pos = b"", b"", 0
    for n, flush in [(65_536, 0), (12_345, 2), (65_536, 3), (5001, 2), (40_000, 0), (1, 4)]:
        data = src[pos : pos + n]
        pos += n
        seen.clear()
        got += handle.pump(data, flush)
        want += z.compress(data) + (z.flush({2: zlib.Z_SYNC_FLUSH, 3: zlib.Z_FULL_FLUSH,
                                             4: zlib.Z_FINISH}[flush]) if flush else b"")
        assert seen == [0] * (-(-n // 5000) - 1) + [flush]
    assert got == want


# ---------------------------------------------------------------------------
# MEDIUM4-6 (levels 11-13): native's run_medium over the slots
# ---------------------------------------------------------------------------

MEDIUMS = (EK.MEDIUM_BASE, EK.MEDIUM_BASE + 1, EK.MEDIUM_BASE + 2)


class TrackedMedium(TM._Medium):
    """The port's copy of native's MEDIUM scan, its inserts and accepted
    fizzles recorded."""

    def __init__(self, buf: bytes, level: int, dict_len: int):
        self.ins, self.fizzles = [], 0
        super().__init__(buf, TM._KNOBS[level - EK.MEDIUM_BASE + 4], dict_len)

    def insert4(self, pos: int) -> None:
        self.ins.append(pos)
        super().insert4(pos)

    def fizzle(self, cur: list, nm: list) -> None:
        before = list(cur)
        super().fizzle(cur, nm)
        self.fizzles += cur != before

    def truth(self, n: int) -> np.ndarray:
        """The parse's map as n words below its frontier (the positions it
        never inserts set: none past its last insert is decided), the
        dictionary's tail set."""
        bits = np.zeros(32 * n, np.uint8)
        front = max(self.ins) + 1 if self.ins else 0
        bits[:front] = 1
        bits[np.array(self.ins, np.int64)] = 0
        bits[max(0, self.dict_len - 3) : self.dict_len] = 1
        return np.packbits(bits, bitorder="little").view(np.uint32), front


def _fizzled(n: int) -> bytes:
    """A short match whose next match extends back over it (med_fizzle
    takes it): 'wxyz' + T, then n candidates of 'wxyz' and 3 fresh bytes
    (more than MEDIUM6's chain of 256 when n is 300), then a byte found
    before no 'wxyz' and 'wxyz' + T again."""
    t = _rnd(80, 180)
    fill = b"".join(b"wxyz" + _rnd(3, 180) for _ in range(n))
    return _rnd(10, 180) + b"wxyz" + t + fill + b"\x01wxyz" + t + _rnd(300, 180)


def _medium_inputs() -> dict:
    out = {name: (b"", d) for name, d in CRAFTED.items()}
    out["max_dist"] = (b"", MAX_DIST_DATA)
    out["dict_tail"] = DICT_TAIL
    # runs of one byte: 257 and 258 matches at MEDIUM4/5, their interiors never inserted
    out["zero_runs"] = (b"", bytes(3000) + _rnd(50) + b"\xff" * 1200 + _rnd(20) + bytes(600))
    out["fizzle"] = (b"", _fizzled(300))
    # a 100-byte copy ending 150, 60 and 3 bytes before the end (within
    # MIN_LOOKAHEAD and within length + WANT_MIN of it)
    for k in (150, 60, 3):
        x = _rnd(100, 180)
        out[f"near_end{k}"] = (b"", _rnd(500, 180) + x + _rnd(400, 180) + x + _rnd(k, 180))
    return out


MEDIUM_INPUTS = _medium_inputs()


def _native(data: bytes, level: int, final: bool, window: bytes) -> bytes:
    from zlib_rs_tpu import native as jnative

    return jnative.deflate_chunk(data, level, final, window or None)


@pytest.mark.parametrize("level", MEDIUMS)
def test_medium_inserts_each_position_once_and_reaches_its_cases(level):
    """native's MEDIUM inserts go in increasing order and never twice (the
    orgstart rule keeps a fizzled next match from inserting again: a
    re-insert would write a delta of 0 and cut its chain), so the chains
    are static but for the positions it never inserts; the crafted inputs
    hold what they are for: a 257-258 match's interior left out at MEDIUM4/5
    (every interior in at MEDIUM6), an accepted fizzle, a match's interior
    near the end left out."""
    for name, (window, data) in MEDIUM_INPUTS.items():
        m = TrackedMedium(window + data, level, len(window))
        m.run(True)
        assert m.ins == sorted(set(m.ins)), name
        _w, front = m.truth(EK.bit_words(len(window + data)))
        skipped = front - len(window) - len([q for q in m.ins if q >= len(window)])
        if name == "zero_runs":
            assert (skipped > 1000) == (level != EK.MEDIUM_BASE + 2), (level, skipped)
        if name == "fizzle":
            assert m.fizzles >= 1
        if name == "near_end3":  # the copy's interior, within length + WANT_MIN of the end
            total = len(window + data)
            assert not any(total - 103 < q < total - 3 for q in m.ins)
            assert total - 103 in m.ins


@pytest.mark.parametrize("level", MEDIUMS)
def test_medium_host_build_gives_natives_bytes_under_every_assumed_map(host, level):
    """Every MEDIUM input, primed and not, final and not: native's
    deflate_chunk bytes (the plain version's too) from the host build in 1
    and 2 rounds, from every assumed map in one round, whole and in pieces
    of 777 positions; no live walk under the true map, and the map the chase
    leaves is native's inserts' below their frontier."""
    for name, (window, data) in MEDIUM_INPUTS.items():
        for win in {window, _BASH[50_000 - 4000 : 50_000]}:
            for final in (True, False):
                want = _native(data, level, final, win)
                assert TM.compress_medium(data, level - EK.MEDIUM_BASE + 4, final, win) == want
                got, truth, stats = _greedy(host, data, level, final, win, rounds=1)
                assert got == want, (name, len(win), final)
                n = EK.bit_words(len(win + data))
                m = TrackedMedium(win + data, level, len(win))
                m.run(final)
                model, front = m.truth(n)
                bits = np.unpackbits(truth.view(np.uint8), bitorder="little")[:front]
                assert np.array_equal(bits, np.unpackbits(model.view(np.uint8),
                                                          bitorder="little")[:front]), name
                maps = _maps(n, model)
                for label, seed in maps.items():
                    got, _t, st = _greedy(host, data, level, final, win, seed, rounds=1)
                    assert got == want, (name, len(win), final, label)
                    assert label != "true" or st[1] == 0, (name, st)
                assert _greedy(host, data, level, final, win, rounds=2)[0] == want
                assert _greedy(host, data, level, final, win, piece=777)[0] == want
                assert _greedy(host, data, level, final, win, seed=maps["all"], rounds=2,
                               piece=777)[0] == want


@pytest.mark.parametrize("piece", [1, 100, 257, 258, 300, 1000])
@pytest.mark.parametrize("level", MEDIUMS)
def test_medium_chunk_of_1024_positions_in_pieces(host, level, piece):
    """A chunk of 1,024 positions (runs, copies, a fizzle) cut into pieces:
    each piece's slots run MAX_MATCH past it for the lookahead, the carried
    next match and the frontier cross in the record; native's bytes."""
    data = (bytes(300) + _fizzled(40)[:400] + b"ab" * 200)[:1024]
    for win in (b"", _BASH[60_000:70_000]):
        for final in (True, False):
            want = _native(data, level, final, win)
            for rounds in (1, 2):
                assert _greedy(host, data, level, final, win, rounds=rounds, piece=piece)[0] \
                    == want, (len(win), final, rounds)


@pytest.mark.parametrize("level", MEDIUMS)
def test_medium_host_build_on_binary_data_and_the_live_walks(host, level):
    """60 KB of /bin/bash and 60 KB of runs: native's bytes in 1 and 2
    rounds; under the true map no live walk."""
    for data in (_BASH[100_000:160_000], (bytes(700) + _rnd(40) + b"\x01" * 500) * 50):
        want = _native(data, level, True, b"")
        for rounds in (1, 2):
            got, truth, (tops, _live) = _greedy(host, data, level, True, b"", rounds=rounds)
            assert got == want and tops > 0
        got, _t, (_tops, live) = _greedy(host, data, level, True, b"", truth, rounds=1)
        assert got == want and live == 0


@pytest.mark.parametrize("level", MEDIUMS)
def test_medium_plain_resolve_and_dry_parse_equal_host_build(host, level):
    """EX's pieces at MEDIUM (slots past each piece by MAX_MATCH, deltas of
    hash4's chains) under random maps: resolve_plain's deltas and slots are
    the host build's; then the dry parse of the slots from records not
    started and from a record left by the chase of a chunk's first piece
    (its carried next match, its frontier): dry_plain's maps are the host
    build's. A DS pump's piece seeded by a handle's head4 and prevd4 too."""
    buf = (_BASH[200_000:240_000] + bytes(5000) + _fizzled(40) + _BASH[300_000:330_000])
    data = torch.from_numpy(np.frombuffer(buf + bytes(8), np.uint8).copy())
    rows = CD.chunk_meta([(0, 6000, 0, 1), (40_000, 30_000, 32768, 0)], level).tolist()
    prs = [EK.ex_piece(rows[0], 0, 0, 0, EK.PIECE, True),
           EK.ex_piece(rows[1], 32768, 1, 1, 9000, True),
           EK.ex_piece(rows[1], 32768 + 9000, 1, 1, 9000, True)]
    pieces_np, nd, ns, *_ = EK.with_offsets(prs, True)
    assert ns == sum(EK.slot_end(r, True) - r[EK.P_S] for r in prs)
    pieces = torch.from_numpy(pieces_np)
    stride = EK.bit_words(32768 + 30_000)
    words = np.random.default_rng(level).integers(0, 1 << 32, 2 * stride,
                                                  dtype=np.uint64).astype(np.uint32)
    words &= np.random.default_rng(level + 9).integers(0, 1 << 32, 2 * stride,
                                                       dtype=np.uint64).astype(np.uint32)
    bits = torch.from_numpy(words.view(np.int32).copy())
    deltas = torch.zeros(max(nd, 1), dtype=torch.int16)
    slots = torch.zeros(max(ns, 1), 2, dtype=torch.int32)
    _host_resolve(host, data, pieces, level, deltas, slots, bits, stride, 1)
    want_d, want_s = EK.resolve_plain(data, pieces, level, bits=bits, bit_stride=stride)
    assert torch.equal(EK.unsigned(deltas), EK.unsigned(want_d))
    assert torch.equal(slots, want_s)
    assert int((slots[:, 0] != 0).sum()) > 10_000
    # the records: none started, then chunk 1's after its first piece's chase
    recs = np.zeros(2 * EK.REC, np.int64)
    meta = torch.from_numpy(np.array(rows, np.int64))
    out = torch.zeros(EK.out_bytes(meta), dtype=torch.uint8)
    lens, st = torch.zeros(2, dtype=torch.int64), torch.zeros(2, dtype=torch.int32)
    scratch = torch.zeros(2 * EK.WORK_BYTES, dtype=torch.uint8)
    dlist = torch.zeros_like(deltas)
    for chased in (False, True):
        if chased:
            first = torch.from_numpy(pieces_np[1:2].copy())
            assert host.zrs_exact_chase_host(_p(data), _p(meta), _p(first), 1, level, _p(out),
                                             _p(lens), _p(st), recs.ctypes.data, _p(scratch),
                                             EK.WORK_BYTES, _p(slots), _p(deltas), _p(dlist),
                                             _p(bits.clone()), stride, None) == 0
            assert recs[EK.REC + EK.REC_STARTED] and recs[EK.REC + EK.REC_FRONT] > 32768 + 9000
        got = words.copy()
        assert host.zrs_exact_dry_host(_p(data), pieces_np.ctypes.data, len(prs), level,
                                       recs.ctypes.data, slots.numpy().ctypes.data,
                                       got.ctypes.data, stride) == 0
        plain = words.copy()
        EK.dry_plain(pieces_np, level, slots.numpy().astype(np.int64), plain, stride, recs,
                     np.frombuffer(buf, np.uint8))
        assert np.array_equal(got, plain) and not np.array_equal(got, words), chased
    # DS: a handle's tables after 40,000 bytes, then a pump of 20,000
    rec = np.zeros(DK.REC, np.int64)
    rec[DK.D_LEVEL] = level
    rec[DK.D_MATCH_LENGTH] = rec[DK.D_PREV_LENGTH] = 2
    work = torch.zeros(EK.work_bytes(level), dtype=torch.uint8)
    for chunk, flush in ((buf[:40_000], 2), (buf[40_000:60_000], 0)):
        rec[DK.D_TOTAL] += len(chunk)
        rec[DK.D_FLUSH], rec[DK.D_OUT_CAP] = flush, DK.room(int(rec[DK.D_TOTAL]))
        a, c1, s, we = DK.ranges(rec)
        row = [0, int(rec[DK.D_TOTAL]), a, a, c1, 0, s, we, 0, 0, 0, 0, 0, 0]
        pieces, _nd, dns, *_ = EK.with_offsets([row], True)
        pieces = torch.from_numpy(pieces)
        n = EK.bit_words(int(rec[DK.D_TOTAL]), a & ~31)
        m = np.random.default_rng(a).integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
        mbits = torch.from_numpy(m.view(np.int32).copy())
        head, ring = DK.handle_tables(work, level)
        head = head[: 4 * 65536].view(torch.int32)
        ring = ring[: 2 * 32768].view(torch.int16)
        ddeltas = torch.zeros(max(c1 - a, 1), dtype=torch.int16)
        dslots = torch.zeros(max(dns, 1), 2, dtype=torch.int32)
        _host_resolve(host, data, pieces, level, ddeltas, dslots, mbits, 0, 1, head, ring)
        want_d, want_s = EK.resolve_plain(data, pieces, level, head, ring, bits=mbits)
        assert torch.equal(EK.unsigned(ddeltas), EK.unsigned(want_d))
        assert torch.equal(dslots, want_s)
        dout = torch.zeros(int(rec[DK.D_OUT_CAP]), dtype=torch.uint8)
        host.zrs_dstream_pump_host(rec.ctypes.data, data.data_ptr(), work.data_ptr(),
                                   dout.data_ptr())
        assert rec[DK.D_STATUS] == 0 and head.any()


@pytest.mark.parametrize("level", MEDIUMS)
def test_medium_run_static_through_the_host_build(host, level):
    """The wrapper's plan and run_static at MEDIUM over the host build's
    launches (pieces of 30,000 positions, ROUNDS 2): the first map holds
    each dictionary's tail, the dry parse gets the records and the data,
    each chunk native's bytes, final and not."""
    data = (_BASH[120_000:170_000] + bytes(9000) + _fizzled(300))
    n = len(data)
    dt = torch.from_numpy(np.frombuffer(data + bytes(8), np.uint8).copy())
    calls = []

    def resolve(data, pieces, level, deltas, slots, cb, wb, bits=None, bit_stride=0):
        calls.append("resolve")
        _host_resolve(host, data, pieces, level, deltas, slots if wb else None, bits, bit_stride,
                      int(cb > 0))

    def dry(pieces, level, slots, bits, bit_stride, recs, data=None):
        calls.append("dry")
        assert host.zrs_exact_dry_host(_p(data), _p(pieces), pieces.shape[0], level, _p(recs),
                                       _p(slots), _p(bits), bit_stride) == 0

    def chase(data, meta, pieces, level, out, lens, st, recs, scratch, slots, deltas, dlist,
              bits, bit_stride):
        calls.append("chase")
        assert host.zrs_exact_chase_host(_p(data), _p(meta), _p(pieces), pieces.shape[0], level,
                                         _p(out), _p(lens), _p(st), _p(recs), _p(scratch),
                                         EK.WORK_BYTES, _p(slots), _p(deltas), _p(dlist),
                                         _p(bits), bit_stride, None) == 0

    rows = [(lo, min(n, lo + 16_384) - lo, min(32768, lo), int(lo + 16_384 >= n))
            for lo in range(0, n, 16_384)]
    meta = torch.from_numpy(CD.chunk_meta(rows, level))
    for share, want in ((0.0, ["resolve", "dry", "resolve", "chase"] * 3),
                        (1.1, ["resolve", "chase"] * 3)):
        calls.clear()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(EK, "PIECE", 7000)
            mp.setattr(EK, "ROUNDS", {level: 2})
            mp.setattr(EK, "LONG_SHARE", share)
            out, lens, st = EK.run_static(dt, meta, level, resolve, chase, dry)
        assert calls == want, share
        for (lo, ln, dl, fin), off, m in zip(rows, meta[:, 4].tolist(), lens.tolist()):
            got = out[off : off + m].numpy().tobytes()
            assert got == _native(data[lo : lo + ln], level, bool(fin), data[lo - dl : lo])


def test_medium_second_round_where_the_slots_hold_long_matches():
    """MEDIUM4/5 take a second round where the first round's slots hold
    matches longer than 16 x lazy (257-258, whose interiors med_insert_match
    never inserts) at LONG_SHARE of the positions or more; MEDIUM6 (lazy
    32) and levels 1-3 whatever the slots."""
    def slots(n_long, n):
        v = torch.zeros(n, 2, dtype=torch.int32)
        v[:n_long, 0] = (258 << 15) | 1
        v[n_long : n_long + 5, 0] = (256 << 15) | 7  # not past 16 x lazy
        v[n_long + 5 : n_long + 9, 0] = 258 << 15  # no match (distance 0)
        return v

    for lv in (EK.MEDIUM_BASE, EK.MEDIUM_BASE + 1):
        assert EK.long_share(slots(25, 100), lv) == 0.25
        assert EK.take_round(lv, slots(25, 100)) and not EK.take_round(lv, slots(24, 100))
    assert EK.long_share(slots(25, 100), EK.MEDIUM_BASE + 2) == 0.0
    assert EK.take_round(1, slots(0, 100)) and EK.take_round(3, slots(0, 100))
    assert EK.ROUNDS[EK.MEDIUM_BASE + 2] == 1 < EK.ROUNDS[EK.MEDIUM_BASE]


def test_medium_constants_match_the_source():
    """The host build's MEDIUM rounds are the wrapper's ROUNDS; MEDIUM is
    resolved under a map, on its one-deeper knob rows; a piece's slots run
    MAX_MATCH past its end, short of the last three positions."""
    src = SRC.read_text()
    rounds = ", ".join(str(EK.ROUNDS[lv]) for lv in MEDIUMS)
    assert f"kHostMediumRounds[3] = {{{rounds}}};" in src
    assert all(EK.resolved_level(lv) and EK.mapped_level(lv) for lv in MEDIUMS)
    assert not EK.static_level(EK.MEDIUM_BASE) and not EK.mapped_level(6)
    assert [EK.knob_level(lv) for lv in (*MEDIUMS, 6)] == [5, 6, 7, 6]
    row = [0, 10_000, 0, 0, 0, 0, 100, 2000, 0, 0, 0, 0, 0, 0]
    assert EK.slot_end(row, False) == 2000 and EK.slot_end(row, True) == 2000 + 258
    row[EK.P_E] = 9900
    assert EK.slot_end(row, True) == 9997
    row[EK.P_S] = row[EK.P_E] = 9999
    assert EK.slot_end(row, True) == 9999
