"""SP2's block launch (csrc/speculative.cu `run_row`: native's headers,
stored blocks, records and the stream's last bits on the head warp; every
coded body with more than 1,088 bits of the stream left decoded by
sub-ranges of L bits that resynchronise, then a pointer-jumping expansion
into u16 cells with markers) on the CPU: the source built as host C++ by
g++, its T threads run in turn, at L of 8, 64 and 1,024 bits and the
card's own choice (0), T of 1, 7, 32 and 1,024.

Each row is held against SP2's plain version (`spec_decode_plain`, the
yardstick): the status row, cells [0, n) and records [0, nrec). The
routes (`inflate_speculative`, `zran_index`, `skim`, `inflate_raw`, on
device="cpu" with the host build in the plain version's place) are held
against the JAX package's native engine, bytes and errors alike. Every
comparison is exact."""

import ctypes
import os
import shutil
import subprocess
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import native_build  # noqa: F401  (the JAX package's native library, built once under a lock)

from test_torch_istream import _BASH, Bits, canonical, dynamic_block
from zlib_rs_tpu import native as jnative
from zlib_rs_tpu_torch.ops.kernels import speculative_kernel as SK
from zlib_rs_tpu_torch.parallel import speculative as SP

torch.set_num_threads(1)

SRC = Path(__file__).resolve().parents[1] / "zlib_rs_tpu_torch" / "csrc" / "speculative.cu"
GRID = [(8, 1), (8, 7), (64, 7), (64, 32), (1024, 1), (1024, 32), (0, 1024)]  # (L, T)
DATA = _BASH[400_000:464_000]
PLAIN = SK.spec_decode_plain


@pytest.fixture(scope="module")
def dll(tmp_path_factory):
    """csrc/speculative.cu built by g++ (no __CUDACC__)."""
    gxx = shutil.which("g++")
    assert gxx, "g++ builds the reference's native engine and this file's host build"
    lib = tmp_path_factory.mktemp("sp_sync") / "libsp_sync.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-x", "c++", str(SRC), "-o",
                    str(lib)], check=True, capture_output=True, timeout=300)
    d = ctypes.CDLL(str(lib))
    d.zrs_spec_decode_host.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                                       ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5 + \
        [ctypes.c_int] * 2
    for name in ("zrs_spec_scratch_words", "zrs_spec_stats_len"):
        getattr(d, name).restype = ctypes.c_longlong
    assert d.zrs_spec_scratch_words() == SK.SCRATCH
    assert d.zrs_spec_stats_len() == SK.STATS == len(SK.STAT_NAMES)
    return d


class Host:
    """The block launch at (L, T), as a `spec_decode_plain` stand-in;
    `stats` gathers its counters."""

    def __init__(self, dll, L: int = 0, T: int = 1024):
        self.dll, self.L, self.T = dll, L, T
        self.ptrs = np.zeros(SK.SCRATCH, np.int32)
        self.stats = np.zeros(SK.STATS, np.int64)

    def __call__(self, words, nbits, meta, cell_total, rec_total):
        SK._prepare_decode(words, nbits, meta, cell_total, rec_total)
        w = np.ascontiguousarray(words.numpy())
        m = np.ascontiguousarray(meta.numpy())
        cells = np.zeros(max(cell_total, 1), np.uint16)
        recs = np.zeros((max(rec_total, 1), 2), np.int64)
        st = np.zeros((m.shape[0], SK.STATUS), np.int64)
        rc = self.dll.zrs_spec_decode_host(
            w.ctypes.data, w.shape[0], nbits, m.ctypes.data, m.shape[0], cells.ctypes.data,
            recs.ctypes.data, st.ctypes.data, self.ptrs.ctypes.data, self.stats.ctypes.data,
            self.L, self.T)
        assert rc == 0
        return (torch.from_numpy(cells[:cell_total].view(np.int16)),
                torch.from_numpy(recs[:rec_total]), torch.from_numpy(st))

    def stat(self, name: str) -> int:
        return int(self.stats[SK.STAT_NAMES.index(name)])


def raw(data: bytes, level: int = 6, strategy: int = zlib.Z_DEFAULT_STRATEGY, mem: int = 8,
        zdict: bytes | None = None) -> bytes:
    c = zlib.compressobj(level, zlib.DEFLATED, -15, mem, strategy,
                         **({"zdict": zdict} if zdict else {}))
    return c.compress(data) + c.flush()


def meta_of(rows, nbits: int, rec_cap: int | None = None):
    meta, nc, nr = SP.row_meta(rows, nbits)
    if rec_cap is not None:  # every row's list cut to rec_cap records
        meta[:, 6] = np.minimum(meta[:, 6], rec_cap)
    return torch.from_numpy(meta), nc, nr


def same(host, stream: bytes, rows, nbits: int | None = None, rec_cap: int | None = None):
    """`rows` of `stream` (its first `nbits` bits) through the host build
    and the plain version: every status row, each row's cells [0, n) and
    records [0, nrec) equal. Returns the plain status."""
    nbits = 8 * len(stream) if nbits is None else nbits
    words = torch.from_numpy(SK.stream_words(stream))
    meta, nc, nr = meta_of(rows, nbits, rec_cap)
    got, want = host(words, nbits, meta, nc, nr), PLAIN(words, nbits, meta, nc, nr)
    assert torch.equal(got[2], want[2]), (got[2], want[2])
    for k, (n, nrec) in enumerate(want[2][:, [0, 5]].tolist()):
        c0, r0 = int(meta[k, 4]), int(meta[k, 5])
        assert torch.equal(got[0][c0 : c0 + n], want[0][c0 : c0 + n]), k
        assert torch.equal(got[1][r0 : r0 + nrec], want[1][r0 : r0 + nrec]), k
    return want[2]


def segment_rows(stream: bytes, seg: int, max_out: int):
    """The first attempt's rows, as `_speculate` cuts the stream (SP1's
    plain version guesses each segment's start)."""
    N = 8 * len(stream)
    T = max(1, len(stream) // seg)
    bounds = [8 * k * seg for k in range(T)] + [N]
    words = torch.from_numpy(SK.stream_words(stream))
    starts = SK.block_find_plain(words, N, torch.tensor(bounds[1:T], dtype=torch.int64),
                                 torch.tensor(bounds[2:], dtype=torch.int64)).tolist()
    cap = SP.segment_cap(seg, max_out)
    return [(0, bounds[1], cap, 0)] + [(s, bounds[k + 1], cap if s >= 0 else 0, SK.WSIZE)
                                       for k, s in enumerate(starts, 1)]


def block_starts(stream: bytes) -> list:
    """Every block start of a stream, from one exact plain row's records."""
    words = torch.from_numpy(SK.stream_words(stream))
    N = 8 * len(stream)
    meta, nc, nr = meta_of([(0, N + 1, 1 << 24, 0)], N)
    _c, recs, st = PLAIN(words, N, meta, nc, nr)
    assert int(st[0, 3]) == SK.OK
    return recs[: int(st[0, 5]), 0].tolist()


def outcome(fn):
    try:
        return fn()
    except (ValueError, BufferError) as e:
        return type(e), str(e)


# ---------------------------------------------------------------------------
# rows against the plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("L,T", GRID)
@pytest.mark.parametrize("level", [1, 6, 9])
def test_corpus_segments_equal_plain(dll, level, L, T):
    """The segments of a 64,000-byte stream at 4 KiB a segment (guesses,
    markers, no-start rows) and the exact row of the whole stream."""
    stream = raw(DATA, level)
    host = Host(dll, L, T)
    st = same(host, stream, segment_rows(stream, 4096, 4 * len(DATA)))
    assert int((st[:, 3] == SK.OK).sum()) >= 2 and int(st[:, 4].max()) > 0  # guesses, markers
    st = same(host, stream, [(0, 8 * len(stream) + 1, 4 * len(DATA), 0)])
    assert int(st[0, 0]) == len(DATA) and int(st[0, 2]) == 1
    assert host.stat("windows") > 0


def test_exact_rows_with_history_and_their_records(dll):
    """Exact rows from real block starts mid-stream (hist = the output
    before them), to the next start past a stop and through the end; small
    blocks (memLevel 2) give many records."""
    stream = raw(DATA, 6, mem=2)
    starts = block_starts(stream)
    assert len(starts) > 8
    words = torch.from_numpy(SK.stream_words(stream))
    N = 8 * len(stream)
    meta, nc, nr = meta_of([(0, N + 1, 1 << 20, 0)], N)
    _c, recs, _st = PLAIN(words, N, meta, nc, nr)
    before = dict(recs[: len(starts)].tolist())
    host = Host(dll)
    rows = [(starts[i], starts[i + 3] + 1, 1 << 20, before[starts[i]])
            for i in range(1, len(starts) - 4, 2)]
    rows.append((starts[len(starts) // 2], N + 1, 1 << 20, before[starts[len(starts) // 2]]))
    st = same(host, stream, rows)
    assert (st[:, 3] == SK.OK).all() and int(st[:, 5].min()) >= 4
    assert int(st[:, 4].max()) > 0  # references before each row's start: markers


def test_wrong_guesses(dll):
    """Starts that are not block starts (every bit offset of a 160-bit
    range mid-stream, SP1 unasked): data errors, truncations, or a decode
    of garbage, all as the plain version reads them."""
    stream = raw(DATA, 6)
    N = 8 * len(stream)
    mid = N // 2
    rows = [(b, N + 1, 1 << 18, SK.WSIZE) for b in range(mid, mid + 160)]
    st = same(Host(dll), stream, rows)
    assert (st[:, 3] == SK.INVALID).any()


def test_markers_of_dist_1_length_258_across_the_row_start(dll):
    """A block of runs (length 258, distance 1) right at a row's start:
    every cell is a marker of back 1, and a copy of a marker copies it."""
    lits = [0] * 286
    lits[65], lits[256], lits[285] = 1, 2, 2
    first = dynamic_block(lits, [1], [65] * 40 + [256], final=False)
    runs = dynamic_block(lits, [1], [285, ("d", 0)] * 1500 + [65, 256])
    stream = first + runs
    b = 8 * len(first)
    host = Host(dll)
    st = same(host, stream, [(b, 8 * len(stream) + 1, 1 << 20, SK.WSIZE),
                             (0, 8 * len(stream) + 1, 1 << 20, 0)])
    assert int(st[0, 4]) == 1 and int(st[0, 0]) == 258 * 1500 + 1
    assert host.stat("windows") > 0


def test_far_back_reference(dll):
    """A stream that needs a dictionary, decoded exactly from bit 0 with
    none (hist 0): the first reference past n + hist is invalid data, in
    the body's range; as a guess (hist 32 KiB) it decodes with markers."""
    window = _BASH[250_000:300_000][-32768:]
    stream = raw(DATA[:6000], 6, zdict=window)
    N = 8 * len(stream)
    st = same(Host(dll), stream, [(0, N + 1, 1 << 20, 0), (0, N + 1, 1 << 20, SK.WSIZE),
                                  (0, N + 1, 1 << 20, 100)])
    assert st[:, 3].tolist()[:2] == [SK.INVALID, SK.OK] and int(st[1, 4]) > 0


def test_room_overflow_on_a_literal_and_on_a_match(dll):
    """3,000 literals, then 500 matches of 3: a room of 1,000 overflows on
    a literal, one of 3,001 on a match, both inside the body's range."""
    lits = [0] * 258
    lits[65], lits[256], lits[257] = 1, 2, 2
    stream = dynamic_block(lits, [1], [65] * 3000 + [257, ("d", 0)] * 500 + [256])
    N = 8 * len(stream)
    st = same(Host(dll), stream, [(0, N + 1, cap, 0) for cap in (1000, 3001, 3002, 4499, 4500)])
    assert st[:, 3].tolist() == [SK.CAP] * 4 + [SK.OK]
    assert st[:, 0].tolist() == [1000, 3000, 3000, 4497, 4500]


def test_truncation_in_a_symbol_a_header_and_a_stored_block(dll):
    """Exact rows of streams cut at every bit over the last 96 before an
    EOB and into the next block's header, inside a dynamic header, and
    inside a stored block's LEN and payload."""
    host = Host(dll)
    stream = raw(DATA[:20_000], 6, mem=2)
    starts = block_starts(stream)
    s = starts[len(starts) // 2]
    for cut in list(range(s - 96, s + 40)) + list(range(24, 600, 37)):
        st = same(host, stream, [(0, cut + 1, 1 << 20, 0)], nbits=cut)
        assert int(st[0, 3]) == SK.TRUNCATED
    stored = raw(DATA[:3000], 0)
    for cut in (3, 10, 20, 40, 200, 8 * len(stored) - 9):
        st = same(host, stored, [(0, cut + 1, 1 << 20, 0)], nbits=cut)
        assert int(st[0, 3]) == SK.TRUNCATED


def test_a_stop_inside_a_block_and_at_the_next_start(dll):
    """A stop bit inside a block ends the row at the next block's start;
    a stop on a block start ends it there."""
    stream = raw(DATA, 6, mem=2)
    starts = block_starts(stream)
    a, b, c = starts[3], starts[4], starts[5]
    rows = [(a, b - 5, 1 << 20, SK.WSIZE), (a, b, 1 << 20, SK.WSIZE),
            (a, b + 1, 1 << 20, SK.WSIZE), (0, a + 1, 1 << 20, 0)]
    st = same(Host(dll), stream, rows)
    assert st[:, 1].tolist() == [b, b, c, b]


def test_a_lone_code_an_empty_distance_code_and_holes(dll):
    """A litlen code of EOB alone, an empty distance code, one distance
    code, and holes of incomplete codes hit past the body's first window
    start: each an exact row, against the plain version."""
    only_eob = [0] * 256 + [1]
    lits = [0] * 258
    lits[65], lits[256], lits[257] = 1, 2, 2
    cases = {
        "empty": dynamic_block(only_eob, [0], [256]),
        "one_dist": dynamic_block(lits, [1], [65] + [65, 257, ("d", 0)] * 400 + [256]),
        "bad_match": dynamic_block(lits, [0], [65] * 2000 + [257, ("bits", 0, 1)]
                                   + [("bits", 0, 30)] * 10),
        "lit_hole": dynamic_block(only_eob, [0], [("bits", 1, 1)] + [("bits", 0, 30)] * 80),
        "dist_hole": dynamic_block(lits, [1], [65] * 2000 + [257, ("bits", 1, 1)] + [65] * 300
                                   + [256]),
    }
    host = Host(dll)
    whys = {}
    for name, stream in cases.items():
        st = same(host, stream, [(0, 8 * len(stream) + 1, 1 << 20, 0)])
        whys[name] = int(st[0, 3])
    assert whys == {"empty": SK.OK, "one_dist": SK.OK, "bad_match": SK.INVALID,
                    "lit_hole": SK.INVALID, "dist_hole": SK.INVALID}
    # a lone litlen code of 6 bits: a hole with fewer than 6 bits left is
    # a truncation (native's root, the code's length), with 6 invalid data
    # (the header's last code length wants 7 bits: 3 are left at least)
    stream = dynamic_block([0] * 256 + [6], [0], [("bits", 1, 1), ("bits", 0, 30)])
    body = 3 + 14 + 19 * 3 + 4 * (257 + 1)
    got = [int(same(host, stream, [(0, body + k + 1, 1 << 20, 0)], nbits=body + k)[0, 3])
           for k in range(3, 8)]
    assert got == [SK.TRUNCATED] * 3 + [SK.INVALID] * 2


def coded_and_stored() -> bytes:
    """Coded blocks, each followed by a stored one (a sync flush's empty
    block, and random bytes zlib stores)."""
    c = zlib.compressobj(6, zlib.DEFLATED, -15)
    noise = np.random.default_rng(3).integers(0, 256, 20_000, dtype=np.uint8).tobytes()
    out = c.compress(DATA[:20_000]) + c.flush(zlib.Z_SYNC_FLUSH)
    out += c.compress(noise) + c.flush(zlib.Z_SYNC_FLUSH)
    return out + c.compress(DATA[20_000:40_000]) + c.flush()


def dynamic_into(b, lit_lens, dist_lens, symbols, final: int) -> None:
    """dynamic_block's block, written on at bit b.n."""
    b.put(final, 1)
    b.put(2, 2)
    b.put(len(lit_lens) - 257, 5)
    b.put(len(dist_lens) - 1, 5)
    b.put(19 - 4, 4)
    for sym in (16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15):
        b.put(4 if sym < 16 else 0, 3)
    for ln in list(lit_lens) + list(dist_lens):
        b.code(ln, 4)
    lc, dc = canonical(lit_lens), canonical(dist_lens)
    for sym in symbols:
        if isinstance(sym, tuple):
            b.code(dc[sym[1]], dist_lens[sym[1]])
        else:
            b.code(lc[sym], lit_lens[sym])


def stored_into(b, data: bytes, final: int) -> None:
    b.put(final, 1)
    b.put(0, 2)
    b.n = (b.n + 7) // 8 * 8
    b.put(len(data) | (len(data) ^ 0xFFFF) << 16, 32)
    for x in data:
        b.put(x, 8)


def fixed_into(b, lits, final: int) -> None:
    b.put(final, 1)
    b.put(1, 2)
    for x in lits:  # literals under 144: codes 0x30 + x of 8 bits
        b.code(0x30 + x, 8)
    b.code(0, 7)  # EOB


LITS = [0] * 258
LITS[65], LITS[256], LITS[257] = 1, 2, 2  # "A" 1 bit, EOB and (3, d) 2 bits


def test_stored_blocks_right_after_a_coded_body(dll):
    """A coded body whose window ends at its EOB, then stored blocks of
    1,000 bytes (the block copies) and 100 bytes (the head copies)."""
    b = Bits()
    dynamic_into(b, LITS, [1], [65] * 3000 + [257, ("d", 0)] * 200 + [256], 0)
    stored_into(b, DATA[:1000], 0)
    stored_into(b, DATA[1000:1100], 0)
    dynamic_into(b, LITS, [1], [65] * 2000 + [256], 1)
    stream = b.bytes()
    for L, T in ((64, 32), (0, 1024)):
        host = Host(dll, L, T)
        st = same(host, stream, [(0, 8 * len(stream) + 1, 1 << 20, 0)])
        assert int(st[0, 0]) == 3600 + 1100 + 2000 and int(st[0, 5]) == 4
        assert host.stat("block_copies") == 1


def test_a_window_past_the_scratch(dll):
    """1,100 runs (258, distance 1) at 2 bits each: the window that holds
    the block's EOB passes SCRATCH cells and ends before it, and the head
    decodes the block's last runs (under 1,088 bits of the stream left)
    and the fixed block after them."""
    lits = [0] * 286
    lits[65], lits[256], lits[285] = 2, 2, 1
    b = Bits()
    dynamic_into(b, lits, [1], [285, ("d", 0)] * 1100 + [256], 0)
    fixed_into(b, [66] * 10, 1)
    stream = b.bytes()
    host = Host(dll)
    st = same(host, stream, [(0, 8 * len(stream) + 1, 1 << 20, SK.WSIZE)])
    assert int(st[0, 0]) == 258 * 1100 + 10 and int(st[0, 3]) == SK.OK
    assert host.stat("windows") == 1 and host.stat("body_out") < 258 * 1100


@pytest.mark.parametrize("L,T", [(64, 32), (0, 1024)])
def test_fixed_and_stored_blocks(dll, L, T):
    host = Host(dll, L, T)
    for stream in (raw(DATA, 6, zlib.Z_FIXED), raw(DATA, 0), raw(DATA[:9000], 1) + bytes(3),
                   coded_and_stored()):
        same(host, stream, segment_rows(stream, 4096, 4 * len(DATA)))
        same(host, stream, [(0, 8 * len(stream) + 1, 4 * len(DATA), 0)])
    assert host.stat("block_copies") > 0


def test_a_record_list_that_overflows(dll):
    stream = raw(DATA, 6, mem=2)
    N = 8 * len(stream)
    for rec_cap in (0, 1, 3):
        st = same(Host(dll), stream, [(0, N + 1, 1 << 20, 0), (block_starts(stream)[2], N + 1,
                                                               1 << 20, SK.WSIZE)], rec_cap=rec_cap)
        assert st[:, 6].tolist() == [1, 1] and st[:, 5].tolist() == [rec_cap] * 2


def test_a_stream_that_stays_out_of_step(dll):
    """Literals of 8-bit codes and one literal repeated: the rounds run out
    and thread 0 finishes the window alone; the cells stay the plain
    version's."""
    lits = [8] * 255 + [9, 9]
    stream = dynamic_block(lits, [1], [0] * 20_000 + [256])
    host = Host(dll)
    same(host, stream, [(0, 8 * len(stream) + 1, 1 << 20, 0)])
    assert host.stat("max_sync_rounds") == 32 and host.stat("serial_finishes") >= 1


def test_a_changed_header_makes_its_includers_stale(tmp_path, monkeypatch):
    """speculative.cu and istream.cu include csrc/sync_body.cuh: a library
    is rebuilt when a header its source includes is newer than it."""
    from zlib_rs_tpu_torch import _device

    assert _device._sources_of("speculative")[1:] == [_device.CSRC / "sync_body.cuh"]
    assert _device._sources_of("istream")[1:] == [_device.CSRC / "sync_body.cuh"]
    src, build = tmp_path / "csrc", tmp_path / "build"
    src.mkdir()
    build.mkdir()
    (src / "a.cu").write_text('#include <cstdint>\n#include "h.cuh"\n')
    (src / "h.cuh").write_text("// a header\n")
    (src / "b.cu").write_text("// no header\n")
    monkeypatch.setattr(_device, "CSRC", src)
    monkeypatch.setattr(_device, "BUILD", build)
    for name in ("a", "b"):
        _device.lib_path(name).write_bytes(b"")
    os.utime(src / "a.cu", (1000, 1000))
    os.utime(src / "b.cu", (1000, 1000))
    os.utime(src / "h.cuh", (1000, 1000))
    assert not _device._stale("a") and not _device._stale("b")
    os.utime(src / "h.cuh", (2 ** 40, 2 ** 40))
    assert _device._stale("a") and not _device._stale("b")


# ---------------------------------------------------------------------------
# the routes against the JAX package's native engine
# ---------------------------------------------------------------------------


ROUTE_STREAMS = {
    "raw1": lambda: raw(DATA, 1), "raw6": lambda: raw(DATA, 6), "raw9": lambda: raw(DATA, 9),
    "fixed": lambda: raw(DATA, 6, zlib.Z_FIXED), "stored": lambda: raw(DATA[:20_000], 0),
}


@pytest.mark.parametrize("name", sorted(ROUTE_STREAMS))
def test_routes_through_the_host_build_equal_native(dll, name, monkeypatch):
    stream = ROUTE_STREAMS[name]()
    n = len(DATA if name != "stored" else DATA[:20_000])
    monkeypatch.setattr(SK, "spec_decode_plain", Host(dll))
    monkeypatch.setattr(SP, "SEGMENT_BYTES", 4096)
    tail = bytes(8)
    got = SP.inflate_speculative(stream, 4 * n, device="cpu")
    assert got[0] == (DATA if name != "stored" else DATA[:20_000])
    assert SP.skim(stream + tail, 4 * n, device="cpu") == (n, len(stream))
    assert SP.inflate_raw(stream, 4 * n, device="cpu") == got
    full, points, used = SP.zran_index(stream, 8192, 4 * n, device="cpu")
    if jnative.available():
        assert got == jnative.inflate_speculative(stream, 4 * n)
        assert got == jnative.inflate_raw(stream, 4 * n)
        assert (full, points, used) == jnative.zran_index(stream, 8192, 4 * n)


def crafted_streams() -> dict:
    """The crafted rows' streams, whole: (stream, max_out)."""
    only_eob = [0] * 256 + [1]
    lits = [0] * 286
    lits[65], lits[256], lits[285] = 1, 2, 2
    window = _BASH[250_000:300_000][-32768:]
    b = Bits()
    dynamic_into(b, LITS, [1], [65] * 3000 + [257, ("d", 0)] * 200 + [256], 0)
    stored_into(b, DATA[:1000], 0)
    dynamic_into(b, LITS, [1], [65] * 2000 + [256], 1)
    return {
        "empty": (dynamic_block(only_eob, [0], [256]), 1 << 20),
        "one_dist": (dynamic_block(LITS, [1], [65] + [65, 257, ("d", 0)] * 400 + [256]), 1 << 20),
        "bad_match": (dynamic_block(LITS, [0], [65] * 2000 + [257, ("bits", 0, 1)]
                                    + [("bits", 0, 30)] * 10), 1 << 20),
        "lit_hole": (dynamic_block(only_eob, [0], [("bits", 1, 1)] + [("bits", 0, 30)] * 80),
                     1 << 20),
        "hole_cut": (dynamic_block([0] * 256 + [6], [0], [("bits", 1, 1)])[:-1], 1 << 20),
        "runs_at_start": (dynamic_block(lits, [1], [285, ("d", 0)] * 1500 + [256]), 1 << 20),
        "far": (raw(DATA[:6000], 6, zdict=window), 1 << 20),
        "room_literal": (dynamic_block(LITS, [1], [65] * 3000 + [257, ("d", 0)] * 500 + [256]),
                         1000),
        "room_match": (dynamic_block(LITS, [1], [65] * 3000 + [257, ("d", 0)] * 500 + [256]),
                       3001),
        "coded_then_stored": (b.bytes(), 1 << 20),
        "stored_cut": (raw(DATA[:3000], 0)[:2000], 1 << 20),
    }


@pytest.mark.parametrize("name", sorted(crafted_streams()))
def test_crafted_streams_through_the_routes_equal_native(dll, name, monkeypatch):
    """Each crafted stream through inflate_raw and inflate_speculative on
    the host build: native's bytes, or its exception and message."""
    monkeypatch.setattr(SK, "spec_decode_plain", Host(dll))
    monkeypatch.setattr(SP, "SEGMENT_BYTES", 1024)
    stream, max_out = crafted_streams()[name]
    for mine, theirs in ((SP.inflate_raw, jnative.inflate_raw),
                         (SP.inflate_speculative, jnative.inflate_speculative)):
        got = outcome(lambda: mine(stream, max_out, device="cpu"))
        if jnative.available():
            assert got == outcome(lambda: theirs(stream, max_out)), (name, mine.__name__)


def test_route_errors_equal_native(dll, monkeypatch):
    """Flipped bytes, truncations, a stream that needs a dictionary and
    too small a budget: the same exception and message as native's, by
    inflate_speculative and inflate_raw through the host build."""
    monkeypatch.setattr(SK, "spec_decode_plain", Host(dll))
    monkeypatch.setattr(SP, "SEGMENT_BYTES", 4096)
    stream = raw(DATA, 6)
    cases = [stream[:k] + bytes([stream[k] ^ 0x44]) + stream[k + 1 :]
             for k in (len(stream) // 3, len(stream) // 2, 2 * len(stream) // 3)]
    cases += [stream[: len(stream) * 3 // 5], stream[:-1],
              raw(DATA[:6000], 6, zdict=_BASH[250_000:282_768])]
    seen = set()
    for s in cases:
        for mine, theirs in ((SP.inflate_speculative, jnative.inflate_speculative),
                             (SP.inflate_raw, jnative.inflate_raw)):
            got = outcome(lambda: mine(s, 4 * len(DATA), device="cpu"))
            seen.add(got[0] if isinstance(got[0], type) else "bytes")
            if jnative.available():
                assert got == outcome(lambda: theirs(s, 4 * len(DATA)))
    assert ValueError in seen
    for mine, theirs in ((SP.inflate_speculative, jnative.inflate_speculative),
                         (SP.inflate_raw, jnative.inflate_raw)):
        got = outcome(lambda: mine(stream, len(DATA) // 2, device="cpu"))
        assert got[0] is BufferError
        if jnative.available():
            assert got == outcome(lambda: theirs(stream, len(DATA) // 2))
