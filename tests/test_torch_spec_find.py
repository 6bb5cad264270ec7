"""SP1's and SP3's second designs (csrc/speculative.cu) on the CPU: the
source built as host C++ by g++, where one thread runs each SP1 tile and
segment in turn and each SP3 cell in turn (so a block's scan, its group
pick and its shared cut-off run with one thread: chip_smoke.py phase 40
holds them on the card), behind the CUDA wrappers themselves (`block_find_cuda`, `spec_resolve_cuda`, their
C entries swapped for the host entries `zrs_block_find_host` and
`zrs_spec_resolve_host`), so the ranges, the tiles, the rooms and their
rerun are the card's.

SP1 (a tile's pre-filter, a word of 32 offsets a thread, the survivors in
offset order; a block a segment checking them in groups up to the first
pass, the code lengths through a table of the code-length code) is held
against `block_find_plain` on a stream of stored, dynamic and fixed
blocks, on stored and Z_FIXED streams, on ranges that start one bit past
a block start (a retry round's), on odd ranges, with a room too small for
the survivors (the rerun), and offset by offset against `_validate`.

SP3 (a chase a cell over a copy of the cells for a hop budget, a
resolved marker's byte written back where seg_ofs starts at 0, so that
later chains end there; a second launch over the chains left pending) is
held against the serial stitch and `spec_resolve_plain` on crafted
segments, a chain through 240 segments (past the budget), a
self-referencing marker at cell 0 (unresolved, the marker's low byte),
odd seg_ofs (a first offset past 0, where nothing is written back and
chains may loop) and random cells, at budgets of 0, 1, 2 and HOP_BUDGET
with the first launch's cells in either order, so that chains end in the
first launch, in the second and on a byte written back. Every comparison is exact."""

import ctypes
import re
import shutil
import subprocess
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_speculative import (_BASH, _mix, _raw, _resolve_serial, _stored_blocks,
                                    _wrapped)
from zlib_rs_tpu_torch import _device
from zlib_rs_tpu_torch.ops.kernels import speculative_kernel as SK

torch.set_num_threads(1)

SRC = Path(__file__).resolve().parents[1] / "zlib_rs_tpu_torch" / "csrc" / "speculative.cu"
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@pytest.fixture(scope="module")
def dll(tmp_path_factory):
    """csrc/speculative.cu built by g++ (no __CUDACC__)."""
    gxx = shutil.which("g++")
    assert gxx, "g++ builds this file's host build"
    lib = tmp_path_factory.mktemp("sp_find") / "libsp_find.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-x", "c++", str(SRC), "-o",
                    str(lib)], check=True, capture_output=True, timeout=300)
    d = ctypes.CDLL(str(lib))
    d.zrs_block_find_host.argtypes = [_P, _I, _L, _P, _I, _I, _P, _I, _P, _P, _P]
    d.zrs_spec_resolve_host.argtypes = [_P, _I, _P, _I, _L, _I, _P, _P, _P, _I]
    return d


class _Entry:
    """A host entry behind a CUDA entry's name: the same arguments, the
    stream's place taken by `extra`."""

    def __init__(self, fn, *extra):
        self.fn, self.extra, self.argtypes, self.restype = fn, extra, None, None

    def __call__(self, *args):
        assert len(args) == len(self.argtypes)
        return self.fn(*args[:-1], *self.extra)


@pytest.fixture
def host(dll, monkeypatch):
    """The CUDA wrappers over CPU tensors with the host build's entries."""
    lib = type("Lib", (), {})()
    lib.zrs_block_find = _Entry(dll.zrs_block_find_host)
    lib.zrs_spec_resolve = _Entry(dll.zrs_spec_resolve_host, 1)  # from the last cell
    monkeypatch.setattr(_device, "library", lambda name: lib)
    monkeypatch.setattr(_device, "require_cuda", lambda *a: None)
    monkeypatch.setattr(_device, "stream_of", lambda t: 0)
    monkeypatch.setattr(SK, "launches", dict.fromkeys(SK.launches, 0))
    return dll


def test_constants_match_the_source():
    text = SRC.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+)", text).group(1))

    assert const("kTileWords") == SK.TILE_WORDS and const("kHopBudget") == SK.HOP_BUDGET
    assert const("kResolveStats") == len(SK.RESOLVE_STATS) and len(SK.FIND_STATS) == 2


# ---------------------------------------------------------------------------
# SP1
# ---------------------------------------------------------------------------


def _mixed() -> bytes:
    """test_sp1_model_equals_plain's stream: stored blocks, a dynamic
    stream cut short, a fixed one."""
    return (_stored_blocks(_mix(6000, 8), 2000, final=False)
            + _wrapped("raw", _BASH[5000:25_000], 6)[:-200] + _raw(_mix(3000, 9), 6, zlib.Z_FIXED))


def _segments(raw: bytes, step_bytes: int):
    N = 8 * len(raw)
    lo = list(range(0, N, 8 * step_bytes))
    return lo, [min(x + 8 * step_bytes, N) for x in lo]


def _find(raw: bytes, lo, hi):
    """SP1's host build and its plain version on one stream's ranges:
    (found, plain, stats)."""
    words = torch.from_numpy(SK.stream_words(raw))
    N = 8 * len(raw)
    stats = {}
    got = SK.block_find_cuda(words, N, lo, hi, stats=stats)
    want = SK.block_find_plain(words, N, lo, hi)
    assert got.dtype == torch.int64 and got.device.type == "cpu"
    return got.tolist(), want.tolist(), stats


def _survivors(raw: bytes, lo, hi) -> int:
    words = torch.from_numpy(SK.stream_words(raw))
    N = 8 * len(raw)
    total = 0
    for a, z in zip(lo, hi):
        offs = torch.arange(max(a, 0), min(z, N), dtype=torch.int64)
        total += int(SK.prefilter_plain(words, N, offs).sum()) if offs.numel() else 0
    return total


def test_sp1_mixed_stream_equals_plain(host):
    """The stored, dynamic and fixed stream at segments of 2,000 and
    7,000 bytes: every segment's first pass equal; the survivors counted
    are prefilter_plain's exactly, and the check stopped short of them."""
    raw = _mixed()
    for step in (2000, 7000):
        lo, hi = _segments(raw, step)
        got, want, stats = _find(raw, lo, hi)
        assert got == want and sum(v >= 0 for v in want) >= 3
        assert stats["survivors"] == _survivors(raw, lo, hi) > 0
        assert 0 < stats["checked"] < stats["survivors"]
    assert SK.launches["block_find"] == 2


@pytest.mark.parametrize("kind", ["stored", "fixed", "bash1", "bash9"])
def test_sp1_other_streams_equal_plain(host, kind):
    """Stored blocks (false anchors in their bytes), Z_FIXED (no anchor:
    every segment -1, every survivor checked) and levels 1 and 9."""
    data = _BASH[200_000:330_000]
    raw = {"stored": _raw(data, 0), "fixed": _raw(data, 6, zlib.Z_FIXED),
           "bash1": _raw(data, 1), "bash9": _raw(data, 9)}[kind]
    lo, hi = _segments(raw, 4096)
    got, want, stats = _find(raw, lo, hi)
    assert got == want
    assert stats["survivors"] == _survivors(raw, lo, hi)
    if kind == "fixed":
        assert set(want[1:]) == {-1} and stats["checked"] == stats["survivors"]
    elif kind != "stored":
        assert sum(v >= 0 for v in want) >= 3


def test_sp1_retry_ranges_start_past_a_block_start(host):
    """A retry round's ranges: one bit past each block start of a dynamic
    stream, to the segment's end, and ranges that start on a word edge,
    one bit before one, mid-word and at the stream's last bits."""
    raw = _wrapped("raw", _mix(96 * 1024, 3), 6)
    N = 8 * len(raw)
    from test_torch_speculative import _host_block_starts

    starts = _host_block_starts(raw)
    assert len(starts) >= 4
    lo = [s + 1 for s in starts] + [0, 31, 32, 33, 8191, 8192, N - 40, N - 3, N - 2, N]
    hi = [min(s + 60_000, N) for s in starts] + [N, 9000, 8300, 70_000, 20_000, N, N, N, N, N + 5]
    got, want, _stats = _find(raw, lo, hi)
    assert got == want and sum(v >= 0 for v in want[: len(starts)]) >= 2


def test_sp1_odd_ranges(host):
    """Empty and reversed ranges, a range before bit 0, one past the
    stream and one over a whole stream of many tiles."""
    raw = _wrapped("raw", _BASH[50_000:150_000], 6)
    N = 8 * len(raw)
    lo = [100, 5000, -700, N - 10, 0, 12_345]
    hi = [100, 4000, 900, N + 100, N, 12_346]
    got, want, _stats = _find(raw, lo, hi)
    assert got == want and want[4] >= 0
    assert SK.block_find_cuda(torch.from_numpy(SK.stream_words(raw)), N, [], []).shape == (0,)


def test_sp1_room_too_small_reruns_exactly(host, monkeypatch):
    """Rooms of 0, 1 and 3 survivors a tile (SURVIVOR_SHARE raised): the
    first launch flags the segments whose tiles overflowed, the second
    runs with room for every offset and gives the plain version's
    offsets."""
    raw = _mixed()
    lo, hi = _segments(raw, 3000)
    share = SK.SURVIVOR_SHARE
    for room in (0, 1, 3):
        monkeypatch.setattr(SK, "SURVIVOR_SHARE", SK.TILE_BITS // room if room else
                            SK.TILE_BITS + 1)
        assert SK.TILE_BITS // SK.SURVIVOR_SHARE == room
        SK.launches["block_find"] = 0
        got, want, stats = _find(raw, lo, hi)
        assert got == want
        assert SK.launches["block_find"] == 2 and stats["room"] == SK.TILE_BITS
    monkeypatch.setattr(SK, "SURVIVOR_SHARE", share)
    SK.launches["block_find"] = 0
    _got, _want, stats = _find(raw, lo, hi)
    assert SK.launches["block_find"] == 1 and stats["room"] == SK.TILE_BITS // SK.SURVIVOR_SHARE


@pytest.mark.parametrize("src", ["bash6", "random"])
def test_sp1_every_survivor_checks_as_validate(host, src):
    """A range of one offset at each pre-filter survivor (and its
    neighbour): the check's verdict is `_validate`'s, survivor by survivor,
    through dynamic headers that fail at every step (16 first, a repeat
    past the end, truncation, both Kraft sums, a missing end-of-block)."""
    if src == "bash6":
        raw = _wrapped("raw", _BASH[300_000:560_000], 6)
    else:
        raw = np.random.default_rng(5).integers(0, 256, 100_000, dtype=np.uint8).tobytes()
    words = torch.from_numpy(SK.stream_words(raw))
    N = 8 * len(raw)
    offs = torch.arange(0, N, dtype=torch.int64)
    surv = offs[SK.prefilter_plain(words, N, offs)].tolist()
    assert len(surv) > 500
    lo = surv + [b + 1 for b in surv[:200]]
    hi = [b + 1 for b in lo]
    got, want, stats = _find(raw, lo, hi)
    buf = bytes(raw) + bytes(8)
    assert got == want
    assert got[: len(surv)] == [b if SK._validate(buf, N, b) else -1 for b in surv]
    assert stats["checked"] == stats["survivors"] >= len(surv)


_CL = [4] * 13 + [5] * 6  # a complete code-length code over all 19 symbols


def _header(seq, hlit=257, hdist=1, cl=_CL) -> bytes:
    """A dynamic block header at bit 0: the code-length code `cl` (lengths
    by symbol), then `seq` as (code-length symbol, its extra bits)."""
    from test_torch_istream import Bits, canonical

    b = Bits()
    b.put(0, 1)
    b.put(2, 2)
    b.put(hlit - 257, 5)
    b.put(hdist - 1, 5)
    ncode = max(4, max((i + 1 for i, s in enumerate(SK.CL_ORDER) if cl[s]), default=4))
    b.put(ncode - 4, 4)
    for i in range(ncode):
        b.put(cl[SK.CL_ORDER[i]], 3)
    codes = canonical(cl)
    for sym, x in seq:
        b.code(codes[sym], cl[sym])
        b.put(x, {16: 2, 17: 3, 18: 7}.get(sym, 0))
    return b.bytes() + bytes(8)


def _zeros(k):  # k zero lengths by repeats (17: 3-10, 18: 11-138)
    out = []
    while k:
        r = min(k, 138)
        if r < 11 and k > 10:
            r = k - 11 if k - 11 >= 3 else r
        out.append((18, r - 11) if r >= 11 else (17, r - 3))
        k -= r
    return out


def _lens(lit: dict, dist: dict, hlit=257, hdist=1):
    """The code lengths of `lit` and `dist` (symbol: length, others 0) as
    one code-length sequence: lengths as symbols 0-15, zero runs as 17/18."""
    seq, run = [], 0
    for ln in [lit.get(i, 0) for i in range(hlit)] + [dist.get(i, 0) for i in range(hdist)]:
        if ln == 0:
            run += 1
            continue
        seq += _zeros(run) + [(ln, 0)]
        run = 0
    return seq + _zeros(run)


def test_sp1_dynamic_verdicts_cover_every_refusal(host):
    """Crafted dynamic headers at bit 0, each passed or refused for one
    reason, against `_validate` and the plain version, whole and cut
    short at every bit: a valid header; a lone litlen code (EOB) and no
    distance code (both pass); a first repeat (16); a repeat past the
    lengths; an over-subscribed and an incomplete litlen code; no
    end-of-block; an over-subscribed and an incomplete distance code; an
    incomplete code-length code; HLIT 287."""
    ok = _lens({65: 1, 256: 1}, {0: 1})
    cases = {
        "valid": _header(ok),
        "lone eob, no distance": _header(_lens({256: 1}, {}, hdist=3), hdist=3),
        "first 16": _header([(16, 0), (18, 62 - 11)] + ok[1:]),  # else valid: 3 + 62 zeros
        "repeat past the end": _header(ok[:-1] + [(18, 40)]),
        "litlen over": _header(_lens({65: 1, 66: 1, 256: 1}, {0: 1})),
        "litlen incomplete": _header(_lens({65: 1, 256: 2}, {0: 1})),
        "no eob": _header(_lens({65: 1, 66: 1}, {0: 1})),
        "distance over": _header(_lens({65: 1, 256: 1}, {0: 1, 1: 1, 2: 1}, hdist=3), hdist=3),
        "distance incomplete": _header(_lens({65: 1, 256: 1}, {0: 1, 1: 2}, hdist=2), hdist=2),
        "cl incomplete": _header(ok, cl=[4] * 12 + [5] * 7),
        "hlit 287": _header(_lens({65: 1, 256: 1}, {0: 1}, hlit=287), hlit=287),
    }
    verdicts = {}
    for name, raw in cases.items():
        words = torch.from_numpy(SK.stream_words(raw))
        buf = bytes(raw) + bytes(8)
        full = 8 * len(raw) - 64
        for cut in range(3, full + 1):
            got = SK.block_find_cuda(words, cut, [0], [1]).tolist()
            want = [0 if SK._validate(buf, cut, 0) else -1]
            assert got == want == SK.block_find_plain(words, cut, [0], [1]).tolist(), (name, cut)
        verdicts[name] = got[0] == 0
    assert verdicts == {n: n in ("valid", "lone eob, no distance") for n in cases}


# ---------------------------------------------------------------------------
# SP3
# ---------------------------------------------------------------------------


def _cells(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.int64).astype(np.uint16).view(np.int16))


def _resolve(dll, cells: torch.Tensor, seg_ofs, budget: int, descending: bool):
    """SP3's host entry at a hop budget, its first launch's cells from the
    first or from the last (where no chain meets a resolved cell): (bytes,
    flag, stats)."""
    n = cells.shape[0]
    so = np.ascontiguousarray(np.asarray(seg_ofs, np.int64))
    work = np.ascontiguousarray(cells.numpy().view(np.uint16)).copy()
    out = np.zeros(max(n, 1), np.uint8)
    ctl = np.zeros(2, np.int32)
    st = np.zeros(len(SK.RESOLVE_STATS), np.int64)
    assert dll.zrs_spec_resolve_host(work.ctypes.data, n, so.ctypes.data, len(so) - 1,
                                     1 << SK.resolve_rounds(len(so) - 1), budget,
                                     out.ctypes.data, ctl.ctypes.data, st.ctypes.data,
                                     int(descending)) == 0
    if so[0] <= 0:  # every marker's byte written back
        assert (work[:n] < 256).all()
    return torch.from_numpy(out[:n]), bool(ctl[0]), dict(zip(SK.RESOLVE_STATS, st.tolist()))


# (hop budget, first launch from the last cell): budget 0 leaves every
# chain to the second launch; from the last cell no chain meets a
# resolved one
BUDGETS = [(0, True), (1, True), (2, False), (SK.HOP_BUDGET, True), (SK.HOP_BUDGET, False)]


def _same(dll, cells, seg_ofs):
    """The host build at each budget and order, and the wrapper, against
    the plain version: bytes and flag. Returns the plain result and the
    stats of each run; the wrapper leaves its cells as they were."""
    so_t = torch.tensor(seg_ofs, dtype=torch.int64)
    want, wflag = SK.spec_resolve_plain(cells, so_t)
    runs = []
    for budget, desc in BUDGETS:
        got, flag, st = _resolve(dll, cells, seg_ofs, budget, desc)
        assert torch.equal(got, want) and flag == wflag, (budget, desc)
        runs.append(st)
    before = cells.clone()
    got, flag = SK.spec_resolve_cuda(cells, so_t)
    assert torch.equal(got, want) and flag == wflag and torch.equal(cells, before)
    return want, wflag, runs


def _crafted():
    """test_sp3_pointer_jumping's segments: sizes with empty and tiny
    ones, 60% markers reaching up to 32 KiB back, each segment's first
    cell copying the previous segment's."""
    rng = np.random.default_rng(4)
    sizes = [900, 40, 1300, 7, 0, 2600, 300, 5000, 64, 1000, 777, 5]
    ofs = [int(x) for x in np.cumsum([0] + sizes[:-1])]
    cells = np.zeros(sum(sizes), np.int64)
    for k, (o, n) in enumerate(zip(ofs, sizes)):
        row = rng.integers(0, 256, n)
        if k:
            for j in range(n):
                if rng.random() < 0.6:
                    row[j] = 256 + int(rng.integers(1, min(o, 32768) + 1)) - 1
            if n:
                row[0] = 256 + (o - ofs[k - 1]) - 1 if sizes[k - 1] else row[0]
        cells[o : o + n] = row
    return cells, ofs


def test_sp3_crafted_segments_equal_serial_and_plain(host):
    cells, ofs = _crafted()
    want_serial = _resolve_serial(cells, ofs)
    want, flag, runs = _same(host, _cells(cells), ofs + [len(cells)])
    assert not flag and (want.numpy().astype(np.int64) == want_serial).all()
    markers = int((cells >= 256).sum())
    assert all(r["markers"] == markers for r in runs)
    # budget 0: every chain pending, then each ended by its first target,
    # resolved before it in the second launch
    assert runs[0]["pending"] == markers and runs[0]["max_hops"] == 1
    # budget 1 from the last cell: the chains of more than one hop pending
    assert 0 < runs[1]["pending"] < markers
    # from the first cell every chain ends at its first target
    assert runs[2]["pending"] == 0 and runs[2]["hops"] == markers
    assert runs[3]["pending"] == 0 and runs[3]["max_hops"] > 2


def test_sp3_chain_through_every_segment(host):
    """240 segments of 5 cells, cell 0 a literal: every other cell points
    at the first cell of the segment before, so the last chain takes 239
    hops, and ends at the same byte."""
    E = 240
    cells = np.full(5 * E, 256 + 5 - 1, np.int64)
    cells[0] = 200
    cells[1:5] = [1, 2, 3, 4]
    ofs = [5 * k for k in range(E)] + [5 * E]
    want, flag, runs = _same(host, _cells(cells), ofs)
    assert not flag and (want.numpy()[5:] == 200).all()
    assert (want.numpy().astype(np.int64) == _resolve_serial(cells, ofs[:-1])).all()
    # from the last cell: the chains of segments past the budget pending,
    # each ended in the second launch by the segment before, resolved first
    for r, budget in ((runs[0], 0), (runs[1], 1), (runs[3], SK.HOP_BUDGET)):
        assert r["pending"] == 5 * (E - 1 - budget)
        assert r["max_hops"] == max(budget, 1)
    # from the first cell: every chain ended by its first target
    assert runs[2]["pending"] == 0 and runs[2]["hops"] == 5 * (E - 1)
    assert SK.resolve_rounds(E) == 8
    # the memo off (seg_ofs past 0 by one empty cell ahead): every chain
    # followed hop by hop, the longest 239 hops
    cells1 = np.concatenate([[200], cells])
    _want, _flag, runs = _same(host, _cells(cells1), [1] + [o + 1 for o in ofs])
    # nothing written back, nothing pending: every hop followed
    assert all(r["max_hops"] == E - 1 and r["pending"] == 0 for r in runs)


def test_sp3_self_referencing_marker_at_cell_zero(host):
    """A marker at cell 0 clamps onto itself: its chain never ends, every
    chain through it is unresolved and gives the marker's low byte (the
    plain version's `c & 0xFF`), and the flag is set. A marker whose
    target clamps to a literal at cell 0 resolves to it."""
    E = 3
    cells = np.array([256 + 0x41, 66, 256 + 2, 67, 256 + 3, 256 + 4, 68], np.int64)
    ofs = [0, 2, 4, len(cells)]
    want, flag, _runs = _same(host, _cells(cells), ofs)
    assert flag
    got = want.numpy()
    assert got[0] == 0x41 and got[2] == 0x41  # 2 -> 0, a marker's low byte
    assert got[4] == 0x41 and got[5] == 0x41 and got[6] == 68
    cells[0] = 90
    want, flag, _runs = _same(host, _cells(cells), ofs)
    assert not flag and want.numpy().tolist() == [90, 66, 90, 67, 90, 90, 68]
    assert E == len(ofs) - 1


def test_sp3_first_offset_past_zero_turns_the_memo_off(host):
    """seg_ofs starting past 0: the cells before it take segment 0 (the
    plain version's clamp), their markers point back into the same cells
    and may loop; chains end where 2^rounds hops of pointer jumping would
    leave them."""
    rng = np.random.default_rng(11)
    for trial in range(12):
        n = int(rng.integers(20, 400))
        start = int(rng.integers(1, n // 2))
        cuts = sorted(int(x) for x in rng.integers(start, n + 1, int(rng.integers(1, 6))))
        ofs = [start] + cuts
        cells = np.where(rng.random(n) < 0.7, 256 + rng.integers(0, 40, n), rng.integers(0, 256, n))
        _same(host, _cells(cells), ofs)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_sp3_random_cells_equal_plain(host, seed):
    """Random non-decreasing seg_ofs from 0 (empty segments among them),
    cells with 80% markers reaching up to 40,000 back (some clamp to cell
    0), with and without a marker at cell 0."""
    rng = np.random.default_rng(seed)
    n = 30_000
    cuts = sorted(int(x) for x in rng.integers(0, n + 1, 60))
    ofs = [0] + cuts + [n]
    cells = np.where(rng.random(n) < 0.8, 256 + rng.integers(0, 40_000, n) % 32768,
                     rng.integers(0, 256, n))
    cells[0] = 65 if seed != 3 else 300
    _want, flag, runs = _same(host, _cells(cells), ofs)
    assert flag == (seed == 3)
    assert runs[-1]["markers"] == int((cells >= 256).sum())


def test_sp3_empty_and_all_literals(host):
    got, flag = SK.spec_resolve_cuda(_cells([]), torch.tensor([0, 0]))
    assert got.shape == (0,) and not flag
    lits = np.arange(300) % 256
    got, flag, runs = _same(host, _cells(lits), [0, 100, 300])
    assert torch.equal(got, torch.from_numpy(lits.astype(np.uint8))) and not flag
    assert runs[-1]["markers"] == 0
