"""SP1-SP3: the speculative decode of one raw-deflate stream with no index
(csrc/speculative.cu), with their plain versions and the wrapper logic.

The port of the decode half of the reference's native engine
(zlib_rs_tpu/native.py `inflate_speculative` and `zran_index`, C++ in
native/zrs_native.cpp): it replaces no `pallas_call` site. The stream is
cut into segments of input; each segment looks for a validated block
header (SP1), decodes from there into u16 cells in which a reference
into the unknown 32 KiB before the segment is a marker (SP2), and once
the host has checked that the segments chain, every marker is resolved
against the real output (SP3).

- SP1 `block_find` (native `validate_header_at`/`find_candidate`, depth
  6): for each segment [lo, hi) of bit offsets, the first offset whose
  block-header chain passes the native checks, or -1. BFINAL may be either
  value; type 3 fails; a static block cannot anchor, and as a follower it
  is sanity-decoded up to 192 symbols; a stored link needs LEN ^ NLEN ==
  0xffff and LEN != 0, and two stored links pass; a dynamic header passes
  when the native `parse_dynamic_tables` would accept it. On the card a
  block pre-filters a tile of 8,192 offsets (a word of 32 a thread, the
  tile's survivors kept in offset order), then a block a segment checks
  its survivors 256 at a time up to the first group in which one passes;
  `block_find_thread_cuda`, the first design (a thread an offset, then a
  thread a survivor), is kept to be timed against it.
- SP2 `spec_decode` (native `spec_decode` with `inflate_raw_impl`'s error
  codes and its stop and point hooks): each segment decodes from its start
  bit to the first block start at or after its stop bit, or through the
  BFINAL block. Cell 0-255 is a byte; 256 + back - 1 a reference `back`
  bytes (1 to 32,768) before the segment's start. `hist` is the history a
  reference may reach (32,768 for a guess, the bytes decoded so far for an
  exact decode from a known block start): a reference past it is invalid
  data. Status a segment: n, end_bit, final_seen, why (0 ok, -1 invalid,
  -2 past the cell cap, -3 truncated, -4 no start), the deepest reference
  before the start, and every block start as (bit, cell offset), into a
  list with a capacity and an overflow flag. On the card a row is a thread
  block of 1,024 (native's headers and the stream's last bits on one
  warp, each coded body decoded by the whole block over IS's
  resynchronising body, csrc/sync_body.cuh); `spec_decode_warp_cuda`, the
  one-warp launch it replaced, is kept to be timed against it.
- SP3 `spec_resolve` (the native stitch): the cells of the chained
  segments, in order, and each segment's output offset. A marker in the
  segment at `ofs` points at absolute byte `ofs - back`, which may itself
  be a marker of an earlier segment; pointer jumping over every cell in
  log2(segments) rounds resolves all at once, then the cells narrow to
  bytes. On the card a thread follows a cell's chain instead (a hop
  lands in an earlier segment; most chains are a few hops), a resolved
  marker's byte written back so that later chains stop there, and a
  second launch follows the chains past HOP_BUDGET hops;
  `spec_resolve_jump_cuda`, the pointer jumping over every cell, is kept
  to be timed against it.

The bit semantics are the native BitReader's: a read past the stream's
`nbits` is truncation, checked where the native code checks it, and a
table lookup near the end sees zero bits past it. The plain versions are
the kernels' control flow on the host (SP1's pre-filter is torch over
every offset, its full check and SP2 a scalar loop, SP3 torch). The
wrapper runs the plain version for a CPU tensor and launches the kernel
for a CUDA one; nothing falls back. Words cross as int32 bit-views of
LE32 words and cells as int16 bit-views of u16. Bit positions are int64
everywhere (SP1's ranges and results, SP2's status and block starts), so
a stream has no size limit of its own; a segment's cells stay under 2^31.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ... import _device
from .istream_kernel import SCRATCH, STAT_NAMES, STATS

# launches of the CUDA kernels; the plain versions do not count
launches = {"block_find": 0, "spec_decode": 0, "spec_resolve": 0}

WSIZE = 32768
DEPTH = 6  # the block-header chain SP1 checks, native find_candidate's
STATIC_SYMS = 192  # symbols a static follower is sanity-decoded for
MIN_BLOCK_BITS = 10  # the shortest block: a fixed header and its EOB
META = 8  # start_bit, stop_bit, cap, hist, cell_off, rec_off, rec_cap, 0
STATUS = 8  # n, end_bit, final_seen, why, need_hist, nrec, overflow, start_bit
OK, INVALID, CAP, TRUNCATED, NO_START = 0, -1, -2, -3, -4
SURVIVOR_SHARE = 8  # SP1's survivor room holds a 1/8 of the offsets at first
TILE_WORDS = 256  # SP1's pre-filter tile: a word of 32 bit offsets a thread (kTileWords)
TILE_BITS = 32 * TILE_WORDS  # a tile's offsets; its room on a rerun
FIND_STATS = ("survivors", "checked")  # SP1's counters
HOP_BUDGET = 16  # hops an SP3 chain takes in its first launch (kHopBudget)
RESOLVE_STATS = ("markers", "hops", "max_hops", "pending")  # SP3's counters (kResolveStats)

CL_ORDER = (16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15)
LEN_BASE = (3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31, 35, 43, 51, 59,
            67, 83, 99, 115, 131, 163, 195, 227, 258)
LEN_EXTRA = (0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4,
             5, 5, 5, 5, 0)
DIST_BASE = (1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193, 257, 385, 513,
             769, 1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289, 16385, 24577)
DIST_EXTRA = (0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10,
              11, 11, 12, 12, 13, 13)
_BAD = -1  # a lookup slot no code reaches


# ---------------------------------------------------------------------------
# operands
# ---------------------------------------------------------------------------


def stream_words(data: bytes) -> np.ndarray:
    """`data` as int32 bit-views of LE32 words with >= 2 zero tail words,
    so that every read past the stream sees zero bits."""
    n = len(data)
    buf = np.zeros(((n + 3) // 4 + 2) * 4, np.uint8)
    buf[:n] = np.frombuffer(data, np.uint8)
    return buf.view("<i4")


def _check_words(words, nbits: int, kernel: str) -> None:
    if words.dim() != 1 or words.dtype != torch.int32:
        raise ValueError(f"{kernel}: words must be int32 [W] (uint32 bit-views)")
    if nbits < 0 or words.shape[0] * 32 < nbits + 64:
        raise ValueError(f"{kernel}: words must hold the stream's nbits and 2 zero tail words")


def _host_bytes(words) -> bytes:
    return words.cpu().numpy().astype("<i4").view(np.uint8).tobytes() + bytes(8)


# ---------------------------------------------------------------------------
# the native bit semantics, shared by the plain SP1 and SP2
# ---------------------------------------------------------------------------


def _peek(buf: bytes, pos: int, k: int) -> int:
    """k <= 25 bits at bit `pos`, LSB first, zero past the stream."""
    i = pos >> 3
    return (int.from_bytes(buf[i : i + 4], "little") >> (pos & 7)) & ((1 << k) - 1)


def _kraft(lens) -> tuple[int, int, int, int]:
    """(left, ncodes, minlen, maxlen) of a length set; left < 0 once the
    code is over-subscribed (native build_table's walk)."""
    cnt = [0] * 16
    for ln in lens:
        cnt[ln] += 1
    left, neg = 1, False
    for ln in range(1, 16):
        left = 2 * left - cnt[ln]
        neg = neg or left < 0
    nz = [ln for ln in range(1, 16) if cnt[ln]]
    return (-1 if neg else left), sum(cnt[1:]), (nz[0] if nz else 15), (nz[-1] if nz else 0)


def _table_bad(lens, kind_of: int) -> bool:
    """Native build_table's refusal: kind_of 0 code lengths (must be
    complete), 1 litlen, 2 distance (an incomplete code of one symbol
    passes; an empty distance code passes)."""
    left, ncodes, _mn, _mx = _kraft(lens)
    if kind_of == 0:
        return left != 0
    if left < 0:
        return True
    if kind_of == 1:
        return left > 0 and ncodes != 1
    return left > 0 and ncodes > 1


def _lut(lens, kind_of: int):
    """A flat lookup of 2^maxlen slots over LSB-first peeks: (sym, nbits)
    a slot, (_BAD, root) where no code reaches (root as native's two-level
    table would give it, min(max(R, minlen), maxlen), which only an
    incomplete code of one symbol, or none, leaves). Returns (lut, bits)."""
    _left, _n, mn, mx = _kraft(lens)
    bits = max(mx, 1)
    root = min(max((7, 10, 9)[kind_of], mn), bits)
    lut = [(_BAD, root)] * (1 << bits)
    code, nxt = 0, [0] * 16
    cnt = [0] * 16
    for ln in lens:
        cnt[ln] += 1
    cnt[0] = 0
    for ln in range(1, 16):
        code = (code + cnt[ln - 1]) << 1
        nxt[ln] = code
    for sym, ln in enumerate(lens):
        if not ln:
            continue
        c = nxt[ln]
        nxt[ln] += 1
        rev = int(f"{c:0{ln}b}"[::-1], 2)
        lut[rev :: 1 << ln] = [(sym, ln)] * len(range(rev, 1 << bits, 1 << ln))
    return lut, bits


_FIXED_LENS = [8] * 144 + [9] * 112 + [7] * 24 + [8] * 8
_FIXED_LIT = _lut(_FIXED_LENS, 1)
_FIXED_DIST = _lut([5] * 32, 2)


def _parse_dynamic(buf: bytes, N: int, pos: int):
    """Native parse_dynamic_tables: (why, pos, litlen lens, dist lens)."""
    if N - pos < 14:
        return TRUNCATED, pos, None, None
    nlen = _peek(buf, pos, 5) + 257
    ndist = _peek(buf, pos + 5, 5) + 1
    ncode = _peek(buf, pos + 10, 4) + 4
    pos += 14
    if nlen > 286 or ndist > 30:
        return INVALID, pos, None, None
    cl = [0] * 19
    for i in range(ncode):
        if N - pos < 3:
            return TRUNCATED, pos, None, None
        cl[CL_ORDER[i]] = _peek(buf, pos, 3)
        pos += 3
    if _table_bad(cl, 0):
        return INVALID, pos, None, None
    cl_lut, cl_bits = _lut(cl, 0)
    total = nlen + ndist
    lens = [0] * total
    have = 0
    while have < total:
        if N - pos < 7:
            return TRUNCATED, pos, None, None
        sym, nb = cl_lut[_peek(buf, pos, cl_bits)]
        if sym < 16:
            pos += nb
            lens[have] = sym
            have += 1
            continue
        extra = 2 if sym == 16 else 3 if sym == 17 else 7
        if N - pos < nb + extra:
            return TRUNCATED, pos, None, None
        pos += nb
        if sym == 16:
            if have == 0:
                return INVALID, pos, None, None
            rep, fill = 3 + _peek(buf, pos, 2), lens[have - 1]
        elif sym == 17:
            rep, fill = 3 + _peek(buf, pos, 3), 0
        else:
            rep, fill = 11 + _peek(buf, pos, 7), 0
        pos += extra
        if have + rep > total:
            return INVALID, pos, None, None
        lens[have : have + rep] = [fill] * rep
        have += rep
    lit, dist = lens[:nlen], lens[nlen:]
    if lit[256] == 0 or _table_bad(lit, 1) or _table_bad(dist, 2):
        return INVALID, pos, None, None
    return OK, pos, lit, dist


# ---------------------------------------------------------------------------
# SP1: the block finder
# ---------------------------------------------------------------------------


def _validate(buf: bytes, N: int, b: int) -> bool:
    """Native validate_header_at(b, depth 6)."""
    pos, stored = b, 0
    for d in range(DEPTH):
        if N - pos < 3:
            return False
        typ = _peek(buf, pos + 1, 2)
        pos += 3
        if typ == 3 or (typ == 1 and d == 0):
            return False
        if typ == 0:
            pos = (pos + 7) & ~7
            if N - pos < 32:
                return False
            ln, nln = _peek(buf, pos, 16), _peek(buf, pos + 16, 16)
            pos += 32
            if ln ^ nln != 0xFFFF or ln == 0 or N - pos < 8 * ln:
                return False
            pos += 8 * ln
            stored += 1
            continue
        if typ == 2:
            return _parse_dynamic(buf, N, pos)[0] == OK
        lut, lbits = _FIXED_LIT
        dlut, dbits = _FIXED_DIST
        syms, eob = 0, False
        while syms < STATIC_SYMS:
            if N - pos == 0:
                return False
            sym, nb = lut[_peek(buf, pos, lbits)]
            if N - pos < nb or sym >= 286:
                return False
            if sym == 256:
                pos += nb
                eob = True
                break
            if sym < 256:
                pos += nb
                syms += 1
                continue
            extra = LEN_EXTRA[sym - 257]
            if N - pos < nb + extra:
                return False
            pos += nb + extra
            dsym, dnb = dlut[_peek(buf, pos, dbits)]
            if dsym >= 30:
                return False
            if N - pos < dnb + DIST_EXTRA[dsym]:
                return False
            pos += dnb + DIST_EXTRA[dsym]
            syms += 1
        if not eob:
            return True
    return stored >= 2


def prefilter_plain(words, nbits: int, offs: torch.Tensor) -> torch.Tensor:
    """SP1's first pass over bit offsets `offs` (int64): the checks of the
    chain's first header that need no table (its type; a stored LEN/NLEN;
    a dynamic header's counts and a complete code-length code). Every
    offset that `_validate` accepts passes."""
    dev = offs.device
    bb = torch.zeros(words.shape[0] * 4 + 8, dtype=torch.int64, device=dev)
    bb[: words.shape[0] * 4] = words.view(torch.uint8).to(torch.int64)

    def field(pos, k):
        i = pos >> 3
        v = bb[i] | (bb[i + 1] << 8) | (bb[i + 2] << 16) | (bb[i + 3] << 24)
        return (v >> (pos & 7)) & ((1 << k) - 1)

    b = offs.clamp(0, max(nbits - 1, 0))
    typ = field(b + 1, 2)
    q = (b + 10) & ~7
    ln, nln = field(q, 16), field(q + 16, 16)
    stored = (typ == 0) & (q + 32 <= nbits) & ((ln ^ nln) == 0xFFFF) & (ln != 0)
    ncode = field(b + 13, 4) + 4
    dyn = ((typ == 2) & (b + 17 + 3 * ncode <= nbits) & (field(b + 3, 5) <= 29)
           & (field(b + 8, 5) <= 29))
    cnt = torch.zeros((8,) + tuple(b.shape), dtype=torch.int64, device=dev)
    for i in range(19):
        ln_i = torch.where(ncode > i, field(b + 17 + 3 * i, 3), 0)
        cnt.scatter_add_(0, ln_i[None], torch.ones_like(ln_i)[None])
    left = torch.ones_like(b)
    neg = torch.zeros_like(b, dtype=torch.bool)
    for ln_ in range(1, 8):
        left = 2 * left - cnt[ln_]
        neg |= left < 0
    dyn &= ~neg & (left == 0)
    return (offs >= 0) & (offs + 3 <= nbits) & (stored | dyn)


def _ranges(lo, hi) -> tuple[list, list]:
    """SP1's segment ranges, lists of T ints each (the route builds them on
    the host, so the wrapper reads nothing back to size its launch)."""
    if not isinstance(lo, list) or not isinstance(hi, list) or len(lo) != len(hi):
        raise ValueError("block_find: lo and hi must be lists of T ints")
    return [int(x) for x in lo], [int(x) for x in hi]


def tile_counts(lo: list, hi: list, nbits: int) -> list:
    """SP1's pre-filter tiles a segment: TILE_WORDS words a tile from the
    word of max(lo, 0) through the last offset b < hi with b + 3 <= nbits
    (csrc/speculative.cu `seg_range`)."""
    out = []
    for a, z in zip(lo, hi):
        a, e = max(a, 0), min(z, nbits - 2)
        out.append(0 if e <= a else -(-(((e - 1) >> 5) - (a >> 5) + 1) // TILE_WORDS))
    return out


def find_operands(lo: list, hi: list, nbits: int) -> tuple[np.ndarray, int]:
    """SP1's ranges as one int64 [3T + 1] row (lo, hi, each segment's first
    tile and the tiles' total) and the number of tiles."""
    first = np.concatenate([[0], np.cumsum(tile_counts(lo, hi, nbits), dtype=np.int64)])
    return np.concatenate([np.asarray(lo, np.int64), np.asarray(hi, np.int64), first]), \
        int(first[-1])


def block_find_plain(words, nbits: int, lo, hi) -> torch.Tensor:
    """The plain SP1: per segment, the first offset in [lo, hi) that passes
    the pre-filter and then `_validate`, or -1: int64 [T] on the host, lo
    and hi anything that iterates to T ints each."""
    _check_words(words, nbits, "block_find")
    buf = _host_bytes(words)
    lo_l, hi_l = [int(x) for x in lo], [int(x) for x in hi]
    best = []
    for a, z in zip(lo_l, hi_l):
        z = min(z, nbits)
        found = -1
        if a < z:
            offs = torch.arange(a, z, dtype=torch.int64, device=words.device)
            cand = offs[prefilter_plain(words, nbits, offs)].tolist()
            for c in cand:
                if _validate(buf, nbits, c):
                    found = c
                    break
        best.append(found)
    return torch.tensor(best, dtype=torch.int64)


# ---------------------------------------------------------------------------
# SP2: the marker decode
# ---------------------------------------------------------------------------


def _spec_lane(buf: bytes, N: int, start: int, stop: int, cap: int, hist: int, rec_cap: int):
    """One segment, as the kernel runs it: (cells list, status list of
    STATUS ints, records list of (bit, cell offset))."""
    cells: list[int] = []
    recs: list[tuple[int, int]] = []
    need = overflow = 0
    pos = start

    def done(why, final=0):
        end = pos if why == OK else -1
        return cells, [len(cells), end, final, why, need, len(recs), overflow, start], recs

    if start < 0:
        return done(NO_START)
    first = True
    while True:
        if not first and pos >= stop:
            return done(OK)
        first = False
        if len(recs) < rec_cap:
            recs.append((pos, len(cells)))
        else:
            overflow = 1
        if N - pos < 3:
            return done(TRUNCATED)
        hdr = _peek(buf, pos, 3)
        pos += 3
        final, typ = hdr & 1, hdr >> 1
        if typ == 0:
            pos = (pos + 7) & ~7
            if N - pos < 32:
                return done(TRUNCATED)
            ln, nln = _peek(buf, pos, 16), _peek(buf, pos + 16, 16)
            pos += 32
            if ln ^ nln != 0xFFFF:
                return done(INVALID)
            if len(cells) + ln > cap:
                return done(CAP)
            if N - pos < 8 * ln:
                return done(TRUNCATED)
            cells.extend(buf[pos >> 3 : (pos >> 3) + ln])
            pos += 8 * ln
        elif typ == 3:
            return done(INVALID)
        else:
            if typ == 1:
                (lut, lbits), (dlut, dbits) = _FIXED_LIT, _FIXED_DIST
            else:
                why, pos, lit, dist = _parse_dynamic(buf, N, pos)
                if why:
                    return done(why)
                (lut, lbits), (dlut, dbits) = _lut(lit, 1), _lut(dist, 2)
            while True:
                if N - pos == 0:
                    return done(TRUNCATED)
                sym, nb = lut[_peek(buf, pos, lbits)]
                if N - pos < nb:
                    return done(TRUNCATED)
                if 0 <= sym < 256:
                    if len(cells) >= cap:
                        return done(CAP)
                    pos += nb
                    cells.append(sym)
                    continue
                if sym == 256:
                    pos += nb
                    break
                if sym < 0 or sym >= 286:
                    return done(INVALID)
                extra = LEN_EXTRA[sym - 257]
                if N - pos < nb + extra:
                    return done(TRUNCATED)
                length = LEN_BASE[sym - 257] + _peek(buf, pos + nb, extra)
                pos += nb + extra
                dsym, dnb = dlut[_peek(buf, pos, dbits)]
                if dsym < 0 or dsym >= 30:
                    return done(INVALID)
                dext = DIST_EXTRA[dsym]
                if N - pos < dnb + dext:
                    return done(TRUNCATED)
                dist = DIST_BASE[dsym] + _peek(buf, pos + dnb, dext)
                pos += dnb + dext
                n = len(cells)
                if dist > n + hist:
                    return done(INVALID)
                if n + length > cap:
                    return done(CAP)
                nm = min(length, dist - n) if dist > n else 0
                if nm:
                    need = max(need, dist - n)
                    cells.extend(256 + dist - n - j - 1 for j in range(nm))
                for j in range(length - nm):
                    cells.append(cells[n + nm + j - dist])
        if final:
            return done(OK, 1)


def _prepare_decode(words, nbits: int, meta, cell_total: int, rec_total: int):
    """The checks of SP2's operands; meta on the host."""
    _check_words(words, nbits, "spec_decode")
    if meta.dim() != 2 or meta.shape[1] != META or meta.dtype != torch.int64:
        raise ValueError("spec_decode: meta must be int64 [T, 8]")
    m = meta.cpu()
    if m.shape[0] and (bool((m[:, 4] + m[:, 2] > cell_total).any())
                       or bool((m[:, 5] + m[:, 6] > rec_total).any())):
        raise ValueError("spec_decode: a segment's cells or records pass the buffers")
    if bool((m[:, 2] >= 1 << 31).any()) or cell_total >= 1 << 40:
        raise ValueError("spec_decode: a cell cap must be < 2^31")
    return m


def spec_decode_plain(words, nbits: int, meta, cell_total: int, rec_total: int):
    """The plain SP2: each segment through `_spec_lane`. Returns (cells
    int16 [cell_total], records int64 [rec_total, 2], status int64
    [T, STATUS]) on meta's device; cells past a segment's n are 0."""
    _prepare_decode(words, nbits, meta, cell_total, rec_total)
    buf = _host_bytes(words)
    cells = np.zeros(cell_total, np.uint16)
    recs = np.zeros((rec_total, 2), np.int64)
    st = np.zeros((meta.shape[0], STATUS), np.int64)
    for k, (start, stop, cap, hist, coff, roff, rcap, _z) in enumerate(meta.tolist()):
        c, s, r = _spec_lane(buf, nbits, start, stop, cap, hist, rcap)
        cells[coff : coff + len(c)] = c
        if r:
            recs[roff : roff + len(r)] = r
        st[k] = s
    dev = meta.device
    return (torch.from_numpy(cells.view(np.int16)).to(dev), torch.from_numpy(recs).to(dev),
            torch.from_numpy(st).to(dev))


# ---------------------------------------------------------------------------
# SP3: the marker resolve
# ---------------------------------------------------------------------------


def resolve_rounds(n_segments: int) -> int:
    """Pointer-jumping rounds that resolve chains of n_segments - 1 hops:
    a hop always lands in an earlier segment."""
    return max(1, int(n_segments).bit_length())


def _check_resolve(cells, seg_ofs):
    if cells.dim() != 1 or cells.dtype != torch.int16:
        raise ValueError("spec_resolve: cells must be int16 [n] (u16 bit-views)")
    if seg_ofs.dim() != 1 or seg_ofs.dtype != torch.int64 or seg_ofs.shape[0] < 2:
        raise ValueError("spec_resolve: seg_ofs must be int64 [E + 1]")
    if cells.shape[0] >= 1 << 31:
        raise ValueError("spec_resolve: at most 2^31 - 1 cells")


def spec_resolve_plain(cells, seg_ofs):
    """The plain SP3: (bytes uint8 [n], unresolved bool) on cells' device.
    seg_ofs holds each segment's first cell and the total, non-decreasing;
    a marker's target clamps to the cells (the host checks the deepest
    reference of each segment against its offset first). A cell whose
    chain still ends on a marker after resolve_rounds rounds (a marker at
    cell 0 whose target clamps onto itself) sets `unresolved` and gives
    that marker's low byte."""
    _check_resolve(cells, seg_ofs)
    c = cells.to(torch.int32) & 0xFFFF
    idx = torch.arange(c.shape[0], dtype=torch.int64, device=c.device)
    seg = torch.searchsorted(seg_ofs, idx, right=True) - 1
    ptr = torch.where(c < 256, idx, seg_ofs[seg.clamp(0, seg_ofs.shape[0] - 2)] - (c - 255))
    ptr = ptr.clamp(0, max(c.shape[0] - 1, 0))
    for _ in range(resolve_rounds(seg_ofs.shape[0] - 1)):
        ptr = ptr[ptr]
    got = c[ptr] if c.numel() else c
    return got.to(torch.uint8), bool((got >= 256).any())


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


def _fn(name: str, argtypes):
    fn = getattr(_device.library("speculative"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_NONE = 1 << 62  # SP1's best offset before any passes


def _to_card(a: np.ndarray, dev) -> torch.Tensor:
    """A host array on `dev` without a host sync: staged in pinned memory
    and copied on the current stream."""
    t = torch.from_numpy(a)
    if dev.type != "cuda":
        return t.to(dev)
    return t.pin_memory().to(dev, non_blocking=True)


def block_find_cuda(words, nbits: int, lo: list, hi: list, *,
                    stats: dict | None = None) -> torch.Tensor:
    """Launch SP1 over CUDA words int32 [W], lo and hi the segments' bit
    ranges (lists of T ints); returns int64 [T] on the host. The
    pre-filter writes each tile's survivors in offset order into a room
    of TILE_BITS // SURVIVOR_SHARE u16 offsets (SURVIVOR_SHARE read at
    each call); the check takes each segment's survivors in that order,
    256 at a time, up to the first group in which one passes. The results
    and an overflow flag a segment come back in one copy, the launch's one
    host sync; where a tile counted more survivors than its room, the
    launch runs again with room for every offset (exact either way).
    `stats`, where given, gets FIND_STATS summed over the launches and
    the last launch's `room`."""
    _device.require_cuda("block_find", words)
    _check_words(words, nbits, "block_find")
    lo, hi = _ranges(lo, hi)
    T = len(lo)
    dev = words.device
    if T == 0:
        return torch.zeros(0, dtype=torch.int64)
    ops, tiles = find_operands(lo, hi, nbits)
    ops_d = _to_card(ops, dev)
    room = TILE_BITS // SURVIVOR_SHARE
    st = None if stats is None else torch.zeros(len(FIND_STATS), dtype=torch.int64, device=dev)
    while True:
        surv = torch.empty((max(tiles, 1), room), dtype=torch.int16, device=dev)
        counts = torch.empty(max(tiles, 1), dtype=torch.int32, device=dev)
        res = torch.zeros(2 * T, dtype=torch.int64, device=dev)
        rc = _fn("zrs_block_find", [_P, _I, _L, _P, _I, _I, _P, _I, _P, _P, _P, _P])(
            _device.ptr(words), words.shape[0], nbits, _device.ptr(ops_d), T, tiles,
            _device.ptr(surv), room, _device.ptr(counts), _device.ptr(res),
            None if st is None else _device.ptr(st), _device.stream_of(words),
        )
        _device.check(rc, "block_find")
        launches["block_find"] += 1
        got = res.cpu()
        if room >= TILE_BITS or not bool(got[T:].any()):
            break
        room = TILE_BITS
    if stats is not None:
        stats.update(zip(FIND_STATS, st.tolist()), room=room)
    return got[:T]


def block_find_thread_cuda(words, nbits: int, lo, hi) -> torch.Tensor:
    """SP1's first design (csrc/speculative.cu `find_prefilter`, a thread an
    offset, then `find_check`, a thread a survivor) over CUDA operands:
    words int32 [W], lo and hi int64 [T] on the card; returns int64 [T] on
    the card. Its survivors go into a list of a 1/SURVIVOR_SHARE of the
    offsets, rerun with room for all where more survive. It is timed
    against block_find_cuda and called by no route, so it counts no
    launch."""
    _device.require_cuda("block_find", words, lo, hi)
    _check_words(words, nbits, "block_find")
    T = lo.shape[0]
    if hi.shape != (T,) or lo.dtype != torch.int64 or hi.dtype != torch.int64:
        raise ValueError("block_find: lo and hi must be int64 [T]")
    dev = words.device
    best = torch.full((T,), -1, dtype=torch.int64, device=dev)
    if T == 0:
        return best
    lo, hi = lo.contiguous(), hi.contiguous()
    span = int((hi.clamp(max=nbits) - lo).clamp(min=0).max())
    offsets = int((hi.clamp(max=nbits) - lo).clamp(min=0).sum())
    cap = offsets // SURVIVOR_SHARE + 1024
    while True:
        surv = torch.empty((cap, 2), dtype=torch.int64, device=dev)
        count = torch.zeros(1, dtype=torch.int32, device=dev)
        best.fill_(_NONE)
        rc = _fn("zrs_block_find_thread", [_P, _I, _L, _P, _P, _I, _I, _P, _I, _P, _P, _P])(
            _device.ptr(words), words.shape[0], nbits, _device.ptr(lo), _device.ptr(hi), T,
            span, _device.ptr(surv), cap, _device.ptr(count), _device.ptr(best),
            _device.stream_of(words),
        )
        _device.check(rc, "block_find")
        got = int(count.item())
        if got <= cap:
            break
        cap = got
    return torch.where(best == _NONE, -1, best)


def _sm_count(dev) -> int:
    """The SMs of `dev`, which bound SP2's resident blocks (one a SM: 1,024
    threads of at most 64 registers); a device with no CUDA properties
    (the wrapper tests' stub) counts one."""
    return torch.cuda.get_device_properties(dev).multi_processor_count if dev.type == "cuda" else 1


def longest_first(m, nbits: int) -> torch.Tensor:
    """The rows of meta `m` (host int64 [T, 8]) by their bit span, the
    longest first (rows with no start last): the order in which SP2's
    persistent blocks take them. int32 [T]."""
    span = torch.where(m[:, 0] >= 0, m[:, 1].clamp(max=nbits) - m[:, 0], -1)
    return torch.argsort(span, descending=True, stable=True).to(torch.int32)


def fold_stats(rows) -> dict:
    """SP2's counters, int64 [blocks, STATS], as one dict of STAT_NAMES:
    summed over the blocks, the max_ fields their largest; and
    `slowest_block_ns`, the largest of a block's head, sync and expansion
    ns (its rows' time, the next headers' parses hidden in the expansion)."""
    rows = rows.cpu()
    out = {name: int(rows[:, i].max() if name.startswith("max_") else rows[:, i].sum())
           for i, name in enumerate(STAT_NAMES)}
    busy = rows[:, [STAT_NAMES.index(k) for k in ("ns_head", "ns_sync", "ns_expand")]].sum(1)
    out["slowest_block_ns"] = int(busy.max()) if busy.numel() else 0
    return out


def spec_decode_cuda(words, nbits: int, meta, cell_total: int, rec_total: int,
                     stats: dict | None = None):
    """Launch SP2 over CUDA operands: words int32 [W], meta int64 [T, 8];
    records int64 [rec_total, 2] and status int64 [T, STATUS] back. A
    thread block of 1,024 a row (csrc/speculative.cu `spec_sync`: warp 0
    runs native's headers and the stream's last bits, the block each
    coded body), as many blocks as are resident, each with a pointer
    scratch of SCRATCH int32, taking the rows the longest first. Cells
    past a row's n and records past its count are left unwritten (the
    plain version's are 0). `stats`, where given, receives the body's
    counters (fold_stats)."""
    _device.require_cuda("spec_decode", words, meta)
    m = _prepare_decode(words, nbits, meta, cell_total, rec_total)
    dev = words.device
    T = meta.shape[0]
    # a segment writes cells [0, n) and records [0, nrec) of its room; no
    # reader goes past them, so nothing is zeroed
    cells = torch.empty(max(cell_total, 1), dtype=torch.int16, device=dev)[:cell_total]
    recs = torch.empty((max(rec_total, 1), 2), dtype=torch.int64, device=dev)[:rec_total]
    st = torch.zeros((T, STATUS), dtype=torch.int64, device=dev)
    if T:
        meta = meta.contiguous()
        if words.data_ptr() % 16:  # the body stages words 16 bytes at a time
            words = words.clone()
        blocks = min(T, _sm_count(dev))
        order = longest_first(m, nbits).to(dev)
        nxt = torch.zeros(1, dtype=torch.int32, device=dev)
        ptrs = torch.empty(blocks * SCRATCH, dtype=torch.int32, device=dev)
        rows = None if stats is None else torch.zeros((blocks, STATS), dtype=torch.int64,
                                                      device=dev)
        rc = _fn("zrs_spec_decode", [_P, _I, _L, _P, _I, _P, _P, _P, _P, _P, _P, _I, _P, _P])(
            _device.ptr(words), words.shape[0], nbits, _device.ptr(meta), T,
            _device.ptr(cells), _device.ptr(recs), _device.ptr(st), _device.ptr(order),
            _device.ptr(nxt), _device.ptr(ptrs), blocks,
            None if rows is None else _device.ptr(rows), _device.stream_of(words),
        )
        _device.check(rc, "spec_decode")
        launches["spec_decode"] += 1
        if stats is not None:
            stats.update(fold_stats(rows), blocks=blocks)
    return cells, recs, st


def spec_decode_warp_cuda(words, nbits: int, meta, cell_total: int, rec_total: int):
    """SP2's one-warp launch (csrc/speculative.cu `spec_decode`, a warp a
    row), the design before the block's: the same operands and results
    as spec_decode_cuda. It is timed against it and called by no route,
    so it counts no launch."""
    _device.require_cuda("spec_decode", words, meta)
    _prepare_decode(words, nbits, meta, cell_total, rec_total)
    dev = words.device
    T = meta.shape[0]
    cells = torch.empty(max(cell_total, 1), dtype=torch.int16, device=dev)[:cell_total]
    recs = torch.empty((max(rec_total, 1), 2), dtype=torch.int64, device=dev)[:rec_total]
    st = torch.zeros((T, STATUS), dtype=torch.int64, device=dev)
    if T:
        meta = meta.contiguous()
        rc = _fn("zrs_spec_decode_warp", [_P, _I, _L, _P, _I, _P, _P, _P, _P])(
            _device.ptr(words), words.shape[0], nbits, _device.ptr(meta), T,
            _device.ptr(cells), _device.ptr(recs), _device.ptr(st), _device.stream_of(words),
        )
        _device.check(rc, "spec_decode")
    return cells, recs, st


def spec_resolve_cuda(cells, seg_ofs, *, stats: dict | None = None):
    """Launch SP3 over CUDA operands: cells int16 [n], seg_ofs int64
    [E + 1]. A warp takes 32 cells at a time, each marker's chain followed
    over a copy of the cells for HOP_BUDGET hops (seg_ofs in shared memory);
    where seg_ofs starts at 0, a resolved marker's byte is written back
    into the copy, so that later chains through it end there, and a second
    launch follows the chains left pending to their ends. A chain stops at
    a literal, at a marker that is its own target, or after
    2^resolve_rounds hops (the plain version's rounds), so the bytes and
    the flag are the plain version's. One C entry, one stream; the flag's
    read is the one host sync. `stats`, where given, gets RESOLVE_STATS."""
    _device.require_cuda("spec_resolve", cells, seg_ofs)
    _check_resolve(cells, seg_ofs)
    dev = cells.device
    n = cells.shape[0]
    out = torch.empty(n, dtype=torch.uint8, device=dev)
    ctl = torch.zeros(2, dtype=torch.int32, device=dev)
    st = None if stats is None else torch.zeros(len(RESOLVE_STATS), dtype=torch.int64,
                                                device=dev)
    if n:
        work = cells.clone(memory_format=torch.contiguous_format)
        seg_ofs = seg_ofs.contiguous()
        rc = _fn("zrs_spec_resolve", [_P, _I, _P, _I, _L, _I, _P, _P, _P, _P])(
            _device.ptr(work), n, _device.ptr(seg_ofs), seg_ofs.shape[0] - 1,
            1 << resolve_rounds(seg_ofs.shape[0] - 1), HOP_BUDGET, _device.ptr(out),
            _device.ptr(ctl), None if st is None else _device.ptr(st), _device.stream_of(cells),
        )
        _device.check(rc, "spec_resolve")
        launches["spec_resolve"] += 1
    if stats is not None:
        stats.update(zip(RESOLVE_STATS, st.tolist()))
    return out, bool(ctl[0].item())


def spec_resolve_jump_cuda(cells, seg_ofs):
    """SP3's first design (csrc/speculative.cu `resolve_init`, rounds of
    `resolve_jump`, `resolve_narrow`: a pointer a cell in two int32 device
    buffers, resolve_rounds rounds over every cell) over the same operands
    and results as spec_resolve_cuda. It is timed against it and called by
    no route, so it counts no launch."""
    _device.require_cuda("spec_resolve", cells, seg_ofs)
    _check_resolve(cells, seg_ofs)
    dev = cells.device
    n = cells.shape[0]
    out = torch.empty(n, dtype=torch.uint8, device=dev)
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    if n:
        cells, seg_ofs = cells.contiguous(), seg_ofs.contiguous()
        ptr_a = torch.empty(n, dtype=torch.int32, device=dev)
        ptr_b = torch.empty(n, dtype=torch.int32, device=dev)
        rc = _fn("zrs_spec_resolve_jump", [_P, _I, _P, _I, _P, _P, _I, _P, _P, _P])(
            _device.ptr(cells), n, _device.ptr(seg_ofs), seg_ofs.shape[0] - 1,
            _device.ptr(ptr_a), _device.ptr(ptr_b), resolve_rounds(seg_ofs.shape[0] - 1),
            _device.ptr(out), _device.ptr(flag), _device.stream_of(cells),
        )
        _device.check(rc, "spec_resolve")
    return out, bool(flag.item())


def block_find(words, nbits: int, lo, hi):
    """SP1: the plain version for a CPU tensor, the kernel for a CUDA one."""
    fn = block_find_plain if words.device.type == "cpu" else block_find_cuda
    return fn(words, nbits, lo, hi)


def spec_decode(words, nbits: int, meta, cell_total: int, rec_total: int):
    """SP2: the plain version for a CPU tensor, the kernel for a CUDA one."""
    fn = spec_decode_plain if words.device.type == "cpu" else spec_decode_cuda
    return fn(words, nbits, meta, cell_total, rec_total)


def spec_resolve(cells, seg_ofs):
    """SP3: the plain version for a CPU tensor, the kernel for a CUDA one."""
    fn = spec_resolve_plain if cells.device.type == "cpu" else spec_resolve_cuda
    return fn(cells, seg_ofs)
