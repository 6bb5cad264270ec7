"""Pure-Python MEDIUM and QUICK deflate modes (a copy of
zlib_rs_tpu/models/medium.py, host code).

`compress_medium(data, n)` is the zlib-ng `deflate_medium` algorithm class
(the current+next Match pair, insert_match's hash-coverage caps and
fizzle_matches backward overlap trimming) decision for decision, with the
realization choices of the reference's native engine (4-byte Knuth hash
into a 16-bit table, 16-bit capped delta chains, one-deeper zlib knob
rows); `MediumStream` is the same scan paused and resumed with native's
pump contract (the plain version of DS at MEDIUM4-6); `compress_quick` is
the adaptive QUICK mode. The reference holds both one-shot modes
byte-identical to its native engine; the port's copies are held
byte-identical to the reference's, and MediumStream to native's handle.

This is NOT the bit-exact zlib path (levels 1-9 keep that contract);
medium trades ~0-2% ratio for 2-3x scan speed, like zlib-ng does.
"""

from __future__ import annotations

from . import trees
from .deflate import BitWriter
from ..config import Strategy

MIN_MATCH = 3
MAX_MATCH = 258
WANT_MIN = 4
WSIZE = 32768
MIN_LOOKAHEAD = MAX_MATCH + MIN_MATCH + 1
MAX_DIST = WSIZE - MIN_LOOKAHEAD
SYM_END = (1 << 14) - 1  # LIT_BUFSIZE_N - 1 at memLevel 8

# native LEVELS rows 5/6/7: {good, lazy, nice, chain}; medium-4/5/6 use
# the one-deeper row (see zrs_native.cpp klevel mapping)
_KNOBS = {4: (8, 16, 32, 32), 5: (8, 16, 128, 128), 6: (8, 32, 128, 256)}


class _Medium:
    def __init__(self, data: bytes, knobs, dict_len: int = 0):
        # `data` is the priming dictionary followed by the input; positions
        # are absolute in it, the scan starting at dict_len (native's base)
        self.data = data
        self.dict_len = dict_len
        self.good, self.lazy, self.nice, self.chain = knobs
        self.head4 = [0] * (1 << 16)
        self.prevd4 = [0] * WSIZE
        self.out = bytearray()
        self.bw = BitWriter(self.out)
        self.sym_dist: list[int] = []
        self.sym_lit: list[int] = []
        self.block_start = dict_len
        self.spos = dict_len
        self.med_next = None  # the pre-found next match: [start, strstart, orgstart, length]
        for i in range(dict_len - 3):  # native's priming: every 4-byte string
            self.insert4(i)

    def _hash4(self, pos: int) -> int:
        v = int.from_bytes(self.data[pos : pos + 4], "little")
        return ((v * 2654435761) & 0xFFFFFFFF) >> 16

    def insert4(self, pos: int) -> None:
        h = self._hash4(pos)
        delta = pos - self.head4[h]
        # native's uint16 store: a negative delta (a head left from before a
        # stream's FULL_FLUSH) wraps, as it does there
        self.prevd4[pos & (WSIZE - 1)] = min(delta, 0xFFFF) & 0xFFFF
        self.head4[h] = pos

    def chain_prev4(self, pos: int) -> int:
        d = self.prevd4[pos & (WSIZE - 1)]
        return pos - d if d else 0

    def _match_len(self, pos: int, cand: int) -> int:
        """Common prefix vs the zero-extended buffer (native match_len_z
        semantics: reads past the data end behave as zeros)."""
        data = self.data
        total = len(data)
        n = 0
        while n < MAX_MATCH:
            a = data[pos + n] if pos + n < total else 0
            b = data[cand + n] if cand + n < total else 0
            if a != b:
                break
            n += 1
        return n

    def longest4(self, pos: int, cur: int):
        """Mirror of native longest4: budgeted chain walk, nice cutoff,
        first-best-wins; returns (length >= WANT_MIN or 0, dist)."""
        total = len(self.data)
        lookahead = total - pos
        chain = self.chain
        best_len = WANT_MIN - 1
        nice = min(self.nice, lookahead)
        limit = max(pos - MAX_DIST, 0)
        best_dist = 0
        while True:
            ml = self._match_len(pos, cur)
            if ml > best_len:
                best_len = ml
                best_dist = pos - cur
                if ml >= nice:
                    break
            nxt = self.chain_prev4(cur)
            if nxt >= cur or nxt <= limit:
                break
            cur = nxt
            chain -= 1
            if chain == 0:
                break
        if not best_dist:
            return 0, 0
        return min(best_len, lookahead), best_dist

    def insert_range(self, p: int, count: int) -> None:
        total = len(self.data)
        for i in range(count):
            if p + i + 4 > total:
                break
            self.insert4(p + i)

    def insert_match(self, start: int, strstart: int, orgstart: int, length: int):
        total = len(self.data)
        if total - strstart <= length + WANT_MIN:
            return
        if length < WANT_MIN:
            strstart += 1
            length -= 1
            if length > 0 and strstart >= orgstart:
                cnt = length if strstart + length > orgstart else orgstart - strstart + 1
                self.insert_range(strstart, cnt)
            return
        if length <= 16 * self.lazy and total - strstart >= WANT_MIN:
            length -= 1
            strstart += 1
            if strstart >= orgstart:
                cnt = length if strstart + length > orgstart else orgstart - strstart + 1
                self.insert_range(strstart, cnt)
            elif orgstart < strstart + length:
                self.insert_range(orgstart, strstart + length - orgstart)
        else:
            strstart += length
            if strstart >= 1 and strstart - 1 + 4 <= total:
                self.insert4(strstart - 1)

    def fizzle(self, cur: list, nm: list) -> None:
        """cur/nm: [start, strstart, orgstart, length] (mutated in place)."""
        data = self.data
        if cur[3] <= 1:
            return
        if cur[3] > 1 + nm[0] or cur[3] > 1 + nm[1]:
            return
        if data[nm[0] - cur[3] + 1] != data[nm[1] - cur[3] + 1]:
            return
        limit = nm[1] - MAX_DIST if nm[1] > MAX_DIST else 0
        c = list(cur)
        n = list(nm)
        mi, oi = n[0], n[1]
        changed = 0
        while mi >= 1 and oi >= 1 and data[mi - 1] == data[oi - 1]:
            if c[3] < 1 or n[1] <= limit or n[3] >= 256 or n[0] <= 1:
                break
            n[1] -= 1
            n[0] -= 1
            n[3] += 1
            c[3] -= 1
            mi -= 1
            oi -= 1
            changed += 1
        if not changed:
            return
        if c[3] <= 1 and n[3] != 2:
            n[2] += 1
            cur[:] = c
            nm[:] = n

    def flush_block(self, spos: int, last: bool) -> None:
        trees.flush_block(
            self.bw,
            self.out,
            self.sym_dist,
            self.sym_lit,
            bytes(self.data[self.block_start : spos]),
            last,
            6,
            Strategy.Default,
        )
        self.sym_dist = []
        self.sym_lit = []
        self.block_start = spos

    def scan(self, limit: int) -> None:
        """native run_medium(limit, total): the positions below `limit`,
        every clamp against the data's current end."""
        data = self.data
        total = len(data)
        early_exit = False  # all mirrored rows have klevel >= 5
        spos = self.spos
        while spos < limit:
            if self.med_next is not None and self.med_next[3] > 0:
                cur = self.med_next
                self.med_next = None
            else:
                hash_head = 0
                if spos + 4 <= total:
                    self.insert4(spos)
                    hash_head = self.chain_prev4(spos)
                cur = [0, spos, spos, 1]
                if hash_head > 0 and spos - hash_head <= MAX_DIST:
                    ml, mdist = self.longest4(spos, hash_head)
                    if mdist > 0 and ml >= WANT_MIN:
                        cur[0] = spos - mdist
                        cur[3] = ml
                    if cur[0] >= cur[1]:
                        cur[3] = 1
            self.insert_match(*cur)

            if not early_exit and total - cur[1] > MIN_LOOKAHEAD:
                nxt = cur[1] + cur[3]
                hh = 0
                if nxt + 4 <= total:
                    self.insert4(nxt)
                    hh = self.chain_prev4(nxt)
                nm = [0, nxt, nxt, 1]
                if hh > 0 and nxt - hh <= MAX_DIST:
                    ml, mdist = self.longest4(nxt, hh)
                    if mdist > 0 and ml >= WANT_MIN:
                        nm[0] = nxt - mdist
                        nm[3] = ml
                    if nm[0] >= nm[1]:
                        nm[3] = 1
                    if nm[3] >= WANT_MIN:
                        self.fizzle(cur, nm)
                self.med_next = nm
            else:
                self.med_next = None

            if cur[3] < WANT_MIN:
                for i in range(cur[3]):
                    self.sym_dist.append(0)
                    self.sym_lit.append(data[cur[1] + i])
            else:
                self.sym_dist.append(cur[1] - cur[0])
                self.sym_lit.append(cur[3])
            spos = cur[1] + cur[3]
            if len(self.sym_dist) >= SYM_END - 4:
                self.flush_block(spos, False)
        self.spos = spos

    def run(self, final: bool = True) -> bytes:
        total = len(self.data)
        self.scan(total)
        if final:
            self.flush_block(total, True)
            self.bw.align()
            return bytes(self.out)
        if self.sym_dist or self.block_start < total:
            self.flush_block(total, False)
        _seam(self.bw, self.out)
        return bytes(self.out)


class MediumStream(_Medium):
    """A resumable MEDIUM raw deflate: native's DefStream::pump over
    run_medium (native/zrs_native.cpp:2107-2150), step by step, the plain
    version of DS at MEDIUM4-6 (ops/kernels/dstream_kernel.py).

    `pump(data, flush)` appends `data` and scans to native's limit: under
    NO_FLUSH (0) the positions with at least MIN_LOOKAHEAD - 1 bytes after
    them, under a flush all. A flush then ends the block: SYNC (2) and
    FULL (3) flush it (when it holds a symbol or a byte) and write the sync
    seam; FULL also restarts the window at position 0 but, as native, keeps
    head4, prevd4 and the carried next match (a stale head's delta wraps in
    its uint16 slot, and every candidate's bytes are compared, so the
    matches stay inside the new window). FINISH (4) writes the last block
    and aligns. Native has no trailing literal at MEDIUM, and its `insert`
    (insert_pending, retro_insert) feeds only the 3-byte chain, which MEDIUM
    never reads, so neither appears here. After each pump the data is
    pruned as native prunes it: once a multiple of WSIZE of at least 1 MiB
    lies before both the match window and the unflushed block, it goes,
    and head4 and the next match are rebased (prevd4 holds deltas). The
    bytes gather in `pending`; dstream_kernel.Plain hands them out at
    native's commit points."""

    PRUNE = 1 << 20  # bytes of dead data before the buffer is pruned (native's)

    def __init__(self, level: int):
        if level not in _KNOBS:
            raise ValueError("medium level must be 4, 5, or 6")
        super().__init__(bytearray(), _KNOBS[level], 0)
        self.pending = self.out
        self.finished = False

    def pump(self, data: bytes, flush: int) -> None:
        if self.finished:
            raise RuntimeError("native deflate stream misuse")
        self.data += data
        total = len(self.data)
        if flush:
            limit = total
        else:
            limit = total - (MIN_LOOKAHEAD - 1) if total >= MIN_LOOKAHEAD else 0
        self.scan(limit)
        if flush == 4:
            self.flush_block(total, True)
            self.bw.align()
            self.finished = True
        elif flush:
            if self.sym_dist or self.block_start < total:
                self.flush_block(total, False)
            _seam(self.bw, self.out)
            if flush == 3:
                del self.data[:]
                self.spos = self.block_start = 0
        self._prune()

    def _prune(self) -> None:
        spos = self.spos
        keep = min(spos - WSIZE if spos > WSIZE else 0, self.block_start) & ~(WSIZE - 1)
        if keep < self.PRUNE:
            return
        del self.data[:keep]
        self.spos -= keep
        self.block_start -= keep
        self.head4 = [h - keep if h > keep else 0 for h in self.head4]
        if self.med_next is not None:
            nm = self.med_next
            nm[:3] = [x - keep if x > keep else 0 for x in nm[:3]]


def _seam(bw: BitWriter, out: bytearray) -> None:
    """Close a non-final chunk: an empty stored block, byte aligned."""
    bw.send_bits(0, 3)
    bw.align()
    out.extend(b"\x00\x00\xff\xff")


def _primed(data: bytes, dictionary) -> tuple[bytes, int]:
    """The dictionary's last 32 KiB followed by the input, and its length."""
    d = bytes(dictionary[-WSIZE:]) if dictionary else b""
    return d + bytes(data), len(d)


def compress_medium(data: bytes, level: int = 6, final: bool = True,
                    dictionary: bytes | None = None) -> bytes:
    """MEDIUM-mode raw deflate of one chunk (host mirror of native's
    deflate_chunk(data, MEDIUM_BASE + level - 4, final, dictionary)).
    level in {4,5,6}; a chunk that is not final ends in a sync seam; the
    dictionary's last 32 KiB prime the 4-byte-hash chains."""
    if level not in _KNOBS:
        raise ValueError("medium level must be 4, 5, or 6")
    buf, dict_len = _primed(data, dictionary)
    return _Medium(buf, _KNOBS[level], dict_len).run(final)


# ---------------------------------------------------------------------------
# The QUICK mode (the deflate_quick class: a single 4-byte-hash probe per
# position, matches >= 4 emitted inside the scan loop, match interiors
# never inserted), as the reference's native engine realizes it.
# ---------------------------------------------------------------------------

from .trees import STATIC_LL_LEN, STATIC_LL_CODE, STATIC_D_LEN, STATIC_D_CODE
from ..ops import huffman as _H


def compress_quick(data: bytes, final: bool = True, dictionary: bytes | None = None) -> bytes:
    """The adaptive QUICK mode: a single 4-byte-hash probe per position,
    each ~48 KiB segment its own block whose trees come from the PREVIOUS
    segment's histogram (+1 smoothing on every symbol), segment 0 static,
    expanded segments rewound to stored. Byte-identical to the reference's
    compress_quick (tests/test_torch_medium.py); the dictionary's last 32
    KiB prime the chains as native's deflate_chunk(data, QUICK, final,
    dictionary) does."""
    import numpy as np

    from .trees import (
        _TreeBuild,
        _scan_tree,
        _send_tree,
        BL_ORDER,
        EXTRA_BLBITS,
        EXTRA_DBITS,
        EXTRA_LBITS,
        LITERALS,
    )
    from ..config import BL_CODES, D_CODES, L_CODES, MAX_BITS, MAX_BL_BITS

    data, dict_len = _primed(data, dictionary)
    total = len(data)
    out = bytearray()
    bw = BitWriter(out)
    head4 = [0] * (1 << 16)
    prevd4 = [0] * WSIZE

    def hash4(pos):
        v = int.from_bytes(data[pos : pos + 4], "little")
        return ((v * 2654435761) & 0xFFFFFFFF) >> 16

    for i in range(dict_len - 3):  # native's priming: every 4-byte string
        h = hash4(i)
        prevd4[i & (WSIZE - 1)] = min(i - head4[h], 0xFFFF)
        head4[h] = i

    def close(final_flag):
        if final_flag:
            bw.align()
            return bytes(out)
        _seam(bw, out)
        return bytes(out)

    QSEG = 49152
    if total == dict_len:
        bw.send_bits((1 << 1) + (1 if final else 0), 3)
        bw.send_bits(int(STATIC_LL_CODE[256]), int(STATIC_LL_LEN[256]))
        return close(final)

    llf_prev = None
    df_prev = None
    final_emitted = False
    pos = dict_len
    while pos < total:
        seg_start = pos
        seg_end = min(pos + QSEG, total)
        seg_last_possible = final and seg_end == total
        snap_len, snap_buf, snap_cnt = len(out), bw.bitbuf, bw.bitcnt
        if llf_prev is not None:
            llf_s = llf_prev + 1
            df_s = df_prev + 1
            tb = _TreeBuild()
            lll, llc, l_max = tb.build_tree(
                llf_s, L_CODES, STATIC_LL_LEN, EXTRA_LBITS, LITERALS + 1,
                MAX_BITS,
            )
            dl, dcod, d_max = tb.build_tree(
                df_s, D_CODES, STATIC_D_LEN, EXTRA_DBITS, 0, MAX_BITS
            )
            bl_freq = np.zeros(BL_CODES, np.int64)
            _scan_tree(lll, l_max, bl_freq)
            _scan_tree(dl, d_max, bl_freq)
            bl_len, bl_code, _ = tb.build_tree(
                bl_freq, BL_CODES, None, EXTRA_BLBITS, 0, MAX_BL_BITS
            )
            max_blindex = BL_CODES - 1
            while max_blindex >= 3 and bl_len[BL_ORDER[max_blindex]] == 0:
                max_blindex -= 1
            bw.send_bits((2 << 1) + (1 if seg_last_possible else 0), 3)
            bw.send_bits(l_max + 1 - 257, 5)
            bw.send_bits(d_max + 1 - 1, 5)
            bw.send_bits(max_blindex + 1 - 4, 4)
            for i in range(max_blindex + 1):
                bw.send_bits(int(bl_len[BL_ORDER[i]]), 3)
            _send_tree(bw, lll, l_max, bl_len, bl_code)
            _send_tree(bw, dl, d_max, bl_len, bl_code)
        else:
            bw.send_bits((1 << 1) + (1 if seg_last_possible else 0), 3)
            lll, llc = STATIC_LL_LEN, STATIC_LL_CODE
            dl, dcod = STATIC_D_LEN, STATIC_D_CODE
        llf_cur = np.zeros(L_CODES, np.int64)
        df_cur = np.zeros(D_CODES, np.int64)
        while pos < seg_end:
            if pos + 4 <= total:
                h = hash4(pos)
                delta = pos - head4[h]
                prevd4[pos & (WSIZE - 1)] = min(delta, 0xFFFF)
                head4[h] = pos
                d = prevd4[pos & (WSIZE - 1)]
                cand = pos - d if d else 0
                if cand > 0 and pos - cand <= MAX_DIST:
                    ml = 0
                    while ml < MAX_MATCH:
                        a = data[pos + ml] if pos + ml < total else 0
                        b = data[cand + ml] if cand + ml < total else 0
                        if a != b:
                            break
                        ml += 1
                    ml = min(ml, total - pos)
                    if ml >= 4:
                        dist = pos - cand
                        lc = int(_H.LENGTH_CODE[ml - MIN_MATCH])
                        sym = 257 + lc
                        bw.send_bits(int(llc[sym]), int(lll[sym]))
                        lbase = int(_H.LENGTH_BASE[lc])
                        lext = int(_H.LENGTH_EXTRA[lc])
                        if lext:
                            bw.send_bits(ml - lbase, lext)
                        dd = dist - 1
                        dc = int(
                            _H.DIST_CODE[dd]
                            if dd < 256
                            else _H.DIST_CODE[256 + (dd >> 7)]
                        )
                        bw.send_bits(int(dcod[dc]), int(dl[dc]))
                        dext = int(_H.DIST_EXTRA[dc])
                        if dext:
                            bw.send_bits(dist - int(_H.DIST_BASE[dc]), dext)
                        llf_cur[sym] += 1
                        df_cur[dc] += 1
                        pos += ml
                        continue
            c = data[pos]
            bw.send_bits(int(llc[c]), int(lll[c]))
            llf_cur[c] += 1
            pos += 1
        bw.send_bits(int(llc[256]), int(lll[256]))  # EOB
        llf_cur[256] += 1
        seg_bytes = pos - seg_start
        bits_used = (len(out) * 8 + bw.bitcnt) - (snap_len * 8 + snap_cnt)
        nstored = (seg_bytes + 65534) // 65535
        stored_bits = 7 + nstored * 40 + seg_bytes * 8
        is_seg_last = final and pos >= total
        if bits_used <= stored_bits:
            final_emitted |= seg_last_possible
        else:
            del out[snap_len:]
            bw.bitbuf = snap_buf
            bw.bitcnt = snap_cnt
            p = seg_start
            while p < pos:
                take = min(pos - p, 65535)
                lb = is_seg_last and p + take == pos
                bw.send_bits(1 if lb else 0, 3)
                bw.align()
                out.extend(
                    bytes(
                        [take & 0xFF, take >> 8,
                         (~take) & 0xFF, ((~take) >> 8) & 0xFF]
                    )
                )
                out.extend(data[p : p + take])
                p += take
                final_emitted |= lb
        llf_prev = llf_cur
        df_prev = df_cur
    if final and not final_emitted:
        bw.send_bits((1 << 1) + 1, 3)
        bw.send_bits(int(STATIC_LL_CODE[256]), int(STATIC_LL_LEN[256]))
    return close(final)
