"""zlib-exact per-block Huffman construction and block emission.

This module reproduces, decision-for-decision, the tree layer of classic
zlib (and therefore of the reference, whose output is pinned to zlib-ng's
zlib-compat mode — zlib-rs/src/deflate.rs:1926-2415, 2979-3124): the
frequency-heap tree build with its exact tie-breaking (freq, then node
depth, then heap order), the 15-bit overflow redistribution, canonical code
assignment, the code-length RLE (scan_tree/send_tree) with its max_count /
min_count state machine, the bit-length-tree build, and the cost-based
stored/static/dynamic block choice measured in whole output bytes.

The engine's north-star property (tests/test_bitexact.py) is that host
deflate output is byte-identical to the live zlib oracle at levels 1-9 for
every strategy; every rule here exists because the oracle's bitstream pins
it. Implemented from the DEFLATE algorithm's published structure (RFC 1951
+ zlib's documented tree construction), not by translating source.
"""

from __future__ import annotations

import numpy as np

from ..config import (
    BL_CODES,
    D_CODES,
    END_BLOCK,
    L_CODES,
    MAX_BITS,
    MAX_BL_BITS,
    MIN_MATCH,
    Strategy,
)
from ..ops import huffman as H

HEAP_SIZE = 2 * L_CODES + 1
LITERALS = 256
REP_3_6 = 16
REPZ_3_10 = 17
REPZ_11_138 = 18

EXTRA_LBITS = H.LENGTH_EXTRA.astype(np.int64)  # 29 entries
EXTRA_DBITS = H.DIST_EXTRA.astype(np.int64)  # 30 entries
EXTRA_BLBITS = np.array([0] * 16 + [2, 3, 7], np.int64)
BL_ORDER = H.CL_ORDER

# static literal/length tree: 288 codes (285..287 never used but coded)
STATIC_LL_LEN = np.array([8] * 144 + [9] * 112 + [7] * 24 + [8] * 8, np.int64)
STATIC_D_LEN = np.array([5] * 30, np.int64)


def _bi_reverse(code: int, length: int) -> int:
    res = 0
    for _ in range(length):
        res = (res << 1) | (code & 1)
        code >>= 1
    return res


def _static_codes(lengths: np.ndarray) -> np.ndarray:
    """Canonical codes (already bit-reversed for LSB-first emission)."""
    bl_count = np.bincount(lengths, minlength=MAX_BITS + 1)
    bl_count[0] = 0
    next_code = np.zeros(MAX_BITS + 2, np.int64)
    code = 0
    for bits in range(1, MAX_BITS + 1):
        code = (code + int(bl_count[bits - 1])) << 1
        next_code[bits] = code
    out = np.zeros(len(lengths), np.int64)
    nxt = next_code.copy()
    for n, ln in enumerate(lengths):
        if ln:
            out[n] = _bi_reverse(int(nxt[ln]), int(ln))
            nxt[ln] += 1
    return out


STATIC_LL_CODE = _static_codes(STATIC_LL_LEN)
STATIC_D_CODE = _static_codes(STATIC_D_LEN)


class _TreeBuild:
    """One block's tree construction state: shared opt_len/static_len
    accumulators across the litlen, dist, and bit-length tree builds
    (zlib keeps these on the deflate state; reference deflate.rs:2979+)."""

    def __init__(self) -> None:
        self.opt_len = 0  # bits, dynamic-tree encoding
        self.static_len = 0  # bits, static-tree encoding

    def build_tree(
        self,
        freq: np.ndarray,
        elems: int,
        stree_len: np.ndarray | None,
        extra: np.ndarray,
        extra_base: int,
        max_length: int,
    ) -> tuple[np.ndarray, np.ndarray, int]:
        """Return (code_lengths[elems], codes[elems], max_code).

        Exact semantics: frequency min-heap with tie-break on (freq, node
        depth <=), internal nodes numbered from `elems` upward, heap array
        doubling as the by-construction-order node list for gen_bitlen,
        overflow redistribution moving leaves to shorter sibling depths.
        """
        nnodes = 2 * elems + 1
        f = np.zeros(nnodes, np.int64)
        f[:elems] = freq[:elems]
        length = np.zeros(nnodes, np.int64)
        dad = np.zeros(nnodes, np.int64)
        depth = np.zeros(nnodes, np.int64)

        heap = [0] * (HEAP_SIZE + 1)
        heap_len = 0
        heap_max = HEAP_SIZE

        max_code = -1
        for n in range(elems):
            if f[n] != 0:
                heap_len += 1
                heap[heap_len] = n
                max_code = n
                depth[n] = 0
            else:
                length[n] = 0
        # ensure at least two non-zero codes (decoder requirement)
        while heap_len < 2:
            if max_code < 2:
                max_code += 1
                node = max_code
            else:
                node = 0
            heap_len += 1
            heap[heap_len] = node
            f[node] = 1
            depth[node] = 0
            self.opt_len -= 1
            if stree_len is not None:
                self.static_len -= int(stree_len[node])

        def smaller(a: int, b: int) -> bool:
            return f[a] < f[b] or (f[a] == f[b] and depth[a] <= depth[b])

        def downheap(k: int) -> None:
            v = heap[k]
            j = k << 1
            while j <= heap_len:
                if j < heap_len and smaller(heap[j + 1], heap[j]):
                    j += 1
                if smaller(v, heap[j]):
                    break
                heap[k] = heap[j]
                k = j
                j <<= 1
            heap[k] = v

        for k in range(heap_len // 2, 0, -1):
            downheap(k)

        node = elems
        while True:
            n = heap[1]
            heap[1] = heap[heap_len]
            heap_len -= 1
            downheap(1)
            m = heap[1]
            heap_max -= 1
            heap[heap_max] = n
            heap_max -= 1
            heap[heap_max] = m
            f[node] = f[n] + f[m]
            depth[node] = max(depth[n], depth[m]) + 1
            dad[n] = dad[m] = node
            heap[1] = node
            node += 1
            downheap(1)
            if heap_len < 2:
                break
        heap_max -= 1
        heap[heap_max] = heap[1]

        # gen_bitlen
        bl_count = np.zeros(MAX_BITS + 1, np.int64)
        length[heap[heap_max]] = 0  # root
        overflow = 0
        # stored node indices run heap_max .. HEAP_SIZE-1 (root at heap_max)
        for h in range(heap_max + 1, HEAP_SIZE):
            n = heap[h]
            bits = int(length[dad[n]]) + 1
            if bits > max_length:
                bits = max_length
                overflow += 1
            length[n] = bits
            if n > max_code:
                continue  # internal node
            bl_count[bits] += 1
            xbits = 0
            if n >= extra_base:
                xbits = int(extra[n - extra_base])
            fr = int(f[n])
            self.opt_len += fr * (bits + xbits)
            if stree_len is not None:
                self.static_len += fr * (int(stree_len[n]) + xbits)

        if overflow > 0:
            while overflow > 0:
                bits = max_length - 1
                while bl_count[bits] == 0:
                    bits -= 1
                bl_count[bits] -= 1
                bl_count[bits + 1] += 2
                bl_count[max_length] -= 1
                overflow -= 2
            h = HEAP_SIZE
            for bits in range(max_length, 0, -1):
                n = int(bl_count[bits])
                while n != 0:
                    h -= 1
                    m = heap[h]
                    if m > max_code:
                        continue
                    if length[m] != bits:
                        self.opt_len += (bits - int(length[m])) * int(f[m])
                        length[m] = bits
                    n -= 1

        # gen_codes
        codes = np.zeros(elems, np.int64)
        next_code = np.zeros(MAX_BITS + 1, np.int64)
        code = 0
        for bits in range(1, max_length + 1):
            code = (code + int(bl_count[bits - 1])) << 1
            next_code[bits] = code
        for n in range(max_code + 1):
            ln = int(length[n])
            if ln != 0:
                codes[n] = _bi_reverse(int(next_code[ln]), ln)
                next_code[ln] += 1
        return length[:elems], codes, max_code


def _scan_tree(lengths: np.ndarray, max_code: int, bl_freq: np.ndarray) -> None:
    """Count bl-alphabet symbol frequencies for one tree's length sequence,
    with zlib's exact run-coalescing state machine."""
    lens = list(lengths[: max_code + 1]) + [0xFFFF]  # guard
    prevlen = -1
    nextlen = int(lens[0])
    count = 0
    max_count = 138 if nextlen == 0 else 7
    min_count = 3 if nextlen == 0 else 4
    for n in range(max_code + 1):
        curlen = nextlen
        nextlen = int(lens[n + 1])
        count += 1
        if count < max_count and curlen == nextlen:
            continue
        elif count < min_count:
            bl_freq[curlen] += count
        elif curlen != 0:
            if curlen != prevlen:
                bl_freq[curlen] += 1
            bl_freq[REP_3_6] += 1
        elif count <= 10:
            bl_freq[REPZ_3_10] += 1
        else:
            bl_freq[REPZ_11_138] += 1
        count = 0
        prevlen = curlen
        if nextlen == 0:
            max_count, min_count = 138, 3
        elif curlen == nextlen:
            max_count, min_count = 6, 3
        else:
            max_count, min_count = 7, 4


def _send_tree(bw, lengths, max_code, bl_len, bl_code) -> None:
    """Emit one tree's length sequence through the bit-length tree; exact
    mirror of the scan pass."""
    lens = list(lengths[: max_code + 1]) + [0xFFFF]
    prevlen = -1
    nextlen = int(lens[0])
    count = 0
    max_count = 138 if nextlen == 0 else 7
    min_count = 3 if nextlen == 0 else 4
    for n in range(max_code + 1):
        curlen = nextlen
        nextlen = int(lens[n + 1])
        count += 1
        if count < max_count and curlen == nextlen:
            continue
        elif count < min_count:
            while True:
                bw.send_bits(int(bl_code[curlen]), int(bl_len[curlen]))
                count -= 1
                if count == 0:
                    break
        elif curlen != 0:
            if curlen != prevlen:
                bw.send_bits(int(bl_code[curlen]), int(bl_len[curlen]))
                count -= 1
            bw.send_bits(int(bl_code[REP_3_6]), int(bl_len[REP_3_6]))
            bw.send_bits(count - 3, 2)
        elif count <= 10:
            bw.send_bits(int(bl_code[REPZ_3_10]), int(bl_len[REPZ_3_10]))
            bw.send_bits(count - 3, 3)
        else:
            bw.send_bits(int(bl_code[REPZ_11_138]), int(bl_len[REPZ_11_138]))
            bw.send_bits(count - 11, 7)
        count = 0
        prevlen = curlen
        if nextlen == 0:
            max_count, min_count = 138, 3
        elif curlen == nextlen:
            max_count, min_count = 6, 3
        else:
            max_count, min_count = 7, 4


def _compress_block(bw, sym_dist, sym_lit, ll_len, ll_code, d_len, d_code) -> None:
    """Emit the symbol buffer with the given trees, then END_BLOCK."""
    LCODE = H.LENGTH_CODE
    LBASE = H.LENGTH_BASE
    LX = H.LENGTH_EXTRA
    DBASE = H.DIST_BASE
    DX = H.DIST_EXTRA
    DCODE = H.DIST_CODE
    send = bw.send_bits
    for dist, lit in zip(sym_dist, sym_lit):
        if dist == 0:
            send(int(ll_code[lit]), int(ll_len[lit]))
        else:
            # lit holds the actual match length (3..258)
            code = int(LCODE[lit - MIN_MATCH])
            sym = code + LITERALS + 1
            send(int(ll_code[sym]), int(ll_len[sym]))
            extra = int(LX[code])
            if extra:
                send(lit - int(LBASE[code]), extra)
            d = dist - 1
            dc = int(DCODE[d]) if d < 256 else int(DCODE[256 + (d >> 7)])
            send(int(d_code[dc]), int(d_len[dc]))
            extra = int(DX[dc])
            if extra:
                send(dist - int(DBASE[dc]), extra)
    send(int(ll_code[END_BLOCK]), int(ll_len[END_BLOCK]))


def flush_block(
    bw,
    pending: bytearray,
    sym_dist,
    sym_lit,
    block_bytes: bytes,
    last: bool,
    level: int,
    strategy: Strategy,
    stored_ok: bool = True,
) -> str:
    """zlib's _tr_flush_block: build trees, pick stored/static/dynamic by
    whole-byte cost, emit. Returns the chosen kind for observability.

    Reference semantics: zlib-rs/src/deflate.rs:2297-2415 zng_tr_flush_block
    (byte-identical block choice in zlib-compat mode)."""
    stored_len = len(block_bytes)

    if level > 0:
        ll_freq = np.zeros(L_CODES, np.int64)
        d_freq = np.zeros(D_CODES, np.int64)
        ll_freq[END_BLOCK] = 1
        sd = np.asarray(sym_dist, np.int64) if sym_dist else np.zeros(0, np.int64)
        sl = np.asarray(sym_lit, np.int64) if sym_lit else np.zeros(0, np.int64)
        if sd.shape[0]:
            litm = sd == 0
            if litm.any():
                ll_freq[:256] += np.bincount(sl[litm], minlength=256)[:256]
            mm = ~litm
            if mm.any():
                lcs = H.LENGTH_CODE[sl[mm] - MIN_MATCH] + LITERALS + 1
                ll_freq += np.bincount(lcs, minlength=L_CODES)[:L_CODES]
                dd = sd[mm] - 1
                dcs = np.where(dd < 256, H.DIST_CODE[np.minimum(dd, 255)], H.DIST_CODE[256 + (dd >> 7)])
                d_freq += np.bincount(dcs, minlength=D_CODES)[:D_CODES]

        tb = _TreeBuild()
        ll_len, ll_code, l_max = tb.build_tree(
            ll_freq, L_CODES, STATIC_LL_LEN, EXTRA_LBITS, LITERALS + 1, MAX_BITS
        )
        d_len, d_code, d_max = tb.build_tree(
            d_freq, D_CODES, STATIC_D_LEN, EXTRA_DBITS, 0, MAX_BITS
        )
        # bit-length tree over both scanned sequences
        bl_freq = np.zeros(BL_CODES, np.int64)
        _scan_tree(ll_len, l_max, bl_freq)
        _scan_tree(d_len, d_max, bl_freq)
        bl_len, bl_code, _ = tb.build_tree(
            bl_freq, BL_CODES, None, EXTRA_BLBITS, 0, MAX_BL_BITS
        )
        max_blindex = BL_CODES - 1
        while max_blindex >= 3 and bl_len[BL_ORDER[max_blindex]] == 0:
            max_blindex -= 1
        tb.opt_len += 3 * (max_blindex + 1) + 5 + 5 + 4

        opt_lenb = (tb.opt_len + 3 + 7) >> 3
        static_lenb = (tb.static_len + 3 + 7) >> 3
        if static_lenb <= opt_lenb:
            opt_lenb = static_lenb
    else:
        opt_lenb = static_lenb = stored_len + 5

    if stored_len + 4 <= opt_lenb and stored_ok:
        # stored wins (also the level-0 path); requires whole bytes on
        # hand — stored_ok=False models zlib's buf==NULL case: the block
        # spans a window slide, so the REAL zlib no longer has its bytes
        # and emits static/dynamic even though stored is cheaper
        # (zng_tr_flush_block, deflate.rs:2367-2402)
        assert stored_len <= 0xFFFF or level == 0
        _emit_stored(bw, pending, block_bytes, last)
        return "stored"
    elif strategy == Strategy.Fixed or static_lenb == opt_lenb:
        bw.send_bits((1 << 1) + (1 if last else 0), 3)
        _compress_block(
            bw, sym_dist, sym_lit, STATIC_LL_LEN, STATIC_LL_CODE, STATIC_D_LEN, STATIC_D_CODE
        )
        return "static"
    else:
        bw.send_bits((2 << 1) + (1 if last else 0), 3)
        # send_all_trees
        bw.send_bits(l_max + 1 - 257, 5)
        bw.send_bits(d_max + 1 - 1, 5)
        bw.send_bits(max_blindex + 1 - 4, 4)
        for i in range(max_blindex + 1):
            bw.send_bits(int(bl_len[BL_ORDER[i]]), 3)
        _send_tree(bw, ll_len, l_max, bl_len, bl_code)
        _send_tree(bw, d_len, d_max, bl_len, bl_code)
        _compress_block(bw, sym_dist, sym_lit, ll_len, ll_code, d_len, d_code)
        return "dynamic"


def _emit_stored(bw, pending: bytearray, data: bytes, last: bool) -> None:
    """_tr_stored_block: 3-bit header, align, LEN/NLEN, raw copy. Splits
    blocks over 65535 bytes (zlib never produces them via the cost rule at
    levels 1-9; the level-0 driver passes <= 65535)."""
    if not data:
        bw.send_bits(1 if last else 0, 1)
        bw.send_bits(0, 2)
        bw.align()
        pending.extend(b"\x00\x00\xff\xff")
        return
    i = 0
    while i < len(data):
        take = min(len(data) - i, 0xFFFF)
        is_last = last and (i + take == len(data))
        bw.send_bits(1 if is_last else 0, 1)
        bw.send_bits(0, 2)
        bw.align()
        pending.extend(
            bytes([take & 0xFF, (take >> 8) & 0xFF, ~take & 0xFF, (~take >> 8) & 0xFF])
        )
        pending.extend(data[i : i + take])
        i += take


def tr_align(bw) -> None:
    """_tr_align: empty static block + bi_flush (partial flush)."""
    bw.send_bits(1 << 1, 3)
    bw.send_bits(int(STATIC_LL_CODE[END_BLOCK]), int(STATIC_LL_LEN[END_BLOCK]))
    bw.flush_partial()
