"""Host Huffman machinery (a copy of zlib_rs_tpu/ops/huffman.py): RFC
1951 constant tables, optimal length-limited code lengths
(package-merge), canonical codes, the code-length-code transmission order
and the two-level decode table of the host inflater (`inflate_table`).

All length/distance base+extra tables are derived from the RFC
construction rather than transcribed.
"""

from __future__ import annotations

import numpy as np

from ..config import BL_CODES, D_CODES, L_CODES, MAX_BITS, MAX_MATCH, MIN_MATCH
from ..utils.bits import bit_reverse

# ---------------------------------------------------------------------------
# RFC 1951 constant tables (derived, not transcribed)
# ---------------------------------------------------------------------------


def _build_length_tables():
    """Length codes 257..285: (base, extra) per RFC 1951 3.2.5.

    Codes are generated by the doubling construction: 8 codes of extra=0
    (lengths 3..10), then 4 groups of 4 codes with extra = 1,2,3,4,5, and the
    final code 285 for length 258 with extra=0.
    """
    base, extra = [], []
    length = 3
    # 8 single-length codes
    for _ in range(8):
        base.append(length)
        extra.append(0)
        length += 1
    # 5 groups of 4 codes with increasing extra bits
    for e in range(1, 6):
        for _ in range(4):
            base.append(length)
            extra.append(e)
            length += 1 << e
    # code 284 (base 227, extra 5) nominally covers up to 258, but length 258
    # has its own dedicated code 285 with no extra bits
    base.append(MAX_MATCH)
    extra.append(0)
    return np.array(base, np.int32), np.array(extra, np.int32)


LENGTH_BASE, LENGTH_EXTRA = _build_length_tables()  # 29 entries, codes 257..285


def _build_dist_tables():
    """Distance codes 0..29: (base, extra) per RFC 1951 3.2.5."""
    base, extra = [1, 2, 3, 4], [0, 0, 0, 0]
    dist = 5
    for e in range(1, 14):
        for _ in range(2):
            base.append(dist)
            extra.append(e)
            dist += 1 << e
    return np.array(base, np.int32), np.array(extra, np.int32)


DIST_BASE, DIST_EXTRA = _build_dist_tables()  # 30 entries


def _build_length_code_lut():
    """LUT: match length - 3 (0..255) -> length code index 0..28."""
    lut = np.zeros(256, np.int32)
    for code in range(28):
        lo = LENGTH_BASE[code] - 3
        hi = LENGTH_BASE[code + 1] - 3
        lut[lo:hi] = code
    lut[255] = 28  # length 258 -> code 285
    return lut


LENGTH_CODE = _build_length_code_lut()


def _build_dist_code_lut():
    """zlib-style 512-entry LUT: first 256 entries index by dist-1 for
    dist <= 256; second 256 entries index by (dist-1) >> 7 for dist > 256.
    (Same shape as the reference's DIST_CODE, trees_tbl.rs:95, but derived.)
    """
    lut = np.zeros(512, np.int32)
    for code in range(30):
        lo = DIST_BASE[code]
        hi = DIST_BASE[code + 1] if code < 29 else 32769
        if lo > 256:
            break
        lut[lo - 1 : min(hi, 257) - 1] = code
    for code in range(30):
        lo = DIST_BASE[code]
        hi = DIST_BASE[code + 1] if code < 29 else 32769
        for d in range(max(lo, 257), hi):
            lut[256 + ((d - 1) >> 7)] = code
    return lut


DIST_CODE = _build_dist_code_lut()


def dist_to_code(dist):
    """Vectorized distance -> distance code (dist in 1..32768)."""
    d = dist - 1
    return np.where(d < 256, DIST_CODE[np.minimum(d, 255)], DIST_CODE[256 + (d >> 7)])


# Order in which code-length-code lengths are transmitted (RFC 1951 3.2.7).
CL_ORDER = np.array(
    [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15], np.int32
)

# Fixed (static) trees, RFC 1951 3.2.6.
FIXED_LITLEN_LENGTHS = np.array([8] * 144 + [9] * 112 + [7] * 24 + [8] * 8, np.int32)
FIXED_DIST_LENGTHS = np.array([5] * 32, np.int32)


# ---------------------------------------------------------------------------
# Package-merge optimal length-limited code lengths
# ---------------------------------------------------------------------------


def huffman_code_lengths(freqs, max_bits: int) -> np.ndarray:
    """Optimal prefix-code lengths with length limit `max_bits` (package-merge).

    Returns int32[n] lengths; 0 for symbols with zero frequency. A single
    used symbol gets length 1 (DEFLATE requires at least one bit per code).

    Counterpart of the reference's build_tree + gen_bitlen overflow fix
    (deflate.rs:1926-2089), but optimal rather than heuristic.
    """
    freqs = np.asarray(freqs, np.int64)
    n = freqs.shape[0]
    lengths = np.zeros(n, np.int32)
    used = np.flatnonzero(freqs > 0)
    m = used.size
    if m == 0:
        return lengths
    if m == 1:
        lengths[used[0]] = 1
        return lengths
    if m > (1 << max_bits):
        raise ValueError("alphabet too large for bit limit")

    order = used[np.argsort(freqs[used], kind="stable")]
    leaf_vals = freqs[order]
    leaf_counts = np.zeros((m, n), np.int32)
    leaf_counts[np.arange(m), order] = 1

    vals = leaf_vals
    counts = leaf_counts
    for _level in range(2, max_bits + 1):
        k = vals.shape[0] // 2
        pvals = vals[0 : 2 * k : 2] + vals[1 : 2 * k : 2]
        pcounts = counts[0 : 2 * k : 2] + counts[1 : 2 * k : 2]
        vals = np.concatenate([leaf_vals, pvals])
        counts = np.concatenate([leaf_counts, pcounts])
        # stable sort => leaves (listed first) win ties: deterministic
        idx = np.argsort(vals, kind="stable")
        vals = vals[idx]
        counts = counts[idx]

    chosen = counts[: 2 * (m - 1)]
    return chosen.sum(axis=0).astype(np.int32)


def huffman_cost(freqs, lengths, extra=None) -> int:
    """Total encoded bits for symbols with the given code lengths."""
    freqs = np.asarray(freqs, np.int64)
    bits = np.asarray(lengths, np.int64)
    if extra is not None:
        bits = bits + np.asarray(extra, np.int64)
    return int((freqs * bits).sum())


# ---------------------------------------------------------------------------
# Canonical code assignment
# ---------------------------------------------------------------------------


def canonical_codes(lengths) -> tuple[np.ndarray, np.ndarray]:
    """Assign canonical Huffman codes from lengths (RFC 1951 3.2.2).

    Returns (codes_msb, codes_lsb): the canonical values and their
    bit-reversed forms ready for LSB-first bitstream packing. Symbols with
    length 0 get code 0. (Counterpart of gen_codes, deflate.rs:2090.)
    """
    lengths = np.asarray(lengths, np.int32)
    bl_count = np.bincount(lengths, minlength=MAX_BITS + 1)
    bl_count[0] = 0
    next_code = np.zeros(MAX_BITS + 2, np.int64)
    for l in range(1, MAX_BITS + 1):
        next_code[l] = (next_code[l - 1] + bl_count[l - 1]) << 1
    # rank of each symbol within its length class, in symbol order
    codes = np.zeros_like(lengths, dtype=np.int64)
    for l in range(1, MAX_BITS + 1):
        sel = lengths == l
        codes[sel] = next_code[l] + np.arange(sel.sum())
    codes_msb = codes.astype(np.uint32)
    codes_lsb = np.asarray(bit_reverse(codes_msb, np.maximum(lengths, 1))).astype(np.uint32)
    codes_lsb[lengths == 0] = 0
    return codes_msb, codes_lsb


# ---------------------------------------------------------------------------
# Decode tables (two-level LUT)
# ---------------------------------------------------------------------------

# Table entry encoding (uint32): kind<<28 | aux<<22 | nbits<<16 | payload
# kind: 0=literal (payload=byte), 1=match base (payload=base, aux=extra bits),
#       2=end-of-block, 3=subtable link (payload=offset, aux=index bits),
#       4=invalid
KIND_LITERAL = 0
KIND_MATCH = 1
KIND_EOB = 2
KIND_SUB = 3
KIND_INVALID = 4


def pack_entry(kind, aux, nbits, payload):
    return (int(kind) << 28) | (int(aux) << 22) | (int(nbits) << 16) | int(payload)


def unpack_entry(e):
    e = int(e)
    return (e >> 28) & 0xF, (e >> 22) & 0x3F, (e >> 16) & 0x3F, e & 0xFFFF


LENS = 0  # literal/length alphabet
DISTS = 1  # distance alphabet
CODES = 2  # code-length alphabet


def inflate_table(kind: int, lengths, root: int):
    """Build a two-level decode LUT from code lengths.

    Returns (table: uint32[...], root_bits, error: str | None). Mirrors the
    validation semantics of the reference's inflate_table
    (inflate/inftrees.rs:42-339): over-subscribed codes are an error; an
    incomplete code is an error except for a single-symbol LENS/DISTS code.

    The table layout: the first 2**root_bits entries are indexed by the low
    root_bits of the (LSB-first) bit buffer; KIND_SUB entries point at
    sub-tables appended after the root table, indexed by the next `aux` bits.
    """
    lengths = np.asarray(lengths, np.int64)
    n = lengths.shape[0]
    counts = np.bincount(lengths, minlength=MAX_BITS + 1)
    counts[0] = 0
    maxlen = int(np.max(lengths)) if np.any(lengths > 0) else 0

    if maxlen == 0:
        # no codes at all: only legal for DISTS (e.g. a stream with no
        # matches); the table is all-invalid so any distance lookup errors
        if kind != DISTS:
            return None, root, "incomplete code"
        root = 1
        table = np.full(2, pack_entry(KIND_INVALID, 0, 1, 0), np.uint32)
        return table, root, None

    minlen = int(np.min(np.flatnonzero(counts)))
    root = min(max(root, minlen), maxlen)

    # Kraft check
    left = 1
    over = False
    for l in range(1, MAX_BITS + 1):
        left = (left << 1) - int(counts[l])
        if left < 0:
            over = True
            break
    ncodes = int(counts.sum())
    if over:
        return None, root, "over-subscribed code"
    if left > 0 and (kind == CODES or ncodes != 1):
        return None, root, "incomplete code"

    codes_msb, codes_lsb = canonical_codes(lengths)

    if kind == LENS:
        # symbol -> (entry kind, aux, payload)
        def sym_entry(s, nbits):
            if s < 256:
                return pack_entry(KIND_LITERAL, 0, nbits, s)
            if s == 256:
                return pack_entry(KIND_EOB, 0, nbits, 0)
            c = s - 257
            if c >= 29:
                return pack_entry(KIND_INVALID, 0, nbits, 0)
            return pack_entry(KIND_MATCH, LENGTH_EXTRA[c], nbits, LENGTH_BASE[c])

    elif kind == DISTS:

        def sym_entry(s, nbits):
            if s >= 30:
                return pack_entry(KIND_INVALID, 0, nbits, 0)
            return pack_entry(KIND_MATCH, DIST_EXTRA[s], nbits, DIST_BASE[s])

    else:  # CODES: payload is the symbol itself

        def sym_entry(s, nbits):
            return pack_entry(KIND_LITERAL, 0, nbits, s)

    table = np.full(1 << root, pack_entry(KIND_INVALID, 0, root, 0), np.uint32)
    subtables: list[np.ndarray] = []
    sub_index: dict[int, tuple[int, int]] = {}  # low-root-bits -> (offset, bits)

    # group symbols with len > root by their low root bits to size sub-tables
    long_syms = np.flatnonzero(lengths > root)
    if long_syms.size:
        low = (codes_lsb[long_syms] & ((1 << root) - 1)).astype(np.int64)
        for prefix in np.unique(low):
            grp = long_syms[low == prefix]
            sub_bits = int(np.max(lengths[grp])) - root
            offset = (1 << root) + sum(t.size for t in subtables)
            subtables.append(
                np.full(1 << sub_bits, pack_entry(KIND_INVALID, 0, sub_bits, 0), np.uint32)
            )
            sub_index[int(prefix)] = (offset, sub_bits)
            table[prefix] = pack_entry(KIND_SUB, sub_bits, root, offset)

    full = np.concatenate([table] + subtables) if subtables else table

    for s in np.flatnonzero(lengths > 0):
        l = int(lengths[s])
        code = int(codes_lsb[s])
        if l <= root:
            entry = sym_entry(int(s), l)
            # fill all root-table slots whose low l bits equal the code
            step = 1 << l
            full[code : 1 << root : step] = entry
        else:
            prefix = code & ((1 << root) - 1)
            offset, sub_bits = sub_index[prefix]
            sub_code = code >> root
            entry = sym_entry(int(s), l - root)
            step = 1 << (l - root)
            idx = offset + np.arange(sub_code, 1 << sub_bits, step)
            full[idx] = entry

    return full, root, None


# Precomputed fixed-mode decode tables (counterpart of inffixed_tbl.rs).
FIXED_LITLEN_TABLE, FIXED_LITLEN_ROOT, _err1 = inflate_table(LENS, FIXED_LITLEN_LENGTHS, 9)
FIXED_DIST_TABLE, FIXED_DIST_ROOT, _err2 = inflate_table(DISTS, FIXED_DIST_LENGTHS, 5)
assert _err1 is None and _err2 is None

# Static encode tables (counterpart of STATIC_LTREE/STATIC_DTREE encodings).
STATIC_LITLEN_CODES_MSB, STATIC_LITLEN_CODES_LSB = canonical_codes(FIXED_LITLEN_LENGTHS)
STATIC_DIST_CODES_MSB, STATIC_DIST_CODES_LSB = canonical_codes(FIXED_DIST_LENGTHS)
