"""Host Huffman helpers for the dynamic block header: optimal
length-limited code lengths (package-merge), canonical codes and the
code-length-code transmission order (RFC 1951 3.2.2, 3.2.7)."""

from __future__ import annotations

import numpy as np

from ..utils.bits import bit_reverse

MAX_BITS = 15

# Order in which code-length-code lengths are transmitted (RFC 1951 3.2.7).
CL_ORDER = np.array(
    [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15], np.int32
)


def huffman_code_lengths(freqs, max_bits: int) -> np.ndarray:
    """Optimal prefix-code lengths under the limit `max_bits`
    (package-merge). Zero-frequency symbols get 0; a single used symbol
    gets length 1 (DEFLATE needs at least one bit per code)."""
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


def canonical_codes(lengths) -> tuple[np.ndarray, np.ndarray]:
    """Canonical Huffman codes from lengths: (codes_msb, codes_lsb), the
    latter bit-reversed for LSB-first packing; length-0 symbols get 0."""
    lengths = np.asarray(lengths, np.int32)
    bl_count = np.bincount(lengths, minlength=MAX_BITS + 1)
    bl_count[0] = 0
    next_code = np.zeros(MAX_BITS + 2, np.int64)
    for l in range(1, MAX_BITS + 1):
        next_code[l] = (next_code[l - 1] + bl_count[l - 1]) << 1
    codes = np.zeros_like(lengths, dtype=np.int64)
    for l in range(1, MAX_BITS + 1):
        sel = lengths == l
        codes[sel] = next_code[l] + np.arange(sel.sum())
    codes_msb = codes.astype(np.uint32)
    codes_lsb = np.asarray(bit_reverse(codes_msb, np.maximum(lengths, 1))).astype(np.uint32)
    codes_lsb[lengths == 0] = 0
    return codes_msb, codes_lsb
