"""Bit-twiddling helpers shared by the Huffman and bitstream layers."""

from __future__ import annotations

import numpy as np


def bit_reverse(values, nbits):
    """Reverse the low `nbits` bits of each value (numpy).

    DEFLATE transmits Huffman codes most-significant-bit first while the
    byte stream is filled LSB-first, so canonical code values are
    bit-reversed before packing (RFC 1951 section 3.1.1).
    """
    v = np.asarray(values, dtype=np.uint32)
    r = np.zeros_like(v)
    for _ in range(16):  # max code length is 15
        r = (r << np.uint32(1)) | (v & np.uint32(1))
        v = v >> np.uint32(1)
    shift = (np.uint32(16) - np.asarray(nbits, np.uint32)).astype(np.uint32)
    return r >> shift
