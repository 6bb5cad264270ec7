"""Host bit writer and code-length RLE used to build dynamic block
headers (RFC 1951 3.2.7)."""

from __future__ import annotations

import numpy as np


class BitWriter:
    """LSB-first bit packer into a byte FIFO."""

    def __init__(self, out: bytearray):
        self.out = out
        self.bitbuf = 0
        self.bitcnt = 0

    def send_bits(self, value: int, nbits: int) -> None:
        self.bitbuf |= (int(value) & ((1 << nbits) - 1)) << self.bitcnt
        self.bitcnt += nbits
        while self.bitcnt >= 8:
            self.out.append(self.bitbuf & 0xFF)
            self.bitbuf >>= 8
            self.bitcnt -= 8


def _scan_code_lengths(lengths: np.ndarray):
    """RLE a tree's code-length sequence into bl-alphabet symbols.

    Returns a list of (symbol, extra_value, extra_bits): runs of the
    previous length use 16 (3-6 copies), runs of zero use 17 (3-10) or 18
    (11-138). Each tree is scanned on its own.
    """
    syms = []
    n = len(lengths)
    prevlen = -1
    i = 0
    while i < n:
        curlen = int(lengths[i])
        run = 1
        while i + run < n and int(lengths[i + run]) == curlen:
            run += 1
        count = run
        if curlen == 0:
            while count >= 11:
                take = min(count, 138)
                syms.append((18, take - 11, 7))
                count -= take
            if count >= 3:
                syms.append((17, count - 3, 3))
                count = 0
            for _ in range(count):
                syms.append((0, 0, 0))
        else:
            if prevlen != curlen:
                syms.append((curlen, 0, 0))
                count -= 1
            while count >= 3:
                take = min(count, 6)
                syms.append((16, take - 3, 2))
                count -= take
            for _ in range(count):
                syms.append((curlen, 0, 0))
        prevlen = curlen
        i += run
    return syms
