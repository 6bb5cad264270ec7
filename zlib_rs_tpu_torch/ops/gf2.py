"""CRC-32 over GF(2): the byte table of K7's plain version, the shifts of
K7's kernel (x^(8 n) and x^(-8 n) mod P), and zlib's `crc32_combine` for
the gzip trailer.

Polynomials are held reflected in 32 bits, bit 31 being x^0, as in zlib.
crc32(A + B) = crc32(A) * x^(8 len(B)) mod P ^ crc32(B), the product taken
carry-less mod P (zlib's multmodp and x2nmodp, the same form csrc/crc32.cu
uses). The reference, zlib_rs_tpu/ops/gf2.py, applies the same operator as
a packed 32x32 shift matrix.
"""

from __future__ import annotations

import numpy as np

CRC32_POLY = 0xEDB88320  # IEEE 802.3, reflected


def _make_crc_table() -> np.ndarray:
    """table[b]: the CRC register after byte b enters a zero register."""
    table = np.zeros(256, dtype=np.uint32)
    for b in range(256):
        c = b
        for _ in range(8):
            c = (c >> 1) ^ (CRC32_POLY if c & 1 else 0)
        table[b] = c
    return table


CRC_TABLE = _make_crc_table()


def multmodp(a: int, b: int) -> int:
    """a * b mod P for reflected a != 0 and b: zlib's multmodp."""
    m, p = 1 << 31, 0
    while True:
        if a & m:
            p ^= b
            if a & (m - 1) == 0:
                return p
        m >>= 1
        b = (b >> 1) ^ CRC32_POLY if b & 1 else b >> 1


def _x2n_table() -> list[int]:
    """x^(2^k) mod P for k in 0..31."""
    out = [1 << 30]  # x^1
    for _ in range(31):
        out.append(multmodp(out[-1], out[-1]))
    return out


X2N = _x2n_table()


def x8nmodp(n: int) -> int:
    """x^(8 n) mod P: the shift past n zero bytes."""
    p, k = 1 << 31, 3  # x^0; one byte is x^(2^3)
    while n:
        if n & 1:
            p = multmodp(X2N[k & 31], p)
        n >>= 1
        k += 1
    return p


# x^-1 mod P: x * (P - 1) / x = P - 1 = 1 mod P; reflected, P's bit for x^i
# moves to x^(i-1) and x^31 comes in
X_INV = ((CRC32_POLY << 1) & 0xFFFFFFFF) | 1


def xinv8nmodp(n: int) -> int:
    """x^(-8 n) mod P: undoes the shift past n zero bytes."""
    p, step = 1 << 31, 1 << 31
    for _ in range(8):
        step = multmodp(X_INV, step)
    for _ in range(n):
        p = multmodp(step, p)
    return p


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """crc32 of A + B from crc1 = crc32(A), crc2 = crc32(B) and len2 =
    len(B): zlib's crc32_combine."""
    return (multmodp(x8nmodp(int(len2)), int(crc1) & 0xFFFFFFFF) ^ int(crc2)) & 0xFFFFFFFF
