"""CRC-32 over GF(2): the byte table of K7's plain version, the shifts of
K7's kernel (x^(8 n) and x^(-8 n) mod P), zlib's `crc32_combine` for the
gzip trailer, and the `crc32_combine_gen` / `crc32_combine_op` pair.

Polynomials are held reflected in 32 bits, bit 31 being x^0, as in zlib.
crc32(A + B) = crc32(A) * x^(8 len(B)) mod P ^ crc32(B), the product taken
carry-less mod P (zlib's multmodp and x2nmodp, the same form csrc/crc32.cu
uses). `crc32_combine_gen` returns the reference's operator, a packed
32x32 shift matrix (uint32 [32], column i the image of bit i), built as
zlib_rs_tpu/ops/gf2.py builds it, so that the arrays are equal.
"""

from __future__ import annotations

import functools

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


# ---------------------------------------------------------------------------
# packed GF(2) shift matrices: crc32_combine_gen / crc32_combine_op
# ---------------------------------------------------------------------------


def matrix_times_vec(mat: np.ndarray, vec: int) -> int:
    """Apply packed GF(2) matrix (uint32[32]) to a 32-bit vector."""
    vec = int(vec)
    out = 0
    i = 0
    while vec:
        if vec & 1:
            out ^= int(mat[i])
        vec >>= 1
        i += 1
    return out


def matrix_times_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Compose packed GF(2) matrices: result = a . b (apply b, then a)."""
    return np.array([matrix_times_vec(a, int(col)) for col in b], dtype=np.uint32)


def _shift_one_bit_matrix() -> np.ndarray:
    """Operator for one zero bit entering the (reflected) CRC register."""
    mat = np.zeros(32, dtype=np.uint32)
    mat[0] = CRC32_POLY  # e_0 -> poly (the bit shifted out feeds back)
    row = 1
    for i in range(1, 32):
        mat[i] = row  # e_i -> e_{i-1}
        row <<= 1
    return mat


@functools.lru_cache(maxsize=1)
def shift_byte_pow2() -> tuple[np.ndarray, ...]:
    """S8^(2^k) for k in 0..31, S8 the operator of one zero byte; built on
    first use."""
    s8 = _shift_one_bit_matrix()
    for _ in range(3):
        s8 = matrix_times_matrix(s8, s8)  # m^2, m^4, m^8
    powers = [s8]
    for _ in range(1, 32):
        powers.append(matrix_times_matrix(powers[-1], powers[-1]))
    return tuple(powers)


def shift_matrix_for_len(len2: int) -> np.ndarray:
    """Packed GF(2) matrix advancing a CRC past len2 zero bytes."""
    out = None
    k = 0
    len2 = int(len2)
    pow2 = shift_byte_pow2()
    while len2:
        if len2 & 1:
            p = pow2[k]
            out = p if out is None else matrix_times_matrix(p, out)
        len2 >>= 1
        k += 1
    if out is None:  # len2 == 0 -> identity
        return (np.uint32(1) << np.arange(32, dtype=np.uint32)).astype(np.uint32)
    return out


def crc32_combine_gen(len2: int) -> np.ndarray:
    """The length-shift operator of crc32_combine_op for a fixed len2
    (zlib's crc32_combine_gen): combining is then O(1) a pair."""
    return shift_matrix_for_len(len2)


def crc32_combine_op(crc1: int, crc2: int, op: np.ndarray) -> int:
    """crc32 of A + B from crc32(A), crc32(B) and crc32_combine_gen(len(B))."""
    return (matrix_times_vec(op, int(crc1)) ^ int(crc2)) & 0xFFFFFFFF
