"""zlib C-API compatibility helpers (a copy of zlib_rs_tpu/compat.py).

The Python-facing equivalents of the misc entry points zlib's C ABI
exports: zError, get_crc_table, zlibCompileFlags, adler32_z/crc32_z
aliases.
"""

from __future__ import annotations

from .config import ReturnCode
from .ops import checksum, gf2


def z_error(code: int) -> str:
    """zError: the message for a return code."""
    try:
        return ReturnCode(code).error_message
    except ValueError:
        return ""


zError = z_error


def get_crc_table() -> tuple[int, ...]:
    """get_crc_table: the classic 256-entry CRC-32 table, derived from the
    polynomial (ops/gf2.py)."""
    return tuple(int(x) for x in gf2.CRC_TABLE)


def zlib_compile_flags() -> int:
    """zlibCompileFlags.

    Bit layout per zlib.h: pairs of bits for sizeof(uInt), sizeof(uLong),
    sizeof(voidpf), sizeof(z_off_t) (1 => 32-bit, 2 => 64-bit), plus
    library capability bits. We report 32-bit uInt/uLong-equivalent ints,
    64-bit pointers/offsets, and no debug/asm flags.
    """
    return (1 << 0) | (1 << 2) | (2 << 4) | (2 << 6)


zlibCompileFlags = zlib_compile_flags

# size_t checksum aliases (adler32_z / crc32_z)
adler32_z = checksum.adler32
crc32_z = checksum.crc32
