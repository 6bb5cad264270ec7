"""The configuration surface the port's encode path needs: wrapper kinds,
strategies and the deflate window-bits convention (zlib's encoding:
negative is raw deflate, 8..15 zlib, +16 gzip)."""

from __future__ import annotations

import enum

MAX_WBITS = 15


class Strategy(enum.IntEnum):
    """Compression strategies (zlib's Z_DEFAULT_STRATEGY .. Z_FIXED)."""

    Default = 0
    Filtered = 1
    HuffmanOnly = 2
    Rle = 3
    Fixed = 4


class Wrap(enum.IntEnum):
    Raw = 0
    Zlib = 1
    Gzip = 2


def decode_window_bits_deflate(window_bits: int) -> tuple[Wrap, int]:
    """Split a deflate windowBits argument into (wrap, wbits)."""
    if window_bits < 0:
        return Wrap.Raw, -window_bits
    if window_bits > MAX_WBITS:
        return Wrap.Gzip, window_bits - 16
    return Wrap.Zlib, window_bits
