"""The configuration surface of the port: window-bits conventions, flush
modes, return codes, strategies, the level table and the deflate/inflate
parameter records of the host engines (a copy of zlib_rs_tpu/config.py).

Window-bits encoding follows zlib's convention:
  * negative  -> raw deflate (no header/trailer)
  * 8..=15    -> zlib wrapper (adler32)
  * +16       -> gzip wrapper (crc32)
  * +32       -> (inflate only) auto-detect zlib vs gzip
"""

from __future__ import annotations

import dataclasses
import enum

MIN_WBITS = 8
MAX_WBITS = 15
DEF_WBITS = MAX_WBITS
DEF_MEM_LEVEL = 8
MAX_MEM_LEVEL = 9
MIN_MATCH = 3
MAX_MATCH = 258
STD_MIN_MATCH = MIN_MATCH
STD_MAX_MATCH = MAX_MATCH
WANT_MIN_MATCH = 4  # the hash covers 4 bytes, like zlib-ng
MAX_DIST_EXTRA = 32768
Z_DEFLATED = 8
Z_DEFAULT_COMPRESSION = -1

# Huffman alphabet sizes (RFC 1951).
L_CODES = 286  # literal/length alphabet actually used
D_CODES = 30
BL_CODES = 19
MAX_BITS = 15
MAX_BL_BITS = 7
END_BLOCK = 256
HEAP_SIZE = 2 * L_CODES + 1

# inflate table-size bounds, same derivation as zlib's enough.c
# (reference: zlib-rs/src/lib.rs:78-92)
ENOUGH_LENS = 852 if False else 1332  # zlib-rs uses root=10 tables: 1332
ENOUGH_DISTS = 592
ENOUGH = ENOUGH_LENS + ENOUGH_DISTS


class DeflateFlush(enum.IntEnum):
    """Flush values accepted by deflate() (reference: zlib-rs/src/lib.rs:103-161)."""

    NO_FLUSH = 0
    PARTIAL_FLUSH = 1
    SYNC_FLUSH = 2
    FULL_FLUSH = 3
    FINISH = 4
    BLOCK = 5


class InflateFlush(enum.IntEnum):
    """Flush values accepted by inflate() (reference: zlib-rs/src/lib.rs:179-187)."""

    NO_FLUSH = 0
    SYNC_FLUSH = 2
    FINISH = 4
    BLOCK = 5
    TREES = 6


class ReturnCode(enum.IntEnum):
    """zlib return codes (reference: zlib-rs/src/lib.rs:214-275)."""

    Ok = 0
    StreamEnd = 1
    NeedDict = 2
    ErrNo = -1
    StreamError = -2
    DataError = -3
    MemError = -4
    BufError = -5
    VersionError = -6

    @property
    def error_message(self) -> str:
        return _ERROR_MESSAGES.get(int(self), "")


_ERROR_MESSAGES = {
    2: "need dictionary",
    1: "stream end",
    0: "",
    -1: "file error",
    -2: "stream error",
    -3: "data error",
    -4: "insufficient memory",
    -5: "buffer error",
    -6: "incompatible version",
}


class Strategy(enum.IntEnum):
    """Compression strategies (reference: zlib-rs/src/deflate.rs:217-245)."""

    Default = 0
    Filtered = 1
    HuffmanOnly = 2
    Rle = 3
    Fixed = 4


class Method(enum.IntEnum):
    Deflated = 8


class DataType(enum.IntEnum):
    """Value reported in stream.data_type (reference: deflate.rs:1505-1532)."""

    Binary = 0
    Text = 1
    Unknown = 2


@dataclasses.dataclass(frozen=True)
class Config:
    """Per-level match-finder tuning (reference: deflate/algorithm/mod.rs:69-82).

    good_length: reduce chain search budget above this match length
    max_lazy:    do not perform lazy search above this length
    nice_length: stop searching when a match of at least this length is found
    max_chain:   maximum hash-chain probes
    """

    good_length: int
    max_lazy: int
    nice_length: int
    max_chain: int
    func: str  # which block algorithm family: stored/quick/fast/medium/slow


# Level -> tuning. This is classic zlib's configuration_table (the live
# oracle our bit-exactness tests pin against): levels 1-3 use the greedy
# `fast` algorithm, 4-9 the lazy `slow` algorithm. The reference's zlib-ng
# table (deflate/algorithm/mod.rs:69-82) adds quick/medium families with
# different knobs; those are available to the device engines as tuning
# presets, but the host/native engines follow the oracle.
CONFIGURATION_TABLE: dict[int, Config] = {
    0: Config(0, 0, 0, 0, "stored"),
    1: Config(4, 4, 8, 4, "fast"),
    2: Config(4, 5, 16, 8, "fast"),
    3: Config(4, 6, 32, 32, "fast"),
    4: Config(4, 4, 16, 16, "slow"),
    5: Config(8, 16, 32, 32, "slow"),
    6: Config(8, 16, 128, 128, "slow"),
    7: Config(8, 32, 128, 256, "slow"),
    8: Config(32, 128, 258, 1024, "slow"),
    9: Config(32, 258, 258, 4096, "slow"),
}


class Wrap(enum.IntEnum):
    Raw = 0
    Zlib = 1
    Gzip = 2
    AutoDetect = 3  # inflate only


def decode_window_bits_deflate(window_bits: int) -> tuple[Wrap, int]:
    """Split a deflate windowBits argument into (wrap, wbits).

    Reference semantics: zlib-rs/src/deflate.rs:281-293.
    """
    if window_bits < 0:
        return Wrap.Raw, -window_bits
    if window_bits > MAX_WBITS:
        return Wrap.Gzip, window_bits - 16
    return Wrap.Zlib, window_bits


def decode_window_bits_inflate(window_bits: int) -> tuple[Wrap, int]:
    """Split an inflate windowBits argument into (wrap, wbits).

    Reference semantics: zlib-rs/src/inflate.rs:2303-2327. wbits==0 means
    "use the window size recorded in the zlib header" (up to 15); +32 enables
    zlib/gzip auto-detection.
    """
    if window_bits < 0:
        return Wrap.Raw, -window_bits
    if window_bits >= 48:
        return Wrap.AutoDetect, window_bits - 48
    if window_bits >= 32:
        return Wrap.AutoDetect, window_bits - 32
    if window_bits >= 16:
        return Wrap.Gzip, window_bits - 16
    return Wrap.Zlib, window_bits


@dataclasses.dataclass(frozen=True)
class DeflateConfig:
    """Mirror of zlib's deflateInit2 parameters (reference: deflate.rs:179-245)."""

    level: int = Z_DEFAULT_COMPRESSION
    method: Method = Method.Deflated
    window_bits: int = DEF_WBITS
    mem_level: int = DEF_MEM_LEVEL
    strategy: Strategy = Strategy.Default

    def normalized_level(self) -> int:
        return 6 if self.level == Z_DEFAULT_COMPRESSION else self.level

    def validate(self) -> ReturnCode:
        level = self.normalized_level()
        wrap, wbits = decode_window_bits_deflate(self.window_bits)
        if (
            not (0 <= level <= 9)
            or self.method != Method.Deflated
            or not (MIN_WBITS <= wbits <= MAX_WBITS)
            or not (1 <= self.mem_level <= MAX_MEM_LEVEL)
            or not (0 <= int(self.strategy) <= 4)
            or (self.window_bits == 8)  # zlib quirk: 8 is bumped to 9
        ):
            if self.window_bits == 8:
                return ReturnCode.Ok  # handled by bump, not an error
            return ReturnCode.StreamError
        return ReturnCode.Ok


@dataclasses.dataclass(frozen=True)
class InflateConfig:
    """Mirror of zlib's inflateInit2 parameter (reference: inflate.rs:2225)."""

    window_bits: int = DEF_WBITS


@dataclasses.dataclass(frozen=True)
class GzHeader:
    """gzip member header fields (reference: zlib-rs/src/c_api.rs gz_header)."""

    text: bool = False
    time: int = 0
    xflags: int = 0
    os: int = 255
    extra: bytes | None = None
    name: bytes | None = None
    comment: bytes | None = None
    hcrc: bool = False
    done: bool = False
