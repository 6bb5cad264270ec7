"""One-shot convenience API: compress, compress_bound, decompress and
uncompress.

The counterpart of zlib_rs_tpu/models/oneshot.py. Where the reference
routes the common shapes through its C++ native engine
(`_try_native_compress`, `_try_native_decompress`), the port routes them
through the native engine's port on the card (`_try_card_compress`,
`_try_card_decompress`): a zlib, gzip or raw stream at the default
strategy and a level of 0-9 is one chunk of `parallel/chunk_deflate`
(EX, one warp); a well-formed zlib, gzip or raw stream decodes with
`parallel/speculative.inflate_speculative` at every size (its exact
SP2 decode from bit 0 below two segments), where the reference takes
its serial `inflate_raw` below 2 MiB: on the card that serial decode is
one warp (PERF.md, phase 42's sweep). `card_member` parses a gzip or
zlib container for both the one-shot route and the CLI's native decode.
Everything else takes the host engines (models/deflate.py,
models/inflate.py), as in the reference. `device=None` means the GPU and
raises without one; "cpu" runs the card routes through the kernels' plain
versions. Only a data fault (native's two messages, a checksum or ISIZE
mismatch, a truncated trailer) sends a decode to the host engine, which
then gives zlib's exact error; a build, launch or "no GPU" error
propagates.
"""

from __future__ import annotations

from ..config import (
    DeflateConfig,
    InflateConfig,
    InflateFlush,
    ReturnCode,
    Strategy,
    Z_DEFAULT_COMPRESSION,
)
from ..ops import checksum as _checksum
from . import deflate as _deflate
from . import inflate as _inflate

# a member's container faults on the card's routes: with a raw decode's
# data faults (speculative.DATA_FAULTS), what hands a stream to the host
# engine, which then gives zlib's exact error
MEMBER_FAULTS = ("incorrect data check", "incorrect length check", "need dictionary",
                 "not a gzip/zlib stream", "truncated gzip header", "truncated trailer")


def _deflate_config(config, level, window_bits, strategy) -> DeflateConfig:
    if config is not None:
        return config
    return DeflateConfig(
        level=level if level is not None else Z_DEFAULT_COMPRESSION,
        window_bits=window_bits,
        strategy=strategy,
    )


def wrap_raw(raw: bytes, data: bytes, window_bits: int, level: int) -> bytes:
    """The container around a raw deflate payload of `data`, as the
    reference's native routes write it: raw (-15), zlib (15; FLEVEL from
    the level) or gzip (31; XFL 2 at level 9, 4 below 2), with the port's
    host checksums."""
    if window_bits == -15:
        return raw
    if window_bits == 15:
        flevel = 0 if level < 2 else 1 if level < 6 else 2 if level == 6 else 3
        cmf = 0x78
        flg = flevel << 6
        flg |= (31 - (cmf * 256 + flg) % 31) % 31
        return bytes([cmf, flg]) + raw + _checksum.adler32(data).to_bytes(4, "big")
    # the XFL rule of the host engine's _emit_header: 2 = level 9, 4 = level < 2
    xfl = 2 if level == 9 else (4 if level < 2 else 0)
    hdr = bytes([0x1F, 0x8B, 8, 0, 0, 0, 0, 0, xfl, 3])
    tail = _checksum.crc32(data).to_bytes(4, "little") + (
        len(data) & 0xFFFFFFFF
    ).to_bytes(4, "little")
    return hdr + raw + tail


def _try_card_compress(data: bytes, level: int, window_bits: int, device):
    """The card's route for the common one-shot shapes (zlib, gzip or raw
    at the default strategy), the reference's `_try_native_compress` line
    for line: one EX chunk and native's headers. None for the host
    engine."""
    if window_bits not in (15, 31, -15):
        return None
    from ..parallel import chunk_deflate

    raw = chunk_deflate.deflate_chunk(data, level=level, final=True, device=device)
    return wrap_raw(raw, data, window_bits, level)


def compress(
    data: bytes,
    level: int | None = None,
    *,
    window_bits: int = 15,
    strategy: Strategy = Strategy.Default,
    config: DeflateConfig | None = None,
    device=None,
) -> bytes:
    """One-shot compress. Default output is a zlib stream (window_bits=15);
    use window_bits=31 for gzip, negative for raw deflate. Common shapes
    run on the card (`device`), anything else on the host engine."""
    if config is None and strategy == Strategy.Default:
        lvl = 6 if level is None or level == Z_DEFAULT_COMPRESSION else level
        if 0 <= lvl <= 9:
            fast = _try_card_compress(bytes(data), lvl, window_bits, device)
            if fast is not None:
                return fast
    return _deflate.compress(data, _deflate_config(config, level, window_bits, strategy))


def compress_bound(
    source_len: int,
    level: int | None = None,
    *,
    window_bits: int = 15,
    strategy: Strategy = Strategy.Default,
    config: DeflateConfig | None = None,
) -> int:
    """Worst-case compressed size (zlib's deflateBound)."""
    return _deflate.compress_bound(
        source_len, _deflate_config(config, level, window_bits, strategy)
    )


def gzip_header_end(data: bytes, pos: int = 0):
    """The offset past the gzip header at `pos`, or None where the header
    is cut short (the host engine gives the error)."""
    if len(data) < pos + 10:
        return None
    flg = data[pos + 3]
    i = pos + 10
    if flg & 0x04:
        i += 2 + int.from_bytes(data[i : i + 2], "little")
    for bit in (0x08, 0x10):
        if flg & bit:
            z = data.find(0, i)
            if z < 0:
                return None
            i = z + 1
    if flg & 0x02:
        i += 2
    return i if i <= len(data) else None


def card_inflate(payload: bytes, device) -> tuple[bytes, int]:
    """Raw inflate of `payload` on the card with growing output room (the
    reference's `grow`): (output, bytes consumed)."""
    from ..parallel import speculative

    cap = max(1 << 16, len(payload) * 4)
    while True:
        try:
            return speculative.inflate_speculative(payload, cap, device=device)
        except BufferError:
            cap *= 4


def is_data_fault(e: Exception) -> bool:
    """A data fault of the stream (a raw decode's two messages, a member's
    container fault), as opposed to an argument, build or launch error."""
    from ..parallel import speculative

    return isinstance(e, ValueError) and (
        str(e) in speculative.DATA_FAULTS or str(e) in MEMBER_FAULTS
    )


def _zlib_header(data: bytes, pos: int) -> bool:
    return (
        len(data) >= pos + 2
        and (data[pos] & 0x0F) == 8
        and (data[pos] >> 4) <= 7
        and ((data[pos] << 8) | data[pos + 1]) % 31 == 0
    )


def card_member(data: bytes, pos: int, device, *, gzip: bool = True,
                zlib: bool = True) -> tuple[bytes, int]:
    """The gzip (if `gzip`) or zlib (if `zlib`) member at `pos`: its header
    parsed on the host, its body inflated on the card, its trailer checked
    (crc32 and ISIZE, or adler32). (output, the offset past the trailer);
    a fault of the stream raises ValueError with one of MEMBER_FAULTS or
    a raw decode's data fault."""
    if gzip and data[pos : pos + 2] == b"\x1f\x8b":
        i = gzip_header_end(data, pos)
        if i is None:
            raise ValueError("truncated gzip header")
        out, used = card_inflate(data[i:], device)
        end = i + used
        if len(data) < end + 8:
            raise ValueError("truncated trailer")
        if _checksum.crc32(out) != int.from_bytes(data[end : end + 4], "little"):
            raise ValueError("incorrect data check")
        if int.from_bytes(data[end + 4 : end + 8], "little") != len(out) & 0xFFFFFFFF:
            raise ValueError("incorrect length check")
        return out, end + 8
    if zlib and _zlib_header(data, pos):
        if data[pos + 1] & 0x20:
            raise ValueError("need dictionary")  # the host's NeedDict path
        out, used = card_inflate(data[pos + 2 :], device)
        end = pos + 2 + used
        if len(data) < end + 4:
            raise ValueError("truncated trailer")
        if _checksum.adler32(out) != int.from_bytes(data[end : end + 4], "big"):
            raise ValueError("incorrect data check")
        return out, end + 4
    raise ValueError("not a gzip/zlib stream")


def _try_card_decompress(data: bytes, window_bits: int, device):
    """The card's route for well-formed zlib, gzip and raw inputs, the
    reference's `_try_native_decompress`: None on a fault of the stream
    (FDICT, a checksum or ISIZE mismatch, a truncated trailer, a corrupt
    body, another shape), so that the host engine supplies zlib's exact
    error."""
    try:
        if window_bits == -15:
            return card_inflate(data, device)[0]
        return card_member(data, 0, device, gzip=window_bits in (31, 47),
                           zlib=window_bits in (15, 47))[0]
    except ValueError as e:
        if is_data_fault(e):
            return None  # the host engine decides, with zlib's error
        raise


def decompress(
    data: bytes,
    *,
    window_bits: int = 47,  # auto-detect zlib/gzip by default
    config: InflateConfig | None = None,
    device=None,
) -> bytes:
    """One-shot decompress with zlib/gzip auto-detection by default; the
    first gzip member only, as zlib's inflate. Well-formed common inputs
    decode on the card (`device`); anything unusual (dictionaries,
    damage, odd window sizes) on the host engine, which owns the exact
    error behavior."""
    if config is None:
        fast = _try_card_decompress(bytes(data), window_bits, device)
        if fast is not None:
            return fast
    cfg = config if config is not None else InflateConfig(window_bits=window_bits)
    return _inflate.decompress(data, cfg)


def uncompress(data: bytes, *, window_bits: int = 15) -> tuple[ReturnCode, bytes]:
    """zlib-style uncompress: returns (ReturnCode, output) instead of raising."""
    inf = _inflate.Inflator(InflateConfig(window_bits=window_bits))
    ret, _consumed, out = inf.inflate(data, None, InflateFlush.FINISH)
    if ret == ReturnCode.StreamEnd:
        return ReturnCode.Ok, out
    if ret == ReturnCode.Ok:
        return ReturnCode.DataError, out  # truncated input
    return ret, out
