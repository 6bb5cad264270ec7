"""zran-style index of a zlib/gzip/raw stream and random access through
it (a copy of zlib_rs_tpu/models/zran.py's `AccessPoint`, `DeflateIndex`,
`_wrapper_span` and the Python paths of `build_index` and `extract`).

One sequential pass of the host inflater records (input bit position,
32 KiB window) checkpoints at block boundaries; `decompress_foreign`
turns each into a window-primed region with a sub-byte start bit, so a
monolithic foreign stream decodes region-parallel on the card, and
`extract` seeks to the nearest checkpoint and decodes only the span it
needs on the host.

The reference's native index pass and region decoder (its C++ host
engine) are not carried: `build_index` and `extract` are the reference's
own branches for a build without them.
"""

from __future__ import annotations

import dataclasses

from ..config import InflateConfig, InflateFlush, ReturnCode
from .inflate import Inflator


@dataclasses.dataclass
class AccessPoint:
    out_offset: int  # uncompressed position of this checkpoint
    in_offset: int  # compressed BYTE offset to resume reading from
    bits: int  # sub-byte bit count to prime
    hold: int  # the unconsumed bit value to prime
    window: bytes  # last 32 KiB of output before this point


@dataclasses.dataclass
class DeflateIndex:
    points: list[AccessPoint]
    total_out: int
    wrapper_offset: int  # bytes of zlib/gzip header before deflate data

    def closest(self, offset: int) -> AccessPoint:
        best = self.points[0]
        for p in self.points:
            if p.out_offset <= offset:
                best = p
            else:
                break
        return best


def _wrapper_span(data: bytes) -> tuple[int, str]:
    """Return (header_length, kind) for a zlib/gzip/raw stream."""
    if len(data) >= 2 and data[:2] == b"\x1f\x8b":
        flg = data[3]
        pos = 10
        if flg & 0x04:  # FEXTRA
            xlen = int.from_bytes(data[pos : pos + 2], "little")
            pos += 2 + xlen
        if flg & 0x08:  # FNAME
            pos = data.index(0, pos) + 1
        if flg & 0x10:  # FCOMMENT
            pos = data.index(0, pos) + 1
        if flg & 0x02:  # FHCRC
            pos += 2
        return pos, "gzip"
    if (
        len(data) >= 2
        and (data[0] & 0x0F) == 8
        and ((data[0] << 8) | data[1]) % 31 == 0
    ):
        hdr = 2 + (4 if data[1] & 0x20 else 0)  # FDICT adds the dict id
        return hdr, "zlib"
    return 0, "raw"


def build_index(data: bytes, span: int = 1 << 20) -> DeflateIndex:
    """One sequential pass over a zlib/gzip/raw stream recording access
    points roughly every `span` uncompressed bytes (zran's build pass).

    The Python engine's pass: the host inflater stops at every block
    boundary (InflateFlush.BLOCK), and a boundary at least `span` bytes
    past the last point becomes a point.

    A raw stream (as `_wrapper_span` tells it) runs a raw inflater from a
    point at its start, so its points are those of the same body in a
    zlib wrapper, two bytes earlier: the reference's pass auto-detects
    zlib or gzip only and raises on a raw stream, which its native pass
    indexes."""
    raw = _wrapper_span(data)[1] == "raw"
    inf = Inflator(InflateConfig(window_bits=-15 if raw else 47))
    # a wrapped stream's first stop is its first block's start; a raw
    # inflater begins there and stops only after progress
    points: list[AccessPoint] = [AccessPoint(0, 0, 0, 0, b"")] if raw else []
    out_total = 0
    window = bytearray()
    pos = 0
    last_point_out = 0 if raw else None
    while True:
        rc, used, out = inf.inflate(data[pos:], None, InflateFlush.BLOCK)
        pos += used
        if out:
            out_total += len(out)
            window.extend(out)
            if len(window) > 32768:
                del window[: len(window) - 32768]
        if rc == ReturnCode.StreamEnd:
            break
        if rc not in (ReturnCode.Ok,):
            raise ValueError(inf.msg or f"index build failed: {rc}")
        # at a block boundary (mode TYPE) we can snapshot
        if inf.mode.name == "TYPE" and (
            last_point_out is None or out_total - last_point_out >= span
        ):
            points.append(
                AccessPoint(
                    out_offset=out_total,
                    in_offset=pos,
                    bits=inf.bits,
                    hold=inf.hold & ((1 << inf.bits) - 1),
                    window=bytes(window),
                )
            )
            last_point_out = out_total
        if used == 0 and not out:
            raise ValueError("no progress during index build")
    if not points:
        raise ValueError("stream too small to index (no block boundaries)")
    return DeflateIndex(points=points, total_out=out_total, wrapper_offset=0)


def extract(data: bytes, index: DeflateIndex, offset: int, length: int) -> bytes:
    """Read `length` uncompressed bytes starting at `offset` using the index
    (zran's extract pass: raw inflater + prime + dictionary + skip)."""
    if offset >= index.total_out:
        return b""
    point = index.closest(offset)
    if point.out_offset > offset:
        # before the first checkpoint: decode from the beginning
        inf = Inflator(InflateConfig(window_bits=47))
        start_in = 0
        produced = 0
    else:
        inf = Inflator(InflateConfig(window_bits=-15))
        inf.prime(point.bits, point.hold)
        if point.window:
            inf.set_dictionary(point.window)
        start_in = point.in_offset
        produced = point.out_offset
    skip = offset - produced
    out = bytearray()
    pos = start_in
    while len(out) < length:
        want = skip + (length - len(out))
        rc, used, chunk = inf.inflate(data[pos:], want, InflateFlush.NO_FLUSH)
        pos += used
        if chunk:
            if skip:
                drop = min(skip, len(chunk))
                chunk = chunk[drop:]
                skip -= drop
            out.extend(chunk)
        if rc == ReturnCode.StreamEnd:
            break
        if rc not in (ReturnCode.Ok,):
            raise ValueError(inf.msg or f"extract failed: {rc}")
        if used == 0 and not chunk:
            break
    return bytes(out[:length])
