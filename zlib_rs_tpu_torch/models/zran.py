"""zran-style index of a zlib/gzip/raw stream and random access through
it (a copy of zlib_rs_tpu/models/zran.py's `AccessPoint`, `DeflateIndex`,
`_wrapper_span`, `build_index` and `extract`).

`build_index` first runs the index pass on the card (`_build_index_card`,
the counterpart of the reference's `_build_index_native`: the speculative
decode of parallel/speculative.py records every block start, and a start
at least `span` output bytes past the last point becomes a point, with
its 32 KiB window cut from the full output). Where that pass returns None
(a data fault, a multi-member gzip, a container-checksum mismatch), the
host inflater's pass runs, as the reference's Python path does without
its native engine: it stops at every block boundary (InflateFlush.BLOCK).
`decompress_foreign` turns each point into a window-primed region with a
sub-byte start bit, so a monolithic foreign stream decodes
region-parallel on the card. `extract` seeks to the nearest point and
decodes the span it needs on K6 (`_extract_card`, the counterpart of
`_extract_native`), or on the host where that returns None.
"""

from __future__ import annotations

import dataclasses

from ..config import InflateConfig, InflateFlush, ReturnCode
from ..ops import checksum
from ..parallel import speculative
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


def build_index(data: bytes, span: int = 1 << 20, *, device=None) -> DeflateIndex:
    """One pass over a zlib/gzip/raw stream recording access points
    roughly every `span` uncompressed bytes (zran's build pass), on
    `device` (the GPU when None; "cpu" runs the plain versions).

    The card's pass (`_build_index_card`) covers single-member streams.
    Where it returns None, the Python engine's pass runs: the host
    inflater stops at every block boundary (InflateFlush.BLOCK), and a
    boundary at least `span` bytes past the last point becomes a point.

    A raw stream (as `_wrapper_span` tells it) runs a raw inflater from a
    point at its start, so its points are those of the same body in a
    zlib wrapper, two bytes earlier: the reference's pass auto-detects
    zlib or gzip only and raises on a raw stream, which its native pass
    indexes."""
    card_idx = _build_index_card(data, span, device)
    if card_idx is not None:
        return card_idx
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


def _build_index_card(data: bytes, span: int, device) -> DeflateIndex | None:
    """The reference's `_build_index_native`, line for line, over the
    card's `speculative.zran_index`: None on a data fault (native's two
    messages, `speculative.DATA_FAULTS`), a multi-member gzip or a
    container-checksum mismatch; a build, launch, argument or size-limit
    error propagates."""
    hdr, kind = _wrapper_span(data)
    body = data[hdr:]
    max_out = max(4 * len(body), 1 << 20)
    for _ in range(4):
        try:
            full, raw_points, in_used = speculative.zran_index(body, span, max_out, device=device)
            break
        except BufferError:
            max_out *= 4
        except ValueError as e:
            if str(e) not in speculative.DATA_FAULTS:
                raise
            return None
    else:
        return None
    # the pass decodes one member; a multi-member gzip has another magic
    # after this member's 8-byte trailer
    if kind == "gzip" and len(body) - in_used > 8:
        return None
    # verify the container checksum so a corrupt stream is not indexed
    if kind == "zlib":
        if checksum.adler32(full) != int.from_bytes(body[in_used : in_used + 4], "big"):
            return None
    elif kind == "gzip":
        if checksum.crc32(full) != int.from_bytes(body[in_used : in_used + 4], "little"):
            return None
    points = []
    for out_off, bitpos in raw_points:
        byte = bitpos >> 3
        sub = bitpos & 7
        if sub:
            points.append(
                AccessPoint(
                    out_offset=int(out_off),
                    in_offset=hdr + byte + 1,
                    bits=8 - sub,
                    hold=body[byte] >> sub,
                    window=full[max(0, out_off - 32768) : out_off],
                )
            )
        else:
            points.append(
                AccessPoint(
                    out_offset=int(out_off),
                    in_offset=hdr + byte,
                    bits=0,
                    hold=0,
                    window=full[max(0, out_off - 32768) : out_off],
                )
            )
    if not points:
        return None
    return DeflateIndex(points=points, total_out=len(full), wrapper_offset=hdr)


def _extract_card(data: bytes, index: DeflateIndex, offset: int, length: int,
                  device) -> bytes | None:
    """The reference's `_extract_native` over `speculative.inflate_region`
    (K6 in its stop mode): None on a data fault (`speculative.REGION_FAULT`);
    any other error propagates."""
    point = index.closest(offset)
    if point.out_offset > offset:
        hdr, _kind = _wrapper_span(data)
        start_in, skip_bits, window, produced = hdr, 0, b"", 0
    else:
        if point.bits:
            start_in = point.in_offset - 1
            skip_bits = 8 - point.bits
        else:
            start_in = point.in_offset
            skip_bits = 0
        window, produced = point.window, point.out_offset
    want = (offset - produced) + length
    try:
        out = speculative.inflate_region(data[start_in:], skip_bits, window, want, device=device)
    except ValueError as e:
        if str(e) != speculative.REGION_FAULT:
            raise
        return None
    return out[offset - produced : offset - produced + length]


def extract(data: bytes, index: DeflateIndex, offset: int, length: int, *,
            device=None) -> bytes:
    """Read `length` uncompressed bytes starting at `offset` using the index
    (zran's extract pass: raw inflater + prime + dictionary + skip), on K6
    on `device` (the GPU when None; "cpu" its plain version), or on the
    host where that faults."""
    if offset >= index.total_out:
        return b""
    fast = _extract_card(data, index, offset, length, device)
    if fast is not None:
        return fast
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
