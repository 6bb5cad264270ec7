"""The stream engines on the card (a copy of zlib_rs_tpu/models/faststream.py
over the port's `native` handles).

Split of responsibilities: this module owns CONTAINER framing (zlib/gzip/
raw header and trailer parsing, wrap auto-detection, the dictionary
handshake, checksum verification), all resumable at arbitrary input
boundaries, on the host; the raw deflate body runs in a handle whose state
lives on the device: IS (`native.RawInflateStream`,
ops/kernels/istream_kernel.py) for the decoder, DS
(`native.RawDeflateStream`, ops/kernels/dstream_kernel.py) for the
compressor. Checksums and the FHCRC check use the host `ops/checksum`.

FastInflateEngine implements the pump contract of models.inflate.Inflator
(`inflate(data, out_budget, flush) -> (rc, consumed, out)`) and
FastDeflateEngine the Deflator subset the stream objects and gzip files
use, for the configurations `eligible`/`deflate_eligible` accept, so that
models.stream and models.gzfile route through them; the exact engines take
every other configuration. Both engines take `device` (None: the GPU,
resolved when the engine is made, so that it raises without one; "cpu":
IS's and DS's plain versions). Eligibility is the configuration's alone:
it never depends on whether a GPU exists, and no error of IS or DS sends
a stream to the exact engines.
"""

from __future__ import annotations

import os

from ..config import (
    InflateConfig,
    InflateFlush,
    ReturnCode,
    Wrap,
    decode_window_bits_inflate,
)
from .. import _device, native
from ..ops import checksum


_SUPPORTED_FLUSH = (
    InflateFlush.NO_FLUSH,
    InflateFlush.SYNC_FLUSH,
    InflateFlush.FINISH,
)


def native_route() -> bool:
    """The reference's switch: ZRS_NATIVE_STREAM=0 keeps every stream
    object and gzip file on the exact engines."""
    return os.environ.get("ZRS_NATIVE_STREAM") != "0"


def eligible(config: InflateConfig) -> bool:
    """True when IS can decode streams of this config with identical
    observable behavior: the window is the full 32 KiB (a smaller
    configured window must REJECT distant back-references, which IS does
    not track)."""
    wrap, wbits = decode_window_bits_inflate(config.window_bits)
    if wrap == Wrap.Raw:
        return wbits == 15
    return wbits in (0, 15)  # 0 = accept any header-declared size


class FastInflateEngine:
    """Resumable container-aware decoder over IS's raw-body handle."""

    # container states
    _HEAD = 0
    _DICT = 1
    _BODY = 2
    _TRAILER = 3
    _DONE = 4
    _BAD = 5

    def __init__(self, config: InflateConfig, device=None):
        self.device = _device.resolve_device(device)
        wrap, _wbits = decode_window_bits_inflate(config.window_bits)
        self.wrap = wrap
        self.detected_wrap = Wrap.Raw if wrap == Wrap.Raw else None
        self.total_in = 0
        self.total_out = 0
        self.msg: str | None = None
        self.data_type = 0
        self.dict_id = 0
        self.check = 1
        self._state = self._BODY if wrap == Wrap.Raw else self._HEAD
        self._raw = self._handle() if wrap == Wrap.Raw else None
        self._hbuf = bytearray()   # header/trailer accumulation
        self._gz_flg = 0
        self._gz_stage = 0         # sub-state inside the gzip header
        self._gz_need = 0
        self._pending_in = b""     # post-body tail bytes not yet parsed
        self.unused_tail = b""     # input beyond the member, after DONE
        self._more = False         # the handle has output queued
        self._gz_crc = 0           # crc32 over header bytes (FHCRC check)

    # -- helpers -----------------------------------------------------------

    def _handle(self, dictionary: bytes | None = None) -> "native.RawInflateStream":
        return native.RawInflateStream(dictionary, device=self.device)

    def _fail(self, msg: str) -> tuple[ReturnCode, int, bytes]:
        self._state = self._BAD
        self.msg = msg
        return ReturnCode.DataError, 0, b""

    def set_dictionary(self, dictionary: bytes) -> ReturnCode:
        if self.wrap == Wrap.Raw and self._raw is not None:
            # raw mode: allowed any time before body output begins
            self._raw = self._handle(dictionary)
            return ReturnCode.Ok
        if self._state != self._DICT:
            return ReturnCode.StreamError
        if checksum.adler32(dictionary) != self.dict_id:
            return ReturnCode.DataError
        self._raw = self._handle(dictionary)
        self._state = self._BODY
        return ReturnCode.Ok

    def copy(self) -> "FastInflateEngine":
        clone = object.__new__(FastInflateEngine)
        clone.__dict__ = dict(self.__dict__)
        clone._hbuf = bytearray(self._hbuf)
        if self._raw is not None:
            clone._raw = self._raw.copy()
        return clone

    def at_boundary(self) -> bool:
        return self._raw is not None and self._raw.at_boundary()

    @property
    def finished(self) -> bool:
        return self._state == self._DONE

    # -- the pump ----------------------------------------------------------

    def inflate(
        self,
        data: bytes,
        out_budget: int | None,
        flush: InflateFlush = InflateFlush.NO_FLUSH,
    ) -> tuple[ReturnCode, int, bytes]:
        if flush not in _SUPPORTED_FLUSH:
            return ReturnCode.StreamError, 0, b""
        if self._state == self._BAD:
            return ReturnCode.DataError, 0, b""
        if self._state == self._DONE:
            return ReturnCode.StreamEnd, 0, b""
        if self._state == self._DICT:
            return ReturnCode.NeedDict, 0, b""

        data = bytes(data)
        consumed = 0

        # ---- container header --------------------------------------------
        if self._state == self._HEAD:
            take = self._parse_header(data)
            if take < 0:
                return self._fail(self.msg or "incorrect header check")
            consumed += take
            data = data[take:]
            self.total_in += take
            if self._state == self._HEAD:
                return ReturnCode.Ok, consumed, b""  # need more header bytes
            if self._state == self._DICT:
                return ReturnCode.NeedDict, consumed, b""

        # ---- raw body through IS's handle ----------------------------------
        out = b""
        if self._state == self._BODY:
            fed = 0
            if self._more:
                # output from an earlier feed is still queued in the
                # handle: zlib would not consume fresh input while
                # avail_out blocks progress, so hold `data` back and
                # drain first (it stays unconsumed for the caller)
                out, self._more = self._raw.pump(b"", out_budget)
            else:
                feed = self._pending_in + data
                self._pending_in = b""
                fed = len(data)
                out, self._more = self._raw.pump(feed, out_budget)
                consumed += fed
                self.total_in += fed
            if self._raw.error:
                # the valid prefix decoded before the corruption is
                # served alongside the error, like zlib
                self.total_out += len(out)
                self._state = self._BAD
                self.msg = "invalid deflate data"
                return ReturnCode.DataError, consumed, out
            self.total_out += len(out)
            if out:
                if self.detected_wrap == Wrap.Gzip:
                    self.check = checksum.crc32(out, self.check)
                elif self.detected_wrap == Wrap.Zlib:
                    self.check = checksum.adler32(out, self.check)
            if self._raw.done:
                # input past the deflate body must NOT count as consumed
                # (consumed == len(data) would absorb the next member or
                # the trailer, breaking avail_in for concatenated-stream
                # consumers). The suffix of `data`
                # that landed in the tail is handed back; bytes over-fed
                # in EARLIER calls (already reported consumed then) go to
                # _pending_in, which later stages drain without counting.
                tail = self._raw.take_tail_all()
                from_data = min(len(tail), fed)
                if from_data:
                    consumed -= from_data
                    self.total_in -= from_data
                    data = data[len(data) - from_data:]
                else:
                    data = b""
                self._pending_in = tail[: len(tail) - from_data]
                self._state = self._TRAILER
                if self.detected_wrap == Wrap.Raw:
                    # the suffix of THIS call's data is already returned
                    # via `consumed`; only bytes over-fed in earlier calls
                    # need the unused_tail escape hatch
                    self.unused_tail = self._pending_in
                    self._pending_in = b""
                    self._state = self._DONE
                    return ReturnCode.StreamEnd, consumed, out
            else:
                return ReturnCode.Ok, consumed, out

        # ---- container trailer -------------------------------------------
        if self._state == self._TRAILER:
            need = 4 if self.detected_wrap == Wrap.Zlib else 8
            # fill from the stashed post-body tail first, then caller data
            if len(self._hbuf) < need and self._pending_in:
                take = min(need - len(self._hbuf), len(self._pending_in))
                self._hbuf.extend(self._pending_in[:take])
                self._pending_in = self._pending_in[take:]
            if len(self._hbuf) < need:
                take = min(need - len(self._hbuf), len(data))
                self._hbuf.extend(data[:take])
                consumed += take
                self.total_in += take
                data = data[take:]
            if len(self._hbuf) < need:
                if consumed or out:
                    return ReturnCode.Ok, consumed, out
                return ReturnCode.BufError, 0, out
            tr = bytes(self._hbuf[:need])
            del self._hbuf[:need]
            # bytes beyond the member (already absorbed input): gzfile's
            # multi-member loop picks these up via `unused_tail`
            self.unused_tail = self._pending_in
            self._pending_in = b""
            if self.detected_wrap == Wrap.Zlib:
                if int.from_bytes(tr, "big") != self.check:
                    self._state = self._BAD
                    self.msg = "incorrect data check"
                    return ReturnCode.DataError, consumed, out
            else:
                if int.from_bytes(tr[:4], "little") != self.check:
                    self._state = self._BAD
                    self.msg = "incorrect data check"
                    return ReturnCode.DataError, consumed, out
                if int.from_bytes(tr[4:], "little") != (
                    self.total_out & 0xFFFFFFFF
                ):
                    self._state = self._BAD
                    self.msg = "incorrect length check"
                    return ReturnCode.DataError, consumed, out
            self._state = self._DONE
            return ReturnCode.StreamEnd, consumed, out

        return ReturnCode.Ok, consumed, out

    # -- header parsing (resumable) ----------------------------------------

    def _parse_header(self, data: bytes) -> int:
        """Consume header bytes from `data`; returns count taken (state
        advances to _BODY/_DICT when the header completes) or -1 on a bad
        header. Mirrors models/inflate.py HEAD..HCRC semantics for the
        fields the fast path needs (full gz_header delivery stays on the
        exact engine — stream.Inflate de-opts when get_header() is used)."""
        taken = 0
        buf = self._hbuf
        # wrap sniff
        if self.detected_wrap is None:
            while len(buf) < 2 and taken < len(data):
                buf.append(data[taken])
                taken += 1
            if len(buf) < 2:
                return taken
            if buf[0] == 0x1F and buf[1] == 0x8B:
                if self.wrap in (Wrap.Gzip, Wrap.AutoDetect):
                    self.detected_wrap = Wrap.Gzip
                else:
                    self.msg = "incorrect header check"
                    return -1
            else:
                if self.wrap in (Wrap.Zlib, Wrap.AutoDetect):
                    self.detected_wrap = Wrap.Zlib
                else:
                    self.msg = "incorrect header check"
                    return -1

        if self.detected_wrap == Wrap.Zlib:
            while len(buf) < 2 and taken < len(data):
                buf.append(data[taken])
                taken += 1
            if len(buf) < 2:
                return taken
            cmf, flg = buf[0], buf[1]
            if ((cmf << 8) | flg) % 31 != 0:
                self.msg = "incorrect header check"
                return -1
            if (cmf & 0x0F) != 8:
                self.msg = "unknown compression method"
                return -1
            if (cmf >> 4) > 7:
                self.msg = "invalid window size"
                return -1
            if flg & 0x20:  # FDICT
                while len(buf) < 6 and taken < len(data):
                    buf.append(data[taken])
                    taken += 1
                if len(buf) < 6:
                    return taken
                self.dict_id = int.from_bytes(bytes(buf[2:6]), "big")
                buf.clear()
                self._state = self._DICT
                return taken
            buf.clear()
            self._raw = self._handle()
            self._state = self._BODY
            return taken

        # gzip: stage machine over (magic+static 10 bytes), extra, name,
        # comment, hcrc. When FHCRC is set, crc32 is folded over every
        # header byte as it is consumed and verified against the stored
        # crc16 — the exact engine and zlib both reject a corrupted header
        # here, so corruption detection does not depend on the engine.
        while True:
            if self._gz_stage == 0:
                while len(buf) < 10 and taken < len(data):
                    buf.append(data[taken])
                    taken += 1
                if len(buf) < 10:
                    return taken
                if buf[2] != 8:
                    self.msg = "unknown compression method"
                    return -1
                self._gz_flg = buf[3]
                if self._gz_flg & 0xE0:
                    self.msg = "unknown header flags set"
                    return -1
                if self._gz_flg & 0x02:
                    self._gz_crc = checksum.crc32(bytes(buf), 0)
                buf.clear()
                self._gz_stage = 1
            if self._gz_stage == 1:  # FEXTRA
                if self._gz_flg & 0x04:
                    while len(buf) < 2 and taken < len(data):
                        buf.append(data[taken])
                        taken += 1
                    if len(buf) < 2:
                        return taken
                    self._gz_need = buf[0] | (buf[1] << 8)
                    if self._gz_flg & 0x02:
                        self._gz_crc = checksum.crc32(bytes(buf), self._gz_crc)
                    buf.clear()
                    self._gz_stage = 2
                else:
                    self._gz_stage = 3
            if self._gz_stage == 2:  # extra payload
                skip = min(self._gz_need, len(data) - taken)
                if skip and self._gz_flg & 0x02:
                    self._gz_crc = checksum.crc32(
                        data[taken : taken + skip], self._gz_crc
                    )
                taken += skip
                self._gz_need -= skip
                if self._gz_need:
                    return taken
                self._gz_stage = 3
            if self._gz_stage == 3:  # FNAME
                if self._gz_flg & 0x08:
                    start = taken
                    while taken < len(data):
                        b = data[taken]
                        taken += 1
                        if b == 0:
                            self._gz_stage = 4
                            break
                    if self._gz_flg & 0x02 and taken > start:
                        self._gz_crc = checksum.crc32(
                            data[start:taken], self._gz_crc
                        )
                    if self._gz_stage != 4:
                        return taken
                else:
                    self._gz_stage = 4
            if self._gz_stage == 4:  # FCOMMENT
                if self._gz_flg & 0x10:
                    done = False
                    start = taken
                    while taken < len(data):
                        b = data[taken]
                        taken += 1
                        if b == 0:
                            done = True
                            break
                    if self._gz_flg & 0x02 and taken > start:
                        self._gz_crc = checksum.crc32(
                            data[start:taken], self._gz_crc
                        )
                    if not done:
                        return taken
                self._gz_stage = 5
            if self._gz_stage == 5:  # FHCRC
                if self._gz_flg & 0x02:
                    while len(buf) < 2 and taken < len(data):
                        buf.append(data[taken])
                        taken += 1
                    if len(buf) < 2:
                        return taken
                    stored = buf[0] | (buf[1] << 8)
                    buf.clear()
                    if stored != (self._gz_crc & 0xFFFF):
                        self.msg = "header crc mismatch"
                        return -1
                self.check = 0
                self._raw = self._handle()
                self._state = self._BODY
                return taken


# ---------------------------------------------------------------------------
# Streaming deflate fast path
# ---------------------------------------------------------------------------

def deflate_eligible(config) -> bool:
    """DS reproduces zlib byte-for-byte only for the default-strategy
    levels 1-9 at memLevel 8 with a 32 KiB window (EX's fixed
    configuration); everything else stays on the exact host engine."""
    from ..config import Strategy, decode_window_bits_deflate

    level = 6 if config.level == -1 else config.level
    if not (1 <= level <= 9):
        return False
    if config.strategy != Strategy.Default:
        return False
    if config.mem_level != 8:
        return False
    wrap, wbits = decode_window_bits_deflate(config.window_bits)
    return wbits == 15


class FastDeflateEngine:
    """Container-aware streaming compressor over DS's handle:
    byte-identical to the exact Deflator (and therefore to zlib) for
    NO_FLUSH / SYNC_FLUSH / FULL_FLUSH / FINISH pump scripts. Implements
    the Deflator pump subset models/stream.py Deflate and gzfile.py use:
    deflate() + take_output() + pending + totals + copy()."""

    def __init__(self, config, device=None):
        from ..config import DeflateFlush, Wrap, decode_window_bits_deflate

        self.device = _device.resolve_device(device)
        self._Flush = DeflateFlush
        self.config = config
        self.level = 6 if config.level == -1 else config.level
        wrap, wbits = decode_window_bits_deflate(config.window_bits)
        self.wrap = wrap
        self.wbits = wbits
        self._raw = native.RawDeflateStream(self.level, device=self.device)
        self.pending = bytearray()
        self.total_in = 0
        self.total_out = 0
        self.data_type = 2  # unknown (DS does not classify)
        self.finished = False
        self._header_emitted = False
        self._last_flush = -2  # zlib deflateResetKeep sentinel
        self.adler = 1
        self.crc = 0

    # -- container ----------------------------------------------------------

    def _emit_header(self) -> None:
        from ..config import Wrap

        if self.wrap == Wrap.Zlib:
            # mirrors models/deflate.py _emit_header (reference deflate.rs
            # header()) for the no-dictionary case
            cinfo = self.wbits - 8
            if self.level < 2:
                flevel = 0
            elif self.level < 6:
                flevel = 1
            elif self.level == 6:
                flevel = 2
            else:
                flevel = 3
            cmf = (cinfo << 4) | 8
            flg = flevel << 6
            rem = (cmf * 256 + flg) % 31
            if rem:
                flg += 31 - rem
            self.pending.extend(bytes([cmf, flg]))
        elif self.wrap == Wrap.Gzip:
            xfl = 2 if self.level == 9 else (4 if self.level < 2 else 0)
            hdr = bytearray([0x1F, 0x8B, 8, 0])
            hdr.extend(b"\x00\x00\x00\x00")  # mtime 0 (no gz_header set)
            hdr.append(xfl)
            hdr.append(3)  # OS: unix, like zlib with no header struct
            self.pending.extend(hdr)
        self._header_emitted = True

    # -- the pump (Deflator-compatible subset) ------------------------------

    def deflate(self, data: bytes, flush) -> "ReturnCode":
        from ..config import Wrap

        F = self._Flush
        if self.finished:
            if data:
                return ReturnCode.StreamError
            return ReturnCode.StreamEnd
        if flush not in (F.NO_FLUSH, F.SYNC_FLUSH, F.FULL_FLUSH, F.FINISH):
            return ReturnCode.StreamError  # caller de-opts before engaging
        data = bytes(data)
        # zlib's last_flush rank rule (mirrors models/deflate.py): repeated
        # empty flushes at or below the previous rank emit nothing
        from .deflate import _rank_flush

        old_flush = self._last_flush
        self._last_flush = int(flush)
        if (
            not data
            and not self.pending
            and _rank_flush(int(flush)) <= _rank_flush(old_flush)
            and flush != F.FINISH
        ):
            return ReturnCode.BufError
        if not self._header_emitted:
            self._emit_header()
        if data:
            self.total_in += len(data)
            if self.wrap == Wrap.Zlib:
                self.adler = checksum.adler32(data, self.adler)
            elif self.wrap == Wrap.Gzip:
                self.crc = checksum.crc32(data, self.crc)
        fl = {F.NO_FLUSH: 0, F.SYNC_FLUSH: 2, F.FULL_FLUSH: 3, F.FINISH: 4}[flush]
        self.pending.extend(self._raw.pump(data, fl))
        if flush == F.FINISH:
            if self.wrap == Wrap.Zlib:
                self.pending.extend(self.adler.to_bytes(4, "big"))
            elif self.wrap == Wrap.Gzip:
                self.pending.extend(self.crc.to_bytes(4, "little"))
                self.pending.extend(
                    (self.total_in & 0xFFFFFFFF).to_bytes(4, "little")
                )
            self.finished = True
            return ReturnCode.StreamEnd
        return ReturnCode.Ok

    def take_output(self, budget: int | None = None) -> bytes:
        if budget is None or budget >= len(self.pending):
            out = bytes(self.pending)
            self.pending.clear()
        else:
            out = bytes(self.pending[:budget])
            del self.pending[:budget]
        self.total_out += len(out)
        return out

    def copy(self) -> "FastDeflateEngine":
        clone = object.__new__(FastDeflateEngine)
        clone.__dict__ = dict(self.__dict__)
        clone.pending = bytearray(self.pending)
        clone._raw = self._raw.copy()
        return clone

    def migrate_to_exact(self):
        """Build an exact Deflator that continues this stream mid-flight.

        DS is drained to a byte-aligned seam (the 5-byte empty stored
        block a SYNC_FLUSH costs) and the live 32 KiB match window is
        carried over as primed history, so the exact-only APIs
        (deflateParams mid-stream, PARTIAL_FLUSH/BLOCK, prime,
        set_dictionary) keep working after the fast path engaged instead
        of raising StreamError. Output before and
        after the seam is valid zlib output; only the seam itself deviates
        from what a never-engaged exact stream would have emitted.
        """
        from .deflate import Deflator

        eng = Deflator(self.config)
        if not self._header_emitted:
            return eng  # nothing processed yet: fresh exact state
        if not self.finished:
            self.pending.extend(self._raw.pump(b"", 2))  # byte-align
        window = self._raw.window()
        eng.header_emitted = True
        eng.finished = self.finished
        eng.adler = self.adler
        eng.crc = self.crc
        eng.total_in = self.total_in
        eng.total_out = self.total_out
        eng.pending.extend(self.pending)
        if window and not self.finished:
            # prime the match window exactly like set_dictionary does
            # (positions become history, not emitted output)
            eng._append_input(window)
            eng.strstart = len(eng.buf)
            eng.block_start = eng.strstart
            eng.base = eng.strstart
            eng._insert_hashes_upto(eng.strstart)
        return eng

    def params(self, level: int, strategy=None) -> "ReturnCode":
        """deflateParams subset for the gz write path (gzsetparams,
        gz.rs:788 role): the caller has already sync-flushed, so swapping
        DS's handle at the byte-aligned seam yields a valid stream.
        Unlike zlib the fresh handle starts with an empty match window
        (slightly worse ratio for the next 32 KiB); non-default strategies
        and level 0 are not supported here — callers keep the exact engine
        for those."""
        from ..config import Strategy

        if strategy not in (None, Strategy.Default) or not (1 <= level <= 9):
            return ReturnCode.StreamError
        if level != self.level:
            self.level = level
            self._raw = native.RawDeflateStream(level, device=self.device)
        return ReturnCode.Ok
