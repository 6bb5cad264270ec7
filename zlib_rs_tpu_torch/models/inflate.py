"""Inflate: streaming DEFLATE/zlib/gzip decoder (host reference engine).

This is the framework's behavioral core for decompression — a resumable
state machine with the same observable semantics as the reference's
~30-state Mode enum + dispatch loop (zlib-rs/src/inflate.rs:288-320,
898-1845): zlib/gzip/raw framing, gzip header-field delivery, stored /
fixed / dynamic blocks, 32KB window back-references, checksum verification,
pause/resume at arbitrary input/output boundaries, sync scan, prime, mark,
copy, codes_used, undermine, validate.

Divergence note: for Block/Trees flush the reference returns every time the
state machine sits at a block boundary (inflate.rs:1278-1288); we stop at
boundaries only after making progress in the call, which keeps indexer-style
callers (zran) live-lock free with identical observable stop points.

A copy of zlib_rs_tpu/models/inflate.py, host code: the zran index pass
(models/zran.py) runs it; the device decodes live in parallel/.
"""

from __future__ import annotations

import copy as _copy
import enum

import numpy as np

from ..config import (
    DEF_WBITS,
    GzHeader,
    InflateConfig,
    InflateFlush,
    ReturnCode,
    Wrap,
    decode_window_bits_inflate,
)
from ..ops import checksum
from ..ops import huffman as H


class Mode(enum.IntEnum):
    HEAD = 0
    FLAGS = 1
    TIME = 2
    OS = 3
    EXLEN = 4
    EXTRA = 5
    NAME = 6
    COMMENT = 7
    HCRC = 8
    DICTID = 9
    DICT = 10
    TYPE = 11
    TYPEDO = 12
    STORED = 13
    COPY_ = 14
    TABLE = 15
    LENLENS = 16
    CODELENS = 17
    LEN = 18
    DIST = 19
    MATCH = 20
    CHECK = 21
    LENGTH = 22
    DONE = 23
    BAD = 24
    MEM = 25
    SYNC = 26


_REP_EXTRA = {16: 2, 17: 3, 18: 7}


class Inflator:
    """Resumable inflate engine over explicit (input, output-budget) calls."""

    def __init__(self, config: InflateConfig = InflateConfig()):
        wrap, wbits = decode_window_bits_inflate(config.window_bits)
        self._wbits_from_header = False
        if wbits == 0 and wrap in (Wrap.Zlib, Wrap.AutoDetect):
            wbits = DEF_WBITS  # accept any header-declared size up to 15
            self._wbits_from_header = True
        if not (8 <= wbits <= 15):
            raise ValueError("invalid inflate window bits")
        self.config = config
        self.wrap = wrap
        self.wbits = wbits
        self.reset()

    # -- lifecycle ---------------------------------------------------------

    def reset(self) -> None:
        """Full reset keeping configuration (reference: inflate.rs:2335)."""
        self.mode = Mode.HEAD if self.wrap != Wrap.Raw else Mode.TYPE
        self.detected_wrap = Wrap.Raw if self.wrap == Wrap.Raw else None
        self.last = False
        self.hold = 0
        self.bits = 0
        self.total_in = 0
        self.total_out = 0
        self.check = 1
        self.gz_flg = 0
        self.wsize = 1 << self.wbits
        self.window = bytearray(self.wsize)
        self.whave = 0
        self.wnext = 0
        self.head: GzHeader | None = None
        self._head_fields: dict = {}
        self._hcrc_accum = 0
        self._strbuf = bytearray()
        self.length = 0
        self.offset = 0
        self.lencode = None
        self.lenroot = 0
        self.distcode = None
        self.distroot = 0
        self.ncode = self.nlen = self.ndist = 0
        self.have = 0
        self.lens = np.zeros(320, np.int32)
        self.msg: str | None = None
        self.codes_used_count = 0
        self.sane = True  # inflateUndermine(true) clears
        self.validate_check = True  # inflateValidate(false) clears
        self.dict_id = 0
        self.havedict = False
        self.dmax = 1 << self.wbits
        self.back = 0  # bits of current code, for inflateMark
        self.data_type = 0

    def copy(self) -> "Inflator":
        """Deep clone mid-stream (reference: inflate.rs:2547 inflateCopy)."""
        return _copy.deepcopy(self)

    # -- introspection ------------------------------------------------------

    def mark(self) -> int:
        """inflateMark (reference: inflate.rs:2611): upper 16 bits = bits
        into the current code, lower 16 = bytes remaining in copy/match."""
        if self.mode in (Mode.COPY_, Mode.MATCH):
            value = self.length
        else:
            value = 0
        return ((self.back & 0xFFFF) << 16) | (value & 0xFFFF)

    def codes_used(self) -> int:
        return self.codes_used_count

    def sync_point(self) -> bool:
        """True at a sync-flush point (reference: inflate.rs:2543)."""
        return self.mode == Mode.TYPE and self.bits == 0

    def undermine(self, subvert: bool) -> None:
        """Disable the distance-too-far check (reference: inflate.rs:2594)."""
        self.sane = not subvert

    def validate(self, check: bool) -> None:
        """Enable/disable checksum validation (reference: inflate.rs:2601)."""
        self.validate_check = check

    def get_header(self, head: GzHeader | None = None) -> ReturnCode:
        """Register interest in gzip header fields (inflateGetHeader)."""
        if self.wrap not in (Wrap.Gzip, Wrap.AutoDetect):
            return ReturnCode.StreamError
        self.head = head if head is not None else GzHeader()
        self._head_fields = {"done": False}
        return ReturnCode.Ok

    def header_fields(self) -> GzHeader | None:
        """The parsed gzip header, once available."""
        if not self._head_fields.get("done"):
            return None
        f = self._head_fields
        return GzHeader(
            text=f.get("text", False),
            time=f.get("time", 0),
            xflags=f.get("xflags", 0),
            os=f.get("os", 255),
            extra=bytes(f["extra"]) if f.get("extra") is not None else None,
            name=f.get("name"),
            comment=f.get("comment"),
            hcrc=f.get("hcrc", False),
            done=True,
        )

    def set_dictionary(self, dictionary: bytes) -> ReturnCode:
        """inflateSetDictionary (reference: inflate.rs:2627): allowed in raw
        mode at any time, otherwise only right after NeedDict."""
        if self.wrap == Wrap.Raw:
            pass
        elif self.mode == Mode.DICT:
            if checksum.adler32(dictionary) != self.dict_id:
                return ReturnCode.DataError
        else:
            return ReturnCode.StreamError
        d = dictionary[-self.wsize :]
        self.window[: len(d)] = d
        self.whave = len(d)
        self.wnext = 0 if len(d) == self.wsize else len(d)
        self.havedict = True
        if self.mode == Mode.DICT:
            self.mode = Mode.TYPE
        return ReturnCode.Ok

    def get_dictionary(self) -> bytes:
        if self.whave < self.wsize:
            return bytes(self.window[: self.whave])
        return bytes(self.window[self.wnext :]) + bytes(self.window[: self.wnext])

    def prime(self, bits: int, value: int) -> ReturnCode:
        """inflatePrime (reference: inflate.rs:2165): inject/clear bit state."""
        if bits < 0:
            self.hold = 0
            self.bits = 0
            return ReturnCode.Ok
        if bits > 16 or self.bits + bits > 32:
            return ReturnCode.StreamError
        self.hold += (value & ((1 << bits) - 1)) << self.bits
        self.bits += bits
        return ReturnCode.Ok

    def sync(self, data: bytes) -> tuple[ReturnCode, int]:
        """inflateSync (reference: inflate.rs:2483): scan input for the
        00 00 FF FF stored-block marker, then reset to decode from there.
        Returns (rc, bytes consumed)."""
        got = 0
        pos = 0
        n = len(data)
        # discard bit-level state first
        self.hold = 0
        self.bits = 0
        while pos < n:
            b = data[pos]
            pos += 1
            # zlib's syncsearch automaton for 00 00 FF FF
            if b == (0 if got < 2 else 0xFF):
                got += 1
            elif b:
                got = 0
            else:
                got = 4 - got
            if got == 4:
                # like zlib's inflateSync: reset codec state but preserve the
                # totals and the already-detected wrapper (its checksum is
                # recomputed from here on and will flag the damage at CHECK)
                total_in, total_out = self.total_in, self.total_out
                wrap_seen = self.detected_wrap
                self.reset()
                self.total_in, self.total_out = total_in + pos, total_out
                self.mode = Mode.TYPE
                self.detected_wrap = wrap_seen
                if wrap_seen == Wrap.Gzip:
                    self.check = 0
                return ReturnCode.Ok, pos
        self.total_in += pos
        return ReturnCode.DataError, pos

    # -- decode helpers ------------------------------------------------------

    def _peek_symbol(self, data, pos, n, table, root):
        """Resolve one Huffman code without consuming bits. Pulls input bytes
        into the persistent bit buffer as needed (those bytes count as
        consumed input even on pause). Returns (result, pos) where result is
        (kind, aux, payload, codebits) or None when input is exhausted before
        the code completes."""
        mask_root = (1 << root) - 1
        while True:
            e = int(table[self.hold & mask_root])
            kind = (e >> 28) & 0xF
            nbits = (e >> 16) & 0x3F
            if kind == H.KIND_SUB:
                aux = (e >> 22) & 0x3F
                off = e & 0xFFFF
                sub_mask = (1 << aux) - 1
                e2 = int(table[off + ((self.hold >> nbits) & sub_mask)])
                k2 = (e2 >> 28) & 0xF
                n2 = (e2 >> 16) & 0x3F
                if nbits + n2 <= self.bits:
                    return (k2, (e2 >> 22) & 0x3F, e2 & 0xFFFF, nbits + n2), pos
            elif nbits <= self.bits:
                return (kind, (e >> 22) & 0x3F, e & 0xFFFF, nbits), pos
            if pos >= n:
                return None, pos
            self.hold |= data[pos] << self.bits
            self.bits += 8
            pos += 1

    def _consume(self, nbits: int) -> None:
        self.hold >>= nbits
        self.bits -= nbits

    # -- main engine --------------------------------------------------------

    def inflate(
        self,
        data: bytes,
        max_out: int | None = None,
        flush: InflateFlush = InflateFlush.NO_FLUSH,
    ) -> tuple[ReturnCode, int, bytes]:
        """Run the state machine over one (input, output-budget) step.

        Returns (return_code, input_consumed, output_bytes). Pauses cleanly
        when input is exhausted or the output budget is reached; callers
        implement z_stream avail_in/avail_out semantics on top (stream.py).
        """
        if self.mode == Mode.MEM:
            return ReturnCode.MemError, 0, b""
        out = bytearray()
        budget = max_out if max_out is not None else (1 << 62)
        data = bytes(data)
        pos = 0
        n = len(data)
        start_bits = self.bits
        ret = ReturnCode.Ok
        checked_here = False

        def need_bits(want: int) -> bool:
            nonlocal pos
            while self.bits < want:
                if pos >= n:
                    return False
                self.hold |= data[pos] << self.bits
                self.bits += 8
                pos += 1
            return True

        def drop(nb: int) -> None:
            self.hold >>= nb
            self.bits -= nb

        while True:
            if self.mode == Mode.HEAD:
                if not need_bits(16):
                    break
                lo = self.hold & 0xFF
                hi = (self.hold >> 8) & 0xFF
                if self.wrap in (Wrap.Gzip, Wrap.AutoDetect) and lo == 0x1F and hi == 0x8B:
                    self.detected_wrap = Wrap.Gzip
                    self._hcrc_accum = checksum.crc32(bytes([lo, hi]))
                    drop(16)
                    self.mode = Mode.FLAGS
                    continue
                if self.wrap == Wrap.Gzip:
                    self.msg = "incorrect header check"
                    self.mode = Mode.BAD
                    continue
                # zlib header
                cmf, flg = lo, hi
                if ((cmf << 8) | flg) % 31 != 0:
                    self.msg = "incorrect header check"
                    self.mode = Mode.BAD
                    continue
                if (cmf & 0x0F) != 8:
                    self.msg = "unknown compression method"
                    self.mode = Mode.BAD
                    continue
                cinfo = cmf >> 4
                if cinfo + 8 > 15 or (not self._wbits_from_header and cinfo + 8 > self.wbits):
                    self.msg = "invalid window size"
                    self.mode = Mode.BAD
                    continue
                if self._wbits_from_header and cinfo + 8 != self.wbits:
                    self.wbits = cinfo + 8
                    self.wsize = 1 << self.wbits
                    self.window = bytearray(self.wsize)
                self.dmax = 1 << (cinfo + 8)
                self.detected_wrap = Wrap.Zlib
                drop(16)
                self.check = 1
                self.mode = Mode.DICTID if (flg & 0x20) else Mode.TYPE
                continue

            if self.mode == Mode.FLAGS:
                if not need_bits(16):
                    break
                method = self.hold & 0xFF
                self.gz_flg = (self.hold >> 8) & 0xFF
                if method != 8:
                    self.msg = "unknown compression method"
                    self.mode = Mode.BAD
                    continue
                if self.gz_flg & 0xE0:
                    self.msg = "unknown header flags set"
                    self.mode = Mode.BAD
                    continue
                if self.head is not None:
                    self._head_fields["text"] = bool(self.gz_flg & 1)
                self._hcrc_accum = checksum.crc32(bytes([method, self.gz_flg]), self._hcrc_accum)
                drop(16)
                self.mode = Mode.TIME
                continue

            if self.mode == Mode.TIME:
                if not need_bits(32):
                    break
                mtime = self.hold & 0xFFFFFFFF
                if self.head is not None:
                    self._head_fields["time"] = mtime
                self._hcrc_accum = checksum.crc32(mtime.to_bytes(4, "little"), self._hcrc_accum)
                drop(32)
                self.mode = Mode.OS
                continue

            if self.mode == Mode.OS:
                if not need_bits(16):
                    break
                xfl = self.hold & 0xFF
                osb = (self.hold >> 8) & 0xFF
                if self.head is not None:
                    self._head_fields["xflags"] = xfl
                    self._head_fields["os"] = osb
                self._hcrc_accum = checksum.crc32(bytes([xfl, osb]), self._hcrc_accum)
                drop(16)
                self.mode = Mode.EXLEN
                continue

            if self.mode == Mode.EXLEN:
                if self.gz_flg & 0x04:
                    if not need_bits(16):
                        break
                    self.length = self.hold & 0xFFFF
                    if self.head is not None:
                        self._head_fields["extra"] = bytearray()
                    self._hcrc_accum = checksum.crc32(
                        (self.hold & 0xFFFF).to_bytes(2, "little"), self._hcrc_accum
                    )
                    drop(16)
                self.mode = Mode.EXTRA
                continue

            if self.mode == Mode.EXTRA:
                if self.gz_flg & 0x04 and self.length:
                    take = min(self.length, n - pos)
                    if take:
                        chunk = data[pos : pos + take]
                        if self.head is not None and self._head_fields.get("extra") is not None:
                            self._head_fields["extra"].extend(chunk)
                        self._hcrc_accum = checksum.crc32(chunk, self._hcrc_accum)
                        pos += take
                        self.length -= take
                    if self.length:
                        break
                self.mode = Mode.NAME
                self._strbuf = bytearray()
                continue

            if self.mode == Mode.NAME:
                if self.gz_flg & 0x08:
                    done = False
                    scanned_from = pos
                    while pos < n:
                        b = data[pos]
                        pos += 1
                        if b == 0:
                            done = True
                            break
                        self._strbuf.append(b)
                    self._hcrc_accum = checksum.crc32(data[scanned_from:pos], self._hcrc_accum)
                    if not done:
                        break
                    if self.head is not None:
                        self._head_fields["name"] = bytes(self._strbuf)
                self.mode = Mode.COMMENT
                self._strbuf = bytearray()
                continue

            if self.mode == Mode.COMMENT:
                if self.gz_flg & 0x10:
                    done = False
                    scanned_from = pos
                    while pos < n:
                        b = data[pos]
                        pos += 1
                        if b == 0:
                            done = True
                            break
                        self._strbuf.append(b)
                    self._hcrc_accum = checksum.crc32(data[scanned_from:pos], self._hcrc_accum)
                    if not done:
                        break
                    if self.head is not None:
                        self._head_fields["comment"] = bytes(self._strbuf)
                self.mode = Mode.HCRC
                continue

            if self.mode == Mode.HCRC:
                if self.gz_flg & 0x02:
                    if not need_bits(16):
                        break
                    if self.validate_check and (self.hold & 0xFFFF) != (self._hcrc_accum & 0xFFFF):
                        self.msg = "header crc mismatch"
                        self.mode = Mode.BAD
                        continue
                    drop(16)
                if self.head is not None:
                    self._head_fields["hcrc"] = bool(self.gz_flg & 0x02)
                    self._head_fields["done"] = True
                self.check = 0  # payload crc starts now
                self.mode = Mode.TYPE
                continue

            if self.mode == Mode.DICTID:
                if not need_bits(32):
                    break
                raw = self.hold & 0xFFFFFFFF
                # adler32 of dictionary is stored big-endian in the stream
                self.dict_id = int.from_bytes(raw.to_bytes(4, "little"), "big")
                drop(32)
                self.mode = Mode.DICT
                continue

            if self.mode == Mode.DICT:
                if not self.havedict:
                    ret = ReturnCode.NeedDict
                    break
                self.check = 1
                self.mode = Mode.TYPE
                continue

            if self.mode == Mode.TYPE:
                if flush in (InflateFlush.BLOCK, InflateFlush.TREES) and (pos > 0 or out):
                    break
                self.mode = Mode.TYPEDO
                continue

            if self.mode == Mode.TYPEDO:
                if self.last:
                    drop(self.bits & 7)
                    self.mode = Mode.CHECK
                    continue
                if not need_bits(3):
                    break
                self.last = bool(self.hold & 1)
                btype = (self.hold >> 1) & 3
                drop(3)
                self.back = 0
                if btype == 0:
                    self.mode = Mode.STORED
                elif btype == 1:
                    self.lencode, self.lenroot = H.FIXED_LITLEN_TABLE, H.FIXED_LITLEN_ROOT
                    self.distcode, self.distroot = H.FIXED_DIST_TABLE, H.FIXED_DIST_ROOT
                    self.mode = Mode.LEN
                    if flush == InflateFlush.TREES:
                        break
                elif btype == 2:
                    self.mode = Mode.TABLE
                else:
                    self.msg = "invalid block type"
                    self.mode = Mode.BAD
                continue

            if self.mode == Mode.STORED:
                drop(self.bits & 7)
                if not need_bits(32):
                    break
                ln = self.hold & 0xFFFF
                nln = (self.hold >> 16) & 0xFFFF
                if ln != (~nln & 0xFFFF):
                    self.msg = "invalid stored block lengths"
                    self.mode = Mode.BAD
                    continue
                self.length = ln
                drop(32)
                self.mode = Mode.COPY_
                if flush == InflateFlush.TREES:
                    break
                continue

            if self.mode == Mode.COPY_:
                if self.length:
                    take = min(self.length, n - pos, budget - len(out))
                    if take == 0:
                        break
                    out.extend(data[pos : pos + take])
                    pos += take
                    self.length -= take
                    if self.length:
                        break
                self.mode = Mode.TYPE
                continue

            if self.mode == Mode.TABLE:
                if not need_bits(14):
                    break
                self.nlen = (self.hold & 31) + 257
                self.ndist = ((self.hold >> 5) & 31) + 1
                self.ncode = ((self.hold >> 10) & 15) + 4
                drop(14)
                if self.nlen > 286 or self.ndist > 30:
                    self.msg = "too many length or distance symbols"
                    self.mode = Mode.BAD
                    continue
                self.have = 0
                self.lens[:] = 0
                self.mode = Mode.LENLENS
                continue

            if self.mode == Mode.LENLENS:
                paused = False
                while self.have < self.ncode:
                    if not need_bits(3):
                        paused = True
                        break
                    self.lens[H.CL_ORDER[self.have]] = self.hold & 7
                    drop(3)
                    self.have += 1
                if paused:
                    break
                table, root, err = H.inflate_table(H.CODES, self.lens[:19].copy(), 7)
                if err:
                    self.msg = "invalid code lengths set"
                    self.mode = Mode.BAD
                    continue
                self.lencode, self.lenroot = table, root
                self.have = 0
                self.lens[:] = 0
                self.mode = Mode.CODELENS
                continue

            if self.mode == Mode.CODELENS:
                paused = False
                while self.have < self.nlen + self.ndist:
                    res, pos = self._peek_symbol(data, pos, n, self.lencode, self.lenroot)
                    if res is None:
                        paused = True
                        break
                    kind, aux, sym, codebits = res
                    if sym < 16:
                        self._consume(codebits)
                        self.lens[self.have] = sym
                        self.have += 1
                        continue
                    extra = _REP_EXTRA[sym]
                    if not need_bits(codebits + extra):
                        paused = True
                        break
                    self._consume(codebits)
                    if sym == 16:
                        if self.have == 0:
                            self.msg = "invalid bit length repeat"
                            self.mode = Mode.BAD
                            break
                        rep = 3 + (self.hold & 3)
                        drop(2)
                        fill = int(self.lens[self.have - 1])
                    elif sym == 17:
                        rep = 3 + (self.hold & 7)
                        drop(3)
                        fill = 0
                    else:
                        rep = 11 + (self.hold & 127)
                        drop(7)
                        fill = 0
                    if self.have + rep > self.nlen + self.ndist:
                        self.msg = "invalid bit length repeat"
                        self.mode = Mode.BAD
                        break
                    self.lens[self.have : self.have + rep] = fill
                    self.have += rep
                if self.mode == Mode.BAD:
                    continue
                if paused:
                    break
                if self.lens[256] == 0:
                    self.msg = "invalid code -- missing end-of-block"
                    self.mode = Mode.BAD
                    continue
                table, root, err = H.inflate_table(H.LENS, self.lens[: self.nlen].copy(), 10)
                if err:
                    self.msg = "invalid literal/lengths set"
                    self.mode = Mode.BAD
                    continue
                self.lencode, self.lenroot = table, root
                dtable, droot, derr = H.inflate_table(
                    H.DISTS, self.lens[self.nlen : self.nlen + self.ndist].copy(), 9
                )
                if derr:
                    self.msg = "invalid distances set"
                    self.mode = Mode.BAD
                    continue
                self.distcode, self.distroot = dtable, droot
                self.codes_used_count += 1
                self.mode = Mode.LEN
                if flush == InflateFlush.TREES:
                    break
                continue

            if self.mode == Mode.LEN:
                if len(out) >= budget:
                    break
                res, pos = self._peek_symbol(data, pos, n, self.lencode, self.lenroot)
                if res is None:
                    break
                kind, aux, payload, codebits = res
                self.back = codebits
                if kind == H.KIND_LITERAL:
                    self._consume(codebits)
                    out.append(payload)
                    continue
                if kind == H.KIND_EOB:
                    self._consume(codebits)
                    self.back = 0
                    self.mode = Mode.TYPE
                    continue
                if kind == H.KIND_INVALID:
                    self.msg = "invalid literal/length code"
                    self.mode = Mode.BAD
                    continue
                # match length: require code + extra bits atomically
                if not need_bits(codebits + aux):
                    break
                self._consume(codebits)
                self.length = payload + (self.hold & ((1 << aux) - 1) if aux else 0)
                if aux:
                    drop(aux)
                self.back += aux
                self.mode = Mode.DIST
                continue

            if self.mode == Mode.DIST:
                res, pos = self._peek_symbol(data, pos, n, self.distcode, self.distroot)
                if res is None:
                    break
                kind, aux, payload, codebits = res
                if kind == H.KIND_INVALID:
                    self.msg = "invalid distance code"
                    self.mode = Mode.BAD
                    continue
                if not need_bits(codebits + aux):
                    break
                self._consume(codebits)
                self.offset = payload + ((self.hold & ((1 << aux) - 1)) if aux else 0)
                if aux:
                    drop(aux)
                self.back += codebits + aux
                self.mode = Mode.MATCH
                continue

            if self.mode == Mode.MATCH:
                if self.offset > self.dmax:
                    self.msg = "invalid distance too far back"
                    self.mode = Mode.BAD
                    continue
                bad = False
                while self.length > 0:
                    if len(out) >= budget:
                        break
                    produced = len(out)
                    if self.offset <= produced:
                        take = min(self.length, budget - produced)
                        src = produced - self.offset
                        if self.offset >= take:
                            out.extend(out[src : src + take])
                        else:
                            # overlapped copy: replicate the period
                            period = out[src:produced]
                            reps = -(-take // self.offset)
                            out.extend((period * reps)[:take])
                        self.length -= take
                    else:
                        dist_in_win = self.offset - produced
                        if dist_in_win > self.whave:
                            if self.sane:
                                self.msg = "invalid distance too far back"
                                self.mode = Mode.BAD
                                bad = True
                                break
                            out.append(0)
                            self.length -= 1
                            continue
                        if self.wnext >= dist_in_win:
                            wsrc = self.wnext - dist_in_win
                        else:
                            wsrc = self.wsize - (dist_in_win - self.wnext)
                        out.append(self.window[wsrc])
                        self.length -= 1
                if bad:
                    continue
                if self.length > 0:
                    break  # output budget hit
                self.back = 0
                self.mode = Mode.LEN
                continue

            if self.mode == Mode.CHECK:
                if self.detected_wrap in (Wrap.Zlib, Wrap.Gzip):
                    if not need_bits(32):
                        break
                    raw = self.hold & 0xFFFFFFFF
                    self._update_check_and_window(out)
                    checked_here = True
                    if self.detected_wrap == Wrap.Zlib:
                        stored = int.from_bytes(raw.to_bytes(4, "little"), "big")
                    else:
                        stored = raw
                    if self.validate_check and stored != self.check:
                        self.msg = "incorrect data check"
                        self.mode = Mode.BAD
                        continue
                    drop(32)
                if self.detected_wrap == Wrap.Gzip:
                    self.mode = Mode.LENGTH
                else:
                    self.mode = Mode.DONE
                continue

            if self.mode == Mode.LENGTH:
                if not need_bits(32):
                    break
                if self.validate_check and (self.hold & 0xFFFFFFFF) != (
                    (self.total_out + len(out)) & 0xFFFFFFFF
                ):
                    self.msg = "incorrect length check"
                    self.mode = Mode.BAD
                    continue
                drop(32)
                self.mode = Mode.DONE
                continue

            if self.mode == Mode.DONE:
                ret = ReturnCode.StreamEnd
                break

            if self.mode == Mode.BAD:
                ret = ReturnCode.DataError
                break

            raise AssertionError(f"unhandled mode {self.mode}")

        if not checked_here:
            self._update_check_and_window(out)
        # data_type: unused bits + 64 at block boundary + 128 after last block
        self.data_type = (self.bits & 7) | (64 if self.mode == Mode.TYPE else 0)
        if self.mode in (Mode.CHECK, Mode.LENGTH, Mode.DONE) or (
            self.last and self.mode == Mode.TYPE
        ):
            self.data_type |= 128
        self.total_in += pos
        self.total_out += len(out)
        return ret, pos, bytes(out)

    def _update_check_and_window(self, out: bytearray) -> None:
        if not out:
            return
        chunk = bytes(out)
        if self.detected_wrap == Wrap.Zlib:
            self.check = checksum.adler32(chunk, self.check)
        elif self.detected_wrap == Wrap.Gzip:
            self.check = checksum.crc32(chunk, self.check)
        # keep last wsize bytes in the window
        if len(chunk) >= self.wsize:
            self.window[:] = chunk[-self.wsize :]
            self.wnext = 0
            self.whave = self.wsize
        else:
            k = len(chunk)
            first = min(k, self.wsize - self.wnext)
            self.window[self.wnext : self.wnext + first] = chunk[:first]
            if k > first:
                self.window[: k - first] = chunk[first:]
            self.wnext = (self.wnext + k) % self.wsize
            self.whave = min(self.wsize, self.whave + k)


class DataError(Exception):
    pass


class NeedDictError(Exception):
    def __init__(self, dict_id: int):
        super().__init__(f"need dictionary (id={dict_id:#x})")
        self.dict_id = dict_id


def decompress(data: bytes, config: InflateConfig = InflateConfig()) -> bytes:
    """One-shot decompress (reference: inflate.rs:172 decompress_slice)."""
    inf = Inflator(config)
    ret, consumed, out = inf.inflate(data, None, InflateFlush.FINISH)
    if ret == ReturnCode.NeedDict:
        raise NeedDictError(inf.dict_id)
    if ret != ReturnCode.StreamEnd:
        raise DataError(inf.msg or "truncated or corrupt stream")
    return out
