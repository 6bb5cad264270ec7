"""Buffered gzip file API (a copy of zlib_rs_tpu/models/gzfile.py over the
port's engines): gzopen/gzread/gzwrite/gzseek/gztell/gzflush/gzeof/
gzdirect/gzerror/gzbuffer/gzungetc/gzgets/gzputs/gzprintf.

Semantics carried over:
  * read path sniffs the gzip magic and falls back to *transparent* mode for
    non-gzip files (gz.rs:1226 gz_look);
  * multi-member archives decode seamlessly (gz.rs:1505-1509: Z_STREAM_END →
    look for the next member);
  * seek is emulated: backward = rewind + re-skip, forward = skip by decoding
    (gz.rs:2530 gzseek64); write-mode forward seek writes zeros;
  * append mode starts a fresh member;
  * default buffer size 128 KiB, adjustable via `buffer_size` (gzbuffer).

A member runs on the fast engines of models/faststream.py (IS and DS, the
raw body on the card) where they take its configuration, as in the
reference: the writer when faststream.deflate_eligible(config), the
reader for every member (it takes every gzip member at the full window),
both unless ZRS_NATIVE_STREAM is "0" (which the reference's reader does
not read). `device` (None: the GPU, which a writer needs
at open and a reader at its first member; "cpu": IS's and DS's plain
versions) is where they run.
"""

from __future__ import annotations

import io
import os

from ..config import (
    DeflateConfig,
    DeflateFlush,
    InflateConfig,
    InflateFlush,
    ReturnCode,
    Strategy,
)
from .deflate import Deflator
from .inflate import Inflator

GZBUFSIZE = 128 * 1024  # reference: gz.rs:175


class GzError(Exception):
    def __init__(self, rc: ReturnCode, msg: str):
        super().__init__(msg)
        self.return_code = rc
        self.msg = msg


def _parse_mode(mode: str):
    """Parse a gzopen-style mode string: [rwa] [b] [0-9] [fhRFT]."""
    op = None
    level = -1
    strategy = Strategy.Default
    transparent = False
    for ch in mode:
        if ch in "rwa":
            op = ch
        elif ch.isdigit():
            level = int(ch)
        elif ch == "f":
            strategy = Strategy.Filtered
        elif ch == "h":
            strategy = Strategy.HuffmanOnly
        elif ch == "R":
            strategy = Strategy.Rle
        elif ch == "F":
            strategy = Strategy.Fixed
        elif ch == "T":
            transparent = True
        elif ch in "bte+x":
            if ch == "+":
                raise GzError(ReturnCode.StreamError, "read/write mode not supported")
        else:
            raise GzError(ReturnCode.StreamError, f"invalid mode char {ch!r}")
    if op is None:
        raise GzError(ReturnCode.StreamError, "mode must contain r, w, or a")
    return op, level, strategy, transparent


class GzFile:
    """A gzip-compressed file handle (counterpart of gzFile)."""

    def __init__(
        self,
        path: str | os.PathLike | None = None,
        mode: str = "rb",
        fileobj=None,
        buffer_size: int = GZBUFSIZE,
        *,
        device=None,
    ):
        op, level, strategy, transparent = _parse_mode(mode)
        self.device = device
        self.mode = op
        self.level = level
        self.strategy = strategy
        self.transparent_write = transparent
        self.buffer_size = buffer_size
        self._err: tuple[ReturnCode, str] | None = None
        self._eof = False  # input exhausted (gzeof semantics)
        self._direct: bool | None = None if op == "r" else transparent
        self._pos = 0  # uncompressed position
        self._closed = False
        self._ungot: bytearray = bytearray()

        if fileobj is not None:
            self._fp = fileobj
            self._owns_fp = False
        else:
            if path is None:
                raise GzError(ReturnCode.StreamError, "path or fileobj required")
            fmode = {"r": "rb", "w": "wb", "a": "ab"}[op]
            self._fp = open(path, fmode)
            self._owns_fp = True

        if op == "r":
            self._inf: Inflator | None = None
            self._inbuf = b""  # compressed bytes read but not yet consumed
            self._outbuf = bytearray()  # decoded bytes not yet delivered
            self._start = self._fp.tell() if self._fp.seekable() else 0
            self._comp_read = 0  # compressed bytes consumed from the fd
        else:
            self._def: Deflator | None = None
            if not transparent:
                cfg = DeflateConfig(level=level, window_bits=31, strategy=strategy)
                self._def = self._new_deflater(cfg)

    def _new_deflater(self, cfg: DeflateConfig):
        """gzip-member deflater: DS's engine where it takes the config
        and ZRS_NATIVE_STREAM is not "0", else the exact host engine."""
        from . import faststream

        if faststream.native_route() and faststream.deflate_eligible(cfg):
            return faststream.FastDeflateEngine(cfg, self.device)
        return Deflator(cfg)

    # -- error surface (gzerror / gzclearerr) -------------------------------

    def error(self) -> tuple[ReturnCode, str]:
        return self._err if self._err is not None else (ReturnCode.Ok, "")

    def clear_error(self) -> None:
        self._err = None
        self._eof = False

    def _set_err(self, rc: ReturnCode, msg: str):
        self._err = (rc, msg)
        raise GzError(rc, msg)

    # -- read path -----------------------------------------------------------

    def _fill_in(self) -> bool:
        """Read more compressed bytes from the fd. False at EOF."""
        chunk = self._fp.read(self.buffer_size)
        if not chunk:
            self._eof = True
            return False
        self._inbuf += chunk
        self._comp_read += len(chunk)
        return True

    def _new_inflater(self):
        """gzip-member inflater: IS's engine (it takes every gzip member)
        unless ZRS_NATIVE_STREAM is "0". The reference's reader does not
        read that variable; here it switches the reader as it switches the
        writer and the stream objects."""
        from . import faststream

        cfg = InflateConfig(window_bits=31)
        if faststream.native_route() and faststream.eligible(cfg):
            return faststream.FastInflateEngine(cfg, self.device)
        return Inflator(cfg)

    def _look(self) -> None:
        """Sniff gzip magic vs transparent mode (gz.rs:1226 gz_look)."""
        while len(self._inbuf) < 2 and not self._eof:
            self._fill_in()
        if len(self._inbuf) >= 2 and self._inbuf[0] == 0x1F and self._inbuf[1] == 0x8B:
            self._direct = False
            self._inf = self._new_inflater()
        else:
            self._direct = True
            self._inf = None

    def _decode_more(self) -> bool:
        """Produce more bytes into _outbuf. False when fully exhausted."""
        if self._direct is None:
            self._look()
        if self._direct:
            if self._inbuf:
                self._outbuf.extend(self._inbuf)
                self._inbuf = b""
                return True
            return self._fill_in() and self._decode_more()
        while True:
            if not self._inbuf and not self._fill_in():
                if self._inf is not None and self._inf.total_in > 0:
                    # Truncated member: the inflater started but never saw
                    # StreamEnd. gzread reports an error here (gz.rs gz_decomp
                    # "unexpected end of file"), not a clean EOF.
                    if not _inf_finished(self._inf):
                        self._set_err(ReturnCode.BufError, "unexpected end of file")
                return False
            rc, consumed, out = self._inf.inflate(
                self._inbuf, None, InflateFlush.NO_FLUSH
            )
            self._inbuf = self._inbuf[consumed:]
            if out:
                self._outbuf.extend(out)
            if rc == ReturnCode.StreamEnd:
                # the fast engine absorbs past-member bytes; hand them back
                tail = getattr(self._inf, "unused_tail", b"")
                if tail:
                    self._inbuf = tail + self._inbuf
                # multi-member: look for another member (gz.rs:1505-1509)
                while len(self._inbuf) < 2 and not self._eof:
                    self._fill_in()
                if len(self._inbuf) >= 2 and self._inbuf[:2] == b"\x1f\x8b":
                    self._inf = self._new_inflater()
                    continue
                if self._inbuf:
                    # trailing garbage is ignored, like gzio
                    self._inbuf = b""
                return bool(out)
            if rc == ReturnCode.DataError:
                self._set_err(ReturnCode.DataError, self._inf.msg or "data error")
            if rc == ReturnCode.Ok and not out and not consumed and self._eof:
                return False
            if out:
                return True

    def read(self, n: int = -1) -> bytes:
        if self.mode != "r":
            self._set_err(ReturnCode.StreamError, "file not open for reading")
        result = bytearray()
        if self._ungot:
            if n < 0:
                result.extend(reversed(self._ungot))
                self._ungot.clear()
            else:
                while self._ungot and len(result) < n:
                    result.append(self._ungot.pop())
        while (n < 0 or len(result) < n) and not self._closed:
            if not self._outbuf and not self._decode_more():
                break
            take = len(self._outbuf) if n < 0 else n - len(result)
            result.extend(self._outbuf[:take])
            del self._outbuf[:take]
        self._pos += len(result)
        return bytes(result)

    def getc(self) -> int:
        """gzgetc: one byte, or -1 at EOF."""
        b = self.read(1)
        return b[0] if b else -1

    def ungetc(self, c: int) -> int:
        """gzungetc: push a byte back; it is returned by the next read."""
        if self.mode != "r" or c < 0:
            return -1
        self._ungot.append(c & 0xFF)
        self._pos -= 1
        return c & 0xFF

    def gets(self, max_len: int = 1 << 20) -> bytes:
        """gzgets: read up to and including a newline."""
        out = bytearray()
        while len(out) < max_len:
            b = self.read(1)
            if not b:
                break
            out += b
            if b == b"\n":
                break
        return bytes(out)

    def fread(self, size: int, nitems: int) -> bytes:
        """gzfread (reference: gz.rs:1029): read up to size*nitems bytes.
        Mirrors C fread semantics — the return's length // size is the
        complete-item count; a trailing partial item's bytes ARE consumed
        from the file and returned (the caller decides what to do with the
        short tail), exactly like the reference which reads len = size*n
        bytes and reports len/size items."""
        if size == 0 or nitems == 0:
            return b""
        if size * nitems // nitems != size:  # overflow guard (gz.rs:1043)
            self._set_err(ReturnCode.StreamError, "request does not fit in a size_t")
        return self.read(size * nitems)

    # -- write path ----------------------------------------------------------

    def fwrite(self, data: bytes, size: int, nitems: int) -> int:
        """gzfwrite (reference: gz.rs:1586): write size*nitems bytes from
        `data`; returns the number of COMPLETE items written. Writing less
        than size*nitems available bytes writes only whole items."""
        if size == 0 or nitems == 0:
            return 0
        if size * nitems // nitems != size:
            self._set_err(ReturnCode.StreamError, "request does not fit in a size_t")
        items = min(nitems, len(data) // size)
        if items:
            self.write(bytes(data[: items * size]))
        return items

    def write(self, data: bytes) -> int:
        if self.mode not in ("w", "a"):
            self._set_err(ReturnCode.StreamError, "file not open for writing")
        data = bytes(data)
        if self._def is None:  # transparent write
            self._fp.write(data)
        else:
            self._def.deflate(data, DeflateFlush.NO_FLUSH)
            out = self._def.take_output()
            if out:
                self._fp.write(out)
        self._pos += len(data)
        return len(data)

    def puts(self, s: str | bytes) -> int:
        """gzputs."""
        if isinstance(s, str):
            s = s.encode()
        return self.write(s)

    def printf(self, fmt: str, *args) -> int:
        """gzprintf (reference: gz.rs:2707, nightly c_variadic)."""
        return self.write((fmt % args).encode())

    def putc(self, c: int) -> int:
        """gzputc."""
        self.write(bytes([c & 0xFF]))
        return c & 0xFF

    def flush(self, flush: DeflateFlush = DeflateFlush.SYNC_FLUSH) -> None:
        """gzflush: push buffered compressed bytes to the fd."""
        if self.mode in ("w", "a") and self._def is not None:
            self._def.deflate(b"", flush)
            out = self._def.take_output()
            if out:
                self._fp.write(out)
        self._fp.flush()

    # -- positioning ---------------------------------------------------------

    def offset(self) -> int:
        """gzoffset/gzoffset64 (reference: gz.rs:2024-2064): current raw
        position in the compressed file — bytes consumed from the underlying
        file minus input still buffered (read mode), or bytes written so far
        (write mode)."""
        if self._closed:
            self._set_err(ReturnCode.StreamError, "file is closed")
        if self.mode == "r":
            if self._fp.seekable():
                return self._fp.tell() - len(self._inbuf)
            return self._start + self._comp_read - len(self._inbuf)
        try:
            return self._fp.tell()
        except (OSError, ValueError):
            return -1

    def tell(self) -> int:
        """gztell: uncompressed offset."""
        return self._pos

    def rewind(self) -> None:
        """gzrewind (read mode only)."""
        if self.mode != "r":
            self._set_err(ReturnCode.StreamError, "rewind on write stream")
        self._fp.seek(self._start)
        self._inf = None
        self._direct = None
        self._inbuf = b""
        self._outbuf = bytearray()
        self._ungot.clear()
        self._eof = False
        self._pos = 0

    def seek(self, offset: int, whence: int = io.SEEK_SET) -> int:
        """gzseek64: emulated seek in uncompressed space."""
        if whence == io.SEEK_CUR:
            target = self._pos + offset
        elif whence == io.SEEK_SET:
            target = offset
        else:
            self._set_err(ReturnCode.StreamError, "SEEK_END not supported")
        if target < 0:
            self._set_err(ReturnCode.StreamError, "negative seek")
        if self.mode == "r":
            if self._direct and self._fp.seekable():
                # transparent mode: true lseek (gz.rs raw path)
                self._fp.seek(self._start + target)
                self._inbuf = b""
                self._outbuf = bytearray()
                self._pos = target
                return target
            if target < self._pos:
                self.rewind()
            while self._pos < target:
                step = min(65536, target - self._pos)
                got = self.read(step)
                if not got:
                    break
            return self._pos
        else:
            # write mode: forward-only, emit zeros (gz.rs write-seek)
            if target < self._pos:
                self._set_err(ReturnCode.StreamError, "backward seek while writing")
            while self._pos < target:
                step = min(65536, target - self._pos)
                self.write(b"\x00" * step)
            return self._pos

    # -- status --------------------------------------------------------------

    def eof(self) -> bool:
        """gzeof: true once a read hit end of input."""
        return self._eof and not self._outbuf and not self._ungot

    def direct(self) -> bool:
        """gzdirect: true when reading/writing raw bytes (no gzip)."""
        if self.mode == "r" and self._direct is None:
            self._look()
        return bool(self._direct)

    def set_buffer_size(self, size: int) -> None:
        """gzbuffer."""
        self.buffer_size = max(8, size)

    def set_params(self, level: int, strategy: Strategy = Strategy.Default) -> None:
        """gzsetparams (reference: gz.rs gzsetparams): change compression
        parameters mid-file; buffered data is flushed under the old ones."""
        if self.mode not in ("w", "a") or self._def is None:
            self._set_err(ReturnCode.StreamError, "not a compressed write stream")
        self._def.deflate(b"", DeflateFlush.SYNC_FLUSH)
        out = self._def.take_output()
        if out:
            self._fp.write(out)
        rc = self._def.params(level, strategy)
        if rc != ReturnCode.Ok:
            self._set_err(rc, "invalid parameters")
        self.level = level
        self.strategy = strategy

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        """gzclose: finish the member (write mode) and release the fd."""
        if self._closed:
            return
        if self.mode in ("w", "a") and self._def is not None:
            self._def.deflate(b"", DeflateFlush.FINISH)
            out = self._def.take_output()
            if out:
                self._fp.write(out)
        if self._owns_fp:
            self._fp.close()
        else:
            self._fp.flush()
        self._closed = True

    def __enter__(self) -> "GzFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        try:
            if not self._closed:
                self.close()
        except Exception:
            pass


def gzopen(path, mode: str = "rb", buffer_size: int = GZBUFSIZE, *, device=None) -> GzFile:
    """gzopen (reference: gz.rs gzopen)."""
    return GzFile(path, mode, buffer_size=buffer_size, device=device)


def gzdopen(fd: int, mode: str = "rb", buffer_size: int = GZBUFSIZE, *,
            device=None) -> GzFile:
    """gzdopen (reference: gz.rs:258): open a gz stream over an existing
    file descriptor. The descriptor is owned by the returned handle (closed
    on close), matching zlib's contract."""
    op = mode.replace("b", "")[:1] or "r"
    fmode = {"r": "rb", "w": "wb", "a": "ab"}.get(op, "rb")
    fileobj = os.fdopen(fd, fmode)
    f = GzFile(None, mode, fileobj=fileobj, buffer_size=buffer_size, device=device)
    f._owns_fp = True  # gzdopen transfers fd ownership
    return f


def gzclose_r(f: GzFile) -> ReturnCode:
    """gzclose_r (reference: gz.rs:627): close a read-mode handle;
    StreamError if the handle was opened for writing."""
    if f.mode != "r":
        return ReturnCode.StreamError
    f.close()
    return ReturnCode.Ok


def gzclose_w(f: GzFile) -> ReturnCode:
    """gzclose_w (reference: gz.rs:676): close a write-mode handle;
    StreamError if the handle was opened for reading."""
    if f.mode not in ("w", "a"):
        return ReturnCode.StreamError
    f.close()
    return ReturnCode.Ok


def _inf_finished(inf) -> bool:
    """True when the member decoded to StreamEnd (works for both the exact
    Inflator and the FastInflateEngine)."""
    fin = getattr(inf, "finished", None)
    if fin is not None:
        return bool(fin)
    from .inflate import Mode as _IMode

    return inf.mode == _IMode.DONE
