"""Streaming API with z_stream pumping semantics (a copy of
zlib_rs_tpu/models/stream.py without its native route).

`Deflate`/`Inflate` objects with compress/decompress(input, output-budget,
flush) -> Status over the host engines in deflate.py / inflate.py. The
avail_in/avail_out contract matches zlib: each call consumes what it can,
produces up to the output budget, and reports BufError only when no forward
progress is possible.

The reference routes eligible streams to its native C++ engine
(models/faststream.py); the port does not carry it, so every stream runs
on the exact host engine, and `_deopt`, which only switched that route off,
is a no-op kept for code written against the reference.
"""

from __future__ import annotations

import enum

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


class Status(enum.Enum):
    """Result of a successful compress/decompress call."""

    Ok = 0
    BufError = 1
    StreamEnd = 2


class DeflateError(Exception):
    def __init__(self, rc: ReturnCode, msg: str | None = None):
        super().__init__(msg or rc.error_message)
        self.return_code = rc


class InflateError(Exception):
    def __init__(self, rc: ReturnCode, msg: str | None = None):
        super().__init__(msg or rc.error_message)
        self.return_code = rc


class Deflate:
    """Streaming compressor over the host Deflator."""

    def __init__(self, config: DeflateConfig | None = None, **kwargs):
        if config is None:
            config = DeflateConfig(**kwargs)
        self.config = config
        self._eng = Deflator(config)
        self._finished = False

    def _deopt(self) -> None:
        """A no-op: the reference's switch off its native route."""

    # introspection
    @property
    def total_in(self) -> int:
        return self._eng.total_in

    @property
    def total_out(self) -> int:
        return self._eng.total_out

    @property
    def pending(self) -> tuple[int, int]:
        return self._eng.pending_info()

    @property
    def data_type(self):
        return self._eng.data_type

    def bound(self, source_len: int) -> int:
        return self._eng.bound(source_len)

    def set_dictionary(self, dictionary: bytes) -> None:
        rc = self._eng.set_dictionary(dictionary)
        if rc != ReturnCode.Ok:
            raise DeflateError(rc)

    def set_header(self, head) -> None:
        rc = self._eng.set_header(head)
        if rc != ReturnCode.Ok:
            raise DeflateError(rc)

    def params(self, level: int, strategy: Strategy = Strategy.Default) -> None:
        rc = self._eng.params(level, strategy)
        if rc != ReturnCode.Ok:
            raise DeflateError(rc)

    def prime(self, bits: int, value: int) -> None:
        rc = self._eng.prime(bits, value)
        if rc != ReturnCode.Ok:
            raise DeflateError(rc)

    def compress(
        self,
        input: bytes,
        flush: DeflateFlush = DeflateFlush.NO_FLUSH,
        out_budget: int | None = None,
    ) -> tuple[Status, int, bytes]:
        """One z_stream pump step: returns (status, input_consumed, output).

        Consumes all of `input` (the engine's pending buffer plays the role
        of the reference's Pending layer) and emits up to `out_budget` bytes.
        """
        eng = self._eng
        had_pending = len(eng.pending) > 0
        if self._finished and input:
            raise DeflateError(ReturnCode.StreamError)
        rc = eng.deflate(input, flush)
        if rc == ReturnCode.StreamEnd:
            self._finished = True
        elif rc == ReturnCode.BufError:
            # zlib's no-progress flush rule (repeated empty flush): not an
            # exception — the z_stream contract reports it as a status
            return Status.BufError, 0, eng.take_output(out_budget)
        elif rc != ReturnCode.Ok:
            raise DeflateError(rc)
        out = eng.take_output(out_budget)
        if self._finished and not eng.pending:
            return Status.StreamEnd, len(input), out
        if not input and not out and not had_pending and flush == DeflateFlush.NO_FLUSH:
            return Status.BufError, 0, out
        return Status.Ok, len(input), out

    def finish(self) -> bytes:
        """Convenience: finish the stream and drain everything."""
        status, _, out = self.compress(b"", DeflateFlush.FINISH)
        assert status == Status.StreamEnd
        return out

    def copy(self) -> "Deflate":
        clone = object.__new__(Deflate)
        clone.config = self.config
        clone._eng = self._eng.copy()
        clone._finished = self._finished
        return clone

    def reset(self) -> None:
        self._eng.reset()
        self._finished = False


class Inflate:
    """Streaming decompressor over the host Inflator."""

    def __init__(self, config: InflateConfig | None = None, **kwargs):
        if config is None:
            config = InflateConfig(**kwargs)
        self.config = config
        self._eng = Inflator(config)
        self._finished = False

    def _deopt(self) -> None:
        """A no-op: the reference's switch off its native route."""

    @property
    def total_in(self) -> int:
        return self._eng.total_in

    @property
    def total_out(self) -> int:
        return self._eng.total_out

    @property
    def msg(self) -> str | None:
        return self._eng.msg

    @property
    def data_type(self) -> int:
        return self._eng.data_type

    @property
    def dict_id(self) -> int:
        return self._eng.dict_id

    def set_dictionary(self, dictionary: bytes) -> None:
        rc = self._eng.set_dictionary(dictionary)
        if rc != ReturnCode.Ok:
            raise InflateError(rc, self.msg)

    def get_header(self):
        return self._eng.get_header()

    def header_fields(self):
        return self._eng.header_fields()

    def prime(self, bits: int, value: int) -> None:
        rc = self._eng.prime(bits, value)
        if rc != ReturnCode.Ok:
            raise InflateError(rc)

    def sync(self, data: bytes) -> tuple[ReturnCode, int]:
        return self._eng.sync(data)

    def sync_point(self) -> bool:
        return self._eng.sync_point()

    def mark(self) -> int:
        return self._eng.mark()

    def codes_used(self) -> int:
        return self._eng.codes_used()

    def decompress(
        self,
        input: bytes,
        out_budget: int | None = None,
        flush: InflateFlush = InflateFlush.NO_FLUSH,
    ) -> tuple[Status, int, bytes]:
        """One z_stream pump step: returns (status, input_consumed, output)."""
        eng = self._eng
        rc, consumed, out = eng.inflate(input, out_budget, flush)
        if rc == ReturnCode.StreamEnd:
            self._finished = True
            return Status.StreamEnd, consumed, out
        if rc == ReturnCode.NeedDict:
            raise InflateError(ReturnCode.NeedDict)
        if rc not in (ReturnCode.Ok, ReturnCode.BufError):
            raise InflateError(rc, eng.msg)
        if not consumed and not out:
            return Status.BufError, 0, out
        return Status.Ok, consumed, out

    def copy(self) -> "Inflate":
        clone = object.__new__(Inflate)
        clone.config = self.config
        clone._eng = self._eng.copy()
        clone._finished = self._finished
        return clone

    def reset(self) -> None:
        self._eng.reset()
        self._finished = False
