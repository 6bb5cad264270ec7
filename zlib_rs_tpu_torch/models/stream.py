"""Streaming API with z_stream pumping semantics (a copy of
zlib_rs_tpu/models/stream.py over the port's engines).

`Deflate`/`Inflate` objects with compress/decompress(input, output-budget,
flush) -> Status. The avail_in/avail_out contract matches zlib: each call
consumes what it can, produces up to the output budget, and reports
BufError only when no forward progress is possible.

The route is the reference's: a stream whose configuration the fast
engines take (models/faststream.py: IS and DS, the raw body on the card)
runs there from its first pump; the advanced APIs and the flush modes DS
lacks send it to the exact host engines (deflate.py / inflate.py), before
it engages or, for the compressor, at a byte-aligned seam after.
ZRS_NATIVE_STREAM=0 keeps every stream on the exact engines. `device`
(None: the GPU, which the first pump of an engaged stream then needs;
"cpu": IS's and DS's plain versions) is where the fast engines run.
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
    """Streaming compressor.

    Default-strategy levels 1-9 at the standard window and memLevel run on
    DS (models/faststream.py FastDeflateEngine), which is byte-identical
    to the exact Deflator for NO/SYNC/FULL/FINISH pump scripts. The
    advanced APIs (set_dictionary, set_header, params, prime) and the
    PARTIAL/BLOCK flushes run on the exact engine: before the fast path
    engages they keep it off, after it they migrate the stream.
    """

    def __init__(self, config: DeflateConfig | None = None, *, device=None, **kwargs):
        if config is None:
            config = DeflateConfig(**kwargs)
        self.config = config
        self.device = device
        self._eng = Deflator(config)
        self._finished = False
        self._fast = None
        self._fast_ok = _fast_deflate_eligible(config)

    def _deopt(self) -> None:
        if self._fast is None:
            self._fast_ok = False

    def _to_exact(self) -> None:
        """Migrate an ENGAGED fast stream onto the exact engine at a
        byte-aligned seam, carrying the 32 KiB window, so that params,
        prime, PARTIAL_FLUSH and BLOCK work mid-stream as zlib's do."""
        if self._fast is not None:
            self._eng = self._fast.migrate_to_exact()
            self._finished = self._fast.finished
            self._fast = None
            self._fast_ok = False

    # introspection
    @property
    def total_in(self) -> int:
        return (self._fast or self._eng).total_in

    @property
    def total_out(self) -> int:
        return (self._fast or self._eng).total_out

    @property
    def pending(self) -> tuple[int, int]:
        if self._fast is not None:
            return (len(self._fast.pending), 0)
        return self._eng.pending_info()

    @property
    def data_type(self):
        return (self._fast or self._eng).data_type

    def bound(self, source_len: int) -> int:
        return self._eng.bound(source_len)

    def set_dictionary(self, dictionary: bytes) -> None:
        self._deopt()
        self._to_exact()
        rc = self._eng.set_dictionary(dictionary)
        if rc != ReturnCode.Ok:
            raise DeflateError(rc)

    def set_header(self, head) -> None:
        self._deopt()
        self._to_exact()  # engaged => header already written => StreamError
        rc = self._eng.set_header(head)
        if rc != ReturnCode.Ok:
            raise DeflateError(rc)

    def params(self, level: int, strategy: Strategy = Strategy.Default) -> None:
        self._deopt()
        self._to_exact()
        rc = self._eng.params(level, strategy)
        if rc != ReturnCode.Ok:
            raise DeflateError(rc)

    def prime(self, bits: int, value: int) -> None:
        self._deopt()
        self._to_exact()
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
        if (
            self._fast is None
            and self._fast_ok
            and self._eng.total_in == 0
            and not self._eng.pending
            and flush in (
                DeflateFlush.NO_FLUSH, DeflateFlush.SYNC_FLUSH,
                DeflateFlush.FULL_FLUSH, DeflateFlush.FINISH,
            )
        ):
            from . import faststream

            self._fast = faststream.FastDeflateEngine(self.config, self.device)
        if self._fast is not None and flush in (
            DeflateFlush.PARTIAL_FLUSH, DeflateFlush.BLOCK
        ):
            self._to_exact()  # flush modes DS lacks
        eng = self._fast if self._fast is not None else self._eng
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
        clone.device = self.device
        clone._eng = self._eng.copy()
        clone._finished = self._finished
        clone._fast_ok = self._fast_ok
        clone._fast = self._fast.copy() if self._fast is not None else None
        return clone

    def reset(self) -> None:
        self._eng.reset()
        self._finished = False
        self._fast = None
        self._fast_ok = _fast_deflate_eligible(self.config)


def _fast_deflate_eligible(config: DeflateConfig) -> bool:
    from . import faststream

    return faststream.native_route() and faststream.deflate_eligible(config)


class Inflate:
    """Streaming decompressor.

    A full-window zlib/gzip/raw stream runs on IS (models/faststream.py
    FastInflateEngine). The introspection and stateful extras
    (set_dictionary, get_header, prime, sync) keep the fast path off
    BEFORE it engages, so that their exact semantics stay on the exact
    engine.
    """

    def __init__(self, config: InflateConfig | None = None, *, device=None, **kwargs):
        if config is None:
            config = InflateConfig(**kwargs)
        self.config = config
        self.device = device
        self._eng = Inflator(config)
        self._finished = False
        self._fast = None
        self._fast_ok = _fast_eligible(config)

    def _deopt(self) -> None:
        """Disable the fast path (only effective before engagement;
        the advanced APIs below call this so they always run on the exact
        engine)."""
        if self._fast is None:
            self._fast_ok = False

    @property
    def total_in(self) -> int:
        return (self._fast or self._eng).total_in

    @property
    def total_out(self) -> int:
        return (self._fast or self._eng).total_out

    @property
    def msg(self) -> str | None:
        return (self._fast or self._eng).msg

    @property
    def data_type(self) -> int:
        return (self._fast or self._eng).data_type

    @property
    def dict_id(self) -> int:
        return (self._fast or self._eng).dict_id

    def set_dictionary(self, dictionary: bytes) -> None:
        self._deopt()
        if self._fast is not None:
            rc = self._fast.set_dictionary(dictionary)
        else:
            rc = self._eng.set_dictionary(dictionary)
        if rc != ReturnCode.Ok:
            raise InflateError(rc, self.msg)

    def get_header(self):
        self._deopt()
        return self._eng.get_header()

    def header_fields(self):
        return self._eng.header_fields()

    def prime(self, bits: int, value: int) -> None:
        self._deopt()
        rc = self._eng.prime(bits, value)
        if rc != ReturnCode.Ok:
            raise InflateError(rc)

    def sync(self, data: bytes) -> tuple[ReturnCode, int]:
        self._deopt()
        return self._eng.sync(data)

    def sync_point(self) -> bool:
        if self._fast is not None:
            return self._fast.at_boundary()
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
        if (
            self._fast is None
            and self._fast_ok
            and self._eng.total_in == 0
            and self._eng.total_out == 0
            and flush in (
                InflateFlush.NO_FLUSH, InflateFlush.SYNC_FLUSH, InflateFlush.FINISH
            )
        ):
            from . import faststream

            self._fast = faststream.FastInflateEngine(self.config, self.device)
        eng = self._fast if self._fast is not None else self._eng
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
        clone.device = self.device
        clone._eng = self._eng.copy()
        clone._finished = self._finished
        clone._fast_ok = self._fast_ok
        clone._fast = self._fast.copy() if self._fast is not None else None
        return clone

    def reset(self) -> None:
        self._eng.reset()
        self._finished = False
        self._fast = None
        self._fast_ok = _fast_eligible(self.config)


def _fast_eligible(config: InflateConfig) -> bool:
    from . import faststream

    return faststream.native_route() and faststream.eligible(config)
