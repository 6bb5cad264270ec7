"""The reference's native engine on the card (the public names of
zlib_rs_tpu/native.py, over the port's kernels).

The JAX package binds a C++ runtime (native/zrs_native.cpp) for its host
hot loops; the port runs the same functions as hand-written CUDA kernels:

- `deflate_chunk`, `deflate_parallel`: EX (parallel/chunk_deflate.py);
- `inflate_raw`, `inflate_speculative`, `zran_index`, `inflate_region`:
  SP1-SP3 and K6 (parallel/speculative.py);
- `inflate_parallel`: K6 over indexed chunks (ops/kernels/inflate_kernel.py);
- `RawInflateStream`: IS (ops/kernels/istream_kernel.py);
- `RawDeflateStream`: DS (ops/kernels/dstream_kernel.py);
- `adler32`, `crc32`: the host checksums of ops/checksum.py, the values
  native's host ones give.

Every function and handle takes `device=None`, meaning the GPU, and raises
RuntimeError without one; "cpu" runs the kernels' plain versions.
`nthreads` arguments are accepted and ignored: the card's parallelism is
the kernels' own. `available()` is True: the kernels build at their first
use, and a build or launch failure raises at that call.
"""

from __future__ import annotations

from . import _device as _dev

# QUICK fast mode (pass as `level`): static trees only, a single hash probe
# per position, tokens emitted inside the scan loop. Valid DEFLATE, not
# zlib's bytes (levels 1-9 are the bit-exact engine).
QUICK = 10

# MEDIUM mode (pass as `level`): zlib-ng's deflate_medium algorithm class on
# a 4-byte-hash chain; MEDIUM_BASE + n is the medium variant of zlib level
# 4 + n (n in 0..2). Valid DEFLATE, byte-identical to models/medium.py.
MEDIUM_BASE = 11
MEDIUM4, MEDIUM5, MEDIUM6 = 11, 12, 13


def available() -> bool:
    """True: the kernels build at their first use (a failure raises there)."""
    return True


def adler32(data: bytes, start: int = 1) -> int:
    from .ops import checksum

    return checksum.adler32(bytes(data), start & 0xFFFFFFFF)


def crc32(data: bytes, start: int = 0) -> int:
    from .ops import checksum

    return checksum.crc32(bytes(data), start & 0xFFFFFFFF)


def deflate_chunk(data: bytes, level: int = 6, final: bool = True,
                  dictionary: bytes | None = None, *, device=None) -> bytes:
    """Raw-deflate one chunk on EX: complete blocks, byte-aligned end (a
    sync seam if not final), BFINAL set when final. Levels 0-9 (zlib's
    bytes for 1-9), QUICK or MEDIUM4-6."""
    from .parallel import chunk_deflate

    return chunk_deflate.deflate_chunk(data, level, final, dictionary, device=device)


def deflate_parallel(data: bytes, level: int = 6, chunk_size: int = 128 * 1024,
                     prime_dict: bool = True, nthreads: int = 0, *, device=None) -> bytes:
    """pigz-style chunked raw deflate (one valid stream), every chunk in
    one EX launch. `nthreads` is ignored."""
    from .parallel import chunk_deflate

    return chunk_deflate.deflate_parallel(data, level, chunk_size, prime_dict, device=device)


def inflate_raw(data: bytes, max_out: int, *, device=None) -> tuple[bytes, int]:
    """Decode one raw-deflate stream fully: (output, input consumed).
    Raises ValueError on corrupt or truncated data, BufferError past
    `max_out`."""
    from .parallel import speculative

    return speculative.inflate_raw(data, max_out, device=device)


def inflate_speculative(data: bytes, max_out: int, nthreads: int = 0, *,
                        device=None) -> tuple[bytes, int]:
    """Decode ONE raw deflate stream with no index, its segments in
    parallel (SP1-SP3): (output, input consumed). `nthreads` is ignored."""
    from .parallel import speculative

    return speculative.inflate_speculative(data, max_out, device=device)


def inflate_parallel(data: bytes, index, nthreads: int = 0, *, device=None) -> bytes:
    """Decode independently decodable indexed chunks ([(body_offset,
    body_len, out_len), ...] as compress_parallel(..., return_index=True)
    gives) with K6, one launch, every chunk a lane. Native's rules: a chunk
    decodes to its end (a chunk body need not end in BFINAL) into room of
    its out_len; one that is corrupt, truncated or longer than its out_len
    raises ValueError("chunk k failed to decode") (the first such k), and
    chunks that end short raise ValueError("decoded n bytes, expected m").
    K6 runs in its stop mode with each target one byte past out_len, so
    that a chunk which would outgrow its room shows it. `nthreads` is
    ignored."""
    import numpy as np
    import torch

    from .ops.kernels import inflate_kernel as IK

    index = list(index)
    sizes = [int(s) for _, _, s in index]
    expected = sum(sizes)
    if not index:
        return b""
    dev = _dev.resolve_device(device)
    words, bits = IK.pack_streams_words([bytes(data[o : o + ln]) for o, ln, _ in index])
    B = len(index)
    targets = np.asarray(sizes, np.int64) + 1
    out, produced, bad, end_bit, _fin = IK.decode_streams(
        torch.from_numpy(words.view(np.int32)).to(dev),
        torch.zeros(B, dtype=torch.int32, device=dev), torch.from_numpy(bits).to(dev),
        torch.from_numpy(targets.astype(np.int32)).to(dev), max_out=int(targets.max()),
        stop_at_target=True)
    produced, bad, end_bit = produced.cpu().numpy(), bad.cpu().numpy(), end_bit.cpu().numpy()
    for k, size in enumerate(sizes):
        if bad[k] or produced[k] > size or end_bit[k] > bits[k]:
            raise ValueError(f"chunk {k} failed to decode")
    got = int(produced.astype(np.int64).sum())
    if got != expected:
        raise ValueError(f"decoded {got} bytes, expected {expected}")
    out = out.cpu().numpy()
    return b"".join(out[k, :size].tobytes() for k, size in enumerate(sizes))


def zran_index(data: bytes, span: int, max_out: int, *, device=None) -> tuple[bytes, list, int]:
    """One pass over a raw deflate stream recording zran access points every
    ~`span` output bytes: (full output, [(out_offset, bit_position), ...],
    input consumed)."""
    from .parallel import speculative

    return speculative.zran_index(data, span, max_out, device=device)


def inflate_region(data: bytes, skip_bits: int, window: bytes, want: int, *,
                   device=None) -> bytes:
    """Resume a raw deflate stream at a zran access point and decode `want`
    bytes. `data` starts at the byte containing the block header."""
    from .parallel import speculative

    return speculative.inflate_region(data, skip_bits, window, want, device=device)


class RawInflateStream:
    """Resumable raw-deflate decoder handle on IS: input at any byte
    boundary, incremental output, copyable mid-stream. Container framing
    (zlib/gzip) lives in models/faststream.py."""

    __slots__ = ("_h", "done", "error")

    def __init__(self, dictionary: bytes | None = None, _handle=None, *, device=None):
        from .ops.kernels import istream_kernel

        if _handle is None:
            _handle = istream_kernel.Handle(_dev.resolve_device(device), dictionary)
        self._h = _handle
        self.done = False
        self.error = False

    def copy(self) -> "RawInflateStream":
        clone = RawInflateStream(_handle=self._h.copy())
        clone.done = self.done
        clone.error = self.error
        return clone

    def pump(self, data: bytes, max_out: int | None) -> tuple[bytes, bool]:
        """Feed `data` (always fully absorbed) and return up to `max_out`
        output bytes: (output, more_pending). On corrupt deflate data the
        bytes decoded BEFORE the error are still returned and `self.error`
        is set. After `done`, take_tail() gives the bytes past the body."""
        out_parts = []
        flags = 0
        more = True
        budget = max_out if max_out is not None else 0
        feed = bytes(data)
        while more and (budget > 0 or max_out is None):
            serve_cap = min(budget, 1 << 22) if max_out is not None else 1 << 22
            n, flags = self._h.pump(feed, serve_cap)
            feed = b""
            if n:
                out_parts.append(n)
            if flags & 2:
                self.error = True
                break
            self.done = bool(flags & 1)
            more = bool(flags & 4)
            if max_out is not None:
                break  # a bounded call serves once; the rest stays in the handle
            if not n and not more:
                break
        return b"".join(out_parts), bool(flags & 4)

    def take_tail(self, cap: int = 1 << 20) -> bytes:
        return self._h.take_tail(cap)

    def take_tail_all(self) -> bytes:
        """The whole input tail past the stream (take_tail is capped at
        1 MiB a call)."""
        parts = []
        while True:
            t = self.take_tail()
            if not t:
                break
            parts.append(t)
        return b"".join(parts)

    @property
    def total_out(self) -> int:
        return self._h.total_out

    def at_boundary(self) -> bool:
        return self._h.at_boundary()


class RawDeflateStream:
    """Resumable raw-deflate compressor handle on DS: byte-identical to
    zlib for every NO/SYNC/FULL/FINISH pump script at levels 1-9, and to
    native's handle at MEDIUM4-6. Levels 0 and QUICK raise RuntimeError at
    the first pump (native's misuse)."""

    __slots__ = ("_h", "finished")

    def __init__(self, level: int = 6, _handle=None, *, device=None):
        from .ops.kernels import dstream_kernel

        if _handle is None:
            _handle = dstream_kernel.open_stream(level, _dev.resolve_device(device))
        self._h = _handle
        self.finished = False

    def copy(self) -> "RawDeflateStream":
        clone = RawDeflateStream(_handle=self._h.copy())
        clone.finished = self.finished
        return clone

    def window(self) -> bytes:
        """Last <= 32 KiB of input seen (the live match window); meaningful
        at a flush seam. Used to migrate onto the exact engine."""
        return self._h.window()

    def pump(self, data: bytes, flush: int) -> bytes:
        """Feed data under flush (0 none / 2 sync / 3 full / 4 finish);
        returns all output that became available."""
        out = self._h.pump(bytes(data), flush)
        if flush == 4:
            self.finished = True
        return out
