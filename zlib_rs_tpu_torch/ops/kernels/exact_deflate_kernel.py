"""EX: zlib-exact deflate of independent chunks (csrc/exact_deflate.cu),
its plain version and the wrapper.

The port of the encode half of the reference's native engine
(zlib_rs_tpu/native.py `deflate_chunk` and `deflate_parallel`, C++
ChunkDeflater in native/zrs_native.cpp): it replaces no `pallas_call`
site. Each chunk is the bytes `data[start - dict_len : start + len]`, its
dictionary (the window that primes it) first; its output is native's
`deflate_chunk(chunk, level, final, window)`: for levels 1-9 stdlib zlib's
raw deflate of the chunk with the window as its preset dictionary, ending
in a sync seam (`00 00 ff ff`) when the chunk is not final; level 0
native's stored schedule; QUICK (10) and MEDIUM (11-13) native's own
modes.

Operands: the input bytes uint8 [N]; meta int64 [C, META], a row a chunk
(start, len, dict_len, final, out_off, out_cap); one level for all chunks.
Results: out uint8 with each chunk's bytes at out_off (out_cap bytes of
room, bytes past it dropped), lens int64 [C] (the stream's length, past
the room when it overflowed) and status int32 [C] (0, or OVERFLOW where
the length passed the room, native's -1).

The plain version runs each chunk through the port's bit-exact host
engines: `models/deflate.Deflator` in raw mode primed by `set_dictionary`
and ended by FINISH or SYNC_FLUSH for levels 0-9, `models/medium` for
QUICK and MEDIUM. A deflate in torch ops would only repeat the same
sequential loop more slowly. The wrapper runs the plain version for a CPU
tensor and launches the kernel for a CUDA one; nothing falls back.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ... import _device

# launches of the CUDA kernel; the plain version does not count
launches = {"exact_deflate": 0}

QUICK = 10
MEDIUM_BASE = 11  # MEDIUM_BASE + k: the medium variant of zlib level 4 + k
META = 6  # start, len, dict_len, final, out_off, out_cap
OVERFLOW = -1
WSIZE = 32768
WORK_BYTES = 300 * 1024  # a warp's scratch (kWorkBytes in the source)
WORK4_BYTES = 320 * 1024  # QUICK's and MEDIUM's 4-byte-hash chains (kWork4Bytes)
MAX_SLOTS = 1024  # warps a launch; each loops over its share of the chunks
# native's empty stored block, which it emits for an empty chunk at level 0
# before the seam (the host engine's SYNC_FLUSH emits only the seam)
EMPTY_STORED = b"\x00\x00\x00\xff\xff"


def is_medium(level: int) -> bool:
    return MEDIUM_BASE <= level <= MEDIUM_BASE + 2


def work_bytes(level: int) -> int:
    """A warp's scratch at `level`."""
    return WORK_BYTES + (WORK4_BYTES if level == QUICK or is_medium(level) else 0)


def chunk_room(n: int, level: int) -> int:
    """The output room of an n-byte chunk (native's: n // 250 of slack, or
    n // 8 for QUICK, which has no stored escape within a segment)."""
    return n + (n // 8 if level == QUICK else n // 250) + 4096


def _check(data, meta, level: int, kernel: str) -> None:
    if data.dim() != 1 or data.dtype != torch.uint8:
        raise ValueError(f"{kernel}: data must be uint8 [N]")
    if meta.dim() != 2 or meta.shape[1] != META or meta.dtype != torch.int64:
        raise ValueError(f"{kernel}: meta must be int64 [C, {META}]")
    if not (0 <= level <= 9 or level == QUICK or is_medium(level)):
        raise ValueError(f"{kernel}: level must be 0-9, QUICK or MEDIUM, got {level}")
    m = meta.cpu()
    if m.shape[0] and (bool((m[:, 0] - m[:, 2] < 0).any())
                       or bool((m[:, 0] + m[:, 1] > data.shape[0]).any())
                       or bool((m[:, 2] > WSIZE).any()) or bool((m[:, 1] < 0).any())):
        raise ValueError(f"{kernel}: a chunk or its dictionary lies outside the data")


def out_bytes(meta) -> int:
    """The length of the output buffer: the end of the last room."""
    m = meta.cpu()
    return int((m[:, 4] + m[:, 5]).max()) if m.shape[0] else 0


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def plain_chunk(chunk: bytes, level: int, final: bool, window: bytes) -> bytes:
    """One chunk through the port's host engines: native's bytes."""
    from ...config import DeflateConfig, DeflateFlush
    from ...models import deflate, medium

    if level == QUICK:
        return medium.compress_quick(chunk, final, window)
    if is_medium(level):
        return medium.compress_medium(chunk, level - MEDIUM_BASE + 4, final, window)
    z = deflate.Deflator(DeflateConfig(level=level, window_bits=-15))
    if window:
        z.set_dictionary(window)
    z.deflate(chunk, DeflateFlush.FINISH if final else DeflateFlush.SYNC_FLUSH)
    raw = z.take_output()
    if level == 0 and not final and not chunk:
        raw = EMPTY_STORED + raw
    return raw


def exact_deflate_plain(data, meta, level: int):
    """The plain EX: (out uint8 [out_bytes(meta)], lens int64 [C], status
    int32 [C]) on meta's device; room a chunk did not fill is 0."""
    _check(data, meta, level, "exact_deflate")
    buf = data.cpu().numpy().tobytes()
    rows = meta.cpu().tolist()
    out = np.zeros(out_bytes(meta), np.uint8)
    lens = np.zeros(len(rows), np.int64)
    st = np.zeros(len(rows), np.int32)
    for k, (start, n, dlen, final, off, cap) in enumerate(rows):
        raw = plain_chunk(buf[start : start + n], level, bool(final), buf[start - dlen : start])
        keep = min(len(raw), cap)
        out[off : off + keep] = np.frombuffer(raw[:keep], np.uint8)
        lens[k] = len(raw)
        st[k] = OVERFLOW if len(raw) > cap else 0
    dev = meta.device
    return (torch.from_numpy(out).to(dev), torch.from_numpy(lens).to(dev),
            torch.from_numpy(st).to(dev))


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _fn():
    fn = _device.library("exact_deflate").zrs_exact_deflate
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _I, _I, _P, _P, _P, _P, _I, _L, _P]
        fn.restype = ctypes.c_int
    return fn


def exact_deflate_cuda(data, meta, level: int):
    """Launch EX over CUDA operands: data uint8 [N], meta int64 [C, META].
    One warp a chunk, at most MAX_SLOTS warps (each loops over its share
    of the chunks), each with work_bytes(level) of scratch. Room a chunk
    did not fill is left unwritten (the plain version's is 0)."""
    _device.require_cuda("exact_deflate", data, meta)
    _check(data, meta, level, "exact_deflate")
    dev = data.device
    C = meta.shape[0]
    nout = out_bytes(meta)
    out = torch.empty(max(nout, 1), dtype=torch.uint8, device=dev)[:nout]
    lens = torch.zeros(C, dtype=torch.int64, device=dev)
    st = torch.zeros(C, dtype=torch.int32, device=dev)
    if C:
        nslots = max(1, min(C, MAX_SLOTS))
        stride = work_bytes(level)
        scratch = torch.empty(nslots * stride, dtype=torch.uint8, device=dev)
        data, meta = data.contiguous(), meta.contiguous()
        rc = _fn()(
            _device.ptr(data), _device.ptr(meta), C, level, _device.ptr(out), _device.ptr(lens),
            _device.ptr(st), _device.ptr(scratch), nslots, stride, _device.stream_of(data),
        )
        _device.check(rc, "exact_deflate")
        launches["exact_deflate"] += 1
    return out, lens, st


def exact_deflate(data, meta, level: int):
    """EX: the plain version for a CPU tensor, the kernel for a CUDA one."""
    fn = exact_deflate_plain if data.device.type == "cpu" else exact_deflate_cuda
    return fn(data, meta, level)
