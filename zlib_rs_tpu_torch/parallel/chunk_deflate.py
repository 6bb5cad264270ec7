"""The encode half of the reference's native engine on the card.

The port of zlib_rs_tpu/native.py's `deflate_chunk` (line 188) and
`deflate_parallel` (:332), whose C++ is native/zrs_native.cpp
(`zrs_deflate_chunk`, `zrs_deflate_parallel` over ChunkDeflater). Both run
EX (ops/kernels/exact_deflate_kernel.py), one warp a chunk, every chunk of
a call in one launch:

- `deflate_chunk(data, level, final, dictionary)`: one chunk, primed by
  the dictionary's last 32 KiB. Levels 1-9 give stdlib zlib's raw deflate
  of the chunk with that preset dictionary (Z_FINISH when final,
  Z_SYNC_FLUSH when not); level 0 native's stored schedule; QUICK and
  MEDIUM4-6 native's own modes.
- `deflate_parallel(data, level, chunk_size, prime_dict)`: pigz's shape,
  one raw stream of chunks cut at `chunk_size`, chunk k > 0 primed with
  the min(32 KiB, its offset) bytes before it, every chunk but the last
  ending in a sync seam; empty input is one final chunk. The chunks'
  byte-aligned outputs are joined on the card (a prefix sum of their
  lengths, then one gather) and come to the host once.

Native's rules: a level below 0 is 6, a level above 9 that is neither
QUICK nor MEDIUM is 9; a chunk's output room is n + n // 250 + 4096 (n //
8 of slack for QUICK), and an output past it raises RuntimeError, as
native's -1. `device=None` means the GPU and raises without one; "cpu"
runs EX's plain version (the port's host engines).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _device
from ..ops.kernels import exact_deflate_kernel as EK

QUICK = EK.QUICK
MEDIUM_BASE = EK.MEDIUM_BASE
MEDIUM4, MEDIUM5, MEDIUM6 = MEDIUM_BASE, MEDIUM_BASE + 1, MEDIUM_BASE + 2
DEFAULT_CHUNK = 128 * 1024
WSIZE = EK.WSIZE


def normalize_level(level: int) -> int:
    """Native's level rules (zrs_deflate_chunk): below 0 is 6, an unknown
    level above 9 is 9."""
    if level < 0:
        return 6
    if level > 9 and level != QUICK and not EK.is_medium(level):
        return 9
    return level


def chunk_meta(rows, level: int) -> np.ndarray:
    """EX's meta for chunk rows of (start, len, dict_len, final): each
    chunk's output room, chunk_room bytes, after the one before it."""
    meta = np.zeros((len(rows), EK.META), np.int64)
    room = 0
    for k, (start, n, dlen, final) in enumerate(rows):
        cap = EK.chunk_room(n, level)
        meta[k] = (start, n, dlen, final, room, cap)
        room += cap
    return meta


def _run(buf: bytes, rows, level: int, device) -> bytes:
    """EX over `buf` and its chunk rows (start, len, dict_len, final); the
    chunks' outputs joined in order."""
    dev = _device.resolve_device(device)
    data = torch.from_numpy(np.frombuffer(buf, np.uint8).copy()).to(dev)
    meta_t = torch.from_numpy(chunk_meta(rows, level)).to(dev)
    out, lens, status = EK.exact_deflate(data, meta_t, level)
    if bool((status != 0).any()):
        raise RuntimeError("exact deflate: a chunk's output passed its room")
    # the join: chunk k's bytes go to the prefix sum of the lengths before it
    total = int(lens.sum())
    dst = torch.cumsum(lens, 0) - lens
    shift = torch.repeat_interleave(meta_t[:, 4] - dst, lens, output_size=total)
    src = shift + torch.arange(total, dtype=torch.int64, device=out.device)
    return out[src].cpu().numpy().tobytes()


def deflate_chunk(data: bytes, level: int = 6, final: bool = True,
                  dictionary: bytes | None = None, *, device=None) -> bytes:
    """Raw-deflate one chunk: complete blocks, a byte-aligned end (a sync
    seam when not final), BFINAL set when final."""
    level = normalize_level(level)
    d = bytes(dictionary[-WSIZE:]) if dictionary else b""
    data = bytes(data)
    return _run(d + data, [(len(d), len(data), len(d), int(final))], level, device)


def deflate_parallel(data: bytes, level: int = 6, chunk_size: int = DEFAULT_CHUNK,
                     prime_dict: bool = True, *, device=None) -> bytes:
    """pigz-style chunked raw deflate of `data`: one valid stream."""
    level = normalize_level(level)
    data = bytes(data)
    n = len(data)
    chunk = chunk_size if chunk_size > 0 else DEFAULT_CHUNK
    nchunks = -(-n // chunk) if n else 1
    rows = []
    for k in range(nchunks):
        lo = k * chunk
        dlen = min(WSIZE, lo) if prime_dict and k else 0
        rows.append((lo, min(n, lo + chunk) - lo, dlen, int(k == nchunks - 1)))
    return _run(data, rows, level, device)
