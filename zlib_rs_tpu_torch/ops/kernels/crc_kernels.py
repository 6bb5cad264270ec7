"""K7: batched crc32 (csrc/crc32.cu) and its plain PyTorch version.

Replaces zlib_rs_tpu/ops/pallas/crc_kernels.py:crc32_batch_pallas (via
`crc32_batch_auto`). Bound on the H100: bytes, one read of the rows at
3.35 TB/s. Design: one block per row; each thread runs the table-driven
crc32 over a contiguous segment and a log-depth tree of zlib's
crc32_combine joins the segments (see the source). The TPU kernel's
limits (rows a multiple of 16 KiB, batches of 8) are its tiling: the
kernel takes any B and N, any length per row and any row stride with
contiguous rows.
"""

from __future__ import annotations

import ctypes

import torch

from ... import _device
from .. import gf2

# launches of the CUDA kernel; the plain version does not count
launches = {"crc32_batch": 0}

_TABLE = torch.from_numpy(gf2.CRC_TABLE.astype("int64"))


def crc32_batch_plain(data: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """crc32 of each row's first lens[b] bytes as int32 bit-views: the
    byte-table loop of zlib, one step per column over all rows at once,
    in int64."""
    B, N = data.shape
    table = _TABLE.to(data.device)
    ln = lens.to(torch.int64).clamp(0, N)
    d = data.to(torch.int64)
    c = torch.full((B,), 0xFFFFFFFF, dtype=torch.int64, device=data.device)
    for j in range(int(ln.max()) if B else 0):
        nxt = table[(c ^ d[:, j]) & 0xFF] ^ (c >> 8)
        c = torch.where(j < ln, nxt, c)
    c = c ^ 0xFFFFFFFF
    return (((c + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def _lib():
    fn = _device.library("crc32").zrs_crc32_batch
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def crc32_batch_cuda(data: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Launch K7 on CUDA rows `data` (uint8 [B, N], rows contiguous, any
    row stride) with int32 lengths. Returns int32 [B] bit-views."""
    _device.require_cuda("crc32_batch", data, lens)
    if data.dtype != torch.uint8 or data.dim() != 2:
        raise ValueError("crc32_batch: data must be uint8 [B, N]")
    B, N = data.shape
    if N and data.stride(1) != 1:
        raise ValueError("crc32_batch: rows must be contiguous")
    lens = lens.to(torch.int32).contiguous()
    if lens.shape != (B,):
        raise ValueError("crc32_batch: lens must be [B]")
    out = torch.empty(B, dtype=torch.int32, device=data.device)
    rc = _lib()(_device.ptr(data), data.stride(0), B, N, _device.ptr(lens),
                _device.ptr(out), _device.stream_of(data))
    _device.check(rc, "crc32_batch")
    launches["crc32_batch"] += 1
    return out
