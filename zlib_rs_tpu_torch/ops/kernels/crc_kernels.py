"""K7: batched crc32 (csrc/crc32.cu) and its plain PyTorch version.

Replaces zlib_rs_tpu/ops/pallas/crc_kernels.py:crc32_batch_pallas (via
`crc32_batch_auto`). Bound on the H100: bytes, one read of the rows at
3.35 TB/s; its practical floor is one shared-memory table lookup a byte.
Design: one block of THREADS threads a row, each owning SEG bytes of
every pass, the passes aligned to the row's end; every thread loads its
segment in 16-byte loads at once, runs slice-by-8 over it, shifts its
raw crc to the row's end by its constant of `shift_table`, and the block
XORs the results (see the source). The TPU kernel's limits (rows a
multiple of 16 KiB, batches of 8) are its tiling: the kernel takes any B
and N, any length per row and any row stride with contiguous rows.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ... import _device
from .. import gf2

# launches of the CUDA kernel; the plain version does not count
launches = {"crc32_batch": 0}

_TABLE = torch.from_numpy(gf2.CRC_TABLE.astype("int64"))

# csrc/crc32.cu's kThreads and kSeg: threads a row, bytes a thread a pass
THREADS = 512
SEG = 64

_SHIFTS: dict = {}  # (device, THREADS, SEG) -> the kernel's shift table


def shift_table(threads: int = THREADS, seg: int = SEG) -> np.ndarray:
    """uint32 [threads + 16]: entry t < threads is x^(8 (threads - 1 - t)
    seg) mod P, which carries thread t's raw crc to its pass's end (entry 0
    also carries a register across the other threads' segments to the
    next pass); entry threads + k is x^(-8 k) mod P, which takes out the k
    zero bytes read past a row's end to its next 16-byte boundary."""
    fwd = [gf2.x8nmodp((threads - 1 - t) * seg) for t in range(threads)]
    return np.array(fwd + [gf2.xinv8nmodp(k) for k in range(16)], np.uint32)


def _shifts_on(device: torch.device) -> torch.Tensor:
    key = (device, THREADS, SEG)
    if key not in _SHIFTS:
        _SHIFTS[key] = torch.from_numpy(shift_table(THREADS, SEG).view(np.int32)).to(device)
    return _SHIFTS[key]


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
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
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
    shifts = _shifts_on(data.device)
    rc = _lib()(_device.ptr(data), data.stride(0), B, N, _device.ptr(lens), _device.ptr(shifts),
                _device.ptr(out), _device.stream_of(data))
    _device.check(rc, "crc32_batch")
    launches["crc32_batch"] += 1
    return out
