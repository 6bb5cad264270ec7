"""K1: batched adler32 (csrc/adler32.cu) and its plain PyTorch version.

Replaces zlib_rs_tpu/ops/pallas/checksum_kernels.py:adler32_batch_pallas.
Bound on the H100: bytes, one read of the rows at 3.35 TB/s. Design: one
block of THREADS threads a row, each owning SEG contiguous bytes of every
pass, read in 16-byte loads at once; two 32-bit partials a segment by
__dp4a (its byte sum and its sum weighted by the distance to the
segment's end), joined with absolute weights, a block reduction mod 65521
(see the source). The kernel accepts any B and N, any length per row and
any row stride with contiguous rows.
"""

from __future__ import annotations

import ctypes

import torch

from ... import _device

ADLER_BASE = 65521

# csrc/adler32.cu's kThreads and kSeg: threads a row, bytes a thread a pass
THREADS = 1024
SEG = 32

# launches of the CUDA kernel; the plain version does not count
launches = {"adler32_batch": 0}


def adler32_batch_plain(data: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """adler32 of each row's first lens[b] bytes, as int32 bit-views of
    (b << 16) | a. Closed form a = 1 + sum d_i, b = len + sum (len - i) d_i
    (mod 65521) in int64."""
    B, N = data.shape
    idx = torch.arange(N, device=data.device, dtype=torch.int64)
    ln = lens.to(torch.int64).clamp(0, N)[:, None]
    live = idx[None, :] < ln
    d = torch.where(live, data.to(torch.int64), 0)
    s = d.sum(dim=1) % ADLER_BASE
    w = (torch.where(live, (ln - idx[None, :]) % ADLER_BASE, 0) * d).sum(dim=1)
    a = (1 + s) % ADLER_BASE
    b = (ln[:, 0] % ADLER_BASE + w % ADLER_BASE) % ADLER_BASE
    return ((b << 16) | a).to(torch.int32)


def _lib():
    lib = _device.library("adler32")
    fn = lib.zrs_adler32_batch
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def adler32_batch_cuda(data: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Launch K1 on CUDA rows `data` (uint8 [B, N], rows contiguous, any
    row stride) with int32 true lengths. Returns int32 [B] bit-views."""
    _device.require_cuda("adler32_batch", data, lens)
    if data.dtype != torch.uint8 or data.dim() != 2:
        raise ValueError("adler32_batch: data must be uint8 [B, N]")
    B, N = data.shape
    if N and data.stride(1) != 1:
        raise ValueError("adler32_batch: rows must be contiguous")
    lens = lens.to(torch.int32).contiguous()
    if lens.shape != (B,):
        raise ValueError("adler32_batch: lens must be [B]")
    out = torch.empty(B, dtype=torch.int32, device=data.device)
    fn = _lib()
    rc = fn(_device.ptr(data), data.stride(0), B, N, _device.ptr(lens),
            _device.ptr(out), _device.stream_of(data))
    _device.check(rc, "adler32_batch")
    launches["adler32_batch"] += 1
    return out
