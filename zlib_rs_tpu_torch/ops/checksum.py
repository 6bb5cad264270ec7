"""adler32 and crc32: the batched device checksums and the host combines.

`adler32_batch(data, lens)` is the per-row adler32 in front of the
hand-written CUDA kernel K1 (ops/kernels/checksum_kernels), and
`crc32_batch(data, lens)` the per-row crc32 in front of K7
(ops/kernels/crc_kernels): the kernel for a CUDA tensor, its plain
PyTorch version for a CPU tensor. `adler32_combine` and `crc32_combine`
join per-chunk values on the host into the zlib and gzip trailers
(`crc32_combine_gen` and `crc32_combine_op` are zlib's operator pair);
`adler32` and `crc32` are the host checksums of the host engines and of a
tail (stdlib zlib's, which equal the reference's host functions).
"""

from __future__ import annotations

import zlib

import torch

from . import gf2
from .kernels import checksum_kernels, crc_kernels

ADLER_BASE = 65521


def adler32(data, start: int = 1) -> int:
    """Host adler32 of `data`, continuing from `start` (stdlib zlib's)."""
    return zlib.adler32(data, start) & 0xFFFFFFFF


def adler32_combine(adler1: int, adler2: int, len2: int) -> int:
    """adler32 of A+B from adler32(A), adler32(B) and len(B)."""
    rem = len2 % ADLER_BASE
    a1 = adler1 & 0xFFFF
    b1 = (adler1 >> 16) & 0xFFFF
    a2 = adler2 & 0xFFFF
    b2 = (adler2 >> 16) & 0xFFFF
    a = (a1 + a2 + ADLER_BASE - 1) % ADLER_BASE
    # rem*a1 adds len2 copies of a1 into the b-sum; "- rem" removes the len2
    # copies of adler2's implicit leading 1 that would be double-counted
    b = (b1 + b2 + (rem * a1) % ADLER_BASE + ADLER_BASE - rem) % ADLER_BASE
    return ((b << 16) | a) & 0xFFFFFFFF


def adler32_batch(data: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """adler32 of each row of uint8 `data` [B, N] over its first lens[b]
    bytes. Returns int64 [B] holding the unsigned 32-bit values. A CUDA
    tensor runs the K1 kernel; a CPU tensor its plain PyTorch version."""
    if data.device.type == "cpu":
        out = checksum_kernels.adler32_batch_plain(data, lens)
    else:
        out = checksum_kernels.adler32_batch_cuda(data, lens)
    return out.to(torch.int64) & 0xFFFFFFFF


crc32_combine = gf2.crc32_combine
crc32_combine_gen = gf2.crc32_combine_gen
crc32_combine_op = gf2.crc32_combine_op


def crc32(data, start: int = 0) -> int:
    """Host crc32 of `data`, continuing from `start` (stdlib zlib's)."""
    return zlib.crc32(data, start) & 0xFFFFFFFF


def crc32_batch(data: torch.Tensor, lens: torch.Tensor | None = None) -> torch.Tensor:
    """crc32 of each row of uint8 `data` [B, N] over its first lens[b]
    bytes (all N when `lens` is None). Returns int64 [B] holding the
    unsigned 32-bit values. A CUDA tensor runs the K7 kernel; a CPU tensor
    its plain PyTorch version."""
    if lens is None:
        lens = torch.full((data.shape[0],), data.shape[1], dtype=torch.int32, device=data.device)
    if data.device.type == "cpu":
        out = crc_kernels.crc32_batch_plain(data, lens)
    else:
        out = crc_kernels.crc32_batch_cuda(data, lens)
    return out.to(torch.int64) & 0xFFFFFFFF
