"""Region decode on the device through the inflate kernel K6.

The port of zlib_rs_tpu/parallel/inflate.py's `decompress_chunks` (lines
353-485), kernel route only. `decompress_foreign` (the zran-indexed decode
of foreign streams) waits for the port of the host engines, and the XLA
engines "lockstep" and "turbo" are not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _device
from ..ops.kernels import inflate_kernel as IK
from .pipeline import _note_fallback

# raw deflate of b"" (final fixed block, EOB only): pads lane counts
_EMPTY_REGION = b"\x03\x00"


def _pow2_at_least(n: int, floor: int) -> int:
    v = max(n, floor)
    return 1 << (v - 1).bit_length()


def decompress_chunks(
    bodies: list[bytes],
    out_sizes: list[int],
    windows: list[bytes] | None = None,
    start_bits: list[int] | None = None,
    engine: str = "auto",
    *,
    device=None,
) -> list[bytes]:
    """Decode B independent byte-aligned multi-block regions with K6 on
    `device` (the GPU when None; "cpu" runs its plain version).

    Bodies may be compress_parallel chunk bodies, whole raw streams or
    regions of a longer stream: `windows` supplies each region's history
    (its last 32 KiB prime the output), and `start_bits` lets a region
    begin at a sub-byte bit offset within its first byte. Lane counts and
    row lengths are padded to powers of two (dummy lanes hold an empty
    final block), as the reference buckets its shapes.

    engine="kernel" raises ValueError naming the first region that fails.
    engine="auto" counts the failure in fallback_stats() as
    `region_kernel:ValueError` and then raises the same ValueError: the
    reference retries such regions on its lockstep XLA engine, which is
    not ported. engine="lockstep" and "turbo" raise NotImplementedError.
    The reference's gate `max_out + window + row <= 384 KiB` is its TPU
    kernel's SMEM budget; the port has no such budget and drops it.
    """
    if engine in ("lockstep", "turbo"):
        raise NotImplementedError(
            f"engine={engine!r} is an XLA decode engine of the JAX package, "
            "which is not ported yet"
        )
    if engine not in ("auto", "kernel"):
        raise ValueError(f"unknown engine {engine!r}")
    if not bodies:
        return []
    dev = _device.resolve_device(device)
    n_real = len(bodies)
    bodies = list(bodies)
    out_sizes = list(out_sizes)
    sb_list = list(start_bits) if start_bits else [0] * n_real
    win_list = list(windows) if windows is not None else None
    B = _pow2_at_least(n_real, 1)
    while len(bodies) < B:
        bodies.append(_EMPTY_REGION)
        out_sizes.append(0)
        sb_list.append(0)
        if win_list is not None:
            win_list.append(b"")
    L = _pow2_at_least(max(len(b) for b in bodies) + 8, 64)
    comp = np.zeros((B, L), np.uint8)
    for i, b in enumerate(bodies):
        comp[i, : len(b)] = np.frombuffer(b, np.uint8)
    targets = np.asarray(out_sizes, np.int32)
    max_out = _pow2_at_least(int(targets.max()), 1024) if int(targets.max()) else 1024
    win = None
    if win_list is not None and any(win_list):
        wlen = 32768
        wins = np.zeros((B, wlen), np.uint8)
        for i, w in enumerate(win_list):
            if w:
                w = w[-wlen:]
                wins[i, wlen - len(w) :] = np.frombuffer(w, np.uint8)
        win = torch.from_numpy(wins).to(dev)
    # LE32 words with 2 zero tail words
    words = np.concatenate([comp.view("<u4"), np.zeros((B, 2), np.uint32)], axis=1)
    out_b, produced, bad, _end_bit = IK.decode_streams(
        torch.from_numpy(words.view(np.int32)).to(dev),
        torch.from_numpy(np.asarray(sb_list, np.int32)).to(dev),
        torch.from_numpy(np.array([len(b) * 8 for b in bodies], np.int32)).to(dev),
        torch.from_numpy(targets).to(dev),
        max_out=max_out,
        win=win,
    )
    ok = ~bad.cpu().numpy() & (produced.cpu().numpy() >= targets)
    if not ok[:n_real].all():
        which = int(np.flatnonzero(~ok[:n_real])[0])
        err = ValueError(f"region {which} failed to decode on device")
        if engine == "auto":
            _note_fallback("region_kernel", err)
        raise err
    out_np = out_b.cpu().numpy()
    return [out_np[i, : int(out_sizes[i])].tobytes() for i in range(n_real)]
