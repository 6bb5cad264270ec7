"""Checkpointed decode of one raw-deflate stream through the inflate kernel K6.

The port of zlib_rs_tpu/parallel/checkpoint.py. The decode state between
steps is plain host data, `(bit offset, window, checksum)`, so a caller
can snapshot it (pickle, save, restore) between steps: each `decode_step`
is one K6 launch that decodes whole deflate blocks from `state.bit` until
the first block boundary at or after `target` output bytes (stop mode),
with the last 32 KiB of output primed as its window. Tables are not part
of the snapshot: checkpoints land on block boundaries, where the next
step re-derives them from the block header it parses.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass

import numpy as np
import torch

from .. import _device
from ..ops.kernels import inflate_kernel as IK

WSIZE = 32768


@dataclass
class DeviceInflateState:
    """Snapshotable decode state (plain host values)."""

    bit: int = 0                  # absolute bit offset into the stream body
    window: bytes = b""           # last <= 32 KiB of produced output
    produced: int = 0             # total output bytes so far
    adler: int = 1                # running adler32 of the output
    finished: bool = False        # BFINAL block fully decoded


def decode_step(
    body: bytes,
    state: DeviceInflateState,
    *,
    target: int,
    max_out: int | None = None,
    device=None,
) -> tuple[bytes, DeviceInflateState]:
    """One K6 launch on `device` (the GPU when None; "cpu" runs its plain
    version): decode whole blocks from `state.bit` until the first block
    boundary at or after `target` new output bytes (or BFINAL).

    `max_out` bounds the overshoot past `target` (one deflate block can
    overshoot; zlib-family encoders emit blocks well under 256 KiB of
    output, raise it for others). Raises ValueError on corrupt data or
    budget overflow so callers can fall back to an exact engine.
    """
    if state.finished:
        return b"", state
    if max_out is None:
        max_out = target + 256 * 1024
    dev = _device.resolve_device(device)
    words, comp_bits = IK.pack_streams_words([body])
    win = None
    wlen = min(len(state.window), WSIZE)
    if wlen:
        wpad = -(-wlen // 4) * 4
        wbuf = np.zeros((1, wpad), np.uint8)
        wbuf[0, wpad - wlen :] = np.frombuffer(state.window[-wlen:], np.uint8)
        win = torch.from_numpy(wbuf).to(dev)
    out_b, produced, bad, end_bit, fin_seen = IK.decode_streams(
        torch.from_numpy(words.view(np.int32)).to(dev),
        torch.tensor([state.bit], dtype=torch.int32, device=dev),
        torch.from_numpy(comp_bits).to(dev),
        torch.tensor([target], dtype=torch.int32, device=dev),
        max_out=int(max_out),
        win=win,
        stop_at_target=True,
    )
    st = torch.stack([produced, bad.to(torch.int32), end_bit, fin_seen.to(torch.int32)]).cpu()
    if int(st[1, 0]):
        raise ValueError("device checkpoint decode failed (bad block/budget)")
    n = int(st[0, 0])
    out = out_b[0, :n].cpu().numpy().tobytes()
    new_state = DeviceInflateState(
        bit=int(st[2, 0]),
        window=(state.window + out)[-WSIZE:],
        produced=state.produced + n,
        adler=zlib.adler32(out, state.adler),
        finished=bool(st[3, 0]),
    )
    return out, new_state


def decode_streaming(
    body: bytes,
    *,
    step_bytes: int,
    max_out: int | None = None,
    device=None,
):
    """Generator over checkpointed decode steps: yields (bytes, state)
    until the stream's final block. Each iteration is an independent K6
    launch; the state between iterations is host-snapshotable."""
    state = DeviceInflateState()
    while not state.finished:
        out, state = decode_step(
            body, state, target=step_bytes, max_out=max_out, device=device,
        )
        yield out, state
        if not out and not state.finished:
            raise ValueError("no progress in device checkpoint decode")
