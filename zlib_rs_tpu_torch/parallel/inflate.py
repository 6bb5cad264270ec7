"""Region decode on the device: K6 first, the lockstep engine behind it,
and the decode of foreign streams.

The port of zlib_rs_tpu/parallel/inflate.py's `decompress_chunks` (lines
353-485: the inflate kernel K6, then on a refused region the lockstep
engine of parallel/device_inflate.py) and `decompress_foreign` (lines
488-565: gzip members, or the zran regions of a monolithic zlib or raw
stream, decoded as window-primed regions). The XLA engine "turbo" lives
outside the reference package and is not ported.
"""

from __future__ import annotations


import numpy as np
import torch

from .. import _device
from ..models import zran as Z
from ..ops import checksum
from ..ops.kernels import inflate_kernel as IK
from ..utils.stages import STAGES
from . import device_inflate as DI
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
    """Decode B independent byte-aligned multi-block regions on `device`
    (the GPU when None; "cpu" runs K6's plain version and the lockstep
    engine's torch ops on the CPU).

    Bodies may be compress_parallel chunk bodies, whole raw streams or
    regions of a longer stream: `windows` supplies each region's history
    (its last 32 KiB prime the output), and `start_bits` lets a region
    begin at a sub-byte bit offset within its first byte. Lane counts and
    row lengths are padded to powers of two (dummy lanes hold an empty
    final block), as the reference buckets its shapes.

    Engines:
      * "kernel": K6 alone; raises ValueError naming the first region that
        fails;
      * "lockstep": `device_inflate.decode_regions` (a state machine a
        lane, one symbol a step), then `resolve_tokens`; raises ValueError
        naming the first bad lane;
      * "auto": K6, and when a region fails, the failure counted in
        fallback_stats() as `region_kernel:ValueError` and the regions K6
        refused decoded again on the lockstep engine (the reference
        retries every region; K6's other regions are exact, so the bytes
        are the same).
    The reference's gate `max_out + window + row <= 384 KiB` is its TPU
    kernel's SMEM budget; the port has no such budget and drops it.
    """
    if engine == "turbo":
        raise NotImplementedError(
            "engine='turbo' is an XLA decode experiment outside the JAX package and is not ported"
        )
    if engine not in ("auto", "kernel", "lockstep"):
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
    sb = torch.from_numpy(np.asarray(sb_list, np.int32)).to(dev)
    eb = torch.from_numpy(np.array([len(b) * 8 for b in bodies], np.int32)).to(dev)
    tg = torch.from_numpy(targets).to(dev)
    wlen = 0
    wins = np.zeros((B, 0), np.uint8)
    if win_list is not None and any(win_list):
        wlen = 32768
        wins = np.zeros((B, wlen), np.uint8)
        for i, w in enumerate(win_list):
            if w:
                w = w[-wlen:]
                wins[i, wlen - len(w) :] = np.frombuffer(w, np.uint8)
    win = torch.from_numpy(wins).to(dev)

    if engine in ("auto", "kernel"):
        # LE32 words with 2 zero tail words
        words = np.concatenate([comp.view("<u4"), np.zeros((B, 2), np.uint32)], axis=1)
        out_b, produced, bad, _end_bit = IK.decode_streams(
            torch.from_numpy(words.view(np.int32)).to(dev), sb, eb, tg,
            max_out=max_out, win=win if wlen else None,
        )
        ok = ~bad.cpu().numpy() & (produced.cpu().numpy() >= targets)
        out_np = out_b.cpu().numpy()
        parts = [out_np[i, : int(out_sizes[i])].tobytes() for i in range(n_real)]
        if ok[:n_real].all():
            return parts
        redo = np.flatnonzero(~ok[:n_real])
        err = ValueError(f"region {int(redo[0])} failed to decode on device")
        if engine == "kernel":
            raise err
        _note_fallback("region_kernel", err)
        # the lockstep engine decodes the regions K6 refused; K6's others stand
        vals_np = _lockstep(comp, sb, eb, tg, win, wlen, max_out, redo)
        for row, i in enumerate(redo):
            parts[i] = vals_np[row, : int(out_sizes[i])].tobytes()
        return parts

    vals_np = _lockstep(comp, sb, eb, tg, win, wlen, max_out, np.arange(B))
    return [vals_np[i, : int(out_sizes[i])].tobytes() for i in range(n_real)]


def _lockstep(comp, sb, eb, tg, win, wlen: int, max_out: int, lanes) -> np.ndarray:
    """The lockstep engine, then the token resolver, on the rows `lanes`
    of a decompress_chunks batch: uint8 [len(lanes), max_out] as numpy.
    Raises ValueError naming the first bad region by its batch index."""
    dev = sb.device
    rows = torch.from_numpy(np.asarray(lanes, np.int64)).to(dev)
    comp_t = torch.from_numpy(comp[lanes]).to(dev)
    # step budget: one output byte a literal plus slack for block headers
    max_steps = max_out + 2 + 512 * max(1, int(eb[rows].max()) // 8 // 4096)
    tk, ta, tb, n_steps, _produced, lbad = DI.decode_regions(
        comp_t, sb[rows], eb[rows], tg[rows], max_steps)
    lbad = lbad.cpu().numpy()
    if lbad.any():
        raise ValueError(f"region {int(lanes[np.flatnonzero(lbad)[0]])} failed to decode on device")
    # columns past n_steps hold no token
    S = max(1, n_steps)
    vals, _totals = DI.resolve_tokens(comp_t, tk[:, :S], ta[:, :S], tb[:, :S], win[rows],
                                      out_size=max_out, wlen=wlen)
    return vals.cpu().numpy()


GZIP_ROOM_GROWTH = 4  # the skim's room grows 4x on each BufferError
DEFLATE_MAX_RATIO = 1032  # deflate's largest expansion: a 258-byte match a 2-bit code
SKIM_FIRST = 4 << 20  # the input the first member's first skim reads
SKIM_MIN = 64 * 1024  # the least input a later member's first skim reads
SKIM_GROWTH = 4  # a skim's input grows 4x while the member ends past it


def _skim_member(rest, first: int, device) -> tuple[int, int]:
    """(output size, input bytes consumed) of the raw deflate member at the
    start of `rest` (bytes or a memoryview of the rest of the file): the
    card's speculative decode (`speculative.skim`: SP1 and SP2, no SP3),
    native's zran_index skim in the reference. The skim reads a prefix of
    `rest`, `first` bytes at first, SKIM_GROWTH times longer on each
    ValueError("truncated deflate data") until it is the whole rest, so a
    member's skim decodes about its own bytes, not every member after it.
    The room starts at the reference's, 4 x the prefix plus 1 MiB, and
    grows 4x on each BufferError up to deflate's own limit, 1032 x the
    prefix plus 1 MiB; past that the BufferError propagates. A data fault
    raises ValueError; a build, launch or no-GPU error propagates."""
    from . import speculative

    cut = min(first, len(rest))
    room = 0
    while True:
        cap = DEFLATE_MAX_RATIO * cut + (1 << 20)
        room = min(max(room, 4 * cut + (1 << 20)), cap)
        try:
            return speculative.skim(bytes(rest[:cut]), room, device=device)
        except BufferError:
            if room >= cap:
                raise
            room = min(room * GZIP_ROOM_GROWTH, cap)
        except ValueError as e:
            if cut == len(rest) or str(e) != "truncated deflate data":
                raise
            cut = min(cut * SKIM_GROWTH, len(rest))


def _gzip_members(data: bytes, device=None) -> list[tuple[bytes, int, int]]:
    """(raw body, output size, crc32) of each gzip member, each skimmed on
    `device` by `_skim_member`, as the reference splits members with its
    native engine (zlib_rs_tpu/parallel/inflate.py:503-519). The first
    member's first skim reads SKIM_FIRST bytes, a later member's twice the
    last member's body, at least SKIM_MIN: a skim's time is about one
    segment's serial decode whatever its input (its segments decode in
    parallel), so fewer, longer reads cost less than exact ones."""
    from ..models.oneshot import gzip_header_end

    view = memoryview(data)
    members = []
    pos, first = 0, SKIM_FIRST
    while pos < len(data) and data[pos : pos + 2] == b"\x1f\x8b":
        start = gzip_header_end(data, pos)
        if start is None:
            raise ValueError("truncated gzip header")
        size, used = _skim_member(view[start:], first, device)
        trailer = data[start + used : start + used + 8]
        members.append((data[start : start + used], size, int.from_bytes(trailer[:4], "little")))
        pos, first = start + used + 8, max(SKIM_MIN, 2 * used)
    return members


def decompress_foreign(data: bytes, span: int = 1 << 20, engine: str = "auto", *,
                       device=None) -> bytes:
    """Decode a zlib, gzip or raw stream that another encoder wrote, its
    regions in parallel on `device` (the GPU when None; "cpu" runs the
    plain versions).

    A gzip stream's members become independent regions, each checked
    against its crc32; each member's end is found by a skim on `device`
    (the speculative decode, `_skim_member`), whose room grows where the
    reference's fixed one raises BufferError. A monolithic zlib or raw stream is indexed by one
    pass on `device` (`models.zran.build_index`: the speculative decode's
    block starts, a point about every `span` output bytes; its full output
    is not kept, as the reference drops native's); each point starts a
    region at its sub-byte bit with its
    32 KiB window, and a zlib stream's adler32 is checked at the end;
    regions that cover no output are not decoded (see below).
    `engine` is decompress_chunks'. A bad checksum raises
    ValueError("incorrect data check"). With STAGES.enabled the host
    stages `zran_index` (or `gzip_split`), `region_decode` and
    `container_check` are timed.
    """
    if data[:2] == b"\x1f\x8b":
        with STAGES.host("gzip_split"):
            members = _gzip_members(data, device)
        with STAGES.host("region_decode"):
            parts = decompress_chunks([m[0] for m in members], [m[1] for m in members],
                                      engine=engine, device=device)
        with STAGES.host("container_check"):
            for part, (_b, _n, crc) in zip(parts, members):
                if checksum.crc32(part) != crc:
                    raise ValueError("incorrect data check")
        return b"".join(parts)

    # monolithic zlib/raw stream: zran index, then window-primed regions
    with STAGES.host("zran_index"):
        index = Z.build_index(data, span=span, device=device)
    hdr, _kind = Z._wrapper_span(data)
    cuts = [(hdr * 8, 0, b"")] + [
        ((p.in_offset - 1) * 8 + (8 - p.bits) if p.bits else p.in_offset * 8,
         p.out_offset, p.window)
        for p in index.points
    ]
    ends = [c[1] for c in cuts[1:]] + [index.total_out]
    end_bits = [c[0] for c in cuts[1:]] + [len(data) * 8]
    bodies, starts, targets, windows = [], [], [], []
    for (bitpos, out_off, window), eout, ebit in zip(cuts, ends, end_bits):
        if eout == out_off:
            # no output: the stream's start, cut again by the index's first
            # point, and a point after the final block (the Python index
            # pass records one when the last block ends a span past the
            # last point), whose bits are the trailer. The reference
            # decodes these as regions, which K6 refuses.
            continue
        # region k's bits end at cut k + 1 (its last symbol ends there), so
        # its body stops there too
        bodies.append(data[bitpos >> 3 : ((ebit + 7) >> 3) + 8])
        starts.append(bitpos & 7)
        targets.append(eout - out_off)
        windows.append(window)
    with STAGES.host("region_decode"):
        parts = decompress_chunks(bodies, targets, windows=windows, start_bits=starts,
                                  engine=engine, device=device)
        out = b"".join(parts)
    with STAGES.host("container_check"):
        if len(data) >= 2 and (data[0] & 0x0F) == 8 and ((data[0] << 8) | data[1]) % 31 == 0:
            if checksum.adler32(out) != int.from_bytes(data[-4:], "big"):
                raise ValueError("incorrect data check")
    return out
