"""The decode half of the reference's native engine on the card: the
speculative decode of one raw-deflate stream with no index, the zran index
pass built on it, and the region decode at an access point.

The port of zlib_rs_tpu/native.py's `inflate_raw` (line 212),
`inflate_speculative` (:232), `zran_index` (:289) and `inflate_region`
(:315), plus `skim`, zran_index's size and end without its output, whose C++ is native/zrs_native.cpp (`zrs_inflate_raw`,
`zrs_inflate_speculative`, `zrs_zran_index`, `zrs_inflate_region`).
`inflate_raw` is SP2's exact decode from bit 0 alone (native's one-thread
branch). The next two run the speculative decode of
ops/kernels/speculative_kernel.py:

1. The stream is cut into segments of SEGMENT_BYTES of input. Segment 0
   decodes exactly from bit 0; every other segment asks SP1 for the first
   offset in its range whose block-header chain passes the native checks.
2. SP2 decodes every segment at once, from its start bit to the first
   block start at or after its range's end (or through BFINAL), into u16
   cells with markers for references before the segment, in room for
   8 cells an input byte and the block past its end (`segment_cap`). A
   segment whose guess fails to decode tries the next offset SP1 finds
   after its guess, and one that
   outgrows its room decodes again from its start in four times the room;
   every such segment goes into one launch a round, up to MAX_ATTEMPTS
   rounds (native's 24 attempts).
3. The host walks the chain from bit 0: the segment whose start is the
   bit where the last one ended follows it. Where none does, SP2 decodes
   exactly from that bit (the history decoded so far is its reach; its
   room grows four times a try up to what is left of `max_out`) to the
   first block start at or after the next guessed start, and the walk
   goes on from there. A re-decode is exact, so the bytes, the block
   starts and every error are those of one sequential decode, whatever
   the segment size; the re-decode emits markers too, which SP3 resolves
   with the rest (native's stitch re-decodes into the resolved output
   instead, a round trip a miss).
4. SP3 resolves every marker against the real output and narrows the
   cells to bytes.

Data faults are native's: ValueError("invalid deflate data") (-1; a
reference before the stream's start is one), ValueError("truncated deflate
data") (-3) and BufferError (-2, past `max_out`), each where a sequential
decode meets it first (the ordering of a reference before the start and
the output cap inside one segment aside); DATA_FAULTS holds the two
messages. Every other error (an argument, the kernels' size limits: a
span and the whole output under 2^31 - 1 cells) has its own message and
is not a data fault. Bit positions are int64 throughout (SP1's ranges,
SP2's start, stop and end bits, the block starts, the chain walk), so the
compressed stream has no size limit of its own. Every function takes
`device=None`, meaning the GPU, and raises without one; "cpu" runs the
plain versions.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _device
from ..ops.kernels import inflate_kernel as IK
from ..ops.kernels import speculative_kernel as SK

SEGMENT_BYTES = 32 * 1024  # input bytes a segment; native's floor is 1 MiB a thread
MAX_ATTEMPTS = 24  # rounds of guesses and regrowths, native's attempts a segment
MAX_CELLS = (1 << 31) - 1  # SP2's cell indices are int32
CAP_SLACK = 1 << 18  # room past 8 cells an input byte: the block past a span's end
REGION_SLACK = 1 << 18  # inflate_region's room past `want` for the last block
DATA_FAULTS = ("invalid deflate data", "truncated deflate data")
REGION_FAULT = "region decode failed"


def segment_cap(in_bytes: int, max_out: int) -> int:
    """The first room, in cells, of a decode of `in_bytes` of input: 8
    cells a byte and CAP_SLACK. A decode that passes it decodes again in
    four times the room, up to `max_out`."""
    return min(max_out, 8 * in_bytes + CAP_SLACK, MAX_CELLS)


def _raise(why: int) -> None:
    if why == SK.INVALID:
        raise ValueError("invalid deflate data")
    if why == SK.TRUNCATED:
        raise ValueError("truncated deflate data")
    if why == SK.CAP:
        raise BufferError("output buffer too small")
    raise RuntimeError(f"speculative decode: unexpected status {why}")


class _Segment:
    """One decoded span: its cells (a view of a decode's buffer), its
    status row and its block starts, on the host."""

    def __init__(self, cells, st, recs):
        self.cells = cells[: int(st[0])]
        self.n, self.end, self.final, self.why, self.need = (int(v) for v in st[:5])
        self.start = int(st[7])
        self.recs = recs
        if st[6]:
            raise RuntimeError("speculative decode: a block-start list overflowed its bound")


def row_meta(rows, nbits: int) -> tuple[np.ndarray, int, int]:
    """SP2's operands for rows of (start, stop, cap, hist): meta int64
    [T, 8] with each row's cells and block-start list packed one after
    another (room for a block start every MIN_BLOCK_BITS of its range),
    and the two buffers' lengths."""
    meta = np.zeros((len(rows), SK.META), np.int64)
    coff = roff = 0
    for k, (start, stop, cap, hist) in enumerate(rows):
        rcap = max(0, min(stop, nbits) - start) // SK.MIN_BLOCK_BITS + 2 if start >= 0 else 0
        meta[k] = (start, stop, cap, hist, coff, roff, rcap, 0)
        coff += cap
        roff += rcap
    return meta, coff, roff


def _decode(words, nbits: int, rows) -> list[_Segment]:
    """SP2 over rows of (start, stop, cap, hist): one launch, one buffer.
    Only the block starts the segments recorded come to the host (the
    lists' room, one a 10 bits, is mostly empty)."""
    meta, ncells, nrecs = row_meta(rows, nbits)
    dev = words.device
    cells, recs, st = SK.spec_decode(words, nbits, torch.from_numpy(meta).to(dev), ncells, nrecs)
    st_np = st.cpu().numpy()
    counts = st_np[:, 5].astype(np.int64)
    first = np.concatenate([[0], np.cumsum(counts)[:-1]])
    # the used rows of every list, in order: its offset plus 0..count-1
    idx = np.repeat(meta[:, 5] - first, counts) + np.arange(int(counts.sum()))
    used = recs[torch.from_numpy(idx).to(dev)].cpu().numpy()
    return [_Segment(cells[c : c + cap], st_np[k], used[f : f + m])
            for k, (c, cap, f, m) in enumerate(zip(meta[:, 4], meta[:, 2], first, counts))]


def _exact(words, nbits: int, cur: int, stop: int, total: int, max_out: int) -> _Segment:
    """SP2 exactly from the block start `cur` (`total` bytes decoded
    before it, all in reach) to the first block start at or after `stop`,
    its room grown four times a try until the span fits or what is left
    of `max_out` does not (the segment's why is then CAP)."""
    room = max_out - total
    cap = segment_cap((stop - cur + 7) // 8, room)
    while True:
        s = _decode(words, nbits, [(cur, stop, cap, total)])[0]
        if s.why != SK.CAP or cap == room:
            return s
        if cap == MAX_CELLS:
            raise ValueError(f"speculative decode: a span decodes to more than {MAX_CELLS} cells")
        cap = min(room, 4 * cap, MAX_CELLS)


def _speculate(data: bytes, max_out: int, device, stats):
    """Steps 1-3: the chain of segments from bit 0 through BFINAL, each a
    _Segment, and its output offsets; raises the stream's error."""
    dev = _device.resolve_device(device)
    seg = SEGMENT_BYTES
    n = len(data)
    N = 8 * n
    words = torch.from_numpy(SK.stream_words(data)).to(dev)
    T = max(1, n // seg)
    bounds = [8 * k * seg for k in range(T)] + [N]
    limit = min(max_out, MAX_CELLS)
    caps = [segment_cap(seg, max_out)] * T
    final: dict[int, _Segment] = {}
    rows, keys = [(0, bounds[1], caps[0], 0)], [0]
    find, lo = list(range(1, T)), bounds[1:T]
    for attempt in range(MAX_ATTEMPTS):
        if find:  # the ranges go as lists: SP1 reads its results back in one copy
            starts = SK.block_find(words, N, lo, [bounds[k + 1] for k in find]).tolist()
            rows += [(s, bounds[k + 1], caps[k] if s >= 0 else 0, SK.WSIZE)
                     for k, s in zip(find, starts)]
            keys += find
        if not rows:
            break
        for k, segm in zip(keys, _decode(words, N, rows)):
            final[k] = segm
        # a guess that failed to decode tries SP1's next offset, as native;
        # one that outgrew its room decodes again from its start
        find = [k for k in keys if k > 0 and final[k].why in (SK.INVALID, SK.TRUNCATED)]
        lo = [final[k].start + 1 for k in find]
        keys = [k for k in keys if k > 0 and final[k].why == SK.CAP and caps[k] < limit]
        for k in keys:
            caps[k] = min(4 * caps[k], limit)
        rows = [(final[k].start, bounds[k + 1], caps[k], SK.WSIZE) for k in keys]
    cand = {s.start: s for k, s in final.items() if k > 0 and s.why == SK.OK}
    chain, ofs, cur, misses, taken = [], [], 0, 0, 0
    total = 0
    first = final[0]
    if first.why not in (SK.OK, SK.CAP):
        _raise(first.why)
    done = False
    while not done:
        if chain:
            s = cand.get(cur)
            taken += s is not None
        else:
            s = first if first.why == SK.OK else None
        if s is None:
            stop = min((b for b in cand if b > cur), default=N)
            s = _exact(words, N, cur, stop, total, max_out)
            misses += 1
            if s.why != SK.OK:
                _raise(s.why)
        if s.need > total:  # a reference before the stream's start
            _raise(SK.INVALID)
        if total + s.n > max_out:
            _raise(SK.CAP)
        chain.append(s)
        ofs.append(total)
        total += s.n
        cur = s.end
        done = bool(s.final)
    if stats is not None:
        stats.update(segment_bytes=seg, segments=T, attempts=attempt + 1, misses=misses,
                     chained=taken, guessed=len(cand))
    return chain, ofs, total, cur


def _resolve(chain, ofs, total: int) -> bytes:
    """Step 4: SP3 over the chain's cells."""
    if total == 0:
        return b""
    cells = torch.cat([s.cells for s in chain])
    for s in chain:  # the decodes' buffers go before SP3's pointers come
        s.cells = None
    seg_ofs = torch.tensor(ofs + [total], dtype=torch.int64, device=cells.device)
    out, unresolved = SK.spec_resolve(cells, seg_ofs)
    if unresolved:
        raise RuntimeError("speculative decode: a marker outlived its resolve rounds")
    return out.cpu().numpy().tobytes()


def inflate_raw(data: bytes, max_out: int, *, device=None) -> tuple[bytes, int]:
    """Decode one raw deflate stream from bit 0 through its BFINAL block:
    (output, input bytes consumed). The counterpart of native's
    inflate_raw: one exact SP2 decode (no history before the stream, so
    no marker), its room grown four times a try up to `max_out`, narrowed
    to bytes on the device. Native's errors: ValueError("invalid deflate
    data"), ValueError("truncated deflate data") (a stream that ends
    without BFINAL is one), BufferError past `max_out`."""
    dev = _device.resolve_device(device)
    data = bytes(data)
    N = 8 * len(data)
    words = torch.from_numpy(SK.stream_words(data)).to(dev)
    s = _exact(words, N, 0, N + 1, 0, max_out)
    if s.why != SK.OK:
        _raise(s.why)
    return s.cells.to(torch.uint8).cpu().numpy().tobytes(), (s.end + 7) // 8


def inflate_speculative(data: bytes, max_out: int, *, device=None,
                        stats: dict | None = None) -> tuple[bytes, int]:
    """Decode ONE raw deflate stream with no index, its segments in
    parallel on `device`. Returns (output, input bytes consumed through
    the BFINAL block). `stats`, when given, receives the segment size,
    the number of segments, SP1's rounds, the chain's re-decodes
    (`misses`) and the guessed segments it took (`chained`)."""
    chain, ofs, total, end = _speculate(bytes(data), max_out, device, stats)
    return _resolve(chain, ofs, total), (end + 7) // 8


def skim(data: bytes, max_out: int, *, device=None,
         stats: dict | None = None) -> tuple[int, int]:
    """Steps 1-3 alone: (output size, input bytes consumed through the
    BFINAL block) of ONE raw deflate stream, with no SP3 pass and no
    output on the host; the errors are inflate_speculative's. Where `data`
    is a prefix of a stream, ValueError("truncated deflate data") says the
    stream ends past it: a sequential decode of a prefix reads the
    stream's own bits up to its end, so it meets every other fault and the
    BFINAL block's end where the whole stream's decode does."""
    _chain, _ofs, total, end = _speculate(bytes(data), max_out, device, stats)
    return total, (end + 7) // 8


def zran_index(data: bytes, span: int, max_out: int, *, device=None,
               stats: dict | None = None) -> tuple[bytes, list, int]:
    """The speculative decode with its block starts: (full output, points
    [(out_offset, bit_position), ...], input bytes consumed). A point goes
    at a block start past output 0 at least `span` bytes past the last
    point (native inflate_raw_impl's rule, its first point at 0)."""
    chain, ofs, total, end = _speculate(bytes(data), max_out, device, stats)
    points, last = [], 0
    for s, base in zip(chain, ofs):
        for bit, off in s.recs.tolist():
            op = base + off
            if op > 0 and op - last >= span:
                points.append((op, bit))
                last = op
    return _resolve(chain, ofs, total), points, (end + 7) // 8


def inflate_region(data: bytes, skip_bits: int, window: bytes, want: int, *,
                   device=None) -> bytes:
    """Resume a raw deflate stream at a zran access point and decode `want`
    bytes (fewer where the stream ends), on K6 in its stop mode: `data`
    starts at the byte holding the block header, `skip_bits` of it already
    consumed, `window` the history. K6 decodes whole blocks, so the output
    room is `want` + REGION_SLACK, four times larger on each of up to
    three retries where the last block may have run past it. A data fault
    raises ValueError(REGION_FAULT)."""
    dev = _device.resolve_device(device)
    if want <= 0:
        return b""
    words, bits = IK.pack_streams_words([bytes(data)])
    words_t = torch.from_numpy(words.view(np.int32)).to(dev)
    one = lambda v: torch.tensor([v], dtype=torch.int32, device=dev)  # noqa: E731
    win = None
    if window:
        w = bytes(window[-SK.WSIZE :])
        pad = -len(w) % 4
        win = torch.from_numpy(np.frombuffer(bytes(pad) + w, np.uint8).copy()[None]).to(dev)
    max_out = want + REGION_SLACK
    for _ in range(4):
        out, produced, bad, _end, _fin = IK.decode_streams(
            words_t, one(skip_bits), one(int(bits[0])), one(want), max_out=max_out, win=win,
            stop_at_target=True)
        got = int(produced[0])
        if not bool(bad[0]):
            return out[0, : min(want, got)].cpu().numpy().tobytes()
        if got <= max_out - (1 << 16):
            break
        max_out *= 4
    raise ValueError(REGION_FAULT)
