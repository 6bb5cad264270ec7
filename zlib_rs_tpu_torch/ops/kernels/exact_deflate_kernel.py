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

Levels 1-9 go a piece at a time (`plan`): a chunk longer than PIECE
positions is resolved and chased a piece at a time, its state kept in a
record. At levels 4-9 a piece takes the resolve (`zrs_exact_resolve`:
static hash chains, then every position's two walks into 8-byte slots)
and the chase (`zrs_exact_chase`: one warp a chunk runs zlib's lazy parse
reading the slots). At levels 1-3 each slot is zlib's greedy walk under
an assumed skip map (the positions deflate_fast leaves out of its
chains), over chains built with the map's positions left out, with the
walk's reach: ROUNDS[level] rounds of the resolve, each but the first after a
dry parse
(`zrs_exact_dry`: the parse followed over the last round's slots,
unchecked, writes the next round's map), then the chase, which takes a
slot only where the map it assumed agrees with the parse's own on the
positions of its hash the walk depends on, and walks live elsewhere (over
the map's chains and the positions where the two maps differ). The bytes
are zlib's whatever the map. MEDIUM4-6 (11-13) go the same way with
native's run_medium in place of deflate_fast: 4-byte-hash chains, each
slot longest4's walk and its reach, the lookahead's walk at the next match
(so a piece's slots run MAX_MATCH past its end, `slot_end`), the map the
positions med_insert_match never inserts (a 257-258 match's interior at
MEDIUM4/5, a match's interior near the end, the dictionary's last three),
ROUNDS[level] rounds, the chase native's medium parse with the fizzle and
the carried next match. The resolve has its own plain version,
`resolve_plain` (torch), which returns the same deltas and slots, and the
dry parse `dry_plain` (numpy).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ... import _device

# launches of the CUDA kernels (at levels 1-9 "exact_deflate" counts the
# chase, "exact_resolve" the resolve, "exact_dry" the dry parse of levels
# 1-3); the plain versions do not count
launches = {"exact_deflate": 0, "exact_resolve": 0, "exact_dry": 0}

QUICK = 10
MEDIUM_BASE = 11  # MEDIUM_BASE + k: the medium variant of zlib level 4 + k
META = 6  # start, len, dict_len, final, out_off, out_cap
OVERFLOW = -1
WSIZE = 32768
WORK_BYTES = 300 * 1024  # a warp's scratch (kWorkBytes in the source)
WORK4_BYTES = 320 * 1024  # QUICK's and MEDIUM's 4-byte-hash chains (kWork4Bytes)
MAX_SLOTS = 1024  # warps a launch; each loops over its share of the chunks
MAX_MATCH, MIN_MATCH, MAX_DIST = 258, 3, 32768 - 262
WANT_MIN = 4  # MEDIUM's shortest match, and the bytes its hash4 reads
HASH_SIZE = 1 << 15
# levels 1-9 (the source's kPiece row, kTile, kLookback, kWalkThreads)
(P_BASE, P_TOTAL, P_LO, P_C0, P_C1, P_DOFF, P_S, P_E, P_SOFF, P_CBLK, P_WBLK, P_CHUNK, P_LAST,
 P_WORK) = range(14)
PIECE_FIELDS = 14
TILE = 16384  # positions a block of the chain build inserts in order
LOOKBACK = 65536  # positions before a tile whose last occurrences seed it
WALK_THREADS = 128  # resolve_walk: a thread a position
PIECE = 1 << 22  # positions of a chunk (or of a DS pump) one resolve and one chase take
# positions the pieces of one round hold at most: MAX_SLOTS chunks of
# 128 KiB, so that a round's chases overlap as many chunks as a launch
# takes (about 2 GB of slots, deltas, dlist and scratch at the most)
ROUND = 1 << 27
REC = 28  # a record in int64: DS's between pumps, a chunk's between its pieces
REC_SPOS = 1  # the record's scan position (DS's D_SPOS)
# MEDIUM's scan state in a record: whether the scan started, the carried
# next match (start, strstart, orgstart, length) and the parse's frontier
REC_STARTED, REC_MED_NEXT, REC_FRONT = 11, 21, 26
# levels 1-3 and MEDIUM: rounds of the resolve a piece (a dry parse between
# two), by level: the fastest on the H100 (PERF.md); level 3's longer
# walks make a live walk dearer, so one more round pays there. MEDIUM6
# never skips a position but near the end: one round. MEDIUM4/5 skip a
# 257-258 match's interior, which the first map gets wrong: their second
# round is taken only where the first round's slots hold such matches at
# LONG_SHARE of the positions or more (take_round): on the corpus a dry
# parse costs more than the live walks it saves, on runs of one byte it
# saves more
ROUNDS = {1: 2, 2: 2, 3: 3, MEDIUM_BASE: 2, MEDIUM_BASE + 1: 2, MEDIUM_BASE + 2: 1}
LONG_SHARE = 0.25
# native's empty stored block, which it emits for an empty chunk at level 0
# before the seam (the host engine's SYNC_FLUSH emits only the seam)
EMPTY_STORED = b"\x00\x00\x00\xff\xff"


def is_medium(level: int) -> bool:
    return MEDIUM_BASE <= level <= MEDIUM_BASE + 2


def static_level(level: int) -> bool:
    """The levels whose chains are built before the parse: zlib's
    deflate_slow (4-9), whose chains the data fixes, and deflate_fast
    (1-3), whose chains an assumed skip map thins."""
    return 1 <= level <= 9


def greedy_level(level: int) -> bool:
    """zlib's deflate_fast levels, resolved under a skip map."""
    return 1 <= level <= 3


def resolved_level(level: int) -> bool:
    """The levels whose walks the resolve runs over the card: 1-9 and
    MEDIUM."""
    return static_level(level) or is_medium(level)


def mapped_level(level: int) -> bool:
    """The levels resolved under a skip map: 1-3 and MEDIUM."""
    return greedy_level(level) or is_medium(level)


def knob_level(level: int) -> int:
    """The zlib knob row a level runs (MEDIUM4-6: native's one row deeper,
    5-7)."""
    return level - MEDIUM_BASE + 5 if is_medium(level) else level


def slot_end(row, medium: bool) -> int:
    """The end of a piece's slots: its scan's end (P_E); at MEDIUM past it
    by the lookahead's reach (MAX_MATCH), short of the positions hash4
    cannot hash (the source's slot_end)."""
    if not medium:
        return int(row[P_E])
    return max(int(row[P_S]), min(int(row[P_E]) + MAX_MATCH, int(row[P_TOTAL]) - (WANT_MIN - 1)))


def long_share(slots, level: int) -> float:
    """The share of a round's slots holding a match longer than 16 x lazy
    (one med_insert_match jumps over: its interior is never inserted)."""
    from ...config import CONFIGURATION_TABLE

    full = unsigned(slots[:, 0])
    jump = ((full & 0x7FFF) != 0) & ((full >> 15) > 16 * CONFIGURATION_TABLE[
        knob_level(level)].max_lazy)
    return float(jump.sum()) / max(slots.shape[0], 1)


def take_round(level: int, slots) -> bool:
    """Whether a round after the first runs (a dry parse, then the resolve
    again): always at levels 1-3, at MEDIUM where the last round's slots
    hold long matches at LONG_SHARE of the positions or more."""
    return not is_medium(level) or long_share(slots, level) >= LONG_SHARE


def bit_words(total: int, b0: int = 0) -> int:
    """The words of a skip map of positions [b0, total) (b0 a multiple of
    32), one spare."""
    return (total - b0 + 31) // 32 + 1


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
# levels 4-9: the plan, the plain resolve
# ---------------------------------------------------------------------------


def with_offsets(rows: list, medium: bool = False) -> tuple:
    """Piece rows with their deltas' and slots' offsets and their first
    blocks in the chain build and the walk filled in: (int64 [P,
    PIECE_FIELDS], deltas, slots, chain blocks, walk blocks) in all (at
    MEDIUM the slots to each piece's slot_end)."""
    pieces = np.array(rows, np.int64).reshape(-1, PIECE_FIELDS)
    nd = ns = cb = wb = 0
    for r in pieces:
        r[P_DOFF], r[P_SOFF], r[P_CBLK], r[P_WBLK] = nd, ns, cb, wb
        nslot = slot_end(r, medium) - r[P_S]
        nd += r[P_C1] - r[P_C0]
        ns += nslot
        cb += -(-(r[P_C1] - r[P_C0]) // TILE)
        wb += -(-nslot // WALK_THREADS)
    return pieces, int(nd), int(ns), int(cb), int(wb)


def ex_piece(row, s: int, k: int, work: int, piece: int = PIECE, medium: bool = False) -> list:
    """Chunk k's piece from position s (window-relative; the body starts at
    dict_len): the slots of [s, s + piece), the deltas from 32 KiB before
    s (a walk reaches no further back) to the last position zlib hashes
    (at MEDIUM to the lookahead's reach past the piece, short of the last
    three, which hash4 cannot hash)."""
    start, n, dlen = row[:3]
    total = dlen + n
    e = min(s + piece, total)
    c0 = max(0, s - WSIZE)
    if medium:
        c1 = max(c0, min(e + MAX_MATCH, total - (WANT_MIN - 1)))
    else:
        c1 = max(c0, min(e, total - (MIN_MATCH - 1)))
    return [start - dlen, total, 0, c0, c1, 0, s, e, 0, 0, 0, k, int(e == total), work]


def plan(rows, piece: int | None = None, round_positions: int | None = None,
         max_slots: int | None = None, level: int = 6) -> list:
    """EX's work at levels 1-9 and MEDIUM over meta rows (start, len,
    dict_len, ...): batches of consecutive chunks (at most max_slots, at
    most round_positions positions a round), each (chunks, rounds), a round
    one piece of each chunk that has one left, as with_offsets gives it. A
    chunk's Work and record are its index in the batch. The limits default
    to PIECE, ROUND and MAX_SLOTS as they stand at the call."""
    piece = PIECE if piece is None else piece
    round_positions = ROUND if round_positions is None else round_positions
    max_slots = MAX_SLOTS if max_slots is None else max_slots
    out, i, C = [], 0, len(rows)
    while i < C:
        j, held = i, 0
        while j < C and j - i < max_slots:
            take = min(int(rows[j][1]), piece)
            if j > i and held + take > round_positions:
                break
            held += take
            j += 1
        rounds, r = [], 0
        while True:
            prs = []
            for w, k in enumerate(range(i, j)):
                s = int(rows[k][2]) + r * piece
                if r == 0 or s < int(rows[k][2]) + int(rows[k][1]):
                    prs.append(ex_piece(rows[k], s, k, w, piece, is_medium(level)))
            if not prs:
                break
            rounds.append(with_offsets(prs, is_medium(level)))
            r += 1
        out.append((j - i, rounds))
        i = j
    return out


def unsigned(t):
    """A resolve's deltas (int16 storage of u16) or slots as their values,
    int64."""
    return t.to(torch.int64) & (0xFFFF if t.dtype == torch.int16 else 0xFFFFFFFF)


def _lcp(data, base, total, pos, cur):
    """match258 and match258_z of longest, vectorised: the first index < 258
    where the bytes at pos and cur differ over each entry's data (from
    `base`) zero-extended past its `total`, or 258."""
    out = torch.full_like(pos, MAX_MATCH)
    alive = torch.arange(pos.numel(), device=pos.device)
    for off in range(0, MAX_MATCH, 16):
        w = min(16, MAX_MATCH - off)
        ar = torch.arange(off, off + w, device=pos.device)
        b, t = base[alive, None], total[alive, None]

        def at(x):
            x = x[:, None] + ar
            v = data[b + torch.minimum(x, t - 1)]
            return torch.where(x < t, v, torch.zeros_like(v))

        neq = at(pos[alive]) != at(cur[alive])
        hit = neq.any(1)
        out[alive[hit]] = off + neq[hit].to(torch.int8).argmax(1)
        alive = alive[~hit]
        if not alive.numel():
            break
    return out


def resolve_plain(data, pieces, level: int, head_old=None, ring=None, bits=None,
                  bit_stride: int = 0):
    """The plain resolve over piece rows (int64 [P, PIECE_FIELDS], on any
    device): (deltas int16 [n] holding u16, slots int32 [m, 2]) as
    zrs_exact_resolve writes them. The deltas by definition: each position's
    distance to the last earlier position of [lo, p) with its hash that
    `bits` leaves in (else head_old's, else 0), capped at 0xffff. The walks
    longest's, every piece's positions at once, a step of every live walk
    per candidate; without the anchored pre-reject, which passes over only
    candidates that cannot beat the best and so changes no result. head_old int32 [32768] and ring
    (int16 [32768] holding u16) are DS's handle tables; bits (int32 words
    holding u32) the skip maps of levels 1-3 and MEDIUM, a piece's at P_WORK
    * bit_stride from its P_LO rounded down to 32 (None: every position
    in). MEDIUM: hash4's chains (head_old int32 [65536]), each slot
    longest4's walk (the best from WANT_MIN - 1) and its reach, with the
    position's hash4 folded to 15 bits in the reach word's high half, to
    the piece's slot_end."""
    if not resolved_level(level):
        raise ValueError(f"exact_resolve: level must be 1-9 or MEDIUM, got {level}")
    from ...config import CONFIGURATION_TABLE

    medium = is_medium(level)
    need = WANT_MIN if medium else MIN_MATCH
    dev = data.device
    rows = pieces.cpu().tolist()
    ends = [slot_end(r, medium) for r in rows]
    nd = sum(r[P_C1] - r[P_C0] for r in rows)
    ns = sum(se - r[P_S] for r, se in zip(rows, ends))
    deltas = torch.zeros(max(nd, 1), dtype=torch.int64, device=dev)
    slots = torch.zeros(max(ns, 1), 2, dtype=torch.int64, device=dev)
    cfg = CONFIGURATION_TABLE[knob_level(level)]
    nice, chain = cfg.nice_length, cfg.max_chain
    data = data.to(torch.int64)
    words = None if bits is None else unsigned(bits).to(dev)
    for r in rows:  # the deltas: a stable sort of each piece's positions by hash
        base, lo, c0, c1 = r[P_BASE], r[P_LO], r[P_C0], r[P_C1]
        if c1 <= c0:
            continue
        q0 = max(lo, c0 - LOOKBACK)
        q = torch.arange(q0, c1, device=dev)
        if medium:
            v = data[base + q] | (data[base + q + 1] << 8) | (data[base + q + 2] << 16) | \
                (data[base + q + 3] << 24)
            h = ((v * 2654435761) & 0xFFFFFFFF) >> 16
        else:
            h = ((data[base + q] << 10) ^ (data[base + q + 1] << 5) ^ data[base + q + 2]) & 0x7FFF
        order = torch.argsort(h * (c1 - q0) + (q - q0))
        hs, qs = h[order], q[order]
        if q0 == lo and head_old is not None:
            seed = head_old.to(dev).to(torch.int64)[hs]
        else:
            seed = torch.zeros_like(hs)
        # the last earlier position of the same hash left in: a running
        # maximum of (hash, position) over the positions left in
        left = torch.ones_like(qs, dtype=torch.bool)
        if words is not None:
            b0 = lo & ~31
            w = words[r[P_WORK] * bit_stride + ((qs - b0) >> 5).clamp(min=0)]
            left = (qs < b0) | (((w >> ((qs - b0) & 31)) & 1) == 0)
        key = torch.where(left, (hs << 32) + qs, torch.full_like(qs, -1))
        run = torch.cummax(key, 0).values
        before = torch.cat([torch.full((1,), -1, dtype=torch.int64, device=dev), run[:-1]])
        same = (before >= 0) & ((before >> 32) == hs)
        pred = torch.empty_like(qs)
        pred[order] = torch.where(same, before & 0xFFFFFFFF, seed)
        deltas[r[P_DOFF] : r[P_DOFF] + c1 - c0] = (q - pred).clamp(max=0xFFFF)[c0 - q0 :]

    # the walks: an entry a position of every piece
    def col(k):
        return torch.cat([torch.full((se - r[P_S],), r[k], dtype=torch.int64, device=dev)
                          for r, se in zip(rows, ends)])

    if ns == 0:
        return deltas.to(torch.int16), slots.to(torch.int32)
    pos = torch.cat([torch.arange(r[P_S], se, device=dev) for r, se in zip(rows, ends)])
    slot_at = col(P_SOFF) + pos - col(P_S)
    base, total, c0, doff = col(P_BASE), col(P_TOTAL), col(P_C0), col(P_DOFF)
    ring_v = None if ring is None else unsigned(ring).to(dev)

    def prev(x, k):
        inside = x >= c0[k]
        dv = deltas[(doff[k] + x - c0[k]).clamp(0, deltas.numel() - 1)]
        old = ring_v[x & (WSIZE - 1)] if ring_v is not None else torch.zeros_like(dv)
        dv = torch.where(inside, dv, old)
        return torch.where(dv != 0, x - dv, torch.zeros_like(x))

    greedy = mapped_level(level)
    every = torch.arange(pos.numel(), device=dev)
    base_all, pos_all, slot_at_all = base, pos, slot_at
    if greedy:
        # no walk: the reach is hash_head's window, max(p - MAX_DIST, 0)
        live_p = pos + need <= total
        slots[slot_at[live_p], 1] = torch.minimum(pos[live_p], torch.full_like(
            pos[live_p], MAX_DIST))
        first = prev(pos, every)
    else:
        first = prev(torch.minimum(pos, (total - MIN_MATCH).clamp(min=0)), every)
    ok = (pos + need <= total) & (first > 0) & (pos - first <= MAX_DIST)
    idx = torch.nonzero(ok).flatten()
    pos, cur, base, total = pos[idx], first[idx], base[idx], total[idx]
    nice_e = (total - pos).clamp(max=nice)
    limit = (pos - MAX_DIST).clamp(min=0)
    best = torch.full_like(pos, need - 1)
    bd = torch.zeros_like(pos)
    q = torch.zeros_like(pos)
    qset = torch.zeros_like(pos, dtype=torch.bool)
    reach = torch.zeros_like(pos)
    live = torch.arange(pos.numel(), device=dev)
    n = 0
    while live.numel():
        n += 1
        lp, lc = pos[live], cur[live]
        ml = _lcp(data, base[live], total[live], lp, lc)
        up = ml > best[live]
        best[live] = torch.where(up, ml, best[live])
        bd[live] = torch.where(up, lp - lc, bd[live])
        brk = up & (ml >= nice_e[live])
        if n == chain >> 2 and not greedy:
            snap = live[~brk]
            q[snap] = (best[snap] << 15) | bd[snap]
            qset[snap] = True
        nxt = prev(lc, idx[live])
        gone = ~brk & (n != chain) & ((nxt <= limit[live]) | (nxt >= lc))
        end = brk | (n == chain) | gone
        # the reach: the last candidate, or the window past limit (and
        # hash_head, which may lie at limit)
        reach[live] = torch.where(gone, torch.minimum(limit[live] + 1, lc), lc)
        cur[live] = torch.where(end, lc, nxt)
        live = live[~end]
    full = (best << 15) | bd
    at = slot_at[idx]
    slots[at, 0] = full
    slots[at, 1] = pos - reach if greedy else torch.where(qset, q, full)
    if medium:  # each hashed position's hash4 folded to 15 bits, the chase's ldh index
        hp = torch.nonzero(live_p).flatten()
        q4 = base_all[hp] + pos_all[hp]
        v = data[q4] | (data[q4 + 1] << 8) | (data[q4 + 2] << 16) | (data[q4 + 3] << 24)
        slots[slot_at_all[hp], 1] |= (((v * 2654435761) & 0xFFFFFFFF) >> 16 & 0x7FFF) << 16
    return deltas.to(torch.int16), slots.to(torch.int32)


def _dry_medium(r, level: int, slots, bitv, rec, buf) -> None:
    """MEDIUM's dry parse of one piece (the source's dry_medium): native's
    run_medium over the slots, unchecked, from the record's state (rec,
    int64 [REC], not started: from P_S) to P_E, each insert
    med_insert_match would make a decision in `bitv` (the piece's map as
    bits from its P_LO rounded down to 32): the positions from the frontier
    to an insert never inserted, the insert in."""
    from ...config import CONFIGURATION_TABLE
    from ...models.medium import _Medium

    total, base, b0 = r[P_TOTAL], r[P_BASE], r[P_LO] & ~31
    lazy = CONFIGURATION_TABLE[knob_level(level)].max_lazy
    win = _Medium.__new__(_Medium)
    win.data = bytes(buf[base : base + total])
    if rec[REC_STARTED]:
        sp, front = int(rec[REC_SPOS]), int(rec[REC_FRONT])
        carry = [int(x) for x in rec[REC_MED_NEXT : REC_MED_NEXT + 4]]
    else:
        sp = front = r[P_S]
        carry = [0, 0, 0, 0]
    end4 = total - (WANT_MIN - 1)

    def decide(a: int, e: int) -> None:
        nonlocal front
        e = min(e, end4)
        if e <= front or e <= a:
            return
        bitv[front - b0 : a - b0] = 1
        bitv[max(a, front) - b0 : e - b0] = 0
        front = e

    def walk(p: int) -> list:
        m = [0, p, p, 1]
        if p + WANT_MIN <= total:
            decide(p, p + 1)
            v = int(slots[r[P_SOFF] + p - r[P_S], 0])
            if v & 0x7FFF:
                m[0], m[3] = p - (v & 0x7FFF), min(v >> 15, total - p)
        return m

    while sp < r[P_E]:
        if carry[3] > 0:
            cur, carry = carry, [0, 0, 0, 0]
        else:
            cur = walk(sp)
        start, strstart, org, length = cur
        if total - strstart > length + WANT_MIN:  # med_insert_match's inserts
            if length < WANT_MIN:
                strstart, length = strstart + 1, length - 1
                if length > 0 and strstart >= org:
                    decide(strstart, strstart + (length if strstart + length > org
                                                 else org - strstart + 1))
            elif length <= 16 * lazy and total - strstart >= WANT_MIN:
                strstart, length = strstart + 1, length - 1
                if strstart >= org:
                    decide(strstart, strstart + (length if strstart + length > org
                                                 else org - strstart + 1))
                elif org < strstart + length:
                    decide(org, strstart + length)
            elif strstart + length >= 1:
                decide(strstart + length - 1, strstart + length)
        if total - cur[1] > MIN_MATCH + MAX_MATCH + 1:  # the lookahead and the fizzle
            nm = walk(cur[1] + cur[3])
            if nm[3] >= WANT_MIN:
                win.fizzle(cur, nm)
            carry = nm
        sp = cur[1] + cur[3]


def dry_plain(pieces, level: int, slots, bits, bit_stride: int, recs=None, data=None) -> None:
    """The plain dry parse (numpy): over piece rows (int64 [P,
    PIECE_FIELDS]), the resolve's slots (int64 values [*, 2]) and the skip
    maps `bits` (uint32 words, written in place, a piece's at P_WORK *
    bit_stride from its P_LO rounded down to 32), as zrs_exact_dry: from
    max(P_S, the record's spos) (recs int64 [*, REC], or None) to P_E,
    the map rewritten from start to the end of the word that holds
    min(e + MAX_MATCH, total) - 1, the bits below start kept. MEDIUM
    (`_dry_medium`) takes the records (EX's, or DS's one) and the data
    (bytes or uint8, the pieces' P_BASE into it)."""
    from ...config import CONFIGURATION_TABLE

    if is_medium(level):
        buf = np.frombuffer(data, np.uint8) if isinstance(data, (bytes, bytearray)) \
            else np.asarray(data, np.uint8)
        for r in np.asarray(pieces).tolist():
            off = r[P_WORK] * bit_stride
            bitv = np.unpackbits(bits[off:].view(np.uint8), bitorder="little")
            _dry_medium(r, level, slots, bitv, recs[r[P_WORK] * REC :], buf)
            bits[off:] = np.packbits(bitv, bitorder="little").view(np.uint32)
        return
    lazy = CONFIGURATION_TABLE[level].max_lazy
    for r in np.asarray(pieces).tolist():
        total, e, b0 = r[P_TOTAL], r[P_E], r[P_LO] & ~31
        off = r[P_WORK] * bit_stride
        start = r[P_S] if recs is None else max(r[P_S], int(recs[r[P_WORK] * REC + REC_SPOS]))
        stop = min(e + MAX_MATCH, total)
        bitv = np.unpackbits(bits[off:].view(np.uint8), bitorder="little")
        if start < stop:
            bitv[start - b0 : ((stop - 1 - b0) // 32 + 1) * 32] = 0
        p = start
        while p < e:
            if p + MIN_MATCH <= total:
                v = int(slots[r[P_SOFF] + p - r[P_S], 0])
                if v & 0x7FFF:
                    end = p + min(v >> 15, total - p)
                    if not (end - p <= lazy and total - end >= MIN_MATCH):
                        bitv[p + 1 - b0 : end - b0] = 1
                    p = end
                    continue
            p += 1
        bits[off:] = np.packbits(bitv, bitorder="little").view(np.uint32)


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


def _resolve_fn():
    fn = _device.library("exact_deflate").zrs_exact_resolve
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _I, _I, _P, _P, _P, _P, _L, _L, _P, _P, _L, _P]
        fn.restype = ctypes.c_int
    return fn


def _dry_fn():
    fn = _device.library("exact_deflate").zrs_exact_dry
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _I, _I, _P, _P, _P, _L, _P]
        fn.restype = ctypes.c_int
    return fn


def _chase_fn():
    fn = _device.library("exact_deflate").zrs_exact_chase
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _L, _P, _P, _P, _P, _L, _P, _P, _P]
        fn.restype = ctypes.c_int
    return fn


def _opt(t):
    return None if t is None else _device.ptr(t)


def resolve_cuda(data, pieces, level: int, deltas, slots, chain_blocks: int, walk_blocks: int,
                 head_old=None, ring=None, count=None, bits=None, bit_stride: int = 0) -> None:
    """Launch the resolve over CUDA operands: data uint8, pieces int64 [P,
    PIECE_FIELDS] (with_offsets), deltas int16 and slots int32 [*, 2] to
    fill (chain_blocks 0 keeps the deltas of an earlier build, walk_blocks
    0 builds them alone); head_old and ring DS's handle tables (uint8 views
    of its Work); count (int64 [1] or None) adds the candidates the walks
    compare; at levels 1-3 and MEDIUM bits (int32, or None) the assumed skip
    maps, a piece's at P_WORK * bit_stride, whose positions the chains leave
    out (MEDIUM's head_old is head4, int32 [65536])."""
    _device.require_cuda("exact_resolve", data, pieces, deltas, slots)
    if not resolved_level(level):
        raise ValueError(f"exact_resolve: level must be 1-9 or MEDIUM, got {level}")
    if bits is not None and not mapped_level(level):
        raise ValueError("exact_resolve: a skip map is for levels 1-3 and MEDIUM")
    rc = _resolve_fn()(
        _device.ptr(data), _device.ptr(pieces), pieces.shape[0], level, _opt(head_old), _opt(ring),
        _device.ptr(deltas), _device.ptr(slots), chain_blocks, walk_blocks, _opt(count),
        _opt(bits), bit_stride, _device.stream_of(data),
    )
    _device.check(rc, "exact_resolve")
    launches["exact_resolve"] += 1


def dry_cuda(pieces, level: int, slots, bits, bit_stride: int, recs=None, data=None) -> None:
    """Launch the dry parse at levels 1-3 and MEDIUM: one warp a piece
    follows the last round's slots from max(P_S, its record's spos) (recs
    None: P_S) and writes the next round's skip map into bits. MEDIUM
    resumes each piece from its record (DS's own) and reads `data` (the
    pieces' bytes, for the fizzle)."""
    _device.require_cuda("exact_dry", pieces, slots, bits)
    if not mapped_level(level):
        raise ValueError(f"exact_dry: level must be 1-3 or MEDIUM, got {level}")
    if is_medium(level) and (recs is None or data is None):
        raise ValueError("exact_dry: MEDIUM takes the records and the data")
    rc = _dry_fn()(_opt(data), _device.ptr(pieces), pieces.shape[0], level, _opt(recs),
                   _device.ptr(slots), _device.ptr(bits), bit_stride, _device.stream_of(slots))
    _device.check(rc, "exact_dry")
    launches["exact_dry"] += 1


def chase_cuda(data, meta, pieces, level: int, out, lens, st, recs, scratch, slots, deltas,
               clk=None, dlist=None, bits=None, bit_stride: int = 0, stats=None) -> None:
    """Launch EX's chase at levels 1-9 and MEDIUM: one warp a piece of
    `pieces` (one piece of a chunk a launch), after the resolve of the same
    pieces; clk (int64 [P, 3] or None) takes each warp's clock64 cycles: in
    all, in flush_block, and of those in emit_symbols; at levels 1-3 and
    MEDIUM `deltas` are
    the last round's chains, `dlist` (int16, as deltas) the chase's
    scratch, bits holds the maps the slots assumed (the chase leaves the
    parse's own there) and stats (int64 [2] or None) adds the loop tops
    and the live walks."""
    _device.require_cuda("exact_deflate", data, meta, pieces, out, recs, scratch, slots, deltas)
    rc = _chase_fn()(
        _device.ptr(data), _device.ptr(meta), _device.ptr(pieces), pieces.shape[0], level,
        _device.ptr(out), _device.ptr(lens), _device.ptr(st), _device.ptr(recs),
        _device.ptr(scratch), WORK_BYTES, _device.ptr(slots), _device.ptr(deltas), _opt(dlist),
        _opt(bits), bit_stride, _opt(clk), _opt(stats), _device.stream_of(data),
    )
    _device.check(rc, "exact_deflate")
    launches["exact_deflate"] += 1


def medium_map(rows, stride: int) -> np.ndarray:
    """MEDIUM's first map of a batch of chunks (meta rows), bit_words
    `stride` a chunk: the last three positions of each dictionary set
    (native hashes no dictionary string that passes its end), the rest
    clear."""
    words = np.zeros(len(rows) * stride, np.uint32)
    for w, r in enumerate(rows):
        for q in range(max(0, int(r[2]) - 3), int(r[2])):
            words[w * stride + (q >> 5)] |= np.uint32(1 << (q & 31))
    return words


def run_static(data, meta, level: int, resolve, chase, dry=None):
    """EX at levels 1-9 and MEDIUM over `plan`: each round of pieces a
    resolve, then a chase. At levels 1-3 and MEDIUM ROUNDS[level] rounds
    each build the chains under the skip map and walk them, a dry parse
    before each but the first (at MEDIUM only where take_round says), over
    each batch's maps (zeros to start, at MEDIUM the dictionaries' tails
    set; bit_words of its longest chunk a chunk). `resolve(data, pieces,
    level, deltas, slots, chain_blocks,
    walk_blocks)`, `dry(pieces, level, slots, bits, bit_stride, recs)` (at
    MEDIUM also data=) and `chase(data, meta, pieces, level, out, lens, st,
    recs, scratch, slots, deltas)` are the launches (the CPU tests pass the
    host build's); at levels 1-3 and MEDIUM the resolve also takes bits=
    and bit_stride=, and the chase dlist= (its scratch), bits= and
    bit_stride=."""
    dev = data.device
    C = meta.shape[0]
    rows = meta.cpu().tolist()
    nout = out_bytes(meta)
    out = torch.empty(max(nout, 1), dtype=torch.uint8, device=dev)[:nout]
    lens = torch.zeros(C, dtype=torch.int64, device=dev)
    st = torch.zeros(C, dtype=torch.int32, device=dev)
    greedy = mapped_level(level)
    medium = is_medium(level)
    first = 0
    for nchunks, rounds in plan(rows, level=level):
        recs = torch.zeros(nchunks * REC, dtype=torch.int64, device=dev)
        scratch = torch.empty(nchunks * WORK_BYTES, dtype=torch.uint8, device=dev)
        kw = {}
        if greedy:
            batch = rows[first : first + nchunks]
            stride = max(bit_words(int(r[1]) + int(r[2])) for r in batch)
            if medium:
                bits = torch.from_numpy(medium_map(batch, stride).view(np.int32)).to(dev)
            else:
                bits = torch.zeros(nchunks * stride, dtype=torch.int32, device=dev)
            kw = {"bits": bits, "bit_stride": stride}
        first += nchunks
        extra = {"data": data} if medium else {}
        for pieces, nd, ns, cb, wb in rounds:
            pt = torch.from_numpy(pieces).to(dev)
            deltas = torch.empty(max(nd, 1), dtype=torch.int16, device=dev)
            slots = torch.empty(max(ns, 1), 2, dtype=torch.int32, device=dev)
            for r in range(ROUNDS[level] if greedy else 1):
                if r:
                    if not take_round(level, slots):
                        break
                    dry(pt, level, slots, bits, stride, recs, **extra)
                resolve(data, pt, level, deltas, slots, cb, wb, **kw)
            more = {"dlist": torch.empty_like(deltas), **kw} if greedy else {}
            chase(data, meta, pt, level, out, lens, st, recs, scratch, slots, deltas, **more)
    return out, lens, st


def exact_deflate_cuda(data, meta, level: int):
    """Launch EX over CUDA operands: data uint8 [N], meta int64 [C, META].
    One warp a chunk, at most MAX_SLOTS warps (each loops over its share
    of the chunks), each with work_bytes(level) of scratch; at levels 1-9
    and MEDIUM the resolve and the chase a round (run_static; at 1-3 and
    MEDIUM with the dry parse). Room a chunk did not fill is left
    unwritten (the plain version's is 0)."""
    _device.require_cuda("exact_deflate", data, meta)
    _check(data, meta, level, "exact_deflate")
    if resolved_level(level):
        return run_static(data.contiguous(), meta.contiguous(), level, resolve_cuda, chase_cuda,
                          dry_cuda)
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
