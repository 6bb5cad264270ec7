"""The design of csrc/vhuff_expand.cu (K5 and K11b) as a numpy model,
shared by tests/test_torch_vhuff.py (K5, two-plane tapes) and
tests/test_torch_vhuff1.py (K11b, single-plane tapes): the per-walker
resolve in windows of a reader's kGroup rows, the tiling check, the fill of
bytes inside matches, synchronous pointer-jumping rounds, and the serial
body (the plain version's own chunk loop) for chunks that do not tile or
are past the chase."""

import numpy as np

from zlib_rs_tpu_torch.ops.kernels import vhuff_kernel as VK

THREADS, SEG = 512, 64  # csrc/vhuff_expand.cu: kThreads, kSeg
# a cell: a pointer to an earlier byte, KNOWN | the byte, or OPEN (the
# kernel packs these in 16 bits, pointers in 15)
KNOWN, OPEN = 1 << 20, 1 << 21


class TwoPlane:
    """K5's reader: row t of column c is (tapeA, tapeB)[t, c]; tapeB =
    cnt:3 | has:1 | len-3:8 | dist:16; an all-zero row ends the walker."""

    group = 4  # TwoPlane::kGroup

    def __init__(self, tapeA, tapeB):
        self.a = np.asarray(tapeA).view(np.uint32)
        self.b = np.asarray(tapeB).view(np.uint32)
        self.cap, self.W = self.a.shape

    def row(self, col, t):
        """(literal bytes, count, match length, dist, end)"""
        a, b = int(self.a[t, col]), int(self.b[t, col])
        length = ((b >> 4) & 0xFF) + 3 if b & 8 else 0
        return a, b & 7, length, (b >> 12) & 0xFFFF, b == 0

    def kind(self, col, t):
        b = int(self.b[t, col]) if t < self.cap else 0
        return "end" if b == 0 else "match" if b & 8 else "lit"

    def serial(self, cols, of, out_words):
        return VK._expand_chunk(self.a[:, cols].T.tolist(), self.b[:, cols].T.tolist(), of,
                                self.cap, out_words)


class SinglePlane:
    """K11b's reader: row t of column c is one token: LIT (1-3 bytes),
    MATCH, or any other kind, which ends the walker. A LIT with bits above
    its count is no row the resolve takes (the serial sprint ORs them into
    the next bytes)."""

    group = 8  # SinglePlane::kGroup

    def __init__(self, tape):
        self.t = np.asarray(tape).view(np.uint32)
        self.cap, self.W = self.t.shape

    def row(self, col, t):
        tok = int(self.t[t, col])
        if tok >> 30 == VK.VTOK_LIT:
            cnt, lits = ((tok >> 24) & 3) + 1, tok & 0xFFFFFF
            return lits, cnt, 0, 0, cnt < 3 and lits >> (8 * cnt) != 0
        if tok >> 30 == VK.VTOK_MATCH:
            return 0, 0, ((tok >> 16) & 0x3FFF) + 3, tok & 0xFFFF, False
        return 0, 0, 0, 0, True

    def kind(self, col, t):
        tok = int(self.t[t, col]) if t < self.cap else 0
        return {VK.VTOK_LIT: "lit", VK.VTOK_MATCH: "match"}.get(tok >> 30, "end")

    def serial(self, cols, of, out_words):
        return VK._expand_chunk1(self.t[:, cols].T.tolist(), of, self.cap, out_words)


def resolve(tape, col, p, p1, end, cell, edges):
    """One walker of the resolve, row by row: its literal bytes, known,
    and each match's first pointer, p - dist; the match's other bytes stay
    open. False when the walker does not tile [p, p1)."""
    if p < 0 or p > p1 or p1 > end:
        return False
    p0, t = p, 0
    while t < tape.cap and p < p1:
        lits, cnt, length, dist, stop = tape.row(col, t)
        t += 1
        if stop or cnt > 4 or p + cnt > p1:
            return False
        for i in range(cnt):
            cell[p + i] = KNOWN | ((lits >> (8 * i)) & 0xFF)
        p += cnt
        if length:
            if dist == 0 or dist > p or p + length > p1:
                return False
            cell[p] = p - dist
            edges["earlier_walker"] += p - dist < p0
            p += length
    if p == p1 and p1 > p0:  # what the serial body meets past the walker's end
        edges["past_end_" + tape.kind(col, t)] += 1
    return p == p1


def resolve_windows(tape, col, p, p1, end, cell, edges):
    """The resolve as the kernel runs it, tape.group lanes a walker: a
    window of tape.group rows, one a lane, placed by an exclusive scan of
    their lengths; the rows that start before p1 (a prefix) are taken, and
    the walker goes on after a full window. Same result as resolve."""
    if p < 0 or p > p1 or p1 > end:
        return False
    p0, G = p, tape.group
    for t0 in range(0, tape.cap, G):
        if p >= p1:
            break
        rows = [tape.row(col, t) for t in range(t0, min(t0 + G, tape.cap))]
        adv = [cnt + length for _l, cnt, length, _d, _s in rows]
        pos = (p + np.concatenate([[0], np.cumsum(adv)[:-1]])).tolist()
        taken = [g for g in range(len(rows)) if pos[g] < p1]
        edges["windows"] += 1
        for g in taken:
            lits, cnt, length, dist, stop = rows[g]
            lit_end = pos[g] + cnt
            if stop or cnt > 4 or lit_end > p1 or (length and (
                    dist == 0 or dist > lit_end or lit_end + length > p1)):
                return False
            for i in range(cnt):
                cell[pos[g] + i] = KNOWN | ((lits >> (8 * i)) & 0xFF)
            if length:
                cell[lit_end] = lit_end - dist
                edges["earlier_walker"] += lit_end - dist < p0
        p = pos[taken[-1]] + adv[taken[-1]]
        if len(taken) < G:
            break
    return p == p1


def fill(cell, q0, q1, last, last_cell, edges):
    """One segment of the fill: each open byte inside the match of the
    last head before it (`last`, the last token before q0 with its cell as
    the resolve left it, starts it); a pointer into [q0, q) takes its
    target's cell, final there; an open byte before any head is a known
    zero."""
    s, d = -1, 1
    if last >= 0 and last_cell < last:
        s, d = last, last - last_cell
        edges["carried"] += q0 < q1 and cell[q0] == OPEN
    for q in range(q0, q1):
        v = int(cell[q])
        if v == OPEN:
            j = q - s
            if s < 0:
                v = KNOWN
                edges["orphan"] += 1
            elif j < d:
                v = q - d
            else:  # inside its own match: one period back, before the match
                v = s - d + j % d
                edges["period"] += 1
        elif v < q:
            s, d = q, q - v
        else:
            s = -1
            continue
        if q0 <= v < q:
            v = int(cell[v])
            edges["compressed"] += 1
        cell[q] = v


def model(tape, offs, out_words, *, max_bytes=VK.CHASE_MAX_BYTES):
    """csrc/vhuff_expand.cu on numpy, through `tape` (TwoPlane or
    SinglePlane): per chunk the resolve, the fill in segments of one
    thread each (the last token before a segment from an exclusive max
    scan), then pointer jumping in synchronous rounds (the kernel's
    asynchronous rounds move cells at least as far), or the serial body
    (the plain version's chunk loop) for walkers that do not tile, a chunk
    past max_bytes or a row past CHASE_MAX_ROW. Returns (words uint32
    [B, out_words], branch [B], edges)."""
    offs = np.asarray(offs)
    B = offs.shape[0]
    S = tape.W // B
    nbytes = 4 * out_words
    out = np.zeros((B, out_words), np.uint32)
    branch = np.zeros(B, np.int64)
    edges = dict(rounds=[], depth=[], earlier_walker=0, carried=0, orphan=0, period=0,
                 compressed=0, windows=0, past_end_lit=0, past_end_match=0, past_end_end=0)
    for k in range(B):
        of = offs[k].tolist()
        cols = slice(k * S, (k + 1) * S)
        if max_bytes is None or (of[S] <= max_bytes and nbytes <= VK.CHASE_MAX_ROW):
            end = min(max(of[S], 0), nbytes)
            cell = np.where(np.arange(nbytes) < end, OPEN, KNOWN)
            # the kernel's windows, held against the serial walk of each walker
            serial = cell.copy()
            ok = [resolve_windows(tape, k * S + s, of[s], of[s + 1], end, cell, edges)
                  for s in range(S)]
            assert ok == [resolve(tape, k * S + s, of[s], of[s + 1], end, serial, edges)
                          for s in range(S)]
            assert not all(ok) or np.array_equal(cell, serial)
            if all(ok):
                seg = SEG * -(-end // (SEG * THREADS))
                spans = [(min(t * seg, end), min(t * seg + seg, end)) for t in range(THREADS)]
                lasts = [max([q for q in range(q0, q1) if cell[q] != OPEN], default=-1)
                         for q0, q1 in spans]
                carry = [max(lasts[:t], default=-1) for t in range(THREADS)]
                heads = [int(cell[c]) if c >= 0 else 0 for c in carry]  # before any fill
                for t, (q0, q1) in enumerate(spans):
                    fill(cell, q0, q1, carry[t], heads[t], edges)
                # hops from each byte to a known cell; every pointer is earlier
                hops = np.zeros(nbytes, np.int64)
                for q in np.flatnonzero(cell < KNOWN):
                    hops[q] = hops[cell[q]] + 1
                depth = int(hops.max())
                rounds = 1
                while True:
                    nxt = cell.copy()
                    ptrs = cell < KNOWN
                    nxt[ptrs] = cell[cell[ptrs]]
                    if np.array_equal(nxt, cell):
                        break
                    cell, rounds = nxt, rounds + 1
                # a chain of h hops is known after bit_length(h) rounds (each
                # round doubles the hops a pointer spans); the last moves none
                assert rounds == depth.bit_length() + 1
                edges["rounds"].append(rounds)
                edges["depth"].append(depth)
                out[k] = (cell & 0xFF).astype(np.uint8).view(np.uint32)
                continue
            branch[k] = VK.BRANCH_UNTILED
        else:
            branch[k] = VK.BRANCH_TOO_LARGE
        out[k] = tape.serial(cols, of, out_words)
    return out, branch, edges


def assert_bytes_equal(got, want, sizes):
    """Rows of LE32 words equal on bytes [0, sizes[k]) of each chunk k,
    the bytes an expansion defines."""
    for k, n in enumerate(sizes):
        np.testing.assert_array_equal(got[k].view(np.uint8)[:n], want[k].view(np.uint8)[:n])
