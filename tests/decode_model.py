"""The design of csrc/vhuff_decode.cu (K4 and K11a) as a numpy model,
shared by tests/test_torch_vhuff.py (K4, two-plane rows) and
tests/test_torch_vhuff1.py (K11a, single-plane rows): each block's window
of staged body words (or the body read in place when the window passes the
budget), the direct code tables built from the cascade tables with their
proof, and the serial walk of each walker under a row policy, with its
prefetched refills, and its warp's zero rows when the warp is done."""

import jax.numpy as jnp
import numpy as np

import zlib_rs_tpu.parallel.vector_inflate as JV
from zlib_rs_tpu_torch.ops.kernels import vhuff_kernel as VK
from zlib_rs_tpu_torch.parallel import vector_inflate as TV

THREADS = 128  # csrc/vhuff_decode.cu: kThreads, walkers a block
D_BITS = 9  # kDBits: the distance table's index width (a policy's kLlBits the other)
MAX_STAGE_WORDS = 44 * 1024  # kMaxStageWords
LEN_FIELD = 0xF << 24  # a direct entry's code length, in the work entry's free bits
KIND_LIT, KIND_MATCH = 0, 1
_M32 = 0xFFFFFFFF


def _i32(x: int) -> int:
    x &= _M32
    return x - (1 << 32) if x >> 31 else x


def _rev15(x: int) -> int:
    return int(f"{x & 0x7FFF:015b}"[::-1], 2)


def _work_index(pk: int, v15: int, ln: int, work_max: int) -> int:
    delta = ((v15 - (pk & 0xFFFF)) & _M32) >> (15 - ln)
    idx = _i32((pk >> 16) + delta)  # int32 wrap, as the reference
    return min(max(idx, 0), work_max)


class Alphabet:
    """One alphabet's cascade tables in a chunk's table row, and its
    direct table."""

    def __init__(self, row, lim_at, pack_at, work_at, work_max, bits):
        row = np.asarray(row, np.int64)
        self.lim = [int(v) for v in row[lim_at + 1 : lim_at + 15]]
        self.pack = [int(v) for v in row[pack_at : pack_at + 16]]
        self.work = [int(v) for v in row[work_at : work_at + work_max + 1]]
        self.work_max, self.bits = work_max, bits
        self.direct = build_direct(self, bits)

    def length(self, v15: int) -> int:
        return 1 + sum(v15 >= l for l in self.lim)

    def cascade(self, p: int):
        """(work entry, code length) of the 15 stream bits p, LSB first."""
        v15 = _rev15(p)
        ln = self.length(v15)
        return self.work[_work_index(self.pack[ln], v15, ln, self.work_max)], ln

    def lookup(self, p: int):
        """The kernel's lookup: the direct entry, else the cascade.
        Returns (work entry, code length, direct?)."""
        e = self.direct[p & ((1 << self.bits) - 1)]
        if e:
            return e & ~LEN_FIELD, (e >> 24) & 0xF, True
        return (*self.cascade(p), False)


def build_direct(a: Alphabet, bits: int) -> list:
    """build_direct<bits>: entry i (the next `bits` stream bits, LSB first)
    stands for the 15-bit values v0..v0 + 2^(15 - bits) - 1, v0 the bit
    reversal of i shifted up. It is the work entry with its code length in
    bits 24-27 where every one of those values gives one length and one
    index, else 0. As the kernel builds it: the limits sorted (the length
    of v is the least l with sorted[l] > v), each of 128 threads walking a
    run of consecutive v0 up the sorted limits (lane l of warp u from
    m0 = l 2^bits / 32 + u per)."""
    sorted_lims = [None] + sorted(a.lim) + [0x7FFFFFFF]
    step, per = 1 << (15 - bits), (1 << bits) // THREADS
    out = [0] * (1 << bits)
    for t in range(THREADS):
        l, m0 = 1, (t & 31) * ((1 << bits) // 32) + (t >> 5) * per
        for m in range(m0, m0 + per):
            v0 = m * step
            while v0 >= sorted_lims[l]:
                l += 1
            pk, entry = a.pack[l], 0
            if l <= bits and pk & ((1 << (15 - l)) - 1) == 0 and sorted_lims[l] > v0 + step - 1:
                e = a.work[_work_index(pk, v0, l, a.work_max)]
                if e & LEN_FIELD == 0:
                    entry = e | (l << 24)
            out[int(f"{m:0{bits}b}"[::-1], 2)] = entry
    return out


def tables_of(row, ll_bits: int):
    """(literal/length, distance) Alphabets of one chunk's table row, the
    literal/length table ll_bits wide."""
    return (Alphabet(row, VK.LL_LIM, VK.LL_PACK, VK.LL_WORK, 383, ll_bits),
            Alphabet(row, VK.D_LIM, VK.D_PACK, VK.D_WORK, 127, D_BITS))


def check_direct(a: Alphabet) -> float:
    """Every one of the 32,768 15-bit values p (stream bits, LSB first)
    whose direct entry is set gives the cascade's work entry and length
    there (the cascade vectorised over all p); returns the share of values
    on the direct path."""
    p = np.arange(1 << 15, dtype=np.int64)
    v15 = np.array([_rev15(int(x)) for x in p], np.int64)
    ln = 1 + (v15[:, None] >= np.array(a.lim, np.int64)[None, :]).sum(axis=1)
    pk = np.array(a.pack, np.int64)[ln]
    delta = ((v15 - (pk & 0xFFFF)) & _M32) >> (15 - ln)
    idx = (((pk >> 16) + delta + (1 << 31)) & _M32) - (1 << 31)
    want = np.array(a.work, np.int64)[np.clip(idx, 0, a.work_max)]
    d = np.array(a.direct, np.int64)[p & ((1 << a.bits) - 1)]
    hit = d != 0
    np.testing.assert_array_equal(d[hit] & ~LEN_FIELD, want[hit])
    np.testing.assert_array_equal((d[hit] >> 24) & 0xF, ln[hit])
    assert ((d[hit] >> 24) & 0xF).max(initial=1) <= a.bits
    return float(hit.mean())


def stage_budget(Lw: int, K: int) -> int:
    """The C entry's staged words a block: a clean window's bound, Lw + K,
    capped at MAX_STAGE_WORDS."""
    return min(Lw + K, MAX_STAGE_WORDS)


def block_window(start_word, block: int, S: int, Lw: int, K: int):
    """(lo, hi) of a block's body words before clipping to the array: every
    index its walkers' fetches reach."""
    sw = np.asarray(start_word[block * THREADS : (block + 1) * THREADS], np.int64)
    base = (block * THREADS // S) * Lw
    return base + int(sw.min()), base + int(sw.max()) + K - 1


class Fifo:
    """A walker's words (widx <= K - 1), as the kernel reads them: in place,
    words.flat[clip(wbase + widx, 0, last)]; or from the block's window
    [lo, hi] staged from sb (lo, rounded down to 4 words when lo >= 0, the
    body array being 16-byte aligned), which holds words.flat[clip(i, 0,
    last)] at i - sb, at stage[wbase - sb + widx] with no clamp."""

    def __init__(self, flat, wbase: int, K: int, lo: int, hi: int, staged: bool):
        self.flat, self.wbase, self.K, self.staged = flat, wbase, K, staged
        if staged:
            sb = lo & ~3 if lo >= 0 else lo
            idx = np.clip(np.arange(sb, hi + 1), 0, len(flat) - 1)
            self.stage, self.at = flat[idx], wbase - sb

    def fetch(self, widx: int) -> int:
        assert 0 <= widx < self.K
        if self.staged:
            assert 0 <= self.at + widx < len(self.stage)
            return int(self.stage[self.at + widx])
        return int(self.flat[min(max(self.wbase + widx, 0), len(self.flat) - 1)])


class Window:
    """The bit window: bits past bitcnt are zero (the kernel's two 64-bit
    registers; a literal/length code's peek never passes bit 63)."""

    def __init__(self):
        self.bits, self.cnt = 0, 0

    def peek(self, s: int) -> int:
        return (self.bits >> s) & _M32

    def consume(self, n: int):
        self.bits >>= n
        self.cnt -= n



class Counts:
    """The lookups a model run made, on the direct path and in all."""

    def __init__(self):
        self.direct = self.total = 0

    def look(self, alphabet: Alphabet, p: int):
        e, ln, direct = alphabet.lookup(p)
        self.direct += direct
        self.total += 1
        return e, ln


def _low(x: int, n: int) -> int:
    return x & ((1 << n) - 1)


class TwoPlane:
    """K4's policy: up to three literals and the match after them, or four
    literals; rows (tapeA, tapeB)."""

    start_refills, row_refills, refill_at, planes, ll_bits = 4, 3, 92, 2, 13

    @staticmethod
    def decode(ll, dd, win: Window, remaining: int, n: Counts):
        es, ls, off = [], [], 0
        for _ in range(4):
            e, ln = n.look(ll, win.peek(off))
            es.append(e)
            ls.append(ln)
            off += ln
        cnt = 0
        while cnt < 4 and es[cnt] >> 28 == KIND_LIT and remaining >= cnt + 1:
            cnt += 1
        litreg = sum((es[i] & 0xFF) << (8 * i) for i in range(cnt))
        lbits = sum(ls[:cnt])
        ce, cl, coff = es[min(cnt, 3)], ls[min(cnt, 3)], sum(ls[: min(cnt, 3)])
        is_len = ce >> 28 == KIND_MATCH
        want_m = is_len and cnt < 4 and remaining > cnt
        x1 = (ce >> 20) & 0xF
        length = (ce & 0xFFFFF) + _low(win.peek(coff + cl), x1)
        s_d = coff + cl + x1
        ed, ld = n.look(dd, win.peek(s_d))
        dx = (ed >> 20) & 0xF
        dist = (ed & 0xFFFFF) + _low(win.peek(s_d + ld), dx)
        is_match = want_m and ed >> 28 == KIND_MATCH
        cover = cnt + (length if is_match else 0)
        bad = (cnt == 0 and not is_len) or (want_m and ed >> 28 != KIND_MATCH) or cover > remaining
        b = cnt | ((8 | ((length - 3) << 4) | (dist << 12)) if is_match else 0)
        nbits = lbits + (cl + x1 + ld + dx if is_match else 0)
        return bad, (litreg & _M32, b & _M32), nbits, cover


class OnePlane:
    """K11a's policy: up to three literals, or one match; one tape word."""

    start_refills, row_refills, refill_at, planes, ll_bits = 3, 2, 64, 1, 12

    @staticmethod
    def decode(ll, dd, win: Window, remaining: int, n: Counts):
        e1, l1 = n.look(ll, win.peek(0))
        kind1 = e1 >> 28
        x1 = (e1 >> 20) & 0xF
        s_d = l1 + x1
        ed, ld = n.look(dd, win.peek(s_d))
        e2, l2 = n.look(ll, win.peek(l1))
        e3, l3 = n.look(ll, win.peek(l1 + l2))
        length = (e1 & 0xFFFFF) + _low(win.peek(l1), x1)
        dx = (ed >> 20) & 0xF
        dist = (ed & 0xFFFFF) + _low(win.peek(s_d + ld), dx)
        lit = kind1 == KIND_LIT
        take2 = lit and e2 >> 28 == KIND_LIT and remaining >= 2
        take3 = take2 and e3 >> 28 == KIND_LIT and remaining >= 3
        match = kind1 == KIND_MATCH and ed >> 28 == KIND_MATCH
        cnt = 1 + take2 + take3
        litreg = (e1 & 0xFF) | ((e2 & 0xFF) << 8 if take2 else 0) | ((e3 & 0xFF) << 16 if take3 else 0)
        cover = cnt if lit else length
        bad = not (lit or match) or cover > remaining
        if lit:
            tok = (VK.VTOK_LIT << 30) | ((cnt - 1) << 24) | litreg
            nbits = l1 + (l2 if take2 else 0) + (l3 if take3 else 0)
        else:
            tok = (VK.VTOK_MATCH << 30) | ((length - 3) << 16) | dist
            nbits = s_d + ld + dx
        return bad, (tok & _M32,), nbits, cover


def model(policy, words, start_word, align, span, tables, *, S: int, K: int, cap: int,
          stage_words=None):
    """The kernel's outputs on numpy operands (words int32 [B, Lw], walker
    arrays [W], tables [B, 576]): (tapes uint32 [cap, W] a plane, cons,
    bad, rem int32 [W], staged bool a block, Counts). `stage_words` is the
    budget a block's window must fit (the C entry's stage_budget)."""
    words = np.asarray(words)
    B, Lw = words.shape
    W = len(start_word)
    assert S % THREADS == 0 and W == B * S
    flat = words.reshape(-1).view(np.uint32)
    budget = stage_budget(Lw, K) if stage_words is None else stage_words
    # every word starts as UNSET: the walk's stores and the zero rows must
    # cover each exactly as the kernel's do
    tapes = [np.full((cap, W), UNSET, np.uint32) for _ in range(policy.planes)]
    cons, bad, rem = (np.zeros(W, np.int32) for _ in range(3))
    staged = np.zeros(W // THREADS, bool)
    counts = Counts()
    alphabets = {}
    for blk in range(W // THREADS):
        chunk = blk * THREADS // S
        if chunk not in alphabets:
            alphabets[chunk] = tables_of(tables[chunk], policy.ll_bits)
        ll, dd = alphabets[chunk]
        lo, hi = block_window(start_word, blk, S, Lw, K)
        staged[blk] = hi - lo + 1 <= budget
        ends = []
        for w in range(blk * THREADS, (blk + 1) * THREADS):
            fifo = Fifo(flat, chunk * Lw + int(start_word[w]), K, lo, hi, bool(staged[blk]))
            c, b, r, it = _walk(policy, fifo, ll, dd, int(align[w]), int(span[w]), cap, tapes, w,
                                counts)
            cons[w], bad[w], rem[w] = c, b, r
            ends.append(it)
        for w0 in range(0, THREADS, 32):
            _zero_tail(tapes, blk * THREADS + w0, ends[w0 : w0 + 32], cap)
    return tapes, cons, bad, rem, staged, counts


UNSET = 0xA5A5A5A5


def _store(tapes, row: int, col: int, values):
    for plane, v in zip(tapes, values):
        plane[row, col] = v


def _zero_tail(tapes, col0: int, ends, cap: int):
    """A warp's zero rows after its walk: each lane's rows from its own end
    to the warp's last, one store a row, then the warp's 16-byte stores of
    its 32 columns to cap. Each row is stored once."""
    warp_end = max(ends)
    for lane, it in enumerate(ends):
        for row in range(it, warp_end):
            assert all(p[row, col0 + lane] == UNSET for p in tapes), "a row stored twice"
            _store(tapes, row, col0 + lane, (0, 0))
    for row in range(warp_end, cap):
        assert all((p[row, col0 : col0 + 32] == UNSET).all() for p in tapes)
        for p in tapes:
            p[row, col0 : col0 + 32] = 0


def _refill(win: Window, widx: int, n: int, refill_at: int, fifo: Fifo) -> int:
    """Up to n refills, each where bitcnt <= refill_at: the refills taken
    are a prefix, so word i goes at bit bitcnt + 32 i. Returns widx."""
    kmax = fifo.K - 1
    b0, taken = win.cnt, 0
    for i in range(n):
        word = fifo.fetch(min(widx + i, kmax))
        if b0 + 32 * i <= refill_at:
            win.bits |= word << (b0 + 32 * i)
            taken += 1
    win.cnt = b0 + 32 * taken
    return min(widx + taken, kmax)


def _walk(policy, fifo: Fifo, ll, dd, align: int, sp: int, cap: int, tapes, w: int, n: Counts):
    win = Window()
    widx = 0
    remaining = sp if sp > 0 else 0
    cons, bad = 0, False
    if sp > 0:
        widx = _refill(win, widx, policy.start_refills, policy.refill_at, fifo)
        win.consume(align & 31)
    it = 0
    while it < cap and remaining > 0 and not bad:
        widx = _refill(win, widx, policy.row_refills, policy.refill_at, fifo)
        bad_now, row, nbits, cover = policy.decode(ll, dd, win, remaining, n)
        if bad_now:
            bad = True
            _store(tapes, it, w, (0, 0))  # the row that ends the walker
        else:
            _store(tapes, it, w, row)
            win.consume(nbits)
            cons += nbits
            remaining -= cover
        it += 1
    return cons, int(bad), remaining, it


CASES = ["clean", "flipped", "shifted", "cap16", "damaged"]


def decode_case(stream, case):
    """The chunks and staged numpy operands of one decode case of a stream
    fixture (data, bodies, sizes, seeds): the stream clean, with a flipped
    body byte, with one walker a bit off its symbol, with cap 16 (the
    caller's), or with a damaged index (walker 5 of the second chunk
    starting Lw + K words before its own start, so that its block's window
    passes the staged budget). Returns (bodies, sizes, seeds, operands,
    meta)."""
    _data, bodies, sizes, seeds = stream
    if case == "flipped":
        bad = bytearray(bodies[0])
        bad[len(bad) // 2] ^= 0xFF
        bodies = [bytes(bad)] + bodies[1:]
    elif case == "shifted":
        bits, outs = seeds[0]
        seeds = [([bits[0], bits[1] + 1] + list(bits[2:]), outs)] + list(seeds[1:])
    dev, meta = TV.prepare_vector_inputs(bodies, sizes, seeds, device="cpu")
    ops = {n: dev[n].numpy().copy() for n in ("words", "start_word", "align", "span", "tables")}
    if case == "damaged":
        ops["start_word"][meta["S"] + 5] -= ops["words"].shape[1] + meta["K"]
    return bodies, sizes, seeds, ops, meta


def jax_decode_on(jax_fn, bodies, sizes, seeds, ops, meta, cap):
    """A JAX decode kernel (`decode_tokens_vector2` or `decode_tokens_vector`)
    in interpret mode on these operands: its own tables, align and span,
    and the FIFO the reference's `_stage_fifo` gathers from the port's
    words and start_word, so that a damaged index reaches it as it reaches
    the port. Returns (tapes uint32 [cap, W] a plane, [cons, bad, rem])."""
    jdev, jmeta = JV.prepare_vector_inputs(bodies, sizes, seeds)
    B, Lw = ops["words"].shape
    W, G = B * meta["S"], jmeta["G"]
    sw = np.zeros(G * 1024, np.int32)
    sw[:W] = ops["start_word"]
    cw = np.zeros(G * 1024, np.int32)
    cw[:W] = np.arange(W) // meta["S"]
    fifo = JV._stage_fifo(jnp.asarray(ops["words"].reshape(-1)), jnp.asarray(sw),
                          jnp.asarray(cw), Lw, K=meta["K"], G=G)
    outs = jax_fn(fifo, *jdev["tables"], jdev["align"], jdev["span"], cap=cap, K=meta["K"],
                  interpret=True)
    tapes = [np.asarray(t).transpose(1, 0, 2, 3).reshape(cap, -1)[:, :W].view(np.uint32)
             for t in outs[:-3]]
    return tapes, [np.asarray(x).reshape(-1)[:W] for x in outs[-3:]]


def assert_equal_runs(model_out, plain, jax_out):
    """The model's tapes, cons, bad and rem equal the plain version's
    (torch) and the JAX kernel's, word for word."""
    tapes, cons, bad, rem = model_out[:4]
    jtapes, jrest = jax_out
    for got, p, j in zip(tapes + [cons, bad, rem], plain, jtapes + jrest):
        np.testing.assert_array_equal(got.view(np.int32), p.numpy())
        np.testing.assert_array_equal(got.view(np.int32), np.asarray(j).view(np.int32))
