"""The vector decode engine's kernels, with their plain versions and the
host tables: K4 (two-plane Huffman decode) and K5 (two-plane expansion),
the default, and K11a (single-plane decode) and K11b (single-plane
expansion), selected by ZRS_VECTOR_TWOPLANE=0.

The port of zlib_rs_tpu/ops/pallas/vhuff_kernel.py:

  decode_tokens_vector2   one walker per encoder seed decodes its span of
                          the chunk body into paired tape rows (K4,
                          csrc/vhuff_decode.cu; replaces
                          `decode_tokens_vector2`, body `_make_kernel2`)
  expand_tokens2          the rows of each chunk's walkers, in order,
                          become the chunk's bytes (K5, csrc/vhuff_expand.cu;
                          replaces `expand_tokens_pallas2`, body
                          `_make_expand_kernel2`)
  decode_tokens_vector    the same walkers into single-plane rows (K11a,
                          K4's body with a single-plane row policy, the
                          `zrs_vhuff_decode1` entry of csrc/vhuff_decode.cu;
                          replaces `decode_tokens_vector`, body
                          `_make_kernel`)
  expand_tokens           single-plane rows to bytes (K11b, K5's body
                          through a single-plane tape reader, the
                          `zrs_vhuff_expand1` entry of csrc/vhuff_expand.cu;
                          replaces `expand_tokens_pallas`, body
                          `_make_expand_kernel`)

A two-plane row holds up to three literals and the match that follows
them, or four literals, or a lone match: tapeA the literal bytes LSB first,
tapeB `cnt | has << 3 | (len - 3) << 4 | dist << 12`; an all-zero row ends
a walker's tape. A single-plane row holds up to three literals or one
match: `VTOK_LIT << 30 | (cnt - 1) << 24 | bytes` or
`VTOK_MATCH << 30 | (len - 3) << 16 | dist`, and 0 ends the walker. Tapes
are row-major int32 [cap, W] (walker w's row t at t * W + w), so the decode
kernels' stores coalesce across walkers.

Walker w belongs to chunk w // S. Its input word widx is
words.flat[clip(chunk * Lw + start_word[w] + min(widx, K - 1), 0, B * Lw - 1)]:
the reference's staged FIFO, read in place. The flat index may run into
the next chunk's row, as the reference's does, so `cons`, `bad` and `rem`
agree even on corrupt input. The decode kernels stage each block's window
of those words in shared memory when it fits (`decode_blocks` counts the
blocks on each branch) and look codes up through direct tables beside the
cascade; both give the in-place cascade's results on any input.

Tables: one int32 row of TABLE_WORDS per chunk, the six cascade tables of
`build_cascade_tables_np` end to end (offsets below).

Each wrapper runs the plain version for a CPU tensor and launches the
kernel for a CUDA tensor; nothing falls back. 32-bit words cross the
kernel boundary as int32 bit-views.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ... import _device
from ...parallel.device_inflate import (
    KIND_EOB,
    KIND_INVALID,
    KIND_LIT,
    KIND_MATCH,
    _DBASE,
    _DEXTRA,
    _LBASE,
    _LEXTRA,
)

# launches of the CUDA kernels; the plain versions do not count
launches = {"vhuff_decode": 0, "vhuff_expand": 0, "vhuff_decode1": 0, "vhuff_expand1": 0}

WALKERS_PER_BLOCK = 128  # K4's and K11a's block; S must be a multiple of it

# single-plane token kinds (bits 31:30 of a tape word)
VTOK_LIT = 1  # (cnt - 1) << 24 | up to 3 literal bytes, LSB first
VTOK_MATCH = 2  # (len - 3) << 16 | dist

# offsets of the six tables in a chunk's table row
LL_LIM, LL_PACK, LL_WORK = 0, 16, 32
D_LIM, D_PACK, D_WORK = 416, 432, 448
TABLE_WORDS = 576

_M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# host-side table construction (numpy; O(320) per chunk)
# ---------------------------------------------------------------------------


def _work_entry(kind, extra, payload):
    return (int(kind) << 28) | (int(extra) << 20) | int(payload)


_INVALID_ENTRY = _work_entry(KIND_INVALID, 0, 0)


def _cascade_np(lens: np.ndarray, entries: np.ndarray, work_size: int):
    """Canonical cascade tables for one alphabet.

    lens: int[n] code lengths (0 = absent); entries: uint32[n] packed
    (kind, extra, payload) per symbol. Returns (lim15[16], pack[16],
    work[work_size]) as int64 numpy (values fit int32).
    """
    n = len(lens)
    counts = np.bincount(lens, minlength=16)[:16]
    counts[0] = 0
    first = np.zeros(16, np.int64)
    code = 0
    for l in range(2, 16):
        code = (code + counts[l - 1]) << 1
        first[l] = code
    lim15 = np.zeros(16, np.int64)
    base15 = np.zeros(16, np.int64)
    off = np.zeros(16, np.int64)
    acc = 0
    for l in range(1, 16):
        base15[l] = first[l] << (15 - l)
        lim15[l] = (first[l] + counts[l]) << (15 - l)
        off[l] = acc
        acc += counts[l]
    pack = (off << 16) | base15
    work = np.full(work_size, _INVALID_ENTRY, np.int64)
    nxt = off.copy()
    for sym in range(n):
        l = lens[sym]
        if l > 0:
            work[nxt[l]] = entries[sym]
            nxt[l] += 1
    return lim15, pack, work


_LL_ENTRIES = np.zeros(320, np.int64)
for _s in range(320):
    if _s < 256:
        _LL_ENTRIES[_s] = _work_entry(KIND_LIT, 0, _s)
    elif _s == 256:
        _LL_ENTRIES[_s] = _work_entry(KIND_EOB, 0, 0)
    elif _s < 286:
        _LL_ENTRIES[_s] = _work_entry(KIND_MATCH, _LEXTRA[_s - 257], _LBASE[_s - 257])
    else:
        _LL_ENTRIES[_s] = _INVALID_ENTRY

_D_ENTRIES = np.zeros(320, np.int64)
for _s in range(320):
    if _s < 30:
        _D_ENTRIES[_s] = _work_entry(KIND_MATCH, _DEXTRA[_s], _DBASE[_s])
    else:
        _D_ENTRIES[_s] = _INVALID_ENTRY


def build_cascade_tables_np(ll_lens: np.ndarray, d_lens: np.ndarray):
    """Per-chunk decode tables for the vector kernel.

    Returns (ll_lim15[16], ll_pack[16], ll_work[384], d_lim15[16],
    d_pack[16], d_work[128]) int32 numpy arrays.
    """
    ll_lim, ll_pack, ll_work = _cascade_np(
        np.asarray(ll_lens[:288], np.int64), _LL_ENTRIES[:288], 384
    )
    d_lim, d_pack, d_work = _cascade_np(
        np.asarray(d_lens[:30], np.int64), _D_ENTRIES[:30], 128
    )
    return (
        ll_lim.astype(np.int32), ll_pack.astype(np.int32),
        ll_work.astype(np.int32), d_lim.astype(np.int32),
        d_pack.astype(np.int32), d_work.astype(np.int32),
    )


def table_row(ll_lens: np.ndarray, d_lens: np.ndarray) -> np.ndarray:
    """One chunk's int32 [TABLE_WORDS] table row."""
    return np.concatenate(build_cascade_tables_np(ll_lens, d_lens))


# ---------------------------------------------------------------------------
# K4: the two-plane decode
# ---------------------------------------------------------------------------


def _i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values taken mod 2^32 as int32 values (two's complement)."""
    return ((x + (1 << 31)) & _M32) - (1 << 31)


def _rev15(x: torch.Tensor) -> torch.Tensor:
    """MSB-first value of a 15-bit LSB-first peek (butterfly reversal)."""
    x = ((x >> 1) & 0x5555) | ((x & 0x5555) << 1)
    x = ((x >> 2) & 0x3333) | ((x & 0x3333) << 2)
    x = ((x >> 4) & 0x0F0F) | ((x & 0x0F0F) << 4)
    x = ((x >> 8) & 0x00FF) | ((x & 0x00FF) << 8)
    return x >> 1


def _check_decode_args(words, start_word, align, span, tables, S: int, K: int, cap: int):
    if any(t.dtype != torch.int32 for t in (words, start_word, align, span, tables)):
        raise ValueError("vhuff_decode: operands must be int32")
    if words.dim() != 2 or start_word.dim() != 1:
        raise ValueError("vhuff_decode: words must be [B, Lw] and start_word [W]")
    B, Lw = words.shape
    W = start_word.shape[0]
    if S <= 0 or S % WALKERS_PER_BLOCK or W != B * S:
        raise ValueError(f"vhuff_decode: need S % 128 == 0 and W == B * S (S={S}, W={W})")
    if align.shape != (W,) or span.shape != (W,) or tables.shape != (B, TABLE_WORDS):
        raise ValueError("vhuff_decode: align/span must be [W], tables [B, 576]")
    if K < 1 or cap < 1:
        raise ValueError("vhuff_decode: K and cap must be positive")
    return B, Lw, W


class _Walkers:
    """What both plain decodes share: every walker's bit window, kept as
    four 32-bit registers in int64 (bits 0..127), its refill from the body
    words, peeks, consumes and cascade lookups, vectorised over walkers.
    `refill_at` is the largest bitcnt that still takes a word: 92 for the
    two-plane decode (K4), 64 for the single-plane one (K11a)."""

    def __init__(self, words, start_word, tables, *, S: int, K: int, refill_at: int):
        B, Lw = words.shape
        W = start_word.shape[0]
        dev = words.device
        i64 = torch.int64
        self.W, self.dev, self.K, self.refill_at = W, dev, K, refill_at
        self.flat = words.reshape(-1).to(i64) & _M32
        self.last = B * Lw - 1
        self.tabs = tables.reshape(-1).to(i64)
        chunk = torch.arange(W, device=dev, dtype=i64) // S
        self.wbase = chunk * Lw + start_word.to(i64)
        self.tbase = chunk * TABLE_WORDS
        cols = torch.arange(1, 15, device=dev, dtype=i64)[None, :]
        self.ll_lim = self.tabs[self.tbase[:, None] + LL_LIM + cols]  # [W, 14]: lim15[1..14]
        self.d_lim = self.tabs[self.tbase[:, None] + D_LIM + cols]
        self.reg4 = torch.arange(4, device=dev, dtype=i64)[None, :]
        self.zero = torch.zeros(W, dtype=i64, device=dev)

    def refill(self, win, bitcnt, widx, active):
        """Insert one word at bit `bitcnt` where bitcnt <= refill_at."""
        need = active & (bitcnt <= self.refill_at)
        word = self.flat[(self.wbase + widx.clamp(max=self.K - 1)).clamp(0, self.last)]
        q = (bitcnt >> 5)[:, None]
        r = (bitcnt & 31)[:, None]
        w2 = word[:, None]
        ins = torch.where(self.reg4 == q, (w2 << r) & _M32, 0) | torch.where(
            self.reg4 == q + 1, w2 >> (32 - r), 0
        )
        win = torch.where(need[:, None], win | ins, win)
        bitcnt = torch.where(need, bitcnt + 32, bitcnt)
        widx = torch.where(need, torch.clamp(widx + 1, max=self.K - 1), widx)
        return win, bitcnt, widx

    def peek(self, win, s):
        """32-bit view of the window starting at bit s (0 <= s <= 95)."""
        ext = torch.cat([win, torch.zeros((self.W, 1), dtype=torch.int64, device=self.dev)], dim=1)
        q = (s >> 5)[:, None]
        r = s & 31
        a = ext.gather(1, q)[:, 0]
        b = ext.gather(1, q + 1)[:, 0]
        return ((a >> r) | (b << (32 - r))) & _M32

    def consume(self, win, n):
        """Drop n bits (0 <= n <= 95): an exact 128-bit right shift."""
        ext = torch.cat([win, torch.zeros((self.W, 3), dtype=torch.int64, device=self.dev)], dim=1)
        idx = self.reg4 + (n >> 5)[:, None]
        r = (n & 31)[:, None]
        a = ext.gather(1, idx)
        b = ext.gather(1, idx + 1)
        return ((a >> r) | (b << (32 - r))) & _M32

    def _lookup(self, win, s, lim, pack_at, work_at, work_max):
        v15 = _rev15(self.peek(win, s) & 0x7FFF)
        ln = 1 + (v15[:, None] >= lim).sum(dim=1)
        pk = self.tabs[self.tbase + pack_at + ln]
        delta = ((v15 - (pk & 0xFFFF)) & _M32) >> (15 - ln)
        idx = _i32((pk >> 16) + delta).clamp(0, work_max)
        return self.tabs[self.tbase + work_at + idx], ln

    def litlen_at(self, win, s):
        """(work entry, code length) of the literal/length code at bit s."""
        return self._lookup(win, s, self.ll_lim, LL_PACK, LL_WORK, 383)

    def dist_at(self, win, s):
        """(work entry, code length) of the distance code at bit s."""
        return self._lookup(win, s, self.d_lim, D_PACK, D_WORK, 127)

    def start(self, align, span, refills: int):
        """`refills` refills, then each live walker's seed alignment
        consumed. Returns (win, bitcnt, widx, remaining)."""
        span64 = span.to(torch.int64)
        live0 = span64 > 0
        win = torch.zeros((self.W, 4), dtype=torch.int64, device=self.dev)
        bitcnt, widx = self.zero.clone(), self.zero.clone()
        for _ in range(refills):
            win, bitcnt, widx = self.refill(win, bitcnt, widx, live0)
        n0 = torch.where(live0, align.to(torch.int64) & 31, 0)  # a seed's bit within its word
        return self.consume(win, n0), bitcnt - n0, widx, torch.where(live0, span64, 0)


def decode_tokens_vector2_plain(words, start_word, align, span, tables, *, S: int,
                                K: int, cap: int):
    """The decode vectorised over walkers in torch, one Python step per
    tape row, stopping once no walker is live. The 128-bit bit window is
    four 32-bit registers kept in int64. Same outputs as the kernel:
    tapeA, tapeB int32 [cap, W]; cons, bad, rem int32 [W]."""
    W = _check_decode_args(words, start_word, align, span, tables, S, K, cap)[2]
    wk = _Walkers(words, start_word, tables, S=S, K=K, refill_at=92)
    i64 = torch.int64
    zero = wk.zero
    win, bitcnt, widx, remaining = wk.start(align, span, 4)
    cons = zero.clone()
    bad = torch.zeros(W, dtype=torch.bool, device=wk.dev)

    tapeA = torch.zeros((cap, W), dtype=torch.int32, device=wk.dev)
    tapeB = torch.zeros((cap, W), dtype=torch.int32, device=wk.dev)

    def sel4(c, a, b, cc, d):
        return torch.where(c == 0, a, torch.where(c == 1, b, torch.where(c == 2, cc, d)))

    for it in range(cap):
        active = (remaining > 0) & ~bad
        if not bool(active.any()):
            break
        for _ in range(3):
            win, bitcnt, widx = wk.refill(win, bitcnt, widx, active)

        e1, l1 = wk.litlen_at(win, zero)
        lit1 = (e1 >> 28) == KIND_LIT
        e2, l2 = wk.litlen_at(win, l1)
        lit2 = lit1 & ((e2 >> 28) == KIND_LIT) & (remaining >= 2)
        e3, l3 = wk.litlen_at(win, l1 + l2)
        lit3 = lit2 & ((e3 >> 28) == KIND_LIT) & (remaining >= 3)
        e4, l4 = wk.litlen_at(win, l1 + l2 + l3)
        lit4 = lit3 & ((e4 >> 28) == KIND_LIT) & (remaining >= 4)
        cnt = lit1.to(i64) + lit2.to(i64) + lit3.to(i64) + lit4.to(i64)
        litreg = (
            torch.where(lit1, e1 & 0xFF, 0)
            | torch.where(lit2, (e2 & 0xFF) << 8, 0)
            | torch.where(lit3, (e3 & 0xFF) << 16, 0)
            | torch.where(lit4, (e4 & 0xFF) << 24, 0)
        )
        lbits = (
            torch.where(lit1, l1, 0) + torch.where(lit2, l2, 0)
            + torch.where(lit3, l3, 0) + torch.where(lit4, l4, 0)
        )

        # the match candidate: the first code after the literals taken
        cand_e = sel4(cnt, e1, e2, e3, e4)
        cand_l = sel4(cnt, l1, l2, l3, l4)
        cand_off = sel4(cnt, zero, l1, l1 + l2, l1 + l2 + l3)
        is_len = (cand_e >> 28) == KIND_MATCH
        want_m = is_len & (cnt < 4) & (remaining > cnt)
        x1 = (cand_e >> 20) & 0xF
        length = (cand_e & 0xFFFFF) + (wk.peek(win, cand_off + cand_l) & ((1 << x1) - 1))
        s_d = cand_off + cand_l + x1
        ed, ld = wk.dist_at(win, s_d)
        dkind = ed >> 28
        dx = (ed >> 20) & 0xF
        dist = (ed & 0xFFFFF) + (wk.peek(win, s_d + ld) & ((1 << dx) - 1))
        is_match = want_m & (dkind == KIND_MATCH)

        bad_now = active & (((cnt == 0) & ~is_len) | (want_m & (dkind != KIND_MATCH)))
        cover = cnt + torch.where(is_match, length, 0)
        bad_now = bad_now | (active & (cover > remaining))
        step = active & ~bad_now
        emit = step & (cover > 0)
        tokB = torch.where(
            emit,
            cnt | torch.where(is_match, 8 | ((length - 3) << 4) | (dist << 12), 0),
            0,
        )
        tapeA[it] = _i32(torch.where(emit, litreg, 0)).to(torch.int32)
        tapeB[it] = _i32(tokB).to(torch.int32)

        n = torch.where(step, lbits + torch.where(is_match, cand_l + x1 + ld + dx, 0), 0)
        win = wk.consume(win, n)
        bitcnt = bitcnt - n
        cons = cons + n
        remaining = remaining - torch.where(step, cover, 0)
        bad = bad | bad_now

    i32 = torch.int32
    return tapeA, tapeB, cons.to(i32), bad.to(i32), remaining.to(i32)


def _decode_lib():
    fn = _device.library("vhuff_decode").zrs_vhuff_decode
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, I, I, P, P, P, P, I, I, I, I, P, P, P, P, P, P]
        fn.restype = ctypes.c_int
    return fn


def decode_blocks() -> tuple[int, int]:
    """The blocks of K4 and K11a launches that took the staged and the
    global branch since the last call, as the kernels counted them; the
    counts restart at 0. Synchronous."""
    fn = _device.library("vhuff_decode").zrs_vhuff_decode_blocks
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
    out = (ctypes.c_ulonglong * 2)()
    _device.check(fn(ctypes.cast(out, ctypes.c_void_p)), "vhuff_decode_blocks")
    return int(out[0]), int(out[1])


def decode_tokens_vector2_cuda(words, start_word, align, span, tables, *, S: int,
                               K: int, cap: int):
    """Launch K4 over CUDA operands: words int32 [B, Lw], start_word,
    align and span int32 [W = B * S], tables int32 [B, 576]."""
    _device.require_cuda("vhuff_decode", words, start_word, align, span, tables)
    B, Lw, W = _check_decode_args(words, start_word, align, span, tables, S, K, cap)
    args = [t.contiguous() for t in (words, start_word, align, span, tables)]
    dev = words.device
    tapeA = torch.empty((cap, W), dtype=torch.int32, device=dev)
    tapeB = torch.empty((cap, W), dtype=torch.int32, device=dev)
    cons, bad, rem = (torch.empty(W, dtype=torch.int32, device=dev) for _ in range(3))
    rc = _decode_lib()(
        _device.ptr(args[0]), B, Lw, *(_device.ptr(t) for t in args[1:]),
        S, K, cap, W, _device.ptr(tapeA), _device.ptr(tapeB), _device.ptr(cons),
        _device.ptr(bad), _device.ptr(rem), _device.stream_of(words),
    )
    _device.check(rc, "vhuff_decode")
    launches["vhuff_decode"] += 1
    return tapeA, tapeB, cons, bad, rem


def decode_tokens_vector2(words, start_word, align, span, tables, *, S: int, K: int,
                          cap: int):
    """The plain version for a CPU tensor, the kernel for a CUDA one.
    Returns (tapeA, tapeB, cons, bad, rem)."""
    if words.device.type == "cpu":
        return decode_tokens_vector2_plain(
            words, start_word, align, span, tables, S=S, K=K, cap=cap
        )
    return decode_tokens_vector2_cuda(
        words, start_word, align, span, tables, S=S, K=K, cap=cap
    )


# ---------------------------------------------------------------------------
# K11a: the single-plane decode
# ---------------------------------------------------------------------------


def decode_tokens_vector_plain(words, start_word, align, span, tables, *, S: int,
                               K: int, cap: int):
    """The single-plane decode vectorised over walkers in torch, one Python
    step per tape row, stopping once no walker is live: three refills and
    the seed alignment, then two refills a step (a word wherever bitcnt
    <= 64, so the 96-bit window holds at least 65 bits), up to three
    literals or one match a row. Same outputs as the kernel: tape int32
    [cap, W]; cons, bad, rem int32 [W]."""
    W = _check_decode_args(words, start_word, align, span, tables, S, K, cap)[2]
    wk = _Walkers(words, start_word, tables, S=S, K=K, refill_at=64)
    zero = wk.zero
    win, bitcnt, widx, remaining = wk.start(align, span, 3)
    cons = zero.clone()
    bad = torch.zeros(W, dtype=torch.bool, device=wk.dev)
    tape = torch.zeros((cap, W), dtype=torch.int32, device=wk.dev)

    for it in range(cap):
        active = (remaining > 0) & ~bad
        if not bool(active.any()):
            break
        for _ in range(2):
            win, bitcnt, widx = wk.refill(win, bitcnt, widx, active)

        e1, l1 = wk.litlen_at(win, zero)
        kind1 = e1 >> 28
        is_lit1 = kind1 == KIND_LIT
        is_len1 = kind1 == KIND_MATCH
        # the match: length extra, distance code and distance extra
        x1 = (e1 >> 20) & 0xF
        length = (e1 & 0xFFFFF) + (wk.peek(win, l1) & ((1 << x1) - 1))
        s_d = l1 + x1
        ed, ld = wk.dist_at(win, s_d)
        dx = (ed >> 20) & 0xF
        dist = (ed & 0xFFFFF) + (wk.peek(win, s_d + ld) & ((1 << dx) - 1))
        is_match = is_len1 & ((ed >> 28) == KIND_MATCH)
        # the literals: up to two more while the span allows
        e2, l2 = wk.litlen_at(win, l1)
        take2 = is_lit1 & ((e2 >> 28) == KIND_LIT) & (remaining >= 2)
        e3, l3 = wk.litlen_at(win, l1 + l2)
        take3 = take2 & ((e3 >> 28) == KIND_LIT) & (remaining >= 3)
        cnt = 1 + take2.long() + take3.long()
        litreg = (
            (e1 & 0xFF)
            | torch.where(take2, (e2 & 0xFF) << 8, 0)
            | torch.where(take3, (e3 & 0xFF) << 16, 0)
        )

        bad_now = active & ((kind1 == KIND_INVALID) | (kind1 == KIND_EOB)
                            | (is_len1 & ~is_match))
        cover = torch.where(is_lit1, cnt, torch.where(is_match, length, 0))
        bad_now = bad_now | (active & (cover > remaining))
        step = active & ~bad_now
        tok = torch.where(
            step & is_lit1, (VTOK_LIT << 30) | ((cnt - 1) << 24) | litreg,
            torch.where(step & is_match, (VTOK_MATCH << 30) | ((length - 3) << 16) | dist, 0),
        )
        tape[it] = _i32(tok).to(torch.int32)

        n_lit = l1 + torch.where(take2, l2, 0) + torch.where(take3, l3, 0)
        n = torch.where(step, torch.where(is_lit1, n_lit, torch.where(is_match, s_d + ld + dx, 0)), 0)
        win = wk.consume(win, n)
        bitcnt = bitcnt - n
        cons = cons + n
        remaining = remaining - torch.where(step, cover, 0)
        bad = bad | bad_now

    i32 = torch.int32
    return tape, cons.to(i32), bad.to(i32), remaining.to(i32)


def _decode1_lib():
    fn = _device.library("vhuff_decode").zrs_vhuff_decode1
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, I, I, P, P, P, P, I, I, I, I, P, P, P, P, P]
        fn.restype = ctypes.c_int
    return fn


def decode_tokens_vector_cuda(words, start_word, align, span, tables, *, S: int,
                              K: int, cap: int):
    """Launch K11a over CUDA operands: words int32 [B, Lw], start_word,
    align and span int32 [W = B * S], tables int32 [B, 576]."""
    _device.require_cuda("vhuff_decode1", words, start_word, align, span, tables)
    B, Lw, W = _check_decode_args(words, start_word, align, span, tables, S, K, cap)
    args = [t.contiguous() for t in (words, start_word, align, span, tables)]
    dev = words.device
    tape = torch.empty((cap, W), dtype=torch.int32, device=dev)
    cons, bad, rem = (torch.empty(W, dtype=torch.int32, device=dev) for _ in range(3))
    rc = _decode1_lib()(
        _device.ptr(args[0]), B, Lw, *(_device.ptr(t) for t in args[1:]),
        S, K, cap, W, _device.ptr(tape), _device.ptr(cons), _device.ptr(bad),
        _device.ptr(rem), _device.stream_of(words),
    )
    _device.check(rc, "vhuff_decode1")
    launches["vhuff_decode1"] += 1
    return tape, cons, bad, rem


def decode_tokens_vector(words, start_word, align, span, tables, *, S: int, K: int,
                         cap: int):
    """The plain version for a CPU tensor, the kernel for a CUDA one.
    Returns (tape, cons, bad, rem)."""
    if words.device.type == "cpu":
        return decode_tokens_vector_plain(
            words, start_word, align, span, tables, S=S, K=K, cap=cap
        )
    return decode_tokens_vector_cuda(
        words, start_word, align, span, tables, S=S, K=K, cap=cap
    )


# ---------------------------------------------------------------------------
# K5: the two-plane expansion
# ---------------------------------------------------------------------------

# K5's (and K11b's) body for a chunk: the per-walker resolve and
# pointer-jumping chase, or the serial body for walkers that do not tile
# their ranges or for a chunk of more output bytes than the chase's 15-bit
# pointers reach (CHASE_MAX_BYTES) or a row past CHASE_MAX_ROW bytes
BRANCH_CHASE, BRANCH_UNTILED, BRANCH_TOO_LARGE = 0, 1, 2
CHASE_MAX_BYTES = 32768
CHASE_MAX_ROW = 65536


def _check_branch(kernel: str, branch, B: int, device) -> None:
    if branch is not None and (branch.dtype != torch.int32 or branch.shape != (B,)
                               or branch.device != device or not branch.is_contiguous()):
        raise ValueError(f"{kernel}: branch must be a contiguous int32 [B] on the tapes' device")


def _check_expand_args(tapeA, tapeB, offs, out_words: int):
    if any(t.dtype != torch.int32 for t in (tapeA, tapeB, offs)):
        raise ValueError("vhuff_expand: operands must be int32")
    if tapeA.dim() != 2 or tapeA.shape != tapeB.shape:
        raise ValueError("vhuff_expand: tapes must be equal [cap, W]")
    cap, W = tapeA.shape
    B = offs.shape[0]
    if offs.dim() != 2 or B == 0 or W != B * (offs.shape[1] - 1):
        raise ValueError("vhuff_expand: offs must be [B, S + 1] with W == B * S")
    if out_words < 1:
        raise ValueError("vhuff_expand: out_words must be positive")
    return cap, W, B, offs.shape[1] - 1


def _expand_chunk(colsA, colsB, offs_k, cap: int, out_words: int) -> list:
    """One chunk's LE32 words: the walkers in order, each row a literal
    funnel store of up to 4 bytes, then the match copy if the row has one.
    Reads are clamped to [0, out_words) and stores outside it dropped, the
    same rules as the kernel."""
    o = [0] * out_words
    top = out_words - 1

    def rd(i):
        return o[0 if i < 0 else top if i > top else i]

    def wr(i, v):
        if 0 <= i <= top:
            o[i] = v

    for s in range(len(colsA)):
        ta, tb = colsA[s], colsB[s]
        p, p1 = offs_k[s], offs_k[s + 1]
        t = 0
        while t < cap and p < p1:
            tok_a, tok_b = ta[t], tb[t]
            cnt = tok_b & 7
            # literal funnel: up to 4 bytes, keeping the bytes below p
            wi = p >> 2
            sh = (p & 3) << 3
            full = (rd(wi) & ((1 << sh) - 1)) | ((tok_a << sh) & _M32)
            spill = tok_a >> (32 - sh) if sh else 0
            p2 = p + cnt
            wr(wi, full)
            if (p2 >> 2) > wi:
                wr(p2 >> 2, spill)
            length = ((tok_b >> 4) & 0xFF) + 3 if tok_b & 8 else 0
            if length:
                dist = (tok_b >> 12) & 0xFFFF
                d4 = dist if dist >= 4 else (6 if dist == 3 else 4)
                base = 0 if dist >= 4 else d4 - dist
                for i in range(base):  # byte head of a dist < 4 match
                    q = p2 + i
                    src = max(q - dist, 0)
                    b = (rd(src >> 2) >> ((src & 3) << 3)) & 0xFF
                    qs = (q & 3) << 3
                    wr(q >> 2, (rd(q >> 2) & ~(0xFF << qs) & _M32) | (b << qs))
                pw = p2 + base
                wi = pw >> 2
                sh = (pw & 3) << 3
                sp = pw - d4
                ssh = (sp & 3) << 3
                w0 = rd(sp >> 2)
                src4 = ((w0 >> ssh) | (rd((sp >> 2) + 1) << (32 - ssh))) & _M32 if ssh else w0
                wr(wi, (rd(wi) & ((1 << sh) - 1)) | ((src4 << sh) & _M32))
                nw = ((p2 + length - 1) >> 2) - wi
                sp0 = ((wi + 1) << 2) - d4
                swi0 = sp0 >> 2
                sh_s = (sp0 & 3) << 3
                rep4 = swi0 == wi
                w0 = rd(swi0)
                for k in range(nw):  # word copies; d4 == 4 repeats the stored word
                    w1 = rd(swi0 + k + 1)
                    val = ((w0 >> sh_s) | (w1 << (32 - sh_s))) & _M32 if sh_s else w0
                    wr(wi + 1 + k, val)
                    w0 = val if rep4 else w1
            t = t + 1 if tok_b else cap
            p = p2 + length
    return o


def expand_tokens2_plain(tapeA, tapeB, offs, *, out_words: int):
    """The expansion as the serial host loop it is: tapes to numpy once,
    then one Python step per row. Returns int32 [B, out_words] LE32 words
    on the tapes' device; only bytes [0, out_len) of a chunk are defined."""
    cap, W, B, S = _check_expand_args(tapeA, tapeB, offs, out_words)
    a_np = tapeA.cpu().numpy().view(np.uint32)
    b_np = tapeB.cpu().numpy().view(np.uint32)
    offs_np = offs.cpu().numpy().astype(np.int64)
    out = np.zeros((B, out_words), np.uint32)
    for k in range(B):
        cols = slice(k * S, (k + 1) * S)
        out[k] = _expand_chunk(
            a_np[:, cols].T.tolist(), b_np[:, cols].T.tolist(),
            offs_np[k].tolist(), cap, out_words,
        )
    return torch.from_numpy(out.view(np.int32)).to(tapeA.device)


def _expand_lib():
    fn = _device.library("vhuff_expand").zrs_vhuff_expand
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, I, I, I, I, P, P, P]
        fn.restype = ctypes.c_int
    return fn


def expand_tokens2_cuda(tapeA, tapeB, offs, *, out_words: int, branch=None):
    """Launch K5 over CUDA operands: tapes int32 [cap, W], offs int32
    [B, S + 1] (walker s of chunk k covers [offs[k, s], offs[k, s + 1])).
    `branch`, an int32 [B] tensor on the tapes' device if given, receives
    each chunk's body: BRANCH_CHASE, BRANCH_UNTILED or BRANCH_TOO_LARGE."""
    _device.require_cuda("vhuff_expand", tapeA, tapeB, offs)
    cap, W, B, S = _check_expand_args(tapeA, tapeB, offs, out_words)
    _check_branch("vhuff_expand", branch, B, tapeA.device)
    tapeA, tapeB, offs = (t.contiguous() for t in (tapeA, tapeB, offs))
    out = torch.empty((B, out_words), dtype=torch.int32, device=tapeA.device)
    rc = _expand_lib()(
        _device.ptr(tapeA), _device.ptr(tapeB), _device.ptr(offs), cap, W, S,
        out_words, _device.ptr(out), None if branch is None else _device.ptr(branch),
        _device.stream_of(tapeA),
    )
    _device.check(rc, "vhuff_expand")
    launches["vhuff_expand"] += 1
    return out


def expand_tokens2(tapeA, tapeB, offs, *, out_words: int):
    """The plain version for a CPU tensor, the kernel for a CUDA one."""
    if tapeA.device.type == "cpu":
        return expand_tokens2_plain(tapeA, tapeB, offs, out_words=out_words)
    return expand_tokens2_cuda(tapeA, tapeB, offs, out_words=out_words)


# ---------------------------------------------------------------------------
# K11b: the single-plane expansion
# ---------------------------------------------------------------------------


def _check_expand1_args(tape, offs, out_words: int):
    if tape.dtype != torch.int32 or offs.dtype != torch.int32:
        raise ValueError("vhuff_expand1: operands must be int32")
    if tape.dim() != 2:
        raise ValueError("vhuff_expand1: the tape must be [cap, W]")
    cap, W = tape.shape
    B = offs.shape[0]
    if offs.dim() != 2 or B == 0 or W != B * (offs.shape[1] - 1):
        raise ValueError("vhuff_expand1: offs must be [B, S + 1] with W == B * S")
    if out_words < 1:
        raise ValueError("vhuff_expand1: out_words must be positive")
    return cap, W, B, offs.shape[1] - 1


def _expand_chunk1(cols, offs_k, cap: int, out_words: int) -> list:
    """One chunk's LE32 words from single-plane tapes: the walkers in
    order, each a literal sprint through a word register, then one match
    copy (a cover-0 copy where the sprint met a token that is no match,
    which ends the walker). Reads are clamped to [0, out_words) and stores
    outside it dropped, the same rules as the kernel."""
    o = [0] * out_words
    top = out_words - 1

    def rd(i):
        return o[0 if i < 0 else top if i > top else i]

    def wr(i, v):
        if 0 <= i <= top:
            o[i] = v

    def src4(sp):
        sh = (sp & 3) << 3
        w0 = rd(sp >> 2)
        return ((w0 >> sh) | (rd((sp >> 2) + 1) << (32 - sh))) & _M32 if sh else w0

    def copy_match(p, length, dist):
        d4 = dist if dist >= 4 else (6 if dist == 3 else 4)
        base = 0 if dist >= 4 else d4 - dist
        for i in range(base):  # byte head of a dist < 4 match
            q = p + i
            src = max(q - dist, 0)
            b = (rd(src >> 2) >> ((src & 3) << 3)) & 0xFF
            qs = (q & 3) << 3
            wr(q >> 2, (rd(q >> 2) & ~(0xFF << qs) & _M32) | (b << qs))
        pw = p + base
        wi = pw >> 2
        sh = (pw & 3) << 3
        keep = rd(wi) & ((1 << sh) - 1)
        wr(wi, keep | ((src4(pw - d4) << sh) & _M32))
        for k in range(((p + length - 1) >> 2) - wi):  # whole words from d4 back
            wr(wi + 1 + k, src4(((wi + 1 + k) << 2) - d4))

    for s, col in enumerate(cols):
        p, p1 = offs_k[s], offs_k[s + 1]
        t = 0
        while t < cap and p < p1:
            reg = rd(p >> 2) & ((1 << ((p & 3) << 3)) - 1)
            tok = col[t]
            while tok >> 30 == VTOK_LIT:  # the literal sprint
                w = tok & 0xFFFFFF
                sh = (p & 3) << 3
                full = (reg | (w << sh)) & _M32
                p2 = p + ((tok >> 24) & 3) + 1
                wr(p >> 2, full)
                reg = (w >> (32 - sh) if sh else 0) if (p2 >> 2) > (p >> 2) else full
                p = p2
                t += 1
                tok = col[t] if t < cap else 0
            wr(p >> 2, reg)  # flush the partial word
            cover = ((tok >> 16) & 0x3FFF) + 3 if tok >> 30 == VTOK_MATCH else 0
            copy_match(p, cover, tok & 0xFFFF)
            p += cover
            t = t + 1 if cover else cap
    return o


def expand_tokens_plain(tape, offs, *, out_words: int):
    """The single-plane expansion as the serial host loop it is: the tape to
    numpy once, then one Python step per token. Returns int32 [B,
    out_words] LE32 words on the tape's device; only bytes [0, out_len) of
    a chunk are defined."""
    cap, W, B, S = _check_expand1_args(tape, offs, out_words)
    t_np = tape.cpu().numpy().view(np.uint32)
    offs_np = offs.cpu().numpy().astype(np.int64)
    out = np.zeros((B, out_words), np.uint32)
    for k in range(B):
        out[k] = _expand_chunk1(
            t_np[:, k * S : (k + 1) * S].T.tolist(), offs_np[k].tolist(), cap, out_words
        )
    return torch.from_numpy(out.view(np.int32)).to(tape.device)


def _expand1_lib():
    # K11b is the second C entry of K5's library: one body, two tape readers
    fn = _device.library("vhuff_expand").zrs_vhuff_expand1
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, I, I, I, I, P, P, P]
        fn.restype = ctypes.c_int
    return fn


def expand_tokens_cuda(tape, offs, *, out_words: int, branch=None):
    """Launch K11b over CUDA operands: tape int32 [cap, W], offs int32
    [B, S + 1] (walker s of chunk k covers [offs[k, s], offs[k, s + 1])).
    `branch`, an int32 [B] tensor on the tape's device if given, receives
    each chunk's body: BRANCH_CHASE, BRANCH_UNTILED or BRANCH_TOO_LARGE."""
    _device.require_cuda("vhuff_expand1", tape, offs)
    cap, W, B, S = _check_expand1_args(tape, offs, out_words)
    _check_branch("vhuff_expand1", branch, B, tape.device)
    tape, offs = tape.contiguous(), offs.contiguous()
    out = torch.empty((B, out_words), dtype=torch.int32, device=tape.device)
    rc = _expand1_lib()(
        _device.ptr(tape), _device.ptr(offs), cap, W, S, out_words, _device.ptr(out),
        None if branch is None else _device.ptr(branch), _device.stream_of(tape),
    )
    _device.check(rc, "vhuff_expand1")
    launches["vhuff_expand1"] += 1
    return out


def expand_tokens(tape, offs, *, out_words: int):
    """The plain version for a CPU tensor, the kernel for a CUDA one."""
    if tape.device.type == "cpu":
        return expand_tokens_plain(tape, offs, out_words=out_words)
    return expand_tokens_cuda(tape, offs, out_words=out_words)
