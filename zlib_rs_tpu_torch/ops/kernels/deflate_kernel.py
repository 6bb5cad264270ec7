"""The matchers (K2 hop chase, K12 interleaved hop chase, K8 chain scan,
K10 table walk), the symbol histogram (K9) and the bit pack (K3) of the
kernel encode engine, with their plain PyTorch versions and the torch
stages around them.

The port of zlib_rs_tpu/ops/pallas/deflate_kernel.py's three routes:

  scan_chunks_hop    lzvec hop tables (torch) -> K2 chase (K12 under
                     ZRS_TPU_HOP_IL=2) -> _hop_post
  scan_chunks_tab    lzvec match tables (torch) -> K10 table walk
  scan_chunks        K8 hash-chain scan (levels 8-9, ZRS_TPU_TABSCAN=0)
  freq_pack_chunks   [K9 histogram, when the scan gave none] -> EOB bump +
                     both trees (torch) -> K3 pack -> lengths from the
                     tables the kernel echoes

The encode pipeline runs exactly these compositions, each stage bracketed
by `utils.stages.STAGES`.

K2 (`zrs_hop_chase`) replaces `scan_chunks_hop_pallas` (body
`_make_kernel_hop`) and K12 (`zrs_hop_chase_il`) its K=2 branch (body
`_make_kernel_hop_il`), both from one templated body in
csrc/hop_chase_il.cu that differs only in the overflow recount; K8 (csrc/chain_scan.cu) `scan_chunks_pallas` (body
`_kernel`); K10 (csrc/tab_scan.cu) `scan_chunks_tab_pallas` (body
`_make_kernel_tab`); K9 (csrc/freq.cu) the freq branch of
`freq_pack_chunks_pallas` (body `_freq_kernel`); K3 (csrc/pack.cu)
`freq_pack_chunks_pallas` (body `_pack_kernel`). One block takes one
chunk. K3 is serial per chunk and latency-bound on the H100; K8 walks a
chain 32 candidates a warp step; K2, K12 and K10 resolve every position of
a tile of the span in parallel into shared memory and chase it a segment
a thread. Their byte floors are the
operands read once and the outputs written once. The sources carry the
design notes.

Each wrapper (`hop_chase`, `hop_chase_il`, `chain_scan`, `tab_scan`,
`freq`, `pack`) runs the plain version for a CPU tensor and launches the
kernel for a CUDA tensor; nothing falls back. 32-bit words cross the kernel boundary as
int32 bit-views.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch
import torch.nn.functional as F

from ... import _device
from ...utils.stages import STAGES
from .. import dynhuff, lzvec
from ..lz77 import dist_symbol_arith as _dist_sym
from ..lz77 import length_symbol_arith as _len_sym

MIN_MATCH = 3
MAX_MATCH = 258
MAX_DIST = 32768
HSIZE = 1 << 15  # zlib's hash_bits = 15: 32K chain heads
TOO_FAR = 4096  # a length-3 match further back than this is no match
CAP_M = 12288  # match-stream slots per chunk; overflow flags `bad`
MAX_BUF = 65024  # dict + data ceiling of the kernel engine (u16 positions)
PAD = 272  # tail padding so word reads past n_valid stay in bounds
N_BINS = 320  # ll symbols at 0..285, dist codes at 288..317

# zlib's configuration table (good, max_lazy, nice, chain) per level
ZLIB_CONFIG = {
    1: (4, 4, 8, 4),
    2: (4, 5, 16, 8),
    3: (4, 6, 32, 32),
    4: (4, 4, 16, 16),
    5: (8, 16, 32, 32),
    6: (8, 16, 128, 128),
    7: (8, 32, 128, 256),
    8: (32, 128, 258, 1024),
    9: (32, 258, 258, 4096),
}

# K2, K12 and K10 keep the resolved slots of a tile of the span in dynamic
# shared memory, one int32 a position: TILE holds a 32 KiB chunk's span in
# one tile; a longer span takes more (MIN_TILE..MAX_TILE, 4 bytes a slot)
TILE = 33792
MIN_TILE = 1024
MAX_TILE = 49152
RESOLVE_THREADS = 512  # threads of a K2, K12 or K10 block

# launches of the CUDA kernels; the plain versions do not count
launches = {"hop_chase": 0, "hop_chase_il": 0, "chain_scan": 0, "tab_scan": 0, "freq": 0,
            "pack": 0}


def words_from_bytes(chunks_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [B, L] (L % 4 == 0) -> int32 [B, L/4 + 2] little-endian word
    bit-views with two zero words of tail padding."""
    B, L = chunks_u8.shape
    if L % 4:
        raise ValueError("chunk buffer length must be a multiple of 4")
    w = chunks_u8.contiguous().view(torch.int32)
    return F.pad(w, (0, 2))


# ---------------------------------------------------------------------------
# K2: the hop chase
# ---------------------------------------------------------------------------


def _get32(w: list, p: int) -> int:
    """The LE32 word at byte p of a row of words (Python ints)."""
    wi = p >> 2
    sh = (p & 3) << 3
    if sh == 0:
        return w[wi]
    return ((w[wi] >> sh) | (w[wi + 1] << (32 - sh))) & 0xFFFFFFFF


def _tail(x: int) -> int:
    """Equal low bytes of a nonzero xor (0-3)."""
    t0 = (x & 0xFF) == 0
    t1 = t0 and (x & 0xFFFF) == 0
    t2 = t1 and (x & 0xFFFFFF) == 0
    return int(t0) + int(t1) + int(t2)


def _count_span(w: list, hist: list, frm: int, to: int) -> None:
    """The literals [frm, to), word-wise into four banks: bank k takes byte
    k of each 4-byte read; a byte past `to` lands in bin 319 of its bank."""
    for p in range(frm, to, 4):
        x = _get32(w, p)
        rem = to - p
        hist[x & 0xFF] += 1
        hist[N_BINS + ((x >> 8) & 0xFF if rem >= 2 else 319)] += 1
        hist[2 * N_BINS + ((x >> 16) & 0xFF if rem >= 3 else 319)] += 1
        hist[3 * N_BINS + (x >> 24 if rem >= 4 else 319)] += 1


def _chase_row(w, ht, n_valid, start, cap_g, mpos_r, mld_r, hist=None):
    """K2's parse of one chunk: fills mpos_r/mld_r and returns (nmatch,
    bad); with `hist`, counts the literal spans as it goes, as K2 does."""
    i0, mc, bad = start, 0, False
    while i0 < n_valid and not bad:
        e = ht[i0]
        i = i0
        if (e >> 30) <= 0:
            i = min(i0 + e, n_valid)
            e = ht[min(i, n_valid - 1)]
        if i >= n_valid:
            if hist is not None:
                _count_span(w, hist, i0, n_valid)
            break
        h = (e >> 23) & 0x7F
        mlen = (e >> 16) & 0x7F
        dist = e & 0xFFFF
        ip = i + h
        if hist is not None:
            _count_span(w, hist, i0, ip)
        cap = min(n_valid - ip, MAX_MATCH)
        if mlen == cap_g:
            k = mlen
            while k < cap and _get32(w, ip + k) == _get32(w, max(ip - dist + k, 0)):
                k += 4
            mlen = min(k, cap)
        xt = _get32(w, ip + mlen) ^ _get32(w, max(ip - dist + mlen, 0))
        mlen = min(mlen + _tail(xt), cap)
        slot = mc if mc < CAP_M else CAP_M
        mpos_r[slot] = ip
        mld_r[slot] = ((mlen - MIN_MATCH) << 15) | (dist - 1)
        bad = mc >= CAP_M
        mc += 1
        i0 = ip + mlen
    return mc, bad


def _chase_plain(words, htab, n_valid, row_fn):
    """Run `row_fn(w, ht, n_valid, mpos_r, mld_r, hist) -> (nmatch, bad)`
    over the rows; returns the four int32 arrays of K2 and K12."""
    B, W = words.shape
    C = CAP_M + 8
    w_np = words.cpu().numpy().view(np.uint32)
    h_np = htab.cpu().numpy()
    nv_np = n_valid.cpu().numpy()
    mpos = np.zeros((B, C), np.int64)
    mld = np.zeros((B, C), np.int64)
    st = np.zeros((B, 8), np.int64)
    freq = np.zeros((B, 4 * N_BINS), np.int64)
    for r in range(B):
        hist = [0] * (4 * N_BINS)
        st[r, :2] = row_fn(w_np[r].tolist(), h_np[r].tolist(), int(nv_np[r]), mpos[r], mld[r], hist)
        freq[r] = hist
    as_t = lambda a: torch.from_numpy(a.astype(np.uint32).view(np.int32)).to(words.device)
    return as_t(mpos), as_t(mld), as_t(st), as_t(freq)


def hop_chase_plain(words, htab, n_valid, start: int, cap_g: int):
    """The chase, one chunk at a time, as the scalar loop it is: each
    step's position depends on the previous match. Same outputs as the
    kernel: mpos/mld int32 [B, CAP_M + 8] (slots past nmatch are 0), st
    int32 [B, 8] (nmatch, bad), freq int32 [B, 4 * 320] (four banks)."""

    def row(w, ht, nv, mpos_r, mld_r, hist):
        mc, bad = _chase_row(w, ht, nv, start, cap_g, mpos_r, mld_r, hist)
        if bad:  # an all-literal recount; bank 0 only is cleared, as in K2
            hist[:N_BINS] = [0] * N_BINS
            _count_span(w, hist, start, nv)
        return mc, int(bad)

    return _chase_plain(words, htab, n_valid, row)


def _hop_entry(kernel: str):
    """The C entry `zrs_<kernel>` of K2 or K12, typed: both live in the
    hop_chase_il library and take the same arguments: K2's match-end
    scratch after freq (null for K12), the tile before the stream."""
    fn = getattr(_device.library("hop_chase_il"), f"zrs_{kernel}")
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P, I, P, L, P, I, I, P, P, I, P, P, P, I, I, P]
        fn.restype = ctypes.c_int
    return fn


def _check_tile(kernel: str, tile: int) -> int:
    if not MIN_TILE <= int(tile) <= MAX_TILE:
        raise ValueError(f"{kernel}: tile {tile} outside [{MIN_TILE}, {MAX_TILE}]")
    return int(tile)


def _launch_hop(kernel, words, htab, n_valid, start, cap_g, tile):
    """K2's or K12's launch (`kernel` names it) over CUDA operands: words
    int32 [B, W], htab int32 [B, 4W] (row-contiguous), n_valid int [B];
    `tile` resolved slots at a time."""
    _device.require_cuda(kernel, words, htab, n_valid)
    tile = _check_tile(kernel, tile)
    B, W = words.shape
    if words.dtype != torch.int32 or htab.dtype != torch.int32:
        raise ValueError(f"{kernel}: words and htab must be int32")
    if htab.shape[0] != B or htab.shape[1] < 4 * (W - 2) or htab.stride(1) != 1:
        raise ValueError(f"{kernel}: htab must be [B, >= 4(W-2)] with contiguous rows")
    words = words.contiguous()
    n_valid = n_valid.to(torch.int32).contiguous()
    if B and int(n_valid.max()) > 4 * (W - 2):
        raise ValueError(f"{kernel}: n_valid exceeds the word buffer")
    C = CAP_M + 8
    mpos = torch.empty((B, C), dtype=torch.int32, device=words.device)
    mld = torch.empty((B, C), dtype=torch.int32, device=words.device)
    st = torch.empty((B, 8), dtype=torch.int32, device=words.device)
    freq = torch.empty((B, 4 * N_BINS), dtype=torch.int32, device=words.device)
    # K2's spans start at each match's true end, which mld cannot hold
    # for a dist past 2^15; K12 reads it back from mld as its reference does
    ends = torch.empty((B, C), dtype=torch.int32, device=words.device) if kernel == "hop_chase" else None
    rc = _hop_entry(kernel)(
        _device.ptr(words), W, _device.ptr(htab), htab.stride(0),
        _device.ptr(n_valid), int(start), int(cap_g), _device.ptr(mpos),
        _device.ptr(mld), C, _device.ptr(st), _device.ptr(freq),
        None if ends is None else _device.ptr(ends), B, tile,
        _device.stream_of(words),
    )
    _device.check(rc, kernel)
    launches[kernel] += 1
    return mpos, mld, st, freq


def hop_chase_cuda(words, htab, n_valid, start: int, cap_g: int, *, tile: int = TILE):
    """Launch K2 over CUDA operands (see `_launch_hop`): K12's body with
    K2's overflow recount, one block of RESOLVE_THREADS a chunk, `tile`
    resolved slots (4 * tile bytes of dynamic shared memory) at a time."""
    return _launch_hop("hop_chase", words, htab, n_valid, start, cap_g, tile)


def hop_chase(words, htab, n_valid, start: int, cap_g: int):
    """The plain version for a CPU tensor, the kernel for a CUDA one."""
    if words.device.type == "cpu":
        return hop_chase_plain(words, htab, n_valid, start, cap_g)
    return hop_chase_cuda(words, htab, n_valid, start, cap_g)


# ---------------------------------------------------------------------------
# K12: the interleaved hop chase
# ---------------------------------------------------------------------------


def hop_chase_il_plain(words, htab, n_valid, start: int, cap_g: int):
    """K12's two phases, one chunk at a time, as serial loops: K2's chase
    without the histogram, then the literal spans replayed from the match
    stream into the four banks (the kernel resolves the chase's slots and
    counts the spans in parallel, which changes no result). A bad
    (overflowing) chunk's whole span is counted once as literals; K2 clears
    bank 0 only before its recount. Same outputs as the kernel: mpos/mld
    int32 [B, CAP_M + 8] (slots past nmatch are 0), st int32 [B, 8]
    (nmatch, bad), freq int32 [B, 4 * 320]."""

    def row(w, ht, nv, mpos_r, mld_r, hist):
        mc, bad = _chase_row(w, ht, nv, start, cap_g, mpos_r, mld_r)
        p = start
        for j in range(0 if bad else mc):
            _count_span(w, hist, p, int(mpos_r[j]))
            p = int(mpos_r[j]) + (int(mld_r[j]) >> 15) + MIN_MATCH
        _count_span(w, hist, p, nv)
        return mc, int(bad)

    return _chase_plain(words, htab, n_valid, row)


def overflow_lanes():
    """A crafted K2/K12 input on which the two differ: two lanes of random
    bytes whose htab holds a literal with delta 5 at every p % 8 == 0 and a
    3-byte distance-1 match everywhere else. Lane 0 (8 * CAP_M + 800 bytes)
    emits more than CAP_M matches and goes bad, lane 1 (4,000 bytes) does
    not. Returns (words, htab, n_valid), int32 CPU tensors; start is 0."""
    n = 8 * CAP_M + 800
    buf = np.zeros((2, n + PAD), np.uint8)
    buf[:, :n] = np.random.default_rng(3).integers(0, 256, size=n)
    words = words_from_bytes(torch.from_numpy(buf))
    htab = torch.full((2, 4 * words.shape[1]), (1 << 30) | (3 << 16) | 1, dtype=torch.int32)
    htab[:, 0::8] = 5
    return words, htab, torch.tensor([n, 4000], dtype=torch.int32)


def hop_chase_il_cuda(words, htab, n_valid, start: int, cap_g: int, *, tile: int = TILE):
    """Launch K12 over CUDA operands, as K2 (see `_launch_hop`): one block
    of RESOLVE_THREADS a chunk, `tile` resolved slots (4 * tile bytes of
    dynamic shared memory) at a time."""
    return _launch_hop("hop_chase_il", words, htab, n_valid, start, cap_g, tile)


def hop_chase_il(words, htab, n_valid, start: int, cap_g: int):
    """The plain version for a CPU tensor, the kernel for a CUDA one."""
    if words.device.type == "cpu":
        return hop_chase_il_plain(words, htab, n_valid, start, cap_g)
    return hop_chase_il_cuda(words, htab, n_valid, start, cap_g)


def _hop_post(mpos, mld, st, freq):
    """Sum the four literal banks and add the len/dist code histogram of
    the match stream (bad chunks contribute no matches: their parse
    degrades to all literals downstream)."""
    B, C = mpos.shape
    fq = freq.view(B, 4, N_BINS).sum(dim=1, dtype=torch.int32)
    nmatch = st[:, 0]
    kbad = st[:, 1] > 0
    x = mld.to(torch.int64) & 0xFFFFFFFF
    slot = torch.arange(C, device=mpos.device)[None, :]
    validm = slot < torch.where(kbad, 0, nmatch)[:, None]
    lc, _, _ = _len_sym(torch.where(validm, (x >> 15) + MIN_MATCH, MIN_MATCH))
    dc, _, _ = _dist_sym(torch.where(validm, (x & 0x7FFF) + 1, 1))
    ones = validm.to(torch.int32)
    lhist = torch.zeros((B, 29), dtype=torch.int32, device=mpos.device)
    dhist = torch.zeros((B, 30), dtype=torch.int32, device=mpos.device)
    lhist.scatter_add_(1, lc, ones)
    dhist.scatter_add_(1, dc, ones)
    fq[:, 257:286] += lhist
    fq[:, 288:318] += dhist
    return mpos, mld, nmatch, kbad, fq


def scan_chunks_hop(
    words4, n_valid, ins_from, *, start: int, depth: int, nice: int,
    good: int = 8, max_lazy: int = 16, w_g: int = 8, bytes_arr=None,
    precise: bool = False,
):
    """Hop tables -> K2 chase (K12 under ZRS_TPU_HOP_IL=2) -> symbol
    histogram. Returns (mpos, mld, nmatch, kbad, freq [B, 320]); needs
    max_lazy - MIN_MATCH < 128."""
    dev = words4.device
    with STAGES.stage("hop_tables", dev):
        htab = lzvec.build_hop_tables(
            words4, n_valid, ins_from, depth=depth, nice=nice, good=good,
            max_lazy=max_lazy, w_g=w_g, bytes_arr=bytes_arr, precise=precise,
        )
    # read on every call: ZRS_TPU_HOP_IL=2 runs K12 in place of K2, on any batch
    if os.environ.get("ZRS_TPU_HOP_IL") == "2":
        with STAGES.stage("hop_chase_il", dev):
            mpos, mld, st, freq = hop_chase_il(words4, htab, n_valid, start, 4 * w_g)
    else:
        with STAGES.stage("hop_chase", dev):
            mpos, mld, st, freq = hop_chase(words4, htab, n_valid, start, 4 * w_g)
    with STAGES.stage("post_trees", dev):
        return _hop_post(mpos, mld, st, freq)


# ---------------------------------------------------------------------------
# K8: the hash-chain scan
# ---------------------------------------------------------------------------


def _as_int32(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.uint32).view(np.int32)).to(dev)


def _chain_scan_row(row, n_valid, start, ins_from, depth, nice, good, max_lazy, mpos_r, mld_r):
    """One chunk of `chain_scan_plain`: fills mpos_r/mld_r, returns
    (nmatch, bad, candidates visited)."""
    buf = row.tobytes()
    b = np.concatenate([row.astype(np.int64), np.zeros(2, np.int64)])
    hsh = (((b[:-2] << 10) ^ (b[1:-1] << 5) ^ b[2:]) & (HSIZE - 1)).tolist()
    head = [-1] * HSIZE
    prev = [-1] * len(buf)
    for j in range(ins_from, start):
        h = hsh[j]
        prev[j] = head[h]
        head[h] = j
    i, plen, pdist, avail, mc, bad, visits = start, 0, 0, False, 0, False, 0
    while i < n_valid and not bad:
        h = hsh[i]
        cand = head[h]
        prev[i] = cand
        head[h] = i
        blen = bdist = 0
        if (not avail or plen < max_lazy) and cand >= 0:
            # longest_match: a candidate whose byte at the current best
            # length differs cannot beat it (the anchored-byte skip); every
            # candidate visited costs one unit of the budget
            bl0 = plen if avail else 0
            cap = min(n_valid - i, MAX_MATCH)
            nice_eff = min(nice, cap)
            budget = depth >> 2 if bl0 >= good else depth
            bl, bd, d = bl0, 0, 0
            while cand >= 0 and i - cand <= MAX_DIST and d < budget and bl < nice_eff:
                if buf[cand + bl] == buf[i + bl]:
                    k = 0
                    while k + 8 <= cap and buf[i + k : i + k + 8] == buf[cand + k : cand + k + 8]:
                        k += 8
                    while k < cap and buf[i + k] == buf[cand + k]:
                        k += 1
                    if k > bl:
                        bl, bd = k, i - cand
                cand = prev[cand]
                d += 1
            visits += d
            if bl > bl0 and bl >= MIN_MATCH and not (bl == MIN_MATCH and bd > TOO_FAR):
                blen, bdist = bl, bd
        if avail and blen == 0 and plen >= MIN_MATCH:
            # one-step lazy: the match pending at i - 1 stands
            slot = min(mc, CAP_M)
            mpos_r[slot] = i - 1
            mld_r[slot] = ((plen - MIN_MATCH) << 15) | (pdist - 1)
            bad = mc >= CAP_M
            mc += 1
            for j in range(i + 1, min(i - 1 + plen, n_valid)):
                h = hsh[j]
                prev[j] = head[h]
                head[h] = j
            i, plen, pdist, avail = i - 1 + plen, 0, 0, False
        else:
            avail = blen >= MIN_MATCH
            plen, pdist = (blen, bdist) if avail else (0, 0)
            i += 1
    if avail and plen >= MIN_MATCH and i - 1 + plen <= n_valid:
        slot = min(mc, CAP_M)
        mpos_r[slot] = i - 1
        mld_r[slot] = ((plen - MIN_MATCH) << 15) | (pdist - 1)
        bad = bad or mc >= CAP_M
        mc += 1
    return mc, bad, visits


def chain_scan_plain(words, n_valid, start, ins_from, *, depth, nice, good, max_lazy):
    """zlib's hash-chain longest_match under deflate_slow's one-step-lazy
    parse, one chunk at a time, as the scalar loop it is. Same outputs as
    the kernel: mpos/mld int32 [B, CAP_M + 8] (slots past nmatch are 0),
    st int32 [B, 8] = (nmatch, bad, chain candidates visited, 0, ...)."""
    B, W = words.shape
    C = CAP_M + 8
    rows = words.cpu().contiguous().numpy().view(np.uint8).reshape(B, 4 * W)
    nv, stt, ins = (x.cpu().tolist() for x in (n_valid, start, ins_from))
    mpos = np.zeros((B, C), np.int64)
    mld = np.zeros((B, C), np.int64)
    st = np.zeros((B, 8), np.int64)
    for r in range(B):
        mc, bad, visits = _chain_scan_row(
            rows[r], nv[r], stt[r], ins[r], depth, nice, good, max_lazy, mpos[r], mld[r]
        )
        st[r, :3] = (mc, int(bad), visits)
    dev = words.device
    return _as_int32(mpos, dev), _as_int32(mld, dev), _as_int32(st, dev)


def _chain_lib():
    fn = _device.library("chain_scan").zrs_chain_scan
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, I, P, P, P, I, I, I, I, P, P, P, P, I, P, I, P]
        fn.restype = ctypes.c_int
    return fn


def chain_scan_cuda(words, n_valid, start, ins_from, *, depth, nice, good, max_lazy):
    """Launch K8 over CUDA operands: words int32 [B, W] (>= 2 zero words
    of tail padding, 4 (W - 2) <= MAX_BUF + 8), n_valid / start /
    ins_from int [B]."""
    _device.require_cuda("chain_scan", words, n_valid, start, ins_from)
    B, W = words.shape
    if words.dtype != torch.int32:
        raise ValueError("chain_scan: words must be int32")
    if (W - 2) * 4 > MAX_BUF + 8:
        raise ValueError(f"chain_scan: chunk buffer {(W - 2) * 4} exceeds MAX_BUF={MAX_BUF}")
    words = words.contiguous()
    n_valid, start, ins_from = [t.to(torch.int32).contiguous() for t in (n_valid, start, ins_from)]
    if any(t.shape != (B,) for t in (n_valid, start, ins_from)):
        raise ValueError("chain_scan: n_valid, start and ins_from must be [B]")
    if B and bool(((n_valid > 4 * (W - 2)) | (start > n_valid) | (ins_from < 0)).any()):
        raise ValueError("chain_scan: needs 0 <= ins_from, start <= n_valid <= 4 (W - 2)")
    C = CAP_M + 8
    # scratch: the bucket counters, and each position's packed rank
    counts = torch.empty((B, HSIZE), dtype=torch.int32, device=words.device)
    ranks = torch.empty((B, MAX_BUF + 8), dtype=torch.int32, device=words.device)
    mpos = torch.empty((B, C), dtype=torch.int32, device=words.device)
    mld = torch.empty((B, C), dtype=torch.int32, device=words.device)
    st = torch.empty((B, 8), dtype=torch.int32, device=words.device)
    rc = _chain_lib()(
        _device.ptr(words), W, _device.ptr(n_valid), _device.ptr(start),
        _device.ptr(ins_from), int(depth), int(nice), int(good), int(max_lazy),
        _device.ptr(counts), _device.ptr(ranks), _device.ptr(mpos), _device.ptr(mld), C, _device.ptr(st), B,
        _device.stream_of(words),
    )
    _device.check(rc, "chain_scan")
    launches["chain_scan"] += 1
    return mpos, mld, st


def chain_scan(words, n_valid, start, ins_from, *, depth, nice, good, max_lazy):
    """The plain version for a CPU tensor, the kernel for a CUDA one."""
    kw = dict(depth=depth, nice=nice, good=good, max_lazy=max_lazy)
    if words.device.type == "cpu":
        return chain_scan_plain(words, n_valid, start, ins_from, **kw)
    return chain_scan_cuda(words, n_valid, start, ins_from, **kw)


def scan_chunks(words4, n_valid, start, ins_from, *, depth: int, nice: int,
                good: int = 8, max_lazy: int = 16):
    """Hash-chain scan of B chunks (K8). words4: int32 [B, W] aligned LE
    words (>= 2 zero words of tail padding, dict + data <= MAX_BUF);
    [start, n_valid) is emitted after [ins_from, start) is inserted as
    dictionary. (depth, nice, good, max_lazy) are zlib's (max_chain,
    nice_length, good_length, max_lazy). Returns (mpos int32 [B, CAP_M +
    8], mld int32 [B, CAP_M + 8] = (len - 3) << 15 | (dist - 1), nmatch
    [B], bad bool [B])."""
    B, W = words4.shape
    if (W - 2) * 4 > MAX_BUF + 8:
        raise ValueError(
            f"chunk buffer {(W - 2) * 4} exceeds MAX_BUF={MAX_BUF} "
            "(positions must fit the packed u16 prev chain)"
        )
    dev = words4.device
    start, ins_from = [torch.as_tensor(x, device=dev).to(torch.int32).expand(B)
                       for x in (start, ins_from)]
    with STAGES.stage("chain_scan", dev):
        mpos, mld, st = chain_scan(
            words4, n_valid.to(dev), start, ins_from, depth=depth, nice=nice,
            good=good, max_lazy=max_lazy,
        )
    return mpos, mld, st[:, 0], st[:, 1] > 0


def to_positional(mpos, mld, nmatch, n: int, n_valid, start):
    """A compact match stream as positional arrays over [B, n] positions,
    the `parse=` input of dynhuff.encode_chunk_dynamic: (tokens bool,
    length int32, dist int32), a match's length and distance at its start,
    tokens at every position of [start, n_valid) not inside a match (the
    reference's `_to_positional`)."""
    B, C = mpos.shape
    dev = mpos.device
    valid = torch.arange(C, device=dev) < nmatch.to(dev)[:, None]
    pos = torch.where(valid, mpos.to(torch.int64), n)
    mld = mld.to(torch.int64)
    mlen = torch.where(valid, (mld >> 15) + MIN_MATCH, 0)
    mdist = torch.where(valid, (mld & 0x7FFF) + 1, 0)
    zeros = torch.zeros((B, n + 2), dtype=torch.int64, device=dev)
    length = zeros.scatter(1, pos, mlen)[:, :n]
    dist = zeros.scatter(1, pos, mdist)[:, :n]
    # a match covers (pos, pos + len): +1 after its start, -1 at its end
    delta = zeros.scatter_add(1, torch.where(valid, pos + 1, n + 1).clamp(max=n + 1),
                              valid.to(torch.int64))
    delta = delta.scatter_add(1, torch.where(valid, pos + mlen, n + 1).clamp(max=n + 1),
                              -valid.to(torch.int64))
    interior = torch.cumsum(delta, dim=1)[:, :n] > 0
    idx = torch.arange(n, device=dev)
    stt = torch.as_tensor(start, device=dev).to(torch.int64).reshape(-1, 1)
    tokens = ~interior & (idx >= stt) & (idx < n_valid.to(dev)[:, None])
    return tokens, length.to(torch.int32), dist.to(torch.int32)


# ---------------------------------------------------------------------------
# K10: the table walk
# ---------------------------------------------------------------------------


def _tail(x: int) -> int:
    """Equal leading bytes (0..3) of a nonzero xor word."""
    if x & 0xFF:
        return 0
    if x & 0xFFFF:
        return 1
    return 2 if x & 0xFFFFFF else 3


def _tab_scan_row(w, tf, tq, n_valid, start, nice, good, max_lazy, mpos_r, mld_r):
    """One chunk of `tab_scan_plain`: fills mpos_r/mld_r, returns (nmatch,
    bad)."""
    W = len(w)
    tabn = len(tf)

    def get32(p):
        wi = p >> 2
        sh = (p & 3) << 3
        w0 = w[min(max(wi, 0), W - 1)]
        if sh == 0:
            return w0
        return ((w0 >> sh) | (w[min(max(wi + 1, 0), W - 1)] << (32 - sh))) & 0xFFFFFFFF

    def extend(i, blen, dist):
        # the table's length is a floor: continue word-wise, then the tail
        cap = min(n_valid - i, MAX_MATCH)
        k = blen
        while k < cap and get32(i + k) == get32(i - dist + k):
            k += 4
        k = min(k, cap)
        x = get32(i + k) ^ get32(i - dist + k)
        return min(k + (_tail(x) if x else 0), cap)

    i, plen, pdist, avail, mc, bad = start, 0, 0, False, 0, False
    while i < n_valid and not bad:
        if not avail:
            # literal sprint: a zero full-budget entry is a literal outright
            while i < n_valid and tf[i - start] == 0:
                i += 1
        bl0 = plen if avail else 0
        cap = min(n_valid - i, MAX_MATCH)
        t = (tq if bl0 >= good else tf)[min(max(i - start, 0), tabn - 1)]
        m, d = min(t >> 16, cap), t & 0xFFFF
        blen = bdist = 0
        if ((not avail or plen < max_lazy) and bl0 < min(nice, cap) and m > bl0
                and m >= MIN_MATCH and not (m == MIN_MATCH and d > TOO_FAR)):
            blen, bdist = m, d
        if avail and blen == 0 and plen >= MIN_MATCH:
            p = i - 1
            plen = extend(p, plen, pdist)
            slot = min(mc, CAP_M)
            mpos_r[slot] = p
            mld_r[slot] = ((plen - MIN_MATCH) << 15) | (pdist - 1)
            bad = mc >= CAP_M
            mc += 1
            i, plen, pdist, avail = p + plen, 0, 0, False
        else:
            avail = blen >= MIN_MATCH
            plen, pdist = (blen, bdist) if avail else (0, 0)
            i += 1
    if avail and plen >= MIN_MATCH and i - 1 + plen <= n_valid:
        p = i - 1
        plen = extend(p, plen, pdist)
        slot = min(mc, CAP_M)
        mpos_r[slot] = p
        mld_r[slot] = ((plen - MIN_MATCH) << 15) | (pdist - 1)
        bad = bad or mc >= CAP_M
        mc += 1
    return mc, bad


def tab_scan_plain(words, tabf, tabq, n_valid, start: int, *, nice, good, max_lazy):
    """deflate_slow's one-step-lazy parse over the match tables, one chunk
    at a time: the literal sprint over zero `tabf` entries, `tabq` once
    the pending match is `good`, and every emitted match extended byte-
    exactly from its table length. tabf/tabq: int32 [B, tabn] indexed by
    position - start. Same outputs as the kernel: mpos/mld int32 [B, CAP_M
    + 8] (slots past nmatch are 0), st int32 [B, 8] = (nmatch, bad, 0...)."""
    B, W = words.shape
    C = CAP_M + 8
    w_np = words.cpu().contiguous().numpy().view(np.uint32)
    tf_np = tabf.cpu().numpy()
    tq_np = tabq.cpu().numpy()
    nv = n_valid.cpu().tolist()
    mpos = np.zeros((B, C), np.int64)
    mld = np.zeros((B, C), np.int64)
    st = np.zeros((B, 8), np.int64)
    for r in range(B):
        mc, bad = _tab_scan_row(
            w_np[r].tolist(), tf_np[r].tolist(), tq_np[r].tolist(), nv[r], int(start),
            nice, good, max_lazy, mpos[r], mld[r],
        )
        st[r, :2] = (mc, int(bad))
    dev = words.device
    return _as_int32(mpos, dev), _as_int32(mld, dev), _as_int32(st, dev)


def _tab_lib():
    fn = _device.library("tab_scan").zrs_tab_scan
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P, I, P, P, L, I, P, I, I, I, I, P, P, I, P, I, I, P]
        fn.restype = ctypes.c_int
    return fn


def tab_scan_cuda(words, tabf, tabq, n_valid, start: int, *, nice, good, max_lazy,
                  tile: int = TILE):
    """Launch K10 over CUDA operands: words int32 [B, W], tabf / tabq
    int32 [B, tabn] (rows contiguous, one row stride for both), n_valid
    int [B]; one block of RESOLVE_THREADS a chunk, `tile` resolved slots
    (4 * tile bytes of dynamic shared memory) at a time."""
    _device.require_cuda("tab_scan", words, tabf, tabq, n_valid)
    tile = _check_tile("tab_scan", tile)
    B, W = words.shape
    if words.dtype != torch.int32 or tabf.dtype != torch.int32 or tabq.dtype != torch.int32:
        raise ValueError("tab_scan: words and tables must be int32")
    tabn = tabf.shape[1]
    if (tabf.shape != (B, tabn) or tabq.shape != tabf.shape or tabf.stride() != tabq.stride()
            or tabf.stride(1) != 1):
        raise ValueError("tab_scan: tabf and tabq must be [B, tabn] with one contiguous-row layout")
    words = words.contiguous()
    n_valid = n_valid.to(torch.int32).contiguous()
    if n_valid.shape != (B,) or start < 0:
        raise ValueError("tab_scan: n_valid must be [B] and start >= 0")
    if B and int(n_valid.max()) > min(4 * (W - 2), start + tabn - 1):
        raise ValueError("tab_scan: n_valid exceeds the word buffer or the tables")
    C = CAP_M + 8
    mpos = torch.empty((B, C), dtype=torch.int32, device=words.device)
    mld = torch.empty((B, C), dtype=torch.int32, device=words.device)
    st = torch.empty((B, 8), dtype=torch.int32, device=words.device)
    rc = _tab_lib()(
        _device.ptr(words), W, _device.ptr(tabf), _device.ptr(tabq), tabf.stride(0),
        tabn, _device.ptr(n_valid), int(start), int(nice), int(good), int(max_lazy),
        _device.ptr(mpos), _device.ptr(mld), C, _device.ptr(st), B, tile,
        _device.stream_of(words),
    )
    _device.check(rc, "tab_scan")
    launches["tab_scan"] += 1
    return mpos, mld, st


def tab_scan(words, tabf, tabq, n_valid, start: int, *, nice, good, max_lazy):
    """The plain version for a CPU tensor, the kernel for a CUDA one."""
    kw = dict(nice=nice, good=good, max_lazy=max_lazy)
    if words.device.type == "cpu":
        return tab_scan_plain(words, tabf, tabq, n_valid, start, **kw)
    return tab_scan_cuda(words, tabf, tabq, n_valid, start, **kw)


def scan_chunks_tab(
    words4, n_valid, ins_from, *, start: int, depth: int, nice: int,
    good: int = 8, max_lazy: int = 16, w_g: int = 16, bytes_arr=None,
    precise: bool = False,
):
    """Match tables -> K10 table walk. Same outputs as `scan_chunks`; the
    tables cap lengths at 4 * w_g, the walk extends every emitted match."""
    B, W = words4.shape
    dev = words4.device
    with STAGES.stage("match_tables", dev):
        tabf, tabq = lzvec.build_match_tables(
            words4, n_valid, ins_from, depth=depth, nice=nice, w_g=w_g,
            bytes_arr=bytes_arr, precise=precise,
        )
    with STAGES.stage("tab_scan", dev):
        # the tables from `start` on, as views: row stride 4W
        mpos, mld, st = tab_scan(
            words4, tabf[:, start:], tabq[:, start:], n_valid.to(dev), start,
            nice=nice, good=good, max_lazy=max_lazy,
        )
    return mpos, mld, st[:, 0], st[:, 1] > 0


# ---------------------------------------------------------------------------
# K9: the symbol histogram
# ---------------------------------------------------------------------------


def freq_plain(words, mpos, mld, meta):
    """The 320-bin symbol histogram of a compact match stream as vector
    code: the literals of every gap between matches (gap k is [end of
    match k - 1, mpos[k]), the first from `start`, the last to n_valid)
    at 0..255, 257 + length code and 288 + distance code of each match;
    EOB is not counted. meta int32 [B, 8] = (n_valid, start, nmatch, ...).
    Returns int32 [B, 320]."""
    B, W = words.shape
    C = mpos.shape[1]
    Lp = 4 * W
    dev = words.device
    i64 = torch.int64
    meta = meta.to(i64)
    nv, stt, nm = meta[:, 0:1], meta[:, 1:2], meta[:, 2:3]
    vm = torch.arange(C, device=dev)[None, :] < nm
    x = mld.to(i64) & 0xFFFFFFFF
    ml = (x >> 15) + MIN_MATCH
    md = (x & 0x7FFF) + 1
    end = mpos.to(i64) + ml
    last_end = torch.where(nm > 0, end.gather(1, (nm - 1).clamp(0, C - 1)), stt)
    ga = torch.cat([torch.where(vm, torch.cat([stt, end[:, :-1]], dim=1), 0), last_end], dim=1)
    gb = torch.cat([torch.where(vm, mpos.to(i64), 0), nv], dim=1)
    live = ga < gb
    one = live.to(i64)
    # each position counts once for every gap that holds it
    delta = torch.zeros((B, Lp + 1), dtype=i64, device=dev)
    delta.scatter_add_(1, torch.where(live, ga, Lp).clamp(0, Lp), one)
    delta.scatter_add_(1, torch.where(live, gb, Lp).clamp(0, Lp), -one)
    mult = torch.cumsum(delta[:, :Lp], dim=1)
    w64 = words.to(i64) & 0xFFFFFFFF
    byte = torch.stack([(w64 >> s) & 0xFF for s in (0, 8, 16, 24)], dim=-1).reshape(B, Lp)
    hist = torch.zeros((B, N_BINS), dtype=i64, device=dev)
    hist.scatter_add_(1, byte, mult)
    lc, _, _ = _len_sym(torch.where(vm, ml, MIN_MATCH))
    dc, _, _ = _dist_sym(torch.where(vm, md, 1))
    hist.scatter_add_(1, (257 + lc).clamp(max=N_BINS - 1), vm.to(i64))
    hist.scatter_add_(1, 288 + dc, vm.to(i64))
    return hist.to(torch.int32)


def _freq_lib():
    fn = _device.library("freq").zrs_freq
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, I, P, P, I, P, P, I, P]
        fn.restype = ctypes.c_int
    return fn


def freq_cuda(words, mpos, mld, meta):
    """Launch K9 over CUDA operands (all int32: words [B, W], mpos/mld
    [B, C], meta [B, 8] = n_valid, start, nmatch, ...)."""
    _device.require_cuda("freq", words, mpos, mld, meta)
    B, W = words.shape
    C = mpos.shape[1]
    ops = [words, mpos, mld, meta]
    if any(t.dtype != torch.int32 for t in ops):
        raise ValueError("freq: operands must be int32")
    if mpos.shape != (B, C) or mld.shape != (B, C) or meta.shape != (B, 8):
        raise ValueError("freq: mpos/mld [B, C], meta [B, 8]")
    words, mpos, mld, meta = [t.contiguous() for t in ops]
    out = torch.empty((B, N_BINS), dtype=torch.int32, device=words.device)
    rc = _freq_lib()(
        _device.ptr(words), W, _device.ptr(mpos), _device.ptr(mld), C,
        _device.ptr(meta), _device.ptr(out), B, _device.stream_of(words),
    )
    _device.check(rc, "freq")
    launches["freq"] += 1
    return out


def freq(words, mpos, mld, meta):
    """The plain version for a CPU tensor, the kernel for a CUDA one."""
    if words.device.type == "cpu":
        return freq_plain(words, mpos, mld, meta)
    return freq_cuda(words, mpos, mld, meta)


# ---------------------------------------------------------------------------
# K3: the bit pack
# ---------------------------------------------------------------------------


def pack_plain(words, mpos, mld, meta, lltab, dtab, oww: int, n_seeds: int):
    """The pack as vector code: per position, a literal's code or a match
    start's two (code + extra) fields; exclusive bit offsets by cumsum;
    fields added into words (their bits never overlap, so the sum is the
    OR). Same outputs as the kernel: owords int32 [B, oww] (zero past the
    slack word), st int32 [B, 8] (total bits, bad), sbit/sout int32
    [B, max(1, n_seeds)], echo int32 [B, 320]."""
    B, W = words.shape
    C = mpos.shape[1]
    Lp = 4 * W
    dev = words.device
    i64 = torch.int64
    meta = meta.to(i64)
    nv, stt, nm, stride = meta[:, 0:1], meta[:, 1:2], meta[:, 2:3], meta[:, 4:5]
    w64 = words.to(i64) & 0xFFFFFFFF
    byte = torch.stack([(w64 >> s) & 0xFF for s in (0, 8, 16, 24)], dim=-1).reshape(B, Lp)
    pos = torch.arange(Lp, device=dev, dtype=i64)[None, :]

    vm = torch.arange(C, device=dev)[None, :] < nm
    x = mld.to(i64) & 0xFFFFFFFF
    mp = torch.where(vm, mpos.to(i64), Lp).clamp(0, Lp)
    ml = (x >> 15) + MIN_MATCH
    md = (x & 0x7FFF) + 1
    cover = torch.zeros((B, Lp + 1), dtype=i64, device=dev)
    cover.scatter_add_(1, mp, vm.to(i64))
    cover.scatter_add_(1, torch.where(vm, mp + ml, Lp).clamp(0, Lp), -vm.to(i64))
    inside = torch.cumsum(cover[:, :Lp], dim=1) > 0
    mlen_at = torch.zeros((B, Lp + 1), dtype=i64, device=dev).scatter_(1, mp, torch.where(vm, ml, 0))[:, :Lp]
    dist_at = torch.zeros((B, Lp + 1), dtype=i64, device=dev).scatter_(1, mp, torch.where(vm, md, 0))[:, :Lp]
    in_rng = (pos >= stt) & (pos < nv)
    is_lit = in_rng & ~inside
    is_m = in_rng & (mlen_at > 0)

    ll = lltab.to(i64) & 0xFFFFFFFF
    dt = dtab.to(i64) & 0xFFFFFFFF
    lit_e = ll.gather(1, byte)
    lc, leb, lev = _len_sym(torch.where(is_m, mlen_at, MIN_MATCH))
    le = ll.gather(1, 257 + lc)
    dc, deb, dev_ = _dist_sym(torch.where(is_m, dist_at, 1))
    de = dt.gather(1, dc)
    v1 = torch.where(is_lit, lit_e & 0xFFFF, (le & 0xFFFF) | (lev << (le >> 16)))
    n1 = torch.where(is_lit, lit_e >> 16, (le >> 16) + leb)
    tok = is_lit | is_m
    v1 = torch.where(tok, v1, 0)
    n1 = torch.where(tok, n1, 0)
    v2 = torch.where(is_m, (de & 0xFFFF) | (dev_ << (de >> 16)), 0)
    n2 = torch.where(is_m, (de >> 16) + deb, 0)

    eob = ll[:, 256:257]
    vals = torch.cat([torch.stack([v1, v2], dim=2).reshape(B, 2 * Lp), eob & 0xFFFF], dim=1)
    nbits = torch.cat([torch.stack([n1, n2], dim=2).reshape(B, 2 * Lp), eob >> 16], dim=1)
    csum = torch.cumsum(nbits, dim=1)
    off = csum - nbits
    total = csum[:, -1]
    wi = off >> 5
    sh = off & 31
    lo = (vals << sh) & 0xFFFFFFFF
    hi = torch.where(sh > 0, vals >> (32 - sh), 0)
    out = torch.zeros((B, oww + 2), dtype=i64, device=dev)
    out.scatter_add_(1, wi.clamp(max=oww + 1), lo)
    out.scatter_add_(1, (wi + 1).clamp(max=oww + 1), hi)
    owords = out[:, :oww].to(torch.int32)

    NS = max(1, n_seeds)
    sbit = torch.zeros((B, NS), dtype=i64, device=dev)
    sout = torch.zeros((B, NS), dtype=i64, device=dev)
    if n_seeds:
        # seed j: the first token at or after output offset j * stride
        tokpos = torch.where(tok, pos, Lp)
        next_tok = torch.flip(torch.cummin(torch.flip(tokpos, [1]), dim=1).values, [1])
        tgt = stt + torch.arange(n_seeds, device=dev, dtype=i64)[None, :] * stride
        sp = next_tok.gather(1, tgt.clamp(max=Lp - 1))
        ok = (tgt < Lp) & (sp < Lp)
        bit_at = off[:, 0 : 2 * Lp : 2]
        sbit = torch.where(ok, bit_at.gather(1, sp.clamp(max=Lp - 1)), total[:, None])
        sout = torch.where(ok, sp - stt, nv - stt)
    st = torch.zeros((B, 8), dtype=i64, device=dev)
    st[:, 0] = total
    st[:, 1] = ((total >> 5) > oww - 1).to(i64)
    echo = torch.cat([lltab[:, :288], dtab[:, :32]], dim=1).to(torch.int32)
    return owords, st.to(torch.int32), sbit.to(torch.int32), sout.to(torch.int32), echo


def _pack_lib():
    fn = _device.library("pack").zrs_pack
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, I, P, P, I, P, P, P, P, I, P, P, P, I, P, I, I, P]
        fn.restype = ctypes.c_int
    return fn


def pack_cuda(words, mpos, mld, meta, lltab, dtab, oww: int, n_seeds: int):
    """Launch K3 over CUDA operands (all int32: words [B, W], mpos/mld
    [B, C], meta [B, 8] = n_valid, start, nmatch, n_seeds, stride, lltab
    [B, 288], dtab [B, 32])."""
    _device.require_cuda("pack", words, mpos, mld, meta, lltab, dtab)
    B, W = words.shape
    C = mpos.shape[1]
    ops = [words, mpos, mld, meta, lltab, dtab]
    if any(t.dtype != torch.int32 for t in ops):
        raise ValueError("pack: operands must be int32")
    if meta.shape != (B, 8) or lltab.shape != (B, 288) or dtab.shape != (B, 32):
        raise ValueError("pack: meta [B, 8], lltab [B, 288], dtab [B, 32]")
    words, mpos, mld, meta, lltab, dtab = [t.contiguous() for t in ops]
    NS = max(1, n_seeds)
    dev = words.device
    owords = torch.empty((B, oww), dtype=torch.int32, device=dev)
    st = torch.empty((B, 8), dtype=torch.int32, device=dev)
    sbit = torch.empty((B, NS), dtype=torch.int32, device=dev)
    sout = torch.empty((B, NS), dtype=torch.int32, device=dev)
    echo = torch.empty((B, 320), dtype=torch.int32, device=dev)
    rc = _pack_lib()(
        _device.ptr(words), W, _device.ptr(mpos), _device.ptr(mld), C,
        _device.ptr(meta), _device.ptr(lltab), _device.ptr(dtab),
        _device.ptr(owords), int(oww), _device.ptr(st), _device.ptr(sbit),
        _device.ptr(sout), NS, _device.ptr(echo), int(n_seeds > 0), B,
        _device.stream_of(words),
    )
    _device.check(rc, "pack")
    launches["pack"] += 1
    return owords, st, sbit, sout, echo


def pack(words, mpos, mld, meta, lltab, dtab, oww: int, n_seeds: int):
    """The plain version for a CPU tensor, the kernel for a CUDA one."""
    if words.device.type == "cpu":
        return pack_plain(words, mpos, mld, meta, lltab, dtab, oww, n_seeds)
    return pack_cuda(words, mpos, mld, meta, lltab, dtab, oww, n_seeds)


def code_tables(freq: torch.Tensor):
    """Both alphabets' trees from a [B, 320] histogram (EOB added). Returns
    (lltab int32 [B, 288], dtab int32 [B, 32]) as code | nbits << 16."""
    ll_freq = freq[:, :286].clone()
    ll_freq[:, 256] += 1  # EOB
    ll_lens, ll_codes, d_lens, d_codes = dynhuff.trees(ll_freq, freq[:, 288:318])
    lltab = F.pad(ll_codes | (ll_lens << 16), (0, 2))
    dtab = F.pad(d_codes | (d_lens << 16), (0, 2))
    return lltab, dtab


def freq_pack_chunks(
    chunks_u8, n_valid, start, mpos, mld, nmatch, hist=None, *, n_seeds: int = 0,
):
    """[K9 histogram] -> trees -> K3 pack from a scan's compact match
    stream. `hist` is the scan's [B, 320] histogram (the hop route's);
    None runs K9 on the match stream (the chain and tab routes).

    chunks_u8: uint8 [B, L] padded chunk buffers (L % 4 == 0). Returns
    (words int32 [B, OWW], total_bits [B], ll_lens [B, 286], d_lens
    [B, 30][, seeds_bit, seeds_out [B, n_seeds]], bad [B]); the lengths
    are read back from the tables the kernel echoes.
    """
    dev = chunks_u8.device
    if hist is None:
        with STAGES.stage("freq", dev):
            words, meta, _oww = pack_inputs(chunks_u8, n_valid, start, nmatch, 0)
            hist = freq(words, mpos, mld, meta)
    with STAGES.stage("post_trees", dev):
        lltab, dtab = code_tables(hist)
    with STAGES.stage("pack", dev):
        return pack_chunks(
            chunks_u8, n_valid, start, mpos, mld, nmatch, lltab, dtab,
            n_seeds=n_seeds,
        )


def pack_inputs(chunks_u8, n_valid, start, nmatch, n_seeds: int):
    """K3's operands besides the match stream and the tables: (words,
    meta [B, 8] = n_valid, start, nmatch, n_seeds, seed stride, oww), with
    oww sized for the worst case of ~16 bits per byte."""
    B, L = chunks_u8.shape
    dev = chunks_u8.device
    oww = (16 * (L + 32) + 64) // 32 + 8
    nv = n_valid.to(device=dev, dtype=torch.int32)
    stt = torch.as_tensor(start, dtype=torch.int32, device=dev).expand(B)
    out_len = (nv - stt).clamp(min=0)
    stride = (out_len // max(n_seeds, 1)).clamp(min=1)
    meta = torch.stack(
        [nv, stt, nmatch.to(device=dev, dtype=torch.int32),
         torch.full((B,), n_seeds, dtype=torch.int32, device=dev), stride],
        dim=1,
    )
    return words_from_bytes(chunks_u8), F.pad(meta, (0, 3)), oww


def pack_chunks(
    chunks_u8, n_valid, start, mpos, mld, nmatch, lltab, dtab, *,
    n_seeds: int = 0,
):
    """K3 with its meta (oww sizing, seed stride); outputs as
    `freq_pack_chunks`."""
    words, meta, oww = pack_inputs(chunks_u8, n_valid, start, nmatch, n_seeds)
    owords, st, sbit, sout, echo = pack(words, mpos, mld, meta, lltab, dtab, oww, n_seeds)
    total = st[:, 0]
    bad = st[:, 1] > 0
    ll_lens = echo[:, :286] >> 16
    d_lens = echo[:, 288:318] >> 16
    if n_seeds:
        return owords, total, ll_lens, d_lens, sbit, sout, bad
    return owords, total, ll_lens, d_lens, bad
