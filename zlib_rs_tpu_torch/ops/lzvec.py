"""Vectorized LZ77 match tables and hop tables, in torch ops.

The same pipeline as zlib_rs_tpu/ops/lzvec.py, which runs there as XLA
vector code (no Pallas kernel), so plain torch ops are its port:

  1. zlib's 3-byte rolling hash at every position;
  2. one sort by the int64 key (hash << 16 | pos): a hash group becomes a
     position-ordered run, so the j-th predecessor of a row in sorted
     order is its j-th chain candidate, newest first. The first w_g
     suffix words of every position ride along as gathered payloads;
  3. a loop over j = 1..depth keeps the running (best_len,
     first-achieving dist) under zlib's walk rules (budget in chain steps,
     inclusive stop at nice, window edge), split at depth >> 2 for the
     quartered budget zlib uses once the pending match is already `good`;
  4. a scatter by position undoes the sort.

`build_hop_tables` then runs deflate_slow's one-step-lazy decision chain
for every position at once, so the parse becomes a pointer chase (the K2
kernel in ops/kernels/deflate_kernel).

Words are carried as int64 holding unsigned 32-bit values, or as int32
bit-views where only equality and xor are needed; keys as int64 (CPU
torch has no uint32 shifts or comparisons). Keys hash << 16 | pos are
unique per row, so the sort needs no stability.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

HASH_BITS = 15
HSIZE = 1 << HASH_BITS
MIN_MATCH = 3
MAX_MATCH = 258
MAX_DIST = 32768

# byte-precise candidate lengths in the first _PRECISE_WORDS words,
# whole-word granular beyond (the parse extends every emitted match
# byte-exactly)
_PRECISE_WORDS = 2


def _unaligned_words(words4: torch.Tensor) -> torch.Tensor:
    """int [B, W] aligned LE words (unsigned values) -> int64 [B, 4W]
    word-at-every-byte (U[p] = bytes p..p+3 LE), zero past the end."""
    B, W = words4.shape
    w = words4.to(torch.int64) & 0xFFFFFFFF
    b = torch.stack([(w >> s) & 0xFF for s in (0, 8, 16, 24)], dim=-1)
    return _unaligned_words_from_bytes(b.reshape(B, 4 * W), 4 * W)


def _unaligned_words_from_bytes(bytes_arr: torch.Tensor, P: int) -> torch.Tensor:
    """uint8/int [B, L] -> int64 [B, P] word-at-every-byte from four
    shifted slices of the byte array (zero fill past L)."""
    B, L = bytes_arr.shape
    need = P + 3
    b = bytes_arr.to(torch.int64)
    b = F.pad(b, (0, need - L)) if L < need else b[:, :need]
    return (
        b[:, :P]
        | (b[:, 1 : P + 1] << 8)
        | (b[:, 2 : P + 2] << 16)
        | (b[:, 3 : P + 3] << 24)
    )


def _tail_bytes(xr: torch.Tensor) -> torch.Tensor:
    """Equal leading bytes (0..3) of a nonzero xor word."""
    t0 = (xr & 0xFF) == 0
    t1 = t0 & ((xr & 0xFFFF) == 0)
    t2 = t1 & ((xr & 0xFFFFFF) == 0)
    return t0.to(torch.int32) + t1.to(torch.int32) + t2.to(torch.int32)


def _compare_stage(ks, G, n_valid, *, depth, nice, w_g, precise=False):
    """The chain walk over sorted rows: candidate j of row k is row k - j.
    Returns (packed, packed32): int32 [B, P] (len << 16 | dist) for the
    full and the quartered budget, 0 where no match >= MIN_MATCH."""
    B, P = ks.shape
    dev = ks.device
    pos_k = (ks & 0xFFFF).to(torch.int32)
    hash_k = (ks >> 16).to(torch.int32)  # 0x8000 marks non-inserted rows
    searcher = hash_k < 0x8000
    cap_k = (n_valid[:, None] - pos_k).clamp(0, MAX_MATCH)
    nice_eff = torch.clamp(cap_k, max=nice)

    pad = depth
    # left padding: hash 0xFFFF matches no row, so padded candidates are
    # never valid
    hash_p = F.pad(hash_k, (pad, 0), value=0xFFFF)
    pos_p = F.pad(pos_k, (pad, 0), value=0xFFFF)
    G_p = [F.pad(g, (pad, 0)) for g in G]

    packed = torch.zeros((B, P), dtype=torch.int32, device=dev)
    frozen = torch.zeros((B, P), dtype=torch.bool, device=dev)
    q = depth >> 2  # 0: the quartered budget finds nothing
    packed32 = packed
    for j in range(1, depth + 1):
        lo = pad - j
        same = hash_p[:, lo : lo + P] == hash_k
        dist = pos_k - pos_p[:, lo : lo + P]
        valid = searcher & same & (dist >= 1) & (dist <= MAX_DIST)

        xr0 = G[0] ^ G_p[0][:, lo : lo + P]
        pe = xr0 == 0
        L = torch.where(pe, 4, _tail_bytes(xr0))
        for w in range(1, w_g):
            gp = G_p[w][:, lo : lo + P]
            if precise or w < _PRECISE_WORDS:
                xr = G[w] ^ gp
                eq = xr == 0
                L = L + torch.where(pe, torch.where(eq, 4, _tail_bytes(xr)), 0)
                pe = pe & eq
            else:
                pe = pe & (G[w] == gp)
                L = L + 4 * pe.to(torch.int32)
        L = torch.where(valid, torch.minimum(L, cap_k), 0)

        live = ~frozen
        better = live & (L > (packed >> 16))
        packed = torch.where(better, (L << 16) | dist, packed)
        frozen = frozen | (live & valid & (L >= nice_eff))
        if j == q:
            packed32 = packed
    keep = (packed >> 16) >= MIN_MATCH
    keep32 = (packed32 >> 16) >= MIN_MATCH
    return torch.where(keep, packed, 0), torch.where(keep32, packed32, 0)


def build_match_tables(
    words4, n_valid, ins_from, *, depth: int, nice: int, w_g: int = 16,
    bytes_arr=None, precise: bool = False,
):
    """Per-position zlib longest_match summaries for a batch of chunks.

    words4: int [B, W] aligned LE words (>= 2 zero pad words at the tail),
    unsigned values or int32 bit-views. n_valid / ins_from: int [B];
    positions [ins_from, n_valid) are chain-inserted. `bytes_arr` (uint8
    [B, L], the same data bytewise) builds the unaligned words directly.

    Returns (tab_full, tab_quart): int32 [B, 4W], position-indexed packed
    (len << 16 | dist) for budget `depth` and `depth >> 2`, 0 where the
    walk finds nothing; len is capped at 4 * w_g.
    """
    B, W = words4.shape
    P = 4 * W
    cap_g = 4 * w_g
    dev = words4.device
    n_valid = n_valid.to(device=dev, dtype=torch.int32)
    ins_from = ins_from.to(device=dev, dtype=torch.int32)

    if bytes_arr is not None:
        U = _unaligned_words_from_bytes(bytes_arr, P)
    else:
        U = _unaligned_words(words4)
    pos = torch.arange(P, device=dev, dtype=torch.int64)[None, :]

    h = (((U & 0xFF) << 10) ^ (((U >> 8) & 0xFF) << 5) ^ ((U >> 16) & 0xFF)) & (HSIZE - 1)
    # non-inserted rows get hash field 0x8000 (above every real hash) and
    # keep their position, so the back-scatter by position is complete
    real = (pos >= ins_from[:, None]) & (pos < n_valid[:, None])
    key = torch.where(real, h << 16, 0x8000 << 16) | pos
    ks, perm = torch.sort(key, dim=1)

    # payload w of sorted row k = the word 4w bytes into its suffix
    U32 = F.pad(U.to(torch.int32), (0, cap_g))
    G = [U32.gather(1, perm + 4 * w) for w in range(w_g)]

    packed, packed32 = _compare_stage(
        ks, G, n_valid, depth=depth, nice=nice, w_g=w_g, precise=precise,
    )
    tabf = torch.empty_like(packed).scatter_(1, perm, packed)
    tabq = torch.empty_like(packed32).scatter_(1, perm, packed32)
    return tabf, tabq


def _shift_fwd(x: torch.Tensor, k: int) -> torch.Tensor:
    """y[p] = x[p + k], zero fill past the end."""
    return F.pad(x[:, k:], (0, k))


def build_hop_tables(
    words4, n_valid, ins_from, *,
    depth: int, nice: int, good: int, max_lazy: int, w_g: int = 8,
    bytes_arr=None, precise: bool = False,
):
    """deflate_slow's lazy decision chain for every position at once.

    From a clean arrival at p the deferral chain is a pure function of p
    (the pending length strictly grows and the search stops at max_lazy),
    so hop k of every position reads the tables at p + k: a constant
    shift. Returns htab int32 [B, 4W], position-indexed:
      delta >= 1                            -> literal run: the next match
                                               stop is delta bytes ahead
      (1 << 30) | h << 23 | len << 16 | d   -> h deferred literals, then a
                                               match (len, d) at p + h
    len is capped at 4 * w_g (the chase extends it at emit); needs
    4 * w_g < 128 and max_lazy - MIN_MATCH < 128.
    """
    if 4 * w_g >= 128 or max_lazy - MIN_MATCH >= 128:
        raise ValueError("hop-table field widths need 4*w_g < 128 and "
                         "max_lazy - MIN_MATCH < 128")
    B, W = words4.shape
    P = 4 * W
    dev = words4.device
    n_valid = n_valid.to(device=dev, dtype=torch.int32)
    tabf, tabq = build_match_tables(
        words4, n_valid, ins_from, depth=depth, nice=nice, w_g=w_g,
        bytes_arr=bytes_arr, precise=precise,
    )
    Mf, Df = tabf >> 16, tabf & 0xFFFF
    pos = torch.arange(P, device=dev, dtype=torch.int32)[None, :]
    nv = n_valid[:, None]

    # hop 0: the clean-arrival search (full budget, threshold 0)
    is_lit = (Mf < MIN_MATCH) | ((Mf == MIN_MATCH) & (Df > 4096))
    plen, pdist = Mf, Df
    h = torch.zeros((B, P), dtype=torch.int32, device=dev)
    alive = ~is_lit
    for k in range(1, max_lazy - MIN_MATCH + 1):
        t = torch.where(plen >= good, _shift_fwd(tabq, k), _shift_fwd(tabf, k))
        cand = t >> 16
        ne = torch.clamp((nv - (pos + k)).clamp(0, MAX_MATCH), max=nice)
        found = (
            alive
            & (pos + k < nv)
            & (plen < max_lazy)
            & (plen < ne)
            & (cand > plen)
        )
        plen = torch.where(found, cand, plen)
        pdist = torch.where(found, t & 0xFFFF, pdist)
        h = torch.where(found, k, h)
        alive = found
    match_ent = (1 << 30) | (h << 23) | (plen << 16) | pdist
    # literal slots carry the distance to the next match stop (a reverse
    # running minimum of stop positions); a run with no following stop
    # jumps past the end
    stoppos = torch.where(is_lit, 2 * P, pos)
    ns = torch.flip(torch.cummin(torch.flip(stoppos, [1]), dim=1).values, [1])
    return torch.where(is_lit, ns - pos, match_ent)
