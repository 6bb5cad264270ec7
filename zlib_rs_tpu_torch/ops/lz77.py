"""LZ77 match finding, greedy parsing and bit packing in torch ops: the
stages of the XLA encode engine, batched over chunks.

The port of zlib_rs_tpu/ops/lz77.py. The reference maps one chunk and
vmaps it over a batch; here every function takes the batch itself, chunk
buffers uint8 [B, n + PAD] (a row a chunk, zero-padded past its data),
with per-row `n_valid` and `valid_from` (an int or an int tensor [B]).
Each result equals the reference's row for row:

  * find_matches: the sorted-space chain (a stable argsort by hash puts a
    position's chain at its `chain_depth` sorted predecessors), the staged
    probe words compared as shifted rows, the byte tail at the break step,
    the winner-only extension, the exact dist-1 run rescue, zlib's TOO_FAR
    rule and the one-step lazy deferral;
  * greedy_parse: pointer doubling, ceil(log2 n) + 1 rounds of a
    scatter-max into n + 1 slots;
  * token_codes_static and the symbol arithmetic: RFC 1951's static codes
    and length/distance symbols computed, not looked up;
  * pack_bits: the reference compacts the live tokens and ORs each word's
    tokens with segmented scans and a one-hot matmul histogram, layouts
    for the TPU. A token's offset is the exclusive sum of the bits before
    it either way (dead tokens have none), so here each live token adds
    its low part into its start word and its spill into the next. A sum
    is the OR while the live fields are disjoint, that is while every live
    value is below 2^nbits, which every code path here keeps (the tests
    check it).

32-bit words are carried in int64 and masked (CPU torch has no uint32
arithmetic); packed words leave as int32 bit-views, as K3's do. The
reference's `clz` steps are exact comparisons here.
"""

from __future__ import annotations

import math

import torch

from ..utils.stages import STAGES

MAX_MATCH = 258
MIN_MATCH = 3
MAX_DIST = 32768
TOO_FAR = 4096  # a length-3 match further back than this is no match
HASH_MULT = 2654435761
HASH_BITS = 20
PAD = 272  # tail padding so word reads past n_valid stay in bounds
STAGE_WORDS = 10  # probe words staged into sorted order
_M32 = 0xFFFFFFFF


def _per_row(x, B: int, device) -> torch.Tensor:
    """An int or an int tensor [B] as an int64 column [B, 1]."""
    return torch.as_tensor(x, device=device).to(torch.int64).expand(B).reshape(B, 1)


def _shift_right(x: torch.Tensor, k: int, fill: int) -> torch.Tensor:
    """Each row moved k places to the right, `fill` shifted in."""
    B, n = x.shape
    head = x.new_full((B, min(k, n)), fill)
    return torch.cat([head, x[:, : n - k]], dim=1) if k < n else head


def words_le32(padded_u8: torch.Tensor) -> torch.Tensor:
    """The little-endian u32 word at every byte offset of each row, int64
    [B, L - 3]."""
    b = padded_u8.to(torch.int64)
    return b[:, :-3] | (b[:, 1:-2] << 8) | (b[:, 2:-1] << 16) | (b[:, 3:] << 24)


def hash4(words: torch.Tensor) -> torch.Tensor:
    """Knuth's multiplicative hash of 4-byte words: (w * 2654435761) mod 2^32
    >> (32 - HASH_BITS). The product is taken in two 16-bit halves of the
    multiplier, so that no step overflows int64."""
    lo = words * (HASH_MULT & 0xFFFF)
    hi = ((words * (HASH_MULT >> 16)) & 0xFFFF) << 16
    return ((lo + hi) & _M32) >> (32 - HASH_BITS)


def _tail_bytes(x: torch.Tensor) -> torch.Tensor:
    """Equal low bytes (0..3) of two words from their xor: the trailing zero
    count over 8, at most 3."""
    return (((x & 0xFF) == 0).to(torch.int64) + ((x & 0xFFFF) == 0).to(torch.int64)
            + ((x & 0xFFFFFF) == 0).to(torch.int64))


def _run_match_lengths(padded_u8, n: int, n_valid, valid_from) -> torch.Tensor:
    """Exact dist-1 match length at every position: the count of j >= i
    with data[j] == data[j - 1] up to the first j where it fails, at most
    MAX_MATCH. Long runs keep their full length past the word cap."""
    B = padded_u8.shape[0]
    idx = torch.arange(n, device=padded_u8.device)
    eq = torch.zeros((B, n), dtype=torch.bool, device=padded_u8.device)
    eq[:, 1:] = padded_u8[:, 1:n] == padded_u8[:, : n - 1]
    eq &= (idx < n_valid) & (idx > valid_from)
    mism = torch.where(eq, n, idx)
    next_mism = torch.cummin(mism.flip(1), dim=1).values.flip(1)
    return (next_mism - idx).clamp(max=MAX_MATCH)


def _candidate_match_len(words, idx, cand, maxcap, max_words: int, skip_words: int = 0):
    """Match length between positions idx and cand < idx: a word scan of up
    to `max_words` u32 steps (the first `skip_words` taken as equal), the
    byte tail of the first unequal word, capped by `maxcap`."""
    B, n = cand.shape
    safe_c = cand.clamp(min=0)
    cum = torch.ones((B, n), dtype=torch.bool, device=words.device)
    nwords = torch.full((B, n), skip_words, dtype=torch.int64, device=words.device)
    for s in range(skip_words, max_words):
        a = words[:, 4 * s : 4 * s + n]
        b = words.gather(1, safe_c + 4 * s)
        cum &= a == b
        nwords += cum
    off = 4 * nwords
    x = words.gather(1, idx + off) ^ words.gather(1, safe_c + off)
    raw = (off + _tail_bytes(x)).clamp(max=4 * max_words)
    return torch.minimum(raw, maxcap)


def find_matches(padded_u8, n_valid, *, chain_depth: int = 4, max_words: int = 16,
                 lazy: bool = False, valid_from=0):
    """Best (length, dist) match at every position of each chunk.

    padded_u8: uint8 [B, n + PAD]; [valid_from, n_valid) of a row is its
    real data (a short dictionary leaves a gap before it). Returns (length
    int32 [B, n], dist int32 [B, n]); length < MIN_MATCH is a literal.
    `chain_depth` bounds the candidates a position tries, `max_words` its
    word scan (run matches are exact)."""
    B, L = padded_u8.shape
    n = L - PAD
    dev = padded_u8.device
    nv = _per_row(n_valid, B, dev)
    vf = _per_row(valid_from, B, dev)
    words = words_le32(padded_u8)
    idx = torch.arange(n, device=dev)
    rows_idx = idx.expand(B, n)
    h = hash4(words[:, :n])
    # positions outside [valid_from, n_valid) get hashes above every real
    # one, so they join no chain and are no candidate
    h = torch.where((idx >= vf) & (idx < nv), h, (1 << HASH_BITS) + (idx & 0xFF))
    maxcap = (nv - idx).clamp(0, MAX_MATCH)

    # sorted space: in stable (hash, position) order a position's chain is
    # its k = 1..chain_depth sorted predecessors, and the staged probe
    # words make each candidate compare a shifted row
    stage_words = min(STAGE_WORDS, max_words)
    po = torch.argsort(h, dim=1, stable=True)
    sh = h.gather(1, po)
    rank = torch.empty_like(po).scatter_(1, po, rows_idx)
    ws = [words.gather(1, po + 4 * s) for s in range(stage_words)]
    capw_s = maxcap.gather(1, po).clamp(max=4 * stage_words)

    len_s = torch.zeros((B, n), dtype=torch.int64, device=dev)
    dist_s = torch.zeros_like(len_s)
    for k in range(1, chain_depth + 1):
        sh_k = _shift_right(sh, k, -1)
        po_k = _shift_right(po, k, -1)
        dist = po - po_k
        ok = (sh_k == sh) & (po_k >= 0) & (dist >= 1) & (dist <= MAX_DIST)
        cum = ok
        nw = torch.zeros_like(len_s)
        tail = torch.zeros_like(len_s)
        for s in range(stage_words):
            ws_k = _shift_right(ws[s], k, 0)
            eq = ws_k == ws[s]
            # the exact byte tail, taken at the step where the scan breaks
            tail = torch.where(cum & ~eq, _tail_bytes(ws_k ^ ws[s]), tail)
            cum = cum & eq
            nw += cum
        ml = torch.where(ok, torch.minimum(4 * nw + tail, capw_s), 0)
        better = ml > len_s  # strict: the more recent candidate wins ties
        len_s = torch.where(better, ml, len_s)
        dist_s = torch.where(better, dist, dist_s)

    best_len = len_s.gather(1, rank)
    best_dist = torch.where(best_len > 0, dist_s.gather(1, rank), 0)
    win_cand = torch.where(best_len > 0, idx - best_dist, -1)

    if max_words > stage_words:  # extend only the winner past the staged words
        ext = _candidate_match_len(words, rows_idx, win_cand.clamp(min=0), maxcap,
                                   max_words, skip_words=stage_words)
        hit_cap = (win_cand >= 0) & (best_len >= 4 * stage_words)
        best_len = torch.where(hit_cap, ext, best_len)

    run_len = _run_match_lengths(padded_u8, n, nv, vf)
    run_ok = (idx > vf) & (run_len >= best_len) & (run_len >= MIN_MATCH)
    best_dist = torch.where(run_ok & (run_len > best_len), 1, best_dist)
    best_len = torch.where(run_ok, torch.maximum(run_len, best_len), best_len)

    accept = (best_len >= MIN_MATCH) & ~((best_len == MIN_MATCH) & (best_dist > TOO_FAR))
    best_len = torch.where(accept, best_len, 0)
    best_dist = torch.where(accept, best_dist, 0)

    if lazy:
        # a position whose successor matches strictly longer becomes a
        # literal, so the parse takes the longer match a byte later
        nxt = torch.cat([best_len[:, 1:], best_len.new_zeros((B, 1))], dim=1)
        defer = (best_len >= MIN_MATCH) & (nxt > best_len)
        best_len = torch.where(defer, 0, best_len)
        best_dist = torch.where(defer, 0, best_dist)
    return best_len.to(torch.int32), best_dist.to(torch.int32)


def greedy_parse(length, n_valid, start: int = 0) -> torch.Tensor:
    """Token-start mask bool [B, n] by pointer doubling: nxt[i] = i +
    max(length[i], 1); each of ceil(log2 n) + 1 rounds scatter-maxes the
    visited marks into nxt and doubles nxt. `start` is the first emitted
    position (the bytes before it are dictionary)."""
    B, n = length.shape
    dev = length.device
    idx = torch.arange(n, device=dev)
    nxt = (idx + length.to(torch.int64).clamp(min=1)).clamp(max=n)
    visited = torch.zeros((B, n + 1), dtype=torch.int32, device=dev)
    visited[:, start] = 1
    rounds = int(math.ceil(math.log2(max(n, 2)))) + 1
    for _ in range(rounds):
        visited = visited.scatter_reduce(1, nxt, visited[:, :n], "amax", include_self=True)
        nxt = nxt.gather(1, nxt.clamp(max=n - 1)).clamp(max=n)
        nxt = torch.where(nxt <= idx, n, nxt)  # strictly forward
    nv = _per_row(n_valid, B, dev)
    return (visited[:, :n] > 0) & (idx >= start) & (idx < nv)


def bit_reverse(v: torch.Tensor, nbits) -> torch.Tensor:
    """The low `nbits` (<= 16) bits of each value reversed."""
    v = v.to(torch.int64)
    r = torch.zeros_like(v)
    for _ in range(16):
        r = (r << 1) | (v & 1)
        v = v >> 1
    return r >> (16 - torch.as_tensor(nbits, device=r.device).to(torch.int64))


def _bitlen(v: torch.Tensor) -> torch.Tensor:
    """Bit length of non-negative values below 2^16."""
    n = torch.zeros_like(v)
    for k in range(16):
        n = n + ((v >> k) > 0).to(v.dtype)
    return n


def length_symbol_arith(safe_len: torch.Tensor):
    """(length code 0..28, extra bits, extra value) of match lengths 3..258,
    by the RFC's doubling construction."""
    v = safe_len - MIN_MATCH
    vs = v.clamp(min=8)
    e = _bitlen(vs) - 3
    lc = torch.where(v < 8, v, 4 + 4 * e + ((vs >> e) & 3))
    lc = torch.where(v == 255, 28, lc)
    small = (v < 8) | (v == 255)
    eb = torch.where(small, 0, e)
    ev = torch.where(small, 0, v & ((1 << e.clamp(min=0)) - 1))
    return lc, eb, ev


def dist_symbol_arith(safe_d: torch.Tensor):
    """(distance code 0..29, extra bits, extra value) of distances 1..32768."""
    d = safe_d - 1
    ds = d.clamp(min=4)
    e = _bitlen(ds) - 2
    dc = torch.where(d < 4, d, 2 * (e + 1) + ((ds >> e) & 1))
    eb = torch.where(d < 4, 0, e)
    ev = torch.where(d < 4, 0, d & ((1 << e.clamp(min=0)) - 1))
    return dc, eb, ev


def static_litlen_code(sym: torch.Tensor):
    """(LSB-first code, nbits) of the RFC 1951 fixed literal/length tree,
    from its four ranges (3.2.6)."""
    code_msb = torch.where(
        sym < 144, 0x30 + sym,
        torch.where(sym < 256, 0x190 + (sym - 144),
                    torch.where(sym < 280, sym - 256, 0xC0 + (sym - 280))),
    )
    nbits = torch.where(sym < 144, 8, torch.where(sym < 256, 9, torch.where(sym < 280, 7, 8)))
    return bit_reverse(code_msb, nbits), nbits


def token_codes_static(padded_u8, length, dist, tokens):
    """(value int64, nbits int32) [B, n] of every position under the static
    trees: a literal's code, or a match's length code, extra, distance code
    and extra fused into one field of at most 31 bits; 0 bits off tokens."""
    n = length.shape[1]
    byte = padded_u8[:, :n].to(torch.int64)
    length = length.to(torch.int64)
    is_match = tokens & (length >= MIN_MATCH)
    lit_v, lit_n = static_litlen_code(byte)
    lc, eb1, e1 = length_symbol_arith(length.clamp(MIN_MATCH, MAX_MATCH))
    v1, n1 = static_litlen_code(257 + lc)
    dc, eb2, e2 = dist_symbol_arith(dist.to(torch.int64).clamp(1, MAX_DIST))
    v2 = bit_reverse(dc, 5)  # fixed distance codes are 5 bits
    sh2 = n1 + eb1
    sh3 = sh2 + 5
    match_v = v1 | (e1 << n1) | (v2 << sh2) | (e2 << sh3)
    value = torch.where(tokens, torch.where(is_match, match_v, lit_v), 0)
    nbits = torch.where(tokens, torch.where(is_match, sh3 + eb2, lit_n), 0)
    return value, nbits.to(torch.int32)


def _as_int32_bits(w: torch.Tensor) -> torch.Tensor:
    """int64 values below 2^32 as int32 bit-views."""
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def pack_bits(value, nbits, header_bits: int, out_words: int):
    """Pack the live (nbits > 0) (value, nbits) fields of each row, in order,
    after `header_bits` zero bits, into int32 [B, out_words] words (LSB
    first). Returns (words, total bits int32 [B], the header included).
    Each field is at most 32 bits, so it touches its start word and the
    next; bits past out_words are dropped."""
    B = value.shape[0]
    nb = nbits.to(torch.int64)
    live = nb > 0
    total = header_bits + nb.sum(dim=1)
    off = header_bits + torch.cumsum(nb, dim=1) - nb
    sw = off >> 5
    sh = off & 31
    v = torch.where(live, value.to(torch.int64) & _M32, 0)
    lo = (v << sh) & _M32
    hi = v >> (32 - sh)
    acc = torch.zeros((B, out_words + 1), dtype=torch.int64, device=value.device)
    acc.scatter_add_(1, torch.where(live & (sw < out_words), sw, out_words), lo)
    acc.scatter_add_(1, torch.where(live & (sw + 1 < out_words), sw + 1, out_words), hi)
    return _as_int32_bits(acc[:, :out_words]), total.to(torch.int32)


def encode_chunk_static(padded_u8, n_valid, final, *, chain_depth: int = 4,
                        max_words: int = 16, lazy: bool = False, start: int = 0,
                        valid_from=0):
    """Each chunk as one static-Huffman block: its header (BFINAL = final,
    BTYPE = 01), every token's code and the 7-bit EOB. Returns (words int32
    [B, W], total bits int32 [B]); the caller byte-aligns and stitches."""
    B, L = padded_u8.shape
    n = L - PAD
    dev = padded_u8.device
    with STAGES.stage("find_matches", dev):
        length, dist = find_matches(padded_u8, n_valid, chain_depth=chain_depth,
                                    max_words=max_words, lazy=lazy, valid_from=valid_from)
    with STAGES.stage("greedy_parse", dev):
        tokens = greedy_parse(length, n_valid, start)
    with STAGES.stage("token_codes", dev):
        value, nbits = token_codes_static(padded_u8, length, dist, tokens)
    out_words = (9 * n + 64) // 32 + 2  # ~9.06 bits a byte at worst, header and EOB
    with STAGES.stage("pack_bits", dev):
        words, total = pack_bits(value, nbits, 3, out_words)
        header = _per_row(final, B, dev)[:, 0].to(torch.int32) | 2  # BFINAL | BTYPE=01 << 1
        words[:, 0] += header  # bits 0-2 of word 0 are still zero
    return words, total + 7  # EOB: the static code of 256 is 7 zero bits
