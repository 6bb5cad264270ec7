"""RFC 1951 decode tables and the token resolver shared by the decode
engines.

The port of zlib_rs_tpu/parallel/device_inflate.py's symbol kinds, token
kinds and length/distance tables (lines 41-96), its flat decode-table
build (`_build_flat_lut`, `_ll_symbol_fields`, `_d_symbol_fields`) and its
pointer-doubling token resolver (`resolve_tokens`), batched over rows in
torch ops. The lockstep engine of that module (`decode_regions`) is not
ported.

A flat table has 2^15 uint32 entries, indexed by the next 15 bits of the
stream LSB first: kind << 28 | aux (extra bits) << 22 | code length << 16
| payload (a literal, a base length or a base distance). Entries outside
every code have kind KIND_INVALID and, as in the reference, the fields of
the nearest symbol.
"""

from __future__ import annotations

import numpy as np
import torch

FLAT_BITS = 15

# token kinds in a tape
TOK_NULL = 0  # no token: covers zero output bytes
TOK_LIT = 1
TOK_MATCH = 2
TOK_RAW = 3  # a stored-block run: `b` holds the input byte offset

KIND_LIT = 0
KIND_MATCH = 1
KIND_EOB = 2
KIND_INVALID = 4

# length codes 257..285: base length and extra bits
_LBASE = np.zeros(29, np.int32)
_LEXTRA = np.zeros(29, np.int32)
_l = 3
for _i in range(8):
    _LBASE[_i] = _l
    _l += 1
for _e in range(1, 6):
    for _k in range(4):
        _i += 1
        _LBASE[_i] = _l
        _LEXTRA[_i] = _e
        _l += 1 << _e
_LBASE[28] = 258
_LEXTRA[28] = 0

# distance codes 0..29: base distance and extra bits
_DBASE = np.zeros(30, np.int32)
_DEXTRA = np.zeros(30, np.int32)
_DBASE[:4] = [1, 2, 3, 4]
_d = 5
_i = 3
for _e in range(1, 14):
    for _k in range(2):
        _i += 1
        _DBASE[_i] = _d
        _DEXTRA[_i] = _e
        _d += 1 << _e


def _rev_table(nbits: int) -> np.ndarray:
    """Each index 0 .. 2^nbits - 1 with its nbits bits reversed."""
    idx = np.arange(1 << nbits, dtype=np.int64)
    r = np.zeros_like(idx)
    v = idx.copy()
    for _ in range(nbits):
        r = (r << 1) | (v & 1)
        v >>= 1
    return r


_REV15_NP = _rev_table(FLAT_BITS)


def _lut_entry(kind, aux, nbits, payload):
    return (kind << 28) | (aux << 22) | (nbits << 16) | payload


def _ll_symbol_fields(nsyms: int):
    """(kind, aux, payload) int64 [nsyms] of the literal/length alphabet."""
    syms = np.arange(nsyms)
    kind = np.where(syms < 256, KIND_LIT, KIND_INVALID)
    kind = np.where(syms == 256, KIND_EOB, kind)
    lc = np.clip(syms - 257, 0, 28)
    is_len = (syms >= 257) & (syms < 286)
    kind = np.where(is_len, KIND_MATCH, kind)
    payload = np.where(syms < 256, syms, np.where(is_len, _LBASE[lc], 0))
    aux = np.where(is_len, _LEXTRA[lc], 0)
    return tuple(torch.from_numpy(a.astype(np.int64)) for a in (kind, aux, payload))


def _d_symbol_fields(nsyms: int):
    """(kind, aux, payload) int64 [nsyms] of the distance alphabet."""
    syms = np.arange(nsyms)
    dc = np.clip(syms, 0, 29)
    kind = np.where(syms < 30, KIND_MATCH, KIND_INVALID)
    aux = _DEXTRA[dc] * (syms < 30)
    payload = _DBASE[dc] * (syms < 30)
    return tuple(torch.from_numpy(a.astype(np.int64)) for a in (kind, aux, payload))


def _build_flat_lut(lengths, sym_kind, sym_aux, sym_payload, rev, nbits_total: int = FLAT_BITS):
    """Flat 2^nbits_total decode tables, int64 [B, 2^nbits_total] holding
    the uint32 entries, from int [B, n] code lengths (0 = absent) and each
    symbol's (kind, aux, payload) [n]. Canonical codes from the length
    counts; each key takes the symbol whose interval [code << (nbits_total
    - len), + 2^(nbits_total - len)) holds it, found by counting the
    interval starts at or below it (a histogram and its prefix sum). The
    intervals are sorted stably by start, so over-subscribed codes resolve
    as in the reference."""
    lengths = lengths.to(torch.int64)
    B, n = lengths.shape
    dev = lengths.device
    sym_kind, sym_aux, sym_payload, rev = (t.to(dev) for t in (sym_kind, sym_aux, sym_payload, rev))
    onehot = (lengths[:, :, None] == torch.arange(16, device=dev)).to(torch.int64)
    counts = onehot.sum(dim=1)  # [B, 16]
    # first canonical code of each length: lengths 0 and 1 start at 0
    first = [torch.zeros(B, dtype=torch.int64, device=dev)] * 2
    code = first[0]
    for l in range(2, 16):
        code = (code + counts[:, l - 1]) << 1
        first.append(code)
    first_code = torch.stack(first, dim=1)
    ranks = torch.cumsum(onehot, dim=1) - onehot  # rank among equal lengths
    li = lengths.clamp(0, 15)
    code_msb = first_code.gather(1, li) + ranks.gather(2, li[:, :, None])[:, :, 0]
    valid = lengths > 0
    start = torch.where(valid, code_msb << (nbits_total - lengths).clamp(min=0), 1 << nbits_total)
    span = torch.where(valid, 1 << (nbits_total - lengths).clamp(min=0), 0)
    any_valid = valid.any(dim=1, keepdim=True)

    order = torch.argsort(start, dim=1, stable=True)
    s_start = start.gather(1, order)
    s_end = s_start + span.gather(1, order)
    s_len = lengths.gather(1, order)
    # the covering interval of a key: (starts <= key) - 1
    nbins = (1 << nbits_total) + 1  # a start can equal the sentinel 2^nbits
    hist = torch.zeros((B, nbins), dtype=torch.int64, device=dev)
    hist.scatter_add_(1, s_start.clamp(0, nbins - 1), torch.ones_like(s_start))
    count_le = torch.cumsum(hist, dim=1)
    pos = (count_le.gather(1, rev.expand(B, -1)) - 1).clamp(0, n - 1)
    sym = order.gather(1, pos)
    inside = (rev < s_end.gather(1, pos)) & any_valid
    kind = torch.where(inside, sym_kind[sym], KIND_INVALID)
    return _lut_entry(kind, sym_aux[sym], s_len.gather(1, pos), sym_payload[sym])


def resolve_tokens(comp, tok_kind, tok_a, tok_b, windows, out_size: int, wlen: int):
    """Expand token tapes into output bytes by pointer doubling.

    comp: uint8 [B, L] each row's input bytes (TOK_RAW runs read them);
    tok_kind, tok_a, tok_b: [B, S] tapes (a = bytes covered, b = literal,
    distance or input offset by kind); windows: uint8 [B, wlen] known
    bytes before the output. The index space of a row is [0, wlen +
    out_size): the window, then the output. Returns (uint8 [B, out_size],
    int32 [B] bytes the tokens cover). Each byte finds its token by a
    scatter of the slot indices at the tokens' starts and a running max;
    a match byte points at its source, and rounds of src = src[src] (at
    most (N - 1).bit_length() + 1, stopping when none moves) reach a known
    byte."""
    B, S = tok_a.shape
    L = comp.shape[1]
    dev = comp.device
    kind = tok_kind.to(torch.int64)
    a = tok_a.to(torch.int64)
    b = tok_b.to(torch.int64)
    covers = torch.where(kind == TOK_NULL, 0, a)
    pos = wlen + torch.cumsum(covers, dim=1) - covers
    tot = wlen + covers.sum(dim=1, keepdim=True)
    N = wlen + out_size
    idx = torch.arange(N, device=dev)

    live = kind != TOK_NULL
    tgt = torch.where(live & (pos >= 0) & (pos < N), pos, N)  # others dropped
    slot = torch.arange(S, device=dev).expand(B, S)
    starts = torch.zeros((B, N + 1), dtype=torch.int64, device=dev)
    starts = starts.scatter_reduce(1, tgt, torch.where(live, slot, 0), "amax")[:, :N]
    t = torch.cummax(starts, dim=1).values.clamp(0, S - 1)
    in_window = idx < wlen
    within = idx < tot
    k = kind.gather(1, t)
    bt = b.gather(1, t)
    off = idx - pos.gather(1, t)
    val = torch.where(k == TOK_LIT, bt, 0).to(torch.uint8)
    raw = comp.gather(1, (bt + off).clamp(0, L - 1))
    val = torch.where(k == TOK_RAW, raw, val)
    if wlen:
        win = windows.to(dev).gather(1, idx.clamp(max=wlen - 1).expand(B, N))
        val = torch.where(in_window, win, val)
    # bytes past the covered total are never read: known (self-pointing),
    # so the fixpoint converges
    known0 = in_window | (k == TOK_LIT) | (k == TOK_RAW) | ~within
    src = torch.where(known0, idx, torch.where(k == TOK_MATCH, idx - bt, idx))
    rounds = max(1, (max(N, 2) - 1).bit_length() + 1)
    for _ in range(rounds):
        nsrc = src.gather(1, src.clamp(0, N - 1))
        if torch.equal(nsrc, src):
            break
        src = nsrc
    val = val.gather(1, src.clamp(0, N - 1))
    out = torch.where(within, val, 0)
    return out[:, wlen:], (tot[:, 0] - wlen).to(torch.int32)
