"""Dynamic Huffman trees and the dynamic-block encode of the XLA engine,
in torch ops, batched over rows.

The port of zlib_rs_tpu/ops/dynhuff.py. `code_lengths_kraft` and the
canonical code assignment are computed in float32 exactly as the reference
computes them: start lengths ceil(log2(total / f) - 1e-6) clamped to
[1, 15], then bulk density-greedy rounds (density f * 2^len, ties by index)
until the Kraft sum is exactly 1, with an early exit at the exact sum and
at most 64 rounds. Rows already at the exact sum are left unchanged by a
round, so the batch loops until every row is done.

`encode_chunk_dynamic` encodes each chunk of a batch as one dynamic block
body: the parse of ops/lz77 (or a given one), the two histograms, both
trees, two fields a token and the EOB through `lz77.pack_bits`, and the
decode seeds of indexed streams.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.stages import STAGES
from . import lz77

MAX_BITS = 15
_KRAFT_ONE = 1 << MAX_BITS

# 2^len for len 0..15, the density weight. Exact here; XLA's CPU exp2 is
# not exact at every integer (2^13 comes out as 8192.0039 and 2^15 as
# 32767.984), which can reorder density ties against the JAX package on
# the CPU. The tests swap in XLA's values to compare like with like.
EXP2_LEN = torch.tensor([float(1 << l) for l in range(MAX_BITS + 1)], dtype=torch.float32)


def _kraft_units(lens: torch.Tensor, used: torch.Tensor) -> torch.Tensor:
    return torch.where(used, 1 << (MAX_BITS - lens), 0).sum(dim=1)


def code_lengths_kraft(freqs: torch.Tensor, max_bits: int = MAX_BITS) -> torch.Tensor:
    """Length-limited prefix-code lengths with an exactly tight Kraft sum,
    per row of int [R, n] frequencies. Returns int32 [R, n] (0 for unused
    symbols; a single used symbol gets length 1)."""
    if max_bits != MAX_BITS:
        raise ValueError("only 15-bit codes are supported")
    freqs = freqs.to(torch.int32)
    R, n = freqs.shape
    dev = freqs.device
    used = freqs > 0
    m = used.sum(dim=1)
    total = freqs.sum(dim=1).clamp(min=1)

    f = freqs.clamp(min=1).to(torch.float32)
    ratio = total.to(torch.float32)[:, None] / f
    l0 = torch.ceil(torch.log2(ratio) - 1e-6).to(torch.int32)
    lens = torch.where(used, l0.clamp(1, max_bits), 0)

    iota = torch.arange(n, device=dev, dtype=torch.int32)
    # earlier[i, j]: symbol j precedes symbol i (the index tie rule)
    earlier = iota[None, :] < iota[:, None]
    ff = freqs.to(torch.float32)
    exp2_len = EXP2_LEN.to(dev)

    def round_fn(lens):
        b = (_KRAFT_ONE - _kraft_units(lens, used))[:, None]

        # shorten (b > 0): the prefix of affordable candidates by density
        cand = used & (lens >= 2)
        cost = torch.where(cand, 1 << (max_bits - lens), 0)
        aff = cand & (cost > 0) & (cost <= b)
        dens = torch.where(aff, ff * exp2_len[lens.long()], -1.0)
        di = dens[:, :, None]
        dj = dens[:, None, :]
        denser = (dj > di) | ((dj == di) & earlier[None])
        csum = torch.where(denser & aff[:, None, :], cost[:, None, :], 0).sum(dim=2)
        take = aff & (csum + cost <= b)
        lens_short = torch.where(take & (b > 0), lens - 1, lens)

        # lengthen (b < 0): the lowest-frequency growable symbol
        candl = used & (lens < max_bits)
        lowf = torch.where(candl, freqs, 2**30).min(dim=1, keepdim=True).values
        at_low = candl & (freqs == lowf)
        first_low = at_low & (torch.cumsum(at_low.to(torch.int32), dim=1) == 1)
        lens_long = torch.where(first_low, lens + 1, lens)

        return torch.where(b > 0, lens_short, torch.where(b < 0, lens_long, lens))

    for _ in range(64):
        busy = (m > 0) & (_kraft_units(lens, used) != _KRAFT_ONE)
        if not bool(busy.any()):
            break
        lens = torch.where(busy[:, None], round_fn(lens), lens)
    # single-symbol code: length 1 regardless of the Kraft loop
    lens = torch.where((m == 1)[:, None], used.to(torch.int32), lens)
    return lens.to(torch.int32)


def canonical_codes(lengths: torch.Tensor) -> torch.Tensor:
    """LSB-first canonical codes for each row of int [R, n] lengths.
    Returns int32 [R, n] (0 for length-0 symbols)."""
    lengths = lengths.to(torch.int64)
    R, n = lengths.shape
    dev = lengths.device
    onehot = (
        lengths[:, :, None] == torch.arange(1, MAX_BITS + 1, device=dev)[None, None, :]
    ).to(torch.int64)
    bl_count = onehot.sum(dim=1)  # [R, 15], codes per length 1..15
    nc = [torch.zeros(R, dtype=torch.int64, device=dev)]
    for l in range(2, MAX_BITS + 1):
        nc.append((nc[-1] + bl_count[:, l - 2]) * 2)
    nc = torch.stack(nc, dim=1)  # first canonical code of each length
    rank = torch.cumsum(onehot, dim=1) - onehot  # exclusive, per length
    li = (lengths - 1).clamp(0, MAX_BITS - 1)
    msb = nc.gather(1, li) + rank.gather(2, li[:, :, None])[:, :, 0]
    v = msb
    r = torch.zeros_like(v)
    for _ in range(16):
        r = (r << 1) | (v & 1)
        v = v >> 1
    lsb = torch.where(lengths > 0, r >> (16 - lengths.clamp(min=1)), 0)
    return lsb.to(torch.int32)


def trees(ll_freq: torch.Tensor, d_freq: torch.Tensor):
    """Both alphabets' trees from int [B, 286] literal/length and [B, 30]
    distance histograms, in one batched pass over a zero-padded stack
    (padding leaves a row's lengths alone). Returns (ll_lens, ll_codes,
    d_lens, d_codes), int32."""
    B = ll_freq.shape[0]
    both = torch.cat([ll_freq.to(torch.int32),
                      F.pad(d_freq.to(torch.int32), (0, ll_freq.shape[1] - d_freq.shape[1]))])
    lens = code_lengths_kraft(both)
    codes = canonical_codes(lens)
    nd = d_freq.shape[1]
    return lens[:B], codes[:B], lens[B:, :nd], codes[B:, :nd]


def token_symbols(padded_u8, length, dist, tokens):
    """Per position (ll_sym, d_sym, length extra value and bits, distance
    extra value and bits), int64 [B, n]; d_sym is -1 off matches."""
    n = length.shape[1]
    byte = padded_u8[:, :n].to(torch.int64)
    length = length.to(torch.int64)
    is_match = tokens & (length >= lz77.MIN_MATCH)
    lc, leb, lev = lz77.length_symbol_arith(length.clamp(lz77.MIN_MATCH, lz77.MAX_MATCH))
    dc, deb, dev_ = lz77.dist_symbol_arith(dist.to(torch.int64).clamp(1, lz77.MAX_DIST))
    ll_sym = torch.where(is_match, 257 + lc, byte)
    d_sym = torch.where(is_match, dc, -1)
    zero = torch.zeros_like(lc)
    return (ll_sym, d_sym, torch.where(is_match, lev, zero), torch.where(is_match, leb, zero),
            torch.where(is_match, dev_, zero), torch.where(is_match, deb, zero))


def _histogram(sym: torch.Tensor, live: torch.Tensor, bins: int) -> torch.Tensor:
    """Count of each symbol 0..bins-1 over the live positions of each row."""
    hist = torch.zeros((sym.shape[0], bins + 1), dtype=torch.int32, device=sym.device)
    hist.scatter_add_(1, torch.where(live, sym, bins), torch.ones_like(sym, dtype=torch.int32))
    return hist[:, :bins]


def encode_chunk_dynamic(padded_u8, n_valid, *, chain_depth: int = 4, max_words: int = 16,
                         lazy: bool = False, start: int = 0, valid_from=0, n_seeds: int = 0,
                         parse=None):
    """Each chunk of a batch as one dynamic-Huffman block BODY (the symbols
    and the EOB; the host builds the header from the lengths).

    padded_u8: uint8 [B, n + PAD]; `parse`, when given, is a tokenization
    (tokens, length, dist) of [B, n] positions used as it is, else
    lz77.find_matches and greedy_parse make one. Returns (words int32
    [B, W], body bits int32 [B], ll_lens int32 [B, 286], d_lens int32
    [B, 30]), and with n_seeds > 0 also (seeds_bit, seeds_out int32
    [B, n_seeds]): for seed j the body bit offset and the output offset of
    the first token at or after output offset j * (out_len // n_seeds),
    the restart points of the seeded decoders."""
    B, L = padded_u8.shape
    n = L - lz77.PAD
    dev = padded_u8.device
    if parse is not None:
        tokens, length, dist = parse
        tokens = tokens.to(torch.bool)
    else:
        with STAGES.stage("find_matches", dev):
            length, dist = lz77.find_matches(
                padded_u8, n_valid, chain_depth=chain_depth, max_words=max_words,
                lazy=lazy, valid_from=valid_from,
            )
        with STAGES.stage("greedy_parse", dev):
            tokens = lz77.greedy_parse(length, n_valid, start)
    with STAGES.stage("token_codes", dev):
        ll_sym, d_sym, e1, eb1, e2, eb2 = token_symbols(padded_u8, length, dist, tokens)
        live = tokens
        d_live = live & (d_sym >= 0)
        ll_freq = _histogram(ll_sym, live, 286)
        ll_freq[:, 256] += 1  # EOB
        d_freq = _histogram(d_sym, d_live, 30)
        ll_lens, ll_codes, d_lens, d_codes = trees(ll_freq, d_freq)
        # two fields a token: the length side (<= 20 bits), then the
        # distance side (<= 28 bits)
        ll_n = ll_lens.to(torch.int64).gather(1, ll_sym)
        v1 = ll_codes.to(torch.int64).gather(1, ll_sym) | (e1 << ll_n)
        n1 = torch.where(live, ll_n + eb1, 0)
        safe_d = d_sym.clamp(min=0)
        d_n = d_lens.to(torch.int64).gather(1, safe_d)
        v2 = torch.where(d_live, d_codes.to(torch.int64).gather(1, safe_d) | (e2 << d_n), 0)
        n2 = torch.where(d_live, d_n + eb2, 0)
        values = torch.cat([torch.stack([v1, v2], dim=2).reshape(B, 2 * n),
                            ll_codes[:, 256:257].to(torch.int64)], dim=1)
        nbits = torch.cat([torch.stack([n1, n2], dim=2).reshape(B, 2 * n),
                           ll_lens[:, 256:257].to(torch.int64)], dim=1)
    out_words = (16 * n + 64) // 32 + 4  # ~15.x bits a byte at worst, and the EOB
    with STAGES.stage("pack_bits", dev):
        words, total = lz77.pack_bits(values, nbits, 0, out_words)
    if not n_seeds:
        return words, total, ll_lens, d_lens

    with STAGES.stage("seeds", dev):
        per_pos = n1 + n2  # 0 off tokens
        bit_off = torch.cumsum(per_pos, dim=1) - per_pos
        idx = torch.arange(n, device=dev)
        tok_pos = torch.where(live, idx, n + 1)
        next_tok = torch.cummin(tok_pos.flip(1), dim=1).values.flip(1)
        out_len = (lz77._per_row(n_valid, B, dev) - start).clamp(min=0)
        stride = (out_len // n_seeds).clamp(min=1)
        targets = (start + torch.arange(n_seeds, device=dev) * stride).clamp(0, n - 1)
        seed_pos = next_tok.gather(1, targets)
        valid = seed_pos <= n  # past the last token: an empty walker
        safe = seed_pos.clamp(0, n - 1)
        seeds_bit = torch.where(valid, bit_off.gather(1, safe), total[:, None].to(torch.int64))
        seeds_out = torch.where(valid, safe - start, out_len)
    return (words, total, ll_lens, d_lens, seeds_bit.to(torch.int32),
            seeds_out.to(torch.int32))
