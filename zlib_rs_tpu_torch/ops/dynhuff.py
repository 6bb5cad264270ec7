"""Dynamic Huffman trees for a batch of histograms, in torch ops.

The port of zlib_rs_tpu/ops/dynhuff.py's `code_lengths_kraft` and its
canonical code assignment, batched over rows and computed in float32 exactly
as the reference computes them: start lengths ceil(log2(total / f) -
1e-6) clamped to [1, 15], then bulk density-greedy rounds (density f *
2^len, ties by index) until the Kraft sum is exactly 1, with an early
exit at the exact sum and at most 64 rounds. Rows already at the exact sum
are left unchanged by a round, so the batch loops until every row is done.
"""

from __future__ import annotations

import torch

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
