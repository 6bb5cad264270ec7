"""K2 (hop chase) and K3 (bit pack) of the kernel encode engine, with
their plain PyTorch versions and the torch stages around them.

The port of zlib_rs_tpu/ops/pallas/deflate_kernel.py's hop route:

  scan_chunks_hop    lzvec hop tables (torch) -> K2 chase -> _hop_post
  freq_pack_chunks   EOB bump + both trees (torch) -> K3 pack -> lengths
                     from the tables the kernel echoes

The encode pipeline runs exactly these two compositions, each stage
bracketed by `utils.stages.STAGES`.

K2 (csrc/hop_chase.cu) replaces `scan_chunks_hop_pallas` (body
`_make_kernel_hop`); K3 (csrc/pack.cu) replaces `freq_pack_chunks_pallas`
(body `_pack_kernel`). Both are serial per chunk and latency-bound on the
H100 (one thread per chunk, one block per chunk); their byte floors are
the operands read once and the outputs written once. The sources carry
the design notes.

Each wrapper (`hop_chase`, `pack`) runs the plain version for a CPU tensor
and launches the kernel for a CUDA tensor; nothing falls back. 32-bit
words cross the kernel boundary as int32 bit-views.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from ... import _device
from ...utils.stages import STAGES
from .. import dynhuff, lzvec

MIN_MATCH = 3
MAX_MATCH = 258
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

# launches of the CUDA kernels; the plain versions do not count
launches = {"hop_chase": 0, "pack": 0}


def words_from_bytes(chunks_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [B, L] (L % 4 == 0) -> int32 [B, L/4 + 2] little-endian word
    bit-views with two zero words of tail padding."""
    B, L = chunks_u8.shape
    if L % 4:
        raise ValueError("chunk buffer length must be a multiple of 4")
    w = chunks_u8.contiguous().view(torch.int32)
    return F.pad(w, (0, 2))


def _bit_length(x: torch.Tensor) -> torch.Tensor:
    """Bit length of non-negative int values below 2^16."""
    n = torch.zeros_like(x)
    for k in range(16):
        n = n + ((x >> k) > 0).to(x.dtype)
    return n


def _len_sym(mlen: torch.Tensor):
    """(length code 0..28, extra bits, extra value) of match lengths."""
    v = mlen - MIN_MATCH
    vs = v.clamp(min=8)
    e = _bit_length(vs) - 3
    lc = torch.where(v < 8, v, 4 + 4 * e + ((vs >> e) & 3))
    lc = torch.where(v == 255, 28, lc)
    small = (v < 8) | (v == 255)
    eb = torch.where(small, 0, e)
    ev = torch.where(small, 0, v & ((1 << e.clamp(min=0)) - 1))
    return lc, eb, ev


def _dist_sym(dist: torch.Tensor):
    """(dist code 0..29, extra bits, extra value) of distances."""
    d = dist - 1
    ds = d.clamp(min=4)
    e = _bit_length(ds) - 2
    dc = torch.where(d < 4, d, 2 * (e + 1) + ((ds >> e) & 1))
    eb = torch.where(d < 4, 0, e)
    ev = torch.where(d < 4, 0, d & ((1 << e.clamp(min=0)) - 1))
    return dc, eb, ev


# ---------------------------------------------------------------------------
# K2: the hop chase
# ---------------------------------------------------------------------------


def hop_chase_plain(words, htab, n_valid, start: int, cap_g: int):
    """The chase, one chunk at a time, as the scalar loop it is: each
    step's position depends on the previous match. Same outputs as the
    kernel: mpos/mld int32 [B, CAP_M + 8] (slots past nmatch are 0), st
    int32 [B, 8] (nmatch, bad), freq int32 [B, 4 * 320] (four banks)."""
    B, W = words.shape
    C = CAP_M + 8
    dev = words.device
    w_np = words.cpu().numpy().view(np.uint32)
    h_np = htab.cpu().numpy()
    nv_np = n_valid.cpu().numpy()
    mpos = np.zeros((B, C), np.int64)
    mld = np.zeros((B, C), np.int64)
    st = np.zeros((B, 8), np.int64)
    freq = np.zeros((B, 4 * N_BINS), np.int64)
    for r in range(B):
        w = w_np[r].tolist()
        ht = h_np[r].tolist()
        n_valid_r = int(nv_np[r])
        hist = [0] * (4 * N_BINS)

        def get32(p):
            wi = p >> 2
            sh = (p & 3) << 3
            if sh == 0:
                return w[wi]
            return ((w[wi] >> sh) | (w[wi + 1] << (32 - sh))) & 0xFFFFFFFF

        def tail(x):
            t0 = (x & 0xFF) == 0
            t1 = t0 and (x & 0xFFFF) == 0
            t2 = t1 and (x & 0xFFFFFF) == 0
            return int(t0) + int(t1) + int(t2)

        def count_span(frm, to):
            for p in range(frm, to, 4):
                x = get32(p)
                rem = to - p
                hist[x & 0xFF] += 1
                hist[N_BINS + ((x >> 8) & 0xFF if rem >= 2 else 319)] += 1
                hist[2 * N_BINS + ((x >> 16) & 0xFF if rem >= 3 else 319)] += 1
                hist[3 * N_BINS + (x >> 24 if rem >= 4 else 319)] += 1

        i0, mc, bad = start, 0, False
        while i0 < n_valid_r and not bad:
            e = ht[i0]
            i = i0
            if (e >> 30) <= 0:
                i = min(i0 + e, n_valid_r)
                e = ht[min(i, n_valid_r - 1)]
            if i >= n_valid_r:
                count_span(i0, n_valid_r)
                break
            h = (e >> 23) & 0x7F
            mlen = (e >> 16) & 0x7F
            dist = e & 0xFFFF
            ip = i + h
            count_span(i0, ip)
            cap = min(n_valid_r - ip, MAX_MATCH)
            if mlen == cap_g:
                k = mlen
                while k < cap and get32(ip + k) == get32(ip - dist + k):
                    k += 4
                k = min(k, cap)
                x = get32(ip + k) ^ get32(ip - dist + k)
                mlen = min(k + (0 if x == 0 else tail(x)), cap)
            xt = get32(ip + mlen) ^ get32(max(ip - dist + mlen, 0))
            mlen = min(mlen + tail(xt), cap)
            slot = mc if mc < CAP_M else CAP_M
            mpos[r, slot] = ip
            mld[r, slot] = ((mlen - MIN_MATCH) << 15) | (dist - 1)
            bad = mc >= CAP_M
            mc += 1
            i0 = ip + mlen
        if bad:
            hist[:N_BINS] = [0] * N_BINS
            count_span(start, n_valid_r)
        st[r, 0] = mc
        st[r, 1] = int(bad)
        freq[r] = hist
    as_t = lambda a: torch.from_numpy(a.astype(np.uint32).view(np.int32)).to(dev)
    return as_t(mpos), as_t(mld), as_t(st), as_t(freq)


def _hop_lib():
    fn = _device.library("hop_chase").zrs_hop_chase
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P, I, P, L, P, I, I, P, P, I, P, P, I, P]
        fn.restype = ctypes.c_int
    return fn


def hop_chase_cuda(words, htab, n_valid, start: int, cap_g: int):
    """Launch K2 over CUDA operands: words int32 [B, W], htab int32
    [B, 4W] (row-contiguous), n_valid int [B]."""
    _device.require_cuda("hop_chase", words, htab, n_valid)
    B, W = words.shape
    if words.dtype != torch.int32 or htab.dtype != torch.int32:
        raise ValueError("hop_chase: words and htab must be int32")
    if htab.shape[0] != B or htab.shape[1] < 4 * (W - 2) or htab.stride(1) != 1:
        raise ValueError("hop_chase: htab must be [B, >= 4(W-2)] with contiguous rows")
    words = words.contiguous()
    n_valid = n_valid.to(torch.int32).contiguous()
    if B and int(n_valid.max()) > 4 * (W - 2):
        raise ValueError("hop_chase: n_valid exceeds the word buffer")
    C = CAP_M + 8
    mpos = torch.empty((B, C), dtype=torch.int32, device=words.device)
    mld = torch.empty((B, C), dtype=torch.int32, device=words.device)
    st = torch.empty((B, 8), dtype=torch.int32, device=words.device)
    freq = torch.empty((B, 4 * N_BINS), dtype=torch.int32, device=words.device)
    rc = _hop_lib()(
        _device.ptr(words), W, _device.ptr(htab), htab.stride(0),
        _device.ptr(n_valid), int(start), int(cap_g), _device.ptr(mpos),
        _device.ptr(mld), C, _device.ptr(st), _device.ptr(freq), B,
        _device.stream_of(words),
    )
    _device.check(rc, "hop_chase")
    launches["hop_chase"] += 1
    return mpos, mld, st, freq


def hop_chase(words, htab, n_valid, start: int, cap_g: int):
    """The plain version for a CPU tensor, the kernel for a CUDA one."""
    if words.device.type == "cpu":
        return hop_chase_plain(words, htab, n_valid, start, cap_g)
    return hop_chase_cuda(words, htab, n_valid, start, cap_g)


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
    """Hop tables -> K2 chase -> symbol histogram. Returns (mpos, mld,
    nmatch, kbad, freq [B, 320]); needs max_lazy - MIN_MATCH < 128."""
    dev = words4.device
    with STAGES.stage("hop_tables", dev):
        htab = lzvec.build_hop_tables(
            words4, n_valid, ins_from, depth=depth, nice=nice, good=good,
            max_lazy=max_lazy, w_g=w_g, bytes_arr=bytes_arr, precise=precise,
        )
    with STAGES.stage("hop_chase", dev):
        mpos, mld, st, freq = hop_chase(words4, htab, n_valid, start, 4 * w_g)
    with STAGES.stage("post_trees", dev):
        return _hop_post(mpos, mld, st, freq)


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
    """Both alphabets' trees from a [B, 320] histogram (EOB added), built
    in one batched pass over a zero-padded stack. Returns (lltab int32
    [B, 288], dtab int32 [B, 32]) as code | nbits << 16."""
    B = freq.shape[0]
    ll_freq = freq[:, :286].clone()
    ll_freq[:, 256] += 1  # EOB
    d_freq = freq[:, 288:318]
    both = torch.cat([ll_freq, F.pad(d_freq, (0, 286 - 30))], dim=0)
    lens = dynhuff.code_lengths_kraft(both)
    codes = dynhuff.canonical_codes(lens)
    tabs = codes | (lens << 16)
    lltab = F.pad(tabs[:B], (0, 2))
    dtab = F.pad(tabs[B:, :30], (0, 2))
    return lltab, dtab


def freq_pack_chunks(
    chunks_u8, n_valid, start, mpos, mld, nmatch, freq, *, n_seeds: int = 0,
):
    """Trees -> K3 pack from the chase's compact match stream.

    chunks_u8: uint8 [B, L] padded chunk buffers (L % 4 == 0). Returns
    (words int32 [B, OWW], total_bits [B], ll_lens [B, 286], d_lens
    [B, 30][, seeds_bit, seeds_out [B, n_seeds]], bad [B]); the lengths
    are read back from the tables the kernel echoes.
    """
    dev = chunks_u8.device
    with STAGES.stage("post_trees", dev):
        lltab, dtab = code_tables(freq)
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
