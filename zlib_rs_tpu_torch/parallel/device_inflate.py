"""RFC 1951 decode tables, the lockstep region decoder and the token
resolver shared by the decode engines.

The port of zlib_rs_tpu/parallel/device_inflate.py: its symbol kinds,
token kinds, lane phases and length/distance tables (lines 41-114), its
flat decode-table build (`_build_flat_lut` and the symbol fields), its
lockstep state machine over byte-padded regions (`decode_regions`: the
hand-written CUDA kernel csrc/lockstep.cu for a CUDA tensor, its plain
version `decode_regions_plain` in torch ops for a CPU one) and its
pointer-doubling token resolver (`resolve_tokens`), batched over rows.

A flat table has 2^15 uint32 entries, indexed by the next 15 bits of the
stream LSB first: kind << 28 | aux (extra bits) << 22 | code length << 16
| payload (a literal, a base length or a base distance). Entries outside
every code have kind KIND_INVALID and, as in the reference, the fields of
the nearest symbol.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _device

FLAT_BITS = 15
CL_BITS = 7

# runs of the lockstep engine, the steps they took and the plain
# version's symbol blocks, for tests and the smoke run to show whether it ran
runs = {"decode_regions": 0, "steps": 0, "symbol_blocks": 0}

# launches of the CUDA kernel; the plain version does not count
launches = {"lockstep": 0}

# steps a symbol block of decode_regions runs without a host read
SYMBOL_BLOCK = 64

# token kinds in a tape
TOK_NULL = 0  # no token: covers zero output bytes
TOK_LIT = 1
TOK_MATCH = 2
TOK_RAW = 3  # a stored-block run: `b` holds the input byte offset

# lane phases of decode_regions
PH_HEADER = 0  # read BFINAL/BTYPE
PH_STORED = 1  # read LEN/NLEN, emit a raw-run token
PH_TABLE_META = 2  # read HLIT/HDIST/HCLEN
PH_CL_LENS = 3  # read one 3-bit code-length-code length a step
PH_CL_BUILD = 4  # build the code-length table
PH_CLEN = 5  # decode one code-length symbol a step
PH_BUILD = 6  # build the literal/length and distance tables
PH_SYMS = 7  # decode one literal or match a step
PH_DONE = 8
PH_BAD = 9

KIND_LIT = 0
KIND_MATCH = 1
KIND_EOB = 2
KIND_INVALID = 4

_CL_ORDER = np.array(
    [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15], np.int64
)

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
_REV7_NP = _rev_table(CL_BITS)

# fixed (static) trees, padded to the 320 lengths of a lane
_FIXED_LL_LENS = np.array([8] * 144 + [9] * 112 + [7] * 24 + [8] * 8 + [0] * 32, np.int64)
_FIXED_D_LENS = np.array([5] * 32 + [0] * 288, np.int64)


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


def _cl_symbol_fields():
    """(kind, aux, payload) int64 [19] of the code-length alphabet."""
    return (torch.zeros(19, dtype=torch.int64), torch.zeros(19, dtype=torch.int64),
            torch.arange(19, dtype=torch.int64))


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


def _words8(comp: torch.Tensor) -> torch.Tensor:
    """The little-endian 64-bit word at every byte offset of each row,
    int64 [B, L] (the top byte's bit 7 lands in the sign), reading zeros
    past the row's end."""
    L = comp.shape[1]
    b = torch.nn.functional.pad(comp.to(torch.int64), (0, 7))
    w = b[:, :L].clone()
    for k in range(1, 8):
        w |= b[:, k : k + L] << (8 * k)
    return w


def decode_regions_plain(comp, start_bits, end_bits, out_targets, max_steps: int):
    """Decode B byte-padded regions in lockstep, on comp's device: the
    plain version of the lockstep kernel (csrc/lockstep.cu), in torch ops.

    comp: uint8 [B, L], each lane's region starting at bit start_bits[b]
    and ending at end_bits[b]; out_targets[b] the expected output size
    (decoding stops once reached). Every row must end in a zero byte, as
    decompress_chunks' rows do (at least 8): the reference's reads past
    the row then read zeros, as here. Returns (tok_kind uint8 [B,
    max_steps], tok_a int32, tok_b int32, n_steps int, produced int32 [B],
    bad bool [B]): a = length or literal count, b = literal, distance or
    input byte offset by kind. The reference's `max_out` argument, which
    it does not use, is dropped.

    Each step, every lane advances one small step of its own state
    machine: a block header, a stored run (one TOK_RAW token),
    HLIT/HDIST/HCLEN, one code-length-code length, one code-length symbol,
    a table build, or one literal or length/distance pair; the phases run
    in the reference's order within a step. A step reads at most 42 bits
    past its start before the symbol phase and 48 past the symbol's
    start, inside the 57 bits a 64-bit word holds after a sub-byte shift,
    so it gathers one word at its start and one at its symbol. The table builds
    run only for the lanes that need them, and a section runs only when
    some lane can be in its phase: one host read a step (of the phases
    present and the lanes that may build next step: a code-length table
    when the next length is the last, lit/len and distance tables for a
    fixed header next or a code-length symbol that completes the lengths)
    decides both, and ends the loop at the reference's step count, the
    first after which every lane is done or bad. While every running lane
    decodes symbols, steps need no read: SYMBOL_BLOCK of them run as one
    block, each counting only while that still holds at its start, so the
    tapes and the step count stay the reference's.
    """
    B, L = comp.shape
    dev = comp.device
    if bool((comp[:, -1] != 0).any()):
        raise ValueError("each row of comp must end in a zero byte")
    i64 = torch.int64
    words = _words8(comp)
    ar19 = torch.arange(19, device=dev)
    ar320 = torch.arange(320, device=dev)
    ar10 = torch.arange(10, device=dev)
    cl_order = torch.from_numpy(_CL_ORDER).to(dev)
    rev7 = torch.from_numpy(_REV7_NP).to(dev)
    rev15 = torch.from_numpy(_REV15_NP).to(dev)
    cl_fields = _cl_symbol_fields()
    ll_fields = _ll_symbol_fields(320)
    d_fields = _d_symbol_fields(320)
    fixed_ll = torch.from_numpy(_FIXED_LL_LENS).to(dev)
    fixed_d = torch.from_numpy(_FIXED_D_LENS).to(dev)

    def z():
        return torch.zeros(B, dtype=i64, device=dev)

    phase = torch.full((B,), PH_HEADER, dtype=i64, device=dev)
    bitpos = start_bits.to(device=dev, dtype=i64)
    end = end_bits.to(device=dev, dtype=i64)
    target = out_targets.to(device=dev, dtype=i64)
    final_f, produced, hlit, hdist, hclen, cl_got, lens_have, prev_len = (z() for _ in range(8))
    cl_lens = torch.zeros((B, 19), dtype=i64, device=dev)
    lens_arr = torch.zeros((B, 320), dtype=i64, device=dev)
    cl_lut = torch.zeros((B, 1 << CL_BITS), dtype=i64, device=dev)
    ll_lut = torch.zeros((B, 1 << FLAT_BITS), dtype=i64, device=dev)
    d_lut = torch.zeros((B, 1 << FLAT_BITS), dtype=i64, device=dev)
    # time-major tapes: a step writes one contiguous row
    tk = torch.zeros((max_steps, B), dtype=torch.uint8, device=dev)
    ta = torch.zeros((max_steps, B), dtype=torch.int32, device=dev)
    tb = torch.zeros((max_steps, B), dtype=torch.int32, device=dev)

    def fetch(pos):
        """Bits from `pos` on (57 of them valid)."""
        return words.gather(1, (pos >> 3).clamp(max=L - 1)[:, None])[:, 0] >> (pos & 7)

    def clen_symbol(w, off):
        """The code-length symbol at bit `off` of window w: (kind, bits of
        its code, symbol, extra-bit count, repeat count)."""
        ce = cl_lut.gather(1, ((w >> off) & ((1 << CL_BITS) - 1))[:, None])[:, 0]
        cnb = (ce >> 16) & 0x3F
        csym = ce & 0xFFFF
        rep_bits = torch.where(csym == 16, 2, torch.where(csym == 17, 3,
                                                          torch.where(csym == 18, 7, 0)))
        rep_extra = (w >> (off + cnb)) & ((1 << rep_bits) - 1)
        rep_n = torch.where((csym == 16) | (csym == 17), 3 + rep_extra,
                            torch.where(csym == 18, 11 + rep_extra, 1))
        return ce >> 28, cnb, csym, rep_bits, rep_n

    def symbols(phase, bitpos, produced, final_f, col_kind, col_a, col_b):
        """PH_SYMS: one literal or length/distance pair a step."""
        in_sy = phase == PH_SYMS
        w1 = fetch(bitpos)
        e = ll_lut.gather(1, (w1 & 0x7FFF)[:, None])[:, 0]
        kind = e >> 28
        aux = (e >> 22) & 0x3F
        nb = (e >> 16) & 0x3F
        payload = e & 0xFFFF
        is_lit = in_sy & (kind == KIND_LIT)
        is_eob = in_sy & (kind == KIND_EOB)
        is_match = in_sy & (kind == KIND_MATCH)
        length = payload + ((w1 >> nb) & ((1 << aux) - 1))
        p2 = nb + aux
        de = d_lut.gather(1, ((w1 >> p2) & 0x7FFF)[:, None])[:, 0]
        daux = (de >> 22) & 0x3F
        dnb = (de >> 16) & 0x3F
        dist = (de & 0xFFFF) + ((w1 >> (p2 + dnb)) & ((1 << daux) - 1))
        s_bad = in_sy & ((kind == KIND_INVALID) | ((kind == KIND_MATCH)
                                                   & ((de >> 28) != KIND_MATCH)))
        good_match = is_match & ~s_bad
        col_kind = torch.where(is_lit, TOK_LIT, torch.where(good_match, TOK_MATCH, col_kind))
        col_a = torch.where(is_lit, 1, torch.where(is_match, length, col_a))
        col_b = torch.where(is_lit, payload, torch.where(is_match, dist, col_b))
        produced = torch.where(is_lit, produced + 1,
                               torch.where(good_match, produced + length, produced))
        bitpos = torch.where(is_lit | is_eob, bitpos + nb,
                             torch.where(good_match, bitpos + p2 + dnb + daux, bitpos))
        phase = torch.where(s_bad, PH_BAD, torch.where(
            is_eob, torch.where(final_f == 1, PH_DONE, PH_HEADER),
            torch.where((is_lit | is_match) & (produced >= target), PH_DONE, phase)))
        return phase, bitpos, produced, col_kind, col_a, col_b

    def exhausted(phase, bitpos, produced):
        """Input exhausted: done if the lane reached its target (a body may
        end at a block boundary with no BFINAL), else bad."""
        running = (phase != PH_DONE) & (phase != PH_BAD)
        return torch.where((bitpos > end) & running,
                           torch.where(produced >= target, PH_DONE, PH_BAD), phase)

    def region_end(phase, bitpos, produced):
        """A non-final body ends when its bits run out exactly at a block
        boundary."""
        at_hdr_end = (phase == PH_HEADER) & (bitpos + 3 > end)
        return torch.where(at_hdr_end & (produced >= target), PH_DONE, phase)

    def lanes(mask) -> torch.Tensor:
        return torch.from_numpy(np.flatnonzero(mask)).to(dev)

    # the symbol block's state, copied in before each block
    blk = {}

    def symbol_step():
        """One step of the symbol regime (every lane in PH_SYMS, done or
        bad): the step of the loop below with only its PH_SYMS section.
        It counts (writes its tape row, moves the state and the step
        index) only while the regime holds at its start, some lane runs
        and the step budget is not spent; otherwise it changes nothing."""
        ph, bp, pr, i_t = blk["phase"], blk["bitpos"], blk["produced"], blk["i"]
        ok = (ph >= PH_SYMS).all() & (ph == PH_SYMS).any() & (i_t < max_steps)
        zero = torch.zeros_like(ph)
        nph, nbp, npr, ck, ca, cb = symbols(exhausted(ph, bp, pr), bp, pr, blk["final_f"],
                                            zero, zero, zero)
        nph = region_end(nph, nbp, npr)
        row = i_t.clamp(max=max_steps - 1).view(1)
        for tape, col in ((tk, ck), (ta, ca), (tb, cb)):
            keep = tape.index_select(0, row)[0]
            tape.index_copy_(0, row, torch.where(ok, col.to(tape.dtype), keep)[None])
        ph.copy_(torch.where(ok, nph, ph))
        bp.copy_(torch.where(ok, nbp, bp))
        pr.copy_(torch.where(ok, npr, pr))
        i_t.add_(ok.to(i64))

    def symbol_block(i: int):
        """SYMBOL_BLOCK symbol steps from step i with no host read."""
        for name, t in (("phase", phase), ("bitpos", bitpos), ("produced", produced),
                        ("final_f", final_f)):
            if name in blk:
                blk[name].copy_(t)
            else:
                blk[name] = t.clone()
        blk.setdefault("i", torch.zeros((), dtype=i64, device=dev)).fill_(i)
        runs["symbol_blocks"] += 1
        for _ in range(SYMBOL_BLOCK):
            symbol_step()

    def look(w, clen_live: bool):
        """One host read: the phases present, the lanes that may build a
        code-length table next step, and those that may build the main
        tables."""
        clb = (phase == PH_CL_LENS) & (cl_got + 1 >= hclen)
        build = (phase == PH_HEADER) & (((w >> 1) & 3) == 1)
        if clen_live:
            _k, _nb, _s, _rb, rep_n = clen_symbol(w, 0)
            build |= (phase == PH_CLEN) & (lens_have + rep_n >= hlit + hdist)
        present = (phase[:, None] == ar10).any(dim=0)
        f = torch.cat([present, clb, build]).cpu().numpy()
        return f[:10], f[10 : 10 + B], f[10 + B :]

    w0 = fetch(bitpos)
    present, clb_next, build_next = look(w0, False)
    i = 0
    while i < max_steps and present[:PH_DONE].any():
        if not present[:PH_SYMS].any():
            # the symbol regime: no table build or header next
            symbol_block(i)
            phase, bitpos, produced = blk["phase"], blk["bitpos"], blk["produced"]
            i = int(blk["i"])
            w0 = fetch(bitpos)
            present, clb_next, build_next = look(w0, False)
            continue
        base = bitpos
        hdr_live = bool(present[PH_HEADER])
        clb_lanes = lanes(clb_next) if clb_next.any() else None
        build_lanes = lanes(build_next) if build_next.any() else None
        phase = exhausted(phase, bitpos, produced)
        col_kind = z()
        col_a = z()
        col_b = z()

        if hdr_live:
            # PH_HEADER: 3 bits
            in_hdr = phase == PH_HEADER
            h_btype = (w0 >> 1) & 3
            nxt = torch.where(h_btype == 0, PH_STORED, torch.where(
                h_btype == 1, PH_BUILD, torch.where(h_btype == 2, PH_TABLE_META, PH_BAD)))
            final_f = torch.where(in_hdr, w0 & 1, final_f)
            bitpos = torch.where(in_hdr, bitpos + 3, bitpos)
            # hclen == -1 marks a fixed block
            hclen = torch.where(in_hdr & (h_btype == 1), -1, hclen)
            phase = torch.where(in_hdr, nxt, phase)

            # PH_STORED: align, LEN/NLEN, one raw-run token
            in_st = phase == PH_STORED
            aligned = (bitpos + 7) & ~7
            lens32 = w0 >> (aligned - base)
            st_len = lens32 & 0xFFFF
            st_ok = st_len == (~(lens32 >> 16) & 0xFFFF)
            st = in_st & st_ok
            col_kind = torch.where(st & (st_len > 0), TOK_RAW, col_kind)
            col_a = torch.where(st, st_len, col_a)
            col_b = torch.where(st, (aligned + 32) >> 3, col_b)
            produced = torch.where(st, produced + st_len, produced)
            bitpos = torch.where(st, aligned + 32 + 8 * st_len, bitpos)
            phase = torch.where(in_st, torch.where(~st_ok, PH_BAD, torch.where(
                (final_f == 1) | (produced >= target), PH_DONE, PH_HEADER)), phase)

            # PH_TABLE_META: 14 bits
            in_tm = phase == PH_TABLE_META
            meta = w0 >> (bitpos - base)
            hlit = torch.where(in_tm, (meta & 31) + 257, hlit)
            hdist = torch.where(in_tm, ((meta >> 5) & 31) + 1, hdist)
            hclen = torch.where(in_tm, ((meta >> 10) & 15) + 4, hclen)
            cl_got = torch.where(in_tm, 0, cl_got)
            cl_lens = torch.where(in_tm[:, None], 0, cl_lens)
            lens_arr = torch.where(in_tm[:, None], 0, lens_arr)
            lens_have = torch.where(in_tm, 0, lens_have)
            bitpos = torch.where(in_tm, bitpos + 14, bitpos)
            phase = torch.where(in_tm, torch.where(hlit > 286, PH_BAD, PH_CL_LENS), phase)

        if hdr_live or present[PH_CL_LENS]:
            # PH_CL_LENS: one 3-bit length a step
            in_cl = phase == PH_CL_LENS
            v3 = (w0 >> (bitpos - base)) & 7
            slot = cl_order[cl_got.clamp(0, 18)]
            cl_lens = torch.where(in_cl[:, None],
                                  cl_lens + (ar19 == slot[:, None]) * v3[:, None], cl_lens)
            bitpos = torch.where(in_cl, bitpos + 3, bitpos)
            cl_got = torch.where(in_cl, cl_got + 1, cl_got)
            phase = torch.where(in_cl & (cl_got >= hclen), PH_CL_BUILD, phase)

        clen_live = bool(present[PH_CLEN]) or clb_lanes is not None
        if clb_lanes is not None:
            # PH_CL_BUILD: the 2^7 code-length table of the lanes that need it
            need = phase == PH_CL_BUILD
            built = _build_flat_lut(cl_lens[clb_lanes], *cl_fields, rev7, CL_BITS)
            cl_lut[clb_lanes] = torch.where(need[clb_lanes, None], built, cl_lut[clb_lanes])
            phase = torch.where(need, PH_CLEN, phase)

        if clen_live:
            # PH_CLEN: one code-length symbol a step
            in_cle = phase == PH_CLEN
            ckind, cnb, csym, rep_bits, rep_n = clen_symbol(w0, bitpos - base)
            rep_val = torch.where(csym < 16, csym, torch.where(csym == 16, prev_len, 0))
            c_bad = in_cle & ((ckind == KIND_INVALID) | ((csym == 16) & (lens_have == 0))
                              | (lens_have + rep_n > hlit + hdist))
            in_range = (ar320 >= lens_have[:, None]) & (ar320 < (lens_have + rep_n)[:, None])
            lens_arr = torch.where(in_cle[:, None] & in_range, rep_val[:, None], lens_arr)
            ok = in_cle & ~c_bad
            lens_have = torch.where(ok, lens_have + rep_n, lens_have)
            prev_len = torch.where(ok, rep_val, prev_len)
            bitpos = torch.where(ok, bitpos + cnb + rep_bits, bitpos)
            cl_done = ok & (lens_have >= hlit + hdist)
            missing_eob = cl_done & (lens_arr[:, 256] == 0)
            phase = torch.where(c_bad | missing_eob, PH_BAD,
                                torch.where(cl_done, PH_BUILD, phase))

        if build_lanes is not None:
            # PH_BUILD: the lit/len and distance tables (fixed or dynamic)
            need = phase == PH_BUILD
            sel = build_lanes
            fixed = (hclen[sel] == -1)[:, None]
            la = lens_arr[sel]
            hl = hlit[sel, None]
            ll_lens = torch.where(fixed, fixed_ll, torch.where(ar320 < hl, la, 0))
            d_lens = la.gather(1, (hl + ar320).clamp(max=319))
            d_lens = torch.where(fixed, fixed_d, torch.where(ar320 < hdist[sel, None], d_lens, 0))
            ll_built = _build_flat_lut(ll_lens, *ll_fields, rev15, FLAT_BITS)
            d_built = _build_flat_lut(d_lens, *d_fields, rev15, FLAT_BITS)
            keep = need[sel, None]
            ll_lut[sel] = torch.where(keep, ll_built, ll_lut[sel])
            d_lut[sel] = torch.where(keep, d_built, d_lut[sel])
            phase = torch.where(need, PH_SYMS, phase)

        if present[PH_SYMS] or build_lanes is not None:
            phase, bitpos, produced, col_kind, col_a, col_b = symbols(
                phase, bitpos, produced, final_f, col_kind, col_a, col_b)

        phase = region_end(phase, bitpos, produced)

        tk[i] = col_kind
        ta[i] = col_a
        tb[i] = col_b
        i += 1
        w0 = fetch(bitpos)
        present, clb_next, build_next = look(w0, clen_live)

    bad = phase == PH_BAD
    runs["decode_regions"] += 1
    runs["steps"] += i
    return (tk.T.contiguous(), ta.T.contiguous(), tb.T.contiguous(), i,
            produced.to(torch.int32), bad)


def _lib():
    fn = _device.library("lockstep").zrs_lockstep
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, I, ctypes.c_longlong, P, P, P, I, P, P, P, P, P, P, P, P]
        fn.restype = ctypes.c_int
    return fn


def decode_regions_cuda(comp, start_bits, end_bits, out_targets, max_steps: int):
    """Launch the lockstep kernel over CUDA operands: comp uint8 [B, L],
    start_bits, end_bits and out_targets [B]. One block a lane runs the
    lane to its end; the lanes' step counts come back in one host read
    with the check that every row ends in a zero byte. Returns what
    `decode_regions_plain` returns on the same inputs."""
    _device.require_cuda("lockstep", comp, start_bits, end_bits, out_targets)
    if comp.dtype != torch.uint8 or comp.dim() != 2:
        raise ValueError(
            f"lockstep: comp must be uint8 [B, L], got {comp.dtype} {tuple(comp.shape)}")
    comp = comp.contiguous()
    B, L = comp.shape
    dev = comp.device
    sb, eb, tg = (t.to(torch.int32).contiguous() for t in (start_bits, end_bits, out_targets))
    tk = torch.zeros((B, max_steps), dtype=torch.uint8, device=dev)
    ta = torch.zeros((B, max_steps), dtype=torch.int32, device=dev)
    tb = torch.zeros((B, max_steps), dtype=torch.int32, device=dev)
    produced = torch.zeros(B, dtype=torch.int32, device=dev)
    bad = torch.zeros(B, dtype=torch.uint8, device=dev)
    counts = torch.zeros(B, dtype=torch.int32, device=dev)
    # each lane's literal/length and distance tables
    scratch = torch.empty((B, 2 << FLAT_BITS), dtype=torch.int32, device=dev)
    if B:
        rc = _lib()(
            _device.ptr(comp), B, L, _device.ptr(sb), _device.ptr(eb), _device.ptr(tg),
            max_steps, _device.ptr(scratch), _device.ptr(tk), _device.ptr(ta), _device.ptr(tb),
            _device.ptr(produced), _device.ptr(bad), _device.ptr(counts),
            _device.stream_of(comp),
        )
        _device.check(rc, "lockstep")
        launches["lockstep"] += 1
        n_steps, last_nonzero = torch.stack(
            [counts.max(), (comp[:, -1] != 0).any().to(torch.int32)]).tolist()
        if last_nonzero:
            raise ValueError("each row of comp must end in a zero byte")
    else:
        n_steps = 0
    runs["decode_regions"] += 1
    runs["steps"] += n_steps
    return tk, ta, tb, n_steps, produced, bad.bool()


def decode_regions(comp, start_bits, end_bits, out_targets, max_steps: int):
    """Decode B byte-padded regions in lockstep: the plain version for a
    CPU tensor, the kernel for a CUDA one (the contract is
    `decode_regions_plain`'s)."""
    fn = decode_regions_plain if comp.device.type == "cpu" else decode_regions_cuda
    return fn(comp, start_bits, end_bits, out_targets, max_steps)


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
