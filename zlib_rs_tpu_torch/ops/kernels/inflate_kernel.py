"""K6: the sequential RFC 1951 inflate, one raw-deflate stream per block of
a decode warp and a copy warp (csrc/inflate.cu), with its plain version
and the wrapper logic.

The port of zlib_rs_tpu/ops/pallas/inflate_kernel.py (`decode_streams_pallas`,
body `_kernel_body`, and `pack_streams_words`). Each stream decodes whole:
stored, fixed and dynamic blocks, multi-block bodies, table builds inside
the decode, an optional right-aligned history window pre-copied in front
of the output, a start bit anywhere in the first word, and a stop mode in
which `out_len` is a checkpoint target (stop at the first block boundary
at or after it) rather than an exact length.

Tables are the reference's two-level layout (9-bit litlen root, 852
entries; 6-bit distance root, 592; 7-bit code-length table, 128). The
reference's `one_level` choice of flat 2^15-entry tables is a TPU SMEM
budget choice; the outputs are the same either way, and the port keeps
the two-level tables, which the decode warp builds in shared memory.

Contract, on any input: `produced`, `bad`, `end_bit`, `fin_seen` and the
output bytes [0, min(produced, max_out)). Every read of the compressed
words is clamped to [0, W - 1] (the reference's dynamic reads clamp the
same way), and every output store out of range lands in the slack word.
A truthy `bad` means "fall back to an exact engine"; a clean `bad` is not
proof of correct bytes (a flipped byte can decode to other bytes), so the
container checksum stays the last oracle.

The plain version is the kernel's control flow as a scalar Python loop
per stream over the words as Python ints: the algorithm is one serial
bit cursor per stream, so it has no lane-parallel torch form. The wrapper
runs it for a CPU tensor and launches the kernel for a CUDA tensor;
nothing falls back. 32-bit words cross the kernel boundary as int32
bit-views.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ... import _device

# launches of the CUDA kernel; the plain version does not count
launches = {"inflate": 0}

# the kernel's dynamic shared memory, a 64 KiB ring of output bytes
# (csrc/inflate.cu); the launch asks for it
SMEM_BYTES = 1 << 16

# table entry: kind (3b @28) | extra (6b @22) | nbits (6b @16) | val (16b @0)
KIND_LIT, KIND_MATCH, KIND_EOB, KIND_SUB, KIND_INVALID = 0, 1, 2, 3, 7
LL_ROOT, D_ROOT, CL_ROOT = 9, 6, 7
LL_CAP, D_CAP, CL_CAP = 852, 592, 128
CL_ORDER = (16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15)
META_WORDS = 8  # start_bit, comp_bits, out_len, max_out, win_words, stop, 0, 0

_M32 = 0xFFFFFFFF


def pack_streams_words(payloads):
    """Pack byte strings into uint32[B, W] LE words with >= 2 words of zero
    tail padding. Returns (words, comp_bits int32[B]) as numpy."""
    B = len(payloads)
    maxlen = max((len(p) for p in payloads), default=0)
    W = (maxlen + 4) // 4 + 2
    arr = np.zeros((B, W * 4), np.uint8)
    bits = np.zeros((B,), np.int32)
    for i, p in enumerate(payloads):
        arr[i, : len(p)] = np.frombuffer(p, np.uint8)
        bits[i] = len(p) * 8
    return arr.view("<u4"), bits


def _entry(kind, extra, nbits, val):
    return (kind << 28) | (extra << 22) | (nbits << 16) | val


def _len_fields(sym):
    """(kind, extra, val) of a litlen symbol."""
    if sym < 256:
        return KIND_LIT, 0, sym
    if sym == 256:
        return KIND_EOB, 0, 0
    c = sym - 257
    e = max(0, (c - 4) >> 2)
    base = c + 3 if c < 4 else 3 + ((4 + (c & 3)) << e)
    if c == 28:
        return KIND_MATCH, 0, 258
    return (KIND_MATCH if c < 29 else KIND_INVALID), e, base


def _dist_fields(sym):
    e = max(0, (sym >> 1) - 1)
    base = sym + 1 if sym < 2 else 1 + ((2 + (sym & 1)) << e)
    if sym < 30:
        return KIND_MATCH, e, base
    return KIND_INVALID, e, 0


def _sym_fields(kind_of, sym):
    if kind_of == 0:
        return KIND_LIT, 0, sym
    return _len_fields(sym) if kind_of == 1 else _dist_fields(sym)


def _inflate_lane(words, meta, win_words, ow):
    """One stream, as the kernel runs it. `words` and `win_words` are lists
    of unsigned 32-bit ints, `meta` the stream's eight meta ints. Returns
    (out words list of length ow, produced, bad, end_bit, fin_seen)."""
    start_bit, comp_bits, out_len, max_out, nwin, stop = meta[:6]
    W = len(words)
    top = W - 1
    dead = ow - 1
    out = [0] * ow
    out[:nwin] = win_words[:nwin]
    lltab = [0] * LL_CAP
    dtab = [0] * D_CAP
    cltab = [0] * CL_CAP
    lens = [0] * 320
    work = [0] * 320
    cnt = [0] * 16
    offs = [0] * 16

    def word(i):
        return words[0 if i < 0 else top if i > top else i]

    def peek32(bp):
        wi = bp >> 5
        sh = bp & 31
        if sh:
            return ((word(wi) >> sh) | (word(wi + 1) << (32 - sh))) & _M32
        return word(wi)

    def src4(p, dist):
        s0 = p - dist
        swi = min(max(s0 >> 2, 0), dead - 1)
        ssh = (s0 & 3) << 3
        v = ((out[swi] >> ssh) | (out[swi + 1] << (32 - ssh))) & _M32 if ssh else out[swi]
        if dist == 1:
            return ((v & 0xFF) * 0x01010101) & _M32
        if dist == 2:
            return ((v & 0xFFFF) * 0x00010001) & _M32
        if dist == 3:
            return (v & 0xFFFFFF) | ((v & 0xFF) << 24)
        return v

    def masked_store(p, nby, v):
        if nby == 0:
            return  # the reference rewrites the slack word with itself
        sh = (p & 3) << 3
        m = ((_M32 >> ((4 - nby) << 3)) << sh) & _M32
        wi = min(p >> 2, dead)
        out[wi] = (out[wi] & ~m & _M32) | ((v << sh) & m)

    def copy_match(p, length, dist):
        head = min((4 - (p & 3)) & 3, length)
        masked_store(p, head, src4(p, dist))
        nwords = (length - head) >> 2
        wbase = (p + head) >> 2
        for k in range(nwords):
            out[wbase + k] = src4((wbase + k) << 2, dist)
        tail0 = p + head + (nwords << 2)
        masked_store(tail0, p + length - tail0, src4(tail0, dist))

    def build_table(tab, cap, nsyms, lens_base, root_in, kind_of):
        for i in range(16):
            cnt[i] = 0
        for i in range(nsyms):
            ln = lens[lens_base + i]
            if ln > 0:
                cnt[ln] += 1
        maxlen = 0
        for i in range(1, 16):
            if cnt[i] > 0:
                maxlen = i
        minlen = 15
        for j in range(15, 0, -1):
            if cnt[j] > 0:
                minlen = j
        root = min(max(root_in, minlen), max(maxlen, 1))
        left, ncodes = 1, 0
        for i in range(1, 16):
            left = left * 2 - cnt[i]
            ncodes += cnt[i]
        bad = left < 0 or (left > 0 and not (kind_of == 2 and ncodes <= 1))
        bad = bad or maxlen == 0
        offs[1] = 0
        for i in range(2, 16):
            offs[i] = offs[i - 1] + cnt[i - 1]
        for i in range(nsyms):
            ln = lens[lens_base + i]
            if ln > 0:
                work[offs[ln]] = i
                offs[ln] += 1
        inv = _entry(KIND_INVALID, 0, root, 0)
        for i in range(cap):
            tab[i] = inv
        rmask = (1 << root) - 1
        huff, low, drop, curr, sub_off, used, b = 0, -1, 0, root, 0, 1 << root, bad
        for k in range(ncodes):
            sym = work[k]
            ln = lens[lens_base + sym]
            if ln > root and (huff & rmask) != low:
                drop = root
                c = ln - drop
                lft = 1 << c
                while lft > 0 and c + drop < maxlen:
                    lft -= cnt[c + drop]
                    if lft > 0 and c + drop < maxlen:
                        c += 1
                        lft *= 2
                curr = c
                sub_off = used
                used += 1 << c
                low = huff & rmask
                b = b or used > cap
                if not b:
                    tab[low] = _entry(KIND_SUB, c, root, sub_off)
            kind, extra, val = _sym_fields(kind_of, sym)
            ent = _entry(kind, extra, ln, val)
            base = sub_off if drop > 0 else 0
            idx = huff >> drop
            step = 1 << (ln - drop)
            f = 1 << (curr if drop > 0 else root)
            while f > 0:
                f -= step
                slot = base + idx + f
                b = b or slot >= cap or slot < 0
                if not b:
                    tab[slot] = ent
            cnt[ln] -= 1
            incr = 1 << (ln - 1)
            while huff & incr:
                incr >>= 1
            huff = (huff & (incr - 1)) + incr if incr else 0
        return root, b

    def stored_block(bp, op, bad):
        bp = (bp + 7) & ~7
        w = peek32(bp)
        ln = w & 0xFFFF
        nln = w >> 16
        bp += 32
        bad = bad or (ln ^ 0xFFFF) != nln
        bad = bad or bp + ln * 8 > comp_bits + 32
        bad = bad or op + ln > max_out
        if bad:
            return bp, op, bad

        def copy_byte(j):
            v = peek32(bp + (j << 3)) & 0xFF
            pos = op + j
            sh = (pos & 3) << 3
            out[pos >> 2] = (out[pos >> 2] & ~(0xFF << sh) & _M32) | (v << sh)

        head = min((4 - (op & 3)) & 3, ln)
        for j in range(head):
            copy_byte(j)
        nwords = (ln - head) >> 2
        wbase = (op + head) >> 2
        s0 = (bp >> 3) + head
        swi = s0 >> 2
        ssh = (s0 & 3) << 3
        for k in range(nwords):
            w0 = word(swi + k)
            out[wbase + k] = ((w0 >> ssh) | (word(swi + k + 1) << (32 - ssh))) & _M32 if ssh else w0
        for j in range(head + (nwords << 2), ln):
            copy_byte(j)
        return bp + (ln << 3), op + ln, bad

    def fixed_lens():
        for i in range(288):
            lens[i] = 8 if i < 144 else 9 if i < 256 else 7 if i < 280 else 8
        for i in range(32):
            lens[288 + i] = 5

    def dynamic_header(bp, bad):
        w = peek32(bp)
        nlen = (w & 31) + 257
        ndist = ((w >> 5) & 31) + 1
        hclen = ((w >> 10) & 15) + 4
        bp += 14
        bad = bad or nlen > 286 or ndist > 30
        for i in range(19):
            lens[i] = 0
        for i in range(hclen):
            lens[CL_ORDER[i]] = peek32(bp) & 7
            bp += 3
        clroot, clbad = build_table(cltab, CL_CAP, 19, 0, CL_ROOT, 0)
        bad = bad or clbad
        cl_mask = (1 << clroot) - 1
        total = nlen + ndist
        i, prev = 0, -1
        while i < total and not bad:
            e = cltab[peek32(bp) & cl_mask]
            sym = e & 0xFFFF
            bad = bad or (e >> 28) == KIND_INVALID
            bp += (e >> 16) & 0x3F
            w2 = peek32(bp)
            if sym < 16:
                lens[i] = sym
                i += 1
                prev = sym
                continue
            ebits = 2 if sym == 16 else 3 if sym == 17 else 7
            r = (w2 & ((1 << ebits) - 1)) + (11 if sym == 18 else 3)
            v = prev if sym == 16 else 0
            bad = bad or (sym == 16 and i == 0) or i + r > total
            if not bad:
                for j in range(r):
                    if i + j < total:
                        lens[i + j] = v
            i += r
            bp += ebits
            prev = v
        bad = bad or bp > comp_bits + 32
        for j in range(31, -1, -1):
            if j < ndist:
                lens[288 + j] = lens[nlen + j]
        bad = bad or lens[256] == 0
        return bp, nlen, ndist, bad

    def coded_block(bp, op, bad, nlen, ndist):
        ll_root, b1 = build_table(lltab, LL_CAP, nlen, 0, LL_ROOT, 1)
        d_root, b2 = build_table(dtab, D_CAP, ndist, 288, D_ROOT, 2)
        bad = bad or b1 or b2
        ll_mask = (1 << ll_root) - 1
        d_mask = (1 << d_root) - 1

        def lookup(tab, w, mask, root):
            i0 = w & mask
            e0 = tab[i0]
            if (e0 >> 28) == KIND_SUB:
                return tab[(e0 & 0xFFFF) + ((w >> root) & ((1 << ((e0 >> 22) & 0x3F)) - 1))]
            return e0

        def peek_sym(bp):
            w = peek32(bp)
            return w, lookup(lltab, w, ll_mask, ll_root)

        oword = out[min(op >> 2, dead)] & ((1 << ((op & 3) << 3)) - 1)
        eob = False
        while not (bad or eob) and bp <= comp_bits:
            w, e = peek_sym(bp)
            # the literal sprint: one literal, then a second if the next
            # code is one too; stores past the row land in the slack word
            while (e >> 28) == KIND_LIT and bp <= comp_bits:
                ow2 = oword | ((e & 0xFF) << ((op & 3) << 3))
                out[min(op >> 2, dead)] = ow2
                oword = 0 if (op & 3) == 3 else ow2
                bp += (e >> 16) & 0x3F
                op += 1
                w, e = peek_sym(bp)
                if (e >> 28) == KIND_LIT and bp <= comp_bits:
                    ow3 = oword | ((e & 0xFF) << ((op & 3) << 3))
                    out[min(op >> 2, dead)] = ow3
                    oword = 0 if (op & 3) == 3 else ow3
                    bp += (e >> 16) & 0x3F
                    op += 1
                    w, e = peek_sym(bp)
                else:
                    out[dead] = oword
            bad = bad or op > max_out
            exhausted = bp > comp_bits
            kind = e >> 28
            nb = (e >> 16) & 0x3F
            is_eob = kind == KIND_EOB and not exhausted
            is_match = kind == KIND_MATCH and not exhausted
            bad = bad or (not exhausted and not (is_eob or is_match))
            if is_eob:
                bp += nb
                eob = True
            if is_match:
                lext = (e >> 22) & 0x3F
                length = (e & 0xFFFF) + ((w >> nb) & ((1 << lext) - 1))
                bp += nb + lext
                w2 = peek32(bp)
                de = lookup(dtab, w2, d_mask, d_root)
                bad = bad or (de >> 28) != KIND_MATCH
                dnb = (de >> 16) & 0x3F
                dext = (de >> 22) & 0x3F
                dist = (de & 0xFFFF) + ((w2 >> dnb) & ((1 << dext) - 1))
                bp += dnb + dext
                bad = bad or dist > op or op + length > max_out or dist < 1
                if not bad:
                    copy_match(op, length, dist)
                    op += length
                oword = out[min(op >> 2, dead)] & ((1 << ((op & 3) << 3)) - 1)
        return bp, op, bad

    bp, op, bad, done, fin_seen = start_bit, nwin << 2, False, False, False
    while not (bad or done):
        w = peek32(bp)
        final = w & 1
        btype = (w >> 1) & 3
        bp += 3
        bad = btype == 3 or bp > comp_bits
        if btype == 0:
            bp, op, bad = stored_block(bp, op, bad)
        elif btype == 1:
            fixed_lens()
            bp, op, bad = coded_block(bp, op, bad, 288, 32)
        else:  # 2, and 3 parses as 2 with bad already set
            bp, nlen, ndist, bad = dynamic_header(bp, bad)
            if not bad:
                bp, op, bad = coded_block(bp, op, bad, nlen, ndist)
        done = final > 0 or (out_len >= 0 and op >= out_len) or bp >= comp_bits
        fin_seen = fin_seen or (final > 0 and not bad)
    bad = bad or (out_len >= 0 and op != out_len and not stop)
    return out, op - (nwin << 2), bad, bp, fin_seen


# ---------------------------------------------------------------------------
# the wrapper logic shared by the plain version and the kernel
# ---------------------------------------------------------------------------


def _prepare(words, start_bits, comp_bits, out_lens, max_out: int, win, stop: bool):
    """Checks and the kernel's operands: (meta int32 [B, 8], win words
    int32 [B, WW], ow output words per stream, wpad)."""
    if words.dim() != 2 or words.dtype != torch.int32:
        raise ValueError("inflate: words must be int32 [B, W] (uint32 bit-views)")
    B, W = words.shape
    if W < 2:
        raise ValueError("inflate: words need >= 2 zero tail words")
    for name, t in (("start_bits", start_bits), ("comp_bits", comp_bits), ("out_lens", out_lens)):
        if t.shape != (B,):
            raise ValueError(f"inflate: {name} must be [B]")
    if max_out < 0:
        raise ValueError("inflate: max_out must be >= 0")
    wpad = 0 if win is None else win.shape[1]
    if wpad % 4:
        raise ValueError("win buffer length must be a multiple of 4")
    if win is not None and (win.dtype != torch.uint8 or win.shape[0] != B):
        raise ValueError("inflate: win must be uint8 [B, WPAD]")
    dev = words.device
    ow = (max_out + wpad + 3) // 4 + 1  # +1 slack word absorbing dead writes
    ww = max(1, wpad // 4)
    if wpad == 0:
        win_w = torch.zeros((B, ww), dtype=torch.int32, device=dev)
    else:
        win_w = win.contiguous().view(torch.int32).reshape(B, ww)
    ol = out_lens.to(device=dev, dtype=torch.int32)
    meta = torch.zeros((B, META_WORDS), dtype=torch.int32, device=dev)
    meta[:, 0] = start_bits.to(device=dev, dtype=torch.int32)
    meta[:, 1] = comp_bits.to(device=dev, dtype=torch.int32)
    meta[:, 2] = torch.where(ol >= 0, ol + wpad, ol)
    meta[:, 3] = max_out + wpad
    meta[:, 4] = wpad // 4
    meta[:, 5] = 1 if stop else 0
    return meta, win_w, ow, wpad


def _finish(out_w, st, wpad: int, max_out: int, stop: bool):
    """LE32 words to bytes, the window head dropped; the status columns."""
    B = out_w.shape[0]
    out_b = out_w.contiguous().view(torch.uint8).reshape(B, -1)[:, wpad : wpad + max_out]
    produced = st[:, 0]
    bad = st[:, 1] > 0
    end_bit = st[:, 2]
    if stop:
        return out_b, produced, bad, end_bit, st[:, 3] > 0
    return out_b, produced, bad, end_bit


def decode_streams_plain(words, start_bits, comp_bits, out_lens, *, max_out: int,
                         win=None, stop_at_target: bool = False):
    """The plain version: each stream through `_inflate_lane` on the host.
    Same outputs as `decode_streams_cuda`, on the inputs' device."""
    meta, win_w, ow, wpad = _prepare(
        words, start_bits, comp_bits, out_lens, max_out, win, stop_at_target
    )
    words_np = words.cpu().numpy().view(np.uint32)
    meta_np = meta.cpu().numpy()
    win_np = win_w.cpu().numpy().view(np.uint32)
    B = words_np.shape[0]
    out = np.zeros((B, ow), np.uint32)
    st = np.zeros((B, 4), np.int32)
    for b in range(B):
        o, produced, bad, end_bit, fin = _inflate_lane(
            words_np[b].tolist(), meta_np[b].tolist(), win_np[b].tolist(), ow
        )
        out[b] = o
        st[b] = (produced, int(bad), end_bit, int(fin))
    dev = words.device
    return _finish(torch.from_numpy(out.view(np.int32)).to(dev), torch.from_numpy(st).to(dev),
                   wpad, max_out, stop_at_target)


def _lib():
    fn = _device.library("inflate").zrs_inflate
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, I, I, P, P, I, P, I, P, I, P]
        fn.restype = ctypes.c_int
    return fn


def decode_streams_cuda(words, start_bits, comp_bits, out_lens, *, max_out: int,
                        win=None, stop_at_target: bool = False):
    """Launch K6 over CUDA operands: words int32 [B, W] (LE32 bit-views,
    >= 2 zero tail words), start_bits, comp_bits and out_lens int32 [B]
    (out_len < 0: decode to BFINAL), win uint8 [B, WPAD] or None. One block
    of two warps a stream, SMEM_BYTES of dynamic shared memory."""
    tensors = [words, start_bits, comp_bits, out_lens] + ([] if win is None else [win])
    _device.require_cuda("inflate", *tensors)
    meta, win_w, ow, wpad = _prepare(
        words, start_bits, comp_bits, out_lens, max_out, win, stop_at_target
    )
    words = words.contiguous()
    B, W = words.shape
    dev = words.device
    out_w = torch.zeros((B, ow), dtype=torch.int32, device=dev)
    st = torch.empty((B, 4), dtype=torch.int32, device=dev)
    if B:
        rc = _lib()(
            _device.ptr(words), B, W, _device.ptr(meta), _device.ptr(win_w),
            win_w.shape[1], _device.ptr(out_w), ow, _device.ptr(st), SMEM_BYTES,
            _device.stream_of(words),
        )
        _device.check(rc, "inflate")
        launches["inflate"] += 1
    return _finish(out_w, st, wpad, max_out, stop_at_target)


def decode_streams(words, start_bits, comp_bits, out_lens, *, max_out: int,
                   win=None, stop_at_target: bool = False):
    """Decode B raw-deflate streams: the plain version for a CPU tensor,
    the kernel for a CUDA one. Returns (out uint8 [B, max_out], produced
    int32 [B], bad bool [B], end_bit int32 [B]), plus fin_seen bool [B]
    when `stop_at_target`. `win` (uint8 [B, WPAD], WPAD % 4 == 0) holds
    each stream's history right-aligned; outputs and `produced` cover the
    stream's own bytes only."""
    fn = decode_streams_plain if words.device.type == "cpu" else decode_streams_cuda
    return fn(words, start_bits, comp_bits, out_lens, max_out=max_out, win=win,
              stop_at_target=stop_at_target)
