"""K6, the sequential inflate kernel: the port's plain version
(`device="cpu"`) against the JAX package's `decode_streams_pallas` in
interpret mode, with both of its table layouts (`one_level` True and
False), lane by lane: `produced`, `bad`, `end_bit`, `fin_seen` and the
output bytes [0, min(produced, max_out)). Then `decode_chunks_kernel` and
the K6 route of `decompress_parallel` against the JAX package's.

Lanes are batched into two shapes (each shape costs the JAX side one
interpret-mode compile): clean and corrupt streams without a window, and
window-primed, sub-byte-start and stop-at-target streams."""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zlib_rs_tpu.parallel.pipeline as jp
import zlib_rs_tpu.parallel.swarm_inflate as JS
from zlib_rs_tpu.ops.pallas.inflate_kernel import decode_streams_pallas
import zlib_rs_tpu_torch as zt
from zlib_rs_tpu_torch.ops.kernels import inflate_kernel as IK
from zlib_rs_tpu_torch.parallel import pipeline as tp
from zlib_rs_tpu_torch.parallel import swarm_inflate as TS

# the test workers share the cores, and an oversubscribed OpenMP pool spin-waits
torch.set_num_threads(1)

_BASH = open("/bin/bash", "rb").read()
TEXT = b"".join(b"line %d of a text with repeats, words and numbers %d\n" % (i, i * i % 977)
                for i in range(800))
MAX_OUT = 32768


def _raw(data, level=6, strategy=zlib.Z_DEFAULT_STRATEGY, mem=8, zdict=None):
    kw = {} if zdict is None else {"zdict": zdict}
    c = zlib.compressobj(level, zlib.DEFLATED, -15, mem, strategy, **kw)
    return c.compress(data) + c.flush()


def _inflate(stream):
    """stdlib raw inflate; a chunk body ends in a sync flush, not BFINAL."""
    return zlib.decompressobj(-15).decompress(stream)


def _flip(b, i):
    b = bytearray(b)
    b[i] ^= 0xFF
    return bytes(b)


@pytest.fixture(scope="module")
def stored_chunk_stream():
    """A three-chunk input whose middle chunk is random bytes (a stored
    chunk, no seeds), indexed by the port and by the JAX kernel engine."""
    rng = np.random.default_rng(12)
    data = _BASH[:32_768] + rng.integers(0, 256, 32_768, dtype=np.uint8).tobytes() + TEXT[:10_000]
    mp = pytest.MonkeyPatch()
    mp.setenv("ZRS_TPU_KERNEL", "1")
    out, index = zt.compress_parallel(data, 6, return_index=True, device="cpu")
    ref, ref_index = jp.compress_parallel(data, 6, return_index=True)
    mp.undo()
    assert [s is None for s in index.seeds] == [False, True, False]
    assert [s is None for s in ref_index.seeds] == [False, True, False]
    return dict(data=data, port=(out, index), jax=(ref, ref_index))


def _lanes_plain(stored_chunk_stream):
    """(name, stream, out_len, clean) lanes of the window-less batch."""
    out, index = stored_chunk_stream["port"]
    ref, ref_index = stored_chunk_stream["jax"]
    bodies = [out[o : o + n] for o, n, _ in index]
    sizes = [s for _, _, s in index]
    jax_body = ref[ref_index[2][0] : ref_index[2][0] + ref_index[2][1]]
    multi = zlib.compressobj(6, zlib.DEFLATED, -15)
    full_flush = (multi.compress(TEXT[:9000]) + multi.flush(zlib.Z_FULL_FLUSH)
                  + multi.compress(_BASH[:9000]) + multi.flush())
    prime = _BASH[60_000:70_000]
    primed = _raw(_BASH[70_000:78_000], zdict=prime)
    level6 = _raw(_BASH[10_000:40_000])
    stored = _raw(TEXT[:20_000], level=0)
    return [
        ("port_chunk0", bodies[0], sizes[0], True),
        ("port_stored_chunk", bodies[1], sizes[1], True),
        ("port_chunk2", bodies[2], sizes[2], True),
        ("jax_chunk2", jax_body, ref_index[2][2], True),
        ("level0", stored, 20_000, True),
        ("level1", _raw(_BASH[:30_000], level=1), 30_000, True),
        ("level6", level6, 30_000, True),
        ("level9", _raw(TEXT[:25_000], level=9), 25_000, True),
        ("fixed", _raw(TEXT[:12_000], strategy=zlib.Z_FIXED), 12_000, True),
        ("empty", _raw(b""), 0, True),
        ("full_flush", full_flush, 18_000, True),
        ("to_bfinal", _raw(TEXT[:5_000]), -1, True),
        ("small_blocks", _raw(_BASH[:20_000], mem=1), 20_000, True),
        ("flip_mid", _flip(level6, len(level6) // 2), 30_000, False),
        ("flip_header", _flip(level6, 1), 30_000, False),
        ("truncated", level6[: len(level6) // 2], 30_000, False),
        ("btype3", b"\x07" + level6[1:200], 30_000, False),
        ("bad_nlen", _flip(stored, 3), 20_000, False),
        ("dist_beyond_output", primed, 8_000, False),
        ("out_len_mismatch", _raw(TEXT[:5_000]), 4_999, False),
        ("over_max_out", _raw(TEXT[:40_000], level=9), 40_000, False),
    ]


_JAX_REF = {}  # the JAX results by input, so that the model's tests reuse them


def _run_both(streams, out_lens, *, start_bits=None, win=None, stop=False, one_level):
    words, bits = IK.pack_streams_words(streams)
    B = len(streams)
    sb = np.zeros(B, np.int32) if start_bits is None else np.asarray(start_bits, np.int32)
    ol = np.asarray(out_lens, np.int32)
    key = (b"".join(streams), tuple(len(x) for x in streams), tuple(ol), tuple(sb), stop, one_level,
           None if win is None else win.tobytes())
    if key not in _JAX_REF:
        _JAX_REF[key] = decode_streams_pallas(
            jnp.asarray(words), jnp.asarray(sb), jnp.asarray(bits), jnp.asarray(ol),
            max_out=MAX_OUT, interpret=True, one_level=one_level,
            win=None if win is None else jnp.asarray(win), stop_at_target=stop,
        )
    ref = _JAX_REF[key]
    got = IK.decode_streams(
        torch.from_numpy(words.view(np.int32)), torch.from_numpy(sb),
        torch.from_numpy(bits), torch.from_numpy(ol), max_out=MAX_OUT,
        win=None if win is None else torch.from_numpy(win), stop_at_target=stop,
    )
    return [np.asarray(r) for r in ref], [g.numpy() for g in got]


def _assert_lanes_equal(ref, got, names):
    for col in range(1, len(ref)):  # produced, bad, end_bit (, fin_seen)
        assert got[col].tolist() == ref[col].tolist(), (col, names)
    for i, name in enumerate(names):
        n = min(int(got[1][i]), MAX_OUT)
        assert got[0][i, :n].tobytes() == ref[0][i, :n].tobytes(), name


@pytest.fixture(scope="module")
def plain_batch(stored_chunk_stream):
    return _lanes_plain(stored_chunk_stream)


@pytest.mark.parametrize("one_level", [True, False])
def test_plain_equals_jax_clean_and_corrupt_lanes(plain_batch, one_level):
    names = [n for n, *_ in plain_batch]
    ref, got = _run_both([s for _, s, _, _ in plain_batch], [o for _, _, o, _ in plain_batch],
                         one_level=one_level)
    _assert_lanes_equal(ref, got, names)
    out, produced, bad = got[0], got[1], got[2]
    for i, (name, stream, out_len, clean) in enumerate(plain_batch):
        if clean:
            want = _inflate(stream)
            assert not bad[i] and produced[i] == len(want), name
            assert out[i, : len(want)].tobytes() == want, name
        elif name == "flip_mid":
            # K6 does not catch every corruption: a clean flag over other
            # bytes is what the container checksum is for
            assert bad[i] or out[i, :out_len].tobytes() != _inflate(
                plain_batch[names.index("level6")][1])
        else:
            assert bad[i], name


def _window_batch():
    """(stream, out_len, start_bit, window) lanes of the primed batch, run
    in stop mode: a primed region, a resume at a sub-byte block boundary
    with its window, early stops of a many-block stream, a damaged region
    and a region whose window is too short."""
    prime = _BASH[60_000:92_768]
    region = _BASH[92_768:110_000]
    primed = _raw(region, zdict=prime)
    many = _raw(TEXT[:30_000], mem=1)  # blocks of ~128 symbols
    # a block boundary of `many` at or after 7000 bytes, found by a stop
    words, bits = IK.pack_streams_words([many])
    _o, produced, bad, end_bit, fin = IK.decode_streams(
        torch.from_numpy(words.view(np.int32)), torch.zeros(1, dtype=torch.int32),
        torch.from_numpy(bits), torch.tensor([7000], dtype=torch.int32), max_out=MAX_OUT,
        stop_at_target=True,
    )
    cut, start = int(produced[0]), int(end_bit[0])
    assert not bool(bad[0]) and not bool(fin[0]) and start % 8 != 0
    return [
        ("primed_region", primed, len(region), 0, prime),
        ("sub_byte_resume", many, 30_000 - cut, start, TEXT[:cut]),
        ("stop_early", many, 5_000, 0, b""),
        ("stop_at_once", many, 1, 0, b""),
        ("flipped_region", _flip(primed, 40), len(region), 0, prime),
        ("short_window", primed, len(region), 0, prime[-1_000:]),
    ]


def _window_array(windows, wpad=32768):
    """uint8 [B, wpad]: each history right-aligned, zeros where none."""
    win = np.zeros((len(windows), wpad), np.uint8)
    for i, w in enumerate(windows):
        if w:
            win[i, wpad - len(w) :] = np.frombuffer(w[-wpad:], np.uint8)
    return win


@pytest.mark.parametrize("one_level", [True, False])
def test_plain_equals_jax_window_start_bit_and_stop_lanes(one_level):
    lanes = _window_batch()
    win = _window_array([w for *_rest, w in lanes])
    ref, got = _run_both(
        [s for _, s, _, _, _ in lanes], [o for _, _, o, _, _ in lanes],
        start_bits=[b for _, _, _, b, _ in lanes], win=win, stop=True, one_level=one_level,
    )
    names = [n for n, *_ in lanes]
    _assert_lanes_equal(ref, got, names)
    out, produced, bad, _end, fin = got
    assert not bad[0] and out[0, : produced[0]].tobytes() == _BASH[92_768:110_000]
    assert not bad[1] and fin[1] and out[1, : produced[1]].tobytes() == TEXT[30_000 - int(produced[1]) : 30_000]
    assert not bad[2] and not fin[2] and 5_000 <= produced[2] < 30_000
    assert not bad[3] and not fin[3] and produced[3] < 5_000
    # the whole 32 KiB buffer counts as history (`dist > op` includes it),
    # so a short window decodes zeros where its history is missing
    assert not bad[5] and out[5, : produced[5]].tobytes() != _BASH[92_768:110_000]


def test_wrapper_checks():
    words, bits = IK.pack_streams_words([_raw(b"abc")])
    args = (torch.from_numpy(words.view(np.int32)), torch.zeros(1, dtype=torch.int32),
            torch.from_numpy(bits), torch.tensor([3], dtype=torch.int32))
    with pytest.raises(ValueError, match="multiple of 4"):
        IK.decode_streams(*args, max_out=64, win=torch.zeros((1, 6), dtype=torch.uint8))
    with pytest.raises(ValueError, match="int32"):
        IK.decode_streams(args[0].long(), *args[1:], max_out=64)
    with pytest.raises(RuntimeError, match="CUDA"):
        IK.decode_streams_cuda(*args, max_out=64)
    out, produced, bad, end_bit = IK.decode_streams(*args, max_out=64)
    assert out.shape == (1, 64) and out[0, :3].numpy().tobytes() == b"abc"
    assert int(produced[0]) == 3 and not bool(bad[0])


def test_pack_streams_words_equals_jax():
    from zlib_rs_tpu.ops.pallas.inflate_kernel import pack_streams_words

    payloads = [b"", b"a", b"abcd", _BASH[:1001]]
    got, gbits = IK.pack_streams_words(payloads)
    want, wbits = pack_streams_words(payloads)
    assert got.dtype == want.dtype and (got == want).all() and (gbits == wbits).all()


# ---------------------------------------------------------------------------
# above the kernel
# ---------------------------------------------------------------------------


def test_decode_chunks_kernel_and_decompress_parallel_equal_jax(monkeypatch, stored_chunk_stream):
    data = stored_chunk_stream["data"]
    out, index = stored_chunk_stream["port"]
    ref, ref_index = stored_chunk_stream["jax"]
    bodies = [out[o : o + n] for o, n, _ in index]
    sizes = [s for _, _, s in index]
    got = TS.decode_chunks_kernel(bodies, sizes, device="cpu")
    assert got == JS.decode_chunks_kernel(bodies, sizes, interpret=True)
    assert b"".join(got) == data
    tp._FALLBACKS.clear()
    monkeypatch.delenv("ZRS_TPU_VECTOR", raising=False)
    assert zt.decompress_parallel(out, index, device="cpu") == data
    assert jp.decompress_parallel(ref, ref_index, engine="tpu") == data
    monkeypatch.setenv("ZRS_TPU_VECTOR", "0")
    assert zt.decompress_parallel(out, index, device="cpu") == data
    assert zt.fallback_stats() == {}


def test_decode_chunks_kernel_raises_kernel_data_fault():
    body = _raw(TEXT[:5_000])
    with pytest.raises(TS.KernelDataFault, match="lanes"):
        TS.decode_chunks_kernel([_flip(body, 1)], [5_000], device="cpu")
    assert isinstance(TS.KernelDataFault("x"), ValueError)
    assert TS.decode_chunks_kernel([], [], device="cpu") == []


# ---------------------------------------------------------------------------
# the kernel's design, as a model
# ---------------------------------------------------------------------------
#
# K6 on the card (csrc/inflate.cu) cannot run here, so its design is held
# here as a Python model, step for step: the decode warp's table build
# (counts, a scan over the 16 counts, each symbol ranked within its length
# in symbol order, one lane a code for the fill, the subtable headers by
# the serial rule), its decode over a 64-bit bit reservoir refilled a word
# at a time from clamped word reads, its writes into the 64 KiB output ring
# (a literal a store, a match 32 bytes a step with the period rule, a
# stored span in 4 KiB pieces from the words), the publications every 4 KiB
# and the wait before a slot not yet stored, and the copy warp's 32-bit
# stores to the row, the last word masked. The copy warp runs either at
# once after each publication or only when the decoder waits and at the
# end, the two extremes of the card's interleavings. The model counts the
# edges it meets, so each case can show that its edge occurred, and is held
# against the plain version (the contract) and the JAX kernel.

import types
from collections import Counter

M32 = 0xFFFFFFFF
RING = IK.SMEM_BYTES  # the output ring
RMASK = RING - 1
PUBLISH = 4096
PIECE = 4096
MAX_MATCH = 258


def _plain_build_table():
    """The plain version's own `build_table` (a closure of `_inflate_lane`),
    bound to fresh state: (function, its lens list)."""
    code = next(c for c in IK._inflate_lane.__code__.co_consts
                if getattr(c, "co_name", "") == "build_table")
    state = {"cnt": [0] * 16, "lens": [0] * 320, "offs": [0] * 16, "work": [0] * 320}
    cells = tuple(types.CellType(state[n]) for n in code.co_freevars)
    return types.FunctionType(code, vars(IK), "build_table", None, cells), state["lens"]


def _brev(code, l):
    """__brev(code) >> (32 - l): the low l bits of code, reversed."""
    return int(format(code & M32, "032b")[::-1], 2) >> (32 - l)


def _warp_build(lens, base, nsyms, root_in, kind_of, cap, edges):
    """The warp's table build over lens[base : base + nsyms]: (root, bad,
    table). Each step is the kernel's: shared-atomic counts, a warp scan
    over the counts and canonical first codes, ranks by __match_any_sync in
    32-symbol groups, one lane a code, the headers in sorted order."""
    L = lens[base : base + nsyms]
    cnt = [0] * 16
    for l in L:
        if l > 0:
            cnt[l] += 1
    nz = [l for l in range(1, 16) if cnt[l] > 0]
    maxlen, minlen = (max(nz), min(nz)) if nz else (0, 15)
    root = min(max(root_in, minlen), max(maxlen, 1))
    incl = list(np.cumsum(cnt))
    ncodes = int(incl[15])
    left, code, nxt = 1, 0, [0] * 16
    for i in range(1, 16):
        left = left * 2 - cnt[i]
        code = (code + cnt[i - 1]) << 1
        nxt[i] = code
    bad = left < 0 or (left > 0 and not (kind_of == 2 and ncodes <= 1)) or maxlen == 0
    offs = [int(incl[l]) - cnt[l] for l in range(16)]
    run = offs[:]
    tab = [IK._entry(IK.KIND_INVALID, 0, root, 0)] * cap
    work = [0] * 320

    def ent(sym, l):
        kind, extra, val = IK._sym_fields(kind_of, sym)
        return IK._entry(kind, extra, l, val)

    sbad = False
    for g0 in range(0, nsyms, 32):
        ls = [L[g0 + j] if g0 + j < nsyms else 0 for j in range(32)]
        for j, l in enumerate(ls):  # lane j of the group
            if l <= 0:
                continue
            k = run[l] + ls[:j].count(l)
            work[k] = g0 + j
            if l <= root:
                huff = _brev(nxt[l] + k - offs[l], l)
                for f in range((1 << root) - (1 << l), -1, -(1 << l)):
                    if huff + f >= cap:  # the highest slot first
                        sbad = True
                        break
                    tab[huff + f] = ent(g0 + j, l)
        for l, c in Counter(x for x in ls if x > 0).items():
            run[l] += c
    bad = bad or sbad
    nshort = int(incl[root])
    rmask = (1 << root) - 1
    if not bad and nshort < ncodes:
        rem = cnt[:]
        used, low = 1 << root, -1
        for k in range(nshort, ncodes):
            l = L[work[k]]
            huff = _brev(nxt[l] + k - offs[l], l)
            if huff & rmask != low:
                c = l - root
                lft = 1 << c
                while lft > 0 and c + root < maxlen:
                    lft -= rem[c + root]
                    if lft > 0 and c + root < maxlen:
                        c += 1
                        lft *= 2
                edges["subtables"] += 1
                sub_off, used, low = used, used + (1 << c), huff & rmask
                if used > cap:
                    bad = True
                    break
                tab[low] = IK._entry(IK.KIND_SUB, c, root, sub_off)
            rem[l] -= 1
    if not bad:
        for k in range(nshort, ncodes):  # one lane a code
            sym = work[k]
            l = L[sym]
            huff = _brev(nxt[l] + k - offs[l], l)
            hdr = tab[huff & rmask]
            at = (hdr & 0xFFFF) + (huff >> root)
            step = 1 << (l - root)
            f = (1 << ((hdr >> 22) & 0x3F)) - step
            while True:
                if at + f >= cap or at + f < 0:
                    bad = True
                    break
                tab[at + f] = ent(sym, l)
                if f <= 0:
                    break
                f -= step
            edges["long_codes"] += 1
    edges["builds"] += 1
    edges["bad_tables"] += bad
    return root, bad, tab


def _check_build(lens, base, nsyms, root_in, kind_of, cap, edges):
    """The warp build, held against the plain version's on the same lens:
    equal root and bad, and equal tables wherever bad is false."""
    root, bad, tab = _warp_build(lens, base, nsyms, root_in, kind_of, cap, edges)
    plain, plens = _plain_build_table()
    plens[:] = lens[:320]
    ptab = [0] * cap
    proot, pbad = plain(ptab, cap, nsyms, base, root_in, kind_of)
    assert (root, bad) == (proot, pbad), (root, bad, proot, pbad)
    if not bad:
        assert tab == ptab
    return root, bad, tab


class _Bits:
    """The decoder's 64-bit reservoir over clamped word reads, one word
    loaded ahead (the kernel's `Bits`)."""

    def __init__(self, words, edges):
        self.w, self.top, self.edges = words, len(words) - 1, edges

    def word(self, i):
        if i > self.top:
            self.edges["clamped_reads"] += 1
        return self.w[0 if i < 0 else self.top if i > self.top else i]

    def seek(self, bp):
        wi, sh = bp >> 5, bp & 31
        self.res = (self.word(wi) | self.word(wi + 1) << 32) >> sh
        self.nbits, self.nxt_i = 64 - sh, wi + 2
        self.nxt = self.word(self.nxt_i)
        self.edges["seeks"] += 1

    def refill(self):
        if self.nbits <= 32:
            self.res |= self.nxt << self.nbits
            self.nbits += 32
            self.nxt_i += 1
            self.nxt = self.word(self.nxt_i)
        assert self.nbits >= 33

    def peek(self):
        return self.res & M32

    def skip(self, n):
        assert 0 <= n <= 32 and n < self.nbits
        self.res >>= n
        self.nbits -= n


class _Ring:
    """The output ring between the decode warp and the copy warp. `late`:
    the copy warp stores only when the decoder waits, and at the end."""

    def __init__(self, win_words, nwin, lim, ow, late, edges):
        self.ring, self.row = bytearray(RING), bytearray(4 * ow)
        for i in range(max(0, nwin - RING // 8), nwin):  # the last <= 32 KiB of the window
            self.ring[(4 * i) & RMASK : ((4 * i) & RMASK) + 4] = win_words[i].to_bytes(4, "little")
        self.pub = self.fpos = nwin << 2
        self.lim, self.late, self.edges = lim, late, edges
        self.limits()

    def limits(self):
        """Below rl a match is written with no publication and no wait;
        below lit_lim (also below max_out) a literal."""
        self.rl = min(self.pub + PUBLISH, self.fpos + RING - MAX_MATCH + 1)
        self.lit_lim = min(self.lim, self.rl)

    def store(self, end):
        """The copy warp: [fpos, end) a word at a time, a partial last word
        masked."""
        for p in range(self.fpos, end, 4):
            v = bytearray(self.ring[p & RMASK : (p & RMASK) + 4])
            if end - p < 4:
                v[end - p :] = bytes(4 - (end - p))
                self.edges["masked_last_word"] += 1
            self.row[p : p + 4] = v
        if end > self.fpos:
            self.fpos = end
            self.edges["stores"] += 1

    def publish(self, p):
        self.pub = p
        if not self.late:
            self.store(min(p, self.lim) & ~3)

    def room(self, op, n):
        """Before the decoder writes [op, op + n): publish if due, and wait
        for the copy warp to store every slot the write reuses."""
        if op - self.pub >= PUBLISH or op + n - self.fpos > RING:
            self.publish(op)
        if op + n - self.fpos > RING:
            self.edges["waits"] += 1
            self.store(min(self.pub, self.lim) & ~3)  # the copy warp, while the decoder spins
            assert op + n - self.fpos <= RING  # the wait ends
        self.limits()

    def finish(self, op):
        self.publish(min(op, self.lim))
        self.store(min(self.pub, self.lim))


def _decode_model(words, meta, ring, edges, check_tables):
    """The decode warp, writing into `ring`: (produced, bad, end_bit,
    fin_seen)."""
    start_bit, comp_bits, out_len, max_out, nwin, stop = meta[:6]
    build = _check_build if check_tables else _warp_build
    rd = _Bits(words, edges)
    rd.seek(start_bit)
    lens = [0] * 320
    s = {"bp": start_bit, "op": nwin << 2}
    buf = ring.ring
    top = len(words) - 1

    def adv(n):
        rd.skip(n)
        s["bp"] += n

    def peek():
        rd.refill()
        return rd.peek()

    def lookup(tab, w, mask, root):
        e0 = tab[w & mask]
        if e0 >> 28 == IK.KIND_SUB:
            return tab[(e0 & 0xFFFF) + ((w >> root) & ((1 << ((e0 >> 22) & 0x3F)) - 1))]
        return e0

    def copy_match(op, length, dist):
        edges["dist_lt_32"] += dist < 32
        edges["period_copy"] += dist < length
        edges["ring_wrap"] += ((op + length - 1) & RMASK) < (op & RMASK) or (
            (op - dist) & RMASK) > (op & RMASK)
        if dist == 1:  # a run of one byte
            edges["run_copy"] += 1
            v = buf[(op - 1) & RMASK]
            for j in range(length):
                buf[(op + j) & RMASK] = v
        elif dist >= 32 or dist >= length:  # every source lies before its 32-byte step
            edges["forward_copy_overlap"] += dist < length
            for k in range(0, length, 32):
                src = [buf[(op - dist + k + lane) & RMASK] for lane in range(32)]
                for lane in range(min(32, length - k)):
                    buf[(op + k + lane) & RMASK] = src[lane]
        else:  # a period under 32: each lane's offset in it, advanced 32 a step
            r = [lane % dist for lane in range(32)]
            for k in range(0, length, 32):
                for lane in range(min(32, length - k)):
                    buf[(op + k + lane) & RMASK] = buf[(op - dist + r[lane]) & RMASK]
                r = [x + 32 % dist - (dist if x + 32 % dist >= dist else 0) for x in r]

    def stored_block(bad):
        adv(((s["bp"] + 7) & ~7) - s["bp"])
        w = peek()
        ln, nln = w & 0xFFFF, w >> 16
        adv(32)
        bad = bad or (ln ^ 0xFFFF) != nln
        bad = bad or s["bp"] + ln * 8 > comp_bits + 32
        bad = bad or s["op"] + ln > max_out
        if bad:
            return bad
        off = s["bp"] >> 3
        for k0 in range(0, ln, PIECE):  # a lane a byte, in pieces
            n = min(PIECE, ln - k0)
            ring.room(s["op"], max(n, MAX_MATCH))
            for j in range(n):
                q = off + k0 + j
                edges["clamped_reads"] += q >> 2 > top
                buf[(s["op"] + j) & RMASK] = (words[min(max(q >> 2, 0), top)] >> ((q & 3) << 3)) & 0xFF
            s["op"] += n
            edges["stored_pieces"] += 1
        s["bp"] += ln << 3
        rd.seek(s["bp"])
        return bad

    def dynamic_header(bad):
        w = peek()
        nlen, ndist, hclen = (w & 31) + 257, ((w >> 5) & 31) + 1, ((w >> 10) & 15) + 4
        adv(14)
        bad = bad or nlen > 286 or ndist > 30
        lens[:19] = [0] * 19
        for i in range(hclen):
            lens[IK.CL_ORDER[i]] = peek() & 7
            adv(3)
        clroot, clbad, cltab = build(lens, 0, 19, IK.CL_ROOT, 0, IK.CL_CAP, edges)
        bad = bad or clbad
        total, i, prev = nlen + ndist, 0, -1
        while i < total and not bad:
            e = cltab[peek() & ((1 << clroot) - 1)]
            sym = e & 0xFFFF
            bad = bad or e >> 28 == IK.KIND_INVALID
            adv((e >> 16) & 0x3F)
            w2 = peek()
            if sym < 16:
                lens[i] = sym
                i, prev = i + 1, sym
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
            adv(ebits)
            prev = v
        bad = bad or s["bp"] > comp_bits + 32
        for j in range(31, -1, -1):
            if j < ndist:
                lens[288 + j] = lens[nlen + j]
        return nlen, ndist, bad or lens[256] == 0

    def coded_block(bad, nlen, ndist):
        ll_root, b1, lltab = build(lens, 0, nlen, IK.LL_ROOT, 1, IK.LL_CAP, edges)
        d_root, b2, dtab = build(lens, 288, ndist, IK.D_ROOT, 2, IK.D_CAP, edges)
        bad = bad or b1 or b2
        ll_mask, d_mask = (1 << ll_root) - 1, (1 << d_root) - 1
        eob = False
        while not (bad or eob) and s["bp"] <= comp_bits:
            w = peek()
            e = lookup(lltab, w, ll_mask, ll_root)
            while e >> 28 == IK.KIND_LIT and s["bp"] <= comp_bits:
                if ring.lit_lim <= s["op"] < max_out:
                    ring.room(s["op"], MAX_MATCH)
                if s["op"] < ring.lit_lim:
                    buf[s["op"] & RMASK] = e & 0xFF
                else:
                    edges["literals_past_max_out"] += 1
                adv((e >> 16) & 0x3F)
                s["op"] += 1
                w = peek()
                e = lookup(lltab, w, ll_mask, ll_root)
            bad = bad or s["op"] > max_out
            exhausted = s["bp"] > comp_bits
            kind, nb = e >> 28, (e >> 16) & 0x3F
            is_eob = kind == IK.KIND_EOB and not exhausted
            is_match = kind == IK.KIND_MATCH and not exhausted
            bad = bad or (not exhausted and not (is_eob or is_match))
            if is_eob:
                adv(nb)
                eob = True
            if is_match:
                lext = (e >> 22) & 0x3F
                length = (e & 0xFFFF) + ((w >> nb) & ((1 << lext) - 1))
                adv(nb + lext)
                w2 = peek()
                de = lookup(dtab, w2, d_mask, d_root)
                bad = bad or de >> 28 != IK.KIND_MATCH
                dnb, dext = (de >> 16) & 0x3F, (de >> 22) & 0x3F
                dist = (de & 0xFFFF) + ((w2 >> dnb) & ((1 << dext) - 1))
                adv(dnb + dext)
                if s["op"] + length > max_out and dist <= s["op"]:
                    edges["match_past_max_out"] += 1
                bad = bad or dist > s["op"] or s["op"] + length > max_out or dist < 1
                if not bad:
                    if s["op"] >= ring.rl:
                        ring.room(s["op"], MAX_MATCH)
                    copy_match(s["op"], length, dist)
                    s["op"] += length
        return bad

    bad = done = fin_seen = False
    while not (bad or done):
        w = peek()
        final, btype = w & 1, (w >> 1) & 3
        adv(3)
        bad = btype == 3 or s["bp"] > comp_bits
        edges[f"btype{btype}"] += 1
        if btype == 0:
            bad = stored_block(bad)
        elif btype == 1:
            lens[:320] = [8] * 144 + [9] * 112 + [7] * 24 + [8] * 8 + [5] * 32
            bad = coded_block(bad, 288, 32)
        else:
            nlen, ndist, bad = dynamic_header(bad)
            if not bad:
                bad = coded_block(bad, nlen, ndist)
        done = final > 0 or (out_len >= 0 and s["op"] >= out_len) or s["bp"] >= comp_bits
        fin_seen = fin_seen or (final > 0 and not bad)
    ring.finish(s["op"])
    bad = bad or (out_len >= 0 and s["op"] != out_len and not stop)
    return s["op"] - (nwin << 2), bad, s["bp"], fin_seen


def _model_decode(words, start_bits, comp_bits, out_lens, *, max_out, win=None, stop=False,
                  check_tables=True, late=False):
    """The design over a batch, with the wrapper's own `_prepare` and
    `_finish`: the outputs of `decode_streams`, and the edges met."""
    args = [torch.from_numpy(words.view(np.int32)), torch.as_tensor(np.asarray(start_bits, np.int32)),
            torch.as_tensor(np.asarray(comp_bits, np.int32)),
            torch.as_tensor(np.asarray(out_lens, np.int32))]
    meta, win_w, ow, wpad = IK._prepare(*args, max_out, None if win is None else torch.from_numpy(win),
                                        stop)
    edges = Counter()
    B = words.shape[0]
    out = np.zeros((B, 4 * ow), np.uint8)
    st = np.zeros((B, 4), np.int32)
    win_np = win_w.numpy().view(np.uint32)
    for b in range(B):
        m = meta[b].tolist()
        ring = _Ring(win_np[b].tolist(), m[4], m[3], ow, late, edges)
        produced, bad, end_bit, fin = _decode_model(words[b].tolist(), m, ring, edges, check_tables)
        out[b] = np.frombuffer(ring.row, np.uint8)
        st[b] = (produced, int(bad), end_bit, int(fin))
    res = IK._finish(torch.from_numpy(out.view(np.int32)), torch.from_numpy(st), wpad, max_out, stop)
    return [t.numpy() for t in res], edges


# -- crafted streams ---------------------------------------------------------

LBASE = [3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31, 35, 43, 51, 59, 67, 83, 99,
         115, 131, 163, 195, 227, 258]
LEXT = [0] * 8 + [1] * 4 + [2] * 4 + [3] * 4 + [4] * 4 + [5] * 4 + [0]
DBASE = [1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193, 257, 385, 513, 769, 1025,
         1537, 2049, 3073, 4097, 6145, 8193, 12289, 16385, 24577]
DEXT = [0 if k < 4 else k // 2 - 1 for k in range(30)]


class _BitWriter:
    """An LSB-first bit stream, Huffman codes MSB-first, as RFC 1951 packs them."""

    def __init__(self):
        self.acc, self.n, self.out = 0, 0, bytearray()

    def put(self, v, nbits):
        self.acc |= v << self.n
        self.n += nbits
        while self.n >= 8:
            self.out.append(self.acc & 0xFF)
            self.acc >>= 8
            self.n -= 8

    def code(self, c, nbits):
        self.put(int(format(c, f"0{nbits}b")[::-1], 2), nbits)

    def fixed_block(self, items, final):
        """Literals (ints) and (length, dist) pairs in one fixed block."""
        self.put(final, 1)
        self.put(1, 2)

        def sym(s):
            if s < 144:
                self.code(0x30 + s, 8)
            elif s < 256:
                self.code(0x190 + s - 144, 9)
            elif s < 280:
                self.code(s - 256, 7)
            else:
                self.code(0xC0 + s - 280, 8)

        for it in items:
            if isinstance(it, int):
                sym(it)
                continue
            length, dist = it
            i = max(k for k in range(29) if LBASE[k] <= length)
            sym(257 + i)
            self.put(length - LBASE[i], LEXT[i])
            j = max(k for k in range(30) if DBASE[k] <= dist)
            self.code(j, 5)
            self.put(dist - DBASE[j], DEXT[j])
        sym(256)

    def stored_block(self, data, final):
        self.put(final, 1)
        self.put(0, 2)
        if self.n:
            self.put(0, 8 - self.n)
        self.out += len(data).to_bytes(2, "little") + (len(data) ^ 0xFFFF).to_bytes(2, "little")
        self.out += data

    def done(self):
        if self.n:
            self.put(0, 8 - self.n)
        return bytes(self.out)


def _expand(items, history=b""):
    """The bytes a list of literals and (length, dist) pairs stands for."""
    out = bytearray(history)
    for it in items:
        if isinstance(it, int):
            out.append(it)
        else:
            for _ in range(it[0]):
                out.append(out[-it[1]])
    return bytes(out[len(history) :])


def _fixed(items):
    bw = _BitWriter()
    bw.fixed_block(items, 1)
    return bw.done()


def _rand(seed, n):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


DIST_ITEMS = list(_rand(1, 40)) + [(258, 1), (17, 2), (40, 3), (100, 31), (64, 32), (70, 33),
                                   (3, 1), (5, 2), (31, 31), (33, 32), (32, 33), (258, 31)]
HISTORY = _BASH[120_000:152_768]  # a 32 KiB window
WINDOW_ITEMS = [(258, 32768), (10, 32763), (3, 32768), *b"abc", (40, 20_000), (258, 3),
                (100, 32768)]


def _model_case(name, plain_batch):
    """(streams, out_lens, max_out, start_bits, windows, stop, edges it must
    meet) of a case of the model's decode."""
    if name == "clean_chunks":
        lanes = [x for x in plain_batch if x[0] in ("port_chunk0", "port_stored_chunk",
                                                     "port_chunk2", "jax_chunk2", "level6")]
        return ([s for _, s, _, _ in lanes], [o for _, _, o, _ in lanes], MAX_OUT, None, None,
                False, ("btype0", "btype2", "long_codes", "subtables", "stored_pieces"))
    if name == "stored_65535":
        bw = _BitWriter()
        bw.fixed_block(list(_rand(2, 1001)), 0)
        bw.stored_block(_rand(3, 65535), 1)
        return [bw.done()], [66_536], 70_000, None, None, False, (
            "btype0", "btype1", "stores", "waits")
    if name == "fixed":
        return ([_raw(TEXT[:12_000], strategy=zlib.Z_FIXED), _fixed(list(b"fixed block") + [(20, 3)])],
                [12_000, 31], MAX_OUT, None, None, False, ("btype1", "period_copy"))
    if name == "distances":
        return [_fixed(DIST_ITEMS)], [len(_expand(DIST_ITEMS))], MAX_OUT, None, None, False, (
            "dist_lt_32", "period_copy", "forward_copy_overlap", "run_copy", "masked_last_word")
    if name == "ring_x4":
        return [_raw(_BASH[:280_000])], [280_000], 280_000, None, None, False, (
            "ring_wrap", "stores", "waits", "long_codes")
    if name == "window_into_history":
        out = _expand(WINDOW_ITEMS, HISTORY)
        return ([_fixed(WINDOW_ITEMS), _raw(_BASH[152_768:170_000], zdict=HISTORY)],
                [len(out), 17_232], MAX_OUT, None, [HISTORY, HISTORY], False, ("period_copy",))
    if name == "start_bit_and_stop":
        lanes = _window_batch()
        return ([s for _, s, _, _, _ in lanes], [o for _, _, o, _, _ in lanes], MAX_OUT,
                [b for _, _, _, b, _ in lanes], [w for *_r, w in lanes], True, ("seeks",))
    if name == "past_max_out":
        # literals run past max_out (counted in produced); a match would cross it
        return ([_fixed(list(_rand(4, MAX_OUT + 100)) + [(3, 1)]),
                 _fixed(list(_rand(5, MAX_OUT - 100)) + [(258, 1)])],
                [MAX_OUT + 103, MAX_OUT + 158], MAX_OUT, None, None, False,
                ("literals_past_max_out", "match_past_max_out"))
    if name == "truncated_and_flipped":
        level6 = _raw(_BASH[10_000:40_000])
        stored = _raw(TEXT[:20_000], level=0)
        return ([level6[: len(level6) // 2], _flip(level6, len(level6) // 2), _flip(level6, 1),
                 _flip(level6, 7), stored[:5_000], _flip(stored, 3), b"\x07" + level6[1:200],
                 level6[:3], b"\x01" + (30_000).to_bytes(2, "little")
                 + (30_000 ^ 0xFFFF).to_bytes(2, "little") + b"x" * 10],
                [30_000, 30_000, 30_000, 30_000, 20_000, 20_000, 30_000, 30_000, 30_000], MAX_OUT,
                None,
                None, False, ("clamped_reads", "bad_tables"))
    raise KeyError(name)


MODEL_CASES = ["clean_chunks", "stored_65535", "fixed", "distances", "ring_x4",
               "window_into_history", "start_bit_and_stop", "past_max_out",
               "truncated_and_flipped"]


def _case_inputs(spec, case):
    streams, out_lens, max_out, start_bits, windows, stop, _edges = spec
    words, bits = IK.pack_streams_words(streams)
    if case == "truncated_and_flipped":
        # a stored block of 30,000 bytes with 10 in the buffer, and comp_bits
        # to match: the copy reads past W - 1, which clamps
        bits[-1] = 8 * (5 + 30_000)
    sb = np.zeros(len(streams), np.int32) if start_bits is None else np.asarray(start_bits, np.int32)
    win = None if windows is None else _window_array(windows)
    return words, sb, bits, np.asarray(out_lens, np.int32), max_out, win, stop


@pytest.mark.parametrize("case", MODEL_CASES)
def test_decoder_writer_model_equals_plain(plain_batch, case):
    """The model's outputs equal the plain version's, all of them: every
    byte of [0, max_out) (0 past `produced` in both), produced, bad,
    end_bit (and fin_seen); and each case meets its edges."""
    spec = _model_case(case, plain_batch)
    words, sb, bits, ol, max_out, win, stop = _case_inputs(spec, case)
    # the copy warp late on the long cases (the decoder then waits on it), at
    # once on the others
    late = case in ("stored_65535", "ring_x4")
    got, edges = _model_decode(words, sb, bits, ol, max_out=max_out, win=win, stop=stop, late=late)
    want = IK.decode_streams(torch.from_numpy(words.view(np.int32)), torch.from_numpy(sb),
                             torch.from_numpy(bits), torch.from_numpy(ol), max_out=max_out,
                             win=None if win is None else torch.from_numpy(win),
                             stop_at_target=stop)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())
    for edge in spec[6]:
        assert edges[edge] > 0, (edge, dict(edges))
    if case == "stored_65535":
        assert edges["stored_pieces"] >= 16 and got[1][0] == 66_536
        assert got[0][0, 1001:66_536].tobytes() == _rand(3, 65535)
    if case == "ring_x4":
        assert got[1][0] >= 4 * RING - 2 * 32768 and got[0][0].tobytes() == _BASH[:280_000]
    if case == "distances":
        assert got[0][0, : got[1][0]].tobytes() == _expand(DIST_ITEMS)
    if case == "window_into_history":
        assert got[0][0, : got[1][0]].tobytes() == _expand(WINDOW_ITEMS, HISTORY)
        assert not got[2].any()
    if case == "past_max_out":
        assert got[1].tolist() == [MAX_OUT + 100, MAX_OUT - 100] and got[2].all()


@pytest.mark.parametrize("batch", ["clean_and_corrupt", "window_start_bit_and_stop", "crafted"])
def test_decoder_writer_model_equals_jax(plain_batch, batch):
    """The model against the JAX kernel in interpret mode (two-level
    tables), on the streams of 32 KiB or less: the batches of the tests
    above (their JAX results are reused) and one of the crafted cases."""
    if batch == "clean_and_corrupt":
        names = [n for n, *_ in plain_batch]
        streams, ol = [s for _, s, _, _ in plain_batch], [o for _, _, o, _ in plain_batch]
        sb, win, stop = None, None, False
    elif batch == "window_start_bit_and_stop":
        lanes = _window_batch()
        names = [n for n, *_ in lanes]
        streams, ol = [s for _, s, _, _, _ in lanes], [o for _, _, o, _, _ in lanes]
        sb, win, stop = [b for _, _, _, b, _ in lanes], _window_array([w for *_r, w in lanes]), True
    else:
        specs = [_model_case(c, plain_batch) for c in ("distances", "window_into_history",
                                                        "past_max_out")]
        names = ["distances", "window_fixed", "window_zdict", "literals_past", "match_past"]
        streams = [x for sp in specs for x in sp[0]]
        ol = [x for sp in specs for x in sp[1]]
        sb, stop = None, False
        win = _window_array([b"", HISTORY, HISTORY, b"", b""])
    ref, _port = _run_both(streams, ol, start_bits=sb, win=win, stop=stop, one_level=False)
    words, bits = IK.pack_streams_words(streams)
    sb_np = np.zeros(len(streams), np.int32) if sb is None else np.asarray(sb, np.int32)
    got, _edges = _model_decode(words, sb_np, bits, np.asarray(ol, np.int32), max_out=MAX_OUT,
                                win=win, stop=stop, check_tables=False)
    _assert_lanes_equal(ref, got, names)


TABLE_CASES = ["fixture_chunks", "complete_to_15", "single_distance_code", "incomplete_litlen",
               "oversubscribed", "fixed"]


def _lens(pairs, n=320):
    """lens[320] with lens[sym] = l for each (sym, l)."""
    lens = [0] * n
    for sym, l in pairs:
        lens[sym] = l
    return lens


@pytest.mark.parametrize("case", TABLE_CASES)
def test_warp_table_build_model_equals_plain(plain_batch, case):
    """The warp build's root, bad and table (where bad is false) equal the
    plain version's `build_table` on every table the fixture's streams
    build, and on crafted length sets."""
    edges = Counter()
    if case == "fixture_chunks":
        for _name, stream, out_len, _clean in plain_batch:
            words, bits = IK.pack_streams_words([stream])
            # every build of the decode is held against the plain build
            _model_decode(words, np.zeros(1, np.int32), bits, np.asarray([out_len], np.int32),
                          max_out=MAX_OUT)
        assert edges is not None
        return
    if case == "complete_to_15":
        # lengths 1..15 and a second 15: complete; the seven codes past the
        # 9-bit root share one root slot, so one subtable of 6 bits
        lens = _lens([(s, l) for s, l in zip(range(0, 300, 17), range(1, 16))] + [(256, 15)])
        root, bad, _t = _check_build(lens, 0, 286, IK.LL_ROOT, 1, IK.LL_CAP, edges)
        assert not bad and root == IK.LL_ROOT
        assert (edges["subtables"], edges["long_codes"]) == (1, 7)
        # lengths 1..8 once, then 8 codes of 12 bits and 16 of 13: two root
        # slots left, two subtables of 3 and 4 bits
        lens = _lens([(s, l) for s, l in zip(range(8), range(1, 9))]
                     + [(20 + s, 12) for s in range(8)] + [(40 + s, 13) for s in range(16)])
        root, bad, _t = _check_build(lens, 0, 286, IK.LL_ROOT, 1, IK.LL_CAP, edges)
        assert not bad and (edges["subtables"], edges["long_codes"]) == (3, 31)
        # the first code set as distance codes: root 6, codes 7..15 past it
        dl = _lens([(288 + s, l) for s, l in zip(range(15), range(1, 16))] + [(288 + 15, 15)])
        root, bad, _t = _check_build(dl, 288, 30, IK.D_ROOT, 2, IK.D_CAP, edges)
        assert not bad and root == IK.D_ROOT and edges["long_codes"] == 31 + 10
    elif case == "single_distance_code":
        for l in (1, 5, 15):
            root, bad, _t = _check_build(_lens([(288 + 3, l)]), 288, 30, IK.D_ROOT, 2, IK.D_CAP,
                                         edges)
            assert not bad and root == l  # min(max(6, l), l): the one length
        # one litlen code alone is incomplete, and bad
        assert _check_build(_lens([(65, 1)]), 0, 286, IK.LL_ROOT, 1, IK.LL_CAP, edges)[1]
    elif case == "incomplete_litlen":
        root, bad, _t = _check_build(_lens([(0, 1), (256, 2)]), 0, 286, IK.LL_ROOT, 1,
                                     IK.LL_CAP, edges)
        assert bad
        assert _check_build(_lens([(s, 15) for s in range(286)]), 0, 286, IK.LL_ROOT, 1,
                            IK.LL_CAP, edges)[1]
    elif case == "oversubscribed":
        assert _check_build(_lens([(0, 1), (1, 1), (256, 1)]), 0, 286, IK.LL_ROOT, 1,
                            IK.LL_CAP, edges)[1]
        assert _check_build(_lens([(s, 2) for s in range(5)]), 0, 19, IK.CL_ROOT, 0,
                            IK.CL_CAP, edges)[1]
    else:  # the fixed tables
        lens = [8] * 144 + [9] * 112 + [7] * 24 + [8] * 8 + [5] * 32
        assert not _check_build(lens, 0, 288, IK.LL_ROOT, 1, IK.LL_CAP, edges)[1]
        assert not _check_build(lens, 288, 32, IK.D_ROOT, 2, IK.D_CAP, edges)[1]
    assert edges["builds"] > 0


def test_clock_script_instruments_the_kernel():
    """k6_clocks.py (the card-only measurement of K6's cycles) edits
    csrc/inflate.cu by exact text anchors and raises when one is gone;
    each must still be there."""
    import importlib.util
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location("k6_clocks", root / "k6_clocks.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    src = (root / "zlib_rs_tpu_torch" / "csrc" / "inflate.cu").read_text()
    out = mod.instrumented(src)
    assert out.count("clock64()") == 4 and 'extern "C" int zrs_dbg' in out
    with pytest.raises(RuntimeError, match="no longer has"):
        mod.instrumented(src.replace("  dc.rd.seek(start_bit);\n", ""))
