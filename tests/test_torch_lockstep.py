"""The lockstep kernel's design (csrc/lockstep.cu) as a Python model,
held against the kernel's plain version (`decode_regions_plain`) and the
JAX package's `decode_regions`, exactly: tapes, step count, produced and
bad.

The model is the kernel's control flow. It runs one lane at a time to its
own end (a lane that is done or bad never changes, so the reference's step
count is the largest of the lanes' counts), walks the reference's sections
in order inside a step, and builds each flat table by the kernel's per-key
rule: key k takes the symbol with the largest (interval start, symbol
index) at or below rev(k), the first in that order when none is, with
KIND_INVALID unless rev(k) lies inside its interval and some length is
nonzero. A fixed block after a fixed block keeps its tables, as in the
kernel.

Lanes: stdlib raw deflate at levels 0, 1, 6 and 9 and under Z_FIXED, the
lone-EOB body, regions cut by the zran index at sub-byte starts, the step
cap, and corrupt lanes: a flipped byte, an over-subscribed code-length
code, HLIT > 286, a stored block whose NLEN is wrong, a truncated body
and a reserved block type (bad in the lane's first step)."""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zlib_rs_tpu.parallel.device_inflate as JDI
from zlib_rs_tpu_torch.models import zran as TZ
from zlib_rs_tpu_torch.parallel import device_inflate as DI

# the test workers share the cores, and an oversubscribed OpenMP pool spin-waits
torch.set_num_threads(1)

_BASH = open("/bin/bash", "rb").read()
LONE_EOB = bytes.fromhex("05c0810800000000207feb03")  # a dynamic block whose only code is EOB
MAX_OUT = 4096
MAX_STEPS = MAX_OUT + 2 + 512


def _raw(data, level=6, mem=8, strategy=zlib.Z_DEFAULT_STRATEGY):
    c = zlib.compressobj(level, zlib.DEFLATED, -15, mem, strategy)
    return c.compress(data) + c.flush()


class _Bits:
    """LSB-first bit writer for crafted headers."""

    def __init__(self):
        self.acc, self.n = 0, 0

    def put(self, v, nbits):
        self.acc |= (v & ((1 << nbits) - 1)) << self.n
        self.n += nbits
        return self

    def done(self, pad=8):
        return self.acc.to_bytes((self.n + 7) // 8, "little") + bytes(pad)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

PH = dict(HEADER=0, STORED=1, TABLE_META=2, CL_LENS=3, CL_BUILD=4, CLEN=5, BUILD=6, SYMS=7,
          DONE=8, BAD=9)
FIXED_LL = [8] * 144 + [9] * 112 + [7] * 24 + [8] * 8 + [0] * 32
FIXED_D = [5] * 32 + [0] * 288


def _sym_entry(alphabet, s, ln):
    """The kernel's sym_entry: (kind, aux, payload) of symbol s packed with
    length ln."""
    kind, aux, payload = DI.KIND_LIT, 0, s
    if alphabet == "ll":
        if s == 256:
            kind, payload = DI.KIND_EOB, 0
        elif 257 <= s < 286:
            kind, aux, payload = DI.KIND_MATCH, int(DI._LEXTRA[s - 257]), int(DI._LBASE[s - 257])
        elif s >= 286:
            kind, payload = DI.KIND_INVALID, 0
    elif alphabet == "d":
        if s < 30:
            kind, aux, payload = DI.KIND_MATCH, int(DI._DEXTRA[s]), int(DI._DBASE[s])
        else:
            kind, payload = DI.KIND_INVALID, 0
    return (kind << 28) | (aux << 22) | (ln << 16) | payload


def model_table(lens, nbits, alphabet):
    """The kernel's build_table: int64 [2^nbits] entries from the lengths."""
    lens = np.asarray(lens, np.int64)
    n = len(lens)
    counts = np.bincount(lens, minlength=16)
    first = [0, 0]
    code = 0
    for ln in range(2, 16):
        code = (code + int(counts[ln - 1])) << 1
        first.append(code)
    start = np.full(n, 1 << nbits, np.int64)
    end = start.copy()
    for s in range(n):
        ln = int(lens[s])
        if ln:
            rank = int((lens[:s] == ln).sum())
            start[s] = (first[ln] + rank) << (nbits - ln)
            end[s] = start[s] + (1 << (nbits - ln))
    order = np.lexsort((np.arange(n), start))  # by (start, index)
    keys = DI._rev_table(nbits)
    pos = np.maximum(np.searchsorted(start[order], keys, side="right") - 1, 0)
    sym = order[pos]
    entries = np.array([_sym_entry(alphabet, s, int(lens[s])) for s in range(n)], np.int64)
    e = entries[sym]
    inside = (keys < end[sym]) & bool(counts[1:].any())
    return np.where(inside, e, (e & 0x0FFFFFFF) | (DI.KIND_INVALID << 28))


def _fetch(row, pos):
    byte = pos >> 3
    chunk = row[byte : byte + 8].tobytes() if byte < len(row) else b""
    return int.from_bytes(chunk.ljust(8, b"\0"), "little") >> (pos & 7)


def model_lane(row, bitpos, end, target, max_steps, tk, ta, tb):
    """One lane to its own end, as thread 0 walks it. Returns (steps,
    produced, bad, the table builds asked of the block)."""
    phase, final_f, produced = PH["HEADER"], 0, 0
    hlit = hdist = hclen = cl_got = lens_have = prev_len = 0
    cl_lens, lens = [0] * 19, [0] * 320
    cl_lut = ll = dl = None
    tables_fixed, builds = False, 0
    step = 0
    while step < max_steps and phase < PH["DONE"]:
        ck = ca = cb = 0
        if bitpos > end:
            phase = PH["DONE"] if produced >= target else PH["BAD"]
        if phase == PH["HEADER"]:
            w = _fetch(row, bitpos)
            btype = (w >> 1) & 3
            final_f = w & 1
            bitpos += 3
            if btype == 1:
                hclen = -1
            phase = [PH["STORED"], PH["BUILD"], PH["TABLE_META"], PH["BAD"]][btype]
        if phase == PH["STORED"]:
            aligned = (bitpos + 7) & ~7
            v = _fetch(row, aligned)
            st_len, st_nlen = v & 0xFFFF, (v >> 16) & 0xFFFF
            if st_len == (~st_nlen & 0xFFFF):
                ck = DI.TOK_RAW if st_len else 0
                ca, cb = st_len, (aligned + 32) >> 3
                produced += st_len
                bitpos = aligned + 32 + 8 * st_len
                phase = PH["DONE"] if final_f == 1 or produced >= target else PH["HEADER"]
            else:
                phase = PH["BAD"]
        if phase == PH["TABLE_META"]:
            m = _fetch(row, bitpos)
            hlit, hdist, hclen = (m & 31) + 257, ((m >> 5) & 31) + 1, ((m >> 10) & 15) + 4
            cl_got, cl_lens, lens, lens_have = 0, [0] * 19, [0] * 320, 0
            bitpos += 14
            phase = PH["BAD"] if hlit > 286 else PH["CL_LENS"]
        if phase == PH["CL_LENS"]:
            cl_lens[int(DI._CL_ORDER[min(cl_got, 18)])] += _fetch(row, bitpos) & 7
            bitpos += 3
            cl_got += 1
            if cl_got >= hclen:
                phase = PH["CL_BUILD"]
        if phase == PH["CL_BUILD"]:
            cl_lut = model_table(cl_lens, DI.CL_BITS, "cl")
            builds += 1
            phase = PH["CLEN"]
        if phase == PH["CLEN"]:
            w = _fetch(row, bitpos)
            ce = int(cl_lut[w & 127])
            ckind, cnb, csym = ce >> 28, (ce >> 16) & 0x3F, ce & 0xFFFF
            rep_bits = {16: 2, 17: 3, 18: 7}.get(csym, 0)
            rep_extra = (w >> cnb) & ((1 << rep_bits) - 1)
            rep_n = 3 + rep_extra if csym in (16, 17) else 11 + rep_extra if csym == 18 else 1
            rep_val = csym if csym < 16 else prev_len if csym == 16 else 0
            if (ckind == DI.KIND_INVALID or (csym == 16 and lens_have == 0)
                    or lens_have + rep_n > hlit + hdist):
                phase = PH["BAD"]
            else:
                lens[lens_have : lens_have + rep_n] = [rep_val] * rep_n
                lens_have += rep_n
                prev_len = rep_val
                bitpos += cnb + rep_bits
                if lens_have >= hlit + hdist:
                    phase = PH["BAD"] if lens[256] == 0 else PH["BUILD"]
        if phase == PH["BUILD"]:
            fixed = hclen == -1
            if not (fixed and tables_fixed):
                tables_fixed = fixed
                if fixed:
                    ll_lens, d_lens = FIXED_LL, FIXED_D
                else:
                    ll_lens = [lens[j] if j < hlit else 0 for j in range(320)]
                    d_lens = [lens[min(hlit + j, 319)] if j < hdist else 0 for j in range(320)]
                ll = model_table(ll_lens, DI.FLAT_BITS, "ll")
                dl = model_table(d_lens, DI.FLAT_BITS, "d")
                builds += 1
            phase = PH["SYMS"]
        if phase == PH["SYMS"]:
            w = _fetch(row, bitpos)
            e = int(ll[w & 0x7FFF])
            kind, aux, nb, payload = e >> 28, (e >> 22) & 0x3F, (e >> 16) & 0x3F, e & 0xFFFF
            if kind == DI.KIND_LIT:
                ck, ca, cb = DI.TOK_LIT, 1, payload
                produced += 1
                bitpos += nb
                if produced >= target:
                    phase = PH["DONE"]
            elif kind == DI.KIND_EOB:
                bitpos += nb
                phase = PH["DONE"] if final_f == 1 else PH["HEADER"]
            elif kind == DI.KIND_MATCH:
                length = payload + ((w >> nb) & ((1 << aux) - 1))
                p2 = nb + aux
                de = int(dl[(w >> p2) & 0x7FFF])
                daux, dnb = (de >> 22) & 0x3F, (de >> 16) & 0x3F
                ca, cb = length, (de & 0xFFFF) + ((w >> (p2 + dnb)) & ((1 << daux) - 1))
                if de >> 28 != DI.KIND_MATCH:
                    phase = PH["BAD"]
                else:
                    ck = DI.TOK_MATCH
                    produced += length
                    bitpos += p2 + dnb + daux
                    if produced >= target:
                        phase = PH["DONE"]
            else:
                phase = PH["BAD"]
        if phase == PH["HEADER"] and bitpos + 3 > end and produced >= target:
            phase = PH["DONE"]
        tk[step], ta[step], tb[step] = ck, ca, cb
        step += 1
    return step, produced, phase == PH["BAD"], builds


def model(comp, start_bits, end_bits, targets, max_steps):
    """The kernel's outputs: tapes [B, max_steps], max of the lanes'
    counts, produced, bad; and each lane's count and builds."""
    B = comp.shape[0]
    tk = np.zeros((B, max_steps), np.uint8)
    ta = np.zeros((B, max_steps), np.int32)
    tb = np.zeros((B, max_steps), np.int32)
    lanes = [model_lane(comp[b], int(start_bits[b]), int(end_bits[b]), int(targets[b]),
                        max_steps, tk[b], ta[b], tb[b]) for b in range(B)]
    counts = [c for c, *_ in lanes]
    produced = np.array([p for _, p, _, _ in lanes], np.int32)
    bad = np.array([x for _, _, x, _ in lanes], bool)
    return (tk, ta, tb, max(counts, default=0), produced, bad), counts, [b for *_, b in lanes]


# ---------------------------------------------------------------------------
# the lanes
# ---------------------------------------------------------------------------

def _levels():
    """3 KiB of /bin/bash at levels 0, 1, 6 and 9 and under Z_FIXED, text
    under Z_FIXED in three sync-flushed pieces (fixed after fixed), the
    lone-EOB body and an empty stream."""
    lanes = [(_raw(_BASH[k * 3072 + 40_000 : (k + 1) * 3072 + 40_000], level=lv, strategy=st),
              _BASH[k * 3072 + 40_000 : (k + 1) * 3072 + 40_000])
             for k, (lv, st) in enumerate(((0, 0), (1, 0), (6, 0), (9, 0), (6, zlib.Z_FIXED)))]
    text = b"lockstep region engine, one block a lane; " * 60
    c = zlib.compressobj(6, zlib.DEFLATED, -15, 8, zlib.Z_FIXED)
    body = b"".join(c.compress(text[i : i + 800]) + c.flush(zlib.Z_SYNC_FLUSH)
                    for i in range(0, 2400, 800)) + c.compress(text[2400:]) + c.flush()
    lanes.append((body, text))
    lanes.append((LONE_EOB, b""))
    lanes.append((_raw(b""), b""))
    return [(b, len(o), 0) for b, o in lanes]


def _primed():
    """Regions of a stream of small blocks cut by the zran index, at
    sub-byte starts (their windows serve the resolver, not this engine)."""
    seg = _BASH[100_000:112_000]
    stream = _raw(seg, mem=1)
    index = TZ.build_index(stream, span=2_000, device="cpu")
    cuts = [(p.in_offset * 8 - p.bits, p.out_offset) for p in index.points]
    cuts.append((len(stream) * 8, index.total_out))
    lanes = [(stream[bit >> 3 : ((ebit + 7) >> 3) + 8], eout - out, bit & 7)
             for (bit, out), (ebit, eout) in zip(cuts, cuts[1:]) if eout > out]
    assert sum(sb != 0 for *_, sb in lanes) >= 2
    return lanes[:8]


def _oversubscribed_cl():
    """A dynamic block whose 19 code-length-code lengths are all 1."""
    bw = _Bits().put(1, 1).put(2, 2).put(0, 5).put(0, 5).put(15, 4)
    for _ in range(19):
        bw.put(1, 3)
    for v in (0b1011, 0b0110, 0b1111, 0b0001):
        bw.put(v, 4)
    return bw.done()


def _corrupt():
    body = _raw(_BASH[30_000:33_000])
    flipped = bytearray(body)
    flipped[len(body) // 2] ^= 0xFF
    hlit_287 = _Bits().put(1, 1).put(2, 2).put(30, 5).put(0, 5).put(0, 4).done()
    bad_nlen = _Bits().put(1, 1).put(0, 2).put(0, 5).put(5, 16).put(5, 16).done() + b"hello"
    reserved = bytes([body[0] | 0x06]) + body[1:]  # BTYPE 3 in the first header
    return [(bytes(flipped), 3000, 0), (_oversubscribed_cl(), 3000, 0), (hlit_287, 100, 0),
            (bad_nlen, 5, 0), (body[: len(body) // 2], 3000, 0), (reserved, 3000, 0),
            (_raw(b"after"), 5, 0)]


def _arrays(lanes):
    B = len(lanes)
    L = max(len(b) for b, *_ in lanes) + 8
    comp = np.zeros((B, L), np.uint8)
    for i, (b, *_r) in enumerate(lanes):
        comp[i, : len(b)] = np.frombuffer(b, np.uint8)
    sb = np.array([s for *_, s in lanes], np.int32)
    eb = np.array([len(b) * 8 for b, *_ in lanes], np.int32)
    tg = np.array([n for _, n, _ in lanes], np.int32)
    return comp, sb, eb, tg


CASES = {"levels": _levels, "primed": _primed, "corrupt": _corrupt}


def _three_ways(comp, sb, eb, tg, max_steps):
    got, counts, builds = model(comp, sb, eb, tg, max_steps)
    plain = DI.decode_regions_plain(*(torch.from_numpy(a) for a in (comp, sb, eb, tg)), max_steps)
    want = JDI.decode_regions(jnp.asarray(comp), jnp.asarray(sb), jnp.asarray(eb),
                              jnp.asarray(tg), max_steps=max_steps, max_out=MAX_OUT)
    for k, name in enumerate(("tok_kind", "tok_a", "tok_b", "n_steps", "produced", "bad")):
        w = np.asarray(want[k])
        p = np.asarray(plain[k]) if k == 3 else plain[k].numpy()
        assert np.array_equal(got[k], w) and np.array_equal(p, w), name
        assert k == 3 or got[k].dtype == p.dtype == w.dtype, name
    return got, counts, builds


@pytest.mark.parametrize("case", sorted(CASES))
def test_model_equals_plain_and_jax(case):
    comp, sb, eb, tg = _arrays(CASES[case]())
    got, counts, builds = _three_ways(comp, sb, eb, tg, MAX_STEPS)
    bad = got[5].tolist()
    assert got[3] == max(counts) < MAX_STEPS
    # each lane's tape is null past its own count
    for b, c in enumerate(counts):
        assert not got[0][b, c:].any() and not got[1][b, c:].any() and not got[2][b, c:].any()
    if case == "corrupt":
        # the flip and the over-subscribed code are whatever they decode to;
        # the rest are bad, the reserved type and HLIT 287 in the first step
        assert bad[2:] == [True, True, True, True, False]
        assert counts[2] == counts[5] == 1
        assert builds[1] >= 1  # the over-subscribed code-length table was built
    else:
        assert not any(bad)
        assert (got[4] == tg).all()
    if case == "levels":
        assert builds[5] == 1  # three fixed blocks, one build
        assert builds[2] >= 1 and got[3] > 500


def test_step_cap_equals_plain_and_jax():
    """A cap below the steps the lanes need: every count stops at the cap
    and the lanes still running are neither done nor bad."""
    comp, sb, eb, tg = _arrays(_levels())
    got, counts, _b = _three_ways(comp, sb, eb, tg, 300)
    assert got[3] == 300 and max(counts) == 300 and min(counts) < 300
    assert not got[5].any() and (got[4] < tg).any()


@pytest.mark.parametrize("nbits, n", [(DI.FLAT_BITS, 320), (DI.CL_BITS, 19)])
def test_table_rule_equals_plain(nbits, n):
    """The per-key rule against the plain version's histogram build, on
    complete, incomplete, over-subscribed and empty length sets."""
    rng = np.random.default_rng(16)
    sets = [np.zeros(n, np.int64), rng.integers(0, 8 if nbits == 7 else 16, n),
            np.where(rng.random(n) < 0.9, 0, rng.integers(1, 4, n)), np.ones(n, np.int64)]
    one = np.zeros(n, np.int64)
    one[3] = 1
    sets.append(one)
    if nbits == DI.FLAT_BITS:
        sets.append(np.asarray(FIXED_LL))
        sets.append(np.asarray(FIXED_D))
    fields = DI._cl_symbol_fields() if nbits == DI.CL_BITS else DI._ll_symbol_fields(n)
    rev = torch.from_numpy(DI._rev_table(nbits))
    alphabet = "cl" if nbits == DI.CL_BITS else "ll"
    for lens in sets:
        want = DI._build_flat_lut(torch.from_numpy(lens[None]), *fields, rev, nbits)[0].numpy()
        assert np.array_equal(model_table(lens, nbits, alphabet), want)
    if nbits == DI.FLAT_BITS:
        dfields = DI._d_symbol_fields(n)
        for lens in sets:
            want = DI._build_flat_lut(torch.from_numpy(lens[None]), *dfields, rev, nbits)[0]
            assert np.array_equal(model_table(lens, nbits, "d"), want.numpy())


def test_kernel_constants_match_the_source():
    """The model's alphabet tables and the kernel's constants agree."""
    src = (DI._device.CSRC / "lockstep.cu").read_text()

    def array(name):
        body = src.split(f"{name}[")[1].split("{")[1].split("}")[0]
        return [int(x) for x in body.replace("\n", " ").split(",")]

    assert array("kClOrder") == DI._CL_ORDER.tolist()
    assert array("kLBase") == DI._LBASE.tolist() and array("kLExtra") == DI._LEXTRA.tolist()
    assert array("kDBase") == DI._DBASE.tolist() and array("kDExtra") == DI._DEXTRA.tolist()
    for name in ("PH_HEADER", "PH_DONE", "PH_BAD"):
        assert name in src
