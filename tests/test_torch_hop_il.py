"""K12, the interleaved hop chase (ZRS_TPU_HOP_IL=2): the port's plain
version against the JAX package's `_make_kernel_hop_il` in interpret mode.

The JAX package reads ZRS_TPU_HOP_IL inside the jitted
`scan_chunks_hop_pallas`, and no static argument carries it, so the first
trace at a shape decides between K2 and K12 for every later call. Each JAX
run of K12 here clears the jit caches before and after it and counts the
traces of `_make_kernel_hop_il`, so that it provably ran and later tests
get K2 back. K12 needs an even batch there; the port runs it on any batch.

The contract is K2's: the match stream, `nmatch`, `bad` and the histogram
bins anything downstream reads (0-285, 288-317) are equal. Bin 319 is a
dead slot, which the JAX K12 also bumps for a lane that waits on its
partner. On a lane that overflows CAP_M, K12 counts the span once, where
K2 clears bank 0 only before its all-literal recount."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from zlib_rs_tpu.ops import lzvec as jl
from zlib_rs_tpu.ops.pallas import deflate_kernel as jdk
from zlib_rs_tpu_torch import interop
from zlib_rs_tpu_torch.ops.kernels import deflate_kernel as tdk

# the test workers share the cores, and an oversubscribed OpenMP pool spin-waits
torch.set_num_threads(1)

_BASH = open("/bin/bash", "rb").read()
PAD = 272
DICT, CHUNK = 4096, 8192
L6 = dict(depth=64, nice=128, good=8, max_lazy=16, w_g=6)
CAP_G = 4 * L6["w_g"]
SEL = np.r_[0:286, 288:318]  # the histogram bins anything downstream reads
# K2's summed literal bins minus K12's on the overflow lane below: banks 1-3
# of K2 keep their counts from before the overflow
K2_EXTRA_LITERALS = 35_922


def _words(buf):
    B = buf.shape[0]
    bb = buf.reshape(B, -1, 4).astype(np.uint32)
    w4 = bb[..., 0] | (bb[..., 1] << 8) | (bb[..., 2] << 16) | (bb[..., 3] << 24)
    return np.concatenate([w4, np.zeros((B, 2), np.uint32)], axis=1)


def _cut(data_len, ins_from, seed):
    """Dictionary-primed chunks cut from /bin/bash, as tests/
    test_torch_deflate_kernel.py's batch; a data_len of -DICT is an empty
    padding row (n_valid 0), as the JAX pipeline pads its tail batch."""
    rng = np.random.default_rng(seed)
    width = DICT + CHUNK + PAD
    buf = np.zeros((len(data_len), width), np.uint8)
    for r, dl in enumerate(data_len):
        off = int(rng.integers(0, len(_BASH) - width))
        n = DICT + dl
        if n > 0:
            buf[r, ins_from[r] : n] = np.frombuffer(_BASH[off + ins_from[r] : off + n], np.uint8)
    n_valid = (np.asarray(data_len) + DICT).astype(np.int32)
    return dict(buf=buf, w4=_words(buf), n_valid=n_valid, ins_from=np.asarray(ins_from, np.int32))


def _jax_scan(b):
    return [np.asarray(x) for x in jdk.scan_chunks_hop_pallas(
        jnp.asarray(b["w4"]), jnp.asarray(b["n_valid"]), jnp.asarray(b["ins_from"]),
        start=DICT, interpret=True, bytes_arr=jnp.asarray(b["buf"]), **L6,
    )]


def _jax_htab(b):
    return np.asarray(jl.build_hop_tables(
        jnp.asarray(b["w4"]), jnp.asarray(b["n_valid"]), jnp.asarray(b["ins_from"]),
        bytes_arr=jnp.asarray(b["buf"]), **L6,
    ))


@pytest.fixture(scope="module")
def batches():
    """An even batch of four chunks (the short one paired with a full one)
    and three of them padded with an empty fourth, with the JAX K12 of
    both and the number of K12 traces."""
    even = _cut([CHUNK, CHUNK, 3001, CHUNK], [DICT, 0, 0, 0], 2024)
    padded = {k: v.copy() for k, v in even.items()}
    padded["buf"][3] = 0
    padded["w4"][3] = 0
    padded["n_valid"][3] = 0
    padded["ins_from"][3] = DICT
    traced = []
    real = jdk._make_kernel_hop_il

    def spy(cap_g, K):
        traced.append((cap_g, K))
        return real(cap_g, K)

    mp = pytest.MonkeyPatch()
    mp.setattr(jdk, "_make_kernel_hop_il", spy)
    mp.setenv("ZRS_TPU_HOP_IL", "2")
    jax.clear_caches()
    try:
        even["k12"] = _jax_scan(even)
        padded["k12"] = _jax_scan(padded)
    finally:
        jax.clear_caches()
        mp.undo()
    even["htab"] = _jax_htab(even)
    return dict(even=even, padded=padded, traced=traced)


def _assert_chase_equal(got, ref, rows=None):
    mpos, mld, nmatch, kbad, freq = ref
    rows = range(len(nmatch)) if rows is None else rows
    tm, tl, tn, tk, tf = [t.numpy() for t in got]
    for r in rows:
        assert tn[r] == nmatch[r] and tk[r] == kbad[r]
        k = int(nmatch[r])
        np.testing.assert_array_equal(tm[r, :k], mpos[r, :k])
        np.testing.assert_array_equal(tl[r, :k].view(np.uint32), mld[r, :k])
        np.testing.assert_array_equal(tf[r, SEL], freq[r, SEL])


def _state(b, rows=slice(None)):
    return interop.state_from_numpy(
        {"words4": b["w4"][rows], "htab": b["htab"][rows], "n_valid": b["n_valid"][rows]},
        device="cpu",
    )


def test_k12_of_the_jax_htab_equals_pallas(batches):
    b = batches["even"]
    assert batches["traced"] and set(batches["traced"]) == {(CAP_G, 2)}
    st = _state(b)
    raw = tdk.hop_chase_il(st["words4"], st["htab"], st["n_valid"], DICT, CAP_G)
    assert [t.dtype for t in raw] == [torch.int32] * 4
    assert raw[0].shape == (4, tdk.CAP_M + 8) and raw[3].shape == (4, 4 * 320)
    _assert_chase_equal(tdk._hop_post(*raw), b["k12"])
    assert b["k12"][2].min() > 100  # real parses, not all-literal
    # on clean lanes K12 is K2: all four arrays, every bin
    for g, w in zip(raw, tdk.hop_chase(st["words4"], st["htab"], st["n_valid"], DICT, CAP_G)):
        assert torch.equal(g, w)


def test_scan_chunks_hop_runs_k12_under_hop_il(monkeypatch, batches):
    b = batches["even"]
    calls = []
    for name in ("hop_chase", "hop_chase_il"):
        real = getattr(tdk, name)
        monkeypatch.setattr(tdk, name, lambda *a, _n=name, _r=real: calls.append(_n) or _r(*a))
    args = (torch.from_numpy(b["w4"].view(np.int32)), torch.from_numpy(b["n_valid"]),
            torch.from_numpy(b["ins_from"]))
    kw = dict(start=DICT, bytes_arr=torch.from_numpy(b["buf"]), **L6)
    monkeypatch.setenv("ZRS_TPU_HOP_IL", "2")
    got = tdk.scan_chunks_hop(*args, **kw)
    assert calls == ["hop_chase_il"]
    _assert_chase_equal(got, b["k12"])
    monkeypatch.delenv("ZRS_TPU_HOP_IL")  # read on every call
    k2 = tdk.scan_chunks_hop(*args, **kw)
    assert calls == ["hop_chase_il", "hop_chase"]
    for g, w in zip(got, k2):
        assert torch.equal(g, w)


def test_odd_batch_equals_pallas_with_an_empty_fourth(batches):
    # the port runs K12 on three chunks; its last pair has one inert lane
    b = batches["even"]
    ref = batches["padded"]["k12"]
    st = _state(b, slice(0, 3))
    raw = tdk.hop_chase_il(st["words4"], st["htab"], st["n_valid"], DICT, CAP_G)
    assert raw[0].shape[0] == 3
    _assert_chase_equal(tdk._hop_post(*raw), ref, rows=range(3))
    assert ref[2][3] == 0 and not ref[3][3]  # the JAX padding lane emits nothing


def _pallas(kernel, w4, htab, n_valid, start=0):
    B = len(n_valid)
    meta = np.zeros((B, 8), np.int32)
    meta[:, 0] = n_valid
    meta[:, 1] = start
    shape = lambda n, dt: jax.ShapeDtypeStruct((1, B, n), dt)
    call = jax.jit(lambda m, w, h: pl.pallas_call(
        kernel, grid=(1,), interpret=True,
        out_shape=[shape(tdk.CAP_M + 8, jnp.int32), shape(tdk.CAP_M + 8, jnp.uint32),
                   shape(8, jnp.int32), shape(4 * 320, jnp.int32)],
    )(m, w, h))
    return [np.asarray(x)[0] for x in call(
        jnp.asarray(meta[None]), jnp.asarray(w4[None]), jnp.asarray(htab[None]))]


def test_overflow_lane_equals_pallas_k12_and_differs_from_k2():
    lanes = tdk.overflow_lanes()
    w4, htab, n_valid = lanes[0].numpy().view(np.uint32), lanes[1].numpy(), lanes[2].numpy()
    k12 = _pallas(jdk._make_kernel_hop_il(24, 2), w4, htab, n_valid)
    k2 = _pallas(jdk._make_kernel_hop(24), w4[:1], htab[:1], n_valid[:1])
    args = (*lanes, 0, 24)
    mpos, mld, st, freq = [t.numpy() for t in tdk.hop_chase_il(*args)]
    np.testing.assert_array_equal(st[:, :2], k12[2][:, :2])
    assert st[0].tolist()[:2] == [tdk.CAP_M + 1, 1] and st[1, 1] == 0
    for r in range(2):
        m = min(int(st[r, 0]), tdk.CAP_M)
        np.testing.assert_array_equal(mpos[r, :m], k12[0][r, :m])
        np.testing.assert_array_equal(mld[r, :m].view(np.uint32), k12[1][r, :m])
        # per bank, every bin but the dead 319
        np.testing.assert_array_equal(freq[r].reshape(4, 320)[:, :319],
                                      k12[3][r].reshape(4, 320)[:, :319])
    lits = freq[0].reshape(4, 320)[:, :256]
    assert lits.sum() == n_valid[0]  # the bad lane's span, counted once
    # the JAX K2 on the same lane: the same parse, banks 1-3 counted twice over
    np.testing.assert_array_equal(k2[2][0, :2], st[0, :2])
    np.testing.assert_array_equal(k2[0][0, : tdk.CAP_M], mpos[0, : tdk.CAP_M])
    k2_lits = k2[3][0].reshape(4, 320)[:, :256]
    np.testing.assert_array_equal(k2_lits[0], lits[0])
    assert k2_lits.sum() - lits.sum() == K2_EXTRA_LITERALS
    # the port's K2 keeps that behaviour, every bin
    k2_port = tdk.hop_chase(*[a[:1] if torch.is_tensor(a) else a for a in args])
    np.testing.assert_array_equal(k2_port[3].numpy(), k2[3])


def test_hop_chase_il_cuda_refuses_cpu_tensors():
    z = torch.zeros((1, 8), dtype=torch.int32)
    before = dict(tdk.launches)
    with pytest.raises(RuntimeError, match="CUDA"):
        tdk.hop_chase_il_cuda(z, z, torch.zeros(1, dtype=torch.int32), 0, 24)
    assert tdk.launches == before


# -- the kernel's design, as a numpy model ---------------------------------
#
# K12 on the card (csrc/hop_chase_il.cu) resolves every match entry of a
# tile of the span into a 32-bit slot at once, chases the slots a segment
# a thread to a fixed point (or a one-thread fix-up), and counts the
# literal spans from the match stream in parallel. The model below is that
# design: the slot layout, the rounds and the fix-up, the tiles that start
# where the chase leaves the last, the serial step for what the resolve
# leaves, and the two passes of the span count. It counts the edges it meets, so
# each case can show that its edge occurred.

FLAG = 1 << 31
M32 = 0xFFFFFFFF
SHORT_WORDS = 32  # a span of more words is finished by a warp


def _exact_len(w, ip, ml, dist, cap, cap_g):
    if ml == cap_g:
        k = ml
        while k < cap and tdk._get32(w, ip + k) == tdk._get32(w, max(ip - dist + k, 0)):
            k += 4
        ml = min(k, cap)
    xt = tdk._get32(w, ip + ml) ^ tdk._get32(w, max(ip - dist + ml, 0))
    return min(ml + tdk._tail(xt), cap)


def _resolve(w, ht, nv, p, cap_g):
    """The resolved slot of position p: a literal entry as it is, a match
    entry as FLAG | h << 24 | (len - 3) << 16 | dist, 0 for the serial step."""
    e = ht[p]
    if (e >> 30) <= 0:
        return e if e > 0 else 0
    h, ml, dist = (e >> 23) & 0x7F, (e >> 16) & 0x7F, e & 0xFFFF
    ip = p + h
    if ip >= nv:
        return 0
    cap = min(nv - ip, tdk.MAX_MATCH)
    if ml != cap_g and ml > cap:
        return 0
    mlen = _exact_len(w, ip, ml, dist, cap, cap_g)
    if mlen < tdk.MIN_MATCH:
        return 0
    return FLAG | h << 24 | (mlen - tdk.MIN_MATCH) << 16 | dist


def _step(w, ht, nv, cap_g, R, t0, tn, p, edges):
    """One step of the chase from the clean position p of the tile: (the
    next position, (ip, slot) of the match it emits or None); -1 where
    the serial step must take over."""
    s, i = R[p - t0], p
    if not s & FLAG:
        if s == 0:
            return -1, None
        i = min(p + s, nv)
        if i >= nv:
            return nv, None
        if i - t0 < tn:
            s = R[i - t0]
        else:  # a landing past the tile: resolved from device memory
            edges["literal_across_edge"] += 1
            s = _resolve(w, ht, nv, i, cap_g)
        if not s & FLAG:
            return -1, None
    ip = i + ((s >> 24) & 0x7F)
    return ip + ((s >> 16) & 0xFF) + tdk.MIN_MATCH, (ip, s)


ROUNDS = 6  # chase rounds before the sequential fix-up


def _segment_chase(step, t0, tn, edges, threads=512):
    """The tile's chase as the kernel's threads run it: one segment a
    thread, each walked from its entry to its end; every entry but the
    first becomes the exit before it, and the segments whose entry changed
    walk again, until none changes or ROUNDS have passed; then one thread
    walks, in order, each segment that did not start from its true entry.
    Returns (the entries, the segment ends, the exits, the match counts),
    or None if a walk met the serial step."""
    seg = -(-tn // threads)
    hi = [t0 + min((k + 1) * seg, tn) for k in range(threads)]
    frm = [t0 + min(k * seg, tn) for k in range(threads)]

    def walk(p, end):
        n = 0
        while p < end:
            p, m = step(p)
            if p < 0:
                return -1, 0
            n += m is not None
        return p, n

    exits, cnt = map(list, zip(*[walk(frm[k], hi[k]) for k in range(threads)]))
    for rnd in range(1, ROUNDS + 1):
        if min(exits) < 0:
            return None
        entry = [t0] + exits[:-1]
        if entry == frm:
            edges["rounds"] = max(edges["rounds"], rnd)
            return frm, hi, exits, cnt
        if rnd == ROUNDS:
            break
        for k in range(threads):
            if entry[k] != frm[k]:
                frm[k] = entry[k]
                exits[k], cnt[k] = walk(frm[k], hi[k])
    edges["fixup"] += 1
    p = t0
    for k in range(threads):
        if p != frm[k]:
            x, c = walk(p, hi[k])
            if x < 0:
                return None
            frm[k], exits[k], cnt[k] = p, x, c
        p = exits[k]
    return frm, hi, exits, cnt


def _tiled_chase(w, ht, nv, start, cap_g, tile, mpos_r, mld_r, edges, ends_r):
    """The chase over resolved tiles; returns (nmatch, bad). Each match's
    true end goes to ends_r (K2's scratch)."""
    t0, mc = start, 0
    while t0 < nv:
        tn = min(nv - t0, tile)
        R = [_resolve(w, ht, nv, t0 + k, cap_g) for k in range(tn)]
        edges["tiles"] += 1
        step = lambda p: _step(w, ht, nv, cap_g, R, t0, tn, p, edges)
        chased = _segment_chase(step, t0, tn, edges)
        if chased is None:  # K2's loop, by one thread, to the end of the span
            edges["serial"] += 1
            return _serial_chase(w, ht, nv, t0, mc, cap_g, mpos_r, mld_r, ends_r)
        entry, hi, exits, cnt = chased
        j = mc
        for k in range(len(entry)):  # the prefix sum of the counts and the last walk
            p = entry[k]
            while p < hi[k] and j <= tdk.CAP_M:
                p, m = step(p)
                if m is not None:
                    ip, sl = m
                    mpos_r[j] = ip  # slot CAP_M takes the overflowing match
                    mld_r[j] = (((sl >> 16) & 0xFF) << 15) | (((sl & 0xFFFF) - 1) & M32)
                    ends_r[j] = ip + ((sl >> 16) & 0xFF) + tdk.MIN_MATCH
                    j += 1
        mc += sum(cnt)
        if mc > tdk.CAP_M:
            return tdk.CAP_M + 1, True
        edge, t0 = t0 + tn, exits[-1]
        edges["match_ends_on_edge"] += t0 == edge < nv
    return mc, False


def _serial_chase(w, ht, nv, i0, mc, cap_g, mpos_r, mld_r, ends_r):
    """K2's loop from i0 with mc matches emitted: (nmatch, bad)."""
    bad = False
    while i0 < nv and not bad:
        e, i = ht[i0], i0
        if (e >> 30) <= 0:
            i = min(i0 + e, nv)
            e = ht[min(i, nv - 1)]
        if i >= nv:
            break
        ip, dist = i + ((e >> 23) & 0x7F), e & 0xFFFF
        mlen = _exact_len(w, ip, (e >> 16) & 0x7F, dist, min(nv - ip, tdk.MAX_MATCH), cap_g)
        slot = min(mc, tdk.CAP_M)
        mpos_r[slot] = ip
        mld_r[slot] = (((mlen - tdk.MIN_MATCH) << 15) | ((dist - 1) & M32)) & M32
        ends_r[slot] = ip + mlen
        bad = mc >= tdk.CAP_M
        mc += 1
        i0 = ip + mlen
    return mc, bad


def _count_words(w, hist, p, e, ks):
    """The 4-byte reads k of `ks` of the span [p, e): read k starts at p + 4k."""
    for k in ks:
        tdk._count_span(w, hist, p + 4 * k, min(e, p + 4 * k + 4))


def _span_replay(w, mpos_r, mld_r, ends_r, mc, bad, start, nv, hist, edges, threads=512,
                 warps=16, k2_rule=False):
    """The two passes of the span count: a thread a span, its first
    SHORT_WORDS words; then a warp a longer span, lanes 32 words apart.
    Span j ends at match j for j < nm and at n_valid for the tail span.
    A bad lane under K12's rule has one span, the whole; under K2's rule
    (`k2_rule`) its CAP_M + 1 spans end at matches, and after them bank 0
    is cleared and the whole span counted again, a word a thread. K12
    reads a match's end back from its mld, K2 from the true ends."""
    nm = mc if not bad or k2_rule else 0
    nspan = mc if bad and k2_rule else nm + 1
    longs = []

    def span(j):
        if j == 0:
            p = start
        elif k2_rule:
            p = int(ends_r[j - 1])
        else:
            p = int(mpos_r[j - 1]) + (int(mld_r[j - 1]) >> 15) + tdk.MIN_MATCH
        return p, (int(mpos_r[j]) if j < nm else nv)

    for t in range(threads):
        for j in range(t, nspan, threads):
            p, e = span(j)
            nw = (e - p + 3) // 4 if e > p else 0
            if e > p:
                edges[f"dead_{(e - p) % 4}"] += 1
            _count_words(w, hist, p, e, range(min(nw, SHORT_WORDS)))
            if nw > SHORT_WORDS:
                longs.append(j)
    edges["long_spans"] += len(longs)
    for wp in range(warps):
        for j in longs[wp::warps]:
            p, e = span(j)
            for lane in range(32):
                _count_words(w, hist, p, e, range(SHORT_WORDS + lane, (e - p + 3) // 4, 32))
    if bad and k2_rule:
        edges["k2_recount"] += 1
        hist[: tdk.N_BINS] = [0] * tdk.N_BINS
        nw = (nv - start + 3) // 4 if nv > start else 0
        for t in range(threads):
            _count_words(w, hist, start, nv, range(t, nw, threads))


def _k12_model(words, htab, n_valid, start, cap_g, tile, k2_rule=False):
    """The design over a batch: (mpos, mld, st, freq) as int64 arrays, and
    the edges met; `k2_rule` counts a bad lane as K2 does."""
    B = words.shape[0]
    C = tdk.CAP_M + 8
    w_np = words.numpy().view(np.uint32)
    mpos, mld = np.zeros((B, C), np.int64), np.zeros((B, C), np.int64)
    st, freq = np.zeros((B, 8), np.int64), np.zeros((B, 4 * 320), np.int64)
    edges = dict.fromkeys(("serial", "tiles", "rounds", "fixup", "match_ends_on_edge",
                           "literal_across_edge", "dead_0", "dead_1", "dead_2", "dead_3",
                           "long_spans", "k2_recount"), 0)
    for r in range(B):
        w, ht, nv = w_np[r].tolist(), htab[r].tolist(), int(n_valid[r])
        ends = np.zeros(C, np.int64)
        mc, bad = _tiled_chase(w, ht, nv, start, cap_g, tile, mpos[r], mld[r], edges, ends)
        hist = [0] * (4 * 320)
        _span_replay(w, mpos[r], mld[r], ends, mc, bad, start, nv, hist, edges, k2_rule=k2_rule)
        st[r, :2], freq[r] = (mc, int(bad)), hist
    return mpos, mld, st, freq, edges


def _lane_tables(data_rows, n_valid):
    """Words, the JAX hop tables and n_valid of rows of bytes (PAD of
    zero tail each), under the level-6 knobs of this file."""
    width = max(len(d) for d in data_rows) + PAD
    width += -width % 4
    buf = np.zeros((len(data_rows), width), np.uint8)
    for r, d in enumerate(data_rows):
        buf[r, : len(d)] = np.frombuffer(d, np.uint8)
    b = dict(buf=buf, w4=_words(buf), n_valid=np.asarray(n_valid, np.int32),
             ins_from=np.zeros(len(data_rows), np.int32))
    return b["w4"], _jax_htab(b), b["n_valid"]


def _random(seed, n):
    return np.random.default_rng(seed).integers(0, 256, n).astype(np.uint8).tobytes()


def _serial_lane():
    """Random bytes whose htab has at p % 8 == 5 a literal entry whose bits
    read as a match (h 0, len 3, dist 1) where a literal jump from p % 8 == 0
    lands, and 3-byte distance-1 matches elsewhere: every landing takes the
    serial step, which decodes it as a match, as K2 does."""
    n = 6000
    buf = np.zeros((1, n + PAD), np.uint8)
    buf[0, :n] = np.frombuffer(_random(7, n), np.uint8)
    w4 = _words(buf)
    htab = np.full((1, 4 * w4.shape[1]), (1 << 30) | (3 << 16) | 1, np.int32)
    htab[:, 0::8] = 5
    htab[:, 5::8] = (3 << 16) | 1
    return w4, htab, np.array([n], np.int32)


def _all_literal_lanes():
    """Three lanes whose every htab slot jumps past n_valid: one literal
    span each, of lengths 1, 2 and 3 mod 4."""
    n = np.array([5001, 6002, 7003], np.int32)
    buf = np.zeros((3, 7003 + PAD + 1), np.uint8)
    for r in range(3):
        buf[r, : n[r]] = np.frombuffer(_random(20 + r, int(n[r])), np.uint8)
    w4 = _words(buf)
    return w4, np.full((3, 4 * w4.shape[1]), 1 << 20, np.int32), n


def _k12_case(name):
    """(words u32, htab, n_valid, start, cap_g, tile, the edges the case
    must meet) of a crafted case; None for the batch's own chunks, "far"
    for them with every dist past the row."""
    if name in ("bash_batch_one_tile", "bash_batch_tiles_of_1024"):
        return None
    if name == "overflow_lane":
        w, h, n = tdk.overflow_lanes()
        return w.numpy().view(np.uint32), h.numpy(), n.numpy(), 0, 24, 5000, (
            "tiles", "match_ends_on_edge", "long_spans")
    if name == "two_tiles_literal_across_edge":
        text = _BASH[200_000:206_000]
        data = [text + _random(1, 3000) + text[:3000] + b"\x00" * 517 + text[:2001]]
        w4, htab, nv = _lane_tables(data, [len(data[0])])
        return w4, htab, nv, 0, CAP_G, 7000, ("literal_across_edge", "tiles", "fixup", "dead_1",
                                              "dead_2", "dead_3")
    if name == "far_sources":
        return "far"
    if name == "serial_landings":
        w4, htab, nv = _serial_lane()
        return w4, htab, nv, 0, CAP_G, 1024, ("serial", "tiles")
    if name == "all_literal":
        w4, htab, nv = _all_literal_lanes()
        return w4, htab, nv, 0, CAP_G, tdk.TILE, ("long_spans", "dead_1", "dead_2", "dead_3")
    raise KeyError(name)


K12_CASES = ["bash_batch_one_tile", "bash_batch_tiles_of_1024", "overflow_lane",
             "two_tiles_literal_across_edge", "far_sources", "serial_landings", "all_literal"]


def _assert_model_equal(model, plain, rows, dead_bins=True, slots=tdk.CAP_M + 1):
    """The model's arrays against a reference's: nmatch and bad, the match
    slots up to `slots` (the JAX kernel writes slot CAP_M whenever a lane
    emits nothing), every bin, or every bin but the dead 319 of each bank."""
    mpos, mld, st, freq, _ = model
    pm, pl_, ps, pf = [t.numpy() for t in plain]
    np.testing.assert_array_equal(st[:, :2], ps[:, :2])
    for r in rows:
        m = min(int(st[r, 0]), slots)
        np.testing.assert_array_equal(mpos[r, :m], pm[r, :m])
        np.testing.assert_array_equal(mld[r, :m].astype(np.uint32), pl_[r, :m].view(np.uint32))
        got, want = freq[r].reshape(4, 320), pf[r].reshape(4, 320)
        np.testing.assert_array_equal(got if dead_bins else got[:, :319],
                                      want if dead_bins else want[:, :319])


def _case_inputs(batches, case):
    """(spec, words u32, htab, n_valid, start, cap_g, tile, the edges the
    K12 model must meet) of a case of K12_CASES."""
    spec = _k12_case(case)
    if spec is None or spec == "far":
        b = batches["even"]
        w4, htab, nv = b["w4"], b["htab"].copy(), b["n_valid"]
        tile, want = (1024, ("tiles", "match_ends_on_edge")) if case.endswith("1024") else (
            tdk.TILE, ("dead_1", "dead_2", "dead_3"))
        if spec == "far":  # every match source before the row: dist 0xFFFF
            w4, htab, nv = w4[:2], htab[:2], nv[:2]
            htab[(htab >> 30) > 0] |= 0xFFFF
        return spec, w4, htab, nv, DICT, CAP_G, tile, want
    return (spec, *spec)


@pytest.mark.parametrize("case", K12_CASES)
def test_resolved_chase_model_equals_plain_and_pallas(batches, case):
    spec, w4, htab, nv, start, cap_g, tile, want = _case_inputs(batches, case)
    st = interop.state_from_numpy({"words4": w4, "htab": htab, "n_valid": nv}, device="cpu")
    model = _k12_model(st["words4"], htab, nv, start, cap_g, tile)
    edges = model[4]
    for edge in want:
        assert edges[edge] > 0, (edge, edges)
    if case != "serial_landings":
        assert edges["serial"] == 0  # tables of this shape never reach the serial step
    # the plain version: every array, every bin, dead bins included
    plain = tdk.hop_chase_il_plain(st["words4"], st["htab"], st["n_valid"], start, cap_g)
    _assert_model_equal(model, plain, range(len(nv)))
    # the JAX K12 in interpret mode (an even number of lanes; a spare lane
    # waits, and its dead bins differ); a source before the row is read
    # there as the TPU reads it, and the port clamps it to byte 0
    if spec == "far":
        return
    if spec is None:
        ref = batches["even"]["k12"]
        post = tdk._hop_post(*[torch.from_numpy(a.astype(np.uint32).view(np.int32))
                               for a in model[:4]])
        _assert_chase_equal(post, ref)
        return
    lanes = len(nv)
    pairs = [_pallas(jdk._make_kernel_hop_il(cap_g, 2), w4[[a, b]], htab[[a, b]], nv[[a, b]], start)
             for a, b in zip(range(0, lanes, 2), [*range(1, lanes, 2), 0])]
    jax_model = [np.concatenate([p[k] for p in pairs])[:lanes] for k in range(4)]
    _assert_model_equal(model, [torch.from_numpy(np.asarray(a).astype(np.uint32).view(np.int32))
                                for a in jax_model], range(lanes), dead_bins=False,
                        slots=tdk.CAP_M)


# -- K2: the same body under K2's overflow rule ----------------------------
#
# K2 on the card (`zrs_hop_chase`) is K12's body with two differences, both
# in the histogram: a lane that overflows CAP_M counts its CAP_M + 1 spans
# that end at a match, then clears bank 0 and counts its whole span again
# (banks 1-3 keep their counts from before the overflow, dead bins
# included); and every span starts at the previous match's true end, which
# mld cannot hold for a dist past 2^15.

_JAX_K2 = {}


def _pallas_k2(w4, htab, n_valid, start, cap_g):
    """The JAX K2 (`_make_kernel_hop`) in interpret mode over a batch, one
    grid step a lane, as `scan_chunks_hop_pallas` launches it: the raw
    (mpos, mld, st, freq), every bank."""
    from jax.experimental.pallas import tpu as pltpu

    B, W = w4.shape
    tabn = 4 * W - start
    meta = np.zeros((B, 1, 8), np.int32)
    meta[:, 0, 0] = n_valid
    meta[:, 0, 1] = start
    spec = lambda n: pl.BlockSpec((1, 1, n), lambda b: (b, 0, 0), memory_space=pltpu.SMEM)
    shape = lambda n, dt: jax.ShapeDtypeStruct((B, 1, n), dt)
    C = tdk.CAP_M + 8
    out = pl.pallas_call(
        jdk._make_kernel_hop(cap_g), grid=(B,), interpret=True,
        in_specs=[spec(8), spec(W), spec(tabn)],
        out_specs=[spec(C), spec(C), spec(8), spec(4 * 320)],
        out_shape=[shape(C, jnp.int32), shape(C, jnp.uint32), shape(8, jnp.int32),
                   shape(4 * 320, jnp.int32)],
    )(jnp.asarray(meta), jnp.asarray(w4.reshape(B, 1, W)),
      jnp.asarray(np.ascontiguousarray(htab[:, start : start + tabn]).reshape(B, 1, tabn)))
    return [np.asarray(x)[:, 0] for x in out]


@pytest.mark.parametrize("case", K12_CASES)
def test_resolved_chase_model_k2_rule_equals_plain_and_pallas(batches, case):
    spec, w4, htab, nv, start, cap_g, tile, _want = _case_inputs(batches, case)
    st = interop.state_from_numpy({"words4": w4, "htab": htab, "n_valid": nv}, device="cpu")
    model = _k12_model(st["words4"], htab, nv, start, cap_g, tile, k2_rule=True)
    edges = model[4]
    plain = tdk.hop_chase_plain(st["words4"], st["htab"], st["n_valid"], start, cap_g)
    _assert_model_equal(model, plain, range(len(nv)))  # every bin, dead bins included
    if case == "overflow_lane":
        assert edges["k2_recount"] == 1 and model[2][0, :2].tolist() == [tdk.CAP_M + 1, 1]
        lits = model[3][0].reshape(4, 320)[:, :256].sum()
        assert lits == nv[0] + K2_EXTRA_LITERALS == 135_026
        k12 = _k12_model(st["words4"], htab, nv, start, cap_g, tile)
        assert k12[3][0].reshape(4, 320)[:, :256].sum() == nv[0] == 99_104
    if spec == "far":
        # mld's dist - 1 spills into the length field: K12's replay and
        # K2's true ends give other spans, and the model is K2's
        k12 = tdk.hop_chase_il_plain(st["words4"], st["htab"], st["n_valid"], start, cap_g)
        assert not torch.equal(k12[3], plain[3])
        return  # the JAX kernel reads a source before the row as the TPU does
    key = (case if spec is not None else "bash", tile if spec is not None else 0)
    if key not in _JAX_K2:
        _JAX_K2[key] = _pallas_k2(w4, htab, nv, start, cap_g)
    jax_k2 = [torch.from_numpy(np.asarray(a).astype(np.uint32).view(np.int32))
              for a in _JAX_K2[key]]
    # every bin; the JAX kernel writes slot CAP_M whenever a lane emits nothing
    _assert_model_equal(model, jax_k2, range(len(nv)), slots=tdk.CAP_M)
