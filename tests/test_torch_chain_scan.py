"""K8 (hash-chain scan), K9 (symbol histogram) and K10 (table walk) of the
port, as their plain PyTorch versions, against the JAX package's Pallas
kernels in interpret mode on the same inputs. Integer codec: every
comparison is exact."""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from zlib_rs_tpu.ops.pallas import deflate_kernel as jdk
from zlib_rs_tpu_torch import interop
from zlib_rs_tpu_torch import compress_parallel
from zlib_rs_tpu_torch.ops import dynhuff as td
from zlib_rs_tpu_torch.ops import lzvec
from zlib_rs_tpu_torch.ops.kernels import deflate_kernel as tdk

# the test workers share the cores, and an oversubscribed OpenMP pool spin-waits
torch.set_num_threads(1)

_BASH = open("/bin/bash", "rb").read()
PAD = 272
DICT, CHUNK = 4096, 8192
C = tdk.CAP_M + 8

# (good, max_lazy, nice, chain) of the three K8 settings the pipeline runs
K8_KNOBS = {
    "level6_tabscan0": (8, 16, 128, 64),
    "level8": tdk.ZLIB_CONFIG[8],
    "level9": tdk.ZLIB_CONFIG[9],
}


def _words(buf):
    B = buf.shape[0]
    bb = buf.reshape(B, -1, 4).astype(np.uint32)
    w4 = bb[..., 0] | (bb[..., 1] << 8) | (bb[..., 2] << 16) | (bb[..., 3] << 24)
    return np.concatenate([w4, np.zeros((B, 2), np.uint32)], axis=1)


def _gen(seed, n=4096, maxcopy=56):
    """Small-alphabet bytes with copied slices (tests/test_lzvec.py's)."""
    rng = np.random.default_rng(seed)
    data = bytearray(rng.integers(0, 12, n).astype(np.uint8).tobytes())
    for _ in range(40):
        s = int(rng.integers(0, n - maxcopy - 1))
        d = int(rng.integers(0, n - maxcopy - 1))
        ln = int(rng.integers(4, maxcopy))
        data[d : d + ln] = data[s : s + ln]
    return bytes(data)


LONG_RUN = (b"abcdefgh" * 64) + _gen(9, n=1024) + (b"\x00" * 300) + b"tail"


@pytest.fixture(scope="module")
def batch():
    """Four chunks: three cut from /bin/bash (no dict, full dict, a short
    last chunk) and one of long runs, every one emitted from DICT on."""
    rng = np.random.default_rng(2024)
    width = DICT + CHUNK + PAD
    ins_from = np.array([DICT, 0, 0, DICT], np.int32)
    data_len = np.array([CHUNK, CHUNK, 3001, len(LONG_RUN)], np.int32)
    buf = np.zeros((4, width), np.uint8)
    for r in range(3):
        off = int(rng.integers(0, len(_BASH) - width))
        n = DICT + int(data_len[r])
        buf[r, ins_from[r] : n] = np.frombuffer(_BASH[off + ins_from[r] : off + n], np.uint8)
    buf[3, DICT : DICT + len(LONG_RUN)] = np.frombuffer(LONG_RUN, np.uint8)
    n_valid = (data_len + DICT).astype(np.int32)
    return dict(buf=buf, w4=_words(buf), n_valid=n_valid, ins_from=ins_from)


def _state(b):
    return interop.state_from_numpy(
        {"words4": b["w4"], "n_valid": b["n_valid"], "ins_from": b["ins_from"],
         "chunks": b["buf"]}, device="cpu",
    )


def _assert_stream_equal(got, ref):
    mpos, mld, nmatch, bad = [np.asarray(x) for x in ref]
    tm, tl, tn, tb = [t.numpy() for t in got]
    np.testing.assert_array_equal(tn, nmatch)
    np.testing.assert_array_equal(tb, bad)
    for r in range(len(nmatch)):
        k = min(int(nmatch[r]), tdk.CAP_M)
        np.testing.assert_array_equal(tm[r, :k], mpos[r, :k])
        np.testing.assert_array_equal(tl[r, :k].view(np.uint32), mld[r, :k])


def _assert_byte_valid(mpos, mld, nmatch, data: bytes, start: int, n_valid: int):
    """The stream tiles [start, n_valid): matches in order, each equal to
    the bytes `dist` back."""
    lens = (mld[:nmatch].view(np.uint32) >> 15).astype(np.int64) + 3
    dists = (mld[:nmatch].view(np.uint32) & 0x7FFF).astype(np.int64) + 1
    end = start
    for p, ln, d in zip(mpos[:nmatch].tolist(), lens.tolist(), dists.tolist()):
        assert p >= end and p + ln <= n_valid and d <= p
        assert data[p : p + ln] == data[p - d : p - d + ln], (p, ln, d)
        end = p + ln
    return lens


@pytest.fixture(scope="module")
def k8_ref(batch):
    """The JAX K8 stream of the batch under each setting, computed once."""
    out = {}
    for name, (good, mlazy, nice, chain) in K8_KNOBS.items():
        out[name] = [np.asarray(x) for x in jdk.scan_chunks_pallas(
            jnp.asarray(batch["w4"]), jnp.asarray(batch["n_valid"]),
            jnp.full((4,), DICT, jnp.int32), jnp.asarray(batch["ins_from"]),
            depth=chain, nice=nice, good=good, max_lazy=mlazy, interpret=True,
        )]
    return out


# ---------------------------------------------------------------------------
# K8
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("setting", list(K8_KNOBS))
def test_chain_scan_equals_pallas(batch, k8_ref, setting):
    good, mlazy, nice, chain = K8_KNOBS[setting]
    st = _state(batch)
    got = tdk.scan_chunks(
        st["words4"], st["n_valid"], DICT, st["ins_from"], depth=chain, nice=nice,
        good=good, max_lazy=mlazy,
    )
    assert [t.dtype for t in got] == [torch.int32, torch.int32, torch.int32, torch.bool]
    assert got[0].shape == (4, C)
    _assert_stream_equal(got, k8_ref[setting])
    assert k8_ref[setting][2][:3].min() > 400  # real parses, not all-literal
    for r in range(4):
        _assert_byte_valid(got[0][r].numpy(), got[1][r].numpy(), int(got[2][r]),
                           batch["buf"][r].tobytes(), DICT, int(batch["n_valid"][r]))


def test_chain_scan_counts_the_candidates_it_visits(batch):
    # st[2] counts chain candidates: deeper budgets visit more of them
    st = _state(batch)
    args = (st["words4"], st["n_valid"], torch.full((4,), DICT), st["ins_from"])
    v = {name: tdk.chain_scan(*args, depth=c, nice=n, good=g, max_lazy=m)[2][:, 2]
         for name, (g, m, n, c) in K8_KNOBS.items()}
    assert (v["level6_tabscan0"] > 0).all()
    assert int(v["level9"].sum()) > int(v["level6_tabscan0"].sum())


def test_chain_scan_overflow_flags_bad_like_pallas():
    # 60 kB of an 8-letter alphabet parse into short matches: more than
    # CAP_M of them, so the dead write lands in slot CAP_M and ends the parse
    rng = np.random.default_rng(5)
    n = 60000
    buf = np.zeros((1, n + 16), np.uint8)
    buf[0, :n] = rng.integers(0, 8, size=n)
    w4 = _words(buf)
    knobs = dict(depth=4, nice=16, good=4, max_lazy=4)
    ref = [np.asarray(x) for x in jdk.scan_chunks_pallas(
        jnp.asarray(w4), jnp.asarray([n], jnp.int32), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1,), jnp.int32), interpret=True, **knobs,
    )]
    z = torch.zeros(1, dtype=torch.int32)
    got = tdk.scan_chunks(torch.from_numpy(w4.view(np.int32)), torch.tensor([n]), z, z, **knobs)
    assert bool(ref[3][0]) and int(ref[2][0]) > tdk.CAP_M
    _assert_stream_equal(got, ref)


# -- the kernel's design, as a numpy model ---------------------------------
#
# K8 on the card reads each chain from the positions sorted stably by hash
# and walks it 32 candidates a step (csrc/chain_scan.cu). The model below is
# that design in numpy: the bucket order, the groups of 32 with their live
# prefix, the anchor test at the group's starting length, the cut after the
# first lane that reaches nice and the first lane of greatest length. It
# also counts the group edges it meets, so each case can show that it puts
# its edge inside a group.


def _match_len(buf, i, c, cap):
    k = 0
    while k + 8 <= cap and buf[i + k : i + k + 8] == buf[c + k : c + k + 8]:
        k += 8
    while k < cap and buf[i + k] == buf[c + k]:
        k += 1
    return k


def _warp_scan_row(row, n_valid, start, ins_from, depth, nice, good, max_lazy, mpos_r, mld_r):
    """One chunk as the kernel's warp walks it: fills mpos_r/mld_r, returns
    (nmatch, bad, candidates visited, the group edges met)."""
    buf = row.tobytes()
    b = np.concatenate([row.astype(np.int64), np.zeros(2, np.int64)])
    hsh = ((b[:-2] << 10) ^ (b[1:-1] << 5) ^ b[2:]) & (tdk.HSIZE - 1)
    lo = min(ins_from, start)
    order = lo + np.argsort(hsh[lo:n_valid], kind="stable")  # S: the bucket order
    rank = np.zeros(len(buf), np.int64)
    rank[order] = np.arange(len(order))
    first = np.searchsorted(hsh[order], hsh, side="left")  # the bucket's first index
    S, rank, first = order.tolist(), rank.tolist(), first.tolist()
    edges = dict.fromkeys(("tie", "nice_mid", "budget_mid", "window_mid", "too_far",
                           "nice_at_start", "quartered"), 0)
    i, plen, pdist, avail, mc, bad, visits = start, 0, 0, False, 0, False, 0
    while i < n_valid and not bad:
        blen = bdist = 0
        if (not avail or plen < max_lazy) and rank[i] > first[i]:
            bl0 = plen if avail else 0
            cap = min(n_valid - i, tdk.MAX_MATCH)
            nice_eff = min(nice, cap)
            budget = depth >> 2 if bl0 >= good else depth
            edges["nice_at_start"] += bl0 >= nice_eff
            edges["quartered"] += bl0 >= good and bl0 < nice_eff
            bl, bd, d, top = bl0, 0, 0, rank[i] - 1
            while bl < nice_eff:
                live, ml = [], []
                for j in range(32):  # the live lanes are a prefix
                    k = top - j
                    if k < first[i] or d + j >= budget:
                        edges["budget_mid"] += 0 < j and k >= first[i]
                        break
                    if i - S[k] > tdk.MAX_DIST:
                        edges["window_mid"] += 0 < j
                        break
                    c = S[k]
                    live.append(c)
                    ml.append(_match_len(buf, i, c, cap) if buf[c + bl] == buf[i + bl] else 0)
                if not live:
                    break
                hit = [j for j, m in enumerate(ml) if m >= nice_eff]
                used = hit[0] + 1 if hit else len(live)
                edges["nice_mid"] += 1 < used < len(live)
                m = max(ml[:used])
                if m > bl:
                    edges["tie"] += ml[:used].count(m) > 1
                    bl, bd = m, i - live[ml.index(m)]
                d += used
                if used < 32 or d >= budget:
                    break
                top -= 32
            visits += d
            edges["too_far"] += bl == tdk.MIN_MATCH and bd > tdk.TOO_FAR and bl > bl0
            if bl > bl0 and bl >= tdk.MIN_MATCH and not (bl == tdk.MIN_MATCH and bd > tdk.TOO_FAR):
                blen, bdist = bl, bd
        if avail and blen == 0 and plen >= tdk.MIN_MATCH:
            slot = min(mc, tdk.CAP_M)
            mpos_r[slot] = i - 1
            mld_r[slot] = ((plen - tdk.MIN_MATCH) << 15) | (pdist - 1)
            bad = mc >= tdk.CAP_M
            mc += 1
            i, plen, pdist, avail = i - 1 + plen, 0, 0, False
        else:
            avail = blen >= tdk.MIN_MATCH
            plen, pdist = (blen, bdist) if avail else (0, 0)
            i += 1
    if avail and plen >= tdk.MIN_MATCH and i - 1 + plen <= n_valid:
        slot = min(mc, tdk.CAP_M)
        mpos_r[slot] = i - 1
        mld_r[slot] = ((plen - tdk.MIN_MATCH) << 15) | (pdist - 1)
        bad = bad or mc >= tdk.CAP_M
        mc += 1
    return mc, bad, visits, edges


def _ties(n):
    """'abcd' and one random byte, over and over: many candidates of equal
    length at different distances."""
    rng = np.random.default_rng(11)
    tail = rng.integers(0, 256, n // 5 + 1).tolist()
    return b"".join(b"abcd" + bytes([t]) for t in tail)[:n]


def _small_alphabet(seed, n, letters):
    return np.random.default_rng(seed).integers(0, letters, n).astype(np.uint8).tobytes()


# name: (data, start, ins_from, (depth, nice, good, max_lazy), edges the walk must meet)
GROUP_CASES = {
    "equal_length_ties": (_ties(6000), 1000, 0, (4096, 258, 32, 258), ("tie",)),
    "nice_cut_mid_group": (_small_alphabet(1, 6000, 4), 1000, 0, (4096, 8, 4, 6),
                           ("nice_mid",)),
    "budget_45_and_quartered": (_small_alphabet(2, 6000, 4), 2000, 0, (45, 258, 8, 32),
                                ("budget_mid", "quartered")),
    "window_edge_dict_36k_back": (_small_alphabet(3, 40000, 16), 36000, 0,
                                  (4096, 258, 32, 258), ("window_mid",)),
    "length_3_past_too_far": (_small_alphabet(4, 20000, 64), 8192, 0, (4096, 258, 32, 258),
                              ("too_far",)),
    "pending_reaches_nice_near_n_valid": (_gen(5, n=3000) + b"\x00" * 400, 0, 0,
                                          (1024, 258, 32, 258), ("nice_at_start",)),
    "bash_level8_dict_36k": (_BASH[500_000:540_000], 36000, 0, (1024, 258, 32, 128),
                             ("tie", "window_mid", "too_far", "quartered")),
    "cap_m_overflow": (_small_alphabet(5, 60000, 8), 0, 0, (4, 16, 4, 4), ()),
}


@pytest.mark.parametrize("case", list(GROUP_CASES))
def test_warp_group_pick_equals_serial_walk_and_pallas(case):
    data, start, ins_from, (depth, nice, good, max_lazy), want_edges = GROUP_CASES[case]
    n = len(data)
    row = np.zeros(-(-(n + 16) // 4) * 4, np.uint8)
    row[:n] = np.frombuffer(data, np.uint8)
    plain_m, plain_l, model_m, model_l = (np.zeros(C, np.int64) for _ in range(4))
    knobs = (depth, nice, good, max_lazy)
    serial = tdk._chain_scan_row(row, n, start, ins_from, *knobs, plain_m, plain_l)
    *model, edges = _warp_scan_row(row, n, start, ins_from, *knobs, model_m, model_l)
    for edge in want_edges:
        assert edges[edge] > 0, (edge, edges)
    # nmatch, bad and the candidates visited, then the streams
    assert tuple(model) == serial
    k = min(serial[0], tdk.CAP_M + 1)
    np.testing.assert_array_equal(model_m[:k], plain_m[:k])
    np.testing.assert_array_equal(model_l[:k], plain_l[:k])
    mpos, mld, nmatch, bad = [np.asarray(x)[0] for x in jdk.scan_chunks_pallas(
        jnp.asarray(_words(row[None])), jnp.asarray([n], jnp.int32),
        jnp.asarray([start], jnp.int32), jnp.asarray([ins_from], jnp.int32),
        depth=depth, nice=nice, good=good, max_lazy=max_lazy, interpret=True,
    )]
    assert (int(nmatch), bool(bad)) == (model[0], model[1])
    k = min(model[0], tdk.CAP_M)
    np.testing.assert_array_equal(model_m[:k], mpos[:k])
    np.testing.assert_array_equal(model_l[:k].astype(np.uint32), mld[:k])
    if case == "cap_m_overflow":
        assert model[1] and model[0] > tdk.CAP_M
    else:
        assert not model[1] and model[0] > 50


def test_chain_scan_refuses_an_oversized_buffer():
    w = torch.zeros((1, (tdk.MAX_BUF + 16) // 4 + 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="MAX_BUF"):
        tdk.scan_chunks(w, torch.tensor([100]), 0, 0, depth=8, nice=8)


# ---------------------------------------------------------------------------
# K9
# ---------------------------------------------------------------------------


def _jax_freq(w4, mpos, mld, meta):
    B, W = w4.shape
    call = jax.jit(lambda m, w, p, l: pl.pallas_call(
        jdk._freq_kernel, grid=(B,),
        in_specs=[pl.BlockSpec((1, 1, 8), lambda b: (b, 0, 0)),
                  pl.BlockSpec((1, 1, W), lambda b: (b, 0, 0)),
                  pl.BlockSpec((1, 1, C), lambda b: (b, 0, 0)),
                  pl.BlockSpec((1, 1, C), lambda b: (b, 0, 0))],
        out_specs=pl.BlockSpec((1, 1, 320), lambda b: (b, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((B, 1, 320), jnp.int32),
        interpret=True,
    )(m, w, p, l))
    return np.asarray(call(jnp.asarray(meta[:, None]), jnp.asarray(w4[:, None]),
                           jnp.asarray(mpos[:, None]), jnp.asarray(mld[:, None])))[:, 0]


def test_freq_equals_pallas_with_an_all_literal_lane(batch, k8_ref):
    mpos, mld, nmatch, _bad = k8_ref["level9"]
    nm = nmatch.astype(np.int32).copy()
    nm[1] = 0  # a bad chunk arrives with nmatch = 0: every byte a literal
    meta = np.zeros((4, 8), np.int32)
    meta[:, 0], meta[:, 1], meta[:, 2] = batch["n_valid"], DICT, nm
    ref = _jax_freq(batch["w4"], mpos, mld, meta)
    st = interop.state_from_numpy(
        {"words4": batch["w4"], "mpos": mpos, "mld": mld, "meta": meta}, device="cpu")
    got = tdk.freq(st["words4"], st["mpos"], st["mld"], st["meta"])
    assert got.dtype == torch.int32 and got.shape == (4, 320)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert int(got[1, :256].sum()) == CHUNK and int(got[1, 256:].sum()) == 0
    # each lane counts every byte of its span once, as a literal or a match
    spans = batch["n_valid"] - DICT
    lens = (mld.view(np.uint32) >> 15).astype(np.int64) + 3
    for r in (0, 2, 3):
        assert int(got[r, :256].sum()) + int(lens[r, : nm[r]].sum()) == spans[r]


def test_freq_pack_without_freq_equals_pallas(batch, k8_ref, monkeypatch):
    # freq=None runs K9 inside the composition, as the reference does
    table = np.asarray(jnp.exp2(jnp.arange(16, dtype=jnp.float32))).copy()
    monkeypatch.setattr(td, "EXP2_LEN", torch.from_numpy(table))
    mpos, mld, nmatch, bad = k8_ref["level8"]
    nm_eff = np.where(bad, 0, nmatch).astype(np.int32)
    ref = jdk.freq_pack_chunks_pallas(
        jnp.asarray(batch["buf"]), jnp.asarray(batch["n_valid"]),
        jnp.full((4,), DICT, jnp.int32), jnp.asarray(mpos), jnp.asarray(mld),
        jnp.asarray(nm_eff), None, n_seeds=0, interpret=True,
    )
    st = interop.state_from_numpy(
        {"chunks": batch["buf"], "n_valid": batch["n_valid"], "mpos": mpos, "mld": mld,
         "nmatch": nm_eff}, device="cpu")
    got = tdk.freq_pack_chunks(st["chunks"], st["n_valid"], DICT, st["mpos"], st["mld"],
                               st["nmatch"])
    words, total, ll, dl, pbad = [np.asarray(x) for x in ref]
    np.testing.assert_array_equal(got[1].numpy(), total)
    np.testing.assert_array_equal(got[2].numpy(), ll)
    np.testing.assert_array_equal(got[3].numpy(), dl)
    np.testing.assert_array_equal(got[4].numpy(), pbad)
    for r in range(4):
        nw = int(total[r]) // 32 + 2
        np.testing.assert_array_equal(got[0][r, :nw].numpy().view(np.uint32), words[r, :nw])


# ---------------------------------------------------------------------------
# K9's design (csrc/freq.cu) as a numpy model
# ---------------------------------------------------------------------------

K9_THREADS, K9_PER, K9_STAGE_WORDS = 1024, 4, 16384  # csrc/freq.cu: kThreads, kPer, kStageWords
K9_TILE = K9_THREADS * K9_PER


def _k9_len_code(mlen):
    v = mlen - 3
    if v == 255:
        return 28
    if v < 8:
        return v
    e = v.bit_length() - 3
    return 4 + 4 * e + ((v >> e) & 3)


def _k9_dist_code(dist):
    d = dist - 1
    if d < 4:
        return d
    e = d.bit_length() - 2
    return 2 * (e + 1) + ((d >> e) & 1)


def _k9_row(w4, mpos, mld, meta, edges):
    """One block of csrc/freq.cu on numpy: the staged words of [start,
    n_valid); per tile of K9_TILE gaps (one before each match, the last to
    n_valid) each thread's K9_PER consecutive gaps, their match codes into
    the thread's warp histogram, the block exclusive scan of the thread
    sums that places each gap's literals; each thread's share of the run,
    its first gap by the kernel's binary search, runs of equal bytes as one
    increment; then the warps' histograms summed. Returns int64 [320]."""
    w4 = np.asarray(w4).view(np.uint32)
    mld = np.asarray(mld).view(np.uint32)
    W, C = len(w4), len(mpos)
    n_valid, start, nmatch = int(meta[0]), int(meta[1]), max(int(meta[2]), 0)
    w0 = min(max(start >> 2, 0), W)
    w1 = max(min((n_valid >> 2) + 1, min(W, w0 + K9_STAGE_WORDS)), w0)
    stage = w4[w0:w1].copy()

    def byte_at(p):
        wi = p >> 2
        if w0 <= wi < w1:
            x = int(stage[wi - w0])
        else:
            x = int(w4[min(max(wi, 0), W - 1)])
            edges["unstaged"] += 1
        return (x >> ((p & 3) << 3)) & 0xFF

    slot = lambda k: min(max(k, 0), C - 1)

    def match_end(k):
        return start if k < 0 else int(mpos[slot(k)]) + (int(mld[slot(k)]) >> 15) + 3

    hist = np.zeros((K9_THREADS // 32, 320), np.int64)
    for t0 in range(0, nmatch + 1, K9_TILE):
        edges["tiles"] += 1
        ng = min(K9_TILE, nmatch - t0 + 1)
        a, ln = [0] * ng, [0] * ng
        for j in range(ng):
            k, warp = t0 + j, j // K9_PER // 32
            b = n_valid
            if k < nmatch:
                x = int(mld[slot(k)])
                hist[warp, min(257 + _k9_len_code((x >> 15) + 3), 319)] += 1
                hist[warp, 288 + _k9_dist_code((x & 0x7FFF) + 1)] += 1
                b = int(mpos[slot(k)])
            a[j] = match_end(k - 1)
            ln[j] = max(b - a[j], 0)
            edges["empty"] += ln[j] == 0
        # the block scan of each thread's sum, then the thread's own prefix
        sums = [sum(ln[t : t + K9_PER]) for t in range(0, ng, K9_PER)]
        base = np.concatenate([[0], np.cumsum(sums)]).tolist()
        off = [base[j // K9_PER] + sum(ln[j - j % K9_PER : j]) for j in range(ng)]
        total = base[-1]
        off.append(total)
        assert off == np.concatenate([[0], np.cumsum(ln)]).tolist()
        per = -(-total // K9_THREADS)
        for tid in range(K9_THREADS):
            lo = min(tid * per, total)
            hi = min(lo + per, total)
            if lo >= hi:
                continue
            j, top = 0, ng - 1  # the last gap whose first literal is at or before lo
            while j < top:
                mid = (j + top + 1) >> 1
                if off[mid] <= lo:
                    j = mid
                else:
                    top = mid - 1
            edges["split"] += off[j] < lo  # a gap an earlier thread began
            p, left = a[j] + lo - off[j], off[j + 1] - lo
            run_b = run_n = 0
            for _ in range(lo, hi):
                while left == 0:
                    j += 1
                    p, left = a[j], off[j + 1] - off[j]
                b = byte_at(p)
                if b != run_b and run_n:
                    hist[tid // 32, run_b] += run_n
                    run_n = 0
                run_b = b
                run_n += 1
                edges["runs"] += run_n == 2
                p += 1
                left -= 1
            if run_n:
                hist[tid // 32, run_b] += run_n
    edges["max_gap"] = max(edges["max_gap"], *ln)
    return hist.sum(0)


def _k9_model(w4, mpos, mld, meta):
    edges = dict(tiles=0, empty=0, split=0, runs=0, unstaged=0, max_gap=0)
    got = np.stack([_k9_row(w4[r], mpos[r], mld[r], meta[r], edges) for r in range(len(meta))])
    return got, edges


def _plain_freq(w4, mpos, mld, meta):
    st = interop.state_from_numpy({"w": w4, "p": mpos, "l": mld, "m": meta}, device="cpu")
    return tdk.freq_plain(st["w"], st["p"], st["l"], st["m"]).numpy()


def test_k9_design_model_equals_plain_and_pallas(batch, k8_ref):
    """The level-9 stream of the batch, lane 1 sent in with nmatch = 0."""
    mpos, mld, nmatch, _bad = k8_ref["level9"]
    nm = nmatch.astype(np.int32).copy()
    nm[1] = 0
    meta = np.zeros((4, 8), np.int32)
    meta[:, 0], meta[:, 1], meta[:, 2] = batch["n_valid"], DICT, nm
    got, edges = _k9_model(batch["w4"], mpos, mld, meta)
    np.testing.assert_array_equal(got, _plain_freq(batch["w4"], mpos, mld, meta))
    np.testing.assert_array_equal(got, _jax_freq(batch["w4"], mpos, mld, meta))
    assert edges["tiles"] == 4 and edges["empty"] > 0 and edges["split"] > 0
    assert edges["runs"] > 0 and edges["unstaged"] == 0


def _k9_lanes():
    """Lanes the corpus does not give, in one batch: nmatch = 0 over a gap
    longer than a tile of gaps; a single match of length 258 (code 28) at
    dist 32,768 (code 29); more matches than one tile, a byte apart; empty
    and overlapping gaps (matches out of order, one before `start`); an
    unaligned start and n_valid with literals at both ends."""
    rng = np.random.default_rng(9)
    nbytes = 24_576
    buf = rng.integers(0, 256, (5, nbytes + PAD), dtype=np.uint8)
    buf[:, 1000:3000] = 0  # a run of one byte value
    w4 = _words(buf)
    mpos = np.zeros((5, C), np.int32)
    mld = np.zeros((5, C), np.uint32)
    meta = np.zeros((5, 8), np.int32)
    meta[:, 0], meta[:, 1] = nbytes, 100
    meta[1, 2], mpos[1, 0], mld[1, 0] = 1, 9000, (255 << 15) | 32767
    n2 = K9_TILE + 904
    meta[2, 2] = n2
    mpos[2, :n2] = 100 + 1 + 4 * np.arange(n2)
    mld[2, :n2] = ((np.arange(n2) % 200) << 15) | (np.arange(n2) * 7 % 32768)
    order = [(500, 3, 10), (503, 10, 40), (513, 4, 1), (4000, 20, 300), (2000, 6, 2),
             (60, 8, 50), (6000, 100, 5000)]
    meta[3, 2] = len(order)
    for k, (p, ln, d) in enumerate(order):
        mpos[3, k], mld[3, k] = p, ((ln - 3) << 15) | (d - 1)
    meta[4, 0], meta[4, 1], meta[4, 2] = nbytes - 3, 7, 2
    mpos[4, :2], mld[4, :2] = [20, 5000], [(5 << 15) | 3, (40 << 15) | 2000]
    return w4, mpos, mld.view(np.int32), meta


def test_k9_design_model_on_crafted_lanes_equals_plain_and_pallas():
    w4, mpos, mld, meta = _k9_lanes()
    got, edges = _k9_model(w4, mpos, mld, meta)
    np.testing.assert_array_equal(got, _plain_freq(w4, mpos, mld, meta))
    np.testing.assert_array_equal(got, _jax_freq(w4, mpos, mld, meta))
    assert got[0, :256].sum() == meta[0, 0] - meta[0, 1] and not got[0, 256:].any()
    assert got[1, 257 + 28] == 1 and got[1, 288 + 29] == 1 and got[1, 256:].sum() == 2
    assert got[2, 257:].sum() == 2 * meta[2, 2]
    # lane 3 counts the bytes of [100, 500) and [517, 4000) twice: the gap
    # after its match at 60 (before `start`) runs on to 6000 over them
    spans = [(100, 500), (513 + 4, 4000), (4000 + 20, 2000), (2000 + 6, 60), (60 + 8, 6000),
             (6000 + 100, int(meta[3, 0]))]
    assert got[3, :256].sum() == sum(max(b - a, 0) for a, b in spans)
    assert edges["tiles"] == 1 + 1 + 2 + 1 + 1
    assert edges["max_gap"] > K9_TILE and edges["empty"] >= 3 and edges["unstaged"] > 0
    assert edges["split"] > 100 and edges["runs"] > 0


# ---------------------------------------------------------------------------
# K10
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("w_g", [6, 32])
def test_tab_scan_equals_pallas(batch, w_g):
    knobs = dict(start=DICT, depth=64, nice=128, good=8, max_lazy=16, w_g=w_g)
    ref = jdk.scan_chunks_tab_pallas(
        jnp.asarray(batch["w4"]), jnp.asarray(batch["n_valid"]),
        jnp.asarray(batch["ins_from"]), interpret=True, **knobs,
    )
    st = _state(batch)
    got = tdk.scan_chunks_tab(st["words4"], st["n_valid"], st["ins_from"],
                              bytes_arr=st["chunks"], **knobs)
    _assert_stream_equal(got, ref)
    lens = _assert_byte_valid(got[0][3].numpy(), got[1][3].numpy(), int(got[2][3]),
                              batch["buf"][3].tobytes(), DICT, int(batch["n_valid"][3]))
    assert lens.max() > 4 * w_g  # the long runs were extended past the table cap


def test_tab_scan_overflow_flags_bad_like_pallas():
    # every table entry is a 3-byte match at distance 1 over random bytes:
    # more than CAP_M matches, so the chunk goes bad
    rng = np.random.default_rng(3)
    n = 3 * tdk.CAP_M + 600
    buf = np.zeros((1, n + PAD), np.uint8)
    buf[0, :n] = rng.integers(0, 256, size=n)
    w4 = _words(buf)
    tabn = 4 * w4.shape[1]
    tab = np.full((1, tabn), (3 << 16) | 1, np.int32)
    good, mlazy, nice, _chain = tdk.ZLIB_CONFIG[9]
    meta = np.array([[n, 0, 0, 0, nice, good, mlazy, 0]], np.int32)
    call = jax.jit(lambda m, w, f, q: pl.pallas_call(
        jdk._make_kernel_tab(24), grid=(1,),
        out_shape=[
            jax.ShapeDtypeStruct((1, 1, C), jnp.int32),
            jax.ShapeDtypeStruct((1, 1, C), jnp.uint32),
            jax.ShapeDtypeStruct((1, 1, 8), jnp.int32),
        ],
        interpret=True,
    )(m, w, f, q))
    ref = [np.asarray(x)[:, 0] for x in call(
        jnp.asarray(meta[:, None]), jnp.asarray(w4[:, None]),
        jnp.asarray(tab[:, None]), jnp.asarray(tab[:, None]),
    )]
    t = torch.from_numpy(tab)
    mpos, mld, st = [x.numpy() for x in tdk.tab_scan(
        torch.from_numpy(w4.view(np.int32)), t, t, torch.tensor([n]), 0,
        nice=nice, good=good, max_lazy=mlazy,
    )]
    assert st[0, 1] == 1 and ref[2][0, 1] == 1
    np.testing.assert_array_equal(st[:, :2], ref[2][:, :2])
    np.testing.assert_array_equal(mpos[:, : tdk.CAP_M], ref[0][:, : tdk.CAP_M])
    np.testing.assert_array_equal(mld[:, : tdk.CAP_M].view(np.uint32), ref[1][:, : tdk.CAP_M])


# ---------------------------------------------------------------------------
# Mirrors of tests/test_lzvec.py on the port
# ---------------------------------------------------------------------------


def _one_chunk(data: bytes):
    w4 = _words(np.frombuffer(data + bytes(-len(data) % 4), np.uint8)[None])
    z = torch.zeros(1, dtype=torch.int32)
    return torch.from_numpy(w4.view(np.int32)), torch.tensor([len(data)], dtype=torch.int32), z


@pytest.mark.parametrize("seed", [0, 3])
def test_precise_tab_scan_equals_chain_scan(seed):
    """With byte-exact table lengths and every true match below the table
    cap, the table walk reproduces the hash-chain scan's stream."""
    w4, nv, z = _one_chunk(_gen(seed))
    knobs = dict(depth=128, nice=128, good=8, max_lazy=16)
    chain = tdk.scan_chunks(w4, nv, z, z, **knobs)
    tab = tdk.scan_chunks_tab(w4, nv, z, start=0, w_g=16, precise=True, **knobs)
    assert not bool(chain[3][0]) and not bool(tab[3][0])
    n = int(chain[2][0])
    assert n == int(tab[2][0]) > 0
    assert torch.equal(chain[0][0, :n], tab[0][0, :n])
    assert torch.equal(chain[1][0, :n], tab[1][0, :n])


def test_tab_route_stream_equals_hop_route(monkeypatch):
    """The hop chase's literal histogram equals K9's, and both routes share
    the parse: level 6 under ZRS_TPU_HOPSCAN=0 gives the hop route's bytes."""
    data = (_gen(21, n=40000, maxcopy=120) + b"\x00" * 5000 + (b"repeat!" * 3000)
            + _gen(22, n=20000))
    monkeypatch.setenv("ZRS_TPU_KERNEL", "1")
    monkeypatch.setenv("ZRS_TPU_HOPSCAN", "1")
    hop = compress_parallel(data, 6, device="cpu")
    monkeypatch.setenv("ZRS_TPU_HOPSCAN", "0")
    tab = compress_parallel(data, 6, device="cpu")
    assert zlib.decompress(hop) == data
    assert hop == tab


@pytest.mark.parametrize("level", [7, 8, 9])
def test_deep_levels_round_trip(level, monkeypatch):
    monkeypatch.setenv("ZRS_TPU_KERNEL", "1")
    data = _gen(31, n=20000, maxcopy=100) + b"x" * 2000
    out = compress_parallel(data, level, chunk_size=16 * 1024, device="cpu")
    assert zlib.decompress(out) == data


@pytest.mark.parametrize("wrapper", ["chain_scan_cuda", "tab_scan_cuda", "freq_cuda"])
def test_new_kernel_wrappers_refuse_cpu_tensors(wrapper):
    z = torch.zeros((1, 8), dtype=torch.int32)
    n = torch.zeros(1, dtype=torch.int32)
    call = {
        "chain_scan_cuda": lambda: tdk.chain_scan_cuda(z, n, n, n, depth=8, nice=8, good=4,
                                                       max_lazy=4),
        "tab_scan_cuda": lambda: tdk.tab_scan_cuda(z, z, z, n, 0, nice=8, good=4, max_lazy=4),
        "freq_cuda": lambda: tdk.freq_cuda(z, z, z, z),
    }[wrapper]
    with pytest.raises(RuntimeError, match="CUDA"):
        call()


# -- K10's design, as a numpy model ----------------------------------------
#
# K10 on the card (csrc/tab_scan.cu) resolves every position of a tile at
# once: a stop into a slot holding the match its deferral chain leaves (h,
# the extended length, the dist), then a literal into the distance to the
# next stop of its warp's segment, found backward 32 positions at a time;
# then the block chases the slots, one segment a thread, to a fixed point
# or a one-thread fix-up. The model below is that design; it counts the edges it
# meets, so each case can show that its edge occurred.

STOP = 1 << 31
M32 = 0xFFFFFFFF
ROUNDS = 6  # chase rounds before the sequential fix-up
TAB_EDGES = ("tabq", "too_far", "max_h", "serial", "tiles", "rounds", "fixup",
             "literal_to_edge", "match_ends_on_edge")


def _tab_resolve(w, tf, tq, nv, start, p, knobs, edges):
    """The clean-arrival outcome at p: None for a literal, else (pos, exact
    len, dist) of the match its deferral chain leaves."""
    nice, good, max_lazy = knobs
    W, tabn = len(w), len(tf)

    def tab(t, q):
        return t[min(max(q - start, 0), tabn - 1)]

    def get32(q):
        wi, sh = q >> 2, (q & 3) << 3
        w0 = w[min(max(wi, 0), W - 1)]
        return w0 if sh == 0 else ((w0 >> sh) | (w[min(max(wi + 1, 0), W - 1)] << (32 - sh))) & M32

    cap = min(nv - p, tdk.MAX_MATCH)
    t = tab(tf, p)
    m, d = min(t >> 16, cap), t & 0xFFFF
    far = m == tdk.MIN_MATCH and d > tdk.TOO_FAR
    if not (0 < min(nice, cap) and m >= tdk.MIN_MATCH and not far):
        edges["too_far"] += far and 0 < min(nice, cap)
        return None
    plen, pdist, q = m, d, p + 1
    while True:
        assert q < nv  # every pending match is decided before n_valid
        cap = min(nv - q, tdk.MAX_MATCH)
        edges["tabq"] += plen >= good
        t = tab(tq if plen >= good else tf, q)
        m = min(t >> 16, cap)
        if not (plen < max_lazy and plen < min(nice, cap) and m > plen):
            break
        plen, pdist, q = m, t & 0xFFFF, q + 1
    pos = q - 1
    cap = min(nv - pos, tdk.MAX_MATCH)
    k = plen
    while k < cap and get32(pos + k) == get32(pos - pdist + k):
        k += 4
    k = min(k, cap)
    x = get32(pos + k) ^ get32(pos - pdist + k)
    edges["max_h"] = max(edges["max_h"], pos - p)
    return pos, min(k + (tdk._tail(x) if x else 0), cap), pdist


def _tab_tile(resolve, t0, tn, nv, edges, warps=16):
    """The tile's slots as the kernel writes them, in two passes. First
    every position, strided over the block: a stop's slot is STOP | h << 23
    | (len - 3) << 15 | (dist - 1), or 0 when the dist does not fit; a
    literal gets 1. Then each warp walks its segment of whole groups of 32
    backward: a literal's slot becomes the distance to the next stop (the
    lowest lane of the group's stop ballot above it, else the carry from
    the groups after it, else the segment's end)."""
    R = [1] * tn
    for k in range(tn):
        r = resolve(t0 + k)
        if r is not None:
            pos, ln, dist = r
            R[k] = (STOP | (pos - t0 - k) << 23 | (ln - tdk.MIN_MATCH) << 15 | (dist - 1)
                    if 1 <= dist <= 32768 else 0)
    seg = -(-tn // (warps * 32)) * 32
    for wp in range(warps):
        s0 = min(wp * seg, tn)
        s1 = min(s0 + seg, tn)
        carry = s1
        for gb in range(s0 + (s1 - s0 - 1) // 32 * 32, s0 - 1, -32) if s1 > s0 else ():
            lanes = range(gb, min(gb + 32, s1))
            mask = sum(1 << (k - gb) for k in lanes if R[k] != 1)
            for k in lanes:
                if R[k] == 1:
                    above = mask & (M32 << (k - gb)) & M32
                    nxt = gb + (above & -above).bit_length() - 1 if above else carry
                    R[k] = nxt - k
                    edges["literal_to_edge"] += nxt == tn and t0 + tn < nv
            if mask:
                carry = gb + (mask & -mask).bit_length() - 1
    return R


def _tab_step(R, t0, p):
    s = R[p - t0]
    if s & STOP:
        pos = p + ((s >> 23) & 0xFF)
        return pos + ((s >> 15) & 0xFF) + tdk.MIN_MATCH, (pos, s & 0x7FFFFF)
    return (p + s, None) if s else (-1, None)


def _segment_chase(step, t0, tn, edges, threads=512):
    """The tile's chase as the kernel's threads run it (K12's, see
    tests/test_torch_hop_il.py): rounds of segment walks to a fixed point,
    else a fix-up in order. Returns (entries, ends, exits, counts) or None
    if a walk met the serial walk's position."""
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


def _tab_model_row(w, tf, tq, nv, start, knobs, tile, mpos_r, mld_r, edges):
    """One chunk as K10's block parses it: (nmatch, bad)."""
    resolve = lambda p: _tab_resolve(w, tf, tq, nv, start, p, knobs, edges)
    t0, mc = start, 0
    while t0 < nv:
        tn = min(nv - t0, tile)
        R = _tab_tile(resolve, t0, tn, nv, edges)
        edges["tiles"] += 1
        chased = _segment_chase(lambda p: _tab_step(R, t0, p), t0, tn, edges)
        if chased is None:  # the walk, by one thread, to the end of the span
            edges["serial"] += 1
            i, bad = t0, False
            while i < nv and not bad:
                r = resolve(i)
                if r is None:
                    i += 1
                    continue
                pos, ln, dist = r
                slot = min(mc, tdk.CAP_M)
                mpos_r[slot] = pos
                mld_r[slot] = (((ln - tdk.MIN_MATCH) << 15) | ((dist - 1) & M32)) & M32
                bad = mc >= tdk.CAP_M
                mc += 1
                i = pos + ln
            return mc, bad
        frm, hi, exits, cnt = chased
        j = mc
        for k in range(len(frm)):  # the prefix sum of the counts and the last walk
            p = frm[k]
            while p < hi[k] and j <= tdk.CAP_M:
                p, m = _tab_step(R, t0, p)
                if m is not None:
                    mpos_r[j], mld_r[j] = m  # slot CAP_M takes the overflowing match
                    j += 1
        mc += sum(cnt)
        if mc > tdk.CAP_M:
            return tdk.CAP_M + 1, True
        k = (tn - 1) // -(-tn // len(frm))  # the last segment that is not empty
        p, last = frm[k], None
        while p < hi[k]:  # how it leaves the tile
            p, last = _tab_step(R, t0, p)
        edge, t0 = t0 + tn, exits[-1]
        edges["match_ends_on_edge"] += t0 == edge < nv and last is not None
    return mc, False


def _tab_model(w4, tf, tq, n_valid, start, knobs, tile):
    """The design over a batch: (mpos, mld, st) as int64 arrays and the
    edges met."""
    B = w4.shape[0]
    mpos, mld, st = np.zeros((B, C), np.int64), np.zeros((B, C), np.int64), np.zeros((B, 8), np.int64)
    edges = dict.fromkeys(TAB_EDGES, 0)
    for r in range(B):
        st[r, :2] = _tab_model_row(w4[r].tolist(), tf[r].tolist(), tq[r].tolist(), int(n_valid[r]),
                                   start, knobs, tile, mpos[r], mld[r], edges)
    return mpos, mld, st, edges


def _jax_tab_lanes(w4, tf, tq, n_valid, start, knobs, cap_g):
    """The JAX K10 body in interpret mode, one lane a call, on given
    tables (indexed by position - start)."""
    nice, good, mlazy = knobs
    call = jax.jit(lambda m, w, f, q: pl.pallas_call(
        jdk._make_kernel_tab(cap_g), grid=(1,),
        out_shape=[jax.ShapeDtypeStruct((1, 1, C), jnp.int32),
                   jax.ShapeDtypeStruct((1, 1, C), jnp.uint32),
                   jax.ShapeDtypeStruct((1, 1, 8), jnp.int32)],
        interpret=True,
    )(m, w, f, q))
    out = []
    for r in range(w4.shape[0]):
        meta = np.array([[int(n_valid[r]), start, 0, 0, nice, good, mlazy, 0]], np.int32)
        out.append([np.asarray(x)[0, 0] for x in call(
            jnp.asarray(meta[:, None]), jnp.asarray(w4[r : r + 1, None]),
            jnp.asarray(tf[r : r + 1, None]), jnp.asarray(tq[r : r + 1, None]))])
    return [np.stack([o[k] for o in out]) for k in range(3)]


def _crafted_tab(case):
    """(words u32, tabf, tabq, n_valid, knobs, cap_g, tile, edges) of the
    crafted K10 lanes; start is 0."""
    l9 = tuple(tdk.ZLIB_CONFIG[9][i] for i in (2, 0, 1))  # nice, good, max_lazy
    rng = np.random.default_rng(3)
    if case == "staircase_h_255":
        # zeros, and table lengths that grow by one a position from 3 to
        # 258: a deferral chain of 255 steps at max_lazy = 258
        n = 9000
        buf = np.zeros((1, n + PAD), np.uint8)
        buf[0, n - 500 :] = rng.integers(0, 256, 500 + PAD)
        w4 = _words(buf)
        p = np.arange(4 * w4.shape[1])
        tab = ((np.minimum(3 + p % 300, 258) << 16) | 1)[None].astype(np.int32)
        return w4, tab, tab, np.array([n], np.int32), l9, 24, 4000, ("max_h",)
    if case == "overflow_past_one_tile":
        n = 3 * tdk.CAP_M + 600
        buf = np.zeros((1, n + PAD), np.uint8)
        buf[0, :n] = rng.integers(0, 256, size=n)
        w4 = _words(buf)
        tab = np.full((1, 4 * w4.shape[1]), (3 << 16) | 1, np.int32)
        return w4, tab, tab, np.array([n], np.int32), l9, 24, 5000, ("tiles", "match_ends_on_edge")
    if case == "all_literal":
        n = np.array([5001, 6002, 7003], np.int32)
        buf = np.zeros((3, 7004 + PAD), np.uint8)
        buf[:, :7003] = rng.integers(0, 256, size=(3, 7003))
        w4 = _words(buf)
        tab = np.zeros((3, 4 * w4.shape[1]), np.int32)
        return w4, tab, tab, n, l9, 24, 2048, ("tiles", "literal_to_edge")
    raise KeyError(case)


K10_CASES = ["bash_level6_wg6", "bash_level6_wg32_tiles_of_1024", "level9_chain256_max_lazy_258",
             "far_dist_serial", "staircase_h_255", "overflow_past_one_tile", "all_literal"]


def _assert_tab_equal(model, ref, slots):
    mpos, mld, st, _ = model
    rm, rl, rs = [np.asarray(x) for x in ref]
    np.testing.assert_array_equal(st[:, :2], rs[:, :2])
    for r in range(st.shape[0]):
        k = min(int(st[r, 0]), slots)
        np.testing.assert_array_equal(mpos[r, :k], rm[r, :k])
        np.testing.assert_array_equal(mld[r, :k].astype(np.uint32), rl[r, :k].astype(np.uint32))


@pytest.mark.parametrize("case", K10_CASES)
def test_resolved_tab_chase_model_equals_plain_and_pallas(batch, case):
    jax_ref = None
    if case.startswith("bash") or case in ("level9_chain256_max_lazy_258", "far_dist_serial"):
        level9 = case == "level9_chain256_max_lazy_258"
        good, mlazy, nice, _ = tdk.ZLIB_CONFIG[9 if level9 else 6]
        depth, w_g = (256, 6) if level9 else (64, 32 if "wg32" in case else 6)
        knobs, start, tile = (nice, good, mlazy), DICT, 1024 if "1024" in case else tdk.TILE
        st = _state(batch)
        tabf, tabq = lzvec.build_match_tables(st["words4"], st["n_valid"], st["ins_from"],
                                              depth=depth, nice=nice, w_g=w_g,
                                              bytes_arr=st["chunks"])
        tf, tq = tabf[:, DICT:].numpy(), tabq[:, DICT:].numpy()
        w4, nv = batch["w4"], batch["n_valid"]
        want = {"bash_level6_wg6": ("too_far", "tabq"), "far_dist_serial": ("serial",),
                "bash_level6_wg32_tiles_of_1024": ("tiles", "literal_to_edge", "fixup"),
                # tables cap lengths at 4 * w_g = 24 here, below good = 32: tabq unread
                "level9_chain256_max_lazy_258": ("too_far", "fixup")}[case]
        if case == "far_dist_serial":  # every dist past the window: 0xFFFF
            tf, tq = np.where(tf != 0, tf | 0xFFFF, 0), np.where(tq != 0, tq | 0xFFFF, 0)
        else:
            jax_ref = [np.asarray(x) for x in jdk.scan_chunks_tab_pallas(
                jnp.asarray(w4), jnp.asarray(nv), jnp.asarray(batch["ins_from"]), start=DICT,
                depth=depth, nice=nice, good=good, max_lazy=mlazy, w_g=w_g, interpret=True)]
            jax_ref = [jax_ref[0], jax_ref[1], np.stack([jax_ref[2], jax_ref[3]], 1)]
    else:
        w4, tf, tq, nv, knobs, cap_g, tile, want = _crafted_tab(case)
        start = 0
        jax_ref = _jax_tab_lanes(w4, tf, tq, nv, start, knobs, cap_g)
    model = _tab_model(w4, tf, tq, nv, start, knobs, tile)
    edges = model[3]
    for edge in want:
        assert edges[edge] > 0, (edge, edges)
    assert edges["max_h"] >= 128 or case != "staircase_h_255"
    assert edges["serial"] == 0 or case == "far_dist_serial"
    plain = tdk.tab_scan_plain(torch.from_numpy(w4.view(np.int32)), torch.from_numpy(tf),
                               torch.from_numpy(tq), torch.from_numpy(nv), start, nice=knobs[0],
                               good=knobs[1], max_lazy=knobs[2])
    _assert_tab_equal(model, [t.numpy() for t in plain], tdk.CAP_M + 1)
    if jax_ref is not None:
        _assert_tab_equal(model, jax_ref, tdk.CAP_M)
    if case == "overflow_past_one_tile":
        assert model[2][0, 1] == 1
