"""K2 (hop chase) and K3 (bit pack) of the port, as their plain PyTorch
versions, against the JAX package's Pallas kernels in interpret mode.

Each kernel is fed the JAX package's own upstream state through
`zlib_rs_tpu_torch.interop` (its htab for the chase, its match stream and
code tables for the pack), so a kernel difference is never confused with
an upstream one. Integer codec: every comparison is exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from zlib_rs_tpu.ops import dynhuff as jd
from zlib_rs_tpu.ops import lzvec as jl
from zlib_rs_tpu.ops.pallas import deflate_kernel as jdk
from zlib_rs_tpu_torch import interop
from zlib_rs_tpu_torch.ops import dynhuff as td
from zlib_rs_tpu_torch.ops.kernels import deflate_kernel as tdk

# the test workers share the cores, and an oversubscribed OpenMP pool spin-waits
torch.set_num_threads(1)

_BASH = open("/bin/bash", "rb").read()
PAD = 272
DICT, CHUNK = 4096, 8192
L6 = dict(depth=64, nice=128, good=8, max_lazy=16, w_g=6)
SEL = np.r_[0:286, 288:318]  # the histogram bins anything downstream reads


@pytest.fixture
def xla_exp2(monkeypatch):
    table = np.asarray(jnp.exp2(jnp.arange(16, dtype=jnp.float32))).copy()
    monkeypatch.setattr(td, "EXP2_LEN", torch.from_numpy(table))


def _words(buf):
    B = buf.shape[0]
    bb = buf.reshape(B, -1, 4).astype(np.uint32)
    w4 = bb[..., 0] | (bb[..., 1] << 8) | (bb[..., 2] << 16) | (bb[..., 3] << 24)
    return np.concatenate([w4, np.zeros((B, 2), np.uint32)], axis=1)


@pytest.fixture(scope="module")
def batch():
    """Three dictionary-primed chunks cut from /bin/bash (no dict, full
    dict, a short last chunk), the JAX hop tables and the JAX chase."""
    rng = np.random.default_rng(2024)
    width = DICT + CHUNK + PAD
    ins_from = np.array([DICT, 0, 0], np.int32)
    data_len = np.array([CHUNK, CHUNK, 3001], np.int32)
    buf = np.zeros((3, width), np.uint8)
    for r in range(3):
        off = int(rng.integers(0, len(_BASH) - width))
        n = DICT + int(data_len[r])
        buf[r, ins_from[r] : n] = np.frombuffer(_BASH[off + ins_from[r] : off + n], np.uint8)
    n_valid = (data_len + DICT).astype(np.int32)
    w4 = _words(buf)
    htab = np.asarray(jl.build_hop_tables(
        jnp.asarray(w4), jnp.asarray(n_valid), jnp.asarray(ins_from),
        bytes_arr=jnp.asarray(buf), **L6,
    ))
    chase = [np.asarray(x) for x in jdk.scan_chunks_hop_pallas(
        jnp.asarray(w4), jnp.asarray(n_valid), jnp.asarray(ins_from),
        start=DICT, interpret=True, bytes_arr=jnp.asarray(buf), **L6,
    )]
    return dict(buf=buf, w4=w4, n_valid=n_valid, ins_from=ins_from,
                htab=htab, chase=chase)


def _assert_chase_equal(got, ref):
    mpos, mld, nmatch, kbad, freq = ref
    tm, tl, tn, tk, tf = [t.numpy() for t in got]
    np.testing.assert_array_equal(tn, nmatch)
    np.testing.assert_array_equal(tk, kbad)
    for r in range(len(nmatch)):
        k = int(nmatch[r])
        np.testing.assert_array_equal(tm[r, :k], mpos[r, :k])
        np.testing.assert_array_equal(tl[r, :k].view(np.uint32), mld[r, :k])
    np.testing.assert_array_equal(tf[:, SEL], freq[:, SEL])


def test_chase_of_the_jax_htab_equals_pallas(batch):
    st = interop.state_from_numpy(
        {"words4": batch["w4"], "htab": batch["htab"], "n_valid": batch["n_valid"]},
        device="cpu",
    )
    raw = tdk.hop_chase(st["words4"], st["htab"], st["n_valid"], DICT, 4 * L6["w_g"])
    assert [t.dtype for t in raw] == [torch.int32] * 4
    assert raw[0].shape == (3, tdk.CAP_M + 8) and raw[3].shape == (3, 4 * 320)
    _assert_chase_equal(tdk._hop_post(*raw), batch["chase"])
    assert batch["chase"][2].min() > 100  # real parses, not all-literal


def test_scan_chunks_hop_end_to_end_equals_pallas(batch):
    got = tdk.scan_chunks_hop(
        torch.from_numpy(batch["w4"].view(np.int32)),
        torch.from_numpy(batch["n_valid"]), torch.from_numpy(batch["ins_from"]),
        start=DICT, bytes_arr=torch.from_numpy(batch["buf"]), **L6,
    )
    _assert_chase_equal(got, batch["chase"])


def test_chase_overflow_flags_bad_and_recounts_literals():
    # every position after the first is a 3-byte match at distance 1 over
    # random bytes: more than CAP_M matches, so the chunk goes bad
    rng = np.random.default_rng(3)
    n = 3 * tdk.CAP_M + 600
    buf = np.zeros((1, n + PAD), np.uint8)
    buf[0, :n] = rng.integers(0, 256, size=n)
    w4 = _words(buf)
    htab = np.full((1, 4 * w4.shape[1]), (1 << 30) | (3 << 16) | 1, np.int32)
    htab[0, 0] = 1  # a literal, then the match stops
    n_valid = np.array([n], np.int32)
    meta = np.array([[n, 0, 0, 0, 0, 0, 0, 0]], np.int32)
    call = jax.jit(lambda m, w, h: pl.pallas_call(
        jdk._make_kernel_hop(24), grid=(1,),
        out_shape=[
            jax.ShapeDtypeStruct((1, 1, tdk.CAP_M + 8), jnp.int32),
            jax.ShapeDtypeStruct((1, 1, tdk.CAP_M + 8), jnp.uint32),
            jax.ShapeDtypeStruct((1, 1, 8), jnp.int32),
            jax.ShapeDtypeStruct((1, 1, 4 * 320), jnp.int32),
        ],
        interpret=True,
    )(m, w, h))
    ref = [np.asarray(x)[:, 0] for x in call(
        jnp.asarray(meta[:, None]), jnp.asarray(w4[:, None]), jnp.asarray(htab[:, None])
    )]
    raw = tdk.hop_chase(torch.from_numpy(w4.view(np.int32)), torch.from_numpy(htab),
                        torch.from_numpy(n_valid), 0, 24)
    mpos, mld, st, freq = [t.numpy() for t in raw]
    assert st[0, 1] == 1 and ref[2][0, 1] == 1
    np.testing.assert_array_equal(st[:, :2], ref[2][:, :2])
    np.testing.assert_array_equal(freq, ref[3])
    np.testing.assert_array_equal(mpos[:, : tdk.CAP_M], ref[0][:, : tdk.CAP_M])


def _jax_tables(ll_lens, d_lens):
    """The code tables (code | nbits << 16) the JAX pack consumed, from
    the lengths it echoed."""
    B = ll_lens.shape[0]
    llc = np.asarray(jax.vmap(jd.canonical_codes_jax)(jnp.asarray(ll_lens)))
    dc = np.asarray(jax.vmap(jd.canonical_codes_jax)(jnp.asarray(d_lens)))
    lltab = np.zeros((B, 288), np.uint32)
    dtab = np.zeros((B, 32), np.uint32)
    lltab[:, :286] = llc.astype(np.uint32) | (ll_lens.astype(np.uint32) << 16)
    dtab[:, :30] = dc.astype(np.uint32) | (d_lens.astype(np.uint32) << 16)
    return lltab, dtab


def _assert_pack_equal(got, ref, n_seeds):
    words, total, ll, dl = [np.asarray(x) for x in ref[:4]]
    tw, tt, tll, tdl = [t.numpy() for t in got[:4]]
    np.testing.assert_array_equal(tt, total)
    np.testing.assert_array_equal(got[-1].numpy(), np.asarray(ref[-1]))
    np.testing.assert_array_equal(tll, ll)
    np.testing.assert_array_equal(tdl, dl)
    for r in range(len(total)):
        nw = int(total[r]) // 32 + 2  # through the last bit, plus the slack word
        np.testing.assert_array_equal(tw[r, :nw].view(np.uint32), words[r, :nw])
        assert words[r, nw - 1] == 0 or int(total[r]) % 32 == 0
    if n_seeds:
        np.testing.assert_array_equal(got[4].numpy(), np.asarray(ref[4]))
        np.testing.assert_array_equal(got[5].numpy(), np.asarray(ref[5]))


@pytest.mark.parametrize("n_seeds", [0, 128])
def test_pack_of_the_jax_match_stream_equals_pallas(batch, n_seeds):
    mpos, mld, nmatch, kbad, freq = batch["chase"]
    nm_eff = np.where(kbad, 0, nmatch).astype(np.int32)
    start = np.full(3, DICT, np.int32)
    ref = jdk.freq_pack_chunks_pallas(
        jnp.asarray(batch["buf"]), jnp.asarray(batch["n_valid"]), jnp.asarray(start),
        jnp.asarray(mpos), jnp.asarray(mld), jnp.asarray(nm_eff), jnp.asarray(freq),
        n_seeds=n_seeds, interpret=True,
    )
    lltab, dtab = _jax_tables(np.asarray(ref[2]), np.asarray(ref[3]))
    st = interop.state_from_numpy({
        "chunks": batch["buf"], "n_valid": batch["n_valid"], "mpos": mpos,
        "mld": mld, "nmatch": nm_eff, "lltab": lltab, "dtab": dtab,
    }, device="cpu")
    got = tdk.pack_chunks(
        st["chunks"], st["n_valid"], DICT, st["mpos"], st["mld"], st["nmatch"],
        st["lltab"], st["dtab"], n_seeds=n_seeds,
    )
    assert len(got) == len(ref)
    _assert_pack_equal(got, ref, n_seeds)


def test_freq_pack_with_trees_equals_pallas(batch, xla_exp2):
    mpos, mld, nmatch, kbad, freq = batch["chase"]
    nm_eff = np.where(kbad, 0, nmatch).astype(np.int32)
    ref = jdk.freq_pack_chunks_pallas(
        jnp.asarray(batch["buf"]), jnp.asarray(batch["n_valid"]),
        jnp.full((3,), DICT, jnp.int32), jnp.asarray(mpos), jnp.asarray(mld),
        jnp.asarray(nm_eff), jnp.asarray(freq), n_seeds=0, interpret=True,
    )
    st = interop.state_from_numpy(
        {"mpos": mpos, "mld": mld, "nmatch": nm_eff, "freq": freq,
         "n_valid": batch["n_valid"]}, device="cpu",
    )
    got = tdk.freq_pack_chunks(
        torch.from_numpy(batch["buf"]), st["n_valid"], DICT, st["mpos"],
        st["mld"], st["nmatch"], st["freq"],
    )
    _assert_pack_equal(got, ref, 0)


def test_length_and_distance_symbols_equal_jax():
    ml = np.arange(3, 259, dtype=np.int32)
    dd = np.arange(1, 32769, dtype=np.int32)
    for got, ref in zip(tdk._len_sym(torch.from_numpy(ml)), jdk._len_sym(jnp.asarray(ml))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    for got, ref in zip(tdk._dist_sym(torch.from_numpy(dd)), jdk._dist_sym(jnp.asarray(dd))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_interop_round_trip():
    rng = np.random.default_rng(0)
    arrays = {
        "words4": rng.integers(0, 2**32, size=(2, 9), dtype=np.uint32),
        "mld": rng.integers(0, 2**32, size=(2, 5), dtype=np.uint32),
        "mpos": rng.integers(0, 2**16, size=(2, 5)).astype(np.int32),
        "kbad": np.array([True, False]),
        "nmatch": np.array([3, 4], np.int64),
        "chunks": rng.integers(0, 256, size=(2, 12), dtype=np.uint8),
    }
    st = interop.state_from_numpy(arrays, device="cpu")
    assert st["words4"].dtype == torch.int32 and st["kbad"].dtype == torch.bool
    assert st["chunks"].dtype == torch.uint8
    back = interop.state_to_numpy(st)
    for k, a in arrays.items():
        np.testing.assert_array_equal(back[k], a)
    assert back["words4"].dtype == np.uint32 and back["mld"].dtype == np.uint32
    with pytest.raises(ValueError):
        interop.state_from_numpy({"x": np.array([2**40])}, device="cpu")


def test_interop_without_device_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        interop.state_from_numpy({"nmatch": np.array([1], np.int32)})


def test_kernel_wrappers_refuse_cpu_tensors():
    z = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="CUDA"):
        tdk.hop_chase_cuda(z, z, torch.zeros(1, dtype=torch.int32), 0, 24)
    with pytest.raises(RuntimeError, match="CUDA"):
        tdk.pack_cuda(z, z, z, z, z, z, 8, 0)


# ---------------------------------------------------------------------------
# K3's block-parallel design (csrc/pack.cu) as a numpy model
# ---------------------------------------------------------------------------

K3_THREADS, K3_SEG = 1024, 32  # csrc/pack.cu: kThreads, kSeg
_MATCH = 1 << 31
_M32 = 0xFFFFFFFF


def _k3_match_code(x):
    """A match's code in the tile: _MATCH | lc | lev << 5 | dc << 10 |
    dev << 15, its length and distance symbols, from its mld."""
    v = x >> 15
    if v < 8:
        lc, lev = v, 0
    elif v == 255:
        lc, lev = 28, 0
    else:
        e = v.bit_length() - 3
        lc, lev = min(4 + 4 * e + ((v >> e) & 3), 30), v & ((1 << e) - 1)
    d = x & 0x7FFF
    if d < 4:
        dc, dv = d, 0
    else:
        e = d.bit_length() - 2
        dc, dv = 2 * (e + 1) + ((d >> e) & 1), d & ((1 << e) - 1)
    return _MATCH | lc | lev << 5 | dc << 10 | dv << 15


def _k3_walk(codes, i0, i1, t0, cover, ll, dd):
    """The tokens of tile positions [i0, i1), [(position, fields)], each
    field (value, nbits), with `cover` the end of the matches before them;
    and the end after them. A match's fields and length come back from its
    symbols."""
    toks = []
    for i in range(i0, i1):
        c, p = codes[i], t0 + i
        if c & _MATCH:
            lc, lev, dc, dv = c & 31, (c >> 5) & 31, (c >> 10) & 31, (c >> 15) & 0x1FFF
            leb = 0 if lc < 8 or lc == 28 else (lc - 4) >> 2
            deb = (dc >> 1) - 1 if dc >= 4 else 0
            e1, e2 = ll[257 + lc], dd[dc]
            toks.append((p, [((e1 & 0xFFFF) | (lev << (e1 >> 16)), (e1 >> 16) + leb),
                             ((e2 & 0xFFFF) | (dv << (e2 >> 16)), (e2 >> 16) + deb)]))
            base = lc if lc < 8 else (255 if lc == 28 else (4 + ((lc - 4) & 3)) << leb)
            cover = max(cover, p + base + lev + 3)
        elif p >= cover:
            toks.append((p, [(ll[c] & 0xFFFF, ll[c] >> 16)]))
    return toks, cover


def _k3_row(byts, mp, md, meta, ll, dd, oww, ns, threads, seg, edges):
    """One block of csrc/pack.cu: tiles of threads * seg positions, each
    classified, counted (two exclusive scans) and emitted segment by
    segment into a zeroed word buffer; then EOB and the unreached seeds."""
    n_valid, start, nmatch, n_seeds, stride = (int(x) for x in meta[:5])
    nmatch, n_seeds, stride = min(nmatch, len(mp)), min(n_seeds, ns), max(stride, 1)
    tile, stage_words = threads * seg, threads * seg // 2 + 8
    out, sb, so = [0] * oww, [0] * ns, [0] * ns
    bit0 = cover = k0 = carry = 0
    last = -1
    for t0 in range(start, n_valid, tile):
        n = min(tile, n_valid - t0)
        edges["tiles"] += 1
        # 1. classify: bytes, then each match at its start; a thread steps
        # k by the block width until a start lies past the tile
        codes = [int(b) for b in byts[t0 : t0 + n]]
        seg_end, kmin, pre = [0] * threads, nmatch, 0
        for th in range(threads):
            for k in range(k0 + th, nmatch, threads):
                p = int(mp[k])
                if p >= t0 + n:
                    kmin = min(kmin, k)
                    break
                end = p + (int(md[k]) >> 15) + 3
                if p >= t0:
                    codes[p - t0] = _k3_match_code(int(md[k]))
                    g = (p - t0) // seg
                    seg_end[g] = max(seg_end[g], end)
                    edges["cross_segment"] += end > t0 + min((g + 1) * seg, n)
                    edges["cross_tile"] += end > t0 + n < n_valid
                    edges["longer_than_segment"] += end - p > seg
                else:
                    pre = max(pre, end)
        cover = max(cover, pre)
        # 2. count: the exclusive max scan of cover ends, the walks, the
        # exclusive sum scan of their bits
        cov_in = [max([cover] + seg_end[:g]) for g in range(threads)]
        walks = [_k3_walk(codes, g * seg, min(g * seg + seg, n), t0, cov_in[g], ll, dd)
                 for g in range(threads)]
        counts = [sum(nb for _, f in toks for _, nb in f) for toks, _ in walks]
        offs = np.concatenate([[0], np.cumsum(counts)]).tolist()
        tile_bits = offs[-1]
        # 3. emit: plain stores to words wholly inside a segment, ORs to
        # the edge words
        stage = [0] * stage_words
        stage[0] = carry
        plain_words, or_words = [], []
        for g, (toks, cov_out) in enumerate(walks):
            i0, i1 = g * seg, min(g * seg + seg, n)
            edges["inside_only"] += i1 > i0 and not toks
            rel = (bit0 & 31) + offs[g]
            widx, acc, nacc, shared, bit = rel >> 5, 0, rel & 31, rel & 31 != 0, bit0 + offs[g]
            lo, hi = t0 + i0 - start, t0 + max(i1, i0) - start
            j, jend = min(-(-lo // stride), n_seeds), min(-(-hi // stride), n_seeds)
            for p, fields in toks:
                last = p
                while j < jend and start + j * stride <= p:
                    sb[j], so[j], j = bit, p - start, j + 1
                for v, nb in fields:
                    acc |= v << nacc
                    nacc += nb
                    bit += nb
                    if nacc >= 32:
                        assert widx < stage_words
                        (or_words if shared else plain_words).append(widx)
                        stage[widx] |= acc & _M32
                        shared, widx, acc, nacc = False, widx + 1, acc >> 32, nacc - 32
            if nacc:
                assert widx < stage_words
                or_words.append(widx)
                stage[widx] |= acc & _M32
            if cov_out < n_valid and j < jend:  # the rest lies inside a match
                edges["seeds_at_match_end"] += jend - j
                for jj in range(j, jend):
                    sb[jj], so[jj] = bit, cov_out - start
        # a plainly stored word has one writer and is no neighbour's
        assert len(set(plain_words)) == len(plain_words)
        assert not set(plain_words) & set(or_words)
        edges["shared_words"] += len(or_words) - len(set(or_words))
        end_bit = (bit0 & 31) + tile_bits
        for i in range(min((end_bit + 31) >> 5, stage_words)):
            if (bit0 >> 5) + i < oww:
                out[(bit0 >> 5) + i] = stage[i]
        carry = stage[end_bit >> 5] if end_bit & 31 else 0
        bit0 += tile_bits
        cover = max([cover] + seg_end)
        k0 = kmin
    # EOB, then zeroes through the slack word
    eob = ll[256]
    total = bit0 + (eob >> 16)
    v = carry | ((eob & 0xFFFF) << (bit0 & 31))
    w0 = bit0 >> 5
    for i in range(w0, (total >> 5) + 2):
        if i < oww:
            out[i] = v & _M32 if i == w0 else (v >> 32 if i == w0 + 1 else 0)
    for j in range(n_seeds):
        if start + j * stride > last:
            sb[j], so[j] = total, n_valid - start
            edges["unreached_seeds"] += 1
    edges["eob_on_word"] += total % 32 == 0
    return out, [total, int((total >> 5) > oww - 1)] + [0] * 6, sb, so


def _k3_model(words, mpos, mld, meta, lltab, dtab, oww, n_seeds, *, threads=K3_THREADS,
              seg=K3_SEG):
    """csrc/pack.cu's design on numpy, on pack_plain's operands. Returns
    pack_plain's five outputs as int32 tensors, and the edges it met."""
    B = words.shape[0]
    byts = words.numpy().view(np.uint8).reshape(B, -1)
    ll_all = lltab.numpy().view(np.uint32).astype(np.int64)
    dd_all = dtab.numpy().view(np.uint32).astype(np.int64)
    mp_all, md_all = mpos.numpy(), mld.numpy().view(np.uint32).astype(np.int64)
    ns = max(1, n_seeds)
    edges = dict.fromkeys(("tiles", "cross_segment", "cross_tile", "longer_than_segment",
                           "inside_only", "shared_words", "seeds_at_match_end",
                           "unreached_seeds", "eob_on_word"), 0)
    rows = [_k3_row(byts[r], mp_all[r], md_all[r], meta[r].tolist(), ll_all[r].tolist(),
                    dd_all[r].tolist(), oww, ns, threads, seg, edges) for r in range(B)]
    as_i32 = lambda x: torch.from_numpy(np.asarray(x, np.int64).astype(np.uint32).view(np.int32))
    owords, st, sb, so = (as_i32([row[i] for row in rows]) for i in range(4))
    echo = torch.cat([lltab[:, :288], dtab[:, :32]], dim=1).to(torch.int32)
    return (owords, st, sb, so, echo), edges


def _assert_model_equals_plain(got, want, n_seeds):
    """Words through total // 32 + 2 (the slack word), st, echo, and both
    seed rows when there are seeds."""
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
    np.testing.assert_array_equal(got[4].numpy(), want[4].numpy())
    for r, total in enumerate(want[1][:, 0].tolist()):
        nw = min(total // 32 + 2, got[0].shape[1])
        np.testing.assert_array_equal(got[0][r, :nw].numpy(), want[0][r, :nw].numpy())
    if n_seeds:
        np.testing.assert_array_equal(got[2].numpy(), want[2].numpy())
        np.testing.assert_array_equal(got[3].numpy(), want[3].numpy())


def _as_pack_chunks(out, n_seeds):
    """pack's five outputs in pack_chunks' (and the JAX pack's) order."""
    owords, st, sb, so, echo = out
    lens = (echo[:, :286] >> 16, echo[:, 288:318] >> 16)
    seeds = (sb, so) if n_seeds else ()
    return (owords, st[:, 0], *lens, *seeds, st[:, 1] > 0)


def _pack_operands(buf, n_valid, start, nmatch, lltab, dtab, n_seeds):
    words, meta, oww = tdk.pack_inputs(
        torch.from_numpy(buf), torch.from_numpy(np.asarray(n_valid, np.int32)), start,
        torch.from_numpy(np.asarray(nmatch, np.int32)), n_seeds)
    return words, meta, lltab, dtab, oww


@pytest.mark.parametrize("n_seeds", [0, 128])
@pytest.mark.parametrize("threads", [K3_THREADS, 32], ids=["one_tile", "tiles_of_1024"])
def test_pack_design_model_equals_plain_and_pallas(batch, n_seeds, threads):
    """The model at the kernel's width (one tile a chunk) and at 32
    threads (tiles of 1024 positions, 8 a chunk, matches across tiles)
    against the plain version and the JAX kernel on real parses."""
    mpos, mld, nmatch, kbad, freq = batch["chase"]
    nm_eff = np.where(kbad, 0, nmatch).astype(np.int32)
    ref = jdk.freq_pack_chunks_pallas(
        jnp.asarray(batch["buf"]), jnp.asarray(batch["n_valid"]),
        jnp.full((3,), DICT, jnp.int32), jnp.asarray(mpos), jnp.asarray(mld),
        jnp.asarray(nm_eff), jnp.asarray(freq), n_seeds=n_seeds, interpret=True,
    )
    lltab, dtab = (torch.from_numpy(t.view(np.int32)) for t in _jax_tables(
        np.asarray(ref[2]), np.asarray(ref[3])))
    words, meta, lltab, dtab, oww = _pack_operands(
        batch["buf"], batch["n_valid"], DICT, nm_eff, lltab, dtab, n_seeds)
    mp_t, md_t = torch.from_numpy(np.array(mpos)), torch.from_numpy(np.array(mld).view(np.int32))
    args = (words, mp_t, md_t, meta, lltab, dtab, oww, n_seeds)
    got, edges = _k3_model(*args, threads=threads)
    _assert_model_equals_plain(got, tdk.pack_plain(*args), n_seeds)
    _assert_pack_equal(_as_pack_chunks(got, n_seeds), ref, n_seeds)
    assert edges["cross_segment"] > 100 and edges["shared_words"] > 100
    assert edges["tiles"] == (3 if threads == K3_THREADS else 3 * 8 - 5)  # the last chunk: 3001
    if threads != K3_THREADS:
        assert edges["cross_tile"] > 0
    if n_seeds:
        assert edges["seeds_at_match_end"] > 0 and edges["unreached_seeds"] == 0


C_EDGE = 64  # match slots of the crafted lanes
W_EDGE = 1024  # their buffer width
S_EDGE = 64  # their start


def _edge_lanes():
    """Crafted lanes, each with (bytes, n_valid, matches (p, length, dist)):
    segment edges inside matches, a 258-byte match over whole segments, an
    all-literal lane, an empty lane, 258-byte dist-1 runs; then lanes of
    two literals, one more 'a' each, of which one ends its EOB on a word."""
    rng = np.random.default_rng(9)
    text = rng.integers(97, 123, W_EDGE, dtype=np.uint8)
    s = S_EDGE
    lanes = [
        (text, s + 900, [(s + 20, 20, 5), (s + 50, 258, 1), (s + 400, 3, 100),
                         (s + 430, 40, 33), (s + 700, 200, 7)]),
        (text, s + 700, []),
        (text, s, []),
        (np.full(W_EDGE, 97, np.uint8), s + 800,
         [(s + 1, 258, 1), (s + 259, 258, 1), (s + 517, 258, 1)]),
    ]
    for n_a in range(100, 132):
        b = np.full(W_EDGE, 98, np.uint8)
        b[s : s + n_a] = 97
        lanes.append((b, s + n_a + 10, []))
    return lanes


def _edge_batch(lanes):
    B = len(lanes)
    buf = np.zeros((B, W_EDGE), np.uint8)
    mpos = np.zeros((B, C_EDGE), np.int32)
    mld = np.zeros((B, C_EDGE), np.uint32)
    n_valid = np.zeros(B, np.int32)
    nmatch = np.zeros(B, np.int32)
    for r, (b, nv, ms) in enumerate(lanes):
        buf[r] = b
        n_valid[r], nmatch[r] = nv, len(ms)
        for k, (p, ln, d) in enumerate(ms):
            mpos[r, k], mld[r, k] = p, ((ln - 3) << 15) | (d - 1)
    return buf, n_valid, mpos, mld, nmatch


@pytest.mark.parametrize("n_seeds", [0, 128])
def test_pack_design_model_on_edge_lanes_equals_plain_and_pallas(n_seeds):
    buf, n_valid, mpos, mld, nmatch = _edge_batch(_edge_lanes())
    B = len(n_valid)
    start = np.full(B, S_EDGE, np.int32)
    ref = jdk.freq_pack_chunks_pallas(
        jnp.asarray(buf), jnp.asarray(n_valid), jnp.asarray(start), jnp.asarray(mpos),
        jnp.asarray(mld), jnp.asarray(nmatch), n_seeds=n_seeds, interpret=True,
    )
    lltab, dtab = (torch.from_numpy(t.view(np.int32)) for t in _jax_tables(
        np.asarray(ref[2]), np.asarray(ref[3])))
    words, meta, lltab, dtab, oww = _pack_operands(
        buf, n_valid, S_EDGE, nmatch, lltab, dtab, n_seeds)
    args = (words, torch.from_numpy(mpos), torch.from_numpy(mld.view(np.int32)), meta, lltab,
            dtab, oww, n_seeds)
    got, edges = _k3_model(*args)
    _assert_model_equals_plain(got, tdk.pack_plain(*args), n_seeds)
    _assert_pack_equal(_as_pack_chunks(got, n_seeds), ref, n_seeds)
    total = got[1][:, 0].numpy()
    assert edges["cross_segment"] >= 4 and edges["longer_than_segment"] >= 4
    assert edges["inside_only"] >= 3 * 7  # three 258-byte matches over whole segments
    assert (total[4:] % 32 == 0).sum() == 1 and edges["eob_on_word"] >= 1
    assert edges["tiles"] == B - 1  # the empty lane has none
    assert total[2] == int(lltab[2, 256]) >> 16  # the empty lane: EOB alone
    assert nmatch[1] == 0 and total[1] > 700  # all literal
    if n_seeds:
        assert edges["seeds_at_match_end"] > 0 and edges["unreached_seeds"] > 0
        np.testing.assert_array_equal(got[3][2].numpy(), 0)  # empty: all end of body


def test_pack_design_model_at_15_bits_a_literal():
    """Tables whose every code is 15 bits (near the 16 bits a position the
    word buffer is sized for): the model, whose buffer asserts its bound,
    against the plain version on all-literal and matched lanes."""
    rng = np.random.default_rng(4)
    lanes = [(rng.integers(0, 256, W_EDGE, dtype=np.uint8), W_EDGE - 16, []),
             (rng.integers(0, 256, W_EDGE, dtype=np.uint8), W_EDGE - 40,
              [(S_EDGE + 3, 3, 32768), (S_EDGE + 100, 258, 24577)])]
    buf, n_valid, mpos, mld, nmatch = _edge_batch(lanes)
    codes = rng.integers(0, 1 << 15, (2, 288), dtype=np.int64)
    lltab = torch.from_numpy((codes | (15 << 16)).astype(np.int32))
    dtab = torch.from_numpy((codes[:, :32] | (15 << 16)).astype(np.int32))
    for n_seeds in (0, 128):
        words, meta, lltab, dtab, oww = _pack_operands(
            buf, n_valid, S_EDGE, nmatch, lltab, dtab, n_seeds)
        args = (words, torch.from_numpy(mpos), torch.from_numpy(mld.view(np.int32)), meta,
                lltab, dtab, oww, n_seeds)
        for threads in (K3_THREADS, 2):
            got, _edges = _k3_model(*args, threads=threads)
            _assert_model_equals_plain(got, tdk.pack_plain(*args), n_seeds)
        assert int(got[1][0, 0]) == 15 * (W_EDGE - 16 - S_EDGE) + 15


def test_pack_design_match_code_round_trips_every_length_and_distance():
    """The match code's symbols, and the length and extra-bit counts the
    walk derives from them, equal the plain version's symbols for every
    length 3..258 and every distance 1..32768."""
    ml = np.arange(3, 259)
    lc, leb, lev = (t.numpy() for t in tdk._len_sym(torch.from_numpy(ml)))
    dd = np.arange(1, 32769)
    dc, deb, dv = (t.numpy() for t in tdk._dist_sym(torch.from_numpy(dd)))
    for i, length in enumerate(ml.tolist()):
        c = _k3_match_code(((length - 3) << 15) | int(dd[i * 128] - 1))
        g_lc, g_lev = c & 31, (c >> 5) & 31
        g_leb = 0 if g_lc < 8 or g_lc == 28 else (g_lc - 4) >> 2
        base = g_lc if g_lc < 8 else (255 if g_lc == 28 else (4 + ((g_lc - 4) & 3)) << g_leb)
        assert (g_lc, g_leb, g_lev, base + g_lev + 3) == (lc[i], leb[i], lev[i], length)
    codes = np.array([_k3_match_code(int(d) - 1) for d in dd])
    g_dc = (codes >> 10) & 31
    np.testing.assert_array_equal(g_dc, dc)
    np.testing.assert_array_equal(np.where(g_dc >= 4, (g_dc >> 1) - 1, 0), deb)
    np.testing.assert_array_equal((codes >> 15) & 0x1FFF, dv)


@pytest.mark.parametrize("kernel", ["pack", "vhuff_expand", "freq", "vhuff_decode", "crc32",
                                    "adler32"])
def test_clock_script_instruments_k3_and_k5(kernel):
    """pack_expand_clocks.py (the card-only measurement of K3's, K5's,
    K11b's, K9's, K4's, K11a's, K7's and K1's phases) edits csrc/pack.cu,
    csrc/vhuff_expand.cu, csrc/freq.cu, csrc/vhuff_decode.cu,
    csrc/crc32.cu and csrc/adler32.cu by exact text anchors and raises
    when one is gone; each must still be there, K11b's resolve window and
    the checksums' geometry constants among them."""
    import importlib.util
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location("clocks", root / "pack_expand_clocks.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    src = (root / "zlib_rs_tpu_torch" / "csrc" / f"{kernel}.cu").read_text()
    edit = {"pack": mod.pack_instrumented, "vhuff_expand": mod.expand_instrumented,
            "freq": mod.freq_instrumented, "vhuff_decode": mod.decode_instrumented,
            "crc32": mod.crc_instrumented, "adler32": mod.adler_instrumented}[kernel]
    phases = {"pack": mod.PACK_PHASES, "vhuff_expand": mod.EXPAND_PHASES,
              "freq": mod.FREQ_PHASES, "vhuff_decode": mod.DECODE_PHASES,
              "crc32": mod.CRC_PHASES, "adler32": mod.ADLER_PHASES}[kernel]
    out = edit(src)
    if kernel in mod.CHECKSUM_VARIANTS:  # the shipped design, at each geometry timed beside it
        assert mod.checksum_design(src, kernel, "this checkout")[2] is edit
        for threads, seg in mod.CHECKSUM_VARIANTS[kernel]:
            varied = mod.geometry_variant(src, kernel, threads, seg)
            assert f"constexpr int kThreads = {threads};" in varied
            assert f"constexpr int kSeg = {seg};" in varied
    if kernel == "vhuff_expand":
        assert out.count(mod.K11B_GROUP) == 1
    if kernel == "vhuff_decode":  # the variants timed beside K4 and K11a
        for _label, _exact, edits in mod.DECODE_VARIANTS:
            assert all(a in src for a, _b in edits)
    assert out.count("CLK_MARK(") == len(phases) + 1 and 'extern "C" int zrs_dbg' in out
    with pytest.raises(RuntimeError, match="no longer has"):
        edit(src.replace("__syncthreads();\n", "__syncthreads(); \n"))
