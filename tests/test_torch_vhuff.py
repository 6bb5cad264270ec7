"""K4 and K5 of the vector decode engine and their host tables: the port
(`zlib_rs_tpu_torch`, plain versions on the CPU) against the JAX package
(`zlib_rs_tpu`, Pallas kernels in interpret mode) on the same inputs.

Inputs are two indexed streams: the JAX package's own (the XLA engine at
128 KiB chunks, the shape of its vector tests and bench) and the port's
(the kernel engine at 32 KiB chunks). Every comparison is exact: header
parse and cascade tables; per walker the tapes, `cons`, `bad` and `rem`;
the expanded bytes in [0, out_len) of each chunk."""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zlib_rs_tpu.ops.pallas.vhuff_kernel as JK
import zlib_rs_tpu.parallel.swarm_inflate as JS
import zlib_rs_tpu.parallel.vector_inflate as JV
import zlib_rs_tpu.parallel.pipeline as jp
import zlib_rs_tpu_torch as zt
from zlib_rs_tpu_torch import interop
from zlib_rs_tpu_torch.ops.kernels import vhuff_kernel as VK
from zlib_rs_tpu_torch.parallel import swarm_inflate as TS
from zlib_rs_tpu_torch.parallel import vector_inflate as TV

# the test workers share the cores, and an oversubscribed OpenMP pool spin-waits
torch.set_num_threads(1)

_BASH = open("/bin/bash", "rb").read()


def _chunks(out, index):
    bodies = [out[off : off + ln] for off, ln, _ in index]
    return bodies, [n for _, _, n in index], index.seeds


@pytest.fixture(scope="module")
def xla_stream(monkeypatch_module):
    monkeypatch_module.delenv("ZRS_TPU_KERNEL", raising=False)
    data = _BASH[:140_000]
    out, index = jp.compress_parallel(data, 6, chunk_size=128 * 1024, return_index=True)
    return (data, *_chunks(out, index))


# two chunks of /bin/bash, then one of dist-1 and dist-2 runs whose
# walkers' matches reach into the bytes of the walkers before them
KERNEL_DATA = _BASH[200_000 : 200_000 + 65_536] + b"a" * 20_000 + b"bc" * 6_384


@pytest.fixture(scope="module")
def kernel_stream():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ZRS_TPU_KERNEL", "1")  # the port's kernel engine
        out, index = zt.compress_parallel(KERNEL_DATA, 6, return_index=True, device="cpu")
    return (KERNEL_DATA, *_chunks(out, index))


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.fixture(params=["xla_stream", "kernel_stream"])
def stream(request):
    return request.getfixturevalue(request.param)


# ---------------------------------------------------------------------------
# host tables
# ---------------------------------------------------------------------------


def _same_parse(body):
    got, want = TS.parse_block_header(body), JS.parse_block_header(body)
    if want is None:
        assert got is None
        return None
    assert got is not None
    assert got[0] == want[0] and got[3] == want[3]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    return got


def _raw_deflate(data, level=6, strategy=zlib.Z_DEFAULT_STRATEGY):
    c = zlib.compressobj(level, zlib.DEFLATED, -15, 9, strategy)
    return c.compress(data) + c.flush()


def test_parse_block_header_real_bodies(stream):
    _data, bodies, _sizes, _seeds = stream
    for body in bodies:
        assert _same_parse(body) is not None


def test_parse_block_header_fixed_stored_and_damaged():
    fixed = _raw_deflate(_BASH[:3000], strategy=zlib.Z_FIXED)
    assert _same_parse(fixed)[0] == 1
    assert _same_parse(_raw_deflate(_BASH[:3000], level=0)) is None  # stored
    dyn = _raw_deflate(_BASH[:20_000])
    assert _same_parse(dyn)[0] == 2
    rng = np.random.default_rng(7)
    nones = 0
    for trial in range(300):
        bad = bytearray(dyn[:200])
        for _ in range(1 + trial % 3):
            pos = int(rng.integers(0, 60 * 8))  # inside the header
            bad[pos >> 3] ^= 1 << (pos & 7)
        nones += _same_parse(bytes(bad)) is None
    for trial in range(100):  # random bytes behind a dynamic block's first bits
        noise = bytearray(rng.integers(0, 256, 120, dtype=np.uint8).tobytes())
        noise[0] = (noise[0] & ~6) | 4
        nones += _same_parse(bytes(noise)) is None
    assert nones > 0  # damaged headers reach the None returns
    assert _same_parse(b"") is None
    assert TS.parse_block_header(bytes([0xFD, 0x00])) is None  # HLIT = 288 > 286


def _random_lengths(rng, n, complete):
    """A code over a random subset of n symbols: complete (Kraft sum 1)
    from a random Huffman tree, or random lengths that need not be."""
    used = rng.choice(n, size=int(rng.integers(1, n + 1)), replace=False)
    lens = np.zeros(320, np.int64)
    if not complete:
        lens[used] = rng.integers(1, 16, used.size)
        return lens
    if used.size == 1:
        lens[used] = 1
        return lens
    freqs = rng.integers(1, 1000, used.size)
    from zlib_rs_tpu_torch.ops.huffman import huffman_code_lengths

    lens[used] = huffman_code_lengths(freqs, 15)
    return lens


@pytest.mark.parametrize("complete", [True, False], ids=["complete", "incomplete"])
def test_cascade_tables_equal_jax(complete):
    rng = np.random.default_rng(11 + complete)
    for _ in range(40):
        ll = _random_lengths(rng, 286, complete)
        ll[256] = max(ll[256], 1)
        d = _random_lengths(rng, 30, complete)
        got = VK.build_cascade_tables_np(ll, d)
        want = JK.build_cascade_tables_np(ll, d)
        for g, w in zip(got, want):
            assert g.dtype == np.int32
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(VK.table_row(ll, d), np.concatenate(want))


# ---------------------------------------------------------------------------
# K4: the two-plane decode
# ---------------------------------------------------------------------------


def _jax_k4(bodies, sizes, seeds, cap=None):
    dev, meta = JV.prepare_vector_inputs(bodies, sizes, seeds)
    cap = cap or JV._twoplane_cap(meta)
    tA, tB, cons, bad, rem = JK.decode_tokens_vector2(
        dev["fifo"], *dev["tables"], dev["align"], dev["span"],
        cap=cap, K=meta["K"], interpret=True,
    )
    W = meta["B"] * meta["S"]
    walker_major = lambda x: np.asarray(x).transpose(0, 2, 3, 1).reshape(-1, cap)[:W]
    flat = lambda x: np.asarray(x).reshape(-1)[:W]
    return dict(
        tapeA=walker_major(tA), tapeB=walker_major(tB), cons=flat(cons),
        bad=flat(bad), rem=flat(rem), offs=np.asarray(dev["offs"]), meta=meta, cap=cap,
    )


def _port_k4(bodies, sizes, seeds, cap=None):
    dev, meta = TV.prepare_vector_inputs(bodies, sizes, seeds, device="cpu")
    cap = cap or TV._twoplane_cap(meta)
    out = VK.decode_tokens_vector2(
        dev["words"], dev["start_word"], dev["align"], dev["span"], dev["tables"],
        S=meta["S"], K=meta["K"], cap=cap,
    )
    state = interop.state_to_numpy(dict(zip(("tapeA", "tapeB", "cons", "bad", "rem"), out)))
    state["tapeA"], state["tapeB"] = state["tapeA"].T, state["tapeB"].T
    return state, dev, meta


def _assert_k4_equal(bodies, sizes, seeds, cap=None):
    want = _jax_k4(bodies, sizes, seeds, cap)
    got, _dev, meta = _port_k4(bodies, sizes, seeds, cap)
    assert (meta["K"], meta["cap"]) == (want["meta"]["K"], want["meta"]["cap"])
    for name in ("tapeA", "tapeB", "cons", "bad", "rem"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert got["tapeA"].dtype == np.uint32
    return got, want


def test_k4_equals_jax(stream):
    _data, bodies, sizes, seeds = stream
    got, _ = _assert_k4_equal(bodies, sizes, seeds)
    assert not got["bad"].any() and not got["rem"].any()
    # rows after each walker's terminator stay zero
    live = got["tapeB"] != 0
    assert (np.cumsum(~live, axis=1)[live] == 0).all()


def test_k4_bit_flipped_body_equals_jax(stream):
    _data, bodies, sizes, seeds = stream
    bad = bytearray(bodies[0])
    bad[len(bad) // 2] ^= 0xFF
    got, _ = _assert_k4_equal([bytes(bad)] + bodies[1:], sizes, seeds)
    clean, _dev, _meta = _port_k4(bodies, sizes, seeds)
    assert (got["cons"] != clean["cons"]).any() or got["bad"].any() or got["rem"].any()


def test_k4_shifted_seed_equals_jax(stream):
    _data, bodies, sizes, seeds = stream
    bits, outs = seeds[0]
    bits = list(bits)
    bits[1] += 1  # one walker a bit off its symbol boundary
    _assert_k4_equal(bodies, sizes, [(bits, outs)] + list(seeds[1:]))


def test_k4_undersized_cap_equals_jax(kernel_stream):
    _data, bodies, sizes, seeds = kernel_stream
    got, _ = _assert_k4_equal(bodies, sizes, seeds, cap=16)
    assert got["rem"].any()  # walkers stop at the cap with span left


def test_k4_wrapper_takes_the_plain_version_only_on_the_cpu(kernel_stream):
    _data, bodies, sizes, seeds = kernel_stream
    dev, meta = TV.prepare_vector_inputs(bodies, sizes, seeds, device="cpu")
    args = (dev["words"], dev["start_word"], dev["align"], dev["span"], dev["tables"])
    before = dict(VK.launches)
    with pytest.raises(RuntimeError, match="CUDA"):
        VK.decode_tokens_vector2_cuda(*args, S=meta["S"], K=meta["K"], cap=256)
    with pytest.raises(RuntimeError, match="CUDA"):
        VK.expand_tokens2_cuda(
            torch.zeros((4, 256), dtype=torch.int32),
            torch.zeros((4, 256), dtype=torch.int32), dev["offs"], out_words=8,
        )
    with pytest.raises(ValueError, match="S % 128"):
        VK.decode_tokens_vector2(*args, S=64, K=meta["K"], cap=256)
    assert VK.launches == before


# ---------------------------------------------------------------------------
# K5: the two-plane expansion
# ---------------------------------------------------------------------------


def _assert_k5_equal(bodies, sizes, seeds, data):
    """Both expansions fed the JAX package's own tapes."""
    want = _jax_k4(bodies, sizes, seeds)
    meta, cap = want["meta"], want["cap"]
    B, S = meta["B"], meta["S"]
    out_words = -(-max(sizes) // 4) + 2
    jax_out = np.asarray(JK.expand_tokens_pallas2(
        want["tapeA"].reshape(B, S, cap), want["tapeB"].reshape(B, S, cap),
        want["offs"], S=S, cap=cap, out_words=out_words, interpret=True,
    ))
    offs = np.concatenate([want["offs"][:, :S], want["offs"][:, S : S + 1]], axis=1)
    st = interop.state_from_numpy(
        {"tapeA": want["tapeA"].T, "tapeB": want["tapeB"].T, "offs": offs}, device="cpu"
    )
    got = VK.expand_tokens2(st["tapeA"], st["tapeB"], st["offs"], out_words=out_words)
    got_np = interop.state_to_numpy({"outw": got})["outw"]
    assert got_np.shape == jax_out.shape == (B, out_words)
    pos = 0
    for k in range(B):
        g = got_np[k].view(np.uint8)[: sizes[k]]
        np.testing.assert_array_equal(g, jax_out[k].view(np.uint8)[: sizes[k]])
        assert g.tobytes() == data[pos : pos + sizes[k]]
        pos += sizes[k]
    return want


def test_k5_equals_jax(stream):
    data, bodies, sizes, seeds = stream
    _assert_k5_equal(bodies, sizes, seeds, data)


def test_k5_short_distance_runs_equal_jax(kernel_stream):
    data, bodies, sizes, seeds = kernel_stream
    tape_b = _assert_k5_equal(bodies, sizes, seeds, data)["tapeB"]
    has = (tape_b & 8) != 0
    dists = set(((tape_b[has] >> 12) & 0xFFFF).tolist())
    assert {1, 2} <= dists  # the byte-head path of dist < 4 matches ran


def test_k5_plain_bounds_every_access():
    """Tapes of a corrupt decode and a damaged index: every read clamps
    into the output row and every store outside it is dropped."""
    rng = np.random.default_rng(3)
    cap, S = 16, 8
    tA = rng.integers(0, 2**32, (cap, 2 * S), dtype=np.uint64).astype(np.uint32)
    tB = rng.integers(0, 2**32, (cap, 2 * S), dtype=np.uint64).astype(np.uint32)
    offs = np.sort(rng.integers(-50, 400, (2, S + 1)), axis=1).astype(np.int32)
    offs[1, 3] = 2**31 - 8  # past any row
    st = interop.state_from_numpy({"tapeA": tA, "tapeB": tB, "offs": offs}, device="cpu")
    out = VK.expand_tokens2(st["tapeA"], st["tapeB"], st["offs"], out_words=20)
    assert out.shape == (2, 20) and out.dtype == torch.int32


# ---------------------------------------------------------------------------
# K5's design (csrc/vhuff_expand.cu) as a numpy model
# ---------------------------------------------------------------------------


K5_THREADS, K5_SEG, K5_GROUP = 512, 64, 4  # csrc/vhuff_expand.cu: kThreads, kSeg, kGroup
# a cell: a pointer to an earlier byte, KNOWN | the byte, or OPEN (the
# kernel packs these in 16 bits, pointers in 15)
KNOWN, OPEN = 1 << 20, 1 << 21


def _k5_resolve(ta, tb, cap, p, p1, end, cell, edges):
    """One walker of the resolve: its literal bytes, known, and each
    match's first pointer, p - dist; the match's other bytes stay open.
    False when the walker does not tile [p, p1)."""
    if p < 0 or p > p1 or p1 > end:
        return False
    p0, t = p, 0
    while t < cap and p < p1:
        a, b = int(ta[t]), int(tb[t])
        t += 1
        cnt, dist = b & 7, (b >> 12) & 0xFFFF
        length = ((b >> 4) & 0xFF) + 3 if b & 8 else 0
        if b == 0 or cnt > 4 or p + cnt > p1:
            return False
        for i in range(cnt):
            cell[p + i] = KNOWN | ((a >> (8 * i)) & 0xFF)
        p += cnt
        if length:
            if dist == 0 or dist > p or p + length > p1:
                return False
            cell[p] = p - dist
            edges["earlier_walker"] += p - dist < p0
            p += length
    return p == p1


def _k5_resolve_windows(ta, tb, cap, p, p1, end, cell, edges):
    """The resolve as the kernel runs it, K5_GROUP lanes a walker: a window
    of K5_GROUP rows, one a lane, placed by an exclusive scan of their
    lengths; the rows that start before p1 (a prefix) are taken, and the
    walker goes on after a full window. Same result as _k5_resolve."""
    if p < 0 or p > p1 or p1 > end:
        return False
    p0 = p
    for t0 in range(0, cap, K5_GROUP):
        if p >= p1:
            break
        rows = [(int(ta[t]), int(tb[t])) for t in range(t0, min(t0 + K5_GROUP, cap))]
        adv = [(b & 7) + (((b >> 4) & 0xFF) + 3 if b & 8 else 0) for _a, b in rows]
        pos = (p + np.concatenate([[0], np.cumsum(adv)[:-1]])).tolist()
        taken = [g for g in range(len(rows)) if pos[g] < p1]
        edges["windows"] += 1
        for g in taken:
            a, b = rows[g]
            cnt, dist = b & 7, (b >> 12) & 0xFFFF
            length = ((b >> 4) & 0xFF) + 3 if b & 8 else 0
            lit_end = pos[g] + cnt
            if b == 0 or cnt > 4 or lit_end > p1 or (length and (
                    dist == 0 or dist > lit_end or lit_end + length > p1)):
                return False
            for i in range(cnt):
                cell[pos[g] + i] = KNOWN | ((a >> (8 * i)) & 0xFF)
            if length:
                cell[lit_end] = lit_end - dist
                edges["earlier_walker"] += lit_end - dist < p0
        p = pos[taken[-1]] + adv[taken[-1]]
        if len(taken) < K5_GROUP:
            break
    return p == p1


def _k5_fill(cell, q0, q1, last, last_cell, edges):
    """One segment of the fill: each open byte inside the match of the
    last head before it (`last`, the last token before q0 with its cell as
    the resolve left it, starts it); a pointer into [q0, q) takes its
    target's cell, final there; an open byte before any head is a known
    zero."""
    s, d = -1, 1
    if last >= 0 and last_cell < last:
        s, d = last, last - last_cell
        edges["carried"] += q0 < q1 and cell[q0] == OPEN
    for q in range(q0, q1):
        v = int(cell[q])
        if v == OPEN:
            j = q - s
            if s < 0:
                v = KNOWN
                edges["orphan"] += 1
            elif j < d:
                v = q - d
            else:  # inside its own match: one period back, before the match
                v = s - d + j % d
                edges["period"] += 1
        elif v < q:
            s, d = q, q - v
        else:
            s = -1
            continue
        if q0 <= v < q:
            v = int(cell[v])
            edges["compressed"] += 1
        cell[q] = v


def _k5_model(tapeA, tapeB, offs, out_words, *, max_bytes=VK.CHASE_MAX_BYTES):
    """csrc/vhuff_expand.cu on numpy: per chunk the resolve, the fill in
    segments of one thread each (the last token before a segment from an
    exclusive max scan), then pointer jumping in synchronous rounds (the
    kernel's asynchronous rounds move cells at least as far), or the
    serial body (the plain version's `_expand_chunk`) for walkers that do
    not tile, a chunk past max_bytes or a row past CHASE_MAX_ROW. Returns
    (words uint32 [B, out_words], branch [B], edges)."""
    a_all = np.asarray(tapeA).view(np.uint32)
    b_all = np.asarray(tapeB).view(np.uint32)
    offs = np.asarray(offs)
    cap, W = a_all.shape
    B = offs.shape[0]
    S = W // B
    nbytes = 4 * out_words
    out = np.zeros((B, out_words), np.uint32)
    branch = np.zeros(B, np.int64)
    edges = dict(rounds=[], depth=[], earlier_walker=0, carried=0, orphan=0, period=0,
                 compressed=0, windows=0)
    for k in range(B):
        of = offs[k].tolist()
        cols = slice(k * S, (k + 1) * S)
        if max_bytes is None or (of[S] <= max_bytes and nbytes <= VK.CHASE_MAX_ROW):
            end = min(max(of[S], 0), nbytes)
            cell = np.where(np.arange(nbytes) < end, OPEN, KNOWN)
            # the kernel's windows, held against the serial walk of each walker
            serial = cell.copy()
            ok = [_k5_resolve_windows(a_all[:, k * S + s], b_all[:, k * S + s], cap, of[s],
                                      of[s + 1], end, cell, edges) for s in range(S)]
            assert ok == [_k5_resolve(a_all[:, k * S + s], b_all[:, k * S + s], cap, of[s],
                                      of[s + 1], end, serial, edges) for s in range(S)]
            assert not all(ok) or np.array_equal(cell, serial)
            if all(ok):
                seg = K5_SEG * -(-end // (K5_SEG * K5_THREADS))
                spans = [(min(t * seg, end), min(t * seg + seg, end)) for t in range(K5_THREADS)]
                lasts = [max([q for q in range(q0, q1) if cell[q] != OPEN], default=-1)
                         for q0, q1 in spans]
                carry = [max(lasts[:t], default=-1) for t in range(K5_THREADS)]
                heads = [int(cell[c]) if c >= 0 else 0 for c in carry]  # before any fill
                for t, (q0, q1) in enumerate(spans):
                    _k5_fill(cell, q0, q1, carry[t], heads[t], edges)
                # hops from each byte to a known cell; every pointer is earlier
                hops = np.zeros(nbytes, np.int64)
                for q in np.flatnonzero(cell < KNOWN):
                    hops[q] = hops[cell[q]] + 1
                depth = int(hops.max())
                rounds = 1
                while True:
                    nxt = cell.copy()
                    ptrs = cell < KNOWN
                    nxt[ptrs] = cell[cell[ptrs]]
                    if np.array_equal(nxt, cell):
                        break
                    cell, rounds = nxt, rounds + 1
                # a chain of h hops is known after bit_length(h) rounds (each
                # round doubles the hops a pointer spans); the last moves none
                assert rounds == depth.bit_length() + 1
                edges["rounds"].append(rounds)
                edges["depth"].append(depth)
                out[k] = (cell & 0xFF).astype(np.uint8).view(np.uint32)
                continue
            branch[k] = VK.BRANCH_UNTILED
        else:
            branch[k] = VK.BRANCH_TOO_LARGE
        out[k] = VK._expand_chunk(a_all[:, cols].T.tolist(), b_all[:, cols].T.tolist(), of,
                                  cap, out_words)
    return out, branch, edges


def _plain_k5(tapeA, tapeB, offs, out_words):
    st = interop.state_from_numpy({"a": tapeA, "b": tapeB, "offs": offs}, device="cpu")
    got = VK.expand_tokens2_plain(st["a"], st["b"], st["offs"], out_words=out_words)
    return got.numpy().view(np.uint32)


def _jax_k5(tapeA, tapeB, offs, out_words):
    """JAX's expand_tokens_pallas2 in interpret mode on row-major tapes
    [cap, W] and offs [B, S + 1]."""
    cap, W = tapeA.shape
    B, S = offs.shape[0], offs.shape[1] - 1
    walker_major = lambda t: jnp.asarray(np.ascontiguousarray(t.T).reshape(B, S, cap))
    joffs = np.concatenate([offs[:, :S], np.repeat(offs[:, S:], 8, axis=1)], axis=1)
    return np.asarray(JK.expand_tokens_pallas2(
        walker_major(tapeA), walker_major(tapeB), jnp.asarray(joffs), S=S, cap=cap,
        out_words=out_words, interpret=True))


def _assert_bytes_equal(got, want, sizes):
    for k, n in enumerate(sizes):
        np.testing.assert_array_equal(got[k].view(np.uint8)[:n], want[k].view(np.uint8)[:n])


@pytest.mark.parametrize("max_bytes", [VK.CHASE_MAX_BYTES, None], ids=["kernel", "no_limit"])
def test_k5_design_model_equals_plain_and_jax(stream, max_bytes):
    """On the JAX package's tapes of both streams: the 32 KiB chunks take
    the chase, the 128 KiB ones the serial body at the kernel's limit and
    the chase without it."""
    data, bodies, sizes, seeds = stream
    want = _jax_k4(bodies, sizes, seeds)
    B, S = want["meta"]["B"], want["meta"]["S"]
    out_words = -(-max(sizes) // 4) + 2
    tapeA, tapeB = want["tapeA"].T.copy(), want["tapeB"].T.copy()
    offs = np.concatenate([want["offs"][:, :S], want["offs"][:, S : S + 1]], axis=1)
    got, branch, edges = _k5_model(tapeA, tapeB, offs, out_words, max_bytes=max_bytes)
    _assert_bytes_equal(got, _plain_k5(tapeA, tapeB, offs, out_words), sizes)
    _assert_bytes_equal(got, _jax_k5(tapeA, tapeB, offs, out_words), sizes)
    assert b"".join(got[k].view(np.uint8)[:n].tobytes() for k, n in enumerate(sizes)) == data
    too_large = max(sizes) > VK.CHASE_MAX_BYTES and max_bytes is not None
    assert (branch == (VK.BRANCH_TOO_LARGE if too_large else VK.BRANCH_CHASE)).all()
    if not too_large:
        assert edges["period"] > 0 and edges["earlier_walker"] > 0
        assert edges["carried"] > 0 and edges["compressed"] > 0 and max(edges["rounds"]) >= 3


def _row(lits=b"", length=0, dist=0):
    """One two-plane row: (tapeA, tapeB) words."""
    a = int.from_bytes(lits.ljust(4, b"\0")[:4], "little")
    b = len(lits) | ((8 | ((length - 3) << 4) | (dist << 12)) if length else 0)
    return a, b


def _tapes(chunks, cap=None):
    """Row-major tapes [cap, W] and offs [B, S + 1] from chunks of walkers,
    each a list of rows (literal bytes, match length, dist); offsets run
    on from 0 with each walker's bytes."""
    B, S = len(chunks), len(chunks[0])
    cap = cap or max(len(w) for c in chunks for w in c) + 1
    tapeA = np.zeros((cap, B * S), np.uint32)
    tapeB = np.zeros((cap, B * S), np.uint32)
    offs = np.zeros((B, S + 1), np.int32)
    for k, walkers in enumerate(chunks):
        for s, rows in enumerate(walkers):
            n = 0
            for t, r in enumerate(rows):
                tapeA[t, k * S + s], tapeB[t, k * S + s] = _row(*r)
                n += len(r[0]) + (r[1] if len(r) > 1 else 0)
            offs[k, s + 1] = offs[k, s] + n
    return tapeA, tapeB, offs


def _edge_chunks():
    """A chunk of chained dist-1 runs over all 128 walkers (each walker's
    bytes point into the walker before it: a chain 128 hops deep), and a
    chunk of overlapping matches (dist < length) inside walkers and sources
    in earlier walkers (padded to 128 walkers with empty ones), then that
    chunk again, to start 5 bytes into its row."""
    S = 128
    deep = [[(b"x", 200, 1)]] + [[(b"", 200, 1)] for _ in range(S - 1)]
    near = [
        [(b"abc", 50, 3), (b"de", 30, 2), (b"f", 20, 1), (b"ghij",)],
        [(b"", 40, 5), (b"kl", 100, 60)],
        [(b"mnop",), (b"q", 258, 250)],
        [(b"", 3, 500), (b"rs", 258, 1)],
    ]
    near += [[] for _ in range(S - len(near))]
    return [deep, near, near]


def test_k5_design_model_on_edge_chunks_equals_plain_and_jax():
    tapeA, tapeB, offs = _tapes(_edge_chunks())
    offs[2] += 5  # bytes [0, 5) stay zero: open bytes before any token
    sizes = offs[:, -1].tolist()
    out_words = -(-max(sizes) // 4) + 2
    got, branch, edges = _k5_model(tapeA, tapeB, offs, out_words)
    assert (branch == VK.BRANCH_CHASE).all()
    _assert_bytes_equal(got, _plain_k5(tapeA, tapeB, offs, out_words), sizes)
    _assert_bytes_equal(got, _jax_k5(tapeA, tapeB, offs, out_words), sizes)
    assert got[0].view(np.uint8)[: sizes[0]].tobytes() == b"x" * sizes[0]
    # the deep chunk: a hop a walker, 128 hops, so 8 rounds that move
    # (2^7 hops span 128 nodes, the 128th takes the next) and the last
    assert edges["depth"][0] == 128 and edges["rounds"][0] == 9
    assert edges["period"] > 0 and edges["earlier_walker"] >= 4 and edges["carried"] > 0
    assert edges["orphan"] == 5 and not got[2].view(np.uint8)[:5].any()


def _corrupt_chunks():
    """Chunks the resolve must send to the serial body, one fault each:
    a walker ending one byte short of its offset, dist 0, a source before
    the row, five literals in a row, a walker cut off by an all-zero row,
    and an index past the row."""
    good = [[(b"abcd",), (b"e", 10, 5)], [(b"fg", 20, 7)], [(b"hijk",)], [(b"", 9, 20)]]
    chunks = [[list(w) for w in good] for _ in range(6)]
    chunks[1][1] = [(b"fg", 20, 0)]
    chunks[2][1] = [(b"fg", 20, 600)]
    chunks[4][2] = []
    tapeA, tapeB, offs = _tapes(chunks)
    offs[0, 2] -= 1  # walker 1 ends one byte past its range
    tapeB[0, 3 * 4 + 2] = (int(tapeB[0, 3 * 4 + 2]) & ~7) | 5  # five literals
    offs[3, 3:] += 1  # in a range of five bytes
    offs[4, 3:] += 4  # walker 2 has no rows for its 4 bytes
    out_words = -(-int(offs[:, -1].max()) // 4) + 2
    offs[5, -1] = 4 * out_words + 40  # the last walker runs past the row
    return tapeA, tapeB, offs, out_words


def test_k5_design_model_sends_corrupt_chunks_to_the_serial_body():
    tapeA, tapeB, offs, out_words = _corrupt_chunks()
    got, branch, _edges = _k5_model(tapeA, tapeB, offs, out_words)
    assert (branch == VK.BRANCH_UNTILED).all()
    np.testing.assert_array_equal(got, _plain_k5(tapeA, tapeB, offs, out_words))
    # the same tapes with the faults mended take the chase
    good = _tapes([[[(b"abcd",), (b"e", 10, 5)], [(b"fg", 20, 7)], [(b"hijk",)],
                    [(b"", 9, 20)]]])
    _got, ok_branch, _ = _k5_model(*good, out_words)
    assert (ok_branch == VK.BRANCH_CHASE).all()


def test_k5_design_model_on_random_tapes_takes_the_serial_body():
    """test_k5_plain_bounds_every_access's tapes: every chunk serial, every
    word of the row equal to the plain version's."""
    rng = np.random.default_rng(3)
    cap, S = 16, 8
    tA = rng.integers(0, 2**32, (cap, 2 * S), dtype=np.uint64).astype(np.uint32)
    tB = rng.integers(0, 2**32, (cap, 2 * S), dtype=np.uint64).astype(np.uint32)
    offs = np.sort(rng.integers(-50, 400, (2, S + 1)), axis=1).astype(np.int32)
    offs[1, 3] = 2**31 - 8
    got, branch, _edges = _k5_model(tA, tB, offs, 20)
    assert (branch == VK.BRANCH_UNTILED).all()
    np.testing.assert_array_equal(got, _plain_k5(tA, tB, offs, 20))
