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

import decode_model
import expand_model

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
# K5's design (csrc/vhuff_expand.cu) as a numpy model (tests/expand_model.py)
# ---------------------------------------------------------------------------


def _k5_model(tapeA, tapeB, offs, out_words, *, max_bytes=VK.CHASE_MAX_BYTES):
    """The model through the two-plane reader: (words uint32 [B,
    out_words], branch [B], edges)."""
    return expand_model.model(expand_model.TwoPlane(tapeA, tapeB), offs, out_words,
                              max_bytes=max_bytes)


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
    expand_model.assert_bytes_equal(got, _plain_k5(tapeA, tapeB, offs, out_words), sizes)
    expand_model.assert_bytes_equal(got, _jax_k5(tapeA, tapeB, offs, out_words), sizes)
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
    expand_model.assert_bytes_equal(got, _plain_k5(tapeA, tapeB, offs, out_words), sizes)
    expand_model.assert_bytes_equal(got, _jax_k5(tapeA, tapeB, offs, out_words), sizes)
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


# ---------------------------------------------------------------------------
# K4's design (csrc/vhuff_decode.cu) as a numpy model (tests/decode_model.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["xla_stream", "kernel_stream"])
def test_direct_tables_equal_the_cascade_on_the_fixture_chunks(request, name):
    """The direct tables of every chunk of both streams, at the literal/
    length widths of K4 (13 bits) and K11a (12), over all 32,768 15-bit
    values: wherever an entry is set it is the cascade's entry and length.
    Canonical tables put most values on the direct path."""
    _data, bodies, _sizes, _seeds = request.getfixturevalue(name)
    for body in bodies:
        _bt, ll, d, _hdr = TS.parse_block_header(body)
        for policy in (decode_model.TwoPlane, decode_model.OnePlane):
            ll_a, d_a = decode_model.tables_of(VK.table_row(ll, d), policy.ll_bits)
            assert decode_model.check_direct(ll_a) > 0.9
            assert decode_model.check_direct(d_a) > 0.5


def _crafted_table_rows(kind, rng):
    """Table rows the encoder does not make: canonical codes over random
    lengths (complete or not, up to 15 bits); random limits, bases on
    their length's grid and random work entries (some with bits 24-27
    set); the same with the low bits of each base set; a one-code distance
    table; the fixed tables."""
    rows = []
    for trial in range(6):
        if kind == "random_codes":
            ll = _random_lengths(rng, 286, trial % 2 == 0)
            ll[256] = max(ll[256], 1)
            rows.append(VK.table_row(ll, _random_lengths(rng, 30, trial % 2 == 1)))
        elif kind in ("random_limits", "low_base_bits"):
            row = rng.integers(-2**31, 2**31, VK.TABLE_WORDS, dtype=np.int64)
            for lim_at, pack_at, work_at, n in ((VK.LL_LIM, VK.LL_PACK, VK.LL_WORK, 384),
                                                (VK.D_LIM, VK.D_PACK, VK.D_WORK, 128)):
                row[lim_at : lim_at + 16] = rng.integers(-100, 1 << 15, 16)
                if trial % 2:
                    row[lim_at : lim_at + 16].sort()
                lens = np.arange(16)
                base = rng.integers(0, 1 << 15, 16) >> (15 - lens) << (15 - lens)
                if kind == "low_base_bits":  # the odd lengths' bases
                    low = rng.integers(1, 1 << 15, 16) & ((1 << (15 - lens)) - 1)
                    base |= np.where(lens % 2 == 1, np.maximum(low, 1), 0)
                off = rng.integers(-40, n + 40, 16)
                row[pack_at : pack_at + 16] = (off << 16) | base
                work = rng.integers(0, 1 << 31, n)
                work[::7] &= ~(0xF << 24)  # most entries with free bits 24-27
                work[::3] &= ~(0xF << 24)
                row[work_at : work_at + n] = work
            rows.append(row.astype(np.int32))
        elif kind == "one_code_distance":
            ll = _random_lengths(rng, 286, True)
            ll[256] = max(ll[256], 1)
            d = np.zeros(320, np.int64)
            d[int(rng.integers(0, 30))] = 1
            rows.append(VK.table_row(ll, d))
        else:  # the fixed tables
            ll = np.array([8] * 144 + [9] * 112 + [7] * 24 + [8] * 8 + [0] * 32, np.int64)
            rows.append(VK.table_row(ll, np.array([5] * 30 + [0] * 290, np.int64)))
    return rows


@pytest.mark.parametrize("kind", ["random_codes", "random_limits", "low_base_bits",
                                  "one_code_distance", "fixed"])
def test_direct_tables_equal_the_cascade_on_crafted_tables(kind):
    rng = np.random.default_rng(["random_codes", "random_limits", "low_base_bits",
                                 "one_code_distance", "fixed"].index(kind) + 40)
    shares = []
    for row in _crafted_table_rows(kind, rng):
        for a in decode_model.tables_of(row, decode_model.TwoPlane.ll_bits):
            shares.append(decode_model.check_direct(a))
            lens = {(e >> 24) & 0xF for e in a.direct if e}
            if kind == "low_base_bits":  # no length whose base has low bits set is direct
                assert not lens & {1, 3, 5, 7, 9, 11, 13}
    assert max(shares) > 0  # every kind puts some values on the direct path
    if kind == "one_code_distance":
        assert shares[1::2] == [0.5] * 6  # the 1-bit code direct, the other half cascaded


@pytest.mark.parametrize("case", decode_model.CASES)
def test_k4_design_model_equals_plain_and_jax(stream, case):
    """The model's staged window, direct tables and walk give the plain
    version's and the JAX kernel's tapes, cons, bad and rem exactly; every
    block of the clean index is staged and the damaged one's block reads in
    place."""
    bodies, sizes, seeds, ops, meta = decode_model.decode_case(stream, case)
    S, K = meta["S"], meta["K"]
    cap = 16 if case == "cap16" else TV._twoplane_cap(meta)
    got = decode_model.model(decode_model.TwoPlane, *ops.values(), S=S, K=K, cap=cap)
    plain = VK.decode_tokens_vector2_plain(*(torch.from_numpy(a) for a in ops.values()),
                                          S=S, K=K, cap=cap)
    decode_model.assert_equal_runs(got, plain, decode_model.jax_decode_on(
        JK.decode_tokens_vector2, bodies, sizes, seeds, ops, meta, cap))
    _tapes, _cons, bad, rem, staged, counts = got
    want_staged = np.ones(len(staged), bool)
    if case == "damaged":
        want_staged[1] = False  # the second chunk's block
    np.testing.assert_array_equal(staged, want_staged)
    assert counts.direct > 0.9 * counts.total
    if case == "clean":
        assert not bad.any() and not rem.any()
    elif case == "cap16":
        assert rem.any()  # walkers stop at the cap with span left


@pytest.mark.parametrize("case", ["clean", "damaged"])
def test_k4_staged_window_equals_the_in_place_fifo(stream, case):
    """Every word any walker of a staged block can fetch (widx 0..K-1)
    lies in its block's window and reads the same from it as in place, the
    last chunk's walkers past the end of the array among them."""
    _b, _s, _seeds, ops, meta = decode_model.decode_case(stream, case)
    words, sw = ops["words"], ops["start_word"]
    B, Lw = words.shape
    S, K = meta["S"], meta["K"]
    flat = words.reshape(-1).view(np.uint32)
    budget = decode_model.stage_budget(Lw, K)
    for blk in range(len(sw) // decode_model.THREADS):
        lo, hi = decode_model.block_window(sw, blk, S, Lw, K)
        staged = hi - lo + 1 <= budget
        assert staged == (case == "clean" or blk != 1)
        for w in range(blk * decode_model.THREADS, (blk + 1) * decode_model.THREADS):
            wbase = (w // S) * Lw + int(sw[w])
            f = decode_model.Fifo(flat, wbase, K, lo, hi, staged)
            in_place = decode_model.Fifo(flat, wbase, K, lo, hi, False)
            assert [f.fetch(i) for i in range(K)] == [in_place.fetch(i) for i in range(K)]
