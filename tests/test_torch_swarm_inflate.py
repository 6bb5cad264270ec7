"""The seeded swarm decode engine (zlib_rs_tpu_torch.parallel.swarm_inflate,
device="cpu") and the decode tables and token resolver under it
(parallel.device_inflate) against the JAX package's (`decode_seeded`,
`_build_flat_lut`, `resolve_tokens`, jitted on the CPU), on the same
arrays, and the engine's place in `decompress_parallel`: under
ZRS_TPU_KERNEL=0 it is the only device engine after the vector engine,
and after K6 it takes what K6 could not decode. Every comparison is
exact.

The streams are the XLA engine's indexed streams of each package, at 32
KiB chunks (the engine's 128 KiB chunks run on the card in
chip_smoke.py)."""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zlib_rs_tpu.parallel.device_inflate as JDI
import zlib_rs_tpu.parallel.pipeline as jp
import zlib_rs_tpu.parallel.swarm_inflate as JS
import zlib_rs_tpu_torch as zt
from zlib_rs_tpu_torch.ops import lz77 as tl
from zlib_rs_tpu_torch.ops.kernels import inflate_kernel as IK
from zlib_rs_tpu_torch.parallel import device_inflate as DI
from zlib_rs_tpu_torch.parallel import pipeline as tp
from zlib_rs_tpu_torch.parallel import swarm_inflate as TS
from zlib_rs_tpu_torch.parallel import vector_inflate as TV

# the test workers share the cores, and an oversubscribed OpenMP pool spin-waits
torch.set_num_threads(1)

_BASH = open("/bin/bash", "rb").read()
CHUNK = 32 * 1024


def _bundle(data, out, index):
    assert zlib.decompress(out) == data
    bodies = [out[off : off + ln] for off, ln, _ in index]
    return dict(data=data, comp=out, index=index, bodies=bodies,
                sizes=[n for _, _, n in index], seeds=index.seeds)


@pytest.fixture(scope="module")
def jax_stream():
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("ZRS_TPU_KERNEL", raising=False)
        data = _BASH[:70_000]
        out, index = jp.compress_parallel(data, 6, chunk_size=CHUNK, return_index=True)
    return _bundle(data, out, index)


@pytest.fixture(scope="module")
def port_stream():
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("ZRS_TPU_KERNEL", raising=False)
        data = _BASH[500_000 : 500_000 + 70_000]
        out, index = zt.compress_parallel(data, 6, chunk_size=CHUNK, return_index=True,
                                          device="cpu")
    return _bundle(data, out, index)


@pytest.fixture(params=["jax_stream", "port_stream"])
def stream(request):
    return request.getfixturevalue(request.param)


@pytest.fixture(autouse=True)
def clean_state(monkeypatch):
    for name in ("ZRS_TPU_KERNEL", "ZRS_TPU_VECTOR", "ZRS_VECTOR_TWOPLANE"):
        monkeypatch.delenv(name, raising=False)
    tp._FALLBACKS.clear()
    yield
    tp._FALLBACKS.clear()


def _flip(stream, chunk: int):
    """The stream's bodies with 16 bytes inverted in the middle of a chunk
    (one flipped byte is often decoded in step: the walker lands on its
    seed with other bytes)."""
    bodies = list(stream["bodies"])
    bad = bytearray(bodies[chunk])
    mid = len(bad) // 2
    bad[mid : mid + 16] = bytes(x ^ 0xFF for x in bad[mid : mid + 16])
    bodies[chunk] = bytes(bad)
    return bodies


# ---------------------------------------------------------------------------
# the flat decode tables and the resolver
# ---------------------------------------------------------------------------


def _jax_luts(lengths, fields):
    rev = jnp.asarray(JDI._REV15_NP)
    return np.asarray(jax.jit(jax.vmap(
        lambda ln: JDI._build_flat_lut(ln, *fields, rev, JDI.FLAT_BITS)))(jnp.asarray(lengths)))


def _crafted_lengths():
    """Length sets on the edges of the table build: none, one code, an
    incomplete code, an over-subscribed one (three 1-bit codes) and the
    fixed trees."""
    rows = np.zeros((5, 320), np.int32)
    rows[1, 7] = 1
    rows[2, [0, 1, 2]] = [1, 2, 3]
    rows[3, [4, 9, 200]] = 1
    rows[4, :288] = TS._FIXED_LL
    return rows


def test_flat_luts_equal_jax(jax_stream, port_stream):
    parsed = [TS.parse_block_header(b) for s in (jax_stream, port_stream) for b in s["bodies"]]
    ll = np.stack([p[1] for p in parsed] + list(_crafted_lengths()))
    dd = np.stack([p[2] for p in parsed] + list(_crafted_lengths()))
    rev = torch.from_numpy(DI._REV15_NP)
    for lengths, port_fields, jax_fields in (
        (ll, DI._ll_symbol_fields(320), JDI._ll_symbol_fields(320)),
        (dd, DI._d_symbol_fields(320), JDI._d_symbol_fields(320)),
    ):
        got = DI._build_flat_lut(torch.from_numpy(lengths), *port_fields, rev)
        np.testing.assert_array_equal(got.numpy(), _jax_luts(lengths, jax_fields).astype(np.int64))
        kinds = got.numpy() >> 28
        assert (kinds[len(parsed)] == DI.KIND_INVALID).all()  # no code: every key invalid
        assert (kinds[0] != DI.KIND_INVALID).all()  # a stream's complete code


def _tapes(data: bytes, wlen: int, window: bytes):
    """Token tapes of `data` (with `window` before it): a raw run over the
    first 700 bytes, then the lz77 parse, with empty tokens among them;
    row 1 is row 0 cut short. Returns (comp, kind, a, b, windows)."""
    rng = np.random.default_rng(8)
    buf = np.frombuffer(window + data, np.uint8)
    n = len(buf)
    padded = torch.zeros((1, n + tl.PAD), dtype=torch.uint8)
    padded[0, :n] = torch.from_numpy(buf.copy())
    length, dist = tl.find_matches(padded, n, chain_depth=12, max_words=32, lazy=True)
    tokens = tl.greedy_parse(length, n, wlen + 700)[0].numpy()
    length, dist = length[0].numpy(), dist[0].numpy()
    toks = [(DI.TOK_RAW, 700, 0)]
    for p in np.nonzero(tokens)[0]:
        if length[p] >= 3:
            toks.append((DI.TOK_MATCH, int(length[p]), int(dist[p])))
        else:
            toks.append((DI.TOK_LIT, 1, int(buf[p])))
        if rng.random() < 0.05:
            toks.append((DI.TOK_NULL, int(rng.integers(0, 300)), int(rng.integers(0, 99))))
    assert any(t[0] == DI.TOK_MATCH and t[2] > 100 for t in toks)
    S = len(toks)
    kind = np.zeros((2, S), np.uint8)
    a = np.zeros((2, S), np.int32)
    b = np.zeros((2, S), np.int32)
    arr = np.array(toks)
    kind[0], a[0], b[0] = arr[:, 0], arr[:, 1], arr[:, 2]
    cut = S // 2
    kind[1, :cut], a[1, :cut], b[1, :cut] = arr[:cut, 0], arr[:cut, 1], arr[:cut, 2]
    comp = np.stack([np.frombuffer(data, np.uint8)] * 2)
    windows = np.stack([np.frombuffer(window, np.uint8)] * 2).reshape(2, wlen)
    return comp, kind, a, b, windows


@pytest.mark.parametrize("wlen", [0, 32_768])
def test_resolve_tokens_equal_jax(wlen):
    data = _BASH[700_000 : 700_000 + 20_000]
    window = _BASH[700_000 - wlen : 700_000]
    comp, kind, a, b, windows = _tapes(data, wlen, window)
    out_size = len(data) + 64
    out, produced = DI.resolve_tokens(*(torch.from_numpy(x) for x in (comp, kind, a, b, windows)),
                                      out_size, wlen)
    jout, jprod = JDI.resolve_tokens(*(jnp.asarray(x) for x in (comp, kind, a, b, windows)),
                                     out_size=out_size, wlen=wlen)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(produced.numpy(), np.asarray(jprod))
    assert produced[0] == len(data) and out[0, : len(data)].numpy().tobytes() == data
    assert 0 < produced[1] < len(data)
    if wlen:  # matches that reach back into the window
        starts = np.cumsum(np.where(kind[0] == DI.TOK_NULL, 0, a[0])) - np.where(
            kind[0] == DI.TOK_NULL, 0, a[0])
        assert ((kind[0] == DI.TOK_MATCH) & (b[0] > starts)).any()


# ---------------------------------------------------------------------------
# decode_seeded
# ---------------------------------------------------------------------------

_JAX_SEEDED = {}


def _seeded(bodies, stream):
    *arrays, cap = TS.seeded_inputs(bodies, stream["sizes"], stream["seeds"])
    return arrays, cap, max(stream["sizes"])


def _jax_seeded(key, arrays, cap, max_out):
    if key not in _JAX_SEEDED:
        comp, ll, dd, sbit, sspan = arrays
        res = JS.decode_seeded(jnp.asarray(comp), jnp.asarray(ll), jnp.asarray(dd),
                               jnp.asarray(sbit.astype(np.int32)),
                               jnp.asarray(sspan.astype(np.int32)), cap=cap, max_out=max_out)
        _JAX_SEEDED[key] = [np.asarray(r) for r in res]
    return _JAX_SEEDED[key]


@pytest.mark.parametrize("flipped", [False, True], ids=["clean", "flipped"])
def test_decode_seeded_equal_jax(stream, flipped):
    bodies = _flip(stream, 1) if flipped else stream["bodies"]
    arrays, cap, max_out = _seeded(bodies, stream)
    assert cap % TS.CAP_QUANTUM == 0
    out, produced, bad = TS.decode_seeded(*(torch.from_numpy(a) for a in arrays), cap=cap,
                                          max_out=max_out)
    want = _jax_seeded((stream["data"], flipped), arrays, cap, max_out)
    for got, w in zip((out, produced, bad), want):
        np.testing.assert_array_equal(got.numpy(), w)
    if flipped:
        assert bad.tolist() == [False, True, False]
    else:
        assert not bad.any()
        assert b"".join(out[k, :n].numpy().tobytes() for k, n in enumerate(stream["sizes"])) \
            == stream["data"]


@pytest.mark.parametrize("flipped", [False, True], ids=["clean", "flipped"])
def test_checking_every_few_steps_gives_the_same_tapes(monkeypatch, port_stream, flipped):
    # the reference tests for a live walker before every step; after the
    # last one stops every step is empty, so checks every k steps, or none
    # before the cap, write the same tapes
    bodies = _flip(port_stream, 1) if flipped else port_stream["bodies"]
    arrays, cap, max_out = _seeded(bodies, port_stream)
    tapes = []
    real = DI.resolve_tokens
    monkeypatch.setattr(DI, "resolve_tokens", lambda *a: tapes.append(a[1:4]) or real(*a))
    results = [TS.decode_seeded(*(torch.from_numpy(a) for a in arrays), cap=cap, max_out=max_out,
                                check_every=k) for k in (1, 7, TS.CHECK_EVERY, cap)]
    for got, res in zip(tapes[1:], results[1:]):
        for t, t0 in zip(got, tapes[0]):
            assert torch.equal(t, t0)
        for r, r0 in zip(res, results[0]):
            assert torch.equal(r, r0)
    assert bool(results[0][2].any()) == flipped


# ---------------------------------------------------------------------------
# decode_chunks_seeded and decompress_parallel
# ---------------------------------------------------------------------------


def test_decode_chunks_seeded_equals_input_and_jax(stream):
    got = TS.decode_chunks_seeded(stream["bodies"], stream["sizes"], stream["seeds"], device="cpu")
    assert b"".join(got) == stream["data"]
    arrays, cap, max_out = _seeded(stream["bodies"], stream)
    out = _jax_seeded((stream["data"], False), arrays, cap, max_out)[0]
    assert got == [out[k, :n].tobytes() for k, n in enumerate(stream["sizes"])]


def test_decode_chunks_seeded_data_faults(port_stream):
    s = port_stream
    with pytest.raises(TS.SwarmDataFault, match="drift"):
        TS.decode_chunks_seeded(_flip(s, 1), s["sizes"], s["seeds"], device="cpu")
    half = [(b[:64], o[:64]) for b, o in s["seeds"]]
    with pytest.raises(TS.SwarmDataFault, match="expected 128 seeds"):
        TS.decode_chunks_seeded(s["bodies"], s["sizes"], half, device="cpu")
    stored = [b"\x01\x03\x00\xfc\xffabc"] + s["bodies"][1:]
    with pytest.raises(TS.SwarmDataFault, match="not a seedable"):
        TS.decode_chunks_seeded(stored, [3] + s["sizes"][1:], s["seeds"], device="cpu")
    assert TS.decode_chunks_seeded([], [], [], device="cpu") == []


def _runs():
    return TS.runs["decode_seeded"]


@pytest.mark.parametrize("wrap", ["zlib", "gzip"])
def test_kernel_env_0_decodes_through_the_swarm_engine(monkeypatch, stream, wrap):
    # ZRS_TPU_KERNEL=0 skips K6: with the vector engine off too, the swarm
    # engine decodes; with it on, the vector engine does
    comp, index = stream["comp"], stream["index"]
    if wrap == "gzip":
        data = stream["data"]
        comp = (bytes([0x1F, 0x8B, 8, 0, 0, 0, 0, 0, 0, 3]) + comp[2:-4]
                + zlib.crc32(data).to_bytes(4, "little") + len(data).to_bytes(4, "little"))
        index = tp.ChunkIndex((off + 8, ln, n) for off, ln, n in stream["index"])
        index.seeds = stream["seeds"]
    monkeypatch.setenv("ZRS_TPU_KERNEL", "0")
    k6 = []
    monkeypatch.setattr(TS, "decode_chunks_kernel", lambda *a, **k: k6.append(1))
    before = _runs()
    monkeypatch.setenv("ZRS_TPU_VECTOR", "0")
    assert zt.decompress_parallel(comp, index, device="cpu") == stream["data"]
    assert _runs() == before + 1 and zt.fallback_stats() == {}
    monkeypatch.setenv("ZRS_TPU_VECTOR", "1")
    assert zt.decompress_parallel(comp, index, device="cpu") == stream["data"]
    assert _runs() == before + 1 and zt.fallback_stats() == {} and k6 == []


def test_static_index_under_kernel_env_0_decodes_on_the_host(monkeypatch):
    # a static stream's index has no seeds: no chunk engine runs, and the
    # region decode (K6) decodes, as the reference's last step does
    data = _BASH[:50_000]
    out, index = zt.compress_parallel(data, 1, chunk_size=CHUNK, return_index=True, device="cpu")
    assert index.seeds is None
    monkeypatch.setenv("ZRS_TPU_KERNEL", "0")
    before = _runs()
    assert zt.decompress_parallel(out, index, device="cpu") == data
    assert _runs() == before and zt.fallback_stats() == {}


def test_k6_data_fault_falls_to_the_swarm_engine(monkeypatch, port_stream):
    # a K6 lane flagged bad: the reference's key, then the swarm engine
    real = IK.decode_streams

    def one_bad_lane(*a, **k):
        out, produced, bad, end_bit = real(*a, **k)
        bad = bad.clone()
        bad[1] = True
        return out, produced, bad, end_bit

    monkeypatch.setattr(IK, "decode_streams", one_bad_lane)
    monkeypatch.setenv("ZRS_TPU_VECTOR", "0")
    before = _runs()
    assert zt.decompress_parallel(port_stream["comp"], port_stream["index"], device="cpu") \
        == port_stream["data"]
    assert _runs() == before + 1
    assert zt.fallback_stats() == {"kernel_decode:ValueError": 1}


def test_swarm_fault_is_counted_and_the_host_step_decides(monkeypatch, port_stream):
    s = port_stream
    monkeypatch.setenv("ZRS_TPU_KERNEL", "0")
    monkeypatch.setenv("ZRS_TPU_VECTOR", "0")
    half = tp.ChunkIndex(list(s["index"]))
    half.seeds = [(b[:64], o[:64]) for b, o in s["seeds"]]
    assert zt.decompress_parallel(s["comp"], half, device="cpu") == s["data"]
    assert zt.fallback_stats() == {"swarm_decode:ValueError": 1}
    off, ln, _n = s["index"][1]
    broken = bytearray(s["comp"])
    broken[off : off + ln] = _flip(s, 1)[1]
    # the region decode decides: K6 refuses the region, the lockstep
    # engine flags it
    with pytest.raises(ValueError, match="failed to decode on device"):
        zt.decompress_parallel(bytes(broken), s["index"], device="cpu")
    assert zt.fallback_stats() == {"swarm_decode:ValueError": 2, "region_kernel:ValueError": 1}


@pytest.mark.parametrize("exc", [RuntimeError, TypeError])
def test_swarm_errors_propagate(monkeypatch, port_stream, exc):
    def failing(*a, **k):
        raise exc("not a data fault")

    monkeypatch.setattr(TS, "decode_seeded", failing)
    monkeypatch.setenv("ZRS_TPU_KERNEL", "0")
    monkeypatch.setenv("ZRS_TPU_VECTOR", "0")
    with pytest.raises(exc):
        zt.decompress_parallel(port_stream["comp"], port_stream["index"], device="cpu")
    assert zt.fallback_stats() == {}
    assert not isinstance(TV.VectorDataFault("x"), TS.SwarmDataFault)
