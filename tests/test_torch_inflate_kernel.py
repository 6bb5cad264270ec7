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


def _run_both(streams, out_lens, *, start_bits=None, win=None, stop=False, one_level):
    words, bits = IK.pack_streams_words(streams)
    B = len(streams)
    sb = np.zeros(B, np.int32) if start_bits is None else np.asarray(start_bits, np.int32)
    ol = np.asarray(out_lens, np.int32)
    ref = decode_streams_pallas(
        jnp.asarray(words), jnp.asarray(sb), jnp.asarray(bits), jnp.asarray(ol),
        max_out=MAX_OUT, interpret=True, one_level=one_level,
        win=None if win is None else jnp.asarray(win), stop_at_target=stop,
    )
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


@pytest.mark.parametrize("one_level", [True, False])
def test_plain_equals_jax_window_start_bit_and_stop_lanes(one_level):
    lanes = _window_batch()
    wpad = 32768
    win = np.zeros((len(lanes), wpad), np.uint8)
    for i, (*_rest, w) in enumerate(lanes):
        if w:
            win[i, wpad - len(w) :] = np.frombuffer(w, np.uint8)
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
