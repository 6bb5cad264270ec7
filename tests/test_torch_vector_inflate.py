"""The decode slice as a whole: the port's vector engine and
`decompress_parallel` (device="cpu", the kernels' plain versions) against
the input and the JAX package's `decode_chunks_vector` (Pallas kernels in
interpret mode), on the JAX package's indexed stream (XLA engine, 128 KiB
chunks) and the port's own (kernel engine, 32 KiB chunks), zlib and gzip.

Also the fail-safe contract: a data fault (corrupt body, wrong seed,
undersized tape cap, wrong bytes behind a good-looking decode) falls back
to the next engine (the inflate kernel K6, the swarm engine, then the
region decode) and is counted; a kernel error, and a wrapper's argument error, is never
caught; engine="native" runs native.inflate_parallel (K6). The K6 route of the
chain (ZRS_TPU_VECTOR=0, an index with a stored chunk, a vector fault)
runs K6's plain version; the swarm engine after it is tested in
tests/test_torch_swarm_inflate.py."""

import zlib

import numpy as np
import pytest
import torch

import zlib_rs_tpu.parallel.pipeline as jp
import zlib_rs_tpu.parallel.vector_inflate as JV
import zlib_rs_tpu_torch as zt
from zlib_rs_tpu_torch.ops.kernels import inflate_kernel as IK
from zlib_rs_tpu_torch.ops.kernels import vhuff_kernel as VK
from zlib_rs_tpu_torch.parallel import pipeline as tp
from zlib_rs_tpu_torch.parallel import swarm_inflate as TS
from zlib_rs_tpu_torch.parallel import vector_inflate as TV

# the test workers share the cores, and an oversubscribed OpenMP pool spin-waits
torch.set_num_threads(1)

_BASH = open("/bin/bash", "rb").read()


def _index(entries, seeds):
    index = zt.ChunkIndex(entries)
    index.seeds = seeds
    return index


def _as_gzip(data, zstream, index):
    """The zlib-wrapped indexed stream re-wrapped as gzip: the chunk bodies
    are the bytes the JAX package's own gzip encode emits (header of 10
    bytes against 2), so only the offsets shift."""
    body = zstream[2:-4]
    gz = (bytes([0x1F, 0x8B, 8, 0, 0, 0, 0, 0, 0, 3]) + body
          + zlib.crc32(data).to_bytes(4, "little")
          + (len(data) & 0xFFFFFFFF).to_bytes(4, "little"))
    return gz, _index([(off + 8, ln, n) for off, ln, n in index], index.seeds)


def _bundle(data, zstream, index, gz=None, gz_index=None):
    if gz is None:
        gz, gz_index = _as_gzip(data, zstream, index)
    assert zlib.decompress(zstream) == data and zlib.decompress(gz, 31) == data
    bodies = [zstream[off : off + ln] for off, ln, _ in index]
    return dict(
        data=data, zlib=(zstream, _index(list(index), index.seeds)),
        gzip=(gz, gz_index), bodies=bodies, sizes=[n for _, _, n in index],
        seeds=index.seeds,
    )


@pytest.fixture(scope="module")
def xla_stream():
    mp = pytest.MonkeyPatch()
    mp.delenv("ZRS_TPU_KERNEL", raising=False)
    data = _BASH[:140_000]
    out, index = jp.compress_parallel(data, 6, chunk_size=128 * 1024, return_index=True)
    mp.undo()
    return _bundle(data, out, index)


@pytest.fixture(scope="module")
def kernel_stream():
    # two chunks of /bin/bash, then one of dist-1 and dist-2 runs
    data = _BASH[200_000 : 200_000 + 65_536] + b"a" * 20_000 + b"bc" * 6_384
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ZRS_TPU_KERNEL", "1")  # the port's kernel engine
        out, index = zt.compress_parallel(data, 6, return_index=True, device="cpu")
        gz, gz_index = zt.compress_parallel(data, 6, window_bits=31, return_index=True,
                                            device="cpu")
    return _bundle(data, out, index, gz, gz_index)


@pytest.fixture(params=["xla_stream", "kernel_stream"])
def stream(request):
    return request.getfixturevalue(request.param)


@pytest.fixture(autouse=True)
def clean_fallbacks(monkeypatch):
    monkeypatch.delenv("ZRS_TPU_VECTOR", raising=False)
    monkeypatch.delenv("ZRS_VECTOR_TWOPLANE", raising=False)
    monkeypatch.delenv("ZRS_TPU_KERNEL", raising=False)
    tp._FALLBACKS.clear()
    yield
    tp._FALLBACKS.clear()


def test_decode_chunks_vector_equals_input_and_jax(stream):
    got = TV.decode_chunks_vector(stream["bodies"], stream["sizes"], stream["seeds"], device="cpu")
    want = JV.decode_chunks_vector(stream["bodies"], stream["sizes"], stream["seeds"])
    assert got == want
    assert b"".join(got) == stream["data"]


@pytest.mark.parametrize("wrap", ["zlib", "gzip"])
def test_decompress_parallel_equals_input(stream, wrap):
    comp, index = stream[wrap]
    assert zt.decompress_parallel(comp, index, device="cpu") == stream["data"]
    assert zt.fallback_stats() == {}
    assert zt.decompress_parallel(comp, index, engine="host") == stream["data"]
    assert zt.decompress_parallel(comp, None) == stream["data"]


def _int64_words(real):
    def call(words, *a, **kw):
        return real(words.long(), *a, **kw)
    return call


@pytest.mark.parametrize("fault", ["cap0", "int64_words"])
def test_wrapper_argument_errors_propagate(monkeypatch, kernel_stream, fault):
    # a wrapper's refusal to launch is a plain ValueError, not a data fault:
    # it must not reach the host exact step
    if fault == "cap0":
        monkeypatch.setattr(TV, "_twoplane_cap", lambda m: 0)
        match = "K and cap must be positive"
    else:
        monkeypatch.setattr(VK, "decode_tokens_vector2", _int64_words(VK.decode_tokens_vector2))
        match = "operands must be int32"
    comp, index = kernel_stream["zlib"]
    with pytest.raises(ValueError, match=match) as info:
        zt.decompress_parallel(comp, index, device="cpu")
    assert not isinstance(info.value, TV.VectorDataFault)
    assert zt.fallback_stats() == {}


# ---------------------------------------------------------------------------
# the fail-safe contract, as the JAX package's tests hold it
# ---------------------------------------------------------------------------


def test_corrupt_body_raises(stream):
    bodies = list(stream["bodies"])
    bad = bytearray(bodies[0])
    bad[len(bad) // 2] ^= 0xFF
    bodies[0] = bytes(bad)
    with pytest.raises(TV.VectorDataFault):
        TV.decode_chunks_vector(bodies, stream["sizes"], stream["seeds"], device="cpu")


def test_wrong_seed_raises(stream):
    bits, outs = stream["seeds"][0]
    bits = list(bits)
    bits[1] += 1  # one walker a bit off its symbol boundary
    seeds = [(bits, outs)] + list(stream["seeds"][1:])
    with pytest.raises(TV.VectorDataFault):
        TV.decode_chunks_vector(stream["bodies"], stream["sizes"], seeds, device="cpu")


def test_undersized_cap_raises_and_falls_back(monkeypatch, stream):
    s = stream
    _dev, meta = TV.prepare_vector_inputs(s["bodies"], s["sizes"], s["seeds"], device="cpu")
    cap = TV._twoplane_cap(meta)
    assert int(meta["sspan"].max()) // 3 <= cap <= meta["cap"]
    monkeypatch.setattr(TV, "_twoplane_cap", lambda m: 16)
    with pytest.raises(TV.VectorDataFault, match="bad/short"):
        TV.decode_chunks_vector(s["bodies"], s["sizes"], s["seeds"], device="cpu")
    comp, index = s["zlib"]
    assert zt.decompress_parallel(comp, index, device="cpu") == s["data"]
    assert zt.fallback_stats() == {"vector_decode:ValueError": 1}


def test_seed_count_not_a_multiple_of_128_falls_back(kernel_stream):
    comp, index = kernel_stream["zlib"]
    half = _index(list(index), [(b[:64], o[:64]) for b, o in index.seeds])
    assert zt.decompress_parallel(comp, half, device="cpu") == kernel_stream["data"]
    assert zt.fallback_stats() == {"vector_decode:ValueError": 1}


def test_silently_corrupt_device_result_falls_back(monkeypatch, kernel_stream):
    def corrupt(bodies, out_sizes, seeds, **kw):
        return [b"\x00" * n for n in out_sizes]  # wrong bytes, no fault raised

    monkeypatch.setattr(TV, "decode_chunks_vector", corrupt)
    for wrap in ("zlib", "gzip"):
        comp, index = kernel_stream[wrap]
        assert zt.decompress_parallel(comp, index, device="cpu") == kernel_stream["data"]
    assert zt.fallback_stats() == {"device_checksum:ValueError": 2}


def test_corrupt_stream_raises_after_the_host_step(kernel_stream):
    # the vector result fails the checksum, and so does the region decode's
    comp, index = kernel_stream["zlib"]
    bad = bytearray(comp)
    bad[-1] ^= 0x01  # the adler32 trailer
    with pytest.raises(ValueError, match="incorrect data check"):
        zt.decompress_parallel(bytes(bad), index, device="cpu")
    assert zt.fallback_stats() == {"device_checksum:ValueError": 1}


# ---------------------------------------------------------------------------
# what is never caught, and what is not ported
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("exc", [RuntimeError, OSError, NotImplementedError])
def test_kernel_errors_propagate(monkeypatch, kernel_stream, exc):
    def failing(*a, **kw):
        raise exc("vhuff_decode: CUDA launch failed with error 700")

    monkeypatch.setattr(VK, "decode_tokens_vector2", failing)
    comp, index = kernel_stream["zlib"]
    with pytest.raises(exc):
        zt.decompress_parallel(comp, index, device="cpu")
    assert zt.fallback_stats() == {}


def test_unseeded_index_decodes_through_k6(kernel_stream):
    # an index without seeds for every chunk skips the vector engine
    comp, index = kernel_stream["zlib"]
    for seeds in (None, [None] + list(index.seeds[1:])):
        got = zt.decompress_parallel(comp, _index(list(index), seeds), device="cpu")
        assert got == kernel_stream["data"]
    assert zt.fallback_stats() == {}
    assert zt.decompress_parallel(comp, _index(list(index), None), engine="host") == kernel_stream["data"]


def _stored_chunk_input():
    rng = np.random.default_rng(12)
    noise = rng.integers(0, 256, 32_768, dtype=np.uint8).tobytes()
    return _BASH[:32_768] + noise + _BASH[40_000:50_000]


# ---------------------------------------------------------------------------
# the single-plane engine (ZRS_VECTOR_TWOPLANE=0: K11a, K11b)
# ---------------------------------------------------------------------------


_JAX_SINGLE = {}


@pytest.mark.parametrize("wrap", ["zlib", "gzip"])
def test_single_plane_engine_decodes(monkeypatch, stream, wrap):
    monkeypatch.setenv("ZRS_VECTOR_TWOPLANE", "0")
    dec = _spy(monkeypatch, VK, "decode_tokens_vector")
    exp = _spy(monkeypatch, VK, "expand_tokens")
    two = _spy(monkeypatch, VK, "decode_tokens_vector2")
    k6 = _spy(monkeypatch, TS, "decode_chunks_kernel")
    comp, index = stream[wrap]
    assert zt.decompress_parallel(comp, index, device="cpu") == stream["data"]
    assert zt.fallback_stats() == {}
    assert dec == ["decode_tokens_vector"] and exp == ["expand_tokens"]
    assert two == [] and k6 == []
    args = (stream["bodies"], stream["sizes"], stream["seeds"])
    got = TV.decode_chunks_vector(*args, device="cpu")
    if stream["data"] not in _JAX_SINGLE:  # one JAX decode of the bodies per stream
        _JAX_SINGLE[stream["data"]] = JV.decode_chunks_vector(*args)
    assert got == _JAX_SINGLE[stream["data"]]
    assert b"".join(got) == stream["data"]


def test_single_plane_corrupt_body_lands_on_k6(monkeypatch, kernel_stream):
    monkeypatch.setenv("ZRS_VECTOR_TWOPLANE", "0")
    comp, index = kernel_stream["zlib"]
    off, ln, _n = index[1]
    broken = bytearray(comp)
    broken[off + ln // 2] ^= 0xFF
    k6 = _spy(monkeypatch, TS, "decode_chunks_kernel")
    with pytest.raises(TV.VectorDataFault):
        TV.decode_chunks_vector(
            [bytes(broken[o : o + n]) for o, n, _ in index], kernel_stream["sizes"],
            kernel_stream["seeds"], device="cpu",
        )
    with pytest.raises(ValueError):
        zt.decompress_parallel(bytes(broken), index, device="cpu")
    assert k6 == ["decode_chunks_kernel"]
    stats = zt.fallback_stats()
    assert stats.pop("vector_decode:ValueError") == 1
    # K6 flags the lane or returns wrong bytes; after a flag the seeded
    # swarm engine runs, as in the reference, and flags or returns wrong
    # bytes; the checksum catches wrong bytes. The region decode runs last:
    # K6 returns the same wrong bytes, or refuses the region (counted) and
    # the lockstep engine flags it or returns wrong bytes
    assert stats in ({"device_checksum:ValueError": 1},
                     {"kernel_decode:ValueError": 1, "swarm_decode:ValueError": 1,
                      "region_kernel:ValueError": 1},
                     {"kernel_decode:ValueError": 1, "device_checksum:ValueError": 1,
                      "region_kernel:ValueError": 1})


# ---------------------------------------------------------------------------
# the inflate kernel K6 in the chain
# ---------------------------------------------------------------------------


def _spy(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def spy(*a, **kw):
        calls.append(name)
        return real(*a, **kw)

    monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize("wrap", ["zlib", "gzip"])
def test_vector_off_decodes_through_k6(monkeypatch, stream, wrap):
    monkeypatch.setenv("ZRS_TPU_VECTOR", "0")
    calls = _spy(monkeypatch, TS, "decode_chunks_kernel")
    vec = _spy(monkeypatch, TV, "decode_chunks_vector")
    comp, index = stream[wrap]
    assert zt.decompress_parallel(comp, index, device="cpu") == stream["data"]
    assert calls == ["decode_chunks_kernel"] and vec == []
    assert zt.fallback_stats() == {}


@pytest.mark.parametrize("make,stored", [
    (_stored_chunk_input, [False, True, False]),
    (lambda: np.random.default_rng(12).integers(0, 256, 40_000, dtype=np.uint8).tobytes(),
     [True, True]),
])
def test_stored_chunk_index_decodes_through_k6(monkeypatch, make, stored):
    # a stored chunk carries no seeds: K6 decodes the whole index, and the
    # host step decodes it alone
    data = make()
    monkeypatch.setenv("ZRS_TPU_KERNEL", "1")
    comp, index = zt.compress_parallel(data, 6, return_index=True, device="cpu")
    assert [s is None for s in index.seeds] == stored
    calls = _spy(monkeypatch, TS, "decode_chunks_kernel")
    assert zt.decompress_parallel(comp, index, device="cpu") == data
    assert calls == ["decode_chunks_kernel"] and zt.fallback_stats() == {}
    assert zt.decompress_parallel(comp, index, engine="host") == data


def test_vector_fault_is_counted_and_k6_decodes(monkeypatch, stream):
    monkeypatch.setattr(TV, "_twoplane_cap", lambda m: 16)
    calls = _spy(monkeypatch, TS, "decode_chunks_kernel")
    comp, index = stream["zlib"]
    assert zt.decompress_parallel(comp, index, device="cpu") == stream["data"]
    assert calls == ["decode_chunks_kernel"]
    assert zt.fallback_stats() == {"vector_decode:ValueError": 1}


def test_kernel_fault_is_counted_and_the_decode_raises(monkeypatch, kernel_stream):
    # BTYPE 3 in the second chunk's first block header: K6 flags the lane,
    # the swarm engine after it (every chunk has seeds, as in the
    # reference) cannot parse the header, and the region decode fails on
    # the same block: K6 refuses the region, the lockstep engine flags it
    comp, index = kernel_stream["zlib"]
    broken = bytearray(comp)
    off, _ln, _n = index[1]
    broken[off] |= 0x06
    monkeypatch.setenv("ZRS_TPU_VECTOR", "0")
    with pytest.raises(ValueError):
        zt.decompress_parallel(bytes(broken), index, device="cpu")
    assert zt.fallback_stats() == {"kernel_decode:ValueError": 1, "swarm_decode:ValueError": 1,
                                   "region_kernel:ValueError": 1}


def test_corrupt_device_result_falls_back(monkeypatch, kernel_stream):
    # mirror of the JAX package's test: every device engine returns wrong
    # bytes without raising; the checksum discards them once, the host
    # step decodes
    def corrupt_vector(bodies, out_sizes, seeds, **kw):
        return [b"\x00" * n for n in out_sizes]

    def corrupt_kernel(bodies, out_sizes, **kw):
        return [b"\x00" * n for n in out_sizes]

    monkeypatch.setattr(TV, "decode_chunks_vector", corrupt_vector)
    monkeypatch.setattr(TS, "decode_chunks_kernel", corrupt_kernel)
    for vector in ("1", "0"):
        monkeypatch.setenv("ZRS_TPU_VECTOR", vector)
        comp, index = kernel_stream["zlib"]
        assert zt.decompress_parallel(comp, index, device="cpu") == kernel_stream["data"]
    assert zt.fallback_stats() == {"device_checksum:ValueError": 2}


def test_kernel_wrapper_errors_propagate(monkeypatch, kernel_stream):
    def failing(*a, **kw):
        raise RuntimeError("inflate: CUDA launch failed with error 700")

    monkeypatch.setattr(IK, "decode_streams", failing)
    monkeypatch.setenv("ZRS_TPU_VECTOR", "0")
    comp, index = kernel_stream["zlib"]
    with pytest.raises(RuntimeError, match="inflate"):
        zt.decompress_parallel(comp, index, device="cpu")
    assert zt.fallback_stats() == {}


def test_engine_native_and_unknown_engines(kernel_stream):
    comp, index = kernel_stream["zlib"]
    # engine="native": native.inflate_parallel on the card, or its plain
    # K6 on the CPU, equal to the reference's native engine
    with pytest.raises(RuntimeError, match="CUDA"):
        zt.decompress_parallel(comp, index, engine="native")
    got = zt.decompress_parallel(comp, index, engine="native", device="cpu")
    assert got == jp.decompress_parallel(comp, index, engine="native") == kernel_stream["data"]
    with pytest.raises(ValueError, match="unknown engine"):
        zt.decompress_parallel(comp, index, engine="kernel")


def test_no_gpu_and_no_device_raises(monkeypatch, kernel_stream):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    comp, index = kernel_stream["zlib"]
    with pytest.raises(RuntimeError, match="CUDA"):
        zt.decompress_parallel(comp, index)
    with pytest.raises(RuntimeError, match="CUDA"):
        TV.decode_chunks_vector(kernel_stream["bodies"], kernel_stream["sizes"], kernel_stream["seeds"])
