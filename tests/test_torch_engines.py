"""decompress_parallel's engine names and the last step of its device
chain, on the CPU (device="cpu": the kernels' plain versions).

engine="tpu" is the port's "device" chain under the reference's name;
engine="auto" is the reference's "auto" without its native engine, the
region decode alone (`inflate.decompress_chunks`: K6, then the lockstep
engine), held against the JAX package's `decompress_parallel(...,
engine="auto")` with `zlib_rs_tpu.native.available` patched to False.
After the chunk engines fault, or a result fails the container checksum,
the device chain ends in the same region decode, never in the host exact
step. The streams stay at a few KiB: the lockstep engine decodes one
symbol a step."""

import zlib

import pytest
import torch

import native_build  # noqa: F401  (the JAX package's native library, built once under a lock)

import zlib_rs_tpu.native as jnative
import zlib_rs_tpu.parallel.pipeline as jp
import zlib_rs_tpu_torch as zt
from zlib_rs_tpu_torch.ops.kernels import inflate_kernel as IK
from zlib_rs_tpu_torch.parallel import device_inflate as DI
from zlib_rs_tpu_torch.parallel import inflate as TI
from zlib_rs_tpu_torch.parallel import pipeline as tp
from zlib_rs_tpu_torch.parallel import swarm_inflate as TS
from zlib_rs_tpu_torch.parallel import vector_inflate as TV

# the test workers share the cores, and an oversubscribed OpenMP pool spin-waits
torch.set_num_threads(1)

DATA = open("/bin/bash", "rb").read()[250_000 : 250_000 + 10_001]  # three 4 KiB chunks


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    for name in ("ZRS_TPU_KERNEL", "ZRS_TPU_VECTOR", "ZRS_VECTOR_TWOPLANE"):
        monkeypatch.delenv(name, raising=False)
    tp._FALLBACKS.clear()
    yield
    tp._FALLBACKS.clear()


@pytest.fixture(scope="module")
def streams():
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("ZRS_TPU_KERNEL", raising=False)  # the XLA engine
        out = {wb: zt.compress_parallel(DATA, 6, window_bits=wb, chunk_size=4096,
                                        return_index=True, device="cpu")
               for wb in (15, 31)}
    for wb, (comp, index) in out.items():
        assert zlib.decompress(comp, wb) == DATA and len(index) == 3
        assert all(s is not None for s in index.seeds)
    return {"zlib": out[15], "gzip": out[31]}


def _spy(monkeypatch, module, name, calls):
    real = getattr(module, name)

    def spy(*a, **kw):
        calls.append(name)
        return real(*a, **kw)

    monkeypatch.setattr(module, name, spy)


@pytest.fixture
def calls(monkeypatch):
    seen = []
    for module, name in ((TV, "decode_chunks_vector"), (TS, "decode_chunks_kernel"),
                         (TS, "decode_chunks_seeded"), (TI, "decompress_chunks"),
                         (tp, "_chunks_host_exact"), (IK, "decode_streams_plain"),
                         (DI, "decode_regions")):
        _spy(monkeypatch, module, name, seen)
    return seen


@pytest.mark.parametrize("wrap", ["zlib", "gzip"])
def test_tpu_equals_device(streams, calls, wrap):
    comp, index = streams[wrap]
    got = zt.decompress_parallel(comp, index, engine="device", device="cpu")
    stats = zt.fallback_stats()
    seen = list(calls)
    calls.clear()
    assert zt.decompress_parallel(comp, index, engine="tpu", device="cpu") == got == DATA
    assert zt.fallback_stats() == stats == {}
    assert calls == seen == ["decode_chunks_vector"]


@pytest.mark.parametrize("wrap", ["zlib", "gzip"])
def test_auto_equals_jax_auto_without_native(monkeypatch, streams, calls, wrap):
    comp, index = streams[wrap]
    got = zt.decompress_parallel(comp, index, engine="auto", device="cpu")
    # the region decode alone: one K6 (plain) run over the chunks, no
    # chunk engine, no lockstep run
    assert calls == ["decompress_chunks", "decode_streams_plain"]
    assert zt.fallback_stats() == {}
    monkeypatch.setattr(jnative, "available", lambda: False)
    assert got == jp.decompress_parallel(comp, list(index), engine="auto") == DATA


def _fault(exc):
    def fail(*a, **kw):
        raise exc("a data fault")
    return fail


@pytest.mark.parametrize("kernel_env", [None, "0"])
def test_last_step_after_every_engine_faults(monkeypatch, streams, calls, kernel_env):
    if kernel_env is not None:
        monkeypatch.setenv("ZRS_TPU_KERNEL", kernel_env)
    monkeypatch.setattr(TV, "decode_chunks_vector", _fault(TV.VectorDataFault))
    monkeypatch.setattr(TS, "decode_chunks_kernel", _fault(TS.KernelDataFault))
    monkeypatch.setattr(TS, "decode_chunks_seeded", _fault(TS.SwarmDataFault))
    comp, index = streams["zlib"]
    assert zt.decompress_parallel(comp, index, device="cpu") == DATA
    assert calls == ["decompress_chunks", "decode_streams_plain"]
    want = {"vector_decode:ValueError": 1, "swarm_decode:ValueError": 1}
    if kernel_env is None:
        want["kernel_decode:ValueError"] = 1
    assert zt.fallback_stats() == want


@pytest.mark.parametrize("wrap", ["zlib", "gzip"])
def test_last_step_after_a_checksum_failure(monkeypatch, streams, calls, wrap):
    monkeypatch.setattr(TV, "decode_chunks_vector",
                        lambda bodies, sizes, seeds, **kw: [b"\0" * n for n in sizes])
    comp, index = streams[wrap]
    assert zt.decompress_parallel(comp, index, device="cpu") == DATA
    assert calls == ["decompress_chunks", "decode_streams_plain"]
    assert zt.fallback_stats() == {"device_checksum:ValueError": 1}


def test_last_step_recovers_through_the_lockstep_engine(monkeypatch, streams, calls):
    # K6 refuses a region of the last step too: counted, and the lockstep
    # engine decodes that region (the reference retries them all; the
    # bytes are the same)
    real = IK.decode_streams

    def one_bad_lane(*a, **kw):
        out, produced, bad, end_bit = real(*a, **kw)
        bad = bad.clone()
        bad[1] = True
        return out, produced, bad, end_bit

    monkeypatch.setattr(IK, "decode_streams", one_bad_lane)
    monkeypatch.setenv("ZRS_TPU_KERNEL", "0")
    monkeypatch.setattr(TV, "decode_chunks_vector", _fault(TV.VectorDataFault))
    monkeypatch.setattr(TS, "decode_chunks_seeded", _fault(TS.SwarmDataFault))
    lanes = []
    real_regions = DI.decode_regions
    monkeypatch.setattr(DI, "decode_regions",
                        lambda comp, *a: lanes.append(comp.shape[0]) or real_regions(comp, *a))
    before = dict(DI.runs)
    comp, index = streams["gzip"]
    assert zt.decompress_parallel(comp, index, device="cpu") == DATA
    assert calls == ["decompress_chunks", "decode_streams_plain", "decode_regions"]
    assert lanes == [1]
    assert DI.runs["decode_regions"] == before["decode_regions"] + 1
    assert DI.runs["steps"] > before["steps"]
    assert zt.fallback_stats() == {"vector_decode:ValueError": 1,
                                   "swarm_decode:ValueError": 1,
                                   "region_kernel:ValueError": 1}


@pytest.mark.parametrize("engine", ["device", "tpu", "auto"])
@pytest.mark.parametrize("where", ["body", "trailer"])
def test_corrupt_stream_raises(streams, engine, where):
    comp, index = streams["zlib"]
    bad = bytearray(comp)
    if where == "body":
        off, ln, _n = index[1]
        bad[off + ln // 2] ^= 0xFF
    else:
        bad[-1] ^= 0x01  # the adler32
    with pytest.raises(ValueError):
        zt.decompress_parallel(bytes(bad), index, engine=engine, device="cpu")
    if where == "trailer":
        with pytest.raises(ValueError, match="incorrect data check"):
            zt.decompress_parallel(bytes(bad), index, engine=engine, device="cpu")


@pytest.mark.parametrize("engine", ["device", "tpu", "auto", "host"])
def test_every_engine_decodes_a_whole_stream_without_index(streams, engine):
    comp, _index = streams["gzip"]
    assert zt.decompress_parallel(comp, None, engine=engine, device="cpu") == DATA


def test_native_and_unknown_names(streams):
    comp, index = streams["zlib"]
    # engine="native" is the reference's native engine on the card
    # (native.inflate_parallel: K6 over the chunks); with no GPU here and
    # no device it raises, and on the CPU its bytes are the reference's
    with pytest.raises(RuntimeError, match="CUDA"):
        zt.decompress_parallel(comp, index, engine="native")
    got = zt.decompress_parallel(comp, index, engine="native", device="cpu")
    assert got == jp.decompress_parallel(comp, index, engine="native") == DATA
    for name in ("kernel", "lockstep", "cuda", ""):
        with pytest.raises(ValueError, match="unknown engine"):
            zt.decompress_parallel(comp, index, engine=name, device="cpu")


@pytest.mark.parametrize("engine", ["device", "tpu", "auto"])
def test_device_engines_need_a_gpu_or_a_device(monkeypatch, streams, engine):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    comp, index = streams["zlib"]
    with pytest.raises(RuntimeError, match="CUDA"):
        zt.decompress_parallel(comp, index, engine=engine)
    assert zt.decompress_parallel(comp, index, engine="host") == DATA
