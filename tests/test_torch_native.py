"""`zlib_rs_tpu_torch.native`, the reference's native engine on the card,
on the CPU (device="cpu": the kernels' plain versions): its public names
are `zlib_rs_tpu.native`'s, and each function is held against the
reference's (its C++ engine built with g++ here) on small inputs. The
handles are held pump for pump in tests/test_torch_istream.py and
tests/test_torch_dstream.py; here only their surface."""

import inspect
import types
import zlib

import pytest
import torch

import native_build  # noqa: F401  (the JAX package's native library, built once under a lock)

import zlib_rs_tpu.native as J
import zlib_rs_tpu_torch as zt
import zlib_rs_tpu_torch.native as T
from zlib_rs_tpu_torch.parallel import speculative as SP

# the test workers share the cores, and an oversubscribed OpenMP pool spin-waits
torch.set_num_threads(1)

_BASH = open("/bin/bash", "rb").read()
DATA = _BASH[100_000:104_096]  # a slice where native and zlib agree at every level
WINDOW = _BASH[100_000 - 40_000 : 100_000]
CPU = {"device": "cpu"}


def public(mod):
    """The names a module defines for its users: no underscore, no module,
    nothing imported from elsewhere."""
    out = set()
    for name, v in vars(mod).items():
        if name.startswith("_") or isinstance(v, types.ModuleType):
            continue
        if getattr(v, "__module__", mod.__name__) != mod.__name__:
            continue
        out.add(name)
    return out


def test_public_names_are_the_references():
    assert public(T) == public(J)
    assert len(public(J)) == 17
    assert zt.native is T
    for name in ("QUICK", "MEDIUM_BASE", "MEDIUM4", "MEDIUM5", "MEDIUM6"):
        assert getattr(T, name) == getattr(J, name)
    assert T.available() is True


def test_every_function_takes_a_device_and_nthreads_where_native_does():
    for name in sorted(public(J)):
        ref = getattr(J, name)
        if not callable(ref) or name in ("available", "adler32", "crc32"):
            continue  # host functions, as native's are
        params = inspect.signature(getattr(T, name)).parameters
        assert "device" in params, name
        for p in inspect.signature(ref).parameters:
            assert p in params, (name, p)


def test_checksums():
    for start in (0, 1, 0xDEADBEEF):
        assert T.adler32(DATA, start) == J.adler32(DATA, start)
        assert T.crc32(DATA, start) == J.crc32(DATA, start)


@pytest.mark.parametrize("level", [0, 1, 4, 6, 9, T.QUICK, T.MEDIUM5])
def test_deflate_chunk(level):
    for final in (True, False):
        got = T.deflate_chunk(DATA, level, final, **CPU)
        assert got == J.deflate_chunk(DATA, level, final)
    if level not in (0, T.QUICK, T.MEDIUM5):  # EX follows zlib on a window's tail
        c = zlib.compressobj(level, zlib.DEFLATED, -15, 8, 0, zdict=WINDOW[-32768:])
        assert T.deflate_chunk(DATA, level, True, WINDOW, **CPU) == c.compress(DATA) + c.flush()


@pytest.mark.parametrize("level", [1, 6])
def test_deflate_parallel(level):
    data = _BASH[100_000:108_192]
    for prime in (True, False):
        got = T.deflate_parallel(data, level, 4096, prime, nthreads=3, **CPU)
        assert zlib.decompress(got, -15) == data
        if not prime:
            assert got == J.deflate_parallel(data, level, 4096, prime)


def test_inflate_raw_speculative_zran_and_region(monkeypatch):
    monkeypatch.setattr(SP, "SEGMENT_BYTES", 2048)  # several segments on a few KiB
    data = _BASH[200_000:260_000]
    c = zlib.compressobj(6, zlib.DEFLATED, -15)  # a block start every 8 KiB
    raw = b"".join(c.compress(data[i : i + 8192]) + c.flush(zlib.Z_SYNC_FLUSH)
                   for i in range(0, len(data), 8192)) + c.flush()
    tail = raw + b"after"
    assert T.inflate_raw(tail, 1 << 20, **CPU) == J.inflate_raw(tail, 1 << 20)
    assert T.inflate_speculative(tail, 1 << 20, 4, **CPU) == J.inflate_speculative(tail, 1 << 20)
    got = T.zran_index(raw, 8192, 1 << 20, **CPU)
    assert got == J.zran_index(raw, 8192, 1 << 20) and len(got[1]) > 1
    out_off, bit = got[1][-1]
    window = data[out_off - 32768 : out_off]
    at = T.inflate_region(raw[bit // 8 :], bit % 8, window, 5000, **CPU)
    assert at == J.inflate_region(raw[bit // 8 :], bit % 8, window, 5000) == \
        data[out_off : out_off + 5000]
    with pytest.raises(ValueError, match="invalid deflate data|truncated"):
        T.inflate_raw(raw[: len(raw) // 2], 1 << 20, **CPU)


def test_inflate_parallel_and_its_errors():
    data = _BASH[300_000:312_000]
    comp, index = zt.compress_parallel(data, 6, chunk_size=4096, return_index=True, **CPU)
    assert T.inflate_parallel(comp, index, 2, **CPU) == J.inflate_parallel(comp, index) == data
    short = [(o, ln, s + 7) if k == 1 else (o, ln, s) for k, (o, ln, s) in enumerate(index)]
    with pytest.raises(ValueError) as te:
        T.inflate_parallel(comp, short, **CPU)
    with pytest.raises(ValueError) as je:
        J.inflate_parallel(comp, short)
    assert str(te.value) == str(je.value)
    long_ = [(o, ln, s - 7) if k == 2 else (o, ln, s) for k, (o, ln, s) in enumerate(index)]
    with pytest.raises(ValueError) as te:
        T.inflate_parallel(comp, long_, **CPU)
    with pytest.raises(ValueError) as je:
        J.inflate_parallel(comp, long_)
    assert str(te.value) == str(je.value) == "chunk 2 failed to decode"
    assert T.inflate_parallel(comp, [], **CPU) == J.inflate_parallel(comp, []) == b""


def test_stream_handles_surface():
    comp = zlib.compress(DATA)[2:-4]
    t, j = T.RawInflateStream(**CPU), J.RawInflateStream()
    assert t.pump(comp, 100) == j.pump(comp, 100)
    assert (t.done, t.error, t.total_out) == (j.done, j.error, j.total_out)
    assert t.copy().pump(b"", None) == j.copy().pump(b"", None)
    d, e = T.RawDeflateStream(6, **CPU), J.RawDeflateStream(6)
    assert d.pump(DATA, 2) == e.pump(DATA, 2) and d.window() == e.window()
    assert d.copy().pump(b"", 4) == e.copy().pump(b"", 4)
    assert d.pump(b"x", 4) == e.pump(b"x", 4) and d.finished and e.finished


@pytest.mark.parametrize("level", [T.MEDIUM4, T.MEDIUM5, T.MEDIUM6])
def test_medium_stream_handle_surface(level):
    """RawDeflateStream takes MEDIUM4-6, as native's handle does: the
    bytes, the window and a copy pump for pump."""
    d, e = T.RawDeflateStream(level, **CPU), J.RawDeflateStream(level)
    assert d.pump(DATA, 2) == e.pump(DATA, 2) and d.window() == e.window()
    assert d.copy().pump(b"", 4) == e.copy().pump(b"", 4)
    assert d.pump(b"x", 4) == e.pump(b"x", 4) and d.finished and e.finished


def test_no_gpu_and_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: T.deflate_chunk(DATA), lambda: T.inflate_raw(b"\x03\x00", 10),
                 lambda: T.inflate_parallel(b"", [(0, 0, 0)]), T.RawInflateStream,
                 T.RawDeflateStream):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
