"""DS (the `zrs_dstream_pump` entry of csrc/exact_deflate.cu), EX's
Deflater paused and resumed under the port's stream objects and gzip
files, on the CPU: its source built as host C++ by g++ (a warp of one
lane) through the kernel's handle (`dstream_kernel.Handle` on CPU tensors,
its launch patched to the host build), and its plain version
(`dstream_kernel.Plain`, the host Deflator), each through the port's
`native.RawDeflateStream`, against the reference's native handle
(`zlib_rs_tpu.native.RawDeflateStream`, built with g++ here) pump for pump
and against stdlib zlib on the whole stream. Every comparison is exact."""

import ctypes
import random
import shutil
import subprocess
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import native_build  # noqa: F401  (the JAX package's native library, built once under a lock)

from zlib_rs_tpu import native as jnative
from zlib_rs_tpu_torch import native as tnative
from zlib_rs_tpu_torch.ops.kernels import dstream_kernel as DK

# the test workers share the cores, and an oversubscribed OpenMP pool spin-waits
torch.set_num_threads(1)

SRC = Path(__file__).resolve().parents[1] / "zlib_rs_tpu_torch" / "csrc" / "exact_deflate.cu"
_BASH = open("/bin/bash", "rb").read()
_rng = np.random.default_rng(20)
SOURCES = {
    "binary": _BASH[120_000:136_384],
    "text": b"".join(b"line %d of a log: status=%s\n" % (i, b"ok" if i % 7 else b"retry")
                     for i in range(600))[:16_384],
    "random": _rng.integers(0, 256, 16_384, dtype=np.uint8).tobytes(),
}
ZFLUSH = {0: zlib.Z_NO_FLUSH, 2: zlib.Z_SYNC_FLUSH, 3: zlib.Z_FULL_FLUSH, 4: zlib.Z_FINISH}


@pytest.fixture(scope="module")
def host_ds(tmp_path_factory):
    """csrc/exact_deflate.cu built by g++ (no __CUDACC__: one lane), as a
    stand-in for dstream_kernel.pump."""
    gxx = shutil.which("g++")
    assert gxx, "g++ builds the reference's native engine and this file's host build"
    lib = tmp_path_factory.mktemp("ds") / "libds_host.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-x", "c++", str(SRC), "-o",
                    str(lib)], check=True, capture_output=True, timeout=300)
    dll = ctypes.CDLL(str(lib))
    dll.zrs_dstream_pump_host.argtypes = [ctypes.c_void_p] * 4
    dll.zrs_dstream_record_len.restype = ctypes.c_longlong
    assert dll.zrs_dstream_record_len() == DK.REC

    def pump(rec, data, work, out, rec_dev=None):
        dll.zrs_dstream_pump_host(rec.ctypes.data, data.data_ptr(), work.data_ptr(),
                                  out.data_ptr())

    return pump


@pytest.fixture(params=["host", "plain"])
def make(request, monkeypatch, host_ds):
    """A port stream at a level: 'host' DS's source through its handle,
    'plain' the plain version."""
    if request.param == "host":
        monkeypatch.setattr(DK, "pump", host_ds)
        return lambda level: tnative.RawDeflateStream(
            level, _handle=DK.Handle(level, "cpu"))
    return lambda level: tnative.RawDeflateStream(level, device="cpu")


def run(s, script):
    """Steps ("pump", data, flush), ("window",) and ("copy",) on stream s;
    at a copy the original runs the rest (logged) and the copy goes on."""
    log = []
    for i, step in enumerate(script):
        if step[0] == "window":
            log.append(s.window())
        elif step[0] == "copy":
            c = s.copy()
            log.append([s.pump(st[1], st[2]) for st in script[i + 1 :] if st[0] == "pump"])
            s = c
        else:
            log.append(s.pump(step[1], step[2]))
    return log


def zlib_of(script, level: int) -> bytes:
    """stdlib zlib's raw stream for a script (no empty repeated flush)."""
    c = zlib.compressobj(level, zlib.DEFLATED, -15)
    out = b""
    for kind, data, flush in script:
        out += c.compress(data)
        if flush:
            out += c.flush(ZFLUSH[flush])
    return out


def scripted(data: bytes, rng, sizes, flushes=(0, 0, 0, 0, 2, 3)):
    script, pos = [], 0
    while pos < len(data):
        n = rng.choice(sizes)
        script.append(("pump", data[pos : pos + n], rng.choice(flushes)))
        pos += n
    return script + [("pump", b"", 4)]


@pytest.mark.parametrize("level", range(1, 10))
@pytest.mark.parametrize("source", sorted(SOURCES))
def test_flush_scripts_equal_native_and_zlib(make, source, level):
    rng = random.Random(level * 31 + len(source))
    script = scripted(SOURCES[source], rng, [1, 50, 700, 3000, 9000])
    got = run(make(level), script)
    assert got == run(jnative.RawDeflateStream(level), script)
    assert b"".join(got) == zlib_of(script, level)


@pytest.mark.parametrize("level", [1, 6])
def test_pump_sizes_from_one_byte_to_64k(make, level):
    data = _BASH[200_000:202_048] + _BASH[300_000:365_536]
    script = [("pump", data[i : i + 1], 0) for i in range(2048)]
    script += [("pump", data[2048 + i : 2048 + i + 65536], 0) for i in range(0, 65536, 65536)]
    script += [("pump", b"", 4)]
    got = run(make(level), script)
    assert got == run(jnative.RawDeflateStream(level), script)
    assert b"".join(got) == zlib_of(script, level)


def test_empty_pumps_and_repeated_flushes(make):
    data = SOURCES["binary"][:6000]
    script = [("pump", b"", 0), ("pump", data[:3000], 0), ("pump", b"", 0), ("pump", b"", 2),
              ("pump", b"", 2), ("pump", b"", 3), ("pump", data[3000:], 2), ("pump", b"", 0),
              ("pump", b"", 4)]
    got = run(make(6), script)
    assert got == run(jnative.RawDeflateStream(6), script)
    assert zlib.decompress(b"".join(got), -15) == data


@pytest.mark.parametrize("flush", [2, 3])
def test_window_at_a_seam_and_copy_mid_stream(make, flush):
    data = SOURCES["text"]
    script = [("pump", data[:5000], 0), ("pump", data[5000:9000], flush), ("window",),
              ("copy",), ("pump", data[9000:12000], 0), ("window",),
              ("pump", data[12000:], 4)]
    got = run(make(6), script)
    assert got == run(jnative.RawDeflateStream(6), script)


@pytest.mark.parametrize("level", [1, 6, 9])
def test_a_stream_past_1mib_prunes_and_rebases(monkeypatch, host_ds, level):
    """The host build alone (the plain version takes about a minute a
    MiB): 1.5 MiB in 128 KiB pumps, a flush now and then, pump for pump
    native's bytes, with the data pruned by multiples of 32 KiB."""
    monkeypatch.setattr(DK, "pump", host_ds)
    data = (_BASH * 2)[: 3 << 19]
    rng = random.Random(level)
    script = scripted(data, rng, [1 << 17], flushes=(0, 0, 0, 2))
    handle = DK.Handle(level, "cpu")
    got = run(tnative.RawDeflateStream(level, _handle=handle), script)
    assert got == run(jnative.RawDeflateStream(level), script)
    assert b"".join(got) == zlib_of(script, level)
    assert handle.rec[DK.D_TOTAL] <= len(data) - DK.PRUNE  # the prune ran


def test_an_outgrown_room_raises(monkeypatch, host_ds):
    monkeypatch.setattr(DK, "pump", host_ds)
    monkeypatch.setattr(DK, "room", lambda unflushed: 16)
    s = tnative.RawDeflateStream(6, _handle=DK.Handle(6, "cpu"))
    with pytest.raises(RuntimeError, match="overflow"):
        s.pump(SOURCES["random"], 2)


@pytest.mark.parametrize("level", [0, tnative.QUICK])
def test_level_0_and_quick_are_misuse(make, level):
    with pytest.raises(RuntimeError, match="misuse"):
        jnative.RawDeflateStream(level).pump(b"abc", 0)
    s = make(level)
    with pytest.raises(RuntimeError, match="misuse"):
        s.pump(b"abc", 0)


def test_finished_stream_is_misuse(make):
    s = make(6)
    s.pump(b"abc", 4)
    with pytest.raises(RuntimeError, match="misuse"):
        s.pump(b"more", 0)


MEDIUMS = [tnative.MEDIUM4, tnative.MEDIUM5, tnative.MEDIUM6]


def medium_checked(make, level, script, want_out: bytes) -> list:
    """A MEDIUM script on the port's stream, pump for pump native's bytes,
    the whole stream decoded by zlib to `want_out`."""
    got = run(make(level), script)
    assert got == run(jnative.RawDeflateStream(level), script)
    assert zlib.decompress(b"".join(g for g in got if isinstance(g, bytes)), -15) == want_out
    return got


@pytest.mark.parametrize("level", MEDIUMS)
@pytest.mark.parametrize("source", sorted(SOURCES))
def test_medium_flush_scripts_equal_native(make, source, level):
    """MEDIUM4-6 under NO/SYNC/FULL/FINISH scripts, pieces of 1 byte to 9
    KB: zlib's bytes are not the contract here, native's are."""
    rng = random.Random(level * 31 + len(source))
    script = scripted(SOURCES[source], rng, [1, 50, 700, 3000, 9000])
    medium_checked(make, level, script, SOURCES[source])


@pytest.mark.parametrize("level", MEDIUMS)
def test_medium_pump_sizes_from_one_byte_to_64k(make, level):
    data = _BASH[200_000:202_048] + _BASH[300_000:365_536]
    script = [("pump", data[i : i + 1], 0) for i in range(2048)]
    script += [("pump", data[2048:], 0), ("pump", b"", 4)]
    medium_checked(make, level, script, data)


@pytest.mark.parametrize("level", MEDIUMS)
def test_medium_full_flush_keeps_head4_and_decodes(make, level):
    """FULL_FLUSH restarts the window at position 0 but leaves head4's
    positions of up to 200 KB behind (native's): the deltas of the first
    inserts after it are negative and wrap in their u16 slots. Native's
    bytes, which the port gives, decode; a copy and the window at the
    seam too."""
    d1, d2 = _BASH[300_000:500_000], _BASH[300_000:400_000] + _BASH[600_000:650_000]
    script = [("pump", d1, 0), ("pump", b"", 3), ("window",), ("copy",), ("pump", d2, 0),
              ("pump", b"", 3), ("pump", d2[:5000], 2), ("pump", b"", 4)]
    got = medium_checked(make, level, script, d1 + d2 + d2[:5000])
    assert got[2] == b""  # the window restarts at a FULL_FLUSH


@pytest.mark.parametrize("level", MEDIUMS)
def test_medium_finish_only_equals_compress_medium(make, level):
    from zlib_rs_tpu_torch.models import medium as TM

    data = SOURCES["binary"] + SOURCES["text"]
    got = medium_checked(make, level, [("pump", data, 4)], data)
    assert got == [TM.compress_medium(data, level - tnative.MEDIUM_BASE + 4)]
    assert got == [jnative.deflate_chunk(data, level, True)]


@pytest.mark.parametrize("level", MEDIUMS)
def test_medium_stream_past_1mib_prunes_and_rebases(monkeypatch, host_ds, level):
    """The host build alone (the plain version takes about 10 s a MiB):
    1.5 MiB in 128 KiB pumps, a flush now and then, pump for pump native's
    bytes, with the data pruned and head4 and the next match rebased."""
    monkeypatch.setattr(DK, "pump", host_ds)
    data = (_BASH * 2)[: 3 << 19]
    script = scripted(data, random.Random(level), [1 << 17], flushes=(0, 0, 0, 2))
    handle = DK.Handle(level, "cpu")
    got = run(tnative.RawDeflateStream(level, _handle=handle), script)
    assert got == run(jnative.RawDeflateStream(level), script)
    assert zlib.decompress(b"".join(got), -15) == data
    assert handle.rec[DK.D_TOTAL] <= len(data) - DK.PRUNE  # the prune ran
    assert handle.work.numel() == DK.WORK_BYTES + 320 * 1024  # Work, then Work4


def _medium_tables(handle) -> tuple:
    """A MEDIUM handle's head4 (int32 [65536]) and prevd4 (u16 [32768])."""
    w4 = handle.work[DK.WORK_BYTES :]
    head4 = w4[: 4 * DK.HASH4_SIZE].view(torch.int32).numpy().astype(np.int64)
    prevd4 = w4[4 * DK.HASH4_SIZE : 4 * DK.HASH4_SIZE + 2 * 32768].view(torch.int16).numpy()
    return head4, prevd4.astype(np.int64) & 0xFFFF


MEDIUM_SOURCES = {
    "binary": _BASH[120_000:160_000],
    # runs of one byte: 257 and 258 matches, whose interiors MEDIUM4/5 never insert
    "runs": (bytes(2000) + _rng.integers(0, 256, 40, dtype=np.uint8).tobytes() + b"\x07" * 900 +
             b"ab" * 400) * 6,
}


@pytest.mark.parametrize("level", MEDIUMS)
@pytest.mark.parametrize("source", sorted(MEDIUM_SOURCES))
def test_medium_tables_after_each_pump_equal_natives_inserts(monkeypatch, host_ds, level, source):
    """DS's source at MEDIUM4-6 (the resolve over hash4's chains, the
    checked chase, the tables rebuilt under the parse's own map): after
    each pump of a script of 1-byte pumps and NO/SYNC/FULL/FINISH pumps of
    1 byte to 9 KB, pump for pump native's bytes, and head4 and prevd4 as
    native's serial inserts leave them. After a FULL_FLUSH head4 keeps the
    old window's positions and the pumps take native's serial inserts
    (D_MED_STALE), its stale heads included."""
    monkeypatch.setattr(DK, "pump", host_ds)
    data = MEDIUM_SOURCES[source]
    rng = random.Random(level + len(source))
    script = [("pump", data[i : i + 1], 0) for i in range(300)]
    script += scripted(data[300:], rng, [1, 50, 700, 3000, 9000], flushes=(0, 0, 0, 2))[:-1]
    script += [("pump", b"", 3), ("pump", data[:5000], 0), ("pump", data[5000:9000], 2),
               ("pump", b"", 4)]
    handle = DK.Handle(level, "cpu")
    s = tnative.RawDeflateStream(level, _handle=handle)
    plain = DK.Plain(level)
    jn = jnative.RawDeflateStream(level)
    stale_seen = False
    for k, (_kind, chunk, flush) in enumerate(script):
        got = s.pump(chunk, flush)
        assert got == plain.pump(chunk, flush) == jn.pump(chunk, flush), k
        head4, prevd4 = _medium_tables(handle)
        assert np.array_equal(head4, np.array(plain.z.head4, np.int64)), k
        assert np.array_equal(prevd4, np.array(plain.z.prevd4, np.int64)), k
        stale_seen |= bool(handle.rec[DK.D_MED_STALE])
        assert bool(handle.rec[DK.D_MED_STALE]) == any(f == 3 for _k, _c, f in script[: k + 1])
    assert stale_seen


@pytest.mark.parametrize("level", MEDIUMS)
def test_medium_pumps_before_a_full_flush_take_the_slots(monkeypatch, host_ds, level):
    """Until a FULL_FLUSH, every MEDIUM pump of the card's handle runs the
    resolve (the launch has its slots); the plain version's bytes."""
    seen = []

    def pump(rec, data, work, out, rec_dev=None):
        seen.append((DK.resolved(rec), int(rec[DK.D_MED_STALE])))
        host_ds(rec, data, work, out)

    monkeypatch.setattr(DK, "pump", pump)
    data = MEDIUM_SOURCES["runs"][:20_000]
    h, p = DK.Handle(level, "cpu"), DK.Plain(level)
    for chunk, flush in ((data[:7000], 0), (data[7000:9000], 2), (data[9000:], 3),
                         (data[:3000], 0), (b"", 4)):
        assert h.pump(chunk, flush) == p.pump(chunk, flush)
    assert seen == [(True, 0)] * 3 + [(False, 1)] * 2


def test_wrapper_refuses_cpu_state_and_no_gpu_raises(monkeypatch):
    h = DK.Handle(6, "cpu")
    out = torch.zeros(64, dtype=torch.uint8)
    with pytest.raises(RuntimeError, match="expected CUDA"):
        DK.pump_cuda(h.rec, h.data, h.work, out, torch.zeros(DK.REC, dtype=torch.int64))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tnative.RawDeflateStream(6)
