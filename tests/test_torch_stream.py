"""The port's stream objects (zlib_rs_tpu_torch.models.stream: Deflate,
Inflate, Status, DeflateError, InflateError) against the JAX package's, on
the same pump scripts, byte for byte: every call's status, input consumed
and output. The reference's native route is kept off with
ZRS_NATIVE_STREAM=0, so both run their exact host engines."""

import gzip
import zlib

import numpy as np
import pytest
import torch

import native_build  # noqa: F401  (the JAX package's native library, built once under a lock)

import zlib_rs_tpu.config as jc
import zlib_rs_tpu.models.stream as JS
from zlib_rs_tpu_torch import config as tc
from zlib_rs_tpu_torch.models import stream as TS

# the test workers share the cores, and an oversubscribed OpenMP pool spin-waits
torch.set_num_threads(1)

_BASH = open("/bin/bash", "rb").read()
_rng = np.random.default_rng(16)
DATA = {
    "binary": _BASH[200_000:208_000],
    "text": b" ".join(_rng.choice([b"stream", b"pump", b"flush", b"window", b"\n"], 1200)),
    "random": _rng.integers(0, 256, 3000, dtype=np.uint8).tobytes(),
    "empty": b"",
}


@pytest.fixture(autouse=True)
def _exact_engines(monkeypatch):
    monkeypatch.setenv("ZRS_NATIVE_STREAM", "0")


def _pkg(port):
    return (TS, tc) if port else (JS, jc)


def _deflate_trace(port, data, flush_name, in_bytes, out_bytes, **cfg):
    """Every call of a Deflate pump: (status, consumed, output)."""
    S, C = _pkg(port)
    if "strategy" in cfg:
        cfg["strategy"] = C.Strategy[cfg["strategy"]]
    d = S.Deflate(**cfg)
    flush = C.DeflateFlush[flush_name]
    trace = []
    for i in range(0, len(data), in_bytes):
        st, used, out = d.compress(data[i : i + in_bytes], flush, out_bytes)
        trace.append((st.name, used, out))
        while d.pending[0]:
            st, used, out = d.compress(b"", C.DeflateFlush.NO_FLUSH, out_bytes)
            trace.append((st.name, used, out))
    while True:
        st, used, out = d.compress(b"", C.DeflateFlush.FINISH, out_bytes)
        trace.append((st.name, used, out))
        if st.name == "StreamEnd":
            break
    return trace, d.total_in, d.total_out


def _inflate_trace(port, stream, flush_name, in_bytes, out_bytes, **cfg):
    S, C = _pkg(port)
    inf = S.Inflate(**cfg)
    flush = C.InflateFlush[flush_name]
    trace, pos = [], 0
    for _ in range(4 * (len(stream) + 2) * max(1, 16384 // out_bytes)):
        st, used, out = inf.decompress(stream[pos : pos + in_bytes], out_bytes, flush)
        pos += used
        trace.append((st.name, used, out))
        if st.name == "StreamEnd":
            break
    return trace, inf.total_in, inf.total_out, inf.msg


@pytest.mark.parametrize("flush", ["NO_FLUSH", "PARTIAL_FLUSH", "SYNC_FLUSH", "FULL_FLUSH",
                                   "BLOCK"])
def test_deflate_flush_modes_equal_jax(flush):
    args = (DATA["binary"], flush, 1024, 700)
    got = _deflate_trace(True, *args, level=6)
    assert got == _deflate_trace(False, *args, level=6)
    assert zlib.decompress(b"".join(o for *_, o in got[0])) == DATA["binary"]


@pytest.mark.parametrize("level", [0, 1, 9])
def test_deflate_levels_equal_jax(level):
    args = (DATA["text"], "SYNC_FLUSH", 2048, 4096)
    assert _deflate_trace(True, *args, level=level) == _deflate_trace(False, *args, level=level)


@pytest.mark.parametrize("cfg", [
    {"window_bits": 31}, {"window_bits": -15}, {"window_bits": 9, "mem_level": 1},
    {"strategy": "Filtered"}, {"strategy": "HuffmanOnly"}, {"strategy": "Rle"},
    {"strategy": "Fixed", "level": 4},
], ids=str)
def test_deflate_configs_one_byte_buffers_equal_jax(cfg):
    data = DATA["binary"][:1500] + DATA["random"][:300]
    assert _deflate_trace(True, data, "NO_FLUSH", 1, 1, **cfg) == \
        _deflate_trace(False, data, "NO_FLUSH", 1, 1, **cfg)


def test_deflate_advanced_calls_equal_jax():
    """set_dictionary, params mid-stream, prime, copy and reset."""
    outs = []
    for port in (True, False):
        S, C = _pkg(port)
        d = S.Deflate(level=6)
        d.set_dictionary(DATA["text"][:2000])
        parts = [d.compress(DATA["text"][:3000], C.DeflateFlush.NO_FLUSH)[2]]
        d.params(1, C.Strategy.Default)
        parts.append(d.compress(DATA["text"][3000:], C.DeflateFlush.SYNC_FLUSH)[2])
        twin = d.copy()
        parts.append(d.finish())
        parts.append(twin.compress(b"tail", C.DeflateFlush.FINISH)[2])
        d.reset()
        parts.append(d.compress(DATA["random"], C.DeflateFlush.FINISH)[2])
        raw = S.Deflate(level=6, window_bits=-15)
        raw.prime(3, 0b101)
        parts.append(raw.compress(b"primed", C.DeflateFlush.FINISH)[2])
        with pytest.raises(S.DeflateError) as e:
            d.compress(b"after the end", C.DeflateFlush.NO_FLUSH)
        parts.append(e.value.return_code.name)
        parts.append((d.bound(12345), d.total_in, d.total_out, d.data_type))
        outs.append(parts)
    assert outs[0] == outs[1]


def _streams():
    b = DATA["binary"]
    c = zlib.compressobj(9, zlib.DEFLATED, -15)
    return {"zlib1": zlib.compress(b, 1), "zlib9": zlib.compress(DATA["text"], 9),
            "gzip": gzip.compress(b, mtime=0), "raw": c.compress(b) + c.flush(),
            "empty": zlib.compress(b"")}


@pytest.mark.parametrize("name", ["zlib1", "zlib9", "gzip", "raw", "empty"])
@pytest.mark.parametrize("in_bytes, out_bytes", [(1, 1), (13, 4096), (4096, 97)])
def test_inflate_buffers_equal_jax(name, in_bytes, out_bytes):
    stream = _streams()[name]
    cfg = {"window_bits": -15} if name == "raw" else {"window_bits": 47}
    got = _inflate_trace(True, stream, "NO_FLUSH", in_bytes, out_bytes, **cfg)
    assert got == _inflate_trace(False, stream, "NO_FLUSH", in_bytes, out_bytes, **cfg)
    assert got[0][-1][0] == "StreamEnd"


@pytest.mark.parametrize("flush", ["SYNC_FLUSH", "FINISH", "BLOCK", "TREES"])
def test_inflate_flush_modes_equal_jax(flush):
    stream = zlib.compress(DATA["binary"] + DATA["text"], 6)
    got = _inflate_trace(True, stream, flush, 512, 1024)
    assert got == _inflate_trace(False, stream, flush, 512, 1024)
    assert b"".join(o for *_, o in got[0]) == DATA["binary"] + DATA["text"]


def test_inflate_errors_and_extras_equal_jax():
    """A corrupt stream's error and message, a preset dictionary, sync,
    sync_point, mark, codes_used, header fields and a copy mid-stream."""
    zdict = DATA["text"][:1000]
    c = zlib.compressobj(6, zlib.DEFLATED, 15, 8, zlib.Z_DEFAULT_STRATEGY, zdict)
    with_dict = c.compress(DATA["text"]) + c.flush()
    bad = bytearray(zlib.compress(DATA["binary"]))
    bad[len(bad) // 2] ^= 0xFF
    outs = []
    for port in (True, False):
        S, C = _pkg(port)
        res = []
        inf = S.Inflate()
        try:
            inf.decompress(bytes(bad))
        except S.InflateError as e:
            res.append((e.return_code.name, str(e)))
        inf = S.Inflate()
        with pytest.raises(S.InflateError) as e:
            inf.decompress(with_dict)
        res.append((e.value.return_code.name, inf.dict_id))
        inf.set_dictionary(zdict)
        st, used, out = inf.decompress(with_dict[inf.total_in :])
        res.append((st.name, used, out))
        inf = S.Inflate(window_bits=47)
        st, used, out = inf.decompress(_streams()["gzip"][:3000], 500)
        res.append((st.name, used, out, inf.mark(), inf.codes_used(), inf.sync_point()))
        twin = inf.copy()
        res.append(twin.decompress(_streams()["gzip"][used:])[2])
        res.append(inf.header_fields() is None)
        inf = S.Inflate(window_bits=-15)
        res.append(inf.sync(b"junk\x00\x00\xff\xffmore")[1])
        inf.reset()
        res.append([m.name for m in S.Status])
        outs.append(res)
    assert outs[0] == outs[1]
