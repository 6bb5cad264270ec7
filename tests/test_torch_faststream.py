"""The port's stream route (models/faststream.py over IS and DS, the stream
objects of models/stream.py and the gzip files of models/gzfile.py) with
device="cpu" (IS's and DS's plain versions), against the JAX package's
with its native route on (ZRS_NATIVE_STREAM unset, the C++ engine built
with g++ here), call for call: every call's (status, consumed, output),
`msg`, the totals, `data_type` and `sync_point`. Each test of
tests/test_faststream.py and of TestFastInflateConsumed and
TestFastGzipHeaderCrc (tests/test_advice_regressions.py) has its
counterpart here, then the migration of an engaged compressor onto the
exact engine, gzsetparams, multi-member and FHCRC gzip reads, a bad
checksum, and the no-GPU rule."""

import gzip
import io
import random
import struct
import zlib

import pytest
import torch

import native_build  # noqa: F401  (the JAX package's native library, built once under a lock)

import zlib_rs_tpu.config as jc
import zlib_rs_tpu.models.faststream as JF
import zlib_rs_tpu.models.gzfile as JG
import zlib_rs_tpu.models.inflate as JI
import zlib_rs_tpu.models.stream as JS
from zlib_rs_tpu_torch import config as tc
from zlib_rs_tpu_torch.models import faststream as TF
from zlib_rs_tpu_torch.models import gzfile as TG
from zlib_rs_tpu_torch.models import inflate as TI
from zlib_rs_tpu_torch.models import stream as TS

# the test workers share the cores, and an oversubscribed OpenMP pool spin-waits
torch.set_num_threads(1)

_rnd = random.Random(1234)
DATA = (
    (b"fast stream engine test corpus, " * 800)
    + bytes(_rnd.randrange(256) for _ in range(40000))
    + b"\x00" * 5000
)


@pytest.fixture(autouse=True)
def _native_route_on(monkeypatch):
    monkeypatch.delenv("ZRS_NATIVE_STREAM", raising=False)


class Side:
    """One package's stream route: the port's on the CPU, or the JAX
    package's with its native engine."""

    def __init__(self, port: bool):
        self.port = port
        self.C = tc if port else jc
        self.S = TS if port else JS
        self.F = TF if port else JF
        self.G = TG if port else JG
        self.I = TI if port else JI
        self.kw = {"device": "cpu"} if port else {}

    def inflate(self, **cfg):
        return self.S.Inflate(self.C.InflateConfig(**cfg), **self.kw)

    def deflate(self, **cfg):
        return self.S.Deflate(self.C.DeflateConfig(**cfg), **self.kw)

    def engine(self, wbits):
        return self.F.FastInflateEngine(self.C.InflateConfig(window_bits=wbits), **self.kw)

    def gzfile(self, **kw):
        return self.G.GzFile(**kw, **self.kw)


def both(fn):
    """fn(side) on the port, then on the JAX package; equal results."""
    got, want = fn(Side(True)), fn(Side(False))
    assert got == want
    return got


def status(v):
    return getattr(v, "name", v)


def inf_call(inf, data, budget=None, flush=None):
    kw = {} if flush is None else {"flush": flush}
    st, consumed, out = inf.decompress(data, budget, **kw)
    return (status(st), consumed, out, inf.msg, inf.total_in, inf.total_out, inf.data_type,
            inf.sync_point())


def def_call(d, data, flush):
    st, consumed, out = d.compress(data, flush)
    return (status(st), consumed, out, d.total_in, d.total_out, d.data_type)


def pump_all(inf, comp, in_chunk, out_budget):
    log, pos = [], 0
    for _ in range(500_000):
        feed = comp[pos : pos + in_chunk] if in_chunk else comp[pos:]
        rec = inf_call(inf, feed, out_budget)
        log.append(rec)
        pos += rec[1]
        if rec[0] == "StreamEnd":
            return log, b"".join(r[2] for r in log)
        if rec[0] == "BufError" and pos >= len(comp):
            raise AssertionError("stuck at end of input")
    raise AssertionError("pump loop stuck")


# ---------------------------------------------------------------------------
# tests/test_faststream.py, call for call
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("wbits,packer", [
    (15, lambda d: zlib.compress(d, 6)),
    (31, lambda d: gzip.compress(d, 6)),
    (-15, lambda d: (lambda c: c.compress(d) + c.flush())(zlib.compressobj(6, zlib.DEFLATED, -15))),
    (47, lambda d: zlib.compress(d, 9)),  # auto-detect
])
def test_fast_stream_all_wrappers(wbits, packer):
    comp = packer(DATA)

    def run(side):
        logs = []
        for in_chunk, out_budget in ((None, None), (257, None), (None, 1024), (64, 96)):
            inf = side.inflate(window_bits=wbits)
            log, got = pump_all(inf, comp, in_chunk, out_budget)
            assert inf._fast is not None and got == DATA
            logs.append(log)
        return logs

    both(run)


def test_fast_stream_random_boundaries():
    comp = zlib.compress(DATA, 9)
    rng = random.Random(5)
    scripts = []
    for _ in range(3):
        cuts = sorted(rng.sample(range(1, len(comp)), 30))
        budgets = [rng.randrange(1, 5000) for _ in range(400)]
        scripts.append(([comp[a:b] for a, b in zip([0] + cuts, cuts + [len(comp)])], budgets))

    def run(side):
        logs = []
        for pieces, budgets in scripts:
            inf, log, k = side.inflate(), [], 0
            st = None
            for p in pieces:
                while p:
                    rec = inf_call(inf, p, budgets[k % len(budgets)])
                    k += 1
                    log.append(rec)
                    p = p[rec[1] :]
                    st = rec[0]
                    if st == "StreamEnd":
                        break
            while st != "StreamEnd":
                rec = inf_call(inf, b"", 5000)
                log.append(rec)
                st = rec[0]
            assert b"".join(r[2] for r in log) == DATA
            logs.append(log)
        return logs

    both(run)


def _until_error(inf, comp, step):
    log = []
    for i in range(0, len(comp), step):
        try:
            log.append(inf_call(inf, comp[i : i + step]))
        except Exception as e:  # the two packages' InflateError
            return log, type(e).__name__, str(e), e.return_code.name, inf.msg
    return log, None


def test_fast_stream_corrupt_raises():
    comp = bytearray(zlib.compress(DATA, 6))
    comp[len(comp) // 2] ^= 0xFF
    got = both(lambda side: _until_error(side.inflate(), bytes(comp), 997))
    assert got[1] == "InflateError" and got[-1] is not None


def test_fast_stream_bad_checksum_raises():
    comp = bytearray(zlib.compress(DATA, 6))
    comp[-1] ^= 0xFF  # the adler trailer
    got = both(lambda side: _until_error(side.inflate(), bytes(comp), 1024))
    assert got[3] == "DataError" and "data check" in got[4]


def test_fast_stream_copy_mid_stream():
    comp = zlib.compress(DATA, 6)

    def run(side):
        inf = side.inflate()
        first = inf_call(inf, comp[:200])
        assert inf._fast is not None
        snap = inf.copy()
        rest1 = inf_call(inf, comp[first[1] :])
        rest2 = inf_call(snap, comp[first[1] :])
        assert rest1 == rest2 and first[2] + rest1[2] == DATA
        return first, rest1

    both(run)


def test_fast_stream_deopt_keeps_exact_engine():
    comp = zlib.compress(DATA, 6)

    def run(side):
        inf = side.inflate()
        inf.prime(-1, 0)  # prime() => the exact engine
        log = [inf_call(inf, comp)]
        assert inf._fast is None
        while log[-1][0] not in ("StreamEnd", "BufError") or len(log) == 1:
            log.append(inf_call(inf, b""))
        assert b"".join(r[2] for r in log) == DATA
        return log

    both(run)


def test_fast_stream_env_kill_switch(monkeypatch):
    monkeypatch.setenv("ZRS_NATIVE_STREAM", "0")

    def run(side):
        inf = side.inflate()
        rec = inf_call(inf, zlib.compress(b"hello", 6))
        assert inf._fast is None
        return rec

    both(run)


def _gz_fields(payload: bytes) -> bytes:
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    body = co.compress(payload) + co.flush()
    extra = b"\x07\x00seven!!"
    hdr = (b"\x1f\x8b\x08" + bytes([0x02 | 0x04 | 0x08 | 0x10]) + b"\x00\x00\x00\x00\x00\xff"
           + struct.pack("<H", len(extra)) + extra + b"name\x00" + b"comment\x00")
    return (hdr + struct.pack("<H", zlib.crc32(hdr) & 0xFFFF) + body
            + struct.pack("<II", zlib.crc32(payload), len(payload) & 0xFFFFFFFF))


def test_fast_stream_gzip_header_fields_skipped():
    payload = DATA[:10000]
    stream = _gz_fields(payload)
    assert gzip.decompress(stream) == payload

    def run(side):
        inf = side.inflate(window_bits=31)
        log, got = pump_all(inf, stream, 333, None)
        assert inf._fast is not None and got == payload
        return log

    both(run)


def test_fast_stream_matches_exact_engine_output(monkeypatch):
    comp = zlib.compress(DATA, 6)

    def run(side):
        fast = side.inflate()
        monkeypatch.setenv("ZRS_NATIVE_STREAM", "0")
        pure = side.inflate()
        monkeypatch.delenv("ZRS_NATIVE_STREAM")
        logs = []
        for inf in (fast, pure):
            log, got = pump_all(inf, comp, 1031, None)
            assert got == DATA
            logs.append([r[:3] + r[5:6] for r in log])
        assert fast._fast is not None and pure._fast is None
        return logs

    logs = both(run)
    assert b"".join(r[2] for r in logs[0]) == b"".join(r[2] for r in logs[1])


def test_fast_deflate_matches_zlib_streaming():
    rng = random.Random(9)
    cases = []
    for level in (1, 4, 6, 9):
        for _ in range(2):
            n = rng.randrange(500, len(DATA))
            script, left = [], n
            while left > 0:
                nb = min(left, rng.randrange(1, 30000))
                fl = rng.choice(["NO_FLUSH"] * 4 + ["SYNC_FLUSH", "FULL_FLUSH"]) \
                    if left > nb else "FINISH"
                script.append((nb, fl))
                left -= nb
            cases.append((level, n, script))

    def run(side):
        logs = []
        for level, n, script in cases:
            d, log, pos = side.deflate(level=level), [], 0
            for nb, fl in script:
                log.append(def_call(d, DATA[pos : pos + nb], side.C.DeflateFlush[fl]))
                pos += nb
            assert d._fast is not None and d.total_in == n
            logs.append(log)
        return logs

    logs = both(run)
    zfl = {"NO_FLUSH": zlib.Z_NO_FLUSH, "SYNC_FLUSH": zlib.Z_SYNC_FLUSH,
           "FULL_FLUSH": zlib.Z_FULL_FLUSH, "FINISH": zlib.Z_FINISH}
    for (level, n, script), log in zip(cases, logs):
        co, ref, pos = zlib.compressobj(level), b"", 0
        for nb, fl in script:
            ref += co.compress(DATA[pos : pos + nb])
            pos += nb
            if fl != "NO_FLUSH":
                ref += co.flush(zfl[fl])
        assert b"".join(r[2] for r in log) == ref


def test_fast_deflate_gzip_container(monkeypatch):
    def run(side):
        d = side.deflate(level=6, window_bits=31)
        a = def_call(d, DATA, side.C.DeflateFlush.FINISH)
        assert d._fast is not None and gzip.decompress(a[2]) == DATA
        monkeypatch.setenv("ZRS_NATIVE_STREAM", "0")
        p = side.deflate(level=6, window_bits=31)
        monkeypatch.delenv("ZRS_NATIVE_STREAM")
        b = def_call(p, DATA, side.C.DeflateFlush.FINISH)
        assert p._fast is None and a[2] == b[2]
        return a

    both(run)


def test_fast_deflate_copy_and_deopt():
    def run(side):
        F = side.C.DeflateFlush
        d = side.deflate(level=6)
        first = def_call(d, DATA[:10000], F.NO_FLUSH)
        assert d._fast is not None
        c = d.copy()
        o1 = def_call(d, DATA[10000:], F.FINISH)
        o2 = def_call(c, DATA[10000:], F.FINISH)
        assert o1 == o2
        d2 = side.deflate(level=6, strategy=side.C.Strategy.Rle)
        rle = def_call(d2, DATA[:1000], F.FINISH)
        assert d2._fast is None
        return first, o1, rle

    both(run)


# ---------------------------------------------------------------------------
# TestFastInflateConsumed and TestFastGzipHeaderCrc, engine for engine
# ---------------------------------------------------------------------------


def _eng_call(eng, data, side):
    rc, consumed, out = eng.inflate(data, None, side.C.InflateFlush.NO_FLUSH)
    return rc.name, consumed, out, eng.msg, eng.total_in, eng.total_out


def test_zlib_wrap_leaves_tail_unconsumed():
    data = b"hello world " * 40
    comp = zlib.compress(data)
    got = both(lambda side: _eng_call(side.engine(15), comp + b"X" * 200, side))
    assert got[:3] == ("StreamEnd", len(comp), data)


def test_raw_wrap_leaves_tail_unconsumed():
    data = b"hello world " * 40
    comp = zlib.compress(data)[2:-4]
    got = both(lambda side: _eng_call(side.engine(-15), comp + b"Y" * 123, side))
    assert got[:3] == ("StreamEnd", len(comp), data)


def test_concatenated_streams_decode_via_consumed():
    blob = zlib.compress(b"first") + zlib.compress(b"second")

    def run(side):
        a = _eng_call(side.engine(15), blob, side)
        b = _eng_call(side.engine(15), blob[a[1] :], side)
        assert (a[2], b[2]) == (b"first", b"second") and a[1] + b[1] == len(blob)
        return a, b

    both(run)


def test_matches_exact_engine_consumed():
    blob = zlib.compress(b"payload bytes here") + b"tail-tail-tail"

    def run(side):
        fast = _eng_call(side.engine(15), blob, side)
        exact = side.I.Inflator(side.C.InflateConfig(window_bits=15))
        rc, c, o = exact.inflate(blob, None, side.C.InflateFlush.NO_FLUSH)
        assert fast[:3] == (rc.name, c, o)
        return fast

    both(run)


def _gz_with_fhcrc(corrupt: bool):
    data = b"fhcrc test payload " * 50
    buf = io.BytesIO()
    g = gzip.GzipFile(fileobj=buf, mode="wb", filename="n.txt", mtime=0)
    g.write(data)
    g.close()
    gz = bytearray(buf.getvalue())
    hdr = bytearray(gz[:10])
    hdr[3] |= 0x02  # FHCRC
    i = 10
    while gz[i] != 0:
        i += 1
    name = bytes(gz[10 : i + 1])
    crc16 = zlib.crc32(bytes(hdr) + name) & 0xFFFF
    if corrupt:
        crc16 ^= 0x5A5A
    return bytes(hdr) + name + struct.pack("<H", crc16) + bytes(gz[i + 1 :]), data


@pytest.mark.parametrize("corrupt", [False, True])
def test_fhcrc_verified(corrupt):
    stream, data = _gz_with_fhcrc(corrupt)

    def run(side):
        fast = _eng_call(side.engine(31), stream, side)
        inf = side.inflate(window_bits=31)
        try:
            obj = inf_call(inf, stream)
        except Exception as e:
            obj = (type(e).__name__, str(e), inf.msg)
        return fast, obj

    fast, obj = both(run)
    if corrupt:
        assert fast[0] == "DataError" and fast[3] == "header crc mismatch"
        assert obj[0] == "InflateError"
    else:
        assert fast[:3] == ("StreamEnd", len(stream), data) and obj[2] == data


# ---------------------------------------------------------------------------
# beyond the reference's tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("api", ["params", "prime", "PARTIAL_FLUSH", "BLOCK"])
def test_migrate_to_exact_after_the_fast_path_engaged(api):
    def run(side):
        F = side.C.DeflateFlush
        d = side.deflate(level=6)
        log = [def_call(d, DATA[:20000], F.NO_FLUSH)]
        assert d._fast is not None
        if api == "params":
            d.params(2, side.C.Strategy.Default)
        elif api == "prime":
            log.append(def_call(d, b"", F.SYNC_FLUSH))
            d.prime(3, 5)
        else:
            log.append(def_call(d, DATA[20000:30000], F[api]))
        assert d._fast is None
        log.append(def_call(d, DATA[30000:40000], F.FINISH))
        return log

    log = both(run)
    if api != "prime":
        assert zlib.decompress(b"".join(r[2] for r in log))[:20000] == DATA[:20000]


def test_gzfile_write_set_params_and_read_back():
    def run(side):
        bio = io.BytesIO()
        f = side.gzfile(fileobj=bio, mode="wb1")
        assert type(f._def).__name__ == "FastDeflateEngine"
        f.write(DATA[:30000])
        f.set_params(9, side.C.Strategy.Default)
        f.write(DATA[30000:])
        f.flush()
        f.close()
        blob = bio.getvalue()
        r = side.gzfile(fileobj=io.BytesIO(blob + gzip.compress(b"second member")),
                        mode="rb", buffer_size=4096)
        text = r.read()
        r.close()
        return blob, text

    blob, text = both(run)
    assert gzip.decompress(blob) == DATA and text == DATA + b"second member"


def test_gzfile_read_fhcrc_and_a_bad_checksum():
    good, data = _gz_with_fhcrc(False)
    bad = bytearray(gzip.compress(DATA[:5000]))
    bad[-6] ^= 0x01  # the crc32

    def run(side):
        out = []
        for blob in (good, bytes(bad)):
            f = side.gzfile(fileobj=io.BytesIO(blob), mode="rb")
            try:
                out.append(f.read())
            except Exception as e:
                out.append((type(e).__name__, str(e)))
            f._closed = True
        return out

    got = both(run)
    assert got[0] == data and got[1][0] == "GzError"


def test_no_gpu_and_no_device(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    comp = zlib.compress(DATA[:3000])
    with pytest.raises(RuntimeError, match="CUDA"):
        TS.Inflate().decompress(comp)
    with pytest.raises(RuntimeError, match="CUDA"):
        TS.Deflate(tc.DeflateConfig(level=6)).compress(b"abc")
    with pytest.raises(RuntimeError, match="CUDA"):
        TG.GzFile(tmp_path / "a.gz", "wb6")
    monkeypatch.setenv("ZRS_NATIVE_STREAM", "0")
    inf = TS.Inflate()
    assert inf.decompress(comp)[2] == DATA[:3000] and inf._fast is None
    d = TS.Deflate(tc.DeflateConfig(level=6))
    assert zlib.decompress(d.compress(b"abc", tc.DeflateFlush.FINISH)[2]) == b"abc"
    with TG.GzFile(tmp_path / "b.gz", "wb6") as f:
        f.write(DATA[:3000])
    assert gzip.decompress((tmp_path / "b.gz").read_bytes()) == DATA[:3000]
