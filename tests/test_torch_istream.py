"""IS (csrc/istream.cu), the resumable raw-deflate decoder under the
port's stream objects and gzip files, on the CPU: its source built as host
C++ by g++ (a warp of one lane) and its plain version, each through the
port's `native.RawInflateStream(device="cpu")`, against the reference's
native handle (`zlib_rs_tpu.native.RawInflateStream`, built with g++ here)
pump for pump: every call's output bytes and more-flag, and after it
`done`, `error`, `total_out` and `at_boundary`, then `take_tail_all`.
Every comparison is exact."""

import ctypes
import random
import shutil
import subprocess
import zlib
from pathlib import Path

import pytest
import torch

import native_build  # noqa: F401  (the JAX package's native library, built once under a lock)

from zlib_rs_tpu import native as jnative
from zlib_rs_tpu_torch import native as tnative
from zlib_rs_tpu_torch.ops.kernels import istream_kernel as ISK

# the test workers share the cores, and an oversubscribed OpenMP pool spin-waits
torch.set_num_threads(1)

SRC = Path(__file__).resolve().parents[1] / "zlib_rs_tpu_torch" / "csrc" / "istream.cu"
_BASH = open("/bin/bash", "rb").read()
DATA = _BASH[300_000:340_000]


def raw(data: bytes, level: int = 6, strategy: int = 0, zdict: bytes | None = None) -> bytes:
    kw = {"zdict": zdict} if zdict else {}
    c = zlib.compressobj(level, zlib.DEFLATED, -15, 8, strategy, **kw)
    return c.compress(data) + c.flush()


@pytest.fixture(scope="module")
def host_is(tmp_path_factory):
    """csrc/istream.cu built by g++ (no __CUDACC__: one lane), as a
    stand-in for istream_kernel.advance_plain."""
    gxx = shutil.which("g++")
    assert gxx, "g++ builds the reference's native engine and this file's host build"
    lib = tmp_path_factory.mktemp("is") / "libis_host.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-x", "c++", str(SRC), "-o",
                    str(lib)], check=True, capture_output=True, timeout=300)
    dll = ctypes.CDLL(str(lib))
    dll.zrs_istream_advance_host.argtypes = [ctypes.c_void_p] * 4
    dll.zrs_istream_table_words.restype = ctypes.c_longlong
    dll.zrs_istream_record_len.restype = ctypes.c_longlong
    assert dll.zrs_istream_table_words() == ISK.TABLE_WORDS
    assert dll.zrs_istream_record_len() == ISK.REC

    def advance(rec, tables, inbuf, outbuf):
        dll.zrs_istream_advance_host(rec.ctypes.data, tables.data_ptr(), inbuf.data_ptr(),
                                     outbuf.data_ptr())

    return advance


@pytest.fixture(params=["host", "plain"])
def engine(request, monkeypatch, host_is):
    """'host': IS's source through the wrapper; 'plain': its plain version."""
    if request.param == "host":
        monkeypatch.setattr(ISK, "advance_plain", host_is)
    return request.param


def run(make, script):
    """A script of ("pump", data, max_out) and ("copy",) steps through a
    handle from make(). At a copy the original runs the rest of the script
    (its log kept), and the copy goes on in its place. Returns every
    step's observables."""
    s = make()
    log = []
    for i, step in enumerate(script):
        if step[0] == "copy":
            c = s.copy()
            rest = [s.pump(d, m) for kind, d, m in script[i + 1 :]]
            log.append(("original", rest, s.done, s.total_out, s.take_tail_all()))
            s = c
            continue
        _, data, max_out = step
        out, more = s.pump(data, max_out)
        log.append((out, more, s.done, s.error, s.total_out, s.at_boundary()))
    log.append(s.take_tail_all())
    return log


def both(script, dictionary=None):
    want = run(lambda: jnative.RawInflateStream(dictionary=dictionary), script)
    got = run(lambda: tnative.RawInflateStream(dictionary, device="cpu"), script)
    return got, want


def cut(comp: bytes, rng, sizes, caps=(None,), drain=2):
    script, pos = [], 0
    while pos < len(comp):
        n = rng.choice(sizes)
        script.append(("pump", comp[pos : pos + n], rng.choice(caps)))
        pos += n
    return script + [("pump", b"", None)] * drain


@pytest.mark.parametrize("kind", ["l0", "l1", "l6", "l9", "fixed", "stored64k"])
def test_random_boundaries_equal_native(engine, kind):
    rng = random.Random(hash(kind) & 0xFFFF)
    if kind == "fixed":
        comp = raw(DATA, 6, zlib.Z_FIXED)
    elif kind == "stored64k":
        comp = raw(_BASH[:70_000], 0)  # stored blocks of 65,535 bytes
    else:
        comp = raw(DATA, int(kind[1:]))
    script = cut(comp, rng, [1, 2, 5, 33, 700, 4096, 20_000, 65_536])
    got, want = both(script)
    assert got == want
    assert b"".join(s[0] for s in got[:-1]) == zlib.decompress(comp, -15)


def test_dynamic_header_split_across_pumps(engine):
    comp = raw(DATA, 9)
    script = [("pump", comp[i : i + 1], None) for i in range(300)]  # the header a byte a pump
    script += [("pump", comp[300:], None), ("pump", b"", None)]
    got, want = both(script)
    assert got == want
    assert not any(s[0] for s in got[:20])  # nothing decodes before the header is whole


def test_bounded_max_out_and_more(engine):
    rng = random.Random(11)
    comp = raw(DATA, 6)
    script = cut(comp, rng, [500, 3000, 9000], caps=(1, 7, 100, 4096), drain=0)
    script += [("pump", b"", rng.choice((1, 1000, 70_000))) for _ in range(40)]
    got, want = both(script)
    assert got == want
    assert any(s[1] for s in got[:-1])  # the more-flag was raised


def test_preset_dictionary(engine):
    window = _BASH[250_000:300_000]
    comp = raw(DATA, 6, zdict=window[-32768:])
    script = cut(comp, random.Random(2), [100, 5000])
    got, want = both(script, dictionary=window)
    assert got == want
    assert b"".join(s[0] for s in got[:-1]) == DATA


def test_bytes_past_the_final_block(engine):
    comp = raw(DATA[:9000], 6)
    tail = b"TRAILER-and-next-member" * 3
    got, want = both(cut(comp + tail, random.Random(4), [1000, 3000]))
    assert got == want
    assert got[-1] == tail


def test_copy_mid_stream(engine):
    comp = raw(DATA, 6)
    script = [("pump", comp[:5000], None), ("pump", comp[5000:5003], 100), ("copy",),
              ("pump", comp[5003:20000], None), ("pump", comp[20000:], None),
              ("pump", b"", None)]
    got, want = both(script)
    assert got == want


@pytest.mark.parametrize("at", [40, 2000, 9000])
def test_flipped_bytes_serve_the_prefix_and_the_error(engine, at):
    comp = bytearray(raw(DATA, 6))
    comp[at] ^= 0x5A
    got, want = both(cut(bytes(comp), random.Random(at), [300, 2000]))
    assert got == want


def test_distance_too_far_back(engine):
    window = _BASH[250_000:300_000][-32768:]
    comp = raw(DATA[:4000], 6, zdict=window)  # decoded without its dictionary
    got, want = both(cut(comp, random.Random(5), [64, 999]))
    assert got == want
    assert any(s[3] for s in got[:-1])  # the error flag


# ---------------------------------------------------------------------------
# crafted dynamic blocks: native's acceptance rules
# ---------------------------------------------------------------------------


class Bits:
    def __init__(self):
        self.v, self.n = 0, 0

    def put(self, value: int, nbits: int) -> None:
        self.v |= (value & ((1 << nbits) - 1)) << self.n
        self.n += nbits

    def code(self, c: int, ln: int) -> None:  # a Huffman code, MSB first
        self.put(int(f"{c:0{ln}b}"[::-1], 2), ln)

    def bytes(self) -> bytes:
        return self.v.to_bytes((self.n + 7) // 8, "little")


def canonical(lens):
    cnt = [0] * 16
    for ln in lens:
        if ln:
            cnt[ln] += 1
    code, nxt = 0, [0] * 16
    for ln in range(1, 16):
        code = (code + (cnt[ln - 1] if ln > 1 else 0)) << 1
        nxt[ln] = code
    out = []
    for ln in lens:
        out.append(nxt[ln] if ln else None)
        if ln:
            nxt[ln] += 1
    return out


def dynamic_block(lit_lens, dist_lens, symbols, final=True) -> bytes:
    """One dynamic block: every code length sent with a flat 4-bit
    code-length code (symbols 0-15), then `symbols`: ints (litlen codes),
    ("d", code) distance codes or ("bits", value, n) raw bits."""
    b = Bits()
    b.put(1 if final else 0, 1)
    b.put(2, 2)
    b.put(len(lit_lens) - 257, 5)
    b.put(len(dist_lens) - 1, 5)
    b.put(19 - 4, 4)
    order = (16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15)
    for sym in order:
        b.put(4 if sym < 16 else 0, 3)
    for ln in list(lit_lens) + list(dist_lens):
        b.code(ln, 4)  # the flat code: symbol s has code s
    lc, dc = canonical(lit_lens), canonical(dist_lens)
    for s in symbols:
        if isinstance(s, tuple) and s[0] == "bits":
            b.put(s[1], s[2])
        elif isinstance(s, tuple):
            b.code(dc[s[1]], dist_lens[s[1]])
        else:
            b.code(lc[s], lit_lens[s])
    return b.bytes()


def test_one_symbol_codes_and_an_empty_distance_code(engine):
    only_eob = [0] * 256 + [1]
    empty = dynamic_block(only_eob, [0], [256])  # litlen: EOB alone; distance: none
    lits = [0] * 258
    lits[65], lits[256], lits[257] = 1, 2, 2
    one_dist = dynamic_block(lits, [1], [65, 257, ("d", 0), 256])  # "A" then (3, 1)
    bad_match = dynamic_block(lits, [0], [65, 257, ("bits", 0, 1), 256])  # no distance code
    for comp, out in ((empty, b""), (one_dist, b"AAAA"), (bad_match, None)):
        for sizes in ([1], [100]):
            got, want = both(cut(comp, random.Random(1), sizes))
            assert got == want
            if out is not None:
                assert b"".join(s[0] for s in got[:-1]) == out and got[-2][2]
            else:
                assert any(s[3] for s in got[:-1])


def test_output_room_grows_without_showing(engine):
    zeros = bytes(600_000)
    comp = raw(zeros, 9)  # ~600 bytes that expand 1000 times
    for max_out in (None, 100_000):
        script = [("pump", comp, max_out)] + [("pump", b"", max_out)] * 8
        got, want = both(script)
        assert got == want
    assert b"".join(s[0] for s in got[:-1]) == zeros


def test_wrapper_refuses_cuda_state_it_cannot_take():
    rec = torch.zeros(ISK.REC, dtype=torch.int64).numpy()
    with pytest.raises(RuntimeError, match="expected CUDA"):
        ISK.advance_cuda(rec, torch.zeros(ISK.TABLE_WORDS, dtype=torch.int32),
                         torch.zeros(16, dtype=torch.uint8), torch.zeros(16, dtype=torch.uint8),
                         torch.zeros(ISK.REC, dtype=torch.int64))


def test_no_gpu_and_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tnative.RawInflateStream()
