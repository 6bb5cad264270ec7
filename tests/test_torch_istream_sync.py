"""IS's whole-block launch (csrc/istream.cu `run_sync`: the head and tail
on one warp, every coded body with more than 1,088 bits of input left
decoded by sub-ranges of L bits that resynchronise, then a
pointer-jumping expansion) on the CPU: the source
built as host C++ by g++, its threads run in turn, at L of 8, 64 and 1,024
bits and the card's own choice (0). Each script runs pump for pump through
three decoders at once:

- the reference's native handle (`zlib_rs_tpu.native.RawInflateStream`,
  built with g++ here): every pump's bytes and more-flag, `done`,
  `error`, `total_out` and `at_boundary`, then the tail past the stream;
- the port's handle on IS's plain version (`istream_kernel.advance_plain`):
  the same, and the record's `R_IN_OFF`, `R_BIT_OFF` and mode after every
  pump;
- the port's handle on the whole-block launch.

Every comparison is exact."""

import ctypes
import random
import shutil
import subprocess
import zlib

import numpy as np
import pytest
import torch

import native_build  # noqa: F401  (the JAX package's native library, built once under a lock)

from test_torch_istream import SRC, _BASH, DATA, cut, dynamic_block, raw
from zlib_rs_tpu import native as jnative
from zlib_rs_tpu_torch import native as tnative
from zlib_rs_tpu_torch.ops.kernels import istream_kernel as ISK

torch.set_num_threads(1)

PLAIN = ISK.advance_plain
LS = (8, 64, 1024, 0)  # 0: the card's adaptive L
SMALL = DATA[:24_000]


@pytest.fixture(scope="module")
def dll(tmp_path_factory):
    """csrc/istream.cu built by g++ (no __CUDACC__)."""
    gxx = shutil.which("g++")
    assert gxx, "g++ builds the reference's native engine and this file's host build"
    lib = tmp_path_factory.mktemp("is_sync") / "libis_sync.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-x", "c++", str(SRC), "-o",
                    str(lib)], check=True, capture_output=True, timeout=300)
    d = ctypes.CDLL(str(lib))
    d.zrs_istream_sync_host.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + \
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
    for name in ("zrs_istream_table_words", "zrs_istream_record_len", "zrs_istream_scratch_words",
                 "zrs_istream_stats_len"):
        getattr(d, name).restype = ctypes.c_longlong
    assert d.zrs_istream_table_words() == ISK.TABLE_WORDS
    assert d.zrs_istream_record_len() == ISK.REC
    assert d.zrs_istream_scratch_words() == ISK.SCRATCH
    assert d.zrs_istream_stats_len() == ISK.STATS
    return d


class Sync:
    """The whole-block launch at sub-ranges of L bits, as an
    `advance_plain` stand-in; `stats` gathers its counters."""

    def __init__(self, dll, L: int):
        self.dll, self.L = dll, L
        self.scratch = np.zeros(ISK.SCRATCH, np.int32)
        self.stats = np.zeros(ISK.STATS, np.int64)

    def __call__(self, rec, tables, inbuf, outbuf):
        rc = self.dll.zrs_istream_sync_host(
            rec.ctypes.data, tables.data_ptr(), inbuf.data_ptr(), inbuf.numel() // 4,
            outbuf.data_ptr(), self.scratch.ctypes.data, self.stats.ctypes.data, self.L, 1024)
        assert rc == 0

    def stat(self, name: str) -> int:
        return int(self.stats[ISK.STAT_NAMES.index(name)])


def lockstep(script, sync, dictionary=None):
    """`script` ((data, max_out) pumps) through native, the port's handle
    on the plain version and on `sync`, in turn a pump. Returns the three
    logs; the port's entries carry the record's offsets and mode."""
    streams = {"native": jnative.RawInflateStream(dictionary=dictionary),
               "plain": tnative.RawInflateStream(dictionary, device="cpu"),
               "sync": tnative.RawInflateStream(dictionary, device="cpu")}
    engines = {"native": None, "plain": PLAIN, "sync": sync}
    logs = {k: [] for k in streams}
    for data, max_out in script:
        for name, s in streams.items():
            ISK.advance_plain = engines[name] or PLAIN
            try:
                out, more = s.pump(data, max_out)
            finally:
                ISK.advance_plain = PLAIN
            obs = (out, more, s.done, s.error, s.total_out, s.at_boundary())
            if name != "native":
                r = s._h.rec
                obs += (int(r[ISK.R_IN_OFF]), int(r[ISK.R_BIT_OFF]), int(r[ISK.R_MODE]))
            logs[name].append(obs)
    for name, s in streams.items():
        logs[name].append(s.take_tail_all())
    return logs


def check(script, sync, dictionary=None):
    logs = lockstep(script, sync, dictionary)
    assert logs["sync"] == logs["plain"]
    assert [o if isinstance(o, bytes) else o[:6] for o in logs["sync"]] == logs["native"]
    return logs["sync"]


def served(log) -> bytes:
    return b"".join(o[0] for o in log[:-1])


def pumps(comp: bytes, seed: int, sizes=(1, 2, 33, 700, 4096, 20_000, 65_536), caps=(None,)):
    return [(d, m) for _, d, m in cut(comp, random.Random(seed), list(sizes), caps)]


@pytest.fixture(params=LS, ids=[f"L{L}" for L in LS])
def sync(request, dll):
    return Sync(dll, request.param)


@pytest.mark.parametrize("kind", ["l0", "l1", "l6", "l9", "fixed", "huffman", "rle"])
def test_levels_and_strategies_equal_native(sync, kind):
    strategy = {"fixed": zlib.Z_FIXED, "huffman": zlib.Z_HUFFMAN_ONLY, "rle": zlib.Z_RLE}
    comp = raw(SMALL, 6, strategy[kind]) if kind in strategy else raw(SMALL, int(kind[1:]))
    for seed, script in enumerate(([(comp, None), (b"", None)], pumps(comp, 7))):
        log = check(script, sync)
        assert served(log) == SMALL, seed
    if kind not in ("l0",):
        assert sync.stat("windows") > 0  # the body ran


def test_runs_of_one_byte(sync):
    data = bytes([0x41]) * 150_000 + SMALL[:3000] + bytes(70_000)
    comp = raw(data, 9)  # dist 1 at length 258, chains as deep as the runs
    log = check([(comp, None), (b"", None), (b"", None)], sync)
    assert served(log) == data
    assert sync.stat("jump_rounds") > 0


def test_a_window_cut_before_its_eob_undoes_the_next_header(sync):
    """Small blocks (memLevel 1) of runs: a window whose sync decode ends
    at an EOB but whose expansion stops earlier for room, so the header
    the head parsed meanwhile is undone, the block's code lengths put back,
    and the block goes on in the next launch."""
    data = bytes([0x41]) * 150_000 + SMALL[:3000] + bytes(70_000) + SMALL
    c = zlib.compressobj(9, zlib.DEFLATED, -15, 1)
    comp = c.compress(data) + c.flush()
    log = check([(comp, None)] + [(b"", None)] * 5, sync)
    assert served(log) == data
    assert sync.stat("specs") > 0


def test_preset_dictionary(sync):
    window = _BASH[250_000:300_000]
    comp = raw(SMALL, 6, zdict=window[-32768:])
    log = check(pumps(comp, 2, sizes=(100, 5000, 30_000)), sync, dictionary=window)
    assert served(log) == SMALL


def test_distance_too_far_back(sync):
    window = _BASH[250_000:300_000][-32768:]
    comp = raw(DATA[:4000], 6, zdict=window)  # decoded without its dictionary
    for script in ([(comp, None), (b"", None)], pumps(comp, 5, sizes=(64, 999))):
        log = check(script, sync)
        assert any(o[3] for o in log[:-1])


@pytest.mark.parametrize("at", [40, 2000, 9000])
def test_flipped_byte_serves_the_prefix_and_the_error(sync, at):
    comp = bytearray(raw(SMALL, 6))
    comp[at] ^= 0x5A
    check([(bytes(comp), None), (b"", None)], sync)
    check(pumps(bytes(comp), at, sizes=(300, 2000)), sync)


def test_bytes_past_the_final_block(sync):
    """A trailer after the final block (a gzip member's 8 bytes, or more):
    the body, not the tail, meets the final EOB, and the bytes past it stay
    for take_tail."""
    comp = raw(SMALL, 6)
    for tail in (b"CRC+SIZE", b"TRAILER-and-next-member" * 3):
        for script in ([(comp + tail, None), (b"", None)],
                       pumps(comp + tail, len(tail), sizes=(1000, 3000))):
            log = check(script, sync)
            assert served(log) == SMALL and log[-1] == tail


def test_dynamic_header_split_across_pumps(sync):
    comp = raw(SMALL, 9)
    script = [(comp[i : i + 1], None) for i in range(300)] + [(comp[300:], None), (b"", None)]
    log = check(script, sync)
    assert served(log) == SMALL


def eob_ends(comp: bytes):
    """The bit after every coded block's EOB, by the plain version."""
    ends = []
    coded = ISK._Plain._coded

    def spy(self, out):
        r = coded(self, out)
        if self.mode in (ISK.M_HEAD, ISK.M_DONE):
            ends.append(self.bp)
        return r

    ISK._Plain._coded = spy
    try:
        ISK.Handle("cpu").pump(comp, 1 << 30)
    finally:
        ISK._Plain._coded = coded
    return ends


def test_pump_ends_at_every_bit_of_the_last_64_before_an_eob(sync):
    """Small blocks (memLevel 3: ~512 symbols, some 4,000 bits a block, so
    that the block's body reaches each cut); for an EOB at each bit
    residue, a first pump cut at every byte from 64 bits before the EOB's
    end to just past it, so that every bit offset in the last 64 bits
    before an EOB ends a pump."""
    c = zlib.compressobj(6, zlib.DEFLATED, -15, 3)
    comp = c.compress(SMALL[:16000]) + c.flush()
    by_residue = {}
    for e in eob_ends(comp)[1:]:
        by_residue.setdefault(e % 8, e)
    assert len(by_residue) == 8
    for e in by_residue.values():
        for at in range((e - 64) // 8, (e + 7) // 8 + 1):
            log = check([(comp[:at], None), (comp[at:], None), (b"", None)], sync)
            assert served(log) == SMALL[:16000]


def test_one_symbol_codes_and_an_empty_distance_code(sync):
    only_eob = [0] * 256 + [1]
    empty = dynamic_block(only_eob, [0], [256])  # litlen: EOB alone; distance: none
    lits = [0] * 258
    lits[65], lits[256], lits[257] = 1, 2, 2
    many = [65, 257, ("d", 0)] * 400 + [256]
    one_dist = dynamic_block(lits, [1], [65] + many)  # "A" then (3, 1) pairs
    # bodies long enough for the block (over kMinBody bits), each with a
    # hole of an incomplete code past its first window's start
    bad_match = dynamic_block(lits, [0],
                              [65] * 2000 + [257, ("bits", 0, 1)] + [("bits", 0, 30)] * 10)
    lit_hole = dynamic_block(only_eob, [0], [("bits", 1, 1)] + [("bits", 0, 30)] * 80)
    dist_hole = dynamic_block(lits, [1], [65] * 2000 + [257, ("bits", 1, 1)] + [65] * 300 + [256])
    for comp, out in ((empty, b""), (one_dist, b"A" * 1601), (bad_match, None),
                      (lit_hole, None), (dist_hole, None)):
        for script in ([(comp, None), (b"", None)], pumps(comp, 1, sizes=(1, 100))):
            log = check(script, sync)
            if out is not None:
                assert served(log) == out and log[-2][2]
            else:
                assert any(o[3] for o in log[:-1])


def test_room_cuts_the_body(sync):
    zeros = bytes(600_000)
    comp = raw(zeros, 9)  # ~600 bytes that expand 1000 times
    for max_out in (None, 100_000):
        log = check([(comp, max_out)] + [(b"", max_out)] * 8, sync)
        assert served(log) == zeros


def test_stored_blocks_in_a_pump(sync):
    data = _BASH[:150_000]
    comp = raw(data, 0)  # stored blocks of 65,535 bytes
    log = check([(comp, None), (b"", None)], sync)
    assert served(log) == data
    assert sync.stat("block_copies") > 0


def test_a_long_stream_compacts_its_output(dll):
    """Over 1 MiB served: the handle drops output before the window, so
    the body's window starts past the buffer's byte 0 (base > 0)."""
    data = (_BASH * 2)[:2_600_000]
    comp = raw(data, 6)
    s = Sync(dll, 0)
    log = check([(comp[i : i + (1 << 17)], None) for i in range(0, len(comp), 1 << 17)]
                + [(b"", None)], s)
    assert served(log) == data


def test_sync_rounds_on_a_stream_that_stays_out_of_step(dll):
    """A dynamic block whose literals all have 8-bit codes and whose data is
    one literal: a decode started off the true bit phase reads the same
    8-bit code forever and never meets the true path, so the rounds run
    out and thread 0 finishes alone; the bytes stay native's. An ordinary
    level-6 stream, by contrast, resynchronises in a few rounds."""
    lits = [8] * 255 + [9, 9]  # literals 0-254: 8 bits; 255 and EOB: 9 bits
    comp = dynamic_block(lits, [1], [0] * 20_000 + [256])
    s = Sync(dll, 0)
    log = check([(comp, None), (b"", None)], s)
    assert served(log) == bytes(20_000)
    assert s.stat("max_sync_rounds") == 32 and s.stat("serial_finishes") >= 1
    s = Sync(dll, 0)
    log = check([(raw(SMALL, 6), None), (b"", None)], s)
    assert served(log) == SMALL
    assert 0 < s.stat("max_sync_rounds") < 32 and s.stat("serial_finishes") == 0
