"""The host side of every kernel wrapper (`*_cuda`): its argument checks,
its output allocation and the ctypes argument list it hands the kernel's C
entry. The kernels run only on the card, so here each wrapper calls a stub
library that checks the argument count against the `argtypes` the wrapper
declared and returns 0; a wrapper whose Python is broken fails on the CPU
and not first in `chip_smoke.py`. Each call must count one launch."""

import ctypes

import numpy as np
import pytest
import torch

import zlib_rs_tpu_torch as zt
from zlib_rs_tpu_torch import _device
from zlib_rs_tpu_torch.ops.kernels import checksum_kernels as CK
from zlib_rs_tpu_torch.ops.kernels import crc_kernels as CRC
from zlib_rs_tpu_torch.ops.kernels import deflate_kernel as DK
from zlib_rs_tpu_torch.ops.kernels import dstream_kernel as DSK
from zlib_rs_tpu_torch.ops.kernels import exact_deflate_kernel as EK
from zlib_rs_tpu_torch.ops.kernels import inflate_kernel as IK
from zlib_rs_tpu_torch.ops.kernels import istream_kernel as ISK
from zlib_rs_tpu_torch.ops.kernels import speculative_kernel as SK
from zlib_rs_tpu_torch.ops.kernels import vhuff_kernel as VK
from zlib_rs_tpu_torch.parallel import device_inflate as DI
from zlib_rs_tpu_torch.parallel import pipeline as PL
from zlib_rs_tpu_torch.parallel import swarm_inflate as SW
from zlib_rs_tpu_torch.parallel import vector_inflate as TV

# the test workers share the cores, and an oversubscribed OpenMP pool spin-waits
torch.set_num_threads(1)

DATA = open("/bin/bash", "rb").read()[300_000:370_000]


class _Entry:
    def __init__(self, calls, name):
        self.calls, self.name, self.argtypes, self.restype = calls, name, None, None

    def __call__(self, *args):
        assert self.argtypes is not None and len(args) == len(self.argtypes), self.name
        self.calls.append(self.name)
        self.args = args
        return 0


class _Library:
    def __init__(self, calls):
        self._calls = calls

    def __getattr__(self, name):
        entry = _Entry(self._calls, name)
        setattr(self, name, entry)
        return entry


@pytest.fixture
def stub(monkeypatch):
    calls, libs = [], {}
    monkeypatch.setattr(_device, "library", lambda name: libs.setdefault(name, _Library(calls)))
    monkeypatch.setattr(_device, "require_cuda", lambda *a: None)
    monkeypatch.setattr(_device, "stream_of", lambda t: 0)
    for mod in (CK, CRC, DK, IK, VK, DI, SW, SK, EK, ISK, DSK):
        monkeypatch.setattr(mod, "launches", dict.fromkeys(mod.launches, 0))
    return calls


@pytest.fixture(scope="module")
def inputs():
    """One small batch of every kernel's operands, from the port's own
    CPU encode (2 chunks of 32 KiB and a tail)."""
    cs = PL.DEFAULT_CHUNK
    n = -(-len(DATA) // cs)
    dsz = PL.priming_dict_size(n, cs, True)
    padded, n_valid, valid_from, _ = PL.chunk_buffers(DATA, cs, dsz)
    dc, dn, dv = (torch.from_numpy(a) for a in (padded, n_valid, valid_from))
    w4 = DK.words_from_bytes(dc)
    htab = torch.zeros((n, 4 * w4.shape[1]), dtype=torch.int32)
    mpos = torch.zeros((n, DK.CAP_M + 8), dtype=torch.int32)
    nm = torch.zeros(n, dtype=torch.int32)
    lltab, dtab = DK.code_tables(torch.ones((n, 320), dtype=torch.int32))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ZRS_TPU_KERNEL", "1")  # the port's kernel engine
        out, index = zt.compress_parallel(DATA, 6, return_index=True, device="cpu")
    bodies = [out[o : o + ln] for o, ln, _ in index]
    staged, meta = TV.prepare_vector_inputs(bodies, [m for *_, m in index], index.seeds, "cpu")
    words, bits = IK.pack_streams_words(bodies)
    return dict(dc=dc, dn=dn, dv=dv, dsz=dsz, w4=w4, htab=htab, mpos=mpos, nm=nm,
                lltab=lltab, dtab=dtab, staged=staged, meta=meta, iwords=words, ibits=bits,
                sizes=[m for *_, m in index], seeds=index.seeds)


def _calls(i):
    st, meta = i["staged"], i["meta"]
    S, K = meta["S"], meta["K"]
    dec = [st[n] for n in ("words", "start_word", "align", "span", "tables")]
    tape = torch.zeros((64, dec[1].shape[0]), dtype=torch.int32)
    start = torch.full_like(i["dn"], i["dsz"])
    pw, pmeta, oww = DK.pack_inputs(i["dc"], i["dn"], i["dsz"], i["nm"], 0)
    lanes = len(i["sizes"])
    return {
        "adler32_batch": (CK, lambda: CK.adler32_batch_cuda(i["dc"], i["dn"])),
        "crc32_batch": (CRC, lambda: CRC.crc32_batch_cuda(i["dc"], i["dn"])),
        "hop_chase": (DK, lambda: DK.hop_chase_cuda(i["w4"], i["htab"], i["dn"], i["dsz"], 24)),
        "hop_chase_il": (DK, lambda: DK.hop_chase_il_cuda(i["w4"], i["htab"], i["dn"], i["dsz"], 24)),
        "chain_scan": (DK, lambda: DK.chain_scan_cuda(i["w4"], i["dn"], start, i["dv"], depth=8,
                                                      nice=8, good=4, max_lazy=4)),
        "tab_scan": (DK, lambda: DK.tab_scan_cuda(i["w4"], i["htab"], i["htab"], i["dn"], i["dsz"],
                                                  nice=8, good=4, max_lazy=4)),
        "freq": (DK, lambda: DK.freq_cuda(pw, i["mpos"], i["mpos"], pmeta)),
        "pack": (DK, lambda: DK.pack_cuda(pw, i["mpos"], i["mpos"], pmeta, i["lltab"], i["dtab"],
                                          oww, 0)),
        "vhuff_decode": (VK, lambda: VK.decode_tokens_vector2_cuda(*dec, S=S, K=K, cap=64)),
        "vhuff_expand": (VK, lambda: VK.expand_tokens2_cuda(tape, tape, st["offs"], out_words=16)),
        "vhuff_decode1": (VK, lambda: VK.decode_tokens_vector_cuda(*dec, S=S, K=K, cap=64)),
        "vhuff_expand1": (VK, lambda: VK.expand_tokens_cuda(tape, st["offs"], out_words=16)),
        "inflate": (IK, lambda: IK.decode_streams_cuda(
            torch.from_numpy(i["iwords"].view(np.int32)), torch.zeros(lanes, dtype=torch.int32),
            torch.from_numpy(i["ibits"]), torch.tensor(i["sizes"], dtype=torch.int32),
            max_out=max(i["sizes"]))),
        "lockstep": (DI, lambda: DI.decode_regions_cuda(*_lockstep_args(i), 64)),
        "swarm_walk": (SW, lambda: SW.walk_cuda(*_walk_args(i), 512)),
        "block_find": (SK, lambda: SK.block_find_cuda(*_spec_stream(i), *_spec_ranges(i))),
        "spec_decode": (SK, lambda: SK.spec_decode_cuda(*_spec_stream(i), _spec_meta(i), 64, 8)),
        "spec_resolve": (SK, lambda: SK.spec_resolve_cuda(
            torch.tensor([65, 256, 66, 257], dtype=torch.int16),
            torch.tensor([0, 1, 4], dtype=torch.int64))),
        "exact_deflate": (EK, lambda: EK.exact_deflate_cuda(*_ex_args(), 0)),
        "exact_resolve": (EK, lambda: EK.resolve_cuda(*_resolve_args(), 1, 1)),
        "exact_dry": (EK, lambda: EK.dry_cuda(*_dry_args())),
        "istream": (ISK, lambda: ISK.advance_cuda(*_is_args())),
        "dstream": (DSK, lambda: DSK.pump_cuda(*_ds_args())),
    }


def _is_args():
    """IS's operands: a fresh handle's record, tables and buffers."""
    h = ISK.Handle("cpu")
    return h.rec, h.tables, h.inbuf, h.outbuf, torch.zeros(ISK.REC, dtype=torch.int64)


def _ds_args():
    """DS's operands: a level-6 handle's record, data, Work and room."""
    h = DSK.Handle(6, "cpu")
    h.rec[DSK.D_OUT_CAP] = 64
    return h.rec, h.data, h.work, torch.zeros(64, dtype=torch.uint8), \
        torch.zeros(DSK.REC, dtype=torch.int64)


def _resolve_args():
    """The resolve's operands: EX's data, one piece of its first chunk at
    level 6, its deltas and slots."""
    data, meta = _ex_args()
    pieces, nd, ns, _cb, _wb = EK.with_offsets([EK.ex_piece(meta[0].tolist(), 0, 0, 0)])
    return (data, torch.from_numpy(pieces), 6, torch.zeros(nd, dtype=torch.int16),
            torch.zeros(ns, 2, dtype=torch.int32))


def _dry_args():
    """The dry parse's operands at level 1: the resolve's piece and slots,
    a skip map and the records."""
    _data, pieces, _level, _deltas, slots = _resolve_args()
    stride = EK.bit_words(1000)
    return (pieces, 1, slots, torch.zeros(stride, dtype=torch.int32), stride,
            torch.zeros(EK.REC, dtype=torch.int64))


def _ex_args():
    """EX's operands: 3,000 bytes and two chunks, the second primed."""
    data = torch.from_numpy(np.frombuffer(DATA[:3000], np.uint8).copy())
    meta = torch.tensor([[0, 1000, 0, 0, 0, 5100], [1000, 2000, 1000, 1, 5100, 6104]],
                        dtype=torch.int64)
    return data, meta


def _spec_stream(i):
    """The speculative kernels' stream: the first chunk body as words."""
    body = i["iwords"].view(np.uint8)[0].tobytes()
    return torch.from_numpy(SK.stream_words(body)), 8 * len(body)


def _spec_ranges(i):
    _w, nbits = _spec_stream(i)
    return [0, nbits // 2], [nbits // 2, nbits]


def _spec_meta(i):
    return torch.tensor([[0, 1 << 20, 32, 0, 0, 0, 4, 0], [-1, 1 << 20, 32, 32768, 32, 4, 4, 0]],
                        dtype=torch.int64)


def _walk_args(i):
    """The swarm walkers' operands: the chunk bodies and their seeds as
    seeded_inputs stages them, with flat tables of every length 8."""
    comp, ll, dd, sbit, sspan, _cap = SW.seeded_inputs(
        [i["iwords"].view(np.uint8)[k].tobytes() for k in range(len(i["sizes"]))],
        i["sizes"], i["seeds"])
    luts = torch.full((comp.shape[0], 1 << 15), 8 << 16, dtype=torch.int64)
    return (torch.from_numpy(comp), luts, luts, torch.from_numpy(sbit),
            torch.from_numpy(sspan))


def _lockstep_args(i):
    """The lockstep engine's operands: the chunk bodies as rows ending in
    zero bytes, their bits and output sizes."""
    lanes = len(i["sizes"])
    comp = torch.from_numpy(np.ascontiguousarray(i["iwords"].view(np.uint8)))
    return (comp, torch.zeros(lanes, dtype=torch.int32), torch.from_numpy(i["ibits"]),
            torch.tensor(i["sizes"], dtype=torch.int32))


KERNELS = ["adler32_batch", "crc32_batch", "hop_chase", "hop_chase_il", "chain_scan", "tab_scan",
           "freq", "pack", "vhuff_decode", "vhuff_expand", "vhuff_decode1", "vhuff_expand1",
           "inflate", "lockstep", "swarm_walk", "block_find", "spec_decode", "spec_resolve",
           "exact_deflate", "exact_resolve", "exact_dry", "istream", "dstream"]


def test_every_kernel_has_a_case():
    assert sorted(KERNELS) == sorted(n for m in (CK, CRC, DK, IK, VK, DI, SW, SK, EK, ISK, DSK)
                                     for n in m.launches)
    # K2 and K12 are one templated body in one source, csrc/hop_chase_il.cu,
    # and so are K5 and K11b, csrc/vhuff_expand.cu, and K4 and K11a,
    # csrc/vhuff_decode.cu; the lockstep engine is csrc/lockstep.cu, the
    # swarm engine's walkers csrc/swarm.cu, SP1-SP3 three C entries of
    # csrc/speculative.cu, EX, its resolve, its dry parse and DS four of
    # csrc/exact_deflate.cu, and IS csrc/istream.cu
    assert len(_device.SOURCES) == len(KERNELS) - 8 == 15
    assert "speculative" in _device.SOURCES and "exact_deflate" in _device.SOURCES
    assert "istream" in _device.SOURCES
    assert "hop_chase_il" in _device.SOURCES and "hop_chase" not in _device.SOURCES
    assert "vhuff_expand" in _device.SOURCES and "vhuff_expand1" not in _device.SOURCES
    assert "vhuff_decode" in _device.SOURCES and "vhuff_decode1" not in _device.SOURCES


@pytest.mark.parametrize("name", KERNELS)
def test_wrapper_host_side(stub, inputs, name):
    mod, call = _calls(inputs)[name]
    call()
    assert len(stub) == 1 and stub[0].startswith("zrs_")
    assert mod.launches[name] == 1 and sum(mod.launches.values()) == 1


def test_chain_scan_hands_the_kernel_its_scratch(stub, inputs, monkeypatch):
    """K8's C entry takes (words, W, n_valid, start, ins_from, depth, nice,
    good, max_lazy, counts, ranks, mpos, mld, C, st, batch, stream); its
    scratch is the int32 bucket counters [B, HSIZE] and each position's
    packed rank [B, MAX_BUF + 8]."""
    monkeypatch.setattr(_device, "ptr", lambda t: t)  # the tensors, not their pointers
    _calls(inputs)["chain_scan"][1]()
    args = _device.library("chain_scan").zrs_chain_scan.args
    B, W = inputs["w4"].shape
    C = DK.CAP_M + 8
    assert args[0].shape == (B, W) and args[1] == W
    assert [tuple(a.shape) for a in args[2:5]] == [(B,)] * 3
    assert args[5:9] == (8, 8, 4, 4) and args[13:16:2] == (C, B)
    counts, ranks, mpos, mld, st = args[9], args[10], args[11], args[12], args[14]
    assert (counts.dtype, counts.shape) == (torch.int32, (B, DK.HSIZE))
    assert (ranks.dtype, ranks.shape) == (torch.int32, (B, DK.MAX_BUF + 8))
    assert mpos.shape == mld.shape == (B, C) and st.shape == (B, 8)


def test_crc32_hands_the_kernel_its_shift_table(stub, inputs, monkeypatch):
    """K7's C entry takes (data, row stride, B, N, lens, shifts, out,
    stream); shifts is the int32 view of shift_table() for the kernel's
    THREADS and SEG, built once a device and handed to every launch."""
    monkeypatch.setattr(_device, "ptr", lambda t: t)
    monkeypatch.setattr(CRC, "_SHIFTS", {})
    dc, dn = inputs["dc"], inputs["dn"]
    for _ in range(2):
        CRC.crc32_batch_cuda(dc, dn)
    args = _device.library("crc32").zrs_crc32_batch.args
    assert len(args) == 8 and args[1:4] == (dc.stride(0), *dc.shape)
    shifts = args[5]
    assert shifts.dtype == torch.int32 and shifts.shape == (CRC.THREADS + 16,)
    assert (shifts.numpy().view(np.uint32) == CRC.shift_table()).all()
    assert list(CRC._SHIFTS.values()) == [shifts] and CRC.launches["crc32_batch"] == 2


@pytest.mark.parametrize("name", ["hop_chase", "hop_chase_il", "tab_scan"])
def test_resolve_chase_wrappers_hand_the_kernel_its_tile(stub, inputs, monkeypatch, name):
    """K2's, K12's and K10's C entries take the tile (the resolved slots a
    block keeps in dynamic shared memory, 4 bytes each) right before the
    stream: TILE by default, so one tile holds a 32 KiB chunk's span, any
    size in [MIN_TILE, MAX_TILE] on request, and a size outside refused
    before the launch. K2 and K12 are two entries of the hop_chase_il
    library."""
    monkeypatch.setattr(_device, "ptr", lambda t: t)
    i = inputs
    call = {
        "hop_chase": lambda **k: DK.hop_chase_cuda(i["w4"], i["htab"], i["dn"], i["dsz"], 24, **k),
        "hop_chase_il": lambda **k: DK.hop_chase_il_cuda(i["w4"], i["htab"], i["dn"], i["dsz"], 24,
                                                         **k),
        "tab_scan": lambda **k: DK.tab_scan_cuda(i["w4"], i["htab"], i["htab"], i["dn"], i["dsz"],
                                                 nice=8, good=4, max_lazy=4, **k),
    }[name]
    lib = "tab_scan" if name == "tab_scan" else "hop_chase_il"
    entry = lambda: getattr(_device.library(lib), f"zrs_{name}")
    call()
    B = i["w4"].shape[0]
    assert entry().args[-3:] == (B, DK.TILE, 0)
    assert DK.MAX_TILE * 4 <= 232_448 - 16 * 1024  # a block's shared memory, static part aside
    assert DK.TILE >= PL.DEFAULT_CHUNK  # one tile holds a chunk's span
    call(tile=DK.MIN_TILE)
    assert entry().args[-2] == DK.MIN_TILE
    for bad in (DK.MIN_TILE - 1, DK.MAX_TILE + 1):
        with pytest.raises(ValueError, match="tile"):
            call(tile=bad)
    assert DK.launches[name] == 2 and len(stub) == 2
    if name != "tab_scan":
        # K2 hands the kernel a B x C int32 scratch of match ends, K12 none
        args = entry().args
        C = DK.CAP_M + 8
        assert len(args) == 16 and args[9] == C
        assert (args[12] is None) == (name == "hop_chase_il")
        if name == "hop_chase":
            assert args[12].shape == (B, C) and args[12].dtype == torch.int32


def test_inflate_wrapper_asks_for_its_shared_memory(stub, inputs, monkeypatch):
    """K6's C entry takes (words, B, W, meta, win, WW, out, OW, st, smem,
    stream): smem is a block's dynamic shared memory, the 64 KiB output
    ring (every distance is at most 32 KiB, so a source lies in it beside
    the bytes not yet stored), above the 48 KiB a launch gets without
    asking and small enough, with the static tables, for three blocks an
    SM."""
    monkeypatch.setattr(_device, "ptr", lambda t: t)
    _calls(inputs)["inflate"][1]()
    args = _device.library("inflate").zrs_inflate.args
    B = len(inputs["sizes"])
    assert len(args) == 11 and args[1] == B and args[-2] == IK.SMEM_BYTES and args[-1] == 0
    assert IK.SMEM_BYTES >= 2 * 32768
    static_tables = 4 * (IK.LL_CAP + IK.D_CAP + IK.CL_CAP) + 4 * 320 + 2 * 320 + 5 * 64
    assert 48 * 1024 < IK.SMEM_BYTES and 3 * (IK.SMEM_BYTES + static_tables + 1024) <= 232_448
    out, meta, st = args[6], args[3], args[8]
    assert out.shape == (B, args[7]) and meta.shape == (B, IK.META_WORDS) and st.shape == (B, 4)


def test_expand_wrapper_hands_the_kernel_its_branch_row(stub, inputs, monkeypatch):
    """K5's C entry takes (tapeA, tapeB, offs, cap, W, S, out_words, out,
    branch, stream): branch is a null pointer unless the caller passes an
    int32 [B] row for each chunk's body (BRANCH_CHASE, BRANCH_UNTILED,
    BRANCH_TOO_LARGE), and a row of another type or shape is refused
    before the launch. The chase's 15-bit pointers cover a 32 KiB chunk,
    the main path's, and its row."""
    monkeypatch.setattr(_device, "ptr", lambda t: t)
    st, S = inputs["staged"], inputs["meta"]["S"]
    tape = torch.zeros((64, st["start_word"].shape[0]), dtype=torch.int32)
    B = st["offs"].shape[0]
    entry = lambda: _device.library("vhuff_expand").zrs_vhuff_expand
    VK.expand_tokens2_cuda(tape, tape, st["offs"], out_words=16)
    args = entry().args
    assert len(args) == 10 and args[3:7] == (64, tape.shape[1], S, 16)
    assert args[7].shape == (B, 16) and args[8] is None and args[9] == 0
    branch = torch.zeros(B, dtype=torch.int32)
    VK.expand_tokens2_cuda(tape, tape, st["offs"], out_words=16, branch=branch)
    assert entry().args[8] is branch
    for bad in (torch.zeros(B, dtype=torch.int64), torch.zeros(B + 1, dtype=torch.int32),
                torch.zeros(2 * B, dtype=torch.int32)[::2]):
        with pytest.raises(ValueError, match="branch"):
            VK.expand_tokens2_cuda(tape, tape, st["offs"], out_words=16, branch=bad)
    assert VK.launches["vhuff_expand"] == 2 and len(stub) == 2
    assert PL.DEFAULT_CHUNK <= VK.CHASE_MAX_BYTES == 2**15
    assert 4 * (-(-PL.DEFAULT_CHUNK // 4) + 2) <= VK.CHASE_MAX_ROW
    assert len({VK.BRANCH_CHASE, VK.BRANCH_UNTILED, VK.BRANCH_TOO_LARGE}) == 3


def test_expand1_wrapper_hands_the_kernel_its_branch_row(stub, inputs, monkeypatch):
    """K11b is the second C entry of K5's library, `zrs_vhuff_expand1`
    of vhuff_expand: (tape, offs, cap, W, S, out_words, out, branch,
    stream), branch a null pointer unless the caller passes an int32 [B]
    row for each chunk's body, and a row of another type or shape refused
    before the launch. Any S that divides W is taken."""
    monkeypatch.setattr(_device, "ptr", lambda t: t)
    st, S = inputs["staged"], inputs["meta"]["S"]
    tape = torch.zeros((64, st["start_word"].shape[0]), dtype=torch.int32)
    B = st["offs"].shape[0]
    entry = lambda: _device.library("vhuff_expand").zrs_vhuff_expand1
    VK.expand_tokens_cuda(tape, st["offs"], out_words=16)
    args = entry().args
    assert len(args) == 9 and args[2:6] == (64, tape.shape[1], S, 16)
    assert args[6].shape == (B, 16) and args[7] is None and args[8] == 0
    branch = torch.zeros(B, dtype=torch.int32)
    VK.expand_tokens_cuda(tape, st["offs"], out_words=16, branch=branch)
    assert entry().args[7] is branch
    for bad in (torch.zeros(B, dtype=torch.int64), torch.zeros(B + 1, dtype=torch.int32),
                torch.zeros(2 * B, dtype=torch.int32)[::2]):
        with pytest.raises(ValueError, match="branch"):
            VK.expand_tokens_cuda(tape, st["offs"], out_words=16, branch=bad)
    odd = torch.zeros((1, 4), dtype=torch.int32)  # one chunk of 3 walkers
    VK.expand_tokens_cuda(torch.zeros((8, 3), dtype=torch.int32), odd, out_words=4)
    assert entry().args[4] == 3
    assert VK.launches["vhuff_expand1"] == 3 and stub == ["zrs_vhuff_expand1"] * 3


def test_decode_wrappers_resolve_from_one_library(stub, inputs, monkeypatch):
    """K4 and K11a are the two C entries of one library, vhuff_decode:
    `zrs_vhuff_decode` (words, B, Lw, start_word, align, span, tables, S, K,
    cap, W, tapeA, tapeB, cons, bad, rem, stream) and `zrs_vhuff_decode1`
    (the same with one tape); `zrs_vhuff_decode_blocks` reads the blocks
    on each branch."""
    monkeypatch.setattr(_device, "ptr", lambda t: t)
    names = []
    real = _device.library
    monkeypatch.setattr(_device, "library", lambda name: names.append(name) or real(name))
    st, meta = inputs["staged"], inputs["meta"]
    dec = [st[n] for n in ("words", "start_word", "align", "span", "tables")]
    B, Lw = dec[0].shape
    W = dec[1].shape[0]
    VK.decode_tokens_vector2_cuda(*dec, S=meta["S"], K=meta["K"], cap=64)
    VK.decode_tokens_vector_cuda(*dec, S=meta["S"], K=meta["K"], cap=32)
    assert VK.decode_blocks() == (0, 0)  # the stub writes nothing
    assert set(names) == {"vhuff_decode"}
    assert stub == ["zrs_vhuff_decode", "zrs_vhuff_decode1", "zrs_vhuff_decode_blocks"]
    lib = real("vhuff_decode")
    two, one = lib.zrs_vhuff_decode.args, lib.zrs_vhuff_decode1.args
    assert len(two) == 17 and len(one) == 16
    for args, cap in ((two, 64), (one, 32)):
        assert args[1:3] == (B, Lw) and args[7:11] == (meta["S"], meta["K"], cap, W)
        assert args[11].shape == (cap, W) and args[-1] == 0
    assert two[12].shape == (64, W) and two[13].shape == (W,) and one[12].shape == (W,)
    assert VK.launches["vhuff_decode"] == VK.launches["vhuff_decode1"] == 1


def test_lockstep_wrapper_hands_the_kernel_its_tables_and_tapes(stub, inputs, monkeypatch):
    """The lockstep kernel's C entry takes (comp, B, L, start_bits,
    end_bits, targets, max_steps, scratch, tok_kind, tok_a, tok_b,
    produced, bad, counts, stream): a 2 x 2^15 uint32 scratch a lane for
    its literal/length and distance tables, zeroed tapes of max_steps
    columns, and one count a lane, whose largest is n_steps."""
    monkeypatch.setattr(_device, "ptr", lambda t: t)
    runs = dict(DI.runs)
    comp, sb, eb, tg = _lockstep_args(inputs)
    tk, ta, tb, n_steps, produced, bad = DI.decode_regions_cuda(comp, sb, eb, tg, 77)
    args = _device.library("lockstep").zrs_lockstep.args
    B, L = comp.shape
    assert len(args) == 15 and args[1] == B and args[2] == L and args[6] == 77 and args[-1] == 0
    assert args[0].dtype == torch.uint8 and args[0].shape == (B, L)
    assert all(a.dtype == torch.int32 and a.shape == (B,) for a in args[3:6])
    assert args[7].shape == (B, 2 << DI.FLAT_BITS) and args[7].dtype == torch.int32
    assert args[8] is tk and tk.dtype == torch.uint8 and tk.shape == (B, 77) and not tk.any()
    assert args[9] is ta and args[10] is tb and ta.shape == tb.shape == (B, 77)
    assert args[11] is produced and args[13].shape == (B,) and args[12].dtype == torch.uint8
    assert bad.dtype == torch.bool and n_steps == 0
    assert DI.runs["decode_regions"] == runs["decode_regions"] + 1
    assert DI.launches["lockstep"] == 1
    # every row must end in a zero byte, checked with the counts' one read
    comp[:, -1] = 1
    with pytest.raises(ValueError, match="zero byte"):
        DI.decode_regions_cuda(comp, sb, eb, tg, 8)
    with pytest.raises(ValueError, match="uint8"):
        DI.decode_regions_cuda(comp.to(torch.int32), sb, eb, tg, 8)


def test_lockstep_dispatch_by_device(monkeypatch):
    """A CPU tensor runs the plain version; anything else the kernel."""
    calls = []
    monkeypatch.setattr(DI, "decode_regions_plain", lambda *a: calls.append("plain"))
    monkeypatch.setattr(DI, "decode_regions_cuda", lambda *a: calls.append("cuda"))
    one = torch.zeros(1, dtype=torch.int32)
    DI.decode_regions(torch.zeros((1, 8), dtype=torch.uint8), one, one, one, 4)
    DI.decode_regions(torch.zeros((1, 8), dtype=torch.uint8, device="meta"), one, one, one, 4)
    assert calls == ["plain", "cuda"]


def test_swarm_walk_wrapper_hands_the_kernel_its_tapes(stub, inputs, monkeypatch):
    """The walker kernel's C entry takes (comp, B, L, S, ll_lut, d_lut,
    seed_bit, seed_span, cap, tok_kind, tok_a, tok_b, end_bit, remaining,
    bad, stream): int32 tables, int64 seeds, walker-major tapes of cap
    slots zeroed, and the walkers' end bits, remaining spans and flags."""
    monkeypatch.setattr(_device, "ptr", lambda t: t)
    comp, ll, dl, sbit, sspan = _walk_args(inputs)
    tk, ta, tb, end, rem, bad = SW.walk_cuda(comp, ll, dl, sbit, sspan, 512)
    args = _device.library("swarm").zrs_swarm_walk.args
    B, L = comp.shape
    S = sbit.shape[1]
    assert len(args) == 16 and args[1:4] == (B, L, S) and args[8] == 512 and args[-1] == 0
    assert args[4].dtype == args[5].dtype == torch.int32 and args[4].shape == (B, 1 << 15)
    assert args[6].dtype == args[7].dtype == torch.int64 and args[6].shape == (B, S)
    assert args[9].shape == (B * S, 512) and args[9].dtype == torch.uint8 and not args[9].any()
    assert tk.shape == ta.shape == tb.shape == (B, S * 512)
    assert end.shape == rem.shape == bad.shape == (B * S,) and bad.dtype == torch.bool
    assert SW.launches["swarm_walk"] == 1
    with pytest.raises(ValueError, match="L >= 12"):
        SW.walk_cuda(comp[:, :8], ll, dl, sbit, sspan, 512)


def test_swarm_walk_dispatch_by_device(monkeypatch):
    calls = []
    monkeypatch.setattr(SW, "walk_plain", lambda *a, **k: calls.append("plain"))
    monkeypatch.setattr(SW, "walk_cuda", lambda *a: calls.append("cuda"))
    one = torch.zeros((1, 1), dtype=torch.int64)
    SW.walk(torch.zeros((1, 16), dtype=torch.uint8), one, one, one, one, 4)
    SW.walk(torch.zeros((1, 16), dtype=torch.uint8, device="meta"), one, one, one, one, 4)
    assert calls == ["plain", "cuda"]


def test_speculative_wrappers_hand_the_kernels_their_operands(stub, inputs, monkeypatch):
    """SP1's entry takes (words, W, nbits, ops, T, tiles, surv, room,
    counts, res, stats, stream): ops int64 [3T + 1] (lo, hi, each
    segment's first pre-filter tile), u16 survivors a tile in a room of
    TILE_BITS // SURVIVOR_SHARE, and res int64 [2T] (the offsets, then an
    overflow flag a segment), rerun with room for every offset when a
    flag is set; SP2's (words, W, nbits, meta, T, cells, recs, status,
    stream) with int16 cells and int64 records and [T, 8] status; SP3's
    (work, n, seg_ofs, E, limit, budget, out, ctl, stats, stream) with a
    copy of the cells to rewrite and 2^rounds hops. Bit positions are 64-bit: nbits a long long, the ranges and
    the offsets int64."""
    monkeypatch.setattr(_device, "ptr", lambda t: t)
    lib = _device.library("speculative")
    words, nbits = _spec_stream(inputs)
    lo, hi = _spec_ranges(inputs)
    rooms = []

    def find(*args):
        rooms.append(args[7])
        args[9][2:] = 1 if len(rooms) == 1 else 0  # the first launch overflows
        return 0

    find.argtypes = None
    lib.zrs_block_find = find
    best = SK.block_find_cuda(words, nbits, lo, hi)
    assert rooms == [SK.TILE_BITS // SK.SURVIVOR_SHARE, SK.TILE_BITS]
    assert SK.launches["block_find"] == 2 and best.tolist() == [0, 0]
    assert best.dtype == torch.int64
    lib.zrs_block_find = _Entry([], "zrs_block_find")
    SK.block_find_cuda(words, nbits, lo, hi)
    args = lib.zrs_block_find.args
    assert lib.zrs_block_find.argtypes[2] is ctypes.c_longlong and args[2] == nbits
    tiles = SK.tile_counts(lo, hi, nbits)
    assert args[3].tolist() == lo + hi + [0, tiles[0], sum(tiles)]
    assert args[4:6] == (2, sum(tiles)) and args[6].shape == (sum(tiles), args[7])
    assert args[3].dtype == args[9].dtype == torch.int64 and args[9].shape == (4,)
    with pytest.raises(ValueError, match="lists"):
        SK.block_find_cuda(words, nbits, torch.tensor(lo), torch.tensor(hi))
    with pytest.raises(ValueError, match="lists"):
        SK.block_find_cuda(words, nbits, lo, hi[:1])
    SK.spec_decode_cuda(words, nbits, _spec_meta(inputs), 64, 8)
    args = lib.zrs_spec_decode.args
    assert args[1:5:3] == (words.shape[0], 2) and args[5].dtype == torch.int16
    assert args[5].shape == (64,) and args[6].shape == (8, 2) and args[7].shape == (2, SK.STATUS)
    assert lib.zrs_spec_decode.argtypes[2] is ctypes.c_longlong
    assert args[6].dtype == args[7].dtype == torch.int64
    # a stream past 2^31 bits: no size check of its own (the words are a
    # view of one zero byte a word, enough for the check)
    big = 1 << 34
    huge = torch.zeros(1, dtype=torch.int32).expand(big // 32 + 2)
    SK.spec_decode_cuda(huge, big, _spec_meta(inputs), 64, 8)
    assert lib.zrs_spec_decode.args[2] == big
    with pytest.raises(ValueError, match="pass the buffers"):
        SK.spec_decode_cuda(words, nbits, _spec_meta(inputs), 40, 8)
    SK.spec_resolve_cuda(torch.zeros(40, dtype=torch.int16), torch.tensor([0, 9, 20, 33, 40]))
    args = lib.zrs_spec_resolve.args
    assert args[1] == 40 and args[3] == 4 and args[4] == 1 << SK.resolve_rounds(4) == 8
    assert args[0].shape == (40,) and args[0].dtype == torch.int16 and args[8] is None
    assert args[5] == SK.HOP_BUDGET and args[7].shape == (2,)
    assert lib.zrs_spec_resolve.argtypes[4] is ctypes.c_longlong
    with pytest.raises(ValueError, match="int16"):
        SK.spec_resolve_cuda(torch.zeros(4, dtype=torch.int32), torch.tensor([0, 4]))


def test_block_find_reads_back_once_a_launch(stub, inputs, monkeypatch):
    """SP1's wrapper, given the ranges as lists (as the route gives them),
    reaches the host once a launch: one copy of the offsets and the
    overflow flags, and one more for the rerun; no other read of a device
    tensor (item, tolist, numpy, a second copy)."""
    reads = []
    for name in ("cpu", "item", "tolist", "numpy"):
        real = getattr(torch.Tensor, name)
        monkeypatch.setattr(torch.Tensor, name,
                            lambda self, *a, _r=real, _n=name, **k: (reads.append(_n),
                                                                     _r(self, *a, **k))[1])
    monkeypatch.setattr(_device, "ptr", lambda t: t)
    words, nbits = _spec_stream(inputs)
    lo, hi = [0, nbits // 3, nbits // 2], [nbits // 3, nbits // 2, nbits]
    best = SK.block_find_cuda(words, nbits, lo, hi)
    assert reads == ["cpu"] and best.shape == (3,)

    def overflow(*args):
        args[9][3:] = 1 if args[7] < SK.TILE_BITS else 0
        return 0

    overflow.argtypes = None
    _device.library("speculative").zrs_block_find = overflow
    reads.clear()
    SK.block_find_cuda(words, nbits, lo, hi)
    assert reads == ["cpu", "cpu"]


def test_speculative_dispatch_by_device(monkeypatch):
    calls = []
    for name in ("block_find", "spec_decode", "spec_resolve"):
        monkeypatch.setattr(SK, f"{name}_plain", lambda *a, n=name: calls.append(f"{n}:plain"))
        monkeypatch.setattr(SK, f"{name}_cuda", lambda *a, n=name: calls.append(f"{n}:cuda"))
    w = torch.zeros(8, dtype=torch.int32)
    one = torch.zeros(1, dtype=torch.int32)
    for dev in ("cpu", "meta"):
        SK.block_find(w.to(dev), 8, one, one)
        SK.spec_decode(w.to(dev), 8, torch.zeros((1, 8), dtype=torch.int64), 0, 0)
        SK.spec_resolve(torch.zeros(2, dtype=torch.int16, device=dev), torch.tensor([0, 2]))
    assert calls == [f"{n}:{d}" for d in ("plain", "cuda")
                     for n in ("block_find", "spec_decode", "spec_resolve")]


def test_exact_deflate_wrapper_hands_the_kernel_its_scratch(stub, monkeypatch):
    """EX's entry takes (data, meta, C, level, out, lens, status, scratch,
    slots, stride, stream): int64 meta and lengths, a long long stride of
    work_bytes(level), one slot a chunk up to MAX_SLOTS, the output buffer
    the end of the last room. At levels 4-9 a round is the resolve (data,
    pieces, P, level, head, ring, deltas, slots, chain and walk blocks,
    count, bits, bit_stride, stream) and the chase (data, meta, pieces, P,
    level, out, lens, status, records, scratch, stride, slots, deltas,
    dlist, bits, bit_stride, clk, stats, stream): one piece a chunk, a Work
    and a record each."""
    monkeypatch.setattr(_device, "ptr", lambda t: t)
    lib = _device.library("exact_deflate")
    data, meta = _ex_args()
    out, lens, st = EK.exact_deflate_cuda(data, meta, 6)
    res, ch = lib.zrs_exact_resolve.args, lib.zrs_exact_chase.args
    assert stub == ["zrs_exact_resolve", "zrs_exact_chase"]
    assert res[2:4] == (2, 6) and res[4] is None and res[5] is None
    assert res[1][:, EK.P_S].tolist() == [0, 1000] and res[1][:, EK.P_E].tolist() == [1000, 3000]
    assert res[6].dtype == torch.int16 and res[6].numel() == 998 + 2998
    assert tuple(res[7].shape) == (3000, 2) and res[8:10] == (1 + 1, 8 + 16)
    assert res[11] is None and ch[13] is None and ch[14] is None
    assert ch[3:5] == (2, 6) and ch[8].numel() == 2 * EK.REC and ch[10] == EK.WORK_BYTES
    assert ch[9].numel() == 2 * EK.WORK_BYTES and ch[11] is res[7] and ch[12] is res[6]
    assert ch[16] is None and out.shape == (11_204,)
    assert EK.launches == {"exact_deflate": 1, "exact_resolve": 1, "exact_dry": 0}
    stub.clear()
    for level, slots, want_slots in ((0, 1024, 2), (EK.QUICK, 1, 1)):
        monkeypatch.setattr(EK, "MAX_SLOTS", slots)
        out, lens, st = EK.exact_deflate_cuda(data, meta, level)
        args = lib.zrs_exact_deflate.args
        assert lib.zrs_exact_deflate.argtypes[9] is ctypes.c_longlong
        assert args[2:4] == (2, level) and args[1].dtype == torch.int64
        assert args[8] == want_slots and args[9] == EK.work_bytes(level)
        assert args[7].shape == (want_slots * EK.work_bytes(level),)
        assert out.shape == (11_204,) and lens.dtype == torch.int64 and st.dtype == torch.int32
    assert EK.work_bytes(6) == EK.WORK_BYTES and EK.work_bytes(EK.QUICK) == \
        EK.WORK_BYTES + EK.WORK4_BYTES
    assert EK.launches["exact_deflate"] == 3
    with pytest.raises(ValueError, match="int64"):
        EK.exact_deflate_cuda(data, meta.int(), 6)
    with pytest.raises(ValueError, match="level"):
        EK.exact_deflate_cuda(data, meta, 42)


def _rounds_logged(stub, monkeypatch, level, rounds):
    """EX's call at `level` with ROUNDS[level] = rounds through the stub:
    the resolve's, the dry parse's and the chase's arguments in order."""
    monkeypatch.setattr(_device, "ptr", lambda t: t)
    monkeypatch.setattr(EK, "ROUNDS", {level: rounds})
    lib = _device.library("exact_deflate")
    seen = []
    for name in ("zrs_exact_resolve", "zrs_exact_dry", "zrs_exact_chase"):
        entry = getattr(lib, name)
        entry.__class__ = type("Logged", (type(entry),), {
            "__call__": lambda self, *a: (seen.append((self.name, a)), _Entry.__call__(self, *a))[1]})
    data, meta = _ex_args()
    EK.exact_deflate_cuda(data, meta, level)
    assert stub == ["zrs_exact_resolve"] + ["zrs_exact_dry", "zrs_exact_resolve"] * \
        (rounds - 1) + ["zrs_exact_chase"]
    return data, seen


@pytest.mark.parametrize("rounds", [1, 2])
@pytest.mark.parametrize("level", [EK.MEDIUM_BASE, EK.MEDIUM_BASE + 2])
def test_exact_deflate_wrapper_runs_the_rounds_at_medium(stub, monkeypatch, level, rounds):
    """MEDIUM takes the resolve and the chase as levels 1-3 do, no
    one-warp zrs_exact_deflate: its slots run MAX_MATCH past each piece
    (slot_end), its deltas to the last position hash4 hashes, its first
    map holds the second chunk's dictionary tail, and the dry parse reads
    the records and the data (its second round taken whatever the first's
    slots, LONG_SHARE 0)."""
    monkeypatch.setattr(EK, "LONG_SHARE", 0.0)
    data, seen = _rounds_logged(stub, monkeypatch, level, rounds)
    stride = EK.bit_words(3000)
    res = seen[0][1]
    bits = res[11]
    assert res[1][:, EK.P_C1].tolist() == [997, 2997] and tuple(res[7].shape) == (997 + 1997, 2)
    words = bits.numpy().view(np.uint32)
    assert words[:stride].tolist() == [0] * stride
    assert words[stride + 31] == 0b111 << 5  # positions 997-999 of the second map
    for name, a in seen:
        if name == "zrs_exact_dry":
            assert a[0] is data and a[2:4] == (2, level) and a[6] is bits and a[7] == stride
        elif name == "zrs_exact_chase":
            assert a[4] == level and a[14] is bits and a[13] is not None
    assert EK.launches == {"exact_deflate": 1, "exact_resolve": rounds, "exact_dry": rounds - 1}


@pytest.mark.parametrize("rounds", [1, 2, 3])
def test_exact_deflate_wrapper_runs_the_rounds_at_levels_1_to_3(stub, monkeypatch, rounds):
    """At levels 1-3 a round of pieces is ROUNDS[level] resolves over chains
    built under the skip map, the dry parse before each but the first,
    then the chase over those chains with a scratch list of its own; the
    map is bit_words(the longest chunk) words a chunk, zeros to start."""
    monkeypatch.setattr(_device, "ptr", lambda t: t)
    monkeypatch.setattr(EK, "ROUNDS", {2: rounds})
    lib = _device.library("exact_deflate")
    seen = []
    for name in ("zrs_exact_resolve", "zrs_exact_dry", "zrs_exact_chase"):
        entry = getattr(lib, name)
        entry.__class__ = type("Logged", (type(entry),), {
            "__call__": lambda self, *a: (seen.append((self.name, a)), _Entry.__call__(self, *a))[1]})
    data, meta = _ex_args()
    EK.exact_deflate_cuda(data, meta, 2)
    assert stub == ["zrs_exact_resolve"] + ["zrs_exact_dry", "zrs_exact_resolve"] * \
        (rounds - 1) + ["zrs_exact_chase"]
    stride = EK.bit_words(3000)
    deltas, bits = seen[0][1][6], seen[0][1][11]
    assert bits.dtype == torch.int32 and bits.shape == (2 * stride,) and not bits.any()
    for name, a in seen:
        if name == "zrs_exact_resolve":
            assert a[11] is bits and a[12] == stride and a[3] == 2 and a[6] is deltas
            assert a[8] == 2 and a[9] == 8 + 16
        elif name == "zrs_exact_dry":
            assert a[2:4] == (2, 2) and a[6] is bits and a[7] == stride and a[4].numel() == 2 * EK.REC
        else:
            assert a[12] is deltas and a[13].shape == deltas.shape and a[13] is not deltas
            assert a[14] is bits and a[15] == stride
    assert EK.launches == {"exact_deflate": 1, "exact_resolve": rounds, "exact_dry": rounds - 1}


def test_exact_deflate_dispatch_by_device(monkeypatch):
    calls = []
    monkeypatch.setattr(EK, "exact_deflate_plain", lambda *a: calls.append("plain"))
    monkeypatch.setattr(EK, "exact_deflate_cuda", lambda *a: calls.append("cuda"))
    data, meta = _ex_args()
    EK.exact_deflate(data, meta, 6)
    EK.exact_deflate(data.to("meta"), meta, 6)
    assert calls == ["plain", "cuda"]


@pytest.mark.parametrize("level", [1, 6, EK.MEDIUM_BASE + 1])
def test_dstream_wrapper_hands_the_kernel_its_work(stub, monkeypatch, level):
    """DS's entry takes (rec, data, work, out, slots, n_slots, deltas,
    dlist, span, pieces, chain blocks, bits, clk, stats, level, stream); a
    MEDIUM handle's work is Work then Work4 (EX's work_bytes), and a shorter
    one raises; at levels 1-3 and MEDIUM it takes a skip map and the chase's
    scratch list."""
    monkeypatch.setattr(_device, "ptr", lambda t: t)
    h = DSK.Handle(level, "cpu")
    assert h.work.numel() == EK.work_bytes(level)
    h.rec[DSK.D_OUT_CAP] = 64
    out, rec_dev = torch.zeros(64, dtype=torch.uint8), torch.zeros(DSK.REC, dtype=torch.int64)
    DSK.pump_cuda(h.rec, h.data, h.work, out, rec_dev)
    args = _device.library("exact_deflate").zrs_dstream_pump.args
    assert args[2] is h.work and int(rec_dev[DSK.D_LEVEL]) == level and args[14] == level
    greedy = EK.mapped_level(level)
    assert (args[11] is not None, args[7] is not None) == (greedy, greedy)
    if greedy:
        assert args[11].dtype == torch.int32 and not args[11].any()
        assert args[7].dtype == torch.int16 and args[7].shape == args[6].shape
    assert DSK.launches["dstream"] == 1
    with pytest.raises(ValueError, match="work"):
        DSK.pump_cuda(h.rec, h.data, h.work[: DSK.WORK_BYTES - 1], out, rec_dev)
