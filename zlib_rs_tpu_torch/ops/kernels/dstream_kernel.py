"""DS: EX's Deflater paused and resumed (the `zrs_dstream_pump` entry of
csrc/exact_deflate.cu), its plain version, the wrapper and the handles.

The port of the reference's native resumable deflate
(zlib_rs_tpu/native.py `RawDeflateStream`, C++ `DefStream` in
native/zrs_native.cpp): it replaces no `pallas_call` site. A `Handle`
keeps one stream's state in device memory between pumps:

- the record, int64 [REC]: EX's scan state (spos, block_start, the
  symbols buffered, the lazy match's carry, the rolling hash, whether the
  scan started, the bit writer's partial word), zlib's `insert` (the
  <= 2 tail positions of the last flush), the level, this pump's flush,
  room and results, and MEDIUM's pre-found next match;
- the data, uint8: the match window and the unflushed block, then each
  pump's input (position 0 is NIL);
- EX's Work, uint8 [work_bytes(level)]: the hash chains (head
  int32[32768] at byte 0, prevd), the block's symbols and the tree
  build's arrays; at MEDIUM then Work4, the 4-byte-hash chains (head4
  int32[65536] at byte WORK_BYTES, prevd4).

A pump (native's `DefStream::pump` then `read`) appends its input (one
host-to-device copy), launches DS once with the flush (0 none, 2 sync,
3 full, 4 finish) and reads back the record and the output (device to
host). Under NO_FLUSH DS scans the positions with at least MIN_LOOKAHEAD
bytes after them; a flush scans all, emits the trailing literal (not at
MEDIUM, as native), the block and the seam (FULL_FLUSH also clears the
3-byte hash and restarts the window, and leaves head4 and MEDIUM's next
match as native does; FINISH ends the stream). The room of a pump is
sized from the unflushed bytes (`room`); a pump that outgrew it raises, as native's -1
would, and drops nothing silently. At levels 1-9 and MEDIUM a pump first
launches the resolve (`exact_deflate_kernel.resolve_cuda`) over the pump's
positions (`ranges`): static chains from its first insert (MEDIUM's:
hash4's, from the last pump's frontier), the older positions read from the
handle's head and prevd (head4 and prevd4), and every position's walks (at
1-3 and MEDIUM EK.ROUNDS[level] rounds under an assumed skip map, a dry
parse between two); DS then chases the slots, and leaves head and prevd
(head4 and prevd4) as the serial inserts would (at 1-3 and MEDIUM over the
chains rebuilt from the positions the parse inserted). At levels 1-9 input
longer than a piece (EK.PIECE) is pumped a piece at a time, so that the
resolve's memory stays bounded (MEDIUM's pumps go whole: native's
lookahead reads the pump's end). Once a FULL_FLUSH has left a MEDIUM
handle's head4 stale (D_MED_STALE), its pumps run native's serial inserts
and walks, with no resolve (`resolved`). After the pump the wrapper prunes
the data as native does: the window and the unflushed block stay, the
rest goes in multiples of WSIZE once it passes 1 MiB, and the hash heads
(head4, MEDIUM's next match and frontier too) are rebased (slide_hash's
role).

The plain version (`Plain`) is, for levels 1-9, the port's host
`Deflator` in raw mode driven by the same flushes: zlib's bytes, which
native's handle gives for every NO/SYNC/FULL/FINISH script; for MEDIUM4-6
(levels 11-13) `models.medium.MediumStream`, native's pump over
run_medium. Its output is handed out at native's granularity (a 64-bit
accumulator: a NO_FLUSH pump returns only whole 8-byte words since the
last byte alignment), so that both give the same bytes pump for pump, and
it scans NO_FLUSH input to native's limit. Levels 0 and QUICK are misuse
(native's -2) and raise RuntimeError at the first pump. `open_stream`
gives the plain version for the CPU and the kernel's handle for a CUDA
device; nothing falls back.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ... import _device
from . import exact_deflate_kernel as EK
from .exact_deflate_kernel import MEDIUM_BASE, WORK_BYTES, WSIZE, is_medium, work_bytes

# launches of the CUDA kernel; the plain version does not count
launches = {"dstream": 0}

REC = EK.REC
(D_TOTAL, D_SPOS, D_BLOCK_START, D_NS, D_MATCH_LENGTH, D_PREV_LENGTH, D_MATCH_START,
 D_PREV_START, D_MATCH_AVAILABLE, D_SH, D_SHV, D_STARTED, D_BW_BUF, D_BW_CNT,
 D_INSERT_PENDING, D_LEVEL, D_FLUSH, D_OUT_CAP, D_OUT_LEN, D_STATUS,
 D_FINISHED, D_MED_NEXT_START, D_MED_NEXT_STRSTART, D_MED_NEXT_ORGSTART,
 D_MED_NEXT_LEN, D_INS_LO, D_INS_HI, D_MED_STALE) = range(28)
MED_NEXT = (D_MED_NEXT_START, D_MED_NEXT_STRSTART, D_MED_NEXT_ORGSTART)
OVERFLOW, MISUSE = -1, -2
MIN_MATCH, MIN_LOOKAHEAD = 3, 262
HASH_SIZE = 1 << 15
HASH4_SIZE = 1 << 16  # MEDIUM's head4
PRUNE = 1 << 20  # bytes of dead data before the buffer is pruned (native's)
FLUSHES = (0, 2, 3, 4)  # none, sync, full, finish


def room(unflushed: int) -> int:
    """A pump's output room: every unflushed byte stored (4 bytes of
    header a block of at least 16,383 symbols, 5 a stored piece of 65,535
    bytes), the bit writer's partial word, the seam and the alignment."""
    return unflushed + (unflushed >> 11) + 64


def ranges(rec) -> tuple[int, int, int, int]:
    """A pump's ranges at levels 1-9 and MEDIUM from its record before the
    pump (the source's ds_ranges): its first insert (spos less zlib's
    pending `insert`; MEDIUM's the last pump's frontier, D_INS_HI), the end
    of the positions it can insert (the deltas cover [first, end)), spos
    and the scan's limit (the slots cover [spos, limit), at MEDIUM to
    EK.slot_end)."""
    total = int(rec[D_TOTAL])
    started = bool(rec[D_STARTED])
    medium = is_medium(int(rec[D_LEVEL]))
    s = int(rec[D_SPOS]) if started else 0
    if not started:
        a = 0
    else:
        a = int(rec[D_INS_HI]) if medium else s - int(rec[D_INSERT_PENDING])
    limit = total if rec[D_FLUSH] else (total - (MIN_LOOKAHEAD - 1) if total >= MIN_LOOKAHEAD
                                        else 0)
    end = total - (EK.WANT_MIN - 1 if medium else MIN_MATCH - 1)
    c1 = max(a, min(max(s, limit + EK.MAX_MATCH), end))
    return a, c1, s, max(s, limit)


def _misuse() -> RuntimeError:
    return RuntimeError("native deflate stream misuse")


def _takes(level: int) -> bool:
    """The levels native's handle takes: 1-9 and MEDIUM4-6."""
    return 1 <= level <= 9 or is_medium(level)


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


_CLASSES = {}


def _classes():
    """The host Deflator scanning NO_FLUSH input to native's limit
    (positions with >= MIN_LOOKAHEAD bytes after them), and its bit writer
    reporting byte alignments to the stream: native's writer stores 8
    bytes each time 64 bits have gathered since the last alignment, and
    all of them at an alignment."""
    if not _CLASSES:
        from ...models import deflate as D

        class StreamDeflator(D.Deflator):
            def _compress_pending_input(self, final: bool, finish: bool = False) -> None:
                n = len(self.buf)
                limit = n if final else max(self.strstart, n - (MIN_LOOKAHEAD - 1))
                if self.func == "fast":
                    self._deflate_fast(limit)
                else:
                    self._deflate_slow(limit, final)

        class Writer(D.BitWriter):
            owner = None

            def send_bits(self, value: int, nbits: int) -> None:
                o = self.owner
                if o.aligned:  # the first bits after an alignment start the accumulator
                    o.epoch = o.drained + len(self.out)
                    o.aligned = False
                super().send_bits(value, nbits)

            def align(self) -> None:
                super().align()
                self.owner.aligned = True

        _CLASSES.update(deflator=StreamDeflator, writer=Writer)
    return _CLASSES["deflator"], _CLASSES["writer"]


class Plain:
    """The plain DS: a stream over the host Deflator (levels 1-9) or
    MediumStream (MEDIUM4-6), native's pump."""

    def __init__(self, level: int):
        self.level = level
        self.finished = False
        self.z = None
        if _takes(level):
            deflator, writer = _classes()
            if is_medium(level):
                from ...models.medium import MediumStream

                self.z = MediumStream(level - MEDIUM_BASE + 4)
            else:
                from ...config import DeflateConfig

                self.z = deflator(DeflateConfig(level=level, window_bits=-15))
            self.z.bw = writer(self.z.pending)
            self.z.bw.owner = self
        self.aligned = True  # the stream starts byte-aligned
        self.epoch = 0  # absolute byte where native's accumulator started
        self.drained = 0  # bytes handed out so far
        self.win = b""  # the last <= 32 KiB of data native keeps

    def pump(self, data: bytes, flush: int) -> bytes:
        from ...config import DeflateFlush

        if self.finished or self.z is None:
            raise _misuse()
        z = self.z
        data = bytes(data)
        if is_medium(self.level):
            z.pump(data, flush)
        else:
            z._last_flush = -2  # native flushes even an empty repeat
            z.deflate(data, {0: DeflateFlush.NO_FLUSH, 2: DeflateFlush.SYNC_FLUSH,
                             3: DeflateFlush.FULL_FLUSH, 4: DeflateFlush.FINISH}[flush])
        emitted = self.drained + len(z.pending)
        if self.aligned:
            commit = emitted
        else:
            bits = 8 * (emitted - self.epoch) + z.bw.bitcnt
            commit = self.epoch + 8 * (bits // 64)
        take = commit - self.drained
        out = bytes(z.pending[:take])
        del z.pending[:take]
        self.drained = commit
        self.win = b"" if flush == 3 else (self.win + data)[-WSIZE:]
        if flush == 4:
            self.finished = True
        return out

    def window(self) -> bytes:
        return self.win

    def copy(self) -> "Plain":
        import copy as _copy

        c = object.__new__(Plain)
        c.__dict__ = dict(self.__dict__)
        if self.z is not None:
            self.z.bw.owner = None
            c.z = _copy.deepcopy(self.z)
            self.z.bw.owner, c.z.bw.owner = self, c
        return c


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p


def _fn():
    fn = _device.library("exact_deflate").zrs_dstream_pump
    if fn.argtypes is None:
        L = ctypes.c_longlong
        fn.argtypes = [_P, _P, _P, _P, _P, L, _P, _P, L, _P, L, _P, _P, _P, ctypes.c_int, _P]
        fn.restype = ctypes.c_int
    return fn


def resolve_operands(rec: np.ndarray, dev):
    """A pump's resolve operands at levels 1-9 and MEDIUM from its record:
    (its piece row on `dev`, or None when its ranges are empty; chain
    blocks, walk blocks, deltas int16 and slots int32 [*, 2] to fill, the
    slots' count, the deltas' count, and at levels 1-3 and MEDIUM the skip
    map, zeros from the first insert rounded down to 32, and the chase's
    scratch int16 (as deltas), else None and None)."""
    a, c1, s, we = ranges(rec)
    total = int(rec[D_TOTAL])
    level = int(rec[D_LEVEL])
    row = [0, total, a, a, c1, 0, s, we, 0, 0, 0, 0, 0, 0]
    n_slots = EK.slot_end(row, is_medium(level)) - s
    deltas = torch.empty(max(c1 - a, 1), dtype=torch.int16, device=dev)
    slots = torch.empty(max(n_slots, 1), 2, dtype=torch.int32, device=dev)
    pieces, _nd, _ns, cb, wb = EK.with_offsets([row], is_medium(level))
    pt = torch.from_numpy(pieces).to(dev) if c1 > a or n_slots > 0 else None
    mapped = EK.mapped_level(level)
    bits = torch.zeros(EK.bit_words(total, a & ~31), dtype=torch.int32, device=dev) \
        if mapped else None
    dlist = torch.empty_like(deltas) if mapped else None
    return pt, cb, wb, deltas, slots, n_slots, c1 - a, bits, dlist


def handle_tables(work, level: int):
    """The handle's chains the resolve reads (uint8 views of its Work):
    head (int32 [32768]; MEDIUM's head4 [65536]) and the prevd ring."""
    if is_medium(level):
        return work[WORK_BYTES:], work[WORK_BYTES + 4 * HASH4_SIZE :]
    return work, work[4 * HASH_SIZE :]


def resolve_pump(rec: np.ndarray, data, work, ops=None, rec_dev=None):
    """The resolve of a pump at levels 1-9 and MEDIUM (launched when its
    ranges are not empty; at 1-3 and MEDIUM EK.ROUNDS[level] rounds over
    chains built under the skip map, the dry parse between two, which at
    MEDIUM resumes from the record already on the device, `rec_dev`, and
    runs only where EK.take_round says) over
    resolve_operands (`ops`, staged here when None): (slots, deltas, the
    slots' count, the deltas' count, the piece row, its chain blocks, the
    skip map, the chase's scratch)."""
    pt, cb, wb, deltas, slots, n_slots, span, bits, dlist = \
        ops or resolve_operands(rec, data.device)
    level = int(rec[D_LEVEL])
    head, ring = handle_tables(work, level)
    if pt is not None:
        for r in range(EK.ROUNDS[level] if bits is not None else 1):
            if r:
                if not EK.take_round(level, slots):
                    break
                if is_medium(level):
                    EK.dry_cuda(pt, level, slots, bits, 0, recs=rec_dev, data=data)
                else:
                    EK.dry_cuda(pt, level, slots, bits, 0)
            EK.resolve_cuda(data, pt, level, deltas, slots, cb, wb, head_old=head, ring=ring,
                            bits=bits)
    return slots, deltas, n_slots, span, pt, cb, bits, dlist


def resolved(rec) -> bool:
    """Whether a pump takes the resolve's slots: levels 1-9, and MEDIUM
    until a FULL_FLUSH has left head4 stale (D_MED_STALE: DS then runs
    native's serial inserts and walks, which a stale head's chains need)."""
    level = int(rec[D_LEVEL])
    return EK.static_level(level) or (is_medium(level) and not rec[D_MED_STALE])


def pump_cuda(rec: np.ndarray, data, work, out, rec_dev, clk=None, stats=None) -> None:
    """One DS launch over CUDA state (at levels 1-9 and MEDIUM the resolve first); the
    record crosses both ways through `rec_dev` (int64 [REC] on the device);
    at levels 1-3 stats (int64 [2] or None) adds the loop tops and the live
    walks; clk (int64 [3] or None) takes the chase's clock64 cycles: in all,
    in flush_block, and of those in emit_symbols."""
    _device.require_cuda("dstream", data, work, out, rec_dev)
    level = int(rec[D_LEVEL])
    need = work_bytes(level) if is_medium(level) else WORK_BYTES
    if work.dtype != torch.uint8 or work.numel() < need:
        raise ValueError(f"dstream: work must be uint8 [>= {need}] at level {level}")
    if data.numel() < int(rec[D_TOTAL]) or out.numel() < int(rec[D_OUT_CAP]):
        raise ValueError("dstream: the data or the room is smaller than the record says")
    slots = deltas = pt = bits = dlist = None
    n_slots = span = cb = 0
    rec_dev.copy_(torch.from_numpy(rec))
    if resolved(rec):
        slots, deltas, n_slots, span, pt, cb, bits, dlist = resolve_pump(rec, data, work,
                                                                         rec_dev=rec_dev)
    rc = _fn()(_device.ptr(rec_dev), _device.ptr(data), _device.ptr(work), _device.ptr(out),
               EK._opt(slots), n_slots, EK._opt(deltas), EK._opt(dlist), span, EK._opt(pt), cb,
               EK._opt(bits), EK._opt(clk), EK._opt(stats), level, _device.stream_of(data))
    _device.check(rc, "dstream")
    launches["dstream"] += 1
    rec[:] = rec_dev.cpu().numpy()


class Handle:
    """One resumable raw deflate whose state lives on a CUDA device."""

    def __init__(self, level: int, device):
        dev = torch.device(device)
        self.device = dev
        self.rec = np.zeros(REC, np.int64)
        self.rec[D_LEVEL] = level
        self.rec[D_MATCH_LENGTH] = self.rec[D_PREV_LENGTH] = MIN_MATCH - 1
        self.rec_dev = torch.zeros(REC, dtype=torch.int64, device=dev) \
            if dev.type == "cuda" else None
        self.data = torch.zeros(1 << 16, dtype=torch.uint8, device=dev)
        self.work = torch.zeros(work_bytes(level) if is_medium(level) else WORK_BYTES,
                                dtype=torch.uint8, device=dev)
        self.level = level

    @property
    def finished(self) -> bool:
        return bool(self.rec[D_FINISHED])

    def _append(self, data: bytes) -> None:
        total = int(self.rec[D_TOTAL])
        need = total + len(data) + 8
        if need > self.data.numel():
            grown = torch.zeros(max(need, 2 * self.data.numel()), dtype=torch.uint8,
                                device=self.device)
            grown[:total] = self.data[:total]
            self.data = grown
        if data:
            self.data[total : total + len(data)] = torch.frombuffer(
                bytearray(data), dtype=torch.uint8).to(self.device)
        self.rec[D_TOTAL] = total + len(data)

    def _prune(self) -> None:
        """native DefStream::prune: keep the match window and the
        unflushed block, drop a multiple of WSIZE (the chain slots are
        keyed by position mod WSIZE) once it reaches 1 MiB."""
        rec = self.rec
        if not rec[D_STARTED]:
            return
        spos, block_start = int(rec[D_SPOS]), int(rec[D_BLOCK_START])
        keep = min(spos - WSIZE if spos > WSIZE else 0, block_start) & ~(WSIZE - 1)
        if keep < PRUNE:
            return
        total = int(rec[D_TOTAL])
        self.data[: total - keep] = self.data[keep:total].clone()
        heads = [self.work[: 4 * HASH_SIZE].view(torch.int32)]
        fields = [D_MATCH_START, D_PREV_START]
        if is_medium(self.level):
            heads.append(self.work[WORK_BYTES : WORK_BYTES + 4 * HASH4_SIZE].view(torch.int32))
            fields += MED_NEXT + (D_INS_HI,)
        for head in heads:
            head.copy_(torch.where(head > keep, head - keep, torch.zeros_like(head)))
        rec[D_TOTAL] = total - keep
        rec[D_SPOS] = spos - keep
        rec[D_BLOCK_START] = block_start - keep
        for f in fields:
            rec[f] = max(int(rec[f]) - keep, 0)

    def pump(self, data: bytes, flush: int) -> bytes:
        """native's pump and read. At levels 1-9 input longer than
        EK.PIECE goes to DS a piece at a time, NO_FLUSH but the last, which
        takes `flush` (the same bytes: no decision depends on how much input
        has arrived), so that a pump's deltas and slots cover at most a
        piece and MIN_LOOKAHEAD positions."""
        if self.finished or not _takes(self.level):
            raise _misuse()
        if flush not in FLUSHES:
            raise ValueError(f"dstream: flush must be one of {FLUSHES}, got {flush}")
        data = bytes(data)
        step = EK.PIECE if EK.static_level(self.level) else max(len(data), 1)
        last = max(len(data) - 1, 0) // step * step
        return b"".join(self._pump_one(data[i : i + step], flush if i == last else 0)
                        for i in range(0, last + 1, step))

    def _pump_one(self, data: bytes, flush: int) -> bytes:
        rec = self.rec
        self._append(data)
        cap = room(int(rec[D_TOTAL] - rec[D_BLOCK_START]))
        out = torch.empty(cap, dtype=torch.uint8, device=self.device)
        rec[D_FLUSH], rec[D_OUT_CAP] = flush, cap
        pump(rec, self.data, self.work, out, self.rec_dev)
        if rec[D_STATUS] == OVERFLOW:
            raise RuntimeError("native deflate buffer overflow")
        if rec[D_STATUS] == MISUSE:
            raise _misuse()
        n = int(rec[D_OUT_LEN])
        self._prune()
        return out[:n].cpu().numpy().tobytes()

    def window(self) -> bytes:
        """The last <= 32 KiB of input the stream keeps (the live match
        window): meaningful at a flush seam."""
        total = int(self.rec[D_TOTAL])
        n = min(total, WSIZE)
        return self.data[total - n : total].cpu().numpy().tobytes()

    def copy(self) -> "Handle":
        """A device-to-device clone of the handle."""
        c = object.__new__(Handle)
        c.__dict__ = dict(self.__dict__)
        c.rec = self.rec.copy()
        c.rec_dev = None if self.rec_dev is None else self.rec_dev.clone()
        c.data = self.data.clone()
        c.work = self.work.clone()
        return c


def pump(rec: np.ndarray, data, work, out, rec_dev=None) -> None:
    """DS on CUDA state. The plain DS is a different engine (`Plain`), so
    a CPU handle has no launch; the CPU tests patch this name with the
    source's host build."""
    pump_cuda(rec, data, work, out, rec_dev)


def open_stream(level: int, device):
    """A DS stream at `level`: the plain version on the CPU, the kernel's
    handle on a CUDA device."""
    dev = torch.device(device)
    return Plain(level) if dev.type == "cpu" else Handle(level, dev)

