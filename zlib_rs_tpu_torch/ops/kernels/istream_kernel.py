"""IS: the resumable raw-deflate decoder (csrc/istream.cu), its plain
version, the wrapper and the handle.

The port of the reference's native resumable inflate
(zlib_rs_tpu/native.py `RawInflateStream`, C++ `InfStream` in
native/zrs_native.cpp): it replaces no `pallas_call` site. A `Handle`
keeps one stream's state in device memory between pumps:

- the record, int64 [REC]: mode (0 block header, 1 stored, 2 coded, 3
  done, -1 data error), last, stored_left, the unconsumed input's offset
  and end in the input buffer and its bit offset, op (absolute output
  position, a preset dictionary included), base (the absolute position
  of the output buffer's byte 0), the output buffer's capacity, the two
  tables' roots and the room flag of the last launch;
- the current block's decode tables, uint32 [TABLE_WORDS]: litlen and
  distance in native's layout, then the block's code lengths (uint16
  [320] from word LENS_OFF: litlen [0, 288), distance [288, 320)), from
  which the kernel's body builds its own table;
- the input buffer, uint8: the bytes not yet consumed, 8 zero bytes past
  their end;
- the output buffer, uint8: the 32 KiB window behind op and every byte
  not yet served.

A pump (native's `zrs_istream_pump`) appends its input (one host-to-device
copy), advances (one launch of the whole-block decoder, `zrs_istream_sync`;
more where the output room ran out, each after the room was grown), and
serves up to `cap` bytes of [served, op) (one device-to-host copy), with
native's flags: 1 done (the final block decoded and all of it served), 2
data error, 4 more output pending. `take_tail`, `total_out`,
`at_boundary`, `set_dict` and `copy` are native's. The record crosses to
the device before each launch and back after it.

`advance_plain` is native's control flow in Python over the same state
(numpy views of CPU tensors): the kernel computes the same function of
the record, tables and buffers. `advance` runs it for a CPU handle and
launches the kernel for a CUDA one. Nothing falls back. `_fn_warp` is the
one-warp decoder's entry (`zrs_istream_advance`), whose control flow the
kernel's head and tail still run: no route of the handle, only the probes
launch it, to time the two on the same state.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ... import _device

# launches of the CUDA kernel (the whole-block decoder); the plain version
# and the one-warp launch do not count
launches = {"istream": 0}

WSIZE = 32768
TCAP = 32768  # entries a table (kTCap)
LENS_OFF = 2 * TCAP  # the block's code lengths, uint16 [320] (kLensOff)
TABLE_WORDS = LENS_OFF + 160  # litlen, distance, the code lengths (kTableWords)
SCRATCH = 1 << 18  # the kernel's pointer scratch, int32 (kPtrCap)
STATS = 16  # the kernel's counters, int64 (kStats), where a probe passes them
STAT_NAMES = ("windows", "sync_rounds", "max_sync_rounds", "serial_finishes", "jump_rounds",
              "max_jump_rounds", "ns_head", "ns_sync", "ns_expand", "block_copies", "body_out",
              "body_bits", "tables", "ns_write", "ns_spec", "specs")
REC = 16
(R_MODE, R_LAST, R_STORED_LEFT, R_IN_OFF, R_IN_END, R_BIT_OFF, R_OP, R_BASE,
 R_OUT_CAP, R_LT_ROOT, R_DT_ROOT, R_ROOM) = range(12)
M_HEAD, M_STORED, M_CODED, M_DONE, M_ERR = 0, 1, 2, 3, -1
K_LIT, K_MATCH, K_EOB, K_SUB, K_BAD = 0, 1, 2, 3, 4
PAD = 8  # zero bytes kept past the input's end
MIN_ROOM = 1 << 16  # free output room a launch starts with at least
COMPACT = 1 << 20  # bytes of dead output before the buffer is compacted (native's)

LEN_BASE = (3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31, 35, 43, 51, 59,
            67, 83, 99, 115, 131, 163, 195, 227, 258)
LEN_EXTRA = (0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4,
             5, 5, 5, 5, 0)
DIST_BASE = (1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193, 257, 385, 513,
             769, 1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289, 16385, 24577)
DIST_EXTRA = (0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10,
              11, 11, 12, 12, 13, 13)
CL_ORDER = (16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15)
_FIXED_LIT = [8] * 144 + [9] * 112 + [7] * 24 + [8] * 8


def _entry(kind: int, aux: int, nbits: int, payload: int) -> int:
    return (kind << 28) | (aux << 22) | (nbits << 16) | payload


def _sym_entry(alphabet: int, s: int, nbits: int) -> int:
    if alphabet == 0:
        if s < 256:
            return _entry(K_LIT, 0, nbits, s)
        if s == 256:
            return _entry(K_EOB, 0, nbits, 0)
        c = s - 257
        if c >= 29:
            return _entry(K_BAD, 0, nbits, 0)
        return _entry(K_MATCH, LEN_EXTRA[c], nbits, LEN_BASE[c])
    if alphabet == 1:
        if s >= 30:
            return _entry(K_BAD, 0, nbits, 0)
        return _entry(K_MATCH, DIST_EXTRA[s], nbits, DIST_BASE[s])
    return _entry(K_LIT, 0, nbits, s)


def build_table(alphabet: int, lens, root: int):
    """Native build_table: (table list, root), or None where native
    refuses the code (alphabet 0 litlen, 1 distance, 2 code lengths)."""
    cnt = [0] * 16
    for ln in lens:
        if ln:
            cnt[ln] += 1
    nz = [ln for ln in range(1, 16) if cnt[ln]]
    if not nz:
        if alphabet != 1:
            return None
        return [_entry(K_BAD, 0, 1, 0)] * 2, 1
    minlen, maxlen, ncodes = nz[0], nz[-1], sum(cnt)
    left = 1
    for ln in range(1, 16):
        left = 2 * left - cnt[ln]
        if left < 0:
            return None
    if left > 0 and (alphabet == 2 or ncodes != 1):
        return None
    root = min(max(root, minlen), maxlen)
    nxt, code = [0] * 16, 0
    for ln in range(1, 16):
        code = (code + (cnt[ln - 1] if ln > 1 else 0)) << 1
        nxt[ln] = code
    codes = [0] * len(lens)
    for s, ln in enumerate(lens):
        if ln:
            codes[s] = int(f"{nxt[ln]:0{ln}b}"[::-1], 2)
            nxt[ln] += 1
    rmask = (1 << root) - 1
    t = [_entry(K_BAD, 0, root, 0)] * (1 << root)
    sub = {}
    for s, ln in enumerate(lens):
        if ln <= root:
            continue
        low = codes[s] & rmask
        if low in sub:
            continue
        sb = max(lens[q] - root for q in range(len(lens))
                 if lens[q] > root and codes[q] & rmask == low)
        sub[low] = (len(t), sb)
        t[low] = _entry(K_SUB, sb, root, len(t))
        t.extend([_entry(K_BAD, 0, sb, 0)] * (1 << sb))
    for s, ln in enumerate(lens):
        if not ln:
            continue
        c = codes[s]
        if ln <= root:
            e = _sym_entry(alphabet, s, ln)
            for idx in range(c, 1 << root, 1 << ln):
                t[idx] = e
        else:
            off, sb = sub[c & rmask]
            e = _sym_entry(alphabet, s, ln - root)
            for idx in range(c >> root, 1 << sb, 1 << (ln - root)):
                t[off + idx] = e
    return t, root


class _Plain:
    """One advance over a handle's state (numpy views), native's control
    flow with the room pause, as csrc/istream.cu runs it."""

    def __init__(self, rec, tables, inbuf, outbuf):
        self.rec, self.tables, self.outbuf = rec, tables, outbuf
        self.inb = inbuf[: int(rec[R_IN_END]) + PAD].tobytes()
        self.nbits = 8 * int(rec[R_IN_END])
        self.mode, self.last = int(rec[R_MODE]), int(rec[R_LAST])
        self.stored_left = int(rec[R_STORED_LEFT])
        self.op, self.base, self.cap = int(rec[R_OP]), int(rec[R_BASE]), int(rec[R_OUT_CAP])
        self.lt_root, self.dt_root = int(rec[R_LT_ROOT]), int(rec[R_DT_ROOT])
        self.lt = tables[:TCAP].tolist()
        self.dt = tables[TCAP : 2 * TCAP].tolist()
        self.new_tables = False
        self.lens = None
        self.room = False
        self.bp = -1

    def peek(self) -> int:
        i = self.bp >> 3
        return int.from_bytes(self.inb[i : i + 5], "little") >> (self.bp & 7)

    def set_tables(self, lt, dt, ll_lens, d_lens) -> None:
        self.lt, self.lt_root = lt
        self.dt, self.dt_root = dt
        self.lens = (list(ll_lens) + [0] * 288)[:288] + (list(d_lens) + [0] * 32)[:32]
        self.new_tables = True

    def parse_dynamic(self):
        """Native parse_dynamic_tables: (0 | -1 | -3, litlen, distance,
        code lengths)."""
        if self.nbits - self.bp < 14:
            return -3, None, None, None
        h = self.peek()
        nlen, ndist, ncode = (h & 31) + 257, ((h >> 5) & 31) + 1, ((h >> 10) & 15) + 4
        self.bp += 14
        if nlen > 286 or ndist > 30:
            return -1, None, None, None
        cl = [0] * 19
        for i in range(ncode):
            if self.nbits - self.bp < 3:
                return -3, None, None, None
            cl[CL_ORDER[i]] = self.peek() & 7
            self.bp += 3
        ct = build_table(2, cl, 7)
        if ct is None:
            return -1, None, None, None
        ct, ct_root = ct
        total = nlen + ndist
        lens = []
        while len(lens) < total:
            if self.nbits - self.bp < 7:
                return -3, None, None, None
            w = self.peek()
            e = ct[w & ((1 << ct_root) - 1)]
            nb, sym = (e >> 16) & 0x3F, e & 0xFFFF
            if self.nbits - self.bp < nb:
                return -3, None, None, None
            if sym < 16:
                self.bp += nb
                lens.append(sym)
                continue
            extra = 2 if sym == 16 else 3 if sym == 17 else 7
            if self.nbits - self.bp < nb + extra:
                return -3, None, None, None
            self.bp += nb + extra
            v = (w >> nb) & ((1 << extra) - 1)
            if sym == 16:
                if not lens:
                    return -1, None, None, None
                rep, fill = 3 + v, lens[-1]
            else:
                rep, fill = (3 if sym == 17 else 11) + v, 0
            if len(lens) + rep > total:
                return -1, None, None, None
            lens.extend([fill] * rep)
        if lens[256] == 0:
            return -1, None, None, None
        lt = build_table(0, lens[:nlen], 10)
        if lt is None:
            return -1, None, None, None
        dt = build_table(1, lens[nlen:], 9)
        if dt is None:
            return -1, None, None, None
        return 0, lt, dt, (lens[:nlen], lens[nlen:])

    def advance(self) -> None:
        rec = self.rec
        if self.mode in (M_DONE, M_ERR):
            return
        in_off, bit_off = int(rec[R_IN_OFF]), int(rec[R_BIT_OFF])
        if bit_off and int(rec[R_IN_END]) - in_off < 1:
            return
        self.bp = 8 * in_off + bit_off
        out = self.outbuf
        while True:
            if self.mode == M_HEAD:
                sv = self.bp
                if self.nbits - self.bp < 3:
                    self.bp = sv
                    break
                w = self.peek()
                fin, typ = w & 1, (w >> 1) & 3
                self.bp += 3
                if typ == 3:
                    self.mode = M_ERR
                    break
                if typ == 0:
                    self.bp = (self.bp + 7) & ~7
                    if self.nbits - self.bp < 32:
                        self.bp = sv
                        break
                    v = self.peek()
                    self.bp += 32
                    if (v & 0xFFFF) ^ ((v >> 16) & 0xFFFF) != 0xFFFF:
                        self.mode = M_ERR
                        break
                    self.last, self.stored_left, self.mode = fin, v & 0xFFFF, M_STORED
                elif typ == 1:
                    self.set_tables(build_table(0, _FIXED_LIT, 9), build_table(1, [5] * 32, 5),
                                    _FIXED_LIT, [5] * 32)
                    self.last, self.mode = fin, M_CODED
                else:
                    perr, lt, dt, lens = self.parse_dynamic()
                    if perr == -3:
                        self.bp = sv
                        break
                    if perr:
                        self.mode = M_ERR
                        break
                    self.set_tables(lt, dt, *lens)
                    self.last, self.mode = fin, M_CODED
            elif self.mode == M_STORED:
                have = (self.nbits - self.bp) >> 3
                want = min(self.stored_left, have)
                take = min(want, self.cap - (self.op - self.base))
                self.room = take < want
                src, dst = self.bp >> 3, self.op - self.base
                out[dst : dst + take] = np.frombuffer(self.inb[src : src + take], np.uint8)
                self.op += take
                self.bp += 8 * take
                self.stored_left -= take
                if self.stored_left:
                    break
                self.mode = M_DONE if self.last else M_HEAD
                if self.mode == M_DONE:
                    break
            else:
                if self._coded(out):
                    break
            if self.mode == M_ERR:
                break

    def _coded(self, out) -> bool:
        """A coded block's body; True where the advance stops."""
        lt, dt = self.lt, self.dt
        lmask, dmask = (1 << self.lt_root) - 1, (1 << self.dt_root) - 1
        pause = False
        while True:
            sv = self.bp
            avail = self.nbits - sv
            w = self.peek()
            e = lt[w & lmask]
            kind, nb = e >> 28, (e >> 16) & 0x3F
            if kind == K_SUB:
                sb = (e >> 22) & 0x3F
                if avail < nb + sb:
                    pause = True
                    break
                e = lt[(e & 0xFFFF) + ((w >> nb) & ((1 << sb) - 1))]
                kind = e >> 28
                nb += (e >> 16) & 0x3F
            if avail < nb:
                pause = True
                break
            if kind == K_LIT:
                if self.op - self.base >= self.cap:
                    self.room = pause = True
                    break
                out[self.op - self.base] = e & 0xFF
                self.op += 1
                self.bp += nb
                continue
            if kind == K_EOB:
                self.bp += nb
                self.mode = M_DONE if self.last else M_HEAD
                break
            if kind == K_BAD:
                self.mode = M_ERR
                break
            aux = (e >> 22) & 0x3F
            if avail < nb + aux:
                pause = True
                break
            length = (e & 0xFFFF) + ((w >> nb) & ((1 << aux) - 1))
            self.bp += nb + aux
            avail = self.nbits - self.bp
            w2 = self.peek()
            de = dt[w2 & dmask]
            dkind, dnb = de >> 28, (de >> 16) & 0x3F
            if dkind == K_SUB:
                sb = (de >> 22) & 0x3F
                if avail < dnb + sb:
                    pause = True
                    break
                de = dt[(de & 0xFFFF) + ((w2 >> dnb) & ((1 << sb) - 1))]
                dkind = de >> 28
                dnb += (de >> 16) & 0x3F
            if dkind == K_BAD:
                self.mode = M_ERR
                break
            daux = (de >> 22) & 0x3F
            if avail < dnb + daux:
                pause = True
                break
            dist = (de & 0xFFFF) + ((w2 >> dnb) & ((1 << daux) - 1))
            self.bp += dnb + daux
            if dist > self.op:
                self.mode = M_ERR
                break
            if self.op - self.base + length > self.cap:
                self.room = pause = True
                break
            at = self.op - self.base
            if dist >= length:
                out[at : at + length] = out[at - dist : at - dist + length]
            else:
                for j in range(length):
                    out[at + j] = out[at - dist + j]
            self.op += length
        if pause:
            self.bp = sv
        return pause or self.mode in (M_DONE, M_ERR)

    def store(self) -> None:
        rec = self.rec
        if self.bp >= 0:
            rec[R_IN_OFF], rec[R_BIT_OFF] = self.bp >> 3, self.bp & 7
        rec[R_MODE], rec[R_LAST], rec[R_STORED_LEFT] = self.mode, self.last, self.stored_left
        rec[R_OP], rec[R_LT_ROOT], rec[R_DT_ROOT] = self.op, self.lt_root, self.dt_root
        rec[R_ROOM] = int(self.room)
        if self.new_tables:
            self.tables[: len(self.lt)] = self.lt
            self.tables[TCAP : TCAP + len(self.dt)] = self.dt
            self.tables[LENS_OFF:TABLE_WORDS].view(np.uint16)[:] = self.lens


def advance_plain(rec: np.ndarray, tables, inbuf, outbuf) -> None:
    """The plain IS: one advance over CPU state (rec int64 numpy [REC],
    tables int32 [TABLE_WORDS], inbuf and outbuf uint8), in place."""
    s = _Plain(rec, tables.numpy().view(np.uint32), inbuf.numpy(), outbuf.numpy())
    s.advance()
    s.store()


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p


def _fn():
    fn = _device.library("istream").zrs_istream_sync
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, ctypes.c_longlong, _P, _P, _P, _P]
        fn.restype = ctypes.c_int
    return fn


def _fn_warp():
    fn = _device.library("istream").zrs_istream_advance
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _P]
        fn.restype = ctypes.c_int
    return fn


def advance_cuda(rec: np.ndarray, tables, inbuf, outbuf, rec_dev, scratch=None) -> None:
    """One IS launch over CUDA state, the whole-block decoder; the record
    crosses both ways through `rec_dev` (int64 [REC] on the device).
    `scratch` is its pointer scratch in device memory (int32 [SCRATCH],
    made here where not given)."""
    _device.require_cuda("istream", tables, inbuf, outbuf, rec_dev)
    if tables.dtype != torch.int32 or tables.numel() != TABLE_WORDS:
        raise ValueError(f"istream: tables must be int32 [{TABLE_WORDS}]")
    if inbuf.numel() % 4 or inbuf.numel() < int(rec[R_IN_END]) + PAD or inbuf.data_ptr() % 16:
        raise ValueError("istream: the input buffer must hold its bytes, 8 zero bytes and "
                         "a whole number of words, from a 16-byte boundary")
    if outbuf.numel() < int(rec[R_OUT_CAP]):
        raise ValueError("istream: the output buffer is smaller than its capacity")
    if scratch is None:
        scratch = torch.empty(SCRATCH, dtype=torch.int32, device=tables.device)
    _device.require_cuda("istream", tables, scratch)
    if scratch.dtype != torch.int32 or scratch.numel() < SCRATCH:
        raise ValueError(f"istream: the scratch must be int32 [{SCRATCH}]")
    rec_dev.copy_(torch.from_numpy(rec))
    rc = _fn()(_device.ptr(rec_dev), _device.ptr(tables), _device.ptr(inbuf),
               inbuf.numel() // 4, _device.ptr(outbuf), _device.ptr(scratch), None,
               _device.stream_of(tables))
    _device.check(rc, "istream")
    launches["istream"] += 1
    rec[:] = rec_dev.cpu().numpy()


# ---------------------------------------------------------------------------
# the handle
# ---------------------------------------------------------------------------


class Handle:
    """One resumable raw-deflate decode whose state lives on `device`."""

    def __init__(self, device, dictionary: bytes | None = None):
        dev = torch.device(device)
        self.device = dev
        self.rec = np.zeros(REC, np.int64)
        self.rec_dev = torch.zeros(REC, dtype=torch.int64, device=dev) if dev.type == "cuda" \
            else None
        self.tables = torch.zeros(TABLE_WORDS, dtype=torch.int32, device=dev)
        self.scratch = None  # the kernel's pointer scratch, made at the first launch
        self.inbuf = torch.zeros(1 << 12, dtype=torch.uint8, device=dev)
        self.outbuf = torch.zeros(MIN_ROOM, dtype=torch.uint8, device=dev)
        self.rec[R_OUT_CAP] = MIN_ROOM
        self.served = 0
        self.dict_len = 0
        self.fresh = False  # input arrived since the last advance
        if dictionary:
            d = bytes(dictionary)[-WSIZE:]
            self.outbuf[: len(d)] = torch.frombuffer(bytearray(d), dtype=torch.uint8)
            self.rec[R_OP] = self.served = self.dict_len = len(d)

    # -- state helpers ----------------------------------------------------

    def _append(self, data: bytes) -> None:
        rec = self.rec
        off, end = int(rec[R_IN_OFF]), int(rec[R_IN_END])
        if off:  # the consumed prefix leaves the buffer
            if end > off:
                self.inbuf[: end - off] = self.inbuf[off:end].clone()
            end -= off
            rec[R_IN_OFF], rec[R_IN_END] = 0, end
        need = end + len(data) + PAD
        if need > self.inbuf.numel():
            grown = torch.zeros(-(-max(need, 2 * self.inbuf.numel()) // 4) * 4,
                                dtype=torch.uint8, device=self.device)
            grown[:end] = self.inbuf[:end]
            self.inbuf = grown
        blob = np.zeros(len(data) + PAD, np.uint8)
        blob[: len(data)] = np.frombuffer(data, np.uint8)
        self.inbuf[end : end + len(blob)] = torch.from_numpy(blob).to(self.device)
        rec[R_IN_END] = end + len(data)

    def _compact(self) -> None:
        """Drop output before the window and before what is unserved
        (native's compact rule)."""
        rec = self.rec
        op, base = int(rec[R_OP]), int(rec[R_BASE])
        keep_from = min(self.served, op - WSIZE if op >= WSIZE else 0)
        if keep_from > base + COMPACT:
            drop = keep_from - base
            self.outbuf[: op - keep_from] = self.outbuf[drop : op - base].clone()
            rec[R_BASE] = keep_from

    def _room(self, want: int) -> None:
        """At least `want` bytes of free output room."""
        rec = self.rec
        used = int(rec[R_OP] - rec[R_BASE])
        if int(rec[R_OUT_CAP]) - used >= want:
            return
        cap = max(2 * int(rec[R_OUT_CAP]), used + want)
        grown = torch.empty(cap, dtype=torch.uint8, device=self.device)
        grown[:used] = self.outbuf[:used]
        self.outbuf = grown
        rec[R_OUT_CAP] = cap

    def advance(self) -> bool:
        """native's advance: decode as far as the input allows, growing
        the room while IS stops for it. False on a data error."""
        rec = self.rec
        if rec[R_MODE] in (M_DONE, M_ERR) or not self.fresh:
            return rec[R_MODE] != M_ERR
        self.fresh = False
        self._compact()
        self._room(max(MIN_ROOM, 4 * int(rec[R_IN_END] - rec[R_IN_OFF])))
        if self.scratch is None and self.device.type == "cuda":
            self.scratch = torch.empty(SCRATCH, dtype=torch.int32, device=self.device)
        while True:
            advance(rec, self.tables, self.inbuf, self.outbuf, self.rec_dev, self.scratch)
            if not rec[R_ROOM]:
                break
            self._room(int(rec[R_OUT_CAP]))  # twice the room
        return rec[R_MODE] != M_ERR

    # -- native's handle API ----------------------------------------------

    def pump(self, data: bytes, cap: int) -> tuple[bytes, int]:
        """zrs_istream_pump: (up to `cap` output bytes, flags)."""
        if data:
            self._append(bytes(data))
            self.fresh = True
        ok = self.advance()
        rec = self.rec
        op, base = int(rec[R_OP]), int(rec[R_BASE])
        take = min(op - self.served, max(cap, 0))
        out = b""
        if take:
            at = self.served - base
            out = self.outbuf[at : at + take].cpu().numpy().tobytes()
            self.served += take
            self._compact()
        flags = (1 if rec[R_MODE] == M_DONE and self.served == op else 0) | \
            (0 if ok else 2) | (4 if op > self.served else 0)
        return out, flags

    def take_tail(self, cap: int) -> bytes:
        rec = self.rec
        off, end = int(rec[R_IN_OFF]), int(rec[R_IN_END])
        skip = 1 if rec[R_BIT_OFF] else 0
        if end - off < skip:
            return b""
        n = min(end - off - skip, cap)
        out = self.inbuf[off + skip : off + skip + n].cpu().numpy().tobytes() if n else b""
        rec[R_IN_OFF] = off + skip + n
        rec[R_BIT_OFF] = 0
        return out

    @property
    def total_out(self) -> int:
        return int(self.rec[R_OP]) - self.dict_len

    @property
    def mode(self) -> int:
        return int(self.rec[R_MODE])

    def at_boundary(self) -> bool:
        rec = self.rec
        return rec[R_MODE] == M_HEAD and rec[R_BIT_OFF] == 0 and rec[R_IN_OFF] == rec[R_IN_END]

    def copy(self) -> "Handle":
        """A device-to-device clone of the handle."""
        c = object.__new__(Handle)
        c.__dict__ = dict(self.__dict__)
        c.rec = self.rec.copy()
        c.rec_dev = None if self.rec_dev is None else self.rec_dev.clone()
        c.tables = self.tables.clone()
        c.inbuf = self.inbuf.clone()
        c.outbuf = self.outbuf.clone()
        c.scratch = None
        return c


def advance(rec: np.ndarray, tables, inbuf, outbuf, rec_dev=None, scratch=None) -> None:
    """IS: the plain version for CPU state, the kernel for CUDA state."""
    if tables.device.type == "cpu":
        advance_plain(rec, tables, inbuf, outbuf)
    else:
        advance_cuda(rec, tables, inbuf, outbuf, rec_dev, scratch)
