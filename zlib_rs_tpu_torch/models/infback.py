"""inflateBack: callback-driven single-pass raw-deflate decoder (a copy of
zlib_rs_tpu/models/infback.py, host code): inflateBackInit / inflateBack /
inflateBackEnd. Unlike the streaming Inflator, this is a self-contained
single-pass decode loop honoring zlib's inflateBack contract:

  * raw deflate only, no header/trailer, no checksum;
  * the caller supplies the sliding window buffer (inflateBackInit's
    `window` argument) and it doubles as the output buffer — decoding
    allocates nothing per stream and the same state/window can be reused
    across `run()` calls (infback.rs:27-95);
  * input is pulled through `in_func`; output is pushed through `out_func`
    exactly when the window fills and once at stream end, so back-
    references always resolve inside the caller's window.

Table-driven: uses the shared two-level LUTs from ops/huffman.inflate_table
(the inftrees.rs analogue); the decode loop itself is independent of
models/inflate.py, mirroring how infback.rs keeps its own copy of the loop.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from ..config import ReturnCode
from ..ops import huffman as H

InFunc = Callable[[], bytes]  # returns b"" when input is exhausted
OutFunc = Callable[[bytes], bool]  # returns False to abort

CL_ORDER = H.CL_ORDER


class InflateBack:
    """Reusable inflateBack state with a caller-supplied window
    (reference: infback.rs:27 back_init)."""

    def __init__(self, window_bits: int = 15, window: bytearray | None = None):
        if not (8 <= window_bits <= 15):
            raise ValueError("window_bits must be in 8..=15")
        self.window_bits = window_bits
        self.wsize = 1 << window_bits
        if window is None:
            window = bytearray(self.wsize)
        if len(window) < self.wsize:
            raise ValueError(f"window must hold {self.wsize} bytes")
        self.window = window
        self.msg: str | None = None

    # -- the single-pass loop -------------------------------------------------

    def run(self, in_func: InFunc, out_func: OutFunc) -> ReturnCode:
        """Decode one raw deflate stream (reference: infback.rs:95 back).

        Returns StreamEnd on success; DataError with `self.msg` set on
        corrupt input; BufError when input runs dry or `out_func` aborts.
        """
        win = self.window
        wsize = self.wsize
        self.msg = None

        # bit reader over pulled input chunks
        state = {"buf": b"", "pos": 0, "bits": 0, "hold": 0, "eof": False}

        def pull() -> bool:
            if state["eof"]:
                return False
            chunk = in_func() or b""
            if not chunk:
                state["eof"] = True
                return False
            state["buf"] = chunk
            state["pos"] = 0
            return True

        def need(nbits: int) -> bool:
            while state["bits"] < nbits:
                if state["pos"] >= len(state["buf"]) and not pull():
                    return False
                state["hold"] |= state["buf"][state["pos"]] << state["bits"]
                state["pos"] += 1
                state["bits"] += 8
            return True

        def take(nbits: int) -> int:
            v = state["hold"] & ((1 << nbits) - 1)
            state["hold"] >>= nbits
            state["bits"] -= nbits
            return v

        def decode(table, root) -> tuple[int, int, int] | None:
            """Return (kind, aux, payload) consuming the code bits, or None
            on input exhaustion."""
            while True:
                e = int(table[state["hold"] & ((1 << root) - 1)])
                kind = (e >> 28) & 0xF
                aux = (e >> 22) & 0x3F
                nbits = (e >> 16) & 0x3F
                payload = e & 0xFFFF
                if kind == H.KIND_SUB:
                    if state["bits"] < root + aux:
                        if need(root + aux):
                            continue
                        return None
                    sub = int(
                        table[payload + ((state["hold"] >> root) & ((1 << aux) - 1))]
                    )
                    kind = (sub >> 28) & 0xF
                    aux2 = (sub >> 22) & 0x3F
                    nbits2 = (sub >> 16) & 0x3F
                    payload = sub & 0xFFFF
                    take(root + nbits2)
                    return kind, aux2, payload
                if nbits > state["bits"]:
                    if need(nbits):
                        continue
                    return None
                take(nbits)
                return kind, aux, payload

        # window write cursor; out_func fires on each fill (infback.rs out())
        wnext = 0
        whave = 0

        def flush_window() -> bool:
            nonlocal wnext, whave
            ok = out_func(bytes(win[:wnext]))
            whave = max(whave, wnext)
            return ok

        def err(msg: str) -> ReturnCode:
            self.msg = msg
            return ReturnCode.DataError

        while True:  # per block
            if not need(3):
                return ReturnCode.BufError
            last = take(1)
            btype = take(2)
            if btype == 3:
                return err("invalid block type")
            if btype == 0:  # stored
                take(state["bits"] & 7)  # byte align
                if not need(32):
                    return ReturnCode.BufError
                ln = take(16)
                nlen = take(16)
                if ln != (~nlen & 0xFFFF):
                    return err("invalid stored block lengths")
                while ln:
                    # copy directly into the caller window, flushing on fill
                    if wnext == wsize:
                        if not flush_window():
                            return ReturnCode.BufError
                        wnext = 0
                    if state["bits"] >= 8:
                        win[wnext] = take(8)
                        wnext += 1
                        ln -= 1
                        continue
                    if state["pos"] >= len(state["buf"]) and not pull():
                        return ReturnCode.BufError
                    run = min(ln, len(state["buf"]) - state["pos"], wsize - wnext)
                    if run <= 0:
                        continue
                    win[wnext : wnext + run] = state["buf"][
                        state["pos"] : state["pos"] + run
                    ]
                    state["pos"] += run
                    wnext += run
                    ln -= run
            else:
                if btype == 1:
                    ll_table, ll_root = H.FIXED_LITLEN_TABLE, H.FIXED_LITLEN_ROOT
                    d_table, d_root = H.FIXED_DIST_TABLE, H.FIXED_DIST_ROOT
                else:  # dynamic: read the code-length tree, then both trees
                    if not need(14):
                        return ReturnCode.BufError
                    hlit = take(5) + 257
                    hdist = take(5) + 1
                    hclen = take(4) + 4
                    if hlit > 286 or hdist > 30:
                        return err("too many length or distance symbols")
                    cl_lens = np.zeros(19, np.int64)
                    for i in range(hclen):
                        if not need(3):
                            return ReturnCode.BufError
                        cl_lens[CL_ORDER[i]] = take(3)
                    cl_table, cl_root, e = H.inflate_table(H.CODES, cl_lens, 7)
                    if e:
                        return err("invalid code lengths set")
                    lens = np.zeros(hlit + hdist, np.int64)
                    i = 0
                    while i < hlit + hdist:
                        sym = decode(cl_table, cl_root)
                        if sym is None:
                            return ReturnCode.BufError
                        _kind, _aux, s = sym
                        if s < 16:
                            lens[i] = s
                            i += 1
                        elif s == 16:
                            if i == 0:
                                return err("invalid bit length repeat")
                            if not need(2):
                                return ReturnCode.BufError
                            rep = 3 + take(2)
                            if i + rep > hlit + hdist:
                                return err("invalid bit length repeat")
                            lens[i : i + rep] = lens[i - 1]
                            i += rep
                        elif s == 17:
                            if not need(3):
                                return ReturnCode.BufError
                            rep = 3 + take(3)
                            if i + rep > hlit + hdist:
                                return err("invalid bit length repeat")
                            i += rep
                        else:
                            if not need(7):
                                return ReturnCode.BufError
                            rep = 11 + take(7)
                            if i + rep > hlit + hdist:
                                return err("invalid bit length repeat")
                            i += rep
                    if lens[256] == 0:
                        return err("invalid code -- missing end-of-block")
                    ll_table, ll_root, e = H.inflate_table(H.LENS, lens[:hlit], 9)
                    if e:
                        return err("invalid literal/lengths set")
                    d_table, d_root, e = H.inflate_table(H.DISTS, lens[hlit:], 6)
                    if e:
                        return err("invalid distances set")

                while True:  # per symbol
                    sym = decode(ll_table, ll_root)
                    if sym is None:
                        return ReturnCode.BufError
                    kind, aux, payload = sym
                    if kind == H.KIND_LITERAL:
                        if wnext == wsize:
                            if not flush_window():
                                return ReturnCode.BufError
                            wnext = 0
                        win[wnext] = payload
                        wnext += 1
                    elif kind == H.KIND_EOB:
                        break
                    elif kind == H.KIND_MATCH:
                        length = payload
                        if aux:
                            if not need(aux):
                                return ReturnCode.BufError
                            length += take(aux)
                        dsym = decode(d_table, d_root)
                        if dsym is None:
                            return ReturnCode.BufError
                        dkind, daux, dpay = dsym
                        if dkind != H.KIND_MATCH:
                            return err("invalid distance code")
                        dist = dpay
                        if daux:
                            if not need(daux):
                                return ReturnCode.BufError
                            dist += take(daux)
                        if dist > max(whave, wnext):
                            return err("invalid distance too far back")
                        # back-copy within the caller window; the forward
                        # byte-by-byte copy realizes overlapped (dist<len)
                        # run semantics, wrapping source and destination
                        while length:
                            if wnext == wsize:
                                if not flush_window():
                                    return ReturnCode.BufError
                                wnext = 0
                            src = wnext - dist
                            if src < 0:
                                src += wsize
                            run = min(length, wsize - wnext)
                            for _ in range(run):
                                win[wnext] = win[src]
                                wnext += 1
                                src += 1
                                if src == wsize:
                                    src = 0
                            length -= run
                    else:
                        return err("invalid literal/length code")
            if last:
                if wnext and not flush_window():
                    return ReturnCode.BufError
                return ReturnCode.StreamEnd


def inflate_back(
    in_func: InFunc, out_func: OutFunc, window_bits: int = 15,
    window: bytearray | None = None,
) -> ReturnCode:
    """One-shot inflateBack (reference: infback.rs:95)."""
    return InflateBack(window_bits, window).run(in_func, out_func)
