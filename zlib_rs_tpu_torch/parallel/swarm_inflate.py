"""The chunk decode through the inflate kernel K6, and the host parse of a
chunk's block header for the seeded decode engines.

The port of zlib_rs_tpu/parallel/swarm_inflate.py's `decode_chunks_kernel`
(lines 296-331), `_HostBits` and `parse_block_header` (lines 65-160). The
seeded swarm engine (the XLA walkers, `decode_chunks_seeded`) and the
bench's `make_kernel_dispatch` are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _device
from ..ops import huffman as H
from ..ops.kernels import inflate_kernel as IK
from ..utils.stages import STAGES


class KernelDataFault(ValueError):
    """K6 could not decode the input exactly: a bad lane or a short
    output. The caller takes it as a data fault and falls back."""


def decode_chunks_kernel(bodies, out_sizes, *, device=None):
    """Decode chunk bodies (or any raw-deflate streams) with K6 on `device`
    (the GPU when None; "cpu" runs its plain version): one sequential
    inflate per stream, no seeds and no host header parse. Returns a list
    of bytes, one per body, or raises KernelDataFault on any bad lane or
    short output."""
    B = len(bodies)
    if B == 0:
        return []
    dev = _device.resolve_device(device)
    max_out = max(out_sizes)
    with STAGES.host("kernel_prepare"):
        words, comp_bits = IK.pack_streams_words(bodies)
        args = [
            torch.from_numpy(words.view(np.int32)).to(dev),
            torch.zeros(B, dtype=torch.int32, device=dev),
            torch.from_numpy(comp_bits).to(dev),
            torch.from_numpy(np.asarray(out_sizes, np.int32)).to(dev),
        ]
    with STAGES.stage("inflate", dev):
        out, produced, bad, _end_bit = IK.decode_streams(*args, max_out=max_out)
    if STAGES.enabled and dev.type == "cuda":
        torch.cuda.synchronize(dev)  # keep device time out of the host stage
    with STAGES.host("kernel_checks"):
        bad_np = bad.cpu().numpy()
        if bad_np.any():
            raise KernelDataFault(f"kernel decode failed on lanes {np.nonzero(bad_np)[0][:4]}")
        produced_np = produced.cpu().numpy()
        out_np = out.cpu().numpy()
        parts = []
        for k in range(B):
            if produced_np[k] < out_sizes[k]:
                raise KernelDataFault(f"chunk {k}: short output {produced_np[k]}")
            parts.append(out_np[k, : out_sizes[k]].tobytes())
        return parts

_CL_ORDER_NP = np.array(
    [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15], np.int64
)
_FIXED_LL = np.concatenate(
    [np.full(144, 8), np.full(112, 9), np.full(24, 7), np.full(8, 8)]
).astype(np.int32)
_FIXED_D = np.full(30, 5, np.int32)


class _HostBits:
    """LSB-first bit reader; bits past the end of `data` read as 0."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def peek(self, n: int) -> int:
        """The next n <= 25 bits, without consuming them."""
        b = self.pos >> 3
        word = int.from_bytes(self.data[b : b + 4], "little")
        return (word >> (self.pos & 7)) & ((1 << n) - 1)

    def take(self, n: int) -> int:
        v = self.peek(n)
        self.pos += n
        return v


def _cl_decoder(cl_lens) -> list:
    """(symbol, length) for each 7-bit peek of the code-length code, or
    None where no code matches. The shortest (code, length) key wins and,
    among equal keys, the highest symbol: the first match of the bit-by-
    bit search over a dict filled in symbol order."""
    _, cl_codes = H.canonical_codes(cl_lens)
    lut = {}
    for sym in range(19):
        ln = int(cl_lens[sym])
        if ln:
            lut[(int(cl_codes[sym]), ln)] = sym
    table = []
    for v in range(128):
        hit = None
        for ln in range(1, 8):
            sym = lut.get((v & ((1 << ln) - 1), ln))
            if sym is not None:
                hit = (sym, ln)
                break
        table.append(hit)
    return table


def parse_block_header(body: bytes):
    """Host parse of one deflate block header.

    Returns (btype, ll_lens int32[320], d_lens int32[320], header_bits) or
    None for stored blocks and malformed headers: HLIT over 286, an
    undecodable code-length symbol, a repeat that overruns HLIT + HDIST, or
    no length for end-of-block.
    """
    br = _HostBits(body)
    _bfinal = br.take(1)
    btype = br.take(2)
    if btype == 1:
        ll = np.zeros(320, np.int32)
        ll[:288] = _FIXED_LL
        d = np.zeros(320, np.int32)
        d[:30] = _FIXED_D
        return btype, ll, d, br.pos
    if btype != 2:
        return None
    hlit = br.take(5) + 257
    hdist = br.take(5) + 1
    hclen = br.take(4) + 4
    if hlit > 286:
        return None
    cl_lens = np.zeros(19, np.int64)
    for i in range(hclen):
        cl_lens[_CL_ORDER_NP[i]] = br.take(3)
    decode = _cl_decoder(cl_lens)
    lens = np.zeros(320, np.int32)
    have = 0
    prev = 0
    while have < hlit + hdist:
        hit = decode[br.peek(7)]
        if hit is None:
            return None
        sym, ln = hit
        br.pos += ln
        if sym < 16:
            lens[have] = sym
            prev = sym
            have += 1
        elif sym == 16:
            rep = 3 + br.take(2)
            lens[have : have + rep] = prev
            have += rep
        elif sym == 17:
            rep = 3 + br.take(3)
            have += rep
        else:
            rep = 11 + br.take(7)
            have += rep
        if have > hlit + hdist:
            return None
    ll = np.zeros(320, np.int32)
    ll[:hlit] = lens[:hlit]
    d = np.zeros(320, np.int32)
    d[:hdist] = lens[hlit : hlit + hdist]
    if ll[256] == 0:
        return None
    return btype, ll, d, br.pos
