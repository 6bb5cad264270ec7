"""The chunk decode through the inflate kernel K6, the seeded swarm decode
engine, and the host parse of a chunk's block header for the seeded
decode engines.

The port of zlib_rs_tpu/parallel/swarm_inflate.py's `decode_chunks_kernel`
(lines 296-331), `_HostBits` and `parse_block_header` (lines 65-160), and
its seeded swarm engine, `decode_seeded` and `decode_chunks_seeded`
(lines 163-293, 389-436), the bench's `make_kernel_dispatch` (lines
334-353) and the sharded `make_sharded_decode_step` (lines 356-385: each
rank of a torch.distributed mesh decodes its rows, then all_gathers them
in chunk order). The swarm engine's walker loop is the hand-written CUDA
kernel csrc/swarm.cu for CUDA tensors (`walk`; its plain version
`walk_plain`, torch ops, for CPU ones); the table build and the resolver
around it are torch ops.

The swarm engine decodes the chunks of an indexed stream from the seeds
the encoder recorded (`compress_parallel(..., return_index=True)`): the
block header is parsed on the host, the flat decode tables are built on
the device (device_inflate._build_flat_lut), and every seed starts a
walker that decodes one symbol a step from its own bit cursor into a
token tape until it has covered exactly its span; the tapes then resolve
into bytes (device_inflate.resolve_tokens). A walker must land on the
next seed's bit cursor, and a bad symbol, a short span or drift flags its
chunk; `decode_chunks_seeded` raises SwarmDataFault for the caller's
fallback.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _device
from ..ops import huffman as H
from ..ops.kernels import inflate_kernel as IK
from ..utils.stages import STAGES
from . import device_inflate as DI
from . import mesh as M

SEEDS_PER_CHUNK = 128  # decode seeds of an indexed dynamic chunk
CAP_QUANTUM = 512  # the walker step bound is rounded up to a multiple of this
CHECK_EVERY = 16  # walker steps between two host checks for live walkers

# runs of the swarm engine's walkers, for tests and the smoke run to show
# the engine ran
runs = {"decode_seeded": 0}

# launches of the walker kernel; the plain version does not count
launches = {"swarm_walk": 0}


class KernelDataFault(ValueError):
    """K6 could not decode the input exactly: a bad lane or a short
    output. The caller takes it as a data fault and falls back."""


class SwarmDataFault(ValueError):
    """The swarm engine could not decode the input exactly: a chunk that is
    not seedable, a seed count other than SEEDS_PER_CHUNK, a bad or
    drifting walker or a short output. The caller takes it as a data fault
    and falls back."""


def _kernel_inputs(bodies, out_sizes, dev) -> list:
    """K6's operands on `dev`: the bodies' LE32 words, zero start bits,
    their bit lengths and the output targets."""
    words, comp_bits = IK.pack_streams_words(bodies)
    return [
        torch.from_numpy(words.view(np.int32)).to(dev),
        torch.zeros(len(bodies), dtype=torch.int32, device=dev),
        torch.from_numpy(comp_bits).to(dev),
        torch.from_numpy(np.asarray(out_sizes, np.int32)).to(dev),
    ]


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
        args = _kernel_inputs(bodies, out_sizes, dev)
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


def make_kernel_dispatch(bodies, out_sizes, *, device=None):
    """A zero-argument dispatch over K6's operands staged once on `device`
    (the GPU when None): each call launches K6 alone, through the same
    `IK.decode_streams` call as decode_chunks_kernel, and returns its
    outputs on the device, unchecked. The shape the bench traces."""
    max_out = max(out_sizes)
    args = _kernel_inputs(bodies, out_sizes, _device.resolve_device(device))

    def dispatch():
        return IK.decode_streams(*args, max_out=max_out)

    return dispatch


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


def _words_at_every_byte(comp: torch.Tensor) -> torch.Tensor:
    """The little-endian u32 at every byte offset of each row, int64 [B, L],
    reading zeros past the row's end."""
    b = torch.nn.functional.pad(comp.to(torch.int64), (0, 3))
    return b[:, :-3] | (b[:, 1:-2] << 8) | (b[:, 2:-1] << 16) | (b[:, 3:] << 24)


def walk_plain(comp, ll_lut, d_lut, seeds_bit, seeds_span, cap: int, *,
               check_every: int = CHECK_EVERY):
    """The walkers of `decode_seeded` in torch ops, the plain version of
    the walker kernel (csrc/swarm.cu): every live walker decodes one symbol
    a step. comp uint8 [B, L] (L >= 12), ll_lut and d_lut int [B, 2^15]
    flat tables, seeds_bit and seeds_span int [B, S]. Returns the tapes
    (tok_kind uint8, tok_a, tok_b int32 [B, S * cap], walker s of a row in
    slots [s * cap, (s + 1) * cap)), each walker's end bit and remaining
    span (int64 [B * S]) and its bad flag (bool [B * S]).

    The reference loops while any walker is live. Past that point a step
    writes empty tokens and moves nothing (a walker that went bad keeps
    decoding the same symbol and stays bad), so the host looks for a live
    walker only every `check_every` steps; the tapes are the same.
    """
    B, L = comp.shape
    S = seeds_bit.shape[1]
    W = B * S
    dev = comp.device
    words = _words_at_every_byte(comp).reshape(-1)
    ll_lut = ll_lut.to(torch.int64).reshape(-1)
    d_lut = d_lut.to(torch.int64).reshape(-1)
    lane = torch.arange(B, device=dev).repeat_interleave(S)
    base_byte = lane * L
    base_lut = lane << DI.FLAT_BITS
    mask15 = (1 << DI.FLAT_BITS) - 1
    m32 = 0xFFFFFFFF
    bitpos = seeds_bit.to(device=dev, dtype=torch.int64).reshape(W).clone()
    remaining = seeds_span.to(device=dev, dtype=torch.int64).reshape(W).clone()
    bad = torch.zeros(W, dtype=torch.bool, device=dev)
    # time-major tapes: a step writes one contiguous row
    tk = torch.zeros((cap, W), dtype=torch.uint8, device=dev)
    ta = torch.zeros((cap, W), dtype=torch.int32, device=dev)
    tb = torch.zeros((cap, W), dtype=torch.int32, device=dev)

    def window(lo, hi, n):
        """Bits [n, n + 32) of the 64-bit window hi:lo."""
        return ((lo >> n) | torch.where(n > 0, hi << (32 - n), 0)) & m32

    for it in range(cap):
        if it % check_every == 0 and it and not bool(((remaining > 0) & ~bad).any()):
            break
        active = remaining > 0
        byte = base_byte + (bitpos >> 3).clamp(0, L - 9)
        sh = bitpos & 7
        w0 = words[byte]
        w1 = words[byte + 4]
        w2 = words[byte + 8]
        lo = window(w0, w1, sh)
        hi = window(w1, w2, sh)

        e = ll_lut[base_lut + (lo & mask15)]
        kind = e >> 28
        aux = (e >> 22) & 0x3F
        nb = (e >> 16) & 0x3F
        payload = e & 0xFFFF
        # bits [nb, nb + aux): the length's extra bits
        length = payload + (window(lo, hi, nb) & ((1 << aux) - 1))
        p2 = nb + aux
        win2 = window(lo, hi, p2)
        de = d_lut[base_lut + (win2 & mask15)]
        dkind = de >> 28
        daux = (de >> 22) & 0x3F
        dnb = (de >> 16) & 0x3F
        dist = (de & 0xFFFF) + ((win2 >> dnb) & ((1 << daux) - 1))

        is_lit = kind == DI.KIND_LIT
        is_match = (kind == DI.KIND_MATCH) & (dkind == DI.KIND_MATCH)
        is_bad = active & ((kind == DI.KIND_INVALID)
                           | (kind == DI.KIND_EOB)  # a span ends before the EOB
                           | ((kind == DI.KIND_MATCH) & (dkind != DI.KIND_MATCH)))
        cover = torch.where(is_lit, 1, torch.where(is_match, length, 0))
        is_bad |= active & (cover > remaining)
        adv = torch.where(is_lit, nb, torch.where(is_match, nb + aux + dnb + daux, 0))
        emit = active & ~is_bad
        tk[it] = torch.where(emit & is_lit, DI.TOK_LIT,
                             torch.where(emit & is_match, DI.TOK_MATCH, DI.TOK_NULL))
        ta[it] = torch.where(emit, cover, 0)
        tb[it] = torch.where(emit, torch.where(is_lit, payload, dist), 0)
        bitpos = torch.where(emit, bitpos + adv, bitpos)
        remaining = torch.where(emit, remaining - cover, remaining)
        bad |= is_bad

    tapes = [t.T.reshape(B, S * cap) for t in (tk, ta, tb)]
    return (*tapes, bitpos, remaining, bad)


def _lib():
    fn = _device.library("swarm").zrs_swarm_walk
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, I, ctypes.c_longlong, I, P, P, P, P, I, P, P, P, P, P, P, P]
        fn.restype = ctypes.c_int
    return fn


def walk_cuda(comp, ll_lut, d_lut, seeds_bit, seeds_span, cap: int):
    """Launch the walker kernel over CUDA operands, a thread a walker, each
    to its own end. Returns what `walk_plain` returns on the same inputs."""
    _device.require_cuda("swarm_walk", comp, ll_lut, d_lut, seeds_bit, seeds_span)
    if comp.dtype != torch.uint8 or comp.dim() != 2 or comp.shape[1] < 12:
        raise ValueError(f"swarm_walk: comp must be uint8 [B, L >= 12], got {comp.dtype} "
                         f"{tuple(comp.shape)}")
    comp = comp.contiguous()
    B, L = comp.shape
    S = seeds_bit.shape[1]
    W = B * S
    dev = comp.device
    ll32, d32 = (t.to(torch.int32).contiguous() for t in (ll_lut, d_lut))
    sbit, sspan = (t.to(torch.int64).contiguous() for t in (seeds_bit, seeds_span))
    tk = torch.zeros((W, cap), dtype=torch.uint8, device=dev)
    ta = torch.zeros((W, cap), dtype=torch.int32, device=dev)
    tb = torch.zeros((W, cap), dtype=torch.int32, device=dev)
    end_bit = torch.empty(W, dtype=torch.int64, device=dev)
    remaining = torch.empty(W, dtype=torch.int64, device=dev)
    bad = torch.empty(W, dtype=torch.uint8, device=dev)
    if W:
        rc = _lib()(
            _device.ptr(comp), B, L, S, _device.ptr(ll32), _device.ptr(d32), _device.ptr(sbit),
            _device.ptr(sspan), cap, _device.ptr(tk), _device.ptr(ta), _device.ptr(tb),
            _device.ptr(end_bit), _device.ptr(remaining), _device.ptr(bad),
            _device.stream_of(comp),
        )
        _device.check(rc, "swarm_walk")
        launches["swarm_walk"] += 1
    tapes = [t.reshape(B, S * cap) for t in (tk, ta, tb)]
    return (*tapes, end_bit, remaining, bad.bool())


def walk(comp, ll_lut, d_lut, seeds_bit, seeds_span, cap: int, *,
         check_every: int = CHECK_EVERY):
    """The swarm engine's walkers: the plain version for a CPU tensor, the
    kernel for a CUDA one."""
    if comp.device.type == "cpu":
        return walk_plain(comp, ll_lut, d_lut, seeds_bit, seeds_span, cap,
                          check_every=check_every)
    return walk_cuda(comp, ll_lut, d_lut, seeds_bit, seeds_span, cap)


def decode_seeded(comp, ll_lens, d_lens, seeds_bit, seeds_span, cap: int, max_out: int, *,
                  check_every: int = CHECK_EVERY):
    """Decode B chunks with S exact walkers each, on the inputs' device.

    comp: uint8 [B, L] chunk bodies zero-padded at least 12 bytes past the
    data; ll_lens, d_lens: int [B, 320] code lengths from the host header
    parse; seeds_bit: int [B, S] the body bit cursor of each walker's first
    symbol; seeds_span: int [B, S] the output bytes each walker must cover;
    cap: the most steps a walker takes. Returns (out uint8 [B, max_out],
    produced int32 [B], bad bool [B]). The walkers run in `walk`;
    `check_every` is the plain version's.
    """
    runs["decode_seeded"] += 1
    B, L = comp.shape
    S = seeds_bit.shape[1]
    dev = comp.device
    rev = torch.from_numpy(DI._REV15_NP).to(dev)
    ll_lut = DI._build_flat_lut(ll_lens.to(dev), *DI._ll_symbol_fields(320), rev)
    d_lut = DI._build_flat_lut(d_lens.to(dev), *DI._d_symbol_fields(320), rev)
    sbit = seeds_bit.to(device=dev, dtype=torch.int64)
    sspan = seeds_span.to(device=dev, dtype=torch.int64)
    *tapes, bitpos, remaining, bad = walk(comp, ll_lut, d_lut, sbit, sspan, cap,
                                          check_every=check_every)

    # exactness: every walker drained its span and landed on the next
    # seed's bit cursor (walkers with no span never move)
    bad = bad | (remaining > 0)
    end_bits = bitpos.reshape(B, S)
    drift = (end_bits[:, :-1] != sbit[:, 1:]) & (sspan[:, :-1] > 0)
    lane_bad = bad.reshape(B, S).any(dim=1) | drift.any(dim=1)
    win = torch.zeros((B, 0), dtype=torch.uint8, device=dev)
    out, produced = DI.resolve_tokens(comp, *tapes, win, max_out, 0)
    return out, produced, lane_bad


def make_sharded_decode_step(mesh, *, cap: int, max_out: int):
    """The sharded decode step over a 1-D "chunks" DeviceMesh: returns
    fn(comp, ll_lens, d_lens, seeds_bit, seeds_span), each argument the
    rank's rows of `decode_seeded`'s operands (the same number on every
    rank: the batch divides by the mesh's width), that decodes them with
    `decode_seeded` on the rank's device (the walker kernel on a card) and
    returns (out, produced, bad) of the whole batch, all_gathered in chunk
    order on every rank."""
    lay = M.layout(mesh)

    def step(comp, ll_lens, d_lens, seeds_bit, seeds_span):
        comp, ll_lens, d_lens, seeds_bit, seeds_span = (
            torch.as_tensor(a).to(lay.device)
            for a in (comp, ll_lens, d_lens, seeds_bit, seeds_span))
        out, produced, bad = decode_seeded(comp, ll_lens, d_lens, seeds_bit, seeds_span,
                                           cap=cap, max_out=max_out)
        return tuple(M.gather_rows(t, lay) for t in (out, produced, bad))

    return step


def seeded_inputs(bodies, out_sizes, seeds):
    """The host staging of the swarm engine: (comp uint8 [B, L], ll_lens,
    d_lens int32 [B, 320], seeds_bit, seeds_span int64 [B, S], cap) as
    numpy arrays and an int, from the bodies, their output sizes and their
    (bit offsets, output offsets) seeds. Raises SwarmDataFault for a chunk
    that is not seedable or a seed count other than SEEDS_PER_CHUNK."""
    B = len(bodies)
    S = SEEDS_PER_CHUNK
    L = max(len(b) for b in bodies) + 12
    comp = np.zeros((B, L), np.uint8)
    ll = np.zeros((B, 320), np.int32)
    dd = np.zeros((B, 320), np.int32)
    sbit = np.zeros((B, S), np.int64)
    sspan = np.zeros((B, S), np.int64)
    for k, body in enumerate(bodies):
        comp[k, : len(body)] = np.frombuffer(body, np.uint8)
        parsed = parse_block_header(body)
        if parsed is None:
            raise SwarmDataFault(f"chunk {k}: not a seedable coded block")
        _bt, ll[k], dd[k], hdr_bits = parsed
        bits, outs = seeds[k]
        if len(bits) != S:
            raise SwarmDataFault(f"chunk {k}: expected {S} seeds, got {len(bits)}")
        sbit[k] = np.asarray(bits, np.int64) + hdr_bits
        sspan[k] = np.diff(np.concatenate([np.asarray(outs, np.int64), [out_sizes[k]]]))
    # the step bound in quanta, so that its value changes seldom
    cap = -(-(int(sspan.max()) + 1) // CAP_QUANTUM) * CAP_QUANTUM
    return comp, ll, dd, sbit, sspan, cap


def decode_chunks_seeded(bodies, out_sizes, seeds, *, max_out=None, device=None):
    """Decode chunk bodies with their (bit offsets, output offsets) seeds,
    as compress_parallel records them, through the swarm engine on
    `device` (the GPU when None; "cpu" runs it in torch on the CPU).
    Returns a list of bytes, one per body, or raises SwarmDataFault."""
    B = len(bodies)
    if B == 0:
        return []
    dev = _device.resolve_device(device)
    max_out = max_out or max(out_sizes)
    with STAGES.host("swarm_prepare"):
        *arrays, cap = seeded_inputs(bodies, out_sizes, seeds)
        args = [torch.from_numpy(a).to(dev) for a in arrays]
    with STAGES.stage("swarm_decode", dev):
        out, produced, bad = decode_seeded(*args, cap=cap, max_out=max_out)
    if STAGES.enabled and dev.type == "cuda":
        torch.cuda.synchronize(dev)  # keep device time out of the host stage
    with STAGES.host("swarm_checks"):
        bad_np = bad.cpu().numpy()
        if bad_np.any():
            raise SwarmDataFault(f"swarm decode drift on lanes {np.nonzero(bad_np)[0][:4]}")
        produced_np = produced.cpu().numpy()
        out_np = out.cpu().numpy()
        parts = []
        for k in range(B):
            if produced_np[k] < out_sizes[k]:
                raise SwarmDataFault(f"chunk {k}: short output {produced_np[k]}")
            parts.append(out_np[k, : out_sizes[k]].tobytes())
        return parts
