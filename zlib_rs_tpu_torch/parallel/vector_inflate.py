"""The vector decode engine: seeded chunks decoded walker-parallel on the
device, through K4 (decode to paired tape rows) and K5 (expansion to
bytes), or, under ZRS_VECTOR_TWOPLANE=0, the single-plane K11a and K11b.

The port of zlib_rs_tpu/parallel/vector_inflate.py.
Inputs are chunk bodies, the encoder-recorded seeds of an indexed stream
(128 (bit offset, output offset) pairs per chunk, `compress_parallel(...,
return_index=True)`) and a host parse of each chunk's block header.

Exactness contract: every walker must drain its span exactly and land on
the next live walker's seed bit; an invalid code, an early end of block, a
short span, drift or a coverage gap raises VectorDataFault (a ValueError),
which the caller takes as a data fault (pipeline.decompress_parallel falls
back to its next engine). The kernel wrappers' own argument checks raise a
plain ValueError, which is not a data fault. The container checksum stays
the last oracle.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import _device
from ..ops.kernels import vhuff_kernel as VK
from ..utils.stages import STAGES
from .swarm_inflate import parse_block_header


class VectorDataFault(ValueError):
    """The input cannot be decoded by the vector engine exactly: a chunk
    that is not seedable, bad or short walkers, drift, a coverage gap."""


def _bucket(n: int, q: int) -> int:
    return -(-n // q) * q


def _pack_words(comp: np.ndarray) -> np.ndarray:
    """uint8[B, L] -> little-endian int32[B, ceil(L/4)] word view."""
    B, L = comp.shape
    Lp = _bucket(L, 4)
    padded = np.zeros((B, Lp), np.uint8)
    padded[:, :L] = comp
    return padded.view("<u4").astype(np.int64).astype(np.int32)


def prepare_vector_inputs(bodies, out_sizes, seeds, device=None):
    """Host-side staging of the decode: the header parse,
    the cascade tables and the per-walker arrays, copied to `device` (the
    GPU when None). Returns (dev, meta); raises VectorDataFault when a chunk is
    not seedable (stored block, malformed header, seed count not a
    positive multiple of 128)."""
    device = _device.resolve_device(device)
    B = len(bodies)
    S = len(seeds[0][0])
    if S == 0 or S % 128 != 0:
        raise VectorDataFault(f"vector engine needs seeds %% 128 == 0 (> 0), got {S}")
    L = max(len(b) for b in bodies) + 16
    comp = np.zeros((B, L), np.uint8)
    sbit = np.zeros((B, S), np.int64)
    sspan = np.zeros((B, S), np.int32)
    tables = np.zeros((B, VK.TABLE_WORDS), np.int32)
    for k, body in enumerate(bodies):
        comp[k, : len(body)] = np.frombuffer(body, np.uint8)
        parsed = parse_block_header(body)
        if parsed is None:
            raise VectorDataFault(f"chunk {k}: not a seedable coded block")
        _bt, ll_k, d_k, hdr_bits = parsed
        tables[k] = VK.table_row(ll_k, d_k)
        bits, outs = seeds[k]
        if len(bits) != S:
            raise VectorDataFault(f"chunk {k}: expected {S} seeds, got {len(bits)}")
        sbit[k] = np.asarray(bits, np.int64) + hdr_bits
        outs_arr = np.asarray(outs, np.int64)
        sspan[k] = np.diff(np.concatenate([outs_arr, [out_sizes[k]]]))

    # walker input span in words: seed-to-seed bit distance (the last
    # walker runs to the body end), +3 words of refill slack
    end_bits = np.concatenate(
        [sbit[:, 1:], np.array([len(b) * 8 for b in bodies])[:, None]], axis=1
    )
    span_words = (end_bits - (sbit & ~31)) // 32 + 1
    K = int(_bucket(int(span_words.max()) + 3, 8))
    cap = int(_bucket(int(sspan.max()) + 2, 256))

    # walker s of chunk k covers output bytes [offs[k, s], offs[k, s + 1])
    offs = np.zeros((B, S + 1), np.int32)
    for k in range(B):
        offs[k, :S] = np.asarray(seeds[k][1], np.int64)
        offs[k, S] = out_sizes[k]

    host = {
        "words": _pack_words(comp),
        "start_word": (sbit >> 5).astype(np.int32).reshape(-1),
        "align": (sbit & 31).astype(np.int32).reshape(-1),
        "span": sspan.reshape(-1),
        "tables": tables,
        "offs": offs,
    }
    dev = {name: torch.from_numpy(a).to(device) for name, a in host.items()}
    meta = {"B": B, "S": S, "K": K, "cap": cap, "sbit": sbit, "sspan": sspan}
    return dev, meta


def _twoplane_default() -> bool:
    """The paired-row engine (<= 3 literals and the following match, or 4
    literals, per tape row, over a 128-bit bit window) is the default;
    ZRS_VECTOR_TWOPLANE=0 selects the single-plane engine."""
    return os.environ.get("ZRS_VECTOR_TWOPLANE") != "0"


def _twoplane_cap(meta) -> int:
    """Row capacity of the paired-row tape: every mid-stream row covers
    >= 3 output bytes (a lone match is >= 3; literals pair with the next
    match or pack 4-wide), so span/3 rows plus a small tail allowance
    suffice. Too small a cap fails safe: a walker stops at row cap with
    span left, and rem != 0 raises."""
    return min(meta["cap"], int(_bucket(int(meta["sspan"].max()) // 3 + 40, 128)))


def _run(dev, meta, *, max_out: int):
    """K4 then K5 (K11a then K11b under ZRS_VECTOR_TWOPLANE=0) on the
    staged inputs: (out words [B, out_words], cons, bad, rem [W]), all on
    the inputs' device. The single-plane tape is row-major [cap, W], so it
    needs none of the reference's relayout to walker-major order."""
    device = dev["words"].device
    out_words = -(-max_out // 4) + 2
    args = (dev["words"], dev["start_word"], dev["align"], dev["span"], dev["tables"])
    if not _twoplane_default():
        with STAGES.stage("vhuff_decode1", device):
            tape, cons, bad, rem = VK.decode_tokens_vector(
                *args, S=meta["S"], K=meta["K"], cap=meta["cap"]
            )
        with STAGES.stage("vhuff_expand1", device):
            outw = VK.expand_tokens(tape, dev["offs"], out_words=out_words)
        return outw, cons, bad, rem
    cap2 = _twoplane_cap(meta)
    with STAGES.stage("vhuff_decode", device):
        tapeA, tapeB, cons, bad, rem = VK.decode_tokens_vector2(
            *args, S=meta["S"], K=meta["K"], cap=cap2
        )
    with STAGES.stage("vhuff_expand", device):
        outw = VK.expand_tokens2(tapeA, tapeB, dev["offs"], out_words=out_words)
    return outw, cons, bad, rem


def decode_chunks_vector(bodies, out_sizes, seeds, *, device=None):
    """Decode chunk bodies with the vector engine on `device` (the GPU
    when None; "cpu" runs the kernels' plain versions). Returns a list of
    bytes, one per chunk, or raises VectorDataFault for the caller's
    fallback."""
    B = len(bodies)
    if B == 0:
        return []
    with STAGES.host("decode_prepare"):
        dev, meta = prepare_vector_inputs(bodies, out_sizes, seeds, device)
    outw, cons, bad, rem = _run(dev, meta, max_out=max(out_sizes))
    if STAGES.enabled and outw.device.type == "cuda":
        torch.cuda.synchronize(outw.device)  # keep device time out of the host stage
    with STAGES.host("decode_checks"):
        S = meta["S"]
        # one device -> host copy of the three walker arrays
        walk = torch.stack([cons, bad, rem]).cpu().numpy().reshape(3, B, S)
        cons_np = walk[0].astype(np.int64)
        # every walker clean AND drained exactly (rem == 0 means the
        # expansion wrote exactly [offs[s], offs[s + 1]), driven by tokens)
        bad_np = (walk[1] != 0) | (walk[2] != 0)
        if bad_np.any():
            raise VectorDataFault(f"vector decode bad/short walkers {np.argwhere(bad_np)[:4]}")
        # seam check chained through zero-span walkers: each positive-span
        # walker lands exactly on the bit offset of the next positive-span
        # walker (padded duplicate seeds are inert and must not mask drift)
        end_bits = meta["sbit"] + cons_np
        for k in range(B):
            live = np.nonzero(meta["sspan"][k] > 0)[0]
            if live.size > 1 and (end_bits[k, live[:-1]] != meta["sbit"][k, live[1:]]).any():
                raise VectorDataFault(f"vector decode drift in chunk {k}")
        # spans must tile [0, out_size) exactly
        for k in range(B):
            if int(meta["sspan"][k].sum()) != int(out_sizes[k]):
                raise VectorDataFault(f"vector span coverage gap in chunk {k}")
        out_np = outw.cpu().numpy().view(np.uint8)
        return [out_np[k, : out_sizes[k]].tobytes() for k in range(B)]


def make_vector_dispatch(bodies, out_sizes, seeds, *, device=None):
    """A zero-argument dispatch over inputs staged once on `device` (the
    GPU when None): each call re-runs K4 and K5 (K11a and K11b under
    ZRS_VECTOR_TWOPLANE=0) and returns their outputs on the device,
    unchecked. The shape the bench traces."""
    dev, meta = prepare_vector_inputs(bodies, out_sizes, seeds, device)
    max_out = max(out_sizes)

    def dispatch():
        return _run(dev, meta, max_out=max_out)

    return dispatch
