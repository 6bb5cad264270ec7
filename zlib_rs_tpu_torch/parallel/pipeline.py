"""Chunk-parallel deflate on one CUDA device, or sharded over the ranks
of a torch.distributed mesh (`mesh=`, `make_sharded_encode_step`; see
parallel/mesh.py): the encode half.

Input is split into fixed-size chunks, every chunk is compressed on the
device as one Huffman block (a dynamic block body at levels 3-9, a whole
static block at levels up to 2), and the host stitches the byte-aligned
chunk blocks into ONE valid zlib/gzip/raw stream:

  * each non-final chunk ends byte-aligned with an empty stored block
    (a sync flush), so concatenation is pure byte concatenation;
  * the final chunk's block carries BFINAL;
  * per-chunk adler32 values (the K1 kernel) are combined on the host;
    so are the gzip trailer's per-chunk crc32 values (the K7 kernel over
    the full chunks, the host crc32 of the tail).

Device stages per batch of chunks (the kernel engine): a matcher, chosen
as the reference chooses it (`_resolve_kernel_variant`) -- `scan_chunks_hop`
(hop tables in torch, the K2 chase (K12 under ZRS_TPU_HOP_IL=2), the
symbol histogram; levels 3-7),
`scan_chunks_tab` (match tables in torch, the K10 table walk;
ZRS_TPU_HOPSCAN=0, a wide ZRS_TPU_WG, level 9 with a short ZRS_TPU_CHAIN)
or `scan_chunks` (the K8 hash-chain scan; levels 8-9, ZRS_TPU_TABSCAN=0)
-> `freq_pack_chunks` (the K9 histogram after K8 and K10, both trees in
torch, the K3 pack) -> K1 adler32; the host builds each chunk's block
header from the code lengths and splices it in front of the body.

The XLA engine (the reference's default: ZRS_TPU_KERNEL unset or other
than 1, levels up to 2, chunk buffers past the kernel's MAX_BUF) runs the
torch stages of ops/lz77.py and ops/dynhuff.py on batches of 16 chunks:
find_matches -> greedy_parse -> token codes (static codes, or the dynamic
symbols, histograms and trees) -> pack_bits [-> seeds] -> K1 adler32.

Every produced stream decodes with any zlib inflater.

The decode half, `decompress_parallel`, decodes indexed streams chunk-
parallel on the device with the vector engine (parallel/vector_inflate.py:
K4 decode and K5 expansion, or K11a and K11b under ZRS_VECTOR_TWOPLANE=0)
or the inflate kernel K6 (one sequential inflate
per chunk, parallel/swarm_inflate.decode_chunks_kernel) or the seeded
swarm engine (parallel/swarm_inflate.decode_chunks_seeded, its walkers in
the CUDA kernel csrc/swarm.cu over flat decode tables), behind the container checksum gate, and last
the region decode (parallel/inflate.decompress_chunks: K6, then the
lockstep engine), as the reference ends its device chain.
"""

from __future__ import annotations

import collections
import os
import zlib

import numpy as np
import torch

from .. import _device
from ..config import DeflateConfig, Strategy, Wrap, decode_window_bits_deflate
from ..models import deflate as host_deflate
from ..models.deflate import BitWriter, _scan_code_lengths
from ..ops import checksum, dynhuff, lz77
from ..ops import huffman as H
from ..ops.kernels import deflate_kernel as DK
from ..utils.stages import STAGES
from . import mesh as M
from . import swarm_inflate, vector_inflate

DEFAULT_CHUNK = 32 * 1024  # the kernel engine's chunk size
XLA_CHUNK = 128 * 1024  # the XLA engine's chunk size (the reference's DEFAULT_CHUNK)
SEEDS_PER_CHUNK = swarm_inflate.SEEDS_PER_CHUNK  # decode seeds per indexed dynamic chunk
SUPER_BATCH = 128  # chunks per batch for the bulk of a kernel-engine input
TAIL_BATCH = 16  # chunks per batch for the rest, and for the XLA engine

# Observability of engine fallbacks, keyed "stage:ExcType". The encode
# path catches nothing; the decode path counts the data faults it falls
# back on (a VectorDataFault of the vector engine, a KernelDataFault of
# K6, a SwarmDataFault of the swarm engine, a checksum mismatch), so a
# healthy run leaves this empty and callers can assert it.
_FALLBACKS: "collections.Counter[str]" = collections.Counter()


def _note_fallback(stage: str, exc: BaseException) -> None:
    _FALLBACKS[f"{stage}:{type(exc).__name__}"] += 1


def fallback_stats() -> dict:
    """Counters of device-path fallbacks since import: {stage:ExcType: n}."""
    return dict(_FALLBACKS)


class ChunkIndex(list):
    """Chunk index: a list of (body_offset, body_len, out_len) tuples,
    optionally carrying per-chunk decode seeds (`.seeds`: a list of
    (bit_offsets, out_offsets), or None for stored-fallback chunks)."""

    seeds = None


def _dyn_header(ll_lens: np.ndarray, d_lens: np.ndarray, final: bool) -> tuple[bytes, int]:
    """One dynamic block header (BFINAL/BTYPE/HLIT/HDIST/HCLEN + the code
    length RLE) from the device-computed length arrays. O(100) bits."""
    nlen = max(257, int(np.max(np.nonzero(ll_lens)[0])) + 1) if np.any(ll_lens) else 257
    ndist = int(np.max(np.nonzero(d_lens)[0])) + 1 if np.any(d_lens) else 1
    rle_ll = _scan_code_lengths(ll_lens[:nlen])
    rle_d = _scan_code_lengths(d_lens[:ndist])
    bl_freq = np.zeros(19, np.int64)
    for sym, _v, _eb in rle_ll + rle_d:
        bl_freq[sym] += 1
    bl_lens = H.huffman_code_lengths(bl_freq, 7)
    _, bl_codes = H.canonical_codes(bl_lens)
    order = H.CL_ORDER
    hclen = 19
    while hclen > 4 and bl_lens[order[hclen - 1]] == 0:
        hclen -= 1
    out = bytearray()
    bw = BitWriter(out)
    bw.send_bits(1 if final else 0, 1)
    bw.send_bits(2, 2)
    bw.send_bits(nlen - 257, 5)
    bw.send_bits(ndist - 1, 5)
    bw.send_bits(hclen - 4, 4)
    for i in range(hclen):
        bw.send_bits(int(bl_lens[order[i]]), 3)
    for sym, v, eb in rle_ll + rle_d:
        bw.send_bits(int(bl_codes[sym]), int(bl_lens[sym]))
        if eb:
            bw.send_bits(v, eb)
    nbits = len(out) * 8 + bw.bitcnt
    if bw.bitcnt:
        out.append(bw.bitbuf & 0xFF)
    return bytes(out), nbits


def _splice_bits(header: bytes, hb: int, body_u8: np.ndarray, body_bits: int) -> bytes:
    """Concatenate two LSB-first bitstreams: header (hb bits) + body."""
    nbody = (body_bits + 7) // 8
    body = body_u8[: nbody + 1]  # +1 slack for the shifted tail
    if body.shape[0] < nbody + 1:
        body = np.concatenate([body, np.zeros(nbody + 1 - body.shape[0], np.uint8)])
    r = hb & 7
    total_bytes = (hb + body_bits + 7) // 8
    if r == 0:
        return (header + body[:nbody].tobytes())[:total_bytes]
    b16 = body.astype(np.uint16)
    lo = ((b16 << r) & 0xFF).astype(np.uint8)
    hi = (b16 >> (8 - r)).astype(np.uint8)
    out = bytearray(header)
    out[-1] |= int(lo[0])
    tail = hi[:-1] | lo[1:]
    out.extend(tail.tobytes())
    return bytes(out[:total_bytes])


def _level_knobs(level: int) -> dict:
    """The XLA matcher's (chain_depth, max_words, lazy) for a level, and
    zlib's (good, max_lazy, nice, chain) for the kernel matcher. At level 6
    the kernel's chain budget is 64 instead of zlib's 128 (the kernel
    engine's speed/ratio knee); ZRS_TPU_CHAIN overrides it. Levels -1 and
    0 fall in the first class, as in the reference."""
    kcfg = DK.ZLIB_CONFIG[min(max(level, 1), 9)]
    if level == 6 or level == -1:
        kcfg = (kcfg[0], kcfg[1], kcfg[2], 64)
    chain_env = os.environ.get("ZRS_TPU_CHAIN")
    if chain_env:
        kcfg = (kcfg[0], kcfg[1], kcfg[2], int(chain_env))
    if level <= 1:
        return dict(chain_depth=1, max_words=8, lazy=False, kernel_cfg=kcfg)
    if level <= 3:
        return dict(chain_depth=4, max_words=16, lazy=False, kernel_cfg=kcfg)
    if level <= 6:
        return dict(chain_depth=12, max_words=32, lazy=True, kernel_cfg=kcfg)
    if level <= 8:
        return dict(chain_depth=16, max_words=32, lazy=True, kernel_cfg=kcfg)
    return dict(chain_depth=24, max_words=64, lazy=True, kernel_cfg=kcfg)


def _resolve_kernel_variant(kernel_cfg) -> tuple[str, int]:
    """(variant, w_g) of the kernel engine's matcher: "hop" (hop tables +
    the K2 chase, the default), "tab" (table walk) or "chain" (hash-chain
    walk, also the route of chains over 256)."""
    _good, mlazy, _nice, chain = kernel_cfg or (8, 16, 128, 128)
    wg = int(os.environ.get("ZRS_TPU_WG", "6"))
    if chain > 256 or os.environ.get("ZRS_TPU_TABSCAN", "1") == "0":
        return "chain", wg
    if (mlazy - 3 < 128 and 4 * wg < 128
            and os.environ.get("ZRS_TPU_HOPSCAN", "1") != "0"):
        return "hop", wg
    return "tab", wg


def _encode_batch(chunks, n_valid, finals, valid_from, *, dict_size, n_seeds, dynamic,
                  kernel_scan, chain_depth, max_words, lazy, kernel_cfg, variant=None,
                  w_g=None):
    """One batch, uint8 [B, dict + chunk + PAD] -> (words, bits, ll_lens,
    d_lens, seeds_bit, seeds_out). Static chunks (levels up to 2) come back
    as complete blocks, with None for the lengths and the seeds; dynamic
    ones as block bodies.

    With `kernel_scan`, the kernel engine: `variant` is the matcher route
    of `_resolve_kernel_variant`, "hop" (K2, whose chase also counts the
    literals), "tab" (K10) or "chain" (K8); the last two leave the
    histogram to K9 inside `freq_pack_chunks`. Otherwise the XLA engine's
    torch stages, lz77.encode_chunk_static or dynhuff.encode_chunk_dynamic
    with the level's (chain_depth, max_words, lazy)."""
    if not kernel_scan:
        knobs = dict(chain_depth=chain_depth, max_words=max_words, lazy=lazy,
                     start=dict_size, valid_from=valid_from)
        if not dynamic:
            words, bits = lz77.encode_chunk_static(chunks, n_valid, finals, **knobs)
            return words, bits, None, None, None, None
        res = dynhuff.encode_chunk_dynamic(chunks, n_valid, n_seeds=n_seeds, **knobs)
        return res if n_seeds else (*res, None, None)
    good, mlazy, nice, chain = kernel_cfg
    with STAGES.stage("words", chunks.device):
        words4 = DK.words_from_bytes(chunks)
    freq = None
    if variant == "hop":
        mpos, mld, nmatch, kbad, freq = DK.scan_chunks_hop(
            words4, n_valid, valid_from, start=dict_size, depth=chain, nice=nice,
            good=good, max_lazy=mlazy, w_g=w_g, bytes_arr=chunks,
        )
    elif variant == "tab":
        mpos, mld, nmatch, kbad = DK.scan_chunks_tab(
            words4, n_valid, valid_from, start=dict_size, depth=chain, nice=nice,
            good=good, max_lazy=mlazy, w_g=w_g, bytes_arr=chunks,
        )
    else:
        mpos, mld, nmatch, kbad = DK.scan_chunks(
            words4, n_valid, dict_size, valid_from, depth=chain, nice=nice,
            good=good, max_lazy=mlazy,
        )
    # a bad (match-overflow) chunk degrades to an all-literal parse
    nm_eff = torch.where(kbad, 0, nmatch)
    res = DK.freq_pack_chunks(
        chunks, n_valid, dict_size, mpos, mld, nm_eff, freq, n_seeds=n_seeds
    )
    if n_seeds:
        words, bits, ll_lens, d_lens, seeds_bit, seeds_out, _bad = res
    else:
        (words, bits, ll_lens, d_lens, _bad), seeds_bit, seeds_out = res, None, None
    return words, bits, ll_lens, d_lens, seeds_bit, seeds_out


def _stored_blocks(data: bytes, final: bool) -> bytes:
    """Byte-aligned stored block(s) for one chunk (used when the coded
    block would be larger)."""
    out = bytearray()
    i = 0
    while True:
        take = min(len(data) - i, 65535)
        is_last = final and (i + take == len(data))
        out.append(1 if is_last else 0)  # BFINAL + BTYPE=00 + 5 pad bits
        out.extend(take.to_bytes(2, "little"))
        out.extend((~take & 0xFFFF).to_bytes(2, "little"))
        out.extend(data[i : i + take])
        i += take
        if i >= len(data):
            return bytes(out)


def _assemble(payloads, chunks_raw, n_chunks: int):
    """Stitch per-chunk block payloads [(bytes, total_bits)]: byte-align
    every non-final chunk with an empty stored block (the 00 00 FF FF sync
    seam); the final chunk carries BFINAL and is only zero-padded. A chunk
    whose coded block is larger than raw + overhead is re-emitted as
    stored blocks. Also returns per-chunk stored flags."""
    out = bytearray()
    index = []
    stored_flags = []
    for k in range(n_chunks):
        payload, total_bits = payloads[k]
        raw_chunk = chunks_raw[k]
        final = k == n_chunks - 1
        start = len(out)
        stored_cost = len(raw_chunk) + 5 * max(1, -(-len(raw_chunk) // 65535))
        if (total_bits + 7) // 8 > stored_cost and len(raw_chunk):
            out.extend(_stored_blocks(raw_chunk, final))
            index.append((start, len(out) - start, len(raw_chunk)))
            stored_flags.append(True)
            continue  # stored blocks end byte-aligned: no seam needed
        out.extend(payload)
        if not final:
            # stored-block seam: 3 header bits are 0, padding bits are 0 —
            # all inside already-zero bytes — then LEN=0000/NLEN=FFFF
            rem = total_bits & 7
            if rem == 0 or rem > 5:
                out.append(0)  # the 3 header bits need a fresh byte
            out.extend(b"\x00\x00\xff\xff")
        index.append((start, len(out) - start, len(raw_chunk)))
        stored_flags.append(False)
    return out, index, stored_flags


def priming_dict_size(n_chunks: int, chunk_size: int, prime: bool, *,
                      shrink: bool = True) -> int:
    """Bytes of preceding data each chunk sees as dictionary: 32 KiB when
    priming a multi-chunk input. With `shrink` (the kernel engine's
    setting) it is cut, never below 8 KiB of room, so that dict + chunk +
    PAD fits the kernel's u16 position space; a buffer that cannot fit it
    keeps the full 32 KiB and runs the XLA engine."""
    dict_size = 32768 if (prime and n_chunks > 1) else 0
    if dict_size and shrink:
        room = DK.MAX_BUF - chunk_size - DK.PAD
        if 8192 <= room < dict_size:
            dict_size = room & ~7
    return dict_size


def chunk_buffers(data: bytes, chunk_size: int, dict_size: int):
    """The chunk buffers of `data`: uint8 [n_chunks, dict + chunk + PAD],
    chunk k's bytes at offset dict_size after up to dict_size bytes of
    the data before it. Returns (padded, n_valid, valid_from, data_len),
    the last three int32 [n_chunks]; [valid_from, n_valid) is real data."""
    n = len(data)
    n_chunks = max(1, -(-n // chunk_size))
    padded = np.zeros((n_chunks, dict_size + chunk_size + DK.PAD), np.uint8)
    flat = np.frombuffer(data, np.uint8)
    valid_from = np.zeros(n_chunks, np.int32)
    for k in range(n_chunks):
        seg = flat[k * chunk_size : (k + 1) * chunk_size]
        padded[k, dict_size : dict_size + seg.shape[0]] = seg
        dlen = min(dict_size, k * chunk_size)
        if dlen:
            padded[k, dict_size - dlen : dict_size] = flat[
                k * chunk_size - dlen : k * chunk_size
            ]
        valid_from[k] = dict_size - dlen
    data_len = np.array(
        [min(chunk_size, max(0, n - k * chunk_size)) for k in range(n_chunks)], np.int32
    )
    n_valid = (data_len + dict_size).astype(np.int32)
    return padded, n_valid, valid_from, data_len


def batch_spans(n_chunks: int, bulk: bool = True, width: int = 1) -> list[tuple[int, int]]:
    """(first chunk, size) of each batch: with `bulk` (the kernel engine
    without a mesh) super-batches for the bulk, then tail batches; without
    (the XLA engine, or a mesh) tail batches only. Under a mesh of `width`
    ranks a tail batch is max(W, min(16, ceil(16 / W) * W)) chunks, as the
    reference batches a mesh, and the caller pads each batch to a multiple
    of W. PyTorch has no per-shape compile, so the last batch is not padded
    to the batch size."""
    tail = max(width, min(TAIL_BATCH, -(-TAIL_BATCH // width) * width))
    bulk = (n_chunks // SUPER_BATCH) * SUPER_BATCH if bulk else 0
    return [(i, SUPER_BATCH) for i in range(0, bulk, SUPER_BATCH)] + [
        (i, min(tail, n_chunks - i)) for i in range(bulk, n_chunks, tail)
    ]


def _shard_batch(arrays, b0: int, bsz: int, lay, dict_size: int):
    """The rank's rows of the batch [b0, b0 + bsz) of (padded, n_valid,
    valid_from, finals), the batch padded to a multiple of the mesh's
    width with empty rows (n_valid = valid_from = dict_size, finals 0).
    Returns the four arrays and the global index of the rank's first
    row."""
    padded, n_valid, valid_from, finals = arrays
    rows = M.rows_of(-(-bsz // lay.width) * lay.width, lay)
    lo, hi = b0 + rows.start, b0 + rows.stop
    real = max(0, min(hi, b0 + bsz) - lo)
    pad = (hi - lo) - real
    out = [a[lo : lo + real] for a in arrays]
    if pad:
        fill = (np.zeros((pad, padded.shape[1]), np.uint8), np.full(pad, dict_size, np.int32),
                np.full(pad, dict_size, np.int32), np.zeros(pad, np.int32))
        out = [np.concatenate([a, f]) for a, f in zip(out, fill)]
    return out, lo


def _gather_fields(fields: dict, lay, n_real: int) -> dict:
    """One all_gather of a batch's per-chunk results: every field, as int32
    columns, rides one [rows, F] buffer; returns the fields of the whole
    batch in chunk order, the padding rows dropped."""
    b = next(iter(fields.values())).shape[0]
    cols = {k: v.reshape(b, -1).to(torch.int32) for k, v in fields.items()}
    flat = M.gather_rows(torch.cat(list(cols.values()), dim=1), lay)[:n_real]
    out, pos = {}, 0
    for k, v in cols.items():
        w = v.shape[1]
        out[k] = flat[:, pos : pos + w].reshape(n_real, *fields[k].shape[1:])
        pos += w
    return out


def _gather_full_rows(need, full_rows, lay) -> dict:
    """The full words rows of the chunks in `need` (the same list on every
    rank) from the ranks that hold them: a second all_gather, in which each
    rank fills the rows it owns and leaves the others zero."""
    width = full_rows[0][1].shape[1]
    buf = torch.zeros((len(need), width), dtype=torch.int32, device=lay.device)
    for i, k in enumerate(need):
        for g0, full in full_rows:
            if g0 <= k < g0 + full.shape[0]:
                buf[i] = full[k - g0]
    # every row is nonzero on its owner alone, so the sum over the ranks is
    # the owner's row
    got = M.gather_rows(buf[None], lay).sum(dim=0, dtype=torch.int32)
    host = got.cpu().numpy().view(np.uint32)
    return {k: host[i] for i, k in enumerate(need)}


def make_sharded_encode_step(mesh, *, chunk_size: int, dict_size: int = 0, dynamic: bool = True,
                             gather: bool = True, kernel_scan: bool = False, kernel_cfg=None,
                             **knobs):
    """The sharded encode step: every rank encodes its shard of a chunk
    batch, then all_gathers the bit sizes (every rank then has the global
    byte offsets, their exclusive prefix sum) and the packed words.

    Returns fn(chunks, n_valid, finals, valid_from), each argument the
    rank's rows (uint8 [b, dict + chunk + PAD] and int [b], on any device;
    they move to the rank's device), that returns (words [B, W] int32,
    bits [B], offsets [B], ll_lens, d_lens): the first three gathered in
    chunk order on every rank, the lengths the rank's own rows. With
    `kernel_scan` the kernel engine encodes (its matcher from
    `_resolve_kernel_variant(kernel_cfg)`), else the XLA engine's
    `encode_chunk_dynamic` (with `dict_size` as its start) or, without
    `dynamic`, `encode_chunk_static` with zero [b, 1] lengths. `knobs`
    are the XLA engine's (chain_depth, max_words, lazy).

    gather=False is the variant with no collective: every output stays the
    rank's own and the offsets are zero."""
    lay = M.layout(mesh)
    kcfg = kernel_cfg or (8, 16, 128, 128)
    variant, w_g = _resolve_kernel_variant(kernel_cfg) if kernel_scan else (None, None)

    def step(chunks, n_valid, finals, valid_from):
        chunks, n_valid, finals, valid_from = (
            torch.as_tensor(a).to(lay.device) for a in (chunks, n_valid, finals, valid_from))
        if kernel_scan:
            words, bits, ll, dl, _sb, _so = _encode_batch(
                chunks, n_valid, finals, valid_from, dict_size=dict_size, n_seeds=0,
                dynamic=True, kernel_scan=True, chain_depth=knobs.get("chain_depth", 12),
                max_words=knobs.get("max_words", 32), lazy=knobs.get("lazy", True),
                kernel_cfg=kcfg, variant=variant, w_g=w_g,
            )
        elif dynamic:
            words, bits, ll, dl = dynhuff.encode_chunk_dynamic(
                chunks, n_valid, start=dict_size, valid_from=valid_from, **knobs)
        else:
            words, bits = lz77.encode_chunk_static(
                chunks, n_valid, finals, start=dict_size, valid_from=valid_from, **knobs)
            ll = dl = torch.zeros((chunks.shape[0], 1), dtype=torch.int32, device=lay.device)
        if not gather:
            return words, bits, torch.zeros_like(bits), ll, dl
        all_bits = M.gather_rows(bits, lay)
        nbytes = (all_bits + 7) // 8
        offsets = (torch.cumsum(nbytes, 0) - nbytes).to(all_bits.dtype)
        return M.gather_rows(words, lay), all_bits, offsets, ll, dl

    return step


def _gzip_crc(data: bytes, chunk_size: int, device: torch.device) -> int:
    """The gzip trailer's crc32: one K7 launch on `device` (its plain
    version on the CPU) over the n // chunk_size full chunk rows, folded
    with crc32_combine, then the host crc32 of the tail. K7 takes any row length,
    so it also serves the rows the reference's `_crc_batch_best` hands to
    its XLA crc32 when they do not tile onto its TPU kernel."""
    n = len(data)
    nfull = n // chunk_size
    crc = 0
    if nfull:
        full = np.frombuffer(data, np.uint8, count=nfull * chunk_size).reshape(nfull, chunk_size)
        with STAGES.stage("crc32", device):
            crcs = checksum.crc32_batch(torch.from_numpy(full.copy()).to(device))
        for c in crcs.cpu().numpy():
            crc = checksum.crc32_combine(crc, int(c), chunk_size)
    return checksum.crc32(data[nfull * chunk_size :], crc)


def compress_parallel(
    data: bytes,
    level: int = 6,
    *,
    window_bits: int = 15,
    chunk_size: int | None = None,
    mesh=None,
    return_index: bool = False,
    prime_dict: bool = True,
    strategy=None,
    device=None,
):
    """Compress `data` into one valid zlib/gzip/raw stream, chunk-parallel
    on one CUDA device (`device=None`; it raises when there is none), or
    through the kernels' plain PyTorch versions and the torch stages on
    the CPU with `device="cpu"`.

    The engine is chosen as the reference chooses it:
      * the kernel engine when ZRS_TPU_KERNEL=1, the level is 3-9 and
        dict + chunk + PAD fits the kernel's 65024 bytes: 32 KiB chunks
        (the default), each primed with up to ~31 KiB of the preceding
        data as dictionary, batches of 128 chunks (16 for the tail), and
        the matcher the reference picks: the hop route (K2) at levels 3-7,
        the chain route (K8) at levels 8-9, the tab route (K10) where the
        hop fields do not fit. ZRS_TPU_CHAIN, ZRS_TPU_WG, ZRS_TPU_HOPSCAN,
        ZRS_TPU_TABSCAN and ZRS_TPU_HOP_IL keep their meanings
        (ZRS_TPU_HOP_IL=2 runs the hop route's chase as K12, the
        interleaved chase, in place of K2; the stream is the same);
      * the XLA engine in every other case: 128 KiB chunks by default,
        primed with 32 KiB at levels 2-9, batches of 16 chunks, a dynamic
        block a chunk at levels 3-9 and a static one at levels up to 2
        (levels -1 and 0 included, as in the reference: no stored level).
    A non-default `strategy` (Filtered, HuffmanOnly, Rle, Fixed) runs the
    host deflate engine, `models.deflate.compress`, on one stream with no
    chunk parallelism, as the reference routes it; with return_index it
    raises ValueError.

    With `mesh` (a 1-D torch.distributed DeviceMesh whose dim is named
    "chunks"), every rank of the mesh makes the same call: the chunks are
    sharded over the ranks in batches of max(W, min(16, ceil(16 / W) * W))
    chunks (no super-batches), each batch padded to a multiple of W with
    empty rows, each rank encodes its contiguous rows on its device
    (`cuda:<local rank>` under a "cuda" mesh, the CPU under a "cpu" one;
    a contradicting `device=` raises ValueError), and one all_gather a
    batch brings every per-chunk result to every rank in chunk order. Every
    rank returns the same stream (and index), equal to the unsharded one.

    With return_index=True, also returns the ChunkIndex of (body_offset,
    body_len, out_len) per chunk, with 128 decode seeds per dynamic coded
    chunk (a static stream's index carries none); indexed streams are not
    dictionary-primed, so every chunk decodes on its own.
    """
    if strategy is not None and strategy != Strategy.Default:
        if return_index:
            raise ValueError(
                "indexed parallel streams require the default strategy "
                "(device-path limitation; see docstring)"
            )
        return host_deflate.compress(
            data, DeflateConfig(level=level, window_bits=window_bits, strategy=strategy)
        )
    lay = M.layout(mesh, device) if mesh is not None else None
    kernel_env = os.environ.get("ZRS_TPU_KERNEL") == "1"
    dev = lay.device if lay is not None else _device.resolve_device(device)
    if chunk_size is None:
        chunk_size = DEFAULT_CHUNK if kernel_env else XLA_CHUNK
    wrap, wbits = decode_window_bits_deflate(window_bits)
    n = len(data)
    n_chunks = max(1, -(-n // chunk_size))
    # indexed streams stay independently decodable, so priming is off
    # with return_index
    dict_size = priming_dict_size(
        n_chunks, chunk_size, prime_dict and not return_index and level >= 2,
        shrink=kernel_env,
    )
    padded, n_valid, valid_from, data_len = chunk_buffers(data, chunk_size, dict_size)
    finals = np.zeros(n_chunks, np.int32)
    finals[-1] = 1
    knobs = _level_knobs(level)
    dynamic = level >= 3
    kernel_scan = kernel_env and dynamic and dict_size + chunk_size + lz77.PAD <= DK.MAX_BUF
    variant, w_g = (_resolve_kernel_variant(knobs["kernel_cfg"]) if kernel_scan
                    else (None, None))
    n_seeds = SEEDS_PER_CHUNK if (return_index and dynamic) else 0

    cw = chunk_size // 4 + 80  # compressed-size bound fetched per chunk
    parts = collections.defaultdict(list)
    full_rows = []  # (global index of the first row, the retained words)
    spans = (batch_spans(n_chunks, bulk=kernel_scan) if lay is None
             else batch_spans(n_chunks, bulk=False, width=lay.width))
    for b0, bsz in spans:
        if lay is None:
            rows, g0 = [a[b0 : b0 + bsz] for a in (padded, n_valid, valid_from, finals)], b0
        else:
            rows, g0 = _shard_batch((padded, n_valid, valid_from, finals), b0, bsz, lay,
                                    dict_size)
        dc, dn, dv, df = (torch.from_numpy(a).to(dev) for a in rows)
        words, bits, ll_lens, d_lens, sbit, sout = _encode_batch(
            dc, dn, df, dv, dict_size=dict_size, n_seeds=n_seeds, dynamic=dynamic,
            kernel_scan=kernel_scan, variant=variant, w_g=w_g, **knobs,
        )
        with STAGES.stage("adler32", dev):
            adlers = checksum.adler32_batch(
                dc[:, dict_size : dict_size + chunk_size], dn - dict_size
            )
        # fetch only a compressed-size bound per chunk; a chunk whose
        # payload exceeds it (incompressible data, stored anyway) reads
        # its full row from the retained device array
        if words.shape[1] > cw:
            full_rows.append((g0, words))
            words = words[:, :cw]
        fields = dict(words=words, bits=bits, adler=adlers.to(torch.int32))
        if dynamic:
            fields.update(ll=ll_lens, d=d_lens)
        if n_seeds:
            fields.update(sbit=sbit, sout=sout)
        if lay is not None:
            with STAGES.stage("gather", dev):
                fields = _gather_fields(fields, lay, bsz)
        for name, value in fields.items():
            parts[name].append(value)

    # before host_assembly, so that its clock holds no K7 time
    crc = _gzip_crc(data, chunk_size, dev) if wrap == Wrap.Gzip else None
    if STAGES.enabled and dev.type == "cuda":
        torch.cuda.synchronize(dev)  # keep device time out of the host stage
    with STAGES.host("host_assembly"):
        # one device -> host transfer of every result
        names = list(parts)
        cat = {k: torch.cat(parts[k]).to(torch.int32) for k in names}
        flat_dev = torch.cat([cat[k].reshape(-1) for k in names])
        flat_host = flat_dev.cpu().numpy()
        host, pos = {}, 0
        for k in names:
            sz = cat[k].numel()
            host[k] = flat_host[pos : pos + sz].reshape(cat[k].shape)
            pos += sz
        words_np = host["words"].view(np.uint32)
        bits_np = host["bits"]
        adlers_np = host["adler"].astype(np.int64) & 0xFFFFFFFF

        def need_bytes(k):
            # a static chunk is a whole block; a body takes one byte of slack
            return (int(bits_np[k]) + 7) // 8 + (1 if dynamic else 0)

        # under a mesh a chunk's full row lives on one rank: every rank
        # knows the bits, so all agree on the rows to gather
        fetched = {}
        if lay is not None and full_rows:
            need = [k for k in range(n_chunks) if need_bytes(k) > words_np.shape[1] * 4]
            if need:
                fetched = _gather_full_rows(need, full_rows, lay)

        def row_words(k):
            if need_bytes(k) <= words_np.shape[1] * 4:
                return words_np[k]
            if k in fetched:
                return fetched[k]
            for g0, full in full_rows:
                if g0 <= k < g0 + full.shape[0]:
                    return full[k - g0].cpu().numpy().view(np.uint32)
            return words_np[k]

        payloads = []
        for k in range(n_chunks):
            if not dynamic:  # a complete static block: no header to splice
                total_bits = int(bits_np[k])
                nbytes = (total_bits + 7) // 8
                row = row_words(k)
                payloads.append((row.view(np.uint8)[:nbytes].tobytes(), total_bits))
                continue
            hdr, hb = _dyn_header(host["ll"][k], host["d"][k], final=k == n_chunks - 1)
            body_bits = int(bits_np[k])
            row = row_words(k)
            payload = _splice_bits(hdr, hb, row.view(np.uint8), body_bits)
            payloads.append((payload, hb + body_bits))

        chunks_raw = [
            data[k * chunk_size : k * chunk_size + int(data_len[k])] for k in range(n_chunks)
        ]
        body, index, stored_flags = _assemble(payloads, chunks_raw, n_chunks)

        out = bytearray()
        if wrap == Wrap.Zlib:
            cinfo = wbits - 8
            cmf = (cinfo << 4) | 8
            flevel = 0 if level < 2 else 1 if level < 6 else 2 if level == 6 else 3
            flg = flevel << 6
            flg |= (31 - (cmf * 256 + flg) % 31) % 31
            out.extend(bytes([cmf, flg]))
        elif wrap == Wrap.Gzip:
            out.extend(bytes([0x1F, 0x8B, 8, 0, 0, 0, 0, 0, 2 if level == 9 else 0, 3]))
        out.extend(body)
        if wrap == Wrap.Zlib:
            a = 1
            for k in range(n_chunks):
                a = checksum.adler32_combine(a, int(adlers_np[k]), int(data_len[k]))
            out.extend(a.to_bytes(4, "big"))
        elif wrap == Wrap.Gzip:
            out.extend(crc.to_bytes(4, "little"))
            out.extend((n & 0xFFFFFFFF).to_bytes(4, "little"))
    if return_index:
        hdr_len = len(out) - len(body) - (
            4 if wrap == Wrap.Zlib else 8 if wrap == Wrap.Gzip else 0
        )
        abs_index = ChunkIndex(
            (hdr_len + off, ln, out_len) for off, ln, out_len in index
        )
        if n_seeds:
            # seeds for coded chunks only; stored chunks decode by memcpy
            abs_index.seeds = [
                None if stored_flags[k]
                else (host["sbit"][k].tolist(), host["sout"][k].tolist())
                for k in range(n_chunks)
            ]
        return bytes(out), abs_index
    return bytes(out)


def _whole_stream_host(data: bytes) -> bytes:
    """A whole zlib or gzip stream (sniffed, window_bits=47) on the host."""
    d = zlib.decompressobj(47)
    try:
        out = d.decompress(data) + d.flush()
    except zlib.error as e:
        raise ValueError(str(e)) from e
    if not d.eof:
        raise ValueError("incomplete or truncated stream")
    return out


def _chunks_host_exact(data: bytes, index) -> bytes:
    """The host exact step of engine="host": stdlib raw inflate of each
    chunk body, held to the index's out_len."""
    parts = []
    for k, (off, ln, out_len) in enumerate(index):
        d = zlib.decompressobj(-15)
        try:
            part = d.decompress(data[off : off + ln], out_len + 1)
        except zlib.error as e:
            raise ValueError(f"chunk {k}: {e}") from e
        if len(part) != out_len:
            raise ValueError(f"chunk {k}: decoded {len(part)} bytes, the index says {out_len}")
        parts.append(part)
    return b"".join(parts)


def container_ok(data: bytes, result: bytes) -> bool:
    """The container's checksum over `result` (zlib or gzip, sniffed from
    `data`; a raw stream has none): the last oracle over every engine."""
    if data[:2] == b"\x1f\x8b":
        return zlib.crc32(result) == int.from_bytes(data[-8:-4], "little")
    if len(data) >= 2 and (data[0] & 0x0F) == 8 and ((data[0] << 8) | data[1]) % 31 == 0:
        return zlib.adler32(result) == int.from_bytes(data[-4:], "big")
    return True


def decompress_parallel(data: bytes, index, engine: str = "device", *, device=None) -> bytes:
    """Decode a stream made by compress_parallel with its chunk index:
    every chunk body decodes on its own, the outputs concatenate in order
    and the container checksum is verified (ValueError("incorrect data
    check") when it fails).

    engine="device" (the default) runs on `device`: the GPU when None,
    raising RuntimeError when there is none; "cpu" runs the kernels' plain
    versions and the torch engines on the CPU. The engines run in the
    reference's order (its engine="tpu"):
      * the vector engine (K4, K5; the single-plane K11a, K11b under
        ZRS_VECTOR_TWOPLANE=0), when every chunk has seeds and
        ZRS_TPU_VECTOR is not "0";
      * the inflate kernel K6 (`swarm_inflate.decode_chunks_kernel`), when
        there is no result yet and ZRS_TPU_KERNEL is not "0": an index
        with a stored chunk (no seeds), ZRS_TPU_VECTOR=0, or a data fault
        of the vector engine;
      * the seeded swarm engine (`swarm_inflate.decode_chunks_seeded`),
        when there is still no result and every chunk has seeds; under
        ZRS_TPU_KERNEL=0 it is the only engine after the vector engine;
      * the region decode (`inflate.decompress_chunks`: K6, then the
        lockstep engine for the regions K6 refuses), when no engine gave a
        result or a result failed the container checksum.
    A data fault (a VectorDataFault, a KernelDataFault or a SwarmDataFault:
    a parse failure, bad or short walkers or lanes, drift, a coverage gap)
    is counted in fallback_stats() as `vector_decode:ValueError`,
    `kernel_decode:ValueError` or `swarm_decode:ValueError` and passes the
    decode on; a device result whose container checksum fails is counted
    as `device_checksum:ValueError`; a region K6 refuses is counted as
    `region_kernel:ValueError`. Kernel build, launch and argument errors
    are not caught.
    engine="tpu" is "device" under the reference's name. engine="auto" is
    the reference's "auto" without its native engine: the region decode
    alone. engine="native" is the reference's native engine on `device`:
    `native.inflate_parallel` (K6 over the indexed chunks, one launch),
    whose ValueError (a chunk that fails to decode, chunks that end short)
    propagates as the reference's does. engine="host" runs the host exact
    step (stdlib raw inflate per chunk) only. index=None decodes the whole
    stream on the host.
    """
    if engine not in ("device", "tpu", "auto", "host", "native"):
        raise ValueError(f"unknown engine {engine!r}")
    if index is None:
        return _whole_stream_host(data)
    if engine in ("host", "native"):
        if engine == "host":
            result = _chunks_host_exact(data, index)
        else:
            from .. import native

            result = native.inflate_parallel(data, index, device=device)
        if not container_ok(data, result):
            raise ValueError("incorrect data check")
        return result

    from . import inflate as pinf  # it imports this module

    dev = _device.resolve_device(device)
    bodies = [data[off : off + ln] for off, ln, _ in index]
    out_sizes = [out_len for _, _, out_len in index]
    if engine in ("device", "tpu"):
        seeds = getattr(index, "seeds", None)
        seeded = seeds is not None and all(s is not None for s in seeds)
        result = None
        if seeded and os.environ.get("ZRS_TPU_VECTOR") != "0":
            try:
                result = b"".join(
                    vector_inflate.decode_chunks_vector(bodies, out_sizes, seeds, device=dev)
                )
            except vector_inflate.VectorDataFault as e:
                # counted under the reference's key; a wrapper's argument
                # error (a plain ValueError) is not a data fault and propagates
                _note_fallback("vector_decode", ValueError(e))
        if result is None and os.environ.get("ZRS_TPU_KERNEL") != "0":
            try:
                result = b"".join(swarm_inflate.decode_chunks_kernel(bodies, out_sizes, device=dev))
            except swarm_inflate.KernelDataFault as e:
                _note_fallback("kernel_decode", ValueError(e))
        if result is None and seeded:
            try:
                result = b"".join(
                    swarm_inflate.decode_chunks_seeded(bodies, out_sizes, seeds, device=dev)
                )
            except swarm_inflate.SwarmDataFault as e:
                _note_fallback("swarm_decode", ValueError(e))
        if result is not None:
            with STAGES.host("container_check"):
                if container_ok(data, result):
                    return result
            # wrong bytes without a flagged fault: the checksum discards them
            _note_fallback("device_checksum", ValueError("device checksum mismatch"))
    with STAGES.host("region_decode"):
        result = b"".join(pinf.decompress_chunks(bodies, out_sizes, device=dev))
    with STAGES.host("container_check"):
        if not container_ok(data, result):
            raise ValueError("incorrect data check")
    return result
