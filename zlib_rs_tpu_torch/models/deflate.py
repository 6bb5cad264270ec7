"""Deflate: streaming DEFLATE/zlib/gzip compressor (host reference engine).

A copy of zlib_rs_tpu/models/deflate.py: `compress_parallel` routes a
non-default strategy here, as the reference does; `BitWriter` and
`_scan_code_lengths` also build the device engines' block headers.

This is the framework's behavioral core for compression — the counterpart of
the reference's deflate driver + block algorithms + tree layer
(zlib-rs/src/deflate.rs:247-3354, deflate/algorithm/*.rs): all levels 0-9,
all strategies (Default/Filtered/HuffmanOnly/Rle/Fixed), zlib/gzip/raw
framing with full gzip header control, streaming flush semantics
(None/Partial/Sync/Full/Finish/Block), dictionary priming, mid-stream
parameter changes, bit-level priming, pending introspection, bound formulas,
and mid-stream copy.

Architecture notes:
  * The engine is **bit-exact with the live zlib oracle** at levels 1-9 for
    every strategy/mem_level/wrapper and any streaming chunking + flush
    pattern (tests/test_bitexact.py) — the same differential property the
    reference pins against zlib-ng (end_to_end.rs:42). That fixes: the
    3-byte rolling hash (the reference's RollHashCalc family), exact
    longest_match walk order/budget/clamps including the zero-padded window
    compare, greedy (levels 1-3) and lazy (4-9) loops with zlib's insertion
    policy, the NIL==0 window-position quirk (stream start and FULL_FLUSH
    resets), sym-buffer flush at lit_bufsize-1, and the zlib-exact tree
    layer in models/trees.py.
  * The code is organized around an append-only input buffer with absolute
    positions and vectorized hash precomputation — the same layout the
    chunk-parallel matcher uses (ops/lz77.py), so the two paths share
    decision semantics; window slides become pure rebases (_maybe_prune)
    that provably never change decisions.

The engine produces output into an internal pending buffer; z_stream
avail_in/avail_out pumping lives in models/stream.py (mirroring the
reference's Pending layer, deflate/pending.rs).
"""

from __future__ import annotations

import copy as _copy

import numpy as np

from ..config import (
    CONFIGURATION_TABLE,
    DataType,
    DeflateConfig,
    DeflateFlush,
    GzHeader,
    MAX_MATCH,
    MIN_MATCH,
    ReturnCode,
    Strategy,
    Wrap,
    decode_window_bits_deflate,
)
from ..ops import checksum
from ..ops import huffman as H
from . import trees

MIN_LOOKAHEAD = MAX_MATCH + MIN_MATCH + 1  # 262, zlib's safety margin
MAX_STORED = 65535
TOO_FAR = 4096


def _hash_all(buf: np.ndarray, hash_bits: int) -> np.ndarray:
    """Vectorized 3-byte rolling hash of every position (0..n-3).

    This is the classic zlib hash (the same family as the reference's
    RollHashCalc, deflate/hash_calc.rs:84-135): h advances by
    ((h << shift) ^ next_byte) & mask over a 3-byte window, with
    shift = ceil(hash_bits / 3) so all three bytes contribute. Expanded
    per-position: h_i = ((b_i << 2s) ^ (b_{i+1} << s) ^ b_{i+2}) & mask
    (the intermediate masking in the rolling form drops only bits the
    final mask drops too). Byte-exactness with the zlib oracle requires
    this hash, the reference's Knuth-multiplicative StandardHashCalc is
    the zlib-ng variant.
    """
    n = buf.shape[0]
    if n < 3:
        return np.zeros(0, np.int64)
    shift = (hash_bits + MIN_MATCH - 1) // MIN_MATCH
    mask = (1 << hash_bits) - 1
    w = (
        (buf[: n - 2].astype(np.int64) << (2 * shift))
        ^ (buf[1 : n - 1].astype(np.int64) << shift)
        ^ buf[2:n].astype(np.int64)
    )
    return w & mask


class BitWriter:
    """LSB-first bit packer into a byte FIFO (counterpart of deflate.rs:901+)."""

    def __init__(self, out: bytearray):
        self.out = out
        self.bitbuf = 0
        self.bitcnt = 0

    def send_bits(self, value: int, nbits: int) -> None:
        self.bitbuf |= (int(value) & ((1 << nbits) - 1)) << self.bitcnt
        self.bitcnt += nbits
        while self.bitcnt >= 8:
            self.out.append(self.bitbuf & 0xFF)
            self.bitbuf >>= 8
            self.bitcnt -= 8

    def align(self) -> None:
        """Pad with zero bits to the next byte boundary (emit_align)."""
        if self.bitcnt:
            self.out.append(self.bitbuf & 0xFF)
        self.bitbuf = 0
        self.bitcnt = 0

    def flush_partial(self) -> None:
        """zlib bi_flush: push out whole bytes, keep the sub-byte tail."""
        while self.bitcnt >= 8:
            self.out.append(self.bitbuf & 0xFF)
            self.bitbuf >>= 8
            self.bitcnt -= 8


def _scan_code_lengths(lengths: np.ndarray):
    """RLE a tree's code-length sequence into bl-alphabet symbols.

    Returns list of (symbol, extra_value, extra_bits). Semantics per RFC 1951
    3.2.7 / the reference's scan_tree (deflate.rs:2152): runs of the previous
    length use 16 (3-6 copies), runs of zero use 17 (3-10) / 18 (11-138).
    Runs do not cross tree boundaries (each tree scanned separately).
    """
    syms = []
    n = len(lengths)
    prevlen = -1
    i = 0
    while i < n:
        curlen = int(lengths[i])
        run = 1
        while i + run < n and int(lengths[i + run]) == curlen:
            run += 1
        count = run
        if curlen == 0:
            while count >= 11:
                take = min(count, 138)
                syms.append((18, take - 11, 7))
                count -= take
            if count >= 3:
                syms.append((17, count - 3, 3))
                count = 0
            for _ in range(count):
                syms.append((0, 0, 0))
        else:
            if prevlen != curlen:
                syms.append((curlen, 0, 0))
                count -= 1
            while count >= 3:
                take = min(count, 6)
                syms.append((16, take - 3, 2))
                count -= take
            for _ in range(count):
                syms.append((curlen, 0, 0))
        prevlen = curlen
        i += run
    return syms


def _detect_data_type(ll_freq: np.ndarray) -> DataType:
    """Binary/text sniff on literal frequencies (reference: deflate.rs:1505)."""
    # Black-listed control chars: 0..6, 14..25, 28..31 (zlib's block_mask).
    black = list(range(0, 7)) + list(range(14, 26)) + list(range(28, 32))
    if any(ll_freq[c] for c in black):
        return DataType.Binary
    if ll_freq[9] or ll_freq[10] or ll_freq[13] or np.any(ll_freq[32:256]):
        return DataType.Text
    return DataType.Binary


class Deflator:
    """Resumable deflate engine over explicit (input, flush) calls.

    Counterpart of the reference's DeflateStream + State (deflate.rs:37-136,
    1225-1358). Output accumulates in `self.pending`; callers drain it.
    """

    def __init__(self, config: DeflateConfig = DeflateConfig()):
        rc = config.validate()
        if rc != ReturnCode.Ok:
            raise ValueError(f"invalid deflate config: {config}")
        wrap, wbits = decode_window_bits_deflate(config.window_bits)
        if wbits == 8:
            wbits = 9  # zlib quirk: 8 is bumped to 9 (deflate.rs:294-300)
        self.config = config
        self.wrap = wrap
        self.wbits = wbits
        self.level = config.normalized_level()
        self.strategy = config.strategy
        self.mem_level = config.mem_level
        self.gzhead: GzHeader | None = None
        self._apply_level_params()
        self.reset()

    # -- lifecycle ---------------------------------------------------------

    def _apply_level_params(self) -> None:
        cfg = CONFIGURATION_TABLE[self.level]
        self.good_length = cfg.good_length
        self.max_lazy = cfg.max_lazy
        self.nice_length = cfg.nice_length
        self.max_chain = cfg.max_chain
        self.func = cfg.func
        # lit_bufsize symbols per block (reference: deflate.rs:316); the
        # block flushes at lit_bufsize - 1 symbols (zlib's sym_end)
        self.lit_bufsize = 1 << (self.mem_level + 6)
        # hash table geometry follows mem_level (zlib: hash_bits = memLevel+7)
        self.hash_bits = self.mem_level + 7
        self.hash_size = 1 << self.hash_bits

    def reset(self) -> None:
        """deflateReset (reference: deflate.rs:739)."""
        self.wsize = 1 << self.wbits
        self.wmask = self.wsize - 1
        self.buf = bytearray()  # dictionary + all input seen
        self._hash_store = np.zeros(4096, np.int64)  # grows with input
        self.hashes = self._hash_store[:0]  # valid prefix view
        self.head = np.full(self.hash_size, -1, np.int64)
        self.prev = np.full(self.wsize, -1, np.int64)
        self.strstart = 0  # next position to process (absolute)
        self.inserted = 0  # positions hashed so far (absolute)
        self.block_start = 0  # first byte of the current block (absolute)
        # zlib window-slide accounting (fill_window, deflate.rs:1768-1786):
        # the REAL zlib slides its 2*wsize window buffer at the first
        # scanned position whose window-relative offset reaches
        # 2*wsize - MIN_LOOKAHEAD, and a block that began before the last
        # slide CANNOT be emitted as stored (zng_tr_flush_block's
        # buf == NULL case) even when stored is cheaper. We keep the whole
        # buffer, so we track the slides virtually: _slid = absolute
        # position of zlib's window base (slides * wsize), _abs_drop =
        # bytes pruned off our buffer (to keep positions absolute).
        self._slid = 0
        self._abs_drop = 0
        self._vthr = 2 * self.wsize - MIN_LOOKAHEAD
        self.base = 0  # output starts here (bytes before are dictionary)
        self.sym_dist: list[int] = []
        self.sym_lit: list[int] = []
        self.pending = bytearray()
        self.bw = BitWriter(self.pending)
        self.header_emitted = False
        self.finished = False
        self.adler = 1
        self.crc = 0
        self.total_in = 0
        self.total_out = 0
        self.data_type = DataType.Unknown
        # Absolute position that plays the role of zlib's window offset 0:
        # entries at or before it can never be match candidates (head/prev
        # NIL is 0 in zlib, so window position 0 is invisible). A FULL_FLUSH
        # resets zlib's window, moving this anchor to the flush point.
        self._nil_pos = 0
        # lazy matcher carry state, mirroring zlib's State fields exactly
        self._match_available = False
        self._match_length = MIN_MATCH - 1  # current position's match
        self._match_start = 0  # absolute position of that match's source
        self._prev_length = MIN_MATCH - 1  # rolled at each slow-loop step
        self._prev_start = 0
        self._last_flush = -2  # zlib deflateResetKeep: rank below everything
        self._block_types: list[str] = []  # introspection: emitted block kinds
        self._n_literals = 0  # observability counters (SURVEY.md section 5:
        self._n_matches = 0   # "counters as returned arrays — jit-friendly")
        self._match_bytes = 0

    def copy(self) -> "Deflator":
        """deflateCopy (reference: deflate.rs:602): deep mid-stream clone."""
        return _copy.deepcopy(self)

    # -- configuration surface ---------------------------------------------

    def set_header(self, head: GzHeader) -> ReturnCode:
        """deflateSetHeader (reference: deflate.rs:3126)."""
        if self.wrap != Wrap.Gzip or self.header_emitted:
            return ReturnCode.StreamError
        self.gzhead = head
        return ReturnCode.Ok

    def set_dictionary(self, dictionary: bytes) -> ReturnCode:
        """deflateSetDictionary (reference: deflate.rs:494-559).

        Only the last wsize bytes are retained. Must be called before any
        input is consumed (zlib additionally allows raw-mode mid-stream use).
        """
        if self.header_emitted and self.wrap != Wrap.Raw:
            return ReturnCode.StreamError
        if self.wrap == Wrap.Gzip:
            return ReturnCode.StreamError
        d = dictionary[-self.wsize :]
        if self.wrap == Wrap.Zlib:
            self.adler = checksum.adler32(dictionary, self.adler)
        self._append_input(d)
        self.strstart = len(self.buf)
        self.block_start = self.strstart
        self.base = self.strstart
        self._insert_hashes_upto(self.strstart)
        return ReturnCode.Ok

    def get_dictionary(self) -> bytes:
        """deflateGetDictionary (reference: deflate.rs:3273)."""
        lo = max(0, self.strstart - self.wsize)
        return bytes(self.buf[lo : self.strstart])

    def params(self, level: int, strategy: Strategy) -> ReturnCode:
        """deflateParams (reference: deflate.rs:436): mid-stream change.

        Flushes buffered symbols as a block under the old parameters first.
        """
        if level == -1:
            level = 6
        if not (0 <= level <= 9) or not (0 <= int(strategy) <= 4):
            return ReturnCode.StreamError
        if self.finished:
            return ReturnCode.StreamError
        if (level != self.level or strategy != self.strategy) and (
            self.sym_dist or self.strstart > self.block_start or len(self.buf) > self.strstart
        ):
            # zlib's deflateParams drains via Z_BLOCK: process all pending
            # input under the old parameters and flush the block
            self._compress_pending_input(final=True)
            self._resolve_deferred()
            if self.sym_dist or self.strstart > self.block_start:
                self._flush_block(last=False)
        self.level = level
        self.strategy = strategy
        self._apply_level_params()
        return ReturnCode.Ok

    def tune(self, good_length: int, max_lazy: int, nice_length: int, max_chain: int) -> ReturnCode:
        """deflateTune (reference: deflate.rs:811-825).

        The reference truncates each knob to u16 and accepts any value; we
        additionally reject values a u16 cannot represent (negative or
        > 65535) with StreamError instead of silently wrapping, since a
        negative chain budget would corrupt the matcher's loop bounds.
        """
        for v in (good_length, max_lazy, nice_length, max_chain):
            if not isinstance(v, int) or not (0 <= v <= 0xFFFF):
                return ReturnCode.StreamError
        self.good_length = good_length
        self.max_lazy = max_lazy
        self.nice_length = nice_length
        self.max_chain = max_chain
        return ReturnCode.Ok

    def prime(self, bits: int, value: int) -> ReturnCode:
        """deflatePrime (reference: deflate.rs:561): inject bits into output."""
        if bits < 0 or bits > 16:
            return ReturnCode.StreamError
        if not self.header_emitted:
            self._emit_header()
        self.bw.send_bits(value, bits)
        return ReturnCode.Ok

    def pending_info(self) -> tuple[int, int]:
        """deflatePending (reference: lib.rs:1618): (bytes, bits) not yet out."""
        return len(self.pending), self.bw.bitcnt

    def stats(self) -> dict:
        """Observability counters (the replacement for the
        reference's ZLIB_DEBUG trace/sent_bits counters, SURVEY.md section 5):
        blocks by type, symbol mix, match coverage."""
        from collections import Counter

        return {
            "blocks": dict(Counter(self._block_types)),
            "literals": self._n_literals,
            "matches": self._n_matches,
            "match_bytes": self._match_bytes,
            "total_in": self.total_in,
            "total_out": self.total_out,
            "data_type": self.data_type.name,
        }

    def bound(self, source_len: int) -> int:
        """deflateBound (reference: deflate.rs:3174-3268), wrap-aware.

        Our emitters guarantee: any block is at most stored-cost (the block
        chooser takes the min), stored blocks add 5 bytes per 65535, and
        flush seams add <= 11 bytes each; the zlib-ng style formula below
        covers this with margin.
        """
        complen = source_len + (source_len >> 12) + (source_len >> 14) + (source_len >> 25) + 13
        if self.wrap == Wrap.Raw:
            wraplen = 0
        elif self.wrap == Wrap.Zlib:
            wraplen = 6 + (4 if self.strstart > self.base or self.base > 0 else 0)
        else:  # gzip
            wraplen = 18
            if self.gzhead is not None:
                if self.gzhead.extra is not None:
                    wraplen += 2 + len(self.gzhead.extra)
                if self.gzhead.name is not None:
                    wraplen += len(self.gzhead.name) + 1
                if self.gzhead.comment is not None:
                    wraplen += len(self.gzhead.comment) + 1
                if self.gzhead.hcrc:
                    wraplen += 2
        return complen + wraplen

    # -- input management ---------------------------------------------------

    def _maybe_prune(self) -> None:
        """Bounded-memory sliding window (reference: fill_window's slide +
        slide_hash, deflate.rs:1757-1842, slide_hash.rs).

        Everything before min(block_start, strstart - wsize) can be
        discarded. The drop amount is a multiple of wsize so that
        `pos & wmask` indexing into `prev` stays consistent after rebasing
        absolute positions.
        """
        keep_from = min(self.block_start, max(0, self.strstart - self.wsize))
        drop = (keep_from // self.wsize) * self.wsize
        if drop < 8 * self.wsize:
            return
        del self.buf[:drop]
        nh = self.hashes.shape[0]
        remaining = max(0, nh - drop)
        if remaining:
            self._hash_store[:remaining] = self._hash_store[drop:nh]
        self.hashes = self._hash_store[:remaining]
        # slide_hash: rebase chain entries, invalidating anything dropped
        self.head = np.where(self.head >= drop, self.head - drop, -1)
        self.prev = np.where(self.prev >= drop, self.prev - drop, -1)
        self.strstart -= drop
        self.block_start -= drop
        self._abs_drop += drop
        self.inserted = max(0, self.inserted - drop)
        self.base = max(0, self.base - drop)
        # lazy-state positions live within the window of strstart
        self._match_start = max(0, self._match_start - drop)
        self._prev_start = max(0, self._prev_start - drop)
        self._nil_pos = max(0, self._nil_pos - drop)

    def _append_input(self, data: bytes) -> None:
        if not data:
            return
        self._maybe_prune()
        n0 = len(self.buf)
        self.buf.extend(data)
        n1 = len(self.buf)
        nh = max(0, n1 - 2)  # number of 3-byte-hashable positions
        if self._hash_store.shape[0] < nh:
            grown = np.zeros(max(2 * self._hash_store.shape[0], nh), np.int64)
            grown[: self.hashes.shape[0]] = self.hashes
            self._hash_store = grown
        # recompute only the tail (positions n0-2 .. n1-3 gain a full window)
        start = max(0, n0 - 2)
        seg = np.frombuffer(bytes(self.buf[start:n1]), np.uint8)
        hs = _hash_all(seg, self.hash_bits)
        self._hash_store[start : start + hs.shape[0]] = hs
        self.hashes = self._hash_store[:nh]

    def _insert_hashes_upto(self, limit: int) -> None:
        """Insert hash-chain entries for positions [inserted, limit)."""
        limit = min(limit, self.hashes.shape[0])
        if limit <= self.inserted:
            return
        pos = np.arange(self.inserted, limit, dtype=np.int64)
        hs = self.hashes[self.inserted : limit]
        # Serial order matters only within identical hash values; np.ufunc.at
        # style scatter with last-writer-wins per hash gives head; prev links
        # need the previous occurrence, built with a grouped pass.
        if pos.shape[0] > 256:
            order = np.argsort(hs, kind="stable")
            sh, sp = hs[order], pos[order]
            same = np.zeros(sp.shape[0], bool)
            same[1:] = sh[1:] == sh[:-1]
            # within-batch predecessor
            prev_in_batch = np.where(same, np.concatenate([[0], sp[:-1]]), -1)
            # first occurrence of each hash in batch links to old head
            first_idx = ~same
            prev_val = np.where(first_idx, self.head[sh], prev_in_batch)
            self.prev[sp & self.wmask] = prev_val
            # head gets the last occurrence per hash
            last = np.zeros(sp.shape[0], bool)
            last[:-1] = sh[:-1] != sh[1:]
            last[-1] = True
            self.head[sh[last]] = sp[last]
        else:
            for p, h in zip(pos.tolist(), hs.tolist()):
                self.prev[p & self.wmask] = self.head[h]
                self.head[h] = p
        self.inserted = limit

    # -- match finding -------------------------------------------------------

    def _match_len(self, pos: int, cur: int) -> int:
        """Common-prefix length of buf[pos:] vs buf[cur:], up to MAX_MATCH,
        treating bytes past the end of the buffer as zero.

        The zero extension reproduces zlib's windowed compare exactly: the
        window is zero-initialized past the valid data (fill_window's
        high_water padding), so near the stream tail a match can *appear*
        to extend into zeros, influencing which candidate wins even though
        the returned length is later clamped to the real lookahead.
        """
        n = len(self.buf)
        if pos + MAX_MATCH <= n:
            va = self.buf[cur : cur + MAX_MATCH]
            vb = self.buf[pos : pos + MAX_MATCH]
        else:
            va = bytes(self.buf[cur : cur + MAX_MATCH])
            vb = bytes(self.buf[pos : pos + MAX_MATCH])
            va += b"\0" * (MAX_MATCH - len(va))
            vb += b"\0" * (MAX_MATCH - len(vb))
        if va == vb:
            return MAX_MATCH
        x = int.from_bytes(va, "little") ^ int.from_bytes(vb, "little")
        return ((x & -x).bit_length() - 1) >> 3

    def _longest_match(self, pos: int, cur: int, prev_length: int) -> tuple[int, int]:
        """zlib's longest_match, decision-for-decision (the reference pins
        the same walk in deflate/longest_match.rs): start from candidate
        `cur` (the pre-insert head), chain budget quartered once the
        deferred length reaches good_length, nice cutoff clamped to the
        real lookahead, candidates beyond max(0, pos - MAX_DIST) rejected
        (which also encodes zlib's NIL==0 quirk: window position 0 can
        never match), closest-first walk where only strictly longer wins,
        and the returned length clamped to the lookahead."""
        n = len(self.buf)
        lookahead = n - pos
        chain = self.max_chain
        best_len = prev_length
        if prev_length >= self.good_length:
            chain >>= 2
        nice = self.nice_length
        if nice > lookahead:
            nice = lookahead
        limit = pos - (self.wsize - MIN_LOOKAHEAD)
        if limit < self._nil_pos:
            limit = self._nil_pos
        best_dist = 0
        prev = self.prev
        wmask = self.wmask
        while True:
            ml = self._match_len(pos, cur)
            if ml > best_len:
                best_len = ml
                best_dist = pos - cur
                if ml >= nice:
                    break
            cur = int(prev[cur & wmask])
            if cur <= limit:
                break
            chain -= 1
            if chain == 0:
                break
        if best_len <= lookahead:
            return best_len, best_dist
        return lookahead, best_dist

    # -- symbol emission -----------------------------------------------------

    def _tally_lit(self, byte: int) -> None:
        self.sym_dist.append(0)
        self.sym_lit.append(byte)
        self._n_literals += 1

    def _tally_match(self, length: int, dist: int) -> None:
        self.sym_dist.append(dist)
        self.sym_lit.append(length)
        self._n_matches += 1
        self._match_bytes += length

    def _sym_full(self) -> bool:
        # zlib flushes at lit_bufsize - 1 symbols (sym_end), leaving room
        # for exactly one trailing tally before the block is emitted
        return len(self.sym_dist) >= self.lit_bufsize - 1

    # -- block algorithms ----------------------------------------------------

    def _compress_pending_input(self, final: bool, finish: bool = False) -> None:
        """Run the level's matcher over unprocessed input.

        `final` means process everything (any flush); `finish` additionally
        marks stream end (level-0 stored blocks carry their own last flag).
        When not final, keeps MIN_LOOKAHEAD bytes unprocessed so decisions
        match zlib's regardless of input chunking.
        """
        n = len(self.buf)
        limit = n if final else max(self.strstart, n - MIN_LOOKAHEAD)
        if self.level == 0 or self.func == "stored":
            self._deflate_stored(final, finish)
            return
        if self.strategy == Strategy.HuffmanOnly:
            self._deflate_huff(limit)
            return
        if self.strategy == Strategy.Rle:
            self._deflate_rle(limit)
            return
        if self.func == "fast":
            self._deflate_fast(limit)
        else:  # slow
            self._deflate_slow(limit, final)

    def _deflate_stored(self, final: bool, finish: bool) -> None:
        """Level 0: direct stored blocks, zlib's ample-output schedule
        (reference: algorithm/stored.rs): full 64K-1 blocks while input
        remains; at stream end the block that consumes the remainder (which
        may be empty) carries the last flag. With constrained output buffers
        zlib splits differently — byte-exactness at level 0 is defined for
        the unbounded-output one-shot case.
        """
        n = len(self.buf)
        min_block = min(4 * self.lit_bufsize - 5, self.wsize)
        if finish:
            while True:
                take = min(n - self.strstart, MAX_STORED)
                last_blk = take == n - self.strstart
                self._emit_stored_block(
                    self.buf[self.strstart : self.strstart + take], last=last_blk
                )
                self.strstart += take
                self.block_start = self.strstart
                if last_blk:
                    break
        elif final:
            # non-FINISH flush: emit everything pending, not last
            while self.strstart < n:
                take = min(n - self.strstart, MAX_STORED)
                self._emit_stored_block(
                    self.buf[self.strstart : self.strstart + take], last=False
                )
                self.strstart += take
                self.block_start = self.strstart
        else:
            # streaming NO_FLUSH: emit once at least min_block is available
            while n - self.strstart >= min_block:
                take = min(n - self.strstart, MAX_STORED)
                self._emit_stored_block(
                    self.buf[self.strstart : self.strstart + take], last=False
                )
                self.strstart += take
                self.block_start = self.strstart
        self.inserted = max(self.inserted, min(self.strstart, self.hashes.shape[0]))

    def _deflate_huff(self, limit: int) -> None:
        """Strategy HuffmanOnly: literals only (reference: algorithm/huff.rs)."""
        while self.strstart < limit:
            if self.strstart + self._abs_drop - self._slid >= self._vthr:
                self._vslide(self.strstart, 1)  # huff fills at lookahead == 0
            self._tally_lit(self.buf[self.strstart])
            self.strstart += 1
            if self._sym_full():
                self._flush_block(last=False)
        self.inserted = max(self.inserted, min(self.strstart, self.hashes.shape[0]))

    def _deflate_rle(self, limit: int) -> None:
        """Strategy Rle: distance-1 runs only, zlib-exact (reference:
        algorithm/rle.rs): a run requires the previous byte repeated at
        least 3 times from the scan point; the scan extends over the
        zero-padded window up to MAX_MATCH, then clamps to the lookahead."""
        buf = self.buf
        n = len(buf)
        while self.strstart < limit:
            pos = self.strstart
            if pos + self._abs_drop - self._slid >= self._vthr:
                self._vslide(pos, MAX_MATCH + 1)  # rle fills at lookahead <= MAX_MATCH
            ml = 0
            lookahead = n - pos
            if lookahead >= MIN_MATCH and pos > self._nil_pos:
                prev_b = buf[pos - 1]
                if prev_b == buf[pos] == buf[pos + 1] == buf[pos + 2]:
                    run = 3
                    while run < MAX_MATCH and pos + run < n and buf[pos + run] == prev_b:
                        run += 1
                    if run < MAX_MATCH and pos + run >= n and prev_b == 0:
                        # window zero-padding extends zero runs virtually
                        run = MAX_MATCH
                    ml = min(run, lookahead)
            if ml >= MIN_MATCH:
                self._tally_match(ml, 1)
                self.strstart += ml
            else:
                self._tally_lit(buf[pos])
                self.strstart += 1
            if self._sym_full():
                self._flush_block(last=False)
        self.inserted = max(self.inserted, min(self.strstart, self.hashes.shape[0]))

    def _deflate_fast(self, limit: int) -> None:
        """Levels 1-3: greedy matching, zlib-exact (reference: fast.rs).

        Each scanned position is hash-inserted first; the pre-insert chain
        head is the sole entry point to longest_match. Matched spans are
        inserted position-by-position unless the match exceeds max_lazy
        (max_insert_length), in which case the span is skipped entirely —
        the hash chains never learn those positions."""
        nh = self.hashes.shape[0]
        n = len(self.buf)
        max_dist = self.wsize - MIN_LOOKAHEAD
        while self.strstart < limit:
            pos = self.strstart
            if pos + self._abs_drop - self._slid >= self._vthr:
                self._vslide(pos)
            hash_head = -1
            if pos < nh:
                self._insert_hashes_upto(pos + 1)
                hash_head = int(self.prev[pos & self.wmask])
            ml, mdist = 0, 0
            if hash_head > self._nil_pos and pos - hash_head <= max_dist:
                ml, mdist = self._longest_match(pos, hash_head, MIN_MATCH - 1)
            if ml >= MIN_MATCH and mdist > 0:
                self._tally_match(ml, mdist)
                if ml <= self.max_lazy and n - (pos + ml) >= MIN_MATCH:
                    self._insert_hashes_upto(min(pos + ml, nh))
                else:
                    self.inserted = max(self.inserted, min(pos + ml, nh))
                self.strstart = pos + ml
            else:
                self._tally_lit(self.buf[pos])
                self.strstart += 1
            if self._sym_full():
                self._flush_block(last=False)

    def _deflate_slow(self, limit: int, final: bool) -> None:
        """Levels 4-9: lazy matching, zlib-exact (reference: slow.rs).

        State carried across calls mirrors zlib's: the current match
        (length/start) rolls into the previous slot at each step; a match is
        emitted from position pos-1 when the current position cannot beat
        it; `match_available` marks an unresolved position whose byte
        becomes a literal if nothing better arrives. The trailing deferral
        at stream end is always a literal (a real match cannot be deferred
        into the final position because lengths clamp to the lookahead)."""
        nh = self.hashes.shape[0]
        max_dist = self.wsize - MIN_LOOKAHEAD
        while self.strstart < limit:
            pos = self.strstart
            if pos + self._abs_drop - self._slid >= self._vthr:
                self._vslide(pos)
            hash_head = -1
            if pos < nh:
                self._insert_hashes_upto(pos + 1)
                hash_head = int(self.prev[pos & self.wmask])
            self._prev_length = self._match_length
            self._prev_start = self._match_start
            self._match_length = MIN_MATCH - 1
            if (
                hash_head > self._nil_pos
                and self._prev_length < self.max_lazy
                and pos - hash_head <= max_dist
            ):
                ml, mdist = self._longest_match(pos, hash_head, self._prev_length)
                self._match_length = ml
                if mdist > 0:
                    self._match_start = pos - mdist
                if self._match_length <= 5 and (
                    self.strategy == Strategy.Filtered
                    or (
                        self._match_length == MIN_MATCH
                        and pos - self._match_start > TOO_FAR
                    )
                ):
                    # drop short matches that are too distant (or filtered)
                    self._match_length = MIN_MATCH - 1
            if self._prev_length >= MIN_MATCH and self._match_length <= self._prev_length:
                # the deferred match at pos-1 wins
                plen = self._prev_length
                self._tally_match(plen, (pos - 1) - self._prev_start)
                self._insert_hashes_upto(min(pos + plen - 1, nh))
                self.strstart = pos + plen - 1
                self._match_available = False
                self._match_length = MIN_MATCH - 1
                if self._sym_full():
                    self._flush_block(last=False)
            elif self._match_available:
                # pos-1 resolves to a literal; flush BEFORE advancing so the
                # block's byte coverage ends at pos (zlib flushes here with
                # strstart not yet advanced)
                self._tally_lit(self.buf[pos - 1])
                if self._sym_full():
                    self._flush_block(last=False)
                self.strstart += 1
            else:
                self._match_available = True
                self.strstart += 1
        if final and self._match_available:
            self._tally_lit(self.buf[self.strstart - 1])
            self._match_available = False

    def _resolve_deferred(self) -> None:
        """Resolve a pending lazy deferral (position strstart-1) to a
        literal, zlib's end-of-input rule. Must run before any direct
        _flush_block while the lazy matcher has carry state."""
        if not self._match_available:
            return
        self._tally_lit(self.buf[self.strstart - 1])
        self._match_available = False
        self._match_length = MIN_MATCH - 1

    # -- block emission ------------------------------------------------------

    def _emit_stored_block(self, data: bytes, last: bool) -> None:
        bw = self.bw
        i = 0
        if not data:
            bw.send_bits(1 if last else 0, 1)
            bw.send_bits(0, 2)
            bw.align()
            self.pending.extend(b"\x00\x00\xff\xff")
            self._block_types.append("stored")
            return
        while i < len(data):
            take = min(len(data) - i, MAX_STORED)
            is_last = last and (i + take == len(data))
            bw.send_bits(1 if is_last else 0, 1)
            bw.send_bits(0, 2)
            bw.align()
            ln = take
            self.pending.extend(bytes([ln & 0xFF, (ln >> 8) & 0xFF, ~ln & 0xFF, (~ln >> 8) & 0xFF]))
            self.pending.extend(data[i : i + take])
            i += take
            self._block_types.append("stored")

    def _vslide(self, pos: int, thr: int = MIN_LOOKAHEAD) -> None:
        """Slow path of the per-position slide check (see reset() comment).

        zlib only reaches the slide test inside fill_window, whose call is
        gated per algorithm class: deflate_fast/slow fill when
        lookahead < MIN_LOOKAHEAD (thr=262), deflate_rle when
        lookahead <= MAX_MATCH (thr=259), deflate_huff when lookahead == 0
        (thr=1) — where lookahead is measured against what fits the REAL
        2*wsize window buffer, not our unbounded one."""
        a = pos + self._abs_drop
        loaded = min(len(self.buf) + self._abs_drop, self._slid + 2 * self.wsize)
        if loaded - a < thr:
            while a - self._slid >= self._vthr:
                self._slid += self.wsize

    def _flush_block(self, last: bool) -> None:
        """Emit the buffered symbols as one block via the zlib-exact tree
        layer (models/trees.py): heap-built dynamic trees with zlib's exact
        tie-breaking, whole-byte cost comparison, stored/static/dynamic
        choice (reference: zng_tr_flush_block, deflate.rs:2297-2415)."""
        block_bytes = bytes(self.buf[self.block_start : self.strstart])

        if self.data_type == DataType.Unknown and self.sym_dist:
            dists = np.asarray(self.sym_dist, np.int64)
            lits = np.asarray(self.sym_lit, np.int64)
            lf = np.zeros(286, np.int64)
            lm = dists == 0
            if lm.any():
                lf[:256] = np.bincount(lits[lm], minlength=256)[:256]
            self.data_type = _detect_data_type(lf)

        kind = trees.flush_block(
            self.bw,
            self.pending,
            self.sym_dist,
            self.sym_lit,
            block_bytes,
            last,
            self.level,
            self.strategy,
            stored_ok=(self.block_start + self._abs_drop) >= self._slid,
        )
        self._block_types.append(kind)
        self.sym_dist.clear()
        self.sym_lit.clear()
        self.block_start = self.strstart

    # -- header / trailer ----------------------------------------------------

    def _emit_header(self) -> None:
        if self.wrap == Wrap.Zlib:
            cinfo = self.wbits - 8
            # compression-level hint bits (reference: deflate.rs header())
            if self.strategy >= Strategy.HuffmanOnly or self.level < 2:
                flevel = 0
            elif self.level < 6:
                flevel = 1
            elif self.level == 6:
                flevel = 2
            else:
                flevel = 3
            has_dict = self.base > 0
            cmf = (cinfo << 4) | 8
            flg = (flevel << 6) | (0x20 if has_dict else 0)
            rem = (cmf * 256 + flg) % 31
            if rem:
                flg += 31 - rem
            self.pending.extend(bytes([cmf, flg]))
            if has_dict:
                self.pending.extend(self.adler.to_bytes(4, "big"))
                self.adler = 1  # restart for payload per zlib semantics
        elif self.wrap == Wrap.Gzip:
            h = self.gzhead
            flg = 0
            if h is not None:
                flg |= 0x01 if h.text else 0
                flg |= 0x02 if h.hcrc else 0
                flg |= 0x04 if h.extra is not None else 0
                flg |= 0x08 if h.name is not None else 0
                flg |= 0x10 if h.comment is not None else 0
            if self.level == 9:
                xfl = 2
            elif self.strategy >= Strategy.HuffmanOnly or self.level < 2:
                xfl = 4
            else:
                xfl = 0
            mtime = h.time if h is not None else 0
            osb = h.os if h is not None else 3
            hdr = bytearray([0x1F, 0x8B, 8, flg])
            hdr.extend((mtime & 0xFFFFFFFF).to_bytes(4, "little"))
            hdr.append(xfl)
            hdr.append(osb & 0xFF)
            if h is not None:
                if h.extra is not None:
                    hdr.extend(len(h.extra).to_bytes(2, "little"))
                    hdr.extend(h.extra)
                if h.name is not None:
                    hdr.extend(h.name)
                    hdr.append(0)
                if h.comment is not None:
                    hdr.extend(h.comment)
                    hdr.append(0)
                if h.hcrc:
                    hdr.extend((checksum.crc32(bytes(hdr)) & 0xFFFF).to_bytes(2, "little"))
            self.pending.extend(hdr)
        self.header_emitted = True

    def _emit_trailer(self) -> None:
        self.bw.align()
        if self.wrap == Wrap.Zlib:
            self.pending.extend(self.adler.to_bytes(4, "big"))
        elif self.wrap == Wrap.Gzip:
            self.pending.extend(self.crc.to_bytes(4, "little"))
            self.pending.extend((self.total_in & 0xFFFFFFFF).to_bytes(4, "little"))

    # -- main driver ---------------------------------------------------------

    def deflate(self, data: bytes, flush: DeflateFlush = DeflateFlush.NO_FLUSH) -> ReturnCode:
        """Consume `data`, produce output into `self.pending` per `flush`.

        Counterpart of the reference's deflate() driver (deflate.rs:2470).
        """
        if self.finished:
            if data:
                return ReturnCode.StreamError
            return ReturnCode.StreamEnd
        # zlib's last_flush rank rule (deflate.c deflate() entry): a flush
        # call with no input, no pending output, and a rank not above the
        # previous call's flush is a no-op Z_BUF_ERROR — this is what makes
        # repeated empty SYNC_FLUSHes emit NOTHING instead of stacking
        # 5-byte empty stored seams (r4 advisor, medium).
        old_flush = self._last_flush
        self._last_flush = int(flush)
        if (
            not data
            and not self.pending
            and _rank_flush(int(flush)) <= _rank_flush(old_flush)
            and flush != DeflateFlush.FINISH
        ):
            return ReturnCode.BufError
        if not self.header_emitted:
            self._emit_header()
        data = bytes(data)
        if data:
            if self.wrap == Wrap.Zlib:
                self.adler = checksum.adler32(data, self.adler)
            elif self.wrap == Wrap.Gzip:
                self.crc = checksum.crc32(data, self.crc)
            self.total_in += len(data)
            self._append_input(data)

        final = flush == DeflateFlush.FINISH
        stored_func = self.level == 0 or self.func == "stored"
        if final or flush != DeflateFlush.NO_FLUSH:
            self._compress_pending_input(final=True, finish=final)
            # zlib's scan loop runs fill_window once more at the terminal
            # strstart before flushing (the slide check included) — mirror
            # that so stored-eligibility at the flush matches
            if not stored_func:
                thr = (
                    1 if self.strategy == Strategy.HuffmanOnly
                    else MAX_MATCH + 1 if self.strategy == Strategy.Rle
                    else MIN_LOOKAHEAD
                )
                self._vslide(self.strstart, thr)
        else:
            self._compress_pending_input(final=False)

        if flush in (
            DeflateFlush.SYNC_FLUSH,
            DeflateFlush.FULL_FLUSH,
            DeflateFlush.PARTIAL_FLUSH,
            DeflateFlush.BLOCK,
        ):
            if not stored_func and (self.sym_dist or self.strstart > self.block_start):
                self._flush_block(last=False)
            if flush == DeflateFlush.PARTIAL_FLUSH:
                trees.tr_align(self.bw)
            elif flush in (DeflateFlush.SYNC_FLUSH, DeflateFlush.FULL_FLUSH):
                self._emit_stored_block(b"", last=False)  # 00 00 FF FF seam
                if flush == DeflateFlush.FULL_FLUSH:
                    # forget match history so decode can restart here; zlib
                    # also zeroes `insert`, so the last MIN_MATCH-1 pre-flush
                    # positions are never hashed once new input arrives
                    self.head.fill(-1)
                    self.prev.fill(-1)
                    self.inserted = max(self.inserted, self.strstart)
                    # zlib resets strstart to 0 here, so the first post-flush
                    # position becomes window offset 0 == NIL: unmatchable
                    self._nil_pos = self.strstart
        elif final:
            if not stored_func:
                # zlib ends every level-1..9 stream with FLUSH_BLOCK(last=1),
                # which emits an empty final block when nothing is buffered;
                # the level-0 path marked its own last stored block already
                self._flush_block(last=True)
            self._emit_trailer()
            self.finished = True
            return ReturnCode.StreamEnd
        return ReturnCode.Ok

    def take_output(self, budget: int | None = None) -> bytes:
        """Drain up to `budget` bytes of pending output."""
        if budget is None or budget >= len(self.pending):
            out = bytes(self.pending)
            self.pending.clear()
        else:
            out = bytes(self.pending[:budget])
            del self.pending[:budget]
        self.total_out += len(out)
        return out


def _rank_flush(f: int) -> int:
    """zlib's RANK macro: orders flush values NO < BLOCK < PARTIAL < SYNC <
    FULL < FINISH (Z_BLOCK=5 folds between NO_FLUSH and PARTIAL_FLUSH)."""
    return f * 2 - (9 if f > 4 else 0)


def compress_bound(source_len: int, config: DeflateConfig = DeflateConfig()) -> int:
    """compressBound (reference: deflate.rs:2956-2977)."""
    return Deflator(config).bound(source_len)


def compress(data: bytes, config: DeflateConfig = DeflateConfig()) -> bytes:
    """One-shot compress (reference: deflate.rs:2826 compress_slice)."""
    d = Deflator(config)
    rc = d.deflate(data, DeflateFlush.FINISH)
    assert rc == ReturnCode.StreamEnd, rc
    return d.take_output()
