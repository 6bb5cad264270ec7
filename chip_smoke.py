#!/usr/bin/env python3
"""Smoke run of zlib_rs_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Sets ZRS_TPU_KERNEL=1 first, so that phases 1-25 run the kernel engine
(unset selects the XLA matcher engine, which phases 26-31 run). Builds
the port's CUDA kernels from zlib_rs_tpu_torch/csrc with nvcc,
holds each kernel against its plain PyTorch version on the card at the
shapes the main path gives it (K1, and K7 in phase 9, also on rows of
every length on an edge of their designs and on all-0xFF rows, at
starts that are not 16-byte aligned, each row also against zlib; K3
also on crafted lanes: empty,
all-literal, 258-byte dist-1 runs, 15-bit codes; K4, and K11a in phase
21, also on flipped body words, an undersized cap and a damaged index
whose block reads the body in place, with the count of blocks on each
branch; K5 also on corrupt
tapes, a random tape, a 128-hop chain and chunks past its chase, with the
count of chunks each body took), then drives the main path: level-6
`compress_parallel` of an 8 MiB corpus (a tar of system binaries, the
recipe of bench.py's corpus), checked by stdlib zlib, and
`decompress_parallel` of its indexed zlib and gzip streams through the
vector engine (K4 decode, K5 expansion), checked against the corpus, then
the decode's fail-safe on damaged input (phases 1-8). Then K7 (crc32)
against its plain version and zlib and the gzip encode that launches it
(phases 9-10); K6 (inflate) against its plain version on chunk bodies and
stored, fixed, window-primed, sub-byte-start, stop-at-target and corrupt
lanes, and in one launch over all chunks; the K6 route of
`decompress_parallel` (ZRS_TPU_VECTOR=0) on both streams, an index with
stored chunks, a flipped byte, `device_decode_streaming` of a stdlib raw
stream of the corpus and `decompress_chunks` of its window-primed regions
(phases 11-16). Then K8 (the hash-chain scan) against its plain version on
the first super-batch at level 9 (chunk 0 and the chunk that visits the
most candidates first) and at level 8 (that chunk), K9 (the symbol
histogram) against its plain version on the level-9 and level-8 streams
of the same batch, on crafted lanes (nmatch 0, random bytes, long gaps)
and on the tab route's stream, K10 (the
table walk) on the same batch under level 6 with ZRS_TPU_HOPSCAN=0, at its
tile and at MIN_TILE, and on crafted lanes (an overflow past one tile,
all-literal lanes, far dists, the level-9 knob set under
ZRS_TPU_CHAIN=256), every match stream checked on the card to tile its
span with byte-valid matches, and `compress_parallel` through the chain
route (levels 9 and 8) and the tab route, each checked by zlib (phases
17-20). Then K11a and K11b
(the single-plane decode and expansion) against their plain versions (K11b
also on corrupt tapes, a random tape, a 128-hop chain and chunks past its
chase, with the count of chunks each body took) and
the single-plane route of `decompress_parallel` (ZRS_VECTOR_TWOPLANE=0) on
both indexed streams, with its fail-safe (phases 21-23); K12 (the
interleaved hop chase) against its plain version and K2 on the first
super-batch, at its tile and at MIN_TILE, and on crafted lanes (an odd
batch, an overflow past one tile, far sources, serial-step landings,
all-literal lanes), and the level-6 encode under ZRS_TPU_HOP_IL=2, whose
stream must equal phase 4's (phases 24-25). Then, with ZRS_TPU_KERNEL
unset, the XLA encode engine (128 KiB chunks, torch stages, K1) at levels
6, 1 and 9, each checked by zlib and equal to the port's CPU stream on a
512 KiB prefix, and at chunk sizes 12345 and 65536 (the latter under
ZRS_TPU_KERNEL=1, past the kernel engine's buffer); K1 and K7 on 128 KiB
rows, and K4, K5, K11a, K11b and K6 on the 128 KiB indexed streams (K5
and K11b on their serial too-large body), each against its plain
version, and every decode route end to end on them; the seeded swarm
engine under ZRS_TPU_KERNEL=0 (and ZRS_TPU_VECTOR=0), held against its
CPU run, and its walker kernel (csrc/swarm.cu) against its plain version
on every chunk, clean and with a flipped byte; the static level-1 index
through K6 (phases 26-31). Then the
lockstep kernel (csrc/lockstep.cu, `decode_regions`) against its plain
version on the CPU on 8 lanes of 16 KiB (stdlib raw deflate at levels 0,
1, 6 and 9 and under Z_FIXED, two zran regions at sub-byte starts with
their windows, the lone-EOB body), on the same lanes with a flipped byte
in each and on a 128 KiB chunk of the XLA engine's stream, with its steps
a second and ms a launch; `resolve_tokens` of the clean lanes against the
corpus, `decompress_chunks(engine="auto")` recovering the lone-EOB body
that K6 refuses and a flipped bit raising (phase 32); `decompress_foreign`
of the corpus as stdlib zlib at levels 6 and 9, raw deflate and gzip of
1, 4 and 64 members, each through K6
with no fallback, the monolithic streams indexed on the card (SP1-SP3
launched in each run's zran_index stage, their launches and event ms
printed), each gzip member skimmed on the card (SP2 at least once a
member; the gzip_split stage beside the host zlib skim of the same
stream, and a member of 8 MiB of zeros through its room's regrowths),
three warm runs of the level-6 stream with the zran
index pass and the region decode timed apart, and a corrupted adler32
raising (phase 33); `compress_parallel` under each non-default strategy
(the host engine) at level 6 on 256 KiB as zlib and gzip, each decoded by
zlib, and return_index raising (phase 34). Then the command line,
`python -m zlib_rs_tpu_torch --engine cuda` on the corpus as a file in
gzip, zlib and raw at levels 6 and 1, each output equal to
compress_parallel's, `--engine auto` taking the card for 8 MiB and the
host below the CLI's threshold, and `-d --engine cuda` giving the corpus
back through K6 (phase 35); decompress_parallel's engine names, "tpu"
equal to "device" and "auto" decoding both indexed streams through the
region decode with one K6 launch, the device chain's last step (the
region decode) giving back a small stream whose engines all fault,
through K6 and, with a region K6 refuses, through the lockstep engine,
and the time to raise on a flipped byte in a 128 KiB chunk, through one
launch of the lockstep kernel (phase 36); the host API layers on 64 KiB
of the corpus, each against stdlib zlib: `Deflate`/`Inflate` through
1-byte and 4 KiB buffers under every flush mode, a `GzFile` write and
read, `inflate_back`, `compress_medium` and `compress_quick`, zran
`extract` at three offsets and `crc32_combine_op` (phase 38, run before
the bench); the multi-device path in a one-rank NCCL group on cuda:0,
`compress_parallel(mesh=)` of the corpus under ZRS_TPU_KERNEL=1 equal to
phase 4's stream (K1-K3 launched) with three warm runs, the XLA engine's
level-6 stream under the mesh equal to its unsharded one,
`make_sharded_decode_step` on the 128 KiB indexed stream through the
walker kernel, byte-exact, and `graft_entry.dryrun_multichip(1)` (phase
39, run before the bench); the speculative decode of an unindexed stream
(csrc/speculative.cu): SP1 (the block finder) on every segment of the
corpus's level-6 raw stream, SP2 (the marker decode, a thread block a
row) on its segments, on crafted rows of the stored, Z_FIXED and a
flipped stream and on its design's edge rows (sp2_edge_rows), and SP3
(the marker resolve) on the whole chain and a long-chain stream, each
against its plain version at max abs err 0 (each also against the first
design it replaced, timed against it in the same call: SP2 over the
segments and the exact row of the whole stream, SP1 and SP3 in turn by
events and by kernel), then `inflate_speculative` of the corpus as raw deflate
at levels 1, 6 and 9, under Z_FIXED, stored, as a zlib body and as 64
MiB (the corpus 8 times), each back to its input with its segments,
chain misses and each kernel's event ms, and a stream of more than 2^28
+ 2^20 bytes (random bytes over 64 letters at level 1, bit positions
past int32) back to its input with its seconds and peak device memory
(phase 40, run before the bench); EX (csrc/exact_deflate.cu, the native
engine's encode half) against its plain version on 16 KiB rows at every
level 0-9, QUICK and MEDIUM4-6, primed and not, final and not, the
resolve's deltas and slots at levels 1-9 and MEDIUM4-6 (at 1-3 and
MEDIUM under two skip maps) and the dry parse of 1-3 and MEDIUM against
their plain versions on the same rows, then `deflate_parallel` of the
corpus at levels 1, 2, 3, 6 and 9, every 128 KiB chunk equal to stdlib
zlib's primed raw deflate, QUICK and MEDIUM4-6 back through zlib (MEDIUM
on the resolve and the chase, no one-warp launch), EX's ms a call, at
levels 6 and 9 the resolve's, the chase's and flush_block's ms and at
1-3 and MEDIUM4-6 the resolve's, the dry parse's and the chase's at
EK.ROUNDS rounds with the live walks a loop top (`ex_split` lines), at
levels 1, 3, MEDIUM4 and MEDIUM6 the dry parse and the next round's
resolve against their plain versions at the main path's shape, and the one-shot
`compress` of 1 MiB at levels 1, 2, 3, 6 and 9 and of the corpus at
level 6 (two pieces) equal to zlib.compress
(phase 41); the one-shot
`decompress` of the corpus's zlib and gzip streams and of a 1 MiB
stream (inflate_speculative at every size), inflate_raw against
inflate_speculative from 16 KiB to 1 MiB, and the CLI's `--quick`,
`--medium`, `--engine native` and `-d --engine native` (two gzip
members) in processes (phase 42); DS at MEDIUM4-6 against its plain
version on pump scripts, `native.RawDeflateStream` over 1 MiB at each
MEDIUM level, a MEDIUM5 pump's event ms (the resolve, then the chase and
its tables) and bytes against the plain version's, one MEDIUM5 stream
past DS's 1 MiB prune held pump for pump
against the plain version, and the K6 and SP launches of
`native.inflate_parallel` and `native.inflate_raw` (phase 44, after the
stream path's phase 43); `python -m zlib_rs_tpu_torch.bench` within the time left, its last line under 500
bytes with a torch.profiler headline, both native inflate rates, every
device phase's key and device-busy share in the full line above it, and
every native and decode-sweep row measured or cut by its budget (phase 37). Any mismatch
raises; no phase's failure is caught.

Each encode prints its stream's length and sha256, so that two checkouts
run in one call can be shown to give the same bytes.

Lines before the last: the build time, per-phase results, one JSON object
{"kernels": [...]} with each kernel's launches on the main path, error
against its plain version, times and bound, the end-to-end numbers, and
the card's name and power limit from nvidia-smi. The last line is
{"ok": true, "device": {...}}. Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import gzip
import hashlib
import io
import json
import os
import subprocess
import sys
import tarfile
import tempfile
import time
import zlib
from pathlib import Path

CORPUS_BYTES = 8 * 1024 * 1024
LEVEL = 6
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
ALU_OPS_PER_S = 67e12  # H100 SXM 32-bit rate outside the tensor cores
COMPARE_ROWS = 8  # chunks held against the plain chase, pack, decode and expansion
UNDERSIZED_CAP = 16  # tape rows: walkers of this corpus need ~33 on average
PLAIN_K8_BUDGET_S = 60.0  # seconds of the plain K8 loop over the rest of phase 17's batch
SMOKE_LIMIT_S = 1100.0  # the whole run's limit, less room for the lines after phase 37
BENCH_BUDGET_S = 400.0  # phase 37's bench budget when the run is on time


def load_corpus(size: int = CORPUS_BYTES) -> tuple[bytes, list[str]]:
    """A deterministic tar of /bin/bash, /usr/bin/python3.12 and /bin/ls
    (those present), repeated to `size` bytes, fixed metadata; with the
    names of the members used."""
    members = []
    for extra in ("/bin/bash", "/usr/bin/python3.12", "/bin/ls"):
        try:
            members.append((Path(extra).name, Path(extra).read_bytes()))
        except OSError:
            pass
    if not members:
        raise RuntimeError("no corpus member is readable")
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w", format=tarfile.USTAR_FORMAT) as tf:
        rep = 0
        while buf.tell() < size:
            for name, blob in members:
                ti = tarfile.TarInfo(f"{rep}/{name}")
                ti.size = len(blob)
                ti.mtime = 0
                tf.addfile(ti, io.BytesIO(blob))
            rep += 1
    return buf.getvalue()[:size], [m[0] for m in members]


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def event_ms(torch, fn, reps: int) -> float:
    """Mean device time of `fn` over `reps` launches after one warm-up."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def queued_ms(torch, fn, reps: int = 50) -> float:
    """Mean device time of `fn` over `reps` launches queued behind a busy
    wait of the card, so that it runs them back to back whatever the host
    spends to launch each (event_ms waits for the host)."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # about 50 ms of cycles at 1.98 GHz
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def timed_ms(torch, fn):
    """One call of `fn`: its result and its wall time in ms (host work
    included); for the plain versions, whose one run is both the reference
    and the timing."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def bound(nbytes: float, nops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / ALU_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def digest(stream: bytes) -> str:
    """A stream's length and sha256, as the encode phases print them."""
    return f"{len(stream)} bytes, sha256 {hashlib.sha256(stream).hexdigest()}"


def max_abs(pairs) -> int:
    """Largest absolute difference over (got, want) integer tensor pairs,
    compared as int64."""
    err = 0
    for got, want in pairs:
        d = (got.to("cpu").long() - want.to("cpu").long()).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    return err


def bytes_err(torch, got, want, sizes) -> int:
    """max_abs over bytes [0, sizes[r]) of each row of two int32 [B, n]
    arrays of LE32 words (an expansion defines only those bytes)."""
    g8 = got.cpu().numpy().view("u1")
    w8 = want.cpu().numpy().view("u1")
    return max_abs([(torch.from_numpy(g8[r, :n]), torch.from_numpy(w8[r, :n]))
                    for r, n in enumerate(sizes)])


def warm_runs(torch, PL, fn, want, nbytes: int, label: str, phase: int) -> dict:
    """Three warm runs of `fn` with stages, each result equal to `want`;
    prints and returns their walls, MB/s (`nbytes` of corpus a run) and
    stages."""
    PL.STAGES.enabled = True
    walls, stages = [], []
    try:
        for _ in range(3):
            PL.STAGES.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            again = fn()
            walls.append(time.perf_counter() - t0)
            stages.append(PL.STAGES.ms())
            if again != want:
                raise AssertionError(f"a warm {label} run gave other bytes")
    finally:
        PL.STAGES.enabled = False
    mbps = [nbytes / w / 1e6 for w in walls]
    print(f"phase {phase} {label}: wall s " + ", ".join(f"{w:.4f}" for w in walls)
          + "; MB/s " + ", ".join(f"{m:.2f}" for m in mbps), flush=True)
    for run, st in enumerate(stages, 1):
        print(f"phase {phase} {label} stages ms (warm run {run}): "
              + json.dumps({n: round(v, 3) for n, v in st.items()}), flush=True)
    return {"warm_s": walls, "warm_mb_per_s": mbps, "stage_ms": stages}


def time_to_raise(torch, PL, fn) -> tuple[str, float, dict]:
    """`fn` must raise ValueError: (its message, the wall to the raise,
    the stages it ran, ms, each summed, with stage timing on)."""
    PL.STAGES.enabled = True
    PL.STAGES.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        fn()
    except ValueError as e:
        why = str(e)
    else:
        raise AssertionError("a damaged stream decoded without a ValueError")
    finally:
        wall = time.perf_counter() - t0
        PL.STAGES.enabled = False
    return why, wall, {k: round(v, 3) for k, v in PL.STAGES.ms().items()}


def stage_decode(VI, idx_out, index, dev):
    """The vector decode's staged inputs of an indexed stream: (bodies,
    sizes, seeds, staged, meta, the decode kernels' operands for all chunks
    and for the first COMPARE_ROWS)."""
    bodies = [idx_out[off : off + ln] for off, ln, _ in index]
    sizes = [n for _, _, n in index]
    staged, meta = VI.prepare_vector_inputs(bodies, sizes, index.seeds, dev)
    k, S = min(COMPARE_ROWS, meta["B"]), meta["S"]
    names = ("words", "start_word", "align", "span", "tables")
    full_args = [staged[n] for n in names]
    sub_args = [staged["words"][:k]] + [staged[n][: k * S] for n in names[1:4]] + [
        staged["tables"][:k]]
    return bodies, sizes, index.seeds, staged, meta, full_args, sub_args


def decode_edge_pairs(torch, VK, cuda, plain, full_args, sub_args, S: int, K: int, cap: int):
    """K4's or K11a's (`cuda`, `plain`) edge cases beside the main run: the
    first chunks with flipped body words, then with an undersized cap, then
    with a damaged index (one walker of the second chunk starting Lw + K
    words before its own start, so that its block's window passes the
    staged budget and the block reads in place). Returns (pairs of outputs, the
    kernel's outputs of the flipped and undersized cases, blocks on each
    branch in the main run and in the damaged one)."""
    VK.decode_blocks()  # restart the counts
    full = cuda(*full_args, S=S, K=K, cap=cap)
    main_blocks = VK.decode_blocks()
    flipped = sub_args[0].clone()
    flipped[:, flipped.shape[1] // 2] ^= 0xFF
    damaged = sub_args[1].clone()
    damaged[S + 5] -= sub_args[0].shape[1] + K
    pairs, bad_runs = [], []
    for words_c, sw_c, cap_c, corrupt in ((flipped, sub_args[1], cap, True),
                                          (sub_args[0], sub_args[1], UNDERSIZED_CAP, True),
                                          (sub_args[0], damaged, cap, False)):
        args_c = [words_c, sw_c] + sub_args[2:]
        VK.decode_blocks()
        got_c = cuda(*args_c, S=S, K=K, cap=cap_c)
        blocks_c = VK.decode_blocks()
        want_c = plain(*args_c, S=S, K=K, cap=cap_c)
        if corrupt and not (int(want_c[-2].sum()) or int(want_c[-1].abs().sum())):
            raise AssertionError("a corrupt decode lane set flags no walker")
        pairs += list(zip(got_c, want_c))
        bad_runs.append(got_c)
    if main_blocks[1] or blocks_c[1] < 1:
        raise AssertionError(f"decode blocks staged/global: main {main_blocks}, damaged "
                             f"index {blocks_c}")
    return full, pairs, bad_runs[:2], {"main": main_blocks, "damaged index": blocks_c}


def decode_phases(torch, dev, corpus, idx_out, index, gz, gz_index, rows, launches) -> dict:
    """Phases 5-8: K4 and K5 against their plain versions on the indexed
    stream's chunks, the decode path end to end (zlib and gzip), and the
    fail-safe on damaged input. Fills `rows` and `launches` for K4 and K5;
    returns the decode's end-to-end numbers."""
    import zlib_rs_tpu_torch as zt
    from zlib_rs_tpu_torch.ops.kernels import inflate_kernel as IK
    from zlib_rs_tpu_torch.ops.kernels import vhuff_kernel as VK
    from zlib_rs_tpu_torch.parallel import pipeline as PL
    from zlib_rs_tpu_torch.parallel import vector_inflate as VI

    bodies, sizes, seeds, staged, meta, full_args, sub_args = stage_decode(VI, idx_out, index, dev)
    S, K, B = meta["S"], meta["K"], meta["B"]
    cap = VI._twoplane_cap(meta)
    W = B * S

    # -- phase 5: K4 against its plain version -----------------------------
    # all chunks clean, then the edges of decode_edge_pairs: flipped words,
    # an undersized cap and a damaged index on the first chunks
    full, edge, bad_runs, blocks = decode_edge_pairs(
        torch, VK, VK.decode_tokens_vector2_cuda, VK.decode_tokens_vector2_plain, full_args,
        sub_args, S, K, cap)
    want, plain_ms = timed_ms(
        torch, lambda: VK.decode_tokens_vector2_plain(*full_args, S=S, K=K, cap=cap))
    err = max_abs(list(zip(full, want)) + edge)
    if err:
        raise AssertionError(f"K4 disagrees with its plain version: max abs err {err}")
    tapeA, tapeB, _cons, bad, rem = full
    if int(bad.abs().sum()) or int(rem.abs().sum()):
        raise AssertionError("K4 flags walkers of the clean stream")
    used_rows = int((tapeB != 0).sum())
    # the body bytes the walkers read, the tables, three walker arrays in,
    # the tape rows used and three walker arrays out (the zero rows past
    # each walker's stop are left out)
    body_bytes = sum(len(b) for b in bodies) + 4 * staged["tables"].numel()
    nb = body_bytes + 3 * 4 * W + 8 * used_rows + 3 * 4 * W
    decode2 = lambda: VK.decode_tokens_vector2_cuda(*full_args, S=S, K=K, cap=cap)
    rows["vhuff_decode"] = dict(
        source="zlib_rs_tpu_torch/csrc/vhuff_decode.cu",
        replaces="zlib_rs_tpu/ops/pallas/vhuff_kernel.py:1200",
        max_abs_err=err,
        ms=event_ms(torch, decode2, 20),
        queued_ms=queued_ms(torch, decode2),
        plain_ms=plain_ms,
        # four cascade lookups (~30 operations each) and ~80 more a row
        bnd=bound(nb, 200 * used_rows),
    )
    print(f"phase 5 K4: {B} chunks, {W} walkers, K {K}, cap {cap}, {used_rows} rows: both "
          f"tapes, cons, bad and rem equal to plain; the first {COMPARE_ROWS} chunks with "
          f"flipped words, with cap {UNDERSIZED_CAP} and with a damaged index equal to plain; "
          f"blocks staged/global {blocks}; ms a launch {rows['vhuff_decode']['ms']:.6f} by "
          f"events, {rows['vhuff_decode']['queued_ms']:.6f} queued", flush=True)

    # -- phase 6: K5 against its plain version -----------------------------
    # all chunks (every one through the chase), then the edges of
    # k5_edge_pairs: corrupt tapes of the first chunks (phase 21's faults),
    # a random tape, a 128-hop chain, rows past the chase
    out_words = -(-max(sizes) // 4) + 2
    offs = staged["offs"]
    branch = torch.full((B,), -1, dtype=torch.int32, device=dev)
    outw = VK.expand_tokens2_cuda(tapeA, tapeB, offs, out_words=out_words, branch=branch)
    want, plain_ms = timed_ms(
        torch, lambda: VK.expand_tokens2_plain(tapeA, tapeB, offs, out_words=out_words))
    err = bytes_err(torch, outw, want, sizes)
    main_bodies = {int(b): int(n) for b, n in zip(*torch.unique(branch, return_counts=True))}
    if (branch != VK.BRANCH_CHASE).any():
        raise AssertionError(f"K5 chunks of the clean stream left the chase: {main_bodies}")
    full8 = outw.cpu().numpy().view("u1")
    if b"".join(full8[r, : sizes[r]].tobytes() for r in range(B)) != corpus:
        raise AssertionError("the full K5 expansion is not the corpus")
    k = min(COMPARE_ROWS, B)
    bad_tapes = [run[:2] for run in bad_runs]
    edge, bodies_seen = k5_edge_pairs(torch, VK, dev, tapeA, tapeB, offs, sizes, bad_tapes, k)
    err = max(err, max_abs((torch.from_numpy(g), torch.from_numpy(w)) for g, w in edge))
    if err:
        raise AssertionError(f"K5 disagrees with its plain version: max abs err {err}")
    nb = 8 * used_rows + 4 * offs.numel() + len(corpus)
    rows["vhuff_expand"] = dict(
        source="zlib_rs_tpu_torch/csrc/vhuff_expand.cu",
        replaces="zlib_rs_tpu/ops/pallas/vhuff_kernel.py:1168",
        max_abs_err=err,
        ms=event_ms(torch, lambda: VK.expand_tokens2_cuda(tapeA, tapeB, offs, out_words=out_words),
                    50),
        plain_ms=plain_ms,
        # a funnel store and a match copy: ~40 operations a row
        bnd=bound(nb, 40 * used_rows),
    )
    names = {VK.BRANCH_CHASE: "chase", VK.BRANCH_UNTILED: "serial (untiled)",
             VK.BRANCH_TOO_LARGE: "serial (too large)"}
    print(f"phase 6 K5: {B} chunks equal to plain and expand to the corpus, bodies "
          f"{ {names[b]: n for b, n in main_bodies.items()} }; edge chunks "
          f"(corrupt, random, a 128-hop chain, a 38400-byte chunk, rows of "
          f"{VK.CHASE_MAX_ROW + 32} and 240000 bytes) equal to plain, bodies "
          f"{ {names[b]: n for b, n in bodies_seen.items()} }",
          flush=True)

    # -- phase 7: the decode path, end to end ------------------------------
    before = PL.fallback_stats()
    for name in VK.launches:
        VK.launches[name] = 0
    t0 = time.perf_counter()
    back = zt.decompress_parallel(idx_out, index)
    cold_s = time.perf_counter() - t0
    launches.update({n: VK.launches[n] for n in ("vhuff_decode", "vhuff_expand")})
    if back != corpus:
        raise AssertionError("decompress_parallel does not return the corpus")
    if min(launches["vhuff_decode"], launches["vhuff_expand"]) < 1 or (
            VK.launches["vhuff_decode1"] + VK.launches["vhuff_expand1"]):
        raise AssertionError(f"the two-plane decode launched {VK.launches}")
    result = {"bytes_out": len(back), "cold_s": cold_s}
    for label, stream, ix in (("zlib", idx_out, index), ("gzip", gz, gz_index)):
        result[label] = warm_runs(torch, PL, lambda: zt.decompress_parallel(stream, ix), corpus,
                                  len(corpus), f"decode {label}", 7)
    if PL.fallback_stats() != before or before:
        raise AssertionError(f"the clean decode fell back: {PL.fallback_stats()}")
    print(f"phase 7 e2e: cold {cold_s:.3f} s, launches "
          f"{ {n: launches[n] for n in ('vhuff_decode', 'vhuff_expand')} }, no fallback",
          flush=True)

    # -- phase 8: fail-safe on the card ------------------------------------
    broken = list(bodies)
    hit = B // 2
    flip = bytearray(broken[hit])
    flip[len(flip) // 2] ^= 0xFF
    broken[hit] = bytes(flip)
    try:
        VI.decode_chunks_vector(broken, sizes, seeds, device=dev)
    except VI.VectorDataFault as e:
        why = str(e)
    else:
        raise AssertionError("a flipped body byte decoded without a VectorDataFault")
    real_cap = VI._twoplane_cap
    VI._twoplane_cap = lambda m: UNDERSIZED_CAP
    try:
        n0 = PL.fallback_stats().get("vector_decode:ValueError", 0)
        k0 = IK.launches["inflate"]
        if zt.decompress_parallel(idx_out, index) != corpus:
            raise AssertionError("the undersized-cap decode is not the corpus")
        if PL.fallback_stats().get("vector_decode:ValueError", 0) != n0 + 1:
            raise AssertionError(f"the undersized cap was not counted: {PL.fallback_stats()}")
        if IK.launches["inflate"] != k0 + 1 or len(PL.fallback_stats()) != 1:
            raise AssertionError(f"the undersized cap did not land on K6: {PL.fallback_stats()}")
    finally:
        VI._twoplane_cap = real_cap
    torch.cuda.synchronize()
    if zt.decompress_parallel(idx_out, index) != corpus:
        raise AssertionError("the clean decode after the faults is not the corpus")
    torch.cuda.synchronize()
    print(f"phase 8 fail-safe: flipped byte in chunk {hit} raised VectorDataFault ({why}); "
          f"cap {UNDERSIZED_CAP} fell back to K6 (one launch) and was counted; a clean decode "
          f"followed", flush=True)
    return result


def _raw(data: bytes, level: int = 6, strategy: int = zlib.Z_DEFAULT_STRATEGY, zdict=None,
         mem: int = 8) -> bytes:
    """A stdlib raw-deflate stream; mem=1 makes blocks of ~128 symbols."""
    kw = {} if zdict is None else {"zdict": zdict}
    c = zlib.compressobj(level, zlib.DEFLATED, -15, mem, strategy, **kw)
    return c.compress(data) + c.flush()


def _flip(b: bytes, i: int) -> bytes:
    b = bytearray(b)
    b[i] ^= 0xFF
    return bytes(b)


class BitWriter:
    """An RFC 1951 bit stream, LSB first, Huffman codes MSB first: fixed
    blocks of literals and (length, dist) pairs, and stored blocks."""

    LBASE = (3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31, 35, 43, 51, 59, 67, 83, 99,
             115, 131, 163, 195, 227, 258)
    DBASE = (1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193, 257, 385, 513, 769, 1025,
             1537, 2049, 3073, 4097, 6145, 8193, 12289, 16385, 24577)

    def __init__(self):
        self.acc, self.n, self.out = 0, 0, bytearray()

    def put(self, v: int, nbits: int) -> None:
        self.acc |= v << self.n
        self.n += nbits
        while self.n >= 8:
            self.out.append(self.acc & 0xFF)
            self.acc >>= 8
            self.n -= 8

    def code(self, c: int, nbits: int) -> None:
        self.put(int(format(c, f"0{nbits}b")[::-1], 2), nbits)

    def sym(self, s: int) -> None:
        if s < 144:
            self.code(0x30 + s, 8)
        elif s < 256:
            self.code(0x190 + s - 144, 9)
        elif s < 280:
            self.code(s - 256, 7)
        else:
            self.code(0xC0 + s - 280, 8)

    def fixed_block(self, items, final: int) -> "BitWriter":
        self.put(final, 1)
        self.put(1, 2)
        for it in items:
            if isinstance(it, int):
                self.sym(it)
                continue
            length, dist = it
            i = max(k for k in range(29) if self.LBASE[k] <= length)
            self.sym(257 + i)
            self.put(length - self.LBASE[i], 0 if i < 8 or i == 28 else (i - 4) // 4)
            j = max(k for k in range(30) if self.DBASE[k] <= dist)
            self.code(j, 5)
            self.put(dist - self.DBASE[j], 0 if j < 4 else j // 2 - 1)
        self.sym(256)
        return self

    def stored_block(self, data: bytes, final: int) -> "BitWriter":
        self.put(final, 1)
        self.put(0, 2)
        if self.n:
            self.put(0, 8 - self.n)
        self.out += len(data).to_bytes(2, "little") + (len(data) ^ 0xFFFF).to_bytes(2, "little")
        self.out += data
        return self

    def done(self) -> bytes:
        if self.n:
            self.put(0, 8 - self.n)
        return bytes(self.out)


def expand(items, history: bytes = b"") -> bytes:
    """The bytes that literals and (length, dist) pairs stand for."""
    out = bytearray(history)
    for it in items:
        if isinstance(it, int):
            out.append(it)
        else:
            for _ in range(it[0]):
                out.append(out[-it[1]])
    return bytes(out[len(history) :])


def k6_design_lanes(np, corpus: bytes, max_out: int) -> list:
    """K6 lanes for the edges of its design: (label, streams, out_lens,
    max_out, windows, clean). A stored block of 65,535 bytes after a fixed
    block (it crosses the 4 KiB copy pieces and the 64 KiB ring);
    distances 1, 2, 3, 31, 32 and 33 (the period rule); matches of distance
    32,768 into a 32 KiB window; literals run past max_out (counted) and a
    match that would cross it; an output several times the ring; one stream
    of 1.2 MB at B=1."""
    rnd = np.random.default_rng(8).integers(0, 256, 100_000, dtype=np.uint8).tobytes()
    dists = list(rnd[:40]) + [(258, 1), (17, 2), (40, 3), (100, 31), (64, 32), (70, 33), (3, 1),
                              (5, 2), (31, 31), (33, 32), (32, 33), (258, 31)]
    history = corpus[120_000:152_768]
    into = [(258, 32768), (10, 32763), (3, 32768), *b"abc", (40, 20_000), (258, 3), (100, 32768)]
    stored = BitWriter().fixed_block(list(rnd[:1001]), 0).stored_block(rnd[1001:66_536], 1).done()
    past = [BitWriter().fixed_block(list(rnd[: max_out + 100]) + [(3, 1)], 1).done(),
            BitWriter().fixed_block(list(rnd[: max_out - 100]) + [(258, 1)], 1).done()]
    return [
        ("stored 65,535 after fixed", [stored], [66_536], 70_000, None, True),
        ("distances 1-33", [BitWriter().fixed_block(dists, 1).done()], [len(expand(dists))],
         max_out, None, True),
        ("distance 32,768 into the window", [BitWriter().fixed_block(into, 1).done()],
         [len(expand(into, history))], max_out, [history], True),
        ("past max_out", past, [max_out + 103, max_out + 158], max_out, None, False),
        ("300 kB, the ring four times over", [_raw(corpus[:300_000])], [300_000], 300_000, None,
         True),
        ("one 1.2 MB stream", [_raw(corpus[:1_200_000])], [-1], 1_200_000, None, True),
    ]


def k6_against_plain(torch, dev, IK, streams, out_lens, max_out, *, start_bits=None, win=None,
                     stop=False) -> tuple[int, list]:
    """K6 and its plain version on the same lanes: max abs err over
    produced, bad, end_bit (and fin_seen), and the bytes
    [0, min(produced, max_out)) of every lane. Returns (err, plain's
    (produced, bad) per lane)."""
    words, bits = IK.pack_streams_words(streams)
    B = len(streams)
    sb = [0] * B if start_bits is None else start_bits
    args = [torch.from_numpy(words.view("i4")), torch.tensor(sb, dtype=torch.int32),
            torch.from_numpy(bits), torch.tensor(out_lens, dtype=torch.int32)]
    got = IK.decode_streams_cuda(*[a.to(dev) for a in args], max_out=max_out,
                                 win=None if win is None else win.to(dev), stop_at_target=stop)
    want = IK.decode_streams_plain(*args, max_out=max_out, win=win, stop_at_target=stop)
    return k6_err(torch, got, want, max_out), list(zip(want[1].tolist(), want[2].tolist()))


def k6_err(torch, got, want, max_out) -> int:
    """Max abs err between two K6 results: produced, bad, end_bit (and
    fin_seen), and the bytes [0, min(produced, max_out)) of every lane."""
    got = [t.cpu() for t in got]
    pairs = [(g.to(torch.int32), w.to(torch.int32)) for g, w in zip(got[1:], want[1:])]
    for r in range(want[0].shape[0]):
        n = min(int(want[1][r]), max_out)
        pairs.append((got[0][r, :n], want[0][r, :n]))
    return max_abs(pairs)


class kernel_events:
    """Within the block, every launch of `module`'s `<name>_cuda` wrapper
    of each of `names` is bracketed by CUDA events; the dict it yields
    holds each name's list of device ms once the block ends."""

    def __init__(self, torch, module, names):
        self.torch, self.module, self.names = torch, module, tuple(names)
        self.ms = {n: [] for n in self.names}
        self.events = {n: [] for n in self.names}
        self.real = {}

    def __enter__(self):
        for name in self.names:
            real = self.real[name] = getattr(self.module, f"{name}_cuda")

            def timed(*a, _real=real, _name=name, **k):
                e0 = self.torch.cuda.Event(enable_timing=True)
                e1 = self.torch.cuda.Event(enable_timing=True)
                e0.record()
                out = _real(*a, **k)
                e1.record()
                self.events[_name].append((e0, e1))
                return out

            setattr(self.module, f"{name}_cuda", timed)
        return self.ms

    def __exit__(self, *exc):
        for name, real in self.real.items():
            setattr(self.module, f"{name}_cuda", real)
        self.torch.cuda.synchronize()
        for name, evs in self.events.items():
            self.ms[name].extend(e0.elapsed_time(e1) for e0, e1 in evs)
        return False


def design_lengths(threads: int, seg: int, n: int) -> list:
    """Row lengths on each edge of K1's and K7's designs (threads a row,
    bytes a thread a pass, row width n): under four bytes, one 16-byte
    load, one segment, one pass, and past it."""
    return [0, 1, 3, 4, 5, 15, 16, 17, seg - 1, seg, seg + 1, threads * seg - 1,
            threads * seg, threads * seg + 1, n - 1, n]


def checksum_edge_pairs(torch, dev, cuda, plain, zcheck, threads: int, seg: int, label: str):
    """K1's or K7's (`cuda`, `plain`) edge rows beside the main run: rows
    of design_lengths in a view whose row stride is 3 bytes past a
    multiple of 16 (every row at another misaligned start), then all-0xFF
    rows in such a view. Each row must equal `zcheck` (zlib's function)
    of its bytes; returns the (kernel, plain) pairs."""
    n = threads * seg + 100
    lengths = design_lengths(threads, seg, n)
    g = torch.Generator().manual_seed(3)
    pairs = []
    for fill in (None, 0xFF):
        R = len(lengths) if fill is None else 4
        size = 3 + R * (n + 3)
        if fill is None:
            flat = torch.randint(0, 256, (size,), generator=g, dtype=torch.uint8)
            lens = torch.tensor(lengths, dtype=torch.int32)
        else:
            flat = torch.full((size,), fill, dtype=torch.uint8)
            lens = torch.tensor([n, threads * seg, threads * seg - 1, 17], dtype=torch.int32)
        view = torch.as_strided(flat.to(dev), (R, n), (n + 3, 1), 3)
        got = cuda(view, lens.to(dev))
        pairs.append((got, plain(view, lens.to(dev))))
        host = torch.as_strided(flat, (R, n), (n + 3, 1), 3).numpy()
        for r in range(R):
            z = zcheck(host[r, : int(lens[r])].tobytes())
            if int(got[r].item()) & 0xFFFFFFFF != z:
                raise AssertionError(f"{label} edge row {r} (length {int(lens[r])}, start "
                                     f"{(3 + r * (n + 3)) % 16} past 16 bytes, fill {fill}) "
                                     f"disagrees with zlib")
    return pairs


def crc_phase(torch, dev, corpus, rows) -> None:
    """Phase 9: K7 against its plain version and zlib on the gzip
    trailer's 256 full 32 KiB rows and on ragged rows."""
    import numpy as np
    from zlib_rs_tpu_torch.ops.kernels import crc_kernels as CRC
    from zlib_rs_tpu_torch.parallel import pipeline as PL

    cs = PL.DEFAULT_CHUNK
    nfull = len(corpus) // cs
    full = torch.from_numpy(np.frombuffer(corpus, np.uint8, count=nfull * cs).reshape(nfull, cs).copy()).to(dev)
    lens = torch.full((nfull,), cs, dtype=torch.int32, device=dev)
    got = CRC.crc32_batch_cuda(full, lens)
    want = CRC.crc32_batch_plain(full, lens)
    err = max_abs([(got, want)])
    for r in range(nfull):
        z = zlib.crc32(corpus[r * cs : (r + 1) * cs])
        if int(got[r].item()) & 0xFFFFFFFF != z:
            raise AssertionError(f"K7 row {r} disagrees with zlib")
    g = torch.Generator().manual_seed(2)
    rag = torch.randint(0, 256, (6, 5000), generator=g, dtype=torch.uint8)
    rlen = torch.tensor([0, 1, 255, 257, 4999, 5000], dtype=torch.int32)
    rg = CRC.crc32_batch_cuda(rag.to(dev), rlen.to(dev))
    err = max(err, max_abs([(rg, CRC.crc32_batch_plain(rag, rlen))]))
    for r in range(6):
        if int(rg[r].item()) & 0xFFFFFFFF != zlib.crc32(rag[r, : rlen[r]].numpy().tobytes()):
            raise AssertionError(f"K7 ragged row {r} disagrees with zlib")
    err = max(err, max_abs(checksum_edge_pairs(torch, dev, CRC.crc32_batch_cuda,
                                               CRC.crc32_batch_plain, zlib.crc32, CRC.THREADS,
                                               CRC.SEG, "K7")))
    if err:
        raise AssertionError(f"K7 disagrees with its plain version: max abs err {err}")
    nb = nfull * cs
    t0 = time.perf_counter()
    CRC.crc32_batch_plain(full, lens)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    rows["crc32_batch"] = dict(
        source="zlib_rs_tpu_torch/csrc/crc32.cu",
        replaces="zlib_rs_tpu/ops/pallas/crc_kernels.py:111",
        max_abs_err=err,
        ms=event_ms(torch, lambda: CRC.crc32_batch_cuda(full, lens), 50),
        queued_ms=queued_ms(torch, lambda: CRC.crc32_batch_cuda(full, lens)),
        plain_ms=plain_ms,
        # a table lookup, a shift and two xors a byte
        bnd=bound(nb + 8 * nfull, 4 * nb),
    )
    print(f"phase 9 K7: {nfull}x{cs}, 6x5000 ragged and the design's edge rows (lengths "
          f"{design_lengths(CRC.THREADS, CRC.SEG, CRC.THREADS * CRC.SEG + 100)} and all-0xFF "
          f"rows at misaligned starts) equal to plain and zlib; {CRC.THREADS} threads a row, "
          f"{CRC.SEG} bytes a thread a pass", flush=True)


def gzip_encode_phase(torch, corpus, launches) -> dict:
    """Phase 10: the gzip encode, one cold and three warm runs; K7
    launches once a call and the trailer is zlib's crc32."""
    import zlib_rs_tpu_torch as zt
    from zlib_rs_tpu_torch.ops.kernels import crc_kernels as CRC
    from zlib_rs_tpu_torch.parallel import pipeline as PL

    CRC.launches["crc32_batch"] = 0
    t0 = time.perf_counter()
    gz = zt.compress_parallel(corpus, LEVEL, window_bits=31)
    cold_s = time.perf_counter() - t0
    launches["crc32_batch"] = CRC.launches["crc32_batch"]
    if launches["crc32_batch"] != 1:
        raise AssertionError(f"the gzip encode launched K7 {launches['crc32_batch']} times")
    if zlib.decompress(gz, 31) != corpus or gz[-8:-4] != zlib.crc32(corpus).to_bytes(4, "little"):
        raise AssertionError("the gzip stream or its trailer is wrong")
    print(f"phase 10 gzip encode: {digest(gz)}, cold {cold_s:.3f} s, K7 launches 1",
          flush=True)
    return {"bytes_out": len(gz), "cold_s": cold_s, **warm_runs(
        torch, PL, lambda: zt.compress_parallel(corpus, LEVEL, window_bits=31), gz, len(corpus),
        "gzip encode", 10)}


def inflate_phases(torch, dev, corpus, idx_out, index, gz, gz_index, rows, launches) -> dict:
    """Phases 11-16: K6 against its plain version, the K6 route of the
    decode end to end, a stored-chunk index, the fail-safe, the
    checkpointed stream decode and the region decode."""
    import numpy as np

    import zlib_rs_tpu_torch as zt
    from zlib_rs_tpu_torch.ops.kernels import inflate_kernel as IK
    from zlib_rs_tpu_torch.parallel import inflate as RI
    from zlib_rs_tpu_torch.parallel import pipeline as PL

    bodies = [idx_out[off : off + ln] for off, ln, _ in index]
    sizes = [n for _, _, n in index]
    max_out = max(sizes)
    k = min(COMPARE_ROWS, len(bodies))
    result = {}

    # -- phase 11: K6 against its plain version ----------------------------
    level6 = _raw(corpus[:30_000])
    stored = _raw(corpus[40_000:60_000], level=0)
    lanes = [(b, n) for b, n in zip(bodies[:k], sizes[:k])] + [
        (stored, 20_000),
        (_raw(corpus[60_000:72_000], strategy=zlib.Z_FIXED), 12_000),
        (_raw(b""), 0),
        (_flip(level6, len(level6) // 2), 30_000),
        (_flip(level6, 1), 30_000),
        (level6[: len(level6) // 2], 30_000),
        (b"\x07" + level6[1:200], 30_000),
        (_flip(stored, 3), 20_000),
        (_raw(corpus[90_000:98_000], zdict=corpus[90_000:100_000]), 8_000),
        (level6, 29_999),
        (_raw(corpus[:40_000], level=9), 40_000),
    ]
    err, st = k6_against_plain(torch, dev, IK, [b for b, _ in lanes], [n for _, n in lanes], max_out)
    n_clean = k + 3
    if any(bad for _, bad in st[:n_clean]) or not all(bad for _, bad in st[n_clean + 1 :]):
        raise AssertionError(f"K6 lanes flagged wrongly: {st}")
    prime, region = corpus[200_000:232_768], corpus[232_768:260_000]
    primed = _raw(region, zdict=prime)
    many = _raw(corpus[300_000:330_000], mem=1)
    words, bits = IK.pack_streams_words([many])
    _o, cut, _b, start, _f = IK.decode_streams_plain(
        torch.from_numpy(words.view("i4")), torch.zeros(1, dtype=torch.int32),
        torch.from_numpy(bits), torch.tensor([7000], dtype=torch.int32), max_out=max_out,
        stop_at_target=True)
    cut, start = int(cut[0]), int(start[0])
    wlanes = [(primed, len(region), 0, prime), (many, 30_000 - cut, start, corpus[300_000 : 300_000 + cut]),
              (many, 5_000, 0, b""), (_flip(primed, 40), len(region), 0, prime)]
    win = np.zeros((len(wlanes), 32768), np.uint8)
    for i, (*_r, w) in enumerate(wlanes):
        if w:
            win[i, 32768 - len(w) :] = np.frombuffer(w[-32768:], np.uint8)
    err2, st2 = k6_against_plain(
        torch, dev, IK, [w[0] for w in wlanes], [w[1] for w in wlanes], max_out,
        start_bits=[w[2] for w in wlanes], win=torch.from_numpy(win), stop=True)
    err = max(err, err2)
    if err:
        raise AssertionError(f"K6 disagrees with its plain version: max abs err {err}")
    if st2[0] != (len(region), False) or st2[1][1] or st2[2][1]:
        raise AssertionError(f"K6 window/start-bit/stop lanes: {st2}")
    design = []
    for label, streams, out_lens, mo, windows, clean in k6_design_lanes(np, corpus, max_out):
        w = None
        if windows is not None:
            w = np.zeros((len(streams), 32768), np.uint8)
            for i, h in enumerate(windows):
                w[i, 32768 - len(h) :] = np.frombuffer(h, np.uint8)
            w = torch.from_numpy(w)
        e, st3 = k6_against_plain(torch, dev, IK, streams, out_lens, mo, win=w)
        if e or any(bad == clean for _, bad in st3):
            raise AssertionError(f"K6 lanes '{label}': max abs err {e}, (produced, bad) {st3}")
        design.append(f"{label} {[p for p, _ in st3]}")
        err = max(err, e)
    words, bits = IK.pack_streams_words(bodies)
    args = [torch.from_numpy(words.view("i4")).to(dev), torch.zeros(len(bodies), dtype=torch.int32, device=dev),
            torch.from_numpy(bits).to(dev), torch.tensor(sizes, dtype=torch.int32, device=dev)]
    got = IK.decode_streams_cuda(*args, max_out=max_out)
    out8 = got[0].cpu().numpy()
    if bool(got[2].any()) or b"".join(out8[r, : sizes[r]].tobytes() for r in range(len(bodies))) != corpus:
        raise AssertionError("the 256-chunk K6 launch is not the corpus")
    host_args = [a.cpu() for a in args]
    t0 = time.perf_counter()
    want = IK.decode_streams_plain(*host_args, max_out=max_out)
    plain_ms = (time.perf_counter() - t0) * 1e3
    err_all = k6_err(torch, got, want, max_out)
    if err_all:
        raise AssertionError(f"K6 over all {len(bodies)} chunks disagrees with its plain version: "
                             f"max abs err {err_all}")
    err = max(err, err_all)
    comp = sum(len(b) for b in bodies)
    rows["inflate"] = dict(
        source="zlib_rs_tpu_torch/csrc/inflate.cu",
        replaces="zlib_rs_tpu/ops/pallas/inflate_kernel.py:840",
        max_abs_err=err,
        ms=event_ms(torch, lambda: IK.decode_streams_cuda(*args, max_out=max_out), 5),
        plain_ms=plain_ms,
        # compressed bytes and meta in, output bytes and status out; about
        # 10 operations an output byte
        bnd=bound(comp + 48 * len(bodies) + len(corpus), 10 * len(corpus)),
    )
    print(f"phase 11 K6: {k} chunks and {len(lanes) - k} stored/fixed/empty/corrupt lanes, "
          f"{len(wlanes)} window/start-bit/stop lanes, and the design's lanes ("
          f"{'; '.join(design)} bytes) equal to plain; {len(bodies)} chunks in one launch equal "
          f"to plain and the corpus; launch: a block of 64 threads a stream, "
          f"{IK.SMEM_BYTES} bytes of dynamic shared memory", flush=True)

    # -- phase 12: the K6 route of the decode, end to end -----------------
    PL._FALLBACKS.clear()  # phase 8 counted its undersized cap
    os.environ["ZRS_TPU_VECTOR"] = "0"
    try:
        before = PL.fallback_stats()
        IK.launches["inflate"] = 0
        t0 = time.perf_counter()
        back = zt.decompress_parallel(idx_out, index)
        cold_s = time.perf_counter() - t0
        launches["inflate"] = IK.launches["inflate"]
        if back != corpus or launches["inflate"] != 1:
            raise AssertionError(f"the K6 route: corpus {back == corpus}, launches {launches['inflate']}")
        result["cold_s"] = cold_s
        for label, stream, ix in (("zlib", idx_out, index), ("gzip", gz, gz_index)):
            result[label] = warm_runs(torch, PL, lambda: zt.decompress_parallel(stream, ix),
                                      corpus, len(corpus), f"K6-route decode {label}", 12)
        if PL.fallback_stats() != before or before:
            raise AssertionError(f"the K6-route decode fell back: {PL.fallback_stats()}")
    finally:
        del os.environ["ZRS_TPU_VECTOR"]
    print(f"phase 12 e2e: cold {cold_s:.3f} s, K6 launches {launches['inflate']}, no fallback",
          flush=True)

    # -- phase 13: an index with stored chunks -----------------------------
    noise = np.random.default_rng(3).integers(0, 256, 4 * 32768, dtype=np.uint8).tobytes()
    mixed = corpus[: 2 * 1024 * 1024] + noise + corpus[-1024 * 1024 :]
    m_out, m_index = zt.compress_parallel(mixed, LEVEL, return_index=True)
    n_stored = sum(s is None for s in m_index.seeds)
    k0 = IK.launches["inflate"]
    if zt.decompress_parallel(m_out, m_index) != mixed or IK.launches["inflate"] != k0 + 1:
        raise AssertionError("the stored-chunk index did not decode through K6")
    if n_stored < 1 or PL.fallback_stats():
        raise AssertionError(f"stored chunks {n_stored}, fallbacks {PL.fallback_stats()}")
    print(f"phase 13 stored chunks: {len(m_index)} chunks, {n_stored} stored, decoded through "
          f"one K6 launch, no fallback", flush=True)

    # -- phase 14: a flipped byte raises, then a clean decode --------------
    t14 = time.perf_counter()
    broken = bytearray(idx_out)
    off, ln, _n = index[len(index) // 2]
    broken[off + ln // 2] ^= 0xFF
    why, raise_s, raise_stages = time_to_raise(
        torch, PL, lambda: zt.decompress_parallel(bytes(broken), index))
    result["flipped_raise_s"] = raise_s
    result["flipped_raise_stages_ms"] = raise_stages
    faults = PL.fallback_stats()
    PL._FALLBACKS.clear()
    torch.cuda.synchronize()
    if zt.decompress_parallel(idx_out, index) != corpus or PL.fallback_stats():
        raise AssertionError("the clean decode after the flipped byte failed")
    print(f"phase 14 fail-safe: a flipped byte raised ValueError ({why}) after {faults} in "
          f"{raise_s:.3f} s (stages, ms: {raise_stages}); a clean decode followed; "
          f"{time.perf_counter() - t14:.1f} s", flush=True)

    # -- phase 15: the checkpointed stream decode --------------------------
    raw = _raw(corpus)
    t0 = time.perf_counter()
    parts, states = [], []
    # a level-6 block holds up to 16,384 symbols: on this repeated tar it
    # can cover megabytes, past the default 256 KiB overshoot budget
    with kernel_events(torch, IK, ("decode_streams",)) as ev:
        for out_b, st in zt.device_decode_streaming(raw, step_bytes=1024 * 1024,
                                                    max_out=len(corpus)):
            parts.append(out_b)
            states.append(st)
    k6_ms = ev["decode_streams"]
    stream_s = time.perf_counter() - t0
    if b"".join(parts) != corpus or states[-1].adler != zlib.adler32(corpus):
        raise AssertionError("device_decode_streaming is not the corpus")
    result["streaming_s"] = stream_s
    result["streaming_k6_ms"] = k6_ms
    print(f"phase 15 checkpoints: {len(states)} steps of 1 MiB over a {len(raw)}-byte raw "
          f"stream equal the corpus, adler {states[-1].adler:#010x}, {stream_s:.3f} s, of which "
          f"K6 {sum(k6_ms):.3f} ms by CUDA events over {len(k6_ms)} launches "
          f"({', '.join(f'{x:.3f}' for x in k6_ms)})", flush=True)

    # -- phase 16: region decode with windows and sub-byte starts ---------
    r_bodies, r_sizes, r_windows, r_starts = [], [], [], []
    prev_bit, prev_out = 0, 0
    for out_b, st in zip(parts, states):
        r_bodies.append(raw[prev_bit >> 3 : (st.bit + 7) >> 3])
        r_starts.append(prev_bit & 7)
        r_sizes.append(len(out_b))
        r_windows.append(corpus[max(0, prev_out - 32768) : prev_out])
        prev_bit, prev_out = st.bit, st.produced
    t0 = time.perf_counter()
    with kernel_events(torch, IK, ("decode_streams",)) as ev:
        regions = RI.decompress_chunks(r_bodies, r_sizes, r_windows, r_starts, engine="kernel")
    k6_ms = ev["decode_streams"]
    region_s = time.perf_counter() - t0
    if b"".join(regions) != corpus or not any(r_starts):
        raise AssertionError("the primed regions are not the corpus")
    result["regions_s"] = region_s
    result["regions_k6_ms"] = k6_ms
    print(f"phase 16 regions: {len(regions)} regions, start bits {r_starts}, windows of 32 KiB, "
          f"equal the corpus in {region_s:.3f} s, of which K6 {sum(k6_ms):.3f} ms by CUDA events "
          f"over {len(k6_ms)} launch", flush=True)
    return result


def check_stream(torch, words4, mpos, mld, nmatch, n_valid, start: int, valid_from) -> int:
    """On the card: every lane's match stream tiles [start, n_valid) in
    order (each match at or after the previous one's end, 3 to 258 bytes,
    inside the span, never reaching before valid_from) and every match
    equals the bytes `dist` back. Returns the number of matches checked."""
    B, W = words4.shape
    Lp = 4 * W
    dev = words4.device
    C = mpos.shape[1]
    nm = nmatch.long()[:, None]
    slot = torch.arange(C, device=dev)[None, :]
    vm = slot < nm
    x = mld.long() & 0xFFFFFFFF
    ln = (x >> 15) + 3
    dist = (x & 0x7FFF) + 1
    mp = mpos.long()
    end = mp + ln
    prev_end = torch.cat([torch.full((B, 1), start, dtype=torch.long, device=dev), end[:, :-1]], 1)
    ok = ((mp >= prev_end) & (end <= n_valid.long()[:, None]) & (ln <= 258)
          & (mp - dist >= valid_from.long()[:, None]))
    if not bool((ok | ~vm).all()):
        raise AssertionError("a match stream does not tile its span")
    byte = words4.contiguous().view(torch.uint8).reshape(B, Lp).long()
    mark = torch.zeros((B, Lp + 1), dtype=torch.long, device=dev)
    mark.scatter_(1, torch.where(vm, mp, Lp).clamp(0, Lp), torch.where(vm, slot + 1, 0))
    owner = torch.cummax(mark[:, :Lp], dim=1).values - 1  # the match at or before p
    o = owner.clamp(min=0)
    pos = torch.arange(Lp, device=dev)[None, :]
    inside = (owner >= 0) & (pos < end.gather(1, o))
    src = (pos - dist.gather(1, o)).clamp(min=0)
    if not bool((byte == byte.gather(1, src))[inside].all()):
        raise AssertionError("a match differs from the bytes it copies")
    if int(inside.sum()) != int(torch.where(vm, ln, 0).sum()):
        raise AssertionError("the matches overlap")
    return int(nm.sum())


def k8_pairs(DK, inputs, got, r: int, knobs: dict) -> list:
    """(kernel, plain) pairs of chunk r of a K8 launch `got` = (mpos, mld,
    st) over `inputs` = (words4, n_valid, start, ins_from): nmatch, bad,
    candidates visited, then mpos and mld up to nmatch."""
    pm, pd, ps = DK.chain_scan_plain(*(x[r : r + 1] for x in inputs), **knobs)
    m = int(ps[0, 0])
    mpos, mld, st = got
    return [(st[r, :3], ps[0, :3]), (mpos[r, :m], pm[0, :m]), (mld[r, :m], pd[0, :m])]


def k9_crafted_lanes(torch, words, meta, C: int, dict_size: int):
    """K9 operands the corpus's streams do not give, on the batch's first
    three rows: chunk 0 with nmatch 0 (all literal), random bytes with
    nmatch 0, and chunk 2 with three matches about 12 kB apart (gaps far
    longer than a thread's share; length 258 at dist 32,768, codes 28 and
    29). Returns (words, mpos, mld, meta) on the batch's device."""
    dev = words.device
    w = words[:3].clone()
    g = torch.Generator().manual_seed(12)
    w[1] = torch.randint(-2**31, 2**31 - 1, (w.shape[1],), generator=g, dtype=torch.int64).to(
        device=dev, dtype=torch.int32)
    me = meta[:3].clone()
    me[:, 2] = torch.tensor([0, 0, 3], dtype=torch.int32, device=dev)
    mp = torch.zeros((3, C), dtype=torch.int32, device=dev)
    ml = torch.zeros((3, C), dtype=torch.int32, device=dev)
    mp[2, :3] = dict_size + torch.tensor([100, 12_000, 24_000], dtype=torch.int32, device=dev)
    ml[2, :3] = (255 << 15) | 32767
    return w, mp, ml, me


def encode_route_phases(torch, dev, corpus, batch, hop_out, rows, launches) -> dict:
    """Phases 17-20: K8 at levels 9 and 8 and K9 against their plain
    versions on the first super-batch, K10 on the same batch under level 6 with
    ZRS_TPU_HOPSCAN=0, then the chain route (levels 9 and 8) and the tab
    route of compress_parallel end to end. Fills `rows` and `launches` for
    K8-K10; returns the routes' end-to-end numbers."""
    import zlib_rs_tpu_torch as zt
    from zlib_rs_tpu_torch.ops import lzvec
    from zlib_rs_tpu_torch.ops.kernels import checksum_kernels as CK
    from zlib_rs_tpu_torch.ops.kernels import deflate_kernel as DK
    from zlib_rs_tpu_torch.parallel import pipeline as PL

    dc, dn, dv, dict_size = batch
    B = dc.shape[0]
    words4 = DK.words_from_bytes(dc)
    span = (dn - dv).long()  # the bytes a chunk's scan reads: dict and data
    out_span = (dn - dict_size).long()  # the bytes it parses
    starts = torch.full((B,), dict_size, dtype=torch.int32, device=dev)

    # -- phase 17: K8 against its plain version (levels 9 and 8) -----------
    # at level 9 chunk 0 and the chunk that visits the most candidates come
    # first, then the rest of the batch while the budget lasts; at level 8
    # that chunk (and level 8's own, if another)
    good, mlazy, nice, chain = PL._level_knobs(9)["kernel_cfg"]
    k8 = dict(depth=chain, nice=nice, good=good, max_lazy=mlazy)
    mpos, mld, st = DK.chain_scan_cuda(words4, dn, starts, dv, **k8)
    torch.cuda.synchronize()
    worst = int(st[:, 2].argmax())
    order = [0] + [worst] * (worst != 0) + [r for r in range(1, B) if r != worst]
    pairs, k = [], 0
    t0 = time.perf_counter()
    while k < B and (k < 2 or time.perf_counter() - t0 < PLAIN_K8_BUDGET_S):
        pairs += k8_pairs(DK, (words4, dn, starts, dv), (mpos, mld, st), order[k], k8)
        k += 1
    plain_s = time.perf_counter() - t0
    g8, m8, n8, c8 = PL._level_knobs(8)["kernel_cfg"]
    k8_l8 = dict(depth=c8, nice=n8, good=g8, max_lazy=m8)
    got8 = DK.chain_scan_cuda(words4, dn, starts, dv, **k8_l8)
    torch.cuda.synchronize()
    worst8 = sorted({worst, int(got8[2][:, 2].argmax())})
    t0 = time.perf_counter()
    for r in worst8:
        pairs += k8_pairs(DK, (words4, dn, starts, dv), got8, r, k8_l8)
    plain8_s = time.perf_counter() - t0
    err = max_abs(pairs)
    if err:
        raise AssertionError(f"K8 disagrees with its plain version: max abs err {err}")
    nmatch, bad = st[:, 0], st[:, 1] > 0
    if bool(bad.any()) or bool((got8[2][:, 1] > 0).any()):
        raise AssertionError("K8 flags a chunk of the corpus bad")
    n_checked = check_stream(torch, words4, mpos, mld, nmatch, dn, dict_size, dv)
    n_checked += check_stream(torch, words4, got8[0], got8[1], got8[2][:, 0], dn, dict_size, dv)
    visits = st[:, 2].long()
    nml = nmatch.long()
    ms8 = event_ms(torch, lambda: DK.chain_scan_cuda(words4, dn, starts, dv, **k8_l8), 5)
    rows["chain_scan"] = dict(
        source="zlib_rs_tpu_torch/csrc/chain_scan.cu",
        replaces="zlib_rs_tpu/ops/pallas/deflate_kernel.py:1098",
        max_abs_err=err,
        ms=event_ms(torch, lambda: DK.chain_scan_cuda(words4, dn, starts, dv, **k8), 5),
        plain_ms=plain_s * 1e3, plain_rows=k,
        # the chunk read once, the match stream and status written once;
        # ~6 operations a chain candidate visited, ~10 a position hashed
        bnd=bound(int((span + 8 * nml + 32).sum()), int((6 * visits + 10 * span).sum())),
    )
    print(f"phase 17 K8 (level 9): {k} chunks equal to plain in {plain_s:.1f} s (nmatch, bad, "
          f"candidates, mpos, mld), chunk 0 and chunk {worst} ({int(visits[worst])} "
          f"candidates, the most) first; level 8: chunk(s) {worst8} "
          f"({[int(got8[2][r, 2]) for r in worst8]} candidates) equal to plain in "
          f"{plain8_s:.1f} s; all {B} streams of both levels tile their spans, {n_checked} "
          f"matches byte-valid on the card; level 9 visits {int(visits.sum())} candidates; "
          f"K8 ms a launch: level 9 {rows['chain_scan']['ms']:.3f}, level 8 {ms8:.3f}",
          flush=True)

    # -- phase 18: K9 against its plain version ---------------------------
    # level 9's stream, level 8's, then the crafted lanes of k9_crafted_lanes
    # (phase 19 adds the tab route's stream)
    nm_eff = torch.where(bad, 0, nmatch)
    words, meta, _oww = DK.pack_inputs(dc, dn, dict_size, nm_eff, 0)
    got = DK.freq_cuda(words, mpos, mld, meta)
    want = DK.freq_plain(words, mpos, mld, meta)
    meta8 = meta.clone()
    meta8[:, 2] = torch.where(got8[2][:, 1] > 0, 0, got8[2][:, 0])
    lanes = k9_crafted_lanes(torch, words, meta, mpos.shape[1], dict_size)
    err = max_abs([(got, want), (DK.freq_cuda(words, got8[0], got8[1], meta8),
                                 DK.freq_plain(words, got8[0], got8[1], meta8)),
                   (DK.freq_cuda(*lanes), DK.freq_plain(*lanes))])
    if err:
        raise AssertionError(f"K9 disagrees with its plain version: max abs err {err}")
    lens = torch.where(torch.arange(mpos.shape[1], device=dev)[None, :] < nm_eff.long()[:, None],
                       ((mld.long() & 0xFFFFFFFF) >> 15) + 3, 0).sum(1)
    if not torch.equal(got[:, :256].long().sum(1) + lens, out_span):
        raise AssertionError("K9's literals and the match lengths do not cover the spans")
    lits = got[:, :256].long().sum(1)
    rows["freq"] = dict(
        source="zlib_rs_tpu_torch/csrc/freq.cu",
        replaces="zlib_rs_tpu/ops/pallas/deflate_kernel.py:1517",
        max_abs_err=err,
        ms=event_ms(torch, lambda: DK.freq_cuda(words, mpos, mld, meta), 20),
        queued_ms=queued_ms(torch, lambda: DK.freq_cuda(words, mpos, mld, meta)),
        plain_ms=event_ms(torch, lambda: DK.freq_plain(words, mpos, mld, meta), 3),
        # the gap (literal) bytes, the match stream and meta in, 320 bins
        # out; a shared atomic a literal, two and the code arithmetic a match
        bnd=bound(int((lits + 8 * nml + 32 + 4 * 320).sum()), int((3 * lits + 30 * nml).sum())),
    )
    print(f"phase 18 K9: {B} chunks of levels 9 and 8, all 320 bins equal to plain; literals "
          f"and matches cover every span; crafted lanes (nmatch 0 on a chunk and on random "
          f"bytes, three matches 12 kB apart) equal to plain; ms a launch "
          f"{rows['freq']['ms']:.6f} by events, {rows['freq']['queued_ms']:.6f} queued",
          flush=True)

    # -- phase 19: K10 against its plain version (level 6, HOPSCAN=0) ------
    os.environ["ZRS_TPU_HOPSCAN"] = "0"
    try:
        cfg6 = PL._level_knobs(6)["kernel_cfg"]
        variant, w_g = PL._resolve_kernel_variant(cfg6)
    finally:
        del os.environ["ZRS_TPU_HOPSCAN"]
    if variant != "tab":
        raise AssertionError(f"level 6 with ZRS_TPU_HOPSCAN=0 resolves to {variant}")
    good, mlazy, nice, chain = cfg6
    tabf, tabq = lzvec.build_match_tables(words4, dn, dv, depth=chain, nice=nice, w_g=w_g,
                                          bytes_arr=dc)
    tf, tq = tabf[:, dict_size:], tabq[:, dict_size:]
    kt = dict(nice=nice, good=good, max_lazy=mlazy)
    tpos, tmld, tst = DK.tab_scan_cuda(words4, tf, tq, dn, dict_size, **kt)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ppos, pmld, pst = DK.tab_scan_plain(words4, tf, tq, dn, dict_size, **kt)
    tab_plain_s = time.perf_counter() - t0
    pairs = tab_pairs((tpos, tmld, tst), (ppos, pmld, pst), DK.CAP_M)
    # the batch again in tiles of MIN_TILE, then the crafted lanes (start
    # 0): an overflow lane past one tile (a 3-byte distance-1 match at every
    # position of random bytes, level-9 knobs), three all-literal lanes
    # (tables all zero), and two chunks whose every dist is past the
    # window (0xFFFF: the serial walk)
    pairs += tab_pairs(DK.tab_scan_cuda(words4, tf, tq, dn, dict_size, tile=DK.MIN_TILE, **kt),
                       (ppos, pmld, pst), DK.CAP_M)
    g9, m9, n9, _c9 = DK.ZLIB_CONFIG[9]
    k9 = dict(nice=n9, good=g9, max_lazy=m9)
    n_over = 3 * DK.CAP_M + 600
    over = DK.words_from_bytes(random_rows(torch, DK, [n_over], 3)).to(dev)
    over_tab = torch.full((1, 4 * over.shape[1]), (3 << 16) | 1, dtype=torch.int32, device=dev)
    lit_lens = [5001, 6002, 7003]
    lit = DK.words_from_bytes(random_rows(torch, DK, lit_lens, 8)).to(dev)
    lit_tab = torch.zeros((3, 4 * lit.shape[1]), dtype=torch.int32, device=dev)
    far_f = torch.where(tf[:2] != 0, tf[:2] | 0xFFFF, 0)
    far_q = torch.where(tq[:2] != 0, tq[:2] | 0xFFFF, 0)
    crafted = [
        ((over, over_tab, over_tab, torch.tensor([n_over], device=dev), 0), k9),
        ((lit, lit_tab, lit_tab, torch.tensor(lit_lens, device=dev), 0), kt),
        ((words4[:2], far_f, far_q, dn[:2], dict_size), kt),
    ]
    # the level-9 knob set of the tab route (ZRS_TPU_CHAIN=256: max_lazy 258)
    os.environ["ZRS_TPU_CHAIN"] = "256"
    try:
        cfg9 = PL._level_knobs(9)["kernel_cfg"]
        variant9, w_g9 = PL._resolve_kernel_variant(cfg9)
    finally:
        del os.environ["ZRS_TPU_CHAIN"]
    if variant9 != "tab" or cfg9[1] != 258:
        raise AssertionError(f"level 9 with ZRS_TPU_CHAIN=256 resolves to {variant9}, {cfg9}")
    f9, q9 = lzvec.build_match_tables(words4[:8], dn[:8], dv[:8], depth=cfg9[3], nice=cfg9[2],
                                      w_g=w_g9, bytes_arr=dc[:8])
    crafted.append(((words4[:8], f9[:, dict_size:], q9[:, dict_size:], dn[:8], dict_size),
                     dict(nice=cfg9[2], good=cfg9[0], max_lazy=cfg9[1])))
    bads = []
    for lanes, knobs in crafted:
        want_c = DK.tab_scan_plain(*lanes, **knobs)
        pairs += tab_pairs(DK.tab_scan_cuda(*lanes, **knobs), want_c, DK.CAP_M)
        bads.append(int(want_c[2][:, 1].sum()))
    if bads != [1, 0, 0, 0]:
        raise AssertionError(f"K10's crafted lanes: bad lanes {bads}, want the overflow lane only")
    err = max_abs(pairs)
    if err:
        raise AssertionError(f"K10 disagrees with its plain version: max abs err {err}")
    if bool((tst[:, 1] > 0).any()):
        raise AssertionError("K10 flags a chunk of the corpus bad")
    tmeta = meta.clone()
    tmeta[:, 2] = tst[:, 0]
    k9_err = max_abs([(DK.freq_cuda(words, tpos, tmld, tmeta),
                       DK.freq_plain(words, tpos, tmld, tmeta))])
    if k9_err:
        raise AssertionError(f"K9 disagrees with its plain version on the tab route's stream: "
                             f"max abs err {k9_err}")
    t_checked = check_stream(torch, words4, tpos, tmld, tst[:, 0], dn, dict_size, dv)
    tnm = tst[:, 0].long()
    tlens = torch.where(torch.arange(tmld.shape[1], device=dev)[None, :] < tnm[:, None],
                        ((tmld.long() & 0xFFFFFFFF) >> 15) + 3, 0).sum(1)
    visited = out_span - tlens + tnm  # the walk's stops: each literal, each match
    rows["tab_scan"] = dict(
        source="zlib_rs_tpu_torch/csrc/tab_scan.cu",
        replaces="zlib_rs_tpu/ops/pallas/deflate_kernel.py:1036",
        max_abs_err=err,
        ms=event_ms(torch, lambda: DK.tab_scan_cuda(words4, tf, tq, dn, dict_size, **kt), 5),
        plain_ms=tab_plain_s * 1e3, plain_rows=B,
        # tabf at every stop and tabq once a match, the parsed span's words
        # once, the match stream written once; ~10 operations a stop, ~20 a
        # match
        bnd=bound(int((4 * visited + 4 * tnm + out_span + 8 * tnm + 32).sum()),
                  int((10 * visited + 20 * tnm).sum())),
    )
    print(f"phase 19 K10 (level 6, HOPSCAN=0, w_g {w_g}): {B} chunks equal to plain at tiles "
          f"of {DK.TILE} and {DK.MIN_TILE} positions, and an overflow lane past one tile, "
          f"all-literal lanes, far dists (the serial walk) and the level-9 knob set under "
          f"ZRS_TPU_CHAIN=256 on 8 chunks; {t_checked} matches tile their spans and are "
          f"byte-valid on the card; launch: {DK.RESOLVE_THREADS} threads a block, "
          f"{4 * DK.TILE} bytes of dynamic shared memory, tile {DK.TILE}; K9 on its stream "
          f"equal to plain", flush=True)

    # -- phase 20: the chain and tab routes, end to end --------------------
    result = {}
    for label, level, env, kernels, absent in (
        ("level9", 9, {}, ("chain_scan", "freq", "pack", "adler32_batch"),
         ("hop_chase", "hop_chase_il", "tab_scan")),
        ("level8", 8, {}, ("chain_scan", "freq", "pack", "adler32_batch"),
         ("hop_chase", "hop_chase_il", "tab_scan")),
        ("level6_hopscan0", 6, {"ZRS_TPU_HOPSCAN": "0"}, ("tab_scan", "freq", "pack", "adler32_batch"),
         ("hop_chase", "hop_chase_il", "chain_scan")),
    ):
        os.environ.update(env)
        try:
            for name in DK.launches:
                DK.launches[name] = 0
            CK.launches["adler32_batch"] = 0
            t0 = time.perf_counter()
            out = zt.compress_parallel(corpus, level)
            cold_s = time.perf_counter() - t0
            seen = dict(DK.launches, adler32_batch=CK.launches["adler32_batch"])
            if min(seen[n] for n in kernels) < 1 or max(seen[n] for n in absent) > 0:
                raise AssertionError(f"{label}: launches {seen}")
            if zlib.decompress(out) != corpus:
                raise AssertionError(f"the {label} stream does not decode to the corpus")
            warm = warm_runs(torch, PL, lambda: zt.compress_parallel(corpus, level), out,
                             len(corpus), label, 20)
        finally:
            for name in env:
                del os.environ[name]
        zref = len(zlib.compress(corpus, level))
        result[label] = {"bytes_out": len(out), "zlib_bytes": zref, "ratio_to_zlib": len(out) / zref,
                         "cold_s": cold_s, **warm, "launches": seen}
        if label == "level9":
            launches["chain_scan"], launches["freq"] = seen["chain_scan"], seen["freq"]
        if label == "level6_hopscan0":
            launches["tab_scan"] = seen["tab_scan"]
            result[label]["equals_hop_stream"] = out == hop_out
        print(f"phase 20 {label}: {len(corpus)} -> {digest(out)}, ratio to zlib-{level} "
              f"{len(out) / zref:.6f} ({zref} bytes), cold {cold_s:.3f} s, launches {seen}",
              flush=True)
    print(f"phase 20: the tab-route stream equals phase 4's hop-route stream: "
          f"{result['level6_hopscan0']['equals_hop_stream']}", flush=True)
    return result


def single_plane_phases(torch, dev, corpus, idx_out, index, gz, gz_index, rows, launches) -> dict:
    """Phases 21-23: K11a and K11b against their plain versions on the
    indexed stream's chunks, then the single-plane route of the decode
    (ZRS_VECTOR_TWOPLANE=0) end to end on the zlib and gzip streams, and
    its fail-safe. Fills `rows` and `launches` for K11a and K11b; returns
    the route's end-to-end numbers."""
    import zlib_rs_tpu_torch as zt
    from zlib_rs_tpu_torch.ops.kernels import vhuff_kernel as VK
    from zlib_rs_tpu_torch.parallel import pipeline as PL
    from zlib_rs_tpu_torch.parallel import vector_inflate as VI

    bodies, sizes, seeds, staged, meta, full_args, sub_args = stage_decode(VI, idx_out, index, dev)
    S, K, B, cap = meta["S"], meta["K"], meta["B"], meta["cap"]
    W = B * S
    k = min(COMPARE_ROWS, B)

    # -- phase 21: K11a against its plain version --------------------------
    # all chunks clean, then the edges of decode_edge_pairs: flipped words,
    # an undersized cap and a damaged index on the first chunks
    full, edge, bad_runs, blocks = decode_edge_pairs(
        torch, VK, VK.decode_tokens_vector_cuda, VK.decode_tokens_vector_plain, full_args,
        sub_args, S, K, cap)
    bad_tapes = [run[0] for run in bad_runs]
    want, plain_ms = timed_ms(
        torch, lambda: VK.decode_tokens_vector_plain(*full_args, S=S, K=K, cap=cap))
    err = max_abs(list(zip(full, want)) + edge)
    if err:
        raise AssertionError(f"K11a disagrees with its plain version: max abs err {err}")
    tape, _cons, bad, rem = full
    if int(bad.abs().sum()) or int(rem.abs().sum()):
        raise AssertionError("K11a flags walkers of the clean stream")
    used_rows = int((tape != 0).sum())
    # as K4's: the body bytes, the tables, three walker arrays in, the tape
    # rows used (one word each) and three walker arrays out
    body_bytes = sum(len(b) for b in bodies) + 4 * staged["tables"].numel()
    nb = body_bytes + 3 * 4 * W + 4 * used_rows + 3 * 4 * W
    decode1 = lambda: VK.decode_tokens_vector_cuda(*full_args, S=S, K=K, cap=cap)
    rows["vhuff_decode1"] = dict(
        source="zlib_rs_tpu_torch/csrc/vhuff_decode.cu",
        replaces="zlib_rs_tpu/ops/pallas/vhuff_kernel.py:722",
        max_abs_err=err,
        ms=event_ms(torch, decode1, 20),
        queued_ms=queued_ms(torch, decode1),
        plain_ms=plain_ms,
        # four cascade lookups (~30 operations each) and ~80 more a row
        bnd=bound(nb, 200 * used_rows),
    )
    print(f"phase 21 K11a: {B} chunks, {W} walkers, K {K}, cap {cap}, {used_rows} rows: tape, "
          f"cons, bad and rem equal to plain, none flagged; the first {k} chunks with flipped "
          f"words, with cap {UNDERSIZED_CAP} and with a damaged index equal to plain; blocks "
          f"staged/global {blocks}; ms a launch {rows['vhuff_decode1']['ms']:.6f} by events, "
          f"{rows['vhuff_decode1']['queued_ms']:.6f} queued", flush=True)

    # -- phase 22: K11b against its plain version --------------------------
    # all chunks (every one through the chase), then the edges of
    # k11b_edge_pairs: phase 21's corrupt tapes, a random tape, a 128-hop
    # chain, rows past the chase
    out_words = -(-max(sizes) // 4) + 2
    offs = staged["offs"]
    branch = torch.full((B,), -1, dtype=torch.int32, device=dev)
    outw = VK.expand_tokens_cuda(tape, offs, out_words=out_words, branch=branch)
    want, plain_ms = timed_ms(
        torch, lambda: VK.expand_tokens_plain(tape, offs, out_words=out_words))
    err = bytes_err(torch, outw, want, sizes)
    main_bodies = {int(b): int(n) for b, n in zip(*torch.unique(branch, return_counts=True))}
    if (branch != VK.BRANCH_CHASE).any():
        raise AssertionError(f"K11b chunks of the clean stream left the chase: {main_bodies}")
    full8 = outw.cpu().numpy().view("u1")
    if b"".join(full8[r, : sizes[r]].tobytes() for r in range(B)) != corpus:
        raise AssertionError("the full K11b expansion is not the corpus")
    edge, bodies_seen = k11b_edge_pairs(torch, VK, dev, tape, offs, sizes, bad_tapes, k)
    err = max(err, max_abs((torch.from_numpy(g), torch.from_numpy(w)) for g, w in edge))
    if err:
        raise AssertionError(f"K11b disagrees with its plain version: max abs err {err}")
    nb = 4 * used_rows + 4 * offs.numel() + len(corpus)
    expand1 = lambda: VK.expand_tokens_cuda(tape, offs, out_words=out_words)
    rows["vhuff_expand1"] = dict(
        source="zlib_rs_tpu_torch/csrc/vhuff_expand.cu",
        replaces="zlib_rs_tpu/ops/pallas/vhuff_kernel.py:688",
        max_abs_err=err,
        ms=event_ms(torch, expand1, 50),
        queued_ms=queued_ms(torch, expand1),
        plain_ms=plain_ms,
        # a funnel store a literal row, a match copy a match row: ~40 operations a row
        bnd=bound(nb, 40 * used_rows),
    )
    names = {VK.BRANCH_CHASE: "chase", VK.BRANCH_UNTILED: "serial (untiled)",
             VK.BRANCH_TOO_LARGE: "serial (too large)"}
    print(f"phase 22 K11b: {B} chunks equal to plain and expand to the corpus, bodies "
          f"{ {names[b]: n for b, n in main_bodies.items()} }; edge chunks (phase 21's "
          f"corrupt tapes, a random tape with a damaged index, a 128-hop chain, a 38400-byte "
          f"chunk, rows of {VK.CHASE_MAX_ROW + 32} and 240000 bytes) equal to plain, bodies "
          f"{ {names[b]: n for b, n in bodies_seen.items()} }; ms a launch "
          f"{rows['vhuff_expand1']['ms']:.6f} by events, "
          f"{rows['vhuff_expand1']['queued_ms']:.6f} queued", flush=True)

    # -- phase 23: the single-plane route of the decode, end to end --------
    os.environ["ZRS_VECTOR_TWOPLANE"] = "0"
    try:
        before = PL.fallback_stats()
        for name in VK.launches:
            VK.launches[name] = 0
        t0 = time.perf_counter()
        back = zt.decompress_parallel(idx_out, index)
        cold_s = time.perf_counter() - t0
        seen = dict(VK.launches)
        if back != corpus:
            raise AssertionError("the single-plane decode does not return the corpus")
        if min(seen["vhuff_decode1"], seen["vhuff_expand1"]) < 1 or (
                seen["vhuff_decode"] + seen["vhuff_expand"]):
            raise AssertionError(f"the single-plane decode launched {seen}")
        launches["vhuff_decode1"], launches["vhuff_expand1"] = (
            seen["vhuff_decode1"], seen["vhuff_expand1"])
        result = {"cold_s": cold_s}
        for label, stream, ix in (("zlib", idx_out, index), ("gzip", gz, gz_index)):
            result[label] = warm_runs(torch, PL, lambda: zt.decompress_parallel(stream, ix),
                                      corpus, len(corpus), f"single-plane decode {label}", 23)
        if PL.fallback_stats() != before or before:
            raise AssertionError(f"the single-plane decode fell back: {PL.fallback_stats()}")
        broken = list(bodies)
        hit = B // 2
        broken[hit] = _flip(broken[hit], len(broken[hit]) // 2)
        try:
            VI.decode_chunks_vector(broken, sizes, seeds, device=dev)
        except VI.VectorDataFault as e:
            why = str(e)
        else:
            raise AssertionError("a flipped body byte decoded without a VectorDataFault")
    finally:
        del os.environ["ZRS_VECTOR_TWOPLANE"]
    print(f"phase 23 single-plane e2e: cold {cold_s:.3f} s, launches {seen}, no fallback; a "
          f"flipped byte in chunk {hit} raised VectorDataFault ({why})", flush=True)
    return result


def pack_crafted_lanes(torch, DK, dev, width: int, dict_size: int, C: int):
    """K3 operands the corpus does not give, at the main path's buffer
    width: an empty chunk, an all-literal chunk, a run of 258-byte dist-1
    matches, and random bytes under tables whose every code is 15 bits
    (near the 16 bits a position K3's word buffer is sized for). Returns
    (chunks u8 [4, width], n_valid, nmatch, mpos, mld, lltab, dtab) on `dev`."""
    span = min(32768, width - dict_size - DK.PAD)
    g = torch.Generator().manual_seed(11)
    chunks = torch.randint(0, 256, (4, width), generator=g, dtype=torch.uint8)
    chunks[2] = 97
    n_valid = torch.tensor([dict_size] + [dict_size + span] * 3, dtype=torch.int32)
    mpos = torch.zeros((4, C), dtype=torch.int32)
    mld = torch.zeros((4, C), dtype=torch.int32)
    runs = torch.arange(dict_size + 1, dict_size + span - 257, 258, dtype=torch.int32)
    mpos[2, : len(runs)] = runs
    mld[2, : len(runs)] = 255 << 15  # length 258, dist 1
    nmatch = torch.tensor([0, 0, len(runs), 0], dtype=torch.int32)
    words, meta, _oww = DK.pack_inputs(chunks, n_valid, dict_size, nmatch, 0)
    lltab, dtab = DK.code_tables(DK.freq_plain(words, mpos, mld, meta))
    codes = torch.randint(0, 1 << 15, (288,), generator=g, dtype=torch.int32)
    lltab[3] = codes | (15 << 16)
    dtab[3] = codes[:32] | (15 << 16)
    return [t.to(dev) for t in (chunks, n_valid, nmatch, mpos, mld, lltab, dtab)]


def pack_pairs(DK, chunks, n_valid, dict_size: int, nmatch, mpos, mld, lltab, dtab,
               n_seeds: int) -> list:
    """(got, want) pairs of a K3 launch against its plain version: total,
    bad, the echoed lengths, both seed rows when there are seeds, and each
    chunk's words through its slack word."""
    words, meta, oww = DK.pack_inputs(chunks, n_valid, dict_size, nmatch, n_seeds)
    args = (words, mpos, mld, meta, lltab, dtab, oww, n_seeds)
    ko, po = DK.pack_cuda(*args), DK.pack_plain(*args)
    pairs = [(ko[1][:, :2], po[1][:, :2]), (ko[4] >> 16, po[4] >> 16)]
    if n_seeds:
        pairs += [(ko[2], po[2]), (ko[3], po[3])]
    for r in range(chunks.shape[0]):
        nw = min(int(po[1][r, 0]) // 32 + 2, oww)
        pairs.append((ko[0][r, :nw], po[0][r, :nw]))
    return pairs


def two_plane_tapes(np, walkers):
    """Row-major two-plane tapes [cap, S] and offs [1, S + 1] of one chunk
    from its walkers, each a list of rows (literal bytes, match length,
    dist), offsets running on from 0."""
    S = len(walkers)
    cap = max(len(w) for w in walkers) + 1
    ta = np.zeros((cap, S), np.uint32)
    tb = np.zeros((cap, S), np.uint32)
    offs = np.zeros((1, S + 1), np.int32)
    for s, rows in enumerate(walkers):
        n = 0
        for t, (lits, length, dist) in enumerate(rows):
            ta[t, s] = int.from_bytes(lits.ljust(4, b"\0"), "little")
            tb[t, s] = len(lits) | ((8 | ((length - 3) << 4) | (dist << 12)) if length else 0)
            n += len(lits) + length
        offs[0, s + 1] = offs[0, s] + n
    return ta.view(np.int32), tb.view(np.int32), offs


def single_plane_tape(np, walkers):
    """A row-major single-plane tape [cap, S] and offs [1, S + 1] of one
    chunk from its walkers, each a list of tokens (literal bytes, 1-3 of
    them, or (match length, dist)), offsets running on from 0."""
    S = len(walkers)
    tape = np.zeros((max(len(w) for w in walkers) + 1, S), np.uint32)
    offs = np.zeros((1, S + 1), np.int32)
    for s, toks in enumerate(walkers):
        n = 0
        for t, tok in enumerate(toks):
            if isinstance(tok, bytes):
                tape[t, s] = (1 << 30) | ((len(tok) - 1) << 24) | int.from_bytes(tok, "little")
                n += len(tok)
            else:
                tape[t, s] = (2 << 30) | ((tok[0] - 3) << 16) | tok[1]
                n += tok[0]
        offs[0, s + 1] = offs[0, s] + n
    return tape.view(np.int32), offs


def expand_edge_pairs(torch, VK, dev, cuda, plain, label, tapes, offs, sizes, bad_tapes, k,
                      rnd, chain, long_chunk):
    """(got, want) pairs of an expansion (K5 or K11b: `cuda`, `plain`)
    against its plain version on what the corpus's clean tapes do not
    give, and the count of chunks that took each body: the first k
    chunks' corrupt tapes (full rows where the serial body ran, [0, size)
    elsewhere), a random tape with a damaged index (full rows; every chunk
    must take the serial body), a chunk of dist-1 runs chained through all
    128 walkers (128 hops deep; the chase), and, on full rows, the serial
    body for what is past the chase: a chunk of 38,400 bytes, the first k
    chunks in rows of more than CHASE_MAX_ROW bytes (in shared memory) and
    2 in rows past shared memory (in device memory). Each tape argument is
    a tuple of planes; `rnd` = (planes, offs) of the random tape."""
    counts = {}
    pairs = []

    def run(planes, of, out_words, full_rows, sz=None):
        branch = torch.full((of.shape[0],), -1, dtype=torch.int32, device=dev)
        got = cuda(*planes, of, out_words=out_words, branch=branch)
        want = plain(*planes, of, out_words=out_words)
        for r, b in enumerate(branch.tolist()):
            counts[b] = counts.get(b, 0) + 1
            n = 4 * out_words if full_rows or b != VK.BRANCH_CHASE else sz[r]
            pairs.append((got[r].cpu().numpy().view("u1")[:n], want[r].cpu().numpy().view("u1")[:n]))
        return branch, got

    out_words = -(-max(sizes) // 4) + 2
    S = offs.shape[1] - 1
    for planes in bad_tapes:
        run([t[:, : k * S] for t in planes], offs[:k], out_words, False, sizes)
    if not counts.get(VK.BRANCH_UNTILED):
        raise AssertionError(f"no corrupt {label} chunk took the serial body")
    branch, _ = run(rnd[0], rnd[1], 20, True)
    if (branch != VK.BRANCH_UNTILED).any():
        raise AssertionError(f"a random {label} tape took the chase: {branch.tolist()}")
    *planes, of = (torch.from_numpy(a).to(dev) for a in chain)
    n_deep = int(of[0, -1])
    branch, got = run(planes, of, -(-n_deep // 4) + 2, False, [n_deep])
    if int(branch[0]) != VK.BRANCH_CHASE or bytes(
            got[0].cpu().numpy().view("u1")[:n_deep]) != b"x" * n_deep:
        raise AssertionError(f"{label}: the 128-hop dist-1 chain did not expand through the chase")
    *planes, of = (torch.from_numpy(a).to(dev) for a in long_chunk)
    for args in ((planes, of, -(-int(of[0, -1]) // 4) + 2),
                 ([t[:, : k * S] for t in tapes], offs[:k], VK.CHASE_MAX_ROW // 4 + 8),
                 ([t[:, : 2 * S] for t in tapes], offs[:2], 60000)):
        branch, _ = run(*args, True)
        if (branch != VK.BRANCH_TOO_LARGE).any():
            raise AssertionError(f"a {label} chunk past the chase took {branch.tolist()}")
    return pairs, counts


def k5_edge_pairs(torch, VK, dev, tapeA, tapeB, offs, sizes, bad_tapes, k: int):
    """expand_edge_pairs for K5, on two-plane tapes."""
    import numpy as np

    g = torch.Generator().manual_seed(6)
    rnd = [torch.randint(-2**31, 2**31 - 1, (16, 16), generator=g, dtype=torch.int64)
           .to(torch.int32).to(dev) for _ in range(2)]
    roffs = torch.sort(torch.randint(-50, 400, (2, 9), generator=g), dim=1).values.to(torch.int32)
    roffs[1, 3] = 2**31 - 8
    return expand_edge_pairs(
        torch, VK, dev, VK.expand_tokens2_cuda, VK.expand_tokens2_plain, "K5", (tapeA, tapeB),
        offs, sizes, bad_tapes, k, (rnd, roffs.to(dev)),
        two_plane_tapes(np, [[(b"x", 200, 1)]] + [[(b"", 200, 1)]] * 127),
        two_plane_tapes(np, [[(b"y", 299, 1)]] + [[(b"", 300, 1)]] * 127))


def k11b_edge_pairs(torch, VK, dev, tape, offs, sizes, bad_tapes, k: int):
    """expand_edge_pairs for K11b, on single-plane tapes: phase 21's
    corrupt tapes, and a random tape (every third column LIT tokens, for
    literal sprints) with a damaged index."""
    import numpy as np

    g = torch.Generator().manual_seed(5)
    rtape = torch.randint(-2**31, 2**31, (16, 16), generator=g, dtype=torch.int64)
    rtape[:, ::3] = (rtape[:, ::3] & 0x3FFFFFFF) | (VK.VTOK_LIT << 30)
    rtape = ((rtape + 2**31) % 2**32 - 2**31).to(torch.int32)
    roffs = torch.sort(torch.randint(-50, 400, (2, 9), generator=g), dim=1).values.to(torch.int32)
    roffs[1, 3] = 2**31 - 8
    return expand_edge_pairs(
        torch, VK, dev, VK.expand_tokens_cuda, VK.expand_tokens_plain, "K11b", (tape,), offs,
        sizes, [(t,) for t in bad_tapes], k, ((rtape.to(dev),), roffs.to(dev)),
        single_plane_tape(np, [[b"x", (200, 1)]] + [[(200, 1)]] * 127),
        single_plane_tape(np, [[b"y", (299, 1)]] + [[(300, 1)]] * 127))


def hop_pairs(cuda, plain, lanes, cap_m: int) -> list:
    """(got, want) pairs of a K2 or K12 launch on `lanes` against its plain
    version: nmatch and bad, every bin of every bank, each lane's match
    slots (up to the overflow slot)."""
    got, want = cuda(*lanes), plain(*lanes)
    pairs = [(got[2][:, :2], want[2][:, :2]), (got[3], want[3])]
    for r in range(lanes[0].shape[0]):
        m = min(int(want[2][r, 0]), cap_m + 1)
        pairs += [(got[0][r, :m], want[0][r, :m]), (got[1][r, :m], want[1][r, :m])]
    return pairs


def hop_crafted_lanes(DK, dev, words4, htab, dn, dict_size: int, cap_g: int) -> list:
    """K2/K12 operands the corpus does not give: the port's overflow lanes
    (one lane past CAP_M matches beside one that is not), and two corpus
    chunks whose every match source lies before the row (dist 0xFFFF)."""
    far = htab[:2].clone()
    far[(far >> 30) > 0] |= 0xFFFF
    return [(*[t.to(dev) for t in DK.overflow_lanes()], 0, 24),
            (words4[:2], far, dn[:2], dict_size, cap_g)]


def random_rows(torch, DK, lengths, seed: int):
    """uint8 rows of random bytes, `lengths[r]` each, zero-padded to a
    common width with DK.PAD bytes of tail (a multiple of 4)."""
    width = max(lengths) + DK.PAD
    width += -width % 4
    g = torch.Generator().manual_seed(seed)
    buf = torch.zeros((len(lengths), width), dtype=torch.uint8)
    for r, n in enumerate(lengths):
        buf[r, :n] = torch.randint(0, 256, (n,), generator=g, dtype=torch.uint8)
    return buf


def k12_extra_lanes(torch, DK, dev) -> list:
    """K12 operands neither the corpus nor K2's lanes give (start 0): a lane
    whose literal jumps land on literal entries that read as matches (h 0,
    len 3, dist 1), so every landing takes the serial step; three
    all-literal lanes whose one span is 1, 2 and 3 mod 4 long."""
    words = DK.words_from_bytes(random_rows(torch, DK, [6000], 7))
    htab = torch.full((1, 4 * words.shape[1]), (1 << 30) | (3 << 16) | 1, dtype=torch.int32)
    htab[:, 0::8] = 5
    htab[:, 5::8] = (3 << 16) | 1
    lens = [5001, 6002, 7003]
    lit = DK.words_from_bytes(random_rows(torch, DK, lens, 8))
    lit_tab = torch.full((3, 4 * lit.shape[1]), 1 << 20, dtype=torch.int32)
    n = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
    return [(words.to(dev), htab.to(dev), n([6000]), 0, 24),
            (lit.to(dev), lit_tab.to(dev), n(lens), 0, 24)]


def tab_pairs(got, want, cap_m: int) -> list:
    """(got, want) pairs of two K10 results: nmatch and bad, each lane's
    match slots up to the overflow slot."""
    pairs = [(got[2][:, :2], want[2][:, :2])]
    for r in range(got[0].shape[0]):
        m = min(int(want[2][r, 0]), cap_m + 1)
        pairs += [(got[0][r, :m], want[0][r, :m]), (got[1][r, :m], want[1][r, :m])]
    return pairs


def hop_il_phases(torch, dev, corpus, batch, hop_out, rows, launches) -> dict:
    """Phases 24-25: K12 against its plain version and K2 on the first
    super-batch, then the level-6 encode under ZRS_TPU_HOP_IL=2 end to end,
    its stream equal to phase 4's. Fills `rows` and `launches` for K12;
    returns the route's end-to-end numbers."""
    import zlib_rs_tpu_torch as zt
    from zlib_rs_tpu_torch.ops.kernels import checksum_kernels as CK
    from zlib_rs_tpu_torch.ops.kernels import deflate_kernel as DK
    from zlib_rs_tpu_torch.parallel import pipeline as PL

    dn, dict_size, words4, htab, cap_g = batch
    B = words4.shape[0]
    args = (words4, htab, dn, dict_size, cap_g)

    # -- phase 24: K12 against its plain version and K2 --------------------
    got = DK.hop_chase_il_cuda(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = DK.hop_chase_il_plain(*args)
    plain_s = time.perf_counter() - t0
    st = got[2]
    nmatch = st[:, 0].long()
    pairs = [(st[:, :2], want[2][:, :2]), (got[3], want[3])]
    for r in range(B):
        m = int(nmatch[r])
        pairs += [(got[0][r, :m], want[0][r, :m]), (got[1][r, :m], want[1][r, :m])]
    # an odd batch of three, and the crafted lanes (the overflowing one spans
    # three tiles): all four arrays, every bin
    for lanes in [(words4[:3], htab[:3], dn[:3], dict_size, cap_g)] + hop_crafted_lanes(
            DK, dev, words4, htab, dn, dict_size, cap_g) + k12_extra_lanes(torch, DK, dev):
        pairs += hop_pairs(DK.hop_chase_il_cuda, DK.hop_chase_il_plain, lanes, DK.CAP_M)
    # the whole batch again in tiles of MIN_TILE: ~32 tile edges a chunk
    small = DK.hop_chase_il_cuda(*args, tile=DK.MIN_TILE)
    pairs += [(small[2][:, :2], want[2][:, :2]), (small[3], want[3])]
    for r in range(B):
        m = int(nmatch[r])
        pairs += [(small[0][r, :m], want[0][r, :m]), (small[1][r, :m], want[1][r, :m])]
    err = max_abs(pairs)
    if err:
        raise AssertionError(f"K12 disagrees with its plain version: max abs err {err}")
    if bool((st[:, 1] > 0).any()):
        raise AssertionError("K12 flags a chunk of the corpus bad")
    ilp = DK._hop_post(*got)
    k2p = DK._hop_post(*DK.hop_chase_cuda(*args))
    same = all(torch.equal(ilp[i], k2p[i]) for i in (2, 3, 4))
    for r in range(B):
        m = int(nmatch[r])
        same = same and torch.equal(ilp[0][r, :m], k2p[0][r, :m]) and torch.equal(
            ilp[1][r, :m], k2p[1][r, :m])
    if not same:
        raise AssertionError("K12's parse and histogram differ from K2's on clean lanes")
    span = (dn - dict_size).long()
    nb = int((span + 8 * nmatch + 8 * nmatch + 32 + 4 * 4 * 320).sum())
    rows["hop_chase_il"] = dict(
        source="zlib_rs_tpu_torch/csrc/hop_chase_il.cu",
        replaces="zlib_rs_tpu/ops/pallas/deflate_kernel.py:961",
        max_abs_err=err,
        ms=event_ms(torch, lambda: DK.hop_chase_il_cuda(*args), 5),
        plain_ms=plain_s * 1e3, plain_rows=B,
        bnd=bound(nb, int((span + 20 * nmatch).sum())),  # as K2's
    )
    print(f"phase 24 K12: {B} chunks equal to plain in {plain_s:.1f} s, at tiles of "
          f"{DK.TILE} and {DK.MIN_TILE} positions, and an odd batch of 3, an overflowing lane "
          f"past one tile, far match sources, serial-step landings and all-literal lanes; "
          f"_hop_post equal to K2's on every lane of the batch; launch: "
          f"{DK.RESOLVE_THREADS} threads a block, {4 * DK.TILE} bytes of dynamic shared "
          f"memory, tile {DK.TILE}", flush=True)

    # -- phase 25: the level-6 encode under ZRS_TPU_HOP_IL=2 ---------------
    os.environ["ZRS_TPU_HOP_IL"] = "2"
    try:
        for name in DK.launches:
            DK.launches[name] = 0
        CK.launches["adler32_batch"] = 0
        t0 = time.perf_counter()
        out = zt.compress_parallel(corpus, LEVEL)
        cold_s = time.perf_counter() - t0
        seen = dict(DK.launches, adler32_batch=CK.launches["adler32_batch"])
        if min(seen[n] for n in ("hop_chase_il", "pack", "adler32_batch")) < 1 or max(
                seen[n] for n in ("hop_chase", "chain_scan", "tab_scan", "freq")) > 0:
            raise AssertionError(f"ZRS_TPU_HOP_IL=2: launches {seen}")
        if out != hop_out:
            raise AssertionError("the ZRS_TPU_HOP_IL=2 stream differs from phase 4's")
        launches["hop_chase_il"] = seen["hop_chase_il"]
        result = {"cold_s": cold_s, "launches": seen, "equals_hop_stream": True,
                  **warm_runs(torch, PL, lambda: zt.compress_parallel(corpus, LEVEL), out,
                              len(corpus), "HOP_IL=2 encode", 25)}
    finally:
        del os.environ["ZRS_TPU_HOP_IL"]
    print(f"phase 25 HOP_IL=2 e2e: {digest(out)}, equal to phase 4's stream, cold "
          f"{cold_s:.3f} s, launches {seen}", flush=True)
    return result


def at_128k(label, err, launch, plain_ms, nb, nops, torch, **extra) -> dict:
    """A kernel's numbers at the XLA engine's 128 KiB chunks: its error
    against its plain version, ms by events and queued, the plain version's
    ms and the bound for these bytes and operations."""
    b_ms, b_by = bound(nb, nops)
    row = dict(max_abs_err=err, ms=event_ms(torch, launch, 20), queued_ms=queued_ms(torch, launch),
               plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, **extra)
    print(f"{label} at 128 KiB: " + json.dumps(row), flush=True)
    return row


def xla_phases(torch, dev, corpus, rows) -> dict:
    """Phases 26-31: the XLA encode engine (ZRS_TPU_KERNEL unset: 128 KiB
    chunks, batches of 16) at levels 6, 1 and 9, each checked by zlib and
    against the port's CPU stream on a 512 KiB prefix; the chunk sizes
    12345 (unset) and 65536 (ZRS_TPU_KERNEL=1, past MAX_BUF); K1 and K7 on
    128 KiB rows; the 128 KiB indexed streams through K4/K5, K11a/K11b and
    K6, each launch against its plain version (K5 and K11b on their serial
    too-large body) and each route end to end; the seeded swarm engine
    under ZRS_TPU_KERNEL=0, held against its CPU run, and its walker
    kernel against its plain version; and the static level-1 index
    through K6. Adds each kernel's 128 KiB numbers to `rows`
    as "at_128k"; returns the end-to-end numbers."""
    import numpy as np
    import zlib_rs_tpu_torch as zt
    from zlib_rs_tpu_torch.ops.kernels import checksum_kernels as CK
    from zlib_rs_tpu_torch.ops.kernels import crc_kernels as CRC
    from zlib_rs_tpu_torch.ops.kernels import deflate_kernel as DK
    from zlib_rs_tpu_torch.ops.kernels import inflate_kernel as IK
    from zlib_rs_tpu_torch.ops.kernels import vhuff_kernel as VK
    from zlib_rs_tpu_torch.parallel import device_inflate as DI
    from zlib_rs_tpu_torch.parallel import pipeline as PL
    from zlib_rs_tpu_torch.parallel import swarm_inflate as SW
    from zlib_rs_tpu_torch.parallel import vector_inflate as VI

    t_start = time.perf_counter()
    counters = (CK.launches, CRC.launches, DK.launches, VK.launches, IK.launches, SW.runs,
                SW.launches)

    def zero():
        for c in counters:
            for name in c:
                c[name] = 0

    def counts() -> dict:
        return {name: c[name] for c in counters for name in c if c[name]}

    cs = PL.XLA_CHUNK
    n_chunks = -(-len(corpus) // cs)
    batches = -(-n_chunks // PL.TAIL_BATCH)
    prefix = corpus[: 512 * 1024]
    result = {"encode": {}}
    kernel_env = os.environ.pop("ZRS_TPU_KERNEL", None)  # unset: the XLA engine
    try:
        # -- phase 26: the XLA engine's encodes ----------------------------
        for level in (6, 1, 9):
            zero()
            t0 = time.perf_counter()
            out = zt.compress_parallel(corpus, level)
            cold_s = time.perf_counter() - t0
            ran = counts()
            if ran != {"adler32_batch": batches}:
                raise AssertionError(f"the XLA level-{level} encode launched {ran}, not K1 once a "
                                     f"batch ({batches})")
            if zlib.decompress(out) != corpus:
                raise AssertionError(f"the XLA level-{level} stream does not decode to the corpus")
            zref = len(zlib.compress(corpus, level))
            on_card = zt.compress_parallel(prefix, level)
            t0 = time.perf_counter()
            on_cpu = zt.compress_parallel(prefix, level, device="cpu")
            cpu_s = time.perf_counter() - t0
            if on_card != on_cpu:
                raise AssertionError(f"the XLA level-{level} stream of the 512 KiB prefix differs "
                                     f"between the card and the CPU")
            print(f"phase 26 XLA level {level}: {len(corpus)} -> {digest(out)}, ratio to "
                  f"zlib-{level} {len(out) / zref:.6f} ({zref} bytes), {n_chunks} chunks of {cs} "
                  f"bytes, cold {cold_s:.3f} s, launches {ran}; the 512 KiB prefix equal to the "
                  f"CPU's stream ({len(on_cpu)} bytes, {cpu_s:.1f} s on the CPU)", flush=True)
            result["encode"][f"level{level}"] = {
                "bytes_out": len(out), "zlib_bytes": zref, "ratio_to_zlib": len(out) / zref,
                "cold_s": cold_s, "launches": ran, **warm_runs(
                    torch, PL, lambda: zt.compress_parallel(corpus, level), out, len(corpus),
                    f"XLA level {level}", 26)}

        # -- phase 27: a chunk size off the word grid, and a buffer past MAX_BUF
        more = {}
        for label, env, kw in (("chunk 12345", None, dict(chunk_size=12_345)),
                               ("chunk 65536 under ZRS_TPU_KERNEL=1", "1",
                                dict(chunk_size=65_536))):
            if env:
                os.environ["ZRS_TPU_KERNEL"] = env
            zero()
            t0 = time.perf_counter()
            out = zt.compress_parallel(corpus, LEVEL, **kw)
            wall = time.perf_counter() - t0
            os.environ.pop("ZRS_TPU_KERNEL", None)
            ran = counts()
            if set(ran) != {"adler32_batch"} or zlib.decompress(out) != corpus:
                raise AssertionError(f"the {label} encode launched {ran} or does not decode")
            more[label] = {"bytes_out": len(out), "wall_s": wall, "launches": ran}
            print(f"phase 27 {label}: {digest(out)}, {wall:.3f} s, launches {ran}", flush=True)
        result["more_encodes"] = more

        # -- phase 28: K1 and K7 on 128 KiB rows ---------------------------
        dict_size = PL.priming_dict_size(n_chunks, cs, True, shrink=False)
        padded, n_valid, _vf, _dl = PL.chunk_buffers(corpus, cs, dict_size)
        dc = torch.from_numpy(padded[: PL.TAIL_BATCH]).to(dev)
        dn = torch.from_numpy(n_valid[: PL.TAIL_BATCH]).to(dev)
        seg = dc[:, dict_size : dict_size + cs]
        lens = (dn - dict_size).to(torch.int32)
        got = CK.adler32_batch_cuda(seg, lens)
        want, plain_ms = timed_ms(torch, lambda: CK.adler32_batch_plain(seg, lens))
        host = seg.cpu().numpy()
        for r in range(seg.shape[0]):
            if int(got[r]) & 0xFFFFFFFF != zlib.adler32(host[r, : int(lens[r])].tobytes()):
                raise AssertionError(f"K1 row {r} of 128 KiB disagrees with zlib")
        nb = int(lens.sum())
        rows["adler32_batch"]["at_128k"] = at_128k(
            f"phase 28 K1 ({seg.shape[0]} rows)", max_abs([(got, want)]),
            lambda: CK.adler32_batch_cuda(seg, lens), plain_ms, nb + 8 * seg.shape[0], 3 * nb,
            torch, rows=seg.shape[0])
        nfull = len(corpus) // cs
        full = torch.from_numpy(np.frombuffer(corpus, np.uint8, count=nfull * cs)
                                .reshape(nfull, cs).copy()).to(dev)
        flen = torch.full((nfull,), cs, dtype=torch.int32, device=dev)
        got = CRC.crc32_batch_cuda(full, flen)
        want, plain_ms = timed_ms(torch, lambda: CRC.crc32_batch_plain(full, flen))
        for r in range(nfull):
            if int(got[r]) & 0xFFFFFFFF != zlib.crc32(corpus[r * cs : (r + 1) * cs]):
                raise AssertionError(f"K7 row {r} of 128 KiB disagrees with zlib")
        nb = nfull * cs
        rows["crc32_batch"]["at_128k"] = at_128k(
            f"phase 28 K7 ({nfull} rows)", max_abs([(got, want)]),
            lambda: CRC.crc32_batch_cuda(full, flen), plain_ms, nb + 8 * nfull, 4 * nb, torch,
            rows=nfull)
        for name in ("adler32_batch", "crc32_batch"):
            if rows[name]["at_128k"]["max_abs_err"]:
                raise AssertionError(f"{name} at 128 KiB rows disagrees with its plain version")
        print(f"phase 28: K1 on {seg.shape[0]} and K7 on {nfull} rows of {cs} bytes equal to "
              f"plain and zlib", flush=True)

        # -- phase 29: the 128 KiB indexed streams through every decoder ---
        idx_out, index = zt.compress_parallel(corpus, LEVEL, return_index=True)
        gz, gz_index = zt.compress_parallel(corpus, LEVEL, window_bits=31, return_index=True)
        if zlib.decompress(idx_out) != corpus or zlib.decompress(gz, 31) != corpus:
            raise AssertionError("the 128 KiB indexed streams do not decode")
        bodies, sizes, seeds, staged, meta, full_args, _sub = stage_decode(VI, idx_out, index, dev)
        S, K, B = meta["S"], meta["K"], meta["B"]
        W = B * S
        body_bytes = sum(len(b) for b in bodies) + 4 * staged["tables"].numel()
        out_words = -(-max(sizes) // 4) + 2
        offs = staged["offs"]
        names = {VK.BRANCH_CHASE: "chase", VK.BRANCH_UNTILED: "serial (untiled)",
                 VK.BRANCH_TOO_LARGE: "serial (too large)"}
        large = torch.tensor([n > VK.CHASE_MAX_BYTES for n in sizes], device=dev)

        def expand_check(label, outw, want, branch):
            err = bytes_err(torch, outw, want, sizes)
            seen = {names[int(b)]: int(n)
                    for b, n in zip(*torch.unique(branch, return_counts=True))}
            if (large & (branch != VK.BRANCH_TOO_LARGE)).any():
                raise AssertionError(f"{label}: a chunk past the chase left the too-large body: "
                                     f"{seen}")
            out8 = outw.cpu().numpy().view("u1")
            if b"".join(out8[r, : sizes[r]].tobytes() for r in range(B)) != corpus:
                raise AssertionError(f"{label}'s expansion is not the corpus")
            return err, seen

        # K4 and K5, two-plane
        cap2 = VI._twoplane_cap(meta)
        tapes = VK.decode_tokens_vector2_cuda(*full_args, S=S, K=K, cap=cap2)
        want, plain_ms = timed_ms(
            torch, lambda: VK.decode_tokens_vector2_plain(*full_args, S=S, K=K, cap=cap2))
        err = max_abs(zip(tapes, want))
        tapeA, tapeB, _cons, bad, rem = tapes
        if err or int(bad.abs().sum()) or int(rem.abs().sum()):
            raise AssertionError(f"K4 at 128 KiB: max abs err {err}, or flagged walkers")
        used = int((tapeB != 0).sum())
        rows["vhuff_decode"]["at_128k"] = at_128k(
            "phase 29 K4", err,
            lambda: VK.decode_tokens_vector2_cuda(*full_args, S=S, K=K, cap=cap2),
            plain_ms, body_bytes + 24 * W + 8 * used, 200 * used, torch, chunks=B, cap=cap2)
        branch = torch.full((B,), -1, dtype=torch.int32, device=dev)
        outw = VK.expand_tokens2_cuda(tapeA, tapeB, offs, out_words=out_words, branch=branch)
        want, plain_ms = timed_ms(
            torch, lambda: VK.expand_tokens2_plain(tapeA, tapeB, offs, out_words=out_words))
        err, seen5 = expand_check("K5", outw, want, branch)
        rows["vhuff_expand"]["at_128k"] = at_128k(
            "phase 29 K5", err,
            lambda: VK.expand_tokens2_cuda(tapeA, tapeB, offs, out_words=out_words),
            plain_ms, 8 * used + 4 * offs.numel() + len(corpus), 40 * used, torch, bodies=seen5)
        # K11a and K11b, single-plane
        cap1 = meta["cap"]
        tapes = VK.decode_tokens_vector_cuda(*full_args, S=S, K=K, cap=cap1)
        want, plain_ms = timed_ms(
            torch, lambda: VK.decode_tokens_vector_plain(*full_args, S=S, K=K, cap=cap1))
        err = max_abs(zip(tapes, want))
        tape, _cons, bad, rem = tapes
        if err or int(bad.abs().sum()) or int(rem.abs().sum()):
            raise AssertionError(f"K11a at 128 KiB: max abs err {err}, or flagged walkers")
        used = int((tape != 0).sum())
        rows["vhuff_decode1"]["at_128k"] = at_128k(
            "phase 29 K11a", err,
            lambda: VK.decode_tokens_vector_cuda(*full_args, S=S, K=K, cap=cap1),
            plain_ms, body_bytes + 24 * W + 4 * used, 200 * used, torch, chunks=B, cap=cap1)
        branch = torch.full((B,), -1, dtype=torch.int32, device=dev)
        outw = VK.expand_tokens_cuda(tape, offs, out_words=out_words, branch=branch)
        want, plain_ms = timed_ms(
            torch, lambda: VK.expand_tokens_plain(tape, offs, out_words=out_words))
        err, seen11 = expand_check("K11b", outw, want, branch)
        rows["vhuff_expand1"]["at_128k"] = at_128k(
            "phase 29 K11b", err, lambda: VK.expand_tokens_cuda(tape, offs, out_words=out_words),
            plain_ms, 4 * used + 4 * offs.numel() + len(corpus), 40 * used, torch, bodies=seen11)
        # K6, every chunk in one launch
        max_out = max(sizes)
        words, bits = IK.pack_streams_words(bodies)
        args = [torch.from_numpy(words.view("i4")).to(dev),
                torch.zeros(B, dtype=torch.int32, device=dev), torch.from_numpy(bits).to(dev),
                torch.tensor(sizes, dtype=torch.int32, device=dev)]
        got = IK.decode_streams_cuda(*args, max_out=max_out)
        host_args = [a.cpu() for a in args]
        t0 = time.perf_counter()
        want = IK.decode_streams_plain(*host_args, max_out=max_out)
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = k6_err(torch, got, want, max_out)
        out8 = got[0].cpu().numpy()
        if err or bool(got[2].any()) or b"".join(
                out8[r, : sizes[r]].tobytes() for r in range(B)) != corpus:
            raise AssertionError(f"K6 at 128 KiB: max abs err {err}, or not the corpus")
        comp = sum(len(b) for b in bodies)
        rows["inflate"]["at_128k"] = at_128k(
            "phase 29 K6", err, lambda: IK.decode_streams_cuda(*args, max_out=max_out), plain_ms,
            comp + 48 * B + len(corpus), 10 * len(corpus), torch, chunks=B)
        for name in ("vhuff_decode", "vhuff_expand", "vhuff_decode1", "vhuff_expand1", "inflate"):
            if rows[name]["at_128k"]["max_abs_err"]:
                raise AssertionError(f"{name} at 128 KiB disagrees with its plain version")
        print(f"phase 29 kernels: {B} chunks of {cs} bytes, {W} walkers: K4, K5, K11a, K11b "
              f"and K6 equal to plain and the corpus; K5 bodies {seen5}, K11b bodies {seen11}",
              flush=True)
        # each route of decompress_parallel, end to end
        decodes = {}
        for route, env, want_ran in (
            ("two-plane", {}, {"vhuff_decode": 1, "vhuff_expand": 1}),
            ("single-plane", {"ZRS_VECTOR_TWOPLANE": "0"},
             {"vhuff_decode1": 1, "vhuff_expand1": 1}),
            ("K6", {"ZRS_TPU_VECTOR": "0"}, {"inflate": 1}),
        ):
            os.environ.update(env)
            try:
                for label, stream, ix in (("zlib", idx_out, index), ("gzip", gz, gz_index)):
                    zero()
                    t0 = time.perf_counter()
                    back = zt.decompress_parallel(stream, ix)
                    wall = time.perf_counter() - t0
                    ran = counts()
                    if back != corpus or ran != want_ran or PL.fallback_stats():
                        raise AssertionError(f"the {route} decode of the 128 KiB {label} stream: "
                                             f"launches {ran}, fallbacks {PL.fallback_stats()}")
                    decodes[f"{route} {label}"] = {"wall_s": wall, "launches": ran}
            finally:
                for name in env:
                    del os.environ[name]
        print("phase 29 routes: " + json.dumps(decodes), flush=True)
        result["decode_128k"] = decodes

        # -- phase 30: the seeded swarm engine -----------------------------
        os.environ.update({"ZRS_TPU_KERNEL": "0", "ZRS_TPU_VECTOR": "0"})
        try:
            swarm = {}
            for label, stream, ix in (("zlib", idx_out, index), ("gzip", gz, gz_index)):
                zero()
                t0 = time.perf_counter()
                back = zt.decompress_parallel(stream, ix)
                cold_s = time.perf_counter() - t0
                ran = counts()
                if back != corpus or ran != {"decode_seeded": 1, "swarm_walk": 1} or \
                        PL.fallback_stats():
                    raise AssertionError(f"the swarm decode of the {label} stream: runs {ran}, "
                                         f"fallbacks {PL.fallback_stats()}")
                swarm_launches = ran["swarm_walk"]
                swarm[label] = {"cold_s": cold_s, **warm_runs(
                    torch, PL, lambda: zt.decompress_parallel(stream, ix), corpus, len(corpus),
                    f"swarm decode {label}", 30)}
        finally:
            for name in ("ZRS_TPU_KERNEL", "ZRS_TPU_VECTOR"):
                del os.environ[name]
        *arrays, cap = SW.seeded_inputs(bodies[:4], sizes[:4], seeds[:4])
        mo = max(sizes[:4])
        on_card = SW.decode_seeded(*(torch.from_numpy(a).to(dev) for a in arrays), cap=cap,
                                   max_out=mo)
        t0 = time.perf_counter()
        on_cpu = SW.decode_seeded(*(torch.from_numpy(a) for a in arrays), cap=cap, max_out=mo)
        cpu_s = time.perf_counter() - t0
        err = max_abs(zip(on_card, on_cpu))
        if err or bool(on_cpu[2].any()):
            raise AssertionError(f"decode_seeded on the card differs from the CPU: {err}")
        swarm["first_4_chunks"] = {"max_abs_err": err, "cap": cap, "cpu_s": cpu_s}
        # the walker kernel against its plain version on the card, on every
        # chunk of the 128 KiB stream and with a byte flipped in chunk 1
        *arrays, cap = SW.seeded_inputs(bodies, sizes, seeds)
        comp, ll, dd, sbit, sspan = (torch.from_numpy(a).to(dev) for a in arrays)
        rev = torch.from_numpy(DI._REV15_NP).to(dev)
        luts = [DI._build_flat_lut(x, *f, rev) for x, f in
                ((ll, DI._ll_symbol_fields(320)), (dd, DI._d_symbol_fields(320)))]
        walk_args = (comp, *luts, sbit, sspan, cap)
        flipped = comp.clone()
        flipped[1, int(arrays[0].shape[1]) // 3] ^= 0xFF
        pairs, ends = [], []
        for c in (comp, flipped):
            got = SW.walk_cuda(c, *walk_args[1:])
            want = SW.walk_plain(c, *walk_args[1:])
            pairs += list(zip(got, want))
            ends.append(got[3])
        walk_err = max_abs(pairs)
        if walk_err:
            raise AssertionError(f"the swarm walker kernel differs from its plain version: "
                                 f"max abs err {walk_err}")
        # walkers of the flipped stream that went bad or ended elsewhere
        n_bad = int((pairs[-1][0] | (ends[0] != ends[1])).sum())
        walk_ms = event_ms(torch, lambda: SW.walk_cuda(*walk_args), 10)
        _w, walk_plain_ms = timed_ms(torch, lambda: SW.walk_plain(*walk_args))
        W = int(sbit.numel())
        steps = int(sspan.sum())  # at most a step an output byte
        rows["swarm_walk"] = dict(
            source="zlib_rs_tpu_torch/csrc/swarm.cu",
            replaces="zlib_rs_tpu/parallel/swarm_inflate.py:163",
            max_abs_err=walk_err, ms=walk_ms, plain_ms=walk_plain_ms,
            # the bodies and both tables in, a tape slot a covered step out
            bnd=bound(comp.numel() + 2 * 4 * (1 << 15) * len(bodies) + 16 * W + 9 * steps, 0),
            launches=swarm_launches,
        )
        swarm["walk"] = {"walkers": W, "cap": cap, "ms": walk_ms, "plain_ms": walk_plain_ms,
                         "flipped_bad_or_moved_walkers": n_bad}
        print(f"phase 30 swarm: both streams through the swarm engine (one run each, one walker "
              f"kernel launch, no fallback); decode_seeded of the first 4 chunks (cap {cap}) "
              f"equal to its CPU run (max abs err {err}, {cpu_s:.1f} s on the CPU); the walker "
              f"kernel on {W} walkers of {len(bodies)} chunks, clean and with a flipped byte "
              f"({n_bad} walkers bad or moved), equal to its plain version on the card "
              f"(max abs err {walk_err}): {walk_ms:.4f} ms a launch by events, the plain version "
              f"{walk_plain_ms:.1f} ms", flush=True)
        result["swarm_decode"] = swarm

        # -- phase 31: the static level-1 index through K6 -----------------
        out1, index1 = zt.compress_parallel(corpus, 1, return_index=True)
        if index1.seeds is not None or zlib.decompress(out1) != corpus:
            raise AssertionError("the level-1 index carries seeds or does not decode")
        zero()
        t0 = time.perf_counter()
        back = zt.decompress_parallel(out1, index1)
        wall = time.perf_counter() - t0
        ran = counts()
        if back != corpus or ran != {"inflate": 1} or PL.fallback_stats():
            raise AssertionError(f"the level-1 indexed decode launched {ran}, fallbacks "
                                 f"{PL.fallback_stats()}")
        result["level1_index_k6"] = {"bytes": len(out1), "wall_s": wall, "launches": ran}
        print(f"phase 31 level-1 index: {digest(out1)}, no seeds, decoded by one K6 launch in "
              f"{wall:.3f} s", flush=True)
    finally:
        if kernel_env is None:
            os.environ.pop("ZRS_TPU_KERNEL", None)
        else:
            os.environ["ZRS_TPU_KERNEL"] = kernel_env
    result["phases_s"] = time.perf_counter() - t_start
    print(f"phases 26-31: {result['phases_s']:.1f} s", flush=True)
    return result


LONE_EOB = bytes.fromhex("05c0810800000000207feb03")  # a dynamic block whose only code is EOB


def lockstep_regions(corpus: bytes):
    """Phase 32's 8 lanes: 16 KiB of the corpus as stdlib raw deflate at
    levels 0, 1, 6 and 9 and under Z_FIXED, two regions of a level-6
    stream of small blocks cut by the zran index at sub-byte starts with
    their windows, and the lone-EOB body. Returns (bodies, sizes, windows,
    starts, wants)."""
    from zlib_rs_tpu_torch.models import zran as Z

    kb16 = 16 * 1024
    lanes = [(_raw(corpus[k * kb16 : (k + 1) * kb16], level=lv, strategy=st), k * kb16)
             for k, (lv, st) in enumerate(((0, 0), (1, 0), (6, 0), (9, 0),
                                           (6, zlib.Z_FIXED)))]
    bodies = [b for b, _ in lanes]
    wants = [corpus[o : o + kb16] for _, o in lanes]
    windows = [b""] * len(lanes)
    starts = [0] * len(lanes)
    off = 5 * kb16
    seg = corpus[off : off + 8 * kb16]
    stream = _raw(seg, mem=1)
    index = Z.build_index(stream, span=kb16)
    pts = [p for p in index.points if p.bits and p.out_offset]
    if len(pts) < 2:
        raise AssertionError("the index has fewer than 2 sub-byte points")
    for p in pts[:2]:
        nxt = next((q for q in index.points if q.out_offset > p.out_offset), None)
        end_out = nxt.out_offset if nxt else index.total_out
        end_bit = (nxt.in_offset - 1) * 8 + (8 - nxt.bits) if nxt and nxt.bits else (
            nxt.in_offset * 8 if nxt else len(stream) * 8)
        bit = (p.in_offset - 1) * 8 + (8 - p.bits)
        bodies.append(stream[bit >> 3 : ((end_bit + 7) >> 3) + 8])
        starts.append(bit & 7)
        windows.append(p.window)
        wants.append(seg[p.out_offset : end_out])
    bodies.append(LONE_EOB)
    wants.append(b"")
    windows.append(b"")
    starts.append(0)
    return bodies, [len(w) for w in wants], windows, starts, wants


def lockstep_arrays(np, torch, bodies, sizes, starts):
    """decompress_chunks' operands for the lockstep engine: comp uint8 [B,
    L] (rows padded with at least 8 zero bytes to a power of two), start
    bits, end bits and targets as CPU tensors, and its step budget."""
    B = len(bodies)
    L = 1 << (max(len(b) for b in bodies) + 8 - 1).bit_length()
    comp = np.zeros((B, L), np.uint8)
    for i, b in enumerate(bodies):
        comp[i, : len(b)] = np.frombuffer(b, np.uint8)
    args = [torch.from_numpy(np.asarray(a, np.int32)) for a in
            (starts, [len(b) * 8 for b in bodies], sizes)]
    max_out = 1 << (max(max(sizes), 1) - 1).bit_length()
    max_steps = max_out + 2 + 512 * max(1, max(len(b) for b in bodies) // 4096)
    return torch.from_numpy(comp), args, max_steps


def lockstep_pair(torch, DI, dev, comp, args, max_steps: int, label: str):
    """The lockstep kernel on the card against its plain version on the
    CPU on the same lanes: tapes, n_steps, produced and bad equal (max abs
    err 0) or it raises. Returns (the card's outputs, card s, CPU s)."""
    comp_d, args_d = comp.to(dev), [a.to(dev) for a in args]
    k0 = DI.launches["lockstep"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    on_card = DI.decode_regions(comp_d, *args_d, max_steps)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    if DI.launches["lockstep"] != k0 + 1:
        raise AssertionError(f"{label}: decode_regions on the card did not launch the kernel")
    t0 = time.perf_counter()
    on_cpu = DI.decode_regions(comp, *args, max_steps)
    cpu_s = time.perf_counter() - t0
    if on_card[3] != on_cpu[3]:
        raise AssertionError(f"{label}: the kernel took {on_card[3]} steps, its plain version "
                             f"{on_cpu[3]}")
    err = max_abs([(a, b) for k, (a, b) in enumerate(zip(on_card, on_cpu)) if k != 3])
    if err:
        raise AssertionError(f"{label}: the lockstep kernel differs from its plain version: "
                             f"max abs err {err}")
    return on_card, card_s, cpu_s


def lockstep_phase(torch, dev, corpus, rows) -> dict:
    """Phase 32: the lockstep kernel (csrc/lockstep.cu, `decode_regions`)
    against its plain version on the CPU on phase 32's 8 lanes, on the same
    lanes with a flipped byte in each, and on one 128 KiB chunk of the XLA
    engine's stream; `resolve_tokens` of the clean lanes against the
    corpus; `decompress_chunks(engine="auto")` recovering the lone-EOB body
    K6 refuses; a region with a flipped bit raising."""
    import numpy as np

    import zlib_rs_tpu_torch as zt
    from zlib_rs_tpu_torch.parallel import device_inflate as DI
    from zlib_rs_tpu_torch.parallel import inflate as RI
    from zlib_rs_tpu_torch.parallel import pipeline as PL

    t_start = time.perf_counter()
    bodies, sizes, windows, starts, wants = lockstep_regions(corpus)
    B = len(bodies)
    comp, args, max_steps = lockstep_arrays(np, torch, bodies, sizes, starts)
    on_card, card_s, cpu_s = lockstep_pair(torch, DI, dev, comp, args, max_steps, "8 lanes")
    n_steps = on_card[3]
    if bool(on_card[5].any()):
        raise AssertionError(f"a clean lockstep lane is bad: {on_card[5].tolist()}")
    comp_d, args_d = comp.to(dev), [a.to(dev) for a in args]
    ms = event_ms(torch, lambda: DI.decode_regions(comp_d, *args_d, max_steps), 5)
    _p, plain_ms = timed_ms(torch, lambda: DI.decode_regions_plain(comp_d, *args_d, max_steps))
    wlen = 32768
    wins = np.zeros((B, wlen), np.uint8)
    for i, w in enumerate(windows):
        if w:
            wins[i, wlen - len(w[-wlen:]) :] = np.frombuffer(w[-wlen:], np.uint8)
    t0 = time.perf_counter()
    max_out = 1 << (max(sizes) - 1).bit_length()
    vals, _tot = DI.resolve_tokens(comp_d, *(t[:, :n_steps] for t in on_card[:3]),
                                   torch.from_numpy(wins).to(dev), max_out, wlen)
    vals = vals.cpu().numpy()
    resolve_s = time.perf_counter() - t0
    for i, w in enumerate(wants):
        if vals[i, : len(w)].tobytes() != w:
            raise AssertionError(f"lockstep lane {i} does not resolve to the corpus")

    # the same lanes, a byte flipped in the middle of each
    flipped = [_flip(b, len(b) // 2) for b in bodies]
    fcomp, fargs, fsteps = lockstep_arrays(np, torch, flipped, sizes, starts)
    f_card, f_card_s, f_cpu_s = lockstep_pair(torch, DI, dev, fcomp, fargs, fsteps, "flipped")
    n_bad = int(f_card[5].sum())

    # one 128 KiB chunk of the XLA engine's stream
    kernel_env = os.environ.pop("ZRS_TPU_KERNEL", None)
    try:
        xla_out, xla_ix = zt.compress_parallel(corpus[: 4 * 131072], 6, return_index=True)
    finally:
        if kernel_env is not None:
            os.environ["ZRS_TPU_KERNEL"] = kernel_env
    off, ln, n = xla_ix[1]
    bcomp, bargs, bsteps = lockstep_arrays(np, torch, [xla_out[off : off + ln]], [n], [0])
    b_card, b_card_s, b_cpu_s = lockstep_pair(torch, DI, dev, bcomp, bargs, bsteps, "128 KiB")
    if bool(b_card[5].any()) or int(b_card[4][0]) != n:
        raise AssertionError("the 128 KiB chunk did not decode on the lockstep kernel")
    bcomp_d, bargs_d = bcomp.to(dev), [a.to(dev) for a in bargs]
    ms_128k = event_ms(torch, lambda: DI.decode_regions(bcomp_d, *bargs_d, bsteps), 5)
    tape = 1 + 4 + 4  # a column of tok_kind, tok_a, tok_b
    rows["lockstep"] = dict(
        source="zlib_rs_tpu_torch/csrc/lockstep.cu",
        replaces="zlib_rs_tpu/parallel/device_inflate.py:234",
        max_abs_err=0, ms=ms, plain_ms=plain_ms,
        bnd=bound(comp.numel() + 12 * B + tape * B * n_steps + 9 * B, 0),
        at_128k={"ms": ms_128k, "n_steps": b_card[3], "steps_per_s": b_card[3] / (ms_128k / 1e3),
                 "bound_ms": bound(bcomp.numel() + 12 + tape * b_card[3] + 9, 0)[0],
                 "plain_cpu_s": b_cpu_s},
    )

    PL._FALLBACKS.clear()
    good = bodies[2]
    got = RI.decompress_chunks([LONE_EOB, good], [0, sizes[2]])
    if got != [b"", wants[2]] or PL.fallback_stats() != {"region_kernel:ValueError": 1}:
        raise AssertionError(f"auto on the lone-EOB body: {PL.fallback_stats()}")
    PL._FALLBACKS.clear()
    broken = bytes([good[0] ^ 0x02]) + good[1:]  # BTYPE 2 becomes the reserved 3
    try:
        RI.decompress_chunks([good, broken], [sizes[2]] * 2, engine="lockstep")
    except ValueError as e:
        why = str(e)
    else:
        raise AssertionError("a region with a flipped bit decoded on the lockstep engine")
    wall = time.perf_counter() - t_start
    result = {"lanes": B, "n_steps": n_steps, "card_s": card_s, "steps_per_s": n_steps / card_s,
              "ms": ms, "plain_card_ms": plain_ms, "cpu_s": cpu_s, "resolve_s": resolve_s,
              "flipped": {"n_steps": f_card[3], "bad_lanes": n_bad, "card_s": f_card_s,
                          "cpu_s": f_cpu_s},
              "at_128k": {"n_steps": b_card[3], "card_s": b_card_s, "ms": ms_128k,
                          "cpu_s": b_cpu_s},
              "phase_s": wall}
    print(f"phase 32 lockstep kernel: {B} lanes (levels 0, 1, 6, 9, fixed, 2 primed at start "
          f"bits {starts[5:7]}, lone EOB), {n_steps} steps equal to the plain version on the CPU "
          f"(max abs err 0), {card_s:.4f} s on the card ({n_steps / card_s:.1f} steps/s), "
          f"{ms:.4f} ms a launch by events, the plain version {plain_ms:.1f} ms on the card "
          f"and {cpu_s:.3f} s on the CPU; resolve {resolve_s:.3f} s, bytes equal the corpus; "
          f"flipped: {f_card[3]} steps, {n_bad} of {B} lanes bad, equal; 128 KiB chunk of the "
          f"XLA stream: {b_card[3]} steps equal, {ms_128k:.4f} ms a launch "
          f"({b_card[3] / (ms_128k / 1e3):.1f} steps/s), plain {b_cpu_s:.2f} s on the CPU; "
          f"auto recovered the lone-EOB body after one region_kernel count; a flipped bit "
          f"raised ({why}); phase {wall:.1f} s", flush=True)
    return result


def foreign_streams(corpus: bytes) -> dict:
    """Phase 33's foreign streams of the corpus: stdlib zlib at levels 6
    and 9, raw deflate, a gzip member, 4 gzip members and gzip members of
    128 KiB each (64 over 8 MiB)."""
    import gzip

    q = len(corpus) // 4
    m = GZIP_MANY_BYTES
    return {
        "zlib6": zlib.compress(corpus, 6),
        "zlib9": zlib.compress(corpus, 9),
        "raw": _raw(corpus),
        "gzip": gzip.compress(corpus, 6, mtime=0),
        "gzip4": b"".join(gzip.compress(corpus[k * q : (k + 1) * q if k < 3 else None], 6,
                                        mtime=0) for k in range(4)),
        "gzip_many": b"".join(gzip.compress(corpus[k : k + m], 6, mtime=0)
                              for k in range(0, len(corpus), m)),
    }


GZIP_MANY_BYTES = 128 * 1024  # the input of each member of phase 33's gzip_many


def host_skim_s(stream: bytes) -> float:
    """Seconds of the gzip split as the port ran it before its skims moved
    to the card: each member's end and size from zlib's raw inflater over
    the rest of the file, on the host. Phase 33's baseline for its
    gzip_split stage."""
    from zlib_rs_tpu_torch.models import zran as Z

    t0 = time.perf_counter()
    pos = 0
    while pos < len(stream) and stream[pos : pos + 2] == b"\x1f\x8b":
        hdr, _ = Z._wrapper_span(stream[pos:])
        body = stream[pos + hdr :]
        d = zlib.decompressobj(-15)
        d.decompress(body)
        pos = pos + hdr + len(body) - len(d.unused_data) + 8
    return time.perf_counter() - t0


def foreign_phase(torch, corpus, rows) -> dict:
    """Phase 33: `decompress_foreign` of the corpus as stdlib zlib (levels
    6 and 9), raw deflate and gzip (1, 4 and 64 members), each equal to the
    corpus with no fallback and its K6 launches counted, and the SP1-SP3
    launches of the monolithic streams' zran index pass on the card and of
    the gzip split's member skims (SP2 at least once a member), each gzip
    stream's gzip_split stage beside `host_skim_s` of it: the
    level-6 stream three times with its stages (the zran index pass, the
    region decode; K6 is warm since phase 11), the others once; a gzip
    member of 8 MiB of zeros, whose skim's room must grow past its first
    (the reference's, which raises there), with its rooms; a corrupted
    adler32 raising."""
    import zlib_rs_tpu_torch as zt
    from zlib_rs_tpu_torch.ops.kernels import inflate_kernel as IK
    from zlib_rs_tpu_torch.ops.kernels import speculative_kernel as SK
    from zlib_rs_tpu_torch.parallel import pipeline as PL
    from zlib_rs_tpu_torch.parallel import speculative as SP

    t_start = time.perf_counter()
    span = 1 << 20
    result = {"span": span, "streams": {}}
    streams = foreign_streams(corpus)
    for label, stream in streams.items():
        IK.launches["inflate"] = 0
        for c in SK.launches:
            SK.launches[c] = 0
        with kernel_events(torch, IK, ("decode_streams",)) as ev, \
                sp_events(torch, SK) as sp_ms:
            if label == "zlib6":
                runs = warm_runs(torch, PL, lambda: zt.decompress_foreign(stream, span), corpus,
                                 len(corpus), "foreign zlib-6", 33)
            else:
                PL.STAGES.enabled = True
                PL.STAGES.reset()
                t0 = time.perf_counter()
                try:
                    back = zt.decompress_foreign(stream, span)
                finally:
                    PL.STAGES.enabled = False
                runs = {"warm_s": [time.perf_counter() - t0], "stage_ms": [PL.STAGES.ms()]}
                if back != corpus:
                    raise AssertionError(f"decompress_foreign of {label} is not the corpus")
        k6_ms = ev["decode_streams"]
        ran = IK.launches["inflate"]
        sp_ran = dict(SK.launches)
        if PL.fallback_stats() or ran != len(runs["warm_s"]):
            raise AssertionError(f"decompress_foreign of {label}: fallbacks "
                                 f"{PL.fallback_stats()}, K6 launches {ran}")
        # the monolithic streams' zran_index stage runs the speculative
        # decode on the card (SP1 at least once a run, SP2 and SP3 too);
        # the gzip split skims every member on it (SP2 at least once a
        # member; SP1 where a member has more than one segment)
        members = {"gzip": 1, "gzip4": 4,
                   "gzip_many": -(-len(corpus) // GZIP_MANY_BYTES)}.get(label)
        if members is None and min(sp_ran.values()) < len(runs["warm_s"]) or (
                members and sp_ran["spec_decode"] < members * len(runs["warm_s"])):
            raise AssertionError(f"decompress_foreign of {label}: SP launches {sp_ran}")
        result["streams"][label] = {"bytes": len(stream), "launches": ran, "k6_ms": k6_ms,
                                    "sp_launches": sp_ran, "sp_ms": sp_ms, **runs}
        if members:
            host_s = min(host_skim_s(stream) for _ in range(3))
            result["streams"][label].update(members=members, host_skim_ms=host_s * 1e3)
            print(f"phase 33 {label}: {members} members, gzip_split "
                  f"{runs['stage_ms'][-1]['gzip_split']:.3f} ms on the card; the host skim "
                  f"of zlib's raw inflater over each member's rest (the split before the "
                  f"card's skim), best of 3: {host_s * 1e3:.3f} ms", flush=True)
        rows["inflate"]["foreign_launches"] = rows["inflate"].get("foreign_launches", 0) + ran
        if label == "zlib6":
            result["sp_launches_zlib6"] = sp_ran
        wall = runs["warm_s"][-1]
        print(f"phase 33 {label}: {len(stream)} bytes -> the corpus in {wall:.3f} s "
              f"({len(corpus) / wall / 1e6:.2f} MB/s), K6 launches {ran} "
              f"({', '.join(f'{x:.3f}' for x in k6_ms)} ms by events), SP launches {sp_ran} "
              f"(ms by events, summed: "
              + json.dumps({k: round(sum(v), 3) for k, v in sp_ms.items()}) + "), stages ms "
              + json.dumps({n: round(v, 3) for n, v in runs["stage_ms"][-1].items()}),
              flush=True)
    # 8 MiB of zeros in one gzip member of about 8 KiB: the skim's first
    # room (4 x the body + 1 MiB) is too small, and it grows 4x
    zeros = bytes(8 << 20)
    zmember = gzip.compress(zeros, 6, mtime=0)
    rooms, real = [], SP.skim

    def spy(data, max_out, **kw):
        rooms.append(max_out)
        return real(data, max_out, **kw)

    for c in SK.launches:
        SK.launches[c] = 0
    SP.skim = spy
    try:
        t0 = time.perf_counter()
        back = zt.decompress_foreign(zmember, span)
        wall = time.perf_counter() - t0
    finally:
        SP.skim = real
    if back != zeros or len(rooms) < 2:
        raise AssertionError(f"the 8 MiB-of-zeros member: {len(back)} bytes, rooms {rooms}")
    result["zeros_member"] = {"bytes": len(zmember), "rooms": rooms, "wall_s": wall,
                              "sp_launches": dict(SK.launches)}
    print(f"phase 33 gzip member of 8 MiB of zeros ({len(zmember)} bytes): back in {wall:.3f} s "
          f"after {len(rooms) - 1} room regrowths (rooms {rooms}), SP launches "
          f"{dict(SK.launches)}", flush=True)
    small = zlib.compress(corpus[: 1 << 20], 6)
    bad = small[:-1] + bytes([small[-1] ^ 1])
    try:
        zt.decompress_foreign(bad, span)
    except ValueError as e:
        if "incorrect data check" not in str(e):
            raise
    else:
        raise AssertionError("a corrupted adler32 decoded")
    result["phase_s"] = time.perf_counter() - t_start
    print(f"phase 33: a corrupted adler32 raised; phase {result['phase_s']:.1f} s", flush=True)
    return result


def kernel_ms(torch, fn, reps: int) -> dict:
    """Device ms a call by kernel, over `reps` calls after a warm-up, from a
    torch.profiler trace (CUDA activity): each kernel of csrc/ by its
    function's name, torch's kernels as "torch", copies and fills as
    "memcpy" and "memset"."""
    import re

    from torch.profiler import ProfilerActivity, profile

    from zlib_rs_tpu_torch import bench as ZB

    names = [f for fns in ZB.kernel_symbols().values() for f in fns]
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(prefix="zrs_smoke_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)
    out = {}
    for e in events:
        cat = e.get("cat", "")
        if e.get("ph") != "X" or cat not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        name = e.get("name", "")
        key = next((f for f in names if re.search(rf"(?:^|[\s:]){f}[(<]", name) or re.search(
            rf"_GLOBAL__N_\w*?{len(f)}{f}(?:I|E|P|v|i|j)", name)),
                   "torch" if cat == "kernel" else cat[4:])
        out[key] = out.get(key, 0.0) + float(e.get("dur", 0)) / 1e3 / reps
    return {k: round(v, 6) for k, v in out.items()}


def wall_ms(torch, fn, reps: int) -> list:
    """Host ms of each of `reps` calls of `fn` after a warm-up, each
    ending in a synchronize (a wrapper's own host syncs included)."""
    fn()
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return walls


def in_turn(torch, fns: dict, reps: int) -> dict:
    """The route's launch ("new") against its first design ("old") on the
    same operands, in turn (new, old, old, new): event ms (host syncs
    inside the wrapper included), device ms by kernel (torch.profiler) and
    host wall ms a call, each a list of the two turns; and the peak device
    memory a call allocates."""
    out = {k: {"new": [], "old": []} for k in ("event_ms", "kernel_ms", "wall_ms")}
    for who in ("new", "old", "old", "new"):
        out["event_ms"][who].append(event_ms(torch, fns[who], reps))
        out["kernel_ms"][who].append(kernel_ms(torch, fns[who], reps))
        out["wall_ms"][who].append(sorted(wall_ms(torch, fns[who], reps))[reps // 2])
    out["peak_bytes"] = {}
    for who in ("new", "old"):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fns[who]()
        torch.cuda.synchronize()
        out["peak_bytes"][who] = torch.cuda.max_memory_allocated() - base
    return out


def mean_of(turns: dict, who: str, key: str = "event_ms") -> float:
    """A launch's mean over its turns: event ms, or (key "kernel_ms") its
    device ms, every kernel, copy and fill of the call summed."""
    vals = turns[key][who]
    return sum(sum(v.values()) if isinstance(v, dict) else v for v in vals) / len(vals)


def sp1_pairs(torch, SK, dev, stream: bytes, lo: list, hi: list) -> tuple:
    """SP1 on ranges of one stream: the route's launch (with its counters)
    against the plain version and the first design; the pairs, the
    launch's offsets, its counters and the plain version's wall ms."""
    nbits = 8 * len(stream)
    words = torch.from_numpy(SK.stream_words(stream)).to(dev)
    st = {}
    got = SK.block_find_cuda(words, nbits, lo, hi, stats=st)
    want, plain_ms = timed_ms(torch, lambda: SK.block_find_plain(words, nbits, lo, hi))
    lo_t = torch.tensor(lo, dtype=torch.int64, device=dev)
    hi_t = torch.tensor(hi, dtype=torch.int64, device=dev)
    pairs = [(got, want), (got, SK.block_find_thread_cuda(words, nbits, lo_t, hi_t))]
    return pairs, got.tolist(), st, plain_ms


def survivors_to_first_pass(torch, SK, words, nbits: int, lo: list, hi: list, best: list):
    """The pre-filter's survivors a segment (its plain version on the card)
    up to and with the segment's first pass (all of them where none
    passes): what the check must take at least."""
    upto = []
    for a, z, b in zip(lo, hi, best):
        offs = torch.arange(max(a, 0), min(z, nbits), dtype=torch.int64, device=words.device)
        keep = offs[SK.prefilter_plain(words, nbits, offs)] if offs.numel() else offs
        upto.append(int((keep <= b).sum()) if b >= 0 else int(keep.numel()))
    return upto


def sp1_case(torch, SK, dev, streams: dict, seg: int) -> dict:
    """SP1 as phase 40 holds it, at max abs err 0 against the plain
    version and the first design: every segment of the raw-6 stream's
    first attempt (as inflate_speculative cuts it), a retry round's ranges
    (one bit past each segment's first pass) and 8 segments each of the
    stored and Z_FIXED streams; then the raw-6 and stored ranges again
    with rooms of 1 and 0 survivors a tile (SURVIVOR_SHARE raised), so
    that tiles overflow and the launch reruns with room for every offset,
    against the plain version's offsets. The route's launch and the first
    design timed in turn; the counters, the survivors up to each
    segment's first pass and the reruns' rooms and launches."""
    raw = streams["raw6"]
    nbits = 8 * len(raw)
    words = torch.from_numpy(SK.stream_words(raw)).to(dev)
    T = len(raw) // seg
    bounds = [8 * k * seg for k in range(T)] + [nbits]
    lo, hi = bounds[1:T], bounds[2:]
    pairs, found, stats, plain_ms = sp1_pairs(torch, SK, dev, raw, lo, hi)
    cases = [(raw, lo, hi, pairs[0][1])]
    retry = [(b + 1, z) for b, z in zip(found, hi) if b >= 0][:16]
    pairs += sp1_pairs(torch, SK, dev, raw, [a for a, _ in retry], [z for _, z in retry])[0]
    for name in ("stored", "fixed"):
        l2 = [8 * k * seg for k in range(1, 9)]
        h2 = [x + 8 * seg for x in l2]
        p2 = sp1_pairs(torch, SK, dev, streams[name], l2, h2)[0]
        pairs += p2
        if name == "stored":
            cases.append((streams[name], l2, h2, p2[0][1]))
    reruns, share = [], SK.SURVIVOR_SHARE
    try:
        for room in (1, 0):
            SK.SURVIVOR_SHARE = SK.TILE_BITS // room if room else SK.TILE_BITS + 1
            for stream, a, z, want in cases:
                w2 = words if stream is raw else torch.from_numpy(SK.stream_words(stream)).to(dev)
                before, st = SK.launches["block_find"], {}
                got = SK.block_find_cuda(w2, 8 * len(stream), a, z, stats=st)
                pairs.append((got, want))
                reruns.append({"room": room, "segments": len(a), "last_room": st["room"],
                               "launches": SK.launches["block_find"] - before})
    finally:
        SK.SURVIVOR_SHARE = share
    err = max_abs(pairs)
    if err or any(r["last_room"] != SK.TILE_BITS or r["launches"] != 2 for r in reruns):
        raise AssertionError(f"SP1 disagrees with its plain version or its first design, or "
                             f"a small room did not rerun: max abs err {err}, reruns {reruns}")
    lo_t = torch.tensor(lo, dtype=torch.int64, device=dev)
    hi_t = torch.tensor(hi, dtype=torch.int64, device=dev)
    turns = in_turn(torch, {
        "new": lambda: SK.block_find_cuda(words, nbits, lo, hi),
        "old": lambda: SK.block_find_thread_cuda(words, nbits, lo_t, hi_t)}, 5)
    upto = survivors_to_first_pass(torch, SK, words, nbits, lo, hi, found)
    return {"segments": T - 1, "offsets": nbits - bounds[1], "max_abs_err": err,
            "stats": stats, "plain_ms": plain_ms, "found": found, "upto": upto,
            "reruns": reruns, "turns": turns}


def long_chain_corpus(np, corpus: bytes, size: int = 16 << 20, seed: int = 27) -> bytes:
    """SP3's long chains: a 24 KiB block of the corpus (at an offset drawn
    from `seed`) repeated to `size` bytes, each copy the one before with
    one byte in every 100 changed at random. Deflate copies each from the
    one before, so a segment's cells are markers into the segment before,
    a chain through every segment."""
    rng = np.random.default_rng(seed)
    off = int(rng.integers(0, len(corpus) - 24576))
    blk = np.frombuffer(corpus[off : off + 24576], np.uint8).copy()
    reps = size // 24576
    out = np.empty((reps, 24576), np.uint8)
    at = np.arange(0, 24576, 100)
    for r in range(reps):
        blk[np.minimum(at + rng.integers(0, 100, len(at)), 24575)] = rng.integers(0, 256, len(at))
        out[r] = blk
    return out.tobytes()


def sp3_case(torch, SK, SP, dev, stream: bytes, want: bytes, max_out: int) -> dict:
    """SP3 on the whole chain of one stream as inflate_speculative cuts it:
    the route's launch against the plain version, the first design and
    `want`, all at max abs err 0, with its counters."""
    chain, ofs, total, _end = SP._speculate(stream, max_out, dev, {})
    cells = torch.cat([c.cells for c in chain])
    seg_ofs = torch.tensor(ofs + [total], dtype=torch.int64, device=dev)
    st = {}
    got, flag = SK.spec_resolve_cuda(cells, seg_ofs, stats=st)
    plain, plain_ms = timed_ms(torch, lambda: SK.spec_resolve_plain(cells, seg_ofs))
    old, old_flag = SK.spec_resolve_jump_cuda(cells, seg_ofs)
    err = max_abs([(got, plain[0]), (got, old)])
    if err or flag or plain[1] or old_flag or got.cpu().numpy().tobytes() != want:
        raise AssertionError(f"SP3 disagrees with its plain version, its first design or the "
                             f"stream's input: max abs err {err}")
    fns = {"new": lambda: SK.spec_resolve_cuda(cells, seg_ofs),
           "old": lambda: SK.spec_resolve_jump_cuda(cells, seg_ofs)}
    return {"cells": int(cells.numel()), "spans": len(chain), "max_abs_err": err,
            "plain_ms": plain_ms, "stats": st, "hops_mean": st["hops"] / max(st["markers"], 1),
            "turns": in_turn(torch, fns, 5), "rounds": SK.resolve_rounds(len(chain)),
            "bytes": 3 * total + 8 * (len(chain) + 1)}


def sp_events(torch, SK):
    """kernel_events of SP1, SP2 and SP3."""
    return kernel_events(torch, SK, ("block_find", "spec_decode", "spec_resolve"))


def speculative_streams(corpus: bytes) -> dict:
    """Phase 40's streams of the corpus: stdlib raw deflate at levels 1, 6
    and 9, under Z_FIXED and at level 0 (stored), zlib at level 6 (its
    body), and 64 MiB (the corpus 8 times) at level 6."""
    return {
        "raw6": _raw(corpus), "raw1": _raw(corpus, 1), "raw9": _raw(corpus, 9),
        "fixed": _raw(corpus, 6, zlib.Z_FIXED), "stored": _raw(corpus, 0),
        "zlib6_body": zlib.compress(corpus, 6)[2:], "raw6_64m": _raw(corpus * 8),
    }


def sp2_meta(SP, rows, nbits: int, rec_cap=None):
    """SP.row_meta, each row's block-start list cut to `rec_cap` where given."""
    meta, nc, nr = SP.row_meta(rows, nbits)
    if rec_cap is not None:
        meta[:, 6] = meta[:, 6].clip(max=rec_cap)
    return meta, nc, nr


def sp2_pairs(torch, SK, SP, dev, stream: bytes, rows_sp, pick, rec_cap=None,
              warp: bool = False) -> tuple[list, dict]:
    """SP2 on rows of one stream: the kernel over every row (the main
    path's launch), the plain version over the rows `pick`, and the
    kernel over those rows alone; pairs of every status value and of each
    picked row's written cells and recorded block starts (the kernel
    leaves the rest of its buffers unwritten), and the statuses' why
    counts. `warp` adds the one-warp launch over every row, each row's
    status, cells and records paired with the block launch's."""
    nbits = 8 * len(stream)
    words = torch.from_numpy(SK.stream_words(stream)).to(dev)
    meta, nc, nr = sp2_meta(SP, rows_sp, nbits, rec_cap)
    mt = torch.from_numpy(meta).to(dev)
    full = SK.spec_decode_cuda(words, nbits, mt, nc, nr)
    sub = [rows_sp[i] for i in pick]
    smeta, snc, snr = sp2_meta(SP, sub, nbits, rec_cap)
    sm = torch.from_numpy(smeta).to(dev)
    plain = SK.spec_decode_plain(words, nbits, sm, snc, snr)
    alone = SK.spec_decode_cuda(words, nbits, sm, snc, snr)
    pst = plain[2].cpu()
    pairs = [(alone[2], plain[2])]
    for j, i in enumerate(pick):
        n, nrec = int(pst[j, 0]), int(pst[j, 5])
        d0, dr0 = int(smeta[j, 4]), int(smeta[j, 5])
        want = (plain[0][d0 : d0 + n], plain[1][dr0 : dr0 + nrec])
        for got, c0, r0 in ((full, int(meta[i, 4]), int(meta[i, 5])), (alone, d0, dr0)):
            pairs += [(got[0][c0 : c0 + n], want[0]), (got[1][r0 : r0 + nrec], want[1])]
        pairs.append((full[2][i], plain[2][j]))
    if warp:
        wp = SK.spec_decode_warp_cuda(words, nbits, mt, nc, nr)
        fst = full[2].cpu()
        pairs.append((full[2], wp[2]))
        for i in range(len(rows_sp)):
            n, nrec = int(fst[i, 0]), int(fst[i, 5])
            c0, r0 = int(meta[i, 4]), int(meta[i, 5])
            pairs += [(full[0][c0 : c0 + n], wp[0][c0 : c0 + n]),
                      (full[1][r0 : r0 + nrec], wp[1][r0 : r0 + nrec])]
    why = {}
    for w in full[2][:, 3].tolist():
        why[w] = why.get(w, 0) + 1
    return pairs, why


def sp2_edge_rows(torch, SK, SP, corpus: bytes) -> list:
    """SP2's design edges as (label, stream, rows, rec_cap), each coded
    body long enough for the block: a fixed block of 1,500 runs (258,
    distance 1) right at a row's start (every cell a marker of back 1);
    a stream that needs a dictionary, exact (hist 0 and 100: a reference
    too far back) and guessed; 3,000 literals then 500 (3, 1) matches in
    rooms that overflow on a literal, on a match, and fit; small blocks
    (memLevel 1) from block starts with stops inside a block and on the
    next start, and with record lists of 0, 1 and 3; byte cuts inside a
    symbol, a dynamic header and a stored block."""
    w = BitWriter().fixed_block([65] * 40, 0)
    b = 8 * len(w.out) + w.n
    runs = w.fixed_block([(258, 1)] * 1500 + [65], 1).done()
    far = _raw(corpus[:6000], 6, zdict=corpus[-32768:])
    room = BitWriter().fixed_block([65] * 3000 + [(3, 1)] * 500, 1).done()
    small = _raw(corpus[:64_000], 6, mem=1)
    N = 8 * len(small)
    meta, nc, nr = SP.row_meta([(0, N + 1, 1 << 20, 0)], N)
    _c, recs, st = SK.spec_decode_plain(torch.from_numpy(SK.stream_words(small)), N,
                                        torch.from_numpy(meta), nc, nr)
    starts = recs[: int(st[0, 5]), 0].tolist()
    a, nxt = starts[5], starts[6]
    stored = _raw(corpus[:200_000], 0)
    out = [("runs", runs, [(b, 8 * len(runs) + 1, 1 << 20, SK.WSIZE),
                           (0, 8 * len(runs) + 1, 1 << 20, 0)], None),
           ("far", far, [(0, 8 * len(far) + 1, 1 << 20, h) for h in (0, 100, SK.WSIZE)], None),
           ("room", room, [(0, 8 * len(room) + 1, c, 0) for c in (1000, 3001, 4499, 4500)], None),
           ("stops", small, [(a, nxt - 5, 1 << 20, SK.WSIZE), (a, nxt, 1 << 20, SK.WSIZE),
                             (a, nxt + 1, 1 << 20, SK.WSIZE), (0, a + 1, 1 << 20, 0)], None)]
    out += [(f"records {k}", small, [(0, N + 1, 1 << 20, 0), (a, N + 1, 1 << 20, SK.WSIZE)], k)
            for k in (0, 1, 3)]
    for cut in (len(small) // 2, starts[7] // 8 + 20, len(small) - 3):
        out.append((f"cut {cut}", small[:cut], [(0, 8 * cut + 1, 1 << 20, 0)], None))
    out.append(("cut stored", stored[:100_000], [(0, 800_001, 1 << 20, 0)], None))
    return out


def speculative_phase(torch, dev, corpus, rows) -> dict:
    """Phase 40: SP1, SP2 and SP3 against their plain versions on the card
    at max abs err 0, on the segments of the corpus's level-6 raw stream
    as inflate_speculative cuts them (SP1 on every segment, SP2's plain
    version on a few rows: segment 0's exact decode, two guesses, the
    last segment; the kernel on all of them), on rows of the stored, the
    Z_FIXED and a flipped stream (exact and guessed starts, no start, a
    16-cell cap, an invalid code), and SP3 on the whole chain; then
    inflate_speculative of every stream of speculative_streams back to
    the corpus, each with its segment size, segments, chain misses and
    each kernel's event ms."""
    from zlib_rs_tpu_torch.ops.kernels import speculative_kernel as SK
    from zlib_rs_tpu_torch.parallel import speculative as SP

    t_start = time.perf_counter()
    streams = speculative_streams(corpus)
    seg = SP.SEGMENT_BYTES
    raw = streams["raw6"]
    nbits = 8 * len(raw)
    words = torch.from_numpy(SK.stream_words(raw)).to(dev)
    T = len(raw) // seg
    bounds = [8 * k * seg for k in range(T)] + [nbits]

    # -- SP1 on every segment of the main path's first attempt -----------
    sp1 = sp1_case(torch, SK, dev, streams, seg)
    starts = [0] + sp1["found"]
    cap = SP.segment_cap(seg, 4 * len(corpus))
    sp1_stats, upto, sp1_turns = sp1["stats"], sp1["upto"], sp1["turns"]
    offsets = sp1["offsets"]
    rows["block_find"] = dict(
        source="zlib_rs_tpu_torch/csrc/speculative.cu",
        replaces="native/zrs_native.cpp:1944",
        max_abs_err=sp1["max_abs_err"], ms=mean_of(sp1_turns, "new"), plain_ms=sp1["plain_ms"],
        old_ms=mean_of(sp1_turns, "old"), device_ms=mean_of(sp1_turns, "new", "kernel_ms"),
        old_device_ms=mean_of(sp1_turns, "old", "kernel_ms"),
        turns=sp1_turns, survivors=sp1_stats["survivors"], checked=sp1_stats["checked"],
        survivors_to_first_pass=sum(upto), small_room_reruns=sp1["reruns"],
        # bytes: the stream read once, a pair of bounds in and an offset out
        # a segment; operations: the pre-filter's ~16 integer steps an offset
        bnd=bound(len(raw) + 24 * (T - 1), 16 * offsets),
    )
    print(f"phase 40 SP1: {T - 1} segments, {offsets} offsets, {sp1_stats['survivors']} "
          f"survivors, {sp1_stats['checked']} checked ({sum(upto)} up to each segment's first "
          f"pass, at most {max(upto)} in one); rooms of 1 and 0 rerun "
          + json.dumps(sp1["reruns"]) + "; the launch against its first design in turn "
          + json.dumps(sp1_turns), flush=True)

    # -- SP2 on the same segments, and on crafted rows of other streams ---
    rows_sp = [(0, bounds[1], cap, 0)] + [
        (s, bounds[k + 1], cap if s >= 0 else 0, SK.WSIZE) for k, s in enumerate(starts[1:], 1)]
    pick = [0, 1, T // 2, T - 1]
    pairs2, whys = sp2_pairs(torch, SK, SP, dev, raw, rows_sp, pick)
    crafted = {}
    for name, stream, extra in (
        ("stored", streams["stored"], []),
        ("fixed", streams["fixed"], []),
        ("flipped", _flip(raw, len(raw) // 3), [(8 * (len(raw) // 3 - 20), nbits, 1 << 20, 0)]),
    ):
        n2 = 8 * len(stream)
        w2 = torch.from_numpy(SK.stream_words(stream)).to(dev)
        g2 = SK.block_find_cuda(w2, n2, [8 * seg, 16 * seg], [16 * seg, 24 * seg]).tolist()
        r2 = [(0, 8 * seg, cap, 0), (g2[0], 16 * seg, cap if g2[0] >= 0 else 0, SK.WSIZE),
              (g2[1], 24 * seg, 16 if g2[1] >= 0 else 0, SK.WSIZE), (-1, n2, 0, SK.WSIZE)] + extra
        p2, w = sp2_pairs(torch, SK, SP, dev, stream, r2, list(range(len(r2))), warp=True)
        pairs2 += p2
        crafted[name] = w
    for name, stream, r2, rec_cap in sp2_edge_rows(torch, SK, SP, corpus):
        p2, w = sp2_pairs(torch, SK, SP, dev, stream, r2, list(range(len(r2))), rec_cap,
                          warp=True)
        pairs2 += p2
        crafted[name] = w
    err2 = max_abs(pairs2)
    if err2:
        raise AssertionError(f"SP2 disagrees with its plain version: max abs err {err2}")
    meta, nc, nr = SP.row_meta(rows_sp, nbits)
    meta_t = torch.from_numpy(meta).to(dev)
    # the block launch against the one-warp launch it replaced, in turn
    sp2_fns = {"block": lambda: SK.spec_decode_cuda(words, nbits, meta_t, nc, nr),
               "warp": lambda: SK.spec_decode_warp_cuda(words, nbits, meta_t, nc, nr)}
    sp2_ms = {"block": [], "warp": []}
    for who in ("block", "warp", "warp", "block"):
        sp2_ms[who].append(event_ms(torch, sp2_fns[who], 3))
    ms2, warp2 = (sum(sp2_ms[k]) / 2 for k in ("block", "warp"))
    sp2_stats = {}
    st_full = SK.spec_decode_cuda(words, nbits, meta_t, nc, nr, stats=sp2_stats)[2].cpu()
    cells_written, n_recs = int(st_full[:, 0].sum()), int(st_full[:, 5].sum())
    # the exact row of the whole stream (inflate_raw's launch), both launches
    emeta, enc, enr = SP.row_meta([(0, nbits + 1, 4 * len(corpus), 0)], nbits)
    em = torch.from_numpy(emeta).to(dev)
    exact, exact_ms = {}, {}
    for who, fn in (("block", SK.spec_decode_cuda), ("warp", SK.spec_decode_warp_cuda)):
        exact_ms[who] = event_ms(torch, lambda fn=fn: fn(words, nbits, em, enc, enr), 1)
        exact[who] = fn(words, nbits, em, enc, enr)
    got_exact = exact["block"][0][: len(corpus)].cpu().numpy().astype("u1").tobytes()
    if (not torch.equal(exact["block"][2], exact["warp"][2]) or int(exact["block"][2][0, 0])
            != len(corpus) or got_exact != corpus):
        raise AssertionError("SP2's exact row is not the corpus or not the one-warp launch's")
    sub_meta = SP.row_meta([rows_sp[i] for i in pick], nbits)
    sm_t = torch.from_numpy(sub_meta[0]).to(dev)
    _p, plain2_ms = timed_ms(torch, lambda: SK.spec_decode_plain(words, nbits, sm_t,
                                                                 *sub_meta[1:]))

    # -- SP3 on the whole chain of the level-6 stream, and on long chains --
    import numpy as np

    stats = {}
    SP._speculate(raw, 4 * len(corpus), dev, stats)
    sp3 = sp3_case(torch, SK, SP, dev, raw, corpus, 4 * len(corpus))
    chains = long_chain_corpus(np, corpus)
    sp3_long = sp3_case(torch, SK, SP, dev, _raw(chains), chains, 4 * len(chains))
    ms3, err3 = mean_of(sp3["turns"], "new"), sp3["max_abs_err"] + sp3_long["max_abs_err"]
    rows["spec_decode"] = dict(
        source="zlib_rs_tpu_torch/csrc/speculative.cu",
        replaces="native/zrs_native.cpp:1798",
        max_abs_err=err2, ms=ms2, plain_ms=plain2_ms, plain_rows=len(pick), warp_ms=warp2,
        windows=sp2_stats["windows"], sync_rounds=sp2_stats["sync_rounds"],
        max_sync_rounds=sp2_stats["max_sync_rounds"], jump_rounds=sp2_stats["jump_rounds"],
        serial_finishes=sp2_stats["serial_finishes"],
        head_ms=sp2_stats["ns_head"] / 1e6, sync_ms=sp2_stats["ns_sync"] / 1e6,
        expand_ms=sp2_stats["ns_expand"] / 1e6, exact_ms=exact_ms["block"],
        exact_warp_ms=exact_ms["warp"],
        # bytes: the stream read once, each cell this run's segments decode
        # written once (2 bytes), each block start (8) and each segment's
        # meta and status (96)
        bnd=bound(len(raw) + 2 * cells_written + 8 * n_recs + 96 * T, 0),
    )
    rows["spec_resolve"] = dict(
        source="zlib_rs_tpu_torch/csrc/speculative.cu",
        replaces="native/zrs_native.cpp:2685",
        max_abs_err=err3, ms=ms3, plain_ms=sp3["plain_ms"], old_ms=mean_of(sp3["turns"], "old"),
        device_ms=mean_of(sp3["turns"], "new", "kernel_ms"),
        old_device_ms=mean_of(sp3["turns"], "old", "kernel_ms"),
        turns=sp3["turns"], hops_max=sp3["stats"]["max_hops"], hops_mean=sp3["hops_mean"],
        pending=sp3["stats"]["pending"], long_chain=sp3_long,
        # bytes: each cell read once (2 bytes), each byte written once, the
        # segments' offsets read once
        bnd=bound(sp3["bytes"], 0),
    )
    print(f"phase 40 SP3: the {sp3['spans']} spans of raw-6 ({sp3['cells']} cells) "
          + json.dumps({k: v for k, v in sp3.items() if k != "bytes"}) + f"; long chains "
          f"({len(chains)} bytes) " + json.dumps({k: v for k, v in sp3_long.items()
                                                   if k != "bytes"}), flush=True)
    print(f"phase 40 SP2: the block launch over the {T} rows {sp2_ms['block']} ms against the "
          f"one-warp launch's {sp2_ms['warp']} in turn; the exact row of the stream "
          f"{exact_ms['block']:.3f} ms against {exact_ms['warp']:.3f} ({len(corpus)} cells, equal); "
          f"the block's counters over the rows (blocks' ns summed) " + json.dumps(sp2_stats),
          flush=True)
    print(f"phase 40 SP1-SP3: {T} segments of {seg} bytes of the {len(raw)}-byte raw-6 stream; "
          f"SP1 equal to plain on every segment and 16 of the stored and Z_FIXED streams "
          f"({sum(x >= 0 for x in starts[1:])} guesses); SP2 equal to plain on rows {pick} "
          f"(whys {whys}) and on crafted rows (whys {crafted}); SP3 equal to plain and the "
          f"corpus over {sp3['spans']} chained spans, {sp3['stats']['markers']} markers, and "
          f"on {sp3_long['spans']} spans of long chains; chain {stats}", flush=True)

    # -- inflate_speculative of every stream ------------------------------
    result = {"segment_bytes": seg, "streams": {}, "sp1": rows["block_find"]["turns"],
              "sp3": sp3, "sp3_long_chains": sp3_long}
    for label, stream in streams.items():
        want_out = corpus * 8 if label == "raw6_64m" else corpus
        for c in SK.launches:
            SK.launches[c] = 0
        st = {}
        with sp_events(torch, SK) as ev:
            t0 = time.perf_counter()
            out, used = SP.inflate_speculative(stream, 4 * len(want_out), stats=st)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if out != want_out:
            raise AssertionError(f"inflate_speculative of {label} is not the corpus")
        launched = dict(SK.launches)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        SP.inflate_speculative(stream, 4 * len(want_out))
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        result["streams"][label] = {"bytes": len(stream), "in_used": used, "cold_s": wall,
                                    "warm_s": warm, "launches": launched, "stats": st,
                                    "peak_device_bytes": peak,
                                    "event_ms": {k: round(sum(v), 4) for k, v in ev.items()}}
        print(f"phase 40 {label}: {len(stream)} bytes -> {len(want_out)} in {warm:.4f} s warm "
              f"({len(want_out) / warm / 1e6:.1f} MB/s; cold {wall:.4f} s), segments "
              f"{st['segments']} of {st['segment_bytes']} bytes, chained {st['chained']}, "
              f"misses {st['misses']}, SP1/SP2 rounds {st['attempts']}, launches {launched}, "
              f"peak device memory {peak} bytes ({peak / len(stream):.2f} an input byte), "
              f"event ms " + json.dumps(result["streams"][label]["event_ms"]), flush=True)
    # the segment size against the raw-6 stream's warm wall: two warm runs each
    sweep = {}
    for size in (8192, 16384, 32768, 65536):
        SP.SEGMENT_BYTES = size
        try:
            SP.inflate_speculative(raw, 4 * len(corpus))
            walls = []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out, _used = SP.inflate_speculative(raw, 4 * len(corpus))
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
        finally:
            SP.SEGMENT_BYTES = seg
        if out != corpus:
            raise AssertionError(f"inflate_speculative at {size}-byte segments is not the corpus")
        sweep[size] = walls
    result["segment_sweep_s"] = sweep
    print("phase 40 segment sweep, raw-6, warm s by segment bytes: " + json.dumps(sweep),
          flush=True)
    result["big"] = big_stream_decode(torch, SK, SP)
    result["phase_s"] = time.perf_counter() - t_start
    print(f"phase 40: {result['phase_s']:.1f} s", flush=True)
    return result


BIG_STREAM_MIN = (1 << 28) + (1 << 20)  # compressed bytes: bit positions past int32


def big_stream(np) -> tuple[bytes, bytes]:
    """Random bytes over a 64-letter alphabet (seed 7) and their raw
    deflate at level 1 (dynamic blocks), at least BIG_STREAM_MIN bytes of
    it: 8 pieces compressed by stdlib zlib at once, joined at sync seams."""
    import threading

    size = 400 << 20
    data = (np.random.default_rng(7).integers(0, 64, size, dtype=np.uint8) + 48).tobytes()
    step = -(-size // 8)
    pieces = [b""] * 8

    def job(i):
        c = zlib.compressobj(1, zlib.DEFLATED, -15)
        pieces[i] = c.compress(data[i * step : (i + 1) * step]) + c.flush(
            zlib.Z_FINISH if i == 7 else zlib.Z_SYNC_FLUSH)

    threads = [threading.Thread(target=job, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    stream = b"".join(pieces)
    if len(stream) < BIG_STREAM_MIN:
        raise AssertionError(f"the big stream has {len(stream)} bytes, under {BIG_STREAM_MIN}")
    return data, stream


def big_stream_decode(torch, SK, SP) -> dict:
    """Phase 40's stream past int32 bit positions: inflate_speculative of
    big_stream, cold and warm, back to its input, with its peak device
    memory, SP1-SP3's launches and the warm run's event ms a kernel."""
    import numpy as np

    t0 = time.perf_counter()
    data, stream = big_stream(np)
    make_s = time.perf_counter() - t0
    for c in SK.launches:
        SK.launches[c] = 0
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    walls, st = [], {}
    for _ in range(2):
        with sp_events(torch, SK) as ev:
            t0 = time.perf_counter()
            out, used = SP.inflate_speculative(stream, len(data) + (1 << 20), stats=st)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        if out != data or used != len(stream):
            raise AssertionError("inflate_speculative of the big stream is not its input")
        del out
    peak = torch.cuda.max_memory_allocated() - base
    res = {"bytes": len(stream), "out_bytes": len(data), "bits": 8 * len(stream),
           "cold_s": walls[0], "warm_s": walls[1], "make_s": make_s,
           "peak_device_bytes": peak, "launches": dict(SK.launches), "stats": st,
           "warm_event_ms": {k: round(sum(v), 4) for k, v in ev.items()}}
    print(f"phase 40 big: {len(stream)} bytes ({8 * len(stream)} bits, past 2^31) -> "
          f"{len(data)} in {walls[1]:.4f} s warm ({len(data) / walls[1] / 1e6:.1f} MB/s; cold "
          f"{walls[0]:.4f} s), equal to its input; segments {st['segments']}, misses "
          f"{st['misses']}, launches {res['launches']}, peak device memory {peak} bytes, the "
          f"warm run's event ms {res['warm_event_ms']}; made in {make_s:.1f} s", flush=True)
    return res


def zraw_chunk(data: bytes, level: int, final: bool, window: bytes) -> bytes:
    """stdlib zlib's raw deflate of a chunk primed with `window` (Z_FINISH
    when final, Z_SYNC_FLUSH when not): EX's oracle at levels 1-9."""
    kw = {"zdict": window} if window else {}
    c = zlib.compressobj(level, zlib.DEFLATED, -15, 8, 0, **kw)
    return c.compress(data) + c.flush(zlib.Z_FINISH if final else zlib.Z_SYNC_FLUSH)


EX_MODES = [*range(10), 10, 11, 12, 13]  # levels 0-9, QUICK, MEDIUM4-6
EX_ROW = 16 * 1024  # phase 41's rows against the plain version


def ex_rows(corpus: bytes, level: int) -> list:
    """Four rows of EX_ROW bytes of the corpus at `level`'s own offset:
    (start, len, dict_len, final), unprimed and primed with 32 KiB, final
    and not."""
    base = (3 + 2 * level) * 65_536 + 4097 * level
    return [(base + k * 2 * EX_ROW, EX_ROW, 32768 if k & 1 else 0, k >> 1) for k in range(4)]


def ex_split(torch, EK, dev, data_t, meta, level: int, reps: int = 3) -> dict:
    """EX at levels 4-9 over one round of meta's chunks, by CUDA events: the
    resolve's ms and the chase's ms (a mean of `reps` after a warm-up), the
    chase's share in flush_block by clock64 (the slowest warp's, times the
    chase's ms), and the candidates the walks compare."""
    [(nch, [(pieces, nd, ns, cb, wb)])] = EK.plan(meta.cpu().tolist())
    pt = torch.from_numpy(pieces).to(dev)
    deltas = torch.empty(nd, dtype=torch.int16, device=dev)
    slots = torch.empty(ns, 2, dtype=torch.int32, device=dev)
    out = torch.empty(int((meta[:, 4] + meta[:, 5]).max()), dtype=torch.uint8, device=dev)
    lens = torch.zeros(meta.shape[0], dtype=torch.int64, device=dev)
    st = torch.zeros(meta.shape[0], dtype=torch.int32, device=dev)
    recs = torch.zeros(nch * EK.REC, dtype=torch.int64, device=dev)
    scratch = torch.empty(nch * EK.WORK_BYTES, dtype=torch.uint8, device=dev)
    clk = torch.zeros(pieces.shape[0], 3, dtype=torch.int64, device=dev)
    count = torch.zeros(1, dtype=torch.int64, device=dev)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    res_ms = chase_ms = 0.0
    saved = dict(EK.launches)
    for rep in range(reps + 1):
        count.zero_()
        ev[0].record()
        EK.resolve_cuda(data_t, pt, level, deltas, slots, cb, wb, count=count)
        ev[1].record()
        EK.chase_cuda(data_t, meta, pt, level, out, lens, st, recs, scratch, slots, deltas, clk)
        ev[2].record()
        torch.cuda.synchronize()
        if rep:
            res_ms += ev[0].elapsed_time(ev[1]) / reps
            chase_ms += ev[1].elapsed_time(ev[2]) / reps
    EK.launches.update(saved)
    c = clk.cpu()
    slow = int(c[:, 0].argmax())
    share = float(c[slow, 1]) / float(c[slow, 0])
    emit = float(c[slow, 2]) / float(c[slow, 0])
    r = {"resolve_ms": res_ms, "chase_ms": chase_ms, "flush_ms": chase_ms * share,
         "emit_ms": chase_ms * emit, "flush_share_slowest": share,
         "flush_share_all": float(c[:, 1].sum() / c[:, 0].sum()),
         "candidates": int(count.item()), "positions": ns, "chain_positions": nd}
    print(f"phase 41 EX level {level} split ({meta.shape[0]} chunks, {ns} positions): resolve "
          f"{res_ms:.3f} ms ({r['candidates']} candidates compared), chase {chase_ms:.3f} ms, of "
          f"which flush_block {r['flush_ms']:.3f} ms and of that emit_symbols "
          f"{r['emit_ms']:.3f} ms (the slowest warp's clock64 shares {share:.3f} and "
          f"{emit:.3f}; flush_block's over all warps {r['flush_share_all']:.3f})", flush=True)
    return r


def ex_split_greedy(torch, EK, dev, data_t, meta, level: int, reps: int = 3) -> dict:
    """EX at levels 1-3 and MEDIUM over one round of meta's chunks, by CUDA
    events (a mean of `reps` after a warm-up, EK.ROUNDS[level] rounds): the
    resolve's ms a round (the chains under the map and the walks), the dry
    parse's ms a parse and the chase's ms (and of it flush_block's, by the
    slowest warp's clock64 share), with the chase's loop tops and live
    walks (MEDIUM: its walks, a loop top's and the lookahead's) and the
    candidates a round's walks compare."""
    import numpy as np

    medium = EK.is_medium(level)
    [(nch, [(pieces, nd, ns, cb, wb)])] = EK.plan(meta.cpu().tolist(), level=level)
    pt = torch.from_numpy(pieces).to(dev)
    deltas = torch.empty(nd, dtype=torch.int16, device=dev)
    dlist = torch.empty_like(deltas)
    slots = torch.empty(ns, 2, dtype=torch.int32, device=dev)
    out = torch.empty(int((meta[:, 4] + meta[:, 5]).max()), dtype=torch.uint8, device=dev)
    lens = torch.zeros(meta.shape[0], dtype=torch.int64, device=dev)
    st = torch.zeros(meta.shape[0], dtype=torch.int32, device=dev)
    recs = torch.zeros(nch * EK.REC, dtype=torch.int64, device=dev)
    scratch = torch.empty(nch * EK.WORK_BYTES, dtype=torch.uint8, device=dev)
    stride = max(EK.bit_words(int(m[1] + m[2])) for m in meta.tolist())
    first = torch.zeros(nch * stride, dtype=torch.int32, device=dev)
    if medium:
        first = torch.from_numpy(EK.medium_map(meta.tolist(), stride).view(np.int32)).to(dev)
    bits = first.clone()
    stats = torch.zeros(2, dtype=torch.int64, device=dev)
    count = torch.zeros(1, dtype=torch.int64, device=dev)
    clk = torch.zeros(pieces.shape[0], 3, dtype=torch.int64, device=dev)
    rounds = EK.ROUNDS[level]
    res_ms = dry_ms = chase_ms = 0.0
    saved = dict(EK.launches)
    extra = {"data": data_t} if medium else {}
    share = None
    if medium:  # the rounds run_static takes: the first round's long matches decide
        EK.resolve_cuda(data_t, pt, level, deltas, slots, cb, wb, bits=bits, bit_stride=stride)
        share = EK.long_share(slots, level)
        if rounds > 1 and not EK.take_round(level, slots):
            rounds = 1
    for rep in range(reps + 1):
        bits.copy_(first)
        stats.zero_()
        count.zero_()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2 * rounds + 1)]
        for r in range(rounds):
            if r:
                EK.dry_cuda(pt, level, slots, bits, stride, recs, **extra)
            ev[2 * r].record()
            EK.resolve_cuda(data_t, pt, level, deltas, slots, cb, wb, count=count, bits=bits,
                            bit_stride=stride)
            ev[2 * r + 1].record()
        EK.chase_cuda(data_t, meta, pt, level, out, lens, st, recs, scratch, slots, deltas, clk,
                      dlist=dlist, bits=bits, bit_stride=stride, stats=stats)
        ev[2 * rounds].record()
        torch.cuda.synchronize()
        if rep:
            res_ms += sum(ev[2 * r].elapsed_time(ev[2 * r + 1])
                          for r in range(rounds)) / rounds / reps
            dry_ms += sum(ev[2 * r - 1].elapsed_time(ev[2 * r])
                          for r in range(1, rounds)) / max(rounds - 1, 1) / reps
            chase_ms += ev[2 * rounds - 1].elapsed_time(ev[2 * rounds]) / reps
    EK.launches.update(saved)
    tops, lives = stats.tolist()
    c = clk.cpu()
    slow = int(c[:, 0].argmax())
    return {"rounds": rounds, "long_share": share, "resolve_ms": res_ms, "dry_ms": dry_ms,
            "chase_ms": chase_ms,
            "flush_ms": chase_ms * float(c[slow, 1]) / float(c[slow, 0]),
            "tops": tops, "lives": lives, "live_share": lives / max(tops, 1), "positions": ns,
            "chain_positions": nd, "candidates": int(count.item()) // rounds}


def exact_deflate_phase(torch, dev, corpus, rows) -> dict:
    """Phase 41: EX against its plain version on rows of EX_ROW bytes of
    the corpus at every level 0-9, QUICK and MEDIUM4-6, primed and not,
    final and not, on rows of random bytes, and on a row whose room
    overflows (bytes, lengths, status; max abs err 0); the resolve's deltas
    and slots at levels 1-9 against its plain version on the same rows (at
    1-3 under no skipped position and under a random skip map), and at 1-3
    the dry parse of those slots against its plain version (max abs err
    0); then the main path: `deflate_parallel` of the corpus at levels 1,
    2, 3, 6 and 9 (128 KiB chunks; the resolve and the chase, at 1-3 with
    EK.ROUNDS[level] rounds and the dry parse), every chunk equal to stdlib zlib's
    primed raw deflate (Z_SYNC_FLUSH, Z_FINISH for the last), cold and
    three warm; QUICK and MEDIUM4-6 of the corpus back through zlib, their
    first two chunks equal to the plain version's, three warm; EX's ms a
    call by CUDA events at levels 1, 2, 3, 6 and 9, and the resolve's, the
    chase's and flush_block's at 6 and 9 (ex_split); at 1-3 an `ex_split`
    line at EK.ROUNDS[level] rounds (the call's ms, the resolve's a round,
    the dry parse's, the chase's, the live walks a loop top;
    ex_split_greedy);
    at levels 1 and 3 the dry parse of the first round over the corpus
    chunks (as run_static runs it) against its plain version on every
    chunk, and the second round's resolve under that map against its plain
    version on two whole chunks (max abs err 0);
    the one-shot `compress` of 1 MiB at levels 1, 2, 3, 6 and 9 and of the
    corpus at level 6 (two pieces) equal to zlib.compress, with its
    seconds (one warp a piece). The level-6 chunks also go in several
    batches, cut once by ROUND positions and once by MAX_SLOTS chunks
    (fresh records and scratch a batch), a resolve and a chase a batch."""
    import numpy as np

    from zlib_rs_tpu_torch.models import oneshot
    from zlib_rs_tpu_torch.ops.kernels import exact_deflate_kernel as EK
    from zlib_rs_tpu_torch.parallel import chunk_deflate as CD

    t_start = time.perf_counter()
    data_t = torch.from_numpy(np.frombuffer(corpus, np.uint8).copy()).to(dev)

    def meta_of(rs, level):
        return torch.from_numpy(CD.chunk_meta(rs, level)).to(dev)

    def ex_pairs(got, want, meta):
        pairs = [(got[1], want[1]), (got[2], want[2])]
        for k, (off, cap) in enumerate(meta[:, 4:].tolist()):
            n = min(int(want[1][k]), cap)
            pairs.append((got[0][off : off + n], want[0][off : off + n]))
        return pairs

    # random bytes (stored blocks, QUICK's rewind to stored) and a room of
    # 1,000 bytes (the overflow status, the bytes within the room)
    rnd_t = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, 32768 + EX_ROW // 2, dtype=np.uint8)).to(dev)
    pairs = []
    for level in EX_MODES:
        for buf, meta in ((data_t, meta_of(ex_rows(corpus, level), level)),
                          (rnd_t, meta_of([(32768, EX_ROW // 2, 32768, 1),
                                           (0, EX_ROW // 2, 0, 0)], level))):
            pairs += ex_pairs(EK.exact_deflate_cuda(buf, meta, level),
                              EK.exact_deflate_plain(buf, meta, level), meta)
    small = torch.tensor([[0, EX_ROW // 2, 0, 1, 0, 1000]], dtype=torch.int64, device=dev)
    got, want = EK.exact_deflate_cuda(rnd_t, small, 1), EK.exact_deflate_plain(rnd_t, small, 1)
    if int(got[2][0]) != EK.OVERFLOW:
        raise AssertionError("EX did not report an output past its room")
    pairs += ex_pairs(got, want, small)
    err = max_abs(pairs)
    if err:
        raise AssertionError(f"EX disagrees with its plain version: max abs err {err}")
    print(f"phase 41 EX: {4 * len(EX_MODES)} rows of {EX_ROW} bytes of the corpus and "
          f"{2 * len(EX_MODES)} of {EX_ROW // 2} random bytes (levels 0-9, QUICK, MEDIUM4-6; "
          f"primed and not, final and not) and an overflowing row equal to plain in bytes, "
          f"lengths and status", flush=True)

    # -- the resolve (levels 1-9, MEDIUM4-6) and the dry parse (1-3,
    # MEDIUM4-6) against their plain versions on the rows ----------------
    t0 = time.perf_counter()
    res_pairs, dry_pairs = [], []
    for level in (*range(1, 10), *MEDIUM_LEVELS):
        medium = EK.is_medium(level)
        rs = meta_of(ex_rows(corpus, level % 10), level).tolist()
        pieces, nd, ns, cb, wb = EK.with_offsets([EK.ex_piece(m, m[2], k, k, EK.PIECE, medium)
                                                  for k, m in enumerate(rs)], medium)
        pt = torch.from_numpy(pieces).to(dev)
        stride = max(EK.bit_words(int(m[1] + m[2])) for m in rs)
        rng = np.random.default_rng(level)
        # a quarter of the positions skipped, at random
        rand = (rng.integers(0, 1 << 32, len(rs) * stride, dtype=np.uint64)
                & rng.integers(0, 1 << 32, len(rs) * stride, dtype=np.uint64)).astype(np.uint32)
        first = EK.medium_map(rs, stride) if medium else np.zeros_like(rand)
        maps = [first, rand] if EK.mapped_level(level) else [None]
        recs = torch.zeros(len(rs) * EK.REC, dtype=torch.int64, device=dev)
        more = {"recs": recs, "data": data_t} if medium else {}
        for words in maps:
            kw = {} if words is None else {
                "bits": torch.from_numpy(words.view(np.int32).copy()).to(dev), "bit_stride": stride}
            deltas = torch.empty(nd, dtype=torch.int16, device=dev)
            slots = torch.empty(ns, 2, dtype=torch.int32, device=dev)
            EK.resolve_cuda(data_t, pt, level, deltas, slots, cb, wb, **kw)
            want_d, want_s = EK.resolve_plain(data_t, pt, level, **kw)
            res_pairs += [(EK.unsigned(deltas), EK.unsigned(want_d)), (slots, want_s)]
            if words is not None:
                EK.dry_cuda(pt, level, slots, kw["bits"], stride, **more)
                plain = words.copy()
                EK.dry_plain(pieces, level, slots.cpu().numpy().astype(np.int64), plain, stride,
                             recs.cpu().numpy() if medium else None, corpus if medium else None)
                dry_pairs.append((EK.unsigned(kw["bits"]).cpu(),
                                  torch.from_numpy(plain.astype(np.int64))))
    res_err, dry_err = max_abs(res_pairs), max_abs(dry_pairs)
    if res_err or dry_err:
        raise AssertionError(f"the resolve or the dry parse disagrees with its plain version: "
                             f"max abs err {res_err}, {dry_err}")
    print(f"phase 41 resolve: the deltas and slots of phase 41's rows at levels 1-9 and MEDIUM4-6 "
          f"(at 1-3 and MEDIUM under the first round's map and under a random map) equal to "
          f"plain, max abs err {res_err}; the dry parse of those at 1-3 and MEDIUM equal to "
          f"plain, max abs err {dry_err} ({time.perf_counter() - t0:.1f} s)", flush=True)

    # -- the main path: deflate_parallel at levels 1, 6 and 9 --------------
    chunk = CD.DEFAULT_CHUNK
    n = len(corpus)
    starts = list(range(0, n, chunk))
    result = {"levels": {}, "modes": {}}
    launched = None
    for level in (1, 2, 3, 6, 9):
        EK.launches.update(dict.fromkeys(EK.launches, 0))
        t0 = time.perf_counter()
        out = CD.deflate_parallel(corpus, level)
        cold = time.perf_counter() - t0
        if level == 1:
            launched1 = dict(EK.launches)
        if level == 6:
            launched = EK.launches["exact_deflate"]
            launched_res = EK.launches["exact_resolve"]
        parts = [zraw_chunk(corpus[lo : lo + chunk], level, lo + chunk >= n,
                            corpus[max(0, lo - 32768) : lo]) for lo in starts]
        if level == 6:
            zlib6 = parts
        want = b"".join(parts)
        if out != want or zlib.decompress(out, -15) != corpus:
            raise AssertionError(f"deflate_parallel at level {level} is not zlib's chunk by chunk")
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            again = CD.deflate_parallel(corpus, level)
            walls.append(time.perf_counter() - t0)
            if again != out:
                raise AssertionError(f"a warm deflate_parallel at level {level} differs")
        mbs = sorted(n / w / 1e6 for w in walls)
        result["levels"][level] = {"bytes": len(out), "cold_s": cold, "warm_s": walls,
                                   "mb_s_median": mbs[1], "sha256": hashlib.sha256(out).hexdigest()}
        print(f"phase 41 deflate_parallel level {level}: {digest(out)}, equal to zlib on all "
              f"{len(starts)} chunks; cold {cold:.3f} s, warm {[round(w, 4) for w in walls]} s "
              f"(median {mbs[1]:.3f} MB/s)", flush=True)
    medium_launches = {}
    for level in (CD.QUICK, CD.MEDIUM4, CD.MEDIUM5, CD.MEDIUM6):
        EK.launches.update(dict.fromkeys(EK.launches, 0))
        out = CD.deflate_parallel(corpus, level)
        if zlib.decompress(out, -15) != corpus:
            raise AssertionError(f"deflate_parallel in mode {level} does not round-trip")
        if EK.is_medium(level):  # the resolve's rounds and one chase, no one-warp run_medium
            medium_launches[level] = dict(EK.launches)
            r = EK.launches["exact_resolve"]
            if not 1 <= r <= EK.ROUNDS[level] or medium_launches[level] != {
                    "exact_deflate": 1, "exact_resolve": r, "exact_dry": r - 1}:
                raise AssertionError(f"deflate_parallel at MEDIUM {level} launched "
                                     f"{medium_launches[level]}")
        first = [EK.plain_chunk(corpus[lo : lo + chunk], level, False,
                                corpus[max(0, lo - 32768) : lo]) for lo in starts[:2]]
        meta = meta_of([(lo, chunk, min(32768, lo), 0) for lo in starts[:2]], level)
        got = EK.exact_deflate_cuda(data_t, meta, level)
        lens = got[1].tolist()
        if [got[0][o : o + m].cpu().numpy().tobytes() for o, m in
                zip(meta[:, 4].tolist(), lens)] != first:
            raise AssertionError(f"mode {level}'s first two chunks differ from plain")
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            CD.deflate_parallel(corpus, level)
            walls.append(time.perf_counter() - t0)
        mbs = sorted(n / w / 1e6 for w in walls)
        result["modes"][level] = {"bytes": len(out), "warm_s": walls, "mb_s_median": mbs[1],
                                  "sha256": hashlib.sha256(out).hexdigest()}
        print(f"phase 41 deflate_parallel mode {level}: {digest(out)}, round trip through zlib, "
              f"first two chunks equal to plain; warm {[round(w, 4) for w in walls]} s (median "
              f"{mbs[1]:.3f} MB/s)", flush=True)

    # -- EX at the main path's shape: the call, and at levels 6 and 9 the
    # resolve, the chase and the chase's share in flush_block --------------
    meta6 = meta_of([(lo, min(n, lo + chunk) - lo, min(32768, lo), int(lo + chunk >= n))
                     for lo in starts], 6)
    meta9 = meta_of([(lo, min(n, lo + chunk) - lo, min(32768, lo), int(lo + chunk >= n))
                     for lo in starts], 9)
    call_ms = event_ms(torch, lambda: EK.exact_deflate_cuda(data_t, meta6, 6), 3)
    call9_ms = event_ms(torch, lambda: EK.exact_deflate_cuda(data_t, meta9, 9), 3)
    first = meta6[:1]
    _p, plain_ms = timed_ms(torch, lambda: EK.exact_deflate_plain(data_t, first, 6))
    lens6 = EK.exact_deflate_cuda(data_t, meta6, 6)[1]
    nout = int(lens6.sum())
    split = {level: ex_split(torch, EK, dev, data_t, m, level)
             for level, m in ((6, meta6), (9, meta9))}
    result["split"] = split
    result["call_ms"] = {6: call_ms, 9: call9_ms}
    # levels 1-3: the call and its split (EK.ROUNDS[level] rounds; the
    # other round counts are ex_fast_probe.py's)
    greedy = {}
    for level in (1, 2, 3):
        meta = meta_of([(lo, min(n, lo + chunk) - lo, min(32768, lo), int(lo + chunk >= n))
                        for lo in starts], level)
        call = event_ms(torch, lambda: EK.exact_deflate_cuda(data_t, meta, level), 3)
        g = ex_split_greedy(torch, EK, dev, data_t, meta, level)
        g["call_ms"] = call
        greedy[level] = g
        rounds = g["rounds"]
        print(f"phase 41 ex_split level {level}: call {call:.3f} ms; resolve "
              f"{g['resolve_ms']:.3f} ms a round x {rounds}, dry parse {g['dry_ms']:.3f} ms x "
              f"{rounds - 1}, chase {g['chase_ms']:.3f} ms (flush_block {g['flush_ms']:.3f} ms "
              f"of it); live walks {g['lives']} / loop tops {g['tops']} = "
              f"{g['live_share']:.4f}; {g['candidates']} candidates a round", flush=True)
    result["greedy"] = greedy
    g1 = greedy[1]
    # MEDIUM4-6: the call and its split (EK.ROUNDS[level] rounds; a walk a
    # fresh loop top and one a lookahead)
    mediums = {}
    for level in MEDIUM_LEVELS:
        meta = meta_of([(lo, min(n, lo + chunk) - lo, min(32768, lo), int(lo + chunk >= n))
                        for lo in starts], level)
        call = event_ms(torch, lambda: EK.exact_deflate_cuda(data_t, meta, level), 3)
        g = ex_split_greedy(torch, EK, dev, data_t, meta, level)
        g["call_ms"] = call
        mediums[level] = g
        rounds = g["rounds"]
        print(f"phase 41 ex_split MEDIUM{level - 7}: call {call:.3f} ms; resolve "
              f"{g['resolve_ms']:.3f} ms a round x {rounds}, dry parse {g['dry_ms']:.3f} ms x "
              f"{rounds - 1}, chase {g['chase_ms']:.3f} ms (flush_block {g['flush_ms']:.3f} ms "
              f"of it); live walks {g['lives']} / walks {g['tops']} = {g['live_share']:.4f}; "
              f"{g['candidates']} candidates a round; long matches "
              f"{g['long_share']:.4f} of the first round's slots", flush=True)
    result["medium"] = mediums

    # the dry parse and the resolve under its map at the main path's shape
    # (levels 1 and 3): the first round over the corpus chunks as
    # run_static runs it (EK.plan's pieces, fresh records, no position
    # skipped), the dry parse of its slots against dry_plain on every chunk,
    # then the second round's resolve under that map against resolve_plain
    # on chunk 1 and the last
    t0 = time.perf_counter()
    main_dry, main_res = [], []
    for level in (1, 3, CD.MEDIUM4, CD.MEDIUM6):
        medium = EK.is_medium(level)
        meta = meta_of([(lo, min(n, lo + chunk) - lo, min(32768, lo), int(lo + chunk >= n))
                        for lo in starts], level)
        rs = meta.cpu().tolist()
        [(nch, [(pieces, nd, ns, cb, wb)])] = EK.plan(rs, level=level)
        pt = torch.from_numpy(pieces).to(dev)
        stride = max(EK.bit_words(int(m[1]) + int(m[2])) for m in rs)
        bits = torch.zeros(nch * stride, dtype=torch.int32, device=dev)
        if medium:
            bits = torch.from_numpy(EK.medium_map(rs, stride).view(np.int32)).to(dev)
        recs = torch.zeros(nch * EK.REC, dtype=torch.int64, device=dev)
        deltas = torch.empty(nd, dtype=torch.int16, device=dev)
        slots = torch.empty(ns, 2, dtype=torch.int32, device=dev)
        EK.resolve_cuda(data_t, pt, level, deltas, slots, cb, wb, bits=bits, bit_stride=stride)
        plain = bits.cpu().numpy().view(np.uint32).copy()
        EK.dry_cuda(pt, level, slots, bits, stride, recs, **({"data": data_t} if medium else {}))
        # MEDIUM's plain dry parse (a Python step a walk) on three chunks
        held = pieces[[0, 1, len(rs) - 1]] if medium else pieces
        EK.dry_plain(held, level, slots.cpu().numpy().astype(np.int64), plain, stride,
                     recs.cpu().numpy(), corpus if medium else None)
        got_w = EK.unsigned(bits).cpu()
        for r in held if medium else pieces[:1]:
            w0 = int(r[EK.P_WORK]) * stride if medium else 0
            w1 = w0 + stride if medium else len(plain)
            main_dry.append((got_w[w0:w1], torch.from_numpy(plain[w0:w1].astype(np.int64))))
        EK.resolve_cuda(data_t, pt, level, deltas, slots, cb, wb, bits=bits, bit_stride=stride)
        for k in (1, len(rs) - 1):
            r = pieces[k]
            one = torch.from_numpy(EK.with_offsets([r.tolist()], medium)[0]).to(dev)
            want_d, want_s = EK.resolve_plain(data_t, one, level, bits=bits, bit_stride=stride)
            d0, s0 = int(r[EK.P_DOFF]), int(r[EK.P_SOFF])
            nd1 = int(r[EK.P_C1] - r[EK.P_C0])
            ns1 = EK.slot_end(r, medium) - int(r[EK.P_S])
            main_res += [(EK.unsigned(deltas[d0 : d0 + nd1]), EK.unsigned(want_d[:nd1])),
                         (slots[s0 : s0 + ns1], want_s)]
    main_dry_err, main_res_err = max_abs(main_dry), max_abs(main_res)
    if main_dry_err or main_res_err:
        raise AssertionError(f"at the main path's shape the dry parse or the resolve under its "
                             f"map disagrees with its plain version: max abs err {main_dry_err}, "
                             f"{main_res_err}")
    dry_err, res_err = max(dry_err, main_dry_err), max(res_err, main_res_err)
    print(f"phase 41 main shape: levels 1, 3, MEDIUM4 and MEDIUM6 over {len(starts)} chunks of "
          f"{chunk} bytes: the dry parse of the first round equal to plain on every chunk (MEDIUM: "
          f"chunks 0, 1 and {len(starts) - 1}), max abs err {main_dry_err}; the second round's "
          f"resolve under that map equal to plain on chunks 1 and {len(starts) - 1}, max abs err "
          f"{main_res_err} ({time.perf_counter() - t0:.1f} s)", flush=True)
    # the batch loop: the level-6 chunks in batches cut by ROUND positions,
    # then by MAX_SLOTS chunks, a resolve and a chase a batch, each chunk
    # equal to zlib's
    result["batches"] = {}
    for name, value in (("ROUND", 1 << 20), ("MAX_SLOTS", 5)):
        saved = getattr(EK, name)
        setattr(EK, name, value)
        try:
            want_batches = len(EK.plan(meta6.cpu().tolist()))
            EK.launches.update(dict.fromkeys(EK.launches, 0))
            reuse = EK.exact_deflate_cuda(data_t, meta6, 6)
            ran = dict(EK.launches)
        finally:
            setattr(EK, name, saved)
        got = [reuse[0][o : o + m].cpu().numpy().tobytes()
               for o, m in zip(meta6[:, 4].tolist(), reuse[1].tolist())]
        if got != zlib6 or bool(reuse[2].any()):
            raise AssertionError(f"EX in batches ({name} {value}) is not zlib's chunk by chunk")
        if want_batches < 2 or ran != {"exact_deflate": want_batches,
                                       "exact_resolve": want_batches, "exact_dry": 0}:
            raise AssertionError(f"EX with {name} {value} ran {ran} for {want_batches} batches")
        result["batches"][name] = {"value": value, "batches": want_batches, "launches": ran}
        print(f"phase 41 EX batches: {len(starts)} level-6 chunks with {name} {value} in "
              f"{want_batches} batches, a resolve and a chase each ({ran}), equal to zlib's "
              f"chunk by chunk", flush=True)
    window_bytes = int(meta6[:, 2].sum())
    s6 = split[6]
    rows["exact_deflate"] = dict(
        source="zlib_rs_tpu_torch/csrc/exact_deflate.cu",
        replaces="native/zrs_native.cpp:1314",
        max_abs_err=err, ms=call_ms, plain_ms=plain_ms, plain_rows=1, launches=launched,
        resolve_ms=s6["resolve_ms"], chase_ms=s6["chase_ms"], flush_ms=s6["flush_ms"],
        emit_ms=s6["emit_ms"], level9_ms=call9_ms, level9_resolve_ms=split[9]["resolve_ms"],
        level9_chase_ms=split[9]["chase_ms"],
        # the whole call (the resolve and the chase); bytes: the input and
        # each chunk's window read once, the output written once; the serial
        # chase of the longest chunk is the floor
        bnd=bound(n + window_bytes + nout, 0),
        **{f"level{lv}_ms": greedy[lv]["call_ms"] for lv in (1, 2, 3)},
        level1_chase_ms=g1["chase_ms"], rounds=dict(EK.ROUNDS), live_share=g1["live_share"],
        **{f"medium{lv - 7}_ms": mediums[lv]["call_ms"] for lv in MEDIUM_LEVELS},
        **{f"medium{lv - 7}_chase_ms": mediums[lv]["chase_ms"] for lv in MEDIUM_LEVELS},
        medium_launches=medium_launches,
    )
    first_piece = torch.from_numpy(EK.with_offsets([EK.ex_piece(meta6[0].tolist(), 0, 0, 0)])[0])
    _p, res_plain_ms = timed_ms(torch, lambda: EK.resolve_plain(data_t, first_piece.to(dev), 6))
    rows["exact_resolve"] = dict(
        source="zlib_rs_tpu_torch/csrc/exact_deflate.cu",
        replaces="native/zrs_native.cpp:604",
        max_abs_err=res_err, ms=s6["resolve_ms"], plain_ms=res_plain_ms, plain_rows=1,
        launches=launched_res, level9_ms=split[9]["resolve_ms"], candidates=s6["candidates"],
        # bytes: the input and the windows read once, 2 bytes of delta and
        # 8 of slot a position written once; operations: the two 16-bit
        # compares of the anchored pre-reject a candidate this data's walks
        # compare
        bnd=bound(n + window_bytes + 2 * s6["chain_positions"] + 8 * s6["positions"],
                  2 * s6["candidates"]),
        level1_ms=g1["resolve_ms"], level3_ms=greedy[3]["resolve_ms"],
        level1_launches=launched1["exact_resolve"],
        **{f"medium{lv - 7}_ms": mediums[lv]["resolve_ms"] for lv in MEDIUM_LEVELS},
        medium5_launches=medium_launches[CD.MEDIUM5]["exact_resolve"],
    )
    # the dry parse (levels 1-3): its time on the main path's shape, its
    # plain version's on the first chunk, and its bound: each loop top's
    # slot read once (8 bytes) and the map written once (a bit a position)
    meta1 = meta_of([(lo, min(n, lo + chunk) - lo, min(32768, lo), int(lo + chunk >= n))
                     for lo in starts], 1)
    one = meta1[:1]
    [(_nch, [(p1, nd1, ns1, cb1, wb1)])] = EK.plan(one.cpu().tolist())
    pt1 = torch.from_numpy(p1).to(dev)
    sl1 = torch.empty(ns1, 2, dtype=torch.int32, device=dev)
    st1 = EK.bit_words(int(one[0, 1] + one[0, 2]))
    b1 = torch.zeros(st1, dtype=torch.int32, device=dev)
    EK.resolve_cuda(data_t, pt1, 1, torch.empty(nd1, dtype=torch.int16, device=dev), sl1, cb1,
                    wb1, bits=b1, bit_stride=st1)
    sl1_np = sl1.cpu().numpy().astype(np.int64)
    w1 = np.zeros(st1, np.uint32)
    _p, dry_plain_ms = timed_ms(torch, lambda: EK.dry_plain(p1, 1, sl1_np, w1, st1))
    rows["exact_dry"] = dict(
        source="zlib_rs_tpu_torch/csrc/exact_deflate.cu",
        replaces="native/zrs_native.cpp:794",
        max_abs_err=dry_err, ms=g1["dry_ms"], plain_ms=dry_plain_ms, plain_rows=1,
        launches=launched1["exact_dry"], level3_ms=greedy[3]["dry_ms"],
        bnd=bound(8 * g1["tops"] + (g1["positions"] + 7) // 8, g1["tops"]),
        **{f"medium{lv - 7}_ms": mediums[lv]["dry_ms"] for lv in MEDIUM_LEVELS
           if mediums[lv]["rounds"] > 1},
        medium5_launches=medium_launches[CD.MEDIUM5]["exact_dry"],
    )
    print(f"phase 41 EX level 6: {call_ms:.3f} ms a call ({len(starts)} chunks: the resolve, "
          f"one warp a chunk's chase), level 9 {call9_ms:.3f} ms; plain {plain_ms:.1f} ms for "
          f"one chunk at level 6; the resolve's plain {res_plain_ms:.1f} ms for one chunk",
          flush=True)

    # -- the one-shot compress of 1 MiB: one chunk, one warp ---------------
    mib = corpus[: 1 << 20]
    result["oneshot"] = {}
    for level in (1, 2, 3, 6, 9):
        t0 = time.perf_counter()
        got = oneshot.compress(mib, level)
        wall = time.perf_counter() - t0
        if got != zlib.compress(mib, level):
            raise AssertionError(f"the one-shot compress at level {level} is not zlib.compress")
        result["oneshot"][level] = {"s": wall, "mb_s": len(mib) / wall / 1e6}
        print(f"phase 41 one-shot compress 1 MiB level {level}: equal to zlib.compress, "
              f"{wall:.3f} s ({len(mib) / wall / 1e6:.3f} MB/s)", flush=True)
    # the whole corpus in one chunk: two pieces, the chase resumed from its
    # record between two rounds
    EK.launches.update(dict.fromkeys(EK.launches, 0))
    t0 = time.perf_counter()
    got = oneshot.compress(corpus, 6)
    wall = time.perf_counter() - t0
    pieces_run = dict(EK.launches)
    if got != zlib.compress(corpus, 6) or pieces_run != {"exact_deflate": 2, "exact_resolve": 2,
                                                         "exact_dry": 0}:
        raise AssertionError(f"the one-shot compress of the corpus at level 6 is not "
                             f"zlib.compress in two pieces: launches {pieces_run}")
    result["oneshot"]["corpus_6"] = {"s": wall, "mb_s": n / wall / 1e6, "launches": pieces_run}
    print(f"phase 41 one-shot compress of the corpus level 6: equal to zlib.compress in two "
          f"pieces of {EK.PIECE} positions, {wall:.3f} s ({n / wall / 1e6:.3f} MB/s)", flush=True)
    result["phase_s"] = time.perf_counter() - t_start
    print(f"phase 41: {result['phase_s']:.1f} s", flush=True)
    return result


STREAM_PAIR_BYTES = 64 * 1024  # phase 43's pump scripts against the plain versions
STREAM_PUMP = 128 * 1024  # GZBUFSIZE: the stream path's pump


def stream_pairs(torch, dev, corpus):
    """Phase 43's pairs: IS and DS against their plain versions on pump
    scripts over 64 KiB of the corpus, pump for pump (bytes, flags;
    window() and copies), as max abs err over the bytes. IS (its
    whole-block launch): zlib levels 0, 1, 6 and 9, Z_FIXED, a flipped
    stream, runs of one byte (dist 1 at length 258) and a stream on a
    preset dictionary at random boundaries and bounded max_out, 1-byte
    pumps over the first 4 KiB, a copy mid-stream, and 1 MiB of zeros from
    one pump (room regrowths).
    DS: levels 1, 3, 6 and 9 under every flush kind at random boundaries,
    1-byte pumps over the first 4 KiB, window() at a seam, a copy."""
    import random

    from zlib_rs_tpu_torch.ops.kernels import dstream_kernel as DS
    from zlib_rs_tpu_torch.ops.kernels import istream_kernel as IS

    data = corpus[len(corpus) // 3 :][:STREAM_PAIR_BYTES]
    rng = random.Random(43)
    pairs, n_is, n_ds = [], 0, 0

    def as_t(b):
        return torch.frombuffer(bytearray(b), dtype=torch.uint8) if b else torch.zeros(0)

    def same(got, want, what):
        if len(got) != len(want):
            raise AssertionError(f"{what}: {len(got)} results against {len(want)}")
        for g, w in zip(got, want):
            if isinstance(g, bytes):
                if len(g) != len(w):
                    raise AssertionError(f"{what}: a pump gave {len(g)} bytes, plain {len(w)}")
                pairs.append((as_t(g), as_t(w)))
            elif g != w:
                raise AssertionError(f"{what}: {g} against plain {w}")

    streams = {f"zlib{lv}": _raw(data, lv) for lv in (0, 1, 6, 9)}
    streams["fixed"] = _raw(data, 6, zlib.Z_FIXED)
    streams["flipped"] = _flip(streams["zlib6"], len(streams["zlib6"]) // 3)
    # 1 MiB from about 1 KiB: IS stops for room and the wrapper regrows it
    streams["zeros"] = _raw(bytes(1 << 20) + data[:4096], 9)
    streams["runs"] = _raw(bytes([0x41]) * 150_000 + data[:4096] + bytes(70_000), 9)
    window = corpus[len(corpus) // 3 - 32768 : len(corpus) // 3]
    streams["dict"] = _raw(data, 6, zdict=window)
    for name, comp in streams.items():
        script = [(comp[i : i + 1], rng.choice((1, 4096, None))) for i in range(4096)] \
            if name == "zlib6" else []
        pos = len(script)
        if name == "zeros":
            script.append((comp, None))
            pos = len(comp)
        while pos < len(comp):
            n = rng.choice((1, 7, 300, 5000, 40_000))
            script.append((comp[pos : pos + n], rng.choice((1, 500, 70_000, None))))
            pos += n
        script += [(b"", None)] * 3
        logs = []
        for d in (dev, "cpu"):
            launched = IS.launches["istream"]
            h, log = IS.Handle(d, window if name == "dict" else None), []
            for k, (chunk, cap) in enumerate(script):
                if name == "zlib1" and k == len(script) // 2:
                    log.append(("original", [h.pump(c, 1 << 22) for c, _ in script[k:]]))
                    h = h.copy()
                out, flags = h.pump(chunk, 1 << 22 if cap is None else cap)
                log += [out, (flags, h.total_out, h.at_boundary(), h.mode)]
            log.append(h.take_tail(1 << 20))
            logs.append(log)
            if name == "zeros" and d is dev and IS.launches["istream"] - launched < 2:
                raise AssertionError("IS decoded 1 MiB of zeros without regrowing its room")
        for g, w in zip(logs[0], logs[1]):
            if isinstance(g, tuple) and g and g[0] == "original":
                same([o for o, _ in g[1]], [o for o, _ in w[1]], f"IS {name} (original)")
                same([f for _, f in g[1]], [f for _, f in w[1]], f"IS {name} (original)")
            else:
                same([g], [w], f"IS {name}")
        n_is += len(script)
    for level in (1, 3, 6, 9):
        script = [(data[i : i + 1], 0) for i in range(4096)] if level == 1 else []
        pos = len(script)
        while pos < len(data):
            n = rng.choice((1, 100, 3000, 20_000))
            script.append((data[pos : pos + n], rng.choice((0, 0, 0, 2, 3))))
            pos += n
        script.append((b"", 4))
        logs = []
        for h in (DS.Handle(level, dev), DS.Plain(level)):
            log = []
            for k, (chunk, flush) in enumerate(script):
                log.append(h.pump(chunk, flush))
                if flush:
                    log.append(h.window())
                if k == len(script) // 2:
                    c = h.copy()
                    log += [c.pump(b"copy", 2), c.pump(b"", 4)]
            logs.append(log)
        same(logs[0], logs[1], f"DS level {level}")
        n_ds += len(script)
    return max_abs(pairs), n_is, n_ds


def ds_pump_ms(torch, DS, EK, dev, corpus, level: int, reps: int = 3) -> dict:
    """One 128 KiB NO_FLUSH DS pump at `level` after a first one, by CUDA
    events from a saved record and Work (copied back before each rep, a
    mean of `reps` after a warm-up): the resolve's ms (its operands staged
    before the first event, so that the span holds only its launches; at
    levels 1-3 and MEDIUM all EK.ROUNDS[level] rounds and the dry parses
    between them, with the resolve's ms a round and the dry parse's apart),
    then DS's (the chase, at 1-3 and MEDIUM the chains of the inserted
    positions, and ds_tables), with the chase's clock64 share in
    flush_block and at 1-3 and MEDIUM its loop tops (MEDIUM: its walks)
    and live walks; the pump's output (uint8 on the card) and length."""
    from zlib_rs_tpu_torch._device import ptr as _ptr

    pump = STREAM_PUMP
    d = DS.Handle(level, dev)
    d.pump(corpus[:pump], 0)
    d._append(corpus[pump : 2 * pump])
    unflushed = int(d.rec[DS.D_TOTAL] - d.rec[DS.D_BLOCK_START])
    out = torch.empty(DS.room(unflushed), dtype=torch.uint8, device=dev)
    d.rec[DS.D_FLUSH], d.rec[DS.D_OUT_CAP] = 0, out.numel()
    snap = torch.from_numpy(d.rec.copy()).to(dev)
    rec_dev = torch.empty_like(snap)
    work = d.work.clone()
    clk = torch.zeros(3, dtype=torch.int64, device=dev)
    stats = torch.zeros(2, dtype=torch.int64, device=dev)
    fn = DS._fn()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    res_ms = ds_ms = round_ms = dry_ms = 0.0
    saved = dict(EK.launches)
    pt = deltas = slots = bits = dlist = None
    cb = wb = n_slots = span = 0
    if DS.resolved(d.rec):
        pt, cb, wb, deltas, slots, n_slots, span, bits, dlist = DS.resolve_operands(d.rec, dev)
    greedy = bits is not None
    rounds = EK.ROUNDS[level] if greedy else (1 if EK.static_level(level) else 0)
    head, ring = DS.handle_tables(d.work, level)
    tables = {"head_old": head, "ring": ring, "bits": bits}
    more = {"recs": rec_dev, "data": d.data} if EK.is_medium(level) else {}
    if EK.is_medium(level) and rounds > 1:  # the rounds the pump takes (EK.take_round)
        EK.resolve_cuda(d.data, pt, level, deltas, slots, cb, wb, **tables)
        if not EK.take_round(level, slots):
            rounds = 1
    for rep in range(reps + 1):
        d.work.copy_(work)
        rec_dev.copy_(snap)
        stats.zero_()
        if greedy:
            bits.zero_()
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(2 * rounds)]
        ev[0].record()
        for r in range(rounds):
            if r:
                EK.dry_cuda(pt, level, slots, bits, 0, **more)
            marks[2 * r].record()
            EK.resolve_cuda(d.data, pt, level, deltas, slots, cb, wb, **tables)
            marks[2 * r + 1].record()
        ev[1].record()
        fn(_ptr(rec_dev), _ptr(d.data), _ptr(d.work), _ptr(out), EK._opt(slots), n_slots,
           EK._opt(deltas), EK._opt(dlist), span, EK._opt(pt), cb, EK._opt(bits), _ptr(clk),
           _ptr(stats), level, torch.cuda.current_stream().cuda_stream)
        ev[2].record()
        torch.cuda.synchronize()
        if rep:
            res_ms += ev[0].elapsed_time(ev[1]) / reps
            ds_ms += ev[1].elapsed_time(ev[2]) / reps
            if greedy:
                round_ms += sum(marks[2 * r].elapsed_time(marks[2 * r + 1])
                                for r in range(rounds)) / rounds / reps
                dry_ms += sum(marks[2 * r - 1].elapsed_time(marks[2 * r])
                              for r in range(1, rounds)) / max(rounds - 1, 1) / reps
    EK.launches.update(saved)
    n = int(rec_dev[DS.D_OUT_LEN].item())
    c = clk.cpu()
    share = float(c[1]) / float(c[0])
    tops, lives = stats.tolist()
    return {"resolve_ms": res_ms, "ds_ms": ds_ms, "flush_ms": ds_ms * share,
            "emit_ms": ds_ms * float(c[2]) / float(c[0]), "flush_share": share, "out_len": n,
            "rounds": rounds, "round_ms": round_ms, "dry_ms": dry_ms, "tops": tops,
            "lives": lives, "out": out[:n].cpu()}


def stream_phase(torch, dev, corpus, rows) -> dict:
    """Phase 43: the stream path on IS and DS. First IS and DS against
    their plain versions (stream_pairs, max abs err 0); then the path at
    full size through the entry points a user calls: `Deflate(level=1)`
    over the corpus in 128 KiB pumps with a SYNC_FLUSH every 1 MiB, level 6
    over 2 MiB and level 9 over 256 KiB, each equal to zlib.compressobj's
    bytes for the same script; `Inflate()` of the corpus's zlib-6 stream in
    128 KiB pumps with a 64 KiB out_budget, back to the corpus; a `gzopen`
    write of the corpus at level 1 in 128 KiB writes, read by stdlib gzip
    and read back by `gzopen`. Each wall in MB/s; IS's, DS's and the
    resolve's launches on that path, and IS's ms for one 128 KiB pump by
    CUDA events (the launch alone, from a saved record and tables, with
    two device-to-device copies of them) beside its bound and its plain
    version's ms; DS's at levels 1, 6 and 9 (ds_pump_ms: the resolve, then
    the chase and its tables, flush_block's share), the pump's bytes at 1
    and 6 against the plain version's."""
    import zlib_rs_tpu_torch as zt
    from zlib_rs_tpu_torch._device import ptr as _ptr
    from zlib_rs_tpu_torch.config import DeflateFlush
    from zlib_rs_tpu_torch.ops.kernels import dstream_kernel as DS
    from zlib_rs_tpu_torch.ops.kernels import exact_deflate_kernel as EK
    from zlib_rs_tpu_torch.ops.kernels import istream_kernel as IS

    t_start = time.perf_counter()
    err, n_is, n_ds = stream_pairs(torch, dev, corpus)
    if err:
        raise AssertionError(f"IS or DS disagrees with its plain version: max abs err {err}")
    print(f"phase 43 pairs: IS on {n_is} pumps (zlib 0/1/6/9, Z_FIXED, a flipped stream, runs "
          f"of one byte, a preset dictionary, 1 MiB of zeros from one pump; 1-byte pumps, "
          f"bounded max_out, a copy) and DS on {n_ds} pumps (levels 1/3/6/9, every "
          f"flush, 1-byte pumps, window(), a copy) equal to plain, max abs err {err} "
          f"({time.perf_counter() - t_start:.1f} s)", flush=True)

    # -- the path at full size ---------------------------------------------
    result = {"deflate": {}}
    IS.launches["istream"] = DS.launches["dstream"] = 0
    EK.launches.update(dict.fromkeys(EK.launches, 0))
    pump = STREAM_PUMP
    for level, size in ((1, len(corpus)), (6, 2 << 20), (9, 256 << 10)):
        data = corpus[:size]
        size = len(data)
        d = zt.Deflate(level=level)
        z = zlib.compressobj(level)
        got, want = bytearray(), bytearray()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(0, size, pump):
            flush = DeflateFlush.SYNC_FLUSH if (i + pump) % (1 << 20) == 0 else \
                DeflateFlush.NO_FLUSH
            got += d.compress(data[i : i + pump], flush)[2]
        got += d.finish()
        wall = time.perf_counter() - t0
        if d._fast is None:
            raise AssertionError("Deflate did not take DS")
        for i in range(0, size, pump):
            want += z.compress(data[i : i + pump])
            if (i + pump) % (1 << 20) == 0:
                want += z.flush(zlib.Z_SYNC_FLUSH)
        want += z.flush()
        if got != want:
            raise AssertionError(f"Deflate level {level} is not zlib.compressobj's stream")
        result["deflate"][level] = {"bytes_in": size, "bytes_out": len(got), "wall_s": wall,
                                    "mb_s": size / wall / 1e6}
        print(f"phase 43 Deflate level {level}: {size} bytes in 128 KiB pumps, SYNC_FLUSH every "
              f"1 MiB -> {digest(bytes(got))}, equal to zlib.compressobj; {wall:.3f} s "
              f"({size / wall / 1e6:.3f} MB/s)", flush=True)
    zs = zlib.compress(corpus, 6)
    inf = zt.Inflate()
    back = bytearray()
    pos = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100_000):
        st, used, o = inf.decompress(zs[pos : pos + pump], 65536)
        pos += used
        back += o
        if st.name == "StreamEnd":
            break
    wall = time.perf_counter() - t0
    if bytes(back) != corpus or inf._fast is None:
        raise AssertionError("Inflate of the zlib-6 stream is not the corpus (or not on IS)")
    result["inflate"] = {"bytes_in": len(zs), "bytes_out": len(back), "wall_s": wall,
                         "mb_s": len(back) / wall / 1e6}
    print(f"phase 43 Inflate: the corpus's zlib-6 stream ({len(zs)} bytes) in 128 KiB pumps, "
          f"64 KiB out_budget, back to the corpus; {wall:.3f} s ({len(back) / wall / 1e6:.3f} "
          f"MB/s of output)", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "corpus.gz"
        t0 = time.perf_counter()
        with zt.gzopen(path, "wb1") as f:
            for i in range(0, len(corpus), pump):
                f.write(corpus[i : i + pump])
        w_wall = time.perf_counter() - t0
        blob = path.read_bytes()
        if gzip.decompress(blob) != corpus:
            raise AssertionError("stdlib gzip does not read the gzopen file back to the corpus")
        t0 = time.perf_counter()
        with zt.gzopen(path, "rb") as f:
            back = f.read()
        r_wall = time.perf_counter() - t0
        if back != corpus:
            raise AssertionError("gzopen does not read its file back to the corpus")
    result["gzfile"] = {"bytes": len(blob), "write_s": w_wall, "read_s": r_wall,
                        "write_mb_s": len(corpus) / w_wall / 1e6,
                        "read_mb_s": len(corpus) / r_wall / 1e6}
    launched = {"istream": IS.launches["istream"], "dstream": DS.launches["dstream"],
                "exact_resolve": EK.launches["exact_resolve"], "exact_dry": EK.launches["exact_dry"]}
    if min(launched.values()) < 1:
        raise AssertionError(f"the stream path did not launch IS, DS and the resolve: {launched}")
    print(f"phase 43 gzopen level 1: {len(blob)} bytes written in {w_wall:.3f} s "
          f"({len(corpus) / w_wall / 1e6:.3f} MB/s), read by stdlib gzip and back by gzopen "
          f"in {r_wall:.3f} s ({len(corpus) / r_wall / 1e6:.3f} MB/s); launches {launched}",
          flush=True)

    # -- one 128 KiB pump of each, by CUDA events from a saved state -------
    raw6 = zs[2:-4]  # IS takes the raw body
    h = IS.Handle(dev)
    h.pump(raw6[:pump], 1 << 30)
    h._append(raw6[pump : 2 * pump])
    h._room(16 << 20)
    snap = torch.from_numpy(h.rec.copy()).to(dev)
    rec_dev = torch.empty_like(snap)
    tables = h.tables.clone()  # a launch rebuilds them at each block
    scratch = torch.empty(IS.SCRATCH, dtype=torch.int32, device=dev)
    stats = torch.zeros(IS.STATS, dtype=torch.int64, device=dev)
    fn_is, fn_warp = IS._fn(), IS._fn_warp()
    stream = torch.cuda.current_stream().cuda_stream

    def is_launch(with_stats=False):
        rec_dev.copy_(snap)
        h.tables.copy_(tables)
        fn_is(_ptr(rec_dev), _ptr(h.tables), _ptr(h.inbuf), h.inbuf.numel() // 4,
              _ptr(h.outbuf), _ptr(scratch), _ptr(stats) if with_stats else None, stream)

    def warp_launch():
        rec_dev.copy_(snap)
        h.tables.copy_(tables)
        fn_warp(_ptr(rec_dev), _ptr(h.tables), _ptr(h.inbuf), _ptr(h.outbuf), stream)

    # the whole-block launch and the one-warp launch it replaces, in turn
    times = {"block": [], "warp": []}
    outs = {}
    for who in ("block", "warp", "warp", "block"):
        times[who].append(event_ms(torch, is_launch if who == "block" else warp_launch, 5))
        rec_after = rec_dev.cpu().numpy()
        at0 = int(h.rec[IS.R_OP]) - int(h.rec[IS.R_BASE])
        at1 = int(rec_after[IS.R_OP]) - int(h.rec[IS.R_BASE])
        outs.setdefault(who, set()).add((digest(h.outbuf[at0:at1].cpu().numpy().tobytes()),
                                         tuple(rec_after[:12].tolist())))
    if len(outs["block"] | outs["warp"]) != 1:
        raise AssertionError(f"the timed IS pump: block and warp launches disagree: {outs}")
    is_ms, warp_ms = sum(times["block"]) / 2, sum(times["warp"]) / 2
    is_launch(True)
    st = dict(zip(IS.STAT_NAMES, stats.cpu().tolist()))
    is_out = int(rec_dev[IS.R_OP].item()) - int(h.rec[IS.R_OP])
    p = IS.Handle("cpu")
    p.pump(raw6[:pump], 1 << 30)
    p._append(raw6[pump : 2 * pump])
    p._room(16 << 20)
    t0 = time.perf_counter()
    IS.advance_plain(p.rec, p.tables, p.inbuf, p.outbuf)
    is_plain_ms = (time.perf_counter() - t0) * 1e3
    if is_out <= 0 or int(p.rec[IS.R_OP]) - int(h.rec[IS.R_OP]) != is_out:
        raise AssertionError("the timed IS pump and its plain version decode different lengths")
    rows["istream"] = dict(
        source="zlib_rs_tpu_torch/csrc/istream.cu",
        replaces="native/zrs_native.cpp:2244",
        max_abs_err=err, ms=is_ms, plain_ms=is_plain_ms, launches=launched["istream"],
        warp_ms=warp_ms, head_ms=st["ns_head"] / 1e6, sync_ms=st["ns_sync"] / 1e6,
        expand_ms=st["ns_expand"] / 1e6, spec_ms=st["ns_spec"] / 1e6, windows=st["windows"],
        sync_rounds=st["sync_rounds"],
        max_sync_rounds=st["max_sync_rounds"], jump_rounds=st["jump_rounds"],
        serial_finishes=st["serial_finishes"],
        # bytes: the pump's compressed input read once, its output written once
        bnd=bound(pump + is_out, 0),
    )
    # the plain version takes about 30 s for a level-9 pump on the host, and
    # phase 43's level-9 pump scripts already hold DS against it
    pumps = {level: ds_pump_ms(torch, DS, EK, dev, corpus, level) for level in (1, 3, 6, 9)}
    for level, r in pumps.items():
        if level == 9:
            r.pop("out")
            continue
        pd = DS.Plain(level)
        pd.pump(corpus[:pump], 0)
        t0 = time.perf_counter()
        want = pd.pump(corpus[pump : 2 * pump], 0)
        r["plain_ms"] = (time.perf_counter() - t0) * 1e3
        r["max_abs_err"] = max_abs([(r.pop("out"), torch.frombuffer(bytearray(want),
                                                                     dtype=torch.uint8))]) \
            if len(want) == r["out_len"] else -1
        if r["max_abs_err"]:
            raise AssertionError(f"the timed DS pump at level {level} is not plain's: {r}")
    p6 = pumps[6]
    rows["dstream"] = dict(
        source="zlib_rs_tpu_torch/csrc/exact_deflate.cu",
        replaces="native/zrs_native.cpp:2107",
        max_abs_err=err, ms=p6["resolve_ms"] + p6["ds_ms"], plain_ms=p6["plain_ms"],
        launches=launched["dstream"], resolve_ms=p6["resolve_ms"], chase_ms=p6["ds_ms"],
        flush_ms=p6["flush_ms"], level1_ms=pumps[1]["resolve_ms"] + pumps[1]["ds_ms"],
        level1_resolve_ms=pumps[1]["resolve_ms"], level1_chase_ms=pumps[1]["ds_ms"],
        level3_ms=pumps[3]["resolve_ms"] + pumps[3]["ds_ms"],
        level9_ms=pumps[9]["resolve_ms"] + pumps[9]["ds_ms"],
        level9_resolve_ms=pumps[9]["resolve_ms"], level9_chase_ms=pumps[9]["ds_ms"],
        # the pump (the resolve, the chase and its tables); bytes: the
        # pump's input and the 32 KiB window read once, its output written
        # once; the serial chase is the floor, as EX's
        bnd=bound(pump + 32768 + p6["out_len"], 0),
    )
    rows["exact_resolve"]["stream_launches"] = launched["exact_resolve"]
    rows["exact_dry"]["stream_launches"] = launched["exact_dry"]
    result.update(is_pump_ms=is_ms, is_warp_ms=warp_ms, is_stats=st, ds_pumps=pumps,
                  launches=launched, phase_s=time.perf_counter() - t_start)
    print(f"phase 43 IS: {is_ms:.3f} ms for a 128 KiB pump by the whole-block launch, the "
          f"one-warp launch {warp_ms:.3f} ms from the same state (block, warp, warp, block; "
          f"equal bytes and records; {is_out} bytes out; bound "
          f"{rows['istream']['bnd'][0]:.6f} ms by bytes), plain {is_plain_ms:.1f} ms; split by "
          f"%globaltimer: head and tails {st['ns_head'] / 1e6:.3f} ms, sync decode "
          f"{st['ns_sync'] / 1e6:.3f} ms, expansion {st['ns_expand'] / 1e6:.3f} ms (the next "
          f"{st['specs']} headers parsed meanwhile in {st['ns_spec'] / 1e6:.3f} ms) over "
          f"{st['windows']} windows, {st['sync_rounds']} sync rounds (at most "
          f"{st['max_sync_rounds']} a window, {st['serial_finishes']} serial finishes), "
          f"{st['jump_rounds']} jumping rounds (at most {st['max_jump_rounds']}); launches on "
          f"the path {launched['istream']}", flush=True)
    for level, r in pumps.items():
        held = (f"equal to plain's, plain {r['plain_ms']:.1f} ms" if "plain_ms" in r
                else "(held by the pump scripts above)")
        greedy = (f"; {r['rounds']} rounds: resolve {r['round_ms']:.3f} ms a round, dry parse "
                  f"{r['dry_ms']:.3f} ms; live walks {r['lives']} / loop tops {r['tops']}"
                  if EK.greedy_level(level) else "")
        print(f"phase 43 DS level {level}: a 128 KiB NO_FLUSH pump, resolve {r['resolve_ms']:.3f} ms "
              f"+ DS {r['ds_ms']:.3f} ms (chase and tables; flush_block {r['flush_ms']:.3f} ms, "
              f"emit_symbols {r['emit_ms']:.3f} ms of it, by the chase's clock64 shares){greedy}, "
              f"{r['out_len']} bytes {held}", flush=True)
    print(f"phase 43: bound {rows['dstream']['bnd'][0]:.6f} ms by bytes; resolve launches on the "
          f"path {launched['exact_resolve']}; phase {result['phase_s']:.1f} s", flush=True)
    return result


MEDIUM_LEVELS = (11, 12, 13)  # native.MEDIUM4-6
MEDIUM_PRUNE_BYTES = (1 << 20) + (256 << 10)  # phase 44's stream past DS's prune


def medium_stream_phase(torch, dev, corpus, rows) -> dict:
    """Phase 44: DS at MEDIUM4-6 (the resolve, then run_medium_slots under
    zrs_dstream_pump; native's serial run_medium after a FULL_FLUSH).
    First DS against its plain version (models.medium.MediumStream, which
    the CPU tests hold to native's handle pump for pump) on pump scripts
    over 64 KiB of the corpus: 1-byte pumps over the first 4 KiB at MEDIUM4,
    then pieces of 1 byte to 20 KB under every flush kind, window() at each
    seam and a copy mid-stream, pump for pump as max abs err, and each
    stream decoded by zlib. Then a `native.RawDeflateStream` over 1 MiB of
    the corpus at each level in 128 KiB NO_FLUSH pumps and a FINISH,
    decoded by zlib, in MB/s of input; DS's ms for one 128 KiB MEDIUM5
    NO_FLUSH pump by CUDA events (ds_pump_ms: the resolve, then the chase
    and its tables, from a saved record and Work), beside its bound and its
    plain version's ms, its bytes equal to the plain version's, and its
    split; one MEDIUM5 stream of 1.25 MiB in 128 KiB pumps
    against the plain version pump for pump, which the wrapper prunes past
    1 MiB (rebasing head4 and the next match on the card). Last, the native
    bench rows' decode paths in process: `native.inflate_parallel` of the
    corpus's indexed body (stdlib zlib's raw level 6 a 128 KiB chunk, which
    is deflate_chunk's bytes) and `native.inflate_raw` of 1 MiB, their K6
    and SP launches."""
    import random

    from zlib_rs_tpu_torch import native
    from zlib_rs_tpu_torch.ops.kernels import dstream_kernel as DS
    from zlib_rs_tpu_torch.ops.kernels import exact_deflate_kernel as EK
    from zlib_rs_tpu_torch.ops.kernels import inflate_kernel as IK
    from zlib_rs_tpu_torch.ops.kernels import speculative_kernel as SK

    t_start = time.perf_counter()
    data = corpus[len(corpus) // 3 :][:STREAM_PAIR_BYTES]
    rng = random.Random(44)
    pairs, n_ds = [], 0
    launched = DS.launches["dstream"]

    def as_t(b):
        return torch.frombuffer(bytearray(b), dtype=torch.uint8) if b else torch.zeros(0)

    for level in MEDIUM_LEVELS:
        script = [(data[i : i + 1], 0) for i in range(4096)] if level == 11 else []
        pos = len(script)
        while pos < len(data):
            n = rng.choice((1, 100, 3000, 20_000))
            script.append((data[pos : pos + n], rng.choice((0, 0, 0, 2, 3))))
            pos += n
        script.append((b"", 4))
        logs, mains = [], []
        for h in (DS.Handle(level, dev), DS.Plain(level)):
            log, main = [], []
            for k, (chunk, flush) in enumerate(script):
                out = h.pump(chunk, flush)
                log.append(out)
                main.append(out)
                if flush:
                    log.append(h.window())
                if k == len(script) // 2:
                    c = h.copy()
                    log += [c.pump(b"copy", 2), c.pump(b"", 4)]
            logs.append(log)
            mains.append(b"".join(main))
        if len(logs[0]) != len(logs[1]):
            raise AssertionError(f"DS MEDIUM level {level}: {len(logs[0])} results, plain "
                                 f"{len(logs[1])}")
        for g, w in zip(*logs):
            if len(g) != len(w):
                raise AssertionError(f"DS MEDIUM level {level}: {len(g)} bytes, plain {len(w)}")
            pairs.append((as_t(g), as_t(w)))
        if zlib.decompress(mains[0], -15) != data:
            raise AssertionError(f"DS MEDIUM level {level}: the stream does not decode")
        n_ds += len(script)
    err = max_abs(pairs)
    if err:
        raise AssertionError(f"DS at MEDIUM disagrees with its plain version: max abs err {err}")
    print(f"phase 44 pairs: DS at MEDIUM4-6 on {n_ds} pumps (1-byte pumps, every flush, "
          f"window(), a copy) equal to plain, max abs err {err}, every stream decoded by zlib "
          f"({time.perf_counter() - t_start:.1f} s)", flush=True)

    result = {"streams": {}, "pairs_max_abs_err": err}
    pump = STREAM_PUMP
    mib = corpus[: 1 << 20]
    for level in MEDIUM_LEVELS:
        s = native.RawDeflateStream(level)
        got = bytearray()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(0, len(mib), pump):
            got += s.pump(mib[i : i + pump], 0)
        got += s.pump(b"", 4)
        wall = time.perf_counter() - t0
        if zlib.decompress(bytes(got), -15) != mib:
            raise AssertionError(f"RawDeflateStream MEDIUM{level - 7} does not decode")
        result["streams"][level - 7] = {"bytes_out": len(got), "wall_s": wall,
                                        "mb_s": len(mib) / wall / 1e6}
        print(f"phase 44 RawDeflateStream MEDIUM{level - 7}: 1 MiB in 128 KiB pumps -> "
              f"{digest(bytes(got))}, decoded by zlib; {wall:.3f} s "
              f"({len(mib) / wall / 1e6:.3f} MB/s)", flush=True)

    timed = ds_pump_ms(torch, DS, EK, dev, corpus, 12)
    ds_out, out = timed["out_len"], timed["out"]
    ms = timed["resolve_ms"] + timed["ds_ms"]
    pd = DS.Plain(12)
    pd.pump(corpus[:pump], 0)
    t0 = time.perf_counter()
    plain_out = pd.pump(corpus[pump : 2 * pump], 0)
    plain_ms = (time.perf_counter() - t0) * 1e3
    if len(plain_out) != ds_out:
        raise AssertionError(f"the timed MEDIUM5 pump gave {ds_out} bytes, plain {len(plain_out)}")
    timed_err = max_abs([(out[:ds_out].cpu(), as_t(plain_out))])
    if timed_err:
        raise AssertionError(f"the timed MEDIUM5 pump gave {ds_out} bytes, plain "
                             f"{len(plain_out)}, max abs err {timed_err}")
    b_ms, _by = bound(pump + 32768 + ds_out, 0)
    rows["dstream"].update(medium_ms=ms, medium_plain_ms=plain_ms, medium_bound_ms=b_ms,
                           medium_resolve_ms=timed["resolve_ms"], medium_ds_ms=timed["ds_ms"])
    result.update(medium5_pump_ms=ms, medium5_plain_ms=plain_ms, medium5_pump_err=timed_err,
                  medium5_split={k: timed[k] for k in ("resolve_ms", "round_ms", "dry_ms",
                                                       "ds_ms", "flush_ms", "rounds", "tops",
                                                       "lives")})
    print(f"phase 44 DS MEDIUM5: {ms:.3f} ms for a 128 KiB NO_FLUSH pump ({ds_out} bytes out, "
          f"equal to plain, max abs err {timed_err}; bound {b_ms:.6f} ms by bytes) = the resolve "
          f"{timed['resolve_ms']:.3f} ms ({timed['rounds']} rounds of {timed['round_ms']:.3f} ms, "
          f"dry parse {timed['dry_ms']:.3f} ms) + DS {timed['ds_ms']:.3f} ms (flush_block "
          f"{timed['flush_ms']:.3f} ms; live walks {timed['lives']} / walks {timed['tops']}); "
          f"plain {plain_ms:.1f} ms", flush=True)

    # one MEDIUM5 stream past PRUNE + 32 KiB in 128 KiB pumps, pump for
    # pump against the plain version: the wrapper prunes the buffer and
    # rebases head, head4 and the carried next match on the card
    t0 = time.perf_counter()
    long_in = corpus[: MEDIUM_PRUNE_BYTES]
    h, pl = DS.Handle(12, dev), DS.Plain(12)
    long_pairs, long_out, pruned = [], [], 0
    for i in range(0, len(long_in), pump):
        g, w = h.pump(long_in[i : i + pump], 0), pl.pump(long_in[i : i + pump], 0)
        long_pairs.append((as_t(g), as_t(w)))
        long_out.append(g)
        pruned = max(pruned, i + pump - int(h.rec[DS.D_TOTAL]))
    g, w = h.pump(b"", 4), pl.pump(b"", 4)
    long_pairs.append((as_t(g), as_t(w)))
    long_out.append(g)
    if any(len(a) != len(b) for a, b in long_pairs):
        raise AssertionError("DS MEDIUM5 past the prune: a pump's length differs from plain")
    long_err = max_abs(long_pairs)
    if (long_err or pruned < DS.PRUNE
            or zlib.decompress(b"".join(long_out), -15) != long_in):
        raise AssertionError(f"DS MEDIUM5 past the prune: max abs err {long_err}, "
                             f"{pruned} bytes pruned")
    result.update(prune_stream={"bytes": len(long_in), "pumps": len(long_pairs),
                                "pruned": pruned, "max_abs_err": long_err,
                                "s": time.perf_counter() - t0},
                  launches=DS.launches["dstream"] - launched)
    print(f"phase 44 DS MEDIUM5 past the prune: {len(long_in)} bytes in {len(long_pairs)} "
          f"pumps equal to plain (max abs err {long_err}), {pruned} bytes pruned on the card, "
          f"decoded by zlib ({result['prune_stream']['s']:.1f} s); DS launches in the phase "
          f"{result['launches']}", flush=True)

    # the native bench rows' decode paths: inflate_parallel (K6), inflate_raw (SP2)
    body, index = bytearray(), []
    for k in range(0, len(corpus), 128 << 10):
        seg = corpus[k : k + (128 << 10)]
        c = zlib.compressobj(6, zlib.DEFLATED, -15)
        part = c.compress(seg) + c.flush(zlib.Z_FINISH if k + len(seg) == len(corpus)
                                         else zlib.Z_SYNC_FLUSH)
        index.append((len(body), len(part), len(seg)))
        body += part
    IK.launches["inflate"] = 0
    t0 = time.perf_counter()
    if native.inflate_parallel(bytes(body), index) != corpus:
        raise AssertionError("native.inflate_parallel is not the corpus")
    par_wall = time.perf_counter() - t0
    k6 = IK.launches["inflate"]
    for c in SK.launches:
        SK.launches[c] = 0
    raw1 = _raw(mib)
    t0 = time.perf_counter()
    if native.inflate_raw(raw1, len(mib))[0] != mib:
        raise AssertionError("native.inflate_raw is not the input")
    raw_wall = time.perf_counter() - t0
    sp = dict(SK.launches)
    if k6 < 1 or sp["spec_decode"] < 1:
        raise AssertionError(f"the native decode rows did not launch K6 ({k6}) or SP2 ({sp})")
    rows["inflate"]["inflate_parallel_launches"] = k6
    result.update(inflate_parallel={"chunks": len(index), "k6_launches": k6, "wall_s": par_wall},
                  inflate_raw={"sp_launches": sp, "wall_s": raw_wall},
                  phase_s=time.perf_counter() - t_start)
    print(f"phase 44 native.inflate_parallel: {len(index)} chunks back to the corpus in "
          f"{par_wall:.3f} s, K6 launches {k6}; native.inflate_raw of 1 MiB in {raw_wall:.3f} s, "
          f"SP launches {sp}; phase {result['phase_s']:.1f} s", flush=True)
    return result


def routes_phase(torch, corpus) -> dict:
    """Phase 42: the one-shot `decompress` of the corpus's zlib-6 and gzip
    streams and of a 1 MiB zlib stream (inflate_speculative), each equal
    to its input, cold and three warm with MB/s; inflate_raw against
    inflate_speculative on raw-6 streams of 16 KiB to 1 MiB, warm;
    then the CLI's native routes in processes: `--quick`, `--medium` and
    `--engine native` on the corpus as a file, each back through zlib and
    equal to deflate_parallel in this process, and `-d --engine native` of
    a gzip stream of two members giving back the corpus."""
    import gzip

    from zlib_rs_tpu_torch.models import oneshot
    from zlib_rs_tpu_torch.ops.kernels import speculative_kernel as SK
    from zlib_rs_tpu_torch.parallel import chunk_deflate as CD
    from zlib_rs_tpu_torch.parallel import speculative as S

    t_start = time.perf_counter()
    result = {"decompress": {}, "cli": {}}
    mib = corpus[: 1 << 20]
    for label, stream, want in (("zlib6", zlib.compress(corpus, 6), corpus),
                                ("gzip6", gzip.compress(corpus, 6), corpus),
                                ("zlib6_1mib", zlib.compress(mib, 6), mib)):
        for c in SK.launches:
            SK.launches[c] = 0
        walls = []
        for _ in range(4):
            t0 = time.perf_counter()
            out = oneshot.decompress(stream)
            walls.append(time.perf_counter() - t0)
            if out != want:
                raise AssertionError(f"the one-shot decompress of {label} is not its input")
        mbs = sorted(len(want) / w / 1e6 for w in walls[1:])
        result["decompress"][label] = {"bytes": len(stream), "cold_s": walls[0],
                                       "warm_s": walls[1:], "mb_s_median": mbs[1],
                                       "launches": dict(SK.launches)}
        print(f"phase 42 one-shot decompress {label}: {len(stream)} bytes, cold "
              f"{walls[0]:.4f} s, warm {[round(w, 4) for w in walls[1:]]} s (median "
              f"{mbs[1]:.1f} MB/s), launches {dict(SK.launches)}", flush=True)

    # the one-shot decode's engine by payload size: inflate_raw (one exact
    # SP2 decode, native's choice below 2 MiB) against inflate_speculative
    # (the port's at every size), warm, in turn on the same raw-6 streams
    result["raw_vs_speculative"] = {}
    for size in (16 << 10, 64 << 10, 256 << 10, 1 << 20):
        part = corpus[:size]
        c = zlib.compressobj(6, zlib.DEFLATED, -15)
        raw = c.compress(part) + c.flush()
        walls = {"inflate_raw": [], "inflate_speculative": []}
        for rep in range(4):
            for name in walls:
                t0 = time.perf_counter()
                out, used = getattr(S, name)(raw, size)
                wall = time.perf_counter() - t0
                if (out, used) != (part, len(raw)):
                    raise AssertionError(f"{name} of the {size}-byte raw-6 stream differs")
                if rep:
                    walls[name].append(wall)
        med = {name: sorted(w)[1] for name, w in walls.items()}
        result["raw_vs_speculative"][size] = {"raw_bytes": len(raw), "warm_s": walls,
                                              "median_s": med}
        print(f"phase 42 decode of {size} bytes ({len(raw)} raw-6), warm median s: "
              + ", ".join(f"{k} {v:.5f} ({size / v / 1e6:.1f} MB/s)" for k, v in med.items()),
              flush=True)

    root = Path(__file__).resolve().parent
    work = root / "build" / "chip_smoke_cli"  # git-ignored
    work.mkdir(parents=True, exist_ok=True)
    src = work / "native.bin"
    src.write_bytes(corpus)
    env = dict(os.environ, PYTHONPATH=str(root))

    def cli(*args) -> tuple[bytes, float]:
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-m", "zlib_rs_tpu_torch", *args],
                             capture_output=True, env=env, cwd=root, timeout=600)
        wall = time.perf_counter() - t0
        if run.returncode:
            raise AssertionError(f"the CLI {args} exited {run.returncode}: "
                                 f"{run.stderr.decode()[-2000:]}")
        return run.stdout, wall

    for label, flags, level, wrap_level in (("quick", ["--quick"], CD.QUICK, 1),
                                            ("medium", ["--medium", "-5"], CD.MEDIUM5, 5),
                                            ("native", ["--engine", "native", "-6"], 6, 6)):
        out, wall = cli("-c", *flags, str(src))
        if gzip.decompress(out) != corpus:
            raise AssertionError(f"the CLI's {label} output does not decode")
        if out != oneshot.wrap_raw(CD.deflate_parallel(corpus, level), corpus, 31, wrap_level):
            raise AssertionError(f"the CLI's {label} output differs from deflate_parallel's")
        result["cli"][label] = {"bytes": len(out), "wall_s": wall}
        print(f"phase 42 cli {' '.join(flags)}: {digest(out)}, {wall:.3f} s, equal to "
              f"deflate_parallel's and back through gzip", flush=True)
    members = work / "members.gz"
    half = len(corpus) // 2
    members.write_bytes(gzip.compress(corpus[:half], 6) + gzip.compress(corpus[half:], 1))
    back, wall = cli("-d", "-c", "--engine", "native", str(members))
    if back != corpus:
        raise AssertionError("the CLI's -d --engine native does not give back the corpus")
    result["cli"]["decompress_native"] = {"wall_s": wall}
    print(f"phase 42 cli -d --engine native: two gzip members back to the corpus, {wall:.3f} s",
          flush=True)
    result["phase_s"] = time.perf_counter() - t_start
    print(f"phase 42: {result['phase_s']:.1f} s", flush=True)
    return result


def host_strategy_phase(corpus) -> dict:
    """Phase 34: `compress_parallel` under each non-default strategy (the
    host engine) at level 6 on a 256 KiB slice, as zlib and gzip, each
    decoded by zlib with its length and sha256; return_index raising."""
    import zlib_rs_tpu_torch as zt
    from zlib_rs_tpu_torch.config import Strategy

    t_start = time.perf_counter()
    data = corpus[: 256 * 1024]
    result = {}
    for strategy in (Strategy.Filtered, Strategy.HuffmanOnly, Strategy.Rle, Strategy.Fixed):
        for wbits in (15, 31):
            t0 = time.perf_counter()
            out = zt.compress_parallel(data, 6, window_bits=wbits, strategy=strategy)
            wall = time.perf_counter() - t0
            if zlib.decompress(out, wbits) != data:
                raise AssertionError(f"{strategy.name} (window_bits {wbits}) does not decode")
            label = f"{strategy.name}_{'zlib' if wbits == 15 else 'gzip'}"
            result[label] = {"bytes": len(out), "sha256": hashlib.sha256(out).hexdigest(),
                             "wall_s": wall}
            print(f"phase 34 {label}: {len(data)} -> {digest(out)}, {wall:.3f} s", flush=True)
        try:
            zt.compress_parallel(data, 6, strategy=strategy, return_index=True)
        except ValueError:
            pass
        else:
            raise AssertionError(f"{strategy.name} with return_index did not raise")
    result["phase_s"] = time.perf_counter() - t_start
    print(f"phase 34: return_index raised under every strategy; phase "
          f"{result['phase_s']:.1f} s", flush=True)
    return result


def cli_phase(corpus) -> dict:
    """Phase 35: `python -m zlib_rs_tpu_torch -c --engine cuda` on the corpus
    as a file, in gzip, zlib and raw at levels 6 and 1 (ZRS_TPU_KERNEL
    unset, the CLI's default engine), each output decoded by zlib and equal
    to compress_parallel with the same arguments in this process; `--engine
    auto` on the corpus (the native route's stream, deflate_parallel in
    gzip) and on a file of half the CLI's TPU_THRESHOLD (the host
    engine's); `-d --engine cuda` of the corpus's
    gzip stream giving back the corpus, as a process and in this one (one
    K6 launch), and `-d --engine host` of the small file's."""
    import gzip

    import zlib_rs_tpu_torch as zt
    from zlib_rs_tpu_torch import cli as CLI
    from zlib_rs_tpu_torch.models import oneshot
    from zlib_rs_tpu_torch.ops.kernels import inflate_kernel as IK
    from zlib_rs_tpu_torch.parallel import chunk_deflate as CD

    t_start = time.perf_counter()
    root = Path(__file__).resolve().parent
    work = root / "build" / "chip_smoke_cli"  # git-ignored
    work.mkdir(parents=True, exist_ok=True)
    big, small = work / "corpus.bin", work / "small.bin"
    big.write_bytes(corpus)
    n_small = CLI.TPU_THRESHOLD // 2
    small.write_bytes(corpus[:n_small])
    env = dict(os.environ, PYTHONPATH=str(root))
    env.pop("ZRS_TPU_KERNEL", None)

    def cli(*args) -> tuple[bytes, float]:
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-m", "zlib_rs_tpu_torch", *args],
                             capture_output=True, env=env, cwd=root, timeout=600)
        wall = time.perf_counter() - t0
        if run.returncode:
            raise AssertionError(f"the CLI {args} exited {run.returncode}: "
                                 f"{run.stderr.decode()[-2000:]}")
        return run.stdout, wall

    result = {}
    kernel_env = os.environ.pop("ZRS_TPU_KERNEL", None)
    try:
        for fmt, wbits in (("gzip", 31), ("zlib", 15), ("raw", -15)):
            for level in (6, 1):
                out, wall = cli("-c", "--engine", "cuda", "--format", fmt, f"-{level}", str(big))
                if zlib.decompress(out, wbits) != corpus:
                    raise AssertionError(f"the CLI's {fmt} -{level} output does not decode")
                if out != zt.compress_parallel(corpus, level, window_bits=wbits):
                    raise AssertionError(f"the CLI's {fmt} -{level} output differs from "
                                         "compress_parallel's")
                result[f"{fmt}_{level}"] = {"bytes": len(out), "wall_s": wall,
                                            "sha256": hashlib.sha256(out).hexdigest()}
                print(f"phase 35 cli {fmt} -{level}: {digest(out)}, {wall:.3f} s, equal to "
                      f"compress_parallel", flush=True)
        _out, wall = cli("-k", "-f", "--engine", "auto", str(big), str(small))
        big_gz = (work / "corpus.bin.gz").read_bytes()
        small_gz = (work / "small.bin.gz").read_bytes()
        on_card = zt.compress_parallel(corpus[:n_small], 6, window_bits=31)
        # from TPU_THRESHOLD up, auto takes the native engine's port on the card
        if big_gz != oneshot.wrap_raw(CD.deflate_parallel(corpus, 6), corpus, 31, 6):
            raise AssertionError("--engine auto did not take the native route for 8 MiB")
        if (small_gz != oneshot.compress(corpus[:n_small], 6, window_bits=31)
                or small_gz == on_card or gzip.decompress(small_gz) != corpus[:n_small]):
            raise AssertionError(f"--engine auto did not take the host for {n_small} bytes")
        result["auto_wall_s"] = wall
        print(f"phase 35 cli auto: the 8 MiB file took the native route ({digest(big_gz)}), the "
              f"{n_small}-byte file the host ({digest(small_gz)}), {wall:.3f} s", flush=True)
        gz = work / "corpus.bin.gz"
        back, wall = cli("-d", "-c", "--engine", "cuda", str(gz))
        if back != corpus:
            raise AssertionError("the CLI's -d --engine cuda does not give back the corpus")
        result["decompress_cuda_wall_s"] = wall
        k0 = IK.launches["inflate"]
        t0 = time.perf_counter()
        if CLI.main(["-d", "-k", "-f", "--engine", "cuda", str(gz)]) != 0:
            raise AssertionError("the CLI's -d --engine cuda failed in this process")
        warm = time.perf_counter() - t0
        if big.read_bytes() != corpus or IK.launches["inflate"] != k0 + 1:
            raise AssertionError(f"the CLI's -d --engine cuda in this process: K6 launches "
                                 f"{IK.launches['inflate'] - k0}")
        result["decompress_cuda_in_process_s"] = warm
        print(f"phase 35 cli -d --engine cuda: the corpus back from {len(big_gz)} gzip bytes in "
              f"{wall:.3f} s as a process, {warm:.3f} s in this one (one K6 launch)", flush=True)
        back, wall = cli("-d", "-c", "--engine", "host", str(work / "small.bin.gz"))
        if back != corpus[:n_small]:
            raise AssertionError("the CLI's -d --engine host does not give back the small file")
        result["decompress_host_small_wall_s"] = wall
        print(f"phase 35 cli -d --engine host: {n_small} bytes back in {wall:.3f} s", flush=True)
    finally:
        if kernel_env is not None:
            os.environ["ZRS_TPU_KERNEL"] = kernel_env
    result["phase_s"] = time.perf_counter() - t_start
    print(f"phase 35: {result['phase_s']:.1f} s", flush=True)
    return result


def engine_names_phase(torch, corpus, idx_out, index, gz, gz_index) -> dict:
    """Phase 36: decompress_parallel's engine names on the indexed zlib and
    gzip streams: "tpu" gives the bytes and fallbacks of "device"; "auto"
    decodes through the region decode (one K6 launch, no lockstep run),
    cold and three warm. Then the last step of the device chain on a small
    indexed stream (two chunks of 16 KiB and one of 1,000 bytes) whose
    engines all fault under ZRS_TPU_KERNEL=0 (phase 8's undersized cap for
    the vector engine, every lane of the swarm engine flagged bad): the
    region decode gives back the input through K6, and through the
    lockstep engine on the 1,000-byte region when K6 refuses it too.
    Last, the time to raise on a flipped byte in a 128 KiB chunk of the
    XLA engine's indexed stream (ZRS_TPU_KERNEL unset, a user's default):
    every engine faults, and the region decode runs the lockstep engine on
    the one region K6 refuses."""
    import zlib_rs_tpu_torch as zt
    from zlib_rs_tpu_torch import _device
    from zlib_rs_tpu_torch.ops.kernels import inflate_kernel as IK
    from zlib_rs_tpu_torch.parallel import device_inflate as DI
    from zlib_rs_tpu_torch.parallel import pipeline as PL
    from zlib_rs_tpu_torch.parallel import swarm_inflate as SW
    from zlib_rs_tpu_torch.parallel import vector_inflate as VI

    t_start = time.perf_counter()
    result = {}
    PL._FALLBACKS.clear()
    for label, stream, ix in (("zlib", idx_out, index), ("gzip", gz, gz_index)):
        outs, stats = [], []
        for engine in ("device", "tpu"):
            outs.append(zt.decompress_parallel(stream, ix, engine=engine))
            stats.append(PL.fallback_stats())
        if outs[0] != corpus or outs[1] != outs[0] or stats[0] != stats[1] or stats[0]:
            raise AssertionError(f"tpu and device differ on the {label} stream: {stats}")
        k0, r0 = IK.launches["inflate"], dict(DI.runs)
        t0 = time.perf_counter()
        back = zt.decompress_parallel(stream, ix, engine="auto")
        cold = time.perf_counter() - t0
        if (back != corpus or IK.launches["inflate"] != k0 + 1 or DI.runs != r0
                or PL.fallback_stats()):
            raise AssertionError(f"auto on the {label} stream: K6 launches "
                                 f"{IK.launches['inflate'] - k0}, lockstep {DI.runs} against "
                                 f"{r0}, fallbacks {PL.fallback_stats()}")
        result[f"auto_{label}"] = {"cold_s": cold, **warm_runs(
            torch, PL, lambda: zt.decompress_parallel(stream, ix, engine="auto"), corpus,
            len(corpus), f"auto decode {label}", 36)}
        print(f"phase 36 {label}: tpu equals device (no fallback); auto through the region "
              f"decode, one K6 launch, no lockstep run, cold {cold:.3f} s", flush=True)

    data = corpus[:33_768]
    kernel_env = os.environ.pop("ZRS_TPU_KERNEL", None)
    try:
        small, small_ix = zt.compress_parallel(data, 6, chunk_size=16_384, return_index=True)
    finally:
        if kernel_env is not None:
            os.environ["ZRS_TPU_KERNEL"] = kernel_env
    real_cap, real_seeded, real_decode = VI._twoplane_cap, SW.decode_seeded, IK.decode_streams

    def swarm_all_bad(*a, **k):
        out, produced, bad = real_seeded(*a, **k)
        return out, produced, torch.ones_like(bad)

    def k6_refuses_lane_2(*a, **k):
        out, produced, bad, end_bit = real_decode(*a, **k)
        bad = bad.clone()
        bad[2] = True
        return out, produced, bad, end_bit

    os.environ["ZRS_TPU_KERNEL"] = "0"
    VI._twoplane_cap = lambda m: UNDERSIZED_CAP
    SW.decode_seeded = swarm_all_bad
    try:
        for case in ("K6", "lockstep"):
            if case == "lockstep":
                IK.decode_streams = k6_refuses_lane_2
            PL._FALLBACKS.clear()
            k0, r0 = IK.launches["inflate"], dict(DI.runs)
            t0 = time.perf_counter()
            back = zt.decompress_parallel(small, small_ix)
            wall = time.perf_counter() - t0
            stats = PL.fallback_stats()
            work = {"k6_launches": IK.launches["inflate"] - k0,
                    "lockstep_runs": DI.runs["decode_regions"] - r0["decode_regions"],
                    "lockstep_steps": DI.runs["steps"] - r0["steps"]}
            want = {"vector_decode:ValueError": 1, "swarm_decode:ValueError": 1}
            if case == "lockstep":
                want["region_kernel:ValueError"] = 1
            if (back != data or stats != want or work["k6_launches"] != 1
                    or (work["lockstep_runs"] == 1) != (case == "lockstep")):
                raise AssertionError(f"the last step ({case}): input back {back == data}, "
                                     f"fallbacks {stats}, {work}")
            result[f"last_step_{case}"] = {"wall_s": wall, "fallbacks": stats, **work}
            print(f"phase 36 last step ({case}): {len(small_ix)} chunks back after {stats}; "
                  f"{work}; {wall:.3f} s", flush=True)
    finally:
        VI._twoplane_cap, SW.decode_seeded, IK.decode_streams = (
            real_cap, real_seeded, real_decode)
        if kernel_env is None:
            os.environ.pop("ZRS_TPU_KERNEL", None)
        else:
            os.environ["ZRS_TPU_KERNEL"] = kernel_env
        PL._FALLBACKS.clear()

    kernel_env = os.environ.pop("ZRS_TPU_KERNEL", None)
    try:
        data = corpus[: 4 * 131072]
        xla_out, xla_ix = zt.compress_parallel(data, 6, return_index=True)
        off, ln, n = xla_ix[1]
        # the first byte from chunk 1's middle whose flip K6 refuses, so
        # that the region decode runs the lockstep engine on it
        flips = [off + ln // 2 + k for k in range(64)]
        bodies = []
        for at in flips:
            body = bytearray(xla_out[off : off + ln])
            body[at - off] ^= 0xFF
            bodies.append(bytes(body))
        _o, produced, bad, _e = IK.decode_streams(
            *SW._kernel_inputs(bodies, [n] * len(bodies), _device.resolve_device(None)),
            max_out=n)
        refused = (bad | (produced < n)).cpu().numpy()
        if not refused.any():
            raise AssertionError("K6 refused none of 64 flipped bytes in a 128 KiB chunk")
        at = flips[int(refused.argmax())]
        broken = bytearray(xla_out)
        broken[at] ^= 0xFF
        r0 = dict(DI.runs)
        DI.launches["lockstep"] = 0
        why, wall, raise_stages = time_to_raise(
            torch, PL, lambda: zt.decompress_parallel(bytes(broken), xla_ix))
        lockstep_launches = DI.launches["lockstep"]
        if lockstep_launches < 1:
            raise AssertionError("the region decode of a refused 128 KiB chunk launched no "
                                 "lockstep kernel")
        stats = PL.fallback_stats()
        PL._FALLBACKS.clear()
        steps = DI.runs["steps"] - r0["steps"]
        if zt.decompress_parallel(xla_out, xla_ix) != data or PL.fallback_stats():
            raise AssertionError("the clean 128 KiB-chunk decode after the flipped byte failed")
    finally:
        if kernel_env is not None:
            os.environ["ZRS_TPU_KERNEL"] = kernel_env
        PL._FALLBACKS.clear()
    result["flipped_128k"] = {"raise_s": wall, "stages_ms": raise_stages, "why": why,
                              "fallbacks": stats,
                              "flip_at": at - off, "chunk_bytes": ln,
                              "lockstep_runs": DI.runs["decode_regions"] - r0["decode_regions"],
                              "lockstep_launches": lockstep_launches, "lockstep_steps": steps}
    print(f"phase 36 flipped byte {at - off} of the {ln}-byte chunk 1 (128 KiB out, "
          f"{len(xla_ix)} chunks): ValueError ({why}) "
          f"after {stats}, {steps} lockstep steps in {lockstep_launches} lockstep kernel "
          f"launch(es), {wall:.3f} s to raise (stages, ms: {raise_stages})", flush=True)
    result["phase_s"] = time.perf_counter() - t_start
    print(f"phase 36: {result['phase_s']:.1f} s", flush=True)
    return result


def _pump_deflate(zt, data: bytes, in_bytes: int, out_bytes: int, flush) -> bytes:
    """A `Deflate` stream of `data` fed `in_bytes` at a time with `flush`,
    drained `out_bytes` a call, then finished."""
    from zlib_rs_tpu_torch.config import DeflateFlush
    from zlib_rs_tpu_torch.models.stream import Status

    d = zt.Deflate(level=LEVEL)
    out = bytearray()
    for i in range(0, len(data), in_bytes):
        _st, _used, o = d.compress(data[i : i + in_bytes], flush, out_bytes)
        out += o
        while d.pending[0]:
            out += d.compress(b"", DeflateFlush.NO_FLUSH, out_bytes)[2]
    while True:
        st, _used, o = d.compress(b"", DeflateFlush.FINISH, out_bytes)
        out += o
        if st is Status.StreamEnd:
            return bytes(out)


def _pump_inflate(zt, stream: bytes, in_bytes: int, out_bytes: int, flush) -> bytes:
    """An `Inflate` of `stream` fed `in_bytes` at a time, `out_bytes` out a
    call, under `flush`; raises if it does not reach the stream's end."""
    from zlib_rs_tpu_torch.models.stream import Status

    inf = zt.Inflate()
    out = bytearray()
    pos = 0
    for _ in range(4 * (len(stream) + 1) * max(1, 65536 // out_bytes)):
        st, used, o = inf.decompress(stream[pos : pos + in_bytes], out_bytes, flush)
        pos += used
        out += o
        if st is Status.StreamEnd:
            return bytes(out)
    raise AssertionError(f"Inflate under {flush.name} did not reach the stream's end")


def host_layers_phase(corpus) -> dict:
    """Phase 38: the host API layers on 64 KiB of the corpus, each result
    held against stdlib zlib: `Deflate` under every flush mode through 4
    KiB buffers and without one through 1-byte buffers, `Inflate` of each
    stream through 4 KiB buffers under every inflate flush mode and of one
    through 1-byte buffers; a `GzFile` write, then read; `inflate_back`;
    `compress_medium` at 4-6 and `compress_quick`; zran `extract` at three
    offsets; `crc32_combine_op`."""
    import zlib_rs_tpu_torch as zt
    from zlib_rs_tpu_torch.config import DeflateFlush, InflateFlush, ReturnCode
    from zlib_rs_tpu_torch.models.medium import compress_quick

    t0 = time.perf_counter()
    data = corpus[1 << 20 : (1 << 20) + 65536]
    modes = [m for m in DeflateFlush if m is not DeflateFlush.FINISH]
    streams = []
    for mode in modes:
        stream = _pump_deflate(zt, data, 4096, 4096, mode)
        if zlib.decompress(stream) != data:
            raise AssertionError(f"Deflate under {mode.name} does not decode with zlib")
        streams.append(stream)
    one = _pump_deflate(zt, data, 1, 1, DeflateFlush.NO_FLUSH)
    if one != streams[0] or _pump_inflate(zt, one, 1, 1, InflateFlush.NO_FLUSH) != data:
        raise AssertionError("the 1-byte Deflate/Inflate round trip failed")
    inflate_modes = list(InflateFlush)
    for k, stream in enumerate(streams):
        for fl in (inflate_modes[k % len(inflate_modes)], InflateFlush.NO_FLUSH):
            if _pump_inflate(zt, stream, 4096, 4096, fl) != data:
                raise AssertionError(f"Inflate under {fl.name} is not the data")
    streams_s = time.perf_counter() - t0

    buf = io.BytesIO()
    f = zt.GzFile(fileobj=buf, mode="wb6")
    f.write(data)
    f.close()
    gz = buf.getvalue()
    f = zt.GzFile(fileobj=io.BytesIO(gz), mode="rb")
    back = f.read()
    f.close()
    if zlib.decompress(gz, 31) != data or back != data:
        raise AssertionError("the GzFile write/read round trip failed")

    raw = _raw(data)
    pieces = iter([raw[i : i + 4096] for i in range(0, len(raw), 4096)])
    got = bytearray()
    rc = zt.inflate_back(lambda: next(pieces, b""), lambda b: got.extend(b) or True)
    if rc != ReturnCode.StreamEnd or bytes(got) != data:
        raise AssertionError(f"inflate_back: {rc}")

    medium = {lv: len(zt.compress_medium(data, lv)) for lv in (4, 5, 6)}
    for lv in medium:
        if zlib.decompress(zt.compress_medium(data, lv), -15) != data:
            raise AssertionError(f"compress_medium({lv}) does not decode with zlib")
    quick = compress_quick(data)
    if zlib.decompress(quick, -15) != data:
        raise AssertionError("compress_quick does not decode with zlib")

    zs = zlib.compress(data, LEVEL)
    index = zt.build_index(zs, span=16384)
    offsets = (0, 30_000, len(data) - 1000)
    for off in offsets:
        if zt.extract(zs, index, off, 1000) != data[off : off + 1000]:
            raise AssertionError(f"extract at {off} is not the data")

    a, b = data[:40_000], data[40_000:]
    op = zt.crc32_combine_gen(len(b))
    if zt.crc32_combine_op(zlib.crc32(a), zlib.crc32(b), op) != zlib.crc32(data):
        raise AssertionError("crc32_combine_op is not zlib's crc32")
    wall = time.perf_counter() - t0
    result = {"bytes": len(data), "streams_s": streams_s, "phase_s": wall,
              "deflate_bytes": {m.name: len(st) for m, st in zip(modes, streams)},
              "medium_bytes": medium, "quick_bytes": len(quick), "gzfile_bytes": len(gz),
              "extract_points": len(index.points)}
    print(f"phase 38 host layers: {len(data)} bytes; Deflate under "
          f"{', '.join(m.name for m in modes)} (4 KiB buffers) and NO_FLUSH (1-byte) decode "
          f"with zlib, Inflate of each under every inflate flush mode and through 1-byte "
          f"buffers gives the data ({streams_s:.1f} s); GzFile write/read ({len(gz)} bytes), "
          f"inflate_back, compress_medium {medium} and compress_quick ({len(quick)} bytes), "
          f"extract at {offsets} over {len(index.points)} points and crc32_combine_op equal "
          f"zlib; phase {wall:.1f} s", flush=True)
    return result


def mesh_phase(torch, corpus, out, warm) -> dict:
    """Phase 39: the multi-device path in a one-rank NCCL group on cuda:0
    (one card shows the collectives run, not how they scale).
    `compress_parallel(mesh=)` of the corpus under ZRS_TPU_KERNEL=1, whose
    stream must equal phase 4's (`out`) with K1, K2 and K3 launched, and
    three warm runs beside phase 4's (`warm`); the XLA engine's level-6
    stream under the mesh equal to its unsharded one; the sharded decode
    step on the XLA engine's 128 KiB indexed stream through the walker
    kernel, byte-exact; and `graft_entry.dryrun_multichip(1)` joining the
    group. The group is destroyed before the next phase."""
    import socket

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    import zlib_rs_tpu_torch as zt
    from zlib_rs_tpu_torch import graft_entry
    from zlib_rs_tpu_torch.ops.kernels import checksum_kernels as CK
    from zlib_rs_tpu_torch.ops.kernels import deflate_kernel as DK
    from zlib_rs_tpu_torch.parallel import mesh as M
    from zlib_rs_tpu_torch.parallel import pipeline as PL
    from zlib_rs_tpu_torch.parallel import swarm_inflate as SW

    t_start = time.perf_counter()
    result = {}
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0, world_size=1)
    kernel_env = os.environ.get("ZRS_TPU_KERNEL")
    try:
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("chunks",))
        os.environ["ZRS_TPU_KERNEL"] = "1"
        for c in (CK.launches, DK.launches):
            for name in c:
                c[name] = 0
        t0 = time.perf_counter()
        sharded = zt.compress_parallel(corpus, LEVEL, mesh=mesh)
        cold_s = time.perf_counter() - t0
        launches = {"adler32_batch": CK.launches["adler32_batch"],
                    "hop_chase": DK.launches["hop_chase"], "pack": DK.launches["pack"]}
        if min(launches.values()) < 1:
            raise AssertionError(f"the sharded kernel-engine encode missed a kernel: {launches}")
        if sharded != out:
            raise AssertionError(f"the sharded kernel-engine stream {digest(sharded)} is not "
                                 f"phase 4's {digest(out)}")
        if zlib.decompress(sharded) != corpus:
            raise AssertionError("the sharded kernel-engine stream does not decode")
        print(f"phase 39 mesh kernel engine: {digest(sharded)}, equal to phase 4's stream, cold "
              f"{cold_s:.3f} s, launches {launches}", flush=True)
        result["kernel_engine"] = {"cold_s": cold_s, "launches": launches, **warm_runs(
            torch, PL, lambda: zt.compress_parallel(corpus, LEVEL, mesh=mesh), out,
            len(corpus), "mesh warm", 39)}
        print("phase 39 beside phase 4's warm wall s: "
              + ", ".join(f"{w:.4f}" for w in warm["warm_s"]), flush=True)

        os.environ.pop("ZRS_TPU_KERNEL")  # the XLA engine
        t0 = time.perf_counter()
        xla_sharded = zt.compress_parallel(corpus, LEVEL, mesh=mesh)
        xla_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        xla = zt.compress_parallel(corpus, LEVEL)
        plain_s = time.perf_counter() - t0
        if xla_sharded != xla or zlib.decompress(xla) != corpus:
            raise AssertionError(f"the XLA engine's sharded stream {digest(xla_sharded)} is not "
                                 f"its unsharded {digest(xla)}")
        result["xla_engine"] = {"wall_s": xla_s, "unsharded_wall_s": plain_s,
                                "bytes_out": len(xla)}
        print(f"phase 39 mesh XLA engine level {LEVEL}: {digest(xla_sharded)}, equal to the "
              f"unsharded stream, {xla_s:.3f} s (unsharded {plain_s:.3f} s)", flush=True)

        # one all_gather of a kernel-engine batch's fields (16 rows of the
        # fetched words, bits, adler, ll and d), alone, by events
        lay = M.layout(mesh)
        buf = torch.zeros((PL.TAIL_BATCH, PL.DEFAULT_CHUNK // 4 + 80 + 2 + 286 + 30),
                          dtype=torch.int32, device=lay.device)
        result["gather_ms"] = event_ms(torch, lambda: M.gather_rows(buf, lay), 50)
        print(f"phase 39 one all_gather of a {tuple(buf.shape)} int32 batch buffer: "
              f"{result['gather_ms']:.4f} ms by events", flush=True)

        idx_out, index = zt.compress_parallel(corpus, LEVEL, return_index=True)
        sizes = [n for *_, n in index]
        *operands, cap = SW.seeded_inputs([idx_out[o : o + n] for o, n, _ in index], sizes,
                                          index.seeds)
        step = SW.make_sharded_decode_step(mesh, cap=cap, max_out=max(sizes))
        args = [torch.from_numpy(a) for a in operands]
        walks = SW.launches["swarm_walk"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outb, produced, bad = step(*args)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        walks = SW.launches["swarm_walk"] - walks
        got = outb.cpu().numpy()
        if bad.any() or walks < 1 or outb.device.type != "cuda":
            raise AssertionError(f"the sharded decode step: bad lanes {int(bad.sum())}, walker "
                                 f"launches {walks}, output on {outb.device}")
        if b"".join(got[k, : sizes[k]].tobytes() for k in range(len(sizes))) != corpus:
            raise AssertionError("the sharded decode step gave other bytes")
        result["decode_step"] = {"chunks": len(sizes), "cap": cap, "wall_s": decode_s,
                                 "walker_launches": walks}
        print(f"phase 39 sharded decode step: {len(sizes)} chunks of {PL.XLA_CHUNK} bytes "
              f"byte-exact through {walks} walker kernel launch(es), cap {cap}, "
              f"{decode_s:.3f} s", flush=True)

        result["dryrun"] = graft_entry.dryrun_multichip(1)
    finally:
        if kernel_env is None:
            os.environ.pop("ZRS_TPU_KERNEL", None)
        else:
            os.environ["ZRS_TPU_KERNEL"] = kernel_env
        dist.destroy_process_group()
    result["phase_s"] = time.perf_counter() - t_start
    print(f"phase 39: {result['phase_s']:.1f} s", flush=True)
    return result


NATIVE_ROWS = {  # bench.py's bench_native rows: each one's keys
    **{f"compress.{lv}": ("gbps", "ratio_vs_zlib", "bit_exact") for lv in range(10)},
    **{f"parallel_compress.{lv}": ("gbps", "ratio_vs_zlib") for lv in (1, 6, 9)},
    "quick": ("gbps", "ratio_vs_zlib1"),
    **{f"medium.{lv}": ("gbps", "ratio_vs_zlib") for lv in (4, 5, 6)},
    "inflate_gbps": None, "parallel_inflate_gbps": None, "speculative_inflate_gbps": None,
}
SWEEP_ROWS = [f"2^{b}" for b in range(4, 25)] + ["pure_engine_2^14"]


def bench_rows(full: dict) -> list:
    """(section, row, engine, value) of every native and decode-sweep row
    of the bench's full line; raises where a row is missing or is neither
    measured (its keys, or a rate) nor cut_by_budget."""
    native, sweep = full["native"], full["host_stream_decode_mbps_by_input_chunk"]
    out = []
    for name, keys in NATIVE_ROWS.items():
        group, _, lv = name.partition(".")
        v = native.get(group, {}).get(lv) if lv else native.get(group)
        ok = isinstance(v, dict) and (v.get("cut_by_budget") or (
            keys is not None and all(k in v for k in keys))) or (
            keys is None and isinstance(v, (int, float)))
        if not ok:
            raise AssertionError(f"the bench's native row {name}: {v}")
        out.append(("native", name, native["engines"][group], v))
    for name in SWEEP_ROWS:
        v = sweep.get(name)
        if not (isinstance(v, (int, float)) or isinstance(v, dict) and v.get("cut_by_budget")):
            raise AssertionError(f"the bench's decode sweep row {name}: {v}")
        out.append(("decode_sweep", name,
                    sweep["engines"]["2^N" if name.startswith("2^") else name], v))
    return out


def bench_phase(budget_s: float) -> dict:
    """Phase 37: `python -m zlib_rs_tpu_torch.bench` with ZRS_BENCH_BUDGET_S
    = `budget_s`: its last line parses, `value` > 0 from torch.profiler,
    a kernel ratio, a vector decode rate and both native inflate rates;
    every device phase left its key in the full line above it (the native
    rows and the decode sweep at its top level) and none failed or was
    skipped; every row of bench.py's bench_native and bench_decode_sweep
    is there, measured or cut_by_budget, and is printed with its engine."""
    from zlib_rs_tpu_torch import bench

    t_start = time.perf_counter()
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root), ZRS_BENCH_BUDGET_S=str(int(budget_s)))
    for name in ("ZRS_TPU_KERNEL", "ZRS_BENCH_TARGET_MB"):
        env.pop(name, None)
    run = subprocess.run([sys.executable, "-m", "zlib_rs_tpu_torch.bench"],
                         capture_output=True, text=True, env=env, cwd=root,
                         timeout=budget_s + 120)
    lines = run.stdout.strip().splitlines()
    if run.returncode or len(lines) < 2:
        raise AssertionError(f"the bench exited {run.returncode}: {run.stderr[-3000:]}")
    compact, full = json.loads(lines[-1]), json.loads(lines[-2])
    dev = full["device"]
    where = dict(dev, native=full["native"],
                 decode_sweep=full["host_stream_decode_mbps_by_input_chunk"])
    missing = [p for p, key in bench.PHASE_KEYS.items() if key not in where]
    if (len(lines[-1]) >= 500 or not compact["value"] > 0
            or "torch.profiler" not in compact["value_source"]
            or compact["kernel_ratio"] is None or not (compact["vector_decode_gbps"] or 0) > 0
            or compact["native_inflate_gbps"] is None
            or compact["parallel_inflate_gbps"] is None
            or missing or full["device_phase_errors"]):
        raise AssertionError(f"the bench's result: compact {compact}, phases without their "
                             f"key {missing}, errors {full['device_phase_errors']}; "
                             f"{run.stderr[-3000:]}")
    table = bench_rows(full)
    for section, name, engine, v in table:
        print(f"phase 37 bench {section} {name} [{engine}]: {json.dumps(v)}", flush=True)
    print(f"phase 37 bench full line: {lines[-2]}", flush=True)
    print(f"phase 37 bench: {lines[-1]}; device-busy share "
          f"{json.dumps(full['device_busy_share'])}; card {full['card']}; "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    return {"compact": compact, "device": dev, "busy_share": full["device_busy_share"],
            "native": full["native"],
            "decode_sweep": full["host_stream_decode_mbps_by_input_chunk"],
            "cut_by_budget": [n for _s, n, _e, v in table
                              if isinstance(v, dict) and v.get("cut_by_budget")],
            "phase_seconds": full["phase_seconds"], "phase_s": time.perf_counter() - t_start}


def main() -> int:
    import torch

    t_main = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    os.environ["ZRS_TPU_KERNEL"] = "1"  # the kernel engine (phases 26-31 unset it)
    root = Path(__file__).resolve().parent
    if not (root / "zlib_rs_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    import zlib_rs_tpu_torch as zt
    from zlib_rs_tpu_torch import _device
    from zlib_rs_tpu_torch.ops import lzvec
    from zlib_rs_tpu_torch.ops.kernels import checksum_kernels as CK
    from zlib_rs_tpu_torch.ops.kernels import crc_kernels as CRC
    from zlib_rs_tpu_torch.ops.kernels import deflate_kernel as DK
    from zlib_rs_tpu_torch.ops.kernels import inflate_kernel as IK
    from zlib_rs_tpu_torch.ops.kernels import vhuff_kernel as VK
    from zlib_rs_tpu_torch.parallel import pipeline as PL

    dev = _device.resolve_device(None)
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    print(f"card: {smi} ({torch.cuda.device_count()} visible), torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, zlib {zlib.ZLIB_RUNTIME_VERSION}",
          flush=True)

    t0 = time.perf_counter()
    _device.build()
    for name in _device.SOURCES:
        _device.library(name)
    print(f"setup: built {', '.join(_device.SOURCES)} for sm_90a in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)

    corpus, members = load_corpus(CORPUS_BYTES)
    print(f"corpus: {len(corpus)} bytes, tar of {members}", flush=True)

    # the main path's first super-batch, as compress_parallel builds it
    good, mlazy, nice, chain = PL._level_knobs(LEVEL)["kernel_cfg"]
    _variant, w_g = PL._resolve_kernel_variant((good, mlazy, nice, chain))
    cs = PL.DEFAULT_CHUNK
    n_chunks = -(-len(corpus) // cs)
    dict_size = PL.priming_dict_size(n_chunks, cs, True)
    padded, n_valid, valid_from, data_len = PL.chunk_buffers(corpus, cs, dict_size)
    b0, bsz = PL.batch_spans(n_chunks)[0]
    dc = torch.from_numpy(padded[b0 : b0 + bsz]).to(dev)
    dn = torch.from_numpy(n_valid[b0 : b0 + bsz]).to(dev)
    dv = torch.from_numpy(valid_from[b0 : b0 + bsz]).to(dev)
    words4 = DK.words_from_bytes(dc)
    htab = lzvec.build_hop_tables(
        words4, dn, dv, depth=chain, nice=nice, good=good, max_lazy=mlazy,
        w_g=w_g, bytes_arr=dc,
    )
    torch.cuda.synchronize()
    print(f"batch: {bsz} chunks of {cs} bytes, dict {dict_size}, words "
          f"{tuple(words4.shape)}, htab {tuple(htab.shape)}", flush=True)
    rows = {}

    # -- phase 1: K1 against its plain version and zlib ------------------
    seg = dc[:, dict_size : dict_size + cs]
    lens = (dn - dict_size).to(torch.int32)
    got = CK.adler32_batch_cuda(seg, lens)
    want = CK.adler32_batch_plain(seg, lens)
    err = max_abs([(got, want)])
    host = seg.cpu().numpy()
    for r in range(bsz):
        z = zlib.adler32(host[r, : int(lens[r])].tobytes())
        if int(got[r].item()) & 0xFFFFFFFF != z:
            raise AssertionError(f"K1 row {r}: {int(got[r]) & 0xFFFFFFFF:#x} != zlib {z:#x}")
    g = torch.Generator().manual_seed(1)
    rag = torch.randint(0, 256, (3, 1000), generator=g, dtype=torch.uint8)
    rlen = torch.tensor([0, 517, 1000], dtype=torch.int32)
    rg = CK.adler32_batch_cuda(rag.to(dev), rlen.to(dev))
    err = max(err, max_abs([(rg, CK.adler32_batch_plain(rag, rlen))]))
    for r in range(3):
        if int(rg[r].item()) & 0xFFFFFFFF != zlib.adler32(rag[r, : rlen[r]].numpy().tobytes()):
            raise AssertionError(f"K1 ragged row {r} disagrees with zlib")
    err = max(err, max_abs(checksum_edge_pairs(torch, dev, CK.adler32_batch_cuda,
                                               CK.adler32_batch_plain, zlib.adler32, CK.THREADS,
                                               CK.SEG, "K1")))
    if err:
        raise AssertionError(f"K1 disagrees with its plain version: max abs err {err}")
    nb = int(lens.sum())
    rows["adler32_batch"] = dict(
        source="zlib_rs_tpu_torch/csrc/adler32.cu",
        replaces="zlib_rs_tpu/ops/pallas/checksum_kernels.py:64",
        max_abs_err=err,
        ms=event_ms(torch, lambda: CK.adler32_batch_cuda(seg, lens), 50),
        queued_ms=queued_ms(torch, lambda: CK.adler32_batch_cuda(seg, lens)),
        plain_ms=event_ms(torch, lambda: CK.adler32_batch_plain(seg, lens), 10),
        bnd=bound(nb + 8 * bsz, 3 * nb),
    )
    print(f"phase 1 K1: {bsz}x{cs}, 3x1000 ragged and the design's edge rows (lengths "
          f"{design_lengths(CK.THREADS, CK.SEG, CK.THREADS * CK.SEG + 100)} and all-0xFF rows "
          f"at misaligned starts) equal to plain and zlib; {CK.THREADS} threads a row, "
          f"{CK.SEG} bytes a thread a pass", flush=True)

    # -- phase 2: K2 against its plain version -----------------------------
    cap_g = 4 * w_g
    chase = DK.hop_chase_cuda(words4, htab, dn, dict_size, cap_g)
    plain, plain_ms = timed_ms(
        torch, lambda: DK.hop_chase_plain(words4, htab, dn, dict_size, cap_g))
    kpost = DK._hop_post(*chase)
    ppost = DK._hop_post(*plain)
    nm_k = kpost[2]
    if not torch.equal(nm_k, ppost[2]) or not torch.equal(kpost[3], ppost[3]):
        raise AssertionError("K2's nmatch or bad differ from its plain version's")
    sel = torch.cat([torch.arange(0, 286), torch.arange(288, 318)]).to(dev)
    pairs = [(kpost[4][:, sel], ppost[4][:, sel])]
    for r in range(bsz):
        m = int(nm_k[r])
        pairs += [(chase[0][r, :m], plain[0][r, :m]), (chase[1][r, :m], plain[1][r, :m])]
    # every array and every bin of every bank, at the whole span and at
    # tiles of MIN_TILE (~32 tile edges a chunk), on the batch and on the
    # crafted lanes (an overflowing lane past one tile, far match sources)
    small = DK.hop_chase_cuda(words4, htab, dn, dict_size, cap_g, tile=DK.MIN_TILE)
    for got in (chase, small):
        pairs += [(got[2], plain[2]), (got[3], plain[3])]
        for r in range(bsz):
            m = int(nm_k[r])
            pairs += [(got[0][r, :m], plain[0][r, :m]), (got[1][r, :m], plain[1][r, :m])]
    for lanes in hop_crafted_lanes(DK, dev, words4, htab, dn, dict_size, cap_g):
        for tile in (DK.TILE, DK.MIN_TILE):
            pairs += hop_pairs(lambda *a, t=tile: DK.hop_chase_cuda(*a, tile=t),
                               DK.hop_chase_plain, lanes, DK.CAP_M)
    err = max_abs(pairs)
    if err:
        raise AssertionError(f"K2 disagrees with its plain version: max abs err {err}")
    st = chase[2]
    nmatch = st[:, 0].long()
    span = (dn - dict_size).long()
    nb = int((span + 8 * nmatch + 8 * nmatch + 32 + 4 * 4 * 320).sum())
    rows["hop_chase"] = dict(
        source="zlib_rs_tpu_torch/csrc/hop_chase_il.cu",
        replaces="zlib_rs_tpu/ops/pallas/deflate_kernel.py:895",
        max_abs_err=err,
        ms=event_ms(torch, lambda: DK.hop_chase_cuda(words4, htab, dn, dict_size, cap_g), 5),
        plain_ms=plain_ms,
        bnd=bound(nb, int((span + 20 * nmatch).sum())),
    )
    print(f"phase 2 K2: {bsz} chunks ({int(nm_k.sum())} matches) equal to plain in every bin "
          f"at tiles of {DK.TILE} and {DK.MIN_TILE}, and an overflowing lane and far match "
          f"sources; launch: K12's body with K2's recount, {DK.RESOLVE_THREADS} threads a "
          f"block, {4 * DK.TILE} bytes of dynamic shared memory", flush=True)

    # -- phase 3: K3 against its plain version, with and without seeds -----
    k = min(COMPARE_ROWS, bsz)
    # the first chunks of the batch, then the crafted lanes: an empty
    # chunk, an all-literal one, 258-byte dist-1 runs, 15 bits a byte
    mpos, mld, nm, kbad, freq = DK._hop_post(*chase)
    nm_eff = torch.where(kbad, 0, nm)
    lltab, dtab = DK.code_tables(freq)
    crafted = pack_crafted_lanes(torch, DK, dev, dc.shape[1], dict_size, mpos.shape[1])
    pairs = []
    for n_seeds in (0, PL.SEEDS_PER_CHUNK):
        pairs += pack_pairs(DK, dc[:k], dn[:k], dict_size, nm_eff[:k], mpos[:k], mld[:k],
                            lltab[:k], dtab[:k], n_seeds)
        cc, cn, cm, cp, cl, ct, cd = crafted
        pairs += pack_pairs(DK, cc, cn, dict_size, cm, cp, cl, ct, cd, n_seeds)
    err = max_abs(pairs)
    if err:
        raise AssertionError(f"K3 disagrees with its plain version: max abs err {err}")
    words, meta, oww = DK.pack_inputs(dc, dn, dict_size, nm_eff, 0)
    args = (words, mpos, mld, meta, lltab, dtab, oww, 0)
    st3 = DK.pack_cuda(*args)[1]
    torch.cuda.synchronize()
    nmk = nm_eff.long()
    out_words = st3[:, 0].long() // 32 + 2
    nb = int((span + 8 * nmk + 4 * 320 + 32 + 4 * out_words + 32 + 4 * 320).sum())
    rows["pack"] = dict(
        source="zlib_rs_tpu_torch/csrc/pack.cu",
        replaces="zlib_rs_tpu/ops/pallas/deflate_kernel.py:1487",
        max_abs_err=err,
        ms=event_ms(torch, lambda: DK.pack_cuda(*args), 50),
        plain_ms=event_ms(torch, lambda: DK.pack_plain(*args), 2),
        bnd=bound(nb, int((10 * (span + 2 * nmk)).sum())),
    )
    print(f"phase 3 K3: {k} chunks and an empty, an all-literal, a 258-byte dist-1 and a "
          f"15-bit lane equal to plain with 0 and {PL.SEEDS_PER_CHUNK} seeds", flush=True)

    # -- phase 4: the main path, end to end ------------------------------
    counters = {"adler32_batch": CK.launches, "hop_chase": DK.launches, "pack": DK.launches,
                "chain_scan": DK.launches, "tab_scan": DK.launches, "freq": DK.launches,
                "hop_chase_il": DK.launches, "vhuff_decode": VK.launches,
                "vhuff_expand": VK.launches, "vhuff_decode1": VK.launches,
                "vhuff_expand1": VK.launches, "inflate": IK.launches, "crc32_batch": CRC.launches}
    for c in counters.values():
        for name in c:
            c[name] = 0
    t0 = time.perf_counter()
    out = zt.compress_parallel(corpus, LEVEL)
    cold_s = time.perf_counter() - t0
    launches = {name: c[name] for name, c in counters.items()}
    if sum(launches.pop(n) for n in ("vhuff_decode", "vhuff_expand", "vhuff_decode1",
                                     "vhuff_expand1", "inflate", "crc32_batch")):
        raise AssertionError("the zlib encode path launched a decode or crc32 kernel")
    if sum(launches.pop(n) for n in ("chain_scan", "tab_scan", "freq", "hop_chase_il")):
        raise AssertionError("the level-6 hop route launched K8, K9, K10 or K12")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    if zlib.decompress(out) != corpus:
        raise AssertionError("the level-6 stream does not decode to the corpus")
    zref = len(zlib.compress(corpus, LEVEL))
    print(f"phase 4 e2e: {len(corpus)} -> {digest(out)}, ratio to zlib-{LEVEL} "
          f"{len(out) / zref:.6f} ({zref} bytes), cold {cold_s:.3f} s, launches "
          f"{launches}", flush=True)

    warm = warm_runs(torch, PL, lambda: zt.compress_parallel(corpus, LEVEL), out, len(corpus),
                     "warm", 4)

    idx_out, index = zt.compress_parallel(corpus, LEVEL, return_index=True)
    if zlib.decompress(idx_out) != corpus or len(index) != n_chunks:
        raise AssertionError("the indexed stream does not decode")
    pos = 0
    for off, ln, out_len in index[:4]:
        d = zlib.decompressobj(-15)
        if d.decompress(idx_out[off : off + ln]) != corpus[pos : pos + out_len]:
            raise AssertionError("an indexed chunk does not decode on its own")
        pos += out_len
    seeded = sum(s is not None for s in index.seeds)
    gz, gz_index = zt.compress_parallel(corpus, LEVEL, window_bits=31, return_index=True)
    if zlib.decompress(gz, 31) != corpus:
        raise AssertionError("the gzip stream does not decode")
    small = corpus[:100_000]
    on_card = zt.compress_parallel(small, LEVEL)
    on_cpu = zt.compress_parallel(small, LEVEL, device="cpu")
    if zlib.decompress(on_card) != small or zlib.decompress(on_cpu) != small:
        raise AssertionError("the 100 kB streams do not decode")
    print(f"phase 4 more: return_index {len(idx_out)} bytes, {seeded}/{len(index)} "
          f"chunks seeded; gzip {len(gz)} bytes; 100 kB card stream equal to the "
          f"CPU port's: {on_card == on_cpu}", flush=True)

    decode = decode_phases(torch, dev, corpus, idx_out, index, gz, gz_index, rows, launches)
    crc_phase(torch, dev, corpus, rows)
    gzip_encode = gzip_encode_phase(torch, corpus, launches)
    k6_decode = inflate_phases(torch, dev, corpus, idx_out, index, gz, gz_index, rows, launches)
    routes = encode_route_phases(torch, dev, corpus, (dc, dn, dv, dict_size), out, rows, launches)
    single = single_plane_phases(torch, dev, corpus, idx_out, index, gz, gz_index, rows, launches)
    hop_il = hop_il_phases(torch, dev, corpus, (dn, dict_size, words4, htab, cap_g), out, rows,
                           launches)
    xla = xla_phases(torch, dev, corpus, rows)
    lockstep = lockstep_phase(torch, dev, corpus, rows)
    foreign = foreign_phase(torch, corpus, rows)
    host_strategies = host_strategy_phase(corpus)
    cli = cli_phase(corpus)
    engine_names = engine_names_phase(torch, corpus, idx_out, index, gz, gz_index)
    host_layers = host_layers_phase(corpus)
    mesh = mesh_phase(torch, corpus, out, warm)
    speculative = speculative_phase(torch, dev, corpus, rows)
    exact = exact_deflate_phase(torch, dev, corpus, rows)
    native_routes = routes_phase(torch, corpus)
    streams = stream_phase(torch, dev, corpus, rows)
    medium_streams = medium_stream_phase(torch, dev, corpus, rows)
    bench = bench_phase(min(BENCH_BUDGET_S, SMOKE_LIMIT_S - (time.perf_counter() - t_main)))

    # the lockstep kernel's path: the region decode of the chunk K6 refused;
    # the swarm walker's: phase 30's swarm decode
    launches["lockstep"] = engine_names["flipped_128k"]["lockstep_launches"]
    launches["swarm_walk"] = rows["swarm_walk"].pop("launches")
    # the speculative kernels' path: phase 33's zran_index stage of the
    # zlib-6 stream (its three warm runs)
    launches.update(foreign["sp_launches_zlib6"])
    # EX's and the resolve's path: phase 41's level-6 deflate_parallel of
    # the corpus (the resolve also on phase 43's stream path); the dry
    # parse's: phase 41's level-1 deflate_parallel (and phase 43's)
    launches["exact_deflate"] = rows["exact_deflate"].pop("launches")
    launches["exact_resolve"] = rows["exact_resolve"].pop("launches")
    launches["exact_dry"] = rows["exact_dry"].pop("launches")
    if min(launches[k] for k in ("exact_deflate", "exact_resolve", "exact_dry")) < 1 or \
            rows["exact_resolve"]["level1_launches"] < 1:
        raise AssertionError("deflate_parallel never launched EX's chase, the resolve or the dry "
                             "parse")
    # IS's and DS's path: phase 43's stream objects and gzip file at full size
    launches["istream"] = rows["istream"].pop("launches")
    launches["dstream"] = rows["dstream"].pop("launches")
    kernels = []
    for name in ("adler32_batch", "hop_chase", "pack", "vhuff_decode", "vhuff_expand",
                 "inflate", "crc32_batch", "chain_scan", "freq", "tab_scan",
                 "vhuff_decode1", "vhuff_expand1", "hop_chase_il", "lockstep", "swarm_walk",
                 "block_find", "spec_decode", "spec_resolve", "exact_deflate", "exact_resolve",
                 "exact_dry", "istream", "dstream"):
        r = rows[name]
        b_ms, b_by = r.pop("bnd")
        kernels.append(dict(
            name=name, route="cuda", source=r["source"], replaces=r["replaces"],
            launches=launches[name], max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=b_ms, bound_by=b_by, library_ms=None,
            **{k: r[k] for k in ("plain_rows", "queued_ms", "at_128k", "foreign_launches",
                                 "inflate_parallel_launches", "medium_ms", "medium_plain_ms",
                                 "medium_bound_ms", "call_ms", "flush_ms", "emit_ms", "level9_ms",
                                 "candidates", "resolve_ms", "chase_ms", "level1_ms",
                                 "level9_resolve_ms", "level9_chase_ms", "stream_launches",
                                 "level2_ms", "level3_ms", "level1_chase_ms", "level1_resolve_ms",
                                 "rounds", "live_share", "level1_launches", "warp_ms",
                                 "head_ms", "sync_ms", "expand_ms", "spec_ms", "windows",
                                 "sync_rounds",
                                 "max_sync_rounds", "jump_rounds", "serial_finishes", "exact_ms",
                                 "exact_warp_ms", "old_ms", "survivors", "checked",
                                 "survivors_to_first_pass", "hops_max", "hops_mean", "device_ms",
                                 "old_device_ms", "pending")
                       if k in r},
        ))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"e2e": {
        "bytes_in": len(corpus), "bytes_out": len(out), "zlib_bytes": zref,
        "ratio_to_zlib": len(out) / zref, "cold_s": cold_s, **warm, "decode": decode,
        "gzip_encode": gzip_encode, "k6_decode": k6_decode, "encode_routes": routes,
        "single_plane_decode": single, "hop_il_encode": hop_il, "xla": xla,
        "lockstep": lockstep, "foreign_decode": foreign, "host_strategies": host_strategies,
        "cli": cli, "engine_names": engine_names, "host_layers": host_layers, "mesh": mesh,
        "speculative": speculative, "exact_deflate": exact, "routes": native_routes,
        "streams": streams, "medium_streams": medium_streams, "bench": bench,
    }}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
