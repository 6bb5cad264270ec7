"""A short call for the speculative decode's kernels on one H100
(csrc/speculative.cu): SP2 (`spec_sync`, a thread block a row, and
`spec_decode`, the one-warp launch it replaced), SP1 (`find_tiles` and
`find_first` against `find_prefilter` and `find_check`) and SP3
(`resolve_chase` and `resolve_tail` against the pointer jumping).

Prints the card's name and power limit; builds speculative.cu once with
`-Xptxas -v` and prints those kernels' registers, stack and spills;
then, on chip_smoke.py's 8 MiB corpus as raw deflate at level 6:
- SP1 and SP3 against their plain versions and their first designs and
  timed against them in turn (new, old, old, new: event ms, device ms by
  kernel, host wall, peak memory), with SP1's survivors (counted, checked,
  up to each segment's first pass) and SP3's hops (the longest, the mean), on
  the raw-6 chain and a 16 MiB long-chain stream (chip_smoke's
  `sp1_pairs`, `in_turn`, `sp3_case`); `inflate_speculative`'s warm walls;
- cuts the stream as `inflate_speculative` does (SP1 on every 32 KiB
  segment) and holds the block launch against the plain version on four
  rows and against the one-warp launch on every row (cells [0, n),
  records and status); the same on the stored, Z_FIXED and a flipped
  stream's crafted rows (chip_smoke.sp2_pairs);
- times the two launches over the segments' rows in turn (block, warp,
  warp, block) by CUDA events, and prints the block's counters;
- the exact row of the whole stream (`inflate_raw`'s launch), both
  launches, and `inflate_raw`'s warm wall, equal to the corpus;
- `inflate_raw` against `inflate_speculative` on raw-6 streams of 16 KiB
  to 1 MiB of the corpus, warm walls.
Its last line is OK or FAIL. `--times` keeps the build, SP1 and SP3, the
block launch against the one-warp launch on every segment row, the
timings and `inflate_raw`'s walls (to compare two trees in one call);
`--sp13` the build, SP1 and SP3 and `inflate_speculative`'s walls alone.

    python3 spec_probe.py            # one H100, about a minute of command time
    python3 spec_probe.py --times
    python3 spec_probe.py --sp13
"""

import json
import os
import subprocess
import sys
import time
import zlib

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402
from zlib_rs_tpu_torch import _device  # noqa: E402
from zlib_rs_tpu_torch.ops.kernels import speculative_kernel as SK  # noqa: E402
from zlib_rs_tpu_torch.parallel import speculative as SP  # noqa: E402


KERNELS = ("spec_sync", "spec_decode", "find_tiles", "find_first", "find_prefilter",
           "find_check", "resolve_chase", "resolve_tail")


def ptxas_lines() -> list:
    """speculative.cu's ptxas report for SP2's two kernels and SP1's and
    SP3's, both designs."""
    out = _device.BUILD / "spec_probe"
    out.mkdir(parents=True, exist_ok=True)
    res = subprocess.run([_device._nvcc(), *_device.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                          str(out / "libzrs_speculative.so"), str(_device.CSRC / "speculative.cu")],
                         capture_output=True, text=True, timeout=600, check=True)
    lines = res.stdout.splitlines() + res.stderr.splitlines()
    keep, name = [], None
    for ln in lines:
        if "Compiling entry function" in ln:
            name = next((k for k in KERNELS if k in ln), None)
        elif name and ("registers" in ln or "stack frame" in ln):
            keep.append(f"{name}: {ln.strip()}")
    return keep


def rows_of(torch, dev, stream: bytes, seg: int, max_out: int):
    """The first attempt's rows of `stream` as inflate_speculative cuts
    it, with the words on the card."""
    nbits = 8 * len(stream)
    words = torch.from_numpy(SK.stream_words(stream)).to(dev)
    T = len(stream) // seg
    bounds = [8 * k * seg for k in range(T)] + [nbits]
    starts = SK.block_find_cuda(words, nbits, bounds[1:T], bounds[2:]).tolist()
    cap = SP.segment_cap(seg, max_out)
    rows = [(0, bounds[1], cap, 0)] + [
        (s, bounds[k + 1], cap if s >= 0 else 0, SK.WSIZE) for k, s in enumerate(starts, 1)]
    return words, nbits, rows


def launches_agree(torch, words, nbits, rows) -> tuple[bool, dict]:
    """The block and the one-warp launch over `rows`: every status row,
    and each row's cells [0, n) and records [0, nrec), equal."""
    meta, nc, nr = SP.row_meta(rows, nbits)
    mt = torch.from_numpy(meta).to(words.device)
    a = SK.spec_decode_cuda(words, nbits, mt, nc, nr)
    b = SK.spec_decode_warp_cuda(words, nbits, mt, nc, nr)
    st = b[2].cpu()
    ok = bool(torch.equal(a[2].cpu(), st))
    for k in range(len(rows)):
        n, nrec = int(st[k, 0]), int(st[k, 5])
        c0, r0 = int(meta[k, 4]), int(meta[k, 5])
        ok = ok and torch.equal(a[0][c0 : c0 + n], b[0][c0 : c0 + n])
        ok = ok and torch.equal(a[1][r0 : r0 + nrec], b[1][r0 : r0 + nrec])
    whys = {}
    for w in st[:, 3].tolist():
        whys[w] = whys.get(w, 0) + 1
    return ok, whys


def timed_pair(torch, words, nbits, rows, reps: int) -> dict:
    """Event ms of the block and the one-warp launch over `rows`, in turn
    (block, warp, warp, block), and the block's counters."""
    meta, nc, nr = SP.row_meta(rows, nbits)
    mt = torch.from_numpy(meta).to(words.device)
    fns = {"block": lambda: SK.spec_decode_cuda(words, nbits, mt, nc, nr),
           "warp": lambda: SK.spec_decode_warp_cuda(words, nbits, mt, nc, nr)}
    ms = {"block": [], "warp": []}
    for who in ("block", "warp", "warp", "block"):
        ms[who].append(CS.event_ms(torch, fns[who], reps))
    stats = {}
    SK.spec_decode_cuda(words, nbits, mt, nc, nr, stats=stats)
    return {"ms": ms, "stats": stats}


def sp1_sp3(torch, dev, corpus: bytes, streams: dict) -> tuple[bool, dict]:
    """SP1 and SP3, the route's launches against their first designs
    (chip_smoke.py phase 40's comparisons, `sp1_case` and `sp3_case`):
    SP1 on every segment of the raw-6 stream, a retry round's ranges and
    8 segments each of the stored and Z_FIXED streams against the plain
    version and the first design, and with rooms of 1 and 0 survivors a
    tile; SP3 on the raw-6 chain and a long-chain stream against the plain
    version, the first design and the input; each timed in turn with its
    counters."""
    raw = streams["raw6"]
    sp1 = CS.sp1_case(torch, SK, dev, streams, SP.SEGMENT_BYTES)
    upto = sp1.pop("upto")
    sp1.update(survivors_to_first_pass=sum(upto), max_to_first_pass=max(upto),
               found=sum(b >= 0 for b in sp1["found"]))
    sp3 = CS.sp3_case(torch, SK, SP, dev, raw, corpus, 4 * len(corpus))
    chains = CS.long_chain_corpus(np, corpus)
    sp3_long = CS.sp3_case(torch, SK, SP, dev, CS._raw(chains), chains, 4 * len(chains))
    return sp1["max_abs_err"] == 0, {"sp1": sp1, "sp3": sp3, "sp3_long_chains": sp3_long}


def main() -> int:
    times_only = "--times" in sys.argv[1:]
    sp_only = "--sp13" in sys.argv[1:]
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        return 1
    dev = torch.device("cuda")
    print(CS.nvidia_smi(), flush=True)
    t0 = time.perf_counter()
    for ln in [] if times_only else ptxas_lines():
        print("ptxas " + ln, flush=True)
    print(f"build: {_device.build():.1f} s (ptxas report {time.perf_counter() - t0:.1f} s)",
          flush=True)
    corpus, _names = CS.load_corpus()
    streams = CS.speculative_streams(corpus)
    raw = streams["raw6"]
    ok, res = sp1_sp3(torch, dev, corpus, streams)
    print("SP1 and SP3: " + json.dumps(res), flush=True)
    walls = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, _used = SP.inflate_speculative(raw, 4 * len(corpus))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    ok = ok and out == corpus
    print(f"inflate_speculative of raw-6: warm s {walls[1:]} (cold {walls[0]:.4f}), "
          f"{len(corpus) / min(walls[1:]) / 1e6:.1f} MB/s", flush=True)
    if sp_only:
        print("OK" if ok else "FAIL", flush=True)
        return 0 if ok else 1

    # -- the segments' rows: block against plain and the one-warp launch --
    seg = SP.SEGMENT_BYTES
    words, nbits, rows = rows_of(torch, dev, raw, seg, 4 * len(corpus))
    T = len(rows)
    pairs, whys = CS.sp2_pairs(torch, SK, SP, dev, raw, rows, [] if times_only else
                               [0, 1, T // 2, T - 1])
    err = CS.max_abs(pairs)
    same, _w = launches_agree(torch, words, nbits, rows)
    print(f"segments: {T} rows of the {len(raw)}-byte raw-6 stream, block against plain max "
          f"abs err {err} (whys {whys}), block equal to the one-warp launch on every row: "
          f"{same}", flush=True)
    ok = ok and err == 0 and same
    for name, stream, extra in () if times_only else (
        ("stored", streams["stored"], []),
        ("fixed", streams["fixed"], []),
        ("flipped", CS._flip(raw, len(raw) // 3), [(8 * (len(raw) // 3 - 20), nbits, 1 << 20, 0)]),
    ):
        n2 = 8 * len(stream)
        w2 = torch.from_numpy(SK.stream_words(stream)).to(dev)
        g2 = SK.block_find_cuda(w2, n2, [8 * seg, 16 * seg], [16 * seg, 24 * seg]).tolist()
        cap = SP.segment_cap(seg, 4 * len(corpus))
        r2 = [(0, 8 * seg, cap, 0), (g2[0], 16 * seg, cap if g2[0] >= 0 else 0, SK.WSIZE),
              (g2[1], 24 * seg, 16 if g2[1] >= 0 else 0, SK.WSIZE), (-1, n2, 0, SK.WSIZE)] + extra
        p2, w = CS.sp2_pairs(torch, SK, SP, dev, stream, r2, list(range(len(r2))))
        e2 = CS.max_abs(p2)
        s2, _w = launches_agree(torch, w2, n2, r2)
        print(f"crafted {name}: max abs err {e2}, whys {w}, equal to the one-warp launch: {s2}",
              flush=True)
        ok = ok and e2 == 0 and s2

    # -- the two launches over the segments, in turn ---------------------
    res = timed_pair(torch, words, nbits, rows, 3)
    print("segments timed: " + json.dumps(res), flush=True)

    # -- the exact row of the whole stream --------------------------------
    exact = [(0, nbits + 1, 4 * len(corpus), 0)]
    same, whys = launches_agree(torch, words, nbits, exact)
    res = timed_pair(torch, words, nbits, exact, 1)
    print(f"exact row: equal to the one-warp launch {same} (whys {whys}); " + json.dumps(res),
          flush=True)
    ok = ok and same
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, used = SP.inflate_raw(raw, 4 * len(corpus))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    ok = ok and out == corpus and used == len(raw)
    print(f"inflate_raw of raw-6: {len(corpus)} bytes, warm s {walls}, "
          f"{len(corpus) / min(walls[1:]) / 1e9:.4f} GB/s, equal to the corpus: {out == corpus}",
          flush=True)

    # -- inflate_raw against inflate_speculative, 16 KiB to 1 MiB ---------
    sweep = {}
    for size in () if times_only else (1 << 14, 1 << 16, 1 << 18, 1 << 20):
        piece = corpus[:size]
        r = zlib.compressobj(6, zlib.DEFLATED, -15)
        rs = r.compress(piece) + r.flush()
        got = {}
        for name, fn in (("inflate_raw", SP.inflate_raw), ("inflate_speculative",
                                                           SP.inflate_speculative)):
            fn(rs, 4 * size)
            w = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out, _u = fn(rs, 4 * size)
                torch.cuda.synchronize()
                w.append(time.perf_counter() - t0)
            ok = ok and out == piece
            got[name] = w
        sweep[size] = got
    print("raw vs speculative, warm s: " + json.dumps(sweep), flush=True)
    print("OK" if ok else "FAIL", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
