#!/usr/bin/env python3
"""EX and DS at zlib levels 1-3 (or MEDIUM4-6) on one H100, for one tree of the port.

    python3 ex_fast_probe.py [--tree DIR] [--check] [--levels 1,2,3] [--rounds main,1,2,3]
                             [--copies 16] [--input corpus|runs] [--reps 3] [--out FILE]

Imports `zlib_rs_tpu_torch` from DIR (default: this script's directory),
so that one call can measure two commits in turn: unpack the other
commit with `git archive` into a directory that .gitignore lists and run
this script once with `--tree` that directory, once without, alternating.
Every reading is taken on chip_smoke.py's 8 MiB corpus and must give
stdlib zlib's bytes:

- EX's call on 64 chunks of 128 KiB primed with 32 KiB, at levels 1, 2
  and 3, ms by CUDA events (a mean of --reps after a warm-up);
- `deflate_parallel` of the corpus at 1-3, MB/s (median of 3 warm walls);
- the one-shot `compress` of 1 MiB at 1-3, seconds (median of 3);
- one 128 KiB NO_FLUSH DS pump at 1 and 3 after a first one, ms by CUDA
  events around `Handle.pump` of a copy of the saved handle (the host's
  staging included), its bytes equal to `DS.Plain`'s;
- with --input runs, the same readings on a run-heavy 8 MiB in place of
  the corpus (`runs_input`: runs of one byte, 300 to 3,299 long, between
  500-byte pieces of the corpus), where MEDIUM4/5's 257-258 matches leave
  their interiors out of the chains;
- with --levels 11,12,13 (MEDIUM4-6, whose bytes are native's, not
  zlib's) the same readings at those levels: every chunk and
  `deflate_parallel` decoded by zlib, the first 4 chunks equal to the plain
  version's, and a digest of all the chunks' bytes a level (the parent's
  one-warp run_medium gives native's bytes, so equal digests in one call
  hold the change to them); `native.deflate_chunk` of 1 MiB in place of
  the one-shot compress; the DS pump at MEDIUM5 (12); and
  `native.RawDeflateStream` over 1 MiB in 128 KiB NO_FLUSH pumps and a
  FINISH at each level, MB/s of input by the host clock (median of 3),
  decoded by zlib;
- with --copies K (K > 1), the corpus repeated K times (64 K chunks of
  128 KiB): EX's call at 1-3 and 6 by CUDA events and `deflate_parallel`
  (MB/s, median of 3), every chunk equal to zlib's; the call's split
  where the tree takes the chunks in one round.

A tree whose EX takes an assumed skip map at the levels (`EK.greedy_level`;
at MEDIUM `EK.mapped_level`) is measured at each round count of --rounds
("main": its own EK.ROUNDS, a number: that many at every level): the call
and the pump as above, and the call's split by CUDA events
(chip_smoke.ex_split_greedy: the resolve a round, the dry parse, the
chase) with the chase's loop tops and live walks. --check instead
compiles csrc/exact_deflate.cu with `-Xptxas -v`, prints its kernels'
registers, stack and spills, holds the resolve and the dry parse at the
levels against their plain versions on 4 rows of 16 KiB, EX against
zlib (MEDIUM: the plain version) on 8 chunks and DS at two of the levels
against `DS.Plain` on a pump script, and stops.

Prints a line a reading, the card's name and power limit, and last one
JSON object (its "tree": "change" for this script's tree, else the
tree's directory name), also written to FILE when --out names one.
Exits 2 without a GPU.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
import time
import zlib
from pathlib import Path

HERE = Path(__file__).resolve().parent
CHUNK = 128 * 1024
PUMP = 128 * 1024
MEDIUM = (11, 12, 13)  # native's MEDIUM4-6


def zraw(data: bytes, level: int, final: bool, window: bytes) -> bytes:
    kw = {"zdict": window} if window else {}
    c = zlib.compressobj(level, zlib.DEFLATED, -15, 8, 0, **kw)
    return c.compress(data) + c.flush(zlib.Z_FINISH if final else zlib.Z_SYNC_FLUSH)


def runs_input(corpus: bytes, size: int = 8 << 20) -> bytes:
    """A run-heavy input of `size` bytes: runs of one byte (300 to 3,299
    long) between 500-byte pieces of the corpus."""
    out, k = bytearray(), 0
    while len(out) < size:
        out += bytes([(k * 37) % 256]) * (300 + (k * 7919) % 3000)
        out += corpus[(k * 1000) % (len(corpus) - 500) :][:500]
        k += 1
    return bytes(out[:size])


def unprime(part: bytes, window: bytes) -> bytes:
    """A chunk's raw deflate decoded with its window as the dictionary."""
    d = zlib.decompressobj(-15, zdict=window) if window else zlib.decompressobj(-15)
    return d.decompress(part)


def smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()


def ptxas_report(tree: Path) -> list:
    """nvcc -Xptxas -v of the tree's exact_deflate.cu: a line a kernel."""
    from zlib_rs_tpu_torch import _device

    out = tree / "build" / "ex_fast_probe"
    out.mkdir(parents=True, exist_ok=True)
    res = subprocess.run([_device._nvcc(), *_device.NVCC_FLAGS, "-Xptxas", "-v",
                          str(_device.CSRC / "exact_deflate.cu"), "-o",
                          str(out / "libprobe.so")], capture_output=True, text=True, timeout=900)
    if res.returncode:
        raise RuntimeError(res.stderr[-4000:])
    lines, fn = [], None
    for ln in res.stderr.splitlines():
        if "Compiling entry function" in ln:
            fn = ln.split("'")[1] if "'" in ln else ln
        elif fn and ("registers" in ln or "stack frame" in ln):
            lines.append(f"{fn}: {ln.strip()}")
    return lines


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(HERE))
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--levels", default="1,2,3")
    ap.add_argument("--rounds", default="main")
    ap.add_argument("--copies", type=int, default=1)
    ap.add_argument("--input", default="corpus", choices=("corpus", "runs"))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ex_fast_probe: no CUDA device", file=sys.stderr)
        return 2
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(HERE))
    from chip_smoke import ex_split, ex_split_greedy, load_corpus  # this tree's, whichever runs

    sys.path[0] = str(tree)
    from zlib_rs_tpu_torch import _device
    from zlib_rs_tpu_torch.models import oneshot
    from zlib_rs_tpu_torch.ops.kernels import dstream_kernel as DS
    from zlib_rs_tpu_torch.ops.kernels import exact_deflate_kernel as EK
    from zlib_rs_tpu_torch.parallel import chunk_deflate as CD

    card = smi()
    tag = "change" if tree == HERE else tree.name
    print(f"card: {card}; tree {tree} ({tag}); torch {torch.__version__}", flush=True)
    dev = torch.device("cuda")
    levels = [int(x) for x in args.levels.split(",")]
    medium = all(lv in MEDIUM for lv in levels)
    if not medium and any(lv in MEDIUM or not 1 <= lv <= 3 for lv in levels):
        raise SystemExit("ex_fast_probe: --levels takes levels of 1-3, or of 11-13")
    greedy = hasattr(EK, "mapped_level" if medium else "greedy_level")
    result = {"tree": tag, "card": card, "greedy": greedy, "levels": levels}
    t0 = time.perf_counter()
    if args.check:
        result["ptxas"] = ptxas_report(tree)
        for ln in result["ptxas"]:
            print(ln, flush=True)
    _device.build()
    _device.library("exact_deflate")
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    corpus, _members = load_corpus()
    if args.input == "runs":
        corpus = runs_input(corpus)
    result["input"] = args.input
    n = len(corpus)
    data_t = torch.from_numpy(np.frombuffer(corpus, np.uint8).copy()).to(dev)
    starts = list(range(0, n, CHUNK))

    def meta_of(rows, level):
        return torch.from_numpy(CD.chunk_meta(rows, level)).to(dev)

    def parts_of(res, meta):
        return [res[0][o : o + m].cpu().numpy().tobytes()
                for o, m in zip(meta[:, 4].tolist(), res[1].tolist())]

    def ev_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / reps

    def resolve_parts(data, meta, lv):
        """The resolve's two launches apart over one round of meta's chunks
        (no position skipped): the chain build's ms and the walks' ms."""
        rs = meta.cpu().tolist()
        [(_n, [(pieces, nd, ns, cb, wb)])] = EK.plan(rs, level=lv) if lv in MEDIUM else \
            EK.plan(rs)
        pt = torch.from_numpy(pieces).to(dev)
        deltas = torch.empty(nd, dtype=torch.int16, device=dev)
        slots = torch.empty(ns, 2, dtype=torch.int32, device=dev)
        kw = {}
        if lv <= 3 or lv in MEDIUM:
            stride = max(EK.bit_words(int(m[1] + m[2])) for m in meta.tolist())
            kw = {"bits": torch.zeros(len(pieces) * stride, dtype=torch.int32, device=dev),
                  "bit_stride": stride}
        saved = dict(EK.launches)
        chains = ev_ms(lambda: EK.resolve_cuda(data, pt, lv, deltas, slots, cb, 0, **kw),
                       args.reps)
        walks = ev_ms(lambda: EK.resolve_cuda(data, pt, lv, deltas, slots, 0, wb, **kw),
                      args.reps)
        EK.launches.update(saved)
        return {"chains_ms": chains, "walks_ms": walks}

    if args.check:
        return check(torch, np, EK, DS, CD, dev, corpus, data_t, meta_of, parts_of, result, tag,
                     levels)

    rows = [(lo, min(n, lo + CHUNK) - lo, min(32768, lo), int(lo + CHUNK >= n)) for lo in starts]
    if medium:
        # native's bytes: the first 4 chunks by the plain version; the rest
        # decoded by zlib and digested (the parent's give native's digest)
        want = {lv: [EK.plain_chunk(corpus[lo : lo + ln], lv, bool(fin), corpus[lo - dl : lo])
                     for lo, ln, dl, fin in rows[:4]] for lv in levels}
    else:
        want = {lv: [zraw(corpus[lo : lo + ln], lv, bool(fin), corpus[lo - dl : lo])
                     for lo, ln, dl, fin in rows] for lv in levels}
    pump_levels = [12] if medium else [lv for lv in (1, 3) if lv in levels]
    pump_want = {}
    for lv in pump_levels:
        p = DS.Plain(lv)
        p.pump(corpus[:PUMP], 0)
        pump_want[lv] = p.pump(corpus[PUMP : 2 * PUMP], 0)

    def stream_mb_s(lv, mib):
        """native.RawDeflateStream over `mib` in PUMP NO_FLUSH pumps and a
        FINISH: MB/s of input, a median of 3, the stream decoded by zlib."""
        from zlib_rs_tpu_torch import native

        mbs = []
        for _ in range(3):
            s = native.RawDeflateStream(lv)
            got = bytearray()
            torch.cuda.synchronize()
            t = time.perf_counter()
            for i in range(0, len(mib), PUMP):
                got += s.pump(mib[i : i + PUMP], 0)
            got += s.pump(b"", 4)
            mbs.append(len(mib) / (time.perf_counter() - t) / 1e6)
            if zlib.decompress(bytes(got), -15) != mib:
                raise AssertionError(f"RawDeflateStream at {lv} does not decode")
        return statistics.median(mbs)

    def held(label, lv, parts, whole):
        """The chunks' bytes against `want` (MEDIUM: its first 4, every
        chunk decoded by zlib); deflate_parallel's stream against the
        chunks'; the chunks' digest."""
        if parts[: len(want[lv])] != want[lv]:
            raise AssertionError(f"{label}: EX level {lv} is not the reference's")
        if medium:
            for (lo, ln, dl, _fin), part in zip(rows, parts):
                if unprime(part, corpus[lo - dl : lo]) != corpus[lo : lo + ln]:
                    raise AssertionError(f"{label}: EX level {lv} chunk at {lo} does not decode")
        if whole is not None and whole != b"".join(parts):
            raise AssertionError(f"{label}: deflate_parallel level {lv} is not EX's chunks")
        return hashlib.sha1(b"".join(parts)).hexdigest()

    def measure(label):
        out = {}
        for lv in levels:
            meta = meta_of(rows, lv)
            got = parts_of(EK.exact_deflate_cuda(data_t, meta, lv), meta)
            digest = held(label, lv, got, None)
            ms = ev_ms(lambda: EK.exact_deflate_cuda(data_t, meta, lv), args.reps)
            walls = []
            for _ in range(3):
                t = time.perf_counter()
                dp = CD.deflate_parallel(corpus, lv)
                walls.append(time.perf_counter() - t)
            held(label, lv, got, dp)
            mib = corpus[: 1 << 20]
            os_s = []
            for _ in range(3):
                t = time.perf_counter()
                got1 = CD.deflate_chunk(mib, lv) if medium else oneshot.compress(mib, lv)
                os_s.append(time.perf_counter() - t)
            if (zlib.decompress(got1, -15) if medium else got1) != \
                    (mib if medium else zlib.compress(mib, lv)):
                raise AssertionError(f"{label}: the one-shot compress at {lv} is not the "
                                     f"reference's")
            out[lv] = {"ex_call_ms": ms, "deflate_parallel_mb_s": n / statistics.median(walls) / 1e6,
                       "oneshot_1mib_s": statistics.median(os_s), "digest": digest}
            if medium:
                out[lv]["stream_mb_s"] = stream_mb_s(lv, mib)
        for lv in pump_levels:
            h = DS.Handle(lv, dev)
            h.pump(corpus[:PUMP], 0)
            spans = []
            for rep in range(args.reps + 1):
                c = h.copy()
                torch.cuda.synchronize()
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
                got = c.pump(corpus[PUMP : 2 * PUMP], 0)
                e1.record()
                torch.cuda.synchronize()
                if got != pump_want[lv]:
                    raise AssertionError(f"{label}: the DS pump at {lv} is not plain's")
                if rep:
                    spans.append(e0.elapsed_time(e1))
            out[lv]["ds_pump_ms"] = statistics.mean(spans)
        for lv, r in out.items():
            print(f"{label} level {lv}: " + ", ".join(
                f"{k} {v:.6f}" if isinstance(v, float) else f"{k} {v}" for k, v in r.items()),
                flush=True)
        return out

    def dp_parts(buf, rs, lv):
        """deflate_parallel's wall in its three steps (chunk_deflate._run's),
        by the host clock with a synchronize after each, a median of 3: the
        copy to the card, EX, the join and the copy back."""
        steps = {"h2d_s": [], "ex_s": [], "join_s": []}
        for _ in range(3):
            t = time.perf_counter()
            d = torch.from_numpy(np.frombuffer(buf, np.uint8).copy()).to(dev)
            m = torch.from_numpy(CD.chunk_meta(rs, lv)).to(dev)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            o, ln, _st = EK.exact_deflate(d, m, lv)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            total = int(ln.sum())
            dst = torch.cumsum(ln, 0) - ln
            shift = torch.repeat_interleave(m[:, 4] - dst, ln, output_size=total)
            o[shift + torch.arange(total, dtype=torch.int64, device=dev)].cpu().numpy().tobytes()
            t3 = time.perf_counter()
            for key, v in zip(steps, (t1 - t, t2 - t1, t3 - t2)):
                steps[key].append(v)
        return {key: statistics.median(v) for key, v in steps.items()}

    def measure_many(label, k):
        big = corpus * k
        big_t = torch.from_numpy(np.frombuffer(big, np.uint8).copy()).to(dev)
        nb = len(big)
        brows = [(lo, min(nb, lo + CHUNK) - lo, min(32768, lo), int(lo + CHUNK >= nb))
                 for lo in range(0, nb, CHUNK)]
        out = {}
        for lv in levels if medium else (1, 2, 3, 6):
            meta = meta_of(brows, lv)
            got = parts_of(EK.exact_deflate_cuda(big_t, meta, lv), meta)
            if medium:  # every chunk decoded, the digest held across trees
                for (lo, ln, dl, _fin), part in zip(brows, got):
                    if unprime(part, big[lo - dl : lo]) != big[lo : lo + ln]:
                        raise AssertionError(f"{label}: EX level {lv} chunk at {lo} does not "
                                             f"decode")
                bwant = got
            else:
                bwant = [zraw(big[lo : lo + ln], lv, bool(fin), big[lo - dl : lo])
                         for lo, ln, dl, fin in brows]
            if got != bwant:
                raise AssertionError(f"{label}: EX level {lv} on {len(brows)} chunks is not zlib's")
            ms = ev_ms(lambda: EK.exact_deflate_cuda(big_t, meta, lv), args.reps)
            walls = []
            for _ in range(3):
                t = time.perf_counter()
                dp = CD.deflate_parallel(big, lv)
                walls.append(time.perf_counter() - t)
            if dp != b"".join(bwant):
                raise AssertionError(f"{label}: deflate_parallel level {lv} of {nb} bytes is "
                                     f"not zlib's")
            out[lv] = {"chunks": len(brows), "ex_call_ms": ms,
                       "deflate_parallel_mb_s": nb / statistics.median(walls) / 1e6,
                       "digest": hashlib.sha1(b"".join(got)).hexdigest(),
                       **dp_parts(big, brows, lv)}
            if greedy and len(EK.plan(meta.cpu().tolist())) == 1:
                if lv <= 3 or lv in MEDIUM:
                    s = ex_split_greedy(torch, EK, dev, big_t, meta, lv, args.reps)
                    keys = ("resolve_ms", "dry_ms", "chase_ms", "flush_ms", "live_share")
                else:
                    s = ex_split(torch, EK, dev, big_t, meta, lv, args.reps)
                    keys = ("resolve_ms", "chase_ms", "flush_ms")
                out[lv].update({k: s[k] for k in keys})
                out[lv].update(resolve_parts(big_t, meta, lv))
            print(f"{label} x{k} level {lv}: " + ", ".join(f"{a} {b}" for a, b in out[lv].items()),
                  flush=True)
        return out

    if args.copies > 1:
        result["copies"] = {args.copies: measure_many(tag, args.copies)}
    if not greedy:
        result["levels"] = measure(tag)
    else:
        result["rounds"] = {}
        main_rounds = dict(EK.ROUNDS)
        for rounds in args.rounds.split(","):
            EK.ROUNDS = main_rounds if rounds == "main" else \
                {**main_rounds, **dict.fromkeys(levels, int(rounds))}
            r = measure(f"{tag} ROUNDS {rounds}")
            for lv in levels:
                r[lv]["split"] = ex_split_greedy(torch, EK, dev, data_t, meta_of(rows, lv), lv,
                                                 args.reps)
                r[lv]["split"].update(resolve_parts(data_t, meta_of(rows, lv), lv))
                s = r[lv]["split"]
                print(f"{tag} ROUNDS {rounds} level {lv} split ({s['rounds']} rounds, long "
                      f"matches {s.get('long_share')}): resolve "
                      f"{s['resolve_ms']:.3f} ms a round, dry "
                      f"{s['dry_ms']:.3f} ms, chase {s['chase_ms']:.3f} ms; live walks "
                      f"{s['lives']} / loop tops {s['tops']} ({s['live_share']:.4f}); the "
                      f"resolve's chains {s['chains_ms']:.3f} ms, walks {s['walks_ms']:.3f} ms",
                      flush=True)
            result["rounds"][rounds] = r
    print(card)
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


def check(torch, np, EK, DS, CD, dev, corpus, data_t, meta_of, parts_of, result, tag,
          levels) -> int:
    """--check: the plain resolve and dry parse, EX's bytes and DS's pumps
    at the levels on a short run."""
    import random

    n = len(corpus)
    errs = {}
    for lv in levels:
        medium = EK.is_medium(lv)
        base = (3 + 2 * (lv % 10)) * 65_536
        rs = meta_of([(base + k * 32768, 16384, 32768 if k & 1 else 0, k >> 1) for k in range(4)],
                     lv).tolist()
        pieces, nd, ns, cb, wb = EK.with_offsets([EK.ex_piece(m, m[2], k, k, EK.PIECE, medium)
                                                  for k, m in enumerate(rs)], medium)
        pt = torch.from_numpy(pieces).to(dev)
        stride = EK.bit_words(16384 + 32768)
        rng = np.random.default_rng(lv)
        words = (rng.integers(0, 1 << 32, 4 * stride, dtype=np.uint64)
                 & rng.integers(0, 1 << 32, 4 * stride, dtype=np.uint64)).astype(np.uint32)
        recs = torch.zeros(4 * EK.REC, dtype=torch.int64, device=dev)
        more = {"recs": recs, "data": data_t} if medium else {}
        for label, m in (("zeros", np.zeros_like(words)), ("random", words)):
            bits = torch.from_numpy(m.view(np.int32).copy()).to(dev)
            deltas = torch.empty(nd, dtype=torch.int16, device=dev)
            slots = torch.empty(ns, 2, dtype=torch.int32, device=dev)
            EK.resolve_cuda(data_t, pt, lv, deltas, slots, cb, wb, bits=bits, bit_stride=stride)
            wd, ws = EK.resolve_plain(data_t, pt, lv, bits=bits, bit_stride=stride)
            e_res = int((EK.unsigned(deltas) - EK.unsigned(wd)).abs().max()) + \
                int((slots.long() - ws.long()).abs().max())
            EK.dry_cuda(pt, lv, slots, bits, stride, **more)
            plain = m.copy()
            EK.dry_plain(pieces, lv, slots.cpu().numpy().astype(np.int64), plain, stride,
                         recs.cpu().numpy() if medium else None, corpus if medium else None)
            e_dry = int(np.abs(bits.cpu().numpy().view(np.uint32).astype(np.int64)
                               - plain.astype(np.int64)).max())
            errs[f"resolve {lv} {label}"] = e_res
            errs[f"dry {lv} {label}"] = e_dry
            print(f"{tag} check level {lv} map {label}: resolve max abs err {e_res}, dry parse "
                  f"max abs err {e_dry}", flush=True)
        rows = [(lo, CHUNK, min(32768, lo), 0) for lo in range(0, 8 * CHUNK, CHUNK)]
        meta = meta_of(rows, lv)
        got = parts_of(EK.exact_deflate_cuda(data_t, meta, lv), meta)
        ref = EK.plain_chunk if medium else zraw
        ok = got == [ref(corpus[lo : lo + ln], lv, False, corpus[lo - dl : lo])
                     for lo, ln, dl, _f in rows]
        errs[f"ex {lv}"] = 0 if ok else 1
        print(f"{tag} check level {lv}: EX on 8 chunks of 128 KiB {'equal' if ok else 'NOT equal'} "
              f"to the reference; launches {EK.launches}", flush=True)
    data = corpus[n // 3 :][: 1 << 16]
    for lv in (levels[0], levels[-1]):
        rng = random.Random(lv)
        script, pos = [(data[i : i + 1], 0) for i in range(2000)], 2000
        while pos < len(data):
            k = rng.choice((1, 100, 3000, 20_000))
            script.append((data[pos : pos + k], rng.choice((0, 0, 2, 3))))
            pos += k
        script.append((b"", 4))
        h, p = DS.Handle(lv, dev), DS.Plain(lv)
        bad = sum(h.pump(c, f) != p.pump(c, f) for c, f in script)
        errs[f"ds {lv}"] = bad
        print(f"{tag} check DS level {lv}: {len(script)} pumps, {bad} differ from plain",
              flush=True)
    result["check"] = errs
    ok = not any(errs.values())
    print(json.dumps(result))
    print("OK" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
