#!/usr/bin/env python3
"""Where MEDIUM's chase spends its time on one H100: variants of
csrc/exact_deflate.cu, each with one part of run_medium_slots taken out.

    python3 ex_variant_probe.py [--levels 12,13] [--reps 3]

Builds this tree's exact_deflate.cu and one copy a variant (the source
patched as text, nvcc in parallel under build/ex_variants/), resolves
chip_smoke.py's corpus in 64 chunks of 128 KiB at each level with the
tree's own library, then times each variant's `zrs_exact_chase` on the
same slots by CUDA events (a mean of --reps after a warm-up; the map and
the records restored before each), with flush_block's clock64 share of the
slowest warp. The variants' bytes are not the chase's (a part is gone):
only their times are read, against the whole chase ("base"):

- nofizzle: no med_fizzle at the lookahead (the parse changes a little);
- noemit: no symbol stored and no flush_block (nor the literal bytes' loads);
- noflush: the symbols stored, flush_block not called (the buffer reused);
- noliteral: a literal stores 0, its byte not loaded;
- nocheck: every slot taken, no disagreement looked up;
- nodecide: no decision marked into the map (the frontier still moves).

Prints a line a variant and level, and the card's name and power limit.
Exits 2 without a GPU.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import ctypes
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
CHUNK = 128 * 1024


def patch(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise SystemExit(f"ex_variant_probe: the source no longer holds {old!r}")
    return src.replace(old, new)


def variants(src: str) -> dict:
    lit = "syms[n++] = Sym{0, ldb(b + cur.strstart + i)};"
    return {
        "base": src,
        "nofizzle": patch(src, "            med_fizzle(cur, nm);\n", ""),
        "noemit": patch(patch(src, "      if (!dry) {\n        if (cur.length < WANT_MIN) {",
                              "      if (false) {\n        if (cur.length < WANT_MIN) {"),
                        "      if (!dry && n >= SYM_END - 4) {", "      if (false) {"),
        "noflush": patch(src, "        ns = n;\n        flush_block(false, sp);\n        n = ns;\n",
                         "        n = 0;\n"),
        "noliteral": patch(src, lit, "syms[n++] = Sym{0, 0};"),
        "nocheck": patch(src, "    if (dry) return slot.full;\n    const long long reach",
                         "    if (true) return slot.full;\n    const long long reach"),
        "nodecide": patch(src, "    if (e <= F) return -1;\n    const long long h = clean",
                          "    if (true) {\n      F = e > F ? e : F;\n      return -1;\n    }\n"
                          "    const long long h = clean"),
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--levels", default="12,13")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ex_variant_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    from chip_smoke import load_corpus
    from zlib_rs_tpu_torch import _device
    from zlib_rs_tpu_torch.ops.kernels import exact_deflate_kernel as EK
    from zlib_rs_tpu_torch.parallel import chunk_deflate as CD

    out = HERE / "build" / "ex_variants"
    out.mkdir(parents=True, exist_ok=True)
    srcs = variants((_device.CSRC / "exact_deflate.cu").read_text())

    def build(name):
        cu, so = out / f"{name}.cu", out / f"lib{name}.so"
        cu.write_text(srcs[name])
        subprocess.run([_device._nvcc(), *_device.NVCC_FLAGS, "-o", str(so), str(cu)], check=True,
                       capture_output=True, timeout=900)
        return name, ctypes.CDLL(str(so))

    _device.build()
    with cf.ThreadPoolExecutor(len(srcs)) as ex:
        libs = dict(ex.map(build, list(srcs)))
    dev = torch.device("cuda")
    corpus, _members = load_corpus()
    n = len(corpus)
    data_t = torch.from_numpy(np.frombuffer(corpus, np.uint8).copy()).to(dev)
    p = _device.ptr
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for level in (int(x) for x in args.levels.split(",")):
        rows = [(lo, min(n, lo + CHUNK) - lo, min(32768, lo), int(lo + CHUNK >= n))
                for lo in range(0, n, CHUNK)]
        meta = torch.from_numpy(CD.chunk_meta(rows, level)).to(dev)
        rs = meta.cpu().tolist()
        [(nch, [(pieces, nd, ns, cb, wb)])] = EK.plan(rs, level=level)
        pt = torch.from_numpy(pieces).to(dev)
        stride = max(EK.bit_words(int(m[1]) + int(m[2])) for m in rs)
        first = torch.from_numpy(EK.medium_map(rs, stride).view(np.int32)).to(dev)
        bits = first.clone()
        deltas = torch.empty(nd, dtype=torch.int16, device=dev)
        dlist = torch.empty_like(deltas)
        slots = torch.empty(ns, 2, dtype=torch.int32, device=dev)
        EK.resolve_cuda(data_t, pt, level, deltas, slots, cb, wb, bits=bits, bit_stride=stride)
        outb = torch.empty(EK.out_bytes(meta), dtype=torch.uint8, device=dev)
        lens = torch.zeros(nch, dtype=torch.int64, device=dev)
        st = torch.zeros(nch, dtype=torch.int32, device=dev)
        recs = torch.zeros(nch * EK.REC, dtype=torch.int64, device=dev)
        scratch = torch.empty(nch * EK.WORK_BYTES, dtype=torch.uint8, device=dev)
        clk = torch.zeros(nch, 3, dtype=torch.int64, device=dev)
        for name, lib in libs.items():
            fn = lib.zrs_exact_chase
            fn.argtypes = [P, P, P, I, I, P, P, P, P, P, L, P, P, P, P, L, P, P, P]
            fn.restype = ctypes.c_int
            ms = 0.0
            for rep in range(args.reps + 1):
                bits.copy_(first)
                recs.zero_()
                torch.cuda.synchronize()
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
                rc = fn(p(data_t), p(meta), p(pt), pt.shape[0], level, p(outb), p(lens), p(st),
                        p(recs), p(scratch), EK.WORK_BYTES, p(slots), p(deltas), p(dlist), p(bits),
                        stride, p(clk), None, torch.cuda.current_stream().cuda_stream)
                e1.record()
                torch.cuda.synchronize()
                if rc:
                    raise RuntimeError(f"ex_variant_probe: {name} returned {rc}")
                if rep:
                    ms += e0.elapsed_time(e1) / args.reps
            c = clk.cpu()
            slow = int(c[:, 0].argmax())
            print(f"level {level} {name}: chase {ms:.3f} ms, flush_block's clock64 share "
                  f"{float(c[slow, 1]) / float(c[slow, 0]):.3f}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
