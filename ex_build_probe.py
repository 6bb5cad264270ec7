#!/usr/bin/env python3
"""EX's build time and kernel time with its large bodies kept out of line
(`EX_BIG` = `__device__ __noinline__`, the source as it stands) and with
everything inlined (`EX_BIG` = `__device__`, a copy of the source).

    python3 ex_build_probe.py [--reps 3]

Writes both variants under build/ex_build_probe/, compiles each alone with
the port's nvcc flags (timed, one after the other), reads each library's
registers and stack from `cuobjdump --dump-resource-usage`, then times EX
on the bench corpus in 128 KiB chunks primed with 32 KiB (64 chunks, one
warp each) at levels 1, 6 and 9, QUICK and MEDIUM5 by CUDA events, the
two variants in turn (inline, out of line, out of line, inline). Every
launch's bytes, lengths and status must equal the inlined variant's
first. Prints a line a reading, then one JSON line with the build
seconds, the resource usage and the ms, and the card's name and power
limit. Exits 2 without a GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_OF_LINE = "#define EX_BIG __device__ __noinline__"
INLINE = "#define EX_BIG __device__"
LEVELS = (1, 6, 9, 10, 12)  # 10 QUICK, 12 MEDIUM5


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ex_build_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from zlib_rs_tpu_torch import _device
    from zlib_rs_tpu_torch.bench import load_corpus
    from zlib_rs_tpu_torch.ops.kernels import exact_deflate_kernel as EK
    from zlib_rs_tpu_torch.parallel import chunk_deflate as CD

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    src = (_device.CSRC / "exact_deflate.cu").read_text()
    if src.count(OUT_OF_LINE) != 1:
        raise AssertionError(f"the source does not define EX_BIG as {OUT_OF_LINE!r}")
    work = ROOT / "build" / "ex_build_probe"  # git-ignored
    work.mkdir(parents=True, exist_ok=True)
    nvcc = _device._nvcc()
    cuobjdump = str(Path(nvcc).with_name("cuobjdump"))
    libs, build_s, usage = {}, {}, {}
    for name, text in (("inline", src.replace(OUT_OF_LINE, INLINE)), ("out_of_line", src)):
        cu, so = work / f"exact_deflate_{name}.cu", work / f"libex_{name}.so"
        cu.write_text(text)
        t0 = time.perf_counter()
        subprocess.run([nvcc, *_device.NVCC_FLAGS, "-o", str(so), str(cu)], check=True)
        build_s[name] = time.perf_counter() - t0
        dump = subprocess.run([cuobjdump, "--dump-resource-usage", str(so)],
                              capture_output=True, text=True).stdout
        usage[name] = [ln.strip() for ln in dump.splitlines() if "REG:" in ln]
        libs[name] = ctypes.CDLL(str(so))
        print(f"{name}: nvcc {build_s[name]:.3f} s; {usage[name]}", flush=True)

    corpus = load_corpus()
    n, chunk = len(corpus), CD.DEFAULT_CHUNK
    data = torch.from_numpy(np.frombuffer(corpus, np.uint8).copy()).cuda()
    rows = [(lo, min(n, lo + chunk) - lo, min(CD.WSIZE, lo), int(lo + chunk >= n))
            for lo in range(0, n, chunk)]
    ms = {name: {lvl: [] for lvl in LEVELS} for name in libs}
    first = {}
    for name in ("inline", "out_of_line", "out_of_line", "inline"):
        _device._LIBS["exact_deflate"] = libs[name]
        for lvl in LEVELS:
            meta = torch.from_numpy(CD.chunk_meta(rows, lvl)).cuda()
            got = EK.exact_deflate_cuda(data, meta, lvl)  # warm-up and check
            lens = got[1].tolist()
            view = [got[0][o : o + m].cpu().numpy().tobytes()
                    for o, m in zip(meta[:, 4].tolist(), lens)] + [lens, got[2].tolist()]
            if first.setdefault(lvl, view) != view:
                raise AssertionError(f"the {name} EX differs at level {lvl}")
            torch.cuda.synchronize()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(args.reps):
                EK.exact_deflate_cuda(data, meta, lvl)
            e1.record()
            torch.cuda.synchronize()
            ms[name][lvl].append(e0.elapsed_time(e1) / args.reps)
            print(f"{name} level {lvl}: {ms[name][lvl][-1]:.3f} ms a launch "
                  f"({len(rows)} chunks)", flush=True)
    print(json.dumps({"build_s": build_s, "usage": usage, "ms": ms, "chunks": len(rows),
                      "bytes": n, "card": smi}))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
