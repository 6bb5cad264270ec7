#!/usr/bin/env python3
"""Where the port's CLI should hand a file to the card: the wall of one
`python -m zlib_rs_tpu_torch` process with `--engine host` and with each
card engine (`native`: EX and the speculative decode; `cuda`:
compress_parallel and the foreign decode), compress and decompress, on
slices of the bench corpus.

    python3 cli_crossover.py [--sizes 65536,131072,...] [--engines native,cuda] [--ops c,d]

Builds the kernels first (a user's later runs find them built in
build/), writes each slice and its stdlib gzip-6 stream under
build/cli_crossover/, then runs each size's processes (`-c`, then `-d -c`
of the gzip stream, host first, then each card engine) with
ZRS_TPU_KERNEL unset, the CLI's default encode engine. Every output is
checked: a compressed one decodes to the slice with stdlib zlib, a
decompressed one equals the slice. Prints a line a run, then one JSON
line with the walls, for each card engine the smallest size from which
its wall stays under the host's (compress and decompress:
`TPU_THRESHOLD` in zlib_rs_tpu_torch/cli.py applies to the input bytes,
so the decompress crossover is also given in gzip bytes), and the card's
name and power limit. Exits 2 without a GPU.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import subprocess
import sys
import time
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SIZES = (65536, 131072, 262144, 524288, 1 << 20, 2 << 20, 4 << 20)


def crossover(sizes, host, card):
    """The smallest size from which the card's wall is below the host's at
    every larger size measured, or None."""
    best = None
    for n, h, c in reversed(list(zip(sizes, host, card))):
        if c >= h:
            break
        best = n
    return best


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default=",".join(map(str, SIZES)))
    ap.add_argument("--engines", default="native,cuda")
    ap.add_argument("--ops", default="c,d", help="c (compress), d (decompress) or both")
    args = ap.parse_args()
    sizes = [int(s) for s in args.sizes.split(",")]
    engines = ["host", *args.engines.split(",")]
    import torch

    if not torch.cuda.is_available():
        print("cli_crossover: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from zlib_rs_tpu_torch import _device
    from zlib_rs_tpu_torch.bench import load_corpus

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    t0 = time.perf_counter()
    _device.build()
    print(f"built the kernels in {time.perf_counter() - t0:.3f} s", flush=True)
    corpus = load_corpus()
    work = ROOT / "build" / "cli_crossover"  # git-ignored
    work.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    env.pop("ZRS_TPU_KERNEL", None)

    def cli(*argv) -> tuple[bytes, float]:
        t = time.perf_counter()
        run = subprocess.run([sys.executable, "-m", "zlib_rs_tpu_torch", *argv],
                             capture_output=True, env=env, cwd=ROOT, timeout=900)
        wall = time.perf_counter() - t
        if run.returncode:
            raise AssertionError(f"the CLI {argv} exited {run.returncode}: "
                                 f"{run.stderr.decode()[-2000:]}")
        return run.stdout, wall

    ops = args.ops.split(",")
    walls = {f"{op}_{engine}": [] for op in ops for engine in engines}
    gz_sizes = []
    for n in sizes:
        data = corpus[:n]
        src, gz = work / f"slice_{n}.bin", work / f"slice_{n}.bin.gz"
        src.write_bytes(data)
        stream = gzip.compress(data, 6, mtime=0)
        gz.write_bytes(stream)
        gz_sizes.append(len(stream))
        for engine in engines if "c" in ops else ():
            out, wall = cli("-c", "--engine", engine, str(src))
            if zlib.decompress(out, 31) != data:
                raise AssertionError(f"-c --engine {engine} of {n} bytes does not decode")
            walls[f"c_{engine}"].append(wall)
            print(f"{n} bytes -c --engine {engine}: {len(out)} bytes, {wall:.3f} s", flush=True)
        for engine in engines if "d" in ops else ():
            out, wall = cli("-d", "-c", "--engine", engine, str(gz))
            if out != data:
                raise AssertionError(f"-d --engine {engine} of {n} bytes differs")
            walls[f"d_{engine}"].append(wall)
            print(f"{n} bytes -d --engine {engine} ({len(stream)} gzip bytes): {wall:.3f} s",
                  flush=True)
    cross = {}
    for engine in engines[1:]:
        c = crossover(sizes, walls["c_host"], walls[f"c_{engine}"]) if "c" in ops else None
        d = crossover(sizes, walls["d_host"], walls[f"d_{engine}"]) if "d" in ops else None
        cross[engine] = {"compress": c, "decompress": d,
                         "decompress_gzip_bytes": None if d is None else gz_sizes[sizes.index(d)]}
    print(json.dumps({"sizes": sizes, "gzip_sizes": gz_sizes, **walls, "crossover": cross,
                      "card": smi}))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
