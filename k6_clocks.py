#!/usr/bin/env python3
"""Where K6's time goes, by clock64 counters inside the kernel, on one card.

    python3 k6_clocks.py

Builds a copy of zlib_rs_tpu_torch/csrc/inflate.cu with counters added
(the decode warp's cycles, its cycles in literal runs, its literals and
matches, the slowest block's cycles) into build/k6_clocks/, then decodes
chip_smoke.py's 8 MiB corpus as its 256-chunk index in one launch and a
1.2 MB stdlib raw stream at B=1, each checked against the plain version.
Prints, per input: the instrumented launch's CUDA-event ms, cycles per
literal (the literal runs' cycles over the literals), cycles per match
(the rest of the decode's cycles over the matches) and the slowest block
against the mean; then the card's name and power limit. The counters
cost a few percent; the uninstrumented kernel's times are chip_smoke.py's.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def rep(s: str, a: str, b: str) -> str:
    if a not in s:
        raise RuntimeError(f"k6_clocks: csrc/inflate.cu no longer has {a.strip()!r}")
    return s.replace(a, b, 1)


def instrumented(src: str) -> str:
    """The kernel source with its counters, read back by zrs_dbg."""
    s = rep(src, "__constant__ int kClOrder",
            "__device__ unsigned long long dbg[8];\n__constant__ int kClOrder")
    s = rep(s, "  int rl, lit_lim;\n", "  int rl, lit_lim;\n  long long c_lit, n_lit, n_match;\n")
    s = rep(s, "      while (e < (1u << 28) && bp <= comp_bits) {  // kind kLit\n",
            "      long long cl = clock64();\n"
            "      while (e < (1u << 28) && bp <= comp_bits) {  // kind kLit\n        n_lit++;\n")
    s = rep(s, "      bad = bad || op > max_out;\n      const bool exhausted",
            "      c_lit += clock64() - cl;\n      bad = bad || op > max_out;\n      const bool exhausted")
    s = rep(s, "          op += length;\n", "          n_match++;\n          op += length;\n")
    s = rep(s, "  dc.rd.seek(start_bit);\n", "  dc.rd.seek(start_bit);\n  long long c0 = clock64();\n")
    s = rep(s, "  dc.publish(min(dc.op, dc.max_out));\n",
            "  if (lane == 0) {\n"
            "    const unsigned long long cyc = clock64() - c0;\n"
            "    atomicAdd(&dbg[0], cyc);\n"
            "    atomicAdd(&dbg[1], (unsigned long long)dc.c_lit);\n"
            "    atomicAdd(&dbg[2], (unsigned long long)dc.n_lit);\n"
            "    atomicAdd(&dbg[3], (unsigned long long)dc.n_match);\n"
            "    atomicMax(&dbg[4], cyc);\n"
            "  }\n  dc.publish(min(dc.op, dc.max_out));\n")
    return s + """
extern "C" int zrs_dbg(void* host) {
  cudaError_t e = cudaMemcpyFromSymbol(host, dbg, sizeof(dbg));
  unsigned long long z[8] = {0};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(dbg, z, sizeof(z));
  return (int)e;
}
"""


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k6_clocks: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "zlib_rs_tpu_torch" / "csrc" / "inflate.cu").is_file():
        print("k6_clocks: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    os.environ["ZRS_TPU_KERNEL"] = "1"
    import chip_smoke as cs
    import zlib_rs_tpu_torch as zt
    from zlib_rs_tpu_torch import _device
    from zlib_rs_tpu_torch.ops.kernels import inflate_kernel as IK

    out_dir = ROOT / "build" / "k6_clocks"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "inflate_clk.cu"
    src.write_text(instrumented((ROOT / "zlib_rs_tpu_torch" / "csrc" / "inflate.cu").read_text()))
    lib_path = out_dir / "libzrs_inflate_clk.so"
    subprocess.run([_device._nvcc(), *_device.NVCC_FLAGS, "-o", str(lib_path), str(src)],
                   check=True)
    _device.build()
    lib = ctypes.CDLL(str(lib_path))
    real = _device.library
    _device.library = lambda name: lib if name == "inflate" else real(name)

    dev = torch.device("cuda")
    corpus, _ = cs.load_corpus(cs.CORPUS_BYTES)
    idx_out, index = zt.compress_parallel(corpus, cs.LEVEL, return_index=True)
    bodies = [idx_out[o : o + n] for o, n, _ in index]
    sizes = [n for *_, n in index]
    big = cs._raw(corpus[:1_200_000])
    buf = (ctypes.c_ulonglong * 8)()
    for label, streams, out_lens, max_out in (
            (f"{len(bodies)}-chunk index", bodies, sizes, max(sizes)),
            ("1.2 MB stream at B=1", [big], [-1], 1_200_000)):
        words, bits = IK.pack_streams_words(streams)
        args = [torch.from_numpy(words.view("i4")).to(dev),
                torch.zeros(len(streams), dtype=torch.int32, device=dev),
                torch.from_numpy(bits).to(dev), torch.tensor(out_lens, dtype=torch.int32, device=dev)]
        want = IK.decode_streams_plain(*[a.cpu() for a in args], max_out=max_out)
        torch.cuda.synchronize()
        _device.check(lib.zrs_dbg(buf), "zrs_dbg")
        got = IK.decode_streams_cuda(*args, max_out=max_out)
        torch.cuda.synchronize()
        _device.check(lib.zrs_dbg(buf), "zrs_dbg")
        err = cs.k6_err(torch, got, want, max_out)
        if err:
            raise AssertionError(f"the instrumented K6 disagrees with its plain version: {err}")
        dec, lit_cyc, n_lit, n_match, slowest = list(buf)[:5]
        ms = cs.event_ms(torch, lambda: IK.decode_streams_cuda(*args, max_out=max_out), 5)
        print(f"{label}: {ms:.3f} ms a launch (instrumented), equal to plain; "
              f"{lit_cyc / max(n_lit, 1):.1f} cycles a literal ({n_lit} literals), "
              f"{(dec - lit_cyc) / max(n_match, 1):.1f} cycles a match ({n_match} matches); "
              f"slowest block {slowest} cycles, mean {dec / len(streams):.0f}", flush=True)
    print(cs.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
