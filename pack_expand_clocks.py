#!/usr/bin/env python3
"""Where K3's, K5's, K11b's, K9's, K4's and K11a's time goes, by clock64
counters inside the kernels, on one card.

    python3 pack_expand_clocks.py [--parent DIR]

Builds copies of zlib_rs_tpu_torch/csrc/pack.cu, csrc/vhuff_expand.cu (K5
and K11b, one body; a second copy with K11b's resolve window cut from 8
rows to 4), csrc/freq.cu and csrc/vhuff_decode.cu (K4 and K11a, one body)
with counters added into build/pack_expand_clocks/, then runs K3 on the
first level-6 super-batch of chip_smoke.py's 8 MiB corpus (128 chunks, no
seeds), K4, K11a, K5 and K11b on the 256 chunks of its indexed stream (the
two-plane and the single-plane tapes), and K9 on the level-9 match stream
of the first super-batch, each checked against the plain version. The
counters are thread 0's clock64 between the block's barriers, so each
phase counts until its slowest thread is done. Prints, per kernel: the
instrumented launch's CUDA-event ms, each phase's mean cycles a block and
the slowest block's, for K5 and K11b the chase's rounds (mean and most),
for K4 and K11a a walker's cycles a row, its rows, the blocks on each
branch and the longest walker's chunk decoded alone; then the shipped
kernels' ms a launch, by events as chip_smoke.py times them and with the
launches queued behind a busy card (the kernel alone, without the host's
cost to launch each); then copies of csrc/vhuff_decode.cu with one thing
changed (DECODE_VARIANTS: each kernel at the other's literal/length table
width, checked against the plain versions; no zero rows, timing only),
timed the same two ways; then the card's name and power limit.

With --parent DIR (a checkout of an earlier commit, e.g. unpacked with
`git archive`), also builds DIR's csrc/freq.cu and, where DIR has them,
csrc/vhuff_expand1.cu and the one-thread-a-walker decodes
csrc/vhuff_decode.cu and csrc/vhuff_decode1.cu as they are, and times them
on the same inputs the same two ways (the decodes also with a counter pair
a walker: its decode loop and its zero rows).
    python3 pack_expand_clocks.py --checksums [--parent DIR]

Only K7 and K1 (csrc/crc32.cu, csrc/adler32.cu): each built with counters
and as it is, from this checkout and, with --parent, from DIR, whichever
of the two designs each source holds (the first: a combine tree and a
strided walk; the second: end-aligned segments joined by XOR and 16-byte
segment loads). K7 runs on the gzip trailer's 256 full 32 KiB rows of the
corpus, K1 on the first level-6 super-batch's 128 chunk views, as
chip_smoke.py's phases 9 and 1 take them, each checked against its plain
version; prints each phase's mean cycles a block, the slowest block, and
each kernel's ms a launch by events and queued; then this checkout's K7
and K1 at the other geometries of CHECKSUM_VARIANTS (threads a row, bytes
a thread a pass), checked and timed the same way.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "zlib_rs_tpu_torch" / "csrc"
PACK_PHASES = ("tables and codes", "classify", "count and scans", "emit", "copy-out")
EXPAND_PHASES = ("init", "resolve", "fill", "chase", "copy-out")
FREQ_PHASES = ("stage", "matches and scan", "literal count", "merge")
DECODE_PHASES = ("staging", "table build", "decode loop", "zero rows")
# copies of csrc/vhuff_decode.cu timed beside it: (label, exact, edits)
DECODE_VARIANTS = (
    ("K4's literal/length table at 12 bits", True,
     (("  static constexpr int kLlBits = 13;", "  static constexpr int kLlBits = 12;"),)),
    ("K11a's literal/length table at 13 bits", True,
     (("  static constexpr int kLlBits = 12;", "  static constexpr int kLlBits = 13;"),)),
    ("no zero rows (timing only)", False,
     (("  for (int it = r.it; it < warp_end; ++it) out.zero((long long)it * W + w);\n", ""),
      ("  for (int it = warp_end + (lane >> 3); it < cap; it += 4) out.zero4((long long)it * W + col);\n",
       ""))),
)
K11B_GROUP = "  static constexpr int kGroup = 8;  // lanes a resolving walker: a window of 8 rows\n"
DBG = """
__device__ unsigned long long dbg[16];
#define CLK_MARK(i) if (threadIdx.x == 0) { const long long now_ = clock64(); \\
  clk_[i] += now_ - clk_t_; clk_t_ = now_; }
"""
DBG_READ = """
extern "C" int zrs_dbg(void* host) {
  cudaError_t e = cudaMemcpyFromSymbol(host, dbg, sizeof(dbg));
  unsigned long long z[16] = {0};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(dbg, z, sizeof(z));
  return (int)e;
}
"""
# dbg[0:n] phase cycles summed over blocks, dbg[8] the slowest block's
# total, dbg[9] chase rounds summed, dbg[10] the most rounds


def rep(s: str, a: str, b: str, name: str) -> str:
    if a not in s:
        raise RuntimeError(f"pack_expand_clocks: csrc/{name} no longer has {a.strip()!r}")
    return s.replace(a, b, 1)


def flush(n: int) -> str:
    return ("  if (threadIdx.x == 0) {\n    unsigned long long tot_ = 0;\n"
            f"    for (int i_ = 0; i_ < {n}; ++i_) {{ atomicAdd(&dbg[i_], clk_[i_]); tot_ += clk_[i_]; }}\n"
            "    atomicMax(&dbg[8], tot_);\n  }\n")


def pack_instrumented(src: str) -> str:
    n = "pack.cu"
    s = rep(src, "namespace {\n", DBG + "namespace {\n", n)
    s = rep(s, "  if (tid == 0) s_last = -1;\n",
            "  if (tid == 0) s_last = -1;\n  unsigned long long clk_[5] = {0};\n"
            "  long long clk_t_ = clock64();\n", n)
    s = rep(s, "    __syncthreads();\n    // 1. classify", "    __syncthreads();\n    CLK_MARK(0)\n"
            "    // 1. classify", n)
    s = rep(s, "    cover = max(cover, s_pre);\n", "    cover = max(cover, s_pre);\n    CLK_MARK(1)\n", n)
    s = rep(s, "    const int off = block_scan<false>(cnt.bits, tmp, &tile_bits);\n",
            "    const int off = block_scan<false>(cnt.bits, tmp, &tile_bits);\n    CLK_MARK(2)\n", n)
    s = rep(s, "    if (em.last >= 0) atomicMax(&s_last, em.last);\n    __syncthreads();\n",
            "    if (em.last >= 0) atomicMax(&s_last, em.last);\n    __syncthreads();\n"
            "    CLK_MARK(3)\n", n)
    s = rep(s, "    k0 = s_kmin;\n    __syncthreads();\n  }\n",
            "    k0 = s_kmin;\n    __syncthreads();\n    CLK_MARK(4)\n  }\n" + flush(5), n)
    return s + DBG_READ


def expand_instrumented(src: str) -> str:
    n = "vhuff_expand.cu"
    s = rep(src, "namespace {\n", DBG + "namespace {\n", n)
    s = rep(s, "  if (mode == kModeChase && fits) {\n",
            "  unsigned long long clk_[5] = {0};\n  long long clk_t_ = clock64();\n"
            "  unsigned long long rounds_ = 0;\n  if (mode == kModeChase && fits) {\n", n)
    s = rep(s, "    __syncthreads();\n    bool ok = true;\n",
            "    __syncthreads();\n    CLK_MARK(0)\n    bool ok = true;\n", n)
    s = rep(s, "    if (!__syncthreads_or(!ok)) {\n", "    if (!__syncthreads_or(!ok)) {\n      CLK_MARK(1)\n", n)
    s = rep(s, "      fill(cell, q0, q1, last, last_cell);\n      __syncthreads();\n",
            "      fill(cell, q0, q1, last, last_cell);\n      __syncthreads();\n      CLK_MARK(2)\n", n)
    s = rep(s, "        if (!__syncthreads_or(moved)) break;\n",
            "        ++rounds_;\n        if (!__syncthreads_or(moved)) break;\n", n)
    s = rep(s, "      for (int i = tid; i < out_words; i += kThreads) {\n        const uint32_t c01",
            "      CLK_MARK(3)\n      for (int i = tid; i < out_words; i += kThreads) {\n"
            "        const uint32_t c01", n)
    s = rep(s, "      if (branch && tid == 0) branch[chunk] = kChase;\n",
            "      __syncthreads();\n      CLK_MARK(4)\n" + flush(5)
            + "      if (tid == 0) { atomicAdd(&dbg[9], rounds_); atomicMax(&dbg[10], rounds_); }\n"
            "      if (branch && tid == 0) branch[chunk] = kChase;\n", n)
    return s + DBG_READ


def freq_instrumented(src: str) -> str:
    n = "freq.cu"
    s = rep(src, "namespace {\n", DBG + "namespace {\n", n)
    s = rep(s, "  const int row = blockIdx.x, tid = threadIdx.x;\n",
            "  const int row = blockIdx.x, tid = threadIdx.x;\n  unsigned long long clk_[4] = {0};\n"
            "  long long clk_t_ = clock64();\n", n)
    s = rep(s, "  __syncthreads();\n\n  for (int t0 = 0; t0 <= nmatch; t0 += kTile) {\n",
            "  __syncthreads();\n  CLK_MARK(0)\n\n  for (int t0 = 0; t0 <= nmatch; t0 += kTile) {\n", n)
    s = rep(s, "    if (tid == 0) gap_off[ng] = total;\n    __syncthreads();\n",
            "    if (tid == 0) gap_off[ng] = total;\n    __syncthreads();\n    CLK_MARK(1)\n", n)
    s = rep(s, "      if (run_n) atomicAdd(&wh[run_b], run_n);\n    }\n    __syncthreads();\n  }\n",
            "      if (run_n) atomicAdd(&wh[run_b], run_n);\n    }\n    __syncthreads();\n"
            "    CLK_MARK(2)\n  }\n", n)
    s = rep(s, "    f[b] = s;\n  }\n}\n",
            "    f[b] = s;\n  }\n  __syncthreads();\n  CLK_MARK(3)\n" + flush(4) + "}\n", n)
    return s + DBG_READ


def decode_instrumented(src: str) -> str:
    """K4 and K11a with a barrier after each phase: the staged window's copy
    (its cp.async waited for before the table build, which it overlaps in
    the shipped kernel), the direct tables, the slowest walker's decode
    loop, and the zero rows; dbg[11] the walkers' cycles in their loops and
    dbg[12] their rows."""
    n = "vhuff_decode.cu"
    s = rep(src, "namespace {\n", DBG + "namespace {\n", n)
    s = rep(s, "  const int tid = threadIdx.x, lane = tid & 31;\n",
            "  const int tid = threadIdx.x, lane = tid & 31;\n  unsigned long long clk_[4] = {0};\n"
            "  long long clk_t_ = clock64();\n", n)
    s = rep(s, "      cp_async4(stage + (i - sb), words + (i < 0 ? 0 : (i > last ? last : i)));\n  }\n",
            "      cp_async4(stage + (i - sb), words + (i < 0 ? 0 : (i > last ? last : i)));\n  }\n"
            "  asm volatile(\"cp.async.wait_all;\\n\" ::: \"memory\");\n  __syncthreads();\n  CLK_MARK(0)\n", n)
    s = rep(s, "  asm volatile(\"cp.async.wait_all;\\n\" ::: \"memory\");\n  __syncthreads();\n  if (tid == 0)",
            "  asm volatile(\"cp.async.wait_all;\\n\" ::: \"memory\");\n  __syncthreads();\n  CLK_MARK(1)\n"
            "  if (tid == 0)", n)
    s = rep(s, "  Walked r;\n", "  Walked r;\n  const long long w0_ = clock64();\n", n)
    s = rep(s, "  // zero rows:", "  atomicAdd(&dbg[11], (unsigned long long)(clock64() - w0_));\n"
            "  atomicAdd(&dbg[12], (unsigned long long)r.it);\n"
            "  __syncthreads();\n  CLK_MARK(2)\n  // zero rows:", n)
    s = rep(s, "  cons_out[w] = r.cons;\n", "  __syncthreads();\n  CLK_MARK(3)\n" + flush(4)
            + "  cons_out[w] = r.cons;\n", n)
    return s + DBG_READ


def decode_variants(torch, cs, VK, out_dir: Path, calls: dict, wants: dict) -> None:
    """DECODE_VARIANTS built in parallel and timed as the shipped K4 and
    K11a are, by events and queued; the exact ones checked against the
    plain versions first."""
    from zlib_rs_tpu_torch import _device

    src = (CSRC / "vhuff_decode.cu").read_text()
    procs = []
    for i, (label, _exact, edits) in enumerate(DECODE_VARIANTS):
        text = src
        for a, b in edits:
            text = rep(text, a, b, "vhuff_decode.cu")
        path = out_dir / f"vhuff_decode_v{i}.cu"
        path.write_text(text)
        lib = out_dir / f"libzrs_vhuff_decode_v{i}.so"
        procs.append((label, lib, subprocess.Popen(
            [_device._nvcc(), *_device.NVCC_FLAGS, "-o", str(lib), str(path)])))
    real = _device.library
    try:
        for label, lib_path, proc in procs:
            if proc.wait():
                raise RuntimeError(f"pack_expand_clocks: the {label} variant does not build")
            lib = ctypes.CDLL(str(lib_path))
            _device.library = lambda name, lib=lib: lib if name == "vhuff_decode" else real(name)
            exact = dict((v[0], v[1]) for v in DECODE_VARIANTS)[label]
            parts = []
            for kernel, fn in calls.items():
                if exact and cs.max_abs(zip(fn(), wants[kernel])):
                    raise AssertionError(f"the {label} variant of {kernel} disagrees with plain")
                parts.append(f"{kernel} {cs.event_ms(torch, fn, 20):.6f} ms by events, "
                              f"{cs.queued_ms(torch, fn):.6f} queued")
            print(f"vhuff_decode.cu, {label}: " + "; ".join(parts), flush=True)
    finally:
        _device.library = real


def build(name: str, text: str, out_dir: Path):
    from zlib_rs_tpu_torch import _device

    src = out_dir / f"{name}_clk.cu"
    src.write_text(text)
    lib_path = out_dir / f"libzrs_{name}_clk.so"
    subprocess.run([_device._nvcc(), *_device.NVCC_FLAGS, "-o", str(lib_path), str(src)],
                   check=True)
    return ctypes.CDLL(str(lib_path))


def report(label, buf, blocks, phases, ms, rounds=False):
    d = list(buf)
    parts = ", ".join(f"{p} {d[i] / blocks:.0f}" for i, p in enumerate(phases))
    line = (f"{label}: {ms:.4f} ms a launch (instrumented), equal to plain; mean cycles a "
            f"block: {parts}; slowest block {d[8]} cycles")
    if rounds:
        line += f"; chase rounds mean {d[9] / blocks:.2f}, most {d[10]}"
    print(line, flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("pack_expand_clocks: no CUDA device", file=sys.stderr)
        return 2
    if not (CSRC / "pack.cu").is_file():
        print("pack_expand_clocks: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    os.environ["ZRS_TPU_KERNEL"] = "1"
    import chip_smoke as cs
    import zlib_rs_tpu_torch as zt
    from zlib_rs_tpu_torch import _device
    from zlib_rs_tpu_torch.ops import lzvec
    from zlib_rs_tpu_torch.ops.kernels import deflate_kernel as DK
    from zlib_rs_tpu_torch.ops.kernels import vhuff_kernel as VK
    from zlib_rs_tpu_torch.parallel import pipeline as PL
    from zlib_rs_tpu_torch.parallel import vector_inflate as VI

    parent = Path(sys.argv[sys.argv.index("--parent") + 1]) if "--parent" in sys.argv else None
    if "--checksums" in sys.argv:
        checksum_clocks(torch, cs, parent)
        print(cs.nvidia_smi())
        return 0
    out_dir = ROOT / "build" / "pack_expand_clocks"
    out_dir.mkdir(parents=True, exist_ok=True)
    expand_src = expand_instrumented((CSRC / "vhuff_expand.cu").read_text())
    libs = {"pack": build("pack", pack_instrumented((CSRC / "pack.cu").read_text()), out_dir),
            "vhuff_expand": build("vhuff_expand", expand_src, out_dir),
            "freq": build("freq", freq_instrumented((CSRC / "freq.cu").read_text()), out_dir),
            "vhuff_decode": build("vhuff_decode", decode_instrumented(
                (CSRC / "vhuff_decode.cu").read_text()), out_dir)}
    expand_g4 = build("vhuff_expand_g4", rep(expand_src, K11B_GROUP, K11B_GROUP.replace(
        "kGroup = 8;  // lanes a resolving walker: a window of 8 rows",
        "kGroup = 4;  // lanes a resolving walker: a window of 4 rows"), "vhuff_expand.cu"), out_dir)
    _device.build()
    real = _device.library
    _device.library = lambda name: libs.get(name) or real(name)
    dev = torch.device("cuda")
    buf = (ctypes.c_ulonglong * 16)()
    corpus, _ = cs.load_corpus(cs.CORPUS_BYTES)

    # K3: the first super-batch, as chip_smoke.py's phase 3 builds it
    good, mlazy, nice, chain = PL._level_knobs(cs.LEVEL)["kernel_cfg"]
    _variant, w_g = PL._resolve_kernel_variant((good, mlazy, nice, chain))
    n_chunks = -(-len(corpus) // PL.DEFAULT_CHUNK)
    dict_size = PL.priming_dict_size(n_chunks, PL.DEFAULT_CHUNK, True)
    padded, n_valid, valid_from, _ = PL.chunk_buffers(corpus, PL.DEFAULT_CHUNK, dict_size)
    b0, bsz = PL.batch_spans(n_chunks)[0]
    dc = torch.from_numpy(padded[b0 : b0 + bsz]).to(dev)
    dn = torch.from_numpy(n_valid[b0 : b0 + bsz]).to(dev)
    dv = torch.from_numpy(valid_from[b0 : b0 + bsz]).to(dev)
    words4 = DK.words_from_bytes(dc)
    htab = lzvec.build_hop_tables(words4, dn, dv, depth=chain, nice=nice, good=good,
                                  max_lazy=mlazy, w_g=w_g, bytes_arr=dc)
    mpos, mld, nm, kbad, freq = DK._hop_post(*DK.hop_chase_cuda(words4, htab, dn, dict_size,
                                                                 4 * w_g))
    lltab, dtab = DK.code_tables(freq)
    words, meta, oww = DK.pack_inputs(dc, dn, dict_size, torch.where(kbad, 0, nm), 0)
    args = (words, mpos, mld, meta, lltab, dtab, oww, 0)
    want = DK.pack_plain(*args)
    torch.cuda.synchronize()
    _device.check(libs["pack"].zrs_dbg(buf), "zrs_dbg")
    got = DK.pack_cuda(*args)
    torch.cuda.synchronize()
    _device.check(libs["pack"].zrs_dbg(buf), "zrs_dbg")
    pairs = [(got[1][:, :2], want[1][:, :2])]
    pairs += [(got[0][r, : int(want[1][r, 0]) // 32 + 2], want[0][r, : int(want[1][r, 0]) // 32 + 2])
              for r in range(bsz)]
    if cs.max_abs(pairs):
        raise AssertionError("the instrumented K3 disagrees with its plain version")
    report(f"K3, {bsz} chunks", buf, bsz, PACK_PHASES,
           cs.event_ms(torch, lambda: DK.pack_cuda(*args), 50))
    pack_call = lambda: DK.pack_cuda(*args)

    # K5: the indexed stream's tapes, as chip_smoke.py's phase 6 takes them
    idx_out, index = zt.compress_parallel(corpus, cs.LEVEL, return_index=True)
    _bodies, sizes, _seeds, staged, m, full_args, _sub = cs.stage_decode(VI, idx_out, index, dev)
    tapeA, tapeB, *_ = VK.decode_tokens_vector2_cuda(*full_args, S=m["S"], K=m["K"],
                                                     cap=VI._twoplane_cap(m))
    out_words = -(-max(sizes) // 4) + 2
    offs = staged["offs"]
    want = VK.expand_tokens2_plain(tapeA, tapeB, offs, out_words=out_words)
    torch.cuda.synchronize()
    _device.check(libs["vhuff_expand"].zrs_dbg(buf), "zrs_dbg")
    got = VK.expand_tokens2_cuda(tapeA, tapeB, offs, out_words=out_words)
    torch.cuda.synchronize()
    _device.check(libs["vhuff_expand"].zrs_dbg(buf), "zrs_dbg")
    if cs.bytes_err(torch, got, want, sizes):
        raise AssertionError("the instrumented K5 disagrees with its plain version")
    report(f"K5, {m['B']} chunks", buf, m["B"], EXPAND_PHASES,
           cs.event_ms(torch, lambda: VK.expand_tokens2_cuda(tapeA, tapeB, offs,
                                                             out_words=out_words), 50),
           rounds=True)
    expand_call = lambda: VK.expand_tokens2_cuda(tapeA, tapeB, offs, out_words=out_words)

    # K4 and K11a on the same chunks, as phases 5 and 21 take them
    decode_calls, decode_wants = {}, {}
    for label, cuda, plain, cap in (
            ("K4", VK.decode_tokens_vector2_cuda, VK.decode_tokens_vector2_plain,
             VI._twoplane_cap(m)),
            ("K11a", VK.decode_tokens_vector_cuda, VK.decode_tokens_vector_plain, m["cap"])):
        call = lambda cuda=cuda, cap=cap: cuda(*full_args, S=m["S"], K=m["K"], cap=cap)
        want = plain(*full_args, S=m["S"], K=m["K"], cap=cap)
        torch.cuda.synchronize()
        _device.check(libs["vhuff_decode"].zrs_dbg(buf), "zrs_dbg")
        VK.decode_blocks()
        got = call()
        torch.cuda.synchronize()
        _device.check(libs["vhuff_decode"].zrs_dbg(buf), "zrs_dbg")
        blocks = VK.decode_blocks()
        if cs.max_abs(zip(got, want)):
            raise AssertionError(f"the instrumented {label} disagrees with its plain version")
        rows = (want[-4] != 0).sum(dim=0)
        blk = len(rows) // 128
        report(f"{label}, {m['B']} chunks, cap {cap}", buf, blk, DECODE_PHASES,
               cs.event_ms(torch, call, 20))
        print(f"{label}: rows a walker mean {float(rows.float().mean()):.1f}, longest walker "
              f"{int(rows.max())}; a walker's loop {buf[11] / max(buf[12], 1):.0f} cycles a row "
              f"(mean over rows); blocks staged/global {blocks}", flush=True)
        decode_calls[label], decode_wants[label] = call, want
        # the chunk of the longest walker alone on the card: one block
        k = int(rows.argmax()) // m["S"]
        S = m["S"]
        one = [full_args[0][k : k + 1]] + [a[k * S : (k + 1) * S] for a in full_args[1:4]] + [
            full_args[4][k : k + 1]]
        torch.cuda.synchronize()
        _device.check(libs["vhuff_decode"].zrs_dbg(buf), "zrs_dbg")
        got1 = cuda(*one, S=S, K=m["K"], cap=cap)
        torch.cuda.synchronize()
        _device.check(libs["vhuff_decode"].zrs_dbg(buf), "zrs_dbg")
        if cs.max_abs(zip(got1, plain(*one, S=S, K=m["K"], cap=cap))):
            raise AssertionError(f"the instrumented {label} disagrees on chunk {k} alone")
        report(f"{label}, chunk {k} alone ({S // 128} blocks)", buf, S // 128, DECODE_PHASES,
               cs.event_ms(torch, lambda: cuda(*one, S=S, K=m["K"], cap=cap), 20))
        print(f"{label}, chunk {k} alone: a walker's loop {buf[11] / max(buf[12], 1):.0f} cycles "
              f"a row", flush=True)

    # K11b: the single-plane tape of the same chunks, as phase 22 takes it,
    # with its resolve window as shipped (8 rows) and cut to 4
    tape, *_ = VK.decode_tokens_vector_cuda(*full_args, S=m["S"], K=m["K"], cap=m["cap"])
    want1 = VK.expand_tokens_plain(tape, offs, out_words=out_words)
    expand1_call = lambda: VK.expand_tokens_cuda(tape, offs, out_words=out_words)
    for group, lib in ((8, libs["vhuff_expand"]), (4, expand_g4)):
        libs["vhuff_expand"] = lib
        torch.cuda.synchronize()
        _device.check(lib.zrs_dbg(buf), "zrs_dbg")
        branch = torch.full((m["B"],), -1, dtype=torch.int32, device=dev)
        got = VK.expand_tokens_cuda(tape, offs, out_words=out_words, branch=branch)
        torch.cuda.synchronize()
        _device.check(lib.zrs_dbg(buf), "zrs_dbg")
        if cs.bytes_err(torch, got, want1, sizes) or (branch != VK.BRANCH_CHASE).any():
            raise AssertionError("the instrumented K11b disagrees with its plain version")
        report(f"K11b, {m['B']} chunks, resolve window {group}", buf, m["B"], EXPAND_PHASES,
               cs.event_ms(torch, expand1_call, 50), rounds=True)

    # K9: the level-9 match stream of the first super-batch, as phase 18 takes it
    g9, m9, n9, c9 = PL._level_knobs(9)["kernel_cfg"]
    starts = torch.full((bsz,), dict_size, dtype=torch.int32, device=dev)
    mpos9, mld9, st9 = DK.chain_scan_cuda(words4, dn, starts, dv, depth=c9, nice=n9, good=g9,
                                          max_lazy=m9)
    meta9 = meta.clone()
    meta9[:, 2] = torch.where(st9[:, 1] > 0, 0, st9[:, 0])
    want = DK.freq_plain(words, mpos9, mld9, meta9)
    torch.cuda.synchronize()
    _device.check(libs["freq"].zrs_dbg(buf), "zrs_dbg")
    got = DK.freq_cuda(words, mpos9, mld9, meta9)
    torch.cuda.synchronize()
    _device.check(libs["freq"].zrs_dbg(buf), "zrs_dbg")
    if cs.max_abs([(got, want)]):
        raise AssertionError("the instrumented K9 disagrees with its plain version")
    freq_call = lambda: DK.freq_cuda(words, mpos9, mld9, meta9)
    report(f"K9, {bsz} chunks at level 9", buf, bsz, FREQ_PHASES, cs.event_ms(torch, freq_call, 50))

    # the kernels as shipped, without counters: event ms as chip_smoke.py
    # takes them, and with the launches queued behind a busy card
    _device.library = real
    for label, fn in (("K3", pack_call), ("K5", expand_call), ("K11b", expand1_call),
                      ("K9", freq_call), ("K4", decode_calls["K4"]),
                      ("K11a", decode_calls["K11a"])):
        print(f"{label} uninstrumented: {cs.event_ms(torch, fn, 50):.6f} ms a launch by events, "
              f"{cs.queued_ms(torch, fn):.6f} ms queued", flush=True)
    decode_variants(torch, cs, VK, out_dir, decode_calls, decode_wants)
    if parent is not None:
        parent_kernels(torch, cs, DK, VK, parent, out_dir, (words, mpos9, mld9, meta9),
                       (tape, offs, out_words, sizes, want1))
        parent_decodes(torch, cs, VK, parent, out_dir, full_args, m, VI._twoplane_cap(m))
    print(cs.nvidia_smi())
    return 0


def parent_kernels(torch, cs, DK, VK, parent: Path, out_dir: Path, k9_args, k11b_args) -> None:
    """The parent checkout's K9 and K11b, built from its sources as they
    are, on the same inputs: checked against the plain versions, then
    timed by events and queued."""
    from zlib_rs_tpu_torch import _device

    src = parent / "zlib_rs_tpu_torch" / "csrc"
    lib = build("parent_freq", (src / "freq.cu").read_text(), out_dir)
    real = _device.library
    _device.library = lambda name: lib if name == "freq" else real(name)
    try:
        fn = lambda: DK.freq_cuda(*k9_args)
        if cs.max_abs([(fn(), DK.freq_plain(*k9_args))]):
            raise AssertionError("the parent's K9 disagrees with its plain version")
        print(f"K9 parent: {cs.event_ms(torch, fn, 50):.6f} ms a launch by events, "
              f"{cs.queued_ms(torch, fn):.6f} ms queued", flush=True)
    finally:
        _device.library = real
    if not (src / "vhuff_expand1.cu").is_file():
        return
    entry = build("parent_vhuff_expand1", (src / "vhuff_expand1.cu").read_text(),
                  out_dir).zrs_vhuff_expand1
    P, I = ctypes.c_void_p, ctypes.c_int
    entry.argtypes, entry.restype = [P, P, I, I, I, I, P, P], ctypes.c_int
    tape, offs, out_words, sizes, want = k11b_args
    cap, W = tape.shape
    S = offs.shape[1] - 1
    out = torch.empty((offs.shape[0], out_words), dtype=torch.int32, device=tape.device)

    def fn():
        _device.check(entry(_device.ptr(tape), _device.ptr(offs), cap, W, S, out_words,
                            _device.ptr(out), _device.stream_of(tape)), "parent vhuff_expand1")
        return out

    if cs.bytes_err(torch, fn(), want, sizes):
        raise AssertionError("the parent's K11b disagrees with its plain version")
    print(f"K11b parent: {cs.event_ms(torch, fn, 50):.6f} ms a launch by events, "
          f"{cs.queued_ms(torch, fn):.6f} ms queued", flush=True)



# the parent's decode kernels (one thread a walker), with one counter pair
# a walker: its decode loop and its zero rows
PARENT_DECODES = (("vhuff_decode", "zrs_vhuff_decode", "K4", 2),
                  ("vhuff_decode1", "zrs_vhuff_decode1", "K11a", 1))


def split_instrumented(src: str, name: str) -> str:
    """A walker's cycles from its first refill to its last row (dbg[0],
    the most dbg[2]) and in its zero-row loop (dbg[1], the most dbg[3]);
    dbg[4] the longest walker's total."""
    s = rep(src, "namespace {\n", DBG + "namespace {\n", name)
    s = rep(s, "  if (w >= W) return;\n", "  if (w >= W) return;\n  const long long c0_ = clock64();\n",
            name)
    s = rep(s, "  for (; it < cap; ++it) ", "  const long long c1_ = clock64();\n"
            "  for (; it < cap; ++it) ", name)
    s = rep(s, "  cons_out[w] = cons;\n",
            "  const unsigned long long d_ = c1_ - c0_, z_ = clock64() - c1_;\n"
            "  atomicAdd(&dbg[0], d_); atomicAdd(&dbg[1], z_); atomicMax(&dbg[2], d_);\n"
            "  atomicMax(&dbg[3], z_); atomicMax(&dbg[4], d_ + z_);\n  cons_out[w] = cons;\n", name)
    return s + DBG_READ


def parent_decodes(torch, cs, VK, parent: Path, out_dir: Path, full_args, m, cap2) -> None:
    """The parent checkout's K4 and K11a, where it has them as the first
    design's two sources (csrc/vhuff_decode.cu and csrc/vhuff_decode1.cu,
    one thread a walker), on the indexed stream's 256 chunks: checked
    against the plain versions, timed by events and queued, then a copy
    with the split counters."""
    from zlib_rs_tpu_torch import _device

    src = parent / "zlib_rs_tpu_torch" / "csrc"
    S, K = m["S"], m["K"]
    words, start_word, align, span, tables = full_args
    B, Lw = words.shape
    W = start_word.shape[0]
    P, I = ctypes.c_void_p, ctypes.c_int
    buf = (ctypes.c_ulonglong * 16)()
    if not (src / "vhuff_decode1.cu").is_file():
        return
    for name, entry_name, label, planes in PARENT_DECODES:
        cap = cap2 if planes == 2 else m["cap"]
        plain = VK.decode_tokens_vector2_plain if planes == 2 else VK.decode_tokens_vector_plain
        want = plain(*full_args, S=S, K=K, cap=cap)
        outs = [torch.empty((cap, W), dtype=torch.int32, device=words.device)
                for _ in range(planes)]
        outs += [torch.empty(W, dtype=torch.int32, device=words.device) for _ in range(3)]
        text = (src / f"{name}.cu").read_text()
        for tag, lib in (("", build(f"parent_{name}", text, out_dir)),
                         ("_clk", build(f"parent_{name}_clk", split_instrumented(text, f"{name}.cu"),
                                        out_dir))):
            entry = getattr(lib, entry_name)
            entry.argtypes = [P, I, I, P, P, P, P, I, I, I, I] + [P] * (planes + 4)
            entry.restype = ctypes.c_int

            def fn(entry=entry):
                _device.check(entry(
                    _device.ptr(words), B, Lw, *(_device.ptr(t) for t in full_args[1:]), S, K,
                    cap, W, *(_device.ptr(t) for t in outs), _device.stream_of(words)),
                    f"parent {name}")
                return outs

            if tag:
                torch.cuda.synchronize()
                _device.check(lib.zrs_dbg(buf), "zrs_dbg")
            if cs.max_abs(zip(fn(), want)):
                raise AssertionError(f"the parent's {label} disagrees with its plain version")
            if not tag:
                print(f"{label} parent: {cs.event_ms(torch, fn, 20):.6f} ms a launch by events, "
                      f"{cs.queued_ms(torch, fn):.6f} ms queued", flush=True)
                continue
            torch.cuda.synchronize()
            _device.check(lib.zrs_dbg(buf), "zrs_dbg")
            d = list(buf)
            rows = (want[planes - 1] != 0).sum(dim=0)
            print(f"{label} parent split ({B} chunks, {W} walkers, cap {cap}): cycles a walker: "
                  f"decode mean {d[0] / W:.0f}, most {d[2]}; zero rows mean {d[1] / W:.0f}, most "
                  f"{d[3]}; longest walker {d[4]} cycles; rows a walker mean "
                  f"{float(rows.float().mean()):.1f}, most {int(rows.max())}", flush=True)


# K7 and K1 (--checksums): the phases of their first design (a combine
# tree; a strided walk), which the current sources replaced, and of theirs
CRC_FIRST_PHASES = ("table and x2n", "segment walk", "combine tree")
ADLER_FIRST_PHASES = ("strided walk", "reduction")


def crc_first_instrumented(src: str) -> str:
    n = "crc32.cu"
    s = rep(src, "namespace {\n", DBG + "namespace {\n", n)
    s = rep(s, "  const int t = threadIdx.x;\n",
            "  const int t = threadIdx.x;\n  unsigned long long clk_[3] = {0};\n"
            "  long long clk_t_ = clock64();\n", n)
    s = rep(s, "  __syncthreads();\n\n  const int row = blockIdx.x;\n",
            "  __syncthreads();\n  CLK_MARK(0)\n\n  const int row = blockIdx.x;\n", n)
    s = rep(s, "  seg_len[t] = hi - lo;\n  __syncthreads();\n",
            "  seg_len[t] = hi - lo;\n  __syncthreads();\n  CLK_MARK(1)\n", n)
    s = rep(s, "  if (t == 0) out[row] = (int32_t)crc[0];\n",
            "  CLK_MARK(2)\n" + flush(3) + "  if (t == 0) out[row] = (int32_t)crc[0];\n", n)
    return s + DBG_READ


def adler_first_instrumented(src: str) -> str:
    n = "adler32.cu"
    s = rep(src, "namespace {\n", DBG + "namespace {\n", n)
    s = rep(s, "  const int row = blockIdx.x;\n",
            "  const int row = blockIdx.x;\n  unsigned long long clk_[2] = {0};\n"
            "  long long clk_t_ = clock64();\n", n)
    s = rep(s, "  sh_w[threadIdx.x] = w;\n  __syncthreads();\n",
            "  sh_w[threadIdx.x] = w;\n  __syncthreads();\n  CLK_MARK(0)\n", n)
    s = rep(s, "  if (threadIdx.x == 0) {\n    const uint32_t a",
            "  CLK_MARK(1)\n" + flush(2) + "  if (threadIdx.x == 0) {\n    const uint32_t a", n)
    return s + DBG_READ


CRC_PHASES = ("loads and tables", "segment walk", "shift and join")
ADLER_PHASES = ("loads and partials", "reduction")


def crc_instrumented(src: str) -> str:
    """K7 with a barrier after the segment walk (none in the shipped kernel)."""
    n = "crc32.cu"
    s = rep(src, "namespace {\n", DBG + "namespace {\n", n)
    s = rep(s, "  const int t = threadIdx.x, row = blockIdx.x;\n",
            "  const int t = threadIdx.x, row = blockIdx.x;\n  unsigned long long clk_[3] = {0};\n"
            "  long long clk_t_ = clock64();\n", n)
    s = rep(s, "  __syncthreads();\n\n  uint32_t c = 0;\n",
            "  __syncthreads();\n  CLK_MARK(0)\n\n  uint32_t c = 0;\n", n)
    s = rep(s, "  c = multmodp(shift, c);\n",
            "  __syncthreads();\n  CLK_MARK(1)\n  c = multmodp(shift, c);\n", n)
    s = rep(s, "    out[row] = (int32_t)~x;\n",
            "    CLK_MARK(2)\n" + flush(3) + "    out[row] = (int32_t)~x;\n", n)
    return s + DBG_READ


def adler_instrumented(src: str) -> str:
    n = "adler32.cu"
    s = rep(src, "namespace {\n", DBG + "namespace {\n", n)
    s = rep(s, "  const int t = threadIdx.x, row = blockIdx.x;\n",
            "  const int t = threadIdx.x, row = blockIdx.x;\n  unsigned long long clk_[2] = {0};\n"
            "  long long clk_t_ = clock64();\n", n)
    s = rep(s, "  __syncthreads();\n  if (t < 32) {\n",
            "  __syncthreads();\n  CLK_MARK(0)\n  if (t < 32) {\n", n)
    s = rep(s, "      out[row] = (int32_t)((b << 16) | a);\n",
            "      CLK_MARK(1)\n" + flush(2) + "      out[row] = (int32_t)((b << 16) | a);\n", n)
    return s + DBG_READ


# (marker in the source, phases, instrumenting function, first design?)
CHECKSUM_DESIGNS = {
    "crc32": (("__shared__ uint32_t x2n[32];", CRC_FIRST_PHASES, crc_first_instrumented, True),
              ("shifts[kThreads + k]", CRC_PHASES, crc_instrumented, False)),
    "adler32": (("for (int i = threadIdx.x; i < len; i += kThreads)", ADLER_FIRST_PHASES,
                 adler_first_instrumented, True),
                ("__dp4a", ADLER_PHASES, adler_instrumented, False)),
}
# this checkout's K7 and K1 at other geometries (threads a row, bytes a
# thread a pass), timed beside the shipped ones
CHECKSUM_VARIANTS = {"crc32": ((256, 128), (1024, 32), (128, 256)),
                     "adler32": ((512, 64), (256, 128))}


def geometry_variant(src: str, name: str, threads: int, seg: int) -> str:
    for const, v in (("kThreads", threads), ("kSeg", seg)):
        found = re.search(rf"constexpr int {const} = \d+;", src)
        if not found:
            raise RuntimeError(f"pack_expand_clocks: csrc/{name}.cu no longer has {const}")
        src = src.replace(found.group(0), f"constexpr int {const} = {v};", 1)
    return src


def build_all(out_dir: Path, texts: dict) -> dict:
    """{name: source text} built at once, one nvcc each; {name: CDLL}."""
    from zlib_rs_tpu_torch import _device

    procs = {}
    for name, text in texts.items():
        src = out_dir / f"{name}.cu"
        src.write_text(text)
        lib = out_dir / f"libzrs_{name}.so"
        procs[name] = (lib, subprocess.Popen([_device._nvcc(), *_device.NVCC_FLAGS, "-o", str(lib),
                                              str(src)]))
    libs = {}
    for name, (lib, proc) in procs.items():
        if proc.wait():
            raise RuntimeError(f"pack_expand_clocks: {name}.cu does not build")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def checksum_design(src: str, name: str, label: str) -> tuple:
    found = [d for d in CHECKSUM_DESIGNS[name] if d[0] in src]
    if not found:
        raise RuntimeError(f"pack_expand_clocks: {label}'s {name}.cu is no design known here")
    return found[0]


def checksum_clocks(torch, cs, parent) -> None:
    """--checksums: K7 and K1 of this checkout and of `parent`, each with
    counters and as it is, on the main path's inputs."""
    import numpy as np

    from zlib_rs_tpu_torch import _device
    from zlib_rs_tpu_torch.ops.kernels import checksum_kernels as CK
    from zlib_rs_tpu_torch.ops.kernels import crc_kernels as CRC
    from zlib_rs_tpu_torch.parallel import pipeline as PL

    dev = torch.device("cuda")
    corpus, _ = cs.load_corpus(cs.CORPUS_BYTES)
    chunk = PL.DEFAULT_CHUNK
    nfull = len(corpus) // chunk
    rows = torch.from_numpy(np.frombuffer(corpus, np.uint8, count=nfull * chunk)
                            .reshape(nfull, chunk).copy()).to(dev)
    rlens = torch.full((nfull,), chunk, dtype=torch.int32, device=dev)
    n_chunks = -(-len(corpus) // chunk)
    dict_size = PL.priming_dict_size(n_chunks, chunk, True)
    padded, n_valid, _, _ = PL.chunk_buffers(corpus, chunk, dict_size)
    b0, bsz = PL.batch_spans(n_chunks)[0]
    dc = torch.from_numpy(padded[b0 : b0 + bsz]).to(dev)
    seg = dc[:, dict_size : dict_size + chunk]
    slens = (torch.from_numpy(n_valid[b0 : b0 + bsz]).to(dev) - dict_size).to(torch.int32)
    inputs = {"crc32": (rows, rlens, CRC.crc32_batch_cuda, CRC.crc32_batch_plain, "K7"),
              "adler32": (seg, slens, CK.adler32_batch_cuda, CK.adler32_batch_plain, "K1")}
    out_dir = ROOT / "build" / "checksum_clocks"
    out_dir.mkdir(parents=True, exist_ok=True)
    checkouts = [("this checkout", ROOT)] + ([("parent", parent)] if parent is not None else [])
    texts, plan = {}, []
    for tag, (label, root) in enumerate(checkouts):
        for name in ("crc32", "adler32"):
            src = (root / "zlib_rs_tpu_torch" / "csrc" / f"{name}.cu").read_text()
            _marker, phases, instrument, first = checksum_design(src, name, label)
            texts[f"{name}_{tag}"] = src
            texts[f"{name}_{tag}_clk"] = instrument(src)
            plan.append((label, name, tag, phases, first))
            if tag == 0 and not first:  # the first designs have no geometry to vary
                for threads, seg in CHECKSUM_VARIANTS[name]:
                    texts[f"{name}_{threads}x{seg}"] = geometry_variant(src, name, threads, seg)
    libs = build_all(out_dir, texts)
    buf = (ctypes.c_ulonglong * 16)()
    real = _device.library
    wants = {name: plain(data, lens) for name, (data, lens, _c, plain, _k) in inputs.items()}
    try:
        for label, name, tag, phases, first in plan:
            data, lens, cuda, plain, kname = inputs[name]
            want = wants[name]
            for suffix in ("_clk", ""):
                lib = libs[f"{name}_{tag}{suffix}"]
                if first and name == "crc32":
                    # the first K7's C entry has no shift table
                    entry = lib.zrs_crc32_batch
                    P, I = ctypes.c_void_p, ctypes.c_int
                    entry.argtypes, entry.restype = [P, ctypes.c_longlong, I, I, P, P, P], I
                    out = torch.empty(data.shape[0], dtype=torch.int32, device=dev)

                    def call(entry=entry, out=out, data=data, lens=lens):
                        _device.check(entry(_device.ptr(data), data.stride(0), data.shape[0],
                                            data.shape[1], _device.ptr(lens), _device.ptr(out),
                                            _device.stream_of(data)), "crc32")
                        return out
                else:
                    _device.library = lambda n, lib=lib, name=name: lib if n == name else real(n)
                    call = lambda cuda=cuda, data=data, lens=lens: cuda(data, lens)
                torch.cuda.synchronize()
                if suffix:
                    _device.check(lib.zrs_dbg(buf), "zrs_dbg")
                got = call()
                torch.cuda.synchronize()
                if cs.max_abs([(got, want)]):
                    raise AssertionError(f"{label}'s {kname}{suffix} disagrees with its plain version")
                if suffix:
                    _device.check(lib.zrs_dbg(buf), "zrs_dbg")
                    report(f"{kname} ({label}), {data.shape[0]} rows of {data.shape[1]} bytes",
                           buf, data.shape[0], phases, cs.event_ms(torch, call, 50))
                else:
                    print(f"{kname} ({label}) as built: {cs.event_ms(torch, call, 50):.6f} ms a "
                          f"launch by events, {cs.queued_ms(torch, call):.6f} ms queued", flush=True)
                _device.library = real
        for name, geoms in CHECKSUM_VARIANTS.items():
            data, lens, cuda, _plain, kname = inputs[name]
            mod = CRC if name == "crc32" else CK
            for threads, seg in geoms:
                lib = libs.get(f"{name}_{threads}x{seg}")
                if lib is None:
                    continue
                _device.library = lambda n, lib=lib, name=name: lib if n == name else real(n)
                shipped = mod.THREADS, mod.SEG
                mod.THREADS, mod.SEG = threads, seg  # K7's wrapper builds its shifts from them
                try:
                    call = lambda cuda=cuda, data=data, lens=lens: cuda(data, lens)
                    if cs.max_abs([(call(), wants[name])]):
                        raise AssertionError(f"{kname} at {threads}x{seg} disagrees with plain")
                    print(f"{kname} at {threads} threads x {seg} bytes: "
                          f"{cs.event_ms(torch, call, 50):.6f} ms a launch by events, "
                          f"{cs.queued_ms(torch, call):.6f} ms queued", flush=True)
                finally:
                    mod.THREADS, mod.SEG = shipped
                    _device.library = real
    finally:
        _device.library = real


if __name__ == "__main__":
    sys.exit(main())
