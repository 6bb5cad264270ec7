"""Benchmark of the port on one CUDA card: the structure, phases and final
line of bench.py (the JAX package's bench, which stays at the repository
root), with device seconds read from a torch.profiler trace.

    python -m zlib_rs_tpu_torch.bench

Prints a result JSON line incrementally: after every completed phase the
full result, then a compact line under 500 bytes, so that a kill at any
point after the corpus is built still leaves a parseable last line. The
global wall-clock budget is ZRS_BENCH_BUDGET_S (default 1200 s). The
device phases run in a killable child process (--device-child, a fresh
interpreter) that prints "DEVPART <json>" after every phase; the parent
merges each part, prints a snapshot, and kills the child at its deadline.

Corpus: bench.py's deterministic tar of mixed members, byte for byte: the
reference's vendored test data (lcet10.txt, paper-100k.pdf, fireworks.jpg,
issue-169.js) from the directory ZRS_BENCH_TESTDATA names, when it is set
and holds them, then /bin/bash, /usr/bin/python3.12 and /bin/ls, repeated
to TARGET_SIZE (ZRS_BENCH_TARGET_MB) bytes with fixed metadata.

Sections reported:
  cpu_zlib  stdlib zlib compress (levels 0-9) and decompress, the baseline.
  device    the device phases, in the reference's order: kernel_encode
            (the kernel engine's level-6 batch, the headline),
            vector_decode (K4, K5), inflate_kernel (K6; the reference's
            pallas_inflate), foreign_kernel (decompress_foreign on K6),
            swarm (the seeded swarm engine, zrs_swarm), kernel_ratio (the kernel
            engine's compress_parallel, wall clock) and xla_encode (the
            XLA engine's batch, and its ratio over the corpus). Each checks
            its output against the zlib oracle before it records a time.
            The indexed stream the decode phases read is compress_parallel
            of the first BATCH chunks on the card.
  native    every row of bench.py's bench_native, its keys, reps and
            checks against stdlib zlib, through the port's `native` facade
            on the card, each row's engine in `engines`: deflate_chunk at
            levels 0-9 (`compress`, one EX warp over the corpus),
            deflate_parallel at 1, 6, 9 (`parallel_compress`, EX), QUICK and
            MEDIUM4-6 (EX), inflate_raw (`inflate_gbps`, SP2 from bit 0),
            inflate_parallel over a body of one deflate_chunk a CHUNK
            (`parallel_inflate_gbps`, K6) and `speculative_inflate_gbps`
            (SP1-SP3; the speculative phase's number: best of 3 calls on
            stdlib zlib-6 raw of the corpus). The inflate rows read stdlib
            zlib's raw level 6, which is deflate_chunk's bytes (EX gives
            zlib's at 1-9), so that they need not wait on EX's serial
            level-6 call. Walls of whole calls, host included (the facade
            returns host bytes). The rows run cheapest first; the level
            sweep is a phase of its own, native_levels, run after the
            decode sweep, into native["compress"]. A row whose reps, priced
            at its first call (its check), would overrun the budget, or
            whose first call would (priced at twice the last level's), is
            {"cut_by_budget": true, "first_call_s": ...}, not a phase error.
  decode_sweep  bench.py's bench_decode_sweep: the port's models.stream
            Inflate (IS on the card) fed a zlib-6 stream of the corpus's
            first 4 MiB (256 KiB below 2^10) in pieces of 2^4-2^24 bytes,
            median MB/s of 3 runs, and pure_engine_2^14 through the host
            Inflator; budgeted as the native rows.
  On the CPU (device="cpu") both run the plain versions, labelled wall
  clock of the plain versions in their `timing`.

Device seconds: the traced phases run their dispatch under
torch.profiler (CUDA activity only, no shapes, no stacks); a dispatch's
device seconds are the union of its kernel, memcpy and memset intervals
over the reps, divided by the reps, also given per kernel (the port's
kernels by their library name, zrs_<csrc source>; torch's own kernels as
"torch"). The wall of the traced reps gives each phase's device-busy
share. A traced phase whose hand-written kernels are missing from its
trace raises; if the profiler itself fails, a wall-clock number is kept,
labelled as such. No CPU time is labelled as device time.

Headline: parallel_deflate_level6_device_gbps, the kernel engine's level-6
batch (8 chunks of 32 KiB behind a 31,976-byte dictionary) over its device
seconds; vs_baseline divides it by single-thread zlib at level 6.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tarfile
import tempfile
import threading
import time
import zlib
from pathlib import Path

import numpy as np
import torch

from . import _device

TESTDATA_MEMBERS = ("lcet10.txt", "paper-100k.pdf", "fireworks.jpg", "issue-169.js")
TARGET_SIZE = 8 * 1024 * 1024
CHUNK = 128 * 1024
KCHUNK = 32 * 1024  # the kernel-engine chunk size
BATCH = 16
LEVEL = 6
LEVELS_MATRIX = (1, 6, 9)
LEVELS_SWEEP = tuple(range(10))
KB = 8  # chunks of the traced kernel-engine batch
KDICT = 31976  # its dictionary: KDICT + KCHUNK + PAD fits the kernel's 65,024 bytes
NB = 16  # chunk bodies of the inflate_kernel phase
VECTOR_BYTES = 8 << 20  # the vector phase tiles its batch to about this output
SWARM_TILE = 4  # the swarm phase's lanes: the seeded chunks, this many times
FOREIGN_BYTES = 4 * 1024 * 1024  # the foreign stream's input
VALUE_SOURCE = "CUDA device time (torch.profiler)"
ROW_MARGIN_S = 15.0  # kept free past a native or sweep row's predicted cost
NATIVE_ENGINES = {  # the card's engine of each native row
    "compress": "EX", "parallel_compress": "EX", "quick": "EX", "medium": "EX",
    "inflate_gbps": "SP", "parallel_inflate_gbps": "K6", "speculative_inflate_gbps": "SP",
}
SWEEP_ENGINES = {"2^N": "IS", "pure_engine_2^14": "host"}
# the key each device phase leaves on success
PHASE_KEYS = {
    "kernel_encode": "kernel_encode_trace_gbps",
    "vector_decode": "vector_decode_trace_gbps",
    "inflate_kernel": "inflate_kernel_gbps",
    "foreign_kernel": "foreign_kernel_decode_gbps",
    "speculative": "speculative_inflate_gbps",
    "swarm": "swarm_decode_trace_gbps",
    "kernel_ratio": "kernel_ratio_vs_zlib",
    "xla_encode": "encode_trace_gbps",
    "native": "native",
    "decode_sweep": "decode_sweep",
    "native_levels": "native",  # its rows are native["compress"]
}
SECTIONS = ("native", "decode_sweep")  # device entries the result carries at its top level

T0 = time.monotonic()
BUDGET = float(os.environ.get("ZRS_BENCH_BUDGET_S", "1200"))
PHASE_SECONDS = {}
PHASE_ERRORS = {}  # device phases that did not complete, and why
if os.environ.get("ZRS_BENCH_TARGET_MB"):
    TARGET_SIZE = int(float(os.environ["ZRS_BENCH_TARGET_MB"]) * 1024 * 1024)


def remaining() -> float:
    return BUDGET - (time.monotonic() - T0)


def load_corpus() -> bytes:
    """Deterministic tar of mixed members with fixed metadata, bench.py's recipe."""
    members = []
    testdata = os.environ.get("ZRS_BENCH_TESTDATA")
    if testdata:
        for name in TESTDATA_MEMBERS:
            p = Path(testdata) / name
            if p.exists():
                members.append((name, p.read_bytes()))
    for extra in ("/bin/bash", "/usr/bin/python3.12", "/bin/ls"):
        try:
            members.append((Path(extra).name, Path(extra).read_bytes()))
        except OSError:
            pass
    if not members:
        rng = np.random.default_rng(0)
        members = [("rand", rng.integers(0, 64, 1 << 20, dtype=np.uint8).tobytes())]
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w", format=tarfile.USTAR_FORMAT) as tf:
        rep = 0
        while buf.tell() < TARGET_SIZE:
            for name, blob in members:
                ti = tarfile.TarInfo(f"{rep}/{name}")
                ti.size = len(blob)
                ti.mtime = 0
                tf.addfile(ti, io.BytesIO(blob))
            rep += 1
    return buf.getvalue()[:TARGET_SIZE]


def _log(msg):
    print(f"# bench: {msg}", file=sys.stderr, flush=True)


@contextlib.contextmanager
def _phase(name):
    """Add the wall time of the block to PHASE_SECONDS[name]."""
    t = time.monotonic()
    try:
        yield
    finally:
        PHASE_SECONDS[name] = round(PHASE_SECONDS.get(name, 0.0) + time.monotonic() - t, 1)


@contextlib.contextmanager
def _env(name: str, value):
    """Set (or, with None, unset) one environment variable for the block."""
    old = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


def _time_median(fn, reps=5):
    """Median-of-reps wall time."""
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


def _time_best(fn, reps=3):
    """Best-of-reps wall time."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def bench_cpu(data: bytes) -> dict:
    n = len(data)
    out = {"compress": {}}
    zstreams = {}
    for lvl in LEVELS_SWEEP:
        reps = 5 if lvl in LEVELS_MATRIX else 3
        t = _time_median(lambda l=lvl: zlib.compress(data, l), reps=reps)
        zstreams[lvl] = zlib.compress(data, lvl)
        out["compress"][str(lvl)] = {
            "gbps": round(n / t / 1e9, 4),
            "bytes": len(zstreams[lvl]),
        }
    z6 = zstreams[LEVEL]
    t = _time_median(lambda: zlib.decompress(z6), reps=5)
    out["inflate_gbps"] = round(n / t / 1e9, 4)
    return out, zstreams


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return res.stdout.strip() or f"nvidia-smi rc {res.returncode}"


class _watchdog:
    """SIGALRM-based phase timeout, so that a phase that hangs ends in
    TimeoutError; the parent's SIGKILL of the child is the hard stop."""

    def __init__(self, seconds, label):
        self.seconds = max(1, int(seconds))
        self.label = label

    def __enter__(self):
        import signal

        def _fire(_sig, _frm):
            raise TimeoutError(f"{self.label} exceeded {self.seconds}s")

        self._old = signal.signal(signal.SIGALRM, _fire)
        signal.alarm(self.seconds)
        return self

    def __exit__(self, *exc):
        import signal

        signal.alarm(0)
        signal.signal(signal.SIGALRM, self._old)
        return False


# ---------------------------------------------------------------------------
# device seconds from a torch.profiler trace
# ---------------------------------------------------------------------------

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def kernel_symbols() -> dict:
    """{"zrs_<source>": the __global__ functions of csrc/<source>.cu} for
    every source of `_device.SOURCES`, a tuple each; speculative.cu holds
    SP1-SP3's seven, exact_deflate.cu EX's and DS's seven, istream.cu IS's
    two, every other source one."""
    out = {}
    for name in _device.SOURCES:
        text = (_device.CSRC / f"{name}.cu").read_text()
        found = re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(", text)
        if not found:
            raise RuntimeError(f"csrc/{name}.cu: no kernel found")
        out[f"zrs_{name}"] = tuple(found)
    return out


def _owner(name: str, symbols: dict) -> str:
    """The zrs_ library whose kernel a trace event names, or "torch"."""
    for lib, fns in symbols.items():
        for fn in fns:
            # demangled ("void (anonymous namespace)::pack<true>(...)") or
            # mangled ("_GLOBAL__N_14packILb1E..."; a file-unique prefix
            # "_GLOBAL__N__<hash>_..._<n><fn>" also ends in the length and name)
            if re.search(rf"(?:^|[\s:]){fn}[(<]", name) or re.search(
                    rf"_GLOBAL__N_\w*?{len(fn)}{fn}(?:I|E|P|v|i|j)", name):
                return lib
    return "torch"


def device_busy(events, symbols: dict) -> tuple[float, dict]:
    """(seconds of the union of the device intervals, seconds per owner)
    of a Chrome trace's events: kernels by their zrs_ library or "torch",
    and "memcpy", "memset"."""
    spans = []
    per = {}
    for e in events:
        cat = e.get("cat", "")
        if e.get("ph") != "X" or cat not in _DEVICE_CATS:
            continue
        ts, dur = float(e["ts"]), float(e.get("dur", 0))
        key = _owner(e.get("name", ""), symbols) if cat == "kernel" else cat[4:]
        per[key] = per.get(key, 0.0) + dur / 1e6
        spans.append((ts, ts + dur))
    spans.sort()
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e6, per


def _trace(fn, reps: int, device: torch.device) -> tuple[float, dict, float]:
    """Run fn `reps` times under torch.profiler (CUDA activity only):
    (device-busy seconds, seconds per owner, wall seconds), totals over
    the reps."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA], record_shapes=False,
                 with_stack=False, profile_memory=False) as prof:
        t0 = time.monotonic()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize(device)
        wall = time.monotonic() - t0
    fd, path = tempfile.mkstemp(prefix="zrs_bench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)
    busy, per = device_busy(events, kernel_symbols())
    return busy, per, wall


def _device_trace_seconds(dispatch, reps: int, tag: str, timeout_s: float, *,
                          device: torch.device, expect=()):
    """Device seconds per dispatch from a torch.profiler trace.

    A wall number is banked first (reps dispatches, then a synchronize).
    Returns (seconds_per_dispatch, per-kernel seconds per dispatch, wall
    seconds per dispatch of the traced reps), or (None, {}, wall) when
    the trace holds no device time. Raises when a kernel of `expect` (zrs_
    library names) is missing from the trace. For a CPU dispatch, and when
    the profiler itself fails, returns the banked wall with
    {"__wall_clock__": True}: never device time."""

    def run():
        t0 = time.monotonic()
        for _ in range(reps):
            dispatch()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return (time.monotonic() - t0) / reps

    with _watchdog(timeout_s, f"device trace {tag}"):
        wall = run()
        if device.type != "cuda":
            return wall, {"__wall_clock__": True}, wall
        try:
            busy, per, traced_wall = _trace(dispatch, reps, device)
        except TimeoutError:
            raise
        except Exception as e:
            _log(f"trace {tag} failed ({type(e).__name__}: {e}): keeping the "
                 "banked wall-clock number")
            return wall, {"__wall_clock__": True}, wall
    missing = [k for k in expect if per.get(k, 0.0) <= 0.0]
    if missing:
        raise RuntimeError(f"trace {tag}: no {missing} among the traced kernels {sorted(per)}")
    if busy <= 0:
        return None, {}, traced_wall / reps
    return busy / reps, {k: round(v / reps, 6) for k, v in per.items()}, traced_wall / reps


def _record_trace(dev: dict, prefix: str, sec, progs: dict, wall: float) -> bool:
    """The per-kernel seconds, the traced wall and the device-busy share of
    a traced phase under `prefix`; False when the trace gave no device
    time (a wall-clock number or none)."""
    if not sec or progs.get("__wall_clock__"):
        return False
    dev[f"{prefix}_trace_kernels"] = progs
    dev[f"{prefix}_trace_wall_s"] = round(wall, 6)
    dev[f"{prefix}_busy_share"] = round(sec / wall, 4) if wall else None
    return True


# ---------------------------------------------------------------------------
# the device phases
# ---------------------------------------------------------------------------


def _check_blocks(res, chunks: np.ndarray, n_valid, valid_from, dict_size: int,
                  label: str) -> None:
    """Each chunk's dynamic block of an `_encode_batch` result, given its
    header as a final block, inflates with zlib (primed with the chunk's
    dictionary) to the chunk's bytes."""
    from .parallel import pipeline as P

    words = res[0].to(torch.int32).cpu().numpy()
    bits, ll, dd = (t.cpu().numpy() for t in res[1:4])
    for k in range(chunks.shape[0]):
        hdr, hb = P._dyn_header(ll[k], dd[k], final=True)
        body_bits = int(bits[k])
        block = P._splice_bits(hdr, hb, words[k].view(np.uint8), body_bits)
        zdict = chunks[k, int(valid_from[k]) : dict_size].tobytes()
        d = zlib.decompressobj(-15, zdict=zdict) if zdict else zlib.decompressobj(-15)
        if d.decompress(block) + d.flush() != chunks[k, dict_size : int(n_valid[k])].tobytes():
            raise ValueError(f"{label}: chunk {k} does not inflate to its bytes")


def _phase_kernel_encode(data, flat, dev, device):
    """The kernel engine at its configuration (32 KiB chunks behind a
    31,976-byte priming dictionary, level 6: the hop route, K2 then K3),
    one `_encode_batch` of KB chunks; its trace normalizes per input
    byte."""
    from .ops import lz77
    from .parallel import pipeline as P

    knobs = P._level_knobs(LEVEL)
    variant, w_g = P._resolve_kernel_variant(knobs["kernel_cfg"])
    karr = np.zeros((KB, KDICT + KCHUNK + lz77.PAD), np.uint8)
    kvf = np.zeros((KB,), np.int32)
    knv = np.zeros((KB,), np.int32)
    for k in range(KB):
        seg = flat[k * KCHUNK : (k + 1) * KCHUNK]
        karr[k, KDICT : KDICT + seg.shape[0]] = seg
        dlen = min(KDICT, k * KCHUNK)
        if dlen:
            karr[k, KDICT - dlen : KDICT] = flat[k * KCHUNK - dlen : k * KCHUNK]
        kvf[k] = KDICT - dlen
        knv[k] = KDICT + seg.shape[0]
    kdc = torch.from_numpy(karr).to(device)
    knvj = torch.from_numpy(knv).to(device)
    kfins = torch.zeros((KB,), dtype=torch.int32, device=device)
    kvfj = torch.from_numpy(kvf).to(device)

    def kernel_once():
        return P._encode_batch(
            kdc, knvj, kfins, kvfj, dict_size=KDICT, n_seeds=0, dynamic=True,
            kernel_scan=True, variant=variant, w_g=w_g, **knobs,
        )

    with _watchdog(min(120, remaining() - 10), "kernel-scan encode check"):
        _check_blocks(kernel_once(), karr, knv, kvf, KDICT, "kernel encode")
    _log("kernel-scan encode checked by zlib")
    scan = {"hop": "zrs_hop_chase_il", "tab": "zrs_tab_scan", "chain": "zrs_chain_scan"}[variant]
    expect = (scan, "zrs_pack") + (("zrs_freq",) if variant != "hop" else ())
    sec, progs, wall = _device_trace_seconds(
        kernel_once, 1, "kencode", min(120, remaining() - 10), device=device, expect=expect)
    nbytes = int((knv - KDICT).sum())
    if sec and progs.get("__wall_clock__"):
        dev["kernel_encode_wallclock_gbps"] = round(nbytes / sec / 1e9, 5)
        _log(f"kernel-scan encode WALL-CLOCK {dev['kernel_encode_wallclock_gbps']} GB/s")
    elif _record_trace(dev, "kernel_encode", sec, progs, wall):
        dev["kernel_encode_trace_s_per_batch"] = round(sec, 6)
        dev["kernel_encode_trace_gbps"] = round(nbytes / sec / 1e9, 5)
        _log(f"kernel-scan encode device-trace {dev['kernel_encode_trace_gbps']} GB/s "
             f"({sec * 1e3:.3f} ms/batch, busy {dev['kernel_encode_busy_share']})")


def _seeded_stream(data, device) -> dict:
    """The indexed stream the decode phases read: compress_parallel of the
    first BATCH chunks of CHUNK bytes with return_index, on the XLA engine
    (ZRS_TPU_KERNEL unset, as the reference's seed child runs it),
    checked by zlib."""
    from .parallel.pipeline import compress_parallel

    prefix = bytes(data[: BATCH * CHUNK])
    with _env("ZRS_TPU_KERNEL", None):
        comp, idx = compress_parallel(prefix, level=LEVEL, chunk_size=CHUNK,
                                      return_index=True, device=device)
    if zlib.decompress(comp) != prefix:
        raise ValueError("the seeded stream does not inflate to its input")
    return {"comp": comp, "index": list(idx), "seeds": idx.seeds}


def _seeded_chunks(seeded):
    """(bodies, out sizes, seeds) of the seeded chunks of the stream."""
    keep = [k for k, s in enumerate(seeded["seeds"] or []) if s is not None]
    idx = seeded["index"]
    bodies = [seeded["comp"][idx[k][0] : idx[k][0] + idx[k][1]] for k in keep]
    return bodies, [idx[k][2] for k in keep], [seeded["seeds"][k] for k in keep]


def _inflate_raw(body: bytes, n: int) -> bytes:
    return zlib.decompressobj(-15).decompress(body)[:n]


def _phase_vector(seeded, dev, device):
    """The vector decode engine (K4 decode, K5 expansion; K11a, K11b
    under ZRS_VECTOR_TWOPLANE=0) on the seeded chunks, tiled to about
    VECTOR_BYTES of output; byte-exact against the raw-deflate oracle
    before any timing."""
    from .parallel import vector_inflate as VI

    bodies, out_sizes, seeds = _seeded_chunks(seeded)
    if not bodies:
        raise ValueError("vector decode: no seeded chunks")
    tile = max(1, VECTOR_BYTES // max(1, sum(out_sizes)))
    bodies, out_sizes, seeds = bodies * tile, out_sizes * tile, seeds * tile
    with _watchdog(min(120, remaining() - 10), "vector exactness"):
        parts = VI.decode_chunks_vector(bodies, out_sizes, seeds, device=device)
    for part, body, osz in zip(parts, bodies, out_sizes):
        if part != _inflate_raw(body, osz):
            raise ValueError("vector decode mismatch vs raw-deflate oracle")
    _log("vector decode byte-exact vs oracle")
    dispatch = VI.make_vector_dispatch(bodies, out_sizes, seeds, device=device)
    dispatch()
    sec, progs, wall = _device_trace_seconds(
        dispatch, 5, "vector", min(120, remaining() - 10), device=device,
        expect=("zrs_vhuff_decode", "zrs_vhuff_expand"))
    out_bytes = sum(out_sizes)
    if sec and progs.get("__wall_clock__"):
        dev["vector_decode_wallclock_gbps"] = round(out_bytes / sec / 1e9, 5)
        _log(f"vector decode WALL-CLOCK {dev['vector_decode_wallclock_gbps']} GB/s")
    elif _record_trace(dev, "vector_decode", sec, progs, wall):
        dev["vector_decode_trace_s"] = round(sec, 6)
        dev["vector_decode_trace_gbps"] = round(out_bytes / sec / 1e9, 5)
        dev["vector_decode_chunks"] = len(bodies)
        dev["vector_huffman_trace_s"] = progs["zrs_vhuff_decode"]
        dev["vector_expand_trace_s"] = progs["zrs_vhuff_expand"]
        _log(f"vector decode device-trace {dev['vector_decode_trace_gbps']} GB/s "
             f"(busy {dev['vector_decode_busy_share']})")


def _phase_inflate_kernel(data, dev, device):
    """K6 over NB independently coded 32 KiB chunk bodies (the kernel
    engine's decode configuration), each a stdlib raw-deflate stream at
    LEVEL: the kernel decodes any raw stream. Times the dispatch of
    swarm_inflate.make_kernel_dispatch."""
    from .parallel import swarm_inflate as SW

    bodies = []
    for k in range(NB):
        c = zlib.compressobj(LEVEL, zlib.DEFLATED, -15)
        bodies.append(c.compress(data[k * KCHUNK : (k + 1) * KCHUNK]) + c.flush())
    out_sizes = [len(data[k * KCHUNK : (k + 1) * KCHUNK]) for k in range(NB)]
    with _watchdog(min(120, remaining() - 10), "inflate kernel verify"):
        parts = SW.decode_chunks_kernel(bodies, out_sizes, device=device)
    if b"".join(parts) != data[: NB * KCHUNK]:
        raise ValueError("inflate kernel output mismatch")
    _log("inflate kernel: decode verified")
    dispatch = SW.make_kernel_dispatch(bodies, out_sizes, device=device)
    sec, progs, wall = _device_trace_seconds(
        dispatch, 1, "inflate_kernel", min(120, remaining() - 10), device=device,
        expect=("zrs_inflate",))
    if sec and progs.get("__wall_clock__"):
        dev["inflate_kernel_wallclock_gbps"] = round(sum(out_sizes) / sec / 1e9, 5)
    elif _record_trace(dev, "inflate_kernel", sec, progs, wall):
        dev["inflate_kernel_trace_s"] = round(sec, 6)
        dev["inflate_kernel_gbps"] = round(sum(out_sizes) / sec / 1e9, 5)
        _log(f"inflate kernel device-trace {dev['inflate_kernel_gbps']} GB/s "
             f"(busy {dev['inflate_kernel_busy_share']})")


def _phase_foreign_kernel(data, dev, device):
    """A foreign monolithic stream (stdlib zlib of FOREIGN_BYTES of the
    corpus) through decompress_foreign: the zran index pass on the card
    (SP1-SP3), then the regions on K6 with 32 KiB windows and sub-byte
    starts. The trace gives the device seconds, the index kernels' among
    them; the wall, host work included, is reported apart."""
    from .parallel.inflate import decompress_foreign

    slice_ = bytes(data[:FOREIGN_BYTES])
    z = zlib.compress(slice_, LEVEL)
    box = []

    def decode():
        box.append(decompress_foreign(z, span=KCHUNK, engine="kernel", device=device))

    with _watchdog(min(240, remaining() - 10), "foreign kernel decode"):
        with _phase("device:foreign_trace"):
            if device.type == "cuda":
                sec, per, wall = _trace(decode, 1, device)
            else:
                t0 = time.monotonic()
                decode()
                sec, per, wall = None, {}, time.monotonic() - t0
    if box[-1] != slice_:
        raise ValueError("foreign decode mismatch")
    if device.type == "cuda":
        for lib in ("zrs_inflate", "zrs_speculative"):
            if per.get(lib, 0.0) <= 0.0:
                raise RuntimeError(f"trace foreign: no {lib} among {sorted(per)}")
        dev["foreign_kernel_decode_trace_s"] = round(sec, 6)
        dev["foreign_kernel_decode_gbps"] = round(len(slice_) / sec / 1e9, 5)
        _record_trace(dev, "foreign_kernel_decode", sec,
                      {k: round(v, 6) for k, v in per.items()}, wall)
    dev["foreign_kernel_decode_wall_s"] = round(wall, 3)
    dev["foreign_kernel_decode_bytes"] = len(slice_)
    _log(f"foreign kernel decode: device {dev.get('foreign_kernel_decode_gbps')} GB/s, "
         f"wall {wall:.1f} s with the index pass")


def _phase_speculative(data, dev, device):
    """The native section's carried row: inflate_speculative on the card
    of stdlib zlib-6 raw of the corpus (SP1-SP3, no index), checked
    against the corpus, then the best of 3 synchronized walls, host
    orchestration included, as the reference times its native row."""
    from .parallel.speculative import inflate_speculative

    c = zlib.compressobj(LEVEL, zlib.DEFLATED, -15)
    raw6 = c.compress(data) + c.flush()
    n = len(data)
    with _watchdog(min(120, remaining() - 10), "speculative inflate"):
        with _phase("device:speculative"):
            if inflate_speculative(raw6, n, device=device)[0] != data:
                raise ValueError("speculative inflate mismatch")
            best = float("inf")
            for _ in range(3):
                if device.type == "cuda":
                    torch.cuda.synchronize()
                t0 = time.monotonic()
                inflate_speculative(raw6, n, device=device)
                if device.type == "cuda":
                    torch.cuda.synchronize()
                best = min(best, time.monotonic() - t0)
    key = "speculative_inflate_gbps" if device.type == "cuda" else "speculative_inflate_wallclock_gbps"
    dev[key] = round(n / best / 1e9, 5)
    dev["speculative_inflate_bytes"] = n
    _log(f"speculative inflate: {dev[key]} GB/s ({device.type} wall)")


def _phase_kernel_ratio(data, dev, device):
    """The kernel engine's compress_parallel (ZRS_TPU_KERNEL=1) at its
    configuration, round trip checked by zlib: the ratio to zlib, and the
    first and the steady (second) wall rate, host work included. The
    measured kernel encode rate sizes the prefix to the time box."""
    from .parallel.pipeline import compress_parallel

    rate = (dev.get("kernel_encode_trace_gbps") or 0.004) * 1e9  # bytes/s
    box = min(600.0, remaining() - 20)
    if box < 30:
        raise TimeoutError("no time box left for kernel ratio")
    nbytes = int(min(len(data), max(1 << 20, rate * box * 0.6)))
    nbytes = (nbytes // KCHUNK) * KCHUNK or len(data)
    prefix = bytes(data[:nbytes])
    with _env("ZRS_TPU_KERNEL", "1"), _watchdog(box, "kernel ratio"):
        t0 = time.monotonic()
        comp = compress_parallel(prefix, level=LEVEL, chunk_size=KCHUNK, device=device)
        wall = time.monotonic() - t0
    if zlib.decompress(comp) != prefix:
        raise ValueError("the kernel-engine stream does not inflate to its input")
    zref = len(zlib.compress(prefix, LEVEL))
    dev["kernel_ratio_vs_zlib"] = round(len(comp) / zref, 4)
    dev["kernel_ratio_bytes"] = nbytes
    if remaining() > 30:
        with _env("ZRS_TPU_KERNEL", "1"), _watchdog(min(60, remaining() - 10),
                                                    "kernel ratio steady"):
            t0 = time.monotonic()
            again = compress_parallel(prefix, level=LEVEL, chunk_size=KCHUNK, device=device)
            steady = time.monotonic() - t0
        if again != comp:
            raise ValueError("the second kernel-engine stream differs from the first")
        dev["kernel_e2e_steady_gbps"] = round(nbytes / steady / 1e9, 5)
    dev["kernel_e2e_wall_gbps"] = round(nbytes / wall / 1e9, 5)
    _log(f"kernel-path ratio {dev['kernel_ratio_vs_zlib']} over {nbytes} bytes; "
         f"e2e wall {dev['kernel_e2e_wall_gbps']} GB/s, steady "
         f"{dev.get('kernel_e2e_steady_gbps')} GB/s")


def _phase_swarm(seeded, dev, device):
    """The seeded swarm engine (its walkers in the zrs_swarm kernel, the
    tables and the resolver in torch) on the seeded chunks, SWARM_TILE
    times; every lane checked against the raw-deflate oracle before the
    trace."""
    from .parallel import swarm_inflate as SW

    bodies, out_sizes, seeds = _seeded_chunks(seeded)
    if not bodies:
        raise ValueError("swarm: no seeded chunks")
    bodies, out_sizes, seeds = (x * SWARM_TILE for x in (bodies, out_sizes, seeds))
    *arrays, cap = SW.seeded_inputs(bodies, out_sizes, seeds)
    args = [torch.from_numpy(a).to(device) for a in arrays]

    def swarm_once():
        return SW.decode_seeded(*args, cap=cap, max_out=CHUNK)

    with _watchdog(min(120, remaining() - 10), "swarm verify"):
        out, produced, bad = swarm_once()
        out_np, produced_np = out.cpu().numpy(), produced.cpu().numpy()
    if bool(bad.any()):
        raise ValueError("swarm decode: bad lanes")
    for k, (body, osz) in enumerate(zip(bodies, out_sizes)):
        if produced_np[k] < osz or out_np[k, :osz].tobytes() != _inflate_raw(body, osz):
            raise ValueError(f"swarm decode mismatch on lane {k}")
    _log("swarm decode byte-exact vs oracle")
    sec, progs, wall = _device_trace_seconds(
        swarm_once, 1, "swarm", min(180, remaining() - 10), device=device,
        expect=("zrs_swarm",))
    out_bytes = sum(out_sizes)
    if sec and progs.get("__wall_clock__"):
        dev["swarm_decode_wallclock_gbps"] = round(out_bytes / sec / 1e9, 5)
    elif _record_trace(dev, "swarm_decode", sec, progs, wall):
        dev["swarm_decode_trace_s"] = round(sec, 6)
        dev["swarm_decode_trace_gbps"] = round(out_bytes / sec / 1e9, 5)
        dev["swarm_decode_lanes"] = len(bodies)
        _log(f"swarm decode device-trace {dev['swarm_decode_trace_gbps']} GB/s "
             f"(busy {dev['swarm_decode_busy_share']})")


def _phase_xla_encode(data, flat, dev, device):
    """The XLA engine's batch (torch stages, no hand-written kernel) at
    its configuration: BATCH chunks of CHUNK bytes, dynamic, no
    dictionary, checked by zlib; then its compress_parallel of the corpus
    (ZRS_TPU_KERNEL unset), whose ratio to zlib the reference's ratio
    child measures."""
    from .ops import lz77
    from .parallel import pipeline as P

    knobs = P._level_knobs(LEVEL)
    arr = np.zeros((BATCH, CHUNK + lz77.PAD), np.uint8)
    nv = np.zeros((BATCH,), np.int32)
    for k in range(BATCH):
        seg = flat[k * CHUNK : (k + 1) * CHUNK]
        arr[k, : seg.shape[0]] = seg
        nv[k] = seg.shape[0]
    dc = torch.from_numpy(arr).to(device)
    nvj = torch.from_numpy(nv).to(device)
    zeros = torch.zeros((BATCH,), dtype=torch.int32, device=device)

    def run_once():
        return P._encode_batch(dc, nvj, zeros, zeros, dict_size=0, n_seeds=0, dynamic=True,
                               kernel_scan=False, **knobs)

    with _watchdog(min(120, remaining() - 10), "xla encode check"):
        _check_blocks(run_once(), arr, nv, np.zeros(BATCH, np.int32), 0, "xla encode")
    _log("xla encode checked by zlib")
    sec, progs, wall = _device_trace_seconds(
        run_once, 1, "encode", min(120, remaining() - 10), device=device)
    nbytes = int(nv.sum())
    if sec and progs.get("__wall_clock__"):
        dev["encode_wallclock_gbps"] = round(nbytes / sec / 1e9, 5)
    elif _record_trace(dev, "encode", sec, progs, wall):
        dev["encode_trace_s_per_batch"] = round(sec, 6)
        dev["encode_trace_gbps"] = round(nbytes / sec / 1e9, 5)
        _log(f"xla encode device-trace {dev['encode_trace_gbps']} GB/s "
             f"({sec * 1e3:.3f} ms/batch, busy {dev['encode_busy_share']})")
    from .parallel.pipeline import compress_parallel

    with _env("ZRS_TPU_KERNEL", None), _watchdog(min(120, remaining() - 10), "xla ratio"):
        comp = compress_parallel(bytes(data), level=LEVEL, chunk_size=CHUNK, device=device)
    if zlib.decompress(comp) != data:
        raise ValueError("the XLA-engine stream does not inflate to the corpus")
    dev["ratio_vs_zlib"] = round(len(comp) / len(zlib.compress(data, LEVEL)), 4)


def _timing(device) -> str:
    if device.type == "cuda":
        return "wall of whole calls on the card, host included (the calls return host bytes)"
    return "wall clock of the plain versions on the CPU, not a device measurement"


def _budgeted(out: dict, key: str, first, timed, reps: int, predicted=None, price=None):
    """One native or sweep row under the budget, into out[key]. `first()`
    is the row's first call and its check; `timed(first's result)` runs
    its reps and returns the row's value. The first call is not started
    when the budget less ROW_MARGIN_S is spent or cannot hold `predicted`
    seconds, and the reps are not run when their price (`price(result,
    first seconds)`, by default `reps` times the first call) does not fit;
    the row is then {"cut_by_budget": True, "first_call_s": ...} (None when
    the first call did not run). A watchdog ends a first call that runs
    past the budget, and it too is cut. Returns the first call's seconds,
    or None when it did not run to its end."""
    left = remaining() - ROW_MARGIN_S
    if left <= 1 or (predicted is not None and predicted > left):
        out[key] = {"cut_by_budget": True, "first_call_s": None}
        if predicted is not None:
            out[key]["predicted_s"] = round(predicted, 3)
        return None
    t0 = time.perf_counter()
    try:
        with _watchdog(left, f"row {key}"):
            got = first()
    except TimeoutError:
        out[key] = {"cut_by_budget": True, "first_call_s": round(time.perf_counter() - t0, 3)}
        return None
    first_s = time.perf_counter() - t0
    cost = price(got, first_s) if price is not None else reps * first_s
    if cost > remaining() - ROW_MARGIN_S:
        out[key] = {"cut_by_budget": True, "first_call_s": round(first_s, 3)}
        return first_s
    try:
        with _watchdog(max(1, remaining() - 5), f"row {key} reps"):
            out[key] = timed(got)
    except TimeoutError:
        out[key] = {"cut_by_budget": True, "first_call_s": round(first_s, 3)}
    return first_s


def _native_section(data, dev, device) -> dict:
    """The `native` entry of `dev`, made on its first use."""
    return dev.setdefault("native", {"available": True, "engines": dict(NATIVE_ENGINES),
                                     "timing": _timing(device), "bytes": len(data)})


def _native_checked(data, stream: bytes, label: str) -> bytes:
    """`stream` when it inflates (raw) to `data`; raises otherwise."""
    if zlib.decompress(stream, -15) != data:
        raise ValueError(f"native {label}: the stream does not inflate to the corpus")
    return stream


def _phase_native_levels(data, dev, device, tick=lambda: None):
    """bench.py's bench_native compress rows: deflate_chunk of the corpus
    at levels 0-9 through the port's `native` facade on `device` (after
    the decode sweep: the costliest rows), each level priced at twice the
    last one's first call, its first call checked against stdlib zlib;
    `tick()` after each row hands the result so far to the parent."""
    from . import native

    n = len(data)
    comp = _native_section(data, dev, device).setdefault("compress", {})
    last = None
    for lvl in LEVELS_SWEEP:
        def first(l=lvl):
            return _native_checked(data, native.deflate_chunk(data, level=l, final=True,
                                                              device=device), f"level {l}")

        def timed(raw, l=lvl):
            t = _time_median(lambda: native.deflate_chunk(data, level=l, final=True,
                                                          device=device),
                             reps=5 if l in LEVELS_MATRIX else 2)
            z = zlib.compress(data, l)  # zlib stream = 2-byte header + raw + 4-byte adler32
            return {"gbps": round(n / t / 1e9, 4),
                    "ratio_vs_zlib": round(len(raw) / (len(z) - 6), 4),
                    "bit_exact": raw == z[2:-4]}

        fs = _budgeted(comp, str(lvl), first, timed, 5 if lvl in LEVELS_MATRIX else 2,
                       predicted=None if last is None else 2 * last)
        last = fs if fs is not None else last
        tick()


def _phase_native(data, dev, device, tick=lambda: None):
    """bench.py's bench_native through the port's `native` facade on
    `device`, cheapest rows first: parallel_compress, QUICK, MEDIUM4-6,
    inflate_raw, inflate_parallel and the speculative row (the speculative
    phase's number, that phase run here when it has not run); the level
    rows are `_phase_native_levels`. Every row is checked against stdlib
    zlib on its first call; `tick()` after each row hands the result so
    far to the parent."""
    from . import native

    n = len(data)
    nat = _native_section(data, dev, device)
    zstreams = {}

    def zref(level: int) -> bytes:  # stdlib zlib of the corpus, as bench_cpu makes it
        if level not in zstreams:
            zstreams[level] = zlib.compress(data, level)
        return zstreams[level]

    def checked(stream: bytes, label: str) -> bytes:
        return _native_checked(data, stream, label)

    pc = nat.setdefault("parallel_compress", {})
    for lvl in LEVELS_MATRIX:
        def par(l=lvl):
            return native.deflate_parallel(data, level=l, chunk_size=CHUNK, prime_dict=True,
                                           device=device)

        _budgeted(pc, str(lvl), lambda p=par, l=lvl: checked(p(), f"deflate_parallel {l}"),
                  lambda pout, p=par, l=lvl: {
                      "gbps": round(n / _time_median(p, reps=3) / 1e9, 4),
                      "ratio_vs_zlib": round(len(pout) / (len(zref(l)) - 6), 4)}, 3)
        tick()

    def quick():
        return native.deflate_chunk(data, level=native.QUICK, final=True, device=device)

    _budgeted(nat, "quick", lambda: checked(quick(), "QUICK"), lambda q: {
        "gbps": round(n / _time_best(quick, reps=2) / 1e9, 4),
        "ratio_vs_zlib1": round(len(q) / (len(zref(1)) - 6), 4)}, 2)
    tick()
    med = nat.setdefault("medium", {})
    for mlvl, zl in ((native.MEDIUM4, 4), (native.MEDIUM5, 5), (native.MEDIUM6, 6)):
        def medium(lv=mlvl):
            return native.deflate_chunk(data, level=lv, final=True, device=device)

        _budgeted(med, str(zl), lambda m=medium, zl=zl: checked(m(), f"MEDIUM{zl}"),
                  lambda m, f=medium, zl=zl: {
                      "gbps": round(n / _time_best(f, reps=2) / 1e9, 4),
                      "ratio_vs_zlib": round(len(m) / (len(zref(zl)) - 6), 4)}, 2)
        tick()

    c = zlib.compressobj(LEVEL, zlib.DEFLATED, -15)
    raw6 = c.compress(data) + c.flush()

    def inflate_raw():
        return native.inflate_raw(raw6, n, device=device)

    def inflate_first():
        if inflate_raw()[0] != data:
            raise ValueError("native inflate_raw: not the corpus")

    _budgeted(nat, "inflate_gbps", inflate_first,
              lambda _r: round(n / _time_median(inflate_raw, reps=5) / 1e9, 4), 5)
    tick()

    def indexed():
        """The indexed body, one deflate_chunk a CHUNK (the reference's),
        and inflate_parallel's check, timed apart."""
        body, index = bytearray(), []
        n_chunks = -(-n // CHUNK)
        for k in range(n_chunks):
            seg = data[k * CHUNK : (k + 1) * CHUNK]
            part_ = native.deflate_chunk(seg, level=LEVEL, final=(k == n_chunks - 1),
                                         device=device)
            index.append((len(body), len(part_), len(seg)))
            body.extend(part_)
        body = bytes(body)
        t0 = time.perf_counter()
        if native.inflate_parallel(body, index, device=device) != data:
            raise ValueError("native inflate_parallel: not the corpus")
        return body, index, time.perf_counter() - t0

    _budgeted(nat, "parallel_inflate_gbps", indexed,
              lambda r: round(n / _time_best(
                  lambda: native.inflate_parallel(r[0], r[1], device=device)) / 1e9, 4),
              3, price=lambda r, _s: 3 * r[2])
    tick()
    key = "speculative_inflate_gbps" if device.type == "cuda" else \
        "speculative_inflate_wallclock_gbps"
    if key not in dev:
        _phase_speculative(data, dev, device)
    nat["speculative_inflate_gbps"] = dev[key]
    tick()


def _phase_decode_sweep(data, dev, device, tick=lambda: None):
    """bench.py's bench_decode_sweep: the port's models.stream.Inflate (IS
    on the card, its plain version on the CPU) fed a zlib-6 stream of the
    corpus's first 4 MiB (256 KiB below 2^10) in 2^N-byte pieces, N = 4..24,
    the median MB/s of 3 runs (the first is the row's check and prices the
    other two), then pure_engine_2^14: the host Inflator once at 2^14."""
    from .config import InflateConfig, InflateFlush
    from .models.inflate import Inflator
    from .models.stream import Inflate

    sweep = dev.setdefault("decode_sweep", {"engines": dict(SWEEP_ENGINES),
                                            "timing": _timing(device)})
    slice_ = bytes(data[: 4 * 1024 * 1024])
    small = slice_[: 256 * 1024]
    z, zs = zlib.compress(slice_, LEVEL), zlib.compress(small, LEVEL)
    for nbits in range(4, 25):
        step = 1 << nbits
        sl, zz = (small, zs) if nbits < 10 else (slice_, z)

        def once(sl=sl, zz=zz, step=step):
            t0 = time.perf_counter()
            inf = Inflate(device=device)
            produced = 0
            for i in range(0, len(zz), step):
                _st, _consumed, chunk = inf.decompress(zz[i : i + step], None)
                produced += len(chunk)
            if produced != len(sl):
                raise ValueError(f"decode sweep 2^{step.bit_length() - 1}: {produced} bytes "
                                 f"of {len(sl)}")
            return time.perf_counter() - t0

        def timed(t1, sl=sl, once=once):
            times = sorted([t1, once(), once()])
            return round(len(sl) / times[1] / 1e6, 2)  # median MB/s

        _budgeted(sweep, f"2^{nbits}", once, timed, 2)
        tick()

    def pure():
        t0 = time.perf_counter()
        inf = Inflator(InflateConfig(window_bits=15))
        produced = 0
        for i in range(0, len(zs), 1 << 14):
            _rc, _c, chunk = inf.inflate(zs[i : i + (1 << 14)], None, InflateFlush.NO_FLUSH)
            produced += len(chunk)
        if produced != len(small):
            raise ValueError("decode sweep: the host Inflator fell short")
        return round(len(small) / (time.perf_counter() - t0) / 1e6, 2)

    _budgeted(sweep, "pure_engine_2^14", pure, lambda v: v, 0)
    tick()


def bench_device(data: bytes, emit=None, only=None, device=None) -> dict:
    """The device phases in the reference's order, each gated on
    remaining() so that the bench finishes inside its budget; a phase that
    fails or is skipped lands in PHASE_ERRORS. `emit(dev)` is called after
    every phase. `device` is the GPU when None (it raises when there is
    none); "cpu" runs the plain versions, with wall-clock numbers only."""
    device = _device.resolve_device(device)
    flat = np.frombuffer(data, np.uint8)
    dev = {}
    if device.type == "cuda":
        with _phase("device:build"):
            _device.build()
    seeded = {}

    def with_seeds(fn):
        def run():
            if "stream" not in seeded:
                with _phase("device:seeded_stream"):
                    seeded["stream"] = _seeded_stream(data, device)
            fn(seeded["stream"], dev, device)
        return run

    def tick():
        if emit is not None:
            emit(dev)

    phases = [
        ("kernel_encode", 30, lambda: _phase_kernel_encode(data, flat, dev, device)),
        ("vector_decode", 60, with_seeds(_phase_vector)),
        ("inflate_kernel", 30, lambda: _phase_inflate_kernel(data, dev, device)),
        ("foreign_kernel", 60, lambda: _phase_foreign_kernel(data, dev, device)),
        ("speculative", 20, lambda: _phase_speculative(data, dev, device)),
        ("swarm", 60, with_seeds(_phase_swarm)),
        ("kernel_ratio", 40, lambda: _phase_kernel_ratio(data, dev, device)),
        ("xla_encode", 40, lambda: _phase_xla_encode(data, flat, dev, device)),
        # the native rows cheapest first, the decode sweep, then the level
        # sweep: each row is budgeted on its own (cut_by_budget, no skip)
        ("native", 20, lambda: _phase_native(data, dev, device, tick)),
        ("decode_sweep", 20, lambda: _phase_decode_sweep(data, dev, device, tick)),
        ("native_levels", 0, lambda: _phase_native_levels(data, dev, device, tick)),
    ]
    for name, need, fn in phases:
        if only is not None and name not in only:
            continue
        if remaining() < need:
            PHASE_ERRORS[name] = f"skipped: {remaining():.0f}s left < {need}s needed"
            _log(f"{name} {PHASE_ERRORS[name]}")
            continue
        try:
            with _phase(f"device:{name}"):
                fn()
        except Exception as e:  # a phase's failure is recorded; the next runs
            PHASE_ERRORS[name] = f"{type(e).__name__}: {str(e)[:300]}"
            _log(f"{name} phase failed: {PHASE_ERRORS[name]}")
        tick()
    return dev


def _device_child_main(only=None) -> int:
    """The killable device child: run the device phases (those named in
    `only`, or all) and print 'DEVPART <json>' after every one, and after
    every native and sweep row (the parent merges the last one received).
    Exits 1 when there is no CUDA device."""
    card = {"kind": torch.cuda.get_device_name(0) if torch.cuda.is_available() else None}

    def emit(dev):
        print("DEVPART " + json.dumps({"dev": dev, "phase_seconds": PHASE_SECONDS,
                                       "phase_errors": PHASE_ERRORS, "card": card}),
              flush=True)

    data = load_corpus()
    dev = {}
    try:
        dev = bench_device(data, emit=emit, only=only)
    except Exception as e:  # no device, or a failed build: recorded for the parent
        PHASE_ERRORS["device"] = f"{type(e).__name__}: {str(e)[:300]}"
        _log(f"device phases failed: {PHASE_ERRORS['device']}")
    emit(dev)
    return 1 if "device" in PHASE_ERRORS else 0


def _compose_result(result, device, cpu, phase_errors=None, card=None):
    """Recompute the derived headline fields into `result` (before every
    snapshot; the last printed line wins)."""
    base6 = cpu["compress"][str(LEVEL)]["gbps"] if cpu else None
    headline = device.get("kernel_encode_trace_gbps") or 0.0
    headline_src = VALUE_SOURCE if headline else "no device measurement"
    if not headline and device.get("kernel_encode_wallclock_gbps"):
        headline = device["kernel_encode_wallclock_gbps"]
        headline_src = "wall-clock dispatch loop (profiler unavailable)"
    if not headline and device.get("kernel_e2e_wall_gbps"):
        headline = device["kernel_e2e_wall_gbps"]
        headline_src = "e2e wall incl host (no device trace landed yet)"
    shares = {p: device[f"{k}_busy_share"] for p, k in (
        ("kernel_encode", "kernel_encode"), ("vector_decode", "vector_decode"),
        ("inflate_kernel", "inflate_kernel"), ("foreign_kernel", "foreign_kernel_decode"),
        ("swarm", "swarm_decode"), ("xla_encode", "encode"),
    ) if f"{k}_busy_share" in device}
    result.update(
        {
            "value": round(headline, 5),
            "value_source": headline_src,
            "vs_baseline": round(headline / base6, 4) if base6 else None,
            "ratio_vs_zlib": (
                device.get("kernel_ratio_vs_zlib")
                if device.get("kernel_ratio_vs_zlib") is not None
                else device.get("ratio_vs_zlib")
            ),
            "measurement_note": (
                "value = level-6 kernel-engine encode GB/s from the torch.profiler "
                "CUDA trace (union of kernel, memcpy and memset intervals over a "
                "dispatch); device_busy_share = those seconds over the wall of the "
                "traced reps. cpu_zlib is single-thread stdlib zlib on the same host."
            ),
            "card": card,
            "device": {k: v for k, v in device.items() if k not in SECTIONS},
            "device_busy_share": shares,
            "device_phase_errors": phase_errors or {},
            "device_unreachable": not device,
            "native": device.get("native") or {
                "available": False, "reason": "the device child ran no native row"},
            "cpu_zlib": cpu,
            "host_stream_decode_mbps_by_input_chunk": device.get("decode_sweep") or {
                "available": False, "reason": "the device child ran no decode sweep row"},
            "phase_seconds": PHASE_SECONDS,
            "budget_s": BUDGET,
            "elapsed_s": round(time.monotonic() - T0, 1),
        }
    )
    return result


def _number(v):
    """A measured rate, or None for a row cut by the budget."""
    return v if isinstance(v, (int, float)) else None


def _compact_result(result, device):
    """The headline as a single JSON line of under 500 bytes, with the
    reference's keys; the full result is printed on the line above it."""
    native = result.get("native") or {}
    src_tag = result.get("value_source", "")
    if result.get("device_unreachable"):
        src_tag = "DEVICE UNREACHABLE (no CUDA device): value is not a measurement"
    compact = {
        "metric": result["metric"],
        "value": result["value"],
        "unit": result["unit"],
        "value_source": src_tag[:80],
        "vs_baseline": result.get("vs_baseline"),
        "kernel_ratio": result.get("ratio_vs_zlib"),
        "vector_decode_gbps": device.get("vector_decode_trace_gbps"),
        "e2e_wall_gbps": (
            device.get("kernel_e2e_steady_gbps")
            or device.get("kernel_e2e_wall_gbps")
        ),
        "native_inflate_gbps": _number(native.get("inflate_gbps")),
        "parallel_inflate_gbps": _number(native.get("parallel_inflate_gbps")),
        "elapsed_s": result.get("elapsed_s"),
    }
    if len(json.dumps(compact)) >= 500:  # drop optional keys in order
        for k in ("elapsed_s", "parallel_inflate_gbps",
                  "native_inflate_gbps", "e2e_wall_gbps"):
            compact.pop(k, None)
            if len(json.dumps(compact)) < 500:
                break
    return compact


def _run_device_subprocess(device, errors, card, snapshot):
    """Run the device phases in a killable child (a fresh interpreter,
    never a fork of a process that has touched CUDA), merging every
    DEVPART line into `device`, `errors` and `card` and snapshotting at
    once, so that the final kill loses nothing already measured."""
    deadline = remaining() - 30
    if deadline < 30:
        errors["device"] = "skipped: no budget left for the device child"
        _log(errors["device"])
        return
    env = dict(os.environ)
    env["ZRS_BENCH_BUDGET_S"] = str(max(30, int(deadline - 10)))
    root = str(Path(__file__).resolve().parent.parent)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
    args = [sys.executable, "-m", "zlib_rs_tpu_torch.bench", "--device-child"]
    proc = subprocess.Popen(args, stdout=subprocess.PIPE, stderr=sys.stderr, text=True,
                            env=env)

    def reader():
        for line in proc.stdout:
            if line.startswith("DEVPART "):
                try:
                    part = json.loads(line[8:])
                except json.JSONDecodeError:
                    continue
                device.update(part.get("dev", {}))
                errors.update(part.get("phase_errors", {}))
                card.update(part.get("card", {}))
                PHASE_SECONDS.update(part.get("phase_seconds", {}))
                snapshot()

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    try:
        proc.wait(timeout=max(1, deadline))
        _log(f"device subprocess finished (rc {proc.returncode})")
    except subprocess.TimeoutExpired:
        errors["device"] = "the device child hit the hard deadline: SIGKILL"
        _log(errors["device"])
        proc.kill()
        proc.wait(timeout=10)
    t.join(timeout=10)


def main():
    result = {
        "metric": f"parallel_deflate_level{LEVEL}_device_gbps",
        "value": 0.0,
        "unit": "GB/s",
        "vs_baseline": None,
    }
    device, errors, card = {}, {}, {}
    state = {"cpu": None}
    lock = threading.Lock()

    def snapshot():
        # full line, then the compact line: the last stdout line is always
        # a JSON object under 500 bytes
        with lock:
            _compose_result(result, device, state["cpu"], errors, card)
            print(json.dumps(result), flush=True)
            print(json.dumps(_compact_result(result, device)), flush=True)

    try:
        data = load_corpus()
        result["corpus"] = "mixed tar (reference test data when named, system binaries)"
        result["corpus_bytes"] = len(data)
        card["nvidia_smi"] = nvidia_smi()
        _log(f"corpus {len(data)} bytes; card {card['nvidia_smi']}; budget {BUDGET:.0f}s")
        snapshot()  # the first parseable line lands before any slow work
        with _phase("cpu"):
            state["cpu"], _zstreams = bench_cpu(data)
        _log(f"cpu zlib: {state['cpu']}")
        snapshot()
        with _phase("device_total"):
            _run_device_subprocess(device, errors, card, snapshot)
    except Exception as e:  # the last line must still be printed
        _log(f"bench main failed: {type(e).__name__}: {e}")
    finally:
        if not device:
            _log("DEVICE UNREACHABLE for this entire run: the value field is 0.0, "
                 "NOT a measurement")
        snapshot()


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--device-child":
        phases = [a[len("--phases="):] for a in sys.argv[2:] if a.startswith("--phases=")]
        sys.exit(_device_child_main(tuple(phases[0].split(",")) if phases else None))
    main()
