"""A short call for the stream kernels on one H100: IS (csrc/istream.cu)
and DS (the zrs_dstream_pump entry of csrc/exact_deflate.cu).

Builds both sources once with `-Xptxas -v` and prints each kernel's
registers, stack and spills; builds them as the port does; holds IS (its
whole-block launch, the handle's route) and DS against their plain
versions on pump scripts over 64 KiB of /usr/bin/python3 (IS: zlib levels
0, 1, 6, 9 at random boundaries and bounded output; DS: levels 1, 6, 9
under random flushes); checks that EX's chunk path still gives a stream
zlib reads (levels 1, 6, 9); times IS's whole-block launch against the
one-warp launch (`zrs_istream_advance`) on the same saved handle states,
every 128 KiB pump of a zlib-6 stream, the two in turn (block, warp, warp,
block) by CUDA events, their output digests equal; and times one stream of
1 MiB through `native.RawDeflateStream` at levels 1 and 6 and
`native.RawInflateStream`, in 128 KiB pumps, host clock. Prints the
card's name and power limit first. Its last line is OK or FAIL.

    python3 stream_probe.py    # one H100, about a minute
"""

import hashlib
import os
import random
import subprocess
import sys
import time
import zlib

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from zlib_rs_tpu_torch import _device, native  # noqa: E402
from zlib_rs_tpu_torch.ops.kernels import dstream_kernel as DK  # noqa: E402
from zlib_rs_tpu_torch.ops.kernels import istream_kernel as ISK  # noqa: E402
from zlib_rs_tpu_torch.parallel import chunk_deflate as CD  # noqa: E402

PUMP = 1 << 17


def is_pump_times(h, comp: bytes, pump: int = PUMP):
    """Every `pump`-byte pump of `comp` through CUDA handle `h`: the
    block's and the warp's launch from the same saved state, in turn, by
    CUDA events, then one more block launch that gathers its counters.
    Returns [(block ms, warp ms, bytes out, counters)] and whether every
    pump's output and record agreed."""
    rows, same = [], True
    scratch = torch.empty(ISK.SCRATCH, dtype=torch.int32, device=h.device)
    stats = torch.zeros(ISK.STATS, dtype=torch.int64, device=h.device)
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for i in range(0, len(comp), pump):
        h._append(comp[i : i + pump])
        h._compact()
        h._room(max(ISK.MIN_ROOM, 8 * pump))
        state = (h.rec.copy(), h.tables.clone(), h.outbuf.clone())
        res = {}
        for who in ("block", "warp", "warp", "block", "stats"):
            h.rec[:] = state[0]
            h.tables.copy_(state[1])
            h.outbuf.copy_(state[2])
            h.rec_dev.copy_(torch.from_numpy(h.rec))
            stats.zero_()
            torch.cuda.synchronize()
            e0.record()
            if who == "warp":
                rc = ISK._fn_warp()(_device.ptr(h.rec_dev), _device.ptr(h.tables),
                                    _device.ptr(h.inbuf), _device.ptr(h.outbuf),
                                    _device.stream_of(h.tables))
            else:
                rc = ISK._fn()(_device.ptr(h.rec_dev), _device.ptr(h.tables),
                               _device.ptr(h.inbuf), h.inbuf.numel() // 4,
                               _device.ptr(h.outbuf), _device.ptr(scratch),
                               _device.ptr(stats) if who == "stats" else None,
                               _device.stream_of(h.tables))
            e1.record()
            _device.check(rc, "istream")
            torch.cuda.synchronize()
            rec = h.rec_dev.cpu().numpy().copy()
            op0 = int(state[0][ISK.R_OP]) - int(state[0][ISK.R_BASE])
            op1 = int(rec[ISK.R_OP]) - int(rec[ISK.R_BASE])
            dig = hashlib.sha256(h.outbuf[op0:op1].cpu().numpy().tobytes()).hexdigest()
            res.setdefault(who, []).append((e0.elapsed_time(e1), dig, rec.tolist()))
        outs = {r[1] for v in res.values() for r in v}
        recs = {tuple(r[2][:12]) for v in res.values() for r in v}
        same &= len(outs) == 1 and len(recs) == 1
        h.rec[:] = res["block"][-1][2]
        if h.rec[ISK.R_ROOM]:
            raise AssertionError("the timed pump ran out of room")
        rows.append((sum(r[0] for r in res["block"]) / 2, sum(r[0] for r in res["warp"]) / 2,
                     int(h.rec[ISK.R_OP]) - int(state[0][ISK.R_OP]),
                     dict(zip(ISK.STAT_NAMES, stats.cpu().tolist()))))
        h.served = int(h.rec[ISK.R_OP])
    return rows, same


def main() -> int:
    if not torch.cuda.is_available():
        print("stream_probe: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    nvcc = _device._nvcc()
    out_dir = _device.BUILD / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    for name in ("istream", "exact_deflate"):
        r = subprocess.run([nvcc, *_device.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                            str(out_dir / f"{name}.so"), str(_device.CSRC / f"{name}.cu")],
                           capture_output=True, text=True)
        print(name, "rc", r.returncode)
        print("\n".join(ln for ln in (r.stdout + r.stderr).splitlines()
                        if "registers" in ln or "error" in ln or "spill" in ln
                        or ("Compiling entry" in ln and name == "istream")))
    t0 = time.time()
    print("build", _device.build(("istream", "exact_deflate")), time.time() - t0)
    cuda = torch.device("cuda")
    rng = random.Random(3)
    corpus = open("/usr/bin/python3", "rb").read()[: 1 << 20]
    if len(corpus) < 1 << 20:
        corpus = (corpus * 64)[: 1 << 20]
    d = corpus[200000 : 200000 + 65536]
    ok = True
    for lvl in (0, 1, 6, 9):
        c = zlib.compressobj(lvl, 8, -15)
        comp = c.compress(d) + c.flush()
        hc, hp = ISK.Handle(cuda), ISK.Handle("cpu")
        pos, res_c, res_p = 0, [], []
        while pos < len(comp):
            n = rng.choice([1, 7, 100, 3000, 20000])
            cap = rng.choice([1, 500, 1 << 22])
            res_c.append(hc.pump(comp[pos : pos + n], cap))
            res_p.append(hp.pump(comp[pos : pos + n], cap))
            pos += n
        for _ in range(3):
            res_c.append(hc.pump(b"", 1 << 22))
            res_p.append(hp.pump(b"", 1 << 22))
        same = res_c == res_p
        got = b"".join(o for o, _ in res_c)
        print("IS level", lvl, "pumps", len(res_c), "same", same, "roundtrip", got == d,
              "launches", ISK.launches["istream"])
        ok &= same and got == d
    for lvl in (1, 6, 9):
        sc, sp = DK.Handle(lvl, cuda), DK.Plain(lvl)
        pos, oc, op = 0, [], []
        while pos < len(d):
            n = rng.choice([1, 100, 4000, 20000])
            fl = rng.choice([0, 0, 0, 2, 3])
            oc.append(sc.pump(d[pos : pos + n], fl))
            op.append(sp.pump(d[pos : pos + n], fl))
            pos += n
        oc.append(sc.pump(b"", 4))
        op.append(sp.pump(b"", 4))
        same = oc == op
        print("DS level", lvl, "pumps", len(oc), "same", same, "roundtrip",
              zlib.decompress(b"".join(oc), -15) == d, "launches", DK.launches["dstream"])
        ok &= same
    for lvl in (1, 6, 9):
        r = CD.deflate_parallel(corpus, lvl, device=cuda)
        print("EX deflate_parallel", lvl, zlib.decompress(r, -15) == corpus, len(r))
    comp6 = zlib.compressobj(6, 8, -15)
    comp6 = comp6.compress(corpus) + comp6.flush()
    rows, same = is_pump_times(ISK.Handle(cuda), comp6)
    tb, tw = sum(r[0] for r in rows), sum(r[1] for r in rows)
    print(f"IS pumps of 128 KiB over /usr/bin/python3's zlib-6 stream ({len(comp6)} bytes): "
          f"{len(rows)} pumps, block launch {tb:.3f} ms, one-warp launch {tw:.3f} ms in all, "
          f"outputs and records equal {same}")
    for k, (b, w, n, st) in enumerate(rows):
        print(f"  pump {k}: {n} bytes out, block {b:.3f} ms, warp {w:.3f} ms; {st}")
    ok &= same
    for pump in (1 << 4, 1 << 6, 1 << 8, 1 << 10, 1 << 12, 1 << 14):
        rows, same = is_pump_times(ISK.Handle(cuda), comp6[: min(1 << 17, 512 * pump)], pump)
        tb, tw = sum(r[0] for r in rows), sum(r[1] for r in rows)
        print(f"IS pumps of {pump} bytes over the stream's first {len(rows) * pump} bytes: "
              f"{len(rows)} pumps, "
              f"block launch {tb / len(rows):.4f} ms, one-warp launch {tw / len(rows):.4f} ms a "
              f"pump, outputs and records equal {same}")
        ok &= same
    for lvl in (1, 6):
        s = native.RawDeflateStream(lvl, device=cuda)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = [s.pump(corpus[i : i + PUMP], 0) for i in range(0, len(corpus), PUMP)]
        out.append(s.pump(b"", 4))
        t = time.perf_counter() - t0
        z = zlib.compressobj(lvl, 8, -15)
        ref = z.compress(corpus) + z.flush()
        print("DS stream", lvl, "MB/s", len(corpus) / t / 1e6, "equal zlib", b"".join(out) == ref)
    s = native.RawInflateStream(device=cuda)
    t0 = time.perf_counter()
    out = [s.pump(comp6[i : i + PUMP], None)[0] for i in range(0, len(comp6), PUMP)]
    t = time.perf_counter() - t0
    print("IS stream MB/s", len(corpus) / t / 1e6, b"".join(out) == corpus, s.done)
    print("OK" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
