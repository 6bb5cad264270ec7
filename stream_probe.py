"""A short first call for the stream kernels on one H100: IS
(csrc/istream.cu) and DS (the zrs_dstream_pump entry of
csrc/exact_deflate.cu).

Builds both sources once with `-Xptxas -v` and prints each kernel's
registers, stack and spills; builds them as the port does; holds IS and
DS against their plain versions on pump scripts over 64 KiB of
/usr/bin/python3 (IS: zlib levels 0, 1, 6, 9 at random boundaries and
bounded output; DS: levels 1, 6, 9 under random flushes); checks that
EX's chunk path still gives a stream zlib reads (levels 1, 6, 9); and
times one stream of 1 MiB through `native.RawDeflateStream` at levels 1
and 6 and `native.RawInflateStream`, in 128 KiB pumps, host clock. Its
last line is OK or FAIL.

    python3 stream_probe.py    # one H100, about a minute
"""

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
                        if "registers" in ln or "error" in ln or "spill" in ln))
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
    for lvl in (1, 6):
        s = native.RawDeflateStream(lvl, device=cuda)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = [s.pump(corpus[i : i + (1 << 17)], 0) for i in range(0, len(corpus), 1 << 17)]
        out.append(s.pump(b"", 4))
        t = time.perf_counter() - t0
        z = zlib.compressobj(lvl, 8, -15)
        ref = z.compress(corpus) + z.flush()
        print("DS stream", lvl, "MB/s", len(corpus) / t / 1e6, "equal zlib", b"".join(out) == ref)
    comp = zlib.compressobj(6, 8, -15)
    comp = comp.compress(corpus) + comp.flush()
    s = native.RawInflateStream(device=cuda)
    t0 = time.perf_counter()
    out = [s.pump(comp[i : i + (1 << 17)], None)[0] for i in range(0, len(comp), 1 << 17)]
    t = time.perf_counter() - t0
    print("IS stream MB/s", len(corpus) / t / 1e6, b"".join(out) == corpus, s.done)
    print("OK" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
