"""The port's command line (`python -m zlib_rs_tpu_torch`, zlib_rs_tpu_torch/cli.py)
and its one-shot API (models/oneshot.py) against the JAX package on the CPU.

The host route is held against `zlib_rs_tpu.models.deflate.compress` under the
same DeflateConfig rather than the JAX CLI, whose host route takes the C++
native engine when it is built; the cuda route (`--device cpu`: the kernels'
plain versions, the XLA engine's torch stages) against the JAX
`compress_parallel` with the same arguments, with XLA's own 2^len weights
swapped in as in tests/test_torch_pipeline.py; the native route (--engine
native, --quick, --medium, auto from the threshold, and -d under native and
auto; `--device cpu`: EX's and SP2's plain versions) against the JAX CLI
with its C++ native engine built. Every comparison is exact."""

import gzip
import subprocess
import sys
import zlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import native_build  # noqa: F401  (the JAX package's native library, built once under a lock)

import zlib_rs_tpu.cli as jcli
import zlib_rs_tpu.models.deflate as jdeflate
import zlib_rs_tpu.models.oneshot as joneshot
import zlib_rs_tpu.native as jnative
import zlib_rs_tpu.parallel.pipeline as jp
from zlib_rs_tpu.config import DeflateConfig as JDeflateConfig
import zlib_rs_tpu_torch as zt
from zlib_rs_tpu_torch import cli
from zlib_rs_tpu_torch.models import oneshot
from zlib_rs_tpu_torch.ops import dynhuff as td

# the test workers share the cores, and an oversubscribed OpenMP pool spin-waits
torch.set_num_threads(1)

_BASH = open("/bin/bash", "rb").read()
SLICE = _BASH[300_000 : 300_000 + 40_001]
CHUNK = 16_384  # three chunks of the XLA engine
HOST = _BASH[100_000 : 100_000 + 12_001]
ROOT = Path(__file__).resolve().parents[1]
FORMATS = {"gzip": 31, "zlib": 15, "raw": -15}
DECODE = {"gzip": gzip.decompress, "zlib": zlib.decompress,
          "raw": lambda b: zlib.decompress(b, -15)}
_JAX = {}


@pytest.fixture(autouse=True)
def xla_engine(monkeypatch):
    # ZRS_TPU_KERNEL unset: both packages' default, the XLA engine
    for name in ("ZRS_TPU_KERNEL", "ZRS_TPU_HOP_IL", "ZRS_TPU_CHAIN"):
        monkeypatch.delenv(name, raising=False)
    table = np.asarray(jnp.exp2(jnp.arange(16, dtype=jnp.float32))).copy()
    monkeypatch.setattr(td, "EXP2_LEN", torch.from_numpy(table))


def _jax_parallel(fmt: str) -> bytes:
    if fmt not in _JAX:
        _JAX[fmt] = jp.compress_parallel(SLICE, level=6, window_bits=FORMATS[fmt],
                                         chunk_size=CHUNK)
    return _JAX[fmt]


def _run(capsysbinary, argv):
    rc = cli.main(argv)
    out = capsysbinary.readouterr()
    return rc, out.out, out.err.decode()


@pytest.fixture
def src(tmp_path):
    p = tmp_path / "in.bin"
    p.write_bytes(SLICE)
    return p


# ---------------------------------------------------------------------------
# compress: the host route and the cuda route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("level", [1, 6, 9])
@pytest.mark.parametrize("fmt", ["gzip", "zlib", "raw"])
def test_host_route_equals_jax_host_engine(capsysbinary, tmp_path, fmt, level):
    p = tmp_path / "h.bin"
    p.write_bytes(HOST)
    rc, out, _err = _run(capsysbinary, ["-c", "--engine", "host", "--format", fmt,
                                        f"-{level}", str(p)])
    want = jdeflate.compress(HOST, JDeflateConfig(level=level, window_bits=FORMATS[fmt]))
    assert rc == 0 and out == want
    assert DECODE[fmt](out) == HOST


@pytest.mark.parametrize("fmt", ["gzip", "zlib", "raw"])
def test_cuda_route_equals_jax_compress_parallel(capsysbinary, src, fmt):
    rc, out, _err = _run(capsysbinary, ["-c", "--engine", "cuda", "--device", "cpu",
                                        "--chunk", str(CHUNK), "--format", fmt, str(src)])
    assert rc == 0 and out == _jax_parallel(fmt)
    assert DECODE[fmt](out) == SLICE


def test_tpu_is_cuda(capsysbinary, src):
    assert cli._choose_engine("tpu", 1) == "cuda"
    rc, out, _err = _run(capsysbinary, ["-c", "--engine", "tpu", "--device", "cpu",
                                        "--chunk", str(CHUNK), str(src)])
    assert rc == 0 and out == _jax_parallel("gzip")


def _jax_cli(capsysbinary, argv) -> bytes:
    """The JAX CLI's stdout for argv, with its C++ native engine built."""
    assert jnative.available()
    capsysbinary.readouterr()
    assert jcli.main(argv) == 0
    return capsysbinary.readouterr().out


def test_auto_picks_cuda_at_the_threshold(monkeypatch, capsysbinary, src):
    # the port's threshold is measured on the H100 (cli_crossover.py); from
    # it up auto takes the native engine's port, as the reference takes its
    # native engine whenever it is built
    assert (cli.TPU_THRESHOLD, jcli.TPU_THRESHOLD) == (64 * 1024, 4 * 1024 * 1024)
    assert cli._choose_engine("auto", cli.TPU_THRESHOLD) == "native"
    assert cli._choose_engine("auto", cli.TPU_THRESHOLD - 1) == "host"
    assert [cli._choose_engine(e, 10**9) for e in ("host", "cuda", "native")] == \
        ["host", "cuda", "native"]
    # a small threshold sends the slice to the native route: the reference's
    # auto with native built, chunk for chunk
    monkeypatch.setattr(cli, "TPU_THRESHOLD", len(SLICE))
    want = _jax_cli(capsysbinary, ["-c", "--engine", "auto", "--chunk", str(CHUNK), str(src)])
    rc, out, _err = _run(capsysbinary, ["-c", "--device", "cpu", "--chunk", str(CHUNK),
                                        str(src)])
    assert rc == 0 and out == want and gzip.decompress(out) == SLICE
    monkeypatch.setattr(cli, "TPU_THRESHOLD", len(SLICE) + 1)
    rc, out, _err = _run(capsysbinary, ["-c", "--device", "cpu", str(src)])
    assert rc == 0 and out == jdeflate.compress(SLICE, JDeflateConfig(level=6, window_bits=31))


def test_cuda_route_without_a_gpu_fails(monkeypatch, capsysbinary, src):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out, err = _run(capsysbinary, ["-c", "--engine", "cuda", str(src)])
    assert rc == 1 and out == b"" and "CUDA device" in err


@pytest.mark.parametrize("argv", [["--quick"], ["--medium", "-5"], ["--engine", "native", "-9"]])
def test_native_modes_exit_1(capsysbinary, src, argv):
    # the native modes run on the card's port of the native engine (EX's
    # plain version here) and equal the reference CLI's with native built
    # (the name is from the slice where they exited 1)
    want = _jax_cli(capsysbinary, ["-c", "--chunk", str(CHUNK), *argv, str(src)])
    rc, out, _err = _run(capsysbinary, ["-c", "--device", "cpu", "--chunk", str(CHUNK), *argv,
                                        str(src)])
    assert rc == 0 and out == want and gzip.decompress(out) == SLICE


# ---------------------------------------------------------------------------
# decompress
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt,stream", [
    ("gzip", gzip.compress(HOST)),
    ("gzip", gzip.compress(HOST[:5000]) + gzip.compress(HOST[5000:]) + gzip.compress(b"")),
    ("gzip", zlib.compress(HOST)),  # gzip's decode sniffs a zlib stream too
    ("zlib", zlib.compress(HOST, 9)),
    ("raw", zlib.compress(HOST, 1)[2:-4]),
], ids=["gzip", "gzip-members", "gzip-zlib", "zlib", "raw"])
def test_decompress_round_trips(capsysbinary, tmp_path, fmt, stream):
    p = tmp_path / "in.bin.gz"
    p.write_bytes(stream)
    rc, out, _err = _run(capsysbinary, ["-d", "-c", "--format", fmt, str(p)])
    assert rc == 0 and out == HOST


def test_decompress_of_its_own_output(capsysbinary, tmp_path):
    p = tmp_path / "in.bin"
    p.write_bytes(HOST)
    assert cli.main(["-k", "--engine", "host", str(p)]) == 0
    assert cli.main(["-d", "-f", str(tmp_path / "in.bin.gz")]) == 0
    assert p.read_bytes() == HOST
    assert not (tmp_path / "in.bin.gz").exists()


def test_corrupt_input_fails(capsysbinary, tmp_path):
    p = tmp_path / "bad.gz"
    stream = bytearray(gzip.compress(HOST))
    stream[-6] ^= 0xFF  # the crc32
    p.write_bytes(bytes(stream))
    rc, out, err = _run(capsysbinary, ["-d", "-c", str(p)])
    assert rc == 1 and out == b"" and "zlib_rs_tpu_torch" in err


CARD_STREAMS = [
    ("gzip", gzip.compress(HOST)),
    ("gzip", gzip.compress(HOST[:5000]) + gzip.compress(HOST[5000:]) + gzip.compress(b"")),
    ("gzip", zlib.compress(HOST)),
    ("zlib", zlib.compress(HOST, 9)),
    ("raw", zlib.compress(HOST, 1)[2:-4]),
]


@pytest.fixture
def foreign_calls(monkeypatch):
    from zlib_rs_tpu_torch.parallel import inflate as TI

    calls = []
    real = TI.decompress_foreign

    def spy(data, *a, **k):
        calls.append(k.get("device"))
        return real(data, *a, **k)

    monkeypatch.setattr(TI, "decompress_foreign", spy)
    return calls


@pytest.fixture
def native_calls(monkeypatch):
    calls = []
    real = oneshot.card_inflate

    def spy(payload, device):
        calls.append(device)
        return real(payload, device)

    monkeypatch.setattr(oneshot, "card_inflate", spy)
    return calls


@pytest.mark.parametrize("engine", ["cuda", "tpu", "auto"])
@pytest.mark.parametrize("fmt,stream", CARD_STREAMS,
                         ids=["gzip", "gzip-members", "gzip-zlib", "zlib", "raw"])
def test_decompress_on_the_card(monkeypatch, capsysbinary, tmp_path, foreign_calls, native_calls,
                                engine, fmt, stream):
    # auto takes the card from TPU_THRESHOLD input bytes up, as on compress:
    # the native decode (a raw decode a member); cuda the foreign decode
    monkeypatch.setattr(cli, "TPU_THRESHOLD", len(stream))
    p = tmp_path / "in.bin.gz"
    p.write_bytes(stream)
    rc, out, _err = _run(capsysbinary, ["-d", "-c", "--engine", engine, "--device", "cpu",
                                        "--format", fmt, str(p)])
    assert rc == 0 and out == HOST
    members = stream.count(b"\x1f\x8b\x08") if fmt == "gzip" and stream[:2] == b"\x1f\x8b" else 1
    if engine == "auto":
        assert foreign_calls == [] and native_calls == ["cpu"] * members
    else:
        assert foreign_calls == ["cpu"] and native_calls == []


NATIVE_STREAMS = [
    gzip.compress(HOST[:3000]) + gzip.compress(HOST[3000:]) + b"trailing garbage",
    zlib.compress(HOST, 6),
    zlib.compress(HOST, 1)[2:-4],
    gzip.compress(HOST)[:-6],  # a trailer cut inside its crc32
]


@pytest.mark.parametrize("engine", ["native", "auto"])
@pytest.mark.parametrize("k", range(len(NATIVE_STREAMS)),
                         ids=["gzip-members", "zlib", "raw", "cut-trailer"])
def test_native_decompress_equals_the_reference(monkeypatch, capsysbinary, tmp_path,
                                                native_calls, engine, k):
    stream = NATIVE_STREAMS[k]
    fmt = {0: "gzip", 1: "zlib", 2: "raw", 3: "gzip"}[k]
    monkeypatch.setattr(cli, "TPU_THRESHOLD", 0)
    monkeypatch.setattr(jcli, "TPU_THRESHOLD", 0)
    p = tmp_path / "in.gz"
    p.write_bytes(stream)
    argv = ["-d", "-c", "--engine", engine, "--format", fmt, str(p)]
    capsysbinary.readouterr()
    jrc = jcli.main(argv)
    jout = capsysbinary.readouterr().out
    rc, out, err = _run(capsysbinary, [*argv[:-1], "--device", "cpu", str(p)])
    assert native_calls and set(native_calls) == {"cpu"}
    assert (rc, out) == (jrc, jout)
    if k < 3:
        assert rc == 0 and out == HOST
    else:  # native raises; auto hands the stream to the host, which fails too
        assert rc == 1 and out == b"" and "zlib_rs_tpu_torch" in err


@pytest.mark.parametrize("case", ["auto-below", "host", "preset-dict", "other-format"])
def test_decompress_left_to_the_host(monkeypatch, capsysbinary, tmp_path, foreign_calls, case):
    stream, fmt, engine, want = gzip.compress(HOST), "gzip", "cuda", HOST
    if case == "auto-below":
        engine = "auto"
        monkeypatch.setattr(cli, "TPU_THRESHOLD", len(stream) + 1)
    elif case == "host":
        engine = "host"
    elif case == "preset-dict":
        c = zlib.compressobj(6, zlib.DEFLATED, 15, zdict=HOST[:2000])
        stream, fmt = c.compress(HOST) + c.flush(), "zlib"
    else:
        fmt = "zlib"  # a gzip stream named zlib: the host inflater refuses it
    p = tmp_path / "in.bin.gz"
    p.write_bytes(stream)
    rc, out, err = _run(capsysbinary, ["-d", "-c", "--engine", engine, "--device", "cpu",
                                       "--format", fmt, str(p)])
    assert foreign_calls == []
    if case in ("auto-below", "host"):
        assert rc == 0 and out == want
    else:
        assert rc == 1 and out == b"" and "zlib_rs_tpu_torch" in err


def test_decompress_on_the_card_fails_safe(monkeypatch, capsysbinary, tmp_path, foreign_calls):
    p = tmp_path / "bad.gz"
    stream = bytearray(gzip.compress(HOST))
    stream[-6] ^= 0xFF  # the crc32
    p.write_bytes(bytes(stream))
    rc, out, err = _run(capsysbinary, ["-d", "-c", "--engine", "cuda", "--device", "cpu", str(p)])
    assert rc == 1 and out == b"" and "incorrect data check" in err and foreign_calls == ["cpu"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p.write_bytes(gzip.compress(HOST))
    rc, out, err = _run(capsysbinary, ["-d", "-c", "--engine", "cuda", str(p)])
    assert rc == 1 and out == b"" and "CUDA device" in err


# ---------------------------------------------------------------------------
# -k, -f and the refusal to overwrite, as the reference's
# ---------------------------------------------------------------------------


def _files(d: Path) -> dict:
    return {p.name: p.stat().st_size > 0 for p in sorted(d.iterdir())}


@pytest.mark.parametrize("flags,existing", [
    ([], False), (["-k"], False), (["-k"], True), (["-k", "-f"], True), (["-f"], True),
    (["-d", "-k"], False), (["-d"], True),
])
def test_keep_and_force_as_the_reference(tmp_path, flags, existing):
    results = []
    for main, sub in ((cli.main, "port"), (jcli.main, "jax")):
        d = tmp_path / sub
        d.mkdir()
        name = "in.gz" if "-d" in flags else "in.bin"
        (d / name).write_bytes(gzip.compress(HOST) if "-d" in flags else HOST)
        out_name = "in" if "-d" in flags else "in.bin.gz"
        if existing:
            (d / out_name).write_bytes(b"x")
        rc = main([*flags, "--engine", "host", str(d / name)])
        results.append((rc, _files(d), (d / out_name).read_bytes()))
    (rc, files, out), (jrc, jfiles, jout) = results
    assert rc == jrc and files == jfiles
    if rc == 0:
        assert (gzip.decompress(out) if "-d" not in flags else out) == HOST
        assert (gzip.decompress(jout) if "-d" not in flags else jout) == HOST
    else:
        assert out == jout == b"x"


# ---------------------------------------------------------------------------
# the module entry point and the one-shot API
# ---------------------------------------------------------------------------


def test_module_help_and_native_exit(capsysbinary, src):
    help_ = subprocess.run([sys.executable, "-m", "zlib_rs_tpu_torch", "--help"],
                           capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert help_.returncode == 0 and "--engine" in help_.stdout and "native" in help_.stdout
    # --quick runs as a process (EX's plain version under --device cpu) and
    # writes the reference's bytes
    quick = subprocess.run([sys.executable, "-m", "zlib_rs_tpu_torch", "-c", "--quick",
                            "--device", "cpu", str(src)], capture_output=True, cwd=ROOT,
                           timeout=300)
    want = _jax_cli(capsysbinary, ["-c", "--quick", str(src)])
    assert quick.returncode == 0 and quick.stdout == want
    assert src.exists()


@pytest.mark.parametrize("level,window_bits", [(1, 15), (6, 31), (9, -15), (None, 15)])
def test_oneshot_equals_jax_without_native(monkeypatch, level, window_bits):
    monkeypatch.setattr(jnative, "available", lambda: False)
    got = zt.compress(HOST, level, window_bits=window_bits, device="cpu")
    assert got == joneshot.compress(HOST, level, window_bits=window_bits)
    auto = 47 if window_bits > 0 else window_bits
    back = zt.decompress(got, window_bits=auto, device="cpu")
    assert back == joneshot.decompress(got, window_bits=auto) == HOST
    assert zt.compress_bound(len(HOST), level, window_bits=window_bits) == \
        joneshot.compress_bound(len(HOST), level, window_bits=window_bits)


def test_oneshot_uncompress_and_lazy_names():
    assert zt.compress is oneshot.compress and zt.uncompress is oneshot.uncompress
    z = zlib.compress(HOST)
    assert zt.uncompress(z) == joneshot.uncompress(z)
    assert zt.uncompress(z)[1] == HOST
    assert zt.uncompress(z[:-10]) == joneshot.uncompress(z[:-10])
    with pytest.raises(AttributeError):
        zt.not_a_name  # noqa: B018
