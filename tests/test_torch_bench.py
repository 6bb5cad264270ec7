"""The port's bench module (zlib_rs_tpu_torch/bench.py) against bench.py, the
JAX package's bench, on the CPU: the corpus byte for byte, the compact final
line's keys and size, bench_cpu's result shape; each device phase at a tiny
size through the kernels' plain versions (device="cpu"), checked against
zlib inside the phase and recording wall-clock numbers only; the trace
helper's interval union and kernel names on a synthetic trace; and the
whole module run with no CUDA device, killed and to its end."""

import json
import os
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import bench  # noqa: E402  the JAX package's bench, at the repository root
from zlib_rs_tpu_torch import _device  # noqa: E402
from zlib_rs_tpu_torch import bench as B  # noqa: E402
from zlib_rs_tpu_torch.parallel import swarm_inflate as TS  # noqa: E402
from zlib_rs_tpu_torch.parallel import vector_inflate as TV  # noqa: E402

# the test workers share the cores, and an oversubscribed OpenMP pool spin-waits
torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.fixture
def tiny(monkeypatch):
    """Two chunks a phase, a budget that gates nothing, a clean env."""
    for name, value in (("KB", 2), ("NB", 2), ("CHUNK", 16_384), ("BATCH", 2),
                        ("VECTOR_BYTES", 65_536), ("SWARM_TILE", 2),
                        ("FOREIGN_BYTES", 65_536), ("TARGET_SIZE", 256 * 1024),
                        ("BUDGET", 10_000.0)):
        monkeypatch.setattr(B, name, value)
    for name in ("ZRS_TPU_KERNEL", "ZRS_TPU_VECTOR", "ZRS_VECTOR_TWOPLANE",
                 "ZRS_TPU_HOP_IL", "ZRS_BENCH_TESTDATA"):
        monkeypatch.delenv(name, raising=False)
    data = B.load_corpus()
    return data, np.frombuffer(data, np.uint8)


# ---------------------------------------------------------------------------
# the corpus, the final line, the CPU section
# ---------------------------------------------------------------------------


def test_load_corpus_equals_bench(monkeypatch, tmp_path):
    monkeypatch.setattr(bench, "TARGET_SIZE", 1024 * 1024)  # ZRS_BENCH_TARGET_MB=1
    monkeypatch.setattr(B, "TARGET_SIZE", 1024 * 1024)
    monkeypatch.setenv("ZRS_BENCH_TESTDATA", str(bench.TESTDATA))
    got = B.load_corpus()
    assert len(got) == 1024 * 1024 and got == bench.load_corpus()
    # with the reference's test data present: the same members, in order
    for k, name in enumerate(B.TESTDATA_MEMBERS[:3]):
        (tmp_path / name).write_bytes(bytes([k + 1]) * (20_000 + k))
    monkeypatch.setattr(bench, "TESTDATA", tmp_path)
    monkeypatch.setenv("ZRS_BENCH_TESTDATA", str(tmp_path))
    with_members = B.load_corpus()
    assert with_members == bench.load_corpus() and with_members != got
    assert B.TESTDATA_MEMBERS == ("lcet10.txt", "paper-100k.pdf", "fireworks.jpg",
                                  "issue-169.js")


def _full_result():
    result = {"metric": f"parallel_deflate_level{B.LEVEL}_device_gbps", "value": 0.0,
              "unit": "GB/s", "vs_baseline": None}
    device = {"kernel_encode_trace_gbps": 123.456789012, "kernel_ratio_vs_zlib": 1.003337,
              "vector_decode_trace_gbps": 98.7654321098, "kernel_e2e_steady_gbps": 0.0156789,
              "kernel_e2e_wall_gbps": 0.01234567, "ratio_vs_zlib": 1.065113}
    cpu = {"compress": {str(B.LEVEL): {"gbps": 0.017912345}}}
    return B._compose_result(result, device, cpu, {}, {"nvidia_smi": "NVIDIA H100, 700 W"}), \
        device


def test_compact_result_has_the_reference_keys():
    result, device = _full_result()
    result["native"] = {"inflate_gbps": 1.23456789, "parallel_inflate_gbps": 9.87654321}
    result["elapsed_s"] = 123456.7
    compact = B._compact_result(result, device)
    ref = bench._compact_result(dict(result, value_source="x" * 200), device)
    assert list(compact) == list(ref)
    assert len(json.dumps(compact)) < 500
    assert compact["value"] == 123.45679 and compact["value_source"] == B.VALUE_SOURCE
    assert "torch.profiler" in compact["value_source"]
    assert compact["kernel_ratio"] == 1.003337 and compact["e2e_wall_gbps"] == 0.0156789
    result, device = _full_result()
    compact = B._compact_result(result, device)
    assert compact["native_inflate_gbps"] is None and compact["parallel_inflate_gbps"] is None


def test_unreachable_device_is_not_a_measurement():
    result = {"metric": "m", "value": 0.0, "unit": "GB/s", "vs_baseline": None}
    B._compose_result(result, {}, None, {"device": "RuntimeError: no CUDA"}, {})
    compact = B._compact_result(result, {})
    assert compact["value"] == 0.0 and compact["value_source"].startswith("DEVICE UNREACHABLE")
    assert result["device_unreachable"] and result["native"]["available"] is False
    assert result["host_stream_decode_mbps_by_input_chunk"]["available"] is False


def test_bench_cpu_has_the_reference_shape():
    data = bench.load_corpus()[:64 * 1024]
    got, zgot = B.bench_cpu(data)
    want, zwant = bench.bench_cpu(data)
    assert zgot == zwant
    assert set(got) == set(want) and list(got["compress"]) == list(want["compress"])
    for lvl, rec in got["compress"].items():
        assert set(rec) == set(want["compress"][lvl])
        assert rec["bytes"] == want["compress"][lvl]["bytes"] and rec["gbps"] > 0
    assert got["inflate_gbps"] > 0


# ---------------------------------------------------------------------------
# the device phases on the CPU, at two chunks
# ---------------------------------------------------------------------------

PHASES = {
    "kernel_encode": (lambda d, f, dev: B._phase_kernel_encode(d, f, dev, CPU),
                      {"kernel_encode_wallclock_gbps"}),
    "vector_decode": (lambda d, f, dev: B._phase_vector(B._seeded_stream(d, CPU), dev, CPU),
                      {"vector_decode_wallclock_gbps"}),
    "inflate_kernel": (lambda d, f, dev: B._phase_inflate_kernel(d, dev, CPU),
                       {"inflate_kernel_wallclock_gbps"}),
    "foreign_kernel": (lambda d, f, dev: B._phase_foreign_kernel(d, dev, CPU),
                       {"foreign_kernel_decode_wall_s", "foreign_kernel_decode_bytes"}),
    "speculative": (lambda d, f, dev: B._phase_speculative(d[:65_536], dev, CPU),
                    {"speculative_inflate_wallclock_gbps", "speculative_inflate_bytes"}),
    "swarm": (lambda d, f, dev: B._phase_swarm(B._seeded_stream(d, CPU), dev, CPU),
              {"swarm_decode_wallclock_gbps"}),
    "kernel_ratio": (lambda d, f, dev: B._phase_kernel_ratio(d[:65_536], dev, CPU),
                     {"kernel_ratio_vs_zlib", "kernel_ratio_bytes", "kernel_e2e_steady_gbps",
                      "kernel_e2e_wall_gbps"}),
    "xla_encode": (lambda d, f, dev: B._phase_xla_encode(d[:32_768], f, dev, CPU),
                   {"encode_wallclock_gbps", "ratio_vs_zlib"}),
}


@pytest.mark.parametrize("name", list(PHASES))
def test_device_phase_on_the_cpu(tiny, name):
    data, flat = tiny
    run, keys = PHASES[name]
    dev = {}
    run(data, flat, dev)
    assert set(dev) == keys
    assert not any("trace" in k or "busy" in k for k in dev)  # no device time
    assert all(v > 0 for v in dev.values())
    assert name in B.PHASE_KEYS


def test_phases_check_against_zlib_before_timing(tiny, monkeypatch):
    data, _flat = tiny
    wrong = lambda bodies, sizes, *a, **kw: [b"\0" * n for n in sizes]  # noqa: E731
    monkeypatch.setattr(TV, "decode_chunks_vector", wrong)
    monkeypatch.setattr(TS, "decode_chunks_kernel", wrong)
    for phase in (lambda dev: B._phase_vector(B._seeded_stream(data, CPU), dev, CPU),
                  lambda dev: B._phase_inflate_kernel(data, dev, CPU)):
        dev = {}
        with pytest.raises(ValueError, match="mismatch"):
            phase(dev)
        assert dev == {}


def test_bench_device_records_each_phase(tiny, monkeypatch):
    data, _flat = tiny
    monkeypatch.setattr(B, "PHASE_ERRORS", {})
    monkeypatch.setattr(B, "PHASE_SECONDS", {})
    emitted = []
    dev = B.bench_device(data, emit=lambda d: emitted.append(dict(d)),
                         only=("inflate_kernel", "swarm"), device="cpu")
    assert len(emitted) == 2 and B.PHASE_ERRORS == {}
    assert {"inflate_kernel_wallclock_gbps", "swarm_decode_wallclock_gbps"} <= set(dev)
    assert {"device:inflate_kernel", "device:swarm", "device:seeded_stream"} <= set(B.PHASE_SECONDS)
    monkeypatch.setattr(B, "BUDGET", 0.0)  # every phase is skipped, and says so
    B.bench_device(data, only=("kernel_ratio",), device="cpu")
    assert B.PHASE_ERRORS["kernel_ratio"].startswith("skipped")


# ---------------------------------------------------------------------------
# the native rows and the decode sweep, on the CPU
# ---------------------------------------------------------------------------


def _shape(v):
    """A section's key structure: the keys of every nested dict."""
    return {k: _shape(x) for k, x in v.items()} if isinstance(v, dict) else None


NATIVE_BYTES = 4096  # the plain deflate_chunk takes about 10 us a byte here


def test_native_and_decode_sweep_have_the_reference_keys(tiny, monkeypatch):
    """The native rows and the decode sweep through the plain versions
    (device="cpu"), held against bench.py's bench_native (the JAX
    package's native engine, built by g++) and bench_decode_sweep on the
    same bytes: the reference's keys, every row measured, zlib's bytes at
    levels 1-9 (EX follows zlib on a window's tail, so only the keys and
    the round trips are compared, not the ratios); the compact line then
    carries the two inflate rates."""
    data = tiny[0][:NATIVE_BYTES]
    monkeypatch.setattr(B, "CHUNK", 2048)
    monkeypatch.setattr(bench, "CHUNK", 2048)
    monkeypatch.setattr(B, "PHASE_ERRORS", {})
    dev = B.bench_device(data, only=("native", "decode_sweep", "native_levels"), device="cpu")
    assert B.PHASE_ERRORS == {}
    _cpu, zstreams = bench.bench_cpu(data)
    ref_native, ref_sweep = bench.bench_native(data, zstreams), bench.bench_decode_sweep(data)
    nat, sweep = dev["native"], dev["decode_sweep"]
    extra = {"engines", "timing", "bytes"}
    assert _shape({k: v for k, v in nat.items() if k not in extra}) == _shape(ref_native)
    assert set(nat["engines"]) == {k for k in ref_native if k != "available"}
    assert _shape({k: v for k, v in sweep.items() if k not in ("engines", "timing")}) == \
        _shape(ref_sweep)
    assert "not a device measurement" in nat["timing"] == sweep["timing"]
    rates = [r["gbps"] for g in ("compress", "parallel_compress", "medium") for r in nat[g].values()]
    rates += [nat["quick"]["gbps"], nat["inflate_gbps"], nat["parallel_inflate_gbps"],
              nat["speculative_inflate_gbps"]] + [v for k, v in sweep.items() if k.startswith("2^")]
    assert all(v >= 0 for v in rates) and sweep["pure_engine_2^14"] > 0
    assert all(nat["compress"][str(lvl)]["bit_exact"] for lvl in range(1, 10))
    result = {"metric": "m", "value": 0.0, "unit": "GB/s", "vs_baseline": None}
    B._compose_result(result, dev, None, B.PHASE_ERRORS, {})
    assert result["native"] is nat and "native" not in result["device"]
    assert result["host_stream_decode_mbps_by_input_chunk"] is sweep
    compact = B._compact_result(dict(result, elapsed_s=123456.7), dev)
    assert compact["native_inflate_gbps"] == nat["inflate_gbps"] is not None
    assert compact["parallel_inflate_gbps"] == nat["parallel_inflate_gbps"] is not None
    assert len(json.dumps(compact)) < 500


def test_rows_past_the_budget_are_cut_not_phase_errors(tiny, monkeypatch):
    """With 40 s left and a clock on which every call takes 10 s: a row
    whose reps, priced at its first call, pass the 25 s left past the
    margin is cut_by_budget with its first call's seconds (3 reps and
    more, the sweep's rows whose first call read the clock three times);
    the 2-rep rows and the one-call host row run; no phase error."""
    import types

    data = tiny[0][:NATIVE_BYTES]
    monkeypatch.setattr(B, "CHUNK", 2048)
    monkeypatch.setattr(B, "PHASE_ERRORS", {})
    monkeypatch.setattr(B, "remaining", lambda: 40.0)
    ticks = iter(range(0, 10 ** 9, 10))
    monkeypatch.setattr(B, "time", types.SimpleNamespace(
        monotonic=B.time.monotonic, perf_counter=lambda: float(next(ticks))))
    emitted = []
    dev = B.bench_device(data, emit=lambda d: emitted.append(1),
                         only=("native", "decode_sweep", "native_levels"), device="cpu")
    assert B.PHASE_ERRORS == {}
    nat, sweep = dev["native"], dev["decode_sweep"]
    cut = {"cut_by_budget": True, "first_call_s": 10.0}
    assert nat["parallel_compress"] == {"1": cut, "6": cut, "9": cut}
    assert nat["inflate_gbps"] == cut
    assert nat["parallel_inflate_gbps"] == {"cut_by_budget": True, "first_call_s": 30.0}
    assert all(nat["compress"][str(lvl)] == cut for lvl in (1, 6, 9))
    assert all("gbps" in nat["compress"][str(lvl)] for lvl in (0, 2, 3, 4, 5, 7, 8))
    assert "gbps" in nat["quick"] and all("gbps" in r for r in nat["medium"].values())
    assert all(sweep[f"2^{b}"] == {"cut_by_budget": True, "first_call_s": 30.0}
               for b in range(4, 25))
    assert isinstance(sweep["pure_engine_2^14"], float)
    assert len(emitted) > 30  # a snapshot after every row
    compact = B._compact_result(B._compose_result(
        {"metric": "m", "value": 0.0, "unit": "GB/s", "vs_baseline": None}, dev, None), dev)
    assert compact["native_inflate_gbps"] is None and compact["parallel_inflate_gbps"] is None


# ---------------------------------------------------------------------------
# the trace helper
# ---------------------------------------------------------------------------


def test_kernel_symbols_name_one_kernel_a_source():
    """One kernel a source, but SP1-SP3's eleven in csrc/speculative.cu (SP2's
    block launch and the one-warp launch it replaced, SP1's tiles and
    checks and SP3's chases and the first designs they replaced),
    EX's, DS's, the resolve's (the chain build and the walk), the levels
    1-3 dry parse's, the chase's and the tables' seven in
    csrc/exact_deflate.cu, and IS's two in csrc/istream.cu (the one-warp
    launch the probes time and the whole-block launch)."""
    syms = B.kernel_symbols()
    assert list(syms) == [f"zrs_{n}" for n in _device.SOURCES]
    assert syms["zrs_inflate"] == ("inflate_streams",) and syms["zrs_pack"] == ("pack",)
    assert syms["zrs_hop_chase_il"] == ("hop_chase_body",)
    assert syms["zrs_lockstep"] == ("lockstep_regions",) and syms["zrs_swarm"] == ("swarm_walk",)
    assert syms["zrs_speculative"] == ("find_prefilter", "find_check", "spec_decode",
                                       "resolve_init", "resolve_jump", "resolve_narrow",
                                       "spec_sync", "find_tiles", "find_first",
                                       "resolve_chase", "resolve_tail")
    assert syms["zrs_exact_deflate"] == ("exact_deflate", "dstream_pump", "build_chains",
                                         "resolve_walk", "exact_dry", "exact_chase", "ds_tables")
    assert syms["zrs_istream"] == ("istream_advance", "istream_sync")
    assert all(len(v) == 1 for k, v in syms.items()
               if k not in ("zrs_speculative", "zrs_exact_deflate", "zrs_istream"))


def test_device_busy_is_the_union_of_device_intervals():
    syms = B.kernel_symbols()
    events = [
        {"ph": "X", "cat": "kernel", "ts": 100.0, "dur": 50.0,
         "name": "(anonymous namespace)::inflate_streams(unsigned int const*, int)"},
        {"ph": "X", "cat": "kernel", "ts": 120.0, "dur": 10.0,
         "name": "void (anonymous namespace)::pack<true>(unsigned int const*, int)"},
        {"ph": "X", "cat": "kernel", "ts": 140.0, "dur": 20.0,
         "name": "_ZN12_GLOBAL__N_114hop_chase_bodyILb1EEEvPKjiPKi"},
        {"ph": "X", "cat": "kernel", "ts": 150.0, "dur": 4.0,
         "name": "_ZN47_GLOBAL__N__9a212fde_14_speculative_cu_6793fd3912resolve_jumpEPKiPii"},
        {"ph": "X", "cat": "kernel", "ts": 400.0, "dur": 3.0,
         "name": "(anonymous namespace)::find_check(unsigned int const*, int)"},
        {"ph": "X", "cat": "kernel", "ts": 200.0, "dur": 5.0,
         "name": "void at::native::vectorized_elementwise_kernel<4, at::native::unpack>()"},
        {"ph": "X", "cat": "gpu_memcpy", "ts": 300.0, "dur": 7.0, "name": "Memcpy HtoD"},
        {"ph": "X", "cat": "gpu_memset", "ts": 304.0, "dur": 2.0, "name": "Memset (Device)"},
        {"ph": "X", "cat": "cuda_runtime", "ts": 0.0, "dur": 1000.0, "name": "cudaLaunchKernel"},
        {"ph": "f", "cat": "ac2g", "ts": 10.0, "name": "flow"},
    ]
    busy, per = B.device_busy(events, syms)
    # [100, 160), [200, 205), [300, 307), [400, 403)
    assert busy == pytest.approx((60 + 5 + 7 + 3) / 1e6)
    assert per == pytest.approx({"zrs_inflate": 50e-6, "zrs_pack": 10e-6,
                                 "zrs_hop_chase_il": 20e-6, "zrs_speculative": 7e-6,
                                 "torch": 5e-6, "memcpy": 7e-6, "memset": 2e-6})


def test_trace_helper_on_the_cpu_returns_the_wall():
    n = []
    sec, progs, wall = B._device_trace_seconds(lambda: n.append(1), 3, "cpu", 60,
                                               device=CPU, expect=("zrs_inflate",))
    assert progs == {"__wall_clock__": True} and sec == wall > 0 and len(n) == 3
    dev = {}
    assert not B._record_trace(dev, "x", sec, progs, wall) and dev == {}


def test_trace_helper_checks_the_expected_kernels(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    cuda = torch.device("cuda")
    monkeypatch.setattr(B, "_trace", lambda fn, reps, device: (
        0.004, {"zrs_inflate": 0.003, "torch": 0.002}, 0.008))
    sec, progs, wall = B._device_trace_seconds(lambda: None, 2, "t", 60, device=cuda,
                                               expect=("zrs_inflate",))
    assert (sec, progs, wall) == (0.002, {"zrs_inflate": 0.0015, "torch": 0.001}, 0.004)
    dev = {}
    assert B._record_trace(dev, "x", sec, progs, wall) and dev["x_busy_share"] == 0.5
    with pytest.raises(RuntimeError, match="zrs_pack"):
        B._device_trace_seconds(lambda: None, 2, "t", 60, device=cuda,
                                expect=("zrs_inflate", "zrs_pack"))

    def broken(*a):
        raise RuntimeError("CUPTI unavailable")

    monkeypatch.setattr(B, "_trace", broken)
    sec, progs, wall = B._device_trace_seconds(lambda: None, 2, "t", 60, device=cuda,
                                               expect=("zrs_inflate",))
    assert progs == {"__wall_clock__": True} and sec == wall


# ---------------------------------------------------------------------------
# the module run, with no CUDA device
# ---------------------------------------------------------------------------


def bench_corpus(size: int) -> bytes:
    old = B.TARGET_SIZE
    B.TARGET_SIZE = size
    try:
        return B.load_corpus()
    finally:
        B.TARGET_SIZE = old


def _env(**extra):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", ZRS_BENCH_TARGET_MB="0.25",
               ZRS_BENCH_BUDGET_S="120", PYTHONPATH=str(ROOT), **extra)
    env.pop("ZRS_BENCH_TESTDATA", None)
    return env


def test_killed_bench_has_printed_a_parseable_line():
    proc = subprocess.Popen([sys.executable, "-m", "zlib_rs_tpu_torch.bench"],
                            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                            env=_env(), cwd=ROOT, text=True)
    try:
        first = [proc.stdout.readline(), proc.stdout.readline()]
    finally:
        proc.kill()
        rest = proc.communicate(timeout=60)[0]
    lines = [ln for ln in first + rest.splitlines() if ln.strip()]
    last = json.loads(lines[-1])
    assert last["metric"] == "parallel_deflate_level6_device_gbps" and last["value"] == 0.0
    assert len(lines[-1]) < 500


def test_bench_without_cuda_says_the_device_is_unreachable():
    run = subprocess.run([sys.executable, "-m", "zlib_rs_tpu_torch.bench"],
                         capture_output=True, text=True, env=_env(), cwd=ROOT, timeout=300)
    assert run.returncode == 0
    lines = run.stdout.strip().splitlines()
    compact, full = json.loads(lines[-1]), json.loads(lines[-2])
    assert len(lines[-1]) < 500 and compact["value"] == 0.0
    assert compact["value_source"].startswith("DEVICE UNREACHABLE")
    assert full["device"] == {} and full["device_unreachable"]
    assert "CUDA" in full["device_phase_errors"]["device"]
    assert full["cpu_zlib"]["compress"]["6"]["bytes"] == len(zlib.compress(
        bench_corpus(256 * 1024), 6))

