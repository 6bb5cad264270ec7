"""The slice as a whole: the port's `compress_parallel` (device="cpu", every
kernel's plain version) against the JAX package's kernel engine
(ZRS_TPU_KERNEL=1, Pallas kernels in interpret mode) and its XLA engine
(ZRS_TPU_KERNEL unset or 0, levels up to 2, chunk buffers past MAX_BUF)
on the same inputs. Streams, chunk indexes and decode seeds must be
byte-for-byte equal, and every stream must decode with stdlib zlib.

The port runs with XLA's own 2^len density weights (fixture
`kernel_engine`, see tests/test_torch_dynhuff.py) so that both tree
builders do the same float32 arithmetic; `test_shipped_weights_against_jax`
runs the port's own exact weights instead and pins how far its streams
are from the JAX package's."""

import os
import pathlib
import re
import subprocess
import sys
import zlib
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zlib_rs_tpu.parallel.pipeline as jp
from zlib_rs_tpu.ops.pallas import deflate_kernel as jdk
import zlib_rs_tpu_torch as zt
from zlib_rs_tpu_torch.config import Strategy
from zlib_rs_tpu_torch.ops import dynhuff as td
from zlib_rs_tpu_torch.ops.kernels import deflate_kernel as tdk
from zlib_rs_tpu_torch.parallel import pipeline as tp

# the test workers share the cores, and an oversubscribed OpenMP pool spin-waits
torch.set_num_threads(1)

_BASH = open("/bin/bash", "rb").read()
MULTI = _BASH[400_000 : 400_000 + 70_001]  # three chunks, odd length
XLA = _BASH[300_000 : 300_000 + 40_001]  # three 16 KiB chunks of the XLA engine
BIG = _BASH[600_000 : 600_000 + 150_001]  # two chunks at the XLA engine's 128 KiB
ENV = ("ZRS_TPU_KERNEL", "ZRS_TPU_CHAIN", "ZRS_TPU_WG", "ZRS_TPU_HOPSCAN",
       "ZRS_TPU_TABSCAN", "ZRS_TPU_HOP_IL")
_JAX_CACHE = {}
SHIPPED_EXP2 = td.EXP2_LEN  # the port's exact 2^len, before any test swaps it


@pytest.fixture(autouse=True)
def kernel_engine(monkeypatch):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("ZRS_TPU_KERNEL", "1")
    table = np.asarray(jnp.exp2(jnp.arange(16, dtype=jnp.float32))).copy()
    monkeypatch.setattr(td, "EXP2_LEN", torch.from_numpy(table))


def _jax(data: bytes, level: int, **kw):
    key = (data, level, tuple(sorted(kw.items())), tuple(os.environ.get(n) for n in ENV))
    if key not in _JAX_CACHE:
        _JAX_CACHE[key] = jp.compress_parallel(data, level, **kw)
    return _JAX_CACHE[key]


def _decode(stream: bytes, window_bits: int = 15) -> bytes:
    d = zlib.decompressobj(window_bits)
    out = d.decompress(stream) + d.flush()
    assert d.eof and not d.unused_data
    return out


@pytest.mark.parametrize("level", [3, 4, 5, 6, 7])
def test_levels_equal_jax(level):
    got = zt.compress_parallel(MULTI, level, device="cpu")
    assert got == _jax(MULTI, level)
    assert _decode(got) == MULTI


@pytest.mark.parametrize("window_bits", [15, 31, -15, 9])
def test_wrappers_equal_jax(window_bits):
    got = zt.compress_parallel(MULTI, 6, window_bits=window_bits, device="cpu")
    assert got == _jax(MULTI, 6, window_bits=window_bits)
    assert _decode(got, window_bits if window_bits != 9 else 15) == MULTI
    if window_bits == 31:
        assert got[:2] == b"\x1f\x8b"
        assert int.from_bytes(got[-8:-4], "little") == zlib.crc32(MULTI)


@pytest.mark.parametrize("window_bits", [15, 31])
def test_return_index_equal_jax(window_bits):
    got, index = zt.compress_parallel(
        MULTI, 6, return_index=True, window_bits=window_bits, device="cpu"
    )
    ref, ref_index = _jax(MULTI, 6, return_index=True, window_bits=window_bits)
    assert got == ref
    assert isinstance(index, zt.ChunkIndex)
    assert list(index) == list(ref_index)
    assert index.seeds == ref_index.seeds
    assert all(len(s[0]) == len(s[1]) == tp.SEEDS_PER_CHUNK for s in index.seeds)
    assert _decode(got, window_bits) == MULTI
    # indexed chunks are not primed: each body inflates on its own
    pos = 0
    for off, ln, out_len in index:
        d = zlib.decompressobj(-15)
        assert d.decompress(got[off : off + ln]) == MULTI[pos : pos + out_len]
        pos += out_len


@pytest.mark.parametrize(
    "data",
    [b"", b"x", _BASH[:1001], _BASH[500_000 : 500_000 + 65_536]],
    ids=["empty", "one_byte", "odd_1001", "two_chunks"],
)
def test_edge_inputs_equal_jax(data):
    got = zt.compress_parallel(data, 6, device="cpu")
    assert got == _jax(data, 6)
    assert _decode(got) == data


def test_incompressible_input_falls_back_to_stored_chunks():
    data = np.random.default_rng(12).integers(0, 256, size=40_000, dtype=np.uint8).tobytes()
    got, index = zt.compress_parallel(data, 6, return_index=True, device="cpu")
    ref, ref_index = _jax(data, 6, return_index=True)
    assert got == ref and list(index) == list(ref_index)
    assert index.seeds == ref_index.seeds
    assert index.seeds[0] is None  # a stored chunk carries no seeds
    assert _decode(got) == data
    plain = zt.compress_parallel(data, 6, device="cpu")
    assert plain == _jax(data, 6) and _decode(plain) == data


TIE = _BASH[100_000 : 100_000 + 70_001]  # a density tie in the level-3 tree

# (data, level, options, port bytes minus JAX bytes) with the shipped
# weights; a nonzero difference is a Kraft density tie that XLA's inexact
# CPU exp2 breaks the other way (ROADMAP.md, queue 3)
SHIPPED_CASES = {
    "level3": (MULTI, 3, {}, 0),
    "level4": (MULTI, 4, {}, 0),
    "level5": (MULTI, 5, {}, 0),
    "level6": (MULTI, 6, {}, 0),
    "level7": (MULTI, 7, {}, 0),
    "gzip": (MULTI, 6, dict(window_bits=31), 0),
    "raw": (MULTI, 6, dict(window_bits=-15), 0),
    "index": (MULTI, 6, dict(return_index=True), 0),
    "empty": (b"", 6, {}, 0),
    "one_byte": (b"x", 6, {}, 0),
    "odd_1001": (_BASH[:1001], 6, {}, 0),
    "two_chunks": (_BASH[500_000 : 500_000 + 65_536], 6, {}, -1),
    "tie_level3": (TIE, 3, {}, 11),
    "tie_level6": (TIE, 6, {}, 0),
}


@pytest.mark.parametrize("case", list(SHIPPED_CASES))
def test_shipped_weights_against_jax(monkeypatch, case):
    data, level, kw, diff = SHIPPED_CASES[case]
    xla_exp2 = td.EXP2_LEN
    monkeypatch.setattr(td, "EXP2_LEN", SHIPPED_EXP2)
    got = zt.compress_parallel(data, level, device="cpu", **kw)
    ref = _jax(data, level, **kw)
    if kw.get("return_index"):
        (got, index), (ref, ref_index) = got, ref
        assert list(index) == list(ref_index) and index.seeds == ref_index.seeds
    assert len(got) - len(ref) == diff
    if diff == 0:
        assert got == ref
    else:
        # the difference is the weight table alone: XLA's values close it
        monkeypatch.setattr(td, "EXP2_LEN", xla_exp2)
        assert zt.compress_parallel(data, level, device="cpu", **kw) == ref
    assert _decode(got, kw.get("window_bits", 15)) == data


# the XLA engine (ZRS_TPU_KERNEL unset, 16 KiB chunks) with the shipped
# weights: (data, level, options, port bytes minus JAX bytes, bytes equal);
# MULTI at level 6 breaks a density tie the other way at the same length
XLA_SHIPPED_CASES = {
    "level3": (XLA, 3, {}, 0, True),
    "level6": (XLA, 6, {}, 0, True),
    "level9": (XLA, 9, {}, 0, True),
    "index": (XLA, 6, dict(return_index=True), 0, True),
    "tie_level3": (TIE, 3, {}, 0, True),
    "multi_level6": (MULTI, 6, {}, 0, False),
}


@pytest.mark.parametrize("case", list(XLA_SHIPPED_CASES))
def test_shipped_weights_against_jax_xla_engine(monkeypatch, case):
    data, level, kw, diff, same = XLA_SHIPPED_CASES[case]
    kw = dict(kw, chunk_size=16_384)
    monkeypatch.delenv("ZRS_TPU_KERNEL")
    xla_exp2 = td.EXP2_LEN
    monkeypatch.setattr(td, "EXP2_LEN", SHIPPED_EXP2)
    got = zt.compress_parallel(data, level, device="cpu", **kw)
    ref = _jax(data, level, **kw)
    if kw.get("return_index"):
        (got, index), (ref, ref_index) = got, ref
        assert list(index) == list(ref_index) and index.seeds == ref_index.seeds
    assert len(got) - len(ref) == diff
    assert (got == ref) == same
    if not same:  # the weight table alone: XLA's values close it
        monkeypatch.setattr(td, "EXP2_LEN", xla_exp2)
        assert zt.compress_parallel(data, level, device="cpu", **kw) == ref
    assert _decode(got) == data


def test_unset_kernel_env_and_hop_il_run_the_same_engine(monkeypatch):
    # unset selects the XLA matcher engine in both packages (at 16 KiB
    # chunks here); ZRS_TPU_HOP_IL=2 runs the kernel engine
    want = _jax(MULTI, 6)
    monkeypatch.delenv("ZRS_TPU_KERNEL")
    xla = zt.compress_parallel(MULTI, 6, chunk_size=16_384, device="cpu")
    assert xla == _jax(MULTI, 6, chunk_size=16_384) != want
    assert _decode(xla) == MULTI
    monkeypatch.setenv("ZRS_TPU_KERNEL", "1")
    # ZRS_TPU_HOP_IL=2: the JAX package reads it inside its jitted scan, so
    # its caches are cleared around the run, and the K12 traces are counted
    monkeypatch.setenv("ZRS_TPU_HOP_IL", "2")
    traced, ran = [], []
    real_jax, real_port = jdk._make_kernel_hop_il, tdk.hop_chase_il
    monkeypatch.setattr(jdk, "_make_kernel_hop_il", lambda *a: traced.append(a) or real_jax(*a))
    monkeypatch.setattr(tdk, "hop_chase_il", lambda *a: ran.append(a[0].shape[0]) or real_port(*a))
    jax.clear_caches()
    try:
        ref = jp.compress_parallel(MULTI, 6)
    finally:
        jax.clear_caches()
    assert traced and {a[1] for a in traced} == {2}
    got = zt.compress_parallel(MULTI, 6, device="cpu")
    assert ran == [3]  # one odd batch of three chunks
    assert got == ref == want


def test_chain_env_and_wg_env_are_honoured(monkeypatch):
    monkeypatch.setenv("ZRS_TPU_CHAIN", "16")
    monkeypatch.setenv("ZRS_TPU_WG", "4")
    data = MULTI[:40_000]
    got = zt.compress_parallel(data, 6, device="cpu")
    assert got == jp.compress_parallel(data, 6)
    assert _decode(got) == data


# the chain route (K8) and the tab route (K10), each with the K9 histogram
ROUTES = {
    "level8": (8, {}, {}),
    "level9": (9, {}, {}),
    "level9_gzip": (9, dict(window_bits=31), {}),
    "level9_index": (9, dict(return_index=True), {}),
    "level6_tabscan0": (6, {}, {"ZRS_TPU_TABSCAN": "0"}),
    "level6_hopscan0": (6, {}, {"ZRS_TPU_HOPSCAN": "0"}),
    "level6_wg32": (6, {}, {"ZRS_TPU_WG": "32"}),
    "level9_chain128": (9, {}, {"ZRS_TPU_CHAIN": "128"}),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_chain_and_tab_routes_equal_jax(monkeypatch, case):
    level, kw, env = ROUTES[case]
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    want = "chain" if case in ("level8", "level9", "level9_gzip", "level9_index",
                               "level6_tabscan0") else "tab"
    assert tp._resolve_kernel_variant(tp._level_knobs(level)["kernel_cfg"])[0] == want
    got = zt.compress_parallel(MULTI, level, device="cpu", **kw)
    ref = _jax(MULTI, level, **kw)
    if kw.get("return_index"):
        (got, index), (ref, ref_index) = got, ref
        assert list(index) == list(ref_index) and index.seeds == ref_index.seeds
    assert got == ref
    window_bits = kw.get("window_bits", 15)
    assert _decode(got, window_bits) == MULTI
    if window_bits == 31:
        assert got[:2] == b"\x1f\x8b" and got[8] == 2  # gzip XFL: best compression


@pytest.mark.parametrize(
    "kw,match",
    [
        (dict(level=6, mesh=object()), "mesh"),
        (dict(level=6, strategy=Strategy.Filtered), "host engine"),
    ],
)
def test_routes_not_ported_raise(kw, match):
    """mesh= takes a 1-D torch.distributed DeviceMesh (tests/test_torch_mesh.py
    runs it); anything else raises ValueError. A non-default strategy runs
    the host engine, which is ported: its stream is the JAX package's, and
    with return_index both packages raise ValueError."""
    if "strategy" not in kw:
        with pytest.raises(ValueError, match=match):
            zt.compress_parallel(MULTI, device="cpu", **kw)
        return
    got = zt.compress_parallel(MULTI, device="cpu", **kw)
    assert got == jp.compress_parallel(MULTI, **kw) and zlib.decompress(got) == MULTI
    for compress in (partial(zt.compress_parallel, device="cpu"), jp.compress_parallel):
        with pytest.raises(ValueError, match="default strategy"):
            compress(MULTI, return_index=True, **kw)


def _set_env(monkeypatch, env):
    for name, value in env.items():
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)


def _equal_jax(data, level, kw):
    """The port's stream (and index and seeds) equal to the JAX package's
    under the current environment, and decoded by zlib. Returns the port's
    result."""
    res = zt.compress_parallel(data, level, device="cpu", **kw)
    ref = _jax(data, level, **kw)
    got = res
    if kw.get("return_index"):
        (got, index), (ref, ref_index) = res, ref
        assert list(index) == list(ref_index)
        assert index.seeds == ref_index.seeds
    assert got == ref
    assert _decode(got, kw.get("window_bits", 15)) == data
    return res


# the routes that raised before the XLA engine was ported, each now equal
# to the JAX package: static levels under ZRS_TPU_KERNEL=1 (32 KiB chunks,
# level 2 with the kernel engine's shrunk dictionary), ZRS_TPU_KERNEL=0 and
# unset (16 KiB and 128 KiB chunks), and a 65536-byte chunk under
# ZRS_TPU_KERNEL=1, whose primed buffer is past MAX_BUF
NOW_PORTED = {
    "level1": (MULTI, 1, {}, {}),
    "level2": (MULTI, 2, {}, {}),
    "kernel0": (XLA, 6, dict(chunk_size=16_384), {"ZRS_TPU_KERNEL": "0"}),
    "chunk65536": (MULTI, 6, dict(chunk_size=65536), {}),
    "unset": (BIG, 6, {}, {"ZRS_TPU_KERNEL": None}),
}


@pytest.mark.parametrize("case", list(NOW_PORTED))
def test_routes_now_ported_equal_jax(monkeypatch, case):
    data, level, kw, env = NOW_PORTED[case]
    _set_env(monkeypatch, env)
    calls = []
    real = tp._encode_batch
    monkeypatch.setattr(tp, "_encode_batch", lambda *a, **k: calls.append(k) or real(*a, **k))
    _equal_jax(data, level, kw)
    assert calls and not any(k["kernel_scan"] for k in calls)  # the XLA engine
    dict_size = calls[0]["dict_size"]
    assert dict_size == {"level1": 0, "level2": 31_984}.get(case, 32_768)


def test_kernel_engine_refuses_a_chunk_off_the_word_grid():
    # under ZRS_TPU_KERNEL=1 a level-6 buffer of 32768 + 12345 + PAD bytes
    # fits the kernel engine, whose words need a multiple of 4: both
    # packages refuse it (the reference in its reshape into words)
    with pytest.raises(ValueError, match="multiple of 4"):
        zt.compress_parallel(XLA, 6, chunk_size=12_345, device="cpu")
    with pytest.raises(TypeError):
        jp.compress_parallel(XLA, 6, chunk_size=12_345)


# the XLA engine at 16 KiB chunks under an unset ZRS_TPU_KERNEL: every
# level class, the three wrappers, static and dynamic indexes, and a chunk
# size that is not a multiple of 4
XLA_CASES = {
    "level-1": (-1, {}),
    "level0": (0, {}),
    "level1": (1, {}),
    "level2": (2, {}),
    "level3": (3, {}),
    "level6": (6, {}),
    "level9": (9, {}),
    "gzip": (6, dict(window_bits=31)),
    "raw": (6, dict(window_bits=-15)),
    "index_static": (1, dict(return_index=True)),
    "index_dynamic": (6, dict(return_index=True)),
    "chunk12345_level6": (6, dict(chunk_size=12_345)),
    "chunk12345_level9": (9, dict(chunk_size=12_345)),
}


@pytest.mark.parametrize("case", list(XLA_CASES))
def test_xla_engine_equal_jax(monkeypatch, case):
    level, kw = XLA_CASES[case]
    monkeypatch.delenv("ZRS_TPU_KERNEL")
    kw = dict(kw)
    kw.setdefault("chunk_size", 16_384)
    res = _equal_jax(XLA, level, kw)
    if kw.get("return_index"):
        out, index = res
        if level < 3:  # static chunks carry no seeds
            assert index.seeds is None
        else:
            assert all(len(s[0]) == tp.SEEDS_PER_CHUNK for s in index.seeds)
        pos = 0
        for off, ln, out_len in index:  # each chunk inflates on its own
            d = zlib.decompressobj(-15)
            assert d.decompress(out[off : off + ln]) == XLA[pos : pos + out_len]
            pos += out_len


def test_default_strategy_is_the_kernel_engine():
    got = zt.compress_parallel(MULTI, 6, strategy=Strategy.Default, device="cpu")
    assert got == _jax(MULTI, 6)
    assert zt.fallback_stats() == {}


def test_no_gpu_and_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        zt.compress_parallel(b"abc", 6)


def test_import_leaves_jax_and_the_jax_package_out():
    code = (
        "import sys, zlib_rs_tpu_torch, zlib_rs_tpu_torch.interop;"
        "import zlib_rs_tpu_torch.ops.kernels.deflate_kernel;"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'zlib_rs_tpu' or m.startswith('zlib_rs_tpu.')];"
        "print(bad); sys.exit(1 if bad else 0)"
    )
    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root))
    res = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_no_port_source_names_jax_or_the_jax_package():
    root = pathlib.Path(zt.__file__).resolve().parent
    files = [p for p in root.rglob("*") if p.suffix in (".py", ".cu", ".cuh")]
    assert len(files) >= 15
    files.append(root.parent / "chip_smoke.py")
    for path in files:
        text = path.read_text()
        assert not re.search(
            r"\bjax\b|zlib_rs_tpu\.\w|(import|from) zlib_rs_tpu\b", text
        ), path
