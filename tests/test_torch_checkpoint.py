"""The checkpointed stream decode and the region decode through K6: the
port's `decode_step`, `decode_streaming` and `decompress_chunks`
(`device="cpu"`, K6's plain version) against the JAX package's, which run
K6 in interpret mode; a snapshot taken in the JAX package resumes in the
port, its fields passed to the port's DeviceInflateState."""

import dataclasses
import pickle
import zlib

import numpy as np
import pytest
import torch

import zlib_rs_tpu.parallel.checkpoint as JC
import zlib_rs_tpu.parallel.inflate as JI
import zlib_rs_tpu_torch as zt
from zlib_rs_tpu_torch.parallel import checkpoint as TC
from zlib_rs_tpu_torch.parallel import inflate as TI
from zlib_rs_tpu_torch.parallel import pipeline as tp

# the test workers share the cores, and an oversubscribed OpenMP pool spin-waits
torch.set_num_threads(1)

rng = np.random.default_rng(21)
DATA = (
    open("/bin/bash", "rb").read()[:60_000]
    + b"checkpointable stream content " * 1500
    + rng.integers(0, 256, 20_000, dtype=np.uint8).tobytes()
)
STEP = 40_000  # >= 32 KiB: every step after the first primes a full window


def _raw(data, level=6, mem=1):
    co = zlib.compressobj(level, zlib.DEFLATED, -15, mem)  # mem 1: many small blocks
    return co.compress(data) + co.flush()


BODY = _raw(DATA)


def _fields(state):
    return dataclasses.asdict(state)


@pytest.fixture(scope="module")
def jax_steps():
    return list(JC.decode_streaming(BODY, step_bytes=STEP, interpret=True))


def test_decode_streaming_equals_jax(jax_steps):
    got = list(TC.decode_streaming(BODY, step_bytes=STEP, device="cpu"))
    assert len(got) == len(jax_steps) >= 3
    for (out, st), (rout, rst) in zip(got, jax_steps):
        assert out == rout and _fields(st) == _fields(rst)
    assert b"".join(o for o, _ in got) == DATA
    end = got[-1][1]
    assert end.finished and end.produced == len(DATA) and end.adler == zlib.adler32(DATA)


def test_public_names_are_the_checkpoint_api():
    assert zt.DeviceInflateState is TC.DeviceInflateState
    assert zt.device_decode_step is TC.decode_step
    assert zt.device_decode_streaming is TC.decode_streaming


def test_jax_snapshot_resumes_in_the_port(jax_steps):
    _out, snap = jax_steps[0]
    assert snap.bit % 8 != 0  # a sub-byte block boundary
    state = TC.DeviceInflateState(**_fields(snap))
    assert _fields(state) == _fields(snap)
    state = pickle.loads(pickle.dumps(state))
    out, nxt = TC.decode_step(BODY, state, target=STEP, device="cpu")
    rout, rnxt = JC.decode_step(BODY, snap, target=STEP, interpret=True)
    assert out == rout and _fields(nxt) == _fields(rnxt)
    tail = bytearray(out)
    while not nxt.finished:
        out, nxt = TC.decode_step(BODY, nxt, target=STEP, device="cpu")
        tail.extend(out)
    assert jax_steps[0][0] + bytes(tail) == DATA
    # and back: the port's fields make the JAX package's state
    back = JC.DeviceInflateState(**_fields(nxt))
    assert back.finished and back.adler == zlib.adler32(DATA)


def test_undersized_max_out_raises_like_jax():
    # the block that crosses the target overruns a budget of the target
    with pytest.raises(ValueError, match="checkpoint decode failed"):
        TC.decode_step(BODY, TC.DeviceInflateState(), target=STEP, max_out=STEP, device="cpu")
    with pytest.raises(ValueError, match="checkpoint decode failed"):
        JC.decode_step(BODY, JC.DeviceInflateState(), target=STEP, max_out=STEP, interpret=True)


def test_finished_state_is_terminal():
    st = TC.DeviceInflateState(finished=True, produced=5)
    assert TC.decode_step(BODY, st, target=10, device="cpu") == (b"", st)


def test_bad_data_raises_like_jax():
    body = bytearray(_raw(DATA[:30_000], mem=8))
    body[1] ^= 0xFF  # the first block's header
    with pytest.raises(ValueError, match="checkpoint decode failed"):
        TC.decode_step(bytes(body), TC.DeviceInflateState(), target=STEP, device="cpu")
    with pytest.raises(ValueError, match="checkpoint decode failed"):
        JC.decode_step(bytes(body), JC.DeviceInflateState(), target=STEP, interpret=True)


def test_no_device_means_the_gpu(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TC.decode_step(BODY, TC.DeviceInflateState(), target=STEP)


# ---------------------------------------------------------------------------
# decompress_chunks: regions with windows and sub-byte start bits
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def regions():
    """Regions of BODY cut at the port's checkpoint boundaries: each starts
    at a sub-byte bit with the output before it as its window."""
    bodies, sizes, windows, starts = [], [], [], []
    state = TC.DeviceInflateState()
    while not state.finished:
        out, nxt = TC.decode_step(BODY, state, target=25_000, device="cpu")
        first, last = state.bit >> 3, (nxt.bit + 7) >> 3
        bodies.append(BODY[first:last])
        starts.append(state.bit & 7)
        sizes.append(len(out))
        windows.append(DATA[: state.produced])
        state = nxt
    assert len(bodies) >= 4 and any(starts)
    return bodies, sizes, windows, starts


def test_decompress_chunks_equals_jax(regions):
    bodies, sizes, windows, starts = regions
    got = TI.decompress_chunks(bodies, sizes, windows, starts, engine="kernel", device="cpu")
    assert got == JI.decompress_chunks(bodies, sizes, windows, starts, engine="kernel")
    assert b"".join(got) == DATA
    assert TI.decompress_chunks(bodies, sizes, windows, starts, device="cpu") == got


def test_decompress_chunks_bad_region(regions):
    bodies, sizes, windows, starts = regions
    bodies = list(bodies)
    bodies[1] = bodies[1][: len(bodies[1]) // 2]  # truncated
    tp._FALLBACKS.clear()
    with pytest.raises(ValueError, match="region 1"):
        TI.decompress_chunks(bodies, sizes, windows, starts, engine="kernel", device="cpu")
    assert zt.fallback_stats() == {}
    with pytest.raises(ValueError, match="region 1"):
        TI.decompress_chunks(bodies, sizes, windows, starts, device="cpu")
    assert zt.fallback_stats() == {"region_kernel:ValueError": 1}
    tp._FALLBACKS.clear()


@pytest.mark.parametrize("engine", ["lockstep", "turbo"])
def test_decompress_chunks_xla_engines_not_ported(engine):
    """"turbo" (an experiment outside the JAX package) is not ported and
    raises; "lockstep" is ported and decodes as the JAX package's does."""
    if engine == "turbo":
        with pytest.raises(NotImplementedError, match="XLA"):
            TI.decompress_chunks([_raw(b"abc")], [3], engine=engine, device="cpu")
        return
    bodies = [_raw(b"abc"), _raw(DATA[:3_000], mem=8)]
    got = TI.decompress_chunks(bodies, [3, 3_000], engine=engine, device="cpu")
    assert got == JI.decompress_chunks(bodies, [3, 3_000], engine=engine) == [b"abc", DATA[:3_000]]


def test_decompress_chunks_without_windows():
    streams = [_raw(DATA[:5_000]), _raw(b""), _raw(DATA[9_000:20_000], mem=8)]
    sizes = [5_000, 0, 11_000]
    got = TI.decompress_chunks(streams, sizes, device="cpu")
    assert got == [DATA[:5_000], b"", DATA[9_000:20_000]]
    assert TI.decompress_chunks([], [], device="cpu") == []
