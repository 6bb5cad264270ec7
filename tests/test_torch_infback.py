"""The port's inflateBack (zlib_rs_tpu_torch.models.infback: InflateBack,
inflate_back) against the JAX package's, on the same streams and the same
input pieces: the return code, the message and every window the output
callback is handed, in order."""

import zlib

import numpy as np
import pytest
import torch

import zlib_rs_tpu.models.infback as JB
from zlib_rs_tpu_torch.models import infback as TB

# the test workers share the cores, and an oversubscribed OpenMP pool spin-waits
torch.set_num_threads(1)

_BASH = open("/bin/bash", "rb").read()
_rng = np.random.default_rng(18)


def _raw(data, level=6, strategy=zlib.Z_DEFAULT_STRATEGY, wbits=-15):
    c = zlib.compressobj(level, zlib.DEFLATED, wbits, 8, strategy)
    return c.compress(data) + c.flush()


def _run(B, stream, piece, window_bits=15, abort_after=None, reuse=None):
    """inflate_back over `stream` fed `piece` bytes a call: (rc name, msg,
    the windows handed out)."""
    pieces = iter([stream[i : i + piece] for i in range(0, len(stream), piece)])
    outs = []

    def out_func(b):
        outs.append(bytes(b))
        return abort_after is None or len(outs) < abort_after

    if reuse is not None:
        rc = reuse.run(lambda: next(pieces, b""), out_func)
        return rc.name, reuse.msg, outs
    ib = B.InflateBack(window_bits)
    rc = ib.run(lambda: next(pieces, b""), out_func)
    rc2 = B.inflate_back(lambda: b"", lambda b: True, window_bits)
    return rc.name, ib.msg, outs, rc2.name


STREAMS = {
    "level1": (_BASH[:70_000], 1, zlib.Z_DEFAULT_STRATEGY),
    "level6": (_BASH[300_000:340_000], 6, zlib.Z_DEFAULT_STRATEGY),
    "level9": (_BASH[600_000:620_000], 9, zlib.Z_DEFAULT_STRATEGY),
    "fixed": (_BASH[100_000:110_000], 6, zlib.Z_FIXED),
    "stored": (_rng.integers(0, 256, 70_000, dtype=np.uint8).tobytes(), 0, 0),
    "empty": (b"", 6, 0),
}


@pytest.mark.parametrize("piece", [1, 4096])
@pytest.mark.parametrize("name", sorted(STREAMS))
def test_inflate_back_equal_jax(name, piece):
    data, level, strategy = STREAMS[name]
    stream = _raw(data, level, strategy)
    if piece == 1:
        stream = stream[:6000]  # a byte a call: keep it short
    got = _run(TB, stream, piece)
    assert got == _run(JB, stream, piece)
    if piece == 4096:
        assert got[0] == "StreamEnd" and b"".join(got[2]) == data


@pytest.mark.parametrize("window_bits", [9, 12])
def test_small_windows_equal_jax(window_bits):
    data = _BASH[200_000:230_000]
    stream = _raw(data, 6, wbits=-window_bits)
    got = _run(TB, stream, 512, window_bits)
    assert got == _run(JB, stream, 512, window_bits)
    assert b"".join(got[2]) == data and max(len(o) for o in got[2]) <= 1 << window_bits


def test_errors_abort_and_reuse_equal_jax():
    """A flipped byte, a truncated stream, an aborting output callback, a
    reserved block type, a bad window size, and one state run twice."""
    data = _BASH[50_000:120_000]
    stream = _raw(data)
    flipped = bytearray(stream)
    flipped[len(stream) // 3] ^= 0xFF
    cases = [bytes(flipped), stream[: len(stream) // 2], bytes([stream[0] | 0x06]) + stream[1:]]
    for s in cases:
        assert _run(TB, s, 1000) == _run(JB, s, 1000)
    assert _run(TB, stream, 1000, abort_after=1) == _run(JB, stream, 1000, abort_after=1)
    for B in (TB, JB):
        with pytest.raises(ValueError):
            B.InflateBack(16)
        with pytest.raises(ValueError):
            B.InflateBack(15, bytearray(100))
    reused = [B.InflateBack(15) for B in (TB, JB)]
    for s in (stream, _raw(b"second stream")):
        assert _run(TB, s, 777, reuse=reused[0]) == _run(JB, s, 777, reuse=reused[1])
