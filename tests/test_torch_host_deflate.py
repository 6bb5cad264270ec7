"""The host deflate engine behind a non-default strategy: the port's
`compress_parallel(strategy=...)` (a copy of the JAX package's
models/deflate.py, trees.py and the tables under them, routed as
zlib_rs_tpu/parallel/pipeline.py routes it) against the JAX package's,
byte for byte, and decoded by zlib. Each stream's length and sha256 are
what chip_smoke.py's phase 34 prints for its own input."""

import hashlib
import zlib

import pytest
import torch

import zlib_rs_tpu.parallel.pipeline as jp
import zlib_rs_tpu_torch as zt
from zlib_rs_tpu_torch.config import DeflateConfig, Strategy
from zlib_rs_tpu_torch.models import deflate as TD

# the test workers share the cores, and an oversubscribed OpenMP pool spin-waits
torch.set_num_threads(1)

# level 9 under Filtered and Fixed walks long chains: a slice of /bin/bash
# where that takes seconds, not tens of them
SLICE = open("/bin/bash", "rb").read()[300_000:370_001]
INPUTS = {"empty": b"", "one": b"\x7f", "slice": SLICE}
STRATEGIES = (Strategy.Filtered, Strategy.HuffmanOnly, Strategy.Rle, Strategy.Fixed)
WRAPS = {"zlib": 15, "gzip": 31, "raw": -15}


@pytest.mark.parametrize("wrap", list(WRAPS))
@pytest.mark.parametrize("level", [1, 6, 9])
@pytest.mark.parametrize("strategy", STRATEGIES, ids=lambda s: s.name)
@pytest.mark.parametrize("name", list(INPUTS))
def test_strategy_equal_jax(name, strategy, level, wrap):
    data = INPUTS[name]
    wbits = WRAPS[wrap]
    got = zt.compress_parallel(data, level, window_bits=wbits, strategy=strategy, device="cpu")
    want = jp.compress_parallel(data, level, window_bits=wbits, strategy=strategy)
    assert hashlib.sha256(got).hexdigest() == hashlib.sha256(want).hexdigest()
    assert got == want
    assert zlib.decompress(got, wbits) == data


@pytest.mark.parametrize("strategy", STRATEGIES, ids=lambda s: s.name)
def test_strategy_with_index_raises(strategy):
    for compress in (zt.compress_parallel, jp.compress_parallel):
        with pytest.raises(ValueError, match="default strategy"):
            compress(SLICE, 6, strategy=strategy, return_index=True)


def test_default_strategy_is_the_device_engine():
    """Strategy.Default (and None) keep the device engines: the stream is
    the port's chunk-parallel one, not the host engine's."""
    data = SLICE[:40_000]
    dev = zt.compress_parallel(data, 6, device="cpu")
    assert zt.compress_parallel(data, 6, strategy=Strategy.Default, device="cpu") == dev
    assert zlib.decompress(dev) == data
    assert dev != TD.compress(data, DeflateConfig(6))
