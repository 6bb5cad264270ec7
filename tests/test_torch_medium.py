"""The port's pure-Python MEDIUM and QUICK deflate modes
(zlib_rs_tpu_torch.models.medium: compress_medium, compress_quick) against
the JAX package's, byte for byte, each stream also decoded by stdlib
zlib. (The CLI's --quick and --medium exit 1, as the reference's do
without its native engine: tests/test_torch_cli.py.)"""

import zlib

import numpy as np
import pytest
import torch

import native_build  # noqa: F401  (the JAX package's native library, built once under a lock)

import zlib_rs_tpu.models.medium as JM
from zlib_rs_tpu_torch.models import medium as TM

# the test workers share the cores, and an oversubscribed OpenMP pool spin-waits
torch.set_num_threads(1)

_rng = np.random.default_rng(19)
CASES = {
    "binary": open("/bin/bash", "rb").read()[:60_000],
    "runs": b"a" * 20_000 + b"xyz" * 4000 + b"\x00" * 8_000,
    "random": _rng.integers(0, 256, 20_000, dtype=np.uint8).tobytes(),
    "tiny": b"abcabcabc",
    "empty": b"",
}


@pytest.mark.parametrize("level", [4, 5, 6])
@pytest.mark.parametrize("name", sorted(CASES))
def test_medium_equal_jax(name, level):
    data = CASES[name]
    got = TM.compress_medium(data, level)
    assert got == JM.compress_medium(data, level)
    assert zlib.decompress(got, -15) == data


@pytest.mark.parametrize("final", [True, False])
@pytest.mark.parametrize("name", sorted(CASES))
def test_quick_equal_jax(name, final):
    data = CASES[name]
    got = TM.compress_quick(data, final=final)
    assert got == JM.compress_quick(data, final=final)
    d = zlib.decompressobj(-15)
    assert d.decompress(got) == data
