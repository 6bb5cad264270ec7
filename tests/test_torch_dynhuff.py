"""The port's batched tree builder (zlib_rs_tpu_torch.ops.dynhuff) against
the JAX package's `code_lengths_kraft` and `canonical_codes_jax`, vmapped
over the same seeded histograms. Exact equality.

The density weight 2^len is exact in the port; XLA's CPU exp2 is not at
every integer, and that reorders density ties. The comparisons therefore
run the port with XLA's own 2^len values (fixture `xla_exp2`), so that
both sides do the same float32 arithmetic; one test checks the port's
exact weights on their own."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zlib_rs_tpu.ops import dynhuff as jd
from zlib_rs_tpu_torch.ops import dynhuff as td

# the test workers share the cores, and an oversubscribed OpenMP pool spin-waits
torch.set_num_threads(1)


@pytest.fixture
def xla_exp2(monkeypatch):
    table = np.asarray(jnp.exp2(jnp.arange(16, dtype=jnp.float32))).copy()
    monkeypatch.setattr(td, "EXP2_LEN", torch.from_numpy(table))


def _hists(kind: str, seed: int, R: int = 6, n: int = 286) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "random":
        h = rng.integers(0, 2000, size=(R, n))
        h[rng.random((R, n)) < 0.3] = 0
    elif kind == "skewed":  # geometric-like: long codes near the limit
        h = (rng.pareto(0.7, size=(R, n)) * 3).astype(np.int64)
        h[:, :8] += rng.integers(10_000, 60_000, size=(R, 8))
    elif kind == "single":
        h = np.zeros((R, n), np.int64)
        h[np.arange(R), rng.integers(0, n, size=R)] = rng.integers(1, 5000, size=R)
    elif kind == "zero":
        h = np.zeros((R, n), np.int64)
    elif kind == "chunk_like":  # the trees of a 32 KiB chunk
        h = rng.integers(0, 900, size=(R, n))  # distance codes
        if n == 286:  # literals, EOB, length codes
            h[:, :256] = rng.integers(0, 300, size=(R, 256))
            h[:, 256] = 1
    else:
        raise ValueError(kind)
    return h.astype(np.int32)


def _jax_trees(h: np.ndarray):
    lens = np.asarray(jax.vmap(jd.code_lengths_kraft)(jnp.asarray(h)))
    codes = np.asarray(jax.vmap(jd.canonical_codes_jax)(jnp.asarray(lens)))
    return lens, codes


@pytest.mark.parametrize("kind", ["random", "skewed", "single", "zero", "chunk_like"])
@pytest.mark.parametrize("n", [286, 30])
def test_lengths_and_codes_equal_jax(kind, n, xla_exp2):
    h = _hists(kind, seed=len(kind) * 31 + n, n=n)
    jlens, jcodes = _jax_trees(h)
    tlens = td.code_lengths_kraft(torch.from_numpy(h))
    tcodes = td.canonical_codes(tlens)
    assert tlens.dtype == torch.int32 and tcodes.dtype == torch.int32
    np.testing.assert_array_equal(tlens.numpy(), jlens)
    np.testing.assert_array_equal(tcodes.numpy().astype(np.uint32), jcodes.astype(np.uint32))


def test_codes_from_the_same_lengths_equal_jax():
    rng = np.random.default_rng(7)
    h = rng.integers(0, 5000, size=(8, 286)).astype(np.int32)
    lens = np.asarray(jax.vmap(jd.code_lengths_kraft)(jnp.asarray(h))).copy()
    got = td.canonical_codes(torch.from_numpy(lens)).numpy().astype(np.uint32)
    want = np.asarray(jax.vmap(jd.canonical_codes_jax)(jnp.asarray(lens)))
    np.testing.assert_array_equal(got, want.astype(np.uint32))


@pytest.mark.parametrize("kind", ["random", "skewed", "chunk_like"])
def test_exact_weights_give_complete_limited_codes(kind):
    # the port's own (exact 2^len) weights: a complete prefix code within
    # 15 bits, decodable as a canonical code
    h = _hists(kind, seed=99)
    lens = td.code_lengths_kraft(torch.from_numpy(h)).numpy()
    for r in range(h.shape[0]):
        used = h[r] > 0
        assert ((lens[r] > 0) == used).all()
        assert lens[r].max() <= 15
        if used.sum() > 1:
            assert sum(2.0 ** -int(l) for l in lens[r][used]) == 1.0
