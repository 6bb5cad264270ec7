"""The port's batched tree builder (zlib_rs_tpu_torch.ops.dynhuff) against
the JAX package's `code_lengths_kraft` and `canonical_codes_jax`, vmapped
over the same seeded histograms, and the XLA engine's dynamic-block encode
(`token_symbols`, `encode_chunk_dynamic` with seeds and with a given
parse) against the JAX package's. Exact equality.

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
from zlib_rs_tpu.ops import lz77 as jl
from zlib_rs_tpu.ops.pallas import deflate_kernel as jdk
from zlib_rs_tpu_torch.ops import dynhuff as td
from zlib_rs_tpu_torch.ops import lz77 as tl
from zlib_rs_tpu_torch.ops.kernels import deflate_kernel as tdk

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


# ---------------------------------------------------------------------------
# the XLA engine's dynamic-block encode
# ---------------------------------------------------------------------------

_BASH = open("/bin/bash", "rb").read()
DICT, CH = 2_048, 8_192  # a primed chunk buffer: dictionary, then data
_JAX_ENC = {}


def _chunks():
    """Two primed chunks of /bin/bash (the first with a dictionary that
    starts past 0) and a run of 'a' with a random tail."""
    rng = np.random.default_rng(17)
    rows = [_BASH[300_000 : 300_000 + DICT + CH], _BASH[90_000 : 90_000 + DICT + CH],
            b"x" * DICT + b"a" * 3_000 + rng.integers(0, 256, CH - 3_000, dtype=np.uint8).tobytes()]
    padded = np.zeros((3, DICT + CH + tl.PAD), np.uint8)
    for r, row in enumerate(rows):
        padded[r, : len(row)] = np.frombuffer(row, np.uint8)
    padded[0, :500] = 0
    n_valid = np.array([DICT + CH, DICT + CH - 5, DICT + CH], np.int32)
    valid_from = np.array([500, 0, 0], np.int32)
    return padded, n_valid, valid_from


PADDED, NV, VF = _chunks()


def _as_u32(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.int32 else a.astype(np.uint32)


def _jax_encode(key, fn, *args):
    if key not in _JAX_ENC:
        _JAX_ENC[key] = [np.asarray(a) for a in jax.jit(jax.vmap(fn))(*args)]
    return _JAX_ENC[key]


def test_token_symbols_equal_jax():
    length, dist = tl.find_matches(torch.from_numpy(PADDED), torch.from_numpy(NV), chain_depth=12,
                                   max_words=32, lazy=True, valid_from=torch.from_numpy(VF))
    tokens = tl.greedy_parse(length, torch.from_numpy(NV), DICT)
    got = td.token_symbols(torch.from_numpy(PADDED), length, dist, tokens)
    want = jax.jit(jax.vmap(jd.token_symbols))(jnp.asarray(PADDED), jnp.asarray(length.numpy()),
                                                jnp.asarray(dist.numpy()),
                                                jnp.asarray(tokens.numpy()))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[1] >= 0).any() and (got[1] == -1).any()


@pytest.mark.parametrize("level", [3, 9])
def test_encode_chunk_dynamic_with_seeds_equal_jax(monkeypatch, xla_exp2, level):
    cd, mw, lazy = {3: (4, 16, False), 9: (24, 64, True)}[level]
    seen = []
    real = tl.pack_bits
    monkeypatch.setattr(tl, "pack_bits", lambda v, n, *a: seen.append((v, n)) or real(v, n, *a))
    got = td.encode_chunk_dynamic(
        torch.from_numpy(PADDED), torch.from_numpy(NV), chain_depth=cd, max_words=mw, lazy=lazy,
        start=DICT, valid_from=torch.from_numpy(VF), n_seeds=4)
    want = _jax_encode(("dyn", level), lambda p, nv, vf: jd.encode_chunk_dynamic(
        p, nv, chain_depth=cd, max_words=mw, lazy=lazy, start=DICT, valid_from=vf, n_seeds=4),
        jnp.asarray(PADDED), jnp.asarray(NV), jnp.asarray(VF))
    assert len(got) == len(want) == 6
    np.testing.assert_array_equal(_as_u32(got[0].numpy()), _as_u32(want[0]))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), w)
    # the two fields of every token and the EOB fit their bit counts, so
    # pack_bits' sums are ORs
    (values, nbits), = seen
    live = nbits > 0
    assert ((values[live] >> nbits[live]) == 0).all()
    assert int(nbits[:, -1].min()) > 0  # the EOB
    seeds_out = got[5]
    assert (seeds_out[:, 0] == 0).all() and (seeds_out[:, 1:] > seeds_out[:, :-1]).all()


def test_encode_chunk_dynamic_parse_equals_freq_pack_chunks(xla_exp2):
    # a parse of the port's K8 scan (its plain version here), as positional
    # arrays, through encode_chunk_dynamic: the kernel engine's
    # freq_pack_chunks on the same match stream gives the same block
    chunks = torch.from_numpy(PADDED)
    nv = torch.from_numpy(NV)
    start = torch.full((3,), DICT, dtype=torch.int32)
    words4 = tdk.words_from_bytes(chunks)
    mpos, mld, nmatch, bad = tdk.scan_chunks(words4, nv, DICT, torch.from_numpy(VF), depth=128,
                                             nice=128, good=8, max_lazy=16)
    assert not bad.any() and (nmatch > 0).all()
    n = PADDED.shape[1] - tl.PAD
    parse = tdk.to_positional(mpos, mld, nmatch, n, nv, start)
    jparse = jax.jit(jax.vmap(lambda mp, ml, nm, v, st: jdk._to_positional(mp, ml, nm, n, v, st)))(
        jnp.asarray(mpos.numpy()), jnp.asarray(mld.numpy().view(np.uint32)),
        jnp.asarray(nmatch.numpy()), jnp.asarray(NV), jnp.asarray(start.numpy()))
    for g, w in zip(parse, jparse):
        np.testing.assert_array_equal(g.numpy().astype(np.int64), np.asarray(w).astype(np.int64))

    got = td.encode_chunk_dynamic(chunks, nv, start=DICT, n_seeds=4, parse=parse)
    kern = tdk.freq_pack_chunks(chunks, nv, DICT, mpos, mld, nmatch, n_seeds=4)
    assert not kern[-1].any()
    for g, k in zip(got[1:], kern[1:6]):
        np.testing.assert_array_equal(g.numpy(), k.numpy())
    for r in range(3):
        nb = (int(got[1][r]) + 7) // 8
        assert got[0][r].numpy().view(np.uint8)[:nb].tobytes() == \
            kern[0][r].numpy().view(np.uint8)[:nb].tobytes()
    want = _jax_encode("parse", lambda p, v, t, l, d: jd.encode_chunk_dynamic(
        p, v, start=DICT, n_seeds=4, parse=(t, l, d)),
        jnp.asarray(PADDED), jnp.asarray(NV), *(jnp.asarray(a.numpy()) for a in parse))
    np.testing.assert_array_equal(_as_u32(got[0].numpy()), _as_u32(want[0]))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), w)
