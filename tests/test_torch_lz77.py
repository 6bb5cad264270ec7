"""The XLA encode engine's stages (zlib_rs_tpu_torch.ops.lz77, batched
over chunks) against the JAX package's (zlib_rs_tpu.ops.lz77, one chunk
vmapped) on the same seeded inputs. Every comparison is exact.

The batch holds a slice of /bin/bash primed with a dictionary that starts
past 0 (`valid_from > 0`, `start` at the dictionary's end), a 300-byte run
before more of /bin/bash, and random bytes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zlib_rs_tpu.ops import lz77 as jl
from zlib_rs_tpu_torch.ops import lz77 as tl

# the test workers share the cores, and an oversubscribed OpenMP pool spin-waits
torch.set_num_threads(1)

_BASH = open("/bin/bash", "rb").read()
N = 4_096  # positions a chunk buffer
START = 800  # the dictionary's end: the first emitted position

# each level's (chain_depth, max_words, lazy), as the pipelines map them
KNOBS = {1: (1, 8, False), 3: (4, 16, False), 6: (12, 32, True), 9: (24, 64, True)}


def _batch():
    rng = np.random.default_rng(13)
    rows = [
        _BASH[200_000 : 200_000 + N],
        b"a" * 300 + _BASH[40_000 : 40_000 + N - 300],
        rng.integers(0, 256, N, dtype=np.uint8).tobytes(),
    ]
    padded = np.zeros((len(rows), N + tl.PAD), np.uint8)
    for r, row in enumerate(rows):
        padded[r, : len(row)] = np.frombuffer(row, np.uint8)
    n_valid = np.array([N, N - 17, N], np.int32)
    valid_from = np.array([300, 0, 0], np.int32)  # a short dictionary in row 0
    return padded, n_valid, valid_from


PADDED, NV, VF = _batch()
_JAX = {}


def _jv(fn):
    """The JAX function vmapped over the batch and compiled as one program
    (half the compile time of op-by-op dispatch)."""
    return jax.jit(jax.vmap(fn))


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_matches(level):
    if ("m", level) not in _JAX:
        cd, mw, lazy = KNOBS[level]
        _JAX[("m", level)] = tuple(np.asarray(a) for a in _jv(
            lambda p, nv, vf: jl.find_matches(p, nv, chain_depth=cd, max_words=mw, lazy=lazy,
                                              valid_from=vf)
        )(jnp.asarray(PADDED), jnp.asarray(NV), jnp.asarray(VF)))
    return _JAX[("m", level)]


def _jax_tokens(level):
    if ("t", level) not in _JAX:
        length, _ = _jax_matches(level)
        _JAX[("t", level)] = np.asarray(_jv(lambda l, nv: jl.greedy_parse(l, nv, START))(
            jnp.asarray(length), jnp.asarray(NV)))
    return _JAX[("t", level)]


def test_words_and_hash_equal_jax():
    rng = np.random.default_rng(5)
    row = rng.integers(0, 256, (2, 4_096), dtype=np.uint8)
    row[0, :8] = 0xFF  # the top bits of the product
    got = tl.words_le32(_t(row))
    want = np.stack([np.asarray(jl.words_le32(jnp.asarray(r))) for r in row])
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(tl.hash4(got).numpy(), np.asarray(jl.hash4(jnp.asarray(want))))


@pytest.mark.parametrize("level", [1, 3, 6, 9])
def test_find_matches_equal_jax(level):
    cd, mw, lazy = KNOBS[level]
    length, dist = tl.find_matches(_t(PADDED), _t(NV), chain_depth=cd, max_words=mw,
                                   lazy=lazy, valid_from=_t(VF))
    assert length.dtype == dist.dtype == torch.int32
    jlen, jdist = _jax_matches(level)
    np.testing.assert_array_equal(length.numpy(), jlen)
    np.testing.assert_array_equal(dist.numpy(), jdist)
    # the inputs reach the rules they are here for
    assert (length[1] == tl.MAX_MATCH).any()  # the run, past the word cap
    assert (length[0, : VF[0]] == 0).all()  # before the dictionary
    assert (length[1, NV[1]:] == 0).all()  # past the data
    if level >= 6:
        assert int(length.max()) > 4 * tl.STAGE_WORDS  # the winner's extension


@pytest.mark.parametrize("level", [1, 6])
def test_greedy_parse_equal_jax(level):
    jlen, _ = _jax_matches(level)
    got = tl.greedy_parse(_t(jlen), _t(NV), START)
    np.testing.assert_array_equal(got.numpy(), _jax_tokens(level))
    # the mask tiles [START, n_valid) exactly, as a serial greedy walk does
    for r in range(len(NV)):
        i = START
        while i < NV[r]:
            assert got[r, i]
            i += max(int(jlen[r, i]), 1)
        assert not got[r, START:].numpy()[np.arange(START, N) >= NV[r]].any()


def test_symbol_arithmetic_and_bit_reverse_equal_jax():
    lens = np.arange(3, 259, dtype=np.int32)
    for got, want in zip(tl.length_symbol_arith(_t(lens).long()),
                         jl.length_symbol_arith(jnp.asarray(lens))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    dists = np.arange(1, 32769, dtype=np.int32)
    for got, want in zip(tl.dist_symbol_arith(_t(dists).long()),
                         jl.dist_symbol_arith(jnp.asarray(dists))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    syms = np.arange(288, dtype=np.int32)
    for got, want in zip(tl.static_litlen_code(_t(syms).long()),
                         jl.static_litlen_code(jnp.asarray(syms))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    v = np.arange(1 << 15, dtype=np.int32)
    nb = (v % 15 + 1).astype(np.int32)
    np.testing.assert_array_equal(tl.bit_reverse(_t(v), _t(nb)).numpy(),
                                  np.asarray(jl.bit_reverse_jax(jnp.asarray(v), jnp.asarray(nb))))


def _live_fields_fit(value, nbits):
    """Every live field lies below 2^nbits: pack_bits' sums are then ORs."""
    v, nb = value.long(), nbits.long()
    live = nb > 0
    assert live.any()
    assert ((v[live] >> nb[live]) == 0).all()


@pytest.mark.parametrize("level", [1, 6])
def test_token_codes_static_equal_jax(level):
    jlen, jdist = _jax_matches(level)
    tok = _jax_tokens(level)
    value, nbits = tl.token_codes_static(_t(PADDED), _t(jlen), _t(jdist), _t(tok))
    jv, jn = _jv(jl.token_codes_static)(jnp.asarray(PADDED), jnp.asarray(jlen),
                                             jnp.asarray(jdist), jnp.asarray(tok))
    np.testing.assert_array_equal(value.numpy(), np.asarray(jv).astype(np.int64))
    np.testing.assert_array_equal(nbits.numpy(), np.asarray(jn))
    _live_fields_fit(value, nbits)
    is_match = (_t(tok) & (_t(jlen) >= 3))
    assert is_match.any() and (nbits[is_match] > 9).all()  # matches and literals both


def test_pack_bits_with_dead_tokens_equal_jax():
    rng = np.random.default_rng(21)
    B, T = 3, 1_500
    nbits = rng.integers(1, 33, (B, T)).astype(np.int32)
    nbits[rng.random((B, T)) < 0.4] = 0  # dead tokens among the live
    nbits[2] = 0
    nbits[2, ::7] = 32  # whole words at every alignment
    value = (rng.integers(0, 1 << 32, (B, T), dtype=np.uint64)
             & ((np.uint64(1) << nbits.astype(np.uint64)) - np.uint64(1))).astype(np.uint32)
    value[nbits == 0] = rng.integers(0, 1 << 32, int((nbits == 0).sum()), dtype=np.uint64)
    out_words = (32 * T + 64) // 32 + 2
    words, total = tl.pack_bits(_t(value.astype(np.int64)), _t(nbits), 5, out_words)
    _live_fields_fit(torch.where(_t(nbits) > 0, _t(value.astype(np.int64)), 0), _t(nbits))
    jw, jt = _jv(lambda v, n: jl.pack_bits(v, n, 5, out_words))(
        jnp.asarray(value), jnp.asarray(nbits))
    assert words.dtype == torch.int32
    np.testing.assert_array_equal(words.numpy().view(np.uint32), np.asarray(jw))
    np.testing.assert_array_equal(total.numpy(), np.asarray(jt))
    assert int(total[0]) == 5 + int(nbits[0].sum())


@pytest.mark.parametrize("level", [1, 3, 9])
def test_encode_chunk_static_equal_jax(monkeypatch, level):
    cd, mw, lazy = KNOBS[level]
    finals = np.array([0, 0, 1], np.int32)
    seen = []
    real = tl.pack_bits
    monkeypatch.setattr(tl, "pack_bits", lambda v, n, *a: seen.append((v, n)) or real(v, n, *a))
    words, total = tl.encode_chunk_static(
        _t(PADDED), _t(NV), _t(finals), chain_depth=cd, max_words=mw, lazy=lazy, start=START,
        valid_from=_t(VF))
    jw, jt = _jv(lambda p, nv, f, vf: jl.encode_chunk_static(
        p, nv, f, chain_depth=cd, max_words=mw, lazy=lazy, start=START, valid_from=vf)
    )(jnp.asarray(PADDED), jnp.asarray(NV), jnp.asarray(finals), jnp.asarray(VF))
    np.testing.assert_array_equal(words.numpy().view(np.uint32), np.asarray(jw))
    np.testing.assert_array_equal(total.numpy(), np.asarray(jt))
    assert len(seen) == 1
    _live_fields_fit(*seen[0])
    assert (words[:, 0] & 7).tolist() == [2, 2, 3]  # BTYPE 01, BFINAL on the last
