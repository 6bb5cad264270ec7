"""The swarm walker kernel's design (csrc/swarm.cu) as a Python model, held
against the kernel's plain version (`swarm_inflate.walk_plain`) exactly:
the walker-major tapes, each walker's end bit, remaining span and bad
flag. The JAX package's engine is held against the plain version in
tests/test_torch_swarm_inflate.py.

The model is the kernel's control flow: a walker at a time, to its own
end (a walker that is covered or bad never moves again in the reference,
so the rows after it stays null), reading the 12 bytes at its cursor
with the byte offset clamped to [0, L - 9] and zeros past the row, then
the literal/length and distance entries of its chunk's flat tables.
Inputs: the port's own indexed stream of /bin/bash (3 chunks of 128 KiB,
128 seeds each), the same with a flipped byte, a cap below the steps
the walkers need, a walker with no span, and walkers seeded near the row's
end and past it."""

import numpy as np
import pytest
import torch

import zlib_rs_tpu_torch as zt
from zlib_rs_tpu_torch.parallel import device_inflate as DI
from zlib_rs_tpu_torch.parallel import swarm_inflate as SW

# the test workers share the cores, and an oversubscribed OpenMP pool spin-waits
torch.set_num_threads(1)

DATA = open("/bin/bash", "rb").read()[120_000:420_000]


@pytest.fixture(scope="module")
def seeded():
    out, index = zt.compress_parallel(DATA, 6, return_index=True, device="cpu")
    bodies = [out[o : o + n] for o, n, _ in index]
    sizes = [m for *_, m in index]
    *arrays, cap = SW.seeded_inputs(bodies, sizes, index.seeds)
    comp, ll, dd, sbit, sspan = arrays
    rev = torch.from_numpy(DI._REV15_NP)
    ll_lut = DI._build_flat_lut(torch.from_numpy(ll), *DI._ll_symbol_fields(320), rev).numpy()
    d_lut = DI._build_flat_lut(torch.from_numpy(dd), *DI._d_symbol_fields(320), rev).numpy()
    return dict(comp=comp, ll=ll_lut, dl=d_lut, sbit=sbit, sspan=sspan, cap=cap)


def model(comp, ll_lut, d_lut, sbit, sspan, cap):
    """The kernel's outputs: tapes [B, S * cap], end bits, remaining, bad."""
    B, L = comp.shape
    S = sbit.shape[1]
    tk = np.zeros((B * S, cap), np.uint8)
    ta = np.zeros((B * S, cap), np.int32)
    tb = np.zeros((B * S, cap), np.int32)
    end = np.zeros(B * S, np.int64)
    rem = np.zeros(B * S, np.int64)
    bad = np.zeros(B * S, bool)
    for w in range(B * S):
        lane = w // S
        row = comp[lane].tobytes() + bytes(4)
        ll, dl = ll_lut[lane], d_lut[lane]
        bitpos, remaining, is_bad = int(sbit.flat[w]), int(sspan.flat[w]), False
        it = 0
        while it < cap and remaining > 0 and not is_bad:
            off = min(max(bitpos >> 3, 0), L - 9)
            v = int.from_bytes(row[off : off + 12], "little") >> (bitpos & 7)
            e = int(ll[v & 0x7FFF])
            kind, aux, nb, payload = e >> 28, (e >> 22) & 0x3F, (e >> 16) & 0x3F, e & 0xFFFF
            length = payload + ((v >> nb) & ((1 << aux) - 1))
            win2 = (v >> (nb + aux)) & 0xFFFFFFFF
            de = int(dl[win2 & 0x7FFF])
            dkind, daux, dnb = de >> 28, (de >> 22) & 0x3F, (de >> 16) & 0x3F
            dist = (de & 0xFFFF) + ((win2 >> dnb) & ((1 << daux) - 1))
            is_lit = kind == DI.KIND_LIT
            is_match = kind == DI.KIND_MATCH and dkind == DI.KIND_MATCH
            cover = 1 if is_lit else length if is_match else 0
            if (kind in (DI.KIND_INVALID, DI.KIND_EOB) or (kind == DI.KIND_MATCH and not is_match)
                    or cover > remaining):
                is_bad = True
            else:
                tk[w, it] = DI.TOK_LIT if is_lit else DI.TOK_MATCH
                ta[w, it] = cover
                tb[w, it] = payload if is_lit else dist
                bitpos += nb if is_lit else nb + aux + dnb + daux
                remaining -= cover
            it += 1
        end[w], rem[w], bad[w] = bitpos, remaining, is_bad
    return [t.reshape(B, S * cap) for t in (tk, ta, tb)] + [end, rem, bad]


def _check(s, comp=None, sbit=None, sspan=None, cap=None):
    args = [s["comp"] if comp is None else comp, s["ll"], s["dl"],
            s["sbit"] if sbit is None else sbit, s["sspan"] if sspan is None else sspan]
    cap = s["cap"] if cap is None else cap
    want = SW.walk_plain(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args), cap)
    got = model(*args, cap)
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.numpy().dtype and np.array_equal(g, w.numpy()), k
    return got


def test_clean_walkers_equal_plain(seeded):
    got = _check(seeded)
    assert not got[5].any() and not got[4].any()
    # every walker lands on the next seed's cursor
    ends = got[3].reshape(seeded["sbit"].shape)
    assert (ends[:, :-1] == seeded["sbit"][:, 1:]).all()


def test_flipped_byte_equal_plain(seeded):
    comp = seeded["comp"].copy()
    comp[1, 20_000] ^= 0xFF
    got = _check(seeded, comp=comp)
    ends = got[3].reshape(seeded["sbit"].shape)
    drift = (ends[:, :-1] != seeded["sbit"][:, 1:]).any(axis=1)
    assert (got[5].reshape(ends.shape).any(axis=1) | drift).tolist() == [False, True, False]


def test_step_cap_and_empty_span_equal_plain(seeded):
    sspan = seeded["sspan"].copy()
    sspan[0, 7] = 0  # a walker with no span never moves
    got = _check(seeded, sspan=sspan, cap=64)
    assert got[4].reshape(sspan.shape)[0, 7] == 0 and got[3].reshape(sspan.shape)[0, 7] == \
        seeded["sbit"][0, 7]
    assert (got[4] > 0).any()  # walkers stopped at the cap with bytes left


def test_walkers_at_and_past_the_row_end_equal_plain(seeded):
    """Cursors in the last bytes of a row and past it read the clamped
    window (the offset held at L - 9 whatever the cursor), as the plain
    version's do."""
    comp = seeded["comp"]
    L = comp.shape[1]
    sbit = seeded["sbit"].copy()
    sbit[2, :4] = [8 * (L - 12) + 3, 8 * (L - 9) + 5, 8 * L + 1, 8 * (L + 40)]
    got = _check(seeded, sbit=sbit)
    assert got[5].reshape(sbit.shape)[2, :4].any()
