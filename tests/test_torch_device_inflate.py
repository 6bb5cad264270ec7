"""The lockstep region engine (zlib_rs_tpu_torch.parallel.device_inflate.
decode_regions, device="cpu") against the JAX package's (jitted on the
CPU), on the same arrays, and `decompress_chunks` under its three engines
against the JAX package's bytes. Every comparison is exact.

The regions are at most 4 KiB of output (the port's step loop costs about
half a millisecond a step on the CPU): stored, fixed and dynamic blocks,
several to a region, regions cut by the zran index at sub-byte starts
with their windows, bad regions (a truncated body, a reserved block
type) and the lone-EOB body that K6 refuses. The port reads its loop's
flags every step outside its symbol blocks, and a block's step counts
only while every running lane decodes symbols at its start, so `n_steps`
is the reference's by construction; it is compared on every input, at
the default block and at blocks of 1 and 5 steps."""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zlib_rs_tpu.parallel.device_inflate as JDI
import zlib_rs_tpu.parallel.inflate as JI
import zlib_rs_tpu.parallel.pipeline as jp
from zlib_rs_tpu_torch.models import zran as TZ
from zlib_rs_tpu_torch.parallel import device_inflate as DI
from zlib_rs_tpu_torch.parallel import inflate as TI
from zlib_rs_tpu_torch.parallel import pipeline as tp

# the test workers share the cores, and an oversubscribed OpenMP pool spin-waits
torch.set_num_threads(1)

_BASH = open("/bin/bash", "rb").read()
rng = np.random.default_rng(14)
LONE_EOB = bytes.fromhex("05c0810800000000207feb03")  # a dynamic block whose only code is EOB


def _raw(data, level=6, mem=8, strategy=zlib.Z_DEFAULT_STRATEGY, flush=zlib.Z_FINISH):
    c = zlib.compressobj(level, zlib.DEFLATED, -15, mem, strategy)
    return c.compress(data) + c.flush(flush)


def _text(n):
    words = [b"region", b"lockstep", b"deflate", b"window", b"symbol", b"block", b"\n"]
    picks = rng.integers(0, len(words), n)
    return b" ".join(words[i] for i in picks)[:n]


def _blocks():
    """(body, output) pairs: each body several blocks of mixed types, the
    earlier ones ended by a sync flush (byte-aligned, not final)."""
    out = []
    for k in range(3):
        parts = [_text(900 + 100 * k), rng.integers(0, 256, 700, dtype=np.uint8).tobytes(),
                 _BASH[20_000 * k : 20_000 * k + 1_200]]
        body = (_raw(parts[0], strategy=zlib.Z_FIXED, flush=zlib.Z_SYNC_FLUSH)
                + _raw(parts[1], level=0, flush=zlib.Z_SYNC_FLUSH)
                + _raw(parts[2], level=6 + k, mem=1))
        out.append((body, b"".join(parts)))
    out.append((_raw(_BASH[70_000:73_000], level=1), _BASH[70_000:73_000]))
    out.append((_raw(b""), b""))
    return out


def _primed():
    """(body, output, window, start bit) regions of a stream of small
    blocks, cut at the zran index's points."""
    seg = _BASH[100_000:116_000]
    stream = _raw(seg, mem=1)
    index = TZ.build_index(stream, span=3_000, device="cpu")
    cuts = [(p.in_offset * 8 - p.bits, p.out_offset, p.window) for p in index.points]
    cuts.append((len(stream) * 8, index.total_out, b""))
    regions = []
    for (bit, out, win), (ebit, eout, _w) in zip(cuts, cuts[1:]):
        if eout > out:
            regions.append((stream[bit >> 3 : ((ebit + 7) >> 3) + 8], seg[out:eout], win,
                            bit & 7))
    assert len(regions) >= 3 and sum(r[3] != 0 for r in regions) >= 2
    return regions


def _corrupt():
    """A truncated body (its bits run out before its target) and one whose
    first block has the reserved BTYPE 3, with their outputs."""
    body = _raw(_BASH[30_000:33_000])
    return [(body[: len(body) // 2], _BASH[30_000:33_000]),
            (bytes([body[0] ^ 0x02]) + body[1:], _BASH[30_000:33_000])]


def _case(name):
    """(bodies, outputs, windows or None, start bits or None)."""
    if name == "blocks":
        pairs = _blocks()
        return [b for b, _ in pairs], [o for _, o in pairs], None, None
    if name == "primed":
        regs = _primed()
        return ([r[0] for r in regs], [r[1] for r in regs], [r[2] for r in regs],
                [r[3] for r in regs])
    if name == "corrupt":
        (b1, o1), (b2, o2) = _corrupt()
        return ([_raw(b"before"), b1, b2, _raw(b"after")], [b"before", o1, o2, b"after"], None,
                None)
    if name == "lone_eob":
        return [LONE_EOB, _raw(_BASH[:2_000])], [b"", _BASH[:2_000]], None, None
    raise KeyError(name)


CASES = ("blocks", "primed", "corrupt", "lone_eob")


def _arrays(bodies, outputs, start_bits):
    B = len(bodies)
    L = max(len(b) for b in bodies) + 8
    comp = np.zeros((B, L), np.uint8)
    for i, b in enumerate(bodies):
        comp[i, : len(b)] = np.frombuffer(b, np.uint8)
    sb = np.asarray(start_bits or [0] * B, np.int32)
    eb = np.array([len(b) * 8 for b in bodies], np.int32)
    tg = np.array([len(o) for o in outputs], np.int32)
    return comp, sb, eb, tg


@pytest.mark.parametrize("case", CASES)
def test_decode_regions_equal_jax(case):
    bodies, outputs, _windows, start_bits = _case(case)
    comp, sb, eb, tg = _arrays(bodies, outputs, start_bits)
    max_out = 4096
    max_steps = max_out + 2 + 512
    want = JDI.decode_regions(jnp.asarray(comp), jnp.asarray(sb), jnp.asarray(eb),
                              jnp.asarray(tg), max_steps=max_steps, max_out=max_out)
    got = DI.decode_regions(*(torch.from_numpy(a) for a in (comp, sb, eb, tg)), max_steps)
    names = ("tok_kind", "tok_a", "tok_b", "n_steps", "produced", "bad")
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        g = np.asarray(g) if isinstance(g, int) else g.numpy()
        assert g.dtype == w.dtype or name == "n_steps", name
        assert g.shape == w.shape and np.array_equal(g, w), name
    assert got[3] < max_steps
    assert got[5].tolist() == ([False, True, True, False] if case == "corrupt"
                               else [False] * len(bodies))


@pytest.mark.parametrize("block", [1, 5])
@pytest.mark.parametrize("case", ["blocks", "corrupt"])
def test_decode_regions_symbol_blocks_equal_jax(monkeypatch, case, block):
    """Symbol blocks of 1 and 5 steps, whose edges fall at other steps:
    the tapes, counts and flags stay the JAX package's."""
    bodies, outputs, _windows, start_bits = _case(case)
    comp, sb, eb, tg = _arrays(bodies, outputs, start_bits)
    want = JDI.decode_regions(jnp.asarray(comp), jnp.asarray(sb), jnp.asarray(eb),
                              jnp.asarray(tg), max_steps=4096 + 514, max_out=4096)
    monkeypatch.setattr(DI, "SYMBOL_BLOCK", block)
    blocks = DI.runs["symbol_blocks"]
    got = DI.decode_regions(*(torch.from_numpy(a) for a in (comp, sb, eb, tg)), 4096 + 514)
    assert DI.runs["symbol_blocks"] > blocks
    assert got[3] == int(want[3])
    for g, w in zip(got[:3] + got[4:], want[:3] + want[4:]):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_decode_regions_step_cap_equal_jax():
    """A cap below the steps the regions need: both stop at the cap, with
    the same tapes and the lanes still running neither done nor bad."""
    bodies, outputs, _w, _s = _case("blocks")
    comp, sb, eb, tg = _arrays(bodies, outputs, None)
    want = JDI.decode_regions(jnp.asarray(comp), jnp.asarray(sb), jnp.asarray(eb),
                              jnp.asarray(tg), max_steps=300, max_out=4096)
    got = DI.decode_regions(*(torch.from_numpy(a) for a in (comp, sb, eb, tg)), 300)
    assert got[3] == int(want[3]) == 300
    for g, w in zip(got[:3] + got[4:], want[:3] + want[4:]):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_decode_regions_needs_a_zero_last_byte():
    comp = torch.full((1, 16), 7, dtype=torch.uint8)
    one = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="zero byte"):
        DI.decode_regions(comp, one * 0, one * 64, one, 8)


def test_cl_table_equal_jax():
    """The 2^7 code-length table of the port's batched build against the
    JAX package's, on random length sets (complete, incomplete and
    over-subscribed)."""
    lens = rng.integers(0, 8, (24, 19)).astype(np.int32)
    lens[:4] = 0
    lens[0, [0, 8]] = 1  # a complete 2-symbol code
    want = np.stack([np.asarray(JDI._build_flat_lut(jnp.asarray(ln), *JDI._cl_symbol_fields(),
                                                    jnp.asarray(JDI._REV7_NP), JDI.CL_BITS))
                     for ln in lens])
    got = DI._build_flat_lut(torch.from_numpy(lens), *DI._cl_symbol_fields(),
                             torch.from_numpy(DI._REV7_NP), DI.CL_BITS)
    assert np.array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("engine", ["lockstep", "kernel", "auto"])
@pytest.mark.parametrize("case", ["blocks", "primed"])
def test_decompress_chunks_equal_jax(case, engine):
    bodies, outputs, windows, start_bits = _case(case)
    tp._FALLBACKS.clear()
    got = TI.decompress_chunks(bodies, [len(o) for o in outputs], windows, start_bits,
                               engine=engine, device="cpu")
    assert got == outputs
    assert got == JI.decompress_chunks(bodies, [len(o) for o in outputs], windows, start_bits,
                                       engine=engine)
    assert tp.fallback_stats() == {}


def test_auto_recovers_lone_eob():
    """K6 refuses the lone-EOB body; "auto" counts it once and decodes
    the refused region on the lockstep engine, which gives the JAX
    package's bytes. (The JAX package's "auto" runs its kernel on a TPU only, so on
    the CPU it goes to its lockstep engine directly and counts nothing.)"""
    bodies, outputs, _w, _s = _case("lone_eob")
    sizes = [len(o) for o in outputs]
    tp._FALLBACKS.clear()
    jp._FALLBACKS.clear()
    with pytest.raises(ValueError, match="region 0"):
        TI.decompress_chunks(bodies, sizes, engine="kernel", device="cpu")
    with pytest.raises(ValueError, match="region 0"):
        JI.decompress_chunks(bodies, sizes, engine="kernel")
    assert tp.fallback_stats() == {}
    got = TI.decompress_chunks(bodies, sizes, device="cpu")
    assert tp.fallback_stats() == {"region_kernel:ValueError": 1}
    assert got == outputs == JI.decompress_chunks(bodies, sizes, engine="lockstep")
    assert got == JI.decompress_chunks(bodies, sizes) and jp.fallback_stats() == {}
    tp._FALLBACKS.clear()


@pytest.mark.parametrize("engine", ["lockstep", "auto"])
def test_bad_region_raises_like_jax(engine):
    bodies, outputs, _w, _s = _case("corrupt")
    sizes = [len(o) for o in outputs]
    with pytest.raises(ValueError, match="region 1 failed") as want:
        JI.decompress_chunks(bodies, sizes, engine="lockstep")
    tp._FALLBACKS.clear()
    with pytest.raises(ValueError, match="region 1 failed") as got:
        TI.decompress_chunks(bodies, sizes, engine=engine, device="cpu")
    assert str(got.value) == str(want.value)
    assert tp.fallback_stats() == ({"region_kernel:ValueError": 1} if engine == "auto" else {})
    tp._FALLBACKS.clear()
