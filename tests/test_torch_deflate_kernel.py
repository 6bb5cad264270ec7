"""K2 (hop chase) and K3 (bit pack) of the port, as their plain PyTorch
versions, against the JAX package's Pallas kernels in interpret mode.

Each kernel is fed the JAX package's own upstream state through
`zlib_rs_tpu_torch.interop` (its htab for the chase, its match stream and
code tables for the pack), so a kernel difference is never confused with
an upstream one. Integer codec: every comparison is exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from zlib_rs_tpu.ops import dynhuff as jd
from zlib_rs_tpu.ops import lzvec as jl
from zlib_rs_tpu.ops.pallas import deflate_kernel as jdk
from zlib_rs_tpu_torch import interop
from zlib_rs_tpu_torch.ops import dynhuff as td
from zlib_rs_tpu_torch.ops.kernels import deflate_kernel as tdk

# the test workers share the cores, and an oversubscribed OpenMP pool spin-waits
torch.set_num_threads(1)

_BASH = open("/bin/bash", "rb").read()
PAD = 272
DICT, CHUNK = 4096, 8192
L6 = dict(depth=64, nice=128, good=8, max_lazy=16, w_g=6)
SEL = np.r_[0:286, 288:318]  # the histogram bins anything downstream reads


@pytest.fixture
def xla_exp2(monkeypatch):
    table = np.asarray(jnp.exp2(jnp.arange(16, dtype=jnp.float32))).copy()
    monkeypatch.setattr(td, "EXP2_LEN", torch.from_numpy(table))


def _words(buf):
    B = buf.shape[0]
    bb = buf.reshape(B, -1, 4).astype(np.uint32)
    w4 = bb[..., 0] | (bb[..., 1] << 8) | (bb[..., 2] << 16) | (bb[..., 3] << 24)
    return np.concatenate([w4, np.zeros((B, 2), np.uint32)], axis=1)


@pytest.fixture(scope="module")
def batch():
    """Three dictionary-primed chunks cut from /bin/bash (no dict, full
    dict, a short last chunk), the JAX hop tables and the JAX chase."""
    rng = np.random.default_rng(2024)
    width = DICT + CHUNK + PAD
    ins_from = np.array([DICT, 0, 0], np.int32)
    data_len = np.array([CHUNK, CHUNK, 3001], np.int32)
    buf = np.zeros((3, width), np.uint8)
    for r in range(3):
        off = int(rng.integers(0, len(_BASH) - width))
        n = DICT + int(data_len[r])
        buf[r, ins_from[r] : n] = np.frombuffer(_BASH[off + ins_from[r] : off + n], np.uint8)
    n_valid = (data_len + DICT).astype(np.int32)
    w4 = _words(buf)
    htab = np.asarray(jl.build_hop_tables(
        jnp.asarray(w4), jnp.asarray(n_valid), jnp.asarray(ins_from),
        bytes_arr=jnp.asarray(buf), **L6,
    ))
    chase = [np.asarray(x) for x in jdk.scan_chunks_hop_pallas(
        jnp.asarray(w4), jnp.asarray(n_valid), jnp.asarray(ins_from),
        start=DICT, interpret=True, bytes_arr=jnp.asarray(buf), **L6,
    )]
    return dict(buf=buf, w4=w4, n_valid=n_valid, ins_from=ins_from,
                htab=htab, chase=chase)


def _assert_chase_equal(got, ref):
    mpos, mld, nmatch, kbad, freq = ref
    tm, tl, tn, tk, tf = [t.numpy() for t in got]
    np.testing.assert_array_equal(tn, nmatch)
    np.testing.assert_array_equal(tk, kbad)
    for r in range(len(nmatch)):
        k = int(nmatch[r])
        np.testing.assert_array_equal(tm[r, :k], mpos[r, :k])
        np.testing.assert_array_equal(tl[r, :k].view(np.uint32), mld[r, :k])
    np.testing.assert_array_equal(tf[:, SEL], freq[:, SEL])


def test_chase_of_the_jax_htab_equals_pallas(batch):
    st = interop.state_from_numpy(
        {"words4": batch["w4"], "htab": batch["htab"], "n_valid": batch["n_valid"]},
        device="cpu",
    )
    raw = tdk.hop_chase(st["words4"], st["htab"], st["n_valid"], DICT, 4 * L6["w_g"])
    assert [t.dtype for t in raw] == [torch.int32] * 4
    assert raw[0].shape == (3, tdk.CAP_M + 8) and raw[3].shape == (3, 4 * 320)
    _assert_chase_equal(tdk._hop_post(*raw), batch["chase"])
    assert batch["chase"][2].min() > 100  # real parses, not all-literal


def test_scan_chunks_hop_end_to_end_equals_pallas(batch):
    got = tdk.scan_chunks_hop(
        torch.from_numpy(batch["w4"].view(np.int32)),
        torch.from_numpy(batch["n_valid"]), torch.from_numpy(batch["ins_from"]),
        start=DICT, bytes_arr=torch.from_numpy(batch["buf"]), **L6,
    )
    _assert_chase_equal(got, batch["chase"])


def test_chase_overflow_flags_bad_and_recounts_literals():
    # every position after the first is a 3-byte match at distance 1 over
    # random bytes: more than CAP_M matches, so the chunk goes bad
    rng = np.random.default_rng(3)
    n = 3 * tdk.CAP_M + 600
    buf = np.zeros((1, n + PAD), np.uint8)
    buf[0, :n] = rng.integers(0, 256, size=n)
    w4 = _words(buf)
    htab = np.full((1, 4 * w4.shape[1]), (1 << 30) | (3 << 16) | 1, np.int32)
    htab[0, 0] = 1  # a literal, then the match stops
    n_valid = np.array([n], np.int32)
    meta = np.array([[n, 0, 0, 0, 0, 0, 0, 0]], np.int32)
    call = jax.jit(lambda m, w, h: pl.pallas_call(
        jdk._make_kernel_hop(24), grid=(1,),
        out_shape=[
            jax.ShapeDtypeStruct((1, 1, tdk.CAP_M + 8), jnp.int32),
            jax.ShapeDtypeStruct((1, 1, tdk.CAP_M + 8), jnp.uint32),
            jax.ShapeDtypeStruct((1, 1, 8), jnp.int32),
            jax.ShapeDtypeStruct((1, 1, 4 * 320), jnp.int32),
        ],
        interpret=True,
    )(m, w, h))
    ref = [np.asarray(x)[:, 0] for x in call(
        jnp.asarray(meta[:, None]), jnp.asarray(w4[:, None]), jnp.asarray(htab[:, None])
    )]
    raw = tdk.hop_chase(torch.from_numpy(w4.view(np.int32)), torch.from_numpy(htab),
                        torch.from_numpy(n_valid), 0, 24)
    mpos, mld, st, freq = [t.numpy() for t in raw]
    assert st[0, 1] == 1 and ref[2][0, 1] == 1
    np.testing.assert_array_equal(st[:, :2], ref[2][:, :2])
    np.testing.assert_array_equal(freq, ref[3])
    np.testing.assert_array_equal(mpos[:, : tdk.CAP_M], ref[0][:, : tdk.CAP_M])


def _jax_tables(ll_lens, d_lens):
    """The code tables (code | nbits << 16) the JAX pack consumed, from
    the lengths it echoed."""
    B = ll_lens.shape[0]
    llc = np.asarray(jax.vmap(jd.canonical_codes_jax)(jnp.asarray(ll_lens)))
    dc = np.asarray(jax.vmap(jd.canonical_codes_jax)(jnp.asarray(d_lens)))
    lltab = np.zeros((B, 288), np.uint32)
    dtab = np.zeros((B, 32), np.uint32)
    lltab[:, :286] = llc.astype(np.uint32) | (ll_lens.astype(np.uint32) << 16)
    dtab[:, :30] = dc.astype(np.uint32) | (d_lens.astype(np.uint32) << 16)
    return lltab, dtab


def _assert_pack_equal(got, ref, n_seeds):
    words, total, ll, dl = [np.asarray(x) for x in ref[:4]]
    tw, tt, tll, tdl = [t.numpy() for t in got[:4]]
    np.testing.assert_array_equal(tt, total)
    np.testing.assert_array_equal(got[-1].numpy(), np.asarray(ref[-1]))
    np.testing.assert_array_equal(tll, ll)
    np.testing.assert_array_equal(tdl, dl)
    for r in range(len(total)):
        nw = int(total[r]) // 32 + 2  # through the last bit, plus the slack word
        np.testing.assert_array_equal(tw[r, :nw].view(np.uint32), words[r, :nw])
        assert words[r, nw - 1] == 0 or int(total[r]) % 32 == 0
    if n_seeds:
        np.testing.assert_array_equal(got[4].numpy(), np.asarray(ref[4]))
        np.testing.assert_array_equal(got[5].numpy(), np.asarray(ref[5]))


@pytest.mark.parametrize("n_seeds", [0, 128])
def test_pack_of_the_jax_match_stream_equals_pallas(batch, n_seeds):
    mpos, mld, nmatch, kbad, freq = batch["chase"]
    nm_eff = np.where(kbad, 0, nmatch).astype(np.int32)
    start = np.full(3, DICT, np.int32)
    ref = jdk.freq_pack_chunks_pallas(
        jnp.asarray(batch["buf"]), jnp.asarray(batch["n_valid"]), jnp.asarray(start),
        jnp.asarray(mpos), jnp.asarray(mld), jnp.asarray(nm_eff), jnp.asarray(freq),
        n_seeds=n_seeds, interpret=True,
    )
    lltab, dtab = _jax_tables(np.asarray(ref[2]), np.asarray(ref[3]))
    st = interop.state_from_numpy({
        "chunks": batch["buf"], "n_valid": batch["n_valid"], "mpos": mpos,
        "mld": mld, "nmatch": nm_eff, "lltab": lltab, "dtab": dtab,
    }, device="cpu")
    got = tdk.pack_chunks(
        st["chunks"], st["n_valid"], DICT, st["mpos"], st["mld"], st["nmatch"],
        st["lltab"], st["dtab"], n_seeds=n_seeds,
    )
    assert len(got) == len(ref)
    _assert_pack_equal(got, ref, n_seeds)


def test_freq_pack_with_trees_equals_pallas(batch, xla_exp2):
    mpos, mld, nmatch, kbad, freq = batch["chase"]
    nm_eff = np.where(kbad, 0, nmatch).astype(np.int32)
    ref = jdk.freq_pack_chunks_pallas(
        jnp.asarray(batch["buf"]), jnp.asarray(batch["n_valid"]),
        jnp.full((3,), DICT, jnp.int32), jnp.asarray(mpos), jnp.asarray(mld),
        jnp.asarray(nm_eff), jnp.asarray(freq), n_seeds=0, interpret=True,
    )
    st = interop.state_from_numpy(
        {"mpos": mpos, "mld": mld, "nmatch": nm_eff, "freq": freq,
         "n_valid": batch["n_valid"]}, device="cpu",
    )
    got = tdk.freq_pack_chunks(
        torch.from_numpy(batch["buf"]), st["n_valid"], DICT, st["mpos"],
        st["mld"], st["nmatch"], st["freq"],
    )
    _assert_pack_equal(got, ref, 0)


def test_length_and_distance_symbols_equal_jax():
    ml = np.arange(3, 259, dtype=np.int32)
    dd = np.arange(1, 32769, dtype=np.int32)
    for got, ref in zip(tdk._len_sym(torch.from_numpy(ml)), jdk._len_sym(jnp.asarray(ml))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    for got, ref in zip(tdk._dist_sym(torch.from_numpy(dd)), jdk._dist_sym(jnp.asarray(dd))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_interop_round_trip():
    rng = np.random.default_rng(0)
    arrays = {
        "words4": rng.integers(0, 2**32, size=(2, 9), dtype=np.uint32),
        "mld": rng.integers(0, 2**32, size=(2, 5), dtype=np.uint32),
        "mpos": rng.integers(0, 2**16, size=(2, 5)).astype(np.int32),
        "kbad": np.array([True, False]),
        "nmatch": np.array([3, 4], np.int64),
        "chunks": rng.integers(0, 256, size=(2, 12), dtype=np.uint8),
    }
    st = interop.state_from_numpy(arrays, device="cpu")
    assert st["words4"].dtype == torch.int32 and st["kbad"].dtype == torch.bool
    assert st["chunks"].dtype == torch.uint8
    back = interop.state_to_numpy(st)
    for k, a in arrays.items():
        np.testing.assert_array_equal(back[k], a)
    assert back["words4"].dtype == np.uint32 and back["mld"].dtype == np.uint32
    with pytest.raises(ValueError):
        interop.state_from_numpy({"x": np.array([2**40])}, device="cpu")


def test_interop_without_device_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        interop.state_from_numpy({"nmatch": np.array([1], np.int32)})


def test_kernel_wrappers_refuse_cpu_tensors():
    z = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="CUDA"):
        tdk.hop_chase_cuda(z, z, torch.zeros(1, dtype=torch.int32), 0, 24)
    with pytest.raises(RuntimeError, match="CUDA"):
        tdk.pack_cuda(z, z, z, z, z, z, 8, 0)
