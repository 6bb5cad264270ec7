"""K12, the interleaved hop chase (ZRS_TPU_HOP_IL=2): the port's plain
version against the JAX package's `_make_kernel_hop_il` in interpret mode.

The JAX package reads ZRS_TPU_HOP_IL inside the jitted
`scan_chunks_hop_pallas`, and no static argument carries it, so the first
trace at a shape decides between K2 and K12 for every later call. Each JAX
run of K12 here clears the jit caches before and after it and counts the
traces of `_make_kernel_hop_il`, so that it provably ran and later tests
get K2 back. K12 needs an even batch there; the port runs it on any batch.

The contract is K2's: the match stream, `nmatch`, `bad` and the histogram
bins anything downstream reads (0-285, 288-317) are equal. Bin 319 is a
dead slot, which the JAX K12 also bumps for a lane that waits on its
partner. On a lane that overflows CAP_M, K12 counts the span once, where
K2 clears bank 0 only before its all-literal recount."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from zlib_rs_tpu.ops import lzvec as jl
from zlib_rs_tpu.ops.pallas import deflate_kernel as jdk
from zlib_rs_tpu_torch import interop
from zlib_rs_tpu_torch.ops.kernels import deflate_kernel as tdk

# the test workers share the cores, and an oversubscribed OpenMP pool spin-waits
torch.set_num_threads(1)

_BASH = open("/bin/bash", "rb").read()
PAD = 272
DICT, CHUNK = 4096, 8192
L6 = dict(depth=64, nice=128, good=8, max_lazy=16, w_g=6)
CAP_G = 4 * L6["w_g"]
SEL = np.r_[0:286, 288:318]  # the histogram bins anything downstream reads
# K2's summed literal bins minus K12's on the overflow lane below: banks 1-3
# of K2 keep their counts from before the overflow
K2_EXTRA_LITERALS = 35_922


def _words(buf):
    B = buf.shape[0]
    bb = buf.reshape(B, -1, 4).astype(np.uint32)
    w4 = bb[..., 0] | (bb[..., 1] << 8) | (bb[..., 2] << 16) | (bb[..., 3] << 24)
    return np.concatenate([w4, np.zeros((B, 2), np.uint32)], axis=1)


def _cut(data_len, ins_from, seed):
    """Dictionary-primed chunks cut from /bin/bash, as tests/
    test_torch_deflate_kernel.py's batch; a data_len of -DICT is an empty
    padding row (n_valid 0), as the JAX pipeline pads its tail batch."""
    rng = np.random.default_rng(seed)
    width = DICT + CHUNK + PAD
    buf = np.zeros((len(data_len), width), np.uint8)
    for r, dl in enumerate(data_len):
        off = int(rng.integers(0, len(_BASH) - width))
        n = DICT + dl
        if n > 0:
            buf[r, ins_from[r] : n] = np.frombuffer(_BASH[off + ins_from[r] : off + n], np.uint8)
    n_valid = (np.asarray(data_len) + DICT).astype(np.int32)
    return dict(buf=buf, w4=_words(buf), n_valid=n_valid, ins_from=np.asarray(ins_from, np.int32))


def _jax_scan(b):
    return [np.asarray(x) for x in jdk.scan_chunks_hop_pallas(
        jnp.asarray(b["w4"]), jnp.asarray(b["n_valid"]), jnp.asarray(b["ins_from"]),
        start=DICT, interpret=True, bytes_arr=jnp.asarray(b["buf"]), **L6,
    )]


def _jax_htab(b):
    return np.asarray(jl.build_hop_tables(
        jnp.asarray(b["w4"]), jnp.asarray(b["n_valid"]), jnp.asarray(b["ins_from"]),
        bytes_arr=jnp.asarray(b["buf"]), **L6,
    ))


@pytest.fixture(scope="module")
def batches():
    """An even batch of four chunks (the short one paired with a full one)
    and three of them padded with an empty fourth, with the JAX K12 of
    both and the number of K12 traces."""
    even = _cut([CHUNK, CHUNK, 3001, CHUNK], [DICT, 0, 0, 0], 2024)
    padded = {k: v.copy() for k, v in even.items()}
    padded["buf"][3] = 0
    padded["w4"][3] = 0
    padded["n_valid"][3] = 0
    padded["ins_from"][3] = DICT
    traced = []
    real = jdk._make_kernel_hop_il

    def spy(cap_g, K):
        traced.append((cap_g, K))
        return real(cap_g, K)

    mp = pytest.MonkeyPatch()
    mp.setattr(jdk, "_make_kernel_hop_il", spy)
    mp.setenv("ZRS_TPU_HOP_IL", "2")
    jax.clear_caches()
    try:
        even["k12"] = _jax_scan(even)
        padded["k12"] = _jax_scan(padded)
    finally:
        jax.clear_caches()
        mp.undo()
    even["htab"] = _jax_htab(even)
    return dict(even=even, padded=padded, traced=traced)


def _assert_chase_equal(got, ref, rows=None):
    mpos, mld, nmatch, kbad, freq = ref
    rows = range(len(nmatch)) if rows is None else rows
    tm, tl, tn, tk, tf = [t.numpy() for t in got]
    for r in rows:
        assert tn[r] == nmatch[r] and tk[r] == kbad[r]
        k = int(nmatch[r])
        np.testing.assert_array_equal(tm[r, :k], mpos[r, :k])
        np.testing.assert_array_equal(tl[r, :k].view(np.uint32), mld[r, :k])
        np.testing.assert_array_equal(tf[r, SEL], freq[r, SEL])


def _state(b, rows=slice(None)):
    return interop.state_from_numpy(
        {"words4": b["w4"][rows], "htab": b["htab"][rows], "n_valid": b["n_valid"][rows]},
        device="cpu",
    )


def test_k12_of_the_jax_htab_equals_pallas(batches):
    b = batches["even"]
    assert batches["traced"] and set(batches["traced"]) == {(CAP_G, 2)}
    st = _state(b)
    raw = tdk.hop_chase_il(st["words4"], st["htab"], st["n_valid"], DICT, CAP_G)
    assert [t.dtype for t in raw] == [torch.int32] * 4
    assert raw[0].shape == (4, tdk.CAP_M + 8) and raw[3].shape == (4, 4 * 320)
    _assert_chase_equal(tdk._hop_post(*raw), b["k12"])
    assert b["k12"][2].min() > 100  # real parses, not all-literal
    # on clean lanes K12 is K2: all four arrays, every bin
    for g, w in zip(raw, tdk.hop_chase(st["words4"], st["htab"], st["n_valid"], DICT, CAP_G)):
        assert torch.equal(g, w)


def test_scan_chunks_hop_runs_k12_under_hop_il(monkeypatch, batches):
    b = batches["even"]
    calls = []
    for name in ("hop_chase", "hop_chase_il"):
        real = getattr(tdk, name)
        monkeypatch.setattr(tdk, name, lambda *a, _n=name, _r=real: calls.append(_n) or _r(*a))
    args = (torch.from_numpy(b["w4"].view(np.int32)), torch.from_numpy(b["n_valid"]),
            torch.from_numpy(b["ins_from"]))
    kw = dict(start=DICT, bytes_arr=torch.from_numpy(b["buf"]), **L6)
    monkeypatch.setenv("ZRS_TPU_HOP_IL", "2")
    got = tdk.scan_chunks_hop(*args, **kw)
    assert calls == ["hop_chase_il"]
    _assert_chase_equal(got, b["k12"])
    monkeypatch.delenv("ZRS_TPU_HOP_IL")  # read on every call
    k2 = tdk.scan_chunks_hop(*args, **kw)
    assert calls == ["hop_chase_il", "hop_chase"]
    for g, w in zip(got, k2):
        assert torch.equal(g, w)


def test_odd_batch_equals_pallas_with_an_empty_fourth(batches):
    # the port runs K12 on three chunks; its last pair has one inert lane
    b = batches["even"]
    ref = batches["padded"]["k12"]
    st = _state(b, slice(0, 3))
    raw = tdk.hop_chase_il(st["words4"], st["htab"], st["n_valid"], DICT, CAP_G)
    assert raw[0].shape[0] == 3
    _assert_chase_equal(tdk._hop_post(*raw), ref, rows=range(3))
    assert ref[2][3] == 0 and not ref[3][3]  # the JAX padding lane emits nothing


def _pallas(kernel, w4, htab, n_valid):
    B = len(n_valid)
    meta = np.zeros((B, 8), np.int32)
    meta[:, 0] = n_valid
    shape = lambda n, dt: jax.ShapeDtypeStruct((1, B, n), dt)
    call = jax.jit(lambda m, w, h: pl.pallas_call(
        kernel, grid=(1,), interpret=True,
        out_shape=[shape(tdk.CAP_M + 8, jnp.int32), shape(tdk.CAP_M + 8, jnp.uint32),
                   shape(8, jnp.int32), shape(4 * 320, jnp.int32)],
    )(m, w, h))
    return [np.asarray(x)[0] for x in call(
        jnp.asarray(meta[None]), jnp.asarray(w4[None]), jnp.asarray(htab[None]))]


def test_overflow_lane_equals_pallas_k12_and_differs_from_k2():
    lanes = tdk.overflow_lanes()
    w4, htab, n_valid = lanes[0].numpy().view(np.uint32), lanes[1].numpy(), lanes[2].numpy()
    k12 = _pallas(jdk._make_kernel_hop_il(24, 2), w4, htab, n_valid)
    k2 = _pallas(jdk._make_kernel_hop(24), w4[:1], htab[:1], n_valid[:1])
    args = (*lanes, 0, 24)
    mpos, mld, st, freq = [t.numpy() for t in tdk.hop_chase_il(*args)]
    np.testing.assert_array_equal(st[:, :2], k12[2][:, :2])
    assert st[0].tolist()[:2] == [tdk.CAP_M + 1, 1] and st[1, 1] == 0
    for r in range(2):
        m = min(int(st[r, 0]), tdk.CAP_M)
        np.testing.assert_array_equal(mpos[r, :m], k12[0][r, :m])
        np.testing.assert_array_equal(mld[r, :m].view(np.uint32), k12[1][r, :m])
        # per bank, every bin but the dead 319
        np.testing.assert_array_equal(freq[r].reshape(4, 320)[:, :319],
                                      k12[3][r].reshape(4, 320)[:, :319])
    lits = freq[0].reshape(4, 320)[:, :256]
    assert lits.sum() == n_valid[0]  # the bad lane's span, counted once
    # the JAX K2 on the same lane: the same parse, banks 1-3 counted twice over
    np.testing.assert_array_equal(k2[2][0, :2], st[0, :2])
    np.testing.assert_array_equal(k2[0][0, : tdk.CAP_M], mpos[0, : tdk.CAP_M])
    k2_lits = k2[3][0].reshape(4, 320)[:, :256]
    np.testing.assert_array_equal(k2_lits[0], lits[0])
    assert k2_lits.sum() - lits.sum() == K2_EXTRA_LITERALS
    # the port's K2 keeps that behaviour, every bin
    k2_port = tdk.hop_chase(*[a[:1] if torch.is_tensor(a) else a for a in args])
    np.testing.assert_array_equal(k2_port[3].numpy(), k2[3])


def test_hop_chase_il_cuda_refuses_cpu_tensors():
    z = torch.zeros((1, 8), dtype=torch.int32)
    before = dict(tdk.launches)
    with pytest.raises(RuntimeError, match="CUDA"):
        tdk.hop_chase_il_cuda(z, z, torch.zeros(1, dtype=torch.int32), 0, 24)
    assert tdk.launches == before
