"""K11a and K11b, the single-plane vector decode engine
(ZRS_VECTOR_TWOPLANE=0): the port (`zlib_rs_tpu_torch`, plain versions on
the CPU) against the JAX package (`zlib_rs_tpu`, Pallas kernels in
interpret mode) on the same inputs.

Inputs are the two indexed streams of tests/test_torch_vhuff.py: the JAX
package's own (the XLA engine at 128 KiB chunks) and the port's (the kernel
engine at 32 KiB chunks). Every comparison is exact: per walker the whole
tape, `cons`, `bad` and `rem`; the expanded bytes in [0, out_len) of each
chunk."""

import numpy as np
import pytest
import torch

import zlib_rs_tpu.ops.pallas.vhuff_kernel as JK
import zlib_rs_tpu.parallel.pipeline as jp
import zlib_rs_tpu.parallel.vector_inflate as JV
import zlib_rs_tpu_torch as zt
from zlib_rs_tpu_torch import interop
from zlib_rs_tpu_torch.ops.kernels import vhuff_kernel as VK
from zlib_rs_tpu_torch.parallel import vector_inflate as TV

# the test workers share the cores, and an oversubscribed OpenMP pool spin-waits
torch.set_num_threads(1)

_BASH = open("/bin/bash", "rb").read()

# two chunks of /bin/bash, then one of dist-1 and dist-2 runs whose
# walkers' matches reach into the bytes of the walkers before them
KERNEL_DATA = _BASH[200_000 : 200_000 + 65_536] + b"a" * 20_000 + b"bc" * 6_384


def _chunks(out, index):
    bodies = [out[off : off + ln] for off, ln, _ in index]
    return bodies, [n for _, _, n in index], index.seeds


@pytest.fixture(scope="module")
def xla_stream():
    mp = pytest.MonkeyPatch()
    mp.delenv("ZRS_TPU_KERNEL", raising=False)
    data = _BASH[:140_000]
    out, index = jp.compress_parallel(data, 6, chunk_size=128 * 1024, return_index=True)
    mp.undo()
    return (data, *_chunks(out, index))


@pytest.fixture(scope="module")
def kernel_stream():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ZRS_TPU_KERNEL", "1")  # the port's kernel engine
        out, index = zt.compress_parallel(KERNEL_DATA, 6, return_index=True, device="cpu")
    return (KERNEL_DATA, *_chunks(out, index))


@pytest.fixture(params=["xla_stream", "kernel_stream"])
def stream(request):
    return request.getfixturevalue(request.param)


# ---------------------------------------------------------------------------
# K11a: the single-plane decode
# ---------------------------------------------------------------------------

_JAX_K11A = {}


def _jax_k11a(bodies, sizes, seeds, cap=None):
    """The JAX decode of these chunks, walker-major, cached per input."""
    key = (tuple(bodies), tuple(sizes), str(seeds), cap)
    if key not in _JAX_K11A:
        dev, meta = JV.prepare_vector_inputs(bodies, sizes, seeds)
        c = cap or meta["cap"]
        tape, cons, bad, rem = JK.decode_tokens_vector(
            dev["fifo"], *dev["tables"], dev["align"], dev["span"],
            cap=c, K=meta["K"], interpret=True,
        )
        W = meta["B"] * meta["S"]
        flat = lambda x: np.asarray(x).reshape(-1)[:W]
        _JAX_K11A[key] = dict(
            tape=np.asarray(tape).transpose(0, 2, 3, 1).reshape(-1, c)[:W],
            cons=flat(cons), bad=flat(bad), rem=flat(rem),
            offs=np.asarray(dev["offs"]), meta=meta, cap=c,
        )
    return _JAX_K11A[key]


def _port_k11a(bodies, sizes, seeds, cap=None):
    dev, meta = TV.prepare_vector_inputs(bodies, sizes, seeds, device="cpu")
    out = VK.decode_tokens_vector(
        dev["words"], dev["start_word"], dev["align"], dev["span"], dev["tables"],
        S=meta["S"], K=meta["K"], cap=cap or meta["cap"],
    )
    state = interop.state_to_numpy(dict(zip(("tape", "cons", "bad", "rem"), out)))
    state["tape"] = state["tape"].T
    return state, meta


def _assert_k11a_equal(bodies, sizes, seeds, cap=None):
    want = _jax_k11a(bodies, sizes, seeds, cap)
    got, meta = _port_k11a(bodies, sizes, seeds, cap)
    assert (meta["K"], meta["cap"]) == (want["meta"]["K"], want["meta"]["cap"])
    assert got["tape"].shape == want["tape"].shape and got["tape"].dtype == np.uint32
    for name in ("tape", "cons", "bad", "rem"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    return got


def test_k11a_equals_jax(stream):
    _data, bodies, sizes, seeds = stream
    got = _assert_k11a_equal(bodies, sizes, seeds)
    assert not got["bad"].any() and not got["rem"].any()
    # rows after each walker's terminator stay zero; both token kinds occur
    live = got["tape"] != 0
    assert (np.cumsum(~live, axis=1)[live] == 0).all()
    kinds = set((got["tape"][live] >> 30).tolist())
    assert kinds == {VK.VTOK_LIT, VK.VTOK_MATCH}


def test_k11a_bit_flipped_body_equals_jax(stream):
    _data, bodies, sizes, seeds = stream
    bad = bytearray(bodies[0])
    bad[len(bad) // 2] ^= 0xFF
    got = _assert_k11a_equal([bytes(bad)] + bodies[1:], sizes, seeds)
    clean, _meta = _port_k11a(bodies, sizes, seeds)
    assert (got["cons"] != clean["cons"]).any() or got["bad"].any() or got["rem"].any()


def test_k11a_shifted_seed_equals_jax(stream):
    _data, bodies, sizes, seeds = stream
    bits, outs = seeds[0]
    bits = list(bits)
    bits[1] += 1  # one walker a bit off its symbol boundary
    _assert_k11a_equal(bodies, sizes, [(bits, outs)] + list(seeds[1:]))


def test_k11a_undersized_cap_equals_jax(kernel_stream):
    _data, bodies, sizes, seeds = kernel_stream
    got = _assert_k11a_equal(bodies, sizes, seeds, cap=16)
    assert got["rem"].any()  # walkers stop at the cap with span left


def test_k11_wrappers_take_the_plain_versions_only_on_the_cpu(kernel_stream):
    _data, bodies, sizes, seeds = kernel_stream
    dev, meta = TV.prepare_vector_inputs(bodies, sizes, seeds, device="cpu")
    args = (dev["words"], dev["start_word"], dev["align"], dev["span"], dev["tables"])
    before = dict(VK.launches)
    with pytest.raises(RuntimeError, match="CUDA"):
        VK.decode_tokens_vector_cuda(*args, S=meta["S"], K=meta["K"], cap=256)
    with pytest.raises(RuntimeError, match="CUDA"):
        VK.expand_tokens_cuda(torch.zeros((4, 3 * 128), dtype=torch.int32), dev["offs"],
                              out_words=8)
    with pytest.raises(ValueError, match="S % 128"):
        VK.decode_tokens_vector(*args, S=64, K=meta["K"], cap=256)
    with pytest.raises(ValueError, match="\\[B, S \\+ 1\\]"):
        VK.expand_tokens(torch.zeros((4, 100), dtype=torch.int32), dev["offs"], out_words=8)
    assert VK.launches == before


# ---------------------------------------------------------------------------
# K11b: the single-plane expansion
# ---------------------------------------------------------------------------


def _assert_k11b_equal(bodies, sizes, seeds, data):
    """Both expansions fed the JAX package's own tape."""
    want = _jax_k11a(bodies, sizes, seeds)
    meta, cap = want["meta"], want["cap"]
    B, S = meta["B"], meta["S"]
    out_words = -(-max(sizes) // 4) + 2
    jax_out = np.asarray(JK.expand_tokens_pallas(
        want["tape"].reshape(B, S, cap), want["offs"], S=S, cap=cap,
        out_words=out_words, interpret=True,
    ))
    offs = want["offs"][:, : S + 1]
    st = interop.state_from_numpy({"tape": want["tape"].T, "offs": offs}, device="cpu")
    got = VK.expand_tokens(st["tape"], st["offs"], out_words=out_words)
    got_np = interop.state_to_numpy({"outw": got})["outw"]
    assert got_np.shape == jax_out.shape == (B, out_words)
    pos = 0
    for k in range(B):
        g = got_np[k].view(np.uint8)[: sizes[k]]
        np.testing.assert_array_equal(g, jax_out[k].view(np.uint8)[: sizes[k]])
        assert g.tobytes() == data[pos : pos + sizes[k]]
        pos += sizes[k]
    return want


def test_k11b_equals_jax(stream):
    data, bodies, sizes, seeds = stream
    _assert_k11b_equal(bodies, sizes, seeds, data)


def test_k11b_short_distance_runs_equal_jax(kernel_stream):
    data, bodies, sizes, seeds = kernel_stream
    tape = _assert_k11b_equal(bodies, sizes, seeds, data)["tape"]
    match = (tape >> 30) == VK.VTOK_MATCH
    dists = set((tape[match] & 0xFFFF).tolist())
    assert {1, 2} <= dists  # the byte-head path of dist < 4 matches ran


def _lit(bs):
    return (VK.VTOK_LIT << 30) | ((len(bs) - 1) << 24) | int.from_bytes(bs, "little")


def _match(length, dist):
    return (VK.VTOK_MATCH << 30) | ((length - 3) << 16) | dist


def test_k11b_plain_bounds_every_access():
    """Every read clamps into the output row and every store outside it is
    dropped. A crafted tape, worked by hand: walker 0 starts 8 bytes before
    the row (its first 8 literal bytes are dropped, the 9th lands on byte
    0), then copies 5 bytes from distance 3 at byte 1, whose sources before
    the row read word 0 (a read that wrapped to the row's end would read
    0); walker 1 stores 4 literals in the last word, and the rest of its
    literals and its match run off the row. Then
    a random tape with a damaged index runs without a fault."""
    tape = np.zeros((4, 2), np.uint32)
    tape[:, 0] = [_lit(b"\x11\x22\x33"), _lit(b"\x44\x55\x66"), _lit(b"\x77\x88\x99"),
                  _match(5, 3)]
    tape[:3, 1] = [_lit(b"\xaa\xbb\xcc"), _lit(b"\xdd\xee\xff"), _match(6, 30)]
    st = interop.state_from_numpy(
        {"tape": tape, "offs": np.array([[-8, 28, 40]], np.int32)}, device="cpu")
    out = VK.expand_tokens(st["tape"], st["offs"], out_words=8).numpy().view(np.uint32)
    assert out[0].tolist() == [0x99999999, 0x99999999, 0, 0, 0, 0, 0, 0xDDCCBBAA]

    rng = np.random.default_rng(3)
    cap, S = 16, 8
    tape = rng.integers(0, 2**32, (cap, 2 * S), dtype=np.uint64).astype(np.uint32)
    tape[:, ::3] = (tape[:, ::3] & 0x3FFFFFFF) | (VK.VTOK_LIT << 30)  # literal sprints
    offs = np.sort(rng.integers(-50, 400, (2, S + 1)), axis=1).astype(np.int32)
    offs[1, 3] = 2**31 - 8  # past any row
    st = interop.state_from_numpy({"tape": tape, "offs": offs}, device="cpu")
    out = VK.expand_tokens(st["tape"], st["offs"], out_words=20)
    assert out.shape == (2, 20) and out.dtype == torch.int32
