"""K11a and K11b, the single-plane vector decode engine
(ZRS_VECTOR_TWOPLANE=0): the port (`zlib_rs_tpu_torch`, plain versions on
the CPU) against the JAX package (`zlib_rs_tpu`, Pallas kernels in
interpret mode) on the same inputs.

Inputs are the two indexed streams of tests/test_torch_vhuff.py: the JAX
package's own (the XLA engine at 128 KiB chunks) and the port's (the kernel
engine at 32 KiB chunks). Every comparison is exact: per walker the whole
tape, `cons`, `bad` and `rem`; the expanded bytes in [0, out_len) of each
chunk."""

import jax.numpy as jnp
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

import decode_model
import expand_model

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


# ---------------------------------------------------------------------------
# K11b's design: K5's body (csrc/vhuff_expand.cu) through the single-plane
# reader, as the numpy model of tests/expand_model.py
# ---------------------------------------------------------------------------


def _k11b_model(tape, offs, out_words, *, max_bytes=VK.CHASE_MAX_BYTES):
    return expand_model.model(expand_model.SinglePlane(tape), offs, out_words,
                              max_bytes=max_bytes)


def _plain_k11b(tape, offs, out_words):
    st = interop.state_from_numpy({"tape": tape, "offs": offs}, device="cpu")
    return VK.expand_tokens_plain(st["tape"], st["offs"], out_words=out_words).numpy().view(
        np.uint32)


def _jax_k11b(tape, offs, out_words):
    """JAX's expand_tokens_pallas in interpret mode on a row-major tape
    [cap, W] and offs [B, S + 1]."""
    cap, W = tape.shape
    B, S = offs.shape[0], offs.shape[1] - 1
    joffs = np.concatenate([offs[:, :S], np.repeat(offs[:, S:], 8, axis=1)], axis=1)
    return np.asarray(JK.expand_tokens_pallas(
        jnp.asarray(np.ascontiguousarray(tape.T).reshape(B, S, cap)), jnp.asarray(joffs), S=S,
        cap=cap, out_words=out_words, interpret=True))


@pytest.mark.parametrize("max_bytes", [VK.CHASE_MAX_BYTES, None], ids=["kernel", "no_limit"])
def test_k11b_design_model_equals_plain_and_jax(stream, max_bytes):
    """On the JAX package's single-plane tapes of both streams: the 32 KiB
    chunks take the chase, the 128 KiB ones the serial body at the
    kernel's limit and the chase without it. The decode ends every
    walker of a clean tape with an end token right at its offset, so the
    serial body's sprint never runs past a walker's end here: the crafted
    chunks below put a LIT and a match there."""
    data, bodies, sizes, seeds = stream
    want = _jax_k11a(bodies, sizes, seeds)
    S = want["meta"]["S"]
    out_words = -(-max(sizes) // 4) + 2
    tape = want["tape"].T.copy()
    offs = np.ascontiguousarray(want["offs"][:, : S + 1])
    got, branch, edges = _k11b_model(tape, offs, out_words, max_bytes=max_bytes)
    expand_model.assert_bytes_equal(got, _plain_k11b(tape, offs, out_words), sizes)
    expand_model.assert_bytes_equal(got, _jax_k11b(tape, offs, out_words), sizes)
    assert b"".join(got[k].view(np.uint8)[:n].tobytes() for k, n in enumerate(sizes)) == data
    too_large = max(sizes) > VK.CHASE_MAX_BYTES and max_bytes is not None
    assert (branch == (VK.BRANCH_TOO_LARGE if too_large else VK.BRANCH_CHASE)).all()
    if not too_large:
        assert edges["period"] > 0 and edges["earlier_walker"] > 0
        assert edges["carried"] > 0 and edges["compressed"] > 0 and max(edges["rounds"]) >= 3
        assert edges["past_end_end"] == sum(n > 0 for n in np.diff(offs).ravel())
        assert edges["past_end_lit"] == edges["past_end_match"] == 0


def _end(dist, kind=0):
    """A token that ends the walker (kind 0 or 3), with dist bits for its
    cover-0 copy."""
    return (kind << 30) | dist


def _tok_bytes(tok):
    if tok >> 30 == VK.VTOK_LIT:
        return ((tok >> 24) & 3) + 1
    return ((tok >> 16) & 0x3FFF) + 3 if tok >> 30 == VK.VTOK_MATCH else 0


def _tape1(chunks, cap=None):
    """A row-major single-plane tape [cap, B * S] and offs [B, S + 1] from
    chunks of walkers, each (tokens, past): the walker's range holds the
    bytes of `tokens`, and the tape goes on with `past` (what the serial
    body meets at or past the walker's end); offsets run on from 0."""
    B, S = len(chunks), len(chunks[0])
    cap = cap or max(len(t) + len(p) for c in chunks for t, p in c) + 1
    tape = np.zeros((cap, B * S), np.uint32)
    offs = np.zeros((B, S + 1), np.int32)
    for k, walkers in enumerate(chunks):
        for s, (toks, past) in enumerate(walkers):
            for t, tok in enumerate(toks + past):
                tape[t, k * S + s] = tok
            offs[k, s + 1] = offs[k, s] + sum(_tok_bytes(t) for t in toks)
    return tape, offs


def _k11b_edge_chunks():
    """A chunk of dist-1 runs chained through all 128 walkers (128 hops
    deep); a chunk whose walkers put each edge of the single-plane serial
    body inside the chase's range: LIT tokens of 1, 2 and 3 bytes across
    word edges, a sprint that runs past the walker's end into a match, a
    walker whose literals end at its end with a match next, end tokens of
    kind 0 and 3 with dists 0-3 (a cover-0 copy with a byte head),
    overlapping matches, a 1000-byte match, sources in earlier walkers
    (padded to 128 walkers with empty ones); then that chunk again, to
    start 5 bytes into its row."""
    S = 128
    deep = [([_lit(b"x"), _match(200, 1)], [])] + [([_match(200, 1)], [])] * (S - 1)
    near = [
        ([_lit(b"a"), _lit(b"bc"), _lit(b"def"), _lit(b"g"), _lit(b"hi")],
         [_lit(b"zz"), _lit(b"yyy"), _match(5, 2)]),
        ([_match(20, 9), _lit(b"jk")], [_match(10, 3)]),
        ([_lit(b"lmn"), _match(40, 3)], [_end(0)]),
        ([_lit(b"o"), _match(7, 1)], [_end(1)]),
        ([_match(30, 60)], [_end(2)]),
        ([_lit(b"pq"), _match(1000, 2)], [_end(3)]),
        ([_lit(b"rst")], [_end(3, kind=3)]),
        ([_match(50, 100), _lit(b"uv")], [_lit(b"w"), _end(2)]),
        ([_lit(b"\x00"), _lit(b"\x00\x00\x00")], [_lit(b"\x01")]),
    ]
    near += [([], [])] * (S - len(near))
    return [deep, near, near]


def test_k11b_design_model_on_edge_chunks_equals_plain_and_jax():
    tape, offs = _tape1(_k11b_edge_chunks())
    offs[2] += 5  # bytes [0, 5) stay zero: open bytes before any token
    sizes = offs[:, -1].tolist()
    out_words = -(-max(sizes) // 4) + 2
    got, branch, edges = _k11b_model(tape, offs, out_words)
    assert (branch == VK.BRANCH_CHASE).all()
    expand_model.assert_bytes_equal(got, _plain_k11b(tape, offs, out_words), sizes)
    expand_model.assert_bytes_equal(got, _jax_k11b(tape, offs, out_words), sizes)
    assert got[0].view(np.uint8)[: sizes[0]].tobytes() == b"x" * sizes[0]
    # the deep chunk: a hop a walker, 128 hops, so 8 rounds that move and the last
    assert edges["depth"][0] == 128 and edges["rounds"][0] == 9
    # per near chunk: walkers 0, 7 and 8 sprint on past their ends, walker
    # 1 meets a match, walkers 2-6 an end token (as do the deep chunk's 128)
    assert edges["past_end_lit"] == 6 and edges["past_end_match"] == 2
    assert edges["past_end_end"] == 128 + 10
    assert edges["period"] > 0 and edges["earlier_walker"] >= 4 and edges["carried"] > 0
    assert edges["orphan"] == 5 and not got[2].view(np.uint8)[:5].any()
    # the serial body does write past walker 0's end: run alone, its sprint
    # leaves "zzyyy" and a match after "abcdefghi"
    alone = _plain_k11b(tape[:, 128:129].copy(), np.array([[0, 9]], np.int32), 8)
    assert alone[0].view(np.uint8)[:19].tobytes() == b"abcdefghizzyyyyyyyy"


def _k11b_corrupt_chunks():
    """Chunks the resolve must send to the serial body, one fault each: a
    walker ending one byte past its range, dist 0, a source before the
    row, a LIT with bits above its count, a walker cut off by an end token,
    an index past the row, and a LIT that crosses its walker's end."""
    good = [([_lit(b"abc"), _lit(b"d"), _match(10, 4)], []), ([_lit(b"fg"), _match(20, 7)], []),
            ([_lit(b"hi"), _lit(b"jk")], []), ([_match(9, 20)], [])]
    chunks = [[(list(t), list(p)) for t, p in good] for _ in range(7)]
    chunks[1][1] = ([_lit(b"fg"), _match(20, 0)], [])
    chunks[2][1] = ([_lit(b"fg"), _match(20, 600)], [])
    chunks[3][2] = ([_lit(b"h") | (0x69 << 8), _lit(b"i"), _lit(b"jk")], [])
    chunks[4][2] = ([_lit(b"hi"), _end(0), _lit(b"jk")], [])
    tape, offs = _tape1(chunks)
    offs[0, 2] -= 1  # walker 1's match runs one byte past its range
    offs[4, 3:] += 2  # walker 2 ends at its end token, 2 bytes short
    out_words = -(-int(offs[:, -1].max()) // 4) + 2
    offs[5, -1] = 4 * out_words + 40  # the last walker runs past the row
    offs[6, 3] -= 1  # walker 2's "jk" starts inside its range and crosses its end
    return tape, offs, out_words


def test_k11b_design_model_sends_corrupt_chunks_to_the_serial_body():
    tape, offs, out_words = _k11b_corrupt_chunks()
    got, branch, _edges = _k11b_model(tape, offs, out_words)
    assert (branch == VK.BRANCH_UNTILED).all()
    np.testing.assert_array_equal(got, _plain_k11b(tape, offs, out_words))
    # the same tapes with the faults mended take the chase
    good = _tape1([[([_lit(b"abc"), _lit(b"d"), _match(10, 4)], []),
                    ([_lit(b"fg"), _match(20, 7)], []), ([_lit(b"hi"), _lit(b"jk")], []),
                    ([_match(9, 20)], [])]])
    _got, ok_branch, _ = _k11b_model(*good, out_words)
    assert (ok_branch == VK.BRANCH_CHASE).all()


def test_k11b_design_model_on_random_tapes_takes_the_serial_body():
    """test_k11b_plain_bounds_every_access's random tape: every chunk
    serial, every word of the row equal to the plain version's."""
    rng = np.random.default_rng(3)
    cap, S = 16, 8
    tape = rng.integers(0, 2**32, (cap, 2 * S), dtype=np.uint64).astype(np.uint32)
    tape[:, ::3] = (tape[:, ::3] & 0x3FFFFFFF) | (VK.VTOK_LIT << 30)
    offs = np.sort(rng.integers(-50, 400, (2, S + 1)), axis=1).astype(np.int32)
    offs[1, 3] = 2**31 - 8
    got, branch, _edges = _k11b_model(tape, offs, 20)
    assert (branch == VK.BRANCH_UNTILED).all()
    np.testing.assert_array_equal(got, _plain_k11b(tape, offs, 20))


# ---------------------------------------------------------------------------
# K11a's design (K4's body in csrc/vhuff_decode.cu with the single-plane
# row policy) as a numpy model (tests/decode_model.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", decode_model.CASES)
def test_k11a_design_model_equals_plain_and_jax(stream, case):
    """The model's staged window, direct tables and branch-free single-plane
    walk give the plain version's and the JAX kernel's tape, cons, bad and
    rem exactly; the damaged index's block reads in place; both token kinds
    come from the direct path."""
    bodies, sizes, seeds, ops, meta = decode_model.decode_case(stream, case)
    S, K = meta["S"], meta["K"]
    cap = 16 if case == "cap16" else meta["cap"]
    got = decode_model.model(decode_model.OnePlane, *ops.values(), S=S, K=K, cap=cap)
    plain = VK.decode_tokens_vector_plain(*(torch.from_numpy(a) for a in ops.values()),
                                         S=S, K=K, cap=cap)
    decode_model.assert_equal_runs(got, plain, decode_model.jax_decode_on(
        JK.decode_tokens_vector, bodies, sizes, seeds, ops, meta, cap))
    (tape,), _cons, bad, rem, staged, counts = got
    np.testing.assert_array_equal(staged, np.arange(len(staged)) != 1 if case == "damaged"
                                  else np.ones(len(staged), bool))
    assert counts.direct > 0.9 * counts.total
    if case == "clean":
        assert not bad.any() and not rem.any()
        assert set((tape[tape != 0] >> 30).tolist()) == {VK.VTOK_LIT, VK.VTOK_MATCH}
    elif case == "cap16":
        assert rem.any()


def test_k11a_design_model_on_a_small_stage_budget_equals_plain():
    """Every block of the port's stream forced to read in place (a budget
    of one word): the same outputs as staged."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ZRS_TPU_KERNEL", "1")
        out, index = zt.compress_parallel(KERNEL_DATA, 6, return_index=True, device="cpu")
    stream = (KERNEL_DATA, *_chunks(out, index))
    _b, _s, _seeds, ops, meta = decode_model.decode_case(stream, "clean")
    S, K, cap = meta["S"], meta["K"], meta["cap"]
    staged = decode_model.model(decode_model.OnePlane, *ops.values(), S=S, K=K, cap=cap)
    in_place = decode_model.model(decode_model.OnePlane, *ops.values(), S=S, K=K, cap=cap,
                                  stage_words=1)
    assert staged[4].all() and not in_place[4].any()
    for a, b in zip(staged[0] + list(staged[1:4]), in_place[0] + list(in_place[1:4])):
        np.testing.assert_array_equal(a, b)
