"""The port's sharded steps on the CPU, over gloo groups of 2 and 4 ranks
(spawned processes that import the port alone, tests/torch_mesh_ranks.py):
`make_sharded_encode_step` (the XLA engine and the kernel engine, with and
without the gather) and `make_sharded_decode_step`, held field for field
against the JAX package's shard_map steps on a `Mesh(jax.devices()[:W],
("chunks",))` of the same width on the same inputs. Also the launcher of
ranks: a rank that raises, or hangs, fails the run and leaves no rank
running.

The ranks rendezvous through a file in the test's temporary directory and
run under a time limit of their own (`RANK_TIMEOUT_S`); they start first
and run while this process computes the references."""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import zlib_rs_tpu.parallel.pipeline as jp
import zlib_rs_tpu.parallel.swarm_inflate as jsw
import zlib_rs_tpu_torch as zt
from zlib_rs_tpu_torch.ops import lz77 as tl
from zlib_rs_tpu_torch.parallel import mesh as M
from zlib_rs_tpu_torch.parallel import swarm_inflate as tsw

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_mesh_ranks  # noqa: E402

torch.set_num_threads(1)

RANK_TIMEOUT_S = 180.0  # the ranks start at once and end long before it, even on a busy host
WIDTHS = (2, 4)
_BASH = open("/bin/bash", "rb").read()
DECODE_DATA = _BASH[400_000 : 400_000 + 4 * 16384]  # four 16 KiB chunks


def _encode_step_inputs():
    """tests/test_parallel_pipeline.py:130's XLA step (2 KiB of random
    bytes a row, chain_depth=2, max_words=8) and the kernel step of the
    graft entry's dry run (1 KiB chunks after a 512-byte dictionary,
    kernel_cfg (4, 8, 16, 16)), on 4 rows. Returns {name: (inputs, step
    options)}."""
    rows = 4
    chunk = 2048
    raw = np.zeros((rows, chunk + tl.PAD), np.uint8)
    raw[:, :chunk] = np.random.default_rng(1).integers(0, 64, (rows, chunk), dtype=np.uint8)
    xla = ((raw, np.full(rows, chunk, np.int32), np.zeros(rows, np.int32),
            np.zeros(rows, np.int32)),
           dict(chunk_size=chunk, dynamic=True, chain_depth=2, max_words=8))
    chunk, dict_size = 1024, 512
    width = -(-(dict_size + chunk + tl.PAD) // 4) * 4
    raw = np.zeros((rows, width), np.uint8)
    base = (b"sharded kernel-scan step %d " * 32) % tuple(range(32))
    blob = (base * (chunk // len(base) + 2))[:chunk]
    raw[:, dict_size : dict_size + chunk] = np.frombuffer(blob, np.uint8)
    kernel = ((raw, np.full(rows, dict_size + chunk, np.int32), np.zeros(rows, np.int32),
               np.full(rows, dict_size, np.int32)),
              dict(chunk_size=chunk, dict_size=dict_size, dynamic=True, kernel_scan=True,
                   kernel_cfg=(4, 8, 16, 16)))
    return {"xla": xla, "kernel": kernel}


STEPS = _encode_step_inputs()


def _jax_encode_step(width: int, name: str, gather: bool):
    inputs, kw = STEPS[name]
    mesh = Mesh(np.array(jax.devices()[:width]), ("chunks",))
    step = jp.make_sharded_encode_step(mesh, gather=gather, **kw)
    return [np.asarray(t) for t in step(*inputs)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the ranks of both widths, compute the JAX package's steps
    meanwhile, then collect the ranks' results."""
    index, idx = zt.compress_parallel(DECODE_DATA, 6, chunk_size=16384, return_index=True,
                                      device="cpu")
    sizes = [n for *_, n in idx]
    *operands, cap = tsw.seeded_inputs([index[o : o + n] for o, n, _ in idx], sizes, idx.seeds)
    handles = {
        w: M.Ranks(torch_mesh_ranks.step_cases, w, (STEPS, (operands, cap, 16384)),
                   workdir=tmp_path_factory.mktemp(f"w{w}"), timeout=RANK_TIMEOUT_S, threads=1)
        for w in WIDTHS
    }
    steps = {(w, name): _jax_encode_step(w, name, True) for w in WIDTHS for name in STEPS}
    steps[2, "xla", False] = _jax_encode_step(2, "xla", False)
    jax_decode = {}
    args = [a.astype(np.int32) if a.dtype == np.int64 else a for a in operands]
    for w in WIDTHS:
        mesh = Mesh(np.array(jax.devices()[:w]), ("chunks",))
        step = jsw.make_sharded_decode_step(mesh, cap=cap, max_out=16384)
        jax_decode[w] = [np.asarray(t) for t in step(*args)]
    ranks = {w: h.join() for w, h in handles.items()}
    return dict(ranks=ranks, steps=steps, jax_decode=jax_decode, sizes=sizes)


def _payload(words, bits, rows):
    """The words that hold each row's bits: past them the JAX package's K3
    leaves its output buffer unwritten."""
    return [words[r, : (int(bits[r]) + 31) // 32] for r in rows]


@pytest.mark.parametrize("gather", [True, False])
@pytest.mark.parametrize("name", list(STEPS))
@pytest.mark.parametrize("width", WIDTHS)
def test_encode_step_equals_jax(runs, width, name, gather):
    want = runs["steps"][width, name]
    want = [want[0].view(np.uint32), *want[1:]]
    per_rank = [r["encode"][name, gather] for r in runs["ranks"][width]]
    n = STEPS[name][0][0].shape[0]
    rows = n // width
    for rank, (words, bits, offsets, ll, dl) in enumerate(per_rank):
        words = words.view(np.uint32)  # the port's int32 words, the JAX package's uint32
        mine = slice(rank * rows, (rank + 1) * rows)
        np.testing.assert_array_equal(ll, want[3][mine])
        np.testing.assert_array_equal(dl, want[4][mine])
        if gather:
            assert words.shape == want[0].shape
            np.testing.assert_array_equal(bits, want[1])
            np.testing.assert_array_equal(offsets, want[2])
            for a, b in zip(_payload(words, bits, range(n)), _payload(want[0], bits, range(n))):
                np.testing.assert_array_equal(a, b)
            nbytes = (bits.astype(np.int64) + 7) // 8
            assert (offsets == np.cumsum(nbytes) - nbytes).all() and (bits > 0).all()
            if name == "xla":  # every word, the unwritten tail included
                np.testing.assert_array_equal(words, want[0])
        else:  # the rank's own rows, zero offsets
            assert words.shape == (rows, want[0].shape[1]) and not offsets.any()
            np.testing.assert_array_equal(bits, want[1][mine])
            theirs = _payload(want[0], want[1], range(mine.start, mine.stop))
            for a, b in zip(_payload(words, bits, range(rows)), theirs):
                np.testing.assert_array_equal(a, b)
    if not gather and (width, name) == (2, "xla"):
        local = runs["steps"][2, "xla", False]
        np.testing.assert_array_equal(local[0].view(np.uint32), want[0])
        assert not local[2].any()


@pytest.mark.parametrize("width", WIDTHS)
def test_decode_step_equals_jax(runs, width):
    sizes = runs["sizes"]
    want_out, want_produced, want_bad = runs["jax_decode"][width]
    for out, produced, bad in (r["decode"] for r in runs["ranks"][width]):
        np.testing.assert_array_equal(produced, want_produced)
        np.testing.assert_array_equal(bad, want_bad)
        assert not bad.any()
        got = b"".join(out[k, : sizes[k]].tobytes() for k in range(len(sizes)))
        assert got == DECODE_DATA
        assert np.array_equal(out, want_out)


@pytest.mark.parametrize("hang", [False, True], ids=["raises", "hangs"])
def test_a_failing_rank_fails_the_run(tmp_path, hang):
    """A rank that raises stops its peers, which wait for it in an
    all_gather; one that hangs runs the run into its time limit. Either
    way the launcher raises, and no rank is left running."""
    ranks = M.Ranks(torch_mesh_ranks.fail_on_rank, 2, (1, hang), workdir=tmp_path,
                    timeout=10.0 if hang else RANK_TIMEOUT_S, threads=1)
    with pytest.raises(TimeoutError if hang else RuntimeError,
                       match="ran past" if hang else "fails on purpose"):
        ranks.join()
    assert not any(p.is_alive() for p in ranks.procs)
