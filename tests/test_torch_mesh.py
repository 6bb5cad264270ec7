"""The port's `compress_parallel(mesh=)` on the CPU, over gloo groups of
2, 3 and 4 ranks (spawned processes that import the port alone,
tests/torch_mesh_ranks.py), held against the port's unsharded streams and
the JAX package's `compress_parallel` on the same inputs: both engines,
levels 1, 6 and 9, zlib, gzip and raw, indexes with their seeds, chunk
counts that no width divides, two batches, and random bytes (stored
chunks, whose full rows the ranks gather from their owners). Every rank
must return the same stream. Also the devices and meshes the path
refuses.

The ranks rendezvous through a file in the test's temporary directory and
run under a time limit of their own (`RANK_TIMEOUT_S`), past which they
are stopped and the test fails; a rank that raises stops the others
(tests/test_torch_mesh_steps.py holds the launcher to both). The ranks
start first and run while this process computes the references. Both
packages build their trees with XLA's own 2^len weights
(tests/test_torch_dynhuff.py), so that density ties break alike."""

import sys
import zlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

import zlib_rs_tpu.parallel.pipeline as jp
import zlib_rs_tpu_torch as zt
from zlib_rs_tpu_torch.ops import dynhuff as td
from zlib_rs_tpu_torch.parallel import mesh as M
from zlib_rs_tpu_torch.parallel import pipeline as tp
from zlib_rs_tpu_torch.parallel import swarm_inflate as tsw

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_mesh_ranks  # noqa: E402

torch.set_num_threads(1)

RANK_TIMEOUT_S = 180.0  # the ranks start at once and end long before it, even on a busy host
WIDTHS = (2, 3, 4)
_BASH = open("/bin/bash", "rb").read()
FIVE = _BASH[200_000 : 200_000 + 5 * 8192 - 1000]  # five 8 KiB chunks: no width divides it
MANY = _BASH[260_000 : 260_000 + 17 * 8192 - 77]  # 17 chunks: two batches at every width
RANDOM = np.random.default_rng(3).integers(0, 256, 30_000, dtype=np.uint8).tobytes()
K = {"ZRS_TPU_KERNEL": "1"}

# {name: (data, level, options, environment)}
CASES = {
    "level1": (FIVE, 1, dict(chunk_size=8192), {}),
    "level6": (FIVE, 6, dict(chunk_size=8192), {}),
    "level9": (FIVE, 9, dict(chunk_size=8192), {}),
    "gzip": (FIVE, 6, dict(chunk_size=8192, window_bits=31), {}),
    "raw": (FIVE, 6, dict(chunk_size=8192, window_bits=-15), {}),
    "index": (FIVE, 6, dict(chunk_size=8192, return_index=True), {}),
    "stored": (RANDOM, 1, dict(chunk_size=8192), {}),
    "stored_index": (RANDOM, 6, dict(chunk_size=8192, return_index=True), {}),
    "two_batches": (MANY, 1, dict(chunk_size=8192), {}),
    "kernel": (FIVE, 6, dict(chunk_size=8192), K),
    "kernel_index": (FIVE, 6, dict(chunk_size=8192, return_index=True), K),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the ranks of every width, compute the references meanwhile,
    then collect the ranks' results: {"ranks": {W: [per-rank results]},
    "port": {case: unsharded result}, "jax": {case: result}}."""
    exp2 = np.asarray(jnp.exp2(jnp.arange(16, dtype=jnp.float32))).copy()
    handles = {
        w: M.Ranks(torch_mesh_ranks.compress_cases, w, (exp2, CASES),
                   workdir=tmp_path_factory.mktemp(f"w{w}"), timeout=RANK_TIMEOUT_S, threads=1)
        for w in WIDTHS
    }
    port, ref = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(td, "EXP2_LEN", torch.from_numpy(exp2))
        for case, (data, level, kw, env) in CASES.items():
            for name in torch_mesh_ranks.ENV:
                mp.delenv(name, raising=False)
            for name, value in env.items():
                mp.setenv(name, value)
            port[case] = zt.compress_parallel(data, level, device="cpu", **kw)
            ref[case] = jp.compress_parallel(data, level, **kw)
    ranks = {w: h.join() for w, h in handles.items()}
    return dict(ranks=ranks, port=port, jax=ref)


def _same_result(a, b) -> bool:
    if isinstance(a, tuple):
        (sa, ia), (sb, ib) = a, b
        return sa == sb and list(ia) == list(ib) and ia.seeds == ib.seeds
    return a == b


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("width", WIDTHS)
def test_compress_mesh_equals_unsharded_and_jax(runs, width, case):
    port, ref = runs["port"][case], runs["jax"][case]
    assert _same_result(port, ref)
    per_rank = [r["compress"][case] for r in runs["ranks"][width]]
    assert len(per_rank) == width
    for got in per_rank:
        assert _same_result(got, port)
    stream = port[0] if isinstance(port, tuple) else port
    data, _level, kw, _env = CASES[case]
    d = zlib.decompressobj(kw.get("window_bits", 15))
    assert d.decompress(stream) + d.flush() == data and d.eof


@pytest.mark.parametrize("width", WIDTHS)
def test_stored_chunks_fetch_their_rows_from_the_owner(runs, width):
    """Random bytes at level 1: every static block passes the fetched
    bound, so every rank gathers the full rows once and the chunks are
    stored; at level 6 the stored chunks carry no seeds."""
    _stream, index = runs["port"]["stored_index"]
    assert index.seeds is not None and all(s is None for s in index.seeds)
    for r in runs["ranks"][width]:
        assert r["full_row_gathers"]["stored"] == 1
        assert r["full_row_gathers"]["level1"] == 0


@pytest.mark.parametrize("width", [1, 2, 3, 4, 5, 8])
def test_mesh_batches_follow_the_reference_rule(width):
    """max(W, min(16, ceil(16 / W) * W)) chunks a batch (the reference's
    `compress_parallel` under a mesh), no super-batches, the last batch
    short; `_shard_batch` pads a batch to a multiple of W with empty rows
    and gives each rank its contiguous block."""
    batch = max(width, min(16, -(-16 // width) * width))
    n = 2 * batch + 3
    spans = tp.batch_spans(n, bulk=False, width=width)
    assert spans == [(0, batch), (batch, batch), (2 * batch, 3)]
    padded = np.arange(n * 2, dtype=np.uint8).reshape(n, 2)
    arrays = (padded, np.arange(n, dtype=np.int32) + 100, np.arange(n, dtype=np.int32),
              np.zeros(n, np.int32))
    rows = []
    for rank in range(width):
        lay = M.Layout(width, rank, None, torch.device("cpu"))
        (p, nv, vf, fin), g0 = tp._shard_batch(arrays, 2 * batch, 3, lay, 7)
        assert g0 == 2 * batch + rank * (-(-3 // width))
        rows += list(zip(p.tolist(), nv.tolist(), vf.tolist(), fin.tolist()))
    want = [(padded[k].tolist(), 100 + k, k, 0) for k in range(2 * batch, n)]
    empty = ([0, 0], 7, 7, 0)
    assert rows == want + [empty] * (-(-3 // width) * width - 3)


@pytest.fixture
def one_rank_mesh(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}", rank=0,
                            world_size=1)
    try:
        yield init_device_mesh("cpu", (1,), mesh_dim_names=("chunks",))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("device", ["cuda", "cuda:0", "meta"])
def test_device_contradicting_the_mesh_raises(one_rank_mesh, device):
    data = FIVE[:9000]
    with pytest.raises(ValueError, match="contradicts"):
        zt.compress_parallel(data, 1, chunk_size=8192, mesh=one_rank_mesh, device=device)
    got = zt.compress_parallel(data, 1, chunk_size=8192, mesh=one_rank_mesh, device="cpu")
    assert got == zt.compress_parallel(data, 1, chunk_size=8192, device="cpu")


def test_mesh_of_another_shape_raises(one_rank_mesh):
    other = init_device_mesh("cpu", (1,), mesh_dim_names=("rows",))
    for mesh in (other, object()):
        with pytest.raises(ValueError, match="1-D DeviceMesh"):
            zt.compress_parallel(FIVE, 1, mesh=mesh, device="cpu")
        with pytest.raises(ValueError, match="1-D DeviceMesh"):
            tp.make_sharded_encode_step(mesh, chunk_size=8192)
        with pytest.raises(ValueError, match="1-D DeviceMesh"):
            tsw.make_sharded_decode_step(mesh, cap=512, max_out=8192)
