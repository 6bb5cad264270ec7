"""The port's driver entry points, the counterparts of the repository's
`__graft_entry__.py` (the JAX package's, which stays as it is):

entry(device=None)    -> (fn, example_args): the dynamic-Huffman chunk
                         encoder on one 16 KiB chunk, its arguments on the
                         card (or on `device`).
dryrun_multichip(n)   -> run the sharded encode and decode steps over a
                         group of n ranks, check them, and sweep the step
                         time over widths 1, 2, 4, ... up to n.

    python -m zlib_rs_tpu_torch.graft_entry --devices N [--device cpu]
    torchrun --nproc_per_node=N -m zlib_rs_tpu_torch.graft_entry --devices N

The first starts N ranks itself (one card each, NCCL; or CPU processes
under gloo with `--device cpu`); under torchrun, or inside a process group
the caller started, the ranks join that group. Every number in the report
comes from the card or CPU it names; it predicts nothing about cards it
did not run on.
"""

from __future__ import annotations

import argparse
import os
import time
import zlib

import numpy as np
import torch
import torch.distributed as dist

from . import _device
from .ops import dynhuff, lz77
from .parallel import mesh as M
from .parallel import pipeline as PL
from .parallel import swarm_inflate as SW

ENTRY_CHUNK = 16384
SWEEP_CHUNK = 65536  # the sweep's chunk a rank
SWEEP_KNOBS = dict(chain_depth=12, max_words=32, lazy=True)  # the XLA engine's level-6 knobs
DECODE_CHUNK = 16384
DRYRUN_TIMEOUT_S = 900.0  # the ranks it starts must end within this


def entry(device=None):
    """(fn, example_args): fn(padded_chunk uint8 [16384 + PAD], n_valid)
    encodes one chunk as a dynamic-Huffman block body with
    `dynhuff.encode_chunk_dynamic` (chain_depth=4, max_words=16) and
    returns (words, body bits, ll_lens, d_lens) of that chunk; the example
    is 16 KiB of bytes under 64 from a seeded generator."""
    dev = _device.resolve_device(device)

    def fn(padded_chunk, n_valid):
        words, bits, ll, dl = dynhuff.encode_chunk_dynamic(
            padded_chunk[None], n_valid.reshape(1), chain_depth=4, max_words=16)
        return words[0], bits[0], ll[0], dl[0]

    rng = np.random.default_rng(0)
    raw = np.zeros(ENTRY_CHUNK + lz77.PAD, np.uint8)
    raw[:ENTRY_CHUNK] = rng.integers(0, 64, ENTRY_CHUNK, dtype=np.uint8)
    example_args = (torch.from_numpy(raw).to(dev),
                    torch.tensor(ENTRY_CHUNK, dtype=torch.int32, device=dev))
    return fn, example_args


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _step_rows(rows: int, chunk: int):
    """The sweep's and the tiny step's batch: `rows` chunks of a repeated
    sentence with a few low bits flipped, from a seeded generator."""
    rng = np.random.default_rng(0)
    raw = np.zeros((rows, chunk + lz77.PAD), np.uint8)
    base = (b"the quick brown fox jumps over the lazy dog %d " * 64) % tuple(range(64))
    blob = (base * (chunk // len(base) + 1))[:chunk]
    raw[:, :chunk] = np.frombuffer(blob, np.uint8)
    raw[:, :chunk] ^= rng.integers(0, 4, (rows, chunk), dtype=np.uint8)
    return (raw, np.full(rows, chunk, np.int32), np.zeros(rows, np.int32),
            np.zeros(rows, np.int32))


def _time_step(mesh, chunk: int, knobs: dict, gather: bool, reps: int):
    """The sharded XLA-engine step on one chunk a rank: its outputs and
    the median of `reps` timed runs, each from a barrier to the rank's
    synchronized end, the slowest rank's median on every rank."""
    lay = M.layout(mesh)
    step = PL.make_sharded_encode_step(mesh, chunk_size=chunk, dynamic=True, gather=gather,
                                       **knobs)
    mine = [torch.from_numpy(a[M.rows_of(lay.width, lay)]).to(lay.device)
            for a in _step_rows(lay.width, chunk)]
    out = step(*mine)
    _sync(lay.device)
    times = []
    for _ in range(reps):
        dist.barrier(group=lay.group)
        t0 = time.perf_counter()
        step(*mine)
        _sync(lay.device)
        times.append(time.perf_counter() - t0)
    median = torch.tensor([sorted(times)[len(times) // 2]], dtype=torch.float64,
                          device=lay.device)
    dist.all_reduce(median, op=dist.ReduceOp.MAX, group=lay.group)
    return out, float(median.item())


def _kernel_step(mesh, chunk: int = 1024, dict_size: int = 512):
    """The kernel engine's sharded step (kernel_cfg (4, 8, 16, 16)) on one
    chunk a rank after a dictionary of `dict_size` zeros: its gathered
    bits, whose offsets must be their prefix sum."""
    lay = M.layout(mesh)
    step = PL.make_sharded_encode_step(mesh, chunk_size=chunk, dict_size=dict_size,
                                       dynamic=True, kernel_scan=True, kernel_cfg=(4, 8, 16, 16))
    width = -(-(dict_size + chunk + lz77.PAD) // 4) * 4
    raw = np.zeros((lay.width, width), np.uint8)
    base = (b"sharded kernel-scan step %d " * 32) % tuple(range(32))
    blob = (base * (chunk // len(base) + 2))[:chunk]
    raw[:, dict_size : dict_size + chunk] = np.frombuffer(blob, np.uint8)
    rows = M.rows_of(lay.width, lay)
    k = rows.stop - rows.start
    _words, bits, offsets, _ll, _dl = step(
        torch.from_numpy(raw[rows]), torch.full((k,), dict_size + chunk, dtype=torch.int32),
        torch.zeros(k, dtype=torch.int32), torch.full((k,), dict_size, dtype=torch.int32))
    bits = bits.cpu().numpy()
    nbytes = (bits.astype(np.int64) + 7) // 8
    if not (offsets.cpu().numpy() == np.cumsum(nbytes) - nbytes).all():
        raise AssertionError("the kernel step's offsets are not the prefix sum of its sizes")
    if not (bits > 0).all():
        raise AssertionError("the kernel step produced an empty payload")
    return bits


def _decode_step(mesh, chunk: int = DECODE_CHUNK) -> tuple[int, int]:
    """compress_parallel(mesh=) of W chunks with seeds, then the sharded
    decode step on them, byte-exact. Returns (bytes, walker kernel
    launches)."""
    lay = M.layout(mesh)
    base = (b"sharded decode across the mesh %d " * 64) % tuple(range(64))
    data = (base * (lay.width * chunk // len(base) + 1))[: lay.width * chunk]
    out, idx = PL.compress_parallel(data, 6, chunk_size=chunk, return_index=True, mesh=mesh)
    if zlib.decompress(out) != data:
        raise AssertionError("the sharded stream does not decode")
    sizes = [n for *_, n in idx]
    *operands, cap = SW.seeded_inputs([out[o : o + n] for o, n, _ in idx], sizes, idx.seeds)
    rows = M.rows_of(len(sizes), lay)
    step = SW.make_sharded_decode_step(mesh, cap=cap, max_out=chunk)
    before = SW.launches["swarm_walk"]
    outb, _produced, bad = step(*(torch.from_numpy(a[rows]) for a in operands))
    if bad.any():
        raise AssertionError("the sharded decode flagged bad seeds")
    got = outb.cpu().numpy()
    if b"".join(got[k, : sizes[k]].tobytes() for k in range(len(sizes))) != data:
        raise AssertionError("the sharded decode gave other bytes")
    return len(data), SW.launches["swarm_walk"] - before


def _sub_mesh(mesh, nd: int):
    """The mesh of the first `nd` ranks of `mesh` (every rank of the mesh
    must call this, in the same order), or None on the ranks outside it."""
    from torch.distributed.device_mesh import DeviceMesh

    lay = M.layout(mesh)
    if nd == lay.width:
        return mesh
    ranks = dist.get_process_group_ranks(lay.group)[:nd]
    group = dist.new_group(ranks)
    if lay.rank >= nd:
        return None
    return DeviceMesh.from_group(group, mesh.device_type, mesh_dim_names=(M.MESH_DIM,))


def dryrun_on_mesh(mesh, n_devices: int, sweep_chunk: int = SWEEP_CHUNK, reps: int = 5):
    """The dry run on this rank of `mesh` (every rank calls it). Raises on
    any failed check; returns the report line, the same on every rank."""
    lay = M.layout(mesh)
    if lay.width != n_devices:
        raise ValueError(f"a mesh of {lay.width} ranks for dryrun_multichip({n_devices})")
    ranks = f"{n_devices} rank{'s' * (n_devices > 1)}"
    where = (f"{torch.cuda.get_device_name(lay.device)} x{n_devices}, NCCL"
             if lay.device.type == "cuda" else f"the CPU, gloo, {ranks}")

    # 1) the XLA engine's tiny step: gathered sizes, prefix-sum offsets
    out, tiny_s = _time_step(mesh, 2048, dict(chain_depth=2, max_words=8), True, reps)
    bits, offsets = out[1].cpu().numpy(), out[2].cpu().numpy()
    nbytes = (bits.astype(np.int64) + 7) // 8
    if not (offsets == np.cumsum(nbytes) - nbytes).all():
        raise AssertionError("offset prefix-sum wrong")
    # 1b) the kernel engine's step; 1c) the decode step
    kbits = _kernel_step(mesh)
    decoded, walks = _decode_step(mesh)

    # 2) the step time at widths 1, 2, 4, ..., with and without the gather
    sweep = []
    nd = 1
    while nd <= n_devices:
        sub = _sub_mesh(mesh, nd)
        if sub is not None:
            _, full = _time_step(sub, sweep_chunk, SWEEP_KNOBS, True, reps)
            _, local = _time_step(sub, sweep_chunk, SWEEP_KNOBS, False, reps)
            sweep.append((nd, full, local))
        nd *= 2
    shared = [sweep]
    dist.broadcast_object_list(shared, group_src=0, group=lay.group)
    parts = [f"{w} rank{'s' * (w > 1)} full={f * 1e3:.3f}ms local={lo * 1e3:.3f}ms "
             f"gather share={max(0.0, (f - lo) / f):.1%}" for w, f, lo in shared[0]]
    report = (
        f"dryrun_multichip({n_devices}): ok on {where}; tiny XLA-engine step "
        f"{tiny_s * 1e3:.3f} ms, bits={bits.tolist()}, offsets={offsets.tolist()}; "
        f"kernel-engine sharded step bits={kbits.tolist()}; sharded decode step byte-exact "
        f"on {decoded} bytes ({walks} walker kernel launches on this rank); step time "
        f"(XLA engine, one {sweep_chunk}-byte chunk a rank, level-6 knobs, medians of "
        f"{reps}, the slowest rank): " + "; ".join(parts)
    )
    return report


def dryrun_multichip(n_devices: int, *, device=None, sweep_chunk: int = SWEEP_CHUNK,
                     reps: int = 5) -> str:
    """Run the dry run over `n_devices` ranks: one card each (`device`
    None or a CUDA device, NCCL), or CPU processes under gloo
    (`device="cpu"`). Inside an initialized process group of that size
    (torchrun's, or the caller's), this process is one of the ranks;
    under torchrun's environment it joins torchrun's group; otherwise it
    starts the ranks itself, which must end within DRYRUN_TIMEOUT_S.
    Prints the report line (once: on rank 0, or in the process that
    started the ranks) and returns it."""
    device_type = "cpu" if device is not None and torch.device(device).type == "cpu" else "cuda"
    if device_type == "cuda":
        _device.resolve_device(None)  # raises without a card
        if not dist.is_initialized() and torch.cuda.device_count() < n_devices:
            raise ValueError(f"dryrun_multichip({n_devices}) needs {n_devices} cards, "
                             f"{torch.cuda.device_count()} visible")
    from torch.distributed.device_mesh import init_device_mesh

    torchrun = all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"))
    if dist.is_initialized() or torchrun:
        started = not dist.is_initialized()
        if started:
            if device_type == "cuda":
                torch.cuda.set_device(M.local_rank())
            dist.init_process_group("nccl" if device_type == "cuda" else "gloo")
        try:
            if dist.get_world_size() != n_devices:
                raise ValueError(f"a group of {dist.get_world_size()} ranks for "
                                 f"dryrun_multichip({n_devices})")
            mesh = init_device_mesh(device_type, (n_devices,), mesh_dim_names=(M.MESH_DIM,))
            report = dryrun_on_mesh(mesh, n_devices, sweep_chunk, reps)
            if dist.get_rank() == 0:
                print(report, flush=True)
            return report
        finally:
            if started:
                dist.destroy_process_group()
    threads = max(1, (os.cpu_count() or 1) // n_devices) if device_type == "cpu" else None
    report = M.Ranks(dryrun_on_mesh, n_devices, (n_devices, sweep_chunk, reps),
                     device_type=device_type, timeout=DRYRUN_TIMEOUT_S, threads=threads).join()[0]
    print(report, flush=True)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m zlib_rs_tpu_torch.graft_entry",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=int(os.environ.get("WORLD_SIZE", "1")),
                    help="ranks of the group (default: torchrun's WORLD_SIZE, else 1)")
    ap.add_argument("--device", default=None, help="'cpu' runs gloo ranks on the CPU")
    ap.add_argument("--sweep-chunk", type=int, default=SWEEP_CHUNK)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    dryrun_multichip(args.devices, device=args.device, sweep_chunk=args.sweep_chunk,
                     reps=args.reps)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
