"""The multi-device layer over torch.distributed: a mesh's width, rank and
device, a rank's rows of a batch, the ordered gather, and a launcher of
ranks on one host.

A mesh is a 1-D `torch.distributed.device_mesh.DeviceMesh` whose one dim
is named "chunks", torch's counterpart of the reference's
`Mesh(devices, ("chunks",))`. The sharded paths are SPMD: every rank runs
the same call on the same arguments, works on its contiguous block of a
batch's rows (`[r * b / W, (r + 1) * b / W)`, as `P("chunks")` lays a
batch out), and gathers the results in chunk order, so that every rank
returns the same result.

The mesh's device type picks the device: "cuda" means `cuda:<local rank>`
under NCCL, "cpu" the kernels' plain versions under gloo. Every kernel
wrapper launches on the CUDA runtime's current device, so `layout` makes
the rank's card the current one before anything is allocated; a `device=`
that contradicts the mesh raises ValueError. No path carries on unsharded
or on the CPU when a collective fails: the error propagates.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import pickle
import tempfile
import time
import traceback
from dataclasses import dataclass
from pathlib import Path

import torch
import torch.distributed as dist

MESH_DIM = "chunks"
RANK_TIMEOUT_S = 120.0  # the launcher's default limit on a run of ranks


@dataclass(frozen=True)
class Layout:
    """A rank's place in a mesh: the mesh's width, the rank's coordinate
    (its place in the gather order), the mesh's process group and the
    rank's device."""

    width: int
    rank: int
    group: object
    device: torch.device


def local_rank() -> int:
    """The rank's card on its host: LOCAL_RANK where a launcher (torchrun,
    `Ranks`) set it, else the global rank modulo the visible cards."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() % max(1, torch.cuda.device_count())


def layout(mesh, device=None) -> Layout:
    """The rank's `Layout` in `mesh`. Under a "cuda" mesh the rank's card
    becomes the current device; `device`, when given, must name the
    mesh's device type (and, on a card, the rank's card)."""
    if not hasattr(mesh, "get_group") or mesh.ndim != 1 or mesh.mesh_dim_names != (MESH_DIM,):
        raise ValueError(f"mesh must be a 1-D DeviceMesh with the dim name {MESH_DIM!r}, "
                         f"got {mesh!r}")
    group = mesh.get_group(MESH_DIM)
    rank = mesh.get_local_rank(MESH_DIM)
    if dist.get_rank(group) != rank:
        raise ValueError(f"mesh coordinate {rank} is rank {dist.get_rank(group)} of its "
                         "group: the gather would not keep chunk order")
    want = None if device is None else torch.device(device)
    if mesh.device_type == "cuda":
        dev = torch.device("cuda", local_rank())
        if want is not None and (want.type != "cuda" or want.index not in (None, dev.index)):
            raise ValueError(f"device={device!r} contradicts the mesh's device {dev}")
        torch.cuda.set_device(dev)
        bound = getattr(group, "bound_device_id", None)
        if torch.cuda.current_device() != dev.index or (
                bound is not None and bound.index != dev.index):
            raise RuntimeError(f"the rank's card {dev} is not its current device "
                               f"({torch.cuda.current_device()}, group bound to {bound})")
    elif mesh.device_type == "cpu":
        dev = torch.device("cpu")
        if want is not None and want.type != "cpu":
            raise ValueError(f"device={device!r} contradicts the mesh's device cpu")
    else:
        raise ValueError(f"unsupported mesh device type {mesh.device_type!r}")
    return Layout(mesh.size(), rank, group, dev)


def rows_of(n_rows: int, lay: Layout) -> slice:
    """The rank's contiguous rows of a batch of `n_rows`, which the width
    must divide."""
    if n_rows % lay.width:
        raise ValueError(f"a batch of {n_rows} rows does not divide over {lay.width} ranks")
    k = n_rows // lay.width
    return slice(lay.rank * k, (lay.rank + 1) * k)


def gather_rows(t: torch.Tensor, lay: Layout) -> torch.Tensor:
    """`all_gather` of every rank's rows, concatenated along dim 0 in rank
    (chunk) order. Every rank must pass the same shape and dtype."""
    src = t.to(torch.uint8) if t.dtype == torch.bool else t
    src = src.contiguous()
    parts = [torch.empty_like(src) for _ in range(lay.width)]
    dist.all_gather(parts, src, group=lay.group)
    out = torch.cat(parts)
    return out.bool() if t.dtype == torch.bool else out


def _rank_main(rank, world, device_type, out_dir, threads, timeout_s):
    """One rank of `Ranks`: load the call from `out_dir/call.pkl`, join the
    group, build the mesh, run `fn(mesh, *args)` and pickle its result (or
    its traceback) to `out_dir/rank<r>.pkl`."""
    from torch.distributed.device_mesh import init_device_mesh

    os.environ["LOCAL_RANK"] = str(rank)
    if threads:
        torch.set_num_threads(threads)
    work = Path(out_dir)
    path = work / f"rank{rank}.pkl"
    try:
        fn, args = pickle.loads((work / "call.pkl").read_bytes())
        if device_type == "cuda":
            torch.cuda.set_device(rank)
        dist.init_process_group(
            "nccl" if device_type == "cuda" else "gloo",
            init_method=f"file://{work / 'rendezvous'}",
            rank=rank, world_size=world, timeout=datetime.timedelta(seconds=timeout_s),
        )
        try:
            mesh = init_device_mesh(device_type, (world,), mesh_dim_names=(MESH_DIM,))
            result = ("ok", fn(mesh, *args))
        finally:
            dist.destroy_process_group()
    except BaseException:  # the parent reports it and stops the other ranks
        path.write_bytes(pickle.dumps(("error", traceback.format_exc())))
        raise SystemExit(1)
    path.write_bytes(pickle.dumps(result))


class Ranks:
    """`world` ranks of one host running `fn(mesh, *args)`, each a fresh
    spawned process in a group that rendezvous through a file in
    `workdir` (a temporary directory when None): gloo under a "cpu" mesh,
    NCCL on `cuda:<rank>` under a "cuda" one. `fn` and `args` must pickle,
    and `fn` must live in a module the ranks can import. The ranks start
    at once; `join` waits for them.

    The group's own timeout is `timeout`, so a collective that a peer
    never joins raises on the ranks that wait in it."""

    def __init__(self, fn, world: int, args=(), *, device_type: str = "cpu", workdir=None,
                 timeout: float = RANK_TIMEOUT_S, threads: int | None = None):
        self._tmp = None
        if workdir is None:
            self._tmp = tempfile.TemporaryDirectory(prefix="zrs_ranks_")
            workdir = self._tmp.name
        self.work = Path(workdir)
        self.work.mkdir(parents=True, exist_ok=True)
        self.world, self.timeout = world, timeout
        self.name = getattr(fn, "__name__", str(fn))
        (self.work / "rendezvous").unlink(missing_ok=True)
        for old in self.work.glob("rank*.pkl"):
            old.unlink()
        # the call goes through a file: a spawn's start blocks until the
        # child has read what goes through its pipe
        (self.work / "call.pkl").write_bytes(pickle.dumps((fn, tuple(args))))
        ctx = multiprocessing.get_context("spawn")
        self.procs = [
            ctx.Process(target=_rank_main, daemon=True, args=(
                r, world, device_type, str(self.work), threads, timeout))
            for r in range(world)
        ]
        for p in self.procs:
            p.start()
        self.deadline = time.monotonic() + timeout

    def _result(self, r):
        path = self.work / f"rank{r}.pkl"
        if path.exists():
            return pickle.loads(path.read_bytes())
        return "error", f"exit code {self.procs[r].exitcode}, no result (stopped)"

    def join(self) -> list:
        """The ranks' results in rank order. When a rank fails, the others
        are stopped and RuntimeError carries every failed rank's traceback
        (the first failure and the peers it broke); when the ranks
        have not all ended `timeout` seconds after their start, they are
        all stopped and TimeoutError is raised."""
        procs = self.procs
        try:
            while any(p.is_alive() for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                if time.monotonic() > self.deadline:
                    raise TimeoutError(f"{self.world} ranks of {self.name} ran past "
                                       f"{self.timeout:.0f} s and were stopped")
                time.sleep(0.05)
            results = [self._result(r) for r in range(self.world)]
            errors = [f"rank {r}: {value}" for r, (status, value) in enumerate(results)
                      if status != "ok"]
            if errors:
                raise RuntimeError(f"{len(errors)} of {self.world} ranks of {self.name} "
                                   "failed:\n" + "\n".join(errors))
            return [value for _status, value in results]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join()
            if self._tmp is not None:
                self._tmp.cleanup()
