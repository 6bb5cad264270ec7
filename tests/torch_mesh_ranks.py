"""Rank functions for tests/test_torch_mesh.py and test_torch_mesh_steps.py.

A helper module, not a test file: the ranks are spawned processes that
import it, so it imports the port alone, never JAX (importing the test
module would pull in JAX and the XLA flags of tests/conftest.py). Each
function takes the rank's DeviceMesh first, as `mesh.Ranks` calls it.
"""

import os

import torch

ENV = ("ZRS_TPU_KERNEL", "ZRS_TPU_CHAIN", "ZRS_TPU_WG", "ZRS_TPU_HOPSCAN",
       "ZRS_TPU_TABSCAN", "ZRS_TPU_HOP_IL")


def _set_env(env: dict) -> None:
    for name in ENV:
        os.environ.pop(name, None)
    os.environ.update(env)


def compress_cases(mesh, exp2, cases):
    """`compress_parallel(mesh=)` of each of `cases` ({name: (data, level,
    kwargs, environment)}) on this rank, the trees built with the density
    weight table `exp2`. Returns {"compress": {name: result},
    "full_row_gathers": {name: count}}."""
    import zlib_rs_tpu_torch as zt
    from zlib_rs_tpu_torch.ops import dynhuff
    from zlib_rs_tpu_torch.parallel import pipeline as PL

    dynhuff.EXP2_LEN = torch.from_numpy(exp2)
    real_gather = PL._gather_full_rows
    gathers = []
    PL._gather_full_rows = lambda *a: gathers.append(1) or real_gather(*a)
    out = {"compress": {}, "full_row_gathers": {}}
    for name, (data, level, kw, env) in cases.items():
        _set_env(env)
        gathers.clear()
        out["compress"][name] = zt.compress_parallel(data, level, mesh=mesh, **kw)
        out["full_row_gathers"][name] = len(gathers)
    return out


def step_cases(mesh, encode_steps, decode):
    """The sharded steps on this rank: each of `encode_steps` ({name:
    (inputs of the whole batch, step options)}) on the rank's rows, with
    and without the gather, and the decode step on `decode` ((operands of
    the whole batch, cap, max_out)). Returns {"encode": {(name, gather):
    outputs}, "decode": outputs}, as numpy arrays."""
    from zlib_rs_tpu_torch.parallel import mesh as M
    from zlib_rs_tpu_torch.parallel import pipeline as PL
    from zlib_rs_tpu_torch.parallel import swarm_inflate as SW

    _set_env({})
    lay = M.layout(mesh)
    out = {"encode": {}, "decode": None}
    for name, (inputs, kw) in encode_steps.items():
        mine = [a[M.rows_of(inputs[0].shape[0], lay)] for a in inputs]
        for gather in (True, False):
            step = PL.make_sharded_encode_step(mesh, gather=gather, **kw)
            res = step(*(torch.from_numpy(a) for a in mine))
            out["encode"][name, gather] = [t.cpu().numpy() for t in res]
    operands, cap, max_out = decode
    mine = [a[M.rows_of(operands[0].shape[0], lay)] for a in operands]
    step = SW.make_sharded_decode_step(mesh, cap=cap, max_out=max_out)
    out["decode"] = [t.cpu().numpy() for t in step(*(torch.from_numpy(a) for a in mine))]
    return out


def fail_on_rank(mesh, bad_rank: int, hang: bool):
    """Rank `bad_rank` raises (or, with `hang`, sleeps) while the others
    wait for it in an all_gather."""
    import time

    from zlib_rs_tpu_torch.parallel import mesh as M

    lay = M.layout(mesh)
    if lay.rank == bad_rank:
        if hang:
            time.sleep(3600)
        raise ValueError(f"rank {bad_rank} fails on purpose")
    return M.gather_rows(torch.zeros(1, dtype=torch.int32), lay).tolist()

