"""The port's graft entry points (zlib_rs_tpu_torch/graft_entry.py) on the
CPU: `entry()` against the JAX package's `__graft_entry__.entry()` on the
same example, and `dryrun_multichip` over gloo ranks it starts itself,
through its command line, and inside a one-rank group it joins. The dry
run's sweep runs at a small chunk and one repetition."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from zlib_rs_tpu_torch import graft_entry
from zlib_rs_tpu_torch.ops import dynhuff as td

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import __graft_entry__ as jax_entry  # noqa: E402

torch.set_num_threads(1)

SMALL = dict(device="cpu", sweep_chunk=2048, reps=1)


def test_entry_equals_jax(monkeypatch):
    table = np.asarray(jnp.exp2(jnp.arange(16, dtype=jnp.float32))).copy()
    monkeypatch.setattr(td, "EXP2_LEN", torch.from_numpy(table))
    fn, args = graft_entry.entry(device="cpu")
    jfn, jargs = jax_entry.entry()
    np.testing.assert_array_equal(args[0].numpy(), np.asarray(jargs[0]))
    assert int(args[1]) == int(jargs[1])
    words, bits, ll, dl = fn(*args)
    jwords, jbits, jll, jdl = (np.asarray(t) for t in jax.jit(jfn)(*jargs))
    assert words.shape == jwords.shape and int(bits) == int(jbits) > 0
    np.testing.assert_array_equal(words.numpy().view(np.uint32), jwords)
    np.testing.assert_array_equal(ll.numpy(), jll)
    np.testing.assert_array_equal(dl.numpy(), jdl)


def test_dryrun_multichip_on_two_gloo_ranks(capsys):
    report = graft_entry.dryrun_multichip(2, **SMALL)
    assert report.startswith("dryrun_multichip(2): ok on the CPU, gloo, 2 ranks")
    assert "sharded decode step byte-exact on 32768 bytes" in report
    assert "1 rank full=" in report and "2 ranks full=" in report
    assert "efficiency" not in report  # no claim for cards it did not run on
    assert capsys.readouterr().out.strip() == report


def test_dryrun_command_line(capsys):
    assert graft_entry.main(["--devices", "2", "--device", "cpu", "--sweep-chunk", "2048",
                             "--reps", "1"]) == 0
    assert capsys.readouterr().out.startswith("dryrun_multichip(2): ok on the CPU, gloo")


def test_dryrun_joins_the_callers_group(tmp_path, capsys):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}", rank=0,
                            world_size=1)
    try:
        report = graft_entry.dryrun_multichip(1, **SMALL)
        with pytest.raises(ValueError, match="a group of 1 ranks"):
            graft_entry.dryrun_multichip(2, **SMALL)
    finally:
        dist.destroy_process_group()
    assert report.startswith("dryrun_multichip(1): ok on the CPU, gloo, 1 rank;")
    assert "sharded decode step byte-exact on 16384 bytes" in report
    assert capsys.readouterr().out.strip() == report
