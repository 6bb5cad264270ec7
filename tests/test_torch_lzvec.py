"""The port's match and hop tables (zlib_rs_tpu_torch.ops.lzvec) against
the JAX package's (zlib_rs_tpu.ops.lzvec) on the same seeded chunk
buffers. Integer tables: every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zlib_rs_tpu.ops import lzvec as jl
from zlib_rs_tpu_torch.ops import lzvec as tl

# the test workers share the cores, and an oversubscribed OpenMP pool spin-waits
torch.set_num_threads(1)

_BASH = open("/bin/bash", "rb").read()
PAD = 272
# level 6 of the kernel engine: depth 64, nice 128, good 8, max_lazy 16, w_g 6
L6 = dict(depth=64, nice=128, good=8, max_lazy=16, w_g=6)


def _chunks(seed: int, dict_size: int = 4096, chunk: int = 4096):
    """Three primed chunk buffers like the pipeline's: dictionary bytes
    before each chunk, `ins_from` where real context starts (no dict, a
    partial dict, the full dict), the last one short."""
    rng = np.random.default_rng(seed)
    width = dict_size + chunk + PAD
    ins_from = np.array([dict_size, 1000, 0], np.int32)
    data_len = np.array([chunk, chunk, chunk - chunk // 3], np.int32)
    buf = np.zeros((3, width), np.uint8)
    for r in range(3):
        off = int(rng.integers(0, len(_BASH) - width))
        n = dict_size + int(data_len[r])
        buf[r, ins_from[r] : n] = np.frombuffer(_BASH[off + ins_from[r] : off + n], np.uint8)
    n_valid = (data_len + dict_size).astype(np.int32)
    bb = buf.reshape(3, -1, 4).astype(np.uint32)
    w4 = bb[..., 0] | (bb[..., 1] << 8) | (bb[..., 2] << 16) | (bb[..., 3] << 24)
    w4 = np.concatenate([w4, np.zeros((3, 2), np.uint32)], axis=1)
    return buf, w4, n_valid, ins_from


def _both(fn_j, fn_t, buf, w4, n_valid, ins_from, with_bytes, **kw):
    jb = jnp.asarray(buf) if with_bytes else None
    tb = torch.from_numpy(buf) if with_bytes else None
    ref = fn_j(jnp.asarray(w4), jnp.asarray(n_valid), jnp.asarray(ins_from),
               bytes_arr=jb, **kw)
    got = fn_t(torch.from_numpy(w4.view(np.int32)), torch.from_numpy(n_valid),
               torch.from_numpy(ins_from), bytes_arr=tb, **kw)
    return ref, got


@pytest.mark.parametrize("precise", [False, True])
@pytest.mark.parametrize("with_bytes", [True, False])
def test_match_tables_equal_jax(precise, with_bytes):
    buf, w4, n_valid, ins_from = _chunks(1)
    kw = dict(depth=L6["depth"], nice=L6["nice"], w_g=L6["w_g"], precise=precise)
    (jf, jq), (tf, tq) = _both(
        jl.build_match_tables, tl.build_match_tables, buf, w4, n_valid,
        ins_from, with_bytes, **kw,
    )
    assert tf.dtype == torch.int32 and tf.shape == (3, 4 * w4.shape[1])
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert (tf.numpy() >> 16).max() >= 3  # the data does have matches


@pytest.mark.parametrize("precise", [False, True])
def test_hop_tables_equal_jax_level6(precise):
    buf, w4, n_valid, ins_from = _chunks(2)
    ref, got = _both(
        jl.build_hop_tables, tl.build_hop_tables, buf, w4, n_valid, ins_from,
        True, precise=precise, **L6,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize(
    "knobs",
    [
        dict(depth=32, nice=32, good=4, max_lazy=6, w_g=6),    # level 3
        dict(depth=256, nice=128, good=8, max_lazy=32, w_g=6),  # level 7
        dict(depth=3, nice=16, good=4, max_lazy=5, w_g=4),     # depth >> 2 == 0
    ],
)
def test_hop_tables_equal_jax_other_knobs(knobs):
    buf, w4, n_valid, ins_from = _chunks(3, dict_size=2048, chunk=3000)
    ref, got = _both(
        jl.build_hop_tables, tl.build_hop_tables, buf, w4, n_valid, ins_from,
        True, **knobs,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_hop_tables_reject_wide_fields():
    buf, w4, n_valid, ins_from = _chunks(4, dict_size=512, chunk=512)
    with pytest.raises(ValueError):
        tl.build_hop_tables(
            torch.from_numpy(w4.view(np.int32)), torch.from_numpy(n_valid),
            torch.from_numpy(ins_from), depth=8, nice=16, good=4,
            max_lazy=16, w_g=32,
        )
