"""The port's checksums (zlib_rs_tpu_torch.ops.checksum) against the JAX
package and stdlib zlib. Integer arithmetic: every comparison is exact.

`adler32_batch` on a CPU tensor runs K1's plain PyTorch version; the JAX
side runs its XLA reduction and its Pallas kernel in interpret mode."""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zlib_rs_tpu.ops import checksum as jchk
from zlib_rs_tpu.ops.pallas import checksum_kernels as jck
from zlib_rs_tpu_torch.ops import checksum as tchk
from zlib_rs_tpu_torch.ops.kernels import checksum_kernels as tck

# the test workers share the cores, and an oversubscribed OpenMP pool spin-waits
torch.set_num_threads(1)

_BASH = open("/bin/bash", "rb").read()


def _rows(seed: int, B: int, N: int):
    """uint8 [B, N] rows cut from /bin/bash at seeded offsets, zero past
    each row's seeded true length (0 and N included)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, N + 1, size=B).astype(np.int32)
    lens[0] = 0
    lens[-1] = N
    data = np.zeros((B, N), np.uint8)
    for r in range(B):
        off = int(rng.integers(0, len(_BASH) - N))
        data[r, : lens[r]] = np.frombuffer(_BASH[off : off + lens[r]], np.uint8)
    return data, lens


@pytest.mark.parametrize(
    "B,N", [(1, 1), (3, 1000), (5, 4097), (8, 4096), (2, 65521), (16, 32768)]
)
def test_adler32_batch_matches_jax_and_zlib(B, N):
    data, lens = _rows(B * 7 + N, B, N)
    got = tchk.adler32_batch(torch.from_numpy(data), torch.from_numpy(lens)).numpy()
    ref = np.asarray(jchk.adler32_batch_jax(jnp.asarray(data), jnp.asarray(lens)))
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, ref.astype(np.int64))
    for r in range(B):
        assert int(got[r]) == zlib.adler32(data[r, : lens[r]].tobytes())


def test_adler32_batch_matches_pallas_kernel_interpret():
    data, lens = _rows(11, 8, 4096)
    got = tchk.adler32_batch(torch.from_numpy(data), torch.from_numpy(lens)).numpy()
    ref = np.asarray(jck.adler32_batch_pallas(
        jnp.asarray(data), jnp.asarray(lens), interpret=True
    ))
    np.testing.assert_array_equal(got, ref.astype(np.int64))


def test_adler32_batch_strided_rows_and_full_chunk():
    # the pipeline hands K1 a column slice of the chunk buffer
    rng = np.random.default_rng(5)
    buf = rng.integers(0, 256, size=(4, 32768 + 300), dtype=np.uint8)
    lens = np.array([32768, 1, 0, 20000], np.int32)
    view = torch.from_numpy(buf)[:, 100 : 100 + 32768]
    got = tchk.adler32_batch(view, torch.from_numpy(lens)).numpy()
    for r in range(4):
        assert int(got[r]) == zlib.adler32(buf[r, 100 : 100 + lens[r]].tobytes())


def test_adler32_batch_plain_of_all_ff_bytes():
    # the largest per-byte terms: no overflow in the int64 sums
    data = np.full((2, 65536), 255, np.uint8)
    lens = np.array([65536, 65521], np.int32)
    got = tck.adler32_batch_plain(torch.from_numpy(data), torch.from_numpy(lens))
    got = got.numpy().view(np.uint32)
    for r in range(2):
        assert int(got[r]) == zlib.adler32(data[r, : lens[r]].tobytes())


def test_adler32_kernel_wrapper_refuses_cpu_tensors():
    data = torch.zeros((2, 8), dtype=torch.uint8)
    lens = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="CUDA"):
        tck.adler32_batch_cuda(data, lens)


@pytest.mark.parametrize("split", [0, 1, 777, 32768, 50_000])
def test_combines_match_zlib(split):
    buf = _BASH[300_000 : 300_000 + 50_000]
    a, b = buf[:split], buf[split:]
    want_adler = zlib.adler32(buf)
    got = tchk.adler32_combine(zlib.adler32(a), zlib.adler32(b), len(b))
    assert got == want_adler == jchk.adler32_combine(zlib.adler32(a), zlib.adler32(b), len(b))
