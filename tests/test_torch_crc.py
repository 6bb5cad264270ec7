"""K7, the batched crc32, and the gzip trailer it feeds: the port's plain
version (`device="cpu"`) against the JAX package's K7 in interpret mode
and stdlib zlib, on full and ragged rows; the host combine; the gzip
streams of `compress_parallel` against the JAX package's bytes."""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zlib_rs_tpu.parallel.pipeline as jp
from zlib_rs_tpu.ops import gf2 as jgf2
from zlib_rs_tpu.ops.pallas import crc_kernels as JK
import zlib_rs_tpu_torch as zt
from zlib_rs_tpu_torch.ops import checksum as C
from zlib_rs_tpu_torch.ops import gf2
from zlib_rs_tpu_torch.ops.kernels import crc_kernels as CK
from zlib_rs_tpu_torch.parallel import pipeline as tp

# the test workers share the cores, and an oversubscribed OpenMP pool spin-waits
torch.set_num_threads(1)

_BASH = open("/bin/bash", "rb").read()


def _rows(B, N, seed):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 256, (B, N), dtype=np.uint8)
    rows[: B // 2] = np.frombuffer(_BASH[: (B // 2) * N], np.uint8).reshape(B // 2, N)
    return rows


def test_plain_equals_jax_kernel_and_zlib_on_full_rows():
    rows = _rows(8, 32 * 1024, 1)
    got = C.crc32_batch(torch.from_numpy(rows)).numpy()
    want = np.asarray(JK.crc32_batch_pallas(jnp.asarray(rows), interpret=True))
    assert got.tolist() == want.astype(np.int64).tolist()
    assert got.tolist() == [zlib.crc32(r.tobytes()) for r in rows]


@pytest.mark.parametrize("N", [1, 3, 255, 256, 257, 1000, 4099])
def test_plain_on_ragged_rows_equals_zlib(N):
    rows = _rows(6, N, N)
    lens = np.array([0, 1, N // 2, N - 1, N, N // 3], np.int32)
    got = C.crc32_batch(torch.from_numpy(rows), torch.from_numpy(lens)).numpy()
    assert got.tolist() == [zlib.crc32(r[:n].tobytes()) for r, n in zip(rows, lens)]


def test_plain_returns_int32_bit_views():
    rows = np.full((2, 64), 0xFF, np.uint8)
    out = CK.crc32_batch_plain(torch.from_numpy(rows), torch.tensor([64, 7], dtype=torch.int32))
    assert out.dtype == torch.int32
    assert (out.numpy().view(np.uint32)).tolist() == [
        zlib.crc32(rows[0].tobytes()), zlib.crc32(rows[1, :7].tobytes())]


def test_kernel_wrapper_refuses_cpu_tensors():
    rows = torch.zeros((2, 16), dtype=torch.uint8)
    with pytest.raises(RuntimeError, match="CUDA"):
        CK.crc32_batch_cuda(rows, torch.tensor([16, 16], dtype=torch.int32))


@pytest.mark.parametrize("split", [0, 1, 4095, 32768, 65535])
def test_combine_and_host_crc_equal_zlib_and_jax(split):
    data = _BASH[:70_001]
    a, b = data[:split], data[split:]
    got = C.crc32_combine(C.crc32(a), C.crc32(b), len(b))
    assert got == zlib.crc32(data)
    assert got == jgf2.crc32_combine(zlib.crc32(a), zlib.crc32(b), len(b))
    assert C.crc32(b, C.crc32(a)) == zlib.crc32(data)


def test_gf2_table_and_shift_equal_the_jax_package():
    # the port's carry-less shift is the reference's packed shift matrix
    assert (gf2.CRC_TABLE == jgf2.CRC_TABLE).all()
    for n, crc in zip((0, 1, 3, 4096, 32768, 123_457), (0, 1, 0xFFFFFFFF, 0x80000000, 0x1234, 0xDEADBEEF)):
        want = jgf2.matrix_times_vec(jgf2.shift_matrix_for_len(n), crc)
        assert gf2.crc32_combine(crc, 0, n) == want


@pytest.mark.parametrize("n", [0, 5, 32_767, 32_768, 65_536 + 99])
def test_gzip_trailer_crc_equals_zlib(n):
    data = (_BASH * 2)[:n]
    assert tp._gzip_crc(data, tp.DEFAULT_CHUNK, torch.device("cpu")) == zlib.crc32(data)


@pytest.fixture
def kernel_engine(monkeypatch):
    for name in ("ZRS_TPU_CHAIN", "ZRS_TPU_WG", "ZRS_TPU_HOPSCAN", "ZRS_TPU_TABSCAN",
                 "ZRS_TPU_HOP_IL"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("ZRS_TPU_KERNEL", "1")
    from zlib_rs_tpu_torch.ops import dynhuff as td

    table = np.asarray(jnp.exp2(jnp.arange(16, dtype=jnp.float32))).copy()
    monkeypatch.setattr(td, "EXP2_LEN", torch.from_numpy(table))


@pytest.mark.parametrize("n", [65_536, 40_000])
def test_gzip_streams_equal_jax(kernel_engine, n):
    data = _BASH[300_000 : 300_000 + n]
    got = zt.compress_parallel(data, 6, window_bits=31, device="cpu")
    assert got == jp.compress_parallel(data, 6, window_bits=31)
    assert zlib.decompress(got, 31) == data
