"""The port's top-level names, version names, compat helpers
(zlib_rs_tpu_torch.compat) and checksum combine operators
(ops/gf2.crc32_combine_gen, crc32_combine_op) against the JAX package's:
every name of zlib_rs_tpu's package, read from its __init__.py, is found
on the port, `native` included (the port's facade over its kernels)."""

import ast
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import zlib_rs_tpu as J
import zlib_rs_tpu.compat as JC
import zlib_rs_tpu.ops.gf2 as JG
import zlib_rs_tpu_torch as T
from zlib_rs_tpu_torch import compat as TC
from zlib_rs_tpu_torch.ops import gf2 as TG

# the test workers share the cores, and an oversubscribed OpenMP pool spin-waits
torch.set_num_threads(1)


def reference_names() -> list[str]:
    """The top-level names of zlib_rs_tpu: its imports and definitions,
    and every name its __getattr__ compares against."""
    tree = ast.parse(Path(J.__file__).read_text())
    names = []
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names += [a.asname or a.name for a in node.names]
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, ast.FunctionDef) and node.name != "__getattr__":
            names.append(node.name)
        elif isinstance(node, ast.FunctionDef):
            for sub in ast.walk(node):
                if isinstance(sub, ast.Compare) and isinstance(sub.left, ast.Name):
                    for c in sub.comparators:
                        elts = c.elts if isinstance(c, ast.Tuple) else [c]
                        names += [e.value for e in elts if isinstance(e, ast.Constant)]
    return names


def test_every_reference_name_but_native():
    """Every reference name, `native` included since the port carries the
    native engine on the card: `T.native` is the port's facade."""
    names = reference_names()
    # 48 names beside __getattr__ itself
    assert len(names) == len(set(names)) == 48
    missing = [n for n in names if not hasattr(T, n)]
    assert missing == []
    import zlib_rs_tpu_torch.native as facade

    assert T.native is facade and T.native.RawInflateStream.__module__ == "zlib_rs_tpu_torch.native"
    with pytest.raises(AttributeError, match="no attribute 'nothing'"):
        T.nothing


def test_version_names():
    assert T.__version__ == J.__version__
    assert T.ZLIB_VERSION.split("-")[0] == J.ZLIB_VERSION.split("-")[0] == "1.3.0"
    assert T.zlib_version() == T.ZLIB_VERSION


def test_compat_equal_jax():
    for code in range(-7, 4):
        assert TC.z_error(code) == JC.z_error(code) == TC.zError(code)
    assert TC.z_error(99) == JC.z_error(99) == ""
    assert TC.get_crc_table() == JC.get_crc_table() == T.get_crc_table()
    assert TC.zlib_compile_flags() == JC.zlib_compile_flags() == T.zlibCompileFlags()
    data = open("/bin/bash", "rb").read()[:20_000]
    assert TC.adler32_z(data) == JC.adler32_z(data) == zlib.adler32(data)
    assert TC.crc32_z(data, 7) == JC.crc32_z(data, 7) == zlib.crc32(data, 7)


@pytest.mark.parametrize("len2", [0, 1, 3, 8, 1000, 65536, 123_457, 1 << 31])
def test_crc32_combine_gen_equal_jax(len2):
    got = TG.crc32_combine_gen(len2)
    assert got.dtype == np.uint32 and np.array_equal(got, JG.crc32_combine_gen(len2))
    rng = np.random.default_rng(len2 % 1000)
    for c1, c2 in rng.integers(0, 1 << 32, (4, 2), dtype=np.uint64).tolist():
        want = JG.crc32_combine_op(c1, c2, got)
        assert T.crc32_combine_op(c1, c2, got) == want
        if len2:
            assert T.crc32_combine(c1, c2, len2) == want


def test_combines_equal_zlib():
    data = open("/bin/bash", "rb").read()[:50_000]
    for cut in (0, 1, 17_000, 50_000):
        a, b = data[:cut], data[cut:]
        op = T.crc32_combine_gen(len(b))
        assert T.crc32_combine_op(zlib.crc32(a), zlib.crc32(b), op) == zlib.crc32(data)
        assert T.adler32_combine(zlib.adler32(a), zlib.adler32(b), len(b)) == zlib.adler32(data)
    assert T.adler32(data) == J.adler32(data) and T.crc32(data) == J.crc32(data)
