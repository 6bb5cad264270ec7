"""The port's gzip file API (zlib_rs_tpu_torch.models.gzfile: GzFile,
gzopen, gzdopen, gzclose_r, gzclose_w) against the JAX package's, on the
same calls, byte for byte: the files each writes and what each reads back.
The reference's native route is kept off: ZRS_NATIVE_STREAM=0 for its
writer, and for its reader (which does not read that variable) its
`faststream.eligible` patched to refuse, so both run their exact host
engines."""

import gzip
import io
import os

import numpy as np
import pytest
import torch

import native_build  # noqa: F401  (the JAX package's native library, built once under a lock)

import zlib_rs_tpu.config as jc
import zlib_rs_tpu.models.faststream as JF
import zlib_rs_tpu.models.gzfile as JG
from zlib_rs_tpu_torch import config as tc
from zlib_rs_tpu_torch.models import gzfile as TG

# the test workers share the cores, and an oversubscribed OpenMP pool spin-waits
torch.set_num_threads(1)

_BASH = open("/bin/bash", "rb").read()
_rng = np.random.default_rng(17)
DATA = _BASH[500_000:512_000] + _rng.integers(0, 256, 2000, dtype=np.uint8).tobytes()


@pytest.fixture(autouse=True)
def _exact_engines(monkeypatch):
    monkeypatch.setenv("ZRS_NATIVE_STREAM", "0")
    monkeypatch.setattr(JF, "eligible", lambda cfg: False)


def _both(fn):
    """fn(G, C) on the port's module and config, then the JAX package's."""
    return fn(TG, tc), fn(JG, jc)


@pytest.mark.parametrize("mode", ["wb", "wb1", "wb9", "wbf", "wbh", "wbR", "wbF", "wbT"])
def test_write_equal_jax(mode):
    def write(G, C):
        bio = io.BytesIO()
        f = G.GzFile(fileobj=bio, mode=mode)
        n = f.write(DATA[:5000])
        f.printf("n=%d s=%s ", 42, "str")
        f.putc(ord("!"))
        f.puts("line\n")
        f.flush()
        f.write(DATA[5000:])
        f.close()
        return n, bio.getvalue()

    got, want = _both(write)
    assert got == want
    if mode != "wbT":
        assert gzip.decompress(got[1]) == DATA[:5000] + b"n=42 s=str !line\n" + DATA[5000:]


def test_set_params_seek_and_fwrite_equal_jax():
    def write(G, C):
        bio = io.BytesIO()
        f = G.GzFile(fileobj=bio, mode="wb1")
        f.write(DATA[:4000])
        f.set_params(9, C.Strategy.Default)
        f.write(DATA[4000:8000])
        f.seek(9000)  # pads with zeros
        items = f.fwrite(DATA[8000:], 7, 1000)
        f.close()
        return items, bio.getvalue()

    got, want = _both(write)
    assert got == want


@pytest.mark.parametrize("buffer_size", [16, 4096, TG.GZBUFSIZE])
def test_read_equal_jax(buffer_size):
    """A stdlib member, then two of ours, read in pieces, with gets,
    getc/ungetc, seek and tell, rewind and eof."""
    lines = b"first line\nsecond line\n" * 40
    blob = gzip.compress(lines, mtime=0) + gzip.compress(DATA, 6, mtime=0)

    def read(G, C):
        f = G.GzFile(fileobj=io.BytesIO(blob), mode="rb", buffer_size=buffer_size)
        out = [f.gets(), f.getc()]
        out.append(f.ungetc(out[-1]))
        out += [f.read(97), f.tell()]
        f.seek(2000)
        out += [f.read(500), f.tell()]
        f.seek(100)  # backward: rewind and skip
        out += [f.read(10)]
        f.seek(25, io.SEEK_CUR)
        out += [f.read(5), f.direct()]
        f.rewind()
        out += [f.read(), f.eof(), f.tell(), f.getc()]
        f.close()
        return out

    got, want = _both(read)
    assert got == want and got[-4] == lines + DATA


def test_transparent_and_corrupt_read_equal_jax():
    bad = b"\x1f\x8b\x08\x00" + b"\xff" * 40

    def read(G, C):
        out = []
        f = G.GzFile(fileobj=io.BytesIO(b"plain bytes, not gzip"), mode="rb")
        out += [f.read(), f.direct()]
        f = G.GzFile(fileobj=io.BytesIO(bad), mode="rb")
        with pytest.raises(G.GzError) as e:
            f.read()
        out += [e.value.return_code.name, str(e.value), f.error()[0].name]
        f.clear_error()
        out.append(f.error()[0].name)
        with pytest.raises(G.GzError):
            G.GzFile(fileobj=io.BytesIO(), mode="rb+")
        return out

    got, want = _both(read)
    assert got == want


def test_gzopen_gzdopen_and_close_equal_jax(tmp_path):
    def files(G, C):
        tag = G.__name__.split(".")[0]
        p = tmp_path / f"{tag}.gz"
        with G.gzopen(p, "wb6") as f:
            f.write(DATA)
        with G.gzopen(p, "ab") as f:
            f.write(b"appended member")
        fd = os.open(p, os.O_RDONLY)
        f = G.gzdopen(fd, "rb")
        back = f.read()
        rcs = [G.gzclose_w(f).name, G.gzclose_r(f).name]
        w = G.gzopen(tmp_path / f"{tag}-2.gz", "wb")
        rcs += [G.gzclose_r(w).name, G.gzclose_w(w).name]
        return p.read_bytes(), back, rcs

    got, want = _both(files)
    assert got == want and got[1] == DATA + b"appended member"
