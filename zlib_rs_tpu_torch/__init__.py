"""zlib_rs_tpu_torch: chunk-parallel DEFLATE encode and decode on a CUDA device.

The PyTorch and CUDA port of zlib_rs_tpu's two encode engines (the
kernel engine under ZRS_TPU_KERNEL=1, and the XLA engine, the default,
in torch ops), its vector decode engine (two-plane, and single-plane under
ZRS_VECTOR_TWOPLANE=0), its sequential inflate kernel (the decode of
indexes with stored chunks or without seeds, the region decode and the
checkpointed stream decode), its seeded swarm decode engine (its walkers
a CUDA kernel; the only device engine after the vector engine under
ZRS_TPU_KERNEL=0), its lockstep region engine (a CUDA kernel, behind K6) and
`decompress_foreign`, the region-parallel decode of streams another
encoder wrote (a zran index pass through the speculative decode of
parallel/speculative.py, its kernels SP1-SP3, then K6). A non-default strategy
runs the host deflate engine, as in the reference. It imports neither JAX nor
zlib_rs_tpu. Entry points run on `cuda` unless the caller passes
`device="cpu"`, which runs every kernel's plain PyTorch version instead.

The host API layers are the reference's: the one-shot API (`compress`,
`decompress`, `compress_bound`, `uncompress`), the `Deflate`/`Inflate`
stream objects and the gzip file API (`GzFile`, `gzopen`, `gzdopen`,
`gzclose_r`, `gzclose_w`), whose raw bodies run on the card's resumable
handles IS and DS (models/faststream.py), inflateBack, zran
`build_index`/`extract`, `compress_medium`, the compat helpers and the
checksums with their combine operators; they load on first use. `native`
is the reference's native engine on the card (native.py: EX, SP1-SP3,
K6, IS and DS). `python -m zlib_rs_tpu_torch` is the pigz-style
command line (cli.py); `python -m zlib_rs_tpu_torch.bench` the benchmark.
"""

from .config import (  # noqa: F401
    CONFIGURATION_TABLE,
    DeflateConfig,
    DeflateFlush,
    GzHeader,
    InflateConfig,
    InflateFlush,
    Method,
    ReturnCode,
    Strategy,
    Wrap,
    Z_DEFAULT_COMPRESSION,
)
from .ops.checksum import (  # noqa: F401
    adler32,
    adler32_batch,
    adler32_combine,
    crc32,
    crc32_combine,
    crc32_combine_gen,
    crc32_combine_op,
)
from .parallel.checkpoint import DeviceInflateState
from .parallel.checkpoint import decode_step as device_decode_step
from .parallel.checkpoint import decode_streaming as device_decode_streaming
from .parallel.inflate import decompress_foreign
from .parallel.pipeline import (
    ChunkIndex,
    compress_parallel,
    decompress_parallel,
    fallback_stats,
)

__all__ = [
    "compress_parallel", "decompress_parallel", "adler32_batch", "ChunkIndex",
    "fallback_stats", "DeviceInflateState", "device_decode_step",
    "device_decode_streaming", "decompress_foreign",
]

__version__ = "0.1.0"
ZLIB_VERSION = "1.3.0-zlib-rs-tpu-torch-" + __version__


def zlib_version() -> str:
    """Version string, zlib-style."""
    return ZLIB_VERSION


# the lazy host layers: {name: (module under the package, attribute)}
_LAZY = {
    **{n: ("models.oneshot", n) for n in ("compress", "decompress", "compress_bound",
                                          "uncompress")},
    **{n: ("models.stream", n) for n in ("Deflate", "Inflate")},
    **{n: ("models.gzfile", n) for n in ("GzFile", "gzopen", "gzdopen", "gzclose_r",
                                         "gzclose_w")},
    **{n: ("models.infback", n) for n in ("InflateBack", "inflate_back")},
    **{n: ("models.zran", n) for n in ("build_index", "extract")},
    "compress_medium": ("models.medium", "compress_medium"),
    **{n: ("compat", n) for n in ("z_error", "zError", "get_crc_table", "zlib_compile_flags",
                                  "zlibCompileFlags")},
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod, attr = _LAZY[name]
        return getattr(importlib.import_module(f".{mod}", __name__), attr)
    if name == "native":
        import importlib

        return importlib.import_module(".native", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
