"""zlib_rs_tpu_torch: chunk-parallel DEFLATE encode and decode on a CUDA device.

The PyTorch and CUDA port of zlib_rs_tpu's kernel encode engine and its
two-plane vector decode engine. It imports neither JAX nor zlib_rs_tpu.
Entry points run on `cuda` unless the caller passes `device="cpu"`, which
runs every kernel's plain PyTorch version instead.
"""

from .ops.checksum import adler32_batch
from .parallel.pipeline import (
    ChunkIndex,
    compress_parallel,
    decompress_parallel,
    fallback_stats,
)

__all__ = [
    "compress_parallel", "decompress_parallel", "adler32_batch", "ChunkIndex",
    "fallback_stats",
]
