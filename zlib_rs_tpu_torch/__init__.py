"""zlib_rs_tpu_torch: the chunk-parallel DEFLATE encoder on a CUDA device.

The PyTorch and CUDA port of zlib_rs_tpu's kernel encode engine. It
imports neither JAX nor zlib_rs_tpu. Entry points run on `cuda` unless
the caller passes `device="cpu"`, which runs every kernel's plain PyTorch
version instead.
"""

from .ops.checksum import adler32_batch
from .parallel.pipeline import ChunkIndex, compress_parallel, fallback_stats

__all__ = ["compress_parallel", "adler32_batch", "ChunkIndex", "fallback_stats"]
