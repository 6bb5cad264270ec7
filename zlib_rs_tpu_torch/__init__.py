"""zlib_rs_tpu_torch: chunk-parallel DEFLATE encode and decode on a CUDA device.

The PyTorch and CUDA port of zlib_rs_tpu's two encode engines (the
kernel engine under ZRS_TPU_KERNEL=1, and the XLA engine, the default,
in torch ops), its vector decode engine (two-plane, and single-plane under
ZRS_VECTOR_TWOPLANE=0), its sequential inflate kernel (the decode of
indexes with stored chunks or without seeds, the region decode and the
checkpointed stream decode), its seeded swarm decode engine (in torch
ops; the only device engine after the vector engine under
ZRS_TPU_KERNEL=0), its lockstep region engine (torch ops, behind K6) and
`decompress_foreign`, the region-parallel decode of streams another
encoder wrote (a host zran index pass, then K6). A non-default strategy
runs the host deflate engine, as in the reference. It imports neither JAX nor
zlib_rs_tpu. Entry points run on `cuda` unless the caller passes
`device="cpu"`, which runs every kernel's plain PyTorch version instead.

The one-shot host API (`compress`, `decompress`, `compress_bound`,
`uncompress`) loads on first use. `python -m zlib_rs_tpu_torch` is the
pigz-style command line (cli.py); `python -m zlib_rs_tpu_torch.bench` the
benchmark.
"""

from .ops.checksum import adler32_batch
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


def __getattr__(name):
    if name in ("compress", "decompress", "compress_bound", "uncompress"):
        from .models import oneshot

        return getattr(oneshot, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
