"""One-shot convenience API: compress, compress_bound, decompress and
uncompress over the host engines (models/deflate.py, models/inflate.py).

A copy of zlib_rs_tpu/models/oneshot.py without its C++ fast paths
(`_try_native_compress`, `_try_native_decompress`): the port does not
carry the native engine, so every call takes the path the reference takes
when `native.available()` is false.
"""

from __future__ import annotations

from ..config import (
    DeflateConfig,
    InflateConfig,
    InflateFlush,
    ReturnCode,
    Strategy,
    Z_DEFAULT_COMPRESSION,
)
from . import deflate as _deflate
from . import inflate as _inflate


def _deflate_config(config, level, window_bits, strategy) -> DeflateConfig:
    if config is not None:
        return config
    return DeflateConfig(
        level=level if level is not None else Z_DEFAULT_COMPRESSION,
        window_bits=window_bits,
        strategy=strategy,
    )


def compress(
    data: bytes,
    level: int | None = None,
    *,
    window_bits: int = 15,
    strategy: Strategy = Strategy.Default,
    config: DeflateConfig | None = None,
) -> bytes:
    """One-shot compress. Default output is a zlib stream (window_bits=15);
    use window_bits=31 for gzip, negative for raw deflate."""
    return _deflate.compress(data, _deflate_config(config, level, window_bits, strategy))


def compress_bound(
    source_len: int,
    level: int | None = None,
    *,
    window_bits: int = 15,
    strategy: Strategy = Strategy.Default,
    config: DeflateConfig | None = None,
) -> int:
    """Worst-case compressed size (zlib's deflateBound)."""
    return _deflate.compress_bound(
        source_len, _deflate_config(config, level, window_bits, strategy)
    )


def decompress(
    data: bytes,
    *,
    window_bits: int = 47,  # auto-detect zlib/gzip by default
    config: InflateConfig | None = None,
) -> bytes:
    """One-shot decompress with zlib/gzip auto-detection by default; the
    first gzip member only, as zlib's inflate."""
    cfg = config if config is not None else InflateConfig(window_bits=window_bits)
    return _inflate.decompress(data, cfg)


def uncompress(data: bytes, *, window_bits: int = 15) -> tuple[ReturnCode, bytes]:
    """zlib-style uncompress: returns (ReturnCode, output) instead of raising."""
    inf = _inflate.Inflator(InflateConfig(window_bits=window_bits))
    ret, _consumed, out = inf.inflate(data, None, InflateFlush.FINISH)
    if ret == ReturnCode.StreamEnd:
        return ReturnCode.Ok, out
    if ret == ReturnCode.Ok:
        return ReturnCode.DataError, out  # truncated input
    return ret, out
