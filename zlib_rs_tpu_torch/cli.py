"""pigz-style command line interface of the port.

The counterpart of zlib_rs_tpu/cli.py, with the same flags: gzip-compatible
compress and decompress with level, format and keep flags, stdin/stdout
streaming, and two engines on the CUDA card: the chunk-parallel encode of
`compress_parallel` (--engine cuda; `tpu` is accepted as its synonym, so
that scripts written for the reference still run) and the port of the
reference's C++ native engine (--engine native, --quick, --medium).

Usage:
  python -m zlib_rs_tpu_torch [-c] [-d] [-k] [-f] [-1..-9] [--format gzip|zlib|raw]
                              [--engine auto|host|native|cuda] [--quick] [--medium]
                              [--chunk BYTES] [--device cuda|cpu] [FILE ...]

Compress. --engine native runs `parallel/chunk_deflate.deflate_parallel`
(EX on the card, zlib's bytes chunk by chunk, 128 KiB chunks primed with
32 KiB) at the level; --quick and --medium run it in the native engine's
QUICK and MEDIUM modes (--medium honours levels 4-6), each wrapped in
the reference's zlib or gzip container. --engine auto takes the native
route from TPU_THRESHOLD input bytes up, as the reference takes its
native engine whenever it is built, and the host engine below it (the
native route's compress crossover, measured for the port by
cli_crossover.py).
--engine cuda runs `compress_parallel`. The host engine is the one-shot
`compress` with device="cpu".

Decompress. -d under --engine native, and under auto from TPU_THRESHOLD,
runs the reference's native decode: the container parsed on the host,
gzip members in turn (trailing garbage ignored), each raw body decoded on
the card by `inflate_speculative` and checked against its trailer
(`models/oneshot.card_member`, shared with the one-shot decode); under
auto a fault of the stream falls to the host engine, as in the
reference. -d
--engine cuda runs `parallel.inflate.decompress_foreign` (gzip members or
zran regions, indexed on the card, on K6) for the stream kinds --format
names. The host engine runs the host inflater, every member of a gzip
stream. --device cpu runs the card's routes through the kernels' plain
PyTorch versions; without it, a card route with no GPU fails. --threads
is accepted and ignored.
"""

from __future__ import annotations

import argparse
import os
import sys

from .config import InflateConfig, InflateFlush, ReturnCode

# auto engine: the native route from this many input bytes. cli_crossover.py
# times one process of each engine on an H100: the native route's compress
# wall is under the host engine's from 64 KiB up (over it at 4-32 KiB), its
# decompress wall from 239,891 gzip bytes up and within 1.1 s of the host
# inflater's below (a process wall's spread between runs). The reference's
# 4 MiB is where its TPU beats its C++ engine.
TPU_THRESHOLD = 64 * 1024


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="zlib_rs_tpu_torch", description="CUDA gzip/zlib (de)compressor"
    )
    p.add_argument("files", nargs="*", help="files to process ('-' or none = stdin)")
    p.add_argument("-c", "--stdout", action="store_true", help="write to stdout")
    p.add_argument("-d", "--decompress", action="store_true")
    p.add_argument("-k", "--keep", action="store_true", help="keep input files")
    p.add_argument("-f", "--force", action="store_true", help="overwrite outputs")
    for lvl in range(1, 10):
        p.add_argument(
            f"-{lvl}", dest="level", action="store_const", const=lvl,
            help=argparse.SUPPRESS,
        )
    p.add_argument("--level", type=int, default=None, help="compression level 0-9")
    p.add_argument("--quick", action="store_true",
                   help="the native engine's QUICK mode on the card: adaptive trees, a "
                        "single hash probe (valid DEFLATE, a worse ratio)")
    p.add_argument("--medium", action="store_true",
                   help="the native engine's MEDIUM mode on the card (zlib-ng's "
                        "deflate_medium class); honours --level 4-6")
    p.add_argument(
        "--format", choices=("gzip", "zlib", "raw"), default="gzip",
        help="container format (default gzip)",
    )
    p.add_argument(
        "--engine", choices=("auto", "host", "native", "cuda", "tpu"), default="auto",
        help="pure-Python host engine, the native engine's port on the card "
             "(zlib's bytes, chunk-parallel), or compress_parallel's CUDA engine "
             "(tpu: the same as cuda)",
    )
    p.add_argument("-p", "--threads", type=int, default=0,
                   help="the reference's native worker threads (ignored: one warp a chunk)")
    p.add_argument(
        "--chunk", type=int, default=None,
        help="chunk size (default: the active engine's own default)",
    )
    p.add_argument("--device", default=None,
                   help="torch device of the card's engines (default: the GPU; cpu runs "
                        "the plain PyTorch versions)")
    p.add_argument("--suffix", default=".gz", help="output suffix (default .gz)")
    return p


def _wbits_for(fmt: str, decompress: bool) -> int:
    if fmt == "raw":
        return -15
    if fmt == "zlib":
        return 15
    return 47 if decompress else 31  # gzip; +32 auto-detect on decode


def _choose_engine(engine: str, n: int) -> str:
    """The engine that compresses or decompresses `n` input bytes: "tpu"
    is "cuda", and "auto" is the native engine's port from TPU_THRESHOLD
    up (the reference's choice with its native engine built), the host
    below."""
    if engine == "tpu":
        return "cuda"
    if engine == "auto":
        return "native" if n >= TPU_THRESHOLD else "host"
    return engine


def _compress(data: bytes, args) -> bytes:
    level = args.level if args.level is not None else 6
    chunk = args.chunk or 128 * 1024
    wbits = _wbits_for(args.format, False)
    if args.quick or args.medium:
        from .models.oneshot import wrap_raw
        from .parallel import chunk_deflate as CD

        if args.quick:
            raw = CD.deflate_parallel(data, level=CD.QUICK, chunk_size=chunk, device=args.device)
            return wrap_raw(raw, data, wbits, 1)
        mlvl = CD.MEDIUM_BASE + min(max(level, 4), 6) - 4
        raw = CD.deflate_parallel(data, level=mlvl, chunk_size=chunk, device=args.device)
        return wrap_raw(raw, data, wbits, level)
    engine = _choose_engine(args.engine, len(data))
    if engine == "cuda":
        from .parallel.pipeline import compress_parallel

        return compress_parallel(
            data, level=level, window_bits=wbits, chunk_size=args.chunk,
            device=args.device,
        )
    if engine == "native":
        from .models.oneshot import wrap_raw
        from .parallel import chunk_deflate as CD

        raw = CD.deflate_parallel(data, level=level, chunk_size=chunk, device=args.device)
        return wrap_raw(raw, data, wbits, level)
    from .models import oneshot

    return oneshot.compress(data, level=level, window_bits=wbits, device="cpu")


def _inflate_member(data: bytes, window_bits: int) -> tuple[bytes, int]:
    """One zlib, gzip or raw stream from the start of `data` on the host
    inflater: (output, bytes consumed, its trailer included)."""
    from .models import inflate

    inf = inflate.Inflator(InflateConfig(window_bits=window_bits))
    ret, consumed, out = inf.inflate(data, None, InflateFlush.FINISH)
    if ret == ReturnCode.NeedDict:
        raise inflate.NeedDictError(inf.dict_id)
    if ret != ReturnCode.StreamEnd:
        raise inflate.DataError(inf.msg or "truncated or corrupt stream")
    return out, consumed


# the stream kinds each --format decodes (gzip's decode sniffs zlib too)
_KINDS = {"gzip": ("gzip", "zlib"), "zlib": ("zlib",), "raw": ("raw",)}


def _on_card(data: bytes, args) -> bool:
    """Whether the cuda engine's foreign decode takes `data`: the cuda
    engine chosen, and a stream of a kind --format names, without a
    preset dictionary."""
    if _choose_engine(args.engine, len(data)) != "cuda":
        return False
    from .models import zran

    _hdr, kind = zran._wrapper_span(data)
    return kind in _KINDS[args.format] and not (kind == "zlib" and data[1] & 0x20)


def _native_decompress(data: bytes, fmt: str, device) -> bytes:
    """The reference's native decode: the container parsed on the host,
    each raw body inflated on the card, multi-member aware."""
    from .models.oneshot import card_inflate, card_member

    if fmt == "raw":
        return card_inflate(data, device)[0]
    out, pos = bytearray(), 0
    while pos < len(data):
        dec, pos = card_member(data, pos, device, zlib=pos == 0)
        out.extend(dec)
        if data[:2] != b"\x1f\x8b" or data[pos : pos + 2] != b"\x1f\x8b":
            break  # one zlib stream; after gzip, trailing garbage is ignored, gzio-style
    return bytes(out)


def _decompress(data: bytes, args) -> bytes:
    engine = _choose_engine(args.engine, len(data))
    if engine == "native":
        from .models.oneshot import is_data_fault

        try:
            return _native_decompress(data, args.format, args.device)
        except ValueError as e:
            if args.engine == "native" or not is_data_fault(e):
                raise
    if _on_card(data, args):
        from .parallel.inflate import decompress_foreign

        return decompress_foreign(data, device=args.device)
    wbits = _wbits_for(args.format, True)
    if args.format != "gzip" or data[:2] != b"\x1f\x8b":
        from .models import inflate

        return inflate.decompress(data, InflateConfig(window_bits=wbits))
    # gzip: every member, as gzip -d; trailing garbage is ignored, gzio-style
    out = bytearray()
    pos = 0
    while pos < len(data) and data[pos : pos + 2] == b"\x1f\x8b":
        part, used = _inflate_member(data[pos:], wbits)
        out.extend(part)
        pos += used
    return bytes(out)


def _out_name(path: str, args) -> str:
    if args.decompress:
        if path.endswith(args.suffix):
            return path[: -len(args.suffix)]
        return path + ".out"
    return path + args.suffix


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    files = args.files or ["-"]
    status = 0
    for path in files:
        try:
            if path == "-":
                data = sys.stdin.buffer.read()
            else:
                with open(path, "rb") as f:
                    data = f.read()
            out = _decompress(data, args) if args.decompress else _compress(data, args)
            if path == "-" or args.stdout:
                sys.stdout.buffer.write(out)
                sys.stdout.buffer.flush()
            else:
                dest = _out_name(path, args)
                if os.path.exists(dest) and not args.force:
                    print(f"{dest}: already exists (use -f)", file=sys.stderr)
                    status = 1
                    continue
                with open(dest, "wb") as f:
                    f.write(out)
                if not args.keep:
                    os.unlink(path)
        except Exception as e:  # deliberate CLI-boundary catch
            print(f"zlib_rs_tpu_torch: {path}: {e}", file=sys.stderr)
            status = 1
    return status


if __name__ == "__main__":
    sys.exit(main())
