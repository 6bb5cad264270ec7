"""pigz-style command line interface of the port.

The counterpart of zlib_rs_tpu/cli.py, with the same flags: gzip-compatible
compress and decompress with level, format and keep flags, stdin/stdout
streaming, and the chunk-parallel encode on the CUDA card for large inputs
(--engine cuda; `tpu` is accepted as its synonym, so that scripts written
for the reference still run).

Usage:
  python -m zlib_rs_tpu_torch [-c] [-d] [-k] [-f] [-1..-9] [--format gzip|zlib|raw]
                              [--engine auto|host|cuda] [--chunk BYTES]
                              [--device cuda|cpu] [FILE ...]

The port does not carry the reference's C++ native engine: a compress
with --engine native, --quick or --medium exits with status 1, and
--engine auto picks as the reference does without it, the card from
TPU_THRESHOLD input bytes up and the host engine below (a lower
threshold than the reference's, measured for the port). Decompression
picks the same way: the card's engine decodes a gzip, zlib or raw stream
of the given format (`parallel.inflate.decompress_foreign`: gzip members
or zran regions, indexed on the card, on K6, each checked against its
container checksum), and
the host engine runs the host inflater, every member of a gzip stream
(the reference decodes only the first without its native engine), and
takes the streams the card's engine does not (a zlib preset dictionary,
or a stream of another format than --format names). --device cpu runs
the card's path through the kernels' plain PyTorch versions; without it,
--engine cuda with no GPU fails.
"""

from __future__ import annotations

import argparse
import os
import sys

from .config import InflateConfig, InflateFlush, ReturnCode

# auto engine: the card from this many input bytes. cli_crossover.py times
# one process of each engine: on an H100 the card's compress wall is under
# the host engine's from 64 KiB (its smallest size) up, and its decompress
# wall within 0.4 s of the host inflater's from 52 KB of gzip input and
# under it from 97 KB. The reference's 4 MiB is where its TPU beats its
# C++ engine.
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
                   help="the native engine's QUICK mode (not carried: exits 1)")
    p.add_argument("--medium", action="store_true",
                   help="the native engine's MEDIUM mode (not carried: exits 1)")
    p.add_argument(
        "--format", choices=("gzip", "zlib", "raw"), default="gzip",
        help="container format (default gzip)",
    )
    p.add_argument(
        "--engine", choices=("auto", "host", "native", "cuda", "tpu"), default="auto",
        help="pure-Python host engine or the CUDA device engine (tpu: the same "
             "as cuda; native is not carried)",
    )
    p.add_argument("-p", "--threads", type=int, default=0,
                   help="native engine worker threads (not carried; ignored)")
    p.add_argument(
        "--chunk", type=int, default=None,
        help="chunk size (default: the active engine's own default)",
    )
    p.add_argument("--device", default=None,
                   help="torch device of the cuda engine (default: the GPU; cpu runs "
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
    is "cuda", and "auto" is the reference's choice without its native
    engine."""
    if engine == "tpu":
        return "cuda"
    if engine == "auto":
        return "cuda" if n >= TPU_THRESHOLD else "host"
    return engine


def _needs_native(args) -> None:
    for flag, used in (("--quick", args.quick), ("--medium", args.medium),
                       ("--engine native", args.engine == "native")):
        if used:
            raise SystemExit(f"{flag} needs the native engine")


def _compress(data: bytes, args) -> bytes:
    _needs_native(args)
    level = args.level if args.level is not None else 6
    wbits = _wbits_for(args.format, False)
    if _choose_engine(args.engine, len(data)) == "cuda":
        from .parallel.pipeline import compress_parallel

        return compress_parallel(
            data, level=level, window_bits=wbits, chunk_size=args.chunk,
            device=args.device,
        )
    from .models import oneshot

    return oneshot.compress(data, level=level, window_bits=wbits)


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
    """Whether the card's engine decodes `data`: the cuda engine chosen,
    and a stream of a kind --format names, without a preset dictionary."""
    if _choose_engine(args.engine, len(data)) != "cuda":
        return False
    from .models import zran

    _hdr, kind = zran._wrapper_span(data)
    return kind in _KINDS[args.format] and not (kind == "zlib" and data[1] & 0x20)


def _decompress(data: bytes, args) -> bytes:
    if _on_card(data, args):
        from .parallel.inflate import decompress_foreign

        return decompress_foreign(data, device=args.device)
    wbits = _wbits_for(args.format, True)
    if args.format != "gzip" or data[:2] != b"\x1f\x8b":
        from .models import oneshot

        return oneshot.decompress(data, window_bits=wbits)
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
