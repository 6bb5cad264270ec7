"""Device resolution and the build-and-load of the hand-written CUDA kernels.

Every entry point of the port runs on `cuda` unless the caller passes
`device="cpu"`; there is no silent CPU continuation when no GPU exists.

The kernels live in `csrc/*.cu`, each with a plain C interface. At first
use each source is compiled by `nvcc` for `sm_90a` into its own shared
library under `build/zlib_rs_tpu_torch/` (beside the package, listed in
`.gitignore`) and loaded with `ctypes`. All missing libraries are built
in parallel, one `nvcc` process per source. A library is rebuilt when its
source, or a header of `csrc/` that the source includes, is newer. Every
C entry returns `cudaGetLastError()` after its launch; `check` raises on
anything but 0.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

SOURCES = ("adler32", "pack", "vhuff_decode", "vhuff_expand", "inflate", "crc32", "chain_scan",
           "tab_scan", "freq", "hop_chase_il", "lockstep", "swarm", "speculative", "exact_deflate",
           "istream")

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD = _PKG.parent / "build" / "zlib_rs_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_LIBS: dict[str, ctypes.CDLL] = {}


def resolve_device(device=None) -> torch.device:
    """`None` means the GPU; it raises when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "zlib_rs_tpu_torch runs on a CUDA device and none is "
                "available; pass device='cpu' for the plain PyTorch path"
            )
        return torch.device("cuda")
    return torch.device(device)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def lib_path(name: str) -> Path:
    return BUILD / f"libzrs_{name}.so"


def _sources_of(name: str) -> list:
    """csrc/<name>.cu and the headers of csrc it includes."""
    src = CSRC / f"{name}.cu"
    return [src] + [CSRC / h for h in re.findall(r'^#include "([^"]+)"', src.read_text(), re.M)]


def _stale(name: str) -> bool:
    lib = lib_path(name)
    return not lib.exists() or lib.stat().st_mtime < max(p.stat().st_mtime
                                                          for p in _sources_of(name))


def build(names=SOURCES) -> float:
    """Compile every stale library of `names`, all `nvcc`s at once.
    Returns the wall seconds spent; raises with the compiler's output on
    any failure."""
    todo = [n for n in names if _stale(n)]
    if not todo:
        return 0.0
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for name in todo:
        tmp = BUILD / f"libzrs_{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    errors = []
    for name, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode:
            errors.append(f"{name}.cu (rc={proc.returncode}):\n{out}")
        else:
            os.replace(tmp, lib_path(name))
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`. The first call builds every stale
    library at once, so the main path pays one parallel build."""
    lib = _LIBS.get(name)
    if lib is None:
        build()
        lib = ctypes.CDLL(str(lib_path(name)))
        _LIBS[name] = lib
    return lib


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def check(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {rc}")


def require_cuda(kernel: str, *tensors: torch.Tensor) -> None:
    """A kernel wrapper's guard: every operand on one CUDA device."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise RuntimeError(f"{kernel}: expected CUDA tensors, got {dev}")
    for t in tensors:
        if t.device != dev:
            raise RuntimeError(f"{kernel}: operands on {t.device} and {dev}")
