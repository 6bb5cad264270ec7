"""Build the JAX package's native library once, under a lock.

`zlib_rs_tpu.native` builds `native/libzrs_native.so` on first use when it is
missing or older than its source, in place and with no lock. Test workers that
start together then race: one loads a file that another's linker is still
writing, fails, and keeps its pure-Python fallback for the rest of its life,
so every test that holds the port against the native engine fails there.

`ensure()` builds the file with the command the JAX package uses, into a
temporary file under `build/` that is then `os.replace`d into place, inside an
`fcntl` lock, and checks that it loads. If the JAX module had already tried and
failed in this process, its cached failure is cleared so that its next use
loads the good file. The port's test files that compare against the native
engine call it at import.
"""

import ctypes
import fcntl
import os
import subprocess

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "native", "zrs_native.cpp")
SO = os.path.join(ROOT, "native", "libzrs_native.so")
LOCK = os.path.join(ROOT, "build", "libzrs_native.lock")
TIMEOUT_S = 900


def _fresh() -> bool:
    if not os.path.exists(SO) or os.path.getmtime(SO) < os.path.getmtime(SRC):
        return False
    try:
        ctypes.CDLL(SO)
    except OSError:
        return False
    return True


def _build() -> None:
    tmp = os.path.join(os.path.dirname(LOCK), f"libzrs_native.{os.getpid()}.so")
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
             "-o", tmp, SRC],
            check=True, capture_output=True, timeout=TIMEOUT_S,
        )
        os.replace(tmp, SO)
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"building {SO} failed:\n{e.stderr.decode(errors='replace')}")
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def ensure() -> None:
    os.makedirs(os.path.dirname(LOCK), exist_ok=True)
    with open(LOCK, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not _fresh():
                _build()
                if not _fresh():
                    raise RuntimeError(f"{SO} was built but does not load")
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    from zlib_rs_tpu import native

    if native._tried and native._lib is None:
        native._tried = False
    if not native.available():
        raise RuntimeError("zlib_rs_tpu.native does not load its library")


ensure()
