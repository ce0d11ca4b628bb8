"""Build and load the CUDA kernels: nvcc -> shared library -> ctypes.

The sources under `csrc/` have a plain C interface (no PyTorch headers), so a
build takes seconds.  It happens at first use, into `_build/` inside the
package (git-ignored), and the library's name carries a hash of the sources so
a stale build is never loaded.  Nothing is built or looked up at import time.
The compiler's report (`-Xptxas -v`: registers, shared memory and spills of
every kernel) is kept beside the library (`build_log`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()  # guards the two dicts, never held during a build
_libs: dict = {}
_source_locks: dict = {}


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and under CUDA_HOME): the CUDA "
        "kernels cannot be built on this machine"
    )


def _library_path(source: str, deps=()) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in (source, *deps):
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(f.read())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{h.hexdigest()[:12]}.so")


def build_log(source: str, deps=()) -> str:
    """The compiler's report of the build of csrc/<source> (after `build`)."""
    with open(_library_path(source, deps)[:-3] + ".log") as f:
        return f.read()


def build(source: str, deps=()) -> str:
    """Compile csrc/<source> (+ headers `deps`, hashed only) into a shared
    library and return its path.  Raises with the compiler's output on
    failure."""
    out = _library_path(source, deps)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-I", CSRC_DIR, "-o", tmp,
           os.path.join(CSRC_DIR, source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    with open(out[:-3] + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def load(source: str, deps=()) -> ctypes.CDLL:
    """The built library for csrc/<source>, loaded once per process.  Builds
    of different sources may run side by side (one lock per source)."""
    with _lock:
        source_lock = _source_locks.setdefault(source, threading.Lock())
    with source_lock:
        lib = _libs.get(source)
        if lib is None:
            lib = _libs[source] = ctypes.CDLL(build(source, deps))
        return lib
