"""Build and load the native C++ runtime: g++ of `cpp/src` -> shared library.

This package's own build of the unchanged `cpp/` sources (the C++
`hexl-fpga.h` runtime and its 52-bit wire codec), made without cmake: one
compiler process per source, side by side, then one link, with the flags of
`cpp/CMakeLists.txt`.  It goes into `_build/` beside the CUDA kernels
(`_build.py`), under a name that carries a hash of the sources and flags, at
first use.  It never loads `cpp/build/`, the reference's cache.

  build_library    compile (or reuse) the library; returns its path
  codec_library    the library loaded once, its codec bound (`wirepack.py`)
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Optional

from . import _build

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CPP_DIR = os.path.join(_REPO_ROOT, "cpp")
CPP_SOURCES = ("number_theory.cpp", "compute.cpp", "runtime.cpp", "api.cpp",
               "capi.cpp", "stack_trace.cpp")
# cpp/CMakeLists.txt's flags (Release, position-independent, Threads)
CXX_FLAGS = ["-std=c++17", "-O3", "-fPIC", "-pthread"]


def find_cxx() -> str:
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError("g++ not found on PATH: the native runtime cannot "
                           "be built on this machine")
    return path


@functools.lru_cache(maxsize=None)
def cxx_flags(cxx: str) -> tuple:
    """CXX_FLAGS, plus -fopenmp where the compiler takes it (the native
    kernels' intra-op loops, as cmake's optional OpenMP)."""
    with tempfile.TemporaryDirectory() as d:
        src = os.path.join(d, "probe.cpp")
        with open(src, "w") as f:
            f.write("int probe() { int s = 0;\n#pragma omp parallel for reduction(+:s)\n"
                    "for (int i = 0; i < 4; ++i) s += i;\nreturn s; }\n")
        proc = subprocess.run(
            [cxx, *CXX_FLAGS, "-fopenmp", "-shared", src, "-o",
             os.path.join(d, "probe.so")], capture_output=True)
    return tuple(CXX_FLAGS + (["-fopenmp"] if proc.returncode == 0 else []))


def _sources():
    srcs = [os.path.join(CPP_DIR, "src", s) for s in CPP_SOURCES]
    headers = sorted(glob.glob(os.path.join(CPP_DIR, "src", "*.hpp"))
                     + glob.glob(os.path.join(CPP_DIR, "include", "*.h")))
    return srcs, headers


def library_path(cxx: Optional[str] = None) -> str:
    """Where build_library() puts the library for the current sources and
    flags."""
    flags = cxx_flags(cxx or find_cxx())
    h = hashlib.sha256(" ".join(flags).encode())
    srcs, headers = _sources()
    for path in srcs + headers:
        h.update(os.path.relpath(path, CPP_DIR).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(_build.BUILD_DIR, f"libhexl_fpga_tpu_{h.hexdigest()[:12]}.so")


_build_lock = threading.Lock()


def build_library() -> str:
    """Compile cpp/src into a shared library (one compiler process per
    source, side by side, then one link) and return its path; a library
    already built from the same sources and flags is reused.  Written under
    a temporary name, then renamed.  Raises with the compiler's output."""
    with _build_lock:
        cxx = find_cxx()
        out = library_path(cxx)
        if os.path.exists(out):
            return out
        flags = list(cxx_flags(cxx))
        os.makedirs(_build.BUILD_DIR, exist_ok=True)
        srcs, _ = _sources()
        include = os.path.join(CPP_DIR, "include")
        with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
            objs = [os.path.join(tmp, os.path.basename(s)[:-4] + ".o") for s in srcs]
            cmds = [[cxx, *flags, "-I", include, "-c", s, "-o", o]
                    for s, o in zip(srcs, objs)]
            lib = os.path.join(tmp, "lib.so")
            _check_all(cmds)
            _check_all([[cxx, *flags, "-shared", *objs, "-o", lib]])
            os.replace(lib, out)
        return out


def _check_all(cmds) -> None:
    """Run the commands side by side; raise with the output of each that
    failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    failed = [f"{' '.join(c)}\n{p.communicate()[0]}" for c, p in zip(cmds, procs)]
    failed = [f for f, p in zip(failed, procs) if p.returncode != 0]
    if failed:
        raise RuntimeError("C++ build of cpp/src failed:\n" + "\n".join(failed))


@functools.lru_cache(maxsize=None)
def codec_library() -> ctypes.CDLL:
    """The library with its 52-bit wire codec bound (`cpp/src/capi.cpp`
    hexl_tpu_pack52 / hexl_tpu_unpack52)."""
    lib = ctypes.CDLL(build_library())
    p = ctypes.c_void_p
    lib.hexl_tpu_pack52.argtypes = [p, p, ctypes.c_uint64]
    lib.hexl_tpu_pack52.restype = None
    lib.hexl_tpu_unpack52.argtypes = [p, p, ctypes.c_uint64]
    lib.hexl_tpu_unpack52.restype = None
    return lib
