"""Time variants of the split kernels on the card: one part of their work
taken away, or another value of one of their constants.

    python -m hexl_fpga_tpu_torch.utils.ablate_kernels [VARIANT ...]

Needs a CUDA device and nvcc.  Each variant is csrc/ with one textual patch
(VARIANTS below), built side by side into `_build/ablate/` and loaded in place
of the kernels' own library, so the wrappers launch it unchanged.  For every
variant, and for `base` (no patch), it prints one JSON object per launch shape
of SHAPES: the device time per launch by the profiler and whether the output
still equals the plain version (`ok`: the ablations are wrong on purpose).
What a part costs is the base's time less the variant's, in one call
(PERF.md §6 reads the MAC's epilogue, the inverse's strided stores and its
loads in flight this way).
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

from hexl_fpga_tpu_torch.ops import _build, nt, ntt_cuda, word64 as w
from hexl_fpga_tpu_torch.utils import cuda_timing

CU, CUH = "ntt_kernels.cu", "ntt_kernels.cuh"
EPILOGUE = ("const u64 t = mul_lazy(reduce4(s[spad(x)], q), __ldg(key + x),\n"
            "                                 __ldg(pre + x), q);")
CROSS_TWIDDLES = ("__ldg(w + at),\n                            __ldg(wp + at), q);")
# name -> (file, text, replacement)
VARIANTS = {
    # ntt_fwd_mac: no multiply and no key reads in the epilogue
    "mac_no_terms": (CU, EPILOGUE, "const u64 t = reduce4(s[spad(x)], q);"),
    # ntt_fwd_mac: the multiply kept, the key and precon reads gone
    "mac_no_key_reads": (CU, EPILOGUE,
                         "const u64 t = mul_lazy(reduce4(s[spad(x)], q), q - 1 - x, x, q);"),
    # ntt_fwd_mac: the cluster's sum from the block's own accumulators
    "mac_no_dsmem": (CU, "sum += cluster.map_shared_rank(acc, rho)[k * len + x];",
                     "sum += acc[k * len + x + rho];"),
    # ntt_fwd_mac: 256 threads a block (two blocks an SM where shared memory allows)
    "mac_256_threads": (CU, "return launch(k, dim3(B * parts, cluster), len, smem,",
                        "return launch(k, dim3(B * parts, cluster), len < 4096 ? len : 2048, smem,"),
    # ntt_inv: the last pass stores contiguously (to the wrong places)
    "inv_contiguous_stores": (CUH, "    out[(size_t)C * k] = v;", "    out[k] = v;"),
    # ntt_inv: the crossing stages without their twiddle reads
    "inv_no_cross_twiddles": (CUH, CROSS_TWIDDLES, "at, wp[1], q);"),
    # ntt_inv: 4, 8 or 16 values of each thread in flight at load at every C
    **{f"inv_loads_{u}": (CUH, "constexpr int INV_LOADS = C == 1 ? 8 : 4;",
                          f"constexpr int INV_LOADS = {u};") for u in (4, 8, 16)},
}
# (kernel, rows, n, parts, cluster): the paths' shapes at the chosen launch,
# and the MAC's in-block design (cluster 1, C = 4)
SHAPES = (("ntt_inv", 32, 16384, 4, None), ("ntt_inv", 64, 16384, 2, None),
          ("ntt_inv", 256, 16384, 1, None), ("ntt_fwd_mac", 192, 16384, 2, 2),
          ("ntt_fwd_mac", 160, 16384, 2, 2), ("ntt_fwd_mac", 192, 16384, 4, 1))
MAC_L, MAC_B, MAC_COMP, MAC_K = 6, 32, 2, 7  # KeySwitch at 16384_6_7_7_2, batch 32
REPS = 20


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def start_build(name: str):
    """Copy csrc/ to _build/ablate/<name>, patch it, start nvcc; returns
    (process, library path)."""
    d = os.path.join(_build.BUILD_DIR, "ablate", name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(_build.CSRC_DIR, d)
    if name != "base":
        f, old, new = VARIANTS[name]
        path = os.path.join(d, f)
        with open(path) as fh:
            src = fh.read()
        if old not in src:
            raise ValueError(f"variant {name}: its patch no longer applies to csrc/{f}")
        with open(path, "w") as fh:
            fh.write(src.replace(old, new))
    lib = os.path.join(d, "lib.so")
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", d, "-o", lib, os.path.join(d, CU)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True), lib


def time_shape(rng, device, kernel, rows, n, parts, cluster):
    q = int(nt.generate_primes(1, 50, n)[0])
    tabs = ntt_cuda.modulus_tables(n, q, device=device)
    if kernel == "ntt_fwd_mac":
        skip = None if rows == MAC_L * MAC_B else 0
        keys = rng.integers(0, q, size=(MAC_L, MAC_COMP, MAC_K, n), dtype=np.uint64)
        kp = w.from_u64_np(w.precon64_np(keys, q), device)
        keys = w.from_u64_np(keys, device)
        ins = cuda_timing.rotating(
            lambda: w.from_u64_np(rng.integers(0, 1 << 53, size=(MAC_L * MAC_B, n),
                                               dtype=np.uint64), device),
            MAC_L * MAC_B * n * 8)
        fn = lambda: ntt_cuda.ntt_fwd_mac(ins(), keys, kp, 0, tabs, skip, parts, cluster)
        plain = lambda x: ntt_cuda.ntt_fwd_mac_plain(x, keys, kp, 0, tabs, skip)
        got = lambda x: ntt_cuda.ntt_fwd_mac(x, keys, kp, 0, tabs, skip, parts, cluster)
    else:
        ins = cuda_timing.rotating(
            lambda: w.from_u64_np(rng.integers(0, 1 << 53, size=(rows, n),
                                               dtype=np.uint64), device),
            rows * n * 8)
        fn = lambda: ntt_cuda.ntt_inv(ins(), tabs, parts)
        plain = lambda x: ntt_cuda.ntt_inv_plain(x, tabs)
        got = lambda x: ntt_cuda.ntt_inv(x, tabs, parts)
    x = ins()
    ok = torch.equal(got(x), plain(x))
    dev, count = cuda_timing.device_ms(fn, REPS, {kernel + "_kernel"})
    return {"ok": ok, "device_ms": dev, "profiled_launches": count}


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("ablate_kernels: no CUDA device is available", file=sys.stderr)
        return 1
    names = ["base"] + (argv[1:] or list(VARIANTS))
    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    emit({"device": smi})
    builds = {name: start_build(name) for name in names}  # side by side
    rng = np.random.default_rng(7)
    for name, (proc, lib) in builds.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"variant {name}: nvcc failed\n{log}")
        cdll = ctypes.CDLL(lib)
        _build.load = lambda source, deps=(), cdll=cdll: cdll  # the wrappers' library
        ntt_cuda._lib.cache_clear()
        for kernel, rows, n, parts, cluster in SHAPES:
            emit({"variant": name, "kernel": kernel, "rows": rows, "n": n,
                  "parts": parts, "cluster": cluster,
                  **time_shape(rng, device, kernel, rows, n, parts, cluster)})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
