"""Time every split of the split forward kernels on the card.

    python -m hexl_fpga_tpu_torch.utils.sweep_row_split [--quick]

Needs a CUDA device and nvcc.  For ntt_fwd and ntt_fwd_tail it prints one
JSON object per line:

  ptxas     the compiler's registers / spills lines of the split kernels;
  info      registers, local bytes, threads and resident blocks per SM of
            each parts at n = 16384 (hexl_ntt_split_info);
  chosen    the parts `ntt_cuda.row_split` takes for a shape on this card;
  time      for each shape the main paths give the kernels and each parts
            C in {1, 2, 4}: the device time per launch by the profiler and
            by a CUDA graph of the launches; inputs rotate over more than the
            50 MB L2.

`--quick` times only the shapes of the main path.  The bits of every split
are checked by `chip_smoke.py` (its `split_sweep` phase), not here.
`row_split`'s rule and SPLIT_R in csrc/ntt_kernels.cuh were read off this
output (PERF.md §6).
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys

import numpy as np
import torch

from hexl_fpga_tpu_torch.ops import _build, nt, ntt_cuda, word64 as w
from hexl_fpga_tpu_torch.utils import cuda_timing

PARTS = (1, 2, 4)
REPS = 20


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def ptxas_lines(log: str):
    """{kernel instance: 'registers ... spill ...'} of the split kernels."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            continue
        if name and ("ntt_fwd_kernel" in name or "ntt_fwd_tail_kernel" in name):
            if "spill" in line or "Used" in line:
                out.setdefault(name, []).append(line.split(":", 1)[-1].strip())
    return out


def rand(rng, rows, n, bits, device):
    return w.from_u64_np(
        rng.integers(0, 1 << bits, size=(rows, n), dtype=np.uint64), device)


def tail_args(rng, rows, tabs, device):
    q = tabs.q
    msf = int(rng.integers(1, q))
    return (rand(rng, rows, tabs.n, 53, device), rand(rng, rows, tabs.n, 64, device),
            w.from_u64_np(rng.integers(0, q, size=(rows, tabs.n), dtype=np.uint64), device),
            tabs, q - 12345, msf, (msf << 64) // q)


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("sweep_row_split: no CUDA device is available", file=sys.stderr)
        return 1
    parser = argparse.ArgumentParser(prog="sweep_row_split")
    parser.add_argument("--quick", action="store_true")
    args = parser.parse_args(argv[1:])
    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    emit({"device": smi, "torch": torch.__version__, "cuda": torch.version.cuda})
    ntt_cuda.build_kernels()
    n = 16384
    emit({"ptxas": ptxas_lines(_build.build_log(ntt_cuda.KERNEL_SOURCE,
                                                ntt_cuda.KERNEL_DEPS))})
    emit({"info": [dict(kernel=k, parts=p, **ntt_cuda.split_info(k, n, p))
                   for k in ("ntt_fwd", "ntt_fwd_tail") for p in PARTS]})

    rng = np.random.default_rng(41)
    shapes = [("ntt_fwd", 192, n), ("ntt_fwd_tail", 64, n), ("ntt_fwd", 256, n)]
    if not args.quick:
        shapes += [("ntt_fwd", 32, n), ("ntt_fwd", 64, n), ("ntt_fwd", 256, 4096),
                   ("ntt_fwd", 256, 1024)]
    for kernel, rows, nn in shapes:
        q = int(nt.generate_primes(1, 50, nn)[0])
        tabs = ntt_cuda.modulus_tables(nn, q, device=device)
        if kernel == "ntt_fwd":
            ins = cuda_timing.rotating(lambda: rand(rng, rows, nn, 53, device), rows * nn * 8)
        else:
            ins = cuda_timing.rotating(lambda: tail_args(rng, rows, tabs, device), 3 * rows * nn * 8)
        emit({"chosen": {"kernel": kernel, "rows": rows, "n": nn,
                         "parts": ntt_cuda.row_split(rows, nn, device)}})
        for parts in PARTS:
            if 2 * parts > nn:
                continue
            if kernel == "ntt_fwd":
                def fn(parts=parts):
                    return ntt_cuda.ntt_fwd(ins(), tabs, parts)
            else:
                def fn(parts=parts):
                    return ntt_cuda.ntt_fwd_tail(*ins(), parts=parts)
            dev, count = cuda_timing.device_ms(fn, REPS, {kernel + "_kernel"})
            emit({"time": {"kernel": kernel, "rows": rows, "n": nn, "parts": parts,
                           "device_ms": dev, "profiled_launches": count,
                           "graph_ms": cuda_timing.graph_ms(fn, REPS)}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
