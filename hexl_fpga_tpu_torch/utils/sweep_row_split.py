"""Time every launch shape of the split kernels on the card.

    python -m hexl_fpga_tpu_torch.utils.sweep_row_split [--quick]

Needs a CUDA device and nvcc.  For ntt_fwd, ntt_fwd_tail, ntt_inv and
ntt_fwd_mac it prints one JSON object per line:

  ptxas     the compiler's registers / spills lines of the split kernels;
  info      registers, local bytes, threads, resident blocks per SM and
            shared memory of each parts at n = 16384 and 32768, and for
            ntt_fwd_mac the clusters the card runs at once
            (hexl_ntt_split_info);
  chosen    the launch shape `ntt_cuda.row_split` / `mac_split` takes for a
            shape on this card;
  time      for each shape the paths give the kernels and each parts C in
            {1, 2, 4} whose piece fits a block (ntt_fwd_mac: each C and each
            cluster of blocks that share the source limbs; at n = 32768 the
            transforms at rows 1, 32 and 256): the device time per launch by
            the profiler and by a CUDA graph of the launches; inputs rotate
            over more than the 50 MB L2.

`--quick` times only the shapes of the main path and of the fused-MAC body
(KeySwitch at 16384_6_7_7_2, batch 32).  The bits of every shape are checked
by `chip_smoke.py` (its `split_sweep` phase), not here.  `row_split`'s rule,
`mac_split`'s and SPLIT_R in csrc/ntt_kernels.cuh were read off this output
(PERF.md §6).
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
# KeySwitch at 16384_6_7_7_2, batch 32: the engines' source limbs and key shape
MAC_L, MAC_B, MAC_COMP, MAC_K = 6, 32, 2, 7


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
        if name and any(k + "_kernel" in name for k in ntt_cuda.SPLIT_KERNELS):
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
    emit({"info": [dict(kernel=k, n=nn, parts=p, **ntt_cuda.split_info(k, nn, p))
                   for nn in (n, 2 * n) for k in ntt_cuda.SPLIT_KERNELS
                   for p in ntt_cuda.split_candidates(nn, k)]})
    emit({"info_mac_clusters": [
        dict(parts=p, cluster=c, **ntt_cuda.split_info("ntt_fwd_mac", n, p, cluster=c))
        for p in ntt_cuda.split_candidates(n, "ntt_fwd_mac") for c in (2, 3, 5, 6)]})

    rng = np.random.default_rng(41)
    shapes = [("ntt_fwd", 192, n), ("ntt_fwd_tail", 64, n), ("ntt_inv", 32, n),
              ("ntt_inv", 64, n), ("ntt_fwd_mac", MAC_L * MAC_B, n),
              ("ntt_fwd_mac", (MAC_L - 1) * MAC_B, n)]
    if not args.quick:
        shapes += [("ntt_fwd", 256, n), ("ntt_inv", 256, n), ("ntt_fwd", 32, n),
                   ("ntt_fwd", 64, n), ("ntt_fwd", 256, 4096), ("ntt_inv", 256, 4096),
                   ("ntt_fwd", 256, 1024), ("ntt_inv", 256, 1024)]
        shapes += [(k, rows, 2 * n) for rows in (1, 32, 256)
                   for k in ("ntt_fwd", "ntt_inv")]
    for kernel, rows, nn in shapes:
        q = int(nt.generate_primes(1, 50, nn)[0])
        tabs = ntt_cuda.modulus_tables(nn, q, device=device)
        if kernel == "ntt_fwd_mac":
            time_mac(rng, rows, tabs, device)
            continue
        if kernel == "ntt_fwd_tail":
            ins = cuda_timing.rotating(lambda: tail_args(rng, rows, tabs, device), 3 * rows * nn * 8)
        else:
            ins = cuda_timing.rotating(lambda: rand(rng, rows, nn, 53, device), rows * nn * 8)
        emit({"chosen": {"kernel": kernel, "rows": rows, "n": nn,
                         "parts": ntt_cuda.row_split(rows, nn, device, kernel)}})
        for parts in PARTS:
            if 2 * parts > nn or not ntt_cuda.piece_fits(nn, parts):
                continue
            if kernel == "ntt_fwd":
                def fn(parts=parts):
                    return ntt_cuda.ntt_fwd(ins(), tabs, parts)
            elif kernel == "ntt_inv":
                def fn(parts=parts):
                    return ntt_cuda.ntt_inv(ins(), tabs, parts)
            else:
                def fn(parts=parts):
                    return ntt_cuda.ntt_fwd_tail(*ins(), parts=parts)
            emit({"time": {"kernel": kernel, "rows": rows, "n": nn, "parts": parts,
                           **times(fn, kernel)}})
    return 0


def times(fn, kernel):
    dev, count = cuda_timing.device_ms(fn, REPS, {kernel + "_kernel"})
    return {"device_ms": dev, "profiled_launches": count,
            "graph_ms": cuda_timing.graph_ms(fn, REPS)}


def time_mac(rng, rows, tabs, device):
    """ntt_fwd_mac over `rows` summed rows (MAC_B of them per limb; fewer
    than MAC_L limbs: the first is skipped) at every parts and cluster."""
    n, q = tabs.n, tabs.q
    limbs = rows // MAC_B
    skip = None if limbs == MAC_L else 0
    keys = rng.integers(0, q, size=(MAC_L, MAC_COMP, MAC_K, n), dtype=np.uint64)
    kp = w.precon64_np(keys, q)
    keys, kp = w.from_u64_np(keys, device), w.from_u64_np(kp, device)
    ins = cuda_timing.rotating(lambda: rand(rng, MAC_L * MAC_B, n, 53, device),
                               MAC_L * MAC_B * n * 8)
    emit({"chosen": {"kernel": "ntt_fwd_mac", "rows": rows, "n": n,
                     "parts_cluster": ntt_cuda.mac_split(MAC_B, limbs, n, device)}})
    for parts in ntt_cuda.split_candidates(n, "ntt_fwd_mac"):
        for cluster in sorted({1, 2, 3, limbs}):
            def fn(parts=parts, cluster=cluster):
                return ntt_cuda.ntt_fwd_mac(ins(), keys, kp, 0, tabs, skip,
                                            parts, cluster)
            emit({"time": {"kernel": "ntt_fwd_mac", "rows": rows, "n": n,
                           "parts": parts, "cluster": cluster,
                           **times(fn, "ntt_fwd_mac")}})


if __name__ == "__main__":
    sys.exit(main(sys.argv))
