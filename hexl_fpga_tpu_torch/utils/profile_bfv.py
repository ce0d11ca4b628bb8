"""Where one BEHZ multiply (BFV ciphertext x ciphertext) spends its time, on
the card.

    python -m hexl_fpga_tpu_torch.utils.profile_bfv

Needs a CUDA device.  At the chain of the frozen vector 16384_6_7_7_2
(`tests/testdata/16384_6_7_7_2_0.json.gz`: n = 16384, six 52-bit decomp
primes and the special one; t = 65537), the shape of the benchmark's cell
`bfv16384.behz_multiply`, it builds a BfvContext and its
`DeviceBfvEvaluator`, stages two batches of random canonical NTT limbs, and
at batch 8 and 1, for the eager composition (`BehzCuda.multiply_tensors`)
and the evaluator's multiply (its CUDA graph replay) prints one JSON line
each: the synchronised wall milliseconds of one call, then torch.profiler's
table over one call (device busy time, idle share of the window, device
operations launched, the NTT kernels' time and share of busy time, the
largest other kernels: `dyadic_mul` and the torch lane math).
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from hexl_fpga_tpu_torch.integrations.bfv import BfvContext, DeviceBfvEvaluator
from hexl_fpga_tpu_torch.utils import vectors
from hexl_fpga_tpu_torch.utils.cuda_timing import device_table, wall_ms

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
VECTOR = os.path.join(ROOT, "tests", "testdata", "16384_6_7_7_2_0.json.gz")
T, BATCH = 65537, 8


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_bfv: no CUDA device is available", file=sys.stderr)
        return 1
    vec = vectors.load_json(VECTOR)
    n, k = vec.coeff_count, vec.decomp_modulus_size
    ctx = BfvContext(n, vec.moduli, T, seed=7)
    ev = DeviceBfvEvaluator(ctx, "cuda")
    behz = ctx._behz_cuda(k, ev.device)
    tool = behz.tool
    print(json.dumps({"device": torch.cuda.get_device_name(0), "n": n,
                      "q_bits": [m.bit_length() for m in tool.q],
                      "bsk_bits": [m.bit_length() for m in tool.Bsk], "t": T}),
          flush=True)
    rng = np.random.default_rng(7)
    qcol = np.array(tool.q, dtype=np.uint64).reshape(1, 1, k, 1)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for B in (BATCH, 1):
        c1, c2 = (ev.stage(rng.integers(0, 1 << 62, size=(B, 2, k, n), dtype=np.uint64)
                           % qcol) for _ in range(2))
        ops = {"eager": lambda: behz.multiply_tensors(c1, c2),
               "graph_replay": lambda: ev.multiply(c1, c2)}
        for name, fn in ops.items():
            for _ in range(2):
                _, ms = wall_ms(fn)
            with torch.profiler.profile(activities=acts) as prof:
                _, window = wall_ms(fn)
            print(json.dumps({f"batch_{B}_{name}": {"wall_ms": ms,
                                                    **device_table(prof, window)}}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
