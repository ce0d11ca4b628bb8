"""Where one BEHZ multiply (BFV ciphertext x ciphertext) spends its time, on
the card.

    python -m hexl_fpga_tpu_torch.utils.profile_bfv

Needs a CUDA device.  At the reference benchmark's BEHZ shape (`bench.py`
`bench_bfv_multiply`: n = 16384, six 51-bit primes, t = 65537, batch 8) and
at batch 1, it stages `rns_behz_cuda.BehzCuda` and for the eager composition
and its CUDA graph replay prints one JSON line each: the synchronised wall
milliseconds of one call, then torch.profiler's table over one call (device
busy time, idle share of the window, device operations launched, the NTT
kernels' time and share of busy time, the largest other kernels: `dyadic_mul`
and the torch lane math).
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from hexl_fpga_tpu_torch.ops import nt, rns_behz, rns_behz_cuda, twiddles, word64 as w
from hexl_fpga_tpu_torch.utils.cuda_timing import device_table, wall_ms

# bench.py's BEHZ cell
N, K, BITS, T, BATCH = 16384, 6, 51, 65537, 8


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_bfv: no CUDA device is available", file=sys.stderr)
        return 1
    q = [int(p) for p in nt.generate_primes(K, BITS, N)]
    tool = rns_behz.BehzTool(N, q, T)
    behz = rns_behz_cuda.BehzCuda(tool, [twiddles.ntt_tables(N, qi) for qi in q])
    print(json.dumps({"device": torch.cuda.get_device_name(0), "n": N,
                      "q_bits": [m.bit_length() for m in q],
                      "bsk_bits": [m.bit_length() for m in tool.Bsk], "t": T}),
          flush=True)
    rng = np.random.default_rng(7)
    qcol = np.array(q, dtype=np.uint64).reshape(1, 1, K, 1)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for B in (BATCH, 1):
        c1, c2 = (w.from_u64_np(rng.integers(0, 1 << 62, size=(B, 2, K, N),
                                             dtype=np.uint64) % qcol, "cuda")
                  for _ in range(2))
        program = behz.program(B)
        ops = {"eager": lambda: behz.multiply_tensors(c1, c2),
               "graph_replay": lambda: program(c1, c2)}
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
