"""Where one CKKS evaluator operation spends its time, on the card.

    python -m hexl_fpga_tpu_torch.utils.profile_ckks

Needs a CUDA device.  At the SEAL bridge's configuration
(`experimental/bridge-seal/tests/keyswitch-example.cpp:30-33`: n = 16384,
moduli of {52, 40, 40, 40, 40, 40, 52} bits, scale 2^40) it builds the host
context and its keys, encrypts one vector, and for each evaluator operation
(rotate, multiply_relin, rescale, rotate_hoisted, rotate_many of four steps,
the 16-diagonal BSGS matvec eager and replayed from its CUDA graph) prints one
JSON line: the synchronised wall milliseconds of one call, then
torch.profiler's table over one call (device busy time, idle share of the
window, device operations launched, the hand-written kernels' time, the
largest torch kernels).
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from hexl_fpga_tpu_torch.integrations import ckks
from hexl_fpga_tpu_torch.integrations.ckks import (
    MATVEC_DIAGONALS, MATVEC_N1, SEAL_BITS, SEAL_N, SEAL_SCALE, seal_moduli,
)
from hexl_fpga_tpu_torch.utils.cuda_timing import device_table, wall_ms


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_ckks: no CUDA device is available", file=sys.stderr)
        return 1
    n = SEAL_N
    rng = np.random.default_rng(3)
    ctx = ckks.CkksContext(n, seal_moduli(n), SEAL_SCALE, seed=3)
    z = rng.uniform(-1, 1, n // 2)
    diags = {d: rng.uniform(-0.5, 0.5, n // 2) for d in range(MATVEC_DIAGONALS)}
    ev = ckks.DeviceCkksEvaluator(ctx, "cuda")
    h = ev.stage(ctx.encrypt(z))
    hh = ev.hoist(h)
    m = ev.multiply_relin(h, h)
    _, program = ev.linear_transform_fused(h, diags, bsgs_n1=MATVEC_N1,
                                           return_program=True)
    ops = {
        "rotate": lambda: ev.rotate(h, 1),
        "multiply_relin": lambda: ev.multiply_relin(h, h),
        "rescale": lambda: ev.rescale(m),
        "rotate_hoisted": lambda: ev.rotate_hoisted(hh, 1),
        "rotate_many": lambda: ev.rotate_many(h, [0, 1, 2, 3]),
        "matvec_eager": lambda: program.eager(h.data),
        "matvec_graph_replay": lambda: program(h.data),
    }
    print(json.dumps({"device": torch.cuda.get_device_name(0), "n": n,
                      "moduli_bits": list(SEAL_BITS)}), flush=True)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for name, fn in ops.items():
        for _ in range(2):  # stages keys, tables and launch shapes first
            _, ms = wall_ms(fn)
        with torch.profiler.profile(activities=acts) as prof:
            _, window = wall_ms(fn)
        print(json.dumps({name: {"wall_ms": ms, **device_table(prof, window)}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
