"""Where a DyadicMultiply batch and an _NTT / _INTT batch spend their time, on
the card.

    python -m hexl_fpga_tpu_torch.utils.profile_paths

Needs a CUDA device.  For DyadicMultiply at n = 16384 under 14 moduli of 50
bits (batch 32) and for _NTT / _INTT at n = 16384 under a 52-bit prime (batch
256) and n = 32768 under a 61-bit prime (batch 32), one JSON object per line:

  host_steps_ms  wall milliseconds of each step the executor takes for one
                 batch (stack, host->device, device body, device->host,
                 scatter into the caller's buffers), each ended by a
                 synchronise; the second pass is reported;
  api            torch.profiler over the whole call sequence through the
                 public API (64 DyadicMultiply ops; `ops` _NTT then `ops`
                 _INTT ops): the window, the device's busy time (the union
                 of the kernels' and copies' spans; their sum beside it) and
                 idle share, the port's kernels' time, and the largest other
                 rows (the copies).
"""

from __future__ import annotations

import json
import os
import sys
import warnings

import numpy as np
import torch
import torch.profiler

import hexl_fpga_tpu_torch as hexl
from hexl_fpga_tpu_torch import config as config_mod
from hexl_fpga_tpu_torch.ops import dyadic_cuda, nt, ntt_cuda, twiddles, word64 as w
from hexl_fpga_tpu_torch.utils.profile_keyswitch import (
    device_busy_ms, device_rows, wall_ms,
)

KERNEL_WORDS = ("dyadic_mul_kernel", "ntt_fwd", "ntt_inv")
ACTS = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]


def host_steps(sources, stack, body, dests):
    """The executor's steps for one batch, one by one; `sources` are the
    caller's arrays, `dests` makes the buffers the results are scattered to."""
    for _ in range(2):
        # the last pass's pinned buffer goes back to torch's host allocator
        # first, so this pass reuses it as the executor's batches do
        host = None
        steps = {}
        stacked, steps["stack"] = wall_ms(lambda: stack(sources))
        dev, steps["host_to_device"] = wall_ms(
            lambda: [w.from_u64_np(a, "cuda") for a in stacked])
        out, steps["device_body"] = wall_ms(lambda: body(*dev))
        # the executor's copy back: into pinned memory, off the host
        host, steps["device_to_host"] = wall_ms(lambda: w.to_host_async(out))
        host = host.numpy().view(np.uint64)
        dst = dests()
        _, steps["scatter"] = wall_ms(lambda: [
            np.copyto(d, host[b].reshape(d.shape)) for b, d in enumerate(dst)])
    steps["sum"] = sum(steps.values())
    return steps


def api_trace(run, ops):
    """torch.profiler over run() (already warmed by one earlier call)."""
    run()
    with torch.profiler.profile(activities=ACTS) as prof:
        _, window = wall_ms(run)
    rows = device_rows(prof)
    busy = device_busy_ms(prof)
    ours = {k: v for k, v in rows.items() if any(x in k for x in KERNEL_WORDS)}
    rest = sorted(((v, k) for k, v in rows.items() if k not in ours), reverse=True)
    return {
        "ops": ops, "window_ms": window, "ops_per_s": ops / window * 1e3,
        "device_busy_ms": busy, "device_time_sum_ms": sum(rows.values()),
        "device_idle_share": 1 - busy / window,
        "kernels_ms": ours, "largest_other_ms": {k: v for v, k in rest[:4]},
    }


def start(**env):
    for k, v in env.items():
        os.environ[k] = str(v)
    os.environ["RUN_CHOICE"] = "2"
    config_mod.reset_config()
    hexl.acquire_FPGA_resources()


def dyadic(n=16384, M=14, bits=50, batch=32):
    moduli = [int(q) for q in nt.generate_primes(M, bits, n)]
    rng = np.random.default_rng(0)
    qcol = np.array(moduli, dtype=np.uint64).reshape(1, M, 1)
    make = lambda: [(rng.integers(0, 1 << 63, size=(2, M, n), dtype=np.uint64)
                     % qcol).reshape(-1) for _ in range(2 * batch)]
    op1, op2 = make(), make()
    runner = dyadic_cuda.runner(moduli, "cuda")
    steps = host_steps(
        (op1[:batch], op2[:batch]),
        lambda s: [np.stack([a.reshape(2, M, n) for a in side]) for side in s],
        runner.run,
        lambda: [np.zeros(3 * M * n, dtype=np.uint64) for _ in range(batch)])
    print(json.dumps({"dyadic": {"n": n, "moduli": M, "batch": batch,
                                 "host_steps_ms": steps}}), flush=True)

    start(BATCH_SIZE_DYADIC_MULTIPLY=batch)

    def run():
        res = [np.zeros(3 * M * n, dtype=np.uint64) for _ in op1]
        hexl.set_worksize_DyadicMultiply(len(op1))
        for r, a, b in zip(res, op1, op2):
            hexl.DyadicMultiply(r, a, b, n, moduli, M)
        hexl.DyadicMultiplyCompleted()

    table = api_trace(run, len(op1))
    hexl.release_FPGA_resources()
    print(json.dumps({"dyadic": {"api": table}}), flush=True)


def transforms(n, bits, ops, batch):
    q = int(nt.generate_primes(1, bits, n)[0])
    t = twiddles.ntt_tables(n, q)
    rng = np.random.default_rng(n)
    src = [rng.integers(0, q, size=n, dtype=np.uint64) for _ in range(ops)]
    ft = ntt_cuda.caller_fwd_tables(n, q, t.fwd, t.fwd_precon, device="cuda")
    steps = host_steps(
        src[:batch], lambda s: [np.stack(s)], lambda x: ntt_cuda.ntt_fwd(x, ft),
        lambda: src[:batch])  # in place: the caller's own, touched, buffers
    print(json.dumps({"ntt": {"n": n, "modulus_bits": bits, "batch": batch,
                              "host_steps_ms": steps}}), flush=True)

    start(BATCH_SIZE_NTT=batch, BATCH_SIZE_INTT=batch)

    def run():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            hexl._set_worksize_NTT(ops)
            for a in src:
                hexl._NTT(a, t.fwd, t.fwd_precon, q, n)
            hexl._NTTCompleted()
            hexl._set_worksize_INTT(ops)
            for a in src:
                hexl._INTT(a, t.inv, t.inv_precon, q, t.inv_n, t.inv_n_w, n)
            hexl._INTTCompleted()

    table = api_trace(run, 2 * ops)
    hexl.release_FPGA_resources()
    print(json.dumps({"ntt": {"n": n, "api": table}}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_paths: no CUDA device is available", file=sys.stderr)
        return 1
    print(json.dumps({"device": torch.cuda.get_device_name(0)}), flush=True)
    dyadic()
    transforms(16384, 52, 1024, 256)
    transforms(32768, 61, 64, 32)
    return 0


if __name__ == "__main__":
    sys.exit(main())
