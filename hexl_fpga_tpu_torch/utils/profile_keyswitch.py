"""Where one KeySwitch batch spends its time, on the card.

    python -m hexl_fpga_tpu_torch.utils.profile_keyswitch [vector.json[.gz]]
        [--schedule default|fused_mac|exact128|unfused_tail]

Needs a CUDA device.  `--schedule` picks the KeySwitchContext options whose
device body is profiled (the API always runs the default schedule, so its
trace is taken for `default` only).  For one batch of BATCH ops at the vector's
configuration (default: tests/testdata/16384_6_7_7_2_0.json.gz) it prints one
JSON object per line:

  host_steps   wall milliseconds of each step the executor takes for a batch
               (stack, host->device, device body, device->host, scatter), each
               ended by a synchronise;
  device_body  torch.profiler over the device body alone: device time by
               kernel name (the hand-written NTT kernels, then the largest
               torch kernels), the count of launches, the busy time (the
               union of the kernels' and copies' spans; `device_time_sum_ms`
               is their sum) and the idle share of the window;
  api          the same trace over 2*BATCH ops through the public API: the
               device's busy and idle share of the whole call sequence.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

import hexl_fpga_tpu_torch as hexl
from hexl_fpga_tpu_torch import config as config_mod
from hexl_fpga_tpu_torch.ops import keyswitch_cuda, word64 as w
from hexl_fpga_tpu_torch.utils import vectors
from hexl_fpga_tpu_torch.utils.cuda_timing import kernel_base

BATCH = 32
NTT_KERNELS = ("ntt_fwd_kernel", "ntt_inv_kernel", "ntt_fwd_tail_kernel",
               "ntt_fwd_mac_kernel")
SCHEDULES = {
    "default": {},
    "fused_mac": {"fused_mac": True},
    "exact128": {"mac_impl": "exact128"},
    "unfused_tail": {"fused_tail": False},
}


def wall_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _device_events(prof):
    """(name, device microseconds, count) of every kernel and copy row."""
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", 0) or getattr(ev, "cuda_time_total", 0)
        # kernels and copies only: operator rows repeat their kernels' time
        if us and str(getattr(ev, "device_type", "")).endswith("CUDA"):
            yield ev.key.split("(")[0][:90], us, ev.count  # no argument list


def device_rows(prof) -> dict:
    """Device milliseconds by kernel (or copy) name from a finished profile."""
    rows = {}
    for name, us, _ in _device_events(prof):
        rows[name] = rows.get(name, 0.0) + us / 1e3
    return rows


def device_busy_ms(prof) -> float:
    """Milliseconds of a finished profile in which at least one kernel or
    copy ran on the card: the union of their spans (the executor's copies
    run on a stream of their own, so device rows overlap and their sum
    counts the overlap twice)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if str(e.device_type).endswith("CUDA"))
    busy, end = 0.0, float("-inf")
    for start, stop in spans:
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy / 1e3


def _device_table(prof, window_ms, top=8):
    """Device time by kernel from a finished profile, against the window."""
    rows = device_rows(prof)
    busy = device_busy_ms(prof)
    ntt = {k: v for k, v in rows.items() if kernel_base(k) in NTT_KERNELS}
    rest = sorted(((v, k) for k, v in rows.items() if k not in ntt), reverse=True)
    return {
        "window_ms": window_ms, "device_busy_ms": busy,
        "device_time_sum_ms": sum(rows.values()),
        "device_idle_share": 1 - busy / window_ms,
        "launches": sum(count for _, _, count in _device_events(prof)),
        "ntt_kernels_ms": ntt,
        "ntt_kernels_share_of_busy": sum(ntt.values()) / busy,
        "largest_other_ms": {k: v for v, k in rest[:top]},
    }


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("profile_keyswitch: no CUDA device is available", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    parser = argparse.ArgumentParser(prog="profile_keyswitch")
    parser.add_argument("vector", nargs="?", default=os.path.join(
        here, "..", "..", "tests", "testdata", "16384_6_7_7_2_0.json.gz"))
    parser.add_argument("--schedule", choices=list(SCHEDULES), default="default")
    args = parser.parse_args(argv[1:])
    vec = vectors.load_json(args.vector)
    n, L, K = vec.coeff_count, vec.decomp_modulus_size, vec.key_modulus_size
    device = torch.device("cuda", 0)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "config": vec.config_name, "batch": BATCH,
                      "schedule": args.schedule}), flush=True)
    rng = np.random.default_rng(0)
    ts = [np.concatenate([rng.integers(0, vec.moduli[j], size=n, dtype=np.uint64)
                          for j in range(L)]) for _ in range(BATCH)]
    rs = [np.concatenate([rng.integers(0, vec.moduli[j % L], size=n, dtype=np.uint64)
                          for j in range(2 * L)]) for _ in range(BATCH)]
    ctx = keyswitch_cuda.KeySwitchContext(
        n, L, K, vec.rns_modulus_size, 2, vec.moduli, vec.twiddle_factors,
        device=device, **SCHEDULES[args.schedule])
    keys, kp = ctx.device_keys(vec.key_vectors)
    msf = ctx.prepare_msf4(vec.modswitch_factors)

    # the executor's steps for one batch, one by one (second pass is reported)
    for _ in range(2):
        # the last pass's pinned buffer goes back to torch's host allocator
        # first, so this pass reuses it as the executor's batches do
        host = None
        steps = {}
        (t_np, r_np), steps["stack"] = wall_ms(
            lambda: (np.stack(ts).reshape(BATCH, L, n),
                     np.stack(rs).reshape(BATCH, 2, L, n)))
        (t, r), steps["host_to_device"] = wall_ms(
            lambda: (w.from_u64_np(t_np, device), w.from_u64_np(r_np, device)))
        out, steps["device_body"] = wall_ms(lambda: ctx._build(t, keys, kp, r, msf))
        # the executor's copy back: into pinned memory, off the host
        host, steps["device_to_host"] = wall_ms(lambda: w.to_host_async(out))
        host = host.numpy().view(np.uint64)
        dst = [np.empty_like(x) for x in rs]
        _, steps["scatter"] = wall_ms(lambda: [
            np.copyto(d, host[b].reshape(d.shape)) for b, d in enumerate(dst)])
    steps["sum"] = sum(steps.values())
    print(json.dumps({"host_steps_ms": steps}), flush=True)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, wall = wall_ms(lambda: ctx._build(t, keys, kp, r, msf))
    print(json.dumps({"device_body": _device_table(prof, wall)}), flush=True)
    if args.schedule != "default":
        return 0

    os.environ["BATCH_SIZE_KEYSWITCH"] = str(BATCH)
    os.environ["RUN_CHOICE"] = "2"
    config_mod.reset_config()
    hexl.acquire_FPGA_resources()

    def api_pass(res):
        hexl.set_worksize_KeySwitch(len(res))
        for x, t_ in zip(res, ts + ts):
            hexl.KeySwitch(x, t_, n, L, K, vec.rns_modulus_size, 2, vec.moduli,
                           vec.key_vectors, vec.modswitch_factors,
                           vec.twiddle_factors)
        hexl.KeySwitchCompleted()

    api_pass([x.copy() for x in rs + rs])
    res = [x.copy() for x in rs + rs]
    with torch.profiler.profile(activities=acts) as prof:
        _, wall = wall_ms(lambda: api_pass(res))
    hexl.release_FPGA_resources()
    table = _device_table(prof, wall)
    table["ops"] = 2 * BATCH
    print(json.dumps({"api": table}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
