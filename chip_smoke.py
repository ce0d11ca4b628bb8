#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Needs one CUDA device, nvcc, and nothing from the network.  It

  1. builds the CUDA kernels from hexl_fpga_tpu_torch/csrc/,
  2. holds each kernel against its plain PyTorch version on the card, bit for
     bit, at the shapes the main path gives it (n = 16384, the frozen
     vector's seven moduli) and at n = 1024, and times both,
  3. drives the main path through the public API: 64 KeySwitch ops at
     16384_6_7_7_2 in batches of 32 with the frozen vector's moduli, keys,
     twiddles and modswitch factors; two ops carry the vector's own operands
     (checked against its expected_output), the rest operands drawn from a
     numpy seed; EVERY op is checked against the golden model, and the launch
     counters must read 7 forward / 7 inverse / 6 tail launches per batch.

Every phase asserts; nothing is caught.  One JSON object per line; the last
line is {"ok": true, "device": {...}}.  Exit code 0 only if all of it passed.

`main(rehearse=True)` walks the same control flow on the CPU at n = 1024 with
the kernels' plain versions (no build, no kernel comparison, no timings): a
check of the script, not of the card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

import hexl_fpga_tpu_torch as hexl
from hexl_fpga_tpu_torch import config as config_mod
from hexl_fpga_tpu_torch.ops import golden, keyswitch_cuda, ntt_cuda, word64 as w
from hexl_fpga_tpu_torch.utils import vectors

HERE = os.path.dirname(os.path.abspath(__file__))
VECTOR = os.path.join(HERE, "tests", "testdata", "16384_6_7_7_2_0.json.gz")
KERNEL_SRC = "hexl_fpga_tpu_torch/csrc/ntt_kernels.cu"
BATCH = 32
WORKSIZE = 64
N_VECTOR_OPS = 2  # ops that carry the frozen vector's own operands

# Published peaks of one H100 SXM.  The data sheet has no integer rate: the
# 32-bit integer multiply-add runs on half of the lanes that give 67 TFLOP/s
# in float32 (two flops per fused multiply-add), so 67e12 / 2 / 2 per second.
PEAK_BYTES_PER_S = 3.35e12
PEAK_IMAD32_PER_S = 67e12 / 4
# 32-bit multiply-adds in the 64-bit products the kernels are made of
IMAD_MULHI64 = 4
IMAD_MULLO64 = 3
IMAD_LAZY_MUL = IMAD_MULHI64 + 2 * IMAD_MULLO64  # Harvey multiply
IMAD_BARRETT = IMAD_MULHI64 + IMAD_MULLO64


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps launches, CUDA events, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound(rows: int, n: int, arrays: int, extra_imad_per_coeff: int):
    """(bound_ms, bound_by) for one transform kernel: `arrays` (rows, n) u64
    arrays each read or written once plus the two table rows, against the
    butterflies' and the per-coefficient multiplies' 32-bit multiply-adds."""
    log_n = n.bit_length() - 1
    nbytes = 8 * (arrays * rows * n + 2 * n)
    imad = rows * (n // 2) * log_n * IMAD_LAZY_MUL + rows * n * extra_imad_per_coeff
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = imad / PEAK_IMAD32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rand_u64(rng, shape, bits, device):
    return w.from_u64_np(
        rng.integers(0, 1 << bits, size=shape, dtype=np.uint64), device
    )


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version, on the card
# ---------------------------------------------------------------------------


def check_kernels(vec, device):
    """Compare and time the three kernels; returns the `kernels` entries
    (without `launches`, which the main path fills in)."""
    n, L, K = vec.coeff_count, vec.decomp_modulus_size, vec.key_modulus_size
    ctx = keyswitch_cuda.get_context(
        n, L, K, vec.rns_modulus_size, 2, vec.moduli, vec.twiddle_factors,
        device=device,
    )
    msf = ctx.prepare_msf4(vec.modswitch_factors)
    rng = np.random.default_rng(2024)
    max_err = {"ntt_fwd": 0, "ntt_inv": 0, "ntt_fwd_tail": 0}

    def same(name, got, want):
        torch.cuda.synchronize()  # a fault inside the kernel surfaces here
        err = int((got - want).abs().max().item())
        max_err[name] = max(max_err[name], err)
        assert err == 0, f"{name}: differs from the plain version by up to {err}"

    def tail_args(j, rows, tabs):
        q = tabs.q
        return (
            rand_u64(rng, (rows, tabs.n), 53, device),  # e + fix unreduced
            rand_u64(rng, (rows, tabs.n), 58, device),  # lazy MAC sums
            w.from_u64_np(rng.integers(0, q, size=(rows, tabs.n),
                                       dtype=np.uint64), device),
            tabs, ctx._fix[j] if tabs.n == n else q - 12345,
            int(msf[j, 0]) % q, (int(msf[j, 0]) % q << 64) // q,
        )

    # main-path shapes, every modulus the path transforms under
    for j, tabs in ctx._tabs.items():
        x = rand_u64(rng, (L * BATCH, n), 53, device)  # wide, unreduced
        same("ntt_fwd", ntt_cuda.ntt_fwd(x, tabs), ntt_cuda.ntt_fwd_plain(x, tabs))
        rows = 2 * BATCH if j == K - 1 else BATCH
        y = w.from_u64_np(
            rng.integers(0, tabs.q, size=(rows, n), dtype=np.uint64), device
        )
        same("ntt_inv", ntt_cuda.ntt_inv(y, tabs), ntt_cuda.ntt_inv_plain(y, tabs))
        if j < L:
            a = tail_args(j, 2 * BATCH, tabs)
            same("ntt_fwd_tail", ntt_cuda.ntt_fwd_tail(*a),
                 ntt_cuda.ntt_fwd_tail_plain(*a))
    # any-u64 input, and a small n under a small modulus
    tabs = ctx._tabs[0]
    x = rand_u64(rng, (4, n), 64, device)
    same("ntt_fwd", ntt_cuda.ntt_fwd(x, tabs), ntt_cuda.ntt_fwd_plain(x, tabs))
    same("ntt_inv", ntt_cuda.ntt_inv(x, tabs), ntt_cuda.ntt_inv_plain(x, tabs))
    small = ntt_cuda.modulus_tables(1024, 1073750017, device=device)  # 30 bits
    x = rand_u64(rng, (5, 1024), 64, device)
    same("ntt_fwd", ntt_cuda.ntt_fwd(x, small), ntt_cuda.ntt_fwd_plain(x, small))
    same("ntt_inv", ntt_cuda.ntt_inv(x, small), ntt_cuda.ntt_inv_plain(x, small))
    a = tail_args(0, 6, small)
    same("ntt_fwd_tail", ntt_cuda.ntt_fwd_tail(*a), ntt_cuda.ntt_fwd_tail_plain(*a))

    # timings at the main path's shapes, under the first decomp modulus; the
    # inputs rotate over more than the L2 cache holds so reads come from
    # device memory
    tabs = ctx._tabs[0]

    def rotating(make, rows):
        copies = int(100e6 // (rows * n * 8)) + 2
        sets = [make() for _ in range(copies)]
        state = {"i": 0}

        def nxt():
            state["i"] = (state["i"] + 1) % copies
            return sets[state["i"]]

        return nxt

    fwd_in = rotating(lambda: rand_u64(rng, (L * BATCH, n), 53, device), L * BATCH)
    inv_in = rotating(lambda: rand_u64(rng, (BATCH, n), 50, device), BATCH)
    inv2_in = rotating(lambda: rand_u64(rng, (2 * BATCH, n), 50, device), 2 * BATCH)
    tail_in = rotating(lambda: tail_args(0, 2 * BATCH, tabs), 2 * BATCH)

    entries = []
    for name, rows, arrays, extra, kern, plain, replaces in (
        ("ntt_fwd", L * BATCH, 2, IMAD_BARRETT,
         lambda: ntt_cuda.ntt_fwd(fwd_in(), tabs),
         lambda: ntt_cuda.ntt_fwd_plain(fwd_in(), tabs),
         "hexl_fpga_tpu/ops/ntt_mxu_pallas.py:213"),
        ("ntt_inv", BATCH, 2, IMAD_BARRETT + IMAD_LAZY_MUL // 2,  # last stage: 2 products
         lambda: ntt_cuda.ntt_inv(inv_in(), tabs),
         lambda: ntt_cuda.ntt_inv_plain(inv_in(), tabs),
         "hexl_fpga_tpu/ops/ntt_mxu_pallas.py:230"),
        ("ntt_fwd_tail", 2 * BATCH, 4, 2 * IMAD_BARRETT + IMAD_LAZY_MUL,
         lambda: ntt_cuda.ntt_fwd_tail(*tail_in()),
         lambda: ntt_cuda.ntt_fwd_tail_plain(*tail_in()),
         "hexl_fpga_tpu/ops/ntt_mxu_pallas.py:422"),
    ):
        b_ms, b_by = bound(rows, n, arrays, extra)
        entry = {
            "name": name, "route": "cuda", "source": KERNEL_SRC,
            "replaces": replaces,
            "shape": [rows, n], "launches": None,
            "max_abs_err": max_err[name],
            "ms": time_ms(kern, 20), "plain_ms": time_ms(plain, 3),
            "bound_ms": b_ms, "bound_by": b_by,
            # no single PyTorch call computes a modular NTT
            "library_ms": None,
        }
        if name == "ntt_inv":  # INTT2 runs the same kernel over 2B rows
            entry["ms_rows_2B"] = time_ms(
                lambda: ntt_cuda.ntt_inv(inv2_in(), tabs), 20)
        entries.append(entry)
    return entries


# ---------------------------------------------------------------------------
# phase 3: the main path, through the public API
# ---------------------------------------------------------------------------


def make_ops(vec, count, seed):
    """`count` (result, t_target) operand pairs: the first N_VECTOR_OPS are
    the vector's own, the rest canonical residues drawn from `seed`."""
    n, L = vec.coeff_count, vec.decomp_modulus_size
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(count):
        if i < N_VECTOR_OPS:
            ops.append((vec.input.copy(), vec.t_target_iter_ptr.copy()))
            continue
        t = np.stack([rng.integers(0, vec.moduli[j], size=n, dtype=np.uint64)
                      for j in range(L)])
        r = np.stack([rng.integers(0, vec.moduli[j % L], size=n, dtype=np.uint64)
                      for j in range(2 * L)])
        ops.append((r.ravel(), t.ravel()))
    return ops


def drive_api(vec, ops):
    """set_worksize -> len(ops) x KeySwitch -> Completed, results in place;
    returns the wall seconds from the first call to Completed's return."""
    results = [r.copy() for r, _ in ops]
    t0 = time.perf_counter()
    hexl.set_worksize_KeySwitch(len(ops))
    for res, (_, t) in zip(results, ops):
        hexl.KeySwitch(
            res, t, vec.coeff_count, vec.decomp_modulus_size,
            vec.key_modulus_size, vec.rns_modulus_size,
            vec.key_component_count, vec.moduli, vec.key_vectors,
            vec.modswitch_factors, vec.twiddle_factors,
        )
    assert hexl.KeySwitchCompleted()
    return results, time.perf_counter() - t0


def main_path(vec, device, rehearse):
    n, L, K = vec.coeff_count, vec.decomp_modulus_size, vec.key_modulus_size
    os.environ["BATCH_SIZE_KEYSWITCH"] = str(BATCH)
    os.environ["RUN_CHOICE"] = "1" if rehearse else "2"
    config_mod.reset_config()
    hexl.acquire_FPGA_resources()

    ops = make_ops(vec, WORKSIZE, seed=7)
    t0 = time.perf_counter()
    want = [
        golden.keyswitch(r, t, n, L, K, vec.rns_modulus_size, 2, vec.moduli,
                         vec.key_vectors, vec.modswitch_factors,
                         vec.twiddle_factors)
        for r, t in ops
    ]
    golden_s = time.perf_counter() - t0
    for i in range(N_VECTOR_OPS):
        np.testing.assert_array_equal(want[i], vec.expected_output)

    # a first pass stages keys and tables; the second is the counted one
    first, _ = drive_api(vec, ops)
    ntt_cuda.reset_launch_counts()
    results, wall_s = drive_api(vec, ops)
    launches = dict(ntt_cuda.LAUNCHES)
    hexl.release_FPGA_resources()

    for i, exp in enumerate(want):
        np.testing.assert_array_equal(first[i], exp, err_msg=f"first pass, op {i}")
        np.testing.assert_array_equal(results[i], exp, err_msg=f"op {i}")
    batches = WORKSIZE // BATCH
    expected = {"ntt_fwd": (L + 1) * batches, "ntt_inv": (L + 1) * batches,
                "ntt_fwd_tail": L * batches}
    if rehearse:
        assert launches == dict.fromkeys(expected, 0), launches
    else:
        assert launches == expected, (launches, expected)

    out = {
        "config": vec.config_name, "ops": WORKSIZE, "batch": BATCH,
        "ops_checked_vs_golden": len(want),
        "ops_checked_vs_frozen_vector": N_VECTOR_OPS,
        "golden_s": golden_s, "launches": launches,
    }
    if not rehearse:
        out["api_ops_per_s"] = WORKSIZE / wall_s
        # the device body alone, on operands already staged
        ctx = keyswitch_cuda.get_context(
            n, L, K, vec.rns_modulus_size, 2, vec.moduli, vec.twiddle_factors,
            device=device,
        )
        keys, kp = ctx.device_keys(vec.key_vectors)
        t = w.from_u64_np(np.stack([o[1] for o in ops[:BATCH]]).reshape(BATCH, L, n), device)
        r = w.from_u64_np(np.stack([o[0] for o in ops[:BATCH]]).reshape(BATCH, 2, L, n), device)
        msf = ctx.prepare_msf4(vec.modswitch_factors)
        build_ms = time_ms(lambda: ctx._build(t, keys, kp, r, msf), 5)
        out["build_ms_per_batch"] = build_ms
        out["build_ops_per_s"] = BATCH / build_ms * 1e3
        out["device_bytes_keys_and_precons"] = 2 * keys.numel() * 8
        out["device_bytes_operands_in_per_batch"] = (t.numel() + r.numel()) * 8
        out["device_bytes_results_out_per_batch"] = r.numel() * 8
    return out


def main(rehearse: bool = False) -> int:
    if rehearse:
        device = torch.device("cpu")
        vec = vectors.make_keyswitch_vector(1024, 6, 7, seed=5, modulus_bits=50)
    else:
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device is available", file=sys.stderr)
            return 1
        device = torch.device("cuda", 0)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0]
        t0 = time.perf_counter()
        ntt_cuda.build_kernels()
        emit({"device": smi, "kernel_build_s": time.perf_counter() - t0,
              "torch": torch.__version__, "cuda": torch.version.cuda})
        vec = vectors.load_json(VECTOR)

    kernels = [] if rehearse else check_kernels(vec, device)
    path = main_path(vec, device, rehearse)
    for k in kernels:
        k["launches"] = path["launches"][k["name"]]
        assert k["launches"] > 0, k["name"]
    emit({"main_path": path})
    emit({"kernels": kernels})
    if rehearse:
        emit({"ok": True, "device": {"platform": "cpu", "kind": "rehearsal", "count": 0}})
        return 0
    print(smi, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
