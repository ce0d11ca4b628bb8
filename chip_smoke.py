#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Needs one CUDA device, nvcc, and nothing from the network.  It

  1. builds the CUDA kernels from hexl_fpga_tpu_torch/csrc/ (one nvcc per
     source) and the C++ runtime from cpp/src (g++, no cmake), side by side,
  2. holds the split kernels `ntt_fwd`, `ntt_fwd_tail`, `ntt_inv` and
     `ntt_fwd_mac` against their plain versions over n = 4 .. 32768 (at
     n = 16384 rows 1 .. 256, at 32768 rows 1, 5 and 32), moduli of 30 and
     61 bits, 53-bit and any-u64
     input, at the wrappers' own launch shape and at every other one (the MAC
     also at every cluster of blocks sharing its limbs, with no limb, the
     first or the last skipped) (`split_sweep`); then each kernel against its
     plain PyTorch version on the card, bit for bit, at the shapes its path
     gives it, and times both (`ms`: CUDA events through the wrapper; after
     the paths also `device_ms` by torch.profiler and `host_ms`): the three
     keyswitch transforms at n = 16384 under the frozen vector's seven moduli
     and at n = 1024; `dyadic_mul` at (32, 2, 14, 16384) on canonical operands,
     operands in [0, 4q) and random 64-bit ones, on the ramp stimulus over
     q = 10, 20, 30 at n = 64 and under q = 2, 3; the standalone transforms
     at (32, 32768) under a 61-bit prime on canonical and random 64-bit
     input, at their own launch shape and at C = 2 and 4 (`ntt_fwd` /
     `ntt_inv`: a row of 32768 values takes 2 or 4 blocks, never one),
  3. drives the main path through the public API: 64 KeySwitch ops at
     16384_6_7_7_2 in batches of 32 with the frozen vector's moduli, keys,
     twiddles and modswitch factors; two ops carry the vector's own operands
     (checked against its expected_output), the rest operands drawn from a
     numpy seed; EVERY op is checked against the golden model, and the launch
     counters must read 7 forward / 7 inverse / 6 tail / 7 MAC launches per
     batch (a key's first dispatch runs eager, its second captures a CUDA
     graph, and the counted pass replays both batches' graph: a replay
     counts the kernels it runs; `keyswitch_cuda.GRAPHS` counts the bodies);
     then `copy_overlap` (the executor's copy stream): 96 KeySwitch ops in
     3 batches of 32 through the API with the executor's timing events on,
     every op against the device context's own batch (held to the golden
     model above); it prints how long the copy back of batch i-1 overlaps
     the body of batch i (`copy_overlap_ms`) and fails if that copy starts
     only after the body ends,
  4. drives the DyadicMultiply path: 64 ops at n = 16384 under 14 moduli of 50
     bits in batches of 32, every op checked against an oracle that is not the
     kernel's arithmetic (the first 8 the bignum golden model, the rest a
     vectorised Harvey product), 2 launches,
  5. drives the _NTT / _INTT path: 1024 ops each way at n = 16384 under a
     52-bit prime in batches of 256 with the caller's tables, then 64 each way
     at n = 32768 under a 61-bit prime in batches of 32; every op against the
     golden transforms and the round trip against the input; `ntt_fwd` 4 and
     `ntt_inv` 4 launches at n = 16384, 2 and 2 at n = 32768,
  6. drives the device KeySwitch context by hand at 16384_6_7_7_2, batch 32
     (`device_path`): the fused transform+MAC schedule (`fused_mac=True`)
     against the default schedule bit for bit and two ops against the golden
     model, with 7 inverse / 7 fused-MAC / 6 tail / 6 keyswitch_mac (the
     identity limbs) / 0 forward launches; the
     `exact128` MAC and the unfused tail against the same output; the
     schedules' device bodies timed side by side, ten turns each; the BGV tail
     (`plain_modulus=65537`) fused against unfused, against the golden model,
     and through `api.KeySwitch(plain_modulus=...)`; device handles, a chain
     of depth 4 and a keyed chain over two key sets against sequential calls;
     `hoist` + `run_hoisted` against `run_batch`, the Galois apply against the
     generic permutation for g = 3 and g = 2n - 1, with their times.  The
     kernel phase holds `ntt_fwd_mac` against its plain version at
     (192, 16384) under the special prime and two decomp moduli, with and
     without a skipped limb, on canonical and random 64-bit input, and at
     n = 1024; `keyswitch_mac` (the default schedule's MAC) against its plain
     version at the engines' broadcast shapes, timed at (6, 2, 32, 16384)
     and at batch 1.  The `kernels` entries of the split kernels carry their launch
     shape from the card (`split`: parts, the MAC's cluster, registers,
     blocks per SM, waves) at every path shape: `ntt_inv` at (32, 16384),
     (64, 16384) (`rows_2B`) and `_INTT`'s (256, 16384), `ntt_fwd_mac` at 192
     and 160 rows (`with_skipped_limb`),
  7. drives `wire_pack`: the main path's 64 ops through the API with
     HEXL_TPU_WIRE_PACK=1 (52-bit words both ways; the host codec the C++
     library's, then NumPy's), every op against the golden model, both
     rates beside the unpacked run's, the bytes each way, the two codecs
     against each other on a batch with values of 2^52 and above,
  8. drives `ckks_path` at the SEAL bridge's configuration (n = 16384,
     moduli of 52, 40 x 5, 52 bits, scale 2^40): encrypt three vectors, then
     on the evaluator multiply_relin, rescale, rotate, add, conjugate,
     add_plain, multiply_plain, each bit for bit against the host
     CkksContext (through the API on the card); hoisted rotations,
     rotate_many fused against unfused, the 16-diagonal BSGS matvec eager,
     fused and replayed from one CUDA graph, bit for bit with each other,
     and the replay again after more key sets than the key cache keeps
     have passed through its level; every result decrypted to noise; the
     kernels against their plain
     versions at this path's shapes; times, launches per op, peak device
     memory and the host's seconds,
  9. drives `bgv_path` (n = 16384, t = 65537, the frozen vector's moduli):
     multiply_relin, the GHS mod switch, rotate against the host BgvContext
     bit for bit, and a hoisted rotation, each decrypted exactly mod t; the
     kernels against their plain versions at this path's shapes,
 10. drives `bfv_path`: a BfvContext over the frozen vector's moduli
     (t = 65537) and its DeviceBfvEvaluator, at the shape of the benchmark's
     cell bfv16384.behz_multiply (n = 16384, the six 52-bit decomp primes,
     batch 8): the level's BehzCuda eager and the evaluator's multiply
     (its CUDA graph replay), bit for bit with each other and with the host
     BehzTool on two batch rows; 3k + 1 ntt_inv, 2k + 1 ntt_fwd, 1
     dyadic_mul, 1 behz_extend and 1 behz_floor_sk launches a multiply,
     counted for a replay too, and
     rns_behz_cuda.GRAPHS counting the replays; multiply_rns on the card
     against the host tool, relinearize and mod_switch_to_next decrypted
     exactly, a rotation on DeviceCkksEvaluator against the host context,
     the noise budget; the kernels against their plain versions at the
     multiply's shapes; ms a batch eager and replayed, the dependent-chain
     rate, peak device memory, the host's seconds,
 11. runs the frozen vector 16384_5_7_6_2_0 (an idle modulus: K > L + 1)
     through the device context against its expected output,
 12. drives `cpp_path`: hexl-fpga.h through the C++ runtime with the port
     registered as its accelerator backend (`cpp_bridge`; the pool created
     with batches of 32 KeySwitch / DyadicMultiply and 256 transforms):
     the main path's 64 KeySwitch ops under the v2 ABI, then under v1
     alone, each against the golden model, on a fresh registration (one key
     upload) and again on the same one (none); two ops accumulating into
     one result within one worksize against the device context applied
     twice; all eight frozen vectors of tests/testdata against their
     expected output; the dyadic path's 64 ops against its oracle; 1024
     _NTT and 1024 _INTT at n = 16384 with the C++ runtime's own tables
     (equal to the port's) against the golden transforms and the round
     trip; the 64 KeySwitch ops again with two C++ workers on the one card
     (NUM_DEV = 2).  No decline, no error, every op served by the backend,
     the launches per served batch (7 / 7 / 6 / 7, 1, 1); the C API's rates
     beside the Python API's, batches by ABI version, the library's build
     seconds,
 13. drives `sharded_path`: the multi-device layer (`parallel/`) with its
     ranks as threads on the one card, each with its own gloo groups: the
     dp NTT (4 ranks, n = 16384, batch 256) against the single card's
     `ntt_fwd` and golden; the sp pair at P = 2 and 4 (batch 32) against
     the single card, the round trip and INTT -> NTT chained on the rank
     tensors; ShardedKeySwitch at mp 4, batch 1, against the vector's
     expected output, at dp 2 x mp 2, batch 32, against the single card's
     body, in BGV mode against the single card's BGV context, and hoisted
     at mp 2 (plain and Galois 5^3) against the single card's run_hoisted;
     before them the kernels at the shapes the phase gives them against
     their plain versions.  Each op runs once to stage, then once counted:
     ms, launches per rank (their sum the counters' total), the
     collectives' calls and ms, bytes handed to gloo and staged through
     host memory, comm_report.  After the profiler, the scaling model's
     block (`parallel/projection.py`) from this run's single-card numbers;
     no scaling is measured (one card).  Also the glue alone, one rank
     then four: 200 small torch ops a rank, then 50 each read back,
 14. drives `process_ranks`: sharded_path's runs again with each rank a
     process of its own (`spawn_ranks`: `python -m` per rank, torch's
     launcher environment, `Mesh.from_env`, a TCPStore held here), spawned
     once for the two-rank runs and once for the four-rank ones, every run
     on meshes of its own prefix, all on cuda:0; every output equal to the
     threaded run's and to its oracle, the launches (each process counts
     its own) to sharded_path's, no child process left after a spawn;
     `ms_ranks_in_processes` beside `ms_ranks_on_one_card` (one card, gloo
     through host memory: not scaling numbers),
 15. drives `examples_path`: every script of examples_torch/ (the seven
     examples and the C++ API's) through its main() on the card, with the
     earlier phases' runtime knobs out of the environment (the multichip
     example spawns four ranks on the card); its printed checks, seconds
     and launches by kernel; before them ntt_fwd and ntt_inv at n = 256 ..
     4096, ntt_fwd_tail at 1024 and 4096 and dyadic_mul at 1024 and 4096,
     at the examples' rows, against their plain versions, and the split
     (C, registers, blocks per SM, waves) at n = 1024 and 4096,
 16. drives `envelope_path`: the kernels at corner shapes (utils/
     sanitize_kernels.py: the split cores at C = 1, 2 and 4, the tail at
     (2, 1024), the MAC's cluster of 2 with and without a skipped limb,
     dyadic_mul at (1, 2, 3, 1024)) against their plain versions; then
     utils/fuzz_card.py's quick grid: ntt_fwd / ntt_inv and _NTT / _INTT
     through the API at n = 1024 .. 32768 under moduli of 20 .. 62 bits
     (the largest prime below 2^62 included) on the reference's corner rows,
     random canonical and random 64-bit rows; KeySwitch at the envelope's
     edges (the smallest width that holds K primes, the K largest primes
     below 2^52) in both schedules and through api.KeySwitch, fuzz_hw.py's
     quick configuration and a BGV one; dyadic_mul at 17 .. 60 bits; every
     configuration against the golden model, every launch of the grid
     against its plain version on the same inputs; it prints each
     configuration's line,
 17. drives `multi_worker`: NUM_DEV = 2 through the Python API on the one
     card: the main path's 64 KeySwitch ops, the dyadic path's 64 ops and
     256 _NTT then 256 _INTT at n = 16384 (batches of 64), every op against
     the golden model; the batches each worker served (both must serve),
     each executor's device, api_ops_per_s beside the NUM_DEV = 1 rates,
     and the launches summed over both workers, equal to the batches times
     the per-batch counts, KeySwitch's replayed from the one context's
     graphs by both workers (no scaling claim: one card).

compute-sanitizer ships with the card's toolkit but refuses its device
("Device not supported"; a plain CUDA program's cudaMalloc then fails), so
no phase runs the kernels under it; utils/sanitize_kernels.py is the program
it would run, and phase 16 runs its shapes.

The launch counters are set to 0 just before each path's counted pass and read
just after it.  Every phase asserts; nothing is caught.  One JSON object per
line; the last line is {"ok": true, "device": {...}}.  Exit code 0 only if all
of it passed.

`main(rehearse=True)` walks the same control flow on the CPU at n = 1024 (and
a few ops at n = 32768; the vector 1024_5_7_6_2_0 for phase 11, the four small
vectors in phase 12, n = 1024 for phases 13 and 14, the examples with
device "cpu", one configuration of each kind at n = 1024 for phase 16)
with the kernels' plain versions (no nvcc build, no kernel comparison, no
timings; the C++ runtime built by g++): a check of the script, not of the
card.  Each phase prints its seconds (`s`).
"""

from __future__ import annotations

import contextlib
import faulthandler
import functools
import importlib
import io
import json
import math
import os
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import hexl_fpga_tpu_torch as hexl
from hexl_fpga_tpu_torch import config as config_mod, cpp_bridge
from hexl_fpga_tpu_torch.integrations import bfv, bgv, ckks
from hexl_fpga_tpu_torch.integrations.ckks import (
    MATVEC_DIAGONALS, MATVEC_N1, SEAL_N, SEAL_SCALE, seal_moduli,
)
from hexl_fpga_tpu_torch.ops import (
    dyadic_cuda, galois_cuda, golden, keyswitch_cuda, nt, ntt_cuda, rns_behz,
    rns_behz_cuda, twiddles, wirepack, word64 as w,
)
from hexl_fpga_tpu_torch.parallel import mesh as mesh_mod, projection, rank_ops, sharded
from hexl_fpga_tpu_torch.parallel.mesh import run_ranks
from hexl_fpga_tpu_torch.runtime import scheduler
from hexl_fpga_tpu_torch.utils import cuda_timing, fuzz_card, keycache, sanitize_kernels, vectors
from hexl_fpga_tpu_torch.utils.cuda_timing import (
    device_table, event_ms as time_ms, rotating, wall_ms,
)

HERE = os.path.dirname(os.path.abspath(__file__))
VECTOR = os.path.join(HERE, "tests", "testdata", "16384_6_7_7_2_0.json.gz")
KERNEL_SRC = "hexl_fpga_tpu_torch/csrc/ntt_kernels.cu"
DYADIC_SRC = "hexl_fpga_tpu_torch/csrc/dyadic_kernels.cu"
BATCH = 32
WORKSIZE = 64
N_VECTOR_OPS = 2  # ops that carry the frozen vector's own operands
PLAIN_MODULUS = 65537  # BGV: coprime to q_k and below every modulus
CHAIN_DEPTH = 4
GALOIS_ELEMENTS = (3, -1)  # a rotation, and the conjugation 2n - 1
BODY_TURNS = 10  # timings of each device body, the order reversed every turn

# the DyadicMultiply path: the reference bench shape
DYADIC_N, DYADIC_MODULI, DYADIC_BITS = 16384, 14, 50
DYADIC_BIGNUM_OPS = 8  # ops checked against the (slow) bignum golden model
# the _NTT / _INTT path: (n, modulus bits, ops, batch); the reference fixture
# runs 4096 ops at n = 16384, 1024 keep the golden check of every op short
NTT_CELLS = ((16384, 52, 1024, 256), (32768, 61, 64, 32))

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
# reference MultMod: the full product, then Barrett (mulhi and mullo)
IMAD_MULT_MOD = 2 * (IMAD_MULHI64 + IMAD_MULLO64)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def larger_bound(nbytes: int, imad: int):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate and
    the 32-bit multiply-adds over their peak rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = imad / PEAK_IMAD32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound(rows: int, n: int, arrays: int, extra_imad_per_coeff: int):
    """(bound_ms, bound_by) for one transform kernel: `arrays` (rows, n) u64
    arrays each read or written once plus the two table rows, against the
    butterflies' and the per-coefficient multiplies' 32-bit multiply-adds."""
    log_n = n.bit_length() - 1
    nbytes = 8 * (arrays * rows * n + 2 * n)
    imad = rows * (n // 2) * log_n * IMAD_LAZY_MUL + rows * n * extra_imad_per_coeff
    return larger_bound(nbytes, imad)


def dyadic_bound(B: int, M: int, n: int):
    """(bound_ms, bound_by) for dyadic_mul: four u64 read and three written
    per (item, modulus, coefficient) plus the (3, M) constants, against four
    MultMods."""
    return larger_bound(56 * B * M * n + 24 * M, B * M * n * 4 * IMAD_MULT_MOD)


def assert_same(name, got, want):
    """Zero tolerance; returns the largest absolute difference (0)."""
    torch.cuda.synchronize()  # a fault inside the kernel surfaces here
    err = int((got - want).abs().max().item())
    assert err == 0, f"{name}: differs from the plain version by up to {err}"
    return err


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
        max_err[name] = max(max_err[name], assert_same(name, got, want))

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

    fwd_in = rotating(lambda: rand_u64(rng, (L * BATCH, n), 53, device), L * BATCH * n * 8)
    inv_in = rotating(lambda: rand_u64(rng, (BATCH, n), 50, device), BATCH * n * 8)
    inv2_in = rotating(lambda: rand_u64(rng, (2 * BATCH, n), 50, device), 2 * BATCH * n * 8)
    tail_in = rotating(lambda: tail_args(0, 2 * BATCH, tabs), 2 * BATCH * n * 8)

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
        profile_later(entry, name, kern)
        entry["split"] = split_fields(name, rows, n)
        if name == "ntt_inv":  # INTT2 runs the same kernel over 2B rows
            inv2 = lambda: ntt_cuda.ntt_inv(inv2_in(), tabs)
            entry["rows_2B"] = {
                "shape": [2 * BATCH, n], "ms": time_ms(inv2, 20),
                "bound_ms": bound(2 * BATCH, n, arrays, extra)[0],
                "split": split_fields(name, 2 * BATCH, n)}
            profile_later(entry["rows_2B"], name, inv2)
        entries.append(entry)
    return entries


# (entry, kernel name, call) whose device_ms / host_ms are taken after the
# paths: once torch.profiler has traced the card, every later launch of the
# process costs the host more, and the paths' launch-bound bodies would feel
# it (PERF.md §6)
PROFILE_LATER = []


def profile_later(entry, name, kern):
    PROFILE_LATER.append((entry, name, kern))


# torch.profiler once saw none of a kernel's 20 launches in a run whose
# counters had every one (PERF.md §7): a profile that misses some is taken
# again, at most this many times in all
PROFILE_ATTEMPTS = 3


def profile_kernels(reps=20):
    """Fill in each PROFILE_LATER entry: the host's enqueue time per call
    (`host_ms`, all taken before the profiler first runs), then the kernels'
    own time per call by torch.profiler (`device_ms`), over reps calls.  The
    port's counters must show one launch a call (the warm-up's included) and
    nothing else, and the profiler must see every launch of one attempt
    (`profiler_attempts`)."""
    for entry, _, kern in PROFILE_LATER:
        entry["host_ms"] = cuda_timing.host_ms(kern, reps)
    for entry, name, kern in PROFILE_LATER:
        for attempt in range(1, PROFILE_ATTEMPTS + 1):
            rank_ops.reset_counts()
            ms, seen = cuda_timing.device_ms(kern, reps, {f"{name}_kernel"})
            assert rank_ops.counts() == {name: reps + 1}, (name, rank_ops.counts())
            if seen == reps:
                break
        assert seen == reps and ms is not None, (name, seen, attempt)
        entry["device_ms"], entry["profiler_attempts"] = ms, attempt


def split_fields(name, rows, n):
    """The parts ntt_cuda.row_split chose for `name` at (rows, n) on the card,
    what the card made of that launch (registers, spills, threads, resident
    blocks per SM), the waves of rows * parts blocks over the card's SMs, and
    the parts the CPU's model of an H100 would choose (the CPU tests' choice)."""
    device = torch.device("cuda", torch.cuda.current_device())
    parts = ntt_cuda.row_split(rows, n, device, name)
    info = ntt_cuda.split_info(name, n, parts, device.index)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return {"parts": parts, "stages_per_pass": ntt_cuda.SPLIT_R, **info,
            "sms": sms, "waves": rows * parts / (sms * info["blocks_per_sm"]),
            "cpu_model_parts": ntt_cuda.row_split(rows, n, kernel=name)}


def mac_fields(B, limbs, n):
    """ntt_fwd_mac's launch shape for B rows summed over `limbs` limbs on the
    card (mac_split: parts, cluster), what the card made of it, the waves of
    its B * parts * cluster blocks, and the CPU model's choice."""
    device = torch.device("cuda", torch.cuda.current_device())
    parts, cluster = ntt_cuda.mac_split(B, limbs, n, device)
    info = ntt_cuda.split_info("ntt_fwd_mac", n, parts, device.index,
                               cluster=cluster)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return {"parts": parts, "cluster": cluster, "limbs_per_block": -(-limbs // cluster),
            "stages_per_pass": ntt_cuda.SPLIT_R, **info, "sms": sms,
            "waves": B * parts * cluster / (sms * info["blocks_per_sm"]),
            "cpu_model": list(ntt_cuda.mac_split(B, limbs, n))}


# the split sweep: n with its rows, moduli of 30 and 61 bits, 53-bit and
# any-u64 input
SWEEP_N = ((4, (1, 5)), (8, (5,)), (16, (5,)), (64, (5,)), (1024, (5,)),
           (2048, (5,)), (4096, (5,)), (8192, (5, 64)),
           (16384, (1, 5, 32, 64, 192, 256)), (32768, (1, 5, 32)))


def mac_sweep_keys(rng, n, q, L, device):
    """(keys, precons) of shape (L, 2, 1, n) under q, for the sweep."""
    keys = rng.integers(0, q, size=(L, 2, 1, n), dtype=np.uint64)
    precons = ((keys.astype(object) << 64) // q).astype(np.uint64)  # any q < 2^62
    return w.from_u64_np(keys, device), w.from_u64_np(precons, device)


def check_split_sweep(device):
    """ntt_fwd, ntt_fwd_tail, ntt_inv and ntt_fwd_mac against their plain
    versions over SWEEP_N, both moduli and both inputs, at the wrappers' own
    launch shape and at every other parts a row of n can take (C pieces of
    at least 2 values that fit one block's shared memory; the MAC also
    at every cluster of blocks sharing its limbs, with no limb, the first or
    the last skipped; 6 limbs of 32 rows at 192 rows, 5 limbs of one row at
    5); returns the count of comparisons (each 0)."""
    rng = np.random.default_rng(404)
    cases = 0
    for n, rows_list in SWEEP_N:
        for bits in (30, 61):
            q = int(nt.generate_primes(1, bits, n)[0])
            tabs = ntt_cuda.modulus_tables(n, q, device=device)
            for rows in rows_list:
                for in_bits in (53, 64):
                    x = rand_u64(rng, (rows, n), in_bits, device)
                    msf = int(rng.integers(1, q))
                    tail = (x, rand_u64(rng, (rows, n), 64, device),
                            w.from_u64_np(rng.integers(0, q, size=(rows, n),
                                                       dtype=np.uint64), device),
                            tabs, q - 12345, msf, (msf << 64) // q)
                    want = ntt_cuda.ntt_fwd_plain(x, tabs)
                    want_tail = ntt_cuda.ntt_fwd_tail_plain(*tail)
                    want_inv = ntt_cuda.ntt_inv_plain(x, tabs)
                    assert_same("ntt_fwd", ntt_cuda.ntt_fwd(x, tabs), want)
                    assert_same("ntt_fwd_tail", ntt_cuda.ntt_fwd_tail(*tail), want_tail)
                    assert_same("ntt_inv", ntt_cuda.ntt_inv(x, tabs), want_inv)
                    cases += 3
                    if rows not in (5, 192):
                        continue
                    for parts in (1, 2, 4):
                        if 2 * parts > n or not ntt_cuda.piece_fits(n, parts):
                            continue
                        assert_same(f"ntt_fwd parts={parts}",
                                    ntt_cuda.ntt_fwd(x, tabs, parts), want)
                        assert_same(f"ntt_fwd_tail parts={parts}",
                                    ntt_cuda.ntt_fwd_tail(*tail, parts=parts),
                                    want_tail)
                        assert_same(f"ntt_inv parts={parts}",
                                    ntt_cuda.ntt_inv(x, tabs, parts), want_inv)
                        cases += 3
                    cases += check_mac_sweep(rng, x, tabs, device)
    return cases


def check_mac_sweep(rng, data, tabs, device):
    """ntt_fwd_mac on `data` as 6 limbs (192 rows) or 5 (5 rows), with no
    limb, the first or the last skipped, at its own launch shape and at every
    parts and cluster; returns the count of comparisons."""
    n = tabs.n
    L = 6 if data.shape[0] == 192 else data.shape[0]
    keys, kp = mac_sweep_keys(rng, n, tabs.q, L, device)
    shapes = [p for p in (1, 2, 4) if 2 * p <= n and ntt_cuda.mac_chunk(n, p, 2) >= 1]
    cases = 0
    for skip in (None, 0, L - 1):
        limbs = L - (skip is not None)
        want = ntt_cuda.ntt_fwd_mac_plain(data, keys, kp, 0, tabs, skip)
        got = ntt_cuda.ntt_fwd_mac(data, keys, kp, 0, tabs, skip)
        assert int(got.max()) < 2 * limbs * tabs.q, "lazy sum out of range"
        assert_same("ntt_fwd_mac", got, want)
        cases += 1
        for parts in shapes:
            for cluster in sorted({1, 2, limbs}):
                assert_same(f"ntt_fwd_mac parts={parts} cluster={cluster}",
                            ntt_cuda.ntt_fwd_mac(data, keys, kp, 0, tabs, skip,
                                                 parts, cluster), want)
                cases += 1
    return cases


def mac_bound(limbs: int, B: int, n: int, comp: int):
    """(bound_ms, bound_by) for ntt_fwd_mac over `limbs` summed source limbs:
    the data rows, the key and precon columns and the two table rows read
    once and out written once, against the butterflies plus one Barrett and
    `comp` lazy multiplies per coefficient and limb."""
    log_n = n.bit_length() - 1
    nbytes = 8 * (limbs * B * n + 2 * limbs * comp * n + comp * B * n + 2 * n)
    imad = limbs * B * ((n // 2) * log_n * IMAD_LAZY_MUL
                        + n * (IMAD_BARRETT + comp * IMAD_LAZY_MUL))
    return larger_bound(nbytes, imad)


def check_mac_kernel(vec, device):
    """ntt_fwd_mac against its plain version, then its times; returns its
    `kernels` entry."""
    n, L, K = vec.coeff_count, vec.decomp_modulus_size, vec.key_modulus_size
    ctx = keyswitch_cuda.get_context(
        n, L, K, vec.rns_modulus_size, 2, vec.moduli, vec.twiddle_factors,
        device=device,
    )
    keys, kp = ctx.device_keys(vec.key_vectors)
    rng = np.random.default_rng(8)
    err = 0

    def same(data, keys, kp, j, tabs, skip_i):
        got = ntt_cuda.ntt_fwd_mac(data, keys, kp, j, tabs, skip_i)
        want = ntt_cuda.ntt_fwd_mac_plain(data, keys, kp, j, tabs, skip_i)
        limbs = keys.shape[0] - (skip_i is not None)
        assert int(got.max()) < 2 * limbs * tabs.q, "lazy sum out of range"
        return assert_same("ntt_fwd_mac", got, want)

    # the special engine (column K - 1, nothing skipped) and decomp engines
    # with the first and the last limb skipped; canonical and any-u64 input
    for bits in (50, 64):
        data = rand_u64(rng, (L * BATCH, n), bits, device)
        for j, skip_i in ((K - 1, None), (0, 0), (L - 1, L - 1)):
            err = max(err, same(data, keys, kp, j, ctx._tabs[j], skip_i))
    # a small n under small moduli, K > L + 1
    small_q = [int(q) for q in nt.generate_primes(4, 30, 1024)]
    sk = np.stack([rng.integers(0, q, size=(2, 2, 1024), dtype=np.uint64)
                   for q in small_q], axis=2)
    sp = np.stack([w.precon64_np(sk[:, :, j], q) for j, q in enumerate(small_q)],
                  axis=2)
    sk, sp = w.from_u64_np(sk, device), w.from_u64_np(sp, device)
    data = rand_u64(rng, (2 * 5, 1024), 64, device)
    for j, skip_i in ((3, None), (1, 1), (0, 0)):
        tabs = ntt_cuda.modulus_tables(1024, small_q[j], device=device)
        err = max(err, same(data, sk, sp, j, tabs, skip_i))

    sp_j = K - 1
    tabs = ctx._tabs[sp_j]
    ins = rotating(lambda: rand_u64(rng, (L * BATCH, n), 53, device),
                   L * BATCH * n * 8)
    b_ms, b_by = mac_bound(L, BATCH, n, 2)
    mac = lambda: ntt_cuda.ntt_fwd_mac(ins(), keys, kp, sp_j, tabs)
    skip = lambda: ntt_cuda.ntt_fwd_mac(ins(), keys, kp, 0, ctx._tabs[0], 0)
    entry = {
        "name": "ntt_fwd_mac", "route": "cuda", "source": KERNEL_SRC,
        "replaces": "hexl_fpga_tpu/ops/ntt_mxu_pallas.py:520",
        "shape": [L * BATCH, n], "launches": None, "max_abs_err": err,
        "ms": time_ms(mac, 20),
        "plain_ms": time_ms(
            lambda: ntt_cuda.ntt_fwd_mac_plain(ins(), keys, kp, sp_j, tabs), 3),
        "bound_ms": b_ms, "bound_by": b_by,
        # no single PyTorch call computes a modular NTT or a modular MAC
        "library_ms": None,
        "split": mac_fields(BATCH, L, n),
        # a decomp engine: its own limb is the caller's
        "with_skipped_limb": {
            "shape": [(L - 1) * BATCH, n], "ms": time_ms(skip, 20),
            "bound_ms": mac_bound(L - 1, BATCH, n, 2)[0],
            "split": mac_fields(BATCH, L - 1, n)},
    }
    profile_later(entry, "ntt_fwd_mac", mac)
    profile_later(entry["with_skipped_limb"], "ntt_fwd_mac", skip)
    return entry


def keyswitch_mac_bound(limbs: int, Bv: int, Bk: int, comp: int, n: int):
    """(bound_ms, bound_by) for keyswitch_mac: the limbs, the key and precon
    rows and the sums each read or written once, against `limbs` lazy terms
    (a 64-bit low product and three 32x32 partials of the quotient) per
    output and one close."""
    B = max(Bv, Bk)
    nbytes = 8 * (limbs * Bv * n + 2 * limbs * comp * Bk * n + comp * B * n)
    imad = comp * B * n * (limbs * (IMAD_MULLO64 + 3) + IMAD_MULLO64)
    return larger_bound(nbytes, imad)


def check_keyswitch_mac_kernel(vec, device):
    """keyswitch_mac against its plain version at the engines' shapes (a key
    row for the batch; one per batch row; one source row for S key rows; the
    identity limb's strided view; an operand 8 bytes off 16), on canonical
    and any-u64 limbs, each sum below 28q; then its times at (L, 2, BATCH, n)
    and at batch 1; returns its `kernels` entry."""
    n, L, K = vec.coeff_count, vec.decomp_modulus_size, vec.key_modulus_size
    ctx = keyswitch_cuda.get_context(
        n, L, K, vec.rns_modulus_size, 2, vec.moduli, vec.twiddle_factors,
        device=device,
    )
    keys, kp = ctx.device_keys(vec.key_vectors)
    rng = np.random.default_rng(18)
    err = 0
    col = lambda x, j, rows=slice(None): x[rows, :, j, None, :]

    def same(val, key, p, q):
        got = ntt_cuda.keyswitch_mac(val, key, p, q)
        assert int(got.min()) >= 0 and int(got.max()) < 28 * q, "lazy sum out of range"
        return assert_same("keyswitch_mac", got, ntt_cuda.keyswitch_mac_plain(val, key, p, q))

    for bits in (50, 64):
        val = rand_u64(rng, (L, BATCH, n), bits, device)
        for j in (K - 1, 0):
            q = ctx.moduli[j]
            err = max(err, same(val, col(keys, j), col(kp, j), q))
            err = max(err, same(val[:, :1], col(keys, j), col(kp, j), q))  # batch 1
        t = rand_u64(rng, (BATCH, L, n), bits, device)  # the identity limb
        err = max(err, same(t[:, 1, :][None], col(keys, 1, slice(1, 2)),
                             col(kp, 1, slice(1, 2)), ctx.moduli[1]))
    q = ctx.moduli[0]
    rk = rng.integers(0, q, size=(L, 2, BATCH, n), dtype=np.uint64)
    rkd, rpd = w.from_u64_np(rk, device), w.from_u64_np(w.precon64_np(rk, q), device)
    val = rand_u64(rng, (L, BATCH, n), 64, device)
    err = max(err, same(val, rkd, rpd, q))                  # a key row per batch row
    err = max(err, same(val[:, :1], rkd, rpd, q))           # one source row, S keys
    flat = torch.empty(val.numel() + 1, dtype=torch.int64, device=device)
    off = flat[1:].view_as(val)
    off.copy_(val)
    err = max(err, same(off, col(keys, 0), col(kp, 0), q))  # one-word accesses

    sp_j = K - 1
    q = ctx.moduli[sp_j]
    key, p = col(keys, sp_j), col(kp, sp_j)
    ins = rotating(lambda: rand_u64(rng, (L, BATCH, n), 52, device), L * BATCH * n * 8)
    one = rotating(lambda: rand_u64(rng, (L, 1, n), 52, device), L * n * 8)
    mac = lambda: ntt_cuda.keyswitch_mac(ins(), key, p, q)
    mac1 = lambda: ntt_cuda.keyswitch_mac(one(), key, p, q)
    b_ms, b_by = keyswitch_mac_bound(L, BATCH, 1, 2, n)
    entry = {
        "name": "keyswitch_mac", "route": "cuda", "source": KERNEL_SRC,
        "replaces": "torch glue: the reference's XLA composition, "
                    "hexl_fpga_tpu/ops/keyswitch_tpu.py:226 _mac_term, :243 _mac_close",
        "shape": [L, 2, BATCH, n], "launches": None, "max_abs_err": err,
        "ms": time_ms(mac, 20),
        "plain_ms": time_ms(lambda: ntt_cuda.keyswitch_mac_plain(ins(), key, p, q), 3),
        "bound_ms": b_ms, "bound_by": b_by,
        # no single PyTorch call computes a modular MAC
        "library_ms": None,
        "batch_1": {
            "shape": [L, 2, 1, n], "ms": time_ms(mac1, 20),
            "plain_ms": time_ms(lambda: ntt_cuda.keyswitch_mac_plain(one(), key, p, q), 3),
            "bound_ms": keyswitch_mac_bound(L, 1, 1, 2, n)[0]},
    }
    profile_later(entry, "keyswitch_mac", mac)
    profile_later(entry["batch_1"], "keyswitch_mac", mac1)
    return entry


def dyadic_moduli():
    return [int(q) for q in nt.generate_primes(DYADIC_MODULI, DYADIC_BITS, DYADIC_N)]


def ramp_operands(num_moduli, n, b=0):
    """One op of the reference's ramp stimulus
    (`tests/test_dyadic_multiply.cpp:32-109`): moduli 10, 20, 30, ... and raw
    operands far beyond 4q, shaped (2, M, n)."""
    i = np.arange(n, dtype=np.uint64)
    rows = lambda off: np.stack(
        [np.uint64(b + off) + i + np.uint64(m * n) for m in range(num_moduli)])
    moduli = [(b + m + 1) * 10 for m in range(num_moduli)]
    return moduli, np.stack([rows(1), rows(11)]), np.stack([rows(2), rows(22)])


def check_dyadic_kernel(device):
    """dyadic_mul against its plain version, then its times; returns its
    `kernels` entry."""
    B, M, n = BATCH, DYADIC_MODULI, DYADIC_N
    moduli = dyadic_moduli()
    runner = dyadic_cuda.runner(moduli, device)
    rng = np.random.default_rng(4)
    qcol = np.array(moduli, dtype=np.uint64).reshape(1, 1, M, 1)

    def operands(factor=None):
        """(B, 2, M, n) operands: below factor * q, or any u64."""
        a = rng.integers(0, 1 << 64, size=(B, 2, M, n), dtype=np.uint64)
        if factor is not None:
            a %= np.uint64(factor) * qcol
        return w.from_u64_np(a, device)

    def same(r, x, y):
        return assert_same("dyadic_mul", r.run(x, y),
                           dyadic_cuda.dyadic_multiply_plain(x, y, r.meta))

    err = 0
    for factor in (1, 4, None):
        err = max(err, same(runner, operands(factor), operands(factor)))
    # the ramp over the composite moduli 10, 20, 30 at n = 64, and len = 0
    q, a, b = ramp_operands(3, 64)
    small = [(q, a[None], b[None])]
    for q in ([2, 3], [3, 10, 2]):
        shape = (3, 2, len(q), 100)
        small.append((q, rng.integers(0, 64, size=shape, dtype=np.uint64),
                      rng.integers(0, 1 << 64, size=shape, dtype=np.uint64)))
    for q, a, b in small:
        r = dyadic_cuda.runner(q, device)
        x, y = w.from_u64_np(a, device), w.from_u64_np(b, device)
        err = max(err, same(r, x, y))
    want = golden.dyadic_multiply(small[0][1][0], small[0][2][0], 64, small[0][0], 3)
    got = dyadic_cuda.dyadic_multiply_np(small[0][1][0], small[0][2][0], 64,
                                         small[0][0], 3, device=device)
    np.testing.assert_array_equal(got, want)

    ins = rotating(lambda: (operands(1), operands(1)), 2 * B * 2 * M * n * 8)
    b_ms, b_by = dyadic_bound(B, M, n)
    run = lambda: runner.run(*ins())
    entry = {
        "name": "dyadic_mul", "route": "cuda", "source": DYADIC_SRC,
        "replaces": "hexl_fpga_tpu/ops/dyadic_pallas.py:129",
        "shape": [B, 2, M, n], "launches": None, "max_abs_err": err,
        "ms": time_ms(run, 20),
        "plain_ms": time_ms(
            lambda: dyadic_cuda.dyadic_multiply_plain(*ins(), runner.meta), 3),
        "bound_ms": b_ms, "bound_by": b_by,
        # no single PyTorch call computes a 64-bit modular product
        "library_ms": None,
    }
    profile_later(entry, "dyadic_mul", run)
    return entry


def transform_entry(name, replaces, rows, n, extra_imad, kern, plain, err):
    b_ms, b_by = bound(rows, n, 2, extra_imad)
    entry = {
        "name": name, "route": "cuda", "source": KERNEL_SRC,
        "replaces": replaces, "shape": [rows, n], "launches": None,
        "max_abs_err": err,
        "ms": time_ms(kern, 20), "plain_ms": time_ms(plain, 3),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None,  # no single PyTorch call computes a modular NTT
    }
    profile_later(entry, name, kern)
    if name in ("ntt_fwd", "ntt_inv"):
        entry["split"] = split_fields(name, rows, n)
    return entry


def check_standalone_transforms(device):
    """The standalone transform pair at the _NTT/_INTT path's shapes: at
    (32, 32768) under a 61-bit prime, where a row takes 2 or 4 blocks, each
    kernel against its plain version at its own launch shape and at every C
    (canonical and any-u64 input), with its `kernels` entry; and the times of
    the same kernels at the path's (256, 16384)."""
    rng = np.random.default_rng(6)
    entries, at_path_shape = [], []
    for n, bits, _, rows in NTT_CELLS:
        q = int(nt.generate_primes(1, bits, n)[0])
        tabs = ntt_cuda.modulus_tables(n, q, device=device)
        err = {"ntt_fwd": 0, "ntt_inv": 0}
        parts = ntt_cuda.split_candidates(n)
        for x in (
            w.from_u64_np(rng.integers(0, q, size=(rows, n), dtype=np.uint64), device),
            rand_u64(rng, (3, n), 64, device),
        ):
            for name, fn, plain in (
                ("ntt_fwd", ntt_cuda.ntt_fwd, ntt_cuda.ntt_fwd_plain),
                ("ntt_inv", ntt_cuda.ntt_inv, ntt_cuda.ntt_inv_plain),
            ):
                want = plain(x, tabs)
                before = dict(ntt_cuda.LAUNCHES)
                err[name] = max(err[name], assert_same(name, fn(x, tabs), want))
                # one launch of the kernel, nothing else
                assert {k: v - before[k] for k, v in ntt_cuda.LAUNCHES.items()} == {
                    k: int(k == name) for k in before}, (name, n)
                for c in parts:
                    err[name] = max(err[name], assert_same(
                        f"{name} parts={c}", fn(x, tabs, c), want))
        ins = rotating(
            lambda: w.from_u64_np(
                rng.integers(0, q, size=(rows, n), dtype=np.uint64), device),
            rows * n * 8)
        # the calls bind this cell's inputs and tables: they run again after
        # the loop (profile_later)
        call = lambda fn, ins=ins, tabs=tabs: lambda: fn(ins(), tabs)
        made = [
            transform_entry(
                "ntt_fwd", "hexl_fpga_tpu/ops/ntt_pallas.py:179", rows, n,
                IMAD_BARRETT, call(ntt_cuda.ntt_fwd),
                call(ntt_cuda.ntt_fwd_plain), err["ntt_fwd"]),
            transform_entry(
                "ntt_inv", "hexl_fpga_tpu/ops/ntt_pallas.py:200", rows, n,
                IMAD_BARRETT + IMAD_LAZY_MUL // 2, call(ntt_cuda.ntt_inv),
                call(ntt_cuda.ntt_inv_plain), err["ntt_inv"]),
        ]
        for entry in made:
            entry["parts_compared"] = parts
        (entries if n > 16384 else at_path_shape).extend(made)
    return entries, at_path_shape


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


def keyswitch_launches(L, batches=1):
    """The default schedule's kernel launches for `batches` KeySwitch bodies."""
    return {"ntt_fwd": (L + 1) * batches, "ntt_inv": (L + 1) * batches,
            "ntt_fwd_tail": L * batches, "keyswitch_mac": (L + 1) * batches}


def keyswitch_bodies(before):
    """dispatch_batch's bodies since `before`, a copy of keyswitch_cuda.GRAPHS:
    (served, counts), where an eager body or a replay serves a batch."""
    d = {k: v - before[k] for k, v in keyswitch_cuda.GRAPHS.items()}
    return d["eager"] + d["replays"], d


def golden_ops(vec):
    """The main path's WORKSIZE operand pairs and their golden outputs (the
    wire_pack phase drives the same ops); returns (ops, want, seconds)."""
    n, L, K = vec.coeff_count, vec.decomp_modulus_size, vec.key_modulus_size
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
    return ops, want, golden_s


def main_path(vec, device, rehearse, ops, want, golden_s):
    n, L, K = vec.coeff_count, vec.decomp_modulus_size, vec.key_modulus_size
    start_runtime(rehearse, BATCH_SIZE_KEYSWITCH=BATCH)

    # a first pass stages keys and tables; the second is the counted one
    first, _ = drive_api(vec, ops)
    ntt_cuda.reset_launch_counts()
    graphs = dict(keyswitch_cuda.GRAPHS)
    results, wall_s = drive_api(vec, ops)
    served, graphs = keyswitch_bodies(graphs)
    launches = {k: ntt_cuda.LAUNCHES[k]
                for k in ("ntt_fwd", "ntt_inv", "ntt_fwd_tail", "keyswitch_mac")}
    assert sum(ntt_cuda.LAUNCHES.values()) == sum(launches.values())
    hexl.release_FPGA_resources()

    for i, exp in enumerate(want):
        np.testing.assert_array_equal(first[i], exp, err_msg=f"first pass, op {i}")
        np.testing.assert_array_equal(results[i], exp, err_msg=f"op {i}")
    batches = WORKSIZE // BATCH
    assert served == batches, (graphs, batches)
    expected = keyswitch_launches(L, batches)
    if rehearse:
        assert launches == dict.fromkeys(expected, 0), launches
    else:
        # the first pass ran the key eager, then captured: this one replays
        assert graphs["replays"] == batches, graphs
        assert launches == expected, (launches, expected)

    out = {
        "config": vec.config_name, "ops": WORKSIZE, "batch": BATCH,
        "ops_checked_vs_golden": len(want),
        "ops_checked_vs_frozen_vector": N_VECTOR_OPS,
        "golden_s": golden_s, "launches": launches, "graphs": graphs,
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


# the executor's copy stream: KeySwitch batches through the API, the copy
# back of each overlapping the next batch's body
OVERLAP_BATCHES = 3


def copy_overlap_path(vec, device, rehearse):
    """OVERLAP_BATCHES * BATCH KeySwitch ops through the API in batches of
    BATCH, with the executor's timing events on (`TorchExecutor.timeline`):
    on the card's clock, from the first body's start, each batch's body
    (start, end) on the compute stream and its copy back (start, end) on the
    copy stream, and how long the copy back of batch i-1 overlaps body i.
    Every op is checked against the device context's own batch (the body
    the main path holds to the golden model).  Fails if a copy back starts
    only after the next batch's body ends."""
    n, L, K = vec.coeff_count, vec.decomp_modulus_size, vec.key_modulus_size
    keyed = (vec.key_vectors, vec.modswitch_factors)
    ops = make_ops(vec, OVERLAP_BATCHES * BATCH, seed=13)
    ctx = keyswitch_cuda.get_context(
        n, L, K, vec.rns_modulus_size, 2, vec.moduli, vec.twiddle_factors,
        device=device,
    )
    want = np.concatenate([
        ctx.run_batch(np.stack([r for r, _ in ops[i:i + BATCH]]),
                      np.stack([t for _, t in ops[i:i + BATCH]]), *keyed)
        for i in range(0, len(ops), BATCH)])

    start_runtime(rehearse, BATCH_SIZE_KEYSWITCH=BATCH)
    drive_api(vec, ops[:BATCH])  # the runtime's first batch, not timed
    executor = scheduler.pool().devices[0].executor
    executor.timeline = []
    ntt_cuda.reset_launch_counts()
    graphs = dict(keyswitch_cuda.GRAPHS)
    results, wall_s = drive_api(vec, ops)
    served, graphs = keyswitch_bodies(graphs)
    launches = {k: v for k, v in ntt_cuda.LAUNCHES.items() if v}
    hexl.release_FPGA_resources()

    for i, exp in enumerate(want):
        np.testing.assert_array_equal(results[i], exp, err_msg=f"op {i}")
    assert served == OVERLAP_BATCHES, graphs
    expected = {} if rehearse else keyswitch_launches(L, OVERLAP_BATCHES)
    assert launches == expected, (launches, expected)
    out = {"config": vec.config_name, "ops": len(ops), "batch": BATCH,
           "ops_checked_vs_device_batch": len(ops), "launches": launches,
           "graphs": graphs}
    if rehearse:  # the CPU has no streams
        assert executor.timeline == []
        return out
    torch.cuda.synchronize()
    marks = executor.timeline
    assert len(marks) == OVERLAP_BATCHES, len(marks)
    t0 = marks[0][0]
    # per batch: body start, body end, copy-back start, copy-back end
    ms = [[t0.elapsed_time(e) for e in m] for m in marks]
    overlap = []
    for i in range(1, OVERLAP_BATCHES):
        (b0, b1, _, _), (_, _, c0, c1) = ms[i], ms[i - 1]
        assert c0 < b1, (f"the copy back of batch {i - 1} starts at {c0} ms, "
                         f"after body {i} ends at {b1} ms")
        overlap.append(max(0.0, min(b1, c1) - max(b0, c0)))
    out.update(timeline_ms=ms, copy_overlap_ms=overlap,
               api_ops_per_s=len(ops) / wall_s)
    return out


# ---------------------------------------------------------------------------
# phase 4: the DyadicMultiply path
# ---------------------------------------------------------------------------


def start_runtime(rehearse, **batch_env):
    for k, v in batch_env.items():
        os.environ[k] = str(v)
    os.environ["RUN_CHOICE"] = "1" if rehearse else "2"
    config_mod.reset_config()
    hexl.acquire_FPGA_resources()


def harvey_mul_mod(x, y, q):
    """(x * y) mod q for canonical u64 arrays, vectorised: Harvey's product
    with a per-element precon, not the kernel's Barrett."""
    r = golden.mul_mod_lazy64(x, y, w.precon64_np(y, q), q)
    return np.where(r >= np.uint64(q), r - np.uint64(q), r)


def dyadic_oracle(op1, op2, moduli):
    """(ops, 2, M, n) canonical operands -> (ops, 3, M, n), by harvey_mul_mod."""
    out = np.empty((op1.shape[0], 3) + op1.shape[2:], dtype=np.uint64)
    for m, q in enumerate(moduli):
        x0, x1, y0, y1 = op1[:, 0, m], op1[:, 1, m], op2[:, 0, m], op2[:, 1, m]
        out[:, 0, m] = harvey_mul_mod(x0, y0, q)
        s = harvey_mul_mod(x0, y1, q) + harvey_mul_mod(x1, y0, q)
        out[:, 1, m] = np.where(s >= np.uint64(q), s - np.uint64(q), s)
        out[:, 2, m] = harvey_mul_mod(x1, y1, q)
    return out


def drive_dyadic(op1, op2, n, moduli):
    M = len(moduli)
    results = [np.zeros(3 * M * n, dtype=np.uint64) for _ in range(len(op1))]
    t0 = time.perf_counter()
    hexl.set_worksize_DyadicMultiply(len(op1))
    for res, a, b in zip(results, op1, op2):
        hexl.DyadicMultiply(res, a.reshape(-1), b.reshape(-1), n, moduli, M)
    assert hexl.DyadicMultiplyCompleted()
    return results, time.perf_counter() - t0


@functools.lru_cache(maxsize=1)
def dyadic_data(rehearse):
    """The DyadicMultiply path's WORKSIZE operand pairs (n, moduli, op1, op2)
    and their oracle outputs (want, seconds); cpp_path drives the same."""
    n = 1024 if rehearse else DYADIC_N
    M = DYADIC_MODULI
    moduli = [int(q) for q in nt.generate_primes(M, DYADIC_BITS, n)]
    rng = np.random.default_rng(21)
    qcol = np.array(moduli, dtype=np.uint64).reshape(1, 1, M, 1)
    op1 = rng.integers(0, 1 << 63, size=(WORKSIZE, 2, M, n), dtype=np.uint64) % qcol
    op2 = rng.integers(0, 1 << 63, size=(WORKSIZE, 2, M, n), dtype=np.uint64) % qcol

    t0 = time.perf_counter()
    want = dyadic_oracle(op1, op2, moduli)
    for i in range(DYADIC_BIGNUM_OPS):
        np.testing.assert_array_equal(
            want[i].reshape(-1), golden.dyadic_multiply(op1[i], op2[i], n, moduli, M),
            err_msg=f"oracles disagree, op {i}")
    return n, moduli, op1, op2, want, time.perf_counter() - t0


def dyadic_path(device, rehearse):
    n, moduli, op1, op2, want, oracle_s = dyadic_data(rehearse)
    M = len(moduli)

    start_runtime(rehearse, BATCH_SIZE_DYADIC_MULTIPLY=BATCH)
    first, _ = drive_dyadic(op1, op2, n, moduli)  # uploads the constants
    dyadic_cuda.reset_launch_counts()
    results, wall_s = drive_dyadic(op1, op2, n, moduli)
    launches = dict(dyadic_cuda.LAUNCHES)
    hexl.release_FPGA_resources()

    for i in range(WORKSIZE):
        np.testing.assert_array_equal(first[i], want[i].reshape(-1),
                                      err_msg=f"first pass, op {i}")
        np.testing.assert_array_equal(results[i], want[i].reshape(-1),
                                      err_msg=f"op {i}")
    assert launches == {"dyadic_mul": 0 if rehearse else WORKSIZE // BATCH}, launches

    out = {
        "n": n, "moduli": M, "modulus_bits": DYADIC_BITS, "ops": WORKSIZE,
        "batch": BATCH, "ops_checked_vs_harvey_oracle": WORKSIZE,
        "ops_checked_vs_bignum_golden": DYADIC_BIGNUM_OPS,
        "oracle_s": oracle_s, "launches": launches,
    }
    if not rehearse:
        out["api_ops_per_s"] = WORKSIZE / wall_s
        runner = dyadic_cuda.runner(moduli, device)
        x = w.from_u64_np(op1[:BATCH], device)
        y = w.from_u64_np(op2[:BATCH], device)
        body_ms = time_ms(lambda: runner.run(x, y), 10)
        out["body_ms_per_batch"] = body_ms
        out["body_ops_per_s"] = BATCH / body_ms * 1e3
        out["device_bytes_operands_in_per_batch"] = (x.numel() + y.numel()) * 8
        out["device_bytes_results_out_per_batch"] = BATCH * 3 * M * n * 8
    return out


# ---------------------------------------------------------------------------
# phase 5: the _NTT / _INTT path
# ---------------------------------------------------------------------------


def drive_transform(ops, call, set_worksize, completed):
    """Transform copies of `ops` in place through the deprecated API section;
    returns them and the wall seconds."""
    bufs = [o.copy() for o in ops]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        t0 = time.perf_counter()
        set_worksize(len(bufs))
        for b in bufs:
            call(b)
        assert completed()
    return bufs, time.perf_counter() - t0


@functools.lru_cache(maxsize=2)
def ntt_data(n, bits, count):
    """`count` operands at (n, one prime of `bits` bits), the modulus, its
    tables and the golden forward transforms (the inverse checked to give
    the operands back); cpp_path drives the n = 16384 cell's."""
    q = int(nt.generate_primes(1, bits, n)[0])
    t = twiddles.ntt_tables(n, q)
    rng = np.random.default_rng(n)
    src = rng.integers(0, q, size=(count, n), dtype=np.uint64)
    t0 = time.perf_counter()
    want_fwd = golden.fwd_ntt(src, q, t)
    want_inv = golden.inv_ntt(want_fwd, q, t)
    np.testing.assert_array_equal(want_inv, src)
    return q, t, src, want_fwd, time.perf_counter() - t0


def ntt_cell(device, rehearse, n, bits, count, batch):
    """`count` _NTT ops, then `count` _INTT ops on their results, at (n, one
    prime of `bits` bits) with the caller's tables, in batches of `batch`."""
    q, t, src, want_fwd, golden_s = ntt_data(n, bits, count)

    start_runtime(rehearse, BATCH_SIZE_NTT=batch, BATCH_SIZE_INTT=batch)
    fwd = lambda b: hexl._NTT(b, t.fwd, t.fwd_precon, q, n)
    inv = lambda b: hexl._INTT(b, t.inv, t.inv_precon, q, t.inv_n, t.inv_n_w, n)
    # a first pass uploads the caller's tables; the second is the counted one
    drive_transform(src[:batch], fwd, hexl._set_worksize_NTT, hexl._NTTCompleted)
    drive_transform(src[:batch], inv, hexl._set_worksize_INTT, hexl._INTTCompleted)
    ntt_cuda.reset_launch_counts()
    got_fwd, fwd_s = drive_transform(
        src, fwd, hexl._set_worksize_NTT, hexl._NTTCompleted)
    got_inv, inv_s = drive_transform(
        got_fwd, inv, hexl._set_worksize_INTT, hexl._INTTCompleted)
    launches = {k: v for k, v in ntt_cuda.LAUNCHES.items() if v}
    hexl.release_FPGA_resources()

    np.testing.assert_array_equal(np.stack(got_fwd), want_fwd)
    np.testing.assert_array_equal(np.stack(got_inv), src)  # the round trip
    expected = {} if rehearse else dict.fromkeys(("ntt_fwd", "ntt_inv"), count // batch)
    assert launches == expected, (launches, expected)

    out = {
        "n": n, "modulus_bits": bits, "ops_each_way": count, "batch": batch,
        "ops_checked_vs_golden": 2 * count, "golden_s": golden_s,
        "launches": launches,
    }
    if not rehearse:
        out["ntt_api_ops_per_s"] = count / fwd_s
        out["intt_api_ops_per_s"] = count / inv_s
        ft = ntt_cuda.caller_fwd_tables(n, q, t.fwd, t.fwd_precon, device=device)
        it = ntt_cuda.caller_inv_tables(n, q, t.inv, t.inv_precon, t.inv_n,
                                        t.inv_n_w, device=device)
        x = w.from_u64_np(src[:batch], device)
        out["fwd_body_ms_per_batch"] = time_ms(lambda: ntt_cuda.ntt_fwd(x, ft), 10)
        out["inv_body_ms_per_batch"] = time_ms(lambda: ntt_cuda.ntt_inv(x, it), 10)
        out["device_bytes_operands_in_per_batch"] = x.numel() * 8
        out["device_bytes_results_out_per_batch"] = x.numel() * 8
        out["device_bytes_tables"] = ft.tab.numel() * 8
    return out


def ntt_path(device, rehearse):
    cells = []
    for n, bits, count, batch in NTT_CELLS:
        if rehearse:  # the same two cells, little work
            n, count, batch = (1024, 64, 16) if n <= 16384 else (n, 4, 2)
        cells.append(ntt_cell(device, rehearse, n, bits, count, batch))
    launches = {}
    for c in cells:
        for k, v in c["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return {"cells": cells, "launches": launches}


# ---------------------------------------------------------------------------
# phase 6: the device KeySwitch context, driven by hand
# ---------------------------------------------------------------------------


def device_path(vec, device, rehearse):
    """Every schedule, tail, handle, chain and hoisted apply of
    KeySwitchContext at the vector's configuration, batch BATCH.  Each step
    asserts; device tensors are compared on the device."""
    n, L, K = vec.coeff_count, vec.decomp_modulus_size, vec.key_modulus_size
    cfg = (n, L, K, vec.rns_modulus_size, 2, vec.moduli, vec.twiddle_factors)
    keyed = (vec.key_vectors, vec.modswitch_factors)
    checked = (0, N_VECTOR_OPS)  # a vector op and a seeded op, against golden

    def make(**kw):
        return keyswitch_cuda.KeySwitchContext(*cfg, device=device, **kw)

    def golden_of(i, plain_modulus=None):
        return golden.keyswitch(rs[i], ts[i], n, L, K, vec.rns_modulus_size, 2,
                                vec.moduli, *keyed, vec.twiddle_factors,
                                plain_modulus=plain_modulus)

    ops = make_ops(vec, BATCH, seed=11)
    rs = np.stack([r for r, _ in ops])
    ts = np.stack([t for _, t in ops])
    default = keyswitch_cuda.get_context(*cfg, device=device)
    base = default.run_batch(rs, ts, *keyed)

    # 1. the fused transform+MAC schedule: a first pass stages the keys, the
    # second is the counted one
    fused = make(fused_mac=True)
    fused.run_batch(rs, ts, *keyed)
    ntt_cuda.reset_launch_counts()
    got = fused.run_batch(rs, ts, *keyed)
    launches = dict(ntt_cuda.LAUNCHES)
    np.testing.assert_array_equal(got, base, err_msg="fused_mac vs default")
    t0 = time.perf_counter()
    for i in checked:
        np.testing.assert_array_equal(got[i], golden_of(i), err_msg=f"op {i}")
    np.testing.assert_array_equal(got[0], vec.expected_output)
    expected = dict.fromkeys(ntt_cuda.LAUNCHES, 0)
    if not rehearse:
        # the identity limb's term: one keyswitch_mac a decomp engine
        expected.update(ntt_inv=L + 1, ntt_fwd_mac=L + 1, ntt_fwd_tail=L,
                        keyswitch_mac=L)
    assert launches == expected, (launches, expected)

    # 2. the other two schedules
    exact = make(mac_impl="exact128")
    unfused = make(fused_tail=False)
    for name, c in (("exact128", exact), ("fused_tail=False", unfused)):
        np.testing.assert_array_equal(c.run_batch(rs, ts, *keyed), base,
                                      err_msg=f"{name} vs default")

    # 4. BGV: fused against unfused tail, both against the golden model, and
    # through the public API
    bgv = keyswitch_cuda.get_context(*cfg, device=device,
                                     plain_modulus=PLAIN_MODULUS)
    bgv_out = bgv.run_batch(rs, ts, *keyed)
    np.testing.assert_array_equal(
        make(plain_modulus=PLAIN_MODULUS, fused_tail=False).run_batch(rs, ts, *keyed),
        bgv_out, err_msg="BGV: unfused vs fused tail")
    for i in checked:
        np.testing.assert_array_equal(bgv_out[i], golden_of(i, PLAIN_MODULUS),
                                      err_msg=f"BGV op {i}")
    golden_s = time.perf_counter() - t0
    assert not np.array_equal(bgv_out, base)
    start_runtime(rehearse, BATCH_SIZE_KEYSWITCH=BATCH)
    api_ops = 4
    results = [rs[i].copy() for i in range(api_ops)]
    hexl.set_worksize_KeySwitch(api_ops)
    for res, t in zip(results, ts):
        hexl.KeySwitch(res, t, n, L, K, vec.rns_modulus_size, 2, vec.moduli,
                       *keyed, vec.twiddle_factors, plain_modulus=PLAIN_MODULUS)
    assert hexl.KeySwitchCompleted()
    hexl.release_FPGA_resources()
    np.testing.assert_array_equal(np.stack(results), bgv_out[:api_ops],
                                  err_msg="api.KeySwitch(plain_modulus)")

    # 5. handles and chains: operands stay on the device from here on
    h_t = default.stage_target(ts)
    h_c = default.stage_ciphertext(rs)
    cur = h_c
    for _ in range(CHAIN_DEPTH):
        cur = default.run_device(cur, h_t, *keyed)
    chain = default.run_device_chain(h_c, h_t, *keyed, depth=CHAIN_DEPTH)
    assert torch.equal(chain.data, cur.data), "chain vs sequential run_device"
    keys2 = [np.roll(np.asarray(kv, np.uint64).reshape(2, K, n), 7, axis=-1).reshape(-1)
             for kv in vec.key_vectors]
    key_sets, schedule = [vec.key_vectors, keys2], [1, 0, 0, 1]
    seq = h_c
    for s in schedule:
        seq = default.run_device(seq, h_t, key_sets[s], vec.modswitch_factors)
    chain_keyed = default.run_device_chain_keyed(
        h_c, h_t, key_sets, vec.modswitch_factors, schedule)
    assert torch.equal(chain_keyed.data, seq.data), "keyed chain vs sequential"
    assert not torch.equal(chain_keyed.data, chain.data)
    host = rs
    for _ in range(CHAIN_DEPTH):  # the same chain, through the host each link
        host = default.run_batch(host, ts, *keyed)
    np.testing.assert_array_equal(chain.synchronize().to_host(), host)

    # 6. hoisting and the Galois apply
    dec = default.hoist(h_t)
    assert dec.batch == BATCH and dec.data.shape == (L + 1, L * BATCH, n)
    hoisted = default.run_hoisted(dec, h_c, *keyed)
    assert torch.equal(hoisted.data, w.from_u64_np(base, device).view_as(hoisted.data))
    for g in GALOIS_ELEMENTS:
        sigma = galois_cuda.ntt_galois_sigma(n, g)
        via_g = default.run_hoisted(dec, h_c, *keyed, galois=g)
        via_perm = default.run_hoisted(dec, h_c, *keyed, perm=sigma)
        assert torch.equal(via_g.data, via_perm.data), f"galois {g} vs perm"
        assert not torch.equal(via_g.data, hoisted.data)
    g = GALOIS_ELEMENTS[0]
    x = rand_u64(np.random.default_rng(12), (BATCH, 2, L, n), 64, device)
    index = galois_cuda.galois_index(n, g, device)
    assert torch.equal(galois_cuda.apply_galois(x, g), x[..., index])

    out = {
        "config": vec.config_name, "batch": BATCH,
        "schedules_equal_to_default": ["fused_mac", "exact128", "fused_tail=False"],
        "ops_checked_vs_golden": 2 * len(checked), "golden_s": golden_s,
        "plain_modulus": PLAIN_MODULUS, "api_ops_with_plain_modulus": api_ops,
        "chain_depth": CHAIN_DEPTH, "keyed_schedule": schedule,
        "galois_elements": [g % (2 * n) for g in GALOIS_ELEMENTS],
        "launches": launches,
    }
    if not rehearse:
        keys, kp = default.device_keys(vec.key_vectors)
        msf = default.prepare_msf4(vec.modswitch_factors)
        t, r = h_t.data, h_c.data
        # A/B of the device bodies on staged operands, in turns
        bodies = {"default": default, "fused_mac": fused, "exact128": exact,
                  "fused_tail=False": unfused, "plain_modulus": bgv}
        turns = {name: [] for name in bodies}
        for turn in range(BODY_TURNS):
            order = list(bodies) if turn % 2 == 0 else list(reversed(bodies))
            for name in order:
                c = bodies[name]
                turns[name].append(time_ms(lambda: c._build(t, keys, kp, r, msf), 5))
        out["build_ms_per_batch"] = {k: float(np.median(v)) for k, v in turns.items()}
        out["build_ms_per_batch_turns"] = turns
        out["fused_mac_faster_than_default_in_turns"] = sum(
            f < d for f, d in zip(turns["fused_mac"], turns["default"]))
        out["chain_ms"] = time_ms(
            lambda: default.run_device_chain(h_c, h_t, *keyed, depth=CHAIN_DEPTH), 3)
        sigma = galois_cuda.ntt_galois_sigma(n, g)
        pkeys, pkp = default.device_keys(vec.key_vectors, hoist_perm=sigma)
        out["hoist_ms"] = time_ms(lambda: default._decompose(t), 5)
        out["hoisted_apply_ms"] = time_ms(
            lambda: default._apply_hoisted(dec.data, r, keys, kp, msf), 5)
        out["hoisted_apply_galois_ms"] = time_ms(
            lambda: default._apply_hoisted(dec.data, r, pkeys, pkp, msf, index), 5)
        out["galois_apply_ms"] = time_ms(lambda: galois_cuda.apply_galois(x, g), 10)
        out["device_bytes_decomposition"] = dec.data.numel() * 8
    return out


# ---------------------------------------------------------------------------
# phase 7: the wire-packed KeySwitch transport (HEXL_TPU_WIRE_PACK=1)
# ---------------------------------------------------------------------------


def check_wire_codecs(vec, ops):
    """The native codec against NumPy's on one batch of the path's operands,
    with values of 2^52 and above in it (each corrupts only its own field),
    both ways; each codec's host ms on that batch."""
    r = np.stack([o[0] for o in ops[:BATCH]])
    r[0, :8] |= np.uint64(0xFFF) << np.uint64(52)
    packed = wirepack.pack_u64_native(r)
    np.testing.assert_array_equal(packed, wirepack.pack_u64_np(r))
    back = wirepack.unpack_u64_native(packed)
    np.testing.assert_array_equal(back, wirepack.unpack_u64_np(packed))
    np.testing.assert_array_equal(back, r & np.uint64((1 << 52) - 1))
    ms = {}
    for name, fn, x in (("pack_native", wirepack.pack_u64_native, r),
                        ("pack_numpy", wirepack.pack_u64_np, r),
                        ("unpack_native", wirepack.unpack_u64_native, packed),
                        ("unpack_numpy", wirepack.unpack_u64_np, packed)):
        t0 = time.perf_counter()
        for _ in range(3):
            fn(x)
        ms[name] = (time.perf_counter() - t0) / 3 * 1e3
    return {"values": int(r.size), "host_ms": ms}


def wire_pack_path(vec, device, rehearse, ops, want, unpacked_ops_per_s):
    """The main path's WORKSIZE ops through the API with HEXL_TPU_WIRE_PACK=1
    (52-bit words both ways over the copy stream, unpacked and packed on the
    card; the host codec the native one): every op against the golden
    model, so against the unpacked path's output too; the rate beside the
    unpacked one, the bytes each way per batch, packed and not, and the
    native codec against NumPy's, with each codec's host time on a batch."""
    n, L = vec.coeff_count, vec.decomp_modulus_size
    os.environ["HEXL_TPU_WIRE_PACK"] = "1"
    try:
        start_runtime(rehearse, BATCH_SIZE_KEYSWITCH=BATCH)
        first, _ = drive_api(vec, ops)
        ntt_cuda.reset_launch_counts()
        results, wall_s = drive_api(vec, ops)
        launches = {k: v for k, v in ntt_cuda.LAUNCHES.items() if v}
        hexl.release_FPGA_resources()
    finally:
        del os.environ["HEXL_TPU_WIRE_PACK"]
    for i, exp in enumerate(want):
        np.testing.assert_array_equal(first[i], exp, err_msg=f"first pass, op {i}")
        np.testing.assert_array_equal(results[i], exp, err_msg=f"op {i}")
    batches = WORKSIZE // BATCH
    expected = {} if rehearse else {"ntt_fwd": (L + 1) * batches,
                                    "ntt_inv": (L + 1) * batches,
                                    "ntt_fwd_tail": L * batches,
                                    "keyswitch_mac": (L + 1) * batches}
    assert launches == expected, (launches, expected)
    words = lambda rows: BATCH * rows * n * 13 // 8 * 4
    out = {"config": vec.config_name, "ops": WORKSIZE, "batch": BATCH,
           "ops_checked_vs_golden": len(want), "launches": launches,
           "bytes_in_per_batch": words(3 * L),
           "bytes_out_per_batch": words(2 * L),
           "unpacked_bytes_in_per_batch": BATCH * 3 * L * n * 8,
           "unpacked_bytes_out_per_batch": BATCH * 2 * L * n * 8}
    out["codecs"] = check_wire_codecs(vec, ops)
    if not rehearse:
        out["api_ops_per_s"] = WORKSIZE / wall_s
        out["unpacked_api_ops_per_s"] = unpacked_ops_per_s
    return out


# ---------------------------------------------------------------------------
# phase 8: CKKS at the SEAL bridge's configuration
# ---------------------------------------------------------------------------

# the SEAL bridge's CKKS deployment (SEAL_N, SEAL_SCALE, seal_moduli) and
# bench.py's matvec shape (MATVEC_DIAGONALS, MATVEC_N1), from integrations/ckks
CKKS_HOIST_STEPS = (1, 2, 3)
CKKS_MANY_STEPS = [0, 1, 2, 3]
NOISE = 1e-2  # decryptions, on values of order 1 (the reference's tests)


def launches_of(fn):
    """The launches of one call of fn, by kernel."""
    rank_ops.reset_counts()
    fn()
    return rank_ops.counts()


def check_scheme_shapes(moduli, n, device):
    """The kernels of the scheme paths against their plain versions at the
    shapes these paths give them (a batch of one ciphertext): ntt_inv and
    ntt_fwd over (2, n) (rescale, the GHS mod switch) and (6, n) (INTT1's
    stack), ntt_fwd_tail over (2, n) under each decomp modulus, dyadic_mul
    at (1, 2, nl, n); returns the largest difference per kernel (0)."""
    rng = np.random.default_rng(77)
    L = len(moduli) - 1
    err = {"ntt_fwd": 0, "ntt_inv": 0, "ntt_fwd_tail": 0, "dyadic_mul": 0}
    for j, q in enumerate(moduli):
        tabs = ntt_cuda.modulus_tables(n, q, device=device)
        for rows in (2, L):
            x = rand_u64(rng, (rows, n), 64, device)
            err["ntt_fwd"] = max(err["ntt_fwd"], assert_same(
                "ntt_fwd", ntt_cuda.ntt_fwd(x, tabs), ntt_cuda.ntt_fwd_plain(x, tabs)))
            err["ntt_inv"] = max(err["ntt_inv"], assert_same(
                "ntt_inv", ntt_cuda.ntt_inv(x, tabs), ntt_cuda.ntt_inv_plain(x, tabs)))
        msf = int(rng.integers(1, q))
        tail = (rand_u64(rng, (2, n), 53, device), rand_u64(rng, (2, n), 58, device),
                w.from_u64_np(rng.integers(0, q, size=(2, n), dtype=np.uint64), device),
                tabs, q - 4321, msf, (msf << 64) // q)
        err["ntt_fwd_tail"] = max(err["ntt_fwd_tail"], assert_same(
            "ntt_fwd_tail", ntt_cuda.ntt_fwd_tail(*tail), ntt_cuda.ntt_fwd_tail_plain(*tail)))
    for nl in (L, L - 1):
        runner = dyadic_cuda.runner(moduli[:nl], device)
        qcol = np.array(moduli[:nl], dtype=np.uint64).reshape(1, 1, nl, 1)
        x, y = (w.from_u64_np(rng.integers(0, 1 << 63, size=(1, 2, nl, n),
                                           dtype=np.uint64) % qcol, device)
                for _ in range(2))
        err["dyadic_mul"] = max(err["dyadic_mul"], assert_same(
            "dyadic_mul", runner.run(x, y), dyadic_cuda.dyadic_multiply_plain(x, y, runner.meta)))
    return err


def same_ct(name, got, want):
    """A device op's ciphertext against the host context's, bit for bit."""
    np.testing.assert_array_equal(got.data, want.data, err_msg=name)
    assert (got.level, got.scale) == (want.level, want.scale), name


def ckks_path(device, rehearse):
    """CKKS at the SEAL bridge's configuration: the host context's keys and
    encryptions, then on the evaluator multiply_relin -> rescale -> rotate(1)
    -> add -> conjugate -> add_plain -> multiply_plain (the counted pass),
    each held bit for bit to the port's host CkksContext (which runs through
    the public API on the card, a different composition of the same
    kernels); hoist + rotate_hoisted, rotate_many fused against unfused, and
    the BSGS matvec eager, fused and replayed from one CUDA graph, bit for
    bit with each other; every result decrypted to noise.  Times by CUDA
    events, launches per op, peak device memory, the host's seconds."""
    n = 1024 if rehearse else SEAL_N
    moduli = seal_moduli(n)
    rng = np.random.default_rng(40)
    slots = n // 2
    zs = [rng.uniform(-1, 1, slots) + 1j * rng.uniform(-1, 1, slots) for _ in range(3)]
    plain = rng.uniform(-1, 1, slots)
    diags = {d: rng.uniform(-0.5, 0.5, slots) for d in range(MATVEC_DIAGONALS)}
    if not rehearse:
        torch.cuda.reset_peak_memory_stats()
    host_s = {}
    t0 = time.perf_counter()
    ctx = ckks.CkksContext(n, moduli, SEAL_SCALE, seed=16)
    host_s["context_and_relin_keys"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for r in sorted({1, *CKKS_HOIST_STEPS, *range(1, MATVEC_N1),
                     *range(MATVEC_N1, MATVEC_DIAGONALS, MATVEC_N1)}):
        ctx.galois_keys(r)
    ctx._galois_keys_for(2 * n - 1)
    host_s["rotation_keys"] = time.perf_counter() - t0
    host_s["key_sets"] = 1 + len(ctx._rot_keys)
    t0 = time.perf_counter()
    cts = [ctx.encrypt(z) for z in zs]
    host_s["encrypt_each"] = (time.perf_counter() - t0) / len(zs)
    t0 = time.perf_counter()
    ctx.encode(zs[0])
    host_s["encode"] = time.perf_counter() - t0
    ev = ckks.DeviceCkksEvaluator(ctx, device)
    kernels = check_scheme_shapes(moduli, n, device) if not rehearse else None

    # the counted pass: one evaluation on the card, a first pass stages keys
    def chain():
        h1, h2, h3 = (ev.stage(c) for c in cts)
        steps = {"multiply_relin": ev.multiply_relin(h1, h2)}
        steps["rescale"] = ev.rescale(steps["multiply_relin"])
        steps["rotate"] = ev.rotate(steps["rescale"], 1)
        steps["add"] = ev.add(steps["rescale"], steps["rotate"])
        steps["conjugate"] = ev.conjugate(steps["add"])
        steps["add_plain"] = ev.add_plain(steps["conjugate"], plain)
        steps["multiply_plain"] = ev.multiply_plain(steps["add_plain"], plain)
        return h3, steps

    chain()
    rank_ops.reset_counts()
    h3, steps = chain()
    launches = rank_ops.counts()
    got = {k: ev.to_host(v) for k, v in steps.items()}

    # the same evaluation by the host context, through the API
    start_runtime(rehearse)
    t0 = time.perf_counter()
    want = {"multiply_relin": ctx.multiply_relin(cts[0], cts[1])}
    want["rescale"] = ctx.rescale(want["multiply_relin"])
    want["rotate"] = ctx.rotate(want["rescale"], 1)
    want["add"] = ctx.add(want["rescale"], want["rotate"])
    want["conjugate"] = ctx.conjugate(want["add"])
    want["add_plain"] = ctx.add_plain(want["conjugate"], plain)
    want["multiply_plain"] = ctx.multiply_plain(want["add_plain"], plain)
    host_s["host_context_evaluation"] = time.perf_counter() - t0
    hexl.release_FPGA_resources()
    for k in want:
        same_ct(k, got[k], want[k])
    zz = zs[0] * zs[1]
    z_add = zz + np.roll(zz, -1)
    z_final = (np.conj(z_add) + plain) * plain
    errors = {"evaluation": float(np.max(np.abs(ctx.decrypt(got["multiply_plain"]) - z_final)))}

    # hoisting: one decomposition, several rotations (to noise)
    hh = ev.hoist(h3)
    for r in CKKS_HOIST_STEPS:
        back = ctx.decrypt(ev.to_host(ev.rotate_hoisted(hh, r)))
        errors[f"rotate_hoisted_{r}"] = float(np.max(np.abs(back - np.roll(zs[2], -r))))
    fused = ev.rotate_many(h3, CKKS_MANY_STEPS)
    unfused = ev.rotate_many(h3, CKKS_MANY_STEPS, fused=False)
    for r, a, b in zip(CKKS_MANY_STEPS, fused, unfused):
        assert torch.equal(a.data, b.data), f"rotate_many fused vs unfused, step {r}"
        back = ctx.decrypt(ev.to_host(a))
        errors[f"rotate_many_{r}"] = float(np.max(np.abs(back - np.roll(zs[2], -r))))

    # the matvec: eager composition, fused, and one CUDA graph replayed
    unfused_mv = ev.linear_transform(h3, diags, bsgs_n1=MATVEC_N1)
    t0 = time.perf_counter()
    fused_mv, program = ev.linear_transform_fused(h3, diags, bsgs_n1=MATVEC_N1,
                                                  return_program=True)
    host_s["matvec_staging_and_capture"] = time.perf_counter() - t0
    assert torch.equal(fused_mv.data, unfused_mv.data), "matvec fused vs unfused"
    assert torch.equal(program.eager(h3.data), fused_mv.data), "matvec eager"
    assert torch.equal(program(h3.data), fused_mv.data), "matvec replay"
    assert (program.graph is None) == rehearse
    # the graph holds every key set it reads: more other key sets than the
    # key cache keeps pass through h3's level, evicting the giant steps'
    # (whose memory new keys then take), and the replay gives the same bits
    ks = ev._ks_ctx(h3.level + 1)
    giant = set(range(MATVEC_N1, MATVEC_DIAGONALS, MATVEC_N1))
    others = [r for r in range(1, slots) if r not in giant][: ks.KEY_CACHE_SLOTS + 1]
    t0 = time.perf_counter()
    for r in others:
        ev.rotate(h3, r)
    host_s["eviction_check"] = time.perf_counter() - t0
    cached = ks._key_cache._cache
    for r in giant:
        src = ctx.galois_keys(r)
        assert tuple(id(a) for a in src) not in cached, f"giant step {r} still cached"
    assert torch.equal(program(h3.data), fused_mv.data), "matvec replay after eviction"
    want_mv = sum(diags[d] * np.roll(zs[2], -d) for d in diags)
    errors["matvec"] = float(np.max(np.abs(ctx.decrypt(ev.to_host(fused_mv)) - want_mv)))
    assert max(errors.values()) < NOISE, errors

    per_op = {
        "rotate": lambda: ev.rotate(h3, 1),
        "multiply_relin": lambda: ev.multiply_relin(h3, h3),
        "rescale": lambda: ev.rescale(steps["multiply_relin"]),
        "rotate_hoisted": lambda: ev.rotate_hoisted(hh, 1),
        "rotate_many": lambda: ev.rotate_many(h3, CKKS_MANY_STEPS),
        "matvec_eager": lambda: program.eager(h3.data),
    }
    out = {
        "n": n, "moduli_bits": [q.bit_length() for q in moduli], "scale_log2": 40,
        "levels": {k: v.level for k, v in got.items()},
        "ops_checked_vs_host_context": len(want),
        "bit_equal": ["rotate_many fused vs unfused", "matvec fused vs unfused",
                      "matvec eager vs graph replay",
                      "matvec replay after its key sets left the cache"],
        "key_sets_through_cache_after_capture": len(others),
        "max_abs_err_decrypted": errors, "launches": launches,
        "launches_per_op": {k: launches_of(f) for k, f in per_op.items()},
        "host_s": host_s,
        "host_bytes_embedding": ctx.E.nbytes,
    }
    if not rehearse:
        out["kernels_vs_plain_max_abs_err"] = kernels
        ms = {k: time_ms(f, 5) for k, f in per_op.items()}
        ms["matvec_graph_replay"] = time_ms(lambda: program(h3.data), 5)
        out["ms_per_op"] = ms
        out["peak_device_bytes"] = torch.cuda.max_memory_allocated()
        out["device_bytes_key_set"] = 2 * 8 * ctx.L * 2 * ctx.K * n
    return out


# ---------------------------------------------------------------------------
# phase 9: BGV at n = 16384 over the frozen vector's moduli
# ---------------------------------------------------------------------------


def bgv_path(vec, device, rehearse):
    """BGV, t = PLAIN_MODULUS, over the frozen vector's seven moduli: on the
    evaluator multiply_relin -> mod_switch_to_next -> rotate, and a hoisted
    rotation (the counted pass); the non-hoisted ones equal the host
    BgvContext bit for bit, and every one decrypts exactly mod t."""
    n, t = vec.coeff_count, PLAIN_MODULUS
    ctx = bgv.BgvContext(n, vec.moduli, t, seed=17)
    rng = np.random.default_rng(18)
    zs = [rng.integers(0, t, size=n, dtype=np.uint64) for _ in range(2)]
    t0 = time.perf_counter()
    ctx.galois_keys(1)
    ctx.galois_keys(2)
    cts = [ctx.encrypt(z) for z in zs]
    host_s = {"keys_and_encrypt": time.perf_counter() - t0}
    ev = bgv.DeviceBgvEvaluator(ctx, device)
    kernels = check_scheme_shapes(vec.moduli, n, device) if not rehearse else None

    def chain():
        h1, h2 = (ev.stage(c) for c in cts)
        s = {"multiply_relin": ev.multiply_relin(h1, h2)}
        s["mod_switch_to_next"] = ev.mod_switch_to_next(s["multiply_relin"])
        s["rotate"] = ev.rotate(s["mod_switch_to_next"], 1)
        s["rotate_hoisted"] = ev.rotate_hoisted(ev.hoist(s["mod_switch_to_next"]), 2)
        return s

    chain()
    rank_ops.reset_counts()
    steps = chain()
    launches = rank_ops.counts()
    got = {k: ev.to_host(v) for k, v in steps.items()}

    start_runtime(rehearse)
    t0 = time.perf_counter()
    want = {"multiply_relin": ctx.multiply_relin(*cts)}
    want["mod_switch_to_next"] = ctx.mod_switch_to_next(want["multiply_relin"])
    want["rotate"] = ctx.rotate(want["mod_switch_to_next"], 1)
    host_s["host_context_evaluation"] = time.perf_counter() - t0
    hexl.release_FPGA_resources()
    for k in want:
        same_ct(k, got[k], want[k])
    prod = (zs[0].astype(object) * zs[1] % t).astype(np.uint64).reshape(2, -1)
    expect = {"multiply_relin": prod, "mod_switch_to_next": prod,
              "rotate": np.roll(prod, -1, axis=1),
              "rotate_hoisted": np.roll(prod, -2, axis=1)}
    for k, v in expect.items():
        np.testing.assert_array_equal(ctx.decrypt(got[k]).reshape(2, -1), v, err_msg=k)
    out = {"n": n, "plain_modulus": t, "moduli_of": vec.config_name,
           "ops_checked_vs_host_context": len(want),
           "ops_decrypted_exactly": len(expect), "launches": launches,
           "noise_budget_bits": {"fresh": ctx.noise_budget(cts[0]),
                                 "after_mod_switch": ctx.noise_budget(got["mod_switch_to_next"])},
           "host_s": host_s}
    if not rehearse:
        out["kernels_vs_plain_max_abs_err"] = kernels
        h1, h2 = (ev.stage(c) for c in cts)
        ms_in = steps["multiply_relin"]
        out["ms_per_op"] = {
            "multiply_relin": time_ms(lambda: ev.multiply_relin(h1, h2), 5),
            "mod_switch_to_next": time_ms(lambda: ev.mod_switch_to_next(ms_in), 5),
        }
    return out


# ---------------------------------------------------------------------------
# phase 10: BFV at n = 16384, the BEHZ multiply as one CUDA graph
# ---------------------------------------------------------------------------

# the benchmark's cell bfv16384.behz_multiply: the level of the frozen
# vector's six decomp primes, t = 65537, batch 8 (bench.py's BEHZ batch)
BEHZ_BATCH = 8
BEHZ_ORACLE_ROWS = (0, BEHZ_BATCH - 1)  # batch rows held to the host BehzTool
CHAIN_STEPS = 10


def behz_launches(k):
    """Kernel launches of one BEHZ multiply at k q moduli: ntt_inv over the
    four inputs under q, the three outputs under q and under Bsk; ntt_fwd
    over the extension under Bsk and the result under q; one tensor product
    over q u Bsk; one extension q -> Bsk and one fast floor +
    Shenoy-Kumaresan."""
    return {"ntt_inv": 3 * k + 1, "ntt_fwd": 2 * k + 1, "dyadic_mul": 1,
            "behz_extend": 1, "behz_floor_sk": 1}


def behz_conversion_bound(k: int, cols: int, floor_sk: bool):
    """(bound_ms, bound_by) for behz_extend (floor_sk False) or
    behz_floor_sk over `cols` columns: each limb read and written once
    against the Harvey products of a column (a prologue per source limb, a
    term per source and destination limb, the corrections)."""
    D = k + 1
    if floor_sk:  # fast floor (k + k D + 2D), then SK (k + k D + 1 + k)
        words, products = 3 * k + 1, 3 * k + 2 * k * D + 2 * D + 1
    else:  # prologue, conversion, SmMRq term and m_tilde^-1; the m_tilde residue
        words, products = 2 * k + 1, k + k * D + 2 * D
    return larger_bound(8 * words * cols, cols * (products * IMAD_LAZY_MUL + D))


def check_behz_shapes(behz, device):
    """ntt_inv and ntt_fwd against their plain versions at the BEHZ
    multiply's rows (4B and 3B) under the first q and the first Bsk prime,
    dyadic_mul at (B, 2, 2k + 1, n) over q u Bsk, behz_extend at (k, 4B, n)
    and behz_floor_sk at (k, 3B, n) against the torch lane math; each timed
    beside its bound (`device_ms` filled in after the paths)."""
    rng = np.random.default_rng(79)
    T = behz.tool
    B, k, n = BEHZ_BATCH, T.k, T.n
    entries = []
    for tabs in (behz._q_tabs[0], behz._bsk_tabs[0]):
        for rows in (4 * B, 3 * B):
            x = w.from_u64_np(rng.integers(0, tabs.q, size=(rows, n), dtype=np.uint64),
                              device)
            for name, fn, plain, extra in (
                ("ntt_inv", ntt_cuda.ntt_inv, ntt_cuda.ntt_inv_plain,
                 IMAD_BARRETT + IMAD_LAZY_MUL // 2),
                ("ntt_fwd", ntt_cuda.ntt_fwd, ntt_cuda.ntt_fwd_plain, IMAD_BARRETT),
            ):
                kern = lambda fn=fn, x=x, tabs=tabs: fn(x, tabs)
                b_ms, b_by = bound(rows, n, 2, extra)
                entry = {"name": name, "shape": [rows, n], "modulus_bits": tabs.q.bit_length(),
                         "max_abs_err": assert_same(name, kern(), plain(x, tabs)),
                         "ms": time_ms(kern, 20), "plain_ms": time_ms(lambda: plain(x, tabs), 2),
                         "bound_ms": b_ms, "bound_by": b_by}
                profile_later(entry, name, kern)
                entries.append(entry)
    moduli = T.q + T.Bsk
    qcol = np.array(moduli, dtype=np.uint64).reshape(1, 1, -1, 1)
    x, y = (w.from_u64_np(rng.integers(0, 1 << 63, size=(B, 2, len(moduli), n),
                                       dtype=np.uint64) % qcol, device) for _ in range(2))
    runner = behz._runner
    kern = lambda: runner.run(x, y)
    b_ms, b_by = dyadic_bound(B, len(moduli), n)
    entry = {"name": "dyadic_mul", "shape": [B, 2, len(moduli), n],
             "max_abs_err": assert_same("dyadic_mul", kern(),
                                        dyadic_cuda.dyadic_multiply_plain(x, y, runner.meta)),
             "ms": time_ms(kern, 20),
             "plain_ms": time_ms(lambda: dyadic_cuda.dyadic_multiply_plain(x, y, runner.meta), 2),
             "bound_ms": b_ms, "bound_by": b_by}
    profile_later(entry, "dyadic_mul", kern)
    entries.append(entry)
    # the two conversion kernels at the multiply's shapes: the extension of
    # the four inputs (k, 4B, n), the floor + SK of the three components
    canon = lambda mods, R: w.from_u64_np(
        rng.integers(0, 1 << 63, size=(len(mods), R, n), dtype=np.uint64)
        % np.array(mods, dtype=np.uint64).reshape(-1, 1, 1), device)
    coeff = canon(T.q, 4 * B)  # a name of its own: dyadic_mul's kern reads x later
    d_q, d_bsk = canon(T.q, 3 * B), canon(T.Bsk, 3 * B)
    for name, kern, plain, shape, floor_sk in (
        ("behz_extend", lambda: behz.extend_to_bsk(coeff),
         lambda: behz._extend_to_bsk_plain(coeff), [k, 4 * B, n], False),
        ("behz_floor_sk", lambda: behz.floor_sk(d_q, d_bsk),
         lambda: behz._floor_sk_plain(d_q, d_bsk), [k, 3 * B, n], True),
    ):
        b_ms, b_by = behz_conversion_bound(k, shape[1] * n, floor_sk)
        entry = {"name": name, "shape": shape,
                 "bsk_bits": [m.bit_length() for m in T.Bsk],
                 "max_abs_err": assert_same(name, kern(), plain()),
                 "ms": time_ms(kern, 20), "plain_ms": time_ms(plain, 2),
                 "bound_ms": b_ms, "bound_by": b_by}
        profile_later(entry, name, kern)
        entries.append(entry)
    return entries


def bfv_path(vec, device, rehearse):
    """BFV on the card, at the shape of the benchmark's cell
    bfv16384.behz_multiply: a BfvContext over the frozen vector's seven
    moduli, t = PLAIN_MODULUS, and its DeviceBfvEvaluator.  First the BEHZ
    multiply at batch 8 on the level of the six decomp moduli: the level's
    BehzCuda eager and the evaluator's multiply (its CUDA graph replay), bit
    for bit with each other and, on two batch rows, with the host BehzTool;
    launches per multiply (counted for a replay as for the eager run), and
    rns_behz_cuda.GRAPHS counting the evaluator's call as a replay.  Then two
    encryptions, multiply_rns on the card bit for bit against the host tool,
    relinearize and mod_switch_to_next each decrypting exactly to z1 * z2 mod
    t, a rotation on DeviceCkksEvaluator bit for bit against the host context
    and decrypted exactly, the noise budget along the way.  Times by CUDA
    events, the dependent-chain rate of `bench.py` (two of the three outputs
    feed the next multiply), peak device memory, the host's seconds."""
    n, t = vec.coeff_count, PLAIN_MODULUS
    if rehearse:  # multiply_rns(device=None) under RUN_CHOICE=1: the plain versions
        os.environ["RUN_CHOICE"] = "1"
        config_mod.reset_config()
    on_card = None if rehearse else True
    if not rehearse:
        torch.cuda.reset_peak_memory_stats()
    host_s = {}
    rng = np.random.default_rng(19)
    t0 = time.perf_counter()
    ctx = bfv.BfvContext(n, vec.moduli, t, seed=21)
    host_s["context_and_relin_keys"] = time.perf_counter() - t0
    bev = bfv.DeviceBfvEvaluator(ctx, device)
    k = ctx.L
    t0 = time.perf_counter()
    tool, tabs = ctx._behz(k), ctx.tabs[:k]
    behz = ctx._behz_cuda(k, device)
    host_s["behz_tool_and_staging"] = time.perf_counter() - t0
    q = tool.q
    qcol = np.array(q, dtype=np.uint64).reshape(1, 1, k, 1)
    c1, c2 = (rng.integers(0, 1 << 62, size=(BEHZ_BATCH, 2, k, n), dtype=np.uint64)
              % qcol for _ in range(2))
    x1, x2 = bev.stage(c1), bev.stage(c2)
    t0 = time.perf_counter()
    program = behz.program(BEHZ_BATCH)
    host_s["behz_capture"] = time.perf_counter() - t0
    assert (program.graph is None) == rehearse
    eager = behz.multiply_tensors(x1, x2)
    graphs = dict(rns_behz_cuda.GRAPHS)
    replay = bev.multiply(x1, x2)
    counted = {key: rns_behz_cuda.GRAPHS[key] - v for key, v in graphs.items()}
    assert counted == {"captures": 0, "replays": 0 if rehearse else 1,
                       "eager": 1 if rehearse else 0}, counted
    assert torch.equal(eager, replay), "BEHZ multiply: eager vs graph replay"
    got = w.to_u64_np(replay)
    t0 = time.perf_counter()
    for b in BEHZ_ORACLE_ROWS:
        np.testing.assert_array_equal(got[b], tool.multiply(c1[b], c2[b], tabs),
                                      err_msg=f"BEHZ batch row {b} vs BehzTool")
    host_s["behz_oracle_each"] = (time.perf_counter() - t0) / len(BEHZ_ORACLE_ROWS)
    per_multiply = {"eager": launches_of(lambda: behz.multiply_tensors(x1, x2)),
                    "graph_replay": launches_of(lambda: bev.multiply(x1, x2))}
    # a replay counts the kernels it runs, as the eager multiply does
    assert per_multiply == ({"eager": {}, "graph_replay": {}} if rehearse else
                            {"eager": behz_launches(k),
                             "graph_replay": behz_launches(k)}), per_multiply

    t0 = time.perf_counter()
    ctx.galois_keys(1)
    host_s["rotation_keys"] = time.perf_counter() - t0
    zs = [rng.integers(0, t, size=n, dtype=np.uint64) for _ in range(2)]
    t0 = time.perf_counter()
    cts = [ctx.encrypt(z) for z in zs]
    host_s["encrypt_each"] = (time.perf_counter() - t0) / len(zs)
    ev = ckks.DeviceCkksEvaluator(ctx, device)

    # the counted pass: an eager BEHZ multiply at the benchmark shape, its
    # replay, multiply_rns on the context's level (its graph captured by the
    # first pass) and a rotation on the evaluator
    def chain():
        s = {"behz_eager": behz.multiply_tensors(x1, x2), "behz_replay": bev.multiply(x1, x2)}
        s["multiply_rns"], _ = ctx.multiply_rns(cts[0], cts[1], device=on_card)
        s["rotate"] = ev.to_host(ev.rotate(ev.stage(cts[0]), 1))
        return s

    chain()
    rank_ops.reset_counts()
    steps = chain()
    launches = rank_ops.counts()
    rotate_launches = launches_of(lambda: ev.rotate(ev.stage(cts[0]), 1))
    if not rehearse:
        # the eager multiply and its replay, multiply_rns's replay at the
        # context's level, the rotation
        want = {}
        for part in (behz_launches(k), behz_launches(k),
                     behz_launches(cts[0].level + 1), rotate_launches):
            for name, v in part.items():
                want[name] = want.get(name, 0) + v
        assert launches == want, (launches, want)
    assert torch.equal(steps["behz_eager"], eager) and torch.equal(steps["behz_replay"], eager)

    nl = cts[0].level + 1
    t0 = time.perf_counter()
    d_host, _ = ctx.multiply_rns(cts[0], cts[1], device=False)
    host_s["multiply_rns_host_tool"] = time.perf_counter() - t0
    np.testing.assert_array_equal(steps["multiply_rns"], d_host,
                                  err_msg="multiply_rns on the card vs the host BehzTool")
    t0 = time.perf_counter()
    relin = ctx.relinearize(steps["multiply_rns"], 1.0, level=nl - 1)
    switched = ctx.mod_switch_to_next(relin)
    want_rot = ctx.rotate(cts[0], 1)
    host_s["relinearize_mod_switch_rotate"] = time.perf_counter() - t0
    same_ct("rotate", steps["rotate"], want_rot)
    prod = (zs[0].astype(object) * zs[1] % t).astype(np.uint64)
    for name, ct, z in (("relinearize", relin, prod), ("mod_switch_to_next", switched, prod),
                        ("rotate", steps["rotate"],
                         np.roll(zs[0].reshape(2, -1), -1, axis=1).ravel())):
        np.testing.assert_array_equal(ctx.decrypt(ct), z, err_msg=name)
    budget = {"fresh": ctx.noise_budget(cts[0]), "after_multiply": ctx.noise_budget(relin),
              "after_mod_switch": ctx.noise_budget(switched)}
    assert 0 < budget["after_multiply"] < budget["fresh"], budget
    out = {
        "n": n, "plain_modulus": t,
        "behz": {"moduli_of": vec.config_name, "q_bits": [m.bit_length() for m in q],
                 "bsk_bits": [m.bit_length() for m in tool.Bsk], "batch": BEHZ_BATCH,
                 "rows_vs_host_tool": len(BEHZ_ORACLE_ROWS),
                 "launches_per_multiply": per_multiply},
        "moduli_of": vec.config_name, "level_moduli": nl,
        "bsk_bits_of_level": [m.bit_length() for m in ctx._behz(nl).Bsk],
        "bit_equal": ["BEHZ eager vs graph replay", "BEHZ vs host BehzTool",
                      "multiply_rns card vs host tool", "rotate evaluator vs host context"],
        "ops_decrypted_exactly": 3, "noise_budget_bits": budget,
        "launches": launches, "launches_rotate": rotate_launches, "host_s": host_s,
    }
    if not rehearse:
        out["kernels_at_path_shapes"] = check_behz_shapes(behz, device)
        ms = {"behz_eager_batch": time_ms(lambda: behz.multiply_tensors(x1, x2), 5),
              "behz_graph_replay_batch": time_ms(lambda: bev.multiply(x1, x2), 10)}
        h1 = ev.stage(cts[0])
        ms["rotate"] = time_ms(lambda: ev.rotate(h1, 1), 5)
        out["ms"] = ms
        # bench.py's dependent chain: two of the three outputs feed the next
        state = {"a": x1, "b": x2}

        def step():
            o = bev.multiply(state["a"], state["b"])
            state["a"], state["b"] = o[:, 0:2], o[:, 1:3]

        chain_ms = time_ms(step, CHAIN_STEPS)
        out["chain_multiplies_per_s"] = BEHZ_BATCH / chain_ms * 1e3
        out["chain_ms_per_batch"] = chain_ms
        out["peak_device_bytes"] = torch.cuda.max_memory_allocated()
        out["device_bytes_behz_operands"] = 2 * x1.numel() * 8
    return out


# ---------------------------------------------------------------------------
# phase 11: the frozen vector with an idle modulus (K > L + 1)
# ---------------------------------------------------------------------------


def idle_modulus_vector(device, rehearse):
    """16384_5_7_6_2_0 (1024_5_7_6_2_0 in rehearsal): five decomp moduli under
    seven key moduli, through the device context, against its
    expected_output."""
    name = "1024_5_7_6_2_0.json" if rehearse else "16384_5_7_6_2_0.json.gz"
    v = vectors.load_json(os.path.join(HERE, "tests", "testdata", name))
    ctx = keyswitch_cuda.get_context(
        v.coeff_count, v.decomp_modulus_size, v.key_modulus_size,
        v.rns_modulus_size, 2, v.moduli, v.twiddle_factors, device=device)
    args = (v.input[None], v.t_target_iter_ptr[None], v.key_vectors,
            v.modswitch_factors)
    ctx.run_batch(*args)
    rank_ops.reset_counts()
    got = ctx.run_batch(*args)
    launches = rank_ops.counts()
    np.testing.assert_array_equal(got[0], v.expected_output)
    return {"vector": name, "ops_checked_vs_expected_output": 1,
            "launches": launches}


# ---------------------------------------------------------------------------
# phase 12: the C++ runtime (hexl-fpga.h) served by the port
# ---------------------------------------------------------------------------

# the C++ pool reads these once, when it is created (runtime.cpp:23-35)
CPP_POOL_ENV = {"BATCH_SIZE_KEYSWITCH": BATCH, "BATCH_SIZE_DYADIC_MULTIPLY": BATCH,
                "BATCH_SIZE_NTT": 256, "BATCH_SIZE_INTT": 256, "NUM_DEV": 1}
CPP_VECTORS = ("1024_2_3_3_2_0.json", "1024_2_3_3_2_1.json",
               "1024_5_7_6_2_0.json", "2048_3_4_4_2_0.json",
               "8192_5_7_6_2_0.json.gz", "8192_6_7_7_2_0.json.gz",
               "16384_5_7_6_2_0.json.gz", "16384_6_7_7_2_0.json.gz")


def cpp_acquire(rt, rehearse, **pool):
    """Create the C++ pool with CPP_POOL_ENV (updated by `pool`) and the
    backend route (RUN_CHOICE >= 1), then put the environment back as it
    was."""
    env = {**{k: str(v) for k, v in {**CPP_POOL_ENV, **pool}.items()},
           "RUN_CHOICE": "1" if rehearse else "2"}
    keep = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        rt.acquire()
    finally:
        for k, v in keep.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


def c_keyswitch_config(v):
    """The C arguments of a vector's configuration: (n, L, K, rns, comp,
    moduli, keys, msf, twiddles), pointers into arrays that stay alive in
    the returned list's last element."""
    keep = [np.ascontiguousarray(a, dtype=np.uint64) for a in (
        v.moduli, v.modswitch_factors, v.twiddle_factors, *v.key_vectors)]
    P = cpp_bridge._np_ptr
    keys = (cpp_bridge.u64_p * v.decomp_modulus_size)(
        *[P(k) for k in keep[3:]])
    return ((v.coeff_count, v.decomp_modulus_size, v.key_modulus_size,
             v.rns_modulus_size, v.key_component_count, P(keep[0]), keys,
             P(keep[1]), P(keep[2])), keep + [keys])


def drive_cpp_keyswitch(rt, v, ops):
    """hexl_tpu_set_worksize_keyswitch(len(ops)) -> one hexl_tpu_keyswitch per
    (result, t_target) pair into copies of the results ->
    hexl_tpu_keyswitch_completed(); returns the results and the seconds of
    those C calls."""
    (n, L, K, rns, comp, moduli, keys, msf, tw), keep = c_keyswitch_config(v)
    results = [np.array(r, dtype=np.uint64) for r, _ in ops]
    targets = [np.ascontiguousarray(t, dtype=np.uint64) for _, t in ops]
    ptrs = [(cpp_bridge._np_ptr(r), cpp_bridge._np_ptr(t))
            for r, t in zip(results, targets)]
    t0 = time.perf_counter()
    rt.lib.hexl_tpu_set_worksize_keyswitch(len(ops))
    for r, t in ptrs:
        rt.lib.hexl_tpu_keyswitch(r, t, n, L, K, rns, comp, moduli, keys, msf, tw)
    assert rt.lib.hexl_tpu_keyswitch_completed()
    return results, time.perf_counter() - t0


def drive_cpp_dyadic(rt, op1, op2, moduli):
    """The DyadicMultiply worksize through the C API; (results, seconds)."""
    M, n = op1.shape[2], op1.shape[3]
    q = np.ascontiguousarray(moduli, dtype=np.uint64)
    results = [np.zeros(3 * M * n, dtype=np.uint64) for _ in range(len(op1))]
    P = cpp_bridge._np_ptr
    ptrs = [(P(r), P(np.ascontiguousarray(a)), P(np.ascontiguousarray(b)))
            for r, a, b in zip(results, op1, op2)]
    t0 = time.perf_counter()
    rt.lib.hexl_tpu_set_worksize_dyadic_multiply(len(results))
    for r, a, b in ptrs:
        rt.lib.hexl_tpu_dyadic_multiply(r, a, b, n, P(q), M)
    assert rt.lib.hexl_tpu_dyadic_multiply_completed()
    return results, time.perf_counter() - t0


def drive_cpp_transform(rt, operands, inverse, tables, q, n):
    """The _NTT (or _INTT) worksize through the C API on copies of
    `operands`, with the caller's tables from hexl_tpu_make_ntt_tables;
    (results, seconds)."""
    fwd, fwd_p, inv, inv_p, inv_n, inv_n_w = tables
    P = cpp_bridge._np_ptr
    bufs = [np.array(o, dtype=np.uint64) for o in operands]
    ptrs = [P(b) for b in bufs]
    L = rt.lib
    t0 = time.perf_counter()
    if inverse:
        L.hexl_tpu_set_worksize_intt(len(bufs))
        for b in ptrs:
            L.hexl_tpu_intt(b, P(inv), P(inv_p), q, inv_n, inv_n_w, n)
        assert L.hexl_tpu_intt_completed()
    else:
        L.hexl_tpu_set_worksize_ntt(len(bufs))
        for b in ptrs:
            L.hexl_tpu_ntt(b, P(fwd), P(fwd_p), q, n)
        assert L.hexl_tpu_ntt_completed()
    return bufs, time.perf_counter() - t0


def cpp_path(vec, device, rehearse, ops, want, python_rates, build_s):
    """hexl-fpga.h through the C++ runtime (the port's g++ build of cpp/),
    its accelerator backend the port's (`register_torch_backend`), every
    output against an oracle: KeySwitch (64 ops at the main path's
    configuration, v2 then v1 alone, against golden_ops), two ops
    accumulating into one result, every frozen vector, DyadicMultiply
    (dyadic_data's oracle) and _NTT / _INTT (golden transforms, the round
    trip), then KeySwitch again with two C++ workers (NUM_DEV = 2).  Each
    run asserts no decline and no error, every op served by the backend in
    at least ceil(ops / batch) batches, and the launches per served batch;
    the C API's rates beside the Python API's."""
    n, L = vec.coeff_count, vec.decomp_modulus_size
    rt = cpp_bridge.NativeRuntime()
    cpp_acquire(rt, rehearse)
    out = {"library": os.path.relpath(rt.lib._name, HERE),
           "library_build_s": build_s, "pool": CPP_POOL_ENV, "runs": {}}
    totals = {}

    def run(name, fn, op, count, per_batch, batch, abi="v2", bodies=None):
        """fn() once with every count at 0; the run's launches (per_batch
        times the served batches, or times `bodies`), served batches (for
        KeySwitch, dispatch_batch's bodies too) and key uploads, asserted;
        returns fn's value."""
        rt.backend_stats(clear=True)
        rank_ops.reset_counts()
        keycache.UPLOADS["key_sets"] = 0
        graphs = dict(keyswitch_cuda.GRAPHS)
        value = fn()
        launches, stats = rank_ops.counts(), rt.backend_stats(clear=True)
        served, graphs = keyswitch_bodies(graphs)
        assert stats["declines"] == [] and stats["errors"] == [], stats
        batches = stats["batches"].get(abi, {}).get(op, 0)
        assert stats["batches"] == {abi: {op: batches}}, stats
        assert stats["ops"] == {abi: {op: count}}, stats
        assert batches >= math.ceil(count / batch), (batches, count, batch)
        if op == "KEYSWITCH":
            assert served == (bodies or batches), (name, graphs, bodies or batches)
        expected = {} if rehearse else {
            k: b * (bodies or batches) for k, b in per_batch.items()}
        assert launches == expected, (name, launches, expected)
        for k, c in launches.items():
            totals[k] = totals.get(k, 0) + c
        out["runs"][name] = {"ops": count, "abi": abi, "batches": batches,
                             "worker_threads": stats["threads"],
                             "launches": launches,
                             "key_uploads": keycache.UPLOADS["key_sets"]}
        if op == "KEYSWITCH":
            out["runs"][name]["graphs"] = graphs
        return value

    try:
        # 1. the main path's 64 ops, under v2 then under v1 alone: a fresh
        # registration stages the key set once (cold), a second stream on
        # it finds it staged (warm, as the Python API's counted pass)
        for abi in ("v2", "v1"):
            rt.register_torch_backend(pipelined=abi == "v2", device=device)
            for name, uploads in ((f"keyswitch_{abi}", 1),
                                  (f"keyswitch_{abi}_warm", 0)):
                results, wall_s = run(name, lambda: drive_cpp_keyswitch(rt, vec, ops),
                                      "KEYSWITCH", len(ops), keyswitch_launches(L),
                                      BATCH, abi)
                for i, exp in enumerate(want):
                    np.testing.assert_array_equal(results[i], exp,
                                                  err_msg=f"{name}, op {i}")
                assert out["runs"][name]["key_uploads"] == uploads, out["runs"][name]
                if not rehearse:
                    out["runs"][name]["cpp_api_ops_per_s"] = len(ops) / wall_s
        rt.register_torch_backend(pipelined=True, device=device)

        # 2. two ops accumulating into one result within one worksize
        ctx = keyswitch_cuda.get_context(
            n, L, vec.key_modulus_size, vec.rns_modulus_size, 2, vec.moduli,
            vec.twiddle_factors, device=device)
        r, t = ops[N_VECTOR_OPS]
        keyed = (vec.key_vectors, vec.modswitch_factors)
        twice = ctx.run_batch(ctx.run_batch(r[None], t[None], *keyed), t[None], *keyed)
        (cn, cL, cK, rns, comp, moduli, keys, msf, tw), keep = c_keyswitch_config(vec)
        result = np.array(r, dtype=np.uint64)

        def accumulate():
            rt.lib.hexl_tpu_set_worksize_keyswitch(2)
            for _ in range(2):
                rt.lib.hexl_tpu_keyswitch(
                    cpp_bridge._np_ptr(result), cpp_bridge._np_ptr(t), cn, cL,
                    cK, rns, comp, moduli, keys, msf, tw)
            assert rt.lib.hexl_tpu_keyswitch_completed()

        # the two ops may share a batch, which the backend then runs in two
        # pieces: two bodies either way
        run("accumulate_pair", accumulate, "KEYSWITCH", 2, keyswitch_launches(L),
            2, bodies=2)
        np.testing.assert_array_equal(result, twice[0], err_msg="accumulate pair")

        # 3. every frozen vector (the four small ones in rehearsal)
        checked = []
        for name in CPP_VECTORS[:4] if rehearse else CPP_VECTORS:
            v = vec if name == os.path.basename(VECTOR) else vectors.load_json(
                os.path.join(HERE, "tests", "testdata", name))
            pair = [(v.input, v.t_target_iter_ptr)]
            (got,), _ = run(name, lambda: drive_cpp_keyswitch(rt, v, pair),
                            "KEYSWITCH", 1, keyswitch_launches(v.decomp_modulus_size), 1)
            np.testing.assert_array_equal(got, v.expected_output, err_msg=name)
            checked.append(name)
        out["vectors_checked_vs_expected_output"] = checked

        # 4. DyadicMultiply, the dyadic path's ops
        dn, dmoduli, op1, op2, dwant, _ = dyadic_data(rehearse)
        results, wall_s = run("dyadic", lambda: drive_cpp_dyadic(rt, op1, op2, dmoduli),
                              "DYADIC_MULTIPLY", len(op1), {"dyadic_mul": 1}, BATCH)
        for i in range(len(op1)):
            np.testing.assert_array_equal(results[i], dwant[i].reshape(-1),
                                          err_msg=f"dyadic op {i}")
        if not rehearse:
            out["runs"]["dyadic"]["cpp_api_ops_per_s"] = len(op1) / wall_s

        # 5. _NTT / _INTT with the C++ runtime's own tables
        tn, bits, count, tbatch = NTT_CELLS[0]
        if rehearse:
            tn, count = 1024, 64
        q, tabs, src, want_fwd, _ = ntt_data(tn, bits, count)
        made = rt.make_ntt_tables(tn, q)
        for got_t, exp_t in zip(made, (tabs.fwd, tabs.fwd_precon, tabs.inv,
                                       tabs.inv_precon, tabs.inv_n, tabs.inv_n_w)):
            np.testing.assert_array_equal(got_t, exp_t, err_msg="C++ tables")
        fwd, fwd_s = run("ntt", lambda: drive_cpp_transform(rt, src, False, made, q, tn),
                         "NTT", count, {"ntt_fwd": 1}, tbatch)
        np.testing.assert_array_equal(np.stack(fwd), want_fwd)
        back, inv_s = run("intt", lambda: drive_cpp_transform(rt, fwd, True, made, q, tn),
                          "INTT", count, {"ntt_inv": 1}, tbatch)
        np.testing.assert_array_equal(np.stack(back), src)  # the round trip
        if not rehearse:
            out["runs"]["ntt"]["cpp_api_ops_per_s"] = count / fwd_s
            out["runs"]["intt"]["cpp_api_ops_per_s"] = count / inv_s
        out["ntt"] = {"n": tn, "modulus_bits": bits, "tables_equal_port_twiddles": True}

        # 6. two C++ workers on the one card (NUM_DEV = 2): an executor each,
        # both on device index k % device_count = 0
        rt.clear_backend()
        rt.release()
        cpp_acquire(rt, rehearse, NUM_DEV=2)
        rt.register_torch_backend(pipelined=True, device=device)
        results, wall_s = run("keyswitch_v2_num_dev_2",
                              lambda: drive_cpp_keyswitch(rt, vec, ops),
                              "KEYSWITCH", len(ops), keyswitch_launches(L), BATCH)
        for i, exp in enumerate(want):
            np.testing.assert_array_equal(results[i], exp, err_msg=f"NUM_DEV=2, op {i}")
        assert out["runs"]["keyswitch_v2_num_dev_2"]["key_uploads"] == 1
        if not rehearse:
            out["runs"]["keyswitch_v2_num_dev_2"]["cpp_api_ops_per_s"] = len(ops) / wall_s
    finally:
        rt.clear_backend()
        rt.release()

    out["launches"] = totals
    out["batches_by_abi"] = {}
    for r in out["runs"].values():
        out["batches_by_abi"][r["abi"]] = out["batches_by_abi"].get(r["abi"], 0) + r["batches"]
    out["key_uploads_per_keyswitch_run"] = {
        k: r["key_uploads"] for k, r in out["runs"].items()
        if k.startswith("keyswitch_")}
    if not rehearse:
        out["python_api_ops_per_s"] = python_rates
    return out


# ---------------------------------------------------------------------------
# phase 13: the multi-device layer, P ranks as threads on the one card
# ---------------------------------------------------------------------------

# the dp and sp transforms: n, modulus bits, batches; the hoisted Galois
# element 5^3 mod 2n (the reference's dryrun step 6/6)
SHARDED_N, SHARDED_BITS, DP_BATCH, SP_BATCH = 16384, 52, 256, 32
SHARDED_GALOIS_EXP = 3
PSUM_REPS = 20
TORCH_OPS = 200  # about a KeySwitch body's device ops (PERF.md §5)
SYNCED_OPS = 50
SPAWN_TIMEOUT_S = 600

# sharded_path's runs, each a group of ops on one mesh: axes, maker and
# spec (parallel/rank_ops.py), the threaded outputs, and per op its record
# name, the launches it must make and the check of its per-rank outputs
# against the op's oracle; process_ranks runs them again in processes
SHARDED_RUNS = []


def ranks_as_threads(axes, device, maker, spec):
    """maker's ops on every rank of `axes`, ranks as threads on `device`,
    each op once counted: ({name: (per-rank outputs, summary)}, info)."""
    per_rank = run_ranks(functools.partial(rank_ops.counted, maker=maker, spec=spec),
                         axes, device=device, timeout_s=SPAWN_TIMEOUT_S)
    return rank_ops.summarize(per_rank), per_rank[0]["info"]


def check_sharded_kernels(vec, device, q, n, rehearse):
    """The kernels at the shapes the sharded path gives them, against their
    plain versions on the card: ntt_fwd at dp's rows; each rank's block
    tables of the sp pair; the KeySwitch engines, INTT1/INTT2 and tails at
    batch 16 (dp 2 x mp 2) and 1 (mp 4).  Returns the comparisons made."""
    if rehearse:
        return 0
    rng = np.random.default_rng(13)
    made = 0

    def same(name, got, want):
        nonlocal made
        assert_same(name, got, want)
        made += 1

    full = ntt_cuda.modulus_tables(n, q, device=device)
    x = rand_u64(rng, (DP_BATCH // 4, n), 64, device)
    same("ntt_fwd dp", ntt_cuda.ntt_fwd(x, full), ntt_cuda.ntt_fwd_plain(x, full))
    for P in (2, 4):
        S = n // P
        for p in range(P):
            y = rand_u64(rng, (SP_BATCH, S), 64, device)
            ft = ntt_cuda.caller_fwd_tables(S, q, *sharded.fwd_block_tables(n, q, P, p),
                                            device=device)
            tab, pre, last = sharded.inv_block_tables(n, q, P, p)
            it = ntt_cuda.caller_inv_tables(S, q, tab, pre, 1, last, device=device)
            same(f"ntt_fwd sp={P}", ntt_cuda.ntt_fwd(y, ft), ntt_cuda.ntt_fwd_plain(y, ft))
            same(f"ntt_inv sp={P}", ntt_cuda.ntt_inv(y, it), ntt_cuda.ntt_inv_plain(y, it))
    L = vec.decomp_modulus_size
    for j in (0, vec.key_modulus_size - 1):
        tabs = ntt_cuda.modulus_tables(vec.coeff_count, vec.moduli[j], device=device)
        for rows in (L * BATCH // 2, L, BATCH // 2, 2, BATCH, 1):
            z = rand_u64(rng, (rows, vec.coeff_count), 64, device)
            same("ntt_fwd ks", ntt_cuda.ntt_fwd(z, tabs), ntt_cuda.ntt_fwd_plain(z, tabs))
            same("ntt_inv ks", ntt_cuda.ntt_inv(z, tabs), ntt_cuda.ntt_inv_plain(z, tabs))
        for rows in (BATCH, 2):
            e, acc = (rand_u64(rng, (rows, vec.coeff_count), b, device) for b in (53, 58))
            res = w.from_u64_np(rng.integers(0, vec.moduli[j], size=(rows, vec.coeff_count),
                                             dtype=np.uint64), device)
            args = (e, acc, res, tabs, 12345, 678, (678 << 64) // vec.moduli[j])
            same("ntt_fwd_tail ks", ntt_cuda.ntt_fwd_tail(*args),
                 ntt_cuda.ntt_fwd_tail_plain(*args))
    return made


def sharded_ks_launches(L, P, D):
    """Kernel launches of one ShardedKeySwitch.run over mp = P, dp = D:
    INTT1 on every rank, one transform and one MAC per engine and one INTT2
    per limb group, one tail per decomp engine."""
    return {"ntt_inv": L * P * D + D, "ntt_fwd": (L + 1) * D,
            "keyswitch_mac": (L + 1) * D, "ntt_fwd_tail": L * D}


def sharded_path(vec, device, rehearse):
    """The port's parallel/ layer at full width with its ranks as threads on
    the card: the dp NTT, the sp pair at P = 2 and 4, ShardedKeySwitch
    (CKKS at mp 4 and dp 2 x mp 2, BGV, hoisted plain and Galois), each op
    once counted, each against the single-card path (and golden or the
    vector); then the scaling model's inputs, read after the profiler.
    Every run is kept in SHARDED_RUNS for process_ranks."""
    n, bits = (1024, 50) if rehearse else (SHARDED_N, SHARDED_BITS)
    q = int(nt.generate_primes(1, bits, n)[0])
    rng = np.random.default_rng(21)
    out = {"ops": {}, "launches": {}}
    out["kernels_vs_plain_comparisons"] = check_sharded_kernels(vec, device, q, n, rehearse)
    tabs = ntt_cuda.modulus_tables(n, q, device=device)
    SHARDED_RUNS.clear()

    def group(axes, maker, spec, records, processes=True):
        """records: {op: (record name, launches, check(outs) -> extra, extra)};
        processes: process_ranks runs it again"""
        ops, info = ranks_as_threads(axes, device, maker, spec)
        for name, (rec, want, check, extra) in records.items():
            outs, summary = ops[name]
            record(out, rec, summary, want, rehearse, "ms_ranks_on_one_card",
                   mesh=axes, **info, **extra, **(check(outs) or {}))
        if processes:
            SHARDED_RUNS.append({"axes": axes, "maker": maker, "spec": spec,
                                 "records": records,
                                 "outs": {name: ops[name][0] for name in records}})

    def rows_equal(want, axis=0, what=""):
        def check(outs):
            np.testing.assert_array_equal(np.concatenate(outs, axis), want, err_msg=what)
        return check

    def each_equal(want, what):
        def check(outs):
            for o in outs:
                np.testing.assert_array_equal(o, want, err_msg=what)
        return check

    # 1. dp: batch sharding, no collective
    a = rng.integers(0, q, size=(DP_BATCH, n), dtype=np.uint64)
    want = w.to_u64_np(ntt_cuda.ntt_fwd(w.from_u64_np(a, device), tabs))
    sample = [0, DP_BATCH - 1]
    np.testing.assert_array_equal(want[sample], golden.fwd_ntt(a[sample], q))
    group({"dp": 4}, rank_ops.dp_ntt, {"n": n, "q": q, "x": a}, {
        "batch_sharded_fwd_ntt": ("batch_sharded_fwd_ntt", {"ntt_fwd": 4},
                                  rows_equal(want, 0, "dp vs single-card ntt_fwd"),
                                  {"n": n, "batch": DP_BATCH})})

    # 2. sp: the binary-exchange pair, forward against the single card, the
    # round trip, and INTT -> NTT chained on the rank tensors
    a = rng.integers(0, q, size=(SP_BATCH, n), dtype=np.uint64)
    want_f = w.to_u64_np(ntt_cuda.ntt_fwd(w.from_u64_np(a, device), tabs))
    for P in (2, 4):
        group({"sp": P}, rank_ops.sp_pair, {"n": n, "q": q, "x": a, "want_f": want_f}, {
            "dist_fwd_ntt": (f"dist_fwd_ntt sp={P}", {"ntt_fwd": P},
                             rows_equal(want_f, 1, f"sp={P} forward vs single card"),
                             {"n": n, "batch": SP_BATCH}),
            "dist_inv_ntt": (f"dist_inv_ntt sp={P}", {"ntt_inv": P},
                             rows_equal(a, 1, f"sp={P} round trip"),
                             {"n": n, "batch": SP_BATCH})})

    # 3. ShardedKeySwitch on the vector: mp 4 at batch 1 against its
    # expected output, dp 2 x mp 2 at batch 32 against the single-card body,
    # the same in BGV mode
    nv, L, K = vec.coeff_count, vec.decomp_modulus_size, vec.key_modulus_size
    cfg = (nv, L, K, vec.rns_modulus_size, 2, vec.moduli, vec.twiddle_factors)
    keyed = (vec.key_vectors, vec.modswitch_factors)
    ks_spec = {"n": nv, "L": L, "K": K, "moduli": list(vec.moduli),
               "keys": vec.key_vectors, "msf": vec.modswitch_factors}

    group({"mp": 4}, rank_ops.keyswitch,
          {**ks_spec, "rs": vec.input[None], "ts": vec.t_target_iter_ptr[None]}, {
              "run": ("keyswitch mp=4", sharded_ks_launches(L, 4, 1),
                      each_equal(vec.expected_output[None], "mp 4 vs expected_output"),
                      {"batch": 1, "checked": "expected_output"})})

    ops = make_ops(vec, BATCH, seed=13)
    rs = np.stack([r for r, _ in ops])
    ts = np.stack([t for _, t in ops])
    single = keyswitch_cuda.get_context(*cfg, device=device)
    keys, kp = single.device_keys(vec.key_vectors)
    h_t, h_c = single.stage_target(ts), single.stage_ciphertext(rs)
    msf = single.prepare_msf4(vec.modswitch_factors)
    base = w.to_u64_np(single._build(h_t.data, keys, kp, h_c.data, msf)).reshape(BATCH, -1)
    np.testing.assert_array_equal(base[0], vec.expected_output)
    mesh22 = {"dp": 2, "mp": 2}
    group(mesh22, rank_ops.keyswitch, {**ks_spec, "rs": rs, "ts": ts}, {
        "run": ("keyswitch dp=2 x mp=2", sharded_ks_launches(L, 2, 2),
                each_equal(base, "dp 2 x mp 2 vs single card"),
                {"batch": BATCH, "checked": "single-card _build"})})

    bgv_base = keyswitch_cuda.get_context(
        *cfg, device=device, plain_modulus=PLAIN_MODULUS).run_batch(rs, ts, *keyed)
    assert not np.array_equal(bgv_base, base)
    group(mesh22, rank_ops.keyswitch,
          {**ks_spec, "rs": rs, "ts": ts, "plain_modulus": PLAIN_MODULUS}, {
              "run": ("keyswitch BGV dp=2 x mp=2", sharded_ks_launches(L, 2, 2),
                      each_equal(bgv_base, "BGV vs single card"),
                      {"batch": BATCH, "plain_modulus": PLAIN_MODULUS,
                       "checked": "single-card BGV context"})})

    # 4. hoisting at mp 2: the decomposition once, the plain and the Galois
    # apply against the single-card run_hoisted
    g = pow(5, SHARDED_GALOIS_EXP, 2 * nv)
    dec1 = single.hoist(h_t)
    want_plain = single.run_hoisted(dec1, h_c, *keyed).to_host()
    want_g = single.run_hoisted(dec1, h_c, *keyed, galois=g).to_host()
    np.testing.assert_array_equal(want_plain, base)
    group({"mp": 2}, rank_ops.hoisted, {**ks_spec, "rs": rs, "ts": ts, "galois": g}, {
        "hoist": ("hoist mp=2", {"ntt_inv": 2 * L, "ntt_fwd": L + 1},
                  lambda outs: {"planes_per_rank": outs}, {"batch": BATCH}),
        "run_hoisted": ("run_hoisted mp=2",
                        {"ntt_inv": 1, "keyswitch_mac": L + 1, "ntt_fwd_tail": L},
                        each_equal(want_plain, "run_hoisted vs single card"),
                        {"batch": BATCH, "checked": "single-card run_hoisted"}),
        "run_hoisted galois": ("run_hoisted galois mp=2",
                               {"ntt_inv": 1, "keyswitch_mac": L + 1, "ntt_fwd_tail": L},
                               each_equal(want_g, "run_hoisted galois vs single card"),
                               {"batch": BATCH, "galois": g,
                                "checked": "single-card run_hoisted(galois)"})})

    # 5. the glue alone (no kernel of ours, no collective), one rank and
    # four: TORCH_OPS small torch ops a rank, then SYNCED_OPS each followed
    # by a read of one value to the host
    for P in (1, 4):
        for ops_per_rank, sync in ((TORCH_OPS, False), (SYNCED_OPS, True)):
            what = f"{ops_per_rank} torch ops{' each read back' if sync else ''}"
            group({"mp": P}, rank_ops.torch_ops,
                  {"rows": 2, "n": n, "ops": ops_per_rank, "sync": sync}, {
                      "torch_ops": (f"{what} a rank mp={P}", {}, lambda outs: None,
                                    {"ops_per_rank": ops_per_rank, "read_back": sync})},
                  processes=P > 1)

    # 6. one collective's own cost: PSUM_REPS psums of one value over mp 4
    group({"mp": 4}, rank_ops.psum_of_one, {"axis": "mp", "reps": PSUM_REPS}, {
        "psum": (f"psum of one value x{PSUM_REPS} mp=4", {}, lambda outs: None,
                 {"reps": PSUM_REPS})})
    if not rehearse:
        small = out["ops"][f"psum of one value x{PSUM_REPS} mp=4"]["ms_ranks_on_one_card"]
        out["psum_of_one_value_ms_mp4"] = small / PSUM_REPS
        PROJECTION_LATER.update(
            body=lambda: single._build(h_t.data, keys, kp, h_c.data, msf),
            collective_ms=small / PSUM_REPS)
    out.update(n=n, modulus_bits=bits, vector=vec.config_name, batch=BATCH,
               ranks_on_one_card=True, collectives="gloo",
               gloo_takes_cuda=sorted(mesh_mod.GLOO_TAKES_CUDA))
    return out


def record(out, name, summary, want_launches, rehearse, ms_key, **extra):
    """One op's summary into out["ops"] (its `ms` named ms_key) and its
    launches into out["launches"]; on the card the launches must be
    want_launches (the plain versions off the card count none)."""
    got = {k: v for k, v in summary["launches"].items() if v}
    summary = dict(summary)
    summary[ms_key] = summary.pop("ms")
    if rehearse:  # no timings off the card
        del summary[ms_key], summary["ms_per_rank"], summary["collective_ms_max_rank"]
    else:
        assert got == want_launches, (name, got, want_launches)
    for k, v in got.items():
        out["launches"][k] = out["launches"].get(k, 0) + v
    out["ops"][name] = {**summary, **extra}


# ---------------------------------------------------------------------------
# phase 14: the same runs with the ranks as processes of their own
# ---------------------------------------------------------------------------


def child_pids() -> set:
    """The live children of this process (Linux /proc)."""
    kids = set()
    for tid in os.listdir(f"/proc/{os.getpid()}/task"):
        with open(f"/proc/{os.getpid()}/task/{tid}/children") as f:
            kids.update(int(p) for p in f.read().split())
    return kids


def process_ranks(rehearse, threaded):
    """sharded_path's runs again with the ranks as processes of their own
    (`spawn_ranks`: python -m per rank, `Mesh.from_env`, one TCPStore),
    spawned once per world size, every group of that size in one spawn on
    meshes of its own prefix; ranks on the card take cuda:(LOCAL_RANK %
    cards), here all cuda:0.  Every output equal to the threaded run's and
    to the op's oracle, the launches (summed over the ranks' processes) to
    sharded_path's, and no child left once a spawn returns.  The ms are one
    card's, with gloo through host memory: not scaling numbers."""
    out = {"ops": {}, "launches": {}, "spawns": []}
    by_world = {}
    for i, run in enumerate(SHARDED_RUNS):
        by_world.setdefault(math.prod(run["axes"].values()), []).append((f"g{i}", run))
    for size, runs in sorted(by_world.items()):
        before = child_pids()
        t0 = time.perf_counter()
        per_rank = mesh_mod.spawn_ranks(
            rank_ops.counted_groups, {"world": size},
            device="cpu" if rehearse else None, timeout_s=SPAWN_TIMEOUT_S,
            args=([(prefix, run["axes"], run["maker"], run["spec"])
                   for prefix, run in runs],))
        spawn_s = time.perf_counter() - t0
        left = child_pids() - before
        assert not left, f"children left after spawn_ranks: {sorted(left)}"
        out["spawns"].append({"ranks": size, "groups": len(runs), "s": spawn_s,
                              "children_left": 0})
        for gi, (_, run) in enumerate(runs):
            ops = rank_ops.summarize([r[gi] for r in per_rank])
            for name, (rec, want, check, extra) in run["records"].items():
                outs, summary = ops[name]
                assert summary["processes"] == size, (rec, summary["processes"])
                more = check(outs) or {}
                for got, thr in zip(outs, run["outs"][name]):
                    if isinstance(got, np.ndarray):
                        np.testing.assert_array_equal(got, thr, err_msg=f"{rec}: "
                                                      "processes vs threads")
                    else:
                        assert got == thr, (rec, got, thr)
                record(out, rec, summary, want, rehearse, "ms_ranks_in_processes",
                       mesh=run["axes"], **per_rank[0][gi]["info"], **extra, **more)
                if not rehearse:
                    out["ops"][rec]["ms_ranks_on_one_card"] = \
                        threaded[rec]["ms_ranks_on_one_card"]
    if not rehearse:
        small = out["ops"][f"psum of one value x{PSUM_REPS} mp=4"]["ms_ranks_in_processes"]
        out["psum_of_one_value_ms_mp4"] = small / PSUM_REPS
    out.update(ranks_in_processes=True, collectives="gloo", launcher="spawn_ranks",
               not_scaling="one card; gloo through host memory")
    return out


# ---------------------------------------------------------------------------
# phase 15: the port's examples (examples_torch/), on the card
# ---------------------------------------------------------------------------

EXAMPLES = ("example_dyadic_multiply", "example_cpp_api", "example_ckks", "example_bgv",
            "example_bfv", "example_rotate_chain", "example_matvec", "example_multichip")
# the runtime knobs a user's shell would not have set: the examples run at
# their defaults, not at the batch sizes the earlier phases left behind
RUNTIME_ENV_PREFIXES = ("RUN_CHOICE", "BATCH_SIZE_", "NUM_DEV", "FPGA_", "HEXL_TPU_")
# rows of each kernel at n = 256 .. 4096 that the examples give it (a batch
# of one ciphertext: 1 to 3 limbs, pairs, the hoisted matvec's stacked
# rotations, the sp blocks of 1024 / P) and dyadic_mul's (B, M)
EXAMPLE_ROWS = (1, 2, 3, 4, 6, 8, 16, 32)
EXAMPLE_DYADIC = ((1, 1), (1, 2), (1, 3), (1, 4), (1, 9), (4, 3))
EXAMPLE_SPLIT_ROWS = (1, 2, 3, 32)


@contextlib.contextmanager
def runtime_knobs_cleared():
    """The runtime knobs the earlier phases left in the environment taken
    out for the block (a phase sets its own), and put back after it."""
    knobs = {k: v for k, v in os.environ.items() if k.startswith(RUNTIME_ENV_PREFIXES)}
    for k in knobs:
        del os.environ[k]
    config_mod.reset_config()
    try:
        yield
    finally:
        for k in [k for k in os.environ if k.startswith(RUNTIME_ENV_PREFIXES)]:
            del os.environ[k]
        os.environ.update(knobs)
        config_mod.reset_config()


def check_example_shapes(device):
    """ntt_fwd and ntt_inv at EXAMPLE_ROWS x n = 256 .. 4096, ntt_fwd_tail at
    n = 1024 and 4096, dyadic_mul at EXAMPLE_DYADIC x n = 1024 and 4096, each
    against its plain version on the card (45- and 48-bit moduli, the
    examples'); the split row_split chose at n = 1024 and 4096.  Returns
    (comparisons, max_abs_err by kernel, split)."""
    rng = np.random.default_rng(15)
    err = {"ntt_fwd": 0, "ntt_inv": 0, "ntt_fwd_tail": 0, "dyadic_mul": 0}
    made = 0

    def same(name, got, want):
        nonlocal made
        err[name] = max(err[name], assert_same(f"{name} {tuple(got.shape)}", got, want))
        made += 1

    for n in (256, 512, 1024, 4096):
        q = int(nt.generate_primes(1, 45, n)[0])
        tabs = ntt_cuda.modulus_tables(n, q, device=device)
        for rows in EXAMPLE_ROWS:
            x = rand_u64(rng, (rows, n), 64, device)
            same("ntt_fwd", ntt_cuda.ntt_fwd(x, tabs), ntt_cuda.ntt_fwd_plain(x, tabs))
            same("ntt_inv", ntt_cuda.ntt_inv(x, tabs), ntt_cuda.ntt_inv_plain(x, tabs))
            if n >= 1024:
                msf = int(rng.integers(1, q))
                tail = (rand_u64(rng, (rows, n), 53, device), rand_u64(rng, (rows, n), 58, device),
                        w.from_u64_np(rng.integers(0, q, size=(rows, n), dtype=np.uint64),
                                      device), tabs, q - 4321, msf, (msf << 64) // q)
                same("ntt_fwd_tail", ntt_cuda.ntt_fwd_tail(*tail),
                     ntt_cuda.ntt_fwd_tail_plain(*tail))
    for n, bits in ((1024, 45), (4096, 48)):
        primes = nt.generate_primes(9, bits, n)
        for B, M in EXAMPLE_DYADIC:
            runner = dyadic_cuda.runner(primes[:M], device)
            qcol = np.array(primes[:M], dtype=np.uint64).reshape(1, 1, M, 1)
            x, y = (w.from_u64_np(rng.integers(0, 1 << 63, size=(B, 2, M, n),
                                               dtype=np.uint64) % qcol, device)
                    for _ in range(2))
            same("dyadic_mul", runner.run(x, y),
                 dyadic_cuda.dyadic_multiply_plain(x, y, runner.meta))
    split = {name: {n: {rows: split_fields(name, rows, n) for rows in EXAMPLE_SPLIT_ROWS}
                    for n in (1024, 4096)}
             for name in ("ntt_fwd", "ntt_inv", "ntt_fwd_tail")}
    return made, err, split


def examples_path(device, rehearse):
    """Every port example's main() in this process (the multichip example
    spawns its ranks: one per card, four on one card), with the runtime
    knobs of the earlier phases out of the environment: its printed checks,
    seconds and launches by kernel (the multichip ranks' summed over their
    processes).  Any failed check raises.  Before them, the kernels at the
    examples' shapes against their plain versions."""
    out = {"examples": {}, "launches": {}}
    if not rehearse:
        made, err, split = check_example_shapes(device)
        out.update(kernels_vs_plain_comparisons=made, max_abs_err=err, split=split)
    with runtime_knobs_cleared():
        for name in EXAMPLES:
            mod = importlib.import_module(f"examples_torch.{name}")
            printed = io.StringIO()
            rank_ops.reset_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(printed):
                value = mod.main("cpu" if rehearse else None)
            s = time.perf_counter() - t0
            launches = rank_ops.counts()
            if name == "example_multichip":
                assert not launches, launches  # every launch is a rank's
                launches = value["launches"]
            if not rehearse:
                assert launches, f"{name}: no kernel launched"
            for k, v in launches.items():
                out["launches"][k] = out["launches"].get(k, 0) + v
            out["examples"][name] = {"s": s, "launches": launches,
                                     "printed": printed.getvalue().splitlines()}
    return out


# ---------------------------------------------------------------------------
# phase 16: the envelope the API accepts (utils/fuzz_card.py), on the card
# ---------------------------------------------------------------------------

ENVELOPE_SEED = 12
CHECKED_WRAPPERS = ("ntt_fwd", "ntt_inv", "ntt_fwd_tail", "ntt_fwd_mac", "keyswitch_mac",
                    "dyadic_multiply")


def envelope_grids(rehearse):
    """fuzz_card's quick grid; for the rehearsal one configuration of each
    kind at n = 1024."""
    if not rehearse:
        return fuzz_card.grids(quick=True)
    return (fuzz_card.transform_grid(sizes=(1024,), widths=(20, 62)),
            [fuzz_card.keyswitch_edge(1024, 1, 2, "smallest", seed=1)],
            fuzz_card.dyadic_grid(sizes=(1024,), ms=(1,), widths=(17, 60)))


def envelope_path(device, rehearse):
    """First sanitize_kernels' corner shapes (the split cores at C = 1, 2, 4,
    the tail, the MAC's cluster of 2 with and without a skipped limb, the
    dyadic product) each against its plain version; then fuzz_card's quick
    grid: transforms up to 62-bit moduli, KeySwitch at the envelope's edges
    (both schedules and the API), DyadicMultiply at 17 .. 60 bits, each
    against the golden model, and every launch of the grid against its
    plain version on the same inputs.  Prints each configuration's line."""
    out = {}
    with runtime_knobs_cleared():
        if not rehearse:
            corners = sanitize_kernels.check(device)
            assert all(v == "equal" for v in corners.values()), corners
            out["corner_shapes_vs_plain"] = corners
        printed = []
        summary = fuzz_card.run(device, *envelope_grids(rehearse), seed=ENVELOPE_SEED,
                                echo=printed.append)
    assert not summary.failures, summary.failures
    if not rehearse:
        assert all(summary.kernels_vs_plain.get(k) for k in CHECKED_WRAPPERS), \
            summary.kernels_vs_plain
    out.update(
        configs=summary.configs, comparisons_vs_golden=summary.comparisons,
        by_kind=summary.by_kind, kernels_vs_plain_comparisons=summary.kernels_vs_plain,
        edges=summary.edges, fuzz_s=summary.s, launches=summary.launches,
        printed=printed)
    return out


# ---------------------------------------------------------------------------
# phase 17: two workers (NUM_DEV = 2) through the Python API on the one card
# ---------------------------------------------------------------------------

MULTI_WORKERS = 2
MULTI_NTT_OPS = 256
MULTI_NTT_BATCH = 64


def multi_worker_path(vec, device, rehearse, ops, want, single_rates):
    """The main path's 64 KeySwitch ops (batches of 32), the dyadic path's 64
    ops (batches of 32) and 256 _NTT then 256 _INTT at n = 16384 (batches of
    64) through the API with NUM_DEV = 2: one executor a worker, each on
    cuda:(i % cards), so both on the one card.  A first pass stages, the
    second is counted; every op against the golden model (the dyadic path's
    oracle; the round trip).  Prints the batches each worker served, each
    executor's device, api_ops_per_s beside the NUM_DEV = 1 rates, and
    launches summed over both workers, asserted equal to the batches times
    the per-batch counts.  No scaling claim: the workers share one card."""
    L = vec.decomp_modulus_size
    n_dy, moduli, op1, op2, dy_want, _ = dyadic_data(rehearse)
    n, bits, count, batch = ((1024, 52, 64, 16) if rehearse
                             else (NTT_CELLS[0][0], NTT_CELLS[0][1], MULTI_NTT_OPS,
                                   MULTI_NTT_BATCH))
    q, t, src, want_fwd, _ = ntt_data(n, bits, 64 if rehearse else NTT_CELLS[0][2])
    src, want_fwd = src[:count], want_fwd[:count]
    fwd = lambda b: hexl._NTT(b, t.fwd, t.fwd_precon, q, n)
    inv = lambda b: hexl._INTT(b, t.inv, t.inv_precon, q, t.inv_n, t.inv_n_w, n)

    def everything():
        ks, ks_s = drive_api(vec, ops)
        dy, dy_s = drive_dyadic(op1, op2, n_dy, moduli)
        f, f_s = drive_transform(src, fwd, hexl._set_worksize_NTT, hexl._NTTCompleted)
        i, i_s = drive_transform(f, inv, hexl._set_worksize_INTT, hexl._INTTCompleted)
        return (ks, dy, f, i), (ks_s, dy_s, f_s, i_s)

    with runtime_knobs_cleared():
        start_runtime(rehearse, NUM_DEV=MULTI_WORKERS, BATCH_SIZE_KEYSWITCH=BATCH,
                      BATCH_SIZE_DYADIC_MULTIPLY=BATCH, BATCH_SIZE_NTT=batch,
                      BATCH_SIZE_INTT=batch)
        pool = scheduler.pool()
        try:
            first, _ = everything()  # stages keys, tables and constants
            for d in pool.devices:
                d.served.clear()
            ntt_cuda.reset_launch_counts()
            dyadic_cuda.reset_launch_counts()
            graphs = dict(keyswitch_cuda.GRAPHS)
            counted, secs = everything()
            ks_served, graphs = keyswitch_bodies(graphs)
            launches = {k: v for k, v in {**ntt_cuda.LAUNCHES, **dyadic_cuda.LAUNCHES}.items()
                        if v}
            served = [dict(d.served) for d in pool.devices]
            devices = [str(d.executor.device) for d in pool.devices]
        finally:
            hexl.release_FPGA_resources()

    for results in (first, counted):
        ks, dy, f, i = results
        for k, exp in enumerate(want):
            np.testing.assert_array_equal(ks[k], exp, err_msg=f"KeySwitch op {k}")
        for k in range(WORKSIZE):
            np.testing.assert_array_equal(dy[k], dy_want[k].reshape(-1),
                                          err_msg=f"DyadicMultiply op {k}")
        np.testing.assert_array_equal(np.stack(f), want_fwd)
        np.testing.assert_array_equal(np.stack(i), src)  # the round trip
    assert len(served) == MULTI_WORKERS and all(served), served  # both workers served
    batches = {op: sum(s.get(op, 0) for s in served) for op in
               (scheduler.KEYSWITCH, scheduler.DYADIC_MULTIPLY, scheduler.NTT, scheduler.INTT)}
    ks_b = batches[scheduler.KEYSWITCH]
    assert ks_served == ks_b, (graphs, batches)
    ks = keyswitch_launches(L, ks_b)
    expected = {**ks, "ntt_fwd": ks["ntt_fwd"] + batches[scheduler.NTT],
                "ntt_inv": ks["ntt_inv"] + batches[scheduler.INTT],
                "dyadic_mul": batches[scheduler.DYADIC_MULTIPLY]}
    assert launches == ({} if rehearse else expected), (launches, expected)

    out = {"workers": MULTI_WORKERS, "executor_devices": devices,
           "batches_served_by_worker": served, "batches": batches,
           "ops": {"keyswitch": len(ops), "dyadic": WORKSIZE, "ntt": count, "intt": count},
           "batch": {"keyswitch": BATCH, "dyadic": BATCH, "ntt": batch},
           "ops_checked_vs_golden": 2 * (len(ops) + WORKSIZE + 2 * count),
           "launches": launches, "keyswitch_graphs": graphs,
           "not_scaling": "two workers share one card"}
    if not rehearse:
        ks_s, dy_s, f_s, i_s = secs
        out["api_ops_per_s"] = {"keyswitch": len(ops) / ks_s, "dyadic": WORKSIZE / dy_s,
                                "ntt": count / f_s, "intt": count / i_s}
        out["api_ops_per_s_num_dev_1"] = single_rates
    return out


# the scaling model's inputs that need the profiler: filled by sharded_path,
# read after profile_kernels
PROJECTION_LATER = {}


def projection_block(paths, smi):
    """parallel/projection.py's model fed with this run's single-card
    numbers: the KeySwitch body and hoisted apply at batch 32
    (device_path), one _NTT body of 256 rows (ntt_path), alpha = the NTT
    kernels' share of the default body's busy time (torch.profiler), and
    one collective's own cost: sharded_path's psum of one value (gloo,
    ranks as threads on one card)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, wall = wall_ms(PROJECTION_LATER["body"])
    alpha = device_table(prof, wall)["ntt_kernels_share_of_busy"]
    inputs = {
        "t1_ks_ms": paths["device_path"]["build_ms_per_batch"]["default"],
        "t1_hoisted_ms": paths["device_path"]["hoisted_apply_ms"],
        "t1_ntt_ms": paths["ntt_path"]["cells"][0]["fwd_body_ms_per_batch"],
        "ntt_batch": paths["ntt_path"]["cells"][0]["batch"],
        "alpha": alpha, "collective_ms": PROJECTION_LATER["collective_ms"],
    }
    text = projection.report(
        inputs["t1_ks_ms"], inputs["t1_hoisted_ms"], inputs["t1_ntt_ms"],
        alpha, inputs["collective_ms"], ks_batch=BATCH,
        ntt_batch=inputs["ntt_batch"], device=smi)
    return {"inputs": inputs, "model": text.splitlines()}


def seconds_of(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def main(rehearse: bool = False) -> int:
    faulthandler.enable()  # a crash in native code prints the Python stacks
    if rehearse:
        device = torch.device("cpu")
        vec = vectors.make_keyswitch_vector(1024, 6, 7, seed=5, modulus_bits=50)
        cpp_build_s = seconds_of(cpp_bridge.build_library)
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
        # one nvcc per source and the C++ runtime's g++ build, together
        with ThreadPoolExecutor(4) as pool:
            builds = [pool.submit(ntt_cuda.build_kernels),
                      pool.submit(dyadic_cuda.build_kernels),
                      pool.submit(rns_behz_cuda.build_kernels),
                      pool.submit(seconds_of, cpp_bridge.build_library)]
            cpp_build_s = [b.result() for b in builds][-1]
        emit({"device": smi, "kernel_build_s": time.perf_counter() - t0,
              "cpp_library_build_s": cpp_build_s,
              "torch": torch.__version__, "cuda": torch.version.cuda})
        vec = vectors.load_json(VECTOR)

    kernels, at_path_shape = [], []
    if not rehearse:
        t0 = time.perf_counter()
        emit({"split_sweep": {"comparisons": check_split_sweep(device),
                              "max_abs_err": 0, "s": time.perf_counter() - t0}})
        kernels = check_kernels(vec, device)
        kernels.append(check_mac_kernel(vec, device))
        kernels.append(check_keyswitch_mac_kernel(vec, device))
        kernels.append(check_dyadic_kernel(device))
        at_32768, at_path_shape = check_standalone_transforms(device)
        kernels += at_32768
    ops, want, golden_s = golden_ops(vec)
    paths = {}

    def run(name, fn, *args):
        t0 = time.perf_counter()
        paths[name] = fn(*args)
        paths[name]["s"] = time.perf_counter() - t0
        print(f"chip_smoke: {name} passed in {paths[name]['s']:.1f} s",
              file=sys.stderr, flush=True)

    run("main_path", main_path, vec, device, rehearse, ops, want, golden_s)
    run("copy_overlap", copy_overlap_path, vec, device, rehearse)
    run("dyadic_path", dyadic_path, device, rehearse)
    run("ntt_path", ntt_path, device, rehearse)
    run("device_path", device_path, vec, device, rehearse)
    run("wire_pack", wire_pack_path, vec, device, rehearse, ops, want,
        paths["main_path"].get("api_ops_per_s"))
    run("ckks_path", ckks_path, device, rehearse)
    run("bgv_path", bgv_path, vec, device, rehearse)
    run("bfv_path", bfv_path, vec, device, rehearse)
    run("16384_5_7_6_2_0", idle_modulus_vector, device, rehearse)
    python_rates = {
        "keyswitch": paths["main_path"].get("api_ops_per_s"),
        "dyadic": paths["dyadic_path"].get("api_ops_per_s"),
        "ntt": paths["ntt_path"]["cells"][0].get("ntt_api_ops_per_s"),
        "intt": paths["ntt_path"]["cells"][0].get("intt_api_ops_per_s"),
    }
    run("cpp_path", cpp_path, vec, device, rehearse, ops, want, python_rates,
        cpp_build_s)
    # its rank threads are joined and their groups shut down when it returns
    run("sharded_path", sharded_path, vec, device, rehearse)
    run("process_ranks", process_ranks, rehearse, paths["sharded_path"]["ops"])
    run("examples_path", examples_path, device, rehearse)
    run("envelope_path", envelope_path, device, rehearse)
    run("multi_worker", multi_worker_path, vec, device, rehearse, ops, want, python_rates)
    if at_path_shape:
        paths["ntt_path"]["row_kernels_at_path_shape"] = at_path_shape
    profile_kernels()
    if not rehearse:
        emit({"projection": projection_block(paths, smi)})
    ntt_cells = {c["n"]: c["launches"] for c in paths["ntt_path"]["cells"]}
    for k in kernels:
        if k["replaces"].startswith("hexl_fpga_tpu/ops/ntt_pallas.py"):
            # B6 at n = 32768: the _NTT / _INTT cell's own counted pass
            k["launches"] = ntt_cells[k["shape"][1]].get(k["name"], 0)
        else:  # summed over the paths' counted passes
            k["launches_by_path"] = {
                name: p["launches"][k["name"]] for name, p in paths.items()
                if p["launches"].get(k["name"])}
            k["launches"] = sum(k["launches_by_path"].values())
        assert k["launches"] > 0, k["name"]
    for name, path in paths.items():
        emit({name: path})
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
