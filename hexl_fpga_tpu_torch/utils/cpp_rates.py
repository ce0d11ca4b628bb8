"""KeySwitch streams through the C API (`hexl-fpga.h` served by the port's
torch backend) beside the same stream through the Python API, on the card.

    python -m hexl_fpga_tpu_torch.utils.cpp_rates [--rounds 2]

Needs a CUDA device and g++.  At 16384_6_7_7_2 (the frozen vector
`tests/testdata/16384_6_7_7_2_0.json.gz`), 64 ops a stream in batches of 32:
the Python API's rate (its second stream), then, on one C++ pool, for each
registration in v2, v1, v2 the rate of a cold stream (the key set staged in
its window) and of warm ones.  Every C API op is held against the Python
API's output for the same op.  Prints one JSON object of ops per second.
To compare two trees, run it from each in one chip call, alternating.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

import hexl_fpga_tpu_torch as hexl
from hexl_fpga_tpu_torch import config as config_mod, cpp_bridge
from hexl_fpga_tpu_torch.utils import vectors

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
VECTOR = os.path.join(ROOT, "tests", "testdata", "16384_6_7_7_2_0.json.gz")
OPS, BATCH = 64, 32


def make_ops(vec, seed=7):
    """OPS (result, t_target) pairs of canonical residues."""
    n, L = vec.coeff_count, vec.decomp_modulus_size
    rng = np.random.default_rng(seed)
    return [(np.stack([rng.integers(0, vec.moduli[j % L], size=n, dtype=np.uint64)
                       for j in range(2 * L)]).ravel(),
             np.stack([rng.integers(0, vec.moduli[j], size=n, dtype=np.uint64)
                       for j in range(L)]).ravel()) for _ in range(OPS)]


def python_stream(vec, ops):
    results = [r.copy() for r, _ in ops]
    t0 = time.perf_counter()
    hexl.set_worksize_KeySwitch(len(ops))
    for res, (_, t) in zip(results, ops):
        hexl.KeySwitch(res, t, vec.coeff_count, vec.decomp_modulus_size,
                       vec.key_modulus_size, vec.rns_modulus_size,
                       vec.key_component_count, vec.moduli, vec.key_vectors,
                       vec.modswitch_factors, vec.twiddle_factors)
    assert hexl.KeySwitchCompleted()
    return results, time.perf_counter() - t0


def c_stream(rt, vec, ops):
    P = cpp_bridge._np_ptr
    keep = [np.ascontiguousarray(a, dtype=np.uint64) for a in (
        vec.moduli, vec.modswitch_factors, vec.twiddle_factors, *vec.key_vectors)]
    keys = (cpp_bridge.u64_p * vec.decomp_modulus_size)(*[P(k) for k in keep[3:]])
    results = [r.copy() for r, _ in ops]
    args = (vec.coeff_count, vec.decomp_modulus_size, vec.key_modulus_size,
            vec.rns_modulus_size, vec.key_component_count, P(keep[0]), keys,
            P(keep[1]), P(keep[2]))
    ptrs = [(P(r), P(t)) for r, (_, t) in zip(results, ops)]
    t0 = time.perf_counter()
    rt.lib.hexl_tpu_set_worksize_keyswitch(len(ops))
    for r, t in ptrs:
        rt.lib.hexl_tpu_keyswitch(r, t, *args)
    assert rt.lib.hexl_tpu_keyswitch_completed()
    return results, time.perf_counter() - t0


def with_env(env, fn):
    keep = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return fn()
    finally:
        for k, v in keep.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


def main(rounds: int = 2) -> dict:
    vec = vectors.load_json(VECTOR)
    ops = make_ops(vec)
    env = {"RUN_CHOICE": "2", "BATCH_SIZE_KEYSWITCH": str(BATCH)}
    with_env(env, lambda: (config_mod.reset_config(), hexl.acquire_FPGA_resources()))
    python_stream(vec, ops)
    want, py_s = python_stream(vec, ops)
    hexl.release_FPGA_resources()
    out = {"config": vec.config_name, "ops": OPS, "batch": BATCH,
           "python_api_ops_per_s": OPS / py_s}
    rt = cpp_bridge.NativeRuntime()
    with_env(env, rt.acquire)
    try:
        for abi in ("v2", "v1", "v2"):
            rt.register_torch_backend(pipelined=abi == "v2")
            for tag in ["cold"] + ["warm"] * rounds:
                got, s = c_stream(rt, vec, ops)
                for i, (g, w) in enumerate(zip(got, want)):
                    np.testing.assert_array_equal(g, w, err_msg=f"{abi} {tag} op {i}")
                out.setdefault(f"cpp_{abi}_{tag}_ops_per_s", []).append(OPS / s)
        stats = rt.backend_stats()
        assert stats["declines"] == [] and stats["errors"] == [], stats
    finally:
        rt.clear_backend()
        rt.release()
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2, help="warm streams a registration")
    print(json.dumps(main(ap.parse_args().rounds)))
