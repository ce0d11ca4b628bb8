"""The C++ API on the card: the port's counterpart of `examples/example_cpp/`.

The C++ example links the unchanged `cpp/` library and calls the
`hexl-fpga.h` functions.  Here the port builds its own copy of that library
(`cpp_bridge`: g++, no cmake), registers itself as the library's
accelerator backend (`register_torch_backend`: the card's kernels serve the
C++ runtime's batches), and makes the same calls through ctypes: a worksize
of DyadicMultiply at the C++ example's n, moduli and worksize, every result
checked against the golden model, and no batch declined or failed (a
declined batch would run on the library's CPU path instead of the card).
The operands come from numpy's generator in place of std::mt19937_64.

    python examples_torch/example_cpp_api.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hexl_fpga_tpu_torch import config, cpp_bridge  # noqa: E402
from hexl_fpga_tpu_torch.ops import golden  # noqa: E402


def main(device=None):
    """Runs on the card (device None), or with the kernels' plain versions
    on the CPU (device "cpu"); returns (moduli, [(op1, op2, out), ...])."""
    n, n_moduli, worksize = 4096, 3, 4
    moduli = np.array([(1 << 48) + 0x4001, (1 << 48) + 0xa001, (1 << 48) + 0x1c001],
                      dtype=np.uint64)
    rt = cpp_bridge.NativeRuntime()  # the library, built from cpp/src
    with config.run_choice_for(device) as name:
        rt.acquire()  # the C++ pool reads RUN_CHOICE here
        try:
            rt.register_torch_backend(device=device)
            print(f"dyadic multiply: n={n}, {n_moduli} moduli, worksize={worksize} "
                  f"through hexl-fpga.h on {name}")

            rng = np.random.default_rng(0)
            qcol = np.repeat(moduli, n)[None].repeat(2, 0).reshape(-1)
            jobs = []
            ptr = cpp_bridge._np_ptr
            rt.lib.hexl_tpu_set_worksize_dyadic_multiply(worksize)
            for _ in range(worksize):
                op1 = rng.integers(0, 1 << 63, size=2 * n_moduli * n, dtype=np.uint64) % qcol
                op2 = rng.integers(0, 1 << 63, size=2 * n_moduli * n, dtype=np.uint64) % qcol
                out = np.zeros(3 * n_moduli * n, dtype=np.uint64)
                jobs.append((op1, op2, out))
                rt.lib.hexl_tpu_dyadic_multiply(ptr(out), ptr(op1), ptr(op2), n,
                                                ptr(moduli), n_moduli)
            if not rt.lib.hexl_tpu_dyadic_multiply_completed():
                raise AssertionError("DyadicMultiplyCompleted returned false")

            for i, (op1, op2, out) in enumerate(jobs):
                want = golden.dyadic_multiply(op1, op2, n, moduli, n_moduli)
                np.testing.assert_array_equal(out, want, err_msg=f"MISMATCH at job {i}")
                print(f"job {i}: verified OK")
            stats = rt.backend_stats()
            served = sum(v.get("DYADIC_MULTIPLY", 0) for v in stats["ops"].values())
            if stats["declines"] or stats["errors"] or served != worksize:
                raise AssertionError(f"the backend did not serve every op: {stats}")
            print(f"served by the backend: {served} ops in "
                  f"{sum(v.get('DYADIC_MULTIPLY', 0) for v in stats['batches'].values())} "
                  "batches, 0 declines, 0 errors")
        finally:
            rt.release()
    print("all results validated")
    return moduli, jobs


if __name__ == "__main__":
    main()
