"""Standalone dyadic-multiply demo with validation, on the card: enqueue a
worksize of ciphertext products through the async API, wait, verify each
against the golden model.  The port's counterpart of
`examples/example_dyadic_multiply.py`, at its configuration and seed.

    python examples_torch/example_dyadic_multiply.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hexl_fpga_tpu_torch import api, config  # noqa: E402
from hexl_fpga_tpu_torch.ops import golden, nt  # noqa: E402


def main(device=None):
    """Runs on the card (device None), or with the kernels' plain versions
    on the CPU (device "cpu"); returns (moduli, [(op1, op2, out), ...])."""
    n = 4096
    n_moduli = 3
    worksize = 4
    moduli = np.array(nt.generate_primes(n_moduli, 48, n), dtype=np.uint64)
    rng = np.random.default_rng(0)

    with config.run_choice_for(device) as name:
        api.acquire_FPGA_resources()
        print(f"dyadic multiply: n={n}, {n_moduli} moduli, worksize={worksize} on {name}")

        jobs = []
        api.set_worksize_DyadicMultiply(worksize)
        for _ in range(worksize):
            op1 = rng.integers(0, moduli.min(), size=2 * n_moduli * n, dtype=np.uint64)
            op2 = rng.integers(0, moduli.min(), size=2 * n_moduli * n, dtype=np.uint64)
            out = np.zeros(3 * n_moduli * n, dtype=np.uint64)
            api.DyadicMultiply(out, op1, op2, n, moduli, n_moduli)
            jobs.append((op1, op2, out))
        api.DyadicMultiplyCompleted()

        for i, (op1, op2, out) in enumerate(jobs):
            want = golden.dyadic_multiply(op1, op2, n, moduli, n_moduli)
            np.testing.assert_array_equal(out, want, err_msg=f"job {i} mismatch")
            print(f"job {i}: verified OK")
        api.release_FPGA_resources()
    print("all results validated")
    return moduli, jobs


if __name__ == "__main__":
    main()
