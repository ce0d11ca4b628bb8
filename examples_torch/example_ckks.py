"""CKKS end-to-end demo on the card: encrypt, square (DyadicMultiply),
relinearize (KeySwitch), rescale, rotate, decrypt: the workload the
reference's SEAL bridge accelerates.  The port's counterpart of
`examples/example_ckks.py`, at its configuration and seed.

    python examples_torch/example_ckks.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hexl_fpga_tpu_torch import api, config  # noqa: E402
from hexl_fpga_tpu_torch.integrations import ckks  # noqa: E402
from hexl_fpga_tpu_torch.ops import nt  # noqa: E402

NOISE = 1e-2  # decryption error on values of order 1 (the reference's tests)


def main(device=None):
    """Runs on the card (device None), or with the kernels' plain versions
    on the CPU (device "cpu"); returns the two decryption errors."""
    n = 1024
    moduli = nt.generate_primes(4, 45, n)
    ctx = ckks.CkksContext(n, moduli, scale=2.0**45, seed=7)
    with config.run_choice_for(device) as name:
        api.acquire_FPGA_resources()

        rng = np.random.default_rng(0)
        z = rng.uniform(0.5, 1.5, size=ctx.slots)
        ct = ctx.encrypt(z)
        print(f"encrypted {ctx.slots} slots at scale 2^45 on {name}")

        sq = ctx.rescale(ctx.multiply_relin(ct, ct))
        err_sq = np.max(np.abs(ctx.decrypt(sq) - z * z))
        print(f"square + relinearize + rescale: max abs error {err_sq:.3e}")

        rot = ctx.rotate(ct, 3)
        err_rot = np.max(np.abs(ctx.decrypt(rot) - np.roll(z, -3)))
        print(f"rotate by 3: max abs error {err_rot:.3e}")

        api.release_FPGA_resources()
    if not (err_sq < NOISE and err_rot < NOISE):
        raise AssertionError(f"decryption error above {NOISE}")
    print("done")
    return err_sq, err_rot


if __name__ == "__main__":
    main()
