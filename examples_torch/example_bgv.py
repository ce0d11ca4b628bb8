"""BGV end-to-end demo on the card: exact integer homomorphic arithmetic.

Encrypt two integer vectors (SEAL BatchEncoder-style slots), multiply them
through the accelerated DyadicMultiply, relinearize through the BGV-mode
KeySwitch (GHS-corrected tail: the rounding delta is divisible by t, so the
message mod t is untouched), mod-switch down a level, and decrypt: every
result is EXACT mod t.  The port's counterpart of `examples/example_bgv.py`,
at its configuration and seed.

    python examples_torch/example_bgv.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hexl_fpga_tpu_torch import api, config  # noqa: E402
from hexl_fpga_tpu_torch.integrations import bgv  # noqa: E402
from hexl_fpga_tpu_torch.ops import nt  # noqa: E402


def main(device=None):
    """Runs on the card (device None), or with the kernels' plain versions
    on the CPU (device "cpu")."""
    n, t = 1024, 65537  # t prime, t = 1 (mod 2n) for batching
    moduli = nt.generate_primes(4, 45, n)
    ctx = bgv.BgvContext(n, moduli, t=t, seed=7)
    with config.run_choice_for(device) as name:
        api.acquire_FPGA_resources()

        rng = np.random.default_rng(0)
        z1 = rng.integers(0, t, size=n, dtype=np.uint64)
        z2 = rng.integers(0, t, size=n, dtype=np.uint64)
        ct1, ct2 = ctx.encrypt(z1), ctx.encrypt(z2)
        print(f"encrypted 2 x {n} integer slots mod t={t} on {name}")

        want = (z1.astype(object) * z2 % t).astype(np.uint64)
        prod = ctx.multiply_relin(ct1, ct2)
        np.testing.assert_array_equal(ctx.decrypt(prod), want)
        print("multiply + relinearize: EXACT slotwise product")

        prod = ctx.mod_switch_to_next(prod)
        np.testing.assert_array_equal(ctx.decrypt(prod), want)
        print(f"GHS mod-switch to level {prod.level}: message preserved "
              f"(correction factor {int(prod.scale)})")

        rot = ctx.rotate(ct1, 5)
        np.testing.assert_array_equal(ctx.decrypt(rot).reshape(2, -1),
                                      np.roll(z1.reshape(2, -1), -5, axis=1))
        print("rotate rows by 5: EXACT")

        api.release_FPGA_resources()
    print("done")


if __name__ == "__main__":
    main()
