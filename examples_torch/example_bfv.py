"""BFV end-to-end demo on the card: the reference's other SEAL scheme.

Encrypt integer vectors, multiply exactly (textbook t/Q tensor product),
relinearize through the accelerated KeySwitch, multiply again through the
full-RNS BEHZ multiply on the card, mod-switch down a level, rotate: every
result exact mod t.  The port's counterpart of `examples/example_bfv.py`, at
its configuration and seed.

    python examples_torch/example_bfv.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hexl_fpga_tpu_torch import api, config  # noqa: E402
from hexl_fpga_tpu_torch.integrations import bfv  # noqa: E402
from hexl_fpga_tpu_torch.ops import nt  # noqa: E402


def main(device=None):
    """Runs on the card (device None), or with the kernels' plain versions
    on the CPU (device "cpu")."""
    n, t = 1024, 65537
    moduli = nt.generate_primes(4, 45, n)
    ctx = bfv.BfvContext(n, moduli, t=t, seed=11)
    with config.run_choice_for(device) as name:
        api.acquire_FPGA_resources()

        rng = np.random.default_rng(0)
        z1 = rng.integers(0, t, size=n, dtype=np.uint64)
        z2 = rng.integers(0, t, size=n, dtype=np.uint64)
        print(f"encrypted 2 x {n} integer slots mod t={t} on {name}")
        want = (z1.astype(object) * z2 % t).astype(np.uint64)

        prod = ctx.multiply_relin(ctx.encrypt(z1), ctx.encrypt(z2))
        np.testing.assert_array_equal(ctx.decrypt(prod), want)
        print("multiply (exact t/Q tensor) + accelerated relinearize: EXACT")

        # the full-RNS BEHZ multiply, on the card (BehzCuda: the transform
        # and dyadic kernels, the base conversions as torch lane math)
        d_rns, sc = ctx.multiply_rns(ctx.encrypt(z1), ctx.encrypt(z2))
        prod_rns = ctx.relinearize(d_rns, sc, level=len(moduli) - 2)
        np.testing.assert_array_equal(ctx.decrypt(prod_rns), want)
        print("multiply_rns (device BEHZ) + relinearize: EXACT")

        prod = ctx.mod_switch_to_next(prod)
        np.testing.assert_array_equal(ctx.decrypt(prod), want)
        print(f"divide-and-round mod-switch to level {prod.level}: EXACT")

        rot = ctx.rotate(ctx.encrypt(z1), 3)
        np.testing.assert_array_equal(ctx.decrypt(rot).reshape(2, -1),
                                      np.roll(z1.reshape(2, -1), -3, axis=1))
        print("rotate rows by 3 (accelerated keyswitch): EXACT")

        api.release_FPGA_resources()
    print("done")


if __name__ == "__main__":
    main()
