"""Device-resident CKKS rotation chain on the card.

A chain of slot rotations (the hot pattern in CKKS matrix-vector products
and bootstrapping) in which the ciphertext NEVER returns to the host
between ops: each rotation is an NTT-domain permutation gather and the
keyswitch kernels, and the chain pays one device->host transfer at the
end.  The port's counterpart of `examples/example_rotate_chain.py`, at its
configuration and seed.

    python examples_torch/example_rotate_chain.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hexl_fpga_tpu_torch import api, config  # noqa: E402
from hexl_fpga_tpu_torch.integrations import ckks  # noqa: E402
from hexl_fpga_tpu_torch.ops import nt  # noqa: E402

NOISE = 1e-2


def main(device=None):
    """Runs on the card (device None), or with the kernels' plain versions
    on the CPU (device "cpu"); returns the decryption error."""
    n = 1024
    moduli = nt.generate_primes(4, 45, n)  # 3 decomp primes + special
    ctx = ckks.CkksContext(n, moduli, scale=2.0**45, seed=7)
    with config.run_choice_for(device) as name:
        api.acquire_FPGA_resources()

        rng = np.random.default_rng(0)
        z = rng.standard_normal(ctx.slots) + 1j * rng.standard_normal(ctx.slots)
        ct = ctx.encrypt(z)

        ev = ckks.DeviceCkksEvaluator(ctx, device or "cuda")
        h = ev.stage(ct)                    # host -> device, once
        depth = 4
        for _ in range(depth):
            h = ev.rotate(h, 1)             # gather + keyswitch, on device
        out = ev.to_host(h)                 # device -> host, once
        back = ctx.decrypt(out)

        want = np.roll(z, -depth)
        err = np.max(np.abs(back - want))
        print(f"rotation chain depth {depth} on {name}: max |err| = {err:.2e}")
        if not err < NOISE:
            raise AssertionError(f"decryption error {err} above {NOISE}")
        api.release_FPGA_resources()
    print("OK")
    return err


if __name__ == "__main__":
    main()
