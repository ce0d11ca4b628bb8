"""Encrypted matrix-vector product with hoisted rotations (BSGS), on the card.

The dominant kernel of encrypted inference and CKKS bootstrapping: apply a
plaintext matrix M to an encrypted vector z via the diagonal method,

    M z = sum_d  diag_d(M) * rot_d(z),

organized baby-step/giant-step so the baby rotations all come from ONE
hoisted keyswitch decomposition (Halevi-Shoup hoisting: the keyswitch
prefix is computed once and each further rotation costs only an NTT-domain
permutation, a MAC and a tail).  The whole computation is device-resident:
one upload, one fetch.  The port's counterpart of
`examples/example_matvec.py`, at its configuration and seed.

    python examples_torch/example_matvec.py
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hexl_fpga_tpu_torch import api, config  # noqa: E402
from hexl_fpga_tpu_torch.integrations import ckks  # noqa: E402
from hexl_fpga_tpu_torch.ops import nt  # noqa: E402

NOISE = 1e-2


def main(device=None):
    """Runs on the card (device None), or with the kernels' plain versions
    on the CPU (device "cpu"); returns the two decryption errors."""
    n = 1024
    moduli = nt.generate_primes(4, 45, n)  # 3 decomp primes + special
    ctx = ckks.CkksContext(n, moduli, scale=2.0**45, seed=7)
    with config.run_choice_for(device) as name:
        api.acquire_FPGA_resources()

        rng = np.random.default_rng(0)
        z = rng.standard_normal(ctx.slots) * 0.5
        # a banded matrix: 6 generalized diagonals
        bands = (0, 1, 2, 16, 17, 33)
        diags = {d: rng.standard_normal(ctx.slots) * 0.5 for d in bands}
        want = sum(diags[d] * np.roll(z, -d) for d in bands)

        ev = ckks.DeviceCkksEvaluator(ctx, device or "cuda")
        h = ev.stage(ctx.encrypt(z))            # host -> device, once
        composed = ev.linear_transform(h, diags, bsgs_n1=16)
        out = ev.rescale(composed)              # scale back to ~2^45
        back = ctx.decrypt(ev.to_host(out))     # device -> host, once

        err = np.max(np.abs(back - want))
        print(f"matvec over {len(bands)} diagonals (BSGS n1=16, hoisted) on {name}: "
              f"max |err| = {err:.2e}")

        # the same computation as ONE device program, bit-identical to the
        # composition above: on the card one CUDA graph, replayed
        fused, program = ev.linear_transform_fused(h, diags, bsgs_n1=16,
                                                   return_program=True)
        replayed = program(h.data)
        for got in (fused.data, replayed):
            if not torch.equal(got, composed.data):
                raise AssertionError("fused matvec differs from the composition")
        fused = ev.rescale(fused)
        err_f = np.max(np.abs(ctx.decrypt(ev.to_host(fused)) - want))
        print(f"fused one-program matvec ({'CUDA graph' if program.graph else 'eager'}, "
              f"bit-identical to the composition): max |err| = {err_f:.2e}")
        if not (err < NOISE and err_f < NOISE):
            raise AssertionError(f"decryption error above {NOISE}")
        api.release_FPGA_resources()
    print("OK")
    return err, err_f


if __name__ == "__main__":
    main()
