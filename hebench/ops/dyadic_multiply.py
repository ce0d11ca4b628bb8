"""DyadicMultiply: its inputs from the seed, the port's API entry, the
reference.

Inputs: a pool of distinct operand pairs (P, 2, M, n), each limb below its
modulus, drawn on the device in one call per modulus.  `DyadicMultiply`
writes its result buffer whole, so the client need not restore it; it
poisons the buffer of each op whose answer is kept for the check, so an op
that writes nothing cannot pass on an earlier round's answer.
"""

from __future__ import annotations

import numpy as np
import torch

from hebench.reference import dyadic as ref_dyadic

BATCH_ENV = "BATCH_SIZE_DYADIC_MULTIPLY"
POISON = np.uint64((1 << 64) - 1)


def _u64(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy().view(np.uint64)


class Workload:
    def __init__(self, cfg: dict, pool: int, seed: int, device):
        self.cfg = cfg
        self.n, self.M = cfg["n"], cfg["n_moduli"]
        self.moduli = [int(q) for q in cfg["moduli"]][:self.M]
        gen = torch.Generator(device=device).manual_seed(seed)
        ops = torch.empty((2, pool, 2, self.M, self.n), dtype=torch.int64,
                          device=device)
        for m, q in enumerate(self.moduli):
            ops[:, :, :, m] = torch.randint(0, q, (2, pool, 2, self.n),
                                            generator=gen, device=device)
        ops = _u64(ops)
        self.x = ops[0].reshape(pool, -1)
        self.y = ops[1].reshape(pool, -1)
        self.results = np.zeros((pool, 3 * self.M * self.n), dtype=np.uint64)
        self.pool = pool

    def api(self):
        import hexl_fpga_tpu_torch as hexl

        self.hexl = hexl
        hexl.acquire_FPGA_resources()

    def set_worksize(self, ws: int) -> None:
        self.hexl.set_worksize_DyadicMultiply(ws)

    def restore(self, slot: int, sampled: bool) -> None:
        if sampled:
            self.results[slot].fill(POISON)

    def call(self, slot: int) -> None:
        self.hexl.DyadicMultiply(self.results[slot], self.x[slot], self.y[slot],
                                 self.n, self.moduli, self.M)

    def completed(self) -> None:
        self.hexl.DyadicMultiplyCompleted()

    def result(self, slot: int):
        return self.results[slot].copy(), 1

    def after(self, rows, once: np.ndarray, uses) -> np.ndarray:
        """The result buffer is written whole: every op's answer is the
        one-op answer."""
        return once

    def release(self) -> None:
        self.hexl.release_FPGA_resources()

    def reference(self, mode: str, device):
        dy = ref_dyadic.Dyadic(self.moduli, mode, device)
        shape = (-1, 2, self.M, self.n)

        def run(rows):
            x = torch.from_numpy(self.x[rows].view(np.int64)).to(device)
            y = torch.from_numpy(self.y[rows].view(np.int64)).to(device)
            return _u64(dy(x.view(shape), y.view(shape))).reshape(len(rows), -1)

        return run
