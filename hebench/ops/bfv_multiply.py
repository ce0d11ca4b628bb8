"""BFV multiply (BEHZ): its inputs from the seed, the port's device entry,
the reference.

Inputs: a pool of distinct ciphertext pairs, (P, 2, k, n) words each side,
NTT-domain and uniform below each limb's modulus, drawn on the device in one
call per modulus.  Device entry: `DeviceBfvEvaluator.multiply` on batches
staged once in set-up, over a BfvContext of the configuration's chain; its
results stay on the card, and the staged inputs stay as they were, so each
answer is the one-op answer.  There is no API entry: the HEXL-FPGA API has no
BFV multiply.
"""

from __future__ import annotations

import numpy as np
import torch

from hebench.driver import batch_rows
from hebench.reference import behz as ref_behz

# the batch size of the cell's traffic, in the environment; read by no code of
# the port (the device entry takes its batches whole)
BATCH_ENV = "HEBENCH_BFV_MULTIPLY_BATCH"


def _u64(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy().view(np.uint64)


class Workload:
    def __init__(self, cfg: dict, pool: int, seed: int, device):
        # a port without the device evaluator cannot run the cell: fail first
        from hexl_fpga_tpu_torch.integrations import DeviceBfvEvaluator  # noqa: F401

        if int(cfg["m_tilde"]) != ref_behz.M_TILDE:
            raise ValueError(f"m_tilde {cfg['m_tilde']}: the reference takes 2^32")
        self.cfg, self.seed = cfg, seed
        self.n, self.t = cfg["n"], cfg["t"]
        self.moduli = [int(q) for q in cfg["moduli"]]
        self.k = k = len(self.moduli)
        gen = torch.Generator(device=device).manual_seed(seed)
        c = torch.empty((pool, 2, 2, k, self.n), dtype=torch.int64, device=device)
        for i, q in enumerate(self.moduli):
            c[:, :, :, i] = torch.randint(0, q, (pool, 2, 2, self.n), generator=gen,
                                          device=device)
        c = _u64(c)
        self.c1, self.c2 = c[:, 0], c[:, 1]
        self.pool = pool

    # -- the API entry -----------------------------------------------------

    def api(self, *_):
        raise NotImplementedError(
            "the HEXL-FPGA API has no BFV multiply: this op has the device entry only")

    set_worksize = restore = call = completed = result = release = api

    def after(self, rows, once: np.ndarray, uses) -> np.ndarray:
        """A multiply writes its result whole: every answer is the one-op
        answer."""
        return once

    # -- the device entry --------------------------------------------------

    def device(self, batch: int, batches: int, device):
        from hexl_fpga_tpu_torch.integrations import DeviceBfvEvaluator
        from hexl_fpga_tpu_torch.integrations.bfv import BfvContext

        cfg = self.cfg
        ctx = BfvContext(self.n, self.moduli + [int(cfg["special_modulus"])], self.t,
                         seed=self.seed)
        tool = ctx._behz(self.k)
        bsk = tool.Bsk
        if bsk != [int(m) for m in cfg["bsk_moduli"]] or tool.m_tilde != ref_behz.M_TILDE:
            raise ValueError(f"the port's Bsk {bsk} is not the configuration's "
                             f"{cfg['bsk_moduli']}")
        self.ev = DeviceBfvEvaluator(ctx, device)
        self.staged = []
        for b in range(batches):
            rows = batch_rows(b, batch, self.pool)
            self.staged.append((self.ev.stage(self.c1[rows]),
                                self.ev.stage(self.c2[rows]), rows))

    def dispatch(self, b: int) -> torch.Tensor:
        c1, c2, _ = self.staged[b]
        return self.ev.multiply(c1, c2)

    def device_rows(self, b: int) -> list:
        return self.staged[b][2]

    def device_result(self, out: torch.Tensor):
        """A batch's results (one op each: the staged inputs stay as they
        were)."""
        return _u64(out).reshape(out.shape[0], -1), 1

    def release_device(self) -> None:
        self.ev = self.staged = None

    # -- the plain reference -----------------------------------------------

    def reference(self, mode: str, device):
        """rows -> the (len(rows), 3*k*n) u64 results of those pool rows."""
        mul = ref_behz.BehzMultiply(self.n, self.moduli, self.cfg["bsk_moduli"],
                                    self.t, mode, device)

        def run(rows):
            c1, c2 = (torch.from_numpy(x[rows].view(np.int64)).to(device)
                      for x in (self.c1, self.c2))
            return _u64(mul(c1, c2)).reshape(len(rows), -1)

        return run
