"""CKKS at the SEAL bridge's chain: its inputs from the seed, the port's device
entry, the reference.

The cell's traffic names the op in its `env`, HEBENCH_CKKS_OP:

  rotate  `DeviceCkksEvaluator.rotate` of one staged ciphertext: staged
          batch b (pool row b) rotates by rotation_steps[b mod their count],
          a Galois gather and a keyswitch
  matvec  one matrix of `matvec_diagonals` encoded diagonals, staged once by
          `DeviceCkksEvaluator.stage_linear_transform`, whose program (one
          captured CUDA graph) runs on staged ciphertext b

Inputs: a pool of ciphertexts at the configuration's level, (P, 2, L, n)
NTT-domain words uniform below each limb's modulus, and the matrix's
diagonals, (D, L, n) likewise, each standing for an encoded diagonal already
rotated for its giant step; drawn on the device in one call per modulus.
Keys: the Galois keys of a `CkksContext` of the chain, from the seed (the
port's key generation: the check holds the evaluator's arithmetic to the
reference on those keys).  Results stay on the card and the staged inputs as
they were, so each answer is the one-op answer.  There is no API entry.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from hebench.driver import batch_rows
from hebench.reference import ckks as ref_ckks

# the batch size of the cell's traffic, in the environment; read by no code of
# the port (the evaluator takes one ciphertext a call)
BATCH_ENV = "HEBENCH_CKKS_BATCH"
OP_ENV = "HEBENCH_CKKS_OP"
KINDS = ("rotate", "matvec")


def _u64(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy().view(np.uint64)


def kind() -> str:
    k = os.environ.get(OP_ENV, "rotate")
    if k not in KINDS:
        raise ValueError(f"{OP_ENV}={k!r}: one of {', '.join(KINDS)}")
    return k


def steps(cfg: dict, k: str) -> list:
    """The rotation steps the op's keys serve: the cell's steps, or the
    matvec's baby steps 1 .. n1 - 1 and giant steps n1, 2 n1, ..."""
    if k == "rotate":
        return [int(r) for r in cfg["rotation_steps"]]
    D, n1 = int(cfg["matvec_diagonals"]), int(cfg["matvec_n1"])
    return list(range(1, min(n1, D))) + list(range(n1, D, n1))


class Workload:
    def __init__(self, cfg: dict, pool: int, seed: int, device):
        self.kind = kind()
        # a port without the entry the op runs cannot run the cell: fail first
        from hexl_fpga_tpu_torch.integrations.ckks import DeviceCkksEvaluator

        if self.kind == "matvec" and not hasattr(DeviceCkksEvaluator,
                                                 "stage_linear_transform"):
            raise RuntimeError("the port has no encoded-diagonal linear transform "
                               "(DeviceCkksEvaluator.stage_linear_transform)")
        from hexl_fpga_tpu_torch.integrations.ckks import CkksContext

        self.cfg, self.pool = cfg, pool
        self.n, self.moduli = cfg["n"], [int(q) for q in cfg["moduli"]]
        self.level = int(cfg["level"])
        self.L = L = self.level + 1
        n = self.n
        gen = torch.Generator(device=device).manual_seed(seed)
        c = torch.empty((pool, 2, L, n), dtype=torch.int64, device=device)
        D = int(cfg["matvec_diagonals"]) if self.kind == "matvec" else 0
        planes = torch.empty((D, L, n), dtype=torch.int64, device=device)
        for i, q in enumerate(self.moduli[:L]):
            c[:, :, i] = torch.randint(0, q, (pool, 2, n), generator=gen, device=device)
            planes[:, i] = torch.randint(0, q, (D, n), generator=gen, device=device)
        self.c, self.planes = _u64(c), _u64(planes)
        self.scale = 2.0 ** int(cfg["scale_bits"])
        self.ctx = CkksContext(n, self.moduli, self.scale, seed=seed)
        self.steps = steps(cfg, self.kind)
        self.keys = {r: self.ctx.galois_keys(r) for r in self.steps}

    def step(self, row: int) -> int:
        """A rotate row's step."""
        return self.steps[row % len(self.steps)]

    # -- the API entry -----------------------------------------------------

    def api(self, *_):
        raise NotImplementedError(
            "the HEXL-FPGA API has no CKKS evaluator: this op has the device entry only")

    set_worksize = restore = call = completed = result = release = api

    def after(self, rows, once: np.ndarray, uses) -> np.ndarray:
        """An op writes its result whole: every answer is the one-op answer."""
        return once

    # -- the device entry --------------------------------------------------

    def device(self, batch: int, batches: int, device):
        from hexl_fpga_tpu_torch.integrations.ckks import (
            Ciphertext, DeviceCkksEvaluator)

        if batch != 1:
            raise ValueError(f"batch {batch}: the evaluator takes one ciphertext a call")
        self.ev = DeviceCkksEvaluator(self.ctx, device)
        self.staged = []
        for b in range(batches):
            rows = batch_rows(b, batch, self.pool)
            ct = Ciphertext(self.c[rows[0]], self.level, self.scale)
            self.staged.append((self.ev.stage(ct), rows))
        if self.kind == "matvec":
            lt = self.ev.stage_linear_transform(
                dict(enumerate(self.planes)), self.level,
                int(self.cfg["matvec_n1"]), encoded=True)
            self.program = lt.program(self.staged[0][0].data)

    def dispatch(self, b: int) -> torch.Tensor:
        h, rows = self.staged[b]
        if self.kind == "matvec":
            return self.program(h.data)
        return self.ev.rotate(h, self.step(rows[0])).data

    def device_rows(self, b: int) -> list:
        return self.staged[b][1]

    def device_result(self, out: torch.Tensor):
        """One op's result (the staged inputs stay as they were)."""
        return _u64(out).reshape(1, -1), 1

    def release_device(self) -> None:
        self.ev = self.staged = self.program = None

    # -- the plain reference -----------------------------------------------

    def reference(self, mode: str, device):
        """rows -> the (len(rows), 2*L*n) u64 results of those pool rows."""
        n, K = self.n, len(self.moduli)
        keys = {ref_ckks.galois_element(n, r): torch.from_numpy(
                    np.stack(self.keys[r]).view(np.int64)).view(-1, 2, K, n)
                for r in self.steps}
        ref = ref_ckks.Ckks(n, self.moduli, self.L, keys, mode, device)
        planes = torch.from_numpy(self.planes.view(np.int64)).to(device)
        n1 = int(self.cfg.get("matvec_n1", 1))

        def run(rows):
            out = []
            for r in rows:
                c = torch.from_numpy(self.c[r].view(np.int64)).to(device)[None]
                if self.kind == "matvec":
                    got = ref.matvec(c, planes, n1)
                else:
                    got = ref.rotate(c, ref_ckks.galois_element(n, self.step(r)))
                out.append(_u64(got).reshape(-1))
            return np.stack(out)

        return run
