"""DyadicMultiply, plain: the ciphertext product of the HEXL-FPGA API.

For operands x, y laid out [2][M][n] (two polynomials over M moduli):
out[0] = x0 y0, out[1] = x0 y1 + x1 y0, out[2] = x1 y1, each modulo its
row's modulus, laid out [3][M][n].
"""

from __future__ import annotations

import torch

from .arith import Modulus


class Dyadic:
    def __init__(self, moduli, mode="exact", device="cpu"):
        self.mod = Modulus([int(q) for q in moduli], mode, device)

    def __call__(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """(B, 2, M, n) canonical operands -> (B, 3, M, n)."""
        m = self.mod
        mid = m.add(m.mul(x[:, 0], y[:, 1]), m.mul(x[:, 1], y[:, 0]))
        return torch.stack([m.mul(x[:, 0], y[:, 0]), mid,
                            m.mul(x[:, 1], y[:, 1])], 1)
