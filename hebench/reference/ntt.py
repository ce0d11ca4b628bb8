"""The negacyclic NTT of the HEXL convention, plain and exact.

Forward: natural order in, bit-reversed order out, the table holding
psi^i at position bitrev(i), stage m (m = 1, 2, ..., n/2) combining
(X, Y) -> (X + W Y, X - W Y) with W = table[m + group].  Inverse: each
stage undone in the opposite order, then a multiply by n^-1.  Every value
is canonical (in [0, q)) after every stage, so the result is the unique
transform whatever lazy representatives a program keeps.
"""

from __future__ import annotations

import torch

from .arith import Modulus, prep_ints


def _bitrev(i: int, bits: int) -> int:
    return int(f"{i:0{bits}b}"[::-1], 2) if bits else 0


class Tables:
    """One (n, q, psi)'s twiddles in the form `Modulus.mul_prepped` takes."""

    def __init__(self, n: int, q: int, psi: int, mode: str = "exact",
                 device="cpu"):
        if pow(psi, n, q) != q - 1:
            raise ValueError(f"{psi} is not a primitive {2 * n}-th root mod {q}")
        bits = n.bit_length() - 1
        fwd, inv = [0] * n, [0] * n
        psi_inv = pow(psi, -1, q)
        p, pi = 1, 1
        for i in range(n):
            r = _bitrev(i, bits)
            fwd[r], inv[r] = p, pi
            p, pi = p * psi % q, pi * psi_inv % q
        self.n, self.q = n, q
        self.mod = Modulus(q, mode, device)
        self.fwd = prep_ints(fwd, q, mode, device)
        self.inv = prep_ints(inv, q, mode, device)
        self.inv_n = prep_ints([pow(n, -1, q)], q, mode, device)


def forward(x: torch.Tensor, t: Tables) -> torch.Tensor:
    """(..., n) canonical residues -> their transforms, bit-reversed."""
    n, mod = t.n, t.mod
    shape = x.shape
    x = x.reshape(-1, n)
    m = 1
    while m < n:
        v = x.view(-1, m, 2, n // (2 * m))
        w = mod.mul_prepped(v[:, :, 1], t.fwd[m:2 * m].view(1, m, 1))
        x = torch.stack([mod.add(v[:, :, 0], w), mod.sub(v[:, :, 0], w)], 2)
        x = x.view(-1, n)
        m *= 2
    return x.view(shape)


def inverse(x: torch.Tensor, t: Tables) -> torch.Tensor:
    """The inverse of `forward`: bit-reversed transforms -> residues."""
    n, mod = t.n, t.mod
    shape = x.shape
    x = x.reshape(-1, n)
    m = n // 2
    while m >= 1:
        v = x.view(-1, m, 2, n // (2 * m))
        a, b = v[:, :, 0], v[:, :, 1]
        d = mod.mul_prepped(mod.sub(a, b), t.inv[m:2 * m].view(1, m, 1))
        x = torch.stack([mod.add(a, b), d], 2).view(-1, n)
        m //= 2
    return mod.mul_prepped(x, t.inv_n).view(shape)
