"""Exact modular arithmetic on u64 words held in torch.int64 tensors.

Plain PyTorch, any device.  Every value handled here is below 2^63, so the
signed compares of int64 are the unsigned ones; products wrap modulo 2^64,
which is exactly the low half of the 128-bit product.  The high half is put
together from four 32 x 32-bit limb products.  A modular product is a
Montgomery product (R = 2^64): exact for any odd modulus q < 2^62.

`Modulus(q, mode="float64")` is the benchmark's control: the same calls,
with every modular product computed in float64 (53 bits of mantissa) in
place of u64 words, the step below the configuration's exact u64 words.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
R_BITS = 64


def _i64(v: int) -> int:
    """A u64 value as the int64 of the same bit pattern."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >= 1 << 63 else v


def hi32(x):
    """The high 32 bits of each u64 word (a logical shift)."""
    return (x >> 32) & M32


def mulhi(a, b):
    """The high 64 bits of the 128-bit product of two u64 words."""
    a0, a1 = a & M32, hi32(a)
    b0, b1 = b & M32, hi32(b)
    p00, p01, p10, p11 = a0 * b0, a0 * b1, a1 * b0, a1 * b1
    mid = hi32(p00) + (p01 & M32) + (p10 & M32)
    return p11 + hi32(p01) + hi32(p10) + hi32(mid)


class Modulus:
    """Arithmetic modulo one odd q < 2^62 (or a tensor of them that
    broadcasts against the operands)."""

    def __init__(self, q, mode: str = "exact", device="cpu"):
        if mode not in ("exact", "float64"):
            raise ValueError(f"mode {mode!r}: 'exact' or 'float64'")
        self.mode = mode
        qs = [int(v) for v in (q if isinstance(q, (list, tuple)) else [q])]
        for v in qs:
            if v % 2 == 0 or not 2 < v < 1 << 62:
                raise ValueError(f"modulus {v}: odd and below 2^62")
        self.ints = qs
        # -q^-1 mod 2^64 and R^2 mod q, per modulus
        qinv = [_i64(-pow(v, -1, 1 << 64)) for v in qs]
        r2 = [pow(2, 2 * R_BITS, v) for v in qs]
        if isinstance(q, (list, tuple)):
            shape = (-1, 1)  # one modulus per row of the last two dims
            t = lambda xs: torch.tensor(xs, dtype=torch.int64, device=device).view(shape)
            self.q, self.qinv, self.r2 = t(qs), t(qinv), t(r2)
            self.qf = torch.tensor(qs, dtype=torch.float64, device=device).view(shape)
        else:
            self.q, self.qinv, self.r2 = qs[0], qinv[0], r2[0]
            self.qf = float(qs[0])

    # -- canonical residues in [0, q) --------------------------------------

    def add(self, a, b):
        s = a + b
        return torch.where(s >= self.q, s - self.q, s)

    def sub(self, a, b):
        d = a - b
        return torch.where(d < 0, d + self.q, d)

    def reduce(self, a):
        """Any non-negative int64 -> [0, q)."""
        return torch.remainder(a, self.q)

    def _mont(self, a, b):
        """a * b * 2^-64 mod q for a, b in [0, q)."""
        lo = a * b
        m = lo * self.qinv
        u = mulhi(a, b) + mulhi(m, self.q) + (lo != 0).to(torch.int64)
        return torch.where(u >= self.q, u - self.q, u)

    def _f64(self, a, b):
        """The control: the product and its remainder in float64."""
        p = torch.fmod(a.to(torch.float64) * b.to(torch.float64), self.qf)
        return self.reduce(p.round().to(torch.int64))

    def prep(self, b):
        """A constant operand in the form `mul_prepped` takes: b * 2^64 mod q
        (Montgomery form), or b itself for the control."""
        if self.mode == "float64":
            return b
        return self._mont(b, self.r2)

    def mul_prepped(self, a, bp):
        """a * b mod q, with bp = prep(b)."""
        if self.mode == "float64":
            return self._f64(a, bp)
        return self._mont(a, bp)

    def mul(self, a, b):
        """a * b mod q for a, b in [0, q)."""
        if self.mode == "float64":
            return self._f64(a, b)
        return self._mont(self._mont(a, b), self.r2)


def prep_ints(values, q: int, mode: str, device="cpu") -> torch.Tensor:
    """Python-int constants below q as a tensor in `Modulus.prep` form,
    worked out with Python integers."""
    if mode == "float64":
        return torch.tensor([int(v) % q for v in values], dtype=torch.int64,
                            device=device)
    return torch.tensor([(int(v) << R_BITS) % q for v in values],
                        dtype=torch.int64, device=device)
