"""KeySwitch, plain: what the HEXL-FPGA API's `KeySwitch` returns.

For one op at (n, L decomp moduli, K key moduli, 2 key components), with
q_0 .. q_{L-1} the decomp moduli and q_k = q_{K-1} the special one:

  c_i     = INTT_{q_i}(t_i)                                  i < L
  a_j[c]  = sum_i NTT_{q_j}(c_i mod q_j) * key_i[c][j]       j < L and j = K-1
  e[c]    = INTT_{q_k}(a_{K-1}[c]) + floor(q_k / 2)         mod q_k
  g_i[c]  = NTT_{q_i}(e[c] - floor(q_k / 2))                 mod q_i
  out     = result + (a_i[c] - g_i[c]) * msf_i               mod q_i

every operation on canonical residues (the dataflow of the reference
device's intt1, dyadmult, intt2 and ms stages, and the host's accumulate
into `result`).  The twiddles and the factors are worked out here from the
moduli and the roots; nothing is taken from the program under test.
"""

from __future__ import annotations

import torch

from . import ntt
from .arith import prep_ints


class KeySwitch:
    """One configuration's constants on one device."""

    def __init__(self, n, L, K, moduli, psis, msf, keys, mode="exact",
                 device="cpu"):
        """moduli, psis, msf: K Python ints; keys: (L, 2, K, n) int64
        tensor of the switching keys (u64 words below each modulus)."""
        self.n, self.L, self.K = n, L, K
        self.moduli = [int(q) for q in moduli]
        engines = [*range(L), K - 1]
        self.tabs = {j: ntt.Tables(n, self.moduli[j], int(psis[j]), mode, device)
                     for j in engines}
        keys = keys.to(device)
        self.keys = {j: self.tabs[j].mod.prep(keys[:, :, j, :]) for j in engines}
        self.msf = {i: prep_ints([int(msf[i]) % self.moduli[i]], self.moduli[i],
                                 mode, device) for i in range(L)}

    def __call__(self, t: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
        """t (B, L, n) targets, r (B, 2, L, n) accumulators, canonical ->
        (B, 2, L, n), the results the API leaves in `result`."""
        L, K = self.L, self.K
        coeff = torch.stack([ntt.inverse(t[:, i], self.tabs[i])
                             for i in range(L)], 1)  # (B, L, n)
        acc = {}
        for j in (*range(L), K - 1):
            tab = self.tabs[j]
            val = ntt.forward(tab.mod.reduce(coeff), tab)  # (B, L, n)
            s = 0
            for i in range(L):
                # (B, 1, n) x (2, n): below L * q_j < 2^55
                s = s + tab.mod.mul_prepped(val[:, i, None], self.keys[j][i])
            acc[j] = tab.mod.reduce(s)  # (B, 2, n)
        qk = self.moduli[K - 1]
        half = qk // 2
        e = self.tabs[K - 1].mod.add(ntt.inverse(acc[K - 1], self.tabs[K - 1]),
                                     half % qk)
        out = torch.empty_like(r)
        for i in range(L):
            tab = self.tabs[i]
            q = self.moduli[i]
            g = ntt.forward(tab.mod.sub(tab.mod.reduce(e), half % q), tab)
            delta = tab.mod.mul_prepped(tab.mod.sub(acc[i], g), self.msf[i])
            s = r[:, :, i] + delta  # the host's accumulate
            out[:, :, i] = torch.where(s >= q, s - q, s)
        return out
