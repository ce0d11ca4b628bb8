"""CKKS rotations and the BSGS matrix-vector product, plain: what a
device-resident CKKS evaluator computes on NTT-domain ciphertexts.

A ciphertext is (2, L, n): c0 and c1 under the L active moduli, each row in
the NTT domain of `ntt.py` (bit-reversed order).  The Galois element g
(5^r mod 2n rotates the slots left by r) acts as:

  sigma_g   the NTT-domain automorphism c(X) -> c(X^g), a permutation:
            position k holds the evaluation at psi^e(k), e(k) = 2 bitrev(k)
            + 1, and c(X^g) there is c's evaluation at psi^(g e(k) mod 2n)
  rotate    c' = sigma_g c, then KeySwitch(c'_1, [c'_0, 0]) under g's keys
  hoisted   sigma_g( KeySwitch(c_1, [c_0, 0]) under sigma_g^-1 of g's keys ):
            a hoisted rotation, whose decomposition of c_1 is shared between
            steps, permutes the keys in place of the target and the output
            once; not the bits of `rotate`
  matvec    M z = sum_j rot_{j n1}( sum_i p_{j n1 + i} * rot_i(z) ): the baby
            rotations i = 1 .. n1 - 1 hoisted, the giant ones (j > 0) full
            rotations, p_d the encoded diagonal d (already rotated for its
            giant step), products and sums limbwise mod q

KeySwitch is `keyswitch.py`'s, with the API's layout of the keys (L, 2, K, n)
and the modswitch factors q_k^-1 mod q_i worked out here.  Each KeySwitch
rounds, so the grouping of the product decides its bits; the grouping above
is the evaluator's.
"""

from __future__ import annotations

import copy

import torch

from . import keyswitch, ntt, primes
from .arith import Modulus


def galois_element(n: int, step: int) -> int:
    """The Galois element of a left rotation of the n/2 slots by `step`."""
    return pow(5, step % (n // 2), 2 * n)


def galois_index(n: int, g: int, device="cpu") -> torch.Tensor:
    """index with sigma_g(x) = x[..., index], in `ntt.py`'s output order."""
    bits = n.bit_length() - 1
    pos = {2 * ntt._bitrev(k, bits) + 1: k for k in range(n)}  # exponent -> position
    index = [pos[g * (2 * ntt._bitrev(k, bits) + 1) % (2 * n)] for k in range(n)]
    return torch.tensor(index, dtype=torch.int64, device=device)


class Ckks:
    """One chain's rotations and products on one device.

    moduli: the K key moduli, the special one last; the ciphertexts carry
    the first L.  keys: {g: (L', 2, K, n) int64 tensor} with L' >= L, the
    Galois keys of every element used (u64 words below each modulus)."""

    def __init__(self, n: int, moduli, L: int, keys: dict, mode: str = "exact",
                 device="cpu"):
        self.n, self.L, self.device = n, L, device
        self.moduli = [int(q) for q in moduli]
        K = len(self.moduli)
        qk = self.moduli[-1]
        psis = [primes.minimal_root(n, q) for q in self.moduli]
        msf = [pow(qk, -1, q) for q in self.moduli[:-1]] + [1]
        self.keys = {int(g): k[:L].to(device) for g, k in keys.items()}
        first = next(iter(self.keys.values()))
        # the twiddles and factors once; a key set swaps only the keys
        self._base = keyswitch.KeySwitch(n, L, K, self.moduli, psis, msf, first,
                                         mode, device)
        self._switch, self._index = {}, {}
        self.mod = Modulus(self.moduli[:L], mode, device)

    def index(self, g: int) -> torch.Tensor:
        if g not in self._index:
            self._index[g] = galois_index(self.n, g, self.device)
        return self._index[g]

    def switch(self, g: int, hoisted: bool) -> keyswitch.KeySwitch:
        """KeySwitch under g's keys, or under sigma_g^-1 of them."""
        if (g, hoisted) not in self._switch:
            keys = self.keys[g]
            if hoisted:
                inv = torch.argsort(self.index(g))  # sigma_g^-1 as a gather
                keys = keys.index_select(-1, inv)
            ks = copy.copy(self._base)
            ks.keys = {j: ks.tabs[j].mod.prep(keys[:, :, j, :]) for j in ks.tabs}
            self._switch[g, hoisted] = ks
        return self._switch[g, hoisted]

    @staticmethod
    def _base_of(c0: torch.Tensor) -> torch.Tensor:
        return torch.stack([c0, torch.zeros_like(c0)], 1)

    def rotate(self, c: torch.Tensor, g: int) -> torch.Tensor:
        """c (B, 2, L, n) -> the rotations (B, 2, L, n)."""
        r = c.index_select(-1, self.index(g))
        return self.switch(g, False)(r[:, 1], self._base_of(r[:, 0]))

    def rotate_hoisted(self, c: torch.Tensor, g: int) -> torch.Tensor:
        out = self.switch(g, True)(c[:, 1], self._base_of(c[:, 0]))
        return out.index_select(-1, self.index(g))

    def matvec(self, c: torch.Tensor, planes: torch.Tensor, n1: int) -> torch.Tensor:
        """c (B, 2, L, n), planes (D, L, n): diagonal d = j n1 + i is plane d."""
        D = planes.shape[0]
        babies = {0: c}
        for i in range(1, min(n1, D)):
            babies[i] = self.rotate_hoisted(c, galois_element(self.n, i))
        acc = None
        for j in range(-(-D // n1)):
            inner = None
            for d in range(j * n1, min(D, (j + 1) * n1)):
                term = self.mod.mul(babies[d % n1], planes[d])
                inner = term if inner is None else self.mod.add(inner, term)
            if j:
                inner = self.rotate(inner, galois_element(self.n, j * n1))
            acc = inner if acc is None else self.mod.add(acc, inner)
        return acc
