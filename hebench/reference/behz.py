"""The BFV ciphertext multiply, plain: the full-RNS tensor product of Bajard,
Eynard, Hasan and Zucca ("A Full RNS Variant of FV like Somewhat Homomorphic
Encryption Schemes", SAC 2016) with the conventions of SEAL 4.0's
`Evaluator::bfv_multiply` and `RNSTool`.

One level: ciphertext moduli q_0 .. q_{k-1} (Q their product), the auxiliary
base B = b_0 .. b_{k-1} and m_sk (Bsk = B and m_sk, taken as given), m~ = 2^32
and the plaintext modulus t.  Two ciphertexts of NTT limbs (c1, c2), each two
polynomials under every q_i:

  x_i    = INTT_{q_i}(c_i)                          the four polynomials
  u_i    = [x_i m~ qhat_i^-1]_{q_i}                 qhat_i = Q / q_i
  y_m    = sum_i u_i (qhat_i mod m)    mod m        m in Bsk, and m~
  r      = [-y_m~ Q^-1]_{m~}, centred: r - m~ where r >= m~/2    (SmMRq)
  z_m    = (y_m + Q r) m~^-1           mod m        m in Bsk
  d      = (a0 b0, a0 b1 + a1 b0, a1 b1)            mod each of q and Bsk:
           a, b the input limbs under q and NTT_m(z_m) under Bsk
  e      = INTT of each component under q and Bsk
  f_m    = sum_i [e_i t qhat_i^-1]_{q_i} (qhat_i mod m)   mod m, m in Bsk
  g_m    = (e_m t - f_m) Q^-1          mod m        (the fast floor)
  v_j    = [g_j bhat_j^-1]_{b_j}                    bhat_j = B / b_j
  s_p    = sum_j v_j (bhat_j mod p)    mod p        p in q, and m_sk
  alpha  = [(s_msk - g_msk) B^-1]_{m_sk}, centred: negative above m_sk / 2
  h_i    = s_i - alpha B               mod q_i      (Shenoy-Kumaresan)
  out    = NTT_{q_i}(h_i)

Every value is canonical after every step, so the result is one function of
the inputs whatever lazy forms a program keeps.  Transforms are `ntt.py`'s,
at the least primitive 2n-th root of each modulus; modular products are
`arith.py`'s (`mode` "exact", or "float64" for the control).  The m~
arithmetic is on the low 32 bits of int64 words, whose wrapping products
agree with those of u32 there.
"""

from __future__ import annotations

import math

import torch

from . import ntt, primes
from .arith import M32, prep_ints

M_TILDE = 1 << 32


class BehzMultiply:
    """One level's constants on one device."""

    def __init__(self, n, q_moduli, bsk_moduli, t, mode="exact", device="cpu"):
        self.n, self.t = n, int(t)
        self.q = [int(v) for v in q_moduli]
        bsk = [int(v) for v in bsk_moduli]
        k = self.k = len(self.q)
        if len(bsk) != k + 1:
            raise ValueError(f"{len(bsk)} Bsk moduli for {k} q moduli: want {k + 1}")
        self.bsk, self.b, self.m_sk = bsk, bsk[:k], bsk[k]
        self.tabs = {m: ntt.Tables(n, m, primes.minimal_root(n, m), mode, device)
                     for m in self.q + bsk}
        self.mod = {m: tab.mod for m, tab in self.tabs.items()}
        c = lambda v, m: prep_ints([v], m, mode, device)
        Q, B, t = math.prod(self.q), math.prod(self.b), self.t
        qhat = [Q // qi for qi in self.q]
        qhat_inv = [pow(h % qi, -1, qi) for h, qi in zip(qhat, self.q)]
        bhat = [B // bj for bj in self.b]
        bhat_inv = [pow(h % bj, -1, bj) for h, bj in zip(bhat, self.b)]
        # the extension q -> Bsk, and SmMRq
        self.ext_u = [c(M_TILDE * hi, qi) for hi, qi in zip(qhat_inv, self.q)]
        self.qhat_to = {m: [c(h, m) for h in qhat] for m in bsk}
        self.qhat_mt = [h % M_TILDE for h in qhat]
        self.neg_inv_q_mt = -pow(Q, -1, M_TILDE) % M_TILDE
        self.q_mod = {m: c(Q, m) for m in bsk}
        self.inv_mt = {m: c(pow(M_TILDE, -1, m), m) for m in bsk}
        # the fast floor
        self.floor_u = [c(t * hi, qi) for hi, qi in zip(qhat_inv, self.q)]
        self.t_mod = {m: c(t, m) for m in bsk}
        self.inv_q = {m: c(pow(Q, -1, m), m) for m in bsk}
        # Shenoy-Kumaresan
        self.sk_v = [c(hi, bj) for hi, bj in zip(bhat_inv, self.b)]
        self.bhat_to = {p: [c(h, p) for h in bhat] for p in self.q + [self.m_sk]}
        self.inv_b_msk = c(pow(B, -1, self.m_sk), self.m_sk)
        self.b_mod = {qi: c(B, qi) for qi in self.q}

    def _conv(self, u, consts, m):
        """sum_i u_i * consts[i] mod m, for canonical u_i under other moduli."""
        mod = self.mod[m]
        acc = None
        for ui, ci in zip(u, consts):
            term = mod.mul_prepped(mod.reduce(ui), ci)
            acc = term if acc is None else mod.add(acc, term)
        return acc

    def _extend(self, x):
        """k canonical coefficient tensors under q -> k + 1 under Bsk."""
        u = [self.mod[qi].mul_prepped(xi, ci)
             for xi, ci, qi in zip(x, self.ext_u, self.q)]
        y_mt = torch.zeros_like(u[0])
        for ui, hi in zip(u, self.qhat_mt):
            y_mt = (y_mt + (ui & M32) * hi) & M32
        r = (y_mt * self.neg_inv_q_mt) & M32
        neg = r >= M_TILDE // 2
        r_mag = torch.where(neg, M_TILDE - r, r)  # at most 2^31, below every m
        out = []
        for m in self.bsk:
            mod = self.mod[m]
            y = self._conv(u, self.qhat_to[m], m)
            qr = mod.mul_prepped(r_mag, self.q_mod[m])
            z = torch.where(neg, mod.sub(y, qr), mod.add(y, qr))
            out.append(mod.mul_prepped(z, self.inv_mt[m]))
        return out

    def _floor(self, e_q, e_bsk):
        """The t-scaled fast floor: k components under q and k + 1 under Bsk
        -> floor(t e / Q) - alpha under Bsk."""
        u = [self.mod[qi].mul_prepped(ei, ci)
             for ei, ci, qi in zip(e_q, self.floor_u, self.q)]
        out = []
        for m, em in zip(self.bsk, e_bsk):
            mod = self.mod[m]
            te = mod.mul_prepped(em, self.t_mod[m])
            diff = mod.sub(te, self._conv(u, self.qhat_to[m], m))
            out.append(mod.mul_prepped(diff, self.inv_q[m]))
        return out

    def _shenoy_kumaresan(self, g):
        """k + 1 values under Bsk -> the same integers under q, exactly."""
        k, msk = self.k, self.m_sk
        v = [self.mod[bj].mul_prepped(gj, cj)
             for gj, cj, bj in zip(g[:k], self.sk_v, self.b)]
        mod_sk = self.mod[msk]
        s_sk = self._conv(v, self.bhat_to[msk], msk)
        alpha = mod_sk.mul_prepped(mod_sk.sub(s_sk, g[k]), self.inv_b_msk)
        neg = alpha > msk // 2
        a_mag = torch.where(neg, msk - alpha, alpha)
        out = []
        for qi in self.q:
            mod = self.mod[qi]
            s = self._conv(v, self.bhat_to[qi], qi)
            corr = mod.mul_prepped(mod.reduce(a_mag), self.b_mod[qi])
            out.append(torch.where(neg, mod.add(s, corr), mod.sub(s, corr)))
        return out

    def __call__(self, c1: torch.Tensor, c2: torch.Tensor) -> torch.Tensor:
        """(R, 2, k, n) canonical NTT limbs each -> (R, 3, k, n)."""
        k, tabs = self.k, self.tabs
        pair = torch.stack([c1, c2], 1)  # (R, 2 ciphertexts, 2 polys, k, n)
        x = [ntt.inverse(pair[:, :, :, i], tabs[qi]) for i, qi in enumerate(self.q)]
        ext = [ntt.forward(z, tabs[m]) for z, m in zip(self._extend(x), self.bsk)]
        limbs = [pair[:, :, :, i] for i in range(k)] + ext
        e = []
        for m, a in zip(self.q + self.bsk, limbs):
            mod = self.mod[m]
            a0, a1, b0, b1 = a[:, 0, 0], a[:, 0, 1], a[:, 1, 0], a[:, 1, 1]
            d = torch.stack([mod.mul(a0, b0),
                             mod.add(mod.mul(a0, b1), mod.mul(a1, b0)),
                             mod.mul(a1, b1)], 1)  # (R, 3, n)
            e.append(ntt.inverse(d, tabs[m]))
        h = self._shenoy_kumaresan(self._floor(e[:k], e[k:]))
        return torch.stack([ntt.forward(hi, tabs[qi]) for hi, qi in zip(h, self.q)], 2)
