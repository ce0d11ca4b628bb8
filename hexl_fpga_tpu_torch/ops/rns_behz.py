"""BEHZ full-RNS BFV multiplication on the host (Bajard-Eynard-Hasan-Zucca,
"A Full RNS Variant of FV like Somewhat Homomorphic Encryption Schemes",
SAC 2016): the algorithm SEAL's RNSTool implements on the CPU.

The port's own copy of `hexl_fpga_tpu/ops/rns_behz.py`: the same constants,
the same auxiliary primes, the same `aux_bits` sizing and the same errors,
over the port's `golden`, `nt` and `twiddles`.  It is exact NumPy residue
arithmetic and the oracle of `rns_behz_cuda.BehzCuda`, on the CPU and on the
card.

Pipeline (all residues (len(base), n) uint64, canonical):

  1. extend ciphertexts from base q to Bsk = B u {m_sk} with the m_tilde
     Montgomery correction (`fastbconv_m_tilde` + `sm_mrq`) — removes the
     alpha*q overflow of the fast base conversion up to a +/-(k+1)/2 term
     that joins the noise;
  2. tensor product per modulus of q u Bsk (the q half reuses the
     ciphertexts' existing NTT limbs);
  3. scale by t/q with `fast_floor` (exact division after subtracting the
     fast-converted q-residue; |error| < k joins the noise);
  4. convert back Bsk -> q with the Shenoy-Kumaresan m_sk correction
     (`fastbconv_sk` — exact, no overflow term).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from . import golden, nt, twiddles

_MASK32 = np.uint64(0xFFFFFFFF)


def _prod(xs) -> int:
    p = 1
    for x in xs:
        p *= int(x)
    return p


class BehzTool:
    """Precomputed constants for one (n, q-base, t) BFV level.

    q_moduli: the level's ciphertext primes (NTT-friendly for 2n).
    Auxiliary base B (len(q) primes) + m_sk are drawn NTT-friendly and
    distinct from q; m_tilde = 2^32 (power of two: its modular ops are
    masks, exactly SEAL's choice `seal/util/rns.cpp` RNSTool m_tilde_).

    aux_bits (None = auto) sizes the Bsk primes.  Two hard requirements,
    both verified (ValueError) rather than assumed:
      * every aux modulus > 2^32: the SmMRq magnitude rmag < m_tilde/2 =
        2^31 must satisfy golden.mul_mod's x < q precondition, so aux
        primes start at 33 bits even for small q;
      * the BEHZ range condition prod(B)*m_sk > 2*t*n*(k+2)^2*prod(q):
        the t-scaled tensor-product coefficients (|d| <= n((k+2)q/2)^2
        after the +/-(k+1)/2 extension overflow, so |g| <= tn(k+2)^2 q/4
        + k after fast_floor) must fit the Bsk CRT range or fast_floor /
        Shenoy silently wrap and decryption corrupts with no error (SEAL
        guarantees this by always using max-size Bsk primes).
    Auto mode starts at max(q_bits, 33) and widens up to 62 bits (the
    golden-model modulus ceiling) until the bound holds."""

    AUX_BITS_MAX = 62

    def __init__(self, n: int, q_moduli: Sequence[int], t: int,
                 aux_bits: int | None = None):
        self.n = int(n)
        self.q = [int(m) for m in q_moduli]
        self.t = int(t)
        k = len(self.q)
        self.k = k
        q_prod_early = _prod(self.q)
        behz_rhs = 2 * self.t * self.n * (k + 2) ** 2 * q_prod_early
        if aux_bits is None:
            bits = max(max(int(q).bit_length() for q in self.q), 33)
            while bits < self.AUX_BITS_MAX and (
                # k primes of `bits` bits (each > 2^(bits-1)) + m_sk
                (1 << ((bits - 1) * (k + 1))) <= behz_rhs
            ):
                bits += 1
            aux_bits = bits
        if aux_bits < 33:
            raise ValueError(
                f"aux_bits={aux_bits} < 33: SmMRq needs every Bsk modulus "
                "above m_tilde/2 = 2^31 (see class docstring)"
            )
        self.aux_bits = int(aux_bits)
        # auxiliary primes: skip any that collide with q (or t)
        taken = set(self.q) | {self.t}
        aux: List[int] = []
        seed_n = self.n
        cand = nt.generate_primes(2 * k + 8, aux_bits, seed_n)
        for p in cand:
            if int(p) not in taken:
                aux.append(int(p))
            if len(aux) == k + 1:
                break
        assert len(aux) == k + 1, "not enough auxiliary primes"
        self.b = aux[:k]
        self.m_sk = aux[k]
        self.Bsk = self.b + [self.m_sk]
        if _prod(self.b) * self.m_sk <= behz_rhs:
            raise ValueError(
                "BEHZ range condition violated: prod(B)*m_sk <= "
                f"2*t*n*(k+2)^2*prod(q) at aux_bits={aux_bits} "
                "(fast_floor/Shenoy exactness would silently break; "
                "raise aux_bits or lower t)"
            )
        self.m_tilde = 1 << 32

        q_prod = _prod(self.q)
        B_prod = _prod(self.b)
        self.q_prod = q_prod
        self.B_prod = B_prod
        # base-q CRT scaffolding
        self.q_hat = [q_prod // qi for qi in self.q]
        self.q_hat_inv = [
            nt.inverse_mod(self.q_hat[i] % self.q[i], self.q[i])
            for i in range(k)
        ]
        # q_hat_i mod m for every destination m in Bsk u {m_tilde}
        self.q_hat_mod_Bsk = np.array(
            [[self.q_hat[i] % m for m in self.Bsk] for i in range(k)],
            dtype=np.uint64,
        )
        self.q_hat_mod_mtilde = np.array(
            [self.q_hat[i] % self.m_tilde for i in range(k)], dtype=np.uint64
        )
        self.q_mod_Bsk = np.array([q_prod % m for m in self.Bsk],
                                  dtype=np.uint64)
        # SmMRq constants
        self.neg_inv_q_mod_mtilde = (
            self.m_tilde - nt.inverse_mod(q_prod % self.m_tilde, self.m_tilde)
        ) % self.m_tilde
        self.inv_mtilde_mod_Bsk = [
            nt.inverse_mod(self.m_tilde % m, m) for m in self.Bsk
        ]
        # fast-floor constants
        self.inv_q_mod_Bsk = [
            nt.inverse_mod(q_prod % m, m) for m in self.Bsk
        ]
        # base-B CRT scaffolding (for the Shenoy-Kumaresan back-conversion)
        self.b_hat = [B_prod // bj for bj in self.b]
        self.b_hat_inv = [
            nt.inverse_mod(self.b_hat[j] % self.b[j], self.b[j])
            for j in range(k)
        ]
        self.b_hat_mod_msk = np.array(
            [self.b_hat[j] % self.m_sk for j in range(k)], dtype=np.uint64
        )
        self.b_hat_mod_q = np.array(
            [[self.b_hat[j] % qi for qi in self.q] for j in range(k)],
            dtype=np.uint64,
        )
        self.inv_B_mod_msk = nt.inverse_mod(B_prod % self.m_sk, self.m_sk)
        self.B_mod_q = np.array([B_prod % qi for qi in self.q],
                                dtype=np.uint64)
        self._bsk_tabs = None

    # -- twiddle tables for the auxiliary base --------------------------------

    def bsk_tables(self) -> List[twiddles.NttTables]:
        if self._bsk_tabs is None:
            self._bsk_tabs = [
                twiddles.ntt_tables(self.n, m) for m in self.Bsk
            ]
        return self._bsk_tabs

    # -- primitives (numpy residue arrays, exact) ------------------------------

    def _tilde(self, x_q: np.ndarray) -> np.ndarray:
        """[x_i * q_hat_inv_i]_{q_i} — the shared prologue of every fast
        base conversion out of q ((k, n) -> (k, n))."""
        return np.stack([
            golden.mul_mod(x_q[i], self.q_hat_inv[i], self.q[i])
            for i in range(self.k)
        ])

    def fastbconv_q_to(self, x_q: np.ndarray, dst: Sequence[int],
                       hat_mod_dst: np.ndarray) -> np.ndarray:
        """Fast base conversion (BEHZ eq. FastBConv): y_m = sum_i
        [x_i qhat_inv_i]_{q_i} * (qhat_i mod m) mod m.  Represents
        x + alpha*q with 0 <= alpha < k.  x_q: (k, n); returns
        (len(dst), n)."""
        tilde = self._tilde(x_q)
        out = []
        for d, m in enumerate(dst):
            acc = np.zeros(x_q.shape[1], dtype=np.uint64)
            for i in range(self.k):
                term = golden.mul_mod(tilde[i], int(hat_mod_dst[i, d]), m)
                acc = acc + term  # k terms < m < 2^52: sum < 2^56, exact
            out.append(golden.barrett_reduce64(acc, m))
        return np.stack(out)

    def fastbconv_mtilde(self, x_q: np.ndarray) -> np.ndarray:
        """The m_tilde component of the conversion (mod 2^32: a mask)."""
        tilde = self._tilde(x_q)
        acc = np.zeros(x_q.shape[1], dtype=np.uint64)
        with np.errstate(over="ignore"):
            for i in range(self.k):
                acc += tilde[i] * self.q_hat_mod_mtilde[i]
        return acc & _MASK32

    def extend_to_bsk(self, x_q: np.ndarray) -> np.ndarray:
        """Base extension q -> Bsk with the m_tilde Montgomery correction
        (BEHZ steps FastBConv_mtilde + SmMRq; SEAL RNSTool::fastbconv_m_tilde
        + sm_mrq): returns (k+1, n) residues of y = x + a*q with
        |a| <= (k+1)/2 — y is congruent to x mod q and small enough that
        the correction joins the noise."""
        # scale by m_tilde inside q first
        xm = np.stack([
            golden.mul_mod(x_q[i], self.m_tilde % self.q[i], self.q[i])
            for i in range(self.k)
        ])
        conv = self.fastbconv_q_to(xm, self.Bsk, self.q_hat_mod_Bsk)
        r_mt = self.fastbconv_mtilde(xm)
        # r = [conv_mtilde * (-q)^{-1}]_{m_tilde}, centered
        with np.errstate(over="ignore"):
            r = (r_mt * np.uint64(self.neg_inv_q_mod_mtilde)) & _MASK32
        neg = r >= np.uint64(self.m_tilde // 2)
        rmag = np.where(neg, np.uint64(self.m_tilde) - r, r)
        out = []
        for d, m in enumerate(self.Bsk):
            term = golden.mul_mod(rmag, int(self.q_mod_Bsk[d]), m)
            s = np.where(
                neg,
                golden.barrett_reduce64(conv[d] + np.uint64(m) - term, m),
                golden.barrett_reduce64(conv[d] + term, m),
            )
            out.append(golden.mul_mod(s, self.inv_mtilde_mod_Bsk[d], m))
        return np.stack(out)

    def fast_floor(self, tq_q: np.ndarray, tq_bsk: np.ndarray) -> np.ndarray:
        """floor(t*x / q) - alpha (0 <= alpha < k, the fast-conversion
        overflow of [t*x]_q) in Bsk, from the t-scaled
        residues of x in q (tq_q) and in Bsk (tq_bsk) (BEHZ fast flooring;
        SEAL RNSTool::fast_floor): g_m = (tq_m - FastBConv(tq_q)) * q^{-1}
        mod m."""
        f = self.fastbconv_q_to(tq_q, self.Bsk, self.q_hat_mod_Bsk)
        out = []
        for d, m in enumerate(self.Bsk):
            diff = golden.barrett_reduce64(
                tq_bsk[d] + np.uint64(m) - f[d], m
            )
            out.append(golden.mul_mod(diff, self.inv_q_mod_Bsk[d], m))
        return np.stack(out)

    def fastbconv_sk(self, g_bsk: np.ndarray) -> np.ndarray:
        """Exact conversion Bsk -> q via Shenoy-Kumaresan (BEHZ FastBConvSK;
        SEAL RNSTool::fastbconv_sk): the m_sk residue pins the fast
        conversion's alpha overflow, so the result is exact mod q.
        g_bsk: (k+1, n) -> (k, n)."""
        g_b, g_sk = g_bsk[: self.k], g_bsk[self.k]
        tilde = np.stack([
            golden.mul_mod(g_b[j], self.b_hat_inv[j], self.b[j])
            for j in range(self.k)
        ])
        # alpha_sk = [(FastBConv(g, B -> m_sk) - g_sk) * B^{-1}]_{m_sk},
        # centered (g may represent a centered-negative value)
        acc = np.zeros(g_bsk.shape[1], dtype=np.uint64)
        for j in range(self.k):
            acc = acc + golden.mul_mod(
                tilde[j], int(self.b_hat_mod_msk[j]), self.m_sk
            )
        h = golden.barrett_reduce64(acc, self.m_sk)
        d0 = golden.barrett_reduce64(
            h + np.uint64(self.m_sk) - g_sk, self.m_sk
        )
        alpha = golden.mul_mod(d0, self.inv_B_mod_msk, self.m_sk)
        neg = alpha > np.uint64(self.m_sk // 2)
        amag = np.where(neg, np.uint64(self.m_sk) - alpha, alpha)
        out = []
        for i, qi in enumerate(self.q):
            acc = np.zeros(g_bsk.shape[1], dtype=np.uint64)
            for j in range(self.k):
                acc = acc + golden.mul_mod(
                    tilde[j], int(self.b_hat_mod_q[j, i]), qi
                )
            conv = golden.barrett_reduce64(acc, qi)
            corr = golden.mul_mod(amag, int(self.B_mod_q[i]), qi)
            out.append(
                np.where(
                    neg,
                    golden.barrett_reduce64(conv + corr, qi),
                    golden.barrett_reduce64(conv + np.uint64(qi) - corr, qi),
                )
            )
        return np.stack(out)

    # -- end-to-end multiply ---------------------------------------------------

    def multiply(self, ct1_ntt: np.ndarray, ct2_ntt: np.ndarray,
                 q_tabs: Sequence[twiddles.NttTables]) -> np.ndarray:
        """BEHZ BFV multiply: (2, k, n) NTT-limb ciphertexts (base q) ->
        (3, k, n) NTT-limb tensor output, scaled by t/q with rounding.

        q_tabs: the level's NTT tables (BfvContext.tabs[:k]).  The q-base
        tensor product reuses the input NTT limbs directly; only the Bsk
        extension needs new transforms."""
        k, n = self.k, self.n
        bsk_tabs = self.bsk_tables()
        # coefficient-domain residues of all four polys (for the extension)
        coeff = {}
        for (c, j) in ((0, 0), (0, 1), (1, 0), (1, 1)):
            src = (ct1_ntt, ct2_ntt)[c]
            coeff[(c, j)] = np.stack([
                golden.inv_ntt(src[j][i], self.q[i], q_tabs[i])
                for i in range(k)
            ])
        # extend to Bsk and transform (NTT under each Bsk modulus)
        bsk_ntt = {}
        for key, x_q in coeff.items():
            ext = self.extend_to_bsk(x_q)
            bsk_ntt[key] = np.stack([
                golden.fwd_ntt(ext[d], self.Bsk[d], bsk_tabs[d])
                for d in range(k + 1)
            ])
        # tensor products, elementwise per modulus
        def tensor(a0, a1, b0, b1, moduli):
            d0 = np.stack([
                golden.mul_mod(a0[m], b0[m], moduli[m])
                for m in range(len(moduli))
            ])
            cross1 = np.stack([
                golden.mul_mod(a0[m], b1[m], moduli[m])
                for m in range(len(moduli))
            ])
            cross2 = np.stack([
                golden.mul_mod(a1[m], b0[m], moduli[m])
                for m in range(len(moduli))
            ])
            d1 = np.stack([
                golden.barrett_reduce64(cross1[m] + cross2[m], moduli[m])
                for m in range(len(moduli))
            ])
            d2 = np.stack([
                golden.mul_mod(a1[m], b1[m], moduli[m])
                for m in range(len(moduli))
            ])
            return d0, d1, d2

        dq = tensor(ct1_ntt[0], ct1_ntt[1], ct2_ntt[0], ct2_ntt[1], self.q)
        db = tensor(
            bsk_ntt[(0, 0)], bsk_ntt[(0, 1)], bsk_ntt[(1, 0)],
            bsk_ntt[(1, 1)], self.Bsk,
        )
        # back to coefficients, t-scale, floor, convert, and re-transform
        out = np.zeros((3, k, n), dtype=np.uint64)
        for c in range(3):
            dq_coeff = np.stack([
                golden.inv_ntt(dq[c][i], self.q[i], q_tabs[i])
                for i in range(k)
            ])
            db_coeff = np.stack([
                golden.inv_ntt(db[c][d], self.Bsk[d], bsk_tabs[d])
                for d in range(k + 1)
            ])
            tq_q = np.stack([
                golden.mul_mod(dq_coeff[i], self.t % self.q[i], self.q[i])
                for i in range(k)
            ])
            tq_bsk = np.stack([
                golden.mul_mod(db_coeff[d], self.t % self.Bsk[d], self.Bsk[d])
                for d in range(k + 1)
            ])
            g = self.fast_floor(tq_q, tq_bsk)
            res_q = self.fastbconv_sk(g)
            out[c] = np.stack([
                golden.fwd_ntt(res_q[i], self.q[i], q_tabs[i])
                for i in range(k)
            ])
        return out
