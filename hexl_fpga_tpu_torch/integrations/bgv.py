"""BGV scheme on the port's primitives: exact integer HE.

The counterpart of `hexl_fpga_tpu/integrations/bgv.py`.  The message lives in
the low bits mod t, so every division step subtracts a value divisible by t:

  * ciphertext x ciphertext multiply -> api.DyadicMultiply / dyadic_mul
  * relinearization / rotation       -> the BGV keyswitch tail
    (golden.keyswitch or KeySwitchContext with plain_modulus=t: the
    GHS-corrected tail, noise divisible by t)
  * batching (SEAL BatchEncoder): t = 1 (mod 2n), slots are evaluations at
    the odd powers of a primitive 2n-th root of unity mod t, a 2 x n/2
    matrix; rotate = Galois 5^r (row rotation), conjugate = row swap
  * modulus switching (Gentry-Halevi-Smart): drop q_last by exact division
    after subtracting a correction divisible by t; the message picks up
    q_last^{-1} mod t, tracked as the ciphertext's correction factor (SEAL's
    BGVCorrectionFactor) in `Ciphertext.scale`.

BGV is exact: decryption equals the message mod t.  The host context reuses
CkksContext's RLWE machinery (the same keys and ciphertexts for the same
seed as the reference); the device evaluator reuses DeviceCkksEvaluator with
BGV keyswitch contexts and a device GHS mod switch.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np
import torch

from ..ops import golden, nt, ntt_cuda, twiddles, word64 as w
from . import ckks
from .ckks import Ciphertext


class BatchEncoder:
    """SEAL BatchEncoder analog.  Requires t = 1 (mod 2n): row 0 of the
    2 x n/2 slot matrix at exponents 5^j, row 1 at -5^j (the CKKS embedding's
    orbits, so the evaluators' Galois permutations apply unchanged)."""

    def __init__(self, n: int, t: int):
        assert (t - 1) % (2 * n) == 0, "batching needs t ≡ 1 (mod 2n)"
        self.n = n
        self.t = t
        self.tab_t = twiddles.ntt_tables(n, t)
        b = n.bit_length() - 1
        br = np.array([int(bin(p)[2:].zfill(b)[::-1], 2) for p in range(n)])
        e_of_pos = 2 * br + 1  # golden NTT position p evaluates psi^e
        pos_of_e = np.zeros(2 * n, dtype=np.int64)
        pos_of_e[e_of_pos] = np.arange(n)
        half = n // 2
        g = np.array([pow(5, j, 2 * n) for j in range(half)])
        self.slot_pos = np.concatenate(
            [pos_of_e[g], pos_of_e[(2 * n - g) % (2 * n)]]
        )  # (n,) NTT position of slot j (row-major 2 x n/2)

    def to_poly(self, vals) -> List[int]:
        """(n,) slot values mod t -> centered poly coefficients."""
        a = np.zeros(self.n, dtype=np.uint64)
        a[self.slot_pos] = np.asarray(vals, dtype=np.uint64)
        m = golden.inv_ntt(a, self.t, self.tab_t)
        return [int(v) - self.t if int(v) > self.t // 2 else int(v) for v in m]

    def to_slots(self, m_int) -> np.ndarray:
        """poly coefficients (any lift) -> (n,) slot values mod t."""
        arr = np.array([v % self.t for v in m_int], dtype=np.uint64)
        return golden.fwd_ntt(arr, self.t, self.tab_t)[self.slot_pos]


class BgvContext(ckks.CkksContext):
    """Parameters + keys for one BGV instantiation.

    moduli: decomp primes plus the special prime P last.  t: the plaintext
    modulus, prime, t = 1 mod 2n and coprime to every q.  Ciphertext.scale
    carries the correction factor cf (a small integer in a float): decrypt
    returns [m * cf^{-1}]_t, mod_switch_to_next multiplies cf by
    q_last^{-1} mod t."""

    def __init__(self, n: int, moduli: Sequence[int], t: int, seed: int = 0):
        t = int(t)
        assert t >= 2
        assert (t - 1) % (2 * n) == 0, "batching needs t ≡ 1 (mod 2n)"
        for q in moduli:
            assert math.gcd(int(q), t) == 1, "moduli must be coprime to t"
        self.t = t
        self._noise_scale = t  # fresh/key errors are t*e (BGV form)
        super().__init__(n, moduli, scale=1.0, seed=seed)
        self.encoder = BatchEncoder(n, t)

    def _embedding(self):
        """BGV encodes by the batch encoder: no complex embedding."""

    # -- encode / decode ------------------------------------------------------

    def encode(self, z, level: int | None = None, scale=None) -> List[int]:
        """(n,) integer vector mod t -> centered poly coefficients, rows as
        SEAL's BatchEncoder lays them out.  `scale`, when given, is the
        ciphertext's correction factor: the plaintext is pre-multiplied by cf
        so it adds into [cf * m]_t coherently."""
        z = np.asarray(z)
        assert z.shape == (self.n,), "BGV encodes n slots (2 x n/2 matrix)"
        cf = 1 if scale is None else int(round(scale)) % self.t
        vals = ((z.astype(object) * cf) % self.t).astype(np.uint64)
        return self.encoder.to_poly(vals)

    def decode(self, m_int: List[int], scale) -> np.ndarray:
        """Centered coefficients -> (n,) slot values [m * cf^{-1}]_t."""
        cf = int(round(scale)) % self.t
        a = self.encoder.to_slots(m_int)
        inv_cf = nt.inverse_mod(cf, self.t)
        return (a.astype(object) * inv_cf % self.t).astype(np.uint64)

    def noise_budget(self, ct: Ciphertext) -> int:
        """Bits of headroom before [c0 + c1 s]_Q wraps Q and decryption
        fails: floor(log2(Q / (2 * max |v|))), v = cf*m + t*e centered."""
        Q = math.prod(self.moduli[: ct.level + 1])
        worst = max(abs(v) for v in self._decrypt_centered(ct))
        if worst == 0:
            return Q.bit_length() - 1
        return max(0, int(math.floor(math.log2(Q / (2 * worst)))))

    # -- scheme-specific overrides -------------------------------------------

    def _keyswitch_accumulate(self, d01: np.ndarray, t_ntt: np.ndarray,
                              keys: List[np.ndarray]) -> np.ndarray:
        """result (2, nl, n) += BGV KeySwitch(t) by the golden model's
        GHS-corrected tail (any n, as the reference's host tier)."""
        nl = d01.shape[1]
        out = golden.keyswitch(
            d01.reshape(-1).copy(), t_ntt.ravel(), self.n, nl, self.K, nl + 1,
            2, self.moduli, keys, self.modswitch_factors, self.twiddle_factors,
            plain_modulus=self.t,
        )
        return out.reshape(2, nl, self.n)

    def multiply_relin(self, ct1: Ciphertext, ct2: Ciphertext) -> Ciphertext:
        d, _ = self.multiply(ct1, ct2)
        cf = (int(round(ct1.scale)) * int(round(ct2.scale))) % self.t
        return self.relinearize(d, float(cf), ct1.level)

    def rescale(self, ct: Ciphertext) -> Ciphertext:
        raise TypeError(
            "rescale is a CKKS operation; BGV noise management is "
            "mod_switch_to_next (exact GHS division, correction factor "
            "tracked)"
        )

    def mod_switch_to_next(self, ct: Ciphertext) -> Ciphertext:
        """Drop q_last by the Gentry-Halevi-Smart exact division:
        c' = (c - d') / q_last with d' = c (mod q_last), d' = 0 (mod t):
        d' = [c]_qlast + q_last * u', u' = [-[c]_qlast * q_last^{-1}]_t, both
        centered.  The message picks up q_last^{-1} mod t in cf."""
        nl = ct.level + 1
        assert nl >= 2
        ql = self.moduli[nl - 1]
        ql_half = ql >> 1
        inv_ql_t = nt.inverse_mod(ql % self.t, self.t)
        t_half = self.t >> 1
        out = np.zeros((2, nl - 1, self.n), dtype=np.uint64)
        for k in range(2):
            d = golden.inv_ntt(ct.data[k, nl - 1], ql, self.tabs[nl - 1])
            # e - ql_half is the centered residue [c]_ql; sigma - t_half is
            # the centered u'
            e = (d.astype(object) + ql_half) % ql
            sigma = ((ql_half - e) * inv_ql_t + t_half) % self.t
            for j in range(nl - 1):
                q = self.moduli[j]
                inv_ql = nt.inverse_mod(ql % q, q)
                fix = (-ql_half - ql * t_half) % q
                f = (e + fix + sigma * (ql % q)) % q  # == d' mod q
                c = ct.data[k, j].astype(object)
                g = golden.fwd_ntt(f.astype(np.uint64), q, self.tabs[j])
                out[k, j] = ((c - g.astype(object)) % q * inv_ql % q).astype(np.uint64)
        cf = (int(round(ct.scale)) * inv_ql_t) % self.t
        return Ciphertext(data=out, level=ct.level - 1, scale=float(cf))


class DeviceBgvEvaluator(ckks.DeviceCkksEvaluator):
    """Device-resident BGV ops: DeviceCkksEvaluator's rotations (hoisted too),
    add/sub, plaintext ops and multiply_relin run unchanged on BGV
    ciphertexts over keyswitch contexts with plain_modulus=t; the
    differences are the correction-factor bookkeeping and the mod switch
    (the GHS division on the card instead of a row slice)."""

    @property
    def _plain_modulus(self):
        return self.ctx.t

    def multiply_relin(self, h1, h2):
        out = super().multiply_relin(h1, h2)
        out.scale = float((int(round(h1.scale)) * int(round(h2.scale))) % self.ctx.t)
        return out

    def rescale(self, h):
        raise TypeError("rescale is a CKKS operation; BGV uses mod_switch_to_next")

    def _ms_consts(self, nl: int):
        key = ("bgv_ms", nl)
        if key not in self._consts:
            t, moduli = self.ctx.t, self.ctx.moduli
            ql = moduli[nl - 1]
            t_half, ql_half = t >> 1, ql >> 1
            per_limb = []
            for j in range(nl - 1):
                q = moduli[j]
                inv_ql = nt.inverse_mod(ql % q, q)
                per_limb.append((q, (-ql_half - ql * t_half) % q, ql % q, inv_ql,
                                 nt.barrett_factor(inv_ql, 64, q)))
            self._consts[key] = (ql, ql_half, nt.inverse_mod(ql % t, t),
                                 nt.barrett_factor(1, 64, t), per_limb)
        return self._consts[key]

    def mod_switch_to_next(self, h):
        """GHS mod switch on the card: ntt_inv of the last limb (both
        components), the correction digit sigma mod t in lane math, then per
        remaining limb ntt_fwd of e + fix + sigma * (q_last mod q) (any u64
        in, canonical out) and a Harvey multiply by q_last^{-1}."""
        nl = h.level + 1
        assert nl >= 2
        t = self.ctx.t
        ql, ql_half, inv_ql_t, t_barr, per_limb = self._ms_consts(nl)
        ks = self._ks_ctx(nl)
        d = ntt_cuda.ntt_inv(h.data[:, nl - 1].contiguous(), ks._tabs[nl - 1])
        e = w.add_mod(d, ql_half, ql)                       # (2, n)
        e_t = w.barrett_reduce64(e, t, t_barr)
        x = w.cond_sub64(w.add64(w.sub64(ql_half % t, e_t), t), t)
        sigma = w.add_mod(w.mul_mod_static(x, inv_ql_t, t), t >> 1, t)
        outs = []
        for j, (q, fix, ql_mod, inv_ql, prec) in enumerate(per_limb):
            f = w.add64(w.add64(e, w.mul_mod_static(sigma, ql_mod, q)), fix)
            g = ntt_cuda.ntt_fwd(f, ks._tabs[j])            # NTT(f mod q)
            diff = w.sub_mod(h.data[:, j], g, q)
            outs.append(w.cond_sub64(w.mul_mod_lazy(diff, inv_ql, prec, q), q))
        cf = (int(round(h.scale)) * inv_ql_t) % t
        return ckks.DeviceCkksCiphertext(torch.stack(outs, 1), h.level - 1, float(cf))
