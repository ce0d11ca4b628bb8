"""BFV on the port's primitives: the reference's other SEAL scheme.

The counterpart of `hexl_fpga_tpu/integrations/bfv.py`, with its names, and
the same keys, ciphertexts and bits for the same seed.  The message rides
the high bits (Delta = floor(Q/t)), so the plain CKKS keyswitch serves
relinearization and rotation (the tail's rounding lands in the noise):

  * relinearization / rotation -> `golden.keyswitch` on the host, as the
    reference's host tier; `ckks.DeviceCkksEvaluator` on BFV ciphertexts on
    the card (its CKKS keyswitch contexts are BFV's)
  * multiplication             -> `multiply_rns`: the full-RNS BEHZ multiply,
    on the card by `ops/rns_behz_cuda.py` (`BehzCuda`) or on the host by
    `ops/rns_behz.py` (`BehzTool`); `multiply` is the textbook big-int tensor
    product the RNS algorithm approximates (O(n^2): a small-n oracle)
  * batching                   -> bgv.BatchEncoder (t = 1 mod 2n)
  * modulus switching          -> divide-and-round drop of q_last (no
    correction factor, unlike BGV)

BFV's noise scale is 1: BfvContext derives from CkksContext, not from
BgvContext.  Like BgvContext it builds no complex embedding (BFV never reads
it; 2.15 GB at n = 16384).  The reference computes a*s in `encrypt` and
c1*s in `_raw_decrypt` by a Python schoolbook loop (268 M steps at
n = 16384); here they are the same integers from the vectorised
`ckks._negacyclic_mul_crt` and `CkksContext._decrypt_centered`.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np
import torch

from .. import config
from ..ops import golden, nt, rns_behz, rns_behz_cuda
from . import ckks
from .bgv import BatchEncoder
from .ckks import Ciphertext


def _div_round(num: int, den: int) -> int:
    """round(num / den) in exact integer arithmetic (den > 0; half rounds
    up)."""
    return (2 * num + den) // (2 * den)


class BfvContext(ckks.CkksContext):
    """Parameters + keys for one BFV instantiation.

    moduli: decomp primes q_0..q_{L-1} plus the special prime P last.
    t: plaintext modulus, prime, t = 1 mod 2n (batching).  Messages are (n,)
    integer vectors mod t; Ciphertext.scale stays 1.0."""

    def __init__(self, n: int, moduli: Sequence[int], t: int, seed: int = 0):
        t = int(t)
        assert t >= 2
        for q in moduli:
            assert math.gcd(int(q), t) == 1, "moduli must be coprime to t"
        self.t = t
        super().__init__(n, moduli, scale=1.0, seed=seed)
        self.encoder = BatchEncoder(n, t)

    def _embedding(self):
        """BFV encodes by the batch encoder: no complex embedding."""

    # -- level helpers ---------------------------------------------------------

    def _Q(self, nl: int) -> int:
        return math.prod(self.moduli[:nl])

    def _delta(self, nl: int) -> int:
        return self._Q(nl) // self.t

    def _lift_centered(self, data: np.ndarray, nl: int) -> List[int]:
        """NTT-limb rows (nl, n) -> centered big-int coefficients mod Q."""
        coeff = np.stack([golden.inv_ntt(data[j], self.moduli[j], self.tabs[j])
                          for j in range(nl)])
        return ckks._crt_centered(coeff, self.moduli[:nl])

    # -- encode / decode -------------------------------------------------------

    def encode(self, z, level: int | None = None, scale=None) -> List[int]:
        """(n,) slot values mod t -> centered plaintext poly mod t (the Delta
        scaling happens at encrypt/add_plain, as in SEAL)."""
        z = np.asarray(z)
        assert z.shape == (self.n,), "BFV encodes n slots (2 x n/2 matrix)"
        return self.encoder.to_poly(z.astype(np.uint64))

    def decode(self, m_int: List[int], scale=None) -> np.ndarray:
        return self.encoder.to_slots(m_int)

    # -- encrypt / decrypt -----------------------------------------------------

    def encrypt(self, z, noise_bound: int = 3) -> Ciphertext:
        n, L = self.n, self.L
        Qd = self._Q(L)
        delta = self._delta(L)
        m_int = [delta * v for v in self.encode(z)]
        rng = self._rng
        a_int = [int(rng.integers(0, 1 << 62)) % Qd for _ in range(n)]
        e = [int(v) for v in rng.integers(-noise_bound, noise_bound + 1, size=n)]
        b_int = ckks._negacyclic_mul_crt([(-v) % Qd for v in a_int], self.s,
                                         self.moduli[:L], self.tabs[:L])
        b_int = [(bv + ev + mv) % Qd for bv, ev, mv in zip(b_int, e, m_int)]
        data = np.stack([self._to_ntt_limbs(b_int, L), self._to_ntt_limbs(a_int, L)])
        return Ciphertext(data=data, level=L - 1, scale=1.0)

    def decrypt(self, ct: Ciphertext) -> np.ndarray:
        """m = round(t * [c0 + c1 s]_Q / Q) mod t, then slot-decode."""
        Q = self._Q(ct.level + 1)
        m = [_div_round(self.t * x, Q) % self.t for x in self._raw_decrypt(ct)]
        return self.decode(m)

    def noise_budget(self, ct: Ciphertext) -> int:
        """SEAL's invariant_noise_budget analog: floor(log2(Q / (2 * max
        |[t * v]_Q centered|))) for v = [c0 + c1 s]_Q; 0 means the next
        operation may corrupt the message."""
        Q = self._Q(ct.level + 1)
        worst = max(
            abs(r - Q if r > Q // 2 else r)
            for r in ((self.t * x) % Q for x in self._raw_decrypt(ct))
        )
        if worst == 0:
            return Q.bit_length() - 1
        return max(0, int(math.floor(math.log2(Q / (2 * worst)))))

    def _raw_decrypt(self, ct: Ciphertext) -> List[int]:
        """Centered [c0 + c1 s]_Q (big ints)."""
        return self._decrypt_centered(ct)

    # -- homomorphic ops -------------------------------------------------------

    def _keyswitch_accumulate(self, d01: np.ndarray, t_ntt: np.ndarray,
                              keys) -> np.ndarray:
        """result (2, nl, n) += KeySwitch(t), the plain CKKS/BFV tail, by the
        golden model (any n, as the reference's host tier)."""
        nl = d01.shape[1]
        out = golden.keyswitch(
            d01.reshape(-1).copy(), t_ntt.ravel(), self.n, nl, self.K, nl + 1, 2,
            self.moduli, keys, self.modswitch_factors, self.twiddle_factors,
        )
        return out.reshape(2, nl, self.n)

    def multiply(self, ct1: Ciphertext, ct2: Ciphertext):
        """Textbook BFV tensor product: exact integer negacyclic products of
        the centered lifts, scaled by t/Q with rounding (O(n^2) big-int
        steps: the small-n oracle of multiply_rns).  Returns ((3, nl, n) NTT
        limbs, scale) like CkksContext.multiply, feeding relinearize()."""
        assert ct1.level == ct2.level
        nl = ct1.level + 1
        n = self.n
        Q = self._Q(nl)
        a = [self._lift_centered(ct1.data[k, :nl], nl) for k in range(2)]
        b = [self._lift_centered(ct2.data[k, :nl], nl) for k in range(2)]

        def negacyclic_int(x, y):
            out = [0] * n
            for i, xi in enumerate(x):
                if xi == 0:
                    continue
                for jj, yj in enumerate(y):
                    k = i + jj
                    if k < n:
                        out[k] += xi * yj
                    else:
                        out[k - n] -= xi * yj
            return out

        t01 = negacyclic_int(a[0], b[1])
        t10 = negacyclic_int(a[1], b[0])
        raw = [
            negacyclic_int(a[0], b[0]),
            [u + v for u, v in zip(t01, t10)],
            negacyclic_int(a[1], b[1]),
        ]
        d = np.zeros((3, nl, n), dtype=np.uint64)
        for c in range(3):
            scaled = [_div_round(self.t * v, Q) % Q for v in raw[c]]
            d[c] = self._to_ntt_limbs(scaled, nl)
        return d, 1.0

    def _behz(self, nl: int) -> rns_behz.BehzTool:
        """Per-level host BEHZ tool (aux_bits auto-sized to the BEHZ range
        condition), cached."""
        tools = self.__dict__.setdefault("_behz_tools", {})
        if nl not in tools:
            tools[nl] = rns_behz.BehzTool(self.n, self.moduli[:nl], self.t)
        return tools[nl]

    def _behz_cuda(self, nl: int, device) -> "rns_behz_cuda.BehzCuda | None":
        """Per-(level, device) BehzCuda, cached; None where the level's shape
        is beyond the port's kernels (rns_behz_cuda.fits), decided by the
        shape before anything is built."""
        tools = self.__dict__.setdefault("_behz_cuda_tools", {})
        key = (nl, str(torch.device(device)))
        if key not in tools:
            tool = self._behz(nl)
            tools[key] = (rns_behz_cuda.BehzCuda(tool, self.tabs[:nl], device)
                          if rns_behz_cuda.fits(tool) else None)
        return tools[key]

    def multiply_rns(self, ct1: Ciphertext, ct2: Ciphertext,
                     device: bool | None = None):
        """Full-RNS BFV multiply (BEHZ): base extension, NTT-domain tensor,
        fast floor, Shenoy-Kumaresan back-conversion.  device=True runs
        BehzCuda on the card (raising without one, or at a shape beyond its
        kernels); False the host BehzTool; None follows RUN_CHOICE: 2 the
        card, 1 BehzCuda on the CPU (the kernels' plain versions), 0 the host
        tool, and the host tool wherever the shape is beyond the kernels.
        Every route gives the same bits.  The result differs from `multiply`
        only by BEHZ's bounded correction terms, which land in the noise."""
        assert ct1.level == ct2.level
        nl = ct1.level + 1
        c1 = np.asarray(ct1.data[:, :nl], dtype=np.uint64)
        c2 = np.asarray(ct2.data[:, :nl], dtype=np.uint64)
        run_choice = config.get_config().run_choice if device is None else None
        dev = None
        if device is True or run_choice in (1, 2):
            target = "cpu" if run_choice == 1 else "cuda"
            dev = self._behz_cuda(nl, target)
            if device is True and dev is None:
                raise ValueError(
                    "device BEHZ unavailable at this shape (n beyond the "
                    "transform kernels or Bsk primes of 2^62 and more)")
        if dev is not None:
            return dev.multiply(c1, c2), 1.0
        return self._behz(nl).multiply(c1, c2, self.tabs[:nl]), 1.0

    def rescale(self, ct: Ciphertext) -> Ciphertext:
        raise TypeError(
            "rescale is a CKKS operation; BFV noise management is "
            "mod_switch_to_next (divide-and-round drop of q_last)"
        )

    def mod_switch_to_next(self, ct: Ciphertext) -> Ciphertext:
        """Drop q_last by exact division after subtracting the centered
        residue: Delta m / q_last lands within 1 of Delta' m, the difference
        joining the noise (no mod-t correction, unlike bgv.BgvContext)."""
        nl = ct.level + 1
        assert nl >= 2
        ql = self.moduli[nl - 1]
        ql_half = ql >> 1
        out = np.zeros((2, nl - 1, self.n), dtype=np.uint64)
        for k in range(2):
            d = golden.inv_ntt(ct.data[k, nl - 1], ql, self.tabs[nl - 1])
            e = (d.astype(object) + ql_half) % ql  # e - ql_half = [c]_ql
            for j in range(nl - 1):
                q = self.moduli[j]
                inv_ql = nt.inverse_mod(ql % q, q)
                f = (e + q - (ql_half % q)) % q
                c = ct.data[k, j].astype(object)
                g = golden.fwd_ntt(f.astype(np.uint64), q, self.tabs[j])
                out[k, j] = ((c - g.astype(object)) % q * inv_ql % q).astype(np.uint64)
        return Ciphertext(data=out, level=ct.level - 1, scale=1.0)

    def add_plain(self, ct: Ciphertext, z) -> Ciphertext:
        """ct + Delta * encode(z) (SEAL multiply_add_plain_with_scaling)."""
        nl = ct.level + 1
        delta = self._delta(nl)
        m_ntt = self._to_ntt_limbs([delta * v for v in self.encode(z)], nl)
        out = ct.data.copy()
        for j in range(nl):
            q = np.uint64(self.moduli[j])
            with np.errstate(over="ignore"):
                s = out[0, j] + m_ntt[j]
            out[0, j] = np.where(s >= q, s - q, s)
        return Ciphertext(data=out, level=ct.level, scale=1.0)

    def multiply_plain(self, ct: Ciphertext, z) -> Ciphertext:
        """ct * encode(z): pointwise NTT multiply per limb; the plain poly is
        not Delta-scaled (the message becomes Delta * m1 * m2)."""
        nl = ct.level + 1
        m_ntt = self._to_ntt_limbs(self.encode(z), nl)
        out = np.zeros_like(ct.data)
        for k in range(2):
            for j in range(nl):
                q = self.moduli[j]
                out[k, j] = (ct.data[k, j].astype(object)
                             * m_ntt[j].astype(object) % q).astype(np.uint64)
        return Ciphertext(data=out, level=ct.level, scale=1.0)
