"""Minimal CKKS scheme on the port's primitives: the SEAL-bridge analog.

The counterpart of `hexl_fpga_tpu/integrations/ckks.py`, with the same names,
the same keys and ciphertexts for the same seed, and the same bits from every
operation that is not hoisted:

  CkksContext            host context: parameters, keys, encode/decode,
                         encrypt/decrypt in exact host arithmetic; multiply
                         and every keyswitch through the port's public API
                         (api.DyadicMultiply, api.KeySwitch)
  DeviceCkksEvaluator    device-resident evaluation on int64 tensors: Galois
                         gather + KeySwitchContext._build (rotate, conjugate),
                         dyadic_mul + _build (multiply_relin), ntt_inv +
                         word64 lane math + ntt_fwd (rescale), hoisted
                         rotations, and the BSGS matrix-vector product, whose
                         fused form replays as one CUDA graph

The reference's host context builds two negacyclic products by a Python
schoolbook loop (s^2 for the relinearization key, a*s in every encrypt), about
180 M and 268 M steps at n = 16384; here they are exact vectorised products of
the same integers (`_negacyclic_square_small`, `_negacyclic_mul_crt`).  Every
random draw is the reference's, one `rng.integers` per coefficient where it
draws so.  The embedding matrix E is built and applied as the reference
builds it (BLAS summation order decides encode's rounding); at n = 16384 it
is (8192, 16384) complex128, 2.1 GB, and each encode makes its conjugate
transpose for the call, another 2.1 GB.

SEAL_N, SEAL_BITS, SEAL_SCALE and `seal_moduli` give the SEAL bridge's CKKS
deployment; MATVEC_DIAGONALS and MATVEC_N1 the benchmark's matvec shape.

Device values are one int64 bit pattern per u64 (`ops/word64.py`), a
ciphertext one (2, level + 1, n) tensor where the reference carries an
interleaved u32 `data32`.  An evaluator takes a `device`: "cuda" (the default)
raises without a CUDA device, "cpu" runs every kernel's plain version.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch

from .. import api
from ..ops import dyadic_cuda, galois_cuda, golden, keyswitch_cuda, nt, ntt_cuda
from ..ops import twiddles, word64 as w
from ..utils.graph import GraphProgram

# the SEAL bridge's CKKS deployment
# (experimental/bridge-seal/tests/keyswitch-example.cpp:30-33): n = 16384,
# moduli of {52, 40, 40, 40, 40, 40, 52} bits, scale 2^40
SEAL_N, SEAL_BITS, SEAL_SCALE = 16384, (52, 40, 40, 40, 40, 40, 52), 2.0 ** 40
# the benchmark's encrypted matrix-vector product: 16 diagonals, n1 = 4
MATVEC_DIAGONALS, MATVEC_N1 = 16, 4


def seal_moduli(n: int) -> List[int]:
    """The bridge's chain from nt.generate_primes: one 52-bit prime first,
    five of 40 bits, a second 52-bit prime (the special prime) last.  SEAL's
    bit sizes are bit lengths; generate_primes(k, b, n) draws from
    [2^b, 2^(b+1)), so a prime of b bits takes b - 1."""
    p52 = [int(q) for q in nt.generate_primes(2, 51, n)]
    return [p52[0]] + [int(q) for q in nt.generate_primes(5, 39, n)] + [p52[1]]


def _obj(a) -> np.ndarray:
    return np.asarray(a, dtype=np.uint64).astype(object)


def _negacyclic_automorphism(m: List[int], g: int, n: int, Q: int) -> List[int]:
    """m(X) -> m(X^g) mod (X^n + 1, Q)."""
    out = [0] * n
    for k, c in enumerate(m):
        e = (g * k) % (2 * n)
        if e < n:
            out[e] = (out[e] + c) % Q
        else:
            out[e - n] = (out[e - n] - c) % Q
    return out


def _automorphism_np(c: np.ndarray, g: int, q: int) -> np.ndarray:
    """_negacyclic_automorphism of canonical residues mod q, vectorised: g is
    odd, so every output coefficient receives exactly one input, c or -c."""
    n = c.shape[-1]
    e = (g * np.arange(n)) % (2 * n)
    neg = e >= n
    vals = np.where(neg & (c != 0), np.uint64(q) - c, c)
    out = np.empty_like(c)
    out[..., np.where(neg, e - n, e)] = vals
    return out


def _negacyclic_square_small(s: Sequence[int]) -> List[int]:
    """s(X)^2 mod X^n + 1 for small integer coefficients, exact: an int64
    linear convolution (|s_i| <= 1 keeps every sum below n) folded
    negacyclically.  Equals the schoolbook product, centered."""
    a = np.asarray(s, dtype=np.int64)
    n = a.size
    full = np.convolve(a, a)  # (2n - 1,), direct summation in int64
    out = full[:n].copy()
    out[: n - 1] -= full[n:]
    return [int(v) for v in out]


def _negacyclic_mul_crt(a_int: Sequence[int], s: Sequence[int], moduli,
                        tabs) -> List[int]:
    """a(X) * s(X) mod (X^n + 1, Q), Q = prod(moduli), canonical in [0, Q):
    per q_j the product of the residues by the golden NTT (exact, q_j = 1 mod
    2n), then the CRT.  The same integers as vectors._negacyclic_mul(a, s, Q)."""
    Q = math.prod(moduli)
    acc = None
    for q, tab in zip(moduli, tabs):
        A = golden.fwd_ntt(np.array([v % q for v in a_int], dtype=np.uint64), q, tab)
        S = golden.fwd_ntt(np.array([v % q for v in s], dtype=np.uint64), q, tab)
        prod = ((A.astype(object) * S.astype(object)) % q).astype(np.uint64)
        r = golden.inv_ntt(prod, q, tab).astype(object)
        Qi = Q // q
        term = r * (Qi * nt.inverse_mod(Qi % q, q))
        acc = term if acc is None else acc + term
    return [int(v) % Q for v in acc]


def _crt_centered(coeff: np.ndarray, moduli) -> List[int]:
    """(nl, n) residues -> the centered integers mod Q = prod(moduli)."""
    Q = math.prod(moduli)
    acc = 0
    for j, q in enumerate(moduli):
        Qi = Q // q
        acc = acc + coeff[j].astype(object) * (Qi * nt.inverse_mod(Qi % q, q))
    m = [int(v) % Q for v in acc]
    return [v - Q if v > Q // 2 else v for v in m]


@dataclass
class Ciphertext:
    data: np.ndarray  # (2, level+1, n) uint64, NTT domain per limb
    level: int        # number of active decomp moduli - 1
    scale: float


class CkksContext:
    """Parameters + keys for one CKKS instantiation.

    moduli: full key-modulus chain — decomp primes q_0..q_{L-1} plus the
    special prime P as the last entry (the reference keyswitch layout)."""

    # the BGV subclass sets t: fresh and key errors are then t * e
    _noise_scale = 1

    def __init__(self, n: int, moduli: Sequence[int], scale: float,
                 seed: int = 0):
        self._setup(n, moduli, scale, seed)
        rng = self._rng
        self.s = [int(v) for v in rng.integers(-1, 2, size=n)]  # ternary
        self._embedding()
        # relinearization keys: s^2 -> s (small integers, centered)
        self.relin_keys = self._make_switch_keys(_negacyclic_square_small(self.s))
        self._rot_keys = {}

    def _setup(self, n, moduli, scale, seed):
        self.n = n
        self.moduli = [int(q) for q in moduli]
        self.K = len(self.moduli)
        self.L = self.K - 1            # decomp moduli
        self.P = self.moduli[-1]
        self.scale = scale
        self.slots = n // 2
        self.tabs = [twiddles.ntt_tables(n, q) for q in self.moduli]
        self.twiddle_factors = twiddles.keyswitch_twiddles(n, self.moduli)
        self.modswitch_factors = [
            nt.inverse_mod(self.P % q, q) if q != self.P else 1
            for q in self.moduli
        ]
        self._rng = np.random.default_rng(seed)

    def _embedding(self):
        """Canonical embedding: slot j evaluated at zeta^{5^j}, zeta = e^{i pi/n}
        (the reference's expression, so encode rounds alike)."""
        n = self.n
        e = np.array([pow(5, j, 2 * n) for j in range(self.slots)])
        k = np.arange(n)
        self.E = np.exp(1j * np.pi * np.outer(e, k) / n)  # (slots, n)

    # -- key material --------------------------------------------------------

    def _s_ntt(self, j: int) -> np.ndarray:
        q = self.moduli[j]
        return golden.fwd_ntt(np.array([v % q for v in self.s], dtype=np.uint64),
                              q, self.tabs[j])

    def _make_switch_keys(self, s_old: List[int]) -> List[np.ndarray]:
        """P-gadget switching keys s_old -> s (the reference's recipe and
        draws)."""
        n, K, L, P = self.n, self.K, self.L, self.P
        QP = math.prod(self.moduli)
        rng = self._rng
        sn_ntt = [self._s_ntt(j) for j in range(K)]
        keys = []
        for i in range(L):
            a_int = [int(rng.integers(0, 1 << 62)) % QP for _ in range(n)]
            e = [self._noise_scale * int(v)
                 for v in rng.integers(-3, 4, size=n)]
            comp0 = np.zeros((K, n), dtype=np.uint64)
            comp1 = np.zeros((K, n), dtype=np.uint64)
            for j, q in enumerate(self.moduli):
                a_ntt = golden.fwd_ntt(
                    np.array([v % q for v in a_int], dtype=np.uint64), q,
                    self.tabs[j],
                )
                comp1[j] = a_ntt
                neg_a = np.where(a_ntt == 0, 0, np.uint64(q) - a_ntt)
                b = golden.inv_ntt(
                    ((neg_a.astype(object) * sn_ntt[j].astype(object)) % q
                     ).astype(np.uint64), q, self.tabs[j],
                )
                add = np.array(
                    [(ev + (P * sv if j == i else 0)) % q
                     for ev, sv in zip(e, s_old)],
                    dtype=np.uint64,
                )
                b = ((b.astype(object) + add.astype(object)) % q).astype(
                    np.uint64
                )
                comp0[j] = golden.fwd_ntt(b, q, self.tabs[j])
            keys.append(np.concatenate([comp0.ravel(), comp1.ravel()]))
        return keys

    def galois_keys(self, r: int) -> List[np.ndarray]:
        """Rotation keys for a left-rotation by r slots (s(X^g) -> s)."""
        return self._galois_keys_for(pow(5, r, 2 * self.n))

    def _galois_keys_for(self, g: int) -> List[np.ndarray]:
        if g not in self._rot_keys:
            s_g = _negacyclic_automorphism(self.s, g, self.n, 1 << 127)
            s_g = [v if v < (1 << 126) else v - (1 << 127) for v in s_g]
            self._rot_keys[g] = self._make_switch_keys(s_g)
        return self._rot_keys[g]

    # -- encode / decode ------------------------------------------------------

    def encode(self, z, level: int | None = None, scale: float | None = None):
        """complex vector (slots,) -> integer poly coefficients (list)."""
        scale = scale or self.scale
        z = np.asarray(z, dtype=np.complex128)
        assert z.shape == (self.slots,)
        m = (2.0 / self.n) * np.real(self.E.conj().T @ z)  # (n,)
        return [int(round(v * scale)) for v in m]

    def decode(self, m_int: List[int], scale: float) -> np.ndarray:
        m = np.array([float(v) for v in m_int])
        return (self.E @ m) / scale

    # -- encrypt / decrypt ----------------------------------------------------

    def _to_ntt_limbs(self, m_int: List[int], nlimbs: int) -> np.ndarray:
        out = np.zeros((nlimbs, self.n), dtype=np.uint64)
        for j in range(nlimbs):
            q = self.moduli[j]
            arr = np.array([v % q for v in m_int], dtype=np.uint64)
            out[j] = golden.fwd_ntt(arr, q, self.tabs[j])
        return out

    def encrypt(self, z, noise_bound: int = 3) -> Ciphertext:
        n, L = self.n, self.L
        m_int = self.encode(z)
        Qd = math.prod(self.moduli[:L])
        rng = self._rng
        a_int = [int(rng.integers(0, 1 << 62)) % Qd for _ in range(n)]
        e = [self._noise_scale * int(v)
             for v in rng.integers(-noise_bound, noise_bound + 1, size=n)]
        b_int = _negacyclic_mul_crt([(-v) % Qd for v in a_int], self.s,
                                    self.moduli[:L], self.tabs[:L])
        b_int = [(bv + ev + mv) % Qd for bv, ev, mv in zip(b_int, e, m_int)]
        data = np.stack(
            [self._to_ntt_limbs(b_int, L), self._to_ntt_limbs(a_int, L)]
        )
        return Ciphertext(data=data, level=L - 1, scale=self.scale)

    def _decrypt_centered(self, ct: Ciphertext) -> List[int]:
        """[c0 + c1 s]_Q per limb, CRT-reconstructed and centered."""
        nl = ct.level + 1
        coeff = np.zeros((nl, self.n), dtype=np.uint64)
        for j, q in enumerate(self.moduli[:nl]):
            v = (_obj(ct.data[0, j]) + _obj(ct.data[1, j])
                 * self._s_ntt(j).astype(object)) % q
            coeff[j] = golden.inv_ntt(v.astype(np.uint64), q, self.tabs[j])
        return _crt_centered(coeff, self.moduli[:nl])

    def decrypt(self, ct: Ciphertext) -> np.ndarray:
        return self.decode(self._decrypt_centered(ct), ct.scale)

    # -- homomorphic ops (through the port's public API) ----------------------

    def multiply(self, ct1: Ciphertext, ct2: Ciphertext):
        """ct x ct -> 3-component intermediate (d0, d1, d2), via
        api.DyadicMultiply."""
        assert ct1.level == ct2.level
        nl = ct1.level + 1
        moduli = np.array(self.moduli[:nl], dtype=np.uint64)
        results = np.zeros(3 * nl * self.n, dtype=np.uint64)
        api.set_worksize_DyadicMultiply(1)
        api.DyadicMultiply(
            results, ct1.data.ravel(), ct2.data.ravel(), self.n, moduli, nl
        )
        api.DyadicMultiplyCompleted()
        return results.reshape(3, nl, self.n), ct1.scale * ct2.scale

    def _keyswitch_accumulate(self, d01: np.ndarray, t_ntt: np.ndarray,
                              keys: List[np.ndarray]) -> np.ndarray:
        """result (2, nl, n) += KeySwitch(t) via api.KeySwitch."""
        nl = d01.shape[1]
        result = d01.reshape(-1).copy()
        api.set_worksize_KeySwitch(1)
        api.KeySwitch(
            result, t_ntt.ravel(), self.n, nl, self.K, nl + 1, 2,
            self.moduli, keys, self.modswitch_factors, self.twiddle_factors,
        )
        api.KeySwitchCompleted()
        return result.reshape(2, nl, self.n)

    def relinearize(self, d: np.ndarray, scale: float, level: int) -> Ciphertext:
        """(d0, d1, d2) -> 2-component ciphertext via the relin keyswitch."""
        out = self._keyswitch_accumulate(d[:2], d[2], self.relin_keys)
        return Ciphertext(data=out, level=level, scale=scale)

    def multiply_relin(self, ct1: Ciphertext, ct2: Ciphertext) -> Ciphertext:
        d, sc = self.multiply(ct1, ct2)
        return self.relinearize(d, sc, ct1.level)

    def rescale(self, ct: Ciphertext) -> Ciphertext:
        """Exact RNS rescale by the last active modulus (coeff domain)."""
        nl = ct.level + 1
        assert nl >= 2
        q_last = self.moduli[nl - 1]
        out = np.zeros((2, nl - 1, self.n), dtype=np.uint64)
        for k in range(2):
            limbs = [
                golden.inv_ntt(ct.data[k, j], self.moduli[j], self.tabs[j])
                for j in range(nl)
            ]
            last = limbs[nl - 1].astype(object)
            for j in range(nl - 1):
                q = self.moduli[j]
                inv_qlast = nt.inverse_mod(q_last % q, q)
                v = ((limbs[j].astype(object) - last) % q * inv_qlast) % q
                out[k, j] = golden.fwd_ntt(v.astype(np.uint64), q, self.tabs[j])
        return Ciphertext(data=out, level=ct.level - 1, scale=ct.scale / q_last)

    def mod_switch_to_next(self, ct: Ciphertext) -> Ciphertext:
        """Drop the last active modulus WITHOUT rescaling (SEAL's
        mod_switch_to_next): a row slice in RNS-NTT form, scale unchanged."""
        nl = ct.level + 1
        assert nl >= 2
        return Ciphertext(data=ct.data[:, : nl - 1].copy(), level=ct.level - 1,
                          scale=ct.scale)

    def _addsub(self, ct1: Ciphertext, ct2: Ciphertext, sub: bool) -> Ciphertext:
        assert ct1.level == ct2.level and abs(ct1.scale - ct2.scale) < 1e-3
        nl = ct1.level + 1
        out = np.zeros_like(ct1.data)
        for j in range(nl):
            q = np.uint64(self.moduli[j])
            with np.errstate(over="ignore"):
                s = (ct1.data[:, j] + q - ct2.data[:, j] if sub
                     else ct1.data[:, j] + ct2.data[:, j])
            out[:, j] = np.where(s >= q, s - q, s)
        return Ciphertext(data=out, level=ct1.level, scale=ct1.scale)

    def add(self, ct1: Ciphertext, ct2: Ciphertext) -> Ciphertext:
        return self._addsub(ct1, ct2, sub=False)

    def sub(self, ct1: Ciphertext, ct2: Ciphertext) -> Ciphertext:
        return self._addsub(ct1, ct2, sub=True)

    def add_plain(self, ct: Ciphertext, z) -> Ciphertext:
        """ct + encode(z) at the ciphertext's scale."""
        nl = ct.level + 1
        m_ntt = self._to_ntt_limbs(self.encode(z, scale=ct.scale), nl)
        out = ct.data.copy()
        for j in range(nl):
            q = np.uint64(self.moduli[j])
            with np.errstate(over="ignore"):
                s = out[0, j] + m_ntt[j]
            out[0, j] = np.where(s >= q, s - q, s)
        return Ciphertext(data=out, level=ct.level, scale=ct.scale)

    def multiply_plain(self, ct: Ciphertext, z) -> Ciphertext:
        """ct * encode(z); scale multiplies (rescale afterwards)."""
        nl = ct.level + 1
        m_ntt = self._to_ntt_limbs(self.encode(z), nl)
        out = np.zeros_like(ct.data)
        for k in range(2):
            for j in range(nl):
                q = self.moduli[j]
                out[k, j] = (
                    _obj(ct.data[k, j]) * m_ntt[j].astype(object) % q
                ).astype(np.uint64)
        return Ciphertext(data=out, level=ct.level, scale=ct.scale * self.scale)

    def conjugate(self, ct: Ciphertext) -> Ciphertext:
        """Complex conjugation of the slots: the Galois map X -> X^{2n-1}."""
        return self._apply_galois(ct, 2 * self.n - 1)

    def rotate(self, ct: Ciphertext, r: int) -> Ciphertext:
        """Left-rotate slots by r: Galois automorphism + keyswitch."""
        return self._apply_galois(ct, pow(5, r, 2 * self.n))

    def _apply_galois(self, ct: Ciphertext, g: int) -> Ciphertext:
        nl = ct.level + 1
        # apply tau_g per limb in the coefficient domain (exact)
        rot = np.zeros_like(ct.data)
        for j in range(nl):
            q = self.moduli[j]
            c = golden.inv_ntt(ct.data[:, j], q, self.tabs[j])
            rot[:, j] = golden.fwd_ntt(_automorphism_np(c, g, q), q, self.tabs[j])
        # keyswitch the c1(X^g) component from s(X^g) to s
        d01 = np.stack([rot[0], np.zeros_like(rot[0])])
        out = self._keyswitch_accumulate(d01, rot[1], self._galois_keys_for(g))
        return Ciphertext(data=out, level=ct.level, scale=ct.scale)


# ---------------------------------------------------------------------------
# Device-resident evaluation
# ---------------------------------------------------------------------------
#
# The Galois automorphism tau_g is a permutation of NTT-domain values
# (galois_cuda.ntt_galois_sigma), so a rotation is one gather + the keyswitch
# and a chain of operations keeps the ciphertext on the card, with one copy
# to the host at the end.


@dataclass
class DeviceCkksCiphertext:
    """(2, level+1, n) int64 NTT-domain ciphertext on the evaluator's device."""

    data: torch.Tensor
    level: int
    scale: float


@dataclass
class DeviceHoistedCiphertext:
    """A ciphertext + the hoisted decomposition of its c1, on device."""

    dec: torch.Tensor   # (nl+1, nl, n): KeySwitchContext._decompose of c1
    data: torch.Tensor  # the (2, nl, n) ciphertext (for c0)
    level: int
    scale: float


class DeviceCkksEvaluator:
    """Device-resident CKKS ops for a CkksContext, on `device`.

    Every operation is a composition of the port's kernels and word64 lane
    math on int64 tensors; per-level constants and key uploads are cached
    (the keys in each level's KeySwitchContext LRU)."""

    def __init__(self, ctx: CkksContext, device="cuda"):
        self.ctx = ctx
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"{type(self).__name__}(device='cuda'): no CUDA device is "
                "available; pass device='cpu' to run the plain versions"
            )
        self._ks = {}
        self._qcol = {}
        self._consts = {}

    # the BGV evaluator's keyswitch tail (None: the CKKS tail)
    _plain_modulus = None

    def _ks_ctx(self, nl: int) -> keyswitch_cuda.KeySwitchContext:
        """The KeySwitchContext of nl active decomp moduli under all K key
        moduli (after a rescale K > nl + 1: the moduli between are idle),
        held per level: get_context hashes the twiddle tables on every call
        (a few ms at n = 16384)."""
        if nl not in self._ks:
            c = self.ctx
            self._ks[nl] = keyswitch_cuda.get_context(
                c.n, nl, c.K, nl + 1, 2, c.moduli, c.twiddle_factors,
                device=self.device, plain_modulus=self._plain_modulus,
            )
        return self._ks[nl]

    def _moduli_col(self, nl: int) -> torch.Tensor:
        """(nl, 1) int64 moduli on the device, for limbwise add/sub."""
        if nl not in self._qcol:
            self._qcol[nl] = w.from_u64_np(
                np.array(self.ctx.moduli[:nl], dtype=np.uint64).reshape(nl, 1),
                self.device)
        return self._qcol[nl]

    def _msf(self, ks):
        return ks.prepare_msf4(self.ctx.modswitch_factors)

    def stage(self, ct: Ciphertext) -> DeviceCkksCiphertext:
        return DeviceCkksCiphertext(w.from_u64_np(ct.data, self.device),
                                    ct.level, ct.scale)

    def to_host(self, h: DeviceCkksCiphertext) -> Ciphertext:
        data = w.to_u64_np(h.data).reshape(2, h.level + 1, self.ctx.n)
        return Ciphertext(data=data, level=h.level, scale=h.scale)

    # -- tensor-level pieces, shared by every composition below --------------

    @staticmethod
    def _base(c0: torch.Tensor) -> torch.Tensor:
        """(nl, n) c0 -> the accumulation base (1, 2, nl, n) = [c0, 0]."""
        return torch.stack([c0, torch.zeros_like(c0)])[None]

    def _galois_staged(self, ks, g: int):
        """(keys, key precons, Galois index) of g at ks's level, from the
        caches (an LRU each: hold the tensors to keep them)."""
        keys, kp = ks.device_keys(self.ctx._galois_keys_for(g))
        return keys, kp, galois_cuda.galois_index(self.ctx.n, g, self.device)

    def _galois_data(self, x: torch.Tensor, staged) -> torch.Tensor:
        """NTT-domain automorphism (one gather) + keyswitch of c1(X^g), with
        g's `_galois_staged` tensors."""
        ks = self._ks_ctx(x.shape[1])
        keys, kp, index = staged
        rot = x.index_select(-1, index)
        return ks._build(rot[1][None], keys, kp, self._base(rot[0]),
                         self._msf(ks))[0]

    def _addsub_data(self, a: torch.Tensor, b: torch.Tensor, sub: bool):
        q = self._moduli_col(a.shape[1])
        return w.sub_mod(a, b, q) if sub else w.add_mod(a, b, q)

    def _plain_planes(self, m_int, nl: int) -> torch.Tensor:
        """Encoded plaintext (coefficients) -> (nl, n) NTT limbs on device."""
        return w.from_u64_np(self.ctx._to_ntt_limbs(m_int, nl), self.device)

    def _mul_meta(self, nl: int) -> torch.Tensor:
        """dyadic_cuda's per-limb (q, Barrett factor, length) rows for nl
        limbs, from its runner cache (an LRU: hold the tensor to keep it)."""
        return dyadic_cuda.runner(self.ctx.moduli[:nl], self.device).meta

    def _mul_plain_data(self, x: torch.Tensor, p: torch.Tensor,
                        meta: torch.Tensor) -> torch.Tensor:
        """x (2, nl, n) * p (nl, n) limbwise, canonical: every limb at once by
        the reference MultMod with `_mul_meta`'s per-limb constants, exact on
        canonical operands."""
        q, barr, length = (meta[k].view(-1, 1) for k in range(3))
        return w.mul_mod_traced(x, p, q, barr, length)

    def _hoisted_keys(self, ks, gs):
        """Per-step sigma^{-1}-permuted key sets, stacked (S, L, comp, K, n),
        and the steps' output permutations (S, n)."""
        n = self.ctx.n
        sets = [ks.device_keys(self.ctx._galois_keys_for(g),
                               hoist_perm=galois_cuda.ntt_galois_sigma(n, g))
                for g in gs]
        keys, kp = (torch.stack([s[i] for s in sets]) for i in range(2))
        index = torch.stack([galois_cuda.galois_index(n, g, self.device) for g in gs])
        return keys, kp, index

    def _hoisted_many_data(self, dec, c0, ks, staged):
        """S hoisted rotations of one decomposition as one batched apply:
        (S, 2, nl, n)."""
        keys, kp, index = staged
        res = self._base(c0).expand(keys.shape[0], -1, -1, -1).contiguous()
        return ks._apply_hoisted_many(dec, res, keys, kp, self._msf(ks), index)

    # -- rotations, add/sub ---------------------------------------------------

    def _apply_galois(self, h: DeviceCkksCiphertext, g: int):
        ks = self._ks_ctx(h.level + 1)
        return DeviceCkksCiphertext(
            self._galois_data(h.data, self._galois_staged(ks, g)), h.level, h.scale)

    def rotate(self, h: DeviceCkksCiphertext, r: int) -> DeviceCkksCiphertext:
        """Left-rotate slots by r, fully on device (gather + keyswitch)."""
        return self._apply_galois(h, pow(5, r, 2 * self.ctx.n))

    def conjugate(self, h: DeviceCkksCiphertext) -> DeviceCkksCiphertext:
        return self._apply_galois(h, 2 * self.ctx.n - 1)

    def _addsub(self, h1, h2, sub: bool):
        assert h1.level == h2.level and abs(h1.scale - h2.scale) < 1e-3
        return DeviceCkksCiphertext(self._addsub_data(h1.data, h2.data, sub),
                                    h1.level, h1.scale)

    def add(self, h1, h2) -> DeviceCkksCiphertext:
        return self._addsub(h1, h2, sub=False)

    def sub(self, h1, h2) -> DeviceCkksCiphertext:
        return self._addsub(h1, h2, sub=True)

    # -- multiply / relinearize / rescale -------------------------------------

    def multiply_relin(self, h1: DeviceCkksCiphertext,
                       h2: DeviceCkksCiphertext) -> DeviceCkksCiphertext:
        """h1 * h2 -> relinearized: dyadic_mul (2x2 -> 3 per limb), then the
        relin keyswitch of d2 accumulated into (d0, d1)."""
        assert h1.level == h2.level
        nl = h1.level + 1
        runner = dyadic_cuda.runner(self.ctx.moduli[:nl], self.device)
        ks = self._ks_ctx(nl)
        keys, kp = ks.device_keys(self.ctx.relin_keys)
        d = runner.run(h1.data.contiguous()[None],
                       h2.data.contiguous()[None])[0]         # (3, nl, n)
        out = ks._build(d[2][None], keys, kp, d[:2][None], self._msf(ks))[0]
        return DeviceCkksCiphertext(out, h1.level, h1.scale * h2.scale)

    def _rescale_consts(self, nl: int):
        key = ("rescale", nl)
        if key not in self._consts:
            moduli = self.ctx.moduli
            q_last = moduli[nl - 1]
            consts = []
            for j in range(nl - 1):
                q = moduli[j]
                inv = nt.inverse_mod(q_last % q, q)
                # C * q > q_last: c_j + C*q - c_last is positive, < 2^54
                consts.append((q, inv, nt.barrett_factor(inv, 64, q),
                               (q_last // q + 1) * q))
            self._consts[key] = consts
        return self._consts[key]

    def rescale(self, h: DeviceCkksCiphertext) -> DeviceCkksCiphertext:
        """Exact RNS rescale by the last active modulus: per limb ntt_inv over
        both components, (c_j - c_last) * q_last^{-1} mod q_j as lane math
        (c_j + C*q_j - c_last into a Harvey multiply), ntt_fwd."""
        nl = h.level + 1
        assert nl >= 2, "rescale needs at least two active moduli"
        ks = self._ks_ctx(nl)
        coeff = [ntt_cuda.ntt_inv(h.data[:, j].contiguous(), ks._tabs[j])
                 for j in range(nl)]
        last = coeff[nl - 1]
        outs = []
        for j, (q, inv, prec, cq) in enumerate(self._rescale_consts(nl)):
            d = w.sub64(w.add64(coeff[j], cq), last)
            v = w.cond_sub64(w.mul_mod_lazy(d, inv, prec, q), q)
            outs.append(ntt_cuda.ntt_fwd(v, ks._tabs[j]))
        return DeviceCkksCiphertext(torch.stack(outs, 1), h.level - 1,
                                    h.scale / self.ctx.moduli[nl - 1])

    def mod_switch_to_next(self, h: DeviceCkksCiphertext) -> DeviceCkksCiphertext:
        """Drop the last active modulus without rescaling: a row slice."""
        nl = h.level + 1
        assert nl >= 2
        return DeviceCkksCiphertext(h.data[:, : nl - 1].contiguous(),
                                    h.level - 1, h.scale)

    # -- plaintext ops (encoding on the host) ---------------------------------

    def add_plain(self, h: DeviceCkksCiphertext, z) -> DeviceCkksCiphertext:
        """h + encode(z) at h's scale: the limbwise add on device."""
        nl = h.level + 1
        p = self._plain_planes(self.ctx.encode(z, scale=h.scale), nl)
        c0 = w.add_mod(h.data[0], p, self._moduli_col(nl))
        return DeviceCkksCiphertext(torch.stack([c0, h.data[1]]), h.level, h.scale)

    def multiply_plain(self, h: DeviceCkksCiphertext, z) -> DeviceCkksCiphertext:
        """h * encode(z); scale multiplies (rescale afterwards)."""
        nl = h.level + 1
        p = self._plain_planes(self.ctx.encode(z), nl)
        return DeviceCkksCiphertext(
            self._mul_plain_data(h.data, p, self._mul_meta(nl)), h.level,
            h.scale * self.ctx.scale)

    # -- hoisted rotations (decompose once, rotate many) ----------------------
    #
    # Halevi-Shoup hoisting on KeySwitchContext's hoisted core: the keyswitch
    # prefix (INTT1 + every engine NTT) depends only on c1, so it runs once,
    # and each rotation is the MAC against sigma^{-1}-permuted keys + INTT2 +
    # tails + one output gather.  Not bit-identical to rotate-then-keyswitch
    # (the automorphism does not commute with the tail's integer lifts): the
    # result decrypts alike up to noise, the standard hoisting trade.

    def hoist(self, h: DeviceCkksCiphertext) -> DeviceHoistedCiphertext:
        """Run the keyswitch prefix on h's c1 once."""
        ks = self._ks_ctx(h.level + 1)
        return DeviceHoistedCiphertext(ks._decompose(h.data[1][None]), h.data,
                                       h.level, h.scale)

    def rotate_hoisted(self, hh: DeviceHoistedCiphertext,
                       r: int) -> DeviceCkksCiphertext:
        return self._apply_galois_hoisted(hh, pow(5, r, 2 * self.ctx.n))

    def conjugate_hoisted(self, hh: DeviceHoistedCiphertext) -> DeviceCkksCiphertext:
        return self._apply_galois_hoisted(hh, 2 * self.ctx.n - 1)

    def _apply_galois_hoisted(self, hh: DeviceHoistedCiphertext, g: int):
        ks = self._ks_ctx(hh.level + 1)
        sigma = galois_cuda.ntt_galois_sigma(self.ctx.n, g)
        keys, kp = ks.device_keys(self.ctx._galois_keys_for(g), hoist_perm=sigma)
        index = galois_cuda.galois_index(self.ctx.n, g, self.device)
        out = ks._apply_hoisted(hh.dec, self._base(hh.data[0]), keys, kp,
                                self._msf(ks), index)[0]
        return DeviceCkksCiphertext(out, hh.level, hh.scale)

    def rotate_many(self, h: DeviceCkksCiphertext, steps,
                    fused: bool = True) -> "list[DeviceCkksCiphertext]":
        """Rotate h by every step in `steps`, hoisting the keyswitch prefix
        once.  Step 0 returns h itself.  fused=True runs the distinct
        nontrivial steps as ONE batched hoisted apply (per-step keys stacked,
        in chunks of at most HEXL_TPU_ROT_MANY_MAX_MB of keys, default 256);
        fused=False calls rotate_hoisted per step.  The bits are the same."""
        slots = self.ctx.slots
        nontrivial = [r for r in steps if r % slots != 0]
        hh = self.hoist(h) if nontrivial else None
        if not fused or len(nontrivial) <= 1:
            by_step = {r: self.rotate_hoisted(hh, r) for r in set(nontrivial)}
            return [h if r % slots == 0 else by_step[r] for r in steps]
        ks = self._ks_ctx(h.level + 1)
        uniq = sorted(set(nontrivial))
        keyset_bytes = 2 * 8 * ks.L * ks.comp * ks.K * ks.n  # keys + precons
        max_mb = int(os.environ.get("HEXL_TPU_ROT_MANY_MAX_MB", "256"))
        chunk = max(1, (max_mb << 20) // keyset_bytes)
        by_step = {}
        for c0 in range(0, len(uniq), chunk):
            sub = uniq[c0 : c0 + chunk]
            gs = [pow(5, r, 2 * self.ctx.n) for r in sub]
            outs = self._hoisted_many_data(hh.dec, hh.data[0], ks,
                                           self._hoisted_keys(ks, gs))
            for s, r in enumerate(sub):
                by_step[r] = DeviceCkksCiphertext(outs[s], h.level, h.scale)
        return [h if r % slots == 0 else by_step[r] for r in steps]

    # -- encrypted matrix-vector product (BSGS diagonal method) ---------------

    def _bsgs(self, diagonals, bsgs_n1):
        slots = self.ctx.slots
        diags = {d % slots: np.asarray(v) for d, v in diagonals.items()}
        assert diags, "linear_transform requires at least one diagonal"
        assert all(v.shape == (slots,) for v in diags.values())
        n1 = bsgs_n1 or max(1, int(round(math.sqrt(len(diags)))))
        groups: "dict[int, list[int]]" = {}
        for d in sorted(diags):
            groups.setdefault(d // n1, []).append(d)
        return diags, n1, sorted(groups.items())

    def linear_transform(self, h: DeviceCkksCiphertext, diagonals,
                         bsgs_n1: int | None = None) -> DeviceCkksCiphertext:
        """Encrypted M @ z by the diagonal method with baby-step/giant-step
        rotations (Halevi-Shoup): u_d[i] = M[i, (i+d) % slots] and

            M z = sum_j rot_{j*n1}( sum_i roll(u_{j*n1+i}, j*n1) * rot_i(z) )

        The baby rotations come from one hoisted decomposition (rotate_many);
        each giant step is a full rotation.  Output scale h.scale * ctx.scale:
        rescale afterwards."""
        diags, n1, group_list = self._bsgs(diagonals, bsgs_n1)
        slots = self.ctx.slots
        baby_needed = sorted({d % n1 for d in diags})
        baby = dict(zip(baby_needed, self.rotate_many(h, baby_needed)))
        out = None
        for j, ds in group_list:
            inner = None
            for d in ds:
                term = self.multiply_plain(baby[d % n1], np.roll(diags[d], j * n1))
                inner = term if inner is None else self.add(inner, term)
            if j:
                inner = self.rotate(inner, (j * n1) % slots)
            out = inner if out is None else self.add(out, inner)
        return out

    def linear_transform_fused(self, h: DeviceCkksCiphertext, diagonals,
                               bsgs_n1: int | None = None,
                               return_program: bool = False):
        """linear_transform as ONE function of the ciphertext tensor, every
        key, permutation and diagonal staged first: the hoisted
        decomposition, all baby rotations in one batched apply, the
        plaintext products, the group sums, the giant-step rotations and the
        final sum.  The same operations in the same order as
        linear_transform, so the same bits.

        return_program=True also returns a GraphProgram: a callable
        of the (2, nl, n) tensor that, on CUDA, replays one captured
        torch.cuda.CUDAGraph of the whole product (the counterpart of the
        reference's one jitted program); `.eager` runs the composition
        launch by launch."""
        diags, n1, group_list = self._bsgs(diagonals, bsgs_n1)
        slots, n = self.ctx.slots, self.ctx.n
        nl = h.level + 1
        ks = self._ks_ctx(nl)
        baby_rot = sorted({d % n1 for d in diags} - {0})
        baby_staged = (self._hoisted_keys(ks, [pow(5, r, 2 * n) for r in baby_rot])
                       if baby_rot else None)
        # every tensor the program reads is staged here and held by run's
        # closure: a captured graph replays raw pointers, and the caches
        # these come from may evict and free theirs
        giant = {j: self._galois_staged(ks, pow(5, (j * n1) % slots, 2 * n))
                 for j, _ in group_list if j}
        meta = self._mul_meta(nl)
        planes = [
            torch.stack([
                self._plain_planes(self.ctx.encode(np.roll(diags[d], j * n1)), nl)
                for d in ds
            ])
            for j, ds in group_list
        ]                                             # per group (len(ds), nl, n)

        def run(x: torch.Tensor) -> torch.Tensor:
            babies = {0: x}
            if baby_rot:
                outs = self._hoisted_many_data(ks._decompose(x[1][None]), x[0],
                                               ks, baby_staged)
                babies.update(zip(baby_rot, outs))
            acc = None
            for (j, ds), p in zip(group_list, planes):
                inner = None
                for di, d in enumerate(ds):
                    term = self._mul_plain_data(babies[d % n1], p[di], meta)
                    inner = term if inner is None else self._addsub_data(inner, term, False)
                if j:
                    inner = self._galois_data(inner, giant[j])
                acc = inner if acc is None else self._addsub_data(acc, inner, False)
            return acc

        out = DeviceCkksCiphertext(run(h.data), h.level, h.scale * self.ctx.scale)
        if return_program:
            return out, GraphProgram(run, h.data)
        return out
