"""Twiddle-factor tables for the negacyclic NTT family.

Reproduces, bit for bit, the two table layouts the reference uses:

* The *golden* layout of `tests/test_utils/ntt.cpp::ComputeRootOfUnityPowers`:
  - ``root_of_unity_powers[bit_reverse(i)] = w^i`` (w = minimal 2N-th root),
  - ``inv_root_of_unity_powers``: element 0 is 1, then the scan
    ``inv_pre[m + i]`` for m = N/2, N/4, ..., 1 (N elements total).

* The *keyswitch host* layout of `host/src/twiddle-factors.cpp:16-63`
  (``ComputeRootOfUnityPowers``): identical forward table; the inverse table
  drops the leading 1 (scan starts filling at index 0) and zeroes index N-1.
  Four tables per modulus, concatenated per modulus in the order
  [inv, precon64_inv, fwd, precon64_fwd] (`host/src/fpga.cpp`
  Device::KeySwitch_load_twiddles).

All tables are returned as numpy uint64 arrays; precon tables hold the 64-bit
Barrett factors floor(W << 64 / q).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np

from . import nt


class NttTables(NamedTuple):
    """Golden-layout tables for one (n, q)."""

    n: int
    q: int
    w: int  # the 2n-th root of unity used
    fwd: np.ndarray  # root_of_unity_powers, bit-reversed order, len n
    fwd_precon: np.ndarray  # floor(fwd << 64 / q), len n
    inv: np.ndarray  # inv_root_of_unity_powers, scan order (leading 1), len n
    inv_precon: np.ndarray  # floor(inv << 64 / q), len n
    inv_n: int  # n^{-1} mod q
    inv_n_w: int  # n^{-1} * inv[n-1] mod q (the golden model's fused last twiddle)


def _bit_reverse_perm(n: int) -> np.ndarray:
    bits = nt.log2_exact(n)
    return np.array([nt.reverse_bits(i, bits) for i in range(n)], dtype=np.int64)


@functools.lru_cache(maxsize=None)
def _tables_cached(n: int, q: int, w: int) -> NttTables:
    bits = nt.log2_exact(n)
    # fwd[bit_reverse(i)] = w^i
    fwd = [0] * n
    for i in range(n):
        fwd[nt.reverse_bits(i, bits)] = pow(w, i, q)
    # inv_pre[j] = fwd[j]^{-1} mod q
    inv_pre = [nt.inverse_mod(v, q) for v in fwd]
    # golden scan order: temp[0] = inv_pre[0] (== 1), then m = n/2 .. 1
    inv = [inv_pre[0]]
    m = n >> 1
    while m > 0:
        inv.extend(inv_pre[m : 2 * m])
        m >>= 1
    assert len(inv) == n
    fwd_precon = [nt.barrett_factor(v, 64, q) for v in fwd]
    inv_precon = [nt.barrett_factor(v, 64, q) for v in inv]
    inv_n = nt.inverse_mod(n, q)
    inv_n_w = (inv_n * inv[n - 1]) % q
    return NttTables(
        n=n,
        q=q,
        w=w,
        fwd=np.array(fwd, dtype=np.uint64),
        fwd_precon=np.array(fwd_precon, dtype=np.uint64),
        inv=np.array(inv, dtype=np.uint64),
        inv_precon=np.array(inv_precon, dtype=np.uint64),
        inv_n=inv_n,
        inv_n_w=inv_n_w,
    )


def ntt_tables(n: int, q: int, w: int | None = None) -> NttTables:
    """Golden-layout twiddle tables for (n, q); w defaults to the minimal
    primitive 2n-th root of unity (canonical)."""
    if w is None:
        w = nt.minimal_primitive_root(2 * n, q)
    return _tables_cached(n, q, w)


def keyswitch_twiddles_one_modulus(n: int, q: int, w: int | None = None) -> np.ndarray:
    """The 4n-entry per-modulus block in the keyswitch host layout
    [inv, precon64_inv, fwd, precon64_fwd] (`host/src/twiddle-factors.cpp`).

    The inverse tables drop the golden layout's leading 1 and zero slot n-1."""
    t = ntt_tables(n, q, w)
    inv_ks = np.zeros(n, dtype=np.uint64)
    inv_ks[: n - 1] = t.inv[1:]
    inv_precon_ks = np.array(
        [nt.barrett_factor(int(v), 64, q) for v in inv_ks], dtype=np.uint64
    )
    return np.concatenate([inv_ks, inv_precon_ks, t.fwd, t.fwd_precon])


def keyswitch_twiddles(n: int, moduli) -> np.ndarray:
    """Full keyswitch twiddle buffer: key_modulus_size x 4 x n, flattened in the
    reference's per-modulus-block order (Device::KeySwitch_load_twiddles)."""
    return np.concatenate([keyswitch_twiddles_one_modulus(n, int(q)) for q in moduli])


class KeySwitchTwiddleView(NamedTuple):
    """Decoded view of a keyswitch twiddle buffer (caller-supplied or generated).

    inv[k], inv_precon[k], fwd[k], fwd_precon[k] are n-vectors for modulus k."""

    n: int
    inv: np.ndarray  # (K, n)
    inv_precon: np.ndarray
    fwd: np.ndarray
    fwd_precon: np.ndarray


def decode_keyswitch_twiddles(buf: np.ndarray, n: int, key_modulus_size: int) -> KeySwitchTwiddleView:
    buf = np.asarray(buf, dtype=np.uint64).reshape(key_modulus_size, 4, n)
    return KeySwitchTwiddleView(
        n=n,
        inv=buf[:, 0, :],
        inv_precon=buf[:, 1, :],
        fwd=buf[:, 2, :],
        fwd_precon=buf[:, 3, :],
    )
