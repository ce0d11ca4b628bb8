"""Exact (bit-exact) software golden models, vectorized in numpy.

These mirror the reference's software oracle and decoded device semantics:

* fwd/inv negacyclic NTT: `tests/test_utils/ntt.cpp`
  ForwardTransformToBitReverse64 / InverseTransformFromBitReverse64
  (Harvey lazy butterflies, 64-bit Barrett preconditioning).
* keyswitch: the dataflow of `device/keyswitch/*.hpp` decoded in SURVEY.md §3.3
  (INTT1 -> Barrett-reduce into each RNS modulus -> NTT -> MAC over decomp
  with switch keys -> INTT2 under the special modulus -> +qk/2 centering fix ->
  reduce -> NTT -> modswitch multiply), plus the host-side accumulate of
  `host/src/fpga.cpp` FPGAObject_KeySwitch::fill_out_data.

All arithmetic is exact: u64 numpy ops with explicit 128-bit handling via
32-bit limb splits; arbitrary-modulus paths fall back to object (bignum)
arrays.  The torch and CUDA implementations are tested against this module;
it is the backend of RUN_CHOICE=0.
"""

from __future__ import annotations

import numpy as np

from . import nt, twiddles

_M32 = np.uint64(0xFFFFFFFF)
_S32 = np.uint64(32)


def _u64(a) -> np.ndarray:
    return np.asarray(a, dtype=np.uint64)


def mulhi64(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """High 64 bits of the 128-bit product, exactly (32-bit limb split)."""
    a = _u64(a)
    b = _u64(b)
    a0 = a & _M32
    a1 = a >> _S32
    b0 = b & _M32
    b1 = b >> _S32
    p00 = a0 * b0
    p01 = a0 * b1
    p10 = a1 * b0
    p11 = a1 * b1
    mid = (p00 >> _S32) + (p01 & _M32) + (p10 & _M32)
    return p11 + (p01 >> _S32) + (p10 >> _S32) + (mid >> _S32)


def mullo64(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        return _u64(a) * _u64(b)


def mul_mod_lazy64(x: np.ndarray, y_op, y_precon, q: int) -> np.ndarray:
    """(x * y_op) mod q with result in [0, 2q).

    The Harvey lazy multiply, MultiplyUIntModLazy<64>
    (`tests/test_utils/ntt.hpp:86-101`): Q = mulhi64(x, y_precon);
    return y_op * x - Q * q  (low 64 bits)."""
    x = _u64(x)
    Q = mulhi64(x, y_precon)
    with np.errstate(over="ignore"):
        return mullo64(y_op, x) - mullo64(Q, np.uint64(q))


def barrett_reduce64(x: np.ndarray, q: int, q_barr: int | None = None) -> np.ndarray:
    """x mod q for x < 2^63-ish, via 64-bit Barrett (reference BarrettReduce64,
    `device/mod_ops.hpp:213-217`). Exact full reduction."""
    if q_barr is None:
        q_barr = nt.barrett_factor(1, 64, q)
    x = _u64(x)
    Qhat = mulhi64(x, np.uint64(q_barr))
    with np.errstate(over="ignore"):
        r = x - mullo64(Qhat, np.uint64(q))
    return np.where(r >= np.uint64(q), r - np.uint64(q), r)


def mul_mod(x: np.ndarray, y, q: int) -> np.ndarray:
    """(x * y) mod q exactly for x, y < q < 2^62 (lazy multiply + reduce)."""
    y = _u64(y)
    # dtype MUST be forced: numpy 2 promotes a python-int list holding any
    # value >= 2^63 (every precon of y >= q/2) to float64, silently rounding
    # the precon to 53 bits — the Harvey quotient then lands off by one for
    # unlucky operands and the result is wrong by +-q, past the single
    # conditional subtract (caught by the BEHZ property tests, which drive
    # mul_mod with arbitrary array multiplicands)
    y_precon = np.array(
        [nt.barrett_factor(int(v) % q, 64, q) for v in np.atleast_1d(y)],
        dtype=np.uint64,
    ).reshape(np.shape(y))
    r = mul_mod_lazy64(x, y, y_precon, q)
    return np.where(r >= np.uint64(q), r - np.uint64(q), r)


# ---------------------------------------------------------------------------
# NTT / INTT golden models
# ---------------------------------------------------------------------------


def fwd_ntt(
    a,
    q: int,
    tables: twiddles.NttTables | None = None,
    input_mod_factor: int = 1,
    output_mod_factor: int = 1,
) -> np.ndarray:
    """Forward negacyclic NTT, output bit-reversed; exact HEXL semantics
    (ForwardTransformToBitReverse64, `tests/test_utils/ntt.cpp:464-548`).

    a: (..., n) uint64, values < input_mod_factor * q.  Returns same shape.
    """
    a = _u64(a)
    n = a.shape[-1]
    if tables is None:
        tables = twiddles.ntt_tables(n, q)
    assert tables.n == n and tables.q == q
    batch_shape = a.shape[:-1]
    x = a.reshape(-1, n).copy()
    twice_q = np.uint64(2 * q)
    fwd = tables.fwd
    fwd_precon = tables.fwd_precon

    t = n >> 1
    m = 1
    while m < n:
        v = x.reshape(-1, m, 2, t)
        X = v[:, :, 0, :]
        Y = v[:, :, 1, :]
        W = fwd[m : 2 * m].reshape(1, m, 1)
        Wp = fwd_precon[m : 2 * m].reshape(1, m, 1)
        tx = np.where(X >= twice_q, X - twice_q, X)
        T = mul_mod_lazy64(Y, W, Wp, q)
        with np.errstate(over="ignore"):
            v[:, :, 0, :] = tx + T
            v[:, :, 1, :] = tx + twice_q - T
        m <<= 1
        t >>= 1

    if output_mod_factor == 1:
        x = np.where(x >= twice_q, x - twice_q, x)
        x = np.where(x >= np.uint64(q), x - np.uint64(q), x)
    return x.reshape(*batch_shape, n)


def inv_ntt(
    a,
    q: int,
    tables: twiddles.NttTables | None = None,
    input_mod_factor: int = 1,
    output_mod_factor: int = 1,
) -> np.ndarray:
    """Inverse negacyclic NTT from bit-reversed input, including the n^{-1}
    normalization; exact HEXL semantics (InverseTransformFromBitReverse64,
    `tests/test_utils/ntt.cpp:580-660`)."""
    a = _u64(a)
    n = a.shape[-1]
    if tables is None:
        tables = twiddles.ntt_tables(n, q)
    assert tables.n == n and tables.q == q
    batch_shape = a.shape[:-1]
    x = a.reshape(-1, n).copy()
    twice_q = np.uint64(2 * q)
    inv = tables.inv
    inv_precon = tables.inv_precon

    t = 1
    root_index = 1
    m = n >> 1
    while m > 1:
        v = x.reshape(-1, m, 2, t)
        X = v[:, :, 0, :].copy()
        Y = v[:, :, 1, :]
        W = inv[root_index : root_index + m].reshape(1, m, 1)
        Wp = inv_precon[root_index : root_index + m].reshape(1, m, 1)
        root_index += m
        with np.errstate(over="ignore"):
            tx = X + Y
            ty = X + twice_q - Y
        v[:, :, 0, :] = np.where(tx >= twice_q, tx - twice_q, tx)
        v[:, :, 1, :] = mul_mod_lazy64(ty, W, Wp, q)
        t <<= 1
        m >>= 1

    # Fused final stage: multiply the X half by n^{-1} and the Y half by
    # n^{-1} * W_last (golden model `ntt.cpp:629-646`).
    inv_n = np.uint64(tables.inv_n)
    inv_n_w = np.uint64(tables.inv_n_w)
    inv_n_precon = np.uint64(nt.barrett_factor(tables.inv_n, 64, q))
    inv_n_w_precon = np.uint64(nt.barrett_factor(tables.inv_n_w, 64, q))
    h = n >> 1
    X = x[:, :h].copy()
    Y = x[:, h:].copy()
    with np.errstate(over="ignore"):
        tx = X + Y
        ty = X + twice_q - Y
    tx = np.where(tx >= twice_q, tx - twice_q, tx)
    x[:, :h] = mul_mod_lazy64(tx, inv_n, inv_n_precon, q)
    x[:, h:] = mul_mod_lazy64(ty, inv_n_w, inv_n_w_precon, q)

    if output_mod_factor == 1:
        x = np.where(x >= np.uint64(q), x - np.uint64(q), x)
    return x.reshape(*batch_shape, n)


# ---------------------------------------------------------------------------
# Dyadic multiply golden model
# ---------------------------------------------------------------------------


def dyadic_multiply(op1, op2, n: int, moduli, n_moduli: int) -> np.ndarray:
    """Ciphertext x ciphertext dyadic product (2x2 -> 3 polys per modulus).

    Layouts follow the public API (`host/inc/hexl-fpga.h:41-43`, oracle at
    `tests/test_dyadic_multiply.cpp:32-109`):
      op:  [2][n_moduli][n]  (poly0 for all moduli, then poly1)
      out: [3][n_moduli][n]  (x0*y0, x0*y1 + x1*y0, x1*y1), each mod moduli[m].
    Moduli are arbitrary word-sized integers (not necessarily prime), so the
    golden path uses bignum object arrays."""
    op1 = _u64(op1).reshape(2, n_moduli, n).astype(object)
    op2 = _u64(op2).reshape(2, n_moduli, n).astype(object)
    q = np.asarray(list(map(int, moduli)), dtype=object)[:n_moduli].reshape(n_moduli, 1)
    out = np.empty((3, n_moduli, n), dtype=object)
    out[0] = (op1[0] * op2[0]) % q
    out[1] = (op1[0] * op2[1] + op1[1] * op2[0]) % q
    out[2] = (op1[1] * op2[1]) % q
    return out.astype(np.uint64).reshape(-1)


# ---------------------------------------------------------------------------
# KeySwitch golden model
# ---------------------------------------------------------------------------


def keyswitch(
    result,
    t_target,
    n: int,
    decomp_modulus_size: int,
    key_modulus_size: int,
    rns_modulus_size: int,
    key_component_count: int,
    moduli,
    k_switch_keys,
    modswitch_factors,
    twiddle_factors=None,
    plain_modulus: int | None = None,
) -> np.ndarray:
    """One KeySwitch op, bit-exact with the reference device dataflow.

    Arguments mirror `intel::hexl::KeySwitch` (`host/inc/hexl-fpga.h:75-80`):
      result:   [key_component_count][decomp][n] accumulated in place (returned)
      t_target: [decomp][n], NTT form under moduli[i]
      k_switch_keys: list of decomp arrays, each [2*key_modulus_size*n]
        (component-major: [comp][key_modulus][n]), NTT form under moduli[j]
      modswitch_factors: [key_modulus_size] (q_special^{-1} mod q_i, possibly
        unreduced; reduced with ReduceMod8 semantics as in build_modulus_meta)
      twiddle_factors: optional caller table in the keyswitch host layout
        (key_modulus_size x [inv, precon_inv, fwd, precon_fwd] x n).
      plain_modulus: optional BGV plaintext modulus t.  The reference's tail
        (`device/keyswitch/ms.hpp:27-84`) subtracts the CENTERED residue
        [d]_qk before the q_k^{-1} multiply — correct for CKKS/BFV, where the
        division error lands in the noise.  BGV keeps its message in the LSB
        mod t, so the subtracted value must ALSO be divisible by t: with
        d' = [d]_qk + qk*u', u' = [-[d]_qk * qk^{-1}]_t centered, (acc - d')
        is divisible by qk AND d' == 0 (mod t), so the switched ciphertext
        stays exact mod t (Gentry-Halevi-Smart correction; requires
        gcd(qk, t) == 1 and key errors scaled by t).
    """
    # rns_modulus_size is validated (>0) and stored by the reference but
    # never reaches its computation: the host uses it only in the batch
    # fence (`host/src/fpga_int.cpp:443`), and the device kernel launches
    # pass n / decomp_modulus_size / modulus_meta only
    # (`host/src/fpga.cpp:1296-1301,1560-1565`; no `rns` symbol exists
    # under device/).  Match that: accept any positive value, compute
    # independently of it.
    assert rns_modulus_size > 0, "requires rns_modulus_size > 0"
    assert key_modulus_size > decomp_modulus_size
    moduli = [int(m) for m in moduli]
    qk = moduli[key_modulus_size - 1]
    qk_half = qk >> 1
    t_target = _u64(t_target).reshape(decomp_modulus_size, n)
    result = _u64(result).reshape(key_component_count, decomp_modulus_size, n).copy()

    # Tables: from the caller's twiddle buffer if given, else computed
    # (Device::KeySwitch_load_twiddles fallback).
    tabs = []
    if twiddle_factors is not None:
        view = twiddles.decode_keyswitch_twiddles(twiddle_factors, n, key_modulus_size)
        for j in range(key_modulus_size):
            q = moduli[j]
            # Rebuild golden-layout tables from the keyswitch layout: the inv
            # table gains back its leading 1.
            inv = np.empty(n, dtype=np.uint64)
            inv[0] = 1
            inv[1:] = view.inv[j][: n - 1]
            inv_precon = np.empty(n, dtype=np.uint64)
            inv_precon[0] = nt.barrett_factor(1, 64, q)
            inv_precon[1:] = view.inv_precon[j][: n - 1]
            inv_n = nt.inverse_mod(n, q)
            tabs.append(
                twiddles.NttTables(
                    n=n,
                    q=q,
                    w=int(view.fwd[j][1]) if n > 1 else 1,
                    fwd=view.fwd[j].copy(),
                    fwd_precon=view.fwd_precon[j].copy(),
                    inv=inv,
                    inv_precon=inv_precon,
                    inv_n=inv_n,
                    inv_n_w=(inv_n * int(inv[n - 1])) % q,
                )
            )
    else:
        tabs = [twiddles.ntt_tables(n, moduli[j]) for j in range(key_modulus_size)]

    # INTT1: take each decomp poly out of NTT form under its own modulus
    # (`device/keyswitch/intt1.hpp`, normalize by n^{-1}).
    coeff = np.stack(
        [inv_ntt(t_target[i], moduli[i], tabs[i]) for i in range(decomp_modulus_size)]
    )  # (decomp, n), canonical

    # Engines: 0..decomp-1 over moduli[j], plus the special engine
    # key_modulus_size-1 (`device/keyswitch/dyadmult.hpp:144-146` valid_engine).
    engines = list(range(decomp_modulus_size)) + [key_modulus_size - 1]
    acc = {}  # engine j -> (key_component, n) object array accumulator
    for j in engines:
        q = moduli[j]
        acc_j = np.zeros((key_component_count, n), dtype=object)
        for i in range(decomp_modulus_size):
            # intt1_redu: Barrett-reduce coeff (< q_i) into q_j
            # (`device/keyswitch/intt1_redu.hpp:30-46`).
            red = barrett_reduce64(coeff[i], q)
            # NTT under q_j (`device/keyswitch/ntt_core.hpp`), canonical output.
            val = fwd_ntt(red, q, tabs[j])
            keys_i = _u64(k_switch_keys[i]).reshape(key_component_count, key_modulus_size, n)
            for k in range(key_component_count):
                acc_j[k] = (acc_j[k] + val.astype(object) * keys_i[k][j].astype(object)) % q
        acc[j] = acc_j

    # Special-modulus tail per component (`intt2_core.hpp`, `intt2_redu.hpp`,
    # `ms.hpp`): INTT under qk, center by +qk/2, reduce into each q_i, NTT,
    # subtract from the q_i accumulator, multiply by the reduced modswitch
    # factor.
    if plain_modulus is not None:
        t = int(plain_modulus)
        assert t >= 2
        from math import gcd

        assert gcd(qk, t) == 1, "special modulus must be coprime to t"
        inv_qk_t = nt.inverse_mod(qk % t, t)
        t_half = t >> 1
    for k in range(key_component_count):
        d = inv_ntt(acc[key_modulus_size - 1][k].astype(np.uint64), qk, tabs[key_modulus_size - 1])
        e = (d.astype(object) + qk_half) % qk  # AddUIntMod(val, qk_half, qk)
        if plain_modulus is not None:
            # sigma = [u + t/2]_t with u = [(qk_half - e) * qk^{-1}]_t, so
            # u' = sigma - t_half is the centered correction digit and
            # d' = (e - qk_half) + qk*u' is == d (mod qk) and == 0 (mod t).
            sigma = ((qk_half - e) * inv_qk_t + t_half) % t
        for i in range(decomp_modulus_size):
            q = moduli[i]
            fix = q - (qk_half % q)
            if plain_modulus is None:
                f = ((e + fix) % q).astype(np.uint64)
            else:
                fix_bgv = (-qk_half - qk * t_half) % q
                f = ((e + fix_bgv + sigma * (qk % q)) % q).astype(np.uint64)
            g = fwd_ntt(f, q, tabs[i])
            msf = int(modswitch_factors[i]) % q  # ReduceMod<8> semantics
            out = ((acc[i][k] + q - g.astype(object)) * msf) % q
            # Host accumulate: result += out; single conditional subtract
            # (`host/src/fpga.cpp` FPGAObject_KeySwitch::fill_out_data).
            with np.errstate(over="ignore"):
                r = result[k, i] + out.astype(np.uint64)
            result[k, i] = np.where(r >= np.uint64(q), r - np.uint64(q), r)

    return result.reshape(-1)
