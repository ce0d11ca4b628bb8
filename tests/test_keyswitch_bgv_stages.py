"""The stages only BGV adds to the n=1024 KeySwitch device context, eagerly.

`test_keyswitch_bgv.py::test_device_bgv_matches_golden_{fused,unfused}` run
the whole interpret-mode program on its BGV vector; the fused one runs for
over 40 minutes on 8 CPU cores.  There is no smaller n for the context
(`ntt_mxu_pallas._pick_n1` needs n >= 1024), so this file holds the BGV
stages alone on the same vector, in seconds: `_sigma` on an INTT2 output and
`_tail_j` for every decomp modulus.  The stages BGV shares with CKKS (engines,
MAC, INTT) are covered end to end at n=1024 by `test_keyswitch_tpu.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from hexl_fpga_tpu.ops import golden, keyswitch_tpu, nt, word64 as jw
from hexl_fpga_tpu.utils import vectors

T = 65537  # BGV plaintext modulus, as in test_keyswitch_bgv.py


@pytest.fixture(scope="module")
def bgv_vec():
    """test_keyswitch_bgv.py's n=1024 BGV vector, same shape and seed."""
    return vectors.make_keyswitch_vector(
        1024, 2, 3, seed=11, modulus_bits=45, plain_modulus=T,
    )


@pytest.mark.parametrize("fused_tail", [True, False])
def test_device_bgv_sigma_and_tail(bgv_vec, fused_tail):
    """`_sigma` on an INTT2 output e (canonical under q_k) and `_tail_j` for
    every decomp modulus, held bit-exactly against Python integers and
    golden.fwd_ntt; the two cases together hold the fused Pallas tail and
    the XLA-composition tail to the same values."""
    vec = bgv_vec
    n, L, comp, B = 1024, 2, 2, 2
    ctx = keyswitch_tpu.KeySwitchTpuContext(
        n, L, 3, 3, comp, vec.moduli, vec.twiddle_factors,
        tile_p=2, interpret=True, plain_modulus=T, fused_tail=fused_tail,
    )
    qk, qk_half, t_half = ctx.qk, ctx.qk >> 1, T >> 1
    rng = np.random.default_rng(57)
    e = rng.integers(0, qk, size=(comp * B, n), dtype=np.uint64)
    # sigma's borders: e = 0, qk/2 - 1, qk/2, qk/2 + 1, qk - 1
    e[0, :5] = [0, qk_half - 1, qk_half, qk_half + 1, qk - 1]
    # lazy MAC sums (< 28q, `_mac_term`) and canonical caller rows, per q_j
    acc = [rng.integers(0, 28 * q, size=(comp, B, n), dtype=np.uint64)
           for q in vec.moduli[:L]]
    res = [rng.integers(0, q, size=(comp, B, n), dtype=np.uint64)
           for q in vec.moduli[:L]]

    def pair(a):
        return tuple(jnp.asarray(p) for p in jw.to_pair_np(a))

    def rows(a):
        return [pair(a[k]) for k in range(comp)]

    sigma = ctx._sigma(pair(e))
    got_sigma = jw.from_pair_np(*sigma)
    inv_qk_t = nt.inverse_mod(qk % T, T)
    e_int = e.astype(object)
    want_sigma = ((qk_half - e_int) * inv_qk_t + t_half) % T
    np.testing.assert_array_equal(got_sigma.astype(object), want_sigma)
    # d' = [d]_qk + qk*u' with u' = sigma - t/2, the value the tail
    # subtracts, is divisible by t (as the keyswitch noise is)
    d_prime = (e_int - qk_half) + qk * (want_sigma - t_half)
    assert all(int(x) % T == 0 for x in d_prime.ravel())

    msf4 = jnp.asarray(ctx.prepare_msf4(vec.modswitch_factors))
    for j in range(L):
        q = vec.moduli[j]
        outs = ctx._tail_j(j, pair(e), rows(acc[j]), rows(res[j]), msf4, sigma)
        got = np.stack([jw.from_pair_np(*o) for o in outs])
        # golden.keyswitch's BGV tail on the same operands, in Python ints
        f = (d_prime % q).astype(np.uint64)
        g = golden.fwd_ntt(f, q).astype(object).reshape(comp, B, n)
        msf = int(vec.modswitch_factors[j]) % q
        delta = ((acc[j].astype(object) % q + q - g) * msf) % q
        want = (res[j].astype(object) + delta) % q
        np.testing.assert_array_equal(got.astype(object), want,
                                      err_msg=f"j={j}")
