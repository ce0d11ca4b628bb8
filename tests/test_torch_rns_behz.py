"""The port's host BEHZ tool (`hexl_fpga_tpu_torch/ops/rns_behz.py`) against
the reference's (`hexl_fpga_tpu/ops/rns_behz.py`): the same constants and
auxiliary primes, the same primitives and multiply bit for bit on the same
residues, the same errors.  Shapes of the reference's `tests/test_rns_behz.py`
(n = 32 and 64)."""

import numpy as np
import pytest

from hexl_fpga_tpu.ops import rns_behz as jbehz, twiddles as jtw
from hexl_fpga_tpu_torch.ops import nt, rns_behz, twiddles

# (n, k, q bits, t, aux_bits): the reference's fixture, its end-to-end
# multiply's level, and a wider base with auto-sized Bsk
SHAPES = [(32, 3, 45, 65537, 46), (64, 3, 45, 257, None), (64, 4, 40, 257, None)]

CONSTANTS = [
    "n", "q", "t", "k", "aux_bits", "b", "m_sk", "Bsk", "m_tilde", "q_prod",
    "B_prod", "q_hat", "q_hat_inv", "q_hat_mod_Bsk", "q_hat_mod_mtilde",
    "q_mod_Bsk", "neg_inv_q_mod_mtilde", "inv_mtilde_mod_Bsk", "inv_q_mod_Bsk",
    "b_hat", "b_hat_inv", "b_hat_mod_msk", "b_hat_mod_q", "inv_B_mod_msk",
    "B_mod_q",
]


def tools(n, k, bits, t, aux_bits):
    q = [int(p) for p in nt.generate_primes(k, bits, n)]
    return (rns_behz.BehzTool(n, q, t, aux_bits=aux_bits),
            jbehz.BehzTool(n, q, t, aux_bits=aux_bits))


def residues(tool, seed, rows=1):
    """Random canonical residues (len(base), n) of one integer vector per
    base, as the primitives take them."""
    rng = np.random.default_rng(seed)
    Q = tool.q_prod * 3
    xs = [int(v) % Q for v in rng.integers(0, 1 << 62, size=tool.n)]
    return (np.stack([np.array([x % m for x in xs], dtype=np.uint64) for m in tool.q]),
            np.stack([np.array([x % m for x in xs], dtype=np.uint64) for m in tool.Bsk]))


@pytest.mark.parametrize("shape", SHAPES)
def test_constants_equal_reference(shape):
    P, J = tools(*shape)
    for name in CONSTANTS:
        a, b = getattr(P, name), getattr(J, name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert a == b, name
    for a, b in zip(P.bsk_tables(), J.bsk_tables()):
        assert (a.n, a.q, a.w, a.inv_n, a.inv_n_w) == (b.n, b.q, b.w, b.inv_n, b.inv_n_w)
        for f in ("fwd", "fwd_precon", "inv", "inv_precon"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("shape", SHAPES)
def test_primitives_equal_reference(shape):
    P, J = tools(*shape)
    x_q, x_bsk = residues(P, seed=shape[0] + shape[1])
    for name, args in (
        ("_tilde", (x_q,)),
        ("fastbconv_q_to", (x_q, P.Bsk, P.q_hat_mod_Bsk)),
        ("fastbconv_mtilde", (x_q,)),
        ("extend_to_bsk", (x_q,)),
        ("fast_floor", (x_q, x_bsk)),
        ("fastbconv_sk", (x_bsk,)),
    ):
        got, want = getattr(P, name)(*args), getattr(J, name)(*args)
        assert got.dtype == want.dtype == np.uint64, name
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("shape", SHAPES)
def test_multiply_equals_reference(shape):
    """BehzTool.multiply on random NTT-limb ciphertexts, bit for bit, under
    the level's own twiddle tables."""
    P, J = tools(*shape)
    n = P.n
    rng = np.random.default_rng(7)
    c1, c2 = (np.stack([np.stack([rng.integers(0, q, size=n, dtype=np.uint64)
                                  for q in P.q]) for _ in range(2)])
              for _ in range(2))
    got = P.multiply(c1, c2, [twiddles.ntt_tables(n, q) for q in P.q])
    want = J.multiply(c1, c2, [jtw.ntt_tables(n, q) for q in J.q])
    assert got.shape == (3, P.k, n)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kwargs,match", [
    # 45-bit q at k = 3 under t = 65537 needs Bsk primes of 48 bits or more
    ({"aux_bits": 40}, "range condition"),
    ({"aux_bits": 32}, "aux_bits=32 < 33"),
])
def test_range_condition_raises_as_reference(kwargs, match):
    q = [int(p) for p in nt.generate_primes(3, 45, 32)]
    for mod in (rns_behz, jbehz):
        with pytest.raises(ValueError, match=match):
            mod.BehzTool(32, q, 65537, **kwargs)
