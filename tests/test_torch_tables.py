"""The port's own copies of nt / twiddles / golden equal the reference's,
element for element."""

import numpy as np
import pytest

from hexl_fpga_tpu.ops import golden as jgolden, nt as jnt, twiddles as jtw
from hexl_fpga_tpu.utils import vectors as jvectors
from hexl_fpga_tpu_torch.ops import golden, nt, twiddles
from hexl_fpga_tpu_torch.utils import vectors


@pytest.mark.parametrize("bits,n", [(20, 64), (30, 1024), (45, 1024), (52, 2048), (61, 256)])
def test_nt_matches(bits, n):
    assert nt.generate_primes(3, bits, n) == jnt.generate_primes(3, bits, n)
    q = nt.generate_primes(1, bits, n)[0]
    assert nt.minimal_primitive_root(2 * n, q) == jnt.minimal_primitive_root(2 * n, q)
    assert nt.barrett_factor(1, 64, q) == jnt.barrett_factor(1, 64, q) == (1 << 64) // q
    assert nt.precompute_modulus_k(q) == jnt.precompute_modulus_k(q)
    assert nt.rk_factor(q) == jnt.rk_factor(q)
    assert nt.inverse_mod(n, q) == jnt.inverse_mod(n, q)
    assert [nt.reverse_bits(i, 10) for i in range(1024)] == [
        jnt.reverse_bits(i, 10) for i in range(1024)]
    assert nt.is_prime(q) and not nt.is_prime(q + 2 * n) == (not jnt.is_prime(q + 2 * n))


@pytest.mark.parametrize("bits,n", [(30, 256), (45, 1024), (52, 2048)])
def test_ntt_tables_match(bits, n):
    q = nt.generate_primes(1, bits, n)[0]
    a, b = twiddles.ntt_tables(n, q), jtw.ntt_tables(n, q)
    for f in ("fwd", "fwd_precon", "inv", "inv_precon"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert (a.w, a.inv_n, a.inv_n_w) == (b.w, b.inv_n, b.inv_n_w)
    # psi override
    psi = (a.w * a.w * a.w) % q
    a, b = twiddles.ntt_tables(n, q, psi), jtw.ntt_tables(n, q, psi)
    np.testing.assert_array_equal(a.fwd, b.fwd)
    np.testing.assert_array_equal(a.inv_precon, b.inv_precon)


def test_keyswitch_twiddles_match():
    n = 1024
    moduli = nt.generate_primes(3, 45, n)
    buf = twiddles.keyswitch_twiddles(n, moduli)
    np.testing.assert_array_equal(buf, jtw.keyswitch_twiddles(n, moduli))
    a = twiddles.decode_keyswitch_twiddles(buf, n, 3)
    b = jtw.decode_keyswitch_twiddles(buf, n, 3)
    for f in ("inv", "inv_precon", "fwd", "fwd_precon"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    # the 2n-th root sits at bit_reverse(1) of the forward table
    for j, q in enumerate(moduli):
        assert int(a.fwd[j][n // 2]) == nt.minimal_primitive_root(2 * n, q)


@pytest.mark.parametrize("bits", [30, 50, 61])
def test_golden_ntt_matches(bits):
    n = 512
    q = nt.generate_primes(1, bits, n)[0]
    rng = np.random.default_rng(bits)
    a = rng.integers(0, q, size=(3, n), dtype=np.uint64)
    f = golden.fwd_ntt(a, q)
    np.testing.assert_array_equal(f, jgolden.fwd_ntt(a, q))
    np.testing.assert_array_equal(golden.inv_ntt(f, q), a)
    np.testing.assert_array_equal(golden.inv_ntt(a, q), jgolden.inv_ntt(a, q))
    y = rng.integers(0, q, size=n, dtype=np.uint64)
    np.testing.assert_array_equal(golden.mul_mod(a[0], y, q), jgolden.mul_mod(a[0], y, q))
    x = rng.integers(0, 1 << 62, size=n, dtype=np.uint64)
    np.testing.assert_array_equal(golden.barrett_reduce64(x, q), x % np.uint64(q))


@pytest.mark.parametrize("name", ["1024_2_3_3_2_0", "1024_2_3_3_2_1"])
def test_golden_keyswitch_and_vector_io_match(name, tmp_path):
    path = f"tests/testdata/{name}.json"
    import os

    path = os.path.join(os.path.dirname(__file__), "testdata", f"{name}.json")
    v, jv = vectors.load_json(path), jvectors.load_json(path)
    for f in ("twiddle_factors", "t_target_iter_ptr", "input", "expected_output"):
        np.testing.assert_array_equal(getattr(v, f), getattr(jv, f))
    assert v.moduli == jv.moduli and v.config_name == jv.config_name
    args = (v.input, v.t_target_iter_ptr, v.coeff_count, v.decomp_modulus_size,
            v.key_modulus_size, v.rns_modulus_size, 2, v.moduli, v.key_vectors,
            v.modswitch_factors)
    out = golden.keyswitch(*args, v.twiddle_factors)
    np.testing.assert_array_equal(out, v.expected_output)
    np.testing.assert_array_equal(out, jgolden.keyswitch(*args, jv.twiddle_factors))
    # save/load round trip, gz included
    gz = str(tmp_path / "v.json.gz")
    vectors.save_json(v, gz)
    back = vectors.load_json(gz)
    np.testing.assert_array_equal(back.expected_output, v.expected_output)
    np.testing.assert_array_equal(back.key_vectors[1], v.key_vectors[1])


def test_make_keyswitch_vector_matches():
    a = vectors.make_keyswitch_vector(64, 2, 3, seed=4, modulus_bits=30)
    b = jvectors.make_keyswitch_vector(64, 2, 3, seed=4, modulus_bits=30)
    np.testing.assert_array_equal(a.expected_output, b.expected_output)
    np.testing.assert_array_equal(a.key_vectors[0], b.key_vectors[0])
    assert a.modswitch_factors == b.modswitch_factors
