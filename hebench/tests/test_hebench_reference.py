"""The plain reference against the recorded vectors and bignum arithmetic."""

import gzip
import json
import os
import random

import numpy as np
import pytest
import torch

from hebench.reference import arith, dyadic, keyswitch, ntt, primes

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
VECTORS = ["1024_2_3_3_2_0.json", "1024_2_3_3_2_1.json", "2048_3_4_4_2_0.json",
           "1024_5_7_6_2_0.json", "16384_6_7_7_2_0.json.gz"]


def _i64(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, dtype=np.uint64).view(np.int64).copy())


def _load(name):
    path = os.path.join(ROOT, "tests", "testdata", name)
    with (gzip.open if name.endswith(".gz") else open)(path, "rt") as f:
        return json.load(f)


@pytest.mark.parametrize("name", VECTORS)
def test_keyswitch_equals_recorded_vector(name):
    """expected_output of the reference's recorded vectors, bit for bit, with
    each modulus's root read from the vector's own table (fwd[n/2] = psi)."""
    d = _load(name)
    n, L, K = d["coeff_count"], d["decomp_modulus_size"], d["key_modulus_size"]
    psis = [int(d["root_of_unity_powers"][j][n // 2]) for j in range(K)]
    ks = keyswitch.KeySwitch(n, L, K, d["moduli"], psis, d["modswitch_factors"],
                             _i64(d["key_vector"]).view(L, 2, K, n))
    out = ks(_i64(d["t_target_iter_ptr"]).view(1, L, n),
             _i64(d["input"]).view(1, 2, L, n))
    got = out.numpy().view(np.uint64).reshape(-1)
    np.testing.assert_array_equal(got, np.asarray(d["expected_output"], np.uint64))


@pytest.mark.parametrize("bits", [17, 50, 60])
def test_dyadic_equals_bignum(bits):
    """Every product at 17, 50 and 60-bit moduli against Python integers."""
    n, M = 64, 3
    moduli = primes.ntt_primes(M, bits - 1, n)
    rng = random.Random(bits)
    x = [[[rng.randrange(q) for _ in range(n)] for q in moduli] for _ in range(2)]
    y = [[[rng.randrange(q) for _ in range(n)] for q in moduli] for _ in range(2)]
    want = np.zeros((3, M, n), dtype=np.uint64)
    for m, q in enumerate(moduli):
        for i in range(n):
            a0, a1, b0, b1 = x[0][m][i], x[1][m][i], y[0][m][i], y[1][m][i]
            want[:, m, i] = [a0 * b0 % q, (a0 * b1 + a1 * b0) % q, a1 * b1 % q]
    got = dyadic.Dyadic(moduli)(_i64(x)[None], _i64(y)[None])[0]
    np.testing.assert_array_equal(got.numpy().view(np.uint64), want)


@pytest.mark.parametrize("bits", [17, 52, 61])
def test_mul_is_exact_at_the_edges(bits):
    """Montgomery products next to 0 and q - 1, against Python integers."""
    q = primes.ntt_primes(1, bits - 1, 2)[0]
    vals = [0, 1, 2, q // 2, q - 2, q - 1] + [random.Random(q).randrange(q)
                                              for _ in range(26)]
    a = torch.tensor(vals).repeat_interleave(len(vals))
    b = torch.tensor(vals).repeat(len(vals))
    got = arith.Modulus(q).mul(a, b)
    assert got.tolist() == [x * y % q for x, y in zip(a.tolist(), b.tolist())]


def test_ntt_round_trip_and_negacyclic_product():
    """inverse(forward(x)) = x, and the pointwise product of two transforms
    is the transform of the negacyclic product (schoolbook, mod x^n + 1)."""
    n, q = 32, primes.ntt_primes(1, 40, 32)[0]
    t = ntt.Tables(n, q, primes.minimal_root(n, q))
    rng = random.Random(7)
    a, b = ([rng.randrange(q) for _ in range(n)] for _ in range(2))
    fa, fb = ntt.forward(torch.tensor([a]), t), ntt.forward(torch.tensor([b]), t)
    assert ntt.inverse(fa, t)[0].tolist() == a
    prod = [0] * n
    for i in range(n):
        for j in range(n):
            k, s = (i + j) % n, 1 if i + j < n else -1
            prod[k] = (prod[k] + s * a[i] * b[j]) % q
    assert ntt.inverse(t.mod.mul(fa, fb), t)[0].tolist() == prod


def test_minimal_root_is_the_least_primitive_root():
    n, q = 16, primes.ntt_primes(1, 20, 16)[0]
    roots = [g for g in range(1, q) if pow(g, n, q) == q - 1]
    assert primes.minimal_root(n, q) == min(roots)


def test_configuration_moduli_are_the_stated_ones(spec):
    """Each configuration's moduli are primes = 1 mod 2n; the dyadic ones
    are the stated search's result."""
    for c in spec["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        for q in cfg["moduli"]:
            assert primes.is_prime(q) and q % (2 * cfg["n"]) == 1
        if cfg["op"] == "dyadic_multiply":
            assert cfg["moduli"] == primes.ntt_primes(
                cfg["n_moduli"], cfg["modulus_bits"], cfg["n"])
    d = _load("16384_6_7_7_2_0.json.gz")
    with open(os.path.join(ROOT, "hebench/configs/ks16384_6_7_7_2.json")) as f:
        assert json.load(f)["moduli"] == d["moduli"]


def test_control_misses():
    """The float64 control differs from the exact reference."""
    moduli = primes.ntt_primes(2, 50, 64)
    x = torch.randint(0, moduli[0], (1, 2, 2, 64))
    exact = dyadic.Dyadic(moduli)(x, x)
    control = dyadic.Dyadic(moduli, mode="float64")(x, x)
    assert (exact != control).float().mean() > 0.9
