"""Number-theory utilities (host-side precompute).

The port's own copy of the host number theory layer of the reference
(`host/inc/number_theory_util.h:44-225`,
`host/src/number_theory_util.cpp`: InverseUIntMod, PowMod,
MinimalPrimitiveRoot, GeneratePrimes, MultiplyFactor/BarrettFactor,
ReverseBitsUInt, IsPrime).  Everything here runs at op-setup time on the host,
so plain Python integers (arbitrary precision) are used for exactness; the
device-side kernels consume the precomputed tables.
"""

from __future__ import annotations

import functools
import random
from typing import List

MAX_MODULUS_BITS = 52
U64 = (1 << 64) - 1


def is_power_of_two(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def log2_exact(n: int) -> int:
    assert is_power_of_two(n), f"{n} is not a power of two"
    return n.bit_length() - 1


def reverse_bits(x: int, bit_width: int) -> int:
    """Bit-reverse the low `bit_width` bits of x.

    Mirrors ReverseBitsUInt (`number_theory_util.cpp`)."""
    if bit_width == 0:
        return 0
    rev = 0
    for i in range(bit_width, 0, -1):
        rev |= (x & 1) << (i - 1)
        x >>= 1
    return rev


def add_mod(x: int, y: int, q: int) -> int:
    s = x + y
    return s - q if s >= q else s


def sub_mod(x: int, y: int, q: int) -> int:
    d = x + q - y
    return d - q if d >= q else d


def mul_mod(x: int, y: int, q: int) -> int:
    return (x * y) % q


def pow_mod(base: int, exp: int, q: int) -> int:
    return pow(base, exp, q)


def inverse_mod(a: int, q: int) -> int:
    """a^{-1} mod q (extended Euclid; reference InverseUIntMod)."""
    a = a % q
    if a == 0:
        raise ValueError("0 has no inverse")
    return pow(a, -1, q)


def barrett_factor(operand: int, bit_shift: int, q: int) -> int:
    """floor(operand << bit_shift / q), the reference MultiplyFactor::BarrettFactor
    (`tests/test_utils/ntt.hpp:17-44`). bit_shift in {52, 64}."""
    assert operand <= q
    assert bit_shift in (52, 64)
    return ((operand << bit_shift) // q) & U64


def precompute_modulus_k(q: int) -> int:
    """Smallest k with 2^k >= q (reference Device::precompute_modulus_k,
    `host/src/fpga.cpp`)."""
    k = 0
    for i in range(64, 0, -1):
        if (1 << i) >= q:
            k = i
    return k


def rk_factor(q: int) -> int:
    """Packed (r << 8) | k Barrett metadata used by the device kernels
    (`host/src/fpga.cpp` build_modulus_meta): r = floor(2^(2k) / q)."""
    k = precompute_modulus_k(q)
    r = (1 << (2 * k)) // q
    return (r << 8) | k


_MILLER_RABIN_BASES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 2^64 (reference IsPrime)."""
    if n < 2:
        return False
    for a in _MILLER_RABIN_BASES:
        if n == a:
            return True
        if n % a == 0:
            return False
    d = n - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _MILLER_RABIN_BASES:
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = (x * x) % n
            if x == n - 1:
                break
        else:
            return False
    return True


def generate_primes(num_primes: int, bit_size: int, ntt_size: int = 1) -> List[int]:
    """num_primes primes in [2^bit_size, 2^(bit_size+1)) with q % (2*ntt_size) == 1.

    Mirrors hetest::utils::GeneratePrimes (`tests/test_utils/ntt.cpp:220-246`)."""
    assert num_primes > 0
    assert is_power_of_two(ntt_size)
    assert log2_exact(ntt_size) < bit_size
    value = (1 << bit_size) + 1
    ret: List[int] = []
    while value < (1 << (bit_size + 1)):
        if is_prime(value):
            ret.append(value)
            if len(ret) == num_primes:
                return ret
        value += 2 * ntt_size
    raise RuntimeError("Failed to find enough primes")


def is_primitive_root(root: int, degree: int, q: int) -> bool:
    if root == 0:
        return False
    assert is_power_of_two(degree)
    return pow(root, degree // 2, q) == q - 1


def generate_primitive_root(degree: int, q: int, rng: random.Random | None = None) -> int:
    """A primitive degree-th root of unity mod q (randomized; reference
    GeneratePrimitiveRoot)."""
    rng = rng or random.Random(0)
    size_quotient_group = (q - 1) // degree
    for _ in range(200):
        root = pow(rng.randrange(q), size_quotient_group, q)
        if is_primitive_root(root, degree, q):
            return root
    raise RuntimeError(f"no primitive root for degree {degree} modulus {q}")


@functools.lru_cache(maxsize=None)
def minimal_primitive_root(degree: int, q: int) -> int:
    """The minimal primitive degree-th root of unity mod q.

    Mirrors MinimalPrimitiveRoot (`tests/test_utils/ntt.cpp:137-160`): walk the
    odd powers root * (root^2)^i and take the minimum — this enumerates every
    primitive degree-th root, so the result is canonical (independent of the
    random starting root)."""
    assert is_power_of_two(degree)
    root = generate_primitive_root(degree, q)
    generator_sq = (root * root) % q
    current = root
    min_root = root
    for _ in range(degree):
        if current < min_root:
            min_root = current
        current = (current * generator_sq) % q
    return min_root
