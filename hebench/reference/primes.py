"""Number theory for the benchmark's configurations, in Python integers.

The deterministic prime search that picks a configuration's moduli, and the
canonical 2n-th root of unity that each side derives when no twiddle table
is given: the least primitive 2n-th root of unity modulo q.
"""

from __future__ import annotations

_BASES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(n: int) -> bool:
    """Miller-Rabin with the first twelve primes as bases: exact below 2^64."""
    if n < 2:
        return False
    for p in _BASES:
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _BASES:
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def ntt_primes(count: int, bits: int, n: int) -> list[int]:
    """The first `count` primes q >= 2^bits + 1 with q = 1 mod 2n, in
    increasing order (the search of the reference's GeneratePrimes)."""
    out = []
    q = (1 << bits) + 1
    while len(out) < count:
        if q >= 1 << (bits + 1):
            raise ValueError(f"fewer than {count} primes of {bits + 1} bits")
        if is_prime(q):
            out.append(q)
        q += 2 * n
    return out


def minimal_root(n: int, q: int) -> int:
    """The least primitive 2n-th root of unity modulo the prime q."""
    if (q - 1) % (2 * n):
        raise ValueError(f"{q} is not 1 mod {2 * n}")
    for g in range(2, q):
        psi = pow(g, (q - 1) // (2 * n), q)
        if pow(psi, n, q) == q - 1:  # order exactly 2n
            break
    # every primitive 2n-th root is an odd power of psi
    best, cur, sq = psi, psi, psi * psi % q
    for _ in range(n - 1):
        cur = cur * sq % q
        best = min(best, cur)
    return best
