"""Port word64 (u64 on torch.int64 bit patterns) vs Python big ints, mirroring
tests/test_word64.py, and vs the JAX word64 on the same arrays via convert.
Tolerance: zero."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hexl_fpga_tpu.ops import word64 as jw
from hexl_fpga_tpu_torch import convert
from hexl_fpga_tpu_torch.ops import nt, word64 as w

M64 = (1 << 64) - 1
EDGES = [0, 1, 2, (1 << 32) - 1, 1 << 32, (1 << 63) - 1, 1 << 63, M64 - 1, M64,
         0xFFFFFFFF00000000, 0x8000000080000000, 0x123456789ABCDEF0]


def t64(vals):
    return w.from_u64_np(np.array(vals, dtype=np.uint64))


def ints(x):
    return [int(v) for v in w.to_u64_np(x)]


def jpair(vals):
    return tuple(jnp.asarray(p) for p in jw.to_pair_np(np.array(vals, dtype=np.uint64)))


def from_jax(p):
    return ints(convert.pair_to_i64(p[0], p[1]))


@pytest.fixture(scope="module")
def rng():
    return random.Random(1234)


@pytest.fixture(scope="module")
def xy(rng):
    xs = EDGES + [rng.randrange(1 << 64) for _ in range(500)]
    ys = list(reversed(EDGES)) + [rng.randrange(1 << 64) for _ in range(500)]
    return xs, ys


def test_host_converters_roundtrip(xy):
    xs, _ = xy
    a = np.array(xs, dtype=np.uint64)
    t = w.from_u64_np(a)
    assert t.dtype == torch.int64
    np.testing.assert_array_equal(w.to_u64_np(t), a)
    lo, hi = w.to_pair_np(a)
    np.testing.assert_array_equal(w.from_pair_np(lo, hi), a)
    np.testing.assert_array_equal(lo, jw.to_pair_np(a)[0])
    np.testing.assert_array_equal(hi, jw.to_pair_np(a)[1])
    lo2, hi2 = convert.i64_to_pair(convert.pair_to_i64(lo, hi))
    np.testing.assert_array_equal(lo2, lo)
    np.testing.assert_array_equal(hi2, hi)
    assert [w.const64(x) & M64 for x in xs] == xs


def test_add_sub_cmp(xy):
    xs, ys = xy
    a, b = t64(xs), t64(ys)
    assert ints(w.add64(a, b)) == [(x + y) & M64 for x, y in zip(xs, ys)]
    assert ints(w.sub64(a, b)) == [(x - y) & M64 for x, y in zip(xs, ys)]
    assert w.ge64(a, b).tolist() == [x >= y for x, y in zip(xs, ys)]
    assert w.lt64(a, b).tolist() == [x < y for x, y in zip(xs, ys)]
    # static scalars on either side, including >= 2^63
    for c in (0, 5, (1 << 63) + 7, M64):
        assert ints(w.add64(a, c)) == [(x + c) & M64 for x in xs]
        assert w.ge64(a, c).tolist() == [x >= c for x in xs]
        assert w.lt64(c, b).tolist() == [c < y for y in ys]
    assert ints(w.add64(a, b)) == from_jax(jw.add64(jpair(xs), jpair(ys)))
    assert ints(w.sub64(a, b)) == from_jax(jw.sub64(jpair(xs), jpair(ys)))


@pytest.mark.parametrize("k", [0, 1, 7, 31, 32, 33, 63])
def test_lshr64(xy, k):
    xs, _ = xy
    assert ints(w.lshr64(t64(xs), k)) == [x >> k for x in xs]
    assert w.lshr64(xs[6], k) & M64 == xs[6] >> k


def test_select_cond_sub(xy):
    xs, ys = xy
    a, b = t64(xs), t64(ys)
    sel = w.select64(w.ge64(a, b), a, b)
    assert ints(sel) == [max(x, y) for x, y in zip(xs, ys)]
    assert ints(w.cond_sub64(a, b)) == [x - y if x >= y else x for x, y in zip(xs, ys)]
    q = (1 << 52) - 47
    assert ints(w.cond_sub64(a, q)) == [x - q if x >= q else x for x in xs]
    assert ints(w.cond_sub64(a, b)) == from_jax(jw.cond_sub64(jpair(xs), jpair(ys)))


def test_mul64(xy):
    xs, ys = xy
    a, b = t64(xs), t64(ys)
    assert ints(w.mullo64(a, b)) == [(x * y) & M64 for x, y in zip(xs, ys)]
    assert ints(w.mulhi64(a, b)) == [(x * y) >> 64 for x, y in zip(xs, ys)]
    for c in (3, (1 << 64) // 1125899906826241, M64):
        assert ints(w.mullo64(a, c)) == [(x * c) & M64 for x in xs]
        assert ints(w.mulhi64(a, c)) == [(x * c) >> 64 for x in xs]
        assert ints(w.mulhi64(c, b)) == [(c * y) >> 64 for y in ys]
    assert ints(w.mullo64(a, b)) == from_jax(jw.mullo64(jpair(xs), jpair(ys)))
    assert ints(w.mulhi64(a, b)) == from_jax(jw.mulhi64(jpair(xs), jpair(ys)))


def test_mulhi64_approx_error_bound_and_reference_bits(xy):
    """Underestimates the exact high word by at most 2, and drops exactly the
    partial products the JAX one drops (the lazy MAC sums depend on it)."""
    xs, ys = xy
    got = ints(w.mulhi64_approx(t64(xs), t64(ys)))
    want = [(x * y) >> 64 for x, y in zip(xs, ys)]
    assert all(0 <= wv - gv <= 2 for wv, gv in zip(want, got))
    assert got == from_jax(jw.mulhi64_approx(jpair(xs), jpair(ys)))
    c = (1 << 64) // 1125899906826241
    assert ints(w.mulhi64_approx(t64(xs), c)) == from_jax(
        jw.mulhi64_approx(jpair(xs), c))


@pytest.mark.parametrize("bits", [17, 28, 33, 45, 52])
def test_mul_mod_static(rng, bits):
    q = nt.generate_primes(1, bits, 16)[0]
    xs = [0, 1, q - 1] + [rng.randrange(q) for _ in range(509)]
    ys = [q - 1, q - 1, q - 1] + [rng.randrange(q) for _ in range(509)]
    got = ints(w.mul_mod_static(t64(xs), t64(ys), q))
    assert got == [(x * y) % q for x, y in zip(xs, ys)]
    assert got == from_jax(jw.mul_mod_static(jpair(xs), jpair(ys), q))
    # a static multiplicand, as the keyswitch uses it
    c = ys[5]
    assert ints(w.mul_mod_static(t64(xs), c, q)) == [(x * c) % q for x in xs]


@pytest.mark.parametrize("bits", [20, 40, 52, 61])
def test_mul_mod_lazy_and_barrett(rng, bits):
    q = nt.generate_primes(1, bits, 16)[0]
    ws = [rng.randrange(q) for _ in range(256)]
    wp = [nt.barrett_factor(v, 64, q) for v in ws]
    xs = [rng.randrange(4 * q) for _ in range(256)]
    lazy = ints(w.mul_mod_lazy(t64(xs), t64(ws), t64(wp), q))
    for x, wv, t in zip(xs, ws, lazy):
        assert t < 2 * q
        assert t % q == (x * wv) % q
    assert lazy == from_jax(jw.mul_mod_lazy(jpair(xs), jpair(ws), jpair(wp), q))
    # scalar twiddle (the tail's modswitch factor)
    assert ints(w.mul_mod_lazy(t64(xs), ws[0], wp[0], q)) == [
        (ws[0] * x - ((x * wp[0]) >> 64) * q) & M64 for x in xs
    ]
    q_barr = nt.barrett_factor(1, 64, q)
    vals = [rng.randrange(1 << 62) for _ in range(256)]
    red = ints(w.barrett_reduce64(t64(vals), q, q_barr))
    assert red == [v % q for v in vals]
    assert red == from_jax(jw.barrett_reduce64(jpair(vals), q, q_barr))
    # barrett_canonical takes ANY u64
    anyv = EDGES + [rng.randrange(1 << 64) for _ in range(256)]
    assert ints(w.barrett_canonical(t64(anyv), q, q_barr)) == [v % q for v in anyv]


def test_add_sub_mod(rng):
    q = nt.generate_primes(1, 50, 16)[0]
    xs = [rng.randrange(q) for _ in range(256)]
    ys = [rng.randrange(q) for _ in range(256)]
    assert ints(w.add_mod(t64(xs), t64(ys), q)) == [(x + y) % q for x, y in zip(xs, ys)]
    assert ints(w.sub_mod(t64(xs), t64(ys), q)) == [(x - y) % q for x, y in zip(xs, ys)]
    assert ints(w.add_mod(t64(xs), q >> 1, q)) == from_jax(
        jw.add_mod(jpair(xs), q >> 1, q))


@pytest.mark.parametrize("factor", [1, 2, 4, 8])
def test_reduce_mod_factor(rng, factor):
    q = nt.generate_primes(1, 45, 16)[0]
    xs = [rng.randrange(factor * q) for _ in range(256)]
    got = ints(w.reduce_mod_factor(t64(xs), q, factor))
    assert got == [x % q for x in xs]
    assert got == from_jax(jw.reduce_mod_factor(jpair(xs), q, factor))


@pytest.mark.parametrize("bits", [17, 40, 45, 52, 54])
def test_precon64_np_exact_vs_bigint(bits):
    rng = np.random.default_rng(5)
    q = int(nt.generate_primes(1, bits, 1024)[0])
    ks = np.concatenate([
        np.array([0, 1, q - 1], dtype=np.uint64),
        rng.integers(0, q, size=200, dtype=np.uint64),
    ])
    got = w.precon64_np(ks, q)
    want = np.array([(int(k) << 64) // q for k in ks], dtype=np.uint64)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jw.precon64_np(ks, q))


def test_mul64_full(xy):
    xs, ys = xy
    lo, hi = w.mul64_full(t64(xs), t64(ys))
    assert ints(lo) == [(x * y) & M64 for x, y in zip(xs, ys)]
    assert ints(hi) == [(x * y) >> 64 for x, y in zip(xs, ys)]
    p0, p1, p2, p3 = jw.mul64_full(jpair(xs), jpair(ys))
    assert ints(lo) == from_jax((p0, p1)) and ints(hi) == from_jax((p2, p3))


def test_add128(xy, rng):
    """Exact 128-bit add of (low, high) pairs, carries out of the low half
    included; against Python ints and the reference's four-limb add."""
    xs, ys = xy
    M128 = (1 << 128) - 1
    a = [(h << 64) | l for l, h in zip(xs, ys)]
    b = [(h << 64) | l for l, h in zip(reversed(xs), xs)]
    b[:3] = [1, M128, (1 << 64) - 1]  # carry chains through both halves
    a[:3] = [(1 << 64) - 1, 1, 1]
    split = lambda vs: (t64([v & M64 for v in vs]), t64([v >> 64 for v in vs]))
    lo, hi = w.add128(split(a), split(b))
    want = [(x + y) & M128 for x, y in zip(a, b)]
    assert ints(lo) == [v & M64 for v in want]
    assert ints(hi) == [v >> 64 for v in want]
    jsplit = lambda vs: jpair([v & M64 for v in vs]) + jpair([v >> 64 for v in vs])
    r = jw.add128(jsplit(a), jsplit(b))
    assert ints(lo) == from_jax(r[:2]) and ints(hi) == from_jax(r[2:])
    # a sum of seven 116-bit products, as the exact128 MAC forms it
    prods = [[rng.randrange(1 << 52) * rng.randrange(1 << 64) for _ in range(64)]
             for _ in range(7)]
    acc = split(prods[0])
    for p in prods[1:]:
        acc = w.add128(acc, split(p))
    total = [sum(col) for col in zip(*prods)]
    assert ints(acc[0]) == [v & M64 for v in total]
    assert ints(acc[1]) == [v >> 64 for v in total]


@pytest.mark.parametrize("s", [0, 1, 31, 32, 33, 62, 63])
def test_shift128_right_static_and_per_element(xy, s):
    """s = 0 is the trap: nothing may be shifted by 64."""
    xs, ys = xy
    want = [(((h << 64) | l) >> s) & M64 for l, h in zip(xs, ys)]
    assert ints(w.shift128_right(t64(xs), t64(ys), s)) == want
    per = torch.full((len(xs),), s, dtype=torch.int64)
    assert ints(w.shift128_right(t64(xs), t64(ys), per)) == want
    limbs = jpair(xs) + jpair(ys)
    assert want == from_jax(jw._shift128_right_static(*limbs, s))
    assert want == from_jax(jw._shift128_right_traced(*limbs, jnp.uint32(s)))
    with pytest.raises(ValueError):
        w.shift128_right(t64(xs), t64(ys), 64)


def test_shift128_right_mixed_shifts(xy):
    xs, ys = xy
    ss = [i % 64 for i in range(len(xs))]
    got = ints(w.shift128_right(t64(xs), t64(ys), torch.tensor(ss)))
    assert got == [(((h << 64) | l) >> s) & M64 for l, h, s in zip(xs, ys, ss)]


@pytest.mark.parametrize("q", [2, 3, 10, 30, (1 << 20) + 7, 1125899906826241,
                               (1 << 61) + 409, (1 << 62) - 57])
def test_mul_mod_traced(rng, q):
    """The reference MultMod with runtime moduli: exact on [0, 4q) for any
    word-sized q (prime or not), with q, barr, len as scalars or as tensors,
    and the JAX function's bits on any u64."""
    ln = q.bit_length() - 2
    barr = ((1 << (ln + 64)) // q) & M64
    xs = [0, q - 1, 4 * q - 1, q] + [rng.randrange(4 * q) for _ in range(252)]
    ys = [4 * q - 1, q - 1, 4 * q - 1, 1] + [rng.randrange(4 * q) for _ in range(252)]
    want = [(x * y) % q for x, y in zip(xs, ys)]
    assert ints(w.mul_mod_traced(t64(xs), t64(ys), q, barr, ln)) == want
    k = len(xs)
    qt, bt, lt = t64([q] * k), t64([barr] * k), torch.full((k,), ln)
    assert ints(w.mul_mod_traced(t64(xs), t64(ys), qt, bt, lt)) == want
    jq, jb, jl = jpair([q] * k), jpair([barr] * k), jnp.full((k,), ln, jnp.uint32)
    assert want == from_jax(jw.mul_mod_traced(jpair(xs), jpair(ys), jq, jb, jl))
    # raw operands beyond 4q stay exact while x*y < 2^(len+64)
    cap = 1 << ((ln + 64) // 2)
    rx = [rng.randrange(cap) for _ in range(64)]
    ry = [rng.randrange(cap) for _ in range(64)]
    assert ints(w.mul_mod_traced(t64(rx), t64(ry), q, barr, ln)) == [
        (x * y) % q for x, y in zip(rx, ry)]
    # any u64: no longer modular, still the reference's bits
    ax = EDGES + [rng.randrange(1 << 64) for _ in range(52)]
    ay = list(reversed(EDGES)) + [rng.randrange(1 << 64) for _ in range(52)]
    k = len(ax)
    assert ints(w.mul_mod_traced(t64(ax), t64(ay), q, barr, ln)) == from_jax(
        jw.mul_mod_traced(jpair(ax), jpair(ay), jpair([q] * k), jpair([barr] * k),
                          jnp.full((k,), ln, jnp.uint32)))
