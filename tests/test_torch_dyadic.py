"""The port's DyadicMultiply (plain version of the `dyadic_mul` kernel) vs the
Pallas kernel it replaces (interpret mode), both XLA tiers of the JAX package
and the golden model, on the same numpy inputs.  Tolerance: zero."""

import numpy as np
import pytest
import torch

from hexl_fpga_tpu.ops import dyadic_jax, dyadic_pallas, word64 as jw
from hexl_fpga_tpu_torch import convert
from hexl_fpga_tpu_torch.ops import dyadic_cuda, golden, nt, word64 as w

N, M, B = 256, 3, 2


def port(op1, op2, moduli):
    """(B, 2, M, n) u64 operands through the port's wrapper on the CPU."""
    r = dyadic_cuda.runner(moduli, device="cpu")
    return w.to_u64_np(r.run(w.from_u64_np(op1), w.from_u64_np(op2)))


def golden4(op1, op2, moduli):
    Bq, _, Mq, n = op1.shape
    return np.stack([
        golden.dyadic_multiply(op1[b], op2[b], n, moduli, Mq).reshape(3, Mq, n)
        for b in range(Bq)
    ])


def operands(moduli, n, factor, seed, batch=B):
    """Operands in [0, factor * q) per modulus, the edges of the range first."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(2):
        a = np.stack(
            [rng.integers(0, factor * int(q), size=(batch, 2, n), dtype=np.uint64)
             for q in moduli], axis=2)
        for m, q in enumerate(moduli):
            a[0, :, m, :4] = [0, int(q) - 1, factor * int(q) - 1, int(q)][:4]
        ops.append(a)
    return ops


@pytest.mark.parametrize("bits", [20, 51])
@pytest.mark.parametrize("factor", [1, 4])
def test_plain_matches_pallas_both_xla_tiers_and_golden(bits, factor):
    moduli = [int(q) for q in nt.generate_primes(M, bits, N)]
    op1, op2 = operands(moduli, N, factor, seed=bits + factor)
    got = port(op1, op2, moduli)
    np.testing.assert_array_equal(got, golden4(op1, op2, moduli))
    r = dyadic_pallas.runner(tuple(moduli), N, interpret=True)
    np.testing.assert_array_equal(got, r.run(op1, op2))
    out32 = np.asarray(r.dispatch32(op1, op2))
    np.testing.assert_array_equal(
        got, w.to_u64_np(convert.interleaved_to_i64(out32)).reshape(B, 3, M, N))
    mods = np.tile(np.array(moduli, dtype=np.uint64), (B, 1))
    np.testing.assert_array_equal(
        got, dyadic_jax.dyadic_multiply_batched(op1, op2, mods))
    np.testing.assert_array_equal(
        got, dyadic_jax.dyadic_multiply_static(op1, op2, moduli))


def ramp(num_ops, num_moduli, n):
    """The reference's ramp stimulus (`tests/test_dyadic_multiply.cpp:32-109`):
    raw operands far beyond 4q over the composite moduli 10, 20, 30, ..."""
    i = np.arange(n, dtype=np.uint64)
    moduli, op1, op2 = [], [], []
    for b in range(num_ops):
        moduli.append([(b + m + 1) * 10 for m in range(num_moduli)])
        rows = lambda off: np.stack(
            [np.uint64(b + off) + i + np.uint64(m * n) for m in range(num_moduli)])
        op1.append(np.stack([rows(1), rows(11)]))
        op2.append(np.stack([rows(2), rows(22)]))
    return moduli, op1, op2


@pytest.mark.parametrize("n", [64, 256])
def test_ramp_raw_operands_beyond_4q(n):
    """MultMod stays exact for raw operands while x*y < 2^(len+64); the traced
    XLA tier is the reference's route for them at any n, the Pallas kernel
    where n is a multiple of 128."""
    moduli, op1, op2 = ramp(2, M, n)
    for k, (q, a, b) in enumerate(zip(moduli, op1, op2)):
        assert int(a.max()) > 4 * max(q)
        got = port(a[None], b[None], q)
        np.testing.assert_array_equal(got, golden4(a[None], b[None], q))
        np.testing.assert_array_equal(
            got, dyadic_jax.dyadic_multiply_batched(
                a[None], b[None], np.array([q], dtype=np.uint64)))
        if n % 128 == 0 and k == 0:  # one compile of the Pallas kernel
            r = dyadic_pallas.runner(tuple(q), n, interpret=True)
            np.testing.assert_array_equal(got, r.run(a[None], b[None]))


def test_tiny_moduli_len_zero():
    """q = 2 and 3 have len = 0: the 128-bit shift must not shift by 64."""
    moduli = [2, 3, 10]
    lens, barrs = dyadic_cuda.moduli_meta(moduli)
    assert lens.tolist() == [0, 0, 2]
    assert barrs.tolist() == [1 << 63, (1 << 64) // 3, (1 << 66) // 10]
    jl, jb = dyadic_jax.moduli_meta(np.array(moduli, dtype=np.uint64))
    np.testing.assert_array_equal(lens, jl)
    np.testing.assert_array_equal(barrs, jb)
    op1, op2 = operands(moduli, 128, 4, seed=5, batch=1)
    got = port(op1, op2, moduli)
    np.testing.assert_array_equal(got, golden4(op1, op2, moduli))
    np.testing.assert_array_equal(
        got, dyadic_jax.dyadic_multiply_batched(
            op1, op2, np.array([moduli], dtype=np.uint64)))
    r = dyadic_pallas.runner(tuple(moduli), 128, interpret=True)
    np.testing.assert_array_equal(got, r.run(op1, op2))


def test_any_u64_operands_follow_the_traced_tier():
    """Outside MultMod's exact domain nothing is modular any more, but the
    port is still the four MultMods and one add of the reference's traced
    tier, bit for bit (sums may wrap)."""
    moduli = [int(q) for q in nt.generate_primes(2, 40, N)] + [30]
    rng = np.random.default_rng(11)
    op1 = rng.integers(0, 1 << 64, size=(1, 2, 3, N), dtype=np.uint64)
    op2 = rng.integers(0, 1 << 64, size=(1, 2, 3, N), dtype=np.uint64)
    np.testing.assert_array_equal(
        port(op1, op2, moduli),
        dyadic_jax.dyadic_multiply_batched(
            op1, op2, np.array([moduli], dtype=np.uint64)))


def test_numpy_convenience_and_odd_n():
    """One route for every n: n = 100 is no multiple of anything the kernel
    cares about."""
    n, moduli = 100, [1000003, 97]
    op1, op2 = operands(moduli, n, 4, seed=3, batch=1)
    got = dyadic_cuda.dyadic_multiply_np(op1[0], op2[0], n, moduli + [5], 2,
                                         device="cpu")
    np.testing.assert_array_equal(
        got, golden.dyadic_multiply(op1[0], op2[0], n, moduli, 2))
    np.testing.assert_array_equal(
        got, dyadic_jax.dyadic_multiply(op1[0], op2[0], n, moduli, 2))


def test_interleaved_converter_reads_the_reference_layout():
    a = np.random.default_rng(0).integers(0, 1 << 64, size=(2, 5), dtype=np.uint64)
    t = convert.interleaved_to_i64(jw.to_interleaved_np(a))
    assert t.shape == (2, 5)
    np.testing.assert_array_equal(w.to_u64_np(t), a)


def test_runner_is_cached_and_wrapper_checks_arguments():
    moduli = [17, 19]
    r = dyadic_cuda.runner(moduli, device="cpu")
    assert dyadic_cuda.runner(np.array(moduli, dtype=np.uint64), device="cpu") is r
    assert r.meta.shape == (3, 2) and r.meta.dtype == torch.int64
    x = torch.zeros(1, 2, 2, 8, dtype=torch.int64)
    with pytest.raises(TypeError):
        r.run(x.to(torch.int32), x)
    with pytest.raises(ValueError):
        r.run(x, x[:, :, :1])
    with pytest.raises(ValueError):
        r.run(x[:, :1], x[:, :1])
    with pytest.raises(ValueError):
        r.run(x.transpose(2, 3), x.transpose(2, 3))
    with pytest.raises(ValueError):
        dyadic_cuda.dyadic_multiply(x, x, r.meta[:, :1].contiguous())
    with pytest.raises(ValueError, match=">= 2"):
        dyadic_cuda.runner([17, 1], device="cpu")


def test_cpu_tensors_launch_nothing():
    dyadic_cuda.reset_launch_counts()
    x = torch.zeros(1, 2, 1, 8, dtype=torch.int64)
    dyadic_cuda.runner([17], device="cpu").run(x, x)
    assert dyadic_cuda.LAUNCHES == {"dyadic_mul": 0}
