"""Plain versions of the port's three NTT kernels vs the Pallas kernels they
replace (interpret mode, tile_p=2, n=1024) and vs the golden model.

Tolerance: zero, except that a LAZY forward output of the reference
(canonical=False: any u64 representative) is compared mod q — the port emits
canonical values there."""

import jax
import numpy as np
import pytest
import torch

from hexl_fpga_tpu.ops import ntt_mxu_pallas, word64 as jw
from hexl_fpga_tpu_torch import convert
from hexl_fpga_tpu_torch.ops import golden, nt, ntt_cuda, twiddles, word64 as w

N = 1024
TILE_P = 2


@pytest.fixture(scope="module")
def q():
    return int(nt.generate_primes(1, 45, N)[0])


def run_pallas(call, *arrays, extra=()):
    """Feed u64 arrays to a raw Pallas callable as (lo, hi) planes."""
    planes = [p for a in arrays for p in jw.to_pair_np(a)]
    olo, ohi = jax.jit(call)(*planes, *extra)
    return w.to_u64_np(convert.pair_to_i64(olo, ohi))


def run_port(fn, a, tabs, *rest):
    return w.to_u64_np(fn(w.from_u64_np(a), tabs, *rest))


def test_fwd_matches_pallas_and_golden(q):
    rng = np.random.default_rng(1)
    a = rng.integers(0, q, size=(4, N), dtype=np.uint64)
    a[0] = 0
    a[1] = q - 1
    tabs = ntt_cuda.modulus_tables(N, q, device="cpu")
    got = run_port(ntt_cuda.ntt_fwd, a, tabs)
    np.testing.assert_array_equal(got, golden.fwd_ntt(a, q))
    ref = run_pallas(ntt_mxu_pallas.raw_fwd_call(N, q, TILE_P, interpret=True), a)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(ntt_cuda.fwd_ntt(a, q, device="cpu"), got)


def test_fwd_unreduced_53bit_input_lazy_reference_mod_q(q):
    """The keyswitch engines' contract: unreduced input < 2^53, lazy output."""
    rng = np.random.default_rng(7)
    raw = rng.integers(0, 1 << 53, size=(2, N), dtype=np.uint64)
    tabs = ntt_cuda.modulus_tables(N, q, device="cpu")
    got = run_port(ntt_cuda.ntt_fwd, raw, tabs)
    np.testing.assert_array_equal(got, golden.fwd_ntt(raw % np.uint64(q), q))
    call = ntt_mxu_pallas.raw_fwd_call(N, q, TILE_P, interpret=True,
                                       canonical=False, data_bits=53)
    lazy = run_pallas(call, raw)
    np.testing.assert_array_equal(got, lazy % np.uint64(q))


def test_fwd_takes_any_u64(q):
    rng = np.random.default_rng(8)
    raw = rng.integers(0, 1 << 64, size=(2, N), dtype=np.uint64)
    raw[0, :4] = [0, (1 << 64) - 1, 1 << 63, q]
    got = run_port(ntt_cuda.ntt_fwd, raw, ntt_cuda.modulus_tables(N, q, device="cpu"))
    np.testing.assert_array_equal(got, golden.fwd_ntt(raw % np.uint64(q), q))


def test_inv_matches_pallas_and_golden(q):
    rng = np.random.default_rng(2)
    a = rng.integers(0, q, size=(4, N), dtype=np.uint64)
    a[0] = q - 1
    tabs = ntt_cuda.modulus_tables(N, q, device="cpu")
    got = run_port(ntt_cuda.ntt_inv, a, tabs)
    np.testing.assert_array_equal(got, golden.inv_ntt(a, q))
    ref = run_pallas(ntt_mxu_pallas.raw_inv_call(N, q, TILE_P, interpret=True), a)
    np.testing.assert_array_equal(got, ref)
    assert int(got.max()) < q  # canonical
    back = run_port(ntt_cuda.ntt_fwd, got, tabs)
    np.testing.assert_array_equal(back, a)
    np.testing.assert_array_equal(ntt_cuda.inv_ntt(a, q, device="cpu"), got)


def test_psi_override_matches_pallas(q):
    """A caller's 2n-th root (not the minimal one) reaches both transforms."""
    psi0 = nt.minimal_primitive_root(2 * N, q)
    psi = pow(psi0, 5, q)
    assert psi != psi0 and nt.is_primitive_root(psi, 2 * N, q)
    rng = np.random.default_rng(3)
    a = rng.integers(0, q, size=(2, N), dtype=np.uint64)
    tabs = ntt_cuda.modulus_tables(N, q, psi, device="cpu")
    gtabs = twiddles.ntt_tables(N, q, psi)
    f = run_port(ntt_cuda.ntt_fwd, a, tabs)
    np.testing.assert_array_equal(f, golden.fwd_ntt(a, q, gtabs))
    assert not np.array_equal(f, golden.fwd_ntt(a, q))
    ref = run_pallas(
        ntt_mxu_pallas.raw_fwd_call(N, q, TILE_P, psi=psi, interpret=True), a)
    np.testing.assert_array_equal(f, ref)
    i = run_port(ntt_cuda.ntt_inv, a, tabs)
    np.testing.assert_array_equal(i, golden.inv_ntt(a, q, gtabs))
    ref = run_pallas(
        ntt_mxu_pallas.raw_inv_call(N, q, TILE_P, psi=psi, interpret=True), a)
    np.testing.assert_array_equal(i, ref)


def _tail_oracle(e, acc, res, q, fix, msf):
    """The tail from its definition, in Python ints over the golden NTT."""
    g = golden.fwd_ntt((e.astype(object) + fix) % q, q).astype(object)
    t1 = (acc.astype(object) % q + 4 * q - g) % q
    r = res.astype(object) + (t1 * msf) % q
    return np.where(r >= q, r - q, r).astype(np.uint64)


def test_fwd_tail_matches_pallas_and_definition(q):
    rng = np.random.default_rng(4)
    R = 4
    qk = int(nt.generate_primes(3, 45, N)[2])
    fix = q - ((qk >> 1) % q)
    msf = int(rng.integers(1, q))
    msf_p = (msf << 64) // q
    e = rng.integers(0, qk, size=(R, N), dtype=np.uint64)  # canonical under q_k
    acc = rng.integers(0, 1 << 58, size=(R, N), dtype=np.uint64)  # lazy sums
    res = rng.integers(0, q, size=(R, N), dtype=np.uint64)
    res[0, :2] = [q - 1, 0]
    tabs = ntt_cuda.modulus_tables(N, q, device="cpu")
    got = w.to_u64_np(ntt_cuda.ntt_fwd_tail(
        w.from_u64_np(e), w.from_u64_np(acc), w.from_u64_np(res), tabs,
        fix, msf, msf_p))
    np.testing.assert_array_equal(got, _tail_oracle(e, acc, res, q, fix, msf))
    call = ntt_mxu_pallas.raw_fwd_tail_call(N, q, fix, TILE_P, interpret=True)
    msf4 = np.array([msf & 0xFFFFFFFF, msf >> 32,
                     msf_p & 0xFFFFFFFF, msf_p >> 32], dtype=np.uint32)
    ref = run_pallas(call, e, acc, res, extra=(msf4,))
    np.testing.assert_array_equal(got, ref)
    # out-of-range res passes through one conditional subtract, as there
    res_bad = res.copy()
    res_bad[1, :3] = [q, 2 * q + 5, 3 * q]
    got = w.to_u64_np(ntt_cuda.ntt_fwd_tail(
        w.from_u64_np(e), w.from_u64_np(acc), w.from_u64_np(res_bad), tabs,
        fix, msf, msf_p))
    ref = run_pallas(call, e, acc, res_bad, extra=(msf4,))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("bits,n", [(20, 64), (30, 256), (52, 2048), (61, 128)])
def test_plain_versions_vs_golden_other_sizes(bits, n):
    qq = int(nt.generate_primes(1, bits, n)[0])
    rng = np.random.default_rng(bits)
    a = rng.integers(0, qq, size=(3, n), dtype=np.uint64)
    np.testing.assert_array_equal(ntt_cuda.fwd_ntt(a, qq, device="cpu"), golden.fwd_ntt(a, qq))
    np.testing.assert_array_equal(ntt_cuda.inv_ntt(a, qq, device="cpu"), golden.inv_ntt(a, qq))


def test_wrappers_check_their_arguments(q):
    tabs = ntt_cuda.modulus_tables(N, q, device="cpu")
    x = torch.zeros(2, N, dtype=torch.int64)
    with pytest.raises(TypeError):
        ntt_cuda.ntt_fwd(x.to(torch.int32), tabs)
    with pytest.raises(ValueError):
        ntt_cuda.ntt_fwd(torch.zeros(2, N // 2, dtype=torch.int64), tabs)
    with pytest.raises(ValueError):
        ntt_cuda.ntt_inv(torch.zeros(N, 2, dtype=torch.int64).t(), tabs)
    with pytest.raises(ValueError):
        ntt_cuda.ntt_fwd_tail(x, x[:1], x, tabs, 0, 1, 1)


def test_cpu_tensors_launch_nothing(q):
    ntt_cuda.reset_launch_counts()
    tabs = ntt_cuda.modulus_tables(N, q, device="cpu")
    x = torch.zeros(2, N, dtype=torch.int64)
    ntt_cuda.ntt_fwd(x, tabs)
    ntt_cuda.ntt_inv(x, tabs)
    ntt_cuda.ntt_fwd_tail(x, x, x, tabs, 0, 1, 1)
    keys = torch.zeros(2, 2, 3, N, dtype=torch.int64)
    ntt_cuda.ntt_fwd_mac(x, keys, keys, 0, tabs)
    ntt_cuda.keyswitch_mac(x.view(2, 1, N), keys[:, :, :1], keys[:, :, :1], q)
    assert ntt_cuda.LAUNCHES == dict.fromkeys(
        ("ntt_fwd", "ntt_inv", "ntt_fwd_tail", "ntt_fwd_mac", "keyswitch_mac"), 0)
