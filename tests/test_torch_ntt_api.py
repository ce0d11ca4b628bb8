"""The standalone transform pair of the port: the plain versions of
`ntt_fwd` / `ntt_inv` (the kernels' splits up to n = 32768, built and caller
tables) vs the batched butterfly Pallas kernels of `ntt_pallas` (interpret mode), the
XLA tier with caller tables and the golden model; and the deprecated
`_NTT` / `_INTT` API section as a whole vs the JAX package's, both under
RUN_CHOICE=1 on the same buffers.  Tolerance: zero."""

import functools

import numpy as np
import pytest
import torch

import hexl_fpga_tpu as jhexl
import hexl_fpga_tpu_torch as hexl
from hexl_fpga_tpu import config as jconfig
from hexl_fpga_tpu.ops import ntt_jax, ntt_pallas
from hexl_fpga_tpu_torch import config as config_mod
from hexl_fpga_tpu_torch.ops import golden, nt, ntt_cuda, twiddles, word64 as w
from hexl_fpga_tpu_torch.utils.debug import HexlAssertError

N = 1024


def run_port(fn, a, tabs, *rest):
    return w.to_u64_np(fn(w.from_u64_np(a), tabs, *rest))


def other_root(n, q, k=5):
    """A primitive 2n-th root that is not the minimal one."""
    psi0 = nt.minimal_primitive_root(2 * n, q)
    psi = pow(psi0, k, q)
    assert psi != psi0 and nt.is_primitive_root(psi, 2 * n, q)
    return psi


# -- the plain versions -------------------------------------------------------


def test_plain_matches_batched_butterfly_pallas_kernels():
    """Canonical in -> canonical out, as `ntt_pallas._fwd_kernel/_inv_kernel`."""
    q = int(nt.generate_primes(1, 50, N)[0])
    rng = np.random.default_rng(1)
    a = rng.integers(0, q, size=(8, N), dtype=np.uint64)
    a[0], a[1] = 0, q - 1
    tabs = ntt_cuda.modulus_tables(N, q, device="cpu")
    f = run_port(ntt_cuda.ntt_fwd, a, tabs)
    np.testing.assert_array_equal(f, ntt_pallas.fwd_ntt(a, q, interpret=True))
    i = run_port(ntt_cuda.ntt_inv, a, tabs)
    np.testing.assert_array_equal(i, ntt_pallas.inv_ntt(a, q, interpret=True))
    np.testing.assert_array_equal(run_port(ntt_cuda.ntt_inv, f, tabs), a)


@pytest.mark.parametrize("bits", [50, 61])
def test_caller_tables_other_root_match_xla_tier_and_golden(bits):
    q = int(nt.generate_primes(1, bits, N)[0])
    t = twiddles.ntt_tables(N, q, other_root(N, q))
    rng = np.random.default_rng(bits)
    a = rng.integers(0, q, size=(3, N), dtype=np.uint64)
    ft = ntt_cuda.caller_fwd_tables(N, q, t.fwd, t.fwd_precon, device="cpu")
    f = run_port(ntt_cuda.ntt_fwd, a, ft)
    np.testing.assert_array_equal(f, golden.fwd_ntt(a, q, t))
    assert not np.array_equal(f, golden.fwd_ntt(a, q))
    np.testing.assert_array_equal(
        f, ntt_jax.fwd_ntt_with_tables(a, q, t.fwd, t.fwd_precon))
    it = ntt_cuda.caller_inv_tables(N, q, t.inv, t.inv_precon, t.inv_n, t.inv_n_w,
                                   device="cpu")
    i = run_port(ntt_cuda.ntt_inv, a, it)
    np.testing.assert_array_equal(i, golden.inv_ntt(a, q, t))
    np.testing.assert_array_equal(
        i, ntt_jax.inv_ntt_with_tables(a, q, t.inv, t.inv_precon, t.inv_n, t.inv_n_w))
    np.testing.assert_array_equal(run_port(ntt_cuda.ntt_inv, f, it), a)


def test_caller_tables_are_cached_by_content_and_one_directional():
    q = int(nt.generate_primes(1, 30, 64)[0])
    t = twiddles.ntt_tables(64, q)
    cpu = {"device": "cpu"}
    ft = ntt_cuda.caller_fwd_tables(64, q, t.fwd, t.fwd_precon, **cpu)
    # a second batch under equal tables (other array objects) uploads nothing
    assert ntt_cuda.caller_fwd_tables(64, q, t.fwd.copy(), list(t.fwd_precon),
                                      **cpu) is ft
    it = ntt_cuda.caller_inv_tables(64, q, t.inv, t.inv_precon, t.inv_n, t.inv_n_w,
                                    **cpu)
    assert ntt_cuda.caller_inv_tables(
        64, q, t.inv.copy(), t.inv_precon, t.inv_n, t.inv_n_w, **cpu) is it
    other = twiddles.ntt_tables(64, q, other_root(64, q, 3))
    assert ntt_cuda.caller_fwd_tables(64, q, other.fwd, other.fwd_precon,
                                      **cpu) is not ft
    x = torch.zeros(1, 64, dtype=torch.int64)
    with pytest.raises(ValueError, match="no inverse"):
        ntt_cuda.ntt_inv(x, ft)
    with pytest.raises(ValueError, match="no forward"):
        ntt_cuda.ntt_fwd(x, it)
    with pytest.raises(ValueError, match="expected 64"):
        ntt_cuda.caller_fwd_tables(64, q, t.fwd[:32], t.fwd_precon, **cpu)
    with pytest.raises(ValueError, match="below q"):
        ntt_cuda.caller_inv_tables(64, q, t.inv, t.inv_precon, q, t.inv_n_w, **cpu)


WIDE = 32768  # a row of it takes 2 or 4 blocks, never one


@functools.lru_cache(maxsize=None)
def wide_case():
    """(q, tables, 2 rows of any u64 with a canonical first row, the rows
    mod q, golden forward and inverse of them) at n = 32768, under a root
    that is not the minimal one."""
    q = int(nt.generate_primes(1, 61, WIDE)[0])
    psi = other_root(WIDE, q, 3)
    rng = np.random.default_rng(WIDE)
    a = rng.integers(0, 1 << 64, size=(2, WIDE), dtype=np.uint64)
    a[0] %= np.uint64(q)
    red = a % np.uint64(q)
    gt = twiddles.ntt_tables(WIDE, q, psi)
    return (q, ntt_cuda.modulus_tables(WIDE, q, psi, device="cpu"), a, red,
            golden.fwd_ntt(red, q, gt), golden.inv_ntt(red, q, gt))


@pytest.mark.parametrize("direction", ["fwd", "inv"])
@pytest.mark.parametrize("parts", [2, 4])
def test_split_schedule_at_n_32768(direction, parts):
    """The kernels' split at n = 32768 (pieces of 16384 and 8192 values, log2
    of a piece 14 and 13): the plain versions against the golden model and
    against the other C."""
    q, tabs, a, red, want_fwd, want_inv = wide_case()
    fn = ntt_cuda.ntt_fwd_plain if direction == "fwd" else ntt_cuda.ntt_inv_plain
    got = run_port(fn, a, tabs, parts)
    np.testing.assert_array_equal(got, want_fwd if direction == "fwd" else want_inv)
    np.testing.assert_array_equal(got, run_port(fn, a, tabs, 8 // parts))


def test_n_beyond_the_kernels_is_refused():
    """n must be a power of two from 4 to 32768, on any device; five kernels
    count their launches."""
    for n in (65536, 3, 1000, 2):
        with pytest.raises(ValueError, match=f"no NTT kernel serves n = {n}"):
            ntt_cuda.modulus_tables(n, 1152921504606584833, device="cpu")
    assert set(ntt_cuda.LAUNCHES) == {
        "ntt_fwd", "ntt_inv", "ntt_fwd_tail", "ntt_fwd_mac", "keyswitch_mac"}


# -- the API section ----------------------------------------------------------


@pytest.fixture
def both(monkeypatch):
    """Both packages' runtimes under one environment; always released."""

    def start(**env):
        for k, v in env.items():
            monkeypatch.setenv(k, str(v))
        config_mod.reset_config()
        jconfig.reset_config()
        hexl.acquire_FPGA_resources()
        jhexl.acquire_FPGA_resources()

    yield start
    hexl.release_FPGA_resources()
    jhexl.release_FPGA_resources()
    config_mod.reset_config()
    jconfig.reset_config()


def drive_ntt(pkg, ops, t, q, n):
    with pytest.deprecated_call():
        pkg._set_worksize_NTT(len(ops))
        for o in ops:
            pkg._NTT(o, t.fwd, t.fwd_precon, q, n)
    assert pkg._NTTCompleted()


def drive_intt(pkg, ops, t, q, n):
    with pytest.deprecated_call():
        pkg._set_worksize_INTT(len(ops))
        for o in ops:
            pkg._INTT(o, t.inv, t.inv_precon, q, t.inv_n, t.inv_n_w, n)
    assert pkg._INTTCompleted()


@pytest.mark.parametrize("n,bits,worksize", [
    (1024, 50, 1), (1024, 61, 4), (1024, 50, 7), (32768, 61, 3)])
def test_ntt_intt_api_matches_jax_api(both, n, bits, worksize):
    """Same buffers through both packages' `_NTT` then `_INTT`, in place, with
    a caller's root that is not the minimal one; 7 ops in batches of 4 leave a
    short last batch."""
    both(RUN_CHOICE=1, BATCH_SIZE_NTT=4, BATCH_SIZE_INTT=4)
    q = int(nt.generate_primes(1, bits, n)[0])
    t = twiddles.ntt_tables(n, q, other_root(n, q))
    rng = np.random.default_rng(n + worksize)
    src = [rng.integers(0, q, size=n, dtype=np.uint64) for _ in range(worksize)]
    mine = [s.copy() for s in src]
    ref = [s.copy() for s in src]
    drive_ntt(hexl, mine, t, q, n)
    drive_ntt(jhexl, ref, t, q, n)
    for a, b, s in zip(mine, ref, src):
        np.testing.assert_array_equal(a, b)
        assert not np.array_equal(a, s)  # written in place
    np.testing.assert_array_equal(mine[0], golden.fwd_ntt(src[0], q, t))
    drive_intt(hexl, mine, t, q, n)
    drive_intt(jhexl, ref, t, q, n)
    for a, b, s in zip(mine, ref, src):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, s)  # the round trip


def test_modulus_change_fences_a_batch(both):
    both(RUN_CHOICE=1, BATCH_SIZE_NTT=8)
    qs = [int(q) for q in nt.generate_primes(2, 40, N)]
    rng = np.random.default_rng(4)
    src = [rng.integers(0, min(qs), size=N, dtype=np.uint64) for _ in range(4)]
    ops = [s.copy() for s in src]
    with pytest.deprecated_call():
        hexl._set_worksize_NTT(4)
        for o, q in zip(ops, (qs[0], qs[0], qs[1], qs[0])):
            t = twiddles.ntt_tables(N, q)
            hexl._NTT(o, t.fwd, t.fwd_precon, q, N)
    assert hexl._NTTCompleted()
    for o, s, q in zip(ops, src, (qs[0], qs[0], qs[1], qs[0])):
        np.testing.assert_array_equal(o, golden.fwd_ntt(s, q))


def test_validation_and_deprecation(both):
    both(RUN_CHOICE=1)
    q = int(nt.generate_primes(1, 30, N)[0])
    t = twiddles.ntt_tables(N, q)
    a = np.zeros(N, dtype=np.uint64)
    for fn, args in (
        (hexl._set_worksize_NTT, (1,)), (hexl._set_worksize_INTT, (1,)),
        (hexl._NTT, (a, t.fwd, t.fwd_precon, q, N)),
        (hexl._INTT, (a, t.inv, t.inv_precon, q, t.inv_n, t.inv_n_w, N)),
    ):
        with pytest.warns(DeprecationWarning, match="deprecated since version 1.1"):
            fn(*args)
    with pytest.deprecated_call():
        for bad_n in (512, 65536, 1000):
            with pytest.raises(HexlAssertError):
                hexl._NTT(np.zeros(bad_n, dtype=np.uint64), t.fwd, t.fwd_precon, q, bad_n)
        with pytest.raises(HexlAssertError, match="size mismatch"):
            hexl._INTT(a[:5], t.inv, t.inv_precon, q, t.inv_n, t.inv_n_w, N)
        with pytest.raises(HexlAssertError, match="size mismatch"):
            hexl._NTT(None, t.fwd, t.fwd_precon, q, N)
        with pytest.raises(HexlAssertError, match="positive"):
            hexl._set_worksize_NTT(0)
    assert hexl._NTTCompleted() and hexl._INTTCompleted()


def test_run_choice_0_raises_on_ntt_as_the_reference(both):
    both(RUN_CHOICE=0)
    q = int(nt.generate_primes(1, 30, N)[0])
    t = twiddles.ntt_tables(N, q)
    a = np.ones(N, dtype=np.uint64)
    with pytest.deprecated_call():
        with pytest.raises(RuntimeError, match="not supported on the CPU backend"):
            hexl._NTT(a, t.fwd, t.fwd_precon, q, N)
        with pytest.raises(RuntimeError, match="not supported on the CPU backend"):
            hexl._INTT(a, t.inv, t.inv_precon, q, t.inv_n, t.inv_n_w, N)
        with pytest.raises(RuntimeError):
            jhexl._NTT(a, t.fwd, t.fwd_precon, q, N)
