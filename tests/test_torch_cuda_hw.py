"""The port's hardware tier, the counterpart of tests/test_tpu_hw.py: runs
only with HEXL_TORCH_HW_TESTS=1 on a machine with a CUDA device, and skips
everywhere else.  It imports nothing of JAX or of the JAX package, so on a
machine without JAX it runs without the suite's conftest:

  HEXL_TORCH_HW_TESTS=1 python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_hw.py -q

Every result is held bit for bit against the golden model or a frozen
vector; the entry points are the port's (`ntt_cuda`,
`keyswitch_cuda.get_context`, the API), each on the card.
"""

import glob
import os
import warnings

import numpy as np
import pytest
import torch

import hexl_fpga_tpu_torch as hexl
from hexl_fpga_tpu_torch import config as config_mod
from hexl_fpga_tpu_torch.ops import golden, keyswitch_cuda, nt, ntt_cuda, twiddles
from hexl_fpga_tpu_torch.runtime import scheduler
from hexl_fpga_tpu_torch.utils import vectors

TESTDATA = os.path.join(os.path.dirname(__file__), "testdata")

pytestmark = pytest.mark.card


@pytest.fixture(autouse=True)
def hardware_tier():
    """Decided per test, never at import: the tier runs only when asked for
    and a card is there."""
    if os.environ.get("HEXL_TORCH_HW_TESTS") != "1":
        pytest.skip("hardware tier: set HEXL_TORCH_HW_TESTS=1 on a machine with a CUDA device")
    if not torch.cuda.is_available():
        pytest.skip("hardware tier: no CUDA device is available")


@pytest.fixture
def runtime(monkeypatch):
    """The API's workers on the card (RUN_CHOICE=2) under the environment a
    test sets; released afterwards."""
    def start(**env):
        monkeypatch.setenv("RUN_CHOICE", "2")
        for k, v in env.items():
            monkeypatch.setenv(k, str(v))
        config_mod.reset_config()
        hexl.acquire_FPGA_resources()
        return scheduler.pool()

    yield start
    hexl.release_FPGA_resources()
    config_mod.reset_config()


def test_mxu_ntt_roundtrip_hw():
    for n, bits in [(1024, 30), (16384, 51)]:
        q = nt.generate_primes(1, bits, n)[0]
        a = np.random.default_rng(0).integers(0, q, size=(8, n), dtype=np.uint64)
        got = ntt_cuda.fwd_ntt(a, q)
        np.testing.assert_array_equal(got, golden.fwd_ntt(a, q))
        np.testing.assert_array_equal(ntt_cuda.inv_ntt(got, q), a)


def test_keyswitch_benchmark_config_hw():
    n, L, K = 16384, 6, 7
    vec = vectors.make_keyswitch_vector(n, L, K, seed=0, modulus_bits=51)
    ctx = keyswitch_cuda.get_context(n, L, K, L + 1, 2, vec.moduli, vec.twiddle_factors)
    got = ctx.run(vec.input, vec.t_target_iter_ptr, vec.key_vectors, vec.modswitch_factors)
    np.testing.assert_array_equal(got, vec.expected_output)


@pytest.mark.parametrize("config", ["16384_6_7_7_2", "16384_5_7_6_2"])
def test_recorded_16384_configs_hw(config):
    """Both recorded 16384 configurations through the device context, bit
    for bit against the frozen vectors."""
    files = sorted(glob.glob(os.path.join(TESTDATA, f"{config}_*.json*")))
    assert files, f"frozen {config} vector missing from tests/testdata/"
    vec = vectors.load_json(files[0])
    ctx = keyswitch_cuda.get_context(
        vec.coeff_count, vec.decomp_modulus_size, vec.key_modulus_size,
        vec.rns_modulus_size, vec.key_component_count, vec.moduli,
        vec.twiddle_factors,
    )
    got = ctx.run(vec.input, vec.t_target_iter_ptr, vec.key_vectors, vec.modswitch_factors)
    np.testing.assert_array_equal(got, vec.expected_output)


def test_fuzz_random_configs_hw():
    """Random (n, L, K, prime width) KeySwitch configurations on the card,
    both schedules, against the golden model."""
    rng = np.random.default_rng(2026)
    for trial in range(3):
        n = int(rng.choice([1024, 2048, 4096]))
        L = int(rng.integers(2, 5))
        K = L + 1
        bits = int(rng.integers(30, 52))
        vec = vectors.make_keyswitch_vector(n, L, K, seed=trial, modulus_bits=bits)
        for fused in (False, True):
            ctx = keyswitch_cuda.KeySwitchContext(
                n, L, K, L + 1, 2, vec.moduli, vec.twiddle_factors, fused_mac=fused)
            got = ctx.run(vec.input, vec.t_target_iter_ptr, vec.key_vectors,
                          vec.modswitch_factors)
            np.testing.assert_array_equal(
                got, vec.expected_output,
                err_msg=f"config n={n} L={L} K={K} bits={bits} fused_mac={fused}")


def _ntt_through_api(a, t, q, n):
    op = a.copy()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        hexl._set_worksize_NTT(1)
        hexl._NTT(op, t.fwd, t.fwd_precon, q, n)
    assert hexl._NTTCompleted()
    return op


def test_api_accelerated_hw(runtime):
    runtime()
    q = nt.generate_primes(1, 48, 2048)[0]
    t = twiddles.ntt_tables(2048, q)
    a = np.random.default_rng(1).integers(0, q, size=2048, dtype=np.uint64)
    np.testing.assert_array_equal(_ntt_through_api(a, t, q, 2048), golden.fwd_ntt(a, q, t))


def test_api_wide_modulus_fallback_hw(runtime):
    """A modulus of 62 bits through the public _NTT on the card.  The
    reference routes it to a second core; the port's kernels take every
    q < 2^62, so the same kernel serves it, bit for bit."""
    runtime()
    n = 1024
    q = nt.generate_primes(1, 61, n)[0]
    t = twiddles.ntt_tables(n, q)
    a = np.random.default_rng(7).integers(0, q, size=n, dtype=np.uint64)
    np.testing.assert_array_equal(_ntt_through_api(a, t, q, n), golden.fwd_ntt(a, q, t))


def test_api_wire_packed_keyswitch_hw(runtime, monkeypatch):
    """HEXL_TPU_WIRE_PACK=1 through the public API on the card: the packed
    route stays bit for bit."""
    monkeypatch.setenv("HEXL_TPU_WIRE_PACK", "1")
    runtime()
    vec = vectors.make_keyswitch_vector(1024, 2, 3, seed=4, modulus_bits=45)
    res = vec.input.copy()
    hexl.set_worksize_KeySwitch(1)
    hexl.KeySwitch(res, vec.t_target_iter_ptr, 1024, 2, 3, 3, 2, vec.moduli,
                   vec.key_vectors, vec.modswitch_factors, vec.twiddle_factors)
    assert hexl.KeySwitchCompleted()
    np.testing.assert_array_equal(res.ravel(), vec.expected_output.ravel())


def test_api_num_dev_2_hw(runtime):
    """Two workers (NUM_DEV=2) on the one card: KeySwitch, DyadicMultiply and
    _NTT through the API, in batches small enough that both workers serve,
    every op against the golden model; each worker's executor on a card."""
    pool = runtime(NUM_DEV=2, BATCH_SIZE_KEYSWITCH=2, BATCH_SIZE_DYADIC_MULTIPLY=2,
                   BATCH_SIZE_NTT=2)
    assert len(pool.devices) == 2
    assert all(d.executor.device.type == "cuda" for d in pool.devices)
    rng = np.random.default_rng(3)
    ops = 8

    vec = vectors.make_keyswitch_vector(1024, 2, 3, seed=9, modulus_bits=45)
    ks = [vec.input.copy() for _ in range(ops)]
    hexl.set_worksize_KeySwitch(ops)
    for r in ks:
        hexl.KeySwitch(r, vec.t_target_iter_ptr, 1024, 2, 3, 3, 2, vec.moduli,
                       vec.key_vectors, vec.modswitch_factors, vec.twiddle_factors)
    assert hexl.KeySwitchCompleted()
    for r in ks:
        np.testing.assert_array_equal(r, vec.expected_output)

    n, M = 4096, 3
    moduli = np.array(nt.generate_primes(M, 50, n), dtype=np.uint64)
    dy = []
    hexl.set_worksize_DyadicMultiply(ops)
    for _ in range(ops):
        a, b = (rng.integers(0, int(moduli.min()), size=2 * M * n, dtype=np.uint64)
                for _ in range(2))
        out = np.zeros(3 * M * n, dtype=np.uint64)
        dy.append((a, b, out))
        hexl.DyadicMultiply(out, a, b, n, moduli, M)
    assert hexl.DyadicMultiplyCompleted()
    for a, b, out in dy:
        np.testing.assert_array_equal(out, golden.dyadic_multiply(a, b, n, moduli, M))

    n = 16384
    q = nt.generate_primes(1, 51, n)[0]
    t = twiddles.ntt_tables(n, q)
    src = rng.integers(0, q, size=(ops, n), dtype=np.uint64)
    bufs = [s.copy() for s in src]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        hexl._set_worksize_NTT(ops)
        for b in bufs:
            hexl._NTT(b, t.fwd, t.fwd_precon, q, n)
    assert hexl._NTTCompleted()
    np.testing.assert_array_equal(np.stack(bufs), golden.fwd_ntt(src, q, t))
