"""The NTT-domain Galois apply (`ops/galois_cuda.py`): one index gather,
against the reference's sigma table and `jnp.take`, and as a pure permutation
of any 64-bit pattern.  Tolerance: zero."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hexl_fpga_tpu.ops import galois_mxu, word64 as jw
from hexl_fpga_tpu_torch.ops import galois_cuda, golden, nt, twiddles, word64 as w


@pytest.mark.parametrize("n", [8, 1024, 8192])
@pytest.mark.parametrize("g", [3, 5, 25, -1])
def test_sigma_and_apply_match_reference(n, g):
    g = g % (2 * n)  # -1 is the conjugation 2n - 1
    sigma = galois_cuda.ntt_galois_sigma(n, g)
    np.testing.assert_array_equal(sigma, galois_mxu.ntt_galois_sigma(n, g))
    assert sorted(sigma.tolist()) == list(range(n))
    rng = np.random.default_rng(n + g)
    # values >= 2^56 included: nothing is assumed canonical
    x = rng.integers(0, 1 << 63, size=(2, 3, n), dtype=np.uint64) * np.uint64(2) + np.uint64(1)
    x[0, 0, :4] = [0, (1 << 64) - 1, 1 << 56, (1 << 63) + 5]
    got = w.to_u64_np(galois_cuda.apply_galois(w.from_u64_np(x), g))
    np.testing.assert_array_equal(got, x[..., sigma])
    assert int(got.max()) >= 1 << 56
    lo, hi = jw.to_pair_np(x)
    idx = jnp.asarray(sigma)
    want = jw.from_pair_np(np.asarray(jnp.take(jnp.asarray(lo), idx, axis=-1)),
                           np.asarray(jnp.take(jnp.asarray(hi), idx, axis=-1)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("g", [3, 2 * 64 - 1])
def test_apply_is_the_automorphism_of_the_polynomial(g):
    """NTT(tau_g m) == NTT(m)[sigma_g] with tau_g: X -> X^g on Z_q[X]/(X^n+1)."""
    n = 64
    q = int(nt.generate_primes(1, 40, n)[0])
    t = twiddles.ntt_tables(n, q)
    rng = np.random.default_rng(g)
    m = rng.integers(0, q, size=n, dtype=np.uint64)
    tau = np.zeros(n, dtype=np.uint64)
    for i in range(n):
        e = (i * g) % (2 * n)
        tau[e % n] = m[i] if e < n else (q - int(m[i])) % q
    got = galois_cuda.apply_galois(w.from_u64_np(golden.fwd_ntt(m[None], q, t)), g)
    np.testing.assert_array_equal(w.to_u64_np(got), golden.fwd_ntt(tau[None], q, t))


def test_index_is_cached_per_n_g_device_and_inputs_are_checked():
    a = galois_cuda.galois_index(1024, 5, device="cpu")
    assert galois_cuda.galois_index(1024, 5 + 2048, device="cpu") is a
    assert galois_cuda.galois_index(1024, 7, device="cpu") is not a
    assert a.dtype == torch.int64 and a.device.type == "cpu"
    with pytest.raises(ValueError, match="odd"):
        galois_cuda.ntt_galois_sigma(1024, 4)
    with pytest.raises(ValueError, match="power of two"):
        galois_cuda.ntt_galois_sigma(1000, 3)
    with pytest.raises(TypeError, match="int64"):
        galois_cuda.apply_galois(torch.zeros(8, dtype=torch.int32), 3)
    # composition: tau_g then tau_h is tau_{gh}
    x = torch.arange(1024, dtype=torch.int64) * 7 - 3
    two = galois_cuda.apply_galois(galois_cuda.apply_galois(x, 5), 3)
    assert torch.equal(two, galois_cuda.apply_galois(x, 15))
