"""Hoisted keyswitch of the port (decompose once, apply many, deferred Galois
permutation) on the CPU vs `run_batch` and vs the reference's hoist /
run_hoisted (Pallas kernels in interpret mode).  Tolerance: zero; the
decomposition planes are compared mod q (the reference's are lazy)."""

import numpy as np
import pytest

from hexl_fpga_tpu.ops import keyswitch_tpu
from hexl_fpga_tpu.utils import vectors as jvectors
from hexl_fpga_tpu_torch import convert
from hexl_fpga_tpu_torch.ops import galois_cuda, keyswitch_cuda, word64 as w
from hexl_fpga_tpu_torch.utils import vectors

N, L, K, COMP = 1024, 2, 3, 2
G = 5


@pytest.fixture(scope="module")
def vec():
    return jvectors.make_keyswitch_vector(N, L, K, seed=11, modulus_bits=45)


@pytest.fixture(scope="module")
def ref_ctx(vec):
    """ONE shared interpret-mode reference context, built with the arguments
    tests/test_keyswitch_tpu.py uses so the compile cache is shared."""
    return keyswitch_tpu.get_context(
        N, L, K, 3, 2, vec.moduli, vec.twiddle_factors,
        tile_p=2, interpret=True,
    )


@pytest.fixture(scope="module")
def ctx(vec):
    return keyswitch_cuda.get_context(
        N, L, K, 3, 2, vec.moduli, vec.twiddle_factors, device="cpu",
    )


@pytest.fixture(scope="module")
def dec(vec, ctx):
    return ctx.hoist(vec.t_target_iter_ptr[None])


@pytest.fixture(scope="module")
def ref_dec(vec, ref_ctx):
    return ref_ctx.hoist(np.asarray(vec.t_target_iter_ptr, np.uint64)[None])


def test_run_hoisted_equals_run_batch(vec, ctx, dec):
    assert dec.batch == 1 and dec.data.shape == (L + 1, L, N)
    args = (dec, vec.input[None], vec.key_vectors, vec.modswitch_factors)
    out = ctx.run_hoisted(*args)
    np.testing.assert_array_equal(out.to_host()[0], vec.expected_output)
    np.testing.assert_array_equal(
        out.to_host(),
        ctx.run_batch(vec.input[None], vec.t_target_iter_ptr[None],
                      vec.key_vectors, vec.modswitch_factors))
    # identity permutation == no permutation (the perm path itself is exact)
    out2 = ctx.run_hoisted(*args, perm=np.arange(N, dtype=np.int32))
    np.testing.assert_array_equal(out2.to_host()[0], vec.expected_output)
    # a staged target and a staged ciphertext serve as well
    dec2 = ctx.hoist(ctx.stage_target(vec.t_target_iter_ptr[None]))
    out3 = ctx.run_hoisted(dec2, ctx.stage_ciphertext(vec.input[None]),
                           vec.key_vectors, vec.modswitch_factors)
    np.testing.assert_array_equal(out3.to_host()[0], vec.expected_output)


def test_decomposition_planes_equal_reference_mod_q(vec, ctx, dec, ref_dec):
    ours = w.to_u64_np(dec.data)
    theirs = w.to_u64_np(convert.pair_to_i64(ref_dec.dlo, ref_dec.dhi))
    assert ours.shape == theirs.shape
    for plane, j in enumerate((*range(L), K - 1)):
        q = np.uint64(vec.moduli[j])
        assert int(ours[plane].max()) < int(q)  # the port's are canonical
        np.testing.assert_array_equal(ours[plane], theirs[plane] % q)


def test_reference_decomposition_feeds_the_ports_apply(vec, ctx, ref_dec):
    carried = convert.decomposition_from_pairs(ref_dec.dlo, ref_dec.dhi, ctx)
    assert isinstance(carried, keyswitch_cuda.DeviceDecomposition)
    assert carried.batch == 1
    out = ctx.run_hoisted(carried, vec.input[None], vec.key_vectors,
                          vec.modswitch_factors)
    np.testing.assert_array_equal(out.to_host()[0], vec.expected_output)


@pytest.mark.parametrize("mode", ["perm", "galois"])
def test_deferred_permutation_matches_reference(vec, ctx, ref_ctx, dec, ref_dec, mode):
    sigma = galois_cuda.ntt_galois_sigma(N, G)
    ct = np.asarray(vec.input, np.uint64)[None]
    kw = {"perm": sigma.astype(np.int32)} if mode == "perm" else {"galois": G}
    got = ctx.run_hoisted(dec, ct, vec.key_vectors, vec.modswitch_factors,
                          **kw).to_host()
    ref = ref_ctx.run_hoisted(ref_dec, ct, vec.key_vectors,
                              vec.modswitch_factors, **kw).to_host()
    np.testing.assert_array_equal(got, ref)


def test_deferred_permutation_identity(vec, ctx, dec):
    """run_hoisted(perm=sigma) == sigma(run_batch(res, t, sigma^-1(keys))):
    keys staged pre-permuted, the apply gather-free, one output gather; and
    galois=g is the same apply with the cached index."""
    sigma = galois_cuda.ntt_galois_sigma(N, G)
    inv = np.empty_like(sigma)
    inv[sigma] = np.arange(N)
    ct = vec.input[None]
    out = ctx.run_hoisted(dec, ct, vec.key_vectors, vec.modswitch_factors,
                          perm=sigma).to_host()[0]
    keys_perm = [
        np.asarray(kv, np.uint64).reshape(COMP, K, N)[..., inv].reshape(-1)
        for kv in vec.key_vectors
    ]
    inner = ctx.run_batch(ct, vec.t_target_iter_ptr[None], keys_perm,
                          vec.modswitch_factors)[0]
    np.testing.assert_array_equal(
        out, inner.reshape(COMP, L, N)[..., sigma].reshape(-1))
    via_g = ctx.run_hoisted(dec, ct, vec.key_vectors, vec.modswitch_factors,
                            galois=G).to_host()[0]
    np.testing.assert_array_equal(via_g, out)
    # the conjugation 2n - 1, and g taken mod 2n
    conj = ctx.run_hoisted(dec, ct, vec.key_vectors, vec.modswitch_factors,
                           galois=2 * N - 1).to_host()
    also = ctx.run_hoisted(dec, ct, vec.key_vectors, vec.modswitch_factors,
                           galois=-1).to_host()
    np.testing.assert_array_equal(conj, also)
    assert not np.array_equal(conj[0], out)


def test_compact_planes_at_a_reduced_level():
    """K > L + 1: the decomposition holds L + 1 planes (decomp moduli, then
    the special prime) and run_hoisted still equals run_batch."""
    v = vectors.make_keyswitch_vector(N, 2, 4, seed=3, modulus_bits=45)
    c = keyswitch_cuda.KeySwitchContext(N, 2, 4, 3, 2, v.moduli,
                                        v.twiddle_factors, device="cpu")
    d = c.hoist(v.t_target_iter_ptr[None])
    assert d.data.shape[0] == c.L + 1
    out = c.run_hoisted(d, v.input[None], v.key_vectors, v.modswitch_factors)
    np.testing.assert_array_equal(out.to_host()[0], v.expected_output)


@pytest.mark.parametrize("kwargs", [
    {"mac_impl": "exact128"}, {"fused_tail": False}, {"fused_mac": True},
])
def test_hoisted_apply_under_options_in_a_batch(vec, kwargs):
    c = keyswitch_cuda.KeySwitchContext(N, L, K, 3, 2, vec.moduli,
                                        vec.twiddle_factors, device="cpu",
                                        **kwargs)
    rng = np.random.default_rng(61)
    ts = np.stack([vec.t_target_iter_ptr] + [
        np.concatenate([rng.integers(0, vec.moduli[j], size=N, dtype=np.uint64)
                        for j in range(L)]) for _ in range(2)])
    rs = np.stack([vec.input] * 3)
    out = c.run_hoisted(c.hoist(ts), rs, vec.key_vectors,
                        vec.modswitch_factors).to_host()
    np.testing.assert_array_equal(out[0], vec.expected_output)
    np.testing.assert_array_equal(
        out, c.run_batch(rs, ts, vec.key_vectors, vec.modswitch_factors))


def test_permuted_key_cache_is_an_lru_of_perm_cache_slots(vec, monkeypatch):
    c = keyswitch_cuda.KeySwitchContext(N, L, K, 3, 2, vec.moduli, None,
                                        device="cpu")
    monkeypatch.setattr(keyswitch_cuda.KeySwitchContext, "PERM_CACHE_SLOTS", 3)
    sig = [galois_cuda.ntt_galois_sigma(N, g) for g in (3, 5, 7, 9)]
    first = c.device_keys(vec.key_vectors, hoist_perm=sig[0])
    assert c.device_keys(vec.key_vectors, hoist_perm=sig[0])[0] is first[0]
    # staged pre-permuted by sigma^-1, precons recomputed for the permuted keys
    inv = np.empty_like(sig[0])
    inv[sig[0]] = np.arange(N)
    plain = c.device_keys(vec.key_vectors)
    assert (first[0] == plain[0][..., inv]).all()
    assert (first[1] == plain[1][..., inv]).all()
    c.device_keys(vec.key_vectors, hoist_perm=sig[1])
    c.device_keys(vec.key_vectors, hoist_perm=sig[0])  # refresh: 1 is oldest
    c.device_keys(vec.key_vectors, hoist_perm=sig[2])
    assert len(c._key_cache_perm) == 3
    c.device_keys(vec.key_vectors, hoist_perm=sig[3])  # evicts sigma 1
    assert len(c._key_cache_perm) == 3
    assert c.device_keys(vec.key_vectors, hoist_perm=sig[0])[0] is first[0]
    assert keyswitch_cuda.KeySwitchContext.PERM_CACHE_SLOTS == 3
    # the unpermuted cache is separate and untouched
    assert c.device_keys(vec.key_vectors)[0] is plain[0]


def test_hoisted_key_stack_and_guards(vec, ctx, dec):
    sig = [galois_cuda.ntt_galois_sigma(N, g) for g in (3, 5)]
    keys, kp = ctx.hoisted_key_stack(vec.key_vectors, sig)
    assert keys.shape == kp.shape == (2, L, COMP, K, N)
    for s, p in enumerate(sig):
        one = ctx.device_keys(vec.key_vectors, hoist_perm=p)
        assert (keys[s] == one[0]).all() and (kp[s] == one[1]).all()
    two = np.stack([vec.input] * 2)
    with pytest.raises(AssertionError, match="decomposition batch 1"):
        ctx.run_hoisted(dec, two, vec.key_vectors, vec.modswitch_factors)
    with pytest.raises(AssertionError, match="either galois or perm"):
        ctx.run_hoisted(dec, vec.input[None], vec.key_vectors,
                        vec.modswitch_factors, perm=sig[0], galois=3)
