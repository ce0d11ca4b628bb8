"""Every constructor option of the port's KeySwitchContext on the CPU (plain
versions of the kernels) vs the reference context built with the same option
(Pallas kernels in interpret mode) and vs the golden model.  The two MAC
options are held against the reference's whole compiled program at B = 1; the
tails (unfused, BGV, both) against the reference's own `_sigma` and `_tail_j`
run eagerly on the same operands, which spares the minutes its whole program
takes to compile for them.  Tolerance: zero."""

import jax.numpy as jnp
import numpy as np
import pytest

from hexl_fpga_tpu.ops import keyswitch_tpu, word64 as jw
from hexl_fpga_tpu.utils import vectors as jvectors
from hexl_fpga_tpu_torch import convert
from hexl_fpga_tpu_torch.ops import golden, keyswitch_cuda, ntt_cuda, word64 as w
from hexl_fpga_tpu_torch.utils import vectors

T = 65537  # BGV plaintext modulus
CFG = (1024, 2, 3, 3, 2)

OPTIONS = {
    "fused_mac": {"fused_mac": True},
    "exact128": {"mac_impl": "exact128"},
    "unfused_tail": {"fused_tail": False},
    "bgv": {"plain_modulus": T},
    "bgv_unfused_tail": {"plain_modulus": T, "fused_tail": False},
}


@pytest.fixture(scope="module")
def vec():
    return jvectors.make_keyswitch_vector(1024, 2, 3, seed=11, modulus_bits=45)


@pytest.fixture(scope="module")
def bgv_vec():
    return jvectors.make_keyswitch_vector(1024, 2, 3, seed=11, modulus_bits=45,
                                          plain_modulus=T)


def random_ops(vec, B, seed):
    rng = np.random.default_rng(seed)
    L, n = vec.decomp_modulus_size, vec.coeff_count
    ts = np.stack([
        np.concatenate([rng.integers(0, vec.moduli[j], size=n, dtype=np.uint64)
                        for j in range(L)]) for _ in range(B)])
    rs = np.stack([
        np.concatenate([rng.integers(0, vec.moduli[j % L], size=n, dtype=np.uint64)
                        for j in range(2 * L)]) for _ in range(B)])
    return rs, ts


def port_ctx(v, **kw):
    return keyswitch_cuda.KeySwitchContext(
        v.coeff_count, v.decomp_modulus_size, v.key_modulus_size,
        v.rns_modulus_size, 2, v.moduli, v.twiddle_factors, device="cpu", **kw)


def golden_ks(v, r, t, plain_modulus=None):
    return golden.keyswitch(
        r, t, v.coeff_count, v.decomp_modulus_size, v.key_modulus_size,
        v.rns_modulus_size, 2, v.moduli, v.key_vectors, v.modswitch_factors,
        v.twiddle_factors, plain_modulus=plain_modulus)


def ref_ctx(v, **kw):
    """The reference context for an option; nothing compiles until it runs."""
    return keyswitch_tpu.KeySwitchTpuContext(
        *CFG, v.moduli, v.twiddle_factors, tile_p=2, interpret=True, **kw)


@pytest.mark.parametrize("name", list(OPTIONS))
def test_option_matches_golden(name, vec, bgv_vec):
    kw = OPTIONS[name]
    v = bgv_vec if "plain_modulus" in kw else vec
    c = port_ctx(v, **kw)
    got = c.run(v.input, v.t_target_iter_ptr, v.key_vectors, v.modswitch_factors)
    np.testing.assert_array_equal(got, v.expected_output)
    rs, ts = random_ops(v, 1, seed=51)  # not a valid RLWE sample: still exact
    got = c.run_batch(rs, ts, v.key_vectors, v.modswitch_factors)
    np.testing.assert_array_equal(
        got[0], golden_ks(v, rs[0], ts[0], kw.get("plain_modulus")))


@pytest.mark.parametrize("name", ["fused_mac", "exact128"])
def test_mac_option_matches_reference_context(name, vec):
    kw = OPTIONS[name]
    rs, ts = random_ops(vec, 1, seed=51)
    got = port_ctx(vec, **kw).run_batch(rs, ts, vec.key_vectors,
                                        vec.modswitch_factors)
    ref = ref_ctx(vec, **kw).run_batch(rs, ts, vec.key_vectors,
                                       vec.modswitch_factors)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("name", ["unfused_tail", "bgv", "bgv_unfused_tail"])
def test_tail_option_matches_reference_tail(name, bgv_vec):
    """`_sigma` and `_tail_j` of both packages on the same INTT2 output e,
    lazy MAC sums acc and caller rows res, for every decomp modulus."""
    kw = OPTIONS[name]
    v = bgv_vec
    c, ref = port_ctx(v, **kw), ref_ctx(v, **kw)
    n, L, comp, B = c.n, c.L, c.comp, 2
    rng = np.random.default_rng(53)
    e = rng.integers(0, c.qk, size=(comp * B, n), dtype=np.uint64)
    acc = rng.integers(0, 1 << 56, size=(comp, B, n), dtype=np.uint64)
    res = np.stack([rng.integers(0, v.moduli[j], size=(B, comp, n), dtype=np.uint64)
                    for j in range(L)], axis=2)
    pair = lambda a: tuple(jnp.asarray(p) for p in jw.to_pair_np(a))
    e_t, e_p = w.from_u64_np(e), pair(e)
    sigma = sigma_p = None
    if c.plain_modulus is not None:
        sigma, sigma_p = c._sigma(e_t), ref._sigma(e_p)
        np.testing.assert_array_equal(
            w.to_u64_np(sigma), w.to_u64_np(convert.pair_to_i64(*sigma_p)))
        assert int(w.to_u64_np(sigma).max()) < T
    msf = c.prepare_msf4(v.modswitch_factors)
    msf4 = jnp.asarray(ref.prepare_msf4(v.modswitch_factors))
    for j in range(L):
        got = c._tail_j(j, e_t, w.from_u64_np(acc), w.from_u64_np(res), msf, sigma)
        outs = ref._tail_j(j, e_p, [pair(acc[k]) for k in range(comp)],
                           [pair(res[:, k, j]) for k in range(comp)], msf4,
                           sigma_p)
        for k in range(comp):
            np.testing.assert_array_equal(
                w.to_u64_np(got[:, k]),
                w.to_u64_np(convert.pair_to_i64(*outs[k])), err_msg=f"{j}, {k}")


# the four options that raised before they were ported now compute
@pytest.mark.parametrize("kwargs", [
    {"plain_modulus": T}, {"fused_mac": True}, {"mac_impl": "exact128"},
    {"fused_tail": False},
])
def test_options_in_a_batch_with_computed_twiddles(vec, bgv_vec, kwargs):
    v = bgv_vec if "plain_modulus" in kwargs else vec
    c = keyswitch_cuda.KeySwitchContext(*CFG, v.moduli, None, device="cpu",
                                        **kwargs)
    rs, ts = random_ops(v, 3, seed=52)
    rs[1], ts[1] = v.input, v.t_target_iter_ptr
    outs = c.run_batch(rs, ts, v.key_vectors, v.modswitch_factors)
    np.testing.assert_array_equal(outs[1], v.expected_output)
    base = port_ctx(v, plain_modulus=kwargs.get("plain_modulus"))
    np.testing.assert_array_equal(
        outs, base.run_batch(rs, ts, v.key_vectors, v.modswitch_factors))


def count_mac_calls(monkeypatch):
    calls = []
    real = ntt_cuda.ntt_fwd_mac

    def counting(data, keys, kp, j, tabs, skip_i=None):
        calls.append((j, skip_i))
        return real(data, keys, kp, j, tabs, skip_i)

    monkeypatch.setattr(ntt_cuda, "ntt_fwd_mac", counting)
    return calls


def test_fused_mac_engines_and_their_skipped_limbs(vec, monkeypatch):
    calls = count_mac_calls(monkeypatch)
    c = port_ctx(vec, fused_mac=True)
    got = c.run(vec.input, vec.t_target_iter_ptr, vec.key_vectors,
                vec.modswitch_factors)
    np.testing.assert_array_equal(got, vec.expected_output)
    # special engine: column K - 1, nothing skipped; decomp engine j skips j
    assert calls == [(2, None), (0, 0), (1, 1)]


def test_fused_mac_with_one_decomp_modulus_builds_no_decomp_engine(monkeypatch):
    """L == 1: the decomp engine's only term is the identity limb, which the
    glue adds; a skip_i engine would have nothing to sum."""
    v = vectors.make_keyswitch_vector(1024, 1, 2, seed=4, modulus_bits=45)
    calls = count_mac_calls(monkeypatch)
    c = port_ctx(v, fused_mac=True)
    got = c.run(v.input, v.t_target_iter_ptr, v.key_vectors, v.modswitch_factors)
    np.testing.assert_array_equal(got, v.expected_output)
    assert calls == [(1, None)]


@pytest.mark.parametrize("kwargs", [{"fused_mac": True}, {"mac_impl": "exact128"},
                                    {"fused_tail": False}])
def test_inactive_modulus_between_level_and_special_prime(kwargs):
    """K > L + 1: the special engine reads key column K - 1, not L."""
    v = vectors.make_keyswitch_vector(1024, 2, 4, seed=3, modulus_bits=45)
    got = port_ctx(v, **kwargs).run(v.input, v.t_target_iter_ptr, v.key_vectors,
                                    v.modswitch_factors)
    np.testing.assert_array_equal(got, v.expected_output)


def test_fused_mac_with_exact128_is_refused_by_name(vec):
    with pytest.raises(ValueError, match="fused_mac=True and mac_impl='exact128'"):
        port_ctx(vec, fused_mac=True, mac_impl="exact128")
    with pytest.raises(AssertionError):
        port_ctx(vec, mac_impl="harvey")


def test_bgv_fix_constants_match_reference(bgv_vec):
    v = bgv_vec
    c = port_ctx(v, plain_modulus=T)
    ref = keyswitch_tpu.KeySwitchTpuContext(
        *CFG, v.moduli, None, tile_p=2, interpret=True, plain_modulus=T)
    assert c._fix == ref._fix and c._qk_mod == ref._qk_mod
    assert (c.t_half, c.inv_qk_t, c.qk_half_t, c.t_barr) == (
        ref.t_half, ref.inv_qk_t, ref.qk_half_t, ref.t_barr)
    plain = port_ctx(v)
    assert plain.plain_modulus is None and plain._fix != c._fix


def test_bgv_context_guards(bgv_vec):
    v = bgv_vec
    with pytest.raises(AssertionError, match="coprime"):
        port_ctx(v, plain_modulus=v.moduli[-1])
    with pytest.raises(AssertionError, match=">= 2"):
        port_ctx(v, plain_modulus=1)
    with pytest.raises(AssertionError, match="below every"):
        port_ctx(v, plain_modulus=max(v.moduli) + 2)


def test_get_context_caches_per_plain_modulus_and_mac_impl(bgv_vec):
    v = bgv_vec
    a = keyswitch_cuda.get_context(*CFG, v.moduli, device="cpu")
    b = keyswitch_cuda.get_context(*CFG, v.moduli, device="cpu", plain_modulus=T)
    c = keyswitch_cuda.get_context(*CFG, v.moduli, device="cpu",
                                   mac_impl="exact128")
    assert a is not b and a is not c
    assert a.plain_modulus is None and b.plain_modulus == T
    assert c.mac_impl == "exact128"
    assert keyswitch_cuda.get_context(*CFG, v.moduli, device="cpu") is a
    assert keyswitch_cuda.get_context(*CFG, v.moduli, device="cpu",
                                      plain_modulus=np.uint64(T)) is b
