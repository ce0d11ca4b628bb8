"""The slice as a whole: the port's KeySwitchContext on the CPU (plain
versions of the kernels) vs the reference's KeySwitchTpuContext (Pallas
kernels in interpret mode) and vs the frozen vectors.  Tolerance: zero."""

import os

import numpy as np
import pytest

from hexl_fpga_tpu.ops import keyswitch_tpu
from hexl_fpga_tpu.utils import vectors as jvectors
from hexl_fpga_tpu_torch import convert
from hexl_fpga_tpu_torch.ops import golden, keyswitch_cuda, ntt_cuda, word64 as w
from hexl_fpga_tpu_torch.utils import vectors

TESTDATA = os.path.join(os.path.dirname(__file__), "testdata")


@pytest.fixture(scope="module")
def vec():
    return jvectors.make_keyswitch_vector(1024, 2, 3, seed=11, modulus_bits=45)


@pytest.fixture(scope="module")
def ref_ctx(vec):
    """ONE shared interpret-mode reference context, built with the arguments
    tests/test_keyswitch_tpu.py uses so the compile cache is shared."""
    return keyswitch_tpu.get_context(
        1024, 2, 3, 3, 2, vec.moduli, vec.twiddle_factors,
        tile_p=2, interpret=True,
    )


@pytest.fixture(scope="module")
def ctx(vec):
    return keyswitch_cuda.get_context(
        1024, 2, 3, 3, 2, vec.moduli, vec.twiddle_factors, device="cpu",
    )


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


def test_run_matches_reference_context(vec, ctx, ref_ctx):
    got = ctx.run(vec.input, vec.t_target_iter_ptr, vec.key_vectors,
                  vec.modswitch_factors)
    np.testing.assert_array_equal(got, vec.expected_output)
    ref = ref_ctx.run(vec.input, vec.t_target_iter_ptr, vec.key_vectors,
                      vec.modswitch_factors)
    np.testing.assert_array_equal(got, ref)
    # operands drawn from a seed, not a valid RLWE sample: still bit-identical
    rs, ts = random_ops(vec, 1, seed=21)
    got = ctx.run_batch(rs, ts, vec.key_vectors, vec.modswitch_factors)
    ref = ref_ctx.run_batch(rs, ts, vec.key_vectors, vec.modswitch_factors)
    np.testing.assert_array_equal(got, ref)


def test_builds_fed_the_same_staged_operands(vec, ctx, ref_ctx):
    """Stage once with the REFERENCE's own staging (u32 planes, (K, 4) msf4),
    carry the operands across with convert, run both device bodies."""
    rs, ts = random_ops(vec, 1, seed=22)
    n, L = 1024, 2
    t_lo, t_hi = w.to_pair_np(ts.reshape(1, L, n))
    r_lo, r_hi = w.to_pair_np(rs.reshape(1, 2, L, n))
    klo, khi, plo, phi = ref_ctx.device_keys(vec.key_vectors)
    msf4 = ref_ctx.prepare_msf4(vec.modswitch_factors)
    ref_lo, ref_hi = ref_ctx._fn(t_lo, t_hi, klo, khi, plo, phi, r_lo, r_hi, msf4)

    keys, kp = convert.staged_keys_from_pairs(klo, khi, plo, phi, device="cpu")
    msf = convert.msf_from_msf4(msf4)
    out = ctx._build(convert.pair_to_i64(t_lo, t_hi), keys, kp,
                     convert.pair_to_i64(r_lo, r_hi), msf)
    got_lo, got_hi = convert.i64_to_pair(out)
    np.testing.assert_array_equal(got_lo, np.asarray(ref_lo))
    np.testing.assert_array_equal(got_hi, np.asarray(ref_hi))
    # and the port's own staging produces the very same operands
    own_keys, own_kp = ctx.device_keys(vec.key_vectors)
    assert (own_keys == keys).all() and (own_kp == kp).all()
    np.testing.assert_array_equal(ctx.prepare_msf4(vec.modswitch_factors), msf)


@pytest.mark.parametrize("name", [
    "1024_2_3_3_2_0", "1024_2_3_3_2_1", "1024_5_7_6_2_0", "2048_3_4_4_2_0",
])
def test_frozen_vectors(name):
    v = vectors.load_json(os.path.join(TESTDATA, f"{name}.json"))
    c = keyswitch_cuda.get_context(
        v.coeff_count, v.decomp_modulus_size, v.key_modulus_size,
        v.rns_modulus_size, v.key_component_count, v.moduli,
        v.twiddle_factors, device="cpu",
    )
    got = c.run(v.input, v.t_target_iter_ptr, v.key_vectors, v.modswitch_factors)
    np.testing.assert_array_equal(got, v.expected_output)


def test_batch_and_computed_twiddles(vec):
    c = keyswitch_cuda.KeySwitchContext(1024, 2, 3, 3, 2, vec.moduli, None,
                                        device="cpu")
    rs, ts = random_ops(vec, 3, seed=23)
    rs[0], ts[0] = vec.input, vec.t_target_iter_ptr
    outs = c.run_batch(rs, ts, vec.key_vectors, vec.modswitch_factors)
    np.testing.assert_array_equal(outs[0], vec.expected_output)
    for b in range(3):
        want = golden.keyswitch(rs[b], ts[b], 1024, 2, 3, 3, 2, vec.moduli,
                                vec.key_vectors, vec.modswitch_factors)
        np.testing.assert_array_equal(outs[b], want)


def test_inactive_modulus_between_level_and_special_prime():
    """K > L + 1: the schedule transforms under the decomp moduli and the
    special prime only."""
    v = vectors.make_keyswitch_vector(1024, 2, 4, seed=3, modulus_bits=45)
    c = keyswitch_cuda.KeySwitchContext(1024, 2, 4, 3, 2, v.moduli,
                                        v.twiddle_factors, device="cpu")
    assert sorted(c._tabs) == [0, 1, 3]
    got = c.run(v.input, v.t_target_iter_ptr, v.key_vectors, v.modswitch_factors)
    np.testing.assert_array_equal(got, v.expected_output)


def test_unreduced_modswitch_factors(vec, ctx):
    msf = [int(m) + 3 * q for m, q in zip(vec.modswitch_factors, vec.moduli)]
    got = ctx.run(vec.input, vec.t_target_iter_ptr, vec.key_vectors, msf)
    np.testing.assert_array_equal(got, vec.expected_output)


def test_rns_is_fence_only(vec):
    for rns in (1, 4, 9):
        c = keyswitch_cuda.get_context(1024, 2, 3, rns, 2, vec.moduli,
                                       vec.twiddle_factors, device="cpu")
        got = c.run(vec.input, vec.t_target_iter_ptr, vec.key_vectors,
                    vec.modswitch_factors)
        np.testing.assert_array_equal(got, vec.expected_output)
    with pytest.raises(AssertionError):
        keyswitch_cuda.KeySwitchContext(1024, 2, 3, 0, 2, vec.moduli, None,
                                        device="cpu")


def test_device_key_cache(vec):
    c = keyswitch_cuda.KeySwitchContext(1024, 2, 3, 3, 2, vec.moduli, None,
                                        device="cpu")
    keys = [np.array(k, dtype=np.uint64) for k in vec.key_vectors]
    k1 = c.device_keys(keys)
    assert c.device_keys(keys)[0] is k1[0]
    assert k1[0].device == c.device and k1[1].device == c.device
    assert k1[0].shape == (2, 2, 3, 1024)
    # in-place mutation of a cached key buffer re-stages
    keys[0][:] = (keys[0] + np.uint64(1)) % np.uint64(vec.moduli[0])
    k2 = c.device_keys(keys)
    assert k2[0] is not k1[0]
    np.testing.assert_array_equal(
        w.to_u64_np(k2[0])[0].ravel(), keys[0])
    # precons are floor(key << 64 / q_j)
    kk, pp = w.to_u64_np(k2[0]), w.to_u64_np(k2[1])
    for idx in [(0, 0, 0, 0), (1, 1, 2, 1023), (0, 1, 1, 17)]:
        q = vec.moduli[idx[2]]
        assert int(pp[idx]) == (int(kk[idx]) << 64) // q


def test_context_cache_and_twiddle_keying(vec):
    a = keyswitch_cuda.get_context(1024, 2, 3, 3, 2, vec.moduli,
                                   vec.twiddle_factors, device="cpu")
    b = keyswitch_cuda.get_context(1024, 2, 3, 3, 2, vec.moduli,
                                   vec.twiddle_factors.copy(), device="cpu")
    c = keyswitch_cuda.get_context(1024, 2, 3, 3, 2, vec.moduli, None,
                                   device="cpu")
    assert a is b and a is not c
    assert c.psi == [None] * 3 and a.psi[0] is not None


@pytest.mark.parametrize("kwargs,match", [
    ({"plain_modulus": 65537}, "plain_modulus"),
    ({"fused_mac": True}, "fused_mac"),
    ({"mac_impl": "exact128"}, "exact128"),
    ({"fused_tail": False}, "fused_tail"),
])
def test_unported_options_raise(vec, kwargs, match):
    """These four options raised until they were ported; now each computes:
    the frozen vector's output, or under a plain modulus the golden BGV one."""
    c = keyswitch_cuda.KeySwitchContext(1024, 2, 3, 3, 2, vec.moduli, None,
                                        device="cpu", **kwargs)
    for option, value in kwargs.items():
        assert getattr(c, option) == value
    got = c.run(vec.input, vec.t_target_iter_ptr, vec.key_vectors,
                vec.modswitch_factors)
    if "plain_modulus" in kwargs:
        want = golden.keyswitch(vec.input, vec.t_target_iter_ptr, 1024, 2, 3, 3,
                                2, vec.moduli, vec.key_vectors,
                                vec.modswitch_factors, plain_modulus=65537)
        assert not np.array_equal(want, vec.expected_output)
    else:
        want = vec.expected_output
    np.testing.assert_array_equal(got, want, err_msg=match)


def test_wire_pack_raises(vec, ctx, monkeypatch):
    """HEXL_TPU_WIRE_PACK=1 packs host operands and gives the unpacked bits;
    only a device handle, already on the card, raises."""
    monkeypatch.setenv("HEXL_TPU_WIRE_PACK", "1")
    np.testing.assert_array_equal(
        ctx.run(vec.input, vec.t_target_iter_ptr, vec.key_vectors,
                vec.modswitch_factors), vec.expected_output)
    with pytest.raises(TypeError, match="HEXL_TPU_WIRE_PACK"):
        ctx.dispatch_batch(ctx.stage_ciphertext(vec.input[None]),
                           vec.t_target_iter_ptr[None], vec.key_vectors,
                           vec.modswitch_factors)


def test_cuda_request_without_cuda_raises(vec):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        keyswitch_cuda.KeySwitchContext(1024, 2, 3, 3, 2, vec.moduli, None)
    assert ntt_cuda.LAUNCHES["ntt_fwd"] == 0
