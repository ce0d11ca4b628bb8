"""Device handles and chains of the port's KeySwitchContext on the CPU vs
sequential calls and vs the reference's handles and compiled chains (Pallas
kernels in interpret mode).  Tolerance: zero."""

import numpy as np
import pytest

from hexl_fpga_tpu.ops import keyswitch_tpu
from hexl_fpga_tpu.utils import vectors as jvectors
from hexl_fpga_tpu_torch import convert
from hexl_fpga_tpu_torch.ops import keyswitch_cuda, word64 as w

N, L, K = 1024, 2, 3


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
def key_sets(vec):
    """A second key set over the SAME moduli: each (comp, K, n) plane rolled
    by 7 along n (values stay canonical per modulus plane)."""
    keys2 = [
        np.roll(np.asarray(kv, np.uint64).reshape(2, K, N), 7, axis=-1).reshape(-1)
        for kv in vec.key_vectors
    ]
    return [vec.key_vectors, keys2]


def test_run_device_with_handles_and_host_arrays(vec, ctx, ref_ctx):
    h_ct = ctx.stage_ciphertext(vec.input[None])
    h_t = ctx.stage_target(vec.t_target_iter_ptr[None])
    assert (h_ct.batch, h_t.batch) == (1, 1)
    assert h_ct.data.shape == (1, 2, L, N) and h_t.data.shape == (1, L, N)
    assert h_ct.data.device == ctx.device
    out1 = ctx.run_device(h_ct, h_t, vec.key_vectors, vec.modswitch_factors)
    assert out1.synchronize() is out1
    np.testing.assert_array_equal(out1.to_host()[0], vec.expected_output)
    # chain: the output handle feeds the next op's accumulator directly
    out2 = ctx.run_device(out1, h_t, vec.key_vectors, vec.modswitch_factors)
    want2 = ctx.run(vec.expected_output, vec.t_target_iter_ptr,
                    vec.key_vectors, vec.modswitch_factors)
    np.testing.assert_array_equal(out2.to_host()[0], want2)
    # host arrays are accepted in place of handles
    out3 = ctx.run_device(vec.input[None], vec.t_target_iter_ptr[None],
                          vec.key_vectors, vec.modswitch_factors)
    np.testing.assert_array_equal(out3.to_host()[0], vec.expected_output)
    # the reference's handles, link by link
    r_t = ref_ctx.stage_target(vec.t_target_iter_ptr[None])
    r1 = ref_ctx.run_device(vec.input[None], r_t, vec.key_vectors,
                            vec.modswitch_factors)
    r2 = ref_ctx.run_device(r1, r_t, vec.key_vectors, vec.modswitch_factors)
    np.testing.assert_array_equal(out2.to_host(), r2.to_host())


def test_staged_forms_cross_between_the_packages(vec, ctx, ref_ctx):
    r_ct = ref_ctx.stage_ciphertext(vec.input[None])
    r_t = ref_ctx.stage_target(vec.t_target_iter_ptr[None])
    h_ct = convert.handle_from_data32(r_ct.data32, ctx)
    h_t = convert.handle_from_data32(r_t.data32, ctx)
    assert isinstance(h_ct, keyswitch_cuda.DeviceCiphertext)
    assert isinstance(h_t, keyswitch_cuda.DeviceTarget)
    assert (h_ct.data == ctx.stage_ciphertext(vec.input[None]).data).all()
    assert (h_t.data == ctx.stage_target(vec.t_target_iter_ptr[None]).data).all()
    np.testing.assert_array_equal(convert.i64_to_interleaved(h_ct.data),
                                  np.asarray(r_ct.data32))
    out = ctx.run_device(h_ct, h_t, vec.key_vectors, vec.modswitch_factors)
    np.testing.assert_array_equal(out.to_host()[0], vec.expected_output)
    # and back: the port's output as the reference's next accumulator
    back = keyswitch_tpu.DeviceCiphertext(
        np.asarray(convert.i64_to_interleaved(out.data)), ref_ctx)
    np.testing.assert_array_equal(back.to_host(), out.to_host())


@pytest.mark.parametrize("depth", [1, 3])
def test_run_device_chain_matches_sequential_and_reference(vec, ctx, ref_ctx, depth):
    h_t = ctx.stage_target(vec.t_target_iter_ptr[None])
    cur = ctx.stage_ciphertext(vec.input[None])
    for _ in range(depth):
        cur = ctx.run_device(cur, h_t, vec.key_vectors, vec.modswitch_factors)
    chained = ctx.run_device_chain(
        vec.input[None], vec.t_target_iter_ptr[None], vec.key_vectors,
        vec.modswitch_factors, depth=depth)
    np.testing.assert_array_equal(chained.to_host(), cur.to_host())
    ref = ref_ctx.run_device_chain(
        vec.input[None], vec.t_target_iter_ptr[None], vec.key_vectors,
        vec.modswitch_factors, depth=depth)
    np.testing.assert_array_equal(chained.to_host(), ref.to_host())


@pytest.mark.parametrize("schedule", [[1, 0], [0, 1, 1]])
def test_run_device_chain_keyed_matches_sequential_and_reference(
        vec, ctx, ref_ctx, key_sets, schedule):
    h_t = ctx.stage_target(vec.t_target_iter_ptr[None])
    cur = ctx.stage_ciphertext(vec.input[None])
    for s in schedule:
        cur = ctx.run_device(cur, h_t, key_sets[s], vec.modswitch_factors)
    chained = ctx.run_device_chain_keyed(
        vec.input[None], vec.t_target_iter_ptr[None], key_sets,
        vec.modswitch_factors, schedule)
    np.testing.assert_array_equal(chained.to_host(), cur.to_host())
    if len(schedule) == 2:  # the reference compiles one program per length
        ref = ref_ctx.run_device_chain_keyed(
            vec.input[None], vec.t_target_iter_ptr[None], key_sets,
            vec.modswitch_factors, schedule)
        np.testing.assert_array_equal(chained.to_host(), ref.to_host())


def test_no_host_copy_between_links(vec, ctx, key_sets, monkeypatch):
    h_t = ctx.stage_target(vec.t_target_iter_ptr[None])
    h_ct = ctx.stage_ciphertext(vec.input[None])
    for ks in key_sets:
        ctx.device_keys(ks)  # resident before the count starts
    copies = {"up": 0, "down": 0}
    up, down = w.from_u64_np, w.to_u64_np

    def count_up(*a, **k):
        copies["up"] += 1
        return up(*a, **k)

    def count_down(*a, **k):
        copies["down"] += 1
        return down(*a, **k)

    monkeypatch.setattr(w, "from_u64_np", count_up)
    monkeypatch.setattr(w, "to_u64_np", count_down)
    a = ctx.run_device_chain(h_ct, h_t, vec.key_vectors,
                             vec.modswitch_factors, depth=3)
    b = ctx.run_device_chain_keyed(a, h_t, key_sets, vec.modswitch_factors,
                                   [1, 0, 1])
    c = ctx.run_device(b, h_t, key_sets[1], vec.modswitch_factors)
    assert copies == {"up": 0, "down": 0}
    c.to_host()
    assert copies == {"up": 0, "down": 1}


def test_schedule_and_handle_guards(vec, ctx, key_sets):
    args = (vec.input[None], vec.t_target_iter_ptr[None], key_sets,
            vec.modswitch_factors)
    with pytest.raises(AssertionError):
        ctx.run_device_chain_keyed(*args, [])
    with pytest.raises(AssertionError):
        ctx.run_device_chain_keyed(*args, [0, -1])
    with pytest.raises(AssertionError, match="past key_sets"):
        ctx.run_device_chain_keyed(*args, [0, 2])
    other = keyswitch_cuda.KeySwitchContext(N, L, K, 3, 2, vec.moduli, None,
                                            device="cpu")
    with pytest.raises(AssertionError):
        ctx.run_device(other.stage_ciphertext(vec.input[None]),
                       vec.t_target_iter_ptr[None], vec.key_vectors,
                       vec.modswitch_factors)
    with pytest.raises(AssertionError):
        ctx.run_device(vec.input[None],
                       other.stage_target(vec.t_target_iter_ptr[None]),
                       vec.key_vectors, vec.modswitch_factors)


def test_chain_under_an_option(vec):
    """Chains run the context's own schedule: fused engines, BGV tail."""
    c = keyswitch_cuda.KeySwitchContext(N, L, K, 3, 2, vec.moduli,
                                        vec.twiddle_factors, device="cpu",
                                        fused_mac=True, plain_modulus=65537)
    chained = c.run_device_chain(vec.input[None], vec.t_target_iter_ptr[None],
                                 vec.key_vectors, vec.modswitch_factors, depth=2)
    one = c.run(vec.input, vec.t_target_iter_ptr, vec.key_vectors,
                vec.modswitch_factors)
    two = c.run(one, vec.t_target_iter_ptr, vec.key_vectors,
                vec.modswitch_factors)
    np.testing.assert_array_equal(chained.to_host()[0], two)
