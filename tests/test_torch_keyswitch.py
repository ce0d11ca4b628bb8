"""The slice as a whole: the port's KeySwitchContext on the CPU (plain
versions of the kernels) vs the reference's KeySwitchTpuContext (Pallas
kernels in interpret mode) and vs the frozen vectors.  Tolerance: zero."""

import gc
import os
import sys
import threading
import weakref

import numpy as np
import pytest
import torch

from hexl_fpga_tpu.ops import keyswitch_tpu
from hexl_fpga_tpu.utils import vectors as jvectors
from hexl_fpga_tpu_torch import convert
from hexl_fpga_tpu_torch.ops import dyadic_cuda, golden, keyswitch_cuda, ntt_cuda, word64 as w
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


# -- dispatch_batch's graphs of the body ---------------------------------------


class StubProgram:
    """GraphProgram's stand-in on the CPU: it keeps contiguous static
    inputs, as the captured graph does, and runs the composition on them."""

    def __init__(self, run, *examples, queue=None, warm=True, holds=()):
        self.run, self.queue, self.warm, self.holds = run, queue, warm, holds
        self.ins = [x.clone(memory_format=torch.contiguous_format) for x in examples]
        self.calls = 0

    def __call__(self, *xs):
        for static, x in zip(self.ins, xs):
            static.copy_(x)
        self.calls += 1
        return self.run(*self.ins).clone()


@pytest.fixture
def graphed(vec):
    """A CPU context whose dispatch_batch builds StubPrograms (made, in
    order), and GRAPHS' counts from zero."""
    c = keyswitch_cuda.KeySwitchContext(1024, 2, 3, 3, 2, vec.moduli,
                                        vec.twiddle_factors, device="cpu")
    made = []

    def factory(*args, **kwargs):
        made.append(StubProgram(*args, **kwargs))
        return made[-1]

    c._graph_program = factory
    for k in keyswitch_cuda.GRAPHS:
        keyswitch_cuda.GRAPHS[k] = 0
    return c, made


def dispatch(c, rs, ts, keys, msf):
    return w.to_u64_np(c.dispatch_batch(rs, ts, keys, msf)).reshape(rs.shape[0], -1)


def test_dispatch_captures_on_a_keys_second_dispatch(vec, graphed):
    """First dispatch eager, second captures and replays, later ones replay;
    every result the eager body's bits."""
    c, made = graphed
    rs, ts = random_ops(vec, 3, seed=5)
    keyed = (vec.key_vectors, vec.modswitch_factors)
    want = c.run_batch(rs, ts, *keyed)
    assert made == [] and keyswitch_cuda.GRAPHS == {"captures": 0, "replays": 0,
                                                    "eager": 1}
    for i in range(3):
        np.testing.assert_array_equal(dispatch(c, rs, ts, *keyed), want)
        assert len(made) == 1 and made[0].calls == i + 1
    assert keyswitch_cuda.GRAPHS == {"captures": 1, "replays": 3, "eager": 1}
    prog = made[0]
    assert prog.queue is c._graph_queue and prog.warm is False
    assert prog.holds == c.device_keys(vec.key_vectors)
    # the static inputs are limb-major: (L, B, n) targets, (L, comp, B, n) results
    assert [tuple(x.shape) for x in prog.ins] == [(2, 3, 1024), (2, 2, 3, 1024)]
    assert all(x.is_contiguous() for x in prog.ins)


@pytest.mark.parametrize("change", ["batch", "restaged_keys", "modswitch"])
def test_dispatch_captures_anew_for_another_key(vec, graphed, change):
    """Another B, a key set re-staged after an in-place mutation (as in
    test_device_key_cache) or other modswitch factors is another graph: it
    too runs eager once, then captures."""
    c, made = graphed
    keys = [np.array(k, dtype=np.uint64) for k in vec.key_vectors]
    msf = list(vec.modswitch_factors)
    rs, ts = random_ops(vec, 2, seed=6)
    for _ in range(2):
        dispatch(c, rs, ts, keys, msf)
    assert len(made) == 1
    if change == "batch":
        rs, ts = rs[:1], ts[:1]
    elif change == "restaged_keys":
        keys[0][:] = (keys[0] + np.uint64(1)) % np.uint64(vec.moduli[0])
    else:
        msf[0] = (msf[0] + 1) % vec.moduli[0]
    want = c.run_batch(rs, ts, keys, msf)  # eager: the new key's first dispatch
    assert len(made) == 1
    np.testing.assert_array_equal(dispatch(c, rs, ts, keys, msf), want)
    assert len(made) == 2 and made[1].calls == 1
    assert keyswitch_cuda.GRAPHS == {"captures": 2, "replays": 2, "eager": 2}


def test_dispatch_graphs_are_lru_bounded(vec, graphed):
    """At most KEY_CACHE_SLOTS entries; the least recently used leaves first,
    and its program and static tensors are released."""
    c, made = graphed
    slots = c.KEY_CACHE_SLOTS
    rs, ts = random_ops(vec, slots + 1, seed=7)
    keyed = (vec.key_vectors, vec.modswitch_factors)
    for B in range(1, slots + 2):
        for _ in range(3):  # eager, capture, replay
            dispatch(c, rs[:B], ts[:B], *keyed)
    assert len(made) == slots + 1 and len(c._graphs) == slots
    first = weakref.ref(made[0])
    static = [weakref.ref(x) for x in made[0].ins]
    made.clear()
    gc.collect()
    assert first() is None and all(s() is None for s in static)
    # the newest, B = slots + 1, replays; the evicted B = 1 runs eager again
    counts = dict(keyswitch_cuda.GRAPHS)
    dispatch(c, rs, ts, *keyed)
    dispatch(c, rs[:1], ts[:1], *keyed)
    assert keyswitch_cuda.GRAPHS["eager"] == counts["eager"] + 1
    assert keyswitch_cuda.GRAPHS["replays"] == counts["replays"] + 1
    assert len(c._graphs) == slots


def test_dispatch_graph_holds_its_keys_past_the_key_cache(vec, graphed):
    """A graph replays raw pointers: its entry keeps the key and precon
    tensors it was captured with alive after the key cache evicted them, and
    replays to the same bits; the set's next dispatch, staged anew, is
    another key."""
    c, made = graphed
    rs, ts = random_ops(vec, 2, seed=8)
    msf = vec.modswitch_factors
    keys = [np.array(k, dtype=np.uint64) for k in vec.key_vectors]
    want = c.run_batch(rs, ts, keys, msf)
    dispatch(c, rs, ts, keys, msf)
    staged = [weakref.ref(x) for x in c.device_keys(keys)]
    for s in range(c.KEY_CACHE_SLOTS):  # other key sets push it out
        c.device_keys([np.roll(k, s + 1) for k in keys])
    gc.collect()
    assert all(x() is not None for x in staged)
    assert c.device_keys(keys)[0] is not staged[0]()  # re-staged
    prog = made[0]
    np.testing.assert_array_equal(
        w.to_u64_np(prog(*(torch.from_numpy(a.view(np.int64)) for a in (
            ts.reshape(2, 2, 1024).transpose(1, 0, 2),
            rs.reshape(2, 2, 2, 1024).transpose(2, 1, 0, 3))))).reshape(2, -1),
        want)
    np.testing.assert_array_equal(dispatch(c, rs, ts, keys, msf), want)
    assert len(made) == 1  # the re-staged set: a new key, eager
    assert keyswitch_cuda.GRAPHS["eager"] == 2


def test_dispatch_off_the_card_is_eager(vec):
    """A CPU context builds no graph: every dispatch counts as eager."""
    c = keyswitch_cuda.KeySwitchContext(1024, 2, 3, 3, 2, vec.moduli, None,
                                        device="cpu")
    assert c._graph_program is None
    before = dict(keyswitch_cuda.GRAPHS)
    for _ in range(3):
        c.run(vec.input, vec.t_target_iter_ptr, vec.key_vectors,
              vec.modswitch_factors)
    assert keyswitch_cuda.GRAPHS == {**before, "eager": before["eager"] + 3}
    assert len(c._graphs) == 0


def test_dispatch_graph_cache_under_many_threads(vec, graphed):
    """Twelve threads dispatch on one context, three batch sizes among them,
    with the interpreter switching threads as often as it can: each key
    captures once, every dispatch replays or runs eager, and every result is
    the eager body's."""
    c, made = graphed
    rs, ts = random_ops(vec, 3, seed=9)
    keyed = (vec.key_vectors, vec.modswitch_factors)
    want = {B: c.run_batch(rs[:B], ts[:B], *keyed) for B in (1, 2, 3)}
    for k in keyswitch_cuda.GRAPHS:
        keyswitch_cuda.GRAPHS[k] = 0
    c._graphs.clear()
    wrong, errors = [], []

    def worker(i):
        try:
            for j in range(3):
                B = 1 + (i + j) % 3
                if not np.array_equal(dispatch(c, rs[:B], ts[:B], *keyed), want[B]):
                    wrong.append((i, j))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(12)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert not errors and not wrong, (errors, wrong)
    assert len(made) == 3
    graphs = keyswitch_cuda.GRAPHS
    # a key's dispatches while another thread captures it run eager
    assert graphs["captures"] == 3 and graphs["eager"] >= 3, graphs
    assert graphs["replays"] + graphs["eager"] == 12 * 3, graphs


def test_dispatch_capture_waits_for_measured_reuse(vec, graphed):
    """Graphs that leave the cache without a replay raise the dispatch on
    which a key captures; a key that then repeats still captures, on that
    dispatch, and its first replay lowers it again.  Every result is the
    eager body's."""
    c, made = graphed
    plain = keyswitch_cuda.KeySwitchContext(1024, 2, 3, 3, 2, vec.moduli,
                                            vec.twiddle_factors, device="cpu")
    slots = c.KEY_CACHE_SLOTS
    rs, ts = random_ops(vec, slots + 2, seed=10)
    keyed = (vec.key_vectors, vec.modswitch_factors)
    want = {B: plain.run_batch(rs[:B], ts[:B], *keyed) for B in range(1, slots + 3)}
    for k in keyswitch_cuda.GRAPHS:
        keyswitch_cuda.GRAPHS[k] = 0
    for B in range(1, slots + 3):  # each key twice, then gone
        for _ in range(2):
            np.testing.assert_array_equal(dispatch(c, rs[:B], ts[:B], *keyed), want[B])
    # B = slots + 1 and + 2 each pushed out an unreplayed graph
    assert len(made) == slots and c._need == 4
    assert keyswitch_cuda.GRAPHS == {"captures": slots, "replays": slots,
                                     "eager": slots + 4}
    B = slots + 2  # dispatched twice already: the fourth dispatch captures
    np.testing.assert_array_equal(dispatch(c, rs[:B], ts[:B], *keyed), want[B])
    assert len(made) == slots
    np.testing.assert_array_equal(dispatch(c, rs[:B], ts[:B], *keyed), want[B])
    assert len(made) == slots + 1 and c._need == 4
    np.testing.assert_array_equal(dispatch(c, rs[:B], ts[:B], *keyed), want[B])
    assert made[-1].calls == 2 and c._need == 3


def test_launches_inside_a_capture_count_on_replay():
    """A launch while this thread captures runs nothing: it goes into the
    capture's record, not into LAUNCHES or the thread's own counts; each
    replay counts the record (GraphProgram)."""
    before = (dict(ntt_cuda.LAUNCHES), dict(dyadic_cuda.LAUNCHES))
    with ntt_cuda.thread_launches() as mine:
        with ntt_cuda.captured_launches() as record:
            ntt_cuda.count_launch(ntt_cuda.LAUNCHES, "ntt_fwd")
            ntt_cuda.count_launch(dyadic_cuda.LAUNCHES, "dyadic_mul")
        assert (dict(ntt_cuda.LAUNCHES), dict(dyadic_cuda.LAUNCHES)) == before
        assert record == [(ntt_cuda.LAUNCHES, "ntt_fwd"),
                          (dyadic_cuda.LAUNCHES, "dyadic_mul")]
        assert set(mine.values()) == {0}
        ntt_cuda.count_launch(ntt_cuda.LAUNCHES, "ntt_fwd", 3)
        ntt_cuda.count_launch(dyadic_cuda.LAUNCHES, "dyadic_mul", 2)
    assert ntt_cuda.LAUNCHES["ntt_fwd"] == before[0]["ntt_fwd"] + 3
    assert dyadic_cuda.LAUNCHES["dyadic_mul"] == before[1]["dyadic_mul"] + 2
    assert mine == {**dict.fromkeys(mine, 0), "ntt_fwd": 3}
