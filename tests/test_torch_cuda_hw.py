"""The port's hardware tier, the counterpart of tests/test_tpu_hw.py: runs
only with HEXL_TORCH_HW_TESTS=1 on a machine with a CUDA device, and skips
everywhere else.  It imports nothing of JAX or of the JAX package, so on a
machine without JAX it runs without the suite's conftest:

  HEXL_TORCH_HW_TESTS=1 python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_hw.py -q

Every result is held bit for bit against the golden model or a frozen
vector; the entry points are the port's (`ntt_cuda`,
`keyswitch_cuda.get_context`, the API), each on the card.
"""

import gc
import glob
import os
import threading
import warnings
import weakref

import numpy as np
import pytest
import torch

import hexl_fpga_tpu_torch as hexl
from hexl_fpga_tpu_torch import config as config_mod
from hexl_fpga_tpu_torch.ops import golden, keyswitch_cuda, nt, ntt_cuda, twiddles, word64 as w64
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


# -- dispatch_batch's CUDA graphs of the body --------------------------------


def _bench_context():
    """A fresh context at the benchmark's vector, 16384_6_7_7_2."""
    files = sorted(glob.glob(os.path.join(TESTDATA, "16384_6_7_7_2_*.json*")))
    vec = vectors.load_json(files[0])
    ctx = keyswitch_cuda.KeySwitchContext(
        vec.coeff_count, vec.decomp_modulus_size, vec.key_modulus_size,
        vec.rns_modulus_size, 2, vec.moduli, vec.twiddle_factors)
    return vec, ctx


def _staged_ops(vec, ctx, B, seed):
    """B random (accumulator, target) pairs as device handles."""
    rng = np.random.default_rng(seed)
    L, n = ctx.L, ctx.n
    rs = np.stack([np.concatenate([rng.integers(0, vec.moduli[j % L], size=n,
                                                dtype=np.uint64)
                                   for j in range(2 * L)]) for _ in range(B)])
    ts = np.stack([np.concatenate([rng.integers(0, vec.moduli[j], size=n,
                                                dtype=np.uint64)
                                   for j in range(L)]) for _ in range(B)])
    return ctx.stage_ciphertext(rs), ctx.stage_target(ts)


def _eager(ctx, vec, r, t):
    keys, kp = ctx.device_keys(vec.key_vectors)
    return ctx._build(t.data, keys, kp, r.data, ctx.prepare_msf4(vec.modswitch_factors))


def _program(ctx):
    (prog,) = [e.program for e in ctx._graphs.values() if e.program is not None]
    return prog


@pytest.mark.parametrize("B", [1, 32])
def test_dispatch_graph_replay_equals_eager_build_hw(B):
    """At the benchmark vector: the first dispatch eager, the second captures,
    the third replays; each equal to eager _build bit for bit, and each
    counting the body's 7 / 7 / 6 / 7 launches: the kernels that ran."""
    vec, ctx = _bench_context()
    r, t = _staged_ops(vec, ctx, B, seed=B)
    want = _eager(ctx, vec, r, t)
    before = dict(keyswitch_cuda.GRAPHS)
    L = ctx.L
    body = {**dict.fromkeys(ntt_cuda.LAUNCHES, 0), "ntt_fwd": L + 1,
            "ntt_inv": L + 1, "ntt_fwd_tail": L, "keyswitch_mac": L + 1}
    for _ in range(3):
        launched = dict(ntt_cuda.LAUNCHES)
        got = ctx.dispatch_batch(r, t, vec.key_vectors, vec.modswitch_factors)
        assert got.is_contiguous() and torch.equal(got, want)
        assert {k: v - launched[k] for k, v in ntt_cuda.LAUNCHES.items()} == body
    assert {k: v - before[k] for k, v in keyswitch_cuda.GRAPHS.items()} == {
        "captures": 1, "replays": 2, "eager": 1}
    assert _program(ctx).graph is not None


def test_dispatch_graph_outlives_its_key_set_in_the_cache_hw():
    """Nine other key sets push the captured set out of the key LRU and the
    cache frees it; the graph holds its own tensors and replays, over
    memory the allocator has handed out again, to the same bits."""
    vec, ctx = _bench_context()
    r, t = _staged_ops(vec, ctx, 32, seed=5)
    want = _eager(ctx, vec, r, t)
    for _ in range(2):
        ctx.dispatch_batch(r, t, vec.key_vectors, vec.modswitch_factors)
    first = weakref.ref(ctx.device_keys(vec.key_vectors)[0])
    for s in range(9):
        ctx.device_keys([np.roll(k, s + 1) for k in vec.key_vectors])
    assert ctx.device_keys(vec.key_vectors)[0] is not first()  # re-staged
    assert first() is not None  # held by the graph alone
    torch.cuda.empty_cache()
    junk = torch.full((256 << 20,), -1, dtype=torch.int64, device="cuda")
    got = _program(ctx)(t.data.transpose(0, 1), r.data.permute(2, 1, 0, 3))
    assert torch.equal(got, want)
    del junk


def test_dispatch_graph_captures_again_after_its_pool_emptied_hw():
    """Every graph of the context dropped, the key captures anew into the
    context's pool, which outlives its programs, and replays to the same
    bits."""
    vec, ctx = _bench_context()
    r, t = _staged_ops(vec, ctx, 8, seed=7)
    want = _eager(ctx, vec, r, t)
    before = dict(keyswitch_cuda.GRAPHS)
    for _ in range(2):
        for _ in range(3):
            got = ctx.dispatch_batch(r, t, vec.key_vectors, vec.modswitch_factors)
            assert torch.equal(got, want)
        ctx._graphs.clear()
        gc.collect()
        torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in keyswitch_cuda.GRAPHS.items()} == {
        "captures": 2, "replays": 4, "eager": 2}


def test_dispatch_graph_reads_only_what_it_staged_hw(monkeypatch):
    """Once captured, the program looks nothing up: it replays with
    device_keys refused, to the same bits."""
    vec, ctx = _bench_context()
    r, t = _staged_ops(vec, ctx, 32, seed=6)
    want = _eager(ctx, vec, r, t)
    for _ in range(2):
        ctx.dispatch_batch(r, t, vec.key_vectors, vec.modswitch_factors)

    def refused(*args, **kwargs):
        raise AssertionError("the program looked a key set up in the cache")

    monkeypatch.setattr(ctx, "device_keys", refused)
    got = _program(ctx)(t.data.transpose(0, 1), r.data.permute(2, 1, 0, 3))
    assert torch.equal(got, want)


def test_dispatch_graph_two_threads_on_one_context_hw():
    """Two threads, each on a stream of its own, dispatch 100 batches each
    on one context: one thread batches of 4, the other batches of 4 and 8 in
    turn, so one graph's static inputs are shared and two graphs share the
    context's memory pool.  Every result equals eager _build."""
    vec, ctx = _bench_context()
    inputs = {"a": [_staged_ops(vec, ctx, 4, seed=10)],
              "b": [_staged_ops(vec, ctx, 4, seed=11), _staged_ops(vec, ctx, 8, seed=12)]}
    want = {k: [_eager(ctx, vec, r, t) for r, t in v] for k, v in inputs.items()}
    got = {k: [] for k in inputs}
    errors = []

    def worker(name):
        try:
            with torch.cuda.stream(torch.cuda.Stream()):
                for i in range(100):
                    j = i % len(inputs[name])
                    r, t = inputs[name][j]
                    got[name].append((j, ctx.dispatch_batch(
                        r, t, vec.key_vectors, vec.modswitch_factors)))
                torch.cuda.current_stream().synchronize()
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(k,)) for k in inputs]
    before = dict(keyswitch_cuda.GRAPHS)
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors
    torch.cuda.synchronize()
    assert all(len(v) == 100 for v in got.values())
    for name, outs in got.items():
        for i, (j, out) in enumerate(outs):
            assert torch.equal(out, want[name][j]), (name, i)
    d = {k: v - before[k] for k, v in keyswitch_cuda.GRAPHS.items()}
    assert d["captures"] == 2 and d["replays"] + d["eager"] == 200, d


def test_dispatch_graphs_evicted_under_two_threads_hw():
    """Two threads, each on a stream of its own, cycle through five batch
    sizes each, three dispatches a size in a row: ten keys on one context,
    more than its KEY_CACHE_SLOTS, so graphs leave the cache while the other
    thread's replays may still be pending, and their static inputs and keys
    go back to the allocator.  Every result equals eager _build."""
    vec, ctx = _bench_context()
    sizes = {"a": [1, 2, 3, 4, 5], "b": [6, 7, 8, 9, 10]}
    assert len(sizes["a"]) + len(sizes["b"]) > ctx.KEY_CACHE_SLOTS
    inputs = {k: [_staged_ops(vec, ctx, B, seed=20 + B) for B in v] for k, v in sizes.items()}
    want = {k: [_eager(ctx, vec, r, t) for r, t in v] for k, v in inputs.items()}
    got = {k: [] for k in inputs}
    errors = []

    def worker(name):
        try:
            with torch.cuda.stream(torch.cuda.Stream()):
                for i in range(60):
                    j = (i // 3) % len(inputs[name])
                    r, t = inputs[name][j]
                    got[name].append((j, ctx.dispatch_batch(
                        r, t, vec.key_vectors, vec.modswitch_factors)))
                    # allocations on this stream, which may take freed blocks
                    torch.empty((1 << 20,), dtype=torch.int64, device="cuda").fill_(-1)
                torch.cuda.current_stream().synchronize()
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(k,)) for k in inputs]
    before = dict(keyswitch_cuda.GRAPHS)
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors
    torch.cuda.synchronize()
    for name, outs in got.items():
        assert len(outs) == 60
        for i, (j, out) in enumerate(outs):
            assert torch.equal(out, want[name][j]), (name, i)
    d = {k: v - before[k] for k, v in keyswitch_cuda.GRAPHS.items()}
    assert d["captures"] > len(ctx._graphs) and d["replays"] + d["eager"] == 120, d
    assert len(ctx._graphs) <= ctx.KEY_CACHE_SLOTS


def test_bfv_evaluator_replays_the_eager_multiply_hw():
    """DeviceBfvEvaluator.multiply on the card: its first call captures the
    level's BEHZ program and replays it, later calls replay; each replay
    equals the eager composition and, row by row, the host BehzTool, and
    rns_behz_cuda.GRAPHS counts one capture, the replays and the eager body."""
    from hexl_fpga_tpu_torch.integrations import BfvContext, DeviceBfvEvaluator
    from hexl_fpga_tpu_torch.integrations.ckks import Ciphertext
    from hexl_fpga_tpu_torch.ops import rns_behz_cuda

    n, k, B = 1024, 3, 4
    ctx = BfvContext(n, [int(p) for p in nt.generate_primes(k + 1, 52, n)], 65537, seed=5)
    ev = DeviceBfvEvaluator(ctx, "cuda")
    rng = np.random.default_rng(5)
    qcol = np.array(ctx.moduli[:k], dtype=np.uint64).reshape(1, 1, k, 1)
    c1, c2 = (rng.integers(0, 1 << 62, size=(B, 2, k, n), dtype=np.uint64) % qcol
              for _ in range(2))
    x1, x2 = ev.stage(c1), ev.stage(c2)
    before = dict(rns_behz_cuda.GRAPHS)
    got = [ev.multiply(x1, x2) for _ in range(2)]
    eager = ctx._behz_cuda(k, ev.device).multiply_tensors(x1, x2)
    assert all(torch.equal(g, eager) for g in got)
    counted = {key: rns_behz_cuda.GRAPHS[key] - v for key, v in before.items()}
    assert counted == {"captures": 1, "replays": 2, "eager": 1}, counted
    out = ev.to_host(got[0])
    for b in (0, B - 1):
        want, _ = ctx.multiply_rns(*(Ciphertext(data=c[b], level=k - 1, scale=1.0)
                                     for c in (c1, c2)), device=False)
        np.testing.assert_array_equal(out[b], want)


def _behz_on_card(n, k, bits, t, aux_bits=None, moduli=None):
    """BehzCuda on the card over k primes of `bits` bits (or `moduli`), with
    its tool's q tables."""
    from hexl_fpga_tpu_torch.ops import rns_behz, rns_behz_cuda

    q = moduli or [int(p) for p in nt.generate_primes(k, bits, n)]
    tabs = [twiddles.ntt_tables(n, m) for m in q]
    tool = rns_behz.BehzTool(n, q, t, aux_bits=aux_bits)
    return rns_behz_cuda.BehzCuda(tool, tabs, "cuda"), tabs


def _canonical(rng, moduli, shape):
    """Random canonical words below each modulus, the moduli along the first
    axis (or along axis 2 for (B, 2, k, n) ciphertexts), on the card."""
    axis = 0 if len(shape) == 3 else 2
    col = np.array(moduli, dtype=np.uint64).reshape(
        [-1 if a == axis else 1 for a in range(len(shape))])
    return w64.from_u64_np(rng.integers(0, 1 << 63, size=shape, dtype=np.uint64) % col,
                           "cuda")


def _cell_moduli():
    """The cell bfv16384.behz_multiply's q: the frozen vector 16384_6_7_7_2's
    six 52-bit decomp primes."""
    vec = vectors.load_json(os.path.join(TESTDATA, "16384_6_7_7_2_0.json.gz"))
    return [int(m) for m in vec.moduli[:vec.decomp_modulus_size]]


# case -> (n, k, bits, t, aux_bits) of the conversion kernels' tests
_BEHZ_CASES = {
    "k2_45": (4096, 2, 45, 65537, None), "k3_45": (4096, 3, 45, 65537, None),
    "k7_52": (4096, 7, 52, 65537, None), "k8_52": (4096, 8, 52, 65537, None),
    "bsk61": (4096, 4, 45, 257, 61),
    # above MAX_K = 8: the same kernels with the limbs in a scratch tensor
    "k9_45": (4096, 9, 45, 65537, None), "k13_50": (4096, 13, 50, 65537, None),
    "bsk61_k10": (4096, 10, 45, 257, 61),
}


@pytest.mark.parametrize("case", ["cell", *_BEHZ_CASES])
def test_behz_conversion_kernels_equal_the_plain_lane_math_hw(case):
    """behz_extend and behz_floor_sk bit for bit against the torch lane math
    they replace, one launch each: at the cell's shape (k = 6, 32 rows
    extended and 24 floored, n = 16384, 52-bit q and 53-bit Bsk), at k = 2
    and 3 with 45-bit primes, at k = 7 and 8 (MAX_K, the largest k held in
    registers), at k = 9 and 13 (limbs in a scratch tensor), and at 62-bit
    Bsk primes, where a conversion sum of lazy terms is reduced in groups
    smaller than k, below and above MAX_K."""
    from hexl_fpga_tpu_torch.ops import rns_behz_cuda

    rows = (32, 24)
    if case == "cell":
        n, k = 16384, 6
        behz, _ = _behz_on_card(n, k, 52, 65537, moduli=_cell_moduli())
        assert [m.bit_length() for m in behz.tool.Bsk] == [53] * (k + 1)
    else:
        n, k, bits, t, aux_bits = _BEHZ_CASES[case]
        behz, _ = _behz_on_card(n, k, bits, t, aux_bits=aux_bits)
        if aux_bits:
            assert behz._q_to_bsk.group < k and max(behz.tool.Bsk) > 1 << 61
    T, rng = behz.tool, np.random.default_rng(k)
    x = _canonical(rng, T.q, (k, rows[0], n))
    d_q, d_bsk = _canonical(rng, T.q, (k, rows[1], n)), _canonical(rng, T.Bsk, (k + 1, rows[1], n))
    before = dict(rns_behz_cuda.LAUNCHES)
    got = (behz.extend_to_bsk(x), behz.floor_sk(d_q, d_bsk))
    assert {key: v - before[key] for key, v in rns_behz_cuda.LAUNCHES.items()} == \
        {"behz_extend": 1, "behz_floor_sk": 1}
    torch.cuda.synchronize()
    assert torch.equal(got[0], behz._extend_to_bsk_plain(x))
    assert torch.equal(got[1], behz._floor_sk_plain(d_q, d_bsk))


@pytest.mark.parametrize("case", ["cell", "k10"])
def test_behz_program_replays_the_plain_composition_hw(case, monkeypatch):
    """BehzCuda.program(B) at the cell's chain (B = 8), and at k = 10 above
    MAX_K (B = 2, the kernels' scratch allocated inside the capture): its
    replay equals the eager composition on the kernels, the composition on
    the plain lane math and, row by row, BehzTool.multiply; one multiply
    launches behz_extend and behz_floor_sk once each, eager and replayed."""
    from hexl_fpga_tpu_torch.ops import rns_behz_cuda

    if case == "cell":
        n, k, B = 16384, 6, 8
        behz, tabs = _behz_on_card(n, k, 52, 65537, moduli=_cell_moduli())
    else:
        n, k, B = 4096, 10, 2
        behz, tabs = _behz_on_card(n, k, 50, 65537)
    rng = np.random.default_rng(8)
    c1, c2 = (_canonical(rng, behz.tool.q, (B, 2, k, n)) for _ in range(2))
    program = behz.program(B)
    assert program.graph is not None

    def launched(fn):
        before = dict(rns_behz_cuda.LAUNCHES)
        out = fn()
        return out, {key: v - before[key] for key, v in rns_behz_cuda.LAUNCHES.items()}

    once = {"behz_extend": 1, "behz_floor_sk": 1}
    replay, counted = launched(lambda: program(c1, c2))
    assert counted == once
    eager, counted = launched(lambda: behz.multiply_tensors(c1, c2))
    assert counted == once
    monkeypatch.setattr(rns_behz_cuda, "kernel_path", lambda device: False)
    plain, counted = launched(lambda: behz.multiply_tensors(c1, c2))
    assert counted == dict.fromkeys(once, 0)
    assert torch.equal(replay, eager) and torch.equal(replay, plain)
    out, a, b = (w64.to_u64_np(v) for v in (replay, c1, c2))
    for row in (0, B - 1):
        np.testing.assert_array_equal(out[row], behz.tool.multiply(a[row], b[row], tabs))
