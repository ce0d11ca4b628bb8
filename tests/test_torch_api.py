"""The port's public API through its async runtime: worksize/Completed,
fences, batching, validation, RUN_CHOICE 0/1/2.  Tolerance: zero."""

import threading

import numpy as np
import pytest
import torch

import hexl_fpga_tpu as jhexl
import hexl_fpga_tpu_torch as hexl
from hexl_fpga_tpu import api as japi, config as jconfig
from hexl_fpga_tpu_torch import api, config as config_mod
from hexl_fpga_tpu_torch.ops import golden, nt
from hexl_fpga_tpu_torch.runtime import executors, scheduler
from hexl_fpga_tpu_torch.utils import vectors
from hexl_fpga_tpu_torch.utils.debug import HexlAssertError

N, L, K = 1024, 2, 3


@pytest.fixture(scope="module")
def vec():
    return vectors.make_keyswitch_vector(N, L, K, seed=2, modulus_bits=45)


@pytest.fixture
def runtime(monkeypatch):
    """acquire under the environment a test sets; always release."""
    started = []

    def start(**env):
        for k, v in env.items():
            monkeypatch.setenv(k, str(v))
        config_mod.reset_config()
        hexl.acquire_FPGA_resources()
        started.append(True)
        return scheduler.pool()

    yield start
    hexl.release_FPGA_resources()
    config_mod.reset_config()


def keyswitch(vec, result, t=None, **over):
    a = dict(n=N, decomp_modulus_size=L, key_modulus_size=K,
             rns_modulus_size=L + 1, key_component_count=2,
             moduli=vec.moduli, k_switch_keys=vec.key_vectors,
             modswitch_factors=vec.modswitch_factors,
             twiddle_factors=vec.twiddle_factors)
    a.update(over)
    hexl.KeySwitch(result, vec.t_target_iter_ptr if t is None else t, **a)


@pytest.mark.parametrize("run_choice", [0, 1])
@pytest.mark.parametrize("worksize", [1, 5])
def test_keyswitch_worksize_completed(vec, runtime, run_choice, worksize):
    runtime(RUN_CHOICE=run_choice, BATCH_SIZE_KEYSWITCH=4)
    results = [vec.input.copy() for _ in range(worksize)]
    hexl.set_worksize_KeySwitch(worksize)
    for r in results:
        keyswitch(vec, r)
    assert hexl.KeySwitchCompleted()
    for r in results:
        np.testing.assert_array_equal(r, vec.expected_output)


def test_worksize_one_is_synchronous_and_resets(vec, runtime):
    pool = runtime(RUN_CHOICE=1)
    r = vec.input.copy()
    keyswitch(vec, r)  # default worksize 1: done on return
    np.testing.assert_array_equal(r, vec.expected_output)
    hexl.set_worksize_KeySwitch(3)
    rs = [vec.input.copy() for _ in range(3)]
    for x in rs:
        keyswitch(vec, x)
    assert hexl.KeySwitchCompleted()
    assert pool._worksize[scheduler.KEYSWITCH] == 1
    r2 = vec.input.copy()
    keyswitch(vec, r2)
    np.testing.assert_array_equal(r2, vec.expected_output)


class _Recorder:
    """Executor stub: records batch sizes and fence flags, computes nothing."""

    def __init__(self):
        self.batches = []
        self.thread = None

    def bind_thread(self):
        self.thread = threading.current_thread().name

    def run_batch(self, batch):
        self.batches.append([i.fence for i in batch])


def _pool_with_recorder(monkeypatch, **env):
    for k, v in env.items():
        monkeypatch.setenv(k, str(v))
    config_mod.reset_config()
    rec = _Recorder()
    return scheduler.DevicePool(lambda i: rec), rec


def test_promised_worksize_runs_in_full_batches(monkeypatch):
    """A worksize of N ops runs as ceil(N / batch) batches however fast the
    worker drains the queue: it waits for ops the caller has promised."""
    # a loaded machine may stall the enqueuing thread: wait as long as it takes
    monkeypatch.setattr(scheduler.Buffer, "LINGER_S", 30.0)
    pool, rec = _pool_with_recorder(monkeypatch, BATCH_SIZE_KEYSWITCH=4)
    try:
        for _ in range(3):
            pool.set_worksize(scheduler.KEYSWITCH, 10)
            for i in range(10):
                pool.enqueue(scheduler.KEYSWITCH, ("cfg",), {"i": i})
            assert pool.completed(scheduler.KEYSWITCH)
        assert [len(b) for b in rec.batches] == [4, 4, 2] * 3
        assert rec.thread == "hexl-tpu-device-0"  # bound on the worker thread
    finally:
        pool.release()
        config_mod.reset_config()


def test_fence_on_parameter_change_splits_batches(monkeypatch):
    monkeypatch.setattr(scheduler.Buffer, "LINGER_S", 30.0)
    pool, rec = _pool_with_recorder(monkeypatch, BATCH_SIZE_KEYSWITCH=8)
    try:
        pool.set_worksize(scheduler.KEYSWITCH, 6)
        for key in ("a", "a", "a", "b", "b", "a"):
            pool.enqueue(scheduler.KEYSWITCH, (key,), {})
        assert pool.completed(scheduler.KEYSWITCH)
        assert rec.batches == [[True, False, False], [True, False], [True]]
    finally:
        pool.release()
        config_mod.reset_config()


def test_broken_promise_does_not_hang(monkeypatch):
    """Completed() before the promised count: the worker gives up waiting."""
    monkeypatch.setattr(scheduler.Buffer, "LINGER_S", 0.05)
    pool, rec = _pool_with_recorder(monkeypatch, BATCH_SIZE_KEYSWITCH=8)
    try:
        pool.set_worksize(scheduler.KEYSWITCH, 8)
        for _ in range(3):
            pool.enqueue(scheduler.KEYSWITCH, ("cfg",), {})
        assert pool.completed(scheduler.KEYSWITCH)
        assert sum(len(b) for b in rec.batches) == 3
    finally:
        pool.release()
        config_mod.reset_config()


def test_executor_error_surfaces_on_completed(monkeypatch):
    class Boom(_Recorder):
        def run_batch(self, batch):
            raise ValueError("boom")

    config_mod.reset_config()
    pool = scheduler.DevicePool(lambda i: Boom())
    try:
        with pytest.raises(ValueError, match="boom"):
            pool.enqueue(scheduler.KEYSWITCH, ("cfg",), {})
    finally:
        pool.release()


def test_keys_change_fences_and_both_sets_compute(vec, runtime):
    runtime(RUN_CHOICE=1, BATCH_SIZE_KEYSWITCH=8)
    vec2 = vectors.make_keyswitch_vector(N, L, K, seed=9, modulus_bits=45)
    assert vec2.moduli == vec.moduli
    rs = [vec.input.copy(), vec2.input.copy(), vec.input.copy()]
    hexl.set_worksize_KeySwitch(3)
    keyswitch(vec, rs[0])
    keyswitch(vec2, rs[1], t=vec2.t_target_iter_ptr)
    keyswitch(vec, rs[2])
    assert hexl.KeySwitchCompleted()
    np.testing.assert_array_equal(rs[0], vec.expected_output)
    np.testing.assert_array_equal(rs[1], vec2.expected_output)
    np.testing.assert_array_equal(rs[2], vec.expected_output)


@pytest.mark.parametrize("over", [
    {"n": 999},
    {"n": 32768},
    {"decomp_modulus_size": 0},
    {"key_modulus_size": 8},
    {"rns_modulus_size": 0},
    {"key_modulus_size": 2},  # not above decomp_modulus_size
    {"key_component_count": 3},
    {"moduli": None},
    {"moduli": [17, 1 << 20, 1 << 20]},
    {"moduli": [1 << 20, 1 << 20, (1 << 52) + 1]},
    {"k_switch_keys": None},
    {"modswitch_factors": None},
])
def test_keyswitch_validation(vec, runtime, over):
    runtime(RUN_CHOICE=1)
    with pytest.raises(HexlAssertError):
        keyswitch(vec, vec.input.copy(), **over)


def test_null_buffers_and_worksize_validation(vec, runtime):
    runtime(RUN_CHOICE=1)
    with pytest.raises(HexlAssertError):
        keyswitch(vec, None)
    with pytest.raises(HexlAssertError):
        hexl.KeySwitch(vec.input.copy(), None, N, L, K, L + 1, 2, vec.moduli,
                       vec.key_vectors, vec.modswitch_factors)
    with pytest.raises(HexlAssertError):
        hexl.set_worksize_KeySwitch(0)


def test_not_ported_entry_points_raise(vec, runtime):
    """What is left unported raises by name; the 14 functions of the header
    are all there, with the reference's signatures."""
    import inspect

    runtime(RUN_CHOICE=1)
    assert api.acquire_GPU_resources is api.acquire_FPGA_resources
    assert api.release_GPU_resources is api.release_FPGA_resources
    names = [n for n, f in vars(japi).items()
             if inspect.isfunction(f) and f.__module__ == japi.__name__
             and n != "_deprecated" and "_TPU_" not in n]
    assert len(names) == 14
    for name in names:
        assert getattr(hexl, name) is getattr(api, name)
        assert (inspect.signature(getattr(api, name))
                == inspect.signature(getattr(japi, name))), name


@pytest.mark.parametrize("run_choice", [0, 1])
def test_keyswitch_plain_modulus_equals_golden(vec, runtime, run_choice):
    """The BGV tail through the API: fenced apart from the plain ops that
    share its keys, equal to the golden BGV model."""
    runtime(RUN_CHOICE=run_choice, BATCH_SIZE_KEYSWITCH=4)
    want = golden.keyswitch(vec.input, vec.t_target_iter_ptr, N, L, K, L + 1, 2,
                            vec.moduli, vec.key_vectors, vec.modswitch_factors,
                            vec.twiddle_factors, plain_modulus=65537)
    assert not np.array_equal(want, vec.expected_output)
    rs = [vec.input.copy() for _ in range(3)]
    hexl.set_worksize_KeySwitch(3)
    keyswitch(vec, rs[0], plain_modulus=65537)
    keyswitch(vec, rs[1])
    keyswitch(vec, rs[2], plain_modulus=np.int64(65537))
    assert hexl.KeySwitchCompleted()
    np.testing.assert_array_equal(rs[0], want)
    np.testing.assert_array_equal(rs[1], vec.expected_output)
    np.testing.assert_array_equal(rs[2], want)


@pytest.mark.parametrize("t", [1, 0, 2 ** 45])
def test_keyswitch_plain_modulus_validation(vec, runtime, t):
    runtime(RUN_CHOICE=1)
    bad = t if t < 2 else int(vec.moduli[1]) * 3  # shares a factor with q_1
    with pytest.raises(HexlAssertError, match="plain_modulus"):
        keyswitch(vec, vec.input.copy(), plain_modulus=bad)


# -- DyadicMultiply section ---------------------------------------------------


def ramp_io(num_ops, num_moduli, n):
    """The reference's ramp stimulus (`tests/test_dyadic_multiply.cpp:32-109`):
    per op its own composite moduli 10, 20, 30, ... and raw operands far
    beyond 4q, flat in the API's [2][M][n] layout."""
    i = np.arange(n, dtype=np.uint64)
    moduli, op1, op2 = [], [], []
    for b in range(num_ops):
        moduli.append([(b + m + 1) * 10 for m in range(num_moduli)])
        flat = lambda offs: np.concatenate(
            [np.uint64(b + off) + i + np.uint64(m * n)
             for off in offs for m in range(num_moduli)])
        op1.append(flat((1, 11)))
        op2.append(flat((2, 22)))
    return moduli, op1, op2


@pytest.fixture
def jax_runtime(monkeypatch):
    """The JAX package's runtime under RUN_CHOICE=1 beside the port's."""
    monkeypatch.setenv("RUN_CHOICE", "1")
    jconfig.reset_config()
    jhexl.acquire_FPGA_resources()
    yield jhexl
    jhexl.release_FPGA_resources()
    jconfig.reset_config()


def drive_dyadic(pkg, op1, op2, n, moduli, M):
    outs = [np.zeros(3 * M * n, dtype=np.uint64) for _ in op1]
    pkg.set_worksize_DyadicMultiply(len(op1))
    for o, a, b, q in zip(outs, op1, op2, moduli):
        pkg.DyadicMultiply(o, a, b, n, q, M)
    assert pkg.DyadicMultiplyCompleted()
    return outs


@pytest.mark.parametrize("run_choice", [0, 1])
@pytest.mark.parametrize("worksize", [1, 4])
def test_dyadic_multiply_ramp_matches_jax_api(runtime, jax_runtime, run_choice, worksize):
    """Each op has its own moduli, so every op is fenced into its own batch."""
    runtime(RUN_CHOICE=run_choice, BATCH_SIZE_DYADIC_MULTIPLY=4)
    n, M = 64, 3
    moduli, op1, op2 = ramp_io(worksize, M, n)
    outs = drive_dyadic(hexl, op1, op2, n, moduli, M)
    ref = drive_dyadic(jax_runtime, op1, op2, n, moduli, M)
    for o, r, a, b, q in zip(outs, ref, op1, op2, moduli):
        np.testing.assert_array_equal(o, golden.dyadic_multiply(a, b, n, q, M))
        np.testing.assert_array_equal(o, r)


@pytest.mark.parametrize("bits,worksize", [(51, 7), (20, 4)])
def test_dyadic_multiply_batches_match_jax_api(runtime, jax_runtime, bits, worksize):
    """One moduli vector, operands in [0, 4q), batches of 4 (7 ops leave a
    short last batch)."""
    pool = runtime(RUN_CHOICE=1, BATCH_SIZE_DYADIC_MULTIPLY=4)
    n, M = 256, 3
    q = [int(x) for x in nt.generate_primes(M, bits, n)]
    rng = np.random.default_rng(bits)
    mk = lambda: [np.concatenate([rng.integers(0, 4 * q[m], size=n, dtype=np.uint64)
                                  for _ in range(2) for m in range(M)])
                  for _ in range(worksize)]
    op1, op2 = mk(), mk()
    moduli = [q + [12345]] * worksize  # entries past n_moduli are ignored
    outs = drive_dyadic(hexl, op1, op2, n, moduli, M)
    assert pool._worksize[scheduler.DYADIC_MULTIPLY] == 1
    ref = drive_dyadic(jax_runtime, op1, op2, n, moduli, M)
    for o, r, a, b in zip(outs, ref, op1, op2):
        np.testing.assert_array_equal(o, golden.dyadic_multiply(a, b, n, q, M))
        np.testing.assert_array_equal(o, r)


def test_dyadic_multiply_validation(runtime):
    runtime(RUN_CHOICE=1)
    a = np.zeros(2 * 8, dtype=np.uint64)
    out = np.zeros(3 * 8, dtype=np.uint64)
    for args in ((None, a, a, 8, [17], 1), (out, None, a, 8, [17], 1),
                 (out, a, None, 8, [17], 1), (out, a, a, 0, [17], 1),
                 (out, a, a, 8, [17], 0)):
        with pytest.raises(HexlAssertError):
            hexl.DyadicMultiply(*args)
    with pytest.raises(HexlAssertError):
        hexl.set_worksize_DyadicMultiply(0)
    with pytest.raises(ValueError, match=">= 2"):  # surfaces on completion
        hexl.DyadicMultiply(out, a, a, 8, [1], 1)


def test_mixed_dyadic_and_keyswitch(vec, runtime):
    """Interleaved DyadicMultiply + KeySwitch batches, the combined-kernel
    test (`tests/test_dyadic_multiply_keyswitch.cpp`)."""
    runtime(RUN_CHOICE=1)
    M = 2
    moduli, op1, op2 = ramp_io(2, M, N)
    outs = [np.zeros(3 * M * N, dtype=np.uint64) for _ in range(2)]
    ks_res = vec.input.copy()
    hexl.set_worksize_DyadicMultiply(2)
    hexl.set_worksize_KeySwitch(1)
    hexl.DyadicMultiply(outs[0], op1[0], op2[0], N, moduli[0], M)
    keyswitch(vec, ks_res)
    hexl.DyadicMultiply(outs[1], op1[1], op2[1], N, moduli[1], M)
    assert hexl.KeySwitchCompleted()
    assert hexl.DyadicMultiplyCompleted()
    np.testing.assert_array_equal(ks_res, vec.expected_output)
    for i in range(2):
        np.testing.assert_array_equal(
            outs[i], golden.dyadic_multiply(op1[i], op2[i], N, moduli[i], M))


def test_run_choice_2_without_cuda_raises(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.delenv("RUN_CHOICE", raising=False)  # the default is 2
    config_mod.reset_config()
    assert config_mod.get_config().run_choice == 2
    try:
        with pytest.raises(RuntimeError, match="CUDA"):
            hexl.acquire_FPGA_resources()
        with pytest.raises(RuntimeError, match="CUDA"):
            executors.make_executor(2, 0)
    finally:
        hexl.release_FPGA_resources()
        config_mod.reset_config()


def test_make_executor_routes():
    assert isinstance(executors.make_executor(0, 0), executors.GoldenExecutor)
    ex = executors.make_executor(1, 0)
    assert isinstance(ex, executors.TorchExecutor) and ex.device.type == "cpu"


def test_profile_hook_writes_a_trace(vec, runtime, tmp_path):
    runtime(RUN_CHOICE=1, HEXL_TPU_PROFILE=tmp_path / "prof")
    r = vec.input.copy()
    keyswitch(vec, r)
    np.testing.assert_array_equal(r, vec.expected_output)
    hexl.release_FPGA_resources()
    assert (tmp_path / "prof" / "hexl_trace.json").stat().st_size > 0
