"""The port's worker pool (`runtime/scheduler.py` `DevicePool`) held to the
JAX package's worker-pool tests: `tests/test_scheduler.py` (NUM_DEV workers,
the batch limit, backpressure, finalize-once, concurrent producers),
`tests/test_scheduler_release.py` (release drains pending work) and
`tests/test_mixed_workload.py` (interleaved DyadicMultiply and KeySwitch, the
fence on a parameter change), with the same names, fake executors and
assertions.  A hang is a fault: every test runs its body in a thread joined
with a time limit of its own (`LIMIT_S`) and fails when the limit passes."""

import sys
import threading
import time

import numpy as np
import pytest

import hexl_fpga_tpu_torch as hexl
from hexl_fpga_tpu_torch import config as config_mod
from hexl_fpga_tpu_torch.ops import golden
from hexl_fpga_tpu_torch.runtime import scheduler
from hexl_fpga_tpu_torch.utils import vectors

# seconds each test's body may take; the slowest takes under 2 on one CPU
LIMIT_S = 10.0


def within(body, limit_s=LIMIT_S):
    """Run body() in a thread; fail if it is still running after limit_s,
    re-raise what it raised."""
    out = {}

    def run():
        try:
            body()
        except BaseException as exc:  # handed to the test's thread
            out["exc"] = exc

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=limit_s)
    assert not t.is_alive(), f"did not finish within {limit_s} s (a hang)"
    if "exc" in out:
        raise out["exc"]


def dyadic_into(item):
    a = item.args
    out = golden.dyadic_multiply(
        a["operand1"], a["operand2"], a["n"], a["moduli"], a["n_moduli"]
    )
    np.copyto(a["results"], out.reshape(a["results"].shape))


class _CountingExecutor:
    def __init__(self):
        self.batches = []
        self.lock = threading.Lock()

    def run_batch(self, batch):
        with self.lock:
            self.batches.append(len(batch))
        for item in batch:
            dyadic_into(item)


@pytest.fixture
def mk_pool(monkeypatch):
    """A DevicePool over one executor under the environment a test sets;
    released (and the configuration re-read) afterwards."""
    pools = []

    def make(executor, **env):
        for k, v in env.items():
            monkeypatch.setenv(k, str(v))
        config_mod.reset_config()
        pools.append(scheduler.DevicePool(executor_factory=lambda i: executor))
        return pools[-1]

    yield make
    for p in pools:
        p.release()
    config_mod.reset_config()


def dyadic_op(pool, rng, n=64, q=65537):
    op1 = rng.integers(0, q, size=2 * n, dtype=np.uint64)
    op2 = rng.integers(0, q, size=2 * n, dtype=np.uint64)
    out = np.zeros(3 * n, dtype=np.uint64)
    moduli = np.array([q], dtype=np.uint64)
    pool.enqueue(
        scheduler.DYADIC_MULTIPLY,
        (n, 1, moduli.tobytes()),
        {"results": out, "operand1": op1, "operand2": op2, "n": n,
         "moduli": moduli, "n_moduli": 1},
    )
    return op1, op2, out


def check_dyadic(jobs, n=64, q=65537):
    for op1, op2, out in jobs:
        np.testing.assert_array_equal(
            out, golden.dyadic_multiply(op1, op2, n, [q], 1)
        )


def _enqueue_dyadic(pool, count):
    rng = np.random.default_rng(0)
    pool.set_worksize(scheduler.DYADIC_MULTIPLY, count)
    jobs = [dyadic_op(pool, rng) for _ in range(count)]
    assert pool.completed(scheduler.DYADIC_MULTIPLY)
    check_dyadic(jobs)


# -- tests/test_scheduler.py -------------------------------------------------


def test_multi_worker_pool(mk_pool):
    ex = _CountingExecutor()
    pool = mk_pool(ex, NUM_DEV=3, BATCH_SIZE_DYADIC_MULTIPLY=2)
    assert len(pool.devices) == 3
    within(lambda: _enqueue_dyadic(pool, 12))
    assert sum(ex.batches) == 12
    assert max(ex.batches) <= 2  # batch limit respected


def test_small_bufsize_backpressure(mk_pool):
    ex = _CountingExecutor()
    pool = mk_pool(ex, FPGA_BUFSIZE=2)
    within(lambda: _enqueue_dyadic(pool, 10))  # no deadlock on the bounded queue
    assert sum(ex.batches) == 10


class _SplitExecutor(_CountingExecutor):
    """Submit/finalize split executor: counts finalizations per submission,
    each submit() with a token of its own."""

    def __init__(self):
        super().__init__()
        self.finalized = []
        self._next_token = 0

    def submit(self, batch):
        with self.lock:
            token = self._next_token
            self._next_token += 1

        def finalize():
            self.run_batch(batch)
            with self.lock:
                self.finalized.append((token, len(batch)))

        return finalize


def test_each_batch_finalized_exactly_once(mk_pool):
    """The overlapped demux must finalize every batch once: a stale pending
    batch is never demuxed twice, none is dropped."""
    ex = _SplitExecutor()
    pool = mk_pool(ex, BATCH_SIZE_DYADIC_MULTIPLY=4)

    def waves():
        for _ in range(3):  # waves with the queue idle between them
            _enqueue_dyadic(pool, 10)

    within(waves)
    tokens = [t for t, _ in ex.finalized]
    assert len(tokens) == len(set(tokens))  # no batch demuxed twice
    assert sum(sz for _, sz in ex.finalized) == 30  # none dropped


def test_concurrent_producers(mk_pool):
    ex = _CountingExecutor()
    pool = mk_pool(ex, NUM_DEV=2, BATCH_SIZE_DYADIC_MULTIPLY=4)
    errs = []

    def producer(seed):
        try:
            rng = np.random.default_rng(seed)
            for _ in range(5):
                # worksize 1 (the default): each enqueue is synchronous
                check_dyadic([dyadic_op(pool, rng)])
        except Exception as e:  # handed to the test's thread
            errs.append(e)

    def producers():
        threads = [threading.Thread(target=producer, args=(s,)) for s in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    within(producers)
    assert not errs, errs
    assert sum(ex.batches) == 20


def test_synchronous_op_is_counted_before_a_worker_can_pop_it(mk_pool):
    """A worker that pops a worksize-1 op the moment it is queued must not
    read that more ops are promised (it would linger Buffer.LINGER_S for an op
    that never comes): the buffer counts the op as it queues it, under its
    lock."""
    ex = _CountingExecutor()
    pool = mk_pool(ex, BATCH_SIZE_DYADIC_MULTIPLY=4)
    seen = []
    push = pool.buffer.push

    def push_then_look(item):
        push(item)
        seen.append(pool._more_coming(item.op_type))

    pool.buffer.push = push_then_look
    rng = np.random.default_rng(3)

    def ops():
        for _ in range(4):
            check_dyadic([dyadic_op(pool, rng)])

    t0 = time.perf_counter()
    within(ops)
    assert seen == [False] * 4
    # four synchronous ops, none waits out a linger
    assert time.perf_counter() - t0 < 4 * scheduler.Buffer.LINGER_S


def test_stress_many_workers_and_producers(mk_pool):
    """More workers than cores and four producers filling one promised
    worksize, with the interpreter switching threads as often as it can:
    the buffer's count of queued ops loses no update, every op is served
    once, within the batch limit, and right."""
    ex = _CountingExecutor()
    pool = mk_pool(ex, NUM_DEV=8, BATCH_SIZE_DYADIC_MULTIPLY=4)
    producers, each = 4, 50
    pool.set_worksize(scheduler.DYADIC_MULTIPLY, producers * each)
    jobs = []

    def producer(seed):
        rng = np.random.default_rng(seed)
        mine = [dyadic_op(pool, rng) for _ in range(each)]
        jobs.extend(mine)

    def fill():
        threads = [threading.Thread(target=producer, args=(s,)) for s in range(producers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert pool.buffer.queued(scheduler.DYADIC_MULTIPLY) == producers * each
        assert pool.completed(scheduler.DYADIC_MULTIPLY)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        within(fill)
    finally:
        sys.setswitchinterval(interval)
    assert pool.buffer.queued(scheduler.DYADIC_MULTIPLY) == 0  # reset by completed()
    assert sum(ex.batches) == producers * each and max(ex.batches) <= 4
    check_dyadic(jobs)


# -- tests/test_scheduler_release.py ------------------------------------------


class _SlowExecutor:
    def run_batch(self, batch):
        time.sleep(0.02)
        for item in batch:
            dyadic_into(item)


def test_release_drains_pending_work(mk_pool):
    pool = mk_pool(_SlowExecutor())
    rng = np.random.default_rng(0)
    pool.set_worksize(scheduler.DYADIC_MULTIPLY, 8)
    jobs = [dyadic_op(pool, rng) for _ in range(8)]
    # a waiter blocks on completion while release() fires concurrently
    done = {}

    def waiter():
        done["ok"] = pool.completed(scheduler.DYADIC_MULTIPLY)

    t = threading.Thread(target=waiter)
    t.start()
    pool.release()
    t.join(timeout=LIMIT_S)
    assert not t.is_alive(), "completed() left spinning after release()"
    assert done.get("ok") is True
    check_dyadic(jobs)


# -- tests/test_mixed_workload.py (through the port's API, RUN_CHOICE=1) -------


@pytest.fixture
def api_runtime(monkeypatch):
    monkeypatch.setenv("RUN_CHOICE", "1")
    config_mod.reset_config()
    hexl.acquire_FPGA_resources()
    yield
    hexl.release_FPGA_resources()
    config_mod.reset_config()


def test_interleaved_dyadic_and_keyswitch(api_runtime):
    n, L, K = 1024, 2, 3
    vec = vectors.make_keyswitch_vector(n, L, K, seed=21, modulus_bits=45)
    M = 2
    dy_moduli = np.array(vec.moduli[:M], dtype=np.uint64)
    rng = np.random.default_rng(0)
    reps = 3
    dy_outs, dy_ins, ks_outs = [], [], []

    def interleaved():
        # both op types enqueued before either is completed
        hexl.set_worksize_DyadicMultiply(reps)
        hexl.set_worksize_KeySwitch(reps)
        for _ in range(reps):
            op1 = rng.integers(0, dy_moduli.min(), size=2 * M * n, dtype=np.uint64)
            op2 = rng.integers(0, dy_moduli.min(), size=2 * M * n, dtype=np.uint64)
            out = np.zeros(3 * M * n, dtype=np.uint64)
            dy_ins.append((op1, op2))
            dy_outs.append(out)
            hexl.DyadicMultiply(out, op1, op2, n, dy_moduli, M)
            ks = vec.input.copy()
            ks_outs.append(ks)
            hexl.KeySwitch(
                ks, vec.t_target_iter_ptr, n, L, K, L + 1, 2,
                vec.moduli, vec.key_vectors, vec.modswitch_factors,
                vec.twiddle_factors,
            )
        assert hexl.DyadicMultiplyCompleted()
        assert hexl.KeySwitchCompleted()

    within(interleaved)
    for (op1, op2), out in zip(dy_ins, dy_outs):
        np.testing.assert_array_equal(
            out, golden.dyadic_multiply(op1, op2, n, dy_moduli, M)
        )
    for ks in ks_outs:
        np.testing.assert_array_equal(ks, vec.expected_output)


def test_fence_on_parameter_change(api_runtime):
    """Consecutive dyadic ops with different moduli all complete correctly
    (each parameter change fences the batch)."""
    n = 512
    rng = np.random.default_rng(1)
    cases = []

    def fenced():
        hexl.set_worksize_DyadicMultiply(4)
        for m in [(1 << 30) + 3, (1 << 40) + 79, (1 << 30) + 3, (1 << 50) + 5]:
            moduli = np.array([m], dtype=np.uint64)
            op1 = rng.integers(0, m, size=2 * n, dtype=np.uint64)
            op2 = rng.integers(0, m, size=2 * n, dtype=np.uint64)
            out = np.zeros(3 * n, dtype=np.uint64)
            cases.append((op1, op2, out, moduli))
            hexl.DyadicMultiply(out, op1, op2, n, moduli, 1)
        assert hexl.DyadicMultiplyCompleted()

    within(fenced)
    for op1, op2, out, moduli in cases:
        np.testing.assert_array_equal(
            out, golden.dyadic_multiply(op1, op2, n, moduli, 1)
        )
