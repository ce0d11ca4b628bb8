"""The executor's host staging: each batch's operands gathered from the
callers' buffers straight into host tensors (pinned on CUDA) and uploaded
from there.

On the CPU (RUN_CHOICE=1) the executor is driven here directly, as the
worker drives it (submit batch i, then finalize batch i-1, or each batch at
once), over sequences that alternate ops and shapes and change the batch
size, and over streams of one op; operands come in any layout that
`np.asarray(..., dtype=np.uint64)` takes; a scatter that raises writes
nothing and the next batches are still exact.  Inputs and expected results
are the JAX package's (`hexl_fpga_tpu.ops.golden`, its primes, twiddle
tables and KeySwitch vector), bit for bit.

The card tests (the uploads read pinned memory; a steady stream takes no new
pinned block; batches queued behind a slow upload stay exact) run with the
hardware tier; the card has no JAX, so there the port's golden model is the
oracle:

  HEXL_TORCH_HW_TESTS=1 python -m pytest --noconftest -p no:cacheprovider tests/test_torch_executor_staging.py -q

Tolerance: zero."""

import os
import types

import numpy as np
import pytest
import torch

from hexl_fpga_tpu_torch.ops import golden, nt, twiddles
from hexl_fpga_tpu_torch.runtime import executors, scheduler as sched
from hexl_fpga_tpu_torch.utils import vectors

KS_N, KS_L, KS_K = 1024, 2, 3


def _reference():
    """The JAX package's oracle modules, imported only where a test runs on
    the CPU."""
    from hexl_fpga_tpu.ops import golden as g, nt as n, twiddles as t
    from hexl_fpga_tpu.utils import vectors as v
    return types.SimpleNamespace(golden=g, nt=n, twiddles=t, vectors=v)


PORT = types.SimpleNamespace(golden=golden, nt=nt, twiddles=twiddles, vectors=vectors)


def _dyadic(n, M):
    def make(ref, B, rng):
        q = [int(p) for p in ref.nt.generate_primes(M, 30, n)]
        qcol = np.array(q, dtype=np.uint64).reshape(1, M, 1)
        items = [sched.WorkItem(sched.DYADIC_MULTIPLY, {
            "results": np.zeros(3 * M * n, dtype=np.uint64),
            "operand1": (rng.integers(0, 1 << 62, size=(2, M, n), dtype=np.uint64)
                         % qcol).ravel(),
            "operand2": (rng.integers(0, 1 << 62, size=(2, M, n), dtype=np.uint64)
                         % qcol).ravel(),
            "n": n, "moduli": q, "n_moduli": M}) for _ in range(B)]
        want = [ref.golden.dyadic_multiply(i.args["operand1"], i.args["operand2"],
                                           n, q, M).ravel() for i in items]
        return items, "results", want

    return make


def _transform(n, inverse):
    def make(ref, B, rng):
        q = int(ref.nt.generate_primes(1, 50, n)[0])
        t = ref.twiddles.ntt_tables(n, q)
        if inverse:
            shared = {"inv_root_of_unity_powers": t.inv, "precon": t.inv_precon,
                      "inv_n": t.inv_n, "inv_n_w": t.inv_n_w}
        else:
            shared = {"root_of_unity_powers": t.fwd, "precon": t.fwd_precon}
        items = [sched.WorkItem(sched.INTT if inverse else sched.NTT, {
            "operand": rng.integers(0, q, size=n, dtype=np.uint64),
            "coeff_modulus": q, "n": n, **shared}) for _ in range(B)]
        oracle = ref.golden.inv_ntt if inverse else ref.golden.fwd_ntt
        want = [oracle(i.args["operand"], q, t) for i in items]
        return items, "operand", want

    return make


def _keyswitch(ref, B, rng):
    """KeySwitch at the port's smallest test shape: each op's result and
    target the vector's, rotated by a drawn shift (still below each row's
    modulus), so every op of a batch differs."""
    v = ref.vectors.make_keyswitch_vector(KS_N, KS_L, KS_K, seed=2, modulus_bits=45)
    r0 = np.asarray(v.input, dtype=np.uint64).reshape(2, KS_L, KS_N)
    t0 = np.asarray(v.t_target_iter_ptr, dtype=np.uint64).reshape(KS_L, KS_N)
    shared = {"n": KS_N, "decomp_modulus_size": KS_L, "key_modulus_size": KS_K,
              "rns_modulus_size": KS_K, "key_component_count": 2,
              "moduli": np.asarray(v.moduli, dtype=np.uint64),
              "k_switch_keys": list(v.key_vectors),
              "modswitch_factors": np.asarray(v.modswitch_factors, dtype=np.uint64),
              "twiddle_factors": v.twiddle_factors}
    items = [sched.WorkItem(sched.KEYSWITCH, {
        "result": np.roll(r0, s, axis=-1).ravel(),
        "t_target": np.roll(t0, s, axis=-1).ravel(),
        "plain_modulus": None, **shared}) for s in rng.integers(0, KS_N, size=B)]
    want = [ref.golden.keyswitch(i.args["result"], i.args["t_target"], **shared).ravel()
            for i in items]
    return items, "result", want


OPS = {
    "dyadic": _dyadic(64, 2),
    "dyadic_wide": _dyadic(128, 3),
    "ntt": _transform(64, False),
    "intt": _transform(64, True),
    "keyswitch": _keyswitch,
}


def _check(items, key, want):
    for item, w in zip(items, want):
        np.testing.assert_array_equal(item.args[key], w)


def _drive(ex, ref, steps, rng, overlap=True):
    """Run (op name, batch size) steps through ex as the worker does:
    submit batch i, then finalize batch i-1 (or each at once), and hold
    every result to the oracle."""
    pending = []
    for name, B in steps:
        items, key, want = OPS[name](ref, B, rng)
        pending.append((ex.submit(items), items, key, want))
        while len(pending) > (1 if overlap else 0):
            fin, *rest = pending.pop(0)
            fin()
            _check(*rest)
    for fin, *rest in pending:
        fin()
        _check(*rest)


@pytest.fixture
def cpu_executor():
    return executors.TorchExecutor(0, force_cpu=True)


@pytest.fixture(scope="module")
def ref():
    return _reference()


# ops and shapes alternate, and the batch size goes up and down
SEQUENCE = [("dyadic", 3), ("dyadic_wide", 2), ("dyadic", 1), ("ntt", 4),
            ("intt", 2), ("keyswitch", 2), ("dyadic", 2), ("ntt", 1),
            ("keyswitch", 1), ("dyadic_wide", 3), ("dyadic", 3), ("intt", 1)]


@pytest.mark.parametrize("overlap", [True, False], ids=["one_pending", "at_once"])
def test_sequence_matches_reference(cpu_executor, ref, overlap):
    _drive(cpu_executor, ref, SEQUENCE, np.random.default_rng(5), overlap)


@pytest.mark.parametrize("op", list(OPS))
def test_stream_of_one_op_matches_reference(cpu_executor, ref, op):
    _drive(cpu_executor, ref, [(op, 2)] * 4 + [(op, 1)], np.random.default_rng(6))


@pytest.mark.parametrize("layout", ["list", "strided", "big_endian"])
def test_operands_in_any_layout_are_gathered(cpu_executor, ref, layout):
    """The gather converts as `np.asarray(..., dtype=np.uint64)` does: a
    list, a strided view and a big-endian array give the same bits."""
    items, key, want = OPS["dyadic"](ref, 3, np.random.default_rng(7))
    for item in items:
        for name in ("operand1", "operand2"):
            a = item.args[name]
            if layout == "list":
                a = [int(x) for x in a]
            elif layout == "strided":
                a = np.repeat(a, 2)[::2]
            else:
                a = a.astype(">u8")
            item.args[name] = a
    cpu_executor.submit(items)()
    _check(items, key, want)


@pytest.mark.parametrize("op", ["dyadic", "ntt", "keyswitch"])
def test_a_scatter_that_raises_writes_nothing(cpu_executor, ref, op):
    ex = cpu_executor
    rng = np.random.default_rng(10)
    items, key, _ = OPS[op](ref, 3, rng)
    before = [i.args[key].copy() for i in items]
    items[1].args[key].flags.writeable = False
    with pytest.raises(ValueError, match="writable"):
        ex.submit(items)()
    for item, b in zip(items, before):
        np.testing.assert_array_equal(item.args[key], b)
    _drive(ex, ref, [(op, 3), (op, 2)], rng)


# -- on the card -------------------------------------------------------------


@pytest.fixture
def card_executor():
    """Decided per test, never at import: runs only in the hardware tier
    with a card."""
    if os.environ.get("HEXL_TORCH_HW_TESTS") != "1":
        pytest.skip("hardware tier: set HEXL_TORCH_HW_TESTS=1 on a machine with a CUDA device")
    if not torch.cuda.is_available():
        pytest.skip("hardware tier: no CUDA device is available")
    ex = executors.TorchExecutor(0, force_cpu=False)
    ex.bind_thread()
    return ex


@pytest.mark.card
def test_card_uploads_read_pinned_memory(card_executor, monkeypatch):
    """Every operand upload (those on the executor's copy stream; tables
    and keys go up elsewhere) reads a pinned tensor."""
    ex = card_executor
    upload = executors.w.from_u64_np
    seen = []

    def spy(a, device="cpu"):
        if torch.cuda.current_stream(ex.device) == ex.copy_stream:
            seen.append(isinstance(a, torch.Tensor) and a.is_pinned())
        return upload(a, device)

    monkeypatch.setattr(executors.w, "from_u64_np", spy)
    _drive(ex, PORT, SEQUENCE, np.random.default_rng(11))
    operands = {"ntt": 1, "intt": 1}
    assert seen == [True] * sum(operands.get(name, 2) for name, _ in SEQUENCE)


@pytest.mark.card
def test_card_steady_stream_takes_no_new_pinned_block(card_executor):
    """Once a stream of one shape has run a few batches, torch's host cache
    serves every later batch's staging and copy back from blocks it holds."""
    rng = np.random.default_rng(13)
    _drive(card_executor, PORT, [("dyadic", 2)] * 3, rng)
    made = torch.cuda.host_memory_stats()["num_host_alloc"]
    _drive(card_executor, PORT, [("dyadic", 2)] * 8, rng)
    assert torch.cuda.host_memory_stats()["num_host_alloc"] == made


@pytest.mark.card
def test_card_batches_behind_a_slow_upload_stay_exact(card_executor):
    """Uploads queued behind a long sleep on the copy stream: the host
    tensors of later batches must not reuse a block an upload still has to
    read, so every result is exact."""
    ex = card_executor
    rng = np.random.default_rng(12)
    # the kernel built and its moduli's runner cached first, by another
    # executor, so no submit below outlasts the sleep
    _drive(executors.TorchExecutor(0, force_cpu=False), PORT, [("dyadic", 2)], rng)
    batches = [OPS["dyadic"](PORT, 2, rng) for _ in range(3)]
    with torch.cuda.stream(ex.copy_stream):
        torch.cuda._sleep(2_000_000_000)  # about a second
    fins = [ex.submit(items) for items, _, _ in batches]
    for fin, batch in zip(fins, batches):
        fin()
        _check(*batch)
