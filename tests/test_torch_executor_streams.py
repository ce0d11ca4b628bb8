"""The executor's two streams on CUDA, checked on the CPU.

On CUDA a batch's copies go to the executor's copy stream and its body to
the thread's current (compute) stream, ordered by events, so that the copy
back of batch i-1 runs while batch i computes and the upload of batch i
waits for no body.  A recording stand-in for torch.cuda's streams, events
and `Tensor.record_stream` takes the card's place: for a worksize of two
batches of each op type through the API (RUN_CHOICE=1, the executor given
the stand-in's copy stream) it checks that

  * every batch's operands are uploaded on the copy stream, which has waited
    on no event before the last upload (so the upload of batch 1 does not
    wait for body 0), and the compute stream waits for that upload's event
    before the body, each staged tensor kept for the compute stream;
  * the copy back of each batch makes the copy stream wait on its own body's
    event and on nothing else, then copies back on the copy stream, and the
    copy back of batch 0 is queued after batch 1's upload and before batch
    1's body;
  * finalize waits for an event behind each copy back, XCompleted() returns
    after the last of them, and every result is the golden model's.

Tolerance: zero."""

import contextlib
import itertools
import threading
import warnings

import numpy as np
import pytest
import torch

import hexl_fpga_tpu_torch as hexl
from hexl_fpga_tpu_torch import config as config_mod
from hexl_fpga_tpu_torch.ops import golden, nt, twiddles, word64
from hexl_fpga_tpu_torch.runtime import scheduler
from hexl_fpga_tpu_torch.utils import vectors

N, BATCH, WORKSIZE = 1024, 2, 4


class Recorder:
    """Streams, events and the current stream of a thread, as a log of
    (what, stream name, event id) entries."""

    def __init__(self):
        self.log = []
        self.local = threading.local()
        self.ids = itertools.count()
        self.compute = self.Stream("compute", self)
        self.copy = self.Stream("copy", self)
        # the first upload on the copy stream waits here until the test has
        # pushed every op, so the worker holds batch 0 while it submits batch 1
        self.all_pushed = threading.Event()

    def current(self):
        return getattr(self.local, "stream", self.compute)

    @contextlib.contextmanager
    def stream(self, s):
        before = self.current()
        self.local.stream = s
        try:
            yield
        finally:
            self.local.stream = before

    class Stream:
        def __init__(self, name, rec):
            self.name, self.rec = name, rec

        def wait_event(self, ev):
            self.rec.log.append(("wait", self.name, ev.id))

    def event(self, **_):
        rec = self

        class Event:
            id = next(rec.ids)

            def record(self, stream=None):
                rec.log.append(("record", (stream or rec.current()).name, self.id))

            def synchronize(self):
                rec.log.append(("sync", None, self.id))

        return Event()


@pytest.fixture
def recorder(monkeypatch):
    rec = Recorder()
    from_np, to_host = word64.from_u64_np, word64.to_host_async

    def upload(a, device="cpu"):
        if rec.current() is rec.copy:
            assert rec.all_pushed.wait(10), "the test never pushed every op"
        rec.log.append(("upload", rec.current().name, None))
        return from_np(a, device)

    def download(x):
        rec.log.append(("download", rec.current().name, None))
        return to_host(x)

    monkeypatch.setattr(word64, "from_u64_np", upload)
    monkeypatch.setattr(word64, "to_host_async", download)
    monkeypatch.setattr(torch.cuda, "Event", rec.event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: rec.current())
    monkeypatch.setattr(torch.cuda, "stream", rec.stream)
    monkeypatch.setattr(torch.Tensor, "record_stream",
                        lambda x, s: rec.log.append(("keep", s.name, None)))
    return rec


@pytest.fixture
def runtime(monkeypatch, recorder):
    """The port's runtime on the CPU, its one executor given the stand-in's
    copy stream; always released."""
    for k, v in dict(RUN_CHOICE=1, BATCH_SIZE_DYADIC_MULTIPLY=BATCH,
                     BATCH_SIZE_NTT=BATCH, BATCH_SIZE_INTT=BATCH,
                     BATCH_SIZE_KEYSWITCH=BATCH).items():
        monkeypatch.setenv(k, str(v))
    config_mod.reset_config()
    hexl.acquire_FPGA_resources()
    (device,) = scheduler.pool().devices
    device.executor.copy_stream = recorder.copy
    yield recorder
    recorder.all_pushed.set()
    hexl.release_FPGA_resources()
    config_mod.reset_config()


def dyadic_ops():
    q = [int(p) for p in nt.generate_primes(2, 30, N)]
    rng = np.random.default_rng(1)
    qcol = np.array(q, dtype=np.uint64).reshape(1, 2, 1)
    ops = [(rng.integers(0, 1 << 62, size=(2, 2, N), dtype=np.uint64) % qcol,
            rng.integers(0, 1 << 62, size=(2, 2, N), dtype=np.uint64) % qcol)
           for _ in range(WORKSIZE)]
    bufs = [np.zeros(3 * 2 * N, dtype=np.uint64) for _ in ops]

    def push():
        hexl.set_worksize_DyadicMultiply(WORKSIZE)
        for (a, b), r in zip(ops, bufs):
            hexl.DyadicMultiply(r, a.ravel(), b.ravel(), N, q, 2)
        return hexl.DyadicMultiplyCompleted

    def check():
        for (a, b), r in zip(ops, bufs):
            np.testing.assert_array_equal(
                r, golden.dyadic_multiply(a, b, N, q, 2).reshape(-1))

    return push, check


def transform_ops(inverse):
    q = int(nt.generate_primes(1, 50, N)[0])
    t = twiddles.ntt_tables(N, q)
    rng = np.random.default_rng(2)
    src = [rng.integers(0, q, size=N, dtype=np.uint64) for _ in range(WORKSIZE)]
    bufs = [s.copy() for s in src]

    def push():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            if inverse:
                hexl._set_worksize_INTT(WORKSIZE)
                for b in bufs:
                    hexl._INTT(b, t.inv, t.inv_precon, q, t.inv_n, t.inv_n_w, N)
            else:
                hexl._set_worksize_NTT(WORKSIZE)
                for b in bufs:
                    hexl._NTT(b, t.fwd, t.fwd_precon, q, N)
        return hexl._INTTCompleted if inverse else hexl._NTTCompleted

    def check():
        want = golden.inv_ntt if inverse else golden.fwd_ntt
        for s, b in zip(src, bufs):
            np.testing.assert_array_equal(b, want(s, q, t))

    return push, check


def keyswitch_ops():
    vec = vectors.make_keyswitch_vector(N, 2, 3, seed=2, modulus_bits=45)
    bufs = [vec.input.copy() for _ in range(WORKSIZE)]

    def push():
        hexl.set_worksize_KeySwitch(WORKSIZE)
        for r in bufs:
            hexl.KeySwitch(r, vec.t_target_iter_ptr, N, 2, 3, 3, 2, vec.moduli,
                           vec.key_vectors, vec.modswitch_factors,
                           vec.twiddle_factors)
        return hexl.KeySwitchCompleted

    def check():
        for r in bufs:
            np.testing.assert_array_equal(r, vec.expected_output)

    return push, check


OPS = {"dyadic_multiply": dyadic_ops, "ntt": lambda: transform_ops(False),
       "intt": lambda: transform_ops(True), "keyswitch": keyswitch_ops}


@pytest.mark.parametrize("op", OPS)
def test_copies_and_bodies_are_ordered_by_events(runtime, op):
    rec = runtime
    push, check = OPS[op]()
    completed = push()
    rec.all_pushed.set()
    assert completed()
    rec.log.append(("completed", None, None))
    check()
    log = rec.log

    # the events: each batch records an upload event on the copy stream that
    # the compute stream waits for, a body event on the compute stream, and
    # an event behind its copy back on the copy stream that finalize waits for
    at = {entry: i for i, entry in enumerate(log)}
    up = [e for what, s, e in log if what == "record" and s == "copy"
          and ("wait", "compute", e) in at]
    body = [e for what, s, e in log if what == "record" and s == "compute"]
    done = [e for what, _, e in log if what == "sync"]
    assert len(up) == len(body) == len(done) == WORKSIZE // BATCH, log
    copy_waits = [i for i, (what, s, _) in enumerate(log)
                  if what == "wait" and s == "copy"]
    # a copy back: the copy stream waits on the batch's own body event alone,
    # copies back, and records the event finalize waits for
    assert [log[i][2] for i in copy_waits] == body, log
    for i, b in zip(copy_waits, done):
        assert log[i + 1][:2] == ("download", "copy"), log
        assert log[i + 2] == ("record", "copy", b), log
        assert i < at["sync", None, b] < at["completed", None, None], log
    for i in range(len(up)):
        recorded = at["record", "copy", up[i]]
        waited = at["wait", "compute", up[i]]
        computed = at["record", "compute", body[i]]
        # the batch's operands went up on the copy stream just before (an
        # upload on the compute stream before them is a table's or a key's)
        start = at["record", "compute", body[i - 1]] if i else 0
        uploads = [s for what, s, _ in log[start:recorded] if what == "upload"]
        assert "copy" in uploads, (i, log)
        assert set(uploads[uploads.index("copy"):]) == {"copy"}, (i, log)
        # the compute stream waits for them and keeps them; then, ahead of
        # the body, the previous batch's copy back is queued
        assert recorded < waited < computed, (i, log)
        between = log[waited + 1:computed]
        assert ("keep", "compute", None) in between, (i, log)
        # the body's own uploads (a key set's) go to the compute stream
        assert all(s == "compute" for w, s, _ in between if w == "upload"), (i, log)
        assert (i > 0 and waited < copy_waits[i - 1] < computed) or (
            i == 0 and copy_waits[0] > computed), (i, log)
    assert all(s == "compute" for w, s, _ in log if w == "keep")
    # no copy-stream wait before the last upload: the upload of batch 1 did
    # not wait for body 0
    assert copy_waits[0] > at["record", "copy", up[-1]], log
