"""Asynchronous batching runtime.

Re-implements the reference's host scheduler (`host/inc/fpga.h:96-732`,
`host/src/fpga.cpp`: Object / Buffer / FPGAObject / Device / DevicePool) with
the same observable semantics, over PyTorch's asynchronous CUDA streams:

* callers enqueue ops (`set_worksize_X(n)` ... n x `X(...)` ... `XCompleted()`);
* a bounded work queue (capacity FPGA_BUFSIZE) feeds per-device worker
  threads;
* ops are batched up to BATCH_SIZE_X per submission, never across a *fence*
  (an op whose parameters differ from its predecessor — modulus for NTT/INTT,
  any config/keys change for KeySwitch: `fpga_int.cpp:263-273,429-448`);
* `XCompleted()` blocks until every outstanding op of that type is done and
  resets the worksize to 1 (`fpga_int.cpp:209-232,484-507`).

What the reference built by hand (credit-based double buffering, ping-pong
FPGAObjects, polling threads) a CUDA stream provides natively: kernels are
enqueued without blocking the worker, which only blocks when it copies
results back into caller buffers (the executor's finalize).
"""

from __future__ import annotations

import threading
import time
from collections import Counter, deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from .. import config as config_mod

DYADIC_MULTIPLY = "DYADIC_MULTIPLY"
NTT = "NTT"
INTT = "INTT"
KEYSWITCH = "KEYSWITCH"

_OP_TYPES = (DYADIC_MULTIPLY, NTT, INTT, KEYSWITCH)


@dataclass
class WorkItem:
    """One enqueued op (the reference's Object, `fpga.h:96-225`)."""

    op_type: str
    args: Dict[str, Any]
    fence: bool = False
    ready: bool = False
    fence_key: Tuple = ()


class Buffer:
    """Bounded multi-producer queue with fence-aware batched pop
    (reference Buffer, `fpga.h:260-360`, `fpga.cpp:92-190`)."""

    def __init__(self, capacity: int):
        self._capacity = capacity
        self._q: deque[WorkItem] = deque()
        self._lock = threading.Lock()
        self._not_full = threading.Condition(self._lock)
        self._not_empty = threading.Condition(self._lock)
        self._closed = False
        # ops queued per type since reset_count(type), counted under the lock
        # as they are queued: a worker (which reads it under the lock) never
        # sees an op in the queue that the count lacks
        self._queued: Dict[str, int] = {}

    def push(self, item: WorkItem) -> None:
        with self._not_full:
            while len(self._q) >= self._capacity and not self._closed:
                self._not_full.wait()
            if self._closed:
                raise RuntimeError("runtime released")
            self._q.append(item)
            self._queued[item.op_type] = self._queued.get(item.op_type, 0) + 1
            self._not_empty.notify_all()

    def queued(self, op_type: str) -> int:
        """Ops of op_type queued since the last reset_count (pop_batch's
        more_coming reads it under the lock)."""
        return self._queued.get(op_type, 0)

    def reset_count(self, op_type: str) -> None:
        with self._lock:
            self._queued[op_type] = 0

    def tail(self) -> Optional[WorkItem]:
        with self._lock:
            return self._q[-1] if self._q else None

    # how long a worker waits for the next op of a promised worksize before
    # it gives up on filling the batch; only a caller that enqueues fewer ops
    # than it promised ever pays it
    LINGER_S = 0.25

    def pop_batch(self, batch_sizes: Dict[str, int], timeout: float = 0.05,
                  more_coming: Optional[Callable[[str], bool]] = None) -> List[WorkItem]:
        """Dequeue up to batch_size ops of the front op's type, stopping at a
        type change or a fence (`fpga.cpp:107-180`).

        more_coming(op_type) says whether the caller has promised ops (through
        set_worksize) that it has not pushed yet.  While it does, a batch that
        is not full waits for them instead of leaving with what the queue
        holds, so a worksize of N ops always runs as ceil(N / batch_size)
        batches however fast the worker drains the queue."""
        with self._not_empty:
            if not self._q:
                self._not_empty.wait(timeout)
            if not self._q:
                return []
            front = self._q[0]
            limit = batch_sizes.get(front.op_type, 1)
            batch = [self._q.popleft()]
            self._not_full.notify_all()
            while len(batch) < limit:
                if self._q:
                    nxt = self._q[0]
                    if nxt.op_type != front.op_type or nxt.fence:
                        break
                    batch.append(self._q.popleft())
                    self._not_full.notify_all()
                elif (
                    self._closed
                    or more_coming is None
                    or not more_coming(front.op_type)
                    or not self._not_empty.wait(self.LINGER_S)
                ):
                    break
            return batch

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()
            self._not_full.notify_all()

    @property
    def closed(self) -> bool:
        return self._closed

    def __len__(self) -> int:
        with self._lock:
            return len(self._q)


class Device:
    """One worker draining the shared buffer (reference Device + its
    std::thread(Device::run), `fpga.cpp:581-1607,1670`).

    Batches are double-buffered like the reference's ping-pong KeySwitch
    FPGAObjects (`fpga.cpp:701-705,1517-1545`): when the executor supports
    split submit/finalize, batch i is dispatched to the device before batch
    i-1's results are demultiplexed into caller buffers, so host-side demux
    (the blocking device->host copy) overlaps device compute instead of
    serializing it."""

    def __init__(self, index: int, buffer: Buffer, executor, cfg, notify=None,
                 more_coming=None):
        self.index = index
        self.buffer = buffer
        self.executor = executor
        self.cfg = cfg
        self.notify = notify or (lambda: None)
        self.more_coming = more_coming
        self.batch_sizes = {
            DYADIC_MULTIPLY: cfg.batch_size_dyadic_multiply,
            NTT: cfg.batch_size_ntt,
            INTT: cfg.batch_size_intt,
            KEYSWITCH: cfg.batch_size_keyswitch,
        }
        # batches this worker took, by op type (written by its thread only)
        self.served: Counter = Counter()
        self.thread = threading.Thread(
            target=self._run, name=f"hexl-tpu-device-{index}", daemon=True
        )
        self.thread.start()

    def _finalize(self, pending) -> None:
        batch, fin, t0, t_submit = pending
        t1 = time.perf_counter()
        if fin is not None:
            try:
                fin()
            except Exception as exc:  # surface errors on completion
                for item in batch:
                    item.args["error"] = exc
        for item in batch:
            item.ready = True
        self.notify()
        if self.cfg.debug:
            now = time.perf_counter()
            dt = (now - t0) * 1e6
            msg = (
                f"[hexl-tpu dev{self.index}] {batch[0].op_type} batch "
                f"{len(batch)}: {dt:.1f} us ({dt/len(batch):.1f} us/op)"
            )
            if self.cfg.debug >= 2:
                # staging/dispatch vs result-demux split — the analog of the
                # reference's FPGA_DEBUG=2 I/O-staging vs API timing prints
                # (`host/src/fpga.cpp:882-920,1303-1318`)
                stage_us = (t_submit - t0) * 1e6
                demux_us = (now - t1) * 1e6
                msg += (
                    f" [stage+dispatch {stage_us:.1f} us, "
                    f"demux {demux_us:.1f} us, overlap-deferred "
                    f"{(t1 - t_submit)*1e6:.1f} us]"
                )
            print(msg)

    def _run(self) -> None:
        # a CUDA device is per-thread state: bind this worker to its
        # executor's device before the first launch
        bind = getattr(self.executor, "bind_thread", None)
        if bind is not None:
            bind()
        pending = None  # (batch, finalize_fn, t0) awaiting demux
        while True:
            try:
                # holding a pending (un-finalized) batch: only a non-blocking
                # probe — with NUM_DEV > 1 another worker may have drained the
                # queue between our length check and this pop, and callers
                # blocked in completed() must not wait out a poll timeout
                timeout = 0.0 if pending is not None else 0.05
                batch = self.buffer.pop_batch(
                    self.batch_sizes, timeout=timeout,
                    more_coming=self.more_coming,
                )
            except Exception:
                break
            if not batch:
                if pending is not None:
                    self._finalize(pending)
                    pending = None
                # drain fully before exiting on release(): a waiter inside
                # completed() must never be left blocked on an un-run item
                if self.buffer.closed and len(self.buffer) == 0:
                    break
                continue
            self.served[batch[0].op_type] += 1
            t0 = time.perf_counter()
            fin = None
            try:
                submit = getattr(self.executor, "submit", None)
                if submit is not None:
                    fin = submit(batch)  # async dispatch; demux deferred
                else:
                    self.executor.run_batch(batch)
            except Exception as exc:  # surface errors on completion
                for item in batch:
                    item.args["error"] = exc
            new_pending = (batch, fin, t0, time.perf_counter())
            if pending is not None:
                self._finalize(pending)
                pending = None
            if len(self.buffer) > 0:
                pending = new_pending  # overlap demux with the next batch
            else:
                self._finalize(new_pending)  # nothing queued: don't hold
        if pending is not None:  # pragma: no cover - defensive flush
            self._finalize(pending)


class DevicePool:
    """Shared queue + NUM_DEV workers (reference DevicePool,
    `fpga.cpp:1609-1685`)."""

    def __init__(self, executor_factory: Callable[[int], Any] | None = None):
        self.cfg = config_mod.get_config()
        self.buffer = Buffer(self.cfg.bufsize)
        from . import executors

        factory = executor_factory or (
            lambda i: executors.make_executor(self.cfg.run_choice, i)
        )
        # per-op bookkeeping for worksize/Completed semantics
        self._lock = threading.Lock()
        self._done = threading.Condition(self._lock)
        self._worksize = {t: 1 for t in _OP_TYPES}
        self._outstanding: Dict[str, List[WorkItem]] = {t: [] for t in _OP_TYPES}
        self._last_fence_key: Dict[str, Optional[Tuple]] = {t: None for t in _OP_TYPES}
        self.devices = [
            Device(i, self.buffer, factory(i), self.cfg,
                   notify=self._notify_done, more_coming=self._more_coming)
            for i in range(self.cfg.num_dev)
        ]

    def _more_coming(self, op_type: str) -> bool:
        # called by a worker under the buffer's lock: the ops queued since the
        # last completed() against the worksize, read without the pool's lock
        # (enqueue and completed() take the two in the other order)
        return self.buffer.queued(op_type) < self._worksize[op_type]

    def _notify_done(self) -> None:
        with self._done:
            self._done.notify_all()

    # -- worksize protocol ---------------------------------------------------

    def set_worksize(self, op_type: str, ws: int) -> None:
        assert ws > 0
        with self._lock:
            self._worksize[op_type] = ws

    def enqueue(self, op_type: str, fence_key: Tuple, args: Dict[str, Any]) -> None:
        with self._lock:
            # fence on the first op after completed() and when parameters
            # changed (`fpga_int.cpp:263-273,344-354,429-448`).  The
            # reference also fences whenever its queue went idle; here a
            # fence only has to keep a batch homogeneous, and fencing on an
            # idle queue would let a fast worker split a promised worksize
            # into batches of one.
            fence = (
                self._last_fence_key[op_type] is None
                or self._last_fence_key[op_type] != fence_key
            )
            self._last_fence_key[op_type] = fence_key
            item = WorkItem(op_type=op_type, args=args, fence=fence, fence_key=fence_key)
            self._outstanding[op_type].append(item)
            sync = self._worksize[op_type] == 1
        self.buffer.push(item)
        if sync:
            self.completed(op_type)

    def completed(self, op_type: str) -> bool:
        """Block until all outstanding ops of this type are done; reset
        worksize to 1 (`fpga_int.cpp:209-232`).

        The reference busy-spins here (`fpga_int.cpp:484-507`); on a host
        that also feeds the device, a worker-signaled condition variable frees the
        core (the timeout is a safety net, not a poll interval)."""
        with self._done:
            while not all(i.ready for i in self._outstanding[op_type]):
                self._done.wait(timeout=0.1)
            items = list(self._outstanding[op_type])
            self._outstanding[op_type] = []
            self._worksize[op_type] = 1
            self.buffer.reset_count(op_type)
            self._last_fence_key[op_type] = None
        for i in items:
            err = i.args.get("error")
            if err is not None:
                raise err
        return True

    def release(self) -> None:
        self.buffer.close()
        for d in self.devices:
            d.thread.join(timeout=5)


_pool: Optional[DevicePool] = None
_pool_lock = threading.Lock()
_profiling = None  # (torch.profiler.profile, out_dir) while tracing


def _maybe_start_profiler(cfg) -> None:
    """HEXL_TPU_PROFILE=<dir>: trace host and device activity between
    acquire and release with torch.profiler (the replacement for the
    reference's SYCL queue-profiling property, `fpga.cpp:617-622`); release
    writes <dir>/hexl_trace.json (chrome trace)."""
    global _profiling
    if not cfg.profile_dir or _profiling is not None:
        return
    import torch.profiler as tp

    acts = [tp.ProfilerActivity.CPU]
    if cfg.run_choice == 2:
        acts.append(tp.ProfilerActivity.CUDA)
    prof = tp.profile(activities=acts)
    prof.start()
    _profiling = (prof, cfg.profile_dir)


def _maybe_stop_profiler() -> None:
    global _profiling
    if _profiling is None:
        return
    import os

    prof, out_dir = _profiling
    _profiling = None
    prof.stop()
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "hexl_trace.json"))


def acquire() -> DevicePool:
    """acquire_FPGA_resources analog (`host/src/fpga_context.cpp:15`)."""
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = DevicePool()
            _maybe_start_profiler(_pool.cfg)
        return _pool


def release() -> None:
    global _pool
    with _pool_lock:
        if _pool is not None:
            _pool.release()
            _pool = None
            _maybe_stop_profiler()


def pool() -> DevicePool:
    p = _pool
    if p is None:
        return acquire()
    return p
