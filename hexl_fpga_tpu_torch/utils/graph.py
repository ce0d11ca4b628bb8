"""A device composition replayed as one captured CUDA graph.

The reference compiles a whole composition (the BSGS matvec, the BEHZ
multiply) into one jitted device program.  The port's counterpart is a
`torch.cuda.CUDAGraph` captured from the eager composition: the replay runs
the same kernels on the same tensors, so it gives the same bits, without the
host enqueueing them one by one.
"""

from __future__ import annotations

import collections
import contextlib
import threading

import torch

# one capture at a time in the process, each on its device's capture stream:
# a stream of priority -1, whose pool the port's own streams (all of the
# default priority) never draw from, since a capture takes in whatever any
# thread enqueues on its stream
_capture_lock = threading.Lock()
_capture_streams: dict = {}


class GraphQueue:
    """Programs that share one memory pool and take turns.

    Each call of a program of the queue enqueues its copy-in, replay and
    output copy under the queue's lock; on the card each call first waits
    for the event behind the call before it, whatever stream either ran on.
    So two threads never interleave their writes to a program's static
    inputs, and no two programs run at once: their graphs may then share one
    memory pool, whose size does not grow with their number.  A capture
    needs no turn: nothing runs while it records."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.lock = threading.Lock()
        self.pool = (torch.cuda.graph_pool_handle()
                     if self.device.type == "cuda" else None)
        self._last = None  # the event behind the last call
        self._anchor = None  # hold_pool's graph

    def hold_pool(self) -> None:
        """Capture, once, a graph of one fill into the pool and keep it, so
        that the pool lives as long as the queue: the allocator retires a
        pool once no graph holds it, and refuses a capture into a retired
        pool (an internal assert), which a queue whose programs all left
        would meet at its next capture.  Call on the capture stream."""
        if self._anchor is None:
            anchor = torch.cuda.CUDAGraph()
            anchor.capture_begin(self.pool, capture_error_mode="thread_local")
            try:
                torch.zeros(1, device=self.device)
            finally:
                anchor.capture_end()
            self._anchor = anchor

    @contextlib.contextmanager
    def turn(self):
        with self.lock:
            stream = torch.cuda.current_stream(self.device)
            if self._last is not None:
                stream.wait_event(self._last)
            yield
            self._last = torch.cuda.Event()
            self._last.record(stream)


class GraphProgram:
    """A composition `run(*tensors) -> tensor` as a callable of its inputs.

    On CUDA the constructor runs `run` once on a side stream (filling the
    launch-shape caches; `warm=False` leaves that out for a caller that has
    just run the composition eagerly at these shapes) and captures it into
    one torch.cuda.CUDAGraph.  The capture calls capture_begin/capture_end
    itself: torch.cuda.graph's device-wide synchronize and emptying of the
    allocator's caches would stall every other stream on the card.  The
    graph replays raw pointers, so it may read only tensors that outlive it:
    the caller stages every key, table and constant before and holds them
    (`run`'s closure or its object, or `holds`), and nothing inside `run`
    looks one up in a cache that may evict it.  A call copies its inputs
    into the graph's static inputs (contiguous, whatever the examples'
    strides), replays the graph and returns a copy of its static output;
    with a `queue` (GraphQueue) every call takes the queue's turn.  A call
    marks the static inputs and `holds` as used on its stream, so that
    memory is not handed out again while a replay on another thread's stream
    may still read it.  A failed capture raises: the card never falls back
    to the eager composition.  On the CPU a call is the eager composition.
    The kernels' launch counters (ntt_cuda.count_launch) count what runs:
    the warm-up and every replay, never the capture."""

    def __init__(self, run, *examples: torch.Tensor,
                 queue: GraphQueue | None = None, warm: bool = True,
                 holds: tuple = ()):
        self.eager = run
        self.graph = None
        self.queue = queue
        device = examples[0].device
        if device.type != "cuda":
            return
        from ..ops import ntt_cuda  # the launch counters (ops import this module)

        self._count = ntt_cuda.count_launch
        self._ins = [x.clone(memory_format=torch.contiguous_format) for x in examples]
        self._holds = (*self._ins, *holds)
        if warm:
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                run(*self._ins)
            torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with _capture_lock, ntt_cuda.captured_launches() as launched:
            stream = _capture_streams.get(device)
            if stream is None:
                stream = _capture_streams[device] = torch.cuda.Stream(device, priority=-1)
            with torch.cuda.stream(stream):
                if queue is not None:
                    queue.hold_pool()
                self.graph.capture_begin(queue and queue.pool,
                                         capture_error_mode="thread_local")
                try:
                    self._out = run(*self._ins)
                finally:
                    self.graph.capture_end()
        tables = {id(table): table for table, _ in launched}
        self._launches = tuple(
            (tables[i], name, times) for (i, name), times in
            collections.Counter((id(table), name) for table, name in launched).items())

    def _turn(self):
        return self.queue.turn() if self.queue else contextlib.nullcontext()

    def __call__(self, *xs: torch.Tensor) -> torch.Tensor:
        if self.graph is None:
            return self.eager(*xs)
        if len(xs) != len(self._ins):
            raise TypeError(f"the program takes {len(self._ins)} tensors, got {len(xs)}")
        with self._turn():
            for static, x in zip(self._ins, xs):
                static.copy_(x)
            self.graph.replay()
            out = self._out.clone()
            stream = torch.cuda.current_stream(out.device)
            for t in self._holds:
                t.record_stream(stream)
        for table, name, times in self._launches:
            self._count(table, name, times)
        return out
