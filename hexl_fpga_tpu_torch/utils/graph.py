"""A device composition replayed as one captured CUDA graph.

The reference compiles a whole composition (the BSGS matvec, the BEHZ
multiply) into one jitted device program.  The port's counterpart is a
`torch.cuda.CUDAGraph` captured from the eager composition: the replay runs
the same kernels on the same tensors, so it gives the same bits, without the
host enqueueing them one by one.
"""

from __future__ import annotations

import torch


class GraphProgram:
    """A composition `run(*tensors) -> tensor` as a callable of its inputs.

    On CUDA the constructor runs `run` once on a side stream (filling the
    launch-shape caches) and captures it into one torch.cuda.CUDAGraph.  The
    graph replays raw pointers, so it may read only tensors that outlive it:
    the caller stages every key, table and constant before and holds them
    (`run`'s closure or its object), and nothing inside `run` looks one up in
    a cache that may evict it.  A call copies its inputs into the graph's
    static inputs, replays the graph and returns a copy of its static output.
    A failed capture raises: the card never falls back to the eager
    composition.  On the CPU a call is the eager composition.  The kernels'
    launch counters see the warm-up and the capture, never a replay."""

    def __init__(self, run, *examples: torch.Tensor):
        self.eager = run
        self.graph = None
        device = examples[0].device
        if device.type != "cuda":
            return
        self._ins = [x.clone() for x in examples]
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            run(*self._ins)
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self._out = run(*self._ins)

    def __call__(self, *xs: torch.Tensor) -> torch.Tensor:
        if self.graph is None:
            return self.eager(*xs)
        if len(xs) != len(self._ins):
            raise TypeError(f"the program takes {len(self._ins)} tensors, got {len(xs)}")
        for static, x in zip(self._ins, xs):
            static.copy_(x)
        self.graph.replay()
        return self._out.clone()
