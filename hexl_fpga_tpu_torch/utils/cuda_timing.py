"""Kernel times on the card, four ways.

  event_ms     CUDA events around `reps` calls through the Python wrapper:
               what a caller of the wrapper sees; once a kernel takes less
               than the wrapper's own host cost, this is the host's rate;
  host_ms      the host's enqueue time per call (no synchronise inside);
  device_ms    the kernels' own time from torch.profiler: device time of the
               kernels of the given names, per call;
  graph_ms     CUDA events around a CUDA graph of `reps` calls: the device's
               time per call with no host in the way.

Each warms up with one call first.  All need a CUDA device; `rotating`
feeds them inputs from device memory.
"""

from __future__ import annotations

import time

import torch


def rotating(make, nbytes: int):
    """A source of inputs that cycles over enough copies (at least two) of
    make() to exceed the 50 MB L2 cache, so timed reads come from device
    memory."""
    copies = int(100e6 // nbytes) + 2
    sets = [make() for _ in range(copies)]
    state = {"i": 0}

    def nxt():
        state["i"] = (state["i"] + 1) % copies
        return sets[state["i"]]

    return nxt


def event_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps calls, CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def host_ms(fn, reps: int) -> float:
    """Mean host milliseconds to enqueue fn() (no synchronise between)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


def device_events(prof):
    """(key, device microseconds, count) of every device row of a profile."""
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", 0) or getattr(ev, "cuda_time_total", 0)
        if us and str(getattr(ev, "device_type", "")).endswith("CUDA"):
            yield ev.key, us, ev.count


def kernel_base(name: str) -> str:
    """A kernel's name without return type, template and argument lists:
    "void ntt_fwd_kernel<2, 3>(unsigned long long const*, ...)" ->
    "ntt_fwd_kernel"."""
    return name.removeprefix("void ").split("(")[0].split("<")[0]


def device_ms(fn, reps: int, kernels):
    """(device milliseconds per call, launches seen) of the kernels named in
    `kernels` (kernel_base names) over reps calls of fn(), by torch.profiler:
    their device time over reps (for one kernel a call, the time over the
    count); (None, 0) if the profiler saw no device time for them."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us, count = 0.0, 0
    for key, t, c in device_events(prof):
        if kernel_base(key) in kernels:
            us += t
            count += c
    return (us / 1e3 / reps if count else None), count


def graph_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of a CUDA graph of reps calls of fn()."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (3 * reps)
