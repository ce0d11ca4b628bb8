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

For a whole body or call sequence: `wall_ms` times one call between two
synchronises; from a torch.profiler the caller ran, `device_rows` gives the
device time by kernel or copy name, `device_busy_ms` the union of their
spans, and `device_table` both against the window, with the NTT kernels'
share of busy time.
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


NTT_KERNELS = ("ntt_fwd_kernel", "ntt_inv_kernel", "ntt_fwd_tail_kernel",
               "ntt_fwd_mac_kernel")


def wall_ms(fn):
    """(fn()'s result, host milliseconds of the call between two
    synchronises)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _device_events(prof):
    """(name, device microseconds, count) of every kernel and copy row."""
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", 0) or getattr(ev, "cuda_time_total", 0)
        # kernels and copies only: operator rows repeat their kernels' time
        if us and str(getattr(ev, "device_type", "")).endswith("CUDA"):
            yield ev.key.split("(")[0][:90], us, ev.count  # no argument list


def device_rows(prof) -> dict:
    """Device milliseconds by kernel (or copy) name from a finished profile."""
    rows = {}
    for name, us, _ in _device_events(prof):
        rows[name] = rows.get(name, 0.0) + us / 1e3
    return rows


def device_busy_ms(prof) -> float:
    """Milliseconds of a finished profile in which at least one kernel or
    copy ran on the card: the union of their spans (the executor's copies
    run on a stream of their own, so device rows overlap and their sum
    counts the overlap twice)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if str(e.device_type).endswith("CUDA"))
    busy, end = 0.0, float("-inf")
    for start, stop in spans:
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy / 1e3


def device_table(prof, window_ms, top=8):
    """Device time by kernel from a finished profile, against the window."""
    rows = device_rows(prof)
    busy = device_busy_ms(prof)
    ntt = {k: v for k, v in rows.items() if kernel_base(k) in NTT_KERNELS}
    rest = sorted(((v, k) for k, v in rows.items() if k not in ntt), reverse=True)
    return {
        "window_ms": window_ms, "device_busy_ms": busy,
        "device_time_sum_ms": sum(rows.values()),
        "device_idle_share": 1 - busy / window_ms,
        "launches": sum(count for _, _, count in _device_events(prof)),
        "ntt_kernels_ms": ntt,
        "ntt_kernels_share_of_busy": sum(ntt.values()) / busy,
        "largest_other_ms": {k: v for v, k in rest[:top]},
    }
