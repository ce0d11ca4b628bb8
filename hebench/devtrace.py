"""What a torch.profiler trace of the traced part of a window says.

The busy time is the union of the device's kernel and copy spans (the
port's copies run on a stream of their own, so spans overlap and their sum
would count the overlap twice): the arithmetic of the port's
`utils/profile_keyswitch.py` `device_busy_ms`, copied here.  The traced
part is the benchmark's own `hebench.traced` span; every device span is
clipped to it.  An idle stretch of the device is put down to what the
caller's thread was doing then: the benchmark's spans `hebench.<step>`, or
`harness` between them.

In a rehearsal on the CPU (no device) the aten operators stand in for the
device's operations, so the arithmetic can be tested; no number of such a
run is a device number.
"""

from __future__ import annotations

import glob
import os
import re
from dataclasses import dataclass, field

TRACED = "hebench.traced"
SPAN_PREFIX = "hebench."


def kernel_base(name: str) -> str:
    """"void ntt_fwd_kernel<2>(unsigned long long const*, ...)" ->
    "ntt_fwd_kernel" (the port's `utils/cuda_timing.py` rule, copied)."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("(")[0].split("<")[0]


def hand_written_kernels(package_dir: str) -> frozenset:
    """The names of the `__global__` functions of the program's csrc/."""
    names = set()
    for path in glob.glob(os.path.join(package_dir, "csrc", "*.cu*")):
        with open(path) as f:
            names.update(re.findall(
                r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)",
                f.read()))
    return frozenset(names)


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def _union(spans):
    """Sorted, merged (start, end) pairs of spans."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


@dataclass
class Summary:
    window_s: float = 0.0
    busy_s: float = 0.0
    kernel_s: float = 0.0          # kernels' device time, copies left out
    hand_written_s: float = 0.0    # of the csrc kernels
    device_ops: int = 0            # kernels, copies and sets
    by_name: dict = field(default_factory=dict)   # device seconds
    idle_by_host: dict = field(default_factory=dict)

    def breakdown(self, top: int = 10) -> dict:
        rank = lambda d: [[k, v] for k, v in
                          sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": rank(self.by_name),
                "idle_gaps": rank(self.idle_by_host)}


def summarize(events, hand_written: frozenset, rehearse: bool) -> Summary:
    """events: (name, is_device, start_us, end_us) of a finished profile,
    from `profile_events`."""
    window = [(s, e) for name, dev, s, e in events
              if name == TRACED and not dev]
    if not window:
        raise RuntimeError("the trace holds no hebench.traced span")
    w0, w1 = window[0]
    sm = Summary(window_s=(w1 - w0) / 1e6)
    if rehearse:
        dev = [(n, s, e) for n, d, s, e in events
               if not d and n.startswith("aten::")]
    else:
        dev = [(n, s, e) for n, d, s, e in events
               if d and not n.startswith(SPAN_PREFIX)]
    spans = []
    for name, s, e in dev:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        spans.append((s, e))
        sm.device_ops += 1
        key = name if _is_copy(name) else kernel_base(name)
        sm.by_name[key] = sm.by_name.get(key, 0.0) + (e - s) / 1e6
        if not _is_copy(name):
            sm.kernel_s += (e - s) / 1e6
            if key in hand_written:
                sm.hand_written_s += (e - s) / 1e6
    busy = _union(spans)
    sm.busy_s = sum(e - s for s, e in busy) / 1e6
    # idle stretches of the window, put down to the caller's spans
    gaps, cur = [], w0
    for s, e in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if cur < w1:
        gaps.append((cur, w1))
    host = sorted((s, e, n[len(SPAN_PREFIX):]) for n, d, s, e in events
                  if not d and n.startswith(SPAN_PREFIX) and n != TRACED)
    first = 0  # host spans follow one another, and so do the gaps
    for g0, g1 in gaps:
        while first < len(host) and host[first][1] <= g0:
            first += 1
        left = g1 - g0
        for k in range(first, len(host)):
            s, e, label = host[k]
            if s >= g1:
                break
            part = min(e, g1) - max(s, g0)
            sm.idle_by_host[label] = sm.idle_by_host.get(label, 0.0) + part / 1e6
            left -= part
        if left > 0:
            sm.idle_by_host["harness"] = (sm.idle_by_host.get("harness", 0.0)
                                          + left / 1e6)
    return sm


def profile_events(prof):
    """(name, is_device, start_us, end_us) of every event."""
    for e in prof.events():
        yield (e.name, str(e.device_type).endswith("CUDA"),
               e.time_range.start, e.time_range.end)
