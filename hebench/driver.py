"""The one traffic driver: it reads a traffic file's parameters and drives a
configuration's op (an `ops/<op>.py` Workload) through one of two patterns.

  api_rounds      one caller, closed loop: each round is
                  set_worksize_X(worksize) (left out at worksize 1, as a
                  SEAL-style caller does), `worksize` calls of X, each after
                  the client's step on its buffer, then XCompleted().  Ops
                  cycle over the pool's slots.
  device_batches  the op's device entry on batches staged once in set-up,
                  back to back over the staged pool; results stay on the
                  device; the window ends with a synchronise.

A window runs whole rounds (or batches) until `seconds` have passed, and
ends when the last one has completed: its rate is all its ops over all its
time.  The answers kept for the check are drawn from the seed, each op with
chance 1 / check_every, and the window's last op always.  With tracing on,
torch.profiler runs over the window's first `trace_seconds` (the traced
part); the host-side per-layer numbers are taken over the rest of the
window, where the profiler costs the host nothing.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import numpy as np

from hebench import devtrace


@dataclass
class Window:
    seconds: float = 0.0
    ops: int = 0
    failed: int = 0
    error: str = ""
    call_s: list = field(default_factory=list)      # per call at worksize 1, untraced part
    round_s: list = field(default_factory=list)     # per round or batch
    kept: list = field(default_factory=list)        # (rows, uses, answers)
    enqueue_s: list = field(default_factory=list)   # per call, untraced part
    body_gaps_ms: list = field(default_factory=list)
    traced_ops: int = 0
    traced_batches: int = 0


class Tracer:
    """torch.profiler over the first `seconds` of the window, and the
    benchmark's own spans (as profiler ranges) while it runs."""

    def __init__(self, enabled: bool, seconds: float, cuda: bool):
        self.enabled, self.seconds, self.cuda = enabled, seconds, cuda
        self.prof = self.active = None
        self.window_range = None

    def start(self):
        if not self.enabled:
            return
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self.window_range = torch.profiler.record_function(devtrace.TRACED)
        self.window_range.__enter__()
        self.t0 = time.perf_counter()
        self.active = True

    def due(self, now: float) -> bool:
        return bool(self.active) and now - self.t0 >= self.seconds

    def stop(self) -> float:
        """Ends the traced part; returns the seconds the profiler took to
        stop, which the window does not count."""
        t = time.perf_counter()
        self.window_range.__exit__(None, None, None)
        self.prof.stop()
        self.active = False
        self.stop_s = time.perf_counter() - t
        return self.stop_s

    def span(self, label: str):
        if not self.active:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(devtrace.SPAN_PREFIX + label)

    def events(self) -> list:
        return list(devtrace.profile_events(self.prof)) if self.prof else []


def _executors():
    """The port's API executors that keep a timeline (CUDA ones)."""
    from hexl_fpga_tpu_torch.runtime import scheduler

    return [d.executor for d in scheduler.pool().devices
            if getattr(d.executor, "copy_stream", None) is not None]


def _body_gaps_ms(timelines) -> list:
    """Card-clock milliseconds from each body's end to the next body's
    start, from the executor's (body start, body end, copy start, copy end)
    events."""
    gaps = []
    for marks in timelines:
        for prev, cur in zip(marks, marks[1:]):
            gaps.append(prev[1].elapsed_time(cur[0]))
    return gaps


class ApiRounds:
    def __init__(self, w, traffic: dict, seed: int):
        self.w, self.traffic = w, traffic
        self.ws = int(traffic["worksize"])
        if self.ws > w.pool:
            raise ValueError(f"worksize {self.ws} over a pool of {w.pool}")
        self.rng = np.random.default_rng([seed, 1])

    def setup(self, device):
        from hexl_fpga_tpu_torch import config

        config.reset_config()
        self.w.api()
        for r in range(int(self.traffic.get("warm_rounds", 1))):
            self._round(r * self.ws, np.zeros(self.ws, bool), Tracer(False, 0, False))

    def _round(self, g, keep, tracer):
        w = self.w
        slots = [(g + i) % w.pool for i in range(self.ws)]
        t_enq = []
        if self.ws > 1:
            w.set_worksize(self.ws)
        for i, s in enumerate(slots):
            with tracer.span("client"):
                w.restore(s, keep[i])
            c0 = time.perf_counter()
            with tracer.span("enqueue"):
                w.call(s)
            t_enq.append((c0, time.perf_counter()))
        with tracer.span("completed"):
            w.completed()
        return slots, t_enq, time.perf_counter()

    def window(self, seconds: float, tracer: Tracer) -> Window:
        w, win = self.w, Window()
        p = 1.0 / float(self.traffic["check_every"])
        timelines = []
        g = 0
        tracer.start()
        t0 = prev = time.perf_counter()
        while True:
            keep = self.rng.random(self.ws) < p
            traced = bool(tracer.active)
            try:
                slots, t_enq, done = self._round(g, keep, tracer)
            except Exception as exc:  # the port's error, raised by Completed
                win.failed += self.ws
                win.error = f"{type(exc).__name__}: {exc}"
                done = time.perf_counter()
                break
            g += self.ws
            win.round_s.append(done - prev)
            prev = done
            if self.ws == 1 and not traced:
                win.call_s.append(done - t_enq[0][0])
            last = done - t0 >= seconds
            keep[-1] |= last
            for i in np.flatnonzero(keep):
                got, uses = w.result(slots[i])
                win.kept.append(([slots[i]], [uses], got[None]))
            if traced:
                win.traced_ops += self.ws
                win.traced_batches += -(-self.ws // int(self.traffic["batch"]))
                if tracer.due(done) and not last:
                    t0 += tracer.stop()
                    prev = time.perf_counter()
                    for ex in _executors():
                        ex.timeline = []
                        timelines.append(ex.timeline)
            else:
                win.enqueue_s.extend(e - s for s, e in t_enq)
            if last:
                break
        win.seconds, win.ops = done - t0, g
        if tracer.active:  # a window shorter than the traced part
            tracer.stop()
        for ex in _executors() if tracer.enabled else ():
            ex.timeline = None
        win.body_gaps_ms = _body_gaps_ms(timelines)
        return win

    def close(self):
        self.w.release()


class DeviceBatches:
    def __init__(self, w, traffic: dict, seed: int):
        self.w, self.traffic = w, traffic
        self.batch = int(traffic["batch"])
        self.rng = np.random.default_rng([seed, 2])

    def setup(self, device):
        import torch

        self.device = torch.device(device)
        self.w.device(self.batch, int(self.traffic["pool_batches"]), self.device)
        for b in range(int(self.traffic.get("warm_batches", 1))):
            self.w.dispatch(b % len(self.w.staged))
        self._sync()

    def _sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, seconds: float, tracer: Tracer) -> Window:
        w, win = self.w, Window()
        p = 1.0 / float(self.traffic["check_every"])
        nb = len(w.staged)
        kept = []
        i = 0
        tracer.start()
        t0 = time.perf_counter()
        while True:
            b = i % nb
            with tracer.span("dispatch"):
                out = w.dispatch(b)
            i += 1
            if tracer.active:
                win.traced_batches += 1
            now = time.perf_counter()
            last = now - t0 >= seconds
            if last or self.rng.random() < p:
                kept.append((b, out))
            if tracer.due(now) and not last:
                with tracer.span("sync"):
                    self._sync()
                t0 += tracer.stop()
            if last:
                break
        self._sync()
        win.seconds = time.perf_counter() - t0
        if tracer.active:  # a window shorter than the traced part
            tracer.stop()
        win.ops = i * self.batch
        win.traced_ops = win.traced_batches * self.batch
        for b, out in kept:
            got, uses = w.device_result(out)
            rows = w.device_rows(b)
            win.kept.append((rows, [uses] * len(rows), got))
        return win

    def close(self):
        self.w.release_device()


PATTERNS = {"api_rounds": ApiRounds, "device_batches": DeviceBatches}
CHECK_BLOCK = 16  # pool rows a call of the reference


def batch_rows(b: int, batch: int, pool: int) -> list:
    """The pool rows of staged batch b."""
    return [(b * batch + i) % pool for i in range(batch)]


def compare(w, kept, reference) -> dict:
    """The kept answers against the reference's, word for word.  The
    reference runs once for each distinct pool row, CHECK_BLOCK rows a call;
    w.after turns its one-op answers into those after each row's uses."""
    rows = sorted({r for rs, _, _ in kept for r in rs})
    once = {}
    for k in range(0, len(rows), CHECK_BLOCK):
        part = rows[k:k + CHECK_BLOCK]
        for r, ans in zip(part, reference(part)):
            once[r] = ans
    mismatched = 0
    for rs, uses, got in kept:
        want = w.after(rs, np.stack([once[r] for r in rs]), uses)
        mismatched += int(np.count_nonzero(want != got))
    return {"mismatched_words": mismatched,
            "ops_checked": sum(len(rs) for rs, _, _ in kept)}
