"""Assertions, tracing and timing hooks.

Analog of the reference's FPGA_ASSERT + stack-trace dump
(`host/inc/fpga_assert.h:18-45`, `host/src/stack_trace.cpp:19-80`) and its
FPGA_DEBUG host timers (`host/src/fpga.cpp:882-920`).  Python exceptions carry
tracebacks natively, so `hexl_assert` raises; set HEXL_TPU_ABORT=1 to get the
reference's abort-with-backtrace behavior instead.
"""

from __future__ import annotations

import os
import time
import traceback
from contextlib import contextmanager


class HexlAssertError(AssertionError):
    pass


def hexl_assert(cond: bool, msg: str) -> None:
    if cond:
        return
    if os.environ.get("HEXL_TPU_ABORT") == "1":
        traceback.print_stack()
        os.abort()
    raise HexlAssertError(msg)


@contextmanager
def timed(label: str, n_ops: int = 1, enabled: bool = True):
    """FPGA_DEBUG-style timer: prints total and per-op microseconds."""
    if not enabled:
        yield
        return
    t0 = time.perf_counter()
    yield
    dt = (time.perf_counter() - t0) * 1e6
    print(f"{label} time taken: {dt:.2f} us ({dt / max(n_ops, 1):.2f} us/op)")
