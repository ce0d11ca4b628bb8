"""Host microseconds inside the op's call (validation, the scheduler's
enqueue), per op, over the window's untraced part (the benchmark's own
spans around each call)."""


def read(r):
    s = r.win.enqueue_s
    return 1e6 * sum(s) / len(s) if s else None
