"""Percent of the traced part in which no kernel or copy ran on the device,
in a cell that drives the API."""


def read(r):
    t = r.trace
    return 100.0 * (1 - t.busy_s / t.window_s) if t.window_s else None
