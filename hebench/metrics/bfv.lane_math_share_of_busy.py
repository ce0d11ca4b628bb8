"""Percent of the device's busy time taken by operations that are not a
hand-written kernel of the program's csrc/ (the BEHZ lane math of torch
elementwise and reduce kernels, copies), in the traced part of a BFV
multiply cell."""


def read(r):
    t = r.trace
    if r.op != "bfv_multiply" or not t.busy_s:
        return None
    other = sum(t.by_name.values()) - t.hand_written_s
    return 100.0 * other / t.busy_s
