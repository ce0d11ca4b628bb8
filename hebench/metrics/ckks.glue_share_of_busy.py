"""Percent of the device's busy time taken by operations that are not a
hand-written kernel of the program's csrc/ (the evaluator's torch glue: the
Galois gathers, the plaintext products' lane math, the modular sums, a
graph's copy-in and its output's clone; copies), in the traced part of a
CKKS cell."""


def read(r):
    t = r.trace
    if r.op != "ckks" or not t.busy_s:
        return None
    other = sum(t.by_name.values()) - t.hand_written_s
    return 100.0 * other / t.busy_s
