"""Percent: the least time the card could take for the DyadicMultiply work
of the traced part (work/dyadic_multiply.py against peaks.json) over the
device time of all its kernels, copies left out."""


def read(r):
    return r.roofline("dyadic_multiply")
