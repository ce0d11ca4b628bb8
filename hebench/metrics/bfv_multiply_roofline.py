"""Percent: the least time the card could take for the BFV multiply work of
the traced part (work/bfv_multiply.py against peaks.json) over the device
time of all its kernels, copies left out."""


def read(r):
    return r.roofline("bfv_multiply")
